// zstd Huffman literal-stream decode for Hopper (sm_90a): one CTA of 64
// threads a stream, the stream's bytes and its table in shared memory.
//
// Replaces zpack_tpu/kernels/huffman_jax.py:decode_streams_scan and its
// opt-in twin decode_streams (driven by DeviceHuffmanDecoder), the literal
// stage of the zstd extract path.  The contract is
// codecs/zstd/huffman.py:_decode_one_stream, stated in plain PyTorch by
// zpack_tpu_torch/kernels/huffman_torch.py:decode_streams_plain.
//
// A stream is read backward from its sentinel bit, one symbol per step, and
// each step depends on the bit count of the one before: the decode is a
// chain, and the chain carries only the bit position.  The TPU design walks
// every stream in lockstep in a lax.scan, two symbols per gathered 32-bit
// window.  Here a stream is a CTA, so every stream's chain runs at once
// (1,160 CTAs at the extract shape, all resident), and nothing the chain
// touches lies in global memory:
//
//   1. All threads stage the stream's bytes into shared memory (16-byte
//      loads, a zero chunk below the bytes and one above) and its table's
//      2^max_bits entries as uint16 sym | nbits << 8.
//   2. Thread 0 walks.  A step is two aligned 32-bit shared loads and a
//      funnel shift for the code, one shared table load, and the new
//      position, all in int32.  No other lane walks, so nothing diverges,
//      and the step has no branch.  The walker packs four symbols a word into
//      a shared buffer of kOutBuf symbols.
//   3. All threads copy the buffer out to the row's place in the output,
//      coalesced; steps 2 and 3 take turns until the row is done.
//
// A row too long for the stage (above STAGE_CAP in huffman_torch.py) runs
// the same walk with its words read from global memory.  Reads below bit 0
// give zeros, as the plain version's padding does; a write outside the
// output is skipped.  A malformed row (table out of range, max_bits outside
// 1..11, bytes outside the payload, start_bit outside its bytes) writes
// nothing and gets final -1, the plain version's rule.  What bounds it: the
// longest stream's chain, two dependent shared loads a symbol (the word
// pair, then the table) and a few integer operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 7;  // byte_start, n_bytes, start_bit, n_syms, dst_off, table, max_bits
constexpr int kTable = 2048;
constexpr int kMaxBits = 11;
constexpr int kThreads = 64;
constexpr int kPadChunks = 1;  // zero 16-byte chunks below a staged row
constexpr int kTopChunks = 1;  // and above it: the upper word of a read
constexpr int kPadBytes = 16 * kPadChunks;
constexpr long long kMaxRowBytes = 1ll << 26;  // int32 bit positions

// Shared memory a row of n bytes needs when its first byte sits mis bytes
// into a 16-byte chunk.
__host__ __device__ constexpr long long stage_bytes(long long n, int mis) {
  return 16 * ((mis + n + 15) / 16 + kPadChunks + kTopChunks);
}

// A staged row: byte j of the row at stage byte pad_bits / 8 + j, zeros
// around it; word i is stage bytes [4i, 4i + 4).
struct SharedBits {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t word(int i) const { return w[i]; }
};

// A row above the stage cap, in the same layout (pad_bits = 8 * kPadBytes)
// but read from its bytes in global memory, zero outside them.
struct GlobalBits {
  const uint8_t* src;
  int nbytes;
  __device__ uint32_t word(int i) const {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * i + k - kPadBytes;
      if (j >= 0 && j < nbytes) v |= uint32_t(src[j]) << (8 * k);
    }
    return v;
  }
};

// Thread 0's walk of one row: the position q in stage coordinates (the
// code is stage bits [q - mb, q); the row's bit p is stage bit p + pad).
template <class Bits>
struct Walker {
  Bits bits;
  const uint16_t* tab;
  int mb, pad, q;
  uint32_t mask;
  int qb = 0, nb = 0;  // the position before the last symbol, its bits

  // The next symbol's table entry, sym | nbits << 8; moves q.
  __device__ __forceinline__ uint32_t next() {
    const int lo = q - mb;
    const uint32_t e =
        tab[__funnelshift_r(bits.word(lo >> 5), bits.word((lo >> 5) + 1), lo) & mask];
    nb = int(e >> 8);
    qb = q;
    q = max(q - nb, pad);
    return e;
  }
};

constexpr int kOutBuf = 4096;  // symbols a round of the walk

// The CTA decodes n > 0 symbols of one row to out[dst + k], skipping a
// store outside [0, n_out): rounds of kOutBuf symbols, thread 0 packing
// them four a word into obuf, then all threads copying the round out.
// Returns final in thread 0: the position before the last symbol minus
// its bit count.
template <class Bits>
__device__ int decode_row(Walker<Bits> w, int64_t n, uint8_t* __restrict__ out, int64_t dst,
                          int64_t n_out, uint32_t* obuf) {
  for (int64_t k0 = 0; k0 < n; k0 += kOutBuf) {
    const int cnt = n - k0 < kOutBuf ? int(n - k0) : kOutBuf;
    if (threadIdx.x == 0) {
      uint32_t pack = 0;
      for (int k = 0; k < cnt; ++k) {
        pack |= (w.next() & 0xFF) << (8 * (k & 3));
        if ((k & 3) == 3) {
          obuf[k >> 2] = pack;
          pack = 0;
        }
      }
      if (cnt & 3) obuf[cnt >> 2] = pack;
    }
    __syncthreads();
    const uint8_t* ob = reinterpret_cast<const uint8_t*>(obuf);
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const int64_t d = dst + k0 + i;
      if (d >= 0 && d < n_out) out[d] = ob[i];
    }
    __syncthreads();
  }
  return w.qb - w.pad - w.nb;
}

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ payload, int64_t payload_len,
                      const int64_t* __restrict__ rows, const int* __restrict__ tables, int T,
                      uint8_t* __restrict__ out, int64_t n_out, int* __restrict__ final_bits,
                      int smem_bytes) {
  extern __shared__ uint4 stage[];
  __shared__ uint16_t tab[kTable];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int64_t* r = rows + int64_t(s) * kCols;
  const int64_t start = r[0], nbytes = r[1], p0 = r[2], n = r[3], dst = r[4], ti = r[5];
  const int64_t mb = r[6];
  if (ti < 0 || ti >= T || mb < 1 || mb > kMaxBits || start < 0 || nbytes < 0 ||
      start + nbytes > payload_len || p0 < 0 || p0 >= 8 * nbytes || nbytes >= kMaxRowBytes) {
    if (tid == 0) final_bits[s] = -1;
    return;
  }
  if (n <= 0) {
    if (tid == 0) final_bits[s] = 0;
    return;
  }
  const uint8_t* src = payload + start;
  const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
  const bool staged = stage_bytes(nbytes, mis) <= smem_bytes;
  if (staged) {
    const int nch = int((mis + nbytes + 15) / 16);
    const uint4* g = reinterpret_cast<const uint4*>(src - mis);
    for (int c = tid; c < nch + kPadChunks + kTopChunks; c += kThreads) {
      const int gc = c - kPadChunks, lo = 16 * gc - mis;  // the chunk's first row byte
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gc >= 0 && gc < nch) {
        if (lo >= 0 && lo + 16 <= nbytes) {
          v = g[gc];
        } else {  // the row's first or last chunk: its bytes only
          uint32_t u[4] = {0, 0, 0, 0};
          for (int j = max(-lo, 0); j < min(16, int(nbytes) - lo); ++j)
            u[j >> 2] |= uint32_t(src[lo + j]) << (8 * (j & 3));
          v = make_uint4(u[0], u[1], u[2], u[3]);
        }
      }
      stage[c] = v;
    }
  }
  const int* t = tables + ti * kTable;
  for (int i = tid; i < (1 << mb); i += kThreads) tab[i] = uint16_t(t[i]);
  __syncthreads();
#ifndef ZP_HUF_STAGE_ONLY  // a knock-out build: staging alone, for timing
  __shared__ uint32_t obuf[kOutBuf / 4];
  const uint32_t mask = (1u << mb) - 1;
  const int f =
      staged ? decode_row(Walker<SharedBits>{SharedBits{reinterpret_cast<const uint32_t*>(stage)},
                                             tab, int(mb), 8 * (kPadBytes + mis),
                                             int(p0) + 8 * (kPadBytes + mis), mask},
                          n, out, dst, n_out, obuf)
             : decode_row(Walker<GlobalBits>{GlobalBits{src, int(nbytes)}, tab, int(mb),
                                             8 * kPadBytes, int(p0) + 8 * kPadBytes, mask},
                          n, out, dst, n_out, obuf);
  if (tid == 0) final_bits[s] = f;
#endif
}

}  // namespace

// payload: flat u8 of payload_len bytes; rows (S, 7) i64; tables (T, 2048)
// i32 sym | nbits << 8 (the low 16 bits are read); out: zeroed u8 of n_out
// bytes; final_bits (S,) i32; stage: the bytes of the longest row to stage
// in shared memory (a longer row reads global memory).
// Returns cudaGetLastError().
extern "C" int zp_huffman_decode(const void* payload, long long payload_len, const void* rows,
                                 int S, const void* tables, int T, void* out, long long n_out,
                                 void* final_bits, int stage, void* stream) {
  const int smem = int(stage_bytes(stage < 0 ? 0 : stage, 15));
  huffman_decode_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_len, static_cast<const int64_t*>(rows),
      static_cast<const int*>(tables), T, static_cast<uint8_t*>(out), n_out,
      static_cast<int*>(final_bits), smem);
  return int(cudaGetLastError());
}

// The CTAs of one launch with this stage size that one SM holds at once.
extern "C" int zp_huffman_decode_occupancy(int stage, void* blocks_per_sm) {
  const int smem = int(stage_bytes(stage < 0 ? 0 : stage, 15));
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks_per_sm), huffman_decode_kernel, kThreads, smem));
}
