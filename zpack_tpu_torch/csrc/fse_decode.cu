// zstd FSE sequence-section decode for Hopper (sm_90a): one CTA of 128
// threads per block, the block's bitstream and tables in shared memory.
//
// Replaces zpack_tpu/kernels/fse_jax.py:decode_seq_streams (driven by
// DeviceSequenceDecoder), the sequence stage of the zstd extract path.  The
// contract is codecs/zstd/seq.py:decode_sequences with the offset codes
// capped at 30, stated in plain PyTorch by
// zpack_tpu_torch/kernels/fse_torch.py:decode_seq_streams_plain.
//
// The three FSE state machines (LL, OF, ML) of a block read one backward
// bitstream in turn, so a block is one chain; blocks are independent.  But
// the chain carries only the bit position and the three states: how many
// bits a step consumes follows from its three table entries, and the value
// bits (offset, match and literal extras) need not be read to go on.  So,
// as the plain version states it, the chain and the values are two passes:
//
//   1. All threads stage the block's bytes into shared memory (16-byte
//      loads, zero chunks below and above) and its three decode tables,
//      each entry rewritten into a chain-ready form: the bits the step
//      consumes for that machine (extras + state bits), the state bits, the
//      code and the next-state base.
//   2. Thread 0 walks the chain.  A step is three independent table loads,
//      the position of the state bits, one read of them (two aligned 32-bit
//      shared loads and a funnel shift) and the three new states, all in
//      int32.  It stores one record a sequence (the position of the value
//      bits, the three codes) to a global scratch, off the chain.
//   3. All threads read the values: per record the ML+LL extras and the
//      offset extras from the staged bits, the baselines and bit counts
//      from shared memory; the stores are coalesced.
//
// A row too long for the stage (above STAGE_CAP in fse_torch.py, the size
// of a zstd block) runs the same code with its bits read from global
// memory.  Reads below bit 0 give zeros, as the plain version's padding
// does.  What bounds it: the longest block's chain, one shared table load
// and one shared bit read a step; all blocks run at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 512;     // max FSE table size (accuracy log 9)
constexpr int kThreads = 128;
constexpr int kPadChunks = 1;   // zero 16-byte chunks below a staged row
constexpr int kTopChunks = 2;   // and above it
constexpr int kPadBytes = 16 * kPadChunks;

// baselines | extra-bit count << 20 per literal-length and match-length
// code (RFC 8878 §3.1.1.3.2.1.1); copied to shared memory before use
__constant__ int kLLConst[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16 | 1 << 20, 18 | 1 << 20, 20 | 1 << 20, 22 | 1 << 20, 24 | 2 << 20, 28 | 2 << 20,
    32 | 3 << 20, 40 | 3 << 20, 48 | 4 << 20, 64 | 6 << 20, 128 | 7 << 20, 256 | 8 << 20,
    512 | 9 << 20, 1024 | 10 << 20, 2048 | 11 << 20, 4096 | 12 << 20, 8192 | 13 << 20,
    16384 | 14 << 20, 32768 | 15 << 20, 65536 | 16 << 20};
__constant__ int kMLConst[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34,
    35 | 1 << 20, 37 | 1 << 20, 39 | 1 << 20, 41 | 1 << 20, 43 | 2 << 20, 47 | 2 << 20,
    51 | 3 << 20, 59 | 3 << 20, 67 | 4 << 20, 83 | 4 << 20, 99 | 5 << 20, 131 | 7 << 20,
    259 | 8 << 20, 515 | 9 << 20, 1027 | 10 << 20, 2051 | 11 << 20, 4099 | 12 << 20,
    8195 | 13 << 20, 16387 | 14 << 20, 32771 | 15 << 20, 65539 | 16 << 20};

// Shared memory a row of n bytes needs when its first byte sits mis bytes
// into a 16-byte chunk.
__host__ __device__ constexpr long long stage_bytes(long long n, int mis) {
  return 16 * ((mis + n + 15) / 16 + kPadChunks + kTopChunks);
}

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {  // n in 0..32
  return n >= 32 ? v : v & ((1u << n) - 1);
}

// A staged row: byte j of the row at stage byte pad_bits / 8 + j, zeros
// around it; word i is stage bytes [4i, 4i + 4).
struct SharedBits {
  const uint32_t* w;
  int pad_bits;
  __device__ __forceinline__ uint32_t word(int i) const { return w[i]; }
};

// A row above the stage cap, in the same layout but read from its bytes in
// global memory, zero outside them.
struct GlobalBits {
  const uint8_t* src;
  int nbytes;
  int pad_bits;
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

// The 32 bits of the stream from bit pos up; a position below the pad
// reads the pad's zeros, as every read starting below bit -32 must.
template <class Bits>
__device__ __forceinline__ uint32_t window(const Bits& bits, int pos) {
  const int k = max(pos + bits.pad_bits, 0);
  return __funnelshift_r(bits.word(k >> 5), bits.word((k >> 5) + 1), k);
}

// The three codes of a step's chain-ready entries, LL | OF << 6 | ML << 12.
__device__ __forceinline__ int codes(uint32_t el, uint32_t eo, uint32_t em) {
  return int((el >> 10 & 63) | (eo >> 10 & 63) << 6 | (em >> 10 & 63) << 12);
}

// Passes 2 and 3 of one row: the walk by thread 0, then the values by all.
// T: the chain-ready tables, (LL, OF, ML) x kTable; entry = consumed bits
// (extras + state bits) | state bits << 6 | code << 10 | next-state base << 16.
template <class Bits>
__device__ void decode_row(const Bits& bits, const uint32_t* T, const int* s_ll,
                           const int* s_ml, const int* al, int pos, int n, int2* rec,
                           int* lls, int* mls, int* ovs, int* pos_f, bool* err_out) {
  if (threadIdx.x == 0) {
    // initial states: LL, OF, ML
    pos -= al[0];
    int ll_s = low_bits(window(bits, pos), al[0]) & (kTable - 1);
    pos -= al[1];
    int of_s = low_bits(window(bits, pos), al[1]) & (kTable - 1);
    pos -= al[2];
    int ml_s = low_bits(window(bits, pos), al[2]) & (kTable - 1);
    // every sequence but the last: values skipped, state bits read
    for (int i = 0; i + 1 < n; ++i) {
      const uint32_t el = T[ll_s], eo = T[kTable + of_s], em = T[2 * kTable + ml_s];
      const int ps = pos - int(el & 63) - int(eo & 63) - int(em & 63);
      const int nl = el >> 6 & 15, no = eo >> 6 & 15, nm = em >> 6 & 15;
      rec[i] = make_int2(ps + nl + no + nm, codes(el, eo, em));
      const uint32_t w = window(bits, ps);
      of_s = ((eo >> 16) + (w & ((1u << no) - 1))) & (kTable - 1);
      ml_s = ((em >> 16) + (w >> no & ((1u << nm) - 1))) & (kTable - 1);
      ll_s = ((el >> 16) + (w >> (no + nm) & ((1u << nl) - 1))) & (kTable - 1);
      pos = ps;
    }
    if (n > 0) {  // the last sequence: its values, no state update
      const uint32_t el = T[ll_s], eo = T[kTable + of_s], em = T[2 * kTable + ml_s];
      pos -= int((el & 63) - (el >> 6 & 15)) + int((eo & 63) - (eo >> 6 & 15)) +
             int((em & 63) - (em >> 6 & 15));
      rec[n - 1] = make_int2(pos, codes(el, eo, em));
    }
    *pos_f = pos;
  }
  __syncthreads();
  // the values, a sequence a thread: ML above LL at the record's position,
  // the offset's extras above them
  bool bad = false;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int2 r = rec[i];
    const int ofc = r.y >> 6 & 63;
    bad |= ofc > 30;
    const int of_b = min(ofc, 30);
    const int lc = s_ll[min(r.y & 63, 35)], mc = s_ml[min(r.y >> 12 & 63, 52)];
    const int ll_b = lc >> 20, ml_b = mc >> 20;
    const uint32_t w = low_bits(window(bits, r.x), ll_b + ml_b);
    lls[i] = (lc & 0xFFFFF) + int(w & ((1u << ll_b) - 1));
    mls[i] = (mc & 0xFFFFF) + int(w >> ll_b);
    ovs[i] = of_b > 0 ? int((1u << of_b) + low_bits(window(bits, r.x + ll_b + ml_b), of_b)) : 1;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) *err_out = bad;
}

__global__ void __launch_bounds__(kThreads)
fse_decode_kernel(const uint8_t* __restrict__ payload, int64_t payload_len,
                  const int64_t* __restrict__ rows, const int64_t* __restrict__ seq_off,
                  const int* __restrict__ al, const int* __restrict__ tables, int any_steps,
                  int smem_bytes, int2* __restrict__ rec, int* __restrict__ lls,
                  int* __restrict__ mls, int* __restrict__ ovs, int* __restrict__ pos_f,
                  bool* __restrict__ err_out) {
  extern __shared__ uint4 stage[];
  __shared__ uint32_t T[3 * kTable];
  __shared__ int s_ll[36], s_ml[53];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int64_t start = rows[3 * b], nbytes = rows[3 * b + 1], bl0 = rows[3 * b + 2];
  const int64_t s0 = seq_off[b], n = seq_off[b + 1] - s0;
  // a row outside the payload, or whose sentinel lies above its bytes
  if (start < 0 || nbytes < 0 || start + nbytes > payload_len || bl0 > 8 * nbytes || n < 0) {
    if (tid == 0) {
      pos_f[b] = -1;
      err_out[b] = true;
    }
    return;
  }
  if (!any_steps) {  // no block of the batch has a sequence: nothing is read
    if (tid == 0) {
      pos_f[b] = int(bl0);
      err_out[b] = false;
    }
    return;
  }
  if (tid < 36) s_ll[tid] = kLLConst[tid];
  if (tid < 53) s_ml[tid] = kMLConst[tid];
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
  __syncthreads();
  // the tables, chain-ready; the extras of a code past its alphabet are
  // its alphabet's last, the offset's capped at 30
  for (int i = tid; i < 3 * kTable; i += kThreads) {
    const uint32_t e = uint32_t(tables[int64_t(b) * 3 * kTable + i]);
    const int c = i / kTable, sym = e & 63, nb = min(int(e >> 6 & 0x3FF), 15);
    const int extra = c == 0 ? s_ll[min(sym, 35)] >> 20 : c == 1 ? min(sym, 30)
                                                                 : s_ml[min(sym, 52)] >> 20;
    T[i] = uint32_t(nb + extra) | uint32_t(nb) << 6 | uint32_t(sym) << 10 | (e >> 16) << 16;
  }
  __syncthreads();
  const int* al_b = al + 3 * b;
  int2* rec_b = rec + s0;
  if (staged)
    decode_row(SharedBits{reinterpret_cast<const uint32_t*>(stage), 8 * (kPadBytes + mis)}, T,
               s_ll, s_ml, al_b, int(bl0), int(n), rec_b, lls + s0, mls + s0, ovs + s0,
               pos_f + b, err_out + b);
  else
    decode_row(GlobalBits{src, int(nbytes), 8 * kPadBytes}, T, s_ll, s_ml, al_b, int(bl0),
               int(n), rec_b, lls + s0, mls + s0, ovs + s0, pos_f + b, err_out + b);
}

}  // namespace

// payload: flat u8 of payload_len bytes; rows (B, 3) i64 (byte_start,
// n_bytes, bits_left0); seq_off (B + 1) i64; al (B, 3) i32 and tables
// (B, 3, 512) i32, both (ll, of, ml); any_steps: whether any block has a
// sequence; stage: the bytes of the longest row to stage in shared memory
// (a longer row reads global memory); rec (seq_off[B], 2) i32 scratch;
// lls, mls, ovs (seq_off[B],) i32; pos_f (B,) i32; err (B,) bool.
// Returns cudaGetLastError().
extern "C" int zp_fse_decode(const void* payload, long long payload_len, const void* rows,
                             const void* seq_off, const void* al, const void* tables, int B,
                             int any_steps, int stage, void* rec, void* lls, void* mls,
                             void* ovs, void* pos_f, void* err, void* stream) {
  const int smem = int(stage_bytes(stage < 0 ? 0 : stage, 15));
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};  // the attribute as set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && smem > smem_set[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fse_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return int(rc);
    smem_set[dev] = smem;
  }
  fse_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_len, static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(seq_off), static_cast<const int*>(al),
      static_cast<const int*>(tables), any_steps, smem, static_cast<int2*>(rec),
      static_cast<int*>(lls), static_cast<int*>(mls), static_cast<int*>(ovs),
      static_cast<int*>(pos_f), static_cast<bool*>(err));
  return int(cudaGetLastError());
}
