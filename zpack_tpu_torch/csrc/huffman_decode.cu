// zstd Huffman literal-stream decode for Hopper (sm_90a): one thread per stream.
//
// Replaces zpack_tpu/kernels/huffman_jax.py:decode_streams_scan and its
// opt-in twin decode_streams (driven by DeviceHuffmanDecoder), the literal
// stage of the zstd extract path.  The contract is
// codecs/zstd/huffman.py:_decode_one_stream, stated in plain PyTorch by
// zpack_tpu_torch/kernels/huffman_torch.py:decode_streams_plain.
//
// A stream is read backward from its sentinel bit, one symbol per step, and
// each step depends on the bit count of the one before: the decode is a
// chain.  The TPU design walks every stream in lockstep in a lax.scan, two
// symbols per gathered 32-bit window, because a TPU has no cheap scalar
// loop.  Here each thread walks one stream: it keeps a 64-bit window of the
// stream's bits in a register and refills it with eight byte loads when the
// next code would reach below it (every four symbols or more), looks the code
// up in the stream's table (2048 entries, read through the L1 cache: the
// four streams of a literal section share one), and writes the symbol
// straight to its place in the output, which the extract path makes the
// frame's literal row.
//
// What bounds it: the chain of the longest stream, about a table load and a
// few integer operations per symbol; all streams run at once.  Reads outside
// a stream's bytes give zeros, as the scan's zero padding does; a write
// outside the output, or a row whose table is out of range, is skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 7;  // byte_start, n_bytes, start_bit, n_syms, dst_off, table, max_bits
constexpr int kTable = 2048;
constexpr int kThreads = 32;

__device__ __forceinline__ int64_t floor_div8(int64_t x) { return x >= 0 ? x / 8 : -((7 - x) / 8); }

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ payload, int64_t payload_len,
                      const int64_t* __restrict__ rows, int S, const int* __restrict__ tables,
                      int T, uint8_t* __restrict__ out, int64_t n_out,
                      int* __restrict__ final_bits) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int64_t* r = rows + int64_t(s) * kCols;
  const int64_t start = r[0], nbytes = r[1], n = r[3], dst = r[4], tab = r[5];
  const int mb = int(r[6]);
  int64_t p = r[2];
  if (tab < 0 || tab >= T || mb < 1 || mb > 11 || start < 0 || nbytes < 0 ||
      start + nbytes > payload_len) {
    final_bits[s] = -1;
    return;
  }
  const uint8_t* src = payload + start;
  const int* t = tables + tab * kTable;
  const uint64_t mask = (1ull << mb) - 1;
  int64_t base = INT64_MAX;  // the window holds bits [base, base + 64); none yet
  uint64_t bits = 0;
  int64_t fin = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t lo = p - mb;  // the code is bits [lo, p)
    if (lo < base) {
      // the lowest byte-aligned window whose top still covers p
      base = floor_div8(p - 57) * 8;
      bits = 0;
      const int64_t b0 = base / 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t b = b0 + j;
        if (b >= 0 && b < nbytes) bits |= uint64_t(src[b]) << (8 * j);
      }
    }
    const int e = __ldg(t + ((bits >> (lo - base)) & mask));
    const int nb = e >> 8;
    const int64_t d = dst + k;
    if (d >= 0 && d < n_out) out[d] = uint8_t(e & 0xFF);
    if (k == n - 1) fin = p - nb;
    p = p > nb ? p - nb : 0;
  }
  final_bits[s] = int(fin);
}

}  // namespace

// payload: flat u8 of payload_len bytes; rows (S, 7) i64; tables (T, 2048)
// i32 sym | nbits << 8; out: zeroed u8 of n_out bytes; final_bits (S,) i32.
// Returns cudaGetLastError().
extern "C" int zp_huffman_decode(const void* payload, long long payload_len, const void* rows,
                                 int S, const void* tables, int T, void* out, long long n_out,
                                 void* final_bits, void* stream) {
  huffman_decode_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_len, static_cast<const int64_t*>(rows), S,
      static_cast<const int*>(tables), T, static_cast<uint8_t*>(out), n_out,
      static_cast<int*>(final_bits));
  return int(cudaGetLastError());
}
