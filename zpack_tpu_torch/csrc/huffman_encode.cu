// zstd Huffman literal-stream encode for Hopper (sm_90a): one CTA per stream.
//
// Replaces zpack_tpu/kernels/huffman_jax.py:_encode_one_stream and
// encode_streams (driven by DeviceHuffmanEncoder), the literal stage of the
// zstd compress path.  The contract is the bits of
// codecs/zstd/huffman.py:_encode_stream, stated in plain PyTorch by
// zpack_tpu_torch/kernels/huffman_torch.py:encode_streams_plain.
//
// The TPU design looks every symbol up with an int8 one-hot matmul, because
// per-stream gathers are slow there, and combines symbols in five tree
// rounds into 32-symbol groups, because its scatters are the scarce
// resource.  Neither cost exists here: the stream's 256-entry table sits in
// shared memory, each thread takes a contiguous run of symbols, one
// block-wide exclusive scan of the runs' bit counts gives every symbol its
// bit offset, and each thread ORs its codes into the zeroed output plane.
// Symbols later in the stream sit at lower bits, so a run's codes fill
// descending words: the thread builds each word in a register and makes one
// atomicOr per word it touches, not one per code.
//
// What bounds it: the two passes over the symbols (each thread reads its
// own run byte by byte, an uncoalesced pattern that the L1 absorbs) and the
// atomics, about one per output word plus two per thread at the edges of its
// run.  A stream of n symbols costs n / 256 dependent steps per thread.  The
// output sizes come from the host, which already counted every stream's
// bits; a word outside the stream's range is never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per table entry for the load
constexpr int kWarps = kThreads / 32;

struct WordWriter {
  uint32_t* out;
  int64_t n_words;
  int64_t cur = -1;
  uint32_t acc = 0;

  __device__ void flush() {
    if (cur >= 0 && cur < n_words && acc) atomicOr(out + cur, acc);
  }
  // word indices arrive in non-increasing order within one thread's run
  __device__ void put(int64_t w, uint32_t v) {
    if (w != cur) {
      flush();
      cur = w;
      acc = v;
    } else {
      acc |= v;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
huffman_encode_kernel(const uint8_t* __restrict__ syms, const int64_t* __restrict__ rows,
                      const int* __restrict__ tables, const int64_t* __restrict__ word_off,
                      uint32_t* __restrict__ words, int* __restrict__ total_bits) {
  __shared__ uint32_t tab[256];
  __shared__ int warp_incl[kWarps];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tab[threadIdx.x] = static_cast<uint32_t>(tables[int64_t(s) * 256 + threadIdx.x]);
  __syncthreads();

  const uint8_t* p = syms + rows[2 * s];
  const int64_t n = rows[2 * s + 1];
  const int64_t run = (n + kThreads - 1) / kThreads;
  const int64_t lo = min(n, run * threadIdx.x), hi = min(n, lo + run);

  // pass 1: the bits of this thread's run
  int mine = 0;
  for (int64_t i = lo; i < hi; ++i) mine += tab[p[i]] >> 16;

  // block-wide inclusive scan: within each warp, then over the warp totals
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_incl[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const int total = warp_incl[kWarps - 1];
  int c = incl - mine + (warp ? warp_incl[warp - 1] : 0);  // bits before the run

  // pass 2: symbol i occupies bits [total - incl_cumsum(len)[i], +len)
  const int64_t base = word_off[s];
  WordWriter wr{words + base, word_off[s + 1] - base};
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t e = tab[p[i]];
    const int len = min(int(e >> 16), 16);
    c += len;
    const int pos = total - c;
    const uint64_t v = uint64_t(e & ((1u << len) - 1)) << (pos & 31);
    const uint32_t spill = uint32_t(v >> 32);
    if (spill) wr.put((pos >> 5) + 1, spill);
    wr.put(pos >> 5, uint32_t(v));
  }
  wr.flush();
  if (threadIdx.x == 0) {
    // the closing sentinel bit (the decoder's start marker)
    if ((total >> 5) < wr.n_words) atomicOr(wr.out + (total >> 5), 1u << (total & 31));
    total_bits[s] = total;
  }
}

}  // namespace

// syms flat u8; rows (S, 2) i64 (start, n); tables (S, 256) i32
// code | len << 16; word_off (S + 1) i64; words: the zeroed u32 plane;
// total_bits (S,) i32.  Returns cudaGetLastError().
extern "C" int zp_huffman_encode(const void* syms, const void* rows, const void* tables,
                                 const void* word_off, int S, void* words, void* total_bits,
                                 void* stream) {
  huffman_encode_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int64_t*>(rows),
      static_cast<const int*>(tables), static_cast<const int64_t*>(word_off),
      static_cast<uint32_t*>(words), static_cast<int*>(total_bits));
  return int(cudaGetLastError());
}
