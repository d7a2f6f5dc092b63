// zstd Huffman literal-stream encode for Hopper (sm_90a): a CTA a stream.
//
// Replaces zpack_tpu/kernels/huffman_jax.py:_encode_one_stream and
// encode_streams (driven by DeviceHuffmanEncoder), the literal stage of the
// zstd compress path.  The contract is the bits of
// codecs/zstd/huffman.py:_encode_stream, stated in plain PyTorch by
// zpack_tpu_torch/kernels/huffman_torch.py:encode_streams_plain: in a stream
// of `bits` bits, symbol i sits at bit bits - incl_cumsum(len)[i] of the
// stream's little-endian words, symbol 0 highest, the sentinel at `bits`.
//
// The TPU design looks every symbol up with an int8 one-hot matmul and
// combines symbols in five tree rounds, because gathers and scatters are
// scarce there.  Here the work is small (on the zstd path about 0.6 MB of
// symbols in, 0.5 MB of words out: a fraction of a microsecond of bytes at
// the card's rate), so what bounds the kernel is its launch, which lies
// above the bytes' time, and then the latency of each tile of the longest
// stream.  The design does each byte's work once, with few instructions:
//
// * One pass over the symbols: the host counted each stream's bits, so a
//   symbol sits at bit bits - G, G the running sum of code lengths up to and
//   including it.  Each thread loads one aligned 16-byte group of symbols
//   (neighbouring threads on neighbouring groups; the ragged head and tail
//   masked), looks its 16 codes up in the stream's table, staged in shared
//   memory as `code | len << 12` in 16 bits, and a warp-shuffle scan plus
//   one cross-warp step gives every thread its G.  The next tile's group is
//   loaded before this tile is packed.
// * Branch-free packing: each thread shifts its codes into an 8-word
//   register value with funnel shifts (symbol 0 highest), shifts that to
//   its bit offset, stores the words it covers whole into the tile's window
//   of shared words, and ORs only its two edge words (shared atomics).
// * Words stored whole: the CTA stores every word of the window once,
//   coalesced, zeros and the sentinel included, and carries the partial
//   lowest word into the next tile.  The plane needs no memset and the
//   kernel makes no global atomic.
// * The kernel sums the stream's bits itself (`total_bits`); the wrapper
//   raises if they disagree with the host's count, since the positions came
//   from it.  Where they disagree the words are undefined, but no word
//   outside the stream's range is written.
//
// A CTA of 256 threads a stream: a tile is 4,096 symbols, and of 64 and 128
// threads a stream, 256 was the fastest on the zstd path's batch.  A CTA a
// zstd block (the block's four streams under their one table, a segmented
// walk) was measured beside it and lost: the longest block's walk is four
// times the longest stream's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;  // symbols a thread loads at once: one uint4
constexpr int kMaxLen = 15;  // the largest length the 4-bit field holds
constexpr int kLimbs = (kGroup * kMaxLen + 31) / 32;  // a thread's codes: 8 words
constexpr int kCols = 5;  // rows: start, n, table, bits, word
constexpr int T = 256;  // threads a CTA
constexpr int kWarps = T / 32;
constexpr int kSyms = kGroup * T;  // symbols a tile

__global__ void __launch_bounds__(T)
huffman_encode_kernel(const uint8_t* __restrict__ syms, const int64_t* __restrict__ rows,
                      const uint16_t* __restrict__ tables, uint32_t* __restrict__ words,
                      int* __restrict__ total_bits) {
  // a tile's window: its codes, the carried word above them and rounding
  constexpr int kWords = kSyms * kMaxLen / 32 + 2;
  __shared__ __align__(16) uint16_t tab[256];
  __shared__ uint32_t buf[kWords];
  __shared__ int warp_sum[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t* row = rows + kCols * int64_t(blockIdx.x);
  const uint8_t* first = syms + row[0];
  const int N = int(row[1]);
  const int bits = int(row[3]);
  const int64_t word0 = row[4];
  const int head = int(reinterpret_cast<uintptr_t>(first) & 15u);
  const uint4* g0 = reinterpret_cast<const uint4*>(first - head);
  const int n_groups = (N + head + kGroup - 1) / kGroup;
  const int n_tiles = max(1, (n_groups + T - 1) / T);
  uint4 cur = make_uint4(0u, 0u, 0u, 0u);
  if (tid < n_groups) cur = __ldg(g0 + tid);
  if (tid < 32) {
    reinterpret_cast<uint4*>(tab)[tid] =
        __ldg(reinterpret_cast<const uint4*>(tables + 256 * row[2]) + tid);
  }
  for (int s = tid; s < kWords; s += T) buf[s] = 0u;
  __syncthreads();
  int top = bits >> 5;  // the window's top word, local; the sentinel's word at first
  int gbase = 0;        // G before this tile

  for (int k = 0; k < n_tiles; ++k) {
    const int g = k * T + tid;
    uint4 nxt = make_uint4(0u, 0u, 0u, 0u);
    if (g + T < n_groups) nxt = __ldg(g0 + g + T);
    const int v0 = kGroup * g - head;  // the stream's index of this group's byte 0
    uint32_t e[kGroup];
    int tsum = 0;
    const uint32_t wv[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint32_t entry = tab[(wv[j >> 2] >> (8 * (j & 3))) & 0xFFu];
      e[j] = (unsigned(v0 + j) < unsigned(N)) ? entry : 0u;
      tsum += int(e[j] >> 12);
    }
    // the tile's scan of the threads' bits: shuffles in the warp, then each
    // thread sums the warps before its own
    int incl = tsum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, tile_bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      before += (w < warp) ? s : 0;
      tile_bits += s;
    }
    // the window [lo, top] of local words this tile writes: down to the
    // word of its last field, carried unless this is the last tile
    const bool final_tile = k == n_tiles - 1;
    int lo = final_tile ? 0 : (bits - gbase - tile_bits) >> 5;
    lo = min(max(max(lo, 0), top - kWords + 1), top);

    if (tsum > 0) {
      // this thread's codes as one value, symbol 0 highest, then shifted to
      // its lowest bit p
      uint32_t v[kLimbs] = {};
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const uint32_t len = e[j] >> 12;
#pragma unroll
        for (int i = kLimbs - 1; i > 0; --i) v[i] = __funnelshift_l(v[i - 1], v[i], len);
        v[0] = (v[0] << len) | (e[j] & 0xFFFu & ((1u << len) - 1u));
      }
      const int p = bits - (gbase + before + incl);
      const int sh = p & 31, w0 = p >> 5;
      const int last = (sh + tsum - 1) >> 5;  // words w0 .. w0 + last
#pragma unroll
      for (int i = 0; i <= kLimbs; ++i) {
        const uint32_t x = i == 0 ? v[0] << sh
                         : i == kLimbs ? __funnelshift_l(v[kLimbs - 1], 0u, sh)
                                       : __funnelshift_l(v[i - 1], v[i], sh);
        const int w = w0 + i;
        if (i <= last && w >= lo && w <= top) {
          if (i == 0 || i == last) atomicOr(buf + (top - w), x);  // shared with a neighbour
          else buf[top - w] = x;  // every bit of it is this thread's
        }
      }
    }
    if (tid == 0 && (bits >> 5) >= lo && (bits >> 5) <= top) {
      atomicOr(buf + (top - (bits >> 5)), 1u << (bits & 31));  // the sentinel
    }
    __syncthreads();

    // store the window whole, top word first; the carried word waits
    const int n_store = final_tile ? top - lo + 1 : top - lo;
    for (int s = tid; s < n_store; s += T) words[word0 + top - s] = buf[s];
    const uint32_t carry = buf[top - lo];
    __syncthreads();
    for (int s = tid; s <= top - lo; s += T) buf[s] = (s == 0) ? carry : 0u;
    top = lo;
    gbase += tile_bits;
    cur = nxt;
  }
  if (tid == 0) total_bits[blockIdx.x] = gbase;
}

__global__ void empty_kernel() {}

}  // namespace

// syms flat u8 (16-byte aligned base); rows (S, 5) i64 (start, n, table,
// bits, word); tables (T, 256) u16 code | len << 12, 16-byte aligned;
// words: the u32 plane, every word of each row's range [word, word + bits /
// 32 + 1) written; total_bits (S,) i32.  A CTA of 256 threads a row.
// Returns cudaGetLastError().
extern "C" int zp_huffman_encode(const void* syms, const void* rows, const void* tables, int S,
                                 void* words, void* total_bits, void* stream) {
  huffman_encode_kernel<<<S, T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int64_t*>(rows),
      static_cast<const uint16_t*>(tables), static_cast<uint32_t*>(words),
      static_cast<int*>(total_bits));
  return int(cudaGetLastError());
}

// An empty kernel launched on the same grid and CTA size, through the same
// kind of call: the floor under any launch's time.  For timing only.
extern "C" int zp_launch_floor(int grid, void* stream) {
  empty_kernel<<<grid, T, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}
