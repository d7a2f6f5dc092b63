// LZ4 match finder for Hopper (sm_90a): one CTA per window of W <= 65536
// bytes (a block, or a shared dictionary followed by a block).
//
// Replaces zpack_tpu/kernels/lz4_pallas.py:_tokenize_kernel (the Pallas TPU
// kernel, match-length cap 16) and its XLA siblings in
// zpack_tpu/kernels/lz4_jax.py, which share one matcher and differ in the
// last step: tokenize_block_resort ("pair", the main path at 64 KiB blocks),
// tokenize_block_u16, tokenize_block_noscatter and tokenize_block; and the
// size estimate `_est` of zpack_tpu/parallel/pipeline.py:_step_fn.  The
// function is stated in plain PyTorch by
// zpack_tpu_torch/kernels/lz4_torch.py:tokenize_plain and est_plain:
//   hash   h[p] = (u32le(p..p+3) * 2654435761 mod 2^32) >> 16, zero past W;
//   sort   keys (h << 16) | p (unique, so any correct sort gives one order);
//   match  the `depth` sorted rows above with the same h are the nearest
//          earlier same-hash positions; a candidate scores its leading equal
//          bytes capped at capj (under 4 counts as 0), strictly longest wins;
//   rules  p > 0, p < W - 12, ml = min(len, W - 5 - p) >= 4 (at the end of
//          the window, dictionary included);
//   out    one epilogue per wire format, for the data positions p >= dict_pad
//          only, at column p - dict_pad of a row of B = W - dict_pad (src
//          stays relative to the window start):
//            pair     src u16 (0 = none), code u8 = ml - 3;
//            u16      one u16 (src << 3) | (ml - 3), 0 = none (W <= 8192,
//                     capj <= 10).  Positions are unique, so the TPU's second
//                     sort back to position order is a plain scatter here;
//            hash     sorted-row order (dict_pad = 0): pos i32 and
//                     (ml << 17) | (src & 0x1FFFF) i32, src -1 = none;
//            scatter  src i32 (-1 = none), mlen i32 (0 = none);
//   est    in every mode, over the data positions of the launch's rows: the
//          sum of B - sum(ml) + 3 * count(matches), added to one int64 cell
//          (one atomicAdd per CTA after a warp-shuffle and shared-memory
//          reduction); the wrapper zeroes the cell before the launch.
//
// What bounds it: the sort.  A 64 KiB block has 65536 u32 keys (256 KiB),
// more than the 227 KB of shared memory one CTA can have, so the Pallas
// design (the whole sort network resident in VMEM) does not map onto a CTA.
// Here the keys live in a global scratch buffer from the wrapper (256 KiB a
// block, ~33 MB for the 132 resident CTAs, so it stays in the 50 MB L2), and
// the bitonic sort runs every substage whose partner distance is below kTile
// on a kTile-key tile in shared memory; only substages with a distance of
// kTile or more (one of the 136 at 64 KiB) go through L2.  The window words
// the TPU design carries through its sort are not needed: after the sort the
// block's bytes sit in shared memory and each candidate is compared byte by
// byte from there, and results scatter straight to position order.
// Faster designs (a shared-memory hash-head table, a DSMEM cluster sort)
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 32768;  // keys per shared-memory tile (128 KiB)
constexpr uint32_t kHashMul = 2654435761u;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kPad = 32;  // zero bytes kept past the block end (>= capj)

__device__ __forceinline__ uint32_t make_key(const uint8_t* data, int B, int p) {
  if (p >= B) return 0xFFFFFFFFu;  // padding sorts after every real key
  uint32_t u = 0;
  for (int s = 0; s < 4; ++s)
    if (p + s < B) u |= uint32_t(data[p + s]) << (8 * s);
  return (((u * kHashMul) >> 16) << 16) | uint32_t(p);
}

// One bitonic substage over keys[0, n): partner i + j, ascending where
// ((base + i) & k) == 0, base being the global index of keys[0].
__device__ __forceinline__ void substage(uint32_t* keys, int n, int base, int k, int j) {
  for (int q = threadIdx.x; q < n / 2; q += blockDim.x) {
    const int i = 2 * q - (q & (j - 1));
    const uint32_t x = keys[i], y = keys[i + j];
    const bool asc = ((base + i) & k) == 0;
    if ((x > y) == asc) {
      keys[i] = y;
      keys[i + j] = x;
    }
  }
}

// Substages (k, j_hi), (k, j_hi / 2), ..., (k, 1) on every tile of keys.
__device__ void tile_pass(uint32_t* keys, uint32_t* tile_keys, int np2, int tile, int k,
                          int j_hi) {
  for (int t0 = 0; t0 < np2; t0 += tile) {
    for (int p = threadIdx.x; p < tile; p += blockDim.x) tile_keys[p] = keys[t0 + p];
    __syncthreads();
    for (int j = j_hi; j > 0; j >>= 1) {
      substage(tile_keys, tile, t0, k, j);
      __syncthreads();
    }
    for (int p = threadIdx.x; p < tile; p += blockDim.x) keys[t0 + p] = tile_keys[p];
    __syncthreads();
  }
}

enum Mode { kPair = 0, kU16 = 1, kHash = 2, kScatter = 3 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
tokenize_kernel(const uint8_t* __restrict__ blocks, int B, int np2, int dict_pad, int depth,
                int capj, uint32_t* __restrict__ keys_all, void* __restrict__ out0,
                void* __restrict__ out1, unsigned long long* __restrict__ est) {
  // B is the window here: dict_pad dictionary bytes, then the data bytes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_matched[kThreads / 32], red_seq[kThreads / 32];
  uint32_t* tile_keys = reinterpret_cast<uint32_t*>(smem);
  const size_t row = blockIdx.x;
  const uint8_t* data = blocks + row * B;
  uint32_t* keys = keys_all + row * np2;
  const int tile = np2 < kTile ? np2 : kTile;

  // 1. hash keys, each tile sorted in shared memory (every stage k <= tile)
  for (int t0 = 0; t0 < np2; t0 += tile) {
    for (int p = threadIdx.x; p < tile; p += blockDim.x)
      tile_keys[p] = make_key(data, B, t0 + p);
    __syncthreads();
    for (int k = 2; k <= tile; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        substage(tile_keys, tile, t0, k, j);
        __syncthreads();
      }
    for (int p = threadIdx.x; p < tile; p += blockDim.x) keys[t0 + p] = tile_keys[p];
    __syncthreads();
  }
  // 2. the stages k > tile: far substages in global (L2), near ones in tiles
  for (int k = 2 * tile; k <= np2; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      substage(keys, np2, 0, k, j);
      __syncthreads();
    }
    tile_pass(keys, tile_keys, np2, tile, k, tile >> 1);
  }

  // 3. the block's bytes (zero past B) into the shared memory the sort used
  uint8_t* sdata = smem;
  for (int p = threadIdx.x; p < B + kPad; p += blockDim.x) sdata[p] = p < B ? data[p] : 0;
  __syncthreads();

  // 4. candidates from the sorted neighbours; rows [0, B) hold the real keys
  const int nd = B - dict_pad;  // data positions per row
  int matched = 0, n_seq = 0;
  for (int r = threadIdx.x; r < B; r += blockDim.x) {
    const uint32_t key = keys[r];
    const uint32_t h = key >> 16;
    const int p = int(key & 0xFFFFu);
    int best_len = 0, best_src = 0;
    for (int d = 1; d <= depth && r - d >= 0; ++d) {
      const uint32_t kd = keys[r - d];
      if ((kd >> 16) != h) break;  // same hashes are contiguous in the order
      // kd's position is earlier than p and at most 65535 before it
      const int c = int(kd & 0xFFFFu);
      int len = 0;
      while (len < capj && sdata[p + len] == sdata[c + len]) ++len;
      if (len >= kMinMatch && len > best_len) {
        best_len = len;
        best_src = c;
      }
    }
    const int ml = min(best_len, B - kLastLiterals - p);
    const bool ok = best_len >= kMinMatch && p > 0 && p < B - kMfLimit && ml >= kMinMatch;
    const int q = p - dict_pad;
    if (MODE == kHash) {  // sorted-row order; the wrapper admits no dictionary
      static_cast<int32_t*>(out0)[row * B + r] = p;
      static_cast<int32_t*>(out1)[row * B + r] =
          ((ok ? ml : 0) << 17) | ((ok ? best_src : -1) & 0x1FFFF);
    } else if (q >= 0) {
      const size_t o = row * nd + q;
      if (MODE == kPair) {
        static_cast<uint16_t*>(out0)[o] = uint16_t(ok ? best_src : 0);
        static_cast<uint8_t*>(out1)[o] = uint8_t(ok ? ml - 3 : 0);
      } else if (MODE == kU16) {
        static_cast<uint16_t*>(out0)[o] = uint16_t(ok ? (best_src << 3) | (ml - 3) : 0);
      } else {
        static_cast<int32_t*>(out0)[o] = ok ? best_src : -1;
        static_cast<int32_t*>(out1)[o] = ok ? ml : 0;
      }
    }
    if (ok && q >= 0) {
      matched += ml;
      ++n_seq;
    }
  }

  // 5. the size estimate of this row: literals plus 3 bytes a match
  for (int o = 16; o > 0; o >>= 1) {
    matched += __shfl_down_sync(0xFFFFFFFFu, matched, o);
    n_seq += __shfl_down_sync(0xFFFFFFFFu, n_seq, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_matched[warp] = matched;
    red_seq[warp] = n_seq;
  }
  __syncthreads();
  if (warp == 0) {
    matched = red_matched[lane];
    n_seq = red_seq[lane];
    for (int o = 16; o > 0; o >>= 1) {
      matched += __shfl_down_sync(0xFFFFFFFFu, matched, o);
      n_seq += __shfl_down_sync(0xFFFFFFFFu, n_seq, o);
    }
    // may be negative (overlapping candidates): two's complement in the cell
    if (lane == 0)
      atomicAdd(est, static_cast<unsigned long long>(
                         static_cast<long long>(nd - matched + 3 * n_seq)));
  }
}

template <int MODE>
int launch(const void* blocks, int nb, int B, int np2, int dict_pad, int depth, int capj,
           void* keys, void* out0, void* out1, void* est, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tokenize_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  tokenize_kernel<MODE><<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), B, np2, dict_pad, depth, capj,
      static_cast<uint32_t*>(keys), out0, out1, static_cast<unsigned long long*>(est));
  return int(cudaGetLastError());
}

}  // namespace

// blocks (nb, W) u8, each row dict_pad dictionary bytes then the data; keys
// (nb, np2) u32 scratch, np2 = next power of two >= W; mode 0 pair: out0 (nb,
// W - dict_pad) u16, out1 the same u8; 1 u16: out0 u16, out1 unused; 2 hash
// (dict_pad 0): out0, out1 (nb, W) i32; 3 scatter: out0, out1 (nb, W -
// dict_pad) i32; est one int64 cell the caller zeroed.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown mode.
extern "C" int zp_lz4_tokenize(const void* blocks, int nb, int W, int dict_pad, int depth,
                               int capj, int mode, void* keys, void* out0, void* out1,
                               void* est, void* stream) {
  int np2 = 1;
  while (np2 < W) np2 <<= 1;
  const int tile = np2 < kTile ? np2 : kTile;
  const int smem = max(tile * 4, W + kPad);
  switch (mode) {
    case kPair:
      return launch<kPair>(blocks, nb, W, np2, dict_pad, depth, capj, keys, out0, out1, est,
                           smem, stream);
    case kU16:
      return launch<kU16>(blocks, nb, W, np2, dict_pad, depth, capj, keys, out0, out1, est,
                          smem, stream);
    case kHash:
      return launch<kHash>(blocks, nb, W, np2, dict_pad, depth, capj, keys, out0, out1, est,
                           smem, stream);
    case kScatter:
      return launch<kScatter>(blocks, nb, W, np2, dict_pad, depth, capj, keys, out0, out1,
                              est, smem, stream);
  }
  return int(cudaErrorInvalidValue);
}
