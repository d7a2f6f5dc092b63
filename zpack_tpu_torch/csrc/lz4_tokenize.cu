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
//          bytes capped at capj <= 32 (under 4 counts as 0), strictly
//          longest wins (so the walk stops at the first that reaches capj);
//   rules  p > 0, p < W - 12, ml = min(len, W - 5 - p) >= 4 (at the end of
//          the window, dictionary included);
//   out    one epilogue per wire format, for the data positions p >= dict_pad
//          only, at column p - dict_pad of a row of B = W - dict_pad (src
//          stays relative to the window start):
//            pair     src u16 (0 = none), code u8 = ml - 3;
//            u16      one u16 (src << 3) | (ml - 3), 0 = none (W <= 8192,
//                     capj <= 10);
//            hash     sorted-row order (dict_pad = 0): pos i32 and
//                     (ml << 17) | (src & 0x1FFFF) i32, src -1 = none;
//            scatter  src i32 (-1 = none), mlen i32 (0 = none);
//   est    in every mode, over the data positions of the launch's rows: the
//          sum of B - sum(ml) + 3 * count(matches), added to one int64 cell
//          (one atomicAdd per CTA after a warp-shuffle and shared-memory
//          reduction); the wrapper zeroes the cell before the launch.
//
// What bounds it: operations, not bytes of device memory (a window is read
// once and its wire arrays written once): the warp-wide instructions and the
// shared-memory accesses of the sort.  The TPU design is a bitonic sort
// network, the answer of a chip with no gather.  This card gathers from
// shared memory, so the design here is a hash chain:
//   1. the window's bytes go to shared memory once (zero past W); every
//      hash is recomputed from there and no key array exists;
//   2. the keys are (h << 16) | p and p starts in order, so the sort is a
//      stable sort of the positions by their 16-bit hash: two LSD radix
//      passes of 8 bits.  Each warp owns a contiguous stretch of a pass's
//      input and walks it 32 at a time, in order; __match_any_sync on the
//      digit gives a lane its peers, its rank is the warp's counter for the
//      digit plus its lower peers, and the lowest peer adds the count.  The
//      counters are (warp, digit) u16 in shared memory, made exclusive by
//      one block scan in digit-major, warp-minor order, which is what makes
//      a pass stable.  Counting needs no order, so it is done with atomic
//      adds (one per run of equal neighbours): the first pass's counts in a
//      walk of their own, the second pass's inside the first pass's rank
//      walk, where an element's rank says which warp will meet it.  That
//      leaves two __match_any_sync a 32 positions, about two fifths of a
//      launch on an H100.  Nothing is padded to a power of two;
//   3. all the matcher takes from the order is, for each position, its
//      nearest earlier position with the same hash: prev[p], the position
//      one sorted row above if its hash is equal, else p itself.  prev (u16,
//      in position order) takes the place of the first pass's output;
//   4. a thread takes positions in order, walks prev up to `depth` links
//      (nearest first, so on a tie the nearest wins), compares 4 bytes at a
//      time from shared memory, and the wire arrays are written in position
//      order, a warp's stores side by side.  "hash" walks the sorted rows
//      instead and writes in row order.  Once a candidate of best_len is
//      held, a farther one is compared only where its 4 bytes ending at
//      best_len agree with p's (else it cannot be strictly longer), and the
//      walk ends at a candidate of capj: the deep chains of LZ4's
//      high-compression levels cost a compare a link, not a full compare.
// Windows of up to kSmallWindow bytes (the "u16" mode's 8 KiB blocks, the
// dictionary path's 6,144 and 10,240) take a CTA of 256 threads with the
// sorted order in shared memory too, several CTAs an SM.  Larger windows
// take 1,024 threads, one CTA an SM (64 KiB of bytes, 128 KiB of u16
// positions, 32 KiB of counters), and the sorted order goes to a u16 global
// scratch from the wrapper (128 KiB a CTA, so it stays in the 50 MB L2).
// "hash" writes the order straight into its `pos` output in both shapes.
//
// scripts/torch_tokenize_profile.py compiles this file with
// -DZP_LZ4_STAGES=n (the kernel returns after step n of 5) and times the
// steps by difference.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ZP_LZ4_STAGES
#define ZP_LZ4_STAGES 5
#endif

namespace {

constexpr int kSmallWindow = 16384;  // kernels/lz4_torch.py: TOKENIZE_SMALL_WINDOW
constexpr int kSmallThreads = 256;
constexpr int kLargeThreads = 1024;
constexpr int kDigits = 256;
constexpr uint32_t kHashMul = 2654435761u;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kPad = 48;  // zero bytes kept past the window's end (> capj + 7, capj <= 32)

enum Mode { kPair = 0, kU16 = 1, kHash = 2, kScatter = 3 };

// What a sorted row holds: "hash" sorts straight into its int32 pos output.
template <int MODE> struct SortedRow { using type = uint16_t; };
template <> struct SortedRow<kHash> { using type = int32_t; };

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// The 4 bytes at p, any alignment, from shared memory (reads up to p + 7).
__device__ __forceinline__ uint32_t load_u32(const uint8_t* sdata, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(sdata) + (p >> 2);
  return __funnelshift_r(w[0], w[1], (p & 3) << 3);
}

__device__ __forceinline__ uint32_t hash16(const uint8_t* sdata, int p) {
  return (load_u32(sdata, p) * kHashMul) >> 16;
}

// Add one to the u16 counter tbl[k] for every lane with k >= 0, in any
// order: a run of neighbouring lanes with one k (a run of equal bytes gives
// such runs) adds its length once, to the half of the 32-bit word that holds
// the counter.  No counter passes 2,048 (a warp's stretch), so no half
// carries into the other.
__device__ __forceinline__ void count_keys(uint16_t* tbl, int k, int lane) {
  const int up = __shfl_up_sync(kFull, k, 1);
  const bool head = lane == 0 || up != k;
  const uint32_t heads = __ballot_sync(kFull, head);
  if (head && k >= 0) {
    const uint32_t above = lane == 31 ? 0u : heads >> (lane + 1);
    const uint32_t run = above ? __ffs(above) : 32 - lane;
    atomicAdd(reinterpret_cast<uint32_t*>(tbl) + (k >> 1), run << ((k & 1) * 16));
  }
}

// A warp's share of a pass's input: whole batches of 32, in order.
struct Stretch {
  int len, lo, hi;
  __device__ Stretch(int W, int threads, int warp)
      : len((W + threads - 1) / threads * 32), lo(warp * len), hi(min(W, lo + len)) {}
};

// Exclusive scan of the (warp, digit) u16 counters in digit-major,
// warp-minor order, which is what makes a pass stable: entry e = d * NW + w
// lives at cnt[w * kDigits + d]; a thread takes 8 entries.  Every prefix
// that is used is below 65536; the total may be 65536 and wraps only in
// entries no element reads.  Starts and ends with a barrier.
template <int NT>
__device__ __forceinline__ void scan_counters(uint16_t* cnt, int* wsum) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  int c[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = 8 * tid + k;
    c[k] = cnt[(e % NW) * kDigits + e / NW];
    sum += c[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < NW ? wsum[lane] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += n;
    }
    if (lane < NW) wsum[lane] = s - v;
  }
  __syncthreads();
  int run = wsum[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = 8 * tid + k;
    cnt[(e % NW) * kDigits + e / NW] = uint16_t(run);
    run += c[k];
  }
  __syncthreads();
}

// The counts of the first pass: how many positions of each warp's stretch
// have each low digit.
template <int NT>
__device__ __forceinline__ void count_low_digits(const uint8_t* sdata, int W, uint16_t* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Stretch st(W, NT, warp);
  for (int base = st.lo; base < st.hi; base += 32) {
    const int i = base + lane;
    count_keys(cnt, i < st.hi ? warp * kDigits + int(hash16(sdata, i) & 255) : -1, lane);
  }
}

// The rank walk of one stable radix pass over the digit (h >> SHIFT) & 255,
// after the scan of its counters.  The input is the identity order (SHIFT 0:
// position i at index i) or `in` (SHIFT 8); each warp walks its stretch 32
// at a time, in order: a lane's rank is the warp's counter for its digit
// plus its lower peers, and the lowest peer adds the count.  Element i lands
// at out[its rank].  The first pass also counts for the second: the element
// at rank r belongs to the stretch of warp r / stretch there, under its high
// digit.  Ends with a barrier.
template <int NT, int SHIFT, typename OutT>
__device__ __forceinline__ void rank_walk(const uint8_t* sdata, int W, const uint16_t* in,
                                          OutT* out, uint16_t* cnt, uint16_t* cnt_next) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lower = (1u << lane) - 1u;
  const Stretch st(W, NT, warp);
  // r / st.len for r < 65536: exact, as r * st.len < 2^32
  const uint32_t inv_len = 0xFFFFFFFFu / uint32_t(st.len) + 1u;
  uint16_t* mine = cnt + warp * kDigits;
  for (int base = st.lo; base < st.hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < st.hi;
    int d = kDigits, p = 0;  // lanes past the stretch match each other only
    uint32_t h = 0;
    if (valid) {
      p = SHIFT ? int(in[i]) : i;
      h = hash16(sdata, p);
      d = (h >> SHIFT) & 255;
    }
    const uint32_t peers = __match_any_sync(kFull, d);
    const int rank = valid ? mine[d] + __popc(peers & lower) : 0;
    __syncwarp();
    if (valid) {
      if ((peers & lower) == 0) mine[d] += uint16_t(__popc(peers));
      out[rank] = OutT(p);
    }
    if (SHIFT == 0)
      count_keys(cnt_next, valid ? int(__umulhi(rank, inv_len)) * kDigits + int(h >> 8) : -1,
                 lane);
    __syncwarp();
  }
  __syncthreads();
}

template <int MODE, int NT>
__global__ void __launch_bounds__(NT)
tokenize_kernel(const uint8_t* __restrict__ blocks, int W, int dict_pad, int depth, int capj,
                uint16_t* order_all, void* out0, void* out1, unsigned long long* est) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_matched[NW], red_seq[NW], wsum[NW];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const uint8_t* data = blocks + row * W;
  const int data_bytes = round16(W + kPad), list_bytes = round16(2 * W);
  uint8_t* sdata = smem;
  // the first pass's order, then prev
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + data_bytes);
  // (warp, digit) counters of the first pass, then of the second
  uint16_t* cnt = reinterpret_cast<uint16_t*>(smem + data_bytes + list_bytes);
  uint16_t* cnt2 = cnt + kDigits * NW;

  // 1. the window's bytes, 16 a thread where the row allows, zero past W
  const int nvec = (reinterpret_cast<uintptr_t>(data) & 15) == 0 ? W >> 4 : 0;
  for (int v = tid; v < nvec; v += NT)
    reinterpret_cast<uint4*>(sdata)[v] = reinterpret_cast<const uint4*>(data)[v];
  for (int p = nvec * 16 + tid; p < data_bytes; p += NT) sdata[p] = p < W ? data[p] : 0;
  for (int e = tid; e < kDigits * NW; e += NT) reinterpret_cast<uint32_t*>(cnt)[e] = 0;
  __syncthreads();
  if (ZP_LZ4_STAGES < 2) return;

  // 2. positions in the stable order of their hashes, low digit then high
  count_low_digits<NT>(sdata, W, cnt);
  scan_counters<NT>(cnt, wsum);
  rank_walk<NT, 0>(sdata, W, nullptr, list, cnt, cnt2);
  if (ZP_LZ4_STAGES < 3) return;
  typename SortedRow<MODE>::type* order;
  if constexpr (MODE == kHash) {
    order = static_cast<int32_t*>(out0) + row * W;
  } else {
    order = order_all ? order_all + row * W
                      : reinterpret_cast<uint16_t*>(smem + data_bytes + list_bytes +
                                                    kDigits * NW * 4);
  }
  scan_counters<NT>(cnt2, wsum);
  rank_walk<NT, 8>(sdata, W, list, order, cnt2, nullptr);
  if (ZP_LZ4_STAGES < 4) return;

  // 3. prev[p]: the position one sorted row above p's, if its hash is p's
  uint16_t* prev = list;
  for (int r = tid; r < W; r += NT) {
    const int p = int(order[r]);
    const int q = r ? int(order[r - 1]) : p;
    prev[p] = uint16_t(r && hash16(sdata, q) == hash16(sdata, p) ? q : p);
  }
  __syncthreads();
  if (ZP_LZ4_STAGES < 5) return;

  // 4. candidates along the chain; outputs in position order ("hash": rows)
  const int nd = W - dict_pad;  // data positions per row
  int matched = 0, n_seq = 0;
  for (int i = (MODE == kHash ? 0 : dict_pad) + tid; i < W; i += NT) {
    const int p = MODE == kHash ? int(order[i]) : i;
    int best_len = 0, best_src = 0;
    int c = p;
    for (int d = 0; d < depth; ++d) {
      const int n = prev[c];
      if (n == c) break;  // c is the first position of its hash
      c = n;
      // strictly longer than the best only where the 4 bytes ending at
      // best_len agree too: one compare turns most of a deep chain away
      if (best_len && load_u32(sdata, p + best_len - 3) != load_u32(sdata, c + best_len - 3))
        continue;
      int len = 0;
      for (int k = 0; k < capj; k += 4) {
        const uint32_t x = load_u32(sdata, p + k) ^ load_u32(sdata, c + k);
        if (x) {
          len = k + ((__ffs(x) - 1) >> 3);
          break;
        }
        len = k + 4;
      }
      len = min(len, capj);
      if (len >= kMinMatch && len > best_len) {
        best_len = len;
        best_src = c;
        if (len == capj) break;  // no farther candidate can be strictly longer
      }
    }
    const int ml = min(best_len, W - kLastLiterals - p);
    const bool ok = best_len >= kMinMatch && p > 0 && p < W - kMfLimit && ml >= kMinMatch;
    if (MODE == kHash) {  // pos is the order itself, already in out0
      static_cast<int32_t*>(out1)[row * W + i] =
          ((ok ? ml : 0) << 17) | ((ok ? best_src : -1) & 0x1FFFF);
    } else {
      const size_t o = row * nd + (p - dict_pad);
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
    if (ok) {
      matched += ml;
      ++n_seq;
    }
  }

  // 5. the size estimate of this row: literals plus 3 bytes a match
  for (int o = 16; o > 0; o >>= 1) {
    matched += __shfl_down_sync(kFull, matched, o);
    n_seq += __shfl_down_sync(kFull, n_seq, o);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red_matched[warp] = matched;
    red_seq[warp] = n_seq;
  }
  __syncthreads();
  if (warp == 0) {
    matched = lane < NW ? red_matched[lane] : 0;
    n_seq = lane < NW ? red_seq[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      matched += __shfl_down_sync(kFull, matched, o);
      n_seq += __shfl_down_sync(kFull, n_seq, o);
    }
    // may be negative (overlapping candidates): two's complement in the cell
    if (lane == 0)
      atomicAdd(est, static_cast<unsigned long long>(
                         static_cast<long long>(nd - matched + 3 * n_seq)));
  }
}

template <int MODE, int NT>
int launch_shape(const void* blocks, int nb, int W, int dict_pad, int depth, int capj,
                 void* order, void* out0, void* out1, void* est, void* stream) {
  // bytes, the u16 list, the counters; the sorted order too unless it is
  // global ("hash": its pos output; a large window: the wrapper's scratch)
  const bool order_shared = MODE != kHash && order == nullptr;
  const int smem = round16(W + kPad) + round16(2 * W) * (order_shared ? 2 : 1) +
                   kDigits * (NT / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tokenize_kernel<MODE, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  tokenize_kernel<MODE, NT><<<nb, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), W, dict_pad, depth, capj,
      static_cast<uint16_t*>(order), out0, out1, static_cast<unsigned long long*>(est));
  return int(cudaGetLastError());
}

template <int MODE>
int launch(const void* blocks, int nb, int W, int dict_pad, int depth, int capj, void* order,
           void* out0, void* out1, void* est, void* stream) {
  if (W <= kSmallWindow)
    return launch_shape<MODE, kSmallThreads>(blocks, nb, W, dict_pad, depth, capj, nullptr,
                                             out0, out1, est, stream);
  if (MODE != kHash && order == nullptr) return int(cudaErrorInvalidValue);
  return launch_shape<MODE, kLargeThreads>(blocks, nb, W, dict_pad, depth, capj, order, out0,
                                           out1, est, stream);
}

}  // namespace

// blocks (nb, W) u8, each row dict_pad dictionary bytes then the data; order
// (nb, W) u16 scratch for W > 16384 in every mode but hash, else unused (may
// be null); mode 0 pair: out0 (nb, W - dict_pad) u16, out1 the same u8; 1
// u16: out0 u16, out1 unused; 2 hash (dict_pad 0): out0, out1 (nb, W) i32; 3
// scatter: out0, out1 (nb, W - dict_pad) i32; est one int64 cell the caller
// zeroed.  Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown mode or a missing scratch.
extern "C" int zp_lz4_tokenize(const void* blocks, int nb, int W, int dict_pad, int depth,
                               int capj, int mode, void* order, void* out0, void* out1,
                               void* est, void* stream) {
  switch (mode) {
    case kPair:
      return launch<kPair>(blocks, nb, W, dict_pad, depth, capj, order, out0, out1, est,
                           stream);
    case kU16:
      return launch<kU16>(blocks, nb, W, dict_pad, depth, capj, order, out0, out1, est,
                          stream);
    case kHash:
      return launch<kHash>(blocks, nb, W, dict_pad, depth, capj, order, out0, out1, est,
                           stream);
    case kScatter:
      return launch<kScatter>(blocks, nb, W, dict_pad, depth, capj, order, out0, out1, est,
                              stream);
  }
  return int(cudaErrorInvalidValue);
}
