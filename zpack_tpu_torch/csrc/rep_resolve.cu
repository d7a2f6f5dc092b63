// zstd repeat-offset resolution for Hopper (sm_90a): one CTA per block, a
// scan of maps in place of a walk; two entry points.
//
// Replaces zpack_tpu/kernels/fse_jax.py:rep_prefix_maps and apply_rep_maps,
// the repeat-offset stage of the zstd extract path.  The contracts are stated
// in plain PyTorch by zpack_tpu_torch/kernels/fse_torch.py:rep_totals_plain
// and rep_apply_plain.
//
// A sequence's raw offset value updates the three repeat offsets (r0, r1,
// r2) by one of seven maps out_j = in[sel_j] + val_j, or a constant; a
// family closed under composition, associative and not commutative.  So a
// block is no chain: its maps are scanned.  One CTA of 1,024 threads takes a
// block, a tile of 1,024 sequences at a time, one sequence a thread, read
// coalesced straight from the flat arrays (the next tile's loads are issued
// before this tile's scan).  A map is four words (three 2-bit selectors in
// one, three int32 values): an inclusive scan by __shfl_up_sync inside each
// warp, the 32 warp totals scanned by warp 0 through shared memory, and a
// carry from tile to tile, earlier maps first throughout.
//   rep_totals keeps the block's total map (the carry after the last tile)
//              and sums its literal and match lengths by a block reduction
//              (for the host's layout checks);
//   rep_apply  applies each thread's inclusive prefix to the block's entry
//              state, stores the resolved offset (r0) coalesced and flags one
//              <= 0 by __syncthreads_or.
// The host stitches each block's entry state from the totals between the two
// launches.  The (B, N, 3) prefix maps never exist.  Values add in 32-bit
// two's complement, as the int32 maps of the TPU scan do.
//
// What bounds it: the bytes, three or four int32 a sequence, each once; the
// scan is some hundred integer operations a sequence beside them, and a block
// of 11,000 sequences is 11 tiles of two barriers each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // one tile: a sequence a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// out_j = in[sel_j] + v_j, or v_j where sel_j == 3; sel_j at bits 2j, 2j + 1
struct Map {
  int sel, v0, v1, v2;
};

__device__ __forceinline__ Map identity() { return {0 | 1 << 2 | 2 << 4, 0, 0, 0}; }

// the map of one sequence with raw offset value ov and literal length ll
__device__ __forceinline__ Map seq_map(int ov, int ll) {
  const bool litz = ll == 0, is_new = ov > 3;
  const bool c2 = (!litz && ov == 2) || (litz && ov == 1);  // (r1, r0, r2)
  const bool c3 = (!litz && ov == 3) || (litz && ov == 2);  // (r2, r0, r1)
  const bool cd = litz && ov == 3;                          // (r0 - 1, r0, r1)
  const int s0 = is_new ? 3 : c2 ? 1 : c3 ? 2 : 0;
  const int s1 = (is_new || c2 || c3 || cd) ? 0 : 1;
  const int s2 = (is_new || c3 || cd) ? 1 : 2;
  return {s0 | s1 << 2 | s2 << 4, is_new ? ov - 3 : cd ? -1 : 0, 0, 0};
}

__device__ __forceinline__ int add32(int a, int b) { return int(uint32_t(a) + uint32_t(b)); }

// component j of `b` applied after `a`: selector sb and value bv of b
__device__ __forceinline__ void after1(const Map& a, int sb, int bv, int* s, int* v) {
  if (sb == 3) {
    *s = 3;
    *v = bv;
  } else {
    *s = (a.sel >> (2 * sb)) & 3;
    *v = add32(sb == 0 ? a.v0 : sb == 1 ? a.v1 : a.v2, bv);
  }
}

// the map `b` applied after `a` (a is the earlier one)
__device__ __forceinline__ Map after(const Map& a, const Map& b) {
  int s0, s1, s2;
  Map r;
  after1(a, b.sel & 3, b.v0, &s0, &r.v0);
  after1(a, (b.sel >> 2) & 3, b.v1, &s1, &r.v1);
  after1(a, (b.sel >> 4) & 3, b.v2, &s2, &r.v2);
  r.sel = s0 | s1 << 2 | s2 << 4;
  return r;
}

__device__ __forceinline__ Map warp_scan(Map m, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Map p;
    p.sel = __shfl_up_sync(kFull, m.sel, d);
    p.v0 = __shfl_up_sync(kFull, m.v0, d);
    p.v1 = __shfl_up_sync(kFull, m.v1, d);
    p.v2 = __shfl_up_sync(kFull, m.v2, d);
    if (lane >= d) m = after(p, m);
  }
  return m;
}

// Inclusive scan of the CTA's maps in thread order; *total is the tile's
// composition.  `sw` holds kWarps maps; callers alternate two such buffers
// from tile to tile, so a warp that runs ahead never overwrites what a slow
// one still reads.
__device__ __forceinline__ Map tile_scan(Map m, Map* sw, Map* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_scan(m, lane);
  if (lane == 31) sw[warp] = m;
  __syncthreads();
  if (warp == 0) sw[lane] = warp_scan(sw[lane], lane);
  __syncthreads();
  if (warp > 0) m = after(sw[warp - 1], m);
  *total = sw[kWarps - 1];
  return m;
}

__global__ void __launch_bounds__(kThreads)
rep_totals_kernel(const int* __restrict__ ovs, const int* __restrict__ lls,
                  const int* __restrict__ mls, const int64_t* __restrict__ seq_off,
                  int* __restrict__ sel_out, int* __restrict__ val_out,
                  int64_t* __restrict__ sums) {
  __shared__ Map sw[2][kWarps];
  __shared__ int64_t ssum[2][kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int64_t beg = seq_off[b];
  const int n = int(seq_off[b + 1] - beg);
  Map carry = identity();
  int64_t sum_ll = 0, sum_ml = 0;
  int ov = 0, ll = 0, ml = 0;
  if (tid < n) ov = ovs[beg + tid], ll = lls[beg + tid], ml = mls[beg + tid];
  for (int base = 0, tile = 0; base < n; base += kThreads, ++tile) {
    const Map m = base + tid < n ? seq_map(ov, ll) : identity();
    sum_ll += ll;
    sum_ml += ml;
    const int64_t nx = beg + base + kThreads + tid;
    ov = ll = ml = 0;
    if (base + kThreads + tid < n) ov = ovs[nx], ll = lls[nx], ml = mls[nx];
    Map total;
    tile_scan(m, sw[tile & 1], &total);
    carry = after(carry, total);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sum_ll += __shfl_down_sync(kFull, sum_ll, d);
    sum_ml += __shfl_down_sync(kFull, sum_ml, d);
  }
  __syncthreads();
  if ((tid & 31) == 0) ssum[0][tid >> 5] = sum_ll, ssum[1][tid >> 5] = sum_ml;
  __syncthreads();
  if (tid < 32) {
    sum_ll = ssum[0][tid];
    sum_ml = ssum[1][tid];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sum_ll += __shfl_down_sync(kFull, sum_ll, d);
      sum_ml += __shfl_down_sync(kFull, sum_ml, d);
    }
  }
  if (tid == 0) {
    const int v[3] = {carry.v0, carry.v1, carry.v2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sel_out[3 * b + j] = (carry.sel >> (2 * j)) & 3;
      val_out[3 * b + j] = v[j];
    }
    sums[2 * b] = sum_ll;
    sums[2 * b + 1] = sum_ml;
  }
}

__global__ void __launch_bounds__(kThreads)
rep_apply_kernel(const int* __restrict__ ovs, const int* __restrict__ lls,
                 const int64_t* __restrict__ seq_off, const int* __restrict__ entry,
                 int* __restrict__ offsets, bool* __restrict__ err_out) {
  __shared__ Map sw[2][kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int64_t beg = seq_off[b];
  const int n = int(seq_off[b + 1] - beg);
  const int e0 = entry[3 * b], e1 = entry[3 * b + 1], e2 = entry[3 * b + 2];
  Map carry = identity();
  int bad = 0;
  int ov = 0, ll = 0;
  if (tid < n) ov = ovs[beg + tid], ll = lls[beg + tid];
  for (int base = 0, tile = 0; base < n; base += kThreads, ++tile) {
    const bool live = base + tid < n;
    const Map m = live ? seq_map(ov, ll) : identity();
    const int64_t nx = beg + base + kThreads + tid;
    if (base + kThreads + tid < n) ov = ovs[nx], ll = lls[nx];
    Map total;
    const Map pre = after(carry, tile_scan(m, sw[tile & 1], &total));
    carry = after(carry, total);
    // r0 after this sequence: its prefix map applied to the entry state
    const int s0 = pre.sel & 3;
    const int off = s0 == 3 ? pre.v0 : add32(s0 == 0 ? e0 : s0 == 1 ? e1 : e2, pre.v0);
    if (live) {
      offsets[beg + base + tid] = off;
      bad |= off <= 0;
    }
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) err_out[b] = bad != 0;
}

}  // namespace

// ovs, lls, mls: flat i32 sequences, block b's at [seq_off[b], seq_off[b + 1]);
// sel, val (B, 3) i32; sums (B, 2) i64 (sum_ll, sum_ml).
extern "C" int zp_rep_totals(const void* ovs, const void* lls, const void* mls,
                             const void* seq_off, int B, void* sel, void* val, void* sums,
                             void* stream) {
  rep_totals_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ovs), static_cast<const int*>(lls), static_cast<const int*>(mls),
      static_cast<const int64_t*>(seq_off), static_cast<int*>(sel), static_cast<int*>(val),
      static_cast<int64_t*>(sums));
  return int(cudaGetLastError());
}

// entry (B, 3) i32: each block's rep state before its first sequence;
// offsets: flat i32 like ovs; err (B,) bool.
extern "C" int zp_rep_apply(const void* ovs, const void* lls, const void* seq_off,
                            const void* entry, int B, void* offsets, void* err, void* stream) {
  rep_apply_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ovs), static_cast<const int*>(lls),
      static_cast<const int64_t*>(seq_off), static_cast<const int*>(entry),
      static_cast<int*>(offsets), static_cast<bool*>(err));
  return int(cudaGetLastError());
}
