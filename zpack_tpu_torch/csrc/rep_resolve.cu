// zstd repeat-offset resolution for Hopper (sm_90a): one thread per block,
// two entry points.
//
// Replaces zpack_tpu/kernels/fse_jax.py:rep_prefix_maps and apply_rep_maps,
// the repeat-offset stage of the zstd extract path.  The contracts are stated
// in plain PyTorch by zpack_tpu_torch/kernels/fse_torch.py:rep_totals_plain
// and rep_apply_plain.
//
// A sequence's raw offset value updates the three repeat offsets (r0, r1,
// r2) by one of seven maps out_j = in[sel_j] + val_j, or a constant; a
// family closed under composition.  The TPU design composes every prefix
// with an associative scan over (B, N, 3) maps, since a TPU has no cheap
// scalar loop, and the host stitches each block's entry state from the
// per-block totals.  Here the stitch stays on the host, and each pass is a
// walk, one thread per block:
//   rep_totals composes the block's maps into one (sel, val) triple and sums
//              its literal and match lengths (for the host's layout checks);
//   rep_apply  runs the repeat-offset state machine from the block's entry
//              state, writes each resolved offset and flags one <= 0.
// The (B, N, 3) prefix maps never exist.  Values add in 32-bit two's
// complement, as the int32 maps of the scan do.
//
// What bounds it: the longest block's walk, two loads a step from a
// stretch of the flat arrays that stays in the thread's L1 lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

// the map of one sequence with raw offset value ov and literal length ll
__device__ __forceinline__ void seq_map(int ov, int ll, int sel[3], int val[3]) {
  const bool litz = ll == 0, is_new = ov > 3;
  const bool c2 = (!litz && ov == 2) || (litz && ov == 1);  // (r1, r0, r2)
  const bool c3 = (!litz && ov == 3) || (litz && ov == 2);  // (r2, r0, r1)
  const bool cd = litz && ov == 3;                          // (r0 - 1, r0, r1)
  sel[0] = is_new ? 3 : c2 ? 1 : c3 ? 2 : 0;
  val[0] = is_new ? ov - 3 : cd ? -1 : 0;
  sel[1] = (is_new || c2 || c3 || cd) ? 0 : 1;
  sel[2] = (is_new || c3 || cd) ? 1 : 2;
  val[1] = val[2] = 0;
}

__device__ __forceinline__ int add32(int a, int b) { return int(uint32_t(a) + uint32_t(b)); }

__global__ void __launch_bounds__(kThreads)
rep_totals_kernel(const int* __restrict__ ovs, const int* __restrict__ lls,
                  const int* __restrict__ mls, const int64_t* __restrict__ seq_off, int B,
                  int* __restrict__ sel_out, int* __restrict__ val_out,
                  int64_t* __restrict__ sums) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int sel[3] = {0, 1, 2}, val[3] = {0, 0, 0};
  int64_t sum_ll = 0, sum_ml = 0;
  for (int64_t i = seq_off[b]; i < seq_off[b + 1]; ++i) {
    const int ll = lls[i];
    int ms[3], mv[3];
    seq_map(ovs[i], ll, ms, mv);
    int cs[3], cv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // this sequence's map after the prefix
      cs[j] = ms[j] == 3 ? 3 : sel[ms[j]];
      cv[j] = ms[j] == 3 ? mv[j] : add32(val[ms[j]], mv[j]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sel[j] = cs[j];
      val[j] = cv[j];
    }
    sum_ll += ll;
    sum_ml += mls[i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    sel_out[3 * b + j] = sel[j];
    val_out[3 * b + j] = val[j];
  }
  sums[2 * b] = sum_ll;
  sums[2 * b + 1] = sum_ml;
}

__global__ void __launch_bounds__(kThreads)
rep_apply_kernel(const int* __restrict__ ovs, const int* __restrict__ lls,
                 const int64_t* __restrict__ seq_off, const int* __restrict__ entry, int B,
                 int* __restrict__ offsets, bool* __restrict__ err_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int r[3] = {entry[3 * b], entry[3 * b + 1], entry[3 * b + 2]};
  bool err = false;
  for (int64_t i = seq_off[b]; i < seq_off[b + 1]; ++i) {
    int ms[3], mv[3];
    seq_map(ovs[i], lls[i], ms, mv);
    int nr[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) nr[j] = ms[j] == 3 ? mv[j] : add32(r[ms[j]], mv[j]);
#pragma unroll
    for (int j = 0; j < 3; ++j) r[j] = nr[j];
    offsets[i] = r[0];
    err |= r[0] <= 0;
  }
  err_out[b] = err;
}

}  // namespace

// ovs, lls, mls: flat i32 sequences, block b's at [seq_off[b], seq_off[b + 1]);
// sel, val (B, 3) i32; sums (B, 2) i64 (sum_ll, sum_ml).
extern "C" int zp_rep_totals(const void* ovs, const void* lls, const void* mls,
                             const void* seq_off, int B, void* sel, void* val, void* sums,
                             void* stream) {
  rep_totals_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ovs), static_cast<const int*>(lls), static_cast<const int*>(mls),
      static_cast<const int64_t*>(seq_off), B, static_cast<int*>(sel), static_cast<int*>(val),
      static_cast<int64_t*>(sums));
  return int(cudaGetLastError());
}

// entry (B, 3) i32: each block's rep state before its first sequence;
// offsets: flat i32 like ovs; err (B,) bool.
extern "C" int zp_rep_apply(const void* ovs, const void* lls, const void* seq_off,
                            const void* entry, int B, void* offsets, void* err, void* stream) {
  rep_apply_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ovs), static_cast<const int*>(lls),
      static_cast<const int64_t*>(seq_off), static_cast<const int*>(entry), B,
      static_cast<int*>(offsets), static_cast<bool*>(err));
  return int(cudaGetLastError());
}
