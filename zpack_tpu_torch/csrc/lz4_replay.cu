// LZ4 / zstd sequence replay for Hopper (sm_90a): pointer doubling over
// one int32 a byte, in place, with no wait anywhere.
//
// Replaces zpack_tpu/kernels/lz4_jax.py:_replay_build, _replay_rounds and
// _replay_emit (driven by replay_sequences): the extract stage of the LZ4
// main path (one row per 64 KiB block) and of the zstd path (one row per
// frame, megabytes long).  The contract is the bytes, stated in plain
// PyTorch by zpack_tpu_torch/kernels/lz4_torch.py:replay_plain.
//
// What bounds a replay is the depth of its copy chains.  In a row of
// 32-byte records every record's run of zeros is a match that reads the
// same run of the record before: one chain of 131,000 links in a 4 MiB
// row.  Any design that copies bytes from where they were written pays one
// memory round trip a link (measured on an H100 on 16 such rows: a barrier
// per match with one CTA a row, 167 ms; chunks of 32 sequences ordered by
// flags and acquire loads, 555 ms, some 4 us a link; this file, 2.3 ms).
// So the bytes are not copied along the chain:
// the chain is collapsed first, as the TPU design does, but with the card's
// gather and in place:
//
//   build  the work is cut by output position, not by sequence (a literal
//          run of 128 KiB and a match of 3 bytes are both one sequence): a
//          thread takes four consecutive positions of a tile of 1,024,
//          finds the sequence of the first by a binary search over the
//          row's sequence starts and steps on from there.  f[p] becomes
//          ~byte (negative) for a literal, or the position it copies from
//          for a match byte, folded onto the match's first period so that
//          it lies before the match.  An offset <= 0 or beyond the row's
//          start (the host checks both before the launch) gives ~0, a zero
//          byte.
//   round  f[p] = f[f[p]] wherever f[p] >= 0, four positions a thread, in
//          place: whatever value of f[q] a thread meets, old or new, names
//          an earlier link of p's chain or its byte, so no order between
//          threads is needed and every launch at least doubles each hop.
//          A tile of 1,024 positions that is resolved is flagged and never
//          read again; a chain has at most one link a sequence, so
//          ceil(log2(S + 1)) + 1 launches resolve everything, and a launch
//          that follows one which left no tile open returns at once.
//   emit   out[p] = ~f[p], zero past the row's decoded size.  A position
//          still unresolved there sets the error word (it cannot be; the
//          wrapper raises if it is).
//
// What bounds it now: bytes.  f is written once, its live part is read,
// gathered and written once a round, and read once more by emit: about
// 100 bytes of traffic an output byte for the deepest rows, 10 for rows
// without chains.  The scratch (4 bytes an output byte, the tile flags)
// comes from the wrapper; nothing here allocates or waits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads a CTA
constexpr int kTile = 4 * kThreads;  // positions a tile, four a thread
// ints of the state the wrapper zeroes: the error word and a flag a round
// (at most 32 rounds, since S < 2^31)
constexpr int kState = 40;
static_assert(kState >= 1 + 32 + 1, "the error word, a flag a round, one past the last");

// f for every position of every tile: a binary search over the row's
// sequence starts finds the thread's first position, the three after it
// step on from there.
__global__ void __launch_bounds__(kThreads)
build_kernel(const uint8_t* __restrict__ lit_bytes, int L, const int* __restrict__ seg_start,
             const int* __restrict__ lit_start, const int* __restrict__ lit_len,
             const int* __restrict__ offset, const int* __restrict__ n_seq,
             const int* __restrict__ out_len, int S, int* __restrict__ f, int fstride,
             int tiles_per_row, int n_tiles) {
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row = t / tiles_per_row;
    const int p0 = (t - row * tiles_per_row) * kTile + 4 * threadIdx.x;
    const int ns = min(n_seq[row], S);
    const int total = min(out_len[row], fstride);
    if (p0 >= total || ns <= 0) continue;
    const size_t tab = size_t(row) * S;
    const int* ss = seg_start + tab;
    const uint8_t* lits = lit_bytes + size_t(row) * L;
    int j = 0;  // the last sequence that starts at or before p0
    for (int hi = ns; hi - j > 1;) {
      const int mid = (j + hi) >> 1;
      if (ss[mid] <= p0) j = mid; else hi = mid;
    }
    int v[4] = {~0, ~0, ~0, ~0};
    int nxt = j + 1 < ns ? ss[j + 1] : INT_MAX;
    int st = ss[j], n = lit_len[tab + j], l0 = lit_start[tab + j], o = offset[tab + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i;
      if (p < total) {
        if (p >= nxt) {
          do {
            ++j;
            nxt = j + 1 < ns ? ss[j + 1] : INT_MAX;
          } while (p >= nxt);
          st = ss[j], n = lit_len[tab + j], l0 = lit_start[tab + j], o = offset[tab + j];
        }
        const int k = p - st - n;  // < 0 in the literals, else the match byte's index
        if (k < 0)
          v[i] = ~int(lits[l0 + p - st]);
        else if (o > 0 && o <= st + n)
          v[i] = st + n - o + (k < o ? k : k % o);
      }
    }
    *reinterpret_cast<int4*>(f + size_t(row) * fstride + p0) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

// One doubling step over every live tile.  live[t] != 0: tile t may hold an
// unresolved position.  *go == 0 (set by the round before through its
// `more`): no tile is live, nothing to do.
__global__ void __launch_bounds__(kThreads)
round_kernel(int* f, int fstride, const int* __restrict__ out_len, int tiles_per_row,
             int n_tiles, int* live, const int* go, int* more) {
  if (go && !*go) return;
  int any = 0;  // one store of `more` a CTA: a store a tile would queue up in L2
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if (!live[t]) continue;  // the same for the whole CTA
    const int row = t / tiles_per_row;
    const int p0 = (t - row * tiles_per_row) * kTile + 4 * threadIdx.x;
    const int total = min(out_len[row], fstride);
    int* frow = f + size_t(row) * fstride;
    int open = 0;
    if (p0 < total) {
      const int4 v = *reinterpret_cast<const int4*>(frow + p0);
      int q[4] = {v.x, v.y, v.z, v.w};
      bool moved = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q[i] >= 0 && p0 + i < total) {
          // a source lies before its position; anything else is no source
          q[i] = q[i] < p0 + i ? __ldcg(frow + q[i]) : ~0;
          moved = true;
          open |= q[i] >= 0;
        }
      }
      if (moved) *reinterpret_cast<int4*>(frow + p0) = make_int4(q[0], q[1], q[2], q[3]);
    }
    open = __syncthreads_or(open);
    if (threadIdx.x == 0) live[t] = open;
    any |= open;
  }
  if (threadIdx.x == 0 && any) *more = 1;
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const int* __restrict__ f, int fstride, const int* __restrict__ out_len,
            int tiles_per_row, int n_tiles, int n_out, uint8_t* __restrict__ out,
            int* __restrict__ err) {
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row = t / tiles_per_row;
    const int p0 = (t - row * tiles_per_row) * kTile + 4 * threadIdx.x;
    if (p0 >= n_out) continue;
    const int total = min(out_len[row], n_out);
    const int* frow = f + size_t(row) * fstride;
    uint8_t* dst = out + size_t(row) * n_out;
    int q[4] = {~0, ~0, ~0, ~0};
    if (p0 < total) {
      const int4 v = *reinterpret_cast<const int4*>(frow + p0);
      q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + i < n_out) {
        const bool in = p0 + i < total;
        if (in && q[i] >= 0) atomicExch(err, 1);
        dst[p0 + i] = in ? uint8_t(~q[i]) : uint8_t(0);
      }
    }
  }
}

}  // namespace

// lit_bytes (bp, L) u8; seg_start, lit_start, lit_len, offset (bp, S) i32;
// n_seq, out_len (bp,) i32; out (bp, n_out) u8.  Scratch: f (bp, fstride)
// i32 with fstride = n_out rounded up to 4; live (bp * ceil(fstride / 1024),)
// i32, all ones; state (kState,) i32, zero: [0] the error word, [1 + r] "a
// tile was left open by round r".  Returns the first CUDA error.
extern "C" int zp_lz4_replay(const void* lit_bytes, int L, const void* seg_start,
                             const void* lit_start, const void* lit_len, const void* offset,
                             const void* n_seq, const void* out_len, int bp, int S, int n_out,
                             void* out, void* f, int fstride, void* live, void* state,
                             void* stream) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return int(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_per_row = (fstride + kTile - 1) / kTile;
  const long long n_tiles = (long long)bp * tiles_per_row;
  if (n_tiles > INT_MAX || n_tiles < 1) return int(cudaErrorInvalidValue);
  const int full = sms * 8;  // CTAs of 256 threads that fill the card
  const int tile_grid = int(n_tiles < full ? n_tiles : full);

  build_kernel<<<tile_grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(lit_bytes), L, static_cast<const int*>(seg_start),
      static_cast<const int*>(lit_start), static_cast<const int*>(lit_len),
      static_cast<const int*>(offset), static_cast<const int*>(n_seq),
      static_cast<const int*>(out_len), S, static_cast<int*>(f), fstride, tiles_per_row,
      int(n_tiles));
  // a chain has at most one link a sequence: 2^rounds > S launches resolve
  // it, and one more is the margin
  int rounds = 1;
  while ((1LL << rounds) <= S) ++rounds;  // S < 2^31: at most 31
  int* more = static_cast<int*>(state) + 1;
  for (int r = 0; r <= rounds; ++r)
    round_kernel<<<tile_grid, kThreads, 0, st>>>(
        static_cast<int*>(f), fstride, static_cast<const int*>(out_len), tiles_per_row,
        int(n_tiles), static_cast<int*>(live), r ? more + r - 1 : nullptr, more + r);
  emit_kernel<<<tile_grid, kThreads, 0, st>>>(
      static_cast<const int*>(f), fstride, static_cast<const int*>(out_len), tiles_per_row,
      int(n_tiles), n_out, static_cast<uint8_t*>(out), static_cast<int*>(state));
  return int(cudaGetLastError());
}

// Message for a code returned by any entry point above.
extern "C" const char* zp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
