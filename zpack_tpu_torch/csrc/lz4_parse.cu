// LZ4 block parse for Hopper (sm_90a): the token walk of every block of a
// batch, then the replay's padded sequence tables; two entry points and an
// occupancy query.
//
// No TPU kernel does this: the JAX package parses on the host
// (zpack_tpu/kernels/lz4_jax.py:parse_block_sequences, called by
// DeviceLZ4Replayer.decompress_blocks).  The contract is
// zpack_tpu_torch/kernels/lz4_torch.py:build_batch, bit for bit: the tables
// lit_bytes (Bp, L) u8, seg_start / lit_start / lit_len / offset (Bp, S)
// i32, n_seq and out_len (Bp,), zeros in every padding lane and row.
//
// A block is a chain: where a token sits depends on every length before it.
// Blocks are independent.  So the parse is two kernels with one small
// read-back between them (the host picks S, L and n_out from the per-row
// totals and raises the errors in build_batch's order):
//
//   1. zp_lz4_parse_walk, one CTA of 256 for a group of 1 to 8 rows, packed
//      by the host by size (parse_plan in lz4_torch.py: the largest rows
//      beside the smallest), so that every row of a batch like the main
//      path's is resident at once: the stage is the group's bytes, not the
//      longest row's times the CTAs.  All threads stage the group's rows in
//      shared memory with 16-byte loads.  Then two steps:
//      a. The chain.  Lane 0 of warp w walks row w alone and carries only
//         the token's position.  A common token (a literal nibble under 15,
//         a match length of at most one extension byte, the next token
//         inside the row) is one shared byte load and three integer
//         operations: the next token's address is the token's plus 3,
//         plus (t + 1) >> 4, which counts the extension byte when the
//         match nibble is 15.  The loop's one branch waits on nothing the
//         step loads; a 255 in the extension byte is caught a step later
//         and that step undone.  The walker never loads an offset; it
//         checks only what bounds the chain (codes 1, 2, 3 and 6) and
//         stores each token's position off the chain.  It stops at the
//         row's end or its first chain error, so no byte past the row
//         decides anything (a read ahead past it is discarded), and every
//         sequence but the last takes 3 bytes: the count stays within
//         seq_bound(n) = (n - 1) / 3 + 1, the stride of the row's slots.
//      b. The values, read by the whole CTA, a row at a time, tiles of 256
//         sequences, one a thread: ll, the offset and ml from each token;
//         an exclusive block scan of ll + ml (with a carry from tile to
//         tile) for the output before each sequence; the offset checks
//         (code 4, zero; code 5, beyond the output so far); one 16-byte
//         record a sequence (lit_len, offset, match_len, literal position)
//         and the row's (n_seq, literal total, out_len, error code).  The
//         row's error is the host parse's first: the least sequence index,
//         and within one sequence codes 1, 2, 3, then 4, 5, then 6 (a code
//         6 sequence's offset is checked first).
//   2. zp_lz4_parse_layout, one CTA of 256 a row of the padded batch.  Tiles
//      of 256 records, one a thread, read coalesced: an exclusive block scan
//      of (lit_len + match_len, lit_len) with a carry from tile to tile gives
//      seg_start and lit_start; the four tables are stored coalesced.  The
//      tile's literal runs are one contiguous stretch of the lit_bytes row,
//      copied a byte a thread from the row's compressed bytes (each thread
//      finds its run by a binary search over the tile's 256 run starts in
//      shared memory).  Then the row's padding lanes get zeros.
//
// A row longer than PARSE_STAGE_CAP (lz4_torch.py) runs the same two steps
// on its bytes in global memory.  Rows must be shorter than 2^23 bytes, so
// every length and out_len fits in int32 (out_len is at most 255 a
// compressed byte).  What bounds it: the longest block's chain, one
// dependent shared byte load and three integer operations a sequence; the
// layout moves the tables' bytes once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = kWarps;  // rows a walk CTA: one walker warp each
constexpr unsigned kFull = 0xffffffffu;

// error codes, in lz4_torch.PARSE_ERRORS order (0 = none)
enum : int {
  kOk = 0,
  kTruncLit = 1,
  kLitOverrun = 2,
  kTruncOffset = 3,
  kZeroOffset = 4,
  kOffsetBeyond = 5,
  kTruncMatch = 6,
};

// One byte at a shared-memory address.  Volatile, so that the compiler
// keeps the walker's read ahead where it stands, before the step's branch,
// and does not sink it into the path that uses it.
__device__ __forceinline__ int lds_u8(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return int(v);
}

// A staged row: byte j at p[j].  The walker carries the token's address
// (Addr: a shared-memory address) and reads the next token ahead, up to 19
// bytes past the row, before it knows the step is common (a read ahead
// after a step to be undone reaches no further): the stage holds
// PARSE_AHEAD (32) bytes past the group's last row, and a read into the
// next row's place is discarded.
struct SharedBytes {
  using Addr = uint32_t;
  const uint8_t* p;
  int n;
  __device__ __forceinline__ int operator[](int j) const { return p[j]; }
  __device__ __forceinline__ Addr addr(int j) const {
    return uint32_t(__cvta_generic_to_shared(p)) + j;
  }
  __device__ __forceinline__ int ahead(Addr a) const { return lds_u8(a); }
};

// A row above the stage cap, read from global memory; the read ahead is
// clamped to the row.
struct GlobalBytes {
  using Addr = const uint8_t*;
  const uint8_t* p;
  int n;
  __device__ __forceinline__ int operator[](int j) const { return __ldg(p + j); }
  __device__ __forceinline__ Addr addr(int j) const { return p + j; }
  __device__ __forceinline__ int ahead(Addr a) const {
    return __ldg(a < p + n ? a : p + n - 1);
  }
};

// Step a: one thread walks the row's tokens.  Stores each whole sequence's
// token position in tpos and returns (whole sequences, chain error); on
// code 6 the failing token's position goes in tpos too, for step b to
// check its offset first.
template <class Bytes>
__device__ int2 walk_chain(Bytes in, int* __restrict__ tpos) {
  const int n = in.n;
  int pos = 0, k = 0, err = kOk;
  const typename Bytes::Addr base = in.addr(0), end = in.addr(n);
  while (pos < n) {
    int t = in[pos];
    typename Bytes::Addr at = base + pos;
    // The common token: a literal nibble under 15, a match length of at
    // most one extension byte, the next token in the row.  t + 1 carries
    // into the high nibble just when the match nibble is 15, so the next
    // token is read at once, behind the extension byte if there is one.
    // That byte is 255 (a longer match length) only rarely: it is checked
    // a step later, off the chain, and the step is then undone.
    typename Bytes::Addr before = at;
    int t0 = t, longer = 0;
    for (;;) {
      const typename Bytes::Addr next = at + 3 + ((t + 1) >> 4);
      const int tn = in.ahead(next), m = in.ahead(next - 1);
      if (longer | ((t & 0xf0) == 0xf0) | (next >= end)) break;
      longer = ((t & 15) == 15) & (m == 255);
      tpos[k++] = int(at - base);
      before = at;
      t0 = t;
      at = next;
      t = tn;
    }
    if (longer) {  // the token at `before` takes the slow path below
      --k;
      at = before;
      t = t0;
    }
    pos = int(at - base);
    // one sequence with every check of the chain
    int p = pos + 1, ll = t >> 4, c;
    if (ll == 15) {
      do {
        if (p >= n) {
          err = kTruncLit;
          goto done;
        }
        c = in[p++];
        ll += c;
      } while (c == 255);
    }
    if (ll > n - p) {
      err = kLitOverrun;
      break;
    }
    p += ll;
    if (p < n) {  // else the last sequence, literals only
      if (n - p < 2) {
        err = kTruncOffset;
        break;
      }
      p += 2;
      if ((t & 15) == 15) {
        do {
          if (p >= n) {
            tpos[k] = pos;
            err = kTruncMatch;
            goto done;
          }
          c = in[p++];
        } while (c == 255);
      }
    }
    tpos[k++] = pos;
    pos = p;
  }
done:
  return make_int2(k, err);
}

struct WalkShared {
  int2 warp_tot[2 * kWarps];
  int2 chain[kMaxGroup];  // (whole sequences, chain error) of each row of the group
  int4 res;               // the row's info at its first offset error
  int first;              // that error as index * 8 + code
};

// Exclusive scan of two ints over the CTA; the totals land in ta and tb.
__device__ __forceinline__ void block_scan2(int a, int b, int& ea, int& eb, int& ta, int& tb,
                                            int2* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int xa = __shfl_up_sync(kFull, ia, d), xb = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) warp_tot[warp] = make_int2(ia, ib);
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < kWarps ? warp_tot[lane] : make_int2(0, 0);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int xa = __shfl_up_sync(kFull, w.x, d), xb = __shfl_up_sync(kFull, w.y, d);
      if (lane >= d) {
        w.x += xa;
        w.y += xb;
      }
    }
    if (lane < kWarps) warp_tot[kWarps + lane] = w;  // inclusive warp prefixes
  }
  __syncthreads();
  const int2 before = warp ? warp_tot[kWarps + warp - 1] : make_int2(0, 0);
  ea = before.x + ia - a;
  eb = before.y + ib - b;
  const int2 all = warp_tot[2 * kWarps - 1];
  ta = all.x;
  tb = all.y;
}

// Step b: the whole CTA on one row whose chain gave K whole sequences and
// the chain error `code`.  tpos is written by this kernel: no read-only
// (non-coherent) loads of it.
template <class Bytes>
__device__ void read_values(Bytes in, int K, int code, const int* tpos, int4* __restrict__ rec,
                            int4* __restrict__ info, WalkShared& sh) {
  const int n = in.n, tid = threadIdx.x;
  const int m = K + (code == kTruncMatch);  // the sequences with an offset to check
  int carry_seg = 0, carry_lit = 0;
  for (int c0 = 0; c0 < m; c0 += kThreads) {
    const int s = c0 + tid;
    int ll = 0, off = 0, ml = 0, lp = 0;
    bool has_off = false;
    if (s < m) {
      const int p = tpos[s];
      const int t = in[p];
      int q = p + 1, c;
      ll = t >> 4;
      if (ll == 15) {
        do {
          c = in[q++];
          ll += c;
        } while (c == 255);
      }
      lp = q;
      q += ll;
      if (q < n) {
        has_off = true;
        off = in[q] | in[q + 1] << 8;
        q += 2;
        if (s < K) {
          ml = (t & 15) + 4;
          if ((t & 15) == 15) {
            do {
              c = in[q++];
              ml += c;
            } while (c == 255);
          }
        }
      }
    }
    if (tid == 0) sh.first = INT_MAX;
    const bool whole = s < K;
    int es, el, ts, tl;
    block_scan2(whole ? ll + ml : 0, whole ? ll : 0, es, el, ts, tl, sh.warp_tot);
    const int bad = !has_off        ? kOk
                    : off == 0      ? kZeroOffset
                    : off > carry_seg + es + ll ? kOffsetBeyond
                                                : kOk;
    if (bad) atomicMin(&sh.first, s * 8 + bad);
    if (whole) rec[s] = make_int4(ll, off, ml, lp);
    __syncthreads();
    const int first = sh.first;
    if (first != INT_MAX) {  // the same in every thread
      if (s == first >> 3) sh.res = make_int4(s, carry_lit + el, carry_seg + es, first & 7);
      __syncthreads();
      if (tid == 0) *info = sh.res;
      return;
    }
    carry_seg += ts;
    carry_lit += tl;
    __syncthreads();  // sh.first and warp_tot are rewritten by the next tile
  }
  if (tid == 0) *info = make_int4(K, carry_lit, carry_seg, code);
}

// slots (G, group, 2) i64: each CTA's rows (-1: none) and their stage
// offsets (-1: read from global memory).  steps: 1 the chain alone (it
// leaves (K, code) in chain), 2 the values alone (from chain and tpos), 3
// both.
__global__ void __launch_bounds__(kThreads)
parse_walk_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ rows,
                  const int64_t* __restrict__ rec_off, const int64_t* __restrict__ slots,
                  int group, int steps, int* __restrict__ tpos, int2* __restrict__ chain,
                  int4* __restrict__ rec, int4* __restrict__ info) {
  extern __shared__ uint4 stage[];
  __shared__ WalkShared sh;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t* my = slots + 2 * int64_t(blockIdx.x) * group;
  for (int w = 0; w < group; ++w) {
    const int64_t b = my[2 * w], at = my[2 * w + 1];
    if (b < 0 || at < 0) continue;
    const uint8_t* src = payload + rows[2 * b];
    const int n = int(rows[2 * b + 1]);
    const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
    const int nch = (mis + n + 15) / 16;
    const uint4* g = reinterpret_cast<const uint4*>(src - mis);
    uint4* dst = stage + at / 16;
#pragma unroll 4
    for (int c = tid; c < nch; c += kThreads) {
      const int lo = 16 * c - mis;  // the chunk's first row byte
      if (lo >= 0 && lo + 16 <= n) {
        dst[c] = g[c];
      } else {  // the row's first or last chunk: its bytes only
        uint32_t u[4] = {0, 0, 0, 0};
        for (int j = max(-lo, 0); j < min(16, n - lo); ++j)
          u[j >> 2] |= uint32_t(src[lo + j]) << (8 * (j & 3));
        dst[c] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  }
  __syncthreads();
  // (the row, its bytes) of slot w: staged, or in global memory
  auto row = [&](int w, auto&& fn) {
    const int64_t b = my[2 * w], at = my[2 * w + 1];
    const uint8_t* src = payload + rows[2 * b];
    const int n = int(rows[2 * b + 1]);
    if (at >= 0) {
      const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
      fn(b, SharedBytes{reinterpret_cast<const uint8_t*>(stage) + at + mis, n});
    } else {
      fn(b, GlobalBytes{src, n});
    }
  };
  if (steps & 1) {
    if (warp < group && (tid & 31) == 0 && my[2 * warp] >= 0) {
      row(warp, [&](int64_t b, auto in) {
        const int2 kc = walk_chain(in, tpos + rec_off[b]);
        sh.chain[warp] = kc;
        chain[b] = kc;
      });
    }
  } else if (tid < group && my[2 * tid] >= 0) {
    sh.chain[tid] = chain[my[2 * tid]];
  }
  __syncthreads();  // the walkers' positions, in global memory, are visible after it
  if (!(steps & 2)) return;
  for (int w = 0; w < group; ++w) {
    if (my[2 * w] < 0) continue;
    row(w, [&](int64_t b, auto in) {
      read_values(in, sh.chain[w].x, sh.chain[w].y, tpos + rec_off[b], rec + rec_off[b],
                  info + b, sh);
    });
    __syncthreads();  // sh is rewritten by the next row
  }
}

__global__ void __launch_bounds__(kThreads)
parse_layout_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ rows,
                    const int64_t* __restrict__ rec_off, const int4* __restrict__ rec,
                    const int4* __restrict__ info, int B, int S, int L,
                    uint8_t* __restrict__ lit_bytes, int* __restrict__ seg_start,
                    int* __restrict__ lit_start, int* __restrict__ lit_len,
                    int* __restrict__ offset, int* __restrict__ n_seq,
                    int* __restrict__ out_len) {
  __shared__ int2 warp_tot[2 * kWarps];
  __shared__ int run_start[kThreads];  // a tile's lit_start, row coordinates
  __shared__ int run_delta[kThreads];  // its literal's row position minus that
  const int b = blockIdx.x, tid = threadIdx.x;
  const int4 inf = b < B ? info[b] : make_int4(0, 0, 0, 0);
  const int n = inf.x;
  const int64_t o = int64_t(b) * S;
  const uint8_t* src = b < B ? payload + rows[2 * b] : payload;
  const int4* r = b < B ? rec + rec_off[b] : rec;
  uint8_t* lb = lit_bytes + int64_t(b) * L;
  int carry_seg = 0, carry_lit = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int s = c0 + tid;
    const int4 q = s < n ? r[s] : make_int4(0, 0, 0, 0);
    int es, el, ts, tl;
    block_scan2(q.x + q.z, q.x, es, el, ts, tl, warp_tot);
    const int ls = carry_lit + el;
    if (s < n) {
      seg_start[o + s] = carry_seg + es;
      lit_start[o + s] = ls;
      lit_len[o + s] = q.x;
      offset[o + s] = q.y;
    }
    run_start[tid] = s < n ? ls : 0x7fffffff;
    run_delta[tid] = q.w - ls;
    __syncthreads();
    const int cnt = min(n - c0, kThreads);
    for (int j = carry_lit + tid; j < carry_lit + tl; j += kThreads) {
      int lo = 0, hi = cnt - 1;  // the last run starting at or before j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (run_start[mid] <= j)
          lo = mid;
        else
          hi = mid - 1;
      }
      lb[j] = src[j + run_delta[lo]];
    }
    carry_seg += ts;
    carry_lit += tl;
    __syncthreads();  // run_start and warp_tot are rewritten by the next tile
  }
  for (int s = n + tid; s < S; s += kThreads) {
    seg_start[o + s] = 0;
    lit_start[o + s] = 0;
    lit_len[o + s] = 0;
    offset[o + s] = 0;
  }
  // the literal row's tail: bytes up to a 16-byte boundary, then 16 at a time
  const int head = min((carry_lit + 15) & ~15, L);
  for (int j = carry_lit + tid; j < head; j += kThreads) lb[j] = 0;
  uint4* lb16 = reinterpret_cast<uint4*>(lb);
  for (int c = head / 16 + tid; c < L / 16; c += kThreads) lb16[c] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    n_seq[b] = n;
    out_len[b] = inf.z;
  }
}

// Lets the walk launch with smem bytes of dynamic shared memory on the
// current device (the attribute as set, per device).
cudaError_t allow_walk_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem <= 48 * 1024 || (dev < kMaxDevices && smem <= smem_set[dev])) return cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(parse_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess && dev < kMaxDevices) smem_set[dev] = smem;
  return rc;
}

}  // namespace

// payload: flat u8; rows (B, 2) i64 (byte_start, n_bytes), n_bytes < 2^23;
// rec_off (B,) i64, each row's first slot; slots (G, group, 2) i64, group
// <= 8: each CTA's rows and their offsets in its smem bytes of stage (16
// aligned, a row of n bytes taking 16 * ((n + 30) / 16), PARSE_AHEAD bytes
// past the last); tpos: scratch of one i32 a slot; rec: 16 bytes a slot,
// the slots a row (n_bytes - 1) / 3 + 1; chain (B, 2) i32 (whole sequences,
// chain error); info (B, 4) i32 (n_seq, literal total, out_len, error
// code).  steps as parse_walk_kernel.  Returns cudaGetLastError().
extern "C" int zp_lz4_parse_walk(const void* payload, const void* rows, const void* rec_off,
                                 const void* slots, int G, int group, int smem, int steps,
                                 void* tpos, void* chain, void* rec, void* info, void* stream) {
  if (group < 1 || group > kMaxGroup) return int(cudaErrorInvalidValue);
  const cudaError_t rc = allow_walk_smem(smem);
  if (rc != cudaSuccess) return int(rc);
  parse_walk_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(rec_off), static_cast<const int64_t*>(slots), group, steps,
      static_cast<int*>(tpos), static_cast<int2*>(chain), static_cast<int4*>(rec),
      static_cast<int4*>(info));
  return int(cudaGetLastError());
}

// The walk's CTAs that one SM holds at once with smem bytes of stage.
extern "C" int zp_lz4_parse_occupancy(int smem, void* blocks_per_sm) {
  const cudaError_t rc = allow_walk_smem(smem);
  if (rc != cudaSuccess) return int(rc);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks_per_sm), parse_walk_kernel, kThreads, smem));
}

// The same rows and rec_off, the walk's records and info; Bp >= B rows of
// output (rows past B are padding); S and L the tables' widths (L a
// multiple of 16, the tensors 16-byte aligned); lit_bytes (Bp, L) u8;
// seg_start, lit_start, lit_len, offset (Bp, S) i32; n_seq, out_len (Bp,)
// i32.  Every element is written.  Returns cudaGetLastError().
extern "C" int zp_lz4_parse_layout(const void* payload, const void* rows, const void* rec_off,
                                   const void* rec, const void* info, int B, int Bp, int S, int L,
                                   void* lit_bytes, void* seg_start, void* lit_start,
                                   void* lit_len, void* offset, void* n_seq, void* out_len,
                                   void* stream) {
  parse_layout_kernel<<<Bp, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(rec_off), static_cast<const int4*>(rec),
      static_cast<const int4*>(info), B, S, L, static_cast<uint8_t*>(lit_bytes),
      static_cast<int*>(seg_start), static_cast<int*>(lit_start), static_cast<int*>(lit_len),
      static_cast<int*>(offset), static_cast<int*>(n_seq), static_cast<int*>(out_len));
  return int(cudaGetLastError());
}
