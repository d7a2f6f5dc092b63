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
// Blocks are independent.  So, as the plain version states it, the walk and
// the layout are two passes with one small read-back between them (the
// host picks S, L and n_out from the per-row totals and raises the errors
// in build_batch's order):
//
//   1. zp_lz4_parse_walk, one CTA of 128 a block.  All threads stage the
//      block's compressed bytes into shared memory with 16-byte loads;
//      thread 0 walks the tokens exactly as parse_block_sequences does (the
//      same checks, in the same order, int32 lengths, no read before its
//      check) and stores one 16-byte record a sequence (lit_len, offset,
//      match_len, the literal's position in the row) to a flat scratch,
//      each row's records strided by the bound (n - 1) / 3 + 1 (every
//      sequence but the last takes a token and a 2-byte offset).  It writes
//      the row's n_seq, literal total, out_len and an error code.
//   2. zp_lz4_parse_layout, one CTA of 256 a row of the padded batch.  Tiles
//      of 256 records, one a thread, read coalesced: an exclusive block scan
//      of (lit_len + match_len, lit_len) with a carry from tile to tile gives
//      seg_start and lit_start; the four tables are stored coalesced.  The
//      tile's literal runs are one contiguous stretch of the lit_bytes row,
//      copied a byte a thread from the row's compressed bytes (each thread
//      finds its run by a binary search over the tile's 256 run starts in
//      shared memory).  Then the row's padding lanes get zeros.
//
// A row longer than the stage (above PARSE_STAGE_CAP in lz4_torch.py) runs
// the same walk on its bytes in global memory.  Rows must be shorter than
// 2^23 bytes, so every length and out_len fits in int32 (out_len is at most
// 255 a compressed byte).  What bounds it: the longest block's chain, one
// dependent shared byte load a sequence and a few compares; the layout
// moves the tables' bytes once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalkThreads = 128;
constexpr int kLayoutThreads = 256;
constexpr int kWarps = kLayoutThreads / 32;
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

// Shared memory a row of n bytes needs when its first byte sits mis bytes
// into a 16-byte chunk.
__host__ __device__ constexpr long long stage_bytes(long long n, int mis) {
  return 16 * ((mis + n + 15) / 16);
}

struct SharedBytes {
  const uint8_t* p;  // row byte 0
  __device__ __forceinline__ int operator[](int j) const { return p[j]; }
};

struct GlobalBytes {
  const uint8_t* p;
  __device__ __forceinline__ int operator[](int j) const { return __ldg(p + j); }
};

// Thread 0's walk of one row of n bytes: the records and the row's totals.
template <class Bytes>
__device__ void walk_row(Bytes in, int n, int4* __restrict__ rec, int4* __restrict__ info) {
  int pos = 0, out_len = 0, lits = 0, k = 0, err = kOk;
  while (pos < n) {
    const int token = in[pos++];
    int ll = token >> 4;
    if (ll == 15) {
      int c;
      do {
        if (pos >= n) {
          err = kTruncLit;
          goto done;
        }
        c = in[pos++];
        ll += c;
      } while (c == 255);
    }
    if (ll > n - pos) {
      err = kLitOverrun;
      break;
    }
    const int lp = pos;
    pos += ll;
    out_len += ll;
    lits += ll;
    if (pos == n) {
      rec[k++] = make_int4(ll, 0, 0, lp);
      break;
    }
    if (n - pos < 2) {
      err = kTruncOffset;
      break;
    }
    const int off = in[pos] | in[pos + 1] << 8;
    pos += 2;
    if (off == 0) {
      err = kZeroOffset;
      break;
    }
    if (off > out_len) {
      err = kOffsetBeyond;
      break;
    }
    int ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      int c;
      do {
        if (pos >= n) {
          err = kTruncMatch;
          goto done;
        }
        c = in[pos++];
        ml += c;
      } while (c == 255);
    }
    out_len += ml;
    rec[k++] = make_int4(ll, off, ml, lp);
  }
done:
  *info = make_int4(k, lits, out_len, err);
}

__global__ void __launch_bounds__(kWalkThreads)
parse_walk_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ rows,
                  const int64_t* __restrict__ rec_off, int4* __restrict__ rec,
                  int4* __restrict__ info, int smem_bytes) {
  extern __shared__ uint4 stage[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int64_t start = rows[2 * b];
  const int n = int(rows[2 * b + 1]);
  const uint8_t* src = payload + start;
  const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
  const bool staged = stage_bytes(n, mis) <= smem_bytes;
  if (staged) {
    const int nch = (mis + n + 15) / 16;
    const uint4* g = reinterpret_cast<const uint4*>(src - mis);
    for (int c = tid; c < nch; c += kWalkThreads) {
      const int lo = 16 * c - mis;  // the chunk's first row byte
      if (lo >= 0 && lo + 16 <= n) {
        stage[c] = g[c];
      } else {  // the row's first or last chunk: its bytes only
        uint32_t u[4] = {0, 0, 0, 0};
        for (int j = max(-lo, 0); j < min(16, n - lo); ++j)
          u[j >> 2] |= uint32_t(src[lo + j]) << (8 * (j & 3));
        stage[c] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    __syncthreads();
  }
  if (tid != 0) return;
  int4* r = rec + rec_off[b];
  if (staged)
    walk_row(SharedBytes{reinterpret_cast<const uint8_t*>(stage) + mis}, n, r, info + b);
  else
    walk_row(GlobalBytes{src}, n, r, info + b);
}

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

__global__ void __launch_bounds__(kLayoutThreads)
parse_layout_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ rows,
                    const int64_t* __restrict__ rec_off, const int4* __restrict__ rec,
                    const int4* __restrict__ info, int B, int S, int L,
                    uint8_t* __restrict__ lit_bytes, int* __restrict__ seg_start,
                    int* __restrict__ lit_start, int* __restrict__ lit_len,
                    int* __restrict__ offset, int* __restrict__ n_seq,
                    int* __restrict__ out_len) {
  __shared__ int2 warp_tot[2 * kWarps];
  __shared__ int run_start[kLayoutThreads];  // a tile's lit_start, row coordinates
  __shared__ int run_delta[kLayoutThreads];  // its literal's row position minus that
  const int b = blockIdx.x, tid = threadIdx.x;
  const int4 inf = b < B ? info[b] : make_int4(0, 0, 0, 0);
  const int n = inf.x;
  const int64_t o = int64_t(b) * S;
  const uint8_t* src = b < B ? payload + rows[2 * b] : payload;
  const int4* r = b < B ? rec + rec_off[b] : rec;
  uint8_t* lb = lit_bytes + int64_t(b) * L;
  int carry_seg = 0, carry_lit = 0;
  for (int c0 = 0; c0 < n; c0 += kLayoutThreads) {
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
    const int cnt = min(n - c0, kLayoutThreads);
    for (int j = carry_lit + tid; j < carry_lit + tl; j += kLayoutThreads) {
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
  for (int s = n + tid; s < S; s += kLayoutThreads) {
    seg_start[o + s] = 0;
    lit_start[o + s] = 0;
    lit_len[o + s] = 0;
    offset[o + s] = 0;
  }
  // the literal row's tail: bytes up to a 16-byte boundary, then 16 at a time
  const int head = min((carry_lit + 15) & ~15, L);
  for (int j = carry_lit + tid; j < head; j += kLayoutThreads) lb[j] = 0;
  uint4* lb16 = reinterpret_cast<uint4*>(lb);
  for (int c = head / 16 + tid; c < L / 16; c += kLayoutThreads) lb16[c] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    n_seq[b] = n;
    out_len[b] = inf.z;
  }
}

}  // namespace

// payload: flat u8; rows (B, 2) i64 (byte_start, n_bytes), n_bytes < 2^23;
// rec_off (B,) i64, each row's first record; rec: scratch of 16 bytes a
// record, sum over rows of (n_bytes - 1) / 3 + 1; info (B, 4) i32 (n_seq,
// literal total, out_len, error code); stage: the bytes of the longest row
// to stage in shared memory (a longer row reads global memory).
// Returns cudaGetLastError().
extern "C" int zp_lz4_parse_walk(const void* payload, const void* rows, const void* rec_off,
                                 int B, int stage, void* rec, void* info, void* stream) {
  const int smem = int(stage_bytes(stage < 0 ? 0 : stage, 15));
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};  // the attribute as set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && smem > 48 * 1024 && smem > smem_set[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        parse_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return int(rc);
    smem_set[dev] = smem;
  }
  parse_walk_kernel<<<B, kWalkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(rec_off), static_cast<int4*>(rec), static_cast<int4*>(info),
      smem);
  return int(cudaGetLastError());
}

// The walk's CTAs that one SM holds at once with this stage size.
extern "C" int zp_lz4_parse_occupancy(int stage, void* blocks_per_sm) {
  const int smem = int(stage_bytes(stage < 0 ? 0 : stage, 15));
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(blocks_per_sm), parse_walk_kernel, kWalkThreads, smem));
}

// The same rows, records and info; Bp >= B rows of output (rows past B are
// padding); S and L the tables' widths (L a multiple of 16, the tensors
// 16-byte aligned); lit_bytes (Bp, L) u8; seg_start, lit_start, lit_len,
// offset (Bp, S) i32; n_seq, out_len (Bp,) i32.  Every element is written.
// Returns cudaGetLastError().
extern "C" int zp_lz4_parse_layout(const void* payload, const void* rows, const void* rec_off,
                                   const void* rec, const void* info, int B, int Bp, int S, int L,
                                   void* lit_bytes, void* seg_start, void* lit_start,
                                   void* lit_len, void* offset, void* n_seq, void* out_len,
                                   void* stream) {
  parse_layout_kernel<<<Bp, kLayoutThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(rec_off), static_cast<const int4*>(rec),
      static_cast<const int4*>(info), B, S, L, static_cast<uint8_t*>(lit_bytes),
      static_cast<int*>(seg_start), static_cast<int*>(lit_start), static_cast<int*>(lit_len),
      static_cast<int*>(offset), static_cast<int*>(n_seq), static_cast<int*>(out_len));
  return int(cudaGetLastError());
}
