// LZ4 block serializer for Hopper (sm_90a): the lz4f block sections of a
// shard from the match finder's wire arrays, where both already are; one
// entry point that launches two kernels.
//
// No TPU kernel does this: the JAX package serializes on the host
// (zpack_tpu/native.py, zn_lz4_serialize_blocks_pair).  The contract is
// zpack_tpu_torch/kernels/lz4_torch.py:serialize_plain, bit for bit, in
// the "pair" (src u16, code u8) and "u16" (src << 3 | code) wire formats
// and in two parses.  For each block of true length cl, from p = 1 below
// cl - 12: a candidate (j, m) is rejected where m < 4, j < 0, j >= p or
// p - j > 65535, or where its forward length F, m clipped to cl - 5 and
// extended while bytes agree, is under 4.  The greedy parse (LZ4's fast
// levels; the bytes of native/zpack_native.cpp:zn_lz4_serialize_blocks_core)
// takes every accepted match; the HC parse (its high-compression levels;
// native/lz4_hc.cpp) emits an accepted q with F(q) < kLazyCap as a literal
// where F(q + 1) > F(q) or F(q + 2) > F(q) + 1, and takes the others.  A
// match taken at q ends at q + F(q) and extends backward down to the
// previous sequence's end; a block whose compressed bytes would be cl or
// more is stored raw (size header with the high bit set).
//
// What the design rests on: write q for the next accepted position at or
// after p and F(q) for its forward length; the chain is p -> q + F(q).
// Backward extension moves bytes between a sequence's literals and its
// match but never moves the next p, so the chain depends on forward
// quantities only, and everything after it is data-parallel.  The HC
// parse's step at q reads F at q, q + 1 and q + 2 only, so the same holds:
// a literal step is one more kind of step, from q to q + 1.
//
//   1. zp_lz4_serialize's walk kernel, one CTA a block (1,024 threads for
//      blocks over 16 KiB, one CTA an SM; 256 below).  The block's bytes are
//      staged in shared memory.
//      a. The scan, every thread, a position a thread: the candidate's
//         checks and its forward length from the staged bytes, at most
//         kScanExtend compares past m, into one byte a position: 0 for a
//         rejected position, the length where it settled under 255, 255
//         where it did not (a long run; the walk settles those).  So a
//         run of zeros costs O(B * kScanExtend), not O(B^2).
//      b. The chain, warp 0.  One walker a block is a chain of dependent
//         steps (some 8,000 in a block of text), so the walk is
//         speculative: lane i walks segment i of 32 alone, from the
//         segment's first position, a step the byte at p (rejected bytes
//         skipped a word at a time; in the HC parse a literal step where
//         the scanned bytes at p + 1 and p + 2 call for one), a 255
//         settled by the lane no further
//         than the segment's end (an "open" last match).  Then the join,
//         the warp in step: the true chain from p = 1, segment by segment,
//         each step a lane's 4 of the next 128 bytes and a ballot; where it
//         lands on a position the segment's walk landed on, the walk is the
//         chain from there (two chains that meet go on together), and only
//         its open last match is settled, 32 compares a step.  Greedy
//         chains meet within a few steps, so the join is some 32 short
//         walks.  The steps go to a global scratch (each lane's, the
//         join's, then the chain in order, copied by a warp a segment), as
//         q | F(q) << 16.
//      c. The values, the whole CTA, tiles of its size, a sequence a
//         thread: backward extension down to the previous end, the
//         sequence's bytes, a block scan with a carry from tile to tile,
//         the host serializer's bound on its buffer (its conservative need
//         before each emission: a block over it fails the call, as the
//         host's does), the token and length bytes and the offset by the
//         thread, the literal runs a warp a run.  Then the last literals,
//         and the choice: raw blocks copy their bytes over the emission.
//         Each block's section goes to a slot at a fixed stride, its size
//         (or -1, overflowed) to sizes.
//   2. The placement kernel, one CTA a block: the sizes before it summed,
//      its section copied into place after the 16-byte header; the last
//      CTA writes the header (the sections' total, the blocks overflowed).
//
// The caller reads the output back once; nothing here waits on the host.
//
// The choice of the walk, and its bound.  One warp walking each block's
// chain in step (a step one shared load and an add, rejected positions
// skipped 128 at a time) took 2.4 to 2.5 ms a step of 256 blocks of 64 KiB
// of text or records on an H100 (700 W): some 7,000 steps a block at
// 250 cycles or more, each step's store behind its loads; one CTA an SM, so
// two waves.  The 32 segments and the join take 0.42 to 0.52 ms on the same
// blocks.  What bounds it now: the scan's compares (up to kScanExtend past
// m at each candidate) and the longest lane's walk; a block of one long
// run (zeros) is bounded by its extension, 32 bytes a warp step in the
// join.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLits = 5;
constexpr int kMaxOffset = 65535;
// a scanned position's byte: 0 rejected, 4..kMaxSettled its forward
// length, kUnsettled a length the scan did not settle
constexpr int kUnsettled = 255;
constexpr int kMaxSettled = 254;
// byte compares the scan spends past a candidate's m
constexpr int kScanExtend = 32;
// the HC parse weighs a literal step only at a match shorter than this: a
// scanned byte settles every length under it, and one left unsettled
// (kUnsettled) stands for a length above it (the scan's e >= kMinMatch)
constexpr int kLazyCap = kMinMatch + kScanExtend;
// the join reads up to 128 scanned bytes past a position: their pad
constexpr int kScanPad = 128;
constexpr int kHeader = 16;
// the chain's speculative walkers: a lane a segment of at least
// kMinSegment positions
constexpr int kLanes = 32;
constexpr int kMinSegment = 64;
constexpr int kSmallBlock = 16384;
constexpr int kSmallThreads = 256;
constexpr int kLargeThreads = 1024;
constexpr int kPlaceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum : int { kPair = 0, kU16 = 1 };
enum : int { kGreedy = 0, kHc = 1 };

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// the steps one segment's walk (or join) can record: a step advances 4 or more
__host__ __device__ constexpr int seg_cap(int B) {
  return ((B + kLanes - 1) / kLanes > kMinSegment ? (B + kLanes - 1) / kLanes : kMinSegment) / 4 +
         2;
}

// the chain scratch of a block, in words: the chain in order, then the
// lanes' walks and the join's steps
__host__ __device__ constexpr long long chain_words(int B) {
  return B / 4 + 2 + 2LL * kLanes * seg_cap(B);
}

// bytes that extend a length nibble for a length v
__device__ __forceinline__ int lsic_len(int v) { return v >= 15 ? (v - 15) / 255 + 1 : 0; }

__device__ __forceinline__ uint8_t* write_lsic(uint8_t* op, int v) {
  v -= 15;
  while (v >= 255) {
    *op++ = 255;
    v -= 255;
  }
  *op++ = static_cast<uint8_t>(v);
  return op;
}

// one position's candidate: j the source (-1 none), m the capped length
template <int MODE>
__device__ __forceinline__ void fetch(const void* t0, const void* t1, size_t idx, int& j,
                                      int& m) {
  int code;
  if (MODE == kPair) {
    code = static_cast<const uint8_t*>(t1)[idx];
    j = code ? static_cast<const uint16_t*>(t0)[idx] : -1;
  } else {
    const int t = static_cast<const uint16_t*>(t0)[idx];
    code = t & 7;
    j = code ? t >> 3 : -1;
  }
  m = code ? code + 3 : 0;
}

// Exclusive block scan of v over NT threads; *total the sum.  Every thread
// calls it; sums holds NT / 32 ints.
template <int NT>
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sums[warp - 1] : 0;
  *total = sums[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// the warp's first position at or after p whose scanned byte is not 0
// (mflim or past it where there is none): the byte at p, then 128 at a
// time, each lane loading 4
__device__ __forceinline__ int next_accepted(const uint8_t* scan, int p, int mflim, int lane) {
  while (p < mflim) {
    if (scan[p]) return p;
    const int at = p & ~3;
    uint32_t w = *reinterpret_cast<const uint32_t*>(scan + at + 4 * lane);
    w &= lane ? kFull : kFull << (8 * (p - at));
    const uint32_t hit = __ballot_sync(kFull, w != 0);
    if (hit) {
      const int l = __ffs(hit) - 1;
      return at + 4 * l + ((__ffs(__shfl_sync(kFull, w, l)) - 1) >> 3);
    }
    p = at + 128;
  }
  return mflim;
}

// the HC parse's literal step at an accepted q of scanned byte f: a match
// under kLazyCap gives way where the match at q + 1 is longer, or the one
// at q + 2 longer by two (255, unsettled, is longer than any such f)
__device__ __forceinline__ bool lazy_step(const uint8_t* scan, int q, int f) {
  return f < kLazyCap && (scan[q + 1] > f || scan[q + 2] > f + 1);
}

// f grown while q + f < limit and the bytes at q + f and j + f agree, by
// the warp, 32 compares a step
__device__ __forceinline__ int extend_warp(const uint8_t* s, int q, int j, int f, int limit,
                                           int lane) {
  for (;;) {
    const int x = q + f + lane;
    const bool agree = x < limit && s[x] == s[j + f + lane];
    const uint32_t stop = __ballot_sync(kFull, !agree);
    if (stop) return f + __ffs(stop) - 1;
    f += 32;
  }
}

template <int MODE, int NT, int PARSE>
__global__ void __launch_bounds__(NT)
    serialize_kernel(const uint8_t* __restrict__ blocks, int B, long long n, const void* t0,
                     const void* t1, uint32_t* chain, int chain_stride, uint8_t* slots,
                     int slot_stride, int* sizes) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kWarps = NT / 32;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long first = static_cast<long long>(b) * B;
  const int cl = n - first >= B ? B : (n > first ? static_cast<int>(n - first) : 0);
  if (cl == 0) {
    if (tid == 0) sizes[b] = 0;
    return;
  }
  uint8_t* s = smem;                  // the block's bytes
  uint8_t* scan = s + round16(B);     // a byte a position, then the pad
  int* run_src = reinterpret_cast<int*>(scan + round16(B) + kScanPad);
  int* run_dst = run_src + NT;        // a tile's literal runs
  int* run_len = run_dst + NT;
  int* sums = run_len + NT;           // the block scan's warp sums
  __shared__ int s_nseq, s_over;

  // stage the block's bytes
  const uint8_t* row = blocks + first;
  if ((B & 15) == 0 && (reinterpret_cast<uintptr_t>(blocks) & 15) == 0) {
    const uint4* row16 = reinterpret_cast<const uint4*>(row);
    uint4* s16 = reinterpret_cast<uint4*>(s);
    for (int i = tid; i < (cl + 15) / 16; i += NT) s16[i] = row16[i];
  } else {
    for (int i = tid; i < cl; i += NT) s[i] = row[i];
  }
  if (tid == 0) s_over = 0;
  __syncthreads();

  const int limit = cl > kLastLits ? cl - kLastLits : 0;
  const int mflim = cl > kMfLimit ? cl - kMfLimit : 0;
  const size_t base = static_cast<size_t>(b) * B;

  // a. the scan
  for (int p = tid; p < round16(B) + kScanPad; p += NT) {
    int f = 0;
    if (p >= 1 && p < mflim) {
      int j, m;
      fetch<MODE>(t0, t1, base + p, j, m);
      if (m >= kMinMatch && j >= 0 && j < p && p - j <= kMaxOffset) {
        int e = min(m, limit - p);
        if (e > kMaxSettled) {
          f = kUnsettled;
        } else {
          const int top = min(e + kScanExtend, kMaxSettled);
          while (e < top && p + e < limit && s[p + e] == s[j + e]) ++e;
          if (e == top && p + e < limit && s[p + e] == s[j + e]) f = kUnsettled;
          else f = e >= kMinMatch ? e : 0;
        }
      }
    }
    scan[p] = static_cast<uint8_t>(f);
  }
  __syncthreads();

  // b. the chain
  const int cap = seg_cap(B);
  uint32_t* rec = chain + static_cast<size_t>(b) * chain_stride;  // the chain in order
  uint32_t* walked = rec + B / 4 + 2;                             // each lane's, alone
  uint32_t* joined = walked + kLanes * cap;                       // the join's own
  __shared__ int s_walked[kLanes], s_open[kLanes], s_from[kLanes], s_joined[kLanes],
      s_at[kLanes];
  const int seg = max(kMinSegment, (mflim + kLanes - 1) / kLanes);
  if (warp == 0) {
    // b1. lane i walks segment i from its first position, alone
    {
      const int lo = max(lane * seg, 1), hi = min((lane + 1) * seg, mflim);
      uint32_t* mine = walked + lane * cap;
      int p = lo, k = 0;
      bool open = false;
      while (p < hi) {
        int f = scan[p];
        if (f == 0) {  // the rest of p's word
          const uint32_t w = *reinterpret_cast<const uint32_t*>(scan + (p & ~3)) >> (8 * (p & 3));
          p = w ? p + ((__ffs(w) - 1) >> 3) : (p & ~3) + 4;
          continue;
        }
        if (PARSE == kHc && lazy_step(scan, p, f)) {
          ++p;
          continue;
        }
        if (f == kUnsettled) {  // extended no further than the segment's end
          int j, m;
          fetch<MODE>(t0, t1, base + p, j, m);
          f = min(m, limit - p);
          const int stop = min(limit, hi);
          while (p + f < stop && s[p + f] == s[j + f]) ++f;
          open = p + f < limit && s[p + f] == s[j + f];
        }
        mine[k++] = static_cast<uint32_t>(p) | static_cast<uint32_t>(f) << 16;
        if (open) break;
        p += f;
      }
      s_walked[lane] = k;
      s_open[lane] = open;
    }
    __syncwarp();
    // b2. the join: the true chain from p = 1, segment by segment, until it
    //     lands where the segment's walk landed; from there on the walk is
    //     the chain (its open last match settled)
    int p = 1, total = 0;
    for (int i = 0; i < kLanes; ++i) {
      const int hi = min((i + 1) * seg, mflim), wc = s_walked[i];
      const uint32_t* theirs = walked + i * cap;
      int from = wc, own = 0, c = 0;
      while (i * seg < mflim && p < hi) {
        const int q = next_accepted(scan, p, mflim, lane);
        if (q >= hi) {  // nothing accepted before q: the chain goes on from there
          p = q;
          break;
        }
        if (PARSE == kHc && lazy_step(scan, q, scan[q])) {  // never a walk's record
          p = q + 1;
          continue;
        }
        bool found = false;
        while (c < wc) {
          const int at = (c + lane < wc) ? static_cast<int>(theirs[c + lane] & 0xffff) : 0x10000;
          const uint32_t ge = __ballot_sync(kFull, at >= q);
          if (ge) {
            c += __ffs(ge) - 1;
            found = __shfl_sync(kFull, at, __ffs(ge) - 1) == q;
            break;
          }
          c += 32;
        }
        if (found) {
          from = c;
          const uint32_t last = theirs[wc - 1];
          const int lq = last & 0xffff;
          int lf = last >> 16;
          if (s_open[i]) {
            int j, m;
            fetch<MODE>(t0, t1, base + lq, j, m);
            lf = extend_warp(s, lq, j, lf, limit, lane);
            if (lane == 0) walked[i * cap + wc - 1] = lq | static_cast<uint32_t>(lf) << 16;
          }
          p = lq + lf;
          break;
        }
        int f = scan[q];
        if (f == kUnsettled) {
          int j, m;
          fetch<MODE>(t0, t1, base + q, j, m);
          f = extend_warp(s, q, j, min(m, limit - q), limit, lane);
        }
        if (lane == 0) joined[i * cap + own] = q | static_cast<uint32_t>(f) << 16;
        ++own;
        p = q + f;
      }
      if (lane == 0) {
        s_from[i] = from;
        s_joined[i] = own;
        s_at[i] = total;
      }
      total += own + wc - from;
    }
    if (lane == 0) s_nseq = total;
  }
  __syncthreads();
  // b3. the chain in order: each segment's joined steps, then its walk from
  //     the join on
  for (int i = warp; i < kLanes; i += kWarps) {
    uint32_t* to = rec + s_at[i];
    const int own = s_joined[i], from = s_from[i], wc = s_walked[i];
    for (int x = lane; x < own; x += 32) to[x] = joined[i * cap + x];
    for (int x = lane; x < wc - from; x += 32) to[own + x] = walked[i * cap + from + x];
  }
  __syncthreads();

  // c. the values
  const int nseq = s_nseq;
  const int room = cl + cl / 255 + 16;  // the host serializer's buffer past the header
  uint8_t* slot = slots + static_cast<size_t>(b) * slot_stride;
  uint8_t* out = slot + 4;
  int carry = 0;
  for (int t = 0; t < nseq; t += NT) {
    const int k = t + tid;
    int size = 0, need = 0, lit = 0, ll = 0, ml = 0, off = 0;
    if (k < nseq) {
      const uint32_t r = rec[k];
      const int q = r & 0xffff, f = r >> 16;
      if (k > 0) {
        const uint32_t r0 = rec[k - 1];
        lit = (r0 & 0xffff) + (r0 >> 16);
      }
      int j, m;
      fetch<MODE>(t0, t1, base + q, j, m);
      int pp = q, jj = j;
      while (pp > lit && jj > 0 && s[pp - 1] == s[jj - 1]) {
        --pp;
        --jj;
      }
      ll = pp - lit;
      ml = f + q - pp;
      off = q - j;
      size = 1 + lsic_len(ll) + ll + 2 + lsic_len(ml - kMinMatch);
      need = 1 + ll / 255 + 1 + ll + 2 + ml / 255 + 1;
    }
    int tile;
    const int o = carry + block_scan<NT>(size, sums, &tile);
    if (k < nseq) {
      const bool fits = o + need <= room;
      if (!fits) s_over = 1;
      run_src[tid] = lit;
      run_dst[tid] = o + 1 + lsic_len(ll);
      run_len[tid] = fits ? ll : 0;
      if (fits) {
        uint8_t* op = out + o;
        *op++ = static_cast<uint8_t>((min(ll, 15) << 4) | min(ml - kMinMatch, 15));
        if (ll >= 15) op = write_lsic(op, ll);
        op += ll;
        *op++ = static_cast<uint8_t>(off);
        *op++ = static_cast<uint8_t>(off >> 8);
        if (ml - kMinMatch >= 15) write_lsic(op, ml - kMinMatch);
      }
    }
    __syncthreads();
    const int in_tile = min(NT, nseq - t);
    for (int i = warp; i < in_tile; i += kWarps) {
      const uint8_t* from = s + run_src[i];
      uint8_t* to = out + run_dst[i];
      for (int x = lane; x < run_len[i]; x += 32) to[x] = from[x];
    }
    carry += tile;
    __syncthreads();
  }

  // the last literals, then the choice
  int end = 0;
  if (nseq) {
    const uint32_t r = rec[nseq - 1];
    end = (r & 0xffff) + (r >> 16);
  }
  const int ll = cl - end;
  const bool fits = carry + 1 + ll / 255 + 1 + ll <= room;
  const int csz = carry + 1 + lsic_len(ll) + ll;
  const bool raw = csz >= cl;
  if (fits && !raw) {
    if (tid == 0) {
      uint8_t* op = out + carry;
      *op++ = static_cast<uint8_t>(min(ll, 15) << 4);
      if (ll >= 15) write_lsic(op, ll);
    }
    uint8_t* to = out + carry + 1 + lsic_len(ll);
    for (int x = tid; x < ll; x += NT) to[x] = s[end + x];
  }
  if (raw) {
    __syncthreads();  // the emission's bytes are overwritten
    for (int x = tid; x < cl; x += NT) out[x] = s[x];
  }
  if (tid == 0) {
    const uint32_t hdr = raw ? static_cast<uint32_t>(cl) | 0x80000000u : static_cast<uint32_t>(csz);
    slot[0] = hdr & 0xff;
    slot[1] = (hdr >> 8) & 0xff;
    slot[2] = (hdr >> 16) & 0xff;
    slot[3] = hdr >> 24;
    sizes[b] = (s_over || !fits) ? -1 : 4 + (raw ? cl : csz);
  }
}

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kPlaceThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const uint8_t* __restrict__ slots, int slot_stride,
                 const int* __restrict__ sizes, int nb, uint8_t* __restrict__ out) {
  __shared__ long long red[kPlaceThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  long long before = 0;
  for (int i = tid; i < b; i += kPlaceThreads) before += max(sizes[i], 0);
  before = block_sum(before, red);
  const int size = sizes[b];
  const uint8_t* from = slots + static_cast<size_t>(b) * slot_stride;
  uint8_t* to = out + kHeader + before;
  for (int x = tid; x < size; x += kPlaceThreads) to[x] = from[x];
  if (b == nb - 1) {
    long long over = 0;
    for (int i = tid; i < nb; i += kPlaceThreads) over += sizes[i] < 0;
    over = block_sum(over, red);
    if (tid == 0) {
      long long* head = reinterpret_cast<long long*>(out);
      head[0] = before + max(size, 0);
      head[1] = over;
    }
  }
}

template <int MODE, int NT, int PARSE>
int launch_shape(const void* blocks, int nb, int B, long long n, const void* t0, const void* t1,
                void* chain, void* slots, int slot_stride, void* sizes, cudaStream_t stream) {
  const int smem = 2 * round16(B) + kScanPad + (3 * NT + NT / 32) * 4;
  const cudaError_t rc = cudaFuncSetAttribute(
      serialize_kernel<MODE, NT, PARSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return int(rc);
  serialize_kernel<MODE, NT, PARSE><<<nb, NT, smem, stream>>>(
      static_cast<const uint8_t*>(blocks), B, n, t0, t1, static_cast<uint32_t*>(chain),
      static_cast<int>(chain_words(B)), static_cast<uint8_t*>(slots), slot_stride,
      static_cast<int*>(sizes));
  return int(cudaGetLastError());
}

template <int MODE, int PARSE>
int launch_mode(const void* blocks, int nb, int B, long long n, const void* t0, const void* t1,
                void* chain, void* slots, int slot_stride, void* sizes, cudaStream_t stream) {
  if (B <= kSmallBlock)
    return launch_shape<MODE, kSmallThreads, PARSE>(blocks, nb, B, n, t0, t1, chain, slots,
                                                   slot_stride, sizes, stream);
  return launch_shape<MODE, kLargeThreads, PARSE>(blocks, nb, B, n, t0, t1, chain, slots,
                                                 slot_stride, sizes, stream);
}

}  // namespace

// blocks (nb, B) u8, 1 <= B <= 65536, the first n bytes data and zeros past
// them; mode 0 pair: t0 (nb, B) u16 src, t1 (nb, B) u8 code; 1 u16 (B <=
// 8192): t0 (nb, B) u16 tokens, t1 unused; parse 0 greedy, 1 HC; chain scratch (nb, chain_len)
// u32, chain_len = chain_words(B); slots scratch (nb, slot_stride) u8,
// slot_stride >= 4 + B + B / 255 + 16 and a multiple of 16; sizes scratch
// (nb,) i32; out 16 + n + 4 * nb bytes: i64 total and i64 blocks
// overflowed, then the sections.  Launches the walk and the placement on
// stream.  Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown mode or parse or a bad shape.
extern "C" int zp_lz4_serialize(const void* blocks, int nb, int B, long long n, int mode,
                                int parse, const void* t0, const void* t1, void* chain,
                                long long chain_len,
                                void* slots, int slot_stride, void* sizes, void* out,
                                void* stream) {
  if (nb < 1 || B < 1 || B > 65536 || n < 0 || n > static_cast<long long>(nb) * B ||
      chain_len != chain_words(B) ||
      slot_stride < 4 + B + B / 255 + 16 || (slot_stride & 15) != 0 ||
      (mode == kU16 && B > 8192) || (parse != kGreedy && parse != kHc))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (mode * 2 + parse) {
    case kPair * 2 + kGreedy:
      rc = launch_mode<kPair, kGreedy>(blocks, nb, B, n, t0, t1, chain, slots, slot_stride,
                                       sizes, st);
      break;
    case kPair * 2 + kHc:
      rc = launch_mode<kPair, kHc>(blocks, nb, B, n, t0, t1, chain, slots, slot_stride, sizes,
                                   st);
      break;
    case kU16 * 2 + kGreedy:
      rc = launch_mode<kU16, kGreedy>(blocks, nb, B, n, t0, t1, chain, slots, slot_stride,
                                      sizes, st);
      break;
    case kU16 * 2 + kHc:
      rc = launch_mode<kU16, kHc>(blocks, nb, B, n, t0, t1, chain, slots, slot_stride, sizes,
                                  st);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  place_kernel<<<nb, kPlaceThreads, 0, st>>>(static_cast<const uint8_t*>(slots), slot_stride,
                                            static_cast<const int*>(sizes), nb,
                                            static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}
