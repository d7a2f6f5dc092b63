// zstd frame assembly for Hopper (sm_90a): the repeat-offset stitching, the
// segment layout, every layout check and the output's trim, with no wait.
//
// Replaces no TPU kernel: the JAX package lays the sequences out with XLA
// ops (zpack_tpu/parallel/extract.py:_scatter_rows, _scatter_flat_u8,
// _masked_sums, _seg_prefix_validate) and stitches the repeat offsets on
// the host.  Written for the card so that a zstd read waits on it once:
// what these steps need of the decoders (the blocks' repeat-offset totals,
// their literal and match sums, the decoders' flags) stays on the card, and
// the host reads back the output and one record of every check, together.
// The contracts are stated in plain PyTorch and NumPy by
// zpack_tpu_torch/kernels/assemble_torch.py (stitch_plain, layout_plain,
// trim_plain).  Three entry points, in stream order:
//
//   stitch  one CTA.  The card's flags first: a Huffman stream not consumed,
//           an offset code above 30, the first sequence section not consumed
//           exactly.  Then the blocks in tiles of 256, one a thread: a scan
//           (Hillis-Steele in shared memory) of each block's literal bytes,
//           output bytes and segment count, and of its repeat-offset map,
//           where a frame's first block starts from the constant map of the
//           initial offsets (1, 4, 8), so the scan's exclusive value at a
//           block is its entry state (a frame's maps reset at its first
//           block; maps compose as in rep_resolve.cu).  The exclusive sums
//           go to `bases`, the entry states to `entry` for rep_apply.  Each
//           block's checks (literal run overruns literals, more than 128
//           KiB regenerated) give a key 4 * block + kind, the least kept.
//           Then a thread a frame: its output and segment count from the
//           sums, the output bound (the sum to the frame's end over
//           `max_out`: key 4 * (its last block + 1) - 2), its declared size
//           against the computed one, and the replay's segment count and
//           length: zero for a frame the replay must not run, where a block
//           check failed anywhere, the declared size is wrong, or the
//           length exceeds `cap`.  Thread 0 writes the record.
//   layout  a CTA a block, then a CTA a raw or RLE literal run.  A block's
//           sequences in tiles of 1,024 (four a thread, a warp scan by
//           shuffles, the eight warp totals through shared memory) give
//           each segment its start and its literals' start in the frame's
//           row, and the check that no match reaches before the frame; its
//           literal tail and a literal-only block are one segment each.  A
//           run CTA copies its literal bytes into the literal rows.
//   trim    the replay's (F, n_out) rows to the frames' bytes back to back,
//           behind a copy of the record with the replay's error word, so
//           the host reads both in one copy.
//
// Inputs downstream of a failed check are garbage, and nothing here trusts
// them: columns and destinations are computed from counts that the host
// bounded (the segment table's width holds every frame's sequences plus one
// segment a block), sums are 64-bit, and a frame whose tables could send the
// replay outside its literal row gets a replay length of zero.
//
// What bounds it: bytes, and the launches.  layout reads three int32 a
// sequence and writes four; trim reads and writes each output byte once;
// stitch is a few hundred integer steps a block on one CTA.  For the reads
// of a desktop tree (a few KB, a handful of blocks) the three launches are
// the cost, each a few microseconds of the host's, where a synchronisation
// costs tens.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kStitch = 256;              // threads of the stitch CTA, a block each
constexpr int kLayout = 256;              // threads of a layout CTA
constexpr int kPer = 4;                   // sequences a layout thread, a tile
constexpr int kTile = kLayout * kPer;
constexpr int kWarps = kLayout / 32;
constexpr int kTrim = 256;                // threads of a trim CTA
constexpr int kTrimBytes = 16;            // output bytes a trim thread
constexpr long long kMaxBlock = 128 << 10;  // bytes a block may regenerate (RFC 8878)
constexpr unsigned kFull = 0xffffffffu;

// the record's words (assemble_torch.REC_*)
constexpr int kRecHuffman = 0, kRecFseCode = 1, kRecFseItem = 2, kRecFsePos = 3, kRecRep = 4,
              kRecLayout = 5, kRecBeyond = 6, kRecReplay = 7, kRecResize = 8, kRecWords = 16;

// out_j = in[sel_j] + v_j, or v_j where sel_j == 3; sel_j at bits 2j, 2j + 1
struct Map {
  int sel, v0, v1, v2;
};

__device__ __forceinline__ Map identity() { return {0 | 1 << 2 | 2 << 4, 0, 0, 0}; }

__device__ __forceinline__ int add32(int a, int b) { return int(uint32_t(a) + uint32_t(b)); }

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

// a block's share of the scan: its map, segments, output and literal bytes
struct Elem {
  Map m;
  long long nseg, total, lits;
};

__device__ __forceinline__ Elem combine(const Elem& a, const Elem& b) {
  return Elem{after(a.m, b.m), a.nseg + b.nseg, a.total + b.total, a.lits + b.lits};
}

__global__ void __launch_bounds__(kStitch)
stitch_kernel(const long long* __restrict__ blk, int nb, const long long* __restrict__ frame_first,
              int F, const long long* __restrict__ seq_off, const int* __restrict__ sel,
              const int* __restrict__ val, const long long* __restrict__ sums, int B,
              const int* __restrict__ final_bits, int S, const int* __restrict__ pos_f,
              const uint8_t* __restrict__ ferr, const long long* __restrict__ declared,
              long long max_out, long long cap, int* __restrict__ entry,
              long long* __restrict__ bases, int* __restrict__ frame_out, int* __restrict__ rec) {
  __shared__ Elem buf[2][kStitch];
  __shared__ Elem carry;
  __shared__ int s_huf, s_code, s_item, s_block_key, s_frame_key, s_resize;
  const int t = threadIdx.x;
  if (t == 0) {
    s_huf = s_code = s_resize = 0;
    s_item = s_block_key = s_frame_key = INT_MAX;
    carry = Elem{identity(), 0, 0, 0};
  }
  __syncthreads();

  // the decoders' flags
  int huf = 0, code = 0, item = INT_MAX;
  for (int s = t; s < S; s += kStitch) huf |= final_bits[s] != 0;
  for (int b = t; b < B; b += kStitch) {
    code |= ferr[b] != 0;
    if (item == INT_MAX && pos_f[b] != 0 && seq_off[b + 1] > seq_off[b]) item = b;
  }
  if (huf) atomicOr(&s_huf, 1);
  if (code) atomicOr(&s_code, 1);
  if (item != INT_MAX) atomicMin(&s_item, item);

  // the blocks, a tile at a time
  const Map init = {3 | 3 << 2 | 3 << 4, 1, 4, 8};
  int key = INT_MAX;
  for (int base = 0; base < nb; base += kStitch) {
    const int i = base + t;
    Elem e = {identity(), 0, 0, 0};
    bool first = false;
    int slot = -1;
    if (i < nb) {
      const long long frame = blk[3 * i], lt = blk[3 * i + 1];
      slot = int(blk[3 * i + 2]);
      first = i == 0 || blk[3 * (i - 1)] != frame;
      e.lits = lt;
      if (slot < 0) {
        e.total = lt;
        e.nseg = lt > 0;
      } else {
        const long long tail = lt - sums[2 * slot], produced = lt + sums[2 * slot + 1];
        if (key == INT_MAX) {
          if (tail < 0) key = 4 * i;
          else if (produced > kMaxBlock) key = 4 * i + 1;
        }
        e.total = produced;
        e.nseg = seq_off[slot + 1] - seq_off[slot] + (tail > 0);
        const int* s3 = sel + 3 * slot;
        const int* v3 = val + 3 * slot;
        e.m = Map{(s3[0] & 3) | (s3[1] & 3) << 2 | (s3[2] & 3) << 4, v3[0], v3[1], v3[2]};
      }
      if (first) e.m = after(init, e.m);
    }
    int cur = 0;
    buf[0][t] = e;
    __syncthreads();
    for (int d = 1; d < kStitch; d <<= 1) {
      Elem x = buf[cur][t];
      if (t >= d) x = combine(buf[cur][t - d], x);
      buf[cur ^ 1][t] = x;
      cur ^= 1;
      __syncthreads();
    }
    const Elem ex = t ? combine(carry, buf[cur][t - 1]) : carry;
    if (i < nb) {
      bases[3 * i] = ex.nseg;
      bases[3 * i + 1] = ex.total;
      bases[3 * i + 2] = ex.lits;
      if (slot >= 0) {
        // within a frame the exclusive map is constant: the entry state
        int* en = entry + 3 * slot;
        en[0] = first ? 1 : ex.m.v0;
        en[1] = first ? 4 : ex.m.v1;
        en[2] = first ? 8 : ex.m.v2;
      }
    }
    __syncthreads();
    if (t == 0) carry = combine(carry, buf[cur][kStitch - 1]);
    __syncthreads();
  }
  if (key != INT_MAX) atomicMin(&s_block_key, key);
  if (t == 0) {
    bases[3 * nb] = carry.nseg;
    bases[3 * nb + 1] = carry.total;
    bases[3 * nb + 2] = carry.lits;
  }
  __syncthreads();

  // the frames, a thread each
  const bool block_err = s_block_key != INT_MAX;
  long long* f_total = reinterpret_cast<long long*>(rec + kRecWords);
  int fkey = INT_MAX, resize = 0;
  for (int j = t; j < F; j += kStitch) {
    const long long f0 = frame_first[j], f1 = frame_first[j + 1];
    const long long total = bases[3 * f1 + 1] - bases[3 * f0 + 1];
    const long long nseg = bases[3 * f1] - bases[3 * f0];
    if (max_out >= 0 && bases[3 * f1 + 1] > max_out && fkey == INT_MAX)
      fkey = int(4 * f1 - 2);
    const long long want = declared[j];
    const bool wrong = want >= 0 && want != total;
    resize |= wrong;
    const bool ok = !block_err && !wrong && total <= cap && nseg <= INT_MAX;
    f_total[j] = total;
    frame_out[j] = ok ? int(nseg) : 0;
    frame_out[F + j] = ok ? int(total) : 0;
  }
  if (fkey != INT_MAX) atomicMin(&s_frame_key, fkey);
  if (resize) atomicOr(&s_resize, 1);
  __syncthreads();
  if (t == 0) {
    int pos = 0;
    if (s_item != INT_MAX) pos = pos_f[s_item];
    rec[kRecHuffman] = s_huf;
    rec[kRecFseCode] = s_code;
    rec[kRecFseItem] = s_item;
    rec[kRecFsePos] = pos;
    rec[kRecRep] = 0;
    rec[kRecLayout] = min(s_block_key, s_frame_key);
    rec[kRecBeyond] = 0;
    rec[kRecReplay] = 0;
    rec[kRecResize] = s_resize;
    for (int w = kRecResize + 1; w < kRecWords; ++w) rec[w] = 0;
  }
}

__device__ __forceinline__ long long warp_incl(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// seg: four (F * SB) int32 planes, seg_start, lit_start, lit_len, offset
__global__ void __launch_bounds__(kLayout)
layout_kernel(const long long* __restrict__ blk, int nb, const long long* __restrict__ frame_first,
              const long long* __restrict__ bases, const long long* __restrict__ seq_off,
              const int* __restrict__ lls, const int* __restrict__ mls,
              const int* __restrict__ offs, const long long* __restrict__ sums,
              const uint8_t* __restrict__ rep_err, long long SB, int* __restrict__ seg,
              long long plane, const long long* __restrict__ runs,
              const uint8_t* __restrict__ run_src, uint8_t* __restrict__ lits,
              int* __restrict__ rec) {
  const int t = threadIdx.x;
  if (int(blockIdx.x) >= nb) {  // a raw or RLE literal run
    const long long* r = runs + 4 * ((long long)blockIdx.x - nb);
    const long long n = r[0], dst = r[1], src = r[2], step = r[3];
    for (long long k = t; k < n; k += kLayout) lits[dst + k] = run_src[src + k * step];
    return;
  }
  __shared__ long long wx[kWarps], wy[kWarps];
  const int i = blockIdx.x;
  const long long frame = blk[3 * i], lt = blk[3 * i + 1];
  const int slot = int(blk[3 * i + 2]);
  const long long* b0 = bases + 3 * frame_first[frame];
  const long long* bi = bases + 3 * i;
  const long long col = frame * SB + (bi[0] - b0[0]);  // the block's first segment
  const long long ob = bi[1] - b0[1], lb = bi[2] - b0[2];  // its output and literals in the frame
  int* seg_start = seg;
  int* lit_start = seg + plane;
  int* lit_len = seg + 2 * plane;
  int* offset = seg + 3 * plane;
  if (slot < 0) {
    if (t == 0 && lt > 0) {
      seg_start[col] = int(ob);
      lit_start[col] = int(lb);
      lit_len[col] = int(lt);
      offset[col] = 0;
    }
    return;
  }
  const long long s0 = seq_off[slot], n = seq_off[slot + 1] - s0;
  const int lane = t & 31, warp = t >> 5;
  long long cx = 0, cy = 0;  // the tiles before: output and literal bytes
  int beyond = 0;
  for (long long k0 = 0; k0 < n; k0 += kTile) {
    int ll[kPer], ml[kPer], of[kPer];
    long long tx = 0, ty = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long k = k0 + kPer * t + q;
      ll[q] = ml[q] = of[q] = 0;
      if (k < n) {
        ll[q] = lls[s0 + k];
        ml[q] = mls[s0 + k];
        of[q] = offs[s0 + k];
      }
      tx += (long long)ll[q] + ml[q];
      ty += ll[q];
    }
    const long long ix = warp_incl(tx, lane), iy = warp_incl(ty, lane);
    __syncthreads();  // the tile before has read wx, wy
    if (lane == 31) {
      wx[warp] = ix;
      wy[warp] = iy;
    }
    __syncthreads();
    long long px = cx + ix - tx, py = cy + iy - ty;  // exclusive, before this thread
    for (int w = 0; w < warp; ++w) {
      px += wx[w];
      py += wy[w];
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long k = k0 + kPer * t + q;
      if (k < n) {
        const long long st = ob + px;  // the segment's start in the frame
        seg_start[col + k] = int(st);
        lit_start[col + k] = int(lb + py);
        lit_len[col + k] = ll[q];
        offset[col + k] = of[q];
        beyond |= ml[q] > 0 && (long long)of[q] > st + ll[q];
      }
      px += (long long)ll[q] + ml[q];
      py += ll[q];
    }
    for (int w = 0; w < kWarps; ++w) {
      cx += wx[w];
      cy += wy[w];
    }
  }
  if (__syncthreads_or(beyond) && t == 0) rec[kRecBeyond] = 1;
  if (t == 0) {
    if (rep_err[slot]) rec[kRecRep] = 1;
    const long long sll = sums[2 * slot], sml = sums[2 * slot + 1], tail = lt - sll;
    if (tail > 0) {
      seg_start[col + n] = int(ob + sll + sml);
      lit_start[col + n] = int(lb + sll);
      lit_len[col + n] = int(tail);
      offset[col + n] = 0;
    }
  }
}

__global__ void __launch_bounds__(kTrim)
trim_kernel(const uint8_t* __restrict__ rows, long long n_out, const long long* __restrict__ off,
            int F, long long total, const int* __restrict__ state, const int* __restrict__ rec,
            int rec_words, uint8_t* __restrict__ out) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {  // the record, with the replay's error word
    int* head = reinterpret_cast<int*>(out);
    for (int w = t; w < rec_words; w += kTrim)
      head[w] = w == kRecReplay ? (state ? state[0] : 0) : rec[w];
  }
  uint8_t* flat = out + 4 * (long long)rec_words;
  const long long p0 = ((long long)blockIdx.x * kTrim + t) * kTrimBytes;
  if (p0 >= total) return;
  int lo = 0, hi = F;  // the last frame that starts at or before p0
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= p0) lo = mid; else hi = mid;
  }
  int j = lo;
  for (int q = 0; q < kTrimBytes; ++q) {
    const long long p = p0 + q;
    if (p >= total) break;
    while (p >= off[j + 1]) ++j;
    flat[p] = rows[j * n_out + (p - off[j])];
  }
}

}  // namespace

// stitch: blk (nb, 3) i64 (frame, literal bytes, item or -1); frame_first
// (F + 1,) i64; seq_off (B + 1,) i64; sel, val (B, 3) i32 and sums (B, 2) i64
// of rep_totals; final (S,) i32; pos_f (B,) i32; ferr (B,) u8; declared (F,)
// i64, -1 unknown; max_out -1 for none.  Writes entry (B, 3) i32, bases
// (nb + 1, 3) i64, frame_out (2, F) i32 and the record (16 i32, then F i64).
extern "C" int zp_zstd_stitch(const void* blk, int nb, const void* frame_first, int F,
                              const void* seq_off, const void* sel, const void* val,
                              const void* sums, int B, const void* final_bits, int S,
                              const void* pos_f, const void* ferr, const void* declared,
                              long long max_out, long long cap, void* entry, void* bases,
                              void* frame_out, void* rec, void* stream) {
  stitch_kernel<<<1, kStitch, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(blk), nb, static_cast<const long long*>(frame_first), F,
      static_cast<const long long*>(seq_off), static_cast<const int*>(sel),
      static_cast<const int*>(val), static_cast<const long long*>(sums), B,
      static_cast<const int*>(final_bits), S, static_cast<const int*>(pos_f),
      static_cast<const uint8_t*>(ferr), static_cast<const long long*>(declared), max_out, cap,
      static_cast<int*>(entry), static_cast<long long*>(bases), static_cast<int*>(frame_out),
      static_cast<int*>(rec));
  return int(cudaGetLastError());
}

// layout: a CTA a block (nb), then a CTA a literal run (R); lls, mls, offs
// the flat sequences; rep_err (B,) u8; seg four (F * SB) i32 planes, `plane`
// apart; runs (R, 4) i64 (length, destination, source, step) into lits from
// run_src.
extern "C" int zp_zstd_layout(const void* blk, int nb, const void* frame_first, const void* bases,
                              const void* seq_off, const void* lls, const void* mls,
                              const void* offs, const void* sums, const void* rep_err,
                              long long SB, void* seg, long long plane, const void* runs, int R,
                              const void* run_src, void* lits, void* rec, void* stream) {
  const long long grid = (long long)nb + R;
  if (grid < 1 || grid > INT_MAX) return int(cudaErrorInvalidValue);
  layout_kernel<<<int(grid), kLayout, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(blk), nb, static_cast<const long long*>(frame_first),
      static_cast<const long long*>(bases), static_cast<const long long*>(seq_off),
      static_cast<const int*>(lls), static_cast<const int*>(mls), static_cast<const int*>(offs),
      static_cast<const long long*>(sums), static_cast<const uint8_t*>(rep_err), SB,
      static_cast<int*>(seg), plane, static_cast<const long long*>(runs),
      static_cast<const uint8_t*>(run_src), static_cast<uint8_t*>(lits), static_cast<int*>(rec));
  return int(cudaGetLastError());
}

// trim: rows (F, n_out) u8; off (F + 1,) i64, each frame's place in the
// output (off[F] = total); state the replay's (null: no replay ran); out
// (4 * rec_words + total) u8: the record, then the frames back to back.
extern "C" int zp_zstd_trim(const void* rows, long long n_out, const void* off, int F,
                            long long total, const void* state, const void* rec, int rec_words,
                            void* out, void* stream) {
  const long long per = (long long)kTrim * kTrimBytes;
  const long long grid = total > 0 ? (total + per - 1) / per : 1;
  if (F < 1 || grid > INT_MAX) return int(cudaErrorInvalidValue);
  trim_kernel<<<int(grid), kTrim, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), n_out, static_cast<const long long*>(off), F, total,
      static_cast<const int*>(state), static_cast<const int*>(rec), rec_words,
      static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}
