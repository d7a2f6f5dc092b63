// One zstd read's launch chain on the card, from one host call a part.
//
// Replaces no TPU kernel: it is the enqueue of the read that
// zpack_tpu_torch/parallel/extract.py:_decode_python makes through its
// stage and eight Python wrappers, a ctypes call, a stream lookup and an
// argument check a launch
// (about a millisecond of host time a read, against a fifth of that on the
// card for the tree's median entry).  Here the host's layout
// (native/zstd_read.cpp, zstd_chain.cuh) gives every buffer its place in
// one arena, and the kernels of today run in today's order through their
// own entry points, on the caller's stream, with nothing allocated and no
// wait:
//
//   part A        the upload (one copy from pinned memory into the arena's
//                 head), the literal rows and Huffman positions zeroed,
//                 huffman_decode, fse_decode, rep_totals, stitch, rep_apply,
//                 layout; alone (the exact path), the record copied back
//   restitch      every declared size set to -1, the stitch again (a read
//                 whose declared size the card found wrong)
//   part B        the frames' offsets copied up where the caller gives
//                 them, the replay's tile flags and state set, the replay's
//                 three kernels, trim, and the record and output copied back
//
// Zero fills are cudaMemsetAsync on the arena, not fill kernels.  The
// replay reads its tile flags as "nonzero: live", so bytes of 1 set them.
// Each kernel that launched is reported by its code (KERNELS in
// kernels/zstd_chain.py), for the caller's launch count.  Bound: the host's
// enqueue of some ten launches and four copies or fills, a few
// microseconds each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zstd_chain.cuh"

extern "C" {
int zp_huffman_decode(const void* payload, long long payload_len, const void* rows, int S,
                      const void* tables, int T, void* out, long long n_out, void* final_bits,
                      int stage, void* stream);
int zp_fse_decode(const void* payload, long long payload_len, const void* rows,
                  const void* seq_off, const void* al, const void* tables, int B, int any_steps,
                  int stage, void* rec, void* lls, void* mls, void* ovs, void* pos_f, void* err,
                  void* stream);
int zp_rep_totals(const void* ovs, const void* lls, const void* mls, const void* seq_off, int B,
                  void* sel, void* val, void* sums, void* stream);
int zp_rep_apply(const void* ovs, const void* lls, const void* seq_off, const void* entry, int B,
                 void* offsets, void* err, void* stream);
int zp_zstd_stitch(const void* blk, int nb, const void* frame_first, int F, const void* seq_off,
                   const void* sel, const void* val, const void* sums, int B,
                   const void* final_bits, int S, const void* pos_f, const void* ferr,
                   const void* declared, long long max_out, long long cap, void* entry,
                   void* bases, void* frame_out, void* rec, void* stream);
int zp_zstd_layout(const void* blk, int nb, const void* frame_first, const void* bases,
                   const void* seq_off, const void* lls, const void* mls, const void* offs,
                   const void* sums, const void* rep_err, long long SB, void* seg,
                   long long plane, const void* runs, int R, const void* run_src, void* lits,
                   void* rec, void* stream);
int zp_lz4_replay(const void* lit_bytes, int L, const void* seg_start, const void* lit_start,
                  const void* lit_len, const void* offset, const void* n_seq,
                  const void* out_len, int bp, int S, int n_out, void* out, void* f,
                  int fstride, void* live, void* state, void* stream);
int zp_zstd_trim(const void* rows, long long n_out, const void* off, int F, long long total,
                 const void* state, const void* rec, int rec_words, void* out, void* stream);
}

namespace {

// The kernels by the code reported for each launch (kernels/zstd_chain.py
// KERNELS, the same order).
enum Kernel : int {
  kHuffman, kFse, kRepTotals, kStitch, kRepApply, kLayout, kReplay, kTrim
};

struct Chain {
  const long long* d;
  uint8_t* arena;   // the upload, then part A's buffers
  uint8_t* part_b;  // part B's buffers
  cudaStream_t st;
  int* launched;
  int n;

  // a buffer of the arena or of part B; null where the layout has none
  void* a(int slot) const { return d[slot] < 0 ? nullptr : arena + d[slot]; }
  void* b(int slot) const { return d[slot] < 0 ? nullptr : part_b + d[slot]; }
  // a buffer of `count` elements, null for none, as the wrappers pass it
  void* a(int slot, long long count) const { return count ? a(slot) : nullptr; }

  int run(Kernel k, int rc) {
    if (rc == 0) launched[n++] = k;
    return rc;
  }

  int stitch(long long cap) {
    return run(kStitch, zp_zstd_stitch(
        a(ZR_UP_BLK), int(d[ZR_NB]), a(ZR_UP_FIRST), int(d[ZR_F]), a(ZR_UP_SEQ_OFF),
        a(ZR_A_SEL), a(ZR_A_VAL), a(ZR_A_SUMS), int(d[ZR_B]), a(ZR_A_FINAL, d[ZR_S]),
        int(d[ZR_S]), a(ZR_A_POS_F), a(ZR_A_FERR), a(ZR_UP_DECLARED), d[ZR_MAX_OUT], cap,
        a(ZR_A_ENTRY), a(ZR_A_BASES), a(ZR_A_FRAME_OUT), a(ZR_A_REC), st));
  }

  int part_a(const void* pinned, void* back) {
    const long long F = d[ZR_F], NB = d[ZR_NB], S = d[ZR_S], B = d[ZR_B], R = d[ZR_R];
    const long long N = d[ZR_N], LB = d[ZR_LB], SB = d[ZR_SB];
    void* source = a(ZR_UP_SOURCE, N);
    int rc = int(cudaMemcpyAsync(arena, pinned, d[ZR_UP_BYTES], cudaMemcpyHostToDevice, st));
    // the literal rows and, right after them, the Huffman streams' final
    // positions start at zero
    if (!rc) rc = int(cudaMemsetAsync(a(ZR_A_LITS), 0, d[ZR_A_FINAL] + 4 * S - d[ZR_A_LITS], st));
    if (!rc && S)
      rc = run(kHuffman, zp_huffman_decode(source, N, a(ZR_UP_HUF_ROWS), int(S),
                                           a(ZR_UP_HUF_TABLES), int(d[ZR_T]), a(ZR_A_LITS),
                                           F * LB, a(ZR_A_FINAL), int(d[ZR_HUF_STAGE]), st));
    if (!rc && B) {
      const long long widest = d[ZR_FSE_WIDEST];
      rc = run(kFse, zp_fse_decode(source, N, a(ZR_UP_FSE_ROWS), a(ZR_UP_SEQ_OFF),
                                   a(ZR_UP_FSE_AL), a(ZR_UP_FSE_TABLES), int(B),
                                   int(d[ZR_FSE_LONGEST] > 0),
                                   int(widest < zr::kFseStageCap ? widest : zr::kFseStageCap),
                                   a(ZR_A_FREC), a(ZR_A_LLS), a(ZR_A_MLS), a(ZR_A_OVS),
                                   a(ZR_A_POS_F), a(ZR_A_FERR), st));
      if (!rc)
        rc = run(kRepTotals, zp_rep_totals(a(ZR_A_OVS), a(ZR_A_LLS), a(ZR_A_MLS),
                                           a(ZR_UP_SEQ_OFF), int(B), a(ZR_A_SEL), a(ZR_A_VAL),
                                           a(ZR_A_SUMS), st));
    }
    if (!rc) rc = stitch(d[ZR_CAP] < zr::kNone ? d[ZR_CAP] : zr::kNone);
    if (!rc && B)
      rc = run(kRepApply, zp_rep_apply(a(ZR_A_OVS), a(ZR_A_LLS), a(ZR_UP_SEQ_OFF), a(ZR_A_ENTRY),
                                       int(B), a(ZR_A_OFFS), a(ZR_A_REP_ERR), st));
    if (!rc && NB + R)  // without sequences the offsets and flags are none
      rc = run(kLayout, zp_zstd_layout(a(ZR_UP_BLK), int(NB), a(ZR_UP_FIRST), a(ZR_A_BASES),
                                       a(ZR_UP_SEQ_OFF), a(ZR_A_LLS), a(ZR_A_MLS), a(ZR_A_OFFS),
                                       a(ZR_A_SUMS), a(ZR_A_REP_ERR), SB, a(ZR_A_SEG), F * SB,
                                       a(ZR_UP_RUNS, R), int(R), source, a(ZR_A_LITS),
                                       a(ZR_A_REC), st));
    if (!rc && back)  // the exact path: the record alone, for the sizes
      rc = int(cudaMemcpyAsync(back, a(ZR_A_REC), 4 * d[ZR_REC_WORDS], cudaMemcpyDeviceToHost,
                               st));
    return rc;
  }

  int restitch() {
    int rc = int(cudaMemsetAsync(a(ZR_UP_DECLARED), 0xFF, 8 * d[ZR_F], st));  // int64 -1
    return rc ? rc : stitch(zr::kNone);
  }

  int part_b_run(const void* offsets_host, void* back) {
    const long long F = d[ZR_F], SB = d[ZR_SB], n_out = d[ZR_N_OUT];
    const void* off = a(ZR_UP_OFFSETS);
    int rc = 0;
    if (offsets_host) {
      rc = int(cudaMemcpyAsync(b(ZR_B_OFFSETS), offsets_host, 8 * (F + 1),
                               cudaMemcpyHostToDevice, st));
      off = b(ZR_B_OFFSETS);
    }
    if (!rc && n_out) {
      rc = int(cudaMemsetAsync(b(ZR_B_LIVE), 1, 4 * d[ZR_TILES], st));
      if (!rc) rc = int(cudaMemsetAsync(b(ZR_B_STATE), 0, 4 * zr::kReplayState, st));
      const int* seg = static_cast<const int*>(a(ZR_A_SEG));
      const int* frame_out = static_cast<const int*>(a(ZR_A_FRAME_OUT));
      const long long plane = F * SB;
      if (!rc)
        rc = run(kReplay, zp_lz4_replay(a(ZR_A_LITS), int(d[ZR_LB]), seg, seg + plane,
                                        seg + 2 * plane, seg + 3 * plane, frame_out,
                                        frame_out + F, int(F), int(SB), int(n_out), b(ZR_B_ROWS),
                                        b(ZR_B_F), int(d[ZR_FSTRIDE]), b(ZR_B_LIVE),
                                        b(ZR_B_STATE), st));
    }
    if (!rc)
      rc = run(kTrim, zp_zstd_trim(b(ZR_B_ROWS), n_out, off, int(F), d[ZR_TOTAL], b(ZR_B_STATE),
                                   a(ZR_A_REC), int(d[ZR_REC_WORDS]), b(ZR_B_OUT), st));
    if (!rc)
      rc = int(cudaMemcpyAsync(back, b(ZR_B_OUT), d[ZR_BACK_BYTES], cudaMemcpyDeviceToHost, st));
    return rc;
  }
};

}  // namespace

// The parts `parts` (zr::Part bits) of the read laid out in `layout`
// (ZR_SLOTS words), in the order A, restitch, B, on `stream`.  `pinned`:
// the packed upload (part A); `arena`: ZR_A_BYTES of device memory;
// `part_b`: ZR_B_BYTES of it; `offsets_host`: the frames' offsets in pinned
// memory where they are not in the upload (else null); `back`: pinned
// memory for the record alone (part A without part B) or for the record
// and the output (part B).  Writes the code of each kernel launched to
// `launched` (at most 9) and their count to `n_launched`.  Returns the
// first CUDA error; the parts stop there.
extern "C" int zp_zstd_chain(const long long* layout, int parts, const void* pinned, void* arena,
                             void* part_b, const void* offsets_host, void* back, int* launched,
                             int* n_launched, void* stream) {
  Chain c{layout, static_cast<uint8_t*>(arena), static_cast<uint8_t*>(part_b),
          static_cast<cudaStream_t>(stream), launched, 0};
  int rc = 0;
  if (parts & zr::kPartA) rc = c.part_a(pinned, parts & zr::kPartB ? nullptr : back);
  if (!rc && (parts & zr::kPartRestitch)) rc = c.restitch();
  if (!rc && (parts & zr::kPartB)) rc = c.part_b_run(offsets_host, back);
  *n_launched = c.n;
  return rc;
}
