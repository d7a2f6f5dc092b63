// zpack-tpu: the host half of one zstd read on the card.
//
// From the plan of an entry (parallel/extract.py:ZstdPlan, as either walk
// fills it) this computes what the read's Python enqueue computes in numpy
// (parallel/extract.py:_decode_python): each frame's first block, the
// declared sizes or the exact path, the frames' offsets, the segment
// table's width, the decoders' shapes and stage sizes, the replay's row
// length, stride and tiles; then the byte offset of every array of the
// read's one upload and of every device buffer the kernels write, as one
// int64 layout (zpack_tpu_torch/csrc/zstd_chain.cuh).  zr_pack writes the
// upload into a caller-given pinned buffer, one memcpy an array; the
// card's half (csrc/zstd_chain.cu) launches the kernels from the layout.
//
// Compiled only into the PyTorch port's library (zpack_tpu_torch/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "../zpack_tpu_torch/csrc/zstd_chain.cuh"

namespace {

inline int64_t aligned(int64_t n) { return (n + zr::kAlign - 1) / zr::kAlign * zr::kAlign; }

// Buffers placed back to back, each at a multiple of kAlign bytes; an
// absent one (n < 0) gets -1 and takes no room.
struct Region {
    int64_t end = 0;
    int64_t take(int64_t n) {
        if (n < 0) return -1;
        const int64_t at = end;
        end += aligned(n);
        return at;
    }
};

template <typename T>
const T* arr(const int64_t* p, int slot) { return reinterpret_cast<const T*>(p[slot]); }

// Part B's slots from each frame's output size: the replay's row length,
// stride and tiles, its buffers, and part B's pinned buffer (the offsets,
// then the read-back).
int replay_layout(int64_t* d, const int64_t* sizes) {
    const int64_t F = d[ZR_F];
    int64_t total = 0, n_out = 0;
    for (int64_t j = 0; j < F; ++j) {
        total += sizes[j];
        n_out = std::max(n_out, sizes[j]);
    }
    const int64_t fstride = (n_out + 3) / 4 * 4;
    const int64_t tiles = F * ((fstride + zr::kReplayTile - 1) / zr::kReplayTile);
    if (n_out && (tiles >= (int64_t(1) << 31) || fstride >= (int64_t(1) << 31)))
        return zr::kReplayTooLong;
    d[ZR_TOTAL] = total;
    d[ZR_N_OUT] = n_out;
    d[ZR_FSTRIDE] = fstride;
    d[ZR_TILES] = n_out ? tiles : 0;
    const bool replay = n_out > 0;
    Region b;
    d[ZR_B_OFFSETS] = b.take(8 * (F + 1));
    d[ZR_B_ROWS] = b.take(replay ? F * n_out : -1);
    d[ZR_B_F] = b.take(replay ? 4 * F * fstride : -1);
    d[ZR_B_LIVE] = b.take(replay ? 4 * tiles : -1);
    d[ZR_B_STATE] = b.take(replay ? 4 * zr::kReplayState : -1);
    d[ZR_B_OUT] = b.take(4 * d[ZR_REC_WORDS] + total);
    d[ZR_B_BYTES] = b.end;
    d[ZR_BACK_BYTES] = 4 * d[ZR_REC_WORDS] + total;
    d[ZR_PIN_BACK] = aligned(8 * (F + 1));
    d[ZR_PIN_BYTES] = d[ZR_PIN_BACK] + d[ZR_BACK_BYTES];
    return zr::kAccepted;
}

}  // namespace

extern "C" {

// The layout of a read of the plan `p` (ZP_SLOTS words) with the output
// bound `max_out` (-1 for none) into `d` (ZR_SLOTS words).  Returns a
// zr::Refusal: nonzero where a decoder or the replay cannot take the plan,
// checked in the order the Python wrappers check it.
int zr_layout(const int64_t* p, int64_t max_out, int64_t* d) {
    const int64_t F = p[ZP_F], NB = p[ZP_NB], S = p[ZP_S], T = p[ZP_T], B = p[ZP_B],
                  R = p[ZP_R], LB = p[ZP_LB], N = p[ZP_N];
    const int64_t* frame_size = arr<int64_t>(p, ZP_FRAME_SIZE);
    const int64_t* blk = arr<int64_t>(p, ZP_BLOCKS);
    const int64_t* seq_off = arr<int64_t>(p, ZP_SEQ_OFF);
    std::fill(d, d + ZR_SLOTS, 0);
    d[ZR_F] = F, d[ZR_NB] = NB, d[ZR_S] = S, d[ZR_T] = T, d[ZR_B] = B, d[ZR_R] = R;
    d[ZR_LB] = LB, d[ZR_N] = N, d[ZR_MAX_OUT] = max_out;
    d[ZR_SEQS] = B ? seq_off[B] : 0;
    d[ZR_REC_WORDS] = zr::kRecWords + 2 * F;

    // the declared sizes where every frame declares one its blocks can hold
    // (extract.predicted_sizes), and the segment table's width
    std::vector<int64_t> room(F, 0), segs(F, 0);
    for (int64_t i = 0; i < NB; ++i) {
        const int64_t j = blk[3 * i], slot = blk[3 * i + 2];
        room[j] += slot < 0 ? blk[3 * i + 1] : zr::kMaxBlock;
        segs[j] += 1 + (slot < 0 ? 0 : seq_off[slot + 1] - seq_off[slot]);
    }
    bool exact = F == 0;
    int64_t declared = 0, cap = 0, sb = 1;
    for (int64_t j = 0; j < F; ++j) {
        exact |= frame_size[j] < 0 || frame_size[j] > room[j];
        sb = std::max(sb, segs[j]);
    }
    if (!exact) {
        for (int64_t j = 0; j < F; ++j) {
            declared += frame_size[j];
            cap = std::max(cap, frame_size[j]);
        }
        exact = max_out >= 0 && declared > max_out;
    }
    d[ZR_EXACT] = exact;
    d[ZR_SB] = sb;
    d[ZR_CAP] = exact ? zr::kNone : cap;

    if (S) {  // huffman_torch.stage_size of the longest row
        int64_t widest = 0;
        const int64_t* rows = arr<int64_t>(p, ZP_HUF_ROWS);
        for (int64_t s = 0; s < S; ++s) widest = std::max(widest, rows[7 * s + 1]);
        if (widest >= zr::kHufMaxRow) return zr::kHuffmanRowTooWide;
        d[ZR_HUF_STAGE] = std::min(widest, zr::kHufStageCap);
    }
    if (B) {  // fse_torch.decode_shape and its limits
        int64_t widest = 0, longest = 0;
        const int64_t* rows = arr<int64_t>(p, ZP_FSE_ROWS);
        for (int64_t b = 0; b < B; ++b) {
            widest = std::max(widest, rows[3 * b + 1]);
            longest = std::max(longest, seq_off[b + 1] - seq_off[b]);
        }
        if (longest >= zr::kFseMaxSeqs || widest >= zr::kFseMaxRow) return zr::kFseTooLong;
        d[ZR_FSE_WIDEST] = widest;
        d[ZR_FSE_LONGEST] = longest;
    }

    // the upload, in the order of extract.stage's arrays
    Region up;
    d[ZR_UP_BLK] = up.take(24 * NB);
    d[ZR_UP_FIRST] = up.take(8 * (F + 1));
    d[ZR_UP_SEQ_OFF] = up.take(8 * (B + 1));
    d[ZR_UP_RUNS] = up.take(32 * R);
    d[ZR_UP_DECLARED] = up.take(8 * F);
    d[ZR_UP_OFFSETS] = up.take(exact ? -1 : 8 * (F + 1));
    d[ZR_UP_SOURCE] = up.take(N);
    d[ZR_UP_HUF_ROWS] = up.take(S ? 56 * S : -1);
    d[ZR_UP_HUF_TABLES] = up.take(S ? 4 * 2048 * T : -1);
    d[ZR_UP_FSE_ROWS] = up.take(B ? 24 * B : -1);
    d[ZR_UP_FSE_AL] = up.take(B ? 12 * B : -1);
    d[ZR_UP_FSE_TABLES] = up.take(B ? 4 * 3 * 512 * B : -1);
    d[ZR_UP_BYTES] = up.end;

    // part A's buffers follow the upload in the arena
    Region a{up.end};
    const int64_t seqs = d[ZR_SEQS];
    auto seq = [B](int64_t n) { return B ? n : -1; };  // absent without sequences
    d[ZR_A_LITS] = a.take(F * LB);
    d[ZR_A_FINAL] = a.take(4 * S);
    d[ZR_A_LLS] = a.take(seq(4 * seqs));
    d[ZR_A_MLS] = a.take(seq(4 * seqs));
    d[ZR_A_OVS] = a.take(seq(4 * seqs));
    d[ZR_A_FREC] = a.take(seq(8 * seqs));
    d[ZR_A_POS_F] = a.take(seq(4 * B));
    d[ZR_A_FERR] = a.take(seq(B));
    d[ZR_A_SEL] = a.take(seq(12 * B));
    d[ZR_A_VAL] = a.take(seq(12 * B));
    d[ZR_A_SUMS] = a.take(seq(16 * B));
    d[ZR_A_REC] = a.take(4 * d[ZR_REC_WORDS]);
    d[ZR_A_ENTRY] = a.take(seq(12 * B));
    d[ZR_A_BASES] = a.take(24 * (NB + 1));
    d[ZR_A_FRAME_OUT] = a.take(8 * F);
    d[ZR_A_OFFS] = a.take(seq(4 * seqs));
    d[ZR_A_REP_ERR] = a.take(seq(B));
    d[ZR_A_SEG] = a.take(16 * F * sb);
    d[ZR_A_BYTES] = a.end;

    if (exact) {  // the record comes back alone first; part B waits for the sizes
        d[ZR_BACK_BYTES] = 4 * d[ZR_REC_WORDS];
    } else {
        const int rc = replay_layout(d, frame_size);
        if (rc) return rc;
    }
    d[ZR_PIN_BACK] = up.end;
    d[ZR_PIN_BYTES] = std::max<int64_t>(up.end + d[ZR_BACK_BYTES], 1);
    return zr::kAccepted;
}

// Part B's slots from each frame's computed size (`sizes`, F words), for
// the exact path and for a read whose declared size the card found wrong;
// part B's pinned buffer then holds the frames' offsets, then the
// read-back.  Returns a zr::Refusal.
int zr_replay_layout(int64_t* d, const int64_t* sizes) { return replay_layout(d, sizes); }

// The upload of the plan `p` under the layout `d` into `dst` (ZR_UP_BYTES
// bytes): the host arrays, and each frame's first block, declared size
// (-1 on the exact path) and output offset, each at its offset.
void zr_pack(const int64_t* p, const int64_t* d, uint8_t* dst) {
    const int64_t F = d[ZR_F], NB = d[ZR_NB], S = d[ZR_S], B = d[ZR_B];
    auto put = [&](int slot, int src, int64_t bytes) {
        if (bytes > 0) memcpy(dst + d[slot], reinterpret_cast<const void*>(p[src]), bytes);
    };
    put(ZR_UP_BLK, ZP_BLOCKS, 24 * NB);
    const int64_t* blk = arr<int64_t>(p, ZP_BLOCKS);
    int64_t* first = reinterpret_cast<int64_t*>(dst + d[ZR_UP_FIRST]);
    for (int64_t j = 0, i = 0; j <= F; ++j) {  // numpy.searchsorted(blk[:, 0], j)
        while (i < NB && blk[3 * i] < j) ++i;
        first[j] = i;
    }
    if (B) {
        put(ZR_UP_SEQ_OFF, ZP_SEQ_OFF, 8 * (B + 1));
    } else {
        *reinterpret_cast<int64_t*>(dst + d[ZR_UP_SEQ_OFF]) = 0;
    }
    put(ZR_UP_RUNS, ZP_RUNS, 32 * d[ZR_R]);
    const int64_t* frame_size = arr<int64_t>(p, ZP_FRAME_SIZE);
    int64_t* declared = reinterpret_cast<int64_t*>(dst + d[ZR_UP_DECLARED]);
    for (int64_t j = 0; j < F; ++j) declared[j] = d[ZR_EXACT] ? -1 : frame_size[j];
    if (!d[ZR_EXACT]) {
        int64_t* off = reinterpret_cast<int64_t*>(dst + d[ZR_UP_OFFSETS]);
        off[0] = 0;
        for (int64_t j = 0; j < F; ++j) off[j + 1] = off[j] + frame_size[j];
    }
    put(ZR_UP_SOURCE, ZP_SOURCE, d[ZR_N]);
    if (S) {
        put(ZR_UP_HUF_ROWS, ZP_HUF_ROWS, 56 * S);
        put(ZR_UP_HUF_TABLES, ZP_HUF_TABLES, 4 * 2048 * d[ZR_T]);
    }
    if (B) {
        put(ZR_UP_FSE_ROWS, ZP_FSE_ROWS, 24 * B);
        put(ZR_UP_FSE_AL, ZP_FSE_AL, 12 * B);
        put(ZR_UP_FSE_TABLES, ZP_FSE_TABLES, 4 * 3 * 512 * B);
    }
}

}  // extern "C"
