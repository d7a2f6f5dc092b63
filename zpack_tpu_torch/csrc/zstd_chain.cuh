// The layout of one zstd read on the card, shared by its two native halves:
// native/zstd_read.cpp computes it on the host (sizes, the packed upload, the
// offset of every device buffer) and csrc/zstd_chain.cu launches the read's
// kernels from it.  Plain C++: the host compiler and nvcc both include it.
//
// A read's plan goes in as ZP_SLOTS int64 words (counts, then addresses of
// the plan's arrays); its layout comes out as ZR_SLOTS int64 words.  The
// upload packs the host arrays the kernels read, each at a multiple of
// kAlign bytes; it lands at the start of the arena (one device buffer), and
// every scratch and output buffer of part A follows it in the arena.  Part
// B (the replay, the trim and the read-back) has its own offsets, from the
// start of a second region: right after part A where every frame declares
// its size, a buffer of its own where the sizes come from the card.
// kernels/zstd_chain.py lists the same slot names in the same order
// (tests/test_torch_zstd_chain.py holds the two lists and the constants
// below to each other).
#pragma once

#include <stdint.h>

namespace zr {

constexpr int64_t kAlign = 256;               // parallel/extract.py STAGE_ALIGN
constexpr int64_t kRecWords = 16;             // assemble_torch.REC_WORDS
constexpr int64_t kNone = 2147483647;         // assemble_torch.NONE
constexpr int64_t kMaxBlock = 128 << 10;      // assemble_torch.MAX_BLOCK
constexpr int64_t kReplayState = 40;          // lz4_torch.REPLAY_STATE
constexpr int64_t kReplayTile = 1024;         // lz4_torch.REPLAY_TILE
constexpr int64_t kHufStageCap = 16 << 10;    // huffman_torch.STAGE_CAP
constexpr int64_t kHufMaxRow = 1 << 26;       // huffman_torch.MAX_ROW_BYTES
constexpr int64_t kFseStageCap = 128 << 10;   // fse_torch.STAGE_CAP
constexpr int64_t kFseMaxSeqs = 1 << 23;      // fse_torch.decode_seq_streams' limits
constexpr int64_t kFseMaxRow = 1 << 26;

// What zr_layout and zr_replay_layout refuse, as the Python wrappers do
// (each wrapper raises ValueError before its launch).
enum Refusal : int {
  kAccepted = 0,
  kHuffmanRowTooWide = 1,   // huffman_torch.stage_size
  kFseTooLong = 2,          // fse_torch.decode_seq_streams
  kReplayTooLong = 3,       // lz4_torch.replay_enqueue
};

// The parts of zp_zstd_chain.
enum Part : int {
  kPartA = 1,         // upload, decoders, stitch, repeat offsets, layout
  kPartRestitch = 2,  // the stitch again, every declared size -1
  kPartB = 4,         // replay, trim, read-back
};

}  // namespace zr

// The plan, as the caller hands it in: counts, then the arrays' addresses
// (0 for an array of no element).
enum ZpSlot : int {
  ZP_F,            // frames
  ZP_NB,           // blocks
  ZP_S,            // Huffman streams
  ZP_T,            // Huffman tables
  ZP_B,            // blocks with sequences (FSE items)
  ZP_R,            // raw and RLE literal runs
  ZP_LB,           // a frame's literal row, bytes
  ZP_N,            // source bytes
  ZP_FRAME_SIZE,   // (F,) int64, declared size or -1
  ZP_BLOCKS,       // (NB, 3) int64: frame, literal bytes, item or -1
  ZP_HUF_ROWS,     // (S, 7) int64
  ZP_HUF_TABLES,   // (T, 2048) int32
  ZP_FSE_ROWS,     // (B, 3) int64
  ZP_SEQ_OFF,      // (B + 1,) int64
  ZP_FSE_AL,       // (B, 3) int32
  ZP_FSE_TABLES,   // (B, 3, 512) int32
  ZP_RUNS,         // (R, 4) int64
  ZP_SOURCE,       // (N,) uint8
  ZP_SLOTS
};

// The layout.  Offsets are bytes; -1 where the array is absent.
enum ZrSlot : int {
  // what _decode_python computes in numpy
  ZR_F, ZR_NB, ZR_S, ZR_T, ZR_B, ZR_R, ZR_LB, ZR_N,
  ZR_SEQS,         // seq_off[-1]
  ZR_MAX_OUT,      // the output bound, -1 for none
  ZR_EXACT,        // 1: no usable declared sizes (the exact path)
  ZR_SB,           // the segment table's width
  ZR_CAP,          // the longest frame the replay may take (kNone on the exact path)
  ZR_HUF_STAGE,    // huffman_torch.stage_size(widest)
  ZR_FSE_WIDEST,   // decode_shape: the longest row's bytes
  ZR_FSE_LONGEST,  // decode_shape: the most sequences of a block
  ZR_REC_WORDS,    // kRecWords + 2 F
  // part B, from the sizes
  ZR_TOTAL, ZR_N_OUT, ZR_FSTRIDE, ZR_TILES,
  // the upload (the pinned buffer's head; the arena's head once sent)
  ZR_UP_BLK, ZR_UP_FIRST, ZR_UP_SEQ_OFF, ZR_UP_RUNS, ZR_UP_DECLARED, ZR_UP_OFFSETS,
  ZR_UP_SOURCE, ZR_UP_HUF_ROWS, ZR_UP_HUF_TABLES, ZR_UP_FSE_ROWS, ZR_UP_FSE_AL,
  ZR_UP_FSE_TABLES, ZR_UP_BYTES,
  // part A's buffers in the arena, after the upload; ZR_A_BYTES is the
  // arena's bytes through part A, the upload included
  ZR_A_LITS, ZR_A_FINAL, ZR_A_LLS, ZR_A_MLS, ZR_A_OVS, ZR_A_FREC, ZR_A_POS_F, ZR_A_FERR,
  ZR_A_SEL, ZR_A_VAL, ZR_A_SUMS, ZR_A_REC, ZR_A_ENTRY, ZR_A_BASES, ZR_A_FRAME_OUT, ZR_A_OFFS,
  ZR_A_REP_ERR, ZR_A_SEG, ZR_A_BYTES,
  // part B's buffers, from the start of its region
  ZR_B_OFFSETS, ZR_B_ROWS, ZR_B_F, ZR_B_LIVE, ZR_B_STATE, ZR_B_OUT, ZR_B_BYTES,
  // the pinned host buffer: the upload, then the read-back (the record
  // alone on the exact path's first call); after zr_replay_layout, part B's
  // own: the frames' offsets, then the read-back
  ZR_BACK_BYTES, ZR_PIN_BACK, ZR_PIN_BYTES,
  ZR_SLOTS
};
