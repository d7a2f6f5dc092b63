// zstd FSE sequence-section encode for Hopper (sm_90a): one warp per block.
//
// Replaces zpack_tpu/kernels/fse_jax.py:encode_seq_streams (with
// _init_state; driven by DeviceSequenceEncoder), the sequence stage of the
// zstd compress path.  The contract is the bits of
// codecs/zstd/seq.py:encode_sequences followed by BackwardBitWriter.finish(),
// stated in plain PyTorch by
// zpack_tpu_torch/kernels/fse_torch.py:encode_seq_streams_plain.
//
// The three FSE state machines (LL, OF, ML) are sequential within a block
// and independent across blocks.  The TPU design walks every block's chains
// in lockstep in a lax.scan (one fused table gather per step), then
// scatter-adds every bit field into a u32 plane, because a TPU has no cheap
// scalar loop.  Here one warp owns one block: it loads the block's three
// tables (3 x 640 int32, 7.5 KB) into shared memory, stages the block's
// sequence rows into shared memory 256 at a time with coalesced loads, and
// lane 0 walks the chain, appending each field to a 64-bit accumulator and
// storing whole u32 words in order.  Nothing is scattered and no word is
// written twice.
//
// What bounds it: the chain.  Each step is three dependent shared-memory
// table reads (the three machines interleave) plus about a dozen bit-field
// appends on one thread, and a 64 KiB block holds some thousands of
// sequences; all blocks run at once, one warp each, so the longest block
// sets the time.  The staging hides the global-memory latency of the
// sequence rows behind 256 steps.  The output sizes come from the host's
// upper bound (every state write at its accuracy log); a word past the
// block's range is never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 512;             // max FSE table size (accuracy log 9)
constexpr int kSym = 64;                // code alphabets padded to 64
constexpr int kRow = kTable + 2 * kSym;  // state table | delta_nb_bits | delta_find_state
constexpr int kStage = 256;             // sequence rows staged per refill

// extra-bit counts per literal-length and match-length code (RFC 8878
// §3.1.1.3.2.1.1), zero past the alphabets; an offset code's count is the
// code itself
__constant__ uint8_t kLLBits[kSym] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ uint8_t kMLBits[kSym] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct BitWriter {
  uint32_t* out;
  int64_t n_words;
  int64_t w = 0;       // next word to store
  uint64_t acc = 0;    // pending bits, LSB first
  int nacc = 0;        // pending bit count, < 32 between calls
  int64_t bits = 0;    // bits appended so far

  __device__ void add(uint32_t v, int nb) {
    nb = min(max(nb, 0), 32);
    acc |= (uint64_t(v) & ((1ull << nb) - 1)) << nacc;
    nacc += nb;
    bits += nb;
    if (nacc >= 32) {
      if (w < n_words) out[w] = uint32_t(acc);
      ++w;
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ void finish() {
    add(1, 1);  // the closing sentinel bit
    if (nacc > 0 && w < n_words) out[w] = uint32_t(acc);
  }
};

struct Machine {
  const int* st;   // state table, kTable entries
  const int* dnb;  // delta_nb_bits per symbol
  const int* dfs;  // delta_find_state per symbol
  int state;

  // fse.EncodeTable.init_state
  __device__ void init(int sym) {
    const int d = dnb[sym];
    const int nb = (d + (1 << 15)) >> 16;
    const int val = (nb << 16) - d;
    state = st[((val >> nb) + dfs[sym]) & (kTable - 1)];
  }
  // fse.EncodeTable.encode: the state's low bits out, then the next state
  __device__ void encode(BitWriter& bw, int sym) {
    const int nb = (state + dnb[sym]) >> 16;
    bw.add(uint32_t(state), nb);
    state = st[((state >> nb) + dfs[sym]) & (kTable - 1)];
  }
};

__global__ void __launch_bounds__(32)
fse_encode_kernel(const int4* __restrict__ fields, const int64_t* __restrict__ seq_off,
                  const int* __restrict__ tables, const int* __restrict__ al,
                  const int64_t* __restrict__ word_off, uint32_t* __restrict__ words,
                  int* __restrict__ total_bits) {
  __shared__ int tab[3 * kRow];
  __shared__ int4 rows[kStage];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int* src = tables + int64_t(b) * 3 * kRow;
  for (int i = lane; i < 3 * kRow; i += 32) tab[i] = src[i];

  const int64_t s0 = seq_off[b];
  const int64_t n = seq_off[b + 1] - s0;
  const int4* f = fields + s0;
  Machine ll{tab, tab + kTable, tab + kTable + kSym, 0};
  Machine of{tab + kRow, tab + kRow + kTable, tab + kRow + kTable + kSym, 0};
  Machine ml{tab + 2 * kRow, tab + 2 * kRow + kTable, tab + 2 * kRow + kTable + kSym, 0};
  const int64_t base = word_off[b];
  BitWriter bw{words + base, word_off[b + 1] - base};

  for (int64_t k0 = 0; k0 < n; k0 += kStage) {
    const int m = int(min(int64_t(kStage), n - k0));
    __syncwarp();
    for (int i = lane; i < m; i += 32) rows[i] = f[k0 + i];
    __syncwarp();
    if (lane != 0) continue;
    for (int i = 0; i < m; ++i) {
      const int4 r = rows[i];
      const int llc = r.x & (kSym - 1), mlc = (r.x >> 8) & (kSym - 1);
      const int ofc = (r.x >> 16) & (kSym - 1);
      if (k0 + i == 0) {
        // the last sequence: states start on its codes and write no bits
        ll.init(llc);
        of.init(ofc);
        ml.init(mlc);
      } else {
        of.encode(bw, ofc);
        ml.encode(bw, mlc);
        ll.encode(bw, llc);
      }
      bw.add(uint32_t(r.y), kLLBits[llc]);
      bw.add(uint32_t(r.z), kMLBits[mlc]);
      bw.add(uint32_t(r.w), ofc);
    }
  }
  if (lane != 0) return;
  if (n > 0) {
    bw.add(uint32_t(ml.state), al[3 * b + 2]);
    bw.add(uint32_t(of.state), al[3 * b + 1]);
    bw.add(uint32_t(ll.state), al[3 * b]);
  }
  total_bits[b] = int(bw.bits);
  if (n > 0) bw.finish();
}

}  // namespace

// fields (total, 4) i32 (codes, ll, ml and of extra values), in reversed
// sequence order per block; seq_off (B + 1) i64; tables (B, 3, 640) i32
// (ll, of, ml); al (B, 3) i32; word_off (B + 1) i64; words: the zeroed u32
// plane; total_bits (B,) i32.  Returns cudaGetLastError().
extern "C" int zp_fse_encode(const void* fields, const void* seq_off, const void* tables,
                             const void* al, const void* word_off, int B, void* words,
                             void* total_bits, void* stream) {
  fse_encode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(fields), static_cast<const int64_t*>(seq_off),
      static_cast<const int*>(tables), static_cast<const int*>(al),
      static_cast<const int64_t*>(word_off), static_cast<uint32_t*>(words),
      static_cast<int*>(total_bits));
  return int(cudaGetLastError());
}
