// zstd FSE sequence-section decode for Hopper (sm_90a): one warp per block.
//
// Replaces zpack_tpu/kernels/fse_jax.py:decode_seq_streams (driven by
// DeviceSequenceDecoder), the sequence stage of the zstd extract path.  The
// contract is codecs/zstd/seq.py:decode_sequences with the offset codes
// capped at 30, stated in plain PyTorch by
// zpack_tpu_torch/kernels/fse_torch.py:decode_seq_streams_plain.
//
// The three FSE state machines (LL, OF, ML) of a block read one backward
// bitstream in turn, so a block is one chain; blocks are independent.  The
// TPU design walks every block's chain in lockstep in a lax.scan, about
// eleven (B,)-wide gathers a step.  Here one warp owns one block: its lanes
// copy the block's three decode tables (3 x 512 int32, 6 KB) into shared
// memory, and lane 0 walks the chain, keeping a 64-bit window of the
// stream's bits in a register (refilled with eight byte loads when a read
// reaches below it) and writing each sequence's literal length, match
// length and raw offset value to its place in the flat outputs.
//
// What bounds it: the longest block's chain, three shared-memory table
// reads side by side (one per machine) plus three bit reads a step; all
// blocks run at once.  Reads below bit 0 give zeros, as the
// scan's zero padding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 512;  // max FSE table size (accuracy log 9)

// baselines and extra-bit counts per literal-length and match-length code
// (RFC 8878 §3.1.1.3.2.1.1)
__constant__ int kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
    1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16};

__device__ __forceinline__ int64_t floor_div8(int64_t x) { return x >= 0 ? x / 8 : -((7 - x) / 8); }

// A backward bitstream of nbytes bytes, read through a 64-bit window.  Every
// read lies below the previous one, so the window only moves down.
struct BackReader {
  const uint8_t* src;
  int64_t nbytes;
  int64_t base = INT64_MAX;  // the window holds bits [base, base + 64); none yet
  uint64_t bits = 0;

  // bits [pos, pos + n) of the stream, n in 0..32, zero outside its bytes
  __device__ uint32_t read(int64_t pos, int n) {
    if (n <= 0) return 0;
    if (pos < base) {
      base = floor_div8(pos + n - 57) * 8;  // base <= pos, base + 64 >= pos + n
      bits = 0;
      const int64_t b0 = base / 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t b = b0 + j;
        if (b >= 0 && b < nbytes) bits |= uint64_t(src[b]) << (8 * j);
      }
    }
    return uint32_t((bits >> (pos - base)) & ((1ull << n) - 1));
  }
};

__global__ void __launch_bounds__(32)
fse_decode_kernel(const uint8_t* __restrict__ payload, int64_t payload_len,
                  const int64_t* __restrict__ rows, const int64_t* __restrict__ seq_off,
                  const int* __restrict__ al, const int* __restrict__ tables,
                  int* __restrict__ lls, int* __restrict__ mls, int* __restrict__ ovs,
                  int* __restrict__ pos_f, bool* __restrict__ err_out) {
  __shared__ int tab[3 * kTable];
  const int b = blockIdx.x;
  const int* src_tab = tables + int64_t(b) * 3 * kTable;
  for (int i = threadIdx.x; i < 3 * kTable; i += 32) tab[i] = src_tab[i];
  __syncwarp();
  if (threadIdx.x != 0) return;

  const int64_t start = rows[3 * b], nbytes = rows[3 * b + 1];
  int64_t pos = rows[3 * b + 2];
  const int64_t s0 = seq_off[b], n = seq_off[b + 1] - s0;
  if (start < 0 || nbytes < 0 || start + nbytes > payload_len) {
    pos_f[b] = -1;
    err_out[b] = true;
    return;
  }
  BackReader rd{payload + start, nbytes};
  const int* tll = tab;
  const int* tof = tab + kTable;
  const int* tml = tab + 2 * kTable;
  // initial states: LL, OF, ML
  pos -= al[3 * b];
  int ll_s = int(rd.read(pos, al[3 * b]));
  pos -= al[3 * b + 1];
  int of_s = int(rd.read(pos, al[3 * b + 1]));
  pos -= al[3 * b + 2];
  int ml_s = int(rd.read(pos, al[3 * b + 2]));
  bool err = false;
  for (int64_t i = 0; i < n; ++i) {
    const int ofe = tof[of_s & (kTable - 1)];
    const int mle = tml[ml_s & (kTable - 1)];
    const int lle = tll[ll_s & (kTable - 1)];
    // values: the offset's extra bits, then ML and LL in one read
    int ofc = ofe & 0x3F;
    if (ofc > 30) {
      err = true;
      ofc = 30;
    }
    pos -= ofc;
    const uint32_t ofx = rd.read(pos, ofc);
    const int ov = ofc > 0 ? int((1u << ofc) + ofx) : 1;
    const int mlc = min(mle & 0x3F, 52), llc = min(lle & 0x3F, 35);
    const int mlb = kMLBits[mlc], llb = kLLBits[llc];
    pos -= mlb + llb;
    const uint32_t w = rd.read(pos, mlb + llb);
    lls[s0 + i] = kLLBase[llc] + int(w & ((1u << llb) - 1));
    mls[s0 + i] = kMLBase[mlc] + int(w >> llb);
    ovs[s0 + i] = ov;
    // state updates, LL, ML, OF, but after the last sequence
    if (i + 1 < n) {
      const int lln = (lle >> 6) & 0x3FF, mln = (mle >> 6) & 0x3FF, ofn = (ofe >> 6) & 0x3FF;
      pos -= lln + mln + ofn;
      uint32_t wu = rd.read(pos, lln + mln + ofn);
      of_s = (ofe >> 16) + int(wu & ((1u << ofn) - 1));
      wu >>= ofn;
      ml_s = (mle >> 16) + int(wu & ((1u << mln) - 1));
      ll_s = (lle >> 16) + int(wu >> mln);
    }
  }
  pos_f[b] = int(pos);
  err_out[b] = err;
}

}  // namespace

// payload: flat u8 of payload_len bytes; rows (B, 3) i64 (byte_start,
// n_bytes, bits_left0); seq_off (B + 1) i64; al (B, 3) i32 and tables
// (B, 3, 512) i32, both (ll, of, ml); lls, mls, ovs (seq_off[B],) i32;
// pos_f (B,) i32; err (B,) bool.  Returns cudaGetLastError().
extern "C" int zp_fse_decode(const void* payload, long long payload_len, const void* rows,
                             const void* seq_off, const void* al, const void* tables, int B,
                             void* lls, void* mls, void* ovs, void* pos_f, void* err,
                             void* stream) {
  fse_decode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_len, static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(seq_off), static_cast<const int*>(al),
      static_cast<const int*>(tables), static_cast<int*>(lls), static_cast<int*>(mls),
      static_cast<int*>(ovs), static_cast<int*>(pos_f), static_cast<bool*>(err));
  return int(cudaGetLastError());
}
