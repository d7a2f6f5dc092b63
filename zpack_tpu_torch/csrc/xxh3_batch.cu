// XXH3-64 of many streams for Hopper (sm_90a): eight threads per stream.
//
// Replaces zpack_tpu/kernels/xxh3_pallas.py:_kernel (driven by _run and
// xxh3_64_batch).  The contract is stated in plain PyTorch by
// zpack_tpu_torch/kernels/xxh3_torch.py: accumulate_batch_plain (each
// stream's accumulator after its whole stripes, what _run returns) and
// finish_plain (the last stripe, the merge and the avalanche).
//
// The TPU kernel lays up to 128 streams across its lanes, zero-padded into
// (blocks, 256, 128) u32 tiles, and builds every 64-bit product from 16-bit
// limbs, because a TPU lane holds one stream and has no 64-bit integers.
// Here each stream is read where it lies in one flat buffer, a launch takes
// any number of streams, and the arithmetic is native uint64_t:
// lo32(k) * hi32(k) is one 64-bit product and the 64x64 -> 128 fold of the
// merge takes __umul64hi.
//
// Thread i of a stream's eight owns accumulator lane i; a CTA of 256 threads
// holds 32 streams.  Through accumulate and scramble the lanes are
// independent: the pair swap reads the neighbour lane's data word, never its
// accumulator, so thread i loads words i and i^1 of each 64-byte stripe and
// the eight threads read one contiguous 64-byte segment.  Only the merge
// crosses lanes, with three shuffles inside the group of eight.
//
// What bounds it: bytes read.  Every data byte comes once from device memory
// and once more from L1 (the neighbour's word for the swap).  Streams of very
// different lengths in one warp leave the threads of the short ones idle
// until the longest is done.  Sorting streams by length, or one warp per
// long stream, is later work.

#include "xxh3_common.cuh"

namespace {

using namespace zp_xxh3;

constexpr int kThreads = 256;
constexpr int kStreamsPerCta = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
xxh3_batch_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                  const int64_t* __restrict__ rows, int n, const uint64_t* __restrict__ secret,
                  uint64_t* __restrict__ acc_out, uint64_t* __restrict__ hash_out) {
  __shared__ uint64_t sec[kSecretWords];
  if (threadIdx.x < kSecretWords) sec[threadIdx.x] = secret[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int64_t s = int64_t(blockIdx.x) * kStreamsPerCta + threadIdx.x / kLanes;
  int64_t start = 0, len = 0;
  if (s < n) {
    start = rows[2 * s];
    len = rows[2 * s + 1];
  }
  // A row that does not start on 8 bytes, lies outside flat or belongs to
  // the short path reads nothing and yields zeros.  Every thread goes on to
  // the shuffles of the merge.
  const bool valid = s < n && len > kMidsizeMax && start >= 0 && (start & 7) == 0 &&
                     start <= flat_len - len;
  const int64_t nstripes = valid ? (len - 1) / kStripeLen : 0;
  const uint8_t* p = flat + (valid ? start : 0);
  const uint64_t* words = reinterpret_cast<const uint64_t*>(p);

  uint64_t key_secret[kStripesPerBlock];
#pragma unroll
  for (int j = 0; j < kStripesPerBlock; ++j) key_secret[j] = sec[j + lane];
  const uint64_t tail = sec[kScrambleWord + lane];

  uint64_t acc = init_acc(lane);
  const int64_t nblocks = nstripes / kStripesPerBlock;
  for (int64_t b = 0; b < nblocks; ++b) {
    const uint64_t* w = words + b * (kBlockLen / 8);
#pragma unroll
    for (int j = 0; j < kStripesPerBlock; ++j)
      acc += stripe_term(w[j * kLanes + lane], w[j * kLanes + (lane ^ 1)], key_secret[j]);
    acc = scramble(acc, tail);
  }
  const int rem = int(nstripes - nblocks * kStripesPerBlock);
  const uint64_t* w = words + nblocks * (kBlockLen / 8);
#pragma unroll
  for (int j = 0; j < kStripesPerBlock; ++j)
    if (j < rem) acc += stripe_term(w[j * kLanes + lane], w[j * kLanes + (lane ^ 1)], key_secret[j]);

  if (s < n) acc_out[s * kLanes + lane] = valid ? acc : 0;
  // the last 64 bytes start wherever the length puts them: byte loads
  const uint64_t d = valid ? read64(p + len - kStripeLen + 8 * lane) : 0;
  const uint64_t h = finish(acc, d, reinterpret_cast<const uint8_t*>(sec), lane, len, 0xFFFFFFFFu);
  if (s < n && lane == 0) hash_out[s] = valid ? h : 0;
}

}  // namespace

// flat (flat_len,) u8, 8-aligned; rows (n, 2) i64 of (start, length);
// secret (192,) u8, 8-aligned; acc_out (n, 8) and hash_out (n,) u64.
// Returns cudaGetLastError().
extern "C" int zp_xxh3_batch(const void* flat, long long flat_len, const void* rows, int n,
                             const void* secret, void* acc_out, void* hash_out, void* stream) {
  const int grid = (n + kStreamsPerCta - 1) / kStreamsPerCta;
  xxh3_batch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), flat_len, static_cast<const int64_t*>(rows), n,
      static_cast<const uint64_t*>(secret), static_cast<uint64_t*>(acc_out),
      static_cast<uint64_t*>(hash_out));
  return int(cudaGetLastError());
}
