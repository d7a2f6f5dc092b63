// XXH3-64 of one long stream for Hopper (sm_90a): block sums, then the chain.
//
// Replaces zpack_tpu/kernels/xxh3_jax.py:_accumulate (the lax.scan over
// 1 KiB blocks, driven by xxh3_64_jax).  The contract is stated in plain
// PyTorch by zpack_tpu_torch/kernels/xxh3_torch.py: accumulate_stream_plain
// (the accumulator after the whole stripes, what _accumulate returns) and
// finish_plain (the last stripe, the merge and the avalanche).
//
// The JAX version carries every u64 as a (hi, lo) pair of u32 built from
// 16-bit limbs; here the arithmetic is native uint64_t.  Its shape stays:
// within a 1 KiB block the 16 stripe terms of a lane are a plain sum, but the
// scramble acc = ((acc ^ acc >> 47) ^ tail) * PRIME32_1 after each block is
// the specification's sequential dependency.  It is not associative, so no
// scan shortcut exists.  Two launches, in one C entry point:
//
//   1. block_sums_kernel, over the whole card: eight threads per block, one
//      per lane, write C_b[i] = sum over stripes (lo32(k) * hi32(k) +
//      data[i^1]) mod 2^64 into a scratch the wrapper allocates (8 x 8 bytes
//      per KiB of input: 4 MiB for 64 MiB);
//   2. chain_kernel, one warp with eight lanes active, walks acc =
//      scramble(acc + C_b) over the blocks in order, loading C_b a batch
//      ahead, then adds the stripes of the last partial block, applies the
//      last stripe and merges.
//
// What bounds it: the chain.  A 64 MiB stream is 65,536 dependent steps of
// an add, a shift, two xors and a 64 x 32-bit multiply, each waiting on the
// last, so milliseconds, not microseconds.  The block sums read each byte
// once (and its neighbour word again from L1), a few tens of microseconds
// at 64 MiB.

#include "xxh3_common.cuh"

namespace {

using namespace zp_xxh3;

constexpr int kSumThreads = 256;
constexpr int kBlocksPerCta = kSumThreads / kLanes;
constexpr int kAhead = 32;  // C_b loaded per batch of the chain, one batch ahead

__global__ void __launch_bounds__(kSumThreads)
block_sums_kernel(const uint8_t* __restrict__ data, int64_t nblocks,
                  const uint64_t* __restrict__ secret, uint64_t* __restrict__ sums) {
  __shared__ uint64_t sec[kSecretWords];
  if (threadIdx.x < kSecretWords) sec[threadIdx.x] = secret[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int64_t b = int64_t(blockIdx.x) * kBlocksPerCta + threadIdx.x / kLanes;
  if (b >= nblocks) return;
  const uint64_t* words = reinterpret_cast<const uint64_t*>(data + b * kBlockLen);
  uint64_t sum = 0;
#pragma unroll
  for (int j = 0; j < kStripesPerBlock; ++j)
    sum += stripe_term(words[j * kLanes + lane], words[j * kLanes + (lane ^ 1)], sec[j + lane]);
  sums[b * kLanes + lane] = sum;
}

__global__ void __launch_bounds__(kLanes)
chain_kernel(const uint8_t* __restrict__ data, int64_t len, const uint64_t* __restrict__ secret,
             const uint64_t* __restrict__ sums, int64_t nblocks, uint64_t* __restrict__ acc_out,
             uint64_t* __restrict__ hash_out) {
  __shared__ uint64_t sec[kSecretWords];
  for (int k = threadIdx.x; k < kSecretWords; k += kLanes) sec[k] = secret[k];
  __syncthreads();
  const int lane = threadIdx.x;
  const uint64_t tail = sec[kScrambleWord + lane];

  uint64_t acc = init_acc(lane);
  uint64_t cur[kAhead], next[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) cur[k] = k < nblocks ? sums[k * kLanes + lane] : 0;
  for (int64_t b = 0; b < nblocks; b += kAhead) {
    // the next batch's loads are in flight while this batch's steps run
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      next[k] = b + kAhead + k < nblocks ? sums[(b + kAhead + k) * kLanes + lane] : 0;
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (b + k < nblocks) acc = scramble(acc + cur[k], tail);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = next[k];
  }

  // the stripes of the last partial block, then the last stripe and the merge
  const int64_t nstripes = (len - 1) / kStripeLen;
  const int rem = int(nstripes - nblocks * kStripesPerBlock);
  const uint64_t* words = reinterpret_cast<const uint64_t*>(data + nblocks * kBlockLen);
  for (int j = 0; j < rem; ++j)
    acc += stripe_term(words[j * kLanes + lane], words[j * kLanes + (lane ^ 1)], sec[j + lane]);
  acc_out[lane] = acc;
  const uint64_t d = read64(data + len - kStripeLen + 8 * lane);
  const uint64_t h = finish(acc, d, reinterpret_cast<const uint8_t*>(sec), lane, len, 0xFFu);
  if (lane == 0) hash_out[0] = h;
}

}  // namespace

// data (len,) u8, 8-aligned, len > 240; secret (192,) u8, 8-aligned; sums
// scratch (max(nblocks, 1), 8) u64 with nblocks = (len - 1) / 64 / 16;
// acc_out (8,) and hash_out (1,) u64.  Returns cudaGetLastError().
extern "C" int zp_xxh3_stream(const void* data, long long len, const void* secret, void* sums,
                              void* acc_out, void* hash_out, void* stream) {
  const int64_t nblocks = (len - 1) / kStripeLen / kStripesPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const uint64_t* sec = static_cast<const uint64_t*>(secret);
  uint64_t* c = static_cast<uint64_t*>(sums);
  if (nblocks > 0) {
    const int64_t grid = (nblocks + kBlocksPerCta - 1) / kBlocksPerCta;
    block_sums_kernel<<<unsigned(grid), kSumThreads, 0, st>>>(d, nblocks, sec, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  chain_kernel<<<1, kLanes, 0, st>>>(d, len, sec, c, nblocks, static_cast<uint64_t*>(acc_out),
                                     static_cast<uint64_t*>(hash_out));
  return int(cudaGetLastError());
}
