// XXH3-64 of many streams for Hopper (sm_90a): a CTA a stream, its block
// sums by seven warps, its chain by eight lanes of the eighth.
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
// A stream's work splits in two, as xxh3_stream.cu splits one long stream:
// the 1 KiB block sums C_b[i] (the 16 stripe terms of accumulator lane i,
// summed mod 2^64) commute, so any thread may compute any of them; only
// acc = scramble(acc + C_b), block after block, is a chain.  So one CTA of
// 256 threads takes one row:
//
//   * warps 1 to 7, 28 groups of eight threads (thread i of a group owns
//     lane i), compute the sums of the next chunk of 28 blocks into a
//     shared ring of two chunks.  Each thread loads its own word of each
//     stripe; the pair-swapped word is its neighbour's, one shuffle away.
//   * lanes 0 to 7 of warp 0 walk the chain over the chunk before, from
//     shared memory, while the next chunk loads.  One __syncthreads a chunk
//     hands the ring over.
//
// While the chain lanes walk the last chunk, the first producer group sums
// the stripes of the last partial block and reads the last 64 bytes (at any
// alignment, byte loads), so the chain lanes read nothing from device
// memory; they finish with shuffles that name lanes 0 to 7 alone.
//
// One CTA a row spreads 128 rows of 512 KiB over 128 SMs, where eight
// threads a row put them on 4, and a short row no longer waits in a warp
// for a long one.  The host sizes nothing from the rows, which it does not
// read back: the grid is the row count.  A rejected row (not 8-aligned,
// 240 bytes or shorter, outside flat, or a negative start) reads nothing
// and yields zeros.
//
// What bounds it: bytes read, each once from device memory.  A row's chain
// (about 20 cycles a KiB) hides under its loads; a batch of a few long
// rows occupies a few SMs (8 rows of 8 MiB: 8), each at one SM's share of
// the memory rate.

#include "xxh3_common.cuh"

namespace {

using namespace zp_xxh3;

constexpr int kThreads = 256;
constexpr int kChunk = (kThreads - 32) / kLanes;  // producer groups (warps 1 to 7), a block each

__global__ void __launch_bounds__(kThreads)
xxh3_batch_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                  const int64_t* __restrict__ rows, const uint64_t* __restrict__ secret,
                  uint64_t* __restrict__ acc_out, uint64_t* __restrict__ hash_out) {
  __shared__ uint64_t sec[kSecretWords];
  __shared__ uint64_t ring[2][kChunk][kLanes];
  __shared__ uint64_t part[kLanes], last[kLanes];  // the partial block's sums, the last stripe
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kLanes;
  const int64_t start = rows[2 * s], len = rows[2 * s + 1];
  if (!(len > kMidsizeMax && start >= 0 && (start & 7) == 0 && start <= flat_len - len)) {
    if (tid < kLanes) acc_out[s * kLanes + tid] = 0;
    if (tid == 0) hash_out[s] = 0;
    return;  // the whole CTA: nothing else of the row is read
  }
  if (tid < kSecretWords) sec[tid] = secret[tid];
  const uint8_t* p = flat + start;
  const uint64_t* words = reinterpret_cast<const uint64_t*>(p);
  const int64_t nstripes = (len - 1) / kStripeLen;
  const int64_t nblocks = nstripes / kStripesPerBlock;
  const int64_t nchunks = (nblocks + kChunk - 1) / kChunk;
  __syncthreads();

  // one loop for all threads, so that every thread meets every barrier:
  // at step c the producers sum chunk c and the chain lanes walk chunk c - 1
  const int g = (tid - 32) / kLanes;  // producer group (warps 1 to 7)
  uint64_t acc = init_acc(lane);
  const uint64_t tail = sec[kScrambleWord + lane];
  for (int64_t c = 0; c <= nchunks; ++c) {
    if (tid >= 32 && c < nchunks) {
      const int64_t b = c * kChunk + g;
      const bool live = b < nblocks;
      const uint64_t* w = words + (live ? b : 0) * (kBlockLen / 8);
      uint64_t d[kStripesPerBlock];
#pragma unroll
      for (int j = 0; j < kStripesPerBlock; ++j) d[j] = live ? w[j * kLanes + lane] : 0;
      uint64_t sum = 0;
#pragma unroll
      for (int j = 0; j < kStripesPerBlock; ++j)  // every lane of the warp shuffles
        sum += stripe_term(d[j], __shfl_xor_sync(0xFFFFFFFFu, d[j], 1), sec[j + lane]);
      if (live) ring[c & 1][g][lane] = sum;
    } else if (tid >= 32 && g == 0) {  // the last step: the partial block, the last stripe
      const int rem = int(nstripes - nblocks * kStripesPerBlock);
      const uint64_t* w = words + nblocks * (kBlockLen / 8);
      uint64_t sum = 0;
      for (int j = 0; j < rem; ++j)
        sum += stripe_term(w[j * kLanes + lane], w[j * kLanes + (lane ^ 1)], sec[j + lane]);
      part[lane] = sum;
      last[lane] = read64(p + len - kStripeLen + 8 * lane);
    } else if (tid < kLanes && c > 0) {  // the chunk the producers finished last
      const uint64_t(*slot)[kLanes] = ring[(c - 1) & 1];
      const int m = int(min(int64_t(kChunk), nblocks - (c - 1) * kChunk));
#pragma unroll 4
      for (int k = 0; k < m; ++k) acc = scramble(acc + slot[k][lane], tail);
    }
    __syncthreads();
  }
  if (tid >= kLanes) return;
  acc += part[lane];
  acc_out[s * kLanes + lane] = acc;
  const uint64_t h = finish(acc, last[lane], reinterpret_cast<const uint8_t*>(sec), lane, len,
                            0xFFu);
  if (lane == 0) hash_out[s] = h;
}

}  // namespace

// flat (flat_len,) u8, 8-aligned; rows (n, 2) i64 of (start, length);
// secret (192,) u8, 8-aligned; acc_out (n, 8) and hash_out (n,) u64.
// Launches one CTA a row.  Returns cudaGetLastError().
extern "C" int zp_xxh3_batch(const void* flat, long long flat_len, const void* rows, int n,
                             const void* secret, void* acc_out, void* hash_out, void* stream) {
  xxh3_batch_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), flat_len, static_cast<const int64_t*>(rows),
      static_cast<const uint64_t*>(secret), static_cast<uint64_t*>(acc_out),
      static_cast<uint64_t*>(hash_out));
  return int(cudaGetLastError());
}

// out (3,) i32: the grid, the threads a CTA and the CTAs an SM holds, for a
// batch of n rows.  Returns the occupancy query's error.
extern "C" int zp_xxh3_batch_shape(int n, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = n;
  o[1] = kThreads;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[2], xxh3_batch_kernel, kThreads, 0));
}
