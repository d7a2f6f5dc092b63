// XXH3-64 pieces shared by xxh3_batch.cu and xxh3_stream.cu.
//
// The constants are the xxHash specification's, as zpack_tpu/codecs/xxh3.py
// holds them; the 192-byte secret itself comes in as a device tensor made
// from codecs.xxh3.KSECRET.  All arithmetic is native uint64_t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zp_xxh3 {

constexpr int kSecretSize = 192;
constexpr int kSecretWords = kSecretSize / 8;
constexpr int kStripeLen = 64;
constexpr int kStripesPerBlock = 16;
constexpr int kBlockLen = kStripeLen * kStripesPerBlock;  // 1 KiB
constexpr int kMidsizeMax = 240;                          // longer inputs take the long path
constexpr int kLanes = 8;                                 // u64 accumulator lanes
constexpr int kScrambleWord = (kSecretSize - kStripeLen) / 8;
constexpr int kSecretLastAccStart = 7;
constexpr int kSecretMergeAccsStart = 11;

constexpr uint64_t kPrime32_1 = 0x9E3779B1ULL;
constexpr uint64_t kPrime64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kPrimeMx1 = 0x165667919E3779F9ULL;

// The initial accumulator of lane i (XXH3_INIT_ACC).
__device__ __forceinline__ uint64_t init_acc(int lane) {
  const uint64_t v[kLanes] = {0xC2B2AE3DULL,          0x9E3779B185EBCA87ULL,
                              0xC2B2AE3D27D4EB4FULL,  0x165667B19E3779F9ULL,
                              0x85EBCA77C2B2AE63ULL,  0x85EBCA77ULL,
                              0x27D4EB2F165667C5ULL,  0x9E3779B1ULL};
  return v[lane];
}

// Little-endian u64 at any byte address.
__device__ __forceinline__ uint64_t read64(const uint8_t* p) {
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v |= uint64_t(p[k]) << (8 * k);
  return v;
}

// One stripe's contribution to lane `lane`: lo32(k) * hi32(k), k = data ^
// secret, plus the pair-swapped data word (the neighbour lane's data, never
// its accumulator).
__device__ __forceinline__ uint64_t stripe_term(uint64_t d, uint64_t dswap, uint64_t key_secret) {
  const uint64_t k = d ^ key_secret;
  return (k & 0xFFFFFFFFULL) * (k >> 32) + dswap;
}

__device__ __forceinline__ uint64_t scramble(uint64_t acc, uint64_t tail) {
  acc ^= acc >> 47;
  acc ^= tail;
  return acc * kPrime32_1;
}

__device__ __forceinline__ uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  return (a * b) ^ __umul64hi(a, b);
}

__device__ __forceinline__ uint64_t avalanche3(uint64_t h) {
  h ^= h >> 37;
  h *= kPrimeMx1;
  return h ^ (h >> 32);
}

// The last-stripe step and the merge, for the eight threads of one stream
// (named in `mask`, lanes 0-7 in order of lane id).  `acc` is this lane's
// accumulator after the whole stripes, `d` this lane's word of the stream's
// last 64 bytes.  Lane 0 (every even lane) returns the stream's XXH3-64.
__device__ __forceinline__ uint64_t finish(uint64_t acc, uint64_t d, const uint8_t* secret,
                                           int lane, int64_t len, unsigned mask) {
  const uint64_t dswap = __shfl_xor_sync(mask, d, 1);
  acc += stripe_term(
      d, dswap, read64(secret + kSecretSize - kStripeLen - kSecretLastAccStart + 8 * lane));
  // merge: lanes 2j and 2j+1, each xor'ed with its secret word, fold into one
  const uint64_t x = acc ^ read64(secret + kSecretMergeAccsStart + 8 * lane);
  const uint64_t y = __shfl_xor_sync(mask, x, 1);
  uint64_t f = (lane & 1) ? 0 : mul128_fold64(x, y);
  f += __shfl_xor_sync(mask, f, 2);
  f += __shfl_xor_sync(mask, f, 4);
  return avalanche3(uint64_t(len) * kPrime64_1 + f);
}

}  // namespace zp_xxh3
