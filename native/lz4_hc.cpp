// zpack-tpu: LZ4 block sections from the device match finder's wire
// arrays in the HC parse, on the host: the CPU route of the PyTorch port's
// DeviceCompressor at LZ4's high-compression levels (3 and up), and the
// host's statement of csrc/lz4_serialize.cu's HC parse.
//
// The contract is zpack_tpu_torch/kernels/lz4_torch.py:serialize_plain
// with parse "hc", bit for bit.  For each block of true length cl, from
// p = 1 below cl - 12: a candidate (j, m) is rejected where m < 4, j < 0,
// j >= p or p - j > 65535, or where its forward length F, m clipped to
// cl - 5 and extended while bytes agree, is under 4.  An accepted q with
// F(q) < kLazyCap is emitted as a literal where F(q + 1) > F(q) or
// F(q + 2) > F(q) + 1 (F is 0 at a rejected position); any other accepted
// q takes its match, which ends at q + F(q) and extends backward down to
// the previous sequence's end.  A block whose compressed bytes would be cl
// or more is stored raw.  Each block's section is a 4-byte LE size (the
// high bit for a raw block) and the payload; blocks run in parallel.
//
// The greedy parse is native/zpack_native.cpp:zn_lz4_serialize_blocks_pair
// and _u16, which the JAX package calls too and which this file leaves as
// they are.  Compiled only into the PyTorch port's library
// (zpack_tpu_torch/native.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "zn_threads.h"

namespace {

constexpr size_t kMinMatch = 4;
constexpr size_t kMfLimit = 12;
constexpr size_t kLastLits = 5;
// kernels/lz4_torch.py:HC_LAZY_CAP, the kernel's kMinMatch + kScanExtend
constexpr size_t kLazyCap = 36;

uint8_t* write_lsic(uint8_t* op, size_t v) {
    while (v >= 255) {
        *op++ = 255;
        v -= 255;
    }
    *op++ = static_cast<uint8_t>(v);
    return op;
}

struct Pair {
    const uint16_t* src;
    const uint8_t* code;
    void operator()(size_t i, int32_t* j, int32_t* m) const {
        const int32_t c = code[i];
        *m = c ? c + 3 : 0;
        *j = c ? static_cast<int32_t>(src[i]) : -1;
    }
};

struct U16 {
    const uint16_t* tok;
    void operator()(size_t i, int32_t* j, int32_t* m) const {
        const uint16_t t = tok[i];
        const int32_t c = t & 7;
        *m = c ? c + 3 : 0;
        *j = c ? static_cast<int32_t>(t >> 3) : -1;
    }
};

// One block's section into ob; false where the host serializer's output
// bound is passed.
template <class Fetch>
bool block_hc(const uint8_t* d, size_t cl, size_t row, const Fetch& fetch,
              std::vector<uint8_t>& ob) {
    ob.resize(4 + cl + cl / 255 + 16);
    uint8_t* op = ob.data() + 4;
    uint8_t* const oend = ob.data() + ob.size();
    const size_t limit = cl > kLastLits ? cl - kLastLits : 0;
    const size_t mflim = cl > kMfLimit ? cl - kMfLimit : 0;
    // F(p) and its source, 0 where p is rejected
    auto forward = [&](size_t p, int32_t* src) -> size_t {
        if (p < 1 || p >= mflim) return 0;
        int32_t m, j;
        fetch(row + p, &j, &m);
        if (m < static_cast<int32_t>(kMinMatch) || j < 0 || static_cast<size_t>(j) >= p ||
            p - static_cast<size_t>(j) > 65535)
            return 0;
        size_t e = static_cast<size_t>(m);
        if (p + e > limit) e = limit - p;
        while (p + e < limit && d[p + e] == d[static_cast<size_t>(j) + e]) e++;
        *src = j;
        return e >= kMinMatch ? e : 0;
    };
    size_t lit = 0;
    for (size_t p = 1; p < mflim;) {
        int32_t j = 0, unused;
        const size_t f = forward(p, &j);
        if (f == 0 || (f < kLazyCap && (forward(p + 1, &unused) > f ||
                                        forward(p + 2, &unused) > f + 1))) {
            p++;
            continue;
        }
        size_t pp = p, jj = static_cast<size_t>(j);
        while (pp > lit && jj > 0 && d[pp - 1] == d[jj - 1]) {
            pp--;
            jj--;
        }
        const size_t ll = pp - lit, ml = f + p - pp;
        if (op + 1 + ll / 255 + 1 + ll + 2 + ml / 255 + 1 > oend) return false;
        const size_t mlc = ml - kMinMatch;
        *op++ = static_cast<uint8_t>(((ll < 15 ? ll : 15) << 4) | (mlc < 15 ? mlc : 15));
        if (ll >= 15) op = write_lsic(op, ll - 15);
        memcpy(op, d + lit, ll);
        op += ll;
        const size_t off = pp - jj;
        *op++ = static_cast<uint8_t>(off);
        *op++ = static_cast<uint8_t>(off >> 8);
        if (mlc >= 15) op = write_lsic(op, mlc - 15);
        p += f;
        lit = p;
    }
    const size_t ll = cl - lit;
    if (op + 1 + ll / 255 + 1 + ll > oend) return false;
    *op++ = static_cast<uint8_t>((ll < 15 ? ll : 15) << 4);
    if (ll >= 15) op = write_lsic(op, ll - 15);
    memcpy(op, d + lit, ll);
    op += ll;
    const size_t csz = static_cast<size_t>(op - (ob.data() + 4));
    uint32_t hdr;
    if (csz >= cl) {
        ob.resize(4 + cl);
        hdr = static_cast<uint32_t>(cl) | 0x80000000u;
        memcpy(ob.data() + 4, d, cl);
    } else {
        ob.resize(4 + csz);
        hdr = static_cast<uint32_t>(csz);
    }
    memcpy(ob.data(), &hdr, 4);
    return true;
}

template <class Fetch>
size_t serialize_hc(const uint8_t* data, size_t n, size_t bsz, size_t nb, uint8_t* dst,
                    size_t cap, const Fetch& fetch) {
    if (nb == 0 || bsz == 0 || n == 0) return 0;
    std::vector<std::vector<uint8_t>> outs(nb);
    std::atomic<bool> bad{false};
    zn_parallel_for(nb, zn_nthreads(), [&](size_t i) {
        const size_t off0 = i * bsz;
        if (off0 >= n) return;
        const size_t cl = n - off0 < bsz ? n - off0 : bsz;
        if (!block_hc(data + off0, cl, off0, fetch, outs[i])) bad.store(true);
    });
    if (bad.load()) return static_cast<size_t>(-1);
    size_t total = 0;
    for (auto& ob : outs) total += ob.size();
    if (total > cap) return static_cast<size_t>(-1);
    uint8_t* op = dst;
    for (auto& ob : outs) {
        memcpy(op, ob.data(), ob.size());
        op += ob.size();
    }
    return total;
}

}  // namespace

extern "C" {

// The sections of the nb = ceil(n / bsz) blocks of data in the HC parse,
// from the wire arrays of the match finder in mode 0 "pair" (t0 (nb, bsz)
// u16 src, t1 (nb, bsz) u8 code = mlen - 3) or 1 "u16" (t0 (nb, bsz) u16
// src << 3 | code, t1 unused).  Returns the bytes written to dst, or
// (size_t)-1 for an unknown mode, a block past the output bound, or cap
// too small.
size_t zn_lz4_serialize_blocks_hc(const uint8_t* data, size_t n, size_t bsz, int mode,
                                  const void* t0, const void* t1, size_t nb, uint8_t* dst,
                                  size_t cap) {
    if (mode == 0)
        return serialize_hc(data, n, bsz, nb, dst, cap,
                            Pair{static_cast<const uint16_t*>(t0),
                                 static_cast<const uint8_t*>(t1)});
    if (mode == 1)
        return serialize_hc(data, n, bsz, nb, dst, cap, U16{static_cast<const uint16_t*>(t0)});
    return static_cast<size_t>(-1);
}

}  // extern "C"
