// zpack-tpu native zstd walk for the device decoders (RFC 8878).
//
// Reads every frame, block, literals-section and sequences-section header
// of concatenated zstd frames and builds each Huffman and FSE decode table
// once, emitting the flat batches that the device decoders take
// (zpack_tpu_torch/kernels/huffman_torch.py:build_decode_batch and
// fse_torch.py:build_decode_batch), without decoding an entropy stream.
//
// It is the native form of zpack_tpu_torch/parallel/extract.py:walk_zstd
// and follows its checks: whatever that walk, or the two batch builders
// after it, would reject is rejected here too (a nonzero return), and the
// caller then runs the Python walk for its error message.  Where both
// accept, the batches are the same, array for array (payload offsets point
// into the entry rather than into a copy of its streams).
//
// Two passes an entry: zw_literals (frames, blocks, literals sections,
// Huffman tables, the literal layout), then zw_sequences (sequences
// sections and FSE tables, from the blocks pass 1 found).  Compiled only
// into the PyTorch port's library (zpack_tpu_torch/native.py).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <new>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkipMin = 0x184D2A50u;
constexpr uint32_t kSkipMax = 0x184D2A5Fu;
constexpr int kMaxWindowLog = 31;
constexpr int kHufRow = 2048;      // huffman_torch.DTABLE
constexpr int kHufMaxBits = 11;
constexpr int kFseRow = 512;       // fse_torch.TABLE
constexpr int kBlockCols = 6;      // frame, offset, size, lits_end, literals, type
constexpr int kStreamCols = 7;     // huffman_torch.DECODE_COLS
constexpr int kRunCols = 4;        // length, destination, source in the entry, step

inline uint32_t le32(const uint8_t* p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}
inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ---------------------------------------------------------------------------
// bit readers (codecs/zstd/bits.py)
// ---------------------------------------------------------------------------

// LSB-first forward reader; bits at or past `size` read as zero.
struct FwdBits {
    const uint8_t* data;
    size_t size;
    uint64_t bitpos;

    uint32_t peek(int nbits) const {
        if (nbits == 0) return 0;
        uint64_t byte = bitpos >> 3;
        uint64_t w = 0;
        if (byte + 8 <= size) {
            memcpy(&w, data + byte, 8);
        } else {
            for (uint64_t i = 0; i < 8 && byte + i < size; i++)
                w |= (uint64_t)data[byte + i] << (8 * i);
        }
        return (uint32_t)((w >> (bitpos & 7)) & ((1u << nbits) - 1));
    }
    void skip(int nbits) { bitpos += nbits; }
    uint64_t byte_pos() const { return (bitpos + 7) >> 3; }
};

// Backward reader from the sentinel bit; reads below bit 0 give zeros.
struct BackBits {
    const uint8_t* data = nullptr;
    size_t size = 0;
    long long bits_left = 0;

    bool init(const uint8_t* d, size_t n) {
        if (n == 0 || d[n - 1] == 0) return false;
        data = d;
        size = n;
        bits_left = (long long)(n - 1) * 8 + highbit(d[n - 1]);
        return true;
    }
    uint64_t word_at(size_t start) const {
        uint64_t w = 0;
        if (start + 8 <= size) {
            memcpy(&w, data + start, 8);
            return w;
        }
        for (size_t i = 0; i < 8 && start + i < size; i++) w |= (uint64_t)data[start + i] << (8 * i);
        return w;
    }
    uint32_t read(int nbits) {
        if (nbits == 0) return 0;
        bits_left -= nbits;
        long long pos = bits_left;
        if (pos >= 0)
            return (uint32_t)((word_at((size_t)(pos >> 3)) >> (pos & 7)) & ((1ull << nbits) - 1));
        long long avail = nbits + pos;
        if (avail <= 0) return 0;
        return (uint32_t)((word_at(0) & ((1ull << avail) - 1)) << (-pos));
    }
};

// ---------------------------------------------------------------------------
// FSE (codecs/zstd/fse.py)
// ---------------------------------------------------------------------------

struct Fse {
    int al = 0;
    uint16_t sym[kFseRow];
    uint8_t nb[kFseRow];
    uint16_t ns[kFseRow];
};

// An FSE table description at byte `offset` of [data, data + size): its
// counts (-1 for "less than 1") and accuracy log.  Returns the bytes it
// takes, which may pass `size` (zeros are read there), or -1.
long long read_ncount(const uint8_t* data, size_t size, size_t offset, int max_symbol,
                      int max_al, std::vector<int>& counts, int& al_out) {
    FwdBits br{data, size, (uint64_t)offset * 8};
    int al = (int)br.peek(4) + 5;
    br.skip(4);
    if (al > max_al) return -1;
    int remaining = (1 << al) + 1;
    int threshold = 1 << al;
    int nbits = al + 1;
    counts.clear();
    bool previous0 = false;
    while (remaining > 1) {
        if ((int)counts.size() > max_symbol) return -1;
        if (previous0) {
            while (br.peek(2) == 3) {
                br.skip(2);
                counts.insert(counts.end(), 3, 0);
                if ((int)counts.size() > max_symbol + 1) return -1;
            }
            uint32_t n0 = br.peek(2);
            br.skip(2);
            counts.insert(counts.end(), n0, 0);
            if ((int)counts.size() > max_symbol + 1) return -1;
        }
        int maxv = (2 * threshold - 1) - remaining;
        int val = (int)br.peek(nbits);
        if ((val & (threshold - 1)) < maxv) {
            val &= threshold - 1;
            br.skip(nbits - 1);
        } else {
            br.skip(nbits);
            if (val >= threshold) val -= maxv;
        }
        int count = val - 1;
        remaining -= count < 0 ? -count : count;
        counts.push_back(count);
        previous0 = count == 0;
        while (remaining < threshold && remaining > 1) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return -1;
    al_out = al;
    return (long long)(br.byte_pos() - offset);
}

bool build_fse(const std::vector<int>& counts, int al, Fse& t) {
    int size = 1 << al;
    t.al = al;
    int high = size - 1;
    for (size_t s = 0; s < counts.size(); s++)
        if (counts[s] == -1) t.sym[high--] = (uint16_t)s;
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (size_t s = 0; s < counts.size(); s++) {
        for (int c = 0; c < counts[s]; c++) {
            if (high < 0) return false;
            t.sym[pos] = (uint16_t)s;
            pos = (pos + step) & mask;
            while (pos > high) pos = (pos + step) & mask;
        }
    }
    if (pos != 0) return false;
    int next[258];
    for (size_t s = 0; s < counts.size(); s++) next[s] = counts[s] == -1 ? 1 : counts[s];
    for (int u = 0; u < size; u++) {
        int x = next[t.sym[u]]++;
        int nbits = al - highbit((uint64_t)x);
        t.nb[u] = (uint8_t)nbits;
        t.ns[u] = (uint16_t)((x << nbits) - size);
    }
    return true;
}

// fse_torch.pack_decode_table: sym | nb_bits << 6 | new_state << 16, zeros
// past the table
void pack_fse(const Fse& t, int32_t* row) {
    int size = 1 << t.al;
    for (int u = 0; u < size; u++)
        row[u] = (int32_t)t.sym[u] | (int32_t)t.nb[u] << 6 | (int32_t)t.ns[u] << 16;
    memset(row + size, 0, sizeof(int32_t) * (kFseRow - size));
}

// ---------------------------------------------------------------------------
// Huffman (codecs/zstd/huffman.py)
// ---------------------------------------------------------------------------

// The tree description at the start of [data, data + size): every weight,
// the implied last one included.  Returns the bytes it takes, or -1.
long long read_huf_weights(const uint8_t* data, size_t size, std::vector<int>& counts,
                           std::vector<int>& weights) {
    if (size < 1) return -1;
    uint32_t header = data[0];
    weights.clear();
    long long consumed;
    if (header < 128) {
        size_t csize = header;
        if (size - 1 < csize) return -1;
        const uint8_t* p = data + 1;
        int al = 0;
        long long desc = read_ncount(p, csize, 0, 255, 6, counts, al);
        if (desc < 0) return -1;
        Fse t;
        if (!build_fse(counts, al, t)) return -1;
        if ((size_t)desc >= csize) return -1;  // an empty backward stream
        BackBits br;
        if (!br.init(p + desc, csize - (size_t)desc)) return -1;
        uint32_t even = br.read(al);
        uint32_t odd = br.read(al);
        bool ended = false;
        while (weights.size() <= 255) {
            weights.push_back(t.sym[even]);
            int bits = t.nb[even];
            if (br.bits_left < bits) {
                weights.push_back(t.sym[odd]);
                ended = true;
                break;
            }
            even = t.ns[even] + br.read(bits);
            weights.push_back(t.sym[odd]);
            bits = t.nb[odd];
            if (br.bits_left < bits) {
                weights.push_back(t.sym[even]);
                ended = true;
                break;
            }
            odd = t.ns[odd] + br.read(bits);
        }
        if (!ended) return -1;
        consumed = 1 + (long long)csize;
    } else {
        int n = (int)header - 127;
        size_t nbytes = (size_t)(n + 1) / 2;
        if (size - 1 < nbytes) return -1;
        for (int i = 0; i < n; i++) {
            uint8_t b = data[1 + i / 2];
            weights.push_back(i % 2 == 0 ? (b >> 4) : (b & 0xF));
        }
        consumed = 1 + (long long)nbytes;
    }
    // a weight above 11 makes a code longer than 11 bits; past 255 explicit
    // weights a symbol no longer fits a byte
    if (weights.size() > 255) return -1;
    uint64_t total = 0;
    for (int w : weights) {
        if (w > kHufMaxBits) return -1;
        if (w > 0) total += 1ull << (w - 1);
    }
    if (total == 0) return -1;
    uint64_t next_pow2 = 1ull << (highbit(total) + 1);
    uint64_t rest = next_pow2 - total;
    if (rest & (rest - 1)) return -1;
    weights.push_back(highbit(rest) + 1);
    if (highbit(next_pow2) > kHufMaxBits) return -1;
    return consumed;
}

// huffman.build_decode_table, packed as huffman_torch.build_decode_batch
// packs it: sym | nb_bits << 8 over the first 2^max_bits entries of a row
// of 2048, zeros after.  Returns max_bits.
int build_huf(const std::vector<int>& weights, int32_t* row) {
    uint64_t total = 0;
    for (int w : weights)
        if (w > 0) total += 1ull << (w - 1);
    int max_bits = highbit(total);
    int pos = 0;
    for (int w = 1; w <= max_bits; w++) {
        for (size_t s = 0; s < weights.size(); s++) {
            if (weights[s] != w) continue;
            int32_t e = (int32_t)s | (int32_t)(max_bits + 1 - w) << 8;
            for (int i = 0; i < 1 << (w - 1); i++) row[pos + i] = e;
            pos += 1 << (w - 1);
        }
    }
    memset(row + pos, 0, sizeof(int32_t) * (kHufRow - pos));
    return max_bits;
}

// ---------------------------------------------------------------------------
// sequences tables (codecs/zstd/seq.py)
// ---------------------------------------------------------------------------

const int kLLDist[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                         2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDist[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDist[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// The three kinds in the batch's order: ll, of, ml.
struct Kind {
    int max_code, max_al, shift;  // shift of its mode in the modes byte
    const int* dist;
    int n_dist, default_al;
};
const Kind kKinds[3] = {{35, 9, 6, kLLDist, 36, 6}, {31, 8, 4, kOFDist, 29, 5},
                        {52, 9, 2, kMLDist, 53, 6}};

struct Packed {
    int al = 0;
    int32_t row[kFseRow];
};

// The predefined tables, packed once a process.
const Packed* predefined() {
    static const Packed* tables = [] {
        static Packed p[3];
        for (int k = 0; k < 3; k++) {
            std::vector<int> c(kKinds[k].dist, kKinds[k].dist + kKinds[k].n_dist);
            Fse t;
            build_fse(c, kKinds[k].default_al, t);
            pack_fse(t, p[k].row);
            p[k].al = t.al;
        }
        return p;
    }();
    return tables;
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

struct Walk {
    const uint8_t* data = nullptr;
    size_t n = 0;
    // pass 1
    std::vector<int64_t> frame_chk;   // the content checksum, or -1
    std::vector<int64_t> frame_lits;  // the literal bytes of each frame
    std::vector<int64_t> frame_size;  // the declared content size, or -1
    std::vector<int64_t> blocks;      // kBlockCols a block
    std::vector<int64_t> streams;     // kStreamCols a Huffman stream
    std::vector<int64_t> stream_frame;
    std::vector<int32_t> huf;         // kHufRow a table
    std::vector<int64_t> runs;        // kRunCols a raw or RLE literal run
    std::vector<int64_t> run_frame;
    int64_t lit_row = 1;
    // pass 2
    std::vector<int64_t> rows;        // byte_start, n_bytes, bits_left0
    std::vector<int64_t> seq_off;
    std::vector<int32_t> al;          // 3 an item
    std::vector<int32_t> fse;         // 3 * kFseRow an item
    std::vector<int64_t> slots;       // an item's index, or -1, a block
    // scratch
    std::vector<int> counts, weights;
};

// A literal run of `len` bytes of the entry from `src`: raw (step 1) or
// one byte repeated (step 0).
void add_run(Walk& w, int64_t frame, int64_t& lp, size_t src, int64_t step, int64_t len) {
    if (len) {
        w.runs.insert(w.runs.end(), {len, lp, (int64_t)src, step});
        w.run_frame.push_back(frame);
    }
    lp += len;
}

// One literals section at the start of a compressed block (frame.py:
// parse_literals_section): its literal runs or Huffman streams, its table.
// Returns where the sequences section starts, or -1.
long long literals_section(Walk& w, size_t boff, size_t bsize, int64_t frame, int64_t& lp,
                           bool& have_table, int64_t& table, int& max_bits, int64_t& lit_total) {
    const uint8_t* block = w.data + boff;
    if (bsize < 1) return -1;
    uint32_t b0 = block[0];
    int ltype = b0 & 3, sf = (b0 >> 2) & 3;
    if (ltype < 2) {  // raw or RLE
        size_t rs, hdr;
        if (sf == 0 || sf == 2) {
            rs = b0 >> 3;
            hdr = 1;
        } else if (sf == 1) {
            if (bsize < 2) return -1;
            rs = (b0 >> 4) + ((size_t)block[1] << 4);
            hdr = 2;
        } else {
            if (bsize < 3) return -1;
            rs = (b0 >> 4) + ((size_t)block[1] << 4) + ((size_t)block[2] << 12);
            hdr = 3;
        }
        lit_total = (int64_t)rs;
        if (ltype == 0) {
            if (bsize - hdr < rs) return -1;
            add_run(w, frame, lp, boff + hdr, 1, (int64_t)rs);
            return (long long)(hdr + rs);
        }
        if (hdr >= bsize) return -1;
        add_run(w, frame, lp, boff + hdr, 0, (int64_t)rs);
        return (long long)(hdr + 1);
    }
    size_t rs, cs, hdr;
    int nstreams = sf == 0 ? 1 : 4;
    if (sf < 2) {
        if (bsize < 3) return -1;
        uint32_t b1 = block[1], b2 = block[2];
        rs = (b0 >> 4) + ((size_t)(b1 & 0x3F) << 4);
        cs = (b1 >> 6) + ((size_t)b2 << 2);
        hdr = 3;
    } else if (sf == 2) {
        if (bsize < 4) return -1;
        uint32_t b1 = block[1], b2 = block[2], b3 = block[3];
        rs = (b0 >> 4) + ((size_t)b1 << 4) + ((size_t)(b2 & 3) << 12);
        cs = (b2 >> 2) + ((size_t)b3 << 6);
        hdr = 4;
    } else {
        if (bsize < 5) return -1;
        uint32_t b1 = block[1], b2 = block[2], b3 = block[3], b4 = block[4];
        rs = (b0 >> 4) + ((size_t)b1 << 4) + ((size_t)(b2 & 0x3F) << 12);
        cs = (b2 >> 6) + ((size_t)b3 << 2) + ((size_t)b4 << 10);
        hdr = 5;
    }
    if (bsize - hdr < cs) return -1;
    const uint8_t* payload = block + hdr;
    size_t off = 0;
    if (ltype == 2) {
        long long used = read_huf_weights(payload, cs, w.counts, w.weights);
        if (used < 0) return -1;
        table = (int64_t)(w.huf.size() / kHufRow);
        w.huf.resize(w.huf.size() + kHufRow);
        max_bits = build_huf(w.weights, w.huf.data() + table * kHufRow);
        have_table = true;
        off = (size_t)used;
    }
    if (!have_table) return -1;
    size_t body = boff + hdr + off, blen = cs - off;
    size_t starts[4], lens[4];
    int64_t syms[4];
    if (nstreams == 1) {
        starts[0] = body;
        lens[0] = blen;
        syms[0] = (int64_t)rs;
    } else {
        if (blen < 6) return -1;
        const uint8_t* jt = w.data + body;
        size_t s1 = jt[0] | jt[1] << 8, s2 = jt[2] | jt[3] << 8, s3 = jt[4] | jt[5] << 8;
        size_t rest = blen - 6;
        if (s1 + s2 + s3 > rest) return -1;
        int64_t per = ((int64_t)rs + 3) / 4;
        if ((int64_t)rs - 3 * per < 0) return -1;
        size_t at = body + 6;
        const size_t part[4] = {s1, s2, s3, rest - s1 - s2 - s3};
        for (int k = 0; k < 4; k++) {
            starts[k] = at;
            lens[k] = part[k];
            syms[k] = k < 3 ? per : (int64_t)rs - 3 * per;
            at += part[k];
        }
    }
    for (int k = 0; k < nstreams; k++) {
        // huffman_torch.build_decode_batch needs each stream's sentinel bit
        if (lens[k] == 0 || w.data[starts[k] + lens[k] - 1] == 0) return -1;
        int64_t start_bit = (int64_t)(lens[k] - 1) * 8 + highbit(w.data[starts[k] + lens[k] - 1]);
        w.streams.insert(w.streams.end(), {(int64_t)starts[k], (int64_t)lens[k], start_bit,
                                           syms[k], lp, table, max_bits});
        w.stream_frame.push_back(frame);
        lp += syms[k];
    }
    lit_total = (int64_t)rs;
    return (long long)(hdr + cs);
}

// Pass 1 (extract.walk_zstd without the sequences, then _literal_layout).
bool walk_literals(Walk& w) {
    const uint8_t* d = w.data;
    size_t n = w.n, pos = 0;
    while (pos < n) {
        if (n - pos < 4) return false;
        uint32_t magic = le32(d + pos);
        if (magic >= kSkipMin && magic <= kSkipMax) {
            if (n - pos < 8) return false;
            pos += 8 + (size_t)le32(d + pos + 4);
            continue;
        }
        if (magic != kMagic) return false;
        pos += 4;
        // frame header (frame.parse_frame_header)
        if (pos >= n) return false;
        uint32_t fhd = d[pos++];
        int fcs_flag = fhd >> 6;
        bool single = fhd & 0x20;
        if (fhd & 0x08) return false;
        bool has_checksum = fhd & 0x04;
        if (!single) {
            if (pos >= n) return false;
            if ((int)(d[pos++] >> 3) + 10 > kMaxWindowLog) return false;
        }
        static const size_t kDid[4] = {0, 1, 2, 4};
        size_t did_len = kDid[fhd & 3];
        if (n - pos < did_len) return false;
        for (size_t i = 0; i < did_len; i++)
            if (d[pos + i]) return false;  // a dictionary frame
        pos += did_len;
        static const size_t kFcs[4] = {0, 2, 4, 8};
        size_t fcs_len = fcs_flag == 0 && single ? 1 : kFcs[fcs_flag];
        if (n - pos < fcs_len) return false;
        // the declared content size (frame.parse_frame_header), -1 where
        // the frame declares none or more than an int64 holds
        int64_t fcs = -1;
        if (fcs_len) {
            uint64_t v = 0;
            for (size_t i = 0; i < fcs_len; i++) v |= (uint64_t)d[pos + i] << (8 * i);
            if (fcs_len == 2) v += 256;
            fcs = v > (uint64_t)INT64_MAX ? -1 : (int64_t)v;
        }
        pos += fcs_len;
        // blocks
        int64_t frame = (int64_t)w.frame_chk.size();
        int64_t lp = 0;
        bool have_table = false;
        int64_t table = -1;
        int max_bits = 0;
        while (true) {
            if (n - pos < 3) return false;
            uint32_t bh = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16;
            pos += 3;
            bool last = bh & 1;
            int btype = (bh >> 1) & 3;
            size_t bsize = bh >> 3;
            if (btype == 1) {  // RLE
                if (n - pos < 1) return false;
                w.blocks.insert(w.blocks.end(), {frame, (int64_t)pos, 1, 0, (int64_t)bsize, 1});
                add_run(w, frame, lp, pos, 0, (int64_t)bsize);
                pos += 1;
            } else if (btype == 0) {  // raw
                if (n - pos < bsize) return false;
                w.blocks.insert(w.blocks.end(),
                                {frame, (int64_t)pos, (int64_t)bsize, 0, (int64_t)bsize, 0});
                add_run(w, frame, lp, pos, 1, (int64_t)bsize);
                pos += bsize;
            } else if (btype == 2) {
                if (n - pos < bsize) return false;
                int64_t lit_total = 0;
                long long lits_end = literals_section(w, pos, bsize, frame, lp, have_table, table,
                                                      max_bits, lit_total);
                if (lits_end < 0) return false;
                w.blocks.insert(w.blocks.end(), {frame, (int64_t)pos, (int64_t)bsize,
                                                 (int64_t)lits_end, lit_total, 2});
                pos += bsize;
            } else {
                return false;
            }
            if (last) break;
        }
        int64_t chk = -1;
        if (has_checksum) {
            if (n - pos < 4) return false;
            chk = le32(d + pos);
            pos += 4;
        }
        w.frame_chk.push_back(chk);
        w.frame_lits.push_back(lp);
        w.frame_size.push_back(fcs);
    }
    // the layout: frame j's literals fill row j of an (F, lit_row) table
    int64_t lb = 1;
    for (int64_t v : w.frame_lits) lb = v > lb ? v : lb;
    w.lit_row = lb;
    for (size_t s = 0; s < w.stream_frame.size(); s++)
        w.streams[s * kStreamCols + 4] += w.stream_frame[s] * lb;
    for (size_t r = 0; r < w.run_frame.size(); r++) w.runs[r * kRunCols + 1] += w.run_frame[r] * lb;
    return true;
}

// One table of a sequences section (seq._read_table) into `row`; `prev`
// is the frame's table of that kind for repeat mode.  Returns the new
// position, which may pass `size`, or -1.
long long read_seq_table(Walk& w, const uint8_t* block, size_t size, size_t pos, int mode,
                         const Kind& kind, int k, Packed& prev, bool& have_prev) {
    if (mode == 0) {
        prev = predefined()[k];
    } else if (mode == 1) {
        if (pos >= size) return -1;
        int sym = block[pos];
        if (sym > kind.max_code) return -1;
        prev.al = 0;
        prev.row[0] = sym;
        memset(prev.row + 1, 0, sizeof(int32_t) * (kFseRow - 1));
        pos += 1;
    } else if (mode == 2) {
        int al = 0;
        long long used = read_ncount(block, size, pos, kind.max_code, kind.max_al, w.counts, al);
        if (used < 0) return -1;
        Fse t;
        if (!build_fse(w.counts, al, t)) return -1;
        pack_fse(t, prev.row);
        prev.al = al;
        pos += (size_t)used;
    } else if (!have_prev) {
        return -1;
    }
    have_prev = true;
    return (long long)pos;
}

// Pass 2 (fse_torch.parse_headers for each compressed block, then
// fse_torch.build_decode_batch).
bool walk_sequences(Walk& w) {
    size_t nb = w.blocks.size() / kBlockCols;
    w.slots.assign(nb, -1);
    w.seq_off.assign(1, 0);
    Packed prev[3];
    bool have_prev[3] = {false, false, false};
    int64_t frame = -1;
    for (size_t b = 0; b < nb; b++) {
        const int64_t* blk = &w.blocks[b * kBlockCols];
        if (blk[0] != frame) {  // repeat mode starts afresh in each frame
            frame = blk[0];
            have_prev[0] = have_prev[1] = have_prev[2] = false;
        }
        if (blk[5] != 2) continue;
        const uint8_t* block = w.data + blk[1];
        size_t size = (size_t)blk[2], pos = (size_t)blk[3];
        // seq.parse_nb_sequences
        if (pos >= size) return false;
        uint32_t b0 = block[pos];
        int64_t nb_seq;
        if (b0 < 128) {
            nb_seq = b0;
            pos += 1;
        } else if (b0 < 255) {
            if (size - pos < 2) return false;
            nb_seq = ((int64_t)(b0 - 128) << 8) + block[pos + 1];
            pos += 2;
        } else {
            if (size - pos < 3) return false;
            nb_seq = block[pos + 1] + ((int64_t)block[pos + 2] << 8) + 0x7F00;
            pos += 3;
        }
        if (nb_seq == 0) continue;
        if (pos >= size) return false;
        uint32_t modes = block[pos++];
        if (modes & 3) return false;
        for (int k = 0; k < 3; k++) {
            long long next = read_seq_table(w, block, size, pos, (modes >> kKinds[k].shift) & 3,
                                            kKinds[k], k, prev[k], have_prev[k]);
            if (next < 0) return false;
            pos = (size_t)next;
        }
        // the bitstream is the rest of the block, and needs its sentinel bit
        if (pos >= size || block[size - 1] == 0) return false;
        int64_t nbytes = (int64_t)(size - pos);
        w.slots[b] = (int64_t)(w.seq_off.size() - 1);
        w.rows.insert(w.rows.end(), {blk[1] + (int64_t)pos, nbytes,
                                     (nbytes - 1) * 8 + highbit(block[size - 1])});
        w.seq_off.push_back(w.seq_off.back() + nb_seq);
        for (int k = 0; k < 3; k++) {
            w.al.push_back(prev[k].al);
            w.fse.insert(w.fse.end(), prev[k].row, prev[k].row + kFseRow);
        }
    }
    return true;
}

}  // namespace

extern "C" {

// What pass 1 found; the arrays live until zw_free.
struct ZwLiterals {
    int64_t n_frames, n_blocks, n_streams, n_tables, n_runs, lit_row;
    const int64_t* frame_chk;   // (n_frames,): the content checksum, or -1
    const int64_t* blocks;      // (n_blocks, 6): frame, offset, size, lits_end, literals, type
    const int64_t* streams;     // (n_streams, 7): huffman_torch.DECODE_COLS, offsets into the entry
    const int32_t* tables;      // (n_tables, 2048)
    const int64_t* runs;        // (n_runs, 4): length, destination, source in the entry, step
    const int64_t* frame_size;  // (n_frames,): the declared content size, or -1
};

// What pass 2 found: fse_torch.build_decode_batch's arrays but the payload
// (rows' byte_start are offsets into the entry), and each block's item.
struct ZwSequences {
    int64_t n_items;
    const int64_t* rows;     // (n_items, 3)
    const int64_t* seq_off;  // (n_items + 1,)
    const int32_t* al;       // (n_items, 3)
    const int32_t* tables;   // (n_items, 3, 512)
    const int64_t* slots;    // (n_blocks,): the block's item, or -1
};

// Pass 1 over the entry [data, data + n), which must stay alive until
// zw_free.  Returns the walk, or null where the input is rejected.
void* zw_literals(const uint8_t* data, size_t n, ZwLiterals* out) {
    Walk* w = new (std::nothrow) Walk();
    if (!w) return nullptr;
    w->data = data;
    w->n = n;
    bool ok;
    try {
        ok = walk_literals(*w);
    } catch (...) {
        ok = false;
    }
    if (!ok) {
        delete w;
        return nullptr;
    }
    *out = ZwLiterals{(int64_t)w->frame_chk.size(),
                      (int64_t)(w->blocks.size() / kBlockCols),
                      (int64_t)(w->streams.size() / kStreamCols),
                      (int64_t)(w->huf.size() / kHufRow),
                      (int64_t)(w->runs.size() / kRunCols),
                      w->lit_row,
                      w->frame_chk.data(),
                      w->blocks.data(),
                      w->streams.data(),
                      w->huf.data(),
                      w->runs.data(),
                      w->frame_size.data()};
    return w;
}

// Pass 2 on a walk of zw_literals.  Returns 0, or 1 where the input is
// rejected.
int zw_sequences(void* handle, ZwSequences* out) {
    Walk* w = (Walk*)handle;
    bool ok;
    try {
        ok = walk_sequences(*w);
    } catch (...) {
        ok = false;
    }
    if (!ok) return 1;
    *out = ZwSequences{(int64_t)(w->seq_off.size() - 1), w->rows.data(), w->seq_off.data(),
                       w->al.data(), w->fse.data(), w->slots.data()};
    return 0;
}

void zw_free(void* handle) { delete (Walk*)handle; }

}  // extern "C"
