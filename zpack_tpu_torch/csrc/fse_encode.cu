// zstd FSE sequence-section encode for Hopper (sm_90a): one CTA of 256
// threads per block; three lanes walk the three state chains, the CTA packs
// the fields.
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
// scalar loop.  But the chain carries only the three states: how many bits
// a state writes follows from the state and its code, and where every field
// goes follows from an exclusive scan of those counts.  So, as the sequence
// decoder (fse_decode.cu) splits its chain from its values:
//
//   1. All threads stage the block's three tables into shared memory (the
//      state table, and delta_nb_bits with delta_find_state as one 8-byte
//      entry a code, all times 4 so that a table index is a byte offset)
//      and its code words (the first int of each row, 4 bytes a sequence).
//   2. Lanes 0, 1 and 2 of warp 0 walk the LL, OF and ML chains, one
//      machine a lane: nb = (state + dnb[code]) >> 16, state =
//      st[((state >> nb) + dfs[code]) & 511], one dependent shared load a
//      step.  The codes come a batch of eight steps ahead and their table
//      entries do not depend on the state, so the step waits on nothing
//      else.  Each lane stores the state each step starts from (16 bits).
//   3. All threads pack, a sequence a thread, in tiles of 256: each
//      recomputes its three state widths and values from the stored states
//      and the codes (the row read coalesced from global memory), adds the
//      ll, ml and of extra bits, and takes its position from a block-wide
//      exclusive scan of the bit counts.  The fields are OR'ed into a shared
//      tile of words (of, ml, ll states, then ll, ml, of extras); the tile's
//      whole words go out in coalesced stores, each word once, and its last
//      partial word is carried into the next tile.  After the last tile come
//      the flush (ml, of, ll at their accuracy logs) and the sentinel bit.
//
// A block of more sequences than the stage holds (10 bytes a sequence; the
// wrapper sizes it from the batch, up to fse_torch.ENCODE_STAGE_CAP) runs
// the same code with its code words and states in a global scratch.
//
// What bounds it: the longest block's chain, a step one dependent shared
// load and six dependent integer operations (add, two shifts, add, mask, the
// table's base); every block of the main path is resident at once.  The
// output sizes come from the host's upper bound (every state write at its
// accuracy log); a word past the block's range is never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTable = 512;             // max FSE table size (accuracy log 9)
constexpr int kSym = 64;                // code alphabets padded to 64
constexpr int kRow = kTable + 2 * kSym;  // state table | delta_nb_bits | delta_find_state
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 8;               // code words a walker loads a batch ahead
constexpr int kStageBytes = 4 + 3 * 2;  // a staged sequence: its code word, three states
// a tile's words: six fields of at most 32 bits a sequence, the carried
// word and the overhang of the last field
constexpr int kTileWords = kThreads * 6 + 2;

// extra-bit counts per literal-length and match-length code (RFC 8878
// §3.1.1.3.2.1.1), zero past the alphabets; an offset code's count is the
// code itself.  Copied to shared memory before use.
__constant__ uint8_t kLLBits[kSym] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ uint8_t kMLBits[kSym] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Smem {
  int st[3][kTable];      // state tables: LL, OF, ML, times 4
  int2 dd[3][kSym];       // (delta_nb_bits, delta_find_state) per code, times 4
  uint8_t xbits[2][kSym];  // extra bits per LL and ML code
  uint32_t tile[kTileWords];
  int warp_sums[kWarps];
  int fin[3];             // the states after the last step
};

// The code of machine m (LL, OF, ML) in a code word llc | mlc << 8 | ofc << 16.
__device__ __forceinline__ int code_of(uint32_t c, int m) {
  return int(c >> (m == 0 ? 0 : m == 1 ? 16 : 8)) & (kSym - 1);
}

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {  // n in 0..32
  return n >= 32 ? v : v & ((1u << n) - 1);
}

// OR the low nb bits of v into the tile at bit p (nb in 0..32).
__device__ __forceinline__ void put(uint32_t* tile, int p, uint32_t v, int nb) {
  if (nb <= 0) return;
  const uint64_t x = uint64_t(low_bits(v, nb)) << (p & 31);
  atomicOr(&tile[p >> 5], uint32_t(x));
  if ((p & 31) + nb > 32) atomicOr(&tile[(p >> 5) + 1], uint32_t(x >> 32));
}

// fse.EncodeTable.encode's next state, on values times 4: nb = (s + dnb) >>
// 16 and s = st[((s >> nb) + dfs) & 511].  Scaled, the index masked by
// 511 * 4 is the entry's byte offset in the machine's table st.  dd is the
// machine's (dnb, dfs) row, c holds the code in its low 6 bits.
__device__ __forceinline__ int next_state(const int* st, const int2* dd, int s, uint32_t c) {
  const int2 e = dd[c & (kSym - 1)];
  const int nb = (s + e.x) >> 18;
  return *reinterpret_cast<const int*>(reinterpret_cast<const char*>(st) +
                                       (((s >> nb) + e.y) & (4 * kTable - 4)));
}

// Step 2: lane m of warp 0 walks machine m's chain over codes[0, n),
// storing to states[m * stride + k] the state step k starts from (times 4,
// as the tables are); fin[m] gets the state after the last step.
__device__ __forceinline__ void walk(const uint32_t* codes, uint16_t* states, int stride, int n,
                                     const Smem& sm, int* fin) {
  const int m = threadIdx.x;
  const int shift = m == 0 ? 0 : m == 1 ? 16 : 8;  // the machine's code in a code word
  const int* st = sm.st[m];
  const int2* dd = sm.dd[m];
  uint16_t* out = states + m * stride;
  int s;
  {  // the block's last sequence: fse.EncodeTable.init_state, in unscaled terms
    const int2 e = dd[codes[0] >> shift & (kSym - 1)];
    const int d = e.x >> 2;
    const int nb = (d + (1 << 15)) >> 16;
    const int val = (nb << 16) - d;
    s = st[((val >> nb) + (e.y >> 2)) & (kTable - 1)];
  }
  uint32_t cur[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) cur[j] = 1 + j < n ? codes[1 + j] : 0;
  int k0 = 1;
  for (; k0 + kAhead <= n; k0 += kAhead) {  // whole batches: no branch in the steps
    uint32_t nxt[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      nxt[j] = k0 + kAhead + j < n ? codes[k0 + kAhead + j] : 0;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      out[k0 + j] = uint16_t(s);
      s = next_state(st, dd, s, cur[j] >> shift);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) cur[j] = nxt[j];
  }
  for (; k0 < n; ++k0) {  // the last steps
    out[k0] = uint16_t(s);
    s = next_state(st, dd, s, codes[k0] >> shift);
  }
  fin[m] = s >> 2;
}

// An exclusive block-wide scan of v; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// Steps 2 and 3 of one block: codes holds its n code words, states its
// three state rows at the given stride.  steps: 1 the walk, 2 the packing
// (each alone for timing only), 3 both.
__device__ __forceinline__ void encode_block(const uint32_t* codes, uint16_t* states, int stride,
                                             int n, const int4* __restrict__ f, const int* al,
                                             uint32_t* __restrict__ out, int64_t nw,
                                             int* total_bits, int steps, Smem& sm) {
  const int tid = threadIdx.x;
  if (tid < 3) {
    sm.fin[tid] = 0;
    if ((steps & 1) && n > 0) walk(codes, states, stride, n, sm, sm.fin);
  }
  __syncthreads();
  if (!(steps & 2)) return;

  int run = 0;  // the block's bits so far; its tile starts at word run >> 5
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int k = t0 + tid;
    const bool live = k < n;
    const int4 r = live ? f[k] : make_int4(0, 0, 0, 0);
    const uint32_t c = uint32_t(r.x);
    int sn[3] = {0, 0, 0};
    uint32_t sv[3] = {0, 0, 0};
    if (live && k > 0) {  // the first row (the block's last sequence) writes no state
#pragma unroll
      for (int m = 0; m < 3; ++m) {  // scaled: the state and delta_nb_bits times 4
        const int state = states[m * stride + k];
        sn[m] = min(max((state + sm.dd[m][code_of(c, m)].x) >> 18, 0), 32);
        sv[m] = uint32_t(state >> 2);
      }
    }
    const int xl = live ? sm.xbits[0][code_of(c, 0)] : 0;
    const int xm = live ? sm.xbits[1][code_of(c, 2)] : 0;
    const int xo = live ? min(code_of(c, 1), 32) : 0;
    int tile_bits;
    const int excl = block_scan(sn[0] + sn[1] + sn[2] + xl + xm + xo, sm.warp_sums, &tile_bits);
    const int w0 = run >> 5;
    int p = run - 32 * w0 + excl;  // bit position in the tile
    put(sm.tile, p, sv[1], sn[1]);  // of, ml, ll states
    p += sn[1];
    put(sm.tile, p, sv[2], sn[2]);
    p += sn[2];
    put(sm.tile, p, sv[0], sn[0]);
    p += sn[0];
    put(sm.tile, p, uint32_t(r.y), xl);  // ll, ml, of extras
    p += xl;
    put(sm.tile, p, uint32_t(r.z), xm);
    p += xm;
    put(sm.tile, p, uint32_t(r.w), xo);
    __syncthreads();
    const int end = run + tile_bits;
    const int whole = (end >> 5) - w0, used = ((end + 31) >> 5) - w0;
    uint32_t carry = 0;
    bool holder = false;
    for (int j = tid; j < used; j += kThreads) {
      const uint32_t v = sm.tile[j];
      sm.tile[j] = 0;
      if (j < whole) {
        if (w0 + j < nw) out[w0 + j] = v;
      } else {  // the partial last word goes on as the next tile's first
        carry = v;
        holder = true;
      }
    }
    __syncthreads();
    if (holder) atomicOr(&sm.tile[0], carry);
    run = end;
  }
  // the flush (ml, of, ll at their accuracy logs), then the sentinel
  const int w0 = run >> 5;
  if (tid == 0) {
    int p = run - 32 * w0;
    if (n > 0) {
      const int order[3] = {2, 1, 0};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int a = min(max(al[order[i]], 0), 32);
        put(sm.tile, p, uint32_t(sm.fin[order[i]]), a);
        p += a;
      }
      put(sm.tile, p, 1u, 1);
    }
    *total_bits = w0 * 32 + p;
  }
  __syncthreads();
  if (n == 0) return;
  const int end = *total_bits + 1;
  const int used = ((end + 31) >> 5) - w0;
  for (int j = tid; j < used; j += kThreads)
    if (w0 + j < nw) out[w0 + j] = sm.tile[j];
}

__global__ void __launch_bounds__(kThreads)
fse_encode_kernel(const int4* __restrict__ fields, const int64_t* __restrict__ seq_off,
                  const int* __restrict__ tables, const int* __restrict__ al,
                  const int64_t* __restrict__ word_off, int stage, int steps,
                  uint32_t* __restrict__ scratch, uint32_t* __restrict__ words,
                  int* __restrict__ total_bits) {
  extern __shared__ uint32_t staged[];  // codes[stage], then states[3][stage] as uint16
  __shared__ Smem sm;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int* src = tables + int64_t(b) * 3 * kRow;
  for (int i = tid; i < 3 * kTable; i += kThreads)  // times 4: byte offsets
    sm.st[i / kTable][i % kTable] = 4 * src[(i / kTable) * kRow + i % kTable];
  for (int i = tid; i < 3 * kSym; i += kThreads) {
    const int* row = src + (i / kSym) * kRow + kTable;
    sm.dd[i / kSym][i % kSym] = make_int2(4 * row[i % kSym], 4 * row[kSym + i % kSym]);
  }
  if (tid < kSym) {
    sm.xbits[0][tid] = kLLBits[tid];
    sm.xbits[1][tid] = kMLBits[tid];
  }
  for (int i = tid; i < kTileWords; i += kThreads) sm.tile[i] = 0;
  const int64_t s0 = seq_off[b];
  const int n = int(seq_off[b + 1] - s0);
  const int64_t total = seq_off[gridDim.x];
  const int4* f = fields + s0;
  const bool in_stage = n <= stage;
  // a longer block: codes[total], then states[3][total], in the scratch
  uint32_t* codes = in_stage ? staged : scratch + s0;
  for (int i = tid; i < n; i += kThreads) codes[i] = uint32_t(f[i].x);
  __syncthreads();
  const int64_t base = word_off[b];
  if (in_stage)
    encode_block(staged, reinterpret_cast<uint16_t*>(staged + stage), stage, n, f, al + 3 * b,
                 words + base, word_off[b + 1] - base, total_bits + b, steps, sm);
  else
    encode_block(scratch + s0, reinterpret_cast<uint16_t*>(scratch + total) + s0, int(total), n,
                 f, al + 3 * b, words + base, word_off[b + 1] - base, total_bits + b, steps, sm);
}

// Lets the kernel take smem bytes of dynamic shared memory (once a device).
cudaError_t allow_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};  // the attribute as set, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && smem > smem_set[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fse_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    smem_set[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// fields (total, 4) i32 (codes, ll, ml and of extra values), in reversed
// sequence order per block; seq_off (B + 1) i64; tables (B, 3, 640) i32
// (ll, of, ml); al (B, 3) i32; word_off (B + 1) i64; stage: the sequences a
// block may stage in shared memory (a longer one works in the scratch);
// steps: 3 (1 the walk alone, 2 the packing alone: for timing only);
// scratch: 10 bytes a sequence of the batch (u32 codes, then three u16
// state rows) if any block is longer than stage; words: the zeroed u32
// plane; total_bits (B,) i32.  Returns cudaGetLastError().
extern "C" int zp_fse_encode(const void* fields, const void* seq_off, const void* tables,
                             const void* al, const void* word_off, int B, int stage, int steps,
                             void* scratch, void* words, void* total_bits, void* stream) {
  const int smem = kStageBytes * (stage < 0 ? 0 : stage);
  const cudaError_t rc = allow_smem(smem);
  if (rc != cudaSuccess) return int(rc);
  fse_encode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(fields), static_cast<const int64_t*>(seq_off),
      static_cast<const int*>(tables), static_cast<const int*>(al),
      static_cast<const int64_t*>(word_off), stage, steps, static_cast<uint32_t*>(scratch),
      static_cast<uint32_t*>(words), static_cast<int*>(total_bits));
  return int(cudaGetLastError());
}

// *per_sm: the CTAs an SM holds at a stage of that many sequences.
// Returns the occupancy query's error.
extern "C" int zp_fse_encode_occupancy(int stage, void* per_sm) {
  const int smem = kStageBytes * (stage < 0 ? 0 : stage);
  const cudaError_t rc = allow_smem(smem);
  if (rc != cudaSuccess) return int(rc);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(per_sm),
                                                           fse_encode_kernel, kThreads, smem));
}
