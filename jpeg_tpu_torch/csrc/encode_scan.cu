// encode_scan: restart-segment Huffman encode of quantized zig-zag blocks
// into one tight stream of big-endian-bit u32 words, and the per-table
// symbol histogram of the same blocks, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device programs
// jpeg_tpu/entropy/encode_jax.py::encode_scan_device3 (with the transfer
// compaction device_encode._compact_segment_words) and
// encode_jax.py::hist_from_blocks.  The TPU runs a block-lane symbol state
// machine over a static number of item slots, builds [B, slots] word
// buffers and merges them into padded [n_segments, words_per_seg] rows
// with scatter-adds, behind sticky capacities that grow and retry on
// overflow.  Here one warp owns one restart segment, or one piece of up
// to PIECE blocks of a long one, and walks its blocks in bitstream order,
// all 32 lanes on one block at a time:
//
//   1. encode_segments: the warp finds its blocks in `seg_of` (a 32-ary
//      search).  For each block it loads the 64 coefficients
//      coalesced (lane l: positions l and l + 32) and takes the block's
//      nonzero mask with two ballots; each lane sizes its own positions'
//      items (the zero run before a nonzero from the mask with __clzll,
//      the ZRLs before it, its (run, cat) symbol, the DC item on lane 0,
//      EOB on lane 31 unless position 63 is nonzero), one warp scan of
//      the lengths (both halves of the block in one 32-bit scan) gives
//      every item's bit offset, and the items go into a ring of words in
//      shared memory with shared-memory atomicOr.  Whole words go out
//      coalesced as the ring fills and at the piece's end, into the
//      piece's own region of a scratch buffer: BLOCK_WORDS words per
//      block from its first block's, which its words cannot outgrow.  The
//      warp writes its bits and whether a symbol had no code;
//   2. layout_segments: one warp per segment sums its pieces' bits (a
//      warp scan gives each piece its bit offset in the segment) and
//      writes one int64 record: the segment's word count in the low
//      WORD_BITS bits, 1 above them if a symbol had no code;
//   3. the wrapper (entropy/encode_cuda.py) takes one torch.cumsum of the
//      records, on the device (a 1-D scan: a [n, 2] scan over the outer
//      dimension took 1.9 ms of a 2.2 ms call on the H100): each segment
//      starts on a fresh word of the tight stream;
//   4. compact_segments: one warp per piece stores the words of the tight
//      stream whose first bit is its own, shifting its bits (and the next
//      piece's, for the word they share) into place (~the compressed
//      size, coalesced); the last segment's warp writes the stream's word
//      count and the missing flag;
//   5. hist_blocks (the optimize dry pass, encoder.c:525-558): one
//      warp per block, read by the encode walk's for_each_block (two
//      coalesced loads, UNROLL blocks in flight, two ballots for the
//      nonzero mask):
//      each lane finds its positions' symbols from the mask (the run with
//      __clzll, its ZRLs, the (run, cat) symbol; the DC category on lane
//      0, EOB on lane 31 unless position 63 is nonzero), so no lane loops
//      over positions, and adds them with shared-memory atomics into its
//      CTA's one [T, 256] histogram.  A persistent grid: each CTA walks a
//      contiguous share of the groups of 32 blocks, so where the tables
//      are per frame (rows offset by each block's frame, T up to T_MAX) a
//      CTA's blocks lie in one or two frames and it has few nonzero bins;
//      each CTA adds its nonzero bins into the global int32 histogram
//      once: integer adds, so the result is exact and the same in any
//      order.  Exact in int32 at any size, where the TPU's float32 one-hot
//      sums are exact only below 2^24 per bin.
//
// The symbol rules are those of encode_scan_device3 bit for bit, missing
// codes included: an item is (ehufco[s] << cat) | extra over
// ehufsi[s] + cat bits, negative values carry (v - 1) & mask, and the
// category is the bit length of |v| capped at 16 (encode_cat_jax).  The
// plain versions are entropy/encode_torch.py::encode_scan_ref and
// hist_from_blocks_ref.  Code lengths are those of a JPEG table (at most
// 16 bits; longer entries are clipped to 16), so no block takes more than
// 32 + 63 * 32 = 2048 bits (BLOCK_WORDS words): a segment's words fit its
// region, and the tight stream fits the wrapper's word_capacity.
//
// What bounds it on the H100: an 8-frame 1080p chunk is 391,680 blocks
// (100 MB of int32 coefficients, read once) and ~1.6 MB of output, so
// bytes bound it at ~30 us; the histogram reads the same 100 MB and
// writes 2-8 KB.  Its earlier design ran one thread per block, so every
// warp load touched 32 block rows (32 L1 wavefronts a load), each thread
// looped over its 64 positions with divergent branches, and it took ~4x
// its bound.  The encode walk's earlier design (one thread per block)
// read each block row with 32 rows per warp load, read the blocks twice,
// stalled on a host sync between its passes and ORed every word with a
// global atomic into a zeroed buffer; here every block load is two
// 128-byte transactions, the blocks are read once, the code tables live
// in dynamic shared memory sized by the table count, nothing waits for
// the host, and no global atomic or memset runs.  A long segment (one
// per frame is 48,960 blocks at 1080p) would leave one warp walking it in
// order; its pieces spread it over the card.  What is left is the lanes'
// work per block: sizing, the scan, shared atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

// Stacked code tables: four a frame for the 8 frames of a chunk coded
// with per-frame tables.  Both kernels size their shared tables by the
// count a call passes (T * 1 KiB; 32 with the encode walk's rings is
// 40 KiB, under the 48 KiB a launch gets without opting in).
constexpr int T_MAX = 32;
constexpr int HIST_WARPS = 16;  // warps a CTA of hist_blocks
constexpr int SEG_WARPS = 8;  // segments (warps) per CTA
constexpr int RING = 256;  // words of each warp's shared-memory ring
constexpr int BLOCK_WORDS = 64;  // 2048 bits: the most one block takes
// Blocks whose loads a warp keeps in flight.  For hist_blocks on an
// 8-frame 1080p chunk (H100 80GB HBM3, 700 W; tools/hist_probe.py): 4 took
// 0.0463 ms, 2 0.0475, 8 0.0530 (53 registers: fewer warps an SM), 16
// 0.0774.
constexpr int UNROLL = 4;
// A warp's piece of a long segment: PIECE blocks, the first of a segment
// at least HALF (below).
constexpr int PIECE = 256;
constexpr int HALF = PIECE / 2;
// A segment record holds its words below bit WORD_BITS and its missing
// flag above: 64 * B words stay below 2^40 for any B < 2^31.
constexpr int WORD_BITS = 40;
constexpr long long WORD_MASK = (1LL << WORD_BITS) - 1;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int category(int v) {
  // encode_cat_jax: #{k < 16 : |v| >= 2^k}, with |INT_MIN| wrapping to a
  // negative value (category 0) as jnp.abs does.
  const int mag =
      static_cast<int>(v < 0 ? 0u - static_cast<uint32_t>(v)
                             : static_cast<uint32_t>(v));
  if (mag <= 0) return 0;
  return min(32 - __clz(mag), 16);
}

__device__ __forceinline__ uint32_t extra_bits(int v, int cat) {
  const uint32_t adj = static_cast<uint32_t>(v < 0 ? v - 1 : v);
  return adj & ((1u << cat) - 1u);
}

// ---- encode_scan: one warp per restart segment --------------------------

// The stacked code tables as one shared word per symbol: length << 16 |
// code, the length clipped to 16 bits.
__device__ __forceinline__ void load_codes(const int32_t* __restrict__ ehufco,
                                           const int32_t* __restrict__ ehufsi,
                                           int T, uint32_t* tab) {
  for (int i = threadIdx.x; i < T * 256; i += blockDim.x) {
    const int si = min(max(ehufsi[i], 0), 16);
    tab[i] = (static_cast<uint32_t>(si) << 16) |
             (static_cast<uint32_t>(ehufco[i]) & 0xFFFFu);
  }
  __syncthreads();
}

__device__ __forceinline__ int code_len(uint32_t e) {
  return static_cast<int>(e >> 16);
}

// First position p in [0, n) with seg_of[p] >= s (n if none), for a
// nondecreasing `seg_of`: a 32-ary search, one probe per lane per step.
__device__ __forceinline__ int lower_bound_warp(
    const int32_t* __restrict__ seg_of, int n, int s, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + lane * step;
    const unsigned m = __ballot_sync(FULL, q >= hi || seg_of[q] >= s);
    if (m & 1u) return lo;
    const int f = m ? __ffs(m) - 1 : 32;  // first probe at or past it
    const int nhi = f < 32 ? min(lo + f * step, hi) : hi;
    lo += (f - 1) * step + 1;
    hi = nhi;
  }
  const int q = lo + lane;
  const unsigned m = __ballot_sync(FULL, q >= hi || seg_of[q] >= s);
  return m ? min(lo + __ffs(m) - 1, hi) : hi;
}

// The block's nonzero positions as a 64-bit mask, with bit 0 (the DC)
// always set: it anchors the zero run before the first nonzero AC.
__device__ __forceinline__ uint64_t nz_mask(int a, int b) {
  const unsigned lo = __ballot_sync(FULL, a != 0);
  const unsigned hi = __ballot_sync(FULL, b != 0);
  return (static_cast<uint64_t>(hi) << 32) | lo | 1ull;
}

// Zero run before the nonzero AC at position p (1..63).
__device__ __forceinline__ int run_before(uint64_t mask, int p) {
  return p - (63 - __clzll(mask & ((1ull << p) - 1ull))) - 1;
}

// Calls fn(lo_val, hi_val, dc table, ac table) for each block of
// bitstream positions [lo, hi), in order, on the whole warp: lane l holds
// the block's coefficients at positions l and l + 32.  Position i is row
// order[i] of zz with LISTED (the encode walk), else row i (the
// histogram, which took 14% longer with its rows shuffled as well).
// The rows and table ids of 32 blocks come in one coalesced load, and the
// coefficient loads of UNROLL blocks are in flight together.
template <bool LISTED, typename Fn>
__device__ __forceinline__ void for_each_block(
    const int32_t* __restrict__ zz, const int32_t* __restrict__ order,
    const int32_t* __restrict__ dc_tab, const int32_t* __restrict__ ac_tab,
    int lo, int hi, int lane, Fn& fn) {
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    int row = 0, dct = 0, act = 0;
    if (lane < n) {
      row = LISTED ? order[base + lane] : base + lane;
      dct = dc_tab[row];
      act = ac_tab[row];
    }
    for (int j = 0; j < n; j += UNROLL) {
      int va[UNROLL], vb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        int r = base + j + u;
        if constexpr (LISTED) r = __shfl_sync(FULL, row, (j + u) & 31);
        va[u] = vb[u] = 0;
        if (j + u < n) {
          const int32_t* p = zz + static_cast<int64_t>(r) * 64;
          va[u] = p[lane];
          vb[u] = p[32 + lane];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int d = __shfl_sync(FULL, dct, (j + u) & 31);
        const int c = __shfl_sync(FULL, act, (j + u) & 31);
        if (j + u < n) fn(va[u], vb[u], d, c);
      }
    }
  }
}

// The items of one position of a block: `nz` ZRLs (code `zcode` over
// `zlen` bits each), then `code` over `len` bits (nothing for a zero AC).
struct Items {
  uint32_t zcode = 0u, code = 0u;
  int nz = 0, zlen = 0, len = 0;
  __device__ int bits() const { return nz * zlen + len; }
};

// The items of AC position p (1..63) holding v; `missing` notes a code of
// length 0.
__device__ __forceinline__ Items ac_items(const uint32_t* tab, int a, int p,
                                          int v, uint64_t mask,
                                          bool& missing) {
  Items it;
  if (v == 0) return it;
  const int gap = run_before(mask, p);
  const int cat = category(v);
  const uint32_t e = tab[a + (((gap & 15) << 4) | cat)];
  it.code = ((e & 0xFFFFu) << cat) | extra_bits(v, cat);
  it.len = code_len(e) + cat;
  missing |= code_len(e) == 0;
  if (gap >= 16) {
    const uint32_t z = tab[a + 0xF0];
    it.nz = gap >> 4;
    it.zcode = z & 0xFFFFu;
    it.zlen = code_len(z);
    missing |= it.zlen == 0;
  }
  return it;
}

struct Pack {
  const uint32_t* tab;
  uint32_t* ring;  // this warp's RING words: piece word w in slot w % RING
  uint32_t* out;   // the piece's region of the scratch words
  int lane;
  long long bit = 0;      // the piece's bits so far (warp-uniform)
  long long flushed = 0;  // words already stored (warp-uniform)
  bool missing = false;   // this lane saw a code of length 0

  // Stores words [flushed, upto) and zeroes their slots.
  __device__ void flush(long long upto) {
    __syncwarp();
    for (long long w = flushed + lane; w < upto; w += 32) {
      uint32_t* slot = ring + (w & (RING - 1));
      out[w] = *slot;
      *slot = 0u;
    }
    __syncwarp();
    flushed = upto;
  }

  // ORs the low `len` (0..32) bits of `val` in at bit `pos` of the ring,
  // counted from word `flushed`'s slot `base`.
  __device__ void put(int base, int pos, uint32_t val, int len) {
    if (len == 0) return;
    if (len < 32) val &= (1u << len) - 1u;
    const int w = base + (pos >> 5);
    const int end = (pos & 31) + len;
    if (end <= 32) {
      atomicOr(ring + (w & (RING - 1)), val << (32 - end));
    } else {
      atomicOr(ring + (w & (RING - 1)), val >> (end - 32));
      atomicOr(ring + ((w + 1) & (RING - 1)), val << (64 - end));
    }
  }

  // Puts the items `it` in from ring bit `pos`.
  __device__ void put_items(int base, int pos, const Items& it) {
    for (int z = 0; z < it.nz; ++z) {
      put(base, pos, it.zcode, it.zlen);
      pos += it.zlen;
    }
    put(base, pos, it.code, it.len);
  }

  __device__ void operator()(int va, int vb, int dct, int act) {
    // Room for the block's worst case in the ring, past its partial word.
    if ((bit >> 5) + BLOCK_WORDS + 1 - flushed > RING) flush(bit >> 5);
    const uint64_t mask = nz_mask(va, vb);
    const int a = act * 256;
    Items ia, ib;  // positions lane and lane + 32
    if (lane == 0) {  // the DC item
      const int dcat = category(va);
      const uint32_t e = tab[dct * 256 + dcat];
      ia.code = ((e & 0xFFFFu) << dcat) | extra_bits(va, dcat);
      ia.len = code_len(e) + dcat;
      missing |= code_len(e) == 0;
    } else {
      ia = ac_items(tab, a, lane, va, mask, missing);
    }
    if (lane == 31 && !(mask >> 63)) {  // position 63 is zero: EOB
      const uint32_t e = tab[a];
      ib.code = e & 0xFFFFu;
      ib.len = code_len(e);
      missing |= ib.len == 0;
    } else {
      ib = ac_items(tab, a, lane + 32, vb, mask, missing);
    }
    // One inclusive scan of both halves' lengths (each sum < 2^16).
    const int packed = ia.bits() | (ib.bits() << 16);
    int incl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int tot = __shfl_sync(FULL, incl, 31);
    const int ex = incl - packed;
    const int tot_a = tot & 0xFFFF;
    // The block starts less than RING words past word `flushed`.
    const int base = static_cast<int>(flushed & (RING - 1));
    const int rel = static_cast<int>(bit - (flushed << 5));
    put_items(base, rel + (ex & 0xFFFF), ia);
    put_items(base, rel + tot_a + (ex >> 16), ib);
    bit += tot_a + (tot >> 16);
  }
};

// Long segments are cut into pieces, one warp each: a segment's first
// piece runs from its first block to the first multiple of PIECE at least
// HALF blocks on, and every multiple of PIECE past that inside the
// segment starts a piece of up to PIECE blocks.  So every piece but a
// segment's last holds at least HALF blocks, and no piece needs to know
// where another starts.
__device__ __forceinline__ int first_cont(int lo) {
  return (lo + HALF + PIECE - 1) / PIECE;
}

// The piece of warp w (first pieces 0..n_segments-1, then the window
// k = w - n_segments whose first block starts a continuation piece, if
// it does): its segment, its blocks [start, end) and the segment's blocks
// [lo, hi).  -> false for a window that starts no piece.
__device__ __forceinline__ bool piece_of(const int32_t* __restrict__ seg_of,
                                         int B, int n_segments, int w,
                                         int lane, int& s, int& start,
                                         int& end, int& lo, int& hi) {
  if (w < n_segments) {
    s = w;
    lo = lower_bound_warp(seg_of, B, s, lane);
    hi = lower_bound_warp(seg_of, B, s + 1, lane);
    start = lo;
    end = min(hi, first_cont(lo) * PIECE);
    return true;
  }
  start = (w - n_segments) * PIECE;
  if (start >= B) return false;
  s = seg_of[start];
  lo = lower_bound_warp(seg_of, B, s, lane);
  if (start < lo + HALF) return false;
  hi = lower_bound_warp(seg_of, B, s + 1, lane);
  end = min(hi, start + PIECE);
  return true;
}

__global__ void __launch_bounds__(SEG_WARPS * 32)
encode_segments_kernel(const int32_t* __restrict__ zz,
                       const int32_t* __restrict__ order,
                       const int32_t* __restrict__ seg_of,
                       const int32_t* __restrict__ dc_tab,
                       const int32_t* __restrict__ ac_tab,
                       const int32_t* __restrict__ ehufco,
                       const int32_t* __restrict__ ehufsi, int T, int B,
                       int n_segments, int n_pieces,
                       uint32_t* __restrict__ scratch,
                       int32_t* __restrict__ seg_first,
                       int64_t* __restrict__ piece_rec) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;
  load_codes(ehufco, ehufsi, T, tab);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * SEG_WARPS + warp;
  if (w >= n_pieces) return;
  int s, start, end, lo, hi;
  if (!piece_of(seg_of, B, n_segments, w, lane, s, start, end, lo, hi)) {
    if (lane == 0) piece_rec[w] = -1;
    return;
  }
  uint32_t* ring = smem + T * 256 + warp * RING;
  for (int i = lane; i < RING; i += 32) ring[i] = 0u;
  __syncwarp();
  Pack pk{tab, ring, scratch + static_cast<int64_t>(start) * BLOCK_WORDS,
          lane};
  for_each_block<true>(zz, order, dc_tab, ac_tab, start, end, lane, pk);
  pk.flush((pk.bit + 31) >> 5);
  const bool missing = __any_sync(FULL, pk.missing);
  if (lane == 0) {
    if (w < n_segments) seg_first[s] = lo;
    piece_rec[w] = pk.bit | (missing ? 1LL << WORD_BITS : 0LL);
  }
}

// Per segment: its pieces' bit offsets in it (continuation pieces), its
// bits, and its record (words | missing << WORD_BITS).
__global__ void __launch_bounds__(SEG_WARPS * 32)
layout_segments_kernel(const int32_t* __restrict__ seg_first,
                       const int64_t* __restrict__ piece_rec, int B,
                       int n_segments, int64_t* __restrict__ piece_off,
                       int64_t* __restrict__ seg_bits,
                       int64_t* __restrict__ seg_rec) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  if (s >= n_segments) return;
  const int lo = seg_first[s];
  const int hi = s + 1 < n_segments ? seg_first[s + 1] : B;
  long long total = piece_rec[s] & WORD_MASK;
  bool missing = (piece_rec[s] >> WORD_BITS) != 0;
  const int k1 = (hi + PIECE - 1) / PIECE;  // windows starting below hi
  for (int base = first_cont(lo); base < k1; base += 32) {
    const int k = base + lane;
    const int64_t r = k < k1 ? piece_rec[n_segments + k] : 0;
    const long long bits = r & WORD_MASK;
    missing |= __any_sync(FULL, (r >> WORD_BITS) != 0);
    long long incl = bits;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (k < k1) piece_off[k] = total + incl - bits;
    total += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) {
    seg_bits[s] = total;
    seg_rec[s] = ((total + 31) >> 5) | (missing ? 1LL << WORD_BITS : 0LL);
  }
}

// The 32 bits of a piece from its bit t (t < bits), MSB first, zero past
// its `bits`; the piece's words start at `src`.
__device__ __forceinline__ uint32_t piece_bits(const uint32_t* src,
                                               long long bits, long long t) {
  const long long w = t >> 5;
  const int sh = static_cast<int>(t & 31);
  uint32_t v = src[w];
  if (sh) {
    v <<= sh;
    if ((w + 1) * 32 < bits) v |= src[w + 1] >> (32 - sh);
  }
  const long long rest = bits - t;
  return rest < 32 ? v & (~0u << (32 - rest)) : v;
}

// One warp per piece: the stream's words whose first bit falls in the
// piece, each stored once, with the bits of the following pieces of the
// segment that the word takes; the first pieces store the segments'
// first words, and the last segment's the word count and missing flag.
__global__ void __launch_bounds__(SEG_WARPS * 32)
compact_segments_kernel(const uint32_t* __restrict__ scratch,
                        const int32_t* __restrict__ seg_of,
                        const int32_t* __restrict__ seg_first,
                        const int64_t* __restrict__ piece_rec,
                        const int64_t* __restrict__ piece_off,
                        const int64_t* __restrict__ seg_rec,
                        const int64_t* __restrict__ cum, int B,
                        int n_segments, int n_pieces,
                        uint32_t* __restrict__ words,
                        int64_t* __restrict__ seg_wbase,
                        int64_t* __restrict__ n_words,
                        bool* __restrict__ missing) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  if (w >= n_pieces || piece_rec[w] < 0) return;
  const bool first = w < n_segments;
  const int start = first ? 0 : (w - n_segments) * PIECE;
  const int s = first ? w : seg_of[start];
  const int lo = seg_first[s];
  const int hi = s + 1 < n_segments ? seg_first[s + 1] : B;
  const long long base = (cum[s] - seg_rec[s]) & WORD_MASK;
  if (first && lane == 0) {
    seg_wbase[s] = base;
    if (s == n_segments - 1) {
      *n_words = cum[s] & WORD_MASK;
      *missing = (cum[s] >> WORD_BITS) != 0;
    }
  }
  const long long bits = piece_rec[w] & WORD_MASK;
  const long long off = first ? 0 : piece_off[w - n_segments];
  const uint32_t* src =
      scratch + static_cast<int64_t>(first ? lo : start) * BLOCK_WORDS;
  // The next piece's window (past the segment's end: none).
  const int next = first ? first_cont(lo) : (w - n_segments) + 1;
  for (long long word = ((off + 31) >> 5) + lane; word * 32 < off + bits;
       word += 32) {
    const long long t = word * 32 - off;
    uint32_t v = piece_bits(src, bits, t);
    int have = static_cast<int>(min(32LL, bits - t));
    for (int k = next; have < 32 && k * PIECE < hi; ++k) {
      const long long kb = piece_rec[n_segments + k] & WORD_MASK;
      if (kb > 0) {
        v |= piece_bits(scratch + static_cast<int64_t>(k) * PIECE * BLOCK_WORDS,
                        kb, 0) >> have;
        have += static_cast<int>(min(static_cast<long long>(32 - have), kb));
      }
    }
    words[base + word] = v;
  }
}

// ---- block_histogram: one warp per block ------------------------------

// Counts one block's symbols into its CTA's histogram `h` on the whole
// warp: lane l holds the coefficients at positions l (va) and l + 32 (vb);
// the block's tables are dct and act.  The symbols are the encode walk's
// (ac_items): the DC category, per nonzero AC its ZRLs and its (run, cat)
// symbol, EOB unless position 63 is nonzero.  A lane adds its symbols
// with shared-memory atomics: a histogram a warp took 4% longer on the
// H100, and electing one lane a bin (__match_any_sync) 25% longer
// (tools/hist_probe.py): same-bin lanes of one block are few.
struct Count {
  int32_t* h;
  int lane;

  __device__ void operator()(int va, int vb, int dct, int act) {
    const uint64_t mask = nz_mask(va, vb);
    const int a = act * 256;
    int sa = -1, sb = -1, zrl = 0;
    if (lane == 0) {
      sa = dct * 256 + category(va);
    } else if (va != 0) {
      const int gap = run_before(mask, lane);
      sa = a + (((gap & 15) << 4) | category(va));
      zrl = gap >> 4;
    }
    if (vb != 0) {
      const int gap = run_before(mask, lane + 32);
      sb = a + (((gap & 15) << 4) | category(vb));
      zrl += gap >> 4;
    } else if (lane == 31) {
      sb = a;  // position 63 is zero: EOB
    }
    if (sa >= 0) atomicAdd(h + sa, 1);
    if (sb >= 0) atomicAdd(h + sb, 1);
    if (zrl) atomicAdd(h + a + 0xF0, zrl);
  }
};

// A persistent grid: CTA c takes the c-th of gridDim.x contiguous shares
// of the groups of 32 blocks, its warp w every HIST_WARPS-th group of the
// share from the w-th, and walks each with for_each_block.
__global__ void __launch_bounds__(HIST_WARPS * 32)
hist_blocks_kernel(const int32_t* __restrict__ zz,
                   const int32_t* __restrict__ dc_tab,
                   const int32_t* __restrict__ ac_tab, int T, int B,
                   int32_t* __restrict__ hist) {
  extern __shared__ int32_t h[];  // [T, 256]
  const int bins = T * 256;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  Count count{h, lane};
  const int64_t groups = (static_cast<int64_t>(B) + 31) / 32;
  const int64_t g1 = groups * (blockIdx.x + 1) / gridDim.x;
  for (int64_t g = groups * blockIdx.x / gridDim.x + warp; g < g1;
       g += HIST_WARPS) {
    const int64_t lo = g * 32;
    const int hi = static_cast<int>(lo + 32 < B ? lo + 32 : B);
    for_each_block<false>(zz, nullptr, dc_tab, ac_tab, static_cast<int>(lo),
                          hi, lane, count);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

unsigned seg_grid(int warps) {
  return static_cast<unsigned>((warps + SEG_WARPS - 1) / SEG_WARPS);
}

}  // namespace

extern "C" int jt_encode_scan_t_max() { return T_MAX; }
extern "C" int jt_encode_scan_block_words() { return BLOCK_WORDS; }

// The warps of the encode walk and the compaction: one per segment's
// first piece and one per window of PIECE blocks.
extern "C" int jt_encode_scan_pieces(int B, int n_segments) {
  return n_segments + (B + PIECE - 1) / PIECE;
}

// Pass 1 on `stream`: each piece's words into its region of `scratch`
// (BLOCK_WORDS words per block from its first block), each segment's
// first position, and a record per piece (bits | missing << WORD_BITS,
// -1 for a window that starts no piece); then per segment its pieces'
// offsets, its bits and record (words | missing << WORD_BITS).  Returns
// cudaGetLastError() after the launches.
extern "C" int jt_encode_segments(const void* zz, const void* order,
                                  const void* seg_of, const void* dc_tab,
                                  const void* ac_tab, const void* ehufco,
                                  const void* ehufsi, int T, int B,
                                  int n_segments, void* scratch,
                                  void* seg_first, void* piece_rec,
                                  void* piece_off, void* seg_bits,
                                  void* seg_rec, void* stream) {
  if (n_segments <= 0) return 0;
  const int n_pieces = jt_encode_scan_pieces(B, n_segments);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shared =
      (static_cast<size_t>(T) * 256 + SEG_WARPS * RING) * sizeof(uint32_t);
  encode_segments_kernel<<<seg_grid(n_pieces), SEG_WARPS * 32, shared, st>>>(
      static_cast<const int32_t*>(zz), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(seg_of), static_cast<const int32_t*>(dc_tab),
      static_cast<const int32_t*>(ac_tab), static_cast<const int32_t*>(ehufco),
      static_cast<const int32_t*>(ehufsi), T, B, n_segments, n_pieces,
      static_cast<uint32_t*>(scratch), static_cast<int32_t*>(seg_first),
      static_cast<int64_t*>(piece_rec));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layout_segments_kernel<<<seg_grid(n_segments), SEG_WARPS * 32, 0, st>>>(
      static_cast<const int32_t*>(seg_first),
      static_cast<const int64_t*>(piece_rec), B, n_segments,
      static_cast<int64_t*>(piece_off), static_cast<int64_t*>(seg_bits),
      static_cast<int64_t*>(seg_rec));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on `stream`, after the inclusive prefix sums `cum` of `seg_rec`:
// the tight stream, each segment's first word, the stream's word count
// and the missing flag; returns cudaGetLastError() after the launch.
extern "C" int jt_compact_segments(const void* scratch, const void* seg_of,
                                   const void* seg_first,
                                   const void* piece_rec,
                                   const void* piece_off, const void* seg_rec,
                                   const void* cum, int B, int n_segments,
                                   void* words, void* seg_wbase,
                                   void* n_words, void* missing,
                                   void* stream) {
  if (n_segments <= 0) return 0;
  const int n_pieces = jt_encode_scan_pieces(B, n_segments);
  compact_segments_kernel<<<seg_grid(n_pieces), SEG_WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(scratch),
      static_cast<const int32_t*>(seg_of),
      static_cast<const int32_t*>(seg_first),
      static_cast<const int64_t*>(piece_rec),
      static_cast<const int64_t*>(piece_off),
      static_cast<const int64_t*>(seg_rec), static_cast<const int64_t*>(cum),
      B, n_segments, n_pieces, static_cast<uint32_t*>(words),
      static_cast<int64_t*>(seg_wbase), static_cast<int64_t*>(n_words),
      static_cast<bool*>(missing));
  return static_cast<int>(cudaGetLastError());
}

// Adds the symbol counts of the B blocks into `hist` [T, 256] on
// `stream`; returns the first CUDA error (cudaGetLastError() after the
// launch).
extern "C" int jt_hist_blocks(const void* zz, const void* dc_tab,
                              const void* ac_tab, int T, int B, void* hist,
                              void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T > T_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(T) * 256 * sizeof(int32_t);
  int ctas = 0;
  const cudaError_t err = resident_ctas(
      reinterpret_cast<const void*>(hist_blocks_kernel), HIST_WARPS * 32,
      shared, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = static_cast<int>((B + 32LL * HIST_WARPS - 1) /
                                      (32LL * HIST_WARPS));
  const int grid = groups < ctas ? groups : ctas;
  hist_blocks_kernel<<<grid, HIST_WARPS * 32, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(zz), static_cast<const int32_t*>(dc_tab),
      static_cast<const int32_t*>(ac_tab), T, B, static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}
