// decode_rstless: speculative parallel Huffman decode of entropy-coded
// segments without restart markers, for Hopper (sm_90a).
//
// Replaces the JAX package's speculative engine
// (jpeg_tpu/entropy/speculative.py): K8 _probe_match (the phase-variant
// probe, record compaction, membership scatter and tail walk), K9
// _resolve_fast / _fused_recover (authority chain and re-probe rounds) and
// K10 _final_decode (authoritative re-decode and DC prefix).  The TPU
// version runs every lane in lockstep for a static, learned step bound,
// keeps block-start records in capped per-lane lists (TCAP/HCAP) and
// composes per-row variant maps with an associative scan, all to serve
// XLA's static shapes.  Here a thread decodes until its work is done, the
// records go straight into a dense membership map, and the authority chain
// is a short sequential walk per frame.  The plain versions, step for
// step, are in entropy/speculative_torch.py.
//
// A segment of a frame is cut into chunk rows of cb_bits bits; every bit
// position is frame-global and a row reads its frame's words from its own
// offset, so a decode may run past its chunk.  The Huffman tables in use
// depend on a block's slot in the MCU, so two decodes meet only at a
// common (bit, slot) block-start state; each row is decoded once per
// possible slot ("variant" v starts at the row's first bit with slot v).
//
//   K8  jt_rstless_sync, two launches:
//       head  every (row, variant) thread decodes the row's first
//             strip_bits bits and raises member[row, bit, slot] to
//             ((ordinal << 4) | variant) + 1 at each block start (atomicMax:
//             deterministic);
//       tail  every (row, variant) thread decodes from its start through
//             the row into the successor row and stops at the first block
//             start present in the successor's membership (ST_LINK: the
//             state, its own ordinal there and the successor's variant and
//             ordinal), or past the successor's strip (ST_MISS: its
//             crossing, the first block start at or after the successor's
//             first bit), or where it dies (ST_END; a frame's last row
//             always decodes to the segment's end).
//   K9  jt_rstless_walk: one CTA per frame stages the links in shared
//       memory and one thread walks the rows from row 0, variant 0 (the
//       true start).  A row entered by a handoff (a miss) needs a
//       re-decode from its known entry (RECOVER); the walk continues
//       through the row's majority link and stops the frame when there is
//       none.  jt_rstless_recover re-decodes every RECOVER row with the
//       tail walk into its override row (and, while the re-decode misses
//       again, the rows after it); the host walks again until a walk counts
//       no RECOVER row.  Each round settles at least the first unsettled
//       row of every frame, so the loop ends.
//   K10 jt_rstless_final: one thread per row decodes exactly its blocks
//       from its entry into their plane rows (row-local DC predictors) and
//       sums its DC per component; jt_rstless_dc_fix adds each row's
//       per-frame, per-component DC prefix (a torch cumsum between the two
//       launches) to its blocks' DC.
//
// What bounds it on the H100.  The work is a dependent chain per symbol
// (window, table lookup, length, bit position) in every thread, and every
// bit of the segment is decoded about 1 + strip/chunk times per variant in
// K8 (bpm variants) and once more in K10.  The bytes are small (the
// segment, the membership map, the coefficients), so the kernels sit far
// above their memory bound and near a latency bound: the design keeps the
// decode loop of decode_segments.cu (12-bit first-level lookup table in
// shared memory, a register lookahead over the words) and makes the chunk
// small enough that a batch of frames puts several warps on each SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Packed table layout (int32); entropy/place_cuda.py builds it, the same
// as decode_segments.cu's.
constexpr int T_MAX = 8;
constexpr int SLOTS = 16;
constexpr int C_MAX = 4;
constexpr int LUT_BITS = 12;
constexpr int LUT_SIZE = 1 << LUT_BITS;
constexpr int OFF_MAXCODE = 0;
constexpr int OFF_MINCODE = OFF_MAXCODE + T_MAX * 17;
constexpr int OFF_VALPTR = OFF_MINCODE + T_MAX * 17;
constexpr int OFF_HUFFVAL = OFF_VALPTR + T_MAX * 17;
constexpr int OFF_SLOT_COMP = OFF_HUFFVAL + T_MAX * 256;
constexpr int OFF_SLOT_DC = OFF_SLOT_COMP + SLOTS;
constexpr int OFF_SLOT_AC = OFF_SLOT_DC + SLOTS;
constexpr int OFF_C0 = OFF_SLOT_AC + SLOTS;
constexpr int OFF_C1 = OFF_C0 + SLOTS;
constexpr int OFF_C2 = OFF_C1 + SLOTS;
constexpr int OFF_BLK_END = OFF_C2 + SLOTS;
constexpr int OFF_ZIGZAG = OFF_BLK_END + SLOTS;
constexpr int OFF_LUT = OFF_ZIGZAG + 64;
constexpr int TABLE_INTS = OFF_LUT + T_MAX * LUT_SIZE / 2;

// links / override columns and codes (speculative_torch.py)
constexpr int NCOL = 5;  // status, bit, slot, ordinal, payload
constexpr int OCOL = 3 + NCOL;  // valid, entry bit, entry slot, links row
constexpr int ST_LINK = 0, ST_MISS = 1, ST_END = 2;
constexpr int SETTLED = 0, RECOVER = 1, PENDING = 2;

constexpr int THREADS = 64;        // K8 walks: threads per CTA
constexpr int ROW_THREADS = 32;    // per-row walks (K9 re-decode, K10): a
                                   // batch has ~bpm times fewer rows than
                                   // K8 threads, so smaller CTAs spread
                                   // them over more SMs
constexpr int WALK_THREADS = 128;  // resolve walk: stagers per frame

struct Params {
  int wn;           // u32 words per frame row
  int bpm;          // blocks per MCU
  int n_mcus;       // MCUs per frame
  int m_x;          // MCU-row width of the block affinities
  int vpad;         // huffval index clip
  int tab_ints;     // ints of `tables` staged in shared memory
  int cb_bits;      // chunk row bits
  int strip_bits;   // head strip bits
  int total_blocks; // blocks per frame
};

// Rows of the batch: frame f owns rows row0[f] .. row0[f + 1] - 1.
struct Rows {
  const int32_t* row0;       // [F + 1]
  const int32_t* row_frame;  // [R]
  int R;
};

__device__ __forceinline__ void stage_tables(int32_t* tab,
                                             const int32_t* tables,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
}

// One thread's decoder: bit position, a 64-bit window of words widx and
// widx + 1, and a lookahead of word widx + 2.
struct Decoder {
  const uint32_t* row;
  int wn, nb, bitpos, widx;
  uint64_t buf;
  uint32_t ahead;
  int slot, coeff, blk;

  __device__ uint32_t word(int i) const {
    return i < wn ? __ldg(row + i) : 0u;
  }
  __device__ void start(const uint32_t* r, int wn_, int nb_, int bit,
                        int slot_) {
    row = r;
    wn = wn_;
    nb = nb_;
    bitpos = bit;
    widx = bit >> 5;
    buf = (static_cast<uint64_t>(word(widx)) << 32) | word(widx + 1);
    ahead = word(widx + 2);
    slot = slot_;
    coeff = 0;
    blk = 0;
  }
  __device__ void consume(int need) {
    bitpos += need;
    const int nw = bitpos >> 5;  // a symbol crosses at most one word
    if (nw != widx) {
      widx = nw;
      buf = (buf << 32) | ahead;
      ahead = word(widx + 2);
    }
  }
};

struct Sym {
  int need, coef_val, new_coeff, after;
  bool is_dc, is_eob, done;
};

// Decode the symbol at d.bitpos; false when the lane dies on it (no code
// matches, a DC category above 16, a symbol past the segment's end, an AC
// run past coefficient 63), exactly the restart kernels' rules.
__device__ __forceinline__ bool symbol(const int32_t* tab, const Params& p,
                                       const Decoder& d, Sym& s) {
  const uint32_t win =
      static_cast<uint32_t>((d.buf << (d.bitpos & 31)) >> 32);
  const bool is_dc = d.coeff == 0;
  const int t = is_dc ? tab[OFF_SLOT_DC + d.slot] : tab[OFF_SLOT_AC + d.slot];
  const uint16_t* lut = reinterpret_cast<const uint16_t*>(tab + OFF_LUT);
  const int e = lut[t * LUT_SIZE + (win >> (32 - LUT_BITS))];
  int length, value;
  if (e != 0) {
    length = e >> 8;
    value = e & 0xFF;
  } else {
    const int code16 = static_cast<int>(win >> 16);
    const int* maxcode = tab + OFF_MAXCODE + t * 17;
    length = 0;
#pragma unroll
    for (int l = 16; l > LUT_BITS; --l)
      if ((code16 >> (16 - l)) <= maxcode[l]) length = l;
    if (length == 0) return false;
    const int vidx = tab[OFF_VALPTR + t * 17 + length] +
                     (code16 >> (16 - length)) -
                     tab[OFF_MINCODE + t * 17 + length];
    value = tab[OFF_HUFFVAL + t * 256 + min(max(vidx, 0), p.vpad - 1)];
  }
  if (is_dc && value > 16) return false;
  const int cat = is_dc ? value : (value & 15);
  const int need = length + cat;
  if (d.bitpos + need > d.nb) return false;
  const int extra =
      static_cast<int>((win >> (32 - need)) & ((1u << cat) - 1u));
  s.coef_val = cat == 0 ? 0
                        : ((extra >> (cat - 1)) ? extra
                                                : extra - (1 << cat) + 1);
  s.is_dc = is_dc;
  s.is_eob = !is_dc && value == 0;
  s.new_coeff = is_dc ? 1 : d.coeff + (value >> 4);
  if (!is_dc && !s.is_eob && s.new_coeff > 63) return false;
  s.after = is_dc ? 1 : s.new_coeff + 1;
  s.done = s.is_eob || s.after >= 64;
  s.need = need;
  return true;
}

__device__ __forceinline__ void advance(Decoder& d, const Sym& s, int bpm) {
  if (s.done) {
    d.coeff = 0;
    ++d.blk;
    if (++d.slot >= bpm) d.slot = 0;
  } else {
    d.coeff = s.after;
  }
  d.consume(s.need);
}

// K8 head walk: one thread per (row, variant).
__global__ void __launch_bounds__(THREADS)
head_kernel(const int32_t* __restrict__ tables,
            const uint32_t* __restrict__ words,
            const int32_t* __restrict__ nbits, Rows rows, Params p,
            int32_t* __restrict__ member) {
  extern __shared__ int32_t tab[];
  stage_tables(tab, tables, p.tab_ints);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= rows.R * p.bpm) return;
  const int row = lane / p.bpm, v = lane - row * p.bpm;
  const int f = rows.row_frame[row];
  const int start = (row - rows.row0[f]) * p.cb_bits;
  Decoder d;
  d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f], start, v);
  Sym s;
  while (true) {
    const int rel = d.bitpos - start;
    if (rel >= p.strip_bits) break;
    if (d.coeff == 0)
      atomicMax(member + (static_cast<int64_t>(row) * p.strip_bits + rel) *
                             p.bpm + d.slot,
                ((d.blk << 4) | v) + 1);
    if (!symbol(tab, p, d, s)) break;
    advance(d, s, p.bpm);
  }
}

// The tail walk of K8 and of K9's re-decode: from (bit, slot) in chunk row
// `row` to a link into the successor's membership, a miss or the end.
__device__ void tail_walk(const int32_t* tab, const Params& p,
                          const uint32_t* words, const int32_t* nbits,
                          const Rows& rows, const int32_t* member, int row,
                          int bit, int slot, int32_t* out) {
  const int f = rows.row_frame[row];
  const int local = row - rows.row0[f];
  const bool last = rows.row0[f] + local + 1 == rows.row0[f + 1];
  const int next_start = (local + 1) * p.cb_bits;
  Decoder d;
  d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f], bit, slot);
  bool crossed = false;
  int c_bit = 0, c_slot = 0, c_m = 0;
  Sym s;
  int st, o_bit, o_slot, o_m, o_pay = -1;
  while (true) {
    const int rel = d.bitpos - next_start;
    if (d.coeff == 0 && !last && rel >= 0) {
      if (!crossed) {
        crossed = true;
        c_bit = d.bitpos;
        c_slot = d.slot;
        c_m = d.blk;
      }
      if (rel < p.strip_bits) {
        const int look =
            member[(static_cast<int64_t>(row + 1) * p.strip_bits + rel) *
                       p.bpm + d.slot];
        if (look > 0) {
          st = ST_LINK, o_bit = d.bitpos, o_slot = d.slot, o_m = d.blk;
          o_pay = look - 1;
          break;
        }
      } else {
        st = ST_MISS, o_bit = c_bit, o_slot = c_slot, o_m = c_m;
        break;
      }
    }
    if (!symbol(tab, p, d, s)) {
      st = ST_END, o_bit = d.bitpos, o_slot = d.slot, o_m = d.blk;
      break;
    }
    advance(d, s, p.bpm);
  }
  out[0] = st;
  out[1] = o_bit;
  out[2] = o_slot;
  out[3] = o_m;
  out[4] = o_pay;
}

// K8 tail walk: one thread per (row, variant).
__global__ void __launch_bounds__(THREADS)
tail_kernel(const int32_t* __restrict__ tables,
            const uint32_t* __restrict__ words,
            const int32_t* __restrict__ nbits, Rows rows, Params p,
            const int32_t* __restrict__ member, int32_t* __restrict__ links) {
  extern __shared__ int32_t tab[];
  stage_tables(tab, tables, p.tab_ints);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= rows.R * p.bpm) return;
  const int row = lane / p.bpm, v = lane - row * p.bpm;
  const int start = (row - rows.row0[rows.row_frame[row]]) * p.cb_bits;
  tail_walk(tab, p, words, nbits, rows, member, row, start, v,
            links + static_cast<int64_t>(lane) * NCOL);
}

// K9 re-decode: one thread per RECOVER row.  A row whose re-decode misses
// again hands its crossing to the row that holds it, so the thread goes on
// there (the rows between are empty) until a link, the segment's end, or
// a row of its own frame that is RECOVER itself, whose thread owns it: one
// round then settles a run of rows whose variants never meet the true
// decode (content that does not resynchronize within a strip).
__global__ void __launch_bounds__(ROW_THREADS)
recover_kernel(const int32_t* __restrict__ tables,
               const uint32_t* __restrict__ words,
               const int32_t* __restrict__ nbits, Rows rows, Params p,
               const int32_t* __restrict__ member,
               const int32_t* __restrict__ f_bit,
               const int32_t* __restrict__ f_slot,
               const int32_t* __restrict__ state, int32_t* __restrict__ ovr) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = row < rows.R && state[row] == RECOVER;
  if (!__syncthreads_or(mine)) return;
  extern __shared__ int32_t tab[];
  stage_tables(tab, tables, p.tab_ints);
  if (!mine) return;
  const int f = rows.row_frame[row];
  const int q0 = rows.row0[f], q1 = rows.row0[f + 1];
  int q = row, bit = f_bit[row], slot = f_slot[row];
  while (true) {
    int32_t* o = ovr + static_cast<int64_t>(q) * OCOL;
    int32_t res[NCOL];
    tail_walk(tab, p, words, nbits, rows, member, q, bit, slot, res);
    o[0] = 1;
    o[1] = bit;
    o[2] = slot;
    for (int c = 0; c < NCOL; ++c) o[3 + c] = res[c];
    if (res[0] != ST_MISS) break;
    const int q2 = q0 + res[1] / p.cb_bits;  // the row of the crossing
    if (q2 >= q1) break;
    bool owned = false;
    for (int r = q + 1; r <= q2; ++r) owned = owned || state[r] == RECOVER;
    if (owned) break;
    q = q2;
    bit = res[1];
    slot = res[2];
  }
}

// K9 walk: one CTA per frame.  The CTA stages a tile of rows' links and
// override rows in shared memory; thread 0 walks them (its walk state
// carries over from tile to tile).
__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const int32_t* __restrict__ links,
            const int32_t* __restrict__ ovr,
            const int32_t* __restrict__ row0, int bpm, int cb_bits,
            int tile_rows, int32_t* __restrict__ f_bit,
            int32_t* __restrict__ f_slot, int32_t* __restrict__ nblk,
            int32_t* __restrict__ state, int32_t* __restrict__ frame_bad,
            int32_t* __restrict__ n_rec) {
  extern __shared__ int32_t sm[];
  int32_t* s_links = sm;
  int32_t* s_ovr = sm + tile_rows * bpm * NCOL;
  const int f = blockIdx.x;
  const int q0 = row0[f], q1 = row0[f + 1];
  int e_bit = 0, e_slot = 0, src = 0, k = 0, nrec = 0, bad = 0;
  bool handoff = false, ended = false, blocked = false;
  for (int t0 = q0; t0 < q1; t0 += tile_rows) {
    const int n = min(tile_rows, q1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * bpm * NCOL; i += blockDim.x)
      s_links[i] = links[static_cast<int64_t>(t0) * bpm * NCOL + i];
    for (int i = threadIdx.x; i < n * OCOL; i += blockDim.x)
      s_ovr[i] = ovr[static_cast<int64_t>(t0) * OCOL + i];
    __syncthreads();
    if (threadIdx.x != 0) continue;
    for (int i = 0; i < n; ++i) {
      const int q = t0 + i, li = q - q0;
      int st = SETTLED, fb = 0, fs = 0, nb = 0;
      if (blocked) {
        st = PENDING;
      } else {
        fb = e_bit;
        fs = e_slot;
        if (!ended && e_bit < (li + 1) * cb_bits) {  // else an empty row
          const int32_t* o = s_ovr + i * OCOL;
          const int32_t* rec = nullptr;
          if (o[0] && o[1] == e_bit && o[2] == e_slot) {
            rec = o + 3;
            k = 0;
          } else if (!handoff) {
            rec = s_links + (i * bpm + src) * NCOL;
          } else {
            st = RECOVER;
            ++nrec;
            // optimistic continuation: the majority link of the row's
            // variants (same next bit, slot and payload), lowest variant
            // first among equals
            const int32_t* lk = s_links + i * bpm * NCOL;
            int best = -1, best_c = 0;
            for (int w = 0; w < bpm; ++w) {
              const int32_t* a = lk + w * NCOL;
              if (a[0] != ST_LINK) continue;
              int c = 0;
              for (int w2 = 0; w2 < bpm; ++w2) {
                const int32_t* b = lk + w2 * NCOL;
                c += b[0] == ST_LINK && b[1] == a[1] && b[2] == a[2] &&
                     b[4] == a[4];
              }
              if (c > best_c) best_c = c, best = w;
            }
            if (best < 0) {
              blocked = true;
            } else {
              const int32_t* a = lk + best * NCOL;
              e_bit = a[1];
              e_slot = a[2];
              src = a[4] & 15;
              k = a[4] >> 4;
              handoff = false;
            }
          }
          if (rec != nullptr) {
            const int m = rec[3] - k;
            if (m < 0) {
              bad = 1;
              blocked = true;
              st = PENDING;
            } else {
              nb = m;
              e_bit = rec[1];
              e_slot = rec[2];
              if (rec[0] == ST_LINK) {
                src = rec[4] & 15;
                k = rec[4] >> 4;
                handoff = false;
              } else if (rec[0] == ST_MISS) {
                k = 0;
                handoff = true;
              } else {
                ended = true;
              }
            }
          }
        }
      }
      f_bit[q] = fb;
      f_slot[q] = fs;
      nblk[q] = nb;
      state[q] = st;
    }
  }
  if (threadIdx.x == 0) {
    frame_bad[f] = bad;
    if (nrec) atomicAdd(n_rec, nrec);
  }
}

// Frame-relative block `rel` of frame-local block ordinal gblk in `slot`;
// false when the block lies outside the frame (the restart kernels'
// affinities and guard).
__device__ __forceinline__ bool place(const int32_t* tab, const Params& p,
                                      int f, int64_t gblk, int slot,
                                      int64_t& dst) {
  const int64_t mcu = gblk / p.bpm;
  const int64_t my = mcu / p.m_x;
  const int64_t rel = tab[OFF_C0 + slot] + my * tab[OFF_C1 + slot] +
                      (mcu - my * p.m_x) * tab[OFF_C2 + slot];
  dst = (static_cast<int64_t>(f) * p.total_blocks + rel) * 64;
  return mcu < p.n_mcus && rel < tab[OFF_BLK_END + slot];
}

// K10 walk: one thread per row decodes its nblk blocks from its entry.
__global__ void __launch_bounds__(ROW_THREADS)
final_kernel(const int32_t* __restrict__ tables,
             const uint32_t* __restrict__ words,
             const int32_t* __restrict__ nbits, Rows rows, Params p,
             const int32_t* __restrict__ f_bit,
             const int32_t* __restrict__ f_slot,
             const int32_t* __restrict__ nblk,
             const int32_t* __restrict__ g0, int32_t* __restrict__ coeffs,
             int32_t* __restrict__ dc_sum, int32_t* __restrict__ ok) {
  extern __shared__ int32_t tab[];
  stage_tables(tab, tables, p.tab_ints);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows.R) return;
  const int n = nblk[row], g = g0[row];
  const int f = rows.row_frame[row];
  bool good = !(n > 0 && g % p.bpm != f_slot[row]);
  uint32_t pred[C_MAX] = {0u, 0u, 0u, 0u};
  if (n > 0 && good) {
    Decoder d;
    d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f],
            f_bit[row], f_slot[row]);
    int64_t dst = 0;
    bool valid = place(tab, p, f, g, d.slot, dst);
    int cur = 0;
    Sym s;
    while (true) {
      if (!symbol(tab, p, d, s)) {
        good = false;
        break;
      }
      if (valid && !s.is_dc && !s.is_eob)
        coeffs[dst + tab[OFF_ZIGZAG + s.new_coeff]] = s.coef_val;
      if (s.is_dc) cur = s.coef_val;
      if (s.done) {
        const int c = tab[OFF_SLOT_COMP + d.slot];
        const uint32_t dc = pred[c] + static_cast<uint32_t>(cur);
        if (valid) coeffs[dst] = static_cast<int32_t>(dc);
        pred[c] = dc;
        advance(d, s, p.bpm);
        if (d.blk == n) break;
        valid = place(tab, p, f, static_cast<int64_t>(g) + d.blk, d.slot,
                      dst);
      } else {
        advance(d, s, p.bpm);
      }
    }
  }
  for (int c = 0; c < C_MAX; ++c)
    dc_sum[static_cast<int64_t>(row) * C_MAX + c] =
        static_cast<int32_t>(pred[c]);
  ok[row] = good ? 1 : 0;
}

// K10 DC pass: one thread per row adds its DC base to its blocks' DC.
__global__ void __launch_bounds__(ROW_THREADS)
dc_fix_kernel(const int32_t* __restrict__ tables, Rows rows, Params p,
              const int32_t* __restrict__ nblk,
              const int32_t* __restrict__ g0,
              const int32_t* __restrict__ base,
              int32_t* __restrict__ coeffs) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows.R) return;
  const int n = nblk[row];
  const int f = rows.row_frame[row];
  const int32_t* b = base + static_cast<int64_t>(row) * C_MAX;
  for (int i = 0; i < n; ++i) {
    const int64_t gblk = static_cast<int64_t>(g0[row]) + i;
    const int slot = static_cast<int>(gblk % p.bpm);
    int64_t dst;
    if (place(tables, p, f, gblk, slot, dst))
      coeffs[dst] = static_cast<int32_t>(
          static_cast<uint32_t>(coeffs[dst]) +
          static_cast<uint32_t>(b[tables[OFF_SLOT_COMP + slot]]));
  }
}

template <typename Kernel>
int set_smem(Kernel kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int check_params(const Params& p) {
  if (p.tab_ints <= 0 || p.tab_ints > TABLE_INTS || p.bpm <= 0 ||
      p.bpm > SLOTS || p.cb_bits <= 0 || p.strip_bits <= 0 ||
      p.strip_bits > p.cb_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int jt_decode_rstless_table_ints() { return TABLE_INTS; }
extern "C" int jt_decode_rstless_ncol() { return NCOL; }

// K8: head walk, then tail walk, on `stream`.  `member` must be zeroed.
extern "C" int jt_rstless_sync(const void* tables, const void* words,
                               const void* nbits, const void* row0,
                               const void* row_frame, void* member,
                               void* links, int R, int wn, int bpm,
                               int vpad, int tab_ints, int cb_bits,
                               int strip_bits, void* stream) {
  const Params p{wn, bpm, 0, 1, vpad, tab_ints, cb_bits, strip_bits, 0};
  int rc = check_params(p);
  if (rc != 0 || R <= 0) return rc;
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const size_t smem = sizeof(int32_t) * tab_ints;
  const int blocks = (R * bpm + THREADS - 1) / THREADS;
  auto s = static_cast<cudaStream_t>(stream);
  if ((rc = set_smem(head_kernel, smem)))
    return rc;
  if ((rc = set_smem(tail_kernel, smem)))
    return rc;
  head_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<int32_t*>(member));
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  tail_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(member), static_cast<int32_t*>(links));
  return static_cast<int>(cudaGetLastError());
}

// K9 walk of F frames on `stream`; `n_rec` must be zeroed.
extern "C" int jt_rstless_walk(const void* links, const void* ovr,
                               const void* row0, void* f_bit, void* f_slot,
                               void* nblk, void* state, void* frame_bad,
                               void* n_rec, int F, int bpm, int cb_bits,
                               int tile_rows, void* stream) {
  if (F <= 0) return 0;
  if (bpm <= 0 || bpm > SLOTS || tile_rows <= 0 || cb_bits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) * tile_rows * (bpm * NCOL + OCOL);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  walk_kernel<<<F, WALK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(links), static_cast<const int32_t*>(ovr),
      static_cast<const int32_t*>(row0), bpm, cb_bits, tile_rows,
      static_cast<int32_t*>(f_bit), static_cast<int32_t*>(f_slot),
      static_cast<int32_t*>(nblk), static_cast<int32_t*>(state),
      static_cast<int32_t*>(frame_bad), static_cast<int32_t*>(n_rec));
  return static_cast<int>(cudaGetLastError());
}

// K9 re-decode of the RECOVER rows into their override rows, on `stream`.
extern "C" int jt_rstless_recover(const void* tables, const void* words,
                                  const void* nbits, const void* row0,
                                  const void* row_frame, const void* member,
                                  const void* f_bit, const void* f_slot,
                                  const void* state, void* ovr, int R,
                                  int wn, int bpm, int vpad, int tab_ints,
                                  int cb_bits, int strip_bits,
                                  void* stream) {
  const Params p{wn, bpm, 0, 1, vpad, tab_ints, cb_bits, strip_bits, 0};
  int rc = check_params(p);
  if (rc != 0 || R <= 0) return rc;
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const size_t smem = sizeof(int32_t) * tab_ints;
  if ((rc = set_smem(recover_kernel, smem)))
    return rc;
  recover_kernel<<<(R + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(f_bit),
      static_cast<const int32_t*>(f_slot),
      static_cast<const int32_t*>(state), static_cast<int32_t*>(ovr));
  return static_cast<int>(cudaGetLastError());
}

// K10 walk on `stream`; `coeffs` must be zeroed.
extern "C" int jt_rstless_final(const void* tables, const void* words,
                                const void* nbits, const void* row0,
                                const void* row_frame, const void* f_bit,
                                const void* f_slot, const void* nblk,
                                const void* g0, void* coeffs, void* dc_sum,
                                void* ok, int R, int wn, int bpm,
                                int n_mcus, int m_x, int vpad, int tab_ints,
                                int total_blocks, void* stream) {
  const Params p{wn, bpm, n_mcus, m_x, vpad, tab_ints, 1, 1, total_blocks};
  int rc = check_params(p);
  if (rc != 0 || R <= 0) return rc;
  if (m_x <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const size_t smem = sizeof(int32_t) * tab_ints;
  if ((rc = set_smem(final_kernel, smem)))
    return rc;
  final_kernel<<<(R + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(f_bit),
      static_cast<const int32_t*>(f_slot),
      static_cast<const int32_t*>(nblk), static_cast<const int32_t*>(g0),
      static_cast<int32_t*>(coeffs), static_cast<int32_t*>(dc_sum),
      static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// K10 DC pass on `stream`.
extern "C" int jt_rstless_dc_fix(const void* tables, const void* row0,
                                 const void* row_frame, const void* nblk,
                                 const void* g0, const void* base,
                                 void* coeffs, int R, int bpm, int n_mcus,
                                 int m_x, int total_blocks, void* stream) {
  if (R <= 0) return 0;
  if (bpm <= 0 || bpm > SLOTS || m_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{0, bpm, n_mcus, m_x, 0, 0, 1, 1, total_blocks};
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  dc_fix_kernel<<<(R + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables), rows, p,
      static_cast<const int32_t*>(nblk), static_cast<const int32_t*>(g0),
      static_cast<const int32_t*>(base), static_cast<int32_t*>(coeffs));
  return static_cast<int>(cudaGetLastError());
}
