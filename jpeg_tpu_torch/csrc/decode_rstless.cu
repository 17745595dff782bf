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
// A row is further cut into P pieces of piece_bits bits for the final
// decode.
//
//   K8  jt_rstless_sync, two launches:
//       head  a CTA holds the bpm variants of each of its rows.  Every
//             (row, variant) thread decodes the row's first strip_bits
//             bits, raises member[row, bit, slot] to ((ordinal << 4) |
//             variant) + 1 at each block start (atomicMax:
//             deterministic), marks the piece boundaries it passes, and
//             stops at its strip mark: the first block start at or after
//             row_start + strip_bits (bit, slot, ordinal), or where it dies
//             (ST_END: its links row is final).  Behind one barrier the
//             CTA groups each row's variants by strip mark: from an equal
//             (bit, slot) two decodes are one, so only the lowest variant
//             of a group (its survivor) decodes on.  The survivors go to
//             a list on the card (one atomicAdd a CTA for its place);
//       tail  one thread per survivor, packed densely into warps, resumes
//             at its strip mark (no bit of the strip is decoded twice) and
//             decodes through the row into the successor row, stopping at
//             the first block start present in the successor's membership
//             (ST_LINK: the state, its own ordinal there and the
//             successor's variant and ordinal), or past the successor's
//             strip (ST_MISS: its crossing, the first block start at or
//             after the successor's first bit), or where it dies (ST_END;
//             a frame's last row always decodes to the segment's end).  On
//             the way it marks, for each piece boundary j after its strip
//             mark, the first block start at or after row_start + j *
//             piece_bits (bit, slot, ordinal; ordinal MARK_NONE where it
//             stopped before).  It then writes its links row and those
//             marks for every member of its group, each ordinal shifted by
//             the member's ordinal less its own at the strip mark (the
//             splice K9 makes too), so links and marks are those of an
//             every-variant walk from each row's first bit.
//   K9  jt_rstless_resolve, one launch, one CTA per frame (a frame's rows
//       depend only on its own rows, so no grid barrier is needed).  The
//       CTA stages the code tables and the frame's links and override rows
//       (tiles of rows when the frame does not fit) in shared memory.
//       Thread 0 walks the rows from row 0, variant 0 (the true start) into
//       shared memory, and the CTA copies the rows' outputs out: a row
//       entered by a handoff (a miss) needs a re-decode from its known
//       entry (RECOVER); the walk continues through the row's majority
//       link and stops the frame when there is none.  The CTA's threads
//       then re-decode the frame's RECOVER rows in parallel with the tail
//       walk into their override rows (and, while a re-decode misses
//       again, the rows after it, up to a row another chain owns); a
//       re-decode whose mark at a piece boundary is also a K8 variant's
//       mark there takes that variant's link and later marks (the two
//       decodes are one from there), so it rarely decodes past a piece.
//       The CTA walks again, until a walk counts no RECOVER row or the
//       frame reaches max_rounds.  Each round settles at least the first
//       unsettled row, so the loop ends.  The kernel then counts the
//       frame's mispredicts (rows its first walk settled at an entry the
//       last walk does not keep), writes the frame's stats, and lays out
//       the pieces: a row settled through variant `src` at its ordinal k
//       holds that decode's blocks [k, k + nblk), so the marks of `src`
//       inside that range are true block starts of the row (an override
//       row: its own marks in [0, nblk)).  Piece j of the row runs from
//       its mark (or the row's entry) to the next: (bit, slot, first
//       block, count).  Nothing is read back by the host.
//   K10 jt_rstless_final, two launches: one thread per piece decodes
//       exactly its blocks from its entry, assembles each block in shared
//       memory and writes it whole into its plane row (piece-local DC
//       predictors), and sums its DC per component; the DC pass (a CTA
//       per tile of a frame's rows) adds to each piece's blocks the
//       frame's exclusive prefix of those sums, computed in the CTA, and
//       writes each row's ok bit (all of its pieces decoded their blocks
//       from a slot that matches their first block's).
//
// What bounds it on the H100.  The work is a dependent chain per symbol
// (window, table lookups, length, bit position) in every thread: ~230 ns a
// symbol for a lone thread (two dependent L1 lookups and ~40 dependent
// ALU steps).  The bytes are small (the segment, the membership map, the
// coefficients), so the kernels sit far above their memory bound and near
// a latency bound: the length of the longest chain and how much a warp's
// divergent lanes stretch each step.  The design keeps the decode loop of
// decode_segments.cu (12-bit first-level lookup table, a register
// lookahead over the words).  K8 decodes each row's strip once per
// variant and the rest of the row once per distinct decode: a row's
// variants mostly meet within the strip, so the tail walk runs a few
// survivors a row from the strip's end, not every variant from the row's
// first bit; and both walks put only a few walking threads in a warp (16,
// 4), since a warp of 32 distinct decodes diverges at every branch of the
// step, and read the tables through L1.  The tail walk then takes about
// its longest survivor's chain.  K10 gets chains of one piece (1/P of a
// row), so a batch puts ~P times as many threads on the SMs, and reads the
// tables through L1 rather than stage them per CTA (44 KB of tables for
// 64 threads that decode 2 KB cost more than the lookups save).  K9 stays
// on the card: its walks are short sequential scans of shared memory by
// one thread a frame, which bound it, and its re-decodes are few and
// short, so a host read a round costs more than the work.
//
// Layout contract (entropy/speculative_torch.py has the same):
//   links   [R * bpm, NCOL]     marks      [R * bpm, P - 1, MCOL]
//   scratch (K8): group [R * bpm, GCOL], survivors [1 + R * bpm] (count,
//   then lanes)
//   row_out [RCOL, R]           frame_out  [F, SCOL]
//   pieces  [R * P, PCOL]       scratch (K9): ovr [R, OCOL], override
//   marks [R, P - 1, MCOL], first walk [3, R]; (K10): piece DC sums
//   [R * P, C_MAX], piece ok [R * P].

#include <climits>
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

// Columns and codes (speculative_torch.py)
constexpr int NCOL = 5;         // links: status, bit, slot, ordinal, payload
constexpr int OCOL = 3 + NCOL;  // override: valid, entry bit, entry slot, links row
constexpr int MCOL = 3;         // marks: bit, slot, ordinal
constexpr int GCOL = 4;         // group: strip-mark bit, slot, ordinal,
                                // survivor variant (-1: ended in the strip)
constexpr int PCOL = 4;         // pieces: entry bit, entry slot, first block, count
constexpr int RCOL = 7;         // row_out: entry bit, entry slot, blocks, state,
                                // source variant (-1: override), ordinal there,
                                // first block (frame-local)
constexpr int SCOL = 5;         // frame_out: rounds, recovery rows, mispredicts,
                                // max_rounds reached, walk refused the frame
constexpr int MARK_NONE = INT_MAX;
constexpr int ST_LINK = 0, ST_MISS = 1, ST_END = 2;
constexpr int SETTLED = 0, RECOVER = 1, PENDING = 2;

constexpr int SYNC_LANES = 64;        // K8 head walk: lanes a CTA (whole rows)
constexpr int HEAD_LANES = 16;        // K8 head walk: walking threads a warp
constexpr int TAIL_LANES = 4;         // K8 tail walk: walking threads a warp
constexpr int SYNC_BOUND = 512;       // K8 walks: their launch bounds
constexpr int TAIL_WARPS = 2;         // K8 tail walk: warps a CTA
constexpr int RESOLVE_THREADS = 256;  // K9: stagers and re-decoders per frame
constexpr int PIECE_THREADS = 64;     // K10 walk: a thread per piece
constexpr int FINAL_BOUND = 256;      // K10 walk: its launch bounds
constexpr int DC_THREADS = 256;       // K10 DC pass: a thread per piece
constexpr int MAX_SMEM = 232448;      // dynamic shared memory a CTA can opt in to

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
  int piece_bits;   // piece bits of the final decode
  int n_pieces;     // pieces a row: ceil(cb_bits / piece_bits)
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

// Marks piece boundaries j, j + 1, ... up to the block start at d.bitpos
// with its state (bit, slot, ordinal); mark_at is boundary j's bit.
__device__ __forceinline__ void mark_to(const Params& p, const Decoder& d,
                                        int& j, int& mark_at,
                                        int32_t* marks) {
  for (; j < p.n_pieces && d.bitpos >= mark_at;
       ++j, mark_at += p.piece_bits) {
    int32_t* m = marks + (j - 1) * MCOL;
    m[0] = d.bitpos;
    m[1] = d.slot;
    m[2] = d.blk;
  }
  if (j == p.n_pieces) mark_at = INT_MAX;
}

__device__ __forceinline__ void write_link(int32_t* out, int st, int bit,
                                           int slot, int m, int pay) {
  out[0] = st;
  out[1] = bit;
  out[2] = slot;
  out[3] = m;
  out[4] = pay;
}

// K8 head walk: a CTA of rows_per_cta rows x bpm variants, a thread per
// (row, variant), decodes each row's strip into the membership map and
// its marks, to its strip mark; then groups each row's variants by strip
// mark and lists the survivors (`survivors`: count, then lanes).  Only the
// first HEAD_LANES threads of each warp walk (logical lane warp *
// HEAD_LANES + lane): a warp's distinct decodes diverge at the branches of
// the symbol step, so fewer of them a warp, in more warps, shorten each
// step; 16 in the head and 4 in the tail gave the shortest walks on an
// H100 over 32, 16, 8 and 4 (PERF.md).  The code tables are read through
// L1 (staging them a CTA measured slower).
__global__ void __launch_bounds__(SYNC_BOUND)
head_kernel(const int32_t* __restrict__ tab,
            const uint32_t* __restrict__ words,
            const int32_t* __restrict__ nbits, Rows rows, Params p,
            int rows_per_cta, int32_t* __restrict__ member,
            int32_t* __restrict__ links, int32_t* __restrict__ marks,
            int32_t* __restrict__ group, int32_t* __restrict__ survivors) {
  __shared__ int32_t s_st[2 * SYNC_LANES];  // a lane's strip mark: bit, slot
  __shared__ int s_n, s_base;
  if (threadIdx.x == 0) s_n = 0;
  const int wl = threadIdx.x & 31;
  const int n_lanes = rows_per_cta * p.bpm;
  const int li =
      wl < HEAD_LANES ? (threadIdx.x >> 5) * HEAD_LANES + wl : n_lanes;
  const int v = li % p.bpm;
  const int row = blockIdx.x * rows_per_cta + li / p.bpm;
  const bool in = li < n_lanes && row < rows.R;
  const int M = p.n_pieces - 1;
  const int64_t lane = static_cast<int64_t>(row) * p.bpm + v;
  int bit = -1, slot = -1, blk = 0;  // bit -1: ended in the strip
  if (in) {
    const int f = rows.row_frame[row];
    const int start = (row - rows.row0[f]) * p.cb_bits;
    const int strip_end = start + p.strip_bits;
    int32_t* mk = marks + lane * M * MCOL;
    int j = 1;
    int mark_at = M > 0 ? start + p.piece_bits : INT_MAX;
    Decoder d;
    d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f], start,
            v);
    Sym s;
    while (true) {
      if (d.coeff == 0) {
        if (d.bitpos >= mark_at) mark_to(p, d, j, mark_at, mk);
        if (d.bitpos >= strip_end) {
          bit = d.bitpos;
          slot = d.slot;
          blk = d.blk;
          break;
        }
        atomicMax(member + (static_cast<int64_t>(row) * p.strip_bits +
                            d.bitpos - start) * p.bpm + d.slot,
                  ((d.blk << 4) | v) + 1);
      }
      if (!symbol(tab, p, d, s)) {
        write_link(links + lane * NCOL, ST_END, d.bitpos, d.slot, d.blk, -1);
        for (; j < p.n_pieces; ++j) {
          int32_t* m = mk + (j - 1) * MCOL;
          m[0] = -1;
          m[1] = -1;
          m[2] = MARK_NONE;
        }
        break;
      }
      advance(d, s, p.bpm);
    }
  }
  if (li < n_lanes) {
    s_st[2 * li] = bit;
    s_st[2 * li + 1] = slot;
  }
  __syncthreads();
  // The survivor of a group is its lowest variant; a thread that ended in
  // the strip has bit -1, which no strip mark equals.
  int srv = -1, at = 0;
  if (in && bit >= 0) {
    const int32_t* r0 = s_st + 2 * (li - v);
    srv = 0;
    while (srv < v && !(r0[2 * srv] == bit && r0[2 * srv + 1] == slot))
      ++srv;
    if (srv == v) at = atomicAdd(&s_n, 1);
  }
  if (in) {
    int32_t* g = group + lane * GCOL;
    g[0] = bit;
    g[1] = slot;
    g[2] = blk;
    g[3] = srv;
  }
  __syncthreads();
  if (threadIdx.x == 0) s_base = s_n > 0 ? atomicAdd(survivors, s_n) : 0;
  __syncthreads();
  if (in && bit >= 0 && srv == v)
    survivors[1 + s_base + at] = static_cast<int32_t>(lane);
}

// The tail walk of K8 and of K9's re-decode: from (bit, slot) in chunk row
// `row`, at ordinal blk0, to a link into the successor's membership, a miss
// or the end, marking the row's piece boundaries from j0 on the way
// (`marks`: P - 1 rows of MCOL; K8 resumes at a strip mark with the
// boundaries up to it marked, K9 starts a decode with j0 = 1).  A
// re-decode passes K8's marks and links (`sp_marks`, `sp_links`; K8 itself
// nullptr): where its last mark at a block start is also variant v's mark
// there (same bit and slot, lowest v first), the two decodes are one from
// there on, so it splices: v's links row and later marks, their ordinals
// shifted to its own count.
__device__ __forceinline__ void tail_walk(const int32_t* tab,
                                          const Params& p,
                          const uint32_t* words, const int32_t* nbits,
                          const Rows& rows, const int32_t* member, int row,
                          int bit, int slot, int blk0, int j0, int32_t* out,
                          int32_t* marks, const int32_t* sp_marks,
                          const int32_t* sp_links) {
  const int f = rows.row_frame[row];
  const int local = row - rows.row0[f];
  const bool last = rows.row0[f] + local + 1 == rows.row0[f + 1];
  const int next_start = (local + 1) * p.cb_bits;
  const int M = p.n_pieces - 1;
  // A block start needs a look only at or past the next piece boundary or
  // the successor's first bit: one compare on the common path, as a
  // decode without marks has.
  int j = j0;
  int mark_at = j < p.n_pieces ? local * p.cb_bits + j * p.piece_bits
                               : INT_MAX;
  const int link_at = last ? INT_MAX : next_start;
  int gate = min(mark_at, link_at);
  Decoder d;
  d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f], bit, slot);
  d.blk = blk0;
  bool crossed = false;
  int c_bit = 0, c_slot = 0, c_m = 0;
  Sym s;
  int st, o_bit, o_slot, o_m, o_pay = -1;
  while (true) {
    if (d.coeff == 0 && d.bitpos >= gate) {
      if (d.bitpos >= mark_at) {
        mark_to(p, d, j, mark_at, marks);
        gate = min(mark_at, link_at);
        if (sp_marks != nullptr) {
          int v = 0;
          const int32_t* vm = nullptr;
          for (; v < p.bpm; ++v) {
            vm = sp_marks +
                 ((static_cast<int64_t>(row) * p.bpm + v) * M + (j - 2)) *
                     MCOL;
            if (vm[0] == d.bitpos && vm[1] == d.slot) break;
          }
          if (v < p.bpm) {
            const int shift = d.blk - vm[2];
            const int32_t* vl =
                sp_links + (static_cast<int64_t>(row) * p.bpm + v) * NCOL;
            st = vl[0], o_bit = vl[1], o_slot = vl[2], o_m = vl[3] + shift;
            o_pay = vl[4];
            for (const int j1 = j; j < p.n_pieces; ++j) {  // v's later marks
              const int32_t* a = vm + (j - j1 + 1) * MCOL;
              int32_t* m = marks + (j - 1) * MCOL;
              m[0] = a[0];
              m[1] = a[1];
              m[2] = a[2] == MARK_NONE ? MARK_NONE : a[2] + shift;
            }
            break;
          }
        }
      }
      if (d.bitpos >= link_at) {
        const int rel = d.bitpos - next_start;
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
    }
    if (!symbol(tab, p, d, s)) {
      st = ST_END, o_bit = d.bitpos, o_slot = d.slot, o_m = d.blk;
      break;
    }
    advance(d, s, p.bpm);
  }
  for (; j < p.n_pieces; ++j) {
    int32_t* m = marks + (j - 1) * MCOL;
    m[0] = -1;
    m[1] = -1;
    m[2] = MARK_NONE;
  }
  write_link(out, st, o_bit, o_slot, o_m, o_pay);
}

// K8 tail walk: a thread per listed survivor, TAIL_LANES of them a warp
// (as the head walk), resumes at its strip mark, then writes its links row
// and later marks for each member of its group, their ordinals shifted.
// The grid covers every lane; CTAs past the count return at once.
__global__ void __launch_bounds__(SYNC_BOUND)
tail_kernel(const int32_t* __restrict__ tab,
            const uint32_t* __restrict__ words,
            const int32_t* __restrict__ nbits, Rows rows, Params p,
            const int32_t* __restrict__ member,
            const int32_t* __restrict__ group,
            const int32_t* __restrict__ survivors,
            int32_t* __restrict__ links, int32_t* __restrict__ marks) {
  const int n = survivors[0];
  const int per_cta = (blockDim.x >> 5) * TAIL_LANES;
  if (blockIdx.x * per_cta >= n) return;
  const int wl = threadIdx.x & 31;
  const int i = blockIdx.x * per_cta + (threadIdx.x >> 5) * TAIL_LANES + wl;
  if (wl >= TAIL_LANES || i >= n) return;
  const int lane = survivors[1 + i];
  const int row = lane / p.bpm, v = lane - row * p.bpm;
  const int M = p.n_pieces - 1;
  const int32_t* g = group + static_cast<int64_t>(lane) * GCOL;
  const int bit = g[0], slot = g[1], blk = g[2];
  const int start = (row - rows.row0[rows.row_frame[row]]) * p.cb_bits;
  const int j0 = min(p.n_pieces, (bit - start) / p.piece_bits + 1);
  int32_t* out = links + static_cast<int64_t>(lane) * NCOL;
  int32_t* mk = marks + static_cast<int64_t>(lane) * M * MCOL;
  tail_walk(tab, p, words, nbits, rows, member, row, bit, slot, blk, j0, out,
            mk, nullptr, nullptr);
  for (int w = v + 1; w < p.bpm; ++w) {
    const int64_t lw = static_cast<int64_t>(row) * p.bpm + w;
    const int32_t* gw = group + lw * GCOL;
    if (gw[3] != v) continue;
    const int shift = gw[2] - blk;
    write_link(links + lw * NCOL, out[0], out[1], out[2], out[3] + shift,
               out[4]);
    int32_t* mw = marks + lw * M * MCOL;
    for (int j = j0; j < p.n_pieces; ++j) {
      const int32_t* a = mk + (j - 1) * MCOL;
      int32_t* m = mw + (j - 1) * MCOL;
      m[0] = a[0];
      m[1] = a[1];
      m[2] = a[2] == MARK_NONE ? MARK_NONE : a[2] + shift;
    }
  }
}

// K9's outputs and scratch in device memory.
struct Resolve {
  int32_t* row;        // [RCOL, R] (row_out)
  int32_t* ovr;        // [R, OCOL]: override rows
  int32_t* ovr_marks;  // [R, P - 1, MCOL]: their marks
  int32_t* first;      // [3, R]: the first walk's entry bit, slot, state
};

// K9 walk of frame blockIdx.x, by the whole CTA: tiles of the frame's
// links and override rows are staged in shared memory and thread 0 walks
// them (its walk state carries over from tile to tile) into s_out [RCOL,
// tile_rows], which the CTA then copies out.  Thread 0 leaves the walk's
// RECOVER rows in s_res[0] and its refusal in s_res[1]; the first walk
// (`first_walk`) also keeps each row's entry and state.
__device__ void walk_frame(const int32_t* links, const Rows& rows,
                           const Params& p, int tile_rows, int32_t* s_links,
                           int32_t* s_ovr, int32_t* s_out, const Resolve& o,
                           bool first_walk, int* s_res) {
  const int f = blockIdx.x, bpm = p.bpm, cb_bits = p.cb_bits, R = rows.R;
  const int q0 = rows.row0[f], q1 = rows.row0[f + 1];
  int e_bit = 0, e_slot = 0, src = 0, k = 0, nrec = 0, bad = 0, gsum = 0;
  bool handoff = false, ended = false, blocked = false;
  for (int t0 = q0; t0 < q1; t0 += tile_rows) {
    const int n = min(tile_rows, q1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * bpm * NCOL; i += blockDim.x)
      s_links[i] = links[static_cast<int64_t>(t0) * bpm * NCOL + i];
    for (int i = threadIdx.x; i < n * OCOL; i += blockDim.x)
      s_ovr[i] = o.ovr[static_cast<int64_t>(t0) * OCOL + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int li = t0 + i - q0;
        int st = SETTLED, fb = 0, fs = 0, nb = 0, so = 0, ko = 0;
        if (blocked) {
          st = PENDING;
        } else {
          fb = e_bit;
          fs = e_slot;
          if (!ended && e_bit < (li + 1) * cb_bits) {  // else an empty row
            const int32_t* ov = s_ovr + i * OCOL;
            const int32_t* rec = nullptr;
            bool from_ovr = false;
            if (ov[0] && ov[1] == e_bit && ov[2] == e_slot) {
              rec = ov + 3;
              from_ovr = true;
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
                so = from_ovr ? -1 : src;
                ko = k;
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
        int32_t* w = s_out + i;
        w[0] = fb;
        w[tile_rows] = fs;
        w[2 * tile_rows] = nb;
        w[3 * tile_rows] = st;
        w[4 * tile_rows] = so;
        w[5 * tile_rows] = ko;
        w[6 * tile_rows] = gsum;
        gsum += nb;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * RCOL; i += blockDim.x) {
      const int c = i / n, r = i - c * n;
      o.row[static_cast<int64_t>(c) * R + t0 + r] = s_out[c * tile_rows + r];
    }
    if (first_walk)  // entry bit, entry slot, state
      for (int i = threadIdx.x; i < n * 3; i += blockDim.x) {
        const int c = i / n, r = i - c * n;
        o.first[static_cast<int64_t>(c) * R + t0 + r] =
            s_out[(c == 2 ? 3 : c) * tile_rows + r];
      }
  }
  if (threadIdx.x == 0) {
    s_res[0] = nrec;
    s_res[1] = bad;
  }
}

// K9 re-decode of RECOVER row `row` into its override row, splicing onto
// K8's variants where it meets one (tail_walk).  A row whose re-decode
// misses again hands its crossing to the row that holds it, so the thread
// goes on there (the rows between are empty) until a link, the segment's
// end, or a row of its own frame that is RECOVER itself, whose thread owns
// it: one round then settles a run of rows whose variants never meet the
// true decode (content that does not resynchronize within a strip).
__device__ void recover_chain(const int32_t* tab, const Params& p,
                              const uint32_t* words, const int32_t* nbits,
                              const Rows& rows, const int32_t* member,
                              const int32_t* marks, const int32_t* links,
                              const Resolve& o, int row, int q0, int q1) {
  const int R = rows.R, M = p.n_pieces - 1;
  const int32_t* state = o.row + 3 * static_cast<int64_t>(R);
  int q = row, bit = o.row[row], slot = o.row[R + row];
  while (true) {
    int32_t* ov = o.ovr + static_cast<int64_t>(q) * OCOL;
    int32_t res[NCOL];
    tail_walk(tab, p, words, nbits, rows, member, q, bit, slot, 0, 1, res,
              o.ovr_marks + static_cast<int64_t>(q) * M * MCOL, marks, links);
    ov[0] = 1;
    ov[1] = bit;
    ov[2] = slot;
    for (int c = 0; c < NCOL; ++c) ov[3 + c] = res[c];
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

// K9: one CTA per frame runs the frame's walk and re-decode rounds, then
// its stats and its piece layout.
__global__ void __launch_bounds__(RESOLVE_THREADS)
resolve_kernel(const int32_t* __restrict__ tables,
               const uint32_t* __restrict__ words,
               const int32_t* __restrict__ nbits, Rows rows, Params p,
               const int32_t* __restrict__ member,
               const int32_t* __restrict__ links,
               const int32_t* __restrict__ marks, int tile_rows,
               int max_rounds, Resolve o, int32_t* __restrict__ frame_out,
               int32_t* __restrict__ pieces) {
  extern __shared__ int32_t sm[];
  int32_t* tab = sm;
  int32_t* s_links = sm + p.tab_ints;
  int32_t* s_ovr = s_links + tile_rows * p.bpm * NCOL;
  int32_t* s_out = s_ovr + tile_rows * OCOL;
  __shared__ int s_res[3];  // RECOVER rows, walk refusal, mispredicts
  const int f = blockIdx.x;
  const int64_t R = rows.R;
  const int q0 = rows.row0[f], q1 = rows.row0[f + 1];
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x)
    o.ovr[static_cast<int64_t>(q) * OCOL] = 0;
  if (threadIdx.x == 0) s_res[2] = 0;
  stage_tables(tab, tables, p.tab_ints);
  int rounds = 0, rec = 0, unresolved = 0;
  while (true) {
    walk_frame(links, rows, p, tile_rows, s_links, s_ovr, s_out, o,
               rounds == 0, s_res);
    __syncthreads();
    const int nrec = s_res[0];
    if (nrec == 0) break;
    ++rounds;
    rec += nrec;
    if (rounds >= max_rounds) {
      unresolved = 1;
      break;
    }
    for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x)
      if (o.row[3 * R + q] == RECOVER)
        recover_chain(tab, p, words, nbits, rows, member, marks, links, o, q,
                      q0, q1);
    // walk_frame opens with a barrier: the override rows are complete
  }
  const int32_t* f_bit = o.row;
  const int32_t* f_slot = o.row + R;
  if (!unresolved && rounds > 0) {
    int mis = 0;
    for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x)
      mis += o.first[2 * R + q] == SETTLED &&
             (o.first[q] != f_bit[q] || o.first[R + q] != f_slot[q]);
    if (mis) atomicAdd(&s_res[2], mis);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t* fo = frame_out + static_cast<int64_t>(f) * SCOL;
    fo[0] = rounds;
    fo[1] = rec;
    fo[2] = s_res[2];
    fo[3] = unresolved;
    fo[4] = s_res[1];
  }
  // The pieces of the frame's rows.
  const int P = p.n_pieces, M = P - 1;
  for (int64_t i = static_cast<int64_t>(q0) * P + threadIdx.x;
       i < static_cast<int64_t>(q1) * P; i += blockDim.x) {
    const int q = static_cast<int>(i / P), j = static_cast<int>(i - q * P);
    const int n = o.row[2 * R + q], s = o.row[4 * R + q];
    const int kk = o.row[5 * R + q];
    const int32_t* mk =
        s >= 0 ? marks + (static_cast<int64_t>(q) * p.bpm + s) * M * MCOL
               : o.ovr_marks + static_cast<int64_t>(q) * M * MCOL;
    const int lo = j == 0 ? kk : max(kk, min(mk[(j - 1) * MCOL + 2], kk + n));
    const int hi = j == M ? kk + n : max(kk, min(mk[j * MCOL + 2], kk + n));
    int32_t* e = pieces + i * PCOL;
    if (lo == kk) {
      e[0] = f_bit[q];
      e[1] = f_slot[q];
    } else {
      e[0] = mk[(j - 1) * MCOL];
      e[1] = mk[(j - 1) * MCOL + 1];
    }
    e[2] = o.row[6 * R + q] + lo - kk;
    e[3] = hi - lo;
  }
}

// Frame-relative block `rel` of frame-local block ordinal gblk in `slot`;
// false when the block lies outside the frame (the restart kernels'
// affinities and guard).  32-bit divisions: ordinals fit int32.
__device__ __forceinline__ bool place(const int32_t* tab, const Params& p,
                                      int f, int gblk, int slot,
                                      int64_t& dst) {
  const int mcu = gblk / p.bpm;
  const int my = mcu / p.m_x;
  const int64_t rel =
      tab[OFF_C0 + slot] + static_cast<int64_t>(my) * tab[OFF_C1 + slot] +
      static_cast<int64_t>(mcu - my * p.m_x) * tab[OFF_C2 + slot];
  dst = (static_cast<int64_t>(f) * p.total_blocks + rel) * 64;
  return mcu < p.n_mcus && rel < tab[OFF_BLK_END + slot];
}

// K10 walk: one thread per piece decodes its blocks from its entry, with
// the code tables read through L1.  Each thread assembles its current
// block in shared memory (coefficient z of thread t at z * blockDim.x +
// t: a warp's threads hit distinct banks) and writes it out whole, 16
// bytes a store.  It runs PIECE_THREADS-thread CTAs with the register
// budget of FINAL_BOUND-thread ones and reads its stride at run time: the
// compiler's code for bounds of PIECE_THREADS, or for a compile-time
// stride, spends fewer registers and measured slower (PERF.md).
__global__ void __launch_bounds__(FINAL_BOUND)
final_kernel(const int32_t* __restrict__ tab,
             const uint32_t* __restrict__ words,
             const int32_t* __restrict__ nbits, Rows rows, Params p,
             const int32_t* __restrict__ pieces,
             int32_t* __restrict__ coeffs, int32_t* __restrict__ dc_sum,
             int32_t* __restrict__ pok) {
  extern __shared__ int32_t sm[];  // 64 ints a thread
  const int stride = blockDim.x;
  int32_t* mine = sm + threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(rows.R) * p.n_pieces) return;
  const int32_t* e = pieces + i * PCOL;
  const int n = e[3], g = e[2];
  const int f = rows.row_frame[i / p.n_pieces];
  bool good = !(n > 0 && g % p.bpm != e[1]);
  uint32_t pred[C_MAX] = {0u, 0u, 0u, 0u};
  if (n > 0 && good) {
    Decoder d;
    d.start(words + static_cast<int64_t>(f) * p.wn, p.wn, nbits[f], e[0],
            e[1]);
    int64_t dst = 0;
    bool valid = place(tab, p, f, g, d.slot, dst);
    int cur = 0;
    uint64_t nz = 0;  // the block's coefficients written in `mine`
    Sym s;
    while (true) {
      if (!symbol(tab, p, d, s)) {
        good = false;
        break;
      }
      if (!s.is_dc && !s.is_eob) {
        const int z = tab[OFF_ZIGZAG + s.new_coeff];
        mine[z * stride] = s.coef_val;
        nz |= 1ull << z;
      }
      if (s.is_dc) cur = s.coef_val;
      if (s.done) {
        const int c = tab[OFF_SLOT_COMP + d.slot];
        const uint32_t dc = pred[c] + static_cast<uint32_t>(cur);
        pred[c] = dc;
        if (valid) {
          int4* out = reinterpret_cast<int4*>(coeffs + dst);
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            int v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int z = 4 * q + u;
              v[u] = (nz >> z) & 1 ? mine[z * stride] : 0;
            }
            if (q == 0) v[0] = static_cast<int32_t>(dc);
            out[q] = make_int4(v[0], v[1], v[2], v[3]);
          }
        }
        nz = 0;
        advance(d, s, p.bpm);
        if (d.blk == n) break;
        valid = place(tab, p, f, g + d.blk, d.slot, dst);
      } else {
        advance(d, s, p.bpm);
      }
    }
  }
  for (int c = 0; c < C_MAX; ++c)
    dc_sum[i * C_MAX + c] = static_cast<int32_t>(pred[c]);
  pok[i] = good ? 1 : 0;
}

// K10 DC pass: the CTA (tile blockIdx.x of frame blockIdx.y, tile_rows
// rows) sums the DC of the frame's pieces before its tile, scans its own
// pieces' sums in chunks of DC_THREADS, adds each piece's base to its
// blocks' DC, and ANDs its rows' piece ok bits.  Sums wrap as uint32.
__global__ void __launch_bounds__(DC_THREADS)
dc_kernel(const int32_t* __restrict__ tables, Rows rows, Params p,
          const int32_t* __restrict__ pieces,
          const int32_t* __restrict__ dc_sum, const int32_t* __restrict__ pok,
          int tile_rows, int32_t* __restrict__ coeffs,
          int32_t* __restrict__ ok) {
  __shared__ uint32_t s_carry[C_MAX];
  __shared__ uint32_t s_scan[DC_THREADS][C_MAX];
  __shared__ int s_ok[DC_THREADS];
  const int f = blockIdx.y, tid = threadIdx.x;
  const int q0 = rows.row0[f], q1 = rows.row0[f + 1];
  const int r0 = q0 + blockIdx.x * tile_rows;
  if (r0 >= q1) return;
  const int r1 = min(q1, r0 + tile_rows);
  const int P = p.n_pieces;
  const int64_t p0 = static_cast<int64_t>(q0) * P;
  const int64_t a = static_cast<int64_t>(r0) * P;
  const int64_t b = static_cast<int64_t>(r1) * P;
  if (tid < C_MAX) s_carry[tid] = 0u;
  for (int i = tid; i < r1 - r0; i += blockDim.x) s_ok[i] = 1;
  __syncthreads();
  uint32_t part[C_MAX] = {0u, 0u, 0u, 0u};
  for (int64_t i = p0 + tid; i < a; i += blockDim.x)
    for (int c = 0; c < C_MAX; ++c)
      part[c] += static_cast<uint32_t>(dc_sum[i * C_MAX + c]);
  for (int c = 0; c < C_MAX; ++c)
    if (part[c]) atomicAdd(&s_carry[c], part[c]);
  __syncthreads();
  for (int64_t base = a; base < b; base += blockDim.x) {
    const int64_t i = base + tid;
    uint32_t v[C_MAX] = {0u, 0u, 0u, 0u};
    if (i < b)
      for (int c = 0; c < C_MAX; ++c)
        v[c] = static_cast<uint32_t>(dc_sum[i * C_MAX + c]);
    for (int c = 0; c < C_MAX; ++c) s_scan[tid][c] = v[c];
    __syncthreads();
    for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
      uint32_t t[C_MAX] = {0u, 0u, 0u, 0u};
      if (tid >= off)
        for (int c = 0; c < C_MAX; ++c) t[c] = s_scan[tid - off][c];
      __syncthreads();
      for (int c = 0; c < C_MAX; ++c) s_scan[tid][c] += t[c];
      __syncthreads();
    }
    if (i < b) {
      uint32_t add[C_MAX];
      for (int c = 0; c < C_MAX; ++c)
        add[c] = s_carry[c] + s_scan[tid][c] - v[c];
      const int32_t* e = pieces + i * PCOL;
      const int n = e[3], g = e[2];
      // eight blocks at a time: their loads in flight together
      for (int j0 = 0; j0 < n; j0 += 8) {
        int64_t dst[8];
        bool in[8];
        int32_t x[8];
        int comp[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int gblk = g + j0 + u;
          const int slot = gblk % p.bpm;
          in[u] = j0 + u < n && place(tables, p, f, gblk, slot, dst[u]);
          comp[u] = tables[OFF_SLOT_COMP + slot];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (in[u]) x[u] = coeffs[dst[u]];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (in[u])
            coeffs[dst[u]] = static_cast<int32_t>(
                static_cast<uint32_t>(x[u]) + add[comp[u]]);
      }
      if (!pok[i]) s_ok[static_cast<int>(i / P) - r0] = 0;
    }
    __syncthreads();
    if (tid < C_MAX) s_carry[tid] += s_scan[blockDim.x - 1][tid];
    __syncthreads();
  }
  for (int i = tid; i < r1 - r0; i += blockDim.x) ok[r0 + i] = s_ok[i];
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
      p.strip_bits > p.cb_bits || p.n_pieces <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// K8 and K9 cut each row at piece_bits; K10 takes the pieces as laid out.
int check_pieces(const Params& p) {
  if (p.piece_bits <= 0 ||
      p.n_pieces != (p.cb_bits + p.piece_bits - 1) / p.piece_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  return check_params(p);
}

}  // namespace

extern "C" int jt_decode_rstless_table_ints() { return TABLE_INTS; }
extern "C" int jt_decode_rstless_ncol() { return NCOL; }
extern "C" int jt_decode_rstless_gcol() { return GCOL; }

// K8 on `stream`: clears the survivor count, then launch 1 (the head walk
// and grouping) and launch 2 (the tail walk of the survivors, a grid that
// covers every lane).  `member` must be zeroed; `scratch` holds R * bpm *
// GCOL ints of group state, then the survivor list (1 + R * bpm ints).
extern "C" int jt_rstless_sync(const void* tables, const void* words,
                               const void* nbits, const void* row0,
                               const void* row_frame, void* member,
                               void* links, void* marks, void* scratch, int R,
                               int wn, int bpm, int vpad, int tab_ints,
                               int cb_bits, int strip_bits, int piece_bits,
                               int n_pieces, void* stream) {
  const Params p{wn,      bpm,        0, 1,          vpad,    tab_ints,
                 cb_bits, strip_bits, 0, piece_bits, n_pieces};
  int rc = check_pieces(p);
  if (rc != 0 || R <= 0) return rc;
  const int rows_per_cta = bpm < SYNC_LANES ? SYNC_LANES / bpm : 1;
  const int threads =
      32 * ((rows_per_cta * bpm + HEAD_LANES - 1) / HEAD_LANES);
  if (threads > SYNC_BOUND) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const auto* tab = static_cast<const int32_t*>(tables);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* nb = static_cast<const int32_t*>(nbits);
  auto* group = static_cast<int32_t*>(scratch);
  int32_t* survivors = group + static_cast<int64_t>(R) * bpm * GCOL;
  auto s = static_cast<cudaStream_t>(stream);
  if ((rc = static_cast<int>(
           cudaMemsetAsync(survivors, 0, sizeof(int32_t), s))))
    return rc;
  head_kernel<<<(R + rows_per_cta - 1) / rows_per_cta, threads, 0, s>>>(
      tab, w, nb, rows, p, rows_per_cta, static_cast<int32_t*>(member),
      static_cast<int32_t*>(links), static_cast<int32_t*>(marks), group,
      survivors);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const int64_t lanes = static_cast<int64_t>(R) * bpm;
  const int per_cta = TAIL_WARPS * TAIL_LANES;
  tail_kernel<<<static_cast<unsigned>((lanes + per_cta - 1) / per_cta),
                TAIL_WARPS * 32, 0, s>>>(
      tab, w, nb, rows, p, static_cast<const int32_t*>(member), group,
      survivors, static_cast<int32_t*>(links), static_cast<int32_t*>(marks));
  return static_cast<int>(cudaGetLastError());
}

// K9 of F frames on `stream`, one launch.  `scratch` holds R * (OCOL +
// (n_pieces - 1) * MCOL + 3) ints and needs no initial value.
extern "C" int jt_rstless_resolve(
    const void* tables, const void* words, const void* nbits,
    const void* row0, const void* row_frame, const void* member,
    const void* links, const void* marks, void* scratch, void* row_out,
    void* frame_out, void* pieces, int F, int R, int wn, int bpm, int vpad,
    int tab_ints, int cb_bits, int strip_bits, int piece_bits, int n_pieces,
    int tile_rows, int max_rounds, void* stream) {
  const Params p{wn,      bpm,        0, 1,          vpad,    tab_ints,
                 cb_bits, strip_bits, 0, piece_bits, n_pieces};
  int rc = check_pieces(p);
  if (rc != 0 || F <= 0 || R <= 0) return rc;
  if (tile_rows <= 0 || max_rounds <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(int32_t) * (tab_ints + static_cast<size_t>(tile_rows) *
                                        (bpm * NCOL + OCOL + RCOL));
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if ((rc = set_smem(resolve_kernel, smem)))
    return rc;
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  auto* sc = static_cast<int32_t*>(scratch);
  const int64_t r = R;
  const Resolve o{static_cast<int32_t*>(row_out), sc, sc + r * OCOL,
                  sc + r * OCOL + r * (n_pieces - 1) * MCOL};
  resolve_kernel<<<F, RESOLVE_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(links), static_cast<const int32_t*>(marks),
      tile_rows, max_rounds, o, static_cast<int32_t*>(frame_out),
      static_cast<int32_t*>(pieces));
  return static_cast<int>(cudaGetLastError());
}

// K10: the piece walk, then the DC pass (dc_tiles x F CTAs of dc_tile_rows
// rows), on `stream`.  Neither `coeffs` nor `scratch` (R * n_pieces *
// (C_MAX + 1) ints) needs an initial value: every block of a frame that
// decodes all its MCUs with every row ok is written whole, and a block no
// piece decodes (only in a frame the engine refuses) is left as it was.
extern "C" int jt_rstless_final(const void* tables, const void* words,
                                const void* nbits, const void* row0,
                                const void* row_frame, const void* pieces,
                                void* coeffs, void* scratch, void* ok, int F,
                                int R, int wn, int bpm, int n_mcus, int m_x,
                                int vpad, int tab_ints, int total_blocks,
                                int n_pieces, int dc_tile_rows, int dc_tiles,
                                void* stream) {
  const Params p{wn, bpm, n_mcus,       m_x, vpad,    tab_ints,
                 1,  1,   total_blocks, 0,   n_pieces};
  int rc = check_params(p);
  if (rc != 0 || F <= 0 || R <= 0) return rc;
  if (m_x <= 0 || dc_tile_rows <= 0 || dc_tile_rows > DC_THREADS ||
      dc_tiles <= 0 || dc_tiles > 65535 || F > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const int64_t n_pc = static_cast<int64_t>(R) * n_pieces;
  auto* dc_sum = static_cast<int32_t*>(scratch);
  int32_t* pok = dc_sum + n_pc * C_MAX;
  auto s = static_cast<cudaStream_t>(stream);
  final_kernel<<<static_cast<unsigned>((n_pc + PIECE_THREADS - 1) /
                                       PIECE_THREADS),
                 PIECE_THREADS, sizeof(int32_t) * 64 * PIECE_THREADS, s>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(pieces), static_cast<int32_t*>(coeffs),
      dc_sum, pok);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  dc_kernel<<<dim3(dc_tiles, F), DC_THREADS, 0, s>>>(
      static_cast<const int32_t*>(tables), rows, p,
      static_cast<const int32_t*>(pieces), dc_sum, pok, dc_tile_rows,
      static_cast<int32_t*>(coeffs), static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
