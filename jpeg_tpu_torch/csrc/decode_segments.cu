// decode_segments: restart-segment Huffman decode straight into
// plane-major coefficient blocks, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU decode of Motion-JPEG restart segments:
//   * eligible shapes (each lane owns `ri` whole MCUs of one MCU row): the
//     Pallas lane-region placement kernel
//     (jpeg_tpu/entropy/place_pallas.py, _region_kernel / _place_region)
//     and the XLA symbol scan that feeds it (jpeg_tpu/entropy/
//     lockstep_jax.py, _scan_lanes / _symbol_step_scalar);
//   * every other shape (a restart interval that does not tile the MCU
//     rows, a short last segment, a whole RST-less frame as one lane):
//     the same scan followed by the prefix-sum scatter _place_emissions
//     (lockstep_jax.py:595, decode_scan_device :568).
// The TPU decodes one symbol per lane per lockstep step up to a static
// step bound, streams (key, value) emissions through device memory and
// places them with masked selects or a scatter.  Here one thread owns one
// restart segment and decodes it to its end, so there is no step bound
// and no emission stream: every coefficient is stored straight into its
// block.
//
// Four walks share one decode loop (template MODE):
//   MODE_REGION   eligible shapes, one pass: lane k of a frame owns MCUs
//                 k*ri .. k*ri+ri-1, so a block's index is arithmetic;
//                 writes of lane-local MCUs >= ri are dropped.
//   MODE_COUNT    general pass 1: decode to the end, store only the MCU
//                 count.  The wrapper's per-frame exclusive cumsum gives
//                 each lane its first MCU (lane_off).
//   MODE_PLACE    general pass 2: a write of lane-local MCU m goes to
//                 block(lane_off + m, slot), dropped unless m < n_mcus and
//                 the block lies inside its component (slot_nblocks).
//   MODE_RESOLVE  general pass 3, see below.
// Two lanes can write the same coefficient only in an MCU at a lane
// boundary: the partial MCU a lane was decoding when it died starts where
// the next lane starts.  The JAX scatter is a scatter-SET over emissions in
// (step, lane) order, and on the CPU the last update wins (XLA applies
// updates in order).  So MODE_PLACE writes MCUs strictly inside a lane's
// range directly and, for the lane's first MCU and its partial last one,
// only raises a per-coefficient owner key ((step + 1) << 32 | lane) with
// atomicMax in a small table of boundary MCUs; MODE_RESOLVE walks again
// and writes those coefficients whose owner key is its own.  An intact
// stream has no partial MCUs, so pass 3 then rewrites each lane's first
// MCU and nothing else.
//
// Semantics are integer-exact with the JAX paths, corrupt input included
// (see entropy/lockstep_torch.py and entropy/place_cuda.py, the plain
// versions): a lane dies on an unmatched code, a DC category above 16, an
// AC run past 63, a symbol overrunning the segment, or (interleaved
// scans) a DC of an out-of-range lane-local MCU; nothing of the fatal
// symbol is written.  A block's DC (predictor + diff) is written only
// when the block completes, one step after it (the JAX scan's pending
// emission), and only for lane-local MCUs below n_mcus.
//
// What bounds it on the H100: one thread per lane is ~16k threads for an
// 8-frame 1080p chunk (2,040 segments per frame), about one 128-thread
// block per SM, and every thread walks a dependent chain of bit-window,
// table and store operations.  It is latency-bound, not bandwidth-bound
// (a chunk reads ~4 MB of padded segment words and scatters a few MB of
// coefficients into its 100 MB zero-filled output).  The general shapes
// pay three walks for that.  The tables sit in shared memory
// (canonical-code compare over 16 lengths instead of a 64K-entry LUT,
// which would not fit); the bit window is a per-thread 64-bit buffer
// refilled one word at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Packed table layout (int32); entropy/place_cuda.py builds it.
constexpr int T_MAX = 8;
constexpr int SLOTS = 16;
constexpr int C_MAX = 4;
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
constexpr int TABLE_INTS = OFF_ZIGZAG + 64;

constexpr int THREADS = 128;

constexpr int MODE_REGION = 0;
constexpr int MODE_COUNT = 1;
constexpr int MODE_PLACE = 2;
constexpr int MODE_RESOLVE = 3;

struct Params {
  int S;             // lanes (frames * spf)
  int wn;            // u32 words per lane row
  int spf;           // segments per frame
  int ri;            // restart interval (MCUs per segment; region mode)
  int total_blocks;  // blocks per frame
  int bpm;           // blocks per MCU
  int n_mcus;        // MCUs per frame (lane-local MCU bound)
  int interleaved;   // Ns > 1
  int m_x;           // MCU-row width used by the block affinities
  int vpad;          // huffval index clip: vidx <= vpad - 1
};

// Per-lane inputs of the general passes (null in the other modes).
struct General {
  const int32_t* counts;     // [S] lane MCU counts (pass 1)
  const int32_t* lane_off;   // [S] frame-local first MCU of each lane
  const int32_t* lane_first; // [S] first lane of the frame with that offset
  unsigned long long* bkey;  // [frames, spf + 1, bpm, 64] owner keys
};

__device__ __forceinline__ uint32_t load_word(const uint32_t* row, int i,
                                              int wn) {
  return i < wn ? row[i] : 0u;
}

// Frame-relative block of frame-local MCU `gm`, slot `slot`.
__device__ __forceinline__ int64_t block_of(const int32_t* tab,
                                            const Params& p, int64_t gm,
                                            int slot) {
  int64_t my = 0, mx = gm;
  if (p.interleaved) {
    my = gm / p.m_x;
    mx = gm - my * p.m_x;
  }
  return tab[OFF_C0 + slot] + my * tab[OFF_C1 + slot] +
         mx * tab[OFF_C2 + slot];
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
decode_segments_kernel(const int32_t* __restrict__ tables,
                       const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ nbits,
                       int32_t* __restrict__ coeffs,
                       int32_t* __restrict__ mcu_counts, Params p,
                       General g) {
  __shared__ int32_t tab[TABLE_INTS];
  for (int i = threadIdx.x; i < TABLE_INTS; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.S) return;

  const uint32_t* row = words + static_cast<int64_t>(lane) * p.wn;
  const int nb = nbits[lane];
  const int frame = lane / p.spf;
  const int k = lane - frame * p.spf;
  const int64_t frame_base = static_cast<int64_t>(frame) * p.total_blocks;
  int count = 0, off = 0, first = 0;
  if (MODE == MODE_PLACE || MODE == MODE_RESOLVE) {
    count = g.counts[lane];
    off = g.lane_off[lane];
    first = g.lane_first[lane];
  }

  int bitpos = 0, mcu = 0, slot = 0, coeff = 0, cur_diff = 0, step = 0;
  int dc_pred[C_MAX] = {0, 0, 0, 0};
  int widx = 0;  // buf holds words widx and widx + 1
  uint64_t buf = (static_cast<uint64_t>(load_word(row, 0, p.wn)) << 32) |
                 load_word(row, 1, p.wn);
  bool alive = nb > 0;

  for (; alive; ++step) {
    const uint32_t win = static_cast<uint32_t>((buf << (bitpos & 31)) >> 32);
    const int code16 = static_cast<int>(win >> 16);
    const bool is_dc = coeff == 0;
    const int t = is_dc ? tab[OFF_SLOT_DC + slot] : tab[OFF_SLOT_AC + slot];

    // Canonical decode: the first length l with prefix <= maxcode[t][l].
    int length = 0, base = 0, minc = 0;
    for (int l = 1; l <= 16; ++l) {
      if ((code16 >> (16 - l)) <= tab[OFF_MAXCODE + t * 17 + l]) {
        length = l;
        base = tab[OFF_VALPTR + t * 17 + l];
        minc = tab[OFF_MINCODE + t * 17 + l];
        break;
      }
    }
    if (length == 0) break;  // no code matches: the lane dies
    int vidx = base + (code16 >> (16 - length)) - minc;
    vidx = min(max(vidx, 0), p.vpad - 1);
    const int value = tab[OFF_HUFFVAL + t * 256 + vidx];
    if (is_dc && value > 16) break;  // DC category past 16
    const int cat = is_dc ? value : (value & 15);
    const int need = length + cat;  // 1..32 bits
    if (bitpos + need > nb) break;  // symbol overruns the segment

    const int extra =
        static_cast<int>((win >> (32 - need)) & ((1u << cat) - 1u));
    const int coef_val =
        cat == 0 ? 0
                 : ((extra >> (cat - 1)) ? extra : extra - (1 << cat) + 1);

    const bool block_ok = mcu < p.n_mcus;
    if (is_dc && !block_ok && p.interleaved) break;  // NULL-block DC
    const bool is_eob = !is_dc && value == 0;
    const int new_coeff = is_dc ? 1 : coeff + (value >> 4);
    if (!is_dc && !is_eob && new_coeff > 63) break;  // AC run past 63

    // The symbol is live.  Its block, computed once per symbol as in the
    // one-pass kernel: dst is the block's first coefficient (-1: writes
    // are dropped); a general-shape write into an MCU at a lane boundary
    // goes through the owner keys at bkey[kbase + pos].
    int64_t dst = -1, kbase = -1;
    if (MODE == MODE_REGION) {
      if (mcu < p.ri) {  // inside the lane's region
        // gm < n_mcus here, so 32-bit arithmetic (and, for Ns=1 scans,
        // m_x = n_mcus gives my = 0).
        const int gm = k * p.ri + mcu;
        const int my = gm / p.m_x;
        const int mx = gm - my * p.m_x;
        dst = (frame_base + tab[OFF_C0 + slot] + my * tab[OFF_C1 + slot] +
               mx * tab[OFF_C2 + slot]) * 64;
      }
    } else if (MODE != MODE_COUNT && mcu < p.n_mcus) {  // lane-local bound
      const int64_t rel =
          block_of(tab, p, static_cast<int64_t>(off) + mcu, slot);
      if (rel < tab[OFF_BLK_END + slot]) {  // seq < slot_nblocks
        dst = (frame_base + rel) * 64;
        if (mcu == 0 || mcu == count) {  // other lanes may write this MCU
          const int brow = mcu == 0 ? first : k + 1;
          kbase = ((static_cast<int64_t>(frame) * (p.spf + 1) + brow) *
                   p.bpm + slot) * 64;
        }
      }
    }
    // Store `value` at position `pos` of the block, emitted at lockstep
    // step `at`.
    auto put = [&](int pos, int value, int at) {
      if (dst < 0) return;
      if (kbase < 0) {
        if (MODE != MODE_RESOLVE) coeffs[dst + pos] = value;
        return;
      }
      const unsigned long long key =
          (static_cast<unsigned long long>(at + 1) << 32) |
          static_cast<unsigned int>(lane);
      if (MODE == MODE_PLACE) {
        atomicMax(g.bkey + kbase + pos, key);
      } else if (g.bkey[kbase + pos] == key) {
        coeffs[dst + pos] = value;
      }
    };
    if (!is_dc && !is_eob) put(tab[OFF_ZIGZAG + new_coeff], coef_val, step);
    if (is_dc) cur_diff = coef_val;
    const int after = is_dc ? 1 : new_coeff + 1;
    if (is_eob || after >= 64) {
      const int comp = tab[OFF_SLOT_COMP + slot];
      // int32 wrap-around, as the JAX engine's int32 arithmetic
      const int dc = static_cast<int>(static_cast<uint32_t>(dc_pred[comp]) +
                                      static_cast<uint32_t>(cur_diff));
      put(0, dc, step + 1);  // the scan emits it a step later
      dc_pred[comp] = dc;
      coeff = 0;
      if (++slot >= p.bpm) {
        slot = 0;
        ++mcu;
      }
    } else {
      coeff = after;
    }
    bitpos += need;
    const int nw = bitpos >> 5;  // a symbol crosses at most one word
    if (nw != widx) {
      widx = nw;
      buf = (buf << 32) | load_word(row, widx + 1, p.wn);
    }
  }
  if (MODE == MODE_REGION || MODE == MODE_COUNT) mcu_counts[lane] = mcu;
}

template <int MODE>
int launch(const void* tables, const void* words, const void* nbits,
           void* coeffs, void* mcu_counts, const Params& p, const General& g,
           void* stream) {
  if (p.S <= 0) return 0;
  const int blocks = (p.S + THREADS - 1) / THREADS;
  decode_segments_kernel<MODE><<<blocks, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), static_cast<int32_t*>(coeffs),
      static_cast<int32_t*>(mcu_counts), p, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jt_decode_segments_table_ints() { return TABLE_INTS; }

// Eligible shapes, one pass.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int jt_decode_segments(const void* tables, const void* words,
                                  const void* nbits, void* coeffs,
                                  void* mcu_counts, int S, int wn, int spf,
                                  int ri, int total_blocks, int bpm,
                                  int n_mcus, int interleaved, int m_x,
                                  int vpad, void* stream) {
  const Params p{S, wn, spf, ri, total_blocks, bpm, n_mcus, interleaved, m_x,
                 vpad};
  return launch<MODE_REGION>(tables, words, nbits, coeffs, mcu_counts, p,
                             General{}, stream);
}

// General shapes, pass 1: per-lane MCU counts only.
extern "C" int jt_decode_segments_count(const void* tables, const void* words,
                                        const void* nbits, void* mcu_counts,
                                        int S, int wn, int spf, int bpm,
                                        int n_mcus, int interleaved, int m_x,
                                        int vpad, void* stream) {
  const Params p{S, wn, spf, 0, 0, bpm, n_mcus, interleaved, m_x, vpad};
  return launch<MODE_COUNT>(tables, words, nbits, nullptr, mcu_counts, p,
                            General{}, stream);
}

// General shapes, passes 2 and 3, one launch each on `stream`: the place
// walk, then the resolve walk over the boundary MCUs' owner keys.
extern "C" int jt_decode_segments_place(
    const void* tables, const void* words, const void* nbits,
    const void* counts, const void* lane_off, const void* lane_first,
    void* bkey, void* coeffs, int S, int wn, int spf, int total_blocks,
    int bpm, int n_mcus, int interleaved, int m_x, int vpad, void* stream) {
  const Params p{S, wn, spf, 0, total_blocks, bpm, n_mcus, interleaved, m_x,
                 vpad};
  const General g{static_cast<const int32_t*>(counts),
                  static_cast<const int32_t*>(lane_off),
                  static_cast<const int32_t*>(lane_first),
                  static_cast<unsigned long long*>(bkey)};
  int rc = launch<MODE_PLACE>(tables, words, nbits, coeffs, nullptr, p, g,
                              stream);
  if (rc != 0) return rc;
  return launch<MODE_RESOLVE>(tables, words, nbits, coeffs, nullptr, p, g,
                              stream);
}
