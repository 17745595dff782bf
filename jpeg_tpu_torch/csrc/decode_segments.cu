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
// and no emission stream: every coefficient goes straight to its block.
//
// Four walks share one decode loop (template MODE):
//   MODE_REGION   eligible shapes, one pass: lane k of a frame owns MCUs
//                 k*ri .. k*ri+ri-1 outright (they tile the frame), so it
//                 assembles each block in a per-thread shared-memory tile
//                 and stores it whole when it completes; a lane that dies
//                 stores the block it died in (its ACs, DC 0, as the scan
//                 leaves it) and zero blocks for the rest of its region.
//                 The output needs no zero fill.  Lane-local MCUs >= ri
//                 are dropped.
//   MODE_COUNT    general pass 1: decode to the end, store the MCU count
//                 and whether the lane wrote into the MCU it died in
//                 ("partial").  Then the frame's layout, in the same
//                 launch: each CTA adds its lanes of a frame to the
//                 frame's ticket, and the CTA that completes the frame
//                 gives each lane its first MCU (lane_off, the per-frame
//                 exclusive sum of the counts), marks the lane-boundary
//                 MCUs that two lanes write ("contested"; plain version
//                 place_cuda.lane_layout + contested_rows) and resets the
//                 ticket for the next call.  Their owner keys are zeroed
//                 by each CTA for the rows its partial lanes end in, and
//                 by the layout for the rest.
//   MODE_PLACE    general pass 2: a write of lane-local MCU m goes to
//                 block(lane_off + m, slot), dropped unless m < n_mcus and
//                 the block lies inside its component (slot_nblocks).
//   MODE_RESOLVE  general pass 3, see below.
// Only a contested MCU has two writers: the partial MCU a damaged lane
// died in is the next lane's first MCU.  The JAX scatter is a scatter-SET
// over emissions in (step, lane) order, and on the CPU the last update
// wins (XLA applies updates in order).  So MODE_PLACE writes every MCU
// directly except contested ones, where it only raises a per-coefficient
// owner key ((step + 1) << 32 | lane) with atomicMax (zeroed beforehand
// by the count walk's layout, contested rows only); MODE_RESOLVE walks again,
// only in lanes that touch a contested MCU and only as far as it, and
// writes the coefficients whose owner key is its own.  On an intact
// stream nothing is contested and pass 3 returns at once.  The general
// path is three launches: count (with the layout), place, resolve.
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
// What bounds it on the H100.  The least time is set by bytes: an 8-frame
// 1080p chunk reads ~1.6 MB of segment bits (in ~4 MB of padded words)
// and writes 100 MB of int32 coefficients, ~0.031 ms at 3.35 TB/s.  The
// kernel sits 3x (one pass) to 10x (general) above that: each lane is one
// dependent chain per symbol (window, table load, length, bit position),
// a chunk holds only 9k-16k lanes, about one warp per scheduler, so
// nothing hides that chain's latency, and a warp steps at the pace of its
// slowest lane and of the rarest path any lane takes (a block completing,
// a long code).  The design shortens the chain and the divergent paths:
//   * table lookup: a first-level table of 2^LUT_BITS entries per Huffman
//     table (code length and symbol, packed in 16 bits; 0 = a longer
//     code) decodes every code of up to LUT_BITS bits with one
//     shared-memory load; longer codes continue the canonical compare at
//     length LUT_BITS + 1 with independent compares.  12 bits (8 KB a
//     table; only the scan's tables are staged) leave so few long codes
//     that a warp rarely waits on one.  place_cuda.lookup_table builds it
//     with the compare's own formula, vidx clip included, so hostile
//     tables decode the same.  Folding the magnitude bits into the entry
//     (libjpeg-turbo's fast path) is not done: a path most but not all
//     lanes of a warp take saves a warp nothing;
//   * per-block state: tables, component, destination and owner-key row
//     are set once when a block starts; the DC predictors live in
//     registers;
//   * staged words: when a CTA's [lanes, wn] slab of segment words fits
//     the wrapper's budget, it arrives in shared memory by cp.async 16-byte
//     copies together with the tables (STAGED); otherwise each thread
//     keeps a register lookahead that issues the load of word widx + 2
//     while widx is consumed;
//   * CTA_LANES = 64 lanes per CTA so both chunk shapes cover all 132 SMs,
//     decoded by warps of WARP_LANES = 8 active threads (256 threads a
//     CTA): a chunk then fills each scheduler with a few warps instead of
//     ~one, and a warp waits on 8 lanes' divergent paths instead of 32;
//   * whole-block stores in the one-pass walk: two tiles per thread, a
//     finished tile leaves by one cp.async.bulk copy while the thread
//     fills the other, and the output needs no memset; the place walk
//     stores each coefficient into a zeroed output, which measured faster
//     than tiles there; owner keys only in contested MCUs;
//   * the general layout rides the count walk: a separate layout launch
//     (one CTA a frame over a few KB) cost more in launch and wrapper
//     than in work, so the CTA that finishes a frame's last lanes lays
//     the frame out while the other CTAs still decode.
//
// A lane order (the general walks; jpeg_tpu's phased scan,
// lockstep_jax.py:499 _scan_lanes_phased with _place_emissions(perm=...),
// behind models/device_decode.py:236 _decode_device_phased).  jpeg_tpu
// learns each segment's symbol count from a first batch and writes later
// batches' rows sorted by it, longest first, so that each lockstep phase
// continues only the lanes still alive and the scatter's attempts track
// the symbols decoded.  Here no lane waits on a step bound, but a warp of
// WARP_LANES threads steps at the pace of its longest lane, and the
// sorted order puts lanes of like length in one warp.  With `perm` (sorted
// row -> frame-major lane), thread t decodes row t of the sorted words and
// bit counts (the CTA's staged slab stays a contiguous block of rows), but
// takes its frame and segment from perm[t], reads and writes every
// per-lane array (counts, partial, lane_off, lane_first, nsteps) at
// perm[t], so frame_layout works on frame-major arrays as before, and puts
// the sorted index t in its owner keys, so that a contested coefficient
// goes to the emission latest in (step, sorted lane) order, as jpeg_tpu's
// phase-by-phase scatter leaves it.  A CTA's rows then span many frames:
// its lanes add to their frames' tickets a warp's peers of one frame at a
// time.  With `perm` null every walk does what it did before.  `nsteps`
// (count walk, nullable) receives each lane's steps begun alive, the
// lockstep scan's counter that jpeg_tpu's learning pass reads.

#include <atomic>
#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

// Packed table layout (int32); entropy/place_cuda.py builds it.
constexpr int T_MAX = 8;
constexpr int SLOTS = 16;
constexpr int C_MAX = 4;  // the walk keeps one DC predictor register each
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
constexpr int OFF_LUT = OFF_ZIGZAG + 64;  // uint16 [T_MAX, LUT_SIZE]
constexpr int TABLE_INTS = OFF_LUT + T_MAX * LUT_SIZE / 2;
static_assert(OFF_LUT % 4 == 0 && TABLE_INTS % 4 == 0,
              "tables are staged in 16-byte copies");

// Launch shape: CTA_LANES lanes per CTA, WARP_LANES of them per warp
// (threads 0..WARP_LANES-1 of each warp decode, the rest only help stage).
constexpr int CTA_LANES = 64;  // place_cuda.CTA_LANES sizes the staged slab
constexpr int WARP_LANES = 8;
constexpr int THREADS = CTA_LANES / WARP_LANES * 32;
constexpr int TILE_STRIDE = 68;  // ints per block tile: 16-byte rows that
                                 // start 4 banks apart
constexpr int TILES_PER_THREAD = 2;  // one filling, one being copied out
constexpr int ROW_PAD = 4;       // staged rows start 4 banks apart

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
  int tab_ints;      // ints of `tables` to stage (the used LUTs only)
};

// Per-lane inputs and outputs of the general passes (null in region mode);
// the count walk writes partial and the layout, the others read them.
struct General {
  const int32_t* counts;     // [S] lane MCU counts (pass 1)
  int32_t* lane_off;         // [S] frame-local first MCU of each lane
  int32_t* lane_first;       // [S] first lane of the frame with that offset
  int32_t* partial;          // [S] 1: the lane wrote into MCU `count`
  int32_t* contested;        // [frames * (spf + 1)] boundary rows, 1 = two
                             // lanes write that MCU
  unsigned long long* bkey;  // [frames, spf + 1, bpm, 64] owner keys
  unsigned int* tickets;     // [frames] count walk: lanes stored so far, 0
                             // between calls
  const int32_t* perm;       // [S] sorted row -> frame-major lane, or null
  int32_t* nsteps;           // [S] count walk: steps begun alive, or null
};

// Kernel launches of this file since the library loaded (a host count).
std::atomic<long long> g_launches{0};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

using SumScan = cub::BlockScan<long long, THREADS>;
using MaxScan = cub::BlockScan<int, THREADS>;
struct LayoutSmem {
  union {
    typename SumScan::TempStorage sum;
    typename MaxScan::TempStorage max;
  } scan;
  int last_whole;  // the frame's last lane with a nonzero count
  int n_done;      // frames this CTA completed
  int done[CTA_LANES];
  int n_cand;      // the CTA's partial lanes with a whole MCU decoded ...
  int64_t cand[CTA_LANES];  // ... and the owner-key row each ends in
  int n_zero;      // contested rows of a frame the layout zeroes ...
  int zero[THREADS];  // ... (those past THREADS, their finder alone)
};

// A partial lane wrote into the MCU it died in, so its end row may be
// contested.  The layout counts a row's partial writers in its low bits
// and sets this bit for one that decoded no whole MCU (its end row is its
// first row, which only the layout knows).
constexpr int ZERO_COUNT_WRITER = 1 << 30;

// Zero the owner keys of `n` rows (row indices `rows[i] + add`, bkey rows
// of `row_len` keys) with `threads` threads from `t` on, 16-byte stores.
template <typename Row>
__device__ __forceinline__ void zero_key_rows(unsigned long long* bkey,
                                              const Row* rows, int n,
                                              int64_t add, int row_len,
                                              int t, int threads) {
  const int per_row = row_len / 2;
  for (int i = t; i < n * per_row; i += threads) {
    const int c = i / per_row;
    reinterpret_cast<ulonglong2*>(bkey + (rows[c] + add) * row_len)
        [i - c * per_row] = make_ulonglong2(0ull, 0ull);
  }
}

// The general walks' layout of frame `f`, run by the whole CTA of the
// count walk that stored the frame's last lanes (plain version:
// place_cuda.lane_layout + contested_rows): each lane's first MCU (the
// exclusive sum of the counts before it), the first lane of the frame with
// that first MCU, and the contested boundary rows.  Row r (the MCU where
// lane r starts; row spf: where the last lane ends) is contested when it
// lies in the frame and has two writers: the first lane from r on with a
// nonzero count, and each partial lane ending there (row k + 1, or its
// own first row when its count is 0).  Thread t takes lanes and rows
// [k0, k1), ceil(spf / THREADS) of them (thread 0 also row spf), so one
// pair of block scans covers the frame and each thread's loads are
// independent.  Other CTAs' counts and partial flags, and the writer
// counts the atomics leave in L2, are read through L2 (__ldcg): L1 does
// not see those stores.  The owner keys of a contested row whose only
// partial writers decoded no whole MCU are zeroed here; every other
// contested row's were zeroed by the count walk CTA of its partial lane.
__device__ void frame_layout(int f, const int32_t* counts,
                             const int32_t* partial, const Params& p,
                             const General& g, LayoutSmem& sm) {
  const int spf = p.spf;
  const int64_t base = static_cast<int64_t>(f) * spf;
  const int64_t frow = base + f;  // the frame's first row: f * (spf + 1)
  int32_t* row = g.contested + frow;
  const int per = (spf + THREADS - 1) / THREADS;
  const int k0 = min(spf, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(spf, k0 + per);
  for (int r = k0; r < k1; ++r) row[r] = 0;
  if (threadIdx.x == 0) {
    row[spf] = 0;
    sm.last_whole = -1;
    sm.n_zero = 0;
  }
  __syncthreads();
  const int before = k0 > 0 ? __ldcg(counts + base + k0 - 1) : 0;
  long long sum = 0;
  int last_start = -1, last_whole = -1, prev = before;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int c = __ldcg(counts + base + k);
    if (k == 0 || prev > 0) last_start = k;
    if (c > 0) last_whole = k;
    sum += c;
    prev = c;
  }
  if (last_whole >= 0) atomicMax(&sm.last_whole, last_whole);
  long long off, total;
  SumScan(sm.scan.sum).ExclusiveSum(sum, off, total);
  __syncthreads();
  int first;
  MaxScan(sm.scan.max).ExclusiveScan(last_start, first, -1, MaxOp());
  // Each lane's first MCU and first lane, and each partial lane's mark on
  // the row it ends in.
  prev = before;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int c = __ldcg(counts + base + k);
    if (k == 0 || prev > 0) first = k;
    g.lane_off[base + k] = static_cast<int32_t>(off);
    g.lane_first[base + k] = first;
    if (__ldcg(partial + base + k)) {
      atomicAdd(row + (c == 0 ? first : k + 1), 1);
      if (c == 0) atomicOr(row + first, ZERO_COUNT_WRITER);
    }
    off += c;
    prev = c;
  }
  __syncthreads();
  const int row_len = p.bpm * 64;
  auto contest = [&](int r) {
    const long long start = r < spf ? g.lane_off[base + r] : total;
    const int marks = __ldcg(row + r);
    const int writers =
        (marks & (ZERO_COUNT_WRITER - 1)) + (r <= sm.last_whole ? 1 : 0);
    const bool hit = start < p.n_mcus && writers >= 2;
    row[r] = hit ? 1 : 0;
    if (hit && (marks & ZERO_COUNT_WRITER)) {
      const int i = atomicAdd(&sm.n_zero, 1);
      if (i < THREADS)
        sm.zero[i] = r;
      else
        zero_key_rows(g.bkey, &r, 1, frow, row_len, 0, 1);
    }
  };
#pragma unroll 4
  for (int r = k0; r < k1; ++r) contest(r);
  if (threadIdx.x == 0) contest(spf);
  __syncthreads();
  zero_key_rows(g.bkey, sm.zero, min(sm.n_zero, THREADS), frow, row_len,
                threadIdx.x, THREADS);
  __syncthreads();  // the shared scratch is free for the next frame
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void zero_block(int32_t* dst) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = make_int4(0, 0, 0, 0);
}

template <int MODE, bool STAGED>
__global__ void __launch_bounds__(THREADS)
decode_segments_kernel(const int32_t* __restrict__ tables,
                       const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ nbits,
                       int32_t* __restrict__ coeffs,
                       int32_t* __restrict__ mcu_counts, Params p,
                       General g) {
  // The region walk assembles blocks in shared-memory tiles and stores
  // them whole.
  constexpr bool TILES = MODE == MODE_REGION;
  extern __shared__ int4 smem[];
  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  int32_t* tiles = tab + p.tab_ints;
  uint32_t* slab = reinterpret_cast<uint32_t*>(
      tiles + (TILES ? CTA_LANES * TILE_STRIDE * TILES_PER_THREAD : 0));

  // A warp decodes WARP_LANES lanes: fewer lanes per warp put more warps
  // on each scheduler to hide the decode chain's latency, and a warp then
  // waits on fewer lanes' divergent paths.
  const int li = threadIdx.x & 31;
  const int idx = (threadIdx.x >> 5) * WARP_LANES + li;  // lane in the CTA
  const int base = blockIdx.x * CTA_LANES;
  const int lane = base + idx;  // the row of words and bit counts
  const bool mine = li < WARP_LANES && lane < p.S;
  // The lane's frame-major index: its frame and segment, and where its
  // per-lane inputs and outputs live.
  const int fl = g.perm != nullptr && mine ? g.perm[lane] : lane;
  const int frame = fl / p.spf;
  const int k = fl - frame * p.spf;
  int count = 0, off = 0, first = 0;
  bool c_first = false, c_end = false;  // contested first / partial MCU
  if ((MODE == MODE_PLACE || MODE == MODE_RESOLVE) && mine) {
    count = g.counts[fl];
    off = g.lane_off[fl];
    first = g.lane_first[fl];
    const int64_t frow = static_cast<int64_t>(frame) * (p.spf + 1);
    c_first = g.contested[frow + first] != 0;
    c_end = g.partial[fl] != 0 &&
            g.contested[frow + (count == 0 ? first : k + 1)] != 0;
  }
  if (MODE == MODE_RESOLVE) {
    // Only lanes that touch a contested MCU walk again.
    if (!__syncthreads_or(mine && (c_first || c_end))) return;
  }

  // Stage the tables and, on the staged route, the CTA's word slab.
  for (int c = threadIdx.x; c < p.tab_ints / 4; c += blockDim.x)
    cp_async16(smem + c, tables + 4 * c);
  const int stride = p.wn + ROW_PAD;
  if (STAGED) {
    const int rows = min(CTA_LANES, p.S - base);
    const int cpr = p.wn >> 2;  // 16-byte chunks per row
    const uint32_t* src = words + static_cast<int64_t>(base) * p.wn;
    for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
      const int i = c / cpr, j = c - i * cpr;
      cp_async16(slab + i * stride + 4 * j,
                 src + static_cast<int64_t>(i) * p.wn + 4 * j);
    }
  }
  __shared__ LayoutSmem sm;  // the count walk's layout (unused otherwise)
  if (MODE == MODE_COUNT && threadIdx.x == 0) sm.n_cand = 0;
  int32_t* tile = tiles + idx * TILE_STRIDE * TILES_PER_THREAD;
  int32_t* spare = tile + TILE_STRIDE;  // the thread's second tile
  if (TILES && mine) {
    int4* t = reinterpret_cast<int4*>(tile);
    for (int i = 0; i < 16 * TILES_PER_THREAD; ++i)
      t[i + (i >> 4)] = make_int4(0, 0, 0, 0);  // 17 int4 per tile
  }
  cp_async_wait_all();
  __syncthreads();
  // A resolve lane without a contested MCU writes nothing: it only helped
  // stage.  The count walk's threads that decode no lane stay for its
  // layout.
  const bool walks = mine && !(MODE == MODE_RESOLVE && !c_first && !c_end);
  if (MODE != MODE_COUNT && !walks) return;
  if (walks) {
    const uint16_t* lut = reinterpret_cast<const uint16_t*>(tab + OFF_LUT);

    const uint32_t* grow = words + static_cast<int64_t>(lane) * p.wn;
    const uint32_t* srow = slab + idx * stride;
    auto word = [&](int i) -> uint32_t {
      if (i >= p.wn) return 0u;
      return STAGED ? srow[i] : __ldg(grow + i);
    };

    const int nb = nbits[lane];
    const int64_t frame_base = static_cast<int64_t>(frame) * p.total_blocks;
    // Position of the current frame-local MCU in its MCU row (Ns=1 scans:
    // one row holds every MCU, so mx never wraps), advanced per MCU.
    int64_t my = 0, mx = MODE == MODE_REGION ? k * p.ri : off;
    if (p.interleaved) {
      my = mx / p.m_x;
      mx -= my * p.m_x;
    }
    auto next_mcu = [&]() {
      if (++mx == p.m_x && p.interleaved) {
        mx = 0;
        ++my;
      }
    };
    // Store the current tile whole at `d` by one bulk asynchronous copy
    // (cp.async.bulk, 256 bytes) and start the next block on the other,
    // cleared tile.
    auto flush = [&](int32_t* d) {
      // The tile's generic-proxy stores must be visible to the bulk copy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const unsigned src =
          static_cast<unsigned>(__cvta_generic_to_shared(tile));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], 256;\n"
          ::"l"(d), "r"(src) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      int32_t* t = tile;
      tile = spare;
      spare = t;
      // The copy that last read the tile we switch to is done with it.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      int4* z = reinterpret_cast<int4*>(tile);
  #pragma unroll
      for (int i = 0; i < 16; ++i) z[i] = make_int4(0, 0, 0, 0);
    };
    auto block_dst = [&](int s) -> int64_t {  // -1: outside the frame
      const int64_t rel = tab[OFF_C0 + s] + my * tab[OFF_C1 + s] +
                          mx * tab[OFF_C2 + s];
      // region_path: the lanes' regions tile the frame's blocks exactly.
      if (MODE == MODE_REGION) return (frame_base + rel) * 64;
      return rel < tab[OFF_BLK_END + s] ? (frame_base + rel) * 64 : -1;
    };

    int bitpos = 0, mcu = 0, slot = 0, coeff = 0, cur_diff = 0, step = 0;
    int pred0 = 0, pred1 = 0, pred2 = 0, pred3 = 0;  // DC predictors
    int widx = 0;  // buf holds words widx and widx + 1
    uint64_t buf = (static_cast<uint64_t>(word(0)) << 32) | word(1);
    uint32_t ahead = STAGED ? 0u : word(2);  // lookahead: word widx + 2
    bool wrote = false;  // count walk: a write landed in MCU `mcu`
    bool alive = nb > 0;

    // State of the block (mcu, slot), set when it starts: its tables and
    // component, whether the scan emits its writes (block_ok), its first
    // coefficient (dst, -1: writes are dropped) and, for a contested MCU of
    // the general walks, its owner keys at bkey[kbase + pos].
    int t_dc = 0, t_ac = 0, comp = 0;
    bool block_ok = false;
    int64_t dst = -1, kbase = -1;
    auto begin_block = [&]() {
      t_dc = tab[OFF_SLOT_DC + slot];
      t_ac = tab[OFF_SLOT_AC + slot];
      comp = tab[OFF_SLOT_COMP + slot];
      block_ok = mcu < p.n_mcus;
      dst = -1;
      kbase = -1;
      if (MODE == MODE_REGION) {
        if (mcu < p.ri) dst = block_dst(slot);  // inside the lane's region
      } else if (MODE != MODE_COUNT && block_ok) {
        dst = block_dst(slot);
        if (dst >= 0 && ((mcu == 0 && c_first) || (mcu == count && c_end))) {
          const int brow = mcu == 0 ? first : k + 1;
          kbase = ((static_cast<int64_t>(frame) * (p.spf + 1) + brow) *
                   p.bpm + slot) * 64;
        }
      }
    };
    begin_block();

    for (; alive; ++step) {
      if (MODE == MODE_RESOLVE && !c_end && mcu > 0) break;  // past MCU 0
      const uint32_t win = static_cast<uint32_t>((buf << (bitpos & 31)) >> 32);
      const bool is_dc = coeff == 0;
      const int t = is_dc ? t_dc : t_ac;

      // Codes of up to LUT_BITS bits: one lookup.  Longer ones: the
      // canonical compare from LUT_BITS + 1 on (the first length l with
      // prefix <= maxcode[t][l]), its compares independent of each other.
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
        if (length == 0) break;  // no code matches: the lane dies
        const int vidx = tab[OFF_VALPTR + t * 17 + length] +
                         (code16 >> (16 - length)) -
                         tab[OFF_MINCODE + t * 17 + length];
        value = tab[OFF_HUFFVAL + t * 256 + min(max(vidx, 0), p.vpad - 1)];
      }
      if (is_dc && value > 16) break;  // DC category past 16
      const int cat = is_dc ? value : (value & 15);
      const int need = length + cat;  // 1..32 bits
      if (bitpos + need > nb) break;  // symbol overruns the segment

      const int extra =
          static_cast<int>((win >> (32 - need)) & ((1u << cat) - 1u));
      const int coef_val =
          cat == 0 ? 0
                   : ((extra >> (cat - 1)) ? extra : extra - (1 << cat) + 1);

      if (is_dc && !block_ok && p.interleaved) break;  // NULL-block DC
      const bool is_eob = !is_dc && value == 0;
      const int new_coeff = is_dc ? 1 : coeff + (value >> 4);
      if (!is_dc && !is_eob && new_coeff > 63) break;  // AC run past 63

      // The symbol is live.  Store `v` at position `pos` of the block,
      // emitted at lockstep step `at`.
      auto put = [&](int pos, int v, int at) {
        if (MODE == MODE_COUNT) {
          wrote = wrote || block_ok;
        } else if (dst >= 0) {
          if (TILES) {
            tile[pos] = v;
          } else if (kbase < 0) {
            if (MODE != MODE_RESOLVE) coeffs[dst + pos] = v;
          } else {
            const unsigned long long key =
                (static_cast<unsigned long long>(at + 1) << 32) |
                static_cast<unsigned int>(lane);
            if (MODE == MODE_PLACE) {
              atomicMax(g.bkey + kbase + pos, key);
            } else if (g.bkey[kbase + pos] == key) {
              coeffs[dst + pos] = v;
            }
          }
        }
      };
      if (!is_dc && !is_eob) put(tab[OFF_ZIGZAG + new_coeff], coef_val, step);
      if (is_dc) cur_diff = coef_val;
      const int after = is_dc ? 1 : new_coeff + 1;
      if (is_eob || after >= 64) {
        // int32 wrap-around, as the JAX engine's int32 arithmetic
        const int pred = comp == 0 ? pred0
                       : comp == 1 ? pred1
                       : comp == 2 ? pred2 : pred3;
        const int dc = static_cast<int>(static_cast<uint32_t>(pred) +
                                        static_cast<uint32_t>(cur_diff));
        put(0, dc, step + 1);  // the scan emits it a step later
        if (TILES && dst >= 0) flush(coeffs + dst);
        pred0 = comp == 0 ? dc : pred0;
        pred1 = comp == 1 ? dc : pred1;
        pred2 = comp == 2 ? dc : pred2;
        pred3 = comp == 3 ? dc : pred3;
        coeff = 0;
        if (++slot >= p.bpm) {
          slot = 0;
          ++mcu;
          next_mcu();
          wrote = false;
        }
        begin_block();
      } else {
        coeff = after;
      }
      bitpos += need;
      const int nw = bitpos >> 5;  // a symbol crosses at most one word
      if (nw != widx) {
        widx = nw;
        if (STAGED) {
          buf = (buf << 32) | word(widx + 1);
        } else {
          buf = (buf << 32) | ahead;
          ahead = word(widx + 2);
        }
      }
    }
    if (TILES && mcu < p.ri) {
      // The block the lane died in keeps what it decoded (ACs, DC 0); the
      // rest of its region is zero.
      flush(coeffs + dst);
      for (int s = slot + 1; s < p.bpm; ++s)
        zero_block(coeffs + block_dst(s));
      next_mcu();
      for (int m = mcu + 1; m < p.ri; ++m, next_mcu())
        for (int s = 0; s < p.bpm; ++s) zero_block(coeffs + block_dst(s));
    }
    if (TILES)  // the tiles stay allocated until copied out
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (MODE == MODE_REGION || MODE == MODE_COUNT) mcu_counts[fl] = mcu;
    if (MODE == MODE_COUNT) {
      g.partial[fl] = wrote ? 1 : 0;
      // The walk left the loop at its fatal step, which it began alive.
      if (g.nsteps != nullptr) g.nsteps[fl] = nb > 0 ? step + 1 : 0;
      if (wrote && mcu > 0)  // it ends in row k + 1 of its frame
        sm.cand[atomicAdd(&sm.n_cand, 1)] =
            static_cast<int64_t>(frame) * (p.spf + 1) + k + 1;
    }
  }
  if (MODE != MODE_COUNT) return;

  // The end rows of this CTA's partial lanes may be contested: zero their
  // owner keys here, every CTA its own, in 16-byte stores.  Then add this
  // CTA's lanes of each frame it holds to the frame's ticket (each
  // thread's stores fenced before); the CTA that brings a ticket to spf
  // holds the frame's last stores, lays the frame out and resets the
  // ticket.  Frame-major rows give a CTA a contiguous range of frames,
  // one add a frame; sorted rows may hold a lane of every frame, so the
  // lanes of one frame in a warp add together, by their lowest lane.
  __threadfence();
  __syncthreads();
  zero_key_rows(g.bkey, sm.cand, sm.n_cand, 0, p.bpm * 64, threadIdx.x,
                THREADS);
  if (threadIdx.x == 0) sm.n_done = 0;
  __syncthreads();
  auto add_ticket = [&](int f, unsigned add) {
    if (atomicAdd(g.tickets + f, add) + add == static_cast<unsigned>(p.spf)) {
      g.tickets[f] = 0u;  // every other CTA of the frame has added
      sm.done[atomicAdd(&sm.n_done, 1)] = f;
    }
  };
  if (g.perm == nullptr) {
    const int rows = min(CTA_LANES, p.S - base);
    const int f = base / p.spf + static_cast<int>(threadIdx.x);
    if (f <= (base + rows - 1) / p.spf) {
      const int lo = max(base, f * p.spf);
      const int hi = min(base + rows, (f + 1) * p.spf);
      add_ticket(f, static_cast<unsigned>(hi - lo));
    }
  } else {
    const unsigned walkers = __ballot_sync(0xffffffffu, mine);
    if (mine) {
      const unsigned peers = __match_any_sync(walkers, frame);
      if (__ffs(peers) - 1 == li)
        add_ticket(frame, static_cast<unsigned>(__popc(peers)));
    }
  }
  __syncthreads();
  if (sm.n_done == 0) return;
  __threadfence();
  for (int i = 0; i < sm.n_done; ++i)
    frame_layout(sm.done[i], mcu_counts, g.partial, p, g, sm);
}

template <int MODE, bool STAGED>
int launch_route(const void* tables, const void* words, const void* nbits,
                 void* coeffs, void* mcu_counts, const Params& p,
                 const General& g, void* stream) {
  auto kern = decode_segments_kernel<MODE, STAGED>;
  const size_t smem =
      sizeof(int32_t) * (p.tab_ints +
                         (MODE == MODE_REGION
                              ? CTA_LANES * TILE_STRIDE * TILES_PER_THREAD
                              : 0) +
                         (STAGED ? CTA_LANES * (p.wn + ROW_PAD) : 0));
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (p.S + CTA_LANES - 1) / CTA_LANES;
  kern<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), static_cast<int32_t*>(coeffs),
      static_cast<int32_t*>(mcu_counts), p, g);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return static_cast<int>(err);
}

template <int MODE>
int launch(const void* tables, const void* words, const void* nbits,
           void* coeffs, void* mcu_counts, const Params& p, const General& g,
           int staged, void* stream) {
  if (p.S <= 0) return 0;
  if (p.tab_ints % 4 || p.tab_ints > TABLE_INTS || (staged && p.wn % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return staged ? launch_route<MODE, true>(tables, words, nbits, coeffs,
                                           mcu_counts, p, g, stream)
                : launch_route<MODE, false>(tables, words, nbits, coeffs,
                                            mcu_counts, p, g, stream);
}

}  // namespace

extern "C" int jt_decode_segments_table_ints() { return TABLE_INTS; }
extern "C" int jt_decode_segments_lut_bits() { return LUT_BITS; }
extern "C" int jt_decode_segments_cta_lanes() { return CTA_LANES; }

// Eligible shapes, one pass.  Launches on `stream`; returns
// cudaGetLastError() after the launch.  `staged` picks the route that
// copies each CTA's word slab into shared memory (needs wn % 4 == 0 and
// 16-byte-aligned words).
extern "C" int jt_decode_segments(const void* tables, const void* words,
                                  const void* nbits, void* coeffs,
                                  void* mcu_counts, int S, int wn, int spf,
                                  int ri, int total_blocks, int bpm,
                                  int n_mcus, int interleaved, int m_x,
                                  int vpad, int tab_ints, int staged,
                                  void* stream) {
  const Params p{S,      wn,          spf, ri,   total_blocks, bpm,
                 n_mcus, interleaved, m_x, vpad, tab_ints};
  return launch<MODE_REGION>(tables, words, nbits, coeffs, mcu_counts, p,
                             General{}, staged, stream);
}

// Kernel launches of this file since the library loaded.
extern "C" long long jt_decode_segments_launches() { return g_launches; }

// General shapes, pass 1: per-lane MCU counts and partial flags, then each
// frame's layout (lane_off, lane_first, the contested rows, their owner
// keys in bkey zeroed) in the same launch.  `tickets` holds `frames`
// zeros, and holds zeros again when the launch ends.  `perm` (nullable) is
// the rows' lane order, `nsteps` (nullable) receives each lane's steps;
// every per-lane output is frame-major.
extern "C" int jt_decode_segments_count(
    const void* tables, const void* words, const void* nbits,
    void* mcu_counts, void* partial, void* lane_off, void* lane_first,
    void* contested, void* bkey, void* tickets, const void* perm,
    void* nsteps, int S, int wn, int spf, int bpm, int n_mcus,
    int interleaved, int m_x, int vpad, int tab_ints, int staged,
    void* stream) {
  if (spf <= 0 || S % spf) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{S,      wn,          spf, 0,    0,       bpm,
                 n_mcus, interleaved, m_x, vpad, tab_ints};
  General g{};
  g.partial = static_cast<int32_t*>(partial);
  g.lane_off = static_cast<int32_t*>(lane_off);
  g.lane_first = static_cast<int32_t*>(lane_first);
  g.contested = static_cast<int32_t*>(contested);
  g.bkey = static_cast<unsigned long long*>(bkey);
  g.tickets = static_cast<unsigned int*>(tickets);
  g.perm = static_cast<const int32_t*>(perm);
  g.nsteps = static_cast<int32_t*>(nsteps);
  return launch<MODE_COUNT>(tables, words, nbits, nullptr, mcu_counts, p, g,
                            staged, stream);
}

// General shapes, passes 2 and 3 on `stream`: the place walk, then the
// resolve walk (its CTAs without a contested lane return at once; it
// always reads words from device memory).  `perm` as the count walk's.
extern "C" int jt_decode_segments_place(
    const void* tables, const void* words, const void* nbits,
    const void* counts, const void* lane_off, const void* lane_first,
    const void* partial, const void* contested, void* bkey, void* coeffs,
    const void* perm, int S, int wn, int spf, int total_blocks, int bpm,
    int n_mcus, int interleaved, int m_x, int vpad, int tab_ints,
    int staged, void* stream) {
  if (S <= 0) return 0;
  const Params p{S,      wn,          spf, 0,    total_blocks, bpm,
                 n_mcus, interleaved, m_x, vpad, tab_ints};
  General g{};
  g.counts = static_cast<const int32_t*>(counts);
  g.lane_off = const_cast<int32_t*>(static_cast<const int32_t*>(lane_off));
  g.lane_first =
      const_cast<int32_t*>(static_cast<const int32_t*>(lane_first));
  g.partial = const_cast<int32_t*>(static_cast<const int32_t*>(partial));
  g.contested = const_cast<int32_t*>(static_cast<const int32_t*>(contested));
  g.bkey = static_cast<unsigned long long*>(bkey);
  g.perm = static_cast<const int32_t*>(perm);
  const int rc = launch<MODE_PLACE>(tables, words, nbits, coeffs, nullptr, p,
                                    g, staged, stream);
  if (rc != 0) return rc;
  return launch<MODE_RESOLVE>(tables, words, nbits, coeffs, nullptr, p, g,
                              0, stream);
}
