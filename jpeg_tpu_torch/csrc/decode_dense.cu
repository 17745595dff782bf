// coeffs_to_pixels: the dense decode tail for Hopper (sm_90a), plane-major
// quantized coefficients to interleaved pixel frames.
//
// Replaces the JAX package's XLA dense device program
// (jpeg_tpu/models/device_decode.py:149: dequantize
// ops/quant.dequantize, IDCT + level shift models/batch.decode_blocks_batch,
// nearest-neighbour upsampling ops/resample.upsample_nn, colour
// ops/color.ycc_to_rgb_planar / to_rgb, roundf, clip and the interleave).
// On the TPU, and in the plain version models/decode_dense.py::
// coeffs_to_pixels_ref, those are separate ops with full-frame float32
// intermediates in device memory; here a CTA decodes one tile at a time --
// up to TILE_BLOCKS blocks: a run of MCUs of one MCU row
// (models/decode_dense.tile_plan) -- so nothing but the int32
// coefficients and the frames' tables is read and nothing but the
// uint8/uint16 pixels is written.
//
// A persistent grid (as many CTAs as fit on the SMs) walks the tiles
// t = blockIdx.x, t += gridDim.x.  Each CTA keeps a ring of STAGES tile
// stages in shared memory, a block every BLK = 72 ints: the copies of tile
// i + STAGES are issued as soon as tile i's pixels are made, so they are in
// flight through tile i's stores and tile i + 1's compute.  A tile is the
// runs of its plan (tile_plan's `runs`: one per component block row, a
// contiguous run of n * h_j blocks in the plane), each block one bulk
// asynchronous copy (cp.async.bulk of 256 bytes, issued by warp 0,
// completing on the stage's mbarrier); where the coefficients are not
// 16-byte aligned (only a view can be: blocks are 256 bytes), every
// thread copies with 4-byte cp.async on the same barrier instead.  The
// IDCT works in place in the stage, so a CTA needs ~44 KB at 4:2:0 and
// several fit on an SM.  Per tile:
//
//   B. IDCT rows, one thread per block row: the 8 coefficients, dequantized
//      with the frame's own table (qtables [F, 4, 64], frame stride 0 when
//      all frames share one set; reloaded only when the frame changes),
//      64 fmaf, back in place as floats;
//   C. IDCT columns: one thread per block column, 64 fmaf, + 2^(P-1);
//   D. one thread per run of 8 pixels of a row (all in one MCU): each
//      component's 8 samples by vector loads from one block row
//      (nearest-neighbour upsampling), colour, roundf, clip, packed into
//      32-bit stores of the staged copy of the tile's interleaved rows;
//      then the stage's next copies are issued;
//   E. the rows out, 16-byte stores where the rows are aligned, else one
//      sample at a time (stores do not wait: they overlap the next tile);
//      only rows < H and columns < W are computed and stored.
//
// The 72-int block pitch puts the 4 blocks x 8 columns of a warp in C on
// 32 distinct banks and keeps every block row 16-byte aligned for B and D.
//
// Numerics, held against the plain version within +-1 per sample (and
// operand for operand those of the one-tile-per-CTA kernel before it, so
// byte-identical to it):
//   * dequantize is the int32 product (as uint32, so a damaged stream's
//     huge DC wraps as torch's int32 multiply does) and one conversion;
//   * the IDCT is separable, rows then columns, with the dct_lut_f32
//     coefficients (ops/dct.lut_on) and fmaf chains over ascending taps;
//     the plain version multiplies by the [64, 64] Kronecker operator in
//     cuBLAS's order.  This sum's order is the only difference between
//     the two, so a sample moves by 1 only where its value sits on a
//     rounding boundary;
//   * colour uses __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn with
//     float32 constants, the eager float32 ops of ops/color.py operand for
//     operand, so nvcc cannot contract them into FMAs;
//   * roundf rounds half away from zero, as utils/floatops.roundf (rintf
//     rounds ties to even and would be wrong); kernels.py builds without
//     --use_fast_math.
//
// What bounds it on the H100: an 8-frame 1080p 4:2:0 chunk reads 100.3 MB
// of int32 coefficients and writes 49.8 MB of uint8 pixels (~45 us at
// 3.35 TB/s); the separable IDCT is 2,048 float32 operations a block,
// 0.8 G per chunk (~12 us at the float32 peak).  So the function is bound
// by bytes, but the kernel issues ~7,000 warp instructions a tile (the
// pixel phase most), so its SMs' issue slots and the latency between its
// barriers hold it well above that bound.  The design takes the load
// instructions and their component search out of the threads (bulk copies
// over the plan's runs; phase B still finds each block row's table by a
// short search over the components), keeps loads in flight through the
// compute (the ring), computes the
// pixels 8 at a time (one index computation and vector sample loads a run,
// packed stores), and keeps every intermediate in shared memory: every
// coefficient is read once and every pixel written once.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "resident.cuh"

namespace {

constexpr int COMP_INTS = 8;  // models/decode_dense.py COMP_INTS
constexpr int RUN_INTS = 4;   // models/decode_dense.py RUN_INTS
constexpr int RUN_MAX = 16;   // models/decode_dense.py RUN_MAX
constexpr int C_MAX = 4;
constexpr int THREADS = 128;
constexpr int TILE_BLOCKS = 64;  // models/decode_dense.py TILE_BLOCKS
constexpr int STAGES = 2;        // tile stages of the ring
constexpr int BLK = 72;  // ints (then floats) of a block in a stage
constexpr int PLAN_INTS = C_MAX * COMP_INTS + RUN_MAX * RUN_INTS;

struct Params {
  int frames, height, width, nf, nc, precision, tb;
  int m_x, m_y, mcus, tiles_x, mcu_w, mcu_h, bpm, qt_stride, n_runs;
};

// Byte offsets of the shared memory of a CTA, for tiles of tile_blocks
// blocks: the stages' mbarriers, the ring of stages, the IDCT
// coefficients, the frame's four tables, the component records and runs,
// then the staged pixel rows.  Every offset is a multiple of 16.
struct Smem {
  int ring, lut, q, plan, px;
};

__host__ __device__ inline Smem smem_layout(int tile_blocks) {
  Smem m;
  m.ring = 128;
  m.lut = m.ring + STAGES * tile_blocks * BLK * 4;
  m.q = m.lut + 64 * 4;
  m.plan = m.q + 4 * 64 * 4;
  m.px = m.plan + PLAN_INTS * 4;
  return m;
}
static_assert(PLAN_INTS * 4 % 16 == 0 && BLK * 4 % 16 == 0,
              "stages and the pixel stage must be 16-aligned");

// x / d for an upsampling step d = max sampling / sampling, 1..4: the same
// d for every thread of a component, so the branch does not diverge.
__device__ __forceinline__ int div_step(int x, int d) {
  switch (d) {
    case 1: return x;
    case 2: return x >> 1;
    case 4: return x >> 2;
    case 3: return x / 3;
    default: return x / d;
  }
}

// float(int32(a * b)): the product wraps as torch's int32 multiply does.
__device__ __forceinline__ float dequant(int32_t a, int32_t b) {
  return static_cast<float>(static_cast<int32_t>(
      static_cast<uint32_t>(a) * static_cast<uint32_t>(b)));
}

template <typename T>
__device__ __forceinline__ T quantize(float v, float maxval) {
  v = fminf(fmaxf(roundf(v), 0.f), maxval);
  return static_cast<T>(static_cast<int>(v));
}

// Tile t: frame f, MCU row my, tile column tx, of n MCUs.
struct Tile {
  int f, my, tx, n;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int per_frame = p.m_y * p.tiles_x;
  Tile u;
  u.f = t / per_frame;
  const int rem = t - u.f * per_frame;
  u.my = rem / p.tiles_x;
  u.tx = rem - u.my * p.tiles_x;
  u.n = min(p.mcus, p.m_x - u.tx * p.mcus);
  return u;
}

// First plane block of run rn of tile u (frame-relative).
__device__ __forceinline__ int64_t run_src(const Params& p,
                                           const int32_t* CP,
                                           const int32_t* rn, const Tile& u) {
  const int32_t* c = CP + rn[0] * COMP_INTS;
  return c[4] + static_cast<int64_t>(u.my * c[1] + rn[1]) * c[5] +
         static_cast<int64_t>(u.tx) * p.mcus * c[0];
}

// Issue tile t's blocks into stage `dst` (a block every BLK ints) on `bar`:
// run r of the plan is component j's block row r_j of the tile, n * h_j
// contiguous plane blocks to stage slots n * first_r on.  Warp 0 issues
// one bulk copy per block; with coefficients off a 16-byte boundary every
// thread copies 4 bytes at a time instead.  Every thread arrives once on
// `bar` (its count is THREADS).
__device__ __forceinline__ void load_tile(const Params& p,
                                          const int32_t* coeffs,
                                          const int32_t* CP, int t,
                                          int32_t* dst, uint64_t* bar,
                                          bool bulk) {
  const Tile u = tile_at(p, t);
  const int32_t* cf = coeffs + static_cast<int64_t>(u.f) * p.tb * 64;
  const int32_t* RN = CP + C_MAX * COMP_INTS;
  if (bulk) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        // the stage was last read through the generic proxy
        fence_proxy_async();
        mbar_arrive_expect_tx(bar, u.n * p.bpm * 64 * 4);
      }
      __syncwarp();
      for (int r = 0; r < p.n_runs; ++r) {
        const int32_t* rn = RN + r * RUN_INTS;
        const int32_t* from = cf + run_src(p, CP, rn, u) * 64;
        int32_t* to = dst + u.n * rn[2] * BLK;
        for (int i = threadIdx.x; i < u.n * rn[3]; i += 32)
          bulk_copy(to + i * BLK, from + i * 64, 64 * 4, bar);
      }
      if (threadIdx.x != 0) mbar_arrive(bar);
    } else {
      mbar_arrive(bar);
    }
  } else {
    for (int r = 0; r < p.n_runs; ++r) {
      const int32_t* rn = RN + r * RUN_INTS;
      const int32_t* from = cf + run_src(p, CP, rn, u) * 64;
      int32_t* to = dst + u.n * rn[2] * BLK;
      for (int e = threadIdx.x; e < u.n * rn[3] * 64; e += THREADS)
        copy4(to + (e >> 6) * BLK + (e & 63), from + e);
    }
    copy4_arrive(bar);
  }
}

// The 8 samples of a component for pixels px0 .. px0 + 7 (px0 a multiple
// of 8) of one sample row `row` (a pointer to the row's 8 floats in the
// first block of the component's block row), upsampled by the step d:
// aligned vector loads where d is 1, 2 or 4.
__device__ __forceinline__ void samples8(const float* row, int px0, int d,
                                         float v[8]) {
  if (d == 1) {
    const float4* b = reinterpret_cast<const float4*>(row + (px0 >> 3) * BLK);
    const float4 a0 = b[0], a1 = b[1];
    v[0] = a0.x, v[1] = a0.y, v[2] = a0.z, v[3] = a0.w;
    v[4] = a1.x, v[5] = a1.y, v[6] = a1.z, v[7] = a1.w;
  } else if (d == 2) {
    const int sx = px0 >> 1;  // a multiple of 4
    const float4 a =
        *reinterpret_cast<const float4*>(row + (sx >> 3) * BLK + (sx & 7));
    v[0] = v[1] = a.x, v[2] = v[3] = a.y, v[4] = v[5] = a.z,
    v[6] = v[7] = a.w;
  } else if (d == 4) {
    const int sx = px0 >> 2;  // a multiple of 2
    const float2 a =
        *reinterpret_cast<const float2*>(row + (sx >> 3) * BLK + (sx & 7));
    v[0] = v[1] = v[2] = v[3] = a.x;
    v[4] = v[5] = v[6] = v[7] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int sx = div_step(px0 + i, d);
      v[i] = row[(sx >> 3) * BLK + (sx & 7)];
    }
  }
}

// Four samples of type T packed into a 32-bit word (two for uint16).
__device__ __forceinline__ uint32_t pack(const uint8_t* v) {
  return v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<uint32_t>(v[3])
                                                << 24);
}
__device__ __forceinline__ uint32_t pack(const uint16_t* v) {
  return v[0] | (static_cast<uint32_t>(v[1]) << 16);
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
coeffs_to_pixels_kernel(const int32_t* __restrict__ coeffs,  // [F, tb, 64]
                        const int32_t* __restrict__ qtables,  // [F, 4, 64]
                        const float* __restrict__ lut,  // [8 x][8 u]
                        const int32_t* __restrict__ plan,  // [PLAN_INTS]
                        T* __restrict__ out,  // [F, H, W, NC]
                        Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile_blocks = p.mcus * p.bpm;
  const Smem L = smem_layout(tile_blocks);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [STAGES]
  int32_t* ring = reinterpret_cast<int32_t*>(smem + L.ring);
  float* A = reinterpret_cast<float*>(smem + L.lut);
  int32_t* Q = reinterpret_cast<int32_t*>(smem + L.q);
  int32_t* CP = reinterpret_cast<int32_t*>(smem + L.plan);
  T* stage = reinterpret_cast<T*>(smem + L.px);
  const int tid = threadIdx.x;
  const int stage_ints = tile_blocks * BLK;
  const int tiles = p.frames * p.m_y * p.tiles_x;
  const bool bulk = reinterpret_cast<uintptr_t>(coeffs) % 16 == 0;

  if (tid < 64) A[tid] = lut[tid];
  for (int i = tid; i < PLAN_INTS; i += THREADS) CP[i] = plan[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + s, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  for (int s = 0; s < STAGES; ++s) {
    const int64_t t = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
    if (t < tiles)
      load_tile(p, coeffs, CP, static_cast<int>(t), ring + s * stage_ints,
                bar + s, bulk);
  }

  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float shift = static_cast<float>(1 << (p.precision - 1));
  const float maxval = static_cast<float>((1 << p.precision) - 1);
  const float denom = static_cast<float>(1 << p.precision);
  int q_frame = -1;
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const Tile u = tile_at(p, t);
    const int n = u.n, nblk = n * p.bpm;
    const int y0 = u.my * p.mcu_h, x0 = u.tx * p.mcus * p.mcu_w;
    const int qf = p.qt_stride ? u.f : 0;
    if (qf != q_frame) {  // the same frame for every thread
      const int32_t* q = qtables + static_cast<int64_t>(u.f) * p.qt_stride;
      for (int i = tid; i < 4 * 64; i += THREADS) Q[i] = q[i];
      q_frame = qf;
      __syncthreads();
    }
    const int s = k % STAGES;
    mbar_wait(bar + s, (k / STAGES) & 1);
    int32_t* raw = ring + s * stage_ints;
    float* S = reinterpret_cast<float*>(raw);  // the same blocks, in place

    // B. Rows, in place: T[u][x] = sum_v X[u][v] * A[x][v], X the block of
    // slot b dequantized with its component's table (component j's blocks
    // from slot n * first_j).
    for (int e = tid; e < nblk * 8; e += THREADS) {
      const int b = e >> 3, uu = e & 7;
      int j = 0;
      while (j + 1 < p.nf && b >= n * CP[(j + 1) * COMP_INTS + 7]) ++j;
      const int32_t* q = Q + CP[j * COMP_INTS + 6] * 64 + uu * 8;
      int4* r4 = reinterpret_cast<int4*>(raw + b * BLK + uu * 8);
      const int4 lo = r4[0], hi = r4[1];
      float x[8];
      x[0] = dequant(lo.x, q[0]);
      x[1] = dequant(lo.y, q[1]);
      x[2] = dequant(lo.z, q[2]);
      x[3] = dequant(lo.w, q[3]);
      x[4] = dequant(hi.x, q[4]);
      x[5] = dequant(hi.y, q[5]);
      x[6] = dequant(hi.z, q[6]);
      x[7] = dequant(hi.w, q[7]);
      float y[8];
#pragma unroll
      for (int xx = 0; xx < 8; ++xx) {
        const float4 a0 = A4[xx * 2], a1 = A4[xx * 2 + 1];
        float acc = fmaf(x[0], a0.x, 0.f);
        acc = fmaf(x[1], a0.y, acc);
        acc = fmaf(x[2], a0.z, acc);
        acc = fmaf(x[3], a0.w, acc);
        acc = fmaf(x[4], a1.x, acc);
        acc = fmaf(x[5], a1.y, acc);
        acc = fmaf(x[6], a1.z, acc);
        acc = fmaf(x[7], a1.w, acc);
        y[xx] = acc;
      }
      float4* w4 = reinterpret_cast<float4*>(r4);
      w4[0] = make_float4(y[0], y[1], y[2], y[3]);
      w4[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    __syncthreads();

    // C. Columns, in place: out[y][x] = sum_u A[y][u] * T[u][x] + 2^(P-1).
    // A warp's 32 columns are 4 blocks x 8: the blocks' 72-int pitch puts
    // them on 32 distinct banks.
    for (int e = tid; e < nblk * 8; e += THREADS) {
      float* col = S + (e >> 3) * BLK + (e & 7);
      float tt[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) tt[v] = col[v * 8];
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const float4 a0 = A4[y * 2], a1 = A4[y * 2 + 1];
        float acc = fmaf(a0.x, tt[0], 0.f);
        acc = fmaf(a0.y, tt[1], acc);
        acc = fmaf(a0.z, tt[2], acc);
        acc = fmaf(a0.w, tt[3], acc);
        acc = fmaf(a1.x, tt[4], acc);
        acc = fmaf(a1.y, tt[5], acc);
        acc = fmaf(a1.z, tt[6], acc);
        acc = fmaf(a1.w, tt[7], acc);
        col[y * 8] = __fadd_rn(acc, shift);
      }
    }
    __syncthreads();

    // D. Pixels of the tile inside the frame, 8 of a row at a time (a run
    // of 8 columns lies in one MCU, so all its samples are in the stage),
    // into the pixel stage as [rows][cols][NC].
    const int rows = min(p.mcu_h, p.height - y0);
    const int cols = min(n * p.mcu_w, p.width - x0);
    const int octs = (cols + 7) >> 3;
    for (int e = tid; e < rows * octs; e += THREADS) {
      const int py = e / octs;
      const int px0 = (e - py * octs) << 3;
      float sm[C_MAX][8];
#pragma unroll
      for (int j = 0; j < (NC == 1 ? 1 : C_MAX); ++j) {
        if (j < p.nf) {
          const int32_t* c = CP + j * COMP_INTS;
          const int sy = div_step(py, c[2]);
          samples8(S + (n * c[7] + (sy >> 3) * (n * c[0])) * BLK +
                       (sy & 7) * 8,
                   px0, c[3], sm[j]);
        }
      }
      T v[8 * NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (NC == 1) {
          v[i] = quantize<T>(sm[0][i], maxval);
        } else {
          // Planar YCbCr -> RGB (ops/color.ycc_to_rgb_planar, float32).
          const float cb = __fsub_rn(sm[1][i], shift);
          const float cr = __fsub_rn(sm[2][i], shift);
          float r = __fadd_rn(sm[0][i], __fmul_rn(1.402f, cr));
          float g = __fsub_rn(__fsub_rn(sm[0][i], __fmul_rn(0.34414f, cb)),
                              __fmul_rn(0.71414f, cr));
          float bl = __fadd_rn(sm[0][i], __fmul_rn(1.772f, cb));
          if (p.nf == 4) {
            // YCCK: CMY from the first three, inverted through K
            // (ops/color.ycck_to_rgb); K itself is dropped.
            const float kk = sm[3][i];
            r = __fsub_rn(kk, __fdiv_rn(__fmul_rn(r, kk), denom));
            g = __fsub_rn(kk, __fdiv_rn(__fmul_rn(g, kk), denom));
            bl = __fsub_rn(kk, __fdiv_rn(__fmul_rn(bl, kk), denom));
          }
          v[3 * i] = quantize<T>(r, maxval);
          v[3 * i + 1] = quantize<T>(g, maxval);
          v[3 * i + 2] = quantize<T>(bl, maxval);
        }
      }
      T* o = stage + (py * cols + px0) * NC;
      const int npx = min(8, cols - px0);
      if (npx == 8 && reinterpret_cast<uintptr_t>(o) % 4 == 0) {
        constexpr int PER = 4 / sizeof(T);
#pragma unroll
        for (int w = 0; w < 8 * NC / PER; ++w)
          reinterpret_cast<uint32_t*>(o)[w] = pack(v + w * PER);
      } else {
#pragma unroll
        for (int i = 0; i < 8 * NC; ++i)
          if (i < npx * NC) o[i] = v[i];
      }
    }
    __syncthreads();
    // The stage is read: its next tile's copies go in flight, over E and
    // the next tile's compute.
    if (static_cast<int64_t>(t) + STAGES * gridDim.x < tiles)
      load_tile(p, coeffs, CP, t + STAGES * gridDim.x, raw, bar + s, bulk);

    // E. The staged rows out.  The next tile writes the pixel stage only
    // after two more barriers (B and C), so no barrier closes the tile.
    const int64_t pitch = static_cast<int64_t>(p.width) * NC;
    T* dst = out + (static_cast<int64_t>(u.f) * p.height + y0) * pitch +
             static_cast<int64_t>(x0) * NC;
    const int row_elems = cols * NC;
    const bool wide = (row_elems * sizeof(T)) % 16 == 0 &&
                      (pitch * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dst) % 16 == 0;
    if (wide) {
      const int vpr = static_cast<int>(row_elems * sizeof(T) / 16);
      for (int e = tid; e < rows * vpr; e += THREADS) {
        const int r = e / vpr;
        reinterpret_cast<uint4*>(dst + r * pitch)[e - r * vpr] =
            reinterpret_cast<const uint4*>(stage)[e];
      }
    } else {
      for (int e = tid; e < rows * row_elems; e += THREADS) {
        const int r = e / row_elems;
        dst[r * pitch + (e - r * row_elems)] = stage[e];
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch_kernel(const int32_t* coeffs, const int32_t* qtables,
                         const float* lut, const int32_t* plan, T* out,
                         const Params& p, cudaStream_t s) {
  const size_t stage =
      static_cast<size_t>(p.mcu_h) * p.mcus * p.mcu_w * NC * sizeof(T);
  const size_t shared =
      smem_layout(p.mcus * p.bpm).px + (stage + 15) / 16 * 16;
  auto kernel = coeffs_to_pixels_kernel<T, NC>;
  const int64_t tiles = static_cast<int64_t>(p.frames) * p.m_y * p.tiles_x;
  if (tiles > 0x7fffffff - (1 << 24)) return cudaErrorInvalidConfiguration;
  int ctas = 0;
  const cudaError_t err =
      resident_ctas(reinterpret_cast<const void*>(kernel), THREADS, shared,
                    &ctas);
  if (err != cudaSuccess) return err;
  const int64_t grid = std::min<int64_t>(tiles, ctas);
  kernel<<<static_cast<unsigned>(grid), THREADS, shared, s>>>(
      coeffs, qtables, lut, plan, out, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiles(const int32_t* coeffs, const int32_t* qtables,
                         const float* lut, const int32_t* plan, T* out,
                         const Params& p, cudaStream_t s) {
  return p.nc == 1
             ? launch_kernel<T, 1>(coeffs, qtables, lut, plan, out, p, s)
             : launch_kernel<T, 3>(coeffs, qtables, lut, plan, out, p, s);
}

}  // namespace

extern "C" int jt_decode_dense_tile_blocks() { return TILE_BLOCKS; }
extern "C" int jt_decode_dense_comp_ints() { return COMP_INTS; }
extern "C" int jt_decode_dense_plan_ints() { return PLAN_INTS; }

// Launches the kernel on `stream`; returns the CUDA error (0 on success).
// `plan` holds the component records [C_MAX, COMP_INTS], then the runs
// [RUN_MAX, RUN_INTS] of a tile (models/decode_dense.tile_plan).
extern "C" int jt_coeffs_to_pixels(const void* coeffs, const void* qtables,
                                   const void* lut, const void* plan,
                                   void* out, int is16, int frames,
                                   int height, int width, int nf, int nc,
                                   int precision, int tb, int m_x, int m_y,
                                   int mcus, int tiles_x, int mcu_w,
                                   int mcu_h, int bpm, int qt_stride,
                                   int n_runs, void* stream) {
  const Params p{frames, height, width, nf, nc, precision, tb, m_x,
                 m_y, mcus, tiles_x, mcu_w, mcu_h, bpm, qt_stride, n_runs};
  if (frames <= 0) return 0;
  if (mcus * bpm > TILE_BLOCKS || nf < 1 || nf > C_MAX ||
      (nc != 1 && nc != 3) || n_runs < 1 || n_runs > RUN_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(coeffs);
  const int32_t* q = static_cast<const int32_t*>(qtables);
  const float* l = static_cast<const float*>(lut);
  const int32_t* pl = static_cast<const int32_t*>(plan);
  const cudaError_t err =
      is16 ? launch_tiles(c, q, l, pl, static_cast<uint16_t*>(out), p, s)
           : launch_tiles(c, q, l, pl, static_cast<uint8_t*>(out), p, s);
  return static_cast<int>(err);
}
