// decode_frame_fast (K11) and encode_frame_fast (K12): the fast mode's
// dense stages for Hopper (sm_90a), between plane-major int32
// coefficients and a float32 frame.
//
// K11 replaces the JAX package's jitted XLA program
// jpeg_tpu/api.py::_jitted_decode_frame(geom, exact=False), which jits
// jpeg_tpu/models/pipeline.py::decode_frame (ops/quant.dequantize,
// ops/dct.idct8x8_matmul, the level shift, ops/blocks.blocks_to_plane,
// ops/resample.upsample_nn, ops/color.to_rgb); K12 replaces
// jpeg_tpu/encoder.py::_jitted_encode_frame(geom, exact=False), which jits
// models/pipeline.py::encode_frame (ops/color.rgb_to_ycc inside the true
// window, ops/resample.downsample_box, the level shift,
// ops/dct.fdct8x8_matmul, ops/quant.quantize).  On the TPU, and in the
// plain versions models/dense_fast.py::*_ref, those are separate ops with
// full-frame float32 intermediates in device memory; here one launch reads
// its input once and writes its output once, every intermediate in shared
// memory.
//
// What bounds them on the H100: bench frame 0 (1080p 4:2:0, 48,960
// blocks) is 12.53 MB of int32 coefficients one way and a 25.07 MB float32
// frame the other, 37.6 MB, ~11.2 us at 3.35 TB/s; the separable DCTs are
// 2,048 float32 operations a block, 0.1 G a frame (~1.5 us at the float32
// peak).  So both are bound by bytes, and what keeps them from that bound
// is the instructions between the bytes (a shared-memory read of the LUT
// per multiply-add, of the records and spans per pixel; 4-byte stores at
// a 12- or 32-byte stride) and loads, compute and stores that wait on one
// another.  So both kernels:
//   * take the cosine LUT A[x][u] (ops/dct.dct_lut_f32) and the component
//     records by value, so every multiply-add reads A from the constant
//     bank and no thread reads a record or a span from shared memory (the
//     spans of a tile are a few integers a thread recomputes);
//   * walk their tiles in a persistent grid (resident.cuh), each CTA with a
//     ring of 2 input stages filled by bulk asynchronous copies
//     (async_copy.cuh): a tile's stage, once read, takes the copies of the
//     CTA's tile two ahead, in flight over the rest of this tile and the
//     next; 4-byte asynchronous copies where the input is off 16-byte
//     alignment;
//   * move rows through shared memory as 16-byte accesses with the halves
//     of a row swapped on every other group of 4 lanes, so the 8 lanes of
//     a phase cover all 32 banks;
//   * are instantiated for the common samplings (every upsampling step 1
//     or 2; every box 1 x 1 or the one cell of the frame), where a sample
//     index is a shift, beside the general code for every other frame (on
//     bench frame 0, NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py
//     --compare against a copy forced onto the general code: K11
//     0.0188-0.0191 ms against 0.0209-0.0214, K12 0.0236-0.0237 against
//     0.0457-0.0459, device only).
//
// K11: tiles of the padded frame's pixels (models/dense_fast.decode_tiles:
// one MCU row high, whole MCUs, ~64 columns wide).  Per tile:
//   copies: the rectangle of blocks each channel's pixels read (the span:
//      samples y / step_y, x / step_x of the pixels below the component's
//      painted size, so a sampling ratio that does not divide works too),
//      one contiguous run of 256-byte blocks a block row, channel after
//      channel into the stage (models/dense_fast.tile_runs);
//   B. IDCT rows, a thread per block row: 8 coefficients dequantized (the
//      int32 product, as uint32 so that a huge value wraps as torch's int32
//      multiply does, then one conversion), 64 fmaf, into a float stage of
//      72-float blocks (two of them, so the next tile's rows do not wait
//      for this tile's pixels); the coefficient stage is then free, and
//      the tile two ahead is copied into it;
//   C. IDCT columns, a thread per block column, + 2^(P-1), in place (the
//      72-float pitch puts a warp's 4 blocks x 8 columns on 32 banks);
//   D. a thread per run of 4 pixels of a row: each channel's 4 samples
//      (nearest neighbour: one float4 at step 1, one float2 at step 2, a
//      sample at a time in the general code, 0.0 past the component's
//      painted plane, the reference's untouched margin), colour (YCbCr or
//      YCCK -> RGB, gray as it is), and the run's floats out as 1, 3 or 4
//      16-byte stores (unrounded, unclipped; the frame is the wrapper's own
//      aligned tensor).
// K12: tiles of MCUs of one MCU row (models/dense_fast.encode_tiles, at
// most ENCODE_TILE_BLOCKS blocks, so that 3 CTAs of 256 threads fit an
// SM).  Per tile:
//   copies: the tile's float pixels, one contiguous run a pixel row;
//   B. a thread per box cell (the pixels one chroma sample averages: 2 x 2
//      at 4:2:0): it reads the cell's pixels once (8-byte loads), converts
//      each pixel once (YCbCr inside the true [height, width] window, the
//      raw padded channel outside it, frame.c:162-163), writes each luma
//      sample and the cell's chroma samples, level-shifted, into the block
//      stage; in the general code a thread per component sample;
//   C. FDCT rows, a thread per block row, in place;
//   D. FDCT columns, a thread per block column, each coefficient quantized
//      by K5's quantizer round_away(__fdiv_rn(c, q)) into the stage, in
//      place, raster order: no zig-zag, no DC difference;
//   E. whole 256-byte blocks out with 16-byte stores: a tile's blocks of
//      one component block row are consecutive plane rows.
//
// Numerics, held against the plain versions: the DCTs are separable fmaf
// chains over ascending taps from 0.f; the plain versions multiply by the
// same matrix in cuBLAS's (or the CPU's) order.  That order is the only difference, so the floats agree
// within ~1e-4 and a quantized value moves by 1 only where c / q sits on a
// rounding boundary.  Colour, the box and the level shifts use __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn with float32 constants, the eager
// float32 ops operand for operand, so nvcc cannot contract them into FMAs;
// kernels.py builds without --use_fast_math.  A 1 x 1 box's sample is
// value - shift, as the plain version's; the general code's box sum
// (0 + value) / 1 - shift gives the same float for every non-NaN value
// (adding 0 only turns -0 into +0, which the subtraction of a nonzero
// shift cannot tell apart).  A 2- or 4-pixel box divides by multiplying
// with 1/2 or 1/4: a power of two, so the product rounds the same real
// number as the plain version's quotient.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "resident.cuh"
#include "round_away.cuh"

namespace {

constexpr int COMP_INTS = 8;  // models/dense_fast.py COMP_INTS
constexpr int C_MAX = 4;      // models/dense_fast.py C_MAX
constexpr int BP = 72;        // models/dense_fast.py BLOCK_FLOATS
constexpr int THREADS = 256;
constexpr int STAGES = 2;  // stages of a CTA's ring
// Record fields (models/dense_fast.comp_records).
constexpr int F_H = 0, F_V = 1, F_SY = 2, F_SX = 3, F_FIRST = 4, F_BX = 5,
              F_TQ = 6;
// Shared memory before the stages: the ring's mbarriers, then the four
// tables (models/dense_fast.py HEAD_BYTES).
constexpr int HEAD_BYTES = 16 + 4 * 64 * 4;
static_assert(HEAD_BYTES % 16 == 0 && BP % 4 == 0,
              "the stages must be 16-byte aligned");

struct Lut {
  float a[64];  // A[x][u] at x * 8 + u
};

// The component records, passed by value: K11's in channel order (the
// output channel k reads record k), K12's in geometry order.
struct Recs {
  int32_t r[C_MAX][COMP_INTS];
};

// float(int32(a * b)): the product wraps as torch's int32 multiply does.
__device__ __forceinline__ float dequant(int32_t a, int32_t b) {
  return __int2float_rn(static_cast<int>(static_cast<uint32_t>(a) *
                                         static_cast<uint32_t>(b)));
}

__device__ __forceinline__ int div_step(int a, int s) {
  return s == 1 ? a : (s == 2 ? a >> 1 : a / s);
}

// The two 16-byte halves of an 8-float row at `p` (16-byte aligned),
// the half `h` read first: lanes 4-7 of each group of 8 pass h = 1, so
// the 8 lanes of a phase, 32 bytes apart, cover all 32 banks.
template <typename V>
__device__ __forceinline__ void load_row(const V* p, int h, V& lo, V& hi) {
  const V a = p[h], b = p[h ^ 1];
  lo = h ? b : a;
  hi = h ? a : b;
}

template <typename V>
__device__ __forceinline__ void store_row(V* p, int h, const V& lo,
                                          const V& hi) {
  p[h] = h ? hi : lo;
  p[h ^ 1] = h ? lo : hi;
}

// ---------------------------------------------------------------- K11

struct DecodeParams {
  int size_y, size_x, precision, m_y, tile_h, tile_w, tiles_x, tiles,
      stage_blocks;
};

// Tile t's pixels [y0, y1) x [x0, x1) of the padded frame.
struct Box {
  int y0, x0, y1, x1;
};

__device__ __forceinline__ Box tile_box(const DecodeParams& p, int t) {
  const int ty = t / p.tiles_x, tx = t - ty * p.tiles_x;
  Box b;
  b.y0 = ty * p.tile_h;
  b.x0 = tx * p.tile_w;
  b.y1 = min(b.y0 + p.tile_h, p.size_y);
  b.x1 = min(b.x0 + p.tile_w, p.size_x);
  return b;
}

// The blocks of a component's plane (first, count) that the pixels
// [p0, p1) of one axis read: the samples p / step of the pixels below
// `painted` (models/dense_fast.py _span).
__device__ __forceinline__ void span(int p0, int p1, int step, int painted,
                                     int& first, int& count) {
  const int end = min(p1, painted);
  if (p0 >= end) {
    first = count = 0;
    return;
  }
  first = div_step(p0, step) >> 3;
  count = (div_step(end - 1, step) >> 3) - first + 1;
}

// Each channel's span of a tile (block rows br0 + [0, nbr), block columns
// bc0 + [0, nbc)) and its first stage block; slot[NF] is the tile's
// blocks.
template <int NF>
struct Spans {
  int br0[NF], nbr[NF], bc0[NF], nbc[NF], slot[NF + 1];
};

// POW2: every step is 1 or 2 and every plane is painted over the whole
// frame (models/dense_fast.pow2_sampling), so a sample index is a shift.
template <int NF, bool POW2>
__device__ __forceinline__ Spans<NF> tile_spans(const Recs& R,
                                                const DecodeParams& p,
                                                const Box& b) {
  Spans<NF> s;
  s.slot[0] = 0;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int sy = R.r[k][F_SY], sx = R.r[k][F_SX];
    if (POW2) {
      const int shy = sy >> 1, shx = sx >> 1;
      s.br0[k] = (b.y0 >> shy) >> 3;
      s.nbr[k] = (((b.y1 - 1) >> shy) >> 3) - s.br0[k] + 1;
      s.bc0[k] = (b.x0 >> shx) >> 3;
      s.nbc[k] = (((b.x1 - 1) >> shx) >> 3) - s.bc0[k] + 1;
    } else {
      span(b.y0, b.y1, sy, p.m_y * R.r[k][F_V] * 8 * sy, s.br0[k], s.nbr[k]);
      span(b.x0, b.x1, sx, R.r[k][F_BX] * 8 * sx, s.bc0[k], s.nbc[k]);
    }
    s.slot[k + 1] = s.slot[k] + s.nbr[k] * s.nbc[k];
  }
  return s;
}

// Issue tile t's coefficients into stage `dst` (dense, 64 ints a block),
// completing on `bar`: channel k's block row br0 + rb is one run of nbc
// blocks in its plane, to stage blocks slot[k] + rb * nbc on.  Warp 0
// issues one bulk copy a run (the barrier's count is 1: lane 0's arrival
// with the bytes); off 16-byte alignment every thread copies 4 bytes at a
// time and arrives once its copies land (the count is THREADS).
template <int NF, bool POW2>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ coeffs,
                                          const Recs& R,
                                          const DecodeParams& p, int t,
                                          int32_t* dst, uint64_t* bar,
                                          bool bulk) {
  const Spans<NF> s = tile_spans<NF, POW2>(R, p, tile_box(p, t));
  if (bulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, s.slot[NF] * 256);
    __syncwarp();
    fence_proxy_async();
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      if (s.nbc[k] == 0) continue;
      const int32_t* src =
          coeffs + (R.r[k][F_FIRST] +
                    static_cast<int64_t>(s.br0[k]) * R.r[k][F_BX] + s.bc0[k]) *
                       64;
      for (int rb = threadIdx.x; rb < s.nbr[k]; rb += 32)
        bulk_copy(dst + (s.slot[k] + rb * s.nbc[k]) * 64,
                  src + static_cast<int64_t>(rb) * R.r[k][F_BX] * 64,
                  s.nbc[k] * 256, bar);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int run = s.nbc[k] * 64;
      const int32_t* src =
          coeffs + (R.r[k][F_FIRST] +
                    static_cast<int64_t>(s.br0[k]) * R.r[k][F_BX] + s.bc0[k]) *
                       64;
      for (int e = threadIdx.x; e < s.nbr[k] * run; e += THREADS) {
        const int rb = e / run;
        copy4(dst + s.slot[k] * 64 + e,
              src + static_cast<int64_t>(rb) * R.r[k][F_BX] * 64 +
                  (e - rb * run));
      }
    }
    copy4_arrive(bar);
  }
}

// A run of 4 pixels (NF samples each, ch[k][i]) to their floats at `o`:
// colour (ops/color.ycc_to_rgb_planar, float32; YCCK through K, ops/color.
// ycck_to_rgb, K itself out as 255), then NF 16-byte stores (`o` is
// 16-byte aligned: the frame is the wrapper's own fresh tensor and a run
// starts at a multiple of 4 pixels).
template <int NF>
__device__ __forceinline__ void put_run(float* o, const float (&ch)[NF][4],
                                        float shift, float denom) {
  float v[4 * NF];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (NF == 1) {
      v[i] = ch[0][i];
    } else {
      const float y = ch[0][i];
      const float cbv = __fsub_rn(ch[1][i], shift);
      const float crv = __fsub_rn(ch[2][i], shift);
      float r = __fadd_rn(y, __fmul_rn(1.402f, crv));
      float g = __fsub_rn(__fsub_rn(y, __fmul_rn(0.34414f, cbv)),
                          __fmul_rn(0.71414f, crv));
      float b = __fadd_rn(y, __fmul_rn(1.772f, cbv));
      if constexpr (NF == 4) {  // K - (C * K) / 2^P
        const float k = ch[3][i];
        r = __fsub_rn(k, __fdiv_rn(__fmul_rn(r, k), denom));
        g = __fsub_rn(k, __fdiv_rn(__fmul_rn(g, k), denom));
        b = __fsub_rn(k, __fdiv_rn(__fmul_rn(b, k), denom));
        v[4 * i + 3] = 255.f;
      }
      v[NF * i] = r;
      v[NF * i + 1] = g;
      v[NF * i + 2] = b;
    }
  }
#pragma unroll
  for (int q = 0; q < NF; ++q)
    reinterpret_cast<float4*>(o)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int NF, bool POW2>
__global__ void __launch_bounds__(THREADS, 4)
decode_frame_fast_kernel(const int32_t* __restrict__ coeffs,   // [TB, 64]
                         const int32_t* __restrict__ qtables,  // [4, 64]
                         const Lut lut, const Recs R,
                         float* __restrict__ out,  // [size_y, size_x, NF]
                         DecodeParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [STAGES]
  int32_t* Q = reinterpret_cast<int32_t*>(smem + 16);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + HEAD_BYTES);
  float* fstage = reinterpret_cast<float*>(ring + STAGES * p.stage_blocks * 64);
  const int tid = threadIdx.x;
  const bool bulk = (reinterpret_cast<uintptr_t>(coeffs) & 15) == 0;
  for (int i = tid; i < 4 * 64; i += THREADS) Q[i] = qtables[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + s, bulk ? 1 : THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  for (int s = 0; s < STAGES; ++s) {
    const int t = blockIdx.x + s * gridDim.x;
    if (t < p.tiles)
      load_tile<NF, POW2>(coeffs, R, p, t, ring + s * p.stage_blocks * 64,
                          bar + s, bulk);
  }
  const float shift = static_cast<float>(1 << (p.precision - 1));
  const float denom = static_cast<float>(1 << p.precision);
  const int h4 = (tid >> 2) & 1;
  int k = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const Box b = tile_box(p, t);
    const Spans<NF> sp = tile_spans<NF, POW2>(R, p, b);
    int32_t* raw = ring + s * p.stage_blocks * 64;
    float* F = fstage + s * p.stage_blocks * BP;
    const int items = sp.slot[NF] * 8;
    mbar_wait(bar + s, (k >> 1) & 1);

    // B. IDCT rows: T[u][x] = sum_v X[u][v] A[x][v], block g of the stage
    // dequantized with the table of the last channel whose stage starts
    // at or before g (one with no blocks starts where the next one does).
    for (int e = tid; e < items; e += THREADS) {
      const int g = e >> 3, u = e & 7;
      int tq = R.r[0][F_TQ];
#pragma unroll
      for (int j = 1; j < NF; ++j)
        if (g >= sp.slot[j]) tq = R.r[j][F_TQ];
      int4 c0, c1, q0, q1;
      load_row(reinterpret_cast<const int4*>(raw + g * 64 + u * 8), h4, c0,
               c1);
      load_row(reinterpret_cast<const int4*>(Q + tq * 64 + u * 8), h4, q0,
               q1);
      const float x[8] = {dequant(c0.x, q0.x), dequant(c0.y, q0.y),
                          dequant(c0.z, q0.z), dequant(c0.w, q0.w),
                          dequant(c1.x, q1.x), dequant(c1.y, q1.y),
                          dequant(c1.z, q1.z), dequant(c1.w, q1.w)};
      float y[8];
#pragma unroll
      for (int xo = 0; xo < 8; ++xo) {
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < 8; ++v) acc = fmaf(x[v], lut.a[xo * 8 + v], acc);
        y[xo] = acc;
      }
      store_row(reinterpret_cast<float4*>(F + g * BP + u * 8), h4,
                make_float4(y[0], y[1], y[2], y[3]),
                make_float4(y[4], y[5], y[6], y[7]));
    }
    __syncthreads();
    // The coefficient stage is read: the tile two ahead goes in flight,
    // over this tile's columns and pixels and the next tile.
    if (t + STAGES * gridDim.x < p.tiles)
      load_tile<NF, POW2>(coeffs, R, p, t + STAGES * gridDim.x, raw, bar + s,
                          bulk);

    // C. IDCT columns, in place: out[y][x] = sum_u A[y][u] T[u][x] + 2^(P-1)
    for (int e = tid; e < items; e += THREADS) {
      float* col = F + (e >> 3) * BP + (e & 7);
      float c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = col[u * 8];
#pragma unroll
      for (int yo = 0; yo < 8; ++yo) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = fmaf(lut.a[yo * 8 + u], c[u], acc);
        col[yo * 8] = __fadd_rn(acc, shift);
      }
    }
    __syncthreads();

    // D. runs of 4 pixels of a row (tile widths are multiples of 8).  The
    // next tile's B writes the other float stage, so no barrier closes
    // the tile.
    const int rpr = (b.x1 - b.x0) >> 2;
    for (int e = tid; e < (b.y1 - b.y0) * rpr; e += THREADS) {
      const int ry = e / rpr;
      const int y = b.y0 + ry, x = b.x0 + ((e - ry * rpr) << 2);
      float ch[NF][4];
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        const int sy = R.r[c][F_SY], sx = R.r[c][F_SX];
        const float* blk = F + sp.slot[c] * BP;
        if (POW2) {
          const int ly = (y >> (sy >> 1)) - (sp.br0[c] << 3);
          const int lx = (x >> (sx >> 1)) - (sp.bc0[c] << 3);
          const float* row = blk + ((ly >> 3) * sp.nbc[c] + (lx >> 3)) * BP +
                             ((ly & 7) << 3) + (lx & 7);
          if (sx == 1) {
            const float4 v = *reinterpret_cast<const float4*>(row);
            ch[c][0] = v.x, ch[c][1] = v.y, ch[c][2] = v.z, ch[c][3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(row);
            ch[c][0] = ch[c][1] = v.x;
            ch[c][2] = ch[c][3] = v.y;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) ch[c][i] = 0.f;
          if (y < p.m_y * R.r[c][F_V] * 8 * sy) {
            const int ly = div_step(y, sy) - (sp.br0[c] << 3);
            const float* rows =
                blk + (ly >> 3) * sp.nbc[c] * BP + ((ly & 7) << 3);
            const int painted_x = R.r[c][F_BX] * 8 * sx;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (x + i < painted_x) {
                const int lx = div_step(x + i, sx) - (sp.bc0[c] << 3);
                ch[c][i] = rows[(lx >> 3) * BP + (lx & 7)];
              }
            }
          }
        }
      }
      put_run<NF>(out + (static_cast<int64_t>(y) * p.size_x + x) * NF, ch,
                  shift, denom);
    }
  }
}

// ---------------------------------------------------------------- K12

struct EncodeParams {
  int size_x, height, width, precision, m_x, mcus, tiles_x, tiles, mcu_w,
      mcu_h, stage_floats;
};

// Tile t: MCU row my, tile column tx, n MCUs, its pixels' first row and
// column in the padded frame and its columns.
struct EncodeTile {
  int my, tx, n, y0, x0, cols;
};

__device__ __forceinline__ EncodeTile encode_tile(const EncodeParams& p,
                                                  int t) {
  EncodeTile g;
  g.my = t / p.tiles_x;
  g.tx = t - g.my * p.tiles_x;
  g.n = min(p.mcus, p.m_x - g.tx * p.mcus);
  g.y0 = g.my * p.mcu_h;
  g.x0 = g.tx * p.mcus * p.mcu_w;
  g.cols = g.n * p.mcu_w;
  return g;
}

// Issue tile t's pixels (mcu_h rows of cols * NC floats, each one
// contiguous run of the frame) into stage `dst`, completing on `bar`, as
// K11's load_tile does.
template <int NC>
__device__ __forceinline__ void load_pixels(const float* __restrict__ frame,
                                            const EncodeParams& p, int t,
                                            float* dst, uint64_t* bar,
                                            bool bulk) {
  const EncodeTile g = encode_tile(p, t);
  const int row = g.cols * NC;
  const int64_t pitch = static_cast<int64_t>(p.size_x) * NC;
  const float* src = frame + g.y0 * pitch + static_cast<int64_t>(g.x0) * NC;
  if (bulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0) mbar_arrive_expect_tx(bar, p.mcu_h * row * 4);
    __syncwarp();
    fence_proxy_async();
    for (int r = threadIdx.x; r < p.mcu_h; r += 32)
      bulk_copy(dst + r * row, src + r * pitch, row * 4, bar);
  } else {
    for (int e = threadIdx.x; e < p.mcu_h * row; e += THREADS) {
      const int r = e / row;
      copy4(dst + e, src + r * pitch + (e - r * row));
    }
    copy4_arrive(bar);
  }
}

// ops/color.rgb_to_ycc, float32, channel j (the chroma centred on shift).
__device__ __forceinline__ float ycc(int j, float r, float g, float b,
                                     float shift) {
  if (j == 0)
    return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                     __fmul_rn(0.114f, b));
  if (j == 1)
    return __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.1687f, r),
                                         __fmul_rn(0.3313f, g)),
                               __fmul_rn(0.5f, b)),
                     shift);
  return __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(0.5f, r),
                                       __fmul_rn(0.4187f, g)),
                             __fmul_rn(0.0813f, b)),
                   shift);
}

// CY x CX: the box cell, where every component's box is 1 x 1 or the
// cell (models/dense_fast.box_cell); CY = CX = 0: any sampling.
template <int NC, int CY, int CX>
__global__ void __launch_bounds__(THREADS, 3)
encode_frame_fast_kernel(const float* __restrict__ frame,  // [sy, sx, NC]
                         const int32_t* __restrict__ qtables,  // [4, 64]
                         const Lut lut, const Recs R,
                         int32_t* __restrict__ out,  // [TB, 64]
                         EncodeParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [STAGES]
  int32_t* Q = reinterpret_cast<int32_t*>(smem + 16);
  float* ring = reinterpret_cast<float*>(smem + HEAD_BYTES);
  float* S = ring + STAGES * p.stage_floats;  // the tile's blocks
  const int tid = threadIdx.x;
  const bool bulk = (reinterpret_cast<uintptr_t>(frame) & 15) == 0;
  for (int i = tid; i < 4 * 64; i += THREADS) Q[i] = qtables[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + s, bulk ? 1 : THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  for (int s = 0; s < STAGES; ++s) {
    const int t = blockIdx.x + s * gridDim.x;
    if (t < p.tiles)
      load_pixels<NC>(frame, p, t, ring + s * p.stage_floats, bar + s, bulk);
  }
  // f[j]: component j's first block in an MCU (its tile part holds the
  // tile's n * h_j * v_j blocks from n * f[j] on)
  int f[NC];
  f[0] = 0;
#pragma unroll
  for (int j = 1; j < NC; ++j)
    f[j] = f[j - 1] + R.r[j - 1][F_H] * R.r[j - 1][F_V];
  const float shift = static_cast<float>(1 << (p.precision - 1));
  const int h4 = (tid >> 2) & 1;
  int k = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++k) {
    const int s = k & 1;
    const EncodeTile g = encode_tile(p, t);
    const int n = g.n, cols = g.cols;
    int nblk = 0;
#pragma unroll
    for (int j = 0; j < NC; ++j) nblk += n * R.r[j][F_H] * R.r[j][F_V];
    float* P = ring + s * p.stage_floats;
    mbar_wait(bar + s, (k >> 1) & 1);

    // B. level-shifted samples into the block stage
    if constexpr (CY > 0) {
      // a thread per box cell (cr, cc); the cell's pixel rows read as
      // float2 where a row holds an even count of floats
      const int ccols = cols / CX;
      for (int e = tid; e < (p.mcu_h / CY) * ccols; e += THREADS) {
        const int cr = e / ccols, cc = e - cr * ccols;
        float acc[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] = 0.f;
#pragma unroll
        for (int yy = 0; yy < CY; ++yy) {
          const int ry = cr * CY + yy;
          const float* px = P + (ry * cols + cc * CX) * NC;
          float pv[CX * NC];
          if constexpr ((CX * NC) % 2 == 0) {
#pragma unroll
            for (int i = 0; i < CX * NC / 2; ++i) {
              const float2 v = reinterpret_cast<const float2*>(px)[i];
              pv[2 * i] = v.x;
              pv[2 * i + 1] = v.y;
            }
          } else {
#pragma unroll
            for (int i = 0; i < CX * NC; ++i) pv[i] = px[i];
          }
#pragma unroll
          for (int xx = 0; xx < CX; ++xx) {
            const int rx = cc * CX + xx;
            const bool inside = g.y0 + ry < p.height && g.x0 + rx < p.width;
            float v[NC];
            if constexpr (NC == 1) {
              v[0] = pv[xx];
            } else {
              const float* c = pv + xx * NC;
#pragma unroll
              for (int j = 0; j < NC; ++j)
                v[j] = inside ? ycc(j, c[0], c[1], c[2], shift) : c[j];
            }
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              if (R.r[j][F_SY] != 1 || R.r[j][F_SX] != 1) {
                acc[j] = __fadd_rn(acc[j], v[j]);
              } else {  // a 1 x 1 box
                const int pr = n * R.r[j][F_H];
                S[(n * f[j] + (ry >> 3) * pr + (rx >> 3)) * BP +
                  ((ry & 7) << 3) + (rx & 7)] = __fsub_rn(v[j], shift);
              }
            }
          }
        }
        constexpr float inv = CY * CX == 4 ? 0.25f : 0.5f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (R.r[j][F_SY] != 1 || R.r[j][F_SX] != 1) {
            const int pr = n * R.r[j][F_H];
            S[(n * f[j] + (cr >> 3) * pr + (cc >> 3)) * BP + ((cr & 7) << 3) +
              (cc & 7)] = __fsub_rn(__fmul_rn(acc[j], inv), shift);
          }
        }
      }
    } else {
      // a thread per component sample: the box average of its channel (yy
      // outer, xx inner, from 0.f, then the division by the box's size)
      for (int e = tid; e < nblk * 64; e += THREADS) {
        const int gb = e >> 6;
        int j = 0, fj = 0, hj = R.r[0][F_H], st_y = R.r[0][F_SY],
            st_x = R.r[0][F_SX];
#pragma unroll
        for (int jj = 1; jj < NC; ++jj) {
          if (gb >= n * f[jj]) {
            j = jj;
            fj = f[jj];
            hj = R.r[jj][F_H];
            st_y = R.r[jj][F_SY];
            st_x = R.r[jj][F_SX];
          }
        }
        const int local = e - 64 * n * fj;
        const int wj = 8 * n * hj;
        const int sy = local / wj, sx = local - sy * wj;
        float acc = 0.f;
        for (int yy = 0; yy < st_y; ++yy) {
          for (int xx = 0; xx < st_x; ++xx) {
            const int py = sy * st_y + yy, px = sx * st_x + xx;
            const float* pix = P + (py * cols + px) * NC;
            float val;
            if (NC == 1 || g.y0 + py >= p.height || g.x0 + px >= p.width)
              val = pix[j];  // gray, or the raw channel past the window
            else
              val = ycc(j, pix[0], pix[1], pix[2], shift);
            acc = __fadd_rn(acc, val);
          }
        }
        S[(n * fj + (sy >> 3) * (n * hj) + (sx >> 3)) * BP + ((sy & 7) << 3) +
          (sx & 7)] = __fsub_rn(
            __fdiv_rn(acc, static_cast<float>(st_y * st_x)), shift);
      }
    }
    __syncthreads();
    // The pixel stage is read: the tile two ahead goes in flight.
    if (t + STAGES * gridDim.x < p.tiles)
      load_pixels<NC>(frame, p, t + STAGES * gridDim.x, P, bar + s, bulk);

    // C. FDCT rows: T[y][v] = sum_x X[y][x] A[x][v], in place
    for (int e = tid; e < nblk * 8; e += THREADS) {
      float4* rp = reinterpret_cast<float4*>(S + (e >> 3) * BP + (e & 7) * 8);
      float4 a, b;
      load_row(rp, h4, a, b);
      const float xr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float y[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc = fmaf(xr[x], lut.a[x * 8 + v], acc);
        y[v] = acc;
      }
      store_row(rp, h4, make_float4(y[0], y[1], y[2], y[3]),
                make_float4(y[4], y[5], y[6], y[7]));
    }
    __syncthreads();

    // D. FDCT columns: out[u][v] = sum_y A[y][u] T[y][v], quantized into
    // the stage in place (a thread reads its whole column first)
    for (int e = tid; e < nblk * 8; e += THREADS) {
      const int gb = e >> 3, v = e & 7;
      int tq = R.r[0][F_TQ];
#pragma unroll
      for (int j = 1; j < NC; ++j)
        if (gb >= n * f[j]) tq = R.r[j][F_TQ];
      float* cp = S + gb * BP + v;
      float col[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) col[y] = cp[y * 8];
      const int32_t* q = Q + tq * 64 + v;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int y = 0; y < 8; ++y) acc = fmaf(lut.a[y * 8 + u], col[y], acc);
        reinterpret_cast<int32_t*>(cp)[u * 8] =
            round_away(__fdiv_rn(acc, static_cast<float>(q[u * 8])));
      }
    }
    __syncthreads();

    // E. whole blocks out: component j's block row rb of the tile is n * h_j
    // consecutive plane rows, from stage block n * (f[j] + rb * h_j) on
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int hj = R.r[j][F_H], vj = R.r[j][F_V];
      const int run = n * hj * 16;
      for (int rb = 0; rb < vj; ++rb) {
        const int4* from =
            reinterpret_cast<const int4*>(S + n * (f[j] + rb * hj) * BP);
        int4* to = reinterpret_cast<int4*>(
            out + (R.r[j][F_FIRST] +
                   static_cast<int64_t>(g.my * vj + rb) * R.r[j][F_BX] +
                   g.tx * p.mcus * hj) *
                      64);
        for (int e = tid; e < run; e += THREADS)
          to[e] = from[(e >> 4) * (BP / 4) + (e & 15)];
      }
    }
    __syncthreads();  // the next tile's B rewrites the stage
  }
}

using DecodeKernel = void (*)(const int32_t*, const int32_t*, Lut, Recs,
                              float*, DecodeParams);
using EncodeKernel = void (*)(const float*, const int32_t*, Lut, Recs,
                              int32_t*, EncodeParams);

DecodeKernel decode_kernel(int nf, bool pow2) {
  switch (nf) {
    case 1:
      return pow2 ? decode_frame_fast_kernel<1, true>
                  : decode_frame_fast_kernel<1, false>;
    case 3:
      return pow2 ? decode_frame_fast_kernel<3, true>
                  : decode_frame_fast_kernel<3, false>;
    case 4:
      return pow2 ? decode_frame_fast_kernel<4, true>
                  : decode_frame_fast_kernel<4, false>;
    default:
      return nullptr;
  }
}

EncodeKernel encode_kernel(int nc, int cy, int cx) {
  if (nc == 1)  // gray: box_cell is always (1, 1)
    return cy == 1 && cx == 1 ? encode_frame_fast_kernel<1, 1, 1> : nullptr;
  if (nc != 3) return nullptr;
  if (cy == 1 && cx == 1) return encode_frame_fast_kernel<3, 1, 1>;
  if (cy == 1 && cx == 2) return encode_frame_fast_kernel<3, 1, 2>;
  if (cy == 2 && cx == 1) return encode_frame_fast_kernel<3, 2, 1>;
  if (cy == 2 && cx == 2) return encode_frame_fast_kernel<3, 2, 2>;
  return cy == 0 && cx == 0 ? encode_frame_fast_kernel<3, 0, 0> : nullptr;
}

}  // namespace

extern "C" int jt_dense_fast_comp_ints() { return COMP_INTS; }
extern "C" int jt_dense_fast_block_floats() { return BP; }
extern "C" int jt_dense_fast_head_bytes() { return HEAD_BYTES; }
extern "C" int jt_dense_fast_stages() { return STAGES; }

// K11 on `stream`: a persistent grid over tiles_y x tiles_x tiles, `smem`
// bytes of dynamic shared memory (models/dense_fast.decode_smem).  `lut`
// (the 64 floats of A[x][u]) and `recs` ([C_MAX, COMP_INTS] int32, channel
// order) are host pointers, passed to the kernel by value.  -> CUDA error.
extern "C" int jt_decode_frame_fast(const void* coeffs, const void* qtables,
                                    const void* lut, const void* recs,
                                    void* out, int size_y, int size_x,
                                    int nf, int precision, int m_y,
                                    int tile_h, int tile_w, int tiles_y,
                                    int tiles_x, int stage_blocks, int pow2,
                                    int smem, void* stream) {
  const DecodeKernel kernel = decode_kernel(nf, pow2 != 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_y <= 0 || tiles_x <= 0) return 0;
  Lut a;
  memcpy(a.a, lut, sizeof(a.a));
  Recs r;
  memcpy(r.r, recs, sizeof(r.r));
  int ctas = 0;
  const cudaError_t err = resident_ctas(
      reinterpret_cast<const void*>(kernel), THREADS,
      static_cast<size_t>(smem), &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecodeParams p{size_y,  size_x,  precision,         m_y,
                       tile_h,  tile_w,  tiles_x, tiles_y * tiles_x,
                       stage_blocks};
  kernel<<<std::min(p.tiles, ctas), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs),
      static_cast<const int32_t*>(qtables), a, r, static_cast<float*>(out),
      p);
  return static_cast<int>(cudaGetLastError());
}

// K12 on `stream`: a persistent grid over m_y x tiles_x tiles of `mcus`
// MCUs, `smem` bytes of dynamic shared memory (models/dense_fast.
// encode_smem); (cell_y, cell_x) the box cell of the common samplings, or
// (0, 0).  `lut` and `recs` (geometry order) as for K11.  -> CUDA error.
extern "C" int jt_encode_frame_fast(const void* frame, const void* qtables,
                                    const void* lut, const void* recs,
                                    void* out, int size_x, int height,
                                    int width, int nc, int precision,
                                    int m_x, int m_y, int mcus, int tiles_x,
                                    int mcu_w, int mcu_h, int cell_y,
                                    int cell_x, int smem, void* stream) {
  const EncodeKernel kernel = encode_kernel(nc, cell_y, cell_x);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (m_y <= 0 || tiles_x <= 0) return 0;
  Lut a;
  memcpy(a.a, lut, sizeof(a.a));
  Recs r;
  memcpy(r.r, recs, sizeof(r.r));
  int ctas = 0;
  const cudaError_t err = resident_ctas(
      reinterpret_cast<const void*>(kernel), THREADS,
      static_cast<size_t>(smem), &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeParams p{size_x, height, width, precision,
                       m_x,    mcus,   tiles_x, m_y * tiles_x,
                       mcu_w,  mcu_h,  mcu_h * mcus * mcu_w * nc};
  kernel<<<std::min(p.tiles, ctas), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), static_cast<const int32_t*>(qtables),
      a, r, static_cast<int32_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// What the kernel K11 (encode 0: nf, a = pow2) or K12 (encode 1: nf, a, b =
// the cell) takes on this device with `smem` bytes of dynamic shared
// memory: out[0] registers a thread, out[1] local (spilled) bytes a
// thread, out[2] CTAs an SM, out[3] SMs.  -> CUDA error.
extern "C" int jt_dense_fast_resources(int encode, int nf, int a, int b,
                                       int smem, void* out) {
  const void* kernel =
      encode ? reinterpret_cast<const void*>(encode_kernel(nf, a, b))
             : reinterpret_cast<const void*>(decode_kernel(nf, a != 0));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0, device = 0, sms = 0;
  if (err == cudaSuccess)
    err = resident_ctas(kernel, THREADS, static_cast<size_t>(smem), &ctas);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.localSizeBytes);
  o[2] = sms > 0 ? ctas / sms : 0;
  o[3] = sms;
  return 0;
}
