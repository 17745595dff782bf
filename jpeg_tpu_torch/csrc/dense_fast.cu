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
// K11: a CTA per tile of the padded frame's pixels (models/dense_fast.
// decode_tiles: one MCU row high, whole MCUs, ~128 columns wide).
//   A. per component, the rectangle of its blocks that the tile's pixels
//      read (span: the samples y / step_y, x / step_x of the pixels below
//      the component's painted size, so a sampling ratio that does not
//      divide works too), and where it starts in the stage;
//   B. IDCT rows, a thread per block row: 8 coefficients dequantized (the
//      int32 product, as uint32 so that a huge value wraps as torch's
//      int32 multiply does, then one conversion), 64 fmaf into the stage;
//   C. IDCT columns, a thread per block column, + 2^(P-1), in place;
//   D. a thread per pixel: each output channel's sample (nearest
//      neighbour; 0.0 past the component's painted plane, the reference's
//      untouched margin), colour (YCbCr or YCCK -> RGB, gray as it is),
//      the float32 interleaved frame out, unrounded and unclipped.
// K12: a CTA per tile of MCUs, cut as K5 (csrc/encode_dense.cu) cuts them:
//   A. the tile's float pixels into shared memory, 16-byte loads;
//   B. a thread per component sample: the box average of its channel (yy
//      outer, xx inner, from 0.f, then the division by the box's size),
//      YCbCr inside the true [height, width] window and the raw padded
//      channel outside it (frame.c:162-163), - 2^(P-1), into the stage;
//   C. FDCT rows, a thread per block row, in place;
//   D. FDCT columns, a thread per block column, each coefficient
//      quantized by K5's quantizer round_away(__fdiv_rn(c, q)) and stored
//      in raster order: no zig-zag, no DC difference.
//
// Numerics, held against the plain versions: the DCTs are separable fmaf
// chains over ascending taps with the dct_lut_f32 coefficients
// (ops/dct.lut_on); the plain versions multiply by the same matrix in
// cuBLAS's (or the CPU's) order.  That order is the only difference, so
// the floats agree within ~1e-4 and a quantized value moves by 1 only
// where c / q sits on a rounding boundary.  Colour, the box and the level
// shifts use __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn with float32
// constants, the eager float32 ops operand for operand, so nvcc cannot
// contract them into FMAs; kernels.py builds without --use_fast_math.
//
// What bounds them on the H100: bench frame 0 (1080p 4:2:0, 48,960
// blocks) is 12.53 MB of int32 coefficients one way and a 25.07 MB float32
// frame the other, 37.6 MB, ~11.2 us at 3.35 TB/s; the separable DCTs are
// 2,048 float32 operations a block, 0.1 G a frame (~1.5 us at the float32
// peak).  So both are bound by bytes, and each reads its input once and
// writes its output once.  The eager chain they replace makes ~20-30
// launches and a full-frame float32 intermediate at each.

#include <cstdint>
#include <cuda_runtime.h>

#include "resident.cuh"
#include "round_away.cuh"

namespace {

constexpr int COMP_INTS = 8;  // models/dense_fast.py COMP_INTS
constexpr int C_MAX = 4;      // models/dense_fast.py C_MAX
constexpr int BP = 72;        // models/dense_fast.py BLOCK_FLOATS
constexpr int THREADS = 256;
// Record fields (models/dense_fast.comp_records).
constexpr int F_H = 0, F_V = 1, F_SY = 2, F_SX = 3, F_FIRST = 4, F_BX = 5,
              F_TQ = 6, F_CH = 7;
// A component's span in a K11 CTA: first block row, block rows, first
// block column, block columns, first stage block, painted rows, painted
// columns (and one spare int).
constexpr int SPAN_INTS = 8;
constexpr int S_BR0 = 0, S_NBR = 1, S_BC0 = 2, S_NBC = 3, S_SLOT = 4,
              S_PY = 5, S_PX = 6;
// Shared memory before a CTA's stage: the LUT, the four tables and the
// records (models/dense_fast.py decode_smem / encode_smem).
constexpr int HEAD_WORDS = 64 + 4 * 64 + C_MAX * COMP_INTS;
static_assert(HEAD_WORDS % 4 == 0 && SPAN_INTS % 4 == 0 && BP % 4 == 0,
              "the stage and the pixels must be 16-byte aligned");

__device__ __forceinline__ int div_step(int a, int s) {
  return s == 1 ? a : (s == 2 ? a >> 1 : a / s);
}

// The blocks of a component's plane (first, count) that the pixels
// [p0, p1) of one axis read: the samples p / step of the pixels below
// `painted` (models/dense_fast.py _span).
__device__ __forceinline__ void span(int p0, int p1, int step, int painted,
                                     int32_t* first, int32_t* count) {
  const int end = min(p1, painted);
  if (p0 >= end) {
    *first = 0;
    *count = 0;
    return;
  }
  *first = div_step(p0, step) >> 3;
  *count = (div_step(end - 1, step) >> 3) - *first + 1;
}

__device__ __forceinline__ void load_head(const float* lut,
                                          const int32_t* qtables,
                                          const int32_t* recs, float* A,
                                          int32_t* Q, int32_t* CP) {
  for (int i = threadIdx.x; i < 64; i += THREADS) A[i] = lut[i];
  for (int i = threadIdx.x; i < 4 * 64; i += THREADS) Q[i] = qtables[i];
  for (int i = threadIdx.x; i < C_MAX * COMP_INTS; i += THREADS)
    CP[i] = recs[i];
}

struct DecodeParams {
  int size_y, size_x, nf, precision, m_y, tile_h, tile_w;
};

__global__ void __launch_bounds__(THREADS)
decode_frame_fast_kernel(const int32_t* __restrict__ coeffs,   // [TB, 64]
                         const int32_t* __restrict__ qtables,  // [4, 64]
                         const float* __restrict__ lut,        // [8, 8]
                         const int32_t* __restrict__ recs,     // [4, 8]
                         float* __restrict__ out,  // [size_y, size_x, nf]
                         DecodeParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_stage;
  float* A = smem;  // A[x * 8 + u]
  int32_t* Q = reinterpret_cast<int32_t*>(A + 64);
  int32_t* CP = Q + 4 * 64;
  int32_t* SP = CP + C_MAX * COMP_INTS;
  float* R = reinterpret_cast<float*>(SP + C_MAX * SPAN_INTS);  // stage
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * p.tile_h, x0 = blockIdx.x * p.tile_w;
  const int y1 = min(y0 + p.tile_h, p.size_y);
  const int x1 = min(x0 + p.tile_w, p.size_x);
  load_head(lut, qtables, recs, A, Q, CP);
  __syncthreads();

  // A. each component's blocks and their place in the stage
  if (tid == 0) {
    int slot = 0;
    for (int j = 0; j < p.nf; ++j) {
      const int32_t* c = CP + j * COMP_INTS;
      int32_t* s = SP + j * SPAN_INTS;
      s[S_PY] = p.m_y * c[F_V] * 8 * c[F_SY];
      s[S_PX] = c[F_BX] * 8 * c[F_SX];
      span(y0, y1, c[F_SY], s[S_PY], s + S_BR0, s + S_NBR);
      span(x0, x1, c[F_SX], s[S_PX], s + S_BC0, s + S_NBC);
      s[S_SLOT] = slot;
      slot += s[S_NBR] * s[S_NBC];
    }
    n_stage = slot;
  }
  __syncthreads();
  const int items = n_stage * 8;
  const float shift = static_cast<float>(1 << (p.precision - 1));

  // B. IDCT rows: T[u][x] = sum_v X[u][v] A[x][v]
  const bool vec = (reinterpret_cast<uintptr_t>(coeffs) & 15) == 0;
  for (int e = tid; e < items; e += THREADS) {
    const int g = e >> 3, u = e & 7;
    // The last component whose stage starts at or before g (one with no
    // blocks starts where the next one does).
    int j = 0;
    while (j + 1 < p.nf && g >= SP[(j + 1) * SPAN_INTS + S_SLOT]) ++j;
    const int32_t* c = CP + j * COMP_INTS;
    const int32_t* s = SP + j * SPAN_INTS;
    const int local = g - s[S_SLOT];
    const int rb = local / s[S_NBC], cb = local - rb * s[S_NBC];
    const int64_t blk = c[F_FIRST] +
                        static_cast<int64_t>(s[S_BR0] + rb) * c[F_BX] +
                        s[S_BC0] + cb;
    const int32_t* src = coeffs + blk * 64 + u * 8;
    int v[8];
    if (vec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(src));
      const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(src + k);
    }
    const int32_t* q = Q + c[F_TQ] * 64 + u * 8;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = __int2float_rn(static_cast<int>(static_cast<uint32_t>(v[k]) *
                                             static_cast<uint32_t>(q[k])));
    float* dst = R + g * BP + u * 8;
#pragma unroll
    for (int xo = 0; xo < 8; ++xo) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) t = fmaf(x[k], A[xo * 8 + k], t);
      dst[xo] = t;
    }
  }
  __syncthreads();

  // C. IDCT columns: out[y][x] = sum_u A[y][u] T[u][x] + 2^(P-1)
  for (int e = tid; e < items; e += THREADS) {
    float* b = R + (e >> 3) * BP + (e & 7);
    float col[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) col[u] = b[u * 8];
#pragma unroll
    for (int yo = 0; yo < 8; ++yo) {
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) t = fmaf(A[yo * 8 + u], col[u], t);
      b[yo * 8] = __fadd_rn(t, shift);
    }
  }
  __syncthreads();

  // D. pixels.  The component each output channel reads (ascending id).
  int src_of[C_MAX] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < C_MAX; ++j) {
    if (j >= p.nf) break;
    const int k = CP[j * COMP_INTS + F_CH];
#pragma unroll
    for (int kk = 0; kk < C_MAX; ++kk)
      if (kk == k) src_of[kk] = j;
  }
  const int w = x1 - x0, h = y1 - y0;
  for (int e = tid; e < h * w; e += THREADS) {
    const int ry = e / w, rx = e - ry * w;
    const int y = y0 + ry, x = x0 + rx;
    float ch[C_MAX];
#pragma unroll
    for (int k = 0; k < C_MAX; ++k) {
      ch[k] = 0.f;
      if (k >= p.nf) continue;
      const int32_t* c = CP + src_of[k] * COMP_INTS;
      const int32_t* s = SP + src_of[k] * SPAN_INTS;
      if (y < s[S_PY] && x < s[S_PX]) {
        const int ly = div_step(y, c[F_SY]) - (s[S_BR0] << 3);
        const int lx = div_step(x, c[F_SX]) - (s[S_BC0] << 3);
        ch[k] = R[(s[S_SLOT] + (ly >> 3) * s[S_NBC] + (lx >> 3)) * BP +
                  ((ly & 7) << 3) + (lx & 7)];
      }
    }
    float* o = out + (static_cast<int64_t>(y) * p.size_x + x) * p.nf;
    if (p.nf == 1) {
      o[0] = ch[0];
      continue;
    }
    // ops/color.ycc_to_rgb_planar, float32
    const float cbv = __fsub_rn(ch[1], shift), crv = __fsub_rn(ch[2], shift);
    const float r = __fadd_rn(ch[0], __fmul_rn(1.402f, crv));
    const float g = __fsub_rn(__fsub_rn(ch[0], __fmul_rn(0.34414f, cbv)),
                              __fmul_rn(0.71414f, crv));
    const float b = __fadd_rn(ch[0], __fmul_rn(1.772f, cbv));
    if (p.nf == 3) {
      o[0] = r;
      o[1] = g;
      o[2] = b;
    } else {  // YCCK (ops/color.ycck_to_rgb): K - (C * K) / 2^P
      const float k = ch[3];
      const float denom = static_cast<float>(1 << p.precision);
      o[0] = __fsub_rn(k, __fdiv_rn(__fmul_rn(r, k), denom));
      o[1] = __fsub_rn(k, __fdiv_rn(__fmul_rn(g, k), denom));
      o[2] = __fsub_rn(k, __fdiv_rn(__fmul_rn(b, k), denom));
      o[3] = 255.f;
    }
  }
}

struct EncodeParams {
  int size_y, size_x, height, width, nc, precision, m_x, mcus, mcu_w, mcu_h,
      bpm;
};

// The component (geometry order) of a tile's stage block g, with f its
// first block in an MCU: component j holds the tile's n * h_j * v_j
// blocks from n * f_j on.
__device__ __forceinline__ int comp_of(const int32_t* CP, int nc, int n,
                                       int g, int* f) {
  int j = 0, first = 0;
  while (j + 1 < nc) {
    const int hv = CP[j * COMP_INTS + F_H] * CP[j * COMP_INTS + F_V];
    if (g < n * (first + hv)) break;
    first += hv;
    ++j;
  }
  *f = first;
  return j;
}

__global__ void __launch_bounds__(THREADS)
encode_frame_fast_kernel(const float* __restrict__ frame,  // [sy, sx, nc]
                         const int32_t* __restrict__ qtables,  // [4, 64]
                         const float* __restrict__ lut,        // [8, 8]
                         const int32_t* __restrict__ recs,     // [4, 8]
                         int32_t* __restrict__ out,            // [TB, 64]
                         EncodeParams p) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;  // A[x * 8 + u]
  int32_t* Q = reinterpret_cast<int32_t*>(A + 64);
  int32_t* CP = Q + 4 * 64;
  float* S = reinterpret_cast<float*>(CP + C_MAX * COMP_INTS);  // stage
  float* P = S + p.mcus * p.bpm * BP;  // the tile's pixels
  const int tid = threadIdx.x;
  const int my = blockIdx.y, tx = blockIdx.x;
  const int n = min(p.mcus, p.m_x - tx * p.mcus);
  const int nblk = n * p.bpm;
  const int y0 = my * p.mcu_h, x0 = tx * p.mcus * p.mcu_w;
  const int cols = n * p.mcu_w, row = cols * p.nc;
  load_head(lut, qtables, recs, A, Q, CP);

  // A. the tile's pixels, mcu_h rows of `row` floats
  const int64_t pitch = static_cast<int64_t>(p.size_x) * p.nc;
  const float* src = frame + static_cast<int64_t>(y0) * pitch +
                     static_cast<int64_t>(x0) * p.nc;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (pitch & 3) == 0 &&
      (row & 3) == 0) {
    const int vr = row >> 2;
    for (int e = tid; e < p.mcu_h * vr; e += THREADS) {
      const int r = e / vr;
      reinterpret_cast<float4*>(P)[e] =
          __ldg(reinterpret_cast<const float4*>(src + r * pitch) + (e - r * vr));
    }
  } else {
    for (int e = tid; e < p.mcu_h * row; e += THREADS) {
      const int r = e / row;
      P[e] = __ldg(src + r * pitch + (e - r * row));
    }
  }
  __syncthreads();

  // B. level-shifted samples, a thread per sample of a component's part
  // of the tile (v_j * 8 rows of n * h_j * 8)
  const float shift = static_cast<float>(1 << (p.precision - 1));
  for (int e = tid; e < nblk * 64; e += THREADS) {
    int f;
    const int j = comp_of(CP, p.nc, n, e >> 6, &f);
    const int32_t* c = CP + j * COMP_INTS;
    const int local = e - 64 * n * f;
    const int wj = 8 * n * c[F_H];
    const int sy = local / wj, sx = local - sy * wj;
    const int st_y = c[F_SY], st_x = c[F_SX];
    float acc = 0.f;
    for (int yy = 0; yy < st_y; ++yy) {
      for (int xx = 0; xx < st_x; ++xx) {
        const int py = sy * st_y + yy, px = sx * st_x + xx;
        const float* pix = P + (py * cols + px) * p.nc;
        float val;
        if (p.nc == 1 || y0 + py >= p.height || x0 + px >= p.width) {
          val = pix[j];  // gray, or the raw channel past the window
        } else {  // ops/color.rgb_to_ycc, float32, channel j
          const float r = pix[0], g = pix[1], b = pix[2];
          if (j == 0)
            val = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r),
                                      __fmul_rn(0.587f, g)),
                            __fmul_rn(0.114f, b));
          else if (j == 1)
            val = __fadd_rn(
                __fadd_rn(__fsub_rn(__fmul_rn(-0.1687f, r),
                                    __fmul_rn(0.3313f, g)),
                          __fmul_rn(0.5f, b)),
                shift);
          else
            val = __fadd_rn(
                __fsub_rn(__fsub_rn(__fmul_rn(0.5f, r),
                                    __fmul_rn(0.4187f, g)),
                          __fmul_rn(0.0813f, b)),
                shift);
        }
        acc = __fadd_rn(acc, val);
      }
    }
    const int g = n * f + (sy >> 3) * (n * c[F_H]) + (sx >> 3);
    S[g * BP + ((sy & 7) << 3) + (sx & 7)] = __fsub_rn(
        __fdiv_rn(acc, static_cast<float>(st_y * st_x)), shift);
  }
  __syncthreads();

  // C. FDCT rows: T[y][v] = sum_x X[y][x] A[x][v], in place
  for (int e = tid; e < nblk * 8; e += THREADS) {
    float* rp = S + (e >> 3) * BP + (e & 7) * 8;
    const float4 a = *reinterpret_cast<const float4*>(rp);
    const float4 b = *reinterpret_cast<const float4*>(rp + 4);
    const float xr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float t = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) t = fmaf(xr[x], A[x * 8 + v], t);
      rp[v] = t;
    }
  }
  __syncthreads();

  // D. FDCT columns: out[u][v] = sum_y A[y][u] T[y][v], quantized, to the
  // component's plane in raster order
  for (int e = tid; e < nblk * 8; e += THREADS) {
    const int g = e >> 3, v = e & 7;
    int f;
    const int j = comp_of(CP, p.nc, n, g, &f);
    const int32_t* c = CP + j * COMP_INTS;
    const int local = g - n * f, per_row = n * c[F_H];
    const int rb = local / per_row, cb = local - rb * per_row;
    const int64_t blk = c[F_FIRST] +
                        static_cast<int64_t>(my * c[F_V] + rb) * c[F_BX] +
                        tx * p.mcus * c[F_H] + cb;
    const float* cp = S + g * BP + v;
    float col[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) col[y] = cp[y * 8];
    const int32_t* q = Q + c[F_TQ] * 64 + v;
    int32_t* o = out + blk * 64 + v;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float t = 0.f;
#pragma unroll
      for (int y = 0; y < 8; ++y) t = fmaf(A[y * 8 + u], col[y], t);
      o[u * 8] = round_away(__fdiv_rn(t, static_cast<float>(q[u * 8])));
    }
  }
}

}  // namespace

extern "C" int jt_dense_fast_comp_ints() { return COMP_INTS; }
extern "C" int jt_dense_fast_block_floats() { return BP; }

// K11 on `stream`: a CTA per tile, tiles_x x tiles_y; `smem` bytes of
// dynamic shared memory (models/dense_fast.decode_smem).  -> CUDA error.
extern "C" int jt_decode_frame_fast(const void* coeffs, const void* qtables,
                                    const void* lut, const void* recs,
                                    void* out, int size_y, int size_x,
                                    int nf, int precision, int m_y,
                                    int tile_h, int tile_w, int tiles_y,
                                    int tiles_x, int smem, void* stream) {
  if (nf < 1 || nf > C_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles_y <= 0 || tiles_x <= 0) return 0;
  int ctas = 0;
  cudaError_t err = resident_ctas(
      reinterpret_cast<const void*>(decode_frame_fast_kernel), THREADS,
      static_cast<size_t>(smem), &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecodeParams p{size_y, size_x, nf, precision, m_y, tile_h, tile_w};
  decode_frame_fast_kernel<<<dim3(tiles_x, tiles_y), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs),
      static_cast<const int32_t*>(qtables), static_cast<const float*>(lut),
      static_cast<const int32_t*>(recs), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// K12 on `stream`: a CTA per tile of MCUs, tiles_x x m_y; `smem` bytes of
// dynamic shared memory (models/dense_fast.encode_smem).  -> CUDA error.
extern "C" int jt_encode_frame_fast(const void* frame, const void* qtables,
                                    const void* lut, const void* recs,
                                    void* out, int size_y, int size_x,
                                    int height, int width, int nc,
                                    int precision, int m_x, int m_y,
                                    int mcus, int tiles_x, int mcu_w,
                                    int mcu_h, int bpm, int smem,
                                    void* stream) {
  if (nc != 1 && nc != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (m_y <= 0 || tiles_x <= 0) return 0;
  int ctas = 0;
  cudaError_t err = resident_ctas(
      reinterpret_cast<const void*>(encode_frame_fast_kernel), THREADS,
      static_cast<size_t>(smem), &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeParams p{size_y, size_x, height, width, nc, precision,
                       m_x, mcus, mcu_w, mcu_h, bpm};
  encode_frame_fast_kernel<<<dim3(tiles_x, m_y), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), static_cast<const int32_t*>(qtables),
      static_cast<const float*>(lut), static_cast<const int32_t*>(recs),
      static_cast<int32_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
