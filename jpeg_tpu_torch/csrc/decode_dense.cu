// coeffs_to_pixels: the dense decode tail for Hopper (sm_90a), plane-major
// quantized coefficients to interleaved pixel frames.
//
// Replaces the JAX package's XLA device program
// jpeg_tpu/models/device_decode.py::_dense_from_coeffs (dequantize
// ops/quant.dequantize, IDCT + level shift models/batch.decode_blocks_batch,
// nearest-neighbour upsampling ops/resample.upsample_nn, colour
// ops/color.ycc_to_rgb_planar / to_rgb, roundf, clip and the interleave).
// On the TPU, and in the plain version models/decode_dense.py::
// coeffs_to_pixels_ref, those are separate ops with full-frame float32
// intermediates in device memory; here one CTA decodes one tile -- up to
// TILE_BLOCKS blocks: a run of MCUs of one MCU row
// (models/decode_dense.tile_plan) -- so nothing but the int32
// coefficients and the frame's tables is read and nothing but the
// uint8/uint16 pixels is written:
//
//   A. the tile's blocks of every component, 16-byte loads, dequantized
//      with the frame's own table (qtables [F, 4, 64], frame stride 0 when
//      all frames share one set) into shared memory;
//   B. IDCT rows: one thread per block row, 64 fmaf from registers;
//   C. IDCT columns: one thread per block column, 64 fmaf, + 2^(P-1);
//   D. one thread per output pixel: each component's sample by index
//      (nearest-neighbour upsampling), colour, roundf, clip, into a staged
//      copy of the tile's interleaved rows;
//   E. the rows out, 16-byte stores where the rows are aligned, else one
//      sample at a time; only rows < H and columns < W are computed and
//      stored.
//
// Shared memory holds a block as 8 rows of 9 floats, blocks 72 floats
// apart: a warp stepping along the rows of 4 blocks (B), along their
// columns (C) or along a pixel row (D) then hits 32 distinct banks.
//
// Numerics, held against the plain version within +-1 per sample:
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
// 0.8 G per chunk (~12 us at the float32 peak).  So it is bound by bytes:
// every coefficient is read once with 16-byte loads, every pixel written
// once with 16-byte stores, and every intermediate stays in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COMP_INTS = 8;  // models/decode_dense.py COMP_INTS
constexpr int C_MAX = 4;
constexpr int THREADS = 128;
constexpr int TILE_BLOCKS = 64;  // models/decode_dense.py TILE_BLOCKS
constexpr int ROW = 9;   // floats of a block row in shared memory
constexpr int BLK = 72;  // floats of a block (72 = 8 mod 32 banks)
// Shared memory before the pixel stage: blocks, the IDCT coefficients,
// the frame's four tables and the component records.
constexpr int FIXED_BYTES =
    (TILE_BLOCKS * BLK + 64 + 4 * 64 + C_MAX * COMP_INTS) * 4;
static_assert(FIXED_BYTES % 16 == 0, "the pixel stage must be 16-aligned");

struct Params {
  int frames, height, width, nf, nc, precision, tb;
  int m_x, m_y, mcus, tiles_x, mcu_w, mcu_h, bpm, qt_stride;
};

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
coeffs_to_pixels_kernel(const int32_t* __restrict__ coeffs,  // [F, tb, 64]
                        const int32_t* __restrict__ qtables,  // [F, 4, 64]
                        const float* __restrict__ lut,  // [8 x][8 u]
                        const int32_t* __restrict__ comps,  // [C_MAX, 8]
                        T* __restrict__ out,  // [F, H, W, nc]
                        Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // [TILE_BLOCKS][BLK]
  float* A = S + TILE_BLOCKS * BLK;
  int32_t* Q = reinterpret_cast<int32_t*>(A + 64);
  int32_t* CP = Q + 4 * 64;
  T* stage = reinterpret_cast<T*>(smem + FIXED_BYTES);
  const int tid = threadIdx.x;

  // The tile: frame f, MCU row my, tile column tx, of n MCUs.
  const int per_frame = p.m_y * p.tiles_x;
  const int f = static_cast<int>(blockIdx.x / per_frame);
  const int rem = static_cast<int>(blockIdx.x - f * per_frame);
  const int my = rem / p.tiles_x, tx = rem - my * p.tiles_x;
  const int n = min(p.mcus, p.m_x - tx * p.mcus);
  const int nblk = n * p.bpm;
  const int y0 = my * p.mcu_h, x0 = tx * p.mcus * p.mcu_w;

  if (tid < 64) A[tid] = lut[tid];
  const int32_t* qf = qtables + static_cast<int64_t>(f) * p.qt_stride;
  for (int i = tid; i < 4 * 64; i += THREADS) Q[i] = qf[i];
  if (tid < C_MAX * COMP_INTS) CP[tid] = comps[tid];
  __syncthreads();

  // A. Dequantized blocks.  Slot b of the tile: component j's blocks from
  // n * first_j, block row r of the MCU row, n * h_j blocks a row.
  const int32_t* cf = coeffs + static_cast<int64_t>(f) * p.tb * 64;
  const bool vec = reinterpret_cast<uintptr_t>(coeffs) % 16 == 0;
  for (int e = tid; e < nblk * 16; e += THREADS) {
    const int b = e >> 4, part = e & 15;
    int j = 0;
    while (j + 1 < p.nf && b >= n * CP[(j + 1) * COMP_INTS + 7]) ++j;
    const int32_t* c = CP + j * COMP_INTS;
    const int local = b - n * c[7];
    const int cw = n * c[0];
    const int r = local / cw;
    const int64_t blk = c[4] + static_cast<int64_t>(my * c[1] + r) * c[5] +
                        static_cast<int64_t>(tx) * p.mcus * c[0] +
                        (local - r * cw);
    const int32_t* src = cf + blk * 64 + part * 4;
    int4 v;
    if (vec) {
      v = __ldg(reinterpret_cast<const int4*>(src));
    } else {
      v = make_int4(src[0], src[1], src[2], src[3]);
    }
    const int32_t* q = Q + c[6] * 64 + part * 4;
    float* s = S + b * BLK + (part >> 1) * ROW + (part & 1) * 4;
    s[0] = dequant(v.x, q[0]);
    s[1] = dequant(v.y, q[1]);
    s[2] = dequant(v.z, q[2]);
    s[3] = dequant(v.w, q[3]);
  }
  __syncthreads();

  // B. Rows: T[u][x] = sum_v X[u][v] * A[x][v], in place.
  const float4* A4 = reinterpret_cast<const float4*>(A);
  for (int e = tid; e < nblk * 8; e += THREADS) {
    float* row = S + (e >> 3) * BLK + (e & 7) * ROW;
    float x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) x[v] = row[v];
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
      row[xx] = acc;
    }
  }
  __syncthreads();

  // C. Columns: out[y][x] = sum_u A[y][u] * T[u][x] + 2^(P-1), in place.
  const float shift = static_cast<float>(1 << (p.precision - 1));
  for (int e = tid; e < nblk * 8; e += THREADS) {
    float* col = S + (e >> 3) * BLK + (e & 7);
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = col[u * ROW];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const float4 a0 = A4[y * 2], a1 = A4[y * 2 + 1];
      float acc = fmaf(a0.x, t[0], 0.f);
      acc = fmaf(a0.y, t[1], acc);
      acc = fmaf(a0.z, t[2], acc);
      acc = fmaf(a0.w, t[3], acc);
      acc = fmaf(a1.x, t[4], acc);
      acc = fmaf(a1.y, t[5], acc);
      acc = fmaf(a1.z, t[6], acc);
      acc = fmaf(a1.w, t[7], acc);
      col[y * ROW] = __fadd_rn(acc, shift);
    }
  }
  __syncthreads();

  // D. Pixels of the tile inside the frame, into the stage as
  // [rows][cols][nc].  Thread pixels advance THREADS at a time along the
  // rows, so (py, px) is stepped, not divided out.
  const int rows = min(p.mcu_h, p.height - y0);
  const int cols = min(n * p.mcu_w, p.width - x0);
  const float maxval = static_cast<float>((1 << p.precision) - 1);
  const float denom = static_cast<float>(1 << p.precision);
  int py = tid / cols, px = tid - (tid / cols) * cols;
  for (int e = tid; e < rows * cols; e += THREADS) {
    float s[C_MAX];
#pragma unroll
    for (int j = 0; j < C_MAX; ++j) {
      if (j < p.nf) {
        const int32_t* c = CP + j * COMP_INTS;
        const int sy = div_step(py, c[2]), sx = div_step(px, c[3]);
        const int slot = n * c[7] + (sy >> 3) * (n * c[0]) + (sx >> 3);
        s[j] = S[slot * BLK + (sy & 7) * ROW + (sx & 7)];
      }
    }
    T* o = stage + static_cast<int64_t>(e) * p.nc;
    if (p.nf == 1) {
      o[0] = quantize<T>(s[0], maxval);
    } else {
      // Planar YCbCr -> RGB (ops/color.ycc_to_rgb_planar, float32).
      const float cb = __fsub_rn(s[1], shift), cr = __fsub_rn(s[2], shift);
      float r = __fadd_rn(s[0], __fmul_rn(1.402f, cr));
      float g = __fsub_rn(__fsub_rn(s[0], __fmul_rn(0.34414f, cb)),
                          __fmul_rn(0.71414f, cr));
      float bl = __fadd_rn(s[0], __fmul_rn(1.772f, cb));
      if (p.nf == 4) {
        // YCCK: CMY from the first three, inverted through K
        // (ops/color.ycck_to_rgb); K itself is dropped.
        const float k = s[3];
        r = __fsub_rn(k, __fdiv_rn(__fmul_rn(r, k), denom));
        g = __fsub_rn(k, __fdiv_rn(__fmul_rn(g, k), denom));
        bl = __fsub_rn(k, __fdiv_rn(__fmul_rn(bl, k), denom));
      }
      o[0] = quantize<T>(r, maxval);
      o[1] = quantize<T>(g, maxval);
      o[2] = quantize<T>(bl, maxval);
    }
    px += THREADS;
    while (px >= cols) {
      px -= cols;
      ++py;
    }
  }
  __syncthreads();

  // E. The staged rows out.
  const int64_t pitch = static_cast<int64_t>(p.width) * p.nc;
  T* dst = out + (static_cast<int64_t>(f) * p.height + y0) * pitch +
           static_cast<int64_t>(x0) * p.nc;
  const int row_elems = cols * p.nc;
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

template <typename T>
cudaError_t launch_tiles(const int32_t* coeffs, const int32_t* qtables,
                         const float* lut, const int32_t* comps, T* out,
                         const Params& p, cudaStream_t s) {
  const size_t stage = static_cast<size_t>(p.mcu_h) * p.mcus * p.mcu_w *
                       p.nc * sizeof(T);
  const size_t shared = FIXED_BYTES + (stage + 15) / 16 * 16;
  auto kernel = coeffs_to_pixels_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>(p.frames) * p.m_y * p.tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(tiles), THREADS, shared, s>>>(
      coeffs, qtables, lut, comps, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jt_decode_dense_tile_blocks() { return TILE_BLOCKS; }
extern "C" int jt_decode_dense_comp_ints() { return COMP_INTS; }

// Launches the kernel on `stream`; returns the CUDA error (0 on success).
extern "C" int jt_coeffs_to_pixels(const void* coeffs, const void* qtables,
                                   const void* lut, const void* comps,
                                   void* out, int is16, int frames,
                                   int height, int width, int nf, int nc,
                                   int precision, int tb, int m_x, int m_y,
                                   int mcus, int tiles_x, int mcu_w,
                                   int mcu_h, int bpm, int qt_stride,
                                   void* stream) {
  const Params p{frames, height, width, nf, nc, precision, tb, m_x,
                 m_y, mcus, tiles_x, mcu_w, mcu_h, bpm, qt_stride};
  if (frames <= 0) return 0;
  if (mcus * bpm > TILE_BLOCKS || nf < 1 || nf > C_MAX ||
      (nc != 1 && nc != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(coeffs);
  const int32_t* q = static_cast<const int32_t*>(qtables);
  const float* l = static_cast<const float*>(lut);
  const int32_t* cp = static_cast<const int32_t*>(comps);
  const cudaError_t err =
      is16 ? launch_tiles(c, q, l, cp, static_cast<uint16_t*>(out), p, s)
           : launch_tiles(c, q, l, cp, static_cast<uint8_t*>(out), p, s);
  return static_cast<int>(err);
}
