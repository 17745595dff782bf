// dense_exact: the bit-exact dense kernels for Hopper (sm_90a): the
// inverse DCT of the decoder, the forward DCT + quantizer of the encoder,
// and the colour conversions, each bit-identical to the reference codec's
// strict-IEEE C build.
//
// Replaces the JAX package's exact mode (exact=True, its default):
// jpeg_tpu/ops/dct.py::idct8x8_exact / fdct8x8_exact (built on
// _contract_last_exact) with ops/quant.py's dequantize / quantize, and the
// exact=True forms of jpeg_tpu/ops/color.py (rgb_to_ycc, ycc_to_rgb,
// ycck_to_rgb).  The JAX package runs those EAGERLY, one XLA executable
// per elementwise op, because inside a jitted fusion XLA contracts mul+add
// into FMAs and the result is no longer the C code's; that is its exact
// mode's whole cost (VERDICT "weak" #4).  Here each DCT runs an 8x8
// block on 8 lanes of a warp (below), each pixel of a colour conversion
// one thread, and the arithmetic is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __dmul_rn,
// __dadd_rn, __dsub_rn), which nvcc never contracts, in exactly the order
// of the plain versions
// (models/dense_exact.py, eager PyTorch):
//   * idct_exact: int32 x int32 dequantize (wrapping), ONE correctly
//     rounded int->float conversion, the row pass out[y][x] = sum_u
//     in[y][u] * A[x][u], the column pass out[y][x] = sum_v r[v][x] *
//     A[y][v] (each sum starts from its first product and adds the others
//     in ascending tap order), then the level shift;
//   * fdct_exact: level unshift, rows out[y][u] = sum_x in[y][x] * A[x][u],
//     columns out[v][u] = sum_y r[y][u] * A[y][v], then q = (float)Q and
//     roundf(c / q) (ties away from zero; rintf would be wrong);
//   * color_exact: the C expression's double products and sums between
//     float32 stores (frame.c:154-244): decode centres Cb/Cr in float32,
//     then R = Y + 1.402 Cr etc. in double, stored to float; YCCK stores
//     C/M/Y to float and inverts K - (C K) / 2^P in float32; encode is
//     double throughout (0.299 R + 0.587 G + 0.114 B left to right) and
//     stored to float.
// The cosine LUT A[x][u] is ops/dct.dct_lut_f32(), bit for bit.
//
// What bounds it on the H100: a 1080p 4:2:0 frame is ~49k blocks, 2 x 512
// dependent multiply-adds each, and ~2M pixels of a few double operations
// (the H100 runs double at half its float rate outside the tensor cores);
// about 25 MB moved per frame, so bytes bound each kernel (~5 us for the
// 1080p Y plane's 32,640 blocks in and out).  The first design of both
// DCTs (8,160 CTAs of 256 threads, a thread a coefficient, each CTA
// reloading the LUT and crossing two CTA barriers, one scalar load and
// store a thread) took ~2.5x that on the device; the one below keeps a
// block in a group of 8 lanes, with no CTA barrier.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

constexpr int THREADS = 256;  // threads a CTA of the colour kernel

constexpr int COLOR_YCC_TO_RGB = 0;
constexpr int COLOR_YCCK_TO_RGB = 1;
constexpr int COLOR_RGB_TO_YCC = 2;

// Both DCTs: eight lanes own a block, lane y its row y, so a warp step is
// 4 blocks (1 KB of contiguous input, two 16-byte loads a lane).  The row
// pass runs in registers with A from the kernel's parameters (the
// constant bank: every lane reads the same entry at the same step); the
// rows go through a warp-private shared tile under __syncwarp only; each
// lane then sums its output row from the 8 rows with its own row or
// column of A (held in registers, as are its row's 8 quantizers) and
// stores it as two 16-byte stores (scalar ones when a pointer is off
// 16-byte alignment).  A persistent grid, no CTA barrier.
struct Lut {
  float a[64];  // A[x][u] at x * 8 + u
};

constexpr int DCT_WARPS = 8;  // warps a CTA
constexpr int DCT_PITCH = 72;  // floats of a block's tile: 8 rows of 8,
                               // padded so the 4 blocks' rows of a warp
                               // load fall on distinct banks

__device__ __forceinline__ void load8(const float* p, bool vec, float* v) {
  if (vec) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0];
    const float4 hi = reinterpret_cast<const float4*>(p)[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ void load8(const int32_t* p, bool vec,
                                      int32_t* v) {
  if (vec) {
    const int4 lo = reinterpret_cast<const int4*>(p)[0];
    const int4 hi = reinterpret_cast<const int4*>(p)[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
  }
}

// Store row r[0..8) through the lane's row of the warp's tile, and make
// every lane's row visible to the warp.
__device__ __forceinline__ void put_row(float* rows, int y, const float* r) {
  reinterpret_cast<float4*>(rows + y * 8)[0] =
      make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(rows + y * 8)[1] =
      make_float4(r[4], r[5], r[6], r[7]);
  __syncwarp();
}

// idct_exact: lane y dequantizes its row y (the wrapping uint32 product,
// one correctly rounded int->float conversion), the row pass r[y][x] =
// sum_u in[y][u] * A[x][u], then its output row out[y][x] = sum_v r[v][x]
// * A[y][v] from the tile with its row of A, + the level shift.
__global__ void __launch_bounds__(DCT_WARPS * 32)
idct_exact_kernel(const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ qtable, const Lut lut,
                  float* __restrict__ out, int64_t n_blocks, float shift) {
  __shared__ __align__(16) float tile[DCT_WARPS][4 * DCT_PITCH];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y = lane & 7;  // the lane's input row and output row
  float* rows = tile[warp] + (lane >> 3) * DCT_PITCH;
  // A[y][v] for this lane's output row y, and its row's quantizers.
  float arow[8];
  uint32_t q[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (y == k) c = lut.a[k * 8 + v];
    arow[v] = c;
    q[v] = static_cast<uint32_t>(qtable[y * 8 + v]);
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(coeffs) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t steps = (n_blocks + 3) / 4;
  for (int64_t st = static_cast<int64_t>(blockIdx.x) * DCT_WARPS + warp;
       st < steps; st += static_cast<int64_t>(gridDim.x) * DCT_WARPS) {
    const int64_t blk = st * 4 + (lane >> 3);
    const bool live = blk < n_blocks;
    int32_t c[8] = {};
    if (live) load8(coeffs + blk * 64 + y * 8, vec, c);
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = __int2float_rn(
          static_cast<int32_t>(static_cast<uint32_t>(c[k]) * q[k]));
    // Row pass: r[y][x] = sum_u in[y][u] * A[x][u], ascending u.
    float r[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float s = __fmul_rn(x[0], lut.a[o * 8]);
#pragma unroll
      for (int u = 1; u < 8; ++u)
        s = __fadd_rn(s, __fmul_rn(x[u], lut.a[o * 8 + u]));
      r[o] = s;
    }
    put_row(rows, y, r);
    // Column pass: out[y][x] = sum_v r[v][x] * A[y][v], ascending v.
    float o[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float rv[8];
      load8(rows + v * 8, true, rv);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = v == 0 ? __fmul_rn(rv[k], arow[0])
                      : __fadd_rn(o[k], __fmul_rn(rv[k], arow[v]));
    }
    __syncwarp();  // the tile is free for the next step
    if (live) {
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(o[k], shift);
      float* dst = out + blk * 64 + y * 8;
      if (vec) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = o[k];
      }
    }
  }
}

// fdct_exact: lane y takes its row y of samples (level unshift), the row
// pass r[y][u] = sum_x in[y][x] * A[x][u], then its output row v = y,
// out[v][u] = sum_y r[y][u] * A[y][v] from the tile with its column of A,
// and the quantizer roundf(c / Q).
__global__ void __launch_bounds__(DCT_WARPS * 32)
fdct_exact_kernel(const float* __restrict__ samples,
                  const int32_t* __restrict__ qtable, const Lut lut,
                  int32_t* __restrict__ out, int64_t n_blocks, float shift) {
  __shared__ __align__(16) float tile[DCT_WARPS][4 * DCT_PITCH];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y = lane & 7;  // the lane's input row and output row v
  float* rows = tile[warp] + (lane >> 3) * DCT_PITCH;
  // A[k][v] for this lane's output row v = y, and its row's quantizers.
  float acol[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float c = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v)
      if (y == v) c = lut.a[k * 8 + v];
    acol[k] = c;
    q[k] = static_cast<float>(qtable[y * 8 + k]);
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(samples) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t steps = (n_blocks + 3) / 4;
  for (int64_t st = static_cast<int64_t>(blockIdx.x) * DCT_WARPS + warp;
       st < steps; st += static_cast<int64_t>(gridDim.x) * DCT_WARPS) {
    const int64_t blk = st * 4 + (lane >> 3);
    const bool live = blk < n_blocks;
    float x[8] = {};
    if (live) load8(samples + blk * 64 + y * 8, vec, x);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __fsub_rn(x[k], shift);
    // Row pass: r[y][u] = sum_x in[y][x] * A[x][u], ascending x.
    float r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float s = __fmul_rn(x[0], lut.a[u]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        s = __fadd_rn(s, __fmul_rn(x[k], lut.a[k * 8 + u]));
      r[u] = s;
    }
    put_row(rows, y, r);
    // Column pass: out[v][u] = sum_y r[y][u] * A[y][v], ascending y.
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float rk[8];
      load8(rows + k * 8, true, rk);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        o[u] = k == 0 ? __fmul_rn(rk[u], acol[0])
                      : __fadd_rn(o[u], __fmul_rn(rk[u], acol[k]));
    }
    __syncwarp();  // the tile is free for the next step
    if (live) {
      int32_t c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        c[u] = static_cast<int32_t>(roundf(__fdiv_rn(o[u], q[u])));
      int32_t* dst = out + blk * 64 + y * 8;
      if (vec) {
        reinterpret_cast<int4*>(dst)[0] = make_int4(c[0], c[1], c[2], c[3]);
        reinterpret_cast<int4*>(dst)[1] = make_int4(c[4], c[5], c[6], c[7]);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) dst[u] = c[u];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
color_exact_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int64_t n_pixels, int mode, float shift_f,
                   double shift_d, float denom) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n_pixels) return;
  if (mode == COLOR_RGB_TO_YCC) {
    const double r = in[i * 3], g = in[i * 3 + 1], b = in[i * 3 + 2];
    const double y = __dadd_rn(__dadd_rn(__dmul_rn(0.299, r),
                                         __dmul_rn(0.587, g)),
                               __dmul_rn(0.114, b));
    const double cb =
        __dadd_rn(__dadd_rn(__dsub_rn(__dmul_rn(-0.1687, r),
                                      __dmul_rn(0.3313, g)),
                            __dmul_rn(0.5, b)),
                  shift_d);
    const double cr =
        __dadd_rn(__dsub_rn(__dsub_rn(__dmul_rn(0.5, r),
                                      __dmul_rn(0.4187, g)),
                            __dmul_rn(0.0813, b)),
                  shift_d);
    out[i * 3] = __double2float_rn(y);
    out[i * 3 + 1] = __double2float_rn(cb);
    out[i * 3 + 2] = __double2float_rn(cr);
    return;
  }
  const int c = mode == COLOR_YCCK_TO_RGB ? 4 : 3;
  const double y = in[i * c];
  const double cb = __fsub_rn(in[i * c + 1], shift_f);
  const double cr = __fsub_rn(in[i * c + 2], shift_f);
  const float r = __double2float_rn(__dadd_rn(y, __dmul_rn(1.402, cr)));
  const float g = __double2float_rn(
      __dsub_rn(__dsub_rn(y, __dmul_rn(0.34414, cb)), __dmul_rn(0.71414, cr)));
  const float b = __double2float_rn(__dadd_rn(y, __dmul_rn(1.772, cb)));
  if (mode == COLOR_YCC_TO_RGB) {
    out[i * 3] = r;
    out[i * 3 + 1] = g;
    out[i * 3 + 2] = b;
    return;
  }
  const float k = in[i * 4 + 3];
  out[i * 4] = __fsub_rn(k, __fdiv_rn(__fmul_rn(r, k), denom));
  out[i * 4 + 1] = __fsub_rn(k, __fdiv_rn(__fmul_rn(g, k), denom));
  out[i * 4 + 2] = __fsub_rn(k, __fdiv_rn(__fmul_rn(b, k), denom));
  out[i * 4 + 3] = 255.0f;
}

unsigned grid_for(int64_t items, int per_cta) {
  return static_cast<unsigned>((items + per_cta - 1) / per_cta);
}

// Launch a DCT kernel on the persistent grid: as many CTAs as fit the
// card at once, fewer when the blocks need fewer.  `lut` is a host
// pointer to the 64 floats of A[x][u], passed to the kernel by value.
template <typename In, typename Out>
int launch_dct(void (*kernel)(const In*, const int32_t*, Lut, Out*,
                              int64_t, float),
               const void* in, const void* qtable, const void* lut,
               void* out, long long n_blocks, int precision, void* stream) {
  if (n_blocks <= 0) return 0;
  Lut a;
  memcpy(a.a, lut, sizeof(a.a));
  int ctas = 0;
  const cudaError_t err = resident_ctas(reinterpret_cast<const void*>(kernel),
                                        DCT_WARPS * 32, 0, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = (n_blocks + 3) / 4;
  const long long want = (warps + DCT_WARPS - 1) / DCT_WARPS;
  kernel<<<static_cast<unsigned>(want < ctas ? want : ctas), DCT_WARPS * 32,
           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(in), static_cast<const int32_t*>(qtable), a,
      static_cast<Out*>(out), n_blocks,
      static_cast<float>(1 << (precision - 1)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after it.  The
// DCTs take `lut` as a host pointer to the 64 floats of A[x][u].
extern "C" int jt_idct_exact(const void* coeffs, const void* qtable,
                             const void* lut, void* out, long long n_blocks,
                             int precision, void* stream) {
  return launch_dct(idct_exact_kernel, coeffs, qtable, lut, out, n_blocks,
                    precision, stream);
}

extern "C" int jt_fdct_exact(const void* samples, const void* qtable,
                             const void* lut, void* out, long long n_blocks,
                             int precision, void* stream) {
  return launch_dct(fdct_exact_kernel, samples, qtable, lut, out, n_blocks,
                    precision, stream);
}

// mode: 0 YCbCr -> RGB ([n, 3]), 1 YCCK -> RGB + K=255 ([n, 4]),
// 2 RGB -> YCbCr ([n, 3]).
extern "C" int jt_color_exact(const void* in, void* out, long long n_pixels,
                              int mode, int precision, void* stream) {
  if (n_pixels <= 0) return 0;
  if (mode < COLOR_YCC_TO_RGB || mode > COLOR_RGB_TO_YCC) return -1;
  const int shift = 1 << (precision - 1);
  color_exact_kernel<<<grid_for(n_pixels, THREADS), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n_pixels, mode,
      static_cast<float>(shift), static_cast<double>(shift),
      static_cast<float>(1 << precision));
  return static_cast<int>(cudaGetLastError());
}
