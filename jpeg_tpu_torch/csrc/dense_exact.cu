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
// mode's whole cost (VERDICT "weak" #4).  Here each 8x8 block is one
// 64-thread group and each pixel one thread, and the arithmetic is
// written with the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __dmul_rn, __dadd_rn, __dsub_rn), which nvcc never
// contracts, in exactly the order of the plain versions
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
// about 25 MB moved per frame.  All of it is far below the card's limits,
// so the simple one-thread-per-coefficient design stays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 4 blocks of 64 coefficients per CTA
constexpr int BLOCKS_PER_CTA = THREADS / 64;

constexpr int COLOR_YCC_TO_RGB = 0;
constexpr int COLOR_YCCK_TO_RGB = 1;
constexpr int COLOR_RGB_TO_YCC = 2;

__global__ void __launch_bounds__(THREADS)
idct_exact_kernel(const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ qtable,
                  const float* __restrict__ lut, float* __restrict__ out,
                  int64_t n_blocks, float shift) {
  __shared__ float a[64];
  __shared__ float in[BLOCKS_PER_CTA][64];
  __shared__ float rows[BLOCKS_PER_CTA][64];
  const int t = threadIdx.x & 63;
  const int b = threadIdx.x >> 6;
  if (threadIdx.x < 64) a[threadIdx.x] = lut[threadIdx.x];
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * BLOCKS_PER_CTA + b;
  const bool live = blk < n_blocks;
  if (live) {
    const uint32_t prod = static_cast<uint32_t>(coeffs[blk * 64 + t]) *
                          static_cast<uint32_t>(qtable[t]);
    in[b][t] = __int2float_rn(static_cast<int32_t>(prod));
  }
  __syncthreads();
  const int y = t >> 3, x = t & 7;
  if (live) {
    float s = __fmul_rn(in[b][y * 8], a[x * 8]);
    for (int u = 1; u < 8; ++u)
      s = __fadd_rn(s, __fmul_rn(in[b][y * 8 + u], a[x * 8 + u]));
    rows[b][t] = s;
  }
  __syncthreads();
  if (live) {
    float s = __fmul_rn(rows[b][x], a[y * 8]);
    for (int v = 1; v < 8; ++v)
      s = __fadd_rn(s, __fmul_rn(rows[b][v * 8 + x], a[y * 8 + v]));
    out[blk * 64 + t] = __fadd_rn(s, shift);
  }
}

__global__ void __launch_bounds__(THREADS)
fdct_exact_kernel(const float* __restrict__ samples,
                  const int32_t* __restrict__ qtable,
                  const float* __restrict__ lut, int32_t* __restrict__ out,
                  int64_t n_blocks, float shift) {
  __shared__ float a[64];
  __shared__ float in[BLOCKS_PER_CTA][64];
  __shared__ float rows[BLOCKS_PER_CTA][64];
  const int t = threadIdx.x & 63;
  const int b = threadIdx.x >> 6;
  if (threadIdx.x < 64) a[threadIdx.x] = lut[threadIdx.x];
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * BLOCKS_PER_CTA + b;
  const bool live = blk < n_blocks;
  if (live) in[b][t] = __fsub_rn(samples[blk * 64 + t], shift);
  __syncthreads();
  const int y = t >> 3, u = t & 7;
  if (live) {
    float s = __fmul_rn(in[b][y * 8], a[u]);
    for (int x = 1; x < 8; ++x)
      s = __fadd_rn(s, __fmul_rn(in[b][y * 8 + x], a[x * 8 + u]));
    rows[b][t] = s;
  }
  __syncthreads();
  if (live) {
    const int v = y;  // output row: vertical frequency
    float s = __fmul_rn(rows[b][u], a[v]);
    for (int yy = 1; yy < 8; ++yy)
      s = __fadd_rn(s, __fmul_rn(rows[b][yy * 8 + u], a[yy * 8 + v]));
    const float q = static_cast<float>(qtable[t]);
    out[blk * 64 + t] = static_cast<int32_t>(roundf(__fdiv_rn(s, q)));
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

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() after it.
extern "C" int jt_idct_exact(const void* coeffs, const void* qtable,
                             const void* lut, void* out, long long n_blocks,
                             int precision, void* stream) {
  if (n_blocks <= 0) return 0;
  idct_exact_kernel<<<grid_for(n_blocks, BLOCKS_PER_CTA), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const int32_t*>(qtable),
      static_cast<const float*>(lut), static_cast<float*>(out), n_blocks,
      static_cast<float>(1 << (precision - 1)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jt_fdct_exact(const void* samples, const void* qtable,
                             const void* lut, void* out, long long n_blocks,
                             int precision, void* stream) {
  if (n_blocks <= 0) return 0;
  fdct_exact_kernel<<<grid_for(n_blocks, BLOCKS_PER_CTA), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(samples), static_cast<const int32_t*>(qtable),
      static_cast<const float*>(lut), static_cast<int32_t*>(out), n_blocks,
      static_cast<float>(1 << (precision - 1)));
  return static_cast<int>(cudaGetLastError());
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
