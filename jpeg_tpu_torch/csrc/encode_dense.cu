// pixels_to_zz: the dense encode stage for Hopper (sm_90a), pixel frames
// to quantized zig-zag blocks with differential DC.
//
// Replaces the JAX package's XLA device program
// jpeg_tpu/models/device_encode.py::_pixels_to_zz (colour convert
// ops/color.rgb_to_ycc, box downsample ops/resample.downsample_box, level
// shift + FDCT + quantize models/batch.encode_plane_batch, zig-zag and the
// prev_idx DC difference).  On the TPU those are separate fused XLA ops
// with full-frame float32 intermediates in HBM; here one 64-thread group
// computes one output block from the source pixels, so nothing but the
// uint8/uint16 pixels is read and nothing but the int32 blocks is written.
//
// Numerics, held against the plain version models/encode_dense.py::
// pixels_to_zz_ref (PyTorch eager, no FMA contraction):
//   * colour and the box average use __fmul_rn / __fadd_rn / __fdiv_rn,
//     so nvcc cannot contract them into FMAs and the values are those of
//     the eager float32 ops, operand for operand, in the reference's order
//     (y = 0.299r + 0.587g + 0.114b left to right; box sum yy outer, xx
//     inner, from 0.f, then one true division by the step product);
//   * padded rows and columns keep the raw replicated RGB value of the
//     component's channel, not YCbCr (frame.c:162-163);
//   * the FDCT is the [64,64] float32 Kronecker operator the plain version
//     multiplies by (ops/dct._kron_mats()[1]), summed in ascending order
//     with fmaf: only this sum's order differs from the plain version's
//     matmul, so a quantized value may differ by 1 where c/q sits on a
//     rounding boundary (the JAX package's own device-vs-host contract);
//   * quantization is a true IEEE division __fdiv_rn(c, q) and roundf
//     (ties away from zero).  rintf / __float2int_rn round ties to even and
//     would be wrong.  kernels.py builds without --use_fast_math and with
//     the default -prec-div=true -ftz=false for the same reason.
//
// What bounds it on the H100: an 8-frame 1080p 4:2:0 chunk reads 50 MB of
// pixels (chroma blocks read 4 pixels per output) and writes 100 MB of
// int32 blocks; the FDCT is 64 MACs per coefficient (1.6 GFLOP per
// chunk).  Both are far below the card's limits; the simple design keeps
// the operator in shared memory (16 KB per CTA, loaded once per CTA in a
// grid-stride loop) and accepts uncoalesced interleaved-pixel loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COMP_INTS = 8;  // models/encode_dense.py COMP_INTS
constexpr int C_MAX = 3;
constexpr int THREADS = 256;  // 4 output blocks per CTA iteration
constexpr int BLOCKS_PER_CTA = THREADS / 64;

struct Params {
  int frames, height, width, nc, precision, bf;
};

template <typename T>
__device__ __forceinline__ float load_px(const T* __restrict__ px,
                                         int64_t idx) {
  return static_cast<float>(px[idx]);
}

// One component sample of padded pixel (y, x) of frame f, before the box
// average: YCbCr inside the true frame, the raw replicated channel value
// in the MCU padding.
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ px,
                                        const Params& p, int f, int y, int x,
                                        int j, float shift) {
  const bool inside = y < p.height && x < p.width;
  const int yc = min(y, p.height - 1);
  const int xc = min(x, p.width - 1);
  const int64_t base =
      ((static_cast<int64_t>(f) * p.height + yc) * p.width + xc) * p.nc;
  if (p.nc == 1 || !inside) return load_px(px, base + j);
  const float r = load_px(px, base);
  const float g = load_px(px, base + 1);
  const float b = load_px(px, base + 2);
  if (j == 0) {
    return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                     __fmul_rn(0.114f, b));
  }
  if (j == 1) {
    return __fadd_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(-0.1687f, r), __fmul_rn(0.3313f, g)),
                  __fmul_rn(0.5f, b)),
        shift);
  }
  return __fadd_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.4187f, g)),
                __fmul_rn(0.0813f, b)),
      shift);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pixels_to_zz_kernel(const T* __restrict__ px,
                    const float* __restrict__ fdct,      // [64, 64]
                    const int32_t* __restrict__ inv_zz,  // [64]
                    const int32_t* __restrict__ comps,   // [C_MAX, 8]
                    const int32_t* __restrict__ qtables,  // [2, 64]
                    int32_t* __restrict__ zz,            // [F*Bf, 64]
                    int32_t* __restrict__ dc_raw,        // [F*Bf]
                    Params p) {
  __shared__ float m[64 * 64];
  __shared__ float tile[BLOCKS_PER_CTA][64];
  __shared__ int32_t comp[C_MAX * COMP_INTS];
  __shared__ int32_t q[2 * 64];
  __shared__ int32_t inv[64];
  for (int i = threadIdx.x; i < 64 * 64; i += THREADS) m[i] = fdct[i];
  for (int i = threadIdx.x; i < C_MAX * COMP_INTS; i += THREADS)
    comp[i] = comps[i];
  for (int i = threadIdx.x; i < 2 * 64; i += THREADS) q[i] = qtables[i];
  if (threadIdx.x < 64) inv[threadIdx.x] = inv_zz[threadIdx.x];
  __syncthreads();

  const int sub = threadIdx.x >> 6;
  const int k = threadIdx.x & 63;  // raster position in the block
  const float shift = static_cast<float>(1 << (p.precision - 1));
  const int64_t total = static_cast<int64_t>(p.frames) * p.bf;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCKS_PER_CTA;
       base < total; base += static_cast<int64_t>(gridDim.x) * BLOCKS_PER_CTA) {
    const int64_t n = base + sub;
    const bool live = n < total;
    int tq = 0;
    if (live) {
      const int f = static_cast<int>(n / p.bf);
      const int local = static_cast<int>(n - static_cast<int64_t>(f) * p.bf);
      int j = 0;
      while (j + 1 < p.nc && local >= comp[(j + 1) * COMP_INTS + 4]) ++j;
      const int32_t* c = comp + j * COMP_INTS;
      const int bi = local - c[4];
      const int by = bi / c[1];
      const int bx = bi - by * c[1];
      const int sy = c[2], sx = c[3];
      tq = c[6];
      const int py = by * 8 + (k >> 3);
      const int px_ = bx * 8 + (k & 7);
      float v;
      if (sy == 1 && sx == 1) {
        v = sample(px, p, f, py, px_, j, shift);
      } else {
        float acc = 0.f;
        for (int yy = 0; yy < sy; ++yy)
          for (int xx = 0; xx < sx; ++xx)
            acc = __fadd_rn(acc,
                            sample(px, p, f, py * sy + yy, px_ * sx + xx, j,
                                   shift));
        v = __fdiv_rn(acc, static_cast<float>(sy * sx));
      }
      tile[sub][k] = __fsub_rn(v, shift);
    }
    __syncthreads();
    if (live) {
      float s = 0.f;
#pragma unroll 16
      for (int i = 0; i < 64; ++i) s = fmaf(tile[sub][i], m[i * 64 + k], s);
      const float qv = static_cast<float>(q[tq * 64 + k]);
      const int out = static_cast<int>(roundf(__fdiv_rn(s, qv)));
      zz[n * 64 + inv[k]] = out;
      if (k == 0) dc_raw[n] = out;
    }
    __syncthreads();
  }
}

// zz[n][0] = dc[n] - dc[prev(n)] within the frame (0 at interval starts).
__global__ void dc_diff_kernel(const int32_t* __restrict__ dc_raw,
                               const int32_t* __restrict__ prev_idx,
                               int32_t* __restrict__ zz, int64_t total,
                               int bf) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int64_t f = n / bf;
  const int prev = prev_idx[n - f * bf];
  const int pred = prev >= 0 ? dc_raw[f * bf + prev] : 0;
  zz[n * 64] = dc_raw[n] - pred;
}

}  // namespace

// Launches both kernels on `stream`; returns the first CUDA error.
extern "C" int jt_pixels_to_zz(const void* pixels, int is16, const void* fdct,
                               const void* inv_zz, const void* comps,
                               const void* qtables, const void* prev_idx,
                               void* zz, void* dc_raw, int frames, int height,
                               int width, int nc, int precision, int bf,
                               void* stream) {
  const Params p{frames, height, width, nc, precision, bf};
  const int64_t total = static_cast<int64_t>(frames) * bf;
  if (total <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 8 CTAs per SM stride over the blocks, each loading the operator once.
  const int64_t iters = (total + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
  const int64_t cap = 8LL * sms;
  const int grid = static_cast<int>(iters < cap ? iters : cap);
  const float* m = static_cast<const float*>(fdct);
  const int32_t* inv = static_cast<const int32_t*>(inv_zz);
  const int32_t* c = static_cast<const int32_t*>(comps);
  const int32_t* q = static_cast<const int32_t*>(qtables);
  int32_t* out = static_cast<int32_t*>(zz);
  int32_t* dc = static_cast<int32_t*>(dc_raw);
  if (is16) {
    pixels_to_zz_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(pixels), m, inv, c, q, out, dc, p);
  } else {
    pixels_to_zz_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(pixels), m, inv, c, q, out, dc, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dthreads = 256;
  const int64_t dgrid = (total + dthreads - 1) / dthreads;
  dc_diff_kernel<<<static_cast<unsigned>(dgrid), dthreads, 0, s>>>(
      dc, static_cast<const int32_t*>(prev_idx), out, total, bf);
  return static_cast<int>(cudaGetLastError());
}
