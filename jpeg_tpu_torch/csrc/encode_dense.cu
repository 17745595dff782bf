// pixels_to_zz: the dense encode stage for Hopper (sm_90a), pixel frames
// to quantized zig-zag blocks with differential DC.
//
// Replaces the JAX package's XLA device program
// jpeg_tpu/models/device_encode.py::_pixels_to_zz (colour convert
// ops/color.rgb_to_ycc, box downsample ops/resample.downsample_box, level
// shift + FDCT + quantize models/batch.encode_plane_batch, zig-zag and the
// prev_idx DC difference).  On the TPU those are separate fused XLA ops
// with full-frame float32 intermediates in HBM; here one CTA encodes one
// tile -- a run of MCUs of one MCU row (models/encode_dense.tile_plan) --
// at a time, in a persistent loop over the tiles, so nothing but the
// uint8/uint16 pixels is read and nothing but the int32 blocks is written:
//
//   A. the tile's pixels (with edge replication past the frame) go into
//      shared memory, in 16-byte loads where the rows allow;
//   B. a thread step takes one box cell (the pixels one chroma sample
//      averages, 2 x 2 at 4:2:0): it converts each pixel once and writes
//      the luma samples and the cell's chroma samples, level-shifted, into
//      a [64 positions][64 blocks] float tile;
//   C. the FDCT as a register-tiled product [blocks x 64] @ [64 x 64]: a
//      thread holds 4 blocks x 8 coefficients, and each step reads one
//      float4 of samples and two of the operator for 32 FMAs;
//   D. quantize, scatter into zig-zag rows in shared memory;
//   E. store whole 256-byte rows with 16-byte stores (a tile's blocks of
//      one component row are consecutive output rows), each DC already
//      replaced by its difference to the previous block of its restart
//      interval where that block lies in the same tile.
//
// A second kernel finishes the DCs whose previous block lies in another
// tile: the first block of each component in a tile's first MCU.
//
// Numerics, held against the plain version models/encode_dense.py::
// pixels_to_zz_ref (PyTorch eager, no FMA contraction), and bit for bit
// the earlier one-block-per-64-threads kernel's:
//   * colour and the box average use __fmul_rn / __fadd_rn, so nvcc cannot
//     contract them into FMAs and the values are those of the eager
//     float32 ops, operand for operand, in the reference's order (y =
//     0.299r + 0.587g + 0.114b left to right; box sum yy outer, xx inner,
//     from 0.f, then the division by the step product);
//   * padded rows and columns keep the raw replicated RGB value of the
//     component's channel, not YCbCr (frame.c:162-163);
//   * the FDCT is the [64,64] float32 Kronecker operator the plain version
//     multiplies by (ops/dct._kron_mats()[1]), each coefficient one fmaf
//     chain over ascending sample positions from 0.f: only this sum's
//     order differs from the plain version's matmul, so a quantized value
//     may differ by 1 where c/q sits on a rounding boundary (the JAX
//     package's own device-vs-host contract);
//   * quantization is a true IEEE division __fdiv_rn(c, q) rounded half
//     away from zero, as roundf (round_away).  rintf / __float2int_rn
//     round ties to even and would be wrong.  kernels.py builds without
//     --use_fast_math and with the default -prec-div=true -ftz=false for
//     the same reason;
//   * the conversions stay off the SM's conversion pipe (16 results per
//     clock against 128 float32 operations): pixels become floats by the
//     exponent trick, the box average's division by its step product (1,
//     2 or 4) is the exact multiply by its reciprocal, and round_away
//     rounds with float adds.
//
// What bounds it on the H100: an 8-frame 1080p 4:2:0 chunk reads 49.8 MB
// of pixels and writes 100 MB of int32 blocks (~45 us at 3.35 TB/s); the
// dense FDCT is 4,096 FMAs per block, 1.6 G per chunk (~48 us at the
// float32 peak), so the tile loop keeps the FMAs fed from registers and
// shared memory rather than from device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "round_away.cuh"

namespace {

constexpr int COMP_INTS = 8;  // models/encode_dense.py COMP_INTS
constexpr int C_MAX = 3;
constexpr int THREADS = 128;
constexpr int TILE_BLOCKS = 64;  // block slots of a tile: 4 warps x 16
// Sample rows: 68 block slots, so that the lanes of a box cell step write
// to distinct banks, and a row stays 16-byte aligned for float4 loads.
constexpr int SROW = TILE_BLOCKS + 4;
// Shared memory before the pixel stage: operator, samples, quantizers,
// inverse zig-zag, component records, block rows and their prev_idx.
constexpr int FIXED_BYTES =
    (64 * 64 + 64 * SROW) * 4 +
    (2 * 64 + 64 + C_MAX * COMP_INTS + 2 * TILE_BLOCKS) * 4;
static_assert(FIXED_BYTES % 16 == 0, "the pixel stage must be 16-aligned");

struct Params {
  int frames, height, width, nc, precision, bf;
  int m_x, m_y, mcus, tiles_x, mcu_w, mcu_h, bpm;
};

// Component of local block b of a tile of n MCUs: record j holds
// h, v, step_y, step_x, block offset, b_x, qtable, first block of an MCU.
__device__ __forceinline__ int comp_of(const int32_t* cp, int nc, int n,
                                       int b) {
  int j = 0;
  while (j + 1 < nc && b >= n * cp[(j + 1) * COMP_INTS + 7]) ++j;
  return j;
}

// x exactly as a float, for 0 <= x < 2^23: (2^23 + x) - 2^23.
__device__ __forceinline__ float px_float(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | x), 8388608.f);
}

// The component of a block's row in its frame (by block offsets), and its
// tile's local block index for the tile (my, tx) of n MCUs, or -1 outside.
__device__ __forceinline__ int comp_of_row(const int32_t* cp, int nc,
                                           int frow) {
  int j = 0;
  while (j + 1 < nc && frow >= cp[(j + 1) * COMP_INTS + 4]) ++j;
  return j;
}

__device__ __forceinline__ int local_block(const int32_t* cp, int nc,
                                           int mcus, int frow, int my,
                                           int tx, int n) {
  const int32_t* c = cp + comp_of_row(cp, nc, frow) * COMP_INTS;
  const int pl = frow - c[4];
  const int by = pl / c[5], bx = pl - by * c[5];
  const int r = by - my * c[1], cc = bx - tx * mcus * c[0];
  if (r < 0 || r >= c[1] || cc < 0 || cc >= n * c[0]) return -1;
  return n * c[7] + r * n * c[0] + cc;
}

__device__ __forceinline__ int tile_of_row(const int32_t* cp, int nc,
                                           int mcus, int tiles_x, int frow) {
  const int32_t* c = cp + comp_of_row(cp, nc, frow) * COMP_INTS;
  const int pl = frow - c[4];
  const int by = pl / c[5], bx = pl - by * c[5];
  return (by / c[1]) * tiles_x + bx / (mcus * c[0]);
}

// A tile of the persistent loop: frame, MCU row and tile column, its
// MCUs and blocks, and its pixel window in the padded frame.
struct Tile {
  int f, my, tx, n, nblk, y0, x0, cols;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int64_t t) {
  const int per_frame = p.m_y * p.tiles_x;
  Tile g;
  g.f = static_cast<int>(t / per_frame);
  const int rem = static_cast<int>(t - static_cast<int64_t>(g.f) * per_frame);
  g.my = rem / p.tiles_x;
  g.tx = rem - g.my * p.tiles_x;
  g.n = min(p.mcus, p.m_x - g.tx * p.mcus);
  g.nblk = g.n * p.bpm;
  g.y0 = g.my * p.mcu_h;
  g.x0 = g.tx * p.mcus * p.mcu_w;
  g.cols = g.n * p.mcu_w;
  return g;
}

// Row in its frame of local block b of tile g.
__device__ __forceinline__ int block_row(const int32_t* CP, const Params& p,
                                         const Tile& g, int b) {
  const int32_t* c = CP + comp_of(CP, p.nc, g.n, b) * COMP_INTS;
  const int local = b - g.n * c[7];
  const int cw = g.n * c[0];
  const int r = local / cw;
  return c[4] + (g.my * c[1] + r) * c[5] + g.tx * p.mcus * c[0] +
         (local - r * cw);
}

// Tile g's pixels [mcu_h][cols][nc] into the stage, rows and columns
// past the frame replicated from its last row and column: 16-byte loads
// where the rows lie inside the frame's width, 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ px,
                                           const Params& p, const Tile& g,
                                           T* stage) {
  const int row_elems = g.cols * p.nc;
  const int64_t frame = static_cast<int64_t>(g.f) * p.height * p.width * p.nc;
  const size_t row_bytes = static_cast<size_t>(row_elems) * sizeof(T);
  const bool vec =
      g.x0 + g.cols <= p.width && row_bytes % 16 == 0 &&
      (static_cast<size_t>(p.width) * p.nc * sizeof(T)) % 16 == 0 &&
      (static_cast<size_t>(g.x0) * p.nc * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(px) % 16 == 0;
  if (vec) {
    const int vpr = static_cast<int>(row_bytes / 16);
    for (int e = threadIdx.x; e < p.mcu_h * vpr; e += THREADS) {
      const int r = e / vpr;
      const int ys = min(g.y0 + r, p.height - 1);
      reinterpret_cast<uint4*>(stage)[e] = __ldg(
          reinterpret_cast<const uint4*>(
              px + frame + (static_cast<int64_t>(ys) * p.width + g.x0) * p.nc) +
          (e - r * vpr));
    }
  } else {
    for (int e = threadIdx.x; e < p.mcu_h * row_elems; e += THREADS) {
      const int r = e / row_elems, q = e - r * row_elems;
      const int x = q / p.nc, ch = q - x * p.nc;
      const int ys = min(g.y0 + r, p.height - 1);
      const int xs = min(g.x0 + x, p.width - 1);
      stage[e] =
          px[frame + (static_cast<int64_t>(ys) * p.width + xs) * p.nc + ch];
    }
  }
}

// A component's place in a tile of n MCUs: its first block and the
// blocks of one of its block rows there, and whether its box is the cell.
struct CompTile {
  int first, row;
  bool box;
};

// Slot in S of the sample at (py, px) of the component's plane within
// the tile.
__device__ __forceinline__ int sample_slot(const CompTile& c, int py,
                                           int px) {
  const int k = ((py & 7) << 3) | (px & 7);
  return k * SROW + c.first + (py >> 3) * c.row + (px >> 3);
}

// B for the pixels of box cell (cr, cc): every component sample they
// make, level-shifted, into S.  A component whose box is 1 x 1 takes one
// sample per pixel; one whose box is the cell (cy x cx) sums its cell's
// values yy outer, xx inner from 0.f, then multiplies by 1 / (cy * cx),
// which is exact for the 1, 2 or 4 pixels a box holds.  The colour
// formulas are the reference's, with a - b written as a + (-b) (exact);
// the MCU padding keeps the raw replicated channel value.
template <int CY, int CX, typename T>
__device__ __forceinline__ void cell_samples(const T* stage,
                                             const CompTile* ct,
                                             const Params& p, int cols,
                                             int y0, int x0, int cr, int cc,
                                             float shift, float* S) {
  float acc[C_MAX] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int yy = 0; yy < CY; ++yy) {
#pragma unroll
    for (int xx = 0; xx < CX; ++xx) {
      const int ry = cr * CY + yy, rx = cc * CX + xx;
      const T* s = stage + (ry * cols + rx) * p.nc;
      const bool inside = y0 + ry < p.height && x0 + rx < p.width;
      float v[C_MAX];
      if (p.nc == 1) {
        v[0] = px_float(s[0]);
      } else {
        const float r = px_float(s[0]), g = px_float(s[1]), b = px_float(s[2]);
        v[0] = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                         __fmul_rn(0.114f, b));
        v[1] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(-0.1687f, r), __fmul_rn(-0.3313f, g)),
                      __fmul_rn(0.5f, b)),
            shift);
        v[2] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(0.5f, r), __fmul_rn(-0.4187f, g)),
                      __fmul_rn(-0.0813f, b)),
            shift);
        if (!inside) {
          v[0] = r;
          v[1] = g;
          v[2] = b;
        }
      }
#pragma unroll
      for (int j = 0; j < C_MAX; ++j) {
        if (j >= p.nc) break;
        if (!ct[j].box)
          S[sample_slot(ct[j], ry, rx)] = __fsub_rn(v[j], shift);
        else
          acc[j] = __fadd_rn(acc[j], v[j]);
      }
    }
  }
  const float inv = CY * CX == 4 ? 0.25f : 0.5f;
#pragma unroll
  for (int j = 0; j < C_MAX; ++j) {
    if (j >= p.nc) break;
    if (ct[j].box)
      S[sample_slot(ct[j], cr, cc)] =
          __fsub_rn(__fmul_rn(acc[j], inv), shift);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pixels_to_zz_kernel(const T* __restrict__ px,
                    const float* __restrict__ fdct,      // [64, 64]
                    const int32_t* __restrict__ inv_zz,  // [64]
                    const int32_t* __restrict__ comps,   // [C_MAX, 8]
                    const int32_t* __restrict__ qtables,  // [2, 64]
                    const int32_t* __restrict__ prev_idx,  // [Bf]
                    int32_t* __restrict__ zz,            // [F*Bf, 64]
                    int32_t* __restrict__ dc_raw,        // [F*Bf]
                    Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* M = reinterpret_cast<float*>(smem);  // [64 i][64 k]
  float* S = M + 64 * 64;  // samples [64 i][SROW]
  // Then the quantized rows [TILE_BLOCKS][SROW]: at 64 ints a row, the 4
  // blocks a warp quantizes at once would share every bank.
  int32_t* O = reinterpret_cast<int32_t*>(S);
  int32_t* Q = reinterpret_cast<int32_t*>(S + 64 * SROW);
  int32_t* INV = Q + 2 * 64;
  int32_t* CP = INV + 64;
  int32_t* FROW = CP + C_MAX * COMP_INTS;  // each block's row in its frame
  int32_t* PREV = FROW + TILE_BLOCKS;  // and prev_idx of it
  T* stage = reinterpret_cast<T*>(smem + FIXED_BYTES);
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * 64 / 4; i += THREADS)
    reinterpret_cast<float4*>(M)[i] =
        __ldg(reinterpret_cast<const float4*>(fdct) + i);
  for (int i = tid; i < 2 * 64; i += THREADS) Q[i] = qtables[i];
  if (tid < 64) INV[tid] = inv_zz[tid];
  if (tid < C_MAX * COMP_INTS) CP[tid] = comps[tid];
  __syncthreads();

  const float shift = static_cast<float>(1 << (p.precision - 1));
  const int lane = tid & 31, warp = tid >> 5;
  // The box cell: the largest step of any component (the wrapper admits
  // only components whose box is 1 x 1 or this cell).
  int cy = 1, cx = 1;
  for (int j = 0; j < p.nc; ++j) {
    cy = max(cy, CP[j * COMP_INTS + 2]);
    cx = max(cx, CP[j * COMP_INTS + 3]);
  }
  // FDCT ownership: blocks b0..b0+3, coefficients kA..kA+3 and kB..kB+3
  // (each float4 load of the operator then covers all 32 banks once).
  const int b0 = warp * 16 + (lane >> 3) * 4;
  const int kA = (lane & 7) * 4, kB = 32 + kA;
  const int64_t total = static_cast<int64_t>(p.frames) * p.m_y * p.tiles_x;
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile g = tile_at(p, t);
    const int n = g.n, nblk = g.nblk, y0 = g.y0, x0 = g.x0, cols = g.cols;

    // A. pixels, and each block's row and prev_idx (their loads in
    // flight beside the pixels').
    stage_tile(px, p, g, stage);
    if (tid < nblk) {
      const int frow = block_row(CP, p, g, tid);
      FROW[tid] = frow;
      PREV[tid] = prev_idx[frow];
    }
    __syncthreads();

    // B. level-shifted samples, one box cell per thread step; block slots
    // past the tile's blocks hold zeros.
    CompTile ct[C_MAX];
#pragma unroll
    for (int j = 0; j < C_MAX; ++j) {
      const int32_t* c = CP + j * COMP_INTS;
      ct[j] = {n * c[7], n * c[0], c[2] != 1 || c[3] != 1};
    }
    const int ccols = cols / cx;
    for (int e = tid; e < (p.mcu_h / cy) * ccols; e += THREADS) {
      const int cr = e / ccols, cc = e - cr * ccols;
      // The cell's pixels unrolled, so their loads overlap.
      if (cy == 2 && cx == 2)
        cell_samples<2, 2>(stage, ct, p, cols, y0, x0, cr, cc, shift, S);
      else if (cy == 1 && cx == 2)
        cell_samples<1, 2>(stage, ct, p, cols, y0, x0, cr, cc, shift, S);
      else if (cy == 2 && cx == 1)
        cell_samples<2, 1>(stage, ct, p, cols, y0, x0, cr, cc, shift, S);
      else
        cell_samples<1, 1>(stage, ct, p, cols, y0, x0, cr, cc, shift, S);
    }
    for (int e = tid; e < 64 * (TILE_BLOCKS - nblk); e += THREADS) {
      const int k = e / (TILE_BLOCKS - nblk);
      S[k * SROW + nblk + (e - k * (TILE_BLOCKS - nblk))] = 0.f;
    }
    __syncthreads();

    // C. FDCT: acc[b][k] = fmaf chain over ascending positions i.
    const bool active = warp * 16 < nblk;
    float acc[4][8];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc[bb][kk] = 0.f;
    if (active) {
#pragma unroll 2
      for (int i = 0; i < 64; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(S + i * SROW + b0);
        const float4 ma = *reinterpret_cast<const float4*>(M + i * 64 + kA);
        const float4 mb = *reinterpret_cast<const float4*>(M + i * 64 + kB);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float mv[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            acc[bb][kk] = fmaf(sv[bb], mv[kk], acc[bb][kk]);
      }
    }
    __syncthreads();

    // D. quantize into zig-zag rows (O aliases S).
    if (active) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int b = b0 + bb;
        if (b >= nblk) continue;
        const int32_t* q = Q + CP[comp_of(CP, p.nc, n, b) * COMP_INTS + 6] * 64;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int k = kk < 4 ? kA + kk : kB + kk - 4;
          O[b * SROW + INV[k]] =
              round_away(__fdiv_rn(acc[bb][kk], static_cast<float>(q[k])));
        }
      }
    }
    __syncthreads();

    // E. rows out, 16 bytes a thread; the raw DC beside them, and the
    // DC difference where the previous block is in this tile.
    for (int e = tid; e < nblk * 16; e += THREADS) {
      const int b = e >> 4, part = e & 15;
      const int64_t row = static_cast<int64_t>(g.f) * p.bf + FROW[b];
      int4 v = reinterpret_cast<const int4*>(O + b * SROW)[part];
      if (part == 0) {
        dc_raw[row] = v.x;
        if (PREV[b] >= 0) {
          const int pb = local_block(CP, p.nc, p.mcus, PREV[b], g.my, g.tx, n);
          if (pb >= 0) v.x -= O[pb * SROW];
        }
      }
      reinterpret_cast<int4*>(zz + row * 64)[part] = v;
    }
    __syncthreads();  // FROW, PREV and O are rewritten by the next tile
  }
}

// zz[n][0] = dc[n] - dc[prev(n)] for the blocks whose previous block of
// the restart interval lies in another tile (the tile kernel did the rest).
__global__ void dc_fixup_kernel(const int32_t* __restrict__ dc_raw,
                                const int32_t* __restrict__ prev_idx,
                                const int32_t* __restrict__ comps,
                                int32_t* __restrict__ zz, int64_t total,
                                int bf, int nc, int mcus, int tiles_x) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int64_t f = n / bf;
  const int frow = static_cast<int>(n - f * bf);
  const int prev = prev_idx[frow];
  if (prev < 0 || tile_of_row(comps, nc, mcus, tiles_x, frow) ==
                      tile_of_row(comps, nc, mcus, tiles_x, prev))
    return;
  zz[n * 64] = dc_raw[n] - dc_raw[f * bf + prev];
}

template <typename T>
cudaError_t launch_tiles(const T* px, const Params& p, size_t shared,
                         const float* m, const int32_t* inv,
                         const int32_t* c, const int32_t* q,
                         const int32_t* prev, int32_t* out, int32_t* dc,
                         cudaStream_t s) {
  auto kernel = pixels_to_zz_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, shared);
  if (err != cudaSuccess) return err;
  // Persistent CTAs, as many as fit at once: each loads the operator once.
  const int64_t tiles =
      static_cast<int64_t>(p.frames) * p.m_y * p.tiles_x;
  const int64_t cap = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  kernel<<<grid, THREADS, shared, s>>>(px, m, inv, c, q, prev, out, dc, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jt_encode_dense_tile_blocks() { return TILE_BLOCKS; }

// Launches both kernels on `stream`; returns the first CUDA error.
extern "C" int jt_pixels_to_zz(const void* pixels, int is16, const void* fdct,
                               const void* inv_zz, const void* comps,
                               const void* qtables, const void* prev_idx,
                               void* zz, void* dc_raw, int frames, int height,
                               int width, int nc, int precision, int bf,
                               int m_x, int m_y, int mcus, int tiles_x,
                               int mcu_w, int mcu_h, int bpm, void* stream) {
  const Params p{frames, height, width, nc, precision, bf,
                 m_x, m_y, mcus, tiles_x, mcu_w, mcu_h, bpm};
  const int64_t total = static_cast<int64_t>(frames) * bf;
  if (total <= 0) return 0;
  if (mcus * bpm > TILE_BLOCKS || nc < 1 || nc > C_MAX) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stage = static_cast<size_t>(mcu_h) * mcus * mcu_w * nc *
                       (is16 ? 2 : 1);
  const size_t shared = FIXED_BYTES + (stage + 15) / 16 * 16;
  const float* m = static_cast<const float*>(fdct);
  const int32_t* inv = static_cast<const int32_t*>(inv_zz);
  const int32_t* c = static_cast<const int32_t*>(comps);
  const int32_t* q = static_cast<const int32_t*>(qtables);
  const int32_t* prev = static_cast<const int32_t*>(prev_idx);
  int32_t* out = static_cast<int32_t*>(zz);
  int32_t* dc = static_cast<int32_t*>(dc_raw);
  cudaError_t err =
      is16 ? launch_tiles(static_cast<const uint16_t*>(pixels), p, shared, m,
                          inv, c, q, prev, out, dc, s)
           : launch_tiles(static_cast<const uint8_t*>(pixels), p, shared, m,
                          inv, c, q, prev, out, dc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dthreads = 256;
  const int64_t dgrid = (total + dthreads - 1) / dthreads;
  dc_fixup_kernel<<<static_cast<unsigned>(dgrid), dthreads, 0, s>>>(
      dc, prev, c, out, total, bf, nc, mcus, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
