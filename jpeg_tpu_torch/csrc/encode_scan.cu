// encode_scan: restart-segment Huffman encode of quantized zig-zag blocks
// into one tight stream of big-endian-bit u32 words, and the per-table
// symbol histogram of the same blocks, for Hopper (sm_90a).
//
// Replaces the JAX package's XLA device programs
// jpeg_tpu/entropy/encode_jax.py::encode_scan_device3 (with the transfer
// compaction device_encode._compact_segment_words) and
// encode_jax.py::hist_from_blocks.  The TPU runs a block-lane symbol state
// machine over a static number of item slots, builds [B, slots] word
// buffers and merges them into padded [n_segments, words_per_seg] rows
// with scatter-adds, behind sticky capacities that grow and retry on
// overflow.  Here every block is one thread that walks its own symbols
// (walk_block), and the three kernels differ only in what they do with
// each symbol:
//
//   1. encode_bits: thread i (bitstream position i, block row order[i])
//      counts its bits (DC category + extra bits, (run, cat) symbols, ZRL
//      before a nonzero that follows 16+ zeros, EOB unless position 63 is
//      nonzero) and flags a symbol whose code length is 0 (missing);
//   2. the wrapper (entropy/encode_cuda.py) takes the segmented exclusive
//      prefix sums with torch.cumsum: each segment starts on a fresh word
//      of the tight stream, each block at its 64-bit bit offset;
//   3. encode_pack: thread i writes its bits MSB-first from its offset,
//      atomicOr on every word (a block shares its first and last word
//      with its neighbours);
//   4. hist_blocks (the optimize=True dry pass, encoder.c:525-558): each
//      thread counts its block's symbols with integer atomics into a
//      per-CTA shared-memory histogram [T, 256], and each CTA adds its
//      nonzero bins into the global int32 histogram.  Exact in int32 at
//      any size, where the TPU's float32 one-hot sums are exact only below
//      2^24 per bin.
//
// The symbol rules are those of encode_scan_device3 bit for bit, missing
// codes included: an item is (ehufco[s] << cat) | extra over
// ehufsi[s] + cat bits, negative values carry (v - 1) & mask, and the
// category is the bit length of |v| capped at 16 (encode_cat_jax).  The
// plain versions are entropy/encode_torch.py::encode_scan_ref and
// hist_from_blocks_ref.
//
// What bounds it on the H100: an 8-frame 1080p chunk is 391,680 blocks,
// so ~3,000 CTAs of 128 threads, each thread a dependent walk over its
// 64 coefficients (its own 256-byte row, so a warp's loads are not
// coalesced; L1 serves the row after its first touch) with table lookups
// in shared memory.  It is latency-bound;
// the output is ~the compressed size, a few MB, and the atomics touch
// each word once or twice.  The histogram reads the same 100 MB of blocks
// (~30 us at HBM rate) with shared-memory atomics on a few hot bins (EOB,
// small categories); its grid of 4 CTAs per SM strides over the blocks so
// that the global adds stay at 4 x SMs x T x 256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T_MAX = 8;  // stacked code tables
constexpr int THREADS = 128;

__device__ __forceinline__ int category(int v) {
  // encode_cat_jax: #{k < 16 : |v| >= 2^k}, with |INT_MIN| wrapping to a
  // negative value (category 0) as jnp.abs does.
  const int mag =
      static_cast<int>(v < 0 ? 0u - static_cast<uint32_t>(v)
                             : static_cast<uint32_t>(v));
  if (mag <= 0) return 0;
  return min(32 - __clz(mag), 16);
}

__device__ __forceinline__ uint32_t extra_bits(int v, int cat) {
  const uint32_t adj = static_cast<uint32_t>(v < 0 ? v - 1 : v);
  return adj & ((1u << cat) - 1u);
}

// Walks one block's Huffman items in bitstream order, calling
// sink(sym, cat, extra) for each: `sym` indexes the stacked [T, 256] code
// tables (table * 256 + symbol value), and `cat` extra bits `extra`
// follow its code.
template <typename Sink>
__device__ __forceinline__ void walk_block(const int32_t* __restrict__ row,
                                           int dct, int act, Sink& sink) {
  const int dc = row[0];
  const int dcat = category(dc);
  sink(dct * 256 + dcat, dcat, extra_bits(dc, dcat));
  const int a = act * 256;
  int last = 0;
  for (int p = 1; p < 64; ++p) {
    const int v = row[p];
    if (v == 0) continue;
    const int gap = p - last - 1;
    for (int z = 0; z < (gap >> 4); ++z) sink(a + 0xF0, 0, 0u);
    const int cat = category(v);
    sink(a + (((gap & 15) << 4) | cat), cat, extra_bits(v, cat));
    last = p;
  }
  if (last != 63) sink(a, 0, 0u);
}

struct CountSink {
  const int32_t* si;
  int bits = 0;
  bool missing = false;
  __device__ void operator()(int sym, int cat, uint32_t) {
    const int size = si[sym];
    bits += size + cat;
    missing |= size == 0;
  }
};

struct PackSink {
  const int32_t* co;
  const int32_t* si;
  uint32_t* words;
  int64_t w;     // word the window's first bit lands in
  uint64_t acc;  // the window's low `n` bits, MSB first
  int n;
  __device__ void operator()(int sym, int cat, uint32_t extra) {
    const int len = si[sym] + cat;
    if (len == 0) return;
    const uint32_t val = (static_cast<uint32_t>(co[sym]) << cat) | extra;
    // n < 32 and len <= 32, so n + len <= 63 bits fit the window.
    acc = (acc << len) | (len == 32 ? val : (val & ((1u << len) - 1u)));
    n += len;
    if (n >= 32) {
      const uint32_t out = static_cast<uint32_t>(acc >> (n - 32));
      if (out) atomicOr(words + w, out);
      ++w;
      n -= 32;
      acc &= (n ? (~0ull >> (64 - n)) : 0ull);
    }
  }
  __device__ void flush() {
    if (n > 0) {
      const uint32_t out = static_cast<uint32_t>(acc << (32 - n));
      if (out) atomicOr(words + w, out);
    }
  }
};

struct HistSink {
  int32_t* h;  // the CTA's shared [T, 256] histogram
  __device__ void operator()(int sym, int, uint32_t) { atomicAdd(h + sym, 1); }
};

__device__ __forceinline__ void load_tables(const int32_t* ehufco,
                                            const int32_t* ehufsi, int T,
                                            int32_t* co, int32_t* si) {
  for (int i = threadIdx.x; i < T * 256; i += blockDim.x) {
    co[i] = ehufco[i];
    si[i] = ehufsi[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
encode_bits_kernel(const int32_t* __restrict__ zz,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ dc_tab,
                   const int32_t* __restrict__ ac_tab,
                   const int32_t* __restrict__ ehufco,
                   const int32_t* __restrict__ ehufsi, int T, int B,
                   int32_t* __restrict__ blk_bits,
                   int32_t* __restrict__ missing) {
  __shared__ int32_t co[T_MAX * 256];
  __shared__ int32_t si[T_MAX * 256];
  load_tables(ehufco, ehufsi, T, co, si);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int row = order[i];
  CountSink sink{si};
  walk_block(zz + static_cast<int64_t>(row) * 64, dc_tab[row], ac_tab[row],
             sink);
  blk_bits[i] = sink.bits;
  if (sink.missing) atomicOr(missing, 1);
}

__global__ void __launch_bounds__(THREADS)
encode_pack_kernel(const int32_t* __restrict__ zz,
                   const int32_t* __restrict__ order,
                   const int32_t* __restrict__ dc_tab,
                   const int32_t* __restrict__ ac_tab,
                   const int32_t* __restrict__ ehufco,
                   const int32_t* __restrict__ ehufsi, int T, int B,
                   const int64_t* __restrict__ dst_bit,
                   uint32_t* __restrict__ words) {
  __shared__ int32_t co[T_MAX * 256];
  __shared__ int32_t si[T_MAX * 256];
  load_tables(ehufco, ehufsi, T, co, si);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int row = order[i];
  const int64_t bit = dst_bit[i];
  // The window starts at the block's first word with the bits before the
  // block's offset held as zeros, which leave the neighbour's bits alone.
  PackSink sink{co, si, words, bit >> 5, 0ull, static_cast<int>(bit & 31)};
  walk_block(zz + static_cast<int64_t>(row) * 64, dc_tab[row], ac_tab[row],
             sink);
  sink.flush();
}

__global__ void __launch_bounds__(THREADS)
hist_blocks_kernel(const int32_t* __restrict__ zz,
                   const int32_t* __restrict__ dc_tab,
                   const int32_t* __restrict__ ac_tab, int T, int64_t B,
                   int32_t* __restrict__ hist) {
  __shared__ int32_t h[T_MAX * 256];
  for (int i = threadIdx.x; i < T * 256; i += THREADS) h[i] = 0;
  __syncthreads();
  HistSink sink{h};
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       b < B; b += static_cast<int64_t>(gridDim.x) * THREADS)
    walk_block(zz + b * 64, dc_tab[b], ac_tab[b], sink);
  __syncthreads();
  for (int i = threadIdx.x; i < T * 256; i += THREADS)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

}  // namespace

extern "C" int jt_encode_scan_t_max() { return T_MAX; }

// Pass 1 on `stream`; returns cudaGetLastError() after the launch.
extern "C" int jt_encode_bits(const void* zz, const void* order,
                              const void* dc_tab, const void* ac_tab,
                              const void* ehufco, const void* ehufsi, int T,
                              int B, void* blk_bits, void* missing,
                              void* stream) {
  if (B <= 0) return 0;
  encode_bits_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(zz), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(dc_tab), static_cast<const int32_t*>(ac_tab),
      static_cast<const int32_t*>(ehufco), static_cast<const int32_t*>(ehufsi),
      T, B, static_cast<int32_t*>(blk_bits), static_cast<int32_t*>(missing));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on `stream` into zeroed `words`; returns cudaGetLastError().
extern "C" int jt_encode_pack(const void* zz, const void* order,
                              const void* dc_tab, const void* ac_tab,
                              const void* ehufco, const void* ehufsi, int T,
                              int B, const void* dst_bit, void* words,
                              void* stream) {
  if (B <= 0) return 0;
  encode_pack_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(zz), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(dc_tab), static_cast<const int32_t*>(ac_tab),
      static_cast<const int32_t*>(ehufco), static_cast<const int32_t*>(ehufsi),
      T, B, static_cast<const int64_t*>(dst_bit),
      static_cast<uint32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// Adds into the zeroed `hist` [T, 256] on `stream`; returns the first CUDA
// error (cudaGetLastError() after the launch).
extern "C" int jt_hist_blocks(const void* zz, const void* dc_tab,
                              const void* ac_tab, int T, long long B,
                              void* hist, void* stream) {
  if (B <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (B + THREADS - 1) / THREADS;
  // 4 CTAs per SM: each CTA adds its bins into the same hot global bins,
  // so more CTAs cost more than they hide (8 per SM took 1.7x as long
  // on an H100 80GB HBM3 at 700 W).
  const long long cap = 4LL * sms;
  const int grid = static_cast<int>(want < cap ? want : cap);
  hist_blocks_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(zz), static_cast<const int32_t*>(dc_tab),
      static_cast<const int32_t*>(ac_tab), T, static_cast<int64_t>(B),
      static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}
