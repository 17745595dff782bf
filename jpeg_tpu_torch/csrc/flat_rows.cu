// flat_rows: the lane-row rebuild of the flat-upload restart decode for
// Hopper (sm_90a), K13.
//
// Replaces the gather of jpeg_tpu/models/device_decode.py::
// _decode_device_flat (:272-273):
//   words = jnp.take(buf, starts[:, None] + arange(wn), mode="clip")
// In the flat prep mode the host packs every restart segment of a chunk
// back to back at word-aligned offsets in one u32 buffer (jt_prep_ecs_flat
// of native/scanner.cpp) and uploads that buffer, about the compressed
// size, instead of the zero-padded [S, wn] lane matrix.  This kernel
// rebuilds the matrix on the card:
//   words[s, j] = buf[clamp(starts[s] + j, 0, blen - 1)],  s < S, j < wn.
// Words past a segment's end hold the next segment's words (the decode
// kernels never consume them: a symbol that runs past its lane's bit count
// kills the lane before it is used).
//
// What bounds it on the H100: bytes.  For the 8-frame 1080p ri=4 chunk it
// reads ~2 MB of flat words and writes the ~7 MB matrix; there is no
// arithmetic to speak of.  The design: one thread per (row, 16-byte chunk
// of the row).  Consecutive threads cover consecutive chunks of a row, so
// a warp's four __ldg word loads a thread are coalesced (a row's source is
// contiguous, at any word offset), and its store is one 16-byte store: the
// row pitch wn is a multiple of 4 words, so every chunk is 16-byte aligned
// in the fresh output (which K1's staged word route needs as well).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // threads a CTA

__global__ void __launch_bounds__(THREADS)
    rows_from_flat_kernel(const uint32_t* __restrict__ buf,
                          const int32_t* __restrict__ starts,
                          uint4* __restrict__ words, int64_t chunks, int cpr,
                          int64_t blen) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (c >= chunks) return;
  const int64_t s = c / cpr;
  const int64_t j = 4 * (c - s * cpr);
  const int64_t at = static_cast<int64_t>(__ldg(starts + s)) + j;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t k = at + i;  // clip mode, as jnp.take's
    w[i] = __ldg(buf + (k < 0 ? 0 : k >= blen ? blen - 1 : k));
  }
  words[c] = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

// buf [blen] u32, starts [S] int32 (word offsets into buf), words [S, wn]
// u32 with wn % 4 == 0 and a 16-byte-aligned base.  Launches on `stream`
// and returns cudaGetLastError() after it; -1 for arguments it refuses.
extern "C" int jt_rows_from_flat(const void* buf, const void* starts,
                                 void* words, long long blen, int S, int wn,
                                 void* stream) {
  if (S <= 0 || wn <= 0) return 0;
  if (blen <= 0 || wn % 4 != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0)
    return -1;
  const int cpr = wn / 4;
  const int64_t chunks = static_cast<int64_t>(S) * cpr;
  const int64_t ctas = (chunks + THREADS - 1) / THREADS;
  rows_from_flat_kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(buf), static_cast<const int32_t*>(starts),
      static_cast<uint4*>(words), chunks, cpr, static_cast<int64_t>(blen));
  return static_cast<int>(cudaGetLastError());
}
