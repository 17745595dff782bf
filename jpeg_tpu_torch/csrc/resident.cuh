// resident_ctas: the size of a persistent grid, shared by the kernels that
// walk their work with t = blockIdx.x, t += gridDim.x.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cuda_runtime.h>
#include <mutex>
#include <vector>

namespace {

struct Resident {
  const void* kernel;
  int device;
  int threads;
  size_t shared;
  int ctas;
};

// The CTAs of `kernel` (`threads` each, `shared` bytes of dynamic shared
// memory) that fit on the current device at once, its shared-memory
// opt-in raised to `shared` where needed: found once per (kernel, device,
// threads, shared size) and kept, so a launch makes one host call
// (cudaGetDevice) before its own.
cudaError_t resident_ctas(const void* kernel, int threads, size_t shared,
                          int* ctas) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::vector<Resident> known;
  std::lock_guard<std::mutex> lock(mu);
  size_t opted = 0;
  for (const Resident& r : known) {
    if (r.kernel != kernel || r.device != device) continue;
    if (r.threads == threads && r.shared == shared) {
      *ctas = r.ctas;
      return cudaSuccess;
    }
    opted = std::max(opted, r.shared);
  }
  if (shared > opted &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(shared))) != cudaSuccess)
    return err;
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, shared)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known.push_back({kernel, device, threads, shared, per_sm * sms});
  *ctas = per_sm * sms;
  return cudaSuccess;
}

}  // namespace
