// What the float64 certifiers of all-<= batches share: the certifier of
// batches without bounds (certify_le.cu) and that of bounded ones
// (certify_bounded.cu).  Both run one warp an instance, lane l owning
// rows (and basis positions) l and l + 32 of the m <= kMaxRows basis
// matrix, which they keep in shared memory at an odd row pitch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRows = 64;             // two rows a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOptimal = 0;

__host__ __device__ inline int pitch_of(int m) { return m | 1; }

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ double load_real(const void* p, int64_t i,
                                            int is_f64) {
  return is_f64 ? __ldg(static_cast<const double*>(p) + i)
                : static_cast<double>(__ldg(static_cast<const float*>(p) + i));
}

__device__ __forceinline__ double warp_max(double v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void reject(double* xrow, int n, int lane,
                                       uint8_t* cert, double* fun) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (int j = lane; j < n; j += kWarp) xrow[j] = nan;
  if (lane == 0) {
    *cert = 0;
    *fun = nan;
  }
}

}  // namespace
