// Helpers shared by the batched step kernels K2 (fused_pivot_step.cu) and K3
// (fused_pivot_step_bounded.cu): explicitly rounded arithmetic, extrema that
// propagate NaN as torch.amin / amax / maximum do, and block reductions over
// the kThreads threads of the one block that owns an instance.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 2147483647;
constexpr int kRunning = -1;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  // a * b + c, rounded once.
  __device__ static float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static bool isinf(float a) { return ::isinf(a); }
  __device__ static bool isfinite(float a) { return ::isfinite(a); }
  static constexpr float kEps = 1.1920928955078125e-07f;  // 2^-23
};

template <>
struct Arith<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  // a * b + c, each operation rounded: in float64 the plain twins have no
  // wider type to round once in, so the kernels round as they do.
  __device__ static double fma(double a, double b, double c) {
    return __dadd_rn(__dmul_rn(a, b), c);
  }
  __device__ static double abs(double a) { return fabs(a); }
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static bool isinf(double a) { return ::isinf(a); }
  __device__ static bool isfinite(double a) { return ::isfinite(a); }
  static constexpr double kEps = 2.220446049250313e-16;  // 2^-52
};

// NaN-propagating extrema, as torch.amin / amax / maximum.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}
// max(x, 0) that keeps a NaN, as torch.clamp_min.
template <typename T>
__device__ __forceinline__ T clamp0(T x) {
  return x < T(0) ? T(0) : x;
}

struct MinF {
  template <typename T>
  __device__ T operator()(T a, T b) const { return nan_min(a, b); }
};
struct MaxF {
  template <typename T>
  __device__ T operator()(T a, T b) const { return nan_max(a, b); }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// Reduce v over the block; every thread gets the result.  The leading
// __syncthreads keeps `sh` from being overwritten while a previous
// reduction's result is still being read from it.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, Op op, V* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) v = op(v, sh[k]);
  return v;
}

}  // namespace
