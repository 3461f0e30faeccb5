// K4: the streaming copy out = x + 1e-7 over a contiguous array, in place or
// out of place, for Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py::_pallas_stream_gbps (body copy_kernel,
// o_ref[...] = x_ref[...] + 1e-7): the hand-written copy whose GB/s is the
// measured streaming ceiling that the pivot rate is held against.  The
// constant is the tensor's type (1e-7f in float32, as JAX's weak-typed
// literal rounds it) and the sum rounds once, so the result is bit-equal to
// torch.add(x, 1e-7) in either type.  `out` is either `x` itself (in place:
// each element is read and then written by the same thread) or an array that
// does not overlap it.
//
// Bound: bytes.  Each element is read once and written once:
// 2 * numel * sizeof(T) bytes, at 3.35 TB/s on an H100 SXM; one add an
// element is far below the arithmetic peak.  Design:
//   * the TPU kernel's (blk, N) VMEM row blocks and its (64, 128) tile
//     rounding are Mosaic constraints and are not carried over; the kernel
//     takes any contiguous length;
//   * a grid-stride loop over 16-byte vectors (float4 / double2), one load
//     and one store a vector, neighbouring threads on neighbouring vectors,
//     kUnroll loads in flight a thread before its stores; the grid is sized
//     from the SM count (kBlocksPerSM resident blocks an SM), so every SM
//     keeps loads in flight and no block waits for a second wave;
//   * a scalar head (elements before the first 16-byte boundary of x) and
//     tail (after the last whole vector) let a view that starts off the
//     boundary or has an odd length take the vector path; where x and out
//     are misaligned against each other by other than a whole vector, every
//     element takes the scalar loop;
//   * 64-bit indices, so arrays above 2^31 elements work.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kUnroll = 4;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float4 add_vec(float4 v, float c) {
  v.x = add_rn(v.x, c);
  v.y = add_rn(v.y, c);
  v.z = add_rn(v.z, c);
  v.w = add_rn(v.w, c);
  return v;
}
__device__ __forceinline__ double2 add_vec(double2 v, double c) {
  v.x = add_rn(v.x, c);
  v.y = add_rn(v.y, c);
  return v;
}

// Elements [head, head + nvec * VEC) as nvec vectors; the `rest` others
// (the head [0, head) and the tail [head + nvec * VEC, n)) one at a time.
// No __restrict__: in place, x and out are the same array.
template <typename T, typename V>
__global__ void stream_add_kernel(const T* x, T* out, int64_t n, int64_t head,
                                  int64_t nvec, T c) {
  constexpr int64_t VEC = sizeof(V) / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const V* xv = reinterpret_cast<const V*>(x + head);
  V* ov = reinterpret_cast<V*>(out + head);
  // kUnroll loads in flight a thread before its stores: in place, program
  // order alone keeps the compiler from hoisting a load above a store that
  // may alias it.
  for (int64_t i0 = tid; i0 < nvec; i0 += stride * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < nvec) v[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < nvec) ov[i] = add_vec(v[u], c);
    }
  }
  const int64_t tail0 = head + nvec * VEC;
  const int64_t rest = head + (n - tail0);
  for (int64_t k = tid; k < rest; k += stride) {
    const int64_t i = k < head ? k : tail0 + (k - head);
    out[i] = add_rn(x[i], c);
  }
}

template <typename T, typename V>
int launch(const T* x, T* out, int64_t n, T c, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  constexpr int64_t VEC = sizeof(V) / sizeof(T);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out);
  int64_t head = n, nvec = 0;
  if (ax % sizeof(T) == 0 && (ax - ao) % sizeof(V) == 0) {
    head = (int64_t)(((sizeof(V) - ax % sizeof(V)) % sizeof(V)) / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / VEC;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t work = nvec + (n - nvec * VEC);  // vectors + scalars
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  stream_add_kernel<T, V><<<(unsigned)blocks, kThreads, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      x, out, n, head, nvec, c);
  return (int)cudaGetLastError();
}

}  // namespace

// out == x runs in place; otherwise the two arrays must not overlap (the
// Python wrapper checks).
extern "C" int k4_stream_copy_f32(const float* x, float* out, int64_t numel,
                                  void* stream) {
  return launch<float, float4>(x, out, numel, 1e-7f, stream);
}

extern "C" int k4_stream_copy_f64(const double* x, double* out, int64_t numel,
                                  void* stream) {
  return launch<double, double2>(x, out, numel, 1e-7, stream);
}
