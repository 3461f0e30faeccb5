// K4: the streaming copy out = x + 1e-7 over a contiguous array, in place or
// out of place, for Hopper (sm_90a).
//
// Replaces the TPU kernel bench.py::_pallas_stream_gbps (body copy_kernel,
// o_ref[...] = x_ref[...] + 1e-7): the hand-written copy whose GB/s is the
// measured streaming ceiling that the pivot rate is held against.  The
// constant is the tensor's type (1e-7f in float32, as JAX's weak-typed
// literal rounds it) and the sum rounds once, so the result is bit-equal to
// torch.add(x, 1e-7) in either type.  `out` is either `x` itself (in place)
// or an array that does not overlap it.
//
// Bound: bytes.  Each element is read once and written once:
// 2 * numel * sizeof(T) bytes, at 3.35 TB/s on an H100 SXM; one add an
// element is far below the arithmetic peak.  Design: the pass is
// stream_common.cuh's skeleton with an add as its function.  The TPU
// kernel's (blk, N) VMEM row blocks and (64, 128) tile rounding are Mosaic
// constraints and are not carried over; the skeleton takes any contiguous
// length and gives each block of 256 threads one contiguous 4 KB tile, one
// 16-byte vector a thread, with streaming cache hints.  The first port ran
// a persistent grid (4 blocks an SM) whose threads each held four vectors
// a grid-stride apart, so every block touched four stretches of DRAM in
// every round; on the card it ran 5 % below torch's add_ (PERF.md).
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "stream_common.cuh"

namespace {

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
struct AddConst {
  T c;
  __device__ __forceinline__ stream::Vec<T> vec(stream::Vec<T> v,
                                                int64_t) const {
#pragma unroll
    for (int e = 0; e < stream::Vec<T>::N; ++e) v.v[e] = add_rn(v.v[e], c);
    return v;
  }
  __device__ __forceinline__ T one(T v, int64_t) const { return add_rn(v, c); }
};

// No __restrict__: in place, x and out are the same array.
template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    stream_add_kernel(const T* x, T* out, int64_t n, int64_t head,
                      int64_t nvec, T c) {
  stream::pass(x, out, n, head, nvec, AddConst<T>{c});
}

template <typename T>
int launch(const T* x, T* out, int64_t n, T c, void* cuda_stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const stream::Plan p = stream::plan(x, out, n);
  stream_add_kernel<T><<<p.blocks, stream::kThreads, 0,
                         reinterpret_cast<cudaStream_t>(cuda_stream)>>>(
      x, out, n, p.head, p.nvec, c);
  return (int)cudaGetLastError();
}

}  // namespace

// out == x runs in place; otherwise the two arrays must not overlap (the
// Python wrapper checks).
extern "C" int k4_stream_copy_f32(const float* x, float* out, int64_t numel,
                                  void* stream) {
  return launch<float>(x, out, numel, 1e-7f, stream);
}

extern "C" int k4_stream_copy_f64(const double* x, double* out, int64_t numel,
                                  void* stream) {
  return launch<double>(x, out, numel, 1e-7, stream);
}
