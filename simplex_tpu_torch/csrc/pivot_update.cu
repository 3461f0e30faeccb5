// K1: one rank-1 simplex pivot on a dense (R, W) tableau, in place, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel simplex_tpu/ops/pallas_pivot.py::pivot_update_fused
// and computes what simplex_tpu/ops/tableau.py::pivot_update computes, with
// the update rounded once (see below):
//
//     prow      = T[r, :] * (1 / T[r, s])          (RHS lane clamped to >= 0
//                                                  when clamp_rhs is set)
//     T        <- T - T[:, s] (outer) prow
//     T[r, :]  <- prow
//     T[:, s]  <- e_r                               (exact 1.0 / 0.0)
//
// The pivot position (r, s) and a do_pivot flag are read from device memory,
// so the solve loop never reads them back to the host; do_pivot == 0 leaves
// T bit-identical.
//
// Bound: bytes.  Each pivot must read and write every element of T once:
// 2 * R * W * sizeof(T) bytes at 3.35 TB/s on an H100 SXM; two operations
// an element are far below the arithmetic peak.  Design:
//   * pivot_gather_kernel copies the pivot column and the normalised pivot
//     row into side buffers (R + W elements) BEFORE the update, so the
//     in-place update never reads T[:, s] or T[r, :] from the array it is
//     overwriting;
//   * pivot_apply_kernel is stream_common.cuh's skeleton over the flat
//     R * W array, so every width moves 16-byte vectors (the first port
//     vectorized only where W % (16 / sizeof(T)) == 0 and fell back to one
//     4-byte column a thread otherwise, at half the rate).  An element's row
//     is its flat index k divided by W, by a multiply-shift with a constant
//     the wrapper computes (row = (umulhi64(k, magic) + k) >> shift), once
//     a vector; its column is k - row * W.  A vector may span a row
//     boundary (more than one where W < 16 / sizeof(T)): the elements after
//     it step to the next row and read that row's col entry.  col[row] is
//     read once a row of the vector and prow[column] as scalars through L1;
//     both side buffers stay in L1/L2;
//   * the update is one fused multiply-add per element (one rounding),
//     as XLA contracts it inside the reference's solve loop; the plain
//     PyTorch twin rounds once too (float32 via float64).
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "stream_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <>
__device__ __forceinline__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}

// t - c * p with one rounding.
template <typename T>
__device__ __forceinline__ T fnms(T c, T p, T t);
template <>
__device__ __forceinline__ float fnms<float>(float c, float p, float t) {
  return __fmaf_rn(-c, p, t);
}
template <>
__device__ __forceinline__ double fnms<double>(double c, double p, double t) {
  return __fma_rn(-c, p, t);
}

template <typename T>
__global__ void pivot_gather_kernel(const T* __restrict__ tab, int64_t R,
                                    int64_t W, const int64_t* __restrict__ r_p,
                                    const int64_t* __restrict__ s_p,
                                    const uint8_t* __restrict__ do_p,
                                    int clamp_rhs, T* __restrict__ col,
                                    T* __restrict__ prow) {
  if (!*do_p) return;
  const int64_t r = *r_p;
  const int64_t s = *s_p;
  const T inv = T(1) / tab[r * W + s];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < R + W;
       i += stride) {
    if (i < R) {
      col[i] = tab[i * W + s];
    } else {
      const int64_t j = i - R;
      T v = mul_rn(tab[r * W + j], inv);
      if (clamp_rhs && j == W - 1 && v < T(0)) v = T(0);
      prow[j] = v;
    }
  }
}

// The per-element function of the apply pass.
template <typename T>
struct PivotApply {
  int64_t W, r, s;
  uint64_t magic;
  int shift;
  const T* col;
  const T* prow;

  __device__ __forceinline__ int64_t row_of(int64_t k) const {
    const uint64_t u = (uint64_t)k;
    return (int64_t)((__umul64hi(u, magic) + u) >> shift);
  }
  __device__ __forceinline__ T at(T t, int64_t i, int64_t j, T c) const {
    const T p = __ldg(prow + j);
    T out = i == r ? p : fnms(c, p, t);
    if (j == s) out = i == r ? T(1) : T(0);
    return out;
  }
  __device__ __forceinline__ stream::Vec<T> vec(stream::Vec<T> v,
                                                int64_t k) const {
    int64_t i = row_of(k);
    int64_t j = k - i * W;
    T c = __ldg(col + i);
#pragma unroll
    for (int e = 0; e < stream::Vec<T>::N; ++e) {
      if (e > 0 && ++j == W) {  // the vector runs into the next row
        j = 0;
        c = __ldg(col + ++i);
      }
      v.v[e] = at(v.v[e], i, j, c);
    }
    return v;
  }
  __device__ __forceinline__ T one(T t, int64_t k) const {
    const int64_t i = row_of(k);
    return at(t, i, k - i * W, __ldg(col + i));
  }
};

template <typename T>
__global__ void __launch_bounds__(stream::kThreads)
    pivot_apply_kernel(T* tab, int64_t n, int64_t head, int64_t nvec,
                       PivotApply<T> f, const int64_t* __restrict__ r_p,
                       const int64_t* __restrict__ s_p,
                       const uint8_t* __restrict__ do_p) {
  if (!*do_p) return;
  PivotApply<T> g = f;
  g.r = *r_p;
  g.s = *s_p;
  stream::pass(tab, tab, n, head, nvec, g);
}

template <typename T>
int launch(T* tab, int64_t R, int64_t W, uint64_t magic, int shift,
           const int64_t* r, const int64_t* s, const uint8_t* do_pivot,
           int clamp_rhs, T* col, T* prow, void* cuda_stream) {
  if (R <= 0 || W <= 0 || shift < 0 || shift > 63)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(cuda_stream);
  constexpr int kGatherThreads = 256;
  int64_t gather_blocks = (R + W + kGatherThreads - 1) / kGatherThreads;
  if (gather_blocks > 4096) gather_blocks = 4096;
  pivot_gather_kernel<T><<<(unsigned)gather_blocks, kGatherThreads, 0, st>>>(
      tab, R, W, r, s, do_pivot, clamp_rhs, col, prow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = R * W;
  const stream::Plan p = stream::plan(tab, tab, n);
  const PivotApply<T> f{W, 0, 0, magic, shift, col, prow};
  pivot_apply_kernel<T><<<p.blocks, stream::kThreads, 0, st>>>(
      tab, n, p.head, p.nvec, f, r, s, do_pivot);
  return (int)cudaGetLastError();
}

}  // namespace

// (magic, shift) divide a flat index by W:
// row = (umulhi64(k, magic) + k) >> shift, exact for 0 <= k < 2^63
// (ops/pivot_kernel.py::row_divider computes them).
extern "C" int k1_pivot_update_f32(float* tab, int64_t R, int64_t W,
                                   uint64_t magic, int shift, const int64_t* r,
                                   const int64_t* s, const uint8_t* do_pivot,
                                   int clamp_rhs, float* col, float* prow,
                                   void* stream) {
  return launch<float>(tab, R, W, magic, shift, r, s, do_pivot, clamp_rhs,
                       col, prow, stream);
}

extern "C" int k1_pivot_update_f64(double* tab, int64_t R, int64_t W,
                                   uint64_t magic, int shift, const int64_t* r,
                                   const int64_t* s, const uint8_t* do_pivot,
                                   int clamp_rhs, double* col, double* prow,
                                   void* stream) {
  return launch<double>(tab, R, W, magic, shift, r, s, do_pivot, clamp_rhs,
                        col, prow, stream);
}
