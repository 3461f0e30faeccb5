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
// Bound: the pass is memory-bound.  Each pivot must read and write every
// element of T once: 2 * R * W * sizeof(T) bytes, held against the card's
// measured copy bandwidth (PERF.md).  Design:
//   * pivot_gather_kernel copies the pivot column and the normalised pivot
//     row into side buffers (R + W elements) BEFORE the update, so the
//     in-place update never reads T[:, s] or T[r, :] from the array it is
//     overwriting;
//   * pivot_apply_kernel makes one read and one write of T on a 2-D grid:
//     each thread owns VEC consecutive columns (one 16-byte vector load and
//     store where W % VEC == 0 and the base is 16-byte aligned) of
//     ROWS_PER_BLOCK rows; the side buffers stay in L1/L2;
//   * the update is one fused multiply-add per element (one rounding),
//     as XLA contracts it inside the reference's solve loop; the plain
//     PyTorch twin rounds once too (float32 via float64);
//   * ragged edges are masked, so R and W need no alignment.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

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

template <typename T, int VEC>
__global__ void pivot_apply_kernel(T* __restrict__ tab, int64_t R, int64_t W,
                                   const int64_t* __restrict__ r_p,
                                   const int64_t* __restrict__ s_p,
                                   const uint8_t* __restrict__ do_p,
                                   const T* __restrict__ col,
                                   const T* __restrict__ prow) {
  if (!*do_p) return;
  const int64_t r = *r_p;
  const int64_t s = *s_p;
  const int64_t j0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (j0 >= W) return;  // VEC divides W whenever VEC > 1
  const int64_t i0 = (int64_t)blockIdx.y * kRowsPerBlock;
  const int64_t i1 = i0 + kRowsPerBlock < R ? i0 + kRowsPerBlock : R;

  Vec<T, VEC> p = *reinterpret_cast<const Vec<T, VEC>*>(prow + j0);
  for (int64_t i = i0; i < i1; ++i) {
    Vec<T, VEC>* cell = reinterpret_cast<Vec<T, VEC>*>(tab + i * W + j0);
    Vec<T, VEC> t = *cell;
    const T c = col[i];
    const bool is_r = (i == r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      T out = is_r ? p.v[k] : fnms(c, p.v[k], t.v[k]);
      if (j0 + k == s) out = is_r ? T(1) : T(0);
      t.v[k] = out;
    }
    *cell = t;
  }
}

template <typename T, int VEC>
cudaError_t launch(T* tab, int64_t R, int64_t W, const int64_t* r,
                   const int64_t* s, const uint8_t* do_pivot, int clamp_rhs,
                   T* col, T* prow, cudaStream_t stream) {
  const int64_t n_side = R + W;
  int64_t gather_blocks = (n_side + kThreads - 1) / kThreads;
  if (gather_blocks > 4096) gather_blocks = 4096;
  pivot_gather_kernel<T><<<(unsigned)gather_blocks, kThreads, 0, stream>>>(
      tab, R, W, r, s, do_pivot, clamp_rhs, col, prow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t cols_per_block = (int64_t)kThreads * VEC;
  dim3 grid((unsigned)((W + cols_per_block - 1) / cols_per_block),
            (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock));
  pivot_apply_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      tab, R, W, r, s, do_pivot, col, prow);
  return cudaGetLastError();
}

template <typename T, int VEC_MAX>
int dispatch(T* tab, int64_t R, int64_t W, const int64_t* r, const int64_t* s,
             const uint8_t* do_pivot, int clamp_rhs, T* col, T* prow,
             int vectorized, void* stream) {
  if (R <= 0 || W <= 0 || (R + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err =
      vectorized ? launch<T, VEC_MAX>(tab, R, W, r, s, do_pivot, clamp_rhs,
                                      col, prow, st)
                 : launch<T, 1>(tab, R, W, r, s, do_pivot, clamp_rhs, col,
                                prow, st);
  return (int)err;
}

}  // namespace

// `vectorized` may be set only when W % (16 / sizeof(T)) == 0 and T, col and
// prow are 16-byte aligned (the Python wrapper checks).
extern "C" int k1_pivot_update_f32(float* tab, int64_t R, int64_t W,
                                   const int64_t* r, const int64_t* s,
                                   const uint8_t* do_pivot, int clamp_rhs,
                                   float* col, float* prow, int vectorized,
                                   void* stream) {
  return dispatch<float, 4>(tab, R, W, r, s, do_pivot, clamp_rhs, col, prow,
                            vectorized, stream);
}

extern "C" int k1_pivot_update_f64(double* tab, int64_t R, int64_t W,
                                   const int64_t* r, const int64_t* s,
                                   const uint8_t* do_pivot, int clamp_rhs,
                                   double* col, double* prow, int vectorized,
                                   void* stream) {
  return dispatch<double, 2>(tab, R, W, r, s, do_pivot, clamp_rhs, col, prow,
                             vectorized, stream);
}
