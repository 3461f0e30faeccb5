// The float64 certifier of an all-<= batch: the KKT check of every
// instance's claimed optimal basis (rows A x <= b with b >= 0, x >= 0, no
// upper bounds), one warp an instance, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package certifies a batch on the host in
// numpy (simplex_tpu/models/certify.py::certify_sweep_le_f64, copied as it
// is into the port), which took most of a batched solve's time beside a
// device that had finished its loop.  This kernel computes what its plain
// PyTorch twin simplex_tpu_torch/ops/certify_kernel.py::certify_le_ref
// computes, step for step (sums may round differently where the compiler
// contracts a product into an add), and that is what certify_sweep_le_f64
// computes with ub=None, except that B x_B = b and B^T y = c_B are solved
// from one LU instead of two.  Per instance (basis[k], k < m, its claimed
// basic columns; slack i is column n + i):
//
//   claim     status == OPTIMAL and 0 <= basis[k] < n + m for every k
//   basis     B[:, k] = A[:, basis[k]] (structural) or e_(basis[k] - n)
//             (slack); c_B[k] = c_min[basis[k]] or 0; c_min = -c where the
//             instance maximizes, else c
//   LU        P B = L U with partial pivoting (the first largest |entry| of
//             the column); an exact zero pivot leaves the instance
//             uncertified
//   solves    B x_B = b (L, then U); B^T y = c_B (U^T, then L^T, then P^T)
//   tests     x_B, y finite; x_B >= -tol (1 + max|b|); y <= tol (1 +
//             max|c|) (the slacks' reduced costs); rc_j = c_min_j - sum_i
//             y_i A_ij >= -tol (1 + max|c|) on the nonbasic structural j
//   outputs   certified; x_j = max(x_B[k], 0) where basis[k] = j < n (the
//             last such k), 0 on the other columns; fun = c_min . x; x and
//             fun NaN where the instance is not certified
//
// A, b and c are read in their own types (A: the kernel's type; b and c:
// float32 or float64 each, by flag) and widened to float64 in registers.
//
// Bound: bytes.  The kernel must read A, b, c, the basis and the status
// once and write x, fun and the flag: 115 MB at 16384 x (30 x 50) in
// float32, 35 us at 3.35 TB/s.  Its float64 operations (an LU of about
// m^3 / 3 multiply-adds, four triangular solves, the m n reduced costs) are
// about 0.4 GFLOP there, 12 us at 34 TFLOP/s.  Each instance is a chain of
// small dependent steps, so what the design fights is latency:
//   * one warp an instance and several warps a block, so that an SM keeps
//     many independent instances in flight;
//   * the warp stages its instance's A in shared memory, in chunks of
//     columns of at most kStageBudget bytes (one chunk, read as a
//     contiguous tile in 16-byte loads, at 30 x 50 in float32), builds the
//     m x m float64 basis matrix from the staged chunk, and reads the chunk
//     again for the reduced costs;
//   * the basis matrix has an odd row pitch, so that lanes walking one
//     column meet no bank conflict; lane l owns rows l and l + 32 (m <=
//     kMaxRows = 64): the pivot search is a shuffle argmax, a row swap one
//     pass of the warp, and each lane eliminates in the rows it is given;
//   * the four substitutions keep their right-hand sides in registers and
//     broadcast each solved entry with one shuffle.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "certify_common.cuh"

namespace {

constexpr int kMaxWarps = 4;             // instances a block
constexpr int kStageBudget = 12288;      // bytes of A staged a warp
constexpr size_t kBlockSmem = 48 * 1024; // dynamic shared memory, no opt-in

// One warp's shared memory: the basis matrix (m rows of pitch_of(m)
// doubles), y, b then x_B (kMaxRows doubles each), the basis and the row
// permutation (kMaxRows ints each), then the staged chunk of A (m rows of
// nc entries).
__host__ __device__ inline size_t warp_bytes(int m, int nc, int elt) {
  return round16(sizeof(double) * m * pitch_of(m)) +
         2 * kMaxRows * (sizeof(double) + sizeof(int)) +
         round16(static_cast<size_t>(m) * nc * elt);
}

// Columns [j0, j0 + w) of the instance's A (m x n, row-major) into the
// stage (m rows of pitch nc).  A whole tile (w == n == nc) is one
// contiguous run, copied in 16-byte pieces where it is aligned.
template <typename TA>
__device__ __forceinline__ void stage_chunk(TA* stage, const TA* Ai, int m,
                                            int n, int j0, int w, int nc,
                                            int lane) {
  __syncwarp();  // the previous chunk is read no more
  if (w == n && nc == n) {
    const int total = m * n;
    const size_t bytes = sizeof(TA) * static_cast<size_t>(total);
    if ((reinterpret_cast<uintptr_t>(Ai) & 15) == 0 && bytes % 16 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(Ai);
      uint4* dst = reinterpret_cast<uint4*>(stage);
      const int pieces = static_cast<int>(bytes / 16);
#pragma unroll 4
      for (int e = lane; e < pieces; e += kWarp) dst[e] = __ldg(src + e);
    } else {
#pragma unroll 4
      for (int e = lane; e < total; e += kWarp) stage[e] = __ldg(Ai + e);
    }
  } else {
    for (int i = 0; i < m; ++i)
      for (int jj = lane; jj < w; jj += kWarp)
        stage[i * nc + jj] = __ldg(Ai + static_cast<int64_t>(i) * n + j0 + jj);
  }
  __syncwarp();
}

template <typename TA>
__global__ void __launch_bounds__(kWarp* kMaxWarps)
    certify_le_kernel(const TA* __restrict__ A, const void* __restrict__ b,
                      const void* __restrict__ c, int b_f64, int c_f64,
                      const uint8_t* __restrict__ maximize,
                      const int32_t* __restrict__ basis, int64_t ldb,
                      const int32_t* __restrict__ status, int64_t B, int m,
                      int n, int nc, double tol, uint8_t* __restrict__ cert,
                      double* __restrict__ x, double* __restrict__ fun) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t inst =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;  // the whole warp

  const int pitch = pitch_of(m);
  unsigned char* base = smem + warp * warp_bytes(m, nc, sizeof(TA));
  double* lu = reinterpret_cast<double*>(base);
  double* yv = reinterpret_cast<double*>(
      base + round16(sizeof(double) * m * pitch));
  double* bs = yv + kMaxRows;
  int* bas = reinterpret_cast<int*>(bs + kMaxRows);
  int* perm = bas + kMaxRows;
  TA* stage = reinterpret_cast<TA*>(perm + kMaxRows);

  const TA* Ai = A + inst * static_cast<int64_t>(m) * n;
  double* xrow = x + inst * n;
  uint8_t* cert_i = cert + inst;
  double* fun_i = fun + inst;

  // ---- the claim: optimal, and every basic column in range ------------ //
  bool in_range = true;
  for (int k = lane; k < m; k += kWarp) {
    const int v = basis[inst * ldb + k];
    bas[k] = v;
    in_range &= v >= 0 && v < n + m;
  }
  __syncwarp();
  if (!__all_sync(kFull, in_range) || status[inst] != kOptimal) {
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }

  // ---- scales, P b, c_B ------------------------------------------------ //
  const double sgn = maximize[inst] ? -1.0 : 1.0;
  double bmax = 0.0;
  for (int i = lane; i < m; i += kWarp) {
    const double v = load_real(b, inst * m + i, b_f64);
    bs[i] = v;
    perm[i] = i;
    bmax = fmax(bmax, fabs(v));
  }
  const double scale = 1.0 + warp_max(bmax);
  double cmax = 0.0;
  for (int j = lane; j < n; j += kWarp)
    cmax = fmax(cmax, fabs(load_real(c, inst * n + j, c_f64)));
  const double c_scale = 1.0 + warp_max(cmax);
  // Lane l's rows (and basis positions) are i0 = l and i1 = l + 32; the
  // two right-hand sides of each solve are named scalars, so that they stay
  // in registers.
  const int i0 = lane, i1 = lane + kWarp;
  double cb0 = 0.0, cb1 = 0.0;
  if (i0 < m && bas[i0] < n)
    cb0 = sgn * load_real(c, inst * n + bas[i0], c_f64);
  if (i1 < m && bas[i1] < n)
    cb1 = sgn * load_real(c, inst * n + bas[i1], c_f64);

  // ---- the basis matrix: slack columns, then A's columns by chunk ------ //
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = lane + r * kWarp;
    if (k < m && bas[k] >= n) {
      const int u = bas[k] - n;
      for (int i = 0; i < m; ++i) lu[i * pitch + k] = i == u ? 1.0 : 0.0;
    }
  }
  const int nchunks = (n + nc - 1) / nc;
  for (int q = 0; q < nchunks; ++q) {
    const int j0 = q * nc, w = min(nc, n - j0);
    stage_chunk(stage, Ai, m, n, j0, w, nc, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = lane + r * kWarp;
      if (k < m) {
        const int v = bas[k];
        if (v >= j0 && v < j0 + w)
          for (int i = 0; i < m; ++i)
            lu[i * pitch + k] = static_cast<double>(stage[i * nc + v - j0]);
      }
    }
  }
  __syncwarp();
  int staged = (nchunks - 1) * nc;  // the chunk left in the stage

  // ---- P B = L U -------------------------------------------------------- //
  bool singular = false;
  for (int k = 0; k < m; ++k) {
    // The first largest |B[i][k]|, i >= k; a NaN wins (and fails the
    // instance at the finiteness test).
    double best = -1.0;
    int arg = m;
    for (int i = lane; i < m; i += kWarp) {
      if (i < k) continue;
      double a = fabs(lu[i * pitch + k]);
      if (a != a) a = INFINITY;
      if (a > best) {
        best = a;
        arg = i;
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(kFull, best, off);
      const int oa = __shfl_xor_sync(kFull, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const int p = __shfl_sync(kFull, arg, 0);
    if (p != k) {
      for (int j = lane; j < m; j += kWarp) {
        const double t = lu[k * pitch + j];
        lu[k * pitch + j] = lu[p * pitch + j];
        lu[p * pitch + j] = t;
      }
      if (lane == 0) {
        const double tb = bs[k];
        bs[k] = bs[p];
        bs[p] = tb;
        const int tp = perm[k];
        perm[k] = perm[p];
        perm[p] = tp;
      }
      __syncwarp();
    }
    const double piv = lu[k * pitch + k];
    if (piv == 0.0) {  // the same value in every lane
      singular = true;
      break;
    }
    const double* urow = lu + k * pitch;
    for (int i = k + 1 + lane; i < m; i += kWarp) {
      double* row = lu + i * pitch;
      const double l = row[k] / piv;
      row[k] = l;
#pragma unroll 4
      for (int j = k + 1; j < m; ++j) row[j] = fma(-l, urow[j], row[j]);
    }
    __syncwarp();
  }
  if (singular) {
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }

  // ---- B x_B = b: L z = P b, U x_B = z ---------------------------------- //
  double z0 = i0 < m ? bs[i0] : 0.0, z1 = i1 < m ? bs[i1] : 0.0;
  for (int k = 0; k < m; ++k) {
    const double zk = __shfl_sync(kFull, k < kWarp ? z0 : z1, k & (kWarp - 1));
    if (i0 > k && i0 < m) z0 = fma(-lu[i0 * pitch + k], zk, z0);
    if (i1 > k && i1 < m) z1 = fma(-lu[i1 * pitch + k], zk, z1);
  }
  for (int k = m - 1; k >= 0; --k) {
    const double xk =
        __shfl_sync(kFull, k < kWarp ? z0 : z1, k & (kWarp - 1)) /
        lu[k * pitch + k];
    if (k == i0) z0 = xk;
    if (k == i1) z1 = xk;
    if (i0 < k) z0 = fma(-lu[i0 * pitch + k], xk, z0);
    if (i1 < k) z1 = fma(-lu[i1 * pitch + k], xk, z1);
  }

  // ---- B^T y = c_B: U^T w = c_B, L^T v = w, y = P^T v (in cb0, cb1) -- //
  for (int k = 0; k < m; ++k) {
    const double wk =
        __shfl_sync(kFull, k < kWarp ? cb0 : cb1, k & (kWarp - 1)) /
        lu[k * pitch + k];
    if (k == i0) cb0 = wk;
    if (k == i1) cb1 = wk;
    if (i0 > k && i0 < m) cb0 = fma(-lu[k * pitch + i0], wk, cb0);
    if (i1 > k && i1 < m) cb1 = fma(-lu[k * pitch + i1], wk, cb1);
  }
  for (int k = m - 1; k >= 0; --k) {
    const double vk =
        __shfl_sync(kFull, k < kWarp ? cb0 : cb1, k & (kWarp - 1));
    if (i0 < k) cb0 = fma(-lu[k * pitch + i0], vk, cb0);
    if (i1 < k) cb1 = fma(-lu[k * pitch + i1], vk, cb1);
  }

  // ---- primal and slack tests; y and x_B to shared memory -------------- //
  bool good = true;
  if (i0 < m) {
    good &= isfinite(z0) && isfinite(cb0) && z0 >= -tol * scale &&
            cb0 <= tol * c_scale;
    yv[perm[i0]] = cb0;
    bs[i0] = z0;  // x_B, by basis position
  }
  if (i1 < m) {
    good &= isfinite(z1) && isfinite(cb1) && z1 >= -tol * scale &&
            cb1 <= tol * c_scale;
    yv[perm[i1]] = cb1;
    bs[i1] = z1;
  }
  if (!__all_sync(kFull, good)) {
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }
  __syncwarp();

  // ---- reduced costs, x and c_min . x, the staged chunk first ---------- //
  bool dual = true;
  double fsum = 0.0;
  for (int q = nchunks - 1; q >= 0; --q) {
    const int j0 = q * nc, w_cols = min(nc, n - j0);
    if (j0 != staged) {
      stage_chunk(stage, Ai, m, n, j0, w_cols, nc, lane);
      staged = j0;
    }
    for (int jj = lane; jj < w_cols; jj += kWarp) {
      const int j = j0 + jj;
      double acc = 0.0;
#pragma unroll 4
      for (int i = 0; i < m; ++i)
        acc = fma(yv[i], static_cast<double>(stage[i * nc + jj]), acc);
      const double cj = sgn * load_real(c, inst * n + j, c_f64);
      int pos = -1;
      for (int k = 0; k < m; ++k)
        if (bas[k] == j) pos = k;
      double xj = 0.0;
      if (pos >= 0)
        xj = fmax(bs[pos], 0.0);
      else
        dual &= cj - acc >= -tol * c_scale;
      xrow[j] = xj;
      fsum = fma(cj, xj, fsum);
    }
  }
  fsum = warp_sum(fsum);
  if (!__all_sync(kFull, dual)) {
    __syncwarp();  // the x just written comes before the NaN
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }
  if (lane == 0) {
    *cert_i = 1;
    *fun_i = fsum;
  }
}

template <typename TA>
int launch(const TA* A, const void* b, const void* c, int b_f64, int c_f64,
           const uint8_t* maximize, const int32_t* basis, int64_t ldb,
           const int32_t* status, int64_t B, int64_t m, int64_t n, double tol,
           uint8_t* cert, double* x, double* fun, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || m < 1 || m > kMaxRows || n < 1 || ldb < m || n > INT32_MAX / 2)
    return cudaErrorInvalidValue;
  const int64_t cols = kStageBudget / (m * static_cast<int64_t>(sizeof(TA)));
  const int nc = static_cast<int>(std::max<int64_t>(1, std::min(n, cols)));
  const size_t per_warp =
      warp_bytes(static_cast<int>(m), nc, static_cast<int>(sizeof(TA)));
  const int wpb = static_cast<int>(
      std::min<size_t>(kMaxWarps, kBlockSmem / per_warp));
  if (wpb < 1) return cudaErrorInvalidValue;
  const int64_t blocks = (B + wpb - 1) / wpb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  certify_le_kernel<TA><<<static_cast<unsigned>(blocks), wpb * kWarp,
                          wpb * per_warp, static_cast<cudaStream_t>(stream)>>>(
      A, b, c, b_f64, c_f64, maximize, basis, ldb, status, B,
      static_cast<int>(m), static_cast<int>(n), nc, tol, cert, x, fun);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int certify_le_f32(const float* A, const void* b, const void* c,
                              int b_f64, int c_f64, const uint8_t* maximize,
                              const int32_t* basis, int64_t ldb,
                              const int32_t* status, int64_t B, int64_t m,
                              int64_t n, double tol, uint8_t* certified,
                              double* x, double* fun, void* stream) {
  return launch<float>(A, b, c, b_f64, c_f64, maximize, basis, ldb, status, B,
                       m, n, tol, certified, x, fun, stream);
}

extern "C" int certify_le_f64(const double* A, const void* b, const void* c,
                              int b_f64, int c_f64, const uint8_t* maximize,
                              const int32_t* basis, int64_t ldb,
                              const int32_t* status, int64_t B, int64_t m,
                              int64_t n, double tol, uint8_t* certified,
                              double* x, double* fun, void* stream) {
  return launch<double>(A, b, c, b_f64, c_f64, maximize, basis, ldb, status,
                        B, m, n, tol, certified, x, fun, stream);
}
