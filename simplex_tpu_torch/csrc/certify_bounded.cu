// The float64 certifier of an all-<= batch, with or without upper bounds:
// the KKT check of every instance's claimed optimal basis (rows A x <= b
// with b >= 0, 0 <= x <= ub), one warp an instance, for Hopper (sm_90a).
// A batch without bounds comes as one +inf ub row and no at_upper: the
// at-upper set is then empty, b_eff = b, and the check is that of the
// unbounded KKT system, term for term.
//
// Replaces no TPU kernel: the JAX package certifies a batch on the host in
// numpy (simplex_tpu/models/certify.py::certify_sweep_le_f64, with ub and
// at_upper where the batch has bounds, copied as it is into the port),
// which took most of a batched solve's time beside a card with nothing to
// do.  This kernel computes what its plain PyTorch twin
// simplex_tpu_torch/ops/certify_kernel.py::certify_le_ref computes, step
// for step (sums may round differently where the compiler contracts a
// product into an add), and that is what certify_sweep_le_f64 computes,
// except that B x_B = b_eff and B^T y = c_B are solved from one LU instead
// of two.  Per instance (basis[k], k < m, its claimed basic columns; slack
// i is column n + i; c_min = -c where the instance maximizes, else c):
//
//   claim     status == OPTIMAL and 0 <= basis[k] < n + m for every k
//   basis     B[:, k] = A[:, basis[k]] (structural) or e_(basis[k] - n)
//             (slack); c_B[k] = c_min[basis[k]] or 0
//   LU        P B = L U with partial pivoting (the first largest |entry| of
//             the column); an exact zero pivot leaves the instance
//             uncertified
//   duals     B^T y = c_B (U^T, then L^T, then P^T); y finite and y <= tol
//             (1 + max|c|) (the slacks' reduced costs)
//   at upper  up_j = at_upper[j], ub_j finite and j not basic; u = ub on
//             them, 0 elsewhere
//   columns   rc_j = c_min_j - sum_i y_i A_ij on the nonbasic structural j:
//             rc_j <= tol (1 + max|c|) where up_j, else rc_j >= -tol (1 +
//             max|c|) unless ub_j == 0 (fixed); b_eff = b - A u
//   primal    B x_B = b_eff (L, then U); x_B finite, x_B >= -tol (1 +
//             max|b|), and x_B <= ub_B + tol (1 + max|b|) where the basic
//             column is structural with a finite bound (the scale is
//             max|b|, not max|b_eff|, as on the host)
//   outputs   certified; x_j = max(x_B[k], 0) where basis[k] = j < n (the
//             last such k), ub_j where up_j, 0 elsewhere; fun = c_min . x;
//             x and fun NaN where the instance is not certified
//
// A is read in the kernel's type, b, c and ub in float32 or float64 each,
// by flag, and everything is widened to float64 in registers.  ub is one
// row for the batch (ld_ub 0) or one an instance (ld_ub n); at_upper may
// be null (no column at its upper bound).
//
// Bound: bytes.  The kernel must read A, b, c, ub, at_upper, the basis and
// the status once and write x, fun and the flag: about 1.13 GB at 16384 x
// (30 x 500) in float32 (A alone 983 MB), 0.34 ms at 3.35 TB/s.  Its
// float64 work (an LU of about m^3 / 3 multiply-adds, four triangular
// solves, 2 m n multiply-adds for the reduced costs and b_eff) is about
// 1.3 GFLOP there, 0.04 ms at 34 TFLOP/s (at 16384 x (30 x 50): 115 MB,
// 0.03 ms, and 0.4 GFLOP, 0.01 ms).  So the design is about keeping
// A streaming while each warp walks its instance's chain of small
// dependent steps:
//   * A is read once.  Only x_B needs b_eff and y needs only B, so the
//     basis matrix is gathered straight from A (m^2 scattered entries),
//     factored, and y solved before A streams; each column then gives its
//     reduced cost and, where it sits at its upper bound, its ub_j A_:j
//     into b_eff; x_B comes last, from the same LU;
//   * A streams through a ring of two slots in the warp's shared memory,
//     chunks of whole rows' column ranges of about kChunkBytes, by
//     cp.async (16-byte pieces where A's rows are 16-byte multiples, else
//     one element a piece).  The first two chunks are issued before the
//     gather, so they land while the warp factors B; each later chunk is
//     issued as soon as its slot has been read;
//   * in a slot, lane l takes columns l, l + 32, ... for the reduced costs
//     (consecutive lanes, consecutive words) and, where some column of the
//     chunk is at its upper bound, rows l and l + 32 for b_eff in 16-byte
//     vectors: the slot's row pitch is 16 bytes past a multiple of 128, so
//     the eight lanes of a quarter-warp read eight different bank groups;
//   * the basis matrix has an odd row pitch (lanes walking a column meet no
//     bank conflict); the pivot search is a shuffle argmax, each lane
//     eliminates in its two rows, the substitutions keep their right-hand
//     sides in registers and broadcast each solved entry with a shuffle;
//   * a warp's shared memory is about 26 KB at 30 x 500 in float32 (and at
//     30 x 50, where A is one chunk and the second slot stays unused): four
//     warps a block by opt-in dynamic shared memory, eight warps an SM.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRows = 64;       // two rows a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOptimal = 0;
constexpr int kMaxWarps = 4;       // instances a block
constexpr int kChunkBytes = 8192;  // bytes of A a ring slot holds, about
constexpr int kSlots = 2;          // one slot read while the next lands

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

// A slot's row pitch in elements: at least nc, a whole number of 16-byte
// vectors, and 16 bytes past a multiple of 128.
__host__ __device__ inline int stage_pitch(int nc, int elt) {
  const int v = 16 / elt, period = 128 / elt;
  const int p = (nc + v - 1) / v * v;
  return p + (v - p % period + period) % period;
}

// One warp's shared memory, byte offsets: the basis matrix (m rows of
// pitch_of(m) doubles), y and b_eff (kMaxRows doubles each), the basis and
// the row permutation (kMaxRows ints each), the chunk's u (nc doubles) and
// basic flags (nc bytes), then the ring's slots (m rows of the stage
// pitch each).
struct Layout {
  size_t lu, yv, be, bas, perm, u, isb, ring, slot, total;
};

__host__ __device__ inline Layout layout(int m, int nc, int elt) {
  Layout L;
  size_t o = 0;
  L.lu = o;
  o += round16(sizeof(double) * m * pitch_of(m));
  L.yv = o;
  o += sizeof(double) * kMaxRows;
  L.be = o;
  o += sizeof(double) * kMaxRows;
  L.bas = o;
  o += sizeof(int) * kMaxRows;
  L.perm = o;
  o += sizeof(int) * kMaxRows;
  L.u = o;
  o += round16(sizeof(double) * nc);
  L.isb = o;
  o += round16(nc);
  L.ring = o;
  L.slot = static_cast<size_t>(m) * stage_pitch(nc, elt) * elt;
  o += kSlots * L.slot;
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Issue the copy of columns [j0, j0 + w) of the instance's A (m x n,
// row-major) into a slot (m rows of pitch sp), as one cp.async group of
// every lane.  `vec`: A's rows start on 16-byte boundaries (j0 is a whole
// number of vectors), so whole vectors go as 16-byte pieces.
template <typename TA>
__device__ __forceinline__ void issue_chunk(TA* slot, const TA* Ai, int m,
                                            int n, int j0, int w, int sp,
                                            bool vec, int lane) {
  constexpr int V = 16 / sizeof(TA);
  const int nv = vec ? w / V : 0;  // whole vectors a row
  const int rest = w - nv * V;     // elements a row after them
  for (int e = lane; e < m * nv; e += kWarp) {
    const int i = e / nv, v = (e - i * nv) * V;
    cp_async<16>(slot + i * sp + v, Ai + static_cast<int64_t>(i) * n + j0 + v);
  }
  for (int e = lane; e < m * rest; e += kWarp) {
    const int i = e / rest, jj = nv * V + (e - i * rest);
    cp_async<sizeof(TA)>(slot + i * sp + jj,
                         Ai + static_cast<int64_t>(i) * n + j0 + jj);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename TA>
__global__ void __launch_bounds__(kWarp* kMaxWarps) certify_bounded_kernel(
    const TA* __restrict__ A, const void* __restrict__ b,
    const void* __restrict__ c, const void* __restrict__ ub, int b_f64,
    int c_f64, int ub_f64, int64_t ld_ub, const uint8_t* __restrict__ at_upper,
    int64_t ld_up, const uint8_t* __restrict__ maximize,
    const int32_t* __restrict__ basis, int64_t ldb,
    const int32_t* __restrict__ status, int64_t B, int m, int n, int nc,
    double tol, uint8_t* __restrict__ cert, double* __restrict__ x,
    double* __restrict__ fun) {
  constexpr int V = 16 / sizeof(TA);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t inst =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;  // the whole warp

  const int pitch = pitch_of(m);
  const int sp = stage_pitch(nc, sizeof(TA));
  const Layout L = layout(m, nc, sizeof(TA));
  unsigned char* base = smem + warp * L.total;
  double* lu = reinterpret_cast<double*>(base + L.lu);
  double* yv = reinterpret_cast<double*>(base + L.yv);
  double* be = reinterpret_cast<double*>(base + L.be);
  int* bas = reinterpret_cast<int*>(base + L.bas);
  int* perm = reinterpret_cast<int*>(base + L.perm);
  double* uch = reinterpret_cast<double*>(base + L.u);
  uint8_t* isb = base + L.isb;
  TA* ring = reinterpret_cast<TA*>(base + L.ring);
  const int slot_elems = static_cast<int>(L.slot / sizeof(TA));

  const TA* Ai = A + inst * static_cast<int64_t>(m) * n;
  const int64_t ub0 = inst * ld_ub;
  const uint8_t* up_i = at_upper ? at_upper + inst * ld_up : nullptr;
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

  // ---- A starts streaming: the ring's first chunks -------------------- //
  const bool vec = (reinterpret_cast<uintptr_t>(A) & 15) == 0 &&
                   (static_cast<int64_t>(n) * sizeof(TA)) % 16 == 0;
  const int nchunks = (n + nc - 1) / nc;
  for (int q = 0; q < kSlots && q < nchunks; ++q)
    issue_chunk(ring + q * slot_elems, Ai, m, n, q * nc, min(nc, n - q * nc),
                sp, vec, lane);

  // ---- scales, b, c_B ------------------------------------------------- //
  const double sgn = maximize[inst] ? -1.0 : 1.0;
  double bmax = 0.0;
  for (int i = lane; i < m; i += kWarp) {
    const double v = load_real(b, inst * m + i, b_f64);
    be[i] = v;
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

  // ---- the basis matrix, gathered from A ------------------------------ //
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = lane + r * kWarp;
    if (k < m) {
      const int v = bas[k];
      if (v >= n) {
        const int u = v - n;
        for (int i = 0; i < m; ++i) lu[i * pitch + k] = i == u ? 1.0 : 0.0;
      } else {
#pragma unroll 4
        for (int i = 0; i < m; ++i)
          lu[i * pitch + k] =
              static_cast<double>(__ldg(Ai + static_cast<int64_t>(i) * n + v));
      }
    }
  }
  __syncwarp();

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
    cp_async_wait<0>();  // no copy may land after the warp has gone
    reject(xrow, n, lane, cert_i, fun_i);
    return;
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
  bool good = true;
  if (i0 < m) {
    good &= isfinite(cb0) && cb0 <= tol * c_scale;
    yv[perm[i0]] = cb0;
  }
  if (i1 < m) {
    good &= isfinite(cb1) && cb1 <= tol * c_scale;
    yv[perm[i1]] = cb1;
  }
  if (!__all_sync(kFull, good)) {
    cp_async_wait<0>();
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }
  __syncwarp();

  // ---- A streams: reduced costs, at-upper columns, b_eff -------------- //
  const double lo = -tol * c_scale, hi = tol * c_scale;
  bool dual = true;
  double fsum = 0.0, acc0 = 0.0, acc1 = 0.0;  // c_min . x; (A u) rows
  for (int q = 0; q < nchunks; ++q) {
    const int j0 = q * nc, w = min(nc, n - j0);
    const TA* st = ring + (q % kSlots) * slot_elems;
    for (int jj = lane; jj < w; jj += kWarp) isb[jj] = 0;
    __syncwarp();
    for (int k = lane; k < m; k += kWarp) {
      const int v = bas[k] - j0;
      if (v >= 0 && v < w) isb[v] = 1;
    }
    if (q + 1 < nchunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    bool any_up = false;
    for (int jj = lane; jj < w; jj += kWarp) {
      double u = 0.0;
      if (!isb[jj]) {
        const int j = j0 + jj;
        double dot = 0.0;
#pragma unroll 4
        for (int i = 0; i < m; ++i)
          dot = fma(yv[i], static_cast<double>(st[i * sp + jj]), dot);
        const double cj = sgn * load_real(c, inst * n + j, c_f64);
        const double uj = load_real(ub, ub0 + j, ub_f64);
        const double rc = cj - dot;
        if (up_i != nullptr && up_i[j] && isfinite(uj)) {
          dual &= rc <= hi;
          u = uj;
          any_up = true;
        } else if (uj != 0.0) {
          dual &= rc >= lo;
        }
        xrow[j] = u;
        fsum = fma(cj, u, fsum);
      }
      uch[jj] = u;
    }
    __syncwarp();
    if (__any_sync(kFull, any_up)) {
      const int wv = w / V * V;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + r * kWarp;
        if (i < m) {
          const TA* row = st + i * sp;
          double s = r == 0 ? acc0 : acc1;
          for (int jj = 0; jj < wv; jj += V) {
            const uint4 raw = *reinterpret_cast<const uint4*>(row + jj);
            TA a[V];
            memcpy(a, &raw, sizeof(raw));
#pragma unroll
            for (int t = 0; t < V; ++t)
              s = fma(static_cast<double>(a[t]), uch[jj + t], s);
          }
          for (int jj = wv; jj < w; ++jj)
            s = fma(static_cast<double>(row[jj]), uch[jj], s);
          if (r == 0)
            acc0 = s;
          else
            acc1 = s;
        }
      }
    }
    __syncwarp();  // the slot, isb and u are read no more
    if (q + kSlots < nchunks)
      issue_chunk(ring + (q % kSlots) * slot_elems, Ai, m, n,
                  (q + kSlots) * nc, min(nc, n - (q + kSlots) * nc), sp, vec,
                  lane);
  }
  if (!__all_sync(kFull, dual)) {
    __syncwarp();  // the x just written comes before the NaN
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }

  // ---- B x_B = b_eff: L z = P b_eff, U x_B = z -------------------------- //
  if (i0 < m) be[i0] -= acc0;
  if (i1 < m) be[i1] -= acc1;
  __syncwarp();
  double z0 = i0 < m ? be[perm[i0]] : 0.0, z1 = i1 < m ? be[perm[i1]] : 0.0;
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

  // ---- primal tests; then x at the basic columns ---------------------- //
  good = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = lane + r * kWarp;
    const double zk = r == 0 ? z0 : z1;
    if (k < m) {
      good &= isfinite(zk) && zk >= -tol * scale;
      if (bas[k] < n) {
        const double uk = load_real(ub, ub0 + bas[k], ub_f64);
        if (isfinite(uk)) good &= zk <= uk + tol * scale;
      }
    }
  }
  if (!__all_sync(kFull, good)) {
    __syncwarp();
    reject(xrow, n, lane, cert_i, fun_i);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = lane + r * kWarp;
    if (k < m && bas[k] < n) {
      const int j = bas[k];
      bool last = true;
      for (int kk = k + 1; kk < m; ++kk) last &= bas[kk] != j;
      if (last) {
        const double xj = fmax(r == 0 ? z0 : z1, 0.0);
        xrow[j] = xj;
        fsum = fma(sgn * load_real(c, inst * n + j, c_f64), xj, fsum);
      }
    }
  }
  fsum = warp_sum(fsum);
  if (lane == 0) {
    *cert_i = 1;
    *fun_i = fsum;
  }
}

// Dynamic shared memory above 48 KB a block is an opt-in, once a kernel
// and device.
template <typename K>
cudaError_t allow_shared_memory(K kernel, int* optin) {
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && granted[dev]) {
    *optin = granted[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *optin);
  if (e == cudaSuccess && dev >= 0 && dev < 64) granted[dev] = *optin;
  return e;
}

template <typename TA>
int launch(const TA* A, const void* b, const void* c, const void* ub,
           int b_f64, int c_f64, int ub_f64, int64_t ld_ub,
           const uint8_t* at_upper, int64_t ld_up, const uint8_t* maximize,
           const int32_t* basis, int64_t ldb, const int32_t* status,
           int64_t B, int64_t m, int64_t n, double tol, uint8_t* cert,
           double* x, double* fun, void* stream) {
  if (B == 0) return cudaSuccess;
  if (B < 0 || m < 1 || m > kMaxRows || n < 1 || ldb < m ||
      n > INT32_MAX / 2 || (ld_ub != 0 && ld_ub < n) ||
      (at_upper != nullptr && ld_up < n))
    return cudaErrorInvalidValue;
  constexpr int64_t V = 16 / sizeof(TA);
  const int64_t fit = kChunkBytes / (m * static_cast<int64_t>(sizeof(TA)));
  const int nc = static_cast<int>(
      std::min((n + V - 1) / V * V, std::max(V, fit / V * V)));
  const size_t per_warp = layout(static_cast<int>(m), nc, sizeof(TA)).total;
  int optin = 0;
  cudaError_t e = allow_shared_memory(certify_bounded_kernel<TA>, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wpb = static_cast<int>(std::min<size_t>(
      kMaxWarps, static_cast<size_t>(optin) / per_warp));
  if (wpb < 1) return cudaErrorInvalidValue;
  const int64_t blocks = (B + wpb - 1) / wpb;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  certify_bounded_kernel<TA><<<static_cast<unsigned>(blocks), wpb * kWarp,
                               wpb * per_warp,
                               static_cast<cudaStream_t>(stream)>>>(
      A, b, c, ub, b_f64, c_f64, ub_f64, ld_ub, at_upper, ld_up, maximize,
      basis, ldb, status, B, static_cast<int>(m), static_cast<int>(n), nc,
      tol, cert, x, fun);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int certify_le_bounded_f32(
    const float* A, const void* b, const void* c, const void* ub, int b_f64,
    int c_f64, int ub_f64, int64_t ld_ub, const uint8_t* at_upper,
    int64_t ld_up, const uint8_t* maximize, const int32_t* basis, int64_t ldb,
    const int32_t* status, int64_t B, int64_t m, int64_t n, double tol,
    uint8_t* certified, double* x, double* fun, void* stream) {
  return launch<float>(A, b, c, ub, b_f64, c_f64, ub_f64, ld_ub, at_upper,
                       ld_up, maximize, basis, ldb, status, B, m, n, tol,
                       certified, x, fun, stream);
}

extern "C" int certify_le_bounded_f64(
    const double* A, const void* b, const void* c, const void* ub, int b_f64,
    int c_f64, int ub_f64, int64_t ld_ub, const uint8_t* at_upper,
    int64_t ld_up, const uint8_t* maximize, const int32_t* basis, int64_t ldb,
    const int32_t* status, int64_t B, int64_t m, int64_t n, double tol,
    uint8_t* certified, double* x, double* fun, void* stream) {
  return launch<double>(A, b, c, ub, b_f64, c_f64, ub_f64, ld_ub, at_upper,
                        ld_up, maximize, basis, ldb, status, B, m, n, tol,
                        certified, x, fun, stream);
}
