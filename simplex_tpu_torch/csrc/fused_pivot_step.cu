// K2: one fused simplex step (pricing + ratio test + rank-1 pivot + Devex)
// for every instance of a batch of (M, N) tableaus, in place, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel simplex_tpu/ops/pallas_batched.py::fused_pivot_step
// (body _make_kernel) and computes what its plain PyTorch twin
// simplex_tpu_torch/ops/batched_kernel.py::fused_pivot_step_ref computes, bit
// for bit.  Per instance b (objective row M-1, RHS column N-1):
//
//   pricing   rc = mask ? T[M-1, :] : inf; eligible = rc < -tol;
//             s = Bland ? first eligible : (Devex ? first argmax rc^2 / w
//                                                 : first argmin rc)
//   ratio     rows i < M-1 with col_i > tol: ratio = max(rhs_i, 0) / col_i;
//             Harris: the largest col_i among rows whose ratio is within the
//             tol-relaxed minimum; Bland: the smallest basis index among rows
//             within 64 eps of the minimum ratio
//   update    prow = T[r, :] / T[r, s] (RHS lane clamped to >= 0);
//             T <- T - T[:, s] (outer) prow; T[r, :] <- prow; T[:, s] <- e_r
//   Devex     w <- max(w, prow^2 w_s); w[leaving] = max(w_s, 1); w[s] = 1;
//             all ones if any lane (the padded RHS lane too) exceeds 1e8
//   basis     basis[r] = s
//
// An instance that is not RUNNING, optimal or unbounded is left
// bit-identical.  Ties go to the lowest index (the reference's _first_where
// min-reductions); s is clipped to [0, N-1] and r to [0, M-2], so an
// instance with no eligible column or no bounding row never reads out of
// bounds.  Rounding follows the twin: every operation is an explicit
// round-to-nearest intrinsic (no contraction by the compiler); in float32
// the Harris numerator rhs_c + tol (1 + |rhs|) and the update t - c p are
// one fused multiply-add each, as XLA contracts them in the reference's
// compiled step; in float64 every operation rounds on its own.
//
// Bound: bytes.  A pivoting instance must read and write its whole tile
// once, any other only what decides that it stops (its objective row, the
// entering column and the RHS column), plus the small state
// (chip_smoke.py::_step_bytes and _state_bytes count it from a step's
// outcome); a few operations an element, far under the float32 rate.
// Design: K3's, on the batched-step skeleton of batched_step_common.cuh,
// without bounds (see fused_pivot_step_bounded.cu for the why):
//   * one block of 128 threads an instance; its first round trip loads the
//     instance's status, phase and Bland flag and its objective row
//     (load_head); a RUNNING instance whose tile fits kStageMaxBytes
//     (64 KB) is then staged in shared memory by one TMA bulk copy
//     (cp.async where its base or size is not a 16-byte multiple) while
//     the block loads the column masks, the Devex weights and warp 0's rows
//     of the basis;
//   * pricing is one block reduction of (score, first index) and of the
//     first eligible lane; the ratio test is warp 0 alone, each row's ratio
//     and sign computed once into shared memory, then one pass for the
//     Harris and Bland choices, reduced by shuffles;
//   * the write-back reads the staged tile and writes it once in 16-byte
//     vectors, the pivot column and the normalised row coming from shared
//     memory; the other resident blocks of the SM keep their loads and
//     stores in flight while one decides;
//   * an instance above kStageMaxBytes decides from global memory and
//     streams its update through the same write-back; one that is not
//     RUNNING writes only s, r and its flags.
// Per block of 128 threads, as `-Xptxas -v` reported it on sm_90a: 47
// registers a thread in float32, 54 in float64, no spills; 128 B of static
// shared memory for the mbarrier and the reduction slots, and
// layout(M, N, sizeof(T), staged).total bytes of dynamic shared memory
// (17,456 B at 32 x 128 float32; K2 leaves the ub_B and Harris-value rows
// of the layout unused).  It launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "batched_step_common.cuh"

namespace {

template <typename T>
struct K2Args {
  T* tab;
  int M, N;
  int32_t* basis;
  const uint8_t* cm1;
  const uint8_t* cm2;
  const int32_t* phase;
  const int32_t* status;
  const uint8_t* bland;
  T* w;
  T tol;
  int devex;
  int32_t* s_out;
  int32_t* r_out;
  uint8_t* opt_out;
  uint8_t* unb_out;
  uint8_t* did_out;
};

// What warp 0's decision hands to the block.
template <typename T>
struct K2Shared {
  Slots<T> sl;
  int s, r, j_out;
  bool active;
};

// The pricing lane's score and its reduction: Devex takes the first
// argmax of rc^2 / w over the eligible lanes, Dantzig the first argmin of
// the masked rc.
template <bool kDevex, typename T>
__device__ __forceinline__ void k2_price(const T* obj, T obj0,
                                         const uint8_t* cm, const T* wb,
                                         bool live, int j0, bool valid0, T w0,
                                         T tol, int N, Slots<T>& sl,
                                         int& s_price, int& s_bland) {
  using A = Arith<T>;
  T best = kDevex ? -A::inf() : A::inf();
  s_price = kIntMax;
  s_bland = kIntMax;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const bool first = j == j0;
    const bool valid = first ? valid0 : cm[j] != 0;
    const T rc = valid ? (first ? obj0 : obj[j]) : A::inf();
    const bool elig = rc < -tol;
    if (elig && j < s_bland) s_bland = j;
    if (kDevex) {
      const T score = elig ? A::div(A::mul(rc, rc), first && live ? w0 : wb[j])
                           : -A::inf();
      arg_merge<true>(best, s_price, score, j);
    } else {
      arg_merge<false>(best, s_price, rc, j);
    }
  }
  block_price<kDevex>(best, s_price, s_bland, sl);
}

// The step of instance b, deciding from `src`: the staged tile (st.on) or
// the instance in global memory.
template <typename T>
__device__ __forceinline__ void k2_instance(const K2Args<T>& a, int b,
                                            const Head<T>& h, const T* src,
                                            const Stage& st,
                                            const Scratch<T>& sc,
                                            K2Shared<T>& sh) {
  using A = Arith<T>;
  const int M = a.M, N = a.N, R = M - 1;
  const int tid = threadIdx.x, lane = tid & 31;
  const T inf = A::inf(), tol = a.tol;
  T* Tb = a.tab + (size_t)b * M * N;
  int32_t* basis_b = a.basis + (size_t)b * R;
  T* wb = a.w + (size_t)b * N;
  const bool live = h.live, use_bland = h.bland;
  const uint8_t* cm = (h.in_p1 ? a.cm1 : a.cm2) + (size_t)b * N;

  // Loaded while the tile is in flight.
  const int j0 = tid;
  bool valid0 = false;
  T w0 = T(1);
  if (j0 < N) {
    valid0 = cm[j0] != 0;
    if (a.devex && live) w0 = wb[j0];
  }
  int basis0 = kIntMax;
  if (tid < 32 && lane < R && (use_bland || (live && a.devex)))
    basis0 = basis_b[lane];
  stage_wait(st);
  const T* obj = src + (size_t)R * N;

  // ---- pricing: entering column s --------------------------------------
  int s_price, s_bland;
  if (a.devex)
    k2_price<true>(obj, h.obj0, cm, wb, live, j0, valid0, w0, tol, N, sh.sl,
                   s_price, s_bland);
  else
    k2_price<false>(obj, h.obj0, cm, wb, live, j0, valid0, w0, tol, N,
                    sh.sl, s_price, s_bland);
  int s = use_bland ? s_bland : s_price;
  s = s < 0 ? 0 : (s > N - 1 ? N - 1 : s);
  const bool optimal = s_bland == kIntMax;

  // ---- ratio test: warp 0, one row a lane ------------------------------
  if (tid < 32) {
    const T c64 = T(64) * A::kEps;
    T min_ratio = inf, theta_max = inf;
    for (int i = lane; i < R; i += 32) {
      const T c = src[(size_t)i * N + s];
      const T rhs = src[(size_t)i * N + N - 1];
      const bool pos = c > tol;
      const T ratio = pos ? A::div(clamp0(rhs), c) : inf;
      const T relax =
          pos ? A::div(A::fma(A::add(T(1), A::abs(rhs)), tol, clamp0(rhs)), c)
              : inf;
      sc.col[i] = c;
      sc.ratio[i] = ratio;
      sc.flags[i] = pos;
      min_ratio = nan_min(min_ratio, ratio);
      theta_max = nan_min(theta_max, relax);
    }
    if (lane == 0) sc.col[R] = obj[s];
    min_ratio = warp_min(min_ratio);
    theta_max = warp_min(theta_max);
    const T near_max =
        A::add(min_ratio, A::mul(c64, A::add(T(1), A::abs(min_ratio))));
    T piv_big = -inf;
    int r_harris = kIntMax, key_min = kIntMax, r_bland = kIntMax;
    for (int i = lane; i < R; i += 32) {
      const bool pos = sc.flags[i] != 0;
      const T ratio = sc.ratio[i];
      const bool cand = pos && ratio <= theta_max;
      arg_merge<true>(piv_big, r_harris, cand ? sc.col[i] : -inf,
                      cand ? i : kIntMax);
      if (use_bland) {
        const int key = pos && ratio <= near_max
                            ? (i == lane ? basis0 : basis_b[i])
                            : kIntMax;
        arg_merge<false>(key_min, r_bland, key, i);
      }
    }
    warp_arg<true>(piv_big, r_harris);
    warp_arg<false>(key_min, r_bland);
    int r = use_bland ? r_bland : r_harris;
    r = r < 0 ? 0 : (r > M - 2 ? M - 2 : r);
    int j_out = __shfl_sync(0xffffffffu, basis0, r & 31);
    const bool unbounded = !optimal && A::isinf(min_ratio);
    const bool active = live && !optimal && !unbounded;
    if (lane == 0) {
      if (r >= 32 && active && a.devex) j_out = basis_b[r];
      a.s_out[b] = s;
      a.r_out[b] = r;
      a.opt_out[b] = optimal;
      a.unb_out[b] = unbounded;
      a.did_out[b] = active;
      sh.s = s;
      sh.r = r;
      sh.j_out = j_out;
      sh.active = active;
    }
  }
  __syncthreads();
  if (!sh.active) return;  // the same for every thread of the block
  const int r = sh.r;
  const T* col = sc.col;

  // ---- the normalised pivot row and the Devex weights ------------------
  const T pivot = col[r];
  const T safe = A::abs(pivot) > T(0) ? pivot : T(1);
  const int j_out = sh.j_out;
  const T w_s = a.devex ? wb[s] : T(0);
  auto new_w = [&](int j, T wj, T p) -> T {
    if (j == s) return T(1);
    if (j == j_out) return nan_max(w_s, T(1));
    return nan_max(wj, A::mul(A::mul(p, p), w_s));
  };
  T w_max = -inf, nw0 = T(1);
  for (int j = tid; j < N; j += kThreads) {
    T p = A::div(src[(size_t)r * N + j], safe);
    if (j == N - 1) p = clamp0(p);
    sc.prow[j] = p;
    if (a.devex) {
      const T nw = new_w(j, j == j0 ? w0 : wb[j], p);
      if (j == j0) nw0 = nw;
      w_max = nan_max(w_max, nw);
    }
  }
  if (a.devex) {
    // Every w_s is read before this barrier, every weight written after.
    const bool reset = block_max(w_max, sh.sl.wmax) > T(1e8);
    for (int j = tid; j < N; j += kThreads)
      wb[j] = reset ? T(1) : (j == j0 ? nw0 : new_w(j, wb[j], sc.prow[j]));
  } else {
    __syncthreads();
  }

  // ---- rank-1 update: one write of the tile -----------------------------
  const T* prow = sc.prow;
  auto f = [&](int i, int j, T t) -> T {
    if (j == s) return i == r ? T(1) : T(0);
    if (i == r) return prow[j];
    return A::fma(-col[i], prow[j], t);
  };
  if (st.on)
    write_back<false>(Tb, src, M, N, f);
  else
    write_back<true>(Tb, Tb, M, N, f);
  if (tid == 0) basis_b[r] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_pivot_step_kernel(const K2Args<T> a, const Layout L, int stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ K2Shared<T> sh;
  const int b = blockIdx.x;
  T* Tb = a.tab + (size_t)b * a.M * a.N;
  const Head<T> h = load_head(a.status, a.phase, a.bland, Tb, a.M, a.N, b);
  Stage st{stage != 0 && h.live, false, &bar, 0};
  if (st.on && threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  const Scratch<T> sc = scratch<T>(smem, L);
  const T* src =
      st.on ? stage_begin(sc.tile, Tb, (int64_t)a.M * a.N, st) : Tb;
  k2_instance(a, b, h, src, st, sc, sh);
}

template <typename T>
int launch(const K2Args<T>& a, int64_t B, void* stream) {
  if (B < 1 || B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool stage =
      (uint64_t)a.M * (uint64_t)a.N * sizeof(T) <= (uint64_t)kStageMaxBytes;
  const Layout L = layout(a.M, a.N, sizeof(T), stage);
  if (L.total > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_shared_memory(fused_pivot_step_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  fused_pivot_step_kernel<T>
      <<<(unsigned)B, kThreads, (size_t)L.total,
         reinterpret_cast<cudaStream_t>(stream)>>>(a, L, stage ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int k2(T* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
       const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
       const int32_t* status, const uint8_t* bland, T* w, T tol, int devex,
       int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
       uint8_t* did_out, void* stream) {
  if (M < 2 || N < 2 || M > (1 << 30) || N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const K2Args<T> a{tab,    (int)M, (int)N, basis, cm1,   cm2,
                    phase,  status, bland,  w,     tol,   devex,
                    s_out,  r_out,  opt_out, unb_out, did_out};
  return launch<T>(a, B, stream);
}

}  // namespace

// Every pointer is a contiguous device buffer: tab (B, M, N), basis
// (B, M-1) int32, cm1/cm2 (B, N) bool, phase/status (B,) int32, bland (B,)
// bool, w (B, N), the outputs (B,) (the Python wrapper checks).
extern "C" int k2_fused_pivot_step_f32(
    float* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
    const int32_t* status, const uint8_t* bland, float* w, float tol,
    int devex, int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
    uint8_t* unb_out, uint8_t* did_out, void* stream) {
  return k2<float>(tab, B, M, N, basis, cm1, cm2, phase, status, bland, w,
                   tol, devex, s_out, r_out, opt_out, unb_out, did_out,
                   stream);
}

extern "C" int k2_fused_pivot_step_f64(
    double* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
    const int32_t* status, const uint8_t* bland, double* w, double tol,
    int devex, int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
    uint8_t* unb_out, uint8_t* did_out, void* stream) {
  return k2<double>(tab, B, M, N, basis, cm1, cm2, phase, status, bland, w,
                    tol, devex, s_out, r_out, opt_out, unb_out, did_out,
                    stream);
}
