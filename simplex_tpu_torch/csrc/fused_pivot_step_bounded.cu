// K3: one fused bounded simplex step (0 <= x <= ub kept native: two-sided
// pricing, the bounded ratio test with bound flips, the rank-1 pivot with a
// recomputed RHS column, Devex) for every instance of a batch of (M, N)
// tableaus, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// simplex_tpu/ops/pallas_batched.py::fused_pivot_step_bounded (body
// _make_kernel_bounded) and computes what its plain PyTorch twin
// simplex_tpu_torch/ops/batched_kernel.py::fused_pivot_step_bounded_ref
// computes, bit for bit.  Per instance b (objective row M-1, RHS column N-1,
// constraint rows i < M-1):
//
//   pricing   a column is eligible from its lower bound when rc < -tol and
//             from its upper bound (at_upper) when rc > tol; score |rc|, or
//             rc^2 / w under Devex; s = first argmax, or the first eligible
//             column under Bland; s clipped to [0, N-2]
//   ratio     sigma = -1 when s enters from its upper bound, dd = sigma col;
//             t_lo = max(xB, 0) / dd where dd > tol, t_hi = max(ub_B - xB, 0)
//             / -dd where dd < -tol and ub_B is finite; with with_art, the
//             art-exit rows of phase 2 get t_lo = 0; theta = min(min row,
//             ub_s): unbounded when infinite, a bound flip when ub_s <= the
//             min row
//   Harris    both limits relaxed by tol (1 + |.|); the largest |dd| in the
//             window, art-exit rows scoring |dd| + 1e30 (added in T's type,
//             so in float32 they all round to 1e30 and the first wins);
//             Bland: the smallest basis index within 64 eps of the min row;
//             r clipped to [0, M-2]; leave_up = t_hi[r] < t_lo[r]
//   pivot     prow = T[r, :] / T[r, s]; T <- T - T[:, s] (outer) prow on every
//             lane but the RHS; T[r, :] <- prow; T[:, s] <- e_r; the RHS
//             column <- xB - dd theta (the objective cell too), the entering
//             row at theta or ub_s - theta, rows clipped to [0, ub_B new]
//   flip      the RHS column alone <- xB - dd ub_s, rows clipped to
//             [0, ub_B]; at_upper[s] toggles
//   state     on a pivot: at_upper[leaving] = leave_up, at_upper[s] = 0,
//             ub_B[r] = ub_s, is_art_row[r] = art_mask[s] (with_art),
//             basis[r] = s, Devex as K2 (the reset reads every lane)
//
// An instance that neither pivots nor flips is left bit-identical; a flip
// writes only its RHS column and at_upper.  Ties go to the lowest index.
// Infinite bounds are masked before any product (ub_s and theta enter the
// arithmetic as 0 when infinite), so no inf * 0 appears.  Rounding follows
// the twin: explicit round-to-nearest intrinsics; in float32 the lower
// Harris numerator max(xB, 0) + tol (1 + |xB|), the update t - c p and the
// RHS steps xB - dd theta and xB - dd ub_s are one fused multiply-add each,
// as XLA contracts them in the reference's compiled kernel, while the upper
// numerator rounds its product and its sum apart, as there; in float64
// every operation rounds on its own.
//
// Bound: bytes.  A pivoting instance must read and write its whole tile
// once, a flipping or stopping one only its objective row, entering column
// and RHS column, plus the small bound state (chip_smoke.py::_step_bytes
// and _state_bytes count it from a step's outcome); the operations are a
// few per element, far under the card's float32 rate.  Design, on the
// batched-step skeleton of batched_step_common.cuh (one block of 128
// threads an instance):
//   * the block's first round trip loads the instance's status, phase and
//     Bland flag and its objective row (load_head); a RUNNING instance
//     whose tile fits kStageMaxBytes (64 KB: the main shape 32 x 128 is
//     16 KB in float32, 32 KB in float64) is then staged in shared memory
//     by one TMA bulk copy (cp.async where its base or size is not a
//     16-byte multiple), while the block loads the masks, at_upper, the
//     Devex weights and warp 0's rows of ub_B, is_art_row and the basis;
//   * the decision reads the staged tile: pricing is one block reduction
//     of (score, first index) and of the first eligible lane; the ratio
//     test is warp 0 alone, each row's dd, t_lo, t_hi, Harris value and
//     flags computed once into shared memory, then one pass for the Harris
//     and Bland choices, reduced by shuffles; four __syncthreads in all on
//     a Devex pivot;
//   * the write-back reads the staged tile and writes the whole tile once
//     in 16-byte vectors from the instance's first 16-byte boundary, the
//     pivot column, the normalised row and ub_B coming from shared memory;
//   * the other resident blocks of the SM (ten, at the registers below)
//     keep their copies and stores in flight while one block decides,
//     which hides the decision's latency: a persistent grid with a
//     two-stage ring of staged tiles ran 1.64x slower, and a register cap
//     for 12 blocks gained under 1 % (tools/batched_variants.py, PERF.md);
//   * an instance above kStageMaxBytes decides from global memory and
//     streams its update through the same write-back, four 16-byte vectors
//     in flight a thread; one that is not RUNNING decides from global
//     memory and writes only s, r and its flags.
// Per block of 128 threads, as `-Xptxas -v` reported it on sm_90a: 46
// registers a thread in float32, 64 in float64, no spills; 128 B (256 B in
// float64) of static shared memory for the mbarrier and the reduction
// slots, and layout(M, N, sizeof(T), staged).total bytes of dynamic shared
// memory (17,456 B at 32 x 128 float32, 34,864 B in float64).  It launches
// on the caller's stream, allocates nothing and returns cudaGetLastError().

#include "batched_step_common.cuh"

namespace {

template <typename T>
struct K3Args {
  T* tab;
  int M, N;
  int32_t* basis;
  uint8_t* at_upper;
  const uint8_t* cm1;
  const uint8_t* cm2;
  const int32_t* phase;
  const int32_t* status;
  const uint8_t* bland;
  T* w;
  const T* ub;
  T* ub_B;
  uint8_t* is_art_row;
  const uint8_t* art_mask;
  T tol;
  int devex, with_art;
  int32_t* s_out;
  int32_t* r_out;
  uint8_t* opt_out;
  uint8_t* unb_out;
  uint8_t* mov_out;
};

// What warp 0's decision hands to the block.
template <typename T>
struct K3Shared {
  Slots<T> sl;
  int s, r, j_out;
  bool active, flip, leave_up, from_up;
  T ub_s, theta_safe;
};

// Row flags of the ratio test.
constexpr uint8_t kCand = 1, kArtExit = 2, kLeaveUp = 4;

// The step of instance b, deciding from `src`: the staged tile (st.on) or
// the instance in global memory.
template <typename T>
__device__ __forceinline__ void k3_instance(const K3Args<T>& a, int b,
                                            const Head<T>& h, const T* src,
                                            const Stage& st,
                                            const Scratch<T>& sc,
                                            K3Shared<T>& sh) {
  using A = Arith<T>;
  const int M = a.M, N = a.N, R = M - 1;
  const int tid = threadIdx.x, lane = tid & 31;
  const T inf = A::inf(), tol = a.tol;
  T* Tb = a.tab + (size_t)b * M * N;
  int32_t* basis_b = a.basis + (size_t)b * R;
  uint8_t* at_b = a.at_upper + (size_t)b * (N - 1);
  T* wb = a.w + (size_t)b * N;
  const T* ub_b = a.ub + (size_t)b * (N - 1);
  T* ubB_b = a.ub_B + (size_t)b * R;
  uint8_t* art_row_b = a.is_art_row + (size_t)b * R;
  const bool live = h.live, in_p1 = h.in_p1, use_bland = h.bland;
  const bool art_rows = a.with_art && !in_p1;
  const uint8_t* cm = (in_p1 ? a.cm1 : a.cm2) + (size_t)b * N;

  // Loaded while the tile is in flight: this thread's first lane for
  // pricing, warp 0's first row for the ratio test.
  const int j0 = tid;
  bool valid0 = false, up0 = false;
  T w0 = T(1);
  if (j0 < N) {
    valid0 = cm[j0] != 0;
    up0 = j0 < N - 1 && at_b[j0] != 0;
    if (a.devex && live) w0 = wb[j0];
  }
  T ubB0 = T(0);
  bool art0 = false;
  int basis0 = kIntMax;
  if (tid < 32 && lane < R) {
    ubB0 = ubB_b[lane];
    if (art_rows) art0 = art_row_b[lane] != 0;
    if (use_bland || live) basis0 = basis_b[lane];
  }
  stage_wait(st);
  const T* obj = src + (size_t)R * N;

  // ---- two-sided pricing: entering column s -----------------------------
  T best = -inf;
  int s_price = kIntMax, s_bland = kIntMax;
  for (int j = tid; j < N; j += kThreads) {
    const bool first = j == j0;
    const bool valid = first ? valid0 : cm[j] != 0;
    const bool up = first ? up0 : (j < N - 1 && at_b[j] != 0);
    const T rc = valid ? (first ? h.obj0 : obj[j]) : T(0);
    const bool elig = valid && (up ? rc > tol : rc < -tol);
    T score = -inf;
    if (elig) {
      const T viol = A::abs(rc);
      score = a.devex
                  ? A::div(A::mul(viol, viol), first && live ? w0 : wb[j])
                  : viol;
      if (j < s_bland) s_bland = j;
    }
    arg_merge<true>(best, s_price, score, j);
  }
  block_price<true>(best, s_price, s_bland, sh.sl);
  int s = use_bland ? s_bland : s_price;
  s = s < 0 ? 0 : (s > N - 2 ? N - 2 : s);
  const bool optimal = s_bland == kIntMax;

  // ---- bounded ratio test: warp 0, one row a lane -----------------------
  if (tid < 32) {
    const bool from_up = at_b[s] != 0;
    const T sigma = from_up ? T(-1) : T(1);
    const T ub_s = ub_b[s];
    T min_row = inf, theta_max = inf;
    for (int i = lane; i < R; i += 32) {
      const bool first = i == lane;
      const T c = src[(size_t)i * N + s];
      const T xB = src[(size_t)i * N + N - 1];
      const T ubB = first ? ubB0 : ubB_b[i];
      const bool art = art_rows && (first ? art0 : art_row_b[i] != 0);
      sc.col[i] = c;
      sc.ubB[i] = ubB;
      const T dd = A::mul(sigma, c);
      const bool pos = dd > tol;
      const bool neg = dd < -tol && A::isfinite(ubB);
      const T span = A::add(ubB, -xB);
      const T xB_c = clamp0(xB);
      const T span_c = clamp0(span);
      T t_lo = pos ? A::div(xB_c, dd) : inf;
      const T t_hi = neg ? A::div(span_c, -dd) : inf;
      const bool art_exit = art && A::abs(dd) > tol;
      if (art_exit) t_lo = T(0);
      const T t_row = nan_min(t_lo, t_hi);
      const T rel_lo =
          pos ? A::div(A::fma(A::add(T(1), A::abs(xB)), tol, xB_c), dd) : inf;
      const T rel_hi =
          neg ? A::div(A::add(span_c, A::mul(tol, A::add(T(1), A::abs(span)))),
                       -dd)
              : inf;
      min_row = nan_min(min_row, t_row);
      theta_max = nan_min(theta_max, nan_min(rel_lo, rel_hi));
      sc.ratio[i] = t_row;
      sc.hv[i] = art_exit ? A::add(A::abs(dd), T(1e30)) : A::abs(dd);
      sc.flags[i] = ((pos || neg || art_exit) ? kCand : 0) |
                    (art_exit ? kArtExit : 0) | (t_hi < t_lo ? kLeaveUp : 0);
    }
    if (lane == 0) sc.col[R] = obj[s];
    min_row = warp_min(min_row);
    theta_max = warp_min(theta_max);
    const T theta = nan_min(min_row, ub_s);
    const bool unbounded = !optimal && A::isinf(theta);
    const bool flip = !optimal && !unbounded && ub_s <= min_row;
    // Harris over both limits; Bland keeps basis-index ties.
    const T near_max = A::add(
        min_row, A::mul(T(64) * A::kEps, A::add(T(1), A::abs(min_row))));
    T h_max = -inf;
    int r_harris = kIntMax, key_min = kIntMax, r_bland = kIntMax;
    for (int i = lane; i < R; i += 32) {
      const uint8_t fl = sc.flags[i];
      const bool cand = (fl & kCand) != 0;
      const T t_row = sc.ratio[i];
      const bool window = (cand && t_row <= theta_max) || (fl & kArtExit);
      arg_merge<true>(h_max, r_harris, window ? sc.hv[i] : -inf, i);
      if (use_bland) {
        const int key = cand && t_row <= near_max
                            ? (i == lane ? basis0 : basis_b[i])
                            : kIntMax;
        arg_merge<false>(key_min, r_bland, key, i);
      }
    }
    warp_arg<true>(h_max, r_harris);
    warp_arg<false>(key_min, r_bland);
    int r = use_bland ? r_bland : r_harris;
    r = r < 0 ? 0 : (r > M - 2 ? M - 2 : r);
    int j_out = __shfl_sync(0xffffffffu, basis0, r & 31);
    __syncwarp();
    const bool active = live && !optimal && !unbounded;
    if (lane == 0) {
      if (r >= 32 && active) j_out = basis_b[r];
      a.s_out[b] = s;
      a.r_out[b] = r;
      a.opt_out[b] = optimal;
      a.unb_out[b] = unbounded;
      a.mov_out[b] = active;
      sh.s = s;
      sh.r = r;
      sh.j_out = j_out;
      sh.active = active;
      sh.flip = flip;
      sh.leave_up = (sc.flags[r] & kLeaveUp) != 0;
      sh.from_up = from_up;
      sh.ub_s = ub_s;
      sh.theta_safe = A::isfinite(theta) ? theta : T(0);
    }
  }
  __syncthreads();
  if (!sh.active) return;  // the same for every thread of the block
  const int r = sh.r;
  const T sigma = sh.from_up ? T(-1) : T(1);
  const T ub_s = sh.ub_s;
  const T ub_s_safe = A::isfinite(ub_s) ? ub_s : T(0);
  const T* col = sc.col;
  const T* ubB = sc.ubB;

  // ---- bound flip: the RHS column alone ---------------------------------
  if (sh.flip) {
    for (int i = tid; i < M; i += kThreads) {
      T x = A::fma(-A::mul(sigma, col[i]), ub_s_safe,
                   src[(size_t)i * N + N - 1]);
      if (i < R) x = nan_min(ubB[i], clamp0(x));
      Tb[(size_t)i * N + N - 1] = x;
    }
    if (tid == 0) at_b[s] ^= 1;
    return;
  }

  // ---- pivot: the normalised row and the Devex weights ------------------
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
    const T p = A::div(src[(size_t)r * N + j], safe);
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

  // ---- the tile: rank-1 update, the RHS column, one write ---------------
  const T theta_safe = sh.theta_safe;
  const T x_enter = sh.from_up ? A::add(ub_s_safe, -theta_safe) : theta_safe;
  const T* prow = sc.prow;
  auto f = [&](int i, int j, T t) -> T {
    if (j == N - 1) {
      T out = i == r ? x_enter : A::fma(-A::mul(sigma, col[i]), theta_safe, t);
      if (i < R) out = nan_min(i == r ? ub_s : ubB[i], clamp0(out));
      return out;
    }
    if (j == s) return i == r ? T(1) : T(0);
    if (i == r) return prow[j];
    return A::fma(-col[i], prow[j], t);
  };
  if (st.on)
    write_back<false>(Tb, src, M, N, f);
  else
    write_back<true>(Tb, Tb, M, N, f);
  if (tid == 0) {
    if (j_out >= 0 && j_out < N - 1) at_b[j_out] = sh.leave_up;
    at_b[s] = 0;
    ubB_b[r] = ub_s;
    if (a.with_art) art_row_b[r] = a.art_mask[(size_t)b * N + s];
    basis_b[r] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_pivot_step_bounded_kernel(const K3Args<T> a, const Layout L,
                                    int stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ K3Shared<T> sh;
  const int b = blockIdx.x;
  T* Tb = a.tab + (size_t)b * a.M * a.N;
  const Head<T> h = load_head(a.status, a.phase, a.bland, Tb, a.M, a.N, b);
  Stage st{stage != 0 && h.live, false, &bar, 0};
  if (st.on && threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  const Scratch<T> sc = scratch<T>(smem, L);
  const T* src =
      st.on ? stage_begin(sc.tile, Tb, (int64_t)a.M * a.N, st) : Tb;
  k3_instance(a, b, h, src, st, sc, sh);
}

template <typename T>
int launch(const K3Args<T>& a, int64_t B, void* stream) {
  if (B < 1 || B > 2147483647LL || a.M < 2 || a.N < 2 || a.M > (1 << 30) ||
      a.N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const bool stage =
      (uint64_t)a.M * (uint64_t)a.N * sizeof(T) <= (uint64_t)kStageMaxBytes;
  const Layout L = layout(a.M, a.N, sizeof(T), stage);
  if (L.total > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      allow_shared_memory(fused_pivot_step_bounded_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  fused_pivot_step_bounded_kernel<T>
      <<<(unsigned)B, kThreads, (size_t)L.total,
         reinterpret_cast<cudaStream_t>(stream)>>>(a, L, stage ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int k3(T* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
       uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
       const int32_t* phase, const int32_t* status, const uint8_t* bland,
       T* w, const T* ub, T* ub_B, uint8_t* is_art_row,
       const uint8_t* art_mask, T tol, int devex, int with_art,
       int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
       uint8_t* mov_out, void* stream) {
  if (M < 2 || N < 2 || M > (1 << 30) || N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const K3Args<T> a{tab,  (int)M,   (int)N, basis,   at_upper, cm1,
                    cm2,  phase,    status, bland,   w,        ub,
                    ub_B, is_art_row, art_mask, tol, devex,    with_art,
                    s_out, r_out,   opt_out, unb_out, mov_out};
  return launch<T>(a, B, stream);
}

}  // namespace

// Every pointer is a contiguous device buffer: tab (B, M, N), basis
// (B, M-1) int32, at_upper (B, N-1) bool, cm1/cm2 (B, N) bool, phase/status
// (B,) int32, bland (B,) bool, w (B, N), ub (B, N-1), ub_B (B, M-1),
// is_art_row (B, M-1) bool, art_mask (B, N) bool, the outputs (B,) (the
// Python wrapper checks).
extern "C" int k3_fused_pivot_step_bounded_f32(
    float* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
    const int32_t* phase, const int32_t* status, const uint8_t* bland,
    float* w, const float* ub, float* ub_B, uint8_t* is_art_row,
    const uint8_t* art_mask, float tol, int devex, int with_art,
    int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
    uint8_t* mov_out, void* stream) {
  return k3<float>(tab, B, M, N, basis, at_upper, cm1, cm2, phase, status,
                   bland, w, ub, ub_B, is_art_row, art_mask, tol, devex,
                   with_art, s_out, r_out, opt_out, unb_out, mov_out, stream);
}

extern "C" int k3_fused_pivot_step_bounded_f64(
    double* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
    const int32_t* phase, const int32_t* status, const uint8_t* bland,
    double* w, const double* ub, double* ub_B, uint8_t* is_art_row,
    const uint8_t* art_mask, double tol, int devex, int with_art,
    int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
    uint8_t* mov_out, void* stream) {
  return k3<double>(tab, B, M, N, basis, at_upper, cm1, cm2, phase, status,
                    bland, w, ub, ub_B, is_art_row, art_mask, tol, devex,
                    with_art, s_out, r_out, opt_out, unb_out, mov_out,
                    stream);
}
