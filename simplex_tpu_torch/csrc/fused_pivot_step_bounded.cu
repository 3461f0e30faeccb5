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
// Bound: memory.  A step must read and write the tableau once (2 B M N
// sizeof(T) bytes) plus the small bound state.  Design, simple first, K2's
// shape:
//   * one block of kThreads threads per instance, which owns the instance's
//     data, so the in-place update needs no grid-wide sync;
//   * pricing and the ratio test are block reductions (extremum first,
//     NaN-propagating, then the lowest index attaining it);
//   * the pivot column is gathered into a side buffer during the ratio test
//     and the normalised pivot row before any element of T is written; the
//     old RHS column needs no buffer, because the one thread that owns
//     column N-1 in the update reads each of its cells before writing it;
//   * the update makes one read and one write of T: thread t owns columns
//     t, t + kThreads, ... of every row, so a warp reads and writes
//     consecutive addresses.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "batched_step_common.cuh"

namespace {

// One constraint row's part of the bounded ratio test.
template <typename T>
struct BoundedRow {
  T dd, t_lo, t_hi, t_row, rel;
  bool cand, art_exit;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_pivot_step_bounded_kernel(
    T* __restrict__ tab, int M, int N, int32_t* __restrict__ basis,
    uint8_t* __restrict__ at_upper, const uint8_t* __restrict__ cm1,
    const uint8_t* __restrict__ cm2, const int32_t* __restrict__ phase,
    const int32_t* __restrict__ status, const uint8_t* __restrict__ bland,
    T* __restrict__ w, const T* __restrict__ ub, T* __restrict__ ub_B,
    uint8_t* __restrict__ is_art_row, const uint8_t* __restrict__ art_mask,
    T tol, int devex, int with_art, int32_t* __restrict__ s_out,
    int32_t* __restrict__ r_out, uint8_t* __restrict__ opt_out,
    uint8_t* __restrict__ unb_out, uint8_t* __restrict__ mov_out,
    T* __restrict__ scratch) {
  using A = Arith<T>;
  __shared__ T sh_t[kWarps];
  __shared__ int sh_i[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = M - 1;  // constraint rows
  const T inf = A::inf();
  T* Tb = tab + (size_t)b * M * N;
  int32_t* basis_b = basis + (size_t)b * R;
  uint8_t* at_b = at_upper + (size_t)b * (N - 1);
  T* wb = w + (size_t)b * N;
  const T* ub_b = ub + (size_t)b * (N - 1);
  T* ubB_b = ub_B + (size_t)b * R;
  uint8_t* art_row_b = is_art_row + (size_t)b * R;
  T* col = scratch + (size_t)b * (M + N);  // pivot column, M
  T* prow = col + M;                        // normalised pivot row, N
  const bool in_p1 = phase[b] == 1;
  const bool live = status[b] == kRunning;
  const bool use_bland = bland[b] != 0;
  const uint8_t* cm = (in_p1 ? cm1 : cm2) + (size_t)b * N;
  const T* obj = Tb + (size_t)R * N;

  // ---- two-sided pricing: entering column s -----------------------------
  auto at_up = [&](int j) -> bool { return j < N - 1 && at_b[j] != 0; };
  auto price = [&](int j, bool* elig) -> T {
    const bool valid = cm[j] != 0;
    const T rc = valid ? obj[j] : T(0);
    *elig = valid && (at_up(j) ? rc > tol : rc < -tol);
    if (!*elig) return -inf;
    const T viol = A::abs(rc);
    return devex ? A::div(A::mul(viol, viol), wb[j]) : viol;
  };
  T ext = -inf;
  int first_elig = kIntMax;
  for (int j = tid; j < N; j += kThreads) {
    bool elig;
    ext = nan_max(ext, price(j, &elig));
    if (elig && j < first_elig) first_elig = j;
  }
  ext = block_reduce(ext, MaxF(), sh_t);
  const int s_bland = block_reduce(first_elig, MinI(), sh_i);
  int first_ext = kIntMax;
  for (int j = tid; j < N; j += kThreads) {
    bool elig;
    if (price(j, &elig) == ext && j < first_ext) first_ext = j;
  }
  const int s_price = block_reduce(first_ext, MinI(), sh_i);
  int s = use_bland ? s_bland : s_price;
  s = s < 0 ? 0 : (s > N - 2 ? N - 2 : s);
  const bool optimal = s_bland == kIntMax;
  const bool s_from_up = at_up(s);
  const T sigma = s_from_up ? T(-1) : T(1);
  const T ub_s = ub_b[s];
  const T ub_s_safe = A::isfinite(ub_s) ? ub_s : T(0);

  // ---- bounded ratio test over the constraint rows ----------------------
  auto row = [&](int i) -> BoundedRow<T> {
    BoundedRow<T> q;
    q.dd = A::mul(sigma, Tb[(size_t)i * N + s]);
    const T xB = Tb[(size_t)i * N + N - 1];
    const T ubB = ubB_b[i];
    const bool pos = q.dd > tol;
    const bool neg = q.dd < -tol && A::isfinite(ubB);
    const T span = A::add(ubB, -xB);
    const T xB_c = clamp0(xB);
    const T span_c = clamp0(span);
    q.t_lo = pos ? A::div(xB_c, q.dd) : inf;
    q.t_hi = neg ? A::div(span_c, -q.dd) : inf;
    q.art_exit = with_art && !in_p1 && art_row_b[i] != 0 &&
                 A::abs(q.dd) > tol;
    if (q.art_exit) q.t_lo = T(0);
    q.cand = pos || neg || q.art_exit;
    q.t_row = nan_min(q.t_lo, q.t_hi);
    const T rel_lo =
        pos ? A::div(A::fma(A::add(T(1), A::abs(xB)), tol, xB_c), q.dd) : inf;
    const T rel_hi =
        neg ? A::div(A::add(span_c, A::mul(tol, A::add(T(1), A::abs(span)))),
                     -q.dd)
            : inf;
    q.rel = nan_min(rel_lo, rel_hi);
    return q;
  };
  T min_row = inf, theta_max = inf;
  for (int i = tid; i < R; i += kThreads) {
    const BoundedRow<T> q = row(i);
    col[i] = Tb[(size_t)i * N + s];
    min_row = nan_min(min_row, q.t_row);
    theta_max = nan_min(theta_max, q.rel);
  }
  if (tid == 0) col[R] = obj[s];
  min_row = block_reduce(min_row, MinF(), sh_t);
  theta_max = block_reduce(theta_max, MinF(), sh_t);
  const T theta = nan_min(min_row, ub_s);
  const bool unbounded = !optimal && A::isinf(theta);
  const bool flip = !optimal && !unbounded && ub_s <= min_row;
  const T theta_safe = A::isfinite(theta) ? theta : T(0);

  // Harris over both limits; Bland keeps basis-index ties.
  const T near_max = A::add(
      min_row, A::mul(T(64) * A::kEps, A::add(T(1), A::abs(min_row))));
  auto harris = [&](const BoundedRow<T>& q) -> T {
    if (!((q.cand && q.t_row <= theta_max) || q.art_exit)) return -inf;
    return q.art_exit ? A::add(A::abs(q.dd), T(1e30)) : A::abs(q.dd);
  };
  auto tie_key = [&](int i, const BoundedRow<T>& q) -> int {
    return (q.cand && q.t_row <= near_max) ? basis_b[i] : kIntMax;
  };
  T h_max = -inf;
  int key_min = kIntMax;
  for (int i = tid; i < R; i += kThreads) {
    const BoundedRow<T> q = row(i);
    h_max = nan_max(h_max, harris(q));
    const int key = tie_key(i, q);
    if (key < key_min) key_min = key;
  }
  h_max = block_reduce(h_max, MaxF(), sh_t);
  key_min = block_reduce(key_min, MinI(), sh_i);
  int r_harris = kIntMax, r_bland = kIntMax;
  for (int i = tid; i < R; i += kThreads) {
    const BoundedRow<T> q = row(i);
    if (harris(q) == h_max && i < r_harris) r_harris = i;
    if (tie_key(i, q) == key_min && i < r_bland) r_bland = i;
  }
  r_harris = block_reduce(r_harris, MinI(), sh_i);
  r_bland = block_reduce(r_bland, MinI(), sh_i);
  int r = use_bland ? r_bland : r_harris;
  r = r < 0 ? 0 : (r > M - 2 ? M - 2 : r);
  const BoundedRow<T> qr = row(r);
  const bool leave_up = qr.t_hi < qr.t_lo;

  const bool active = live && !optimal && !unbounded;
  const bool do_flip = active && flip;
  if (tid == 0) {
    s_out[b] = s;
    r_out[b] = r;
    opt_out[b] = optimal;
    unb_out[b] = unbounded;
    mov_out[b] = active;
  }
  if (!active) return;  // the same for every thread of the block

  // ---- bound flip: the RHS column alone ---------------------------------
  if (do_flip) {
    for (int i = tid; i < M; i += kThreads) {
      T* cell = Tb + (size_t)i * N + N - 1;
      T x = A::fma(-A::mul(sigma, col[i]), ub_s_safe, *cell);
      if (i < R) x = nan_min(ubB_b[i], clamp0(x));
      *cell = x;
    }
    if (tid == 0) at_b[s] ^= 1;
    return;
  }

  // ---- pivot: gather the normalised pivot row (col is complete) ---------
  const T pivot = col[r];
  const T safe = A::abs(pivot) > T(0) ? pivot : T(1);
  for (int j = tid; j < N; j += kThreads)
    prow[j] = A::div(Tb[(size_t)r * N + j], safe);
  __syncthreads();

  const int j_out = basis_b[r];
  if (devex) {
    const T w_s = wb[s];
    auto new_w = [&](int j) -> T {
      if (j == s) return T(1);
      if (j == j_out) return nan_max(w_s, T(1));
      return nan_max(wb[j], A::mul(A::mul(prow[j], prow[j]), w_s));
    };
    T w_max = -inf;
    for (int j = tid; j < N; j += kThreads) w_max = nan_max(w_max, new_w(j));
    w_max = block_reduce(w_max, MaxF(), sh_t);  // every w_s read before
    const bool reset = w_max > T(1e8);
    for (int j = tid; j < N; j += kThreads) wb[j] = reset ? T(1) : new_w(j);
  }

  // ---- rank-1 update and the RHS column: one read and one write of T ----
  const T x_enter = s_from_up ? A::add(ub_s_safe, -theta_safe) : theta_safe;
  for (int j = tid; j < N; j += kThreads) {
    const T p = prow[j];
    for (int i = 0; i < M; ++i) {
      T* cell = Tb + (size_t)i * N + j;
      T out;
      if (j == N - 1) {
        out = i == r ? x_enter
                     : A::fma(-A::mul(sigma, col[i]), theta_safe, *cell);
        if (i < R) out = nan_min(i == r ? ub_s : ubB_b[i], clamp0(out));
      } else if (j == s) {
        out = i == r ? T(1) : T(0);
      } else if (i == r) {
        out = p;
      } else {
        out = A::fma(-col[i], p, *cell);
      }
      *cell = out;
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (j_out >= 0 && j_out < N - 1) at_b[j_out] = leave_up;
    at_b[s] = 0;
    ubB_b[r] = ub_s;
    if (with_art) art_row_b[r] = art_mask[(size_t)b * N + s];
    basis_b[r] = s;
  }
}

template <typename T>
int launch(T* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
           uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
           const int32_t* phase, const int32_t* status, const uint8_t* bland,
           T* w, const T* ub, T* ub_B, uint8_t* is_art_row,
           const uint8_t* art_mask, T tol, int devex, int with_art,
           int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
           uint8_t* unb_out, uint8_t* mov_out, T* scratch, void* stream) {
  if (B < 1 || B > 2147483647LL || M < 2 || N < 2 || M > (1 << 30) ||
      N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  fused_pivot_step_bounded_kernel<T>
      <<<(unsigned)B, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          tab, (int)M, (int)N, basis, at_upper, cm1, cm2, phase, status,
          bland, w, ub, ub_B, is_art_row, art_mask, tol, devex, with_art,
          s_out, r_out, opt_out, unb_out, mov_out, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// Every pointer is a contiguous device buffer: tab (B, M, N), basis
// (B, M-1) int32, at_upper (B, N-1) bool, cm1/cm2 (B, N) bool, phase/status
// (B,) int32, bland (B,) bool, w (B, N), ub (B, N-1), ub_B (B, M-1),
// is_art_row (B, M-1) bool, art_mask (B, N) bool, the outputs (B,), scratch
// (B, M + N) (the Python wrapper checks).
extern "C" int k3_fused_pivot_step_bounded_f32(
    float* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
    const int32_t* phase, const int32_t* status, const uint8_t* bland,
    float* w, const float* ub, float* ub_B, uint8_t* is_art_row,
    const uint8_t* art_mask, float tol, int devex, int with_art,
    int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
    uint8_t* mov_out, float* scratch, void* stream) {
  return launch<float>(tab, B, M, N, basis, at_upper, cm1, cm2, phase,
                       status, bland, w, ub, ub_B, is_art_row, art_mask, tol,
                       devex, with_art, s_out, r_out, opt_out, unb_out,
                       mov_out, scratch, stream);
}

extern "C" int k3_fused_pivot_step_bounded_f64(
    double* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
    const int32_t* phase, const int32_t* status, const uint8_t* bland,
    double* w, const double* ub, double* ub_B, uint8_t* is_art_row,
    const uint8_t* art_mask, double tol, int devex, int with_art,
    int32_t* s_out, int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
    uint8_t* mov_out, double* scratch, void* stream) {
  return launch<double>(tab, B, M, N, basis, at_upper, cm1, cm2, phase,
                        status, bland, w, ub, ub_B, is_art_row, art_mask,
                        tol, devex, with_art, s_out, r_out, opt_out, unb_out,
                        mov_out, scratch, stream);
}
