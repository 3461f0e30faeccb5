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
// Bound: memory.  A step must read and write every element of the tableau
// once: 2 B M N sizeof(T) bytes, against the card's copy bandwidth
// (PERF.md).  Design, simple first:
//   * one block of kThreads threads per instance, so an instance's data is
//     owned by one block and the in-place update needs no grid-wide sync;
//   * pricing and the ratio test are block reductions (warp shuffles, then
//     one value a warp in shared memory) over N lanes and M-1 rows: first the
//     extremum, NaN-propagating like torch.amin / amax, then the lowest
//     index that attains it;
//   * the pivot column and the normalised pivot row are gathered into side
//     buffers (col_buf, prow_buf: M + N elements an instance) before any
//     element of T is written, so no thread reads a value another thread
//     has overwritten;
//   * the update makes one read and one write of T: thread t owns columns
//     t, t + kThreads, ... of every row, so a warp reads and writes
//     consecutive addresses.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "batched_step_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_pivot_step_kernel(
    T* __restrict__ tab, int M, int N, int32_t* __restrict__ basis,
    const uint8_t* __restrict__ cm1, const uint8_t* __restrict__ cm2,
    const int32_t* __restrict__ phase, const int32_t* __restrict__ status,
    const uint8_t* __restrict__ bland, T* __restrict__ w, T tol, int devex,
    int32_t* __restrict__ s_out, int32_t* __restrict__ r_out,
    uint8_t* __restrict__ opt_out, uint8_t* __restrict__ unb_out,
    uint8_t* __restrict__ did_out, T* __restrict__ col_buf,
    T* __restrict__ prow_buf) {
  using A = Arith<T>;
  __shared__ T sh_t[kWarps];
  __shared__ int sh_i[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const T inf = A::inf();
  T* Tb = tab + (size_t)b * M * N;
  int32_t* basis_b = basis + (size_t)b * (M - 1);
  T* wb = w + (size_t)b * N;
  T* col = col_buf + (size_t)b * M;
  T* prow = prow_buf + (size_t)b * N;
  const bool live = status[b] == kRunning;
  const bool use_bland = bland[b] != 0;
  const uint8_t* cm = (phase[b] == 1 ? cm1 : cm2) + (size_t)b * N;
  const T* obj = Tb + (size_t)(M - 1) * N;

  // ---- pricing: entering column s --------------------------------------
  auto price = [&](int j, bool* elig) -> T {
    const T rc = cm[j] ? obj[j] : inf;
    *elig = rc < -tol;
    if (devex) return *elig ? A::div(A::mul(rc, rc), wb[j]) : -inf;
    return rc;
  };
  T ext = devex ? -inf : inf;
  int first_elig = kIntMax;
  for (int j = tid; j < N; j += kThreads) {
    bool elig;
    const T v = price(j, &elig);
    ext = devex ? nan_max(ext, v) : nan_min(ext, v);
    if (elig && j < first_elig) first_elig = j;
  }
  ext = devex ? block_reduce(ext, MaxF(), sh_t) : block_reduce(ext, MinF(), sh_t);
  const int s_bland = block_reduce(first_elig, MinI(), sh_i);
  int first_ext = kIntMax;
  for (int j = tid; j < N; j += kThreads) {
    bool elig;
    if (price(j, &elig) == ext && j < first_ext) first_ext = j;
  }
  const int s_price = block_reduce(first_ext, MinI(), sh_i);
  int s = use_bland ? s_bland : s_price;
  s = s < 0 ? 0 : (s > N - 1 ? N - 1 : s);
  const bool optimal = s_bland == kIntMax;

  // ---- ratio test: leaving row r ---------------------------------------
  const T c64 = T(64) * A::kEps;
  auto ratio_of = [&](int i, T* c_out) -> T {
    const T c = Tb[(size_t)i * N + s];
    *c_out = c;
    return c > tol ? A::div(clamp0(Tb[(size_t)i * N + N - 1]), c) : inf;
  };
  T min_ratio = inf, theta_max = inf;
  for (int i = tid; i < M - 1; i += kThreads) {
    T c;
    const T ratio = ratio_of(i, &c);
    col[i] = c;
    const T rhs = Tb[(size_t)i * N + N - 1];
    const T relax = c > tol
        ? A::div(A::fma(A::add(T(1), A::abs(rhs)), tol, clamp0(rhs)), c)
        : inf;
    min_ratio = nan_min(min_ratio, ratio);
    theta_max = nan_min(theta_max, relax);
  }
  if (tid == 0) col[M - 1] = obj[s];
  min_ratio = block_reduce(min_ratio, MinF(), sh_t);
  theta_max = block_reduce(theta_max, MinF(), sh_t);
  const T near_max =
      A::add(min_ratio, A::mul(c64, A::add(T(1), A::abs(min_ratio))));
  T piv_big = -inf;
  int key_min = kIntMax;
  for (int i = tid; i < M - 1; i += kThreads) {
    T c;
    const T ratio = ratio_of(i, &c);
    const bool pos = c > tol;
    if (pos && ratio <= theta_max) piv_big = nan_max(piv_big, c);
    const int key = (pos && ratio <= near_max) ? basis_b[i] : kIntMax;
    if (key < key_min) key_min = key;
  }
  piv_big = block_reduce(piv_big, MaxF(), sh_t);
  key_min = block_reduce(key_min, MinI(), sh_i);
  int r_harris = kIntMax, r_bland = kIntMax;
  for (int i = tid; i < M - 1; i += kThreads) {
    T c;
    const T ratio = ratio_of(i, &c);
    const bool pos = c > tol;
    if (pos && ratio <= theta_max && c == piv_big && i < r_harris)
      r_harris = i;
    const int key = (pos && ratio <= near_max) ? basis_b[i] : kIntMax;
    if (key == key_min && i < r_bland) r_bland = i;
  }
  r_harris = block_reduce(r_harris, MinI(), sh_i);
  r_bland = block_reduce(r_bland, MinI(), sh_i);
  int r = use_bland ? r_bland : r_harris;
  r = r < 0 ? 0 : (r > M - 2 ? M - 2 : r);
  const bool unbounded = !optimal && A::isinf(min_ratio);
  const bool active = live && !optimal && !unbounded;
  if (tid == 0) {
    s_out[b] = s;
    r_out[b] = r;
    opt_out[b] = optimal;
    unb_out[b] = unbounded;
    did_out[b] = active;
  }
  if (!active) return;  // the same for every thread of the block

  // ---- gather the normalised pivot row (col is complete) ---------------
  const T pivot = Tb[(size_t)r * N + s];
  const T safe = A::abs(pivot) > T(0) ? pivot : T(1);
  for (int j = tid; j < N; j += kThreads) {
    T p = A::div(Tb[(size_t)r * N + j], safe);
    if (j == N - 1) p = clamp0(p);
    prow[j] = p;
  }
  __syncthreads();

  // ---- Devex weights ---------------------------------------------------
  if (devex) {
    const T w_s = wb[s];
    const int j_out = basis_b[r];
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

  // ---- rank-1 update: one read and one write of T ----------------------
  for (int j = tid; j < N; j += kThreads) {
    const T p = prow[j];
    for (int i = 0; i < M; ++i) {
      T* cell = Tb + (size_t)i * N + j;
      T out;
      if (j == s)
        out = i == r ? T(1) : T(0);
      else if (i == r)
        out = p;
      else
        out = A::fma(-col[i], p, *cell);
      *cell = out;
    }
  }
  if (tid == 0) basis_b[r] = s;
}

template <typename T>
int launch(T* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
           const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
           const int32_t* status, const uint8_t* bland, T* w, T tol,
           int devex, int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
           uint8_t* unb_out, uint8_t* did_out, T* col_buf, T* prow_buf,
           void* stream) {
  if (B < 1 || B > 2147483647LL || M < 2 || N < 2 || M > (1 << 30) ||
      N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  fused_pivot_step_kernel<T>
      <<<(unsigned)B, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          tab, (int)M, (int)N, basis, cm1, cm2, phase, status, bland, w, tol,
          devex, s_out, r_out, opt_out, unb_out, did_out, col_buf, prow_buf);
  return (int)cudaGetLastError();
}

}  // namespace

// Every pointer is a contiguous device buffer: tab (B, M, N), basis
// (B, M-1) int32, cm1/cm2 (B, N) bool, phase/status (B,) int32, bland (B,)
// bool, w (B, N), the outputs (B,), col_buf (B, M) and prow_buf (B, N)
// scratch (the Python wrapper checks).
extern "C" int k2_fused_pivot_step_f32(
    float* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
    const int32_t* status, const uint8_t* bland, float* w, float tol,
    int devex, int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
    uint8_t* unb_out, uint8_t* did_out, float* col_buf, float* prow_buf,
    void* stream) {
  return launch<float>(tab, B, M, N, basis, cm1, cm2, phase, status, bland,
                       w, tol, devex, s_out, r_out, opt_out, unb_out, did_out,
                       col_buf, prow_buf, stream);
}

extern "C" int k2_fused_pivot_step_f64(
    double* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
    const uint8_t* cm1, const uint8_t* cm2, const int32_t* phase,
    const int32_t* status, const uint8_t* bland, double* w, double tol,
    int devex, int32_t* s_out, int32_t* r_out, uint8_t* opt_out,
    uint8_t* unb_out, uint8_t* did_out, double* col_buf, double* prow_buf,
    void* stream) {
  return launch<double>(tab, B, M, N, basis, cm1, cm2, phase, status, bland,
                        w, tol, devex, s_out, r_out, opt_out, unb_out,
                        did_out, col_buf, prow_buf, stream);
}
