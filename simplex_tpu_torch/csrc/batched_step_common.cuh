// The batched-step skeleton shared by K2 (fused_pivot_step.cu) and K3
// (fused_pivot_step_bounded.cu), for Hopper (sm_90a): one block of kThreads
// threads owns one instance of a (B, M, N) batch of tableaus and
//   1. stages the instance's contiguous M*N tile in shared memory in one
//      go: a 1-D TMA bulk copy (cp.async.bulk completing on an mbarrier)
//      where the tile's base and size are 16-byte multiples, else 16-byte
//      cp.async with a scalar head and tail.  Only a RUNNING instance
//      whose tile fits kStageMaxBytes is staged; any other decides from
//      global memory, reading what the decision needs and nothing more;
//   2. decides in shared memory: pricing is one (value, first index)
//      block reduction over the N lanes, the ratio test one warp over the
//      M-1 rows (shuffles only), each row's quantities computed once and
//      kept in shared memory for the Harris and Bland pass;
//   3. writes the updated tile back once, in 16-byte vectors from the
//      instance's first 16-byte boundary (scalar head and tail),
//      consecutive threads on consecutive addresses.
// The pivot column, the normalised pivot row and the per-row state live in
// shared memory: the kernels take no global scratch.  An instance too
// large to stage streams its update from global memory through the same
// write-back loop (four vectors in flight a thread), each element read and
// written by one thread, so in place is safe.  While one block decides,
// the other resident blocks of its SM (ten at 32 x 128 float32, bound by
// registers) keep their copies and stores in flight.
//
// Also here: explicitly rounded arithmetic, and extrema that propagate NaN
// as torch.amin / amax / maximum do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 2147483647;
constexpr int kRunning = -1;
// The largest tile staged in shared memory: an SM has 227 KB for its
// blocks, and three staged blocks of 64 KB (plus their small arrays) keep
// three decisions in flight on it; a larger instance streams.
constexpr int64_t kStageMaxBytes = 64 * 1024;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  // a * b + c, rounded once.
  __device__ static float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
  __device__ static bool isinf(float a) { return ::isinf(a); }
  __device__ static bool isfinite(float a) { return ::isfinite(a); }
  static constexpr float kEps = 1.1920928955078125e-07f;  // 2^-23
};

template <>
struct Arith<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  // a * b + c, each operation rounded: in float64 the plain twins have no
  // wider type to round once in, so the kernels round as they do.
  __device__ static double fma(double a, double b, double c) {
    return __dadd_rn(__dmul_rn(a, b), c);
  }
  __device__ static double abs(double a) { return fabs(a); }
  __device__ static double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static bool isinf(double a) { return ::isinf(a); }
  __device__ static bool isfinite(double a) { return ::isfinite(a); }
  static constexpr double kEps = 2.220446049250313e-16;  // 2^-52
};

// NaN-propagating extrema, as torch.amin / amax / maximum.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}
// max(x, 0) that keeps a NaN, as torch.clamp_min.
template <typename T>
__device__ __forceinline__ T clamp0(T x) {
  return x < T(0) ? T(0) : x;
}

// ---- reductions ----------------------------------------------------------
// (v, i) absorbs (ov, oi): the larger (kMax) or smaller value, the lower
// index on equal values; a NaN wins with index kIntMax and stays.  That is
// "the first index where x == extremum(x)" of the twins: it finds none when
// the extremum is NaN.  Commutative and associative, so any tree order
// gives the same answer.  Identity: (-inf or +inf, kIntMax).
template <bool kMax, typename V>
__device__ __forceinline__ void arg_merge(V& v, int& i, V ov, int oi) {
  if (v != v) return;
  if (ov != ov) {
    v = ov;
    i = kIntMax;
    return;
  }
  if ((kMax ? ov > v : ov < v) || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <bool kMax, typename V>
__device__ __forceinline__ void warp_arg(V& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const V ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    arg_merge<kMax>(v, i, ov, oi);
  }
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, v, o);
    v = ov < v ? ov : v;
  }
  return v;
}

// Slots for the block reductions of one instance, in static shared memory:
// each reduction has its own, so none waits for the previous one's readers.
template <typename T>
struct Slots {
  T price_v[kWarps];
  int price_i[kWarps];
  int price_first[kWarps];
  T wmax[kWarps];
};

// Pricing's reduction over the block: (v, i) as arg_merge<kMax>, and the
// lowest eligible lane `first`.  One __syncthreads.
template <bool kMax, typename T>
__device__ __forceinline__ void block_price(T& v, int& i, int& first,
                                            Slots<T>& sl) {
  warp_arg<kMax>(v, i);
  first = warp_min_int(first);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sl.price_v[warp] = v;
    sl.price_i[warp] = i;
    sl.price_first[warp] = first;
  }
  __syncthreads();
  v = sl.price_v[0];
  i = sl.price_i[0];
  first = sl.price_first[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    arg_merge<kMax>(v, i, sl.price_v[k], sl.price_i[k]);
    first = sl.price_first[k] < first ? sl.price_first[k] : first;
  }
}

// NaN-propagating max over the block.  One __syncthreads.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  v = slot[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) v = nan_max(v, slot[k]);
  return v;
}

// ---- the instance's head ---------------------------------------------------
// What a block loads first, in one round trip: its instance's status,
// phase and Bland flag, and this thread's lane of the objective row (from
// global memory whether or not the tile is staged; the staged copy holds
// the same values).  A stopped instance's decision then waits on two more
// round trips, not four.
template <typename T>
struct Head {
  bool live, in_p1, bland;
  T obj0;
};

template <typename T>
__device__ __forceinline__ Head<T> load_head(const int32_t* status,
                                             const int32_t* phase,
                                             const uint8_t* bland,
                                             const T* Tb, int M, int N,
                                             int b) {
  const int32_t st = status[b];
  const int32_t ph = phase[b];
  const uint8_t bl = bland[b];
  const T obj0 = (int)threadIdx.x < N
                     ? Tb[(size_t)(M - 1) * N + threadIdx.x]
                     : T(0);
  return {st == kRunning, ph == 1, bl != 0, obj0};
}

// ---- shared-memory layout ------------------------------------------------
// Dynamic shared memory of one block: the pivot column (M), the normalised
// pivot row (N), per constraint row ub_B, the ratio-test value, the Harris
// value and a flag byte (M-1 each), then, when staged, the tile with 16
// bytes of slack so that it keeps its global base's offset modulo 16.
struct Layout {
  uint64_t col, prow, ubB, ratio, hv, flags, tile, total;
};

__host__ __device__ inline uint64_t up16(uint64_t x) {
  return (x + 15) & ~(uint64_t)15;
}

__host__ __device__ inline Layout layout(int64_t M, int64_t N, int64_t sz,
                                         bool staged) {
  Layout L;
  const int64_t R = M - 1;
  uint64_t o = 0;
  L.col = o;
  o = up16(o + M * sz);
  L.prow = o;
  o = up16(o + N * sz);
  L.ubB = o;
  o = up16(o + R * sz);
  L.ratio = o;
  o = up16(o + R * sz);
  L.hv = o;
  o = up16(o + R * sz);
  L.flags = o;
  o = up16(o + R);
  L.tile = o;
  if (staged) o += 16 + (uint64_t)(M * N * sz);
  L.total = o;
  return L;
}

// The block's views of its dynamic shared memory.
template <typename T>
struct Scratch {
  T* col;
  T* prow;
  T* ubB;
  T* ratio;
  T* hv;
  uint8_t* flags;
  unsigned char* tile;  // 16-byte aligned start of the tile region
};

template <typename T>
__device__ __forceinline__ Scratch<T> scratch(unsigned char* smem,
                                              const Layout& L) {
  return {reinterpret_cast<T*>(smem + L.col),
          reinterpret_cast<T*>(smem + L.prow),
          reinterpret_cast<T*>(smem + L.ubB),
          reinterpret_cast<T*>(smem + L.ratio),
          reinterpret_cast<T*>(smem + L.hv), smem + L.flags, smem + L.tile};
}

// ---- staging: TMA bulk copy or cp.async ----------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Where an instance's tile is staged and how its copy completes.
struct Stage {
  bool on;        // staged at all (RUNNING and small enough)
  bool bulk;      // one TMA bulk copy on `bar`; else cp.async
  uint64_t* bar;
  uint32_t parity;
};

// Start copying the n elements at src into the tile region; returns the
// tile (its address is src's modulo 16).  Thread 0 issues the bulk copy;
// for cp.async every thread takes its share.  `bar` must be initialised.
template <typename T>
__device__ __forceinline__ T* stage_begin(unsigned char* region, const T* src,
                                          int64_t n, Stage& st) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) % 16;
  T* tile = reinterpret_cast<T*>(region + mis);
  const int64_t bytes = n * (int64_t)sizeof(T);
  st.bulk = mis == 0 && bytes % 16 == 0;
  if (st.bulk) {
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(st.bar)),
          "r"((uint32_t)bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(tile)),
          "l"(src), "r"((uint32_t)bytes), "r"(smem_u32(st.bar))
          : "memory");
    }
    return tile;
  }
  constexpr int V = 16 / sizeof(T);
  int64_t head = mis ? (int64_t)((16 - mis) / sizeof(T)) : 0;
  if (head > n) head = n;
  const int64_t nvec = (n - head) / V;
  const int64_t tail0 = head + nvec * V;
  for (int64_t v = threadIdx.x; v < nvec; v += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(tile + head + v * V)),
                 "l"(src + head + v * V)
                 : "memory");
  const int64_t rest = head + (n - tail0);
  if (threadIdx.x < rest) {
    const int64_t e = threadIdx.x < head ? threadIdx.x
                                         : tail0 + (threadIdx.x - head);
    tile[e] = src[e];
  }
  return tile;
}

// Wait until the staged tile is in shared memory, for every thread.
__device__ __forceinline__ void stage_wait(const Stage& st) {
  if (!st.on) return;
  if (st.bulk) {
    while (!mbar_try_wait(st.bar, st.parity)) {
    }
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
}

// ---- write-back ----------------------------------------------------------
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
struct Native;
template <>
struct Native<float> {
  using type = float4;
};
template <>
struct Native<double> {
  using type = double2;
};

template <bool kGlobal, typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  using W = typename Native<T>::type;
  const W w = kGlobal ? __ldcs(reinterpret_cast<const W*>(p))
                      : *reinterpret_cast<const W*>(p);
  Vec<T> v;
  memcpy(&v, &w, sizeof(v));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  using W = typename Native<T>::type;
  W w;
  memcpy(&w, &v, sizeof(w));
  __stcs(reinterpret_cast<W*>(p), w);
}

// dst[k] = f(i, j, src[k]) for every k = i*N + j of an M x N tile, in
// 16-byte vectors from dst's first 16-byte boundary, with a scalar head
// and tail.  src is the staged tile (kGlobal false: same address as dst
// modulo 16) or dst itself (kGlobal true: the streamed update, in place;
// each element is read and then written by one thread).  Each thread
// keeps kUnroll vectors in flight.
template <bool kGlobal, typename T, typename F>
__device__ __forceinline__ void write_back(T* dst, const T* src, int M, int N,
                                           const F& f) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kUnroll = 4;
  const int64_t n = (int64_t)M * N;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) % 16;
  int64_t head = mis ? (int64_t)((16 - mis) / sizeof(T)) : 0;
  if (head > n) head = n;
  const int64_t nvec = (n - head) / V;
  const int64_t tail0 = head + nvec * V;
  const int tid = threadIdx.x;
  // (i, j) of this thread's first vector, and the step to its next one.
  const int64_t k0 = head + (int64_t)tid * V;
  int i = (int)(k0 / N), j = (int)(k0 % N);
  const int64_t stride = (int64_t)kThreads * V;
  const int di = (int)(stride / N), dj = (int)(stride % N);
  for (int64_t v0 = tid; v0 < nvec; v0 += (int64_t)kUnroll * kThreads) {
    Vec<T> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < nvec) x[u] = load_vec<kGlobal>(src + head + v * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + (int64_t)u * kThreads;
      if (v < nvec) {
        Vec<T> o;
        int ie = i, je = j;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o.v[e] = f(ie, je, x[u].v[e]);
          if (++je == N) {
            je = 0;
            ++ie;
          }
        }
        store_vec(dst + head + v * V, o);
      }
      i += di;
      j += dj;
      if (j >= N) {
        j -= N;
        ++i;
      }
    }
  }
  const int64_t rest = head + (n - tail0);
  if (tid < rest) {
    const int64_t e = tid < head ? tid : tail0 + (tid - head);
    dst[e] = f((int)(e / N), (int)(e % N), src[e]);
  }
}

// ---- launch --------------------------------------------------------------
// Lift `kernel`'s dynamic shared-memory cap to what the device allows, once
// per device; a launch that asks for more is then refused and its error
// returned by the launcher.
template <typename K>
cudaError_t allow_shared_memory(K kernel) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

}  // namespace
