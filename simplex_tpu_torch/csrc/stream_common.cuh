// The streaming skeleton shared by K1 (pivot_update.cu) and K4
// (stream_copy.cu): one read and one write of every element of a flat
// contiguous array, with an elementwise function in between, for Hopper
// (sm_90a).
//
// Both kernels are bound by bytes (each element read once and written
// once), so the skeleton exists to keep HBM busy:
//   * 16-byte vectors (float4 / double2) wherever the array allows them,
//     whatever its length or row width: a scalar head runs up to the first
//     16-byte boundary of x, then whole vectors, then a scalar tail; only
//     where x and out are misaligned against each other by other than a
//     whole vector does every element take the scalar loop;
//   * one vector a thread and one block of kThreads threads for each 4 KB
//     tile, neighbouring threads on neighbouring vectors: an oversubscribed
//     grid of short blocks, as torch's own elementwise loop, so each block
//     touches one stretch of DRAM and a finished block frees its slot at
//     once (a block walks further tiles only if the grid had to be capped);
//   * streaming cache hints (ld.global.cs / st.global.cs): no byte of the
//     array is used twice, so its lines go first and the small side
//     buffers a function reads (K1's pivot row and column) stay cached;
//   * the per-element function is a functor with two members:
//     `Vec<T> vec(Vec<T> v, int64_t k)` for the vector whose first element
//     has flat index k, and `T one(T v, int64_t k)` for a scalar;
//   * 64-bit indices, so arrays above 2^31 elements work.
// tools/stream_variants.py timed the alternatives against torch's add_ on
// the card (tiles of 2, 4 and 8 vectors a thread, 128 and 512 threads,
// no cache hints, persistent grids); PERF.md has their rates.
// In place (out == x) each element is read and written by the same thread,
// its load before its store, so no store can pass a load that aliases it.
// Nothing is allocated and nothing is synchronised.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace stream {

constexpr int kThreads = 256;

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
struct Native;  // the CUDA vector type of a Vec<T>, for the cache hints
template <>
struct Native<float> {
  using type = float4;
};
template <>
struct Native<double> {
  using type = double2;
};

template <typename T>
__device__ __forceinline__ Vec<T> load_cs(const Vec<T>* p) {
  using V = typename Native<T>::type;
  const V w = __ldcs(reinterpret_cast<const V*>(p));
  Vec<T> v;
  memcpy(&v, &w, sizeof(v));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_cs(Vec<T>* p, const Vec<T>& v) {
  using V = typename Native<T>::type;
  V w;
  memcpy(&w, &v, sizeof(w));
  __stcs(reinterpret_cast<V*>(p), w);
}

// How one pass is cut: `head` scalars before the first whole vector,
// `nvec` vectors, the tail after them, and the blocks to launch.
struct Plan {
  int64_t head;
  int64_t nvec;
  unsigned blocks;
};

template <typename T>
inline Plan plan(const T* x, const T* out, int64_t n) {
  constexpr int64_t VEC = Vec<T>::N;
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out);
  Plan p{n, 0, 1};
  if (ax % sizeof(T) == 0 && (ax - ao) % 16 == 0) {
    p.head = (int64_t)(((16 - ax % 16) % 16) / sizeof(T));
    if (p.head > n) p.head = n;
    p.nvec = (n - p.head) / VEC;
  }
  // Vectors, or the scalars where there are more of those.
  const int64_t rest = n - p.nvec * VEC;
  const int64_t work = p.nvec > rest ? p.nvec : rest;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  p.blocks = (unsigned)blocks;
  return p;
}

// The pass itself, for a kernel launched with plan(x, out, n).blocks
// blocks of kThreads threads.
template <typename T, typename F>
__device__ __forceinline__ void pass(const T* x, T* out, int64_t n,
                                     int64_t head, int64_t nvec, const F& f) {
  constexpr int64_t VEC = Vec<T>::N;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + head);
  Vec<T>* ov = reinterpret_cast<Vec<T>*>(out + head);
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = first; i < nvec; i += stride)
    store_cs(ov + i, f.vec(load_cs(xv + i), head + i * VEC));
  // The scalars: the head [0, head) and the tail [head + nvec * VEC, n).
  const int64_t tail0 = head + nvec * VEC;
  const int64_t rest = head + (n - tail0);
  for (int64_t k = first; k < rest; k += stride) {
    const int64_t e = k < head ? k : tail0 + (k - head);
    out[e] = f.one(x[e], e);
  }
}

}  // namespace stream
