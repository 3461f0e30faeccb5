// Variants of the streaming pass out = x + 1e-7f (float32), for
// tools/stream_variants.py, which times each against torch's add_ and the
// port's K4 on one card.  Measurement code only: the port's kernels use the
// one design that won (simplex_tpu_torch/csrc/stream_common.cuh).
//
//   tile<THREADS, VECS, CS>: each block owns one contiguous tile of
//     THREADS * VECS 16-byte vectors, loads before stores; CS uses the
//     streaming cache hints __ldcs / __stcs; grid one block a tile, or
//     (PERSISTENT) as many blocks as fit on the card at once, walking the
//     tiles in order;
//   gridstride<UNROLL>: the first port's K4, a persistent grid of 4 blocks
//     of 256 threads an SM, each thread's UNROLL vectors a grid-stride
//     apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 add4(float4 v, float c) {
  v.x = __fadd_rn(v.x, c);
  v.y = __fadd_rn(v.y, c);
  v.z = __fadd_rn(v.z, c);
  v.w = __fadd_rn(v.w, c);
  return v;
}

__device__ __forceinline__ void scalars(const float* x, float* out, int64_t n,
                                        int64_t head, int64_t nvec, float c) {
  const int64_t tail0 = head + nvec * 4;
  const int64_t rest = head + (n - tail0);
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < rest;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = k < head ? k : tail0 + (k - head);
    out[e] = __fadd_rn(x[e], c);
  }
}

template <int THREADS, int VECS, bool CS>
__global__ void __launch_bounds__(THREADS)
    tile_kernel(const float* x, float* out, int64_t n, int64_t head,
                int64_t nvec, float c) {
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  constexpr int64_t TILE = (int64_t)THREADS * VECS;
  for (int64_t t0 = (int64_t)blockIdx.x * TILE; t0 < nvec;
       t0 += (int64_t)gridDim.x * TILE) {
    float4 v[VECS];
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int64_t i = t0 + u * THREADS + threadIdx.x;
      if (i < nvec) v[u] = CS ? __ldcs(xv + i) : xv[i];
    }
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int64_t i = t0 + u * THREADS + threadIdx.x;
      if (i < nvec) {
        if (CS)
          __stcs(ov + i, add4(v[u], c));
        else
          ov[i] = add4(v[u], c);
      }
    }
  }
  scalars(x, out, n, head, nvec, c);
}

template <int UNROLL>
__global__ void __launch_bounds__(256)
    gridstride_kernel(const float* x, float* out, int64_t n, int64_t head,
                      int64_t nvec, float c) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  for (int64_t i0 = tid; i0 < nvec; i0 += stride * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < nvec) v[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < nvec) ov[i] = add4(v[u], c);
    }
  }
  scalars(x, out, n, head, nvec, c);
}

using Kernel = void (*)(const float*, float*, int64_t, int64_t, int64_t,
                        float);

struct Variant {
  const char* name;
  Kernel kernel;
  int threads;
  // > 0: vectors a tile, one block a tile; 0: as many blocks as are
  // resident at once; < 0: -tile_vecs blocks an SM
  int64_t tile_vecs;
};

const Variant kVariants[] = {
    {"tile 256x4", tile_kernel<256, 4, false>, 256, 1024},
    {"tile 256x8", tile_kernel<256, 8, false>, 256, 2048},
    {"tile 256x2", tile_kernel<256, 2, false>, 256, 512},
    {"tile 128x2", tile_kernel<128, 2, false>, 128, 256},
    {"tile 128x4", tile_kernel<128, 4, false>, 128, 512},
    {"tile 256x1", tile_kernel<256, 1, false>, 256, 256},
    {"tile 512x2", tile_kernel<512, 2, false>, 512, 1024},
    {"tile 256x4 cs", tile_kernel<256, 4, true>, 256, 1024},
    {"tile 256x8 cs", tile_kernel<256, 8, true>, 256, 2048},
    {"tile 256x2 cs", tile_kernel<256, 2, true>, 256, 512},
    {"tile 256x1 cs", tile_kernel<256, 1, true>, 256, 256},
    {"tile 128x2 cs", tile_kernel<128, 2, true>, 128, 256},
    {"tile 128x4 cs", tile_kernel<128, 4, true>, 128, 512},
    {"tile 512x2 cs", tile_kernel<512, 2, true>, 512, 1024},
    {"tile 256x4 persistent", tile_kernel<256, 4, false>, 256, 0},
    {"gridstride 4/SM x256 x4 (first K4)", gridstride_kernel<4>, 256, -4},
};
constexpr int kCount = sizeof(kVariants) / sizeof(kVariants[0]);

}  // namespace

extern "C" int variant_count() { return kCount; }

extern "C" const char* variant_name(int id) {
  return id >= 0 && id < kCount ? kVariants[id].name : "";
}

extern "C" int variant_f32(int id, const float* x, float* out, int64_t n,
                           void* stream) {
  if (id < 0 || id >= kCount || n <= 0) return (int)cudaErrorInvalidValue;
  const Variant& v = kVariants[id];
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ao = reinterpret_cast<uintptr_t>(out);
  int64_t head = n, nvec = 0;
  if (ax % 4 == 0 && (ax - ao) % 16 == 0) {
    head = (int64_t)(((16 - ax % 16) % 16) / 4);
    if (head > n) head = n;
    nvec = (n - head) / 4;
  }
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, v.kernel,
                                                        v.threads, 0);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks;
  if (v.tile_vecs > 0)
    blocks = (nvec + v.tile_vecs - 1) / v.tile_vecs;
  else if (v.tile_vecs == 0)
    blocks = (int64_t)sms * resident;
  else
    blocks = (int64_t)sms * -v.tile_vecs;
  const int64_t scalar_blocks = (n - nvec * 4 + v.threads - 1) / v.threads;
  if (blocks < scalar_blocks) blocks = scalar_blocks;
  if (blocks < 1) blocks = 1;
  v.kernel<<<(unsigned)blocks, v.threads, 0,
             reinterpret_cast<cudaStream_t>(stream)>>>(x, out, n, head, nvec,
                                                       1e-7f);
  return (int)cudaGetLastError();
}
