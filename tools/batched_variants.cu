// Variants of K2 and K3 for tools/batched_variants.py to time against the
// kernels as they ship:
//   * ring: a persistent grid (as many blocks as fit on the card, each
//     walking instances b, b + gridDim.x, ...) with a two-stage ring of
//     staged tiles, so that instance k+1's TMA copy is in flight while
//     instance k decides and writes;
//   * capped: K3's grid as it ships (one block an instance) with
//     __launch_bounds__(128, 11) or (128, 12), so that the compiler keeps
//     the registers low enough for 11 or 12 resident blocks an SM (the
//     shipped K3 takes 54 registers in float32, 9 blocks; K2 takes 40).
// The per-instance step is the shipped one (k2_instance / k3_instance of
// csrc/), included here; only the grid, the staging or the register cap
// differ.  Build: nvcc with the port's flags, -shared.
#include "../simplex_tpu_torch/csrc/fused_pivot_step.cu"
#include "../simplex_tpu_torch/csrc/fused_pivot_step_bounded.cu"

namespace {

// Bytes between the two tile regions of the ring.
inline uint64_t ring_stride(int64_t M, int64_t N, int64_t sz) {
  return up16(16 + (uint64_t)(M * N * sz));
}

// The ring around one instance step `body(b, head, src, st)`.
template <typename T, typename Args, typename Body>
__device__ __forceinline__ void ring(const Args& a, int B,
                                     unsigned char* tile0, uint64_t stride,
                                     uint64_t* bar, const Body& body) {
  unsigned char* region[2] = {tile0, tile0 + stride};
  uint32_t parity[2] = {0, 0};
  Stage st[2];
  Head<T> hd[2];
  const T* src[2];
  const int64_t n = (int64_t)a.M * a.N;
  auto begin = [&](int b, int k) {
    const T* Tb = a.tab + (size_t)b * n;
    hd[k] = load_head(a.status, a.phase, a.bland, Tb, a.M, a.N, b);
    st[k] = Stage{hd[k].live, false, &bar[k], parity[k]};
    src[k] = st[k].on ? stage_begin(region[k], Tb, n, st[k]) : Tb;
  };
  int k = 0;
  if ((int)blockIdx.x < B) begin(blockIdx.x, 0);
  for (int b = blockIdx.x; b < B; b += gridDim.x, k ^= 1) {
    if (b + (int)gridDim.x < B) begin(b + gridDim.x, k ^ 1);
    body(b, hd[k], src[k], st[k]);
    if (st[k].on && st[k].bulk) parity[k] ^= 1;
    // Every thread is done with tile k (generic proxy) before a TMA
    // copy (async proxy) refills it, and with the block's scratch.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k2_ring_kernel(const K2Args<T> a, const Layout L, int B,
                   uint64_t stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[2];
  __shared__ K2Shared<T> sh;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();
  const Scratch<T> sc = scratch<T>(smem, L);
  ring<T>(a, B, sc.tile, stride, bar,
          [&](int b, const Head<T>& h, const T* src, const Stage& st) {
            k2_instance(a, b, h, src, st, sc, sh);
          });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_ring_kernel(const K3Args<T> a, const Layout L, int B,
                   uint64_t stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[2];
  __shared__ K3Shared<T> sh;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();
  const Scratch<T> sc = scratch<T>(smem, L);
  ring<T>(a, B, sc.tile, stride, bar,
          [&](int b, const Head<T>& h, const T* src, const Stage& st) {
            k3_instance(a, b, h, src, st, sc, sh);
          });
}

// Grid and shared memory of a ring launch: two tiles, as many blocks as
// are resident on the card at once (at most B).
template <typename K>
int ring_launch_shape(K kernel, int64_t B, int64_t M, int64_t N, int64_t sz,
                      Layout* L, uint64_t* stride, unsigned* grid) {
  if ((uint64_t)(M * N * sz) > (uint64_t)kStageMaxBytes)
    return (int)cudaErrorInvalidValue;  // the ring stages every instance
  *L = layout(M, N, sz, true);
  *stride = ring_stride(M, N, sz);
  L->total = L->tile + 2 * *stride;
  cudaError_t e = allow_shared_memory(kernel);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    (size_t)L->total);
  if (e != cudaSuccess) return (int)e;
  int64_t g = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(g < B ? g : B);
  return 0;
}

}  // namespace

extern "C" int k3_ring_f32(float* tab, int64_t B, int64_t M, int64_t N,
                           int32_t* basis, uint8_t* at_upper,
                           const uint8_t* cm1, const uint8_t* cm2,
                           const int32_t* phase, const int32_t* status,
                           const uint8_t* bland, float* w, const float* ub,
                           float* ub_B, uint8_t* is_art_row,
                           const uint8_t* art_mask, float tol, int devex,
                           int with_art, int32_t* s_out, int32_t* r_out,
                           uint8_t* opt_out, uint8_t* unb_out,
                           uint8_t* mov_out, void* stream) {
  Layout L;
  uint64_t stride;
  unsigned grid;
  int e = ring_launch_shape(k3_ring_kernel<float>, B, M, N, 4, &L, &stride,
                            &grid);
  if (e) return e;
  const K3Args<float> a{tab,  (int)M,     (int)N,   basis, at_upper, cm1,
                        cm2,  phase,      status,   bland, w,        ub,
                        ub_B, is_art_row, art_mask, tol,   devex,    with_art,
                        s_out, r_out,     opt_out,  unb_out, mov_out};
  k3_ring_kernel<float><<<grid, kThreads, (size_t)L.total,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      a, L, (int)B, stride);
  return (int)cudaGetLastError();
}

extern "C" int k2_ring_f32(float* tab, int64_t B, int64_t M, int64_t N,
                           int32_t* basis, const uint8_t* cm1,
                           const uint8_t* cm2, const int32_t* phase,
                           const int32_t* status, const uint8_t* bland,
                           float* w, float tol, int devex, int32_t* s_out,
                           int32_t* r_out, uint8_t* opt_out, uint8_t* unb_out,
                           uint8_t* did_out, void* stream) {
  Layout L;
  uint64_t stride;
  unsigned grid;
  int e = ring_launch_shape(k2_ring_kernel<float>, B, M, N, 4, &L, &stride,
                            &grid);
  if (e) return e;
  const K2Args<float> a{tab,   (int)M, (int)N, basis, cm1,   cm2,
                        phase, status, bland,  w,     tol,   devex,
                        s_out, r_out,  opt_out, unb_out, did_out};
  k2_ring_kernel<float><<<grid, kThreads, (size_t)L.total,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      a, L, (int)B, stride);
  return (int)cudaGetLastError();
}

template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    k3_capped_kernel(const K3Args<T> a, const Layout L, int stage) {
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

template <int kMinBlocks>
int k3_capped(float* tab, int64_t B, int64_t M, int64_t N, int32_t* basis,
              uint8_t* at_upper, const uint8_t* cm1, const uint8_t* cm2,
              const int32_t* phase, const int32_t* status,
              const uint8_t* bland, float* w, const float* ub, float* ub_B,
              uint8_t* is_art_row, const uint8_t* art_mask, float tol,
              int devex, int with_art, int32_t* s_out, int32_t* r_out,
              uint8_t* opt_out, uint8_t* unb_out, uint8_t* mov_out,
              void* stream) {
  const bool stage = (uint64_t)(M * N * 4) <= (uint64_t)kStageMaxBytes;
  const Layout L = layout(M, N, 4, stage);
  const cudaError_t e =
      allow_shared_memory(k3_capped_kernel<float, kMinBlocks>);
  if (e != cudaSuccess) return (int)e;
  const K3Args<float> a{tab,  (int)M,     (int)N,   basis, at_upper, cm1,
                        cm2,  phase,      status,   bland, w,        ub,
                        ub_B, is_art_row, art_mask, tol,   devex,    with_art,
                        s_out, r_out,     opt_out,  unb_out, mov_out};
  k3_capped_kernel<float, kMinBlocks>
      <<<(unsigned)B, kThreads, (size_t)L.total,
         reinterpret_cast<cudaStream_t>(stream)>>>(a, L, stage ? 1 : 0);
  return (int)cudaGetLastError();
}

#define K3_CAPPED_ENTRY(NAME, MIN)                                           \
  extern "C" int NAME(float* tab, int64_t B, int64_t M, int64_t N,           \
                      int32_t* basis, uint8_t* at_upper, const uint8_t* cm1, \
                      const uint8_t* cm2, const int32_t* phase,              \
                      const int32_t* status, const uint8_t* bland, float* w, \
                      const float* ub, float* ub_B, uint8_t* is_art_row,     \
                      const uint8_t* art_mask, float tol, int devex,         \
                      int with_art, int32_t* s_out, int32_t* r_out,          \
                      uint8_t* opt_out, uint8_t* unb_out, uint8_t* mov_out,  \
                      void* stream) {                                        \
    return k3_capped<MIN>(tab, B, M, N, basis, at_upper, cm1, cm2, phase,    \
                          status, bland, w, ub, ub_B, is_art_row, art_mask,  \
                          tol, devex, with_art, s_out, r_out, opt_out,       \
                          unb_out, mov_out, stream);                         \
  }
K3_CAPPED_ENTRY(k3_capped11_f32, 11)
K3_CAPPED_ENTRY(k3_capped12_f32, 12)

// Registers a thread of each float32 kernel takes: 0 shipped K2, 1 shipped
// K3, 2 K2 ring, 3 K3 ring, 4 K3 capped at 11 blocks, 5 at 12.
extern "C" int kernel_registers(int which) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaErrorInvalidValue;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&attr, fused_pivot_step_kernel<float>);
      break;
    case 1:
      e = cudaFuncGetAttributes(&attr, fused_pivot_step_bounded_kernel<float>);
      break;
    case 2: e = cudaFuncGetAttributes(&attr, k2_ring_kernel<float>); break;
    case 3: e = cudaFuncGetAttributes(&attr, k3_ring_kernel<float>); break;
    case 4: e = cudaFuncGetAttributes(&attr, k3_capped_kernel<float, 11>);
      break;
    case 5: e = cudaFuncGetAttributes(&attr, k3_capped_kernel<float, 12>);
      break;
  }
  return e == cudaSuccess ? attr.numRegs : -(int)e;
}

// How many blocks a ring launch of this shape runs (for the report).
extern "C" int ring_grid(int bounded, int64_t B, int64_t M, int64_t N) {
  Layout L;
  uint64_t stride;
  unsigned grid = 0;
  const int e =
      bounded ? ring_launch_shape(k3_ring_kernel<float>, B, M, N, 4, &L,
                                  &stride, &grid)
              : ring_launch_shape(k2_ring_kernel<float>, B, M, N, 4, &L,
                                  &stride, &grid);
  return e ? -e : (int)grid;
}
