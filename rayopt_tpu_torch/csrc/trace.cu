// Fused sequential ray trace (K1) and fused spot-moment merit (K2) for
// NVIDIA Hopper (sm_90a), templated on float and double.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  rayopt_tpu/ops/pallas_trace.py  _trace_kernel           (pallas_trace_final)
//   K2  rayopt_tpu/ops/pallas_trace.py  _merit_kernel + _moment_row (pallas_trace_merit)
// and computes, ray for ray, what rayopt_tpu_torch.ops.kernels
// .surface_step_spec computes (the plain versions live beside the
// wrappers in rayopt_tpu_torch/ops/cuda_trace.py).
//
// What bounds it on the H100.  Each ray reads 6 words and (K1) writes
// 7; each of the ~12 traced surfaces costs ~60 flops.  In float32 that
// is ~12*60 flops per 28 bytes read (52 with K1's writes), ~25
// flop/byte, against 67 TFLOP/s / 3.35 TB/s = 20 for the card: the
// float32 trace sits near the ridge, so neither the ALUs nor HBM may be
// wasted.  In float64 (67 -> ~34 TFLOP/s of FP64 FMA, 2x the bytes)
// it is ALU bound.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop, structure-of-arrays
//    components: every load and store is coalesced, each ray is read
//    from and written to HBM exactly once whatever the depth, and no
//    intermediate state leaves registers (the single-pass property the
//    TPU kernel got from VMEM residency).
//  * The surface table (17 words a row) and one int32 of static
//    SurfaceSpec flags a row are staged once per block into shared
//    memory; every thread reads the same address (a broadcast), and
//    the flags are uniform across the warp, so branching on them costs
//    no divergence.  Emitting straight-line code per spec tuple (as the
//    TPU kernel's static unroll does) is left to later work.
//  * K2 never writes per-ray output: each thread accumulates its rays'
//    five moments, a shared-memory tree reduces the block, and the
//    block's partial sums go to a (grid, 5) tensor that the caller sums
//    (no float atomics: the result is deterministic for a given grid).
//  * IEEE division and square root, no fast math: vignetted rays are
//    NaN and must stay NaN through every later surface, which the
//    guarded square root (trace_common.cuh; NaN in, NaN out) relies on.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "trace_common.cuh"

namespace {

template <typename T>
__global__ void trace_final_kernel(const T* __restrict__ table,
                                   const int* __restrict__ flags, int nsurf,
                                   int clip, const T* __restrict__ ix,
                                   const T* __restrict__ iy,
                                   const T* __restrict__ iz,
                                   const T* __restrict__ iux,
                                   const T* __restrict__ iuy,
                                   const T* __restrict__ iuz,
                                   T* __restrict__ ox, T* __restrict__ oy,
                                   T* __restrict__ oz, T* __restrict__ oux,
                                   T* __restrict__ ouy, T* __restrict__ ouz,
                                   T* __restrict__ ot, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  int* s_flags = reinterpret_cast<int*>(s_tab + nsurf * ROW);
  stage_table(table, flags, nsurf, s_tab, s_flags);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T x = ix[i], y = iy[i], z = iz[i];
    T ux = iux[i], uy = iuy[i], uz = iuz[i];
    T tacc;
    trace_ray(s_tab, s_flags, nsurf, clip != 0, x, y, z, ux, uy, uz, tacc);
    ox[i] = x; oy[i] = y; oz[i] = z;
    oux[i] = ux; ouy[i] = uy; ouz[i] = uz;
    ot[i] = tacc;
  }
}

template <typename T>
__global__ void trace_merit_kernel(const T* __restrict__ table,
                                   const int* __restrict__ flags, int nsurf,
                                   int clip, const T* __restrict__ ix,
                                   const T* __restrict__ iy,
                                   const T* __restrict__ iz,
                                   const T* __restrict__ iux,
                                   const T* __restrict__ iuy,
                                   const T* __restrict__ iuz,
                                   T* __restrict__ partials, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_red = s_tab + nsurf * ROW;                  // 5 * blockDim.x
  int* s_flags = reinterpret_cast<int*>(s_red + 5 * blockDim.x);
  stage_table(table, flags, nsurf, s_tab, s_flags);
  T m[5] = {T(0), T(0), T(0), T(0), T(0)};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T x = ix[i], y = iy[i], z = iz[i];
    T ux = iux[i], uy = iuy[i], uz = iuz[i];
    T tacc;
    trace_ray(s_tab, s_flags, nsurf, clip != 0, x, y, z, ux, uy, uz, tacc);
    if (isfinite(x) && isfinite(y) && isfinite(uz)) {
      m[0] += T(1);
      m[1] += x;
      m[2] += y;
      m[3] += x * x;
      m[4] += y * y;
    }
  }
  // block tree reduction (blockDim.x is a power of two)
  for (int q = 0; q < 5; ++q) s_red[q * blockDim.x + threadIdx.x] = m[q];
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      for (int q = 0; q < 5; ++q)
        s_red[q * blockDim.x + threadIdx.x] +=
            s_red[q * blockDim.x + threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x < 5)
    partials[int64_t(blockIdx.x) * 5 + threadIdx.x] =
        s_red[threadIdx.x * blockDim.x];
}

size_t final_smem(int nsurf, size_t word) {
  return nsurf * ROW * word + nsurf * sizeof(int);
}

size_t merit_smem(int nsurf, int block, size_t word) {
  return (nsurf * ROW + 5 * size_t(block)) * word + nsurf * sizeof(int);
}

}  // namespace

#define TRACE_FINAL_LAUNCHER(NAME, T)                                         \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int clip, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      void* ox, void* oy, void* oz, void* oux, void* ouy,    \
                      void* ouz, void* ot, long long n, int grid, int block, \
                      void* stream) {                                        \
    trace_final_kernel<T>                                                    \
        <<<grid, block, final_smem(nsurf, sizeof(T)),                        \
           static_cast<cudaStream_t>(stream)>>>(                             \
            static_cast<const T*>(table), static_cast<const int*>(flags),    \
            nsurf, clip, static_cast<const T*>(x),                           \
            static_cast<const T*>(y), static_cast<const T*>(z),              \
            static_cast<const T*>(ux), static_cast<const T*>(uy),            \
            static_cast<const T*>(uz), static_cast<T*>(ox),                  \
            static_cast<T*>(oy), static_cast<T*>(oz), static_cast<T*>(oux),  \
            static_cast<T*>(ouy), static_cast<T*>(ouz), static_cast<T*>(ot), \
            int64_t(n));                                                     \
    return int(cudaGetLastError());                                          \
  }

#define TRACE_MERIT_LAUNCHER(NAME, T)                                         \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int clip, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      void* partials, long long n, int grid, int block,      \
                      void* stream) {                                        \
    if (block <= 0 || (block & (block - 1))) return int(cudaErrorInvalidValue); \
    trace_merit_kernel<T>                                                    \
        <<<grid, block, merit_smem(nsurf, block, sizeof(T)),                 \
           static_cast<cudaStream_t>(stream)>>>(                             \
            static_cast<const T*>(table), static_cast<const int*>(flags),    \
            nsurf, clip, static_cast<const T*>(x),                           \
            static_cast<const T*>(y), static_cast<const T*>(z),              \
            static_cast<const T*>(ux), static_cast<const T*>(uy),            \
            static_cast<const T*>(uz), static_cast<T*>(partials),            \
            int64_t(n));                                                     \
    return int(cudaGetLastError());                                          \
  }

TRACE_FINAL_LAUNCHER(trace_final_f32, float)
TRACE_FINAL_LAUNCHER(trace_final_f64, double)
TRACE_MERIT_LAUNCHER(trace_merit_f32, float)
TRACE_MERIT_LAUNCHER(trace_merit_f64, double)

extern "C" const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
