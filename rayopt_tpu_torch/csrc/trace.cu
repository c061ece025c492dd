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
//    guarded square root below (NaN in, NaN out) relies on.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// packed row layout: keep in sync with cuda_trace.py (ROW, P_*)
constexpr int ROW = 17;
constexpr int P_C = 0;     // curvature
constexpr int P_K = 1;     // conic
constexpr int P_OFF = 2;   // offset x, y, z
constexpr int P_ROT = 5;   // rot, row-major 3x3
constexpr int P_RAD = 14;  // aperture radius
constexpr int P_MU = 15;   // refraction ratio
constexpr int P_NB = 16;   // index before the surface

// flag bits: keep in sync with cuda_trace.py (F_*)
constexpr int F_FLAT = 1;
constexpr int F_SPHERICAL = 2;
constexpr int F_ROTATED = 4;
constexpr int F_OFF_AXIS = 8;
constexpr int F_ALTERNATE = 16;
constexpr int F_FINITE = 32;
constexpr int KIND_SHIFT = 6;  // 2 bits: 0 pass, 1 refract, 2 mirror

template <typename T> __device__ __forceinline__ T qnan();
template <> __device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// sqrt(max(x, 0)) that lets NaN through (fmax would turn NaN into 0)
template <typename T> __device__ __forceinline__ T sqrt0(T x) {
  return sqrt(x < T(0) ? T(0) : x);
}

template <typename T> __device__ __forceinline__ T sgn(T x) {
  return T((x > T(0)) - (x < T(0)));
}

// v <- R v
template <typename T>
__device__ __forceinline__ void rot_apply(const T* r, T& x, T& y, T& z) {
  const T a = r[0] * x + r[1] * y + r[2] * z;
  const T b = r[3] * x + r[4] * y + r[5] * z;
  const T c = r[6] * x + r[7] * y + r[8] * z;
  x = a; y = b; z = c;
}

// v <- R^T v
template <typename T>
__device__ __forceinline__ void rot_apply_t(const T* r, T& x, T& y, T& z) {
  const T a = r[0] * x + r[3] * y + r[6] * z;
  const T b = r[1] * x + r[4] * y + r[7] * z;
  const T c = r[2] * x + r[5] * y + r[8] * z;
  x = a; y = b; z = c;
}

// One transfer-intercept-refract step: kernels.surface_step_spec for
// flat, spherical and conic rows.  State in and out in the global
// (from_normal) frame; adds the optical path n_before * t to tacc.
template <typename T>
__device__ __forceinline__ void surface_step(const T* p, int fl, bool clip,
                                             T& x, T& y, T& z, T& ux,
                                             T& uy, T& uz, T& tacc) {
  if (fl & F_OFF_AXIS) {
    x = x - p[P_OFF];
    y = y - p[P_OFF + 1];
  }
  z = z - p[P_OFF + 2];
  const bool rotated = fl & F_ROTATED;
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  const T c = p[P_C];
  const T k = p[P_K];
  // intercept_spec
  T t;
  if (fl & F_FLAT) {
    const T uz_safe = uz == T(0) ? T(1) : uz;
    t = -z / uz_safe;
  } else {
    const bool sph = fl & F_SPHERICAL;
    T uy_, uu, yy;
    if (sph) {
      uy_ = ux * x + uy * y + uz * z;
      uu = T(1);
      yy = x * x + y * y + z * z;
    } else {
      const T k1 = T(1) + k;
      uy_ = ux * x + uy * y + k1 * uz * z;
      uu = ux * ux + uy * uy + k1 * uz * uz;
      yy = x * x + y * y + k1 * z * z;
    }
    const T d = c * uy_ - uz;
    const T e = c * uu;
    const T f = c * yy - T(2) * z;
    const T disc = d * d - e * f;
    T g = sqrt0(disc);
    if (fl & F_ALTERNATE) g = -g;
    if (sph) {
      t = (d + g) * (T(-1) / c);
    } else if (e == T(0)) {
      t = f / (g == d ? T(1) : g - d);
    } else {
      t = -(d + g) / e;
    }
    if (disc < T(0)) t = qnan<T>();
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  const T z1 = z + t * uz;
  tacc = tacc + t * p[P_NB];
  // clip NaNs the INCOMING direction: the ray turns NaN one surface on
  T vx = ux, vy = uy, vz = uz;
  if (clip && (fl & F_FINITE)) {
    const T rad = p[P_RAD];
    if (x1 * x1 + y1 * y1 > rad * rad) vx = vy = vz = qnan<T>();
  }
  // refract_spec
  const int kind = (fl >> KIND_SHIFT) & 3;
  if (kind != 0) {
    const T mu = p[P_MU];
    const T muf = fabs(mu);
    if (fl & F_FLAT) {
      if (kind == 2) {
        vz = -vz;
      } else {
        const T a = muf * vz;
        const T disc = a * a - (mu * mu - T(1));
        T g = -a + sgn(mu) * sqrt0(disc);
        if (disc < T(0)) g = qnan<T>();
        vx = muf * vx;
        vy = muf * vy;
        vz = muf * vz + g;
      }
    } else {
      const T nx = -c * x1;
      const T ny = -c * y1;
      T nz, a, disc;
      if (fl & F_SPHERICAL) {
        nz = T(1) - c * z1;
        const T dot = vx * nx + vy * ny + vz * nz;
        a = muf * dot;
        if (kind == 2) a = T(2) * dot;
        disc = a * a - (mu * mu - T(1));
      } else {
        nz = T(1) - (T(1) + k) * c * z1;
        const T dot = vx * nx + vy * ny + vz * nz;
        const T ir2 = T(1) / (nx * nx + ny * ny + nz * nz);
        a = muf * dot * ir2;
        if (kind == 2) a = T(2) * dot * ir2;
        disc = a * a - (mu * mu - T(1)) * ir2;
      }
      if (kind == 2) {
        vx = vx - a * nx;
        vy = vy - a * ny;
        vz = vz - a * nz;
      } else {
        T g = -a + sgn(mu) * sqrt0(disc);
        if (disc < T(0)) g = qnan<T>();
        vx = muf * vx + g * nx;
        vy = muf * vy + g * ny;
        vz = muf * vz + g * nz;
      }
    }
  }
  x = x1; y = y1; z = z1;
  ux = vx; uy = vy; uz = vz;
  if (rotated) {
    rot_apply_t(p + P_ROT, x, y, z);
    rot_apply_t(p + P_ROT, ux, uy, uz);
  }
}

// The whole chain for one ray: row-0 from_normal, rows 1..S-1, then
// the last row's to_normal (pallas_trace.py:88-106).
template <typename T>
__device__ __forceinline__ void trace_ray(const T* tab, const int* flags,
                                          int nsurf, bool clip, T& x, T& y,
                                          T& z, T& ux, T& uy, T& uz,
                                          T& tacc) {
  if (flags[0] & F_ROTATED) {
    rot_apply_t(tab + P_ROT, x, y, z);
    rot_apply_t(tab + P_ROT, ux, uy, uz);
  }
  tacc = T(0);
  for (int j = 1; j < nsurf; ++j)
    surface_step(tab + j * ROW, flags[j], clip, x, y, z, ux, uy, uz, tacc);
  if (flags[nsurf - 1] & F_ROTATED) {
    const T* r = tab + (nsurf - 1) * ROW + P_ROT;
    rot_apply(r, x, y, z);
    rot_apply(r, ux, uy, uz);
  }
}

// Stage the packed table and flags into shared memory; returns the
// first free T slot after them.
template <typename T>
__device__ __forceinline__ T* stage_table(const T* table, const int* flags,
                                          int nsurf, T* s_tab, int* s_flags) {
  for (int i = threadIdx.x; i < nsurf * ROW; i += blockDim.x)
    s_tab[i] = table[i];
  for (int i = threadIdx.x; i < nsurf; i += blockDim.x)
    s_flags[i] = flags[i];
  __syncthreads();
  return s_tab + nsurf * ROW;
}

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
