// Device code shared by the kernels specialized per spec tuple
// (grad_spec.cuh: K1-K9) and the df32 kernels (df32_common.cuh: the NaN,
// the compile-time flags, the grid-wide sum's last block and the
// shared-memory opt-in): the packed table layout, the flag bits, the
// guarded math, one surface step with its row flags as compile-time
// constants, the compile-time loop and the last block of a fused
// grid-wide sum.  Each translation unit that includes it gets its own
// internal copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

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

// v <- R v (r: the row's 9 rotation words; a plain or a volatile
// pointer, see surface_step)
template <typename R, typename T>
__device__ __forceinline__ void rot_apply(R r, T& x, T& y, T& z) {
  const T a = r[0] * x + r[1] * y + r[2] * z;
  const T b = r[3] * x + r[4] * y + r[5] * z;
  const T c = r[6] * x + r[7] * y + r[8] * z;
  x = a; y = b; z = c;
}

// v <- R^T v
template <typename R, typename T>
__device__ __forceinline__ void rot_apply_t(R r, T& x, T& y, T& z) {
  const T a = r[0] * x + r[3] * y + r[6] * z;
  const T b = r[1] * x + r[4] * y + r[7] * z;
  const T c = r[2] * x + r[5] * y + r[8] * z;
  x = a; y = b; z = c;
}

// A row's flags: the value of a std::integral_constant (a compile-time
// constant; its operator int is host-only without
// --expt-relaxed-constexpr).
template <int F>
__device__ __forceinline__ constexpr int flag_value(
    std::integral_constant<int, F>) {
  return F;
}

// One transfer-intercept-refract step: kernels.surface_step_spec for
// flat, spherical and conic rows.  State in and out in the global
// (from_normal) frame; adds the optical path n_before * t to tacc.
// The row's flags arrive as std::integral_constant<int, F> (K1-K9,
// grad_spec.cuh): every `fl & F_*` below is a constant and the branches
// it does not take fold away.  p, the row's packed words in shared
// memory, is a volatile pointer (the unrolled rows would otherwise hoist
// every row's words into registers for the whole grid-stride loop),
// read where each word is used.
template <typename T, typename Flags, typename Row = const T*>
__device__ __forceinline__ void surface_step(Row p, Flags flags, bool clip,
                                             T& x, T& y, T& z, T& ux,
                                             T& uy, T& uz, T& tacc) {
  const int fl = flag_value(flags);
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
    // the cancellation-free pair of intercept_spec: f / (g - d) where d
    // and g differ in sign or e == 0, else -(d + g) / e; one division
    const bool conj = d * g <= T(0) || e == T(0);
    T den = conj ? g - d : e;
    if (den == T(0)) den = T(1);
    t = (conj ? f : -(d + g)) / den;
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

// f(std::integral_constant<int, I>{}) for each I of the sequence, in order
template <typename F, int... I>
__device__ __forceinline__ void static_for(std::integer_sequence<int, I...>,
                                           F&& f) {
  (f(std::integral_constant<int, I>{}), ...);
}

// True in the last block to finish, once every block has written its
// partial sums (made visible by the fence).  Every thread of the block
// must call it; the last block resets the counter when it is done.
__device__ __forceinline__ bool last_block(unsigned int* counter) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  return s_last;
}

// Opt a kernel in to `bytes` of dynamic shared memory (Hopper: up to
// 227 KB a block).  Set below 48 KB too: a kernel's static shared
// memory counts against the same default limit.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (!bytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// Resident blocks of `kernel` an SM at `block` threads and `smem` bytes
// of dynamic shared memory (the occupancy calculator).
template <typename K>
__host__ inline int blocks_per_sm(K kernel, int block, size_t smem,
                                  int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, block,
                                                           smem));
}

}  // namespace
