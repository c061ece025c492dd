// Differentiable spot-RMS merit for NVIDIA Hopper (sm_90a), templated on
// float and double: the weighted-moment forward (K4) and its analytic
// adjoint (K5), and their polychromatic twins over a wavelength stack
// of tables (K6, K7).
//
// Replaces the JAX package's Pallas TPU kernels
//   K4  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel           (_moments_impl)
//   K5  rayopt_tpu/ops/pallas_grad.py  _adjoint_kernel       (_moments_bwd)
//   K6  rayopt_tpu/ops/pallas_grad.py  _fwd_kernel_multi     (_moments_multi_impl)
//   K7  rayopt_tpu/ops/pallas_grad.py  _adjoint_kernel_multi (_moments_multi_bwd)
// The plain versions, and a torch model of K5's and K7's reverse written
// line for line (_step_vjp_reference, _merit_adjoint_by_hand,
// _merit_adjoint_multi_by_hand), live beside the wrappers in
// rayopt_tpu_torch/ops/cuda_grad.py.
//
// What bounds them on the H100.  K4 is K2 with one more input stream
// (the weight): 7 words read a ray, nothing written, bound by instruction
// throughput like K2.
// K5 traces each ray twice (the forward recompute and, inside each row's
// reverse, the row's own intercept and normal again) and runs a reverse
// of ~3x the forward's flops; it reads 7 words and writes 7 a ray.  It
// keeps the state entering every row (6 words a row) in a per-thread
// array that the compiler places in local memory (L1, spilling to L2):
// that traffic, not HBM, is its expected bound.
//
// What the design does about it.
//  * One thread per ray, a grid-stride loop over structure-of-arrays
//    components: coalesced loads and stores, each ray read once by each
//    kernel, no per-surface residual ever written to HBM (the TPU
//    kernel's VMEM-only recompute, here per thread).
//  * A dead ray (non-finite final local x, y or uz) skips its reverse
//    sweep and writes exact zeros: every cotangent of a dead ray is
//    zero in the reference too, so the TPU kernel's per-tile donor
//    substitution (which only kept NaN out of jax.vjp) is not needed.
//  * Parameter cotangents (6 a row: curvature, conic, offset x, y, z,
//    mu) are summed without float atomics: after each row a warp-shuffle
//    sum, lane 0 adds it into its warp's row of shared memory, and at
//    the end the block sums its warps in a fixed order and writes one
//    (grid, rows*6) partial that the caller sums.  Deterministic for a
//    given grid.
//  * The moment cotangents arrive as a device (5,) tensor: no host sync.
//  * IEEE division and square root, no fast math.
//
// K6 and K7 read each ray (and its weight) once into registers and run
// K4's / K5's chain once per table of the stack (all staged together in
// shared memory, sharing the first wavelength's flags).  K6 keeps each
// thread's per-wavelength moments in its own shared-memory column and
// writes (grid, nlam, 5) partials.  K7 reuses one saved-state array for
// every wavelength (the states die after each chain's reverse sweep, as
// on the TPU), judges a ray dead or live per wavelength, sums its seven
// ray and weight cotangents over the wavelengths in registers and
// writes them once, and keeps the parameter cotangents per wavelength:
// (grid, nlam * rows * 6) partials from per-warp rows of dynamic shared
// memory.  The rays are read once for all wavelengths, but the chains,
// which bound K4/K5 on this card, run nlam times: expect ~nlam x K4/K5.
//
// Interface: plain extern "C" launchers, loaded with ctypes; each
// launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

#include "trace_common.cuh"

namespace {

constexpr int MAX_ROWS = 32;  // rows a K5 thread keeps: cuda_grad.MAX_ROWS
constexpr int SLOTS = 6;      // parameter cotangents a row: cuda_grad.SLOTS
constexpr int MAX_BLOCK = 256;

// Hand-derived reverse of surface_step (trace_common.cuh) for one live
// ray.  s: the state entering the row (global frame).  g: in, the
// cotangent of the state leaving the row; out, the cotangent of s.
// pg: out, the row's parameter cotangents (c, k, offset x, y, z, mu).
// The aperture clip is a constant mask: a clipped ray is dead.
template <typename T>
__device__ __forceinline__ void surface_step_vjp(const T* p, int fl,
                                                 const T* s, T* g, T* pg) {
  const bool off_axis = fl & F_OFF_AXIS;
  const bool rotated = fl & F_ROTATED;
  const bool flat = fl & F_FLAT;
  const bool sph = fl & F_SPHERICAL;
  const int kind = (fl >> KIND_SHIFT) & 3;
  const T c = p[P_C];
  const T k = p[P_K];
  const T mu = p[P_MU];
  T x = s[0], y = s[1], z = s[2], ux = s[3], uy = s[4], uz = s[5];
  // ---- forward recompute ----
  if (off_axis) {
    x = x - p[P_OFF];
    y = y - p[P_OFF + 1];
  }
  z = z - p[P_OFF + 2];
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  T t, uzs = T(1), k1 = T(1), uyd = T(0), uu = T(1), yy = T(0);
  T d = T(0), e = T(0), f = T(0), sq = T(0), q = T(0), den = T(1);
  if (flat) {
    uzs = uz == T(0) ? T(1) : uz;
    t = -z / uzs;
  } else {
    if (sph) {
      uyd = ux * x + uy * y + uz * z;
      yy = x * x + y * y + z * z;
    } else {
      k1 = T(1) + k;
      uyd = ux * x + uy * y + k1 * uz * z;
      uu = ux * ux + uy * uy + k1 * uz * uz;
      yy = x * x + y * y + k1 * z * z;
    }
    d = c * uyd - uz;
    e = c * uu;
    f = c * yy - T(2) * z;
    sq = sqrt0(d * d - e * f);
    q = sg * sq;
    if (sph) {
      t = (d + q) * (T(-1) / c);
    } else if (e == T(0)) {
      den = q == d ? T(1) : q - d;
      t = f / den;
    } else {
      t = -(d + q) / e;
    }
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  const T z1 = z + t * uz;
  // ---- reverse: leave the row's frame ----
  T gx1 = g[0], gy1 = g[1], gz1 = g[2], gvx = g[3], gvy = g[4], gvz = g[5];
  if (rotated) {
    rot_apply(p + P_ROT, gx1, gy1, gz1);
    rot_apply(p + P_ROT, gvx, gvy, gvz);
  }
  T gc = T(0), gk = T(0), gmu = T(0), gux, guy, guz;
  // ---- reverse: refraction ----
  if (kind == 0) {
    gux = gvx; guy = gvy; guz = gvz;
  } else if (flat && kind == 2) {
    gux = gvx; guy = gvy; guz = -gvz;
  } else if (flat) {
    const T muf = fabs(mu);
    const T sgmu = sgn(mu);
    const T a = muf * uz;
    const T sq2 = sqrt0(a * a - (mu * mu - T(1)));
    T gmuf = ux * gvx + uy * gvy + uz * gvz;
    gux = muf * gvx; guy = muf * gvy; guz = muf * gvz;
    const T gq2 = gvz;
    const T gdisc2 = gq2 * sgmu * T(0.5) / sq2;
    const T ga = -gq2 + T(2) * a * gdisc2;
    gmu = -T(2) * mu * gdisc2;
    gmuf = gmuf + uz * ga;
    guz = guz + muf * ga;
    gmu = gmu + sgmu * gmuf;
  } else {
    const T kc = sph ? c : (T(1) + k) * c;
    const T nx = -c * x1;
    const T ny = -c * y1;
    const T nz = T(1) - kc * z1;
    const T dot = ux * nx + uy * ny + uz * nz;
    const T ir2 = sph ? T(1) : T(1) / (nx * nx + ny * ny + nz * nz);
    T gir2 = T(0), gdot, gnx, gny, gnz;
    if (kind == 2) {
      const T a2 = sph ? T(2) * dot : T(2) * dot * ir2;
      gux = gvx; guy = gvy; guz = gvz;
      gnx = -a2 * gvx; gny = -a2 * gvy; gnz = -a2 * gvz;
      const T ga2 = -(gvx * nx + gvy * ny + gvz * nz);
      if (sph) {
        gdot = T(2) * ga2;
      } else {
        gdot = T(2) * ir2 * ga2;
        gir2 = T(2) * dot * ga2;
      }
    } else {
      const T muf = fabs(mu);
      const T sgmu = sgn(mu);
      T a, disc2;
      if (sph) {
        a = muf * dot;
        disc2 = a * a - (mu * mu - T(1));
      } else {
        a = muf * dot * ir2;
        disc2 = a * a - (mu * mu - T(1)) * ir2;
      }
      const T sq2 = sqrt0(disc2);
      const T q2 = -a + sgmu * sq2;
      T gmuf = ux * gvx + uy * gvy + uz * gvz;
      gux = muf * gvx; guy = muf * gvy; guz = muf * gvz;
      const T gq2 = gvx * nx + gvy * ny + gvz * nz;
      gnx = q2 * gvx; gny = q2 * gvy; gnz = q2 * gvz;
      const T gdisc2 = gq2 * sgmu * T(0.5) / sq2;
      const T ga = -gq2 + T(2) * a * gdisc2;
      if (sph) {
        gmu = -T(2) * mu * gdisc2;
        gmuf = gmuf + dot * ga;
        gdot = muf * ga;
      } else {
        gmu = -T(2) * mu * ir2 * gdisc2;
        gir2 = -(mu * mu - T(1)) * gdisc2 + muf * dot * ga;
        gmuf = gmuf + dot * ir2 * ga;
        gdot = muf * ir2 * ga;
      }
      gmu = gmu + sgmu * gmuf;
    }
    gux = gux + gdot * nx; guy = guy + gdot * ny; guz = guz + gdot * nz;
    gnx = gnx + gdot * ux; gny = gny + gdot * uy; gnz = gnz + gdot * uz;
    if (!sph) {
      const T s2 = -T(2) * ir2 * ir2 * gir2;
      gnx = gnx + s2 * nx; gny = gny + s2 * ny; gnz = gnz + s2 * nz;
      gk = gk - c * z1 * gnz;
    }
    const T zc = sph ? z1 : (T(1) + k) * z1;
    gc = gc - x1 * gnx - y1 * gny - zc * gnz;
    gx1 = gx1 - c * gnx; gy1 = gy1 - c * gny; gz1 = gz1 - kc * gnz;
  }
  // ---- reverse: transfer x1 = x + t u ----
  T gx = gx1, gy = gy1, gz = gz1;
  gux = gux + t * gx1; guy = guy + t * gy1; guz = guz + t * gz1;
  const T gt = ux * gx1 + uy * gy1 + uz * gz1;
  // ---- reverse: intercept ----
  if (flat) {
    gz = gz - gt / uzs;
    if (uz != T(0)) guz = guz + gt * z / (uzs * uzs);
  } else {
    T gd, gq, ge = T(0), gf = T(0);
    if (sph) {
      gd = gq = gt * (T(-1) / c);
      gc = gc + gt * (d + q) / (c * c);
    } else if (e == T(0)) {
      const T dd = q != d ? gt * f / (den * den) : T(0);
      gf = gt / den;
      gd = dd;
      gq = -dd;
    } else {
      gd = gq = -gt / e;
      ge = gt * (d + q) / (e * e);
    }
    const T gdisc = gq * sg * T(0.5) / sq;
    gd = gd + T(2) * d * gdisc;
    ge = ge - f * gdisc;
    gf = gf - e * gdisc;
    gc = gc + yy * gf + uu * ge + uyd * gd;
    const T gyy = c * gf;
    const T guyd = c * gd;
    gz = gz - T(2) * gf;
    guz = guz - gd;
    gx = gx + T(2) * x * gyy + ux * guyd;
    gy = gy + T(2) * y * gyy + uy * guyd;
    gz = gz + T(2) * k1 * z * gyy + k1 * uz * guyd;
    gux = gux + x * guyd;
    guy = guy + y * guyd;
    guz = guz + k1 * z * guyd;
    if (!sph) {
      const T guu = c * ge;
      gux = gux + T(2) * ux * guu;
      guy = guy + T(2) * uy * guu;
      guz = guz + T(2) * k1 * uz * guu;
      gk = gk + z * z * gyy + uz * uz * guu + uz * z * guyd;
    }
  }
  // ---- reverse: enter the row's frame ----
  if (rotated) {
    rot_apply_t(p + P_ROT, gx, gy, gz);
    rot_apply_t(p + P_ROT, gux, guy, guz);
  }
  g[0] = gx; g[1] = gy; g[2] = gz;
  g[3] = gux; g[4] = guy; g[5] = guz;
  pg[0] = gc;
  pg[1] = gk;
  pg[2] = off_axis ? -gx : T(0);
  pg[3] = off_axis ? -gy : T(0);
  pg[4] = -gz;
  pg[5] = gmu;
}

// K4: trace, then the five weighted moments over live rays; block
// partial sums as in K2.
template <typename T>
__global__ void weighted_moments_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ w, T* __restrict__ partials, int64_t n) {
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
      const T wi = w[i];
      m[0] += wi;
      m[1] += wi * x;
      m[2] += wi * y;
      m[3] += wi * x * x;
      m[4] += wi * y * y;
    }
  }
  // block tree reduction (blockDim.x is a power of two)
  for (int q = 0; q < 5; ++q) s_red[q * blockDim.x + threadIdx.x] = m[q];
  block_sum_rows(s_red, 5, partials + int64_t(blockIdx.x) * 5);
}

// K5: the analytic adjoint of K4's moments dotted with ct (5 values).
// Every thread of a block runs the same number of grid-stride
// iterations (inactive tail threads trace the axis ray and stay dead),
// so the warp shuffles always see all 32 lanes.
template <typename T>
__global__ void __launch_bounds__(MAX_BLOCK) merit_adjoint_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ w, const T* __restrict__ ct,
    T* __restrict__ partials, T* __restrict__ ogx, T* __restrict__ ogy,
    T* __restrict__ ogz, T* __restrict__ ogux, T* __restrict__ oguy,
    T* __restrict__ oguz, T* __restrict__ ogw, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = nsurf * SLOTS;
  const int nwarps = blockDim.x >> 5;
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_acc = s_tab + nsurf * ROW;                  // nwarps * slots
  int* s_flags = reinterpret_cast<int*>(s_acc + nwarps * slots);
  for (int i = threadIdx.x; i < nwarps * slots; i += blockDim.x)
    s_acc[i] = T(0);
  stage_table(table, flags, nsurf, s_tab, s_flags);
  const T ct0 = ct[0], ct1 = ct[1], ct2 = ct[2], ct3 = ct[3], ct4 = ct[4];
  const int lane = threadIdx.x & 31;
  T* acc = s_acc + (threadIdx.x >> 5) * slots;
  const T* rl = s_tab + (nsurf - 1) * ROW + P_ROT;
  const bool first_rot = s_flags[0] & F_ROTATED;
  const bool last_rot = s_flags[nsurf - 1] & F_ROTATED;
  T saved[MAX_ROWS * 6];
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool active = i < n;
    T s[6] = {T(0), T(0), T(0), T(0), T(0), T(1)};
    if (active) {
      s[0] = ix[i]; s[1] = iy[i]; s[2] = iz[i];
      s[3] = iux[i]; s[4] = iuy[i]; s[5] = iuz[i];
    }
    // (a) forward recompute, keeping the state entering each row
    if (first_rot) {
      rot_apply_t(s_tab + P_ROT, s[0], s[1], s[2]);
      rot_apply_t(s_tab + P_ROT, s[3], s[4], s[5]);
    }
    T tacc = T(0);
    for (int j = 1; j < nsurf; ++j) {
      for (int q = 0; q < 6; ++q) saved[j * 6 + q] = s[q];
      surface_step(s_tab + j * ROW, s_flags[j], clip != 0, s[0], s[1], s[2],
                   s[3], s[4], s[5], tacc);
    }
    T xl = s[0], yl = s[1], zl = s[2], uxl = s[3], uyl = s[4], uzl = s[5];
    if (last_rot) {
      rot_apply(rl, xl, yl, zl);
      rot_apply(rl, uxl, uyl, uzl);
    }
    // (b) liveness; (c) seed the cotangents from the moment cotangents
    const bool live = active && isfinite(xl) && isfinite(yl) &&
                      isfinite(uzl);
    T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T gw = T(0);
    if (live) {
      const T wi = w[i];
      T gx = wi * (ct1 + T(2) * xl * ct3);
      T gy = wi * (ct2 + T(2) * yl * ct4);
      T gz = T(0);
      gw = ct0 + xl * ct1 + yl * ct2 + xl * xl * ct3 + yl * yl * ct4;
      if (last_rot) rot_apply_t(rl, gx, gy, gz);
      g[0] = gx; g[1] = gy; g[2] = gz;
    }
    // (d) reverse sweep, rows S-1 .. 1; (e) reduce each row's slots
    for (int j = nsurf - 1; j >= 1; --j) {
      T pg[SLOTS] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (live) surface_step_vjp(s_tab + j * ROW, s_flags[j], saved + j * 6,
                                 g, pg);
      for (int q = 0; q < SLOTS; ++q) {
        T v = pg[q];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) acc[j * SLOTS + q] += v;
      }
    }
    if (live && first_rot) {
      rot_apply(s_tab + P_ROT, g[0], g[1], g[2]);
      rot_apply(s_tab + P_ROT, g[3], g[4], g[5]);
    }
    // (f) per-ray cotangents (zeros for a dead ray)
    if (active) {
      ogx[i] = g[0]; ogy[i] = g[1]; ogz[i] = g[2];
      ogux[i] = g[3]; oguy[i] = g[4]; oguz[i] = g[5];
      ogw[i] = gw;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < slots; q += blockDim.x) {
    T sum = T(0);
    for (int wp = 0; wp < nwarps; ++wp) sum += s_acc[wp * slots + q];
    partials[int64_t(blockIdx.x) * slots + q] = sum;
  }
}

// K6: K4's weighted moments for each table of an nlam stack, one ray
// read once; partials[(blockIdx.x * nlam + l) * 5 + q].
template <typename T>
__global__ void weighted_moments_multi_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int nlam, int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ w, T* __restrict__ partials, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = blockDim.x;
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_red = s_tab + nlam * nsurf * ROW;          // 5 * nlam * nb
  int* s_flags = reinterpret_cast<int*>(s_red + 5 * nlam * nb);
  for (int r = 0; r < 5 * nlam; ++r) s_red[r * nb + threadIdx.x] = T(0);
  stage_table(table, flags, nsurf, s_tab, s_flags, nlam);
  const int64_t stride = int64_t(gridDim.x) * nb;
  for (int64_t i = int64_t(blockIdx.x) * nb + threadIdx.x; i < n;
       i += stride) {
    const T x0 = ix[i], y0 = iy[i], z0 = iz[i];
    const T ux0 = iux[i], uy0 = iuy[i], uz0 = iuz[i];
    const T wi = w[i];
    for (int l = 0; l < nlam; ++l) {
      T x = x0, y = y0, z = z0, ux = ux0, uy = uy0, uz = uz0, tacc;
      trace_ray(s_tab + l * nsurf * ROW, s_flags, nsurf, clip != 0, x, y, z,
                ux, uy, uz, tacc);
      if (isfinite(x) && isfinite(y) && isfinite(uz)) {
        T* m = s_red + 5 * l * nb + threadIdx.x;
        m[0] += wi;
        m[nb] += wi * x;
        m[2 * nb] += wi * y;
        m[3 * nb] += wi * x * x;
        m[4 * nb] += wi * y * y;
      }
    }
  }
  block_sum_rows(s_red, 5 * nlam, partials + int64_t(blockIdx.x) * 5 * nlam);
}

// K7: K5 for each table of an nlam stack.  ct holds nlam rows of the
// five moment cotangents.  The ray and weight cotangents are summed over
// the wavelengths; the parameter cotangents stay per wavelength:
// partials[blockIdx.x * nlam * nsurf * SLOTS + (l * nsurf + j) * SLOTS + q].
template <typename T>
__global__ void __launch_bounds__(MAX_BLOCK) merit_adjoint_multi_kernel(
    const T* __restrict__ table, const int* __restrict__ flags, int nsurf,
    int nlam, int clip, const T* __restrict__ ix, const T* __restrict__ iy,
    const T* __restrict__ iz, const T* __restrict__ iux,
    const T* __restrict__ iuy, const T* __restrict__ iuz,
    const T* __restrict__ w, const T* __restrict__ ct,
    T* __restrict__ partials, T* __restrict__ ogx, T* __restrict__ ogy,
    T* __restrict__ ogz, T* __restrict__ ogux, T* __restrict__ oguy,
    T* __restrict__ oguz, T* __restrict__ ogw, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slots = nlam * nsurf * SLOTS;          // a warp's row
  const int nwarps = blockDim.x >> 5;
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_acc = s_tab + nlam * nsurf * ROW;           // nwarps * slots
  T* s_ct = s_acc + nwarps * slots;                // nlam * 5
  int* s_flags = reinterpret_cast<int*>(s_ct + 5 * nlam);
  for (int i = threadIdx.x; i < nwarps * slots; i += blockDim.x)
    s_acc[i] = T(0);
  for (int i = threadIdx.x; i < 5 * nlam; i += blockDim.x) s_ct[i] = ct[i];
  stage_table(table, flags, nsurf, s_tab, s_flags, nlam);
  const int lane = threadIdx.x & 31;
  T* acc = s_acc + (threadIdx.x >> 5) * slots;
  const bool first_rot = s_flags[0] & F_ROTATED;
  const bool last_rot = s_flags[nsurf - 1] & F_ROTATED;
  T saved[MAX_ROWS * 6];
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool active = i < n;
    T s0[6] = {T(0), T(0), T(0), T(0), T(0), T(1)};
    T wi = T(0);
    if (active) {
      s0[0] = ix[i]; s0[1] = iy[i]; s0[2] = iz[i];
      s0[3] = iux[i]; s0[4] = iuy[i]; s0[5] = iuz[i];
      wi = w[i];
    }
    T gsum[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    T gwsum = T(0);
    for (int l = 0; l < nlam; ++l) {
      const T* tab = s_tab + l * nsurf * ROW;
      const T* rl = tab + (nsurf - 1) * ROW + P_ROT;
      T s[6];
      for (int q = 0; q < 6; ++q) s[q] = s0[q];
      // (a) forward recompute, keeping the state entering each row
      if (first_rot) {
        rot_apply_t(tab + P_ROT, s[0], s[1], s[2]);
        rot_apply_t(tab + P_ROT, s[3], s[4], s[5]);
      }
      T tacc = T(0);
      for (int j = 1; j < nsurf; ++j) {
        for (int q = 0; q < 6; ++q) saved[j * 6 + q] = s[q];
        surface_step(tab + j * ROW, s_flags[j], clip != 0, s[0], s[1], s[2],
                     s[3], s[4], s[5], tacc);
      }
      T xl = s[0], yl = s[1], zl = s[2], uxl = s[3], uyl = s[4], uzl = s[5];
      if (last_rot) {
        rot_apply(rl, xl, yl, zl);
        rot_apply(rl, uxl, uyl, uzl);
      }
      // (b) liveness at this wavelength; (c) seed from its cotangents
      const bool live = active && isfinite(xl) && isfinite(yl) &&
                        isfinite(uzl);
      const T* c5 = s_ct + 5 * l;
      T g[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T gw = T(0);
      if (live) {
        T gx = wi * (c5[1] + T(2) * xl * c5[3]);
        T gy = wi * (c5[2] + T(2) * yl * c5[4]);
        T gz = T(0);
        gw = c5[0] + xl * c5[1] + yl * c5[2] + xl * xl * c5[3] +
             yl * yl * c5[4];
        if (last_rot) rot_apply_t(rl, gx, gy, gz);
        g[0] = gx; g[1] = gy; g[2] = gz;
      }
      // (d) reverse sweep, rows S-1 .. 1; (e) reduce each row's slots
      T* acc_l = acc + l * nsurf * SLOTS;
      for (int j = nsurf - 1; j >= 1; --j) {
        T pg[SLOTS] = {T(0), T(0), T(0), T(0), T(0), T(0)};
        if (live) surface_step_vjp(tab + j * ROW, s_flags[j], saved + j * 6,
                                   g, pg);
        for (int q = 0; q < SLOTS; ++q) {
          T v = pg[q];
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) acc_l[j * SLOTS + q] += v;
        }
      }
      if (live && first_rot) {
        rot_apply(tab + P_ROT, g[0], g[1], g[2]);
        rot_apply(tab + P_ROT, g[3], g[4], g[5]);
      }
      // (f) sum over wavelengths (zeros where the ray is dead)
      for (int q = 0; q < 6; ++q) gsum[q] += g[q];
      gwsum += gw;
    }
    if (active) {
      ogx[i] = gsum[0]; ogy[i] = gsum[1]; ogz[i] = gsum[2];
      ogux[i] = gsum[3]; oguy[i] = gsum[4]; oguz[i] = gsum[5];
      ogw[i] = gwsum;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < slots; q += blockDim.x) {
    T sum = T(0);
    for (int wp = 0; wp < nwarps; ++wp) sum += s_acc[wp * slots + q];
    partials[int64_t(blockIdx.x) * slots + q] = sum;
  }
}

size_t moments_smem(int nsurf, int block, size_t word) {
  return (nsurf * ROW + 5 * size_t(block)) * word + nsurf * sizeof(int);
}

size_t adjoint_smem(int nsurf, int block, size_t word) {
  return (nsurf * ROW + size_t(block / 32) * nsurf * SLOTS) * word +
         nsurf * sizeof(int);
}

size_t moments_multi_smem(int nsurf, int nlam, int block, size_t word) {
  return size_t(nlam) * (nsurf * ROW + 5 * size_t(block)) * word +
         nsurf * sizeof(int);
}

size_t adjoint_multi_smem(int nsurf, int nlam, int block, size_t word) {
  return size_t(nlam) * (nsurf * ROW + size_t(block / 32) * nsurf * SLOTS + 5) *
             word + nsurf * sizeof(int);
}

template <typename T>
int launch_moments_multi(const void* table, const void* flags, int nsurf,
                         int nlam, int clip, const void* x, const void* y,
                         const void* z, const void* ux, const void* uy,
                         const void* uz, const void* w, void* partials,
                         long long n, int grid, int block, void* stream) {
  if (block <= 0 || (block & (block - 1)) || nlam < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = moments_multi_smem(nsurf, nlam, block, sizeof(T));
  cudaError_t err = allow_smem(weighted_moments_multi_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  weighted_moments_multi_kernel<T><<<grid, block, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(flags), nsurf,
      nlam, clip, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(ux),
      static_cast<const T*>(uy), static_cast<const T*>(uz),
      static_cast<const T*>(w), static_cast<T*>(partials), int64_t(n));
  return int(cudaGetLastError());
}

template <typename T>
int launch_adjoint_multi(const void* table, const void* flags, int nsurf,
                         int nlam, int clip, const void* x, const void* y,
                         const void* z, const void* ux, const void* uy,
                         const void* uz, const void* w, const void* ct,
                         void* partials, void* gx, void* gy, void* gz,
                         void* gux, void* guy, void* guz, void* gw,
                         long long n, int grid, int block, void* stream) {
  if (block <= 0 || block > MAX_BLOCK || block % 32 || nsurf < 1 ||
      nsurf > MAX_ROWS || nlam < 1)
    return int(cudaErrorInvalidValue);
  const size_t smem = adjoint_multi_smem(nsurf, nlam, block, sizeof(T));
  cudaError_t err = allow_smem(merit_adjoint_multi_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  merit_adjoint_multi_kernel<T><<<grid, block, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(flags), nsurf,
      nlam, clip, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(z), static_cast<const T*>(ux),
      static_cast<const T*>(uy), static_cast<const T*>(uz),
      static_cast<const T*>(w), static_cast<const T*>(ct),
      static_cast<T*>(partials), static_cast<T*>(gx), static_cast<T*>(gy),
      static_cast<T*>(gz), static_cast<T*>(gux), static_cast<T*>(guy),
      static_cast<T*>(guz), static_cast<T*>(gw), int64_t(n));
  return int(cudaGetLastError());
}

}  // namespace

#define WEIGHTED_MOMENTS_LAUNCHER(NAME, T)                                    \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int clip, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      const void* w, void* partials, long long n, int grid,  \
                      int block, void* stream) {                             \
    if (block <= 0 || (block & (block - 1))) return int(cudaErrorInvalidValue); \
    weighted_moments_kernel<T>                                               \
        <<<grid, block, moments_smem(nsurf, block, sizeof(T)),               \
           static_cast<cudaStream_t>(stream)>>>(                             \
            static_cast<const T*>(table), static_cast<const int*>(flags),    \
            nsurf, clip, static_cast<const T*>(x),                           \
            static_cast<const T*>(y), static_cast<const T*>(z),              \
            static_cast<const T*>(ux), static_cast<const T*>(uy),            \
            static_cast<const T*>(uz), static_cast<const T*>(w),             \
            static_cast<T*>(partials), int64_t(n));                          \
    return int(cudaGetLastError());                                          \
  }

#define MERIT_ADJOINT_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int clip, const void* x, const void* y, const void* z, \
                      const void* ux, const void* uy, const void* uz,        \
                      const void* w, const void* ct, void* partials,         \
                      void* gx, void* gy, void* gz, void* gux, void* guy,    \
                      void* guz, void* gw, long long n, int grid, int block, \
                      void* stream) {                                        \
    if (block <= 0 || block > MAX_BLOCK || block % 32 ||                     \
        nsurf < 1 || nsurf > MAX_ROWS)                                       \
      return int(cudaErrorInvalidValue);                                     \
    merit_adjoint_kernel<T>                                                  \
        <<<grid, block, adjoint_smem(nsurf, block, sizeof(T)),               \
           static_cast<cudaStream_t>(stream)>>>(                             \
            static_cast<const T*>(table), static_cast<const int*>(flags),    \
            nsurf, clip, static_cast<const T*>(x),                           \
            static_cast<const T*>(y), static_cast<const T*>(z),              \
            static_cast<const T*>(ux), static_cast<const T*>(uy),            \
            static_cast<const T*>(uz), static_cast<const T*>(w),             \
            static_cast<const T*>(ct), static_cast<T*>(partials),            \
            static_cast<T*>(gx), static_cast<T*>(gy), static_cast<T*>(gz),   \
            static_cast<T*>(gux), static_cast<T*>(guy),                      \
            static_cast<T*>(guz), static_cast<T*>(gw), int64_t(n));          \
    return int(cudaGetLastError());                                          \
  }

WEIGHTED_MOMENTS_LAUNCHER(weighted_moments_f32, float)
WEIGHTED_MOMENTS_LAUNCHER(weighted_moments_f64, double)
MERIT_ADJOINT_LAUNCHER(merit_adjoint_f32, float)
MERIT_ADJOINT_LAUNCHER(merit_adjoint_f64, double)

// K6 launchers: table (nlam, nsurf, ROW), flags (nsurf,), 6 rays, w,
// partials (grid, nlam, 5).
#define MOMENTS_MULTI_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int nlam, int clip, const void* x, const void* y,      \
                      const void* z, const void* ux, const void* uy,         \
                      const void* uz, const void* w, void* partials,         \
                      long long n, int grid, int block, void* stream) {      \
    return launch_moments_multi<T>(table, flags, nsurf, nlam, clip, x, y, z, \
                                   ux, uy, uz, w, partials, n, grid, block,  \
                                   stream);                                  \
  }

// K7 launchers: ... w, ct (nlam, 5), partials (grid, nlam*nsurf*SLOTS),
// 6 ray + 1 weight cotangents (n,).
#define ADJOINT_MULTI_LAUNCHER(NAME, T)                                       \
  extern "C" int NAME(const void* table, const void* flags, int nsurf,       \
                      int nlam, int clip, const void* x, const void* y,      \
                      const void* z, const void* ux, const void* uy,         \
                      const void* uz, const void* w, const void* ct,         \
                      void* partials, void* gx, void* gy, void* gz,          \
                      void* gux, void* guy, void* guz, void* gw,             \
                      long long n, int grid, int block, void* stream) {      \
    return launch_adjoint_multi<T>(table, flags, nsurf, nlam, clip, x, y, z, \
                                   ux, uy, uz, w, ct, partials, gx, gy, gz,  \
                                   gux, guy, guz, gw, n, grid, block,        \
                                   stream);                                  \
  }

MOMENTS_MULTI_LAUNCHER(weighted_moments_multi_f32, float)
MOMENTS_MULTI_LAUNCHER(weighted_moments_multi_f64, double)
ADJOINT_MULTI_LAUNCHER(merit_adjoint_multi_f32, float)
ADJOINT_MULTI_LAUNCHER(merit_adjoint_multi_f64, double)
