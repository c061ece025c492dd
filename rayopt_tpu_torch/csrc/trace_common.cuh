// Device code shared by the kernels specialized per spec tuple
// (grad_spec.cuh: K1-K9) and the df32 kernels (df32_common.cuh: the NaN,
// the compile-time flags, the grid-wide sum's last block and the
// shared-memory opt-in): the packed table layout, the flag bits, the
// guarded math, one surface step with its row flags as compile-time
// constants (flat, spherical, conic and even/odd aspheric rows: the
// latter by the seeded Newton intercept, `newton_intercept`; and the
// anamorphic rows: a conic cylinder in closed form, `cyl_intercept`, a
// biconic or toroid, with or without an aspheric figure, by the seeded
// Newton, `anam_intercept`; and the phase rows: a linear grating or a
// radial diffractive phase on any of these substrates, by the
// generalized Spencer & Murty solve, `grating_refract`; on a cylinder
// with the closed-form intercept and the normal of the biconic or toroid
// that made it, whose flag its row word sets beside F_CYL_Y or F_CYL_X;
// and the freeform XY rows: a conic or aspheric base plus a triangular
// XY-monomial figure, by the seeded Newton with the vertex-plane restart,
// `freeform_intercept`, and the freeform normal, `freeform_normal`), the
// compile-time loop and the last block of a fused grid-wide sum.  Each
// translation unit that includes it gets its own internal copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

// The aspheric coefficients a row of this key's table carries: the
// table's even and odd widths when some row is figured, else 0 (a
// translation unit defines them before the include; cuda_spec.Key.na/no)
#ifndef RAYOPT_N_ASP
#define RAYOPT_N_ASP 0
#endif
#ifndef RAYOPT_N_ODD
#define RAYOPT_N_ODD 0
#endif
// The words a row carries after the coefficients where some row of the
// key is anamorphic (curvature_dx, conic_dx: cuda_trace.
// carries_anamorphic), else 0
#ifndef RAYOPT_N_ANAM
#define RAYOPT_N_ANAM 0
#endif
// The words a row carries after those where some row of the key is a
// grating (grating_dy: cuda_trace.carries_grating), else 0, and the DOE
// coefficients where some row is a DOE (n_after, then N_DOE of them:
// cuda_trace.doe_width), else 0
#ifndef RAYOPT_N_GRAT
#define RAYOPT_N_GRAT 0
#endif
#ifndef RAYOPT_N_DOE
#define RAYOPT_N_DOE 0
#endif
// The XY-monomial coefficients a row carries last where some row of the
// key is freeform (the table's xy_poly width: cuda_trace.xy_width), else 0
#ifndef RAYOPT_N_XY
#define RAYOPT_N_XY 0
#endif
constexpr int N_ASP = RAYOPT_N_ASP;
constexpr int N_ODD = RAYOPT_N_ODD;
constexpr int N_ANAM = RAYOPT_N_ANAM;
constexpr int N_GRAT = RAYOPT_N_GRAT;
constexpr int N_DOE = RAYOPT_N_DOE;
constexpr int N_XY = RAYOPT_N_XY;

// packed row layout: keep in sync with cuda_trace.py (ROW, P_*); the
// coefficients follow the 17 base words, then an anamorphic key's two,
// a grating key's one, a DOE key's n_after and its coefficients, a
// freeform key's XY coefficients
constexpr int ROW = 17 + N_ASP + N_ODD + N_ANAM + N_GRAT +
                    (N_DOE > 0 ? 1 + N_DOE : 0) + N_XY;
constexpr int P_C = 0;     // curvature
constexpr int P_K = 1;     // conic
constexpr int P_OFF = 2;   // offset x, y, z
constexpr int P_ROT = 5;   // rot, row-major 3x3
constexpr int P_RAD = 14;  // aperture radius
constexpr int P_MU = 15;   // refraction ratio
constexpr int P_NB = 16;   // index before the surface
constexpr int P_ASP = 17;          // even aspheric coefficients (N_ASP)
constexpr int P_ODD = 17 + N_ASP;  // odd aspheric coefficients (N_ODD)
constexpr int P_CDX = 17 + N_ASP + N_ODD;  // curvature_dx (N_ANAM)
constexpr int P_KDX = P_CDX + 1;           // conic_dx
constexpr int P_GDY = P_CDX + N_ANAM;      // grating_dy (N_GRAT)
constexpr int P_NA = P_GDY + N_GRAT;       // n_after (N_DOE > 0)
constexpr int P_DOE = P_NA + 1;            // DOE coefficients (N_DOE)
constexpr int P_XY = P_GDY + N_GRAT + (N_DOE > 0 ? 1 + N_DOE : 0);  // N_XY

// flag bits: keep in sync with cuda_trace.py (F_*)
constexpr int F_FLAT = 1;
constexpr int F_SPHERICAL = 2;
constexpr int F_ROTATED = 4;
constexpr int F_OFF_AXIS = 8;
constexpr int F_ALTERNATE = 16;
constexpr int F_FINITE = 32;
constexpr int KIND_SHIFT = 6;  // 2 bits: 0 pass, 1 refract, 2 mirror
constexpr int F_ASPHERIC = 256;  // even figure: its slopes in the normal
constexpr int F_ODD = 512;       // odd figure: its slopes in the normal
constexpr int F_FIGURED = F_ASPHERIC | F_ODD;  // the seeded Newton intercept
// the anamorphic rows, one of them a row (an anamorphic key: N_ANAM = 2;
// a phase row on a cylinder sets F_BICONIC or F_TOROID beside F_CYL_*)
constexpr int F_CYL_Y = 1024;    // conic cylinder curved in y: c, k
constexpr int F_CYL_X = 2048;    // curved in x: c + cdx, k + kdx
constexpr int F_BICONIC = 4096;  // (cx, kx, cy, ky) by the seeded Newton
constexpr int F_TOROID = 8192;   // (cr, cy, ky) by the seeded Newton
constexpr int F_CYL = F_CYL_Y | F_CYL_X;
constexpr int F_ANAM_NEWTON = F_BICONIC | F_TOROID;
constexpr int F_ANAMORPHIC = F_CYL | F_ANAM_NEWTON;
// the phase rows (a grating key: N_GRAT = 1; a DOE key: N_DOE > 0)
constexpr int F_GRATING = 16384;  // grating_dy: the grating term T
constexpr int F_DOE = 32768;      // the DOE's kick potential psi(r2)
constexpr int F_PHASE = F_GRATING | F_DOE;
// the freeform XY rows (a freeform key: N_XY > 0): the Newton on the sag
// less the XY figure, the normal less its slopes
constexpr int F_FREEFORM = 65536;

// The XY figure's degree D of N_XY = D (D + 3) / 2 terms, and term t's
// exponents (i, j) in the triangular order of kernels._xy_terms: degree
// d = 1..D, within a degree from x^d down to y^d (degree d's terms start
// at (d - 1) (d + 2) / 2)
__host__ __device__ constexpr int xy_degree_of(int n) {
  int d = 0, m = 0;
  while (m < n) m += ++d + 1;
  return d;
}
constexpr int XY_DEG = xy_degree_of(N_XY);
static_assert(XY_DEG * (XY_DEG + 3) / 2 == N_XY,
              "N_XY must be a triangle D (D + 3) / 2");
__host__ __device__ constexpr int xy_term_d(int t) {
  int d = 1;
  while (d * (d + 3) / 2 <= t) ++d;
  return d;
}
__host__ __device__ constexpr int xy_term_j(int t) {
  return t - (xy_term_d(t) - 1) * (xy_term_d(t) + 2) / 2;
}
__host__ __device__ constexpr int xy_term_i(int t) {
  return xy_term_d(t) - xy_term_j(t);
}

// the Newton intercept of a figured row (kernels.intercept)
constexpr int ASPHERIC_ITERS = 10;
constexpr double TINY = 1e-30;
// the convergence tolerance, floored at 64 epsilons (kernels._tol_for)
template <typename T> __device__ __forceinline__ constexpr T newton_tol() {
  return sizeof(T) == 4 ? T(64 * 1.1920928955078125e-7) : T(1e-9);
}

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

// A figured row's coefficients, read once into registers.
template <typename T>
struct Figure {
  T a[N_ASP > 0 ? N_ASP : 1];
  T b[N_ODD > 0 ? N_ODD : 1];
};

template <typename T, typename Row>
__device__ __forceinline__ Figure<T> load_figure(Row p) {
  Figure<T> f;
#pragma unroll
  for (int i = 0; i < N_ASP; ++i) f.a[i] = p[P_ASP + i];
#pragma unroll
  for (int j = 0; j < N_ODD; ++j) f.b[j] = p[P_ODD + j];
  return f;
}

// A freeform row's XY coefficients, read once into registers.
template <typename T>
struct XyFig {
  T a[N_XY > 0 ? N_XY : 1];
};

template <typename T, typename Row>
__device__ __forceinline__ XyFig<T> load_xy(Row p) {
  XyFig<T> f;
#pragma unroll
  for (int t = 0; t < N_XY; ++t) f.a[t] = p[P_XY + t];
  return f;
}

// f(std::integral_constant<int, I>{}) for each I of the sequence, in order
template <typename F, int... I>
__device__ __forceinline__ void static_for(std::integer_sequence<int, I...>,
                                           F&& f) {
  (f(std::integral_constant<int, I>{}), ...);
}

// pw = [1, v, v^2, ..., v^XY_DEG] by repeated products (kernels._xy_pows)
template <typename T>
__device__ __forceinline__ void xy_powers(T v, T* pw) {
  pw[0] = T(1);
#pragma unroll
  for (int d = 1; d <= XY_DEG; ++d) pw[d] = pw[d - 1] * v;
}

// sum_t a[t] x^i y^j (kernels._poly_xy), each term's exponents
// compile-time
template <typename T>
__device__ __forceinline__ T poly_xy(T x, T y, const XyFig<T>& f) {
  T xp[XY_DEG + 1], yp[XY_DEG + 1];
  xy_powers(x, xp);
  xy_powers(y, yp);
  T out = T(0);
  static_for(std::make_integer_sequence<int, N_XY>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    constexpr int i = xy_term_i(t), j = xy_term_j(t);
    out = out + f.a[t] * (xp[i] * yp[j]);
  });
  return out;
}

// (d/dx, d/dy) of poly_xy (kernels._dpoly_xy)
template <typename T>
__device__ __forceinline__ void dpoly_xy(T x, T y, const XyFig<T>& f, T& gx,
                                         T& gy) {
  T xp[XY_DEG + 1], yp[XY_DEG + 1];
  xy_powers(x, xp);
  xy_powers(y, yp);
  gx = T(0);
  gy = T(0);
  static_for(std::make_integer_sequence<int, N_XY>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    constexpr int i = xy_term_i(t), j = xy_term_j(t);
    if constexpr (i > 0) gx = gx + (T(i) * f.a[t]) * (xp[i - 1] * yp[j]);
    if constexpr (j > 0) gy = gy + (T(j) * f.a[t]) * (xp[i] * yp[j - 1]);
  });
}

// max(x, lo) that lets NaN through (torch.clamp, jnp.maximum)
template <typename T> __device__ __forceinline__ T floor_at(T x, T lo) {
  return x < lo ? lo : x;
}

// sum_i a[i] r2^(i+1) (kernels._poly_even, Horner)
template <typename T>
__device__ __forceinline__ T poly_even(T r2, const T* a) {
  T d = T(0);
#pragma unroll
  for (int i = N_ASP - 1; i >= 0; --i) d = (d + a[i]) * r2;
  return d;
}

// sum_i 2 (i+1) a[i] r2^i (kernels._dpoly_even)
template <typename T>
__device__ __forceinline__ T dpoly_even(T r2, const T* a) {
  T d = T(0);
#pragma unroll
  for (int i = N_ASP - 1; i >= 0; --i) d = d * r2 + T(2 * (i + 1)) * a[i];
  return d;
}

// sqrt(r2) sum_j b[j] r2^j (kernels._poly_odd)
template <typename T>
__device__ __forceinline__ T poly_odd(T r2, const T* b) {
  T d = T(0);
#pragma unroll
  for (int j = N_ODD - 1; j >= 0; --j) d = d * r2 + b[j];
  return sqrt(r2) * d;
}

// P(r2)/r + 2 r P'(r2), r = max(sqrt(r2), TINY) (kernels._dpoly_odd)
template <typename T>
__device__ __forceinline__ T dpoly_odd(T r2, const T* b) {
  T q = T(0), dq = T(0);
#pragma unroll
  for (int j = N_ODD - 1; j >= 0; --j) q = q * r2 + b[j];
#pragma unroll
  for (int j = N_ODD - 1; j >= 1; --j) dq = dq * r2 + T(j) * b[j];
  const T r = floor_at(sqrt(r2), T(TINY));
  return q / r + T(2) * r * dq;
}

// The Newton residual F = z - sag(x, y) of a figured row at (px, py,
// pz): the conic and EVERY coefficient of the table's widths
// (kernels.sag through _newton_residual).
template <typename T>
__device__ __forceinline__ T sag_residual(T px, T py, T pz, T c, T k,
                                          const Figure<T>& fg) {
  const T r2 = px * px + py * py;
  T e = pz - c * r2 / (T(1) + sqrt0(T(1) - (T(1) + k) * c * c * r2));
  if (N_ASP) e = e - poly_even(r2, fg.a);
  if (N_ODD) e = e - poly_odd(r2, fg.b);
  return e;
}

// The radial factor of the normal (x e, y e, 1) at (px, py), every
// coefficient (kernels.normal_radial through _newton_slope).
template <typename T>
__device__ __forceinline__ T radial_factor(T px, T py, T c, T k,
                                           const Figure<T>& fg) {
  const T r2 = px * px + py * py;
  T e = -c / sqrt0(T(1) - (T(1) + k) * c * c * r2);
  if (N_ASP) e = e - dpoly_even(r2, fg.a);
  if (N_ODD) e = e - dpoly_odd(r2, fg.b);
  return e;
}

// dF/ds along the ray at distance s, a zero slope taken as 1 (the
// Newton step and the implicit derivative's F_s)
template <typename T>
__device__ __forceinline__ T newton_slope(T s, T x, T y, T ux, T uy, T uz,
                                          T c, T k, const Figure<T>& fg) {
  const T px = x + s * ux;
  const T py = y + s * uy;
  const T e = radial_factor(px, py, c, k, fg);
  const T fp = ux * (px * e) + uy * (py * e) + uz;
  return fp == T(0) ? T(1) : fp;
}

// kernels.intercept_conic: the generic conic root by its
// cancellation-free pair, the vertex plane where c == 0, NaN where a
// curved row is missed.  sg: -1 for the alternate root.
template <typename T>
__device__ __forceinline__ T conic_root(T x, T y, T z, T ux, T uy, T uz,
                                        T c, T k, T sg) {
  const T k1 = T(1) + k;
  const T uyd = ux * x + uy * y + k1 * uz * z;
  const T uu = ux * ux + uy * uy + k1 * uz * uz;
  const T yy = x * x + y * y + k1 * z * z;
  const T d = c * uyd - uz;
  const T e = c * uu;
  const T f = c * yy - T(2) * z;
  const T disc = d * d - e * f;
  const T g = sqrt0(disc) * sg;
  const bool conj = d * g <= T(0) || e == T(0);
  T den = conj ? g - d : e;
  if (den == T(0)) den = T(1);
  T seed = (conj ? f : -(d + g)) / den;
  if (c == T(0)) seed = -z / (uz == T(0) ? T(1) : uz);
  if (c != T(0) && disc < T(0)) seed = qnan<T>();
  return seed;
}

// kernels.intercept on a figured row: the generic conic root
// (conic_root) seeds ASPHERIC_ITERS Newton steps on the exact sag, no
// early exit; a ray whose residual exceeds newton_tol() * (1 + |s|), or
// whose seed misses a curved row, is NaN.  sg: -1 for the alternate
// root.
template <typename T>
__device__ __forceinline__ T newton_intercept(T x, T y, T z, T ux, T uy,
                                              T uz, T c, T k, T sg,
                                              const Figure<T>& fg) {
  const T seed = conic_root(x, y, z, ux, uy, uz, c, k, sg);
  T s = seed;
#pragma unroll 1
  for (int it = 0; it < ASPHERIC_ITERS; ++it) {
    const T fn = sag_residual(x + s * ux, y + s * uy, z + s * uz, c, k, fg);
    s = s - fn / newton_slope(s, x, y, ux, uy, uz, c, k, fg);
  }
  const T res = sag_residual(x + s * ux, y + s * uy, z + s * uz, c, k, fg);
  if (!(fabs(res) <= newton_tol<T>() * (T(1) + fabs(s)))) s = qnan<T>();
  if (isnan(seed) && c != T(0)) s = qnan<T>();
  return s;
}

// ---- the freeform rows ----

// The Newton residual of a freeform row: sag_residual (the conic and
// every coefficient of the table's widths) less the XY figure
// (kernels._newton_residual with xy)
template <typename T>
__device__ __forceinline__ T freeform_residual(T px, T py, T pz, T c, T k,
                                               const Figure<T>& fg,
                                               const XyFig<T>& xf) {
  return sag_residual(px, py, pz, c, k, fg) - poly_xy(px, py, xf);
}

// The freeform normal (gx, gy, 1) at (x1, y1): the radial normal (x1 e,
// y1 e), e = -c / sqrt0(1 - (1+k) c^2 r2) less the slopes of every
// coefficient of the table's widths, less the XY figure's slopes
// (kernels.normal_freeform)
template <typename T>
__device__ __forceinline__ void freeform_normal(T x1, T y1, T c, T k,
                                                const Figure<T>& fg,
                                                const XyFig<T>& xf, T& gx,
                                                T& gy) {
  const T e = radial_factor(x1, y1, c, k, fg);
  T dpx, dpy;
  dpoly_xy(x1, y1, xf, dpx, dpy);
  gx = x1 * e - dpx;
  gy = y1 * e - dpy;
}

// dF/ds of a freeform row at distance s, a zero slope taken as 1
template <typename T>
__device__ __forceinline__ T freeform_slope(T s, T x, T y, T ux, T uy, T uz,
                                            T c, T k, const Figure<T>& fg,
                                            const XyFig<T>& xf) {
  T gx, gy;
  freeform_normal(x + s * ux, y + s * uy, c, k, fg, xf, gx, gy);
  const T fp = ux * gx + uy * gy + uz;
  return fp == T(0) ? T(1) : fp;
}

// kernels.intercept with xy_poly: the generic conic root (conic_root)
// seeds ASPHERIC_ITERS Newton steps on the freeform residual, a ray whose
// seed misses restarting from the vertex plane -z/uz (the figure breaks
// the symmetry: the true surface can catch what the conic misses); no
// early exit, and no mask of the seed's misses after: a ray past
// newton_tol() is NaN.  sg: -1 for the alternate root.
template <typename T>
__device__ __forceinline__ T freeform_intercept(T x, T y, T z, T ux, T uy,
                                                T uz, T c, T k, T sg,
                                                const Figure<T>& fg,
                                                const XyFig<T>& xf) {
  T s = conic_root(x, y, z, ux, uy, uz, c, k, sg);
  if (isnan(s)) s = -z / (uz == T(0) ? T(1) : uz);
#pragma unroll 1
  for (int it = 0; it < ASPHERIC_ITERS; ++it) {
    const T fn =
        freeform_residual(x + s * ux, y + s * uy, z + s * uz, c, k, fg, xf);
    s = s - fn / freeform_slope(s, x, y, ux, uy, uz, c, k, fg, xf);
  }
  const T res =
      freeform_residual(x + s * ux, y + s * uy, z + s * uz, c, k, fg, xf);
  if (!(fabs(res) <= newton_tol<T>() * (T(1) + fabs(s)))) s = qnan<T>();
  return s;
}

// ---- the anamorphic rows ----

// kernels.intercept_cyl: the closed-form root of the conic cylinder
// c (w^2 + (1+k) z^2) - 2 z = 0 in its curved coordinate w, by the
// cancellation-free pair; NaN where it is missed.
template <typename T>
__device__ __forceinline__ T cyl_intercept(T w, T z, T uw, T uz, T c, T k,
                                           T sg) {
  const T k1 = T(1) + k;
  const T uyd = uw * w + k1 * uz * z;
  const T uu = uw * uw + k1 * uz * uz;
  const T yy = w * w + k1 * z * z;
  const T d = c * uyd - uz;
  const T e = c * uu;
  const T f = c * yy - T(2) * z;
  const T disc = d * d - e * f;
  const T g = sqrt0(disc) * sg;
  const bool conj = d * g <= T(0) || e == T(0);
  T den = conj ? g - d : e;
  if (den == T(0)) den = T(1);
  T t = (conj ? f : -(d + g)) / den;
  if (disc < T(0)) t = qnan<T>();
  return t;
}

// kernels.refract_cyl: Snell (kind 1) or a mirror (kind 2) on the
// cylinder's normal (-c w, 1 - (1+k) c z); uw along the curved axis, uv
// along the flat one.
template <typename T>
__device__ __forceinline__ void cyl_refract(int kind, T w, T z, T mu, T c,
                                            T k, T& uw, T& uv, T& uz) {
  const T nw = -c * w;
  const T nz = T(1) - (T(1) + k) * c * z;
  const T inv = T(1) / (nw * nw + nz * nz);
  const T dot = uw * nw + uz * nz;
  if (kind == 2) {
    const T a2 = T(2) * dot * inv;
    uw = uw - a2 * nw;
    uz = uz - a2 * nz;
    return;
  }
  const T muf = fabs(mu);
  const T a = muf * dot * inv;
  const T disc = a * a - (mu * mu - T(1)) * inv;
  T g = -a + sgn(mu) * sqrt0(disc);
  if (disc < T(0)) g = qnan<T>();
  uw = muf * uw + g * nw;
  uv = muf * uv;
  uz = muf * uz + g * nz;
}

// The figure of a biconic (cx, kx, cy, ky) or a toroid (cr, cy, ky; pd
// unused) row.
template <typename T>
struct Anam {
  T pa, pb, pc, pd;
};

// With FIG (a key of nonzero widths) a biconic or toroid adds the even
// and odd polynomials of EVERY coefficient of the table's widths, as the
// reference passes the whole coefficient rows, figured or not (a row of
// zeros adds zeros): a biconic's in r2 = x^2 + y^2, a toroid's on its
// generating curve in y^2 alone.

// z - sag of a biconic (kernels.sag_biconic)
template <bool FIG, typename T>
__device__ __forceinline__ T biconic_sag(T px, T py, T pz, const Anam<T>& a,
                                         const Figure<T>& fg) {
  const T x2 = px * px, y2 = py * py;
  const T num = a.pa * x2 + a.pc * y2;
  const T b = (T(1) + a.pb) * a.pa * a.pa * x2 + (T(1) + a.pd) * a.pc * a.pc * y2;
  T e = pz - num / (T(1) + sqrt0(T(1) - b));
  if constexpr (FIG) {
    const T r2 = x2 + y2;
    if (N_ASP) e = e - poly_even(r2, fg.a);
    if (N_ODD) e = e - poly_odd(r2, fg.b);
  }
  return e;
}

// (gx, gy) of the biconic's normal (gx, gy, 1) (kernels.normal_biconic)
template <bool FIG, typename T>
__device__ __forceinline__ void biconic_normal(T x, T y, const Anam<T>& a,
                                               const Figure<T>& fg, T& gx,
                                               T& gy) {
  const T x2 = x * x, y2 = y * y;
  const T num = a.pa * x2 + a.pc * y2;
  const T qx = (T(1) + a.pb) * a.pa * a.pa;
  const T qy = (T(1) + a.pd) * a.pc * a.pc;
  const T s = sqrt0(T(1) - (qx * x2 + qy * y2));
  const T ss = floor_at(s, T(TINY));
  const T inv = T(1) / (T(1) + s);
  gx = -(T(2) * a.pa * x * (T(1) + s) + num * qx * x / ss) * inv * inv;
  gy = -(T(2) * a.pc * y * (T(1) + s) + num * qy * y / ss) * inv * inv;
  if constexpr (FIG) {
    const T r2 = x2 + y2;
    if (N_ASP) {
      const T d = dpoly_even(r2, fg.a);
      gx = gx - x * d;
      gy = gy - y * d;
    }
    if (N_ODD) {
      const T d = dpoly_odd(r2, fg.b);
      gx = gx - x * d;
      gy = gy - y * d;
    }
  }
}

// The toroid's generating curve (kernels._ycurve): zy, dzy
template <bool FIG, typename T>
__device__ __forceinline__ void ycurve(T y, T cy, T ky, const Figure<T>& fg,
                                       T& zy, T& dzy) {
  const T y2 = y * y;
  const T sq = sqrt0(T(1) - (T(1) + ky) * cy * cy * y2);
  zy = cy * y2 / (T(1) + sq);
  dzy = cy * y / floor_at(sq, T(TINY));
  if constexpr (FIG) {
    if (N_ASP) {
      zy = zy + poly_even(y2, fg.a);
      dzy = dzy + y * dpoly_even(y2, fg.a);
    }
    if (N_ODD) {
      zy = zy + poly_odd(y2, fg.b);
      dzy = dzy + y * dpoly_odd(y2, fg.b);
    }
  }
}

// z - sag of a toroid (kernels.sag_toroid)
template <bool FIG, typename T>
__device__ __forceinline__ T toroid_sag(T px, T py, T pz, const Anam<T>& a,
                                        const Figure<T>& fg) {
  T zy, dzy;
  ycurve<FIG>(py, a.pb, a.pc, fg, zy, dzy);
  const T crp = a.pa / (T(1) - a.pa * zy);
  const T x2 = px * px;
  return pz - zy - crp * x2 / (T(1) + sqrt0(T(1) - x2 * crp * crp));
}

// (gx, gy) of the toroid's normal (kernels.normal_toroid)
template <bool FIG, typename T>
__device__ __forceinline__ void toroid_normal(T x, T y, const Anam<T>& a,
                                              const Figure<T>& fg, T& gx,
                                              T& gy) {
  T zy, dzy;
  ycurve<FIG>(y, a.pb, a.pc, fg, zy, dzy);
  const T crp = a.pa / (T(1) - a.pa * zy);
  const T w = floor_at(sqrt0(T(1) - x * x * crp * crp), T(TINY));
  gx = -x * crp / w;
  gy = -dzy / w;
}

template <bool TOROID, bool FIG, typename T>
__device__ __forceinline__ T anam_sag(T px, T py, T pz, const Anam<T>& a,
                                      const Figure<T>& fg) {
  if constexpr (TOROID) {
    return toroid_sag<FIG>(px, py, pz, a, fg);
  } else {
    return biconic_sag<FIG>(px, py, pz, a, fg);
  }
}

template <bool TOROID, bool FIG, typename T>
__device__ __forceinline__ void anam_normal(T x, T y, const Anam<T>& a,
                                            const Figure<T>& fg, T& gx,
                                            T& gy) {
  if constexpr (TOROID) {
    toroid_normal<FIG>(x, y, a, fg, gx, gy);
  } else {
    biconic_normal<FIG>(x, y, a, fg, gx, gy);
  }
}

// dF/ds of a biconic or toroid at distance s, a zero slope taken as 1
template <bool TOROID, bool FIG, typename T>
__device__ __forceinline__ T anam_slope(T s, T x, T y, T ux, T uy, T uz,
                                        const Anam<T>& a,
                                        const Figure<T>& fg) {
  T gx, gy;
  anam_normal<TOROID, FIG>(x + s * ux, y + s * uy, a, fg, gx, gy);
  const T fp = ux * gx + uy * gy + uz;
  return fp == T(0) ? T(1) : fp;
}

// The row's figure: a biconic's (c + cdx, k + kdx, c, k), a toroid's
// (c + cdx, c, k)
template <bool TOROID, typename T, typename Row>
__device__ __forceinline__ Anam<T> load_anam(Row p, T c, T k) {
  const T cx = c + p[P_CDX];
  if constexpr (TOROID) {
    return Anam<T>{cx, c, k, T(0)};
  } else {
    return Anam<T>{cx, k + p[P_KDX], c, k};
  }
}

// kernels.intercept_biconic / intercept_toroid: the y-conic root seeds
// ASPHERIC_ITERS Newton steps (a missed seed restarts from the vertex
// plane -z/uz), no early exit; a ray past newton_tol() is NaN.
template <bool TOROID, bool FIG, typename T>
__device__ __forceinline__ T anam_intercept(T x, T y, T z, T ux, T uy, T uz,
                                            T cy, T ky, T sg,
                                            const Anam<T>& a,
                                            const Figure<T>& fg) {
  T s = conic_root(x, y, z, ux, uy, uz, cy, ky, sg);
  if (isnan(s)) s = -z / (uz == T(0) ? T(1) : uz);
#pragma unroll 1
  for (int it = 0; it < ASPHERIC_ITERS; ++it) {
    const T fn = anam_sag<TOROID, FIG>(x + s * ux, y + s * uy, z + s * uz, a,
                                       fg);
    s = s - fn / anam_slope<TOROID, FIG>(s, x, y, ux, uy, uz, a, fg);
  }
  const T res = anam_sag<TOROID, FIG>(x + s * ux, y + s * uy, z + s * uz, a,
                                      fg);
  if (!(fabs(res) <= newton_tol<T>() * (T(1) + fabs(s)))) s = qnan<T>();
  return s;
}

// kernels._refract_general: Snell (kind 1) or a mirror (kind 2) on the
// normal (gx, gy, 1)
template <typename T>
__device__ __forceinline__ void general_refract(int kind, T mu, T gx, T gy,
                                                T& vx, T& vy, T& vz) {
  const T r2 = gx * gx + gy * gy + T(1);
  const T muf = fabs(mu);
  const T a = muf * (vx * gx + vy * gy + vz) / r2;
  if (kind == 2) {
    vx = vx - T(2) * a * gx;
    vy = vy - T(2) * a * gy;
    vz = vz - T(2) * a;
    return;
  }
  const T disc = a * a - (mu * mu - T(1)) / r2;
  T g = -a + sgn(mu) * sqrt0(disc);
  if (disc < T(0)) g = qnan<T>();
  vx = muf * vx + g * gx;
  vy = muf * vy + g * gy;
  vz = muf * vz + g;
}

// ---- the phase rows ----

// A DOE row's coefficients, read once into registers.
template <typename T>
struct Doe {
  T a[N_DOE > 0 ? N_DOE : 1];
};

template <typename T, typename Row>
__device__ __forceinline__ Doe<T> load_doe(Row p) {
  Doe<T> d;
#pragma unroll
  for (int i = 0; i < N_DOE; ++i) d.a[i] = p[P_DOE + i];
  return d;
}

// psi(r2) = sum_i a[i] r2^(i+1), the DOE's kick potential (its optical
// path over n_after; kernels._poly_even)
template <typename T>
__device__ __forceinline__ T doe_psi(T r2, const Doe<T>& d) {
  T s = T(0);
#pragma unroll
  for (int i = N_DOE - 1; i >= 0; --i) s = (s + d.a[i]) * r2;
  return s;
}

// dpsi/d(r2) times 2: sum_i 2 (i+1) a[i] r2^i (kernels.doe_kick's factor)
template <typename T>
__device__ __forceinline__ T doe_slope(T r2, const Doe<T>& d) {
  T s = T(0);
#pragma unroll
  for (int i = N_DOE - 1; i >= 0; --i) s = s * r2 + T(2 * (i + 1)) * d.a[i];
  return s;
}

// Whether a phase row passes the ray on untouched: mu == 1, no grating
// term and (KICK) every DOE coefficient 0 -- decided for the row, not a
// ray (kernels.refract_grating's keep)
template <bool KICK, typename T>
__device__ __forceinline__ bool phase_keep(T mu, T gdy, const Doe<T>& d) {
  bool keep = mu == T(1) && gdy == T(0);
  if constexpr (KICK) {
#pragma unroll
    for (int i = 0; i < N_DOE; ++i) keep = keep && d.a[i] == T(0);
  }
  return keep;
}

// The normal (gx, gy, 1) of a phase row's radial substrate at (x1, y1):
// (x1 e, y1 e), e = -c / sqrt0(1 - (1+k) c^2 r2) less the slopes of every
// coefficient of the key's widths on a figured row (FIG;
// kernels.normal_radial), zero on a flat row without a figure (FLAT)
template <bool FLAT, bool FIG, typename T>
__device__ __forceinline__ void radial_phase_normal(T x1, T y1, T c, T k,
                                                    const Figure<T>& fg,
                                                    T& gx, T& gy) {
  if constexpr (FLAT) {
    gx = T(0);
    gy = T(0);
  } else {
    const T r2 = x1 * x1 + y1 * y1;
    T e = -c / sqrt0(T(1) - (T(1) + k) * c * c * r2);
    if constexpr (FIG) {
      if (N_ASP) e = e - dpoly_even(r2, fg.a);
      if (N_ODD) e = e - dpoly_odd(r2, fg.b);
    }
    gx = x1 * e;
    gy = y1 * e;
  }
}

// kernels.refract_grating: the generalized Spencer & Murty solve u' =
// |mu| u + T q + s + Gamma (gx, gy, 1) on the substrate normal, with the
// unit groove vector q (y-hat projected into the tangent plane, its
// norm floored at TINY), the grating term T = gdy and (KICK) the DOE's
// kick s = doe_slope(r2) (x1, y1); a mirror (mu == -1) takes Gamma's
// root that flips the normal component, an evanescent order NaN.  The
// row passes the ray on untouched where phase_keep.
template <bool KICK, typename T>
__device__ __forceinline__ void grating_refract(T mu, T gdy, T gx, T gy,
                                                T x1, T y1,
                                                const Doe<T>& dc, T& vx,
                                                T& vy, T& vz) {
  if (phase_keep<KICK>(mu, gdy, dc)) return;
  const T inv_nn = T(1) / (gx * gx + gy * gy + T(1));
  const T muf = fabs(mu);
  T qx = -gy * gx * inv_nn;
  T qy = T(1) - gy * gy * inv_nn;
  T qz = -gy * inv_nn;
  const T qn = T(1) / sqrt(floor_at(qx * qx + qy * qy + qz * qz, T(TINY)));
  qx = qx * qn;
  qy = qy * qn;
  qz = qz * qn;
  T bx = muf * vx + gdy * qx;
  T by = muf * vy + gdy * qy;
  const T bz = muf * vz + gdy * qz;
  if constexpr (KICK) {
    const T e = doe_slope(x1 * x1 + y1 * y1, dc);
    bx = bx + e * x1;
    by = by + e * y1;
  }
  const T bn = (bx * gx + by * gy + bz) * inv_nn;
  const T bb = bx * bx + by * by + bz * bz;
  const T disc = bn * bn - (bb - T(1)) * inv_nn;
  const T root = sqrt0(disc);
  T gam = mu == T(-1) ? -bn - sgn(bn) * root : -bn + sgn(mu) * root;
  if (disc < T(0)) gam = qnan<T>();
  vx = bx + gam * gx;
  vy = by + gam * gy;
  vz = bz + gam;
}

// One transfer-intercept-refract step: kernels.surface_step_spec for
// flat, spherical, conic, even/odd aspheric, anamorphic, phase and
// freeform rows.  State in and out
// in the global (from_normal) frame; adds the optical path n_before * t
// to tacc.
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
  static_assert(!(Flags::value & F_ANAMORPHIC) || N_ANAM == 2,
                "an anamorphic row needs the key's curvature_dx, conic_dx");
  static_assert(!(Flags::value & F_GRATING) || N_GRAT == 1,
                "a grating row needs the key's grating_dy");
  static_assert(!(Flags::value & F_DOE) || N_DOE > 0,
                "a DOE row needs the key's DOE coefficients");
  static_assert(!(Flags::value & F_CYL) || !(Flags::value & F_ANAM_NEWTON) ||
                    (Flags::value & F_PHASE),
                "only a phase row marks its cylinder's origin");
  static_assert(!(Flags::value & F_FREEFORM) || N_XY > 0,
                "a freeform row needs the key's XY coefficients");
  static_assert(!(Flags::value & F_FREEFORM) || !(Flags::value & F_ANAMORPHIC),
                "a freeform figure takes a radial base");
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
  const bool figured = fl & F_FIGURED;
  constexpr bool toroid = (Flags::value & F_TOROID) != 0;
  // a biconic's or toroid's Newton reads every coefficient of the key's
  // widths, figured or not (kernels.reads_figure; a figured cylinder is
  // a biconic: specialize)
  constexpr bool anam_fig = N_ASP + N_ODD > 0;
  static_assert(!(Flags::value & F_CYL) || !(Flags::value & F_FIGURED),
                "a cylinder row has no aspheric figure");
  // a freeform row's Newton and normal read every coefficient of the
  // widths too (kernels.reads_figure), and its XY figure
  constexpr bool freeform = (Flags::value & F_FREEFORM) != 0;
  Figure<T> fg;
  if (figured || ((fl & (F_ANAM_NEWTON | F_FREEFORM)) && anam_fig))
    fg = load_figure<T>(p);
  XyFig<T> xf{};
  if constexpr (freeform) xf = load_xy<T>(p);
  Anam<T> an{};
  if (fl & F_ANAM_NEWTON) an = load_anam<toroid>(p, c, k);
  // a cylinder's curvature and conic: (c, k) in y, (c + cdx, k + kdx) in x
  T cc = c, kk = k;
  if (fl & F_CYL_X) {
    cc = c + p[P_CDX];
    kk = k + p[P_KDX];
  }
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  // intercept_spec, a cylinder's closed form (a phase cylinder's too),
  // or the seeded Newton of a figured, biconic, toroidal or freeform row
  T t;
  if (fl & F_CYL_Y) {
    t = cyl_intercept(y, z, uy, uz, cc, kk, sg);
  } else if (fl & F_CYL_X) {
    t = cyl_intercept(x, z, ux, uz, cc, kk, sg);
  } else if (fl & F_ANAM_NEWTON) {
    t = anam_intercept<toroid, anam_fig>(x, y, z, ux, uy, uz, c, k, sg,
                                            an, fg);
  } else if (freeform) {
    t = freeform_intercept(x, y, z, ux, uy, uz, c, k, sg, fg, xf);
  } else if (figured) {
    t = newton_intercept(x, y, z, ux, uy, uz, c, k,
                         (fl & F_ALTERNATE) ? T(-1) : T(1), fg);
  } else if (fl & F_FLAT) {
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
  constexpr bool doe = (Flags::value & F_DOE) != 0;
  Doe<T> dc{};
  if constexpr (doe) dc = load_doe<T>(p);
  if constexpr (doe) {
    // the DOE's imprinted phase is optical path: psi(r2) * n_after
    tacc = tacc + (t * p[P_NB] + doe_psi(x1 * x1 + y1 * y1, dc) * p[P_NA]);
  } else {
    tacc = tacc + t * p[P_NB];
  }
  // clip NaNs the INCOMING direction: the ray turns NaN one surface on
  T vx = ux, vy = uy, vz = uz;
  if (clip && (fl & F_FINITE)) {
    const T rad = p[P_RAD];
    if (x1 * x1 + y1 * y1 > rad * rad) vx = vy = vz = qnan<T>();
  }
  // refract_spec
  const int kind = (fl >> KIND_SHIFT) & 3;
  if constexpr ((Flags::value & F_PHASE) != 0) {
    // the substrate's normal by its figure (a cylinder's by the biconic or
    // toroid that made it), then the grating/phase solve; before the
    // passthrough: a grating row with mu == 1 still diffracts
    T gx, gy;
    if constexpr ((Flags::value & F_ANAM_NEWTON) != 0) {
      anam_normal<toroid, anam_fig>(x1, y1, an, fg, gx, gy);
    } else if constexpr (freeform) {
      freeform_normal(x1, y1, c, k, fg, xf, gx, gy);
    } else {
      radial_phase_normal<(Flags::value & F_FLAT) != 0 &&
                              !(Flags::value & F_FIGURED),
                          (Flags::value & F_FIGURED) != 0>(x1, y1, c, k, fg,
                                                           gx, gy);
    }
    const T gdy = (fl & F_GRATING) ? T(p[P_GDY]) : T(0);
    grating_refract<doe>(T(p[P_MU]), gdy, gx, gy, x1, y1, dc, vx, vy, vz);
  } else if (kind != 0) {
    const T mu = p[P_MU];
    const T muf = fabs(mu);
    if (fl & F_CYL_Y) {
      cyl_refract(kind, y1, z1, mu, cc, kk, vy, vx, vz);
    } else if (fl & F_CYL_X) {
      cyl_refract(kind, x1, z1, mu, cc, kk, vx, vy, vz);
    } else if (fl & F_ANAM_NEWTON) {
      T gx, gy;
      anam_normal<toroid, anam_fig>(x1, y1, an, fg, gx, gy);
      general_refract(kind, mu, gx, gy, vx, vy, vz);
    } else if (freeform) {
      // kernels.refract_freeform: Snell or a mirror on the freeform normal
      T gx, gy;
      freeform_normal(x1, y1, c, k, fg, xf, gx, gy);
      general_refract(kind, mu, gx, gy, vx, vy, vz);
    } else if (figured) {
      // the radial normal (x e, y e, 1) of _refract_figured: the conic
      // factor by an IEEE square root and division, then the slopes of
      // the flagged figures
      const T r2s = x1 * x1 + y1 * y1;
      const T m = floor_at(T(1) - (T(1) + k) * c * c * r2s, T(TINY));
      T e = -c * (T(1) / sqrt(m));
      if (fl & F_ASPHERIC) e = e - dpoly_even(r2s, fg.a);
      if (fl & F_ODD) e = e - dpoly_odd(r2s, fg.b);
      const T nx = x1 * e;
      const T ny = y1 * e;
      const T ir2 = T(1) / (nx * nx + ny * ny + T(1));
      const T dot = vx * nx + vy * ny + vz;
      if (kind == 2) {
        const T a2 = T(2) * dot * ir2;
        vx = vx - a2 * nx;
        vy = vy - a2 * ny;
        vz = vz - a2;
      } else {
        const T a = muf * dot * ir2;
        const T disc = a * a - (mu * mu - T(1)) * ir2;
        T g = -a + sgn(mu) * sqrt0(disc);
        if (disc < T(0)) g = qnan<T>();
        vx = muf * vx + g * nx;
        vy = muf * vy + g * ny;
        vz = muf * vz + g;
      }
    } else if (fl & F_FLAT) {
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
