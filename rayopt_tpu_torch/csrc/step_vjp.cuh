// The hand-derived reverse of one surface step (trace_common.cuh
// surface_step), run by the adjoints specialized per spec tuple in
// grad_spec.cuh (K5, K7, K9; row flags as compile-time constants; K9's
// with the optical path's cotangent, a DOE row's phase term too), and
// the reference-sphere tail of the OPD (K8 and K9, both in
// grad_spec.cuh with the image row's flags compile-time) with its
// reverse.  Their torch models, line for line, are
// cuda_grad._step_vjp_reference, _sphere_tail and
// _opd_tail_vjp_reference.  A rot key (RAYOPT_ROT) also differentiates
// each rotated row's rotation: every reverse enters and leaves the row's
// frame through rot_enter_vjp and rot_leave_vjp, which add the row's
// nine rotation cotangents to its last slots.

#pragma once

#include "trace_common.cuh"

namespace {

constexpr int SLOTS = 6;      // parameter cotangents a row: cuda_grad.SLOTS
constexpr int OPD_SLOTS = 7;  // K9's a row, + n_before: cuda_grad.OPD_SLOTS
constexpr int AUX = 5;        // K8/K9's centre xyz, radius, lam_scale
// a rot key's nine rotation slots a row, R[i][j] row-major, last
// (cuda_spec.ROT, Key.rot); 0 in every other key
#ifdef RAYOPT_ROT
constexpr int N_ROT = 9;
#else
constexpr int N_ROT = 0;
#endif
// K5's and K7's a row: SLOTS, then the even and the odd aspheric
// coefficients, then an anamorphic key's curvature_dx and conic_dx, then
// a phase key's grating_dy and DOE coefficients, then a freeform key's XY
// coefficients, then a rot key's rotation
constexpr int FIG_SLOTS =
    SLOTS + N_ASP + N_ODD + N_ANAM + N_GRAT + N_DOE + N_XY + N_ROT;
// K9's a row: OPD_SLOTS (SLOTS, then n_before), then the even and the
// odd coefficients, then an anamorphic key's curvature_dx and conic_dx,
// then a phase key's grating_dy, then a DOE key's n_after and DOE
// coefficients (cuda_spec.opd_live_slots), then a freeform key's XY
// coefficients (figured_step_vjp puts them at Q_XY + 1, one more past a
// DOE key's n_after), then a rot key's rotation, last
constexpr int OPD_FIG_SLOTS = OPD_SLOTS + N_ASP + N_ODD + N_ANAM + N_GRAT +
                              (N_DOE > 0 ? 1 + N_DOE : 0) + N_XY + N_ROT;
// a row's per-ray parameter cotangents, the widest of the two
constexpr int PG_SLOTS = FIG_SLOTS > OPD_FIG_SLOTS ? FIG_SLOTS : OPD_FIG_SLOTS;
// an anamorphic row's curvature_dx and conic_dx slots (K5, K7; K9's
// are one further on, past n_before)
constexpr int Q_CDX = SLOTS + N_ASP + N_ODD;
// a grating row's grating_dy slot and a DOE row's coefficients' (K5,
// K7; K9's are one further on, past n_before, and its n_after's sits
// where K5's coefficients start)
constexpr int Q_GDY = Q_CDX + N_ANAM;
constexpr int Q_DOE = Q_GDY + N_GRAT;
// a freeform row's XY coefficients' slots, last (K5's and K7's; with
// PATH one further on, and one more past a DOE key's n_after)
constexpr int Q_XY = Q_DOE + N_DOE;
// a rot key's rotation slots, last (K5's and K7's; with PATH, K9's, one
// further on, and one more past a DOE key's n_after)
constexpr int Q_ROT = Q_XY + N_XY;
template <bool PATH>
__host__ __device__ constexpr int rot_slot() {
  return Q_ROT + (PATH ? 1 + (N_DOE > 0 ? 1 : 0) : 0);
}

// The rotation's cotangent where a reverse leaves a row's frame (a rot
// key's; cuda_grad._rot_leave_vjp): the forward wrote the state leaving
// the row as R^T of its local one, so with so that state (global frame)
// and g its cotangent, pr[3 i + j] = (R so)[i] g[j] + (R so_u)[i] g[3 + j].
template <typename R, typename T>
__device__ __forceinline__ void rot_leave_vjp(R r, const T* so, const T* g,
                                              T* pr) {
  T ox = so[0], oy = so[1], oz = so[2], vx = so[3], vy = so[4], vz = so[5];
  rot_apply(r, ox, oy, oz);
  rot_apply(r, vx, vy, vz);
  const T ol[3] = {ox, oy, oz};
  const T vl[3] = {vx, vy, vz};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) pr[3 * i + j] = ol[i] * g[j] + vl[i] * g[3 + j];
}

// The rotation's cotangent where a reverse enters a row's frame
// (cuda_grad._rot_enter_vjp): the forward took x_l = R d and u_l = R u
// (d the position less the row's offset, u the direction, both in the
// global frame: e[0..2] and e[3..5]), so pr[3 i + j] gains g_xl[i] d[j]
// + g_ul[i] u[j] from the local cotangents gl.
template <typename T>
__device__ __forceinline__ void rot_enter_vjp(const T* e, const T* gl,
                                              T* pr) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      pr[3 * i + j] = pr[3 * i + j] + gl[i] * e[j] + gl[3 + i] * e[3 + j];
}

// Hand-derived reverse of refract_spec's refraction (kind 1) or mirror
// (kind 2) of the direction u by the unnormalized normal n, shared by
// the conic and the figured rows: from the cotangent gv of the new
// direction, the cotangents of u, n and mu.  `unit`: |n| = 1 (a
// sphere's normal), no normalization to reverse (ir2 = 1 exactly).
template <typename T>
__device__ __forceinline__ void refraction_vjp(int kind, bool unit, T mu,
                                               T ux, T uy, T uz, T nx, T ny,
                                               T nz, T gvx, T gvy, T gvz,
                                               T& gux, T& guy, T& guz,
                                               T& gnx, T& gny, T& gnz,
                                               T& gmu) {
  const T dot = ux * nx + uy * ny + uz * nz;
  const T ir2 = unit ? T(1) : T(1) / (nx * nx + ny * ny + nz * nz);
  T gdot, gir2;
  if (kind == 2) {
    const T a2 = T(2) * dot * ir2;
    gux = gvx; guy = gvy; guz = gvz;
    gnx = -a2 * gvx; gny = -a2 * gvy; gnz = -a2 * gvz;
    const T ga2 = -(gvx * nx + gvy * ny + gvz * nz);
    gdot = T(2) * ir2 * ga2;
    gir2 = T(2) * dot * ga2;
    gmu = T(0);
  } else {
    const T muf = fabs(mu);
    const T sgmu = sgn(mu);
    const T a = muf * dot * ir2;
    const T sq2 = sqrt0(a * a - (mu * mu - T(1)) * ir2);
    const T q2 = -a + sgmu * sq2;
    T gmuf = ux * gvx + uy * gvy + uz * gvz;
    gux = muf * gvx; guy = muf * gvy; guz = muf * gvz;
    const T gq2 = gvx * nx + gvy * ny + gvz * nz;
    gnx = q2 * gvx; gny = q2 * gvy; gnz = q2 * gvz;
    const T gdisc2 = gq2 * sgmu * T(0.5) / sq2;
    const T ga = -gq2 + T(2) * a * gdisc2;
    gmu = -T(2) * mu * ir2 * gdisc2;
    gir2 = -(mu * mu - T(1)) * gdisc2 + muf * dot * ga;
    gmuf = gmuf + dot * ir2 * ga;
    gdot = muf * ir2 * ga;
    gmu = gmu + sgmu * gmuf;
  }
  gux = gux + gdot * nx; guy = guy + gdot * ny; guz = guz + gdot * nz;
  gnx = gnx + gdot * ux; gny = gny + gdot * uy; gnz = gnz + gdot * uz;
  if (!unit) {
    const T s2 = -T(2) * ir2 * ir2 * gir2;
    gnx = gnx + s2 * nx; gny = gny + s2 * ny; gnz = gnz + s2 * nz;
  }
}

// Reverse of e = e - dpoly_even(r2) (EVEN) - dpoly_odd(r2) (ODD), the
// figure's slope in a normal, from e's cotangent ge: adds the
// coefficients' cotangents into ga, gb and r2's into gr2
// (cuda_grad._figure_slope_vjp).
template <bool EVEN, bool ODD, typename T>
__device__ __forceinline__ void figure_slope_vjp(T r2, const Figure<T>& fg,
                                                 T ge, T* ga, T* gb,
                                                 T& gr2) {
  if (EVEN) {
    // d/dr2 and d/da_i of sum_i 2 (i+1) a_i r2^i, times -ge
    T dd = T(0), pw = T(1);
#pragma unroll
    for (int i = N_ASP - 1; i >= 1; --i)
      dd = dd * r2 + T(2 * (i + 1) * i) * fg.a[i];
#pragma unroll
    for (int i = 0; i < N_ASP; ++i) {
      ga[i] = ga[i] - T(2 * (i + 1)) * pw * ge;
      pw = pw * r2;
    }
    gr2 = gr2 - dd * ge;
  }
  if (ODD) {
    // dpoly_odd = q/r + 2 r q', r = max(sqrt(r2), TINY), times -ge
    T q = T(0), dq = T(0), ddq = T(0);
#pragma unroll
    for (int j = N_ODD - 1; j >= 0; --j) q = q * r2 + fg.b[j];
#pragma unroll
    for (int j = N_ODD - 1; j >= 1; --j) dq = dq * r2 + T(j) * fg.b[j];
#pragma unroll
    for (int j = N_ODD - 1; j >= 2; --j)
      ddq = ddq * r2 + T(j * (j - 1)) * fg.b[j];
    const T sr = sqrt(r2);
    const T r = floor_at(sr, T(TINY));
    const T gq = -ge / r;
    const T gdq = -ge * T(2) * r;
    const T gr = ge * q / (r * r) - ge * T(2) * dq;
    const T gsr = sr >= T(TINY) ? gr : T(0);
    gr2 = gr2 + gsr / (T(2) * sr) + gq * dq + gdq * ddq;
    T pw = T(1), pw1 = T(1);
#pragma unroll
    for (int j = 0; j < N_ODD; ++j) {
      gb[j] = gb[j] + gq * pw;
      if (j >= 1) {
        gb[j] = gb[j] + gdq * T(j) * pw1;
        pw1 = pw1 * r2;
      }
      pw = pw * r2;
    }
  }
}

// Reverse of F = F - poly_even(r2) - poly_odd(r2) (every coefficient of
// the table's widths), the figure's sag in a residual, from F's
// cotangent gF: adds the coefficients' cotangents into ga, gb and r2's
// into gr2 (cuda_grad._figure_sag_vjp).
template <typename T>
__device__ __forceinline__ void figure_sag_vjp(T r2, const Figure<T>& fg,
                                               T gF, T* ga, T* gb, T& gr2) {
  if (N_ASP) {
    // -sum_i a_i r2^(i+1)
    T d1 = T(0), pw = r2;
#pragma unroll
    for (int i = N_ASP - 1; i >= 0; --i)
      d1 = d1 * r2 + T(i + 1) * fg.a[i];
#pragma unroll
    for (int i = 0; i < N_ASP; ++i) {
      ga[i] = ga[i] - gF * pw;
      pw = pw * r2;
    }
    gr2 = gr2 - gF * d1;
  }
  if (N_ODD) {
    // -sqrt(r2) sum_j b_j r2^j
    T q = T(0), dq = T(0);
#pragma unroll
    for (int j = N_ODD - 1; j >= 0; --j) q = q * r2 + fg.b[j];
#pragma unroll
    for (int j = N_ODD - 1; j >= 1; --j) dq = dq * r2 + T(j) * fg.b[j];
    const T sr = sqrt(r2);
    gr2 = gr2 - gF * q / (T(2) * sr) - gF * sr * dq;
    T pw = sr;
#pragma unroll
    for (int j = 0; j < N_ODD; ++j) {
      gb[j] = gb[j] - gF * pw;
      pw = pw * r2;
    }
  }
}

// The coefficients' cotangents of a row, zeroed
template <typename T>
struct FigureGrad {
  T a[N_ASP > 0 ? N_ASP : 1];
  T b[N_ODD > 0 ? N_ODD : 1];
  __device__ __forceinline__ FigureGrad() {
#pragma unroll
    for (int i = 0; i < N_ASP; ++i) a[i] = T(0);
#pragma unroll
    for (int j = 0; j < N_ODD; ++j) b[j] = T(0);
  }
};

// The coefficients' cotangents into pg from slot q0: the even, then the
// odd
template <typename T>
__device__ __forceinline__ void put_figure(const FigureGrad<T>& gf, T* pg,
                                           int q0) {
#pragma unroll
  for (int i = 0; i < N_ASP; ++i) pg[q0 + i] = gf.a[i];
#pragma unroll
  for (int j = 0; j < N_ODD; ++j) pg[q0 + N_ASP + j] = gf.b[j];
}

// The cotangent of m from that of sq = sqrt0(m) (cuda_grad._sqrt0_vjp)
template <typename T>
__device__ __forceinline__ T sqrt0_vjp(T m, T sq, T g) {
  return m >= T(0) ? g * T(0.5) / sq : T(0);
}

// The cotangent of v from that of max(v, TINY) (cuda_grad._floor_vjp)
template <typename T>
__device__ __forceinline__ T floor_vjp(T v, T g) {
  return v >= T(TINY) ? g : T(0);
}

// ---- the freeform figure's reverse (cuda_grad's torch models of the
// same names) ----

// Reverse of (gx, gy) -= (dP/dx, dP/dy)(x1, y1), P = poly_xy, the XY
// figure's slopes in a normal, from the normal's cotangents (ggx, ggy):
// term t = (i, j) adds -(ggx i x^(i-1) y^j + ggy j x^i y^(j-1)) into
// gxy[t], and the point takes the figure's second derivatives
// (cuda_grad._xy_normal_vjp).
template <typename T>
__device__ __forceinline__ void xy_normal_vjp(T x1, T y1, const XyFig<T>& xf,
                                              T ggx, T ggy, T& gx1, T& gy1,
                                              T* gxy) {
  T xp[XY_DEG + 1], yp[XY_DEG + 1];
  xy_powers(x1, xp);
  xy_powers(y1, yp);
  T hx = T(0), hy = T(0);
  static_for(std::make_integer_sequence<int, N_XY>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    constexpr int i = xy_term_i(t), j = xy_term_j(t);
    T mx = T(0), my = T(0), hxx = T(0), hxy = T(0), hyy = T(0);
    if constexpr (i > 0) mx = T(i) * xp[i - 1] * yp[j];
    if constexpr (j > 0) my = T(j) * xp[i] * yp[j - 1];
    gxy[t] = gxy[t] - (ggx * mx + ggy * my);
    if constexpr (i > 1) hxx = T(i * (i - 1)) * xp[i - 2] * yp[j];
    if constexpr (i > 0 && j > 0) hxy = T(i * j) * xp[i - 1] * yp[j - 1];
    if constexpr (j > 1) hyy = T(j * (j - 1)) * xp[i] * yp[j - 2];
    hx = hx - xf.a[t] * (ggx * hxx + ggy * hxy);
    hy = hy - xf.a[t] * (ggx * hxy + ggy * hyy);
  });
  gx1 = gx1 + hx;
  gy1 = gy1 + hy;
}

// Reverse of F -= P(px, py), the XY figure in a residual, from F's
// cotangent gF: term t = (i, j) adds -gF x^i y^j into gxy[t], the point
// -gF (dP/dx, dP/dy) into gpx, gpy (cuda_grad._xy_sag_vjp).
template <typename T>
__device__ __forceinline__ void xy_sag_vjp(T px, T py, const XyFig<T>& xf,
                                           T gF, T& gpx, T& gpy, T* gxy) {
  T xp[XY_DEG + 1], yp[XY_DEG + 1];
  xy_powers(px, xp);
  xy_powers(py, yp);
  static_for(std::make_integer_sequence<int, N_XY>{}, [&](auto tc) {
    constexpr int t = decltype(tc)::value;
    constexpr int i = xy_term_i(t), j = xy_term_j(t);
    gxy[t] = gxy[t] - gF * (xp[i] * yp[j]);
  });
  T dpx, dpy;
  dpoly_xy(px, py, xf, dpx, dpy);
  gpx = gpx + -gF * dpx;
  gpy = gpy + -gF * dpy;
}

// ---- the phase rows' reverse (K5, K7, K9; cuda_grad's torch models of
// the same names, line for line) ----

// Hand-derived reverse of grating_refract (cuda_grad._grating_refract_vjp)
// for one live ray: from the new direction's cotangent gv, the incoming
// direction's (gu), the normal's (ggx, ggy), mu's, the grating term's
// (ggdy) and (KICK) the DOE coefficients' (gdoe) and the point's (added
// into gx1, gy1).  Gamma's two roots (the mirror's by sgn(bn), the
// transmission's by sgn(mu)), |mu|, the groove vector's TINY floor and
// the kick are reversed; sgn has no cotangent.  A row that passes the
// ray on (phase_keep) hands gv on to u.
template <bool KICK, typename T>
__device__ __forceinline__ void grating_refract_vjp(
    T mu, T gdy, T ngx, T ngy, T x1, T y1, const Doe<T>& dc, T ux, T uy,
    T uz, T gvx, T gvy, T gvz, T& gux, T& guy, T& guz, T& ggx, T& ggy,
    T& gmu, T& ggdy, T* gdoe, T& gx1, T& gy1) {
#pragma unroll
  for (int i = 0; i < N_DOE; ++i) gdoe[i] = T(0);
  if (phase_keep<KICK>(mu, gdy, dc)) {
    gux = gvx; guy = gvy; guz = gvz;
    ggx = ggy = gmu = ggdy = T(0);
    return;
  }
  // ---- forward recompute ----
  const T inv = T(1) / (ngx * ngx + ngy * ngy + T(1));
  const T muf = fabs(mu);
  const T qx0 = -ngy * ngx * inv;
  const T qy0 = T(1) - ngy * ngy * inv;
  const T qz0 = -ngy * inv;
  const T m = qx0 * qx0 + qy0 * qy0 + qz0 * qz0;
  const T qn = T(1) / sqrt(floor_at(m, T(TINY)));
  const T qx = qx0 * qn, qy = qy0 * qn, qz = qz0 * qn;
  T bx = muf * ux + gdy * qx;
  T by = muf * uy + gdy * qy;
  const T bz = muf * uz + gdy * qz;
  T r2 = T(0), ek = T(0);
  if constexpr (KICK) {
    r2 = x1 * x1 + y1 * y1;
    ek = doe_slope(r2, dc);
    bx = bx + ek * x1;
    by = by + ek * y1;
  }
  const T dot = bx * ngx + by * ngy + bz;
  const T bn = dot * inv;
  const T bb = bx * bx + by * by + bz * bz;
  const T disc = bn * bn - (bb - T(1)) * inv;
  const T root = sqrt0(disc);
  const bool mirror = mu == T(-1);
  const T gam = mirror ? -bn - sgn(bn) * root : -bn + sgn(mu) * root;
  // ---- reverse: u' = b + gam (ngx, ngy, 1) ----
  T gbx = gvx, gby = gvy, gbz = gvz;
  const T ggam = gvx * ngx + gvy * ngy + gvz;
  ggx = gvx * gam;
  ggy = gvy * gam;
  T gbn = -ggam;
  const T groot = (mirror ? -sgn(bn) : sgn(mu)) * ggam;
  const T gdisc = sqrt0_vjp(disc, root, groot);
  // disc = bn^2 - (bb - 1) inv
  gbn = gbn + T(2) * bn * gdisc;
  const T gbb = -inv * gdisc;
  T ginv = -(bb - T(1)) * gdisc;
  gbx = gbx + T(2) * bx * gbb;
  gby = gby + T(2) * by * gbb;
  gbz = gbz + T(2) * bz * gbb;
  // bn = (b . (ngx, ngy, 1)) inv
  const T gdot = gbn * inv;
  ginv = ginv + gbn * dot;
  gbx = gbx + gdot * ngx;
  gby = gby + gdot * ngy;
  gbz = gbz + gdot;
  ggx = ggx + gdot * bx;
  ggy = ggy + gdot * by;
  // b = |mu| u + gdy q + s
  const T gmuf = gbx * ux + gby * uy + gbz * uz;
  gux = muf * gbx; guy = muf * gby; guz = muf * gbz;
  ggdy = gbx * qx + gby * qy + gbz * qz;
  const T gqx = gdy * gbx, gqy = gdy * gby, gqz = gdy * gbz;
  if constexpr (KICK) {
    // s = ek(r2) (x1, y1), ek = sum 2 (i+1) a_i r2^i
    const T gek = gbx * x1 + gby * y1;
    T dd = T(0), pw = T(1);
#pragma unroll
    for (int i = N_DOE - 1; i >= 1; --i)
      dd = dd * r2 + T(2 * (i + 1) * i) * dc.a[i];
#pragma unroll
    for (int i = 0; i < N_DOE; ++i) {
      gdoe[i] = T(2 * (i + 1)) * pw * gek;
      pw = pw * r2;
    }
    const T gr2 = dd * gek;
    gx1 = gx1 + (ek * gbx + T(2) * x1 * gr2);
    gy1 = gy1 + (ek * gby + T(2) * y1 * gr2);
  }
  // q = q0 qn, qn = 1/sqrt(max(q0 . q0, TINY))
  const T gqn = gqx * qx0 + gqy * qy0 + gqz * qz0;
  const T gm = floor_vjp(m, T(-0.5) * qn * qn * qn * gqn);
  const T gq0x = gqx * qn + T(2) * qx0 * gm;
  const T gq0y = gqy * qn + T(2) * qy0 * gm;
  const T gq0z = gqz * qn + T(2) * qz0 * gm;
  // q0 = (-ngy ngx inv, 1 - ngy^2 inv, -ngy inv), inv = 1/|n|^2
  ggx = ggx - ngy * inv * gq0x;
  ggy = ggy - ngx * inv * gq0x - T(2) * ngy * inv * gq0y - inv * gq0z;
  ginv = ginv - ngy * ngx * gq0x - ngy * ngy * gq0y - ngy * gq0z;
  const T gnn = -inv * inv * ginv;
  ggx = ggx + T(2) * ngx * gnn;
  ggy = ggy + T(2) * ngy * gnn;
  gmu = sgn(mu) * gmuf;
}

// Reverse of radial_phase_normal (cuda_grad._radial_phase_vjp) from the
// normal's cotangents: adds into gx1, gy1, gc, gk and (FIG) gf.
template <bool FLAT, bool FIG, typename T>
__device__ __forceinline__ void radial_phase_vjp(T x1, T y1, T c, T k,
                                                 const Figure<T>& fg, T ggx,
                                                 T ggy, T& gx1, T& gy1,
                                                 T& gc, T& gk,
                                                 FigureGrad<T>& gf) {
  if constexpr (!FLAT) {
    const T r2 = x1 * x1 + y1 * y1;
    const T kc2 = (T(1) + k) * c * c;
    const T w = T(1) - kc2 * r2;
    const T s = sqrt0(w);
    T e = -c / s;
    if constexpr (FIG) {
      if (N_ASP) e = e - dpoly_even(r2, fg.a);
      if (N_ODD) e = e - dpoly_odd(r2, fg.b);
    }
    const T ge = x1 * ggx + y1 * ggy;
    gx1 = gx1 + e * ggx;
    gy1 = gy1 + e * ggy;
    gc = gc - ge / s;
    const T gw = sqrt0_vjp(w, s, ge * c / (s * s));
    gk = gk - c * c * r2 * gw;
    gc = gc - T(2) * (T(1) + k) * c * r2 * gw;
    T gr2 = -kc2 * gw;
    if constexpr (FIG) {
      figure_slope_vjp<(N_ASP > 0), (N_ODD > 0)>(r2, fg, ge, gf.a, gf.b, gr2);
    }
    gx1 = gx1 + T(2) * x1 * gr2;
    gy1 = gy1 + T(2) * y1 * gr2;
  }
}

// Reverse of a DOE row's optical path term psi(r2) n_after (K9's PATH;
// cuda_grad._doe_path_vjp): coefficient i's cotangent ct_path n_after
// r2^(i+1) added into gdoe, the intercept point's ct_path n_after
// psi'(r2) 2 (x1, y1) into gx1, gy1; returns n_after's, ct_path psi(r2).
template <typename T, typename Row>
__device__ __forceinline__ T doe_path_vjp(Row p, T x1, T y1, const Doe<T>& dc,
                                          T ct_path, T* gdoe, T& gx1,
                                          T& gy1) {
  const T r2 = x1 * x1 + y1 * y1;
  const T gp = ct_path * p[P_NA];
  T pw = r2;
#pragma unroll
  for (int i = 0; i < N_DOE; ++i) {
    gdoe[i] = gdoe[i] + gp * pw;
    pw = pw * r2;
  }
  const T e = gp * doe_slope(r2, dc);
  gx1 = gx1 + e * x1;
  gy1 = gy1 + e * y1;
  return ct_path * doe_psi(r2, dc);
}

// A phase row's grating_dy, (PATH) n_after and DOE coefficients'
// cotangents into pg: K5's and K7's at Q_GDY and Q_DOE, K9's one slot
// further on with n_after's at Q_DOE + 1; zeros where the row is no
// grating, no DOE.
template <bool PATH, typename Flags, typename T>
__device__ __forceinline__ void put_phase(Flags, T ggdy, const T* gdoe,
                                          T gna, T* pg) {
  constexpr int q = PATH ? 1 : 0;
  constexpr bool doe = (Flags::value & F_DOE) != 0;
  if constexpr (N_GRAT > 0) {
    pg[Q_GDY + q] = (Flags::value & F_GRATING) ? ggdy : T(0);
  }
  if constexpr (PATH && N_DOE > 0) pg[Q_DOE + 1] = doe ? gna : T(0);
#pragma unroll
  for (int i = 0; i < N_DOE; ++i)
    pg[Q_DOE + 2 * q + i] = doe ? gdoe[i] : T(0);
}

// The phase solve's reverse on a radial (or flat) substrate, shared by
// surface_step_vjp and figured_step_vjp: the solve's (grating_refract_vjp)
// then the normal's (radial_phase_vjp; XY: a freeform row's, less the XY
// slopes, xy_normal_vjp into gxy), then (PATH) a DOE's path term's
// (doe_path_vjp); the incoming direction's cotangents out, the point's,
// c's, k's and (FIG) the coefficients' added in, mu's out, grating_dy's,
// (PATH) n_after's and the DOE's into pg.
template <bool FLAT, bool FIG, bool PATH, bool XY = false, typename T,
          typename Flags, typename Row>
__device__ __forceinline__ void radial_phase_step_vjp(
    Row p, Flags flags, T x1, T y1, T c, T k, T mu, const Figure<T>& fg,
    T ux, T uy, T uz, T gvx, T gvy, T gvz, T& gux, T& guy, T& guz, T& gx1,
    T& gy1, T& gc, T& gk, T& gmu, FigureGrad<T>& gf, T* pg, T ct_path,
    const XyFig<T>* xf = nullptr, T* gxy = nullptr) {
  constexpr bool doe = (Flags::value & F_DOE) != 0;
  Doe<T> dc{};
  if constexpr (doe) dc = load_doe<T>(p);
  T gdy = T(0);
  if constexpr ((Flags::value & F_GRATING) != 0) gdy = p[P_GDY];
  T ngx, ngy, ggx, ggy, ggdy, gdoe[N_DOE > 0 ? N_DOE : 1];
  if constexpr (XY) {
    freeform_normal(x1, y1, c, k, fg, *xf, ngx, ngy);
  } else {
    radial_phase_normal<FLAT, FIG>(x1, y1, c, k, fg, ngx, ngy);
  }
  grating_refract_vjp<doe>(mu, gdy, ngx, ngy, x1, y1, dc, ux, uy, uz, gvx,
                           gvy, gvz, gux, guy, guz, ggx, ggy, gmu, ggdy,
                           gdoe, gx1, gy1);
  radial_phase_vjp<FLAT, FIG>(x1, y1, c, k, fg, ggx, ggy, gx1, gy1, gc, gk,
                              gf);
  if constexpr (XY) xy_normal_vjp(x1, y1, *xf, ggx, ggy, gx1, gy1, gxy);
  T gna = T(0);
  if constexpr (PATH && doe)
    gna = doe_path_vjp(p, x1, y1, dc, ct_path, gdoe, gx1, gy1);
  put_phase<PATH>(flags, ggdy, gdoe, gna, pg);
}

// Hand-derived reverse of a FIGURED row's step (surface_step with
// F_ASPHERIC or F_ODD) for one live ray, as surface_step_vjp: the
// refraction (refraction_vjp) by the radial normal (x1 e, y1 e, 1) and
// the figures' slopes in e, the transfer, then the Newton intercept
// differentiated implicitly at its root -- one residual gradient dF/dp
// scaled by -gt / F_s, the seed holding no cotangent
// (kernels._NewtonRoot).  A FREEFORM row (F_FREEFORM, with or without an
// aspheric figure) takes its Newton with the XY figure and the
// vertex-plane restart (freeform_intercept), and refracts, or solves its
// phase, on the freeform normal (freeform_normal: every coefficient of
// the widths, less the XY slopes; Snell or a mirror by general_refract's
// form, whose mirror reads |mu|): the normal's reverse takes the XY
// figure's second derivatives (xy_normal_vjp), the residual's each
// coefficient's -gF x^i y^j (xy_sag_vjp); the XY coefficients'
// cotangents go to pg from Q_XY, last.  With PATH (K9) the row's optical path t *
// n_before adds ct_path * n_before to gt before that step, and n_before
// takes ct_path * t.  pg: out, without PATH FIG_SLOTS cotangents (c, k,
// offset x, y, z, mu, the even, then the odd coefficients), with PATH
// OPD_FIG_SLOTS (n_before between mu and the coefficients).  Its torch
// model is the figured branch of cuda_grad._step_vjp_reference.  An
// on-axis ray through an odd figure gets NaN (sqrt(r2) at r2 = 0), as
// autograd and the reference give.
template <typename T, bool PATH, typename Flags, typename Row>
__device__ __forceinline__ void figured_step_vjp(Row p, Flags, const T* s,
                                                 T* g, T* pg, T ct_path,
                                                 const T* so) {
  constexpr int fl = Flags::value;
  constexpr bool off_axis = fl & F_OFF_AXIS;
  constexpr bool rotated = fl & F_ROTATED;
  // a rot key's rotation cotangent on a rotated row
  constexpr bool rot_g = N_ROT > 0 && rotated;
  constexpr int kind = (fl >> KIND_SHIFT) & 3;
  constexpr bool ff = (fl & F_FREEFORM) != 0;
  const T c = p[P_C];
  const T k = p[P_K];
  const T mu = p[P_MU];
  const Figure<T> fg = load_figure<T>(p);
  XyFig<T> xf{};
  if constexpr (ff) xf = load_xy<T>(p);
  T x = s[0], y = s[1], z = s[2], ux = s[3], uy = s[4], uz = s[5];
  // ---- forward recompute ----
  if (off_axis) {
    x = x - p[P_OFF];
    y = y - p[P_OFF + 1];
  }
  z = z - p[P_OFF + 2];
  // a rot key's entering position less the offset, and direction
  [[maybe_unused]] T e0[6];
  if constexpr (rot_g) {
    e0[0] = x; e0[1] = y; e0[2] = z; e0[3] = ux; e0[4] = uy; e0[5] = uz;
  }
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  T t;
  if constexpr (ff) {
    t = freeform_intercept(x, y, z, ux, uy, uz, c, k, sg, fg, xf);
  } else {
    t = newton_intercept(x, y, z, ux, uy, uz, c, k, sg, fg);
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  // ---- reverse: leave the row's frame ----
  [[maybe_unused]] T* pr = pg + rot_slot<PATH>();
  if constexpr (rot_g) rot_leave_vjp(p + P_ROT, so, g, pr);
  T gx1 = g[0], gy1 = g[1], gz1 = g[2], gvx = g[3], gvy = g[4], gvz = g[5];
  if (rotated) {
    rot_apply(p + P_ROT, gx1, gy1, gz1);
    rot_apply(p + P_ROT, gvx, gvy, gvz);
  }
  T gc = T(0), gk = T(0), gmu = T(0), gux, guy, guz;
  FigureGrad<T> gf;
  T gxy[N_XY > 0 ? N_XY : 1];
#pragma unroll
  for (int q = 0; q < N_XY; ++q) gxy[q] = T(0);
  // ---- reverse: refraction by the radial (or freeform) normal ----
  if constexpr ((fl & F_PHASE) != 0) {
    // the phase solve on the normal of every coefficient of the widths
    // (a freeform row's less its XY slopes)
    radial_phase_step_vjp<false, true, PATH, ff>(
        p, Flags{}, x1, y1, c, k, mu, fg, ux, uy, uz, gvx, gvy, gvz, gux, guy,
        guz, gx1, gy1, gc, gk, gmu, gf, pg, ct_path, &xf, gxy);
  } else if (kind == 0) {
    gux = gvx; guy = gvy; guz = gvz;
  } else if constexpr (ff) {
    // Snell or a mirror on the freeform normal (gx, gy, 1)
    T ngx, ngy, gnx, gny, gnz;
    freeform_normal(x1, y1, c, k, fg, xf, ngx, ngy);
    refraction_vjp(kind, false, mu, ux, uy, uz, ngx, ngy, T(1), gvx, gvy, gvz,
                   gux, guy, guz, gnx, gny, gnz, gmu);
    if (kind == 2) {
      // the reflection's a = |mu| (u . n) / |n|^2 with |mu| = 1
      const T nn = ngx * ngx + ngy * ngy + T(1);
      gmu = -sgn(mu) * T(2) * (ux * ngx + uy * ngy + uz) / nn *
            (gvx * ngx + gvy * ngy + gvz);
    }
    radial_phase_vjp<false, true>(x1, y1, c, k, fg, gnx, gny, gx1, gy1, gc,
                                  gk, gf);
    xy_normal_vjp(x1, y1, xf, gnx, gny, gx1, gy1, gxy);
  } else {
    const T r2s = x1 * x1 + y1 * y1;
    const T kc2 = (T(1) + k) * c * c;
    const T m = T(1) - kc2 * r2s;
    const T mm = floor_at(m, T(TINY));
    const T rs = T(1) / sqrt(mm);
    T e = -c * rs;
    if (fl & F_ASPHERIC) e = e - dpoly_even(r2s, fg.a);
    if (fl & F_ODD) e = e - dpoly_odd(r2s, fg.b);
    const T nx = x1 * e;
    const T ny = y1 * e;
    T gnx, gny, gnz;
    refraction_vjp(kind, false, mu, ux, uy, uz, nx, ny, T(1), gvx, gvy, gvz,
                   gux, guy, guz, gnx, gny, gnz, gmu);
    // n = (x1 e, y1 e)
    const T ge = x1 * gnx + y1 * gny;
    gx1 = gx1 + e * gnx; gy1 = gy1 + e * gny;
    // e = -c rs - dpoly_even - dpoly_odd, rs = 1/sqrt(max(m, TINY))
    gc = gc - rs * ge;
    const T gm = m >= T(TINY) ? T(-0.5) * rs * rs * rs * (-c * ge) : T(0);
    gk = gk - c * c * r2s * gm;
    gc = gc - T(2) * (T(1) + k) * c * r2s * gm;
    T gr2s = -kc2 * gm;
    figure_slope_vjp<(fl & F_ASPHERIC) != 0, (fl & F_ODD) != 0>(
        r2s, fg, ge, gf.a, gf.b, gr2s);
    gx1 = gx1 + T(2) * x1 * gr2s;
    gy1 = gy1 + T(2) * y1 * gr2s;
  }
  // ---- reverse: transfer x1 = x + t u ----
  T gx = gx1, gy = gy1, gz = gz1;
  gux = gux + t * gx1; guy = guy + t * gy1; guz = guz + t * gz1;
  T gt = ux * gx1 + uy * gy1 + uz * gz1;
  if constexpr (PATH) {
    gt = gt + ct_path * p[P_NB];
    pg[6] = ct_path * t;
  }
  // ---- reverse: the Newton root, implicitly: dF/dp * (-gt / F_s) ----
  T fs;
  if constexpr (ff) {
    fs = freeform_slope(t, x, y, ux, uy, uz, c, k, fg, xf);
  } else {
    fs = newton_slope(t, x, y, ux, uy, uz, c, k, fg);
  }
  const T gF = -gt / fs;
  {
    // F = pz - c r2 / (1 + sqrt0(w)) - poly_even(r2) - poly_odd(r2),
    // w = 1 - (1+k) c^2 r2, at p = (x, y, z) + t u
    const T px = x + t * ux;
    const T py = y + t * uy;
    const T r2 = px * px + py * py;
    const T kc2 = (T(1) + k) * c * c;
    const T w = T(1) - kc2 * r2;
    const T sq = sqrt0(w);
    const T den = T(1) + sq;
    const T gnum = -gF / den;                    // of c r2
    const T gsq = gF * (c * r2) / (den * den);   // of sq
    const T gw = w >= T(0) ? gsq / (T(2) * sq) : T(0);
    gk = gk - c * c * r2 * gw;
    gc = gc - T(2) * (T(1) + k) * c * r2 * gw + r2 * gnum;
    T gr2 = -kc2 * gw + c * gnum;
    figure_sag_vjp(r2, fg, gF, gf.a, gf.b, gr2);
    T gpx = T(2) * px * gr2;
    T gpy = T(2) * py * gr2;
    if constexpr (ff) xy_sag_vjp(px, py, xf, gF, gpx, gpy, gxy);
    gx = gx + gpx; gy = gy + gpy; gz = gz + gF;
    gux = gux + t * gpx; guy = guy + t * gpy; guz = guz + t * gF;
  }
  // ---- reverse: enter the row's frame ----
  if constexpr (rot_g) {
    const T gl[6] = {gx, gy, gz, gux, guy, guz};
    rot_enter_vjp(e0, gl, pr);
  }
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
  put_figure(gf, pg, PATH ? OPD_SLOTS : SLOTS);
  if constexpr (ff) {
    constexpr int q = Q_XY + (PATH ? 1 + (N_DOE > 0 ? 1 : 0) : 0);
#pragma unroll
    for (int t = 0; t < N_XY; ++t) pg[q + t] = gxy[t];
  }
}

// ---- the anamorphic rows' reverses (cuda_grad's torch models of the
// same names, line for line) ----

// Reverse of a = cx x2 + cy y2, B = (1+kx) cx^2 x2 + (1+ky) cy^2 y2 from
// ga, gb: adds to gpx, gpy and ga4 = (gcx, gkx, gcy, gky)
// (cuda_grad._biconic_ab_vjp)
template <typename T>
__device__ __forceinline__ void biconic_ab_vjp(T px, T py, const Anam<T>& a,
                                               T ga, T gb, T x2, T y2,
                                               T& gpx, T& gpy, T* gp) {
  const T gx2 = ga * a.pa + gb * (T(1) + a.pb) * a.pa * a.pa;
  const T gy2 = ga * a.pc + gb * (T(1) + a.pd) * a.pc * a.pc;
  gp[0] = gp[0] + ga * x2 + gb * x2 * T(2) * (T(1) + a.pb) * a.pa;
  gp[2] = gp[2] + ga * y2 + gb * y2 * T(2) * (T(1) + a.pd) * a.pc;
  gp[1] = gp[1] + gb * x2 * a.pa * a.pa;
  gp[3] = gp[3] + gb * y2 * a.pc * a.pc;
  gpx = gpx + T(2) * px * gx2;
  gpy = gpy + T(2) * py * gy2;
}

// Reverse of the biconic's residual (cuda_grad._biconic_sag_vjp): adds
// to gpx, gpy, gp and (FIG: the row's aspheric figure, in r2) gf (pz's
// cotangent is gF)
template <bool FIG, typename T>
__device__ __forceinline__ void biconic_sag_vjp(T px, T py, const Anam<T>& a,
                                                const Figure<T>& fg, T gF,
                                                T& gpx, T& gpy, T* gp,
                                                FigureGrad<T>& gf) {
  const T x2 = px * px, y2 = py * py;
  const T num = a.pa * x2 + a.pc * y2;
  const T qx = (T(1) + a.pb) * a.pa * a.pa;
  const T qy = (T(1) + a.pd) * a.pc * a.pc;
  const T m = T(1) - (qx * x2 + qy * y2);
  const T sq = sqrt0(m);
  const T den = T(1) + sq;
  const T ga = -gF / den;
  const T gb = -sqrt0_vjp(m, sq, gF * num / (den * den));
  biconic_ab_vjp(px, py, a, ga, gb, x2, y2, gpx, gpy, gp);
  if constexpr (FIG) {
    T gr2 = T(0);
    figure_sag_vjp(x2 + y2, fg, gF, gf.a, gf.b, gr2);
    gpx = gpx + T(2) * px * gr2;
    gpy = gpy + T(2) * py * gr2;
  }
}

// Reverse of biconic_normal (cuda_grad._biconic_normal_vjp) from the
// cotangents of (gx, gy): adds to gx1, gy1, gp and (FIG) gf
template <bool FIG, typename T>
__device__ __forceinline__ void biconic_normal_vjp(T x, T y, const Anam<T>& a,
                                                   const Figure<T>& fg,
                                                   T ggx, T ggy, T& gx1,
                                                   T& gy1, T* gp,
                                                   FigureGrad<T>& gf) {
  const T x2 = x * x, y2 = y * y;
  const T num = a.pa * x2 + a.pc * y2;
  const T qx = (T(1) + a.pb) * a.pa * a.pa;
  const T qy = (T(1) + a.pd) * a.pc * a.pc;
  const T m = T(1) - (qx * x2 + qy * y2);
  const T sq = sqrt0(m);
  const T ss = floor_at(sq, T(TINY));
  const T inv = T(1) / (T(1) + sq);
  const T px_ = T(2) * a.pa * x * (T(1) + sq) + num * qx * x / ss;
  const T py_ = T(2) * a.pc * y * (T(1) + sq) + num * qy * y / ss;
  const T gpx_ = -ggx * inv * inv;
  const T gpy_ = -ggy * inv * inv;
  const T ginv = -T(2) * inv * (ggx * px_ + ggy * py_);
  T gsq = -ginv * inv * inv + gpx_ * T(2) * a.pa * x + gpy_ * T(2) * a.pc * y;
  const T gss = -(gpx_ * num * qx * x + gpy_ * num * qy * y) / (ss * ss);
  gsq = gsq + floor_vjp(sq, gss);
  const T ga = gpx_ * qx * x / ss + gpy_ * qy * y / ss;
  const T gqx = gpx_ * num * x / ss;
  const T gqy = gpy_ * num * y / ss;
  gx1 = gx1 + gpx_ * (T(2) * a.pa * (T(1) + sq) + num * qx / ss);
  gy1 = gy1 + gpy_ * (T(2) * a.pc * (T(1) + sq) + num * qy / ss);
  gp[0] = gp[0] + gpx_ * T(2) * x * (T(1) + sq) + gqx * T(2) * (T(1) + a.pb) * a.pa;
  gp[2] = gp[2] + gpy_ * T(2) * y * (T(1) + sq) + gqy * T(2) * (T(1) + a.pd) * a.pc;
  gp[1] = gp[1] + gqx * a.pa * a.pa;
  gp[3] = gp[3] + gqy * a.pc * a.pc;
  const T gb = -sqrt0_vjp(m, sq, gsq);
  biconic_ab_vjp(x, y, a, ga, gb, x2, y2, gx1, gy1, gp);
  if constexpr (FIG) {
    // (gx, gy) -= (x, y) D(r2), D = dpoly_even + dpoly_odd
    const T r2 = x2 + y2;
    T d = T(0);
    if (N_ASP) d = d + dpoly_even(r2, fg.a);
    if (N_ODD) d = d + dpoly_odd(r2, fg.b);
    gx1 = gx1 - d * ggx;
    gy1 = gy1 - d * ggy;
    T gr2 = T(0);
    figure_slope_vjp<(N_ASP > 0), (N_ODD > 0)>(r2, fg, x * ggx + y * ggy,
                                               gf.a, gf.b, gr2);
    gx1 = gx1 + T(2) * x * gr2;
    gy1 = gy1 + T(2) * y * gr2;
  }
}

// Reverse of ycurve (cuda_grad._ycurve_vjp) from the cotangents of (zy,
// dzy): adds to gy, gcy, gky and (FIG: the figure in y^2) gf
template <bool FIG, typename T>
__device__ __forceinline__ void ycurve_vjp(T y, T cy, T ky,
                                           const Figure<T>& fg, T gzy,
                                           T gdzy, T& gy, T& gcy, T& gky,
                                           FigureGrad<T>& gf) {
  const T y2 = y * y;
  const T m = T(1) - (T(1) + ky) * cy * cy * y2;
  const T sq = sqrt0(m);
  const T sqs = floor_at(sq, T(TINY));
  gcy = gcy + gdzy * y / sqs + gzy * y2 / (T(1) + sq);
  gy = gy + gdzy * cy / sqs;
  const T gsq = floor_vjp(sq, -gdzy * cy * y / (sqs * sqs)) -
                gzy * cy * y2 / ((T(1) + sq) * (T(1) + sq));
  T gy2 = gzy * cy / (T(1) + sq);
  const T gm = sqrt0_vjp(m, sq, gsq);
  gky = gky - gm * cy * cy * y2;
  gcy = gcy - gm * T(2) * (T(1) + ky) * cy * y2;
  gy2 = gy2 - gm * (T(1) + ky) * cy * cy;
  if constexpr (FIG) {
    // zy += poly(y2), dzy += y D(y2), D = dpoly_even + dpoly_odd
    T d = T(0);
    if (N_ASP) d = d + dpoly_even(y2, fg.a);
    if (N_ODD) d = d + dpoly_odd(y2, fg.b);
    gy = gy + gdzy * d;
    figure_sag_vjp(y2, fg, -gzy, gf.a, gf.b, gy2);
    figure_slope_vjp<(N_ASP > 0), (N_ODD > 0)>(y2, fg, -gdzy * y, gf.a, gf.b,
                                               gy2);
  }
  gy = gy + T(2) * y * gy2;
}

// Reverse of the toroid's residual (cuda_grad._toroid_sag_vjp): adds to
// gpx, gpy, gp = (gcr, gcy, gky) and (FIG) gf (pz's cotangent is gF)
template <bool FIG, typename T>
__device__ __forceinline__ void toroid_sag_vjp(T px, T py, const Anam<T>& a,
                                               const Figure<T>& fg, T gF,
                                               T& gpx, T& gpy, T* gp,
                                               FigureGrad<T>& gf) {
  T zy, dzy;
  ycurve<FIG>(py, a.pb, a.pc, fg, zy, dzy);
  const T den = T(1) - a.pa * zy;
  const T crp = a.pa / den;
  const T x2 = px * px;
  const T u = T(1) - x2 * crp * crp;
  const T wr = sqrt0(u);
  const T d = T(1) + wr;
  const T gt = -gF;
  const T gu = sqrt0_vjp(u, wr, -gt * crp * x2 / (d * d));
  const T gcrp = gt * x2 / d - gu * T(2) * x2 * crp;
  const T gx2 = gt * crp / d - gu * crp * crp;
  const T gden = -gcrp * a.pa / (den * den);
  gp[0] = gp[0] + gcrp / den - gden * zy;
  ycurve_vjp<FIG>(py, a.pb, a.pc, fg, -gF - gden * a.pa, T(0), gpy, gp[1],
                  gp[2], gf);
  gpx = gpx + T(2) * px * gx2;
}

// Reverse of toroid_normal (cuda_grad._toroid_normal_vjp): adds to gx1,
// gy1, gp and (FIG) gf
template <bool FIG, typename T>
__device__ __forceinline__ void toroid_normal_vjp(T x, T y, const Anam<T>& a,
                                                  const Figure<T>& fg,
                                                  T ggx, T ggy, T& gx1,
                                                  T& gy1, T* gp,
                                                  FigureGrad<T>& gf) {
  T zy, dzy;
  ycurve<FIG>(y, a.pb, a.pc, fg, zy, dzy);
  const T den = T(1) - a.pa * zy;
  const T crp = a.pa / den;
  const T u = T(1) - x * x * crp * crp;
  const T wr = sqrt0(u);
  const T w = floor_at(wr, T(TINY));
  T gx = -ggx * crp / w;
  T gcrp = -ggx * x / w;
  const T gw = (ggx * x * crp + ggy * dzy) / (w * w);
  const T gdzy = -ggy / w;
  const T gu = sqrt0_vjp(u, wr, floor_vjp(wr, gw));
  gx = gx - gu * T(2) * x * crp * crp;
  gcrp = gcrp - gu * T(2) * x * x * crp;
  const T gden = -gcrp * a.pa / (den * den);
  gp[0] = gp[0] + gcrp / den - gden * zy;
  ycurve_vjp<FIG>(y, a.pb, a.pc, fg, -gden * a.pa, gdzy, gy1, gp[1], gp[2],
                  gf);
  gx1 = gx1 + gx;
}

// Hand-derived reverse of an ANAMORPHIC row's step (surface_step with
// F_CYL_Y, F_CYL_X, F_BICONIC or F_TOROID; a biconic or toroid with the
// figure of the key's widths, when it has any) for one live ray, as
// surface_step_vjp.  A cylinder
// reverses its closed form in its curved coordinate and its refraction
// by refraction_vjp on the normal with a zero flat-axis component; a
// biconic or toroid refracts by its (gx, gy, 1) normal, then its Newton
// root is differentiated implicitly, dF/dp scaled by -gt / F_s.  A
// grating or DOE on a cylinder (F_BICONIC or F_TOROID beside F_CYL_*)
// reverses the phase solve on the normal of the biconic or toroid that
// made it (with the figure of the key's widths), then the cylinder's
// closed form; its (C, K) and the normal's parameters both land on the
// row's c, k, curvature_dx and conic_dx.  With
// PATH (K9) the row's optical path t * n_before adds ct_path * n_before
// to gt before the intercept's reverse (the implicit step's or the
// closed form's), and n_before takes ct_path * t.  pg: out, without PATH
// FIG_SLOTS cotangents (c, k, offset x, y, z, mu, a figured key's even
// and odd coefficients -- a cylinder's zeros --, then curvature_dx and
// conic_dx at Q_CDX), with
// PATH OPD_FIG_SLOTS (n_before after mu; the rest one slot further on).
// Its torch model is cuda_grad._anamorphic_vjp_reference.
template <typename T, bool PATH, typename Flags, typename Row>
__device__ __forceinline__ void anamorphic_step_vjp(Row p, Flags, const T* s,
                                                    T* g, T* pg, T ct_path,
                                                    const T* so) {
  constexpr int fl = Flags::value;
  constexpr bool off_axis = fl & F_OFF_AXIS;
  constexpr bool rotated = fl & F_ROTATED;
  // a rot key's rotation cotangent on a rotated row
  constexpr bool rot_g = N_ROT > 0 && rotated;
  constexpr int kind = (fl >> KIND_SHIFT) & 3;
  constexpr int cyl = (fl & F_CYL_Y) ? 1 : ((fl & F_CYL_X) ? 2 : 0);
  constexpr bool toroid = (fl & F_TOROID) != 0;
  // the normal of a biconic or toroid: a Newton row's, a phase
  // cylinder's (surface_step)
  constexpr bool anam_n = (fl & F_ANAM_NEWTON) != 0;
  // a biconic's or toroid's Newton and normal read every coefficient of
  // the key's widths, figured or not (surface_step)
  constexpr bool fig = anam_n && N_ASP + N_ODD > 0;
  static_assert(!cyl || !(fl & F_FIGURED),
                "a cylinder row has no aspheric figure");
  const T c = p[P_C];
  const T k = p[P_K];
  const T mu = p[P_MU];
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  T x = s[0], y = s[1], z = s[2], ux = s[3], uy = s[4], uz = s[5];
  // ---- forward recompute ----
  if (off_axis) {
    x = x - p[P_OFF];
    y = y - p[P_OFF + 1];
  }
  z = z - p[P_OFF + 2];
  // a rot key's entering position less the offset, and direction
  [[maybe_unused]] T e0[6];
  if constexpr (rot_g) {
    e0[0] = x; e0[1] = y; e0[2] = z; e0[3] = ux; e0[4] = uy; e0[5] = uz;
  }
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  // a cylinder's (C, K) and curved coordinate
  T cc = c, kk = k;
  if (cyl == 2) {
    cc = c + p[P_CDX];
    kk = k + p[P_KDX];
  }
  const T w = cyl == 1 ? y : x;
  const T uw = cyl == 1 ? uy : ux;
  Anam<T> an{};
  if (anam_n) an = load_anam<toroid>(p, c, k);
  Figure<T> fg{};
  if constexpr (fig) fg = load_figure<T>(p);
  FigureGrad<T> gf;
  T t, k1 = T(1), uyd = T(0), uu = T(0), yy = T(0), d = T(0), e = T(0);
  T f = T(0), sq = T(0), q = T(0), den = T(1);
  bool conj = false;
  if (cyl) {
    k1 = T(1) + kk;
    uyd = uw * w + k1 * uz * z;
    uu = uw * uw + k1 * uz * uz;
    yy = w * w + k1 * z * z;
    d = cc * uyd - uz;
    e = cc * uu;
    f = cc * yy - T(2) * z;
    sq = sqrt0(d * d - e * f);
    q = sg * sq;
    conj = d * q <= T(0) || e == T(0);
    den = conj ? q - d : e;
    if (den == T(0)) den = T(1);
    t = (conj ? f : -(d + q)) / den;
  } else {
    t = anam_intercept<toroid, fig>(x, y, z, ux, uy, uz, c, k, sg, an, fg);
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  const T z1 = z + t * uz;
  // ---- reverse: leave the row's frame ----
  [[maybe_unused]] T* pr = pg + rot_slot<PATH>();
  if constexpr (rot_g) rot_leave_vjp(p + P_ROT, so, g, pr);
  T gx1 = g[0], gy1 = g[1], gz1 = g[2], gvx = g[3], gvy = g[4], gvz = g[5];
  if (rotated) {
    rot_apply(p + P_ROT, gx1, gy1, gz1);
    rot_apply(p + P_ROT, gvx, gvy, gvz);
  }
  T gmu = T(0), gux, guy, guz;
  // the figure's cotangents: a biconic's (cx, kx, cy, ky), a toroid's
  // (cr, cy, ky), and a cylinder's (C, K)
  T gp[4] = {T(0), T(0), T(0), T(0)};
  T gck[2] = {T(0), T(0)};
  // ---- reverse: refraction ----
  if constexpr ((fl & F_PHASE) != 0) {
    // the phase solve on the biconic's or toroid's normal
    constexpr bool doe = (fl & F_DOE) != 0;
    Doe<T> dc{};
    if constexpr (doe) dc = load_doe<T>(p);
    T gdy = T(0);
    if constexpr ((fl & F_GRATING) != 0) gdy = p[P_GDY];
    T ngx, ngy, ggx, ggy, ggdy, gdoe[N_DOE > 0 ? N_DOE : 1];
    anam_normal<toroid, fig>(x1, y1, an, fg, ngx, ngy);
    grating_refract_vjp<doe>(mu, gdy, ngx, ngy, x1, y1, dc, ux, uy, uz, gvx,
                             gvy, gvz, gux, guy, guz, ggx, ggy, gmu, ggdy,
                             gdoe, gx1, gy1);
    if constexpr (toroid) {
      toroid_normal_vjp<fig>(x1, y1, an, fg, ggx, ggy, gx1, gy1, gp, gf);
    } else {
      biconic_normal_vjp<fig>(x1, y1, an, fg, ggx, ggy, gx1, gy1, gp, gf);
    }
    T gna = T(0);
    if constexpr (PATH && doe)
      gna = doe_path_vjp(p, x1, y1, dc, ct_path, gdoe, gx1, gy1);
    put_phase<PATH>(Flags{}, ggdy, gdoe, gna, pg);
  } else if (kind == 0) {
    gux = gvx; guy = gvy; guz = gvz;
  } else if (cyl) {
    const T w1 = cyl == 1 ? y1 : x1;
    const T kc = (T(1) + kk) * cc;
    const T nw = -cc * w1;
    const T nz = T(1) - kc * z1;
    T gnx, gny, gnz;
    refraction_vjp(kind, false, mu, ux, uy, uz, cyl == 1 ? T(0) : nw,
                   cyl == 1 ? nw : T(0), nz, gvx, gvy, gvz, gux, guy, guz,
                   gnx, gny, gnz, gmu);
    const T gnw = cyl == 1 ? gny : gnx;
    gck[1] = gck[1] - cc * z1 * gnz;
    gck[0] = gck[0] - w1 * gnw - (T(1) + kk) * z1 * gnz;
    if (cyl == 1) {
      gy1 = gy1 - cc * gnw;
    } else {
      gx1 = gx1 - cc * gnw;
    }
    gz1 = gz1 - kc * gnz;
  } else {
    T ngx, ngy, ggx, ggy, ggz;
    anam_normal<toroid, fig>(x1, y1, an, fg, ngx, ngy);
    refraction_vjp(kind, false, mu, ux, uy, uz, ngx, ngy, T(1), gvx, gvy, gvz,
                   gux, guy, guz, ggx, ggy, ggz, gmu);
    if (kind == 2) {
      // the reflection's a = |mu| (u . n) / |n|^2 with |mu| = 1
      const T nn = ngx * ngx + ngy * ngy + T(1);
      gmu = -sgn(mu) * T(2) * (ux * ngx + uy * ngy + uz) / nn *
            (gvx * ngx + gvy * ngy + gvz);
    }
    if constexpr (toroid) {
      toroid_normal_vjp<fig>(x1, y1, an, fg, ggx, ggy, gx1, gy1, gp, gf);
    } else {
      biconic_normal_vjp<fig>(x1, y1, an, fg, ggx, ggy, gx1, gy1, gp, gf);
    }
  }
  // ---- reverse: transfer x1 = x + t u ----
  T gx = gx1, gy = gy1, gz = gz1;
  gux = gux + t * gx1; guy = guy + t * gy1; guz = guz + t * gz1;
  T gt = ux * gx1 + uy * gy1 + uz * gz1;
  if constexpr (PATH) {
    gt = gt + ct_path * p[P_NB];
    pg[6] = ct_path * t;
  }
  // ---- reverse: intercept ----
  if (cyl) {
    T gd, gq, ge = T(0), gf0 = T(0);
    if (conj) {
      const T dd = q != d ? gt * f / (den * den) : T(0);
      gf0 = gt / den;
      gd = dd;
      gq = -dd;
    } else {
      gd = gq = -gt / den;
      ge = gt * (d + q) / (den * den);
    }
    const T gdisc = gq * sg * T(0.5) / sq;
    gd = gd + T(2) * d * gdisc;
    ge = ge - f * gdisc;
    gf0 = gf0 - e * gdisc;
    gck[0] = gck[0] + yy * gf0 + uu * ge + uyd * gd;
    const T gyy = cc * gf0;
    const T guyd = cc * gd;
    const T guu = cc * ge;
    gz = gz - T(2) * gf0 + T(2) * k1 * z * gyy + k1 * uz * guyd;
    guz = guz - gd + k1 * z * guyd + T(2) * k1 * uz * guu;
    const T gw = T(2) * w * gyy + uw * guyd;
    const T guw = w * guyd + T(2) * uw * guu;
    gck[1] = gck[1] + z * z * gyy + uz * uz * guu + uz * z * guyd;
    if (cyl == 1) {
      gy = gy + gw;
      guy = guy + guw;
    } else {
      gx = gx + gw;
      gux = gux + guw;
    }
  } else {
    // the Newton root, implicitly: dF/dp * (-gt / F_s)
    const T gF = -gt / anam_slope<toroid, fig>(t, x, y, ux, uy, uz, an, fg);
    const T px = x + t * ux;
    const T py = y + t * uy;
    T gpx = T(0), gpy = T(0);
    if constexpr (toroid) {
      toroid_sag_vjp<fig>(px, py, an, fg, gF, gpx, gpy, gp, gf);
    } else {
      biconic_sag_vjp<fig>(px, py, an, fg, gF, gpx, gpy, gp, gf);
    }
    gx = gx + gpx; gy = gy + gpy; gz = gz + gF;
    gux = gux + t * gpx; guy = guy + t * gpy; guz = guz + t * gF;
  }
  // ---- reverse: enter the row's frame ----
  if constexpr (rot_g) {
    const T gl[6] = {gx, gy, gz, gux, guy, guz};
    rot_enter_vjp(e0, gl, pr);
  }
  if (rotated) {
    rot_apply_t(p + P_ROT, gx, gy, gz);
    rot_apply_t(p + P_ROT, gux, guy, guz);
  }
  g[0] = gx; g[1] = gy; g[2] = gz;
  g[3] = gux; g[4] = guy; g[5] = guz;
  // the figure's parameters onto the row's: the coefficients from q0,
  // curvature_dx and conic_dx after them
  constexpr int q0 = PATH ? OPD_SLOTS : SLOTS;
  constexpr int qd = q0 + N_ASP + N_ODD;
  if constexpr (cyl && anam_n) {
    // a phase cylinder: (C, K) is (c, k) in y, (c + cdx, k + kdx) in x;
    // the normal's as a toroid's (cr = c + cdx) or a biconic's
    if constexpr (toroid) {
      pg[0] = gck[0] + (gp[0] + gp[1]); pg[1] = gck[1] + gp[2];
      pg[qd] = gp[0]; pg[qd + 1] = T(0);
    } else if constexpr (cyl == 1) {
      pg[0] = gck[0] + (gp[0] + gp[2]); pg[1] = gck[1] + (gp[1] + gp[3]);
      pg[qd] = gp[0]; pg[qd + 1] = gp[1];
    } else {
      pg[0] = gck[0] + (gp[0] + gp[2]); pg[1] = gck[1] + (gp[1] + gp[3]);
      pg[qd] = gck[0] + gp[0]; pg[qd + 1] = gck[1] + gp[1];
    }
  } else if (cyl == 1) {
    pg[0] = gck[0]; pg[1] = gck[1]; pg[qd] = T(0); pg[qd + 1] = T(0);
  } else if (cyl == 2) {
    pg[0] = gck[0]; pg[1] = gck[1]; pg[qd] = gck[0]; pg[qd + 1] = gck[1];
  } else if (toroid) {
    pg[0] = gp[0] + gp[1]; pg[1] = gp[2];
    pg[qd] = gp[0]; pg[qd + 1] = T(0);
  } else {
    pg[0] = gp[0] + gp[2]; pg[1] = gp[1] + gp[3];
    pg[qd] = gp[0]; pg[qd + 1] = gp[1];
  }
  pg[2] = off_axis ? -gx : T(0);
  pg[3] = off_axis ? -gy : T(0);
  pg[4] = -gz;
  pg[5] = gmu;
  put_figure(gf, pg, q0);
}

// Hand-derived reverse of surface_step for one live ray, the flags and
// the row pointer as in surface_step (an anamorphic row, figured or not:
// anamorphic_step_vjp; another figured row or a freeform row:
// figured_step_vjp).
// s: the state entering the row (global frame).  g: in, the cotangent of
// the state leaving the row; out, the cotangent of s.
// pg: out, the row's parameter cotangents (c, k, offset x, y, z, mu;
// with PATH also n_before; a figured row's coefficients after them, an
// anamorphic row's curvature_dx and conic_dx last).
// With PATH, ct_path is the cotangent of the row's optical path t *
// n_before (K9); without it the path has none and the code is K5's and
// K7's.  The aperture clip is a constant mask: a clipped ray is dead.
// so: the state leaving the row (global frame), read by a rot key on a
// rotated row only, whose rotation cotangents go to pg from
// rot_slot<PATH>().
template <typename T, bool PATH = false, typename Flags,
          typename Row = const T*>
__device__ __forceinline__ void surface_step_vjp(Row p, Flags flags,
                                                 const T* s, T* g, T* pg,
                                                 T ct_path = T(0),
                                                 const T* so = nullptr) {
  if constexpr ((Flags::value & F_ANAMORPHIC) != 0) {
    anamorphic_step_vjp<T, PATH>(p, flags, s, g, pg, ct_path, so);
    return;
  } else if constexpr ((Flags::value & (F_FIGURED | F_FREEFORM)) != 0) {
    figured_step_vjp<T, PATH>(p, flags, s, g, pg, ct_path, so);
    return;
  }
  constexpr bool rot_g = N_ROT > 0 && (Flags::value & F_ROTATED) != 0;
  const int fl = flag_value(flags);
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
  // a rot key's entering position less the offset, and direction
  [[maybe_unused]] T e0[6];
  if constexpr (rot_g) {
    e0[0] = x; e0[1] = y; e0[2] = z; e0[3] = ux; e0[4] = uy; e0[5] = uz;
  }
  if (rotated) {
    rot_apply(p + P_ROT, x, y, z);
    rot_apply(p + P_ROT, ux, uy, uz);
  }
  const T sg = (fl & F_ALTERNATE) ? T(-1) : T(1);
  T t, uzs = T(1), k1 = T(1), uyd = T(0), uu = T(1), yy = T(0);
  T d = T(0), e = T(0), f = T(0), sq = T(0), q = T(0), den = T(1);
  bool conj = false;
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
    // intercept_spec's pair: f / (q - d) (conj) or -(d + q) / e
    conj = d * q <= T(0) || e == T(0);
    den = conj ? q - d : e;
    if (den == T(0)) den = T(1);
    t = (conj ? f : -(d + q)) / den;
  }
  const T x1 = x + t * ux;
  const T y1 = y + t * uy;
  const T z1 = z + t * uz;
  // ---- reverse: leave the row's frame ----
  [[maybe_unused]] T* pr = pg + rot_slot<PATH>();
  if constexpr (rot_g) rot_leave_vjp(p + P_ROT, so, g, pr);
  T gx1 = g[0], gy1 = g[1], gz1 = g[2], gvx = g[3], gvy = g[4], gvz = g[5];
  if (rotated) {
    rot_apply(p + P_ROT, gx1, gy1, gz1);
    rot_apply(p + P_ROT, gvx, gvy, gvz);
  }
  T gc = T(0), gk = T(0), gmu = T(0), gux, guy, guz;
  // ---- reverse: refraction ----
  if constexpr ((Flags::value & F_PHASE) != 0) {
    // the phase solve on the radial normal (flat: (0, 0))
    const Figure<T> fg{};
    FigureGrad<T> gf;
    radial_phase_step_vjp<(Flags::value & F_FLAT) != 0, false, PATH>(
        p, flags, x1, y1, c, k, mu, fg, ux, uy, uz, gvx, gvy, gvz, gux, guy,
        guz, gx1, gy1, gc, gk, gmu, gf, pg, ct_path);
  } else if (kind == 0) {
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
    T gnx, gny, gnz;
    refraction_vjp(kind, sph, mu, ux, uy, uz, nx, ny, nz, gvx, gvy, gvz,
                   gux, guy, guz, gnx, gny, gnz, gmu);
    if (!sph) gk = gk - c * z1 * gnz;
    const T zc = sph ? z1 : (T(1) + k) * z1;
    gc = gc - x1 * gnx - y1 * gny - zc * gnz;
    gx1 = gx1 - c * gnx; gy1 = gy1 - c * gny; gz1 = gz1 - kc * gnz;
  }
  // ---- reverse: transfer x1 = x + t u ----
  T gx = gx1, gy = gy1, gz = gz1;
  gux = gux + t * gx1; guy = guy + t * gy1; guz = guz + t * gz1;
  T gt = ux * gx1 + uy * gy1 + uz * gz1;
  if constexpr (PATH) {
    gt = gt + ct_path * p[P_NB];
    pg[6] = ct_path * t;
  }
  // ---- reverse: intercept ----
  if (flat) {
    gz = gz - gt / uzs;
    if (uz != T(0)) guz = guz + gt * z / (uzs * uzs);
  } else {
    // the derivative of the form the ray took (den is e when not conj)
    T gd, gq, ge = T(0), gf = T(0);
    if (conj) {
      const T dd = q != d ? gt * f / (den * den) : T(0);
      gf = gt / den;
      gd = dd;
      gq = -dd;
    } else {
      gd = gq = -gt / den;
      ge = gt * (d + q) / (den * den);
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
  if constexpr (rot_g) {
    const T gl[6] = {gx, gy, gz, gux, guy, guz};
    rot_enter_vjp(e0, gl, pr);
  }
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

// The reference-sphere tail of K8/K9 (pallas_grad._opd_tail): the
// state leaving row S-2 (global frame) stepped to the image row p,
// rotated into its frame, moved to the sphere centre, and its closed-
// form intercept ti with the sphere of radius aux[3] (the spherical
// branch of the conic intercept; sqrt of a negative is NaN: a miss).
// The flags, the row pointer and aux as in surface_step.
template <typename T>
struct SphereTail {
  T px, py, pz, dx, dy, dz, cc, d, e, f, sq, ti;
};

template <typename T, typename Flags, typename Row = const T*,
          typename Aux = const T*>
__device__ __forceinline__ SphereTail<T> sphere_tail(Row p, Flags flags,
                                                     Aux aux, const T* s) {
  const int fl = flag_value(flags);
  SphereTail<T> o;
  T px = s[0], py = s[1];
  if (fl & F_OFF_AXIS) {
    px = px - p[P_OFF];
    py = py - p[P_OFF + 1];
  }
  T pz = s[2] - p[P_OFF + 2];
  T dx = s[3], dy = s[4], dz = s[5];
  if (fl & F_ROTATED) {
    rot_apply(p + P_ROT, px, py, pz);
    rot_apply(p + P_ROT, dx, dy, dz);
  }
  const T radius = aux[3];
  o.px = px - aux[0];
  o.py = py - aux[1];
  o.pz = pz - aux[2] + radius;
  o.dx = dx; o.dy = dy; o.dz = dz;
  o.cc = T(1) / radius;
  const T uyd = dx * o.px + dy * o.py + dz * o.pz;
  const T uu = dx * dx + dy * dy + dz * dz;
  const T yy = o.px * o.px + o.py * o.py + o.pz * o.pz;
  o.d = o.cc * uyd - dz;
  o.e = o.cc * uu;
  o.f = o.cc * yy - T(2) * o.pz;
  o.sq = sqrt(o.d * o.d - o.e * o.f);
  o.ti = -(o.d + o.sq) / o.e;
  return o;
}

// Hand-derived reverse of the tail for one live ray, from the
// cotangents of q = ti * n_image (ct_q), lx = px + ti dx and ly = py +
// ti dy.  g: out, the cotangent of the state leaving row S-2; pg: out,
// the image row's parameter cotangents (OPD_SLOTS; a rot key's rotated
// image row also its rotation's, from rot_slot<true>(), the tail's
// entering state s read for them); gc: out, the centre cotangents.
template <typename T, typename Flags, typename Row = const T*>
__device__ __forceinline__ void sphere_tail_vjp(Row p, Flags flags,
                                                const SphereTail<T>& o,
                                                T ct_q, T ct_lx, T ct_ly,
                                                T* g, T* pg, T* gc,
                                                const T* s = nullptr) {
  const int fl = flag_value(flags);
  constexpr bool rot_g = N_ROT > 0 && (Flags::value & F_ROTATED) != 0;
  const T nb = p[P_NB];
  const T gti = ct_q * nb + ct_lx * o.dx + ct_ly * o.dy;
  T gpx = ct_lx, gpy = ct_ly, gpz = T(0);
  T gdx = ct_lx * o.ti, gdy = ct_ly * o.ti, gdz = T(0);
  // ti = -(d + sq) / e
  T gd = -gti / o.e;
  const T gsq = gd;
  T ge = gti * (o.d + o.sq) / (o.e * o.e);
  // sq = sqrt(d^2 - e f)
  const T gdisc = gsq * T(0.5) / o.sq;
  gd = gd + T(2) * o.d * gdisc;
  ge = ge - o.f * gdisc;
  const T gf = -o.e * gdisc;
  // d = cc uyd - dz, e = cc uu, f = cc yy - 2 pz
  const T guyd = o.cc * gd;
  const T guu = o.cc * ge;
  const T gyy = o.cc * gf;
  gdz = gdz - gd;
  gpz = gpz - T(2) * gf;
  gdx = gdx + o.px * guyd + T(2) * o.dx * guu;
  gdy = gdy + o.py * guyd + T(2) * o.dy * guu;
  gdz = gdz + o.pz * guyd + T(2) * o.dz * guu;
  gpx = gpx + o.dx * guyd + T(2) * o.px * gyy;
  gpy = gpy + o.dy * guyd + T(2) * o.py * gyy;
  gpz = gpz + o.dz * guyd + T(2) * o.pz * gyy;
  gc[0] = -gpx; gc[1] = -gpy; gc[2] = -gpz;
  if constexpr (rot_g) {
    // the image row's frame, entered from the state s leaving row S-2
    T e0[6] = {s[0], s[1], s[2] - p[P_OFF + 2], s[3], s[4], s[5]};
    if (fl & F_OFF_AXIS) {
      e0[0] = e0[0] - p[P_OFF];
      e0[1] = e0[1] - p[P_OFF + 1];
    }
    const T gl[6] = {gpx, gpy, gpz, gdx, gdy, gdz};
    T* pr = pg + rot_slot<true>();
#pragma unroll
    for (int q = 0; q < N_ROT; ++q) pr[q] = T(0);
    rot_enter_vjp(e0, gl, pr);
  }
  if (fl & F_ROTATED) {
    rot_apply_t(p + P_ROT, gpx, gpy, gpz);
    rot_apply_t(p + P_ROT, gdx, gdy, gdz);
  }
  g[0] = gpx; g[1] = gpy; g[2] = gpz;
  g[3] = gdx; g[4] = gdy; g[5] = gdz;
  pg[0] = T(0);
  pg[1] = T(0);
  pg[2] = (fl & F_OFF_AXIS) ? -gpx : T(0);
  pg[3] = (fl & F_OFF_AXIS) ? -gpy : T(0);
  pg[4] = -gpz;
  pg[5] = T(0);
  pg[6] = ct_q * o.ti;
}

}  // namespace
