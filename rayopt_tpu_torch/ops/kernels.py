"""Component-form (structure-of-arrays) trace math on torch tensors.

Rays are carried as six separate (N,) component tensors (x, y, z, ux,
uy, uz); every operation below is an elementwise expression over them.
Surface parameters are 0-d tensors (one row of a SurfaceTable), so a
step broadcasts them against the bundle.

This is the counterpart of the JAX package's rayopt_tpu.ops.kernels,
operation for operation, so the two agree to rounding in float64.  The
port covers the rotationally symmetric rows -- flat, spherical, conic
and even/odd aspheric -- and the anamorphic rows: conic cylinders
curved in y or in x (a closed-form intercept), general biconics and
toroids (rotated, off-axis, passthrough, refracting and mirror rows,
aperture clip).  An aspheric, biconic or toroidal row is intercepted
by a fixed-count Newton seeded from the (y-)conic (`intercept`,
`intercept_biconic`, `intercept_toroid`), differentiated implicitly at
the root (`_NewtonRoot`).  A linear grating or a radial diffractive
phase (DOE) on any of these substrates takes the generalized Spencer &
Murty solve (`refract_grating`, `doe_kick`).  A freeform XY row -- a
conic or even/odd aspheric base plus a triangular XY-monomial figure
(`_poly_xy`) -- is intercepted by the same Newton on the residual sag
minus the polynomial, a ray whose conic seed misses restarting from the
vertex plane, and refracted by its normal (`normal_freeform`,
`refract_freeform`).

NaN marks a vignetted or missed ray.  `_sqrt0` clamps negative
arguments to 0 but lets NaN through, and every miss is set to NaN
explicitly, as in the JAX package.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

NAN = float("nan")
ASPHERIC_ITERS = 10
ASPHERIC_TOL = 1e-9
TINY = 1e-30


def _tol_for(x, tol):
    """Dtype-aware Newton convergence tolerance: the float64 default
    (1e-9) sits far below float32 evaluation noise, so in reduced
    precision the floor is 64 machine epsilons (about 7.6e-6 in
    float32) -- otherwise every converged ray would be declared a miss
    (NaN)."""
    return max(tol, 64*torch.finfo(x.dtype).eps)


def _sqrt0(x):
    # torch.clamp propagates NaN (like jnp.maximum)
    return torch.sqrt(torch.clamp(x, min=0))


def rot_apply(r, x, y, z):
    """v' = R v on components (to_normal when R = rot_normal)."""
    return (r[0, 0]*x + r[0, 1]*y + r[0, 2]*z,
            r[1, 0]*x + r[1, 1]*y + r[1, 2]*z,
            r[2, 0]*x + r[2, 1]*y + r[2, 2]*z)


def rot_apply_t(r, x, y, z):
    """v' = R^T v on components (from_normal)."""
    return (r[0, 0]*x + r[1, 0]*y + r[2, 0]*z,
            r[0, 1]*x + r[1, 1]*y + r[2, 1]*z,
            r[0, 2]*x + r[1, 2]*y + r[2, 2]*z)


def _poly_even(r2, coeffs):
    """sum_i coeffs[i] * r2**(i+1) by Horner."""
    d = torch.zeros_like(r2)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        d = (d + coeffs[..., i])*r2
    return d


def _dpoly_even(r2, coeffs):
    """2 * d/d(r2) of _poly_even: sum_i 2 (i+1) coeffs[i] r2**i."""
    d = torch.zeros_like(r2)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        d = d*r2 + 2*(i + 1)*coeffs[..., i]
    return d


def _poly_odd(r2, coeffs):
    """sum_j coeffs[j] * r**(2j+1) with r = sqrt(r2): the odd-power
    aspheric figure (the odd half of a Zemax ODDASPHE sag)."""
    d = torch.zeros_like(r2)
    for j in range(coeffs.shape[-1] - 1, -1, -1):
        d = d*r2 + coeffs[..., j]
    return torch.sqrt(r2)*d


def _dpoly_odd(r2, coeffs):
    """2 * d/d(r2) of _poly_odd: P(r2)/r + 2 r P'(r2).  The r**1 term
    has a cusp at the vertex: r is floored at TINY there (a normal
    exactly on the vertex of a coned surface is undefined)."""
    p = torch.zeros_like(r2)
    for j in range(coeffs.shape[-1] - 1, -1, -1):
        p = p*r2 + coeffs[..., j]
    dp = torch.zeros_like(r2)
    for j in range(coeffs.shape[-1] - 1, 0, -1):
        dp = dp*r2 + j*coeffs[..., j]
    r = torch.clamp(torch.sqrt(r2), min=TINY)
    return p/r + 2*r*dp


def _width(coeffs):
    return coeffs is not None and coeffs.shape[-1] > 0


def sag(x, y, z, c, k, aspherics=None, aspherics_odd=None):
    """z - surface_sag(x, y) (reference elements.py:440)."""
    r2 = x*x + y*y
    e = z - c*r2/(1 + _sqrt0(1 - (1 + k)*c*c*r2))
    if _width(aspherics):
        e = e - _poly_even(r2, aspherics)
    if _width(aspherics_odd):
        e = e - _poly_odd(r2, aspherics_odd)
    return e


def normal_radial(x, y, c, k, aspherics=None, aspherics_odd=None):
    """The radial factor e of the surface normal (nx, ny, nz) =
    (x*e, y*e, 1) (reference elements.py:457)."""
    r2 = x*x + y*y
    e = -c/_sqrt0(1 - (1 + k)*c*c*r2)
    if _width(aspherics):
        e = e - _dpoly_even(r2, aspherics)
    if _width(aspherics_odd):
        e = e - _dpoly_odd(r2, aspherics_odd)
    return e


def xy_degree(nterms):
    """Polynomial degree from the triangular term count
    nterms = deg*(deg + 3)/2."""
    deg, n = 0, 0
    while n < nterms:
        deg += 1
        n += deg + 1
    if n != nterms:
        raise ValueError(
            "xy_poly width %d is not triangular (expected deg*(deg+3)/2"
            " for some integer degree)" % nterms)
    return deg


@functools.lru_cache()
def _xy_terms(deg):
    """Triangular XY-monomial ordering: total degree d = 1..deg, within
    each degree from x^d down to y^d, i.e. (i, j) exponent pairs (d, 0),
    (d-1, 1), ..., (0, d).  No (0, 0) term: a constant sag is a vertex
    shift and belongs in the surface position."""
    return tuple((d - j, j) for d in range(1, deg + 1)
                 for j in range(d + 1))


def _xy_pows(v, deg):
    """[None, v, v^2, ..., v^deg] by repeated products."""
    pows = [None, v]
    for _ in range(2, deg + 1):
        pows.append(pows[-1]*v)
    return pows


def _poly_xy(x, y, coeffs):
    """sum_t coeffs[t] x^i y^j over the triangular ordering (_xy_terms):
    the freeform XY-polynomial figure."""
    deg = xy_degree(coeffs.shape[-1])
    xp = _xy_pows(x, deg)
    yp = _xy_pows(y, deg)
    out = torch.zeros_like(x)
    for t, (i, j) in enumerate(_xy_terms(deg)):
        m = xp[i] if i else yp[j]
        if i and j:
            m = m*yp[j]
        out = out + coeffs[..., t]*m
    return out


def _dpoly_xy(x, y, coeffs):
    """(d/dx, d/dy) of _poly_xy."""
    deg = xy_degree(coeffs.shape[-1])
    xp = _xy_pows(x, deg)
    yp = _xy_pows(y, deg)
    gx = torch.zeros_like(x)
    gy = torch.zeros_like(x)
    for t, (i, j) in enumerate(_xy_terms(deg)):
        c = coeffs[..., t]
        if i:
            m = xp[i - 1] if i > 1 else None
            if j:
                m = yp[j] if m is None else m*yp[j]
            gx = gx + (i*c if m is None else (i*c)*m)
        if j:
            m = yp[j - 1] if j > 1 else None
            if i:
                m = xp[i] if m is None else m*xp[i]
            gy = gy + (j*c if m is None else (j*c)*m)
    return gx, gy


def intercept_conic(x, y, z, ux, uy, uz, c, k, alternate):
    """Closed-form conic intercept on components.

    The root -(d+g)/e equals f/(g-d) algebraically; numerically each
    form cancels catastrophically where the other is exact, so the
    cancellation-free numerator/denominator pair is selected from the
    sign of d*g and ONE division is shared."""
    k1 = 1 + k
    uy_ = ux*x + uy*y + k1*uz*z
    uu = ux*ux + uy*uy + k1*uz*uz
    yy = x*x + y*y + k1*z*z
    d = c*uy_ - uz
    e = c*uu
    f = c*yy - 2*z
    disc = d*d - e*f
    g = _sqrt0(disc)*(1 - 2*alternate)
    conj = (d*g <= 0) | (e == 0)
    num = torch.where(conj, f, -(d + g))
    den = torch.where(conj, g - d, e)
    den_safe = torch.where(den == 0, 1., den)
    s = num/den_safe
    uz_safe = torch.where(uz == 0, 1., uz)
    s = torch.where(c == 0, -z/uz_safe, s)
    s = torch.where((c != 0) & (disc < 0), NAN, s)
    return s


def sag_biconic(x, y, z, cx, kx, cy, ky, aspherics=None,
                aspherics_odd=None):
    """z - biconic_sag(x, y): independent x/y curvature and conic,
    sag = (cx x^2 + cy y^2)/(1 + sqrt(1 - (1+kx) cx^2 x^2 - (1+ky)
    cy^2 y^2)), plus the shared rotationally symmetric aspheric terms
    (reference kernels.sag_biconic)."""
    x2, y2 = x*x, y*y
    a = cx*x2 + cy*y2
    b = (1 + kx)*cx*cx*x2 + (1 + ky)*cy*cy*y2
    e = z - a/(1 + _sqrt0(1 - b))
    r2 = x2 + y2
    if _width(aspherics):
        e = e - _poly_even(r2, aspherics)
    if _width(aspherics_odd):
        e = e - _poly_odd(r2, aspherics_odd)
    return e


def normal_biconic(x, y, cx, kx, cy, ky, aspherics=None,
                   aspherics_odd=None):
    """Transverse components (gx, gy) of the unnormalized surface
    normal (gx, gy, 1) = grad(z - sag) of a biconic; the root s of the
    sag's denominator is floored at TINY where it divides."""
    x2, y2 = x*x, y*y
    a = cx*x2 + cy*y2
    b = (1 + kx)*cx*cx*x2 + (1 + ky)*cy*cy*y2
    s = _sqrt0(1 - b)
    s_safe = torch.clamp(s, min=TINY)
    inv = 1./(1 + s)
    gx = -(2*cx*x*(1 + s) + a*(1 + kx)*cx*cx*x/s_safe)*inv*inv
    gy = -(2*cy*y*(1 + s) + a*(1 + ky)*cy*cy*y/s_safe)*inv*inv
    r2 = x2 + y2
    if _width(aspherics):
        d = _dpoly_even(r2, aspherics)
        gx = gx - x*d
        gy = gy - y*d
    if _width(aspherics_odd):
        d = _dpoly_odd(r2, aspherics_odd)
        gx = gx - x*d
        gy = gy - y*d
    return gx, gy


def _ycurve(y, cy, ky, aspherics=None, aspherics_odd=None):
    """(sag, d sag/dy) of the toroid's generating curve in the y-z
    plane: conic + polynomial figure on y alone (the root floored at
    TINY where it divides)."""
    y2 = y*y
    sq = _sqrt0(1 - (1 + ky)*cy*cy*y2)
    zy = cy*y2/(1 + sq)
    dzy = cy*y/torch.clamp(sq, min=TINY)
    if _width(aspherics):
        zy = zy + _poly_even(y2, aspherics)
        dzy = dzy + y*_dpoly_even(y2, aspherics)
    if _width(aspherics_odd):
        zy = zy + _poly_odd(y2, aspherics_odd)
        dzy = dzy + y*_dpoly_odd(y2, aspherics_odd)
    return zy, dzy


def sag_toroid(x, y, z, cr, cy, ky, aspherics=None, aspherics_odd=None):
    """z - toroidal_sag(x, y): the y-z curve zy(y) swept about an axis
    parallel to y at radius 1/cr (the Zemax TOROIDAL model),
    sag = zy + x^2 cr'/(1 + sqrt(1 - x^2 cr'^2)), cr' = cr/(1 - cr zy)."""
    zy, _ = _ycurve(y, cy, ky, aspherics, aspherics_odd)
    crp = cr/(1 - cr*zy)
    x2 = x*x
    return z - zy - crp*x2/(1 + _sqrt0(1 - x2*crp*crp))


def normal_toroid(x, y, cr, cy, ky, aspherics=None, aspherics_odd=None):
    """Transverse components (gx, gy) of the toroid's unnormalized
    normal: gx = -x cr'/w, gy = -zy'/w, w = sqrt(1 - x^2 cr'^2) floored
    at TINY."""
    zy, dzy = _ycurve(y, cy, ky, aspherics, aspherics_odd)
    crp = cr/(1 - cr*zy)
    w = torch.clamp(_sqrt0(1 - x*x*crp*crp), min=TINY)
    return -x*crp/w, -dzy/w


def _newton_residual(kind, s, x, y, z, ux, uy, uz, pa, pb, pc, pd, asp,
                     aspo, xy=None):
    """Sag residual F(s) at distance s along the ray for the three
    Newton-refined figures (the reference's kinds): "radial" (pa, pb =
    c, k: a conic with even/odd aspheric figure), "biconic" (pa..pd =
    cx, kx, cy, ky) and "toroid" (pa..pc = cr, cy, ky).  A nonzero-width
    `xy` (triangular XY-monomial coefficients) adds the freeform figure
    on top of any base."""
    px, py, pz = x + s*ux, y + s*uy, z + s*uz
    if kind == "radial":
        e = sag(px, py, pz, pa, pb, asp, aspo)
    elif kind == "biconic":
        e = sag_biconic(px, py, pz, pa, pb, pc, pd, asp, aspo)
    else:
        e = sag_toroid(px, py, pz, pa, pb, pc, asp, aspo)
    if _width(xy):
        e = e - _poly_xy(px, py, xy)
    return e


def _newton_slope(kind, s, x, y, z, ux, uy, uz, pa, pb, pc, pd, asp,
                  aspo, xy=None):
    """dF/ds = u . grad(z - sag) by the kind's hand-written normal (and
    the freeform figure's slopes)."""
    px, py = x + s*ux, y + s*uy
    if kind == "radial":
        e = normal_radial(px, py, pa, pb, asp, aspo)
        gx, gy = px*e, py*e
    elif kind == "biconic":
        gx, gy = normal_biconic(px, py, pa, pb, pc, pd, asp, aspo)
    else:
        gx, gy = normal_toroid(px, py, pa, pb, pc, asp, aspo)
    if _width(xy):
        dpx, dpy = _dpoly_xy(px, py, xy)
        gx = gx - dpx
        gy = gy - dpy
    return ux*gx + uy*gy + uz


class _NewtonRoot(torch.autograd.Function):
    """Fixed-count Newton refinement of the intercept distance, the
    counterpart of the reference's `_newton_root` (a jax.custom_jvp).

    forward(seed, x, y, z, ux, uy, uz, pa, pb, asp, aspo, iters, tol,
    kind="radial", pc=None, pd=None, xy=None): `iters` Newton steps from
    the seed on the residual of `kind` (_newton_residual, with the
    freeform figure of `xy`; a zero slope steps by F), then a ray whose
    residual exceeds tol*(1 + |s|) (tol floored by _tol_for) becomes
    NaN.

    backward: the implicit-function theorem at the converged root,
    p_bar = -s_bar * dF/dp / F_s (one residual gradient), not the
    unrolled iterations: the derivative is that of the exact root,
    independent of the iteration path.  The seed gets no cotangent (as
    the reference's JVP ignores its tangent).  The backward is not
    itself differentiable: nested derivatives (the reference's
    aberration expansion, item 13) raise."""

    @staticmethod
    def forward(ctx, seed, x, y, z, ux, uy, uz, pa, pb, asp, aspo, iters,
                tol, kind="radial", pc=None, pd=None, xy=None):
        zero = pa.new_zeros(())
        pc = zero if pc is None else pc
        pd = zero if pd is None else pd
        xy = pa.new_zeros((0,)) if xy is None else xy
        args = (x, y, z, ux, uy, uz, pa, pb, pc, pd, asp, aspo, xy)
        s = seed
        for _ in range(iters):
            fn = _newton_residual(kind, s, *args)
            fp = _newton_slope(kind, s, *args)
            fp = torch.where(fp == 0, 1., fp)
            s = s - fn/fp
        res = _newton_residual(kind, s, *args)
        tol = _tol_for(s, tol)
        s = torch.where(torch.abs(res) <= tol*(1 + torch.abs(s)), s, NAN)
        ctx.kind = kind
        ctx.save_for_backward(s, *args)
        return s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        s, *args = ctx.saved_tensors
        given = len(ctx.needs_input_grad)   # kind, pc, pd, xy may be absent
        n = tuple(ctx.needs_input_grad) + (False,)*(17 - given)
        # the inputs in _newton_residual's order: x .. pb, pc, pd, asp,
        # aspo, xy
        need = (*n[1:9], *n[14:16], *n[9:11], n[16])
        kind = ctx.kind
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() if nd else a.detach()
                      for a, nd in zip(args, need)]
            f = _newton_residual(kind, s, *leaves)
            fs = _newton_slope(kind, s, *(a.detach() for a in args))
            fs = torch.where(fs == 0, 1., fs)
            wanted = [a for a, nd in zip(leaves, need) if nd]
            grads = iter(torch.autograd.grad(f, wanted, -ct/fs,
                                             allow_unused=True)
                         if wanted else ())
        out = []
        for a, nd in zip(args, need):
            g = next(grads) if nd else None
            out.append(torch.zeros_like(a) if nd and g is None else g)
        return (None, *out[:8], *out[10:12], None, None, None,
                *out[8:10], out[12])[:given]


def intercept(x, y, z, ux, uy, uz, c, k, aspherics, alternate,
              iters=ASPHERIC_ITERS, tol=ASPHERIC_TOL, aspherics_odd=None,
              xy_poly=None):
    """Ray length to a conic surface with even/odd aspheric figure and
    (xy_poly) a freeform XY figure: the closed conic root, refined by a
    fixed-count Newton on the exact sag when any coefficient table has a
    nonzero width (a static shape, as in the reference).  A ray whose
    conic seed misses a curved row stays NaN -- unless the row has a
    freeform column: the figure breaks the symmetry, so such a ray
    restarts from the vertex plane -z/uz and is not masked after the
    Newton.  A ray the Newton does not converge is NaN."""
    s = intercept_conic(x, y, z, ux, uy, uz, c, k, alternate)
    has_xy = _width(xy_poly)
    if not (_width(aspherics) or _width(aspherics_odd) or has_xy):
        return s
    zeros = s.new_zeros((0,))
    asp = aspherics if aspherics is not None else zeros
    aspo = aspherics_odd if aspherics_odd is not None else zeros
    s0 = s
    x, y, z, ux, uy, uz = torch.broadcast_tensors(x, y, z, ux, uy, uz)
    if has_xy:
        uz_safe = torch.where(uz == 0, 1., uz)
        s0 = torch.where(torch.isnan(s0), -z/uz_safe, s0)
    s = _NewtonRoot.apply(s0, x, y, z, ux, uy, uz, c, k, asp, aspo,
                          iters, tol, "radial", None, None,
                          xy_poly if has_xy else None)
    if has_xy:
        return s
    return torch.where(torch.isnan(s0) & (c != 0), NAN, s)


def _anamorphic_root(kind, x, y, z, ux, uy, uz, pa, pb, pc, pd, cy, ky,
                     aspherics, alternate, iters, tol, aspherics_odd,
                     xy_poly=None):
    """The seeded Newton of a biconic or toroid (with the freeform
    figure of a nonzero-width xy_poly: the generic walk's): the y-conic
    closed form seeds it, a ray whose seed misses restarts from the
    vertex plane -z/uz; a ray the Newton does not converge is NaN."""
    seed = intercept_conic(x, y, z, ux, uy, uz, cy, ky, alternate)
    uz_safe = torch.where(uz == 0, 1., uz)
    seed = torch.where(torch.isnan(seed), -z/uz_safe, seed)
    zeros = seed.new_zeros((0,))
    asp = aspherics if aspherics is not None else zeros
    aspo = aspherics_odd if aspherics_odd is not None else zeros
    x, y, z, ux, uy, uz = torch.broadcast_tensors(x, y, z, ux, uy, uz)
    return _NewtonRoot.apply(seed, x, y, z, ux, uy, uz, pa, pb, asp, aspo,
                             iters, tol, kind, pc, pd,
                             xy_poly if _width(xy_poly) else None)


def intercept_biconic(x, y, z, ux, uy, uz, cx, kx, cy, ky, aspherics,
                      alternate, iters=ASPHERIC_ITERS, tol=ASPHERIC_TOL,
                      aspherics_odd=None, xy_poly=None):
    """Ray length to a biconic surface (reference intercept_biconic):
    the y-axis conic seeds a fixed-count Newton on the exact sag."""
    return _anamorphic_root("biconic", x, y, z, ux, uy, uz, cx, kx, cy, ky,
                            cy, ky, aspherics, alternate, iters, tol,
                            aspherics_odd, xy_poly)


def intercept_toroid(x, y, z, ux, uy, uz, cr, cy, ky, aspherics,
                     alternate, iters=ASPHERIC_ITERS, tol=ASPHERIC_TOL,
                     aspherics_odd=None, xy_poly=None):
    """Ray length to a toroidal surface (reference intercept_toroid):
    the y-conic seeds a fixed-count Newton on the exact sag."""
    return _anamorphic_root("toroid", x, y, z, ux, uy, uz, cr, cy, ky,
                            None, cy, ky, aspherics, alternate, iters, tol,
                            aspherics_odd, xy_poly)


def doe_kick(x, y, doe):
    """Per-ray tangential kick (sx, sy) of a radially symmetric
    diffractive phase: the table column `doe` holds the dimensionless
    kick potential psi(r^2) = sum doe[i] r**(2i+2) (= m lambda phi(r)/
    (2 pi n_after), phi the imprinted phase in radians), so the Spencer
    & Murty kick is grad psi = dpsi/d(r^2) * (2x, 2y)."""
    e = _dpoly_even(x*x + y*y, doe)
    return e*x, e*y


def refract_grating(x, y, ux, uy, uz, mu, gdy, gx, gy, doe=None):
    """Diffraction-grating refraction or reflection on an arbitrary
    substrate normal (gx, gy, 1), the JAX package's refract_grating: the
    generalized Spencer & Murty construction u' = |mu| u + T q + s +
    Gamma n with the unit groove vector q (y-hat projected into the
    tangent plane), the grating term T = m lambda G / n_after (the
    table's grating_dy) and an optional radial diffractive kick s =
    grad psi(r^2) (the table's doe row).  A mirror (mu == -1) takes the
    root that flips the normal component.  T == 0 and s == 0 reduce
    exactly to Snell or the mirror; the row passes untouched only where
    mu == 1, T == 0 and every doe coefficient is 0 -- decided for the
    row, not a ray (an on-axis ray has s == 0 and still takes the
    solve).  An evanescent order (no real Gamma) gives NaN."""
    nn = gx*gx + gy*gy + 1.
    inv_nn = 1./nn
    muf = torch.abs(mu)
    qx, qy, qz = -gy*gx*inv_nn, 1. - gy*gy*inv_nn, -gy*inv_nn
    qn = torch.rsqrt(torch.clamp(qx*qx + qy*qy + qz*qz, min=TINY))
    qx, qy, qz = qx*qn, qy*qn, qz*qn
    bx = muf*ux + gdy*qx
    by = muf*uy + gdy*qy
    bz = muf*uz + gdy*qz
    keep = (mu == 1) & (torch.as_tensor(gdy) == 0)
    if _width(doe):
        sx, sy = doe_kick(x, y, doe)
        bx = bx + sx
        by = by + sy
        keep = keep & torch.all(doe == 0, dim=-1)
    bn = (bx*gx + by*gy + bz)*inv_nn
    bb = bx*bx + by*by + bz*bz
    disc = bn*bn - (bb - 1.)*inv_nn
    root = _sqrt0(disc)
    gam_t = -bn + torch.sign(mu)*root
    gam_r = -bn - torch.sign(bn)*root
    gam = torch.where(mu == -1, gam_r, gam_t)
    gam = torch.where(disc < 0, NAN, gam)
    ox, oy, oz = bx + gam*gx, by + gam*gy, bz + gam
    return (torch.where(keep, ux, ox), torch.where(keep, uy, oy),
            torch.where(keep, uz, oz))


def _refract_general(x, y, ux, uy, uz, mu, gx, gy):
    """Snell/mirror on an arbitrary (gx, gy, 1) normal (reference
    kernels._refract_general)."""
    r2 = gx*gx + gy*gy + 1.
    muf = torch.abs(mu)
    a = muf*(ux*gx + uy*gy + uz)/r2
    rx, ry, rz = ux - 2*a*gx, uy - 2*a*gy, uz - 2*a
    b = (mu*mu - 1)/r2
    disc = a*a - b
    g = -a + torch.sign(mu)*_sqrt0(disc)
    g = torch.where(disc < 0, NAN, g)
    tx, ty, tz = muf*ux + g*gx, muf*uy + g*gy, muf*uz + g
    ox = torch.where(mu == -1, rx, tx)
    oy = torch.where(mu == -1, ry, ty)
    oz = torch.where(mu == -1, rz, tz)
    ox = torch.where(mu == 1, ux, ox)
    oy = torch.where(mu == 1, uy, oy)
    oz = torch.where(mu == 1, uz, oz)
    return ox, oy, oz


def normal_freeform(x, y, c, k, aspherics, aspherics_odd, xy_poly):
    """Transverse components (gx, gy) of the unnormalized normal
    (gx, gy, 1) = grad(z - sag) of a freeform row: the conic/aspheric
    base's radial normal (normal_radial, every coefficient of the
    widths) less the XY figure's slopes (reference normal_freeform)."""
    e = normal_radial(x, y, c, k, aspherics, aspherics_odd)
    gx, gy = x*e, y*e
    if _width(xy_poly):
        dpx, dpy = _dpoly_xy(x, y, xy_poly)
        gx = gx - dpx
        gy = gy - dpy
    return gx, gy


def refract_freeform(x, y, ux, uy, uz, mu, c, k, aspherics, aspherics_odd,
                     xy_poly):
    """Snell/mirror refraction with the freeform normal."""
    gx, gy = normal_freeform(x, y, c, k, aspherics, aspherics_odd, xy_poly)
    return _refract_general(x, y, ux, uy, uz, mu, gx, gy)


def refract_biconic(x, y, ux, uy, uz, mu, cx, kx, cy, ky, aspherics=None,
                    aspherics_odd=None):
    """Snell/mirror refraction with the general biconic normal."""
    gx, gy = normal_biconic(x, y, cx, kx, cy, ky, aspherics, aspherics_odd)
    return _refract_general(x, y, ux, uy, uz, mu, gx, gy)


def refract_toroid(x, y, ux, uy, uz, mu, cr, cy, ky, aspherics=None,
                   aspherics_odd=None):
    """Snell/mirror refraction with the toroidal normal."""
    gx, gy = normal_toroid(x, y, cr, cy, ky, aspherics, aspherics_odd)
    return _refract_general(x, y, ux, uy, uz, mu, gx, gy)


def intercept_cyl(w, z, uw, uz, c, k, alternate):
    """Closed-form intercept of a pure conic cylinder, the quadric
    c (w^2 + (1+k) z^2) - 2 z = 0 in the curved coordinate w alone.

    It takes intercept_conic's cancellation-free numerator/denominator
    pair (f/(g - d) where d and g differ in sign or e == 0, else
    -(d + g)/e) and divides once.  The JAX package's intercept_cyl
    keeps -(d + g)/e wherever e != 0, which loses its digits near the
    axis of a weak cylinder or at a curvature an optimizer drives
    toward 0: a chosen divergence (ROADMAP, Queue 3)."""
    k1 = 1 + k
    uy_ = uw*w + k1*uz*z
    uu = uw*uw + k1*uz*uz
    yy = w*w + k1*z*z
    d = c*uy_ - uz
    e = c*uu
    f = c*yy - 2*z
    disc = d*d - e*f
    g = _sqrt0(disc)*(1 - 2*alternate)
    conj = (d*g <= 0) | (e == 0)
    num = torch.where(conj, f, -(d + g))
    den = torch.where(conj, g - d, e)
    s = num/torch.where(den == 0, 1., den)
    return torch.where(disc < 0, NAN, s)


def refract_cyl(w, z, uw, uv, uz, mu, c, k, kind):
    """Snell/mirror on a conic cylinder's polynomial normal
    N = (-c w, 1 - c(1+k) z) at the on-surface point (w, z): uw is the
    direction along the curved axis, uv along the flat one.  kind: 1
    refract, 2 mirror (static).  Returns (uw', uv', uz')."""
    nw = -c*w
    nz = 1. - (1 + k)*c*z
    inv = 1./(nw*nw + nz*nz)
    dot = uw*nw + uz*nz
    if kind == 2:
        a2 = 2.*dot*inv
        return uw - a2*nw, uv, uz - a2*nz
    muf = torch.abs(mu)
    a = muf*dot*inv
    b = (mu*mu - 1)*inv
    disc = a*a - b
    g = -a + torch.sign(mu)*_sqrt0(disc)
    g = torch.where(disc < 0, NAN, g)
    return muf*uw + g*nw, muf*uv, muf*uz + g*nz


def refract(x, y, ux, uy, uz, mu, c, k, aspherics=None,
            aspherics_odd=None):
    """Vector Snell / mirror reflection on components at a conic with
    even/odd aspheric figure (reference elements.py:351): mu == -1
    reflects, mu == 1 passes."""
    e = normal_radial(x, y, c, k, aspherics, aspherics_odd)
    nx, ny = x*e, y*e
    r2 = nx*nx + ny*ny + 1.
    muf = torch.abs(mu)
    a = muf*(ux*nx + uy*ny + uz)/r2
    # reflection (mu == -1, muf == 1)
    rx, ry, rz = ux - 2*a*nx, uy - 2*a*ny, uz - 2*a
    # refraction
    b = (mu*mu - 1)/r2
    disc = a*a - b
    g = -a + torch.sign(mu)*_sqrt0(disc)
    g = torch.where(disc < 0, NAN, g)
    tx, ty, tz = muf*ux + g*nx, muf*uy + g*ny, muf*uz + g
    ox = torch.where(mu == -1, rx, tx)
    oy = torch.where(mu == -1, ry, ty)
    oz = torch.where(mu == -1, rz, tz)
    ox = torch.where(mu == 1, ux, ox)
    oy = torch.where(mu == 1, uy, oy)
    oz = torch.where(mu == 1, uz, oz)
    return ox, oy, oz


class SurfaceSpec(NamedTuple):
    """Static per-surface specialization flags, derived on the host
    from the concrete table by `specialize` (field for field the JAX
    package's SurfaceSpec).  kind: 0 = passthrough (mu == 1),
    1 = refract, 2 = mirror (mu == -1)."""

    flat: bool        # curvature == 0
    spherical: bool   # conic == 0 (and not flat)
    aspheric: bool    # any even-aspheric coefficient nonzero
    rotated: bool     # rot != identity
    off_axis: bool    # offset has nonzero x/y
    alternate: bool   # alternate (far) conic intersection
    kind: int
    finite_aperture: bool
    off_sign: int     # sign of the axial offset (static geometry)
    odd: bool = False
    biconic: bool = False
    toroidal: bool = False
    grating: bool = False
    cyl_axis: int = 0
    doe: bool = False
    freeform: bool = False


def is_figured(spec):
    """True for an even- or odd-aspheric row (the Newton intercept)."""
    return bool(spec.aspheric or spec.odd)


def is_anamorphic_spec(spec):
    """True for a biconic, toroidal or cylinder row."""
    return bool(spec.biconic or spec.toroidal or spec.cyl_axis)


def reads_figure(spec):
    """True for a row whose intercept or normal reads every aspheric
    coefficient of the table's widths: an aspheric row, a freeform row
    (its sag and normal_radial take the whole coefficient rows, zeros
    included), a biconic or toroid, figured or not (the reference passes
    the whole coefficient rows into their sags and normals), and a
    grating or DOE on a cylinder, whose phase solve takes the normal of
    the biconic or toroid that made it (a plain cylinder's closed form
    and normal read none)."""
    return bool(is_figured(spec) or spec.freeform
                or ((spec.biconic or spec.toroidal)
                    and (not spec.cyl_axis or is_phase(spec))))


def is_phase(spec):
    """True for a grating or DOE row (the generalized solve)."""
    return bool(spec.grating or spec.doe)


def check_supported(spec, j=None, what="rayopt_tpu_torch", kernel=None):
    """Raise NotImplementedError for a row that `what` (a key of
    `kernel`, "k1" ... "k9", or the hand reverse's model) does not
    trace: a freeform figure on a biconic or toroidal base, which
    `specialize` refuses (as the JAX package's does).  Every K1-K9 key
    takes every other row."""
    if kernel is None or not spec.freeform:
        return
    if is_anamorphic_spec(spec):
        raise NotImplementedError(
            "surface row %s combines an anamorphic base with a freeform XY "
            "figure, which %s does not trace (specialize refuses it: "
            "express the full figure in xy_poly)"
            % ("?" if j is None else j, what))


def specialize(table):
    """Host-side: derive the static SurfaceSpec tuple from a concrete
    SurfaceTable.  Pose deltas (tilt/decenter) are folded first, so a
    concretely tilted/decentered row gets rotated/off_axis flags."""
    from .tables import lower_pose
    tab = lower_pose(table)

    def host(f):
        return None if f is None else f.detach().cpu().double().numpy()

    curv, conic = host(tab.curvature), host(tab.conic)
    asp, asp_odd = host(tab.aspherics), host(tab.aspherics_odd)
    rots, offs = host(tab.rot), host(tab.offset)
    mus, alts, rads = host(tab.mu), host(tab.alternate), host(tab.radius)
    s = curv.shape[0]
    zeros = np.zeros(s)
    cdxs = host(tab.curvature_dx) if tab.curvature_dx is not None else zeros
    kdxs = host(tab.conic_dx) if tab.conic_dx is not None else zeros
    tors = host(tab.toroidal) if tab.toroidal is not None else zeros
    grats = host(tab.grating_dy) if tab.grating_dy is not None else zeros
    doe_all = host(tab.doe) if tab.doe is not None else np.zeros((s, 0))
    xy_all = (host(tab.xy_poly) if tab.xy_poly is not None
              else np.zeros((s, 0)))
    specs = []
    for j in range(s):
        c, k = float(curv[j]), float(conic[j])
        mu, alt, rad = float(mus[j]), float(alts[j]), float(rads[j])
        rot, off = rots[j], offs[j]
        cdx, kdx = float(cdxs[j]), float(kdxs[j])
        tor, grat = float(tors[j]), float(grats[j])
        kind = 0 if mu == 1. else (2 if mu == -1. else 1)
        asp_j, odd_j = asp[j], asp_odd[j]
        figured = bool((asp_j.size and np.any(asp_j != 0))
                       or (odd_j.size and np.any(odd_j != 0)))
        cyl_axis = 0
        if not figured:
            if tor != 0. and c + cdx == 0. and c != 0.:
                cyl_axis = 1
            elif tor == 0. and (cdx != 0. or kdx != 0.):
                if c + cdx == 0. and c != 0.:
                    cyl_axis = 1
                elif c == 0. and c + cdx != 0.:
                    cyl_axis = 2
        specs.append(SurfaceSpec(
            flat=(c == 0.),
            spherical=(k == 0.),
            aspheric=bool(asp_j.size and np.any(asp_j != 0)),
            rotated=not np.allclose(rot, np.eye(3)),
            off_axis=bool(off[0] != 0 or off[1] != 0),
            alternate=bool(alt != 0),
            kind=kind,
            finite_aperture=bool(np.isfinite(rad)),
            off_sign=int(np.sign(off[2])) or 1,
            odd=bool(odd_j.size and np.any(odd_j != 0)),
            biconic=bool((cdx != 0. or kdx != 0.) and tor == 0.),
            toroidal=bool(tor != 0.),
            grating=bool(grat != 0.),
            cyl_axis=cyl_axis,
            doe=bool(doe_all[j].size and np.any(doe_all[j] != 0)),
            freeform=bool(xy_all[j].size and np.any(xy_all[j] != 0)),
        ))
        if specs[-1].freeform and (specs[-1].biconic or specs[-1].toroidal):
            raise NotImplementedError(
                "row %d combines an anamorphic base with a freeform XY "
                "figure; express the full figure in xy_poly (quadratic "
                "terms carry the cylinder power)" % j)
    return tuple(specs)


def with_pose(specs, rows=None):
    """Force the rotated/off_axis flags on the given spec rows
    (default: every row but the object) so the pose parameters they
    gate stay live in the specialized engines.  Forward results are
    unchanged (identity rotation applied, zero transverse offset
    subtracted)."""
    if rows is None or rows is True:
        live = set(range(1, len(specs)))
    else:
        live = set(int(r) for r in rows)
    return tuple(s._replace(rotated=True, off_axis=True)
                 if j in live else s for j, s in enumerate(specs))


def intercept_spec(x, y, z, ux, uy, uz, c, k, spec):
    """Specialized conic intercept: assumes unit direction vectors
    (uu == 1 when spherical), drops the conic terms when spherical,
    and the whole quadratic when flat.

    Spherical and conic rows pick the cancellation-free numerator/
    denominator pair as intercept_conic does (f/(g - d) where d and g
    differ in sign or e == 0, else -(d + g)/e) and divide once.  The
    JAX package's specialized intercept keeps -(d + g)/e (spherical:
    times a baked -1/c), which loses its digits near the axis of a
    paraboloid and on a spherical row whose curvature tends to 0: a
    chosen divergence (ROADMAP, Queue 3)."""
    if spec.flat:
        uz_safe = torch.where(uz == 0, 1., uz)
        return -z/uz_safe
    if spec.spherical:
        uy_ = ux*x + uy*y + uz*z
        uu = 1.
        yy = x*x + y*y + z*z
    else:
        k1 = 1 + k
        uy_ = ux*x + uy*y + k1*uz*z
        uu = ux*ux + uy*uy + k1*uz*uz
        yy = x*x + y*y + k1*z*z
    d = c*uy_ - uz
    e = c*uu
    f = c*yy - 2*z
    disc = d*d - e*f
    g = _sqrt0(disc)
    if spec.alternate:
        g = -g
    conj = (d*g <= 0) | (e == 0)
    num = torch.where(conj, f, -(d + g))
    den = torch.where(conj, g - d, e)
    s = num/torch.where(den == 0, 1., den)
    return torch.where(disc < 0, NAN, s)


def refract_spec(x, y, z, ux, uy, uz, mu, c, k, spec, aspherics=None,
                 aspherics_odd=None):
    """Specialized Snell/mirror refraction at the on-surface point
    (x, y, z local) of a flat, spherical, conic or even/odd aspheric
    row (the coefficients are read only where the spec flags them)."""
    if spec.kind == 0:
        return ux, uy, uz
    if is_figured(spec):
        return _refract_figured(x, y, ux, uy, uz, mu, c, k, spec,
                                aspherics, aspherics_odd)
    if spec.flat:
        # plane: normal is exactly +z
        if spec.kind == 2:
            return ux, uy, -uz
        muf = torch.abs(mu)
        a = muf*uz
        disc = a*a - (mu*mu - 1)
        g = -a + torch.sign(mu)*_sqrt0(disc)
        g = torch.where(disc < 0, NAN, g)
        return muf*ux, muf*uy, muf*uz + g
    # implicit-gradient conic normal at the on-surface point:
    # N = (-c x, -c y, 1 - c(1+k) z); for a sphere |N| == 1 exactly
    nx, ny = -c*x, -c*y
    if spec.spherical:
        nz = 1. - c*z
        dot = ux*nx + uy*ny + uz*nz
        if spec.kind == 2:
            a2 = 2.*dot
            return ux - a2*nx, uy - a2*ny, uz - a2*nz
        muf = torch.abs(mu)
        a = muf*dot
        disc = a*a - (mu*mu - 1)
    else:
        nz = 1. - (1 + k)*c*z
        dot = ux*nx + uy*ny + uz*nz
        ir2 = 1./(nx*nx + ny*ny + nz*nz)
        if spec.kind == 2:
            a2 = 2.*dot*ir2
            return ux - a2*nx, uy - a2*ny, uz - a2*nz
        muf = torch.abs(mu)
        a = muf*dot*ir2
        disc = a*a - (mu*mu - 1)*ir2
    g = -a + torch.sign(mu)*_sqrt0(disc)
    g = torch.where(disc < 0, NAN, g)
    return muf*ux + g*nx, muf*uy + g*ny, muf*uz + g*nz


def _refract_figured(x, y, ux, uy, uz, mu, c, k, spec, aspherics,
                     aspherics_odd):
    """Snell/mirror refraction of an aspheric row by the radial normal
    (x e, y e, 1), e = -c/sqrt(max(1 - (1+k) c^2 r^2, TINY)) minus the
    polynomial slopes the spec flags (the reference's figured branch of
    refract_spec)."""
    r2s = x*x + y*y
    e = -c*torch.rsqrt(torch.clamp(1 - (1 + k)*c*c*r2s, min=TINY))
    if spec.aspheric:
        e = e - _dpoly_even(r2s, aspherics)
    if spec.odd:
        e = e - _dpoly_odd(r2s, aspherics_odd)
    nx, ny = x*e, y*e
    r2 = nx*nx + ny*ny + 1.
    ir2 = 1./r2
    dot = ux*nx + uy*ny + uz
    if spec.kind == 2:
        a2 = 2.*dot*ir2
        return ux - a2*nx, uy - a2*ny, uz - a2
    muf = torch.abs(mu)
    a = muf*dot*ir2
    b = (mu*mu - 1)*ir2
    disc = a*a - b
    g = -a + torch.sign(mu)*_sqrt0(disc)
    g = torch.where(disc < 0, NAN, g)
    return muf*ux + g*nx, muf*uy + g*ny, muf*uz + g


def surface_step_spec(state, surf, spec, clip):
    """Specialized transfer-intercept-refract step (same semantics as
    surface_step; static branches from SurfaceSpec).  Returns
    (next_state, ((x1, y1, z1), (ux1, uy1, uz1), (ux, uy, uz), topt))
    with the local outputs in the surface-normal frame."""
    x, y, z, ux, uy, uz = state
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
    if spec.rotated:
        r = surf.rot
        x, y, z = rot_apply(r, x, y, z)
        ux, uy, uz = rot_apply(r, ux, uy, uz)
    c, k = surf.curvature, surf.conic
    if is_anamorphic_spec(spec):
        cx, kx = c + surf.curvature_dx, k + surf.conic_dx
    if spec.cyl_axis == 1:
        t = intercept_cyl(y, z, uy, uz, c, k, surf.alternate)
    elif spec.cyl_axis == 2:
        t = intercept_cyl(x, z, ux, uz, cx, kx, surf.alternate)
    elif spec.toroidal:
        t = intercept_toroid(x, y, z, ux, uy, uz, cx, c, k,
                             surf.aspherics, surf.alternate,
                             aspherics_odd=surf.aspherics_odd)
    elif spec.biconic:
        t = intercept_biconic(x, y, z, ux, uy, uz, cx, kx, c, k,
                              surf.aspherics, surf.alternate,
                              aspherics_odd=surf.aspherics_odd)
    elif spec.freeform:
        t = intercept(x, y, z, ux, uy, uz, c, k, surf.aspherics,
                      surf.alternate, aspherics_odd=surf.aspherics_odd,
                      xy_poly=surf.xy_poly)
    elif is_figured(spec):
        t = intercept(x, y, z, ux, uy, uz, c, k, surf.aspherics,
                      surf.alternate, aspherics_odd=surf.aspherics_odd)
    else:
        t = intercept_spec(x, y, z, ux, uy, uz, c, k, spec)
    x1, y1, z1 = x + t*ux, y + t*uy, z + t*uz
    topt = t*surf.n_before
    ux0, uy0, uz0 = ux, uy, uz
    if clip and spec.finite_aperture:
        # a clipped ray loses its INCOMING direction: it turns NaN one
        # surface later, its intercept stays finite
        bad = x1*x1 + y1*y1 > surf.radius*surf.radius
        ux0 = torch.where(bad, NAN, ux0)
        uy0 = torch.where(bad, NAN, uy0)
        uz0 = torch.where(bad, NAN, uz0)
    if is_phase(spec):
        # the substrate's normal by its figure, then the generalized
        # grating/phase solve (exact Snell at order zero); before the
        # passthrough: a grating row with mu == 1 still diffracts
        if spec.toroidal:
            ngx, ngy = normal_toroid(x1, y1, cx, c, k, surf.aspherics,
                                     surf.aspherics_odd)
        elif spec.biconic:
            ngx, ngy = normal_biconic(x1, y1, cx, kx, c, k, surf.aspherics,
                                      surf.aspherics_odd)
        elif spec.freeform:
            ngx, ngy = normal_freeform(x1, y1, c, k, surf.aspherics,
                                       surf.aspherics_odd, surf.xy_poly)
        elif spec.flat and not is_figured(spec):
            ngx, ngy = torch.zeros_like(x1), torch.zeros_like(y1)
        else:
            e = normal_radial(x1, y1, c, k, surf.aspherics,
                              surf.aspherics_odd)
            ngx, ngy = x1*e, y1*e
        ux1, uy1, uz1 = refract_grating(
            x1, y1, ux0, uy0, uz0, surf.mu,
            surf.grating_dy if spec.grating else 0., ngx, ngy,
            doe=surf.doe if spec.doe else None)
        if spec.doe:
            # the imprinted phase is optical path: psi * n_after
            topt = topt + _poly_even(x1*x1 + y1*y1, surf.doe)*surf.n_after
    elif is_anamorphic_spec(spec) and spec.kind == 0:
        # a passthrough anamorphic row skips the normal and Snell
        ux1, uy1, uz1 = ux0, uy0, uz0
    elif spec.cyl_axis == 1:
        uy1, ux1, uz1 = refract_cyl(y1, z1, uy0, ux0, uz0, surf.mu, c, k,
                                    spec.kind)
    elif spec.cyl_axis == 2:
        ux1, uy1, uz1 = refract_cyl(x1, z1, ux0, uy0, uz0, surf.mu, cx, kx,
                                    spec.kind)
    elif spec.toroidal:
        ux1, uy1, uz1 = refract_toroid(x1, y1, ux0, uy0, uz0, surf.mu, cx,
                                       c, k, surf.aspherics,
                                       surf.aspherics_odd)
    elif spec.biconic:
        ux1, uy1, uz1 = refract_biconic(x1, y1, ux0, uy0, uz0, surf.mu, cx,
                                        kx, c, k, surf.aspherics,
                                        surf.aspherics_odd)
    elif spec.freeform:
        # a passthrough freeform row keeps the ray (its intercept stands)
        if spec.kind == 0:
            ux1, uy1, uz1 = ux0, uy0, uz0
        else:
            ux1, uy1, uz1 = refract_freeform(
                x1, y1, ux0, uy0, uz0, surf.mu, c, k, surf.aspherics,
                surf.aspherics_odd, surf.xy_poly)
    else:
        ux1, uy1, uz1 = refract_spec(x1, y1, z1, ux0, uy0, uz0, surf.mu,
                                     c, k, spec, surf.aspherics,
                                     surf.aspherics_odd)
    out = ((x1, y1, z1), (ux1, uy1, uz1), (ux, uy, uz), topt)
    if spec.rotated:
        r = surf.rot
        nstate = (*rot_apply_t(r, x1, y1, z1),
                  *rot_apply_t(r, ux1, uy1, uz1))
    else:
        nstate = (x1, y1, z1, ux1, uy1, uz1)
    return nstate, out


def _intercept_anam(x, y, z, ux, uy, uz, surf, xy=None):
    """Per-row biconic-or-toroid intercept of the dynamic walk (the row
    kind is a value: both candidates evaluate and a select picks one,
    as the reference's _intercept_anam).  A freeform XY figure (`xy`,
    the zero-padded table column) rides both candidates: a symmetric
    base plus the monomial terms is exactly the freeform sag."""
    cx, kx = surf.curvature + surf.curvature_dx, surf.conic + surf.conic_dx
    tb = intercept_biconic(x, y, z, ux, uy, uz, cx, kx, surf.curvature,
                           surf.conic, surf.aspherics, surf.alternate,
                           aspherics_odd=surf.aspherics_odd, xy_poly=xy)
    tt = intercept_toroid(x, y, z, ux, uy, uz, cx, surf.curvature,
                          surf.conic, surf.aspherics, surf.alternate,
                          aspherics_odd=surf.aspherics_odd, xy_poly=xy)
    return torch.where(surf.toroidal != 0, tt, tb)


def _refract_anam(x, y, ux, uy, uz, surf, xy=None):
    """The dynamic walk's refraction of an anamorphic (or grating, DOE or
    freeform) table: the biconic-or-toroid normal less the freeform
    figure's slopes (`xy`), then the generalized grating/phase solve
    with the row's grating term and diffractive kick (refract_grating)
    -- at zero both, Snell or a mirror's reflection on the (gx, gy, 1)
    normal."""
    c, k, mu = surf.curvature, surf.conic, surf.mu
    cx, kx = c + surf.curvature_dx, k + surf.conic_dx
    gbx, gby = normal_biconic(x, y, cx, kx, c, k, surf.aspherics,
                              surf.aspherics_odd)
    gtx, gty = normal_toroid(x, y, cx, c, k, surf.aspherics,
                             surf.aspherics_odd)
    tor = surf.toroidal != 0
    gx = torch.where(tor, gtx, gbx)
    gy = torch.where(tor, gty, gby)
    if _width(xy):
        dpx, dpy = _dpoly_xy(x, y, xy)
        gx = gx - dpx
        gy = gy - dpy
    gdy = 0. if surf.grating_dy is None else surf.grating_dy
    return refract_grating(x, y, ux, uy, uz, mu, gdy, gx, gy, doe=surf.doe)


def surface_step(state, surf, clip, biconic=False):
    """One generic transfer-intercept-refract step on component state
    (x, y, z, ux, uy, uz): every row is rotated, intercepted by the
    general conic (refined by the Newton on the exact sag when the
    table has aspheric columns of nonzero width, `intercept`) and
    refracted with the radial normal, with no static specialization.
    biconic (static; set it when ops.tables.is_anamorphic(table)): every
    row takes the anamorphic sag instead -- the biconic-or-toroid
    seeded Newton and normal (_intercept_anam), and the generalized
    grating/phase solve (_refract_anam) with the DOE's path term.
    A table whose xy_poly column has a nonzero width gives EVERY row
    the freeform figure of its (zero-padded) coefficients -- decided by
    the column's width, not by the row, as in the reference: the Newton
    with the vertex-plane restart and the freeform normal, zeros
    included.  Returns (next_state, local_outputs) with the per-surface
    (y, u, i, t) in the surface-normal frame (reference
    system.py:459-464)."""
    x, y, z, ux, uy, uz = state
    ox, oy, oz = surf.offset[0], surf.offset[1], surf.offset[2]
    r = surf.rot
    x, y, z = rot_apply(r, x - ox, y - oy, z - oz)
    ix, iy, iz = rot_apply(r, ux, uy, uz)
    xy = surf.xy_poly if _width(surf.xy_poly) else None
    if biconic:
        t = _intercept_anam(x, y, z, ix, iy, iz, surf, xy)
    else:
        t = intercept(x, y, z, ix, iy, iz, surf.curvature, surf.conic,
                      surf.aspherics, surf.alternate,
                      aspherics_odd=surf.aspherics_odd, xy_poly=xy)
    x1, y1, z1 = x + t*ix, y + t*iy, z + t*iz
    ux0, uy0, uz0 = ix, iy, iz
    if clip:
        bad = x1*x1 + y1*y1 > surf.radius*surf.radius
        ux0 = torch.where(bad, NAN, ux0)
        uy0 = torch.where(bad, NAN, uy0)
        uz0 = torch.where(bad, NAN, uz0)
    topt = t*surf.n_before
    if biconic:
        ux1, uy1, uz1 = _refract_anam(x1, y1, ux0, uy0, uz0, surf, xy)
        if _width(surf.doe):
            # the imprinted phase is optical path (surface_step_spec); a
            # row of zero coefficients adds zero
            topt = topt + _poly_even(x1*x1 + y1*y1, surf.doe)*surf.n_after
    elif xy is not None:
        ux1, uy1, uz1 = refract_freeform(x1, y1, ux0, uy0, uz0, surf.mu,
                                         surf.curvature, surf.conic,
                                         surf.aspherics, surf.aspherics_odd,
                                         xy)
    else:
        ux1, uy1, uz1 = refract(x1, y1, ux0, uy0, uz0, surf.mu,
                                surf.curvature, surf.conic,
                                surf.aspherics, surf.aspherics_odd)
    out = ((x1, y1, z1), (ux1, uy1, uz1), (ix, iy, iz), topt)
    nx, ny, nz = rot_apply_t(r, x1, y1, z1)
    nux, nuy, nuz = rot_apply_t(r, ux1, uy1, uz1)
    return (nx, ny, nz, nux, nuy, nuz), out


def split(v):
    """(N, 3) -> component tuple."""
    return v[..., 0], v[..., 1], v[..., 2]


def join(x, y, z):
    """component tuple -> (..., 3)."""
    return torch.stack([x, y, z], dim=-1)


def specs_from_tuple(specs):
    """The port's SurfaceSpec tuple from any tuple of spec-likes with
    the same fields (e.g. the JAX package's kernels.specialize)."""
    return tuple(SurfaceSpec(**s._asdict()) for s in specs)
