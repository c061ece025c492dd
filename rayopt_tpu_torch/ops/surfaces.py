"""Surface kernels on (..., 3) tensors: sag, normal, intercept, Snell.

The single-surface oracle behind the Element methods (reference
elements.py:440-501 for the spheroid sag/normal and closed-form conic
intercept, elements.py:333-349 for the iterative aspheric intercept,
elements.py:351-369 for vector Snell / reflection), written as
batched, NaN-safe torch functions: every branch is a `torch.where`
select, and a missed or totally reflected ray is NaN.

Conic surfaces with even and odd aspheric figure: an aspheric
intercept is the conic root refined by a fixed trip-count Newton over
the whole bundle (ASPHERIC_ITERS, unrolled: its gradient is that of
the iterations, as in the reference's oracle).  A freeform XY figure
(`xy_poly` of nonzero width, the triangular monomials of
kernels._poly_xy) adds to the sag and its slopes to the normal; its
intercept restarts a ray whose conic seed misses from the vertex plane,
as the reference's oracle does.
"""

import torch

from .kernels import (ASPHERIC_ITERS, ASPHERIC_TOL, _dpoly_even,
                      _dpoly_odd, _dpoly_xy, _poly_even, _poly_odd, _poly_xy,
                      _sqrt0)


def _scalars(ref, *vals):
    """Surface parameters (floats or tensors) as tensors of ref's
    dtype and device."""
    return tuple(torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                 for v in vals)


def _coeffs(ref, coeffs):
    """A coefficient vector as a tensor of ref's dtype and device, or
    None when absent or of zero width (a static shape)."""
    if coeffs is None:
        return None
    coeffs = torch.as_tensor(coeffs, dtype=ref.dtype, device=ref.device)
    return coeffs if coeffs.shape[-1] else None


def surface_sag(xyz, curvature, conic, aspherics, aspherics_odd=None,
                xy_poly=None):
    """Signed distance along z from the surface: z - sag(x, y)
    (reference elements.py:440), with the even and odd aspheric terms
    and the freeform XY figure."""
    e = xyz[..., 2]
    r2 = torch.square(xyz[..., :2]).sum(-1)
    c, k = _scalars(xyz, curvature, conic)
    sq = _sqrt0(1 - (1 + k)*c**2*r2)
    e = e - c*r2/(1 + sq)
    asp, aspo = _coeffs(xyz, aspherics), _coeffs(xyz, aspherics_odd)
    if asp is not None:
        e = e - _poly_even(r2, asp)
    if aspo is not None:
        e = e - _poly_odd(r2, aspo)
    xy = _coeffs(xyz, xy_poly)
    if xy is not None:
        e = e - _poly_xy(xyz[..., 0], xyz[..., 1], xy)
    return e


def surface_normal(xyz, curvature, conic, aspherics,
                   aspherics_odd=None, xy_poly=None):
    """(Unnormalized) surface normal of the sag function, pointing +z
    (reference elements.py:457), the freeform figure's slopes
    included."""
    r2 = torch.square(xyz[..., :2]).sum(-1)
    c, k = _scalars(xyz, curvature, conic)
    e = -c/_sqrt0(1 - (1 + k)*c**2*r2)
    asp, aspo = _coeffs(xyz, aspherics), _coeffs(xyz, aspherics_odd)
    if asp is not None:
        e = e - _dpoly_even(r2, asp)
    if aspo is not None:
        e = e - _dpoly_odd(r2, aspo)
    gx = xyz[..., 0]*e
    gy = xyz[..., 1]*e
    xy = _coeffs(xyz, xy_poly)
    if xy is not None:
        dpx, dpy = _dpoly_xy(xyz[..., 0], xyz[..., 1], xy)
        gx = gx - dpx
        gy = gy - dpy
    return torch.stack([gx, gy, torch.ones_like(e)], dim=-1)


def intercept_conic(y, u, curvature, conic, alternate):
    """Closed-form ray length to a conic surface (reference
    elements.py:477-501): c == 0 is the plane, e == 0 takes the
    conjugate-root form, a negative discriminant (a miss) is NaN; the
    cancellation-free root form is picked from the sign of d*g."""
    c, k, alternate = _scalars(y, curvature, conic, alternate)
    kv = torch.stack([torch.ones_like(k), torch.ones_like(k), 1 + k],
                     dim=-1)
    uy = (u*y*kv).sum(-1)
    uu = (torch.square(u)*kv).sum(-1)
    yy = (torch.square(y)*kv).sum(-1)
    d = c*uy - u[..., 2]
    e = c*uu
    f = c*yy - 2*y[..., 2]
    disc = torch.square(d) - e*f
    g = _sqrt0(disc)*(1 - 2*alternate)
    conj = (d*g <= 0) | (e == 0)
    num = torch.where(conj, f, -(d + g))
    den = torch.where(conj, g - d, e)
    den_safe = torch.where(den == 0, 1., den)
    s = num/den_safe
    uz_safe = torch.where(u[..., 2] == 0, 1., u[..., 2])
    s = torch.where(c == 0, -y[..., 2]/uz_safe, s)
    return torch.where((c != 0) & (disc < 0), float("nan"), s)


def intercept(y, u, curvature, conic, aspherics, alternate=0.,
              aspherics_odd=None, xy_poly=None, iters=ASPHERIC_ITERS,
              tol=ASPHERIC_TOL):
    """Ray length from y along unit u to the surface: the closed conic
    root, refined when aspheric coefficients are present (a static
    shape) by a fixed trip-count Newton on the full sag (replacing the
    per-ray scipy.newton loop of reference elements.py:333-349).  A
    ray that does not converge is NaN; so is one whose conic seed misses
    a curved surface, unless the surface has a freeform figure: that ray
    restarts from the vertex plane (the symmetric seed can miss rays the
    true surface catches)."""
    s = intercept_conic(y, u, curvature, conic, alternate)
    has_xy = _coeffs(y, xy_poly) is not None
    if (_coeffs(y, aspherics) is None and _coeffs(y, aspherics_odd) is None
            and not has_xy):
        return s
    s0 = s
    if has_xy:
        uz_safe = torch.where(u[..., 2] == 0, 1., u[..., 2])
        s = torch.where(torch.isnan(s0), -y[..., 2]/uz_safe, s0)
    for _ in range(iters):
        p = y + s[..., None]*u
        fn = surface_sag(p, curvature, conic, aspherics, aspherics_odd,
                         xy_poly)
        fp = (surface_normal(p, curvature, conic, aspherics,
                             aspherics_odd, xy_poly)*u).sum(-1)
        fp = torch.where(fp == 0, 1., fp)
        s = s - fn/fp
    p = y + s[..., None]*u
    res = surface_sag(p, curvature, conic, aspherics, aspherics_odd,
                      xy_poly)
    s = torch.where(torch.abs(res) <= tol*(1 + torch.abs(s)), s,
                    float("nan"))
    if has_xy:
        return s
    c, = _scalars(y, curvature)
    return torch.where(torch.isnan(s0) & (c != 0), float("nan"), s)


def refract(y, u0, mu, curvature, conic, aspherics,
            aspherics_odd=None, xy_poly=None):
    """Vector Snell refraction / mirror reflection at the intercept
    (Spencer & Murty 1962; reference elements.py:351-369).
    mu = n_before/n_after; mu == -1 reflects, mu == 1 passes through;
    total internal reflection produces NaN."""
    r = surface_normal(y, curvature, conic, aspherics, aspherics_odd,
                       xy_poly)
    r2 = torch.square(r).sum(-1)
    mu, = _scalars(y, mu)
    muf = torch.abs(mu)
    a = muf*(u0*r).sum(-1)/r2
    u_refl = u0 - 2*a[..., None]*r
    b = (mu**2 - 1)/r2
    disc = torch.square(a) - b
    g = -a + torch.sign(mu)*_sqrt0(disc)
    u_refr = muf*u0 + g[..., None]*r
    u_refr = torch.where(disc[..., None] < 0, float("nan"), u_refr)
    u = torch.where(mu == -1, u_refl, u_refr)
    return torch.where(mu == 1, u0, u)


def clip_aperture(y, u, radius):
    """NaN the direction of rays outside the aperture
    (reference elements.py:207)."""
    good = torch.square(y[..., :2]).sum(-1) <= radius**2
    return torch.where(good[..., None], u, float("nan"))
