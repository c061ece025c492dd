"""Surface kernels on (..., 3) tensors: sag, normal, intercept, Snell.

The single-surface oracle behind the Element methods (reference
elements.py:440-501 for the spheroid sag/normal and closed-form conic
intercept, elements.py:351-369 for vector Snell / reflection), written
as batched, NaN-safe torch functions: every branch is a `torch.where`
select, and a missed or totally reflected ray is NaN.

Conic surfaces only: an aspheric (or odd-aspheric, or freeform)
figure needs the Newton intercept, which is not ported yet and raises
NotImplementedError.
"""

import torch

from .kernels import _sqrt0


def _scalars(ref, *vals):
    """Surface parameters (floats or tensors) as tensors of ref's
    dtype and device."""
    return tuple(torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                 for v in vals)


def _require_conic(aspherics, aspherics_odd=None, xy_poly=None):
    for a in (aspherics, aspherics_odd, xy_poly):
        if a is not None and a.shape[-1] and bool(torch.any(a != 0)):
            raise NotImplementedError(
                "aspheric/freeform figures are not ported to "
                "rayopt_tpu_torch yet (conic surfaces only)")


def surface_sag(xyz, curvature, conic, aspherics, aspherics_odd=None,
                xy_poly=None):
    """Signed distance along z from the surface: z - sag(x, y)
    (reference elements.py:440)."""
    _require_conic(aspherics, aspherics_odd, xy_poly)
    r2 = torch.square(xyz[..., :2]).sum(-1)
    c, k = _scalars(xyz, curvature, conic)
    sq = _sqrt0(1 - (1 + k)*c**2*r2)
    return xyz[..., 2] - c*r2/(1 + sq)


def surface_normal(xyz, curvature, conic, aspherics,
                   aspherics_odd=None, xy_poly=None):
    """(Unnormalized) surface normal of the sag function, pointing +z
    (reference elements.py:457)."""
    _require_conic(aspherics, aspherics_odd, xy_poly)
    r2 = torch.square(xyz[..., :2]).sum(-1)
    c, k = _scalars(xyz, curvature, conic)
    e = -c/_sqrt0(1 - (1 + k)*c**2*r2)
    gx = xyz[..., 0]*e
    gy = xyz[..., 1]*e
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
              aspherics_odd=None, xy_poly=None):
    """Ray length from y along unit u to a conic surface."""
    _require_conic(aspherics, aspherics_odd, xy_poly)
    return intercept_conic(y, u, curvature, conic, alternate)


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
