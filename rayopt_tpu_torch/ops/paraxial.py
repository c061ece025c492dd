"""Differentiable paraxial (ABCD) engine on torch tensors.

The counterpart of the JAX package's rayopt_tpu.ops.paraxial: 4x4
tangential/sagittal block matrices per surface (Massey-Siegman
refraction), propagated surface by surface, plus the first-order
property set (focal length, pupils, Lagrange invariant) as functions
of the SurfaceTable that torch autograd differentiates.  The JAX
package's associative scan over at most a few dozen 4x4 matrices is a
plain product loop here.  Used by the differentiable optimizer when
first-order targets (EFL, pupil positions) enter the merit.
"""

import torch


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _mat4(rows):
    """(..., 4, 4) from a 4x4 nested list of broadcastable tensors."""
    shape = torch.broadcast_shapes(*(e.shape for r in rows for e in r))
    return torch.stack([torch.stack([e.expand(shape) for e in r], -1)
                        for r in rows], -2)


def surface_abcd(curvature, distance, n_before, n_after, mu, theta=0.,
                 aspheric0=0., doe0=0., curvature_dx=0., xy20=0.,
                 xy02=0.):
    """4x4 paraxial matrix for one surface (or a batch of surfaces,
    elementwise over equal-shape arguments): free propagation to the
    vertex followed by refraction/reflection.  State vector
    (y_sag, y_tan, nu_sag, nu_tan).  The arguments mean what they mean
    in the JAX package's surface_abcd."""
    c = torch.as_tensor(curvature)
    args = [_t(a, c) for a in (distance, n_before, n_after, mu, theta,
                               aspheric0, doe0, curvature_dx, xy20, xy02)]
    distance, n_before, n_after, mu, theta, asp0, doe0, cdx, xy20, xy02 = \
        args
    cy = c + 2*asp0 + 2*xy02
    cx = c + cdx + 2*asp0 + 2*xy20
    costheta = torch.cos(theta)
    is_mirror = mu == -1
    is_bare = mu == 1
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)

    # free propagation
    dn = distance/n_before
    md = _mat4([[one, zero, dn, zero], [zero, one, zero, dn],
                [zero, zero, one, zero], [zero, zero, zero, one]])

    # refraction
    nr = n_after/n_before
    p = torch.sqrt(torch.clamp(nr**2 + costheta**2 - 1, min=1e-30))
    doe_p = 2*n_after*doe0
    m11 = torch.where(is_mirror | is_bare, one, p/(nr*costheta))
    m20 = doe_p + torch.where(is_mirror, 2*cx*costheta,
                              torch.where(is_bare, zero,
                                          n_before*cx*(costheta - p)))
    m31 = doe_p + torch.where(is_mirror, 2*cy/costheta,
                              torch.where(is_bare, zero,
                                          nr*n_before*cy*(costheta - p)
                                          / (costheta*p)))
    m = _mat4([[one, zero, zero, zero], [zero, m11, zero, zero],
               [m20, zero, one, zero], [zero, m31, zero, 1/m11]])
    return m @ md


def abcd_matrices(table, theta=None):
    """(S, 4, 4) per-surface matrices for surfaces 1..S-1 (row 0 is the
    object surface and gets the identity)."""
    c = table.curvature
    s = c.shape[0]
    zeros = torch.zeros(s, dtype=c.dtype, device=c.device)
    theta = zeros if theta is None else theta

    def column(f, i):
        return f[:, i] if f is not None and f.shape[1] > i else zeros
    asp0 = column(table.aspherics, 0)
    doe0 = column(table.doe, 0)
    cdx = zeros if table.curvature_dx is None else table.curvature_dx
    xy = table.xy_poly
    if xy is not None and xy.shape[1] >= 5:
        xy20, xy02 = xy[:, 2], xy[:, 4]
    else:
        xy20 = xy02 = zeros
    m = surface_abcd(c, table.distance, table.n_before, table.n_after,
                     table.mu, theta, asp0, doe0, cdx, xy20, xy02)
    eye = torch.eye(4, dtype=m.dtype, device=m.device)
    return torch.cat([eye[None], m[1:]])


def abcd_product(table, start=1, stop=None):
    """Cumulative ABCD product over surfaces [start, stop)."""
    prod = None
    for mi in abcd_matrices(table)[start:stop]:
        prod = mi if prod is None else mi @ prod
    return prod


def paraxial_trace(table, y0, u0):
    """Propagate the (y, nu) x (marginal, chief) state through the
    system.  y0, u0: (2,) marginal/chief seed (heights, n*slopes).
    Returns y (S, 2), u (S, 2)."""
    m = abcd_matrices(table)
    y0 = _t(y0, m)
    u0 = _t(u0, m)
    yu = torch.stack([y0, y0, u0, u0])  # (4, 2): sag/tan x (y, nu)
    yus = [yu]
    for mi in m[1:]:
        yu = mi @ yu
        yus.append(yu)
    yus = torch.stack(yus)
    # tangential components (axis=1 of the host engine)
    return yus[:, 1, :], yus[:, 3, :]


def first_order(table, y0, u0):
    """First-order property dict (focal length, pupils, invariant) as
    differentiable functions of the table."""
    y, u = paraxial_trace(table, y0, u0)
    y0, u0 = _t(y0, y), _t(u0, y)
    n = table.n_after
    lagrange = u0[0]*y0[1] - u0[1]*y0[0]
    denom = u[0, 1]*u[-2, 0] - u[0, 0]*u[-2, 1]
    efl = lagrange/denom
    focal_length = torch.stack([-efl*n[-2], efl*n[0]])
    c = focal_length/lagrange/torch.stack([n[-2], n[0]])
    fd = torch.stack([y[1, 1]*u[-2, 0] - y[1, 0]*u[-2, 1],
                      y[-2, 1]*u[0, 0] - y[-2, 0]*u[0, 1]])*c
    yp = torch.stack([y[1], y[-2]])
    up = torch.stack([u[0], u[-2]])
    nn = torch.stack([n[0], n[-2]])
    pupil_distance = -yp[:, 1]/up[:, 1]*nn
    pupil_height = torch.abs(yp[:, 0] + pupil_distance*up[:, 0]/nn)
    return {
        "y": y, "u": u,
        "lagrange": lagrange,
        "focal_length": focal_length,
        "focal_distance": fd,
        "pupil_distance": pupil_distance,
        "pupil_height": pupil_height,
    }


def paraxial_solve_image(table, y0, u0):
    """Distance from the last surface to the paraxial image (the
    refocus solve)."""
    y, u = paraxial_trace(table, y0, u0)
    return -table.n_after[-2]*y[-2, 0]/u[-2, 0]
