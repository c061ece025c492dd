"""Component-form (structure-of-arrays) trace math on torch tensors.

Rays are carried as six separate (N,) component tensors (x, y, z, ux,
uy, uz); every operation below is an elementwise expression over them.
Surface parameters are 0-d tensors (one row of a SurfaceTable), so a
step broadcasts them against the bundle.

This is the counterpart of the JAX package's rayopt_tpu.ops.kernels,
operation for operation, so the two agree to rounding in float64.  The
port covers flat, spherical and conic rows (rotated, off-axis,
passthrough, refracting and mirror rows, aperture clip).  The extended
vocabulary (even/odd aspherics with their Newton intercepts, biconic,
toroid, cylinder, grating, DOE and freeform rows) is not ported yet:
a row that needs it raises NotImplementedError.

NaN marks a vignetted or missed ray.  `_sqrt0` clamps negative
arguments to 0 but lets NaN through, and every miss is set to NaN
explicitly, as in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

NAN = float("nan")


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


def normal_radial(x, y, c, k):
    """The radial factor e of the conic normal (nx, ny, nz) =
    (x*e, y*e, 1) (reference elements.py:457)."""
    r2 = x*x + y*y
    return -c/_sqrt0(1 - (1 + k)*c*c*r2)


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


def refract(x, y, ux, uy, uz, mu, c, k):
    """Vector Snell / mirror reflection on components at a conic
    (reference elements.py:351): mu == -1 reflects, mu == 1 passes."""
    e = normal_radial(x, y, c, k)
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


#: SurfaceSpec flags of the extended vocabulary, not ported yet
EXTENDED = ("aspheric", "odd", "biconic", "toroidal", "grating", "doe",
            "freeform", "cyl_axis")


def check_supported(spec, j=None):
    """Raise NotImplementedError for a row that needs the extended
    surface vocabulary."""
    used = [f for f in EXTENDED if getattr(spec, f)]
    if used:
        raise NotImplementedError(
            "surface row %s uses %s, which rayopt_tpu_torch does not "
            "trace yet (flat, spherical and conic rows only)"
            % ("?" if j is None else j, "/".join(used)))


def require_conic(table):
    """Raise NotImplementedError when the generic (spec-free) trace
    would need the extended vocabulary for some row of `table`."""
    from .tables import is_anamorphic
    figured = any(f is not None and f.numel() and bool(torch.any(f != 0))
                  for f in (table.aspherics, table.aspherics_odd))
    if figured or is_anamorphic(table):
        raise NotImplementedError(
            "the table has aspheric or extended-vocabulary rows, which "
            "rayopt_tpu_torch does not trace yet")


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


def refract_spec(x, y, z, ux, uy, uz, mu, c, k, spec):
    """Specialized Snell/mirror refraction at the on-surface point
    (x, y, z local) of a flat, spherical or conic row."""
    if spec.kind == 0:
        return ux, uy, uz
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


def surface_step_spec(state, surf, spec, clip):
    """Specialized transfer-intercept-refract step (same semantics as
    surface_step; static branches from SurfaceSpec).  Returns
    (next_state, ((x1, y1, z1), (ux1, uy1, uz1), (ux, uy, uz), topt))
    with the local outputs in the surface-normal frame."""
    check_supported(spec)
    x, y, z, ux, uy, uz = state
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
    if spec.rotated:
        r = surf.rot
        x, y, z = rot_apply(r, x, y, z)
        ux, uy, uz = rot_apply(r, ux, uy, uz)
    t = intercept_spec(x, y, z, ux, uy, uz, surf.curvature, surf.conic,
                       spec)
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
    ux1, uy1, uz1 = refract_spec(x1, y1, z1, ux0, uy0, uz0, surf.mu,
                                 surf.curvature, surf.conic, spec)
    out = ((x1, y1, z1), (ux1, uy1, uz1), (ux, uy, uz), topt)
    if spec.rotated:
        r = surf.rot
        nstate = (*rot_apply_t(r, x1, y1, z1),
                  *rot_apply_t(r, ux1, uy1, uz1))
    else:
        nstate = (x1, y1, z1, ux1, uy1, uz1)
    return nstate, out


def surface_step(state, surf, clip):
    """One generic transfer-intercept-refract step on component state
    (x, y, z, ux, uy, uz): every row is rotated, intercepted by the
    general conic and refracted with the radial normal, with no
    static specialization.  Returns (next_state, local_outputs) with
    the per-surface (y, u, i, t) in the surface-normal frame
    (reference system.py:459-464).  Callers check the table with
    `require_conic` first."""
    x, y, z, ux, uy, uz = state
    ox, oy, oz = surf.offset[0], surf.offset[1], surf.offset[2]
    r = surf.rot
    x, y, z = rot_apply(r, x - ox, y - oy, z - oz)
    ix, iy, iz = rot_apply(r, ux, uy, uz)
    t = intercept_conic(x, y, z, ix, iy, iz, surf.curvature, surf.conic,
                        surf.alternate)
    x1, y1, z1 = x + t*ix, y + t*iy, z + t*iz
    ux0, uy0, uz0 = ix, iy, iz
    if clip:
        bad = x1*x1 + y1*y1 > surf.radius*surf.radius
        ux0 = torch.where(bad, NAN, ux0)
        uy0 = torch.where(bad, NAN, uy0)
        uz0 = torch.where(bad, NAN, uz0)
    topt = t*surf.n_before
    ux1, uy1, uz1 = refract(x1, y1, ux0, uy0, uz0, surf.mu,
                            surf.curvature, surf.conic)
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
