"""Component-form (structure-of-arrays) trace math on torch tensors.

Rays are carried as six separate (N,) component tensors (x, y, z, ux,
uy, uz); every operation below is an elementwise expression over them.
Surface parameters are 0-d tensors (one row of a SurfaceTable), so a
step broadcasts them against the bundle.

This is the counterpart of the JAX package's rayopt_tpu.ops.kernels,
operation for operation, so the two agree to rounding in float64.  The
port covers the rotationally symmetric rows: flat, spherical, conic
and even/odd aspheric (rotated, off-axis, passthrough, refracting and
mirror rows, aperture clip).  An aspheric row is intercepted by a
fixed-count Newton seeded from the conic (`intercept`), differentiated
implicitly at the root (`_NewtonRoot`).  The rest of the extended
vocabulary (biconic, toroid, cylinder, grating, DOE and freeform rows,
ROADMAP Queue 1 item 9) is not ported yet: a row that needs it raises
NotImplementedError.

NaN marks a vignetted or missed ray.  `_sqrt0` clamps negative
arguments to 0 but lets NaN through, and every miss is set to NaN
explicitly, as in the JAX package.
"""

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


def _newton_residual(s, x, y, z, ux, uy, uz, c, k, asp, aspo):
    """Sag residual F(s) at distance s along the ray (the reference's
    "radial" kind: a conic plus even/odd aspheric figure)."""
    return sag(x + s*ux, y + s*uy, z + s*uz, c, k, asp, aspo)


def _newton_slope(s, x, y, z, ux, uy, uz, c, k, asp, aspo):
    """dF/ds = u . grad(z - sag) by the radial normal."""
    px, py = x + s*ux, y + s*uy
    e = normal_radial(px, py, c, k, asp, aspo)
    return ux*(px*e) + uy*(py*e) + uz


class _NewtonRoot(torch.autograd.Function):
    """Fixed-count Newton refinement of the intercept distance, the
    counterpart of the reference's `_newton_root` (a jax.custom_jvp).

    forward(seed, x, y, z, ux, uy, uz, c, k, asp, aspo, iters, tol):
    `iters` Newton steps from the seed (a zero slope steps by F), then
    a ray whose residual exceeds tol*(1 + |s|) (tol floored by
    _tol_for) becomes NaN.

    backward: the implicit-function theorem at the converged root,
    p_bar = -s_bar * dF/dp / F_s (one residual gradient), not the
    unrolled iterations: the derivative is that of the exact root,
    independent of the iteration path.  The seed gets no cotangent (as
    the reference's JVP ignores its tangent).  The backward is not
    itself differentiable: nested derivatives (the reference's
    aberration expansion, item 13) raise."""

    @staticmethod
    def forward(ctx, seed, x, y, z, ux, uy, uz, c, k, asp, aspo, iters,
                tol):
        args = (x, y, z, ux, uy, uz, c, k, asp, aspo)
        s = seed
        for _ in range(iters):
            fn = _newton_residual(s, *args)
            fp = _newton_slope(s, *args)
            fp = torch.where(fp == 0, 1., fp)
            s = s - fn/fp
        res = _newton_residual(s, *args)
        tol = _tol_for(s, tol)
        s = torch.where(torch.abs(res) <= tol*(1 + torch.abs(s)), s, NAN)
        ctx.save_for_backward(s, *args)
        return s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        s, *args = ctx.saved_tensors
        need = ctx.needs_input_grad[1:11]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() if nd else a.detach()
                      for a, nd in zip(args, need)]
            f = _newton_residual(s, *leaves)
            fs = _newton_slope(s, *(a.detach() for a in args))
            fs = torch.where(fs == 0, 1., fs)
            wanted = [a for a, nd in zip(leaves, need) if nd]
            grads = iter(torch.autograd.grad(f, wanted, -ct/fs,
                                             allow_unused=True)
                         if wanted else ())
        out = [None]
        for a, nd in zip(args, need):
            g = next(grads) if nd else None
            out.append(torch.zeros_like(a) if nd and g is None else g)
        return (*out, None, None)


def intercept(x, y, z, ux, uy, uz, c, k, aspherics, alternate,
              iters=ASPHERIC_ITERS, tol=ASPHERIC_TOL, aspherics_odd=None):
    """Ray length to a conic surface with even/odd aspheric figure: the
    closed conic root, refined by a fixed-count Newton on the exact
    sag when either coefficient table has a nonzero width (a static
    shape, as in the reference).  A ray whose conic seed misses a
    curved row stays NaN; so does a ray the Newton does not
    converge."""
    s = intercept_conic(x, y, z, ux, uy, uz, c, k, alternate)
    if not (_width(aspherics) or _width(aspherics_odd)):
        return s
    zeros = s.new_zeros((0,))
    asp = aspherics if aspherics is not None else zeros
    aspo = aspherics_odd if aspherics_odd is not None else zeros
    s0 = s
    x, y, z, ux, uy, uz = torch.broadcast_tensors(x, y, z, ux, uy, uz)
    s = _NewtonRoot.apply(s0, x, y, z, ux, uy, uz, c, k, asp, aspo,
                          iters, tol)
    return torch.where(torch.isnan(s0) & (c != 0), NAN, s)


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


#: where the extended vocabulary waits (its NotImplementedError says so)
ITEM9 = "ROADMAP Queue 1 item 9"
#: SurfaceSpec flags of the extended vocabulary, not ported yet
EXTENDED = ("biconic", "toroidal", "grating", "doe", "freeform", "cyl_axis")


def is_figured(spec):
    """True for an even- or odd-aspheric row (the Newton intercept)."""
    return bool(spec.aspheric or spec.odd)


def check_supported(spec, j=None, what="rayopt_tpu_torch"):
    """Raise NotImplementedError, naming ROADMAP Queue 1 item 9, for a
    row that needs the extended surface vocabulary (`what`: the engine
    or key that does not trace it)."""
    used = [f for f in EXTENDED if getattr(spec, f)]
    if used:
        raise NotImplementedError(
            "surface row %s uses %s, which %s does not trace yet (%s)"
            % ("?" if j is None else j, "/".join(used), what, ITEM9))


def require_radial(table):
    """Raise NotImplementedError (item 9) when the generic (spec-free)
    trace would need the extended vocabulary for some row of `table`:
    it traces the rotationally symmetric rows only (flat, spherical,
    conic and even/odd aspheric)."""
    from .tables import is_anamorphic
    if is_anamorphic(table):
        raise NotImplementedError(
            "the table has anamorphic, grating, DOE or freeform rows, "
            "which rayopt_tpu_torch does not trace yet (%s)" % ITEM9)


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
    if is_figured(spec):
        t = intercept(x, y, z, ux, uy, uz, surf.curvature, surf.conic,
                      surf.aspherics, surf.alternate,
                      aspherics_odd=surf.aspherics_odd)
    else:
        t = intercept_spec(x, y, z, ux, uy, uz, surf.curvature,
                           surf.conic, spec)
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
                                 surf.curvature, surf.conic, spec,
                                 surf.aspherics, surf.aspherics_odd)
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
    general conic (refined by the Newton on the exact sag when the
    table has aspheric columns of nonzero width, `intercept`) and
    refracted with the radial normal, with no static specialization.
    Returns (next_state, local_outputs) with the per-surface (y, u, i,
    t) in the surface-normal frame (reference system.py:459-464).
    Callers check the table with `require_radial` first."""
    x, y, z, ux, uy, uz = state
    ox, oy, oz = surf.offset[0], surf.offset[1], surf.offset[2]
    r = surf.rot
    x, y, z = rot_apply(r, x - ox, y - oy, z - oz)
    ix, iy, iz = rot_apply(r, ux, uy, uz)
    t = intercept(x, y, z, ix, iy, iz, surf.curvature, surf.conic,
                  surf.aspherics, surf.alternate,
                  aspherics_odd=surf.aspherics_odd)
    x1, y1, z1 = x + t*ix, y + t*iy, z + t*iz
    ux0, uy0, uz0 = ix, iy, iz
    if clip:
        bad = x1*x1 + y1*y1 > surf.radius*surf.radius
        ux0 = torch.where(bad, NAN, ux0)
        uy0 = torch.where(bad, NAN, uy0)
        uz0 = torch.where(bad, NAN, uz0)
    topt = t*surf.n_before
    ux1, uy1, uz1 = refract(x1, y1, ux0, uy0, uz0, surf.mu,
                            surf.curvature, surf.conic, surf.aspherics,
                            surf.aspherics_odd)
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
