"""Batched pupil aiming on the table's device, as plain torch ops.

The counterpart of the JAX package's rayopt_tpu.ops.aiming.  The
host aims one field point at a time with scipy's newton/brentq
(aiming.AimingMixin.pupil).  Here the chief-ray solve is a
fixed-trip-count Newton whose derivative comes from torch.autograd
through the trace itself, for every field point at once (each field's
stop height depends on its own pupil distance only, so one backward of
their sum gives every derivative), and the marginal solve is a
bracketed bisection with NaN (= vignetted/missed) treated as outside.
The host path remains for API parity and as the oracle.

Covers finite and infinite conjugates, all five wide-angle field
projections (conjugates.PROJECTIONS), the stop-edge merit and the rim
(stop=-1) vignetting merit over all interior surfaces, with residual
outputs so callers can bound convergence instead of trusting a fixed
iteration count.

The loops never wait on the host: fixed trip counts, torch.where for
every guard, and no .item(), bool(tensor) or nonzero inside them.  The
table's check that reads it on the host (the pose lowering) runs once
before them (`_prepared`).  Each merit is a trace through the plain
ops.geometric engine, in the table's dtype on its device (an aspheric
or freeform row by its fixed-count Newton): on a CUDA table a few
hundred small launches.

Field coordinates: `field` is (F, 2) fractional object coordinates.
For the infinite conjugate pass `slope=tan(object.angle)` (or
`angle=`); `slope=None` keeps the legacy meaning "field values are
already tangents" (rectilinear only).  For the finite conjugate pass
`radius=object.radius`.
"""

import math

import torch

from . import kernels as K
from .geometric import trace_components_final, trace_rays
from .surfaces import surface_sag
from .tables import lower_pose

#: the table fields the loops never read once `_prepared` folded them
#: (the aspheric coefficients, the anamorphic columns, grating_dy, doe
#: and xy_poly stay: the traces read them on the device, and tests only
#: their static widths)
_CHECKED = ("tilt", "decenter")


def _prepared(table):
    """The table detached and its pose folded, once, here: the fields
    the pose lowering reads become None, so that the loops' traces and
    sags read nothing back to the host.  Every row the port traces is
    let through, the freeform rows included, in stop and in rim mode.
    Idempotent."""
    table = lower_pose(type(table)(*(None if f is None else f.detach()
                                     for f in table)))
    return table.replace(**dict.fromkeys(_CHECKED))


def _field(field, table):
    return torch.as_tensor(field, dtype=table.dtype, device=table.device)


def _like(v, ref):
    """v (a scalar or array-like) as a tensor broadcast to ref's shape."""
    return torch.as_tensor(v, dtype=ref.dtype,
                           device=ref.device).expand_as(ref)


def _slope(slope, ref):
    """The field slope on ref's device before the loops (a wide-angle
    projection takes its arctan there), or None."""
    return None if slope is None else torch.as_tensor(
        slope, dtype=ref.dtype, device=ref.device)


# -- field projections, torch twins of conjugates.PROJECTIONS ------------

def _dir_rectilinear(fx, fy):
    # fx, fy are tangents here
    nrm = torch.rsqrt(fx*fx + fy*fy + 1.)
    return fx*nrm, fy*nrm, nrm


def _dir_stereographic(fx, fy, angle):
    vx = fx*2*torch.tan(angle/2)
    vy = fy*2*torch.tan(angle/2)
    r = (vx*vx + vy*vy)/4
    return vx/(r + 1), vy/(r + 1), (1 - r)/(r + 1)


def _dir_equisolid(fx, fy, angle):
    vx = fx*2*torch.sin(angle/2)
    vy = fy*2*torch.sin(angle/2)
    r = vx*vx + vy*vy
    g = torch.sqrt(torch.clamp(1 - r/4, min=0.))
    return vx*g, vy*g, 1 - r/2


def _dir_orthographic(fx, fy, angle):
    vx = fx*torch.sin(angle)
    vy = fy*torch.sin(angle)
    r = vx*vx + vy*vy
    return vx, vy, torch.sqrt(torch.clamp(1 - r, min=0.))


def _dir_equidistant(fx, fy, angle):
    ax, ay = fx*angle, fy*angle
    backward = ax*ax + ay*ay > (math.pi/2)**2
    vx, vy = torch.sin(ax), torch.sin(ay)
    vz = torch.sqrt(torch.clamp(1 - vx*vx - vy*vy, min=0.))
    return vx, vy, torch.where(backward, -vz, vz)


def _field_direction(fx, fy, slope, projection):
    """Unit field direction for fractional field (fx, fy).

    slope=None: rectilinear with (fx, fy) already tangents (legacy).
    Otherwise slope = tan(semi-angle) and angle = arctan(slope)."""
    if projection == "rectilinear":
        if slope is not None:
            fx, fy = fx*slope, fy*slope
        return _dir_rectilinear(fx, fy)
    angle = torch.atan(torch.as_tensor(slope, dtype=fx.dtype,
                                       device=fx.device))
    fn = {"stereographic": _dir_stereographic,
          "equisolid": _dir_equisolid,
          "orthographic": _dir_orthographic,
          "equidistant": _dir_equidistant}[projection]
    return fn(fx, fy, angle)


def _sm_frame(ux, uy, uz, zsign=1.):
    """Sagittal/meridional unit frame of direction u against the
    (0, 0, zsign) axis (torch twin of utils.math.sagittal_meridional)."""
    sx, sy = uy*zsign, -ux*zsign
    sn = torch.sqrt(sx*sx + sy*sy)
    axial = sn < 1e-12
    den = torch.where(axial, 1., sn)
    sx = torch.where(axial, 1., sx/den)
    sy = torch.where(axial, 0., sy/den)
    mx = -uz*sy
    my = uz*sx
    mz = ux*sy - uy*sx
    mn = torch.sqrt(mx*mx + my*my + mz*mz)
    return sx, sy, (mx/mn, my/mn, mz/mn)


# -- ray seeds (torch twins of Conjugate.aim) -----------------------------

def _seed_infinite(fx, fy, z, px, py, scale, slope, projection):
    """Infinite-conjugate candidate: field direction from the
    projection, origin back-projected from the pupil plane, offset by
    scale*(px, py) in the sagittal/meridional frame
    (reference conjugates.py:236-255)."""
    ux, uy, uz = _field_direction(fx, fy, slope, projection)
    sx, sy, (mx, my, mz) = _sm_frame(ux, uy, uz)
    ox = -z*ux + scale*(px*sx + py*mx)
    oy = -z*uy + scale*(px*sy + py*my)
    oz = z - z*uz + scale*(py*mz)
    return (ox, oy, oz, ux, uy, uz)


def _seed_finite(table, fx, fy, z, px, py, scale, radius):
    """Finite-conjugate candidate: origin on the (possibly curved)
    object surface at -field*radius, direction at the axial pupil
    point, tilted by scale*(px, py) in the pupil plane
    (reference conjugates.py:137-166).  The object surface is a conic
    with even/odd aspheric figure (its freeform figure is not read, as
    in the reference)."""
    ox = -fx*radius
    oy = -fy*radius
    pos = torch.stack([ox, oy, torch.zeros_like(ox)], -1)
    oz = -surface_sag(pos, table.curvature[0], table.conic[0],
                      *(None if f is None else f[0]
                        for f in (table.aspherics, table.aspherics_odd)))
    ux = -ox
    uy = -oy
    uz = z - oz
    zsign = torch.sign(z)
    sx, sy, (mx, my, mz) = _sm_frame(ux, uy, uz, zsign)
    ux = ux + scale*(px*sx + py*mx)
    uy = uy + scale*(px*sy + py*my)
    uz = uz + scale*(py*mz)
    nrm = torch.rsqrt(ux*ux + uy*uy + uz*uz)*zsign
    return (ox, oy, oz, ux*nrm, uy*nrm, uz*nrm)


def _seed(table, fx, fy, z, px, py, scale, slope, radius, finite,
          projection):
    if finite:
        return _seed_finite(table, fx, fy, z, px, py, scale, radius)
    return _seed_infinite(fx, fy, z, px, py, scale, slope, projection)


# -- merits ---------------------------------------------------------------

def _stop_height(table, specs, stop, fx, fy, z, slope=None, radius=0.,
                 finite=False, projection="rectilinear"):
    """Signed fractional chief-ray height at the stop along the field
    direction (the aim_chief merit, reference system.py:519-524)."""
    sub = table.rows(0, stop + 1)
    zero = torch.zeros_like(fx)
    state = _seed(sub, fx, fy, z, zero, zero, zero, slope, radius,
                  finite, projection)
    out, t = trace_components_final(
        sub, state, specs=specs[:stop + 1] if specs else None)
    rad = table.radius[stop]
    return (fx*out[0] + fy*out[1])/rad


def _clearance(table, specs, stop, fx, fy, z, px, py, scale, r2,
               slope=None, radius=0., finite=False,
               projection="rectilinear", rim=False):
    """Edge-clearance merit of the marginal candidate: fractional
    squared height minus one at the stop, or its max over all interior
    surfaces in rim mode (reference system.py:542-552); NaN (missed a
    surface) counts as fully outside."""
    state = _seed(table, fx, fy, z, px, py, scale, slope, radius,
                  finite, projection)
    if rim:
        y0 = torch.stack(state[:3], -1)
        u0 = torch.stack(state[3:], -1)
        # anamorphic, grating and DOE rows need the general walk's
        # anamorphic step (specs are static: a branch on the host)
        ext = bool(specs) and any(K.is_anamorphic_spec(s) or K.is_phase(s)
                                  for s in specs)
        ys = trace_rays(table, y0, u0, biconic=ext)[0]
        h2 = torch.square(ys[1:-1, :, :2]).sum(-1)
        d = h2/torch.square(table.radius[1:-1])[:, None] - 1.
        d = torch.where(torch.isfinite(d), d, 1.)
        return d.amax(0)
    sub = table.rows(0, stop + 1)
    out, t = trace_components_final(
        sub, state, specs=specs[:stop + 1] if specs else None)
    d = (out[0]**2 + out[1]**2)/r2 - 1.
    return torch.where(torch.isfinite(d), d, 1.)


# -- solvers ---------------------------------------------------------------

def aim_chief_batched(table, field, z0, stop, specs=None, iters=12,
                      slope=None, radius=0., finite=False,
                      projection="rectilinear", with_residual=False):
    """Solve the chief-ray pupil distance for a whole batch of field
    points in one fixed-trip-count Newton (derivative by torch.autograd
    through the trace), on the table's device.

    field: (F, 2) fractional field coordinates (legacy: rectilinear
    tangents when slope is None); z0: scalar initial pupil distance.
    Returns (F,) solved distances, plus the (F,) final merit residuals
    when with_residual is set.
    """
    table = _prepared(table)
    field = _field(field, table)
    fx = field[:, 0]
    fy = field[:, 1]
    slope = _slope(slope, fx)

    def merit(z):
        return _stop_height(table, specs, stop, fx, fy, z, slope, radius,
                            finite, projection)

    z = _like(z0, fx).clone()
    with torch.enable_grad():
        for _ in range(iters):
            z = z.detach().requires_grad_()
            f = merit(z)
            # each field's f depends on its own z only: d(sum f)/dz is
            # every field's derivative
            df, = torch.autograd.grad(f.sum(), z)
            df = torch.where(df.abs() < 1e-30, 1., df)
            step = f.detach()/df
            # guard NaN (ray missed): keep the current iterate
            step = torch.where(torch.isfinite(step), step, 0.)
            z = z.detach() - step
    if not with_residual:
        return z
    with torch.no_grad():
        resid = merit(z)
    return z, resid.abs()


@torch.no_grad()
def aim_marginal_batched(table, field, z, p0, stop, specs=None,
                         direction=(0., 1.), grow_iters=30,
                         bisect_iters=40, slope=None, radius=0.,
                         finite=False, projection="rectilinear",
                         rim=False, with_residual=False):
    """Batched marginal-ray solve on the table's device: for every
    field point find the pupil-scale a such that the ray aimed at a*p0
    along `direction` just fills the limiting aperture (the stop, or in
    rim mode the tightest of all interior surfaces), by monotone
    bracketing + bisection with NaN (= vignetted/missed) treated as
    outside.  Returns (F,) scales a*p0, plus the (F,) final bracket
    half-widths (relative) when with_residual is set.
    """
    table = _prepared(table)
    field = _field(field, table)
    fx = field[:, 0]
    fy = field[:, 1]
    z = _like(z, fx)
    slope = _slope(slope, fx)
    px, py = direction
    r2 = table.radius[stop]**2
    ones = torch.ones_like(fx)

    def merit(a):
        return _clearance(table, specs, stop, fx, fy, z, px*ones, py*ones,
                          a*p0, r2, slope, radius, finite, projection, rim)

    # bracket: expand hi by the merit-proportional factor the host
    # solver uses (aiming.bracketed_edge_solve: b *= 1 - fb), so the
    # FIRST zero crossing is bracketed even when the clearance is
    # non-monotone (it dives again once rays start missing surfaces)
    lo = torch.zeros_like(fx)
    hi = ones
    for _ in range(grow_iters):
        f = merit(hi)
        still = f < 0
        lo = torch.where(still, hi, lo)
        hi = torch.where(still, hi*(1 - f), hi)
    for _ in range(bisect_iters):
        mid = (lo + hi)/2
        f = merit(mid)
        lo = torch.where(f < 0, mid, lo)
        hi = torch.where(f < 0, hi, mid)
    a = (lo + hi)/2
    if not with_residual:
        return a*p0
    return a*p0, (hi - lo)/torch.clamp(a, min=1e-30)


def pupil_batched(table, field, z0, p0, stop, specs=None, slope=None,
                  radius=0., finite=False, projection="rectilinear",
                  rim=False, with_residuals=False):
    """Full pupil solve for a batch of field points: chief-ray pupil
    distances plus the four-margin aperture boxes, all on the table's
    device (the batched counterpart of System._aim_pupil, reference
    system.py:557-583).

    Returns (z, boxes): z (F,), boxes (F, 2, 2) as
    [[-sag, -mer], [+sag, +mer]]; with_residuals additionally returns
    (chief residual (F,), max marginal bracket width (F,)).
    """
    table = _prepared(table)
    kw = dict(specs=specs, slope=slope, radius=radius, finite=finite,
              projection=projection)
    z = aim_chief_batched(table, field, z0, stop,
                          with_residual=with_residuals, **kw)
    if with_residuals:
        z, chief_resid = z
    margins = {}
    widths = []
    for name, direction in (("+mer", (0., 1.)), ("-mer", (0., -1.)),
                            ("+sag", (1., 0.)), ("-sag", (-1., 0.))):
        out = aim_marginal_batched(
            table, field, z, p0, stop, direction=direction, rim=rim,
            with_residual=with_residuals, **kw)
        if with_residuals:
            out, width = out
            widths.append(width)
        margins[name] = out
    boxes = torch.stack([
        torch.stack([-margins["-sag"], -margins["-mer"]], -1),
        torch.stack([margins["+sag"], margins["+mer"]], -1),
    ], -2)
    if with_residuals:
        return z, boxes, (chief_resid, torch.stack(widths).amax(0))
    return z, boxes
