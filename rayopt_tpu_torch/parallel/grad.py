"""Differentiable merit functions and gradient-based lens optimization.

The counterpart of the JAX package's rayopt_tpu.parallel.grad: the
merit is a function of the SurfaceTable's tensors, torch autograd
differentiates it, and a torch.optim optimizer drives the updates.
Two engines compute the spot-RMS merit:

* "xla" (the reference's name for its scan engine): autograd through
  the plain torch trace (ops.geometric.trace_rays_final), generic or
  specialized with `specs=`.  Full gradient semantics; its memory
  grows with rays x surfaces.
* "adjoint": ops.cuda_grad.adjoint_spot_rms -- the weighted-moment
  kernel (K4) forward and the analytic-adjoint kernel (K5) backward on
  a CUDA bundle, their plain versions on a CPU bundle.  No autograd
  residuals; specialized-engine gradient semantics.

Both take even- and odd-aspheric rows and the freeform XY rows, and
`select` may hold "aspherics", "aspherics_odd" and "xy_poly" (with
`scales`, one per coefficient column: `freeform_scales` for xy_poly);
the adjoint engine moves the coefficients of the rows that are figured
(or freeform) in the nominal table only.

The wavefront merits follow the same split: opd_rays/wavefront_rms
here are autograd through the plain trace's full history, and
ops.cuda_grad.adjoint_opd_rays/adjoint_wavefront_rms run the OPD
kernel (K8) forward and its adjoint (K9) backward; both take the
freeform XY rows too, so a composite merit of spot (K4/K5) and
wavefront (K8/K9) terms moves xy_poly through either engine.

Both engines move the pose too: `select` may hold "tilt" and
"decenter" (the alignment compensator), the adjoint engine then keeping
every row but the object's rotated and off axis (kernels.with_pose) so
that K5 differentiates the nominal pose through its rot key.

Not ported yet (each raises NotImplementedError naming its ROADMAP
item): ray sharding over a device mesh (`mesh`), checkpointed resume
(`checkpoint_dir`) and fused multi-step dispatch (`jit_steps`).
"""

import functools
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometric import trace_rays_final


def _not_ported(what, item):
    raise NotImplementedError(
        "%s is not ported to rayopt_tpu_torch yet (ROADMAP Queue 1 item "
        "%s)" % (what, item))


def _detached(table):
    return type(table)(*(None if f is None else f.detach() for f in table))


def spot_rms(table, y0, u0, w=None, clip=False, nan_safe=True,
             biconic=False, specs=None):
    """Weighted RMS spot radius at the last surface.

    Vignetted/missed rays become NaN in the trace; masking their
    weight is not enough for reverse-mode autograd (a NaN primal
    anywhere in a ray's chain yields NaN * 0 = NaN cotangents), so
    with nan_safe a no-grad pre-trace finds the surviving rays and
    each dead one is replaced by the first surviving ray at zero
    weight before the differentiated trace runs.  biconic: the generic
    walk's anamorphic step (without specs; set it for an anamorphic
    table, ops.tables.is_anamorphic)."""
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    if w is None:
        w = torch.ones(y0.shape[0], dtype=y0.dtype,
                       device=y0.device)/y0.shape[0]
    else:
        w = torch.as_tensor(w).to(device=y0.device, dtype=y0.dtype)
    if nan_safe:
        with torch.no_grad():
            yp, up, _ = trace_rays_final(_detached(table), y0, u0,
                                         clip=clip, specs=specs,
                                         biconic=biconic)
            # the final u matters too: a clip at the image surface NaNs
            # u after y was already computed
            alive = (torch.isfinite(yp[:, :2]).all(1)
                     & torch.isfinite(up).all(1))
            i0 = int(torch.argmax(alive.to(torch.uint8)))
        y0 = torch.where(alive[:, None], y0, y0[i0])
        u0 = torch.where(alive[:, None], u0, u0[i0])
        w = torch.where(alive, w, 0.)
    y, u, t = trace_rays_final(table, y0, u0, clip=clip, specs=specs,
                               biconic=biconic)
    pt = y[:, :2]
    good = torch.isfinite(pt).all(1)
    wg = torch.where(good, w, 0.)
    pt = torch.where(good[:, None], pt, 0.)
    wsum = wg.sum()
    mean = (wg[:, None]*pt).sum(0)/wsum
    r2 = (wg*torch.square(pt - mean).sum(1)).sum()/wsum
    return torch.sqrt(r2 + 1e-30)


def _bundle_table(table, bundle):
    """(table with the bundle's wavelength overrides, y0, u0, w); the
    overrides follow the table's device."""
    if len(bundle) == 4:
        y0, u0, w, chroma = bundle
        overrides = {k: v.to(device=table.curvature.device)
                     for k, v in chroma.items() if k != "wavelength"}
        return table.replace(**overrides), y0, u0, w
    y0, u0, w = bundle
    return table, y0, u0, w


def trace_rms_merit(table, bundles, mesh=None, axis="rays",
                    biconic=False):
    """Sum of weighted spot RMS over several bundles: (y0, u0, w) or
    (y0, u0, w, chroma) with chroma a dict of per-wavelength table
    field overrides (mu/n_before/n_after)."""
    if mesh is not None:
        _not_ported("trace_rms_merit(mesh=...) (ray sharding)", 16)
    total = 0.
    for bundle in bundles:
        tab, y0, u0, w = _bundle_table(table, bundle)
        total = total + spot_rms(tab, y0, u0, w, biconic=biconic)
    return total


#: table field -> element attribute for writing optimized values back
_WRITE_BACK = {"curvature": "curvature", "conic": "conic",
               "distance": "distance"}


def write_back_table(system, table, select):
    """Write the selected optimized table fields back into the
    System's elements.  curvature/conic/distance map to single element
    attributes; optimized pose deltas (tilt/decenter) are composed
    with each element's baked pose and written back via
    elements.set_pose.  Other table fields warn.  Runs update()."""
    def host(f):
        return getattr(table, f).detach().cpu().double().numpy()
    arrays = {k: host(k) for k in select if k in _WRITE_BACK}
    pose = [k for k in select if k in ("tilt", "decenter")]
    skipped = [k for k in select
               if k not in _WRITE_BACK and k not in pose]
    if skipped:
        warnings.warn("optimized fields not written back to the "
                      "System (no element attribute): %s" % skipped)
    for j, e in enumerate(system):
        for field, vals in arrays.items():
            attr = _WRITE_BACK[field]
            if hasattr(e, attr):
                setattr(e, attr, float(vals[j]))
    if pose:
        from ..ops.tables import rodrigues
        from ..elements import set_pose
        tilt, dec = host("tilt"), host("decenter")
        rot, off = host("rot"), host("offset")
        for j, e in enumerate(system):
            dt = tilt[j] if "tilt" in pose else np.zeros(3)
            dd = dec[j] if "decenter" in pose else np.zeros(3)
            if not (np.any(dt) or np.any(dd)):
                continue
            r = rodrigues(torch.from_numpy(dt)).numpy()
            set_pose(e, off[j] + dd, r @ rot[j])
    system.update()


def paraxial_seed(system):
    """(y0, u0) marginal/chief paraxial seeds of a System, for the
    differentiable first-order merit."""
    p = system.paraxial
    return np.asarray(p.y[0]), np.asarray(p.u[0])


def first_order_penalty(table, seed, targets, weights=None):
    """Weighted quadratic penalty on differentiable first-order
    properties (ops.paraxial.first_order).  seed: (y0, u0) from
    paraxial_seed; targets: dict mapping a property name -- e.g.
    "focal_length", "pupil_distance", "pupil_height", "lagrange" --
    to (index, value) for per-end properties or a bare value for
    scalars."""
    from ..ops.paraxial import first_order
    y0, u0 = seed
    props = first_order(table, y0, u0)
    total = 0.
    for name, want in targets.items():
        got = props[name]
        if isinstance(want, tuple):
            idx, value = want
            got = got[idx]
        else:
            value = want
        w = 1. if weights is None else weights.get(name, 1.)
        total = total + w*torch.square(got - value)
    return total


def composite_merit(*parts):
    """Sum of merit callables table -> scalar (e.g. spot RMS bundles
    plus first-order penalties)."""
    def merit(table):
        return sum(part(table) for part in parts)
    return merit


def opd_rays(table, y0, u0, ref=0, radius=None, wavelength=None,
             scale=1e-3, finite=False, sphere_offset=None,
             with_pupil=False, biconic=False, specs=None):
    """Per-ray optical path difference on the exit-pupil reference
    sphere, in waves -- the differentiable torch mirror of
    GeometricTrace.opd without the grid resample (the "xla" engine:
    autograd through the plain trace with its full history).

    radius: reference-sphere radius (e.g. -image.pupil.distance);
    sphere_offset: optional override for the lab-frame step from the
    second-to-last surface to the image surface (a scalar axial
    distance; defaults to the table's own offset, which also covers
    decentered ends).  Tilted/decentered end elements are handled
    exactly: the rays at the exit surface are rotated out of its normal
    frame, shifted by the lab-frame gap and rotated into the image
    surface's normal frame before the sphere intercept.  with_pupil
    also returns the ref-centred landing coordinates (N, 2) on the
    sphere."""
    from ..ops.geometric import trace_rays
    from ..ops.surfaces import intercept_conic
    from ..ops.tables import lower_pose
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    # fold pose deltas here too: the exit/image frame reads below must
    # see the same tilt/decenter the trace used
    table = lower_pose(table).to(device=y0.device, dtype=y0.dtype)
    y, u, i, t = trace_rays(table, y0, u0, specs=specs, biconic=biconic)
    tsum = (t[:-1] - t[:-1, ref][:, None]).sum(0)
    if not finite:
        # input reference is a plane normal to the chief ray
        tj = (u0[ref]*(y0[ref] - y0)).sum(-1)
        tsum = tsum - tj*table.n_before[0]
    if sphere_offset is None:
        gap = -table.offset[-1]
        if specs is not None and not specs[-1].off_axis:
            # the specialized trace baked out the image row's transverse
            # offset; the gap must see the same geometry
            gap = gap*torch.tensor([0., 0., 1.], dtype=gap.dtype,
                                   device=gap.device)
    else:
        sphere_offset = torch.as_tensor(sphere_offset).to(y)
        gap = -torch.cat([torch.zeros(2, dtype=y.dtype, device=y.device),
                          sphere_offset.reshape(1)])
    # exit-surface normal frame -> lab frame -> image normal frame
    rot_exit, rot_image = table.rot[-2], table.rot[-1]
    ya = (y[-2] @ rot_exit + gap) @ rot_image.T - y[-1, ref]
    ua = (u[-2] @ rot_exit) @ rot_image.T
    ya = ya + ya.new_tensor([0., 0., float(radius)])
    ti = intercept_conic(ya, ua, 1./radius, 0.*radius, 0.)
    tsum = tsum + (ti - ti[ref])*table.n_before[-1]
    waves = -tsum/(wavelength/scale)
    if not with_pupil:
        return waves
    # transverse landing coordinates on the reference sphere, centred on
    # the reference ray (the host opd's x, y)
    landing = ya + ti[:, None]*ua
    landing = landing - landing[ref]
    return waves, landing[:, :2]


def wavefront_rms(table, y0, u0, w=None, ref=0, radius=None,
                  wavelength=None, scale=1e-3, finite=False, biconic=False,
                  specs=None):
    """Weighted RMS wavefront error (waves, piston removed) -- a
    differentiable wavefront merit.  Pass specs for the statically
    specialized engine (the parity twin of
    ops.cuda_grad.adjoint_wavefront_rms, which shares its baked-out
    gradient semantics)."""
    from ..ops.cuda_grad import wavefront_rms_of
    opd = opd_rays(table, y0, u0, ref=ref, radius=radius,
                   wavelength=wavelength, scale=scale, finite=finite,
                   biconic=biconic, specs=specs)
    return wavefront_rms_of(opd, w)


def _device_pupils(system, fields, wavelength, device=None):
    """All-field pupil solve at once on `device` (System.pupils over
    ops.aiming: finite/infinite conjugates, all projections, residual-
    checked with host fallback)."""
    return system.pupils([(0., h) for h in fields], l=wavelength,
                         device=device)


def bundles_from_system(system, fields=None, wavelengths=None,
                        nrays=32, distribution="radau",
                        device_aim=False, pad_to=None, device=None):
    """Aim one weighted ray bundle per (field, wavelength) through the
    system's pupils: the standard multi-configuration merit input.

    Each bundle is (y0 (N, 3), u0 (N, 3), w (N,), chroma), float64 on
    `device` (None: the default device); chroma carries the
    wavelength's mu/n_before/n_after table overrides and the
    wavelength.  The pupils are solved on the host per field, or with
    device_aim (aimed, non-telecentric pupils only, as the reference)
    for all fields at once on `device` (System.pupils); the seeds are
    constants of the merit.  pad_to: pad every bundle's ray count
    up to a multiple of this, repeating the first ray at zero weight
    (the kernels take any count; the option keeps the reference's
    bundle shapes)."""
    from ..utils.distributions import pupil_distribution
    if fields is None:
        fields = system.fields
    if wavelengths is None:
        wavelengths = system.wavelengths
    device = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
            device)
    ref, yp, w = pupil_distribution(distribution, nrays)
    if w is None:
        w = np.ones(yp.shape[0])/yp.shape[0]
    use_device = (device_aim and system.object.pupil.aim and
                  not system.object.pupil.telecentric)
    out = []
    for l in wavelengths:
        tab_l = system.table(l, device=device)
        chroma = {"mu": tab_l.mu, "n_before": tab_l.n_before,
                  "n_after": tab_l.n_after, "wavelength": l}
        if use_device:
            zs, boxes = _device_pupils(system, fields, l, device)
        for i, h in enumerate(fields):
            if use_device:
                z, p = zs[i], boxes[i]
            else:
                z, p = system.pupil((0, h), l=l)
            y0, u0 = system.aim((0, h), yp, z, p, filter=False)
            wb = w
            if pad_to and y0.shape[0] % pad_to:
                pad = pad_to - y0.shape[0] % pad_to
                y0 = np.concatenate([y0, np.repeat(y0[:1], pad, 0)])
                u0 = np.concatenate([u0, np.repeat(u0[:1], pad, 0)])
                wb = np.concatenate([w, np.zeros(pad)])
            out.append((tensor(y0), tensor(u0), tensor(wb), chroma))
    return out


def bundles_from_numpy(bundles, device=None, dtype=torch.float64):
    """The port's bundles from any (y0, u0, w[, chroma]) bundles whose
    arrays are array-likes (e.g. the JAX package's
    bundles_from_system): tensors on `device` (None: the default
    device) in `dtype`; a chroma dict keeps its wavelength as a
    float."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)
    out = []
    for bundle in bundles:
        conv = [tensor(a) for a in bundle[:3]]
        if len(bundle) == 4:
            conv.append({k: (float(v) if k == "wavelength" else tensor(v))
                         for k, v in bundle[3].items()})
        out.append(tuple(conv))
    return out


def bundles_to(bundles, device=None, dtype=None):
    """The same bundles with their ray tensors on another device and/or
    dtype (the chroma overrides follow the table they are applied
    to)."""
    return [tuple(a.to(device=device, dtype=dtype) for a in b[:3])
            + tuple(b[3:]) for b in bundles]


def optimize_system(system, select=("curvature",), fields=None,
                    wavelengths=None, nrays=32, steps=100, lr=None,
                    cycles=1, device=None, **kw):
    """End-to-end differentiable lens optimization on a System: lower
    to the table, minimize summed weighted spot RMS over fields x
    wavelengths with torch autograd and Adam (lr 1e-4 when lr is not
    given), and write the optimized values back into the elements.
    The table and the bundles live on `device` (None: the default
    device).

    `cycles` re-aims the pupils between optimization macro-cycles.
    Returns the merit history."""
    history = []
    for _ in range(cycles):
        bundles = bundles_from_system(system, fields, wavelengths, nrays,
                                      device=device)
        table = system.table(device=device)
        tab_opt, hist = optimize_grad(table, bundles, select=select,
                                      steps=steps, lr=lr or 1e-4, **kw)
        history.extend(hist.tolist())
        write_back_table(system, tab_opt, select)
    return np.asarray(history)


def _adjoint_merit(table, bundles, select):
    from ..ops.cuda_grad import adjoint_spot_rms
    from ..ops.kernels import specialize, with_pose
    specs = specialize(table)
    if any(k in select for k in ("tilt", "decenter")):
        # keep the nominal pose live in the static specialization, so
        # that the adjoint differentiates it (rot and the transverse
        # offset would otherwise bake out at zero tilt and decenter)
        specs = with_pose(specs)

    def merit(tab):
        total = 0.
        for bundle in bundles:
            t2, y0, u0, w0 = _bundle_table(tab, bundle)
            total = total + adjoint_spot_rms(t2, y0, u0, w0, specs=specs)
        return total
    return merit


def freeform_scales(system):
    """(S, KXY) preconditioning matrix for optimizing `xy_poly` (the JAX
    package's freeform_scales).  The table holds denormalized monomial
    coefficients c = A/R**d (A the normalized coefficient, d the total
    degree), so a degree-d column spans ~R**-d; optimize_grad stores
    params = value/scale, so the scale of a degree-d term is R**-d and
    the optimizer steps in the normalized A.  Rows without a freeform
    element scale by 1."""
    from ..ops.kernels import _xy_terms, xy_degree
    rows = [np.asarray(getattr(e, "_xy_arr", np.zeros(0))) for e in system]
    kxy = max((r.size for r in rows), default=0)
    if not kxy:
        return np.ones((len(system), 0))
    terms = _xy_terms(xy_degree(kxy))
    out = np.ones((len(system), kxy))
    for j, (e, r_j) in enumerate(zip(system, rows)):
        r = float(getattr(e, "norm_radius", 0.) or 0.)
        if r and r_j.size:
            out[j] = [r**-(i + k) for i, k in terms]
    return out


def optimize_grad(table, bundles, select=("curvature",), steps=100,
                  lr=1e-4, optimizer=None, merit=None, callback=None,
                  mesh=None, axis="rays", checkpoint_dir=None,
                  checkpoint_every=50, jit_steps=None, scales=None,
                  engine="xla"):
    """Gradient-descent lens optimization.

    table:     initial SurfaceTable (float64; its device holds the
               parameters)
    bundles:   list of (y0, u0, w[, chroma]) ray bundles defining the
               merit; put them on a CUDA device to run the kernels
    select:    which table fields are free variables
    optimizer: None (torch.optim.Adam(lr), optax's adam update) or a
               factory params_list -> torch.optim.Optimizer, e.g.
               functools.partial(torch.optim.SGD, lr=...)
    merit:     optional callable(table) -> scalar (defaults to summed
               spot RMS over the bundles)
    callback:  callable(i, value, params) after step i's update; each
               params[k].grad still holds step i's gradient
    scales:    optional per-field preconditioning: params are stored
               DIVIDED by their scale and multiplied back when writing
               the table
    engine:    "xla" (autograd through the plain torch trace) or
               "adjoint" (ops.cuda_grad.adjoint_spot_rms: K4/K5 on a
               CUDA bundle, specialized-engine gradient semantics from
               the nominal table's specs: "aspherics" and
               "aspherics_odd" move on its aspheric rows only, "xy_poly"
               on its freeform rows only; with "tilt" or "decenter" in
               select every row but the object's keeps its pose live,
               kernels.with_pose, and K5 differentiates the rotation).
               Ignored when `merit` is passed.

    `mesh`, `checkpoint_dir` and `jit_steps` are not ported yet and
    raise NotImplementedError.  Returns (optimized table, history of
    merit values)."""
    if mesh is not None:
        _not_ported("optimize_grad(mesh=...) (ray sharding)", 16)
    if checkpoint_dir is not None:
        _not_ported("optimize_grad(checkpoint_dir=...) (checkpointed "
                    "resume)", 6)
    if jit_steps:
        _not_ported("optimize_grad(jit_steps=...) (several steps a "
                    "dispatch, CUDA graphs)", 6)
    if engine not in ("xla", "adjoint"):
        raise ValueError("engine must be 'xla' or 'adjoint', got %r"
                         % (engine,))
    if merit is None and engine == "adjoint":
        merit = _adjoint_merit(table, bundles, select)
    elif merit is None:
        from ..ops.tables import is_anamorphic
        merit = functools.partial(trace_rms_merit, bundles=bundles,
                                  biconic=is_anamorphic(table))

    scales = {k: torch.as_tensor(v, dtype=table.dtype,
                                 device=table.device)
              for k, v in (scales or {}).items()}
    params = {k: (getattr(table, k).detach()/scales.get(k, 1.)).clone()
              .requires_grad_() for k in select}
    # distance is a derived length; the trace consumes offset, so tie
    # offset = unit_direction * distance when distance is optimized
    off = table.offset.detach().cpu().double().numpy()
    d0 = table.distance.detach().cpu().double().numpy()
    unit = np.divide(off, d0[:, None], where=d0[:, None] != 0,
                     out=np.tile(np.array([0., 0., 1.]),
                                 (off.shape[0], 1)))
    unit = torch.as_tensor(unit, dtype=table.dtype, device=table.device)

    def loss(params):
        tab = table.replace(**{k: v*scales.get(k, 1.)
                               for k, v in params.items()})
        if "distance" in params:
            tab = tab.replace(offset=unit*params["distance"][:, None])
        return merit(tab)

    plist = list(params.values())
    if optimizer is None:
        opt = torch.optim.Adam(plist, lr=lr)
    else:
        opt = optimizer(plist)
    history = []
    for i in range(steps):
        opt.zero_grad()
        value = loss(params)
        value.backward()
        opt.step()
        history.append(float(value.detach()))
        if callback:
            callback(i, value.detach(), params)
    final = {k: v.detach()*scales.get(k, 1.) for k, v in params.items()}
    if "distance" in final:
        final["offset"] = unit*final["distance"][:, None]
    return table.replace(**final), np.asarray(history)
