"""The differentiable spot-RMS merit: weighted moments forward (K4) and
its analytic adjoint (K5) on CUDA, with their plain versions.

K4 `weighted_moments` traces six (N,) ray components through the
specialized surface chain and reduces them to the five WEIGHTED spot
moments (sum w, sum wx, sum wy, sum wx^2, sum wy^2) over the rays
whose final local x, y and uz are finite.  It replaces the JAX
package's Pallas kernel `pallas_grad._fwd_kernel`.

K5 `merit_adjoint` is its backward: it traces each ray again, keeping
the state that enters every surface, seeds the ray's cotangent from
the five moment cotangents, and runs a hand-derived reverse of
`kernels.surface_step_spec` over the rows from last to first.  It
returns the parameter cotangents (per row: curvature, conic, offset
x, y, z and mu; reduced over the rays), the six ray-state cotangents
and the weight cotangent.  It replaces `pallas_grad._adjoint_kernel`.
A dead (vignetted or missed) ray gets exact zeros everywhere; no VJP
residual ever leaves the kernel.

K6 `weighted_moments_multi` and K7 `merit_adjoint_multi` are their
polychromatic twins (`pallas_grad._fwd_kernel_multi`,
`_adjoint_kernel_multi`): a stacked table (leading wavelength axis,
System.tables or glass.glass_tables) and ONE bundle run through every
wavelength's chain (K6 reads it once, its wavelengths unrolled, a
launch a run of at most cuda_spec.MAX_NLAM of them; K7 once a
wavelength, its wavelengths outermost).  K6 returns (nlam, 5) moments;
K7 takes (nlam, 5) moment cotangents, judges each ray dead or live per
wavelength, sums the ray and weight cotangents over the wavelengths and
returns the parameter cotangents per wavelength (nlam, S, SLOTS + na +
no), so autograd through the stacking (glass_tables, a broadcast
curvature) sums the shared geometry.

Every kernel here traces even- and odd-aspheric rows (the seeded Newton
intercept) and the anamorphic rows (conic cylinders in closed form,
biconics and toroids by the seeded Newton, with the figure of the
table's widths); K5, K7 and K9 reverse such a row by hand
(csrc/step_vjp.cuh figured_step_vjp, anamorphic_step_vjp): its
refraction, then the Newton root implicitly, one residual gradient
scaled by -gt/F_s, as kernels._NewtonRoot does (K9 adds the row's path
cotangent to gt first), and reduce the row's aspheric coefficients
beside its six (K9: seven) columns, then an anamorphic key's
curvature_dx and conic_dx.  Every kernel here also traces the phase
rows (a grating or a DOE on any substrate; on a cylinder by its closed
form and the normal of the biconic or toroid that made it); K5, K7 and
K9 reverse the generalized Spencer & Murty solve by hand
(csrc/step_vjp.cuh grating_refract_vjp: the Gamma root of either
branch, the groove vector's normalization, the DOE's kick) and then the
substrate's normal (a phase cylinder's, then its closed form), and
reduce grating_dy and the DOE coefficients
after the other columns (K7 per table of the stack, as mu).  Every
kernel here also traces the freeform XY rows (a conic or aspheric base
plus a triangular XY-monomial figure: the seeded Newton with the
vertex-plane restart, the freeform normal); K5, K7 and K9 reverse such
a row in figured_step_vjp (csrc/step_vjp.cuh): the refraction or phase
solve on the freeform normal, whose reverse reads the figure's second
derivatives, then the Newton root implicitly (K9 adds the row's path
cotangent ct_path n_before to gt first, as a figured row's), each XY
coefficient's cotangent -gF x^i y^j through the residual and i x^(i-1)
y^j, j x^i y^(j-1) through the normal's slopes; its slots are the last
columns, one a coefficient of the table's xy_poly width (K7 per table
of the stack).  K8 adds a
DOE row's imprinted phase psi(r2) n_after to the optical path, and K9
reverses it (doe_path_vjp): n_after takes ct_path psi(r2), coefficient
i ct_path n_after r2^(i+1) and the intercept ct_path n_after psi'(r2)
2 (x1, y1); K9's DOE rows reduce n_after before the coefficients.

`spot_moments` and `adjoint_spot_rms` bind K4/K5 in one
torch.autograd.Function (the JAX package's jax.custom_vjp `_moments`),
`spot_moments_multi` and `polychromatic_spot_rms` bind K6/K7 in the
same Function (`_moments_multi`):
gradients flow to the table's curvature, conic, offset, mu and aspheric
coefficients (and through tables.lower_pose to decenter), to the ray
state and to the weights.  n_before, which feeds only the optical path,
receives a zero cotangent.  The gradient semantics are those of the
SPECIALIZED engine: a parameter the static specs bake out (the conic of
a spherical row, the transverse offset of an on-axis row, mu of a
passthrough row, the coefficients of a row that reads no figure --
neither aspheric nor a biconic or toroid) gets exactly
zero gradient, and the call warns once when such a parameter is the one
being optimized.  A rot that requires grad (a tilt lowered through
tables.lower_pose) while some spec row is rotated is differentiated too:
the adjoint key is then a rot key (cuda_spec.carries_rot), whose nine
slots a row more carry each rotated row's rotation cotangent (the image
row's with its second use, the moment frame), and autograd through
lower_pose's Rodrigues turns them into d/d(tilt), as in the reference.
Row 0's rotation is never a slot: its tilt gradient is zero, as the
reference's.

K8 `opd_chain` and K9 `opd_adjoint` are the exit-pupil wavefront
plane (`pallas_grad._opd_kernel`, `_opd_adjoint_kernel`): K8 traces
rows 1..S-2 summing the optical path, steps to the image row,
intercepts the reference sphere (centre, radius and wavelength scale
in a (5,) aux tensor) and returns k = -(path to the sphere)/lam_scale
and the landing x, y per ray; K9 is its analytic adjoint, with the
path cotangent feeding every row's t and n_before, so it returns
OPD_SLOTS = 7 parameter cotangents a row (K5's six and n_before; then a
figured table's coefficients, an anamorphic one's curvature_dx and
conic_dx, a grating one's grating_dy, a DOE one's n_after and
coefficients, a freeform one's XY coefficients) and the centre's
three.
`adjoint_opd_rays` and `adjoint_wavefront_rms` bind them in `_OpdRays`
(the reference's custom_vjp `_opd`); the
sphere centre, the input-plane term and k - k[ref] stay outside the
kernel, in autograd.  A rot that requires grad makes K9's key a rot key
too (its image row's rotation read by the reference-sphere tail).

The kernels are hand-written CUDA C++.  K4-K9 are compiled for each
(dtype, spec tuple, clip) key, K6 also for its wavelength count,
the adjoints also for their live parameter slots and for whether they
write the ray (and weight) cotangents (csrc/grad_spec.cuh, built and
cached by ops.cuda_spec); through `_SpotMoments` and `_OpdRays` an
adjoint reduces only the slots autograd asks for and, when no ray or
weight needs a gradient (the loops' frozen bundles), writes nothing a
ray.  A new spec tuple costs one nvcc run at its first call.  A
wrapper takes the plain PyTorch
version (`weighted_moments_reference`, `merit_adjoint_reference`,
`weighted_moments_multi_reference`, `merit_adjoint_multi_reference`,
`opd_chain_reference`, `opd_adjoint_reference`) only for a bundle on
the CPU; for a CUDA bundle it launches its kernel or raises.  Each
wrapper counts its launches in `<wrapper>.launches`, and the adjoints
those of a rot key also in `<wrapper>.rot_launches`.
`_step_vjp_reference`, `_merit_adjoint_by_hand`,
`_merit_adjoint_multi_by_hand`, `_opd_tail_vjp_reference` and
`_opd_adjoint_by_hand` write the kernels' hand-derived reverse in
torch, line for line (csrc/step_vjp.cuh and grad_spec.cuh), so the CPU
tests can hold it against autograd; nothing else calls them.
"""

import functools
import warnings
from typing import NamedTuple

import torch

from . import cuda_spec as CS
from . import kernels as K
from .cuda_spec import launch_moments, packed, spec_launch
from .cuda_trace import (ANAM, _check_state, carries_anamorphic,
                         carries_grating, doe_width, figure_widths,
                         spot_rms_from_moments, trace_final_reference,
                         xy_width)
from .tables import lower_pose, table_at

SLOTS = CS.SLOTS          # parameter cotangents a row: c, k, offset x/y/z, mu
OPD_SLOTS = CS.OPD_SLOTS  # K9's a row: SLOTS and n_before
AUX = CS.AUX    # K8/K9's aux vector: centre x, y, z, radius, lam_scale

ROT = CS.ROT    # a rot key's slots a row: the rotation, last
#: differentiable table fields _OpdRays carries (K9's fields: the
#: anamorphic x figure, then the phase rows' grating_dy, n_after and doe,
#: then the freeform rows' xy_poly, then rot, last)
_DIFF = CS.OPD_DIFF + (CS.ROT_FIELD,)
_NO = len(_DIFF)
#: those _SpotMoments carries: _DIFF up to the anamorphic x figure, then
#: the phase rows' grating_dy and doe, the freeform rows' xy_poly and rot
#: (the spot moments' n_before gets a zero cotangent)
_SPOT = _DIFF[:9] + CS.FIELDS[8:] + (CS.ROT_FIELD,)
_NM = len(_SPOT)
#: kernel-carried fields that never receive cotangents
_NONDIFF = ("radius", "alternate")
#: the fields the reference kernel carries (pallas_trace._FIELDS)
_FIELDS = ("curvature", "conic", "aspherics", "aspherics_odd", "offset",
           "rot", "radius", "alternate", "mu", "n_before", "n_after")


# -- plain versions ------------------------------------------------------

def _wmoments(x, y, w, good):
    wg = torch.where(good, w, 0.)
    xg = torch.where(good, x, 0.)
    yg = torch.where(good, y, 0.)
    return torch.stack([wg.sum(), (wg*xg).sum(), (wg*yg).sum(),
                        (wg*xg*xg).sum(), (wg*yg*yg).sum()])


def _live(out):
    return (torch.isfinite(out[0]) & torch.isfinite(out[1])
            & torch.isfinite(out[5]))


def weighted_moments_reference(table, specs, state, w, clip=False):
    """Plain PyTorch version of K4: the (5,) weighted moments of the K1
    trace in the state's dtype."""
    out, _ = trace_final_reference(table, specs, state, clip)
    return _wmoments(out[0], out[1], w, _live(out))


def _folded(table):
    """The table with its pose folded into rot and offset and its tilt
    and decenter dropped: lowering it again reads nothing from the
    device (tables.lower_pose tests a CUDA pose for zeros with a host
    sync)."""
    return lower_pose(table)._replace(tilt=None, decenter=None)


def _constant_table(table, like):
    """The lowered table (_folded), detached, in `like`'s dtype and
    device."""
    return type(table)(*(None if f is None
                         else f.detach().to(device=like.device,
                                            dtype=like.dtype)
                         for f in _folded(table)))


def _param_rows(tab, anamorphic=False, grating=False, nd=0, opd=False,
                nxy=0, rot=False):
    """(S, SLOTS + na + no [+ ANAM] [+ 1] [+ nd] [+ nxy] [+ ROT]) view of
    the differentiated fields of a table: c, k, offset x, y, z, mu, then
    its aspheric coefficients, then (anamorphic, cuda_trace.
    carries_anamorphic) curvature_dx and conic_dx, then (grating,
    carries_grating) grating_dy, then (nd, doe_width) the DOE
    coefficients -- with `opd` (K9's) n_after before them --, then (nxy,
    xy_width) the XY coefficients, then (rot, cuda_spec.carries_rot) the
    rotation, row-major."""
    cols = [torch.stack([tab.curvature, tab.conic, tab.offset[:, 0],
                         tab.offset[:, 1], tab.offset[:, 2], tab.mu], 1),
            tab.aspherics, tab.aspherics_odd]
    if anamorphic:
        cols.append(torch.stack([tab.curvature_dx, tab.conic_dx], 1))
    if grating:
        cols.append(tab.grating_dy[:, None])
    if nd:
        if opd:
            cols.append(tab.n_after[:, None])
        cols.append(tab.doe)
    if nxy:
        cols.append(tab.xy_poly)
    if rot:
        cols.append(tab.rot.flatten(-2))
    return torch.cat(cols, 1)


def _phase_layout(table, specs):
    """(grating, nd) of the phase columns of an adjoint's parameter
    cotangents: whether a row is a grating (cuda_trace.carries_grating)
    and the DOE width (doe_width)."""
    return carries_grating(specs), doe_width(table, specs)


def _table_widths(table):
    """(na, no): a table's aspheric coefficient widths."""
    return (int(table.aspherics.shape[-1]),
            int(table.aspherics_odd.shape[-1]))


def _nslots(table, specs, base=SLOTS, rot=False):
    """K5's and K7's cotangent columns a row for a table and its specs
    (K9's with base OPD_SLOTS): `base`, the table's aspheric
    coefficients, ANAM where a row is anamorphic (cuda_trace.
    carries_anamorphic), then one where a row is a grating and the DOE
    width where a row is a DOE (_phase_layout; K9 one more there, its
    n_after), then the xy_poly width where a row is freeform
    (cuda_trace.xy_width), then ROT for a rot key (`rot`,
    cuda_spec.carries_rot)."""
    grating, nd = _phase_layout(table, specs)
    k9 = base == OPD_SLOTS
    return base + sum(_table_widths(table)) \
        + (ANAM if carries_anamorphic(specs) else 0) + int(grating) + nd \
        + int(k9 and nd > 0) + xy_width(table, specs) + (ROT if rot else 0)


def _key_columns(pg, key, nq, base=SLOTS):
    """An adjoint key's (..., key.slots) cotangent columns widened to the
    table's nq (_nslots): a key of a table with no aspheric row has no
    coefficient columns, theirs are exact zeros (before the anamorphic
    two)."""
    if pg.shape[-1] == nq:
        return pg
    kq = base + key.na + key.no
    return torch.cat([pg[..., :kq], pg.new_zeros(pg.shape[:-1] + (
        nq - pg.shape[-1],)), pg[..., kq:]], -1)


def _diff_values(table, fields=_DIFF):
    """The table's `fields` (every field _OpdRays carries by default),
    zeros for an absent anamorphic or grating field (an empty (S, 0)
    block for an absent doe)."""
    def value(f):
        v = getattr(table, f)
        if v is not None:
            return v
        if f in ("doe", "xy_poly"):
            return table.curvature.new_zeros(table.curvature.shape + (0,))
        return torch.zeros_like(table.curvature)
    return [value(f) for f in fields]


def merit_adjoint_reference(table, specs, state, w, ct, clip=False,
                            rot=False):
    """Plain PyTorch version of K5: torch autograd through the plain
    trace.  A no-grad pre-trace finds the live rays; each dead ray is
    traced as the first live one (so no NaN enters autograd) at zero
    weight.  Returns (parameter cotangents (S, _nslots) in the order
    c, k, offset x, y, z, mu, then the table's na even and no odd
    aspheric coefficients, then for anamorphic specs
    (cuda_trace.carries_anamorphic) curvature_dx and conic_dx, then for
    grating specs grating_dy, for DOE specs the DOE coefficients, for
    freeform specs the XY coefficients, with `rot` (a rot key's) the
    rotation last; the six state cotangents; the weight cotangent), all
    in the state's dtype."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    anam = carries_anamorphic(specs)
    grating, nd = _phase_layout(tab, specs)
    nxy = xy_width(tab, specs)
    with torch.no_grad():
        out, _ = trace_final_reference(tab, specs, state, clip)
        alive = _live(out)
    pg = torch.zeros((tab.nsurfaces, _nslots(tab, specs, rot=rot)),
                     dtype=x0.dtype, device=x0.device)
    if not bool(alive.any()):
        return pg, tuple(torch.zeros_like(x0) for _ in range(6)), \
            torch.zeros_like(x0)
    i0 = int(torch.argmax(alive.to(torch.uint8)))
    fields = ("curvature", "conic", "offset", "mu", "aspherics",
              "aspherics_odd") + (("curvature_dx", "conic_dx") if anam
                                  else ()) \
        + (("grating_dy",) if grating else ()) + (("doe",) if nd else ()) \
        + (("xy_poly",) if nxy else ()) + (("rot",) if rot else ())
    nf = len(fields)
    leaves = [*(getattr(tab, f) for f in fields), *state, w]
    leaves = [v.detach().clone().requires_grad_() for v in leaves]
    st, wl = leaves[nf:nf + 6], leaves[nf + 6]
    with torch.enable_grad():
        sub = tuple(torch.where(alive, s, s[i0]) for s in st)
        t2 = tab.replace(**dict(zip(fields, leaves[:nf])))
        out, _ = trace_final_reference(t2, specs, sub, clip)
        mom = _wmoments(out[0], out[1], wl, alive)
        grads = torch.autograd.grad((mom*ct.to(mom.dtype)).sum(), leaves,
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    pg = _param_rows(tab.replace(**dict(zip(fields, grads[:nf]))), anam,
                     grating, nd, nxy=nxy, rot=rot)
    return pg, tuple(grads[nf:nf + 6]), grads[nf + 6]


def weighted_moments_multi_reference(tables, specs, state, w, clip=False):
    """Plain PyTorch version of K6: weighted_moments_reference for each
    table of the stack, stacked to (nlam, 5)."""
    return torch.stack([
        weighted_moments_reference(table_at(tables, li), specs, state, w,
                                   clip)
        for li in range(tables.curvature.shape[0])])


def _sum_over_tables(one, tables, specs, state, w, ct, clip, rot=False):
    """K7's reduction of a per-table adjoint `one`: parameter
    cotangents stacked per table, ray and weight cotangents summed over
    the tables in order."""
    pgs, st, gw = [], [torch.zeros_like(state[0]) for _ in range(6)], \
        torch.zeros_like(state[0])
    for li in range(tables.curvature.shape[0]):
        pg, sl, wl = one(table_at(tables, li), specs, state, w, ct[li], clip,
                         rot=rot)
        pgs.append(pg)
        st = [a + b for a, b in zip(st, sl)]
        gw = gw + wl
    return torch.stack(pgs), tuple(st), gw


def merit_adjoint_multi_reference(tables, specs, state, w, ct, clip=False,
                                  rot=False):
    """Plain PyTorch version of K7: for each table of the stack,
    torch autograd through the plain trace (merit_adjoint_reference,
    re-traced under enable_grad) of that table's weighted moments
    dotted with its row of the (nlam, 5) cotangents `ct`.  Returns
    (parameter cotangents (nlam, S, _nslots), with `rot` each table's
    rotation last; the six state cotangents and the weight cotangent,
    each summed over the tables)."""
    return _sum_over_tables(merit_adjoint_reference, tables, specs, state,
                            w, ct, clip, rot)


class _Tail(NamedTuple):
    """The reference-sphere tail's intermediates (SphereTail in
    csrc/step_vjp.cuh)."""
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    cc: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    f: torch.Tensor
    sq: torch.Tensor
    ti: torch.Tensor


def _sphere_tail(state, surf, spec, aux):
    """The state leaving row S-2 (global frame) stepped to the image row
    `surf`, rotated into its frame, moved to the reference sphere's
    centre aux[:3] and intercepted with the sphere of radius aux[3] in
    closed form (pallas_grad._opd_tail; a miss is NaN)."""
    px, py = state[0], state[1]
    if spec.off_axis:
        px = px - surf.offset[0]
        py = py - surf.offset[1]
    pz = state[2] - surf.offset[2]
    dx, dy, dz = state[3], state[4], state[5]
    if spec.rotated:
        px, py, pz = K.rot_apply(surf.rot, px, py, pz)
        dx, dy, dz = K.rot_apply(surf.rot, dx, dy, dz)
    radius = aux[3]
    px = px - aux[0]
    py = py - aux[1]
    pz = pz - aux[2] + radius
    cc = 1./radius
    uyd = dx*px + dy*py + dz*pz
    uu = dx*dx + dy*dy + dz*dz
    yy = px*px + py*py + pz*pz
    d = cc*uyd - dz
    e = cc*uu
    f = cc*yy - 2*pz
    sq = torch.sqrt(d*d - e*f)     # NaN on a miss, deliberately
    return _Tail(px, py, pz, dx, dy, dz, cc, d, e, f, sq, -(d + sq)/e)


def _opd_chain(tab, specs, state, aux, clip):
    """K8's computation in torch: (k, lx, ly) per ray, and the states
    entering rows 1..S-1 (index j; None at 0; at S-1 the state the
    reference-sphere tail steps to the image row) with the tail's
    intermediates for the hand-written reverse."""
    nsurf = tab.nsurfaces
    s = tuple(state)
    if specs[0].rotated:
        r0 = tab.rot[0]
        s = (*K.rot_apply_t(r0, *s[:3]), *K.rot_apply_t(r0, *s[3:]))
    path = torch.zeros_like(s[0])
    saved = [None]
    for j in range(1, nsurf - 1):
        saved.append(s)
        s, out = K.surface_step_spec(s, tab.row(j), specs[j], clip)
        path = path + out[3]
    saved.append(s)
    img = tab.row(nsurf - 1)
    o = _sphere_tail(s, img, specs[nsurf - 1], aux)
    k = -(path + o.ti*img.n_before)/aux[4]
    return (k, o.px + o.ti*o.dx, o.py + o.ti*o.dy), saved, o


def _check_opd(specs, state, aux):
    _check_state(state)
    if len(specs) < 3:
        raise ValueError("the OPD needs object, exit and image rows, got "
                         "%d rows" % len(specs))
    _check_vector(aux, state, "aux", (AUX,))


def opd_chain_reference(table, specs, state, aux, clip=False):
    """Plain PyTorch version of K8: (k, lx, ly), each (N,) in the state's
    dtype -- k = -(optical path to the reference sphere)/lam_scale and
    the landing coordinates on the sphere, for aux = (centre x, y, z,
    radius, lam_scale)."""
    tab = _constant_table(table, state[0])
    return _opd_chain(tab, specs, state, aux, clip)[0]


def opd_adjoint_reference(table, specs, state, aux, cts, clip=False,
                          rot=False):
    """Plain PyTorch version of K9: torch autograd through the plain
    chain and tail of K8 dotted with cts = (ct_k, ct_lx, ct_ly).  A
    no-grad pre-trace finds the live rays (finite k); each dead ray is
    traced as the first live one (no NaN enters autograd) with zero
    cotangents.  Returns (parameter cotangents (S, _nslots(table, specs,
    OPD_SLOTS)): c, k, offset x, y, z, mu, n_before, then the table's na
    even and no odd aspheric coefficients, then for anamorphic specs
    curvature_dx and conic_dx, for grating specs grating_dy, for DOE
    specs n_after and the DOE coefficients, for freeform specs the XY
    coefficients, with `rot` (a rot key's) the rotation last; the six
    state cotangents; the (3,) centre cotangents), in the state's
    dtype."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    with torch.no_grad():
        alive = torch.isfinite(_opd_chain(tab, specs, state, aux, clip)[0][0])
    pg = torch.zeros((tab.nsurfaces, _nslots(tab, specs, OPD_SLOTS, rot)),
                     dtype=x0.dtype, device=x0.device)
    if not bool(alive.any()):
        return pg, tuple(torch.zeros_like(x0) for _ in range(6)), \
            torch.zeros(3, dtype=x0.dtype, device=x0.device)
    i0 = int(torch.argmax(alive.to(torch.uint8)))
    nd = len(_DIFF)
    leaves = [*_diff_values(tab), *state, aux]
    leaves = [v.detach().clone().requires_grad_() for v in leaves]
    with torch.enable_grad():
        sub = tuple(torch.where(alive, s, s[i0])
                    for s in leaves[nd:nd + 6])
        t2 = tab.replace(**dict(zip(_DIFF, leaves[:nd])))
        outs = _opd_chain(t2, specs, sub, leaves[-1], clip)[0]
        total = sum((o*torch.where(alive, c.to(o.dtype), 0.)).sum()
                    for o, c in zip(outs, cts))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    g = tab.replace(**dict(zip(_DIFF, grads[:nd])))
    rows = _param_rows(g, carries_anamorphic(specs),
                       *_phase_layout(tab, specs), opd=True,
                       nxy=xy_width(tab, specs), rot=rot)
    pg = torch.cat([rows[:, :SLOTS], g.n_before[:, None], rows[:, SLOTS:]],
                   1)
    return pg, tuple(grads[nd:nd + 6]), grads[-1][:3]


# -- the kernel's reverse, written by hand in torch (test-only) ----------

def _refraction_vjp(kind, unit, mu, u, n, gv):
    """Hand-derived reverse of refract_spec's refraction (kind 1) or
    mirror (kind 2) of the direction u by the unnormalized normal n,
    shared by the conic and the figured rows, the line-for-line model of
    `refraction_vjp` in csrc/step_vjp.cuh.  Returns the cotangents of u,
    n and mu from gv, the new direction's.  `unit`: |n| = 1 (a sphere's
    normal), no normalization to reverse (ir2 = 1 exactly)."""
    ux, uy, uz = u
    nx, ny, nz = n
    gvx, gvy, gvz = gv
    dot = ux*nx + uy*ny + uz*nz
    ir2 = 1. if unit else 1./(nx*nx + ny*ny + nz*nz)
    if kind == 2:
        a2 = 2.*dot*ir2
        gux, guy, guz = gvx, gvy, gvz
        gnx, gny, gnz = -a2*gvx, -a2*gvy, -a2*gvz
        ga2 = -(gvx*nx + gvy*ny + gvz*nz)
        gdot = 2.*ir2*ga2
        gir2 = 2.*dot*ga2
        gmu = torch.zeros_like(dot)
    else:
        muf, sgmu = torch.abs(mu), torch.sign(mu)
        a = muf*dot*ir2
        sq2 = K._sqrt0(a*a - (mu*mu - 1)*ir2)
        q2 = -a + sgmu*sq2
        gmuf = ux*gvx + uy*gvy + uz*gvz
        gux, guy, guz = muf*gvx, muf*gvy, muf*gvz
        gq2 = gvx*nx + gvy*ny + gvz*nz
        gnx, gny, gnz = q2*gvx, q2*gvy, q2*gvz
        gdisc2 = gq2*sgmu*.5/sq2
        ga = -gq2 + 2*a*gdisc2
        gmu = -2*mu*ir2*gdisc2
        gir2 = -(mu*mu - 1)*gdisc2 + muf*dot*ga
        gmuf = gmuf + dot*ir2*ga
        gdot = muf*ir2*ga
        gmu = gmu + sgmu*gmuf
    gux, guy, guz = gux + gdot*nx, guy + gdot*ny, guz + gdot*nz
    gnx, gny, gnz = gnx + gdot*ux, gny + gdot*uy, gnz + gdot*uz
    if not unit:
        s2 = -2.*ir2*ir2*gir2
        gnx, gny, gnz = gnx + s2*nx, gny + s2*ny, gnz + s2*nz
    return (gux, guy, guz), (gnx, gny, gnz), gmu


def _grating_refract_vjp(x1, y1, u, mu, gdy, ngx, ngy, doe, gv):
    """Hand-derived reverse of kernels.refract_grating for live rays,
    the line-for-line model of `grating_refract_vjp` in
    csrc/step_vjp.cuh: from the new direction's cotangent gv, those of
    the incoming direction u, the normal (ngx, ngy), mu, the grating
    term gdy (0. on a DOE row that is no grating), the DOE coefficients
    (doe: the row's, or None) and the point (x1, y1) the kick reads.
    Gamma's two roots (the mirror's by sign(bn), the transmission's by
    sign(mu)), |mu|, the groove vector's TINY floor and the kick are
    reversed; sign() has no cotangent.  A row that passes (mu == 1, no
    grating term, no kick) hands gv on to u.  Returns ((gux, guy, guz),
    (ggx, ggy), gmu, ggdy, [gdoe_i], gx1, gy1)."""
    ux, uy, uz = u
    gvx, gvy, gvz = gv
    zero = torch.zeros_like(ux)
    inv = 1./(ngx*ngx + ngy*ngy + 1.)
    muf = torch.abs(mu)
    qx0, qy0, qz0 = -ngy*ngx*inv, 1. - ngy*ngy*inv, -ngy*inv
    m = qx0*qx0 + qy0*qy0 + qz0*qz0
    qn = torch.rsqrt(torch.clamp(m, min=K.TINY))
    qx, qy, qz = qx0*qn, qy0*qn, qz0*qn
    bx, by, bz = muf*ux + gdy*qx, muf*uy + gdy*qy, muf*uz + gdy*qz
    keep = (mu == 1) & (torch.as_tensor(gdy) == 0)
    kick = doe is not None and doe.shape[-1] > 0
    if kick:
        r2 = x1*x1 + y1*y1
        ek = K._dpoly_even(r2, doe)
        bx, by = bx + ek*x1, by + ek*y1
        keep = keep & torch.all(doe == 0, dim=-1)
    dot = bx*ngx + by*ngy + bz
    bn = dot*inv
    bb = bx*bx + by*by + bz*bz
    disc = bn*bn - (bb - 1.)*inv
    root = K._sqrt0(disc)
    mirror = mu == -1
    gam = torch.where(mirror, -bn - torch.sign(bn)*root,
                      -bn + torch.sign(mu)*root)
    # ---- reverse: u' = b + gam (ngx, ngy, 1) ----
    gbx, gby, gbz = gvx, gvy, gvz
    ggam = gvx*ngx + gvy*ngy + gvz
    ggx, ggy = gvx*gam, gvy*gam
    gbn = -ggam
    groot = torch.where(mirror, -torch.sign(bn), torch.sign(mu))*ggam
    gdisc = _sqrt0_vjp(disc, root, groot)
    # disc = bn^2 - (bb - 1) inv
    gbn = gbn + 2*bn*gdisc
    gbb = -inv*gdisc
    ginv = -(bb - 1.)*gdisc
    gbx, gby, gbz = gbx + 2*bx*gbb, gby + 2*by*gbb, gbz + 2*bz*gbb
    # bn = (b . (ngx, ngy, 1)) inv
    gdot = gbn*inv
    ginv = ginv + gbn*dot
    gbx, gby, gbz = gbx + gdot*ngx, gby + gdot*ngy, gbz + gdot
    ggx, ggy = ggx + gdot*bx, ggy + gdot*by
    # b = |mu| u + gdy q + s
    gmuf = gbx*ux + gby*uy + gbz*uz
    gux, guy, guz = muf*gbx, muf*gby, muf*gbz
    ggdy = gbx*qx + gby*qy + gbz*qz
    gqx, gqy, gqz = gdy*gbx, gdy*gby, gdy*gbz
    gx1, gy1, gdoe = zero, zero, []
    if kick:
        # s = E(r2) (x1, y1), E = sum 2 (i+1) doe_i r2^i
        gek = gbx*x1 + gby*y1
        gx1, gy1 = ek*gbx, ek*gby
        gr2 = _horner(r2, doe, lambda i: 2*(i + 1)*i, 1)*gek
        pw = torch.ones_like(r2)
        for i in range(doe.shape[-1]):
            gdoe.append(2*(i + 1)*pw*gek)
            pw = pw*r2
        gx1, gy1 = gx1 + 2*x1*gr2, gy1 + 2*y1*gr2
    # q = q0 qn, qn = rsqrt(max(q0 . q0, TINY))
    gqn = gqx*qx0 + gqy*qy0 + gqz*qz0
    gq0x, gq0y, gq0z = gqx*qn, gqy*qn, gqz*qn
    gm = _floor_vjp(m, -.5*qn*qn*qn*gqn)
    gq0x, gq0y, gq0z = gq0x + 2*qx0*gm, gq0y + 2*qy0*gm, gq0z + 2*qz0*gm
    # q0 = (-ngy ngx inv, 1 - ngy^2 inv, -ngy inv), inv = 1/|n|^2
    ggx = ggx - ngy*inv*gq0x
    ggy = ggy - ngx*inv*gq0x - 2*ngy*inv*gq0y - inv*gq0z
    ginv = ginv - ngy*ngx*gq0x - ngy*ngy*gq0y - ngy*gq0z
    gnn = -inv*inv*ginv
    ggx, ggy = ggx + 2*ngx*gnn, ggy + 2*ngy*gnn
    gmu = torch.sign(mu)*gmuf

    def moved(v):
        return torch.where(keep, 0., v)
    return ((torch.where(keep, gvx, gux), torch.where(keep, gvy, guy),
             torch.where(keep, gvz, guz)), (moved(ggx), moved(ggy)),
            moved(gmu), moved(ggdy), [moved(v) for v in gdoe], moved(gx1),
            moved(gy1))


def _phase_row(surf, spec):
    """A phase row's grating term (0. where it is no grating) and DOE
    coefficients (None where it is no DOE), as surface_step_spec reads
    them."""
    return (surf.grating_dy if spec.grating else 0.,
            surf.doe if spec.doe else None)


def _phase_tail(surf, spec, ggdy, gdoe, gna=None):
    """The per-ray cotangents a phase row appends after its other slots:
    grating_dy (zero on a DOE that is no grating), then (K9's PATH,
    `gna` given) n_after's, then the row's DOE coefficients (none on a
    grating that is no DOE)."""
    na = () if gna is None or not spec.doe else (gna,)
    return (ggdy if spec.grating else torch.zeros_like(ggdy),) + na \
        + (tuple(gdoe) if spec.doe else ())


def _doe_path_vjp(surf, spec, x1, y1, ct_path, gdoe, gx1, gy1):
    """Reverse of a DOE row's optical path term psi(r2) n_after (K9's
    PATH), the model of `doe_path_vjp` in csrc/step_vjp.cuh: n_after's
    cotangent ct_path psi(r2), coefficient i's ct_path n_after r2^(i+1)
    added into gdoe, the intercept point's ct_path n_after psi'(r2) 2
    (x1, y1) into gx1, gy1.  Returns (gna, gdoe, gx1, gy1); gna None and
    the rest as given without ct_path or on a row that is no DOE."""
    if ct_path is None or not spec.doe:
        return None, gdoe, gx1, gy1
    doe = surf.doe
    r2 = x1*x1 + y1*y1
    gp = ct_path*surf.n_after
    pw, out = r2, []
    for i in range(doe.shape[-1]):
        out.append(gdoe[i] + gp*pw)
        pw = pw*r2
    e = gp*K._dpoly_even(r2, doe)
    return ct_path*K._poly_even(r2, doe), out, gx1 + e*x1, gy1 + e*y1


def _radial_phase_vjp(x1, y1, c, k, asp, aspo, ggx, ggy, ga, gb, flat):
    """Reverse of a phase row's radial normal (x1 e, y1 e) with e =
    -c/sqrt0(1 - (1+k) c^2 r2) less the slopes of every coefficient of
    the figure's widths (kernels.normal_radial; asp and aspo None for a
    row without a figure, whose flat substrate has the normal (0, 0):
    `flat`), from the normal's cotangents: returns (gx1, gy1, gc, gk),
    the coefficients' cotangents added into ga, gb (the model of
    `radial_phase_vjp` in csrc/step_vjp.cuh)."""
    zero = torch.zeros_like(x1)
    if flat:
        return zero, zero, zero, zero
    r2 = x1*x1 + y1*y1
    kc2 = (1 + k)*c*c
    w = 1 - kc2*r2
    s = K._sqrt0(w)
    e = -c/s
    if asp is not None and asp.shape[-1]:
        e = e - K._dpoly_even(r2, asp)
    if aspo is not None and aspo.shape[-1]:
        e = e - K._dpoly_odd(r2, aspo)
    ge = x1*ggx + y1*ggy
    gx1, gy1 = e*ggx, e*ggy
    gc = -ge/s
    gw = _sqrt0_vjp(w, s, ge*c/(s*s))
    gk = -c*c*r2*gw
    gc = gc - 2*(1 + k)*c*r2*gw
    gr2 = -kc2*gw
    if asp is not None:
        gr2 = _figure_slope_vjp(r2, asp, aspo, ge, ga, gb, gr2,
                                asp.shape[-1] > 0, aspo.shape[-1] > 0)
    return gx1 + 2*x1*gr2, gy1 + 2*y1*gr2, gc, gk


def _radial_phase_normal(x1, y1, c, k, asp, aspo, flat):
    """The (ngx, ngy) normal of a phase row's flat, conic or figured
    substrate (surface_step_spec's phase branch)."""
    if flat:
        return torch.zeros_like(x1), torch.zeros_like(y1)
    e = K.normal_radial(x1, y1, c, k, asp, aspo)
    return x1*e, y1*e


def _rot_leave_vjp(r, so, g):
    """The rotation's cotangent where a reverse leaves a row's frame, the
    model of `rot_leave_vjp` in csrc/step_vjp.cuh: the forward wrote the
    state leaving the row as R^T of its local one, so with `so` that
    state (global frame) and g its cotangent, entry 3 i + j is (R so)[i]
    g[j] + (R so_u)[i] g[3 + j].  Returns the nine, R[i][j] row-major."""
    ol = K.rot_apply(r, *so[:3])
    vl = K.rot_apply(r, *so[3:])
    return [ol[i]*g[j] + vl[i]*g[3 + j] for i in range(3) for j in range(3)]


def _rot_enter_vjp(pr, e, gl):
    """The rotation's cotangent where a reverse enters a row's frame, the
    model of `rot_enter_vjp` in csrc/step_vjp.cuh: the forward took x_l =
    R d and u_l = R u (`e` = d, the position less the row's offset, then
    u, global frame), so entry 3 i + j of `pr` gains g_xl[i] d[j] +
    g_ul[i] u[j] from the local cotangents gl."""
    return [pr[3*i + j] + gl[i]*e[j] + gl[3 + i]*e[3 + j]
            for i in range(3) for j in range(3)]


def _step_vjp_reference(state, surf, spec, g, ct_path=None, out=None):
    """Hand-derived reverse of kernels.surface_step_spec for live rays,
    the line-for-line model of `surface_step_vjp` in csrc/step_vjp.cuh.

    state: the six components entering the row (global frame); g: the
    cotangent of the six components leaving it; ct_path: the cotangent
    of the row's optical path t * n_before (K9's PATH instantiation), or
    None (K5's and K7's: the path has no cotangent); out: the six
    components leaving the row (a rot key's, whose rotated rows return
    their rotation's nine cotangents last), or None.  Returns (cotangent
    of the entering state, per-ray parameter cotangents (c, k, offset x,
    y, z, mu, and with ct_path n_before; an aspheric or freeform row
    then its table's even and odd coefficients, a freeform row its XY
    coefficients, `_figured_vjp_reference`; with `out` a rotated row's
    rotation R[i][j] last)).  The aperture clip is a constant mask: a
    clipped ray is dead, and dead rays never reach the reverse sweep.  A
    freeform figure on an anamorphic base raises
    (kernels.check_supported), as every key does."""
    K.check_supported(spec, what="K5's reverse", kernel="k5")
    if K.is_anamorphic_spec(spec):
        return _anamorphic_vjp_reference(state, surf, spec, g, ct_path, out)
    if K.is_figured(spec) or spec.freeform:
        return _figured_vjp_reference(state, surf, spec, g, ct_path, out)
    rot_g = out is not None and spec.rotated
    x, y, z, ux, uy, uz = state
    zero = torch.zeros_like(x)
    c, k, mu = surf.curvature, surf.conic, surf.mu
    # ---- forward recompute ----
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
    e0 = (x, y, z, ux, uy, uz)
    if spec.rotated:
        r = surf.rot
        x, y, z = K.rot_apply(r, x, y, z)
        ux, uy, uz = K.rot_apply(r, ux, uy, uz)
    if spec.flat:
        uzs = torch.where(uz == 0, 1., uz)
        t = -z/uzs
    else:
        k1 = 1. if spec.spherical else 1 + k
        if spec.spherical:
            uyd = ux*x + uy*y + uz*z
            uu = 1.
            yy = x*x + y*y + z*z
        else:
            uyd = ux*x + uy*y + k1*uz*z
            uu = ux*ux + uy*uy + k1*uz*uz
            yy = x*x + y*y + k1*z*z
        d = c*uyd - uz
        e = c*uu
        f = c*yy - 2*z
        disc = d*d - e*f
        sg = -1. if spec.alternate else 1.
        sq = K._sqrt0(disc)
        q = sg*sq
        # intercept_spec's pair: f/(q - d) (conj) or -(d + q)/e
        conj = (d*q <= 0) | (e == 0)
        den = torch.where(conj, q - d, e)
        den = torch.where(den == 0, 1., den)
        t = torch.where(conj, f, -(d + q))/den
    x1, y1, z1 = x + t*ux, y + t*uy, z + t*uz
    # ---- reverse: leave the row's frame ----
    pr = _rot_leave_vjp(r, out, g) if rot_g else []
    gx1, gy1, gz1, gvx, gvy, gvz = g
    if spec.rotated:
        gx1, gy1, gz1 = K.rot_apply(r, gx1, gy1, gz1)
        gvx, gvy, gvz = K.rot_apply(r, gvx, gvy, gvz)
    gc, gk, gmu = zero, zero, zero
    phase = ()
    # ---- reverse: refraction ----
    if K.is_phase(spec):
        # the grating/phase solve on the radial (or flat) normal
        gdy, doe = _phase_row(surf, spec)
        ngx, ngy = _radial_phase_normal(x1, y1, c, k, None, None, spec.flat)
        (gux, guy, guz), (ggx, ggy), gmu, ggdy, gdoe, dx1, dy1 = \
            _grating_refract_vjp(x1, y1, (ux, uy, uz), mu, gdy, ngx, ngy, doe,
                                 (gvx, gvy, gvz))
        nx1, ny1, gc, gk = _radial_phase_vjp(x1, y1, c, k, None, None, ggx,
                                             ggy, [], [], spec.flat)
        gx1, gy1 = gx1 + dx1 + nx1, gy1 + dy1 + ny1
        gna, gdoe, gx1, gy1 = _doe_path_vjp(surf, spec, x1, y1, ct_path,
                                            gdoe, gx1, gy1)
        phase = _phase_tail(surf, spec, ggdy, gdoe, gna)
    elif spec.kind == 0:
        gux, guy, guz = gvx, gvy, gvz
    elif spec.flat and spec.kind == 2:
        gux, guy, guz = gvx, gvy, -gvz
    elif spec.flat:
        muf, sgmu = torch.abs(mu), torch.sign(mu)
        a = muf*uz
        sq2 = K._sqrt0(a*a - (mu*mu - 1))
        gmuf = ux*gvx + uy*gvy + uz*gvz
        gux, guy, guz = muf*gvx, muf*gvy, muf*gvz
        gq2 = gvz
        gdisc2 = gq2*sgmu*.5/sq2
        ga = -gq2 + 2*a*gdisc2
        gmu = -2*mu*gdisc2
        gmuf = gmuf + uz*ga
        guz = guz + muf*ga
        gmu = gmu + sgmu*gmuf
    else:
        kc = c if spec.spherical else (1 + k)*c
        nx, ny, nz = -c*x1, -c*y1, 1. - kc*z1
        (gux, guy, guz), (gnx, gny, gnz), gmu = _refraction_vjp(
            spec.kind, spec.spherical, mu, (ux, uy, uz), (nx, ny, nz),
            (gvx, gvy, gvz))
        if not spec.spherical:
            gk = gk - c*z1*gnz
        zc = z1 if spec.spherical else (1 + k)*z1
        gc = gc - x1*gnx - y1*gny - zc*gnz
        gx1, gy1, gz1 = gx1 - c*gnx, gy1 - c*gny, gz1 - kc*gnz
    # ---- reverse: transfer x1 = x + t u ----
    gx, gy, gz = gx1, gy1, gz1
    gux, guy, guz = gux + t*gx1, guy + t*gy1, guz + t*gz1
    gt = ux*gx1 + uy*gy1 + uz*gz1
    if ct_path is not None:
        gt = gt + ct_path*surf.n_before
        gnb = ct_path*t
    # ---- reverse: intercept ----
    if spec.flat:
        gz = gz - gt/uzs
        guz = guz + torch.where(uz == 0, 0., gt*z/(uzs*uzs))
    else:
        # the derivative of the form the ray took (den is e when not conj)
        dd = torch.where(conj & (q != d), gt*f/(den*den), 0.)
        gf = torch.where(conj, gt/den, 0.)
        gd = torch.where(conj, dd, -gt/den)
        gq = torch.where(conj, -dd, -gt/den)
        ge = torch.where(conj, 0., gt*(d + q)/(den*den))
        gdisc = gq*sg*.5/sq
        gd = gd + 2*d*gdisc
        ge = ge - f*gdisc
        gf = gf - e*gdisc
        gc = gc + yy*gf + uu*ge + uyd*gd
        gyy = c*gf
        guyd = c*gd
        gz = gz - 2*gf
        guz = guz - gd
        gx = gx + 2*x*gyy + ux*guyd
        gy = gy + 2*y*gyy + uy*guyd
        gz = gz + 2*k1*z*gyy + k1*uz*guyd
        gux = gux + x*guyd
        guy = guy + y*guyd
        guz = guz + k1*z*guyd
        if not spec.spherical:
            guu = c*ge
            gux = gux + 2*ux*guu
            guy = guy + 2*uy*guu
            guz = guz + 2*k1*uz*guu
            gk = gk + z*z*gyy + uz*uz*guu + uz*z*guyd
    # ---- reverse: enter the row's frame ----
    if rot_g:
        pr = _rot_enter_vjp(pr, e0, (gx, gy, gz, gux, guy, guz))
    if spec.rotated:
        gx, gy, gz = K.rot_apply_t(r, gx, gy, gz)
        gux, guy, guz = K.rot_apply_t(r, gux, guy, guz)
    gox = -gx if spec.off_axis else zero
    goy = -gy if spec.off_axis else zero
    pg = (gc, gk, gox, goy, -gz, gmu)
    if ct_path is not None:
        pg = pg + (gnb,)
    return (gx, gy, gz, gux, guy, guz), pg + phase + tuple(pr)


def _horner(r2, coeffs, scale=lambda i: 1, start=0):
    """sum_{i >= start} scale(i) coeffs[i] r2**(i - start), by Horner
    from the top (csrc/step_vjp.cuh's loops)."""
    d = torch.zeros_like(r2)
    for i in range(coeffs.shape[-1] - 1, start - 1, -1):
        d = d*r2 + scale(i)*coeffs[..., i]
    return d


def _figure_slope_vjp(r2, asp, aspo, ge, ga, gb, gr2, even, odd):
    """Reverse of e = e - _dpoly_even(r2) (`even`) - _dpoly_odd(r2)
    (`odd`), a figure's slope in a normal, from e's cotangent ge: adds
    the coefficients' cotangents into the lists ga, gb and returns gr2
    plus r2's (csrc/step_vjp.cuh figure_slope_vjp)."""
    if even:
        dd = _horner(r2, asp, lambda i: 2*(i + 1)*i, 1)
        pw = torch.ones_like(r2)
        for i in range(asp.shape[-1]):
            ga[i] = ga[i] - 2*(i + 1)*pw*ge
            pw = pw*r2
        gr2 = gr2 - dd*ge
    if odd:
        q = _horner(r2, aspo)
        dq = _horner(r2, aspo, lambda j: j, 1)
        ddq = _horner(r2, aspo, lambda j: j*(j - 1), 2)
        sr = torch.sqrt(r2)
        rr = torch.clamp(sr, min=K.TINY)
        gq = -ge/rr
        gdq = -ge*2*rr
        gr = ge*q/(rr*rr) - ge*2*dq
        gsr = torch.where(sr >= K.TINY, gr, 0.)
        gr2 = gr2 + gsr/(2*sr) + gq*dq + gdq*ddq
        pw = torch.ones_like(r2)
        pw1 = torch.ones_like(r2)
        for j in range(aspo.shape[-1]):
            gb[j] = gb[j] + gq*pw
            if j >= 1:
                gb[j] = gb[j] + gdq*j*pw1
                pw1 = pw1*r2
            pw = pw*r2
    return gr2


def _figure_sag_vjp(r2, asp, aspo, gF, ga, gb, gr2):
    """Reverse of F = F - _poly_even(r2) - _poly_odd(r2) (every
    coefficient of the widths), a figure's sag in a residual, from F's
    cotangent gF: adds the coefficients' cotangents into ga, gb and
    returns gr2 plus r2's (csrc/step_vjp.cuh figure_sag_vjp)."""
    if asp.shape[-1]:
        d1 = _horner(r2, asp, lambda i: i + 1)
        pw = r2
        for i in range(asp.shape[-1]):
            ga[i] = ga[i] - gF*pw
            pw = pw*r2
        gr2 = gr2 - gF*d1
    if aspo.shape[-1]:
        q = _horner(r2, aspo)
        dq = _horner(r2, aspo, lambda j: j, 1)
        sr = torch.sqrt(r2)
        gr2 = gr2 - gF*q/(2*sr) - gF*sr*dq
        pw = sr
        for j in range(aspo.shape[-1]):
            gb[j] = gb[j] - gF*pw
            pw = pw*r2
    return gr2


def _xy_powers(v, deg):
    """[1, v, v^2, ..., v^deg] by repeated products (csrc/
    trace_common.cuh xy_powers)."""
    pw = [torch.ones_like(v), v]
    for _ in range(2, deg + 1):
        pw.append(pw[-1]*v)
    return pw[:deg + 1]


def _xy_normal_vjp(x1, y1, xy, ggx, ggy, gxy):
    """Reverse of (gx, gy) -= (dP/dx, dP/dy)(x1, y1), P = _poly_xy, the
    freeform figure's slopes in a normal, from the normal's cotangents
    (ggx, ggy): term t = (i, j) adds -(ggx i x^(i-1) y^j + ggy j x^i
    y^(j-1)) into gxy[t], and the point takes the figure's second
    derivatives.  Returns (gx1, gy1) (csrc/step_vjp.cuh
    xy_normal_vjp)."""
    deg = K.xy_degree(xy.shape[-1])
    xp, yp = _xy_powers(x1, deg), _xy_powers(y1, deg)
    gx1 = torch.zeros_like(x1)
    gy1 = torch.zeros_like(x1)
    for t, (i, j) in enumerate(K._xy_terms(deg)):
        c = xy[..., t]
        mx = i*xp[i - 1]*yp[j] if i else 0.
        my = j*xp[i]*yp[j - 1] if j else 0.
        gxy[t] = gxy[t] - (ggx*mx + ggy*my)
        hxx = i*(i - 1)*xp[i - 2]*yp[j] if i >= 2 else 0.
        hxy = i*j*xp[i - 1]*yp[j - 1] if i and j else 0.
        hyy = j*(j - 1)*xp[i]*yp[j - 2] if j >= 2 else 0.
        gx1 = gx1 - c*(ggx*hxx + ggy*hxy)
        gy1 = gy1 - c*(ggx*hxy + ggy*hyy)
    return gx1, gy1


def _xy_sag_vjp(px, py, xy, gF, gxy):
    """Reverse of F -= P(px, py), the freeform figure in a residual,
    from F's cotangent gF: term t = (i, j) adds -gF x^i y^j into gxy[t];
    returns the point's (-gF dP/dx, -gF dP/dy) (csrc/step_vjp.cuh
    xy_sag_vjp)."""
    deg = K.xy_degree(xy.shape[-1])
    xp, yp = _xy_powers(px, deg), _xy_powers(py, deg)
    for t, (i, j) in enumerate(K._xy_terms(deg)):
        gxy[t] = gxy[t] - gF*(xp[i]*yp[j])
    dpx, dpy = K._dpoly_xy(px, py, xy)
    return -gF*dpx, -gF*dpy


def _figured_vjp_reference(state, surf, spec, g, ct_path=None, out=None):
    """Hand-derived reverse of an aspheric row's step (kernels.
    surface_step_spec with spec.aspheric or spec.odd) for live rays, the
    line-for-line model of `figured_step_vjp` in csrc/step_vjp.cuh: the
    refraction (_refraction_vjp) by the radial normal (x1 e, y1 e, 1)
    and the figures' slopes in e, the transfer, then the Newton
    intercept differentiated implicitly at its root, dF/dp scaled by
    -gt/F_s (kernels._NewtonRoot); with ct_path (K9's PATH) the row's
    optical path t * n_before first adds ct_path * n_before to gt, and
    n_before takes ct_path * t.  A freeform row (spec.freeform) takes its
    Newton with the XY figure and the vertex-plane restart, and refracts
    (or solves its phase) on the freeform normal: the radial normal of
    every coefficient of the widths less the XY slopes (kernels.
    normal_freeform), Snell or a mirror by _refract_general's form.
    Returns the entering state's cotangent and the per-ray parameter
    cotangents (c, k, offset x, y, z, mu, with ct_path n_before, then
    the table's na even and no odd coefficients, a phase row's, then a
    freeform row's XY coefficients, then with `out` a rotated row's
    rotation, _step_vjp_reference)."""
    rot_g = out is not None and spec.rotated
    x, y, z, ux, uy, uz = state
    zero = torch.zeros_like(x)
    c, k, mu = surf.curvature, surf.conic, surf.mu
    asp, aspo = surf.aspherics, surf.aspherics_odd
    na, no = asp.shape[-1], aspo.shape[-1]
    ff = bool(spec.freeform)
    xy = surf.xy_poly if ff else None
    # ---- forward recompute ----
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
    e0 = (x, y, z, ux, uy, uz)
    if spec.rotated:
        r = surf.rot
        x, y, z = K.rot_apply(r, x, y, z)
        ux, uy, uz = K.rot_apply(r, ux, uy, uz)
    t = K.intercept(x, y, z, ux, uy, uz, c, k, asp, surf.alternate,
                    aspherics_odd=aspo, xy_poly=xy)
    x1, y1 = x + t*ux, y + t*uy
    # ---- reverse: leave the row's frame ----
    pr = _rot_leave_vjp(r, out, g) if rot_g else []
    gx1, gy1, gz1, gvx, gvy, gvz = g
    if spec.rotated:
        gx1, gy1, gz1 = K.rot_apply(r, gx1, gy1, gz1)
        gvx, gvy, gvz = K.rot_apply(r, gvx, gvy, gvz)
    gc, gk, gmu = zero, zero, zero
    ga = [zero]*na
    gb = [zero]*no
    gxy = [zero]*(xy.shape[-1] if ff else 0)
    phase = ()
    # ---- reverse: refraction by the radial (or freeform) normal ----
    if K.is_phase(spec):
        # the grating/phase solve on the radial normal of every
        # coefficient of the widths (kernels.normal_radial), less a
        # freeform row's XY slopes
        gdy, doe = _phase_row(surf, spec)
        ngx, ngy = (K.normal_freeform(x1, y1, c, k, asp, aspo, xy) if ff
                    else _radial_phase_normal(x1, y1, c, k, asp, aspo,
                                              False))
        (gux, guy, guz), (ggx, ggy), gmu, ggdy, gdoe, dx1, dy1 = \
            _grating_refract_vjp(x1, y1, (ux, uy, uz), mu, gdy, ngx, ngy, doe,
                                 (gvx, gvy, gvz))
        nx1, ny1, gc, gk = _radial_phase_vjp(x1, y1, c, k, asp, aspo, ggx,
                                             ggy, ga, gb, False)
        gx1, gy1 = gx1 + dx1 + nx1, gy1 + dy1 + ny1
        if ff:
            hx1, hy1 = _xy_normal_vjp(x1, y1, xy, ggx, ggy, gxy)
            gx1, gy1 = gx1 + hx1, gy1 + hy1
        gna, gdoe, gx1, gy1 = _doe_path_vjp(surf, spec, x1, y1, ct_path,
                                            gdoe, gx1, gy1)
        phase = _phase_tail(surf, spec, ggdy, gdoe, gna)
    elif spec.kind == 0:
        gux, guy, guz = gvx, gvy, gvz
    elif ff:
        # Snell or a mirror on the freeform normal (gx, gy, 1)
        ngx, ngy = K.normal_freeform(x1, y1, c, k, asp, aspo, xy)
        (gux, guy, guz), (gnx, gny, _), gmu = _refraction_vjp(
            spec.kind, False, mu, (ux, uy, uz), (ngx, ngy, 1.),
            (gvx, gvy, gvz))
        if spec.kind == 2:
            # the reflection's a = |mu| (u . n) / |n|^2 with |mu| = 1
            nn = ngx*ngx + ngy*ngy + 1.
            gmu = -torch.sign(mu)*2*(ux*ngx + uy*ngy + uz)/nn \
                * (gvx*ngx + gvy*ngy + gvz)
        nx1, ny1, gc, gk = _radial_phase_vjp(x1, y1, c, k, asp, aspo, gnx,
                                             gny, ga, gb, False)
        hx1, hy1 = _xy_normal_vjp(x1, y1, xy, gnx, gny, gxy)
        gx1, gy1 = gx1 + nx1 + hx1, gy1 + ny1 + hy1
    else:
        r2s = x1*x1 + y1*y1
        kc2 = (1 + k)*c*c
        m = 1 - kc2*r2s
        mm = torch.clamp(m, min=K.TINY)
        rs = 1./torch.sqrt(mm)
        e = -c*rs
        if spec.aspheric:
            e = e - K._dpoly_even(r2s, asp)
        if spec.odd:
            e = e - K._dpoly_odd(r2s, aspo)
        nx, ny = x1*e, y1*e
        (gux, guy, guz), (gnx, gny, _), gmu = _refraction_vjp(
            spec.kind, False, mu, (ux, uy, uz), (nx, ny, 1.),
            (gvx, gvy, gvz))
        ge = x1*gnx + y1*gny
        gx1, gy1 = gx1 + e*gnx, gy1 + e*gny
        gc = gc - rs*ge
        gm = torch.where(m >= K.TINY, -.5*rs*rs*rs*(-c*ge), 0.)
        gk = gk - c*c*r2s*gm
        gc = gc - 2*(1 + k)*c*r2s*gm
        gr2s = _figure_slope_vjp(r2s, asp, aspo, ge, ga, gb, -kc2*gm,
                                 spec.aspheric, spec.odd)
        gx1, gy1 = gx1 + 2*x1*gr2s, gy1 + 2*y1*gr2s
    # ---- reverse: transfer x1 = x + t u ----
    gx, gy, gz = gx1, gy1, gz1
    gux, guy, guz = gux + t*gx1, guy + t*gy1, guz + t*gz1
    gt = ux*gx1 + uy*gy1 + uz*gz1
    if ct_path is not None:
        gt = gt + ct_path*surf.n_before
        gnb = ct_path*t
    # ---- reverse: the Newton root, implicitly: dF/dp * (-gt/F_s) ----
    fs = K._newton_slope("radial", t, x, y, z, ux, uy, uz, c, k, None, None,
                         asp, aspo, xy)
    gF = -gt/torch.where(fs == 0, 1., fs)
    px, py = x + t*ux, y + t*uy
    r2 = px*px + py*py
    kc2 = (1 + k)*c*c
    w = 1 - kc2*r2
    sq = K._sqrt0(w)
    den = 1 + sq
    gnum = -gF/den
    gsq = gF*(c*r2)/(den*den)
    gw = torch.where(w >= 0, gsq/(2*sq), 0.)
    gk = gk - c*c*r2*gw
    gc = gc - 2*(1 + k)*c*r2*gw + r2*gnum
    gr2 = _figure_sag_vjp(r2, asp, aspo, gF, ga, gb, -kc2*gw + c*gnum)
    gpx, gpy = 2*px*gr2, 2*py*gr2
    if ff:
        hpx, hpy = _xy_sag_vjp(px, py, xy, gF, gxy)
        gpx, gpy = gpx + hpx, gpy + hpy
    gx, gy, gz = gx + gpx, gy + gpy, gz + gF
    gux, guy, guz = gux + t*gpx, guy + t*gpy, guz + t*gF
    # ---- reverse: enter the row's frame ----
    if rot_g:
        pr = _rot_enter_vjp(pr, e0, (gx, gy, gz, gux, guy, guz))
    if spec.rotated:
        gx, gy, gz = K.rot_apply_t(r, gx, gy, gz)
        gux, guy, guz = K.rot_apply_t(r, gux, guy, guz)
    gox = -gx if spec.off_axis else zero
    goy = -gy if spec.off_axis else zero
    nb = () if ct_path is None else (gnb,)
    return ((gx, gy, gz, gux, guy, guz),
            (gc, gk, gox, goy, -gz, gmu, *nb, *ga, *gb, *phase, *gxy, *pr))


def _sqrt0_vjp(m, sq, g):
    """The cotangent of m from that of sq = sqrt0(m) (torch.clamp's
    gradient passes at m >= 0)."""
    return torch.where(m >= 0, g*.5/sq, 0.)


def _floor_vjp(v, g):
    """The cotangent of v from that of max(v, TINY)."""
    return torch.where(v >= K.TINY, g, 0.)


def _biconic_sag_vjp(px, py, cx, kx, cy, ky, gF, fig=None):
    """Reverse of F = pz - (cx x^2 + cy y^2)/(1 + sqrt0(1 - B)),
    B = (1+kx) cx^2 x^2 + (1+ky) cy^2 y^2 (kernels.sag_biconic), less
    the figure's polynomials in r2 = x^2 + y^2 with `fig` = (asp, aspo,
    ga, gb) (their cotangents added into the lists ga, gb): the
    cotangents of (px, py, cx, kx, cy, ky) from gF (pz's is gF)."""
    x2, y2 = px*px, py*py
    a = cx*x2 + cy*y2
    qx, qy = (1 + kx)*cx*cx, (1 + ky)*cy*cy
    m = 1 - (qx*x2 + qy*y2)
    sq = K._sqrt0(m)
    den = 1 + sq
    ga = -gF/den
    gb = -_sqrt0_vjp(m, sq, gF*a/(den*den))
    gpx, gpy, *dp = _biconic_ab_vjp(px, py, cx, kx, cy, ky, ga, gb, x2, y2)
    if fig is not None:
        asp, aspo, fa, fb = fig
        gr2 = _figure_sag_vjp(x2 + y2, asp, aspo, gF, fa, fb, 0.)
        gpx, gpy = gpx + 2*px*gr2, gpy + 2*py*gr2
    return (gpx, gpy, *dp)


def _biconic_ab_vjp(px, py, cx, kx, cy, ky, ga, gb, x2, y2):
    """Reverse of a = cx x2 + cy y2, B = (1+kx) cx^2 x2 + (1+ky) cy^2 y2
    from their cotangents: those of (px, py, cx, kx, cy, ky)."""
    gx2 = ga*cx + gb*(1 + kx)*cx*cx
    gy2 = ga*cy + gb*(1 + ky)*cy*cy
    gcx = ga*x2 + gb*x2*2*(1 + kx)*cx
    gcy = ga*y2 + gb*y2*2*(1 + ky)*cy
    gkx = gb*x2*cx*cx
    gky = gb*y2*cy*cy
    return 2*px*gx2, 2*py*gy2, gcx, gkx, gcy, gky


def _figure_slope(r2, asp, aspo):
    """D(r2) = _dpoly_even + _dpoly_odd of the widths present."""
    d = torch.zeros_like(r2)
    if asp.shape[-1]:
        d = d + K._dpoly_even(r2, asp)
    if aspo.shape[-1]:
        d = d + K._dpoly_odd(r2, aspo)
    return d


def _biconic_normal_vjp(x, y, cx, kx, cy, ky, ggx, ggy, fig=None):
    """Reverse of kernels.normal_biconic (with `fig` = (asp, aspo, ga,
    gb) its figure's (x, y) D(r2) too): the cotangents of (x, y, cx, kx,
    cy, ky) from those of (gx, gy)."""
    x2, y2 = x*x, y*y
    a = cx*x2 + cy*y2
    qx, qy = (1 + kx)*cx*cx, (1 + ky)*cy*cy
    m = 1 - (qx*x2 + qy*y2)
    sq = K._sqrt0(m)
    ss = torch.clamp(sq, min=K.TINY)
    inv = 1./(1 + sq)
    px_ = 2*cx*x*(1 + sq) + a*qx*x/ss
    py_ = 2*cy*y*(1 + sq) + a*qy*y/ss
    gpx_, gpy_ = -ggx*inv*inv, -ggy*inv*inv
    ginv = -2*inv*(ggx*px_ + ggy*py_)
    gsq = -ginv*inv*inv + gpx_*2*cx*x + gpy_*2*cy*y
    gss = -(gpx_*a*qx*x + gpy_*a*qy*y)/(ss*ss)
    gsq = gsq + _floor_vjp(sq, gss)
    ga = gpx_*qx*x/ss + gpy_*qy*y/ss
    gqx, gqy = gpx_*a*x/ss, gpy_*a*y/ss
    gx = gpx_*(2*cx*(1 + sq) + a*qx/ss)
    gy = gpy_*(2*cy*(1 + sq) + a*qy/ss)
    gcx = gpx_*2*x*(1 + sq) + gqx*2*(1 + kx)*cx
    gcy = gpy_*2*y*(1 + sq) + gqy*2*(1 + ky)*cy
    gkx, gky = gqx*cx*cx, gqy*cy*cy
    gb = -_sqrt0_vjp(m, sq, gsq)
    dx, dy, dcx, dkx, dcy, dky = _biconic_ab_vjp(x, y, cx, kx, cy, ky, ga, gb,
                                                 x2, y2)
    gx, gy = gx + dx, gy + dy
    if fig is not None:
        asp, aspo, fa, fb = fig
        r2 = x2 + y2
        d = _figure_slope(r2, asp, aspo)
        gx, gy = gx - d*ggx, gy - d*ggy
        gr2 = _figure_slope_vjp(r2, asp, aspo, x*ggx + y*ggy, fa, fb, 0.,
                                asp.shape[-1] > 0, aspo.shape[-1] > 0)
        gx, gy = gx + 2*x*gr2, gy + 2*y*gr2
    return (gx, gy, gcx + dcx, gkx + dkx, gcy + dcy, gky + dky)


def _ycurve_fwd(y, cy, ky, fig=None):
    """The toroid's y curve (kernels._ycurve; with `fig` = (asp, aspo,
    ...) its figure in y^2) with its intermediates: (y2, m, sq, zy, sqs,
    dzy)."""
    y2 = y*y
    m = 1 - (1 + ky)*cy*cy*y2
    sq = K._sqrt0(m)
    zy = cy*y2/(1 + sq)
    sqs = torch.clamp(sq, min=K.TINY)
    dzy = cy*y/sqs
    if fig is not None:
        asp, aspo = fig[:2]
        if asp.shape[-1]:
            zy = zy + K._poly_even(y2, asp)
            dzy = dzy + y*K._dpoly_even(y2, asp)
        if aspo.shape[-1]:
            zy = zy + K._poly_odd(y2, aspo)
            dzy = dzy + y*K._dpoly_odd(y2, aspo)
    return y2, m, sq, zy, sqs, dzy


def _ycurve_vjp(y, cy, ky, gzy, gdzy, fig=None):
    """Reverse of _ycurve (with `fig` = (asp, aspo, ga, gb) its figure
    in y^2 too: zy + poly(y2), dzy + y D(y2)): the cotangents of (y, cy,
    ky) from those of (zy, dzy)."""
    y2, m, sq, zy, sqs, dzy = _ycurve_fwd(y, cy, ky)
    gcy = gdzy*y/sqs + gzy*y2/(1 + sq)
    gy = gdzy*cy/sqs
    gsq = _floor_vjp(sq, -gdzy*cy*y/(sqs*sqs)) - gzy*cy*y2/((1 + sq)*(1 + sq))
    gy2 = gzy*cy/(1 + sq)
    gm = _sqrt0_vjp(m, sq, gsq)
    gky = -gm*cy*cy*y2
    gcy = gcy - gm*2*(1 + ky)*cy*y2
    gy2 = gy2 - gm*(1 + ky)*cy*cy
    if fig is not None:
        asp, aspo, fa, fb = fig
        gy = gy + gdzy*_figure_slope(y2, asp, aspo)
        gy2 = _figure_sag_vjp(y2, asp, aspo, -gzy, fa, fb, gy2)
        gy2 = _figure_slope_vjp(y2, asp, aspo, -gdzy*y, fa, fb, gy2,
                                asp.shape[-1] > 0, aspo.shape[-1] > 0)
    return gy + 2*y*gy2, gcy, gky


def _toroid_sag_vjp(px, py, cr, cy, ky, gF, fig=None):
    """Reverse of F = pz - zy - crp x^2/(1 + sqrt0(1 - x^2 crp^2)),
    crp = cr/(1 - cr zy) (kernels.sag_toroid; `fig` as _ycurve_vjp's):
    the cotangents of (px, py, cr, cy, ky) from gF (pz's is gF)."""
    zy = _ycurve_fwd(py, cy, ky, fig)[3]
    den = 1 - cr*zy
    crp = cr/den
    x2 = px*px
    u = 1 - x2*crp*crp
    wr = K._sqrt0(u)
    d = 1 + wr
    gt = -gF                        # of crp x2 / d
    gu = _sqrt0_vjp(u, wr, -gt*crp*x2/(d*d))
    gcrp = gt*x2/d - gu*2*x2*crp
    gx2 = gt*crp/d - gu*crp*crp
    gden = -gcrp*cr/(den*den)
    gcr = gcrp/den - gden*zy
    gy, gcy, gky = _ycurve_vjp(py, cy, ky, -gF - gden*cr, 0., fig)
    return 2*px*gx2, gy, gcr, gcy, gky


def _toroid_normal_vjp(x, y, cr, cy, ky, ggx, ggy, fig=None):
    """Reverse of kernels.normal_toroid (`fig` as _ycurve_vjp's): the
    cotangents of (x, y, cr, cy, ky) from those of (gx, gy)."""
    _, _, _, zy, _, dzy = _ycurve_fwd(y, cy, ky, fig)
    den = 1 - cr*zy
    crp = cr/den
    u = 1 - x*x*crp*crp
    wr = K._sqrt0(u)
    w = torch.clamp(wr, min=K.TINY)
    gx = -ggx*crp/w
    gcrp = -ggx*x/w
    gw = (ggx*x*crp + ggy*dzy)/(w*w)
    gdzy = -ggy/w
    gu = _sqrt0_vjp(u, wr, _floor_vjp(wr, gw))
    gx = gx - gu*2*x*crp*crp
    gcrp = gcrp - gu*2*x*x*crp
    gden = -gcrp*cr/(den*den)
    gcr = gcrp/den - gden*zy
    gy, gcy, gky = _ycurve_vjp(y, cy, ky, -gden*cr, gdzy, fig)
    return gx, gy, gcr, gcy, gky


def _general_normal(spec, x, y, c, k, cx, kx, asp=None, aspo=None):
    """The (gx, gy) normal of a biconic or toroid row (with asp, aspo
    its aspheric figure)."""
    if spec.toroidal:
        return K.normal_toroid(x, y, cx, c, k, asp, aspo)
    return K.normal_biconic(x, y, cx, kx, c, k, asp, aspo)


def _anamorphic_vjp_reference(state, surf, spec, g, ct_path=None,
                              out=None):
    """Hand-derived reverse of an anamorphic row's step (kernels.
    surface_step_spec with spec.cyl_axis, spec.biconic or spec.toroidal;
    a biconic or toroid also with an aspheric figure) for live rays, the
    line-for-line model of `anamorphic_step_vjp` in csrc/step_vjp.cuh.
    A cylinder reverses its closed form in its one curved coordinate w
    (y for cyl_axis 1, x for 2) and refracts by the normal (-C w, 1 -
    (1+K) C z); a biconic or toroid refracts by its (gx, gy, 1) normal,
    then its Newton root is differentiated implicitly, dF/dp scaled by
    -gt/F_s (kernels._NewtonRoot).  A grating or DOE on a cylinder
    reverses the phase solve on the normal of the biconic or toroid that
    made it, then the cylinder's closed form.  The row reads (C, K) =
    (c, k) on a y-cylinder, (c + curvature_dx, k + conic_dx) on an
    x-cylinder, (cx, kx, cy, ky) = (c + curvature_dx, k + conic_dx, c,
    k) on a biconic and (cr, cy, ky) = (c + curvature_dx, c, k) on a
    toroid; a biconic or toroid, figured or not (a phase cylinder's
    normal too), every coefficient of the table's widths (a biconic's in
    r^2, a toroid's in y^2).  With ct_path (K9's PATH) the row's optical
    path t * n_before first adds ct_path * n_before to gt, and n_before
    takes ct_path * t.  Returns the entering state's cotangent and the
    per-ray parameter cotangents (c, k, offset x, y, z, mu, with ct_path
    n_before, a biconic's or toroid's na even and no odd coefficients,
    then curvature_dx and conic_dx, then a phase row's, then with `out` a
    rotated row's rotation, _step_vjp_reference)."""
    rot_g = out is not None and spec.rotated
    x, y, z, ux, uy, uz = state
    zero = torch.zeros_like(x)
    c, k, mu = surf.curvature, surf.conic, surf.mu
    cx, kx = c + surf.curvature_dx, k + surf.conic_dx
    # a biconic's or toroid's Newton reads every coefficient of the
    # table's widths, figured or not (kernels.reads_figure)
    figured = K.reads_figure(spec) and bool(
        surf.aspherics.shape[-1] + surf.aspherics_odd.shape[-1])
    asp, aspo = ((surf.aspherics, surf.aspherics_odd) if figured
                 else (None, None))
    ga = [zero]*(asp.shape[-1] if figured else 0)
    gb = [zero]*(aspo.shape[-1] if figured else 0)
    fig = (asp, aspo, ga, gb) if figured else None
    # ---- forward recompute ----
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
    e0 = (x, y, z, ux, uy, uz)
    if spec.rotated:
        r = surf.rot
        x, y, z = K.rot_apply(r, x, y, z)
        ux, uy, uz = K.rot_apply(r, ux, uy, uz)
    cyl = spec.cyl_axis
    if cyl:
        cc, kk = (c, k) if cyl == 1 else (cx, kx)
        w, uw = (y, uy) if cyl == 1 else (x, ux)
        k1 = 1 + kk
        uyd = uw*w + k1*uz*z
        uu = uw*uw + k1*uz*uz
        yy = w*w + k1*z*z
        d = cc*uyd - uz
        e = cc*uu
        f = cc*yy - 2*z
        sg = -1. if spec.alternate else 1.
        sq = K._sqrt0(d*d - e*f)
        q = sg*sq
        conj = (d*q <= 0) | (e == 0)
        den = torch.where(conj, q - d, e)
        den = torch.where(den == 0, 1., den)
        t = torch.where(conj, f, -(d + q))/den
    elif spec.toroidal:
        t = K.intercept_toroid(x, y, z, ux, uy, uz, cx, c, k, asp,
                               surf.alternate, aspherics_odd=aspo)
    else:
        t = K.intercept_biconic(x, y, z, ux, uy, uz, cx, kx, c, k, asp,
                                surf.alternate, aspherics_odd=aspo)
    x1, y1, z1 = x + t*ux, y + t*uy, z + t*uz
    # ---- reverse: leave the row's frame ----
    pr = _rot_leave_vjp(r, out, g) if rot_g else []
    gx1, gy1, gz1, gvx, gvy, gvz = g
    if spec.rotated:
        gx1, gy1, gz1 = K.rot_apply(r, gx1, gy1, gz1)
        gvx, gvy, gvz = K.rot_apply(r, gvx, gvy, gvz)
    gmu = zero
    # the figure's parameter cotangents: (cx, kx, cy, ky) of a biconic,
    # (cr, cy, ky) of a toroid (gp[3] unused), and (C, K) of a cylinder
    gp = [zero, zero, zero, zero]
    gck = [zero, zero]
    phase = ()
    # ---- reverse: refraction ----
    if K.is_phase(spec):
        # the grating/phase solve on the biconic or toroid normal (a
        # cylinder's: the one that made it)
        gdy, doe = _phase_row(surf, spec)
        ngx, ngy = _general_normal(spec, x1, y1, c, k, cx, kx, asp, aspo)
        (gux, guy, guz), (ggx, ggy), gmu, ggdy, gdoe, dx1, dy1 = \
            _grating_refract_vjp(x1, y1, (ux, uy, uz), mu, gdy, ngx, ngy, doe,
                                 (gvx, gvy, gvz))
        if spec.toroidal:
            dx, dy, *dp = _toroid_normal_vjp(x1, y1, cx, c, k, ggx, ggy, fig)
        else:
            dx, dy, *dp = _biconic_normal_vjp(x1, y1, cx, kx, c, k, ggx, ggy,
                                              fig)
        gx1, gy1 = gx1 + dx1 + dx, gy1 + dy1 + dy
        gp = [a + b for a, b in zip(gp, dp)] + gp[len(dp):]
        gna, gdoe, gx1, gy1 = _doe_path_vjp(surf, spec, x1, y1, ct_path,
                                            gdoe, gx1, gy1)
        phase = _phase_tail(surf, spec, ggdy, gdoe, gna)
    elif spec.kind == 0:
        gux, guy, guz = gvx, gvy, gvz
    elif cyl:
        w1 = y1 if cyl == 1 else x1
        kc = (1 + kk)*cc
        nw, nz = -cc*w1, 1. - kc*z1
        n = (zero, nw, nz) if cyl == 1 else (nw, zero, nz)
        (gux, guy, guz), gn, gmu = _refraction_vjp(
            spec.kind, False, mu, (ux, uy, uz), n, (gvx, gvy, gvz))
        gnw, gnz = gn[cyl % 2], gn[2]
        gck[1] = gck[1] - cc*z1*gnz
        gck[0] = gck[0] - w1*gnw - (1 + kk)*z1*gnz
        if cyl == 1:
            gy1 = gy1 - cc*gnw
        else:
            gx1 = gx1 - cc*gnw
        gz1 = gz1 - kc*gnz
    else:
        ngx, ngy = _general_normal(spec, x1, y1, c, k, cx, kx, asp, aspo)
        (gux, guy, guz), (ggx, ggy, _), gmu = _refraction_vjp(
            spec.kind, False, mu, (ux, uy, uz), (ngx, ngy, 1.),
            (gvx, gvy, gvz))
        if spec.kind == 2:
            # _refract_general reflects by a = |mu| (u . n)/|n|^2 with
            # |mu| = 1: mu's cotangent is sign(mu) d/d|mu|
            nn = ngx*ngx + ngy*ngy + 1.
            gmu = -torch.sign(mu)*2*(ux*ngx + uy*ngy + uz)/nn \
                * (gvx*ngx + gvy*ngy + gvz)
        if spec.toroidal:
            dx, dy, *dp = _toroid_normal_vjp(x1, y1, cx, c, k, ggx, ggy, fig)
        else:
            dx, dy, *dp = _biconic_normal_vjp(x1, y1, cx, kx, c, k, ggx, ggy,
                                              fig)
        gx1, gy1 = gx1 + dx, gy1 + dy
        gp = [a + b for a, b in zip(gp, dp)] + gp[len(dp):]
    # ---- reverse: transfer x1 = x + t u ----
    gx, gy, gz = gx1, gy1, gz1
    gux, guy, guz = gux + t*gx1, guy + t*gy1, guz + t*gz1
    gt = ux*gx1 + uy*gy1 + uz*gz1
    if ct_path is not None:
        gt = gt + ct_path*surf.n_before
        gnb = ct_path*t
    # ---- reverse: intercept ----
    if cyl:
        dd = torch.where(conj & (q != d), gt*f/(den*den), 0.)
        gf = torch.where(conj, gt/den, 0.)
        gd = torch.where(conj, dd, -gt/den)
        gq = torch.where(conj, -dd, -gt/den)
        ge = torch.where(conj, 0., gt*(d + q)/(den*den))
        gdisc = gq*sg*.5/sq
        gd = gd + 2*d*gdisc
        ge = ge - f*gdisc
        gf = gf - e*gdisc
        gck[0] = gck[0] + yy*gf + uu*ge + uyd*gd
        gyy, guyd, guu = cc*gf, cc*gd, cc*ge
        gz = gz - 2*gf + 2*k1*z*gyy + k1*uz*guyd
        guz = guz - gd + k1*z*guyd + 2*k1*uz*guu
        gw = 2*w*gyy + uw*guyd
        guw = w*guyd + 2*uw*guu
        gck[1] = gck[1] + z*z*gyy + uz*uz*guu + uz*z*guyd
        if cyl == 1:
            gy, guy = gy + gw, guy + guw
        else:
            gx, gux = gx + gw, gux + guw
    else:
        # the Newton root, implicitly: dF/dp * (-gt/F_s)
        px, py = x + t*ux, y + t*uy
        ngx, ngy = _general_normal(spec, px, py, c, k, cx, kx, asp, aspo)
        fs = ux*ngx + uy*ngy + uz
        gF = -gt/torch.where(fs == 0, 1., fs)
        if spec.toroidal:
            gpx, gpy, *dp = _toroid_sag_vjp(px, py, cx, c, k, gF, fig)
        else:
            gpx, gpy, *dp = _biconic_sag_vjp(px, py, cx, kx, c, k, gF, fig)
        gp = [a + b for a, b in zip(gp, dp)] + gp[len(dp):]
        gx, gy, gz = gx + gpx, gy + gpy, gz + gF
        gux, guy, guz = gux + t*gpx, guy + t*gpy, guz + t*gF
    # ---- reverse: enter the row's frame ----
    if rot_g:
        pr = _rot_enter_vjp(pr, e0, (gx, gy, gz, gux, guy, guz))
    if spec.rotated:
        gx, gy, gz = K.rot_apply_t(r, gx, gy, gz)
        gux, guy, guz = K.rot_apply_t(r, gux, guy, guz)
    # the figure's parameters onto the table's
    if cyl and K.is_phase(spec):
        # (C, K) is (c, k) in y, (c + cdx, k + kdx) in x; the normal's
        # as a toroid's (cr = c + cdx) or a biconic's
        if spec.toroidal:
            gc, gk = gck[0] + (gp[0] + gp[1]), gck[1] + gp[2]
            gcdx, gkdx = gp[0], zero
        else:
            gc, gk = gck[0] + (gp[0] + gp[2]), gck[1] + (gp[1] + gp[3])
            gcdx, gkdx = ((gp[0], gp[1]) if cyl == 1
                          else (gck[0] + gp[0], gck[1] + gp[1]))
    elif cyl == 1:
        gc, gk, gcdx, gkdx = gck[0], gck[1], zero, zero
    elif cyl == 2:
        gc, gk, gcdx, gkdx = gck[0], gck[1], gck[0], gck[1]
    elif spec.toroidal:
        gc, gk, gcdx, gkdx = gp[0] + gp[1], gp[2], gp[0], zero
    else:
        gc, gk, gcdx, gkdx = gp[0] + gp[2], gp[1] + gp[3], gp[0], gp[1]
    gox = -gx if spec.off_axis else zero
    goy = -gy if spec.off_axis else zero
    nb = () if ct_path is None else (gnb,)
    return ((gx, gy, gz, gux, guy, guz),
            (gc, gk, gox, goy, -gz, gmu, *nb, *ga, *gb, gcdx, gkdx, *phase,
             *pr))


def _merit_adjoint_by_hand(table, specs, state, w, ct, clip=False,
                           rot=False):
    """K5 written in torch with _step_vjp_reference, the model of
    `moments_adjoint_ray` in csrc/grad_spec.cuh: same outputs as
    merit_adjoint_reference (with `rot`, a rot key's: each rotated row's
    rotation from the state leaving it, the image row's with the moment
    frame's second use)."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    nsurf = tab.nsurfaces
    s = tuple(state)
    if specs[0].rotated:
        r0 = tab.rot[0]
        s = (*K.rot_apply_t(r0, *s[:3]), *K.rot_apply_t(r0, *s[3:]))
    saved = [None]
    for j in range(1, nsurf):
        saved.append(s)
        s, _ = K.surface_step_spec(s, tab.row(j), specs[j], clip)
    saved.append(s)
    rl = tab.rot[nsurf - 1]
    last_rot = specs[nsurf - 1].rotated
    if last_rot:
        s = (*K.rot_apply(rl, *s[:3]), *K.rot_apply(rl, *s[3:]))
    x, y = s[0], s[1]
    live = _live(s)
    ct0, ct1, ct2, ct3, ct4 = ct
    ctx = w*(ct1 + 2*x*ct3)
    cty = w*(ct2 + 2*y*ct4)
    ct_w = torch.where(live, ct0 + x*ct1 + y*ct2 + x*x*ct3 + y*y*ct4, 0.)
    zero = torch.zeros_like(x0)
    pg = torch.zeros((nsurf, _nslots(tab, specs, rot=rot)), dtype=x0.dtype,
                     device=x0.device)
    if rot and last_rot:
        # the moment frame (x, y) = (R s)[0..1] reads the image row's
        # rotation a second time
        sf = saved[nsurf]
        pr = [v*sf[q] for v in (ctx, cty) for q in range(3)]
        pg[nsurf - 1, -ROT:-3] = torch.stack(
            [torch.where(live, v, 0.).sum() for v in pr])
    g3 = (K.rot_apply_t(rl, ctx, cty, zero)
          if last_rot else (ctx, cty, zero))
    g = tuple(torch.where(live, v, 0.) for v in (*g3, zero, zero, zero))
    nd = _phase_layout(tab, specs)[1]
    nxy = xy_width(tab, specs)
    for j in range(nsurf - 1, 0, -1):
        g, pj = _step_vjp_reference(saved[j], tab.row(j), specs[j], g,
                                    out=saved[j + 1] if rot else None)
        g = tuple(torch.where(live, v, 0.) for v in g)
        _put_row(pg, j, specs[j], pj, live, specs, nd=nd, nxy=nxy, rot=rot)
    if specs[0].rotated:
        g = (*K.rot_apply(r0, *g[:3]), *K.rot_apply(r0, *g[3:]))
    return pg, g, ct_w


def _put_row(pg, j, spec, pj, live, specs, base=SLOTS, nd=0, nxy=0,
             rot=False):
    """Row j of the by-hand models' parameter cotangents: the sums over
    the live rays of _step_vjp_reference's per-ray ones (a row that
    reads no figure has no aspheric slots: zeros; an anamorphic row's
    curvature_dx and conic_dx follow the coefficients; a phase row's
    grating_dy, then (K9, base OPD_SLOTS) n_after, then its nd DOE
    coefficients; a freeform row's nxy XY coefficients come next; with
    `rot` a rotated row's rotation last, added to what the row holds
    there)."""
    if rot:
        if spec.rotated:
            pg[j, -ROT:] += torch.stack([torch.where(live, v, 0.).sum()
                                         for v in pj[-ROT:]])
            pj = pj[:-ROT]
        pg = pg[:, :-ROT]
    sums = torch.stack([torch.where(live, v, 0.).sum() for v in pj])
    if spec.freeform and nxy:
        pg[j, pg.shape[-1] - nxy:] = sums[len(pj) - nxy:]
        sums, pj = sums[:len(pj) - nxy], pj[:len(pj) - nxy]
    anam = carries_anamorphic(specs)
    grating = carries_grating(specs)
    # the DOE block: K9's n_after, then the coefficients
    ndoe = nd + int(base == OPD_SLOTS) if nd else 0
    q = pg.shape[-1] - nxy - int(grating) - ndoe - (ANAM if anam else 0)
    nph = (1 + (ndoe if spec.doe else 0)) if K.is_phase(spec) else 0
    head = len(pj) - nph - (ANAM if K.is_anamorphic_spec(spec) else 0)
    pg[j, :head] = sums[:head]
    if K.is_anamorphic_spec(spec):
        pg[j, q:q + ANAM] = sums[head:head + ANAM]
    if nph:
        q = pg.shape[-1] - nxy - ndoe
        if grating:
            pg[j, q - 1] = sums[-nph]
        if spec.doe:
            pg[j, q:q + ndoe] = sums[-ndoe:]


def _merit_adjoint_multi_by_hand(tables, specs, state, w, ct, clip=False,
                                 rot=False):
    """K7 written in torch: the K5 model run once per table of the stack
    on the same state (each table's dead rays zeroed for it alone), the
    ray and weight cotangents summed over the tables in order, the model
    of `merit_adjoint_multi_spec` in csrc/grad_spec.cuh; same outputs as
    merit_adjoint_multi_reference."""
    return _sum_over_tables(_merit_adjoint_by_hand, tables, specs, state,
                            w, ct, clip, rot)


def _opd_tail_vjp_reference(surf, spec, o, ct_q, ct_lx, ct_ly, state=None):
    """Hand-derived reverse of the sphere tail for live rays, the
    line-for-line model of `sphere_tail_vjp` in csrc/step_vjp.cuh.  o: the
    tail's intermediates (_sphere_tail); ct_q, ct_lx, ct_ly: the
    cotangents of q = ti * n_image and of the landing x, y; state: the
    state leaving row S-2 (a rot key's, whose rotated image row returns
    its rotation's nine cotangents last), or None.  Returns (cotangent of
    the state leaving row S-2, the image row's per-ray parameter
    cotangents (OPD_SLOTS [+ ROT]), the centre cotangents (3))."""
    zero = torch.zeros_like(o.ti)
    gti = ct_q*surf.n_before + ct_lx*o.dx + ct_ly*o.dy
    gpx, gpy, gpz = ct_lx, ct_ly, zero
    gdx, gdy, gdz = ct_lx*o.ti, ct_ly*o.ti, zero
    gd = -gti/o.e
    gsq = gd
    ge = gti*(o.d + o.sq)/(o.e*o.e)
    gdisc = gsq*.5/o.sq
    gd = gd + 2*o.d*gdisc
    ge = ge - o.f*gdisc
    gf = -o.e*gdisc
    guyd, guu, gyy = o.cc*gd, o.cc*ge, o.cc*gf
    gdz = gdz - gd
    gpz = gpz - 2*gf
    gdx = gdx + o.px*guyd + 2*o.dx*guu
    gdy = gdy + o.py*guyd + 2*o.dy*guu
    gdz = gdz + o.pz*guyd + 2*o.dz*guu
    gpx = gpx + o.dx*guyd + 2*o.px*gyy
    gpy = gpy + o.dy*guyd + 2*o.py*gyy
    gpz = gpz + o.dz*guyd + 2*o.pz*gyy
    gc = (-gpx, -gpy, -gpz)
    pr = []
    if state is not None and spec.rotated:
        # the image row's frame, entered from the state leaving row S-2
        e0 = [state[0], state[1], state[2] - surf.offset[2], *state[3:]]
        if spec.off_axis:
            e0[0] = e0[0] - surf.offset[0]
            e0[1] = e0[1] - surf.offset[1]
        pr = _rot_enter_vjp([zero]*ROT, e0, (gpx, gpy, gpz, gdx, gdy, gdz))
    if spec.rotated:
        gpx, gpy, gpz = K.rot_apply_t(surf.rot, gpx, gpy, gpz)
        gdx, gdy, gdz = K.rot_apply_t(surf.rot, gdx, gdy, gdz)
    pg = (zero, zero, -gpx if spec.off_axis else zero,
          -gpy if spec.off_axis else zero, -gpz, zero, ct_q*o.ti)
    return (gpx, gpy, gpz, gdx, gdy, gdz), pg + tuple(pr), gc


def _opd_adjoint_by_hand(table, specs, state, aux, cts, clip=False,
                        rot=False):
    """K9 written in torch with _opd_tail_vjp_reference and
    _step_vjp_reference(ct_path=), the model of `opd_adjoint_spec` in
    csrc/grad_spec.cuh: same outputs as opd_adjoint_reference (with
    `rot`, a rot key's: each rotated row's rotation, the image row's
    from the tail)."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    nsurf = tab.nsurfaces
    (k, _, _), saved, o = _opd_chain(tab, specs, state, aux, clip)
    live = torch.isfinite(k)
    ct_k, ct_lx, ct_ly = (torch.where(live, c, 0.) for c in cts)
    ct_path = -ct_k/aux[4]
    g, pj, gc = _opd_tail_vjp_reference(tab.row(nsurf - 1), specs[nsurf - 1],
                                        o, ct_path, ct_lx, ct_ly,
                                        saved[nsurf - 1] if rot else None)
    g = tuple(torch.where(live, v, 0.) for v in g)
    pg = torch.zeros((nsurf, _nslots(tab, specs, OPD_SLOTS, rot)),
                     dtype=x0.dtype, device=x0.device)
    nd = _phase_layout(tab, specs)[1]
    nxy = xy_width(tab, specs)
    sums = torch.stack([torch.where(live, v, 0.).sum() for v in pj])
    pg[nsurf - 1, :OPD_SLOTS] = sums[:OPD_SLOTS]
    if len(pj) > OPD_SLOTS:
        pg[nsurf - 1, -ROT:] = sums[OPD_SLOTS:]
    gcen = torch.stack([torch.where(live, v, 0.).sum() for v in gc])
    for j in range(nsurf - 2, 0, -1):
        g, pj = _step_vjp_reference(saved[j], tab.row(j), specs[j], g,
                                    ct_path=ct_path,
                                    out=saved[j + 1] if rot else None)
        g = tuple(torch.where(live, v, 0.) for v in g)
        _put_row(pg, j, specs[j], pj, live, specs, OPD_SLOTS, nd, nxy, rot)
    if specs[0].rotated:
        r0 = tab.rot[0]
        g = (*K.rot_apply(r0, *g[:3]), *K.rot_apply(r0, *g[3:]))
    return pg, g, gcen


# -- the CUDA wrappers ---------------------------------------------------

def _check_vector(v, state, name, shape=None):
    x = state[0]
    shape = (x.shape[0],) if shape is None else tuple(shape)
    if v.device != x.device or v.dtype != x.dtype:
        raise ValueError("%s must share the rays' device and dtype (%s %s "
                         "vs %s %s)" % (name, v.device, v.dtype, x.device,
                                        x.dtype))
    if tuple(v.shape) != shape or not v.is_contiguous():
        raise ValueError("%s must be a contiguous %s tensor, got %s"
                         % (name, shape, tuple(v.shape)))


@functools.lru_cache(maxsize=None)
def _moments_kernel(specs, dtype, clip, widths, nd=0, nxy=0):
    return CS.load(CS.moments_key(specs, dtype, clip, widths=widths, nd=nd,
                                  nxy=nxy))


@functools.lru_cache(maxsize=None)
def _moments_multi_kernel(specs, dtype, clip, nlam, widths=(0, 0), nd=0,
                          nxy=0):
    return CS.load(CS.moments_multi_key(specs, dtype, clip, nlam,
                                        widths=widths, nd=nd, nxy=nxy))


@functools.lru_cache(maxsize=None)
def _adjoint_kernel(specs, dtype, clip, fields, rays, widths, nd=0, nxy=0):
    return CS.load(CS.adjoint_key(specs, dtype, clip, fields, rays,
                                  widths=widths, nd=nd, nxy=nxy))


@functools.lru_cache(maxsize=None)
def _adjoint_multi_kernel(specs, dtype, clip, fields, rays, widths=(0, 0),
                          nd=0, nxy=0):
    return CS.load(CS.adjoint_multi_key(specs, dtype, clip, fields, rays,
                                        widths=widths, nd=nd, nxy=nxy))


@functools.lru_cache(maxsize=None)
def _opd_kernel(specs, dtype, clip, widths=(0, 0), nd=0, nxy=0):
    return CS.load(CS.opd_key(specs, dtype, clip, widths=widths, nd=nd,
                              nxy=nxy))


@functools.lru_cache(maxsize=None)
def _opd_adjoint_kernel(specs, dtype, clip, fields, rays, widths=(0, 0),
                        nd=0, nxy=0):
    return CS.load(CS.opd_adjoint_key(specs, dtype, clip, fields, rays,
                                      widths=widths, nd=nd, nxy=nxy))


def weighted_moments(table, specs, state, w, clip=False):
    """K4: the (5,) weighted moments (sum w, sum wx, sum wy, sum wx^2,
    sum wy^2) over live rays, in the rays' dtype.  CUDA bundles launch
    the kernel compiled for (dtype, specs, clip) (ops.cuda_spec: one
    launch, the grid-wide sum fused); CPU bundles take
    weighted_moments_reference."""
    _check_state(state)
    _check_vector(w, state, "w")
    x = state[0]
    if x.device.type == "cpu":
        return weighted_moments_reference(table, specs, state, w, clip)
    spec_launch(state)
    specs = tuple(specs)
    out = launch_moments(_moments_kernel(specs, x.dtype, bool(clip),
                                         figure_widths(table, specs),
                                         doe_width(table, specs),
                                         xy_width(table, specs)),
                         table, specs, state, w)
    if x.shape[0]:
        weighted_moments.launches += 1
    return out[0]


weighted_moments.launches = 0


def merit_adjoint(table, specs, state, w, ct, clip=False, fields=CS.FIELDS,
                  rays=True):
    """K5: (parameter cotangents (S, _nslots): c, k,
    offset x, y, z, mu, then the table's na even and no odd aspheric
    coefficients, then for anamorphic specs (cuda_trace.
    carries_anamorphic) curvature_dx and conic_dx, then a phase table's
    grating_dy and DOE coefficients, then a freeform table's XY
    coefficients, then with "rot" in `fields` and a rotated row
    (cuda_spec.carries_rot) the rotation, row-major; the six state
    cotangents; the weight cotangent) of
    the weighted moments dotted with `ct`, a (5,) tensor of moment
    cotangents on the rays' device.  `fields`: the table fields whose
    cotangents are wanted; a slot outside them, or baked out by the
    specs (cuda_spec.live_slots: an aspheric coefficient is live only
    on an aspheric row, a rotation on a rotated row), is an exact
    zero.  rays=False: the state and
    weight cotangents are not computed and come back as None.  CUDA
    bundles launch the kernel compiled for (dtype, specs, clip, live
    slots, rays, aspheric widths) (ops.cuda_spec: one launch, the
    grid-wide sum fused, nothing written a ray without `rays`); CPU
    bundles take merit_adjoint_reference."""
    _check_state(state)
    _check_vector(w, state, "w")
    _check_vector(ct, state, "ct", (5,))
    x = state[0]
    specs, fields = tuple(specs), tuple(fields)
    na, no = _table_widths(table)
    rot = CS.carries_rot(specs, fields)
    nq = _nslots(table, specs, rot=rot)
    if x.device.type == "cpu":
        pg, st, gw = merit_adjoint_reference(table, specs, state, w, ct,
                                             clip, rot)
        live = CS.live_mask(CS.live_slots(specs, fields, (na, no),
                                          doe_width(table, specs),
                                          xy_width(table, specs)), nq)
        pg = torch.where(live, pg, 0.)
        return (pg, st, gw) if rays else (pg, None, None)
    device, n, stream = spec_launch(state)
    widths = figure_widths(table, specs)
    kern = _adjoint_kernel(specs, x.dtype, bool(clip), fields, bool(rays),
                           widths, doe_width(table, specs),
                           xy_width(table, specs))
    tab = packed(table, specs, x)
    if not n:
        pg = torch.zeros((len(specs), nq), dtype=x.dtype, device=device)
        return (pg, tuple(torch.zeros_like(x) for _ in range(6)),
                torch.zeros_like(x)) if rays else (pg, None, None)
    grid = kern.grid(n, device)
    pg = torch.empty((len(specs), kern.key.slots), dtype=x.dtype,
                     device=device)
    partials = torch.empty((grid, max(kern.key.nlive, 1)), dtype=x.dtype,
                           device=device)
    outs = [torch.empty_like(x) for _ in range(7)] if rays else None
    kern.check(kern.fn(tab.data_ptr(), *(c.data_ptr() for c in state),
                       w.data_ptr(), ct.data_ptr(), partials.data_ptr(),
                       CS.counter(device).data_ptr(), pg.data_ptr(),
                       *((o.data_ptr() for o in outs) if rays
                         else (None,)*7), n, grid, stream))
    merit_adjoint.launches += 1
    merit_adjoint.rot_launches += int(rot)
    pg = _key_columns(pg, kern.key, nq)
    if not rays:
        return pg, None, None
    return pg, tuple(outs[:6]), outs[6]


merit_adjoint.launches = 0
merit_adjoint.rot_launches = 0


def _moments_multi_runs(specs, dtype, clip, nlam, widths=(0, 0), nd=0,
                        nxy=0):
    """K6's launches for a stack of nlam tables (`widths` the stack's,
    figure_widths; `nd` its doe_width, `nxy` its xy_width): (l0, l1,
    loaded key) of each balanced run of at most cuda_spec.multi_most
    wavelengths (MAX_NLAM, fewer where the tables outgrow static shared
    memory; cuda_spec.runs: 12 -> 6 + 6, 13 -> 7 + 6)."""
    most = CS.multi_most("k6", specs, dtype, widths=widths, nd=nd, nxy=nxy)
    if most < 1:
        # raises, saying why
        CS.moments_multi_key(specs, dtype, clip, 1, widths=widths, nd=nd,
                             nxy=nxy)
    return [(l0, l1, _moments_multi_kernel(specs, dtype, clip, l1 - l0,
                                           widths, nd, nxy))
            for l0, l1 in CS.runs(nlam, most)]


def weighted_moments_multi(tables, specs, state, w, clip=False):
    """K6: the (nlam, 5) weighted moments of each table of a stack
    (leading wavelength axis) over its live rays, in the rays' dtype;
    `specs` those of the first wavelength (cuda_trace.multi_specs).
    CUDA bundles launch the kernel compiled for (dtype, specs, clip,
    nlam) (ops.cuda_spec: one launch, the wavelengths unrolled, the
    grid-wide sum fused), one bundle read once; a stack past MAX_NLAM
    in balanced runs, one launch each, the moments concatenated in
    wavelength order (each wavelength's are independent).  CPU bundles
    take weighted_moments_multi_reference."""
    _check_state(state)
    _check_vector(w, state, "w")
    x = state[0]
    if x.device.type == "cpu":
        return weighted_moments_multi_reference(tables, specs, state, w,
                                                clip)
    spec_launch(state)
    specs = tuple(specs)
    runs = _moments_multi_runs(specs, x.dtype, bool(clip),
                               tables.curvature.shape[0],
                               figure_widths(tables, specs),
                               doe_width(tables, specs),
                               xy_width(tables, specs))
    outs = [launch_moments(kern, table_at(tables, slice(l0, l1)), specs,
                           state, w) for l0, l1, kern in runs]
    if x.shape[0]:
        weighted_moments_multi.launches += len(runs)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


weighted_moments_multi.launches = 0


def merit_adjoint_multi(tables, specs, state, w, ct, clip=False,
                        fields=CS.FIELDS, rays=True):
    """K7: (parameter cotangents (nlam, S, _nslots) per table of the
    stack, in merit_adjoint's columns -- a phase table's grating_dy and
    DOE coefficients, a freeform table's XY coefficients and a rot key's
    rotation too, each table's own; the six state cotangents and
    the weight cotangent, each summed over the tables) of the (nlam, 5)
    weighted moments dotted with `ct`, an (nlam, 5) tensor of moment
    cotangents on the rays' device.  `fields` and `rays` as
    merit_adjoint's: a slot outside the fields or baked out by the specs
    is an exact zero; rays=False returns None for the state and weight
    cotangents.  CUDA bundles launch the kernel compiled for (dtype,
    specs, clip, live slots, rays, aspheric widths) (ops.cuda_spec: one
    launch, the wavelengths a run-time argument, the grid-wide sums
    fused); CPU bundles take merit_adjoint_multi_reference."""
    nlam = tables.curvature.shape[0]
    _check_state(state)
    _check_vector(w, state, "w")
    _check_vector(ct, state, "ct", (nlam, 5))
    x = state[0]
    specs, fields = tuple(specs), tuple(fields)
    na, no = _table_widths(tables)
    rot = CS.carries_rot(specs, fields)
    nq = _nslots(tables, specs, rot=rot)
    if x.device.type == "cpu":
        pg, st, gw = merit_adjoint_multi_reference(tables, specs, state, w,
                                                   ct, clip, rot)
        live = CS.live_mask(CS.live_slots(specs, fields, (na, no),
                                          doe_width(tables, specs),
                                          xy_width(tables, specs)), nq)
        pg = torch.where(live, pg, 0.)
        return (pg, st, gw) if rays else (pg, None, None)
    device, n, stream = spec_launch(state)
    kern = _adjoint_multi_kernel(specs, x.dtype, bool(clip), fields,
                                 bool(rays), figure_widths(tables, specs),
                                 doe_width(tables, specs),
                                 xy_width(tables, specs))
    tab = packed(tables, specs, x)
    if not n:
        pg = torch.zeros((nlam, len(specs), nq), dtype=x.dtype,
                         device=device)
        return (pg, tuple(torch.zeros_like(x) for _ in range(6)),
                torch.zeros_like(x)) if rays else (pg, None, None)
    grid = kern.grid(n, device)
    pg = torch.empty((nlam, len(specs), kern.key.slots), dtype=x.dtype,
                     device=device)
    partials = torch.empty((grid, max(nlam*kern.key.nlive, 1)),
                           dtype=x.dtype, device=device)
    outs = [torch.empty_like(x) for _ in range(7)] if rays else None
    kern.check(kern.fn(tab.data_ptr(), *(c.data_ptr() for c in state),
                       w.data_ptr(), ct.data_ptr(), partials.data_ptr(),
                       CS.counter(device).data_ptr(), pg.data_ptr(),
                       *((o.data_ptr() for o in outs) if rays
                         else (None,)*7), n, nlam, grid, stream))
    merit_adjoint_multi.launches += 1
    merit_adjoint_multi.rot_launches += int(rot)
    pg = _key_columns(pg, kern.key, nq)
    if not rays:
        return pg, None, None
    return pg, tuple(outs[:6]), outs[6]


merit_adjoint_multi.launches = 0
merit_adjoint_multi.rot_launches = 0


def opd_chain(table, specs, state, aux, clip=False):
    """K8: (k, lx, ly), each (N,) in the rays' dtype, for aux = (centre
    x, y, z, radius, lam_scale), a (5,) tensor on the rays' device
    (k = -(optical path to the reference sphere)/lam_scale; lx, ly the
    landing on the sphere about its centre).  CUDA bundles launch the
    kernel compiled for (dtype, specs, clip, aspheric widths)
    (ops.cuda_spec: one launch, none for no rays); CPU bundles take
    opd_chain_reference."""
    _check_opd(specs, state, aux)
    x = state[0]
    if x.device.type == "cpu":
        return opd_chain_reference(table, specs, state, aux, clip)
    device, n, stream = spec_launch(state)
    specs = tuple(specs)
    kern = _opd_kernel(specs, x.dtype, bool(clip),
                       figure_widths(table, specs), doe_width(table, specs),
                       xy_width(table, specs))
    tab = packed(table, specs, x)
    outs = [torch.empty_like(x) for _ in range(3)]
    if n:
        kern.check(kern.fn(tab.data_ptr(), *(c.data_ptr() for c in state),
                           aux.data_ptr(), *(o.data_ptr() for o in outs), n,
                           kern.grid(n, device), stream))
        opd_chain.launches += 1
    return tuple(outs)


opd_chain.launches = 0


def opd_adjoint(table, specs, state, aux, cts, clip=False,
                fields=CS.OPD_DIFF, rays=True):
    """K9: (parameter cotangents (S, _nslots(table, specs, OPD_SLOTS)):
    c, k, offset x, y, z, mu, n_before, then the table's na even and no
    odd aspheric coefficients, then an anamorphic table's curvature_dx
    and conic_dx, a grating table's grating_dy, a DOE table's n_after
    and DOE coefficients, a freeform table's XY coefficients, then with
    "rot" in `fields` and a rotated row (cuda_spec.carries_rot) the
    rotation, row-major, the image row's among them; the six state
    cotangents; the (3,) centre cotangents)
    of K8's outputs dotted with cts = (ct_k, ct_lx, ct_ly), three (N,)
    tensors on the rays' device.  `fields`: the table fields whose
    cotangents are wanted; a slot outside them, or never read by the
    specialized chain (cuda_spec.opd_live_slots: an aspheric coefficient
    is live only on an aspheric row), is an exact zero.  rays=False: the
    state cotangents are not computed and come back as None; the centre
    cotangents always are.  CUDA bundles launch the kernel compiled for
    (dtype, specs, clip, live slots, rays, aspheric widths)
    (ops.cuda_spec: one launch, the grid-wide sum fused); CPU bundles
    take opd_adjoint_reference."""
    _check_opd(specs, state, aux)
    for name, c in zip(("ct_k", "ct_lx", "ct_ly"), cts):
        _check_vector(c, state, name)
    x = state[0]
    specs, fields = tuple(specs), tuple(fields)
    na, no = _table_widths(table)
    rot = CS.carries_rot(specs, fields)
    nq = _nslots(table, specs, OPD_SLOTS, rot)
    if x.device.type == "cpu":
        pg, st, gc = opd_adjoint_reference(table, specs, state, aux, cts,
                                           clip, rot)
        live = CS.live_mask(CS.opd_live_slots(specs, fields, (na, no),
                                              doe_width(table, specs),
                                              xy_width(table, specs)), nq)
        pg = torch.where(live, pg, 0.)
        return (pg, st, gc) if rays else (pg, None, gc)
    device, n, stream = spec_launch(state)
    kern = _opd_adjoint_kernel(specs, x.dtype, bool(clip), fields,
                               bool(rays), figure_widths(table, specs),
                               doe_width(table, specs),
                               xy_width(table, specs))
    tab = packed(table, specs, x)
    nsurf = len(specs)
    # the key's columns: OPD_SLOTS, the coefficients of a figured key,
    # the anamorphic two of an anamorphic one, then the phase columns,
    # then the XY columns, then a rot key's rotation
    kq = kern.key.slots
    if not n:
        out = torch.zeros(nsurf*kq + 3, dtype=x.dtype, device=device)
        st = tuple(torch.zeros_like(x) for _ in range(6)) if rays else None
    else:
        grid = kern.grid(n, device)
        out = torch.empty(nsurf*kq + 3, dtype=x.dtype, device=device)
        partials = torch.empty((grid, kern.key.nlive + 3), dtype=x.dtype,
                               device=device)
        st = tuple(torch.empty_like(x) for _ in range(6)) if rays else None
        kern.check(kern.fn(tab.data_ptr(),
                           *(c.data_ptr() for c in state), aux.data_ptr(),
                           *(c.data_ptr() for c in cts), partials.data_ptr(),
                           CS.counter(device).data_ptr(), out.data_ptr(),
                           *((o.data_ptr() for o in st) if rays
                             else (None,)*6), n, grid, stream))
        opd_adjoint.launches += 1
        opd_adjoint.rot_launches += int(rot)
    pg = _key_columns(out[:nsurf*kq].view(nsurf, kq), kern.key, nq,
                      OPD_SLOTS)
    return pg, st, out[nsurf*kq:]


opd_adjoint.launches = 0
opd_adjoint.rot_launches = 0


# -- the differentiable merit --------------------------------------------

class _SpotMoments(torch.autograd.Function):
    """K4 forward, K5 backward (the reference's custom_vjp _moments);
    with `multi`, a stacked table and K6 forward, K7 backward
    (`_moments_multi`)."""

    @staticmethod
    def forward(ctx, table, specs, clip, multi, *tensors):
        params, state, w = tensors[:_NM], tensors[_NM:_NM + 6], tensors[-1]
        ctx.table, ctx.specs, ctx.clip, ctx.multi = table, specs, clip, multi
        ctx.save_for_backward(*tensors)
        tab = table.replace(**dict(zip(_SPOT, params)))
        fwd = weighted_moments_multi if multi else weighted_moments
        return fwd(tab, specs, state, w, clip)

    @staticmethod
    def backward(ctx, ct):
        tensors = ctx.saved_tensors
        params, state, w = tensors[:_NM], tensors[_NM:_NM + 6], tensors[-1]
        tab = ctx.table.replace(**dict(zip(_SPOT, params)))
        # K5/K7 reduce only the slots autograd asks for, and write the
        # ray and weight cotangents only when they are wanted
        need = dict(zip(_SPOT, ctx.needs_input_grad[4:4 + _NM]))
        fields = tuple(f for f in CS.FIELDS + (CS.ROT_FIELD,) if need[f])
        adjoint = merit_adjoint_multi if ctx.multi else merit_adjoint
        pg, ct_state, ct_w = adjoint(
            tab, ctx.specs, state, w, ct.contiguous(), ctx.clip,
            fields=fields, rays=any(ctx.needs_input_grad[4 + _NM:]))
        if ct_state is None:
            ct_state = (None,)*6
        na, no = params[5].shape[-1], params[6].shape[-1]
        q = SLOTS + na + no
        if carries_anamorphic(ctx.specs):
            # an anamorphic key's curvature_dx and conic_dx columns
            gdx = (pg[..., q], pg[..., q + 1])
            q += ANAM
        else:
            gdx = (torch.zeros_like(params[7]), torch.zeros_like(params[8]))
        # a phase key's grating_dy and DOE columns, last
        grating, nd = _phase_layout(tab, ctx.specs)
        ggdy = pg[..., q] if grating else torch.zeros_like(params[9])
        q += int(grating)
        gdoe = (pg[..., q:q + nd].contiguous() if nd
                else torch.zeros_like(params[10]))
        q += nd
        # a freeform key's XY columns, last
        nxy = xy_width(tab, ctx.specs)
        gxy = (pg[..., q:q + nxy].contiguous() if nxy
               else torch.zeros_like(params[11]))
        # a rot key's rotation, last
        grot = (pg[..., -ROT:].reshape(params[12].shape)
                if CS.carries_rot(ctx.specs, fields)
                else torch.zeros_like(params[12]))
        grads = (pg[..., 0], pg[..., 1], pg[..., 2:5].contiguous(),
                 pg[..., 5], torch.zeros_like(params[4]),
                 pg[..., SLOTS:SLOTS + na].contiguous(),
                 pg[..., SLOTS + na:SLOTS + na + no].contiguous(), *gdx,
                 ggdy, gdoe, gxy, grot)
        return (None, None, None, None, *grads, *ct_state, ct_w)


_baked_out_rows = CS.baked_out_rows


def _warn_baked_params(specs, params):
    """When a table field the caller differentiates (it requires grad
    while the rest of the table does not) has rows the static
    specialization bakes out, say so once -- otherwise an optimizer
    silently never moves that parameter there."""
    traced = [f for f, v in params.items()
              if f not in _NONDIFF and v.requires_grad]
    if len(traced) == sum(1 for f in params if f not in _NONDIFF):
        # EVERY float field is differentiated: a wholesale context
        # (full-table jacobians), not a selection for optimization
        return
    for f in traced:
        rows = _baked_out_rows(specs, f)
        if f == "rot":
            if len(rows) == len(specs) - 1:
                warnings.warn(
                    "adjoint kernel: 'rot' (pose/tilt) requires grad but "
                    "no spec row is rotated -- pose gradients are "
                    "structurally zero; pass diff_pose=True (or "
                    "kernels.with_pose(specs)) to keep the nominal pose "
                    "live", stacklevel=4)
            continue
        if rows:
            detail = (" (transverse x/y components)"
                      if f == "offset" else "")
            warnings.warn(
                "adjoint kernel: '%s' of surface row(s) %s is baked out "
                "by the static specialization%s -- its gradient there is "
                "structurally zero; seed it off the baked point "
                "(respecialize) or use the generic engine"
                % (f, rows, detail), stacklevel=4)


def _warn_diff_params(table, specs):
    """_warn_baked_params over the fields the adjoint merits carry: the
    coefficient tables of nonzero width and, where a row reads it, the
    anamorphic x figure."""
    params = {f: getattr(table, f) for f in _FIELDS
              if f not in ("aspherics", "aspherics_odd")
              or getattr(table, f).shape[-1]}
    if carries_anamorphic(specs):
        params.update({f: getattr(table, f)
                       for f in ("curvature_dx", "conic_dx")
                       if getattr(table, f) is not None})
    if any(K.is_phase(s) for s in specs[1:]):
        params.update({f: getattr(table, f) for f in ("grating_dy", "doe")
                       if getattr(table, f) is not None
                       and getattr(table, f).numel()})
    if any(s.freeform for s in specs[1:]):
        params["xy_poly"] = table.xy_poly
    _warn_baked_params(specs, params)


def _resolve_specs(table, specs, diff_pose):
    """Static specs: derived from the concrete table unless given.  A
    pose that requires grad keeps every row's rotated/off_axis flags
    live (kernels.with_pose), as the reference does for a traced pose;
    diff_pose (True or a row iterable) forces that on given specs."""
    pose_grad = any(f is not None and f.requires_grad
                    for f in (table.tilt, table.decenter))
    if specs is None:
        specs = K.specialize(table)
        if pose_grad and diff_pose is None:
            diff_pose = True
    if diff_pose is not None:
        specs = K.with_pose(specs, None if diff_pose is True else diff_pose)
    return tuple(specs)


def spot_moments(table, state, w, specs=None, clip=False, diff_pose=None):
    """Differentiable weighted spot moments (sum w, sum wx, sum wy,
    sum wx^2, sum wy^2) of the fused trace: K4 forward, K5 backward on
    a CUDA bundle, their plain versions on a CPU bundle.  state: six
    contiguous (N,) components; w: (N,) weights.  Gradients reach the
    table's curvature, conic, offset, mu, aspherics and aspherics_odd
    (n_before: zero), its rot (through tables.lower_pose tilt and
    decenter; a pose that requires grad keeps every row but the
    object's rotated and off axis, diff_pose), the state and the
    weights (see the module docstring)."""
    mom = _moments(table, _resolve_specs(table, specs, diff_pose), state, w,
                   clip, False)
    return tuple(mom[i] for i in range(5))


def spot_moments_multi(tables, state, w, specs=None, clip=False,
                       diff_pose=None):
    """Differentiable per-wavelength weighted spot moments, (nlam, 5),
    of a stacked table (leading wavelength axis): K6 forward, K7
    backward on a CUDA bundle, their plain versions on a CPU bundle.
    The specs are derived from the first table (in float64) unless
    given.  Table-field cotangents stay per wavelength, so a stack
    built differentiably from shared parameters (glass_tables, a
    broadcast geometry) receives their sum through autograd."""
    specs = _resolve_specs(table_at(tables, 0), specs, diff_pose)
    return _moments(tables, specs, state, w, clip, True)


def _moments(table, specs, state, w, clip, multi):
    """The autograd call shared by spot_moments and spot_moments_multi
    (a stacked table with `multi`)."""
    table = _folded(table)
    _warn_diff_params(table, specs)
    x = state[0]
    diff = [v.to(device=x.device, dtype=x.dtype)
            for v in _diff_values(table, _SPOT)]
    w = torch.as_tensor(w).to(device=x.device, dtype=x.dtype)
    return _SpotMoments.apply(_constant_table(table, x), specs, bool(clip),
                              multi, *diff, *state, w)


def adjoint_spot_rms(table, y0, u0, w=None, specs=None, clip=False,
                     diff_pose=None):
    """Weighted RMS spot radius through K4, differentiable through the
    analytic adjoint K5 -- the production-scale counterpart of
    parallel.grad.spot_rms (no autograd residuals on a CUDA bundle).
    Semantics match spot_rms(nan_safe=True) with the same weights and
    specs: vignetted rays drop out of the value and the gradient."""
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    if w is None:
        w = torch.ones(y0.shape[0], dtype=y0.dtype,
                       device=y0.device)/y0.shape[0]
    state = tuple(c.contiguous() for c in (*K.split(y0), *K.split(u0)))
    mom = spot_moments(table, state, w, specs=specs, clip=clip,
                       diff_pose=diff_pose)
    return spot_rms_from_moments(*mom)


def union_spot_rms_from_moments(moments):
    """ONE centroid-referenced RMS over the union of all wavelengths'
    spot samples, from (nlam, 5) per-wavelength weighted moments (the
    moment-space identity of glass.polychromatic_spot_rms's union
    reduction: axial and lateral colour are penalized with the blur)."""
    sw, sx, sy, sxx, syy = (moments[:, i].sum() for i in range(5))
    cx, cy = sx/sw, sy/sw
    var = (sxx + syy)/sw - (cx*cx + cy*cy)
    return torch.sqrt(torch.clamp(var, min=0.) + 1e-30)


def polychromatic_spot_rms(tables, y0, u0, w=None, specs=None, clip=False,
                           tile=None, interpret=False, diff_pose=None):
    """Polychromatic union spot RMS through K6, differentiable through
    the analytic adjoint K7 -- the production-scale twin of
    glass.polychromatic_spot_rms.  Every wavelength traces the same
    (y0, u0) bundle at weight w/nlam (w defaults to 1/N), vignetted rays
    drop out per wavelength, and the RMS is taken about the shared
    union centroid.  Gradients reach the fields spot_moments_multi's
    do, a freeform table's xy_poly among them (K7's last columns).
    `tile` and `interpret` (TPU options) are accepted and ignored."""
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    nlam = tables.curvature.shape[0]
    if w is None:
        w = torch.ones(y0.shape[0], dtype=y0.dtype,
                       device=y0.device)/y0.shape[0]
    state = tuple(c.contiguous() for c in (*K.split(y0), *K.split(u0)))
    mom = spot_moments_multi(tables, state, torch.as_tensor(w)/nlam,
                             specs=specs, clip=clip, diff_pose=diff_pose)
    return union_spot_rms_from_moments(mom)


# -- the differentiable per-ray OPD --------------------------------------

class _OpdRays(torch.autograd.Function):
    """K8 forward, K9 backward (the reference's custom_vjp `_opd`):
    table fields, ray state and the aux vector in; k, lx, ly out."""

    @staticmethod
    def forward(ctx, table, specs, clip, *tensors):
        params, state, aux = (tensors[:_NO], tensors[_NO:_NO + 6],
                              tensors[-1])
        ctx.table, ctx.specs, ctx.clip = table, specs, clip
        ctx.save_for_backward(*tensors)
        tab = table.replace(**dict(zip(_DIFF, params)))
        return opd_chain(tab, specs, state, aux, clip)

    @staticmethod
    def backward(ctx, ct_k, ct_lx, ct_ly):
        tensors = ctx.saved_tensors
        params, state, aux = (tensors[:_NO], tensors[_NO:_NO + 6],
                              tensors[-1])
        tab = ctx.table.replace(**dict(zip(_DIFF, params)))
        # K9 reduces only the slots autograd asks for (and the centre's
        # three: the sphere centre's trace may need them), and writes the
        # ray cotangents only when they are wanted
        need = ctx.needs_input_grad
        fields = tuple(f for f, nd in zip(_DIFF, need[3:3 + _NO]) if nd)
        pg, ct_state, ct_c = opd_adjoint(
            tab, ctx.specs, state, aux,
            tuple(c.contiguous() for c in (ct_k, ct_lx, ct_ly)), ctx.clip,
            fields=fields, rays=any(need[3 + _NO:9 + _NO]))
        if ct_state is None:
            ct_state = (None,)*6
        na, no = params[5].shape[-1], params[6].shape[-1]
        q = OPD_SLOTS + na + no
        if carries_anamorphic(ctx.specs):
            # an anamorphic key's curvature_dx and conic_dx columns
            gdx = (pg[:, q], pg[:, q + 1])
            q += ANAM
        else:
            gdx = (torch.zeros_like(params[7]), torch.zeros_like(params[8]))
        # a phase key's grating_dy, then a DOE key's n_after and
        # coefficients, last
        grating, nd = _phase_layout(tab, ctx.specs)
        ggdy = pg[:, q] if grating else torch.zeros_like(params[9])
        q += int(grating)
        gna = pg[:, q] if nd else torch.zeros_like(params[10])
        gdoe = (pg[:, q + 1:q + 1 + nd].contiguous() if nd
                else torch.zeros_like(params[11]))
        q += nd + int(nd > 0)
        # a freeform key's XY columns, last
        nxy = xy_width(tab, ctx.specs)
        gxy = (pg[:, q:q + nxy].contiguous() if nxy
               else torch.zeros_like(params[12]))
        # a rot key's rotation, last
        grot = (pg[:, -ROT:].reshape(params[13].shape)
                if CS.carries_rot(ctx.specs, fields)
                else torch.zeros_like(params[13]))
        grads = (pg[:, 0], pg[:, 1], pg[:, 2:5].contiguous(), pg[:, 5],
                 pg[:, 6], pg[:, OPD_SLOTS:OPD_SLOTS + na].contiguous(),
                 pg[:, OPD_SLOTS + na:OPD_SLOTS + na + no].contiguous(),
                 *gdx, ggdy, gna, gdoe, gxy, grot)
        # radius and lam_scale are constants of the merit
        ct_aux = torch.cat([ct_c, torch.zeros_like(ct_c[:2])])
        return (None, None, None, *grads, *ct_state, ct_aux)


def adjoint_opd_rays(table, y0, u0, ref=0, radius=None, wavelength=None,
                     scale=1e-3, finite=False, with_pupil=False, specs=None,
                     clip=False, diff_pose=None):
    """Per-ray optical path difference on the exit-pupil reference
    sphere, in waves, through K8, differentiable through the analytic
    adjoint K9 -- the production-scale counterpart of
    parallel.grad.opd_rays (the JAX package's pallas_opd_rays).  With
    with_pupil also the ref-centred landing coordinates (N, 2) on the
    sphere (tilt removal, Strehl, pupil grids).

    The reference ray `ref` must be alive.  Its image point, the sphere
    centre, comes from a one-ray differentiable plain trace, and the
    finite=False input-plane term -n0 (y0 . u0[ref])/lam_scale and the
    k - k[ref] difference stay outside the kernel, so gradients reach
    the sphere placement and the bundle exactly as in the plain engine.
    Gradients reach curvature, conic, offset, mu, n_before, aspherics
    and aspherics_odd, curvature_dx and conic_dx, grating_dy, n_after (a
    DOE row's), doe, xy_poly and rot (K9's slots; the sphere centre's
    trace by autograd), the rays, and through tables.lower_pose tilt and
    decenter (a pose that requires grad keeps every row but the
    object's rotated and off axis, diff_pose)."""
    from .geometric import trace_rays_final
    specs = _resolve_specs(table, specs, diff_pose)
    table = lower_pose(table)
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    x = y0
    _warn_diff_params(table, specs)
    # the sphere centre: the reference ray's image point (local frame),
    # one differentiable ray through the plain trace
    yr, _, _ = trace_rays_final(table, y0[ref:ref + 1], u0[ref:ref + 1],
                                clip=False, specs=specs)
    lam_scale = wavelength/scale
    aux = torch.cat([yr[0], torch.as_tensor(
        [float(radius), lam_scale], dtype=x.dtype).to(x.device)])
    diff = [v.to(device=x.device, dtype=x.dtype)
            for v in _diff_values(table)]
    state = tuple(c.contiguous() for c in (*K.split(y0), *K.split(u0)))
    k, lx, ly = _OpdRays.apply(_constant_table(table, x), specs, bool(clip),
                               *diff, *state, aux)
    if not finite:
        # the input reference plane normal to the chief ray: a linear
        # term of the bundle, outside the kernel
        k = k - diff[4][0]*(y0 @ u0[ref])/lam_scale
    waves = k - k[ref]
    if not with_pupil:
        return waves
    return waves, torch.stack([lx - lx[ref], ly - ly[ref]], 1)


def adjoint_wavefront_rms(table, y0, u0, w=None, ref=0, radius=None,
                          wavelength=None, scale=1e-3, finite=False,
                          specs=None, clip=False, diff_pose=None):
    """Weighted RMS wavefront error (waves, piston removed) through K8,
    differentiable through K9 -- the production-scale counterpart of
    parallel.grad.wavefront_rms (the JAX package's
    pallas_wavefront_rms).  NaN (vignetted) rays drop out of the
    moments and carry zero cotangent.  Gradients reach the fields
    adjoint_opd_rays names, a freeform table's xy_poly among them (K9's
    last columns)."""
    opd = adjoint_opd_rays(table, y0, u0, ref=ref, radius=radius,
                           wavelength=wavelength, scale=scale, finite=finite,
                           specs=specs, clip=clip, diff_pose=diff_pose)
    return wavefront_rms_of(opd, w)


def wavefront_rms_of(opd, w=None):
    """Weighted RMS about the weighted mean of per-ray OPD samples (in
    waves), over the finite ones (w defaults to 1/N)."""
    if w is None:
        w = torch.ones(opd.shape[0], dtype=opd.dtype,
                       device=opd.device)/opd.shape[0]
    good = torch.isfinite(opd)
    wg = torch.where(good, torch.as_tensor(w).to(opd), 0.)
    o = torch.where(good, opd, 0.)
    wsum = wg.sum()
    mean = (wg*o).sum()/wsum
    return torch.sqrt((wg*torch.square(o - mean)).sum()/wsum + 1e-30)
