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
System.tables or glass.glass_tables) and ONE bundle, read once and run
through every wavelength's chain.  K6 returns (nlam, 5) moments; K7
takes (nlam, 5) moment cotangents, judges each ray dead or live per
wavelength, sums the ray and weight cotangents over the wavelengths
and returns the parameter cotangents per wavelength (nlam, S, SLOTS),
so autograd through the stacking (glass_tables, a broadcast
curvature) sums the shared geometry.

`spot_moments` and `adjoint_spot_rms` bind K4/K5 in one
torch.autograd.Function (the JAX package's jax.custom_vjp `_moments`),
`spot_moments_multi` and `polychromatic_spot_rms` bind K6/K7 in the
same Function (`_moments_multi`):
gradients flow to the table's curvature, conic, offset and mu (and
through tables.lower_pose to decenter), to the ray state and to the
weights.  n_before, which feeds only the optical path, receives a zero
cotangent.  The gradient semantics are those of the SPECIALIZED
engine: a parameter the static specs bake out (the conic of a
spherical row, the transverse offset of an on-axis row, mu of a
passthrough row) gets exactly zero gradient, and the call warns once
when such a parameter is the one being optimized.  rot is not
differentiated: a rot (or tilt) that requires grad while some spec row
is rotated raises NotImplementedError.

K8 `opd_chain` and K9 `opd_adjoint` are the exit-pupil wavefront
plane (`pallas_grad._opd_kernel`, `_opd_adjoint_kernel`): K8 traces
rows 1..S-2 summing the optical path, steps to the image row,
intercepts the reference sphere (centre, radius and wavelength scale
in a (5,) aux tensor) and returns k = -(path to the sphere)/lam_scale
and the landing x, y per ray; K9 is its analytic adjoint, with the
path cotangent feeding every row's t and n_before, so it returns
OPD_SLOTS = 7 parameter cotangents a row (K5's six and n_before) and
the centre's three.  `adjoint_opd_rays` and `adjoint_wavefront_rms`
bind them in `_OpdRays` (the reference's custom_vjp `_opd`); the
sphere centre, the input-plane term and k - k[ref] stay outside the
kernel, in autograd.

The kernels are hand-written CUDA C++.  K4 and K5 are compiled for
each (dtype, spec tuple, clip) key, K5 also for its live parameter
slots and for whether it writes the ray and weight cotangents
(csrc/grad_spec.cuh, built and cached by ops.cuda_spec); through
`_SpotMoments` K5 reduces only the slots autograd asks for and, when
no ray or weight needs a gradient (the optimizer's frozen bundles),
writes nothing a ray.  K6-K9 read the row flags at run time
(csrc/grad.cu, built with the K1/K2 library by ops.cuda_build).  A
wrapper takes the plain PyTorch
version (`weighted_moments_reference`, `merit_adjoint_reference`,
`weighted_moments_multi_reference`, `merit_adjoint_multi_reference`,
`opd_chain_reference`, `opd_adjoint_reference`) only for a bundle on
the CPU; for a CUDA bundle it launches its kernel or raises.  Each
wrapper counts its launches in `<wrapper>.launches`.
`_step_vjp_reference`, `_merit_adjoint_by_hand`,
`_merit_adjoint_multi_by_hand`, `_opd_tail_vjp_reference` and
`_opd_adjoint_by_hand` write the kernels' hand-derived reverse in
torch, line for line, so the CPU tests can hold it against autograd;
nothing else calls them.
"""

import functools
import warnings
from typing import NamedTuple

import torch

from . import cuda_spec as CS
from . import kernels as K
from .cuda_trace import (BLOCK, ROW, SMEM_OPTIN, _check_state, _launch_setup,
                         _raise_on, pack_values, spot_rms_from_moments,
                         trace_final_reference)
from .tables import lower_pose, table_at

MAX_ROWS = 32   # saved states a K7/K9 thread keeps: keep in sync with grad.cu
SLOTS = 6       # parameter cotangents a row: c, k, offset x/y/z, mu
OPD_SLOTS = 7   # K9's a row: SLOTS and n_before
AUX = 5         # K8/K9's aux vector: centre x, y, z, radius, lam_scale

#: differentiable table fields the autograd Function carries
_DIFF = ("curvature", "conic", "offset", "mu", "n_before")
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


def _param_rows(tab):
    """(S, SLOTS) view of the differentiated fields of a table."""
    return torch.stack([tab.curvature, tab.conic, tab.offset[:, 0],
                        tab.offset[:, 1], tab.offset[:, 2], tab.mu], 1)


def merit_adjoint_reference(table, specs, state, w, ct, clip=False):
    """Plain PyTorch version of K5: torch autograd through the plain
    trace.  A no-grad pre-trace finds the live rays; each dead ray is
    traced as the first live one (so no NaN enters autograd) at zero
    weight.  Returns (parameter cotangents (S, SLOTS) in the order c,
    k, offset x, y, z, mu; the six state cotangents; the weight
    cotangent), all in the state's dtype."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    with torch.no_grad():
        out, _ = trace_final_reference(tab, specs, state, clip)
        alive = _live(out)
    pg = torch.zeros((tab.nsurfaces, SLOTS), dtype=x0.dtype,
                     device=x0.device)
    if not bool(alive.any()):
        return pg, tuple(torch.zeros_like(x0) for _ in range(6)), \
            torch.zeros_like(x0)
    i0 = int(torch.argmax(alive.to(torch.uint8)))
    leaves = [tab.curvature, tab.conic, tab.offset, tab.mu,
              *state, w]
    leaves = [v.detach().clone().requires_grad_() for v in leaves]
    c, k, off, mu = leaves[:4]
    st, wl = leaves[4:10], leaves[10]
    with torch.enable_grad():
        sub = tuple(torch.where(alive, s, s[i0]) for s in st)
        t2 = tab.replace(curvature=c, conic=k, offset=off, mu=mu)
        out, _ = trace_final_reference(t2, specs, sub, clip)
        mom = _wmoments(out[0], out[1], wl, alive)
        grads = torch.autograd.grad((mom*ct.to(mom.dtype)).sum(), leaves,
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    pg = _param_rows(tab.replace(curvature=grads[0], conic=grads[1],
                                 offset=grads[2], mu=grads[3]))
    return pg, tuple(grads[4:10]), grads[10]


def weighted_moments_multi_reference(tables, specs, state, w, clip=False):
    """Plain PyTorch version of K6: weighted_moments_reference for each
    table of the stack, stacked to (nlam, 5)."""
    return torch.stack([
        weighted_moments_reference(table_at(tables, li), specs, state, w,
                                   clip)
        for li in range(tables.curvature.shape[0])])


def _sum_over_tables(one, tables, specs, state, w, ct, clip):
    """K7's reduction of a per-table adjoint `one`: parameter
    cotangents stacked per table, ray and weight cotangents summed over
    the tables in order."""
    pgs, st, gw = [], [torch.zeros_like(state[0]) for _ in range(6)], \
        torch.zeros_like(state[0])
    for li in range(tables.curvature.shape[0]):
        pg, sl, wl = one(table_at(tables, li), specs, state, w, ct[li], clip)
        pgs.append(pg)
        st = [a + b for a, b in zip(st, sl)]
        gw = gw + wl
    return torch.stack(pgs), tuple(st), gw


def merit_adjoint_multi_reference(tables, specs, state, w, ct, clip=False):
    """Plain PyTorch version of K7: for each table of the stack,
    torch autograd through the plain trace (merit_adjoint_reference,
    re-traced under enable_grad) of that table's weighted moments
    dotted with its row of the (nlam, 5) cotangents `ct`.  Returns
    (parameter cotangents (nlam, S, SLOTS); the six state cotangents
    and the weight cotangent, each summed over the tables)."""
    return _sum_over_tables(merit_adjoint_reference, tables, specs, state,
                            w, ct, clip)


class _Tail(NamedTuple):
    """The reference-sphere tail's intermediates (SphereTail in
    csrc/grad.cu)."""
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
    entering rows 1..S-2 (index j; None at 0) with the tail's
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
    img = tab.row(nsurf - 1)
    o = _sphere_tail(s, img, specs[nsurf - 1], aux)
    k = -(path + o.ti*img.n_before)/aux[4]
    return (k, o.px + o.ti*o.dx, o.py + o.ti*o.dy), saved, o


def _check_opd(table, specs, state, aux):
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


def _opd_cotangent_rows(tab, grads):
    """(S, OPD_SLOTS) rows from the table-field gradients (c, k, offset,
    mu, n_before)."""
    return torch.stack([grads[0], grads[1], grads[2][:, 0], grads[2][:, 1],
                        grads[2][:, 2], grads[3], grads[4]], 1)


def opd_adjoint_reference(table, specs, state, aux, cts, clip=False):
    """Plain PyTorch version of K9: torch autograd through the plain
    chain and tail of K8 dotted with cts = (ct_k, ct_lx, ct_ly).  A
    no-grad pre-trace finds the live rays (finite k); each dead ray is
    traced as the first live one (no NaN enters autograd) with zero
    cotangents.  Returns (parameter cotangents (S, OPD_SLOTS): c, k,
    offset x, y, z, mu, n_before; the six state cotangents; the (3,)
    centre cotangents), in the state's dtype."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    with torch.no_grad():
        alive = torch.isfinite(_opd_chain(tab, specs, state, aux, clip)[0][0])
    pg = torch.zeros((tab.nsurfaces, OPD_SLOTS), dtype=x0.dtype,
                     device=x0.device)
    if not bool(alive.any()):
        return pg, tuple(torch.zeros_like(x0) for _ in range(6)), \
            torch.zeros(3, dtype=x0.dtype, device=x0.device)
    i0 = int(torch.argmax(alive.to(torch.uint8)))
    leaves = [tab.curvature, tab.conic, tab.offset, tab.mu, tab.n_before,
              *state, aux]
    leaves = [v.detach().clone().requires_grad_() for v in leaves]
    with torch.enable_grad():
        sub = tuple(torch.where(alive, s, s[i0]) for s in leaves[5:11])
        t2 = tab.replace(**dict(zip(_DIFF, leaves[:5])))
        outs = _opd_chain(t2, specs, sub, leaves[11], clip)[0]
        total = sum((o*torch.where(alive, c.to(o.dtype), 0.)).sum()
                    for o, c in zip(outs, cts))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    return (_opd_cotangent_rows(tab, grads), tuple(grads[5:11]),
            grads[11][:3])


# -- the kernel's reverse, written by hand in torch (test-only) ----------

def _step_vjp_reference(state, surf, spec, g, ct_path=None):
    """Hand-derived reverse of kernels.surface_step_spec for live rays,
    the line-for-line model of `surface_step_vjp` in csrc/grad.cu.

    state: the six components entering the row (global frame); g: the
    cotangent of the six components leaving it; ct_path: the cotangent
    of the row's optical path t * n_before (K9's PATH instantiation), or
    None (K5's: the path has no cotangent).  Returns (cotangent of the
    entering state, per-ray parameter cotangents (c, k, offset x, y, z,
    mu, and with ct_path n_before)).  The aperture clip is a constant
    mask: a clipped ray is dead, and dead rays never reach the reverse
    sweep."""
    K.check_supported(spec)
    x, y, z, ux, uy, uz = state
    zero = torch.zeros_like(x)
    c, k, mu = surf.curvature, surf.conic, surf.mu
    # ---- forward recompute ----
    if spec.off_axis:
        x = x - surf.offset[0]
        y = y - surf.offset[1]
    z = z - surf.offset[2]
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
    gx1, gy1, gz1, gvx, gvy, gvz = g
    if spec.rotated:
        gx1, gy1, gz1 = K.rot_apply(r, gx1, gy1, gz1)
        gvx, gvy, gvz = K.rot_apply(r, gvx, gvy, gvz)
    gc, gk, gmu = zero, zero, zero
    # ---- reverse: refraction ----
    if spec.kind == 0:
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
        dot = ux*nx + uy*ny + uz*nz
        if not spec.spherical:
            ir2 = 1./(nx*nx + ny*ny + nz*nz)
        gir2 = zero
        if spec.kind == 2:
            a2 = 2.*dot if spec.spherical else 2.*dot*ir2
            gux, guy, guz = gvx, gvy, gvz
            gnx, gny, gnz = -a2*gvx, -a2*gvy, -a2*gvz
            ga2 = -(gvx*nx + gvy*ny + gvz*nz)
            if spec.spherical:
                gdot = 2.*ga2
            else:
                gdot = 2.*ir2*ga2
                gir2 = 2.*dot*ga2
        else:
            muf, sgmu = torch.abs(mu), torch.sign(mu)
            if spec.spherical:
                a = muf*dot
                disc2 = a*a - (mu*mu - 1)
            else:
                a = muf*dot*ir2
                disc2 = a*a - (mu*mu - 1)*ir2
            sq2 = K._sqrt0(disc2)
            q2 = -a + sgmu*sq2
            gmuf = ux*gvx + uy*gvy + uz*gvz
            gux, guy, guz = muf*gvx, muf*gvy, muf*gvz
            gq2 = gvx*nx + gvy*ny + gvz*nz
            gnx, gny, gnz = q2*gvx, q2*gvy, q2*gvz
            gdisc2 = gq2*sgmu*.5/sq2
            ga = -gq2 + 2*a*gdisc2
            if spec.spherical:
                gmu = -2*mu*gdisc2
                gmuf = gmuf + dot*ga
                gdot = muf*ga
            else:
                gmu = -2*mu*ir2*gdisc2
                gir2 = -(mu*mu - 1)*gdisc2 + muf*dot*ga
                gmuf = gmuf + dot*ir2*ga
                gdot = muf*ir2*ga
            gmu = gmu + sgmu*gmuf
        gux, guy, guz = gux + gdot*nx, guy + gdot*ny, guz + gdot*nz
        gnx, gny, gnz = gnx + gdot*ux, gny + gdot*uy, gnz + gdot*uz
        if not spec.spherical:
            s = -2.*ir2*ir2*gir2
            gnx, gny, gnz = gnx + s*nx, gny + s*ny, gnz + s*nz
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
    if spec.rotated:
        gx, gy, gz = K.rot_apply_t(r, gx, gy, gz)
        gux, guy, guz = K.rot_apply_t(r, gux, guy, guz)
    gox = -gx if spec.off_axis else zero
    goy = -gy if spec.off_axis else zero
    pg = (gc, gk, gox, goy, -gz, gmu)
    if ct_path is not None:
        pg = pg + (gnb,)
    return (gx, gy, gz, gux, guy, guz), pg


def _merit_adjoint_by_hand(table, specs, state, w, ct, clip=False):
    """K5 written in torch with _step_vjp_reference, the model of
    `merit_adjoint_kernel` in csrc/grad.cu: same outputs as
    merit_adjoint_reference."""
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
    rl = tab.rot[nsurf - 1]
    if specs[nsurf - 1].rotated:
        s = (*K.rot_apply(rl, *s[:3]), *K.rot_apply(rl, *s[3:]))
    x, y = s[0], s[1]
    live = _live(s)
    ct0, ct1, ct2, ct3, ct4 = ct
    ctx = w*(ct1 + 2*x*ct3)
    cty = w*(ct2 + 2*y*ct4)
    ct_w = torch.where(live, ct0 + x*ct1 + y*ct2 + x*x*ct3 + y*y*ct4, 0.)
    zero = torch.zeros_like(x0)
    g3 = (K.rot_apply_t(rl, ctx, cty, zero)
          if specs[nsurf - 1].rotated else (ctx, cty, zero))
    g = tuple(torch.where(live, v, 0.) for v in (*g3, zero, zero, zero))
    pg = torch.zeros((nsurf, SLOTS), dtype=x0.dtype, device=x0.device)
    for j in range(nsurf - 1, 0, -1):
        g, pj = _step_vjp_reference(saved[j], tab.row(j), specs[j], g)
        g = tuple(torch.where(live, v, 0.) for v in g)
        pg[j] = torch.stack([torch.where(live, v, 0.).sum() for v in pj])
    if specs[0].rotated:
        g = (*K.rot_apply(r0, *g[:3]), *K.rot_apply(r0, *g[3:]))
    return pg, g, ct_w


def _merit_adjoint_multi_by_hand(tables, specs, state, w, ct, clip=False):
    """K7 written in torch: the K5 model run once per table of the stack
    on the same state (each table's dead rays zeroed for it alone), the
    model of `merit_adjoint_multi_kernel` in csrc/grad.cu; same outputs
    as merit_adjoint_multi_reference."""
    return _sum_over_tables(_merit_adjoint_by_hand, tables, specs, state,
                            w, ct, clip)


def _opd_tail_vjp_reference(surf, spec, o, ct_q, ct_lx, ct_ly):
    """Hand-derived reverse of the sphere tail for live rays, the
    line-for-line model of `sphere_tail_vjp` in csrc/grad.cu.  o: the
    tail's intermediates (_sphere_tail); ct_q, ct_lx, ct_ly: the
    cotangents of q = ti * n_image and of the landing x, y.  Returns
    (cotangent of the state leaving row S-2, the image row's per-ray
    parameter cotangents (OPD_SLOTS), the centre cotangents (3))."""
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
    if spec.rotated:
        gpx, gpy, gpz = K.rot_apply_t(surf.rot, gpx, gpy, gpz)
        gdx, gdy, gdz = K.rot_apply_t(surf.rot, gdx, gdy, gdz)
    pg = (zero, zero, -gpx if spec.off_axis else zero,
          -gpy if spec.off_axis else zero, -gpz, zero, ct_q*o.ti)
    return (gpx, gpy, gpz, gdx, gdy, gdz), pg, gc


def _opd_adjoint_by_hand(table, specs, state, aux, cts, clip=False):
    """K9 written in torch with _opd_tail_vjp_reference and
    _step_vjp_reference(ct_path=), the model of `opd_adjoint_kernel` in
    csrc/grad.cu: same outputs as opd_adjoint_reference."""
    x0 = state[0]
    tab = _constant_table(table, x0)
    nsurf = tab.nsurfaces
    (k, _, _), saved, o = _opd_chain(tab, specs, state, aux, clip)
    live = torch.isfinite(k)
    ct_k, ct_lx, ct_ly = (torch.where(live, c, 0.) for c in cts)
    ct_path = -ct_k/aux[4]
    g, pj, gc = _opd_tail_vjp_reference(tab.row(nsurf - 1), specs[nsurf - 1],
                                        o, ct_path, ct_lx, ct_ly)
    g = tuple(torch.where(live, v, 0.) for v in g)
    pg = torch.zeros((nsurf, OPD_SLOTS), dtype=x0.dtype, device=x0.device)
    pg[nsurf - 1] = torch.stack([torch.where(live, v, 0.).sum() for v in pj])
    gcen = torch.stack([torch.where(live, v, 0.).sum() for v in gc])
    for j in range(nsurf - 2, 0, -1):
        g, pj = _step_vjp_reference(saved[j], tab.row(j), specs[j], g,
                                    ct_path=ct_path)
        g = tuple(torch.where(live, v, 0.) for v in g)
        pg[j] = torch.stack([torch.where(live, v, 0.).sum() for v in pj])
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


def _spec_launch(state):
    """The device, the rays and the stream of a K4/K5 launch on a CUDA
    bundle."""
    x = state[0]
    if x.device.type != "cuda":
        raise ValueError("expected a CUDA or CPU bundle, got %s" % x.device)
    return x.device, x.shape[0], torch.cuda.current_stream(
        x.device).cuda_stream


def _packed(table, specs, x):
    packed = pack_values(table, x.dtype, x.device)
    if packed.shape[0] != len(specs):
        raise ValueError("%d specs for a table of %d rows"
                         % (len(specs), packed.shape[0]))
    return packed


@functools.lru_cache(maxsize=None)
def _moments_kernel(specs, dtype, clip):
    return CS.load(CS.moments_key(specs, dtype, clip))


@functools.lru_cache(maxsize=None)
def _adjoint_kernel(specs, dtype, clip, fields, rays):
    return CS.load(CS.adjoint_key(specs, dtype, clip, fields, rays))


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
    device, n, stream = _spec_launch(state)
    specs = tuple(specs)
    kern = _moments_kernel(specs, x.dtype, bool(clip))
    packed = _packed(table, specs, x)
    if not n:
        return torch.zeros(5, dtype=x.dtype, device=device)
    grid = kern.grid(n, device)
    out = torch.empty(5, dtype=x.dtype, device=device)
    partials = torch.empty((grid, 5), dtype=x.dtype, device=device)
    kern.check(kern.fn(packed.data_ptr(), *(c.data_ptr() for c in state),
                       w.data_ptr(), partials.data_ptr(),
                       CS.counter(device).data_ptr(), out.data_ptr(), n,
                       grid, stream))
    weighted_moments.launches += 1
    return out


weighted_moments.launches = 0


def merit_adjoint(table, specs, state, w, ct, clip=False, fields=CS.FIELDS,
                  rays=True):
    """K5: (parameter cotangents (S, SLOTS): c, k, offset x, y, z, mu;
    the six state cotangents; the weight cotangent) of the weighted
    moments dotted with `ct`, a (5,) tensor of moment cotangents on
    the rays' device.  `fields`: the table fields whose cotangents are
    wanted; a slot outside them, or baked out by the specs
    (cuda_spec.live_slots), is an exact zero.  rays=False: the state
    and weight cotangents are not computed and come back as None.
    CUDA bundles launch the kernel compiled for (dtype, specs, clip,
    live slots, rays) (ops.cuda_spec: one launch, the grid-wide sum
    fused, nothing written a ray without `rays`); CPU bundles take
    merit_adjoint_reference."""
    _check_state(state)
    _check_vector(w, state, "w")
    _check_vector(ct, state, "ct", (5,))
    x = state[0]
    specs, fields = tuple(specs), tuple(fields)
    if x.device.type == "cpu":
        pg, st, gw = merit_adjoint_reference(table, specs, state, w, ct,
                                             clip)
        pg = torch.where(CS.live_mask(CS.live_slots(specs, fields)), pg, 0.)
        return (pg, st, gw) if rays else (pg, None, None)
    device, n, stream = _spec_launch(state)
    kern = _adjoint_kernel(specs, x.dtype, bool(clip), fields, bool(rays))
    packed = _packed(table, specs, x)
    if not n:
        pg = torch.zeros((len(specs), SLOTS), dtype=x.dtype, device=device)
        return (pg, tuple(torch.zeros_like(x) for _ in range(6)),
                torch.zeros_like(x)) if rays else (pg, None, None)
    grid = kern.grid(n, device)
    pg = torch.empty((len(specs), SLOTS), dtype=x.dtype, device=device)
    partials = torch.empty((grid, max(kern.key.nlive, 1)), dtype=x.dtype,
                           device=device)
    outs = [torch.empty_like(x) for _ in range(7)] if rays else None
    kern.check(kern.fn(packed.data_ptr(), *(c.data_ptr() for c in state),
                       w.data_ptr(), ct.data_ptr(), partials.data_ptr(),
                       CS.counter(device).data_ptr(), pg.data_ptr(),
                       *((o.data_ptr() for o in outs) if rays
                         else (None,)*7), n, grid, stream))
    merit_adjoint.launches += 1
    if not rays:
        return pg, None, None
    return pg, tuple(outs[:6]), outs[6]


merit_adjoint.launches = 0


def weighted_moments_multi(tables, specs, state, w, clip=False):
    """K6: the (nlam, 5) weighted moments of each table of a stack
    (leading wavelength axis) over its live rays, one bundle read once,
    in the rays' dtype.  CUDA bundles launch the kernel ((grid, nlam, 5)
    block partial sums, then one torch sum); CPU bundles take
    weighted_moments_multi_reference."""
    _check_state(state)
    _check_vector(w, state, "w")
    if state[0].device.type == "cpu":
        return weighted_moments_multi_reference(tables, specs, state, w,
                                                clip)
    nlam = tables.curvature.shape[0]
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        tables, specs, state, smem_extra_words=5*nlam*BLOCK)
    partials = torch.zeros((grid, nlam, 5), dtype=state[0].dtype,
                           device=state[0].device)
    if n:
        err = getattr(lib, "weighted_moments_multi_" + suffix)(
            packed.data_ptr(), flags.data_ptr(), nsurf, nlam,
            int(bool(clip)), *(c.data_ptr() for c in state), w.data_ptr(),
            partials.data_ptr(), n, grid, BLOCK, stream)
        _raise_on(lib, err, "weighted_moments_multi")
        weighted_moments_multi.launches += 1
    return partials.sum(0)


weighted_moments_multi.launches = 0


def _adjoint_multi_words(nsurf):
    """Shared-memory words K7 needs a wavelength beside its table."""
    return (BLOCK // 32)*nsurf*SLOTS + 5


def max_adjoint_wavelengths(nsurf, dtype):
    """The most wavelengths K7 holds for `nsurf` rows in `dtype`: its
    per-warp parameter rows, the tables and the cotangents all live in
    one block's shared memory (at most cuda_trace.SMEM_OPTIN bytes)."""
    word = torch.tensor([], dtype=dtype).element_size()
    return ((SMEM_OPTIN - 4*nsurf)
            // ((nsurf*ROW + _adjoint_multi_words(nsurf))*word))


def merit_adjoint_multi(tables, specs, state, w, ct, clip=False):
    """K7: (parameter cotangents (nlam, S, SLOTS) per table of the
    stack; the six state cotangents and the weight cotangent, each
    summed over the tables) of the (nlam, 5) weighted moments dotted
    with `ct`, an (nlam, 5) tensor of moment cotangents on the rays'
    device.  CUDA bundles launch the kernel (per-block parameter
    partials, then one torch sum over blocks); CPU bundles take
    merit_adjoint_multi_reference."""
    nlam = tables.curvature.shape[0]
    _check_state(state)
    _check_vector(w, state, "w")
    _check_vector(ct, state, "ct", (nlam, 5))
    if state[0].device.type == "cpu":
        return merit_adjoint_multi_reference(tables, specs, state, w, ct,
                                             clip)
    nsurf = len(specs)
    if nsurf > MAX_ROWS:
        raise ValueError("merit_adjoint_multi keeps at most %d rows a ray, "
                         "the table has %d" % (MAX_ROWS, nsurf))
    most = max_adjoint_wavelengths(nsurf, state[0].dtype)
    if nlam > most:
        raise ValueError(
            "merit_adjoint_multi holds at most %d wavelengths of %d rows in "
            "%s (%d bytes of shared memory a block), got %d"
            % (most, nsurf, state[0].dtype, SMEM_OPTIN, nlam))
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        tables, specs, state,
        smem_extra_words=nlam*_adjoint_multi_words(nsurf))
    x = state[0]
    partials = torch.zeros((grid, nlam*nsurf*SLOTS), dtype=x.dtype,
                           device=x.device)
    outs = [torch.zeros_like(x) for _ in range(7)]
    if n:
        err = getattr(lib, "merit_adjoint_multi_" + suffix)(
            packed.data_ptr(), flags.data_ptr(), nsurf, nlam,
            int(bool(clip)), *(c.data_ptr() for c in state), w.data_ptr(),
            ct.data_ptr(), partials.data_ptr(),
            *(o.data_ptr() for o in outs), n, grid, BLOCK, stream)
        _raise_on(lib, err, "merit_adjoint_multi")
        merit_adjoint_multi.launches += 1
    return (partials.sum(0).reshape(nlam, nsurf, SLOTS), tuple(outs[:6]),
            outs[6])


merit_adjoint_multi.launches = 0


def opd_chain(table, specs, state, aux, clip=False):
    """K8: (k, lx, ly), each (N,) in the rays' dtype, for aux = (centre
    x, y, z, radius, lam_scale), a (5,) tensor on the rays' device
    (k = -(optical path to the reference sphere)/lam_scale; lx, ly the
    landing on the sphere about its centre).  CUDA bundles launch the
    kernel; CPU bundles take opd_chain_reference."""
    _check_opd(table, specs, state, aux)
    if state[0].device.type == "cpu":
        return opd_chain_reference(table, specs, state, aux, clip)
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        table, specs, state, smem_extra_words=AUX)
    outs = [torch.empty_like(state[0]) for _ in range(3)]
    if n:
        err = getattr(lib, "opd_chain_" + suffix)(
            packed.data_ptr(), flags.data_ptr(), nsurf, int(bool(clip)),
            *(c.data_ptr() for c in state), aux.data_ptr(),
            *(o.data_ptr() for o in outs), n, grid, BLOCK, stream)
        _raise_on(lib, err, "opd_chain")
        opd_chain.launches += 1
    return tuple(outs)


opd_chain.launches = 0


def opd_adjoint(table, specs, state, aux, cts, clip=False):
    """K9: (parameter cotangents (S, OPD_SLOTS): c, k, offset x, y, z,
    mu, n_before; the six state cotangents; the (3,) centre cotangents)
    of K8's outputs dotted with cts = (ct_k, ct_lx, ct_ly), three (N,)
    tensors on the rays' device.  CUDA bundles launch the kernel
    (per-block partials, then one torch sum over blocks); CPU bundles
    take opd_adjoint_reference."""
    _check_opd(table, specs, state, aux)
    for name, c in zip(("ct_k", "ct_lx", "ct_ly"), cts):
        _check_vector(c, state, name)
    if state[0].device.type == "cpu":
        return opd_adjoint_reference(table, specs, state, aux, cts, clip)
    nsurf = len(specs)
    if nsurf > MAX_ROWS:
        raise ValueError("opd_adjoint keeps at most %d rows a ray, the "
                         "table has %d" % (MAX_ROWS, nsurf))
    slots = nsurf*OPD_SLOTS + 3
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        table, specs, state, smem_extra_words=AUX + (BLOCK // 32)*slots)
    x = state[0]
    partials = torch.zeros((grid, slots), dtype=x.dtype, device=x.device)
    outs = [torch.zeros_like(x) for _ in range(6)]
    if n:
        err = getattr(lib, "opd_adjoint_" + suffix)(
            packed.data_ptr(), flags.data_ptr(), nsurf, int(bool(clip)),
            *(c.data_ptr() for c in state), aux.data_ptr(),
            *(c.data_ptr() for c in cts), partials.data_ptr(),
            *(o.data_ptr() for o in outs), n, grid, BLOCK, stream)
        _raise_on(lib, err, "opd_adjoint")
        opd_adjoint.launches += 1
    tot = partials.sum(0)
    return (tot[:nsurf*OPD_SLOTS].reshape(nsurf, OPD_SLOTS), tuple(outs),
            tot[nsurf*OPD_SLOTS:])


opd_adjoint.launches = 0


# -- the differentiable merit --------------------------------------------

class _SpotMoments(torch.autograd.Function):
    """K4 forward, K5 backward (the reference's custom_vjp _moments);
    with `multi`, a stacked table and K6 forward, K7 backward
    (`_moments_multi`)."""

    @staticmethod
    def forward(ctx, table, specs, clip, multi, *tensors):
        params, state, w = tensors[:5], tensors[5:11], tensors[11]
        ctx.table, ctx.specs, ctx.clip, ctx.multi = table, specs, clip, multi
        ctx.save_for_backward(*tensors)
        tab = table.replace(**dict(zip(_DIFF, params)))
        fwd = weighted_moments_multi if multi else weighted_moments
        return fwd(tab, specs, state, w, clip)

    @staticmethod
    def backward(ctx, ct):
        tensors = ctx.saved_tensors
        params, state, w = tensors[:5], tensors[5:11], tensors[11]
        tab = ctx.table.replace(**dict(zip(_DIFF, params)))
        if ctx.multi:
            pg, ct_state, ct_w = merit_adjoint_multi(
                tab, ctx.specs, state, w, ct.contiguous(), ctx.clip)
        else:
            # K5 reduces only the slots autograd asks for, and writes the
            # ray and weight cotangents only when they are wanted
            need = ctx.needs_input_grad
            fields = tuple(f for f, nd in zip(CS.FIELDS, need[4:8]) if nd)
            pg, ct_state, ct_w = merit_adjoint(
                tab, ctx.specs, state, w, ct.contiguous(), ctx.clip,
                fields=fields, rays=any(need[9:16]))
            if ct_state is None:
                ct_state = (None,)*6
        grads = (pg[..., 0], pg[..., 1], pg[..., 2:5].contiguous(),
                 pg[..., 5], torch.zeros_like(params[4]))
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
    table's curvature, conic, offset, mu (n_before: zero), the state
    and the weights (see the module docstring)."""
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
    if table.rot.requires_grad and any(s.rotated for s in specs):
        raise NotImplementedError(
            "the adjoint merit does not differentiate rot/tilt yet (the "
            "rot cotangent, ROADMAP Queue 1 item 9); use the generic "
            "engine (parallel.grad.spot_rms) for pose gradients")
    params = {f: getattr(table, f) for f in _FIELDS
              if f not in ("aspherics", "aspherics_odd")
              or getattr(table, f).shape[-1]}
    _warn_baked_params(specs, params)
    x = state[0]
    diff = [getattr(table, f).to(device=x.device, dtype=x.dtype)
            for f in _DIFF]
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
    union centroid.  `tile` and `interpret` (TPU options) are accepted
    and ignored."""
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
        params, state, aux = tensors[:5], tensors[5:11], tensors[11]
        ctx.table, ctx.specs, ctx.clip = table, specs, clip
        ctx.save_for_backward(*tensors)
        tab = table.replace(**dict(zip(_DIFF, params)))
        return opd_chain(tab, specs, state, aux, clip)

    @staticmethod
    def backward(ctx, ct_k, ct_lx, ct_ly):
        tensors = ctx.saved_tensors
        params, state, aux = tensors[:5], tensors[5:11], tensors[11]
        tab = ctx.table.replace(**dict(zip(_DIFF, params)))
        pg, ct_state, ct_c = opd_adjoint(
            tab, ctx.specs, state, aux,
            tuple(c.contiguous() for c in (ct_k, ct_lx, ct_ly)), ctx.clip)
        grads = (pg[:, 0], pg[:, 1], pg[:, 2:5].contiguous(), pg[:, 5],
                 pg[:, 6])
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
    Gradients reach curvature, conic, offset, mu and n_before (K9's
    slots), the rays, and through tables.lower_pose decenter; a rot or
    tilt that requires grad while a spec row is rotated raises
    NotImplementedError."""
    from .geometric import trace_rays_final
    specs = _resolve_specs(table, specs, diff_pose)
    table = lower_pose(table)
    if table.rot.requires_grad and any(s.rotated for s in specs):
        raise NotImplementedError(
            "the adjoint OPD does not differentiate rot/tilt yet (the rot "
            "cotangent, ROADMAP Queue 1 item 9); use parallel.grad.opd_rays "
            "for pose gradients")
    y0 = torch.as_tensor(y0)
    u0 = torch.as_tensor(u0)
    x = y0
    params = {f: getattr(table, f) for f in _FIELDS
              if f not in ("aspherics", "aspherics_odd")
              or getattr(table, f).shape[-1]}
    _warn_baked_params(specs, params)
    # the sphere centre: the reference ray's image point (local frame),
    # one differentiable ray through the plain trace
    yr, _, _ = trace_rays_final(table, y0[ref:ref + 1], u0[ref:ref + 1],
                                clip=False, specs=specs)
    lam_scale = wavelength/scale
    aux = torch.cat([yr[0], torch.as_tensor(
        [float(radius), lam_scale], dtype=x.dtype).to(x.device)])
    diff = [getattr(table, f).to(device=x.device, dtype=x.dtype)
            for f in _DIFF]
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
    moments and carry zero cotangent."""
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
