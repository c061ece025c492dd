"""A grating or DOE on a cylinder in the K1-K9 keys, on the CPU.

Such a row keeps the cylinder's closed-form intercept and takes, for its
phase solve, the normal of the biconic or toroid that made it (the
reference's surface_step_spec), so its key row sets F_BICONIC or
F_TOROID beside F_CYL_Y or F_CYL_X.  Held here, in float64: the
hand-written reverse of the row (_step_vjp_reference, the model of
csrc/step_vjp.cuh's anamorphic_step_vjp, K5's form and K9's PATH form)
against autograd through kernels.surface_step_spec; the K5, K7 and K9
models written by hand against their autograd plain versions; the
plain path's gradients (K4/K5, K6/K7 and K8/K9 wrappers, which run their
plain versions on a CPU bundle) against jax.grad of the JAX package's
merits with the same specs, curvature_dx and the aspheric coefficients
of the table's widths among the fields (the slot rule: where jax.grad
gives a phase cylinder's slot a nonzero cotangent, the key keeps it
live); and every key's row words and live slots.  The cases: a grating
on a biconic-made y-cylinder, a DOE on a toroid-made y-cylinder and a
grating on an x-cylinder, alone and in a table whose aspheric columns
another row widens.  The kernels build and run only on a CUDA card
(tests/test_torch_cuda.py).  Each test states its tolerance."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import glass as JGL
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _t)

F64 = torch.float64
GRAD_REL = 1e-9       # gradients: of each field's (slot's) largest entry
RTOL = 1e-12          # merit values, relative

#: the phase cylinders (make_table keyword arguments; row 1 the phase
#: cylinder, glass after it; "widened" adds an aspheric row 2, so the
#: table's coefficient columns have width and the cylinder's normal
#: reads them)
CYLINDERS = {
    "grating biconic y": dict(curvature=[0., 1/40., 0.],
                              curvature_dx=[0., -1/40., 0.],
                              conic=[0., -.3, 0.], conic_dx=[0., .5, 0.],
                              grating_dy=[0., .1, 0.]),
    "doe toroid y": dict(curvature=[0., 1/50., 0.],
                         curvature_dx=[0., -1/50., 0.],
                         toroidal=[0., 1., 0.], conic=[0., .2, 0.],
                         doe=[[0., 0.], [-1.5e-3, 2e-7], [0., 0.]]),
    "grating biconic x": dict(curvature=[0., 0., 0.],
                              curvature_dx=[0., 1/45., 0.],
                              conic_dx=[0., -.4, 0.],
                              grating_dy=[0., -.15, 0.]),
}
NAMES = sorted(CYLINDERS) + ["widened grating biconic y",
                             "widened doe toroid y"]
SUB_OPD = dict(radius=-40., wavelength=550e-9, scale=1e-3, finite=False,
               ref=0)


def substrate(name, li=0):
    """The JAX table of a phase cylinder at wavelength index li (mu grown
    by li % of mu - 1, grating_dy and the DOE coefficients by 5 li %);
    "widened ..." puts an even and odd asphere after it."""
    widened = name.startswith("widened ")
    base = CYLINDERS[name[len("widened "):] if widened else name]
    kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
              radius=[np.inf, 12., np.inf])
    kw.update(base)
    if widened:
        def ins(v, at, x):
            v = np.asarray(v, float)
            return np.insert(v, at, x, axis=0)
        kw = {k: ins(v, 2, 0. if np.ndim(v) == 1 else np.zeros(
            np.shape(v)[1])) for k, v in kw.items()}
        kw.update(mu=[1., 1/1.5, 1.5/1.6, 1.], n_before=[1., 1., 1.5, 1.6],
                  n_after=[1., 1.5, 1.6, 1.6], distance=[0., 5., 3., 40.],
                  radius=[np.inf, 12., 12., np.inf])
        kw["curvature"] = np.r_[kw["curvature"][:2], -1/60., 0.]
        kw["aspherics"] = [[0., 0.], [0., 0.], [1e-6, -2e-9], [0., 0.]]
        kw["aspherics_odd"] = [[0.], [0.], [3e-6], [0.]]
    mu = np.asarray(kw["mu"])
    kw["mu"] = 1 + (mu - 1)*(1 + .01*li)
    if "grating_dy" in kw:
        kw["grating_dy"] = np.asarray(kw["grating_dy"])*(1 + .05*li)
    if "doe" in kw:
        kw["doe"] = np.asarray(kw["doe"])*(1 + .05*li)
    return JT.make_table(**kw)


def _one(name):
    """(JAX table, port table, JAX specs, port specs)."""
    jt = substrate(name)
    jspecs = JK.specialize(jt)
    return jt, TT.table_from_numpy(jt), jspecs, TK.specs_from_tuple(jspecs)


def _stack(name):
    """(JAX stack, port stack, JAX specs, port specs) of 3 tables."""
    jt = jax.tree_util.tree_map(
        lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
        *[substrate(name, li) for li in range(3)])
    tt = TT.table_from_numpy(jt)
    jspecs = JK.specialize(jax.tree_util.tree_map(lambda a: a[0], jt))
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs)


def _bundle(n, seed, half=3., slope=.01):
    """n rays, x, y uniform in +-half mm, slopes up to `slope`, weights
    in [0.5, 1.5] normalized; ray 0 the chief ray, just off the axis (an
    odd figure's slope is NaN on it)."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-half, half, (n, 2))
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    y[0, :2] = (.05, .03)
    u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


def _state(y, u):
    return tuple(_t(c) for c in (*y.T, *u.T))


def _close_grad(got, want, name):
    """GRAD_REL of the field's largest entry."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    nptest.assert_allclose(got, want, rtol=0,
                           atol=GRAD_REL*max(float(np.abs(want).max()),
                                             1e-300), err_msg=name)


def _leaves(tab, fields):
    return {f: getattr(tab, f).clone().requires_grad_() for f in fields}


def _grads(leaves):
    return {f: torch.zeros_like(v) if v.grad is None else v.grad
            for f, v in leaves.items()}


def _fields(tab, specs):
    """The fields a phase cylinder's merit is differentiated in:
    curvature, conic, offset, mu, curvature_dx, conic_dx, the phase
    fields and (a widened table) the aspheric coefficients."""
    out = ("curvature", "conic", "offset", "mu", "curvature_dx",
           "conic_dx")
    out += (("grating_dy",) if CT.carries_grating(specs) else ())
    out += (("doe",) if CT.doe_width(tab, specs) else ())
    if sum(CG._table_widths(tab)):
        out += ("aspherics", "aspherics_odd")
    return out


def test_specs_and_row_flags():
    """Each case's row 1 is a phase cylinder (cyl_axis 1 or 2 with the
    grating or DOE flag) and its key row word sets its origin beside the
    cylinder: F_BICONIC on a biconic-made cylinder, F_TOROID on a
    toroid-made one; every other row's word is unchanged, and a plain
    cylinder sets no origin."""
    for name in NAMES:
        _, tt, _, specs = _one(name)
        sp = specs[1]
        assert sp.cyl_axis and TK.is_phase(sp) and TK.reads_figure(sp)
        fl = CT._flags(sp)
        cyl = CT.F_CYL_Y if sp.cyl_axis == 1 else CT.F_CYL_X
        origin = CT.F_TOROID if sp.toroidal else CT.F_BICONIC
        assert fl & cyl and fl & origin
        assert not fl & ((CT.F_CYL_Y | CT.F_CYL_X) & ~cyl)
        assert not fl & ((CT.F_BICONIC | CT.F_TOROID) & ~origin)
        plain = sp._replace(grating=False, doe=False)
        assert CT._flags(plain) == cyl | (CT._flags(sp) & ~(
            cyl | origin | CT.F_GRATING | CT.F_DOE))
        assert not TK.reads_figure(plain)


# -- the hand-written reverse -------------------------------------------------

@pytest.mark.parametrize("path", [False, True])
@pytest.mark.parametrize("variant", ["as is", "rotated", "mirror"])
@pytest.mark.parametrize("name", NAMES)
def test_phase_cylinder_step_vjp_matches_autograd(name, variant, path):
    """_step_vjp_reference on the phase cylinder (as is, rotated and off
    axis, and as a mirror; K5's form, and with path K9's PATH form)
    against autograd of kernels.surface_step_spec's state (and optical
    path) ray by ray, every row parameter expanded to one copy a ray:
    the state, c, k, the offset, mu, (PATH) n_before, the coefficients
    of the table's widths, curvature_dx, conic_dx, grating_dy, (PATH)
    n_after and the DOE coefficients, to GRAD_REL of each slot's
    largest, on the live rays."""
    _, tab, _, specs = _one(name)
    spec, row = specs[1], tab.row(1)
    if variant != "as is":
        th = .03
        rot = _t([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                  [0, np.sin(th), np.cos(th)]])
        row = row._replace(rot=rot, offset=row.offset + _t([.1, -.2, 0.]))
        spec = spec._replace(rotated=True, off_axis=True)
    if variant == "mirror":
        row = row._replace(mu=_t(-1.))
        spec = spec._replace(kind=2)
    n = 48
    y, u, _ = _bundle(n, 17, 3., .01)
    y[:, 2] = -2.
    state = [c.requires_grad_() for c in _state(y, u)]
    scal = ["curvature", "conic", "mu", "n_before", "n_after",
            "curvature_dx", "conic_dx", "grating_dy"]
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in scal}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    coeffs = {f: getattr(row, f).expand(n, -1).clone().requires_grad_()
              for f in ("aspherics", "aspherics_odd", "doe")}
    surf = row._replace(offset=offset, **per_ray, **coeffs)
    out, loc = TK.surface_step_spec(tuple(state), surf, spec, False)
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert int(live.sum()) > n//2
    rng = np.random.RandomState(7)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    ct = torch.from_numpy(rng.normal(size=n)) if path else None
    total = sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g))
    if path:
        total = total + (torch.where(live, loc[3], 0.)*ct).sum()
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"]] + ([per_ray["n_before"]] if path else [])
    nq = len(leaves)
    leaves += [coeffs["aspherics"], coeffs["aspherics_odd"],
               per_ray["curvature_dx"], per_ray["conic_dx"]]
    # grating_dy's slot (zero on a DOE that is no grating: _phase_tail)
    leaves.append(per_ray["grating_dy"])
    if spec.doe:
        leaves += ([per_ray["n_after"]] if path else []) + [coeffs["doe"]]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, grads)]
    cols = want[:8] + [want[8][0], want[8][1], want[8][2]] + want[9:nq]
    for blk in want[nq:nq + 2]:
        cols += [blk[:, i] for i in range(blk.shape[-1])]
    cols += want[nq + 2:nq + 4]
    rest = want[nq + 4:]
    for blk in rest:
        cols += [blk] if blk.dim() == 1 else [blk[:, i] for i in
                                              range(blk.shape[-1])]
    got_state, got_p = CG._step_vjp_reference(
        tuple(c.detach() for c in state), row, spec, g, ct_path=ct)
    assert len(got_state) + len(got_p) == len(cols)
    for i, (a, b) in enumerate(zip((*got_state, *got_p), cols)):
        a = torch.broadcast_to(a, b.shape)[live]
        b = b[live]
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=GRAD_REL*max(float(b.abs().max()),
                                                 1e-300),
                               err_msg="slot %d" % i)


@pytest.mark.parametrize("name", NAMES)
def test_adjoints_by_hand_match_plain(name):
    """K5 (_merit_adjoint_by_hand), K7 (_merit_adjoint_multi_by_hand, on
    the 3-table stack) and K9 (_opd_adjoint_by_hand) written in torch
    against their autograd plain versions: the parameter cotangents to
    1e-10 of each column's largest (the phase cylinder's curvature_dx
    column nonzero), the rays' to GRAD_REL relative."""
    _, tab, _, specs = _one(name)
    y, u, w = _bundle(96, 8)
    state = _state(y, u)
    ct = torch.from_numpy(np.random.RandomState(9).normal(size=5))
    ref = CG.merit_adjoint_reference(tab, specs, state, _t(w), ct)
    got = CG._merit_adjoint_by_hand(tab, specs, state, _t(w), ct)
    q = CG._nslots(tab, specs) - int(CT.carries_grating(specs)) \
        - CT.doe_width(tab, specs) - CT.ANAM
    assert bool(ref[0][1, q] != 0)
    scale = ref[0].abs().amax(0).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12)
    _, tt, _, sspecs = _stack(name)
    ct3 = torch.from_numpy(np.random.RandomState(10).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, sspecs, state, _t(w), ct3)
    got = CG._merit_adjoint_multi_by_hand(tt, sspecs, state, _t(w), ct3)
    scale = ref[0].abs().amax((0, 1)).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    yr, _, _ = trace_rays_final(tab, _t(y[:1]), _t(u[:1]), specs=specs)
    aux = torch.cat([yr[0], torch.tensor([SUB_OPD["radius"], 550.],
                                         dtype=F64)])
    cts = tuple(torch.from_numpy(v)
                for v in np.random.RandomState(11).normal(size=(3, 96)))
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts)
    scale = ref[0].abs().amax(0).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12*float(b.abs().max()))


# -- the merits' gradients against jax.grad ----------------------------------

def _zero_baked(got, specs, tab):
    """The slots the keys bake out (cuda_spec.baked_out_rows) hold exact
    zeros: jax.grad's there must be zero too (the slot rule)."""
    for f, g in got.items():
        rows = CS.baked_out_rows(specs, f)
        if f == "offset":
            g = g[:, :2]
        if rows:
            assert not bool(g[rows].any()), f


@pytest.mark.parametrize("name", NAMES)
def test_spot_rms_gradients_match_jax_grad(name):
    """The spot RMS (parallel.grad.spot_rms, autograd through the
    specialized plain path: K4/K5's plain versions) differentiated in
    every field of _fields against jax.grad of the JAX package's
    spot_rms(specs=, unroll=True), to GRAD_REL of each field's largest:
    curvature_dx and (widened) the aspheric coefficients on the phase
    cylinder row nonzero, where the keys keep their slots live, and
    each slot the keys bake out zero in jax.grad too."""
    jt, tt, jspecs, specs = _one(name)
    sel = _fields(tt, specs)
    y, u, w = _bundle(128, 13)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: JGR.spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True)))(p0)
    leaves = _leaves(tt, sel)
    v = TGR.spot_rms(tt.replace(**leaves), _t(y), _t(u), _t(w), specs=specs)
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    got = _grads(leaves)
    for f in sel:
        _close_grad(got[f], jg[f], f)
    assert bool(got["curvature_dx"][1] != 0)
    if "aspherics" in sel:
        assert bool(got["aspherics"][1].all())
        assert bool(got["aspherics_odd"][1].all())
    _zero_baked({f: torch.from_numpy(np.asarray(jg[f])) for f in sel},
                specs, tt)
    live = CS.live_slots(specs, CS.FIELDS, CT.figure_widths(tt, specs),
                         CT.doe_width(tt, specs))
    cdx = CS.SLOTS + sum(CT.figure_widths(tt, specs))
    assert live[1] >> cdx & 1
    assert bool(live[1] >> (cdx + 1) & 1) == (specs[1].cyl_axis == 2)
    if "aspherics" in sel:
        assert all(live[1] >> q & 1 for q in range(CS.SLOTS, cdx))


@pytest.mark.parametrize("name", NAMES)
def test_polychromatic_adjoint_matches_jax_grad(name):
    """glass.polychromatic_spot_rms(engine="adjoint") (K6/K7's plain
    versions here) on the 3-table stack against jax.value_and_grad of
    the JAX package's XLA engine (specs, unroll=True): the value to
    RTOL, the gradient of curvature, offset, mu, curvature_dx and the
    phase fields to GRAD_REL of each field's largest."""
    jt, tt, jspecs, specs = _stack(name)
    sel = ("curvature", "offset", "mu", "curvature_dx") + (
        ("grating_dy",) if CT.carries_grating(specs) else ("doe",))
    y, u, w = _bundle(96, 4)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: JGL.polychromatic_spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True)))(p0)
    leaves = _leaves(tt, sel)
    with pytest.warns(UserWarning, match="baked out"):
        v = TGL.polychromatic_spot_rms(tt.replace(**leaves), _t(y), _t(u),
                                       _t(w), specs=specs, engine="adjoint")
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    got = _grads(leaves)
    for f in sel:
        _close_grad(got[f], jg[f], f)
    assert bool(got["curvature_dx"][:, 1].all())


@pytest.mark.parametrize("name", NAMES)
def test_adjoint_wavefront_rms_matches_jax_grad(name):
    """adjoint_wavefront_rms (K8/K9's plain versions here) against
    jax.value_and_grad (jitted) of the JAX package's wavefront_rms(
    specs=, unroll=True): the value to 1e-12 relative, the gradient of
    curvature, offset, n_before, n_after, curvature_dx, conic_dx and the
    phase fields and of the rays to GRAD_REL of each one's largest."""
    jt, tt, jspecs, specs = _one(name)
    sel = ("curvature", "offset", "n_before", "n_after", "curvature_dx",
           "conic_dx") + (("grating_dy",) if CT.carries_grating(specs)
                          else ("doe",))
    y, u, w = _bundle(96, 5)
    kw = SUB_OPD
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, (jg, jgy) = jax.jit(jax.value_and_grad(
        lambda p, y0: JGR.wavefront_rms(jt.replace(**p), y0, u, w,
                                        specs=jspecs, unroll=True, **kw),
        argnums=(0, 1)))(p0, jnp.asarray(y))
    leaves = _leaves(tt, sel)
    y0 = _t(y).requires_grad_()
    with pytest.warns(UserWarning, match="baked out"):
        v = CG.adjoint_wavefront_rms(tt.replace(**leaves), y0, _t(u), _t(w),
                                     specs=specs, **kw)
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=1e-12,
                           atol=1e-9)
    got = _grads(leaves)
    _close_grad(y0.grad, jgy, "y0")
    for f in sel:
        _close_grad(got[f], jg[f], f)
    assert bool(got["curvature_dx"][1] != 0)


# -- the keys -----------------------------------------------------------------

def _makes(specs, tab):
    w, nd = CT.figure_widths(tab, specs), CT.doe_width(tab, specs)
    kw = dict(widths=w, nd=nd)
    return {"k1": CS.trace_key(specs, F64, **kw),
            "k2": CS.merit_key(specs, F64, **kw),
            "k3": CS.trace_multi_key(specs, F64, 2, **kw),
            "k3m": CS.trace_multi_key(specs, F64, 2, True, **kw),
            "k4": CS.moments_key(specs, F64, **kw),
            "k5": CS.adjoint_key(specs, F64, **kw),
            "k6": CS.moments_multi_key(specs, F64, False, 2, **kw),
            "k7": CS.adjoint_multi_key(specs, F64, **kw),
            "k8": CS.opd_key(specs, F64, **kw),
            "k9": CS.opd_adjoint_key(specs, F64, **kw)}


@pytest.mark.parametrize("name", NAMES)
def test_every_key_takes_the_phase_cylinder(name):
    """Every K1-K9 key takes the phase cylinder: its row word carries the
    cylinder's flag, its origin's and the phase flag; the key carries
    the table's aspheric widths (the cylinder's normal reads them), the
    anamorphic words and the phase words; K5's and K7's live slots on
    the row are c, k, the axial offset, mu, every coefficient,
    curvature_dx (conic_dx too on an x-cylinder, whose intercept reads
    it; on a y-cylinder its cotangent is exactly zero: baked out) and
    the phase slots; K9's n_before too (and n_after on a DOE); the
    translation units define the widths."""
    _, tt, _, specs = _one(name)
    widths = CT.figure_widths(tt, specs)
    assert widths == CG._table_widths(tt)
    grating, nd = CT.carries_grating(specs), CT.doe_width(tt, specs)
    sp = specs[1]
    for kernel, key in _makes(specs, tt).items():
        assert key.kernel == kernel
        assert (key.na, key.no) == widths and key.anamorphic
        assert (key.grating, key.nd) == (grating, nd)
        fl = key.words[1] & ((1 << CS.LIVE_SHIFT) - 1)
        assert fl == CT._flags(sp)
        unit = CS.translation_unit(key)
        if sum(widths):
            assert "#define RAYOPT_N_ASP %d\n" % widths[0] in unit
        assert "#define RAYOPT_N_ANAM 2\n" in unit
    keys = _makes(specs, tt)
    na, no = widths
    cdx = CS.SLOTS + na + no
    live = keys["k5"].words[1] >> CS.LIVE_SHIFT
    want = {0, 1, 4, 5} | set(range(CS.SLOTS, cdx)) | {cdx}
    if sp.cyl_axis == 2:
        want |= {cdx + 1}
    want |= set(range(cdx + 2, cdx + 2 + int(grating) + nd))
    assert {q for q in range(keys["k5"].slots) if live >> q & 1} == want
    assert keys["k7"].words == keys["k5"].words
    # K9: n_before at slot 6 shifts the rest by one, n_after (a DOE's)
    # before the DOE coefficients
    live9 = keys["k9"].words[1] >> CS.LIVE_SHIFT
    q9 = {q + (q >= 6) for q in want} | {6}
    if nd:
        first = cdx + 3 + int(grating)
        q9 = {q + (q >= first) for q in q9} | {first}
    assert {q for q in range(keys["k9"].slots) if live9 >> q & 1} == q9
