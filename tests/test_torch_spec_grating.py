"""The kernel side of rayopt_tpu_torch's grating and DOE rows, in float64
on the CPU: K5's hand-written reverse of the generalized Spencer &
Murty solve (cuda_grad._step_vjp_reference, the line-for-line model of
csrc/step_vjp.cuh grating_refract_vjp and its substrates) against
autograd on the phase rows of the lenses of tests/test_torch_grating.py
and on gratings and DOEs on an asphere, a biconic, a toroid and a flat,
the K5 model of the whole merit against the plain version, the key
words (F_GRATING, F_DOE below LIVE_SHIFT), the packed rows and K5's
grating_dy and DOE slots, the baked-out phase slots and their warning,
the keys of K3 and K6-K9 on the phase rows (their slots: K7's as K5's,
K9's with n_after), the df32 plan of the phase rows (traced as the JAX
package's eager df32: tests/test_torch_df32_phase.py) and a phase row
on a cylinder in every key (tests/test_torch_spec_phase_cylinder.py),
what still refuses (freeform rows everywhere: item 9.5), and
optimize_grad(engine="adjoint") over
curvature, distance and doe on the hybrid achromat against the JAX
package.  The paths of K3 and K6-K9 on the phase rows are
tests/test_torch_spec_grating_paths.py.  The kernels
themselves build and run only on a CUDA card
(tests/test_torch_cuda.py)."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import df32 as TD
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _t, bundle)
from test_torch_df32_newton import df32_matches_jax
from test_torch_grating import LENSES, PHASE_ROWS, lens

F64 = torch.float64


def _state(y0, u0):
    return tuple(_t(c) for c in (*y0.T, *u0.T))


#: gratings and DOEs on the substrates the lenses lack: an even and odd
#: asphere, a biconic, a toroid, a flat (make_table keyword arguments;
#: the phase row is row 1)
SUBSTRATES = {
    "asphere": dict(curvature=[0., 1/80., 0.], conic=[0., -.5, 0.],
                    aspherics=[[0., 0.], [1e-6, -2e-9], [0., 0.]],
                    aspherics_odd=[[0.], [3e-6], [0.]],
                    grating_dy=[0., .15, 0.], doe=[[0.], [-1e-3], [0.]]),
    "biconic": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., .004, 0.],
                    conic_dx=[0., .3, 0.], doe=[[0., 0.], [-2e-3, 1e-6],
                                                [0., 0.]]),
    "toroid": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., -.01, 0.],
                   toroidal=[0., 1., 0.], conic=[0., -.2, 0.],
                   grating_dy=[0., .2, 0.], doe=[[0.], [-1.5e-3], [0.]]),
    "flat": dict(curvature=[0., 0., 0.], grating_dy=[0., -.25, 0.],
                 doe=[[0., 0.], [-1e-3, 2e-7], [0., 0.]])}


def substrate(name):
    """The port table of SUBSTRATES[name]: a phase row between the object
    and an image plane, glass after it."""
    kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
              radius=[np.inf, 12., np.inf])
    kw.update(SUBSTRATES[name])
    return TT.table_from_numpy(JT.make_table(**kw))


def _cases():
    """(label, table, row) of every phase row the reverse is held on."""
    out = [("lens", name, j) for name in sorted(LENSES)
           for j in PHASE_ROWS[name]]
    return out + [("substrate", name, 1) for name in sorted(SUBSTRATES)]


def _table(kind, name):
    return lens(name)[1].table() if kind == "lens" else substrate(name)


# -- the hand-written reverse -------------------------------------------------

@pytest.mark.parametrize("variant", ["as is", "rotated", "mirror"])
@pytest.mark.parametrize("kind,name,j", _cases())
def test_phase_step_vjp_matches_autograd(kind, name, j, variant):
    """_step_vjp_reference on a grating or DOE row (as is, rotated and
    off axis, and as a mirror) against autograd through
    kernels.surface_step_spec: the entering state's and the parameters'
    cotangents (c, k, offset, mu, the aspheric coefficients of a figured
    substrate, curvature_dx and conic_dx of an anamorphic one, grating_dy
    and the DOE coefficients) to 1e-10 of each one's largest, on the live
    rays."""
    tt = _table(kind, name)
    spec = TK.specialize(tt)[j]
    surf = tt.row(j)
    if variant != "as is":
        th = .03
        rot = _t([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                  [0, np.sin(th), np.cos(th)]])
        surf = surf._replace(rot=rot, offset=surf.offset + _t([.1, -.2, 0.]))
        spec = spec._replace(rotated=True, off_axis=True)
    if variant == "mirror":
        surf = surf._replace(mu=_t(-1.))
        spec = spec._replace(kind=2)
    y0, u0 = bundle(48, 17 + j, 3., .01)
    y0[:, 0] += .1
    y0[:, 2] = -2.
    state = _state(y0, u0)
    names = ["curvature", "conic", "offset", "mu"]
    if TK.reads_figure(spec):
        names += ["aspherics", "aspherics_odd"]
    if TK.is_anamorphic_spec(spec):
        names += ["curvature_dx", "conic_dx"]
    names += ["grating_dy"] + (["doe"] if spec.doe else [])
    leaves = {f: getattr(surf, f).clone().requires_grad_() for f in names}
    st = tuple(c.clone().requires_grad_() for c in state)
    out, _ = TK.surface_step_spec(st, surf._replace(**leaves), spec, False)
    gen = torch.Generator().manual_seed(j)
    g = tuple(torch.randn(48, dtype=F64, generator=gen) for _ in range(6))
    live = torch.isfinite(torch.stack(out)).all(0)
    assert int(live.sum()) > 40
    total = sum((torch.where(live, o, 0.)*c).sum() for o, c in zip(out, g))
    auto = torch.autograd.grad(total, [*st, *leaves.values()],
                               allow_unused=True)
    auto = [torch.zeros(()) if a is None else a for a in auto]
    gs, pg = CG._step_vjp_reference(state, surf, spec, g)
    for a, b in zip(auto[:6], gs):
        b = torch.where(live, b, 0.)
        nptest.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-10*float(a.abs().max()))
    sums = [torch.where(live, p, 0.).sum() for p in pg]
    want = [v.reshape(-1) for v in auto[6:]]
    want = [w for v in want for w in v]
    # a DOE that is no grating returns grating_dy's slot as a zero, as
    # autograd gives (the step does not read it)
    assert len(sums) == len(want), (len(sums), len(want))
    scale = max(float(max(abs(float(w)) for w in want)), 1e-300)
    for k, (a, b) in enumerate(zip(want, sums)):
        nptest.assert_allclose(float(b), float(a), rtol=1e-10,
                               atol=1e-12*scale, err_msg="slot %d" % k)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("kind,name", [(k, n) for k, n, _ in _cases()])
def test_merit_adjoint_by_hand_matches_the_plain_version(kind, name, clip):
    """_merit_adjoint_by_hand (K5 in torch, row by row with the hand
    reverse) against merit_adjoint_reference (autograd): the (S, SLOTS +
    ... + 1 + nd) parameter cotangents, grating_dy and the DOE
    coefficients last, to 1e-10 of each column's largest; the ray and
    weight cotangents to 1e-10."""
    tt = _table(kind, name)
    specs = TK.specialize(tt)
    y0, u0 = bundle(64, 3, 4. if clip else 3., .01)
    y0[:, 0] += .1
    state = _state(y0, u0)
    w = torch.full((64,), 1/64, dtype=F64)
    ct = _t([.3, -.2, .5, 1., .7])
    pr, sr, wr = CG.merit_adjoint_reference(tt, specs, state, w, ct, clip)
    ph, sh, wh = CG._merit_adjoint_by_hand(tt, specs, state, w, ct, clip)
    nd = CT.doe_width(tt, specs)
    assert pr.shape == ph.shape == (tt.nsurfaces, CG._nslots(tt, specs))
    assert pr.shape[1] == (CS.SLOTS + sum(CG._table_widths(tt))
                           + (CT.ANAM if CT.carries_anamorphic(specs) else 0)
                           + int(CT.carries_grating(specs)) + nd)
    scale = pr.abs().max(0).values.clamp(min=1e-300)
    assert float(((ph - pr).abs()/scale).max()) <= 1e-10
    for a, b in zip((*sh, wh), (*sr, wr)):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-10*max(float(b.abs().max()), 1e-300))


# -- the keys -----------------------------------------------------------------

def test_key_words_rows_and_slots():
    """The phase keys: F_GRATING and F_DOE below LIVE_SHIFT (17), rows
    packed with grating_dy, n_after and the DOE coefficients, K5's
    SLOTS [+ na + no] + 1 + nd slots with grating_dy live on the grating
    row and the coefficients on the DOE row only, the units'
    RAYOPT_N_GRAT and RAYOPT_N_DOE; the forward keys carry the rows and
    no slots; a table without a phase row keys as before."""
    assert (CT.F_GRATING, CT.F_DOE) == (1 << 14, 1 << 15)
    assert CS.LIVE_SHIFT == 17 and CS.LIVE_BITS == 46
    # K9's layout, OPD_SLOTS + na + no + 2 + 1 + 1 + nd, fits a word for
    # the widths of the tables here
    assert CS.OPD_SLOTS + 4 + 2 + 1 + 1 + 4 <= CS.LIVE_BITS
    tt = substrate("flat")
    specs = TK.specialize(tt)
    key = CS.adjoint_key(specs, F64, nd=CT.doe_width(tt, specs))
    assert key.grating and key.nd == 2
    assert key.slots == CS.SLOTS + 1 + 2
    assert key.row_words == CT.ROW + 1 + 1 + 2
    flags = [w & ((1 << CS.LIVE_SHIFT) - 1) for w in key.words]
    assert flags[1] & CT.F_GRATING and flags[1] & CT.F_DOE
    assert not (flags[2] & (CT.F_GRATING | CT.F_DOE))
    live = [w >> CS.LIVE_SHIFT for w in key.words]
    q = CS.SLOTS
    assert [m >> q & 7 for m in live] == [0, 7, 0]
    unit = CS.translation_unit(key)
    assert "#define RAYOPT_N_GRAT 1\n" in unit
    assert "#define RAYOPT_N_DOE 2\n" in unit
    packed = CS.packed(tt, specs, tt.curvature)
    assert packed.shape == (tt.nsurfaces, CT.ROW + 4)
    nptest.assert_array_equal(packed[:, CT.ROW].numpy(), tt.grating_dy)
    nptest.assert_array_equal(packed[:, CT.ROW + 1].numpy(), tt.n_after)
    nptest.assert_array_equal(packed[:, CT.ROW + 2:].numpy(), tt.doe)
    for make in (CS.trace_key, CS.merit_key, CS.moments_key):
        k = make(specs, F64, nd=2)
        assert k.grating and k.nd == 2 and k.nlive == 0
        with pytest.raises(ValueError, match="DOE width"):
            make(specs, F64)
    # the hybrid: a DOE key without a grating, the coefficients after the
    # six columns; the spectrograph: a grating key without DOE words
    ht = lens("hybrid_achromat")[1].table()
    hs = TK.specialize(ht)
    k = CS.adjoint_key(hs, F64, nd=CT.doe_width(ht, hs))
    assert not k.grating and k.nd == 1 and k.slots == CS.SLOTS + 1
    st = lens("spectrograph")[1].table()
    ss = TK.specialize(st)
    assert CT.doe_width(st, ss) == 0
    k = CS.adjoint_key(ss, F64)
    assert k.grating and k.nd == 0 and k.row_words == CT.ROW + 1
    plain = TK.specialize(ht.replace(doe=torch.zeros_like(ht.doe)))
    k = CS.adjoint_key(plain, F64)
    assert not k.grating and not k.nd and k.slots == CS.SLOTS
    # a phase row on an anamorphic figured substrate: every word in order
    bt = substrate("biconic")
    bs = TK.specialize(bt)
    k = CS.adjoint_key(bs, F64, nd=2)
    assert k.anamorphic and k.nd == 2
    assert k.slots == CS.SLOTS + CT.ANAM + 2
    assert CS.packed(bt, bs, bt.curvature).shape[1] == CT.ROW + CT.ANAM + 3


def test_phase_slots_bake_out_and_warn():
    """grating_dy is live on a grating row only and the DOE coefficients
    on a DOE row only (the reference's rule keeps them everywhere):
    differentiating grating_dy through the adjoint engine on a table
    whose other rows are no gratings warns; its gradient there is
    exactly zero, on the grating row not."""
    tt = substrate("asphere")
    specs = TK.specialize(tt)
    assert CS.baked_out_rows(specs, "grating_dy") == [2]
    assert CS.baked_out_rows(specs, "doe") == [2]
    # a phase row keeps its curvature and conic, as the reference's rule
    fspecs = TK.specialize(substrate("flat"))
    assert 1 not in CS.baked_out_rows(fspecs, "curvature")
    assert 1 not in CS.baked_out_rows(fspecs, "conic")
    y0, u0 = bundle(64, 5, 3.)
    gdy = tt.grating_dy.clone().requires_grad_()
    with pytest.warns(UserWarning, match="grating_dy"):
        v = CG.adjoint_spot_rms(tt.replace(grating_dy=gdy), _t(y0), _t(u0),
                                specs=specs)
    v.backward()
    assert float(gdy.grad[2]) == 0. and float(gdy.grad[1]) != 0.


def test_adjoint_spot_rms_gradients_match_autograd():
    """adjoint_spot_rms (K4/K5's plain versions on the CPU, through
    _SpotMoments) against autograd through the specialized spot_rms on
    the curved hybrid and the toroid substrate: curvature, grating_dy and
    doe to 1e-10 of each field's largest."""
    for tt in (lens("curved hybrid")[1].table(), substrate("toroid")):
        specs = TK.specialize(tt)
        y0, u0 = bundle(128, 9, 3., .01)
        fields = ("curvature", "grating_dy", "doe")
        grads = []
        for fn in (CG.adjoint_spot_rms, TGR.spot_rms):
            leaves = {f: getattr(tt, f).clone().requires_grad_()
                      for f in fields}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the baked rows
                fn(tt.replace(**leaves), _t(y0), _t(u0),
                   specs=specs).backward()
            grads.append([torch.zeros_like(v) if v.grad is None else v.grad
                          for v in leaves.values()])
        for f, a, b in zip(fields, *grads):
            nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-10*max(float(b.abs().max()),
                                                  1e-300), err_msg=f)


def _phase_specs():
    kw = dict(curvature=[0., 1/40., 0.], mu=[1., 1/1.5, 1.],
              distance=[0., 5., 10.])
    return {"grating": dict(kw, grating_dy=[0., .1, 0.]),
            "doe": dict(kw, doe=[[0.], [-1e-3], [0.]])}


@pytest.mark.parametrize("name", ["grating", "doe"])
def test_the_other_kernels_refuse_phase_rows(name):
    """No kernel refuses a grating or DOE row now: the df32 plan plans
    it (its grating term, or the DOE's kick and path coefficients) and
    traces it as the JAX package's eager df32 does, word for word with
    the optical path.  The keys of K3 (trace and merit), K6, K7, K8 and
    K9, as K1, K2, K4 and K5's, take it: grating and nd set, the rows
    packed with
    grating_dy and with n_after and the DOE coefficients; K7's slots are
    K5's (SLOTS [+ 1] [+ nd]), K9's OPD_SLOTS [+ 1] [+ 1 + nd] with
    n_after live on the DOE row alone; a DOE key without its width
    raises.  Their plain versions on the CPU trace it."""
    tt = TT.table_from_numpy(JT.make_table(**_phase_specs()[name]))
    specs = TK.specialize(tt)
    nd = CT.doe_width(tt, specs)
    grating = name == "grating"
    assert nd == (0 if grating else 1)
    steps = TD.plan(tt)
    assert (steps[0]["grat"] is not None) == grating
    assert (steps[0]["doe"] is not None) == (not grating)
    y, u = bundle(16, 3, 3.)
    assert df32_matches_jax(tt, y, u)
    makes = {"k1": lambda sp, **kw: CS.trace_key(sp, F64, **kw),
             "k2": lambda sp, **kw: CS.merit_key(sp, F64, **kw),
             "k3": lambda sp, **kw: CS.trace_multi_key(sp, F64, 2, **kw),
             "k3m": lambda sp, **kw: CS.trace_multi_key(sp, F64, 2, True,
                                                        **kw),
             "k4": lambda sp, **kw: CS.moments_key(sp, F64, **kw),
             "k5": lambda sp, **kw: CS.adjoint_key(sp, F64, **kw),
             "k6": lambda sp, **kw: CS.moments_multi_key(sp, F64, False, 2,
                                                         **kw),
             "k7": lambda sp, **kw: CS.adjoint_multi_key(sp, F64, **kw),
             "k8": lambda sp, **kw: CS.opd_key(sp, F64, **kw),
             "k9": lambda sp, **kw: CS.opd_adjoint_key(sp, F64, **kw)}
    for kernel, make in makes.items():
        key = make(specs, nd=nd)
        assert key.kernel == kernel
        assert (key.grating, key.nd) == (grating, nd)
        assert key.row_words == CT.ROW + (1 if grating else 2)
        flags = key.words[1] & ((1 << CS.LIVE_SHIFT) - 1)
        assert bool(flags & CT.F_GRATING) == grating
        assert bool(flags & CT.F_DOE) == (not grating)
        if kernel in ("k5", "k7"):
            assert key.slots == CS.SLOTS + 1
            assert key.words[1] >> CS.LIVE_SHIFT >> CS.SLOTS == 1
        elif kernel == "k9":
            assert key.slots == CS.OPD_SLOTS + (1 if grating else 2)
            # grating_dy, or n_after and the coefficient, live on row 1
            # only (the image row's slots are the tail's)
            live = [w >> CS.LIVE_SHIFT >> CS.OPD_SLOTS for w in key.words]
            assert live == [0, 1 if grating else 3, 0]
        else:
            assert key.nlive == 0
        if not grating:
            with pytest.raises(ValueError, match="DOE width"):
                make(specs)
    state = _state(*bundle(8, 1, 2.))
    out, _ = CT.trace_final(tt, specs, state)
    assert torch.isfinite(out[0]).all()
    tabs = type(tt)(*(None if f is None else torch.stack([f, f])
                      for f in tt))
    for (x, *_), _ in CT.trace_multi(tabs, specs, state):
        nptest.assert_array_equal(x.numpy(), out[0].numpy())


def test_a_phase_cylinder_and_a_freeform_row_refuse():
    """A grating on a cylinder: the plain path traces it, and every K1-K9
    key and the hand reverse (K5's and K9's PATH form) take it (the key
    row marks the biconic that made the cylinder; the reverse against
    autograd: tests/test_torch_spec_phase_cylinder.py).  A freeform row
    is traced by the specialized and the generic step and taken by the
    K1, K3 and K8 keys, each carrying the table's XY width
    (tests/test_torch_freeform.py, tests/test_torch_spec_freeform_
    paths.py), and the df32 plan traces it as the JAX package's eager
    df32 does (tests/test_torch_df32_freeform.py): no row refuses
    now."""
    kw = dict(curvature=[0., 1/40., 0.], curvature_dx=[0., -1/40., 0.],
              mu=[1., 1/1.5, 1.], distance=[0., 5., 10.],
              grating_dy=[0., .1, 0.])
    tt = TT.table_from_numpy(JT.make_table(**kw))
    specs = TK.specialize(tt)
    assert specs[1].cyl_axis == 1 and specs[1].grating
    state = _state(*bundle(8, 1, 2.))
    out, _ = TK.surface_step_spec(state, tt.row(1), specs[1], False)
    assert all(torch.isfinite(c).all() for c in out)
    for make in (CS.trace_key, CS.merit_key, CS.moments_key,
                 CS.adjoint_key, CS.adjoint_multi_key, CS.opd_key,
                 CS.opd_adjoint_key,
                 lambda sp, dt: CS.trace_multi_key(sp, dt, 2),
                 lambda sp, dt: CS.trace_multi_key(sp, dt, 2, merit=True),
                 lambda sp, dt: CS.moments_multi_key(sp, dt, False, 2)):
        key = make(specs, F64)
        assert key.grating and key.anamorphic
        fl = key.words[1] & ((1 << CS.LIVE_SHIFT) - 1)
        assert fl & CT.F_CYL_Y and fl & CT.F_BICONIC and fl & CT.F_GRATING
    g = tuple(torch.from_numpy(v) for v in
              np.random.RandomState(2).normal(size=(6, 8)))
    for ct_path in (None, torch.ones(8, dtype=F64)):
        gs, gp = CG._step_vjp_reference(state, tt.row(1), specs[1], g,
                                        ct_path=ct_path)
        assert all(torch.isfinite(v).all() for v in (*gs, *gp))
        # curvature_dx's cotangent: the normal of the biconic (cx = 0)
        q = 6 + (ct_path is not None)
        assert bool(gp[q].any())
    kw = dict(curvature=[0., 1/40.], mu=[1., 1/1.5],
              xy_poly=[[0.]*5, [0., 0., 1e-3, 0., 0.]])
    ft = TT.table_from_numpy(JT.make_table(**kw))
    fspecs = TK.specialize(ft)
    out, _ = TK.surface_step_spec(state, ft.row(1), fspecs[1], False)
    assert all(torch.isfinite(c).all() for c in out)
    out, _ = TK.surface_step(state, ft.row(1), False)
    assert all(torch.isfinite(c).all() for c in out)
    nxy = CT.xy_width(ft, fspecs)
    assert CS.trace_key(fspecs, F64, nxy=nxy).nxy == 5
    assert CS.trace_multi_key(fspecs, F64, 2, nxy=nxy).nxy == 5
    assert CS.opd_key(fspecs + fspecs[-1:], F64, nxy=nxy).nxy == 5
    assert TD.plan(ft)[0]["anam"]["mode"] == "freeform"
    y0 = np.zeros((8, 3))
    y0[:, 0] = np.linspace(-3, 3, 8)
    y0[:, 1] = np.linspace(2, -2, 8)
    u0 = np.zeros((8, 3))
    u0[:, 2] = 1.
    assert df32_matches_jax(ft, y0, u0)


# -- the loop -----------------------------------------------------------------

def test_optimize_grad_adjoint_on_the_hybrid_matches_jax():
    """optimize_grad(engine="adjoint", select=("curvature", "distance",
    "doe")) on the hybrid achromat, 3 Adam steps on the CPU at 2^10 rays
    a bundle (fields 0 and 1, the three wavelengths), against the JAX
    package's optimize_grad on the same bundles, its merit the
    specialized spot_rms with the reference's chroma override: histories
    within 1e-9 relative, tables too."""
    js, ts = lens("hybrid_achromat")
    jb = JGR.bundles_from_system(js, fields=(0., 1.), nrays=32,
                                 pad_to=1024)
    assert all(b[0].shape[0] == 1024 for b in jb)
    jt = js.table()
    specs = JK.specialize(jt)
    sel = ("curvature", "distance", "doe")
    scales = {"doe": 1e-4}

    def merit(tab):
        total = 0.
        for y, u, w, chroma in jb:
            t2 = tab.replace(**{k: v for k, v in chroma.items()
                                if k != "wavelength"})
            total = total + JGR.spot_rms(t2, y, u, w, specs=specs,
                                         unroll=True)
        return total
    jt2, jh = JGR.optimize_grad(jt, jb, select=sel, steps=3, lr=1e-4,
                                merit=merit, scales=scales)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the baked rows, as intended
        tt2, th = TGR.optimize_grad(ts.table(), TGR.bundles_from_numpy(jb),
                                    select=sel, steps=3, lr=1e-4,
                                    engine="adjoint", scales=scales)
    nptest.assert_allclose(th, jh, rtol=1e-9)
    assert th[-1] < th[0]
    for k in sel:
        want = np.asarray(getattr(jt2, k))
        nptest.assert_allclose(getattr(tt2, k).numpy(), want, rtol=1e-9,
                               atol=1e-9*np.abs(want).max(), err_msg=k)
    assert float(tt2.doe[2, 0]) != float(jt.doe[2, 0])
