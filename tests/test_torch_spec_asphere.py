"""The kernel side of the aspheric rows, on the CPU: the hand-derived
reverse that K5 runs on an aspheric row (cuda_grad._step_vjp_reference,
the model of csrc/step_vjp.cuh figured_step_vjp) against torch
autograd of the plain step, an on-axis ray and a ray the Newton does
not converge included; the whole K5 chain by hand against its plain
version; the K1, K2, K4 and K5 keys of aspheric spec tuples (flags,
coefficient widths, live slots, the translation unit's words); the
aspheric keys and wrappers of K3 and K6-K9 (their checks against the
JAX package: tests/test_torch_spec_asphere_paths.py), the refusals of
the df32 plan (ROADMAP Queue 1 item 9) and of the anamorphic rows
everywhere; the adjoint engine's gradient and
optimize_grad(engine="adjoint") over aspheric coefficients against the
JAX package.  float64; tolerances as stated at each check.  The kernels
themselves build and run only on a CUDA card
(tests/test_torch_cuda.py)."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import df32 as TD
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_df32_newton import df32_matches_jax
from test_torch_asphere import (FIGURED_ROWS, _lens, _t, aspheric_doublet,
                                figured_row, grad_bundle)

F32, F64 = torch.float32, torch.float64
RTOL, ATOL = 1e-9, 1e-12
#: a ray whose conic seed hits the "even" row but whose Newton on the
#: true figure does not converge (found by a scan of the row)
NONCONVERGED = ((4.556789733370756, 25.757771854572844, -2.),
                (0.4425024422962086, 0.3282546852328637))


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _rays(n, seed, height=9., slope=.15):
    """Rays entering a figured row: ray 0 exactly on the axis, the last
    one the non-converging ray."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-height, height, (n, 2))
    y[:, 2] = -2.
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    y[0, :2] = u[0, :2] = 0.
    y[-1] = NONCONVERGED[0]
    u[-1, :2] = NONCONVERGED[1]
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    return y, u


def _table(name):
    return TT.table_from_numpy(JT.make_table(**figured_row(
        **FIGURED_ROWS[name])))


def test_nonconverged_ray_is_a_miss_as_the_reference():
    """The conic seed of NONCONVERGED hits the "even" row, the Newton
    does not converge, and both packages call it a miss (NaN)."""
    jt = JT.make_table(**figured_row(**FIGURED_ROWS["even"]))
    y, u = _rays(4, 0)
    args = [np.ascontiguousarray(c) for c in (*y.T, *u.T)]
    c, k = jt.curvature[1], jt.conic[1]
    seed = JK.intercept_conic(*args, c, k, 0.)
    want = JK.intercept(*args, c, k, jt.aspherics[1], 0.,
                        aspherics_odd=jt.aspherics_odd[1])
    got = TK.intercept(*map(_t, args), _t(c), _t(k), _t(jt.aspherics[1]),
                       _t(0.), aspherics_odd=_t(jt.aspherics_odd[1]))
    assert np.isfinite(seed[-1]) and np.isnan(want[-1])
    nptest.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


# -- K5's hand-derived reverse on aspheric rows ------------------------------

@pytest.mark.parametrize("name", sorted(FIGURED_ROWS))
def test_figured_step_vjp_matches_autograd(name):
    """_step_vjp_reference on an aspheric row against autograd of
    kernels.surface_step_spec (the Newton by its implicit Function),
    ray by ray: every row parameter is expanded to one copy a ray, the
    coefficients included.  Ray 0 is on the axis: through an odd figure
    both give NaN there (sqrt(r2) at 0), as the reference does; the last
    ray does not converge on the "even" row, is dead there (NaN forward)
    and never reaches a reverse.  Tolerance: 1e-9 of each slot's largest
    value."""
    tt = _table(name)
    spec = TK.specialize(tt)[1]
    assert TK.is_figured(spec)
    n = 120
    y, u = _rays(n, 11)
    state = [torch.from_numpy(np.ascontiguousarray(c)).requires_grad_()
             for c in (*y.T, *u.T)]
    row = tt.row(1)
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in ("curvature", "conic", "mu")}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    coeffs = {f: getattr(row, f).expand(n, -1).clone().requires_grad_()
              for f in ("aspherics", "aspherics_odd")}
    surf = row._replace(offset=offset, **per_ray, **coeffs)
    out, _ = TK.surface_step_spec(tuple(state), surf, spec, False)
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    odd_axis = spec.odd and live[0]
    live[0] = True            # the on-axis ray: NaN cotangents or not
    assert bool(live[1:-1].any())
    # the non-converging ray (of the "even" row) is dead
    assert name != "even" or not bool(live[-1])
    rng = np.random.RandomState(12)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"], coeffs["aspherics"], coeffs["aspherics_odd"]]
    want = torch.autograd.grad(
        sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g)),
        leaves, allow_unused=True)
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, want)]
    got_state, got_p = CG._step_vjp_reference(
        tuple(s.detach() for s in state), row, spec, g)
    na, no = row.aspherics.shape[-1], row.aspherics_odd.shape[-1]
    assert len(got_p) == CS.SLOTS + na + no
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9])]
    pairs += [(got_p[6 + i], want[10][:, i]) for i in range(na)]
    pairs += [(got_p[6 + na + j], want[11][:, j]) for j in range(no)]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)[live]
        b = b[live]
        if odd_axis and i < 2:   # the entering x and y cotangents
            assert bool(torch.isnan(b[0])) and bool(torch.isnan(a[0])), i
        nptest.assert_array_equal(torch.isnan(a).numpy(),
                                  torch.isnan(b).numpy(), "slot %d" % i)
        ok = torch.isfinite(b)
        scale = float(b[ok].abs().max()) if ok.any() else 0.
        nptest.assert_allclose(a[ok].numpy(), b[ok].numpy(), rtol=RTOL,
                               atol=max(ATOL, RTOL*scale),
                               err_msg="slot %d" % i)


@pytest.mark.parametrize("name", ["doublet", "double_gauss", "odd_singlet"])
def test_adjoint_by_hand_matches_plain_on_aspheric_rows(name):
    """The whole K5 chain in torch on aspheric rows against its autograd
    plain version; the coefficient columns are nonzero only on the
    aspheric rows.  Tolerance: 1e-12 of the largest parameter
    cotangent, 1e-9 relative on the rays."""
    if name == "doublet":
        tt = TT.table_from_numpy(aspheric_doublet(jmodels))
        y, u, w = grad_bundle(jmodels.doublet())
        clip = False
    else:
        tt = _lens(name)[1]
        rng = np.random.RandomState(4)
        n = 256
        h = 12. if name == "double_gauss" else 8.
        y = np.zeros((n, 3))
        y[:, :2] = rng.uniform(-h, h, (n, 2))
        u = np.zeros((n, 3))
        u[:, 2] = 1.
        w = rng.uniform(.5, 1.5, n)
        clip = True
    specs = TK.specialize(tt)
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    state = tuple(_t(c) for c in (*y.T, *u.T))
    wt = _t(w)
    ct = torch.tensor([.3, -1.2, .7, 2., -.4], dtype=F64)
    ref = CG.merit_adjoint_reference(tt, specs, state, wt, ct, clip)
    got = CG._merit_adjoint_by_hand(tt, specs, state, wt, ct, clip)
    na = tt.aspherics.shape[-1]
    assert ref[0].shape == (tt.nsurfaces, CS.SLOTS + na
                            + tt.aspherics_odd.shape[-1])
    coeff = ref[0][:, CS.SLOTS:]
    assert bool((coeff[fig] != 0).any())
    others = [j for j in range(tt.nsurfaces) if j not in fig]
    assert bool((coeff[others] == 0).all())
    scale = float(ref[0].abs().max())
    nptest.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0,
                           atol=1e-12*scale)
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_adjoint_spot_rms_matches_jax_grad():
    """adjoint_spot_rms (K4 and K5, their plain versions on the CPU)
    w.r.t. curvature, conic and both coefficient fields against jax.grad
    of the reference's specialized spot_rms: 1e-9 relative of each
    field's largest entry."""
    jt = aspheric_doublet(jmodels)
    specs = JK.specialize(jt)
    y, u, w = grad_bundle(jmodels.doublet(), seed=3)
    sel = ("curvature", "conic", "aspherics", "aspherics_odd")
    p0 = {k: jnp.asarray(getattr(jt, k)) for k in sel}
    jv, jg = jax.value_and_grad(lambda p: JGR.spot_rms(
        jt.replace(**p), y, u, w, specs=specs, unroll=True))(p0)
    tt = TT.table_from_numpy(jt)
    params = {k: getattr(tt, k).clone().requires_grad_() for k in sel}
    with pytest.warns(UserWarning, match="aspherics"):
        tv = CG.adjoint_spot_rms(tt.replace(**params), _t(y), _t(u), _t(w),
                                 specs=TK.specs_from_tuple(specs))
    tv.backward()
    nptest.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
    for k in sel:
        want = np.asarray(jg[k])
        nptest.assert_allclose(params[k].grad.numpy(), want, rtol=RTOL,
                               atol=RTOL*np.abs(want).max(), err_msg=k)


def test_optimize_grad_adjoint_over_aspherics_matches_jax():
    """optimize_grad(engine="adjoint", select=("curvature",
    "aspherics")) with per-column scales on the CPU against the JAX
    package's optimize_grad on the same bundles, its merit the
    specialized spot_rms (the gradient the reference's adjoint engine
    reproduces, tests/test_pallas_grad.py): histories and tables within
    1e-9 relative."""
    js = jmodels.doublet()
    jb = JGR.bundles_from_system(js, fields=(0., 1.),
                                 wavelengths=js.wavelengths[:2], nrays=16,
                                 pad_to=128)
    jt = aspheric_doublet(jmodels, odd=False)
    specs = JK.specialize(jt)
    sel = ("curvature", "aspherics")
    scales = {"aspherics": [1e-5, 1e-7]}

    def merit(tab):
        total = 0.
        for y, u, w, chroma in jb:
            t2 = tab.replace(**{k: v for k, v in chroma.items()
                                if k != "wavelength"})
            total = total + JGR.spot_rms(t2, y, u, w, specs=specs,
                                         unroll=True)
        return total
    jt2, jh = JGR.optimize_grad(jt, jb, select=sel, steps=4, lr=1e-3,
                                merit=merit, scales=scales)
    tt2, th = TGR.optimize_grad(TT.table_from_numpy(jt),
                                TGR.bundles_from_numpy(jb), select=sel,
                                steps=4, lr=1e-3, engine="adjoint",
                                scales=scales)
    assert th[-1] < th[0]
    nptest.assert_allclose(th, jh, rtol=1e-9)
    for k in sel:
        want = np.asarray(getattr(jt2, k))
        nptest.assert_allclose(getattr(tt2, k).numpy(), want, rtol=1e-9,
                               atol=1e-9*np.abs(want).max(), err_msg=k)
    assert float(tt2.aspherics[1, 0]) != float(jt.aspherics[1, 0])


# -- the keys ------------------------------------------------------------------

def _figured_specs(name):
    tt = _lens(name)[1]
    return tt, TK.specialize(tt)


@pytest.mark.parametrize("name", ["double_gauss", "odd_singlet"])
def test_figured_keys_encode_flags_widths_and_slots(name):
    """K1, K2, K4 and K5 keys of an aspheric spec tuple: the rows'
    F_ASPHERIC/F_ODD bits, the table's widths as (na, no), the packed
    row's words, the live coefficient slots on the aspheric rows only
    (curvature and conic live there even where the row's spherical
    flag is set), and the translation unit that defines the widths
    before the header."""
    tt, specs = _figured_specs(name)
    widths = CT.figure_widths(tt, specs)
    assert widths == (tt.aspherics.shape[-1], tt.aspherics_odd.shape[-1])
    # the packed rows: the base words, then the even, then the odd
    # coefficients
    packed, flags = CT.pack_table(tt, specs, F64, "cpu")
    na = widths[0]
    assert packed.shape == (tt.nsurfaces, CT.ROW + sum(widths))
    assert torch.equal(packed[:, :CT.ROW],
                       CT.pack_values(tt, F64, "cpu")[:, :CT.ROW])
    assert torch.equal(packed[:, CT.P_ASP:CT.P_ASP + na], tt.aspherics)
    assert torch.equal(packed[:, CT.P_ASP + na:], tt.aspherics_odd)
    assert flags.tolist() == [CT._flags(s) for s in specs]
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    for make in (CS.trace_key, CS.merit_key, CS.moments_key):
        key = make(specs, F64, widths=widths)
        assert (key.na, key.no) == widths
        assert key.row_words == CT.ROW + sum(widths)
        for j, (s, word) in enumerate(zip(specs, key.words)):
            assert bool(word & CT.F_ASPHERIC) == s.aspheric
            assert bool(word & CT.F_ODD) == s.odd
            assert word == CT._flags(s)
        unit = CS.translation_unit(key)
        assert ("#define RAYOPT_N_ASP %d\n#define RAYOPT_N_ODD %d\n"
                "#include \"grad_spec.cuh\"" % widths) in unit
        assert "Chain<%s>" % ", ".join(map(str, key.words)) in unit
        # the widths are part of the key; an aspheric row needs them
        assert make(specs, F64, widths=(widths[0] + 1, widths[1] + 1)).name \
            != key.name
        with pytest.raises(ValueError, match="widths"):
            make(specs, F64)
        assert key.shared_bytes >= key.rows*key.row_words*8
    key = CS.adjoint_key(specs, F64, fields=CS.FIELDS, widths=widths)
    assert key.slots == CS.SLOTS + sum(widths)
    live = CS.live_mask(CS.live_slots(specs, CS.FIELDS, widths),
                        key.slots).numpy()
    for j, s in enumerate(specs):
        row_live = live[j, CS.SLOTS:]
        assert row_live.all() == (j in fig) and row_live.any() == (j in fig)
        if j in fig:
            assert live[j, 0] and live[j, 1]    # c and k, read by the sag
    assert key.words == tuple(
        CT._flags(s) | m << CS.LIVE_SHIFT
        for s, m in zip(specs, CS.live_slots(specs, CS.FIELDS, widths)))
    # only the aspheric coefficients asked for
    k2 = CS.adjoint_key(specs, F64, fields=("curvature", "aspherics"),
                        widths=widths)
    m2 = CS.live_mask(CS.live_slots(specs, ("curvature", "aspherics"),
                                    widths), key.slots).numpy()
    assert k2.nlive == int(m2.sum())
    assert m2[:, CS.SLOTS:CS.SLOTS + widths[0]].any() == bool(widths[0])
    assert not m2[:, CS.SLOTS + widths[0]:].any()


def test_unfigured_keys_ignore_the_table_widths():
    """A spec tuple with no aspheric row keys as before whatever the
    table's widths: no defines in its unit, SLOTS slots a row."""
    tt = _lens("double_gauss")[1]
    specs = TK.specialize(TT.table_from_numpy(jmodels.double_gauss().table()))
    assert CT.figure_widths(tt, specs) == (0, 0)
    key = CS.trace_key(specs, F32, widths=(3, 0))
    assert key == CS.trace_key(specs, F32) and (key.na, key.no) == (0, 0)
    assert "RAYOPT_N_ASP" not in CS.translation_unit(key)
    assert CS.adjoint_key(specs, F64, widths=(3, 0)).slots == CS.SLOTS
    with pytest.raises(ValueError, match="row word"):
        CS.trace_key(_figured_specs("double_gauss")[1], F64,
                     widths=(CS.LIVE_BITS, 0))


def test_all_spec_kernels_take_aspheric_rows():
    """Every K1-K9 key takes the odd singlet's aspheric rows, carrying
    the table's widths (K3 both modes, K6, K7, K8 and K9 too), and so do
    their wrappers (the plain versions here: finite values where the
    plain trace is finite); the df32 plan traces them as the JAX
    package's eager df32 does, word for word."""
    tt, specs = _figured_specs("odd_singlet")
    widths = CT.figure_widths(tt, specs)
    keys = [CS.trace_key(specs, F32, widths=widths),
            CS.merit_key(specs, F32, widths=widths),
            CS.moments_key(specs, F64, widths=widths),
            CS.adjoint_key(specs, F64, widths=widths),
            CS.trace_multi_key(specs, F64, 3, widths=widths),
            CS.trace_multi_key(specs, F64, 3, merit=True, widths=widths),
            CS.moments_multi_key(specs, F64, False, 3, widths=widths),
            CS.adjoint_multi_key(specs, F64, widths=widths),
            CS.opd_key(specs, F64, widths=widths),
            CS.opd_adjoint_key(specs, F64, widths=widths)]
    # every kernel of csrc/grad_spec.cuh (the df32 keys: k11, k13)
    assert sorted(k.kernel for k in keys) == sorted(
        k for k in CS._MACROS if k not in ("k11", "k13"))
    for key in keys:
        assert (key.na, key.no) == widths and key.row_words == \
            CT.ROW + sum(widths)
        assert "#define RAYOPT_N_ASP %d\n#define RAYOPT_N_ODD %d\n" % widths \
            in CS.translation_unit(key)
    y, u = np.zeros((8, 3)), np.zeros((8, 3))
    y[:, 0] = .3
    y[:, 1] = np.linspace(-5, 5, 8)
    u[:, 2] = 1.
    assert df32_matches_jax(tt, y, u)
    state = tuple(_t(c) for c in (*y.T, *u.T))
    w = torch.full((8,), 1/8, dtype=F64)
    tabs = TT.stack_tables([tt, tt])
    aux = torch.tensor([0., 0., 0., -50., 1e-3], dtype=F64)
    cts = tuple(torch.ones(8, dtype=F64) for _ in range(3))
    out, _ = CT.trace_final(tt, specs, state)
    assert torch.isfinite(out[0]).all()
    assert float(CT.trace_merit(tt, specs, state)[0]) == 8.
    for (o, t), (o1, t1) in zip(CT.trace_multi(tabs, specs, state),
                                [CT.trace_final(tt, specs, state)]*2):
        assert all(torch.equal(a, b) for a, b in zip((*o, t), (*o1, t1)))
    assert [float(m[0]) for m in CT.trace_multi(tabs, specs, state,
                                                merit=True)] == [8., 8.]
    mom = CG.weighted_moments_multi(tabs, specs, state, w)
    assert mom.shape == (2, 5) and torch.isfinite(mom).all()
    na, no = widths
    pg, st, gw = CG.merit_adjoint_multi(tabs, specs, state, w,
                                        torch.ones(2, 5, dtype=F64))
    assert pg.shape == (2, tt.nsurfaces, CS.SLOTS + na + no)
    assert bool((pg[:, 1, CS.SLOTS:] != 0).any())
    k, lx, ly = CG.opd_chain(tt, specs, state, aux)
    assert torch.isfinite(k).all()
    pg, st, gc = CG.opd_adjoint(tt, specs, state, aux, cts)
    assert pg.shape == (tt.nsurfaces, CS.OPD_SLOTS + na + no)
    assert bool((pg[1, CS.OPD_SLOTS:] != 0).any()) and bool(pg[1, 6] != 0)
    assert torch.isfinite(TGL.polychromatic_spot_rms(
        tabs, _t(y), _t(u), engine="adjoint"))


EXTENDED = {"biconic": dict(curvature_dx=[0., 1e-3]),
            "toroid": dict(toroidal=[0., 1.]),
            "cylinder": dict(curvature=[0., 0.], curvature_dx=[0., .02]),
            "grating": dict(grating_dy=[0., 1e-3]),
            "doe": dict(doe=[[0.], [1e-4]]),
            "freeform": dict(xy_poly=[[0.]*5, [0., 0., 1e-3, 0., 0.]])}


ANAMORPHIC = ("biconic", "cylinder", "toroid")


@pytest.mark.parametrize("name", sorted(EXTENDED))
def test_extended_rows_still_raise_everywhere(name):
    """Freeform rows are traced by the specialized and the generic plain
    step and the plain engines and taken by every K1-K9 key, each
    carrying the table's XY width (tests/test_torch_freeform.py,
    tests/test_torch_spec_freeform.py, tests/test_torch_spec_freeform_
    paths.py), and the df32 plan traces them as the JAX package's eager
    df32 does, word for word with the optical path
    (tests/test_torch_df32_freeform.py).  Biconic, toroid and cylinder
    rows are traced now
    (tests/test_torch_anamorphic.py): every K1-K9 key takes them, and the
    df32 plan traces them as the JAX package's eager df32 does, word for
    word.  Grating and DOE rows are traced by the plain path and by
    every K1-K9 key (tests/test_torch_grating.py,
    tests/test_torch_spec_grating.py, tests/test_torch_spec_grating_
    paths.py), and the df32 plan traces them as the JAX package's eager
    df32 does, word for word with the optical path
    (tests/test_torch_df32_phase.py)."""
    kw = dict(curvature=[0., 1/40.], mu=[1., 1/1.5])
    kw.update(EXTENDED[name])
    tt = TT.table_from_numpy(JT.make_table(**kw))
    specs = TK.specialize(tt)
    assert TK.specs_from_tuple(JK.specialize(JT.make_table(**kw))) == specs
    state = tuple(_t(c) for c in np.zeros((6, 4)) + np.array([[0.]]*5 + [[1.]]))
    keys = (CS.trace_key, CS.merit_key, CS.moments_key, CS.adjoint_key,
            CS.adjoint_multi_key,
            lambda sp, dt: CS.trace_multi_key(sp, dt, 2),
            lambda sp, dt: CS.trace_multi_key(sp, dt, 2, merit=True),
            lambda sp, dt: CS.moments_multi_key(sp, dt, False, 2))
    # the OPD keys on the row and an image row behind it
    kw3 = {k: v + [v[-1]] for k, v in kw.items()}
    specs3 = TK.specialize(TT.table_from_numpy(JT.make_table(**kw3)))
    opd_keys = (CS.opd_key, CS.opd_adjoint_key)
    if name in ANAMORPHIC:
        for make in keys:
            assert make(specs, F64).anamorphic
        for make in opd_keys:
            assert make(specs3, F64).anamorphic
    elif name in ("grating", "doe"):
        nd = CT.doe_width(tt, specs)
        for make in keys[:5]:
            key = make(specs, F64, nd=nd)
            assert (key.grating, key.nd) == (name == "grating", nd)
        for key in (CS.trace_multi_key(specs, F64, 2, nd=nd),
                    CS.trace_multi_key(specs, F64, 2, merit=True, nd=nd),
                    CS.moments_multi_key(specs, F64, False, 2, nd=nd),
                    *(make(specs3, F64, nd=nd) for make in opd_keys)):
            assert (key.grating, key.nd) == (name == "grating", nd)
    else:
        nxy = CT.xy_width(tt, specs)
        for key in (*(make(specs, F64, nxy=nxy) for make in keys[:5]),
                    CS.trace_multi_key(specs, F64, 2, nxy=nxy),
                    CS.trace_multi_key(specs, F64, 2, merit=True, nxy=nxy),
                    CS.moments_multi_key(specs, F64, False, 2, nxy=nxy),
                    *(make(specs3, F64, nxy=nxy) for make in opd_keys)):
            assert key.nxy == nxy
    if name in ANAMORPHIC:
        out, _ = TK.surface_step_spec(state, tt.row(1), specs[1], False)
        assert all(torch.isfinite(c).all() for c in out)
        assert torch.isfinite(CT.trace_final(tt, specs, state)[0][0]).all()
        y, u = np.zeros((8, 3)), np.zeros((8, 3))
        y[:, 0] = np.linspace(-4, 4, 8)
        y[:, 1] = np.linspace(3, -3, 8)
        u[:, 2] = 1.
        assert df32_matches_jax(tt, y, u)
        return
    if name in ("grating", "doe"):
        out, _ = TK.surface_step_spec(state, tt.row(1), specs[1], False)
        assert all(torch.isfinite(c).all() for c in out)
        assert torch.isfinite(CT.trace_final(tt, specs, state)[0][0]).all()
        y, u = np.zeros((8, 3)), np.zeros((8, 3))
        y[:, 0] = np.linspace(-4, 4, 8)
        y[:, 1] = np.linspace(3, -3, 8)
        u[:, 2] = 1.
        steps = TD.plan(tt)
        assert (steps[0]["grat"] is None) == (name == "doe")
        assert (steps[0]["doe"] is None) == (name == "grating")
        assert df32_matches_jax(tt, y, u)
        return
    out, _ = TK.surface_step_spec(state, tt.row(1), specs[1], False)
    assert all(torch.isfinite(c).all() for c in out)
    y = TG.trace_rays_final(tt, torch.zeros(4, 3, dtype=F64),
                            torch.ones(4, 3, dtype=F64)/np.sqrt(3.),
                            biconic=True)[0]
    assert torch.isfinite(y).all()
    assert torch.isfinite(CT.trace_final(tt, specs, state)[0][0]).all()
    assert TD.plan(tt)[0]["anam"]["mode"] == "freeform"
    y, u = np.zeros((8, 3)), np.zeros((8, 3))
    y[:, 0] = np.linspace(-4, 4, 8)
    y[:, 1] = np.linspace(3, -3, 8)
    u[:, 2] = 1.
    assert df32_matches_jax(tt, y, u)
