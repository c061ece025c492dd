"""rayopt_tpu_torch's differentiable merit and optimizer against the
JAX package, in float64 on the CPU: ops.paraxial, parallel.grad
(spot_rms, first-order penalties, bundles, optimize_grad,
optimize_system), the plain versions of the K4/K5 kernels behind
ops.cuda_grad against the Pallas adjoint they replace (interpret
mode), and the hand-derived reverse that K5 runs, against torch
autograd.  Tolerances: rtol 1e-9, atol 1e-12 unless a line says why
not.  The kernels themselves run only on a CUDA card
(tests/test_torch_cuda.py)."""

import functools
import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import paraxial as JP
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.pallas_grad import pallas_spot_rms
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import paraxial as TP
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_trace import BRANCHES

RTOL, ATOL = 1e-9, 1e-12
SELECT = ("curvature", "conic", "offset", "mu")


@pytest.fixture(autouse=True)
def _one_thread():
    # several test workers import both frameworks at once
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default():
    # the port's entry points default to the card: these tests ask for
    # the CPU, where every wrapper runs its plain version
    old = set_default_device("cpu")
    yield
    set_default_device(old)


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    nptest.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                           err_msg=err_msg)


def _bundle(s, n=256, seed=0, dead_frac=0.):
    """The reference's adjoint-test bundle (tests/test_pallas_grad.py):
    with dead_frac a leading block is pushed far off the aperture."""
    rng = np.random.RandomState(seed)
    r = s.object.pupil.radius
    sl = s.object.pupil.slope
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*.8*r
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*.3*sl
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    k = int(n*dead_frac)
    if k:
        y[:k, 1] += 50*r
    w = rng.uniform(.5, 1.5, n)
    w /= w.sum()
    return y, u, w


def _leaves(tt, select):
    return {k: getattr(tt, k).clone().requires_grad_() for k in select}


def _grad(leaf):
    # a field the specialized step never reads gets None (JAX: zeros)
    return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad


def _unit(tab):
    off = np.asarray(tab.offset)
    d = np.asarray(tab.distance)
    return np.divide(off, d[:, None], where=d[:, None] != 0,
                     out=np.tile([0., 0., 1.], (off.shape[0], 1)))


# -- ops.paraxial ---------------------------------------------------------

@pytest.mark.parametrize("name", ["doublet", "cooke_triplet", "double_gauss"])
def test_first_order_matches_jax(name):
    s = getattr(jmodels, name)()
    tab = s.table()
    seed = JGR.paraxial_seed(s)
    want = JP.first_order(tab, jnp.asarray(seed[0]), jnp.asarray(seed[1]))
    got = TP.first_order(TT.table_from_numpy(tab), *seed)
    for k in want:
        _close(got[k], want[k], k)
    _close(TP.paraxial_solve_image(TT.table_from_numpy(tab), *seed),
           JP.paraxial_solve_image(tab, jnp.asarray(seed[0]),
                                   jnp.asarray(seed[1])))
    _close(TP.abcd_product(TT.table_from_numpy(tab)), JP.abcd_product(tab))


# -- parallel.grad.spot_rms ----------------------------------------------

SPOT_CASES = [(spec, clip) for spec in (False, True) for clip in (False, True)]


@pytest.mark.parametrize("specialized,clip", SPOT_CASES)
def test_spot_rms_value_and_grads_match_jax(specialized, clip):
    s = jmodels.doublet()
    tab = s.table()
    specs = jspecialize(tab) if specialized else None
    tspecs = specs and TK.specs_from_tuple(specs)
    y, u, w = _bundle(s, dead_frac=.5 if clip else 0.)
    tt = TT.table_from_numpy(tab)
    yt, ut, wt = (torch.from_numpy(a) for a in (y, u, w))

    def jloss(p):
        return JGR.spot_rms(tab.replace(**p), y, u, w, clip=clip,
                            specs=specs, unroll=specialized)
    p0 = {k: jnp.asarray(getattr(tab, k)) for k in SELECT}
    v1, g1 = jax.value_and_grad(jloss)(p0)
    tp = _leaves(tt, SELECT)
    v2 = TGR.spot_rms(tt.replace(**tp), yt, ut, wt, clip=clip,
                      specs=tspecs)
    v2.backward()
    _close(v2, v1)
    for k in SELECT:
        assert np.isfinite(_grad(tp[k]).numpy()).all(), k
        _close(_grad(tp[k]), g1[k], k)
    # distance, through the offset = unit * distance tie
    unit = _unit(tab)

    def jdist(d):
        return JGR.spot_rms(tab.replace(distance=d, offset=unit*d[:, None]),
                            y, u, w, clip=clip, specs=specs,
                            unroll=specialized)
    gd1 = jax.grad(jdist)(jnp.asarray(tab.distance))
    d = tt.distance.clone().requires_grad_()
    TGR.spot_rms(tt.replace(distance=d,
                            offset=torch.from_numpy(unit)*d[:, None]),
                 yt, ut, wt, clip=clip, specs=tspecs).backward()
    _close(d.grad, gd1, "distance")


def test_pose_grad_at_nominal_matches_jax():
    """A zero tilt/decenter that requires grad is folded by lower_pose,
    so the generic engine differentiates the nominal pose exactly."""
    s = jmodels.cooke_triplet()
    tab = s.table()
    y, u, w = _bundle(s, n=128, seed=3)
    nsurf = tab.curvature.shape[0]
    z3 = jnp.zeros((nsurf, 3))
    g1 = jax.grad(lambda t, d: JGR.spot_rms(
        tab.replace(tilt=t, decenter=d), y, u, w), argnums=(0, 1))(z3, z3)
    tt = TT.table_from_numpy(tab)
    tilt = torch.zeros(nsurf, 3, dtype=torch.float64, requires_grad=True)
    dec = torch.zeros(nsurf, 3, dtype=torch.float64, requires_grad=True)
    TGR.spot_rms(tt.replace(tilt=tilt, decenter=dec), *(
        torch.from_numpy(a) for a in (y, u, w))).backward()
    assert tilt.grad is not None and dec.grad is not None
    assert float(tilt.grad.abs().max()) > 0 and float(dec.grad.abs().max()) > 0
    _close(tilt.grad, g1[0], "tilt")
    _close(dec.grad, g1[1], "decenter")
    # a concrete all-zero pose that needs no grad is left as it is
    assert TT.lower_pose(tt) is tt


# -- the adjoint merit (plain K4/K5 on the CPU) vs the Pallas adjoint -----

@pytest.mark.parametrize("clip,dead", [(False, 0.), (True, .5)])
def test_adjoint_matches_pallas(clip, dead):
    s = jmodels.doublet()
    tab = s.table()
    specs = jspecialize(tab)
    y, u, w = _bundle(s, dead_frac=dead)
    sel = SELECT + ("n_before",)
    p0 = {k: jnp.asarray(getattr(tab, k)) for k in sel}
    v1, g1 = jax.value_and_grad(lambda p: pallas_spot_rms(
        tab.replace(**p), y, u, w, specs=specs, clip=clip, tile=128,
        interpret=True))(p0)
    tt = TT.table_from_numpy(tab)
    tp = _leaves(tt, sel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # conic/offset rows bake out
        v2 = CG.adjoint_spot_rms(tt.replace(**tp), *(
            torch.from_numpy(a) for a in (y, u, w)),
            specs=TK.specs_from_tuple(specs), clip=clip)
    v2.backward()
    assert np.isfinite(float(v2))
    # the value is E[x^2] - c^2 of moments summed in another order:
    # that cancellation leaves ~1e-11 relative
    _close(v2, v1)
    for k in sel:
        assert np.isfinite(tp[k].grad.numpy()).all(), k
        _close(tp[k].grad, g1[k], k)
    assert not tp["n_before"].grad.any()


def test_adjoint_ray_and_weight_grads_match_pallas():
    s = jmodels.doublet()
    tab = s.table()
    specs = jspecialize(tab)
    y, u, w = _bundle(s, n=128)
    g1 = jax.grad(lambda y, u, w: pallas_spot_rms(
        tab, y, u, w, specs=specs, tile=128, interpret=True),
        argnums=(0, 1, 2))(jnp.asarray(y), jnp.asarray(u), jnp.asarray(w))
    tspecs = TK.specs_from_tuple(specs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (y, u, w)]
    CG.adjoint_spot_rms(TT.table_from_numpy(tab), *leaves,
                        specs=tspecs).backward()
    xla = [torch.from_numpy(a).requires_grad_() for a in (y, u, w)]
    TGR.spot_rms(TT.table_from_numpy(tab), *xla, specs=tspecs).backward()
    for a, b, c, name in zip(leaves, g1, xla, "yuw"):
        # against the port's own autograd engine (the same trace): 1e-9
        _close(a.grad, c.grad, name)
        # against JAX: the image sits at focus, where x = x' + t ux
        # cancels ~5 digits, so the two packages' traces (whose
        # operations round differently) agree to ~3e-10 relative there;
        # a ray's cotangent is proportional to its distance from the
        # spot centroid, so it is held to 1e-9 of its kind's largest
        _close(a.grad, b, name, atol=1e-9*float(np.abs(b).max()))


def test_adjoint_baked_out_warns_and_is_zero():
    s = tmodels.doublet()
    tt = s.table()
    specs = TK.specialize(tt)
    y, u, w = (torch.from_numpy(a) for a in _bundle(s, n=128))
    conic = tt.conic.clone().requires_grad_()
    with pytest.warns(UserWarning, match="'conic' of surface row"):
        CG.adjoint_spot_rms(tt.replace(conic=conic), y, u, w,
                            specs=specs).backward()
    rows = CG._baked_out_rows(specs, "conic")
    assert rows and not conic.grad[rows].any()
    # a wholesale differentiation context does not warn
    every = {f: getattr(tt, f).clone().requires_grad_()
             for f in CG._FIELDS if f not in CG._NONDIFF
             and getattr(tt, f).numel()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        CG.spot_moments(tt.replace(**every), tuple(
            c.contiguous() for c in (*y.T, *u.T)), w, specs=specs)


def test_wrappers_take_plain_versions_on_cpu():
    s = tmodels.doublet()
    tt = s.table()
    specs = TK.specialize(tt)
    y, u, w = (torch.from_numpy(a) for a in _bundle(s, n=128))
    state = tuple(c.contiguous() for c in (*y.T, *u.T))
    ct = torch.tensor([.1, -.2, .3, .4, -.5], dtype=torch.float64)
    before = CG.weighted_moments.launches, CG.merit_adjoint.launches
    got = CG.weighted_moments(tt, specs, state, w)
    _close(got, CG.weighted_moments_reference(tt, specs, state, w))
    for a, b in zip(CG.merit_adjoint(tt, specs, state, w, ct),
                    CG.merit_adjoint_reference(tt, specs, state, w, ct)):
        for g, r in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            _close(g, r)
    assert (CG.weighted_moments.launches,
            CG.merit_adjoint.launches) == before
    with pytest.raises(ValueError, match="w must"):
        CG.weighted_moments(tt, specs, state, w.float())
    with pytest.raises(ValueError, match="ct must"):
        CG.merit_adjoint(tt, specs, state, w, ct[:4])


# -- K5's hand-derived reverse against torch autograd ---------------------

@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_step_vjp_matches_autograd(name):
    """_step_vjp_reference (the model of csrc/grad.cu surface_step_vjp)
    against autograd of kernels.surface_step_spec, ray by ray: every
    row parameter is expanded to one copy a ray, so autograd returns
    per-ray parameter cotangents too."""
    tt = TT.make_table(**BRANCHES[name])
    spec = TK.specialize(tt)[1]
    rng = np.random.RandomState(11)
    n = 200
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-8, 8, (n, 2))
    y[:, 2] = -1.
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.2, .2, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    state = [torch.from_numpy(np.ascontiguousarray(c)).requires_grad_()
             for c in (*y.T, *u.T)]
    row = tt.row(1)
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in ("curvature", "conic", "mu")}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    surf = row._replace(offset=offset, **per_ray)
    out, _ = TK.surface_step_spec(tuple(state), surf, spec, False)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert live.any()
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"]]
    want = torch.autograd.grad(
        sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g)),
        leaves, allow_unused=True)
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, want)]
    got_state, got_p = CG._step_vjp_reference(
        tuple(s.detach() for s in state), row, spec, g)
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9])]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)
        # the conic intercept -(d + q)/e cancels ~3 digits where e is
        # small (a paraboloid near the axis), and the two reverses round
        # it differently: so 1e-9 of the slot's largest value as well
        _close(a[live], b[live], "slot %d" % i,
               atol=max(ATOL, 1e-9*float(b[live].abs().max())))


def _posed_cooke():
    """The Cooke with a tilted row, a decentered row and a conic row:
    every branch of the K5 chain (rotated, off-axis, conic) at once."""
    tab = jmodels.cooke_triplet().table()
    nsurf = tab.curvature.shape[0]
    tilt = np.zeros((nsurf, 3))
    tilt[3] = (.01, -.02, 0.)
    dec = np.zeros((nsurf, 3))
    dec[5] = (.05, -.03, 0.)
    conic = np.asarray(tab.conic).copy()
    conic[2] = -.6
    return TT.lower_pose(TT.table_from_numpy(tab.replace(
        tilt=tilt, decenter=dec, conic=conic)))


@pytest.mark.parametrize("case", ["posed_cooke", "doublet_clipped"])
def test_adjoint_by_hand_matches_plain(case):
    """The whole K5 chain in torch (seeding, final rotation, reverse
    sweep, row-0 rotation) against the autograd plain version."""
    if case == "posed_cooke":
        tt, clip = _posed_cooke(), False
        y, u, w = _bundle(jmodels.cooke_triplet(), n=128, seed=2)
    else:
        tt, clip = tmodels.doublet().table(), True
        y, u, w = _bundle(jmodels.doublet(), n=128, dead_frac=.5)
    specs = TK.specialize(tt)
    if case == "posed_cooke":
        assert any(s.rotated for s in specs) and any(s.off_axis for s in specs)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c))
                  for c in (*y.T, *u.T))
    wt = torch.from_numpy(w)
    ct = torch.tensor([.3, -1.2, .7, 2., -.4], dtype=torch.float64)
    ref = CG.merit_adjoint_reference(tt, specs, state, wt, ct, clip)
    got = CG._merit_adjoint_by_hand(tt, specs, state, wt, ct, clip)
    scale = float(ref[0].abs().max())
    _close(got[0], ref[0], "params", atol=1e-12*scale)
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        _close(a, b)


# -- first-order penalties and the optimizer ------------------------------

def test_first_order_penalty_grads_match_jax():
    js, ts = jmodels.cooke_triplet(), tmodels.cooke_triplet()
    jb = JGR.bundles_from_system(js, fields=(0., 1.), nrays=16)
    tb = TGR.bundles_from_numpy(jb)
    seed = JGR.paraxial_seed(js)
    efl = float(js.paraxial.focal_length[1])
    targets = {"focal_length": (1, efl + .5), "lagrange": .3}
    weights = {"focal_length": 10.}
    jm = JGR.composite_merit(
        functools.partial(JGR.trace_rms_merit, bundles=jb),
        functools.partial(JGR.first_order_penalty, seed=seed,
                          targets=targets, weights=weights))
    tm = TGR.composite_merit(
        functools.partial(TGR.trace_rms_merit, bundles=tb),
        functools.partial(TGR.first_order_penalty,
                          seed=TGR.paraxial_seed(ts), targets=targets,
                          weights=weights))
    tab = js.table()
    v1, g1 = jax.value_and_grad(lambda c: jm(tab.replace(curvature=c)))(
        jnp.asarray(tab.curvature))
    tt = ts.table()
    c = tt.curvature.clone().requires_grad_()
    v2 = tm(tt.replace(curvature=c))
    v2.backward()
    _close(v2, v1)
    _close(c.grad, g1)


def _opt_bundles():
    js = jmodels.doublet()
    jb = JGR.bundles_from_system(js, fields=(0., 1.),
                                 wavelengths=js.wavelengths[:2], nrays=16,
                                 pad_to=128)
    return js, jb, TGR.bundles_from_numpy(jb)


OPT_CASES = [(e, o) for e in ("xla", "adjoint") for o in ("sgd", "adam")]


@pytest.mark.parametrize("engine,opt", OPT_CASES)
def test_optimize_grad_history_matches_jax(engine, opt):
    js, jb, tb = _opt_bundles()
    sel = ("curvature", "distance")
    if opt == "sgd":
        jopt, topt = optax.sgd(1e-6), functools.partial(torch.optim.SGD,
                                                        lr=1e-6)
    else:
        jopt, topt = optax.adam(1e-5), None
    kw = dict(interpret=True) if engine == "adjoint" else {}
    jt, jh = JGR.optimize_grad(js.table(), jb, select=sel, steps=4,
                               lr=1e-5, optimizer=jopt, engine=engine, **kw)
    tt, th = TGR.optimize_grad(TT.table_from_numpy(js.table()), tb,
                               select=sel, steps=4, lr=1e-5,
                               optimizer=topt, engine=engine)
    assert th[-1] < th[0]
    _close(th, jh)
    for k in sel + ("offset",):
        _close(getattr(tt, k), getattr(jt, k), k)


def test_optimize_system_writes_back_as_jax():
    js, ts = jmodels.doublet(), tmodels.doublet()
    kw = dict(fields=(0., 1.), wavelengths=js.wavelengths[:1], nrays=16,
              steps=3)
    jh = JGR.optimize_system(js, select=("curvature",), **kw)
    th = TGR.optimize_system(ts, select=("curvature",), **kw)
    _close(th, jh)
    for je, te in zip(js, ts):
        _close(getattr(te, "curvature", 0.), getattr(je, "curvature", 0.))


def test_write_back_pose_matches_jax():
    js, ts = jmodels.cooke_triplet(), tmodels.cooke_triplet()
    jt = js.table()
    nsurf = jt.curvature.shape[0]
    tilt = np.zeros((nsurf, 3))
    tilt[2] = (.002, -.001, 0.)
    dec = np.zeros((nsurf, 3))
    dec[4] = (.03, 0., 0.)
    JGR.write_back_table(js, jt.replace(tilt=tilt, decenter=dec),
                         ("tilt", "decenter"))
    TGR.write_back_table(ts, TT.table_from_numpy(jt).replace(
        tilt=torch.from_numpy(tilt), decenter=torch.from_numpy(dec)),
        ("tilt", "decenter"))
    want, got = js.table(), ts.table()
    for f in ("rot", "offset", "distance"):
        _close(getattr(got, f), getattr(want, f), f)


def test_bundles_from_system_matches_jax():
    js, ts = jmodels.doublet(), tmodels.doublet()
    jb = JGR.bundles_from_system(js, nrays=16, pad_to=128)
    tb = TGR.bundles_from_system(ts, nrays=16, pad_to=128)
    assert len(tb) == len(jb) == len(js.fields)*len(js.wavelengths)
    for a, b in zip(tb, jb):
        assert a[0].shape[0] == 128
        for g, w in zip(a[:3], b[:3]):
            _close(g, w, atol=1e-10, rtol=1e-10)
        for k in ("mu", "n_before", "n_after"):
            _close(a[3][k], b[3][k], k)
        assert a[3]["wavelength"] == b[3]["wavelength"]
    # a pad ray has zero weight and does not move the merit
    tt = ts.table()
    y0, u0, w, chroma = tb[0]
    n = int((w > 0).sum())
    t2 = tt.replace(**{k: v for k, v in chroma.items() if k != "wavelength"})
    _close(TGR.spot_rms(t2, y0, u0, w), TGR.spot_rms(t2, y0[:n], u0[:n],
                                                      w[:n]))
    moved = TGR.bundles_to(tb[:1], dtype=torch.float32)[0]
    assert moved[0].dtype == torch.float32 and moved[3] is chroma


def test_unported_options_raise():
    ts = tmodels.doublet()
    tt = ts.table()
    tb = TGR.bundles_from_system(ts, fields=(0.,), nrays=8)
    for kw, item in ((dict(mesh=object()), "16"),
                     (dict(checkpoint_dir="ckpt"), "6"),
                     (dict(jit_steps=4), "6"),
                     (dict(engine="adjoint", select=("tilt",)), "9"),
                     (dict(engine="adjoint", select=("decenter",)), "9")):
        with pytest.raises(NotImplementedError, match="item " + item):
            TGR.optimize_grad(tt, tb, steps=1, **kw)
    with pytest.raises(ValueError, match="engine"):
        TGR.optimize_grad(tt, tb, steps=1, engine="pallas")
    with pytest.raises(NotImplementedError, match="item 16"):
        TGR.trace_rms_merit(tt, tb, mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        TGR.bundles_from_system(ts, nrays=8, device_aim=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        TGR.spot_rms(tt, *tb[0][:3], biconic=True)
    # the adjoint engine does not differentiate rot: a tilt that
    # requires grad keeps every row rotated, and raises
    tilt = torch.zeros(tt.nsurfaces, 3, dtype=torch.float64,
                       requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        CG.adjoint_spot_rms(tt.replace(tilt=tilt), *tb[0][:3])
