"""rayopt_tpu_torch's polychromatic slice against the JAX package, in
float64 on the CPU: stacked per-wavelength and per-configuration
tables, the batched trace, the plain versions of the stacked-wavelength
kernels (K3 trace_multi, K6 weighted_moments_multi, K7
merit_adjoint_multi) against the Pallas kernels they replace
(interpret mode), the hand-derived K7 reverse against autograd, and
the glass relaxation (glass.py) with both merit engines against the
JAX package's XLA engine.  Also the package's default device: the
card, unless the caller asks for the CPU.  Each test states its
tolerance.  The kernels themselves run only on a CUDA card
(tests/test_torch_cuda.py)."""

import subprocess
import sys
import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import rayopt_tpu as J
from rayopt_tpu import glass as JGL
from rayopt_tpu import models as jmodels
from rayopt_tpu.materials import lambda_d, lambda_C, lambda_F
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.paraxial import paraxial_solve_image as j_solve_image
from rayopt_tpu.ops.pallas_grad import pallas_spot_moments_multi
from rayopt_tpu.ops.pallas_trace import pallas_trace_multi
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as T
from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.paraxial import paraxial_solve_image
from rayopt_tpu_torch.parallel import grad as TGR

RTOL, ATOL = 1e-9, 1e-12
F64 = torch.float64


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


def _bk7_doublet(pkg, pupil=3.):
    """The dispersive cemented doublet of tests/test_glass.py (two
    N-BK7 elements, d/F/C), in package `pkg` (J or T)."""
    s = pkg.System([
        dict(material="air"),
        dict(roc=60., distance=5., material="SCHOTT-BK|N-BK7",
             radius=12.),
        dict(roc=-45., distance=6., material="SCHOTT-BK|N-BK7",
             radius=12.),
        dict(roc=-150., distance=2., material="air", radius=12.),
        dict(distance=95., radius=3.),
    ])
    s.wavelengths = [lambda_d, lambda_F, lambda_C]
    s.object.pupil.radius = pupil
    s.object.pupil.update_radius = False
    s.update()
    return s


def _model_doublet(pkg_models):
    """models.doublet at three wavelengths (tests/test_pallas.py)."""
    s = pkg_models.doublet()
    s.wavelengths = [480e-9, 550e-9, 644e-9]
    return s


def _bundle(n, seed, height, slope, dead_frac=0.):
    """y in +-height, u within +-slope of the axis; with dead_frac a
    leading block is pushed far off the apertures."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*height
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*slope
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    k = int(n*dead_frac)
    if k:
        y[:k, 1] += 50*height
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


def _same(a, b):
    """Bit-identical, NaN where the other is NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _assert_wmoments(got, want, rel):
    """(nlam, 5) weighted moments to `rel` of their scale, positions
    floored at 1 mm a ray as chip_smoke.compare_moments does: the weight
    sum W to rel * W, the sums of x, y to rel * max(sqrt(W sum wx^2), W)
    (they may cancel to ~0), the squares to rel * max(sum wx^2, W)."""
    got, want = np.asarray(got.detach()), np.asarray(want)
    for g, w in zip(got, want):
        scale = [w[0], max((w[0]*w[3])**.5, w[0]),
                 max((w[0]*w[4])**.5, w[0]), max(w[3], w[0]),
                 max(w[4], w[0])]
        for a, b, sc in zip(g, w, scale):
            assert abs(a - b) <= rel*sc, (g, w)


def _jax_at(tables, i):
    """Table i of a JAX stacked table."""
    return jax.tree_util.tree_map(lambda a: a[i], tables)


def _state(y, u):
    return tuple(torch.from_numpy(np.ascontiguousarray(c))
                 for c in (*y.T, *u.T))


def _jstate(y, u):
    return tuple(jnp.asarray(np.ascontiguousarray(c)) for c in (*y.T, *u.T))


# -- the default device ----------------------------------------------------

def test_default_device_is_the_card_unless_asked():
    """Without set_default_device, an entry point asks for the card: on
    this CPU-only torch that raises torch's own error; after
    set_default_device("cpu") the same call returns a CPU table."""
    code = (
        "import torch, rayopt_tpu_torch as T\n"
        "from rayopt_tpu_torch.models import double_gauss\n"
        "s = double_gauss()\n"
        "assert T.default_device() == torch.device('cuda')\n"
        "if torch.cuda.is_available():\n"
        "    assert s.table().device.type == 'cuda'\n"
        "else:\n"
        "    try:\n"
        "        s.table()\n"
        "    except (AssertionError, RuntimeError):\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('a CPU table without asking')\n"
        "T.set_default_device('cpu')\n"
        "assert s.table().device.type == 'cpu'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_entry_points_follow_the_default_device():
    """Every tensor-building entry point lands on the default device
    (here the meta device, which needs no card), while the host-side
    solvers keep their CPU traces: aiming and GeometricTrace still run
    under that default."""
    ts = tmodels.doublet()
    set_default_device("meta")
    assert T.default_device() == torch.device("meta")
    assert ts.table().device.type == "meta"
    assert ts.tables().device.type == "meta"
    assert ts.config_tables().device.type == "meta"
    assert TT.make_table([0., .1]).device.type == "meta"
    assert TT.table_from_numpy(
        jmodels.doublet().table()).device.type == "meta"
    b = TGR.bundles_from_system(ts, fields=(0.,), nrays=8)
    assert all(a.device.type == "meta" for a in b[0][:3])
    assert b[0][3]["mu"].device.type == "meta"
    nb = TGR.bundles_from_numpy(JGR.bundles_from_system(
        jmodels.doublet(), fields=(0.,), nrays=8))
    assert nb[0][0].device.type == "meta"
    t = T.GeometricTrace(ts)
    t.rays_point((0., 1.), nrays=8, distribution="hexapolar")
    assert np.isfinite(t.rms())
    z, p = ts.pupil((0., 1.))
    assert np.isfinite(z)
    for dev in ("cpu", torch.device("cpu")):
        set_default_device(dev)
        assert ts.table().device.type == "cpu"
        assert ts.table(device="meta").device.type == "meta"


def test_import_leaves_jax_out_with_glass():
    code = ("import sys, rayopt_tpu_torch, rayopt_tpu_torch.glass, "
            "rayopt_tpu_torch.ops, rayopt_tpu_torch.parallel, "
            "rayopt_tpu_torch.parallel.diffraction, "
            "rayopt_tpu_torch.utils.zernike, rayopt_tpu_torch.ops.df32, "
            "rayopt_tpu_torch.ops.cuda_df32; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'rayopt_tpu' not in sys.modules, 'rayopt_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# -- stacked tables --------------------------------------------------------

@pytest.mark.parametrize("name", ["doublet", "cooke_triplet", "double_gauss"])
def test_tables_match_jax(name):
    """System.tables equals the JAX package's stack exactly (atol
    1e-15), and table_from_numpy carries the JAX stack across
    unchanged."""
    js, ts = getattr(jmodels, name)(), getattr(tmodels, name)()
    jt, tt = js.tables(), ts.tables()
    carried = TT.table_from_numpy(jt)
    nlam = len(js.wavelengths)
    for f in TT.SurfaceTable._fields:
        want = np.asarray(getattr(jt, f))
        assert getattr(tt, f).shape == want.shape and want.shape[0] == nlam
        _close(getattr(tt, f), want, f, rtol=0, atol=1e-15)
        assert torch.equal(getattr(carried, f), getattr(tt, f)), f
    for li, l in enumerate(js.wavelengths):
        one = TT.table_at(tt, li)
        assert all(torch.equal(a, b) for a, b in zip(one, ts.table(l)))
    assert all(torch.equal(a, b) for a, b in zip(
        TT.stack_tables([TT.table_at(tt, i) for i in range(nlam)]), tt))


def test_config_tables_match_jax():
    """config_tables of the zoom telephoto (carried over by YAML) equals
    the JAX package's exactly (atol 1e-15)."""
    js = jmodels.zoom_telephoto()
    ts = T.system_from_yaml(J.system_to_yaml(js))
    jt, tt = js.config_tables(), ts.config_tables()
    assert tt.curvature.shape[0] == 2
    for f in TT.SurfaceTable._fields:
        _close(getattr(tt, f), getattr(jt, f), f, rtol=0, atol=1e-15)


def test_lower_pose_broadcasts_over_the_stack():
    """lower_pose folds a stacked pose (rodrigues takes (..., 3)) as it
    folds each table's pose (exact)."""
    tt = tmodels.cooke_triplet().tables()
    rng = np.random.RandomState(1)
    tilt = torch.from_numpy(rng.uniform(-.01, .01, tuple(tt.offset.shape)))
    dec = torch.from_numpy(rng.uniform(-.05, .05, tuple(tt.offset.shape)))
    low = TT.lower_pose(tt.replace(tilt=tilt, decenter=dec))
    for li in range(tt.curvature.shape[0]):
        one = TT.lower_pose(TT.table_at(tt.replace(tilt=tilt, decenter=dec),
                                        li))
        for a, b in zip(TT.table_at(low, li), one):
            assert torch.equal(a, b)


def test_pack_table_packs_a_stack():
    """A stacked table packs to (L, S, ROW) in one pass, each slice
    equal to the packing of that wavelength's table (exact), with the
    flags of the shared specs."""
    tt = _model_doublet(tmodels).tables()
    specs = CT.multi_specs(tt, None)
    packed, flags = CT.pack_table(tt, specs, F64, "cpu")
    assert packed.shape == (3, len(specs), CT.ROW) and packed.is_contiguous()
    for li in range(3):
        one, f1 = CT.pack_table(TT.table_at(tt, li), specs, F64, "cpu")
        assert torch.equal(packed[li], one) and torch.equal(flags, f1)


def test_trace_rays_final_multi_matches_jax():
    """The batched trace of the doublet at 3 wavelengths, one collimated
    bundle a wavelength, generic and specialized, equals JAX to 1e-12
    (rtol and atol, as tests/test_torch_trace.py holds the single
    trace: the two frameworks round the ~100 mm path to the image
    differently, ~1.5e-12 on t and the exit directions)."""
    js, ts = _model_doublet(jmodels), _model_doublet(tmodels)
    jt, tt = js.tables(), ts.tables()
    nlam, n = 3, 64
    y = np.stack([_bundle(n, s, .2, 0.)[0] for s in range(nlam)])
    u = np.stack([_bundle(n, s + 9, .2, 0.)[1] for s in range(nlam)])
    specs = jspecialize(_jax_at(jt, 0))
    for jspecs, tspecs in ((None, None),
                           (specs, TK.specs_from_tuple(specs))):
        want = JG.trace_rays_final_multi(jt, y, u, specs=jspecs,
                                         unroll=jspecs is not None)
        got = TG.trace_rays_final_multi(tt, torch.from_numpy(y),
                                        torch.from_numpy(u), specs=tspecs)
        for g, w in zip(got, want):
            assert np.isfinite(g.numpy()).all()
            _close(g, w, rtol=1e-12, atol=1e-12)
    # biconic=True: the generic walk's anamorphic step, as the reference's
    want = JG.trace_rays_final_multi(jt, y, u, biconic=True)
    got = TG.trace_rays_final_multi(tt, torch.from_numpy(y),
                                    torch.from_numpy(u), biconic=True)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        _close(g, w, rtol=1e-12, atol=1e-12)


# -- K3, K6: the plain versions against the Pallas kernels ----------------

@pytest.mark.parametrize("merit", [False, True])
def test_trace_multi_reference_matches_pallas(merit):
    """K3's plain version (and the wrapper on CPU tensors) equals
    pallas_trace_multi in interpret mode with the specs derived from
    the first wavelength on both sides: rtol and atol 1e-12, as
    tests/test_torch_trace.py holds K1's plain version (the doublet's
    ~100 mm path to the image cancels digits the frameworks round
    differently); moments as K1's, to 1e-12 of their scale."""
    js, ts = _model_doublet(jmodels), _model_doublet(tmodels)
    jt, tt = js.tables(), ts.tables()
    y, u, _ = _bundle(256, 0, .2, 0.)
    want = pallas_trace_multi(jax.tree_util.tree_map(jnp.asarray, jt),
                              _jstate(y, u), tile=128, interpret=True,
                              merit=merit)
    before = CT.trace_multi.launches
    got_ref = CT.trace_multi_reference(tt, None, _state(y, u), merit=merit)
    got = CT.trace_multi(tt, None, _state(y, u), merit=merit)
    assert CT.trace_multi.launches == before
    assert len(got) == len(want) == 3
    for g, r, w in zip(got, got_ref, want):
        flat = (lambda o: o) if merit else (lambda o: (*o[0], o[1]))
        for a, b in zip(flat(g), flat(r)):
            _same(a, b)
        if merit:
            assert float(g[0]) == float(w[0])
            _assert_wmoments(torch.stack(g)[None], np.stack(w)[None], 1e-12)
        else:
            for a, c in zip(flat(g), flat(w)):
                _close(a, c, rtol=1e-12, atol=1e-12)
    if not merit:
        # the plain version is trace_rays_final_multi of the bundle
        yb = torch.from_numpy(y).expand(3, -1, -1)
        ub = torch.from_numpy(u).expand(3, -1, -1)
        yf, uf, tf = TG.trace_rays_final_multi(
            tt, yb, ub, specs=CT.multi_specs(tt, None))
        for li, ((x, yy, z, ux, uy, uz), t) in enumerate(got):
            _same(torch.stack([x, yy, z], -1), yf[li])
            _same(t, tf[li])


@pytest.mark.parametrize("clip,dead", [(False, 0.), (True, .25)])
def test_weighted_moments_multi_reference_matches_pallas(clip, dead):
    """K6's plain version equals pallas_spot_moments_multi in interpret
    mode: each moment to 1e-12 of its scale (_assert_wmoments)."""
    js, ts = _model_doublet(jmodels), _model_doublet(tmodels)
    jt, tt = js.tables(), ts.tables()
    specs = jspecialize(_jax_at(jt, 0))
    y, u, w = _bundle(256, 1, .2, 0., dead_frac=dead)
    want = pallas_spot_moments_multi(
        jax.tree_util.tree_map(jnp.asarray, jt), _jstate(y, u),
        jnp.asarray(w), specs=specs, clip=clip, tile=128, interpret=True)
    tspecs = TK.specs_from_tuple(specs)
    got = CG.weighted_moments_multi_reference(tt, tspecs, _state(y, u),
                                              torch.from_numpy(w), clip)
    assert got.shape == (3, 5)
    _assert_wmoments(got, want, 1e-12)
    _close(CG.weighted_moments_multi(tt, tspecs, _state(y, u),
                                     torch.from_numpy(w), clip), got,
           rtol=0, atol=0)


# -- the polychromatic merit: values and gradients -------------------------

def _radius_per_wavelength(tt, jt):
    """A stack whose second wavelength sees a 3 mm aperture on row 2
    (12 mm at the others), so that, clipped, some rays of a 2.8 mm
    bundle die at that wavelength only."""
    rad = np.asarray(jt.radius).copy()
    rad[1, 2] = 3.
    return (tt.replace(radius=torch.from_numpy(rad)),
            jt.replace(radius=jnp.asarray(rad)))


@pytest.mark.parametrize("case", ["plain", "clipped_per_wavelength"])
def test_polychromatic_value_matches_jax(case):
    """The port's glass.polychromatic_spot_rms, both engines, equals the
    JAX package's XLA engine (rtol 1e-12)."""
    js, ts = _bk7_doublet(J), _bk7_doublet(T)
    jt, tt = js.tables(), ts.tables()
    clip = case != "plain"
    if clip:
        tt, jt = _radius_per_wavelength(tt, jt)
    specs = jspecialize(_jax_at(jt, 0))
    y, u, w = _bundle(128, 2, 2.8, .01, dead_frac=.1 if clip else 0.)
    want = float(JGL.polychromatic_spot_rms(jt, y, u, w, specs=specs,
                                            clip=clip))
    tspecs = TK.specs_from_tuple(specs)
    if clip:
        # some rays die at one wavelength only
        yf, _, _ = TG.trace_rays_final_multi(
            tt, torch.from_numpy(y).expand(3, -1, -1),
            torch.from_numpy(u).expand(3, -1, -1), clip=True, specs=tspecs)
        live = np.isfinite(yf[..., 0].numpy())
        assert live.any(0).sum() > live.all(0).sum()
    for engine in ("xla", "adjoint"):
        got = TGL.polychromatic_spot_rms(
            tt, torch.from_numpy(y), torch.from_numpy(u),
            torch.from_numpy(w), specs=tspecs, clip=clip, engine=engine)
        _close(got, want, engine, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", ["model_doublet", "bk7_clipped"])
def test_polychromatic_grads_match_jax(case):
    """Gradients w.r.t. a curvature broadcast over the wavelengths and
    the stacked mu, both port engines, against jax.grad of the JAX
    package's XLA engine (specs, unroll=True): rtol 1e-9, atol 1e-12."""
    if case == "model_doublet":
        js, ts = _model_doublet(jmodels), _model_doublet(tmodels)
        jt, tt = js.tables(), ts.tables()
        y, u, w = _bundle(128, 3, .25, .002)
        clip = False
    else:
        js, ts = _bk7_doublet(J), _bk7_doublet(T)
        tt, jt = _radius_per_wavelength(ts.tables(), js.tables())
        y, u, w = _bundle(128, 4, 2.8, .01, dead_frac=.1)
        clip = True
    specs = jspecialize(_jax_at(jt, 0))

    def jmerit(c, mu):
        t = jt.replace(curvature=jnp.broadcast_to(c, jt.curvature.shape),
                       mu=mu)
        return JGL.polychromatic_spot_rms(t, y, u, w, specs=specs,
                                          unroll=True, clip=clip)
    gc, gm = jax.grad(jmerit, argnums=(0, 1))(
        jnp.asarray(jt.curvature[0]), jnp.asarray(jt.mu))
    tspecs = TK.specs_from_tuple(specs)
    for engine in ("xla", "adjoint"):
        c = tt.curvature[0].clone().requires_grad_()
        mu = tt.mu.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # flat rows bake curvature out
            v = TGL.polychromatic_spot_rms(
                tt.replace(curvature=c.expand_as(tt.curvature), mu=mu),
                torch.from_numpy(y), torch.from_numpy(u),
                torch.from_numpy(w), specs=tspecs, clip=clip, engine=engine)
        v.backward()
        _close(c.grad, gc, engine + " curvature")
        _close(mu.grad, gm, engine + " mu")


def test_glass_gradient_through_glass_tables_matches_jax():
    """d merit / d (nd, vd) through glass_tables' Abbe model on the
    dispersive N-BK7 doublet (tests/test_pallas_grad.py), both port
    engines, against jax.grad of the XLA engine: rtol 1e-9, atol
    1e-12."""
    js, ts = _bk7_doublet(J), _bk7_doublet(T)
    jasg, tasg = JGL.glass_assignment(js), TGL.glass_assignment(ts)
    nd0, vd0 = JGL.initial_glass_params(js, jasg[2])
    jt, tt = js.tables(), ts.tables()
    specs = jspecialize(_jax_at(jt, 0))
    y, u, w = _bundle(128, 5, 2.8, .01)

    def jmerit(nd, vd):
        tb = JGL.glass_tables(jt, nd, vd, jasg, js.wavelengths)
        return JGL.polychromatic_spot_rms(tb, y, u, w, specs=specs,
                                          unroll=True)
    gn, gv = jax.grad(jmerit, argnums=(0, 1))(jnp.asarray(nd0),
                                              jnp.asarray(vd0))
    assert np.all(np.abs(np.asarray(gv)) > 0)
    for engine in ("xla", "adjoint"):
        nd = torch.from_numpy(nd0).requires_grad_()
        vd = torch.from_numpy(vd0).requires_grad_()
        tb = TGL.glass_tables(tt, nd, vd, tasg, ts.wavelengths)
        TGL.polychromatic_spot_rms(
            tb, torch.from_numpy(y), torch.from_numpy(u),
            torch.from_numpy(w), specs=TK.specs_from_tuple(specs),
            engine=engine).backward()
        _close(nd.grad, gn, engine + " nd")
        _close(vd.grad, gv, engine + " vd")


def test_adjoint_multi_baked_out_and_pose():
    """On a stack, a baked-out parameter warns and gets exactly zero, the
    wrapper runs the plain versions without counting launches, and a
    differentiated tilt (K7's rot cotangent, every row kept rotated)
    gets the autograd engine's gradient with the same specs."""
    tt = _model_doublet(tmodels).tables()
    specs = CT.multi_specs(tt, None)
    y, u, w = (torch.from_numpy(a) for a in _bundle(128, 6, .25, .002))
    conic = tt.conic.clone().requires_grad_()
    with pytest.warns(UserWarning, match="'conic' of surface row"):
        CG.polychromatic_spot_rms(tt.replace(conic=conic), y, u, w,
                                  specs=specs).backward()
    rows = CG._baked_out_rows(specs, "conic")
    assert rows and not conic.grad[:, rows].any()
    state = _state(y.numpy(), u.numpy())
    ct = torch.from_numpy(np.random.RandomState(0).normal(size=(3, 5)))
    before = (CG.weighted_moments_multi.launches,
              CG.merit_adjoint_multi.launches)
    for a, b in zip(CG.merit_adjoint_multi(tt, specs, state, w, ct),
                    CG.merit_adjoint_multi_reference(tt, specs, state, w,
                                                     ct)):
        for g, r in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(g, r)
    assert (CG.weighted_moments_multi.launches,
            CG.merit_adjoint_multi.launches) == before
    with pytest.raises(ValueError, match="ct must"):
        CG.merit_adjoint_multi(tt, specs, state, w, ct[:2])
    tilt = torch.zeros(tuple(tt.offset.shape), dtype=F64,
                       requires_grad=True)
    CG.polychromatic_spot_rms(tt.replace(tilt=tilt), y, u, w).backward()
    tilt2 = tilt.detach().clone().requires_grad_()
    TGL.polychromatic_spot_rms(tt.replace(tilt=tilt2), y, u, w,
                               specs=TK.with_pose(specs)).backward()
    assert tilt.grad[:, 1:].abs().max() > 0
    _close(tilt.grad, tilt2.grad, "tilt")


@pytest.mark.parametrize("case", ["posed_cooke", "bk7_clipped"])
def test_adjoint_multi_by_hand_matches_plain(case):
    """The λ loop of the K7 model in torch (_merit_adjoint_multi_by_hand,
    the line-for-line model of csrc/grad_spec.cuh) against the autograd plain
    version, per-wavelength dead rays included: rtol 1e-9, atol 1e-12
    (parameters: 1e-12 of their largest)."""
    if case == "posed_cooke":
        js = jmodels.cooke_triplet()
        jt = js.tables()
        nlam, nsurf = jt.curvature.shape
        tilt = np.zeros((nlam, nsurf, 3))
        tilt[:, 3] = (.01, -.02, 0.)
        dec = np.zeros((nlam, nsurf, 3))
        dec[:, 5] = (.05, -.03, 0.)
        conic = np.asarray(jt.conic).copy()
        conic[:, 2] = -.6
        tt = TT.lower_pose(TT.table_from_numpy(jt.replace(
            tilt=tilt, decenter=dec, conic=conic)))
        y, u, w = _bundle(128, 7, 3., .05)
        clip = False
    else:
        ts, js = _bk7_doublet(T), _bk7_doublet(J)
        tt, _ = _radius_per_wavelength(ts.tables(), js.tables())
        y, u, w = _bundle(128, 8, 2.8, .01, dead_frac=.1)
        clip = True
    specs = CT.multi_specs(tt, None)
    if case == "posed_cooke":
        assert any(s.rotated for s in specs) and any(s.off_axis for s in specs)
    state, wt = _state(y, u), torch.from_numpy(w)
    ct = torch.from_numpy(np.random.RandomState(3).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, specs, state, wt, ct, clip)
    got = CG._merit_adjoint_multi_by_hand(tt, specs, state, wt, ct, clip)
    assert got[0].shape == (3, len(specs), CG.SLOTS)
    assert not got[0][:, 0].any()
    _close(got[0], ref[0], "params", atol=1e-12*float(ref[0].abs().max()))
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        _close(a, b)


# -- glass.py ----------------------------------------------------------------

def test_abbe_index_and_assignment_match_jax():
    """abbe_index (atol 1e-15) and glass_assignment (exact) against JAX;
    mirrors are rejected."""
    for lam in (lambda_d, lambda_F, lambda_C, 550e-9):
        _close(TGL.abbe_index(torch.tensor(1.6123, dtype=F64), 37.4, lam),
               JGL.abbe_index(1.6123, 37.4, lam), rtol=0, atol=1e-15)
    for name in ("doublet", "cooke_triplet", "double_gauss"):
        got = TGL.glass_assignment(getattr(tmodels, name)())
        want = JGL.glass_assignment(getattr(jmodels, name)())
        for a, b in zip(got, want):
            nptest.assert_array_equal(a, b)
    got = TGL.glass_assignment(_bk7_doublet(T))
    nptest.assert_array_equal(got[0], [-1, -1, 0, 1, -1])
    nptest.assert_array_equal(got[1], [-1, 0, 1, -1, -1])
    for a, b in zip(TGL.initial_glass_params(_bk7_doublet(T), got[2]),
                    JGL.initial_glass_params(_bk7_doublet(J), got[2])):
        _close(a, b, rtol=0, atol=1e-15)
    m = T.System([dict(material="air"),
                  dict(roc=-100., distance=10., material="mirror",
                       radius=12.),
                  dict(distance=-45., radius=3.)])
    m.update()
    with pytest.raises(NotImplementedError, match="mirror"):
        TGL.glass_assignment(m)


def _abbe_system(pkg):
    s = pkg.System([
        dict(material="air"),
        dict(roc=60., distance=5., material="1.589/61.2", radius=12.),
        dict(roc=-45., distance=6., material="1.62/36.3", radius=12.),
        dict(roc=-150., distance=2., material="air", radius=12.),
        dict(distance=95., radius=3.),
    ])
    s.wavelengths = [lambda_d, lambda_F, lambda_C]
    s.update()
    return s


def test_glass_tables_reproduce_an_abbe_system():
    """glass_tables rebuilds the glass-owned index slots of an Abbe
    system to rounding (atol 1e-12), equals JAX's glass_tables (atol
    1e-15), leaves bare rows at mu == 1 exactly, and gives finite
    gradients with exact zeros on the rows that own no slot."""
    ts, js = _abbe_system(T), _abbe_system(J)
    asg = TGL.glass_assignment(ts)
    nd0, vd0 = TGL.initial_glass_params(ts, asg[2])
    tabs = ts.tables()
    nb = tabs.n_before.clone()
    na = tabs.n_after.clone()
    nb[:, [2, 3]] = 1.
    na[:, [1, 2]] = 1.
    scrubbed = tabs.replace(n_before=nb, n_after=na,
                            mu=torch.ones_like(tabs.mu))
    rebuilt = TGL.glass_tables(scrubbed, nd0, vd0, asg, ts.wavelengths)
    for j, field in ((1, "n_after"), (2, "n_before"), (2, "n_after"),
                     (3, "n_before")):
        _close(getattr(rebuilt, field)[:, j], getattr(tabs, field)[:, j],
               field, rtol=0, atol=1e-12)
    _close(rebuilt.mu[:, 1:4], tabs.mu[:, 1:4], rtol=0, atol=1e-12)
    assert torch.equal(rebuilt.mu[:, 4], torch.ones(3, dtype=F64))
    jt = js.tables()
    jwant = JGL.glass_tables(jt.replace(
        n_before=jnp.asarray(nb.numpy()), n_after=jnp.asarray(na.numpy()),
        mu=jnp.ones_like(jt.mu)), nd0, vd0, JGL.glass_assignment(js),
        js.wavelengths)
    for f in ("n_before", "n_after", "mu"):
        _close(getattr(rebuilt, f), getattr(jwant, f), f, rtol=0,
               atol=1e-15)
    nd = torch.from_numpy(nd0).requires_grad_()
    vd = torch.from_numpy(vd0).requires_grad_()
    tb = TGL.glass_tables(tabs, nd, vd, asg, ts.wavelengths)
    owned = (asg[0] >= 0) | (asg[1] >= 0)
    free = torch.from_numpy(~owned)
    # rows that own no slot: exactly zero gradient; owned rows: finite
    g = torch.autograd.grad((tb.mu[:, free].sum() + tb.n_before[:, free].sum()
                             + tb.n_after[:, free].sum()), (nd, vd),
                            allow_unused=True, retain_graph=True)
    assert all(x is None or not x.any() for x in g)
    g = torch.autograd.grad(tb.mu.sum() + tb.n_before.sum(), (nd, vd))
    assert all(torch.isfinite(x).all() and x.abs().min() > 0 for x in g)


def test_glass_box_round_trip_matches_jax():
    """encode/decode round trip (rtol 1e-12) and agreement with JAX's
    glass box (rtol 1e-15)."""
    nd = np.array([1.5168, 1.92])
    vd = np.array([64.2, 20.9])
    xi_nd, xi_vd = TGL.glass_box_encode(nd, vd)
    for a, b in zip((xi_nd, xi_vd), JGL.glass_box_encode(nd, vd)):
        nptest.assert_array_equal(a, b)
    nd2, vd2 = TGL.glass_box_decode(torch.from_numpy(xi_nd),
                                    torch.from_numpy(xi_vd))
    _close(nd2, nd, rtol=1e-12, atol=0)
    _close(vd2, vd, rtol=1e-12, atol=0)
    jnd, jvd = JGL.glass_box_decode(jnp.asarray(xi_nd), jnp.asarray(xi_vd))
    _close(nd2, jnd, rtol=1e-15, atol=0)
    _close(vd2, jvd, rtol=1e-15, atol=0)
    assert TGL.GLASS_BOX == JGL.GLASS_BOX


def test_catalog_snap_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 2"):
        TGL.nearest_glasses(1.62, 36.)
    with pytest.raises(NotImplementedError, match="item 2"):
        TGL.substitute_glasses(_bk7_doublet(T), [1.5], [60.], [1])


def test_flint_discovery_matches_jax():
    """tests/test_glass.py's flint discovery without the catalog snap:
    fixed curvatures, free vd2, 500 Adam(0.05) steps on the paraxial
    back-focal spread over d/F/C.  The port lands within 1.5 of the
    thin-lens 25.7 and within 1e-6 relative of the JAX run."""
    js, ts = _bk7_doublet(J), _bk7_doublet(T)
    asg = TGL.glass_assignment(ts)
    nd0, vd0 = TGL.initial_glass_params(ts, asg[2])
    n = 1.5168
    phi1 = (n - 1)*(1/60. + 1/45.)
    phi2 = (n - 1)*(-1/45. + 1/150.)
    v2_thin = vd0[0]*abs(phi2)/phi1
    y0p, u0p = np.array([1., 0.]), np.array([0., 1e-6])
    xi0 = TGL.glass_box_encode([nd0[1]], [vd0[1]])[1]
    steps = 500

    # JAX, as tests/test_glass.py runs it
    jtabs = js.tables()

    def jspread(xi_vd):
        _, vd1 = JGL.glass_box_decode(jnp.zeros(1), xi_vd)
        vd = jnp.concatenate([jnp.asarray(vd0[:1]), vd1])
        tb = JGL.glass_tables(jtabs, jnp.asarray(nd0), vd, asg,
                              js.wavelengths)
        fd = jax.vmap(lambda t: j_solve_image(t, jnp.asarray(y0p),
                                              jnp.asarray(u0p)))(tb)
        return jnp.square(fd - fd.mean()).sum()
    xi = jnp.asarray(xi0)
    opt = optax.adam(0.05)
    st = opt.init(xi)
    vg = jax.jit(jax.value_and_grad(jspread))
    for _ in range(steps):
        _, g = vg(xi)
        up, st = opt.update(g, st, xi)
        xi = optax.apply_updates(xi, up)
    want = float(np.asarray(JGL.glass_box_decode(jnp.zeros(1), xi)[1])[0])

    # the port
    tabs = ts.tables()

    def spread(xi_vd):
        _, vd1 = TGL.glass_box_decode(torch.zeros(1, dtype=F64), xi_vd)
        vd = torch.cat([torch.from_numpy(vd0[:1]), vd1])
        tb = TGL.glass_tables(tabs, nd0, vd, asg, ts.wavelengths)
        fd = torch.stack([paraxial_solve_image(TT.table_at(tb, li), y0p,
                                               u0p)
                          for li in range(len(ts.wavelengths))])
        return torch.square(fd - fd.mean()).sum()
    xt = torch.from_numpy(xi0).requires_grad_()
    v0 = float(spread(xt).detach())
    topt = torch.optim.Adam([xt], lr=0.05)
    for _ in range(steps):
        topt.zero_grad()
        spread(xt).backward()
        topt.step()
    v1 = float(spread(xt).detach())
    got = float(TGL.glass_box_decode(torch.zeros(1, dtype=F64),
                                     xt.detach())[1][0])
    assert v1 < v0*1e-6, (v0, v1)
    assert abs(got - v2_thin) < 1.5, (got, v2_thin)
    nptest.assert_allclose(got, want, rtol=1e-6)
