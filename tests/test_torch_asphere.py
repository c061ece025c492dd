"""rayopt_tpu_torch's aspheric rows (even and odd figure, the seeded
Newton intercept) against the JAX package, in float64 on the CPU: the
polynomials, sag and radial normal, the intercept, the specialized and
generic steps, the engines of ops.geometric on the reference's aspheric
double Gauss (tests/test_df32.py's edit) and odd singlet
(tests/test_pallas.py's), the element oracle of ops.surfaces, and the
implicit-differentiation Newton (kernels._NewtonRoot) against jax.grad
of the reference's specialized XLA engine.  Traces agree to 1e-12
relative with identical NaN masks, gradients to 1e-9 relative (of the
largest of each field, where a field's entries span decades).  The
kernel side (K1, K2, K4, K5 keys, the hand reverse, the refusals) is
tests/test_torch_spec_asphere.py."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import models as jmodels
from rayopt_tpu.elements import Spheroid as JSpheroid
from rayopt_tpu.materials import air as jair
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import surfaces as JS
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR
from rayopt_tpu.system import System as JSystem

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.elements import Spheroid as TSpheroid
from rayopt_tpu_torch.materials import air as tair
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import surfaces as TS
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR
from rayopt_tpu_torch.system import System as TSystem

RTOL = ATOL = 1e-12
GRAD_RTOL = 1e-9


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float64)))


def _same(got, want, rtol=RTOL, atol=ATOL, msg=""):
    """Identical NaN masks, the finite values within rtol/atol."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    nptest.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
    ok = np.isfinite(want)
    nptest.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol,
                           err_msg=msg)


# -- the two lenses ----------------------------------------------------------

def aspheric_double_gauss(models):
    """The reference's aspheric double Gauss (tests/test_df32.py,
    test_trace_parity_conic_aspheric): two conic rows and an even
    asphere."""
    s = models.double_gauss()
    s[2].conic = -.7
    s[5].conic = .4
    s[7].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    return s


def odd_singlet(system, spheroid, air):
    """The reference's odd singlet (tests/test_pallas.py,
    test_pallas_odd_aspherics): a conic front with even and odd
    figure."""
    s = system()
    s.append(spheroid(material=air, radius=9.))
    s.append(spheroid(distance=8., curvature=1/45., conic=-.3,
                      aspherics=[0., 2e-7], aspherics_odd=[0., 1e-5, -2e-8],
                      material=1.6, radius=9.))
    s.append(spheroid(distance=5., curvature=-1/80., material=air,
                      radius=9.))
    s.append(spheroid(distance=70., material=None, radius=9.))
    s.wavelengths = [587.56e-9]
    s.update()
    return s


def _lens(name):
    """(JAX table, port table) of one lens, field for field equal."""
    if name == "double_gauss":
        js, ts = aspheric_double_gauss(jmodels), aspheric_double_gauss(
            tmodels)
    else:
        js = odd_singlet(JSystem, JSpheroid, jair)
        ts = odd_singlet(TSystem, TSpheroid, tair)
    return js.table(), ts.table()


def _bundle(n, seed, height, slope=.05):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*height
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    return y, u


LENSES = ("double_gauss", "odd_singlet")
HEIGHT = {"double_gauss": 12., "odd_singlet": 8.5}


def test_lenses_match_and_are_figured():
    for name in LENSES:
        jt, tt = _lens(name)
        for f in JT.SurfaceTable._fields:
            a, b = getattr(jt, f), getattr(tt, f)
            assert (a is None) == (b is None), f
            if a is not None:
                nptest.assert_array_equal(b.numpy(), np.asarray(a), f)
        specs = TK.specialize(tt)
        assert specs == TK.specs_from_tuple(JK.specialize(jt))
        fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
        assert fig == ([7] if name == "double_gauss" else [1])
    assert TK.specialize(_lens("odd_singlet")[1])[1].odd


# -- polynomials, sag, radial normal -----------------------------------------

def test_polynomials_sag_and_normal_match_jax():
    rng = np.random.RandomState(1)
    r2 = np.concatenate([[0.], rng.uniform(0, 80, 63)])
    x, y = np.sqrt(r2)*np.cos(r2), np.sqrt(r2)*np.sin(r2)
    z = rng.uniform(-1, 1, 64)
    asp = np.array([1e-4, 2e-7, -3e-11])
    aspo = np.array([3e-4, 1e-5, -2e-8])
    c, k = 1/45., -.3
    for name in ("_poly_even", "_dpoly_even", "_poly_odd", "_dpoly_odd"):
        for coeffs in (asp, aspo, asp[:0]):
            _same(getattr(TK, name)(_t(r2), _t(coeffs)),
                  getattr(JK, name)(r2, coeffs), msg=name)
    for a, ao in ((asp, aspo), (asp, None), (asp[:0], aspo)):
        ta, tao = _t(a), None if ao is None else _t(ao)
        _same(TK.sag(_t(x), _t(y), _t(z), _t(c), _t(k), ta, tao),
              JK.sag(x, y, z, c, k, a, ao), msg="sag")
        _same(TK.normal_radial(_t(x), _t(y), _t(c), _t(k), ta, tao),
              JK.normal_radial(x, y, c, k, a, ao), msg="normal_radial")
    # the odd slope's vertex floor: finite (huge) at r2 == 0, as the
    # reference's
    assert np.isfinite(TK._dpoly_odd(_t([0.]), _t(aspo)).numpy()).all()


def test_element_oracle_matches_jax():
    """ops.surfaces (the element oracle, its Newton unrolled) on an even
    and odd figure."""
    y, u = _bundle(64, 4, 6., .1)
    y[:, 2] = -5.
    kw = dict(curvature=1/45., conic=-.3)
    a, ao = np.array([0., 2e-7]), np.array([0., 1e-5, -2e-8])
    want = JS.intercept(y, u, kw["curvature"], kw["conic"], a,
                        aspherics_odd=ao)
    got = TS.intercept(_t(y), _t(u), kw["curvature"], kw["conic"], _t(a),
                       aspherics_odd=_t(ao))
    assert np.isfinite(np.asarray(want)).all()
    _same(got, want)
    p = y + np.asarray(want)[:, None]*u
    _same(TS.surface_sag(_t(p), 1/45., -.3, _t(a), _t(ao)),
          JS.surface_sag(p, 1/45., -.3, a, ao))
    _same(TS.surface_normal(_t(p), 1/45., -.3, _t(a), _t(ao)),
          JS.surface_normal(p, 1/45., -.3, a, ao))
    _same(TS.refract(_t(p), _t(u), 1/1.6, 1/45., -.3, _t(a), _t(ao)),
          JS.refract(p, u, 1/1.6, 1/45., -.3, a, ao))


# -- the intercept and the steps ---------------------------------------------

def _local_rays(n, seed, height):
    y, u = _bundle(n, seed, height, .15)
    y[:, 2] = -2.
    return y, u


@pytest.mark.parametrize("name", LENSES)
def test_intercept_matches_jax(name):
    """kernels.intercept row by row (every row of the double Gauss: the
    generic engine Newtons them all, its aspherics having width 3), NaN
    masks equal; some rays miss."""
    jt, tt = _lens(name)
    # wide enough that some rays miss a curved row (past its rim)
    y, u = _local_rays(256, 2, {"double_gauss": 16., "odd_singlet": 50.}[name])
    nan = 0
    for j in range(1, tt.nsurfaces):
        row = tt.row(j)
        args = (*y.T, *u.T)
        want = JK.intercept(*args, jt.curvature[j], jt.conic[j],
                            jt.aspherics[j], jt.alternate[j],
                            aspherics_odd=jt.aspherics_odd[j])
        got = TK.intercept(*map(_t, args), row.curvature, row.conic,
                           row.aspherics, row.alternate,
                           aspherics_odd=row.aspherics_odd)
        _same(got, want, msg="row %d" % j)
        nan += int(np.isnan(np.asarray(want)).sum())
    assert nan


FIGURED_ROWS = {
    "even": dict(curvature=1/40., conic=-.5, aspherics=[1e-4, 2e-7]),
    "odd": dict(curvature=1/45., aspherics_odd=[0., 1e-5, -2e-8]),
    "both_mirror": dict(curvature=-1/60., conic=.3, mu=-1.,
                        aspherics=[0., 3e-7], aspherics_odd=[2e-4, 0.]),
    "flat_even": dict(curvature=0., aspherics=[5e-4, -1e-6]),
    "passthrough_odd": dict(curvature=1/30., mu=1., aspherics_odd=[1e-4]),
    "rotated_off_axis_even": dict(curvature=-1/50., aspherics=[0., 4e-7],
                                  offset=(.3, -.2, 5.), tilt=(.03, -.02)),
}


def figured_row(curvature=0., conic=0., mu=1/1.5, aspherics=(),
                aspherics_odd=(), offset=(0., 0., 5.), tilt=None,
                radius=np.inf):
    """A two-row table whose row 1 is figured (object row first)."""
    rot = None
    if tilt is not None:
        from rayopt_tpu.utils.geometry import euler_matrix
        rot = [np.eye(3), euler_matrix(*tilt, 0., axes="rxyz")]
    na, no = len(aspherics), len(aspherics_odd)
    return dict(curvature=[0., curvature], conic=[0., conic],
                mu=[1., mu], radius=[np.inf, radius],
                n_before=[1., 1.], n_after=[1., 1./mu if mu > 0 else 1.],
                offset=[[0., 0., 0.], list(offset)], rot=rot,
                aspherics=[[0.]*na, list(aspherics)],
                aspherics_odd=[[0.]*no, list(aspherics_odd)])


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(FIGURED_ROWS))
def test_surface_step_spec_figured_matches_jax(name, clip):
    kw = figured_row(**FIGURED_ROWS[name], radius=7.)
    jt = JT.make_table(**kw)
    specs = JK.specialize(jt)
    tt = TT.table_from_numpy(jt)
    tspecs = TK.specs_from_tuple(specs)
    assert TK.specialize(tt) == tspecs and TK.is_figured(tspecs[1])
    y, u = _local_rays(200, 7, 9.)
    state = tuple(np.ascontiguousarray(c) for c in (*y.T, *u.T))
    jsurf = JT.SurfaceTable(*(None if f is None else jnp.asarray(f)[1]
                              for f in jt))
    for step, tstep, args in (
            (JK.surface_step_spec, TK.surface_step_spec, (specs[1],)),
            (JK.surface_step, TK.surface_step, ())):
        want_state, want_out = step(state, jsurf, *args, clip)
        targs = (tspecs[1],) if args else ()
        got_state, got_out = tstep(tuple(map(_t, state)), tt.row(1),
                                   *targs, clip)
        for g, w in zip((*got_state, *got_out[0], *got_out[1],
                         got_out[3]),
                        (*want_state, *want_out[0], *want_out[1],
                         want_out[3])):
            _same(g, w, msg=step.__name__)


# -- the engines on the two lenses -------------------------------------------

ENGINES = ("generic", "specialized", "fast")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", LENSES)
def test_trace_rays_final_matches_jax(name, engine):
    """trace_rays_final (generic and specialized) and
    trace_rays_final_fast (on the CPU: the plain generic walk) against
    the reference's trace_rays_final, clipped at the lens apertures."""
    jt, tt = _lens(name)
    y, u = _bundle(256, 3, HEIGHT[name])
    specs = JK.specialize(jt) if engine == "specialized" else None
    want = JG.trace_rays_final(jt, y, u, clip=True, specs=specs,
                               unroll=specs is not None)
    if engine == "fast":
        got = TG.trace_rays_final_fast(tt, _t(y), _t(u), clip=True)
    else:
        got = TG.trace_rays_final(tt, _t(y), _t(u), clip=True,
                                  specs=specs and TK.specs_from_tuple(specs))
    for g, w in zip(got, want):
        _same(g, w)
    assert np.isfinite(got[0].numpy()).any()


def test_trace_rays_history_matches_jax():
    jt, tt = _lens("odd_singlet")
    y, u = _bundle(128, 9, 8.5)
    want = JG.trace_rays(jt, y, u)
    got = TG.trace_rays(tt, _t(y), _t(u))
    for g, w in zip(got, want):
        _same(g, w)


# -- the Newton's gradient ---------------------------------------------------

def aspheric_doublet(models, odd=True):
    """The reference's aspheric doublet (tests/test_pallas_grad.py,
    test_adjoint_grad_aspheric_conic), with odd=True also an odd figure
    on its conic row, so that every coefficient field has live rows.
    (The odd figure makes the gradient of an exactly on-axis ray NaN, in
    the reference too: aim no such bundle at it.)"""
    tab = models.doublet().table()
    nsurf = tab.curvature.shape[0]
    asp = np.zeros((nsurf, 2))
    asp[1] = [1e-5, -1e-7]
    aspo = np.zeros((nsurf, 2 if odd else 0))
    if odd:
        aspo[2] = [0., 3e-6]
    conic = np.asarray(tab.conic).copy()
    conic[2] = -.5
    return tab.replace(aspherics=asp, aspherics_odd=aspo, conic=conic)


def grad_bundle(s, n=128, seed=0):
    """The reference's adjoint-test bundle (tests/test_pallas_grad.py):
    uniform in the pupil, no ray exactly on the axis."""
    rng = np.random.RandomState(seed)
    r = s.object.pupil.radius
    sl = s.object.pupil.slope
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*.8*r
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*.3*sl
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


SELECT = ("curvature", "conic", "aspherics", "aspherics_odd")


def test_newton_gradient_matches_jax_grad():
    """spot_rms through the port's specialized plain trace (autograd,
    the Newton by its implicit Function) against jax.grad of the
    reference's spot_rms(specs=, unroll=True) -- its XLA engine, whose
    Newton is the custom_jvp -- w.r.t. curvature, conic and both
    coefficient fields; and the port's generic engine against the
    reference's generic one."""
    jt = aspheric_doublet(jmodels)
    jspecs = JK.specialize(jt)
    assert jspecs[1].aspheric and jspecs[2].odd
    y, u, w = grad_bundle(jmodels.doublet())
    tt = TT.table_from_numpy(jt)
    for jspec in (jspecs, None):
        p0 = {k: jnp.asarray(getattr(jt, k)) for k in SELECT}
        jv, jg = jax.value_and_grad(lambda p: JGR.spot_rms(
            jt.replace(**p), y, u, w, specs=jspec,
            unroll=jspec is not None))(p0)
        params = {k: getattr(tt, k).clone().requires_grad_()
                  for k in SELECT}
        tv = TGR.spot_rms(tt.replace(**params), _t(y), _t(u), _t(w),
                          specs=jspec and TK.specs_from_tuple(jspec))
        tv.backward()
        nptest.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
        for k in SELECT:
            want = np.asarray(jg[k])
            assert np.any(want != 0), k
            nptest.assert_allclose(
                params[k].grad.numpy(), want, rtol=GRAD_RTOL,
                atol=GRAD_RTOL*np.abs(want).max(), err_msg=k)


def test_newton_root_gradcheck():
    """torch.autograd.gradcheck of kernels._NewtonRoot: the implicit
    derivative at the root against central differences of the converged
    forward, w.r.t. the rays, the curvature, the conic and both
    coefficient vectors (the seed gets none)."""
    rng = np.random.RandomState(3)
    n = 6
    x, y = (_t(v) for v in rng.uniform(-5, 5, (2, n)))
    z = _t(np.full(n, -2.))
    ux, uy = (_t(v) for v in rng.uniform(-.1, .1, (2, n)))
    uz = torch.sqrt(1 - ux*ux - uy*uy)
    c, k = _t(1/40.), _t(-.4)
    asp, aspo = _t([1e-4, 2e-7]), _t([3e-4, 1e-5])
    leaves = [v.clone().requires_grad_()
              for v in (x, y, z, ux, uy, uz, c, k, asp, aspo)]

    def root(*a):
        seed = TK.intercept_conic(*(v.detach() for v in a[:8]), 0.)
        return TK._NewtonRoot.apply(seed, *a, TK.ASPHERIC_ITERS,
                                    TK.ASPHERIC_TOL)
    assert torch.isfinite(root(*leaves)).all()
    assert torch.autograd.gradcheck(root, leaves, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_on_axis_odd_gradient_is_nan_as_the_reference():
    """An exactly on-axis ray through an odd figure: the reference's
    gradient is NaN (sqrt(r2) at r2 = 0 in the sag's jets), and so is
    the port's; through an even figure it is finite and equal."""
    for name, nan in (("odd", True), ("even", False)):
        kw = figured_row(**FIGURED_ROWS[name])
        kw = {k: v for k, v in kw.items() if v is not None}
        kw.update(curvature=kw["curvature"] + [-1/80.],
                  conic=kw["conic"] + [0.], mu=kw["mu"] + [1.6],
                  radius=kw["radius"] + [np.inf],
                  n_before=kw["n_before"] + [1/1.5],
                  n_after=kw["n_after"] + [1.],
                  offset=kw["offset"] + [[0., 0., 5.]],
                  aspherics=kw["aspherics"] + [[0.]*len(kw["aspherics"][0])],
                  aspherics_odd=kw["aspherics_odd"]
                  + [[0.]*len(kw["aspherics_odd"][0])])
        kw["curvature"][2] = -1/80.
        jt = JT.make_table(**kw)
        y = np.array([[0., 0., 0.], [0., 1., 0.], [.5, -2., 0.]])
        u = np.array([[0., 0., 1.]]*3)
        jspecs = JK.specialize(jt)
        field = "aspherics_odd" if nan else "aspherics"
        jg = jax.grad(lambda a: JGR.spot_rms(
            jt.replace(**{field: a}), y, u, specs=jspecs,
            unroll=True))(jnp.asarray(getattr(jt, field)))
        tt = TT.table_from_numpy(jt)
        a = getattr(tt, field).clone().requires_grad_()
        TGR.spot_rms(tt.replace(**{field: a}), _t(y), _t(u),
                     specs=TK.specs_from_tuple(jspecs)).backward()
        assert bool(np.isnan(np.asarray(jg)).any()) == nan
        _same(a.grad, jg, rtol=GRAD_RTOL, atol=1e-15)


# -- tables -------------------------------------------------------------------

def test_table_from_numpy_carries_aspheric_widths():
    """table_from_numpy carries aspherics and aspherics_odd whatever
    their widths: zero, equal or different."""
    base = jmodels.doublet().table()
    nsurf = base.curvature.shape[0]
    for na, no in ((0, 0), (3, 0), (0, 2), (2, 5)):
        rng = np.random.RandomState(na + 7*no)
        jt = base.replace(aspherics=rng.normal(size=(nsurf, na))*1e-6,
                          aspherics_odd=rng.normal(size=(nsurf, no))*1e-6)
        tt = TT.table_from_numpy(jt)
        assert tuple(tt.aspherics.shape) == (nsurf, na)
        assert tuple(tt.aspherics_odd.shape) == (nsurf, no)
        nptest.assert_array_equal(tt.aspherics.numpy(), jt.aspherics)
        nptest.assert_array_equal(tt.aspherics_odd.numpy(),
                                  jt.aspherics_odd)
        # a stacked (per-wavelength) table too
        st = TT.table_from_numpy(JT.SurfaceTable(*(
            None if f is None else np.stack([np.asarray(f)]*2)
            for f in jt)))
        assert tuple(st.aspherics.shape) == (2, nsurf, na)
        assert tuple(st.aspherics_odd.shape) == (2, nsurf, no)
