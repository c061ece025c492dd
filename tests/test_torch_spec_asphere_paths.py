"""The polychromatic and wavefront kernels' aspheric rows (K3, K6, K7, K8
and K9), on the CPU against the JAX package, in float64: the plain
versions of K3 (trace and merit) and K6 against the JAX package's
multi-table trace and the moments of its rays, K8 against
parallel.grad.opd_rays; the value and the gradient of
glass.polychromatic_spot_rms(engine="adjoint") (K6/K7) and of
adjoint_wavefront_rms (K8/K9) against jax.grad of the JAX package's XLA
engines with the same specs; one small interpret-mode check of the JAX
package's own Pallas kernels on the odd singlet; the hand-written K7
and K9 reverses (the figured step's PATH form included) against their
autograd plain versions; and the keys' widths, K9's slot layout, its
row-word limit and K3's and K6's shared-memory limit on the grown rows.
The lenses are the JAX package's aspheric double Gauss (its
tests/test_df32.py) and odd singlet (its tests/test_pallas.py).  Each
test states its tolerance.  The kernels themselves build and run only
on a CUDA card (tests/test_torch_cuda.py)."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import glass as JGL
from rayopt_tpu import models as jmodels
from rayopt_tpu.elements import Spheroid as JSpheroid
from rayopt_tpu.materials import air as jair
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops.pallas_grad import (pallas_opd_rays,
                                        pallas_polychromatic_spot_rms)
from rayopt_tpu.parallel import grad as JGR
from rayopt_tpu.system import System as JSystem

from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.elements import Spheroid as TSpheroid
from rayopt_tpu_torch.materials import air as tair
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.system import System as TSystem

from test_torch_asphere import _same, _t, aspheric_double_gauss, odd_singlet

F32, F64 = torch.float32, torch.float64
RTOL = 1e-12          # traces and moments, relative (_same's atol too)
GRAD_REL = 1e-9       # gradients: of each field's largest entry
LENSES = ("double_gauss", "odd_singlet")
#: the rays' half-width (mm) and slope on each lens: every ray lives
#: through the double Gauss; the singlet's odd figure is off the axis
HEIGHT = {"double_gauss": 10., "odd_singlet": 7.}
SLOPE = {"double_gauss": .02, "odd_singlet": .01}
#: the fields the merits differentiate ("offset": the distances too)
SEL = ("curvature", "conic", "offset", "n_before", "aspherics",
       "aspherics_odd")


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


def _systems(name):
    """(JAX system, port system) of one lens."""
    if name == "double_gauss":
        return aspheric_double_gauss(jmodels), aspheric_double_gauss(tmodels)
    return (odd_singlet(JSystem, JSpheroid, jair),
            odd_singlet(TSystem, TSpheroid, tair))


def _stacks(name):
    """(JAX stack, port stack, JAX specs, port specs) of 3 tables: the
    double Gauss's 3 wavelengths (System.tables); the singlet, one
    wavelength of a constant index, as 3 tables whose refracting rows'
    mu grow by 0, 1 and 2 % of mu - 1 (a dispersion of its own)."""
    js, _ = _systems(name)
    if name == "double_gauss":
        jt = js.tables()
    else:
        t0 = js.table()
        mu = np.asarray(t0.mu)
        jt = jax.tree_util.tree_map(
            lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
            *[t0.replace(mu=jnp.asarray(1 + (mu - 1)*(1 + .01*li)))
              for li in range(3)])
    tt = TT.table_from_numpy(jt)
    jspecs = JK.specialize(jax.tree_util.tree_map(lambda a: a[0], jt))
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs)


def _bundle(name, n, seed):
    """n rays over the lens's aperture, slopes up to SLOPE, weights in
    [0.5, 1.5] normalized; ray 0 is the chief ray (on the axis of the
    double Gauss; the singlet's odd figure has a NaN gradient there, as
    the reference's, so its chief ray is off the axis)."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*HEIGHT[name]
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*SLOPE[name]
    y[0, :2] = (0., 0.) if name == "double_gauss" else (.5, .3)
    u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


def _state(y, u):
    return tuple(_t(c) for c in (*y.T, *u.T))


def _wmoments(y, w):
    """The five weighted moments of final positions y (N, 3) over the
    rays whose x, y are finite, in numpy."""
    good = np.isfinite(y[:, 0]) & np.isfinite(y[:, 1])
    x, yy, wg = y[good, 0], y[good, 1], w[good]
    return np.array([wg.sum(), (wg*x).sum(), (wg*yy).sum(),
                     (wg*x*x).sum(), (wg*yy*yy).sum()])


def _close_moments(got, want):
    """Each moment within RTOL of its scale (the weight sum W, W times
    the RMS coordinate, the second moments)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    wsum, sxx, syy = want[0], want[3], want[4]
    scale = np.array([wsum, np.sqrt(wsum*sxx), np.sqrt(wsum*syy), sxx, syy])
    nptest.assert_array_less(np.abs(got - want), RTOL*scale + 1e-300)


def _close_grad(got, want, name):
    """GRAD_REL of the field's largest entry (a field of no columns, the
    double Gauss's odd coefficients, is empty on both sides)."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    if not want.size:
        return
    nptest.assert_allclose(got, want, rtol=0,
                           atol=GRAD_REL*max(float(np.abs(want).max()),
                                             1e-300), err_msg=name)


# -- K3 and K6: the plain versions against the JAX package ------------------

@pytest.mark.parametrize("name", LENSES)
def test_k3_and_k6_plain_versions_match_jax(name):
    """K3's trace (per wavelength: the final state and the path) and
    merit (the count moments), and K6's weighted moments, on a stack of
    3 tables of the lens, against JG.trace_rays_final_multi (specs,
    unroll) of the same bundle and the moments of its rays: the traces
    to RTOL with equal NaN masks, the moments to RTOL of their scale.
    The wrappers run the plain versions here and launch nothing."""
    jt, tt, jspecs, specs = _stacks(name)
    y, u, w = _bundle(name, 96, 1)
    yb, ub = np.broadcast_to(y, (3,) + y.shape), np.broadcast_to(
        u, (3,) + u.shape)
    jy, ju, jtt = (np.asarray(a) for a in JG.trace_rays_final_multi(
        jt, yb, ub, specs=jspecs, unroll=True))
    state = _state(y, u)
    before = (CT.trace_multi.launches, CG.weighted_moments_multi.launches)
    got = CT.trace_multi(tt, specs, state)
    mom = CT.trace_multi(tt, specs, state, merit=True)
    wmom = CG.weighted_moments_multi(tt, specs, state, _t(w))
    assert (CT.trace_multi.launches,
            CG.weighted_moments_multi.launches) == before
    assert np.isfinite(jy).all() and wmom.shape == (3, 5)
    for li in range(3):
        (x, yy, z, ux, uy, uz), t = got[li]
        for c, a in enumerate((x, yy, z)):
            _same(a, jy[li, :, c], msg="y%d wavelength %d" % (c, li))
        for c, a in enumerate((ux, uy, uz)):
            _same(a, ju[li, :, c], msg="u%d wavelength %d" % (c, li))
        _same(t, jtt[li], msg="path wavelength %d" % li)
        _close_moments(torch.stack(mom[li]), _wmoments(jy[li],
                                                       np.ones(len(y))))
        _close_moments(wmom[li], _wmoments(jy[li], w))


def test_k8_plain_version_matches_opd_rays():
    """K8's plain version, through adjoint_opd_rays on a CPU bundle, on
    both lenses against parallel.grad.opd_rays(specs=, unroll=True,
    with_pupil=True): the waves to 1e-12 of the largest optical path
    (|k|, ~1e5 waves: the difference k - k[ref] keeps that rounding),
    the landing to RTOL, equal NaN masks."""
    for name in LENSES:
        js, ts = _systems(name)
        jtab, ttab = js.table(), ts.table(device="cpu")
        jspecs = JK.specialize(jtab)
        specs = TK.specs_from_tuple(jspecs)
        y, u, _ = _bundle(name, 96, 2)
        kw = _opd_kw(js)
        wj, lj = JGR.opd_rays(jtab, y, u, with_pupil=True, specs=jspecs,
                              unroll=True, **kw)
        before = CG.opd_chain.launches
        wt, lt = CG.adjoint_opd_rays(ttab, _t(y), _t(u), with_pupil=True,
                                     specs=specs, **kw)
        assert CG.opd_chain.launches == before
        k, _, _ = CG.opd_chain_reference(ttab, specs, _state(y, u),
                                         _aux(ttab, specs, y, u, kw))
        wj, lj = np.asarray(wj), np.asarray(lj)
        assert np.isfinite(wj).sum() > 90
        _same(wt, wj, rtol=0, atol=1e-12*float(k.abs().max()), msg=name)
        _same(lt, lj, msg=name)


def _opd_kw(js):
    return dict(ref=0, radius=-js.image.pupil.distance,
                wavelength=js.wavelengths[0], scale=js.scale,
                finite=js.object.finite)


def _aux(tab, specs, y, u, kw):
    """K8's aux vector of a bundle (adjoint_opd_rays's): the chief ray's
    image point, the sphere radius and the wavelength scale."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    yr, _, _ = trace_rays_final(tab, _t(y[:1]), _t(u[:1]), specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [kw["radius"], kw["wavelength"]/kw["scale"]], dtype=F64)])


# -- the merits' values and gradients against jax.grad ----------------------

def _leaves(tab, fields):
    return {f: getattr(tab, f).clone().requires_grad_() for f in fields}


def _grads(leaves):
    return {f: torch.zeros_like(v) if v.grad is None else v.grad
            for f, v in leaves.items()}


@pytest.mark.parametrize("name", LENSES)
def test_polychromatic_adjoint_matches_jax_grad(name):
    """glass.polychromatic_spot_rms(engine="adjoint") (K6 forward, K7
    backward; their plain versions here) on a stack of 3 tables of the
    lens against jax.value_and_grad of the JAX package's XLA engine
    (glass.polychromatic_spot_rms, specs, unroll=True): the value to
    RTOL, the gradient of every field of SEL (per table) to GRAD_REL of
    the field's largest entry -- the aspheric coefficients nonzero on
    the figured rows only, n_before exactly zero (the spot merit reads
    no optical path)."""
    jt, tt, jspecs, specs = _stacks(name)
    y, u, w = _bundle(name, 96, 3)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in SEL}
    jv, jg = jax.value_and_grad(lambda p: JGL.polychromatic_spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True))(p0)
    leaves = _leaves(tt, SEL)
    with pytest.warns(UserWarning, match="aspherics"):
        v = TGL.polychromatic_spot_rms(tt.replace(**leaves), _t(y), _t(u),
                                       _t(w), specs=specs, engine="adjoint")
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    got = _grads(leaves)
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    for f in SEL:
        _close_grad(got[f], jg[f], f)
    assert not bool(got["n_before"].any())
    coeff = torch.cat([got["aspherics"], got["aspherics_odd"]], -1)
    assert bool(coeff[:, fig].any())
    assert not bool(coeff[:, [j for j in range(len(specs))
                              if j not in fig]].any())


@pytest.mark.parametrize("name", LENSES)
def test_adjoint_wavefront_rms_matches_jax_grad(name):
    """adjoint_wavefront_rms (K8 forward, K9 backward; their plain
    versions here) on the lens against jax.value_and_grad (jitted) of
    the JAX package's wavefront_rms(specs=, unroll=True), the same rays
    and weights: the value to 1e-9 waves (each ray's OPD is a difference
    of ~1e5-wave paths that the packages round apart by ~1e-10 waves),
    the gradient of every field of SEL to GRAD_REL of the field's
    largest entry -- n_before's and the coefficients' nonzero, the
    latter on the figured rows only -- and, on the singlet, of the rays
    too (the double Gauss's ray gradients would cost the JAX side's
    compile ~40 s more; tests/test_torch_wavefront.py holds them)."""
    js, ts = _systems(name)
    jtab, ttab = js.table(), ts.table(device="cpu")
    jspecs = JK.specialize(jtab)
    specs = TK.specs_from_tuple(jspecs)
    y, u, w = _bundle(name, 96, 4)
    kw = _opd_kw(js)
    rays = name == "odd_singlet"
    p0 = {f: jnp.asarray(getattr(jtab, f)) for f in SEL}
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p, y0, u0: JGR.wavefront_rms(jtab.replace(**p), y0, u0, w,
                                            specs=jspecs, unroll=True, **kw),
        argnums=(0, 1, 2) if rays else 0))(p0, jnp.asarray(y),
                                          jnp.asarray(u))
    leaves = _leaves(ttab, SEL)
    y0, u0 = _t(y).requires_grad_(rays), _t(u).requires_grad_(rays)
    with pytest.warns(UserWarning, match="aspherics"):
        v = CG.adjoint_wavefront_rms(ttab.replace(**leaves), y0, u0, _t(w),
                                     specs=specs, **kw)
    v.backward()
    assert 1. < float(jv) < 1e3
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=0, atol=1e-9)
    got = _grads(leaves)
    if rays:
        jg, jgy, jgu = jg
        _close_grad(y0.grad, jgy, "y0")
        _close_grad(u0.grad, jgu, "u0")
    for f in SEL:
        _close_grad(got[f], jg[f], f)
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    assert bool(got["n_before"].any())
    coeff = torch.cat([got["aspherics"], got["aspherics_odd"]], -1)
    assert bool(coeff[fig].any())
    assert not bool(coeff[[j for j in range(len(specs))
                           if j not in fig]].any())


def test_pallas_kernels_interpret_match_the_plain_versions():
    """The JAX package's own Pallas kernels on the odd singlet at 128
    rays, in interpret mode as its tests run them: the polychromatic
    union spot RMS (pallas_polychromatic_spot_rms, K6's TPU kernel)
    against the port's adjoint engine to RTOL, and the per-ray OPD
    (pallas_opd_rays, K8's) against adjoint_opd_rays to 1e-12 of the
    largest optical path, the landing to RTOL."""
    jt, tt, jspecs, specs = _stacks("odd_singlet")
    y, u, w = _bundle("odd_singlet", 128, 5)
    want = pallas_polychromatic_spot_rms(
        jax.tree_util.tree_map(jnp.asarray, jt), jnp.asarray(y),
        jnp.asarray(u), jnp.asarray(w), specs=jspecs, tile=128,
        interpret=True)
    got = TGL.polychromatic_spot_rms(tt, _t(y), _t(u), _t(w), specs=specs,
                                     engine="adjoint")
    nptest.assert_allclose(float(got), float(want), rtol=RTOL)
    js, ts = _systems("odd_singlet")
    jtab, ttab = js.table(), ts.table(device="cpu")
    kw = _opd_kw(js)
    wj, lj = pallas_opd_rays(jtab, jnp.asarray(y), jnp.asarray(u),
                             with_pupil=True, specs=jspecs, tile=128,
                             interpret=True, **kw)
    wt, lt = CG.adjoint_opd_rays(ttab, _t(y), _t(u), with_pupil=True,
                                 specs=specs, **kw)
    k, _, _ = CG.opd_chain_reference(ttab, specs, _state(y, u),
                                     _aux(ttab, specs, y, u, kw))
    _same(wt, np.asarray(wj), rtol=0, atol=1e-12*float(k.abs().max()))
    _same(lt, np.asarray(lj))


# -- the hand-written reverses -------------------------------------------

@pytest.mark.parametrize("name", LENSES)
def test_figured_step_vjp_with_path_matches_autograd(name):
    """_step_vjp_reference(ct_path=) on the lens's figured row (the
    model of csrc/step_vjp.cuh figured_step_vjp with PATH) against
    autograd of kernels.surface_step_spec's state and optical path, ray
    by ray (every row parameter expanded to one copy a ray): the state,
    the six columns, n_before and the coefficients to GRAD_REL of each
    slot's largest value, with equal NaN masks."""
    _, ts = _systems(name)
    tab = ts.table(device="cpu")
    specs = TK.specialize(tab)
    j = [i for i, s in enumerate(specs) if TK.is_figured(s)][-1]
    n = 96
    y, u, _ = _bundle(name, n, 6)
    # the rays entering row j: through the rows before it
    s = _state(y, u)
    for i in range(1, j):
        s, _ = TK.surface_step_spec(s, tab.row(i), specs[i], False)
    state = [c.detach().clone().requires_grad_() for c in s]
    row = tab.row(j)
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in ("curvature", "conic", "mu", "n_before")}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    coeffs = {f: getattr(row, f).expand(n, -1).clone().requires_grad_()
              for f in ("aspherics", "aspherics_odd")}
    surf = row._replace(offset=offset, **per_ray, **coeffs)
    out, loc = TK.surface_step_spec(tuple(state), surf, specs[j], False)
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert int(live.sum()) > n//2
    rng = np.random.RandomState(7)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    ct = torch.from_numpy(rng.normal(size=n))
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"], per_ray["n_before"], coeffs["aspherics"],
              coeffs["aspherics_odd"]]
    total = (sum((torch.where(live, o, 0.)*gi).sum()
                 for o, gi in zip(out, g))
             + (torch.where(live, loc[3], 0.)*ct).sum())
    want = [torch.zeros_like(v) if w is None else w for v, w in zip(
        leaves, torch.autograd.grad(total, leaves, allow_unused=True))]
    got_state, got_p = CG._step_vjp_reference(
        tuple(c.detach() for c in state), row, specs[j], g, ct_path=ct)
    na, no = row.aspherics.shape[-1], row.aspherics_odd.shape[-1]
    assert len(got_p) == CS.OPD_SLOTS + na + no
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9]),
        (got_p[6], want[10])]
    pairs += [(got_p[7 + i], want[11][:, i]) for i in range(na)]
    pairs += [(got_p[7 + na + i], want[12][:, i]) for i in range(no)]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)[live]
        b = b[live]
        nptest.assert_array_equal(torch.isnan(a).numpy(),
                                  torch.isnan(b).numpy(), "slot %d" % i)
        ok = torch.isfinite(b)
        scale = float(b[ok].abs().max()) if ok.any() else 0.
        nptest.assert_allclose(a[ok].numpy(), b[ok].numpy(), rtol=0,
                               atol=GRAD_REL*max(scale, 1e-300),
                               err_msg="slot %d" % i)


@pytest.mark.parametrize("name", LENSES)
def test_multi_and_opd_adjoints_by_hand_match_plain(name):
    """K7 (_merit_adjoint_multi_by_hand) and K9 (_opd_adjoint_by_hand)
    written in torch against their autograd plain versions on the lens:
    the parameter cotangents -- the coefficient columns nonzero on the
    figured rows only -- to 1e-12 of their largest, the rays' and the
    centre's to GRAD_REL relative."""
    _, tt, _, specs = _stacks(name)
    y, u, w = _bundle(name, 96, 8)
    state = _state(y, u)
    ct = torch.from_numpy(np.random.RandomState(9).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, specs, state, _t(w), ct)
    got = CG._merit_adjoint_multi_by_hand(tt, specs, state, _t(w), ct)
    na, no = CT.figure_widths(tt, specs)
    assert ref[0].shape == (3, len(specs), CS.SLOTS + na + no)
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    assert bool(ref[0][:, fig, CS.SLOTS:].any())
    nptest.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0,
                           atol=1e-12*float(ref[0].abs().max()))
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12)
    js, ts = _systems(name)
    tab = ts.table(device="cpu")
    kw = _opd_kw(js)
    aux = _aux(tab, specs, y, u, kw)
    cts = tuple(torch.from_numpy(v)
                for v in np.random.RandomState(10).normal(size=(3, 96)))
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts)
    assert ref[0].shape == (len(specs), CS.OPD_SLOTS + na + no)
    assert bool(ref[0][fig, CS.OPD_SLOTS:].any()) and bool(ref[0][1:, 6].all())
    others = [j for j in range(len(specs)) if j not in fig]
    assert not bool(ref[0][others, CS.OPD_SLOTS:].any())
    nptest.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0,
                           atol=1e-12*float(ref[0].abs().max()))
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12*float(b.abs().max()))


# -- the keys -------------------------------------------------------------

@pytest.mark.parametrize("name", LENSES)
def test_k9_figured_layout_and_its_row_word_limit(name):
    """A figured K9 key's rows: OPD_SLOTS (the six, then n_before), then
    the even and the odd coefficients, live on the figured rows only
    and never on the image row (the sphere tail reads no figure);
    Key.slots and the translation unit carry the widths.  Its widths
    are refused past LIVE_BITS - OPD_SLOTS coefficients, where K5's and
    K7's (LIVE_BITS - SLOTS) still take them."""
    js, ts = _systems(name)
    tab = ts.table(device="cpu")
    specs = TK.specialize(tab)
    widths = CT.figure_widths(tab, specs)
    na, no = widths
    key = CS.opd_adjoint_key(specs, F64, widths=widths)
    assert key.slots == CS.OPD_SLOTS + na + no and (key.na, key.no) == widths
    live = CS.live_mask(CS.opd_live_slots(specs, CS.OPD_FIELDS, widths),
                        key.slots).numpy()
    fig = [j for j, s in enumerate(specs) if TK.is_figured(s)]
    img = len(specs) - 1
    for j in range(len(specs)):
        assert live[j, CS.OPD_SLOTS:].all() == (j in fig)
        assert live[j, CS.OPD_SLOTS:].any() == (j in fig and j != img)
        assert live[j, 6] == (j > 0)
    # the first OPD_SLOTS columns are the unfigured layout's
    nptest.assert_array_equal(
        live[:, :CS.OPD_SLOTS], CS.live_mask(CS.opd_live_slots(
            specs, CS.OPD_FIELDS), CS.OPD_SLOTS).numpy())
    assert key.nlive == int(live.sum())
    assert "#define RAYOPT_N_ASP %d\n#define RAYOPT_N_ODD %d\n" % widths \
        in CS.translation_unit(key)
    # the coefficients asked for only
    only = CS.live_mask(CS.opd_live_slots(specs, ("n_before", "aspherics"),
                                          widths), key.slots).numpy()
    assert not only[:, :6].any() and only[1:, 6].all()
    assert only[:, 7:7 + na].any() == bool(na) and not only[:, 7 + na:].any()
    # the row word: K9 holds LIVE_BITS - OPD_SLOTS coefficients
    most = CS.LIVE_BITS - CS.OPD_SLOTS
    wide = (most - no, no) if no else (most, 0)
    CS.opd_adjoint_key(specs, F64, widths=wide)
    past = (wide[0] + 1, wide[1])
    with pytest.raises(ValueError, match="row word"):
        CS.opd_adjoint_key(specs, F64, widths=past)
    CS.adjoint_key(specs, F64, widths=past)
    CS.adjoint_multi_key(specs, F64, widths=past)


def test_multi_keys_reckon_the_grown_row(monkeypatch):
    """K3's and K6's keys stage their tables in static shared memory: on
    a long aspheric chain (the double Gauss's rows four times, 49 rows)
    the grown rows lower multi_most below the unfigured chain's, a key
    past it is refused, and the wrappers' runs split a stack past it
    into balanced runs of keys that fit, without raising
    (cuda_spec.load patched: no build)."""
    _, ts = _systems("double_gauss")
    tab = ts.table(device="cpu")
    specs = TK.specialize(tab)
    long = specs[:1] + specs[1:]*4
    widths = CT.figure_widths(tab, specs)
    plain = tuple(s._replace(aspheric=False) for s in long)
    for kernel in ("k3", "k3m", "k6"):
        most = CS.multi_most(kernel, long, F64, widths=widths)
        assert 1 <= most < CS.multi_most(kernel, plain, F64) <= CS.MAX_NLAM
        make = {"k3": lambda n: CS.trace_multi_key(long, F64, n,
                                                   widths=widths),
                "k3m": lambda n: CS.trace_multi_key(long, F64, n, True,
                                                    widths=widths),
                "k6": lambda n: CS.moments_multi_key(long, F64, False, n,
                                                     widths=widths)}[kernel]
        key = make(most)
        assert key.row_words == CT.ROW + sum(widths)
        assert key.shared_bytes <= CS.SMEM_LIMIT
        with pytest.raises(ValueError, match="static shared memory"):
            make(most + 1)
    keys = []

    def load(key):
        keys.append(key)
        return key
    monkeypatch.setattr(CS, "load", load)
    CT._multi_kernel.cache_clear()
    CG._moments_multi_kernel.cache_clear()
    try:
        nlam = 2*CS.multi_most("k6", long, F64, widths=widths) + 1
        runs = {"k3": CT._multi_runs(long, F64, nlam, False, widths),
                "k3m": CT._multi_runs(long, F64, nlam, True, widths),
                "k6": CG._moments_multi_runs(long, F64, False, nlam,
                                             widths)}
    finally:
        CT._multi_kernel.cache_clear()
        CG._moments_multi_kernel.cache_clear()
    for kernel, rs in runs.items():
        sizes = [l1 - l0 for l0, l1, _ in rs]
        assert rs[0][0] == 0 and rs[-1][1] == nlam and len(rs) > 1
        assert max(sizes) - min(sizes) <= 1
        assert max(sizes) <= CS.multi_most(kernel, long, F64, widths=widths)
        assert all(k.kernel == kernel and k.nlam == n and
                   (k.na, k.no) == widths for (_, _, k), n in zip(rs, sizes))


def test_wrappers_warn_about_baked_coefficients():
    """The polychromatic and the wavefront adjoint merits warn, as K5's
    does, when the aspheric coefficients are differentiated on rows
    whose specs carry no figure (their gradient there is structurally
    zero), naming those rows."""
    jt, tt, _, specs = _stacks("double_gauss")
    y, u, w = _bundle("double_gauss", 16, 11)
    rows = [j for j, s in enumerate(specs) if j and not TK.is_figured(s)]
    asp = tt.aspherics.clone().requires_grad_()
    with pytest.warns(UserWarning, match=r"'aspherics' of surface row\(s\) "
                      + str(rows).replace("[", r"\[").replace("]", r"\]")):
        TGL.polychromatic_spot_rms(tt.replace(aspherics=asp), _t(y), _t(u),
                                   _t(w), specs=specs, engine="adjoint")
    js, ts = _systems("double_gauss")
    tab = ts.table(device="cpu")
    asp = tab.aspherics.clone().requires_grad_()
    with pytest.warns(UserWarning, match="'aspherics' of surface row"):
        CG.adjoint_wavefront_rms(tab.replace(aspherics=asp), _t(y), _t(u),
                                 _t(w), specs=specs, **_opd_kw(js))
