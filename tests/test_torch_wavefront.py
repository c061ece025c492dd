"""rayopt_tpu_torch's exit-pupil wavefront plane against the JAX
package, in float64 on the CPU: the per-ray OPD of parallel.grad
(opd_rays, the plain-trace engine) and of the host GeometricTrace.opd,
the plain version of the OPD kernel K8 against the Pallas kernel it
replaces (interpret mode), adjoint_wavefront_rms (K8 forward, K9
backward, their plain versions on the CPU) against jax.grad of the
JAX package's specialized XLA engine, and the hand-derived K9 reverse
against torch autograd.  Each test states its tolerance.  The kernels
themselves run only on a CUDA card (tests/test_torch_cuda.py)."""

import functools
import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import rayopt_tpu as J
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.pallas_grad import pallas_opd_rays
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as T
from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.geometric import trace_rays_final
from rayopt_tpu_torch.parallel import diffraction as TD
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_trace import BRANCHES

WAVES_ATOL = 1e-9      # OPD, waves
LANDING_ATOL = 1e-12   # landing coordinates on the sphere, mm
GRAD_RTOL = 1e-6       # gradients against jax.grad
SEL = ("curvature", "conic", "offset", "mu", "n_before")


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


def _close(got, want, err_msg="", rtol=1e-9, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    nptest.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                           err_msg=err_msg)


def _close_grad(got, want, name):
    """rtol GRAD_RTOL, with a floor of 1e-9 of the field's largest
    value for entries that cancel to near zero."""
    want = np.asarray(want)
    _close(got, want, name, rtol=GRAD_RTOL,
           atol=1e-9*max(float(np.abs(want).max()), 1e-300))


def _tilt(s):
    """The tilted exit and image surfaces of tests/test_wavefront.py."""
    s[-1].angles = (.05, .02, 0.)
    s[-2].angles = (.03, 0., 0.)
    return s


CASES = {"field 0": (0., False), "field .7": (.7, False),
         "tilted ends": (.5, True)}


@functools.lru_cache(maxsize=None)
def _traces(case, nrays=50):
    """The Cooke triplet (tilted ends for that case) and one hexapolar
    GeometricTrace of each package at the case's field (built once: the
    JAX package compiles a trace for each geometry; no test changes
    them)."""
    field, tilted = CASES[case]
    out = []
    for pkg, models in ((J, jmodels), (T, tmodels)):
        s = models.cooke_triplet()
        if tilted:
            _tilt(s)
        g = pkg.GeometricTrace(s)
        g.rays_point((0, field), nrays=nrays, distribution="hexapolar",
                     filter=False)
        out.append((s, g))
    return out


def _opd_kw(s, g):
    return dict(ref=g.ref, radius=-s.image.pupil.distance, wavelength=g.l,
                scale=s.scale, finite=s.object.finite)


@pytest.mark.parametrize("case", sorted(CASES))
def test_opd_rays_match_jax(case):
    """opd_rays (with the landing) against the JAX package's, on the
    same rays: WAVES_ATOL waves, LANDING_ATOL mm; the specialized
    engine too."""
    (js, jg), _ = _traces(case)
    tab = js.table(jg.l)
    kw = _opd_kw(js, jg)
    tt = TT.table_from_numpy(tab)
    y0, u0 = jg.y[0], jg.u[0]
    for specs in (None, jspecialize(tab)):
        wj, lj = JGR.opd_rays(tab, jnp.asarray(y0), jnp.asarray(u0),
                              with_pupil=True, specs=specs,
                              unroll=specs is not None, **kw)
        wt, lt = TGR.opd_rays(tt, torch.from_numpy(y0), torch.from_numpy(u0),
                              with_pupil=True,
                              specs=specs and TK.specs_from_tuple(specs),
                              **kw)
        good = np.isfinite(np.asarray(wj))
        assert good.sum() > 10
        nptest.assert_array_equal(np.isfinite(wt.numpy()), good)
        _close(wt[good], np.asarray(wj)[good], "waves", rtol=0,
               atol=WAVES_ATOL)
        _close(lt[good], np.asarray(lj)[good], "landing", rtol=0,
               atol=LANDING_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_opd_matches_jax_and_opd_rays(case):
    """GeometricTrace.opd(resample=0) against the JAX package's host OPD
    (the same seeds to 1e-14) and against the port's opd_rays on its
    own rays: WAVES_ATOL waves, LANDING_ATOL mm."""
    (js, jg), (ts, tg) = _traces(case)
    nptest.assert_allclose(tg.y[0], jg.y[0], rtol=0, atol=1e-14)
    jx, jy, jw = jg.opd(resample=0)
    tx, ty, tw = tg.opd(resample=0)
    good = np.isfinite(jw)
    nptest.assert_array_equal(np.isfinite(tw), good)
    for a, b, tol in ((tw, jw, WAVES_ATOL), (tx, jx, LANDING_ATOL),
                      (ty, jy, LANDING_ATOL)):
        _close(a[good], b[good], rtol=0, atol=tol)
    w2, l2 = TGR.opd_rays(ts.table(tg.l, device="cpu"),
                          torch.from_numpy(tg.y[0]),
                          torch.from_numpy(tg.u[0]), with_pupil=True,
                          **_opd_kw(ts, tg))
    _close(w2[good], tw[good], rtol=0, atol=WAVES_ATOL)
    _close(l2[good, 0], tx[good], rtol=0, atol=LANDING_ATOL)
    _close(l2[good, 1], ty[good], rtol=0, atol=LANDING_ATOL)


def test_host_psf_and_zernike_match_jax():
    """GeometricTrace.psf and .zernike against the JAX package's on the
    same rays: PSF rtol 1e-9 (scipy's griddata on both sides),
    coefficients and residual atol 1e-9 waves."""
    (_, jg), (_, tg) = _traces("field .7", nrays=200)
    for a, b in zip(tg.psf(resample=2, pad=2), jg.psf(resample=2, pad=2)):
        _close(a, b, atol=1e-12*float(np.abs(b).max()))
    (cj, rj), (ct, rt) = jg.zernike(nterms=11), tg.zernike(nterms=11)
    _close(ct, cj, rtol=0, atol=1e-9)
    _close(rt, rj, rtol=0, atol=1e-9)


def test_opd_kernel_plain_version_matches_pallas():
    """K8's plain version (adjoint_opd_rays on a CPU bundle) against
    pallas_opd_rays(with_pupil=True, interpret=True), 128 rays of the
    Cooke at field .7: WAVES_ATOL waves, LANDING_ATOL mm."""
    (js, jg), _ = _traces("field .7", nrays=200)
    tab = js.table(jg.l)
    specs = jspecialize(tab)
    kw = _opd_kw(js, jg)
    y0, u0 = jg.y[0][:128], jg.u[0][:128]
    wj, lj = pallas_opd_rays(tab, jnp.asarray(y0), jnp.asarray(u0),
                             with_pupil=True, specs=specs, tile=128,
                             interpret=True, **kw)
    before = CG.opd_chain.launches
    wt, lt = CG.adjoint_opd_rays(TT.table_from_numpy(tab),
                                 torch.from_numpy(y0), torch.from_numpy(u0),
                                 with_pupil=True,
                                 specs=TK.specs_from_tuple(specs), **kw)
    assert CG.opd_chain.launches == before
    good = np.isfinite(np.asarray(wj))
    assert good.sum() > 100
    nptest.assert_array_equal(np.isfinite(wt.detach().numpy()), good)
    _close(wt[good], np.asarray(wj)[good], rtol=0, atol=WAVES_ATOL)
    _close(lt[good], np.asarray(lj)[good], rtol=0, atol=LANDING_ATOL)


def test_adjoint_wavefront_rms_matches_jax_grad():
    """adjoint_wavefront_rms (plain K8/K9 on the CPU) against jax.grad
    of the JAX package's wavefront_rms(specs=, unroll=True) on the
    doublet with tilted exit and image surfaces, defocused by 1 mm (a
    wavefront of about a wave), at field .5 (the JAX side runs the
    Cooke's unrolled gradient ~10x slower on the CPU), 128 rays (the
    hexapolar bundle padded at zero weight).  Gradients w.r.t.
    curvature, conic, offset, mu, n_before and the rays: rtol
    GRAD_RTOL.  Value: WAVES_ATOL, the per-ray OPD tolerance -- each
    OPD is a difference of ~1e5-wave optical paths, which the two
    packages round differently by ~2e-10 waves (against the Pallas
    kernel's own formula too), so rtol 1e-10 holds only for wavefronts
    of several waves."""
    js = _tilt(jmodels.doublet())
    js[-1].distance += 1.
    js.update()
    jg = J.GeometricTrace(js)
    jg.rays_point((0, .5), nrays=50, distribution="hexapolar", filter=False)
    n = len(jg.y[0])
    assert n <= 128
    y0 = np.concatenate([jg.y[0], np.repeat(jg.y[0][:1], 128 - n, 0)])
    u0 = np.concatenate([jg.u[0], np.repeat(jg.u[0][:1], 128 - n, 0)])
    w = np.concatenate([np.full(n, 1./n), np.zeros(128 - n)])
    tab = js.table(jg.l)
    specs = jspecialize(tab)
    kw = dict(_opd_kw(js, jg), w=w)
    p0 = {k: jnp.asarray(getattr(tab, k)) for k in SEL}
    vj, (gp, gy, gu) = jax.value_and_grad(
        lambda p, y, u: JGR.wavefront_rms(tab.replace(**p), y, u,
                                          specs=specs, unroll=True, **kw),
        argnums=(0, 1, 2))(p0, jnp.asarray(y0), jnp.asarray(u0))
    got = _wavefront_grads(CG.adjoint_wavefront_rms, TT.table_from_numpy(tab),
                           (y0, u0), TK.specs_from_tuple(specs),
                           dict(kw, w=torch.from_numpy(w)))
    assert .5 < float(vj) < 2
    _close(got[0], vj, rtol=0, atol=WAVES_ATOL)
    for k in SEL:
        _close_grad(got[1][k], gp[k], k)
    assert float(got[1]["n_before"].abs().max()) > 0
    _close_grad(got[2], gy, "y0")
    _close_grad(got[3], gu, "u0")


def _wavefront_grads(engine, tab, rays, specs, kw):
    """(value, {field: gradient}, y0 gradient, u0 gradient) of one
    wavefront-RMS engine at the rays (y0, u0)."""
    leaves = {k: getattr(tab, k).clone().requires_grad_() for k in SEL}
    y0, u0 = (torch.from_numpy(a).requires_grad_() for a in rays)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # conic/offset rows bake out
        v = engine(tab.replace(**leaves), y0, u0, specs=specs, **kw)
    v.backward()
    # a field the specialized trace never reads gets None (JAX: zeros)
    return (v.detach(), {k: torch.zeros_like(v) if v.grad is None
                         else v.grad for k, v in leaves.items()},
            y0.grad, u0.grad)


@pytest.mark.parametrize("case", ["field 0", "field .7"])
def test_adjoint_wavefront_rms_matches_xla_engine(case):
    """adjoint_wavefront_rms (plain K8/K9) against the port's own
    wavefront_rms (autograd through the plain trace's history) with the
    same specs: value WAVES_ATOL, gradients rtol GRAD_RTOL."""
    _, (ts, tg) = _traces(case)
    tab = ts.table(tg.l, device="cpu")
    specs = TK.specialize(tab)
    kw = _opd_kw(ts, tg)
    rays = (tg.y[0], tg.u[0])
    want = _wavefront_grads(TGR.wavefront_rms, tab, rays, specs, kw)
    got = _wavefront_grads(CG.adjoint_wavefront_rms, tab, rays, specs, kw)
    _close(got[0], want[0], rtol=0, atol=WAVES_ATOL)
    for k in SEL:
        _close_grad(got[1][k], want[1][k], k)
    _close_grad(got[2], want[2], "y0")
    _close_grad(got[3], want[3], "u0")


def _dead_bundle(s, n=96, seed=5):
    """Collimated-ish rays over the Cooke's entrance pupil, a quarter of
    them pushed far off the aperture (clip=True vignettes them); ray 0
    is the chief."""
    rng = np.random.RandomState(seed)
    r = s.object.pupil.radius
    y = np.zeros((n, 3))
    y[1:, :2] = rng.uniform(-.9, .9, (n - 1, 2))*r
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.02, .02, (n, 2))
    u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    y[-n//4:, 1] += 20*r
    return y, u


@pytest.mark.parametrize("pose", [False, True])
@pytest.mark.parametrize("tilted", [False, True])
def test_opd_adjoint_by_hand_matches_autograd(tilted, pose):
    """_opd_adjoint_by_hand (the model of csrc/grad_spec.cuh
    opd_adjoint_spec) against opd_adjoint_reference (autograd through
    the plain chain and tail): seeded cotangents on k AND the landing,
    a quarter of the rays vignetted (clip); with `pose` every row keeps
    its rotated/off_axis branches (kernels.with_pose); rtol 1e-9 with a
    floor of 1e-9 of each kind's largest value."""
    s = tmodels.cooke_triplet()
    if tilted:
        _tilt(s)
    tab = s.table(device="cpu")
    specs = TK.specialize(tab)
    if pose:
        specs = TK.with_pose(specs)
    y, u = _dead_bundle(s)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c))
                  for c in (*y.T, *u.T))
    yr, _, _ = trace_rays_final(tab, torch.from_numpy(y[:1]),
                                torch.from_numpy(u[:1]), specs=specs)
    aux = torch.cat([yr[0], torch.tensor([-s.image.pupil.distance,
                                          s.wavelengths[0]/s.scale])])
    rng = np.random.RandomState(2)
    cts = tuple(torch.from_numpy(rng.normal(size=len(y))) for _ in range(3))
    k, lx, ly = CG.opd_chain_reference(tab, specs, state, aux, clip=True)
    live = torch.isfinite(k)
    assert 0 < int(live.sum()) < len(y)
    want = CG.opd_adjoint_reference(tab, specs, state, aux, cts, clip=True)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts, clip=True)
    assert not any(bool(c[~live].any()) for c in got[1])
    for a, b, name in ((got[0], want[0], "parameters"),
                       (torch.stack(got[1][:3]), torch.stack(want[1][:3]),
                        "positions"),
                       (torch.stack(got[1][3:]), torch.stack(want[1][3:]),
                        "directions"),
                       (got[2], want[2], "centre")):
        assert float(b.abs().max()) > 0, name
        _close(a, b, name, atol=1e-9*float(b.abs().max()))
    # the wrapper takes the plain version on the CPU: no launch
    before = CG.opd_adjoint.launches
    for a, b in zip(CG.opd_adjoint(tab, specs, state, aux, cts, clip=True),
                    want):
        for g, r in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            _close(g, r)
    assert CG.opd_adjoint.launches == before


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_step_vjp_with_path_matches_autograd(name):
    """_step_vjp_reference(ct_path=) -- the PATH instantiation of
    surface_step_vjp that K9 runs -- against autograd of
    kernels.surface_step_spec with a cotangent on the row's optical path
    t * n_before as well as its state, ray by ray; n_before's per-ray
    cotangent included.  rtol 1e-9 with a floor of 1e-9 of the slot's
    largest value."""
    tt = TT.make_table(**BRANCHES[name])
    spec = TK.specialize(tt)[1]
    rng = np.random.RandomState(12)
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
               for f in ("curvature", "conic", "mu", "n_before")}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    surf = row._replace(offset=offset, **per_ray)
    out, loc = TK.surface_step_spec(tuple(state), surf, spec, False)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    ct_path = torch.from_numpy(rng.normal(size=n))
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert live.any()
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"], per_ray["n_before"]]
    total = sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g))
    total = total + (torch.where(live, loc[3], 0.)*ct_path).sum()
    want = torch.autograd.grad(total, leaves, allow_unused=True)
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, want)]
    got_state, got_p = CG._step_vjp_reference(
        tuple(s.detach() for s in state), row, spec, g, ct_path=ct_path)
    assert len(got_p) == CG.OPD_SLOTS
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9]),
        (got_p[6], want[10])]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)
        _close(a[live], b[live], "slot %d" % i,
               atol=max(1e-12, 1e-9*float(b[live].abs().max())))


def test_adjoint_strehl_gradient_matches_xla():
    """strehl_ratio(engine="adjoint") -- K9 with non-zero landing
    cotangents through the tilt removal -- against engine="xla" (autograd
    through the plain trace) on the Cooke at field .7: value rtol
    1e-9, curvature and ray gradients rtol GRAD_RTOL."""
    s = tmodels.cooke_triplet()
    g = T.GeometricTrace(s)
    g.rays_point((0, .7), nrays=50, distribution="hexapolar", filter=False)
    tab = s.table(g.l, device="cpu")
    specs = TK.specialize(tab)
    kw = dict(_opd_kw(s, g), specs=specs)
    out = {}
    for engine in ("xla", "adjoint"):
        c = tab.curvature.clone().requires_grad_()
        y0 = torch.from_numpy(g.y[0]).requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            v = TD.strehl_ratio(tab.replace(curvature=c), y0,
                                torch.from_numpy(g.u[0]), engine=engine,
                                **kw)
        v.backward()
        out[engine] = (v, c.grad, y0.grad)
    (v1, c1, y1), (v2, c2, y2) = out["xla"], out["adjoint"]
    assert 0 < float(v1.detach()) < 1
    _close(v2, v1.detach(), rtol=1e-9)
    _close_grad(c2, c1, "curvature")
    _close_grad(y2, y1, "y0")

