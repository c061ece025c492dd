"""rayopt_tpu_torch's batched pupil aiming (ops.aiming, System.pupils,
bundles_from_system(device_aim=True)) against the JAX package's, in
float64 on the CPU: the chief-ray Newton, the four marginal bisections
in stop and rim mode, the full pupil solve with its residuals, on the
Cooke triplet, the double Gauss, a finite conjugate and a wide-angle
projection.

Both sides run the same fixed-trip-count solvers on the same merits, so
the solved pupil distances and scales agree to 1e-9 relative: the
Newton converges far below that, and a bisection halves the same
bracket the same way unless a merit at a midpoint lies within the two
traces' rounding of zero, where one side's last steps may differ (by
the bracket width then, ~1e-12 of the scale).  The card's solve is
held against the CPU's in tests/test_torch_cuda.py."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import aiming as JA
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops import aiming as TA
from rayopt_tpu_torch.ops.kernels import specialize, specs_from_tuple
from rayopt_tpu_torch.parallel import grad as TGR

REL = 1e-9       # solved distances and scales
RESID = 1e-12    # chief residuals (both ~1e-16)
COOKE_FIELDS = (0., .3, .7, 1.)
DIRECTIONS = ((0., 1.), (0., -1.), (1., 0.), (-1., 0.))


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _pair(name, projection=None, aim=None):
    js, ts = getattr(jmodels, name)(), getattr(tmodels, name)()
    for s in (js, ts):
        if projection:
            s.object.projection = projection
        if aim is not None:
            s.object.pupil.aim = aim
        s.update()
        s._pupil_cache.clear()
    return js, ts


def _meridional(fields):
    f = np.asarray(fields, float)
    return np.stack([np.zeros_like(f), f], 1)


def _kw(s):
    """The conjugate's keywords, as System.pupils passes them."""
    kw = dict(finite=bool(s.object.finite), projection=s.object.projection)
    if s.object.finite:
        kw["radius"] = s.object.radius
    else:
        kw["slope"] = np.tan(s.object.angle)
    return kw


def _close(got, want, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    nptest.assert_allclose(got, want, rtol=rel,
                           atol=rel*max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name,fields", [("cooke_triplet", COOKE_FIELDS),
                                         ("double_gauss", (.5, 1.))])
def test_chief_matches_jax(name, fields):
    """aim_chief_batched: 12 Newton steps, derivative by autograd (the
    JAX package's jax.grad, vmapped), the same z and residuals."""
    js, ts = _pair(name)
    jt, tt = js.table(), ts.table()
    f = _meridional(fields)
    zj, rj = JA.aim_chief_batched(jt, f, js.object.pupil.distance, js.stop,
                                  specs=jspecialize(jt), with_residual=True,
                                  **_kw(js))
    zt, rt = TA.aim_chief_batched(tt, f, ts.object.pupil.distance, ts.stop,
                                  specs=specialize(tt), with_residual=True,
                                  **_kw(ts))
    assert zt.shape == (len(fields),) and zt.dtype == torch.float64
    _close(zt, zj)
    assert float(rt.max()) < RESID and float(np.max(rj)) < RESID
    # the generic trace (no specs) solves the same chief rays
    _close(TA.aim_chief_batched(tt, f, ts.object.pupil.distance, ts.stop,
                                **_kw(ts)), zj)


@pytest.mark.parametrize("rim", [False, True])
def test_marginal_matches_jax_in_every_direction(rim):
    """aim_marginal_batched on the Cooke triplet, each of the four
    directions, stop and rim mode: 30 grow and 40 bisection steps, the
    same scales and bracket widths."""
    js, ts = _pair("cooke_triplet")
    jt, tt = js.table(), ts.table()
    f = _meridional((0., .7, 1.))
    jspecs, tspecs = jspecialize(jt), specialize(tt)
    z = np.array(JA.aim_chief_batched(jt, f, js.object.pupil.distance,
                                      js.stop, specs=jspecs, **_kw(js)))
    p0 = js.object.pupil.radius
    for direction in DIRECTIONS:
        aj, wj = JA.aim_marginal_batched(
            jt, f, z, p0, js.stop, specs=jspecs, direction=direction,
            rim=rim, with_residual=True, **_kw(js))
        at, wt = TA.aim_marginal_batched(
            tt, f, z, p0, ts.stop, specs=tspecs, direction=direction,
            rim=rim, with_residual=True, **_kw(ts))
        _close(at, aj)
        assert float(wt.max()) < 1e-9
        _close(wt, wj, 1e-3)


@pytest.mark.parametrize("case", ["cooke", "finite", "stereographic"])
def test_pupil_batched_matches_jax(case):
    """pupil_batched with its residuals: the Cooke triplet at four
    fields, a finite conjugate (the doublet, aimed) at field points off
    the meridian too, and a wide-angle (stereographic) projection."""
    if case == "cooke":
        js, ts = _pair("cooke_triplet")
        f = _meridional(COOKE_FIELDS)
    elif case == "finite":
        js, ts = _pair("doublet", aim=True)
        f = np.array([(0., 0.), (0., .5), (0., 1.), (.6, .3)])
    else:
        js, ts = _pair("cooke_triplet", projection="stereographic")
        f = _meridional((.5, 1.))
    assert bool(ts.object.finite) == (case == "finite")
    jt, tt = js.table(), ts.table()
    args = (js.object.pupil.distance, js.object.pupil.radius, js.stop)
    zj, bj, (cj, wj) = JA.pupil_batched(jt, f, *args, specs=jspecialize(jt),
                                        with_residuals=True, **_kw(js))
    zt, bt, (ct, wt) = TA.pupil_batched(tt, f, *args, specs=specialize(tt),
                                        with_residuals=True, **_kw(ts))
    assert zt.shape == (len(f),) and bt.shape == (len(f), 2, 2)
    _close(zt, zj)
    _close(bt, bj)
    assert float(ct.max()) < RESID and float(wt.max()) < 1e-9
    _close(wt, wj, 1e-3)


def test_pupils_matches_jax_with_chief_only_and_the_host_fallback():
    """System.pupils: the batched solve, chief_only (the pupil radius for
    the boxes) and a field forced past its tolerance (tol=0: the warning
    and the host pupil's result there), each against the JAX package's
    System.pupils."""
    js, ts = _pair("cooke_triplet")
    f = _meridional((0., .7, 1.))
    for kw in ({}, {"chief_only": True}):
        zj, bj = js.pupils(f, **kw)
        zt, bt = ts.pupils(f, **kw)
        assert isinstance(zt, np.ndarray) and bt.shape == (3, 2, 2)
        _close(zt, zj)
        _close(bt, bj)
    one = _meridional((.7,))
    with pytest.warns(UserWarning, match="did not converge for 1/1 fields"):
        zj, bj = js.pupils(one, tol=0.)
    with pytest.warns(UserWarning, match="did not converge for 1/1 fields; "
                      "using the host solver there"):
        zt, bt = ts.pupils(one, tol=0.)
    zh, bh = ts.pupil((0., .7))
    assert zt[0] == zh and np.array_equal(bt[0], bh)
    _close(zt, zj, 1e-10)
    _close(bt, bj, 1e-10)


def test_pupils_of_an_unaimed_pupil_take_the_host_path():
    """An unaimed pupil is not eligible: no warning, the host pupil."""
    _, ts = _pair("doublet")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        z, boxes = ts.pupils([(0., 1.)])
    zh, bh = ts.pupil((0., 1.))
    assert z[0] == zh and np.array_equal(boxes[0], bh)


def test_bundles_device_aim_matches_jax_and_host():
    """bundles_from_system(device_aim=True) against the JAX package's
    (the same seeds to 1e-9 of their scale) and against the port's host
    aiming (to the host solver's tolerance, as the JAX package's
    tests/test_optimize.py holds its own)."""
    js, ts = _pair("cooke_triplet")
    kw = dict(fields=[0., .7, 1.], wavelengths=js.wavelengths[:1],
              nrays=16)
    jd = JGR.bundles_from_system(js, device_aim=True, **kw)
    td = TGR.bundles_from_system(ts, device_aim=True, **kw)
    th = TGR.bundles_from_system(ts, **kw)
    assert len(td) == len(jd) == len(th) == 3
    for (yj, uj, wj, cj), (yd, ud, wd, cd), (yh, uh, wh, ch) in zip(
            jd, td, th):
        _close(yd, yj)
        _close(ud, uj)
        assert torch.equal(wd, wh) and cd["wavelength"] == cj["wavelength"]
        nptest.assert_allclose(yd.numpy(), yh.numpy(), rtol=2e-2, atol=2e-2)
        nptest.assert_allclose(ud.numpy(), uh.numpy(), rtol=2e-2, atol=1e-3)


def test_rim_mode_refuses_the_extended_vocabulary():
    """Rim mode traces every row with the general trace, which traces
    the whole extended vocabulary now: a freeform flag on a row (the
    freeform rows are ported, ROADMAP Queue 1 item 9.5; the JAX package's
    rim mode on a freeform lens is tests/test_torch_freeform.py's, its
    test_rim_aiming_sees_extended_vocabulary tests/test_torch_grating.py's)
    refuses nothing: the cooke triplet's rim-mode margins and pupils
    with the flag equal those without to 1e-13 (its xy_poly column is
    empty; the flagged row's stop-mode step refracts by the general
    form, refract_freeform, rather than the spherical one)."""
    _, ts = _pair("cooke_triplet")
    tt = ts.table()
    specs = list(specialize(tt))
    flagged = list(specs)
    flagged[2] = specs[2]._replace(freeform=True)
    f = _meridional((1.,))
    a = [TA.aim_marginal_batched(tt, f, ts.object.pupil.distance,
                                 ts.object.pupil.radius, ts.stop,
                                 specs=tuple(sp), rim=True, **_kw(ts))
         for sp in (specs, flagged)]
    nptest.assert_allclose(a[1].numpy(), a[0].numpy(), rtol=1e-13)
    z = [TA.pupil_batched(tt, f, ts.object.pupil.distance,
                          ts.object.pupil.radius, ts.stop,
                          specs=specs_from_tuple(sp), rim=True, **_kw(ts))
         for sp in (specs, flagged)]
    for got, want in zip(z[1], z[0]):
        nptest.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-13, atol=1e-13)
