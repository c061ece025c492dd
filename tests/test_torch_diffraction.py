"""rayopt_tpu_torch.parallel.diffraction against the JAX package's, in
float64 on the CPU: Strehl (exact and Marechal), the gridded pupil
function, the PSF (one wavelength and polychromatic) and the MTF at
ngrid 32 on the Cooke triplet, through both OPD engines ("xla":
autograd through the plain trace; "adjoint": the plain versions of the
OPD kernels K8/K9 on a CPU bundle), and their gradients against
jax.grad.  Tolerance: rtol 1e-9 (atol 1e-12 of each output's largest
value) unless a test says otherwise."""

import functools
import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import models as jmodels
from rayopt_tpu.parallel import diffraction as JD

from rayopt_tpu_torch import GeometricTrace, set_default_device
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import bundles_from_system
from rayopt_tpu_torch.parallel import diffraction as TD

NGRID = 32
ENGINES = ("xla", "adjoint")


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


def _close(got, want, err_msg="", rtol=1e-9, atol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if atol is None:
        atol = 1e-12*max(float(np.abs(want).max()), 1.)
    nptest.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _setup(field=.7):
    """The Cooke triplet: the JAX table, one hexapolar bundle from the
    port's GeometricTrace (pupil weights, chief ray first) and the OPD
    keywords."""
    ts = tmodels.cooke_triplet()
    g = GeometricTrace(ts)
    g.rays_point((0, field), nrays=60, distribution="hexapolar",
                 filter=False)
    tab = jmodels.cooke_triplet().table(g.l)
    kw = dict(ref=g.ref, radius=-ts.image.pupil.distance, scale=ts.scale,
              finite=ts.object.finite)
    return tab, (g.y[0], g.u[0], g.w), g.l, kw


def _port(tab, rays):
    return (TT.table_from_numpy(tab),
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in rays))


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # specialized rows bake out
        return fn(*args, **kw)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("remove_tilt", [True, False])
def test_strehl_ratio_matches_jax(engine, remove_tilt):
    tab, rays, l, kw = _setup()
    want = JD.strehl_ratio(tab, *rays, remove_tilt=remove_tilt,
                           wavelength=l, **kw)
    got = _quiet(TD.strehl_ratio, *_port(tab, rays), remove_tilt=remove_tilt,
                 wavelength=l, engine=engine, **kw)
    assert 0 < float(want) < 1
    _close(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_strehl_marechal_matches_jax(engine):
    tab, rays, l, kw = _setup()
    want = JD.strehl_marechal(tab, *rays, wavelength=l, **kw)
    got = _quiet(TD.strehl_marechal, *_port(tab, rays), wavelength=l,
                 engine=engine, **kw)
    _close(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_pupil_grid_matches_jax(engine):
    """The lit cells and the cell size exactly (rtol 1e-9); the unit
    phasors rtol 1e-9 with atol 1e-9: a phasor cos(2 pi W) moves by
    2 pi dW, and the two packages' OPDs differ by ~2e-11 waves."""
    tab, rays, l, kw = _setup()
    grid_j, dx_j = JD.pupil_grid(tab, *rays, ngrid=NGRID, wavelength=l,
                                 **kw)
    grid_t, dx_t = _quiet(TD.pupil_grid, *_port(tab, rays), ngrid=NGRID,
                          wavelength=l, engine=engine, **kw)
    assert grid_t.shape == (NGRID, NGRID) and grid_t.is_complex()
    lit = np.asarray(grid_j) != 0
    assert lit.sum() > 100
    nptest.assert_array_equal(grid_t.detach().numpy() != 0, lit)
    _close(grid_t.real, np.asarray(grid_j).real, "real", atol=1e-9)
    _close(grid_t.imag, np.asarray(grid_j).imag, "imag", atol=1e-9)
    _close(dx_t, dx_j)


@pytest.mark.parametrize("engine", ENGINES)
def test_psf_grid_and_mtf_match_jax(engine):
    """psf_grid's axes and normalized PSF (sum 1), and mtf_radial
    (MTF(0) = 1)."""
    tab, rays, l, kw = _setup()
    for got, want in zip(
            _quiet(TD.psf_grid, *_port(tab, rays), ngrid=NGRID, pad=2,
                   wavelength=l, engine=engine, **kw),
            JD.psf_grid(tab, *rays, ngrid=NGRID, pad=2, wavelength=l, **kw)):
        assert got.shape == (2*NGRID, 2*NGRID)
        _close(got, want)
    psf = _quiet(TD.psf_grid, *_port(tab, rays), ngrid=NGRID, wavelength=l,
                 engine=engine, **kw)[2]
    _close(psf.sum(), 1., rtol=1e-12)
    got = _quiet(TD.mtf_radial, *_port(tab, rays), ngrid=NGRID, pad=2,
                 wavelength=l, engine=engine, **kw)
    want = JD.mtf_radial(tab, *rays, ngrid=NGRID, pad=2, wavelength=l, **kw)
    nptest.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        _close(a, b)
        assert float(a[0]) == 1.


@pytest.mark.parametrize("engine", ENGINES)
def test_psf_polychromatic_matches_jax(engine):
    """Three wavelengths on axis through the port's bundles_from_system
    (carried to the JAX package as numpy): the summed PSF and its axes."""
    ts = tmodels.cooke_triplet()
    bundles = bundles_from_system(ts, fields=(0.,), nrays=24,
                                  distribution="hexapolar")
    jb = [(b[0].numpy(), b[1].numpy(), b[2].numpy(),
           {k: (v if k == "wavelength" else v.numpy())
            for k, v in b[3].items()}) for b in bundles]
    tab = jmodels.cooke_triplet().table()
    kw = dict(radius=-ts.image.pupil.distance, scale=ts.scale,
              finite=ts.object.finite, ngrid=NGRID)
    want = JD.psf_polychromatic(tab, jb, **kw)
    got = _quiet(TD.psf_polychromatic, TT.table_from_numpy(tab), bundles,
                 engine=engine, **kw)
    for a, b in zip(got, want):
        _close(a, b)
    _close(got[2].sum(), 1., rtol=1e-12)


def test_strehl_gradient_matches_jax_grad():
    """d Strehl / d (curvature, rays) against jax.grad of the JAX
    package's strehl_ratio (its XLA engine, generic rows): the port's
    "xla" engine on every row; the "adjoint" engine (K9's plain version,
    the specialized semantics) on the rows its specs read -- the flat
    image row's curvature is baked out there.  rtol 1e-6 with a floor
    of 1e-9 of the largest value."""
    tab, rays, l, kw = _setup()
    gc, gy = jax.grad(lambda c, y: JD.strehl_ratio(
        tab.replace(curvature=c), y, rays[1], rays[2], wavelength=l, **kw),
        argnums=(0, 1))(jnp.asarray(tab.curvature), jnp.asarray(rays[0]))
    gc, gy = np.asarray(gc), np.asarray(gy)
    specs = TK.specialize(TT.table_from_numpy(tab))
    read = [j for j, sp in enumerate(specs) if j and not sp.flat]
    for engine in ENGINES:
        tt, y0, u0, w = _port(tab, rays)
        c = tt.curvature.clone().requires_grad_()
        y0.requires_grad_()
        _quiet(TD.strehl_ratio, tt.replace(curvature=c), y0, u0, w,
               wavelength=l, engine=engine, **kw).backward()
        rows = slice(None) if engine == "xla" else read
        for got, want, name in ((c.grad[rows], gc[rows], "curvature"),
                                (y0.grad, gy, "y0")):
            nptest.assert_allclose(
                got.numpy(), want, rtol=1e-6,
                atol=1e-9*float(np.abs(want).max()),
                err_msg="%s %s" % (engine, name))


def test_psf_peak_gradient_matches_jax_grad():
    """The gradient of the PSF's peak through the pupil-grid scatter
    and the FFT w.r.t. curvature, "xla" engines of both packages: rtol
    1e-6 with a floor of 1e-9 of the largest value."""
    tab, rays, l, kw = _setup()

    def jpeak(c):
        return JD.psf_grid(tab.replace(curvature=c), *rays, ngrid=NGRID,
                           wavelength=l, **kw)[2][0, 0]
    want = np.asarray(jax.grad(jpeak)(jnp.asarray(tab.curvature)))
    tt, y0, u0, w = _port(tab, rays)
    c = tt.curvature.clone().requires_grad_()
    TD.psf_grid(tt.replace(curvature=c), y0, u0, w, ngrid=NGRID,
                wavelength=l, **kw)[2][0, 0].backward()
    assert float(np.abs(want).max()) > 0
    nptest.assert_allclose(c.grad.numpy(), want, rtol=1e-6,
                           atol=1e-9*float(np.abs(want).max()))
