"""The whole forward slice of rayopt_tpu_torch against the JAX
package: YAML -> System -> pupil/aim -> trace_rays_final_fast -> spot
RMS, on the Cooke triplet and the double Gauss, in float64 on the CPU
(the JAX side takes its scan engine there)."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

from rayopt_tpu import GeometricTrace as JGeometricTrace
from rayopt_tpu import system_from_yaml as j_from_yaml
from rayopt_tpu.ops.geometric import trace_rays_final_fast as j_fast

from rayopt_tpu_torch import set_default_device
import rayopt_tpu_torch as T
from rayopt_tpu_torch.models import prescriptions as P
from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
from rayopt_tpu_torch.ops.kernels import specialize
from rayopt_tpu_torch.ops.cuda_trace import (trace_merit,
                                             spot_rms_from_moments)

FIELDS = (0., .7, 1.)
YAMLS = {"cooke": P.COOKE_YAML, "double_gauss": P.DOUBLE_GAUSS_YAML}


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
    js, ts = j_from_yaml(YAMLS[name]), T.system_from_yaml(YAMLS[name])
    js.update()
    ts.update()
    return js, ts


def _disk(n, seed):
    rng = np.random.RandomState(seed)
    r = np.sqrt(rng.uniform(0, 1, n))
    th = rng.uniform(0, 2*np.pi, n)
    return np.stack([r*np.cos(th), r*np.sin(th)], 1)


def _rms(y, u):
    y, u = np.asarray(y), np.asarray(u)
    good = np.isfinite(y[:, :2]).all(1) & np.isfinite(u[:, 2])
    pts = y[good, :2]
    return np.sqrt(((pts - pts.mean(0))**2).sum(1).mean()), good.sum()


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(YAMLS))
def test_slice_spot_rms_matches_jax(name, clip):
    js, ts = _systems(name)
    if clip:
        # both lenses' image apertures are smaller than their images
        # (a clipped bundle would die there): clip at the lens
        # apertures only
        js[-1].radius = ts[-1].radius = np.inf
    yp = _disk(2048, 11)
    table, specs = ts.table(), specialize(ts.table())
    for field in FIELDS:
        z, p = ts.pupil((0., field))
        y, u = ts.aim((0., field), yp, z, p, filter=False)
        zj, pj = js.pupil((0., field))
        yj, uj = js.aim((0., field), yp, zj, pj, filter=False)
        nptest.assert_allclose(y, yj, rtol=1e-10, atol=1e-10)
        yo, uo, t = trace_rays_final_fast(table, torch.from_numpy(y),
                                          torch.from_numpy(u), clip=clip)
        assert yo.dtype == torch.float64 and yo.shape == (2048, 3)
        wy, wu, wt = j_fast(js.table(), yj, uj, clip=clip)
        got, live = _rms(yo.numpy(), uo.numpy())
        want, live_j = _rms(wy, wu)
        assert live == live_j
        # unclipped every ray lands; clipped, the off-axis fields lose
        # rays to the lens apertures (vignetting)
        assert live == 2048 if not clip or field == 0 else 0 < live < 2048
        nptest.assert_allclose(got, want, rtol=1e-10)
        nptest.assert_allclose(t.numpy(), np.asarray(wt), rtol=1e-10,
                               equal_nan=True)
        # the merit route (K2's plain version on the CPU): the moment
        # form E[x^2] - c^2 cancels at off-axis fields, rel ~1e-10 in
        # float64 at this bundle size
        state = tuple(c.contiguous() for c in (*torch.from_numpy(y).T,
                                               *torch.from_numpy(u).T))
        mom = trace_merit(table, specs, state, clip=clip)
        assert float(mom[0]) == live
        nptest.assert_allclose(float(spot_rms_from_moments(*mom)), want,
                               rtol=1e-8)


def test_radau_rms_golden():
    js, ts = _systems("cooke")
    g, gj = T.GeometricTrace(ts), JGeometricTrace(js)
    g.rays_point((0, 1.), nrays=13, distribution="radau", filter=False)
    gj.rays_point((0, 1.), nrays=13, distribution="radau", filter=False)
    nptest.assert_allclose(g.rms(), .052, rtol=1e-2)
    nptest.assert_allclose(g.rms(), gj.rms(), rtol=1e-10)
    for attr in ("y", "u", "i", "t", "n"):
        nptest.assert_allclose(getattr(g, attr), getattr(gj, attr),
                               rtol=1e-10, atol=1e-10, equal_nan=True)


@pytest.mark.parametrize("distribution", ["meridional", "square",
                                          "hexapolar"])
def test_geometric_trace_bundles_match_jax(distribution):
    js, ts = _systems("double_gauss")
    g, gj = T.GeometricTrace(ts), JGeometricTrace(js)
    for field in (.7, 1.):
        g.rays_point((0, field), nrays=32, distribution=distribution)
        gj.rays_point((0, field), nrays=32, distribution=distribution)
        nptest.assert_allclose(g.rms(), gj.rms(), rtol=1e-10)
        nptest.assert_allclose(g.y, gj.y, rtol=1e-10, atol=1e-10,
                               equal_nan=True)


def test_refocus_matches_jax():
    js, ts = _systems("cooke")
    g, gj = T.GeometricTrace(ts), JGeometricTrace(js)
    g.rays_point((0, .5), nrays=64, distribution="hexapolar")
    gj.rays_point((0, .5), nrays=64, distribution="hexapolar")
    g.refocus()
    gj.refocus()
    nptest.assert_allclose(ts[-1].distance, js[-1].distance, rtol=1e-10)
    nptest.assert_allclose(g.rms(), gj.rms(), rtol=1e-9)


def test_fast_trace_precisions_on_cpu():
    _, ts = _systems("cooke")
    z, p = ts.pupil((0., .7))
    y, u = ts.aim((0., .7), _disk(256, 2), z, p, filter=False)
    y, u = torch.from_numpy(y), torch.from_numpy(u)
    fast = trace_rays_final_fast(ts.table(), y.float(), u.float())
    parity = trace_rays_final_fast(ts.table(), y.float(), u.float(),
                                   precision="parity")
    ref = trace_rays_final_fast(ts.table(), y.float().double(),
                                u.float().double())
    assert fast[0].dtype == torch.float32
    assert parity[0].dtype == torch.float64
    for a, b in zip(parity, ref):
        nptest.assert_array_equal(a.numpy(), b.numpy())
    nptest.assert_allclose(fast[0].double().numpy(), ref[0].numpy(),
                           atol=5e-5)
    with pytest.raises(ValueError, match="precision"):
        trace_rays_final_fast(ts.table(), y, u, precision="df32")
