"""rayopt_tpu_torch front end against the JAX package: goldens,
System.table / specialize field by field, materials, elements, pupil
aiming and the YAML round trip, all in float64 on the CPU."""

import subprocess
import sys

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import rayopt_tpu as J
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops.kernels import specialize as jspecialize

from rayopt_tpu_torch import set_default_device
import rayopt_tpu_torch as T
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.ops.kernels import specialize, specs_from_tuple
from rayopt_tpu_torch.ops.tables import SurfaceTable

SYSTEMS = ["doublet", "cooke_triplet", "double_gauss"]


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


def _pair(name):
    return getattr(jmodels, name)(), getattr(tmodels, name)()


def test_import_leaves_jax_out():
    code = ("import sys, rayopt_tpu_torch, rayopt_tpu_torch.ops, "
            "rayopt_tpu_torch.models, rayopt_tpu_torch.parallel; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cooke_first_order_goldens():
    p = tmodels.cooke_triplet().paraxial
    nptest.assert_allclose(p.focal_length[1], 49.85, rtol=1e-3)
    nptest.assert_allclose(p.working_f_number[1], 4.02, rtol=1e-3)
    nptest.assert_allclose(p.numerical_aperture[1], .124, rtol=5e-3)


def test_double_gauss_efl_golden():
    p = tmodels.double_gauss().paraxial
    nptest.assert_allclose(p.focal_length, [-99.56245406, 99.56245406],
                           rtol=1e-8)


@pytest.mark.parametrize("name", SYSTEMS)
def test_paraxial_matches_jax(name):
    js, ts = _pair(name)
    for attr in ("y", "u", "focal_length", "working_f_number",
                 "numerical_aperture", "magnification"):
        nptest.assert_allclose(getattr(ts.paraxial, attr),
                               getattr(js.paraxial, attr), rtol=1e-12,
                               atol=1e-12, err_msg=attr)


@pytest.mark.parametrize("name", SYSTEMS)
def test_table_matches_jax(name):
    js, ts = _pair(name)
    for wavelength in js.wavelengths:
        jt, tt = js.table(wavelength), ts.table(wavelength)
        assert isinstance(tt, SurfaceTable)
        assert tt.dtype == torch.float64 and tt.device.type == "cpu"
        for f in SurfaceTable._fields:
            want = np.asarray(getattr(jt, f))
            got = getattr(tt, f).numpy()
            assert got.shape == want.shape, f
            nptest.assert_allclose(got, want, atol=1e-12, rtol=0,
                                   err_msg=f)


@pytest.mark.parametrize("name", SYSTEMS)
def test_specialize_matches_jax(name):
    js, ts = _pair(name)
    assert specialize(ts.table()) == specs_from_tuple(
        jspecialize(js.table()))


def test_table_dtype_and_device():
    tt = tmodels.cooke_triplet().table(dtype=torch.float32)
    assert all(f.dtype == torch.float32 for f in tt)
    back = tt.to(dtype=torch.float64)
    assert back.rot.dtype == torch.float64


@pytest.mark.parametrize("name", ["schott-sk|n-sk16", "N-SK2", "F5",
                                  "air", "1.5/60"])
def test_material_index_matches_jax(name):
    jm, tm = J.Material.make(name), T.Material.make(name)
    for w in (486.13e-9, 587.56e-9, 656.27e-9):
        nptest.assert_allclose(tm.refractive_index(w),
                               jm.refractive_index(w), rtol=1e-15)


def test_catalog_material_raises_keyerror():
    with pytest.raises(KeyError, match="catalog I/O"):
        T.Material.make("ohara/s-lah64")


@pytest.mark.parametrize("curvature,conic", [(0., 0.), (1/40., 0.),
                                             (-1/30., -.6), (1/50., 1.5)])
def test_spheroid_oracle_matches_jax(curvature, conic):
    rng = np.random.RandomState(3)
    n = 64
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*6
    y[:, 2] = -5.
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.1, .1, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    kw = dict(curvature=curvature, conic=conic, radius=8.)
    je, te = J.Spheroid(**kw), T.Spheroid(**kw)
    tj, tt = je.intercept(y, u), te.intercept(y, u)
    nptest.assert_allclose(tt, tj, rtol=1e-12, atol=1e-12)
    p = y + tj[:, None]*u
    nptest.assert_allclose(te.surface_sag(p), je.surface_sag(p),
                           atol=1e-12)
    nptest.assert_allclose(te.surface_normal(p), je.surface_normal(p),
                           rtol=1e-12, atol=1e-12)
    for mu in (1/1.5, 1.5, -1., 1.):
        nptest.assert_allclose(te.refract(p, u, mu), je.refract(p, u, mu),
                               rtol=1e-12, atol=1e-12, equal_nan=True)
    nptest.assert_allclose(te.clip(p*2, u), je.clip(p*2, u),
                           equal_nan=True)


def test_aspheric_element_not_ported():
    el = T.Spheroid(curvature=.02, aspherics=[0., 1e-6])
    with pytest.raises(NotImplementedError):
        el.intercept(np.zeros((1, 3)), np.array([[0., 0., 1.]]))


@pytest.mark.parametrize("name", ["cooke_triplet", "double_gauss"])
def test_pupil_and_aim_match_jax(name):
    js, ts = _pair(name)
    yp = np.random.RandomState(1).uniform(-.7, .7, (32, 2))
    for field in (0., .7, 1.):
        zj, pj = js.pupil((0., field))
        zt, pt = ts.pupil((0., field))
        nptest.assert_allclose(zt, zj, rtol=1e-10)
        nptest.assert_allclose(pt, pj, rtol=1e-10, atol=1e-12)
        for got, want in zip(ts.aim((0., field), yp, zt, pt),
                             js.aim((0., field), yp, zj, pj)):
            nptest.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_batched_pupils_not_ported():
    with pytest.raises(NotImplementedError):
        tmodels.cooke_triplet().pupils([[0., 1.]])


@pytest.mark.parametrize("name", SYSTEMS)
def test_yaml_round_trip(name):
    ts = getattr(tmodels, name)()
    back = T.system_from_yaml(T.system_to_yaml(ts))
    back.update()
    for f in SurfaceTable._fields:
        nptest.assert_allclose(getattr(back.table(), f).numpy(),
                               getattr(ts.table(), f).numpy(), rtol=1e-15,
                               err_msg=f)
    assert T.system_to_yaml(ts) == J.system_to_yaml(
        getattr(jmodels, name)())


@pytest.mark.parametrize("name", ["cooke_triplet", "double_gauss"])
def test_trace_table_matches_jax(name):
    js, ts = _pair(name)
    z, p = js.pupil((0., 1.))
    yp = np.random.RandomState(2).uniform(-1, 1, (48, 2))
    y, u = js.aim((0., 1.), yp, z, p, filter=False)
    for clip in (False, True):
        want = js.trace_table(y, u, js.wavelengths[0], clip=clip)
        got = ts.trace_table(y, u, ts.wavelengths[0], clip=clip)
        for a, b in zip(got, want):
            nptest.assert_allclose(a, b, rtol=1e-11, atol=1e-11,
                                   equal_nan=True)
