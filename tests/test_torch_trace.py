"""rayopt_tpu_torch trace modules against the JAX package: the
surface_step_spec branches one by one, the generic step, the engines
in ops.geometric, and the plain versions of the CUDA kernels (K1
trace_final, K2 trace_merit) against the Pallas kernels they replace
(interpret mode on the CPU).  float64 on the CPU; the kernels
themselves run only on a CUDA card (tests/test_torch_cuda.py)."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax.numpy as jnp
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.ops.pallas_trace import (pallas_trace_final,
                                         pallas_trace_merit,
                                         spot_rms_from_moments as j_rms)

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops import cuda_trace as CT

RTOL = ATOL = 1e-12


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


def _bundle(n, seed, height, slope=.05):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*height
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    return y, u


def _components(y, u):
    return tuple(np.ascontiguousarray(c) for c in (*y.T, *u.T))


def _torch(state):
    return tuple(torch.from_numpy(c) for c in state)


def _assert_rays(got, want):
    """Identical NaN masks and rtol=atol=1e-12 on live rays."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        nptest.assert_array_equal(np.isnan(g), np.isnan(w))
        nptest.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True)


def _assert_moments(got, want):
    got = [float(v) for v in got]
    want = [float(v) for v in want]
    assert got[0] == want[0]
    # sums of x are held to cnt*rms: their value may cancel to ~0
    scale = [1., (want[0]*want[3])**.5, (want[0]*want[4])**.5, want[3],
             want[4]]
    for g, w, s in zip(got[1:], want[1:], scale[1:]):
        assert abs(g - w) <= 1e-12*s, (g, w)


# -- one surface_step_spec branch at a time -----------------------------

def _row(curvature=0., conic=0., mu=1/1.5, radius=np.inf, alternate=0.,
         offset=(0., 0., 5.), rot=None):
    return dict(curvature=[0., curvature], conic=[0., conic],
                mu=[1., mu], radius=[np.inf, radius],
                alternate=[0., alternate], n_before=[1., 1.],
                n_after=[1., 1./mu if mu > 0 else 1.],
                offset=[[0., 0., 0.], list(offset)],
                rot=None if rot is None else [np.eye(3), rot])


def _tilt(ax, ay):
    from rayopt_tpu.utils.geometry import euler_matrix
    return euler_matrix(ax, ay, 0., axes="rxyz")


BRANCHES = {
    "flat": _row(),
    "flat_mirror": _row(mu=-1.),
    "spherical": _row(curvature=1/40.),
    "spherical_concave": _row(curvature=-1/25.),
    "spherical_mirror": _row(curvature=-1/60., mu=-1.),
    "spherical_alternate": _row(curvature=1/12., alternate=1.),
    "conic": _row(curvature=1/35., conic=-.7),
    "conic_mirror": _row(curvature=-1/100., conic=-1., mu=-1.),
    "passthrough": _row(curvature=1/30., mu=1.),
    "passthrough_flat": _row(mu=1.),
    "rotated": _row(curvature=1/45., rot=_tilt(.05, -.03)),
    "off_axis": _row(curvature=1/45., offset=(.4, -.3, 5.)),
    "rotated_off_axis_conic": _row(curvature=-1/50., conic=.5,
                                   offset=(.2, .1, 4.),
                                   rot=_tilt(-.02, .04)),
    "tir": _row(curvature=1/9., mu=1.7),
}


_JAX_INTERCEPT_SPEC = JK.intercept_spec


def _jax_intercept_selected(x, y, z, ux, uy, uz, c, k, alternate, spec):
    """The JAX package's specialized intercept with the root form the
    port picks: for curved rows its own cancellation-free
    intercept_conic.  The JAX package's specialized form -(d + g)/e
    loses digits near a paraboloid's axis; the port diverges from it
    there by choice (ROADMAP, Queue 3)."""
    if spec.flat:
        return _JAX_INTERCEPT_SPEC(x, y, z, ux, uy, uz, c, k, alternate,
                                   spec)
    return JK.intercept_conic(x, y, z, ux, uy, uz, c,
                              0. if spec.spherical else k, alternate)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_surface_step_spec_branch(name, clip, monkeypatch):
    monkeypatch.setattr(JK, "intercept_spec", _jax_intercept_selected)
    kw = dict(BRANCHES[name])
    kw["radius"] = [np.inf, 5.5]
    jt = JT.make_table(**kw)
    specs = JK.specialize(jt)
    tt = TT.table_from_numpy(jt)
    tspecs = TK.specs_from_tuple(specs)
    assert TK.specialize(tt) == tspecs
    y, u = _bundle(200, 7, 8., .2)
    y[:, 2] = -1.
    state = _components(y, u)
    jsurf = JT.SurfaceTable(*(None if f is None else jnp.asarray(f)[1]
                              for f in jt))
    want_state, want_out = JK.surface_step_spec(state, jsurf, specs[1],
                                                clip)
    got_state, got_out = TK.surface_step_spec(_torch(state), tt.row(1),
                                              tspecs[1], clip)
    _assert_rays(got_state, want_state)
    for g, w in zip(got_out[:3], want_out[:3]):
        _assert_rays(g, w)
    _assert_rays([got_out[3]], [want_out[3]])


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_surface_step_generic_matches_jax(name):
    jt = JT.make_table(**BRANCHES[name])
    tt = TT.table_from_numpy(jt)
    y, u = _bundle(100, 8, 6., .2)
    y[:, 2] = -1.
    state = _components(y, u)
    jsurf = JT.SurfaceTable(*(None if f is None else jnp.asarray(f)[1]
                              for f in jt))
    want_state, want_out = JK.surface_step(state, jsurf, True)
    got_state, got_out = TK.surface_step(_torch(state), tt.row(1), True)
    _assert_rays(got_state, want_state)
    _assert_rays([got_out[3]], [want_out[3]])


def test_extended_vocabulary_raises():
    jt = JT.make_table(curvature=[0., 1/40.], aspherics=[[0.], [1e-6]],
                       mu=[1., 1/1.5])
    tt = TT.table_from_numpy(jt)
    specs = TK.specialize(tt)
    assert specs[1].aspheric
    state = _torch(_components(*_bundle(8, 0, 1.)))
    with pytest.raises(NotImplementedError):
        TK.surface_step_spec(state, tt.row(1), specs[1], False)
    with pytest.raises(NotImplementedError):
        CT.trace_final(tt, specs, state)
    with pytest.raises(NotImplementedError):
        CT.pack_table(tt, specs, torch.float32, "cpu")
    with pytest.raises(NotImplementedError):
        TG.trace_rays_final(tt, torch.zeros(2, 3), torch.ones(2, 3))


# -- tables -------------------------------------------------------------

def test_rodrigues_and_lower_pose_match_jax():
    rng = np.random.RandomState(4)
    v = np.concatenate([rng.normal(size=(5, 3))*.3, np.zeros((1, 3)),
                        np.full((1, 3), 1e-8)])
    nptest.assert_allclose(TT.rodrigues(torch.from_numpy(v)).numpy(),
                           np.asarray(JT.rodrigues(v)), rtol=1e-14,
                           atol=1e-15)
    tab = jmodels.cooke_triplet().table()
    tilt = np.zeros((tab.curvature.shape[0], 3))
    tilt[3] = (.01, -.02, .003)
    dec = np.zeros_like(tilt)
    dec[5] = (.1, 0., -.05)
    jt = tab.replace(tilt=tilt, decenter=dec)
    want = JT.lower_pose(jt)
    got = TT.lower_pose(TT.table_from_numpy(jt))
    for f in ("rot", "offset", "tilt", "decenter"):
        nptest.assert_allclose(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), rtol=1e-14,
                               atol=1e-15)
    assert TK.specialize(TT.table_from_numpy(jt)) == TK.specs_from_tuple(
        JK.specialize(jt))


def test_with_pose_matches_jax():
    specs = JK.specialize(jmodels.cooke_triplet().table())
    assert TK.with_pose(TK.specs_from_tuple(specs), rows=(2, 4)) == \
        TK.specs_from_tuple(JK.with_pose(specs, rows=(2, 4)))


def test_pack_table_layout():
    tab = TT.table_from_numpy(jmodels.cooke_triplet().table())
    specs = TK.specialize(tab)
    packed, flags = CT.pack_table(tab, specs, torch.float32, "cpu")
    assert packed.shape == (tab.nsurfaces, CT.ROW)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    nptest.assert_array_equal(packed[:, CT.P_C], tab.curvature.float())
    nptest.assert_array_equal(packed[:, CT.P_ROT:CT.P_ROT + 9],
                              tab.rot.reshape(-1, 9).float())
    nptest.assert_array_equal(packed[:, CT.P_NB], tab.n_before.float())
    for s, f in zip(specs, flags.tolist()):
        assert bool(f & CT.F_FLAT) == s.flat
        assert bool(f & CT.F_SPHERICAL) == s.spherical
        assert bool(f & CT.F_FINITE) == s.finite_aperture
        assert (f >> CT.KIND_SHIFT) & 3 == s.kind


# -- engines ----------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True])
def test_trace_rays_matches_jax(clip):
    tab = jmodels.cooke_triplet().table()
    y, u = _bundle(64, 5, 7.)
    want = JG.trace_rays(tab, y, u, clip=clip)
    got = TG.trace_rays(TT.table_from_numpy(tab), torch.from_numpy(y),
                        torch.from_numpy(u), clip=clip)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        _assert_rays([g.reshape(-1)], [np.asarray(w).reshape(-1)])


@pytest.mark.parametrize("specialized", [False, True])
def test_trace_rays_final_matches_jax(specialized):
    tab = jmodels.double_gauss().table()
    specs = JK.specialize(tab) if specialized else None
    y, u = _bundle(64, 6, 10.)
    want = JG.trace_rays_final(tab, y, u, clip=True, specs=specs,
                               unroll=specialized)
    got = TG.trace_rays_final(
        TT.table_from_numpy(tab), torch.from_numpy(y), torch.from_numpy(u),
        clip=True, specs=specs and TK.specs_from_tuple(specs))
    for g, w in zip(got, want):
        _assert_rays([g.reshape(-1)], [np.asarray(w).reshape(-1)])


# -- the kernels' plain versions against the Pallas kernels -------------

KERNEL_CASES = [(b, c) for b in ("cooke_triplet", "doublet")
                for c in (False, True)]


def _kernel_inputs(build):
    tab = getattr(jmodels, build)().table()
    specs = JK.specialize(tab)
    # the doublet is sub-mm scale (roc ~ 0.6), the Cooke ~ 6 mm
    height = .3 if build == "doublet" else 8.
    state = _components(*_bundle(256, 0, height))
    return tab, specs, state


@pytest.mark.parametrize("build,clip", KERNEL_CASES)
def test_trace_final_reference_matches_pallas(build, clip):
    tab, specs, state = _kernel_inputs(build)
    out, t = pallas_trace_final(tab, state, clip=clip, specs=specs,
                                tile=128, interpret=True)
    got, tt = CT.trace_final_reference(
        TT.table_from_numpy(tab), TK.specs_from_tuple(specs),
        _torch(state), clip)
    _assert_rays((*got, tt), (*out, t))
    if clip and build == "cooke_triplet":
        assert np.isnan(got[3].numpy()).any()  # clip vignetted rays


@pytest.mark.parametrize("build,clip", KERNEL_CASES)
def test_trace_merit_reference_matches_pallas(build, clip):
    tab, specs, state = _kernel_inputs(build)
    want = pallas_trace_merit(tab, state, clip=clip, specs=specs,
                              tile=128, interpret=True)
    got = CT.trace_merit_reference(TT.table_from_numpy(tab),
                                   TK.specs_from_tuple(specs),
                                   _torch(state), clip)
    _assert_moments(got, want)
    nptest.assert_allclose(float(CT.spot_rms_from_moments(*got)),
                           float(j_rms(*want)), rtol=1e-10)


def test_wrappers_take_plain_version_on_cpu():
    tab, specs, state = _kernel_inputs("cooke_triplet")
    ttab, tspecs = TT.table_from_numpy(tab), TK.specs_from_tuple(specs)
    before = CT.trace_final.launches, CT.trace_merit.launches
    got, t = CT.trace_final(ttab, tspecs, _torch(state), True)
    ref, tref = CT.trace_final_reference(ttab, tspecs, _torch(state), True)
    _assert_rays((*got, t), (*ref, tref))
    mom = CT.trace_merit(ttab, tspecs, _torch(state), True)
    _assert_moments(mom, CT.trace_merit_reference(ttab, tspecs,
                                                  _torch(state), True))
    # no kernel launched on the CPU
    assert (CT.trace_final.launches, CT.trace_merit.launches) == before


def test_wrapper_input_checks():
    tab, specs, state = _kernel_inputs("cooke_triplet")
    ttab, tspecs = TT.table_from_numpy(tab), TK.specs_from_tuple(specs)
    st = list(_torch(state))
    with pytest.raises(ValueError, match="6 components"):
        CT.trace_final(ttab, tspecs, st[:5])
    with pytest.raises(TypeError):
        CT.trace_final(ttab, tspecs, [c.to(torch.int64) for c in st])
    with pytest.raises(ValueError, match="contiguous"):
        CT.trace_final(ttab, tspecs, [torch.stack([c, c], 1)[:, 0]
                                      for c in st])
    with pytest.raises(ValueError, match="one length"):
        CT.trace_merit(ttab, tspecs, st[:5] + [st[5][:10]])
    with pytest.raises(ValueError, match="share device and dtype"):
        CT.trace_final(ttab, tspecs, st[:5] + [st[5].float()])
    with pytest.raises(ValueError, match="specs"):
        CT.pack_table(ttab, tspecs[:-1], torch.float64, "cpu")


def test_float32_reference_tracks_float64():
    tab, specs, state = _kernel_inputs("cooke_triplet")
    ttab, tspecs = TT.table_from_numpy(tab), TK.specs_from_tuple(specs)
    s64 = _torch(state)
    s32 = tuple(c.float() for c in s64)
    got, _ = CT.trace_final_reference(ttab, tspecs, s32)
    want, _ = CT.trace_final_reference(ttab, tspecs, s64)
    assert got[0].dtype == torch.float32
    for g, w in zip(got, want):
        nptest.assert_allclose(g.double().numpy(), w.numpy(), atol=5e-5,
                               equal_nan=True)
