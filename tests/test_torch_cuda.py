"""The hand-written CUDA kernels of rayopt_tpu_torch against their
plain PyTorch versions on a CUDA card (marker `cuda`; they skip where
there is none).  This file imports no jax, so it runs on a machine
without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.models import double_gauss
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
from rayopt_tpu_torch.ops.kernels import specialize


@pytest.fixture(autouse=True)
def _cuda_default():
    # the port's default device; a test that wants the CPU asks for it
    old = set_default_device("cuda")
    yield
    set_default_device(old)


@pytest.fixture
def cuda_device():
    # decided here, not at import: every test worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.set_num_threads(1)
    return torch.device("cuda")


def _bench_state(n, seed, device, dtype):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-11.6, 11.6, (2, n))
    zero, one = np.zeros(n), np.ones(n)
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device, dtype)
                 for c in (*xy, zero, zero, zero, one))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_on_card(cuda_device, dtype, clip):
    tab = double_gauss().table()
    specs = specialize(tab)
    state = _bench_state(1 << 16, 3, cuda_device, dtype)
    launches = CT.trace_final.launches, CT.trace_merit.launches
    got, t = CT.trace_final(tab, specs, state, clip)
    ref, tref = CT.trace_final_reference(tab, specs, state, clip)
    mom = CT.trace_merit(tab, specs, state, clip)
    mref = CT.trace_merit_reference(tab, specs, state, clip)
    torch.cuda.synchronize()
    assert (CT.trace_final.launches, CT.trace_merit.launches) == (
        launches[0] + 1, launches[1] + 1)
    # float64: rounding (FMA contraction) only; float32: a few ulp of
    # the ~30 mm intermediate coordinates
    tol = 1e-12*30 if dtype == torch.float64 else 5e-5
    for g, r in zip((*got, t), (*ref, tref)):
        assert g.dtype == dtype and g.device.type == "cuda"
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        nptest.assert_array_equal(np.isnan(g), np.isnan(r))
        nptest.assert_allclose(g, r, atol=tol, rtol=tol, equal_nan=True)
    assert float(mom[0]) == float(mref[0])
    nptest.assert_allclose(float(CT.spot_rms_from_moments(*mom)),
                           float(CT.spot_rms_from_moments(*mref)),
                           rtol=1e-10 if dtype == torch.float64 else 1e-4)


@pytest.mark.cuda
def test_parity_trace_matches_cpu_on_card(cuda_device):
    s = double_gauss()
    table = s.table()
    rng = np.random.RandomState(5)
    yp = rng.uniform(-.7, .7, (1 << 14, 2))
    for field in (0., .7, 1.):
        z, p = s.pupil((0., field))
        y, u = (torch.from_numpy(a) for a in s.aim((0., field), yp, z, p,
                                                    filter=False))
        got = trace_rays_final_fast(table, y.to(cuda_device),
                                    u.to(cuda_device), precision="parity")
        want = trace_rays_final_fast(table, y, u)
        for g, w in zip(got, want):
            nptest.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-11,
                                   atol=1e-11, equal_nan=True)


@pytest.mark.cuda
def test_wrapper_refuses_bad_bundles_on_card(cuda_device):
    tab = double_gauss().table()
    specs = specialize(tab)
    state = _bench_state(256, 0, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="share device and dtype"):
        CT.trace_final(tab, specs, state[:5] + (state[5].cpu(),))
    with pytest.raises(ValueError, match="contiguous"):
        CT.trace_merit(tab, specs, tuple(torch.stack([c, c], 1)[:, 0]
                                         for c in state))


def _rms_cotangent(mom):
    """d spot_rms / d moments at `mom` (a (5,) tensor)."""
    m = mom.detach().double().cpu().requires_grad_()
    CT.spot_rms_from_moments(*m).backward()
    return m.grad.to(device=mom.device, dtype=mom.dtype)


def _max_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()/max(float(want.abs().max()),
                                                1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_match_plain_on_card(cuda_device, dtype, clip):
    tab = double_gauss().table()
    specs = specialize(tab)
    state = _bench_state(1 << 16, 4, cuda_device, dtype)
    w = torch.from_numpy(np.random.RandomState(1).uniform(
        .5, 1.5, 1 << 16)).to(cuda_device, dtype)
    launches = CG.weighted_moments.launches, CG.merit_adjoint.launches
    mom = CG.weighted_moments(tab, specs, state, w, clip)
    mref = CG.weighted_moments_reference(tab, specs, state, w, clip)
    ct = _rms_cotangent(mref)
    pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct, clip)
    pref, sref, wref = CG.merit_adjoint_reference(tab, specs, state, w, ct,
                                                  clip)
    torch.cuda.synchronize()
    assert (CG.weighted_moments.launches, CG.merit_adjoint.launches) == (
        launches[0] + 1, launches[1] + 1)
    # the bench bundle is on axis: float32 sums of 2^16 rays hold 1e-3
    # of each field's largest cotangent; float64 rounding only
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    nptest.assert_allclose(float(CT.spot_rms_from_moments(*mom)),
                           float(CT.spot_rms_from_moments(*mref)),
                           rtol=1e-10 if dtype == torch.float64 else 1e-4)
    for col in range(CG.SLOTS):
        if float(pref[:, col].abs().max()):
            assert _max_rel(pg[:, col], pref[:, col]) <= tol, col
        assert torch.isfinite(pg[:, col]).all()
    # the same rays are live (a dead ray's cotangents are all zero)
    assert torch.equal(cw != 0, wref != 0)
    # ray cotangents against the largest of their kind (positions,
    # directions, weights): the initial z of a collimated ray has an
    # analytically zero cotangent, so its own scale is rounding noise.
    # A float32 image coordinate carries K1's ~2e-5 mm on a spot of
    # ~0.03 mm (~1e-3 relative), twice that on the squares the weight
    # cotangent holds: 1e-2 there
    ray_tol = 1e-9 if dtype == torch.float64 else 1e-2
    for got, want in (((cst[:3]), sref[:3]), (cst[3:], sref[3:]),
                      ((cw,), (wref,))):
        scale = max(float(r.abs().max()) for r in want)
        for g, r in zip(got, want):
            assert torch.isfinite(g).all()
            assert float((g - r).abs().max()) <= ray_tol*scale


@pytest.mark.cuda
def test_adjoint_optimize_step_on_card(cuda_device):
    from rayopt_tpu_torch.parallel import (bundles_from_system, bundles_to,
                                           optimize_grad)
    s = double_gauss()
    tab = s.table()
    bundles = bundles_from_system(s, fields=(0., 1.), nrays=2048,
                                  distribution="hexapolar")
    grads = {}

    def keep(tag):
        def callback(i, value, params):
            grads[tag] = {k: v.grad.double().cpu() for k, v in params.items()}
        return callback

    before = CG.weighted_moments.launches, CG.merit_adjoint.launches
    sel = ("curvature", "distance")
    _, h_gpu = optimize_grad(tab, bundles_to(bundles, cuda_device),
                             select=sel, steps=1, engine="adjoint",
                             callback=keep("gpu"))
    assert CG.weighted_moments.launches > before[0]
    assert CG.merit_adjoint.launches > before[1]
    _, h_cpu = optimize_grad(tab, bundles, select=sel, steps=1,
                             engine="adjoint", callback=keep("cpu"))
    nptest.assert_allclose(h_gpu, h_cpu, rtol=1e-9)
    for k in sel:
        g, r = grads["gpu"][k], grads["cpu"][k]
        assert float((g - r).abs().max()) <= 1e-8*float(r.abs().max()), k


def _union_cotangent(mom):
    """d union_spot_rms / d (nlam, 5) moments at `mom`."""
    m = mom.detach().double().cpu().requires_grad_()
    CG.union_spot_rms_from_moments(m).backward()
    return m.grad.to(device=mom.device, dtype=mom.dtype).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multi_kernels_match_plain_on_card(cuda_device, dtype, clip):
    """K3 (no clip: traced once, at clip=False), K6 and K7 on the double
    Gauss's 3-wavelength stack against their plain versions: the same
    tolerances as K1/K2 and K4/K5 above, per wavelength."""
    tabs = double_gauss().tables()
    specs = CT.multi_specs(tabs, None)
    nlam = tabs.curvature.shape[0]
    state = _bench_state(1 << 16, 6, cuda_device, dtype)
    w = torch.from_numpy(np.random.RandomState(2).uniform(
        .5, 1.5, 1 << 16)).to(cuda_device, dtype)
    f64 = dtype == torch.float64
    if not clip:
        before = CT.trace_multi.launches
        got = CT.trace_multi(tabs, specs, state)
        ref = CT.trace_multi_reference(tabs, specs, state)
        mom = CT.trace_multi(tabs, specs, state, merit=True)
        mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
        torch.cuda.synchronize()
        assert CT.trace_multi.launches == before + 2
        tol = 1e-12*30 if f64 else 5e-5
        for (g, t), (r, tr) in zip(got, ref):
            for a, b in zip((*g, t), (*r, tr)):
                a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
                nptest.assert_array_equal(np.isnan(a), np.isnan(b))
                nptest.assert_allclose(a, b, atol=tol, rtol=tol,
                                       equal_nan=True)
        for m, r in zip(mom, mref):
            assert float(m[0]) == float(r[0])
            nptest.assert_allclose(float(CT.spot_rms_from_moments(*m)),
                                   float(CT.spot_rms_from_moments(*r)),
                                   rtol=1e-10 if f64 else 1e-4)
    launches = CG.weighted_moments_multi.launches, \
        CG.merit_adjoint_multi.launches
    mom = CG.weighted_moments_multi(tabs, specs, state, w, clip)
    mref = CG.weighted_moments_multi_reference(tabs, specs, state, w, clip)
    ct = _union_cotangent(mref)
    pg, cst, cw = CG.merit_adjoint_multi(tabs, specs, state, w, ct, clip)
    pref, sref, wref = CG.merit_adjoint_multi_reference(tabs, specs, state,
                                                        w, ct, clip)
    torch.cuda.synchronize()
    assert (CG.weighted_moments_multi.launches,
            CG.merit_adjoint_multi.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    assert mom.shape == (nlam, 5) and pg.shape == (nlam, len(specs),
                                                   CG.SLOTS)
    for li in range(nlam):
        nptest.assert_allclose(float(CT.spot_rms_from_moments(*mom[li])),
                               float(CT.spot_rms_from_moments(*mref[li])),
                               rtol=1e-10 if f64 else 1e-4)
        tol = 1e-9 if f64 else 1e-3
        for col in range(CG.SLOTS):
            if float(pref[li, :, col].abs().max()):
                assert _max_rel(pg[li, :, col], pref[li, :, col]) <= tol
            assert torch.isfinite(pg[li, :, col]).all()
    assert not pg[:, 0].any()
    assert torch.equal(cw != 0, wref != 0)
    ray_tol = 1e-9 if f64 else 1e-2
    for got, want in ((cst[:3], sref[:3]), (cst[3:], sref[3:]),
                      ((cw,), (wref,))):
        scale = max(float(r.abs().max()) for r in want)
        for g, r in zip(got, want):
            assert torch.isfinite(g).all()
            assert float((g - r).abs().max()) <= ray_tol*scale


@pytest.mark.cuda
def test_polychromatic_glass_gradient_on_card(cuda_device):
    """The achromatization merit (glass_tables -> polychromatic_spot_rms,
    engine="adjoint") on CUDA tensors launches K6 and K7 and gives the
    CPU plain versions' value (rtol 1e-9) and (nd, vd) gradient (1e-8
    of its max), float64."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = double_gauss()
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    out = {}
    for dev in ("cpu", cuda_device):
        tabs = s.tables(device=dev)
        y0, u0, w, _ = bundles_from_system(
            s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=2048,
            distribution="hexapolar", device=dev)[0]
        nd = torch.tensor(nd0, device=dev, requires_grad=True)
        vd = torch.tensor(vd0, device=dev, requires_grad=True)
        before = CG.merit_adjoint_multi.launches
        v = glass.polychromatic_spot_rms(
            glass.glass_tables(tabs, nd, vd, asg, s.wavelengths), y0, u0, w,
            engine="adjoint")
        v.backward()
        if dev != "cpu":
            assert CG.merit_adjoint_multi.launches == before + 1
        out[str(dev)] = (float(v.detach()), nd.grad.cpu(), vd.grad.cpu())
    (v_c, gn_c, gv_c), (v_g, gn_g, gv_g) = out["cpu"], out["cuda"]
    nptest.assert_allclose(v_g, v_c, rtol=1e-9)
    for g, r in ((gn_g, gn_c), (gv_g, gv_c)):
        assert float((g - r).abs().max()) <= 1e-8*float(r.abs().max())


@pytest.mark.cuda
def test_default_device_entry_points_on_card(cuda_device):
    """With the default device (the card), the host-side solvers keep
    their CPU traces, and first_order_penalty and write_back_table take
    a CUDA table."""
    from rayopt_tpu_torch.parallel import (first_order_penalty,
                                           paraxial_seed, write_back_table)
    s = double_gauss()
    tab = s.table()
    assert tab.curvature.device.type == "cuda"
    assert s.tables().curvature.device.type == "cuda"
    z, p = s.pupil((0., 1.))
    assert np.isfinite(z)
    efl = float(s.paraxial.focal_length[1])
    pen = first_order_penalty(tab, paraxial_seed(s),
                              {"focal_length": (1, efl + 1.)})
    assert pen.device.type == "cuda"
    nptest.assert_allclose(float(pen), 1., rtol=1e-9)
    write_back_table(s, tab, ("curvature", "distance"))
    nptest.assert_allclose(float(s.paraxial.focal_length[1]), efl,
                           rtol=1e-12)
