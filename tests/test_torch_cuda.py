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
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops.tables import make_table, rodrigues
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


def _spec_case(name, device, dtype):
    """A system's table, specs (the Cooke's with with_pose for
    "cooke_pose") and its aimed hexapolar bundle (nrays 2^14) at field
    0.7 and the first wavelength, in `dtype` on `device`."""
    from rayopt_tpu_torch.models import (cooke_triplet, doublet,
                                         parabolic_mirror)
    from rayopt_tpu_torch.ops.kernels import with_pose
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = {"doublet": doublet, "cooke": cooke_triplet,
         "cooke_pose": cooke_triplet, "parabolic": parabolic_mirror}[name]()
    tab = s.table()
    specs = specialize(tab)
    if name == "cooke_pose":
        specs = with_pose(specs)
    y0, u0, w, _ = bundles_from_system(
        s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=1 << 14,
        distribution="hexapolar", device="cpu")[0]
    state = tuple(c.to(device, dtype).contiguous() for c in (*y0.T, *u0.T))
    return tab, specs, state, w.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["doublet", "cooke", "parabolic",
                                  "cooke_pose"])
def test_specialized_grad_kernels_match_plain_on_card(cuda_device, name,
                                                       dtype):
    """K4 and K5 compiled per spec tuple (ops.cuda_spec) against their
    plain versions, clip off and on, for the optimizer's slot set and
    for every field, with and without the ray cotangents: one launch a
    call, the slots that are not live exact zeros.  float64 K5 is held
    to the float64 plain version at rounding (the fused multiply-adds
    nvcc contracts: the doublet's ray cotangents measured 1.2e-9 of
    their largest).  float32 K5 is held to the float64 plain version on
    the same inputs, within 1e-3 (parameters) and 1e-2 (rays) of the
    largest, or ten times the float32 plain version's own error where
    that is larger: on the doublet's aimed bundle the float32 plain
    version is itself 1.6e-2 off in curvature."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    tab, specs, state, w = _spec_case(name, cuda_device, dtype)
    f64 = dtype == torch.float64
    slot_sets = (("curvature", "offset"), CS.FIELDS)
    # one nvcc a key, all started together
    CS.prebuild([CS.moments_key(specs, dtype, clip) for clip in (0, 1)] + [
        CS.adjoint_key(specs, dtype, clip, fields, rays)
        for clip in (0, 1) for fields in slot_sets for rays in (0, 1)])

    def rel(got, want):
        """max |got - want| of the largest |want| (0 if want is 0)."""
        scale = max(float(v.abs().max()) for v in want)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        return err/scale if scale else err

    for clip in (False, True):
        before = CG.weighted_moments.launches
        mom = CG.weighted_moments(tab, specs, state, w, clip)
        mref = CG.weighted_moments_reference(tab, specs, state, w, clip)
        assert CG.weighted_moments.launches == before + 1
        if float(mref[0]) == 0:
            assert float(mom[0]) == 0
            continue
        # each moment of its scale, floored at 1 mm a unit weight as in
        # chip_smoke.compare_wmoments: the spot RMS of float32 moments
        # cancels off axis (E[x^2] - c^2)
        wsum, sxx, syy = (float(mref[i]) for i in (0, 3, 4))
        scale = (wsum, max((wsum*sxx)**.5, wsum), max((wsum*syy)**.5, wsum),
                 max(sxx, wsum), max(syy, wsum))
        for g, r, sc in zip(mom.tolist(), mref.tolist(), scale):
            assert abs(g - r) <= (1e-12 if f64 else 1e-4)*sc, (g, r)
        ct = _rms_cotangent(mref)
        plain = CG.merit_adjoint_reference(tab, specs, state, w, ct, clip)
        truth = CG.merit_adjoint_reference(
            tab, specs, tuple(c.double() for c in state), w.double(),
            ct.double(), clip)
        for fields in slot_sets:
            live = CS.live_mask(CS.live_slots(specs, fields)).to(cuda_device)
            for rays in (False, True):
                before = CG.merit_adjoint.launches
                pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct,
                                               clip, fields=fields,
                                               rays=rays)
                torch.cuda.synchronize()
                assert CG.merit_adjoint.launches == before + 1
                assert torch.isfinite(pg).all()
                assert not bool(pg[~live].any())
                # each field against its largest cotangent (the offset's
                # x, y, z together: a symmetric bundle's x is rounding
                # noise about zero)
                want = torch.where(live, truth[0], 0.)
                own = torch.where(live, plain[0].double(), 0.)
                for cols in ((0,), (1,), (2, 3, 4), (5,)):
                    got = rel([pg[:, cols]], [want[:, cols]])
                    lim = 1e-9 if f64 else max(
                        1e-3, 10*rel([own[:, cols]], [want[:, cols]]))
                    assert got <= lim, (fields, rays, cols, got, lim)
                if not rays:
                    assert cst is None and cw is None
                    continue
                # dead rays are exact zeros in both (a live ray's weight
                # cotangent may round to zero too, so no mask test here)
                for kind in (slice(0, 3), slice(3, 6)):
                    got = rel(cst[kind], truth[1][kind])
                    lim = 1e-8 if f64 else max(
                        1e-2, 10*rel(plain[1][kind], truth[1][kind]))
                    assert got <= lim, (fields, kind, got, lim)
                got = rel([cw], [truth[2]])
                lim = 1e-8 if f64 else max(1e-2,
                                           10*rel([plain[2]], [truth[2]]))
                assert got <= lim, (fields, "w", got, lim)


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


def _opd_setup(device, dtype, n, seed, widen=1.):
    """The double Gauss's table and specs, a bench bundle (ray 0 the
    chief ray, on axis; `widen` scales the footprint), K8's aux vector
    (the chief ray's image point from the CPU plain trace, the exit
    pupil's reference-sphere radius, the first wavelength's scale) and
    seeded cotangents on k and both landing coordinates."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    s = double_gauss()
    tab = s.table()
    specs = specialize(tab)
    state = list(_bench_state(n, seed, "cpu", torch.float64))
    for i in range(6):
        state[i] = state[i]*widen if i < 2 else state[i]
        state[i][0] = 1. if i == 5 else 0.
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    yr, _, _ = trace_rays_final(s.table(device="cpu"), y0[:1], u0[:1],
                                specs=specs)
    aux = torch.cat([yr[0], torch.tensor([-s.image.pupil.distance,
                                          s.wavelengths[0]/s.scale])])
    rng = np.random.RandomState(seed + 1)
    cts = tuple(torch.from_numpy(rng.normal(size=n)).to(device, dtype)
                for _ in range(3))
    state = tuple(c.to(device, dtype).contiguous() for c in state)
    return tab, specs, state, aux.to(device, dtype), cts


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_opd_kernels_match_plain_on_card(cuda_device, dtype, clip):
    """K8 (opd_chain) and K9 (opd_adjoint) against their plain versions
    on the double Gauss, 2^16 bench rays (x1.5 wider and clipped: some
    rays vignette), seeded cotangents on k and both landing coordinates
    for the rays live in every version compared.  K8: float64 1e-12 of
    max(1, max |output|); float32 1e-5 of it (k is a ~1e5-wave path, so
    a float32 ulp is ~0.008 waves), NaN masks differing on at most 1e-4
    of the rays.  K9: float64 within 1e-9 of each kind's largest plain
    cotangent (parameters by column, positions, directions, the
    centre).  Float32: per-ray cotangents within 1e-3 of their kind's
    largest; the parameter and centre sums are held against the float64
    plain version on the same inputs within 1e-2 of the largest sum of
    |term| (the float64 plain version with |ct|): each ray's reverse
    cancels (the path is stationary) and so do the sums, and float32
    holds them only that close, the plain float32 version included.
    Dead rays get exact zeros."""
    f64 = dtype == torch.float64
    tab, specs, state, aux, cts = _opd_setup(cuda_device, dtype, 1 << 16, 7,
                                             1.5 if clip else 1.)
    state64 = tuple(c.double() for c in state)
    launches = CG.opd_chain.launches, CG.opd_adjoint.launches
    got = CG.opd_chain(tab, specs, state, aux, clip)
    ref = CG.opd_chain_reference(tab, specs, state, aux, clip)
    ref64 = CG.opd_chain_reference(tab, specs, state64, aux.double(), clip)
    live = torch.isfinite(ref[0])
    live_got = torch.isfinite(got[0])
    same = live & live_got & torch.isfinite(ref64[0])
    cts = tuple(torch.where(same, c, 0.) for c in cts)
    pg, cst, cc = CG.opd_adjoint(tab, specs, state, aux, cts, clip)
    pr, sr, cr = CG.opd_adjoint_reference(tab, specs, state, aux, cts, clip)
    torch.cuda.synchronize()
    assert (CG.opd_chain.launches, CG.opd_adjoint.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert bool(live.all()) != clip
    assert int((live != live_got).sum()) <= (0 if f64 else 1e-4*len(live))
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.device == state[0].device
        scale = max(float(r[same].abs().max()), 1.)
        tol = (1e-12 if f64 else 1e-5)*scale
        assert float((g[same] - r[same]).abs().max()) <= tol
    assert pg.shape == (len(specs), CG.OPD_SLOTS) and not pg[0].any()
    if f64:
        base, base_c, mass, mass_c = pr, cr, pr, cr
    else:
        cts64 = tuple(c.double() for c in cts)
        base, _, base_c = CG.opd_adjoint_reference(
            tab, specs, state64, aux.double(), cts64, clip)
        mass, _, mass_c = CG.opd_adjoint_reference(
            tab, specs, state64, aux.double(), tuple(c.abs() for c in cts64),
            clip)
    sum_tol = 1e-9 if f64 else 1e-2

    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    for col in range(CG.OPD_SLOTS):
        limit = sum_tol*float(mass[:, col].abs().max())
        assert err(pg[:, col], base[:, col]) <= limit, col
        assert torch.isfinite(pg[:, col]).all()
    assert err(cc, base_c) <= sum_tol*float(mass_c.abs().max())
    assert not any(bool(c[~live_got].any()) for c in cst)
    tol = 1e-9 if f64 else 1e-3
    for got_k, want_k in ((cst[:3], sr[:3]), (cst[3:], sr[3:])):
        scale = max(float(r.abs().max()) for r in want_k)
        for g, r in zip(got_k, want_k):
            assert torch.isfinite(g).all()
            assert err(g, r) <= tol*scale


@pytest.mark.cuda
def test_adjoint_wavefront_and_strehl_on_card(cuda_device):
    """adjoint_wavefront_rms and strehl_ratio(engine="adjoint") on CUDA
    tensors launch K8 and K9 and give the CPU plain versions' value
    (rtol 1e-9) and curvature, n_before and ray gradients (1e-8 of each
    one's max), float64, on a hexapolar bundle of the double Gauss at
    field .7."""
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_wavefront_rms
    from rayopt_tpu_torch.parallel import bundles_from_system, strehl_ratio
    s = double_gauss()
    kw = dict(ref=0, radius=-s.image.pupil.distance,
              wavelength=s.wavelengths[0], scale=s.scale,
              finite=s.object.finite)
    out = {}
    for dev in ("cpu", cuda_device):
        tab = s.table(device=dev)
        y0, u0, w, _ = bundles_from_system(
            s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=2048,
            distribution="hexapolar", device=dev)[0]
        for name, fn in (("wavefront", adjoint_wavefront_rms),
                         ("strehl", lambda *a, **k: strehl_ratio(
                             *a, engine="adjoint", **k))):
            c = tab.curvature.clone().requires_grad_()
            nb = tab.n_before.clone().requires_grad_()
            y = y0.clone().requires_grad_()
            before = CG.opd_chain.launches, CG.opd_adjoint.launches
            v = fn(tab.replace(curvature=c, n_before=nb), y, u0, w, **kw)
            v.backward()
            if dev != "cpu":
                assert (CG.opd_chain.launches, CG.opd_adjoint.launches) == (
                    before[0] + 1, before[1] + 1)
            out[name, str(dev)] = (float(v.detach()), c.grad.cpu(),
                                   nb.grad.cpu(), y.grad.cpu())
    for name in ("wavefront", "strehl"):
        (v_c, *g_c), (v_g, *g_g) = out[name, "cpu"], out[name, "cuda"]
        nptest.assert_allclose(v_g, v_c, rtol=1e-9)
        for g, r in zip(g_g, g_c):
            assert float((g - r).abs().max()) <= 1e-8*float(r.abs().max())


# -- the df32 kernels (K10-K13) ---------------------------------------------

def vocabulary_table():
    """Every branch of the K1 vocabulary in one chain, on the default
    device (tests/test_torch_df32.py traces it on the CPU):
    a sphere, a tilted and decentred conic (rot_df, off-axis), a
    sphere under an exact signed-permutation fold (90 degrees about z),
    a conic mirror, an alternate-root sphere behind it, and a tilted
    flat image row (the last frame's rotation)."""
    rot = torch.eye(3, dtype=torch.float64).repeat(7, 1, 1)
    rot[2] = rodrigues(torch.tensor([.02, -.01, 0.], dtype=torch.float64))
    rot[3] = torch.tensor([[0., 1., 0.], [-1., 0., 0.], [0., 0., 1.]],
                          dtype=torch.float64)
    rot[6] = rodrigues(torch.tensor([0., .03, .01], dtype=torch.float64))
    off = np.zeros((7, 3))
    off[:, 2] = [0., 5., 4., 3., 30., -10., -40.]
    off[2, :2] = [.1, -.05]
    return make_table(
        curvature=[0., .02, -.03, .01, -.005, .004, 0.],
        conic=[0., 0., -.5, 0., -1., 0., 0.],
        offset=off, rot=rot.numpy(),
        radius=[np.inf, 8., 7., 6., 20., 30., np.inf],
        alternate=[0., 0., 0., 0., 0., 1., 0.],
        mu=[1., 1/1.5, 1.5, 1., -1., 1., 1.],
        n_before=[1., 1., 1.5, 1., 1., 1., 1.])


def _df32_words(res, with_path):
    comps = (*res[0], res[1]) if with_path else res
    return [w for c in comps for w in c]


def _differing_words(got, want):
    """Words that differ (NaN equal to NaN) over two lists of tensors."""
    return sum(int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
               for a, b in zip(got, want))


def _moment_scale(m):
    """Each df32 moment's scale, as chip_smoke.compare_moments: a sum of
    x is held to count * sqrt(E[x^2]), floored at the count."""
    cnt, sxx, syy = (float(m[i]) for i in (0, 3, 4))
    return (1., max((cnt*sxx)**.5, cnt), max((cnt*syy)**.5, cnt),
            max(sxx, cnt), max(syy, cnt))


def _moments_rel(got, want):
    return max(abs(float(g) - float(w))/s for g, w, s in
               zip(got[1:], want[1:], _moment_scale(want)[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [True, False])
def test_df32_kernels_match_plain_on_card(cuda_device, fast, clip):
    """K10 (with and without the path) and K12 against their plain
    versions on the card, on the double Gauss (the bench bundle, 1.5x
    wide when clipped) and on the vocabulary table: identical words
    (the kernel rounds every float32 operation as the plain version
    does), the moments within 1e-13 of their scale (another order of
    summation) and the same count."""
    state64 = _bench_state(1 << 16, 3, cuda_device, torch.float64)
    if clip:
        state64 = tuple(c*1.5 if i < 2 else c for i, c in enumerate(state64))
    y, u = torch.stack(state64[:3], 1), torch.stack(state64[3:], 1)
    st = D.state_from_f64(y, u)
    for tab in (double_gauss().table(), vocabulary_table()):
        steps = D.plan(tab, clip=clip, fast=fast)
        before = CD.trace_final_df32.launches, CD.trace_merit_df32.launches
        for wp in (False, True):
            got = CD.trace_final_df32(steps, st, with_path=wp)
            want = CD.trace_final_df32_reference(steps, st, with_path=wp)
            torch.cuda.synchronize()
            assert got[0][0][0].device.type == "cuda" if wp else \
                got[0][0].device.type == "cuda"
            assert _differing_words(_df32_words(got, wp),
                                    _df32_words(want, wp)) == 0
        mom = CD.trace_merit_df32(steps, st)
        mref = CD.trace_merit_df32_reference(steps, st)
        assert float(mom[0]) == float(mref[0]) > 0
        assert _moments_rel(mom, mref) <= 1e-13
        assert (CD.trace_final_df32.launches,
                CD.trace_merit_df32.launches) == (before[0] + 2,
                                                  before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_df32_multi_kernels_match_plain_on_card(cuda_device, fast):
    """K11 and K13 at the double Gauss's 3 wavelengths against their
    plain versions on the card, as K10/K12 are held."""
    s = double_gauss()
    plans = [D.plan(s.table(lam), fast=fast) for lam in s.wavelengths]
    state64 = _bench_state(1 << 16, 4, cuda_device, torch.float64)
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    for wp in (False, True):
        got = CD.trace_multi_df32(plans, st, with_path=wp)
        want = CD.trace_multi_df32_reference(plans, st, with_path=wp)
        torch.cuda.synchronize()
        assert len(got) == 3
        assert sum(_differing_words(_df32_words(g, wp), _df32_words(w, wp))
                   for g, w in zip(got, want)) == 0
    mom = CD.trace_merit_multi_df32(plans, st)
    mref = CD.trace_merit_multi_df32_reference(plans, st)
    for m, r in zip(mom, mref):
        assert float(m[0]) == float(r[0]) > 0
        assert _moments_rel(m, r) <= 1e-13
