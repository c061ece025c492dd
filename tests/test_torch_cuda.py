"""The hand-written CUDA kernels of rayopt_tpu_torch against their
plain PyTorch versions on a CUDA card (marker `cuda`; they skip where
there is none).  This file imports no jax, so it runs on a machine
without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import functools

import numpy as np
from numpy import testing as nptest
import pytest
import torch

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import models
from rayopt_tpu_torch.models import double_gauss
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops.tables import (make_table, rodrigues,
                                         stack_tables, table_at)
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
    "cooke_pose"; "near_flat": the double Gauss with its flat rows at
    c = 1e-12) and its aimed hexapolar bundle (nrays 2^14) at field 0.7
    and the first wavelength, in `dtype` on `device`."""
    from rayopt_tpu_torch.models import (cooke_triplet, doublet,
                                         parabolic_mirror)
    from rayopt_tpu_torch.ops.kernels import with_pose
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = {"doublet": doublet, "cooke": cooke_triplet,
         "cooke_pose": cooke_triplet, "parabolic": parabolic_mirror,
         "double_gauss": double_gauss, "near_flat": double_gauss}[name]()
    tab = s.table()
    if name == "near_flat":
        cur = tab.curvature.clone()
        cur[1:][cur[1:] == 0] = 1e-12
        tab = tab.replace(curvature=cur)
    specs = specialize(tab)
    if name == "cooke_pose":
        specs = with_pose(specs)
    y0, u0, w, _ = bundles_from_system(
        s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=1 << 14,
        distribution="hexapolar", device="cpu")[0]
    state = tuple(c.to(device, dtype).contiguous() for c in (*y0.T, *u0.T))
    return tab, specs, state, w.to(device, dtype)


def _spec_aux(name, tab, specs, state):
    """K8's aux vector for a _spec_case bundle (ray 0 the chief ray): its
    image point from the CPU float64 plain trace, the exit pupil's
    reference-sphere radius and the first wavelength's scale, in the
    rays' dtype on their device."""
    from rayopt_tpu_torch.models import (cooke_triplet, doublet,
                                         parabolic_mirror)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    s = {"doublet": doublet, "cooke": cooke_triplet,
         "cooke_pose": cooke_triplet, "parabolic": parabolic_mirror,
         "double_gauss": double_gauss, "near_flat": double_gauss}[name]()
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double().cpu()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double().cpu()
    yr, _, _ = trace_rays_final(tab.to(device="cpu"), y0, u0, specs=specs)
    aux = torch.cat([yr[0], torch.tensor([-s.image.pupil.distance,
                                          s.wavelengths[0]/s.scale],
                                         dtype=torch.float64)])
    return aux.to(state[0].device, state[0].dtype)


#: float64 K1/K8 against the plain version, of max(1, the output's
#: largest |value|): rounding (the multiply-adds nvcc contracts), save
#: on the doublet, whose first row -- a sphere of c = 1.6/mm 99.9 mm
#: past the input plane -- cancels ~4 digits of its discriminant, so
#: that two roundings of the same ray differ by up to 2.8e-12 of a unit
#: direction at the image (measured on the card; the CPU engines of
#: both packages differ by 5.7e-11 there, tests/test_torch_spec_trace.py)
TRACE_F64_REL = {"doublet": 1e-11}


def _trace_case(name, device, dtype):
    """K1's and K8's inputs: (table, specs, bundle, K8's aux).  A
    _spec_case system, or "vocabulary": vocabulary_table with its object
    row tilted too (each rotated and off-axis branch of the chain: row
    0's frame, a tilted and decentred conic, a fold, a mirror, an
    alternate root and a tilted image row, whose flags reach K8's sphere
    tail), on the bench bundle with ray 0 the chief ray; its aux is that
    ray's image point from the CPU float64 plain trace, a 50 mm
    reference sphere and a 587.56 nm wavelength's scale."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    if name != "vocabulary":
        tab, specs, state, _ = _spec_case(name, device, dtype)
        return tab, specs, state, _spec_aux(name, tab, specs, state)
    tab = vocabulary_table()
    rot = tab.rot.clone()
    rot[0] = rodrigues(torch.tensor([.01, .02, -.015], dtype=torch.float64))
    tab = tab.replace(rot=rot)
    specs = specialize(tab)
    state = _bench_state(1 << 14, 3, device, dtype)
    for c, v in zip(state, (0., 0., 0., 0., 0., 1.)):
        c[0] = v
    yr, _, _ = trace_rays_final(
        tab.to(device="cpu"), torch.tensor([[0., 0., 0.]]).double(),
        torch.tensor([[0., 0., 1.]]).double(), specs=specs)
    aux = torch.cat([yr[0], torch.tensor([50., 587.56e-9/1e-3],
                                         dtype=torch.float64)])
    return tab, specs, state, aux.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["doublet", "cooke", "double_gauss",
                                  "parabolic", "near_flat", "cooke_pose",
                                  "vocabulary"])
def test_specialized_trace_matches_plain_on_card(cuda_device, name, dtype):
    """K1 (trace_final) and K8 (opd_chain) compiled per spec tuple
    (ops.cuda_spec) against their plain versions on aimed bundles (the
    Cooke also with its pose flags forced on; the vocabulary table, every
    rotated and off-axis branch, on the bench bundle), clip off and on
    (1.5x wider clipped, so that apertures vignette; not the doublet,
    which has no finite aperture: widened, its rays only graze its first
    sphere, where rounding decides a hit, and not the vocabulary table,
    whose first aperture already clips the bench bundle): one launch a
    call;
    NaN exactly where the plain version is NaN in
    float64, the masks differing on at most 1e-4 of the rays in float32
    (a ray on an aperture's edge).  On the rays live in every version
    compared, each output of its scale, max(1, its largest |value|):
    float64 within 1e-12 (TRACE_F64_REL on the doublet); float32 against
    the float64 plain version on the same inputs within 5e-5 (K1: a few
    ulp of the ~30 mm intermediates, as test_kernels_match_plain_on_card)
    or 1e-5 (K8: k is a ~1e5-wave path, as
    test_opd_kernels_match_plain_on_card), or ten times the float32 plain
    version's own error where that is larger (the doublet's first
    intercept, above).  No rays give empty outputs and no launch."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    tab, specs, state0, aux = _trace_case(name, cuda_device, dtype)
    f64 = dtype == torch.float64
    CS.prebuild([make(specs, dtype, clip) for clip in (0, 1)
                 for make in (CS.trace_key, CS.opd_key)])
    n = state0[0].shape[0]

    def check(got, ref, ref64, tol, tag):
        for q, (g, r, r64) in enumerate(zip(got, ref, ref64)):
            assert g.dtype == dtype and g.device.type == "cuda"
            assert g.shape == r.shape == (n,)
            gn, rn = torch.isnan(g), torch.isnan(r)
            assert int((gn != rn).sum()) <= (0 if f64 else 1e-4*n), (
                tag, q)
            both = ~(gn | rn) & torch.isfinite(r64)
            if not bool(both.any()):
                continue
            g, r, r64 = (v[both].double() for v in (g, r, r64))
            scale = max(float(r64.abs().max()), 1.)
            err = float((g - r64).abs().max())
            if f64:
                lim = TRACE_F64_REL.get(name, 1e-12)*scale
            else:
                lim = max(tol*scale, 10*float((r - r64).abs().max()))
            assert err <= lim, (tag, q, err, lim)
    widen = 1. if name in ("doublet", "vocabulary") else 1.5
    for clip in (False, True):
        state = tuple(c*widen if clip and i < 2 else c
                      for i, c in enumerate(state0))
        state64 = tuple(c.double() for c in state)
        before = CT.trace_final.launches, CG.opd_chain.launches
        got, t = CT.trace_final(tab, specs, state, clip)
        k = CG.opd_chain(tab, specs, state, aux, clip)
        torch.cuda.synchronize()
        assert (CT.trace_final.launches, CG.opd_chain.launches) == (
            before[0] + 1, before[1] + 1)
        ref, tref = CT.trace_final_reference(tab, specs, state, clip)
        ref64, tref64 = CT.trace_final_reference(tab, specs, state64, clip)
        assert clip or bool(torch.isfinite(ref[3]).any())
        check((*got, t), (*ref, tref), (*ref64, tref64), 5e-5, ("K1", clip))
        kref = CG.opd_chain_reference(tab, specs, state, aux, clip)
        assert clip or bool(torch.isfinite(kref[0]).any())
        check(k, kref, CG.opd_chain_reference(tab, specs, state64,
                                              aux.double(), clip),
              1e-5, ("K8", clip))
        empty = tuple(c[:0] for c in state)
        got, t = CT.trace_final(tab, specs, empty, clip)
        k = CG.opd_chain(tab, specs, empty, aux, clip)
        assert all(c.shape == (0,) for c in (*got, t, *k))
        assert (CT.trace_final.launches, CG.opd_chain.launches) == (
            before[0] + 1, before[1] + 1)


def _rel(got, want):
    """max |got - want| over the pairs, of the largest |want| (the error
    itself where want is all zero)."""
    scale = max(float(v.abs().max()) for v in want)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    return err/scale if scale else err


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
                    got = _rel([pg[:, cols]], [want[:, cols]])
                    lim = 1e-9 if f64 else max(
                        1e-3, 10*_rel([own[:, cols]], [want[:, cols]]))
                    assert got <= lim, (fields, rays, cols, got, lim)
                if not rays:
                    assert cst is None and cw is None
                    continue
                # dead rays are exact zeros in both (a live ray's weight
                # cotangent may round to zero too, so no mask test here)
                for kind in (slice(0, 3), slice(3, 6)):
                    got = _rel(cst[kind], truth[1][kind])
                    lim = 1e-8 if f64 else max(
                        1e-2, 10*_rel(plain[1][kind], truth[1][kind]))
                    assert got <= lim, (fields, kind, got, lim)
                got = _rel([cw], [truth[2]])
                lim = 1e-8 if f64 else max(1e-2,
                                           10*_rel([plain[2]], [truth[2]]))
                assert got <= lim, (fields, "w", got, lim)


def _moment_errors(got, want):
    """|got - want| of each of five (weighted) moments, each of its
    scale: the weight sum, then sum x, sum y floored at the weight sum
    (1 mm a unit weight) and sum x^2, sum y^2 floored the same way, as
    in chip_smoke.compare_wmoments (the spot RMS of float32 moments
    cancels off axis, E[x^2] - c^2)."""
    wsum, sxx, syy = (float(want[i]) for i in (0, 3, 4))
    scale = (wsum, max((wsum*sxx)**.5, wsum), max((wsum*syy)**.5, wsum),
             max(sxx, wsum), max(syy, wsum))
    return [abs(float(g) - float(r))/max(sc, 1e-300)
            for g, r, sc in zip(got, want, scale)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["doublet", "cooke", "double_gauss",
                                  "parabolic", "near_flat"])
def test_specialized_merit_matches_plain_on_card(cuda_device, name, dtype):
    """K2 compiled per spec tuple (ops.cuda_spec) against its plain
    version on aimed bundles, clip off and on: one launch a call, the
    count exact in float64, each moment within 1e-12 of its scale in
    float64 and 1e-4 in float32 (K4's tolerances above); no rays give
    zeros and no launch."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    tab, specs, state, _ = _spec_case(name, cuda_device, dtype)
    f64 = dtype == torch.float64
    CS.prebuild([CS.merit_key(specs, dtype, clip) for clip in (0, 1)])
    for clip in (False, True):
        before = CT.trace_merit.launches
        mom = CT.trace_merit(tab, specs, state, clip)
        mref = CT.trace_merit_reference(tab, specs, state, clip)
        torch.cuda.synchronize()
        assert CT.trace_merit.launches == before + 1
        assert all(m.dim() == 0 and m.dtype == dtype
                   and m.device.type == "cuda" for m in mom)
        if f64:
            assert float(mom[0]) == float(mref[0]), clip
        if float(mref[0]) == 0:
            assert float(mom[0]) == 0
            continue
        errs = _moment_errors(mom, mref)
        assert max(errs) <= (1e-12 if f64 else 1e-4), (clip, errs)
        empty = tuple(c[:0] for c in state)
        got = CT.trace_merit(tab, specs, empty, clip)
        assert CT.trace_merit.launches == before + 1
        assert all(float(m) == 0 for m in got)


#: K7's slot sets: the achromatization loop's (curvature, distance and
#: the glasses' mu) and every field
MULTI_SLOT_SETS = (("curvature", "offset", "mu"), ("curvature", "conic",
                                                    "offset", "mu"))
#: the visible wavelengths of the nlam = 7 stack
SEVEN_WAVELENGTHS = (587.56e-9, 656.27e-9, 486.13e-9, 435.83e-9, 546.07e-9,
                     706.52e-9, 404.66e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["doublet", "cooke"])
def test_specialized_multi_adjoint_matches_plain_on_card(cuda_device, name,
                                                         dtype):
    """K6 and K7 compiled per spec tuple (ops.cuda_spec) against their
    plain versions on stacks of 1, 3 and 7 wavelengths, clip off and
    on, K6 at K4's tolerances above (each moment of its scale, 1e-12 in
    float64, 1e-4 in float32; no rays give zeros and no launch), K7 for
    the achromatization loop's slot set and for every field, with and
    without the ray cotangents: one launch a call, the slots that are
    not live exact zeros.  As K5 above: float64 within 1e-9 of each
    field's largest cotangent (rays 1e-8), float32 against the float64
    plain version within 1e-3 (rays 1e-2) or ten times the float32
    plain version's own error.  The ray cotangents are held on the
    rays whose liveness K1 and both plain versions judge alike at every
    wavelength (a float32 ray on an aperture's edge may clip at one
    wavelength in one version only)."""
    from rayopt_tpu_torch.models import cooke_triplet, doublet
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.tables import table_at
    s = {"doublet": doublet, "cooke": cooke_triplet}[name]()
    _, specs, state, w = _spec_case(name, cuda_device, dtype)
    f64 = dtype == torch.float64
    state64 = tuple(c.double() for c in state)
    stacks = (s.wavelengths[:1], s.wavelengths[:3], SEVEN_WAVELENGTHS)
    CS.prebuild([CS.adjoint_multi_key(specs, dtype, clip, fields, rays)
                 for clip in (0, 1) for fields in MULTI_SLOT_SETS
                 for rays in (0, 1)]
                + [CS.moments_multi_key(specs, dtype, clip, len(lams))
                   for clip in (0, 1) for lams in stacks])
    for lams, clip in ((lams, clip) for lams in stacks for clip in (0, 1)):
        tabs = s.tables(lams)
        nlam = len(lams)
        mref = CG.weighted_moments_multi_reference(tabs, specs, state, w,
                                                   clip)
        before = CG.weighted_moments_multi.launches
        mom = CG.weighted_moments_multi(tabs, specs, state, w, clip)
        torch.cuda.synchronize()
        assert CG.weighted_moments_multi.launches == before + 1
        assert mom.shape == (nlam, 5) and mom.dtype == dtype
        for li in range(nlam):
            if float(mref[li, 0]) == 0:
                assert float(mom[li, 0]) == 0
                continue
            errs = _moment_errors(mom[li], mref[li])
            assert max(errs) <= (1e-12 if f64 else 1e-4), (nlam, clip, li,
                                                           errs)
        empty = tuple(c[:0] for c in state)
        got = CG.weighted_moments_multi(tabs, specs, empty, w[:0], clip)
        assert CG.weighted_moments_multi.launches == before + 1
        assert got.shape == (nlam, 5) and not bool(got.any())
        ct = _union_cotangent(mref)
        plain = CG.merit_adjoint_multi_reference(tabs, specs, state, w, ct,
                                                 clip)
        truth = CG.merit_adjoint_multi_reference(
            tabs, specs, state64, w.double(), ct.double(), clip)
        agree = torch.ones_like(w, dtype=torch.bool)
        for li in range(nlam):
            one = table_at(tabs, li)
            lives = [CG._live(f(one, specs, st, clip)[0]) for f, st in (
                (CT.trace_final, state), (CT.trace_final_reference, state),
                (CT.trace_final_reference, state64))]
            agree &= (lives[0] == lives[1]) & (lives[1] == lives[2])
        for fields, rays in ((f, r) for f in MULTI_SLOT_SETS
                             for r in (False, True)):
            live = CS.live_mask(CS.live_slots(specs, fields)).to(cuda_device)
            before = CG.merit_adjoint_multi.launches
            pg, cst, cw = CG.merit_adjoint_multi(tabs, specs, state, w, ct,
                                                 clip, fields=fields,
                                                 rays=rays)
            torch.cuda.synchronize()
            tag = (nlam, clip, fields, rays)
            assert CG.merit_adjoint_multi.launches == before + 1
            assert pg.shape == (nlam, len(specs), CG.SLOTS)
            assert torch.isfinite(pg).all()
            assert not bool(pg[:, ~live].any()), tag
            for li in range(nlam):
                want = torch.where(live, truth[0][li], 0.)
                own = torch.where(live, plain[0][li].double(), 0.)
                for cols in ((0,), (1,), (2, 3, 4), (5,)):
                    got = _rel([pg[li][:, cols]], [want[:, cols]])
                    lim = 1e-9 if f64 else max(
                        1e-3, 10*_rel([own[:, cols]], [want[:, cols]]))
                    assert got <= lim, (tag, li, cols, got, lim)
            if not rays:
                assert cst is None and cw is None
                continue
            for got, pl, want in ((cst[:3], plain[1][:3], truth[1][:3]),
                                  (cst[3:], plain[1][3:], truth[1][3:]),
                                  ((cw,), (plain[2],), (truth[2],))):
                assert all(bool(torch.isfinite(g).all()) for g in got)
                got, pl, want = ([v[agree] for v in t]
                                 for t in (got, pl, want))
                err = _rel(got, want)
                lim = 1e-8 if f64 else max(1e-2, 10*_rel(pl, want))
                assert err <= lim, (tag, err, lim)


def _opd_case(name, device, dtype, seed=7):
    """A system's table and specs, its aimed hexapolar bundle (nrays
    2^14) at field 0.7 and the first wavelength (ray 0 the chief ray),
    K8's aux vector (the chief ray's image point from the CPU plain
    trace, the exit pupil's reference-sphere radius, the wavelength's
    scale) and seeded cotangents on k and both landing coordinates, in
    `dtype` on `device`."""
    from rayopt_tpu_torch.models import cooke_triplet, doublet
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = {"doublet": doublet, "cooke": cooke_triplet}[name]()
    tab = s.table()
    specs = specialize(tab)
    y0, u0, _, _ = bundles_from_system(
        s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=1 << 14,
        distribution="hexapolar", device="cpu")[0]
    yr, _, _ = trace_rays_final(s.table(device="cpu"), y0[:1], u0[:1],
                                specs=specs)
    aux = torch.cat([yr[0], torch.tensor([-s.image.pupil.distance,
                                          s.wavelengths[0]/s.scale])])
    rng = np.random.RandomState(seed)
    cts = tuple(torch.from_numpy(rng.normal(size=y0.shape[0])).to(device,
                                                                   dtype)
                for _ in range(3))
    state = tuple(c.to(device, dtype).contiguous() for c in (*y0.T, *u0.T))
    return tab, specs, state, aux.to(device, dtype), cts


#: K9's slot sets: the design loop's (curvature, distance) and every field
OPD_SLOT_SETS = (("curvature", "offset"), ("curvature", "conic", "offset",
                                           "mu", "n_before"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["doublet", "cooke"])
def test_specialized_opd_adjoint_matches_plain_on_card(cuda_device, name,
                                                       dtype):
    """K9 compiled per spec tuple against its plain version, clip off and
    on (the bundle 1.5x wider clipped, so that apertures vignette), for
    the design loop's slot set and for every field, with and without the
    ray cotangents: one launch a call, the slots that are not live exact
    zeros, the centre cotangents always.  Tolerances as
    test_opd_kernels_match_plain_on_card: float64 within 1e-9 of each
    column's sum of |term|, ray cotangents within 1e-8 of their kind's
    largest (the fused multiply-adds nvcc contracts, as for K5 above:
    3.4e-9 on the doublet's clipped bundle).  Float32 against the
    float64 plain version on the same inputs, as K5 above: the sums
    within 1e-2 of the sum of |term|, the ray cotangents within 1e-3 of
    their kind's largest, or ten times the float32 plain version's own
    error where that is larger (on the doublet, whose path is nearly
    stationary, the float32 plain version is 1.7e-2 of the sum off in
    mu and 7.2e-3 of the largest off in the ray directions on the
    CPU).  Cotangents sit on the rays live in every version compared."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    f64 = dtype == torch.float64
    tab, specs, state0, aux, cts0 = _opd_case(name, cuda_device, dtype)
    CS.prebuild([CS.opd_adjoint_key(specs, dtype, clip, fields, rays)
                 for clip in (0, 1) for fields in OPD_SLOT_SETS
                 for rays in (0, 1)])

    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    for clip in (False, True):
        state = tuple(c*1.5 if clip and i < 2 else c
                      for i, c in enumerate(state0))
        state64 = tuple(c.double() for c in state)
        got = CG.opd_chain(tab, specs, state, aux, clip)
        ref = CG.opd_chain_reference(tab, specs, state, aux, clip)
        ref64 = CG.opd_chain_reference(tab, specs, state64, aux.double(),
                                       clip)
        same = (torch.isfinite(got[0]) & torch.isfinite(ref[0])
                & torch.isfinite(ref64[0]))
        cts = tuple(torch.where(same, c, 0.) for c in cts0)
        cts64 = tuple(c.double() for c in cts)
        pr, sr, cr = CG.opd_adjoint_reference(tab, specs, state, aux, cts,
                                              clip)
        base, sr64, base_c = CG.opd_adjoint_reference(
            tab, specs, state64, aux.double(), cts64, clip)
        mass, _, mass_c = CG.opd_adjoint_reference(
            tab, specs, state64, aux.double(), tuple(c.abs() for c in cts64),
            clip)
        if f64:
            base, sr64, base_c = pr, sr, cr
        sum_tol = 1e-9 if f64 else 1e-2
        for fields, rays in ((f, r) for f in OPD_SLOT_SETS
                             for r in (False, True)):
            live = CS.live_mask(CS.opd_live_slots(specs, fields),
                                CG.OPD_SLOTS).to(cuda_device)
            before = CG.opd_adjoint.launches
            pg, cst, cc = CG.opd_adjoint(tab, specs, state, aux, cts, clip,
                                         fields=fields, rays=rays)
            torch.cuda.synchronize()
            tag = (clip, fields, rays)
            assert CG.opd_adjoint.launches == before + 1
            assert pg.shape == (len(specs), CG.OPD_SLOTS)
            assert torch.isfinite(pg).all() and torch.isfinite(cc).all()
            assert not bool(pg[~live].any()), tag
            want = torch.where(live, base, 0.)
            for col in range(CG.OPD_SLOTS):
                limit = sum_tol*float(mass[:, col].abs().max())
                if not f64:
                    own = torch.where(live[:, col], pr[:, col].double(), 0.)
                    limit = max(limit, 10*err(own, want[:, col]))
                assert err(pg[:, col], want[:, col]) <= limit, (tag, col)
            assert err(cc, base_c) <= sum_tol*float(mass_c.abs().max()), tag
            if not rays:
                assert cst is None
                continue
            assert not any(bool(c[~torch.isfinite(got[0])].any())
                           for c in cst)
            for kind in (slice(0, 3), slice(3, 6)):
                assert all(bool(torch.isfinite(g).all()) for g in cst[kind])
                tol = 1e-8 if f64 else max(
                    1e-3, 10*_rel(sr[kind], sr64[kind]))
                assert _rel(cst[kind], sr64[kind]) <= tol, (tag, kind)


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
@pytest.mark.parametrize("nlam", [3, 12, 40])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trace_multi_matches_plain_on_card(cuda_device, dtype, nlam):
    """K3's keys, trace and merit, on double Gauss stacks of 3, 12 and
    40 wavelengths (400-700 nm; past MAX_NLAM in balanced runs, one
    launch a run) against trace_multi_reference: the trace within the
    bounds of test_multi_kernels_match_plain_on_card, the moments
    within those of test_specialized_merit_matches_plain_on_card (each
    of its scale: the float32 spot RMS cancels off axis), the count
    exact, and in float64 the spot RMS within 1e-10."""
    tabs = double_gauss().tables(list(np.linspace(400e-9, 700e-9, nlam)))
    specs = CT.multi_specs(tabs, None)
    state = _bench_state(1 << 16, 6, cuda_device, dtype)
    f64 = dtype == torch.float64
    runs = CS.runs(nlam, CS.multi_most("k3", specs, dtype))
    mruns = CS.runs(nlam, CS.multi_most("k3m", specs, dtype))
    before = CT.trace_multi.launches
    got = CT.trace_multi(tabs, specs, state)
    assert CT.trace_multi.launches == before + len(runs)
    mom = CT.trace_multi(tabs, specs, state, merit=True)
    assert CT.trace_multi.launches == before + len(runs) + len(mruns)
    ref = CT.trace_multi_reference(tabs, specs, state)
    mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
    torch.cuda.synchronize()
    assert len(got) == len(mom) == nlam
    assert len(runs) == (1 if nlam <= CS.MAX_NLAM else -(-nlam // 11))
    tol = 1e-12*30 if f64 else 5e-5
    for (g, t), (r, tr) in zip(got, ref):
        for a, b in zip((*g, t), (*r, tr)):
            assert a.dtype == dtype and a.device.type == "cuda"
            a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
            nptest.assert_array_equal(np.isnan(a), np.isnan(b))
            nptest.assert_allclose(a, b, atol=tol, rtol=tol, equal_nan=True)
    for m, r in zip(mom, mref):
        assert float(m[0]) == float(r[0])
        assert max(_moment_errors(m, r)) <= (1e-12 if f64 else 1e-4)
        if f64:
            nptest.assert_allclose(float(CT.spot_rms_from_moments(*m)),
                                   float(CT.spot_rms_from_moments(*r)),
                                   rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cooke_triplet", "double_gauss"])
def test_pupils_on_card_match_cpu(cuda_device, name):
    """System.pupils on a CUDA table (ops.aiming, plain torch ops)
    against the same solve on the CPU at 8 fields, on and off the
    meridian: z and boxes within 1e-9 relative, every field converged
    (no host fallback warned).  Its loops do not synchronise with the
    host: the chief Newton and a marginal bisection run under
    torch.cuda.set_sync_debug_mode("error") on inputs already on the
    card."""
    import warnings
    from rayopt_tpu_torch.ops import aiming as TA
    s = getattr(models, name)()
    fields = np.stack([np.linspace(0., .3, 8), np.linspace(0., 1., 8)], 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        z, boxes = s.pupils(fields, device=cuda_device)
        zc, bc = s.pupils(fields, device="cpu")
    for got, want in ((z, zc), (boxes, bc)):
        nptest.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9*np.abs(want).max())
    tab = s.table(device=cuda_device)
    specs = specialize(tab)
    prepared = TA._prepared(tab)
    f = torch.from_numpy(fields).to(cuda_device)
    z0 = torch.tensor(s.object.pupil.distance, dtype=torch.float64,
                      device=cuda_device)
    slope = torch.tensor(np.tan(s.object.angle), dtype=torch.float64,
                         device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        zd = TA.aim_chief_batched(prepared, f, z0, s.stop, specs=specs,
                                  slope=slope)
        ad = TA.aim_marginal_batched(prepared, f, zd, s.object.pupil.radius,
                                     s.stop, specs=specs, slope=slope)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    nptest.assert_allclose(zd.cpu().numpy(), zc, rtol=1e-9)
    nptest.assert_allclose(ad.cpu().numpy(), bc[:, 1, 1], rtol=1e-9)


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


def _df32_multi_case(name, clip, fast):
    """The plans and the df32 bundle of one K11/K13 case: the double
    Gauss at its 3 wavelengths; "mixed", those plans with the second
    one's fast flag flipped (a second flag tuple); the vocabulary table
    and its twin with every refracting row's mu scaled (one tuple).  The
    bench bundle, 1.5x wide when clipped."""
    if name == "vocabulary":
        tab = vocabulary_table()
        mu = tab.mu
        tabs = [tab, tab.replace(mu=torch.where(mu.abs() != 1., mu*1.01,
                                                mu))]
    else:
        s = double_gauss()
        tabs = [s.table(lam) for lam in s.wavelengths]
    plans = [D.plan(t, clip=clip, fast=fast != (name == "mixed" and i == 1))
             for i, t in enumerate(tabs)]
    state64 = _bench_state(1 << 16, 5, torch.device("cuda"), torch.float64)
    if clip:
        state64 = tuple(c*1.5 if i < 2 else c for i, c in enumerate(state64))
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    return plans, st


#: (name, fast, clip, staged) of the K11/K13 cases: every system fast
#: and exact, clip off and on, each kernel reading its plan words as its
#: key does by default (staged None); the double Gauss also the other
#: way ("other")
DF32_MULTI_CASES = (
    [(name, fast, clip, None) for name in ("double_gauss", "vocabulary",
                                           "mixed")
     for fast in (True, False) for clip in (False, True)]
    + [("double_gauss", fast, False, "other") for fast in (True, False)])


def _df32_multi_staged(staged, kernel):
    default = CS.DF32_STAGED[kernel]
    return (not default) if staged == "other" else default


@functools.lru_cache(maxsize=None)
def _prebuild_df32_multi():
    """Build every key of DF32_MULTI_CASES at once (one nvcc a key, in
    parallel), the first time a case asks."""
    keys = []
    for name, fast, clip, staged in DF32_MULTI_CASES:
        plans, _ = _df32_multi_case(name, clip, fast)
        keys += [CS.df32_multi_key(plans, "k11", wp, staged=(
            _df32_multi_staged(staged, "k11"))) for wp in (False, True)]
        keys.append(CS.df32_multi_key(
            plans, "k13", staged=_df32_multi_staged(staged, "k13")))
    CS.prebuild(keys)


@pytest.mark.cuda
@pytest.mark.parametrize("name,fast,clip,staged", DF32_MULTI_CASES)
def test_specialized_df32_multi_matches_plain_on_card(cuda_device, name,
                                                      fast, clip, staged,
                                                      monkeypatch):
    """K11 and K13 compiled per plan key (csrc/df32_spec.cuh, two_prod
    in its FMA form, the plan words read from the kernel's parameters or
    from a shared-memory copy) against their plain versions on the
    card: the double Gauss
    at its 3 wavelengths, the vocabulary table (every branch: rot_df,
    the permutation fold, a mirror, an alternate root, a conic, off
    axis, the tilted image row) at 2 plans, and plans of two flag
    tuples.  K11: identical words, path on and off; K13: the same count
    and the moments within 1e-13 of their scale (another order of
    summation).  One launch a call, none for no rays."""
    _prebuild_df32_multi()

    def kernel(kind, flags, with_path):
        return CS.load(CS.df32_key_of(flags, kind, with_path, staged=(
            _df32_multi_staged(staged, kind))))
    monkeypatch.setattr(CD, "_multi_kernel", kernel)
    plans, st = _df32_multi_case(name, clip, fast)
    key = CS.df32_multi_key(plans, "k13")
    assert len(key.tuples) == (2 if name == "mixed" else 1)
    before = CD.trace_multi_df32.launches, CD.trace_merit_multi_df32.launches
    for wp in (False, True):
        got = CD.trace_multi_df32(plans, st, with_path=wp)
        want = CD.trace_multi_df32_reference(plans, st, with_path=wp)
        torch.cuda.synchronize()
        assert len(got) == len(plans)
        assert sum(_differing_words(_df32_words(g, wp), _df32_words(w, wp))
                   for g, w in zip(got, want)) == 0
    mom = CD.trace_merit_multi_df32(plans, st)
    mref = CD.trace_merit_multi_df32_reference(plans, st)
    assert len(mom) == len(plans)
    for m, r in zip(mom, mref):
        assert float(m[0]) == float(r[0]) > 0
        assert _moments_rel(m, r) <= 1e-13
    assert (CD.trace_multi_df32.launches,
            CD.trace_merit_multi_df32.launches) == (before[0] + 2,
                                                    before[1] + 1)
    empty = tuple((h[:0], lo[:0]) for h, lo in st)
    out = CD.trace_multi_df32(plans, empty, with_path=True)
    zero = CD.trace_merit_multi_df32(plans, empty)
    assert out[0][0][0][0].shape == (0,) and float(zero[-1][0]) == 0.
    assert (CD.trace_multi_df32.launches,
            CD.trace_merit_multi_df32.launches) == (before[0] + 2,
                                                    before[1] + 1)


# -- K10 and K12 per plan key; the wrappers' split ---------------------------

#: (name, fast, clip, placement) of the K10/K12 cases: every system fast
#: and exact, clip off and on, at the one-plan keys' default placement
#: (None); the double Gauss also reading its words from the other two
#: placements (cuda_spec.WORDS_AT: 0 parameters, 1 a shared copy of
#: them, 2 device words)
DF32_ONE_CASES = (
    [(name, fast, clip, None) for name in ("double_gauss", "vocabulary",
                                           "cooke")
     for fast in (True, False) for clip in (False, True)]
    + [("double_gauss", fast, False, at) for fast in (True, False)
       for at in (0, 1, 2)])


def _df32_one_case(name, clip, fast):
    """The plan and the df32 bundle of one K10/K12 case (the bench
    bundle, 1.5x wide when clipped)."""
    from rayopt_tpu_torch.models import cooke_triplet
    tab = {"double_gauss": lambda: double_gauss().table(),
           "vocabulary": vocabulary_table,
           "cooke": lambda: cooke_triplet().table()}[name]()
    state64 = _bench_state(1 << 16, 8, torch.device("cuda"), torch.float64)
    if clip:
        state64 = tuple(c*1.5 if i < 2 else c for i, c in enumerate(state64))
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    return D.plan(tab, clip=clip, fast=fast), st


def _one_plan_key(plan, kind, with_path, at):
    if at is None:
        return CS.df32_multi_key([plan], kind, with_path)
    return CS.df32_multi_key([plan], kind, with_path, staged=at > 0,
                             device_words=at == 2)


@functools.lru_cache(maxsize=None)
def _prebuild_df32_one():
    """Build every key of DF32_ONE_CASES at once, the first time a case
    asks."""
    keys = []
    for name, fast, clip, at in DF32_ONE_CASES:
        plan, _ = _df32_one_case(name, clip, fast)
        keys += [_one_plan_key(plan, "k11", wp, at) for wp in (False, True)]
        keys.append(_one_plan_key(plan, "k13", False, at))
    CS.prebuild(keys)


@pytest.mark.cuda
@pytest.mark.parametrize("name,fast,clip,at", DF32_ONE_CASES)
def test_specialized_df32_one_plan_matches_plain_on_card(cuda_device, name,
                                                         fast, clip, at,
                                                         monkeypatch):
    """K10 and K12 compiled per plan key (df32_multi_key([plan]),
    csrc/df32_spec.cuh) against their plain versions on the card: the
    double Gauss, the vocabulary table (every branch) and the Cooke
    triplet, fast and exact, clip off and on, each placement of the plan
    words.  K10: identical words, path on and off; K12: the same count
    and the moments within 1e-13 of their scale.  One launch a call,
    none for no rays."""
    _prebuild_df32_one()
    plan, st = _df32_one_case(name, clip, fast)

    def kernel(kind, flags, with_path):
        key = _one_plan_key(plan, kind, with_path, at)
        assert CS.df32_flags([plan]) == flags and key.nlam == 1
        return CS.load(key)
    monkeypatch.setattr(CD, "_multi_kernel", kernel)
    before = CD.trace_final_df32.launches, CD.trace_merit_df32.launches
    for wp in (False, True):
        got = CD.trace_final_df32(plan, st, with_path=wp)
        want = CD.trace_final_df32_reference(plan, st, with_path=wp)
        torch.cuda.synchronize()
        assert _differing_words(_df32_words(got, wp),
                                _df32_words(want, wp)) == 0
    mom = CD.trace_merit_df32(plan, st)
    mref = CD.trace_merit_df32_reference(plan, st)
    assert all(m.dtype == torch.float64 and m.dim() == 0 for m in mom)
    assert float(mom[0]) == float(mref[0]) > 0
    assert _moments_rel(mom, mref) <= 1e-13
    assert (CD.trace_final_df32.launches,
            CD.trace_merit_df32.launches) == (before[0] + 2, before[1] + 1)
    empty = tuple((h[:0], lo[:0]) for h, lo in st)
    out = CD.trace_final_df32(plan, empty, with_path=True)
    zero = CD.trace_merit_df32(plan, empty)
    assert out[0][0][0].shape == (0,) and float(zero[0]) == 0.
    assert (CD.trace_final_df32.launches,
            CD.trace_merit_df32.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_df32_long_plan_on_device_words_on_card(cuda_device):
    """A 300-step plan (the Cooke triplet's steps repeated), past the
    kernel parameters: K10 and K12 take its device-words key and give
    the plain versions' words and moments."""
    from rayopt_tpu_torch.models import cooke_triplet
    plan = D.plan(cooke_triplet().table(), fast=True)
    plan = (plan*(-(-300 // len(plan))))[:300]
    keys = [CS.df32_multi_key([plan], "k11", True),
            CS.df32_multi_key([plan], "k13")]
    assert all(k.device_words and k.steps == 300 for k in keys)
    CS.prebuild(keys)
    state64 = _bench_state(1 << 14, 9, cuda_device, torch.float64)
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    got = CD.trace_final_df32(plan, st, with_path=True)
    want = CD.trace_final_df32_reference(plan, st, with_path=True)
    assert _differing_words(_df32_words(got, True),
                            _df32_words(want, True)) == 0
    assert bool(torch.isfinite(got[0][0][0]).any())
    mom = CD.trace_merit_df32(plan, st)
    mref = CD.trace_merit_df32_reference(plan, st)
    assert float(mom[0]) == float(mref[0]) > 0
    assert _moments_rel(mom, mref) <= 1e-13


@pytest.mark.cuda
def test_df32_multi_splits_24_plans_on_card(cuda_device):
    """K11 and K13 on 24 double Gauss plans (one a wavelength in 400-700
    nm), past one key's kernel parameters: two launches each (12 + 12),
    identical words and moments within 1e-13 of their scale."""
    s = double_gauss()
    lams = [float(v) for v in np.linspace(400e-9, 700e-9, 24)]
    plans = [D.plan(s.table(lam), fast=True) for lam in lams]
    state64 = _bench_state(1 << 16, 10, cuda_device, torch.float64)
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    before = CD.trace_multi_df32.launches, CD.trace_merit_multi_df32.launches
    got = CD.trace_multi_df32(plans, st, with_path=True)
    want = CD.trace_multi_df32_reference(plans, st, with_path=True)
    torch.cuda.synchronize()
    assert len(got) == 24
    assert sum(_differing_words(_df32_words(g, True), _df32_words(w, True))
               for g, w in zip(got, want)) == 0
    mom = CD.trace_merit_multi_df32(plans, st)
    mref = CD.trace_merit_multi_df32_reference(plans, st)
    assert len(mom) == 24
    for m, r in zip(mom, mref):
        assert float(m[0]) == float(r[0]) > 0
        assert _moments_rel(m, r) <= 1e-13
    assert (CD.trace_multi_df32.launches,
            CD.trace_merit_multi_df32.launches) == (before[0] + 2,
                                                    before[1] + 2)


# -- K10-K13 on the Newton rows -----------------------------------------------

def _port_system(rows, pupil=4.):
    """A port System from element dicts, its pupil radius fixed."""
    from rayopt_tpu_torch import System
    s = System(rows)
    s.object.pupil.radius = pupil
    s.object.pupil.update_radius = False
    s.update()
    return s


def _split_biconic(figure=None):
    """The JAX package's split-conic biconic lens (its
    tests/test_anamorphic.py), with an even figure on its first row."""
    s = _port_system([
        dict(material="air"),
        dict(type="biconic", roc=25.84, curvature_x=.013, distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="biconic", distance=3., material="air", radius=10.),
        dict(distance=47., radius=10.)])
    s[1].conic, s[1].conic_x = -.4, .25
    if figure:
        s[1].aspherics = list(figure)
    s.update()
    return s


def _toroid_lens(figure=None):
    """The JAX package's toroid lens, with an even figure on its first
    toroid's generating curve."""
    s = _port_system([
        dict(material="air"),
        dict(type="toroid", roc=51.68, roc_rotation=200., distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="toroid", distance=3., material="air", radius=10.),
        dict(distance=95., radius=20.)])
    if figure:
        s[1].aspherics = list(figure)
        s.update()
    return s


def _aspheric_double_gauss():
    s = double_gauss()
    s[2].conic, s[5].conic = -.7, .4
    s[7].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    return s


def _odd_singlet():
    from rayopt_tpu_torch import Spheroid, System, air
    s = System()
    s.append(Spheroid(material=air, radius=9.))
    s.append(Spheroid(distance=8., curvature=1/45., conic=-.3,
                      aspherics=[0., 2e-7], aspherics_odd=[0., 1e-5, -2e-8],
                      material=1.6, radius=9.))
    s.append(Spheroid(distance=5., curvature=-1/80., material=air,
                      radius=9.))
    s.append(Spheroid(distance=70., material=None, radius=9.))
    s.wavelengths = [587.56e-9]
    s.update()
    return s


#: name: (system factory, bench half width mm) of the Newton lenses:
#: aspheric rows (df32 polish), conic cylinders (closed form), biconic
#: and toroid rows (float32 seed, df32 polish), figured or not
DF32_NEWTON = {
    "aspheric_double_gauss": (_aspheric_double_gauss, 11.6),
    "odd_singlet": (_odd_singlet, 6.),
    "anamorphic_pair": (models.anamorphic_pair, 4.),
    "split_biconic": (_split_biconic, 4.),
    "toroid_lens": (_toroid_lens, 4.),
    "figured_toroid": (lambda: _toroid_lens([1e-5, 2e-8]), 4.),
    "figured_biconic": (lambda: _split_biconic([2e-4, -1e-6]), 4.)}


def _df32_newton_case(name, fast, clip):
    """One Newton lens's plan, its 2 plans for K11/K13 (refracting rows'
    mu grown by 0 and 1 % of mu - 1) and the bench bundle at its half
    width (2.5x wide when clipped: past the lenses' apertures), on the
    card."""
    make, half = DF32_NEWTON[name]
    tab = make().table()
    tabs = [tab, tab.replace(mu=torch.where(tab.mu.abs() != 1.,
                                            1 + (tab.mu - 1)*1.01, tab.mu))]
    plans = [D.plan(t, clip=clip, fast=fast) for t in tabs]
    scale = half/11.6*(2.5 if clip else 1.)
    state64 = _bench_state(1 << 16, 12, torch.device("cuda"), torch.float64)
    state64 = tuple(c*scale if i < 2 else c for i, c in enumerate(state64))
    st = D.state_from_f64(torch.stack(state64[:3], 1),
                          torch.stack(state64[3:], 1))
    return plans, st


@functools.lru_cache(maxsize=None)
def _prebuild_df32_newton():
    """Build the keys of every Newton case at once (one nvcc a key, in
    parallel), the first time a case asks."""
    keys = []
    for name in DF32_NEWTON:
        for fast in (True, False):
            for clip in (False, True):
                plans, _ = _df32_newton_case(name, fast, clip)
                keys += [CS.df32_multi_key(plans[:1], "k11", True),
                         CS.df32_multi_key(plans[:1], "k13"),
                         CS.df32_multi_key(plans, "k11", True),
                         CS.df32_multi_key(plans, "k13")]
    CS.prebuild(keys)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("name", sorted(DF32_NEWTON))
def test_df32_newton_kernels_match_plain_on_card(cuda_device, name, fast):
    """K10 and K11 (with the optical path), K12 and K13 on the Newton
    lenses' plans against their plain versions on the card, clip off and
    on: identical words (the kernels round every float32 operation of
    the df32 polish and of the float32 seed as the plain versions do),
    the same live count and the moments within 1e-13 of their scale."""
    _prebuild_df32_newton()
    for clip in (False, True):
        plans, st = _df32_newton_case(name, fast, clip)
        assert any(CD.fig_of(f) for f in CS.df32_flags(plans[:1])[0])
        got = CD.trace_final_df32(plans[0], st, with_path=True)
        want = CD.trace_final_df32_reference(plans[0], st, with_path=True)
        torch.cuda.synchronize()
        assert _differing_words(_df32_words(got, True),
                                _df32_words(want, True)) == 0
        assert bool(torch.isfinite(got[0][0][0]).any())
        got = CD.trace_multi_df32(plans, st, with_path=True)
        want = CD.trace_multi_df32_reference(plans, st, with_path=True)
        torch.cuda.synchronize()
        assert sum(_differing_words(_df32_words(g, True),
                                    _df32_words(w, True))
                   for g, w in zip(got, want)) == 0
        moms = [(CD.trace_merit_df32(plans[0], st),
                 CD.trace_merit_df32_reference(plans[0], st))]
        moms += list(zip(CD.trace_merit_multi_df32(plans, st),
                         CD.trace_merit_multi_df32_reference(plans, st)))
        for m, r in moms:
            assert float(m[0]) == float(r[0]) > 0
            assert _moments_rel(m, r) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("nlam", [12, 13])
def test_polychromatic_adjoint_past_max_nlam_on_card(cuda_device, nlam):
    """glass.polychromatic_spot_rms(engine="adjoint") at 12 and 13
    wavelengths (past K6's MAX_NLAM: its wrapper launches balanced runs,
    6 + 6 and 7 + 6; K7 one launch) on CUDA tensors gives the CPU plain
    versions' merit (rtol 1e-9) and (nd, vd) gradient (1e-8 of its max),
    float64; K6 and K7 hold their plain versions on the card too."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = double_gauss()
    lams = [float(v) for v in np.linspace(400e-9, 700e-9, nlam)]
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    out = {}
    for dev in ("cpu", cuda_device):
        y0, u0, w, _ = bundles_from_system(
            s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=2048,
            distribution="hexapolar", device=dev)[0]
        nd = torch.tensor(nd0, device=dev, requires_grad=True)
        vd = torch.tensor(vd0, device=dev, requires_grad=True)
        before = (CG.weighted_moments_multi.launches,
                  CG.merit_adjoint_multi.launches)
        v = glass.polychromatic_spot_rms(
            glass.glass_tables(s.tables(lams, device=dev), nd, vd, asg,
                               lams), y0, u0, w, engine="adjoint")
        v.backward()
        if dev != "cpu":
            assert (CG.weighted_moments_multi.launches,
                    CG.merit_adjoint_multi.launches) == (before[0] + 2,
                                                         before[1] + 1)
        out[str(dev)] = (float(v.detach()), nd.grad.cpu(), vd.grad.cpu())
    (v_c, gn_c, gv_c), (v_g, gn_g, gv_g) = out["cpu"], out["cuda"]
    nptest.assert_allclose(v_g, v_c, rtol=1e-9)
    for g, r in ((gn_g, gn_c), (gv_g, gv_c)):
        assert float((g - r).abs().max()) <= 1e-8*float(r.abs().max())
    tabs = s.tables(lams, device=cuda_device)
    specs = CT.multi_specs(tabs, None)
    state = _bench_state(1 << 16, 11, cuda_device, torch.float64)
    wt = torch.from_numpy(np.random.RandomState(3).uniform(
        .5, 1.5, 1 << 16)).to(cuda_device, torch.float64)
    mom = CG.weighted_moments_multi(tabs, specs, state, wt)
    mref = CG.weighted_moments_multi_reference(tabs, specs, state, wt)
    assert mom.shape == (nlam, 5)
    for li in range(nlam):
        assert float(mom[li, 0]) == pytest.approx(float(mref[li, 0]),
                                                  rel=1e-12)
        nptest.assert_allclose(float(CT.spot_rms_from_moments(*mom[li])),
                               float(CT.spot_rms_from_moments(*mref[li])),
                               rtol=1e-10)
    ct = _union_cotangent(mref)
    pg, _, _ = CG.merit_adjoint_multi(tabs, specs, state, wt, ct)
    pref, _, _ = CG.merit_adjoint_multi_reference(tabs, specs, state, wt, ct)
    for li in range(nlam):
        for col in range(CG.SLOTS):
            if float(pref[li, :, col].abs().max()):
                assert _max_rel(pg[li, :, col], pref[li, :, col]) <= 1e-9


# -- the aspheric rows: K1, K2, K4 and K5 on figured keys ------------------

def _aspheric_system(name):
    """(system, half-width of its bundle in mm) of an aspheric lens."""
    from rayopt_tpu_torch import Spheroid, System, air
    if name == "double_gauss":
        s = double_gauss()
        s[2].conic = -.7
        s[5].conic = .4
        s[7].aspherics = [0., 1.2e-7, -3e-11]
        height = 11.
    else:
        s = System()
        s.append(Spheroid(material=air, radius=9.))
        s.append(Spheroid(distance=8., curvature=1/45., conic=-.3,
                          aspherics=[0., 2e-7],
                          aspherics_odd=[0., 1e-5, -2e-8], material=1.6,
                          radius=9.))
        s.append(Spheroid(distance=5., curvature=-1/80., material=air,
                          radius=9.))
        s.append(Spheroid(distance=70., material=None, radius=9.))
        s.wavelengths = [587.56e-9]
        height = 8.
    s.update()
    return s, height


def _aspheric_case(name, device, dtype):
    """(table, specs, bundle, weights) of an aspheric lens: the JAX
    package's aspheric double Gauss (two conics and an even asphere on
    row 7, tests/test_df32.py) or odd singlet (an even and odd figure
    on a conic front, tests/test_pallas.py), on 2^16 rays uniform in its
    aperture, none exactly on the axis (an odd figure's gradient is NaN
    there, as the reference's)."""
    s, height = _aspheric_system(name)
    tab = s.table()
    rng = np.random.RandomState(8)
    n = 1 << 16
    xy = rng.uniform(-height, height, (2, n))
    uv = rng.uniform(-.02, .02, (2, n))
    uz = np.sqrt(1 - np.square(uv).sum(0))
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device, dtype)
                  for c in (*xy, np.zeros(n), *uv, uz))
    w = torch.from_numpy(rng.uniform(.5, 1.5, n)).to(device, dtype)
    return tab, specialize(tab), state, w


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["double_gauss", "odd_singlet"])
def test_aspheric_kernels_match_plain_on_card(cuda_device, name, dtype,
                                              clip):
    """K1, K2, K4 and K5 (every field, the ray cotangents) on an aspheric
    lens's figured keys, unclipped and clipped at its apertures, against
    their plain versions on the card: float64 to rounding, float32 a few
    ulp of the intermediate coordinates; the coefficient cotangents
    come back on the aspheric row only."""
    tab, specs, state, w = _aspheric_case(name, cuda_device, dtype)
    widths = CT.figure_widths(tab, specs)
    assert widths != (0, 0)
    before = (CT.trace_final.launches, CT.trace_merit.launches,
              CG.weighted_moments.launches, CG.merit_adjoint.launches)
    got, t = CT.trace_final(tab, specs, state, clip)
    ref, tref = CT.trace_final_reference(tab, specs, state, clip)
    mom = CT.trace_merit(tab, specs, state, clip)
    mref = CT.trace_merit_reference(tab, specs, state, clip)
    wm = CG.weighted_moments(tab, specs, state, w, clip)
    wref = CG.weighted_moments_reference(tab, specs, state, w,
                                           clip)
    ct = _rms_cotangent(wref)
    pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct, clip)
    pref, sref, cwref = CG.merit_adjoint_reference(tab, specs, state, w, ct,
                                                    clip)
    torch.cuda.synchronize()
    assert (CT.trace_final.launches, CT.trace_merit.launches,
            CG.weighted_moments.launches,
            CG.merit_adjoint.launches) == tuple(b + 1 for b in before)
    f64 = dtype == torch.float64
    tol = 1e-12*100 if f64 else 5e-5
    for g, r in zip((*got, t), (*ref, tref)):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        # float32: a ray on the edge of convergence may flip
        if f64:
            nptest.assert_array_equal(np.isnan(g), np.isnan(r))
        live = np.isfinite(g) & np.isfinite(r)
        assert live.mean() > .5
        nptest.assert_allclose(g[live], r[live], atol=tol, rtol=tol)
    assert abs(float(mom[0]) - float(mref[0])) <= (0 if f64
                                                    else 1e-5*(1 << 16))
    nptest.assert_allclose(float(CT.spot_rms_from_moments(*mom)),
                           float(CT.spot_rms_from_moments(*mref)),
                           rtol=1e-10 if f64 else 1e-4)
    nptest.assert_allclose(float(CT.spot_rms_from_moments(*wm)),
                           float(CT.spot_rms_from_moments(*wref)),
                           rtol=1e-10 if f64 else 1e-4)
    assert pg.shape == pref.shape == (tab.nsurfaces, CG.SLOTS + sum(widths))
    fig = [j for j, s in enumerate(specs) if s.aspheric or s.odd]
    assert bool((pg[fig, CG.SLOTS:] != 0).any())
    others = [j for j in range(tab.nsurfaces) if j not in fig]
    assert bool((pg[others, CG.SLOTS:] == 0).all())
    gtol = 1e-9 if f64 else 1e-3
    top = float(pref.double().abs().max())
    for col in range(pg.shape[1]):
        assert torch.isfinite(pg[:, col]).all()
        scale = float(pref[:, col].double().abs().max())
        if scale:
            err = float((pg[:, col].double() - pref[:, col].double())
                        .abs().max())
            assert err <= gtol*max(scale, 1e-9*top), col
    # a dead ray's cotangents are all zero: the same rays are live in
    # float64; float32 compares the rays live in both
    live = (cw != 0) & (cwref != 0)
    if f64:
        assert torch.equal(cw != 0, cwref != 0)
    ray_tol = 1e-9 if f64 else 1e-2
    for got_, want_ in ((cst[:3], sref[:3]), (cst[3:], sref[3:]),
                        ((cw,), (cwref,))):
        scale = max(float(r.abs().max()) for r in want_)
        for g, r in zip(got_, want_):
            assert float((g - r)[live].abs().max()) <= ray_tol*scale


@pytest.mark.cuda
def test_aspheric_designer_step_on_card(cuda_device):
    """optimize_grad(engine="adjoint", select=("curvature", "aspherics"))
    on the aspheric double Gauss: two steps on the card against the same
    call on the CPU plain versions, merit to 1e-9 relative and the
    step-0 gradients to 1e-8 of their largest."""
    from rayopt_tpu_torch.parallel import (bundles_from_system, bundles_to,
                                           optimize_grad)
    s = double_gauss()
    s[2].conic = -.7
    s[5].conic = .4
    s[7].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    tab = s.table()
    bundles = bundles_from_system(s, fields=(0., 1.), nrays=2048,
                                  distribution="hexapolar", device="cpu")
    sel = ("curvature", "aspherics")
    scales = {"aspherics": [1e-4, 1e-7, 1e-11]}
    grads = {}

    def keep(tag):
        def callback(i, value, params):
            if i == 0:
                grads[tag] = {k: v.grad.double().cpu()
                              for k, v in params.items()}
        return callback
    before = CG.merit_adjoint.launches
    _, h_gpu = optimize_grad(tab, bundles_to(bundles, cuda_device),
                             select=sel, steps=2, lr=1e-7, scales=scales,
                             engine="adjoint", callback=keep("gpu"))
    assert CG.merit_adjoint.launches > before
    _, h_cpu = optimize_grad(tab.to(device="cpu"), bundles, select=sel,
                             steps=2, lr=1e-7, scales=scales,
                             engine="adjoint", callback=keep("cpu"))
    nptest.assert_allclose(h_gpu, h_cpu, rtol=1e-9)
    for k in sel:
        g, r = grads["gpu"][k], grads["cpu"][k]
        assert float(r.abs().max()) > 0, k
        assert float((g - r).abs().max()) <= 1e-8*float(r.abs().max()), k


# -- the aspheric rows: K3, K6, K7, K8 and K9 on figured keys ---------------

def _aspheric_stack(name, tab):
    """A stack of 3 tables of an aspheric lens: the double Gauss's 3
    wavelengths; the singlet (one wavelength of a constant index) with
    its refracting rows' mu grown by 0, 1 and 2 % of mu - 1."""
    from rayopt_tpu_torch.ops.tables import stack_tables
    if name == "double_gauss":
        return _aspheric_system(name)[0].tables()
    return stack_tables([tab.replace(mu=1 + (tab.mu - 1)*(1 + .01*li))
                         for li in range(3)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["double_gauss", "odd_singlet"])
def test_aspheric_multi_and_opd_kernels_match_plain_on_card(cuda_device,
                                                            name, dtype):
    """K3 (trace and merit), K6, K7, K8 and K9 on an aspheric lens's
    figured keys (3 tables for the stacked kernels; ray 0 the chief ray,
    off the axis) against their plain versions on the card: float64
    traces and moments to 1e-12, K7's and K9's cotangents to 1e-9 of
    each column's largest (float32: 5e-5 mm, 1e-4 of the moments' and
    1e-2 of the cotangents' scale; the same dead rays in float64, at
    most 1 in 10^4 rays judged otherwise in float32); the coefficient
    cotangents come back on the aspheric rows only, each wrapper
    launches once."""
    tab, specs, state, w = _aspheric_case(name, cuda_device, dtype)
    tabs = _aspheric_stack(name, tab)
    widths = CT.figure_widths(tab, specs)
    state = tuple(c.clone() for c in state)
    for c, v in zip(state, (.5, .3, 0., 0., 0., 1.)):
        c[0] = v
    f64 = dtype == torch.float64
    tol, mtol, gtol = (1e-12, 1e-12, 1e-9) if f64 else (5e-5, 1e-4, 1e-2)
    wrappers = (CT.trace_multi, CG.weighted_moments_multi,
                CG.merit_adjoint_multi, CG.opd_chain, CG.opd_adjoint)
    before = [f.launches for f in wrappers]
    got = CT.trace_multi(tabs, specs, state)
    mom = CT.trace_multi(tabs, specs, state, merit=True)
    wm = CG.weighted_moments_multi(tabs, specs, state, w)
    ref = CT.trace_multi_reference(tabs, specs, state)
    mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
    wref = CG.weighted_moments_multi_reference(tabs, specs, state, w)
    ct = torch.stack([_rms_cotangent(m) for m in wref])
    pg, cst, cw = CG.merit_adjoint_multi(tabs, specs, state, w, ct)
    pref, sref, cwref = CG.merit_adjoint_multi_reference(tabs, specs, state,
                                                         w, ct)
    # the reference sphere: centred on the chief ray's image point, the
    # exit pupil's radius, the first wavelength's scale
    s, _ = _aspheric_system(name)
    chief, _ = CT.trace_final_reference(tab, specs,
                                        tuple(c[:1] for c in state))
    aux = torch.cat([torch.cat(chief[:3]), torch.tensor(
        [-s.image.pupil.distance, s.wavelengths[0]/s.scale], dtype=dtype,
        device=cuda_device)])
    k = CG.opd_chain(tab, specs, state, aux)
    kref = CG.opd_chain_reference(tab, specs, state, aux)
    live = torch.isfinite(kref[0]) & torch.isfinite(k[0])
    cts = (torch.where(live, 1e-3*w, 0.), torch.where(live, w, 0.),
           torch.where(live, -w, 0.))
    qg, qst, qc = CG.opd_adjoint(tab, specs, state, aux, cts)
    qref, qsref, qcref = CG.opd_adjoint_reference(tab, specs, state, aux,
                                                  cts)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + n for b, n in zip(
        before, (2, 1, 1, 1, 1))]
    for li in range(3):
        for g, r in zip((*got[li][0], got[li][1]), (*ref[li][0], ref[li][1])):
            g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
            if f64:
                nptest.assert_array_equal(np.isnan(g), np.isnan(r))
            ok = np.isfinite(g) & np.isfinite(r)
            assert ok.mean() > .5
            nptest.assert_allclose(g[ok], r[ok], atol=tol*100, rtol=tol)
        for a, b in ((torch.stack(mom[li]), torch.stack(mref[li])),
                     (wm[li], wref[li])):
            assert abs(float(a[0] - b[0])) <= (mtol*float(b[0]) if f64
                                               else 1e-5*float(b[0]) + 1)
            nptest.assert_allclose(float(CT.spot_rms_from_moments(*a)),
                                   float(CT.spot_rms_from_moments(*b)),
                                   rtol=1e-10 if f64 else mtol)
    na, no = widths
    fig = [j for j, s in enumerate(specs) if s.aspheric or s.odd]
    others = [j for j in range(tab.nsurfaces) if j not in fig]
    assert pg.shape == pref.shape == (3, tab.nsurfaces, CG.SLOTS + na + no)
    assert qg.shape == qref.shape == (tab.nsurfaces, CG.OPD_SLOTS + na + no)
    assert bool(pg[:, fig, CG.SLOTS:].any()) and bool(qg[fig, 7:].any())
    assert not pg[:, others, CG.SLOTS:].any() and not qg[others, 7:].any()
    for g, r in [(pg[li], pref[li]) for li in range(3)] + [(qg, qref)]:
        for col in range(g.shape[1]):
            assert torch.isfinite(g[:, col]).all()
            if float(r[:, col].abs().max()):
                assert _max_rel(g[:, col], r[:, col]) <= gtol, col
    nptest.assert_allclose(qc.double().cpu().numpy(),
                           qcref.double().cpu().numpy(), rtol=gtol,
                           atol=gtol*float(qcref.abs().max()))
    # every ray cotangent is finite and a dead ray's are all zero: in
    # float64 the kernels hold the same rays live as the plain versions,
    # in float32 at most 1 in 10^4 rays may differ (a ray on the edge of
    # the Newton's convergence); the rays live in both are compared
    n = state[0].shape[0]
    for got_, want_, groups in (((*cst, cw), (*sref, cwref),
                                 ((0, 6), (6, 7))),
                                (qst, qsref, ((0, 6),))):
        alive, alive_ref = (torch.stack([c != 0 for c in v]).any(0)
                            for v in (got_, want_))
        flips = int((alive != alive_ref).sum())
        assert flips <= (0 if f64 else n // 10000), flips
        live_ = alive & alive_ref
        assert float(live_.double().mean()) > .5
        for a, b in groups:
            scale = max(float(r.abs().max()) for r in want_[a:b])
            for g, r in zip(got_[a:b], want_[a:b]):
                assert bool(torch.isfinite(g).all())
                assert float((g - r)[live_].abs().max()) <= gtol*scale
    kk, kr = k[0][live].double(), kref[0][live].double()
    assert float((kk - kr).abs().max()) <= (
        tol if f64 else 4e-6)*float(kr.abs().max())


# -- the anamorphic rows (K1, K2, K4, K5 keys) ---------------------------------

def _anamorphic_system(name):
    """An anamorphic lens: the crossed-cylinder pair, or the JAX
    package's split-conic biconic and toroid lenses, or those two with
    an aspheric figure on their first row ("figured biconic", "figured
    toroid": tests/test_torch_anamorphic.py's FIGURED)."""
    from rayopt_tpu_torch import System
    figure = {"figured toroid": [1e-5, 2e-8],
              "figured biconic": [2e-4, -1e-6]}.get(name)
    name = name.split()[-1]
    if name == "pair":
        s = models.anamorphic_pair()
    else:
        row = (dict(type="biconic", roc=25.84, curvature_x=.013,
                    conic=-.4, conic_x=.25, distance=5.,
                    material="SCHOTT-BK|N-BK7", radius=10.)
               if name == "biconic" else
               dict(type="toroid", roc=51.68, roc_rotation=200.,
                    distance=5., material="SCHOTT-BK|N-BK7", radius=10.))
        s = System([dict(material="air"), row,
                    dict(type=row["type"], distance=3., material="air",
                         radius=10.),
                    dict(distance=47. if name == "biconic" else 95.,
                         radius=10. if name == "biconic" else 20.)])
        s.update()
    if figure:
        s[1].aspherics = figure
        s.update()
    return s


def _anamorphic_case(name, device):
    """(table on `device`, specs) of an anamorphic lens
    (_anamorphic_system)."""
    tab = _anamorphic_system(name).table(device=device)
    return tab, specialize(tab)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["pair", "biconic", "toroid"])
def test_anamorphic_keys_match_plain_on_card(cuda_device, name, dtype, clip):
    """K1, K2, K4 and K5 on an anamorphic key (a cylinder's closed form,
    a biconic's or toroid's Newton) against their plain versions on the
    card, the bench bundle within the 4 mm pupil (1.5x wide clipped):
    float64 rays to 1e-12 with equal NaN masks, K5's columns (curvature_dx
    and conic_dx last) to 1e-9 of each column's largest; each wrapper
    launches its kernel once."""
    tab, specs = _anamorphic_case(name, cuda_device)
    f64 = dtype == torch.float64
    n = 1 << 14
    rng = np.random.RandomState(3)
    half = 6. if clip else 4.
    xy = rng.uniform(-half, half, (2, n))
    zero, one = np.zeros(n), np.ones(n)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device,
                                                               dtype)
                  for c in (*xy, zero, zero, zero, one))
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    wrappers = (CT.trace_final, CT.trace_merit, CG.weighted_moments,
                CG.merit_adjoint)
    before = [f.launches for f in wrappers]
    got = CT.trace_final(tab, specs, state, clip)
    ref = CT.trace_final_reference(tab, specs, state, clip)
    mom = CT.trace_merit(tab, specs, state, clip)
    mref = CT.trace_merit_reference(tab, specs, state, clip)
    wm = CG.weighted_moments(tab, specs, state, w, clip)
    wref = CG.weighted_moments_reference(tab, specs, state, w, clip)
    ct = _rms_cotangent(wref)
    pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct, clip)
    pref, sref, wr = CG.merit_adjoint_reference(tab, specs, state, w, ct,
                                                clip)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    tol = 1e-12 if f64 else 5e-5
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if f64:
            nptest.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = np.isfinite(g) & np.isfinite(r)
        assert ok.mean() > .5
        nptest.assert_allclose(g[ok], r[ok], atol=tol*max(1., np.abs(
            r[ok]).max()), rtol=0)
    for a, b in ((torch.stack(mom), torch.stack(mref)), (wm, wref)):
        nptest.assert_allclose(float(CT.spot_rms_from_moments(*a)),
                               float(CT.spot_rms_from_moments(*b)),
                               rtol=1e-10 if f64 else 1e-4)
    assert pg.shape == pref.shape == (tab.nsurfaces, CG.SLOTS + CT.ANAM)
    gtol = 1e-9 if f64 else 1e-3
    top = float(pref.double().abs().max())
    for col in range(pg.shape[1]):
        assert torch.isfinite(pg[:, col]).all()
        scale = float(pref[:, col].double().abs().max())
        if scale:
            err = float((pg[:, col].double() - pref[:, col].double())
                        .abs().max())
            assert err <= gtol*max(scale, 1e-9*top), col
    if f64:
        scale = max(float(r.abs().max()) for r in sref)
        for g, r in zip(cst, sref):
            assert float((g - r).abs().max()) <= 1e-9*scale


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in ("pair", "biconic", "toroid")
    for d in (torch.float64, torch.float32)] + [
    ("figured toroid", torch.float64), ("figured biconic", torch.float64)])
def test_anamorphic_multi_and_opd_kernels_match_plain_on_card(cuda_device,
                                                              name, dtype):
    """K3 (trace and merit), K6, K7, K8 and K9 on an anamorphic lens's
    keys (3 tables for the stacked kernels: the refracting rows' mu
    grown by 0, 1 and 2 % of mu - 1; ray 0 the chief ray, on the axis)
    and, on the figured lenses, K1, K2, K4 and K5 too, against their
    plain versions on the card: float64 traces and moments to 1e-12,
    the adjoints' cotangents (a figured lens's coefficients, then
    curvature_dx and conic_dx last) to 1e-9 of each column's largest
    (float32: 5e-5 mm, 1e-4 of the moments' and 1e-2 of the cotangents'
    scale); each wrapper launches once."""
    from rayopt_tpu_torch.ops.tables import stack_tables
    s = _anamorphic_system(name)
    tab = s.table(device=cuda_device)
    specs = specialize(tab)
    tabs = stack_tables([tab.replace(mu=1 + (tab.mu - 1)*(1 + .01*li))
                         for li in range(3)])
    f64 = dtype == torch.float64
    n = 1 << 14
    rng = np.random.RandomState(4)
    xy = rng.uniform(-4., 4., (2, n))
    xy[:, 0] = 0.
    zero, one = np.zeros(n), np.ones(n)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device,
                                                               dtype)
                  for c in (*xy, zero, zero, zero, one))
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    tol, mtol, gtol = (1e-12, 1e-12, 1e-9) if f64 else (5e-5, 1e-4, 1e-2)
    wrappers = (CT.trace_multi, CG.weighted_moments_multi,
                CG.merit_adjoint_multi, CG.opd_chain, CG.opd_adjoint)
    before = [f.launches for f in wrappers]
    got = CT.trace_multi(tabs, specs, state)
    mom = CT.trace_multi(tabs, specs, state, merit=True)
    wm = CG.weighted_moments_multi(tabs, specs, state, w)
    ref = CT.trace_multi_reference(tabs, specs, state)
    mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
    wref = CG.weighted_moments_multi_reference(tabs, specs, state, w)
    ct = torch.stack([_rms_cotangent(m) for m in wref])
    pg, cst, cw = CG.merit_adjoint_multi(tabs, specs, state, w, ct)
    pref, sref, cwref = CG.merit_adjoint_multi_reference(tabs, specs, state,
                                                         w, ct)
    chief, _ = CT.trace_final_reference(tab, specs,
                                        tuple(c[:1] for c in state))
    aux = torch.cat([torch.cat(chief[:3]), torch.tensor(
        [-s.image.pupil.distance, s.wavelengths[0]/s.scale], dtype=dtype,
        device=cuda_device)])
    k = CG.opd_chain(tab, specs, state, aux)
    kref = CG.opd_chain_reference(tab, specs, state, aux)
    live = torch.isfinite(kref[0]) & torch.isfinite(k[0])
    cts = (torch.where(live, 1e-3*w, 0.), torch.where(live, w, 0.),
           torch.where(live, -w, 0.))
    qg, qst, qc = CG.opd_adjoint(tab, specs, state, aux, cts)
    qref, qsref, qcref = CG.opd_adjoint_reference(tab, specs, state, aux,
                                                  cts)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + m for b, m in zip(
        before, (2, 1, 1, 1, 1))]
    for li in range(3):
        for g, r in zip((*got[li][0], got[li][1]), (*ref[li][0], ref[li][1])):
            g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
            if f64:
                nptest.assert_array_equal(np.isnan(g), np.isnan(r))
            ok = np.isfinite(g) & np.isfinite(r)
            assert ok.mean() > .5
            nptest.assert_allclose(g[ok], r[ok], atol=tol*max(1., np.abs(
                r[ok]).max()), rtol=0)
        for a, b in ((torch.stack(mom[li]), torch.stack(mref[li])),
                     (wm[li], wref[li])):
            nptest.assert_allclose(float(CT.spot_rms_from_moments(*a)),
                                   float(CT.spot_rms_from_moments(*b)),
                                   rtol=1e-10 if f64 else mtol)
    nq = CG.SLOTS + sum(CT.figure_widths(tab, specs)) + CT.ANAM
    assert pg.shape == pref.shape == (3, tab.nsurfaces, nq)
    assert qg.shape == qref.shape == (tab.nsurfaces, nq + 1)
    assert bool(pg[..., -2].any()) and bool(qg[:, -2].any())
    for g, r in [(pg[li], pref[li]) for li in range(3)] + [(qg, qref)]:
        for col in range(g.shape[1]):
            assert torch.isfinite(g[:, col]).all()
            if float(r[:, col].abs().max()):
                assert _max_rel(g[:, col], r[:, col]) <= gtol, col
    nptest.assert_allclose(qc.double().cpu().numpy(),
                           qcref.double().cpu().numpy(), rtol=gtol,
                           atol=gtol*float(qcref.abs().max()))
    if f64:
        for got_, want_ in (((*cst, cw), (*sref, cwref)), (qst, qsref)):
            scale = max(float(r.abs().max()) for r in want_[:6])
            for g, r in zip(got_[:6], want_[:6]):
                assert float((g - r).abs().max()) <= gtol*scale
    kk, kr = k[0][live].double(), kref[0][live].double()
    assert float((kk - kr).abs().max()) <= (
        tol if f64 else 4e-6)*float(kr.abs().max())
    if name.startswith("figured"):
        # K1, K2, K4 and K5 on the figured keys too
        got = CT.trace_final(tab, specs, state)
        ref = CT.trace_final_reference(tab, specs, state)
        for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
            g, r = g.cpu().numpy(), r.cpu().numpy()
            nptest.assert_array_equal(np.isnan(g), np.isnan(r))
            ok = np.isfinite(g)
            nptest.assert_allclose(g[ok], r[ok], rtol=0, atol=tol*max(
                1., np.abs(r[ok]).max()))
        nptest.assert_allclose(
            float(CT.spot_rms_from_moments(*CT.trace_merit(tab, specs,
                                                           state))),
            float(CT.spot_rms_from_moments(*CT.trace_merit_reference(
                tab, specs, state))), rtol=1e-10)
        wct = _rms_cotangent(CG.weighted_moments(tab, specs, state, w))
        pg, _, _ = CG.merit_adjoint(tab, specs, state, w, wct)
        pref, _, _ = CG.merit_adjoint_reference(tab, specs, state, w, wct)
        assert bool(pg[1, CG.SLOTS:CG.SLOTS + 2].any())
        for col in range(pg.shape[1]):
            if float(pref[:, col].abs().max()):
                assert _max_rel(pg[:, col], pref[:, col]) <= gtol, col


# -- the grating and DOE rows (K1, K2, K4, K5 keys) ---------------------------

_A1 = -np.pi/((550e-9/1e-3)*100.)   # a kinoform of focal 100 mm at 550 nm


def _phase_system(name):
    """A grating or DOE lens: the published hybrid achromat and
    spectrograph, and the JAX package's test lenses (the curved hybrid
    with a two-term phase, the concave mirror grating, the refractive
    grating on an R = 80 N-BK7 substrate, the reflective zone plate:
    tests/test_torch_grating.py's LENSES); returns (system, bench half
    width)."""
    from rayopt_tpu_torch import System
    if name in ("hybrid_achromat", "spectrograph"):
        return getattr(models, name)(), 6. if name == "hybrid_achromat" \
            else 10.
    grating = dict(type="grating", grating_frequency=600., radius=30.)
    rows, lam, obj = {
        "curved hybrid": ([
            dict(material="air"),
            dict(type="binary2", roc=120., phase_coefficients=[_A1, 1e-4],
                 distance=5., material="glass/N-BK7", radius=10.),
            dict(roc=-150., distance=3., material="air", radius=10.),
            dict(distance=60., radius=10.)], 550e-9, dict(radius=3.)),
        "mirror grating": ([
            dict(material="air"),
            dict(grating, distance=20., material="mirror",
                 curvature=-.001),
            dict(distance=-50., radius=100.)], 500e-9, dict(radius=5.)),
        "bk7 grating": ([
            dict(material="air"),
            dict(grating, roc=80., distance=20.,
                 material="SCHOTT-BK|N-BK7"),
            dict(distance=5., material="air", radius=30.),
            dict(distance=50., radius=100.)], 500e-9, dict(radius=5.)),
        "zone plate": ([
            dict(material="vacuum"),
            dict(type="binary2", phase_coefficients=[_A1],
                 distance=50., material="mirror", radius=20.),
            dict(distance=-100., radius=20.)], 550e-9, dict(radius=5.))}[name]
    s = System(rows, wavelengths=[lam], object=dict(
        pupil=dict(obj, update_radius=False)))
    s.update()
    return s, obj["radius"]


#: gratings and DOEs on an asphere, a biconic and a toroid (make_table
#: keyword arguments; tests/test_torch_spec_grating.py's SUBSTRATES)
_PHASE_SUBSTRATES = {
    "asphere": dict(curvature=[0., 1/80., 0.], conic=[0., -.5, 0.],
                    aspherics=[[0., 0.], [1e-6, -2e-9], [0., 0.]],
                    aspherics_odd=[[0.], [3e-6], [0.]],
                    grating_dy=[0., .15, 0.], doe=[[0.], [-1e-3], [0.]]),
    "biconic": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., .004, 0.],
                    conic_dx=[0., .3, 0.], doe=[[0., 0.], [-2e-3, 1e-6],
                                                [0., 0.]]),
    "toroid": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., -.01, 0.],
                   toroidal=[0., 1., 0.], conic=[0., -.2, 0.],
                   grating_dy=[0., .2, 0.], doe=[[0.], [-1.5e-3], [0.]])}


def _phase_case(name, device):
    """(table on `device`, specs, bench half width) of a phase lens
    (_phase_system) or substrate (_PHASE_SUBSTRATES)."""
    if name in _PHASE_SUBSTRATES:
        kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
                  n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
                  radius=[np.inf, 12., np.inf])
        kw.update(_PHASE_SUBSTRATES[name])
        tab = make_table(**kw, device=device)
        half = 3.
    else:
        s, half = _phase_system(name)
        tab = s.table(device=device)
    return tab, specialize(tab), half


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["hybrid_achromat", "spectrograph",
                                  "curved hybrid", "mirror grating",
                                  "bk7 grating", "zone plate", "asphere",
                                  "biconic", "toroid"])
def test_phase_keys_match_plain_on_card(cuda_device, name, dtype, clip):
    """K1, K2, K4 and K5 on a grating or DOE key against their plain
    versions on the card, the bench bundle within the lens's pupil (1.5x
    wide clipped): float64 rays and optical path (the DOE's phase term)
    to 1e-12 of scale with equal NaN masks, float32 to 5e-5; the moments
    to 1e-10 (float32 1e-4) of their scale; K5's columns (grating_dy
    and the DOE coefficients last) for a fixed moment cotangent to 1e-9
    (float32 1e-3) of each column's largest; each wrapper launches its
    kernel once."""
    tab, specs, half = _phase_case(name, cuda_device)
    f64 = dtype == torch.float64
    n = 1 << 14
    rng = np.random.RandomState(5)
    xy = rng.uniform(-half, half, (2, n))*(1.5 if clip else 1.)
    zero, one = np.zeros(n), np.ones(n)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device,
                                                               dtype)
                  for c in (*xy, zero, zero, zero, one))
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    wrappers = (CT.trace_final, CT.trace_merit, CG.weighted_moments,
                CG.merit_adjoint)
    before = [f.launches for f in wrappers]
    got = CT.trace_final(tab, specs, state, clip)
    ref = CT.trace_final_reference(tab, specs, state, clip)
    mom = CT.trace_merit(tab, specs, state, clip)
    mref = CT.trace_merit_reference(tab, specs, state, clip)
    wm = CG.weighted_moments(tab, specs, state, w, clip)
    wref = CG.weighted_moments_reference(tab, specs, state, w, clip)
    # a fixed moment cotangent: with the spot RMS's, a column such as
    # grating_dy's (a shift of the whole spot) is a residual of
    # cancelling terms, which float32 sums hold to ~1e-3 only (the
    # float32 plain version's own error against float64's)
    ct = torch.tensor([.3, -.2, .5, 1., .7], dtype=dtype, device=cuda_device)
    pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct, clip)
    pref, sref, wr = CG.merit_adjoint_reference(tab, specs, state, w, ct,
                                                clip)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    tol = 1e-12 if f64 else 5e-5
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if f64:
            nptest.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = np.isfinite(g) & np.isfinite(r)
        assert ok.mean() > .5
        nptest.assert_allclose(g[ok], r[ok], atol=tol*max(1., np.abs(
            r[ok]).max()), rtol=0)
    for a, b in ((torch.stack(mom), torch.stack(mref)), (wm, wref)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = max(float(b.abs().max()), 1.)
        assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*scale
    nq = CG._nslots(tab, specs)
    assert pg.shape == pref.shape == (tab.nsurfaces, nq)
    assert nq == (CG.SLOTS + sum(CG._table_widths(tab))
                  + (CT.ANAM if CT.carries_anamorphic(specs) else 0)
                  + int(CT.carries_grating(specs)) + CT.doe_width(tab, specs))
    gtol = 1e-9 if f64 else 1e-3
    top = float(pref.double().abs().max())
    for col in range(pg.shape[1]):
        assert torch.isfinite(pg[:, col]).all()
        scale = float(pref[:, col].double().abs().max())
        if scale:
            err = float((pg[:, col].double() - pref[:, col].double())
                        .abs().max())
            assert err <= gtol*max(scale, 1e-9*top), col
    if f64:
        scale = max(float(r.abs().max()) for r in sref)
        for g, r in zip(cst, sref):
            assert float((g - r).abs().max()) <= 1e-9*scale


def _phase_stack(name, device):
    """(stack of 3 tables on `device`, its specs, the first table, the
    OPD's sphere radius and wavelength, bench half width) of a phase lens
    (its System.tables at its wavelengths, or at 0.9 and 1.1 times its
    one) or substrate (mu grown 1 % and 2 % of mu - 1, grating_dy and the
    DOE coefficients 5 % and 10 %)."""
    if name in _PHASE_SUBSTRATES:
        tab, specs, half = _phase_case(name, device)
        tabs = type(tab)(*(None if f is None else torch.stack([f]*3)
                           for f in tab))
        grow = torch.tensor([0., 1., 2.], dtype=torch.float64,
                            device=device)
        tabs = tabs.replace(
            mu=1 + (tabs.mu - 1)*(1 + .01*grow[:, None]),
            grating_dy=tabs.grating_dy*(1 + .05*grow[:, None]),
            doe=tabs.doe*(1 + .05*grow[:, None, None]))
        return tabs, specs, tab, (-40., 550e-9), half
    s, half = _phase_system(name)
    lam = list(s.wavelengths)
    if len(lam) < 3:
        lam = [lam[0], .9*lam[0], 1.1*lam[0]]
    tabs = s.tables(lam, device=device)
    tab = s.table(device=device)
    return tabs, specialize(tab), tab, (-s.image.pupil.distance,
                                        s.wavelengths[0]), half


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["hybrid_achromat", "spectrograph",
                                  "curved hybrid", "mirror grating",
                                  "bk7 grating", "zone plate", "asphere",
                                  "biconic", "toroid"])
def test_phase_multi_and_opd_keys_match_plain_on_card(cuda_device, name,
                                                      dtype, clip):
    """K3 (trace and merit), K6, K7, K8 and K9 on a grating or DOE key
    against their plain versions on the card, the bench bundle within
    the lens's pupil (1.5x wide clipped; K3 has no clip), ray 0 the
    chief ray: K3's rays and optical path through each of the stack's
    three tables (each its own grating term and DOE coefficients) to
    1e-12 of scale in float64 with equal NaN masks, float32 5e-5; K3's
    and K6's moments to 1e-10 (float32 1e-4) of their scale; K7's
    columns (grating_dy and the DOE coefficients last, per table) for a
    fixed moment cotangent to 1e-9 (float32 1e-3) of each column's
    largest; K8's k to 1e-12 of max |k| (float32 1e-4), and in float64
    K9's columns (grating_dy, n_after and the DOE coefficients last)
    for a fixed cotangent to 1e-9 of each column's largest; each
    wrapper launches its kernel once a call."""
    tabs, specs, tab, (radius, lam), half = _phase_stack(name, cuda_device)
    f64 = dtype == torch.float64
    n = 1 << 14
    rng = np.random.RandomState(6)
    xy = rng.uniform(-half, half, (2, n))*(1.5 if clip else 1.)
    xy[:, 0] = (.05, .03)
    zero, one = np.zeros(n), np.ones(n)
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device,
                                                               dtype)
                  for c in (*xy, zero, zero, zero, one))
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    wrappers = (CT.trace_multi, CG.weighted_moments_multi,
                CG.merit_adjoint_multi, CG.opd_chain, CG.opd_adjoint)
    before = [f.launches for f in wrappers]
    tol = 1e-12 if f64 else 5e-5
    if not clip:
        got = CT.trace_multi(tabs, specs, state)
        ref = CT.trace_multi_reference(tabs, specs, state)
        mom = CT.trace_multi(tabs, specs, state, merit=True)
        mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
        for li in range(3):
            for g, r in zip((*got[li][0], got[li][1]),
                            (*ref[li][0], ref[li][1])):
                g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
                if f64:
                    nptest.assert_array_equal(np.isnan(g), np.isnan(r))
                ok = np.isfinite(g) & np.isfinite(r)
                assert ok.mean() > .5
                nptest.assert_allclose(g[ok], r[ok], rtol=0, atol=tol*max(
                    1., np.abs(r[ok]).max()))
            a = torch.stack(mom[li]).double().cpu()
            b = torch.stack(mref[li]).double().cpu()
            assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*max(
                float(b.abs().max()), 1.)
    wm = CG.weighted_moments_multi(tabs, specs, state, w, clip)
    wref = CG.weighted_moments_multi_reference(tabs, specs, state, w, clip)
    a, b = wm.double().cpu(), wref.double().cpu()
    assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*max(
        float(b.abs().max()), 1.)
    ct = torch.tensor([[.3, -.2, .5, 1., .7]]*3, dtype=dtype,
                      device=cuda_device)
    pg, _, _ = CG.merit_adjoint_multi(tabs, specs, state, w, ct, clip)
    pref, _, _ = CG.merit_adjoint_multi_reference(tabs, specs, state, w,
                                                  ct, clip)
    nq = CG._nslots(tabs, specs)
    assert pg.shape == pref.shape == (3, tab.nsurfaces, nq)
    gtol = 1e-9 if f64 else 1e-3
    for li in range(3):
        for col in range(nq):
            assert torch.isfinite(pg[li, :, col]).all()
            if float(pref[li, :, col].abs().max()):
                assert _max_rel(pg[li, :, col], pref[li, :, col]) <= gtol
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
    yr, _, _ = trace_rays_final(tab, y0, u0, specs=specs)
    aux = torch.cat([yr[0], torch.tensor([radius, lam/1e-3],
                                         dtype=torch.float64,
                                         device=cuda_device)]).to(dtype)
    k = CG.opd_chain(tab, specs, state, aux, clip)
    kref = CG.opd_chain_reference(tab, specs, state, aux, clip)
    g, r = k[0].double().cpu().numpy(), kref[0].double().cpu().numpy()
    ok = np.isfinite(g) & np.isfinite(r)
    assert ok.mean() > .5
    nptest.assert_allclose(g[ok], r[ok], rtol=0, atol=(
        1e-12 if f64 else 1e-4)*max(1., np.abs(r[ok]).max()))
    if f64:
        live = torch.from_numpy(ok).to(cuda_device)
        gen = torch.Generator(device="cpu").manual_seed(7)
        cts = tuple(torch.where(live, torch.randn(n, generator=gen,
                                                  dtype=dtype).to(
            cuda_device), 0.) for _ in range(3))
        pg, _, cc = CG.opd_adjoint(tab, specs, state, aux, cts, clip)
        pref, _, cr = CG.opd_adjoint_reference(tab, specs, state, aux, cts,
                                               clip)
        nq = CG._nslots(tab, specs, CS.OPD_SLOTS)
        assert pg.shape == pref.shape == (tab.nsurfaces, nq)
        for col in range(nq):
            assert torch.isfinite(pg[:, col]).all()
            if float(pref[:, col].abs().max()):
                assert _max_rel(pg[:, col], pref[:, col]) <= 1e-9, col
        assert _max_rel(cc, cr) <= 1e-9
    torch.cuda.synchronize()
    calls = [2 if not clip else 0, 1, 1, 1, 1 if f64 else 0]
    assert [f.launches for f in wrappers] == [b + c for b, c in
                                              zip(before, calls)]


#: gratings and DOEs on cylinders (make_table keyword arguments; row 1):
#: a grating on a biconic-made y-cylinder, a DOE on a toroid-made one, a
#: grating on an x-cylinder (tests/test_torch_spec_phase_cylinder.py)
_PHASE_CYLINDERS = {
    "grating biconic y": dict(curvature=[0., 1/40., 0.],
                              curvature_dx=[0., -1/40., 0.],
                              conic=[0., -.3, 0.], conic_dx=[0., .5, 0.],
                              grating_dy=[0., .1, 0.]),
    "doe toroid y": dict(curvature=[0., 1/50., 0.],
                         curvature_dx=[0., -1/50., 0.],
                         toroidal=[0., 1., 0.], conic=[0., .2, 0.],
                         doe=[[0., 0.], [-1.5e-3, 2e-7], [0., 0.]]),
    "grating biconic x": dict(curvature=[0., 0., 0.],
                              curvature_dx=[0., 1/45., 0.],
                              conic_dx=[0., -.4, 0.],
                              grating_dy=[0., -.15, 0.])}
_PHASE_SUBSTRATES.update(_PHASE_CYLINDERS)
#: the df32 phase cases: the phase lenses and the phase cylinders
_DF32_PHASE = ("hybrid_achromat", "spectrograph", "curved hybrid",
               "mirror grating", "bk7 grating", "zone plate",
               "grating biconic y", "doe toroid y")


def _df32_phase_case(name, fast, clip):
    """A phase case's three wavelength plans (_phase_stack's tables) and
    the bench bundle at its half width (2.5x wide when clipped), on the
    card, as df32 words."""
    tabs, _, _, _, half = _phase_stack(name, torch.device("cuda"))
    plans = [D.plan(table_at(tabs, li), clip=clip, fast=fast)
             for li in range(3)]
    scale = half/11.6*(2.5 if clip else 1.)
    state64 = _bench_state(1 << 16, 14, torch.device("cuda"), torch.float64)
    state64 = tuple(c*scale if i < 2 else c for i, c in enumerate(state64))
    return plans, D.state_from_f64(torch.stack(state64[:3], 1),
                                   torch.stack(state64[3:], 1))


@functools.lru_cache(maxsize=None)
def _prebuild_df32_phase():
    """Build the keys of every df32 phase case and of the degree-7
    freeform singlet at once (one nvcc a key, in parallel), the first
    time a case asks."""
    keys = []
    for name in _DF32_PHASE + ("degree 7",):
        for fast in (True, False):
            for clip in (False, True):
                plans, _ = (_df32_deg7_case(fast, clip) if name == "degree 7"
                            else _df32_phase_case(name, fast, clip))
                keys += [CS.df32_multi_key(plans[:1], "k11", True),
                         CS.df32_multi_key(plans[:1], "k13"),
                         CS.df32_multi_key(plans, "k11", True),
                         CS.df32_multi_key(plans, "k13")]
    CS.prebuild(keys)


def _df32_plans_match_on_card(plans, st, clip):
    """K10 and K11 (with the optical path), K12 and K13 on `plans` (one
    a wavelength; K10/K12 on the first) against their plain versions on
    the card: identical words, the same live count (some live ray
    unclipped), the moments within 1e-13 of their scale; each wrapper
    launches its kernel once."""
    wrappers = (CD.trace_final_df32, CD.trace_multi_df32,
                CD.trace_merit_df32, CD.trace_merit_multi_df32)
    before = [f.launches for f in wrappers]
    got = CD.trace_final_df32(plans[0], st, with_path=True)
    want = CD.trace_final_df32_reference(plans[0], st, with_path=True)
    torch.cuda.synchronize()
    assert _differing_words(_df32_words(got, True),
                            _df32_words(want, True)) == 0
    assert bool(torch.isfinite(got[0][0][0]).any())
    got = CD.trace_multi_df32(plans, st, with_path=True)
    want = CD.trace_multi_df32_reference(plans, st, with_path=True)
    torch.cuda.synchronize()
    assert sum(_differing_words(_df32_words(g, True), _df32_words(w, True))
               for g, w in zip(got, want)) == 0
    moms = [(CD.trace_merit_df32(plans[0], st),
             CD.trace_merit_df32_reference(plans[0], st))]
    moms += list(zip(CD.trace_merit_multi_df32(plans, st),
                     CD.trace_merit_multi_df32_reference(plans, st)))
    for m, r in moms:
        # clipped, the spectrograph's detector aperture (60 mm) stops its
        # 56-85 mm off-axis image: no ray is live
        assert float(m[0]) == float(r[0])
        assert float(m[0]) > 0 or clip
        if float(r[0]):
            assert _moments_rel(m, r) <= 1e-13
        else:
            assert all(float(a) == float(b) == 0. for a, b in zip(m, r))
    assert [f.launches for f in wrappers] == [b + 1 for b in before]


#: a degree-7 freeform row (35 terms, some zero): past the kernels'
#: degree-6 term mask, a dense step
_DEG7 = [1e-4, 0., 3e-3, 0., -2e-3, 2e-5, 0., 0., 1e-5, 1e-6, 0., 2e-6, 0.,
         -1e-6, 0., 3e-8, 0., 0., 0., -2e-8, 1e-9, 0., 0., 0., 0., 0., 2e-9,
         0., 0., 4e-11, 0., 0., 0., 0., -3e-11]


def _df32_deg7_case(fast, clip):
    """The degree-7 freeform singlet's three plans (refracting rows' mu
    grown by 0, 1 and 2 % of mu - 1) and a 5 mm bench bundle (2.5x wide
    when clipped), on the card, as df32 words."""
    tab = make_table(curvature=[0., 1/60., -1/80., 0.],
                     xy_poly=[[0.]*35, _DEG7, [0.]*35, [0.]*35],
                     distance=[0., 10., 4., 40.], mu=[1., 1/1.5, 1.5, 1.],
                     n_before=[1., 1., 1.5, 1.], n_after=[1., 1.5, 1., 1.],
                     radius=[np.inf, 9., 9., 20.], device="cuda")
    plans = [D.plan(tab.replace(mu=1 + (tab.mu - 1)*(1 + .01*li)), clip=clip,
                    fast=fast) for li in range(3)]
    scale = 5./11.6*(2.5 if clip else 1.)
    state64 = _bench_state(1 << 16, 15, torch.device("cuda"), torch.float64)
    state64 = tuple(c*scale if i < 2 else c for i, c in enumerate(state64))
    return plans, D.state_from_f64(torch.stack(state64[:3], 1),
                                   torch.stack(state64[3:], 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("df32", n) for n in _DF32_PHASE]
                         + [("cylinder %s" % dt, n) for n in _PHASE_CYLINDERS
                            for dt in ("f64", "f32")])
def test_phase_rows_refuse_the_other_kernels_on_card(cuda_device, case):
    """No kernel refuses a phase row on the card now.  "df32": K10 and
    K11 (with the optical path: a DOE's phase term), K12 and K13 on a
    phase lens's or phase cylinder's three wavelength plans (one flag
    tuple) against their plain versions, fast and exact, clip off and
    on (_df32_plans_match_on_card); and, since the df32 plan takes the
    freeform rows too, the same on a degree-7 freeform singlet (a dense
    step: no row refuses).
    "cylinder": a grating or DOE on a cylinder in K1, K2, K4, K5 and K3,
    K6-K9, in float64 and float32, clip off and on, against their plain
    versions (test_phase_keys_match_plain_on_card's and
    test_phase_multi_and_opd_keys_match_plain_on_card's tolerances); no
    wrapper falls back to its plain version."""
    kind, name = case
    if kind.startswith("cylinder"):
        dtype = torch.float64 if kind.endswith("f64") else torch.float32
        tab, specs, _ = _phase_case(name, cuda_device)
        assert specs[1].cyl_axis and (specs[1].grating or specs[1].doe)
        for clip in (False, True):
            test_phase_keys_match_plain_on_card(cuda_device, name, dtype,
                                                clip)
            test_phase_multi_and_opd_keys_match_plain_on_card(
                cuda_device, name, dtype, clip)
        return
    _prebuild_df32_phase()
    for fast in (True, False):
        for clip in (False, True):
            plans, st = _df32_phase_case(name, fast, clip)
            flags = CS.df32_flags(plans)
            assert len(set(flags)) == 1
            assert any(f & (CD.G_GRATING | CD.G_DOE) for f in flags[0])
            _df32_plans_match_on_card(plans, st, clip)
            plans, st = _df32_deg7_case(fast, clip)
            assert any(CD.fig_of(f) == CD.FIG_XY_DENSE
                       for f in CS.df32_flags(plans)[0])
            _df32_plans_match_on_card(plans, st, clip)


# -- the freeform XY rows ------------------------------------------------------

_SCHMIDT_FIGURE = [0., 0., -.02, .001, -.021, 0., 1e-4, 0., -2e-4, .012, 0.,
                   .024, 1e-4, .0118]


def _freeform_system(name):
    """(System, bench half width) of a freeform lens of the JAX package's
    tests/test_freeform.py: the Schmidt corrector (seeded at 1e-10, and a
    figured plate), the Zernike corrector, the quadratic XY singlet."""
    from rayopt_tpu_torch import System
    bk7 = "SCHOTT-BK|N-BK7"
    if name.endswith("schmidt"):
        rows = [dict(material="air"),
                dict(type="xypoly", xy_coefficients=_SCHMIDT_FIGURE
                     if name.startswith("figured") else [1e-10]*14,
                     norm_radius=25., distance=5., material=bk7, radius=26.),
                dict(distance=4., material="air", radius=26.),
                dict(roc=-200., distance=100., material="mirror", radius=30.),
                dict(distance=-95., radius=5.)]
        pupil, half = 25., 17.
    elif name == "zernike corrector":
        rows = [dict(material="air"),
                dict(type="zernike", zernike_coefficients=[0.]*10 + [.002],
                     norm_radius=10., distance=5., material=bk7, radius=10.),
                dict(distance=3., material="air", radius=10.),
                dict(roc=-100., distance=50., material="mirror", radius=12.),
                dict(distance=-48., radius=5.)]
        pupil, half = 8., 7.
    else:
        rows = [dict(material="air"),
                dict(type="xypoly", xy_coefficients=[0, 0, .25, .02, .4],
                     norm_radius=5., distance=5., material=bk7, radius=4.),
                dict(distance=3., material="air", radius=4.),
                dict(distance=40., radius=5.)]
        pupil, half = 2., 2.5
    s = System(rows)
    s.object.pupil.radius = pupil
    s.object.pupil.update_radius = False
    s.update()
    return s, half


#: freeform table lenses (make_table): a freeform on an aspheric base and
#: on a grating row
_FREEFORM_TABLES = {
    "aspheric base": dict(
        curvature=[0., 1/60., -1/80., 0.], conic=[0., -.6, 0., 0.],
        aspherics=[[0., 0.], [2e-6, -3e-9], [0., 0.], [0., 0.]],
        xy_poly=[[0.]*9, [1e-4, -2e-4, 3e-3, 1e-3, -2e-3, 2e-5, -1e-5, 3e-5,
                          1e-5], [0.]*9, [0.]*9],
        distance=[0., 10., 4., 40.], n_before=[1., 1., 1.5, 1.],
        n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.],
        radius=[np.inf, 9., 9., 20.]),
    "freeform grating": dict(
        curvature=[0., 1/70., 0., 0.], grating_dy=[0., .08, 0., 0.],
        xy_poly=[[0.]*5, [0., 0., 2e-3, -1e-3, 1.5e-3], [0.]*5, [0.]*5],
        distance=[0., 10., 3., 40.], n_before=[1., 1., 1.5, 1.],
        n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.],
        radius=[np.inf, 9., 9., 20.])}


def _freeform_case(name, device):
    """(table on `device`, specs, bench half width) of a freeform lens."""
    if name in _FREEFORM_TABLES:
        tab = make_table(**_FREEFORM_TABLES[name], device=device)
        half = 5.
    else:
        s, half = _freeform_system(name)
        tab = s.table(device=device)
    return tab, specialize(tab), half


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["schmidt", "figured schmidt",
                                  "zernike corrector", "xy singlet",
                                  "aspheric base", "freeform grating"])
def test_freeform_keys_match_plain_on_card(cuda_device, name, dtype, clip):
    """K1, K2, K4 and K5 on a freeform key against their plain versions
    on the card, on two bench bundles within the lens's aperture (1.5x
    wide clipped): slopes within +-0.03, and in float64 also collimated
    on the axis (as the Schmidt corrector's loop runs).  Float64 rays and optical path to
    1e-12 of scale with equal NaN masks, float32 to 5e-5; the moments to
    1e-10 (float32 1e-4) of their scale; K5's columns (the XY
    coefficients last) for a fixed moment cotangent to 1e-9 (float32
    1e-3) of each column's largest, floored at 1e-9 of the largest
    column's (a column that vanishes, mu through a nearly flat plate at
    normal incidence, is rounding); each wrapper launches its kernel
    once a bundle."""
    tab, specs, half = _freeform_case(name, cuda_device)
    assert any(sp.freeform for sp in specs)
    f64 = dtype == torch.float64
    n = 1 << 14
    for slope in (.03, 0.) if f64 else (.03,):
        rng = np.random.RandomState(5)
        xy = rng.uniform(-half, half, (2, n))*(1.5 if clip else 1.)
        uv = rng.uniform(-slope, slope, (2, n))
        uz = np.sqrt(1 - np.square(uv).sum(0))
        state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(
            cuda_device, dtype) for c in (*xy, np.zeros(n), *uv, uz))
        _check_freeform_keys(tab, specs, state, clip, cuda_device)


def _check_freeform_keys(tab, specs, state, clip, cuda_device):
    dtype = state[0].dtype
    f64 = dtype == torch.float64
    n = state[0].shape[0]
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    wrappers = (CT.trace_final, CT.trace_merit, CG.weighted_moments,
                CG.merit_adjoint)
    before = [f.launches for f in wrappers]
    got = CT.trace_final(tab, specs, state, clip)
    ref = CT.trace_final_reference(tab, specs, state, clip)
    mom = CT.trace_merit(tab, specs, state, clip)
    mref = CT.trace_merit_reference(tab, specs, state, clip)
    wm = CG.weighted_moments(tab, specs, state, w, clip)
    wref = CG.weighted_moments_reference(tab, specs, state, w, clip)
    ct = torch.tensor([.3, -.2, .5, 1., .7], dtype=dtype, device=cuda_device)
    pg, cst, cw = CG.merit_adjoint(tab, specs, state, w, ct, clip)
    pref, sref, wr = CG.merit_adjoint_reference(tab, specs, state, w, ct,
                                                clip)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    tol = 1e-12 if f64 else 5e-5
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
        if f64:
            nptest.assert_array_equal(np.isnan(g), np.isnan(r))
        ok = np.isfinite(g) & np.isfinite(r)
        assert ok.mean() > .5
        nptest.assert_allclose(g[ok], r[ok], atol=tol*max(1., np.abs(
            r[ok]).max()), rtol=0)
    for a, b in ((torch.stack(mom), torch.stack(mref)), (wm, wref)):
        a, b = a.double().cpu(), b.double().cpu()
        scale = max(float(b.abs().max()), 1.)
        assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*scale
    nxy = CT.xy_width(tab, specs)
    nq = CG._nslots(tab, specs)
    assert pg.shape == pref.shape == (tab.nsurfaces, nq)
    assert nq == (CG.SLOTS + sum(CG._table_widths(tab))
                  + int(CT.carries_grating(specs)) + nxy)
    assert float(pref[:, nq - nxy:].abs().max()) > 0
    gtol = 1e-9 if f64 else 1e-3
    top = float(pref.double().abs().max())
    for col in range(pg.shape[1]):
        assert torch.isfinite(pg[:, col]).all()
        scale = float(pref[:, col].double().abs().max())
        if scale:
            err = float((pg[:, col].double() - pref[:, col].double())
                        .abs().max())
            assert err <= gtol*max(scale, 1e-9*top), col
    if f64:
        scale = max(float(r.abs().max()) for r in sref)
        for g, r in zip(cst, sref):
            assert float((g - r).abs().max()) <= 1e-9*scale


def _freeform_stack(name, device):
    """(stack of 3 wavelength tables, their specs, the first table, (sphere
    radius, wavelength), bench half width) of a freeform lens: a system's
    own tables (System.tables) and exit pupil; a table lens's with mu
    grown by 1 and 2 % of mu - 1 and its XY coefficients by 3 and 6 %, a
    sphere of radius -40 mm at 550 nm."""
    if name in _FREEFORM_TABLES:
        tab, _, half = _freeform_case(name, device)
        tabs = stack_tables([tab.replace(mu=1 + (tab.mu - 1)*(1 + .01*li),
                                         xy_poly=tab.xy_poly*(1 + .03*li))
                             for li in range(3)])
        sphere = (-40., 550e-9)
    else:
        s, half = _freeform_system(name)
        tab, tabs = s.table(device=device), s.tables(device=device)
        sphere = (-s.image.pupil.distance, s.wavelengths[0])
    return tabs, CT.multi_specs(tabs, None), tab, sphere, half


#: the freeform lenses of the K3, K6-K9 and K10-K13 card test
_FREEFORM_CARD = ("schmidt", "zernike corrector", "xy singlet",
                  "aspheric base", "freeform grating")


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", _FREEFORM_CARD)
def test_freeform_rows_refuse_the_other_kernels_on_card(cuda_device, name,
                                                        dtype, clip):
    """K3 (trace and merit), K6, K7, K8 and K9 on a freeform key against
    their plain versions on the card (the other kernels took the
    freeform rows in ROADMAP Queue 1 item 9.5 part two, K10-K13 in part
    three: in float64, K10-K13 on the lens's three wavelength plans, fast
    and exact, as _df32_plans_match_on_card holds them), the
    bench bundle within the lens's aperture (1.5x wide clipped; K3 has no
    clip), slopes within +-0.03, ray 0 the chief ray on the axis: K3's
    rays and optical path through each of the stack's three tables to
    1e-12 of scale in float64 with equal NaN masks, float32 5e-5; K3's
    and K6's moments to 1e-10 (float32 1e-4) of their scale; K7's
    columns (the XY coefficients last, per table) for a fixed moment
    cotangent to 1e-9 (float32 1e-3) of each column's largest, floored
    at 1e-9 of the largest column's; K8's k to 1e-12 of max |k| (float32
    1e-4), and in float64 K9's columns (the XY coefficients last) for a
    fixed cotangent as K7's, floored at 1e-5 of the largest column's (a
    ray's cotangents carry its path to the reference sphere, ~7e6 waves
    on the Schmidt plate: the mu column cancels to ~3e-7 of the largest
    and is off by up to 2e-15 of it, float64 rounding); each wrapper
    launches its kernel once a call and falls back to no plain
    version."""
    tabs, specs, tab, (radius, lam), half = _freeform_stack(name,
                                                            cuda_device)
    assert any(sp.freeform for sp in specs)
    f64 = dtype == torch.float64
    n = 1 << 14
    rng = np.random.RandomState(6)
    xy = rng.uniform(-half, half, (2, n))*(1.5 if clip else 1.)
    uv = rng.uniform(-.03, .03, (2, n))
    xy[:, 0] = uv[:, 0] = 0.
    uz = np.sqrt(1 - np.square(uv).sum(0))
    state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(cuda_device,
                                                               dtype)
                  for c in (*xy, np.zeros(n), *uv, uz))
    w = torch.full((n,), 1/n, dtype=dtype, device=cuda_device)
    wrappers = (CT.trace_multi, CG.weighted_moments_multi,
                CG.merit_adjoint_multi, CG.opd_chain, CG.opd_adjoint)
    before = [f.launches for f in wrappers]
    tol = 1e-12 if f64 else 5e-5
    if not clip:
        got = CT.trace_multi(tabs, specs, state)
        ref = CT.trace_multi_reference(tabs, specs, state)
        mom = CT.trace_multi(tabs, specs, state, merit=True)
        mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
        for li in range(3):
            for g, r in zip((*got[li][0], got[li][1]),
                            (*ref[li][0], ref[li][1])):
                g, r = g.double().cpu().numpy(), r.double().cpu().numpy()
                if f64:
                    nptest.assert_array_equal(np.isnan(g), np.isnan(r))
                ok = np.isfinite(g) & np.isfinite(r)
                assert ok.mean() > .5
                nptest.assert_allclose(g[ok], r[ok], rtol=0, atol=tol*max(
                    1., np.abs(r[ok]).max()))
            a = torch.stack(mom[li]).double().cpu()
            b = torch.stack(mref[li]).double().cpu()
            assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*max(
                float(b.abs().max()), 1.)
    wm = CG.weighted_moments_multi(tabs, specs, state, w, clip)
    wref = CG.weighted_moments_multi_reference(tabs, specs, state, w, clip)
    a, b = wm.double().cpu(), wref.double().cpu()
    assert float((a - b).abs().max()) <= (1e-10 if f64 else 1e-4)*max(
        float(b.abs().max()), 1.)
    gtol = 1e-9 if f64 else 1e-3

    def close_columns(pg, pref, floor=1e-9):
        top = float(pref.double().abs().max())
        for col in range(pg.shape[-1]):
            assert torch.isfinite(pg[..., col]).all()
            scale = float(pref[..., col].double().abs().max())
            if scale:
                err = float((pg[..., col].double() - pref[..., col].double())
                            .abs().max())
                assert err <= gtol*max(scale, floor*top), col
    nxy = CT.xy_width(tab, specs)
    ct = torch.tensor([[.3, -.2, .5, 1., .7]]*3, dtype=dtype,
                      device=cuda_device)
    pg, _, _ = CG.merit_adjoint_multi(tabs, specs, state, w, ct, clip)
    pref, _, _ = CG.merit_adjoint_multi_reference(tabs, specs, state, w,
                                                  ct, clip)
    nq = CG._nslots(tabs, specs)
    assert pg.shape == pref.shape == (3, tab.nsurfaces, nq)
    assert float(pref[..., nq - nxy:].abs().max()) > 0
    for li in range(3):
        close_columns(pg[li], pref[li])
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
    yr, _, _ = trace_rays_final(tab, y0, u0, specs=specs)
    aux = torch.cat([yr[0], torch.tensor([radius, lam/1e-3],
                                         dtype=torch.float64,
                                         device=cuda_device)]).to(dtype)
    k = CG.opd_chain(tab, specs, state, aux, clip)
    kref = CG.opd_chain_reference(tab, specs, state, aux, clip)
    g, r = k[0].double().cpu().numpy(), kref[0].double().cpu().numpy()
    ok = np.isfinite(g) & np.isfinite(r)
    assert ok.mean() > .5
    nptest.assert_allclose(g[ok], r[ok], rtol=0, atol=(
        1e-12 if f64 else 1e-4)*max(1., np.abs(r[ok]).max()))
    if f64:
        live = torch.from_numpy(ok).to(cuda_device)
        gen = torch.Generator(device="cpu").manual_seed(7)
        cts = tuple(torch.where(live, torch.randn(n, generator=gen,
                                                  dtype=dtype).to(
            cuda_device), 0.) for _ in range(3))
        pg, _, cc = CG.opd_adjoint(tab, specs, state, aux, cts, clip)
        pref, _, cr = CG.opd_adjoint_reference(tab, specs, state, aux, cts,
                                               clip)
        nq = CG._nslots(tab, specs, CS.OPD_SLOTS)
        assert pg.shape == pref.shape == (tab.nsurfaces, nq)
        assert float(pref[:, nq - nxy:].abs().max()) > 0
        close_columns(pg, pref, 1e-5)
        assert _max_rel(cc, cr) <= 1e-9
    torch.cuda.synchronize()
    calls = [2 if not clip else 0, 1, 1, 1, 1 if f64 else 0]
    assert [f.launches for f in wrappers] == [b + c for b, c in
                                              zip(before, calls)]
    if f64:
        _prebuild_df32_freeform()
        st = D.state_from_f64(torch.stack(state[:3], 1),
                              torch.stack(state[3:], 1))
        for fast in (True, False):
            plans = _df32_freeform_plans(name, fast, clip)
            assert any(CD.fig_of(f) == CD.FIG_FREEFORM
                       for f in CS.df32_flags(plans)[0])
            _df32_plans_match_on_card(plans, st, clip)


def _df32_freeform_plans(name, fast, clip):
    """A freeform lens's three wavelength plans (_freeform_stack's
    tables), on the card."""
    tabs = _freeform_stack(name, torch.device("cuda"))[0]
    return [D.plan(table_at(tabs, li), clip=clip, fast=fast)
            for li in range(3)]


@functools.lru_cache(maxsize=None)
def _prebuild_df32_freeform():
    """Build the K10-K13 keys of every freeform lens of the card test at
    once, the first time a case asks."""
    keys = []
    for name in _FREEFORM_CARD:
        for fast in (True, False):
            for clip in (False, True):
                plans = _df32_freeform_plans(name, fast, clip)
                keys += [CS.df32_multi_key(plans[:1], "k11", True),
                         CS.df32_multi_key(plans[:1], "k13"),
                         CS.df32_multi_key(plans, "k11", True),
                         CS.df32_multi_key(plans, "k13")]
    CS.prebuild(keys)


# -- the rot cotangent: K5, K7 and K9 rot keys (pose gradients) ----------

_POSE_IMAGE_TILT = (1e-3, 2e-3, 0.)
#: the pose lenses (chip_smoke.pose_lenses): (build, {row: tilt}, {row:
#: decenter}, bench half width, every pose live); the image row tilted
#: on each
_POSE_CASES = {
    "double Gauss": (double_gauss, {3: (4e-3, -2e-3, 0.),
                                    12: _POSE_IMAGE_TILT},
                     {9: (.04, -.02, 0.)}, 11.6, True),
    "aspheric double Gauss": (_aspheric_double_gauss,
                              {7: (3e-3, -1e-3, 0.), 2: (2e-3, 1e-3, 0.),
                               12: _POSE_IMAGE_TILT}, {5: (.03, .02, 0.)},
                              11.6, False),
    "biconic": (lambda: _anamorphic_system("biconic"),
                {1: (8e-3, -5e-3, 0.), 3: _POSE_IMAGE_TILT},
                {1: (.05, -.03, 0.)}, 4., False),
    "toroid": (lambda: _anamorphic_system("toroid"),
               {1: (6e-3, 4e-3, 0.), 3: _POSE_IMAGE_TILT},
               {2: (.04, .02, 0.)}, 4., False),
    "hybrid achromat": (lambda: _phase_system("hybrid_achromat")[0],
                        {2: (5e-3, -3e-3, 0.), 3: _POSE_IMAGE_TILT},
                        {1: (.03, 0., 0.)}, 6., False),
    "spectrograph": (lambda: _phase_system("spectrograph")[0],
                     {1: (2e-3, -1e-3, 0.), 2: _POSE_IMAGE_TILT}, {}, 10.,
                     False),
    "figured schmidt": (lambda: _freeform_system("figured schmidt")[0],
                        {1: (4e-3, -3e-3, 0.), 4: _POSE_IMAGE_TILT},
                        {1: (.1, -.05, 0.)}, 17., False)}


def _posed(table, tilts, decs):
    from rayopt_tpu_torch.ops.tables import lower_pose
    shape = table.offset.shape
    t = torch.zeros(shape[-2:], dtype=torch.float64)
    d = torch.zeros_like(t)
    for j, v in tilts.items():
        t[j] = torch.tensor(v, dtype=torch.float64)
    for j, v in decs.items():
        d[j] = torch.tensor(v, dtype=torch.float64)
    dev = table.offset.device
    return lower_pose(table.replace(tilt=t.expand(shape).to(dev),
                                    decenter=d.expand(shape).to(dev)))


def _pose_case(name, device):
    """(system, posed table, its specs, posed stack of 3 tables, its
    specs, bench half width) of a pose lens: the stack is the system's
    wavelengths, a one-glass lens's table with mu grown by 0, 1 and 2 %
    of mu - 1 (the anamorphic lenses) or at 1, 0.9 and 1.1 times its
    wavelength (the phase lenses)."""
    from rayopt_tpu_torch.ops.kernels import with_pose
    build, tilts, decs, half, live = _POSE_CASES[name]
    s = build()
    tab = s.table(device=device)
    if name in ("biconic", "toroid"):
        tabs = stack_tables([tab.replace(mu=1 + (tab.mu - 1)*(1 + .01*li))
                             for li in range(3)])
    elif name in ("hybrid achromat", "spectrograph"):
        lam = list(s.wavelengths)
        if len(lam) < 3:
            lam = [lam[0], .9*lam[0], 1.1*lam[0]]
        tabs = s.tables(lam, device=device)
    else:
        tabs = s.tables(device=device)
    tab, tabs = _posed(tab, tilts, decs), _posed(tabs, tilts, decs)
    specs, mspecs = specialize(tab), CT.multi_specs(tabs, None)
    if live:
        specs, mspecs = with_pose(specs), with_pose(mspecs)
    return s, tab, specs, tabs, mspecs, half


def _pose_state(n, half, dtype, device, widen=1.):
    """The bench bundle of a pose lens: x, y uniform in +-half mm (times
    `widen`), u = (0, 0, 1), ray 0 on the axis (the chief ray)."""
    rng = np.random.RandomState(11)
    xy = rng.uniform(-half*widen, half*widen, (2, n))
    xy[:, 0] = 0.
    zero, one = np.zeros(n), np.ones(n)
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device, dtype)
                 for c in (*xy, zero, zero, zero, one))


def _pose_aux(s, tab, specs, state):
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
    yr, _, _ = trace_rays_final(tab, y0, u0, specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [-s.image.pupil.distance, s.wavelengths[0]/s.scale],
        dtype=torch.float64, device=state[0].device)]).to(state[0].dtype)


def _pose_columns(got, want, rel, floor):
    """Each parameter column (the last axis) within `rel` of its largest
    plain value floored at `floor` of the key's largest; a zero column
    exactly zero."""
    g, w = got.double().cpu(), want.double().cpu()
    dims = tuple(range(w.dim() - 1))
    scale = w.abs().amax(dim=dims)
    err = (g - w).abs().amax(dim=dims)
    held = torch.where(scale > 0, torch.clamp(scale, min=floor*float(
        scale.max())), torch.zeros_like(scale))
    assert bool(torch.isfinite(g).all())
    bad = (err > rel*held).nonzero()[:, 0].tolist()
    assert not bad, "columns %s: errors %s of %s" % (
        bad, err[bad].tolist(), held[bad].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(_POSE_CASES))
def test_pose_rot_keys_match_plain_on_card(cuda_device, name, dtype, clip):
    """The K5, K7 and K9 rot keys (every field and rot, with the ray
    cotangents) against their plain versions on a tilted sphere, conic,
    asphere, biconic, toroid, DOE, grating and freeform row, the image
    row tilted (its two uses of the rotation), at 2^14 rays, clip off
    and on (the clipped bundle 1.5x wide): float64 each column within
    1e-9 of its largest, floored at 1e-9 of the key's (K9: 1e-5; the
    ray cotangents' positions and directions within 1e-9 of each kind's
    largest, as chip_smoke's compare_ray_grads); float32 the rot block
    within 1e-3 of its largest (K5, K7; the spectrograph's not held: its
    off-axis centroid cancels float32 moments) and K9's within 1e-2 of
    the float64 plain version's sums of |term| (the Schmidt plates' not
    held: their ~7e6-wave paths)."""
    s, tab, specs, tabs, mspecs, half = _pose_case(name, cuda_device)
    state = _pose_state(1 << 14, half, dtype, cuda_device,
                        1.5 if clip else 1.)
    w = torch.full((1 << 14,), 1./(1 << 14), dtype=dtype, device=cuda_device)
    every, every9 = CS.FIELDS + ("rot",), CS.OPD_DIFF + ("rot",)
    rot = CS.ROT
    launches = (CG.merit_adjoint.rot_launches,
                CG.merit_adjoint_multi.rot_launches,
                CG.opd_adjoint.rot_launches)
    ct = _rms_cotangent(CG.weighted_moments_reference(tab, specs, state, w,
                                                      clip))
    pg, st, gw = CG.merit_adjoint(tab, specs, state, w, ct, clip,
                                  fields=every)
    pr, sr, wr = CG.merit_adjoint_reference(tab, specs, state, w, ct, clip,
                                            rot=True)
    mom = CG.weighted_moments_multi_reference(tabs, mspecs, state, w, clip)
    m = mom.detach().double().cpu().requires_grad_()
    CG.union_spot_rms_from_moments(m).backward()
    mct = m.grad.to(device=cuda_device, dtype=dtype).contiguous()
    pm, _, _ = CG.merit_adjoint_multi(tabs, mspecs, state, w, mct, clip,
                                      fields=every)
    pmr, _, _ = CG.merit_adjoint_multi_reference(tabs, mspecs, state, w,
                                                 mct, clip, rot=True)
    aux = _pose_aux(s, tab, specs, state)
    k = CG.opd_chain(tab, specs, state, aux, clip)[0]
    kk = k.detach().double().cpu().requires_grad_()
    CG.wavefront_rms_of(kk - kk[0]).backward()
    cts = (kk.grad.to(device=cuda_device, dtype=dtype).contiguous(),
           torch.zeros_like(k), torch.zeros_like(k))
    po, so, co = CG.opd_adjoint(tab, specs, state, aux, cts, clip,
                                fields=every9)
    torch.cuda.synchronize()
    assert (CG.merit_adjoint.rot_launches, CG.merit_adjoint_multi.rot_launches,
            CG.opd_adjoint.rot_launches) == tuple(v + 1 for v in launches)
    rows = [j for j, sp in enumerate(specs) if j and sp.rotated]
    assert pr[rows][:, -rot:].abs().max() > 0
    assert not pg[[j for j in range(len(specs)) if j not in rows]][
        :, -rot:].any()
    if dtype == torch.float64:
        _pose_columns(pg, pr, 1e-9, 1e-9)
        _pose_columns(pm, pmr, 1e-9, 1e-9)
        por, sor, cor = CG.opd_adjoint_reference(tab, specs, state, aux, cts,
                                                 clip, rot=True)
        _pose_columns(po, por, 1e-9, 1e-5)
        # positions, directions and the centre each held to their
        # largest (a component can vanish: the initial z of a collimated
        # ray)
        for got, want in ((st[:3], sr[:3]), (st[3:], sr[3:]),
                          (so[:3], sor[:3]), (so[3:], sor[3:]),
                          ((co,), (cor,))):
            scale = max(float(r.abs().max()) for r in want)
            for g, r in zip(got, want):
                nptest.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=1e-9*scale)
        return
    if name != "spectrograph":
        for got, want in ((pg, pr), (pm, pmr)):
            g, r = got[..., -rot:].double(), want[..., -rot:].double()
            assert float((g - r).abs().max()) <= 1e-3*float(r.abs().max())
    if name != "figured schmidt":
        s64 = tuple(c.double() for c in state)
        c64 = tuple(c.double() for c in cts)
        base = CG.opd_adjoint_reference(tab, specs, s64, aux.double(), c64,
                                        clip, rot=True)[0][:, -rot:]
        mass = CG.opd_adjoint_reference(
            tab, specs, s64, aux.double(), tuple(c.abs() for c in c64), clip,
            rot=True)[0][:, -rot:]
        assert float((po[:, -rot:].double() - base).abs().max()) <= \
            1e-2*float(mass.abs().max())


@pytest.mark.cuda
def test_pose_rot_keys_match_central_differences_on_card(cuda_device):
    """On the posed double Gauss (every pose live), float64, 2^14 rays:
    d/d(tilt, decenter) through K5 (the spot RMS of K4's moments), K7
    (the union spot RMS of K6's) and K9 (the wavefront RMS of K8's k,
    ray 0 the chief ray) against central differences (step 1e-6) of the
    forward kernels' merits, within 1e-6; row 0's tilt gradient is
    zero."""
    from rayopt_tpu_torch.ops.tables import lower_pose
    s, tab, specs, tabs, mspecs, half = _pose_case("double Gauss",
                                                   cuda_device)
    n = 1 << 14
    state = _pose_state(n, half, torch.float64, cuda_device)
    w = torch.full((n,), 1./n, dtype=torch.float64, device=cuda_device)
    nsurf, nlam = tab.curvature.shape[0], tabs.curvature.shape[0]
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    aux = _pose_aux(s, tab, specs, state)
    kw = dict(ref=0, radius=float(aux[3]), wavelength=s.wavelengths[0],
              scale=s.scale, finite=s.object.finite)
    zero = torch.zeros((nsurf, 3), dtype=torch.float64, device=cuda_device)

    def grads(kname):
        tilt = zero.clone().requires_grad_()
        dec = zero.clone().requires_grad_()
        tb = tab.replace(tilt=tilt, decenter=dec)
        if kname == "K5":
            v = CT.spot_rms_from_moments(*CG.spot_moments(tb, state, w,
                                                          specs=specs))
        elif kname == "K7":
            v = CG.union_spot_rms_from_moments(CG.spot_moments_multi(
                tabs.replace(tilt=tilt.expand(nlam, -1, -1),
                             decenter=dec.expand(nlam, -1, -1)), state,
                w/nlam, specs=mspecs))
        else:
            v = CG.adjoint_wavefront_rms(tb, y0, u0, w, specs=specs, **kw)
        v.backward()
        return {"tilt": tilt.grad, "decenter": dec.grad}

    def forward(kname, tilt, dec):
        tb = lower_pose(tab.replace(tilt=tilt, decenter=dec))
        if kname == "K5":
            return float(CT.spot_rms_from_moments(*CG.weighted_moments(
                tb, specs, state, w)))
        if kname == "K7":
            tbs = lower_pose(tabs.replace(tilt=tilt.expand(nlam, -1, -1),
                                          decenter=dec.expand(nlam, -1, -1)))
            return float(CG.union_spot_rms_from_moments(
                CG.weighted_moments_multi(tbs, mspecs, state, w/nlam)))
        k = CG.opd_chain(tb, specs, state, _pose_aux(s, tb, specs, state))[0]
        return float(CG.wavefront_rms_of(k - k[0], w))
    h = 1e-6
    for kname in ("K5", "K7", "K9"):
        g = grads(kname)
        assert not g["tilt"][0].any()
        for field, row, comp in (("tilt", 3, 1), ("tilt", 12, 0),
                                 ("decenter", 9, 0), ("decenter", 5, 1)):
            side = []
            for sgn in (1., -1.):
                v = zero.clone()
                v[row, comp] = sgn*h
                side.append(forward(kname, v, zero) if field == "tilt"
                            else forward(kname, zero, v))
            fd = (side[0] - side[1])/(2*h)
            nptest.assert_allclose(float(g[field][row, comp]), fd, rtol=1e-6,
                                   err_msg="%s %s[%d, %d]" % (kname, field,
                                                              row, comp))
