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

from rayopt_tpu_torch.models import double_gauss
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
from rayopt_tpu_torch.ops.kernels import specialize


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
