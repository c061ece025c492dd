"""The specialization of K4 and K5 per spec tuple (ops.cuda_spec) on
the CPU: the key (stable, and changed by every part of it), the live
parameter slots (the complement of the specs' baked-out rows, AND-ed
with the fields that need a gradient), the translation unit a key
writes, and the K5 wrapper's slot set and ray-cotangent flag, which on
a CPU bundle mask the plain version's result.  The kernels themselves
build and run only on a CUDA card (tests/test_torch_cuda.py)."""

import itertools

import numpy as np
import pytest
import torch

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.models import cooke_triplet, double_gauss
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops.kernels import specialize, with_pose

F32, F64 = torch.float32, torch.float64
OPT_FIELDS = ("curvature", "offset")


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _specs(name):
    s = {"cooke": cooke_triplet, "double_gauss": double_gauss}[name]()
    return specialize(s.table())


def test_key_is_stable_and_changes_with_each_part():
    specs = _specs("double_gauss")
    base = CS.adjoint_key(specs, F64, False, OPT_FIELDS, False)
    # the same arguments give the same key and name, in any field order
    again = CS.adjoint_key(list(specs), F64, 0, ("offset", "curvature"), 0)
    assert again == base and again.name == base.name
    # the name is a pure function of the key's value
    assert base.name == CS.Key(*tuple(base)).name
    assert base.name.startswith("k5_") and len(base.name) == 3 + 16
    variants = [
        CS.adjoint_key(specs, F32, False, OPT_FIELDS, False),
        CS.adjoint_key(with_pose(specs), F64, False, OPT_FIELDS, False),
        CS.adjoint_key(_specs("cooke"), F64, False, OPT_FIELDS, False),
        CS.adjoint_key(specs, F64, True, OPT_FIELDS, False),
        CS.adjoint_key(specs, F64, False, ("curvature",), False),
        CS.adjoint_key(specs, F64, False, CS.FIELDS, False),
        CS.adjoint_key(specs, F64, False, OPT_FIELDS, True),
        CS.adjoint_key(specs, F64, False, OPT_FIELDS, False, block=64),
        CS.adjoint_key(specs, F64, False, OPT_FIELDS, False, min_blocks=2),
        CS.moments_key(specs, F64, False),
    ]
    names = [base.name] + [k.name for k in variants]
    assert len(set(names)) == len(names)
    k4 = {CS.moments_key(specs, dt, clip).name
          for dt, clip in itertools.product((F32, F64), (False, True))}
    assert len(k4) == 4
    with pytest.raises(TypeError, match="float32 or float64"):
        CS.moments_key(specs, torch.float16)
    with pytest.raises(ValueError, match="differentiates"):
        CS.adjoint_key(specs, F64, fields=("radius",))


@pytest.mark.parametrize("name", ["cooke", "double_gauss", "cooke_pose"])
@pytest.mark.parametrize("fields", [OPT_FIELDS, CS.FIELDS, ("mu",),
                                    ("conic", "offset"), ()])
def test_live_slots_are_the_unbaked_fields_that_need_grad(name, fields):
    specs = (with_pose(_specs("cooke")) if name == "cooke_pose"
             else _specs(name))
    live = CS.live_mask(CS.live_slots(specs, fields)).numpy()
    want = np.zeros_like(live)
    for q, f in enumerate(CS.SLOT_FIELDS):
        if f not in fields:
            continue
        baked = set(CG._baked_out_rows(specs, f)) if q != 4 else set()
        for j in range(1, len(specs)):
            want[j, q] = j not in baked
    np.testing.assert_array_equal(live, want)
    key = CS.adjoint_key(specs, F64, False, fields, False)
    assert key.nlive == int(want.sum())
    # the row words carry each row's flags below the live slots
    for j, (wd, sp) in enumerate(zip(key.words, specs)):
        assert wd & ((1 << CS.LIVE_SHIFT) - 1) == CS._flags(sp)
        assert [bool(wd >> CS.LIVE_SHIFT >> q & 1) for q in range(6)] == \
            list(want[j])


def test_optimizer_slot_set_on_the_double_gauss():
    """curvature on the 8 curved rows, the axial offset on all 12 traced
    rows: 20 slots of the 72 a run-time adjoint reduces."""
    specs = _specs("double_gauss")
    key = CS.adjoint_key(specs, F64, False, OPT_FIELDS, False)
    assert sum(not s.flat for s in specs[1:]) == 8
    assert key.nlive == 20
    assert CS.adjoint_key(specs, F64).nlive == 30


def test_translation_unit_instantiates_the_key():
    specs = _specs("double_gauss")
    k5 = CS.adjoint_key(specs, F64, True, OPT_FIELDS, False)
    text = CS.translation_unit(k5)
    assert '#include "grad_spec.cuh"' in text
    assert "Chain<%s>" % ", ".join(map(str, k5.words)) in text
    assert "RAYOPT_SPEC_ADJOINT(%s, double, Rows, true, false, %d, %d)" % (
        k5.name, k5.block, k5.min_blocks) in text
    k4 = CS.moments_key(specs, F32)
    assert "RAYOPT_SPEC_MOMENTS(%s, float, Rows, false, %d, %d)" % (
        k4.name, k4.block, k4.min_blocks) in CS.translation_unit(k4)
    # the saved states: 12 traced rows x 6 words x 128 threads in f64
    assert k5.dynamic_smem == 12*6*128*8


def test_adjoint_refuses_a_table_whose_states_outgrow_shared_memory():
    specs = _specs("double_gauss")
    many = specs[:1] + specs[1:]*4
    with pytest.raises(ValueError, match="shared memory"):
        CS.adjoint_key(many, F64)


def _bundle(n=256, seed=3):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-10, 10, (n, 2))
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.05, .05, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return (tuple(torch.from_numpy(np.ascontiguousarray(c))
                  for c in (*y.T, *u.T)), torch.from_numpy(w))


@pytest.mark.parametrize("rays", [False, True])
@pytest.mark.parametrize("fields", [OPT_FIELDS, CS.FIELDS])
def test_cpu_adjoint_masks_slots_and_drops_ray_cotangents(fields, rays):
    tab = double_gauss().table()
    specs = specialize(tab)
    state, w = _bundle()
    ct = torch.tensor([.1, -.2, .3, .4, -.5], dtype=F64)
    ref = CG.merit_adjoint_reference(tab, specs, state, w, ct)
    before = CG.merit_adjoint.launches
    pg, st, gw = CG.merit_adjoint(tab, specs, state, w, ct, fields=fields,
                                  rays=rays)
    assert CG.merit_adjoint.launches == before
    live = CS.live_mask(CS.live_slots(specs, fields))
    assert torch.equal(pg, torch.where(live, ref[0], 0.))
    if rays:
        for a, b in zip((*st, gw), (*ref[1], ref[2])):
            assert torch.equal(a, b)
    else:
        assert st is None and gw is None


def test_spot_moments_backward_asks_only_for_what_needs_grad():
    """Through the autograd Function the K5 wrapper gets the fields that
    require grad and rays=False for a frozen bundle: the gradients equal
    autograd's, and the bundle and weights receive none."""
    tab = double_gauss().table()
    specs = specialize(tab)
    state, w = _bundle()
    c = tab.curvature.clone().requires_grad_()
    off = tab.offset.clone().requires_grad_()
    calls = []
    real = CG.merit_adjoint

    def spy(*args, **kw):
        calls.append((kw["fields"], kw["rays"]))
        return real(*args, **kw)
    CG.merit_adjoint = spy
    try:
        mom = CG.spot_moments(tab.replace(curvature=c, offset=off), state,
                              w, specs=specs)
        sum(m for m in mom).backward()
    finally:
        CG.merit_adjoint = real
    assert calls == [(("curvature", "offset"), False)]
    ct = torch.ones(5, dtype=F64)
    ref = CG.merit_adjoint_reference(tab, specs, state, w, ct)[0]
    torch.testing.assert_close(c.grad, ref[:, 0], rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(off.grad, ref[:, 2:5], rtol=1e-12, atol=1e-15)
    # a bundle that requires grad gets its cotangents
    st = tuple(s.clone().requires_grad_() for s in state)
    mom = CG.spot_moments(tab, st, w, specs=specs)
    sum(m for m in mom).backward()
    assert all(s.grad is not None for s in st)
