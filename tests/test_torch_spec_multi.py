"""The specialization of the polychromatic trace K3, the polychromatic
forward K6, the polychromatic adjoint K7 and the OPD adjoint K9 per
spec tuple (ops.cuda_spec) on the CPU: K3's keys (trace and merit, the
merit K6's template unweighted) and its wrapper's balanced runs, which
take every stack the earlier run-time K3 took, the refusal of a K6
stack past static shared memory or its wavelength limit, the K6
wrapper's split of a longer stack into balanced runs (the keys it
loads), its plain version on a CPU bundle, the keys of K7 and K9
(stable, and changed by every
part of them), K9's live slots over its seven
columns (n_before on every row, the image row read only by the
reference-sphere tail), the translation unit a key writes, the refusal
of a table whose saved states outgrow shared memory, the wrappers'
slot sets and ray-cotangent flag, which on a CPU bundle mask the plain
version's result, and the autograd Functions asking their adjoint only
for what needs a gradient while the gradients still match the JAX
package's XLA engine.  The kernels themselves build and run only on a
CUDA card (tests/test_torch_cuda.py)."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu import glass as JGL
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.models import cooke_triplet, double_gauss
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops.cuda_build import CSRC
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.geometric import trace_rays_final
from rayopt_tpu_torch.ops.kernels import specialize, with_pose

F32, F64 = torch.float32, torch.float64
ACHROM_FIELDS = ("curvature", "offset", "mu")
DESIGN_FIELDS = ("curvature", "offset")
KEYS = {"k7": CS.adjoint_multi_key, "k9": CS.opd_adjoint_key}


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _specs(name):
    s = {"cooke": cooke_triplet, "double_gauss": double_gauss}[name]()
    return specialize(s.table())


@pytest.mark.parametrize("kernel", ["k7", "k9"])
def test_key_is_stable_and_changes_with_each_part(kernel):
    make = KEYS[kernel]
    specs = _specs("double_gauss")
    base = make(specs, F64, False, DESIGN_FIELDS, False)
    again = make(list(specs), F64, 0, ("offset", "curvature"), 0)
    assert again == base and again.name == base.name
    assert base.name == CS.Key(*tuple(base)).name
    assert base.name.startswith(kernel + "_") and len(base.name) == 19
    every = CS.FIELDS if kernel == "k7" else CS.OPD_FIELDS
    variants = [
        make(specs, F32, False, DESIGN_FIELDS, False),
        make(with_pose(specs), F64, False, DESIGN_FIELDS, False),
        make(_specs("cooke"), F64, False, DESIGN_FIELDS, False),
        make(specs, F64, True, DESIGN_FIELDS, False),
        make(specs, F64, False, ("curvature",), False),
        make(specs, F64, False, every, False),
        make(specs, F64, False, DESIGN_FIELDS, True),
        make(specs, F64, False, DESIGN_FIELDS, False, block=64),
        make(specs, F64, False, DESIGN_FIELDS, False, min_blocks=2),
        # the other adjoints on the same arguments
        CS.adjoint_key(specs, F64, False, DESIGN_FIELDS, False),
        KEYS["k9" if kernel == "k7" else "k7"](specs, F64, False,
                                               DESIGN_FIELDS, False),
    ]
    names = [base.name] + [k.name for k in variants]
    assert len(set(names)) == len(names)
    with pytest.raises(ValueError, match="differentiates"):
        make(specs, F64, fields=("radius",))
    if kernel == "k7":
        # n_before is K9's seventh column only
        with pytest.raises(ValueError, match="differentiates"):
            make(specs, F64, fields=("n_before",))


@pytest.mark.parametrize("name", ["cooke", "double_gauss", "cooke_pose"])
@pytest.mark.parametrize("fields", [DESIGN_FIELDS, CS.OPD_FIELDS,
                                    ("n_before",), ("mu", "n_before"),
                                    ("conic", "offset"), ()])
def test_opd_live_slots_cover_n_before_and_the_sphere_tail(name, fields):
    """K9's seven columns a row: K5's rule on rows 1..S-2, n_before live
    on every row but row 0 (it carries each row's optical path, and the
    image row's through the sphere), and on the image row only the
    axial offset, the transverse offset when the row is off axis, and
    n_before."""
    specs = (with_pose(_specs("cooke")) if name == "cooke_pose"
             else _specs(name))
    masks = CS.opd_live_slots(specs, fields)
    live = CS.live_mask(masks, CS.OPD_SLOTS).numpy()
    assert live.shape == (len(specs), 7)
    want = np.zeros_like(live)
    want[:, :6] = CS.live_mask(CS.live_slots(
        specs, [f for f in fields if f != "n_before"])).numpy()
    want[1:, 6] = "n_before" in fields
    img = len(specs) - 1
    want[img, [0, 1, 5]] = False
    want[img, 2:4] = ("offset" in fields) and specs[img].off_axis
    np.testing.assert_array_equal(live, want)
    key = CS.opd_adjoint_key(specs, F64, False, fields, False)
    assert key.nlive == int(want.sum())
    for j, (wd, sp) in enumerate(zip(key.words, specs)):
        assert wd & ((1 << CS.LIVE_SHIFT) - 1) == CS._flags(sp)
        assert wd >> CS.LIVE_SHIFT == masks[j]


def test_loop_slot_sets_on_the_double_gauss():
    """The achromatization K7 key: 30 live slots a wavelength (8
    curvatures, 12 axial offsets, 10 refracting mu); the design K9
    key: 20 (8 curvatures, 12 axial offsets, the image row's among
    them), and the three centre cotangents beside them."""
    specs = _specs("double_gauss")
    assert CS.adjoint_multi_key(specs, F64, False, ACHROM_FIELDS,
                                False).nlive == 30
    assert CS.opd_adjoint_key(specs, F64, False, DESIGN_FIELDS,
                              False).nlive == 20
    # every field: K9 adds n_before on the 12 traced rows, and reads no
    # curvature or mu on the image row
    assert CS.opd_adjoint_key(specs, F64).nlive == (
        CS.adjoint_key(specs, F64).nlive + 12
        - int(bool(CS.live_slots(specs)[-1] & 0b100001)))


@pytest.mark.parametrize("kernel,macro,rows", [
    ("k7", "RAYOPT_SPEC_ADJOINT_MULTI", 12),
    ("k9", "RAYOPT_SPEC_OPD_ADJOINT", 11)])
def test_translation_unit_instantiates_the_key(kernel, macro, rows):
    specs = _specs("double_gauss")
    key = KEYS[kernel](specs, F32, True, DESIGN_FIELDS, True)
    text = CS.translation_unit(key)
    assert '#include "grad_spec.cuh"' in text
    assert "Chain<%s>" % ", ".join(map(str, key.words)) in text
    assert "%s(%s, float, Rows, true, true, %d, %d)" % (
        macro, key.name, key.block, key.min_blocks) in text
    # the saved states: the traced rows before the sphere (K9) or all
    # of them (K7) x 6 words x 128 threads in float32
    assert key.dynamic_smem == rows*6*128*4


@pytest.mark.parametrize("kernel", ["k7", "k9"])
def test_adjoint_refuses_a_table_whose_states_outgrow_shared_memory(kernel):
    specs = _specs("double_gauss")
    many = specs[:1] + specs[1:]*4
    with pytest.raises(ValueError, match="shared memory"):
        KEYS[kernel](many, F64)
    # the same chain in float32, or at 64 threads a block, fits
    KEYS[kernel](many, F32)
    KEYS[kernel](many, F64, block=64)


def test_moments_multi_refuses_a_stack_past_shared_memory_or_nlam():
    """K6 keeps every wavelength's table in static shared memory (48 KB)
    and 5 moments a wavelength in registers: a stack past either is
    refused, naming why."""
    specs = _specs("double_gauss")
    many = specs[:1] + specs[1:]*5       # 61 rows
    with pytest.raises(ValueError, match="static shared memory"):
        CS.moments_multi_key(many, F64, False, 7)
    # the same stack in float32, or at 3 wavelengths, fits
    CS.moments_multi_key(many, F32, False, 7)
    CS.moments_multi_key(many, F64, False, 3)
    CS.moments_multi_key(specs, F64, False, CS.MAX_NLAM)
    for nlam in (0, CS.MAX_NLAM + 1):
        with pytest.raises(ValueError, match="registers"):
            CS.moments_multi_key(specs, F64, False, nlam)


@pytest.mark.parametrize("nlam,want", [
    (3, [(0, 3)]), (11, [(0, 11)]), (12, [(0, 6), (6, 12)]),
    (13, [(0, 7), (7, 13)]), (23, [(0, 8), (8, 16), (16, 23)])])
def test_moments_multi_splits_a_stack_past_max_nlam(monkeypatch, nlam, want):
    """weighted_moments_multi launches a stack past MAX_NLAM in balanced
    runs (12 -> 6 + 6, 13 -> 7 + 6), each on its key of the run's
    wavelength count, equal runs on one key; 11 or fewer keep their one
    launch.  cuda_spec.load is patched to record the keys (no build)."""
    keys = []

    def load(key):
        keys.append(key)
        return key
    CG._moments_multi_kernel.cache_clear()
    monkeypatch.setattr(CS, "load", load)
    try:
        specs = _specs("double_gauss")
        runs = CG._moments_multi_runs(specs, F64, False, nlam)
    finally:
        CG._moments_multi_kernel.cache_clear()
    assert [(l0, l1) for l0, l1, _ in runs] == want
    assert [k.nlam for _, _, k in runs] == [l1 - l0 for l0, l1 in want]
    assert all(k == CS.moments_multi_key(specs, F64, False, l1 - l0)
               for l0, l1, k in runs)
    assert len(keys) == len({l1 - l0 for l0, l1 in want})


def _k3_runs(monkeypatch, specs, dtype, nlam, merit):
    """K3's runs for a stack of nlam tables and the keys the wrapper
    loads for them (cuda_spec.load patched: no build)."""
    keys = []

    def load(key):
        keys.append(key)
        return key
    CT._multi_kernel.cache_clear()
    monkeypatch.setattr(CS, "load", load)
    try:
        runs = CT._multi_runs(tuple(specs), dtype, nlam, merit)
    finally:
        CT._multi_kernel.cache_clear()
    return runs, keys


@pytest.mark.parametrize("merit", [False, True])
@pytest.mark.parametrize("nlam,dtype,want", [
    (3, F64, [(0, 3)]), (3, F32, [(0, 3)]), (12, F64, [(0, 6), (6, 12)]),
    (13, F32, [(0, 7), (7, 13)]),
    (40, F64, [(0, 10), (10, 20), (20, 30), (30, 40)])])
def test_trace_multi_runs_one_key_a_run(monkeypatch, merit, nlam, dtype,
                                        want):
    """trace_multi launches one key for a stack of MAX_NLAM wavelengths
    or fewer, and a longer stack in balanced runs (12 -> 6 + 6, 13 ->
    7 + 6, 40 -> 4 x 10), equal runs on one key of the run's wavelength
    count: the merit mode a "k3m" key (K6's template unweighted), the
    trace a "k3" key, neither clipped."""
    specs = _specs("double_gauss")
    runs, keys = _k3_runs(monkeypatch, specs, dtype, nlam, merit)
    assert [(l0, l1) for l0, l1, _ in runs] == want
    assert all(k == CS.trace_multi_key(specs, dtype, l1 - l0, merit)
               for l0, l1, k in runs)
    assert len(keys) == len({l1 - l0 for l0, l1 in want})
    for k in keys:
        assert k.kernel == ("k3m" if merit else "k3") and not k.clip
        assert k.block == CS.BLOCK_MULTI[k.kernel][k.dtype]
        assert k.outer == (False if merit else CS.MULTI_OUTER)
        assert k.shared_bytes <= CS.SMEM_LIMIT


def _run_time_k3_most(specs, dtype, merit):
    """The most wavelengths the earlier run-time K3 staged: its tables,
    the merit's 5 moments a wavelength for each of 256 threads and the
    flags, in 227 KB of opt-in shared memory."""
    word = 4 if dtype == F32 else 8
    rows = len(specs)
    per = (rows*CT.ROW + (5*256 if merit else 0))*word
    return (CT.SMEM_OPTIN - 4*rows)//per


@pytest.mark.parametrize("merit", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("chain", ["double_gauss", "long"])
def test_trace_multi_takes_every_stack_the_run_time_kernel_took(
        monkeypatch, merit, dtype, chain):
    """No wavelength count that the run-time K3 (csrc/trace.cu) took is
    refused: every stack up to its shared-memory limit (about 120
    double Gauss tables for the float64 trace, 18 for the merit), and
    past it, runs in balanced runs of keys that fit, each at most
    multi_most wavelengths; a 61-row chain too."""
    specs = _specs("double_gauss")
    if chain == "long":
        specs = specs[:1] + specs[1:]*5
    most = CS.multi_most("k3m" if merit else "k3", specs, dtype)
    old = _run_time_k3_most(specs, dtype, merit)
    assert 1 <= most <= CS.MAX_NLAM and old >= 3
    for nlam in sorted({1, 2, most, most + 1, old // 2, old, old + 1}):
        runs, keys = _k3_runs(monkeypatch, specs, dtype, nlam, merit)
        assert runs[0][0] == 0 and runs[-1][1] == nlam
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        sizes = [l1 - l0 for l0, l1, _ in runs]
        assert max(sizes) <= most and max(sizes) - min(sizes) <= 1
        assert len(runs) == -(-nlam // most)
        assert all(k.nlam == n for (_, _, k), n in zip(runs, sizes))


def test_trace_multi_keys_refuse_and_instantiate():
    """K3's keys: stable, changed by the dtype, the wavelengths, the
    block and the trace's loop order; refused past MAX_NLAM or static
    shared memory, and for an outer merit; the merit's translation unit
    instantiates the moments template unweighted (RAYOPT_SPEC_MERIT_MULTI
    -> RAYOPT_SPEC_MOMENTS_OF with WEIGHTED false), the trace's
    trace_multi_spec with its loop order in the clip's place."""
    specs = _specs("double_gauss")
    base = CS.trace_multi_key(specs, F64, 3)
    assert base == CS.trace_multi_key(list(specs), F64, 3, False)
    variants = [CS.trace_multi_key(specs, F32, 3),
                CS.trace_multi_key(specs, F64, 4),
                CS.trace_multi_key(specs, F64, 3, block=128),
                CS.trace_multi_key(specs, F64, 3, outer=not CS.MULTI_OUTER),
                CS.trace_multi_key(specs, F64, 3, True),
                CS.moments_multi_key(specs, F64, False, 3),
                CS.trace_key(specs, F64)]
    names = [base.name] + [k.name for k in variants]
    assert len(set(names)) == len(names)
    for merit in (False, True):
        for nlam in (0, CS.MAX_NLAM + 1):
            with pytest.raises(ValueError, match="registers"):
                CS.trace_multi_key(specs, F64, nlam, merit)
    with pytest.raises(ValueError, match="outer"):
        CS.trace_multi_key(specs, F64, 3, True, outer=True)
    huge = specs[:1] + specs[1:]*40       # 481 rows: one table past 48 KB
    assert CS.multi_most("k3", huge, F64) == 0
    with pytest.raises(ValueError, match="static shared memory"):
        CT._multi_runs(tuple(huge), F64, 3, False)
    merit = CS.trace_multi_key(specs, F64, 3, True)
    text = CS.translation_unit(merit)
    assert "RAYOPT_SPEC_MERIT_MULTI(%s, double, Rows, false, 3, %d, %d)" % (
        merit.name, CS.BLOCK_MULTI["k3m"]["f64"], CS.MIN_BLOCKS) in text
    for outer in (False, True):
        key = CS.trace_multi_key(specs, F32, 5, outer=outer)
        assert "RAYOPT_SPEC_TRACE_MULTI(%s, float, Rows, %s, 5, %d, %d)" % (
            key.name, "true" if outer else "false",
            CS.BLOCK_MULTI["k3"]["f32"], CS.MIN_BLOCKS) in \
            CS.translation_unit(key)
    header = (CSRC/"grad_spec.cuh").read_text()
    macro = header[header.index("#define RAYOPT_SPEC_MERIT_MULTI"):]
    macro = " ".join(macro[:macro.index("\n\n")].replace("\\", "").split())
    assert macro.endswith("RAYOPT_SPEC_MOMENTS_OF(NAME, T, CHAIN, CLIP, "
                          "false, NLAM, BLOCK, MINB)")


@pytest.mark.parametrize("merit", [False, True])
@pytest.mark.parametrize("nlam", [3, 12])
def test_cpu_trace_multi_runs_the_plain_version(nlam, merit):
    """K3 on a CPU bundle, past one key's wavelengths too: the plain
    version's result, no launch counted."""
    s = double_gauss()
    tabs = s.tables(list(np.linspace(400e-9, 700e-9, nlam)))
    state, _ = _bundle()
    before = CT.trace_multi.launches
    got = CT.trace_multi(tabs, None, state, merit)
    want = CT.trace_multi_reference(tabs, None, state, merit)
    assert CT.trace_multi.launches == before and len(got) == nlam
    for g, w in zip(got, want):
        for a, b in zip(g if merit else (*g[0], g[1]),
                        w if merit else (*w[0], w[1])):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _bundle(n=256, seed=3):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-10, 10, (n, 2))
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-.05, .05, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    y[0], u[0] = 0., (0., 0., 1.)      # the chief ray, for the OPD
    w = rng.uniform(.5, 1.5, n)
    return (tuple(torch.from_numpy(np.ascontiguousarray(c))
                  for c in (*y.T, *u.T)), torch.from_numpy(w))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("nlam", [1, 3, 7])
def test_cpu_moments_multi_runs_the_plain_version(nlam, clip):
    """K6 on a CPU bundle: the plain version's (nlam, 5) moments, no
    launch counted."""
    s = double_gauss()
    lams = (587.56e-9, 656.27e-9, 486.13e-9, 435.83e-9, 546.07e-9,
            706.52e-9, 404.66e-9)[:nlam]
    tabs = s.tables(lams)
    specs = specialize(TT.table_at(tabs, 0))
    state, w = _bundle()
    before = CG.weighted_moments_multi.launches
    got = CG.weighted_moments_multi(tabs, specs, state, w, clip)
    assert CG.weighted_moments_multi.launches == before
    assert got.shape == (nlam, 5)
    assert torch.equal(got, CG.weighted_moments_multi_reference(
        tabs, specs, state, w, clip))


@pytest.mark.parametrize("rays", [False, True])
@pytest.mark.parametrize("fields", [ACHROM_FIELDS, CS.FIELDS, ()])
def test_cpu_multi_adjoint_masks_slots_and_drops_ray_cotangents(fields,
                                                               rays):
    tabs = double_gauss().tables()
    specs = specialize(TT.table_at(tabs, 0))
    state, w = _bundle()
    ct = torch.from_numpy(np.random.RandomState(1).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tabs, specs, state, w, ct)
    before = CG.merit_adjoint_multi.launches
    pg, st, gw = CG.merit_adjoint_multi(tabs, specs, state, w, ct,
                                        fields=fields, rays=rays)
    assert CG.merit_adjoint_multi.launches == before
    live = CS.live_mask(CS.live_slots(specs, fields))
    assert pg.shape == (3, len(specs), CS.SLOTS)
    assert torch.equal(pg, torch.where(live, ref[0], 0.))
    if rays:
        for a, b in zip((*st, gw), (*ref[1], ref[2])):
            assert torch.equal(a, b)
    else:
        assert st is None and gw is None


def _opd_inputs(tab, specs, state):
    yr, _, _ = trace_rays_final(tab, torch.stack(state[:3], 1)[:1],
                                torch.stack(state[3:], 1)[:1], specs=specs)
    aux = torch.cat([yr[0], torch.tensor([80., 587.56e-6])])
    rng = np.random.RandomState(2)
    cts = tuple(torch.from_numpy(rng.normal(size=state[0].shape[0]))
                for _ in range(3))
    return aux, cts


@pytest.mark.parametrize("rays", [False, True])
@pytest.mark.parametrize("fields", [DESIGN_FIELDS, CS.OPD_FIELDS,
                                    ("mu", "n_before")])
def test_cpu_opd_adjoint_masks_slots_and_drops_ray_cotangents(fields,
                                                             rays):
    tab = double_gauss().table()
    specs = specialize(tab)
    state, _ = _bundle()
    aux, cts = _opd_inputs(tab, specs, state)
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    assert bool(torch.isfinite(ref[0]).all())
    before = CG.opd_adjoint.launches
    pg, st, gc = CG.opd_adjoint(tab, specs, state, aux, cts, fields=fields,
                                rays=rays)
    assert CG.opd_adjoint.launches == before
    live = CS.live_mask(CS.opd_live_slots(specs, fields), CS.OPD_SLOTS)
    assert torch.equal(pg, torch.where(live, ref[0], 0.))
    # a slot that is not live is one the plain version gives zero too,
    # or one not asked for
    every = CS.live_mask(CS.opd_live_slots(specs), CS.OPD_SLOTS)
    assert not bool(ref[0][~every].any())
    assert torch.equal(gc, ref[2])
    if rays:
        for a, b in zip(st, ref[1]):
            assert torch.equal(a, b)
    else:
        assert st is None


def _spy(monkeypatch, name):
    calls = []
    real = getattr(CG, name)

    def spy(*args, **kw):
        calls.append((kw["fields"], kw["rays"]))
        return real(*args, **kw)
    monkeypatch.setattr(CG, name, spy)
    return calls


def _model_doublet(models):
    s = models.doublet()
    s.wavelengths = [480e-9, 550e-9, 644e-9]
    return s


def test_polychromatic_backward_asks_only_for_what_needs_grad(monkeypatch):
    """glass.polychromatic_spot_rms(engine="adjoint") over a curvature
    broadcast on the stack and the stacked mu: K7 is asked for the
    curvature, the offset the caller did not free is left out, mu is
    asked for, and no ray cotangent for a frozen bundle; the gradients
    match jax.grad of the JAX package's XLA engine (specs, unroll=True)
    at test_torch_glass's tolerance, rtol 1e-9, atol 1e-12."""
    js, ts = _model_doublet(jmodels), _model_doublet(tmodels)
    jt, tt = js.tables(), ts.tables()
    rng = np.random.RandomState(3)
    y = np.zeros((128, 3))
    y[:, :2] = rng.uniform(-.25, .25, (128, 2))
    u = np.zeros((128, 3))
    u[:, :2] = rng.uniform(-.002, .002, (128, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, 128)
    w = w/w.sum()
    specs = jspecialize(jax.tree_util.tree_map(lambda a: a[0], jt))

    def jmerit(c, mu):
        t = jt.replace(curvature=jnp.broadcast_to(c, jt.curvature.shape),
                       mu=mu)
        return JGL.polychromatic_spot_rms(t, y, u, w, specs=specs,
                                          unroll=True)
    gc, gm = jax.grad(jmerit, argnums=(0, 1))(
        jnp.asarray(jt.curvature[0]), jnp.asarray(jt.mu))
    calls = _spy(monkeypatch, "merit_adjoint_multi")
    c = tt.curvature[0].clone().requires_grad_()
    mu = tt.mu.clone().requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # flat rows bake curvature out
        TGL.polychromatic_spot_rms(
            tt.replace(curvature=c.expand_as(tt.curvature), mu=mu),
            torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(w),
            specs=TK.specs_from_tuple(specs),
            engine="adjoint").backward()
    assert calls == [(("curvature", "mu"), False)]
    for got, want, name in ((c.grad, gc, "curvature"), (mu.grad, gm, "mu")):
        nptest.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12, err_msg=name)
    # a bundle that requires grad gets its cotangents
    calls.clear()
    y0 = torch.from_numpy(y).requires_grad_()
    CG.polychromatic_spot_rms(tt, y0, torch.from_numpy(u),
                              torch.from_numpy(w),
                              specs=TK.specs_from_tuple(specs)).backward()
    assert calls == [((), True)] and y0.grad is not None


def test_wavefront_backward_asks_only_for_what_needs_grad(monkeypatch):
    """adjoint_wavefront_rms over curvature and offset (the design loop's
    fields) on the Cooke triplet at field .5, a frozen bundle: K9 is
    asked for those two and no ray cotangent (the centre's always), and
    the gradients match jax.grad of the JAX package's
    wavefront_rms(specs=, unroll=True) at test_torch_wavefront's
    GRAD_RTOL 1e-6 (floor 1e-9 of the field's largest value)."""
    from rayopt_tpu import GeometricTrace
    js = jmodels.cooke_triplet()
    jg = GeometricTrace(js)
    jg.rays_point((0, .5), nrays=30, distribution="hexapolar", filter=False)
    y0, u0 = np.asarray(jg.y[0]), np.asarray(jg.u[0])
    w = np.full(len(y0), 1./len(y0))
    tab = js.table(jg.l)
    specs = jspecialize(tab)
    kw = dict(ref=jg.ref, radius=-js.image.pupil.distance,
              wavelength=jg.l, scale=js.scale, finite=js.object.finite)
    p0 = {k: jnp.asarray(getattr(tab, k)) for k in DESIGN_FIELDS}
    gp = jax.grad(lambda p: JGR.wavefront_rms(
        tab.replace(**p), y0, u0, w=w, specs=specs, unroll=True, **kw))(p0)
    calls = _spy(monkeypatch, "opd_adjoint")
    ttab = TT.table_from_numpy(tab)
    leaves = {k: getattr(ttab, k).clone().requires_grad_()
              for k in DESIGN_FIELDS}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # on-axis rows bake x/y out
        CG.adjoint_wavefront_rms(
            ttab.replace(**leaves), torch.from_numpy(y0),
            torch.from_numpy(u0), torch.from_numpy(w),
            specs=TK.specs_from_tuple(specs), **kw).backward()
    assert calls == [(DESIGN_FIELDS, False)]
    for k in DESIGN_FIELDS:
        want = np.asarray(gp[k])
        nptest.assert_allclose(leaves[k].grad.numpy(), want, rtol=1e-6,
                               atol=1e-9*float(np.abs(want).max()),
                               err_msg=k)
