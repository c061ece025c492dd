"""The df32 kernels K10-K13 compiled per plan key
(ops.cuda_spec.df32_multi_key, csrc/df32_spec.cuh) on the CPU: their
keys (stable, changed by every part of them, one flag tuple for a
table's wavelengths and one more for a plan whose flags differ; K10 and
K12 the keys of one plan; one plan too long for the kernel parameters
on device words), the translation unit a key writes, the keys'
refusals before any build (past the kernel-parameter or shared-memory
limit), the wrappers' split of a plan list into balanced runs that fit
(the keys they load, with cuda_spec.load patched), the wrappers
trace_multi_df32 and trace_merit_multi_df32 on a CPU bundle, which run
their plain versions, count no launch and match the JAX package's eager
df32 word for word, and the premise of the kernels' two_prod: the FMA
form's error word, fl(a*b) subtracted from the exact product, is the
word Dekker's split gives.  The kernels themselves build and run only
on a CUDA card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import rayopt_tpu  # noqa: F401
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import df32 as JD

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.cuda_build import CSRC

MERIT_REL = 1e-13    # df32 moments against the JAX package's (same tree)


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _cooke(nlam=2, fast=False, clip=False):
    """The JAX Cooke triplet's table at its first nlam wavelengths, and
    the JAX and the port's plan of each."""
    js = jmodels.cooke_triplet()
    jtabs = [js.table(lam) for lam in js.wavelengths[:nlam]]
    return (jtabs, [JD.plan(t, clip=clip, fast=fast) for t in jtabs],
            [D.plan(TT.table_from_numpy(t), clip=clip, fast=fast)
             for t in jtabs])


def _bundle(n=256, half=4., seed=9):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*half
    u = np.zeros((n, 3))
    u[:, 2] = 1.
    return y, u


def _pair(j):
    return tuple(torch.from_numpy(np.array(w, dtype=np.float32)) for w in j)


def _same_words(got, want):
    """Identical hi and lo words, NaN where the other is NaN."""
    for g, w in zip(got, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return False
        live = ~torch.isnan(g)
        if not torch.equal(g[live], w[live]):
            return False
    return True


def _flip(plan, j, key, value):
    """The plan with step j's `key` set to `value` (a new flag word)."""
    out = [dict(st) for st in plan]
    out[j][key] = value
    return out


# -- keys ------------------------------------------------------------------

def test_df32_key_is_stable_and_changes_with_each_part():
    """A key is the same for the same plans, and differs when one step's
    flag word, fast, clip, with_path, the wavelength count, the block,
    the launch bound, the placement of the plan words or the kernel
    does."""
    _, _, plans = _cooke(2)
    base = CS.df32_multi_key(plans, "k11", False)
    again = CS.df32_multi_key([list(p) for p in plans], "k11", 0)
    assert again == base and again.name == base.name
    assert base.name == CS.Df32Key(*tuple(base)).name
    assert base.name.startswith("k11_") and len(base.name) == 20
    assert base.block == CS.BLOCK_DF32["k11"]
    assert base.min_blocks == CS.MIN_BLOCKS
    assert base.staged == CS.DF32_STAGED["k11"] and base.nlam == 2
    assert base.tuples == (tuple(CD._step_words(st)[1] for st in plans[0]),)
    step = [_flip(p, 1, "alternate", True) for p in plans]
    variants = [
        CS.df32_multi_key(step, "k11"),
        CS.df32_multi_key(_cooke(2, fast=True)[2], "k11"),
        CS.df32_multi_key(_cooke(2, clip=True)[2], "k11"),
        CS.df32_multi_key(plans, "k11", True),
        CS.df32_multi_key(_cooke(3)[2], "k11"),
        CS.df32_multi_key(plans, "k11", block=512),
        CS.df32_multi_key(plans, "k11", min_blocks=2),
        CS.df32_multi_key(plans, "k11", staged=not base.staged),
        CS.df32_multi_key(plans, "k13")]
    names = [base.name] + [k.name for k in variants]
    assert len(set(names)) == len(names)
    assert variants[0].tuples[0][1] != base.tuples[0][1]
    assert variants[0].tuples[0][2:] == base.tuples[0][2:]


@pytest.mark.parametrize("nlam", [1, 2, 3])
def test_df32_key_shares_one_tuple_across_wavelengths(nlam):
    """The plans of one table's wavelengths share one flag tuple (only
    mu and n_before differ, values, not flags); a plan whose flags
    differ adds a second tuple, and the map sends each plan to its."""
    _, _, plans = _cooke(nlam)
    key = CS.df32_multi_key(plans, "k13")
    assert len(key.tuples) == 1 and key.plan_map == (0,)*nlam
    words, flags = CD.pack_plan(plans, "cpu")
    assert key.word_bytes == words.numel()*4
    assert key.tuples[0] == tuple(flags[0].tolist())
    fast = _cooke(nlam, fast=True)[2]
    mixed = plans[:1] + fast[:1] + plans[1:]
    key = CS.df32_multi_key(mixed, "k11", True)
    assert len(key.tuples) == 2
    assert key.plan_map == (0, 1) + (0,)*(nlam - 1)
    assert key.tuples[1] == tuple(f | CD.G_FAST for f in key.tuples[0])


def test_df32_key_of_flags_is_df32_multi_key():
    """The wrappers' lookup keys the plans' flag words (df32_flags), as
    df32_multi_key keys the plans."""
    _, _, plans = _cooke(2)
    for kernel, wp in (("k11", True), ("k11", False), ("k13", False)):
        assert CS.df32_key_of(CS.df32_flags(plans), kernel, wp) == \
            CS.df32_multi_key(plans, kernel, wp)


# -- the translation unit and the limits ----------------------------------

@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_df32_translation_unit_instantiates_the_key(kernel):
    """The unit includes df32_spec.cuh, lists each distinct flag tuple
    as a Plan<...> and the plan map, and instantiates the kernel's macro
    with the path (K11), the placement, the block and the launch bound."""
    _, _, plans = _cooke(2)
    fast = _cooke(1, fast=True)[2]
    key = CS.df32_multi_key(plans + fast, kernel, kernel == "k11", block=128,
                            min_blocks=2, staged=True)
    text = CS.translation_unit(key)
    assert '#include "df32_spec.cuh"' in text
    for t in key.tuples:
        assert "Plan<%s>" % ", ".join(map(str, t)) in text
    assert "using Map = PlanMap<0, 0, 1>;" in text
    if kernel == "k11":
        assert "RAYOPT_DF32_TRACE(%s, Ps, Map, true, WORDS_STAGED, 128, 2)" \
            % key.name in text
    else:
        assert "RAYOPT_DF32_MERIT(%s, Ps, Map, WORDS_STAGED, 128, 2)" % (
            key.name) in text
    default = CS.df32_multi_key(plans, kernel)
    assert "%s, %d, %d)" % ("WORDS_STAGED" if CS.DF32_STAGED[kernel]
                            else "WORDS_DIRECT", CS.BLOCK_DF32[kernel],
                            CS.MIN_BLOCKS) in CS.translation_unit(default)


@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_df32_key_sizes(kernel):
    """A key's kernel parameters hold the plan words, staged or not; a
    staged key's static shared memory holds a copy of them, and K13's
    its block reduction's 10 floats a warp."""
    _, _, plans = _cooke(3)
    words = CD.pack_plan(plans, "cpu")[0].numel()*4
    red = 10*4*8 if kernel == "k13" else 0
    direct = CS.df32_multi_key(plans, kernel, staged=False, block=256)
    staged = CS.df32_multi_key(plans, kernel, staged=True, block=256)
    for key in (direct, staged):
        assert key.param_bytes == words + CS.DF32_PARAM_BYTES[kernel]
    assert direct.shared_bytes == red
    assert staged.shared_bytes == words + red


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_df32_key_refuses_past_its_limits(kernel, staged):
    """Past PARAM_LIMIT bytes of kernel parameters, which carry the plan
    words, the key is refused, naming why, before any build; below it
    many wavelengths are fine (no wavelength cap), and a staged copy of
    the words stays inside static shared memory."""
    _, _, plans = _cooke(1)
    per = CD.pack_plan(plans, "cpu")[0].numel()*4
    fits = (CS.PARAM_LIMIT - CS.DF32_PARAM_BYTES[kernel])//per
    key = CS.df32_multi_key(plans*fits, kernel, block=1024, staged=staged)
    assert key.nlam == fits > 11 and len(key.tuples) == 1
    assert key.param_bytes <= CS.PARAM_LIMIT
    assert key.shared_bytes <= CS.SMEM_LIMIT
    with pytest.raises(ValueError, match="kernel parameters"):
        CS.df32_multi_key(plans*(fits + 1), kernel, staged=staged)


def test_df32_key_refuses_bad_plans():
    _, _, plans = _cooke(2)
    with pytest.raises(ValueError, match="step count"):
        CS.df32_multi_key([plans[0], plans[1][:-1]], "k11")
    with pytest.raises(ValueError, match="step count"):
        CS.df32_multi_key([], "k11")
    with pytest.raises(ValueError, match="no optical path"):
        CS.df32_multi_key(plans, "k13", True)
    with pytest.raises(ValueError, match="k11 or k13"):
        CS.df32_multi_key(plans, "k10")


def test_df32_keys_build_from_the_spec_headers():
    """The keys build with the other spec keys (cuda_spec.prebuild), the
    df32 headers among those their cache hash reads; K10 and K12 are
    keys too, and since K3 became one, the run-time sources (df32.cu,
    trace.cu) and cuda_build's kernel library are gone: every file of
    csrc/ is a header that cuda_spec's translation units instantiate."""
    from rayopt_tpu_torch.ops import cuda_build as CB
    assert {"df32_common.cuh", "df32_spec.cuh"} <= set(CS.HEADERS)
    assert all((CSRC/name).exists() for name in CS.HEADERS)
    assert CS._MACROS["k11"] == "RAYOPT_DF32_TRACE"
    assert CS._MACROS["k13"] == "RAYOPT_DF32_MERIT"
    assert not (CSRC/"df32.cu").exists()
    assert not (CSRC/"trace.cu").exists()
    for gone in ("load_library", "KernelLibrary", "SOURCES", "HEADERS"):
        assert not hasattr(CB, gone), gone
    assert sorted(p.name for p in CSRC.glob("*.cu*")) == sorted(CS.HEADERS)
    common = (CSRC/"df32_common.cuh").read_text()
    assert "RAYOPT_DF32_FMA" not in common and "__fmaf_rn" in common
    assert "4097" not in common      # Dekker's splitter


# -- one plan: K10 and K12 -------------------------------------------------

@pytest.mark.parametrize("kernel,one", [("k11", "k10"), ("k13", "k12")])
def test_one_plan_key_is_k10_or_k12(kernel, one):
    """K10 and K12 are df32_multi_key([plan], ...): nlam 1, the map
    (0,), the one-plan block and placement (BLOCK_DF32, DF32_STAGED of
    "k10"/"k12"), and a unit that instantiates the trace or merit
    template at one plan."""
    _, _, plans = _cooke(1)
    wp = kernel == "k11"
    key = CS.df32_multi_key(plans[:1], kernel, wp)
    assert key.kernel == kernel and key.nlam == 1 and key.plan_map == (0,)
    assert key.block == CS.BLOCK_DF32[one]
    assert key.staged == CS.DF32_STAGED[one] and not key.device_words
    text = CS.translation_unit(key)
    assert "using Map = PlanMap<0>;" in text
    macro = "RAYOPT_DF32_TRACE(%s, Ps, Map, true, " if wp \
        else "RAYOPT_DF32_MERIT(%s, Ps, Map, "
    assert (macro % key.name) + "%s, %d, 1)" % (
        key.words_at, key.block) in text
    spec = (CSRC/"df32_spec.cuh").read_text()
    assert ("df32_trace_spec<PLANS, MAP, PATH, AT" if wp
            else "df32_merit_spec<PLANS, MAP, AT") in spec
    # two plans take the multi-plan defaults
    two = CS.df32_multi_key(plans*2, kernel, wp)
    assert (two.block, two.staged) == (CS.BLOCK_DF32[kernel],
                                       CS.DF32_STAGED[kernel])


def _long_plan(steps):
    """A synthetic plan of `steps` steps: the Cooke's steps repeated."""
    _, _, plans = _cooke(1)
    return (plans[0]*(-(-steps // len(plans[0]))))[:steps]


@pytest.mark.parametrize("steps", [227, 300, 330])
@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_one_long_plan_takes_device_words(kernel, steps):
    """A single plan whose words pass PARAM_LIMIT (144 bytes a step: 227
    steps and more) takes the device-words placement, staged into
    dynamic shared memory: its pointer in the parameters, its flags still
    compile-time (one Plan<...> of every step), not refused up to the
    330 steps the run-time K10 and K12 took, and more."""
    plan = _long_plan(steps)
    key = CS.df32_multi_key([plan], kernel, kernel == "k11")
    per = CD.pack_plan(plan, "cpu")[0].numel()*4
    assert per + CS.DF32_PARAM_BYTES[kernel] > CS.PARAM_LIMIT
    assert key.device_words and key.staged and key.steps == steps
    assert key.param_bytes == 8 + CS.DF32_PARAM_BYTES[kernel]
    assert key.dynamic_smem == per
    assert key.shared_bytes == (10*4*key.block//32 if kernel == "k13"
                                else 0)
    text = CS.translation_unit(key)
    assert "WORDS_DEVICE, %d, 1)" % key.block in text
    assert text.count("Plan<") == 1 and len(key.tuples[0]) == steps
    # a plan that fits keeps its placement, unless asked
    short = CS.df32_multi_key([plan[:200]], kernel, kernel == "k11")
    assert not short.device_words
    forced = CS.df32_multi_key([plan[:8]], kernel, device_words=True)
    assert forced.device_words and forced.staged
    assert forced.name != CS.df32_multi_key([plan[:8]], kernel,
                                            staged=True).name


def test_device_words_refusals():
    """Several plans never take device words (they are split into runs
    instead, which the key does not do); device words are always staged;
    past SMEM_OPTIN of dynamic shared memory a plan is refused."""
    plan = _long_plan(300)
    with pytest.raises(ValueError, match="kernel parameters"):
        CS.df32_multi_key([plan, plan], "k11")
    with pytest.raises(ValueError, match="staged"):
        CS.df32_multi_key([plan], "k11", staged=False)
    with pytest.raises(ValueError, match="kernel parameters"):
        CS.df32_multi_key([plan], "k13", device_words=False)
    most = CS.SMEM_OPTIN//(CD.DW*4)
    CS.df32_multi_key([_long_plan(most - 20)], "k13")
    with pytest.raises(ValueError, match="shared memory"):
        CS.df32_multi_key([_long_plan(most + 1)], "k11")


# -- the wrappers' split into runs -----------------------------------------

@pytest.mark.parametrize("n,most,want", [
    (1, 11, [(0, 1)]), (11, 11, [(0, 11)]), (12, 11, [(0, 6), (6, 12)]),
    (13, 11, [(0, 7), (7, 13)]), (23, 11, [(0, 8), (8, 16), (16, 23)]),
    (24, 18, [(0, 12), (12, 24)]), (3, 1, [(0, 1), (1, 2), (2, 3)])])
def test_runs_are_balanced(n, most, want):
    got = CS.runs(n, most)
    assert got == want
    assert all(0 < l1 - l0 <= most for l0, l1 in got)
    assert max(b - a for a, b in got) - min(b - a for a, b in got) <= 1


@pytest.fixture
def loaded(monkeypatch):
    """cuda_spec.load patched to record the keys asked for (nothing is
    built or launched); the wrappers' key caches cleared around it."""
    keys = []

    def load(key):
        keys.append(key)
        return type("Loaded", (), {"key": key})()
    CD._multi_kernel.cache_clear()
    monkeypatch.setattr(CS, "load", load)
    yield keys
    CD._multi_kernel.cache_clear()


def _double_gauss_plans(nlam, fast=True):
    """nlam plans of the double Gauss, one a wavelength in 400-700 nm."""
    from rayopt_tpu_torch.models import double_gauss
    s = double_gauss()
    tabs = s.tables(list(np.linspace(400e-9, 700e-9, nlam)))
    return [D.plan(TT.table_at(tabs, li), fast=fast) for li in range(nlam)]


@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_24_plans_load_two_runs_of_one_key(loaded, kernel):
    """24 double Gauss plans pass PARAM_LIMIT (18 fit): K11 and K13 load
    two runs of 12 plans, plans 0-11 and 12-23, one key (the plans share
    a flag tuple), each within the parameters."""
    plans = _double_gauss_plans(24)
    wp = kernel == "k11"
    with pytest.raises(ValueError, match="kernel parameters"):
        CS.df32_multi_key(plans, kernel, wp)
    runs, packed = CD._runs(kernel, plans, wp)
    assert [(l0, l1) for l0, l1, _ in runs] == [(0, 12), (12, 24)]
    assert packed.shape[0] == 24
    assert len(loaded) == 1       # the second run hits the cache
    key = loaded[0]
    assert key == CS.df32_multi_key(plans[:12], kernel, wp) == \
        CS.df32_multi_key(plans[12:], kernel, wp)
    assert key.nlam == 12 and key.param_bytes <= CS.PARAM_LIMIT
    assert [k.key for _, _, k in runs] == [key, key]


@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_one_plan_loads_its_key(loaded, kernel):
    """K10 and K12 load the one-plan key of their plan; 18 double Gauss
    plans (the most that fit) load one key of 18; a plan past the
    parameters alone loads its device-words key."""
    wp = kernel == "k11"
    plans = _double_gauss_plans(18)
    runs, _ = CD._runs(kernel, plans[:1], wp)
    assert [(l0, l1) for l0, l1, _ in runs] == [(0, 1)]
    assert loaded[-1] == CS.df32_multi_key(plans[:1], kernel, wp)
    runs, _ = CD._runs(kernel, plans, wp)
    assert [(l0, l1) for l0, l1, _ in runs] == [(0, 18)]
    assert loaded[-1].nlam == 18
    long = _long_plan(300)
    runs, _ = CD._runs(kernel, [long, long], wp)
    assert [(l0, l1) for l0, l1, _ in runs] == [(0, 1), (1, 2)]
    assert loaded[-1].device_words and loaded[-1].nlam == 1


# -- the CPU wrappers against the JAX package ------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("with_path", [False, True])
def test_cpu_k11_matches_jax_words(with_path, fast):
    """trace_multi_df32 on a CPU bundle at 2 wavelengths of the Cooke
    gives the JAX package's eager trace_df32_final_multi word for word,
    NaN masks included, and counts no launch."""
    _, jplans, tplans = _cooke(2, fast=fast)
    y, u = _bundle()
    before = CD.trace_multi_df32.launches
    got = CD.trace_multi_df32(tplans, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=with_path)
    want = JD.trace_df32_final_multi(jplans, JD.state_from_f64(y, u),
                                     with_path=with_path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        gw = (*g[0], g[1]) if with_path else g
        ww = (*w[0], w[1]) if with_path else w
        assert all(_same_words(a, _pair(b)) for a, b in zip(gw, ww))
    assert CD.trace_multi_df32.launches == before
    lo = got[0][0][0][1] if with_path else got[0][0][1]
    assert bool((lo != 0).any())


@pytest.mark.parametrize("clip", [False, True])
def test_cpu_k13_matches_jax_merit_per_plan(clip):
    """trace_merit_multi_df32 on a CPU bundle gives, plan by plan, the
    JAX package's eager trace_df32_merit within MERIT_REL (the same
    pairwise df32 tree), five 0-d float64 tensors a plan, and counts no
    launch."""
    _, jplans, tplans = _cooke(2, clip=clip)
    y, u = _bundle(half=7. if clip else 4.)
    before = CD.trace_merit_multi_df32.launches
    got = CD.trace_merit_multi_df32(tplans, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)))
    assert len(got) == 2
    for m, p in zip(got, jplans):
        want = JD.trace_df32_merit(p, JD.state_from_f64(y, u))
        assert all(g.dtype == torch.float64 and g.dim() == 0 for g in m)
        for g, w in zip(m, want):
            assert abs(float(g) - float(w)) <= MERIT_REL*abs(float(w))
    if clip:
        assert 0 < float(got[0][0]) < 256
    assert CD.trace_merit_multi_df32.launches == before


# -- the FMA form of two_prod ----------------------------------------------

#: (low, high) magnitudes of the seeded float32 operands: the rays'
#: positions and directions, products of them, and the df32 refinement
#: terms, above where an error word would underflow (products under
#: ~2^-102, where Dekker's split loses bits and the FMA form does not)
RANGES = ((1e-3, 1e3), (1e-8, 1.), (1., 1e6), (1e-14, 1e-6))


@pytest.mark.parametrize("lo,hi", RANGES)
def test_two_prod_error_word_is_the_fma_result(lo, hi):
    """For seeded signed float32 pairs, the port's Dekker two_prod gives
    p = fl(a*b) and the error word float32(float64(a)*float64(b) - p):
    the float64 product of two float32 values is exact, and so is its
    difference from p, which is what __fmaf_rn(a, b, -p) returns.  So
    the kernels' FMA form gives the plain version's words."""
    rng = np.random.default_rng(int(np.log10(lo)) + 40)
    n = 20000
    a = (rng.uniform(0, 1, n)*(np.log(hi) - np.log(lo)) + np.log(lo))
    b = (rng.uniform(0, 1, n)*(np.log(hi) - np.log(lo)) + np.log(lo))
    a = (np.exp(a)*rng.choice([-1, 1], n)).astype(np.float32)
    b = (np.exp(b)*rng.choice([-1, 1], n)).astype(np.float32)
    p, e = D.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(p, torch.from_numpy(a*b))
    fma = (a.astype(np.float64)*b.astype(np.float64)
           - p.numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(e.numpy(), fma)
    assert (e.numpy() != 0).mean() > .5


def test_two_prod_fma_form_on_edge_values():
    """Signed zeros, ones, powers of two, the splitter and a few plain
    values, every pair: the same error word in both forms."""
    vals = np.array([0., -0., 1., -1., 2.**-20, 2.**20, 4097., 3., .5,
                     1.5, 1e-3], dtype=np.float32)
    a, b = np.meshgrid(vals, vals)
    a, b = a.ravel(), b.ravel()
    p, e = D.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    fma = (a.astype(np.float64)*b.astype(np.float64)
           - p.numpy().astype(np.float64)).astype(np.float32)
    assert np.array_equal(e.numpy(), fma)


# -- the Newton rows' keys ----------------------------------------------------

def _newton_plans(fast=True):
    """{name: the port's plan} of Newton lenses (the JAX package's
    aspheric double Gauss and its biconic lens, tests/test_anamorphic.py,
    with a figure; the port's crossed-cylinder pair)."""
    from rayopt_tpu_torch.models import anamorphic_pair
    s = jmodels.double_gauss()
    s[7].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    b = rayopt_tpu.System([
        dict(material="air"),
        dict(type="biconic", roc=25.84, curvature_x=.013, distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="biconic", distance=3., material="air", radius=10.),
        dict(distance=47., radius=10.)])
    b[1].aspherics = [2e-4, -1e-6]
    b.update()
    return {"aspheric": D.plan(TT.table_from_numpy(s.table()), fast=fast),
            "pair": D.plan(anamorphic_pair().table(), fast=fast),
            "biconic": D.plan(TT.table_from_numpy(b.table()), fast=fast)}


#: the K11/K13 (3 plans) and K10/K12 keys of the double Gauss, fast and
#: exact, as they were before the Newton rows: a plan without one keeps
#: its flag words, its key and its build
DOUBLE_GAUSS_KEYS = {
    True: ("k11_f2e62749c4ef1726", "k13_a31118e3fd254cf4",
           "k11_7aa7f6ece156e5f0", "k13_3923c40522c941b5"),
    False: ("k11_42e5fb6dd8a5eb1b", "k13_42c66f7a1e411131",
            "k11_0fa3ce0f5fb29074", "k13_00d92888c519140f")}


@pytest.mark.parametrize("fast", [True, False])
def test_plan_without_newton_rows_keeps_its_key(fast):
    """The double Gauss's plans pack DW = 36 words a step, set no flag
    bit from G_FIG_SHIFT up, and keep the key names they had before the
    Newton rows (so their builds are those keys' builds)."""
    from rayopt_tpu_torch.models import double_gauss
    tabs = double_gauss().tables()
    plans = [D.plan(TT.table_at(tabs, li), fast=fast) for li in range(3)]
    words, flags = CD.pack_plan(plans, "cpu")
    assert words.shape == (3, 12*CD.DW)
    assert int(flags.max()) < 1 << CD.G_FIG_SHIFT
    assert all(CD.step_words(f) == CD.DW for f in flags[0].tolist())
    names = (CS.df32_multi_key(plans, "k11", True).name,
             CS.df32_multi_key(plans, "k13").name,
             CS.df32_multi_key(plans[:1], "k11", True).name,
             CS.df32_multi_key(plans[:1], "k13").name)
    assert names == DOUBLE_GAUSS_KEYS[fast]


def test_row_kind_bits_change_the_key():
    """A Newton row's flag word carries its kind (FIG_*), its even and
    odd coefficient counts and, on a cylinder, whether it is conic; each
    changes the key, and each step's words follow from its flag word
    (step_words: the key's plan words)."""
    plans = _newton_plans()
    figs = {name: {CD.fig_of(f) for f in CS.df32_flags([p])[0]}
            for name, p in plans.items()}
    assert figs["aspheric"] == {0, CD.FIG_RADIAL}
    assert figs["pair"] == {0, CD.FIG_CYL_Y, CD.FIG_CYL_X}
    assert figs["biconic"] == {0, CD.FIG_BICONIC}
    for name, p in plans.items():
        key = CS.df32_multi_key([p], "k11")
        words, flags = CD.pack_plan(p, "cpu")
        assert key.plan_words == words.numel() == sum(
            CD.step_words(f) for f in flags.tolist()) > len(p)*CD.DW
        assert key.word_bytes == 4*words.numel()
    # aspheric row 7 (step 6): 3 even coefficients, 6 words after DW
    fl = CS.df32_flags([plans["aspheric"]])[0][6]
    assert (fl >> CD.G_NA_SHIFT) & 15 == 3 and (fl >> CD.G_NO_SHIFT) & 15 == 0
    assert CD.step_words(fl) == CD.DW + 6
    base = CS.df32_multi_key([plans["aspheric"]], "k11")
    st = plans["aspheric"][6]
    variants = [
        _flip(plans["aspheric"], 6, "asp", st["asp"][:2]),
        _flip(plans["aspheric"], 6, "asp_odd", st["asp"][:1]),
        _flip(plans["aspheric"], 6, "asp", ())]
    pair = plans["pair"]
    conic = dict(pair[0]["anam"], circular=False)
    xcyl = dict(pair[0]["anam"], mode="cyl_x")
    variants += [_flip(pair, 0, "anam", conic), _flip(pair, 0, "anam", xcyl)]
    keys = [base] + [CS.df32_multi_key([p], "k11") for p in variants]
    keys.append(CS.df32_multi_key([pair], "k11"))
    assert len({k.name for k in keys}) == len(keys)
    assert keys[3].plan_words == base.plan_words - 6
    assert CS.df32_flags([variants[3]])[0][0] & CD.G_CYL_CONIC
    # a biconic row: its 5 pairs, kx and ky, its 2 coefficients
    fl = CS.df32_flags([plans["biconic"]])[0][0]
    assert CD.step_words(fl) == CD.DW + CD.A_COEF + 4
    with pytest.raises(ValueError, match="at most 15"):
        CD.pack_plan(_flip(plans["aspheric"], 6, "asp", st["asp"]*6), "cpu")


def test_runs_and_device_words_count_the_real_words():
    """df32_runs and the device-words choice count a plan's real words
    (its figures' too), not steps * DW: the figured biconic's 3-step
    plan takes 4*(3*36 + 16) bytes, so 65 fit one key's parameters
    where 3-step plans without a figure would fit 75; one plan of 210
    such steps passes PARAM_LIMIT and takes device words, where 210
    steps without a figure would not."""
    plan = _newton_plans()["biconic"]
    per = CD.pack_plan(plan, "cpu")[0].numel()*4
    assert per == 4*(3*CD.DW + CD.A_COEF + 4)
    fits = (CS.PARAM_LIMIT - CS.DF32_PARAM_BYTES["k11"])//per
    assert fits == 65 < (CS.PARAM_LIMIT - CS.DF32_PARAM_BYTES["k11"])//(
        3*CD.DW*4)
    CS.df32_multi_key([plan]*fits, "k11")
    with pytest.raises(ValueError, match="kernel parameters"):
        CS.df32_multi_key([plan]*(fits + 1), "k11")
    flags = CS.df32_flags([plan]*70)
    assert CS.df32_runs(flags, "k11") == [(0, 35), (35, 70)]
    long = plan*70
    key = CS.df32_multi_key([long], "k13")
    assert key.device_words and key.steps == 210
    assert key.dynamic_smem == 70*per > CS.PARAM_LIMIT > 210*CD.DW*4
