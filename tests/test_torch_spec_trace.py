"""The fused trace K1 and the OPD trace K8 specialized per spec tuple
(ops.cuda_spec) on the CPU: their keys (stable, and changed by every
part of them), the translation unit a key writes, the keys' refusals
before any build (a table past the 48 KB of static shared memory it is
staged in; K8: fewer than object, exit and image rows), and the
wrappers trace_final and opd_chain on a CPU bundle, which run their
plain versions, count no launch, and match the JAX package in float64:
on the doublet the Pallas kernels they replace, in interpret mode
(pallas_trace_final, pallas_opd_rays); on the f/2 paraboloid the JAX
package's generic engine (its specialized intercept cancels there,
ROADMAP Queue 3).  The kernels themselves build and run only on a CUDA
card (tests/test_torch_cuda.py)."""

import functools

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax.numpy as jnp
import rayopt_tpu as J
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops.kernels import specialize as jspecialize
from rayopt_tpu.ops.pallas_grad import pallas_opd_rays
from rayopt_tpu.ops.pallas_trace import pallas_trace_final
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.models import cooke_triplet, double_gauss
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

F32, F64 = torch.float32, torch.float64
#: (K1's outputs, of max(1, the output's largest |value|); K8's OPD,
#: waves).  The paraboloid: rounding only (measured 1.0e-14 and 1.4e-10
#: waves).  The doublet's first row, a sphere of c = 1.6/mm 99.9 mm past
#: the input plane, cancels ~4 digits of its discriminant (d^2 ~ 2.6e4
#: against ~4): every engine, the JAX package's included, lands ~5e-12
#: mm off the exact intercept (checked at 40 digits) and each rounds
#: differently, so the engines differ by 5.7e-11 of the scale at the
#: image and by 4.9e-9 waves of the ~1.7e5-wave path (measured)
TOL = {"doublet": (1e-9, 2e-8), "paraboloid": (1e-12, 1e-9)}
LANDING_ATOL = 1e-12  # K8's landing on the sphere, mm (2.3e-13 measured)
#: the per-ray traces' keys
KEYS = {"k1": CS.trace_key, "k8": CS.opd_key}
MACROS = {"k1": "RAYOPT_SPEC_TRACE", "k8": "RAYOPT_SPEC_OPD"}


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


def _specs(name):
    s = {"cooke": cooke_triplet, "double_gauss": double_gauss}[name]()
    return TK.specialize(s.table())


@pytest.mark.parametrize("kernel", sorted(KEYS))
def test_trace_key_is_stable_and_changes_with_each_part(kernel):
    """K1 and K8 are keyed on the dtype, the spec tuple, clip, the block
    and the launch bound; they reduce no parameter slot, trace one
    table, and share no key with each other or with K2 (K1's chain
    without the writes)."""
    make = KEYS[kernel]
    specs = _specs("double_gauss")
    base = make(specs, F64, False)
    again = make(list(specs), F64, 0)
    assert again == base and again.name == base.name
    assert base.name == CS.Key(*tuple(base)).name
    assert base.name.startswith(kernel + "_") and len(base.name) == 19
    assert base.nlive == 0 and not base.rays and base.nlam == 1
    assert base.block == CS.BLOCK_TRACE and base.min_blocks == CS.MIN_BLOCKS
    assert base.words == tuple(CS._flags(sp) for sp in specs)
    variants = [
        make(specs, F32, False),
        make(TK.with_pose(specs), F64, False),
        make(_specs("cooke"), F64, False),
        make(specs, F64, True),
        make(specs, F64, False, block=128),
        make(specs, F64, False, min_blocks=2),
        *(KEYS[k](specs, F64, False) for k in KEYS if k != kernel),
        CS.merit_key(specs, F64, False)]
    names = [base.name] + [k.name for k in variants]
    assert len(set(names)) == len(names)
    with pytest.raises(TypeError, match="float32 or float64"):
        make(specs, torch.float16)


@pytest.mark.parametrize("kernel", sorted(KEYS))
def test_trace_translation_unit_instantiates_the_key(kernel):
    """The unit instantiates the kernel's macro with the key's row
    words, dtype, clip, block and launch bound; the table (K8: and its
    aux vector) sits in static shared memory, with no reduction."""
    specs = _specs("double_gauss")
    key = KEYS[kernel](specs, F64, True, block=128, min_blocks=2)
    text = CS.translation_unit(key)
    assert '#include "grad_spec.cuh"' in text
    assert "Chain<%s>" % ", ".join(map(str, key.words)) in text
    assert "%s(%s, double, Rows, true, 128, 2)" % (MACROS[kernel],
                                                   key.name) in text
    f32 = KEYS[kernel](specs, F32)
    assert "%s(%s, float, Rows, false, %d, %d)" % (
        MACROS[kernel], f32.name, CS.BLOCK_TRACE,
        CS.MIN_BLOCKS) in CS.translation_unit(f32)
    assert key.dynamic_smem == 0
    aux = CS.AUX if kernel == "k8" else 0
    assert key.shared_bytes == (13*17 + aux)*8


@pytest.mark.parametrize("kernel", sorted(KEYS))
def test_trace_key_refuses_a_table_past_static_shared_memory(kernel):
    """A table whose rows outgrow the 48 KB of static shared memory it is
    staged in is refused, naming why, before any build."""
    specs = _specs("double_gauss")
    many = specs[:1] + specs[1:]*31      # 373 rows: 51 KB in float64
    with pytest.raises(ValueError, match="static shared memory"):
        KEYS[kernel](many, F64)
    assert KEYS[kernel](many, F32).shared_bytes <= CS.SMEM_LIMIT


def test_opd_key_refuses_fewer_than_three_rows():
    """K8 traces rows 1..S-2 and lands on the reference sphere from the
    image row: a table of fewer than 3 rows is refused by the key, and
    by the wrapper before it reaches a kernel."""
    specs = _specs("double_gauss")
    with pytest.raises(ValueError, match="object, exit and image rows"):
        CS.opd_key(specs[:2], F64)
    CS.opd_key(specs[:3], F64)
    tab = double_gauss().table()
    two = tab.replace(**{f: getattr(tab, f)[:2] for f in (
        "curvature", "conic", "offset", "rot", "radius", "alternate", "mu",
        "n_before", "n_after")})
    state = tuple(torch.zeros(4, dtype=F64) for _ in range(6))
    aux = torch.zeros(CS.AUX, dtype=F64)
    with pytest.raises(ValueError, match="object, exit and image rows"):
        CG.opd_chain(two, specs[:2], state, aux)


def _bundle(n, seed, height, slope=.05):
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*height
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    return y, u


@functools.lru_cache(maxsize=None)
def _trace_case(name):
    """(JAX table, port table, port specs, y0, u0, the JAX outputs
    (x, y, z, ux, uy, uz, t) unclipped and clipped): the doublet (no
    finite aperture) with a bundle over its aperture through the Pallas
    K1 in interpret mode; the paraboloid with an aimed bundle at half
    field, 1.2x wider than its 25 mm mirror so that the clip vignettes,
    through the generic JAX engine."""
    if name == "doublet":
        jt = jmodels.doublet().table()
        # the doublet is sub-mm scale (roc ~ 0.6), 99.9 mm behind the
        # input plane
        y0, u0 = _bundle(256, 0, .3, slope=1e-3)
        specs = jspecialize(jt)
        state = tuple(jnp.asarray(np.ascontiguousarray(c))
                      for c in (*y0.T, *u0.T))
        outs = []
        for clip in (False, True):
            out, t = pallas_trace_final(jt, state, clip=clip, specs=specs,
                                        tile=128, interpret=True)
            outs.append(tuple(np.asarray(c) for c in (*out, t)))
    else:
        s = jmodels.parabolic_mirror()
        jt = s.table()
        z, p = s.pupil((0., .5))
        rng = np.random.RandomState(4)
        r = np.sqrt(rng.uniform(0, 1, 400))
        th = rng.uniform(0, 2*np.pi, 400)
        y0, u0 = s.aim((0., .5), np.stack([r*np.cos(th), r*np.sin(th)], 1),
                       z, p, filter=False)
        y0[:, :2] *= 1.2
        outs = []
        for clip in (False, True):
            y, u, t = JG.trace_rays_final(jt, jnp.asarray(y0),
                                          jnp.asarray(u0), clip=clip)
            outs.append(tuple(np.asarray(c) for c in (*np.asarray(y).T,
                                                      *np.asarray(u).T, t)))
    tt = TT.table_from_numpy(jt)
    return jt, tt, TK.specialize(tt), y0, u0, tuple(outs)


def _state(y0, u0):
    return tuple(torch.from_numpy(np.ascontiguousarray(c))
                 for c in (*y0.T, *u0.T))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", ["doublet", "paraboloid"])
def test_cpu_trace_final_runs_the_plain_version_and_matches_jax(name, clip):
    """trace_final on a CPU bundle: the plain version's outputs, word
    for word, no launch counted; against the JAX package each output
    within TOL of max(1, its largest |value|) (1 mm or a unit
    direction), NaN where the JAX outputs are NaN; no rays give seven
    empty outputs."""
    _, tt, specs, y0, u0, outs = _trace_case(name)
    state = _state(y0, u0)
    before = CT.trace_final.launches
    got, t = CT.trace_final(tt, specs, state, clip)
    ref, tref = CT.trace_final_reference(tt, specs, state, clip)
    assert CT.trace_final.launches == before
    for g, r in zip((*got, t), (*ref, tref)):
        assert g.dtype == F64 and torch.equal(g.isnan(), r.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(r))
    want = outs[int(clip)]
    live = np.isfinite(want[3])
    assert live.sum() > 100
    if clip and name == "paraboloid":
        assert not live.all()       # the mirror vignettes some rays
    for g, w in zip((*got, t), want):
        g = g.numpy()
        nptest.assert_array_equal(np.isnan(g), np.isnan(w))
        scale = max(1., float(np.abs(w[live]).max()))
        nptest.assert_allclose(g[live], w[live], rtol=0,
                               atol=TOL[name][0]*scale)
    empty = tuple(c[:0] for c in state)
    got, t = CT.trace_final(tt, specs, empty, clip)
    assert len(got) == 6 and all(c.shape == (0,) for c in (*got, t))
    assert CT.trace_final.launches == before


@functools.lru_cache(maxsize=None)
def _opd_case(name):
    """(JAX table, port table, port specs, the OPD keywords, y0, u0, the
    JAX waves and landing): a hexapolar bundle at field .7 (the doublet,
    through pallas_opd_rays in interpret mode) or .5 (the paraboloid,
    through the generic opd_rays), ray 0 the chief ray."""
    s = {"doublet": jmodels.doublet,
         "paraboloid": jmodels.parabolic_mirror}[name]()
    g = J.GeometricTrace(s)
    field = .7 if name == "doublet" else .5
    g.rays_point((0, field), nrays=200, distribution="hexapolar",
                 filter=False)
    jt = s.table(g.l)
    kw = dict(ref=g.ref, radius=-s.image.pupil.distance, wavelength=g.l,
              scale=s.scale, finite=s.object.finite)
    # the Pallas kernel takes whole tiles of 128 rays
    y0, u0 = g.y[0][:128], g.u[0][:128]
    if name == "doublet":
        wj, lj = pallas_opd_rays(jt, jnp.asarray(y0), jnp.asarray(u0),
                                 with_pupil=True, specs=jspecialize(jt),
                                 tile=128, interpret=True, **kw)
    else:
        wj, lj = JGR.opd_rays(jt, jnp.asarray(y0), jnp.asarray(u0),
                              with_pupil=True, **kw)
    tt = TT.table_from_numpy(jt)
    return (jt, tt, TK.specialize(tt), kw, y0, u0, np.asarray(wj),
            np.asarray(lj))


@pytest.mark.parametrize("name", ["doublet", "paraboloid"])
def test_cpu_opd_chain_runs_the_plain_version_and_matches_jax(name):
    """opd_chain on a CPU bundle: the plain version's (k, lx, ly) word
    for word, no launch counted, three empty outputs for no rays; and
    adjoint_opd_rays, whose forward is opd_chain, against the JAX
    package's OPD within TOL waves and its landing within LANDING_ATOL
    mm, NaN where the JAX waves are NaN."""
    _, tt, specs, kw, y0, u0, wj, lj = _opd_case(name)
    state = _state(y0, u0)
    aux = torch.tensor([.01, -.02, 3., kw["radius"],
                        kw["wavelength"]/kw["scale"]], dtype=F64)
    before = CG.opd_chain.launches
    got = CG.opd_chain(tt, specs, state, aux)
    ref = CG.opd_chain_reference(tt, specs, state, aux)
    for g, r in zip(got, ref):
        assert g.dtype == F64 and torch.equal(g.isnan(), r.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(r))
    empty = CG.opd_chain(tt, specs, tuple(c[:0] for c in state), aux)
    assert len(empty) == 3 and all(c.shape == (0,) for c in empty)
    calls = []
    real = CG.opd_chain

    def spy(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)
    CG.opd_chain = spy
    try:
        wt, lt = CG.adjoint_opd_rays(tt, torch.from_numpy(y0),
                                     torch.from_numpy(u0), with_pupil=True,
                                     specs=specs, **kw)
    finally:
        CG.opd_chain = real
    assert len(calls) == 1 and CG.opd_chain.launches == before
    good = np.isfinite(wj)
    assert good.sum() > 100
    wt, lt = wt.detach().numpy(), lt.detach().numpy()
    nptest.assert_array_equal(np.isfinite(wt), good)
    nptest.assert_allclose(wt[good], wj[good], rtol=0, atol=TOL[name][1])
    nptest.assert_allclose(lt[good], lj[good], rtol=0, atol=LANDING_ATOL)
