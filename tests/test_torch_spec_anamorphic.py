"""The kernel side of rayopt_tpu_torch's anamorphic rows, in float64 on
the CPU: K5's hand-written reverse of the cylinder, biconic and toroid
steps (cuda_grad._step_vjp_reference, the line-for-line model of
csrc/step_vjp.cuh anamorphic_step_vjp) against autograd, the K5 model
of the whole merit against the plain version, the key words (64-bit,
the anamorphic flags below LIVE_SHIFT), the packed rows and K5's
curvature_dx/conic_dx slots, the baked-out y-cylinder slots and their
warning, the keys every kernel takes on the anamorphic and the figured
anamorphic lenses and what still refuses (df32.plan; grating, DOE and
freeform rows: NotImplementedError naming ROADMAP Queue 1 item 9),
optimize_grad(engine="adjoint") over curvature and curvature_dx on the
crossed-cylinder pair against the JAX package, and the JAX package's
own Pallas K1 and K2 in interpret mode.  The lenses are those of
tests/test_torch_anamorphic.py.  The kernels themselves build and run
only on a CUDA card (tests/test_torch_cuda.py)."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops.pallas_trace import pallas_trace_final, pallas_trace_merit
from rayopt_tpu.parallel import grad as JGR

from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_df32_newton import df32_matches_jax
from test_torch_anamorphic import (FIGURED, LENSES, ROWS,  # noqa: F401
                                   _cpu_default, _one_thread, _same, _t,
                                   bundle, lens)

F64 = torch.float64
RTOL = 1e-12


def _state(y0, u0):
    return tuple(_t(c) for c in (*y0.T, *u0.T))


def _tables(name):
    js, ts = lens(name)
    tt = ts.table()
    return js, ts, tt, TK.specialize(tt)


# -- the hand-written reverse --------------------------------------------------

def _row_surf(tt, j, variant):
    """Row j of the table and its spec, edited for `variant`."""
    spec = TK.specialize(tt)[j]
    surf = tt.row(j)
    if variant == "as is":
        return surf, spec
    th = .03
    rot = _t([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
              [0, np.sin(th), np.cos(th)]])
    kw = dict(rot=rot, offset=surf.offset + _t([.1, -.2, 0.]))
    spec = spec._replace(rotated=True, off_axis=True)
    if variant == "mirror":
        kw["mu"] = _t(-1.)
        spec = spec._replace(kind=2)
    return surf._replace(**kw), spec


@pytest.mark.parametrize("variant", ["as is", "rotated", "mirror"])
@pytest.mark.parametrize("name,j", [(n, j) for n in sorted(ROWS)
                                    for j in ROWS[n]])
def test_anamorphic_step_vjp_matches_autograd(name, j, variant):
    """_step_vjp_reference on a y- or x-cylinder, biconic or toroid row
    (as is, rotated and off axis, and as a mirror) against autograd
    through kernels.surface_step_spec: the entering state's and the
    parameters' cotangents (c, k, offset, mu, curvature_dx, conic_dx)
    to 1e-10 of each one's largest, on the live rays."""
    _, _, tt, _ = _tables(name)
    surf, spec = _row_surf(tt, j, variant)
    y0, u0 = bundle(48, 17 + j, 3.5, .01)
    y0[:, 0] += .1
    state = _state(y0, u0)
    names = ("curvature", "conic", "offset", "mu", "curvature_dx",
             "conic_dx")
    leaves = {f: getattr(surf, f).clone().requires_grad_() for f in names}
    st = tuple(c.clone().requires_grad_() for c in state)
    out, _ = TK.surface_step_spec(st, surf._replace(**leaves), spec, False)
    gen = torch.Generator().manual_seed(j)
    g = tuple(torch.randn(48, dtype=F64, generator=gen) for _ in range(6))
    live = torch.isfinite(torch.stack(out)).all(0)
    assert int(live.sum()) > 40
    total = sum((torch.where(live, o, 0.)*c).sum() for o, c in zip(out, g))
    auto = torch.autograd.grad(total, [*st, *leaves.values()],
                               allow_unused=True)
    auto = [torch.zeros(()) if a is None else a for a in auto]
    gs, pg = CG._step_vjp_reference(state, surf, spec, g)
    for a, b in zip(auto[:6], gs):
        b = torch.where(live, b, 0.)
        nptest.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-10*float(a.abs().max()))
    sums = [torch.where(live, p, 0.).sum() for p in pg]
    want = [auto[6], auto[7], *auto[8], auto[9], auto[10], auto[11]]
    for k, (a, b) in enumerate(zip(want, sums)):
        nptest.assert_allclose(float(b), float(a), rtol=1e-10, atol=1e-14,
                               err_msg="slot %d" % k)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", sorted(LENSES))
def test_merit_adjoint_by_hand_matches_the_plain_version(name, clip):
    """_merit_adjoint_by_hand (K5 in torch, row by row with the hand
    reverse) against merit_adjoint_reference (autograd): the (S, SLOTS
    + 2) parameter cotangents, curvature_dx and conic_dx last, to 1e-10
    of each column's largest; the ray and weight cotangents to 1e-10."""
    _, _, tt, specs = _tables(name)
    y0, u0 = bundle(64, 3, 4.5 if clip else 3.5, .01)
    y0[:, 0] += .1
    state = _state(y0, u0)
    w = torch.full((64,), 1/64, dtype=F64)
    ct = _t([.3, -.2, .5, 1., .7])
    pr, sr, wr = CG.merit_adjoint_reference(tt, specs, state, w, ct, clip)
    ph, sh, wh = CG._merit_adjoint_by_hand(tt, specs, state, w, ct, clip)
    assert pr.shape == ph.shape == (tt.nsurfaces, CS.SLOTS + CT.ANAM)
    scale = pr.abs().max(0).values.clamp(min=1e-300)
    assert float(((ph - pr).abs()/scale).max()) <= 1e-10
    for a, b in zip((*sh, wh), (*sr, wr)):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-10*max(float(b.abs().max()), 1e-300))


# -- the keys ------------------------------------------------------------------

def test_key_words_rows_and_slots_of_the_pair():
    """The pair's keys: 64-bit row words (the cylinders' flag bits below
    LIVE_SHIFT, live slots above), rows packed with curvature_dx and
    conic_dx, K5's SLOTS + 2 slots with curvature_dx/conic_dx live on
    the x-cylinder only (baked out of the y-cylinder, which reads
    neither), the unit's RAYOPT_N_ANAM."""
    _, _, tt, specs = _tables("pair")
    key = CS.adjoint_key(specs, F64)
    assert key.anamorphic and key.slots == CS.SLOTS + CT.ANAM
    assert key.row_words == CT.ROW + CT.ANAM
    flags = [w & ((1 << CS.LIVE_SHIFT) - 1) for w in key.words]
    assert flags[1] & CT.F_CYL_Y and flags[3] & CT.F_CYL_X
    assert not any(f & (CT.F_BICONIC | CT.F_TOROID) for f in flags)
    assert CS.LIVE_SHIFT + CS.LIVE_BITS == 63
    live = [w >> CS.LIVE_SHIFT for w in key.words]
    q = CS.SLOTS
    assert [bool(m >> q & 1) for m in live] == [False, False, False, True,
                                                False, False]
    assert [bool(m >> (q + 1) & 1) for m in live] == \
        [False, False, False, True, False, False]
    assert live[1] & 3 == 3    # the y-cylinder's curvature and conic
    assert "#define RAYOPT_N_ANAM 2\n" in CS.translation_unit(key)
    packed = CS.packed(tt, specs, tt.curvature)
    assert packed.shape == (tt.nsurfaces, CT.ROW + CT.ANAM)
    nptest.assert_array_equal(packed[:, CT.ROW].numpy(),
                              tt.curvature_dx.numpy())
    # the forward keys carry the rows, no slots
    for make in (CS.trace_key, CS.merit_key, CS.moments_key):
        k = make(specs, F64)
        assert k.anamorphic and k.nlive == 0
    # a table with no anamorphic row keys as before
    dspecs = TK.specialize(tt.replace(curvature_dx=torch.zeros_like(
        tt.curvature_dx)))
    assert not CS.adjoint_key(dspecs, F64).anamorphic


def test_biconic_and_toroid_slots():
    """The biconic's curvature_dx and conic_dx are live; the toroid's
    curvature_dx (its rotation curvature) is, its conic_dx is not."""
    for name, kdx in (("biconic", True), ("toroid", False)):
        _, _, tt, specs = _tables(name)
        live = CS.live_slots(specs, CS.FIELDS)
        q = CS.SLOTS
        assert live[1] >> q & 1 and bool(live[1] >> (q + 1) & 1) == kdx


def test_y_cylinder_curvature_dx_warns_and_is_zero():
    """Differentiating curvature_dx through the adjoint engine warns that
    the y-cylinder row bakes it out; its gradient there is exactly zero
    (the reference's specialized engines give zero too), the
    x-cylinder's is not."""
    _, _, tt, specs = _tables("pair")
    y0, u0 = bundle(64, 5)
    cdx = tt.curvature_dx.clone().requires_grad_()
    with pytest.warns(UserWarning, match="curvature_dx"):
        v = CG.adjoint_spot_rms(tt.replace(curvature_dx=cdx), _t(y0), _t(u0),
                                specs=specs)
    v.backward()
    assert float(cdx.grad[1]) == 0. and float(cdx.grad[3]) != 0.


def test_refusals_name_item_9():
    """What still refuses: a freeform figure on an anamorphic base, in
    every K1-K9 key and the _step_vjp_reference model (specialize
    refuses it, as the reference's; the freeform rows on a radial base,
    ROADMAP Queue 1 item 9.5, are tests/test_torch_spec_freeform.py's).
    Every K1-K9 key takes the three
    lenses and the figured lenses (tests/test_torch_anamorphic.py), the
    adjoints' with their anamorphic slots; the hand reverse takes the
    PATH form (K9's) on every anamorphic row; df32.plan traces them as
    the JAX package's eager df32 does, word for word (item 9.2)."""
    def keys(sp):
        return (CS.trace_key(sp, F64), CS.merit_key(sp, F64),
                CS.moments_key(sp, F64), CS.adjoint_key(sp, F64),
                CS.trace_multi_key(sp, F64, 3),
                CS.trace_multi_key(sp, F64, 3, merit=True),
                CS.moments_multi_key(sp, F64, False, 3),
                CS.adjoint_multi_key(sp, F64), CS.opd_key(sp, F64),
                CS.opd_adjoint_key(sp, F64))
    for name in sorted(LENSES) + sorted(FIGURED):
        _, _, tt, specs = _tables(name)
        widths = CT.figure_widths(tt, specs)
        made = keys(specs) if widths == (0, 0) else (
            CS.trace_key(specs, F64, widths=widths),
            CS.merit_key(specs, F64, widths=widths),
            CS.moments_key(specs, F64, widths=widths),
            CS.adjoint_key(specs, F64, widths=widths),
            CS.trace_multi_key(specs, F64, 3, widths=widths),
            CS.trace_multi_key(specs, F64, 3, merit=True, widths=widths),
            CS.moments_multi_key(specs, F64, False, 3, widths=widths),
            CS.adjoint_multi_key(specs, F64, widths=widths),
            CS.opd_key(specs, F64, widths=widths),
            CS.opd_adjoint_key(specs, F64, widths=widths))
        assert [k.kernel for k in made] == ["k1", "k2", "k4", "k5", "k3",
                                            "k3m", "k6", "k7", "k8", "k9"]
        for k in made:
            assert k.anamorphic and (k.na, k.no) == widths, (name, k.kernel)
            if k.kernel in ("k5", "k7", "k9"):
                assert k.slots == (CS.OPD_SLOTS if k.kernel == "k9"
                                   else CS.SLOTS) + sum(widths) + CT.ANAM
        y, u = np.zeros((8, 3)), np.zeros((8, 3))
        y[:, 0] = np.linspace(-3, 3, 8)
        y[:, 1] = np.linspace(2.5, -2.5, 8)
        u[:, 2] = 1.
        assert df32_matches_jax(tt, y, u), name
        j = [i for i, sp in enumerate(specs) if TK.is_anamorphic_spec(sp)][0]
        _, pg = CG._step_vjp_reference(
            _state(*bundle(4, 1)), tt.row(j), specs[j],
            (torch.zeros(4, dtype=F64),)*6, ct_path=torch.zeros(4, dtype=F64))
        assert len(pg) == CS.OPD_SLOTS + (sum(widths) if TK.is_figured(
            specs[j]) else 0) + CT.ANAM
    # a freeform flag on the biconic lens's biconic row, in every key
    _, _, tt, specs = _tables("biconic")
    for extended in ("freeform",):
        bad = list(specs)
        bad[1] = bad[1]._replace(**{extended: True})
        for make in (lambda sp: CS.trace_key(sp, F64),
                     lambda sp: CS.merit_key(sp, F64),
                     lambda sp: CS.moments_key(sp, F64),
                     lambda sp: CS.adjoint_key(sp, F64),
                     lambda sp: CS.trace_multi_key(sp, F64, 3),
                     lambda sp: CS.trace_multi_key(sp, F64, 3, merit=True),
                     lambda sp: CS.moments_multi_key(sp, F64, False, 3),
                     lambda sp: CS.adjoint_multi_key(sp, F64),
                     lambda sp: CS.opd_key(sp, F64),
                     lambda sp: CS.opd_adjoint_key(sp, F64)):
            with pytest.raises(NotImplementedError, match="anamorphic base"):
                make(tuple(bad))
        with pytest.raises(NotImplementedError, match="anamorphic base"):
            CG._step_vjp_reference(_state(*bundle(4, 1)), tt.row(1), bad[1],
                                   (torch.zeros(4, dtype=F64),)*6)


# -- the loop ------------------------------------------------------------------

def test_optimize_grad_adjoint_on_the_pair_matches_jax():
    """optimize_grad(engine="adjoint", select=("curvature",
    "curvature_dx")) on the crossed-cylinder pair, 2 Adam steps on the
    CPU, against the JAX package's optimize_grad on the same bundles,
    its merit the specialized spot_rms (the gradient its adjoint engine
    reproduces): histories within 1e-9 relative, tables too."""
    js, ts = lens("pair")
    jb = JGR.bundles_from_system(js, fields=(0., 1.),
                                 wavelengths=js.wavelengths[:1], nrays=16,
                                 pad_to=128)
    jt = js.table()
    specs = JK.specialize(jt)
    sel = ("curvature", "curvature_dx")

    def merit(tab):
        total = 0.
        for y, u, w, chroma in jb:
            t2 = tab.replace(**{k: v for k, v in chroma.items()
                                if k != "wavelength"})
            total = total + JGR.spot_rms(t2, y, u, w, specs=specs,
                                         unroll=True)
        return total
    jt2, jh = JGR.optimize_grad(jt, jb, select=sel, steps=2, lr=1e-4,
                                merit=merit)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the baked rows, as intended
        tt2, th = TGR.optimize_grad(ts.table(), TGR.bundles_from_numpy(jb),
                                    select=sel, steps=2, lr=1e-4,
                                    engine="adjoint")
    nptest.assert_allclose(th, jh, rtol=1e-9)
    for k in sel:
        want = np.asarray(getattr(jt2, k))
        nptest.assert_allclose(getattr(tt2, k).numpy(), want, rtol=1e-9,
                               atol=1e-9*np.abs(want).max(), err_msg=k)
    assert float(tt2.curvature_dx[3]) != float(jt.curvature_dx[3])


def test_pallas_k1_k2_interpret_match_the_plain_versions():
    """The JAX package's own Pallas K1 and K2 (pallas_trace_final,
    pallas_trace_merit) on the split-conic biconic at 128 rays, in
    interpret mode as its tests run them, against the port's K1 and K2
    wrappers (their plain versions here): the rays to 1e-12 with equal
    NaN masks, the moments to 1e-12 relative."""
    js, _, tt, specs = _tables("biconic")
    jt = jax.tree_util.tree_map(jnp.asarray, js.table())
    y0, u0 = bundle(128, 9, 5.)
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    jspecs = JK.specialize(js.table())
    want, wt = pallas_trace_final(jt, tuple(map(jnp.asarray, state)),
                                  specs=jspecs, tile=128, interpret=True)
    got, gt = CT.trace_final(tt, specs, tuple(map(_t, state)))
    for g, w in zip((*got, gt), (*want, wt)):
        _same(g, w)
    wm = pallas_trace_merit(jt, tuple(map(jnp.asarray, state)), specs=jspecs,
                            tile=128, interpret=True)
    gm = CT.trace_merit(tt, specs, tuple(map(_t, state)))
    for g, w in zip(gm, wm):
        nptest.assert_allclose(float(g), float(w), rtol=RTOL)
