"""The kernel side of rayopt_tpu_torch's freeform XY rows, in float64 on
the CPU: K5's hand-written reverse of a freeform row
(cuda_grad._step_vjp_reference, the line-for-line model of
csrc/step_vjp.cuh figured_step_vjp with its freeform branches) against
autograd on every freeform row kind of tests/test_torch_freeform.py's
lenses (a flat plate, a curved aspheric base, a grating row, as is,
rotated, as a mirror and passing), the K5 model of the whole merit
against the plain version, the plain K5 against the JAX package's
interpret-mode adjoint kernel on the quadratic XY singlet, the key
words (F_FREEFORM below LIVE_SHIFT 17), the packed rows and K5's XY
slots, the baked-out XY slots and their warning, every K1-K9 key's
XY width and df32.plan's freeform row (the JAX package's eager words;
a freeform figure on a biconic base refused, as the reference), and
optimize_grad(engine="adjoint", select=("xy_poly",),
scales=freeform_scales) on the Schmidt corrector against the JAX
package.  The kernels themselves build and run only on a CUDA card
(tests/test_torch_cuda.py)."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax.numpy as jnp
import rayopt_tpu as jro
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import df32 as TD
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _t)
from test_torch_df32_newton import df32_matches_jax
from test_torch_freeform import (TABLES, lens_bundle, schmidt, tables,
                                 xysystem)

F64 = torch.float64


def _state(y0, u0):
    return tuple(_t(c) for c in (*y0.T, *u0.T))


#: the freeform rows the reverse is held on: (lens, row)
CASES = (("figured schmidt", 1), ("xy singlet", 1), ("zernike corrector", 1),
         ("aspheric base", 1), ("freeform grating", 1))


# -- the hand-written reverse -------------------------------------------------

@pytest.mark.parametrize("variant", ["as is", "rotated", "mirror",
                                     "passthrough"])
@pytest.mark.parametrize("name,j", CASES)
def test_freeform_step_vjp_matches_autograd(name, j, variant):
    """_step_vjp_reference on a freeform row (as is, rotated and off
    axis, as a mirror, and passing) against autograd through
    kernels.surface_step_spec: the entering state's and the parameters'
    cotangents (c, k, offset, mu, every aspheric coefficient of the
    widths, a grating row's grating_dy, the XY coefficients) to 1e-10 of
    each one's largest, on the live rays; K9's PATH form (ct_path) too,
    with n_before's."""
    _, tt = tables(name)
    spec = TK.specialize(tt)[j]
    assert spec.freeform
    surf = tt.row(j)
    if variant in ("rotated", "mirror"):
        th = .03
        rot = _t([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                  [0, np.sin(th), np.cos(th)]])
        surf = surf._replace(rot=rot, offset=surf.offset + _t([.1, -.2, 0.]))
        spec = spec._replace(rotated=True, off_axis=True)
    if variant == "mirror":
        surf = surf._replace(mu=_t(-1.))
        spec = spec._replace(kind=2)
    elif variant == "passthrough" and not spec.grating:
        surf = surf._replace(mu=_t(1.))
        spec = spec._replace(kind=0)
    y0, u0 = lens_bundle(name, 48, 17)
    y0[:, 0] += .1
    y0[:, 2] = -2.
    state = _state(y0, u0)
    names = ["curvature", "conic", "offset", "mu", "aspherics",
             "aspherics_odd"] + (["grating_dy"] if spec.grating else []) \
        + ["xy_poly"]
    for ct_path in (None, torch.linspace(.5, 1.5, 48, dtype=F64)):
        pnames = names + (["n_before"] if ct_path is not None else [])
        leaves = {f: getattr(surf, f).clone().requires_grad_()
                  for f in pnames}
        st = tuple(c.clone().requires_grad_() for c in state)
        out, loc = TK.surface_step_spec(st, surf._replace(**leaves), spec,
                                        False)
        gen = torch.Generator().manual_seed(j)
        g = tuple(torch.randn(48, dtype=F64, generator=gen)
                  for _ in range(6))
        live = torch.isfinite(torch.stack(out)).all(0)
        assert int(live.sum()) > 40
        total = sum((torch.where(live, o, 0.)*c).sum()
                    for o, c in zip(out, g))
        if ct_path is not None:
            total = total + (torch.where(live, loc[3], 0.)*ct_path).sum()
        auto = torch.autograd.grad(total, [*st, *leaves.values()],
                                   allow_unused=True)
        auto = [torch.zeros(()) if a is None else a for a in auto]
        gs, pg = CG._step_vjp_reference(state, surf, spec, g,
                                        ct_path=ct_path)
        for a, b in zip(auto[:6], gs):
            b = torch.where(live, b, 0.)
            nptest.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-10*float(a.abs().max()))
        sums = [torch.where(live, p, 0.).sum() for p in pg]
        by = dict(zip(pnames, auto[6:]))
        order = ["curvature", "conic", "offset", "mu"] + (
            ["n_before"] if ct_path is not None else []) + [
            "aspherics", "aspherics_odd"] + (
            ["grating_dy"] if spec.grating else []) + ["xy_poly"]
        want = [w for f in order for w in by[f].reshape(-1)]
        assert len(sums) == len(want), (len(sums), len(want))
        scale = max(float(max(abs(float(w)) for w in want)), 1e-300)
        for k, (a, b) in enumerate(zip(want, sums)):
            nptest.assert_allclose(float(b), float(a), rtol=1e-10,
                                   atol=1e-12*scale, err_msg="slot %d" % k)
        nxy = tt.xy_poly.shape[-1]
        assert any(float(v) != 0. for v in want[-nxy:])


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_merit_adjoint_by_hand_matches_the_plain_version(name, clip):
    """_merit_adjoint_by_hand (K5 in torch, row by row with the hand
    reverse) against merit_adjoint_reference (autograd): the (S, SLOTS +
    na + no [+ 1] + nxy) parameter cotangents, the XY coefficients last,
    to 1e-10 of each column's largest; the ray and weight cotangents to
    1e-10."""
    _, tt = tables(name)
    specs = TK.specialize(tt)
    y0, u0 = lens_bundle(name, 64, 3)
    state = _state(y0, u0)
    w = torch.full((64,), 1/64, dtype=F64)
    ct = _t([.3, -.2, .5, 1., .7])
    pr, sr, wr = CG.merit_adjoint_reference(tt, specs, state, w, ct, clip)
    ph, sh, wh = CG._merit_adjoint_by_hand(tt, specs, state, w, ct, clip)
    nxy = CT.xy_width(tt, specs)
    assert nxy == tt.xy_poly.shape[-1] > 0
    assert pr.shape == ph.shape == (tt.nsurfaces, CG._nslots(tt, specs))
    assert pr.shape[1] == (CS.SLOTS + sum(CG._table_widths(tt))
                           + int(CT.carries_grating(specs)) + nxy)
    assert bool((pr[1, -nxy:] != 0).any())
    scale = pr.abs().max(0).values.clamp(min=1e-300)
    assert float(((ph - pr).abs()/scale).max()) <= 1e-10
    for a, b in zip((*sh, wh), (*sr, wr)):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-10*max(float(b.abs().max()), 1e-300))


def test_plain_k5_matches_the_interpret_mode_reference_kernel():
    """The quadratic XY singlet, 64 hexapolar rays on axis (the
    reference's test_gradients_and_adjoint_kernel): the JAX package's
    analytic-adjoint Pallas merit (interpret mode) and its gradient in
    xy_poly against adjoint_spot_rms (K4/K5's plain versions on the CPU,
    through _SpotMoments): the value to 1e-12, the gradient to 1e-9 of
    its largest."""
    from rayopt_tpu.ops.pallas_grad import pallas_spot_rms
    import jax
    js, ts = xysystem(jro), xysystem(tro)
    jt, tt = js.table(), ts.table()
    t = jro.GeometricTrace(js)
    t.rays_point((0., 0.), nrays=64, distribution="hexapolar", clip=False)
    y0, u0 = np.asarray(t.y[0]), np.asarray(t.u[0])
    n = y0.shape[0]
    pad = (-n) % 128
    y0p = jnp.asarray(np.concatenate([y0, np.full((pad, 3), np.nan)], 0))
    u0p = jnp.asarray(np.concatenate([u0, np.full((pad, 3), np.nan)], 0))
    jspecs = JK.specialize(jt)

    def rms(xy):
        return pallas_spot_rms(jt.replace(xy_poly=xy), y0p, u0p,
                               specs=jspecs, tile=128, interpret=True)
    jv = float(rms(jt.xy_poly))
    jg = np.asarray(jax.grad(rms)(jt.xy_poly))
    xy = tt.xy_poly.clone().requires_grad_()
    tv = CG.adjoint_spot_rms(tt.replace(xy_poly=xy), _t(y0), _t(u0),
                             specs=TK.specialize(tt))
    tv.backward()
    nptest.assert_allclose(float(tv.detach()), jv, rtol=1e-12)
    assert np.abs(jg[1, 2:]).max() > 0
    nptest.assert_allclose(xy.grad.numpy(), jg, rtol=0,
                           atol=1e-9*np.abs(jg).max())


# -- the keys -----------------------------------------------------------------

def test_key_words_rows_and_slots():
    """The freeform keys: F_FREEFORM (bit 16) below LIVE_SHIFT (17), a
    row packed with the table's XY coefficients last, K5's SLOTS [+ na +
    no] + nxy slots with the XY coefficients live on the freeform row
    only, the unit's RAYOPT_N_XY; the forward keys carry the rows and no
    slots; a degree-6 figure (27 terms) fits a row word with every other
    slot, as part two's K9 layout does; a table whose freeform row is
    exactly zero keys as before."""
    assert CT.F_FREEFORM == 1 << 16
    assert CS.LIVE_SHIFT == 17 and CS.LIVE_BITS == 46
    assert CS.SLOTS + 27 <= CS.LIVE_BITS
    # K9's layout in part two: OPD_SLOTS + na + no + 2 + 1 + (1 + nd) + nxy
    assert CS.OPD_SLOTS + 2 + 2 + 1 + 1 + 1 + 27 <= CS.LIVE_BITS
    for name in ("figured schmidt", "aspheric base", "freeform grating"):
        _, tt = tables(name)
        specs = TK.specialize(tt)
        widths = CT.figure_widths(tt, specs)
        nxy = CT.xy_width(tt, specs)
        assert widths == CG._table_widths(tt) and nxy == tt.xy_poly.shape[1]
        key = CS.adjoint_key(specs, F64, widths=widths, nxy=nxy)
        grating = CT.carries_grating(specs)
        assert key.nxy == nxy
        assert key.slots == CS.SLOTS + sum(widths) + int(grating) + nxy
        assert key.row_words == CT.ROW + sum(widths) + int(grating) + nxy
        flags = [w & ((1 << CS.LIVE_SHIFT) - 1) for w in key.words]
        assert [bool(f & CT.F_FREEFORM) for f in flags] == \
            [sp.freeform for sp in specs]
        live = [w >> CS.LIVE_SHIFT for w in key.words]
        q = key.slots - nxy
        assert [m >> q for m in live] == [
            (1 << nxy) - 1 if sp.freeform else 0 for sp in specs]
        unit = CS.translation_unit(key)
        assert "#define RAYOPT_N_XY %d\n" % nxy in unit
        packed = CS.packed(tt, specs, tt.curvature)
        assert packed.shape == (tt.nsurfaces, key.row_words)
        nptest.assert_array_equal(packed[:, -nxy:].numpy(), tt.xy_poly)
        for make in (CS.trace_key, CS.merit_key, CS.moments_key):
            k = make(specs, F64, widths=widths, nxy=nxy)
            assert k.nxy == nxy and k.nlive == 0
            with pytest.raises(ValueError, match="XY width"):
                make(specs, F64, widths=widths)
        # the curvature and conic of a freeform row stay live
        assert 1 not in CS.baked_out_rows(specs, "curvature")
        assert 1 not in CS.baked_out_rows(specs, "conic")
    # the seeded Schmidt plate: a key of nxy 14, every coefficient live
    _, st = tables("schmidt")
    ss = TK.specialize(st)
    k = CS.adjoint_key(ss, F64, fields=("xy_poly",), nxy=14)
    assert k.slots == CS.SLOTS + 14 and k.nlive == 14
    zero = TK.specialize(st.replace(xy_poly=torch.zeros_like(st.xy_poly)))
    assert not any(sp.freeform for sp in zero)
    assert CT.xy_width(st, zero) == 0
    k = CS.adjoint_key(zero, F64)
    assert not k.nxy and k.slots == CS.SLOTS


def test_xy_slots_bake_out_and_warn():
    """xy_poly is live on a freeform row only (the reference's rule keeps
    it everywhere): differentiating it through the adjoint engine on a
    table with other rows warns; its gradient there is exactly zero, on
    the freeform row not."""
    _, tt = tables("xy singlet")
    specs = TK.specialize(tt)
    assert CS.baked_out_rows(specs, "xy_poly") == [2, 3]
    y0, u0 = lens_bundle("xy singlet", 64, 5)
    xy = tt.xy_poly.clone().requires_grad_()
    with pytest.warns(UserWarning, match="xy_poly"):
        v = CG.adjoint_spot_rms(tt.replace(xy_poly=xy), _t(y0), _t(u0),
                                specs=specs)
    v.backward()
    assert float(xy.grad[2:].abs().max()) == 0.
    assert float(xy.grad[1].abs().max()) > 0.


# -- the refusals -------------------------------------------------------------

def test_the_other_kernels_refuse_freeform_rows():
    """Every K1-K9 key takes a freeform row and carries the table's XY
    width (K3's trace and merit, K6, K7, K8 and K9 since item 9.5 part
    two; the adjoints' XY slots last), and since part three df32.plan
    plans it and traces it as the JAX package's eager df32 does, word for
    word with the optical path (tests/test_torch_df32_freeform.py).  A
    freeform figure on a biconic base raises in specialize and in
    df32.plan as the reference's do, and every key and the hand reverse
    refuse such a spec."""
    _, tt = tables("aspheric base")
    specs = TK.specialize(tt)
    kw = dict(widths=CT.figure_widths(tt, specs))
    nxy = CT.xy_width(tt, specs)
    for make in (CS.trace_key, CS.merit_key, CS.moments_key,
                 CS.adjoint_key,
                 lambda sp, dt, **k: CS.trace_multi_key(sp, dt, 3, **k),
                 lambda sp, dt, **k: CS.trace_multi_key(sp, dt, 3, merit=True,
                                                        **k),
                 lambda sp, dt, **k: CS.moments_multi_key(sp, dt, False, 3,
                                                          **k),
                 CS.adjoint_multi_key, CS.opd_key, CS.opd_adjoint_key):
        key = make(specs, F64, nxy=nxy, **kw)
        assert key.nxy == nxy
        if key.kernel in ("k5", "k7", "k9"):
            assert key.slots == (CS.OPD_SLOTS if key.kernel == "k9"
                                 else CS.SLOTS) + sum(kw["widths"]) + nxy
    assert TD.plan(tt)[0]["anam"]["mode"] == "freeform"
    y0, u0 = lens_bundle("aspheric base", 16, 2)
    assert df32_matches_jax(tt, y0, u0)
    bad = dict(TABLES["quadratic freeform"])
    bad["curvature_dx"] = [0., 1e-3, 0., 0.]
    with pytest.raises(NotImplementedError, match="anamorphic"):
        JK.specialize(JT.make_table(**bad))
    with pytest.raises(NotImplementedError, match="anamorphic"):
        TK.specialize(TT.table_from_numpy(JT.make_table(**bad)))
    with pytest.raises(NotImplementedError, match="anamorphic"):
        TD.plan(TT.table_from_numpy(JT.make_table(**bad)))
    mixed = list(specs)
    mixed[1] = mixed[1]._replace(biconic=True)
    for make in (CS.trace_key, CS.adjoint_key, CS.opd_key,
                 CS.adjoint_multi_key, CS.opd_adjoint_key):
        with pytest.raises(NotImplementedError, match="anamorphic base"):
            make(tuple(mixed), F64, nxy=nxy, **kw)
    state = _state(*lens_bundle("aspheric base", 4, 1))
    with pytest.raises(NotImplementedError, match="anamorphic base"):
        CG._step_vjp_reference(state, tt.row(1), mixed[1],
                               (torch.zeros(4, dtype=F64),)*6)


# -- the loop -----------------------------------------------------------------

def test_optimize_grad_adjoint_on_the_schmidt_corrector_matches_jax():
    """optimize_grad(engine="adjoint", select=("xy_poly",),
    scales={"xy_poly": freeform_scales(s)}) on the Schmidt corrector, 3
    Adam steps on the CPU at 2^10 rays on axis at its three wavelengths,
    against the JAX package's optimize_grad on the same bundles, its
    merit the specialized spot_rms with the reference's chroma override:
    histories within 1e-9 relative, xy_poly too; the merit falls."""
    js, ts = schmidt(jro), schmidt(tro)
    jb = JGR.bundles_from_system(js, fields=(0.,), nrays=32, pad_to=1024,
                                 distribution="hexapolar")
    assert len(jb) == 3 and all(b[0].shape[0] == 1024 for b in jb)
    jt = js.table()
    specs = JK.specialize(jt)
    sc = TGR.freeform_scales(ts)
    nptest.assert_array_equal(sc, JGR.freeform_scales(js))

    def merit(tab):
        total = 0.
        for y, u, w, chroma in jb:
            t2 = tab.replace(**{k: v for k, v in chroma.items()
                                if k != "wavelength"})
            total = total + JGR.spot_rms(t2, y, u, w, specs=specs,
                                         unroll=True)
        return total
    jt2, jh = JGR.optimize_grad(jt, jb, select=("xy_poly",), steps=3,
                                lr=2e-4, merit=merit,
                                scales={"xy_poly": sc})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the baked rows, as intended
        tt2, th = TGR.optimize_grad(ts.table(), TGR.bundles_from_numpy(jb),
                                    select=("xy_poly",), steps=3, lr=2e-4,
                                    engine="adjoint",
                                    scales={"xy_poly": sc})
    nptest.assert_allclose(th, jh, rtol=1e-9)
    assert th[-1] < th[0]
    # the on-axis hexapolar bundles are symmetric in x and in y: a term
    # odd in x or in y has a zero gradient but for rounding, which Adam's
    # normalized step turns into a step of either sign -- the even terms
    # (x^2, y^2, x^4, x^2 y^2, y^4) are the ones the merit moves
    want = np.asarray(jt2.xy_poly)[1]
    got = tt2.xy_poly[1].numpy()
    even = [t for t, (i, j) in enumerate(TK._xy_terms(4))
            if i % 2 == 0 and j % 2 == 0]
    assert even == [2, 4, 9, 11, 13]
    nptest.assert_allclose(got[even], want[even], rtol=1e-9)
    assert float(tt2.xy_poly[1, 2]) != float(jt.xy_poly[1, 2])
