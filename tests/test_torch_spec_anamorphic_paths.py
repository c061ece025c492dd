"""The polychromatic and wavefront kernels' anamorphic rows (K3, K6, K7,
K8 and K9), and the figured anamorphic rows, on the CPU against the JAX
package, in float64: the plain versions of K3 (trace and merit) and K6
against the JAX package's multi-table trace and the moments of its
rays, K8 against parallel.grad.opd_rays (an anamorphic image row too,
which the reference-sphere tail reads only through its pose and
n_before); the value and the gradient of
glass.polychromatic_spot_rms(engine="adjoint") (K6/K7) and of
adjoint_wavefront_rms (K8/K9) against jax.grad of the JAX package's XLA
engines with the same specs; one small interpret-mode check of the JAX
package's own Pallas kernels (_multi_kernel, the OPD kernel); the
hand-written reverse of an anamorphic row in its PATH (K9) and figured
forms against autograd, and the K7 and K9 models against their plain
versions; and K7's and K9's slot layouts and the K3 and K6 keys' shared
memory on the grown rows.  The lenses are those of
tests/test_torch_anamorphic.py (the crossed-cylinder pair, the
split-conic biconic, the toroid lens) and two figured ones: the toroid
lens with the generating-curve terms of the reference's
test_zmx_toroidal_polynomial_terms and the biconic with an even figure
on its first row.  Each test states its tolerance.  The kernels
themselves build and run only on a CUDA card
(tests/test_torch_cuda.py)."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import rayopt_tpu as jro
from rayopt_tpu import glass as JGL
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops.pallas_grad import pallas_opd_rays
from rayopt_tpu.ops.pallas_trace import pallas_trace_multi
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

from test_torch_anamorphic import (FIGURED, LENSES as PLAIN,  # noqa: F401
                                   _cpu_default, _one_thread, _same, _t)

F64 = torch.float64
RTOL = 1e-12          # traces and moments, relative (_same's atol too)
GRAD_REL = 1e-9       # gradients: of each field's largest entry
LENSES = dict(PLAIN, **FIGURED)
NAMES = sorted(LENSES)
#: the fields the merits differentiate ("offset": the distances too)
SEL = ("curvature", "conic", "offset", "n_before", "curvature_dx",
       "conic_dx")


def _systems(name):
    """(JAX system, port system) of one lens."""
    return LENSES[name](jro), LENSES[name](tro)


def _sel(tab):
    """SEL, and the coefficients on a table with an even figure."""
    return SEL + (("aspherics",) if tab.aspherics.shape[-1] else ())


def _stacks(name):
    """(JAX stack, port stack, JAX specs, port specs) of 3 tables of the
    lens: its first wavelength's table with the refracting rows' mu
    grown by 0, 1 and 2 % of mu - 1 (a dispersion of its own; the
    pair's glass is a constant index)."""
    js, _ = _systems(name)
    t0 = js.table()
    mu = np.asarray(t0.mu)
    jt = jax.tree_util.tree_map(
        lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
        *[t0.replace(mu=jnp.asarray(1 + (mu - 1)*(1 + .01*li)))
          for li in range(3)])
    tt = TT.table_from_numpy(jt)
    jspecs = JK.specialize(jax.tree_util.tree_map(lambda a: a[0], jt))
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs)


def _bundle(n, seed, half=3.5, slope=.01):
    """n rays, x, y uniform in +-half mm, slopes up to `slope`, weights
    in [0.5, 1.5] normalized; ray 0 is the chief ray, on the axis."""
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-half, half, (n, 2))
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    y[0, :2] = u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


def _state(y, u):
    return tuple(_t(c) for c in (*y.T, *u.T))


def _wmoments(y, w):
    """The five weighted moments of final positions y (N, 3) over the
    rays whose x, y are finite, in numpy."""
    good = np.isfinite(y[:, 0]) & np.isfinite(y[:, 1])
    x, yy, wg = y[good, 0], y[good, 1], w[good]
    return np.array([wg.sum(), (wg*x).sum(), (wg*yy).sum(),
                     (wg*x*x).sum(), (wg*yy*yy).sum()])


def _close_moments(got, want):
    """Each moment within RTOL of its scale (the weight sum W, W times
    the RMS coordinate, the second moments)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    wsum, sxx, syy = want[0], want[3], want[4]
    scale = np.array([wsum, np.sqrt(wsum*sxx), np.sqrt(wsum*syy), sxx, syy])
    nptest.assert_array_less(np.abs(got - want), RTOL*scale + 1e-300)


def _close_grad(got, want, name):
    """GRAD_REL of the field's largest entry."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    nptest.assert_allclose(got, want, rtol=0,
                           atol=GRAD_REL*max(float(np.abs(want).max()),
                                             1e-300), err_msg=name)


def _opd_kw(js):
    return dict(ref=0, radius=-js.image.pupil.distance,
                wavelength=js.wavelengths[0], scale=js.scale,
                finite=js.object.finite)


def _aux(tab, specs, y, u, kw):
    """K8's aux vector of a bundle (adjoint_opd_rays's): the chief ray's
    image point, the sphere radius and the wavelength scale."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    yr, _, _ = trace_rays_final(tab, _t(y[:1]), _t(u[:1]), specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [kw["radius"], kw["wavelength"]/kw["scale"]], dtype=F64)])


# -- K3 and K6: the plain versions against the JAX package ------------------

@pytest.mark.parametrize("name", NAMES)
def test_k3_and_k6_plain_versions_match_jax(name):
    """K3's trace (per wavelength: the final state and the path) and
    merit (the count moments), and K6's weighted moments, on a stack of
    3 tables of the lens, against JG.trace_rays_final_multi (specs,
    unroll) of the same bundle and the moments of its rays: the traces
    to RTOL with equal NaN masks, the moments to RTOL of their scale.
    The wrappers run the plain versions here and launch nothing."""
    jt, tt, jspecs, specs = _stacks(name)
    y, u, w = _bundle(96, 1)
    yb, ub = np.broadcast_to(y, (3,) + y.shape), np.broadcast_to(
        u, (3,) + u.shape)
    jy, ju, jtt = (np.asarray(a) for a in JG.trace_rays_final_multi(
        jt, yb, ub, specs=jspecs, unroll=True))
    state = _state(y, u)
    before = (CT.trace_multi.launches, CG.weighted_moments_multi.launches)
    got = CT.trace_multi(tt, specs, state)
    mom = CT.trace_multi(tt, specs, state, merit=True)
    wmom = CG.weighted_moments_multi(tt, specs, state, _t(w))
    assert (CT.trace_multi.launches,
            CG.weighted_moments_multi.launches) == before
    assert np.isfinite(jy).all() and wmom.shape == (3, 5)
    for li in range(3):
        (x, yy, z, ux, uy, uz), t = got[li]
        for c, a in enumerate((x, yy, z)):
            _same(a, jy[li, :, c], msg="y%d wavelength %d" % (c, li))
        for c, a in enumerate((ux, uy, uz)):
            _same(a, ju[li, :, c], msg="u%d wavelength %d" % (c, li))
        _same(t, jtt[li], msg="path wavelength %d" % li)
        _close_moments(torch.stack(mom[li]), _wmoments(jy[li],
                                                       np.ones(len(y))))
        _close_moments(wmom[li], _wmoments(jy[li], w))


def test_k8_plain_version_matches_opd_rays():
    """K8's plain version, through adjoint_opd_rays on a CPU bundle, on
    every lens against parallel.grad.opd_rays(specs=, unroll=True,
    with_pupil=True): the waves to 1e-12 of the largest optical path
    (|k|: the difference k - k[ref] keeps that rounding), the landing to
    RTOL, equal NaN masks."""
    for name in NAMES:
        js, ts = _systems(name)
        jtab, ttab = js.table(), ts.table()
        jspecs = JK.specialize(jtab)
        specs = TK.specs_from_tuple(jspecs)
        y, u, _ = _bundle(96, 2)
        kw = _opd_kw(js)
        wj, lj = JGR.opd_rays(jtab, y, u, with_pupil=True, specs=jspecs,
                              unroll=True, **kw)
        before = CG.opd_chain.launches
        wt, lt = CG.adjoint_opd_rays(ttab, _t(y), _t(u), with_pupil=True,
                                     specs=specs, **kw)
        assert CG.opd_chain.launches == before
        k, _, _ = CG.opd_chain_reference(ttab, specs, _state(y, u),
                                         _aux(ttab, specs, y, u, kw))
        wj, lj = np.asarray(wj), np.asarray(lj)
        assert np.isfinite(wj).sum() > 90, name
        _same(wt, wj, rtol=0, atol=1e-12*float(k.abs().max()), msg=name)
        _same(lt, lj, msg=name)


def test_k8_anamorphic_image_row_is_read_by_the_tail_alone():
    """An anamorphic image row (the pair's, made an x-cylinder): the
    reference's _opd_chain_fwd traces rows 1..S-2 and reads the image
    row only in _opd_tail (its offset, rotation and n_before), as
    parallel.grad.opd_rays does.  The port's K8 plain version does the
    same: its waves equal opd_rays' on that table (1e-12 of |k|, equal
    NaN masks) and the flat image row's to 1e-12 of |k| (the chief ray,
    the sphere's centre, lands on the cylinder's vertex line); the K8
    and K9 keys take the table, and K9's live slots on the image row
    are the tail's: the axial offset and n_before only."""
    js, ts = _systems("pair")
    jtab, ttab = js.table(), ts.table()
    last = jtab.curvature.shape[0] - 1
    jcyl = jtab.replace(curvature_dx=jnp.asarray(jtab.curvature_dx)
                        .at[last].set(.01))
    tcyl = ttab.replace(curvature_dx=ttab.curvature_dx.clone().index_put_(
        (torch.tensor([last]),), _t(.01)))
    jspecs = JK.specialize(jcyl)
    specs = TK.specs_from_tuple(jspecs)
    assert specs[last].cyl_axis == 2 and specs == TK.specialize(tcyl)
    y, u, _ = _bundle(96, 3)
    kw = _opd_kw(js)
    wj = np.asarray(JGR.opd_rays(jcyl, y, u, specs=jspecs, unroll=True,
                                 **kw))
    wt = CG.adjoint_opd_rays(tcyl, _t(y), _t(u), specs=specs, **kw)
    flat = CG.adjoint_opd_rays(ttab, _t(y), _t(u), **kw)
    k, _, _ = CG.opd_chain_reference(tcyl, specs, _state(y, u),
                                     _aux(tcyl, specs, y, u, kw))
    tol = 1e-12*float(k.abs().max())
    _same(wt, wj, rtol=0, atol=tol)
    _same(wt, flat.numpy(), rtol=0, atol=tol)
    assert CS.opd_key(specs, F64).anamorphic
    key = CS.opd_adjoint_key(specs, F64)
    tail = key.words[last] >> CS.LIVE_SHIFT
    assert tail == (1 << 4) | (1 << 6)


# -- the merits' values and gradients against jax.grad ----------------------

def _leaves(tab, fields):
    return {f: getattr(tab, f).clone().requires_grad_() for f in fields}


def _grads(leaves):
    return {f: torch.zeros_like(v) if v.grad is None else v.grad
            for f, v in leaves.items()}


@pytest.mark.parametrize("name", NAMES)
def test_polychromatic_adjoint_matches_jax_grad(name):
    """glass.polychromatic_spot_rms(engine="adjoint") (K6 forward, K7
    backward; their plain versions here) on a stack of 3 tables of the
    lens against jax.value_and_grad of the JAX package's XLA engine
    (glass.polychromatic_spot_rms, specs, unroll=True): the value to
    RTOL, the gradient of every field of SEL (and the even figure of a
    figured lens, per table) to GRAD_REL of the field's largest entry --
    curvature_dx nonzero, n_before exactly zero (the spot merit reads no
    optical path)."""
    jt, tt, jspecs, specs = _stacks(name)
    sel = _sel(tt)
    y, u, w = _bundle(96, 4)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, jg = jax.value_and_grad(lambda p: JGL.polychromatic_spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True))(p0)
    leaves = _leaves(tt, sel)
    with pytest.warns(UserWarning, match="baked out"):
        v = TGL.polychromatic_spot_rms(tt.replace(**leaves), _t(y), _t(u),
                                       _t(w), specs=specs, engine="adjoint")
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    got = _grads(leaves)
    for f in sel:
        _close_grad(got[f], jg[f], f)
    assert not bool(got["n_before"].any())
    assert bool(got["curvature_dx"].any())
    if "aspherics" in sel:
        assert bool(got["aspherics"][:, 1].any())


@pytest.mark.parametrize("name", NAMES)
def test_adjoint_wavefront_rms_matches_jax_grad(name):
    """adjoint_wavefront_rms (K8 forward, K9 backward; their plain
    versions here) on the lens against jax.value_and_grad (jitted) of
    the JAX package's wavefront_rms(specs=, unroll=True), the same rays
    and weights: the value to 1e-9 waves (each ray's OPD is a difference
    of long optical paths that the packages round apart), the gradient
    of every field of SEL (and the even figure of a figured lens) and of
    the rays to GRAD_REL of the field's largest entry -- n_before's and
    curvature_dx's nonzero."""
    js, ts = _systems(name)
    jtab, ttab = js.table(), ts.table()
    sel = _sel(ttab)
    jspecs = JK.specialize(jtab)
    specs = TK.specs_from_tuple(jspecs)
    y, u, w = _bundle(96, 5)
    kw = _opd_kw(js)
    p0 = {f: jnp.asarray(getattr(jtab, f)) for f in sel}
    jv, (jg, jgy, jgu) = jax.jit(jax.value_and_grad(
        lambda p, y0, u0: JGR.wavefront_rms(jtab.replace(**p), y0, u0, w,
                                            specs=jspecs, unroll=True, **kw),
        argnums=(0, 1, 2)))(p0, jnp.asarray(y), jnp.asarray(u))
    leaves = _leaves(ttab, sel)
    y0, u0 = _t(y).requires_grad_(), _t(u).requires_grad_()
    with pytest.warns(UserWarning, match="baked out"):
        v = CG.adjoint_wavefront_rms(ttab.replace(**leaves), y0, u0, _t(w),
                                     specs=specs, **kw)
    v.backward()
    assert 1e-6 < float(jv) < 1e3
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=0, atol=1e-9)
    got = _grads(leaves)
    _close_grad(y0.grad, jgy, "y0")
    _close_grad(u0.grad, jgu, "u0")
    for f in sel:
        _close_grad(got[f], jg[f], f)
    assert bool(got["n_before"].any()) and bool(got["curvature_dx"].any())


def test_pallas_kernels_interpret_match_the_plain_versions():
    """The JAX package's own Pallas kernels at 128 rays, in interpret
    mode as its tests run them: _multi_kernel (pallas_trace_multi) on a
    stack of the figured toroid against the port's K3 (its plain version
    here) to RTOL with equal NaN masks, and the OPD kernel
    (pallas_opd_rays) on the split-conic biconic against
    adjoint_opd_rays to 1e-12 of the largest optical path, the landing
    to RTOL."""
    jt, tt, jspecs, specs = _stacks("figured toroid")
    y, u, w = _bundle(128, 6)
    state = tuple(np.ascontiguousarray(c) for c in (*y.T, *u.T))
    want = pallas_trace_multi(jax.tree_util.tree_map(jnp.asarray, jt),
                              tuple(map(jnp.asarray, state)), specs=jspecs,
                              tile=128, interpret=True)
    got = CT.trace_multi(tt, specs, _state(y, u))
    for li in range(3):
        (x, yy, z, ux, uy, uz), t = got[li]
        (wx, wy, wz, wux, wuy, wuz), wt = want[li]
        for g, v in zip((x, yy, z, ux, uy, uz, t),
                        (wx, wy, wz, wux, wuy, wuz, wt)):
            _same(g, np.asarray(v), msg="wavelength %d" % li)
    js, ts = _systems("biconic")
    jtab, ttab = js.table(), ts.table()
    jspecs = JK.specialize(jtab)
    specs = TK.specs_from_tuple(jspecs)
    kw = _opd_kw(js)
    wj, lj = pallas_opd_rays(jtab, jnp.asarray(y), jnp.asarray(u),
                             with_pupil=True, specs=jspecs, tile=128,
                             interpret=True, **kw)
    wt, lt = CG.adjoint_opd_rays(ttab, _t(y), _t(u), with_pupil=True,
                                 specs=specs, **kw)
    k, _, _ = CG.opd_chain_reference(ttab, specs, _state(y, u),
                                     _aux(ttab, specs, y, u, kw))
    _same(wt, np.asarray(wj), rtol=0, atol=1e-12*float(k.abs().max()))
    _same(lt, np.asarray(lj))


# -- the hand-written reverses -----------------------------------------------

ROWS = [(n, j) for n in NAMES for j in {"pair": (1, 3)}.get(n, (1,))]


@pytest.mark.parametrize("path", [False, True])
@pytest.mark.parametrize("name,j", ROWS)
def test_anamorphic_step_vjp_forms_match_autograd(name, j, path):
    """_step_vjp_reference on an anamorphic row (the model of
    csrc/step_vjp.cuh anamorphic_step_vjp), plain and with ct_path (the
    PATH form, K9's), on the figured rows its figured form, against
    autograd of kernels.surface_step_spec's state (and optical path),
    ray by ray (every row parameter expanded to one copy a ray): the
    state, the six columns, n_before, the coefficients and curvature_dx,
    conic_dx to GRAD_REL of each slot's largest value, on the live
    rays."""
    _, ts = _systems(name)
    tab = ts.table()
    specs = TK.specialize(tab)
    spec, row = specs[j], tab.row(j)
    n = 64
    y, u, _ = _bundle(n, 7 + j)
    y[:, :2] += (.1, .05)
    s = _state(y, u)
    for i in range(1, j):
        s, _ = TK.surface_step_spec(s, tab.row(i), specs[i], False)
    state = [c.detach().clone().requires_grad_() for c in s]
    scal = ("curvature", "conic", "mu", "n_before", "curvature_dx",
            "conic_dx")
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in scal}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    coeffs = {f: getattr(row, f).expand(n, -1).clone().requires_grad_()
              for f in ("aspherics", "aspherics_odd")}
    surf = row._replace(offset=offset, **per_ray, **coeffs)
    out, loc = TK.surface_step_spec(tuple(state), surf, spec, False)
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert int(live.sum()) > n//2
    rng = np.random.RandomState(7)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    ct = torch.from_numpy(rng.normal(size=n))
    total = sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g))
    if path:
        total = total + (torch.where(live, loc[3], 0.)*ct).sum()
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"], per_ray["n_before"], coeffs["aspherics"],
              coeffs["aspherics_odd"], per_ray["curvature_dx"],
              per_ray["conic_dx"]]
    want = [torch.zeros_like(v) if w is None else w for v, w in zip(
        leaves, torch.autograd.grad(total, leaves, allow_unused=True))]
    got_state, got_p = CG._step_vjp_reference(
        tuple(c.detach() for c in state), row, spec, g,
        ct_path=ct if path else None)
    pairs = list(zip(got_state, want[:6])) + [
        (got_p[0], want[6]), (got_p[1], want[7]), (got_p[2], want[8][0]),
        (got_p[3], want[8][1]), (got_p[4], want[8][2]), (got_p[5], want[9])]
    q = 6
    if path:
        pairs.append((got_p[6], want[10]))
        q = 7
    na, no = row.aspherics.shape[-1], row.aspherics_odd.shape[-1]
    if TK.reads_figure(spec) and na + no:
        pairs += [(got_p[q + i], want[11][:, i]) for i in range(na)]
        pairs += [(got_p[q + na + i], want[12][:, i]) for i in range(no)]
        q += na + no
        assert bool(want[11][live].any())
    assert len(got_p) == q + 2
    pairs += [(got_p[q], want[13]), (got_p[q + 1], want[14])]
    for i, (a, b) in enumerate(pairs):
        a = torch.broadcast_to(a, b.shape)[live]
        b = b[live]
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=GRAD_REL*max(float(b.abs().max()),
                                                 1e-300),
                               err_msg="slot %d" % i)


@pytest.mark.parametrize("name", NAMES)
def test_multi_and_opd_adjoints_by_hand_match_plain(name):
    """K7 (_merit_adjoint_multi_by_hand) and K9 (_opd_adjoint_by_hand)
    written in torch against their autograd plain versions on the lens:
    the parameter cotangents (the coefficient columns of a figured lens,
    curvature_dx and conic_dx last) to 1e-10 of each column's largest,
    the rays' and the centre's to GRAD_REL relative."""
    _, tt, _, specs = _stacks(name)
    y, u, w = _bundle(96, 8)
    state = _state(y, u)
    ct = torch.from_numpy(np.random.RandomState(9).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, specs, state, _t(w), ct)
    got = CG._merit_adjoint_multi_by_hand(tt, specs, state, _t(w), ct)
    nq = CS.SLOTS + sum(CT.figure_widths(tt, specs)) + CT.ANAM
    assert ref[0].shape == got[0].shape == (3, len(specs), nq)
    assert bool(ref[0][..., -CT.ANAM].any())
    scale = ref[0].abs().amax((0, 1)).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12)
    js, ts = _systems(name)
    tab = ts.table()
    specs = TK.specialize(tab)
    aux = _aux(tab, specs, y, u, _opd_kw(js))
    cts = tuple(torch.from_numpy(v)
                for v in np.random.RandomState(10).normal(size=(3, 96)))
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts)
    assert ref[0].shape == got[0].shape == (len(specs), nq + 1)
    assert bool(ref[0][:, -CT.ANAM].any()) and bool(ref[0][1:, 6].all())
    scale = ref[0].abs().amax(0).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12*float(b.abs().max()))


# -- the keys ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pair", "figured toroid"])
def test_k7_and_k9_anamorphic_slot_layouts(name):
    """An anamorphic K7 key's rows: SLOTS, the figured table's
    coefficients, then curvature_dx and conic_dx (K5's layout); K9's:
    OPD_SLOTS (n_before at 6), the coefficients, then the two.  The
    anamorphic slots are live where the row reads them (not on a
    y-cylinder, not a toroid's conic_dx), never on the image row; the
    first columns are the layout of the table with no anamorphic row;
    the wrappers widen a key's columns to the table's (the coefficients
    of a key of no figured row are zeros before the anamorphic two);
    the translation unit defines RAYOPT_N_ANAM; a row word refuses
    coefficients past LIVE_BITS less the other slots."""
    _, ts = _systems(name)
    tab = ts.table()
    specs = TK.specialize(tab)
    widths = CT.figure_widths(tab, specs)
    na, no = widths
    k7 = CS.adjoint_multi_key(specs, F64, widths=widths)
    k9 = CS.opd_adjoint_key(specs, F64, widths=widths)
    assert k7.anamorphic and k9.anamorphic
    assert k7.slots == CS.SLOTS + na + no + CT.ANAM
    assert k9.slots == CS.OPD_SLOTS + na + no + CT.ANAM
    for key in (k7, k9):
        assert "#define RAYOPT_N_ANAM 2\n" in CS.translation_unit(key)
    l7 = CS.live_mask(CS.live_slots(specs, CS.FIELDS, widths),
                      k7.slots).numpy()
    l9 = CS.live_mask(CS.opd_live_slots(specs, CS.OPD_FIELDS, widths),
                      k9.slots).numpy()
    img = len(specs) - 1
    assert not l9[img, CS.OPD_SLOTS:].any()
    for j, sp in enumerate(specs):
        if not j:
            continue
        reads = bool(sp.cyl_axis == 2 or (not sp.cyl_axis and (
            sp.biconic or sp.toroidal)))
        kdx = bool(sp.cyl_axis == 2 or (not sp.cyl_axis and sp.biconic))
        assert (l7[j, -2], l7[j, -1]) == (reads, kdx)
        if j != img:
            assert (l9[j, -2], l9[j, -1]) == (reads, kdx)
        if na + no:
            # the coefficients: live where the row reads them, a biconic
            # or toroid figured or not (the reference's rule)
            assert l7[j, CS.SLOTS:CS.SLOTS + na + no].all() == \
                TK.reads_figure(sp)
    # K9's rows are K7's with n_before (live past row 0) after mu, but
    # for the image row, which the tail reads through its pose alone
    inner = slice(0, img)
    nptest.assert_array_equal(l9[inner, :CS.SLOTS], l7[inner, :CS.SLOTS])
    nptest.assert_array_equal(l9[inner, CS.OPD_SLOTS:],
                              l7[inner, CS.SLOTS:])
    assert l9[1:, 6].all() and not l9[0].any()
    # a key with no coefficient columns, widened for a table that has them
    if not (na or no):
        bare = CS.adjoint_multi_key(specs, F64)
        wide = torch.arange(4*bare.slots, dtype=F64).view(4, bare.slots)
        got = CG._key_columns(wide, bare, bare.slots + 3)
        assert not bool(got[:, CS.SLOTS:CS.SLOTS + 3].any())
        nptest.assert_array_equal(got[:, -2:].numpy(), wide[:, -2:].numpy())
    # the row word: K9 holds LIVE_BITS - OPD_SLOTS - 2 coefficients
    most = CS.LIVE_BITS - CS.OPD_SLOTS - CT.ANAM
    figured = tuple(sp._replace(aspheric=True) if j == 1 else sp
                    for j, sp in enumerate(specs))
    CS.opd_adjoint_key(figured, F64, widths=(most, 0))
    with pytest.raises(ValueError, match="row word"):
        CS.opd_adjoint_key(figured, F64, widths=(most + 1, 0))
    CS.adjoint_multi_key(figured, F64, widths=(most + 1, 0))


def test_multi_keys_reckon_the_anamorphic_row(monkeypatch):
    """K3's and K6's keys stage their tables in static shared memory: on
    a long anamorphic chain (the figured toroid's rows twelve times) the
    anamorphic words lower multi_most below the same chain's with its
    rows made spherical, a key past it is refused, and the wrappers'
    runs split a stack past it into balanced runs of keys that fit,
    without raising (cuda_spec.load patched: no build)."""
    _, ts = _systems("figured toroid")
    tab = ts.table()
    specs = TK.specialize(tab)
    long = specs[:1] + specs[1:]*12
    widths = CT.figure_widths(tab, specs)
    plain = tuple(s._replace(toroidal=False) for s in long)
    for kernel in ("k3", "k3m", "k6"):
        most = CS.multi_most(kernel, long, F64, widths=widths)
        assert 1 <= most < CS.multi_most(kernel, plain, F64,
                                         widths=widths) <= CS.MAX_NLAM
        make = {"k3": lambda n: CS.trace_multi_key(long, F64, n,
                                                   widths=widths),
                "k3m": lambda n: CS.trace_multi_key(long, F64, n, True,
                                                    widths=widths),
                "k6": lambda n: CS.moments_multi_key(long, F64, False, n,
                                                     widths=widths)}[kernel]
        key = make(most)
        assert key.anamorphic
        assert key.row_words == CT.ROW + sum(widths) + CT.ANAM
        assert key.shared_bytes <= CS.SMEM_LIMIT
        with pytest.raises(ValueError, match="static shared memory"):
            make(most + 1)
    keys = []

    def load(key):
        keys.append(key)
        return key
    monkeypatch.setattr(CS, "load", load)
    CT._multi_kernel.cache_clear()
    CG._moments_multi_kernel.cache_clear()
    try:
        nlam = 2*CS.multi_most("k6", long, F64, widths=widths) + 1
        runs = {"k3": CT._multi_runs(long, F64, nlam, False, widths),
                "k6": CG._moments_multi_runs(long, F64, False, nlam,
                                             widths)}
    finally:
        CT._multi_kernel.cache_clear()
        CG._moments_multi_kernel.cache_clear()
    for kernel, rs in runs.items():
        sizes = [l1 - l0 for l0, l1, _ in rs]
        assert rs[0][0] == 0 and rs[-1][1] == nlam and len(rs) > 1
        assert max(sizes) - min(sizes) <= 1
        assert all(k.kernel == kernel and k.nlam == n and k.anamorphic
                   for (_, _, k), n in zip(rs, sizes))


def test_unfigured_toroid_row_reads_the_figure_of_the_widths():
    """A toroid (or biconic) row with no figure of its own, in a table
    whose widths another row's figure sets, reads every coefficient of
    those widths, as the reference's surface_step_spec passes the whole
    coefficient rows into its Newton: the figured toroid lens's second
    toroid (row 2). adjoint_spot_rms (K4 forward, K5 backward; the plain
    versions here) differentiated w.r.t. the aspheric coefficients
    against jax.grad of the reference's spot_rms(specs=, unroll=True),
    to GRAD_REL of the largest; row 2's are nonzero, as the reference's
    (a repair: the port baked them out, warning, where the reference
    reads them)."""
    js, ts = _systems("figured toroid")
    jt, tt = js.table(), ts.table()
    jspecs = JK.specialize(jt)
    specs = TK.specs_from_tuple(jspecs)
    assert specs[2].toroidal and not TK.is_figured(specs[2])
    assert TK.reads_figure(specs[2])
    assert 2 not in CS.baked_out_rows(specs, "aspherics")
    y, u, w = _bundle(96, 11)
    want = jax.grad(lambda a: JGR.spot_rms(jt.replace(aspherics=a), y, u, w,
                                           specs=jspecs, unroll=True))(
        jnp.asarray(jt.aspherics))
    a = tt.aspherics.clone().requires_grad_()
    CG.adjoint_spot_rms(tt.replace(aspherics=a), _t(y), _t(u), _t(w),
                        specs=specs).backward()
    _close_grad(a.grad, want, "aspherics")
    assert bool(a.grad[2].abs().gt(0).all())


def test_focal_length_penalty_on_the_pair_matches_jax():
    """The design step's focal-length penalty on the pair
    (parallel.grad.first_order_penalty from paraxial_seed, its y-axis
    focal length the target, as chip_smoke's design step on
    anamorphic_pair uses it) against the JAX package's, at the pair and
    at its curvatures grown 1 %: values and curvature gradients to
    1e-12 relative."""
    from rayopt_tpu.parallel.grad import (first_order_penalty as jpen,
                                          paraxial_seed as jseed)
    from rayopt_tpu_torch.parallel.grad import (first_order_penalty as tpen,
                                                paraxial_seed as tseed)
    js, ts = _systems("pair")
    jt, tt = js.table(), ts.table()
    target = {"focal_length": (1, float(js.paraxial.focal_length[1]))}
    js0, ts0 = jseed(js), tseed(ts)
    for grow in (1., 1.01):
        c = np.asarray(jt.curvature)*grow
        jv, jg = jax.value_and_grad(lambda v: jpen(
            jt.replace(curvature=v), js0, target))(jnp.asarray(c))
        cv = _t(c).requires_grad_()
        tv = tpen(tt.replace(curvature=cv), ts0, target)
        tv.backward()
        nptest.assert_allclose(float(tv), float(jv), rtol=1e-12,
                               atol=1e-15)
        nptest.assert_allclose(cv.grad.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12*max(np.abs(jg).max(), 1e-300))
        assert (float(tv) > 0) == (grow != 1.)
