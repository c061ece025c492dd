"""The polychromatic and wavefront kernels' grating and DOE rows (K3, K6,
K7, K8 and K9) on the CPU against the JAX package, in float64: the plain
versions of K3 (trace and merit) and K6 on stacks of phase tables
against the JAX package's multi-table trace and the moments of its
rays, K8 against parallel.grad.opd_rays (the DOE's phase psi(r2)
n_after in the optical path; the kinoform of the reference's
test_doe_phase_enters_optical_path focused flat); the value and the
gradient of glass.polychromatic_spot_rms(engine="adjoint") (K6/K7) and
of adjoint_wavefront_rms (K8/K9) against jax.grad of the JAX package's
XLA engines with the same specs, grating_dy, n_after and the DOE
coefficients among the fields; the hand-written reverse of a phase row
in its PATH (K9) form against autograd, the K7 and K9 models against
their plain versions, and the K9 model's n_after and DOE cotangents,
run through adjoint_opd_rays, against jax.grad of opd_rays; and K7's
and K9's slot layouts and the K3 and K6 keys' shared memory on the
grown rows.  The stacks are the hybrid achromat's and the
spectrograph's own (System.tables: each wavelength's grating term and
DOE coefficients) and three made ones: a grating and a DOE on an
aspheric substrate, on a biconic and on a toroid.  Each test states its
tolerance.  The kernels themselves build and run only on a CUDA card
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
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch import glass as TGL
from rayopt_tpu_torch.ops import cuda_grad as CG
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import cuda_trace as CT
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _same, _t)
from test_torch_grating import lens

F64 = torch.float64
RTOL = 1e-12          # traces and moments, relative (_same's atol too)
GRAD_REL = 1e-9       # gradients: of each field's largest entry
#: the made phase rows (make_table keyword arguments; the phase row is
#: row 1 between the object and an image plane, glass after it)
SUBSTRATES = {
    "asphere": dict(curvature=[0., 1/80., 0.], conic=[0., -.5, 0.],
                    aspherics=[[0., 0.], [1e-6, -2e-9], [0., 0.]],
                    aspherics_odd=[[0.], [3e-6], [0.]],
                    grating_dy=[0., .15, 0.], doe=[[0.], [-1e-3], [0.]]),
    "biconic": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., .004, 0.],
                    conic_dx=[0., .3, 0.], grating_dy=[0., -.12, 0.],
                    doe=[[0., 0.], [-2e-3, 1e-6], [0., 0.]]),
    "toroid": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., -.01, 0.],
                   toroidal=[0., 1., 0.], conic=[0., -.2, 0.],
                   grating_dy=[0., .2, 0.], doe=[[0.], [-1.5e-3], [0.]])}
#: the published lenses, their stacks System.tables'
LENSES = ("hybrid_achromat", "spectrograph")
NAMES = LENSES + tuple(sorted(SUBSTRATES))
#: the bench half width of each (the lens's pupil radius)
HALF = {"hybrid_achromat": 6., "spectrograph": 10.}
#: the substrates' OPD: sphere radius, wavelength
SUB_OPD = dict(radius=-40., wavelength=550e-9, scale=1e-3, finite=False)


def _substrate(name, li=0):
    """The JAX table of a made phase row at wavelength index li: mu grown
    by li % of mu - 1, grating_dy and the DOE coefficients by 5 li %."""
    kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
              radius=[np.inf, 12., np.inf])
    kw.update(SUBSTRATES[name])
    mu = np.asarray(kw["mu"])
    kw["mu"] = 1 + (mu - 1)*(1 + .01*li)
    kw["grating_dy"] = np.asarray(kw.get("grating_dy", [0.]*3))*(1 + .05*li)
    kw["doe"] = np.asarray(kw["doe"])*(1 + .05*li)
    return JT.make_table(**kw)


def _stack(name):
    """(JAX stack, port stack, JAX specs, port specs) of 3 tables."""
    if name in LENSES:
        js, _ = lens(name)
        jt = js.tables()
    else:
        jt = jax.tree_util.tree_map(
            lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
            *[_substrate(name, li) for li in range(3)])
    tt = TT.table_from_numpy(jt)
    jspecs = JK.specialize(jax.tree_util.tree_map(lambda a: a[0], jt))
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs)


def _one(name):
    """(JAX table, port table, JAX specs, port specs, OPD keywords) of
    the first wavelength."""
    if name in LENSES:
        js, ts = lens(name)
        jt, tt = js.table(), ts.table()
        kw = dict(radius=-js.image.pupil.distance,
                  wavelength=js.wavelengths[0], scale=js.scale,
                  finite=js.object.finite)
    else:
        jt = _substrate(name)
        tt = TT.table_from_numpy(jt)
        kw = dict(SUB_OPD)
    jspecs = JK.specialize(jt)
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs), dict(kw, ref=0)


def _bundle(n, seed, name, slope=.01):
    """n rays, x, y uniform in the lens's half width, slopes up to
    `slope`, weights in [0.5, 1.5] normalized; ray 0 the chief ray,
    just off the axis (an odd figure's slope is NaN on it)."""
    half = HALF.get(name, 3.)
    rng = np.random.RandomState(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-half, half, (n, 2))
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-slope, slope, (n, 2))
    y[0, :2] = (.05, .03)
    u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - np.square(u[:, :2]).sum(1))
    w = rng.uniform(.5, 1.5, n)
    return y, u, w/w.sum()


def _state(y, u):
    return tuple(_t(c) for c in (*y.T, *u.T))


def _wmoments(y, w):
    good = np.isfinite(y[:, 0]) & np.isfinite(y[:, 1])
    x, yy, wg = y[good, 0], y[good, 1], w[good]
    return np.array([wg.sum(), (wg*x).sum(), (wg*yy).sum(),
                     (wg*x*x).sum(), (wg*yy*yy).sum()])


def _close_moments(got, want):
    """Each moment within RTOL of its scale."""
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


def _aux(tab, specs, y, u, kw):
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    yr, _, _ = trace_rays_final(tab, _t(y[:1]), _t(u[:1]), specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [kw["radius"], kw["wavelength"]/kw["scale"]], dtype=F64)])


def _phase_fields(tab, specs):
    """The phase fields a table differentiates: grating_dy where a row
    is a grating, doe where one is a DOE."""
    return ((("grating_dy",) if CT.carries_grating(specs) else ())
            + (("doe",) if CT.doe_width(tab, specs) else ()))


# -- K3 and K6: the plain versions against the JAX package -------------------

@pytest.mark.parametrize("name", NAMES)
def test_k3_and_k6_plain_versions_match_jax(name):
    """K3's trace (per wavelength: the final state and the path, the
    DOE's phase term in it) and merit (the count moments), and K6's
    weighted moments, on the stack, against JG.trace_rays_final_multi
    (specs, unroll) of the same bundle and the moments of its rays: the
    traces to RTOL with equal NaN masks, the moments to RTOL of their
    scale.  The stack's tables differ in their grating term and DOE
    coefficients; the wrappers run the plain versions here and launch
    nothing."""
    jt, tt, jspecs, specs = _stack(name)
    assert any(TK.is_phase(s) for s in specs)
    gdy, doe = np.asarray(jt.grating_dy), np.asarray(jt.doe)
    assert (gdy[0] != gdy[1]).any() or (doe[0] != doe[1]).any()
    y, u, w = _bundle(96, 1, name)
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
    assert np.isfinite(jy).mean() > .9 and wmom.shape == (3, 5)
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


@pytest.mark.parametrize("name", NAMES)
def test_k8_plain_version_matches_opd_rays(name):
    """K8's plain version, through adjoint_opd_rays on a CPU bundle,
    against parallel.grad.opd_rays(specs=, unroll=True,
    with_pupil=True): the waves to 1e-12 of the largest optical path
    (the DOE's psi(r2) n_after in it), the landing to RTOL, equal NaN
    masks."""
    jt, tt, jspecs, specs, kw = _one(name)
    y, u, _ = _bundle(96, 2, name)
    wj, lj = JGR.opd_rays(jt, y, u, with_pupil=True, specs=jspecs,
                          unroll=True, **kw)
    before = CG.opd_chain.launches
    wt, lt = CG.adjoint_opd_rays(tt, _t(y), _t(u), with_pupil=True,
                                 specs=specs, **kw)
    assert CG.opd_chain.launches == before
    k, _, _ = CG.opd_chain_reference(tt, specs, _state(y, u),
                                     _aux(tt, specs, y, u, kw))
    wj, lj = np.asarray(wj), np.asarray(lj)
    assert np.isfinite(wj).sum() > 80
    _same(wt, wj, rtol=0, atol=1e-12*float(k.abs().max()))
    _same(lt, lj)


def test_k8_kinoform_focuses_flat():
    """The reference's test_doe_phase_enters_optical_path: a flat
    kinoform of focal 100 mm in air, 8 rays up its y axis; K8's plain
    version (adjoint_opd_rays) is flat to < 0.02 waves, as the
    reference asserts, equals opd_rays to 1e-12 of the largest optical
    path, and without the DOE's path term (n_after 0 on its row) it
    carries tens of waves of sphere."""
    a1 = -np.pi/((550e-9/1e-3)*100.)

    def kinoform(mod):
        s = mod.System([
            dict(material="air"),
            dict(type="binary2", phase_coefficients=[a1], norm_radius=1.,
                 distance=5., material="air", radius=10.),
            dict(distance=100., radius=10.)], wavelengths=[550e-9],
            object=dict(angle_deg=0., pupil=dict(radius=3.,
                                                 update_radius=False)))
        s.update()
        return s
    tab = kinoform(tro).table()
    specs = TK.specialize(tab)
    assert specs[1].doe
    n = 8
    y = np.zeros((n, 3))
    y[:, 1] = np.linspace(0., 2.5, n)
    u = np.zeros((n, 3))
    u[:, 2] = 1.
    kw = dict(radius=-100., wavelength=550e-9, ref=0)
    o = CG.adjoint_opd_rays(tab, _t(y), _t(u), specs=specs, **kw)
    want = np.asarray(JGR.opd_rays(kinoform(jro).table(), y, u,
                                   biconic=True, **kw))
    k, _, _ = CG.opd_chain_reference(tab, specs, _state(y, u),
                                     _aux(tab, specs, y, u, dict(
                                         kw, scale=1e-3)))
    assert float(o.abs().max()) < .02
    _same(o, want, rtol=0, atol=1e-12*float(k.abs().max()))
    bare = CG.adjoint_opd_rays(tab.replace(n_after=torch.zeros_like(
        tab.n_after)), _t(y), _t(u), specs=specs, **kw)
    assert float(bare.abs().max()) > 10.


# -- the merits' values and gradients against jax.grad -----------------------

def _leaves(tab, fields):
    return {f: getattr(tab, f).clone().requires_grad_() for f in fields}


def _grads(leaves):
    return {f: torch.zeros_like(v) if v.grad is None else v.grad
            for f, v in leaves.items()}


@pytest.mark.parametrize("name", NAMES)
def test_polychromatic_adjoint_matches_jax_grad(name):
    """glass.polychromatic_spot_rms(engine="adjoint") (K6 forward, K7
    backward; their plain versions here) on the stack against
    jax.value_and_grad of the JAX package's XLA engine (specs,
    unroll=True): the value to RTOL, the gradient of curvature, offset,
    mu and the phase fields (grating_dy, doe: each table's own) to
    GRAD_REL of the field's largest entry -- the phase fields'
    nonzero."""
    jt, tt, jspecs, specs = _stack(name)
    sel = ("curvature", "offset", "mu") + _phase_fields(tt, specs)
    y, u, w = _bundle(96, 4, name)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: JGL.polychromatic_spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True)))(p0)
    leaves = _leaves(tt, sel)
    with pytest.warns(UserWarning, match="baked out"):
        v = TGL.polychromatic_spot_rms(tt.replace(**leaves), _t(y), _t(u),
                                       _t(w), specs=specs, engine="adjoint")
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    got = _grads(leaves)
    for f in sel:
        _close_grad(got[f], jg[f], f)
    for f in _phase_fields(tt, specs):
        assert bool(got[f].any()), f


@pytest.mark.parametrize("name", NAMES)
def test_adjoint_wavefront_rms_matches_jax_grad(name):
    """adjoint_wavefront_rms (K8 forward, K9 backward; their plain
    versions here) against jax.value_and_grad (jitted) of the JAX
    package's wavefront_rms(specs=, unroll=True), the same rays and
    weights: the value to 1e-9 waves and 1e-12 relative (the
    spectrograph's tilted image plane holds ~3500 waves), the gradient of
    curvature,
    offset, n_before, n_after and the phase fields and of the rays to
    GRAD_REL of the field's largest entry -- a DOE row's n_after
    nonzero (its phase term's), every other row's exactly zero."""
    jt, tt, jspecs, specs, kw = _one(name)
    sel = ("curvature", "offset", "n_before", "n_after") \
        + _phase_fields(tt, specs)
    y, u, w = _bundle(96, 5, name)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, (jg, jgy, jgu) = jax.jit(jax.value_and_grad(
        lambda p, y0, u0: JGR.wavefront_rms(jt.replace(**p), y0, u0, w,
                                            specs=jspecs, unroll=True, **kw),
        argnums=(0, 1, 2)))(p0, jnp.asarray(y), jnp.asarray(u))
    leaves = _leaves(tt, sel)
    y0, u0 = _t(y).requires_grad_(), _t(u).requires_grad_()
    with pytest.warns(UserWarning, match="baked out"):
        v = CG.adjoint_wavefront_rms(tt.replace(**leaves), y0, u0, _t(w),
                                     specs=specs, **kw)
    v.backward()
    assert 1e-6 < float(jv) < 1e4
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=1e-12,
                           atol=1e-9)
    got = _grads(leaves)
    _close_grad(y0.grad, jgy, "y0")
    _close_grad(u0.grad, jgu, "u0")
    for f in sel:
        _close_grad(got[f], jg[f], f)
    doe_rows = [j for j, sp in enumerate(specs) if sp.doe]
    other = [j for j in range(len(specs)) if j not in doe_rows]
    if doe_rows:
        assert bool(got["n_after"][doe_rows].all())
    assert not bool(got["n_after"][other].any())


@pytest.mark.parametrize("name", ["hybrid_achromat", "asphere", "toroid"])
def test_k9_model_doe_cotangents_match_jax_grad(name, monkeypatch):
    """The K9 model written by hand (_opd_adjoint_by_hand, put in place
    of the plain version that adjoint_opd_rays' backward runs on a CPU
    bundle) differentiates opd_rays as jax.grad of the JAX package's
    opd_rays(specs=, unroll=True) does, for a fixed cotangent of the
    waves: n_after's (ct_path psi(r2) on the DOE row), the DOE
    coefficients' (ct_path n_after r2^(i+1) beside the kick's) and
    grating_dy's, and the rays', to GRAD_REL of each one's largest."""
    jt, tt, jspecs, specs, kw = _one(name)
    sel = ("n_after",) + _phase_fields(tt, specs)
    y, u, _ = _bundle(64, 12, name)
    c = np.random.RandomState(13).normal(size=64)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jg, jgy = jax.jit(jax.grad(lambda p, y0: jnp.nansum(
        jnp.asarray(c)*JGR.opd_rays(jt.replace(**p), y0, u, specs=jspecs,
                                    unroll=True, **kw)),
        argnums=(0, 1)))(p0, jnp.asarray(y))
    calls = []

    def by_hand(*args, **kwargs):
        calls.append(1)
        return CG._opd_adjoint_by_hand(*args, **kwargs)
    monkeypatch.setattr(CG, "opd_adjoint_reference", by_hand)
    leaves = _leaves(tt, sel)
    y0 = _t(y).requires_grad_()
    with pytest.warns(UserWarning, match="baked out"):
        o = CG.adjoint_opd_rays(tt.replace(**leaves), y0, _t(u),
                                specs=specs, **kw)
    torch.nansum(_t(c)*o).backward()
    assert calls
    got = _grads(leaves)
    _close_grad(y0.grad, jgy, "y0")
    for f in sel:
        _close_grad(got[f], jg[f], f)
    j = [j for j, sp in enumerate(specs) if sp.doe][0]
    assert bool(got["n_after"][j] != 0) and bool(got["doe"][j].all())


# -- the hand-written reverses -----------------------------------------------

def _rows():
    out = [(n, j) for n in NAMES
           for j in ({"hybrid_achromat": (2,)}.get(n, (1,)))]
    return out


@pytest.mark.parametrize("name,j", _rows())
def test_phase_step_vjp_path_form_matches_autograd(name, j):
    """_step_vjp_reference on a phase row with ct_path (the PATH form,
    K9's: the model of csrc/step_vjp.cuh surface_step_vjp<T, true>)
    against autograd of kernels.surface_step_spec's state and optical
    path, ray by ray (every row parameter expanded to one copy a ray):
    the state, the six columns, n_before, the coefficients of a figured
    substrate, curvature_dx and conic_dx of an anamorphic one,
    grating_dy, n_after (a DOE row's: ct_path psi(r2)) and the DOE
    coefficients to GRAD_REL of each slot's largest value, on the live
    rays."""
    _, tab, _, specs, _ = _one(name)
    spec, row = specs[j], tab.row(j)
    n = 64
    y, u, _ = _bundle(n, 7 + j, name)
    s = _state(y, u)
    for i in range(1, j):
        s, _ = TK.surface_step_spec(s, tab.row(i), specs[i], False)
    state = [c.detach().clone().requires_grad_() for c in s]
    scal = ["curvature", "conic", "mu", "n_before", "n_after"]
    anam = TK.is_anamorphic_spec(spec)
    if anam:
        scal += ["curvature_dx", "conic_dx"]
    if spec.grating:
        scal.append("grating_dy")
    per_ray = {f: getattr(row, f).expand(n).clone().requires_grad_()
               for f in scal}
    offset = row.offset[:, None].expand(3, n).clone().requires_grad_()
    coeffs = {f: getattr(row, f).expand(n, -1).clone().requires_grad_()
              for f in ("aspherics", "aspherics_odd", "doe")}
    surf = row._replace(offset=offset, **per_ray, **coeffs)
    out, loc = TK.surface_step_spec(tuple(state), surf, spec, False)
    live = torch.stack([torch.isfinite(o) for o in out]).all(0)
    assert int(live.sum()) > n//2
    rng = np.random.RandomState(7)
    g = tuple(torch.from_numpy(v) for v in rng.normal(size=(6, n)))
    ct = torch.from_numpy(rng.normal(size=n))
    total = sum((torch.where(live, o, 0.)*gi).sum() for o, gi in zip(out, g))
    total = total + (torch.where(live, loc[3], 0.)*ct).sum()
    leaves = [*state, per_ray["curvature"], per_ray["conic"], offset,
              per_ray["mu"], per_ray["n_before"]]
    if TK.reads_figure(spec):
        leaves += [coeffs["aspherics"], coeffs["aspherics_odd"]]
    if anam:
        leaves += [per_ray["curvature_dx"], per_ray["conic_dx"]]
    leaves.append(per_ray["grating_dy"] if spec.grating else None)
    if spec.doe:
        leaves += [per_ray["n_after"], coeffs["doe"]]
    grads = torch.autograd.grad(total, [v for v in leaves if v is not None],
                                allow_unused=True)
    it = iter(grads)
    want = [torch.zeros(n, dtype=F64) if v is None else next(it)
            for v in leaves]
    want = [torch.zeros_like(v) if w is None else w
            for v, w in zip(leaves, want)]
    got_state, got_p = CG._step_vjp_reference(
        tuple(c.detach() for c in state), row, spec, g, ct_path=ct)
    # expand the offset and the coefficient blocks to one column a slot
    cols = want[:6] + [want[6], want[7], want[8][0], want[8][1], want[8][2],
                       want[9], want[10]]
    q = 11
    if TK.reads_figure(spec):
        cols += [want[q][:, i] for i in range(want[q].shape[-1])]
        cols += [want[q + 1][:, i] for i in range(want[q + 1].shape[-1])]
        q += 2
    if anam:
        cols += [want[q], want[q + 1]]
        q += 2
    cols.append(want[q])
    if spec.doe:
        cols += [want[q + 1]] + [want[q + 2][:, i]
                                 for i in range(want[q + 2].shape[-1])]
        assert bool(want[q + 1][live].any())
    pairs = list(zip((*got_state, *got_p), cols))
    assert len(got_state) + len(got_p) == len(cols)
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
    written in torch against their autograd plain versions: the
    parameter cotangents (the phase columns last: K7's grating_dy and
    coefficients per table, K9's grating_dy, n_after and coefficients)
    to 1e-10 of each column's largest, the rays' and the centre's to
    GRAD_REL relative."""
    _, tt, _, specs = _stack(name)
    y, u, w = _bundle(96, 8, name)
    state = _state(y, u)
    ct = torch.from_numpy(np.random.RandomState(9).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, specs, state, _t(w), ct)
    got = CG._merit_adjoint_multi_by_hand(tt, specs, state, _t(w), ct)
    grating, nd = CT.carries_grating(specs), CT.doe_width(tt, specs)
    nq = CG._nslots(tt, specs)
    assert nq == (CS.SLOTS + sum(CG._table_widths(tt))
                  + (CT.ANAM if CT.carries_anamorphic(specs) else 0)
                  + int(grating) + nd)
    assert ref[0].shape == got[0].shape == (3, len(specs), nq)
    assert bool(ref[0][..., -1].any())
    scale = ref[0].abs().amax((0, 1)).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12)
    _, tab, _, specs, kw = _one(name)
    aux = _aux(tab, specs, y, u, kw)
    cts = tuple(torch.from_numpy(v)
                for v in np.random.RandomState(10).normal(size=(3, 96)))
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts)
    nq9 = nq + 1 + (1 if nd else 0)
    assert CG._nslots(tab, specs, CS.OPD_SLOTS) == nq9
    assert ref[0].shape == got[0].shape == (len(specs), nq9)
    assert bool(ref[0][:, -1].any()) and bool(ref[0][1:, 6].all())
    if nd:
        # n_after's column: the DOE rows' alone
        doe_rows = [j for j, sp in enumerate(specs) if sp.doe]
        na = ref[0][:, nq9 - nd - 1]
        assert bool(na[doe_rows].all())
        assert int((na != 0).sum()) == len(doe_rows)
    scale = ref[0].abs().amax(0).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_REL,
                               atol=1e-12*float(b.abs().max()))


# -- the keys -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_k7_and_k9_phase_slot_layouts(name):
    """A phase K7 key's rows: K5's layout (SLOTS, the coefficients, the
    anamorphic two, grating_dy, the DOE coefficients); K9's: OPD_SLOTS
    (n_before at 6), the coefficients, the anamorphic two, grating_dy,
    then n_after and the DOE coefficients.  grating_dy is live on a
    grating row, the coefficients and K9's n_after on a DOE row, none on
    the image row; K9's other columns are K7's with n_before; the
    translation units define RAYOPT_N_GRAT and RAYOPT_N_DOE; the
    wrappers' CPU masks are the keys'; a row word refuses slots past
    LIVE_BITS, naming the numbers."""
    _, tab, _, specs, _ = _one(name)
    widths = CT.figure_widths(tab, specs)
    grating, nd = CT.carries_grating(specs), CT.doe_width(tab, specs)
    k7 = CS.adjoint_multi_key(specs, F64, widths=widths, nd=nd)
    k9 = CS.opd_adjoint_key(specs, F64, widths=widths, nd=nd)
    k5 = CS.adjoint_key(specs, F64, widths=widths, nd=nd)
    assert (k7.grating, k7.nd, k9.grating, k9.nd) == (grating, nd, grating,
                                                      nd)
    anam = CT.ANAM if CT.carries_anamorphic(specs) else 0
    base = sum(widths) + anam + int(grating)
    assert k7.slots == k5.slots == CS.SLOTS + base + nd
    assert k9.slots == CS.OPD_SLOTS + base + (1 + nd if nd else 0)
    assert k7.words == tuple(w for w in k5.words)
    for key in (k7, k9, CS.opd_key(specs, F64, widths=widths, nd=nd)):
        unit = CS.translation_unit(key)
        assert ("#define RAYOPT_N_GRAT 1\n" in unit) == grating
        assert ("#define RAYOPT_N_DOE %d\n" % nd in unit) == bool(nd)
    l7 = CS.live_mask(CS.live_slots(specs, CS.FIELDS, widths, nd),
                      k7.slots).numpy()
    l9 = CS.live_mask(CS.opd_live_slots(specs, CS.OPD_DIFF, widths, nd),
                      k9.slots).numpy()
    img = len(specs) - 1
    assert not l9[img, CS.OPD_SLOTS:].any()
    g7 = CS.SLOTS + sum(widths) + anam
    g9 = g7 + 1
    for j, sp in enumerate(specs[1:img], 1):
        if grating:
            assert l7[j, g7] == l9[j, g9] == bool(sp.grating)
        if nd:
            q = g7 + int(grating)
            assert (l7[j, q:] == bool(sp.doe)).all()
            assert (l9[j, q + 1:] == bool(sp.doe)).all()
    inner = slice(0, img)
    nptest.assert_array_equal(l9[inner, :CS.SLOTS], l7[inner, :CS.SLOTS])
    nptest.assert_array_equal(l9[inner, CS.OPD_SLOTS:g9 + int(grating)],
                              l7[inner, CS.SLOTS:g7 + int(grating)])
    assert l9[1:, 6].all() and not l9[0].any()
    # the row word: K9 holds LIVE_BITS slots, DOE coefficients included
    if nd:
        most = CS.LIVE_BITS - (k9.slots - nd)
        CS.opd_adjoint_key(specs, F64, widths=widths, nd=most)
        with pytest.raises(ValueError, match="%d slots a row, above the %d"
                           % (CS.LIVE_BITS + 1, CS.LIVE_BITS)):
            CS.opd_adjoint_key(specs, F64, widths=widths, nd=most + 1)


def test_multi_keys_reckon_the_phase_words(monkeypatch):
    """K3's and K6's keys stage their tables in static shared memory: on
    a long phase chain (the toroid substrate's phase row twelve times)
    grating_dy, n_after and the DOE coefficients lower multi_most below
    the same chain's without its phase words, a key past it is refused,
    and the wrappers' runs split a stack past it into balanced runs of
    keys that carry the phase words, without raising (cuda_spec.load
    patched: no build)."""
    _, tab, _, specs, _ = _one("toroid")
    long = specs[:1] + specs[1:2]*24 + specs[2:]
    widths = CT.figure_widths(tab, specs)
    nd = 4
    plain = tuple(s._replace(grating=False, doe=False) for s in long)
    for kernel in ("k3", "k3m", "k6"):
        most = CS.multi_most(kernel, long, F64, widths=widths, nd=nd)
        assert 1 <= most < CS.multi_most(kernel, plain, F64,
                                         widths=widths) <= CS.MAX_NLAM
        make = {"k3": lambda n: CS.trace_multi_key(long, F64, n,
                                                   widths=widths, nd=nd),
                "k3m": lambda n: CS.trace_multi_key(long, F64, n, True,
                                                    widths=widths, nd=nd),
                "k6": lambda n: CS.moments_multi_key(long, F64, False, n,
                                                     widths=widths,
                                                     nd=nd)}[kernel]
        key = make(most)
        assert key.grating and key.nd == nd
        assert key.row_words == CT.ROW + sum(widths) + CT.ANAM + 1 + 1 + nd
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
        nlam = 2*CS.multi_most("k6", long, F64, widths=widths, nd=nd) + 1
        runs = {"k3": CT._multi_runs(long, F64, nlam, False, widths, nd),
                "k6": CG._moments_multi_runs(long, F64, False, nlam,
                                             widths, nd)}
    finally:
        CT._multi_kernel.cache_clear()
        CG._moments_multi_kernel.cache_clear()
    for kernel, rs in runs.items():
        sizes = [l1 - l0 for l0, l1, _ in rs]
        assert rs[0][0] == 0 and rs[-1][1] == nlam and len(rs) > 1
        assert max(sizes) - min(sizes) <= 1
        assert all(k.kernel == kernel and k.nlam == n and k.nd == nd
                   for (_, _, k), n in zip(rs, sizes))
