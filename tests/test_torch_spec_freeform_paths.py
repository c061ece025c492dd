"""The polychromatic and wavefront kernels' freeform XY rows (K3, K6, K7,
K8 and K9) on the CPU against the JAX package, in float64: the plain
versions of K3 (trace and merit) and K6 on stacks of freeform tables
against the JAX package's multi-table trace and the moments of its
rays; K8's plain version, through adjoint_opd_rays, against
parallel.grad.opd_rays; the value and the xy_poly gradient of
glass.polychromatic_spot_rms(engine="adjoint") (K6/K7) and of
adjoint_wavefront_rms (K8/K9) against jax.grad of the JAX package's XLA
engines with the same specs (unroll=True); the K7 and K9 models written
by hand against autograd of the plain path; K7's and K9's slot layouts
(the XY coefficients last) and the K3 and K6 keys' shared memory on the
grown rows; and, for the slice as a whole, the freeform Schmidt
corrector's composite design merit (the spot bundles through K4/K5 and
the wavefront bundle through K8/K9) and its xy_poly gradient at step 0
against the JAX package's.  The stacks: the quadratic XY singlet's own
(System.tables) and two made ones, a freeform on an aspheric base and
on a grating row, whose tables differ by wavelength in mu and in their
XY coefficients.  At most 64 rays a bundle.  Each test states its
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
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _same, _t)
from test_torch_freeform import TABLES, lens_bundle, schmidt, xysystem

F64 = torch.float64
RTOL = 1e-12          # traces and moments, relative (_same's atol too)
GRAD_REL = 1e-10      # gradients: of each field's largest entry
N = 48                # rays a bundle
#: the made stacks (test_torch_freeform.TABLES) and the XY singlet's own
MADE = ("aspheric base", "freeform grating")
NAMES = ("xy singlet",) + MADE
#: the made lenses' OPD: sphere radius, wavelength
MADE_OPD = dict(radius=-40., wavelength=550e-9, scale=1e-3, finite=False)


def _made(name, li=0):
    """The JAX table of a made lens at wavelength index li: mu grown by
    li % of mu - 1, the XY coefficients by 3 li %."""
    kw = dict(TABLES[name])
    mu = np.asarray(kw["mu"])
    kw["mu"] = 1 + (mu - 1)*(1 + .01*li)
    kw["xy_poly"] = np.asarray(kw["xy_poly"])*(1 + .03*li)
    return JT.make_table(**kw)


def _stack(name):
    """(JAX stack, port stack, JAX specs, port specs) of 3 tables."""
    if name == "xy singlet":
        jt = xysystem(jro).tables()
    else:
        jt = jax.tree_util.tree_map(
            lambda *a: jnp.stack([jnp.asarray(v) for v in a]),
            *[_made(name, li) for li in range(3)])
    tt = TT.table_from_numpy(jt)
    jspecs = JK.specialize(jax.tree_util.tree_map(lambda a: a[0], jt))
    return jt, tt, jspecs, TK.specs_from_tuple(jspecs)


def _one(name):
    """(JAX table, port table, JAX specs, port specs, OPD keywords) of
    the first wavelength."""
    if name == "xy singlet":
        js = xysystem(jro)
        jt = js.table()
        kw = dict(radius=-js.image.pupil.distance,
                  wavelength=js.wavelengths[0], scale=js.scale,
                  finite=js.object.finite)
    else:
        jt = _made(name)
        kw = dict(MADE_OPD)
    jspecs = JK.specialize(jt)
    return (jt, TT.table_from_numpy(jt), jspecs, TK.specs_from_tuple(jspecs),
            dict(kw, ref=0))


def _bundle(name, seed):
    """N rays of the lens's bundle (lens_bundle: within its aperture,
    slopes of a few degrees) and weights in [0.5, 1.5] normalized; ray 0
    the chief ray."""
    y, u = lens_bundle(name, N, seed)
    y[0, :2], u[0] = 0., (0., 0., 1.)
    w = np.random.RandomState(seed).uniform(.5, 1.5, N)
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
    got = got.detach().numpy()
    wsum, sxx, syy = want[0], want[3], want[4]
    scale = np.array([wsum, np.sqrt(wsum*sxx), np.sqrt(wsum*syy), sxx, syy])
    nptest.assert_array_less(np.abs(got - want), RTOL*scale + 1e-300)


def _close_grad(got, want, name):
    """GRAD_REL of the field's largest entry."""
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, name
    nptest.assert_allclose(got, want, rtol=0,
                           atol=GRAD_REL*max(float(np.abs(want).max()),
                                             1e-300), err_msg=name)


def _aux(tab, specs, y, u, kw):
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    yr, _, _ = trace_rays_final(tab, _t(y[:1]), _t(u[:1]), specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [kw["radius"], kw["wavelength"]/kw["scale"]], dtype=F64)])


def _ff_row(specs):
    rows = [j for j, sp in enumerate(specs) if sp.freeform]
    assert len(rows) == 1
    return rows[0]


# -- K3 and K6: the plain versions against the JAX package -------------------

@pytest.mark.parametrize("name", NAMES)
def test_k3_and_k6_plain_versions_match_jax(name):
    """K3's trace (per wavelength: the final state and the path) and
    merit (the count moments), and K6's weighted moments, on the stack,
    against JG.trace_rays_final_multi (specs, unroll) of the same bundle
    and the moments of its rays: the traces to RTOL with equal NaN
    masks, the moments to RTOL of their scale.  The made stacks' tables
    differ in their XY coefficients; the wrappers run the plain versions
    here and launch nothing."""
    jt, tt, jspecs, specs = _stack(name)
    assert any(s.freeform for s in specs)
    y, u, w = _bundle(name, 1)
    yb, ub = (np.broadcast_to(a, (3,) + a.shape) for a in (y, u))
    jy, ju, jtt = (np.asarray(a) for a in jax.jit(
        lambda t, yb, ub: JG.trace_rays_final_multi(
            t, yb, ub, specs=jspecs, unroll=True))(jt, yb, ub))
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
        _close_moments(torch.stack(mom[li]), _wmoments(jy[li], np.ones(N)))
        _close_moments(wmom[li], _wmoments(jy[li], w))


# -- the merits' values and gradients against jax.grad -----------------------

def _leaves(tab, fields):
    return {f: getattr(tab, f).clone().requires_grad_() for f in fields}


@pytest.mark.parametrize("name", NAMES)
def test_polychromatic_adjoint_matches_jax_grad(name):
    """glass.polychromatic_spot_rms(engine="adjoint") (K6 forward, K7
    backward; their plain versions here) on the stack against
    jax.value_and_grad (jitted) of the JAX package's XLA engine (specs,
    unroll=True): the value to RTOL, the gradient of curvature, mu and
    xy_poly (each table's own) to GRAD_REL of the field's largest entry
    -- xy_poly's nonzero on the freeform row alone."""
    jt, tt, jspecs, specs = _stack(name)
    sel = ("curvature", "mu", "xy_poly")
    y, u, w = _bundle(name, 4)
    p0 = {f: jnp.asarray(getattr(jt, f)) for f in sel}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: JGL.polychromatic_spot_rms(
        jt.replace(**p), y, u, w, specs=jspecs, unroll=True)))(p0)
    leaves = _leaves(tt, sel)
    with pytest.warns(UserWarning, match="baked out"):
        v = TGL.polychromatic_spot_rms(tt.replace(**leaves), _t(y), _t(u),
                                       _t(w), specs=specs, engine="adjoint")
    v.backward()
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    for f in sel:
        _close_grad(leaves[f].grad, jg[f], f)
    g = leaves["xy_poly"].grad
    j = _ff_row(specs)
    assert bool(g[:, j].any()) and not bool(g[:, :j].any()) \
        and not bool(g[:, j + 1:].any())


@pytest.mark.parametrize("name", NAMES)
def test_k8_and_adjoint_wavefront_rms_match_jax(name):
    """K8's plain version, through adjoint_opd_rays on a CPU bundle,
    against parallel.grad.opd_rays(specs=, unroll=True,
    with_pupil=True): the waves to 1e-12 of the largest optical path,
    the landing to RTOL, equal NaN masks.  Then adjoint_wavefront_rms
    (K8 forward, K9 backward; their plain versions here) against
    jax.value_and_grad (jitted) of the JAX package's wavefront_rms: the
    value to RTOL, the gradient of curvature, n_before and xy_poly and
    of the rays to GRAD_REL of the field's largest entry -- xy_poly's
    nonzero on the freeform row alone."""
    jt, tt, jspecs, specs, kw = _one(name)
    y, u, w = _bundle(name, 5)
    wj, lj = jax.jit(lambda y0, u0: JGR.opd_rays(
        jt, y0, u0, with_pupil=True, specs=jspecs, unroll=True, **kw))(y, u)
    before = CG.opd_chain.launches
    wt, lt = CG.adjoint_opd_rays(tt, _t(y), _t(u), with_pupil=True,
                                 specs=specs, **kw)
    assert CG.opd_chain.launches == before
    k, _, _ = CG.opd_chain_reference(tt, specs, _state(y, u),
                                     _aux(tt, specs, y, u, kw))
    wj, lj = np.asarray(wj), np.asarray(lj)
    assert np.isfinite(wj).sum() > .9*N
    _same(wt, wj, rtol=0, atol=1e-12*float(k.abs().max()))
    _same(lt, lj)
    sel = ("curvature", "n_before", "xy_poly")
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
    nptest.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    _close_grad(y0.grad, jgy, "y0")
    _close_grad(u0.grad, jgu, "u0")
    for f in sel:
        _close_grad(leaves[f].grad, jg[f], f)
    g = leaves["xy_poly"].grad
    j = _ff_row(specs)
    assert bool(g[j].any()) and int((g.abs().sum(1) != 0).sum()) == 1


# -- the hand-written reverses -----------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_multi_and_opd_adjoints_by_hand_match_plain(name):
    """K7 (_merit_adjoint_multi_by_hand) and K9 (_opd_adjoint_by_hand)
    written in torch against their autograd plain versions: the
    parameter cotangents (the XY columns last: K7's per table) to 1e-10
    of each column's largest, the rays' and the centre's to 1e-9
    relative; the XY columns nonzero on the freeform row alone."""
    _, tt, _, specs = _stack(name)
    y, u, w = _bundle(name, 8)
    state = _state(y, u)
    nxy = CT.xy_width(tt, specs)
    ct = torch.from_numpy(np.random.RandomState(9).normal(size=(3, 5)))
    ref = CG.merit_adjoint_multi_reference(tt, specs, state, _t(w), ct)
    got = CG._merit_adjoint_multi_by_hand(tt, specs, state, _t(w), ct)
    nq = CG._nslots(tt, specs)
    assert nq == (CS.SLOTS + sum(CG._table_widths(tt))
                  + int(CT.carries_grating(specs)) + nxy)
    assert ref[0].shape == got[0].shape == (3, len(specs), nq)
    j = _ff_row(specs)
    assert bool(ref[0][:, j, -nxy:].any())
    assert int((ref[0][..., -nxy:] != 0).any(-1).any(0).sum()) == 1
    scale = ref[0].abs().amax((0, 1)).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)
    _, tab, _, specs, kw = _one(name)
    aux = _aux(tab, specs, y, u, kw)
    cts = tuple(torch.from_numpy(v)
                for v in np.random.RandomState(10).normal(size=(3, N)))
    ref = CG.opd_adjoint_reference(tab, specs, state, aux, cts)
    got = CG._opd_adjoint_by_hand(tab, specs, state, aux, cts)
    nq9 = nq + 1
    assert CG._nslots(tab, specs, CS.OPD_SLOTS) == nq9
    assert ref[0].shape == got[0].shape == (len(specs), nq9)
    assert bool(ref[0][j, -nxy:].any()) and bool(ref[0][1:, 6].all())
    assert int((ref[0][:, -nxy:] != 0).any(-1).sum()) == 1
    scale = ref[0].abs().amax(0).clamp(min=1e-300)
    assert float(((got[0] - ref[0]).abs()/scale).max()) <= 1e-10
    for a, b in zip((*got[1], got[2]), (*ref[1], ref[2])):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                               atol=1e-12*float(b.abs().max()))


# -- the keys -----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_k7_and_k9_freeform_slot_layouts(name):
    """A freeform K7 key's rows: K5's layout (SLOTS, the coefficients, a
    grating's grating_dy, then the XY coefficients, last); K9's: OPD_SLOTS
    (n_before at 6), the coefficients, grating_dy, the XY coefficients.
    The XY slots are live on the freeform row alone (none on the image
    row); K9's other columns are K7's with n_before; the K3, K6, K8 and
    K9 keys carry nxy and their translation units define RAYOPT_N_XY;
    the wrappers' CPU masks are the keys'; a row word refuses slots past
    LIVE_BITS, naming the XY width."""
    _, tab, _, specs, _ = _one(name)
    widths = CT.figure_widths(tab, specs)
    nxy = CT.xy_width(tab, specs)
    kw = dict(widths=widths, nd=CT.doe_width(tab, specs), nxy=nxy)
    k5 = CS.adjoint_key(specs, F64, **kw)
    k7 = CS.adjoint_multi_key(specs, F64, **kw)
    k9 = CS.opd_adjoint_key(specs, F64, **kw)
    grating = int(CT.carries_grating(specs))
    assert k7.slots == k5.slots == CS.SLOTS + sum(widths) + grating + nxy
    assert k9.slots == CS.OPD_SLOTS + sum(widths) + grating + nxy
    assert k7.words == k5.words
    for key in (k7, k9, CS.opd_key(specs, F64, **kw),
                CS.trace_multi_key(specs, F64, 3, **kw),
                CS.trace_multi_key(specs, F64, 3, True, **kw),
                CS.moments_multi_key(specs, F64, False, 3, **kw)):
        assert key.nxy == nxy
        assert "#define RAYOPT_N_XY %d\n" % nxy in CS.translation_unit(key)
    l7 = CS.live_mask(CS.live_slots(specs, CS.FIELDS, widths, 0, nxy),
                      k7.slots).numpy()
    l9 = CS.live_mask(CS.opd_live_slots(specs, CS.OPD_DIFF, widths, 0, nxy),
                      k9.slots).numpy()
    j = _ff_row(specs)
    img = len(specs) - 1
    assert l7[j, -nxy:].all() and l9[j, -nxy:].all()
    others = [i for i in range(len(specs)) if i != j]
    assert not l7[others, -nxy:].any() and not l9[others, -nxy:].any()
    assert not l9[img, CS.OPD_SLOTS:].any()
    inner = slice(0, img)
    nptest.assert_array_equal(l9[inner, :CS.SLOTS], l7[inner, :CS.SLOTS])
    nptest.assert_array_equal(l9[inner, CS.OPD_SLOTS:], l7[inner, CS.SLOTS:])
    assert l9[1:, 6].all() and not l9[0].any()
    # only xy_poly asked for: the XY slots of the freeform row alone
    m9 = CS.opd_live_slots(specs, ("xy_poly",), widths, 0, nxy)
    assert [bin(m).count("1") for m in m9] == [nxy if i == j else 0
                                              for i in range(len(specs))]
    # the row word: a degree-8 figure (44 terms) is past LIVE_BITS
    for make in (CS.adjoint_multi_key, CS.opd_adjoint_key):
        with pytest.raises(ValueError, match="XY width 44"):
            make(specs, F64, widths=widths, nxy=44)


def test_multi_keys_reckon_the_xy_words(monkeypatch):
    """K3's and K6's keys stage their tables in static shared memory: on
    a long freeform chain (the aspheric base's freeform row twenty-four
    times) the XY coefficients lower multi_most below the same chain's
    without them, a key past it is refused, and the wrappers' runs split
    a stack past it into balanced runs of keys that carry the XY width,
    without raising (cuda_spec.load patched: no build)."""
    _, tab, _, specs, _ = _one("aspheric base")
    long = specs[:1] + specs[1:2]*24 + specs[2:]
    widths = CT.figure_widths(tab, specs)
    nxy = CT.xy_width(tab, specs)
    plain = tuple(s._replace(freeform=False) for s in long)
    for kernel in ("k3", "k3m", "k6"):
        most = CS.multi_most(kernel, long, F64, widths=widths, nxy=nxy)
        assert 1 <= most < CS.multi_most(kernel, plain, F64,
                                         widths=widths) <= CS.MAX_NLAM
        make = {"k3": lambda n: CS.trace_multi_key(long, F64, n,
                                                   widths=widths, nxy=nxy),
                "k3m": lambda n: CS.trace_multi_key(long, F64, n, True,
                                                    widths=widths, nxy=nxy),
                "k6": lambda n: CS.moments_multi_key(long, F64, False, n,
                                                     widths=widths,
                                                     nxy=nxy)}[kernel]
        key = make(most)
        assert key.nxy == nxy and key.row_words == CT.ROW + sum(widths) + nxy
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
        nlam = 2*CS.multi_most("k6", long, F64, widths=widths, nxy=nxy) + 1
        runs = {"k3": CT._multi_runs(long, F64, nlam, False, widths, 0,
                                     nxy),
                "k6": CG._moments_multi_runs(long, F64, False, nlam, widths,
                                             0, nxy)}
    finally:
        CT._multi_kernel.cache_clear()
        CG._moments_multi_kernel.cache_clear()
    for kernel, rs in runs.items():
        sizes = [l1 - l0 for l0, l1, _ in rs]
        assert rs[0][0] == 0 and rs[-1][1] == nlam and len(rs) > 1
        assert max(sizes) - min(sizes) <= 1
        assert all(k.kernel == kernel and k.nlam == n and k.nxy == nxy
                   for (_, _, k), n in zip(rs, sizes))


# -- the slice: the Schmidt corrector's design step --------------------------

def test_schmidt_design_merit_and_gradient_match_jax():
    """The freeform Schmidt corrector's composite design merit at step 0
    -- the spot RMS of its three on-axis bundles (one a wavelength, with
    the wavelength's chroma overrides) through adjoint_spot_rms (K4/K5)
    plus the wavefront RMS of the first wavelength's bundle through
    adjoint_wavefront_rms (K8/K9); no focal-length term: on axis its
    paraxial EFL is NaN -- and its gradient in xy_poly, against
    jax.value_and_grad (jitted) of the JAX package's spot_rms and
    wavefront_rms with the same specs (unroll=True) on the same bundles
    (hexapolar, nrays 8: 7 rays a bundle, ray 0 the chief ray): the
    value to RTOL, the gradient to GRAD_REL of its largest, nonzero on
    the plate's row alone (the value also to 1e-9 waves: its wavefront
    term's rounding)."""
    js, ts = schmidt(jro), schmidt(tro)
    assert not np.isfinite(ts.paraxial.focal_length[1])
    jb = JGR.bundles_from_system(js, fields=(0.,), nrays=8,
                                 distribution="hexapolar")
    assert len(jb) == 3 and all(b[0].shape[0] <= 64 for b in jb)
    jt = js.table()
    jspecs = JK.specialize(jt)
    kw = dict(ref=0, radius=-js.image.pupil.distance,
              wavelength=js.wavelengths[0], scale=js.scale,
              finite=js.object.finite)

    # one compile a term: the bundles and their chroma overrides are
    # arguments
    jspot = jax.jit(jax.value_and_grad(
        lambda xy, y, u, w, ov: JGR.spot_rms(
            jt.replace(xy_poly=xy, **ov), y, u, w, specs=jspecs,
            unroll=True)))
    jwave = jax.jit(jax.value_and_grad(
        lambda xy, y, u, w: JGR.wavefront_rms(
            jt.replace(xy_poly=xy), y, u, w, specs=jspecs, unroll=True,
            **kw)))
    xy0 = jnp.asarray(jt.xy_poly)
    parts = [jspot(xy0, y, u, w, {k: jnp.asarray(v) for k, v in ch.items()
                                  if k != "wavelength"})
             for y, u, w, ch in jb] + [jwave(xy0, *jb[0][:3])]
    jv = sum(float(v) for v, _ in parts)
    jg = sum(np.asarray(g) for _, g in parts)
    tt = ts.table()
    specs = TK.specialize(tt)
    assert specs == TK.specs_from_tuple(jspecs)
    tb = TGR.bundles_from_numpy(jb)
    xy = tt.xy_poly.clone().requires_grad_()
    tab = tt.replace(xy_poly=xy)
    total = 0.
    before = (CG.weighted_moments.launches, CG.opd_chain.launches)
    with pytest.warns(UserWarning, match="xy_poly"):
        for y, u, w, chroma in tb:
            ov = {k: v for k, v in chroma.items() if k != "wavelength"}
            total = total + CG.adjoint_spot_rms(tab.replace(**ov), y, u, w,
                                                specs=specs)
        y, u, w, _ = tb[0]
        total = total + CG.adjoint_wavefront_rms(tab, y, u, w, specs=specs,
                                                 **kw)
    total.backward()
    assert (CG.weighted_moments.launches, CG.opd_chain.launches) == before
    # the wavefront term's ~85 waves are the difference of optical paths
    # of ~6e6 waves to a sphere of radius ~3.8 m: 1e-9 waves is their
    # rounding
    nptest.assert_allclose(float(total.detach()), jv, rtol=RTOL, atol=1e-9)
    _close_grad(xy.grad, jg, "xy_poly")
    assert bool(xy.grad[1].any()) and int((xy.grad.abs().sum(1)
                                           != 0).sum()) == 1
