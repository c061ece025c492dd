"""rayopt_tpu_torch's anamorphic rows (conic cylinders in closed form,
biconics and toroids by the seeded Newton) against the JAX package, in
float64 on the CPU: the Biconic and Toroid element oracles, the tables
and specs of the crossed-cylinder pair (models.anamorphic_pair) and of
the reference's split-conic biconic and toroid lenses
(tests/test_anamorphic.py's _cyl_system(cx=.013) with conics -0.4 and
0.25, and _toroid_system), the specialized and generic steps, the
engines of ops.geometric on aimed bundles, the per-axis paraxial
matrix, the YAML round trip, the cylinder's cancellation-free root, the
Newton's gradient against jax.grad of the reference's specialized
engine, device aiming on the pair, and the figured anamorphic rows (a
toroid's generating-curve polynomial in y^2, a biconic's in r^2; a
figured cylinder specializes as a biconic): their steps, traces and
Newton gradients.  Traces agree to 1e-12 relative
with identical NaN masks, gradients to 1e-8 of the largest of each
field.  The kernel side (K5's hand reverse, the key words and slots,
the refusals, optimize_grad) is tests/test_torch_spec_anamorphic.py."""

import warnings

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import rayopt_tpu as jro
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.formats import system_from_yaml, system_to_yaml
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.parallel import grad as TGR

RTOL = ATOL = 1e-12
GRAD_RTOL = 1e-8
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    # several test workers import both frameworks at once
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default():
    # the port's entry points default to the card: these tests ask for
    # the CPU, where every wrapper runs its plain version
    old = set_default_device("cpu")
    yield
    set_default_device(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float64)))


def _same(got, want, rtol=RTOL, atol=ATOL, msg=""):
    """Identical NaN masks, the finite values within rtol/atol."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    nptest.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
    ok = np.isfinite(want)
    nptest.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol,
                           err_msg=msg)


# -- the three lenses --------------------------------------------------------

def split_biconic(mod):
    """The reference's split-conic biconic: _cyl_system(cx=.013) with
    conic -0.4 and conic_x 0.25 on its biconic row."""
    s = mod.System([
        dict(material="air"),
        dict(type="biconic", roc=25.84, curvature_x=.013, distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="biconic", distance=3., material="air", radius=10.),
        dict(distance=47., radius=10.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    for j in (1, 3):
        if hasattr(s[j], "conic_x"):
            s[j].conic = -.4
            s[j].conic_x = .25
    s.update()
    return s


def toroid_lens(mod):
    """The reference's _toroid_system: a toroid (roc 51.68, rotation
    radius 200) and a flat toroid behind it."""
    s = mod.System([
        dict(material="air"),
        dict(type="toroid", roc=51.68, roc_rotation=200., distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="toroid", distance=3., material="air", radius=10.),
        dict(distance=95., radius=20.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    return s


LENSES = {"pair": lambda mod: (jmodels if mod is jro else tmodels)
          .anamorphic_pair(),
          "biconic": split_biconic, "toroid": toroid_lens}

#: the toroid's generating-curve terms (y^2, y^4: the reference's
#: test_zmx_toroidal_polynomial_terms) and the biconic's even figure
#: (r^2, r^4)
TOROID_FIGURE = [1e-5, 2e-8]
BICONIC_FIGURE = [2e-4, -1e-6]


def figured_toroid(mod):
    """The toroid lens with TOROID_FIGURE on its first toroid's
    generating curve."""
    s = toroid_lens(mod)
    s[1].aspherics = list(TOROID_FIGURE)
    s.update()
    return s


def figured_biconic(mod):
    """The split-conic biconic with BICONIC_FIGURE on its first row."""
    s = split_biconic(mod)
    s[1].aspherics = list(BICONIC_FIGURE)
    s.update()
    return s


#: the figured anamorphic lenses (the plain path: the tests at the end)
FIGURED = {"figured toroid": figured_toroid,
           "figured biconic": figured_biconic}


def lens(name):
    """(JAX system, port system) of one anamorphic lens (LENSES or
    FIGURED)."""
    make = LENSES.get(name) or FIGURED[name]
    return make(jro), make(tro)


def bundle(n, seed, half=4., slope=.01):
    """(y0, u0) numpy: x, y uniform in +-half, slopes in +-slope."""
    rng = np.random.RandomState(seed)
    y0 = np.zeros((n, 3))
    y0[:, :2] = rng.uniform(-half, half, (n, 2))
    u0 = np.zeros((n, 3))
    u0[:, :2] = rng.uniform(-slope, slope, (n, 2))
    u0[:, 2] = np.sqrt(1 - np.square(u0[:, :2]).sum(1))
    return y0, u0


def jax_row(jt, j):
    return JT.SurfaceTable(*(None if f is None else jnp.asarray(f)[j]
                             for f in jt))


# -- elements ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["biconic", "toroid"])
def test_element_oracles_match_jax(kind):
    """Biconic and Toroid: surface_sag, surface_normal, intercept and
    refract (Snell and a mirror) against the JAX elements to 1e-12;
    dict, reverse and rescale as the reference's."""
    kw = (dict(curvature=.021, conic=-.6, curvature_x=-.034, conic_x=.4,
               radius=8.) if kind == "biconic"
          else dict(curvature=1/51.68, conic=-.3, curvature_rotation=1/200.,
                    radius=8.))
    cls = {"biconic": "Biconic", "toroid": "Toroid"}[kind]
    je, te = getattr(jro.elements, cls)(**kw), getattr(tro, cls)(**kw)
    y, u = bundle(48, 3, 6., .1)
    y[:, 2] = -5.
    tj, tt = je.intercept(y, u), te.intercept(y, u)
    assert np.isfinite(tj).all()
    nptest.assert_allclose(tt, tj, rtol=RTOL, atol=ATOL)
    p = y + tj[:, None]*u
    nptest.assert_allclose(te.surface_sag(p), je.surface_sag(p), atol=ATOL)
    nptest.assert_allclose(te.surface_normal(p), je.surface_normal(p),
                           rtol=RTOL, atol=ATOL)
    for mu in (1/1.5, -1.):
        nptest.assert_allclose(te.refract(p, u, mu), je.refract(p, u, mu),
                               rtol=RTOL, atol=ATOL, equal_nan=True)
    assert te.dict() == je.dict()
    for op in (lambda e: e.reverse(), lambda e: e.rescale(2.5)):
        op(je)
        op(te)
        assert te.dict() == je.dict()
        assert te._vertex_power_x() == je._vertex_power_x()


# -- tables, specs, steps ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(LENSES))
def test_tables_and_specs_match_jax(name):
    """System.table fills curvature_dx, conic_dx and toroidal as the
    reference's (every field equal), and specialize gives equal spec
    tuples: the pair's y- and x-cylinders, the biconic, the toroids."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    for f in tt._fields:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        nptest.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    specs = TK.specialize(tt)
    assert TK.specs_from_tuple(JK.specialize(jt)) == specs
    kinds = [(sp.cyl_axis, sp.biconic, sp.toroidal) for sp in specs[1:]
             if TK.is_anamorphic_spec(sp)]
    assert kinds == {"pair": [(1, True, False), (2, True, False)],
                     "biconic": [(0, True, False)],
                     "toroid": [(0, False, True), (0, False, True)]}[name]


#: the anamorphic rows of each lens (test_tables_and_specs_match_jax)
ROWS = {"pair": (1, 3), "biconic": (1,), "toroid": (1, 2)}
VARIANTS = ("as is", "rotated mirror", "rotated alternate")


def _variant(jt, tt, j, spec, variant):
    """The row j of both tables and the spec, edited for `variant`."""
    jr, tr = jax_row(jt, j), tt.row(j)
    if variant == "as is":
        return jr, tr, spec
    th = .03
    rot = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                    [0, np.sin(th), np.cos(th)]])
    off = np.asarray(jr.offset) + np.array([.1, -.2, 0.])
    kw = dict(rot=rot, offset=off)
    if variant == "rotated mirror":
        kw["mu"] = -1.
        spec = spec._replace(kind=2)
    else:
        kw["alternate"] = 1.
        spec = spec._replace(alternate=True)
    spec = spec._replace(rotated=True, off_axis=True)
    jr = jr._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tr._replace(**{k: _t(v) for k, v in kw.items()})
    return jr, tr, spec


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name,j", [(n, j) for n in sorted(ROWS)
                                    for j in ROWS[n]])
def test_surface_step_spec_matches_jax(name, j, variant):
    """kernels.surface_step_spec on each anamorphic row kind (its
    closed-form cylinder, biconic or toroid Newton, their refraction,
    the passthrough skip) against the reference's, to 1e-12 with equal
    NaN masks."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    spec = TK.specialize(tt)[j]
    jr, tr, spec = _variant(jt, tt, j, spec, variant)
    y0, u0 = bundle(64, j, 6.)
    y0[:, 2] = -80. if variant == "rotated alternate" else -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    jspec = JK.SurfaceSpec(**spec._asdict())
    for clip in (False, True):
        want = JK.surface_step_spec(state, jr, jspec, clip)
        got = TK.surface_step_spec(tuple(map(_t, state)), tr, spec, clip)
        for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
            _same(g, w, msg="%s row %d %s" % (name, j, variant))


@pytest.mark.parametrize("name", sorted(LENSES))
def test_generic_anamorphic_step_matches_jax(name):
    """The generic walk's anamorphic step (surface_step(biconic=True):
    both Newton candidates and the zero-order grating solve) on every
    row, against the reference's, to 1e-12."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    y0, u0 = bundle(64, 5, 5.)
    y0[:, 2] = -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    for j in range(1, tt.nsurfaces):
        want = JK.surface_step(state, jax_row(jt, j), True, True)
        got = TK.surface_step(tuple(map(_t, state)), tt.row(j), True, True)
        for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
            _same(g, w, msg="row %d" % j)


@pytest.mark.parametrize("name", sorted(LENSES))
def test_trace_rays_final_on_aimed_bundles_matches_jax(name):
    """ops.geometric on bundles aimed by the host at fields 0, 0.7 and
    1: the specialized engine (specs) and the generic one
    (biconic=True), clipped and not, against the reference's to 1e-12
    with equal NaN masks; trace_rays_final_fast on the CPU takes the
    generic anamorphic walk."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    jspecs, specs = JK.specialize(jt), TK.specialize(tt)
    rng = np.random.RandomState(7)
    for field in (0., .7, 1.):
        z, p = ts.pupil((0., field))
        yp = rng.uniform(-1.2, 1.2, (96, 2))
        y0, u0 = ts.aim((0., field), yp, z, p, filter=False)
        for clip in (False, True):
            want = JG.trace_rays_final(jt, y0, u0, specs=jspecs,
                                       unroll=True, clip=clip)
            got = TG.trace_rays_final(tt, _t(y0), _t(u0), specs=specs,
                                      clip=clip)
            for g, w in zip(got, want):
                _same(g, w, msg="specs field %g" % field)
            want = JG.trace_rays_final(jt, y0, u0, biconic=True, clip=clip)
            got = TG.trace_rays_final(tt, _t(y0), _t(u0), biconic=True,
                                      clip=clip)
            for g, w in zip(got, want):
                _same(g, w, msg="generic field %g" % field)
            if not clip:
                fast = TG.trace_rays_final_fast(tt, _t(y0), _t(u0))
                for g, w in zip(fast, want):
                    _same(g, w, msg="fast field %g" % field)


@pytest.mark.parametrize("name", sorted(LENSES))
def test_paraxial_per_axis_matches_jax(name):
    """The per-axis paraxial matrices (_vertex_power_x in the sagittal
    slot) and the system's focal lengths equal the reference's."""
    js, ts = lens(name)
    for je, te in zip(js, ts):
        if hasattr(te, "paraxial_matrix"):
            nj, mj = je.paraxial_matrix(1., js.wavelengths[0])
            nt, mt = te.paraxial_matrix(1., ts.wavelengths[0])
            nptest.assert_allclose(mt, mj, rtol=RTOL, atol=ATOL)
    nptest.assert_allclose(ts.paraxial.focal_length,
                           js.paraxial.focal_length, rtol=RTOL)


def test_yaml_round_trip():
    """type: biconic and type: toroid survive system_to_yaml /
    system_from_yaml, their tables equal to the reference's."""
    for name in sorted(LENSES):
        js, ts = lens(name)
        back = system_from_yaml(system_to_yaml(ts))
        assert [type(e).__name__ for e in back] == \
            [type(e).__name__ for e in ts]
        back.update()
        for f in ("curvature", "conic", "curvature_dx", "conic_dx",
                  "toroidal", "offset", "mu"):
            nptest.assert_array_equal(getattr(back.table(), f).numpy(),
                                      np.asarray(getattr(js.table(), f)),
                                      err_msg=f)
    assert "type: toroid" in system_to_yaml(toroid_lens(tro))


# -- the cylinder's root -----------------------------------------------------

def test_cylinder_root_is_cancellation_free():
    """kernels.intercept_cyl takes the cancellation-free pair: it equals
    the reference's intercept_conic restricted to (w, z) (x = 0, ux = 0:
    a y-cylinder's meridian) to 1e-12, also at a near-flat curvature
    where the reference's intercept_cyl (-(d + g)/e) loses its digits,
    and equals that intercept_cyl where the latter does not cancel."""
    y0, u0 = bundle(64, 11, 6., .05)
    w, uw, uz = y0[:, 1], u0[:, 1], np.sqrt(1 - u0[:, 1]**2)
    z = np.full(64, -3.)
    for c, k in ((.019, 0.), (-.03, -.5), (1e-12, 0.), (-1e-11, .3)):
        zero = np.zeros(64)
        want = JK.intercept_conic(zero, w, z, zero, uw, uz, c, k, 0.)
        got = TK.intercept_cyl(_t(w), _t(z), _t(uw), _t(uz), _t(c), _t(k),
                               _t(0.))
        _same(got, want, msg="c %g" % c)
        if abs(c) > 1e-6:
            ref = JK.intercept_cyl(w, z, uw, uz, c, k, 0.)
            _same(got, ref, msg="intercept_cyl c %g" % c)
    # near flat, the reference's form cancels: far from the plane root
    ref = np.asarray(JK.intercept_cyl(w, z, uw, uz, 1e-12, 0., 0.))
    plane = -z/uz
    got = TK.intercept_cyl(_t(w), _t(z), _t(uw), _t(uz), _t(1e-12),
                           _t(0.), _t(0.)).numpy()
    assert np.abs(got - plane).max() < 1e-9 < np.abs(ref - plane).max()


# -- gradients ---------------------------------------------------------------

FIELDS = ("curvature", "conic", "curvature_dx", "conic_dx")


@pytest.mark.parametrize("name", sorted(LENSES))
def test_newton_gradient_matches_jax_grad(name):
    """The spot RMS through the specialized engine (the Newton rows by
    kernels._NewtonRoot's implicit backward, the cylinders by autograd
    through their closed form) differentiated w.r.t. curvature, conic,
    curvature_dx and conic_dx against jax.grad of the reference's
    spot_rms(specs=..., unroll=True), to 1e-8 of each field's largest."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    jspecs, specs = JK.specialize(jt), TK.specialize(tt)
    y0, u0 = bundle(256, 13)
    w = np.full(256, 1/256)

    def jloss(*vals):
        return JGR.spot_rms(jt.replace(**dict(zip(FIELDS, vals))), y0, u0,
                            w, specs=jspecs, unroll=True)
    jvals = [jnp.asarray(getattr(jt, f)) for f in FIELDS]
    want = jax.grad(jloss, argnums=tuple(range(4)))(*jvals)
    leaves = {f: getattr(tt, f).clone().requires_grad_() for f in FIELDS}
    v = TGR.spot_rms(tt.replace(**leaves), _t(y0), _t(u0), _t(w),
                     specs=specs)
    nptest.assert_allclose(float(v), float(jloss(*jvals)), rtol=1e-12)
    v.backward()
    for f, g in zip(FIELDS, want):
        g = np.asarray(g)
        got = (leaves[f].grad if leaves[f].grad is not None
               else torch.zeros_like(leaves[f])).numpy()
        nptest.assert_allclose(got, g, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL*max(np.abs(g).max(), 1e-300),
                               err_msg=f)


@pytest.mark.parametrize("kind", ["biconic", "toroid"])
def test_newton_root_gradcheck_of_each_kind(kind):
    """torch.autograd.gradcheck of kernels._NewtonRoot on the biconic
    and toroid residuals: the implicit derivative at the root against
    central differences of the converged forward, w.r.t. the rays and
    every figure parameter (the seed gets none)."""
    rng = np.random.RandomState(4)
    n = 6
    x, y = (_t(v) for v in rng.uniform(-4, 4, (2, n)))
    z = _t(np.full(n, -2.))
    ux, uy = (_t(v) for v in rng.uniform(-.1, .1, (2, n)))
    uz = torch.sqrt(1 - ux*ux - uy*uy)
    figure = ([.013, .25, 1/25.84, -.4] if kind == "biconic"
              else [1/200., 1/51.68, -.3])
    leaves = [v.clone().requires_grad_()
              for v in (x, y, z, ux, uy, uz, *map(_t, figure))]
    empty = torch.zeros(0, dtype=F64)

    def root(*a):
        rays, fig = a[:6], list(a[6:]) + [None]*(4 - len(a[6:]))
        seed = TK.intercept_conic(*(v.detach() for v in rays),
                                  fig[2].detach() if kind == "biconic"
                                  else fig[1].detach(),
                                  fig[3].detach() if kind == "biconic"
                                  else fig[2].detach(), 0.)
        return TK._NewtonRoot.apply(seed, *rays, fig[0], fig[1], empty,
                                    empty, TK.ASPHERIC_ITERS,
                                    TK.ASPHERIC_TOL, kind, fig[2], fig[3])
    assert torch.isfinite(root(*leaves)).all()
    assert torch.autograd.gradcheck(root, leaves, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


# -- device aiming -----------------------------------------------------------

def test_device_aiming_on_the_pair_matches_the_host_pupil():
    """System.pupils (ops.aiming.pupil_batched: the specialized stop
    trace through the y-cylinder stop) on the aimed pair, against the
    host pupil at tol 1e-12, and in rim mode (the generic walk's
    anamorphic step) against the reference's rim-mode solve."""
    fields = [(0., f) for f in (0., .7, 1.)]

    def aimed(models):
        s = models.anamorphic_pair()
        s.object.pupil.aim = True
        s.update()
        return s
    ts = aimed(tmodels)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # a host fallback fails
        z, boxes = ts.pupils(fields)
    host = [aimed(tmodels).pupil(f, tol=1e-12) for f in fields]
    nptest.assert_allclose(z, [h[0] for h in host], rtol=1e-9)
    nptest.assert_allclose(boxes, [h[1] for h in host], rtol=1e-9)
    from rayopt_tpu.ops import aiming as JA
    from rayopt_tpu_torch.ops import aiming as TA
    js = aimed(jmodels)
    jt, tt = js.table(), ts.table()
    kw = dict(finite=False, projection=js.object.projection,
              slope=np.tan(js.object.angle), rim=True)
    fy = np.array([0., .7, 1.])
    f = np.stack([np.zeros(3), fy], 1)
    jz, jb = JA.pupil_batched(jt, jnp.asarray(f), js.object.pupil.distance,
                              js.object.pupil.radius, js.stop,
                              specs=JK.specialize(jt), **kw)
    tz, tb = TA.pupil_batched(tt, _t(f), ts.object.pupil.distance,
                              ts.object.pupil.radius, ts.stop,
                              specs=TK.specialize(tt), **kw)
    nptest.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-10)
    nptest.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10,
                           atol=1e-10)


# -- the figured anamorphic rows ---------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(FIGURED))
def test_figured_surface_step_spec_matches_jax(name, variant):
    """kernels.surface_step_spec on the figured biconic row (its even
    polynomial in r^2 in the Newton residual, slope and normal) and the
    figured toroid row (its polynomial in y^2 on the generating curve),
    as is, rotated as a mirror and rotated with the alternate root,
    against the reference's, to 1e-12 with equal NaN masks; the specs
    are the reference's (aspheric and biconic or toroidal, no cylinder
    axis)."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    specs = TK.specialize(tt)
    assert TK.specs_from_tuple(JK.specialize(jt)) == specs
    spec = specs[1]
    assert spec.aspheric and (spec.biconic or spec.toroidal)
    assert not spec.cyl_axis
    jr, tr, spec = _variant(jt, tt, 1, spec, variant)
    y0, u0 = bundle(64, 1, 6.)
    y0[:, 2] = -80. if variant == "rotated alternate" else -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    jspec = JK.SurfaceSpec(**spec._asdict())
    for clip in (False, True):
        want = JK.surface_step_spec(state, jr, jspec, clip)
        got = TK.surface_step_spec(tuple(map(_t, state)), tr, spec, clip)
        for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
            _same(g, w, msg="%s %s" % (name, variant))


@pytest.mark.parametrize("name", sorted(FIGURED))
def test_figured_traces_match_jax(name):
    """ops.geometric on the figured lenses, bundles aimed by the host at
    fields 0 and 1: the specialized engine and the generic one
    (biconic=True), clipped and not, and trace_rays_final_fast on the
    CPU, against the reference's to 1e-12 with equal NaN masks; the
    figure moves the image against the lens without it."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    jspecs, specs = JK.specialize(jt), TK.specialize(tt)
    bare = LENSES[name.split()[1]](tro).table()
    rng = np.random.RandomState(8)
    for field in (0., 1.):
        z, p = ts.pupil((0., field))
        yp = rng.uniform(-1.2, 1.2, (96, 2))
        y0, u0 = ts.aim((0., field), yp, z, p, filter=False)
        for clip in (False, True):
            want = JG.trace_rays_final(jt, y0, u0, specs=jspecs,
                                       unroll=True, clip=clip)
            got = TG.trace_rays_final(tt, _t(y0), _t(u0), specs=specs,
                                      clip=clip)
            for g, w in zip(got, want):
                _same(g, w, msg="specs field %g" % field)
            want = JG.trace_rays_final(jt, y0, u0, biconic=True, clip=clip)
            got = TG.trace_rays_final(tt, _t(y0), _t(u0), biconic=True,
                                      clip=clip)
            for g, w in zip(got, want):
                _same(g, w, msg="generic field %g" % field)
        fast = TG.trace_rays_final_fast(tt, _t(y0), _t(u0))
        for g, w in zip(fast, want):
            _same(g, w, msg="fast field %g" % field)
        plain = TG.trace_rays_final(bare, _t(y0), _t(u0),
                                    specs=TK.specialize(bare))
        moved = np.nanmax(np.abs((fast[0] - plain[0]).numpy()))
        assert moved > 1e-6, moved


@pytest.mark.parametrize("name", sorted(FIGURED))
def test_figured_newton_gradient_matches_jax_grad(name):
    """The spot RMS through the specialized engine on the figured lens
    (the Newton's implicit backward with the figure's terms)
    differentiated w.r.t. curvature, conic, curvature_dx, conic_dx and
    the even coefficients against jax.grad of the reference's
    spot_rms(specs=..., unroll=True), to 1e-8 of each field's largest;
    the figured row's coefficients get a nonzero gradient."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    jspecs, specs = JK.specialize(jt), TK.specialize(tt)
    fields = FIELDS + ("aspherics",)
    y0, u0 = bundle(256, 14)
    w = np.full(256, 1/256)

    def jloss(*vals):
        return JGR.spot_rms(jt.replace(**dict(zip(fields, vals))), y0, u0,
                            w, specs=jspecs, unroll=True)
    jvals = [jnp.asarray(getattr(jt, f)) for f in fields]
    want = jax.grad(jloss, argnums=tuple(range(len(fields))))(*jvals)
    leaves = {f: getattr(tt, f).clone().requires_grad_() for f in fields}
    v = TGR.spot_rms(tt.replace(**leaves), _t(y0), _t(u0), _t(w),
                     specs=specs)
    nptest.assert_allclose(float(v), float(jloss(*jvals)), rtol=1e-12)
    v.backward()
    for f, g in zip(fields, want):
        g = np.asarray(g)
        got = (leaves[f].grad if leaves[f].grad is not None
               else torch.zeros_like(leaves[f])).numpy()
        nptest.assert_allclose(got, g, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL*max(np.abs(g).max(), 1e-300),
                               err_msg=f)
    assert np.abs(np.asarray(want[-1])[1]).max() > 0


def test_figured_cylinder_specializes_as_a_biconic():
    """An x-cylinder with an aspheric figure (the pair's row 3 with an
    even figure) is no longer a cylinder: specialize gives the
    reference's spec (cyl_axis 0, biconic, aspheric), the key's row
    flags are F_BICONIC | F_ASPHERIC and never a cylinder's, and the
    step traces it by the biconic's Newton as the reference does
    (1e-12, equal NaN masks)."""
    js, ts = lens("pair")
    for s in (js, ts):
        s[3].aspherics = [1e-4]
        s.update()
    jt, tt = js.table(), ts.table()
    specs = TK.specialize(tt)
    assert TK.specs_from_tuple(JK.specialize(jt)) == specs
    spec = specs[3]
    assert spec.cyl_axis == 0 and spec.biconic and spec.aspheric
    from rayopt_tpu_torch.ops import cuda_trace as CT
    flags = CT._flags(spec)
    assert flags & CT.F_BICONIC and flags & CT.F_ASPHERIC
    assert not flags & (CT.F_CYL_X | CT.F_CYL_Y | CT.F_TOROID)
    y0, u0 = bundle(64, 2, 5.)
    y0[:, 2] = -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    want = JK.surface_step_spec(state, jax_row(jt, 3),
                                JK.SurfaceSpec(**spec._asdict()), False)
    got = TK.surface_step_spec(tuple(map(_t, state)), tt.row(3), spec, False)
    for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
        _same(g, w)
