"""rayopt_tpu_torch's freeform XY rows (a conic or even/odd aspheric base
plus a triangular XY-monomial figure) against the JAX package, in
float64 on the CPU: the polynomial helpers (_poly_xy, _dpoly_xy), the
FreeformXY and ZernikeSag elements (sag, normal, intercept, refraction,
YAML round trip, reverse, rescale), System.table's xy_poly column and
the specs on the reference's freeform lenses (the Schmidt corrector, the
Zernike corrector, the quadratic XY singlet), the per-axis paraxial
power of a quadratic freeform against its biconic paraboloid, the
specialized and generic steps and traces on six lenses (those three,
the quadratic freeform table and its biconic twin, a freeform on a
curved aspheric base and a freeform on a grating row), the intercept of
rays whose conic seed misses, spot-RMS gradients in xy_poly, curvature
and aspherics against jax.grad, freeform_scales, and stop- and rim-mode
aiming on the Zernike corrector.  Traces agree to 1e-12 relative with
identical NaN masks.  The kernel side (K5's hand reverse, the keys, the
refusals, optimize_grad) is tests/test_torch_spec_freeform.py."""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
import jax.numpy as jnp
import rayopt_tpu as jro
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import surfaces as JS
from rayopt_tpu.ops import tables as JT
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch.formats import system_from_yaml, system_to_yaml
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import paraxial as TP
from rayopt_tpu_torch.ops import surfaces as TS
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _same, _t, bundle, jax_row)

F64 = torch.float64
CX, CY = 1/80., 1/50.
QUAD = [0., 0., CX/2., 0., CY/2.]   # x, y, x^2, xy, y^2


# -- the lenses ---------------------------------------------------------------

def schmidt(mod, coefficients=None):
    """The reference's freeform Schmidt corrector
    (tests/test_freeform.py): a degree-4 xypoly plate (14 terms, norm
    radius 25 mm, N-BK7, seeded at 1e-10) ahead of an f/2 R = -200 mm
    mirror, a 25 mm pupil."""
    s = mod.System([
        dict(material="air"),
        dict(type="xypoly", xy_coefficients=coefficients or [1e-10]*14,
             norm_radius=25., distance=5., material="SCHOTT-BK|N-BK7",
             radius=26.),
        dict(distance=4., material="air", radius=26.),
        dict(roc=-200., distance=100., material="mirror", radius=30.),
        dict(distance=-95., radius=5.),
    ])
    s.object.pupil.radius = 25.
    s.object.pupil.update_radius = False
    s.update()
    return s


#: a figured Schmidt plate (normalized coefficients, mm of sag at R):
#: the x^2/y^2 defocus and the x^4/x^2y^2/y^4 corrector terms of a
#: Schmidt profile, plus small asymmetric terms
SCHMIDT_FIGURE = [0., 0., -.02, .001, -.021, 0., 1e-4, 0., -2e-4,
                  .012, 0., .024, 1e-4, .0118]


def zernike_corrector(mod):
    """The reference's Zernike corrector: Z11 = 0.002 at a 10 mm norm
    radius on an N-BK7 plate, an R = -100 mirror fold."""
    z = [0.]*10 + [0.002]
    s = mod.System([
        dict(material="air"),
        dict(type="zernike", zernike_coefficients=z, norm_radius=10.,
             distance=5., material="SCHOTT-BK|N-BK7", radius=10.),
        dict(distance=3., material="air", radius=10.),
        dict(roc=-100., distance=50., material="mirror", radius=12.),
        dict(distance=-48., radius=5.),
    ])
    s.object.pupil.radius = 8.
    s.object.pupil.update_radius = False
    s.update()
    return s


def xysystem(mod):
    """The reference's _xysystem: a degree-2 figure with an xy cross
    term on an N-BK7 singlet."""
    s = mod.System([
        dict(material="air"),
        dict(type="xypoly", xy_coefficients=[0, 0, .25, 0.02, .4],
             norm_radius=5., distance=5., material="SCHOTT-BK|N-BK7",
             radius=4.),
        dict(distance=3., material="air", radius=4.),
        dict(distance=40., radius=5.),
    ])
    s.object.pupil.radius = 2.
    s.object.pupil.update_radius = False
    s.update()
    return s


SYSTEMS = {"schmidt": schmidt, "zernike corrector": zernike_corrector,
           "xy singlet": xysystem,
           "figured schmidt": lambda mod: schmidt(mod, SCHMIDT_FIGURE)}

_QUAD_ROWS = dict(distance=[0., 10., 3., 40.], n_before=[1., 1., 1.5, 1.],
                  n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.])

#: make_table lenses (keyword arguments; the freeform row is row 1)
TABLES = {
    # the reference's _freeform_table: a quadratic freeform singlet
    "quadratic freeform": dict(curvature=[0.]*4,
                               xy_poly=[[0.]*5, QUAD, [0.]*5, [0.]*5],
                               **_QUAD_ROWS),
    # its independently built biconic paraboloid twin
    "biconic paraboloid": dict(curvature=[0., CY, 0., 0.],
                               conic=[0., -1., 0., 0.],
                               curvature_dx=[0., CX - CY, 0., 0.],
                               **_QUAD_ROWS),
    # a freeform on a curved conic base with an even aspheric term
    "aspheric base": dict(
        curvature=[0., 1/60., -1/80., 0.], conic=[0., -.6, 0., 0.],
        aspherics=[[0., 0.], [2e-6, -3e-9], [0., 0.], [0., 0.]],
        xy_poly=[[0.]*9, [1e-4, -2e-4, 3e-3, 1e-3, -2e-3, 2e-5, -1e-5,
                          3e-5, 1e-5], [0.]*9, [0.]*9],
        distance=[0., 10., 4., 40.], n_before=[1., 1., 1.5, 1.],
        n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.],
        radius=[np.inf, 9., 9., 20.]),
    # a freeform on a grating row: the phase solve's freeform normal
    "freeform grating": dict(
        curvature=[0., 1/70., 0., 0.], grating_dy=[0., .08, 0., 0.],
        xy_poly=[[0.]*5, [0., 0., 2e-3, -1e-3, 1.5e-3], [0.]*5, [0.]*5],
        distance=[0., 10., 3., 40.], n_before=[1., 1., 1.5, 1.],
        n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.],
        radius=[np.inf, 9., 9., 20.]),
}

#: the six lenses of the slice (the Schmidt corrector both seeded and
#: figured)
LENSES = tuple(SYSTEMS) + tuple(TABLES)


def tables(name):
    """(JAX table, port table) of one lens."""
    if name in SYSTEMS:
        return SYSTEMS[name](jro).table(), SYSTEMS[name](tro).table()
    jt = JT.make_table(**TABLES[name])
    return jt, TT.table_from_numpy(jt)


def freeform_rows(specs):
    return [j for j, sp in enumerate(specs) if sp.freeform]


def lens_bundle(name, n, seed):
    """(y0, u0) numpy in front of row 1: x, y within the lens's
    aperture, slopes of a few degrees."""
    half = {"schmidt": 22., "figured schmidt": 22.,
            "zernike corrector": 8., "xy singlet": 3.}.get(name, 6.)
    y0, u0 = bundle(n, seed, half, .03)
    return y0, u0


# -- the polynomial -----------------------------------------------------------

@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5, 6])
def test_poly_xy_matches_jax(deg):
    """_poly_xy and _dpoly_xy elementwise against the JAX package's
    (1e-13 relative), and _dpoly_xy against autograd of _poly_xy."""
    rng = np.random.RandomState(deg)
    nt = len(JK._xy_terms(deg))
    assert TK._xy_terms(deg) == JK._xy_terms(deg)
    assert TK.xy_degree(nt) == deg
    c = rng.normal(size=nt)*10.**-np.array([i + j for i, j
                                            in TK._xy_terms(deg)])
    x, y = rng.uniform(-9, 9, (2, 200))
    want = np.asarray(JK._poly_xy(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(c)))
    got = TK._poly_xy(_t(x), _t(y), _t(c))
    nptest.assert_allclose(got.numpy(), want, rtol=1e-13,
                           atol=1e-13*np.abs(want).max())
    wx, wy = (np.asarray(v) for v in JK._dpoly_xy(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(c)))
    tx = _t(x).requires_grad_()
    ty = _t(y).requires_grad_()
    gx, gy = TK._dpoly_xy(tx, ty, _t(c))
    for g, w in ((gx, wx), (gy, wy)):
        nptest.assert_allclose(g.detach().numpy(), w, rtol=1e-13,
                               atol=1e-13*np.abs(w).max())
    ax, ay = torch.autograd.grad(TK._poly_xy(tx, ty, _t(c)).sum(), (tx, ty))
    for g, a in ((gx, ax), (gy, ay)):
        nptest.assert_allclose(g.detach().numpy(), a.numpy(), rtol=1e-12,
                               atol=1e-13*np.abs(a.numpy()).max())


# -- the elements -------------------------------------------------------------

ELEMENTS = {
    "xypoly": dict(type="xypoly", curvature=.02, conic=-.4,
                   aspherics=[0., 1e-6],
                   xy_coefficients=[.01, -.02, .3, .05, .25, .01, 0., -.02,
                                    .015, .04, 0., .03, 0., .02],
                   norm_radius=8., radius=8.),
    "zernike": dict(type="zernike", curvature=-.01,
                    zernike_coefficients=[0., .01, -.02, .05, 0., .02, .01,
                                          0., 0., 0., .03],
                    norm_radius=9., radius=8.),
}


@pytest.mark.parametrize("kind", sorted(ELEMENTS))
def test_element_oracles_match_jax(kind):
    """FreeformXY and ZernikeSag: surface_sag and surface_normal to
    1e-13, intercept and refract (Snell and a mirror) to 1e-12 against
    the JAX elements; the Zernike sag's piston; dict, reverse and
    rescale as the reference's."""
    je = jro.elements.Element.make(dict(ELEMENTS[kind]))
    te = tro.Element.make(dict(ELEMENTS[kind]))
    assert type(te).__name__ == type(je).__name__
    nptest.assert_array_equal(te._xy_arr, je._xy_arr)
    if kind == "zernike":
        assert te.piston == je.piston and te.piston != 0.
    y, u = bundle(64, 3, 6., .1)
    y[:, 2] = -5.
    tj, tt = je.intercept(y, u), te.intercept(y, u)
    assert np.isfinite(tj).all()
    nptest.assert_allclose(tt, tj, rtol=1e-12, atol=1e-12)
    p = y + tj[:, None]*u
    for f in ("surface_sag", "surface_normal"):
        want = np.asarray(getattr(je, f)(p))
        nptest.assert_allclose(getattr(te, f)(p), want, rtol=1e-13,
                               atol=1e-13*np.abs(want).max(), err_msg=f)
    for mu in (1/1.5, -1.):
        nptest.assert_allclose(te.refract(p, u, mu), je.refract(p, u, mu),
                               rtol=1e-12, atol=1e-12, equal_nan=True)
    assert te.dict() == je.dict()
    for op, arg in (("reverse", ()), ("rescale", (2.5,))):
        getattr(je, op)(*arg)
        getattr(te, op)(*arg)
        assert te.dict() == je.dict(), op
        nptest.assert_allclose(te._xy_arr, je._xy_arr, rtol=1e-15)
        nptest.assert_allclose(te.surface_sag(p*2.5), je.surface_sag(p*2.5),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", ["zernike corrector", "xy singlet"])
def test_yaml_round_trip(name):
    """The YAML round trip keeps every element's dict and the traced
    rays (0.0 difference: the same table)."""
    s = SYSTEMS[name](tro)
    s2 = system_from_yaml(system_to_yaml(s))
    s2.update()
    assert [e.dict() for e in s2] == [e.dict() for e in s]
    nptest.assert_array_equal(s2.table().xy_poly.numpy(),
                              s.table().xy_poly.numpy())
    t, t2 = tro.GeometricTrace(s), tro.GeometricTrace(s2)
    t.rays_point((0., 0.), nrays=16)
    t2.rays_point((0., 0.), nrays=16)
    nptest.assert_array_equal(t2.y[-1], t.y[-1])


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_tables_and_specs_match_jax(name):
    """System.table writes xy_poly as the reference's (every field
    equal), and specialize gives equal specs, the freeform flag on row
    1 only."""
    js, ts = SYSTEMS[name](jro), SYSTEMS[name](tro)
    for lam in js.wavelengths:
        jt, tt = js.table(lam), ts.table(lam)
        for f in tt._fields:
            a, b = getattr(jt, f), getattr(tt, f)
            if a is None or b is None:
                assert a is None and b is None, f
                continue
            nptest.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    specs = TK.specialize(tt)
    assert TK.specs_from_tuple(JK.specialize(jt)) == specs
    assert freeform_rows(specs) == [1]
    if name.endswith("schmidt"):
        assert tuple(tt.xy_poly.shape) == (5, 14)


def test_paraxial_per_axis_power_matches_the_biconic():
    """The quadratic freeform singlet's per-axis first order (its xy
    term dropped) equals the biconic paraboloid's: the host
    ParaxialTrace heights (1e-12) and abcd_matrices (1e-14), as the
    reference's test."""
    def biconic(mod):
        cx, cy = 2*.25/25., 2*.4/25.
        s = mod.System([
            dict(material="air"),
            dict(type="biconic", curvature=cy, conic=-1., curvature_x=cx,
                 conic_x=-1., distance=5., material="SCHOTT-BK|N-BK7",
                 radius=4.),
            dict(type="biconic", distance=3., material="air", radius=4.),
            dict(distance=40., radius=5.)])
        s.object.pupil.radius = 2.
        s.object.pupil.update_radius = False
        s.update()
        return s
    s1 = xysystem(tro)
    s1[1].xy_coefficients = [0, 0, .25, 0, .4]
    s1.update()
    s2 = biconic(tro)
    p1, p2 = tro.ParaxialTrace(s1), tro.ParaxialTrace(s2)
    nptest.assert_allclose(p1.height, p2.height, rtol=0, atol=1e-12)
    m1 = TP.abcd_matrices(s1.table()).numpy()
    m2 = TP.abcd_matrices(s2.table()).numpy()
    nptest.assert_allclose(m1, m2, rtol=0, atol=1e-14)
    j1 = xysystem(jro)
    j1[1].xy_coefficients = [0, 0, .25, 0, .4]
    j1.update()
    nptest.assert_allclose(p1.height, jro.ParaxialTrace(j1).height,
                           rtol=0, atol=1e-12)


# -- steps and traces ---------------------------------------------------------

VARIANTS = ("as is", "rotated", "passthrough", "mirror")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", LENSES)
def test_surface_step_spec_matches_jax(name, variant):
    """kernels.surface_step_spec on each freeform row (as is, rotated
    and off axis, with mu = 1, and as a mirror) against the reference's,
    clipped and not, to 1e-12 with equal NaN masks."""
    jt, tt = tables(name)
    specs = TK.specialize(tt)
    rows = freeform_rows(specs) or [1]
    for j in rows:
        spec = specs[j]
        jr, tr = jax_row(jt, j), tt.row(j)
        kw = {}
        if variant == "rotated":
            th = .03
            kw = dict(rot=np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                                    [0, np.sin(th), np.cos(th)]]),
                      offset=np.asarray(jr.offset) + np.array([.1, -.2, 0.]))
            spec = spec._replace(rotated=True, off_axis=True)
        elif variant == "passthrough":
            kw = dict(mu=1.)
            spec = spec._replace(kind=0)
        elif variant == "mirror":
            kw = dict(mu=-1.)
            spec = spec._replace(kind=2)
        jr = jr._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
        tr = tr._replace(**{k: _t(v) for k, v in kw.items()})
        y0, u0 = lens_bundle(name, 64, j)
        y0[:, 2] = -2.
        state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
        jspec = JK.SurfaceSpec(**spec._asdict())
        for clip in (False, True):
            want = JK.surface_step_spec(state, jr, jspec, clip)
            got = TK.surface_step_spec(tuple(map(_t, state)), tr, spec, clip)
            for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
                _same(g, w, msg="%s row %d %s" % (name, j, variant))


@pytest.mark.parametrize("name", LENSES)
def test_generic_step_matches_jax(name):
    """The generic walk on every row, with and without biconic=True,
    against the reference's to 1e-12: a table with an xy_poly column
    gives every row the freeform Newton and normal."""
    jt, tt = tables(name)
    y0, u0 = lens_bundle(name, 64, 5)
    y0[:, 2] = -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    for biconic in (False, True):
        for j in range(1, tt.nsurfaces):
            want = JK.surface_step(state, jax_row(jt, j), True, biconic)
            got = TK.surface_step(tuple(map(_t, state)), tt.row(j), True,
                                  biconic)
            for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
                _same(g, w, msg="row %d biconic=%s" % (j, biconic))


@pytest.mark.parametrize("name", LENSES)
def test_traces_match_jax(name):
    """ops.geometric on one bundle: the specialized engine, clipped and
    not, against the reference's unrolled engine to 1e-12 with equal NaN
    masks, and trace_rays_final_fast on the CPU (the generic walk,
    biconic=True: a freeform table is anamorphic in the reference's
    sense) against the reference's generic walk."""
    jt, tt = tables(name)
    jspecs, specs = JK.specialize(jt), TK.specialize(tt)
    assert TK.specs_from_tuple(jspecs) == specs
    assert TT.is_anamorphic(tt) == JT.is_anamorphic(jt)
    y0, u0 = lens_bundle(name, 128, 7)
    for clip in (False, True):
        want = JG.trace_rays_final(jt, y0, u0, specs=jspecs, unroll=True,
                                   clip=clip)
        got = TG.trace_rays_final(tt, _t(y0), _t(u0), specs=specs,
                                  clip=clip)
        for g, w in zip(got, want):
            _same(g, w, msg="specs clip=%s" % clip)
    want = JG.trace_rays_final(jt, y0, u0, biconic=True)
    fast = TG.trace_rays_final_fast(tt, _t(y0), _t(u0))
    for g, w in zip(fast, want):
        _same(g, w, msg="fast")


def test_quadratic_freeform_equals_its_biconic_twin():
    """A quadratic freeform IS a biconic paraboloid: the specialized and
    generic traces of the two tables agree to 1e-13 (the reference's
    exactness oracle), in the port alone."""
    _, tf = tables("quadratic freeform")
    _, tb = tables("biconic paraboloid")
    y0, u0 = lens_bundle("quadratic freeform", 256, 1)
    ff = TG.trace_rays_final(tf, _t(y0), _t(u0), specs=TK.specialize(tf))
    bc = TG.trace_rays_final(tb, _t(y0), _t(u0), specs=TK.specialize(tb))
    gf = TG.trace_rays_final(tf, _t(y0), _t(u0), biconic=True)
    for a, b, c in zip(ff, bc, gf):
        nptest.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)
        nptest.assert_allclose(c.numpy(), b.numpy(), rtol=0, atol=1e-13)


def test_intercept_of_rays_whose_conic_seed_misses():
    """Tilted rays whose line misses the concave base's whole sphere:
    the conic seed is NaN, but the freeform figure (x^2 + y^2 terms that
    bend the surface out of the sphere's ball) is there to hit -- the
    freeform row restarts from the vertex plane and converges (no NaN
    mask after the Newton), an aspheric row without a freeform column
    stays NaN.  kernels.intercept and the host surfaces.intercept
    against the reference's, with equal NaN masks."""
    rng = np.random.RandomState(11)
    n = 64
    x = rng.uniform(8, 12, n)
    y = rng.uniform(-1, 1, n)
    z = np.full(n, -1.)
    u = np.zeros((n, 3))
    u[:, 0] = -.3 + rng.uniform(-.02, .02, n)
    u[:, 1] = rng.uniform(-.02, .02, n)
    u[:, 2] = 1.
    u /= np.linalg.norm(u, axis=1)[:, None]
    c, k = -.08, 0.
    asp = np.array([1e-6])
    xy = np.array([0., 0., .08, 0., .08])
    seed = np.asarray(JK.intercept_conic(x, y, z, *u.T, c, k, 0.))
    assert np.isnan(seed).sum() > n//4
    for xyp in (xy, None):
        want = np.asarray(JK.intercept(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
            *(jnp.asarray(v) for v in u.T), jnp.asarray(c), jnp.asarray(k),
            jnp.asarray(asp), jnp.asarray(0.),
            xy_poly=None if xyp is None else jnp.asarray(xyp)))
        got = TK.intercept(_t(x), _t(y), _t(z), *(_t(v) for v in u.T),
                           _t(c), _t(k), _t(asp), _t(0.),
                           xy_poly=None if xyp is None else _t(xyp))
        _same(got, want, msg=str(xyp is not None))
        if xyp is not None:
            assert np.isfinite(want[np.isnan(seed)]).any()
        yv = np.stack([x, y, z], -1)
        hw = np.asarray(JS.intercept(
            jnp.asarray(yv), jnp.asarray(u), c, k, jnp.asarray(asp),
            xy_poly=None if xyp is None else jnp.asarray(xyp)))
        hg = TS.intercept(_t(yv), _t(u), c, k, _t(asp),
                          xy_poly=None if xyp is None else _t(xyp))
        _same(hg, hw, msg="host %s" % (xyp is not None))


# -- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("name,engine", [("xy singlet", "specs"),
                                         ("figured schmidt", "specs"),
                                         ("aspheric base", "specs"),
                                         ("aspheric base", "generic")])
def test_spot_rms_gradients_match_jax_grad(name, engine):
    """parallel.grad.spot_rms's gradients in xy_poly, curvature and (the
    aspheric base) aspherics by autograd against jax.grad of the
    reference's, each within 1e-9 of its largest."""
    jt, tt = tables(name)
    y0, u0 = lens_bundle(name, 96, 3)
    fields = ("xy_poly", "curvature") + (
        ("aspherics",) if tt.aspherics.shape[-1] else ())
    if engine == "specs":
        jkw = dict(specs=JK.specialize(jt), unroll=True)
        tkw = dict(specs=TK.specialize(tt))
    else:
        jkw = tkw = dict(biconic=True)

    def jmerit(*vals):
        return JGR.spot_rms(jt.replace(**dict(zip(fields, vals))),
                            jnp.asarray(y0), jnp.asarray(u0), **jkw)
    jv = jmerit(*(getattr(jt, f) for f in fields))
    jg = jax.grad(jmerit, argnums=tuple(range(len(fields))))(
        *(jnp.asarray(getattr(jt, f)) for f in fields))
    leaves = [getattr(tt, f).clone().requires_grad_() for f in fields]
    tv = TGR.spot_rms(tt.replace(**dict(zip(fields, leaves))), _t(y0),
                      _t(u0), **tkw)
    tgr = torch.autograd.grad(tv, leaves)
    nptest.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
    for f, g, w in zip(fields, tgr, jg):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, f
        nptest.assert_allclose(g.numpy(), w, rtol=0,
                               atol=1e-9*np.abs(w).max(), err_msg=f)


def test_freeform_scales_match_jax():
    """freeform_scales on the Schmidt corrector equals the reference's:
    (5, 14), the plate's row R^-(i+j), ones elsewhere."""
    got = TGR.freeform_scales(schmidt(tro))
    want = JGR.freeform_scales(schmidt(jro))
    nptest.assert_array_equal(got, want)
    assert got.shape == (5, 14) and got[1, 2] == 25.**-2
    assert TGR.freeform_scales(xysystem(tro)).shape == (4, 5)


# -- aiming -------------------------------------------------------------------

@pytest.mark.parametrize("rim", [False, True])
def test_pupils_on_the_zernike_corrector_match_jax(rim):
    """ops.aiming.pupil_batched on the Zernike corrector (a small field
    angle; stop mode: the specialized trace through the freeform row;
    rim mode: the generic walk, every row with the freeform figure of
    the table's column) against the reference's batched solve to
    1e-10."""
    from rayopt_tpu.ops import aiming as JA
    from rayopt_tpu_torch.ops import aiming as TA

    def build(mod):
        s = zernike_corrector(mod)
        s.object.angle = .02
        s.update()
        return s
    js, ts = build(jro), build(tro)
    jt, tt = js.table(), ts.table()
    kw = dict(finite=False, projection=js.object.projection,
              slope=np.tan(js.object.angle), rim=rim)
    f = np.stack([np.zeros(3), [0., .5, 1.]], 1)
    jz, jb = JA.pupil_batched(jt, jnp.asarray(f), js.object.pupil.distance,
                              js.object.pupil.radius, js.stop,
                              specs=JK.specialize(jt), **kw)
    tz, tb = TA.pupil_batched(tt, _t(f), ts.object.pupil.distance,
                              ts.object.pupil.radius, ts.stop,
                              specs=TK.specialize(tt), **kw)
    nptest.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=1e-10)
    nptest.assert_allclose(tb.detach().numpy(), np.asarray(jb), rtol=1e-10,
                           atol=1e-10)
