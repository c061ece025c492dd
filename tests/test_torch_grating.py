"""rayopt_tpu_torch's grating and DOE rows (a linear grating and a radial
diffractive phase on any substrate, by the generalized Spencer & Murty
solve) against the JAX package, in float64 on the CPU: the row math
(doe_kick, refract_grating), the Grating and DiffractiveSurface
elements and their YAML round trip, the tables and specs of the
concave-grating spectrograph and the hybrid achromat
(models.spectrograph, models.hybrid_achromat) and of four lenses of the
reference's own tests (the curved-substrate hybrid with a two-term
phase, the concave mirror grating, the refractive grating on an R = 80
BK7 substrate, the reflective zone plate), the specialized and generic
steps and traces, the paraxial focal lengths, the spectrograph's line
positions, spot-RMS gradients in grating_dy, doe and curvature against
jax.grad, stop-mode device aiming on the hybrid, and the reference's
per-wavelength chroma override (mu, n_before, n_after only) that the
port keeps.  Traces agree to 1e-12 relative with identical NaN masks.
The kernel side (K5's hand reverse, the keys, the refusals,
optimize_grad) is tests/test_torch_spec_grating.py."""

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
from rayopt_tpu.parallel import grad as JGR

import rayopt_tpu_torch as tro
from rayopt_tpu_torch import models as tmodels
from rayopt_tpu_torch.formats import system_from_yaml, system_to_yaml
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.parallel import grad as TGR

from test_torch_anamorphic import (_cpu_default, _one_thread,  # noqa: F401
                                   _same, _t, bundle, jax_row)

F64 = torch.float64
LAM0 = 550e-9
F0 = 100.
A1 = -np.pi/((LAM0/1e-3)*F0)   # phi = A1 rho^2: f = F0 at LAM0, R = 1


# -- the lenses --------------------------------------------------------------

def curved_hybrid(mod):
    """The reference's test_doe.py hybrid: a two-term kinoform on an
    R = 120 N-BK7 face, an R = -150 back face."""
    s = mod.System([
        dict(material="air"),
        dict(type="binary2", roc=120., phase_coefficients=[A1, 1e-4],
             norm_radius=1., distance=5., material="glass/N-BK7",
             radius=10.),
        dict(roc=-150., distance=3., material="air", radius=10.),
        dict(distance=60., radius=10.),
    ], wavelengths=[LAM0])
    s.update()
    return s


def _grating_lens(mod, rows):
    s = mod.System(rows, wavelengths=[500e-9])
    s.object.pupil.radius = 5.
    s.object.pupil.update_radius = False
    s.update()
    return s


def mirror_grating(mod):
    """The reference's _grating_system(curvature=-.001, mirror=True): a
    600 lp/mm reflection grating on a weak concave mirror."""
    return _grating_lens(mod, [
        dict(material="air"),
        dict(type="grating", grating_frequency=600., grating_order=1,
             distance=20., material="mirror", radius=30.,
             curvature=-.001),
        dict(distance=-50., radius=100.)])


def bk7_grating(mod):
    """The reference's refractive grating on an R = 80 N-BK7
    substrate."""
    return _grating_lens(mod, [
        dict(material="air"),
        dict(type="grating", grating_frequency=600., roc=80., distance=20.,
             material="SCHOTT-BK|N-BK7", radius=30.),
        dict(distance=5., material="air", radius=30.),
        dict(distance=50., radius=100.)])


def zone_plate(mod):
    """The reference's reflective zone plate: a flat mirror with a
    zone-plate phase of focal F0."""
    s = mod.System([
        dict(material="vacuum"),
        dict(type="binary2", phase_coefficients=[A1], norm_radius=1.,
             distance=50., material="mirror", radius=20.),
        dict(distance=-F0, radius=20.),
    ], wavelengths=[LAM0], object=dict(
        angle_deg=.2, pupil=dict(radius=5., update_radius=False)))
    s.update()
    return s


LENSES = {
    "hybrid_achromat": lambda mod: (jmodels if mod is jro else tmodels)
    .hybrid_achromat(),
    "spectrograph": lambda mod: (jmodels if mod is jro else tmodels)
    .spectrograph(),
    "curved hybrid": curved_hybrid, "mirror grating": mirror_grating,
    "bk7 grating": bk7_grating, "zone plate": zone_plate}
#: each lens's phase rows and their kind (test_tables_and_specs)
PHASE_ROWS = {"hybrid_achromat": {2: "doe"}, "spectrograph": {1: "grating"},
              "curved hybrid": {1: "doe"}, "mirror grating": {1: "grating"},
              "bk7 grating": {1: "grating"}, "zone plate": {1: "doe"}}


def lens(name):
    """(JAX system, port system) of one lens of LENSES."""
    return LENSES[name](jro), LENSES[name](tro)


# -- the row math ------------------------------------------------------------

def _row_inputs(n, seed):
    rng = np.random.RandomState(seed)
    x, y = rng.uniform(-6, 6, (2, n))
    u = rng.normal(size=(n, 3))
    u[:, 2] = np.abs(u[:, 2]) + 1.
    u /= np.linalg.norm(u, axis=1)[:, None]
    gx, gy = rng.uniform(-.3, .3, (2, n))
    return x, y, u, gx, gy


@pytest.mark.parametrize("mu", [1/1.5, 1.5, -1., 1.])
def test_row_math_matches_jax(mu):
    """doe_kick and refract_grating elementwise (a grating term, a
    two-term kick, both, neither: transmission, a mirror, the passthrough
    mu == 1) against the reference's to 1e-13 relative with equal NaN
    masks (the large grating term leaves evanescent rays)."""
    x, y, u, gx, gy = _row_inputs(200, 3)
    doe = np.array([-2e-3, 1e-6])
    jk = JK.doe_kick(x, y, jnp.asarray(doe))
    tk = TK.doe_kick(_t(x), _t(y), _t(doe))
    for g, w in zip(tk, jk):
        _same(g, w, rtol=1e-13, atol=0)
    for gdy, d in ((.4, None), (0., doe), (.9, doe), (0., None)):
        want = JK.refract_grating(x, y, *u.T, mu, gdy, gx, gy,
                                  doe=None if d is None else jnp.asarray(d))
        got = TK.refract_grating(_t(x), _t(y), *map(_t, u.T), _t(mu),
                                 _t(gdy), _t(gx), _t(gy),
                                 doe=None if d is None else _t(d))
        for g, w in zip(got, want):
            _same(g, w, rtol=1e-13, atol=1e-15, msg="gdy %g" % gdy)
        if gdy == .9:
            assert np.isnan(np.asarray(want[0])).any()


def test_a_passthrough_grating_still_diffracts():
    """A grating row with mu == 1 (a grating in air) diffracts, and a
    DOE row kicks an on-axis ray's neighbours while the on-axis ray
    itself takes the solve: the row, not the ray, decides the
    passthrough."""
    z = _t(np.zeros(3))
    u = (z, z, _t(np.ones(3)))
    one = _t(1.)
    ox, oy, oz = TK.refract_grating(z, z, *u, one, _t(.3), z, z)
    nptest.assert_allclose(oy.numpy(), .3)
    nptest.assert_allclose((ox*ox + oy*oy + oz*oz).numpy(), 1.)
    x = _t([0., 1., 2.])
    ox, oy, oz = TK.refract_grating(x, z, *u, one, 0., z, z,
                                    doe=_t([-1e-3]))
    nptest.assert_allclose(ox.numpy(), [0., -2e-3, -4e-3], atol=1e-16)


# -- elements, tables, specs -------------------------------------------------

def test_element_types_and_yaml_round_trip():
    """Grating and DiffractiveSurface register as "grating" and
    "binary2", serialize their own keys, reverse (the grating's
    frequency flips) and rescale as the JAX package's elements; the YAML
    round trip keeps the tables; refract raises as in the reference;
    Grating.efficiency equals the reference's blaze model."""
    for name, kind in (("spectrograph", tro.Grating),
                       ("hybrid_achromat", tro.DiffractiveSurface)):
        js, ts = lens(name)
        j = next(iter(PHASE_ROWS[name]))
        assert isinstance(ts[j], kind)
        assert ts[j].dict() == js[j].dict()
        s2 = system_from_yaml(system_to_yaml(ts))
        s2.update()
        for f in ("grating_dy", "doe", "curvature", "mu"):
            nptest.assert_array_equal(getattr(s2.table(), f).numpy(),
                                      getattr(ts.table(), f).numpy())
        for e in (js[j], ts[j]):
            e.reverse()
            e.rescale(2.)
        assert ts[j].dict() == js[j].dict()
        with pytest.raises(NotImplementedError):
            ts[j].refract(np.zeros((1, 3)), np.array([[0., 0., 1.]]), 1.)
    g = tro.Grating(grating_frequency=600., grating_order=2, blaze_deg=17.)
    jg = jro.Grating(grating_frequency=600., grating_order=2, blaze_deg=17.)
    lam = np.linspace(400e-9, 800e-9, 9)
    nptest.assert_allclose(g.efficiency(lam), jg.efficiency(lam),
                           rtol=1e-15)
    from rayopt_tpu import gratings as JGT
    from rayopt_tpu_torch import gratings as TGT
    nptest.assert_allclose(TGT.order_weights(g, lam, [0, 1, 2]),
                           JGT.order_weights(jg, lam, [0, 1, 2]))


@pytest.mark.parametrize("name", sorted(LENSES))
def test_tables_and_specs_match_jax(name):
    """System.table fills grating_dy and doe as the reference's (every
    field equal, at each wavelength), and specialize gives equal specs
    with the grating or DOE flag on the phase rows."""
    js, ts = lens(name)
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
    assert {j: ("grating" if sp.grating else "doe")
            for j, sp in enumerate(specs) if TK.is_phase(sp)} \
        == PHASE_ROWS[name]


# -- steps and traces --------------------------------------------------------

VARIANTS = ("as is", "rotated", "passthrough")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(LENSES))
def test_surface_step_spec_matches_jax(name, variant):
    """kernels.surface_step_spec on each phase row (as is, rotated and
    off axis, and with mu = 1: a grating or DOE in air still diffracts)
    against the reference's, clipped and not, to 1e-12 with equal NaN
    masks, the optical path (the DOE's phase term) included."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    for j in PHASE_ROWS[name]:
        spec = TK.specialize(tt)[j]
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
        jr = jr._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
        tr = tr._replace(**{k: _t(v) for k, v in kw.items()})
        y0, u0 = bundle(64, j, 6., .05)
        y0[:, 2] = -2.
        state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
        jspec = JK.SurfaceSpec(**spec._asdict())
        for clip in (False, True):
            want = JK.surface_step_spec(state, jr, jspec, clip)
            got = TK.surface_step_spec(tuple(map(_t, state)), tr, spec, clip)
            for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
                _same(g, w, msg="%s row %d %s" % (name, j, variant))


@pytest.mark.parametrize("name", sorted(LENSES))
def test_generic_step_matches_jax(name):
    """The generic walk's anamorphic step (surface_step(biconic=True):
    the grating/phase solve with the DOE's path term) on every row
    against the reference's, to 1e-12."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    y0, u0 = bundle(64, 5, 5., .03)
    y0[:, 2] = -2.
    state = tuple(np.ascontiguousarray(c) for c in (*y0.T, *u0.T))
    for j in range(1, tt.nsurfaces):
        want = JK.surface_step(state, jax_row(jt, j), True, True)
        got = TK.surface_step(tuple(map(_t, state)), tt.row(j), True, True)
        for g, w in zip((*got[0], got[1][3]), (*want[0], want[1][3])):
            _same(g, w, msg="row %d" % j)


@pytest.mark.parametrize("name", sorted(LENSES))
def test_traces_match_jax(name):
    """ops.geometric at each wavelength's own table on one bundle aimed by
    the host at fields 0, 0.7 and 1: the specialized engine, clipped,
    against the reference's to 1e-12 with equal NaN masks, and
    trace_rays_final_fast on the CPU (the generic walk, biconic=True:
    the table is anamorphic in the reference's sense) against the
    reference's generic walk."""
    js, ts = lens(name)
    rng = np.random.RandomState(7)
    for lam in js.wavelengths:
        jt, tt = js.table(lam), ts.table(lam)
        jspecs, specs = JK.specialize(jt), TK.specialize(tt)
        assert TK.specs_from_tuple(jspecs) == specs
        rays = []
        for field in (0., .7, 1.):
            z, p = ts.pupil((0., field), l=lam)
            yp = rng.uniform(-1.1, 1.1, (32, 2))
            rays.append(ts.aim((0., field), yp, z, p, filter=False))
        y0, u0 = (np.concatenate(r) for r in zip(*rays))
        want = JG.trace_rays_final(jt, y0, u0, specs=jspecs, unroll=True,
                                   clip=True)
        got = TG.trace_rays_final(tt, _t(y0), _t(u0), specs=specs, clip=True)
        for g, w in zip(got, want):
            _same(g, w, msg="specs %g" % lam)
        want = JG.trace_rays_final(jt, y0, u0, biconic=True)
        fast = TG.trace_rays_final_fast(tt, _t(y0), _t(u0))
        for g, w in zip(fast, want):
            _same(g, w, msg="fast %g" % lam)


def test_spectrograph_line_positions():
    """The spectrograph's detector line positions through the port's
    System.trace_table at each wavelength: the JAX package's call to
    1e-9 and its golden (tests/test_goldens.py) to 1e-9."""
    js, ts = lens("spectrograph")
    golden = [-56.06593593485528, -69.89487421806105, -84.67998616743552]
    y, u = np.zeros((1, 3)), np.array([[0., 0., 1.]])
    for lam, want in zip(ts.wavelengths, golden):
        got = ts.trace_table(y, u, lam)[0][-1, 0, 1]
        nptest.assert_allclose(got, js.trace_table(y, u, lam)[0][-1, 0, 1],
                               rtol=1e-9)
        nptest.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("name", ["hybrid_achromat", "zone plate"])
def test_paraxial_focal_length_matches_jax(name):
    """The DOE's paraxial power (DiffractiveSurface.paraxial_matrix, the
    System's _scale) gives the reference's focal lengths to 1e-9: the
    hybrid's at each wavelength, the zone plate's |f| = F0."""
    js, ts = lens(name)
    nptest.assert_allclose(ts.paraxial.focal_length,
                           js.paraxial.focal_length, rtol=1e-9)
    if name == "zone plate":
        nptest.assert_allclose(np.abs(ts.paraxial.focal_length), F0,
                               rtol=1e-6)
    for lam in js.wavelengths:
        jm, tm = (s[2].paraxial_matrix(1.5, lam)[1] for s in (js, ts)) \
            if name == "hybrid_achromat" else \
            (s[1].paraxial_matrix(1., lam)[1] for s in (js, ts))
        nptest.assert_allclose(tm, jm, rtol=1e-12)


# -- gradients, aiming, the kept chroma override ------------------------------

FIELDS = ("grating_dy", "doe", "curvature")


@pytest.mark.parametrize("name,engine", [("bk7 grating", "specs"),
                                         ("curved hybrid", "specs"),
                                         ("spectrograph", "generic")])
def test_spot_rms_gradients_match_jax_grad(name, engine):
    """The spot RMS differentiated with respect to grating_dy, doe and
    curvature by autograd through the specialized engine (a refractive
    grating, a two-term DOE) or the generic walk (biconic=True: the
    mirror grating), against jax.grad of the reference's spot_rms with
    the same engine, to 1e-9 of each field's largest."""
    js, ts = lens(name)
    jt, tt = js.table(), ts.table()
    if engine == "specs":
        kw = dict(specs=JK.specialize(jt), unroll=True)
        tkw = dict(specs=TK.specialize(tt))
    else:
        kw = tkw = dict(biconic=True)
    y0, u0 = bundle(128, 13, 3., .005)
    w = np.full(128, 1/128)

    def jloss(*vals):
        return JGR.spot_rms(jt.replace(**dict(zip(FIELDS, vals))), y0, u0, w,
                            **kw)
    jvals = [jnp.asarray(getattr(jt, f)) for f in FIELDS]
    want = jax.grad(jloss, argnums=tuple(range(len(FIELDS))))(*jvals)
    leaves = {f: getattr(tt, f).clone().requires_grad_() for f in FIELDS}
    v = TGR.spot_rms(tt.replace(**leaves), _t(y0), _t(u0), _t(w), **tkw)
    nptest.assert_allclose(float(v.detach()), float(jloss(*jvals)),
                           rtol=1e-12)
    v.backward()
    for f, g in zip(FIELDS, want):
        g = np.asarray(g)
        got = (leaves[f].grad if leaves[f].grad is not None
               else torch.zeros_like(leaves[f])).numpy()
        assert got.shape == g.shape, f
        if g.size:
            nptest.assert_allclose(got, g, rtol=0, atol=1e-9*max(
                np.abs(g).max(), 1e-300), err_msg=f)


def test_device_aiming_on_the_hybrid_matches_the_reference():
    """System.pupils on the aimed hybrid achromat (stop mode: the
    specialized trace through the DOE row) against the host pupil at tol
    1e-12 to 1e-9, and ops.aiming.pupil_batched against the reference's
    batched stop-mode solve to 1e-10."""
    from rayopt_tpu.ops import aiming as JA
    from rayopt_tpu_torch.ops import aiming as TA

    def aimed(models):
        s = models.hybrid_achromat()
        s.object.pupil.aim = True
        s.update()
        return s
    js, ts = aimed(jmodels), aimed(tmodels)
    fields = [(0., f) for f in (0., .7, 1.)]
    z, boxes = ts.pupils(fields)
    host = [aimed(tmodels).pupil(f, tol=1e-12) for f in fields]
    nptest.assert_allclose(z, [h[0] for h in host], rtol=1e-9)
    nptest.assert_allclose(boxes, [h[1] for h in host], rtol=1e-9)
    jt, tt = js.table(), ts.table()
    kw = dict(finite=False, projection=js.object.projection,
              slope=np.tan(js.object.angle))
    f = np.stack([np.zeros(3), [0., .7, 1.]], 1)
    jz, jb = JA.pupil_batched(jt, jnp.asarray(f), js.object.pupil.distance,
                              js.object.pupil.radius, js.stop,
                              specs=JK.specialize(jt), **kw)
    tz, tb = TA.pupil_batched(tt, _t(f), ts.object.pupil.distance,
                              ts.object.pupil.radius, ts.stop,
                              specs=TK.specialize(tt), **kw)
    nptest.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-10)
    nptest.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10,
                           atol=1e-10)


def test_rim_aiming_sees_the_doe():
    """Rim-mode (stop=-1) System.pupils traces the DOE row (the
    reference's test_rim_aiming_sees_extended_vocabulary): the kinoform's
    kick moves the vignetting-limited pupil box against the bare
    substrate's.  The pupil distance equals the host pupil's (tol 1e-12;
    the JAX package's host pupil gives the same) to 1e-8 and the box to
    1e-3 (the host's bisection); the JAX package's own batched solve
    returns the bare substrate's distance here (ROADMAP Queue 3)."""
    lam = 550e-9
    a1 = -np.pi/((lam/1e-3)*60.)

    def build(mod, pc):
        s = mod.System([
            dict(material="air"),
            dict(roc=80., distance=5., material="glass/N-BK7", radius=9.),
            dict(type="binary2", distance=3., material="air", radius=9.,
                 phase_coefficients=pc, norm_radius=1.),
            dict(distance=30., radius=4.),
            dict(distance=30., radius=12.),
        ], wavelengths=[lam], object=dict(
            angle_deg=2., pupil=dict(radius=6., aim=True)), stop=3)
        s.update()
        return s
    z, box = build(tro, [a1]).pupils([(0., 1.)], stop=-1)
    hz, hbox = build(tro, [a1]).pupil((0., 1.), stop=-1, tol=1e-12)
    nptest.assert_allclose(z[0], hz, rtol=1e-8)
    nptest.assert_allclose(box[0], hbox, rtol=0, atol=1e-3)
    _, bare = build(tro, []).pupils([(0., 1.)], stop=-1)
    assert np.abs(np.asarray(box) - np.asarray(bare)).max() > .2


def test_chroma_override_is_kept_as_the_reference_has_it():
    """bundles_from_system's chroma overrides only mu, n_before and
    n_after, as the reference's: the DOE's kick stays at the table's
    wavelength for every bundle.  Both packages give the same merit on
    a two-wavelength bundle list of the hybrid achromat (1e-12), and
    that merit differs from the one of each wavelength's own table."""
    js, ts = lens("hybrid_achromat")
    lams = js.wavelengths[:2]
    jb = JGR.bundles_from_system(js, fields=(0., 1.), wavelengths=lams,
                                 nrays=16)
    assert all(set(b[3]) == {"mu", "n_before", "n_after", "wavelength"}
               for b in jb)
    tb = TGR.bundles_from_system(ts, fields=(0., 1.), wavelengths=lams,
                                 nrays=16)
    assert all(set(b[3]) == {"mu", "n_before", "n_after", "wavelength"}
               for b in tb)
    want = float(JGR.trace_rms_merit(js.table(), jb, biconic=True))
    got = float(TGR.trace_rms_merit(ts.table(), tb, biconic=True))
    nptest.assert_allclose(got, want, rtol=1e-12)
    own = sum(float(TGR.spot_rms(ts.table(b[3]["wavelength"]), *b[:3],
                                 biconic=True)) for b in tb)
    assert abs(own - got) > 1e-9*got
