"""Cross-engine fuzz of the extended vocabulary, the port against the JAX
package (its tests/test_fuzz.py::test_fuzz_extended_vocabulary_parity).

Random five-row systems mix symmetric, biconic, conic-cylinder, toroid,
odd-aspheric, grating and diffractive (DOE) rows from the reference's
seed and draw order; each goes through the port's three engines -- the
generic walk (trace_rays(biconic=True)), the specialized step
(trace_rays(specs=specialize(tab))) and the df32 plan (trace_df32_final
with the optical path) -- and each is held ray for ray against the JAX
package's engine of the same kind, with the reference's tolerances:
1e-10 (rtol and atol) on every traced component with equal NaN masks,
and for df32 equal NaN masks, 1e-9 mm on the image positions and 1e-10
relative on the optical path.  Four more trials put a grating or a DOE
on a cylinder (a y-cylinder made by a biconic or a toroid, an
x-cylinder) on one row of a reference-style draw, and four put an XY
freeform figure there (on a flat, a conic, an odd-aspheric base and on
a grating row), held the same way.  The port's engines are also held
against each other as the reference's are.  The JAX package's generic
walk is compiled once for each table shape (the freeform trials share
one XY width), its specialized step runs eagerly (jax.disable_jit: a
trial's compile would cost more than its trace).
"""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import jax
from rayopt_tpu.ops import df32 as JD
from rayopt_tpu.ops import geometric as JG
from rayopt_tpu.ops import kernels as JK
from rayopt_tpu.ops import tables as JT

from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import geometric as TG
from rayopt_tpu_torch.ops import kernels as TK
from rayopt_tpu_torch.ops import tables as TT

from test_torch_df32_newton import _cpu_default  # noqa: F401

TOL = 1e-10          # traced components (rtol and atol), the reference's
DF32_ATOL = 1e-9     # df32 image positions against float64, mm
PATH_RTOL = 1e-10    # df32 optical path against float64, relative


def _trial_inputs(rng):
    """One trial's make_table keywords and rays, in the reference's draw
    order (tests/test_fuzz.py)."""
    S = 5
    curv = rng.uniform(-.02, .02, S)
    curv[0] = 0.
    conic = np.where(rng.random(S) < .5, rng.uniform(-1., .5, S), 0.)
    cdx, kdx, tor, grat = (np.zeros(S) for _ in range(4))
    odd, doe = np.zeros((S, 2)), np.zeros((S, 2))
    for j in range(1, S - 1):
        kind = rng.integers(0, 7)
        if kind == 1:      # biconic
            cdx[j] = rng.uniform(-.01, .01)
            kdx[j] = rng.uniform(-.5, .5)
        elif kind == 2:    # toroid
            tor[j] = 1.
            cdx[j] = rng.uniform(-.01, .01)
            conic[j] = 0. if curv[j] == 0 else conic[j]
        elif kind == 3:    # grating on the base figure
            grat[j] = rng.uniform(-.2, .2)
        elif kind == 4 and curv[j] != 0.:
            cdx[j] = -curv[j]  # pure y-cylinder (cyl_axis path)
            kdx[j] = -conic[j]
        elif kind == 5:    # odd-aspheric figure
            odd[j] = rng.uniform(-1e-5, 1e-5, 2)
        elif kind == 6:    # radial diffractive kick
            doe[j] = (rng.uniform(-3e-3, 3e-3), rng.uniform(-1e-5, 1e-5))
    mu = np.ones(S)
    mu[1:-1] = rng.uniform(.6, .9, S - 2)
    kw = dict(curvature=curv, conic=conic, distance=np.full(S, 8.), mu=mu,
              n_before=np.ones(S), n_after=np.ones(S), curvature_dx=cdx,
              conic_dx=kdx, toroidal=tor, grating_dy=grat,
              aspherics_odd=odd, doe=doe)
    y0 = np.zeros((16, 3))
    y0[:, :2] = rng.uniform(-2, 2, (16, 2))
    u0 = np.tile([0., 0., 1.], (16, 1))
    u0[:, :2] = rng.uniform(-.05, .05, (16, 2))
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    return kw, y0, u0


#: the phase cylinders a cylinder trial puts on one of its rows: a
#: grating on a biconic-made y-cylinder, a DOE on a toroid-made
#: y-cylinder, a grating on an x-cylinder, a grating and a DOE on a
#: biconic-made y-cylinder
CYLINDER_KINDS = ("grating biconic y", "doe toroid y", "grating x",
                  "both biconic y")


def _phase_cylinder(kw, rng, j, kind):
    """Make row j of a trial's keywords the phase cylinder `kind` (its
    curvature, conic and mu kept, its other figure cleared)."""
    c = kw["curvature"][j] or rng.uniform(.01, .02)
    for f in ("curvature_dx", "conic_dx", "toroidal", "grating_dy"):
        kw[f][j] = 0.
    kw["aspherics_odd"][j] = kw["doe"][j] = 0.
    if kind == "grating x":
        kw["curvature"][j] = kw["conic"][j] = 0.
        kw["curvature_dx"][j] = c
        kw["conic_dx"][j] = rng.uniform(-.5, .5)
    else:
        kw["curvature"][j] = c
        kw["curvature_dx"][j] = -c
        if kind == "doe toroid y":
            kw["toroidal"][j] = 1.
        else:
            kw["conic_dx"][j] = rng.uniform(-.5, .5)
    if kind != "doe toroid y":
        kw["grating_dy"][j] = rng.uniform(-.2, .2)
    if kind in ("doe toroid y", "both biconic y"):
        kw["doe"][j] = (rng.uniform(-3e-3, 3e-3), rng.uniform(-1e-5, 1e-5))


#: the freeform rows a freeform trial puts on one of its rows: a
#: degree-2 figure on a flat base, a degree-4 one on a conic base (some
#: terms zero), a degree-3 one on a grating row, a degree-4 one on an
#: odd-aspheric base; the trials share the degree-4 width (14 terms)
FREEFORM_KINDS = ("quadratic flat", "quartic conic", "cubic grating",
                  "quartic odd")


def _freeform_row(kw, rng, j, kind):
    """Make row j of a trial's keywords the freeform row `kind` (its mu
    kept, its anamorphic figure and its DOE cleared: a freeform figure
    on an anamorphic base is refused): an xy_poly column of 14 terms,
    zero but on row j, each term of degree d within +-1e-3 / 2^(d - 2)
    (a few micrometres of sag at the trial's 2-4 mm heights)."""
    for f in ("curvature_dx", "conic_dx", "toroidal", "grating_dy"):
        kw[f][j] = 0.
    kw["aspherics_odd"][j] = kw["doe"][j] = 0.
    deg = {"quadratic flat": 2, "cubic grating": 3}.get(kind, 4)
    if kind == "quadratic flat":
        kw["curvature"][j] = kw["conic"][j] = 0.
    elif kind == "quartic conic":
        kw["curvature"][j] = kw["curvature"][j] or rng.uniform(.01, .02)
        kw["conic"][j] = rng.uniform(-1., .5)
    elif kind == "cubic grating":
        kw["grating_dy"][j] = rng.uniform(-.2, .2)
    else:
        kw["aspherics_odd"][j] = rng.uniform(-1e-5, 1e-5, 2)
    xy = np.zeros((len(kw["curvature"]), 14))
    for t, (i, k) in enumerate(JK._xy_terms(4)):
        if i + k <= deg and rng.random() < .75:
            xy[j, t] = rng.uniform(-1e-3, 1e-3)/2.**(i + k - 2)
    kw["xy_poly"] = xy


def _trials():
    """The reference's 8 trials (its seed 21, its draws), one trial a
    kind of CYLINDER_KINDS (seed 23: a reference-style draw, then one
    row made that phase cylinder) and one a kind of FREEFORM_KINDS (seed
    25, the same way)."""
    rng = np.random.default_rng(21)
    out = {("reference", i): _trial_inputs(rng) for i in range(8)}
    rng = np.random.default_rng(23)
    for i, kind in enumerate(CYLINDER_KINDS):
        kw, y0, u0 = _trial_inputs(rng)
        _phase_cylinder(kw, rng, 1 + i % 3, kind)
        out[("cylinder", kind)] = kw, y0, u0
    rng = np.random.default_rng(25)
    for i, kind in enumerate(FREEFORM_KINDS):
        kw, y0, u0 = _trial_inputs(rng)
        _freeform_row(kw, rng, 1 + i % 3, kind)
        out[("freeform", kind)] = kw, y0, u0
    return out


TRIALS = _trials()
#: the JAX package's generic walk, compiled once for the trials' shape
_jax_generic = jax.jit(lambda tab, y, u: JG.trace_rays(tab, y, u,
                                                        biconic=True))


def _same(got, want, what):
    """Equal NaN masks and TOL (rtol and atol) where both are finite."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    both = np.isfinite(got) & np.isfinite(want)
    nptest.assert_allclose(got[both], want[both], rtol=TOL, atol=TOL,
                           err_msg=what)
    nptest.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)


@pytest.mark.parametrize("key", sorted(TRIALS))
def test_fuzz_extended_vocabulary_parity(key):
    """One trial: the port's generic walk, specialized step and df32
    plan each against the JAX package's engine of the same kind (the
    generic and specialized traces component by component at every
    surface, the df32 final state and path word by word), and the
    port's engines against each other with the reference's tolerances
    (1e-10 and equal NaN masks between the walks; the df32 NaN mask, its
    image positions within 1e-9 mm and its path within 1e-10 relative
    of the float64 final trace)."""
    kw, y0, u0 = TRIALS[key]
    jtab = JT.make_table(**kw)
    ttab = TT.table_from_numpy(jtab)
    assert TT.is_anamorphic(ttab) or not any(
        np.any(kw[f]) for f in ("curvature_dx", "toroidal", "grating_dy",
                                "doe"))
    jspecs = JK.specialize(jtab)
    specs = TK.specialize(ttab)
    assert TK.specs_from_tuple(jspecs) == specs
    if key[0] == "cylinder":
        assert any(sp.cyl_axis and TK.is_phase(sp) for sp in specs)
    if key[0] == "freeform":
        assert sum(sp.freeform for sp in specs) == 1
        assert sum(st["anam"] is not None and st["anam"]["mode"]
                   == "freeform" for st in D.plan(ttab)) == 1
    yt, ut = torch.from_numpy(y0), torch.from_numpy(u0)
    a = TG.trace_rays(ttab, yt, ut, biconic=True)
    b = TG.trace_rays(ttab, yt, ut, specs=specs)
    ja = _jax_generic(jtab, y0, u0)
    with jax.disable_jit():
        jb = JG.trace_rays(jtab, y0, u0, specs=jspecs, unroll=True)
    for name, got, want in (("generic", a, ja), ("specialized", b, jb),
                            ("walks", b, a)):
        for c, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "%s %s output %d" % (key, name, c))
    # the df32 engine: the JAX package's words, and the float64 trace's
    # values
    jout, jt = JD.trace_df32_final(JD.plan(jtab), JD.state_from_f64(y0, u0),
                                   with_path=True)
    out, tacc = D.trace_df32_final(D.plan(ttab), D.state_from_f64(yt, ut),
                                   with_path=True)
    for c, (g, w) in enumerate(zip((*out, tacc), (*jout, jt))):
        for h in range(2):
            gh, wh = g[h].numpy(), np.asarray(w[h])
            nptest.assert_array_equal(np.isnan(gh), np.isnan(wh))
            live = ~np.isnan(wh)
            nptest.assert_array_equal(gh[live], wh[live],
                                      err_msg="%s df32 %d" % (key, c))
    yf, _, tf = TG.trace_rays_final(ttab, yt, ut, biconic=True)
    yf, tf = yf.numpy(), tf.numpy()
    good = np.isfinite(yf[:, 0])
    xd = D.to_f64(out[0]).numpy()
    nptest.assert_array_equal(np.isnan(xd), ~good)
    for c in range(2):
        nptest.assert_allclose(D.to_f64(out[c]).numpy()[good],
                               yf[good, c], atol=DF32_ATOL,
                               err_msg="%s df32 y%d" % (key, c))
    nptest.assert_allclose(D.to_f64(tacc).numpy()[good], tf[good],
                           rtol=PATH_RTOL, err_msg="%s df32 path" % (key,))


def test_cylinder_trials_cover_every_kind():
    """The cylinder trials put a grating on a biconic-made y-cylinder, a
    DOE on a toroid-made y-cylinder, a grating on an x-cylinder and both
    on a biconic-made y-cylinder, each specialized so (cyl_axis, the
    origin's flag, the phase flags)."""
    kinds = set()
    for (group, _), (kw, _, _) in TRIALS.items():
        if group != "cylinder":
            continue
        for sp in TK.specialize(TT.table_from_numpy(JT.make_table(**kw))):
            if sp.cyl_axis and TK.is_phase(sp):
                kinds.add((sp.cyl_axis, bool(sp.toroidal), bool(sp.grating),
                           bool(sp.doe)))
    assert kinds == {(1, False, True, False), (1, True, False, True),
                     (2, False, True, False), (1, False, True, True)}


def test_freeform_trials_cover_every_kind():
    """The freeform trials put a degree-2 figure on a flat base, a
    degree-4 one on a conic base, a degree-3 one on a grating row and a
    degree-4 one on an odd-aspheric base, each specialized and planned
    so (the freeform row's base and phase flags, the top degree of its
    df32 plan's value terms)."""
    kinds = {}
    for (group, kind), (kw, _, _) in TRIALS.items():
        if group != "freeform":
            continue
        ttab = TT.table_from_numpy(JT.make_table(**kw))
        sp = [s for s in TK.specialize(ttab) if s.freeform][0]
        an = [st["anam"] for st in D.plan(ttab) if st["anam"] is not None
              and st["anam"]["mode"] == "freeform"][0]
        kinds[kind] = (max(i + j for _, i, j in an["xy"]), sp.flat,
                       not (sp.flat or sp.spherical), sp.grating, sp.odd)
    deg, flat, conic, grating, odd = zip(*(kinds[k] for k in FREEFORM_KINDS))
    assert deg == (2, 4, 3, 4)
    assert flat[0] and conic[1] and grating[2] and odd[3]
