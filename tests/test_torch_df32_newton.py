"""The df32 parity engine's Newton rows -- aspheric rows (the df32
polish from the conic root) and anamorphic rows (conic cylinders in
closed form, biconics and toroids by the float32-seeded, df32-polished
Newton), figured or not -- against the JAX package's eager df32, on
the CPU.

The port's plain versions (ops.df32: `plan`, the trace, the merit and
their multi-plan twins) must give the JAX package's hi and lo words
exactly, NaN masks included, and its moments within MERIT_REL; the
image positions stay within F64_ATOL of the port's own float64 trace.
The kernels K10-K13 run only on a CUDA card (tests/test_torch_cuda.py);
here a model of the kernel's packed-plan decoding (the row kinds, the
coefficient counts and the words a step that follow from its flags) is
held against the plain trace.  Each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import rayopt_tpu as ro
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import df32 as JD

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.geometric import trace_rays_final

F64_ATOL = 1e-10     # df32 positions against the float64 trace, mm
MERIT_REL = 1e-13    # df32 moments against the JAX package's


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    set_default_device(old)


# -- the lenses (JAX systems) -------------------------------------------------

def _aspheric_double_gauss():
    """Conics on rows 2 and 5, an even asphere on row 7 (the JAX
    package's tests/test_df32.py)."""
    s = jmodels.double_gauss()
    s[2].conic = -.7
    s[5].conic = .4
    s[7].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    return s


def _odd_singlet():
    """An even and odd figure on a conic front, the odd figure with an
    r^1 term (its vertex cusp): the JAX package's
    tests/test_odd_aspherics.py singlet with A1 = 1e-4."""
    s = ro.System(description="odd-asphere singlet")
    s.append(ro.Spheroid(material=ro.air, radius=8.))
    s.append(ro.Spheroid(distance=10., curvature=1/40., conic=-.5,
                         aspherics=[0., 1e-6],
                         aspherics_odd=[1e-4, 2e-4, -3e-7],
                         material="schott-sk|n-sk16", radius=8.))
    s.append(ro.Spheroid(distance=4., curvature=-1/80., material=ro.air,
                         radius=8.))
    s.append(ro.Spheroid(distance=60., material=None, radius=8.))
    s.wavelengths = [587.56e-9]
    s.update()
    return s


def _cyl_system(cx=0.):
    """The JAX package's tests/test_anamorphic.py biconic pair."""
    s = ro.System([
        dict(material="air"),
        dict(type="biconic", roc=25.84, curvature_x=cx, distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="biconic", distance=3., material="air", radius=10.),
        dict(distance=47., radius=10.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    return s


def _conic_cylinders():
    """models.anamorphic_pair with conics: a y-cylinder of conic -0.5
    and an x-cylinder of conic 0.3 (|N| not one)."""
    s = jmodels.anamorphic_pair()
    s[1].conic = -.5
    s[3].conic_x = .3
    s.update()
    return s


def _split_biconic():
    s = _cyl_system(cx=.013)
    s[1].conic = -.4
    s[1].conic_x = .25
    s.update()
    return s


def _toroid_lens():
    s = ro.System([
        dict(material="air"),
        dict(type="toroid", roc=51.68, roc_rotation=200., distance=5.,
             material="SCHOTT-BK|N-BK7", radius=10.),
        dict(type="toroid", distance=3., material="air", radius=10.),
        dict(distance=95., radius=20.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    return s


def _flat_figured_singlet():
    """A singlet whose flat back carries an even figure: the flat
    intercept polished, and the generic normal."""
    s = ro.System([
        dict(material="air"),
        dict(roc=40., distance=5., material="SCHOTT-BK|N-BK7", radius=8.),
        dict(distance=4., material="air", radius=8.,
             aspherics=[1e-5, -2e-8]),
        dict(distance=50., radius=10.)])
    s.update()
    return s


def _anamorphic_mirror(kind):
    """A concave toroidal mirror, or a conic y-cylinder mirror (conic
    -0.5: |N| is not one), imaging onto a small flat."""
    row = (dict(type="toroid", roc=-200., roc_rotation=-300.)
           if kind == "toroid" else
           dict(type="biconic", roc=-200., curvature_x=0., conic=-.5))
    s = ro.System([dict(material="air"),
                   dict(row, distance=50., material="mirror", radius=25.),
                   dict(distance=-100., radius=5.)])
    s.update()
    return s


def _figured(build, row, **figure):
    def make():
        s = build()
        for name, value in figure.items():
            setattr(s[row], name, list(value))
        s.update()
        return s
    return make


# name: (JAX system factory, bundle half width mm, slope)
LENSES = {
    "aspheric_double_gauss": (_aspheric_double_gauss, 8., 0.),
    "odd_singlet": (_odd_singlet, 3., .02),
    "cylinder_pair": (jmodels.anamorphic_pair, 3., .02),
    "conic_cylinders": (_conic_cylinders, 3., .02),
    "split_biconic": (_split_biconic, 3., .02),
    "toroid": (_toroid_lens, 3., .02),
    "figured_toroid": (_figured(_toroid_lens, 1, aspherics=[1e-5, 2e-8]),
                       3., .02),
    "figured_biconic": (_figured(_split_biconic, 1,
                                 aspherics=[2e-4, -1e-6]), 3., .02),
    "odd_biconic": (_figured(_split_biconic, 1, aspherics=[0., 1e-7],
                             aspherics_odd=[1e-5, 2e-5]), 3., .02),
    "figured_flat": (_flat_figured_singlet, 3., .02),
    # the parabolic mirror with an A4 term: a figured mirror row
    "figured_mirror": (_figured(jmodels.parabolic_mirror, 1,
                                aspherics=[0., 1e-9]), 20., .01),
    "toroid_mirror": (lambda: _anamorphic_mirror("toroid"), 10., 0.),
    "cylinder_mirror": (lambda: _anamorphic_mirror("cylinder"), 10., 0.),
    # a figured y-cylinder takes the Newton
    "figured_cylinder": (_figured(jmodels.anamorphic_pair, 1,
                                  aspherics=[1e-5]), 3., .02),
    # row 3's figure widens the table: row 1, an unfigured cylinder,
    # keeps the closed form
    "widened_cylinder": (_figured(jmodels.anamorphic_pair, 3,
                                  aspherics=[1e-6, 1e-9]), 3., .02),
}


def _bundle(half, slope, n=256, seed=7):
    """Rays within `half` mm of the axis, tilted up to `slope`; ray 0 on
    the axis."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*half
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*slope
    y[0, :2] = u[0, :2] = 0.
    u[:, 2] = np.sqrt(1 - (u[:, :2]**2).sum(1))
    return y, u


def _case(name, fast, clip=False):
    make, half, slope = LENSES[name]
    s = make()
    jtab = s.table()
    ttab = TT.table_from_numpy(jtab)
    y, u = _bundle(half*(2.5 if clip else 1.), slope)
    return (s, jtab, ttab, y, u, JD.plan(jtab, clip=clip, fast=fast),
            D.plan(ttab, clip=clip, fast=fast))


def _pair(j):
    return tuple(torch.from_numpy(np.array(w, dtype=np.float32)) for w in j)


def _same_words(got, want):
    """True when two df32 pairs hold identical words (NaN where the
    other is NaN)."""
    for g, w in zip(got, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return False
        live = ~torch.isnan(g)
        if not torch.equal(g[live], w[live]):
            return False
    return True


def _same_const(got, want):
    if got is None or want is None:
        return got is None and want is None
    if len(got) != len(want):
        return False
    if not len(got):
        return True
    if isinstance(got[0], tuple):
        return all(_same_const(g, w) for g, w in zip(got, want))
    return all(np.float32(g).tobytes() == np.float32(w).tobytes()
               for g, w in zip(got, want))


NAMES = sorted(LENSES)


# -- plan ---------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax(name, fast):
    """Step for step the same flags, the same (hi, lo) constants and the
    same figure: the trimmed coefficients of an aspheric row, and an
    anamorphic row's mode, constants and float32 seed scalars (a
    cylinder's k1c and circular are the values the JAX step bakes from
    its c1 and k1)."""
    _, _, _, _, _, jplan, tplan = _case(name, fast)
    assert len(jplan) == len(tplan)
    kinds = set()
    for js, ts in zip(jplan, tplan):
        for key in ("kind", "flat", "alternate", "clip", "fast"):
            assert js[key] == ts[key], key
        for key in ("c", "mu", "dz", "k1", "dxy", "rot_df", "nb", "asp",
                    "asp_odd"):
            assert _same_const(ts[key], js[key]), key
        assert js["grat"] is None and js["doe"] is None
        ja, ta = js["anam"], ts["anam"]
        assert (ja is None) == (ta is None)
        if ja is None:
            kinds.add("radial" if js["asp"] or js["asp_odd"] else None)
            continue
        kinds.add(ja["mode"])
        assert ja["mode"] == ta["mode"]
        if ja["mode"] in ("cyl_y", "cyl_x"):
            for key in ("c1", "k1"):
                assert _same_const(ta[key], ja[key]), key
            assert ta["alternate"] == ja["alternate"]
            assert _same_const(ta["k1c"], JD.const(
                D._cf(ja["k1"])*D._cf(ja["c1"])))
            assert ta["circular"] == (D._cf(ja["k1"]) == 1.)
            continue
        assert ta["df_iters"] == ja["df_iters"] == (2 if fast else 3)
        for key in ("cx", "cy", "cr", "bxc", "byc", "asp", "asp_odd"):
            assert _same_const(ta[key], ja[key]), key
        for key in ("cx", "kx", "cy", "ky", "cr", "alt"):
            assert np.float32(ta["f32"][key]) == ja["f32"][key], key
        for key in ("asp", "asp_odd"):
            assert np.array_equal(np.asarray(ta["f32"][key], np.float32),
                                  ja["f32"][key]), key
    want = {"aspheric_double_gauss": {"radial"}, "odd_singlet": {"radial"},
            "cylinder_pair": {"cyl_y", "cyl_x"},
            "conic_cylinders": {"cyl_y", "cyl_x"},
            "split_biconic": {"biconic"}, "toroid": {"toroid"},
            "figured_toroid": {"toroid"}, "figured_biconic": {"biconic"},
            "odd_biconic": {"biconic"}, "figured_flat": {"radial"},
            "figured_mirror": {"radial"}, "toroid_mirror": {"toroid"},
            "cylinder_mirror": {"cyl_y"}, "figured_cylinder": {"biconic",
                                                             "cyl_x"},
            "widened_cylinder": {"cyl_y", "biconic"}}[name]
    assert want <= kinds


# -- the trace and the merit against the JAX package -------------------------

@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_trace_words_match_jax(name, fast, clip):
    """trace_df32_final (with the optical path) gives the JAX package's
    eager words exactly, NaN masks included (2.5x wide when clipped)."""
    _, _, _, y, u, jplan, tplan = _case(name, fast, clip)
    jst, jt = JD.trace_df32_final(jplan, JD.state_from_f64(y, u),
                                  with_path=True)
    tst, tt = D.trace_df32_final(tplan, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=True)
    for g, w in zip((*tst, tt), (*jst, jt)):
        assert _same_words(g, _pair(w))
    live = ~torch.isnan(tst[3][0])
    assert int(live.sum()) > (16 if clip else 128)
    assert bool(torch.isfinite(tst[0][0][0]))   # the on-axis ray
    if clip:
        assert not bool(live.all())


@pytest.mark.parametrize("name", NAMES)
def test_merit_matches_jax(name):
    """trace_df32_merit: the five float64 moments of the JAX package's
    eager merit within MERIT_REL (the same pairwise df32 tree)."""
    for fast in (True, False):
        _, _, _, y, u, jplan, tplan = _case(name, fast)
        want = JD.trace_df32_merit(jplan, JD.state_from_f64(y, u))
        got = D.trace_df32_merit(tplan, D.state_from_f64(
            torch.from_numpy(y), torch.from_numpy(u)))
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) <= MERIT_REL*max(abs(float(w)),
                                                             1e-300)


@pytest.mark.parametrize("name", NAMES)
def test_trace_against_float64(name):
    """The port's df32 trace against its own float64 plain trace: per
    ray within F64_ATOL mm, equal NaN masks (the JAX package's
    _df32_parity tolerance)."""
    s, _, ttab, y, u, _, _ = _case(name, True)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    y64 = trace_rays_final(ttab, yt, ut, biconic=TT.is_anamorphic(ttab))[0]
    good = torch.isfinite(y64[:, 0])
    assert int(good.sum()) > 128
    for fast in (True, False):
        out = D.trace_df32_final(D.plan(ttab, fast=fast),
                                 D.state_from_f64(yt, ut))
        xd, yd = D.to_f64(out[0]), D.to_f64(out[1])
        assert torch.equal(good, torch.isfinite(xd))
        assert float((xd[good] - y64[good, 0]).abs().max()) <= F64_ATOL
        assert float((yd[good] - y64[good, 1]).abs().max()) <= F64_ATOL


@pytest.mark.parametrize("name", ["aspheric_double_gauss", "figured_toroid",
                                  "conic_cylinders"])
def test_multi_matches_jax(name):
    """trace_df32_final_multi and trace_df32_merit_multi, one plan a
    wavelength (the double Gauss's 3; the anamorphic lenses' glass at
    2 of them): the JAX package's words and moments plan by plan."""
    make, half, slope = LENSES[name]
    s = make()
    lams = s.wavelengths if len(s.wavelengths) > 1 else [587.56e-9,
                                                        486.13e-9]
    jplans = [JD.plan(s.table(lam), fast=True) for lam in lams]
    tplans = [D.plan(TT.table_from_numpy(s.table(lam)), fast=True)
              for lam in lams]
    y, u = _bundle(half, slope)
    want = JD.trace_df32_final_multi(jplans, JD.state_from_f64(y, u),
                                     with_path=True)
    st = D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))
    got = D.trace_df32_final_multi(tplans, st, with_path=True)
    assert len(got) == len(lams)
    for (gs, gt), (ws, wt) in zip(got, want):
        for g, w in zip((*gs, gt), (*ws, wt)):
            assert _same_words(g, _pair(w))
    assert not torch.equal(got[0][0][1][0], got[1][0][1][0])
    for p, m in zip(jplans, D.trace_df32_merit_multi(tplans, st)):
        w = JD.trace_df32_merit(p, JD.state_from_f64(y, u))
        assert all(abs(float(a) - float(b)) <= MERIT_REL*abs(float(b))
                   for a, b in zip(m, w))


# -- the packed plan and the wrappers on the CPU -----------------------------

def _unpack(words, flags):
    """The plan as csrc/df32_spec.cuh reads it from pack_plan's words and
    flags: each step's words from the end of the previous step's
    (step_words of its flag word), its flags decoded, its figure read by
    row kind and coefficient counts (the float32 seed's cx, cy, cr and
    coefficients from the hi words of their pairs)."""
    steps, at = [], 0
    for fl in flags.tolist():
        w = [np.float32(v) for v in words[at:at + CD.step_words(fl)].tolist()]
        at += CD.step_words(fl)

        def pair(i):
            return w[i], w[i + 1]

        def pairs(i, n):
            return tuple(pair(i + 2*k) for k in range(n))
        na, no = (fl >> CD.G_NA_SHIFT) & 15, (fl >> CD.G_NO_SHIFT) & 15
        conic, fast = bool(fl & CD.G_CONIC), bool(fl & CD.G_FAST)
        st = dict(c=pair(CD.W_C), mu=pair(CD.W_MU), dz=pair(CD.W_DZ),
                  kind=fl & 3, flat=bool(fl & CD.G_FLAT),
                  k1=pair(CD.W_K1) if conic else None,
                  k1c=pair(CD.W_K1C) if conic else None,
                  alternate=bool(fl & CD.G_ALTERNATE), rotm=None,
                  rot_df=None, dxy=None, radius=None,
                  clip=bool(fl & CD.G_CLIP), fast=fast, nb=pair(CD.W_NB),
                  asp=(), asp_odd=(), anam=None)
        if fl & CD.G_OFF_AXIS:
            st["dxy"] = pairs(CD.W_DXY, 2)
        if fl & CD.G_PERM:
            st["rotm"] = np.zeros((3, 3), int)
            for r in range(3):
                code = (fl >> (CD.G_PERM_SHIFT + 3*r)) & 7
                st["rotm"][r, code & 3] = -1 if code & 4 else 1
        elif fl & CD.G_ROT:
            st["rot_df"] = tuple(pairs(CD.W_ROT + 6*r, 3) for r in range(3))
        if st["clip"]:
            st["radius"] = w[CD.W_RAD]
        fig, f0 = CD.fig_of(fl), CD.W_FIG
        if fig == CD.FIG_RADIAL:
            st["asp"], st["asp_odd"] = pairs(f0, na), pairs(f0 + 2*na, no)
        elif fig in (CD.FIG_CYL_Y, CD.FIG_CYL_X):
            st["anam"] = dict(
                mode="cyl_y" if fig == CD.FIG_CYL_Y else "cyl_x",
                c1=pair(f0 + CD.A_C1), k1=pair(f0 + CD.A_K1),
                k1c=pair(f0 + CD.A_K1C),
                circular=not fl & CD.G_CYL_CONIC,
                alternate=st["alternate"])
        elif fig in (CD.FIG_BICONIC, CD.FIG_TOROID):
            coef = f0 + CD.A_COEF
            an = dict(mode="toroid" if fig == CD.FIG_TOROID else "biconic",
                      df_iters=D.ANAM_DF_ITERS + (0 if fast else 1),
                      asp=pairs(coef, na), asp_odd=pairs(coef + 2*na, no))
            for key in ("cx", "cy", "cr", "bxc", "byc"):
                an[key] = pair(f0 + getattr(CD, "A_" + key.upper()))
            an["f32"] = dict(
                cx=an["cx"][0], cy=an["cy"][0], cr=an["cr"][0],
                kx=w[f0 + CD.A_KX], ky=w[f0 + CD.A_KY],
                alt=np.float32(st["alternate"]),
                asp=tuple(p[0] for p in an["asp"]),
                asp_odd=tuple(p[0] for p in an["asp_odd"]))
            st["anam"] = an
        steps.append(st)
    assert at == words.numel()
    return steps


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_packed_plan_decodes_like_the_kernel(name, fast, clip):
    """pack_plan's words and flags, read the way csrc/df32_spec.cuh
    reads them (_unpack), trace every Newton lens to the plain trace's
    words exactly, the optical path included: the packed plan carries
    all its rows read, at the offsets the flags give, and the float32
    seed's scalars are the hi words of their pairs."""
    _, _, _, y, u, _, tplan = _case(name, fast, clip)
    words, flags = CD.pack_plan(tplan, "cpu")
    assert words.dim() == 1 and flags.shape == (len(tplan),)
    st = D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))
    want, wt = D.trace_df32_final(tplan, st, with_path=True)
    got, gt = D.trace_df32_final(_unpack(words, flags), st, with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got, gt), (*want, wt)))


@pytest.mark.parametrize("name", ["odd_singlet", "split_biconic",
                                  "figured_toroid"])
def test_cpu_wrappers_equal_plain(name):
    """K10-K13's wrappers on a CPU bundle of a Newton lens return their
    plain versions' results (two plans of the lens for K11/K13, one fast
    and one exact) and count no launch."""
    _, _, ttab, y, u, _, plan = _case(name, True)
    plans = [plan, D.plan(ttab)]
    st = D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))
    wrappers = (CD.trace_final_df32, CD.trace_multi_df32,
                CD.trace_merit_df32, CD.trace_merit_multi_df32)
    before = [f.launches for f in wrappers]
    got = CD.trace_final_df32(plan, st, with_path=True)
    want = D.trace_df32_final(plan, st, with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got[0], got[1]),
                                                  (*want[0], want[1])))
    for g, w in zip(CD.trace_multi_df32(plans, st),
                    D.trace_df32_final_multi(plans, st)):
        assert all(_same_words(a, b) for a, b in zip(g, w))
    assert all(torch.equal(a, b) for a, b in zip(
        CD.trace_merit_df32(plan, st), D.trace_df32_merit(plan, st)))
    for g, w in zip(CD.trace_merit_multi_df32(plans, st),
                    D.trace_df32_merit_multi(plans, st)):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert [f.launches for f in wrappers] == before


def df32_matches_jax(tab, y, u, fast=True):
    """True when the port's df32 plan and trace of the torch table `tab`
    (on the CPU) give the JAX package's eager words for the float64
    rays (y, u), the optical path included (the JAX plan reads the same
    table as numpy)."""
    jtab = TT.SurfaceTable(*(None if f is None else f.cpu().numpy()
                             for f in tab))
    jst, jt = JD.trace_df32_final(JD.plan(jtab, fast=fast),
                                  JD.state_from_f64(y, u), with_path=True)
    tst, tt = D.trace_df32_final(D.plan(tab, fast=fast), D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=True)
    return all(_same_words(g, _pair(w)) for g, w in zip((*tst, tt),
                                                        (*jst, jt)))
