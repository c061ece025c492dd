"""The df32 parity engine's freeform XY rows -- a triangular XY-monomial
figure on a conic or aspheric base, by the float32-seeded, df32-polished
Newton -- against the JAX package's eager df32, on the CPU.

The port's plain versions (ops.df32: `plan`, the trace, the merit and
their multi-plan twins) must give the JAX package's constants, term
lists and float32 seed, and its hi and lo words exactly, NaN masks
included, and its moments within MERIT_REL; the Zernike corrector of
the reference's tests/test_freeform.py stays within its 2e-12 of the
port's float64 trace.  The kernels K10-K13 run only on a CUDA card
(tests/test_torch_cuda.py); here the kernel's decoding of the packed
plan (the freeform row kinds, the term mask in bits 37-63 or a dense
row's degree, and the words a step that follow from its flag word) is
modelled and held against the plain trace, and the keys' flag tuples
and runs are checked.  Each test states its tolerance.
"""

import numpy as np
from numpy import testing as nptest
import pytest
import torch

import rayopt_tpu as jro
from rayopt_tpu.ops import df32 as JD
from rayopt_tpu.ops import tables as JT

import rayopt_tpu_torch as tro
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.geometric import trace_rays_final
from rayopt_tpu_torch.ops.kernels import _xy_terms

from test_torch_df32_newton import (_cpu_default, _pair,  # noqa: F401
                                    _same_const, _same_words)
from test_torch_df32_phase import _unpack_phase
from test_torch_freeform import SYSTEMS, TABLES, lens_bundle

MERIT_REL = 1e-13    # df32 moments against the JAX package's
ZERNIKE_ATOL = 2e-12  # the reference's df32 freeform pin, mm

#: a degree-7 row (35 terms, some zero, nonzero terms of degree 7: past
#: the kernel's degree-6 term mask, a dense step) on the aspheric-base
#: lens
DEG7 = [1e-4, 0., 3e-3, 0., -2e-3, 2e-5, 0., 0., 1e-5, 1e-6, 0., 2e-6, 0.,
        -1e-6, 0., 3e-8, 0., 0., 0., -2e-8, 1e-9, 0., 0., 0., 0., 0., 2e-9,
        0., 0., 4e-11, 0., 0., 0., 0., -3e-11]

#: made freeform tables (make_table keyword arguments): the degree-7 row,
#: and the aspheric-base lens with its freeform row decentered and
#: tilted (a general df32 rotation)
MADE = {
    "degree 7": dict(TABLES["aspheric base"],
                     xy_poly=[[0.]*35, DEG7, [0.]*35, [0.]*35]),
    "tilted": dict(TABLES["aspheric base"],
                   tilt=[[0.]*3, [.02, -.03, .01], [0.]*3, [0.]*3],
                   decenter=[[0.]*3, [.2, -.1, 0.], [0.]*3, [0.]*3]),
}

NAMES = sorted(SYSTEMS) + sorted(n for n in TABLES
                                 if n != "biconic paraboloid") + sorted(MADE)


def _tables(name):
    """(JAX table, port table) of a case."""
    if name in SYSTEMS:
        return SYSTEMS[name](jro).table(), SYSTEMS[name](tro).table()
    jt = JT.make_table(**(MADE[name] if name in MADE else TABLES[name]))
    return jt, TT.table_from_numpy(jt)


def _case(name, fast, clip=False, n=96):
    """(JAX table, port table, y, u, JAX plan, port plan) of a case on
    its bench bundle (lens_bundle: slopes within +-0.03; 2.5x wide when
    clipped, past the apertures)."""
    jtab, ttab = _tables(name)
    y, u = lens_bundle(name, n, 3)
    if clip:
        y[:, :2] *= 2.5
    return (jtab, ttab, y, u, JD.plan(jtab, clip=clip, fast=fast),
            D.plan(ttab, clip=clip, fast=fast))


def _state(y, u):
    return D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))


def _freeform(steps):
    return [st for st in steps if st["anam"] is not None
            and st["anam"]["mode"] == "freeform"]


# -- plan ---------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax(name, fast):
    """Step for step the JAX plan, exactly: the flags and constants, and
    of each freeform row its mode, df32 rounds, degree, the base's c and
    k1 = const(1 + conic) (also at conic 0), asp and asp_odd, the value,
    x-slope and y-slope term lists (constants and exponents, the nonzero
    terms only), and the float32 seed's cy, ky, alt, coefficients and
    whole XY row (zeros included)."""
    _, _, _, _, jplan, tplan = _case(name, fast)
    assert len(jplan) == len(tplan)
    for js, ts in zip(jplan, tplan):
        for key in ("kind", "flat", "alternate", "clip", "fast"):
            assert js[key] == ts[key], key
        for key in ("c", "mu", "dz", "k1", "dxy", "rot_df", "nb", "asp",
                    "asp_odd", "grat"):
            assert _same_const(ts[key], js[key]), key
        ja, ta = js["anam"], ts["anam"]
        assert (ja is None) == (ta is None)
        if ja is None:
            continue
        for key in ("mode", "df_iters", "deg"):
            assert ja[key] == ta[key], key
        for key in ("c", "k1", "asp", "asp_odd"):
            assert _same_const(ta[key], ja[key]), key
        for key in ("xy", "xy_gx", "xy_gy"):
            assert [t[1:] for t in ta[key]] == [t[1:] for t in ja[key]]
            assert _same_const(tuple(t[0] for t in ta[key]),
                               tuple(t[0] for t in ja[key])), key
        jf, tf = ja["f32"], ta["f32"]
        for key in ("cy", "ky", "alt"):
            assert np.float32(tf[key]).tobytes() == jf[key].tobytes(), key
        for key in ("asp", "asp_odd", "xy"):
            assert (np.asarray(tf[key], np.float32).tobytes()
                    == np.asarray(jf[key], np.float32).tobytes()), key
    assert len(_freeform(tplan)) == 1


# -- the trace and the merit against the JAX package -------------------------

@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_trace_words_match_jax(name, fast, clip):
    """trace_df32_final with the optical path gives the JAX package's
    eager words exactly, NaN masks included (2.5x wide when clipped)."""
    _, _, y, u, jplan, tplan = _case(name, fast, clip)
    jst, jt = JD.trace_df32_final(jplan, JD.state_from_f64(y, u),
                                  with_path=True)
    tst, tt = D.trace_df32_final(tplan, _state(y, u), with_path=True)
    for g, w in zip((*tst, tt), (*jst, jt)):
        assert _same_words(g, _pair(w))
    assert int((~torch.isnan(tst[3][0])).sum()) > (8 if clip else 64)


@pytest.mark.parametrize("name", NAMES)
def test_merit_matches_jax(name):
    """trace_df32_merit: the five float64 moments of the JAX package's
    eager merit within MERIT_REL, fast and exact."""
    for fast in (True, False):
        _, _, y, u, jplan, tplan = _case(name, fast)
        want = JD.trace_df32_merit(jplan, JD.state_from_f64(y, u))
        got = D.trace_df32_merit(tplan, _state(y, u))
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) <= MERIT_REL*max(abs(float(w)),
                                                             1e-300)


def _stack(name):
    """The JAX tables of a case's three wavelength plans: a system's own
    (System.table at each wavelength), a made table's with mu grown by 1
    and 2 % of mu - 1 and its XY row by 3 and 6 %."""
    if name in SYSTEMS:
        s = SYSTEMS[name](jro)
        return [s.table(lam) for lam in s.wavelengths]
    base = _tables(name)[0]
    return [base._replace(mu=1 + (np.asarray(base.mu) - 1)*(1 + .01*li),
                          xy_poly=np.asarray(base.xy_poly)*(1 + .03*li))
            for li in range(3)]


@pytest.mark.parametrize("name", ["schmidt", "zernike corrector",
                                  "aspheric base", "degree 7"])
def test_multi_matches_jax(name):
    """trace_df32_final_multi (with the path) and trace_df32_merit_multi
    over three wavelengths' plans: the JAX package's words and moments
    (MERIT_REL) plan by plan."""
    jtabs = _stack(name)
    jplans = [JD.plan(t, fast=True) for t in jtabs]
    tplans = [D.plan(TT.table_from_numpy(t), fast=True) for t in jtabs]
    y, u = lens_bundle(name, 64, 4)
    want = JD.trace_df32_final_multi(jplans, JD.state_from_f64(y, u),
                                     with_path=True)
    st = _state(y, u)
    got = D.trace_df32_final_multi(tplans, st, with_path=True)
    assert len(got) == 3
    for (gs, gt), (ws, wt) in zip(got, want):
        for g, w in zip((*gs, gt), (*ws, wt)):
            assert _same_words(g, _pair(w))
    assert not torch.equal(got[0][0][3][0], got[1][0][3][0])
    for p, m in zip(jplans, D.trace_df32_merit_multi(tplans, st)):
        w = JD.trace_df32_merit(p, JD.state_from_f64(y, u))
        assert all(abs(float(a) - float(b)) <= MERIT_REL*abs(float(b))
                   for a, b in zip(m, w))


@pytest.mark.parametrize("fast", [False, True])
def test_zernike_corrector_meets_float64(fast):
    """The reference's own pin (its tests/test_freeform.py
    test_df32_freeform_parity) rebuilt on the port: the Zernike
    corrector's 32 hexapolar rays on axis (the JAX package's
    GeometricTrace, unclipped), the port's df32 x, y and ux within
    ZERNIKE_ATOL mm of its float64 trace (the generic walk)."""
    s = SYSTEMS["zernike corrector"](jro)
    t = jro.GeometricTrace(s)
    t.rays_point((0., 0.), nrays=32, distribution="hexapolar", clip=False)
    y0 = torch.from_numpy(np.asarray(t.y[0], float))
    u0 = torch.from_numpy(np.asarray(t.u[0], float))
    tab = SYSTEMS["zernike corrector"](tro).table()
    yf, uf, _ = trace_rays_final(tab, y0, u0, biconic=True)
    out = D.trace_df32_final(D.plan(tab, fast=fast), D.state_from_f64(y0, u0))
    for comp, want in ((0, yf[:, 0]), (1, yf[:, 1]), (3, uf[:, 0])):
        nptest.assert_allclose(D.to_f64(out[comp]).numpy(), want.numpy(),
                               rtol=0, atol=ZERNIKE_ATOL)


# -- the packed plan, the key and its runs -----------------------------------

def _unpack_freeform(words, flags):
    """_unpack_phase (tests/test_torch_df32_phase.py) and a freeform
    step's figure as csrc/df32_common.cuh reads it: the terms of its
    mask (FIG_FREEFORM) or of its dense degree (FIG_XY_DENSE), the base's
    c and 1 + conic from the step's own words (1 without G_CONIC), the
    seed's float32 conic, the base's coefficients, the value, x-slope and
    y-slope pairs from xy_at; the seed's coefficients the hi words of
    their pairs, its XY row zero where the step holds no term."""
    steps = _unpack_phase(words, flags)
    at = 0
    for st, fl in zip(steps, flags.tolist()):
        w = [np.float32(v) for v in words[at:at + CD.step_words(fl)].tolist()]
        at += CD.step_words(fl)
        if CD.fig_of(fl) not in (CD.FIG_FREEFORM, CD.FIG_XY_DENSE):
            continue

        def pairs(i, n):
            return tuple((w[i + 2*k], w[i + 2*k + 1]) for k in range(n))
        na, no = (fl >> CD.G_NA_SHIFT) & 15, (fl >> CD.G_NO_SHIFT) & 15
        terms = CD.xy_terms(fl)
        deg = max(i + j for i, j in terms)
        sx = [(i - 1, j) for i, j in terms if i]
        sy = [(i, j - 1) for i, j in terms if j]
        value = pairs(CD.xy_at(fl, 0), len(terms))
        asp = pairs(CD.W_FIG + CD.F_COEF, na)
        asp_odd = pairs(CD.W_FIG + CD.F_COEF + 2*na, no)
        row = np.zeros(len(_xy_terms(deg)), np.float32)
        for (i, j), p in zip(terms, value):
            row[_xy_terms(deg).index((i, j))] = p[0]
        st["anam"] = dict(
            mode="freeform", df_iters=D.ANAM_DF_ITERS + (0 if st["fast"]
                                                         else 1),
            deg=deg, c=st["c"], k1=st["k1"] or (np.float32(1.),
                                                np.float32(0.)),
            asp=asp, asp_odd=asp_odd,
            xy=tuple((p, i, j) for p, (i, j) in zip(value, terms)),
            xy_gx=tuple((p, i, j) for p, (i, j) in zip(
                pairs(CD.xy_at(fl, 1), len(sx)), sx)),
            xy_gy=tuple((p, i, j) for p, (i, j) in zip(
                pairs(CD.xy_at(fl, 2), len(sy)), sy)),
            f32=dict(cy=st["c"][0], ky=w[CD.W_FIG + CD.F_KY],
                     alt=np.float32(st["alternate"]),
                     asp=tuple(p[0] for p in asp),
                     asp_odd=tuple(p[0] for p in asp_odd), xy=row))
        assert CD.xy_at(fl, 3) == CD.phase_at(fl)
    return steps


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_packed_plan_decodes_like_the_kernel(name, fast, clip):
    """pack_plan's words and 64-bit flags, read as csrc/df32_spec.cuh
    reads them (_unpack_freeform), trace every freeform case to the plain
    trace's words exactly, the optical path included: the packed plan
    carries every freeform word at the offsets the flags give, and the
    kernel's seed (the held terms only) gives the plain seed's words."""
    _, _, y, u, _, tplan = _case(name, fast, clip)
    words, flags = CD.pack_plan(tplan, "cpu")
    assert flags.dtype == torch.int64
    figs = [CD.fig_of(f) for f in flags.tolist()]
    assert figs.count(CD.FIG_XY_DENSE if name == "degree 7"
                      else CD.FIG_FREEFORM) == 1
    st = _state(y, u)
    want, wt = D.trace_df32_final(tplan, st, with_path=True)
    got, gt = D.trace_df32_final(_unpack_freeform(words, flags), st,
                                 with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got, gt), (*want, wt)))


def test_mask_bits_sit_above_the_phase_bits():
    """The term mask (one bit a term of the triangular order, up to
    XY_MASK_TERMS = 27: degree 6) takes bits 37-63, above the phase
    bits and the DOE count (bits 31-36): the freeform grating's step
    sets G_GRATING and its three terms' bits, apart; the Schmidt plate's
    its 14; a degree-6 row whose y^6 term alone is nonzero sets bit 63,
    a negative flag word (the kernels' signed 64-bit Flag), which keys
    and decodes like any other; a plan without a freeform row keeps its
    flag words below bit 37 (and its keys' names)."""
    assert CD.G_XY_SHIFT == 37 and CD.XY_MASK_TERMS == 27
    assert CD.G_XY_SHIFT + CD.XY_MASK_TERMS == 64
    phase = CD.G_GRATING | CD.G_DOE | 15 << CD.G_ND_SHIFT
    assert phase < 1 << CD.G_XY_SHIFT
    for name, ntm, bit in (("freeform grating", 3, CD.G_GRATING),
                           ("schmidt", 14, 0)):
        flags = CS.df32_flags([_case(name, True)[5]])[0]
        fl = [f for f in flags if CD.fig_of(f) == CD.FIG_FREEFORM][0]
        mask = fl >> CD.G_XY_SHIFT
        assert bin(mask).count("1") == ntm and fl & phase == bit
        assert len(CD.xy_terms(fl)) == ntm
    row = [0.]*27
    row[26] = 1e-9
    tab = TT.make_table([0., 0., 0.], distance=[0., 5., 20.],
                        mu=[1., 1/1.5, 1.5],
                        xy_poly=[[0.]*27, row, [0.]*27])
    plan = D.plan(tab, fast=True)
    words, flags = CD.pack_plan(plan, "cpu")
    fl = flags.tolist()[0]
    assert fl < 0 and CD.xy_terms(fl) == ((0, 6),)
    key = CS.df32_multi_key([plan], "k11", True)
    assert key.tuples[0][0] == fl
    assert CS.template_args(key)[2][0] == fl
    y, u = lens_bundle("tilted", 32, 5)
    st = _state(y, u)
    want = D.trace_df32_final(plan, st)
    got = D.trace_df32_final(_unpack_freeform(words, flags), st)
    assert all(_same_words(a, b) for a, b in zip(got, want))
    twin = _tables("aspheric base")[1].replace(
        xy_poly=torch.zeros((4, 0), dtype=torch.float64))
    assert all(0 <= f < 1 << CD.G_XY_SHIFT
               for f in CS.df32_flags([D.plan(twin)])[0])


@pytest.mark.parametrize("field", ["curvature_dx", "conic_dx", "toroidal"])
def test_anamorphic_base_refused(field):
    """A freeform figure on an anamorphic base raises NotImplementedError
    naming it, in the port's plan as in the JAX package's."""
    kw = dict(TABLES["quadratic freeform"])
    kw[field] = [0., 1e-3 if field != "toroidal" else 1., 0., 0.]
    if field == "toroidal":
        kw["curvature"] = [0., 1/50., 0., 0.]
    jtab = JT.make_table(**kw)
    with pytest.raises(NotImplementedError, match="anamorphic"):
        JD.plan(jtab)
    with pytest.raises(NotImplementedError, match="anamorphic base"):
        D.plan(TT.table_from_numpy(jtab))


@pytest.mark.parametrize("base", ["aspheric base", "freeform grating",
                                  "biconic"])
def test_all_zero_row_plans_as_its_base(base):
    """A row whose XY figure is all zero plans as its base row (a conic
    aspheric row, a sphere on a grating row, a biconic row), as the
    reference's plan does: the same steps as the table without the
    xy_poly column, and the JAX package's words."""
    if base == "biconic":
        kw = dict(TABLES["biconic paraboloid"], xy_poly=[[0.]*5]*4)
    else:
        kw = dict(TABLES[base])
        kw["xy_poly"] = [[0.]*len(kw["xy_poly"][0])]*4
    jtab = JT.make_table(**kw)
    ttab = TT.table_from_numpy(jtab)
    bare = ttab.replace(xy_poly=torch.zeros((4, 0), dtype=torch.float64))
    for fast in (True, False):
        got, want = D.plan(ttab, fast=fast), D.plan(bare, fast=fast)
        assert not _freeform(got)
        assert CS.df32_flags([got]) == CS.df32_flags([want])
        assert torch.equal(CD.pack_plan(got, "cpu")[0],
                           CD.pack_plan(want, "cpu")[0])
    y, u = lens_bundle(base, 64, 6)
    jst = JD.trace_df32_final(JD.plan(jtab), JD.state_from_f64(y, u))
    tst = D.trace_df32_final(D.plan(ttab), _state(y, u))
    assert all(_same_words(g, _pair(w)) for g, w in zip(tst, jst))


def test_degree_7_row_plans_and_traces():
    """A degree-7 row (DEG7: 35 terms, 14 nonzero) plans with its degree
    and its nonzero terms; packed, it is a dense step (its terms past the
    degree-6 mask): the degree in bits 37-63, all 35 terms' value pairs
    and the 28 x-slope and 28 y-slope pairs, zeros included; it traces
    to the JAX package's words (test_trace_words_match_jax) and to
    float64 within 1e-10 mm."""
    _, ttab, y, u, _, tplan = _case("degree 7", True)
    an = _freeform(tplan)[0]["anam"]
    assert an["deg"] == 7 and len(an["xy"]) == 14
    assert max(i + j for _, i, j in an["xy"]) == 7
    flags = CD.pack_plan(tplan, "cpu")[1].tolist()
    fl = flags[0]
    assert CD.fig_of(fl) == CD.FIG_XY_DENSE and fl >> CD.G_XY_SHIFT == 7
    assert CD.xy_terms(fl) == _xy_terms(7)
    na = len(an["asp"])
    assert CD.step_words(fl) == CD.DW + 1 + 2*na + 2*(35 + 28 + 28)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    y64, _, _ = trace_rays_final(ttab, yt, ut, biconic=True)
    out = D.trace_df32_final(tplan, _state(y, u))
    good = torch.isfinite(y64[:, 0])
    assert int(good.sum()) > 64
    for c in range(2):
        assert float((D.to_f64(out[c])[good] - y64[good, c]).abs()
                     .max()) <= 1e-10


def test_dense_terms_give_the_sparse_words():
    """The dense form's model: _poly_xy_df over every term of a degree,
    the zero terms' (0, 0) pairs included (value, x-slope and y-slope
    lists), gives the sparse lists' words on finite values; and the
    degree-7 plan with its lists made dense traces to the sparse plan's
    words, the path included."""
    _, _, y, u, _, tplan = _case("degree 7", False)
    an = _freeform(tplan)[0]["anam"]
    zero = (np.float32(0.), np.float32(0.))
    terms = _xy_terms(an["deg"])
    dense = {}
    for key, shift in (("xy", (0, 0)), ("xy_gx", (1, 0)), ("xy_gy", (0, 1))):
        held = {(i, j): p for p, i, j in an[key]}
        dense[key] = tuple((held.get((i - shift[0], j - shift[1]), zero),
                            i - shift[0], j - shift[1]) for i, j in terms
                           if i >= shift[0] and j >= shift[1])
    rng = np.random.default_rng(8)
    x, yv = (D.from_f64(torch.from_numpy(rng.uniform(-6, 6, 256)))
             for _ in range(2))
    for key in ("xy", "xy_gx", "xy_gy"):
        def on_cpu(lst):
            return tuple(((torch.tensor(p[0]), torch.tensor(p[1])), i, j)
                         for p, i, j in lst)
        want = D._poly_xy_df(x, yv, on_cpu(an[key]), an["deg"])
        got = D._poly_xy_df(x, yv, on_cpu(dense[key]), an["deg"])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), key
    dplan = [dict(st) for st in tplan]
    for st in dplan:
        if st["anam"] is not None and st["anam"]["mode"] == "freeform":
            st["anam"] = dict(st["anam"], **dense)
    st = _state(y, u)
    want, wt = D.trace_df32_final(tplan, st, with_path=True)
    got, gt = D.trace_df32_final(dplan, st, with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got, gt), (*want, wt)))


def test_key_shares_one_tuple_and_runs_count_the_grown_words():
    """The Schmidt corrector's three wavelength plans share one flag
    tuple (the term mask is the row's at every wavelength), so K11's and
    K13's key holds one; its plate's step holds DW + 1 + 2 (14 + 10 +
    10) words (the seed's conic, the value pairs and the slope pairs of
    the 10 terms with i > 0 and the 10 with j > 0), the key's plan words
    count them, and a plan list past the parameter limit runs in as
    many balanced runs as the limit asks at those words."""
    jtabs = _stack("schmidt")
    plans = [D.plan(TT.table_from_numpy(t), fast=True) for t in jtabs]
    for kernel in ("k11", "k13"):
        key = CS.df32_multi_key(plans, kernel)
        assert len(key.tuples) == 1 and key.plan_map == (0, 0, 0)
        words, flags = CD.pack_plan(plans, "cpu")
        fl = flags[0].tolist()
        assert key.tuples[0] == tuple(fl)
        assert CD.step_words(fl[0]) == CD.DW + 1 + 2*(14 + 10 + 10)
        assert key.plan_words == words.shape[1] == sum(map(CD.step_words,
                                                           fl))
        most = (CS.PARAM_LIMIT - CS.DF32_PARAM_BYTES[kernel])//(
            key.plan_words*4)
        runs = CS.df32_runs((tuple(fl),)*(most + 3), kernel)
        assert len(runs) == 2 and runs[-1][1] == most + 3
        assert max(b - a for a, b in runs) <= most


def test_cpu_wrappers_equal_plain():
    """K10-K13's wrappers on a CPU bundle of the Schmidt corrector return
    their plain versions' results (its three wavelengths' plans for
    K11/K13) and count no launch."""
    plans = [D.plan(TT.table_from_numpy(t), fast=True)
             for t in _stack("schmidt")]
    y, u = lens_bundle("schmidt", 64, 7)
    st = _state(y, u)
    wrappers = (CD.trace_final_df32, CD.trace_multi_df32,
                CD.trace_merit_df32, CD.trace_merit_multi_df32)
    before = [f.launches for f in wrappers]
    got = CD.trace_final_df32(plans[0], st, with_path=True)
    want = D.trace_df32_final(plans[0], st, with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got[0], got[1]),
                                                  (*want[0], want[1])))
    for g, w in zip(CD.trace_multi_df32(plans, st),
                    D.trace_df32_final_multi(plans, st)):
        assert all(_same_words(a, b) for a, b in zip(g, w))
    for g, w in zip(CD.trace_merit_multi_df32(plans, st),
                    D.trace_df32_merit_multi(plans, st)):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert all(torch.equal(a, b) for a, b in zip(
        CD.trace_merit_df32(plans[0], st), D.trace_df32_merit(plans[0], st)))
    assert [f.launches for f in wrappers] == before
