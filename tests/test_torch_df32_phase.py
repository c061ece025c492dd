"""The df32 parity engine's phase rows -- a linear grating or a radial
diffractive phase (DOE) on a flat, spherical, conic, aspheric, biconic,
toroidal or cylindrical substrate, the DOE's phase in the optical path
-- against the JAX package's eager df32, on the CPU.

The port's plain versions (ops.df32: `plan`, the trace, the merit and
their multi-plan twins) must give the JAX package's constants and its
hi and lo words exactly, NaN masks included, and its moments within
MERIT_REL; the image positions and the optical path stay within
F64_ATOL of the port's own float64 trace.  The kernels K10-K13 run only
on a CUDA card (tests/test_torch_cuda.py); here the kernel's decoding of
the packed plan (the phase bits, the DOE count and the words a step
that follow from its 64-bit flag word) is modelled and held against the
plain trace, and the keys' flag tuples and runs are checked.  Each test
states its tolerance.
"""

import numpy as np
import pytest
import torch

import rayopt_tpu as jro
from rayopt_tpu.ops import df32 as JD
from rayopt_tpu.ops import tables as JT

from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.geometric import trace_rays_final

from test_torch_df32_newton import (_cpu_default, _pair,  # noqa: F401
                                    _same_const, _same_words, _unpack)
from test_torch_grating import LENSES as PHASE_LENSES

F64_ATOL = 1e-10     # df32 positions against the float64 trace, mm
PATH_ATOL = 1e-10    # the kinoform's df32 optical path against float64
MERIT_REL = 1e-13    # df32 moments against the JAX package's

LAM0 = 550e-9
A1 = -np.pi/((LAM0/1e-3)*100.)   # a kinoform of focal 100 mm at LAM0


def _kinoform():
    """The JAX package's tests/test_doe.py kinoform, on axis."""
    s = jro.System([
        dict(material="air"),
        dict(type="binary2", phase_coefficients=[A1], norm_radius=1.,
             distance=5., material="air", radius=10.),
        dict(distance=100., radius=10.)], wavelengths=[LAM0], object=dict(
            angle_deg=0., pupil=dict(radius=3., update_radius=False)))
    s.update()
    return s


#: made phase rows (JAX make_table keyword arguments; the phase row is
#: row 1, glass after it): a grating on a biconic-made y-cylinder (cx =
#: 0), a DOE on a toroid-made y-cylinder (cr = 0), a grating on an
#: x-cylinder (c = 0), and a grating with a DOE on an aspheric, a
#: biconic and a toroidal substrate
SUBSTRATES = {
    "grating y-cylinder": dict(curvature=[0., 1/40., 0.],
                               curvature_dx=[0., -1/40., 0.],
                               conic=[0., -.3, 0.], conic_dx=[0., .3, 0.],
                               grating_dy=[0., .1, 0.]),
    "doe toroid cylinder": dict(curvature=[0., 1/50., 0.],
                                curvature_dx=[0., -1/50., 0.],
                                toroidal=[0., 1., 0.],
                                doe=[[0., 0.], [-1.5e-3, 2e-7], [0., 0.]]),
    "grating x-cylinder": dict(curvature=[0., 0., 0.],
                               curvature_dx=[0., 1/45., 0.],
                               conic_dx=[0., -.4, 0.],
                               grating_dy=[0., -.15, 0.]),
    "aspheric": dict(curvature=[0., 1/60., 0.], conic=[0., -.5, 0.],
                     aspherics=[[0., 0.], [1e-5, -2e-8], [0., 0.]],
                     grating_dy=[0., .12, 0.],
                     doe=[[0.], [-1e-3], [0.]]),
    "biconic": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., .004, 0.],
                    conic=[0., -.3, 0.], conic_dx=[0., .2, 0.],
                    grating_dy=[0., -.1, 0.], doe=[[0.], [1.2e-3], [0.]]),
    "toroid": dict(curvature=[0., 1/60., 0.], curvature_dx=[0., -.01, 0.],
                   toroidal=[0., 1., 0.], conic=[0., -.2, 0.],
                   grating_dy=[0., .2, 0.], doe=[[0.], [-1.5e-3], [0.]]),
}


def substrate(name, mirror=False):
    """The JAX table of SUBSTRATES[name] (a mirror: mu = -1, imaging back
    onto a plane before it)."""
    kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
              radius=[np.inf, 12., np.inf])
    if mirror:
        kw.update(mu=[1., -1., 1.], n_before=[1., 1., 1.],
                  n_after=[1., 1., 1.], distance=[0., 40., -30.])
    kw.update(SUBSTRATES[name])
    return JT.make_table(**kw)


def _lens_table(name):
    """(JAX table, half width mm, slope) of each case."""
    if name in PHASE_LENSES:
        s = PHASE_LENSES[name](jro)
        half = {"hybrid_achromat": 6., "spectrograph": 10.}.get(name, 3.)
        return s.table(), half, .01
    if name == "kinoform":
        return _kinoform().table(), 3., 0.
    if name.endswith(" mirror"):
        return substrate(name[:-len(" mirror")], True), 3., .01
    return substrate(name), 3., .01


NAMES = sorted(PHASE_LENSES) + ["kinoform"] + sorted(SUBSTRATES) + [
    "grating y-cylinder mirror", "toroid mirror"]


def _bundle(half, slope, n=128, seed=11):
    """Rays within `half` mm of the axis, tilted up to `slope`, ray 0 off
    the axis by a tenth of `half` (an on-axis ray through an odd figure
    has no normal)."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*half
    y[0, :2] = (.1*half, -.05*half)
    u = np.zeros((n, 3))
    u[:, :2] = rng.uniform(-1, 1, (n, 2))*slope
    u[:, 2] = np.sqrt(1 - (u[:, :2]**2).sum(1))
    return y, u


def _case(name, fast, clip=False):
    jtab, half, slope = _lens_table(name)
    ttab = TT.table_from_numpy(jtab)
    y, u = _bundle(half*(2.5 if clip else 1.), slope)
    return (jtab, ttab, y, u, JD.plan(jtab, clip=clip, fast=fast),
            D.plan(ttab, clip=clip, fast=fast))


def _state(y, u):
    return D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))


# -- plan ---------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_plan_matches_jax(name, fast):
    """Step for step the phase constants of the JAX plan, exactly: grat
    (grating_dy), doe (2(i+1) a_i), doe_path (a_i n_after/n_before), a
    phase cylinder's bc = (1+k) c^2, and the flags, constants and
    figure the Newton rows already held (tests/test_torch_df32_newton.py)."""
    _, _, _, _, jplan, tplan = _case(name, fast)
    assert len(jplan) == len(tplan)
    phase = 0
    for js, ts in zip(jplan, tplan):
        for key in ("kind", "flat", "alternate", "clip", "fast"):
            assert js[key] == ts[key], key
        for key in ("c", "mu", "dz", "k1", "dxy", "rot_df", "nb", "asp",
                    "asp_odd", "grat", "doe", "doe_path"):
            assert _same_const(ts[key], js[key]), key
        phase += ts["grat"] is not None or ts["doe"] is not None
        ja, ta = js["anam"], ts["anam"]
        assert (ja is None) == (ta is None)
        if ja is None:
            continue
        assert ja["mode"] == ta["mode"]
        for key in ("c1", "k1", "cx", "cy", "cr", "bxc", "byc"):
            if key in ja:
                assert _same_const(ta[key], ja[key]), key
        if ja["mode"] in ("cyl_y", "cyl_x"):
            # bc only where a phase row reads it
            is_phase = ts["grat"] is not None or ts["doe"] is not None
            assert ("bc" in ta) == is_phase
            if is_phase:
                assert _same_const(ta["bc"], ja["bc"])
    assert phase >= 1


# -- the trace and the merit against the JAX package -------------------------

@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_trace_words_match_jax(name, fast, clip):
    """trace_df32_final with the optical path (a DOE row's phase term in
    it) gives the JAX package's eager words exactly, NaN masks included
    (2.5x wide when clipped)."""
    _, _, y, u, jplan, tplan = _case(name, fast, clip)
    jst, jt = JD.trace_df32_final(jplan, JD.state_from_f64(y, u),
                                  with_path=True)
    tst, tt = D.trace_df32_final(tplan, _state(y, u), with_path=True)
    for g, w in zip((*tst, tt), (*jst, jt)):
        assert _same_words(g, _pair(w))
    live = ~torch.isnan(tst[3][0])
    assert int(live.sum()) > (8 if clip else 64)


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


@pytest.mark.parametrize("name", NAMES)
def test_trace_against_float64(name):
    """The port's df32 trace against its own float64 plain trace (the
    generic walk with biconic=True, as the reference's test_doe.py
    holds its df32 path): per ray within F64_ATOL mm, equal NaN masks,
    and the optical path within PATH_ATOL of the float64 path relative
    to its size (the kinoform's: the reference's 1e-10 absolute)."""
    _, ttab, y, u, _, _ = _case(name, True)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    y64, _, t64 = trace_rays_final(ttab, yt, ut, biconic=True)
    good = torch.isfinite(y64[:, 0])
    assert int(good.sum()) > 64
    for fast in (True, False):
        out, tacc = D.trace_df32_final(D.plan(ttab, fast=fast),
                                       D.state_from_f64(yt, ut),
                                       with_path=True)
        xd, yd, td = D.to_f64(out[0]), D.to_f64(out[1]), D.to_f64(tacc)
        assert torch.equal(good, torch.isfinite(xd))
        assert float((xd[good] - y64[good, 0]).abs().max()) <= F64_ATOL
        assert float((yd[good] - y64[good, 1]).abs().max()) <= F64_ATOL
        scale = max(1., float(t64[good].abs().max()))
        assert float((td[good] - t64[good]).abs().max()) <= PATH_ATOL*scale


@pytest.mark.parametrize("name", ["hybrid_achromat", "spectrograph",
                                  "grating y-cylinder",
                                  "doe toroid cylinder"])
def test_multi_matches_jax(name):
    """trace_df32_final_multi and trace_df32_merit_multi over three
    wavelengths' plans (the lens's own, or 0.9, 1 and 1.1 times 550 nm
    of a made table, its grating_dy and DOE coefficients scaled with the
    wavelength): the JAX package's words and moments plan by plan."""
    if name in PHASE_LENSES:
        s = PHASE_LENSES[name](jro)
        jtabs = [s.table(lam) for lam in s.wavelengths]
        half = 6.
    else:
        base = substrate(name)
        jtabs = [base._replace(
            grating_dy=np.asarray(base.grating_dy)*f,
            doe=np.asarray(base.doe)*f) for f in (1., .9, 1.1)]
        half = 3.
    jplans = [JD.plan(t, fast=True) for t in jtabs]
    tplans = [D.plan(TT.table_from_numpy(t), fast=True) for t in jtabs]
    y, u = _bundle(half, .01)
    want = JD.trace_df32_final_multi(jplans, JD.state_from_f64(y, u),
                                     with_path=True)
    st = _state(y, u)
    got = D.trace_df32_final_multi(tplans, st, with_path=True)
    assert len(got) == 3
    for (gs, gt), (ws, wt) in zip(got, want):
        for g, w in zip((*gs, gt), (*ws, wt)):
            assert _same_words(g, _pair(w))
    assert not torch.equal(got[0][0][4][0], got[1][0][4][0])
    for p, m in zip(jplans, D.trace_df32_merit_multi(tplans, st)):
        w = JD.trace_df32_merit(p, JD.state_from_f64(y, u))
        assert all(abs(float(a) - float(b)) <= MERIT_REL*abs(float(b))
                   for a, b in zip(m, w))


# -- the packed plan, the key and its runs -----------------------------------

def _unpack_phase(words, flags):
    """_unpack (tests/test_torch_df32_newton.py) and the phase words as
    csrc/df32_common.cuh reads them: a phase cylinder's bc after its
    three pairs, then from phase_at the grating term (G_GRATING), the nd
    kick and the nd path coefficients (G_DOE, nd from the flag word)."""
    steps = _unpack(words, flags)
    at = 0
    for st, fl in zip(steps, flags.tolist()):
        w = [np.float32(v) for v in words[at:at + CD.step_words(fl)].tolist()]
        at += CD.step_words(fl)

        def pairs(i, n):
            return tuple((w[i + 2*k], w[i + 2*k + 1]) for k in range(n))
        ph = CD.phase_at(fl)
        grating, doe = bool(fl & CD.G_GRATING), bool(fl & CD.G_DOE)
        nd = (fl >> CD.G_ND_SHIFT) & 15
        assert CD.step_words(fl) == ph + 2*grating + 4*nd*doe
        if st["anam"] is not None and (grating or doe) and \
                st["anam"]["mode"] in ("cyl_y", "cyl_x"):
            st["anam"]["bc"] = pairs(CD.W_FIG + CD.A_BC, 1)[0]
        st["grat"] = pairs(ph, 1)[0] if grating else None
        q = ph + 2*grating
        st["doe"] = pairs(q, nd) if doe else None
        st["doe_path"] = pairs(q + 2*nd, nd) if doe else None
    return steps


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_packed_plan_decodes_like_the_kernel(name, fast, clip):
    """pack_plan's words and 64-bit flags, read as csrc/df32_spec.cuh
    reads them (_unpack_phase), trace every phase case to the plain
    trace's words exactly, the optical path included: the packed plan
    carries every phase word at the offsets the flags give."""
    _, _, y, u, _, tplan = _case(name, fast, clip)
    words, flags = CD.pack_plan(tplan, "cpu")
    assert flags.dtype == torch.int64
    assert any(f & (CD.G_GRATING | CD.G_DOE) for f in flags.tolist())
    st = _state(y, u)
    want, wt = D.trace_df32_final(tplan, st, with_path=True)
    got, gt = D.trace_df32_final(_unpack_phase(words, flags), st,
                                 with_path=True)
    assert all(_same_words(a, b) for a, b in zip((*got, gt), (*want, wt)))


def test_phase_bits_sit_above_bit_30():
    """The phase bits and the DOE count sit above the 31 bits the other
    step flags take, so a plan without a phase row keeps its flag words
    (and its keys' names); the hybrid's DOE step sets G_DOE and its
    count, the spectrograph's grating step G_GRATING."""
    low = (1 << 31) - 1
    assert CD.G_GRATING == 1 << 31 and CD.G_DOE == 1 << 32
    assert CD.G_ND_SHIFT == 33
    for name, bit in (("hybrid_achromat", CD.G_DOE),
                      ("spectrograph", CD.G_GRATING)):
        _, _, _, _, _, tplan = _case(name, True)
        flags = CS.df32_flags([tplan])[0]
        phase = [f for f in flags if f & ~low]
        assert len(phase) == 1 and phase[0] & bit
        if bit == CD.G_DOE:
            assert (phase[0] >> CD.G_ND_SHIFT) & 15 == 1
        twin = [st for st in tplan]
        for st in twin:
            if st["grat"] is not None or st["doe"] is not None:
                st.update(grat=None, doe=None, doe_path=None)
        assert all(f <= low for f in CS.df32_flags([twin])[0])


@pytest.mark.parametrize("name", ["hybrid_achromat", "spectrograph"])
def test_key_shares_one_tuple_across_wavelengths(name):
    """A phase lens's wavelength plans share one flag tuple (the grating
    term and the DOE coefficients scale with the wavelength in the
    words, not the flags), so K11's and K13's key holds one tuple; plans
    whose phase bits differ at a step are refused with the step and the
    bits."""
    s = PHASE_LENSES[name](jro)
    plans = [D.plan(TT.table_from_numpy(s.table(lam)), fast=True)
             for lam in s.wavelengths]
    for kernel in ("k11", "k13"):
        key = CS.df32_multi_key(plans, kernel)
        assert len(key.tuples) == 1 and key.plan_map == (0,)*len(plans)
        words, flags = CD.pack_plan(plans, "cpu")
        assert key.tuples[0] == tuple(flags[0].tolist())
        assert key.word_bytes == words.numel()*4
    bad = [dict(st) for st in plans[1]]
    j = next(i for i, st in enumerate(bad)
             if st["grat"] is not None or st["doe"] is not None)
    if bad[j]["doe"] is not None:
        bad[j]["doe"] = bad[j]["doe"] + bad[j]["doe"][:1]
        bad[j]["doe_path"] = bad[j]["doe_path"] + bad[j]["doe_path"][:1]
    else:
        bad[j]["grat"] = None
    with pytest.raises(ValueError, match="step %d .*phase row" % j):
        CS.df32_multi_key([plans[0], bad], "k11")


@pytest.mark.parametrize("kernel", ["k11", "k13"])
def test_df32_runs_count_the_grown_words(kernel):
    """df32_runs and the key's plan words count a phase step's grown
    words: 2 for the grating term, 4 nd for the DOE, 2 for a phase
    cylinder's bc; a plan list runs in as many balanced runs as the
    parameter limit asks at those words."""
    _, ttab, _, _, _, plan = _case("doe toroid cylinder", True)
    words, flags = CD.pack_plan(plan, "cpu")
    fl = flags.tolist()
    assert [CD.step_words(f) for f in fl] == [
        CD.DW + CD.CYL_WORDS + 2 + 4*2, CD.DW]
    _, _, _, _, _, gplan = _case("grating y-cylinder", True)
    assert CD.step_words(CD.pack_plan(gplan, "cpu")[1].tolist()[0]) == \
        CD.DW + CD.CYL_WORDS + 2 + 2
    key = CS.df32_multi_key([plan], kernel)
    assert key.plan_words == words.numel() == sum(map(CD.step_words, fl))
    per = key.plan_words*4
    most = (CS.PARAM_LIMIT - CS.DF32_PARAM_BYTES[kernel])//per
    n = most + 3
    runs = CS.df32_runs((tuple(fl),)*n, kernel)
    assert len(runs) == 2 and runs[-1][1] == n
    assert max(b - a for a, b in runs) <= most


def test_cpu_wrappers_equal_plain():
    """K10-K13's wrappers on a CPU bundle of the hybrid achromat return
    their plain versions' results (its three wavelengths' plans for
    K11/K13) and count no launch."""
    s = PHASE_LENSES["hybrid_achromat"](jro)
    plans = [D.plan(TT.table_from_numpy(s.table(lam)), fast=True)
             for lam in s.wavelengths]
    y, u = _bundle(6., .01)
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
