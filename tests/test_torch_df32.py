"""rayopt_tpu_torch's double-single (df32) parity engine against the JAX
package's eager df32, on the CPU.

The port's plain versions (ops.df32: the arithmetic, `plan`, the trace
and the merit) must give the JAX package's hi and lo words exactly:
both run one rounded float32 operation at a time (the JAX side
eagerly, not in interpret-mode Pallas, whose XLA fusion contracts the
error-free transforms on the CPU: tests/test_df32.py).  The kernels
K10-K13 themselves run only on a CUDA card (tests/test_torch_cuda.py);
here the wrappers take the plain versions, and a model of the kernel's
packed-plan decoding is held against the plain trace.  Each test
states its tolerance.
"""

import numpy as np
import pytest
import torch

import rayopt_tpu  # noqa: F401
from rayopt_tpu import models as jmodels
from rayopt_tpu.ops import df32 as JD

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.ops import cuda_df32 as CD
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops import tables as TT
from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
from rayopt_tpu_torch.ops.geometric import trace_rays_final

from test_torch_cuda import vocabulary_table

F64_ATOL = 1e-10     # df32 positions against the float64 trace, mm
F64_RMS_REL = 1e-11  # df32 spot RMS against the float64 trace
MERIT_REL = 1e-13    # df32 moments against the JAX package's


@pytest.fixture(autouse=True)
def _one_thread():
    # several test workers import both frameworks at once
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    yield
    set_default_device(old)


def _pair(j):
    """A JAX df32 pair as torch tensors."""
    return tuple(torch.from_numpy(np.array(w, dtype=np.float32)) for w in j)


def _same_words(got, want):
    """True when two df32 pairs (torch, or JAX carried by _pair) hold
    identical words (NaN where the other is NaN)."""
    for g, w in zip(got, want):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return False
        live = ~torch.isnan(g)
        if not torch.equal(g[live], w[live]):
            return False
    return True


def _operands(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    a64 = rng.uniform(1e-2, 100, n)*rng.choice([-1, 1], n)
    b64 = rng.uniform(.01, 100, n)
    return a64, b64


# -- the arithmetic ----------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "div1", "sqr",
                                "sqrt", "sqrt1", "two_prod"])
def test_arithmetic_words_match_jax(op):
    """Every hi and lo word equals the JAX package's eager df32 (signed
    operands for the binary operations, positive for the roots)."""
    a64, b64 = _operands()
    ja, jb = JD.from_f64(a64), JD.from_f64(b64)
    ta = D.from_f64(torch.from_numpy(a64))
    tb = D.from_f64(torch.from_numpy(b64))
    assert _same_words(ta, _pair(ja)) and _same_words(tb, _pair(jb))
    if op == "two_prod":
        got, want = D.two_prod(ta[0], tb[0]), JD.two_prod(ja[0], jb[0])
    elif op in ("sqr", "sqrt", "sqrt1"):
        got, want = getattr(D, op)(tb), getattr(JD, op)(jb)
    else:
        got, want = getattr(D, op)(ta, tb), getattr(JD, op)(ja, jb)
    assert _same_words(got, _pair(want))


def test_sqrt_seed_routed_through_float64_is_what_matches(monkeypatch):
    """The float32 root seed taken in float64 and rounded once is the
    correctly rounded root, which jnp.sqrt gives: with it df32 sqrt
    matches JAX word for word.  A seed one ulp off changes the words,
    and where torch's own float32 sqrt is not correctly rounded (on
    some CPUs) a sqrt seeded with it differs from JAX there."""
    _, b64 = _operands(20000, seed=3)
    jb = JD.from_f64(b64)
    tb = D.from_f64(torch.from_numpy(b64))
    want = _pair(JD.sqrt(jb))
    seed = D._sqrt_seed(tb[0])
    assert torch.equal(seed, _pair((np.sqrt(np.asarray(jb[0])),))[0])
    assert _same_words(D.sqrt(tb), want)
    off_seed = torch.sqrt(tb[0]) != seed
    want1 = _pair(JD.sqrt1(jb))

    def changed(got, ref):
        return (got[0] != ref[0]) | (got[1] != ref[1])
    # one ulp above the correctly rounded seed: the words move on ~40%
    # (two rounds) and ~85% (one round) of these inputs
    monkeypatch.setattr(D, "_sqrt_seed", lambda x: torch.nextafter(
        torch.sqrt(x.double()).float(), torch.full_like(x, np.inf)))
    assert changed(D.sqrt(tb), want).float().mean() > .2
    assert changed(D.sqrt1(tb), want1).float().mean() > .5
    # torch's float32 sqrt as the seed: the words move only where that
    # seed is off, and there for many inputs
    monkeypatch.setattr(D, "_sqrt_seed", torch.sqrt)
    moved = changed(D.sqrt1(tb), want1)
    assert not bool(moved[~off_seed].any())
    if bool(off_seed.any()):
        assert moved[off_seed].float().mean() > .3


def test_const_and_state_round_trip():
    """from_f64/to_f64 and state_from_f64 keep the float64 value to
    2^-47 relative and the tensors' device; const equals JAX's."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1e6, 1e6, 1000)
    back = D.to_f64(D.from_f64(torch.from_numpy(x))).numpy()
    assert np.abs((back - x)/x).max() < 2**-46
    for v in (0., 1/3., -123.456789, 1e-30):
        assert D.const(v) == JD.const(v)
    y, u = torch.from_numpy(rng.normal(size=(8, 3))), torch.zeros((8, 3),
                                                                  dtype=torch.float64)
    st = D.state_from_f64(y, u)
    assert len(st) == 6 and all(w.dtype == torch.float32 and w.device == y.device
                                for c in st for w in c)


# -- systems ------------------------------------------------------------------

def _tilted_cooke():
    s = jmodels.cooke_triplet()
    s[2].angles = (.05, -.02, 0.)
    s[4].direction = (.01, 0., 1.)
    return s


# (JAX system factory, bundle half-width mm, clip)
SYSTEMS = {
    "double_gauss": (jmodels.double_gauss, 11.6*.85, False),
    "cooke": (jmodels.cooke_triplet, 5.*.85, False),
    "tilted_cooke": (_tilted_cooke, 4., False),
    "parabolic_mirror": (jmodels.parabolic_mirror, 40., False),
    "clipped_cooke": (jmodels.cooke_triplet, 7., True),
}


def _bundle(half, n=512, seed=7):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 3))
    y[:, :2] = rng.uniform(-1, 1, (n, 2))*half
    u = np.zeros((n, 3))
    u[:, 2] = 1.
    return y, u


def _case(name, fast):
    make, half, clip = SYSTEMS[name]
    jtab = make().table()
    ttab = TT.table_from_numpy(jtab)
    y, u = _bundle(half)
    return (jtab, ttab, y, u, JD.plan(jtab, clip=clip, fast=fast),
            D.plan(ttab, clip=clip, fast=fast))


def _same_const(got, want):
    if got is None or want is None:
        return got is None and want is None
    if isinstance(got[0], tuple):
        return all(_same_const(g, w) for g, w in zip(got, want))
    return (np.float32(got[0]).tobytes() == np.float32(want[0]).tobytes()
            and np.float32(got[1]).tobytes() == np.float32(want[1]).tobytes())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["double_gauss", "cooke", "tilted_cooke",
                                  "parabolic_mirror", "clipped_cooke"])
def test_plan_matches_jax(name, fast):
    """Step for step the same flags and the same (hi, lo) constants; the
    port's k1c is the constant the JAX step bakes from (1+k) and c."""
    _, _, _, _, jplan, tplan = _case(name, fast)
    assert len(jplan) == len(tplan)
    for js, ts in zip(jplan, tplan):
        for key in ("kind", "flat", "alternate", "clip", "fast"):
            assert js[key] == ts[key], key
        for key in ("c", "mu", "dz", "k1", "dxy", "rot_df", "nb"):
            assert _same_const(ts[key], js[key]), key
        assert (js["rotm"] is None) == (ts["rotm"] is None)
        if js["rotm"] is not None:
            assert np.array_equal(js["rotm"], ts["rotm"])
        assert (js["radius"] is None) == (ts["radius"] is None)
        if js["radius"] is not None:
            assert np.float32(js["radius"]) == ts["radius"]
        assert not js["asp"] and not js["asp_odd"]
        assert js["anam"] is None and js["grat"] is None
        assert js["doe"] is None
        if js["k1"] is not None:
            cf = [float(v[0]) + float(v[1]) for v in (js["k1"], js["c"])]
            assert _same_const(ts["k1c"], JD.const(cf[0]*cf[1]))
        else:
            assert ts["k1c"] is None
    names = {"tilted_cooke": "rot_df", "parabolic_mirror": "k1"}
    if name in names:
        assert any(ts[names[name]] is not None for ts in tplan)
    if name == "clipped_cooke":
        assert any(ts["radius"] is not None for ts in tplan)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["double_gauss", "cooke", "tilted_cooke",
                                  "parabolic_mirror", "clipped_cooke"])
def test_trace_words_match_jax(name, fast):
    """trace_df32_final (with the optical path) gives the JAX package's
    eager words exactly, NaN masks included."""
    _, _, y, u, jplan, tplan = _case(name, fast)
    jst, jt = JD.trace_df32_final(jplan, JD.state_from_f64(y, u),
                                  with_path=True)
    tst, tt = D.trace_df32_final(tplan, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=True)
    for g, w in zip((*tst, tt), (*jst, jt)):
        assert _same_words(g, _pair(w))
    live = ~torch.isnan(tst[3][0])
    assert int(live.sum()) > 64
    if name == "clipped_cooke":
        assert not bool(live.all())
    # without the path: the same state
    plain = D.trace_df32_final(tplan, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)))
    assert all(_same_words(a, b) for a, b in zip(plain, tst))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["double_gauss", "cooke"])
def test_trace_against_float64(name, fast):
    """The port's df32 trace against its own float64 plain trace: per
    ray within F64_ATOL mm, the spot RMS within F64_RMS_REL."""
    _, ttab, y, u, _, tplan = _case(name, fast)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    y64 = trace_rays_final(ttab, yt, ut)[0]
    out = D.trace_df32_final(tplan, D.state_from_f64(yt, ut))
    xd, yd = D.to_f64(out[0]), D.to_f64(out[1])
    good = torch.isfinite(y64[:, 0])
    assert int(good.sum()) > 256
    assert torch.equal(good, torch.isfinite(xd))
    assert float((xd[good] - y64[good, 0]).abs().max()) <= F64_ATOL
    assert float((yd[good] - y64[good, 1]).abs().max()) <= F64_ATOL

    def rms(px, py):
        return float(((px - px.mean())**2 + (py - py.mean())**2).mean()
                     .sqrt())
    r64 = rms(y64[good, 0], y64[good, 1])
    assert abs(rms(xd[good], yd[good]) - r64)/r64 <= F64_RMS_REL
    mom = D.trace_df32_merit(tplan, D.state_from_f64(yt, ut))
    assert abs(float(spot_rms_from_moments(*mom)) - r64)/r64 <= F64_RMS_REL


@pytest.mark.parametrize("name", ["double_gauss", "clipped_cooke"])
def test_merit_matches_jax(name):
    """trace_df32_merit: the five float64 moments of the JAX package's
    eager merit within MERIT_REL (the same pairwise df32 tree: in
    practice equal)."""
    _, _, y, u, jplan, tplan = _case(name, True)
    want = JD.trace_df32_merit(jplan, JD.state_from_f64(y, u))
    got = D.trace_df32_merit(tplan, D.state_from_f64(torch.from_numpy(y),
                                                     torch.from_numpy(u)))
    assert all(g.dtype == torch.float64 and g.dim() == 0 for g in got)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= MERIT_REL*abs(float(w))
    assert float(got[0]) < 512 if name == "clipped_cooke" else True


def test_multi_matches_jax_on_two_wavelengths():
    """trace_df32_final_multi on the Cooke at 2 wavelengths gives the
    JAX package's words per plan (with the path), and the plans
    differ."""
    js = jmodels.cooke_triplet()
    lams = js.wavelengths[:2]
    jplans = [JD.plan(js.table(lam)) for lam in lams]
    tplans = [D.plan(TT.table_from_numpy(js.table(lam))) for lam in lams]
    y, u = _bundle(4., n=256)
    want = JD.trace_df32_final_multi(jplans, JD.state_from_f64(y, u),
                                     with_path=True)
    got = D.trace_df32_final_multi(tplans, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=True)
    assert len(got) == 2
    for (gs, gt), (ws, wt) in zip(got, want):
        for g, w in zip((*gs, gt), (*ws, wt)):
            assert _same_words(g, _pair(w))
    assert not torch.equal(got[0][0][1][0], got[1][0][1][0])
    mom = D.trace_df32_merit_multi(tplans, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)))
    for p, m in zip(jplans, mom):
        w = JD.trace_df32_merit(p, JD.state_from_f64(y, u))
        assert all(abs(float(a) - float(b)) <= MERIT_REL*abs(float(b))
                   for a, b in zip(m, w))


@pytest.mark.parametrize("field,item", [("doe", "9.4"), ("xy_poly", "9.5"),
                                        ("grating_dy", "9.4")])
def test_plan_refuses_extended_rows(field, item):
    """No extended row is refused now: an XY-freeform row (item 9.5), a
    DOE and a grating row (item 9.4) are planned and traced as the JAX
    package's eager df32 does, word for word with the optical path (the
    aspheric and anamorphic rows: tests/test_torch_df32_newton.py; the
    phase rows in full: tests/test_torch_df32_phase.py; the freeform
    rows: tests/test_torch_df32_freeform.py)."""
    values = {"doe": [[0.], [1e-4], [0.]],
              "xy_poly": [[0., 0.], [1e-4, 0.], [0., 0.]],
              "grating_dy": [0., .001, 0.]}
    tab = TT.make_table([0., .02, 0.], distance=[0., 5., 40.],
                        mu=[1., 1/1.5, 1.5], **{field: values[field]})
    steps = D.plan(tab)
    assert (steps[0]["grat"] is not None) == (field == "grating_dy")
    assert (steps[0]["doe"] is not None) == (field == "doe")
    assert (steps[0]["anam"] is not None) == (item == "9.5")
    if item == "9.5":
        assert steps[0]["anam"]["mode"] == "freeform"
        assert steps[0]["anam"]["deg"] == 1
    jtab = TT.SurfaceTable(*(None if f is None else f.cpu().numpy()
                             for f in tab))
    y, u = _bundle(4., n=64)
    jst, jt = JD.trace_df32_final(JD.plan(jtab), JD.state_from_f64(y, u),
                                  with_path=True)
    tst, tt = D.trace_df32_final(steps, D.state_from_f64(
        torch.from_numpy(y), torch.from_numpy(u)), with_path=True)
    for g, w in zip((*tst, tt), (*jst, jt)):
        assert _same_words(g, _pair(w))


# -- the wrappers on the CPU and the packed plan ----------------------------

def _torch_state(name):
    _, ttab, y, u, _, tplan = _case(name, True)
    return tplan, D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))


def test_cpu_wrappers_equal_plain():
    """On a CPU bundle each wrapper returns its plain version's result
    and counts no launch."""
    plan, st = _torch_state("cooke")
    js = jmodels.cooke_triplet()
    plans = [D.plan(TT.table_from_numpy(js.table(lam)))
             for lam in js.wavelengths]
    before = [f.launches for f in (CD.trace_final_df32, CD.trace_multi_df32,
                                   CD.trace_merit_df32,
                                   CD.trace_merit_multi_df32)]
    for wp in (False, True):
        got = CD.trace_final_df32(plan, st, with_path=wp)
        want = D.trace_df32_final(plan, st, with_path=wp)
        gw = (*got[0], got[1]) if wp else got
        ww = (*want[0], want[1]) if wp else want
        assert all(_same_words(a, b) for a, b in zip(gw, ww))
        got = CD.trace_multi_df32(plans, st, with_path=wp)
        want = D.trace_df32_final_multi(plans, st, with_path=wp)
        assert len(got) == len(plans)
        for g, w in zip(got, want):
            gw = (*g[0], g[1]) if wp else g
            ww = (*w[0], w[1]) if wp else w
            assert all(_same_words(a, b) for a, b in zip(gw, ww))
    assert all(torch.equal(a, b) for a, b in zip(
        CD.trace_merit_df32(plan, st), D.trace_df32_merit(plan, st)))
    for g, w in zip(CD.trace_merit_multi_df32(plans, st),
                    D.trace_df32_merit_multi(plans, st)):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    after = [f.launches for f in (CD.trace_final_df32, CD.trace_multi_df32,
                                  CD.trace_merit_df32,
                                  CD.trace_merit_multi_df32)]
    assert after == before


def test_wrappers_refuse_bad_states():
    plan, st = _torch_state("cooke")
    with pytest.raises(ValueError, match="6"):
        CD.trace_final_df32(plan, st[:5])
    with pytest.raises(TypeError, match="float32"):
        CD.trace_merit_df32(plan, st[:5] + ((st[5][0].double(), st[5][1]),))
    with pytest.raises(ValueError, match="contiguous"):
        CD.trace_final_df32(plan, tuple(
            (torch.stack([h, h], 1)[:, 0], lo) for h, lo in st))
    with pytest.raises(ValueError, match="step count"):
        CD.pack_plan([plan, plan[:-1]], "cpu")


def _model_trace(words, flags, state, with_path):
    """csrc/df32_spec.cuh's trace_plan (one plan's chain, then the last
    step's frame), decoding the packed plan as the kernel does (flag
    bits, word offsets, permutation codes), on the plain df32
    operations."""
    one = (torch.tensor(1., dtype=torch.float32),
           torch.tensor(0., dtype=torch.float32))

    def ld(w, i):
        return w[i], w[i + 1]

    def perm(fl, v, t):
        out = [None]*3
        for r in range(3):
            code = (fl >> (CD.G_PERM_SHIFT + 3*r)) & 7
            if t:
                out[code & 3] = D.neg(v[r]) if code & 4 else v[r]
            else:
                out[r] = D.neg(v[code & 3]) if code & 4 else v[code & 3]
        return tuple(out)

    def rot(w, v, t):
        def r_(i, j):
            return ld(w, CD.W_ROT + 2*(3*j + i if t else 3*i + j))
        return tuple(D.add(D.add(D.mul(r_(i, 0), v[0]),
                                 D.mul(r_(i, 1), v[1])),
                           D.mul(r_(i, 2), v[2])) for i in range(3))

    def frame(fl, w, pos, dirs, t):
        if fl & CD.G_PERM:
            return perm(fl, pos, t), perm(fl, dirs, t)
        if fl & CD.G_ROT:
            return rot(w, pos, t), rot(w, dirs, t)
        return pos, dirs

    pos, dirs = tuple(state[:3]), tuple(state[3:])
    tacc = D.zero_like(state[0])
    # each step's words start where the words of the steps before end
    at = np.cumsum([0] + [CD.step_words(f) for f in flags.tolist()])
    for j, fl in enumerate(flags.tolist()):
        w = words[at[j]:at[j + 1]]
        fast = bool(fl & CD.G_FAST)
        dv, sq = (D.div1, D.sqrt1) if fast else (D.div, D.sqrt)
        x, y, z = pos
        z = D.sub(z, ld(w, CD.W_DZ))
        if fl & CD.G_OFF_AXIS:
            x, y = D.sub(x, ld(w, CD.W_DXY)), D.sub(y, ld(w, CD.W_DXY + 2))
        (x, y, z), (ux, uy, uz) = frame(fl, w, (x, y, z), dirs, False)
        c, conic = ld(w, CD.W_C), fl & CD.G_CONIC
        if fl & CD.G_FLAT:
            s = D.neg(dv(z, uz))
        else:
            if conic:
                k1 = ld(w, CD.W_K1)
                kz = D.mul(k1, z)
                uy_ = D._dot3(ux, uy, uz, x, y, kz)
                uu = D.add(D.add(D.sqr(ux), D.sqr(uy)), D.mul(k1, D.sqr(uz)))
                yy = D._dot3(x, y, z, x, y, kz)
                e_q = D.mul(c, uu)
            else:
                uy_ = D._dot3(ux, uy, uz, x, y, z)
                yy = D._dot3(x, y, z, x, y, z)
                e_q = (c[0].expand_as(x[0]), c[1].expand_as(x[0]))
            d = D.sub(D.mul(c, uy_), uz)
            f = D.sub(D.mul(c, yy), D.scale(z, 2.))
            g = sq(D.sub(D.sqr(d), D.mul(e_q, f)))
            if fl & CD.G_ALTERNATE:
                s = dv(D.neg(D.sub(d, g)), e_q)
            else:
                stable = d[0] < 0
                s = dv(D.where(stable, f, D.neg(D.add(d, g))),
                       D.where(stable, D.sub(g, d), e_q))
        x, y, z = (D.add(p, D.mul(s, q)) for p, q in ((x, ux), (y, uy),
                                                       (z, uz)))
        if fl & CD.G_CLIP:
            bad = x[0]*x[0] + y[0]*y[0] > w[CD.W_RAD]
            nan = torch.full_like(x[0], float("nan"))
            ux, uy, uz = (D.where(bad, (nan, nan), q) for q in (ux, uy, uz))
        kind, flat = fl & 3, bool(fl & CD.G_FLAT)
        if kind:
            unit = not conic or flat
            if not flat:
                nx, ny = D.neg(D.mul(c, x)), D.neg(D.mul(c, y))
                nzv = D.sub(one, D.mul(ld(w, CD.W_K1C) if conic else c, z))
                dot = D.add(D.add(D.mul(ux, nx), D.mul(uy, ny)),
                            D.mul(uz, nzv))
                nn = (None if unit else
                      D.add(D.add(D.sqr(nx), D.sqr(ny)), D.sqr(nzv)))
            else:
                dot = uz
            if kind == 2:
                a2 = D.scale(dot if unit else dv(dot, nn), 2.)
                if flat:
                    uz = D.sub(uz, a2)
                else:
                    ux, uy, uz = (D.sub(q, D.mul(a2, m)) for q, m in
                                  ((ux, nx), (uy, ny), (uz, nzv)))
            else:
                mu = ld(w, CD.W_MU)
                b0 = D.sub(D.sqr(mu), one)
                if unit:
                    a, b = D.mul(mu, dot), b0
                else:
                    inv = dv(one, nn)
                    a, b = D.mul(D.mul(mu, dot), inv), D.mul(b0, inv)
                g = D.sub(sq(D.sub(D.sqr(a), b)), a)
                if flat:
                    ux, uy, uz = D.mul(mu, ux), D.mul(mu, uy), D.add(
                        D.mul(mu, uz), g)
                else:
                    ux, uy, uz = (D.add(D.mul(mu, q), D.mul(g, m)) for q, m in
                                  ((ux, nx), (uy, ny), (uz, nzv)))
        pos, dirs = frame(fl, w, (x, y, z), (ux, uy, uz), True)
        if with_path:
            tacc = D.add(tacc, D.mul(s, ld(w, CD.W_NB)))
    pos, dirs = frame(flags[-1].item(), words[at[-2]:], pos, dirs, False)
    return (*pos, *dirs), tacc


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_packed_plan_decodes_like_the_kernel(fast, clip):
    """pack_plan's words and flags, read the way csrc/df32_spec.cuh reads
    them, trace the vocabulary table to the plain trace's words exactly;
    the JAX package's eager trace of the same table gives them too."""
    tab = vocabulary_table()
    steps = D.plan(tab, clip=clip, fast=fast)
    assert any(st["rotm"] is not None for st in steps)
    assert any(st["rot_df"] is not None for st in steps)
    assert any(st["kind"] == 2 and st["k1"] is not None for st in steps)
    assert any(st["alternate"] for st in steps)
    assert steps[-1]["rot_df"] is not None
    words, flags = CD.pack_plan(steps, "cpu")
    # no figure: DW words a step
    assert words.shape == (len(steps)*CD.DW,) and flags.dtype == torch.int64
    assert all(CD.step_words(f) == CD.DW for f in flags.tolist())
    rng = np.random.default_rng(5)
    y = np.zeros((256, 3))
    y[:, :2] = rng.uniform(-1, 1, (256, 2))*6.
    u = np.zeros((256, 3))
    u[:, 2] = 1.
    st = D.state_from_f64(torch.from_numpy(y), torch.from_numpy(u))
    want, tw = D.trace_df32_final(steps, st, with_path=True)
    got, tg = _model_trace(words, flags, st, True)
    assert all(_same_words(a, b) for a, b in zip((*got, tg), (*want, tw)))
    live = ~torch.isnan(want[3][0])
    assert int(live.sum()) > 32
    if clip:
        assert not bool(live.all())
    jst, jt = JD.trace_df32_final(
        JD.plan(TT.SurfaceTable(*(None if f is None else f.numpy()
                                  for f in tab)), clip=clip, fast=fast),
        JD.state_from_f64(y, u), with_path=True)
    assert all(_same_words(a, _pair(b)) for a, b in zip((*want, tw),
                                                        (*jst, jt)))


def test_pack_plan_stacks_plans():
    js = jmodels.double_gauss()
    plans = [D.plan(TT.table_from_numpy(js.table(lam)), fast=True)
             for lam in js.wavelengths]
    words, flags = CD.pack_plan(plans, "cpu")
    assert words.shape == (3, len(plans[0])*CD.DW)
    assert flags.shape == (3, len(plans[0]))
    one, fl = CD.pack_plan(plans[1], "cpu")
    assert torch.equal(one, words[1]) and torch.equal(fl, flags[1])
    assert bool((flags & CD.G_FAST).all())
    # the wavelengths differ in mu only
    steps = words.view(3, len(plans[0]), CD.DW)
    assert not torch.equal(steps[0, :, CD.W_MU], steps[1, :, CD.W_MU])

