"""Double-single ("df32") arithmetic and the parity-grade trace, in
plain PyTorch.

The counterpart of the JAX package's rayopt_tpu.ops.df32, with the
same names.  A df32 number is an (hi, lo) pair of float32 tensors whose
sum carries ~2^-47 relative precision; the error-free transforms
(Knuth's two_sum, Dekker's split and two_prod) build add, mul, div and
sqrt from rounded float32 operations.  `plan` bakes a table into
per-surface df32 constants and static flags; `trace_df32_final` runs
the transfer-intercept-refract chain over those steps and
`trace_df32_merit` reduces the traced rays to five spot moments with
pairwise df32 sums, promoted exactly to float64.

These are the plain versions of the CUDA kernels K10-K13
(csrc/df32_spec.cuh, wrapped in ops.cuda_df32), and they match them,
and the JAX package's eager df32, word for word (the kernels form
two_prod's error word with one exact fused multiply-add, the same word
as Dekker's split here).  That rests on three rules:

* one torch operation per float32 operation: every rounding happens
  where the code says (no addcmul, no alpha=, no torch.compile, which
  would contract a product into an exact fused multiply-add and break
  the error-free transforms);
* true division (Tensor.__truediv__ / torch.div) for every quotient:
  `scalar / tensor` would run as tensor.reciprocal() * scalar, two
  roundings;
* the float32 square-root seed is taken in float64 and rounded once,
  `torch.sqrt(a.double()).float()`, which is the correctly rounded
  float32 root (53 >= 2*24 + 2 bits); torch's float32 sqrt on the CPU
  is not always correctly rounded.

The surface vocabulary is that of the fused kernel K1: flat, spherical
and conic rows, refraction, mirrors, `alternate` intersections,
decenters, exact signed-permutation folds and general tilts, the
aperture clip, and the `fast` one-round div/sqrt refinements.  Rows
with aspheric, anamorphic, grating, DOE or freeform figures raise
NotImplementedError (ROADMAP Queue 1 item 9).

On a CUDA card with native float64 the package's parity trace
(ops.geometric.trace_rays_final_fast(precision="parity")) runs the
float64 K1, as the JAX package runs native float64 wherever float64 is
not emulated; this module is the df32 engine for callers that ask for
it by name.
"""

import numpy as np
import torch

from .tables import lower_pose

_SPLITTER = 4097.  # 2^12 + 1 (f32 has a 24-bit significand)


# -- error-free transforms -------------------------------------------------

def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """Assumes |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLITTER*a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    p = a*b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah*bh - p) + ah*bl + al*bh) + al*bl


# -- df32 numbers: (hi, lo) pairs ------------------------------------------

def const(v):
    """Split a float64 scalar into an exact (hi, lo) pair of NumPy
    float32 scalars (the plan's constants)."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return hi, lo


def from_f64(x):
    """Split a float64 tensor into an (hi, lo) float32 pair, exactly,
    on its device."""
    x = torch.as_tensor(x, dtype=torch.float64)
    hi = x.float()
    return hi, (x - hi.double()).float()


def to_f64(a):
    """The float64 value hi + lo of a pair, on its device."""
    return torch.as_tensor(a[0]).double() + torch.as_tensor(a[1]).double()


def zero_like(a):
    z = torch.zeros_like(a[0])
    return z, z


def neg(a):
    return -a[0], -a[1]


def add(a, b):
    s, e = two_sum(a[0], b[0])
    return quick_two_sum(s, e + (a[1] + b[1]))


def sub(a, b):
    return add(a, neg(b))


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    return quick_two_sum(p, e + (a[0]*b[1] + a[1]*b[0]))


def sqr(a):
    p, e = two_prod(a[0], a[0])
    return quick_two_sum(p, e + 2*(a[0]*a[1]))


def scale(a, s):
    """Multiply by an exact power of two (or other exact f32)."""
    return a[0]*s, a[1]*s


def _sqrt_seed(x):
    """The correctly rounded float32 square root (NaN below zero)."""
    return torch.sqrt(x.double()).float()


def _half_over(s1, ok):
    """0.5/s1 where ok, else 0, by true division."""
    half = torch.full_like(s1, .5)
    return torch.where(ok, half/torch.where(ok, s1, torch.ones_like(s1)),
                       torch.zeros_like(s1))


def div(a, b):
    """Two refinement rounds (the reference's; one round already
    reaches ~1e-12 from a correctly rounded seed, `div1`)."""
    zero = torch.zeros_like(a[0])
    q1 = a[0]/b[0]
    r = sub(a, mul((q1, zero), b))
    q = quick_two_sum(q1, (r[0] + r[1])/b[0])
    r = sub(a, mul(q, b))
    return add(q, ((r[0] + r[1])/b[0], zero))


def sqrt(a):
    """Two Karp-Markstein rounds.  NaN-deliberate: a negative hi word
    yields NaN like torch.sqrt."""
    zero = torch.zeros_like(a[0])
    s1 = _sqrt_seed(a[0])
    inv2 = _half_over(s1, s1 > 0)
    r = sub(a, sqr((s1, zero)))
    s = quick_two_sum(s1, (r[0] + r[1])*inv2)
    r = sub(a, sqr(s))
    return add(s, ((r[0] + r[1])*inv2, zero))


def div1(a, b):
    """One-round division: ~1e-12 relative.  The `fast` plan mode uses
    it."""
    q1 = a[0]/b[0]
    r = sub(a, mul((q1, torch.zeros_like(q1)), b))
    return quick_two_sum(q1, (r[0] + r[1])/b[0])


def sqrt1(a):
    """One Karp-Markstein round.  Used by the `fast` plan mode."""
    zero = torch.zeros_like(a[0])
    s1 = _sqrt_seed(a[0])
    inv2 = _half_over(s1, s1 > 0)
    r = sub(a, sqr((s1, zero)))
    return quick_two_sum(s1, (r[0] + r[1])*inv2)


def where(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


# -- the extended-precision surface chain ----------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def _apply_signed(R, vx, vy, vz):
    """Apply a signed permutation matrix (one +-1 per row) to a
    component triple -- exact in df32 (pure sign flips/swaps)."""
    comps = (vx, vy, vz)
    out = []
    for row in R:
        k = int(np.flatnonzero(row)[0])
        out.append(comps[k] if row[k] > 0 else neg(comps[k]))
    return tuple(out)


def _apply_rot_df(R, vx, vy, vz):
    """Full 3x3 rotation in df32: R is a 3x3 nest of (hi, lo) consts."""
    out = []
    for r in range(3):
        acc = mul(R[r][0], vx)
        acc = add(acc, mul(R[r][1], vy))
        acc = add(acc, mul(R[r][2], vz))
        out.append(acc)
    return tuple(out)


def _surface_df(state, st):
    """One transfer-intercept-refract step in df32 for a planned step
    `st` whose constants are 0-d float32 tensors (`_on_device`).
    Mirrors the reference's _surface_df for flat, spherical and conic
    rows; returns the new state and the intercept distance s."""
    dv, sq = (div1, sqrt1) if st["fast"] else (div, sqrt)
    c, mu, kind, flat = st["c"], st["mu"], st["kind"], st["flat"]
    k1, rotm, rot_df = st["k1"], st["rotm"], st["rot_df"]
    x, y, z, ux, uy, uz = state
    z = sub(z, st["dz"])
    if st["dxy"] is not None:
        x = sub(x, st["dxy"][0])
        y = sub(y, st["dxy"][1])
    if rotm is not None:
        x, y, z = _apply_signed(rotm, x, y, z)
        ux, uy, uz = _apply_signed(rotm, ux, uy, uz)
    elif rot_df is not None:
        x, y, z = _apply_rot_df(rot_df, x, y, z)
        ux, uy, uz = _apply_rot_df(rot_df, ux, uy, uz)
    conic = k1 is not None
    if flat:
        s = neg(dv(z, uz))
    else:
        # closed-form conic intercept, unit |u|; the two algebraically
        # equal root forms -(d+g)/e and f/(g-d) are each stable in the
        # complementary sign regime of d (cancellation-free choice)
        if conic:
            kz = mul(k1, z)
            uy_ = _dot3(ux, uy, uz, x, y, kz)
            uu = add(add(sqr(ux), sqr(uy)), mul(k1, sqr(uz)))
            yy = _dot3(x, y, z, x, y, kz)
            e_q = mul(c, uu)
        else:
            uy_ = _dot3(ux, uy, uz, x, y, z)
            yy = _dot3(x, y, z, x, y, z)
            e_q = (c[0].expand_as(x[0]), c[1].expand_as(x[0]))
        d = sub(mul(c, uy_), uz)
        f = sub(mul(c, yy), scale(z, 2.))
        disc = sub(sqr(d), mul(e_q, f))
        g = sq(disc)
        if st["alternate"]:
            s = dv(neg(sub(d, g)), e_q)
        else:
            stable = d[0] < 0
            num = where(stable, f, neg(add(d, g)))
            den = where(stable, sub(g, d), e_q)
            s = dv(num, den)
    x = add(x, mul(s, ux))
    y = add(y, mul(s, uy))
    z = add(z, mul(s, uz))
    if st["clip"] and st["radius"] is not None:
        # aperture clip: NaN the direction of rays outside the radius
        # (membership decided on the hi words -- f32 edge precision)
        bad = x[0]*x[0] + y[0]*y[0] > st["radius"]
        nan = torch.full_like(x[0], float("nan"))
        ux = where(bad, (nan, nan), ux)
        uy = where(bad, (nan, nan), uy)
        uz = where(bad, (nan, nan), uz)
    one = st["one"]
    if kind == 0:
        vx, vy, vz = ux, uy, uz
    else:
        nx = ny = nzv = None
        if not flat:
            # polynomial implicit-gradient normal N = (-c x, -c y,
            # 1 - c(1+k) z); |N| == 1 exactly on a sphere
            nx, ny = neg(mul(c, x)), neg(mul(c, y))
            if conic:
                nzv = sub(one, mul(st["k1c"], z))
            else:
                nzv = sub(one, mul(c, z))
            dot = add(add(mul(ux, nx), mul(uy, ny)), mul(uz, nzv))
            nn = add(add(sqr(nx), sqr(ny)), sqr(nzv)) if conic else None
        else:
            nn, dot = None, uz
        if kind == 2:
            a2 = scale(dot, 2.) if nn is None else scale(dv(dot, nn), 2.)
            if flat:
                vx, vy, vz = ux, uy, sub(uz, a2)
            else:
                vx = sub(ux, mul(a2, nx))
                vy = sub(uy, mul(a2, ny))
                vz = sub(uz, mul(a2, nzv))
        else:
            # refraction: mu > 0 here (mirrors handled above)
            b0 = sub(sqr(mu), one)
            if nn is None:
                a = mul(mu, dot)
                b = b0
            else:
                inv_nn = dv(one, nn)
                a = mul(mul(mu, dot), inv_nn)
                b = mul(b0, inv_nn)
            g = sub(sq(sub(sqr(a), b)), a)
            if flat:
                vx, vy = mul(mu, ux), mul(mu, uy)
                vz = add(mul(mu, uz), g)
            else:
                vx = add(mul(mu, ux), mul(g, nx))
                vy = add(mul(mu, uy), mul(g, ny))
                vz = add(mul(mu, uz), mul(g, nzv))
    if rotm is not None:
        # back to the running (global) frame: from_normal = R^T
        x, y, z = _apply_signed(rotm.T, x, y, z)
        vx, vy, vz = _apply_signed(rotm.T, vx, vy, vz)
    elif rot_df is not None:
        rt = tuple(tuple(rot_df[r][col] for r in range(3))
                   for col in range(3))
        x, y, z = _apply_rot_df(rt, x, y, z)
        vx, vy, vz = _apply_rot_df(rt, vx, vy, vz)
    return (x, y, z, vx, vy, vz), s


_ONE = (np.float32(1.), np.float32(0.))
#: step keys that hold df32 constants (pairs, or nests of pairs)
_CONST_KEYS = ("c", "mu", "dz", "k1", "k1c", "nb", "dxy", "rot_df")
_EXTENDED = "ROADMAP Queue 1 item 9"


def _trim(coeffs):
    nz = int(np.max(np.nonzero(coeffs)[0]) + 1) if coeffs.any() else 0
    return coeffs[:nz]


def _host(table, name, shape_tail=()):
    v = getattr(table, name, None)
    if v is None:
        return np.zeros((table.curvature.shape[0],) + shape_tail)
    return v.detach().cpu().numpy().astype(np.float64)


def plan(table, clip=False, fast=False):
    """Host-side: per-surface df32 constants + static flags from a
    float64 SurfaceTable (on any device; read through .cpu()).

    Each step is a dict with the reference plan's keys for the K1
    vocabulary: c, mu, dz (df32 constants), kind (0 passthrough, 1
    refract, 2 mirror), flat, k1 = const(1 + conic) for a conic row
    (else None), k1c = const((1+k)c) baked from the df32 constants in
    float64 (the reference computes it inside its step), alternate,
    rotm (an exact signed permutation, integer 3x3) or rot_df (a 3x3
    nest of df32 constants), dxy (the decenter pair or None), radius
    (the float32 squared aperture radius when clipping, else None),
    clip, fast, and nb (n_before, for the optical path).

    fast=True bakes one-round div/sqrt refinements into every step
    (div1/sqrt1).  Rows that need the extended vocabulary raise
    NotImplementedError."""
    table = lower_pose(table)  # fold concrete tilt/decenter deltas
    curv = _host(table, "curvature")
    s_count = curv.shape[0]
    conic = _host(table, "conic")
    mu = _host(table, "mu")
    off = _host(table, "offset", (3,))
    rot = _host(table, "rot", (3, 3))
    rad = _host(table, "radius")
    alt = _host(table, "alternate")
    nbef = _host(table, "n_before")
    figures = {name: _host(table, name, (0,)) for name in
               ("aspherics", "aspherics_odd", "doe", "xy_poly")}
    figures.update({name: _host(table, name) for name in
                    ("curvature_dx", "conic_dx", "toroidal", "grating_dy")})
    steps = []
    for j in range(1, s_count):
        used = [name for name, v in figures.items()
                if v[j].size and _trim(np.atleast_1d(v[j])).size]
        if used:
            raise NotImplementedError(
                "df32 plan: row %d uses %s, which rayopt_tpu_torch does "
                "not trace yet (flat, spherical and conic rows only; %s)"
                % (j, "/".join(used), _EXTENDED))
        rotm = rot_df = None
        if not np.allclose(rot[j], np.eye(3)):
            ri = np.rint(rot[j]).astype(int)
            exact_flip = (np.abs(rot[j] - ri).max() < 1e-12
                          and (np.abs(ri).sum(0) == 1).all()
                          and (np.abs(ri).sum(1) == 1).all())
            if exact_flip:
                rotm = ri
            else:
                rot_df = tuple(tuple(const(rot[j][r, cc])
                                     for cc in range(3))
                               for r in range(3))
        dxy = None
        if off[j, 0] or off[j, 1]:
            dxy = (const(off[j, 0]), const(off[j, 1]))
        kind = 0 if mu[j] == 1. else (2 if mu[j] == -1. else 1)
        c = const(curv[j])
        k1 = const(1. + conic[j]) if conic[j] else None
        k1c = None
        if k1 is not None:
            k1c = const((float(k1[0]) + float(k1[1]))
                        * (float(c[0]) + float(c[1])))
        steps.append(dict(
            c=c, mu=const(abs(mu[j])), dz=const(off[j, 2]), kind=kind,
            flat=curv[j] == 0., k1=k1, k1c=k1c, alternate=bool(alt[j]),
            rotm=rotm, rot_df=rot_df, dxy=dxy,
            radius=(np.float32(rad[j])**2 if clip
                    and np.isfinite(rad[j]) else None),
            clip=clip, fast=fast, nb=const(nbef[j])))
    return steps


def _on_device(st, like):
    """The step with its df32 constants as 0-d float32 tensors on
    like's device (and the radius and 1.0 beside them)."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v[0], tuple):
            return tuple(conv(w) for w in v)
        return tuple(torch.tensor(float(w), dtype=torch.float32,
                                  device=like.device) for w in v)
    out = dict(st)
    for key in _CONST_KEYS:
        out[key] = conv(st[key])
    if st["radius"] is not None:
        out["radius"] = torch.tensor(float(st["radius"]),
                                     dtype=torch.float32, device=like.device)
    out["one"] = conv(_ONE)
    return out


def _to_last_frame(steps, state):
    """Rotate the running-frame state into the last surface's normal
    frame (what trace_components_final returns)."""
    last = steps[-1]
    if last["rotm"] is not None:
        return (*_apply_signed(last["rotm"], *state[:3]),
                *_apply_signed(last["rotm"], *state[3:]))
    if last["rot_df"] is not None:
        return (*_apply_rot_df(last["rot_df"], *state[:3]),
                *_apply_rot_df(last["rot_df"], *state[3:]))
    return state


def trace_df32_final(steps, state, with_path=False):
    """The df32 trace over the planned surface chain (plain version of
    K10).

    state: six (hi, lo) pairs of (N,) float32 tensors (state_from_f64).
    Returns the final state in the last surface's normal frame (like
    trace_components_final); with_path additionally returns the
    accumulated optical path as an (hi, lo) pair."""
    like = state[0][0]
    steps = [_on_device(st, like) for st in steps]
    tacc = zero_like(state[0])
    for st in steps:
        state, s = _surface_df(state, st)
        if with_path:
            tacc = add(tacc, mul(s, st["nb"]))
    state = _to_last_frame(steps, state)
    if with_path:
        return state, tacc
    return state


def trace_df32_final_multi(plans, state, with_path=False):
    """Polychromatic df32 trace (plain version of K11): the same input
    rays through several planned chains (one `plan` per wavelength).
    Returns one final state (or (state, path)) per plan."""
    return tuple(trace_df32_final(p, state, with_path=with_path)
                 for p in plans)


def state_from_f64(y, u):
    """(N, 3) float64 position/direction -> df32 component state, on
    the tensors' device."""
    comps = []
    for arr in (y, u):
        arr = torch.as_tensor(arr, dtype=torch.float64)
        for k in range(3):
            comps.append(from_f64(arr[:, k]))
    return tuple(comps)


def _df_sum_flat(hi, lo):
    """Pairwise df32 tree sum of (N,) words -> scalar pair.  Pads to a
    power of two with exact zeros."""
    n = hi.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        hi = torch.cat([hi, hi.new_zeros(p - n)])
        lo = torch.cat([lo, lo.new_zeros(p - n)])
    while p > 1:
        half = p // 2
        hi, lo = add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
        p = half
    return hi[0], lo[0]


def trace_df32_merit(steps, state):
    """Plain version of K12: trace, mask dead rays (x, y or uz hi word
    not finite), and reduce to (count, sum x, sum y, sum x^2, sum y^2)
    with full df32 pairwise accumulation, promoted exactly to float64
    (0-d tensors); feed ops.cuda_trace.spot_rms_from_moments."""
    st = trace_df32_final(steps, state)
    x, y, uz = st[0], st[1], st[5]
    good = (torch.isfinite(x[0]) & torch.isfinite(y[0])
            & torch.isfinite(uz[0]))

    def masked(a):
        zero = torch.zeros_like(a[0])
        return torch.where(good, a[0], zero), torch.where(good, a[1], zero)

    xm, ym = masked(x), masked(y)
    cnt = (good.to(torch.float32), torch.zeros_like(x[0]))
    out = []
    for m in (cnt, xm, ym, mul(xm, xm), mul(ym, ym)):
        hi, lo = _df_sum_flat(*m)
        out.append(hi.double() + lo.double())
    return tuple(out)


def trace_df32_merit_multi(plans, state):
    """Plain version of K13: trace_df32_merit for each plan."""
    return tuple(trace_df32_merit(p, state) for p in plans)
