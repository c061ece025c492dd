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

The surface vocabulary: flat, spherical and conic rows, even and odd
aspheric rows (ASPHERIC_ITERS df32 Newton rounds from the conic root,
then a residual test), conic cylinders (closed form) and biconics and
toroids, figured or not (a Newton seeded in float32, then polished in
df32), refraction, mirrors, `alternate` intersections, decenters,
exact signed-permutation folds and general tilts, the aperture clip,
the `fast` one-round div/sqrt refinements, and the phase rows: a linear
grating or a radial diffractive phase (DOE) on any of these substrates,
by the generalized grating solve (the DOE's kick in its b vector and
its phase psi(r^2) n_after/n_before folded into the step's length, so
that the optical path carries it), and the freeform rows: an XY
figure on a conic or aspheric base, by the same seeded Newton on the
base's sag less the figure's nonzero value terms, its normal the base's
less the slope terms (a freeform figure on an anamorphic base raises
NotImplementedError, as the reference's plan does).  The float32 seed
of the Newton keeps its own copies of the ops.kernels functions that
take a square root, in the JAX package's operation order and with the
correctly rounded root.

On a CUDA card with native float64 the package's parity trace
(ops.geometric.trace_rays_final_fast(precision="parity")) runs the
float64 K1, as the JAX package runs native float64 wherever float64 is
not emulated; this module is the df32 engine for callers that ask for
it by name.
"""

import numpy as np
import torch

from .kernels import _dpoly_xy, _poly_xy, _xy_terms, xy_degree
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


# -- aspheric figures in df32 -----------------------------------------------

ASPHERIC_ITERS = 8   # df32 Newton rounds of an aspheric row
ASPHERIC_TOL = 1e-9  # the residual test, as ops.kernels.ASPHERIC_TOL
ANAM_F32_ITERS = 6   # float32 Newton steps that seed an anamorphic row
ANAM_DF_ITERS = 2    # its df32 rounds (3 in the exact plan)
_TINY32 = np.float32(1e-30)


def _poly_even_df(r2, coeffs):
    """Horner over even powers: sum coeffs[i] * r2^(i+1)."""
    acc = None
    for ci in coeffs[::-1]:
        acc = ci if acc is None else add(mul(acc, r2), ci)
    return mul(acc, r2)


def _dpoly_even_df(r2, coeffs):
    """d/d(r) of the even polynomial divided by r:
    sum 2(i+1) coeffs[i] r2^i."""
    acc = None
    for i in range(len(coeffs) - 1, -1, -1):
        ci = scale(coeffs[i], 2.*(i + 1))
        acc = ci if acc is None else add(mul(acc, r2), ci)
    return acc


def _max_tiny(a):
    """Floor the pair at a tiny positive value (division guards; the
    floored case only arises for degenerate geometry).  NaN floors
    too."""
    ok = a[0] > _TINY32
    return (torch.where(ok, a[0], torch.full_like(a[0], _TINY32)),
            torch.where(ok, a[1], torch.zeros_like(a[1])))


def _poly_odd_df(r2, r, coeffs):
    """sum coeffs[j] * r^(2j+1) with r = sqrt(r2) precomputed."""
    acc = None
    for cj in coeffs[::-1]:
        acc = cj if acc is None else add(mul(acc, r2), cj)
    return mul(r, acc)


def _dpoly_odd_df(r2, r, coeffs, dv):
    """2 d/d(r2) of _poly_odd_df: P(r2)/r + 2 r P'(r2) (the vertex cusp
    of the r^1 term floored by _max_tiny)."""
    p = None
    for cj in coeffs[::-1]:
        p = cj if p is None else add(mul(p, r2), cj)
    dp = None
    for j in range(len(coeffs) - 1, 0, -1):
        cj = scale(coeffs[j], float(j))
        dp = cj if dp is None else add(mul(dp, r2), cj)
    out = dv(p, _max_tiny(r))
    if dp is not None:
        out = add(out, scale(mul(r, dp), 2.))
    return out


def _sag_df(x, y, z, c, k1, asp, asp_odd, one, dv, sq):
    """z - surface_sag(x, y) (kernels.sag in df32)."""
    r2 = add(sqr(x), sqr(y))
    cr2 = mul(c, r2)
    den = add(one, sq(sub(one, mul(k1, mul(c, cr2)))))
    e = sub(z, dv(cr2, den))
    if asp:
        e = sub(e, _poly_even_df(r2, asp))
    if asp_odd:
        e = sub(e, _poly_odd_df(r2, sq(r2), asp_odd))
    return e


def _normal_radial_df(x, y, c, k1, asp, asp_odd, one, dv, sq):
    """Radial factor of the normal (kernels.normal_radial in df32)."""
    r2 = add(sqr(x), sqr(y))
    e = neg(dv(c, sq(sub(one, mul(k1, mul(sqr(c), r2))))))
    if asp:
        e = sub(e, _dpoly_even_df(r2, asp))
    if asp_odd:
        e = sub(e, _dpoly_odd_df(r2, sq(r2), asp_odd, dv))
    return e


# -- anamorphic rows in df32 --------------------------------------------------
#
# Conic cylinders are quadrics in one transverse coordinate and take the
# conic's cancellation-free closed form.  Biconics and toroids (and the
# freeform rows below) run a mixed-precision Newton: the y-conic closed
# form seeds it in float32, ANAM_F32_ITERS float32 steps converge to
# float32 noise, and df_iters df32 rounds land at df32 precision.

def _sag_biconic_df(x, y, z, an, one, dv, sq):
    """z - biconic_sag (kernels.sag_biconic in df32)."""
    x2, y2 = sqr(x), sqr(y)
    a = add(mul(an["cx"], x2), mul(an["cy"], y2))
    b = add(mul(an["bxc"], x2), mul(an["byc"], y2))
    e = sub(z, dv(a, add(one, sq(sub(one, b)))))
    r2 = add(x2, y2)
    if an["asp"]:
        e = sub(e, _poly_even_df(r2, an["asp"]))
    if an["asp_odd"]:
        e = sub(e, _poly_odd_df(r2, sq(r2), an["asp_odd"]))
    return e


def _normal_biconic_df(x, y, an, one, dv, sq):
    """Transverse normal components (kernels.normal_biconic in df32):
    gx = -x (2 cx (1+s) + a bxc / s) / (1+s)^2, bxc = (1+kx) cx^2."""
    x2, y2 = sqr(x), sqr(y)
    a = add(mul(an["cx"], x2), mul(an["cy"], y2))
    b = add(mul(an["bxc"], x2), mul(an["byc"], y2))
    s = sq(sub(one, b))
    one_s = add(one, s)
    inv2 = sqr(dv(one, one_s))
    a_s = dv(a, _max_tiny(s))
    gx = neg(mul(x, mul(add(scale(mul(an["cx"], one_s), 2.),
                            mul(a_s, an["bxc"])), inv2)))
    gy = neg(mul(y, mul(add(scale(mul(an["cy"], one_s), 2.),
                            mul(a_s, an["byc"])), inv2)))
    r2 = add(x2, y2)
    d = None
    if an["asp"]:
        d = _dpoly_even_df(r2, an["asp"])
    if an["asp_odd"]:
        do = _dpoly_odd_df(r2, sq(r2), an["asp_odd"], dv)
        d = do if d is None else add(d, do)
    if d is not None:
        gx = sub(gx, mul(x, d))
        gy = sub(gy, mul(y, d))
    return gx, gy


def _ycurve_df(y, an, one, dv, sq):
    """(sag, d sag/dy) of the toroid's y-z generating curve in df32
    (kernels._ycurve)."""
    y2 = sqr(y)
    sqv = sq(sub(one, mul(an["byc"], y2)))
    zy = dv(mul(an["cy"], y2), add(one, sqv))
    dzy = dv(mul(an["cy"], y), _max_tiny(sqv))
    if an["asp"]:
        zy = add(zy, _poly_even_df(y2, an["asp"]))
        dzy = add(dzy, mul(y, _dpoly_even_df(y2, an["asp"])))
    if an["asp_odd"]:
        ya = sq(y2)
        zy = add(zy, _poly_odd_df(y2, ya, an["asp_odd"]))
        dzy = add(dzy, mul(y, _dpoly_odd_df(y2, ya, an["asp_odd"], dv)))
    return zy, dzy


def _sag_toroid_df(x, y, z, an, one, dv, sq):
    """z - toroidal_sag (kernels.sag_toroid in df32)."""
    zy, _ = _ycurve_df(y, an, one, dv, sq)
    crp = dv(an["cr"], sub(one, mul(an["cr"], zy)))
    x2 = sqr(x)
    w = sq(sub(one, mul(x2, sqr(crp))))
    return sub(sub(z, zy), dv(mul(crp, x2), add(one, w)))


def _normal_toroid_df(x, y, an, one, dv, sq):
    """(gx, gy) of the toroid normal (kernels.normal_toroid in df32)."""
    zy, dzy = _ycurve_df(y, an, one, dv, sq)
    crp = dv(an["cr"], sub(one, mul(an["cr"], zy)))
    w = _max_tiny(sq(sub(one, mul(sqr(x), sqr(crp)))))
    return neg(dv(mul(x, crp), w)), neg(dv(dzy, w))


def _xy_pows_df(v, deg):
    """[None, v, v^2, ..., v^deg] by repeated df32 products."""
    pows = [None, v]
    for _ in range(2, deg + 1):
        pows.append(mul(pows[-1], v))
    return pows


def _poly_xy_df(x, y, terms, deg):
    """sum c x^i y^j in df32 over `terms`, (df32 constant, i, j) triples
    in term order; a (0, 0) exponent broadcasts its constant (the slope
    lists hold them).  The sum starts from the first term."""
    xp = _xy_pows_df(x, deg)
    yp = _xy_pows_df(y, deg)
    acc = None
    for cdf, i, j in terms:
        if i == 0 and j == 0:
            t = (cdf[0].expand_as(x[0]), cdf[1].expand_as(x[0]))
        else:
            m = xp[i] if i else yp[j]
            if i and j:
                m = mul(m, yp[j])
            t = mul(cdf, m)
        acc = t if acc is None else add(acc, t)
    return acc


def _sag_freeform_df(x, y, z, an, one, dv, sq):
    """z - freeform sag: the conic/aspheric base (_sag_df) less the XY
    figure's value terms."""
    e = _sag_df(x, y, z, an["c"], an["k1"], an["asp"], an["asp_odd"], one,
                dv, sq)
    return sub(e, _poly_xy_df(x, y, an["xy"], an["deg"]))


def _normal_freeform_df(x, y, an, one, dv, sq):
    """(gx, gy) of the freeform normal: the base's radial factor times
    (x, y) less the XY figure's slope terms (their constants i a and j a
    baked by the plan)."""
    e = _normal_radial_df(x, y, an["c"], an["k1"], an["asp"], an["asp_odd"],
                          one, dv, sq)
    gx, gy = mul(x, e), mul(y, e)
    if an["xy_gx"]:
        gx = sub(gx, _poly_xy_df(x, y, an["xy_gx"], an["deg"]))
    if an["xy_gy"]:
        gy = sub(gy, _poly_xy_df(x, y, an["xy_gy"], an["deg"]))
    return gx, gy


def _anam_funcs_df(an, one, dv, sq):
    """(sag, normal) of a biconic, toroid or freeform row in df32."""
    if an["mode"] == "freeform":
        return (lambda x, y, z: _sag_freeform_df(x, y, z, an, one, dv, sq),
                lambda x, y: _normal_freeform_df(x, y, an, one, dv, sq))
    if an["mode"] == "toroid":
        return (lambda x, y, z: _sag_toroid_df(x, y, z, an, one, dv, sq),
                lambda x, y: _normal_toroid_df(x, y, an, one, dv, sq))
    return (lambda x, y, z: _sag_biconic_df(x, y, z, an, one, dv, sq),
            lambda x, y: _normal_biconic_df(x, y, an, one, dv, sq))


# -- the float32 seed of the anamorphic Newton --------------------------------
#
# The JAX package seeds it with its ops.kernels functions, run eagerly in
# float32 one operation at a time; these are their copies in the same
# operation order, on float32 tensors and 0-d float32 scalars (scalar
# products round in float32, as NumPy's float32 scalars do there), with
# the correctly rounded square root of _sqrt_seed.

def _sqrt0_32(x):
    # torch.clamp lets NaN through, as jnp.maximum
    return _sqrt_seed(torch.clamp(x, min=0.))


def _poly_even_32(r2, coeffs):
    d = torch.zeros_like(r2)
    for ci in coeffs[::-1]:
        d = (d + ci)*r2
    return d


def _dpoly_even_32(r2, coeffs):
    d = torch.zeros_like(r2)
    for i in range(len(coeffs) - 1, -1, -1):
        d = d*r2 + 2*(i + 1)*coeffs[i]
    return d


def _poly_odd_32(r2, coeffs):
    d = torch.zeros_like(r2)
    for cj in coeffs[::-1]:
        d = d*r2 + cj
    return _sqrt_seed(r2)*d


def _dpoly_odd_32(r2, coeffs):
    p = torch.zeros_like(r2)
    for cj in coeffs[::-1]:
        p = p*r2 + cj
    dp = torch.zeros_like(r2)
    for j in range(len(coeffs) - 1, 0, -1):
        dp = dp*r2 + j*coeffs[j]
    r = torch.clamp(_sqrt_seed(r2), min=_TINY32)
    return p/r + 2*r*dp


def _intercept_conic_32(x, y, z, ux, uy, uz, c, k, alt):
    """kernels.intercept_conic in float32: the cancellation-free closed
    form, the vertex plane where c == 0, NaN for a miss."""
    k1 = 1 + k
    uy_ = ux*x + uy*y + k1*uz*z
    uu = ux*ux + uy*uy + k1*uz*uz
    yy = x*x + y*y + k1*z*z
    d = c*uy_ - uz
    e = c*uu
    f = c*yy - 2*z
    disc = d*d - e*f
    g = _sqrt0_32(disc)*(1 - 2*alt)
    conj = (d*g <= 0) | (e == 0)
    num = torch.where(conj, f, -(d + g))
    den = torch.where(conj, g - d, e)
    s = num/torch.where(den == 0, torch.ones_like(den), den)
    uz_safe = torch.where(uz == 0, torch.ones_like(uz), uz)
    s = torch.where(c == 0, -z/uz_safe, s)
    return torch.where((c != 0) & (disc < 0), torch.full_like(s, np.nan), s)


def _sag_biconic_32(x, y, z, f):
    """kernels.sag_biconic in float32."""
    x2, y2 = x*x, y*y
    a = f["cx"]*x2 + f["cy"]*y2
    b = (1 + f["kx"])*f["cx"]*f["cx"]*x2 + (1 + f["ky"])*f["cy"]*f["cy"]*y2
    e = z - a/(1 + _sqrt0_32(1 - b))
    r2 = x2 + y2
    if f["asp"]:
        e = e - _poly_even_32(r2, f["asp"])
    if f["asp_odd"]:
        e = e - _poly_odd_32(r2, f["asp_odd"])
    return e


def _normal_biconic_32(x, y, f):
    """kernels.normal_biconic in float32."""
    cx, kx, cy, ky = f["cx"], f["kx"], f["cy"], f["ky"]
    x2, y2 = x*x, y*y
    a = cx*x2 + cy*y2
    b = (1 + kx)*cx*cx*x2 + (1 + ky)*cy*cy*y2
    s = _sqrt0_32(1 - b)
    s_safe = torch.clamp(s, min=_TINY32)
    inv = torch.ones_like(s)/(1 + s)
    gx = -(2*cx*x*(1 + s) + a*(1 + kx)*cx*cx*x/s_safe)*inv*inv
    gy = -(2*cy*y*(1 + s) + a*(1 + ky)*cy*cy*y/s_safe)*inv*inv
    r2 = x2 + y2
    if f["asp"]:
        d = _dpoly_even_32(r2, f["asp"])
        gx = gx - x*d
        gy = gy - y*d
    if f["asp_odd"]:
        d = _dpoly_odd_32(r2, f["asp_odd"])
        gx = gx - x*d
        gy = gy - y*d
    return gx, gy


def _ycurve_32(y, f):
    """kernels._ycurve in float32."""
    cy = f["cy"]
    y2 = y*y
    sq = _sqrt0_32(1 - (1 + f["ky"])*cy*cy*y2)
    zy = cy*y2/(1 + sq)
    dzy = cy*y/torch.clamp(sq, min=_TINY32)
    if f["asp"]:
        zy = zy + _poly_even_32(y2, f["asp"])
        dzy = dzy + y*_dpoly_even_32(y2, f["asp"])
    if f["asp_odd"]:
        zy = zy + _poly_odd_32(y2, f["asp_odd"])
        dzy = dzy + y*_dpoly_odd_32(y2, f["asp_odd"])
    return zy, dzy


def _sag_toroid_32(x, y, z, f):
    """kernels.sag_toroid in float32."""
    cr = f["cr"]
    zy, _ = _ycurve_32(y, f)
    crp = cr/(1 - cr*zy)
    x2 = x*x
    return z - zy - crp*x2/(1 + _sqrt0_32(1 - x2*crp*crp))


def _normal_toroid_32(x, y, f):
    """kernels.normal_toroid in float32."""
    cr = f["cr"]
    zy, dzy = _ycurve_32(y, f)
    crp = cr/(1 - cr*zy)
    w = torch.clamp(_sqrt0_32(1 - x*x*crp*crp), min=_TINY32)
    return -x*crp/w, -dzy/w


def _sag_32(x, y, z, f):
    """kernels.sag in float32: a freeform row's conic/aspheric base."""
    c = f["cy"]
    r2 = x*x + y*y
    e = z - c*r2/(1 + _sqrt0_32(1 - (1 + f["ky"])*c*c*r2))
    if f["asp"]:
        e = e - _poly_even_32(r2, f["asp"])
    if f["asp_odd"]:
        e = e - _poly_odd_32(r2, f["asp_odd"])
    return e


def _normal_radial_32(x, y, f):
    """kernels.normal_radial in float32."""
    c = f["cy"]
    r2 = x*x + y*y
    e = -c/_sqrt0_32(1 - (1 + f["ky"])*c*c*r2)
    if f["asp"]:
        e = e - _dpoly_even_32(r2, f["asp"])
    if f["asp_odd"]:
        e = e - _dpoly_odd_32(r2, f["asp_odd"])
    return e


# The XY figure and its slopes take no square root: the seed calls
# ops.kernels' _poly_xy and _dpoly_xy, whose operation order is the JAX
# package's, on the float32 row (zeros included, as the reference's seed).

def _sag_freeform_32(x, y, z, f):
    """kernels.sag less kernels._poly_xy in float32."""
    return _sag_32(x, y, z, f) - _poly_xy(x, y, f["xy"])


def _normal_freeform_32(x, y, f):
    """kernels.normal_freeform in float32."""
    e = _normal_radial_32(x, y, f)
    gx, gy = x*e, y*e
    dpx, dpy = _dpoly_xy(x, y, f["xy"])
    return gx - dpx, gy - dpy


def _anam_funcs_32(an):
    """(sag, normal) of a biconic, toroid or freeform row in float32."""
    f = an["f32"]
    if an["mode"] == "freeform":
        return (lambda x, y, z: _sag_freeform_32(x, y, z, f),
                lambda x, y: _normal_freeform_32(x, y, f))
    if an["mode"] == "toroid":
        return (lambda x, y, z: _sag_toroid_32(x, y, z, f),
                lambda x, y: _normal_toroid_32(x, y, f))
    return (lambda x, y, z: _sag_biconic_32(x, y, z, f),
            lambda x, y: _normal_biconic_32(x, y, f))


# -- the anamorphic intercepts ------------------------------------------------

def _intercept_cyl_df(w, z, uw, uz, an, dv, sq):
    """Closed-form conic-cylinder intercept in df32: the quadric
    c (w^2 + (1+k) z^2) - 2 z = 0 in one transverse coordinate w, with
    the rotationally symmetric conic's cancellation-free root choice.
    A degenerate quadric (e_q == 0: a ray parallel to the curved axis
    of a parabolic cylinder) takes the conjugate-root form."""
    c, k1 = an["c1"], an["k1"]
    kz = mul(k1, z)
    uy_ = add(mul(uw, w), mul(uz, kz))
    uu = add(sqr(uw), mul(k1, sqr(uz)))
    yy = add(sqr(w), mul(z, kz))
    d = sub(mul(c, uy_), uz)
    f = sub(mul(c, yy), scale(z, 2.))
    e_q = mul(c, uu)
    disc = sub(sqr(d), mul(e_q, f))
    g = sq(disc)
    ez = e_q[0] == 0
    if an["alternate"]:
        g = neg(g)
        stable = ez
    else:
        stable = (d[0] < 0) | ez
    num = where(stable, f, neg(add(d, g)))
    den = where(stable, sub(g, d), e_q)
    one = (torch.ones_like(den[0]), torch.zeros_like(den[1]))
    return dv(num, where(den[0] == 0, one, den))


def _residual_ok(s, res):
    """Rays whose sag residual passes |res| <= tol (1 + |s|) on the hi
    words (False for NaN)."""
    return res[0].abs() <= ASPHERIC_TOL*(1 + s[0].abs())


def _intercept_anam_df(x, y, z, ux, uy, uz, an, one, dv, sq):
    """Anamorphic intercept: the closed form for conic cylinders, the
    mixed-precision Newton for biconics, toroids and freeform rows
    (misses NaN)."""
    mode = an["mode"]
    if mode == "cyl_y":
        return _intercept_cyl_df(y, z, uy, uz, an, dv, sq)
    if mode == "cyl_x":
        return _intercept_cyl_df(x, z, ux, uz, an, dv, sq)
    f = an["f32"]
    x0, y0, z0 = x[0], y[0], z[0]
    ux0, uy0, uz0 = ux[0], uy[0], uz[0]
    s32 = _intercept_conic_32(x0, y0, z0, ux0, uy0, uz0, f["cy"], f["ky"],
                              f["alt"])
    uz_safe = torch.where(uz0 == 0, torch.ones_like(uz0), uz0)
    s32 = torch.where(torch.isnan(s32), -z0/uz_safe, s32)
    sag32, grad32 = _anam_funcs_32(an)
    for _ in range(ANAM_F32_ITERS):
        px, py, pz = x0 + s32*ux0, y0 + s32*uy0, z0 + s32*uz0
        fn = sag32(px, py, pz)
        gx, gy = grad32(px, py)
        fp = ux0*gx + uy0*gy + uz0
        fp = torch.where(fp == 0, torch.ones_like(fp), fp)
        s32 = s32 - fn/fp
    sag_df, grad_df = _anam_funcs_df(an, one, dv, sq)
    s = (s32, torch.zeros_like(s32))
    for _ in range(an["df_iters"]):
        px = add(x, mul(s, ux))
        py = add(y, mul(s, uy))
        pz = add(z, mul(s, uz))
        fn = sag_df(px, py, pz)
        gx, gy = grad_df(px, py)
        fp = add(add(mul(ux, gx), mul(uy, gy)), uz)
        ok = fp[0] != 0
        fp = (torch.where(ok, fp[0], torch.ones_like(fp[0])),
              torch.where(ok, fp[1], torch.zeros_like(fp[1])))
        s = sub(s, dv(fn, fp))
    res = sag_df(add(x, mul(s, ux)), add(y, mul(s, uy)), add(z, mul(s, uz)))
    nan = torch.full_like(s[0], np.nan)
    return where(_residual_ok(s, res), s, (nan, nan))


# -- the phase rows in df32 ---------------------------------------------------

def _normal_cyl_df(w, an, one, dv, sq):
    """A conic cylinder's normal component in its curved axis, g_w = w e
    with e = -c/sqrt(1 - (1+k) c^2 w^2) (read by a phase cylinder)."""
    e = neg(dv(an["c1"], sq(sub(one, mul(an["bc"], sqr(w))))))
    return mul(w, e)


def _normal_anam_df(x, y, an, one, dv, sq):
    """(gx, gy) of an anamorphic row's normal (gx, gy, 1)."""
    if an["mode"] == "cyl_y":
        return zero_like(x), _normal_cyl_df(y, an, one, dv, sq)
    if an["mode"] == "cyl_x":
        return _normal_cyl_df(x, an, one, dv, sq), zero_like(y)
    return _anam_funcs_df(an, one, dv, sq)[1](x, y)


def _poly_horner_df(coeffs, r2):
    """sum coeffs[i] r2^i by Horner from the last coefficient."""
    acc = coeffs[-1]
    for cdf in coeffs[-2::-1]:
        acc = add(mul(acc, r2), cdf)
    return acc


def _refract_grating_df(ux, uy, uz, mu, kind, gdy, nrm, one, dv, sq,
                        kick=None):
    """The grating/phase refraction or reflection in df32 (kernels.
    refract_grating with the branch choice static): b = mu u + T q + s,
    q the y axis projected into the tangent plane and normalised, s the
    DOE's radial kick (sx, sy) or None, then u' = b + Gamma n.  nrm is
    (gx, gy) of the substrate normal (gx, gy, 1), None on a plane (q is
    the y axis exactly); a mirror (kind 2) takes the root that flips the
    normal component.  An evanescent order is NaN (the root of a
    negative)."""
    if nrm is None:
        bx = mul(mu, ux)
        by = mul(mu, uy) if gdy is None else add(mul(mu, uy), gdy)
        if kick is not None:
            bx = add(bx, kick[0])
            by = add(by, kick[1])
        bz = mul(mu, uz)
        root = sq(sub(sub(one, sqr(bx)), sqr(by)))
        if kind == 2:
            gam = sub(neg(bz), where(bz[0] >= 0, root, neg(root)))
        else:
            gam = sub(root, bz)
        return bx, by, add(bz, gam)
    gx, gy = nrm
    inv_nn = dv(one, add(add(sqr(gx), sqr(gy)), one))
    bx, by, bz = mul(mu, ux), mul(mu, uy), mul(mu, uz)
    if gdy is not None:
        qx = neg(mul(mul(gy, gx), inv_nn))
        qy = sub(one, mul(sqr(gy), inv_nn))
        qz = neg(mul(gy, inv_nn))
        qinv = dv(one, _max_tiny(sq(add(add(sqr(qx), sqr(qy)), sqr(qz)))))
        bx = add(bx, mul(gdy, mul(qx, qinv)))
        by = add(by, mul(gdy, mul(qy, qinv)))
        bz = add(bz, mul(gdy, mul(qz, qinv)))
    if kick is not None:
        bx = add(bx, kick[0])
        by = add(by, kick[1])
    bn = mul(add(add(mul(bx, gx), mul(by, gy)), bz), inv_nn)
    bb = add(add(sqr(bx), sqr(by)), sqr(bz))
    root = sq(sub(sqr(bn), mul(sub(bb, one), inv_nn)))
    if kind == 2:
        gam = sub(neg(bn), where(bn[0] >= 0, root, neg(root)))
    else:
        gam = sub(root, bn)
    return add(bx, mul(gam, gx)), add(by, mul(gam, gy)), add(bz, gam)


def _phase_df(x, y, ux, uy, uz, st, one, dv, sq):
    """A grating or DOE row's new direction: the substrate's normal (a
    cylinder's, a biconic's, toroid's or freeform row's, the radial one
    of a curved or figured row; none on a plane), the DOE's kick sum
    2(i+1) a_i r^(2i) (x, y) (its coefficients scaled in the plan), then
    the solve."""
    c, k1, anam = st["c"], st["k1"], st["anam"]
    figured = bool(st["asp"] or st["asp_odd"])
    nrm = None
    if anam is not None:
        nrm = _normal_anam_df(x, y, anam, one, dv, sq)
    elif not st["flat"] or figured:
        e = _normal_radial_df(x, y, c, k1 if k1 is not None else one,
                              st["asp"], st["asp_odd"], one, dv, sq)
        nrm = mul(x, e), mul(y, e)
    kick = None
    if st["doe"] is not None:
        ek = _poly_horner_df(st["doe"], add(sqr(x), sqr(y)))
        kick = mul(ek, x), mul(ek, y)
    return _refract_grating_df(ux, uy, uz, st["mu"], st["kind"], st["grat"],
                               nrm, one, dv, sq, kick=kick)


def _polish_radial_df(x, y, z, ux, uy, uz, s, st, one, dv, sq):
    """ASPHERIC_ITERS df32 Newton rounds of an aspheric row from its
    conic root s (no zero-slope guard, as the reference), then the
    residual test: misses are NaN."""
    c, k1 = st["c"], st["k1"] if st["k1"] is not None else one
    asp, asp_odd = st["asp"], st["asp_odd"]
    for _ in range(ASPHERIC_ITERS):
        px = add(x, mul(s, ux))
        py = add(y, mul(s, uy))
        pz = add(z, mul(s, uz))
        fn = _sag_df(px, py, pz, c, k1, asp, asp_odd, one, dv, sq)
        en = _normal_radial_df(px, py, c, k1, asp, asp_odd, one, dv, sq)
        fp = add(add(mul(ux, mul(px, en)), mul(uy, mul(py, en))), uz)
        s = sub(s, dv(fn, fp))
    res = _sag_df(add(x, mul(s, ux)), add(y, mul(s, uy)),
                  add(z, mul(s, uz)), c, k1, asp, asp_odd, one, dv, sq)
    nan = torch.full_like(s[0], np.nan)
    return where(_residual_ok(s, res), s, (nan, nan))


def _surface_df(state, st):
    """One transfer-intercept-refract step in df32 for a planned step
    `st` whose constants are 0-d float32 tensors (`_on_device`).
    Mirrors the reference's _surface_df for flat, spherical, conic,
    aspheric, anamorphic and phase rows; returns the new state and the
    intercept distance s (a DOE row's with its phase term)."""
    dv, sq = (div1, sqrt1) if st["fast"] else (div, sqrt)
    c, mu, kind, flat = st["c"], st["mu"], st["kind"], st["flat"]
    k1, rotm, rot_df, anam = st["k1"], st["rotm"], st["rot_df"], st["anam"]
    figured = bool(st["asp"] or st["asp_odd"])
    one = st["one"]
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
    if anam is not None:
        s = _intercept_anam_df(x, y, z, ux, uy, uz, anam, one, dv, sq)
    elif flat:
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
    if figured and anam is None:
        s = _polish_radial_df(x, y, z, ux, uy, uz, s, st, one, dv, sq)
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
    if st["doe_path"] is not None:
        # the DOE's imprinted phase is optical path: psi(r^2) n_after /
        # n_before folded into the length, which the caller scales by
        # n_before
        r2p = add(sqr(x), sqr(y))
        s = add(s, mul(_poly_horner_df(st["doe_path"], r2p), r2p))
    if st["grat"] is not None or st["doe"] is not None:
        vx, vy, vz = _phase_df(x, y, ux, uy, uz, st, one, dv, sq)
    elif kind == 0:
        vx, vy, vz = ux, uy, uz
    else:
        # the normal (nx, ny, nzv); None stands for a zero component,
        # nzv None for 1 and nn None for an exactly unit |N|^2
        nx = ny = nzv = nn = None
        cyl = anam is not None and anam["mode"] in ("cyl_y", "cyl_x")
        if cyl:
            # a conic cylinder's polynomial normal in its curved axis w:
            # N_w = -c w, N_z = 1 - c(1+k) z, |N| == 1 on a circular one
            cy_ = anam["mode"] == "cyl_y"
            w, uw = (y, uy) if cy_ else (x, ux)
            nw = neg(mul(anam["c1"], w))
            nzv = sub(one, mul(anam["k1c"], z))
            dot = add(mul(uw, nw), mul(uz, nzv))
            if not anam["circular"]:
                nn = add(sqr(nw), sqr(nzv))
            if cy_:
                ny = nw
            else:
                nx = nw
        elif not flat and anam is None and not figured:
            # polynomial implicit-gradient normal N = (-c x, -c y,
            # 1 - c(1+k) z); |N| == 1 exactly on a sphere
            nx, ny = neg(mul(c, x)), neg(mul(c, y))
            nzv = sub(one, mul(st["k1c"] if conic else c, z))
            dot = add(add(mul(ux, nx), mul(uy, ny)), mul(uz, nzv))
            if conic:
                nn = add(add(sqr(nx), sqr(ny)), sqr(nzv))
        elif anam is not None or figured:
            # the generic normal (nx, ny, 1) of a figured or Newton row
            # (a figured flat row too)
            if anam is not None:
                nx, ny = _anam_funcs_df(anam, one, dv, sq)[1](x, y)
            else:
                e = _normal_radial_df(x, y, c, k1 if conic else one,
                                      st["asp"], st["asp_odd"], one, dv, sq)
                nx, ny = mul(x, e), mul(y, e)
            nn = add(add(sqr(nx), sqr(ny)), one)
            dot = add(add(mul(ux, nx), mul(uy, ny)), uz)
        else:
            dot = uz
        if kind == 2:
            a2 = scale(dot, 2.) if nn is None else scale(dv(dot, nn), 2.)
            vx = ux if nx is None else sub(ux, mul(a2, nx))
            vy = uy if ny is None else sub(uy, mul(a2, ny))
            vz = sub(uz, a2) if nzv is None else sub(uz, mul(a2, nzv))
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
            vx = mul(mu, ux) if nx is None else add(mul(mu, ux), mul(g, nx))
            vy = mul(mu, uy) if ny is None else add(mul(mu, uy), mul(g, ny))
            vz = (add(mul(mu, uz), g) if nzv is None
                  else add(mul(mu, uz), mul(g, nzv)))
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
_CONST_KEYS = ("c", "mu", "dz", "k1", "k1c", "nb", "dxy", "rot_df", "asp",
               "asp_odd", "grat", "doe", "doe_path")
#: an anamorphic or freeform row's df32 constants
_ANAM_CONSTS = ("c", "c1", "k1", "k1c", "bc", "cx", "cy", "cr", "bxc", "byc",
                "asp", "asp_odd")
#: a freeform row's term lists: (df32 constant, i, j) triples
_XY_TERMS = ("xy", "xy_gx", "xy_gy")


def _trim(coeffs):
    nz = int(np.max(np.nonzero(coeffs)[0]) + 1) if coeffs.any() else 0
    return coeffs[:nz]


def _host(table, name, shape_tail=()):
    v = getattr(table, name, None)
    if v is None:
        return np.zeros((table.curvature.shape[0],) + shape_tail)
    return v.detach().cpu().numpy().astype(np.float64)


def _cf(t):
    """The float64 value of a df32 constant."""
    return float(t[0]) + float(t[1])


def _anamorphic_row(cy, ky, cdx, kdx, tor, alt, coeffs, codd, df_iters,
                    phase=False):
    """The reference plan's decision for an anamorphic row: a conic
    cylinder without its own figure takes the closed form (cyl_y or
    cyl_x), a figured cylinder, a biconic or a toroid the Newton, and a
    row flat in both axes is a plane (None).  A cylinder that carries a
    grating or DOE (`phase`) also keeps bc = (1+k) c^2, which only its
    phase normal reads."""
    if tor != 0:
        cx, kx = 0., 0.          # placeholders (a toroid uses cr)
        cr = cy + cdx
        cylinder = cr == 0.      # degenerate: the pure y-curve
        mode = "toroid"
    else:
        cx, kx = cy + cdx, ky + kdx
        cr = 0.
        cylinder = cx == 0. or cy == 0.
        mode = "biconic"
    if cylinder and not (coeffs.size or codd.size):
        along_y = tor != 0 or cx == 0.
        caxis, kaxis = (cy, ky) if along_y else (cx, kx)
        if caxis == 0.:
            return None
        c1, k1 = const(caxis), const(1. + kaxis)
        out = dict(mode="cyl_y" if along_y else "cyl_x", c1=c1, k1=k1,
                   k1c=const(_cf(k1)*_cf(c1)), circular=_cf(k1) == 1.,
                   alternate=bool(alt))
        if phase:
            out["bc"] = const((1. + kaxis)*caxis*caxis)
        return out
    return dict(
        mode=mode, df_iters=df_iters,
        cx=const(cx), cy=const(cy), cr=const(cr),
        bxc=const((1. + kx)*cx*cx), byc=const((1. + ky)*cy*cy),
        asp=tuple(const(a) for a in coeffs),
        asp_odd=tuple(const(a) for a in codd),
        f32=dict(cx=np.float32(cx), kx=np.float32(kx), cy=np.float32(cy),
                 ky=np.float32(ky), cr=np.float32(cr), alt=np.float32(alt),
                 asp=tuple(np.float32(a) for a in coeffs),
                 asp_odd=tuple(np.float32(a) for a in codd)))


def _freeform_row(xy_row, c, conic, alt, coeffs, codd, df_iters):
    """The reference plan's freeform row: the conic/aspheric base's c, k1
    = const(1 + conic) (also where the conic is 0), asp and asp_odd, the
    degree of the row's width, and the nonzero XY terms in term order as
    (df32 constant, i, j) triples: the value terms (a, i, j), the x-slope
    terms (i a, i - 1, j) and the y-slope terms (j a, i, j - 1), each
    slope constant const of its float64 product; the float32 seed's
    scalars and the whole float32 row, zeros included."""
    deg = xy_degree(xy_row.size)
    val, gx, gy = [], [], []
    for a, (i, j) in zip(xy_row, _xy_terms(deg)):
        if a == 0.:
            continue
        val.append((const(a), i, j))
        if i:
            gx.append((const(i*a), i - 1, j))
        if j:
            gy.append((const(j*a), i, j - 1))
    return dict(
        mode="freeform", df_iters=df_iters, deg=deg, c=const(c),
        k1=const(1. + conic), asp=tuple(const(a) for a in coeffs),
        asp_odd=tuple(const(a) for a in codd), xy=tuple(val),
        xy_gx=tuple(gx), xy_gy=tuple(gy),
        f32=dict(cy=np.float32(c), ky=np.float32(conic), alt=np.float32(alt),
                 asp=tuple(np.float32(a) for a in coeffs),
                 asp_odd=tuple(np.float32(a) for a in codd),
                 xy=np.asarray(xy_row, np.float32)))


def plan(table, clip=False, fast=False):
    """Host-side: per-surface df32 constants + static flags from a
    float64 SurfaceTable (on any device; read through .cpu()).

    Each step is a dict with the reference plan's keys: c, mu, dz (df32
    constants), kind (0 passthrough, 1 refract, 2 mirror), flat, k1 =
    const(1 + conic) for a conic row (else None), k1c = const((1+k)c)
    baked from the df32 constants in float64 (the reference computes it
    inside its step), asp and asp_odd (the row's trimmed even and odd
    coefficients as df32 constants: an aspheric row's Newton polish),
    anam (an anamorphic or freeform row's constants, else None: a conic
    cylinder's c1, k1, k1c, circular and alternate, and on a grating or
    DOE row bc = (1+k) c1^2; a biconic's or toroid's cx, cy, cr, bxc,
    byc, asp, asp_odd, df_iters and its float32 seed's scalars `f32`; or
    a freeform row's c, k1, asp, asp_odd, deg, its term lists xy, xy_gx
    and xy_gy, df_iters and `f32`, _freeform_row), grat (the
    grating term grating_dy, else None), doe (the DOE's kick
    coefficients 2(i+1) a_i over its trimmed coefficients a_i, else
    None), doe_path (its path coefficients a_i n_after/n_before, else
    None), alternate, rotm (an exact signed permutation, integer 3x3) or
    rot_df (a 3x3 nest of df32 constants), dxy (the decenter pair or
    None), radius (the float32 squared aperture radius when clipping,
    else None), clip, fast, and nb (n_before, for the optical path).

    fast=True bakes one-round div/sqrt refinements into every step
    (div1/sqrt1) and one df32 round fewer into the Newton of an
    anamorphic or freeform row.  A row whose XY figure is all zero plans
    as its base row; a freeform figure on an anamorphic base raises
    NotImplementedError, as the reference's plan does."""
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
    asp = _host(table, "aspherics", (0,))
    asp_odd = _host(table, "aspherics_odd", (0,))
    nafter = _host(table, "n_after")
    cdx, kdx, tor, gdy = (_host(table, name) for name in
                          ("curvature_dx", "conic_dx", "toroidal",
                           "grating_dy"))
    doe_tab = _host(table, "doe", (0,))
    xy_tab = _host(table, "xy_poly", (0,))
    df_iters = ANAM_DF_ITERS + (0 if fast else 1)
    steps = []
    for j in range(1, s_count):
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
        coeffs = _trim(asp[j] if asp.shape[1] else np.zeros(0))
        codd = _trim(asp_odd[j] if asp_odd.shape[1] else np.zeros(0))
        doe = _trim(doe_tab[j]) if doe_tab.shape[1] else np.zeros(0)
        anam = None
        xy_row = xy_tab[j] if xy_tab.shape[1] else np.zeros(0)
        if np.any(xy_row != 0):
            if tor[j] != 0 or cdx[j] != 0 or kdx[j] != 0:
                raise NotImplementedError(
                    "row %d combines an anamorphic base with a freeform XY "
                    "figure; express the full figure in xy_poly" % j)
            anam = _freeform_row(xy_row, curv[j], conic[j], alt[j], coeffs,
                                 codd, df_iters)
        elif tor[j] != 0 or cdx[j] != 0 or kdx[j] != 0:
            anam = _anamorphic_row(curv[j], conic[j], cdx[j], kdx[j],
                                   tor[j], alt[j], coeffs, codd, df_iters,
                                   phase=bool(gdy[j] != 0 or doe.size))
        c = const(curv[j])
        k1 = const(1. + conic[j]) if conic[j] else None
        steps.append(dict(
            c=c, mu=const(abs(mu[j])), dz=const(off[j, 2]), kind=kind,
            flat=curv[j] == 0. and anam is None, k1=k1,
            k1c=None if k1 is None else const(_cf(k1)*_cf(c)),
            asp=tuple(const(a) for a in coeffs),
            asp_odd=tuple(const(a) for a in codd), anam=anam,
            grat=const(gdy[j]) if gdy[j] != 0 else None,
            doe=(tuple(const(2.*(i + 1)*a) for i, a in enumerate(doe))
                 if doe.size else None),
            doe_path=(tuple(const(a*float(nafter[j])/float(nbef[j]))
                            for a in doe) if doe.size else None),
            alternate=bool(alt[j]), rotm=rotm, rot_df=rot_df, dxy=dxy,
            radius=(np.float32(rad[j])**2 if clip
                    and np.isfinite(rad[j]) else None),
            clip=clip, fast=fast, nb=const(nbef[j])))
    return steps


def _on_device(st, like):
    """The step with its df32 constants (and an anamorphic or freeform
    row's, its term lists' and its seed's float32 scalars) as 0-d float32
    tensors on like's device (and the radius and 1.0 beside them; a
    freeform seed's XY row as one float32 tensor)."""
    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32,
                            device=like.device)

    def conv(v):
        if v is None or not len(v):
            return v
        if isinstance(v[0], tuple):
            return tuple(conv(w) for w in v)
        return tuple(scalar(w) for w in v)
    out = dict(st)
    for key in _CONST_KEYS:
        out[key] = conv(st.get(key))
    if st["radius"] is not None:
        out["radius"] = scalar(st["radius"])
    if st["anam"] is not None:
        an = dict(st["anam"])
        for key in _ANAM_CONSTS:
            if key in an:
                an[key] = conv(an[key])
        for key in _XY_TERMS:
            if key in an:
                an[key] = tuple((conv(cdf), i, j) for cdf, i, j in an[key])
        if "f32" in an:
            an["f32"] = {k: (tuple(scalar(w) for w in v)
                             if isinstance(v, tuple)
                             else torch.as_tensor(v, device=like.device)
                             if isinstance(v, np.ndarray) else scalar(v))
                         for k, v in an["f32"].items()}
        out["anam"] = an
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
