"""Zernike polynomials (Noll numbering) and wavefront fits.

The counterpart of the JAX package's rayopt_tpu.utils.zernike, in
NumPy: decompose the exit-pupil wavefront into Noll-ordered Zernike
terms (piston, tilt, defocus, astigmatism, coma, spherical, ...) by
weighted least squares over the traced ray samples
(GeometricTrace.zernike), convert between the Noll and Fringe
orderings, and lower Zernike sags onto XY monomials.
"""

import math
from functools import lru_cache as _lru_cache

import numpy as np

NOLL_NAMES = {
    1: "piston", 2: "tilt x", 3: "tilt y", 4: "defocus",
    5: "astig 45", 6: "astig 0", 7: "coma y", 8: "coma x",
    9: "trefoil y", 10: "trefoil x", 11: "spherical",
    12: "2nd astig 0", 13: "2nd astig 45", 14: "tetrafoil 0",
    15: "tetrafoil 45", 16: "2nd coma x", 17: "2nd coma y",
    22: "2nd spherical",
}


def noll_to_nm(j):
    """Noll index -> (n, m) with the standard sign/parity rules."""
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1)**j * ((n % 2) + 2*((j1 + ((n + 1) % 2))//2))
    return n, int(m)


@_lru_cache()
def _fringe_order():
    """The 37-term Fringe ("University of Arizona") ordering as
    (n, signed m) pairs: groups of constant n + |m| ascending, |m|
    descending within a group (so spherical-aberration orders close
    each group), cosine (m > 0) before sine (m < 0); term 37 is the
    conventional high-order spherical (12, 0).  This is the set the
    Zemax/OpticStudio "Zernike Fringe" surfaces and interferometer
    software use."""
    seq = [(0, 0)]
    for s in range(1, 6):
        for am in range(s, -1, -1):
            n = 2*s - am
            if am:
                seq.append((n, am))
                seq.append((n, -am))
            else:
                seq.append((n, 0))
    seq.append((12, 0))
    return tuple(seq)


def fringe_to_nm(i):
    """Fringe index (1-based, 1..37) -> (n, signed m)."""
    order = _fringe_order()
    if not 1 <= i <= len(order):
        raise ValueError("Fringe Zernike index %d outside the "
                         "37-term set" % i)
    return order[i - 1]


def noll_from_nm(n, m):
    """(n, signed m) -> Noll index (inverse of noll_to_nm)."""
    # Noll index for radial order n starts at n(n+1)/2 + 1; scan the
    # (at most n + 1) candidates in that row
    j0 = n*(n + 1)//2 + 1
    for j in range(j0, j0 + n + 1):
        if noll_to_nm(j) == (n, m):
            return j
    raise ValueError("no Noll index for (n, m) = (%d, %d)" % (n, m))


def _orthonorm(n, m):
    """Orthonormal (Noll) over unnormalized (Fringe/Born & Wolf,
    peak 1 at the rim for cosine terms) amplitude ratio."""
    return math.sqrt(n + 1) if m == 0 else math.sqrt(2*(n + 1))


def fringe_to_noll(coeff):
    """Fringe coefficient vector (coeff[0] = Fringe term 1, scaling
    UNNORMALIZED Zernikes) -> Noll coefficient vector (scaling the
    orthonormal `zernike` basis).  Same surface, different labels:
    sum_i c_i Z_i^fringe == sum_j out_j Z_j^noll exactly."""
    pairs = [fringe_to_nm(i) for i in range(1, len(coeff) + 1)]
    jmax = max((noll_from_nm(n, m) for n, m in pairs), default=0)
    out = [0.]*jmax
    for c, (n, m) in zip(coeff, pairs):
        if c:
            out[noll_from_nm(n, m) - 1] += c/_orthonorm(n, m)
    return out


def noll_to_fringe(coeff):
    """Noll (orthonormal) coefficient vector -> Fringe coefficient
    vector (inverse of fringe_to_noll).  Raises if a term has no
    Fringe slot (the Fringe set stops at 37 terms)."""
    order = _fringe_order()
    index = {nm: i + 1 for i, nm in enumerate(order)}
    out = [0.]*0
    for j, c in enumerate(coeff, start=1):
        if not c:
            continue
        n, m = noll_to_nm(j)
        i = index.get((n, m))
        if i is None:
            raise ValueError(
                "Noll term %d (n=%d, m=%d) has no slot in the 37-term "
                "Fringe set" % (j, n, m))
        while len(out) < i:
            out.append(0.)
        out[i - 1] += c*_orthonorm(n, m)
    return out


def _radial(n, m, rho):
    m = abs(m)
    out = 0.
    for k in range((n - m)//2 + 1):
        c = ((-1)**k*math.factorial(n - k) /
             (math.factorial(k)*math.factorial((n + m)//2 - k) *
              math.factorial((n - m)//2 - k)))
        out = out + c*rho**(n - 2*k)
    return out


def zernike(j, x, y):
    """Noll Zernike Z_j on unit-disc coordinates, orthonormal
    (RMS-normalized: <Z_j^2> = 1 over the disc)."""
    n, m = noll_to_nm(j)
    rho2 = x*x + y*y
    rho = np.sqrt(rho2)
    r = _radial(n, m, rho)
    norm = math.sqrt(2*(n + 1))
    if m == 0:
        return math.sqrt(n + 1)*r
    theta = np.arctan2(y, x)
    if m > 0:
        return norm*r*np.cos(m*theta)
    return norm*r*np.sin(-m*theta)


def fit_zernike(x, y, opd, nterms=15, w=None):
    """Weighted least-squares Zernike fit of OPD samples on (x, y)
    normalized pupil coordinates.  Returns (coefficients, residual
    RMS).  NaN samples are dropped."""
    x = np.asarray(x, float).ravel()
    y = np.asarray(y, float).ravel()
    opd = np.asarray(opd, float).ravel()
    if w is None:
        w = np.ones_like(opd)
    else:
        w = np.asarray(w, float).ravel()
    good = np.isfinite(opd) & np.isfinite(x) & np.isfinite(y)
    x, y, opd, w = x[good], y[good], opd[good], w[good]
    a = np.stack([zernike(j, x, y) for j in range(1, nterms + 1)], 1)
    sw = np.sqrt(w)
    coeff, *_ = np.linalg.lstsq(a*sw[:, None], opd*sw, rcond=None)
    res = opd - a @ coeff
    rms = np.sqrt((w*res**2).sum()/w.sum())
    return coeff, rms


def zernike_table(coeff):
    """Human-readable per-term lines (Noll index, name, value)."""
    lines = []
    for j, c in enumerate(coeff, start=1):
        name = NOLL_NAMES.get(j, "")
        lines.append("Z%-3d %-14s % .4e" % (j, name, c))
    return lines


def zernike_xy(j):
    """Exact Cartesian monomial expansion of Noll Zernike Z_j
    (orthonormal, same convention as `zernike`): returns a dict
    {(i, k): coefficient} with Z_j(x, y) = sum coeff * x^i y^k on
    unit-disc coordinates.

    Built from the closed forms: the radial polynomial's rho^(n-2s)
    factors as (x^2+y^2)^((n-2s-|m|)/2) * rho^|m|, and
    rho^m cos(m th) = Re[(x+iy)^m], rho^m sin(m th) = Im[(x+iy)^m]
    expand binomially with integer coefficients -- the only floating
    factor is the orthonormal normalization, so the expansion is
    exact to one rounding of that factor per term.
    """
    n, m = noll_to_nm(j)
    am = abs(m)
    if m == 0:
        norm = math.sqrt(n + 1)
    else:
        norm = math.sqrt(2*(n + 1))
    # angular part: rho^am * trig(am th) as monomials of (x, y)
    ang = {}
    for t in range(am + 1):
        b = math.comb(am, t)
        if m >= 0 and t % 2 == 0:                 # Re[(x+iy)^m]
            ang[(am - t, t)] = ang.get((am - t, t), 0) + b*(-1)**(t//2)
        elif m < 0 and t % 2 == 1:                # Im[(x+iy)^|m|]
            ang[(am - t, t)] = (ang.get((am - t, t), 0)
                                + b*(-1)**((t - 1)//2))
    if am == 0:
        ang = {(0, 0): 1}
    out = {}
    for s in range((n - am)//2 + 1):
        rc = ((-1)**s*math.factorial(n - s) /
              (math.factorial(s)*math.factorial((n + am)//2 - s) *
               math.factorial((n - am)//2 - s)))
        q = (n - 2*s - am)//2                     # (x^2+y^2)^q
        for p in range(q + 1):
            bc = math.comb(q, p)                  # x^(2(q-p)) y^(2p)
            for (ai, ak), ac in ang.items():
                key = (ai + 2*(q - p), ak + 2*p)
                out[key] = out.get(key, 0.) + norm*rc*bc*ac
    return {k: v for k, v in out.items() if v != 0.}


def zernike_xy_coefficients(coeff, drop_piston=True):
    """Lower a Noll coefficient vector (coeff[0] = Z1) onto the
    triangular XY-monomial ordering of ops.kernels._xy_terms.

    Returns (xy, const): xy is the flat triangular coefficient list
    (unit-disc coordinates; callers divide term t by R^(i+j) to
    denormalize) and const the dropped constant (piston) part -- the
    freeform basis re-references the vertex so sag(0, 0) == 0; the
    constant is reported for callers that track the vertex shift.
    """
    from ..ops.kernels import _xy_terms
    mono = {}
    for j, c in enumerate(coeff, start=1):
        if not c:
            continue
        for k, v in zernike_xy(j).items():
            mono[k] = mono.get(k, 0.) + c*v
    const = mono.pop((0, 0), 0.)
    if not drop_piston and const:
        raise ValueError("constant (piston) sag term %g cannot be "
                         "represented; shift the surface vertex" % const)
    deg = max((i + k for i, k in mono), default=1)
    terms = _xy_terms(deg)
    xy = [mono.pop(t, 0.) for t in terms]
    assert not mono, mono
    return xy, const
