"""Pupil sampling patterns and unit-disc quadrature rules.

Functional parity target: reference utils.py:118-247 (pupil sampling,
Gauss-Radau/Lobatto roots, disc lift).  Eleven named patterns over the
normalized pupil disc; the quadrature patterns ("radau", "lobatto")
carry weights that turn a weighted spot-RMS into a proper disc integral.

Design here: each pattern is a standalone generator registered in
``_PATTERNS`` returning ``(ref_index, xy, weight)``; the public
``pupil_distribution`` only dispatches.  All host-side NumPy — these
build the ray seeds consumed by the tensor trace engines.
"""

import numpy as np

_PATTERNS = {}


def _pattern(name):
    def register(fn):
        _PATTERNS[name] = fn
        return fn
    return register


def _line(lo, hi, count, vertical):
    """`count` points evenly spaced on a pupil axis; (N, 2) array."""
    t = np.linspace(lo, hi, count)
    z = np.zeros(count)
    return np.stack([z, t] if vertical else [t, z], axis=1)


def _with_center(xy):
    """Prepend the chief-ray sample at the pupil center."""
    return np.vstack([np.zeros((1, 2)), xy])


@_pattern("half-meridional")
def _half_meridional(nrays):
    return 0, _line(0, 1, nrays, vertical=True), None


@_pattern("meridional")
def _meridional(nrays):
    # odd count so the axis midpoint is sampled exactly
    return 0, _line(-1, 1, nrays - nrays % 2 + 1, vertical=True), None


@_pattern("sagittal")
def _sagittal(nrays):
    count = nrays - nrays % 2 + 1
    return count // 2, _line(-1, 1, count, vertical=False), None


@_pattern("cross")
def _cross(nrays):
    per_arm = 2 * (nrays // 4) + 1
    arms = np.vstack([_line(-1, 1, per_arm, vertical=True),
                      _line(-1, 1, per_arm, vertical=False)])
    # reference index: midpoint of the vertical arm
    return per_arm // 2, arms, None


@_pattern("tee")
def _tee(nrays):
    half = max((nrays - 2) // 3, 0)
    vert = _line(-1, 1, 2 * half + 1, vertical=True)
    horiz = _line(0, 1, half + 1, vertical=False)
    # the first horizontal sample sits at the pupil center
    return len(vert), np.vstack([vert, horiz]), None


@_pattern("random")
def _random(nrays, rng=None):
    if rng is None:
        rng = np.random.default_rng()
    # area-uniform: radius is sqrt of a uniform variate
    rad = np.sqrt(rng.uniform(size=nrays))
    ang = rng.uniform(0, 2 * np.pi, size=nrays)
    return 0, _with_center(
        np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)), None


def _cartesian_grid(nrays, stagger):
    # side chosen so roughly `nrays` survive the circular clip
    side = int(np.sqrt(nrays * 4 / np.pi))
    axis = np.linspace(-1, 1, side)
    gx, gy = np.meshgrid(axis, axis, indexing="ij")
    if stagger:
        # shift alternate columns by half a row pitch -> triangular lattice
        gx = gx + (np.arange(side) % 2) * (2. / side)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    pts = pts[(pts ** 2).sum(1) <= 1]
    return 0, _with_center(pts), None


@_pattern("square")
def _square(nrays):
    return _cartesian_grid(nrays, stagger=False)


@_pattern("triangular")
def _triangular(nrays):
    return _cartesian_grid(nrays, stagger=True)


@_pattern("hexapolar")
def _hexapolar(nrays):
    # ring r holds 6r points; total 1 + 3R(R+1) <= nrays solves to:
    nring = int(np.sqrt(nrays / 3. - 1 / 12.) - .5)
    pieces = [np.zeros((1, 2))]
    for ring in range(1, nring + 1):
        theta = 2 * np.pi * np.arange(6 * ring) / (6 * ring)
        rho = ring / nring
        pieces.append(np.stack([rho * np.sin(theta),
                                rho * np.cos(theta)], axis=1))
    return 0, np.vstack(pieces), None


def _quadrature_pattern(nrays, roots_fn):
    x, w = roots_fn(int(np.sqrt(nrays) + 1))
    rad, ang, wt = interval_to_circle(x, w)
    return 0, np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1), wt


@_pattern("radau")
def _radau(nrays):
    return _quadrature_pattern(nrays, gr_roots)


@_pattern("lobatto")
def _lobatto(nrays):
    return _quadrature_pattern(nrays, gl_roots)


def pupil_distribution(distribution, nrays):
    """Sample `nrays` points in normalized pupil coordinates.

    Returns ``(ref, xy, weight)``: the index of the reference (chief)
    ray, an (N, 2) array clipped to the unit circle, and quadrature
    weights (or None for non-quadrature patterns).  Patterns:
    meridional, half-meridional, sagittal, cross, tee, random, square,
    triangular, hexapolar, radau, lobatto (reference utils.py:118-199).
    """
    if nrays == 1:
        return 0, np.zeros((1, 2)), None
    try:
        generate = _PATTERNS[distribution]
    except KeyError:
        raise ValueError("unknown ray distribution", distribution) from None
    return generate(nrays)


def _legcoef(n):
    """Legendre-basis coefficient vector selecting P_n."""
    c = np.zeros(n + 1)
    c[n] = 1.
    return c


def gl_roots(n):
    """Gauss-Lobatto nodes/weights on [-1, 1], -1 first, 1 last.

    Interior nodes are the roots of P'_{n-1}, found via the
    Legendre-basis companion matrix (numpy legroots) -- the monomial-
    basis np.poly1d.roots the reference uses (reference utils.py:203)
    loses the roots entirely past degree ~40 (nrays ~ 1600)."""
    from numpy.polynomial.legendre import legder, legroots, legval
    c = _legcoef(n - 1)
    x = np.r_[-1, np.sort(legroots(legder(c)).real), 1]
    w = 2/(n*(n - 1)*legval(x, c)**2)
    return x, w


def gr_roots(n):
    """Gauss-Radau nodes/weights on [-1, 1], -1 first.

    Nodes are the roots of P_{n-1} + P_n (reference utils.py:214):
    the fixed -1 endpoint is dropped from the numerically-found set
    and re-inserted exactly; Legendre-basis companion roots keep the
    rule valid at thousands of nodes (the reference's monomial
    polydiv+roots collapses past degree ~40)."""
    from numpy.polynomial.legendre import legroots, legval
    c = np.zeros(n + 1)
    c[n - 1] = 1.
    c[n] = 1.
    x = np.sort(legroots(c).real)
    x = np.r_[-1, x[1:]]  # replace the found endpoint by exact -1
    w = (1 - x)/(n*legval(x, _legcoef(n - 1)))**2
    return x, w


def interval_to_circle(x, w, p=None, a=-1., b=1.):
    """Lift a 1-D quadrature on [a, b] to the unit disc.

    Radius comes from the area-preserving map ``r = sqrt((x-a)/(b-a))``;
    each nonzero-radius node becomes a fan of azimuth samples (`p`
    angles if scalar/None, or explicit angles if array), each carrying
    an equal share of the node weight.  A node at r=0 stays a single
    center sample.  Weights are normalized so they sum to 1
    (reference utils.py:226).
    """
    x = np.asarray(x, float)
    w = np.asarray(w, float)
    assert x.shape == w.shape
    radius = np.sqrt((x - a) / (b - a))
    if p is None:
        p = len(x)
    if np.ndim(p) == 0:
        nphi = int(p)
        fan = ((np.arange(nphi) + .5) / nphi - .5) * np.pi
    else:
        fan = np.asarray(p, float)
        nphi = len(fan)
    rs, ps, ws = [], [], []
    for rk, wk in zip(radius, w):
        if rk == 0.:
            rs.append([0.])
            ps.append([0.])
            ws.append([wk / 2])
        else:
            rs.append(np.full(nphi, rk))
            ps.append(fan)
            ws.append(np.full(nphi, wk / (2 * nphi)))
    rs, ps, ws = (np.concatenate(v) for v in (rs, ps, ws))
    assert np.allclose(ws.sum(), 1), ws.sum()
    return rs, ps, ws
