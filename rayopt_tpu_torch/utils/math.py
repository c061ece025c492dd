"""Host-side ray-geometry helpers.

Slope <-> direction-sine conversions and the ray-local frame used by
the host front-end (traces, pupils, analysis); the tensor engines
inline torch equivalents (ops.kernels).

API semantics match the reference helpers (rayopt utils.py:42-114,
same names and array conventions), but everything here is derived
from the geometry rather than ported: a transverse slope pair
t = (tx, ty) corresponds to the unit direction
(tx, ty, 1)/sqrt(1 + |t|^2), so the direction sines are
s = t/sqrt(1 + |t|^2) and conversely t = s/sqrt(1 - |s|^2), where
|.|^2 sums the transverse pair (both components share one axial
component).
"""

import numpy as np


def _pair_sumsq(a):
    """|a|^2 with a trailing 2-wide axis summed: a row of an (N, 2)
    array is one transverse pair sharing an axial component; scalars
    and 1-D arrays convert element-wise."""
    q = np.square(a)
    if q.ndim == 2:
        q = q.sum(axis=1, keepdims=True)
    return q


def tanarcsin(u, v=None):
    """Direction sines -> slopes, tan(arcsin(u)).

    (N, 3) rows are full unit directions and the slope is the
    transverse part over the axial part; any other shape holds sines.
    When ``v`` is given the propagation sign rides along as a second
    return value: sign(u_z) for direction rows, sign(v) otherwise.
    """
    u = np.asanyarray(u)
    if u.ndim == 2 and u.shape[1] == 3:
        t = u[:, :2]/u[:, 2:3]
        return (t, np.sign(u[:, 2])) if v is not None else t
    t = u/np.sqrt(1. - _pair_sumsq(u))
    return (t, np.sign(v)) if v is not None else t


def sinarctan(u, v=None):
    """Slopes -> direction sines, sin(arctan(u)).

    Rows with three or more columns carry their own axial component:
    columns 0:2 are the slope pair and the sign of column 2 is the
    propagation direction.  (The reference's version of this branch
    read a fourth column that a 3-column input cannot have and always
    raised IndexError; here the axial column itself is the sign
    source -- regression-tested in tests/test_utils.py.)  Whenever a
    sign source exists the result gains a z column completing the
    unit vector.
    """
    u = np.asanyarray(u)
    if u.ndim == 2 and u.shape[1] >= 3:
        u, v = u[:, :2], u[:, 2]
    axial = 1./np.sqrt(1. + _pair_sumsq(u))
    s = u*axial
    if v is None:
        return s
    return np.concatenate([s, np.sign(v)[:, None]*axial], axis=1)


def sfloat(a):
    """float(a), or None when it does not parse."""
    try:
        return float(a)
    except (ValueError, TypeError):
        return None


def sint(a):
    """int(a), or None when it does not parse."""
    try:
        return int(a)
    except (ValueError, TypeError):
        return None


def normalize_z(u):
    """In place: set z = sqrt(1 - x^2 - y^2) so each row becomes a
    unit forward vector."""
    u[..., 2] = np.sqrt(1. - np.square(u[..., 0]) - np.square(u[..., 1]))


def norm(u):
    """Euclidean length of the trailing axis, kept as a singleton for
    broadcasting against the vectors it scales."""
    return np.linalg.norm(u, axis=-1, keepdims=True)


def normalize(u):
    """Normalize the trailing axis in place."""
    u /= norm(u)


def sagittal_meridional(u, z):
    """Unit sagittal and meridional vectors of the ray-local frame.

    The sagittal direction is perpendicular to both the ray and the
    axis (s ~ u x z); the meridional one completes the right-handed
    triple (m ~ u x s).  Rays parallel to the axis leave the cross
    product degenerate and fall back to s = x-hat.
    """
    s = np.cross(u, z)
    on_axis = np.square(s).sum(-1, keepdims=True) == 0.
    s = np.where(on_axis, np.array([1., 0., 0.]), s)
    m = np.cross(u, s)
    normalize(s)
    normalize(m)
    return s, m
