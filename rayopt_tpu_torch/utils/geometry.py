"""Rotation / Euler-angle helpers.

The reference vendors the full Gohlke transformations library plus a C
accelerator (_transformations.c) but only consumes three functions
(reference elements.py:23-24): rotation_matrix, euler_matrix,
euler_from_matrix.  We implement those from first principles
(Rodrigues formula; Euler composition/extraction derived via index
arithmetic over the axis permutation -- all 24 axes conventions, both
Tait-Bryan and proper-Euler sequences, static and rotating frames).
All return 3x3 matrices.
"""

import numpy as np


def rotation_matrix(angle, direction):
    """Rotation by `angle` about the axis `direction` (Rodrigues)."""
    d = np.asarray(direction, dtype=float)[:3]
    n = np.linalg.norm(d)
    if n == 0:
        return np.eye(3)
    x, y, z = d/n
    c, s = np.cos(angle), np.sin(angle)
    k = np.array([[0., -z, y], [z, 0., -x], [-y, x, 0.]])
    outer = np.outer((x, y, z), (x, y, z))
    return c*np.eye(3) + s*k + (1 - c)*outer


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1., 0, 0], [0, c, -s], [0, s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1., 0], [-s, 0, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.]])


_SINGLE = {0: _rx, 1: _ry, 2: _rz}
_AXIS_IDX = {"x": 0, "y": 1, "z": 2}


def _parse_axes(axes):
    """Parse an axes spec like 'sxyz'/'rzxz' into (frame, i, j, k).

    frame 'r' = rotating/intrinsic (each rotation about the already-
    rotated axes), 's' = static/extrinsic (all about the fixed lab
    axes).  k may repeat i (proper Euler, e.g. zxz) but consecutive
    axes must differ -- the 24 classic conventions.
    """
    try:
        frame = axes[0]
        i, j, k = (_AXIS_IDX[c] for c in axes[1:])
        assert frame in "rs" and i != j and j != k
    except (KeyError, AssertionError, IndexError, ValueError):
        raise ValueError("unsupported axes spec %r" % (axes,))
    return frame, i, j, k


def _perm_sign(i, j):
    """+1 if (i, j, third) is an even permutation of (0, 1, 2)."""
    return 1. if (j - i) % 3 == 1 else -1.


def euler_matrix(ai=0., aj=0., ak=0., axes="sxyz"):
    """3x3 rotation from Euler angles, any of the 24 axes conventions.

    Rotating frame 'rabc': R = Ra(ai) @ Rb(aj) @ Rc(ak) (intrinsic).
    Static frame 'sabc' applies the same axes about the fixed lab
    frame, i.e. R = Rc(ak) @ Rb(aj) @ Ra(ai) -- so e.g.
    'sxyz'(ai, aj, ak) == 'rzyx'(ak, aj, ai).
    """
    frame, i, j, k = _parse_axes(axes)
    if frame == "r":
        return _SINGLE[i](ai) @ _SINGLE[j](aj) @ _SINGLE[k](ak)
    return _SINGLE[k](ak) @ _SINGLE[j](aj) @ _SINGLE[i](ai)


def euler_from_matrix(matrix, axes="sxyz"):
    """Euler angles from a 3x3 (or homogeneous 4x4) rotation matrix:
    the inverse of euler_matrix for the same axes spec.

    Derivation (rotating frame; the static frame reduces to it by
    reversing the sequence and swapping the outer angles): with
    sigma the permutation sign of (i, j, .), expanding basis row i
    and column k/i of the product gives closed forms for each angle;
    the gimbal-locked branch (middle angle at the degenerate value)
    zeroes the last angle and absorbs it into the first.
    """
    m = np.asarray(matrix, dtype=float)[:3, :3]
    frame, i, j, k = _parse_axes(axes)
    if frame == "s":
        # sabc(a, b, c) == r(cba)(c, b, a)
        i, k = k, i
        a, b, c = euler_from_matrix(m, "r" + "xyz"[i] + "xyz"[j]
                                    + "xyz"[k])
        return c, b, a
    eps = np.finfo(float).eps*4
    sig = _perm_sign(i, j)
    if k == i:
        # proper Euler sequence Ri(a) Rj(b) Ri(c); l = third axis.
        # Row i:    m[i,i] = cb, m[i,j] = sb sc, m[i,l] = sig sb cc
        # Column i: m[j,i] = sa sb, m[l,i] = -sig ca sb
        lx = 3 - i - j
        sb = np.hypot(m[i, j], m[i, lx])
        if sb > eps:
            a = np.arctan2(m[j, i], -sig*m[lx, i])
            b = np.arctan2(sb, m[i, i])
            c = np.arctan2(m[i, j], sig*m[i, lx])
        else:
            # b in {0, pi}: only a+c (at 0) or a-c (at pi) is
            # defined; fold it into a.  At b == 0 the product is
            # Ri(a+c) (m[j,l] = -sig sin); at b == pi it is
            # Ri(a-c) Rj(pi) (m[j,l] = +sig sin)
            sgn = 1. if m[i, i] > 0 else -1.
            a = np.arctan2(-sgn*sig*m[j, lx], m[j, j])
            b = np.arctan2(sb, m[i, i])
            c = 0.
        return a, b, c
    # Tait-Bryan sequence Ri(a) Rj(b) Rk(c).
    # Row i:    m[i,i] = cb cc, m[i,j] = -sig cb sc, m[i,k] = sig sb
    # Column k: m[j,k] = -sig cb sa, m[k,k] = cb ca
    cb = np.hypot(m[i, i], m[i, j])
    if cb > eps:
        a = np.arctan2(-sig*m[j, k], m[k, k])
        b = np.arctan2(sig*m[i, k], cb)
        c = np.arctan2(-sig*m[i, j], m[i, i])
    else:
        # gimbal lock: at b = +pi/2 the product collapses to
        # Ri(a+c) Rj(pi/2), at b = -pi/2 to Ri(a-c) Rj(-pi/2); fold
        # the free combination into a (m[j,i] = sign(sb) sin d,
        # m[j,j] = cos d)
        sgn = 1. if sig*m[i, k] > 0 else -1.
        a = np.arctan2(sgn*m[j, i], m[j, j])
        b = np.arctan2(sig*m[i, k], cb)
        c = 0.
    return a, b, c


# -- quaternion family ---------------------------------------------------
#
# The reference vendors these in its Gohlke transformations module
# (transformations.py:996-1310) but never calls them from rayopt
# itself; implemented here from first principles for full surface
# parity.  Convention: (w, x, y, z), scalar first, unit quaternions
# for rotations.

def quaternion_about_axis(angle, axis):
    """Unit quaternion for a rotation by `angle` about `axis`."""
    d = np.asarray(axis, dtype=float)[:3]
    n = np.linalg.norm(d)
    if n == 0:
        return np.array([1., 0., 0., 0.])
    h = 0.5*angle
    return np.concatenate([[np.cos(h)], np.sin(h)*d/n])


def quaternion_multiply(q1, q0):
    """Hamilton product q1 * q0 (apply q0 first, then q1)."""
    w1, x1, y1, z1 = np.asarray(q1, dtype=float)
    w0, x0, y0, z0 = np.asarray(q0, dtype=float)
    return np.array([
        w1*w0 - x1*x0 - y1*y0 - z1*z0,
        w1*x0 + x1*w0 + y1*z0 - z1*y0,
        w1*y0 - x1*z0 + y1*w0 + z1*x0,
        w1*z0 + x1*y0 - y1*x0 + z1*w0])


def quaternion_conjugate(q):
    q = np.asarray(q, dtype=float)
    return q*np.array([1., -1., -1., -1.])


def quaternion_inverse(q):
    q = np.asarray(q, dtype=float)
    return quaternion_conjugate(q)/np.dot(q, q)


def quaternion_matrix(q):
    """3x3 rotation matrix of a (not necessarily unit) quaternion."""
    q = np.asarray(q, dtype=float)
    nn = np.dot(q, q)
    if nn == 0:
        return np.eye(3)
    w, x, y, z = q/np.sqrt(nn)
    return np.array([
        [1 - 2*(y*y + z*z), 2*(x*y - w*z), 2*(x*z + w*y)],
        [2*(x*y + w*z), 1 - 2*(x*x + z*z), 2*(y*z - w*x)],
        [2*(x*z - w*y), 2*(y*z + w*x), 1 - 2*(x*x + y*y)]])


def quaternion_from_matrix(matrix):
    """Unit quaternion of a rotation matrix (Shepperd's method: pick
    the largest of the four squared components from the trace and the
    diagonal, so the division is always well-conditioned)."""
    m = np.asarray(matrix, dtype=float)[:3, :3]
    tr = m.trace()
    choices = np.array([tr, m[0, 0], m[1, 1], m[2, 2]])
    i = int(np.argmax(choices))
    if i == 0:
        w = 0.5*np.sqrt(1. + tr)
        f = 0.25/w
        q = np.array([w, f*(m[2, 1] - m[1, 2]), f*(m[0, 2] - m[2, 0]),
                      f*(m[1, 0] - m[0, 1])])
    else:
        j, k = i % 3, (i + 1) % 3  # i is 1-based axis index here
        a, b, c = i - 1, j, k  # axis indices 0..2
        s = 0.5*np.sqrt(1. + m[a, a] - m[b, b] - m[c, c])
        f = 0.25/s
        q = np.zeros(4)
        q[0] = f*(m[c, b] - m[b, c])
        q[1 + a] = s
        q[1 + b] = f*(m[b, a] + m[a, b])
        q[1 + c] = f*(m[c, a] + m[a, c])
    # canonical sign: non-negative scalar part
    return q if q[0] >= 0 else -q


def quaternion_slerp(q0, q1, fraction):
    """Spherical linear interpolation between unit quaternions along
    the shorter great-circle arc."""
    q0 = np.asarray(q0, dtype=float)/np.linalg.norm(q0)
    q1 = np.asarray(q1, dtype=float)/np.linalg.norm(q1)
    d = np.dot(q0, q1)
    if d < 0:  # shorter arc
        q1, d = -q1, -d
    d = min(d, 1.)
    theta = np.arccos(d)
    if theta < 1e-12:
        out = q0 + fraction*(q1 - q0)  # nearly parallel: lerp
        return out/np.linalg.norm(out)
    return (np.sin((1 - fraction)*theta)*q0
            + np.sin(fraction*theta)*q1)/np.sin(theta)


def quaternion_from_euler(ai=0., aj=0., ak=0., axes="sxyz"):
    return quaternion_from_matrix(euler_matrix(ai, aj, ak, axes))


def euler_from_quaternion(q, axes="sxyz"):
    return euler_from_matrix(quaternion_matrix(q), axes)


def random_quaternion(rng=None):
    """Uniformly random unit rotation quaternion (Shoemake)."""
    rng = np.random.RandomState() if rng is None else rng
    u1, u2, u3 = rng.uniform(size=3)
    a, b = np.sqrt(1 - u1), np.sqrt(u1)
    return np.array([a*np.sin(2*np.pi*u2), a*np.cos(2*np.pi*u2),
                     b*np.sin(2*np.pi*u3), b*np.cos(2*np.pi*u3)])


def superimposition_matrix(v0, v1, scale=False):
    """4x4 homogeneous transform mapping point set v0 (3, N) onto v1
    (least squares; Kabsch/Umeyama via SVD of the cross-covariance --
    a different, better-conditioned derivation than the reference's
    quaternion-eigenvector construction, same result).  With `scale`
    a uniform scale factor is solved too."""
    p = np.asarray(v0, dtype=float)[:3]
    q = np.asarray(v1, dtype=float)[:3]
    mp, mq = p.mean(1, keepdims=True), q.mean(1, keepdims=True)
    pc, qc = p - mp, q - mq
    u, sv, vt = np.linalg.svd(qc @ pc.T)
    d = np.sign(np.linalg.det(u @ vt))
    dd = np.diag([1., 1., d])
    r = u @ dd @ vt
    s = 1.
    if scale:
        s = (sv @ np.diag([1., 1., d]).diagonal())/np.square(pc).sum()
    out = np.eye(4)
    out[:3, :3] = s*r
    out[:3, 3:] = mq - s*(r @ mp)
    return out
