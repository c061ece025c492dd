"""Element/Interface/Spheroid/Biconic/Toroid/FreeformXY/ZernikeSag/
Grating/DiffractiveSurface: the serializable surface front-end.

API parity with reference elements.py (TransformMixin:30, Element:179,
Interface:276, Spheroid:413, Biconic:545, Toroid:671) and with the JAX
package's FreeformXY, ZernikeSag, Grating and DiffractiveSurface.
These objects are a thin, host-side description layer: `System` lowers
a list of them into the struct-of-arrays `SurfaceTable` (ops.tables)
that the trace engines consume.  The per-element numeric methods take and return NumPy
arrays; they evaluate the torch surface oracle (ops.surfaces) on CPU
float64 tensors, so both paths share one implementation of the
physics.

The JAX package's Forbes Qcon element is not ported yet.
"""

import numpy as np
import torch

from .utils.registry import NameMixin
from .utils.geometry import rotation_matrix, euler_matrix, euler_from_matrix
from .materials import Material
from .ops import surfaces as _ops

Z_AXIS = np.array([0., 0., 1.])


def _t(x):
    """Host array -> CPU float64 tensor."""
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=torch.float64)


def _np(x):
    return x.numpy()


def _swing_rotation(axis, angle):
    """Rotation by `angle` about `axis` (degenerate axis -> x)."""
    if np.allclose(axis, 0):
        axis = (1., 0., 0.)
    return rotation_matrix(angle, axis)


def _pose_field(name):
    """Property for one component of the (distance, direction, angles)
    pose triple; writing any component re-runs the combined update."""

    def read(self):
        return getattr(self, "_" + name)

    def write(self, value):
        pose = {k: getattr(self, "_" + k)
                for k in ("distance", "direction", "angles")}
        pose[name] = value
        self.update(**pose)

    return property(read, write)


class TransformMixin:
    """Position/orientation of an element relative to the previous one
    (reference elements.py:30-175): offset = distance*direction in the
    lab frame, plus intrinsic-xyz tilt angles."""

    distance = _pose_field("distance")
    direction = _pose_field("direction")
    angles = _pose_field("angles")

    def __init__(self, distance=0., direction=(0, 0, 1.), angles=(0, 0, 0),
                 offset=None):
        self.update(distance, direction, angles)
        if offset is not None:
            self.offset = offset

    def dict(self):
        dat = {}
        if self.distance:
            dat["distance"] = float(self.distance)
        if not self.straight:
            dat["direction"] = list(map(float, self.direction))
        if not self.normal:
            dat["angles"] = list(map(float, self.angles))
        return dat

    @property
    def offset(self):
        return self._offset

    @offset.setter
    def offset(self, offset):
        length = np.linalg.norm(offset)
        heading = offset/length if length else Z_AXIS
        self.update(length, heading, self._angles)

    def update(self, distance, direction, angles):
        norm = np.linalg.norm(direction)
        heading = (np.asarray(direction, dtype=float)/norm if norm
                   else Z_AXIS.copy())
        if distance < 0:
            distance, heading = -distance, -heading
        tilt = np.asarray(angles, dtype=float)
        self._distance = distance
        self._direction = heading
        # inf*0 would NaN the transverse components of an infinite
        # axial gap (e.g. a .zmx object row with DISZ INFINITY)
        if np.isfinite(distance):
            self._offset = distance*heading
        else:
            off = np.zeros(3)
            nz = heading != 0.
            off[nz] = distance*heading[nz]
            self._offset = off
        self._angles = tilt
        self.straight = np.allclose(heading, Z_AXIS)
        self.normal = np.allclose(tilt, 0.)
        self.rotated = not (self.straight and self.normal)
        self.rot_axis = None
        self.rot_normal = None
        if not self.rotated:
            return
        frame = np.eye(3)
        if not self.straight:
            # rotation carrying z onto the heading
            swing = np.cross(heading, Z_AXIS)
            amount = np.arcsin(np.linalg.norm(swing))
            if heading[2] < 0:
                amount = np.pi - amount
            self.rot_axis = _swing_rotation(swing, amount)
            frame = frame @ self.rot_axis
        if not self.normal:
            frame = frame @ euler_matrix(*tuple(tilt), axes="rxyz")
        self.rot_normal = frame

    @property
    def incidence(self):
        """Optical-axis direction in surface-normal coordinates."""
        return self.to_normal(self._direction)

    def excidence(self, mu):
        """Axial-ray direction after refraction with ratio mu:
        vector Snell about the local z normal
        (reference elements.py:93)."""
        inc = self.incidence
        if mu == 1:
            return inc
        cos_in = abs(mu)*inc[2]
        cos_out = np.sign(mu)*np.sqrt(cos_in**2 + 1 - mu**2)
        return abs(mu)*inc + (cos_out - cos_in)*Z_AXIS

    def align(self, direction, mu):
        """Tilt the surface so `direction` becomes the excidence of the
        axial ray (reference elements.py:103): the surface normal must
        bisect (in Snell's sense) incidence and target excidence."""
        inc = self.direction
        bisector = mu*inc - np.asarray(direction, dtype=float)
        if mu < 1:
            bisector = -bisector
        if np.allclose(bisector, 0):
            bisector = Z_AXIS.copy()
        bisector /= np.linalg.norm(bisector)
        swing = np.cross(inc, bisector)
        amount = np.arcsin(np.linalg.norm(swing))
        frame = _swing_rotation(swing, amount).T
        self.update(self.distance, self.direction,
                    euler_from_matrix(frame, "rxyz"))

    def _rotate(self, rotation, inverse, flag, ys):
        if flag:
            if inverse:
                rotation = rotation.T
            ys = tuple(np.dot(yi, rotation) for yi in ys)
        if len(ys) == 1:
            return ys[0]
        return ys

    def from_axis(self, *y):
        return self._rotate(self.rot_axis, False, not self.straight, y)

    def to_axis(self, *y):
        return self._rotate(self.rot_axis, True, not self.straight, y)

    def from_normal(self, *y):
        return self._rotate(self.rot_normal, False, self.rotated, y)

    def to_normal(self, *y):
        return self._rotate(self.rot_normal, True, self.rotated, y)


def set_pose(element, offset, matrix):
    """Pose `element` so its vertex offset (global frame, from the
    previous vertex) is `offset` and its global->local rotation
    (rot_normal) equals `matrix`.

    TransformMixin couples direction to the offset vector and
    composes rot_normal = rot_axis(direction) @ euler(angles); the
    residual euler factor is solved for here.  Used by importers that
    fold cumulative coordinate transforms (Zemax COORDBRK) into
    per-surface poses."""
    element.offset = np.asarray(offset, dtype=float)
    matrix = np.asarray(matrix, dtype=float)
    residual = (matrix if element.rot_axis is None
                else element.rot_axis.T @ matrix)
    if np.allclose(residual, np.eye(3)):
        angles = (0., 0., 0.)
    else:
        angles = euler_from_matrix(residual, "rxyz")
    element.update(element.distance, element.direction, angles)
    got = element.rot_normal if element.rot_normal is not None \
        else np.eye(3)
    assert np.allclose(got, matrix, atol=1e-12), (got, matrix)
    return element


class Element(NameMixin, TransformMixin):
    """A bare reference plane with an aperture
    (reference elements.py:179)."""

    _default_type = "spheroid"

    def __init__(self, radius=np.inf, diameter=None, **kwargs):
        super().__init__(**kwargs)
        self.radius = radius if diameter is None else diameter/2

    def dict(self):
        dat = NameMixin.dict(self)
        dat.update(TransformMixin.dict(self))
        if np.isfinite(self.radius):
            dat["radius"] = float(self.radius)
        return dat

    def intercept(self, y, u):
        return -y[:, 2]/u[:, 2]

    def refract(self, y, u0, mu):
        return u0

    def clip(self, y, u):
        return _np(_ops.clip_aperture(_t(y), _t(u), self.radius))

    def propagate_paraxial(self, yu0, n0, l):
        n, m = self.paraxial_matrix(n0, l)
        return np.dot(m, yu0), n

    def propagate_gaussian(self, q0i, n0, l):
        n, m = self.paraxial_matrix(n0, l)
        a, b = m[:2, :2], m[:2, 2:]
        c, d = m[2:, :2], m[2:, 2:]
        qi = np.dot(c + np.dot(d, q0i), np.linalg.inv(a + np.dot(b, q0i)))
        return qi, n

    def paraxial_matrix(self, n0, l):
        # 4x4 block matrix [[A, B], [C, D]], sagittal/tangential
        # interleaved; free propagation (reference elements.py:223)
        m = np.eye(4)
        m[0, 2] = m[1, 3] = self.distance/n0
        return n0, m

    def propagate(self, y0, u0, n0, l, clip=True):
        t = self.intercept(y0, u0)
        y = y0 + t[:, None]*u0
        if clip:
            u0 = self.clip(y, u0)
        return y, u0, n0, t*n0

    def reverse(self):
        pass

    def rescale(self, scale):
        self.distance *= scale
        self.radius *= scale

    def surface_cut(self, axis, points):
        # an infinite aperture (open plane) draws as its vertex: a
        # finite outline cannot represent it and inf poisons the
        # layout transforms
        rad = self.radius if np.isfinite(self.radius) else 0.
        xyz = np.zeros((2, 3))
        xyz[:, axis] = -rad, rad
        return xyz

    def aberration(self, *args):
        return 0

    def dispersion(self, *args):
        return 0

    # polynomial-trace hooks (reference elements.py:238-253); the
    # implementations live in trace/poly.py and dispatch on the table,
    # these exist for subclass API parity.
    def propagate_poly(self, state, l):
        raise NotImplementedError


class Interface(Element):
    """An optical interface carrying a material
    (reference elements.py:276)."""

    def __init__(self, material=None, **kwargs):
        super().__init__(**kwargs)
        self.material = Material.make(material) if material else material

    def dict(self):
        dat = super().dict()
        if self.material is not None:
            name = str(self.material)
            if name and name != "-":
                dat["material"] = name
            else:
                # unnamed (float-index / nd-vd) materials have no
                # resolvable name: persist their full dict so the
                # YAML/JSON round trip survives (Material.make
                # accepts dicts)
                dat["material"] = self.material.dict()
        return dat

    def get_n_mu(self, n0, l):
        """(index after, refraction ratio) -- mu = n0/n, -1 for mirrors
        (reference elements.py:283)."""
        if self.material is None:
            return n0, 1.
        if self.material.mirror:
            return n0, -1.
        n = self.refractive_index(l)
        return n, n0/n

    def refractive_index(self, wavelength):
        return self.material.refractive_index(wavelength)

    def paraxial_matrix(self, n0, l):
        m = super().paraxial_matrix(n0, l)[1]
        n = n0 if self.material is None else self.refractive_index(l)
        return n, m

    def propagate(self, y0, u0, n0, l, clip=True):
        y, u, _, tn = super().propagate(y0, u0, n0, l, clip)
        n, mu = self.get_n_mu(n0, l)
        if mu:
            u = self.refract(y, u, mu)
        return y, u, n, tn

    def dispersion(self, lmin, lmax):
        if self.material is None:
            return 0.
        return self.material.delta_n(lmin, lmax)

    def surface_sag(self, p):
        raise NotImplementedError

    def surface_normal(self, p):
        raise NotImplementedError

    def edge_sag(self, axis=1):
        rim = np.zeros(3)
        rim[axis] = self.radius
        return self.surface_sag(rim)

    def surface_cut(self, axis, points):
        if self.material is None:
            return super().surface_cut(axis, points)
        rad = self.radius if np.isfinite(self.radius) else 0.
        xyz = np.zeros((points, 3))
        xyz[:, axis] = np.linspace(-rad, rad, points)
        xyz[:, 2] = -self.surface_sag(xyz)
        return xyz


@Element.register
class Spheroid(Interface):
    """Conic surface with even aspheric terms
    (reference elements.py:413)."""

    def __init__(self, curvature=0., conic=0., aspherics=None, roc=None,
                 alternate_intersection=False, aspherics_odd=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.curvature = curvature if roc is None else 1./roc
        self.conic = conic
        self.aspherics = None if aspherics is None else list(aspherics)
        self.aspherics_odd = (None if aspherics_odd is None
                              else list(aspherics_odd))
        self.alternate_intersection = alternate_intersection
        if self.curvature and np.isfinite(self.radius) and self.conic > -1:
            # the aperture must not extend past the conic's equator
            assert self.radius**2 <= 1/((1 + self.conic)*self.curvature**2)

    def dict(self):
        dat = super().dict()
        for key in ("curvature", "conic"):
            if getattr(self, key):
                dat[key] = float(getattr(self, key))
        if self.aspherics is not None:
            dat["aspherics"] = list(map(float, self.aspherics))
        if self.aspherics_odd is not None:
            dat["aspherics_odd"] = list(map(float, self.aspherics_odd))
        if self.alternate_intersection:
            dat["alternate_intersection"] = True
        return dat

    @property
    def _aspheric_arr(self):
        return _t(np.zeros(0) if self.aspherics is None
                  else self.aspherics)

    @property
    def _aspheric_odd_arr(self):
        return _t(np.zeros(0) if self.aspherics_odd is None
                  else self.aspherics_odd)

    def surface_sag(self, xyz):
        return _np(_ops.surface_sag(_t(xyz), self.curvature, self.conic,
                                    self._aspheric_arr,
                                    self._aspheric_odd_arr))

    def surface_normal(self, xyz):
        return _np(_ops.surface_normal(_t(xyz), self.curvature,
                                       self.conic, self._aspheric_arr,
                                       self._aspheric_odd_arr))

    def intercept(self, y, u):
        return _np(_ops.intercept(
            _t(y), _t(u), self.curvature, self.conic,
            self._aspheric_arr,
            alternate=1. if self.alternate_intersection else 0.,
            aspherics_odd=self._aspheric_odd_arr))

    def refract(self, y, u0, mu):
        return _np(_ops.refract(_t(y), _t(u0), mu, self.curvature,
                                self.conic, self._aspheric_arr,
                                aspherics_odd=self._aspheric_odd_arr))

    def _vertex_power(self):
        """Paraxial curvature: base + the r^2 aspheric term.

        Odd aspheric terms are ignored: r**(2j+1) figures are not
        twice differentiable at the vertex (an r**1 term is a cone),
        so they contribute no well-defined paraxial power.
        """
        if self.aspherics:
            return self.curvature + 2*self.aspherics[0]
        return self.curvature

    def _vertex_power_x(self):
        """x-axis paraxial power; anamorphic subclasses override."""
        return self._vertex_power()

    def paraxial_matrix(self, n0, l):
        """Massey & Siegman (Appl. Opt. 8, 975 (1969)) refraction/
        reflection at a tilted surface, composed with the incoming free
        propagation (reference elements.py:503-541).  Interleaved
        (sag, tan, sag', tan') state; an azimuth (z) tilt conjugates
        the matrix with the reference's pseudo-rotation.  The x (sag)
        and y (tan) power slots read _vertex_power_x/_vertex_power, so
        anamorphic subclasses get per-axis power by overriding the
        hooks alone."""
        n, gap = super().paraxial_matrix(n0, l)
        cy = self._vertex_power()
        cx = self._vertex_power_x()
        tilt = 0. if self.angles is None else self.angles[0]
        ct = np.cos(tilt)
        bend = np.eye(4)
        if self.material is not None and self.material.mirror:
            bend[2, 0] = 2*cx*ct
            bend[3, 1] = 2*cy/ct
        elif self.material is not None:
            nr = n/n0
            # generalized cosine of the refracted axial ray
            p = np.sqrt(nr*nr - 1 + ct*ct)
            bend[1, 1] = p/(nr*ct)
            bend[3, 3] = nr*ct/p
            bend[2, 0] = n0*cx*(ct - p)
            bend[3, 1] = nr*n0*cy*(ct - p)/(ct*p)
        m = bend @ gap
        roll = 0. if self.angles is None else self.angles[2]
        if roll:
            cr, sr = np.cos(roll), np.sin(roll)
            spin = np.zeros((4, 4))
            spin[0, 0] = spin[2, 2] = cr
            spin[0, 1] = spin[2, 3] = -sr
            spin[1, 0] = spin[3, 2] = sr
            spin[1, 1] = spin[3, 3] = -cr
            m = spin @ m @ spin.T
        return n, m

    def reverse(self):
        super().reverse()
        self.curvature = -self.curvature
        if self.aspherics is not None:
            self.aspherics = [-ai for ai in self.aspherics]
        if self.aspherics_odd is not None:
            self.aspherics_odd = [-ai for ai in self.aspherics_odd]

    def rescale(self, scale):
        super().rescale(scale)
        self.curvature /= scale
        if self.aspherics is not None:
            self.aspherics = [ai/scale**(2*i + 1) for i, ai
                              in enumerate(self.aspherics)]
        if self.aspherics_odd is not None:
            # o_j multiplies r**(2j+1): units length**(-2j)
            self.aspherics_odd = [ai/scale**(2*i) for i, ai
                                  in enumerate(self.aspherics_odd)]

    def aberration(self, y, u0, u, n0, n, v0, v):
        """Per-surface third-order (Seidel) transverse contributions
        plus axial/lateral chromatic (reference elements.py:556-587).

        y: (marginal, chief) heights; u0/u: n*u slopes before/after;
        v0/v: dispersion delta-n before/after.
        """
        c = self.curvature
        # fourth-order figure term: conic + first two even aspherics
        quartic = self.conic*c**3/8
        if self.aspherics:
            a2, a4 = (self.aspherics + [0., 0.])[:2]
            quartic += a4 - a2*(4*a2**2 + 6*c*a2 + 3*c**2)/4
            c = c + 2*a2
        if self.material and self.material.mirror:
            n = -n
        mu = n0/n
        inc = c*y + u0/n0                     # paraxial incidence
        lag = u[0]*y[1] - u[1]*y[0]           # Lagrange invariant
        # a degenerate paraxial ray pair (lag == 0: no field or no
        # aperture) has undefined Seidel shares -- produce the NaNs
        # deliberately (the framework's vignetting convention) instead
        # of letting the divides warn on the host
        with np.errstate(divide="ignore", invalid="ignore"):
            seidel = y*(n0*(1 - mu)/(2*lag))*(inc + u/n)
            figure = 4*quartic*n*(1 - mu)/lag
            marg, chief = y
            spherical = seidel[0]*inc[0]**2 + figure*marg**4
            coma = seidel[0]*inc[0]*inc[1] + figure*marg**3*chief
            astig = seidel[0]*inc[1]**2 + figure*(marg*chief)**2
            petzval = (1 - mu)*c*lag/(2*n0)
            distortion = (seidel[1]*inc[0]*inc[1]
                          + (u[1]**2/n**2 - u0[1]**2/n0**2)/2
                          + figure*marg*chief**3)
            axial_chr, lateral_chr = -y[0]*inc/lag*(v0 - mu*v)
        return (spherical, coma, astig, petzval, distortion,
                axial_chr, lateral_chr)


def _rays(v):
    """A host (N, 3) ray array (or one ray) as CPU float64 components."""
    v = _t(np.atleast_2d(np.asarray(v, dtype=float)))
    return v[..., 0], v[..., 1], v[..., 2]


@Element.register
class Biconic(Spheroid):
    """Anamorphic (biconic) surface: independent x/y vertex curvature
    and conic, shared rotationally symmetric aspheric terms (reference
    elements.py:545),

    sag = (cx x^2 + cy y^2) /
          (1 + sqrt(1 - (1+kx) cx^2 x^2 - (1+ky) cy^2 y^2)) + poly(r^2)

    `curvature`/`conic` are the y-axis figure (a Biconic with
    curvature_x == curvature behaves as a Spheroid), and a cylinder
    lens is curvature_x=0 (power in y) or curvature=0 (power in x).
    The paraxial 4x4 carries the per-axis power (_vertex_power_x)."""

    _type = "biconic"

    def __init__(self, curvature_x=0., conic_x=0., roc_x=None, **kwargs):
        super().__init__(**kwargs)
        self.curvature_x = curvature_x if roc_x is None else 1./roc_x
        self.conic_x = conic_x

    def dict(self):
        dat = super().dict()
        if self.curvature_x:
            dat["curvature_x"] = float(self.curvature_x)
        if self.conic_x:
            dat["conic_x"] = float(self.conic_x)
        return dat

    def _figure(self):
        """(cx, kx, cy, ky) as CPU float64 tensors."""
        return tuple(_t(v) for v in (self.curvature_x, self.conic_x,
                                     self.curvature, self.conic))

    def surface_sag(self, xyz):
        from .ops import kernels as _K
        x, y, z = _rays(xyz)
        out = _K.sag_biconic(x, y, z, *self._figure(), self._aspheric_arr,
                             self._aspheric_odd_arr)
        return _np(out).reshape(np.shape(xyz)[:-1])

    def surface_normal(self, xyz):
        from .ops import kernels as _K
        x, y, _ = _rays(xyz)
        gx, gy = _K.normal_biconic(x, y, *self._figure(),
                                   self._aspheric_arr,
                                   self._aspheric_odd_arr)
        out = np.stack([_np(gx), _np(gy), np.ones(gx.shape)], axis=-1)
        return out.reshape(np.shape(xyz))

    def intercept(self, y, u):
        from .ops import kernels as _K
        return _np(_K.intercept_biconic(
            *_rays(y), *_rays(u), *self._figure(), self._aspheric_arr,
            1. if self.alternate_intersection else 0.,
            aspherics_odd=self._aspheric_odd_arr))

    def refract(self, y, u0, mu):
        from .ops import kernels as _K
        x, yy, _ = _rays(y)
        out = _K.refract_biconic(x, yy, *_rays(u0), _t(mu), *self._figure(),
                                 self._aspheric_arr, self._aspheric_odd_arr)
        return np.stack([_np(o) for o in out], axis=-1)

    def _vertex_power_x(self):
        if self.aspherics:
            return self.curvature_x + 2*self.aspherics[0]
        return self.curvature_x

    def reverse(self):
        super().reverse()
        self.curvature_x = -self.curvature_x

    def rescale(self, scale):
        super().rescale(scale)
        self.curvature_x /= scale


@Element.register
class Toroid(Spheroid):
    """Toroidal surface: the y-z generating curve (conic `curvature`/
    `conic` + the polynomial figure, all in y) swept about an axis
    parallel to y at rotation radius R = 1/curvature_rotation (reference
    elements.py:671; the Zemax TOROIDAL model).  curvature_rotation == 0
    degenerates to a pure y-cylinder; at the vertex the x-curvature is
    curvature_rotation (_vertex_power_x)."""

    _type = "toroid"

    def __init__(self, curvature_rotation=0., roc_rotation=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.curvature_rotation = (curvature_rotation if roc_rotation is None
                                   else 1./roc_rotation)

    def dict(self):
        dat = super().dict()
        if self.curvature_rotation:
            dat["curvature_rotation"] = float(self.curvature_rotation)
        return dat

    @property
    def curvature_x(self):
        return self.curvature_rotation

    @property
    def conic_x(self):
        return 0.

    def _vertex_power_x(self):
        return self.curvature_rotation

    def _figure(self):
        """(cr, cy, ky) as CPU float64 tensors."""
        return tuple(_t(v) for v in (self.curvature_rotation,
                                     self.curvature, self.conic))

    def surface_sag(self, xyz):
        from .ops import kernels as _K
        x, y, z = _rays(xyz)
        out = _K.sag_toroid(x, y, z, *self._figure(), self._aspheric_arr,
                            self._aspheric_odd_arr)
        return _np(out).reshape(np.shape(xyz)[:-1])

    def surface_normal(self, xyz):
        from .ops import kernels as _K
        x, y, _ = _rays(xyz)
        gx, gy = _K.normal_toroid(x, y, *self._figure(), self._aspheric_arr,
                                  self._aspheric_odd_arr)
        out = np.stack([_np(gx), _np(gy), np.ones(gx.shape)], axis=-1)
        return out.reshape(np.shape(xyz))

    def intercept(self, y, u):
        from .ops import kernels as _K
        return _np(_K.intercept_toroid(
            *_rays(y), *_rays(u), *self._figure(), self._aspheric_arr,
            1. if self.alternate_intersection else 0.,
            aspherics_odd=self._aspheric_odd_arr))

    def refract(self, y, u0, mu):
        from .ops import kernels as _K
        x, yy, _ = _rays(y)
        out = _K.refract_toroid(x, yy, *_rays(u0), _t(mu), *self._figure(),
                                self._aspheric_arr, self._aspheric_odd_arr)
        return np.stack([_np(o) for o in out], axis=-1)

    def reverse(self):
        super().reverse()
        self.curvature_rotation = -self.curvature_rotation

    def rescale(self, scale):
        super().rescale(scale)
        self.curvature_rotation /= scale


@Element.register
class FreeformXY(Spheroid):
    """Freeform surface (the JAX package's FreeformXY): a conic/aspheric
    base plus a general XY-polynomial figure,

        sag = conic(r2) + poly(r2) + sum_t A_t (x/R)^i (y/R)^j

    with the triangular term ordering of ops.kernels._xy_terms (x, y,
    x^2, xy, y^2, x^3, ...) and no constant term: sag(0, 0) == 0 and the
    vertex carries any piston.  `norm_radius` R normalizes the
    coordinates, so each A_t is the term's sag (in lens units) at the
    normalization radius; System.table lowers the row to the
    denormalized monomials A_t/R^(i+j) (`_xy_arr`).

    Linear terms tilt the vertex tangent plane and add no paraxial
    power; the quadratic terms feed per-axis paraxial power (cx += 2
    A_(2,0)/R^2, cy += 2 A_(0,2)/R^2; the xy cross term is ignored at
    first order).  Optimize the normalized coefficients:
    parallel.grad.optimize_grad(select=("xy_poly",), scales={"xy_poly":
    freeform_scales(system)}), seeding the row with tiny nonzero values
    (an exactly-zero row is baked out of the specialization and carries
    zero gradient by design)."""

    _type = "xypoly"

    def __init__(self, xy_coefficients=None, norm_radius=1., **kwargs):
        super().__init__(**kwargs)
        self.xy_coefficients = (None if xy_coefficients is None
                                else list(xy_coefficients))
        self.norm_radius = float(norm_radius)

    def dict(self):
        dat = super().dict()
        if self.xy_coefficients is not None:
            dat["xy_coefficients"] = list(map(float, self.xy_coefficients))
        if self.norm_radius != 1.:
            dat["norm_radius"] = float(self.norm_radius)
        return dat

    @property
    def _xy_arr(self):
        """Denormalized monomial coefficients, zero-padded to a full
        triangle: term t multiplies x^i y^j in lens units."""
        from .ops.kernels import _xy_terms
        a = np.asarray(self.xy_coefficients or (), dtype=float)
        if not a.size:
            return np.zeros(0)
        deg, n = 0, 0
        while n < a.size:
            deg += 1
            n += deg + 1
        out = np.zeros(n)
        out[:a.size] = a
        scale = np.array([self.norm_radius**(i + j)
                          for i, j in _xy_terms(deg)])
        return out/scale

    def surface_sag(self, xyz):
        return _np(_ops.surface_sag(_t(xyz), self.curvature, self.conic,
                                    self._aspheric_arr,
                                    self._aspheric_odd_arr,
                                    _t(self._xy_arr)))

    def surface_normal(self, xyz):
        return _np(_ops.surface_normal(_t(xyz), self.curvature,
                                       self.conic, self._aspheric_arr,
                                       self._aspheric_odd_arr,
                                       _t(self._xy_arr)))

    def intercept(self, y, u):
        return _np(_ops.intercept(
            _t(y), _t(u), self.curvature, self.conic,
            self._aspheric_arr,
            alternate=1. if self.alternate_intersection else 0.,
            aspherics_odd=self._aspheric_odd_arr,
            xy_poly=_t(self._xy_arr)))

    def refract(self, y, u0, mu):
        return _np(_ops.refract(_t(y), _t(u0), mu, self.curvature,
                                self.conic, self._aspheric_arr,
                                aspherics_odd=self._aspheric_odd_arr,
                                xy_poly=_t(self._xy_arr)))

    def _xy_quadratic(self):
        """(2 c20, 2 c11, 2 c02): the freeform figure's second-derivative
        curvatures at the vertex (denormalized)."""
        a = self._xy_arr
        if a.size < 5:
            return 0., 0., 0.
        return 2*a[2], 2*a[3], 2*a[4]

    def _vertex_power(self):
        return super()._vertex_power() + self._xy_quadratic()[2]

    def _vertex_power_x(self):
        return super()._vertex_power() + self._xy_quadratic()[0]

    def reverse(self):
        super().reverse()
        if self.xy_coefficients is not None:
            self.xy_coefficients = [-a for a in self.xy_coefficients]

    def rescale(self, scale):
        super().rescale(scale)
        self.norm_radius *= scale
        if self.xy_coefficients is not None:
            # A_t is a sag (a length): it scales with the system
            self.xy_coefficients = [a*scale for a in self.xy_coefficients]


@Element.register
class ZernikeSag(FreeformXY):
    """Zernike-sag freeform surface (the JAX package's ZernikeSag): a
    conic/aspheric base plus sum_j z_j Z_j(x/R, y/R) with Z_j the
    orthonormal Noll-ordered Zernikes of utils.zernike, the coefficients
    sag RMS contributions over the normalization disc, in lens units.

    At construction the Zernike sum is lowered exactly onto the
    XY-monomial basis (utils.zernike.zernike_xy_coefficients) and traced
    as a FreeformXY.  The constant (piston) part is dropped so that
    sag(0, 0) == 0 (`piston` keeps it: the vertex is re-referenced to
    the surface)."""

    _type = "zernike"

    def __init__(self, zernike_coefficients=None, norm_radius=1.,
                 **kwargs):
        super().__init__(norm_radius=norm_radius, **kwargs)
        self.zernike_coefficients = list(zernike_coefficients or ())
        self._relower()

    def _relower(self):
        """Recompute the traced XY-monomial lowering from
        `zernike_coefficients` (after in-place edits)."""
        from .utils.zernike import zernike_xy_coefficients
        xy, const = zernike_xy_coefficients(self.zernike_coefficients)
        self.xy_coefficients = xy
        self.piston = const  # the dropped constant (vertex re-reference)

    def dict(self):
        dat = super().dict()
        dat.pop("xy_coefficients", None)
        if self.zernike_coefficients:
            dat["zernike_coefficients"] = list(
                map(float, self.zernike_coefficients))
        return dat

    def reverse(self):
        super().reverse()
        self.zernike_coefficients = [-z for z in self.zernike_coefficients]
        self.piston = -self.piston

    def rescale(self, scale):
        super().rescale(scale)
        self.zernike_coefficients = [z*scale
                                     for z in self.zernike_coefficients]
        self.piston *= scale


@Element.register
class Grating(Spheroid):
    """Linear diffraction grating on a conic/aspheric substrate (the JAX
    package's Grating): grooves ruled along the local x axis
    (dispersion in y), constant line frequency.

    grating_frequency: lines per system length unit (600. is 600 lp/mm
    on a millimeter-scaled system).  grating_order: the traced
    diffraction order m (0 reduces exactly to the substrate's
    refraction or reflection).  The engines trace the generalized
    Spencer & Murty construction n' u' = n u + T q + Gamma n with
    T = m lambda G (kernels.refract_grating); an evanescent order
    vignettes (NaN).  Tilt the element (angles) to orient the ruling.

    The paraxial 4x4 covers the substrate only: the grating deviation
    is affine, not linear."""

    _type = "grating"

    def __init__(self, grating_frequency=0., grating_order=1,
                 blaze_deg=None, **kwargs):
        super().__init__(**kwargs)
        self.grating_frequency = grating_frequency
        self.grating_order = int(grating_order)
        self.blaze_deg = None if blaze_deg is None else float(blaze_deg)

    def dict(self):
        dat = super().dict()
        if self.grating_frequency:
            dat["grating_frequency"] = float(self.grating_frequency)
        if self.grating_order != 1:
            dat["grating_order"] = self.grating_order
        if self.blaze_deg is not None:
            dat["blaze_deg"] = self.blaze_deg
        return dat

    def efficiency(self, wavelength, order=None, incidence_deg=0.,
                   scale=1e-3):
        """Scalar blaze efficiency of `order` (default: the traced
        order) at `wavelength` [m]; 1.0 without a blaze angle (the
        model: rayopt_tpu_torch.gratings).  `scale`: the system length
        unit in meters (pass system.scale when it is not mm)."""
        if self.blaze_deg is None:
            return np.ones_like(np.asarray(wavelength, float))
        from .gratings import blaze_efficiency
        return blaze_efficiency(
            self.grating_order if order is None else order,
            wavelength, self.grating_frequency, self.blaze_deg,
            incidence_deg, scale)

    def refract(self, y, u0, mu):
        raise NotImplementedError(
            "grating refraction is wavelength-dependent; trace "
            "through System.trace_table / the torch engines")

    def reverse(self):
        super().reverse()
        self.grating_frequency = -self.grating_frequency

    def rescale(self, scale):
        super().rescale(scale)
        self.grating_frequency /= scale


@Element.register
class DiffractiveSurface(Spheroid):
    """Radially symmetric diffractive phase profile (kinoform, the
    Zemax Binary 2 model) on a conic/aspheric substrate (the JAX
    package's DiffractiveSurface).

    phase_coefficients: (A_1, A_2, ...), the imprinted phase in radians
    phi(r) = sum_i A_i (r/norm_radius)**(2i); diffraction_order m
    scales the whole profile (0 reduces exactly to the substrate).  The
    engines trace the Spencer & Murty phase-surface construction
    n' u' = n u + (m lambda/2 pi) grad phi + Gamma N, the kick baked per
    trace wavelength into the table's `doe` column (System.table).

    A_1 adds the paraxial power P = -m lambda A_1/(pi norm_radius^2),
    for transmissive and reflective rows alike."""

    _type = "binary2"

    def __init__(self, phase_coefficients=(), norm_radius=1.,
                 diffraction_order=1, **kwargs):
        super().__init__(**kwargs)
        self.phase_coefficients = [float(a) for a in phase_coefficients]
        self.norm_radius = float(norm_radius)
        self.diffraction_order = int(diffraction_order)

    def dict(self):
        dat = super().dict()
        if self.phase_coefficients:
            dat["phase_coefficients"] = [float(a) for a
                                         in self.phase_coefficients]
        if self.norm_radius != 1.:
            dat["norm_radius"] = float(self.norm_radius)
        if self.diffraction_order != 1:
            dat["diffraction_order"] = self.diffraction_order
        return dat

    def paraxial_matrix(self, n0, l):
        n, m = super().paraxial_matrix(n0, l)
        if self.phase_coefficients and self.diffraction_order:
            # System.update stamps _scale (system units per meter); l
            # arrives in meters, A_1 needs it in system units
            lam = l/getattr(self, "_scale", 1e-3)
            p = (self.diffraction_order*lam*self.phase_coefficients[0]
                 / (np.pi*self.norm_radius**2))
            d = np.eye(4)
            d[2, 0] = d[3, 1] = p  # -P_doe
            # an infinite-conjugate gap feeds inf*0 through the
            # composition, as the Seidel path does
            with np.errstate(invalid="ignore"):
                m = d @ m
        return n, m

    def refract(self, y, u0, mu):
        raise NotImplementedError(
            "diffractive refraction is wavelength-dependent; trace "
            "through System.trace_table / the torch engines")

    def rescale(self, scale):
        super().rescale(scale)
        self.norm_radius *= scale
