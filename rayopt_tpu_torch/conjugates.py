"""Object/image side specification and ray-aiming seeds.

Behavioral parity with reference conjugates.py:40-255: a Conjugate
owns a Pupil and produces ray origins/directions for fractional
(field, pupil) coordinates; the infinite conjugate supports five field
projections.  Projections are module-level functions; the two
conjugate classes share the pupil-box plumbing.
"""

import numpy as np

from .utils.math import sagittal_meridional, normalize
from .utils.registry import NameMixin
from .pupils import Pupil, RadiusPupil


# -- field projections (fractional field -> unit direction) --------------
# (reference conjugates.py:208-234; the equidistant z component is
# fixed here to produce unit vectors, see docs/STATUS.md)

def _proj_rectilinear(yo, a, n):
    tanv = yo*np.tan(a)
    u = np.hstack((tanv, np.ones((n, 1))))
    return u/np.sqrt(np.square(u).sum(-1))[:, None]

def _proj_stereographic(yo, a, n):
    v = yo*(2*np.tan(a/2))
    r = np.square(v).sum(-1)[:, None]/4
    return np.hstack((v, 1 - r))/(r + 1)

def _proj_equisolid(yo, a, n):
    v = yo*(2*np.sin(a/2))
    r = np.square(v).sum(-1)[:, None]
    return np.hstack((v*np.sqrt(1 - r/4), 1 - r/2))

def _proj_orthographic(yo, a, n):
    v = yo*np.sin(a)
    r = np.square(v).sum(-1)[:, None]
    return np.hstack((v, np.sqrt(1 - r)))

def _proj_equidistant(yo, a, n):
    ang = yo*a
    backward = np.square(ang).sum(-1) > (np.pi/2)**2
    v = np.sin(ang)
    z = np.sqrt(np.maximum(0., 1 - np.square(v).sum(-1)))
    z = np.where(backward, -z, z)[:, None]
    return np.hstack((v, z))


PROJECTIONS = {
    "rectilinear": _proj_rectilinear,
    "stereographic": _proj_stereographic,
    "equisolid": _proj_equisolid,
    "orthographic": _proj_orthographic,
    "equidistant": _proj_equidistant,
}


class Conjugate(NameMixin):
    _default_type = "infinite"
    finite = None

    def __init__(self, pupil=None, projection="rectilinear",
                 update_radius=False):
        self.pupil = (RadiusPupil(radius=0.) if pupil is None
                      else Pupil.make(pupil))
        self.projection = projection
        self.update_radius = update_radius

    @property
    def wideangle(self):
        return self.projection != "rectilinear"

    def rescale(self, scale):
        self.pupil.rescale(scale)

    def _map_pupil(self, yp, z, a, filter, angular):
        """Fractional pupil coordinates -> physical offsets in the
        pupil plane, via the aperture box a (defaulting to the pupil
        radius)."""
        if a is None:
            r = self.pupil.radius
            a = np.array(((-r, -r), (r, r)))
        if angular:
            a = np.arctan2(a, z)
        yp = self.pupil.map(np.atleast_2d(yp), a, filter)
        if angular:
            yp = z*np.tan(yp)
        return yp

    def aim(self, xy, pq, z=None, a=None):
        """Ray origins y and unit directions u for fractional object
        coordinate xy and fractional sagittal/meridional pupil
        coordinate pq.  Aiming is aplanatic: the grid is uniform in
        object-space solid angle (reference conjugates.py:77-93)."""
        raise NotImplementedError

    def dict(self):
        dat = super().dict()
        dat["pupil"] = self.pupil.dict()
        if self.projection != "rectilinear":
            dat["projection"] = self.projection
        return dat

    def text(self):
        if self.projection != "rectilinear":
            yield "Projection: %s" % self.projection
        if self.update_radius:
            yield "Update Radius: %s" % self.update_radius
        yield "Pupil:"
        for line in self.pupil.text():
            yield "  %s" % line


@Conjugate.register
class FiniteConjugate(Conjugate):
    _type = "finite"
    finite = True

    def __init__(self, radius=0., **kwargs):
        super().__init__(**kwargs)
        self.radius = radius

    @property
    def point(self):
        return not self.radius

    @property
    def slope(self):
        return self.radius/self.pupil.distance

    @slope.setter
    def slope(self, c):
        self.radius = self.pupil.distance*c

    def update(self, radius, pupil_distance, pupil_radius):
        self.pupil.update(pupil_distance, pupil_radius)
        if self.update_radius:
            self.radius = radius

    def rescale(self, scale):
        super().rescale(scale)
        self.radius *= scale

    def aim(self, yo, yp=None, z=None, a=None, surface=None,
            filter=True):
        """Origins on the (possibly curved) object surface, directions
        through the pupil coordinates (reference
        conjugates.py:137-166)."""
        if z is None:
            z = self.pupil.distance
        yo = np.atleast_2d(yo)
        if yp is not None:
            yp = self._map_pupil(yp, z, a, filter, angular=True)
            yo, yp = np.broadcast_arrays(yo, yp)
        origin = np.zeros((yo.shape[0], 3))
        origin[..., :2] = -yo*self.radius
        if surface is not None:
            origin[..., 2] = -surface.surface_sag(origin)
        axis_pt = (0, 0, z)
        if self.pupil.telecentric:
            u = np.array(axis_pt, dtype=float) + np.zeros_like(origin)
        else:
            u = axis_pt - origin
        if yp is not None:
            s, m = sagittal_meridional(u, axis_pt)
            u += yp[..., 0, None]*s + yp[..., 1, None]*m
        normalize(u)
        if z < 0:
            u *= -1
        return origin, u

    def dict(self):
        dat = super().dict()
        if self.radius:
            dat["radius"] = float(self.radius)
        return dat

    def text(self):
        yield "Radius: %.3g" % self.radius
        yield from super().text()


@Conjugate.register
class InfiniteConjugate(Conjugate):
    _type = "infinite"
    finite = False

    def __init__(self, angle=0., angle_deg=None,
                 entrance_distance=None, **kwargs):
        super().__init__(**kwargs)
        if angle_deg is not None:
            angle = np.deg2rad(angle_deg)
        self.angle = angle
        # axial distance from the first surface vertex to the
        # entrance pupil: the chief-aim seed of the reference's dead
        # wideangle branch (reference system.py:559-562 and the
        # attribute list comment at reference conjugates.py:35).
        # Defaults to the paraxial pupil distance.
        self.entrance_distance = entrance_distance

    @property
    def point(self):
        return not self.angle

    @property
    def angle_deg(self):
        return np.rad2deg(self.angle)

    @angle_deg.setter
    def angle_deg(self, deg):
        # settable after construction too (beyond reference, where
        # `obj.angle_deg = x` silently created a dead attribute and
        # left `angle` at 0 -- conjugates.py:175-178 upstream)
        self.angle = np.deg2rad(deg)

    @property
    def slope(self):
        return np.tan(self.angle)

    @slope.setter
    def slope(self, c):
        self.angle = np.arctan(c)

    def update(self, radius, pupil_distance, pupil_radius):
        self.pupil.update(pupil_distance, pupil_radius)
        if self.update_radius:
            self.angle = np.arctan2(radius, pupil_distance)

    def map(self, yo, a):
        """Fractional field -> unit direction under the projection."""
        try:
            proj = PROJECTIONS[self.projection]
        except KeyError:
            raise ValueError("unknown projection %r" % self.projection)
        return proj(yo, a, yo.shape[0])

    def aim(self, yo, yp=None, z=None, a=None, surface=None,
            filter=True):
        """Origins back-projected from the entrance-pupil plane along
        the field direction (reference conjugates.py:236-255)."""
        if z is None:
            z = self.pupil.distance
        yo = np.atleast_2d(yo)
        if yp is not None:
            yp = self._map_pupil(yp, z, a, filter, angular=False)
            yo, yp = np.broadcast_arrays(yo, yp)
        u = self.map(yo, self.angle)
        pupil_pt = (0, 0, z)
        origin = pupil_pt - z*u
        if yp is not None:
            s, m = sagittal_meridional(u, pupil_pt)
            origin += yp[..., 0, None]*s + yp[..., 1, None]*m
        if surface is not None:
            origin += surface.intercept(origin, u)[..., None]*u
        return origin, u

    def dict(self):
        dat = super().dict()
        if self.angle:
            dat["angle"] = float(self.angle)
        if self.entrance_distance is not None:
            dat["entrance_distance"] = float(self.entrance_distance)
        return dat

    def text(self):
        yield "Semi-Angle: %.3g deg" % np.rad2deg(self.angle)
        yield from super().text()
