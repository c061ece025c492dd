"""Pupil parameterizations.

A pupil is a (distance, aperture) pair seen from a conjugate; users
may specify the aperture as a radius, a numerical aperture, a slope,
or an f-number (behavioral parity with reference pupils.py:26-227).
Rather than one subclass per parameterization, a single `Pupil` class
stores whichever quantity was given and converts on demand through a
small conversion table; the registered subclasses are thin shells that
only pin down the stored quantity for serialization.
"""

import numpy as np

from .utils.math import sinarctan, tanarcsin
from .utils.registry import NameMixin


def _slope_to_na(slope, n):
    return n*sinarctan(slope)


def _na_to_slope(na, n):
    return tanarcsin(na/n)


class Pupil(NameMixin):
    """Base pupil.  Subclasses declare which quantity is stored via
    `_param`; everything else is derived."""

    _default_type = "radius"
    _param = None

    def __init__(self, distance=1., update_distance=True,
                 update_radius=False, aim=False, telecentric=False,
                 refractive_index=1., projection="rectilinear"):
        self.distance = distance
        self.update_distance = update_distance
        self.update_radius = update_radius
        self.refractive_index = refractive_index
        self.aim = aim
        self.telecentric = telecentric
        self.projection = projection

    # -- stored-quantity plumbing --------------------------------------

    def _get_param(self):
        return getattr(self, self._param)

    def update(self, distance, radius):
        """Refresh from paraxial data, honoring the update flags."""
        if self.update_distance:
            self.distance = distance
        if self.update_radius:
            self.radius = radius

    def rescale(self, scale):
        self.distance *= scale
        if self._param == "radius":
            self.radius *= scale

    # -- derived quantities ---------------------------------------------

    @property
    def slope(self):
        if self._param == "slope":
            raise AttributeError  # stored directly, see SlopePupil
        if self._param == "radius":
            return self.radius/self.distance
        return _na_to_slope(self.na, self.refractive_index)

    @property
    def radius(self):
        return self.slope*self.distance

    @radius.setter
    def radius(self, r):
        s = r/self.distance
        if self._param == "slope":
            self.slope = s
        elif self._param == "na":
            self.na = _slope_to_na(s, self.refractive_index)
        elif self._param == "fno":
            self.fno = 1/(2*_slope_to_na(s, self.refractive_index))
        else:
            raise AttributeError("radius is derived for %s"
                                 % type(self).__name__)

    @property
    def na(self):
        if self._param == "fno":
            return 1/(2.*self.fno)
        return _slope_to_na(self.slope, self.refractive_index)

    @property
    def fno(self):
        return 1/(2.*self.na)

    # -- sampling --------------------------------------------------------

    def map(self, y, a, filter=True):
        """Fractional pupil coordinates -> the (possibly asymmetric)
        aperture box a = [[-sag, -mer], [+sag, +mer]], elliptically
        filtered (reference pupils.py:97)."""
        pts = np.atleast_2d(y)*np.fabs(a).max()
        if not filter:
            return pts
        return pts[self.inside(y, a)]

    def inside(self, y, a):
        """Elliptical-aperture mask of fractional pupil coordinates
        against the box `a` (the filter `map` applies); callers use it
        to keep per-ray weights aligned with a filtered bundle."""
        pts = np.atleast_2d(y)*np.fabs(a).max()
        center = np.sum(a, axis=0)/2
        half = np.diff(a, axis=0)/2
        return ((pts - center)**2/half**2).sum(1) <= 1

    # -- serialization -----------------------------------------------------

    def dict(self):
        dat = super().dict()
        dat["distance"] = float(self.distance)
        if not self.update_distance:
            dat["update_distance"] = self.update_distance
        if self.update_radius:
            dat["update_radius"] = self.update_radius
        if self.aim:
            dat["aim"] = self.aim
        if self.projection != "rectilinear":
            dat["projection"] = self.projection
        if self.telecentric:
            dat["telecentric"] = self.telecentric
        if self.refractive_index != 1.:
            dat["refractive_index"] = float(self.refractive_index)
        if self._param:
            dat[self._param] = float(self._get_param())
        return dat

    def text(self):
        yield "Pupil Distance: %g" % self.distance
        if self.telecentric:
            yield "Telecentric: %s" % self.telecentric
        if self.refractive_index != 1.:
            yield "Refractive Index: %g" % self.refractive_index
        if self.projection != "rectilinear":
            yield "Projection: %s" % self.projection
        if not self.update_distance:
            yield "Track Distance: %s" % self.update_distance
        if self.update_radius:
            yield "Update Radius: %s" % self.update_radius
        if self.aim:
            yield "Aim: %s" % self.aim
        if self._param:
            label = {"radius": "Radius", "na": "NA", "slope": "Slope",
                     "fno": "F-Number"}[self._param]
            yield "%s: %g" % (label, self._get_param())


@Pupil.register
class RadiusPupil(Pupil):
    _type = "radius"
    _param = "radius"
    radius = None

    def __init__(self, radius, **kwargs):
        super().__init__(**kwargs)
        self.radius = radius

    @property
    def slope(self):
        return self.radius/self.distance


@Pupil.register
class NaPupil(Pupil):
    _type = "na"
    _param = "na"
    na = None

    def __init__(self, na, **kwargs):
        super().__init__(**kwargs)
        self.na = na


@Pupil.register
class SlopePupil(Pupil):
    _type = "slope"
    _param = "slope"
    slope = None

    def __init__(self, slope, **kwargs):
        super().__init__(**kwargs)
        self.slope = slope


@Pupil.register
class FnoPupil(Pupil):
    _type = "fno"
    _param = "fno"
    fno = None

    def __init__(self, fno, **kwargs):
        super().__init__(**kwargs)
        self.fno = fno

    @property
    def na(self):
        return 1/(2.*self.fno)
