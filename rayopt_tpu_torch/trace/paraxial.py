"""Paraxial (first-order) trace: marginal + chief ray ABCD propagation,
first-order properties, and Seidel accumulation.

Parity with reference paraxial_trace.py:28-357.  This host-side class
drives System.update.

The trace state is a 2x2 matrix recursion: per surface the (height,
reduced slope) pair of the marginal and chief rays is advanced by the
axis-projected block of the element's 4x4 Massey-Siegman matrix.
"""

import itertools

import numpy as np

from ..utils.math import sinarctan, tanarcsin
from .base import Trace


class ParaxialTrace(Trace):
    # y[i]: ray height after element i (perpendicular to excidence);
    # u[i]: n*tan(angle) after element i ("the paraxial u is a slope").
    # Two columns: (marginal, chief).  Aplanatic (Abbe sine) conventions
    # as in the reference (paraxial_trace.py:28-44).

    def __init__(self, system, axis=1, update=True):
        super().__init__(system)
        self.axis = axis
        if update:
            self.update()

    def update(self):
        self.allocate()
        self.rays()
        self.propagate()
        self.aberrations()

    @property
    def wavelength(self):
        return self.system.wavelengths[0]

    def allocate(self):
        super().allocate()
        count = self.length
        if getattr(self, "n", None) is not None and len(self.n) == count:
            return
        self.n = np.empty(count)
        self.y = np.empty((count, 2))
        self.u = np.empty((count, 2))
        self.c = np.empty((count, 7))

    def _surface_range(self, start, stop):
        return range(*slice(start, stop).indices(self.length))

    def rays(self):
        """Seed marginal and chief rays from the conjugates
        (reference paraxial_trace.py:66)."""
        obj = self.system.object
        n0 = self.system.refractive_index(self.wavelength, 0)
        if obj.finite:
            # marginal from the axial object point into the pupil,
            # chief from the object edge through the pupil center
            marginal = (0., n0 * obj.pupil.slope)
            chief = (-obj.radius, n0 * obj.slope)
        else:
            # marginal parallel to the axis at the pupil rim, chief
            # at the field angle crossing the pupil center
            angle = 1. if obj.wideangle else np.tan(obj.angle)
            marginal = (obj.pupil.radius, 0.)
            chief = (-obj.slope * obj.pupil.distance, n0 * angle)
        self.n[0] = n0
        self.y[0] = marginal[0], chief[0]
        self.u[0] = marginal[1], chief[1]

    def propagate(self, start=1, stop=None):
        super().propagate()
        # (y; nu) x (marginal, chief) state, advanced by the 2x2
        # axis-projected block of each element's paraxial matrix
        pick = slice(self.axis, None, 2)
        state = np.stack([self.y[start - 1], self.u[start - 1]])
        j = start
        for n, m4 in self.system.paraxial_matrices(
                self.wavelength, start, stop):
            state = m4[pick, pick] @ state
            self.y[j], self.u[j] = state
            self.n[j] = n
            j += 1

    def aberrations(self, start=1, stop=None):
        """Accumulate per-surface third-order coefficients
        (reference paraxial_trace.py:94)."""
        blue = min(self.system.wavelengths)
        red = max(self.system.wavelengths)
        self.c[start - 1] = 0.
        vprev = 0.
        for k in self._surface_range(start, stop):
            el = self.system[k]
            v = el.dispersion(blue, red)
            self.c[k] = el.aberration(
                self.y[k], self.u[k - 1], self.u[k],
                self.n[k - 1], self.n[k], vprev, v)
            vprev = v

    @property
    def transverse3(self):
        """Transverse third-order image aberrations, OSLO scaling
        (reference paraxial_trace.py:105)."""
        return self.c*self.height[1]

    # -- first-order properties (reference paraxial_trace.py:110-211) --
    # Conventions: two-element arrays are (front/object side,
    # back/image side); the "ends" live at surfaces (1, -2) with
    # ambient indices (0, -2).

    _IN = (1, -2)     # first/last optical surface
    _OUT = (0, -2)    # ambient index before/after the ends

    def _end_state(self):
        """(y_end, u_amb, n_amb): ray data at the system ends."""
        return (self.y[self._IN, ], self.u[self._OUT, ],
                self.n[self._OUT, ])

    @property
    def track_length(self):
        return self.track[-2] - self.track[1]

    @property
    def height(self):
        """Object and image chief-ray height."""
        return np.fabs(self.y[(0, -1), 1])

    @property
    def lagrange(self):
        """Optical (Lagrange) invariant of the marginal/chief pair."""
        (m0, c0), (mu, cu) = self.y[0], self.u[0]
        return mu*c0 - cu*m0

    @property
    def pupil_distance(self):
        """Entrance/exit pupil location from the first/last surface:
        where the chief ray crosses the axis."""
        ye, ua, na = self._end_state()
        return -ye[:, 1]/ua[:, 1]*na

    @property
    def pupil_height(self):
        """Marginal-ray height at the pupils."""
        ye, ua, na = self._end_state()
        return np.fabs(ye[:, 0] + self.pupil_distance*ua[:, 0]/na)

    @property
    def focal_length(self):
        """Front/back focal length (principal plane to focus),
        Malacara 2.41/2.42."""
        det = (self.u[0, 1]*self.u[-2, 0] -
               self.u[0, 0]*self.u[-2, 1])
        # afocal/degenerate: det == 0 -> inf focal length, deliberately
        with np.errstate(divide="ignore", invalid="ignore"):
            f = self.lagrange/det
            return np.array([-f*self.n[-2], f*self.n[0]])

    @property
    def focal_distance(self):
        """Front/back focal distance (surface to focus),
        Malacara 2.43/2.44."""
        scale = self.focal_length/self.lagrange/self.n[(-2, 0), ]
        cross = (self.y[self._IN, 1]*self.u[(-2, 0), 0] -
                 self.y[self._IN, 0]*self.u[(-2, 0), 1])
        return cross*scale

    @property
    def principal_distance(self):
        return self.focal_distance - self.focal_length

    @property
    def nodal_distance(self):
        return self.focal_length[::-1] + self.focal_distance

    @property
    def magnification(self):
        transverse = self.u[0, 0]/self.u[-2, 0]
        angular = (self.u[-2, 1]*self.n[0] /
                   (self.u[0, 1]*self.n[-2]))
        return np.array([transverse, angular])

    @property
    def numerical_aperture(self):
        na = self.n[self._OUT, ]
        sines = na*sinarctan(self.u[self._OUT, 0]/na)
        if self.system.object.finite and self.system.image.finite:
            # Abbe sine condition, long-to-short conjugate
            sines[1] = sines[0]/self.magnification[0]
        return np.fabs(sines)

    @property
    def f_number(self):
        return np.fabs(self.focal_length/(2*self.pupil_height))

    @property
    def working_f_number(self):
        # NA == 0 (afocal output) -> inf f-number, deliberately
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.n[self._OUT, ]/(2*self.numerical_aperture)

    @property
    def airy_radius(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return (1.22*self.wavelength/(2*self.numerical_aperture) /
                    self.system.scale)

    @property
    def rayleigh_range(self):
        return (np.pi*self.airy_radius**2/self.wavelength *
                self.system.scale)

    @property
    def number_of_points(self):
        """Resolvable diffraction points (aberration-free)."""
        return 4*self.lagrange**2/self.wavelength**2

    @property
    def eigenrays(self):
        n, m = self.system.paraxial_matrix(self.wavelength)
        return np.linalg.eig(m)

    # -- solves / updates ------------------------------------------------

    def resize(self):
        heights = np.abs(self.y).sum(axis=1)  # marginal + chief
        for k in range(1, self.length):
            self.system[k].radius = heights[k]

    def focal_length_solve(self, f, i=-2):
        """Set curvature of surface `i` so the rear focal length is
        `f`: the marginal slope after it must be -y_in/f."""
        assert i == -2, "only implemented for the last surface"
        target_u = -self.y[0, 0] * self.n[0] / f
        rise = target_u - self.u[i - 1, 0]
        step = self.n[i - 1] - self.n[i]
        self.system[i].curvature = rise / (self.y[i, 0] * step)

    def refocus(self, idx=-1):
        marg_y, marg_u = self.y[idx - 1, 0], self.u[idx - 1, 0]
        self.system[idx].distance = -marg_y / marg_u * self.n[idx - 1]

    def _half_block(self, side):
        """(n, 2x2 axis block) of the system half before ("object") or
        after ("image") the stop."""
        cut = self.system.stop + 1
        pick = slice(self.axis, None, 2)
        if side == "object":
            n, m = self.system.paraxial_matrix(self.wavelength, stop=cut)
            n = self.system.refractive_index(self.wavelength, 0)
        else:
            n, m = self.system.paraxial_matrix(self.wavelength, start=cut)
        return n, m[pick, pick]

    def update_conjugates(self):
        """Derive object/image pupil distance+radius from the ABCD
        blocks through the stop (reference paraxial_trace.py:326)."""
        stop_radius = self.system[self.system.stop].radius
        for side, conj, edge in (
                ("object", self.system.object, self.system[0].radius),
                ("image", self.system.image, self.system[-1].radius)):
            n, m = self._half_block(side)
            if side == "image":
                m = np.linalg.inv(m)
            a, b = m[0]
            conj.update(edge, b * n / a, stop_radius / a)

    def update_stop(self, end="image"):
        """Set the stop radius so the aimed end-conjugate rim ray fills
        it (reference paraxial_trace.py:344)."""
        n, m = self._half_block(end)
        if end == "image":
            m = np.linalg.inv(m)
            y, u = self.system.image.aim((0, 0), (0, -1))
        else:
            y, u = self.system.object.aim((0, 0), (0, 1))
        slope = tanarcsin(u)[0, 1]
        self.system[self.system.stop].radius = \
            m[0, 0] * y[0, 1] + m[0, 1] * slope

    # -- output ----------------------------------------------------------

    def print_transverse3(self):
        return self.print_coeffs(
            self.transverse3,
            "SA3 CMA3 AST3 PTZ3 DIS3 TACHC TCHC".split())

    def print_params(self):
        for label, value in (
                ("lagrange", "%.5g" % self.lagrange),
                ("track length", "%.5g" % self.track_length),
                ("object, image height", self.height),
                ("front, back focal length (from PP)", self.focal_length),
                ("entry, exit pupil height", self.pupil_height),
                ("entry, exit pupil distance", self.pupil_distance),
                ("front, back focal distance", self.focal_distance),
                ("front, back principal distance",
                 self.principal_distance),
                ("front, back nodal distance", self.nodal_distance),
                ("front, back numerical aperture",
                 self.numerical_aperture),
                ("front, back f number", self.f_number),
                ("front, back working f number", self.working_f_number),
                ("front, back airy radius", self.airy_radius),
                ("transverse, angular magnification", self.magnification),
                ):
            yield "%s: %s" % (label, value)

    def print_trace(self):
        cols = np.column_stack((self.path, self.n, self.y[:, 0],
                                self.u[:, 0], self.y[:, 1], self.u[:, 1]))
        return self.print_coeffs(
            cols, "path/n/axial y/axial nu/chief y/chief nu".split("/"),
            sum=False)

    def __str__(self):
        return "\n".join(self.text())

    def text(self):
        return itertools.chain(
            self.print_params(), ("",),
            self.print_trace(), ("",),
            self.print_transverse3(), ("",),
        )

    def _plot_marker(self, ax, end, z_axial, heights, **kwargs):
        """Draw vertical marker segments at axial position `z_axial`
        (relative to the front/back surface per `end` = 0 or -1)."""
        el = self.system[end]
        origin = self.origins[end]
        base = 0. if end == 1 else self.system[-1].distance
        pts = np.array([[h, h, z_axial - base] for h in heights])
        lab = origin + el.from_axis(pts)
        for k in range(0, len(lab) - 1, 2):
            ax.plot(lab[k:k + 2, 2], lab[k:k + 2, self.axis], **kwargs)

    def plot(self, ax, principals=False, pupils=False, focals=False,
             nodals=False, **kwargs):
        kwargs.setdefault("color", "black")
        # the marginal/chief polylines along the unfolded axis
        rays = np.repeat(self.y[:, :, None], 3, axis=2)
        rays[:, :, 2] = self.path[:, None]
        rays = self.from_axis(rays, range(self.length))
        ax.plot(rays[:, :, 2], rays[:, :, self.axis], **kwargs)
        h = self.system.aperture.radius * 1.5
        markers = [(self.principal_distance, principals, (h, -h)),
                   (self.focal_distance, focals, (h, -h)),
                   (self.nodal_distance, nodals, (h, -h))]
        if pupils:
            hp = self.pupil_height
            markers.append((self.pupil_distance, True, None))
        for dist, flag, span in markers:
            if not flag:
                continue
            for end, z in zip((1, -1), dist):
                if span is None:
                    hi = hp[0 if end == 1 else 1]
                    heights = (-1.5 * hi, -hi, hi, 1.5 * hi)
                else:
                    heights = span
                self._plot_marker(ax, end, z, heights, **kwargs)

    def plot_yybar(self, ax, **kwargs):
        kwargs.setdefault("color", "black")
        ax.plot(self.y[:, 0], self.y[:, 1], **kwargs)
