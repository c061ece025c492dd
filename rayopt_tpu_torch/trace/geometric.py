"""GeometricTrace: exact real-ray trace front-end.

API parity with reference geometric_trace.py:30-265.  The per-surface
loop runs over the whole bundle at once in the torch engine
(ops.geometric.trace_rays, through System.trace_table); this class is
a thin NumPy result holder around it.  Trace state is the history
block `y/u/i/t/n` indexed ``[surface, ray, component]`` in each
surface's vertex-normal frame:

* ``y``  intercept position at the surface
* ``i``  direction of incidence arriving at the surface
* ``u``  direction of excidence leaving the surface
* ``t``  path-length increment to reach the surface
* ``n``  refractive index after the surface

Analysis primitives (refocus/OPD/PSF/RMS/Zernike) and bundle
factories (rays_point/clipping) operate on that block.  rays_line is
not ported yet.
"""

import itertools

import numpy as np

from ..utils.math import sinarctan, tanarcsin
from ..utils.distributions import pupil_distribution
from .base import Trace


def _complete_bundle(y, u):
    """Broadcast a seed bundle to matched (N, 3) position/direction
    arrays, zero-padding missing components and solving the forward
    z-direction from unit length when only (x, y) slopes are given."""
    y, u = np.atleast_2d(y, u)
    y, u = np.broadcast_arrays(y, u)
    count, ncomp = y.shape
    pos = np.zeros((count, 3))
    aim = np.zeros((count, 3))
    pos[:, :ncomp] = y
    aim[:, :ncomp] = u
    if ncomp < 3:
        aim[:, 2] = np.sqrt(1. - np.einsum("ij,ij->i", aim[:, :2],
                                           aim[:, :2]))
    return pos, aim


def _grid_resample(x, y, t, samples):
    """Scatter the (x, y, t) wavefront samples onto a square grid
    spanning the pupil footprint (linear interpolation, NaN outside
    the convex hull).  t may be (N,) or (N, m) (one shared
    triangulation, vector-valued interpolation)."""
    from scipy.interpolate import griddata
    t = np.asarray(t)
    tfin = (np.isfinite(t) if t.ndim == 1
            else np.isfinite(t).all(axis=1))
    finite = np.isfinite(x) & np.isfinite(y) & tfin
    if not finite.any():
        raise ValueError("no rays made it through")
    x, y, t = x[finite], y[finite], t[finite]
    half = max(np.abs(x).max(), np.abs(y).max())
    axis = np.linspace(-half, half, samples)
    gx, gy = np.meshgrid(axis, axis, indexing="ij")
    gt = griddata((x, y), t, (gx, gy), method="linear",
                  fill_value=np.nan)
    return gx, gy, gt


def _fraunhofer_psf(grids, step, wavelength, scale, radius, pad):
    """Shared Fraunhofer tail: normalize the pupil grid(s) by the lit
    sample count, zero-pad, FFT, and sum intensities incoherently
    across grids.  Returns (p, q, psf) on the angular-frequency
    conventions of GeometricTrace.psf."""
    lit = np.zeros(grids[0].shape, bool)
    for g in grids:
        lit |= g != 0
    norm = np.sqrt(np.count_nonzero(lit))
    padded = tuple(pad*s for s in grids[0].shape)
    psf = 0.
    for g in grids:
        field = np.fft.fft2(g/norm, padded)
        psf = psf + np.abs(field)**2/field.size
    cycles = scale/wavelength  # waves per unit length
    freq = np.fft.fftfreq(padded[0], step*cycles/radius)
    p, q = np.broadcast_arrays(freq[:, None], freq)
    return p, q, psf


class GeometricTrace(Trace):
    """Result holder for the batched real-ray trace (see module doc)."""

    def allocate(self, nrays):
        super().allocate()
        self.nrays = nrays
        block = (self.length, nrays, 3)
        for name in ("y", "u", "i"):
            setattr(self, name, np.empty(block))
        self.t = np.empty(block[:2])
        self.n = np.empty(self.length)
        self.w = None
        self.ref = None
        self.l = 1.

    # -- seeding and propagation -----------------------------------------

    def rays_given(self, y, u, l=None, w=None, ref=0):
        """Load a seed bundle into row 0 (reference
        geometric_trace.py:49)."""
        pos, aim = _complete_bundle(y, u)
        count = len(pos)
        if getattr(self, "y", None) is None or self.nrays != count:
            self.allocate(count)
        self.l = l if l is not None else self.system.wavelengths[0]
        self.w = w if w is not None else np.full(count, 1. / count)
        self.ref = ref
        self.y[0], self.u[0], self.i[0] = pos, aim, aim
        self.n[0] = self.system.refractive_index(self.l, 0)
        self.t[0] = 0.

    def propagate(self, start=1, stop=None, clip=False):
        super().propagate()
        seed = start - 1
        # host-side by design: the trace fills numpy arrays
        table = self.system.table(self.l, device="cpu")
        traced = self.system.trace_table(
            self.y[seed], self.u[seed], self.l, start, stop, clip,
            table=table)
        rows = slice(start, seed + traced[0].shape[0])
        for dst, src in zip((self.y, self.u, self.i, self.t), traced):
            dst[rows] = src[1:]
        self.n[rows] = table.n_after.cpu().numpy()[rows]

    # -- analysis primitives ----------------------------------------------

    def _weights(self, mask=None):
        w = self.w if self.w is not None else \
            np.full(self.nrays, 1. / self.nrays)
        return w if mask is None else w[mask]

    def refocus(self, at=-1):
        """Move the image by the weighted least-squares focus shift:
        minimize sum w |dy + dz*du|^2 over dz (reference
        geometric_trace.py:82)."""
        xy = self.y[at, :, :2]
        slope = tanarcsin(self.i[at])
        keep = np.isfinite(slope).all(axis=1)
        xy, slope = xy[keep] - xy[keep].mean(0), slope[keep]
        slope = slope - slope.mean(0)
        w = self._weights(keep)[:, None]
        shift = -(w * xy * slope).sum() / (w * slope * slope).sum()
        self.system[at].distance += shift
        self.propagate()

    def _sphere_radius(self, after, image):
        """Exit-pupil reference-sphere radius: image-to-pupil distance,
        or the axial gap for telecentric image space."""
        if self.system.image.pupil.telecentric:
            return self.track[image] - self.track[after]
        return -self.system.image.pupil.distance

    def opd(self, radius=None, after=-2, image=-1, resample=4):
        """Optical path difference on the exit-pupil reference sphere,
        in waves (reference geometric_trace.py:101).  With resample > 0
        the samples are gridded for contouring."""
        from ..elements import Spheroid
        ref = self.ref
        # accumulated optical path to the exit surface, relative to the
        # reference ray
        path = (self.t[:after + 1] - self.t[:after + 1, (ref,)]).sum(0)
        if not self.system.object.finite:
            # start from the wavefront plane through the chief ray
            # instead of the (meaningless) infinite object
            offset = (self.y[0] - self.y[0, ref]) @ self.u[0, ref]
            path += offset * self.n[0]
        if radius is None:
            radius = self._sphere_radius(after, image)
        # rays at `after`, re-expressed in the image frame and centered
        # on the reference sphere (which touches the reference image)
        ea, ei = self.system[after], self.system[image]
        shift = self.origins[after] - self.origins[image]
        pos = ei.to_normal(ea.from_normal(self.y[after]) + shift)
        pos -= self.y[image, ref]
        aim = ei.to_normal(ea.from_normal(self.u[after]))
        pos[:, 2] += radius
        extra = Spheroid(curvature=1. / radius).intercept(pos, aim)
        path += (extra - extra[ref]) * self.n[after]
        waves = -path / (self.l / self.system.scale)
        landing = pos + extra[:, None] * aim
        landing[:, 2] -= radius
        landing -= landing[ref]
        if not resample:
            return landing[:, 0], landing[:, 1], waves
        return _grid_resample(landing[:, 0], landing[:, 1], waves,
                              int(resample * np.sqrt(self.nrays)))

    def psf(self, pad=4, resample=4, **kwargs):
        """Point spread function: |FFT of the pupil function
        exp(-2 pi i OPD)|^2 (reference geometric_trace.py:146)."""
        if not resample:
            raise NotImplementedError("psf requires a resampled opd")
        radius = self.system[-1].distance
        x, _, o = self.opd(resample=resample, radius=radius, **kwargs)
        lit = np.isfinite(o)
        pupil = np.where(lit, np.exp(-2j * np.pi * o), 0.)
        return _fraunhofer_psf([pupil], x[1, 0] - x[0, 0], self.l,
                               self.system.scale, radius, pad)

    def zernike(self, nterms=15, **kwargs):
        """Noll-Zernike decomposition of the exit-pupil wavefront (in
        waves): returns (coefficients, residual RMS)."""
        from ..utils.zernike import fit_zernike
        x, y, o = self.opd(resample=0, **kwargs)
        h = np.nanmax(np.hypot(x, y))
        return fit_zernike(x/h, y/h, o, nterms=nterms, w=self.w)

    def rms(self, i=-1, ref=None):
        """Weighted transverse spot RMS about the centroid (or a
        reference ray) (reference geometric_trace.py:171)."""
        pts = self.y[i, :, :2]
        center = pts.mean(0) if ref is None else pts[ref]
        r2 = np.einsum("ij,ij->i", pts - center, pts - center)
        return np.sqrt(r2 @ self._weights())

    def angular_rms(self, i=-1, ref=None):
        """Weighted RMS angular spread (tan space, radians for small
        angles) of the exit directions about the weighted centroid
        direction (or a reference ray): the afocal-output analog of
        the spot RMS (reference TODO.rst afocal conjugates -- absent
        upstream).  Vignetted (NaN) rays drop out of both the moments
        and the weight normalization."""
        slopes = tanarcsin(self.u[i])
        w = self._weights()
        good = np.isfinite(slopes).all(axis=1)
        wg = np.where(good, w, 0.)
        wsum = wg.sum()
        pts = np.where(good[:, None], slopes, 0.)
        center = ((wg[:, None]*pts).sum(0)/wsum if ref is None
                  else slopes[ref])
        r2 = np.einsum("ij,ij->i", pts - center, pts - center)
        return np.sqrt((wg*r2).sum()/wsum)

    # -- bundle factories ---------------------------------------------

    def rays_paraxial(self, paraxial=None):
        """Seed from the paraxial marginal/chief pair (reference
        geometric_trace.py:185)."""
        if paraxial is None:
            paraxial = self.system.paraxial
        other = 1 - paraxial.axis
        heights = np.stack([paraxial.y[0] * 0, paraxial.y[0]], 1)
        slopes = np.stack([paraxial.u[0] * 0, sinarctan(paraxial.u[0])], 1)
        if other:
            heights, slopes = heights[:, ::-1], slopes[:, ::-1]
        self.rays_given(heights, slopes)
        self.propagate()

    def _seed_aimed(self, yo, yp, wavelength, stop, filter,
                    weight=None, ref=0, clip=False):
        """Aim a pupil-coordinate bundle through the stop and load it.

        With filtering on, the pupil map drops rays outside the
        elliptical aperture box; the per-ray weights and the reference
        index are filtered alongside (the reference left them
        misaligned, reference geometric_trace.py:195-209)."""
        z, p = self.system.pupil(yo, l=wavelength, stop=stop)
        if filter and yp is not None:
            # same box the aim mapping filters against (angular for
            # finite conjugates, conjugates._map_pupil)
            box = np.arctan2(p, z) if self.system.object.finite else p
            keep = self.system.object.pupil.inside(yp, box)
            if not keep.all():
                if weight is not None:
                    weight = np.asarray(weight)[keep]
                    weight = weight/weight.sum()
                ref = int(keep[:ref].sum()) if keep[ref] else 0
        seed = self.system.aim(yo, yp, z, p, filter=filter)
        self.rays_given(*seed, l=wavelength, w=weight, ref=ref)
        self.propagate(clip=clip)
        return p

    def rays(self, yo, yp, wavelength, stop=None, filter=None,
             clip=False, weight=None, ref=0):
        self._seed_aimed(yo, yp, wavelength, stop,
                         not clip if filter is None else filter,
                         weight, ref, clip)

    def rays_point(self, yo, wavelength=None, nrays=11,
                   distribution="meridional", filter=None, stop=None,
                   clip=False):
        ref, yp, weight = pupil_distribution(distribution, nrays)
        self._seed_aimed(yo, yp, wavelength, stop,
                         not clip if filter is None else filter,
                         weight, ref, clip)

    def rays_clipping(self, yo, wavelength=None, axis=1):
        """Chief plus the two rim rays found by the vignetting solve
        (reference geometric_trace.py:211)."""
        z, p = self.system.pupil(yo, l=wavelength, stop=-1)
        yp = np.zeros((3, 2))
        yp[1:, axis] = p[:, axis] / np.abs(p).max()
        self._seed_aimed(yo, yp, wavelength, -1, False)

    # -- edits / output -------------------------------------------------

    def resize(self, fn=lambda a, b: a):
        """Set element radii from traced ray heights
        (reference geometric_trace.py:231)."""
        heights = np.nanmax(np.hypot(self.y[..., 0], self.y[..., 1]), 1)
        for k in range(1, self.length):
            el = self.system[k]
            el.radius = fn(heights[k], el.radius)

    def plot(self, ax, axis=1, **kwargs):
        kwargs.setdefault("color", "green")
        pts = np.stack([self.origins[k]
                        + self.system[k].from_normal(self.y[k])
                        for k in range(self.length)])
        ax.plot(pts[..., 2], pts[..., axis], **kwargs)

    def print_trace(self):
        rel = np.cumsum(self.t, axis=0) - self.path[:, None]
        labels = ("n/track z/rel path/height x/height y/height z/"
                  "angle x/angle y/angle z").split("/")
        for i in range(self.nrays):
            yield "ray %i" % i
            cols = np.column_stack((
                self.n, self.path, rel[:, i], self.y[:, i], self.u[:, i]))
            yield from self.print_coeffs(cols, labels, sum=False)
            yield ""

    def text(self):
        return itertools.chain(self.print_trace())

    def __str__(self):
        return "\n".join(self.text())


class FullTrace(GeometricTrace):
    pass
