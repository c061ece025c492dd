"""Host-side pupil aiming: the scalar-solver front-end.

It provides the reference-parity entry points
(aim/aim_chief/aim_marginal/pupil; reference system.py:504-593) as a
mixin consumed by System.  Each scalar solve traces through
System.trace_table (the torch trace on the CPU); only the 1-D root
iteration itself is Python.  The batched device solver of the JAX
package (System.pupils) is not ported yet.
"""

import warnings

import numpy as np
from scipy.optimize import newton, brentq

from .utils.cachend import PolarCacheND


def _single_eval_cache(fn):
    """Memoize a scalar->scalar merit; the root solvers re-evaluate
    endpoints freely and every evaluation is a full device trace."""
    seen = {}

    def cached(x):
        if x not in seen:
            seen[x] = fn(x)
        return seen[x]

    return cached


def newton_nan_escape(merit, a=0., tol=1e-3, maxiter=30):
    """Newton root of `merit`, starting from the first finite point of
    a, a-1, a+1, a-2, a+2, ... (rays that miss every surface give NaN
    merits; widen the probe until one gets through)."""
    probes = (a + d*s for d in range(maxiter) for s in ((-1., 1.)
              if d else (1.,)))
    for start in probes:
        f = merit(start)
        if f == f:  # not NaN
            break
    else:
        raise ValueError("no starting ray found")
    if abs(f) <= tol:
        return start
    return newton(merit, start, tol=tol, maxiter=maxiter)


def bracketed_edge_solve(merit, a=0., b=1., tol=1e-3, maxiter=30):
    """Find the positive root of a monotone-ish edge-clearance merit.

    Grows b geometrically while merit(b) < 0, retreats from NaN
    territory (vignetted bundles), and finishes with brentq once a
    sign change is bracketed.  If the NaN ceiling pinches the bracket
    shut the bundle vignettes before filling the aperture; aim at that
    vignetting limit instead of failing (the reference's plain
    halving, reference system.py:489, can cycle forever there).
    """
    ceiling = np.inf
    fb = np.nan
    for _ in range(maxiter):
        fb = merit(b)
        if abs(fb) <= tol:
            return b
        if np.isnan(fb):
            ceiling = min(ceiling, b)
            b = (a + b)/2 if a else b/2
            continue
        if fb > 0:
            fa = merit(a)
            if abs(fa) <= tol:
                return a
            assert fa < 0
            return brentq(merit, a, b, rtol=tol, xtol=tol,
                          maxiter=maxiter)
        # still inside the aperture: push the upper end out
        a, b = b, b*(1 - fb)
        if b >= ceiling:
            b = (a + ceiling)/2
        if ceiling - a < tol*max(a, 1.):
            warnings.warn("aperture edge unreachable; aiming at the "
                          "vignetting limit")
            return a
    if a and np.isfinite(ceiling):
        warnings.warn("aperture edge unreachable; aiming at the "
                      "vignetting limit")
        return a
    raise ValueError("no viable interval found", a, b, fb)


class AimingMixin:
    """Pupil-aiming methods for System (reference system.py:504-593).

    Requires the host System API: object/image conjugates, stop,
    wavelengths, table(), trace_table(), aperture, _pupil_cache.
    """

    # reference-parity aliases used by older call sites/tests
    def solve_newton(self, merit, a=0., tol=1e-3, maxiter=30):
        return newton_nan_escape(merit, a, tol, maxiter)

    def solve_brentq(self, merit, a=0., b=1., tol=1e-3, maxiter=30):
        return bracketed_edge_solve(merit, a, b, tol, maxiter)

    def aim(self, *args, **kwargs):
        return self.object.aim(*args, surface=self[0], **kwargs)

    def aim_chief(self, yo, z, p, l=None, stop=None, **kwargs):
        """Chief-ray pupil distance: newton on the stop height of the
        ray aimed at z + a*p (reference system.py:507-526)."""
        assert p
        pupil = self.object.pupil
        if pupil.telecentric or not pupil.aim:
            return z
        if l is None:
            l = self.wavelengths[0]
        last = self.stop if stop in (-1, None) else stop
        rad = self.aperture.radius
        assert rad
        # host root iteration around few-ray CPU traces
        table = self.table(l, device="cpu")
        field = np.asarray(yo)

        @_single_eval_cache
        def height_at_stop(a):
            seed = self.aim(yo, None, z + a*p, filter=False)
            heights = self.trace_table(*seed, l, stop=last + 1,
                                       table=table)[0]
            return field @ heights[-1, 0, :2] / rad

        root = newton_nan_escape(height_at_stop, **kwargs)
        # residual certificate: scipy's newton step criterion can
        # accept a spurious stall (tiny step on a flat merit); check
        # the actual stop-height residual like the batched device
        # solvers do (ops/aiming.py)
        resid = height_at_stop(root)
        tol = kwargs.get("tol", 1e-3)
        if not abs(resid) <= 10*tol:
            warnings.warn(
                "chief-ray aim residual %.3g exceeds tolerance %.3g "
                "at field %s" % (resid, tol, yo))
        return z + p*root

    def aim_marginal(self, yo, yp, z, p, l=None, stop=None, **kwargs):
        """Marginal-ray scale: bracketed root of the edge clearance at
        the limiting aperture; stop=-1 selects rim (vignetting) mode
        over all surfaces (reference system.py:528-555)."""
        assert p
        rim = stop == -1
        if not self.object.pupil.aim and not rim:
            return p
        if l is None:
            l = self.wavelengths[0]
        if rim:
            stop = len(self) - 1
        elif stop is None:
            stop = self.stop + 1
        r2 = np.array([e.radius for e in self[1:stop]]) ** 2
        # host root iteration around few-ray CPU traces
        table = self.table(l, device="cpu")

        @_single_eval_cache
        def edge_clearance(a):
            seed = self.aim(yo, yp, z, a*p, filter=False)
            heights = self.trace_table(*seed, l, stop=stop,
                                       table=table)[0]
            hit2 = np.einsum("sc,sc->s", heights[1:, 0, :2],
                             heights[1:, 0, :2])
            excess = hit2/r2 - 1
            return excess.max() if rim else excess[-1]

        a = bracketed_edge_solve(edge_clearance, **kwargs)
        assert a
        return a*p

    def _aim_pupil(self, xo, yo, guess, **kwargs):
        field = np.array((xo, yo))
        if guess is not None:
            z = guess[0]
            half = guess[1:].reshape(2, 2).copy()
        else:
            z = self.object.pupil.distance
            half = np.full((2, 2), float(self.object.pupil.radius))
            if (not np.allclose(field, 0)
                    and not self.object.finite
                    and getattr(self.object, "wideangle", False)):
                # the wideangle branch the reference left dead
                # ("FIXME: wideangle!", reference system.py:559-562):
                # at steep field angles the paraxial pupil distance is
                # a poor chief seed and the real pupil walks toward
                # the front element.  Start from the (overridable)
                # entrance pupil distance and CONTINUE outward in
                # field -- each partial-field solve seeds the next, so
                # a cold full-field solve behaves like the warm
                # PolarCacheND path instead of probing blindly.
                ze = getattr(self.object, "entrance_distance", None)
                if ze is not None:
                    z = ze
                state = np.r_[z, half.flat]
                for frac in (1./3., 2./3.):
                    state = self._aim_pupil(frac*xo, frac*yo, state,
                                            **kwargs)
                z = state[0]
                half = state[1:].reshape(2, 2).copy()
        if not np.allclose(field, 0):
            z1 = self.aim_chief(field, z, np.abs(half).max(), **kwargs)
            if self.object.finite:
                half *= np.abs(z1/z)  # rescale the rim guess with z
            z = z1
        # rim solves: (row=sign, col=axis); meridional first, and
        # within each axis the upper rim first so it can seed the rest
        for ax in (1, 0):
            for sig in (1, 0):
                probe = [0., 0.]
                probe[ax] = 2.*sig - 1.
                half[sig, ax] = self.aim_marginal(
                    field, probe, z, half[sig, ax], **kwargs)
                if sig == 1:
                    half[0, ax] = -half[1, ax]
                    if ax == 1 and guess is None:
                        half[:, 0] = half[:, 1]
        return np.r_[z, half.flat]

    def pupil(self, yo, l=None, stop=None, **kwargs):
        key = (l, stop)
        solver = self._pupil_cache.get(key)
        if solver is None:
            solver = PolarCacheND(self._aim_pupil, l=l, stop=stop,
                                  **kwargs)
            self._pupil_cache[key] = solver
        state = solver(*yo)
        return state[0], state[1:].reshape(2, 2)

    def pupils(self, fields, l=None, stop=None, tol=1e-6,
               chief_only=False):
        """Batched pupil solve for many field points at once: not
        ported yet (solve each field with `pupil`)."""
        raise NotImplementedError(
            "System.pupils (the batched device aiming solver) is not "
            "ported to rayopt_tpu_torch yet; call System.pupil per field")
