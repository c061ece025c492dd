"""Solver caches with interpolated initial guesses.

Used by System.pupil to reuse earlier pupil-aiming solutions as
starting points for nearby field coordinates (behavioral parity with
reference cachend.py:27-105).  One cache class, pluggable guess
strategies: "polar" (1-D radial linear interpolation — what pupil
aiming uses), "nearest", and "linear" (scipy N-D interpolators).
"""

import numpy as np


def _polar_strategy(points, values):
    radii = np.sqrt(np.square(points).sum(1))
    order = np.argsort(radii)
    radii = radii[order]
    values = values[order]

    def guess(*x):
        r = np.sqrt(np.square(np.asarray(x)).sum())
        if r <= radii[0]:
            return values[0]
        if r >= radii[-1]:
            return values[-1]
        i = np.searchsorted(radii, r)
        frac = (r - radii[i - 1])/(radii[i] - radii[i - 1])
        return values[i - 1] + frac*(values[i] - values[i - 1])

    return guess


def _nearest_strategy(points, values):
    from scipy.interpolate import NearestNDInterpolator
    return NearestNDInterpolator(points, values)


def _linear_strategy(points, values):
    if points.shape[0] < 4:
        return None
    from scipy.interpolate import LinearNDInterpolator
    try:
        return LinearNDInterpolator(points, values)
    except Exception:
        return None


_STRATEGIES = {
    "polar": _polar_strategy,
    "nearest": _nearest_strategy,
    "linear": _linear_strategy,
}


class CacheND:
    """Memoize solver(*args, guess=...) results and interpolate new
    starting guesses from the solutions seen so far."""

    strategy = None

    def __init__(self, solver, guess=None, **kwargs):
        self.solver = solver
        self.kwargs = kwargs
        self.interpolator = None
        self.cache = {}
        self.clear(guess)

    def clear(self, guess=None):
        self.cache.clear()
        self.guess = None

    def __call__(self, *args):
        if args in self.cache:
            return self.cache[args]
        guess = self.guess
        if self.interpolator is not None:
            guess = self.interpolator(*args)
            if np.any(np.isnan(guess)):
                guess = self.guess
        value = self.solver(*args, guess=guess, **self.kwargs)
        self.cache[args] = value
        self._refresh()
        return value

    def _refresh(self):
        if self.strategy is None:
            raise NotImplementedError
        points = np.array(list(self.cache.keys()))
        values = np.array(list(self.cache.values()))
        fit = _STRATEGIES[self.strategy](points, values)
        if fit is not None:
            self.interpolator = fit


class PolarCacheND(CacheND):
    strategy = "polar"


class NearestCacheND(CacheND):
    strategy = "nearest"


class LinearCacheND(CacheND):
    strategy = "linear"
