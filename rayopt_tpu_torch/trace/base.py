"""Shared machinery for the trace-result holders.

Behavioral parity target: reference raytrace.py:25-65.  Every engine
(paraxial, geometric, gaussian, poly) subclasses :class:`Trace`, which
snapshots the system geometry at propagate time and offers two shared
services: lifting per-element axial samples into the lab frame
(`from_axis`) and the fixed-width coefficient-table text format
(`print_coeffs`).  Both are implemented as module functions here; the
class methods are thin bindings.
"""

import numpy as np

#: system attributes frozen onto the trace when it runs
GEOMETRY_ATTRS = ("path", "track", "origins", "mirrored")


def to_global(system, geometry, y, splits=None, ref=0):
    """Map axial-frame sample points to lab-frame coordinates.

    `y` holds (nz, nray, 3) points expressed in each element's local
    axial frame with z measured along the unfolded path; `splits` are
    the row indices where responsibility passes to the next element
    (derived from the path positions of the reference ray when omitted).
    Each chunk is shifted off its element's path coordinate, rotated by
    that element, and offset to the element origin.
    """
    path = geometry["path"]
    origins = geometry["origins"]
    y = np.atleast_3d(y)
    nz = y.shape[0]
    if splits is None:
        splits = np.searchsorted(y[:, ref, 2], path)
    edges = np.concatenate([[0], np.asarray(splits, dtype=int), [nz]])
    out = np.empty(y.shape, dtype=float)
    last = len(system) - 1
    for j in range(len(edges) - 1):
        lo, hi = edges[j], edges[j + 1]
        if lo >= hi:
            continue
        el = system[min(j, last)]
        z0 = path[min(j, last)]
        flat = y[lo:hi].reshape(-1, 3) - (0., 0., z0)
        out[lo:hi] = (origins[min(j, last)]
                      + el.from_axis(flat)).reshape(hi - lo, -1, 3)
    return out


def format_coeff_table(rows, labels, types, total=True):
    """Yield the fixed-width per-surface coefficient table.

    One line per surface: index, type letter, then one 10-wide %.4g
    cell per label; optionally a trailing column-sum line.  This is the
    common text format of every engine's print_* method.
    """
    head = "%2s %1s" + "% 10s" * len(labels)
    body = "%2s %1s" + "% 10.4g" * len(labels)
    yield head % (("#", "T") + tuple(labels))
    rows = np.atleast_2d(rows)
    for idx, (letter, row) in enumerate(zip(types, rows)):
        yield body % ((idx, letter) + tuple(row))
    if total:
        yield body % (("", "") + tuple(rows.sum(axis=0)))


class Trace:
    """Base trace-result holder: a system plus its frozen geometry."""

    def __init__(self, system):
        self.system = system

    def allocate(self):
        self.length = len(self.system)

    def propagate(self):
        for attr in GEOMETRY_ATTRS:
            setattr(self, attr, getattr(self.system, attr))

    @property
    def _geometry(self):
        return {attr: getattr(self, attr) for attr in GEOMETRY_ATTRS}

    def from_axis(self, y, i=None, ref=0):
        return to_global(self.system, self._geometry, y, i, ref)

    def print_coeffs(self, coeff, labels, sum=True):
        letters = [el.typeletter for el in self.system]
        return format_coeff_table(coeff, labels, letters, total=sum)

    def align(self):
        self.system.align(self.n)
        self.propagate()
