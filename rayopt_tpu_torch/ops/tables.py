"""SurfaceTable: the struct-of-arrays system description, as tensors.

Every per-surface quantity lives in one tensor with the surface index
as the leading axis, so a trace walks the rows and keeps the ray
bundle batched.  The field set and layout are those of the JAX
package's ``rayopt_tpu.ops.tables.SurfaceTable`` (see its docstring
for each field's meaning), so the two packages exchange tables field
by field (`table_from_numpy`).

A table is built per trace wavelength (refractive indices and the
refraction ratio mu are baked in).  Tables default to float64 on the
CPU; `SurfaceTable.to` moves one to another device or dtype.
"""

from typing import NamedTuple

import numpy as np
import torch


class SurfaceTable(NamedTuple):
    """Per-surface tensors; leading axis = surface index (0 = object).

    curvature (S,), conic (S,), aspherics (S, K), aspherics_odd
    (S, K2), offset (S, 3), rot (S, 3, 3), radius (S,), alternate
    (S,), mu (S,), n_before (S,), n_after (S,), distance (S,),
    curvature_dx (S,), conic_dx (S,), toroidal (S,), grating_dy (S,),
    doe (S, KD), xy_poly (S, KX), tilt (S, 3), decenter (S, 3)."""

    curvature: torch.Tensor
    conic: torch.Tensor
    aspherics: torch.Tensor
    aspherics_odd: torch.Tensor
    offset: torch.Tensor
    rot: torch.Tensor
    radius: torch.Tensor
    alternate: torch.Tensor
    mu: torch.Tensor
    n_before: torch.Tensor
    n_after: torch.Tensor
    distance: torch.Tensor
    curvature_dx: torch.Tensor = None
    conic_dx: torch.Tensor = None
    toroidal: torch.Tensor = None
    grating_dy: torch.Tensor = None
    doe: torch.Tensor = None
    xy_poly: torch.Tensor = None
    tilt: torch.Tensor = None
    decenter: torch.Tensor = None

    @property
    def nsurfaces(self):
        return self.curvature.shape[0]

    @property
    def dtype(self):
        return self.curvature.dtype

    @property
    def device(self):
        return self.curvature.device

    def to(self, device=None, dtype=None):
        """The same table on another device and/or floating dtype."""
        return SurfaceTable(*(None if f is None
                              else f.to(device=device, dtype=dtype)
                              for f in self))

    def rows(self, start=0, stop=None):
        """The sub-table of rows start..stop-1."""
        return SurfaceTable(*(None if f is None else f[start:stop]
                              for f in self))

    def row(self, j):
        """Row j: every field indexed at j (0-d / 1-d tensors)."""
        return SurfaceTable(*(None if f is None else f[j] for f in self))

    def replace(self, **kw):
        return self._replace(**kw)


def make_table(curvature, conic=None, aspherics=None, offset=None,
               rot=None, radius=None, alternate=None, mu=None,
               n_before=None, n_after=None, distance=None,
               aspherics_odd=None, curvature_dx=None, conic_dx=None,
               toroidal=None, grating_dy=None, doe=None,
               xy_poly=None, tilt=None, decenter=None,
               dtype=torch.float64, device="cpu"):
    """Assemble a SurfaceTable from array-likes, filling defaults
    exactly as the JAX package's make_table does."""
    curvature = np.asarray(curvature, dtype=np.float64)
    s = curvature.shape[0]

    def arr(x, default, shape):
        if x is None:
            out = np.broadcast_to(np.asarray(default, np.float64), shape)
        else:
            out = np.asarray(x, dtype=np.float64)
            if out.shape != shape:
                raise ValueError("table field has shape %s, expected %s"
                                 % (out.shape, shape))
        return out

    def block(x):
        if x is None:
            return np.zeros((s, 0))
        return np.asarray(x, dtype=np.float64).reshape(s, -1)

    if xy_poly is not None:
        from .kernels import xy_degree
        xy_degree(block(xy_poly).shape[1])  # validate triangular width
    if offset is None and distance is not None:
        offset = np.zeros((s, 3))
        offset[:, 2] = distance
    if distance is None and offset is not None:
        distance = np.linalg.norm(np.asarray(offset), axis=-1)
    fields = dict(
        curvature=curvature,
        conic=arr(conic, 0., (s,)),
        aspherics=block(aspherics),
        aspherics_odd=block(aspherics_odd),
        offset=arr(offset, 0., (s, 3)),
        rot=arr(rot, np.eye(3), (s, 3, 3)),
        radius=arr(radius, np.inf, (s,)),
        alternate=arr(alternate, 0., (s,)),
        mu=arr(mu, 1., (s,)),
        n_before=arr(n_before, 1., (s,)),
        n_after=arr(n_after, 1., (s,)),
        distance=arr(distance, 0., (s,)),
        curvature_dx=arr(curvature_dx, 0., (s,)),
        conic_dx=arr(conic_dx, 0., (s,)),
        toroidal=arr(toroidal, 0., (s,)),
        grating_dy=arr(grating_dy, 0., (s,)),
        doe=block(doe),
        xy_poly=block(xy_poly),
        tilt=arr(tilt, 0., (s, 3)),
        decenter=arr(decenter, 0., (s, 3)),
    )
    return SurfaceTable(**{
        k: torch.tensor(np.ascontiguousarray(v), dtype=dtype,
                        device=device)
        for k, v in fields.items()})


def table_from_numpy(tab, device="cpu", dtype=torch.float64):
    """A port SurfaceTable from any table-like with the same field
    names whose fields are array-likes (e.g. a JAX-package
    SurfaceTable after np.asarray of each field).  Absent (None)
    fields stay None."""
    return SurfaceTable(**{
        f: (None if getattr(tab, f, None) is None
            else torch.tensor(np.ascontiguousarray(
                np.asarray(getattr(tab, f), dtype=np.float64)),
                dtype=dtype, device=device))
        for f in SurfaceTable._fields})


def rodrigues(v):
    """Rotation matrices from rotation vectors: (..., 3) -> (..., 3,
    3), R = I + a [v]x + b [v]x^2 with a = sin(th)/th,
    b = (1-cos(th))/th^2, th = |v|.  Guarded branches plus a Taylor
    series keep it smooth (NaN-free gradients) through th = 0."""
    t = (v*v).sum(-1)
    small = t < 1e-12
    ts = torch.where(small, torch.ones_like(t), t)
    th = torch.sqrt(ts)
    a = torch.where(small, 1. - t/6. + t*t/120., torch.sin(th)/th)
    b = torch.where(small, .5 - t/24. + t*t/720.,
                    (1. - torch.cos(th))/ts)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    kx = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=kx.dtype, device=kx.device)
    return (eye + a[..., None, None]*kx
            + b[..., None, None]*(kx @ kx))


def lower_pose(table):
    """Fold the pose deltas (tilt, decenter) into the baked rot/offset:
    rot_eff = rodrigues(tilt) @ rot, offset_eff = offset + decenter.
    Returns a table with zero tilt/decenter (idempotent; a table with
    all-zero poses is returned as it is)."""
    tilt, dec = table.tilt, table.decenter
    kw = {}
    if tilt is not None and bool(torch.any(tilt != 0)):
        kw["rot"] = rodrigues(tilt) @ table.rot
        kw["tilt"] = torch.zeros_like(tilt)
    if dec is not None and bool(torch.any(dec != 0)):
        kw["offset"] = table.offset + dec
        kw["decenter"] = torch.zeros_like(dec)
    return table.replace(**kw) if kw else table


def is_anamorphic(table):
    """True when any row needs the extended surface vocabulary:
    anamorphic figure (biconic/cylinder/toroid), a diffraction
    grating, a diffractive phase or a freeform XY figure."""
    def any_nonzero(f):
        return f is not None and f.numel() and bool(torch.any(f != 0))
    return any(any_nonzero(getattr(table, f))
               for f in ("curvature_dx", "conic_dx", "toroidal",
                         "grating_dy", "doe", "xy_poly"))
