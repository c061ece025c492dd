"""System: ordered elements + conjugates + stop + wavelengths.

API parity with reference system.py:35-593 (update/pickup/solve/
validate, reverse/rescale, text tables, edge thickness, outlines, ABCD
products, pupil aiming).  `System.table` lowers the element list to
the struct-of-arrays SurfaceTable of tensors, and the real-ray trace
(reference system.py:444-464) runs through ops.geometric.trace_rays
on the whole bundle at once; the `propagate*` generators wrap it for
API compatibility.  `System.tables` and `System.config_tables` stack
one table per wavelength or per configuration (a leading axis on every
field) for the polychromatic engines.  Tables land on the package's
default device unless a `device` is given; the host-side traces
(`trace_table`, `propagate`, the per-field aiming solvers) ask for the
CPU, and the batched `pupils` solves on the table's device.

Not ported yet: the polynomial trace.
"""

import itertools

import numpy as np
import torch
from scipy.optimize import newton

from .aiming import AimingMixin
from .elements import Element
from .conjugates import Conjugate, FiniteConjugate, InfiniteConjugate
from .materials import fraunhofer
from .pupils import RadiusPupil
from .ops.tables import is_anamorphic, make_table, stack_tables
from .ops.geometric import trace_rays
from .trace.paraxial import ParaxialTrace


def _auto_pupil():
    return RadiusPupil(radius=1., update_distance=True,
                       update_radius=True)


def _default_object():
    return InfiniteConjugate(angle=0., pupil=_auto_pupil())


def _default_image():
    return FiniteConjugate(radius=0., update_radius=True,
                           pupil=_auto_pupil())


_DCF = "dCF"


class System(AimingMixin, list):
    def __init__(self, elements=None, description="", scale=1e-3,
                 wavelengths=None, stop=1, fields=None,
                 object=None, image=None,
                 pickups=None, validators=None, solves=None,
                 configurations=None):
        super().__init__(Element.make(e) for e in elements or [])
        vars(self).update(
            description=description, scale=scale, stop=stop,
            wavelengths=(wavelengths
                         or [fraunhofer[i] for i in _DCF]),
            object=(Conjugate.make(object) if object
                    else _default_object()),
            image=Conjugate.make(image) if image else _default_image(),
            pickups=pickups or [], validators=validators or [],
            solves=solves or [], configurations=configurations or [],
            _pupil_cache={})
        if fields is None:
            fields = [0.] if self.object.point else [0., .7, 1.]
        self.fields = fields
        self.paraxial = ParaxialTrace(self, update=False)

    def dict(self):
        out = dict(description=self.description, stop=self.stop,
                   scale=float(self.scale))
        out["wavelengths"] = [float(w) for w in self.wavelengths]
        out["object"] = self.object.dict()
        out["image"] = self.image.dict()
        for key in ("pickups", "validators", "solves"):
            out[key] = [dict(spec) for spec in getattr(self, key)]
        if self.configurations:
            out["configurations"] = [[dict(spec) for spec in cfg]
                                     for cfg in self.configurations]
        out["elements"] = [e.dict() for e in self]
        return out

    # -- multi-configuration (zoom) systems (beyond reference) --------
    #
    # A configuration is a list of write specs in the pickup/solve
    # accessor vocabulary, each carrying its `value` (e.g.
    # {"set": [3, "distance"], "value": 4.}): the zoom positions of a
    # variator group.  Solves act as the compensator -- a back-focus
    # solve re-focuses every configuration automatically on update().

    @property
    def n_configurations(self):
        return max(1, len(self.configurations))

    def apply_configuration(self, index, update=True):
        """Write configuration `index`'s overrides in place, then
        update().  Returns self.  Index 0 is always valid (a system
        without configurations has exactly one, its current state)."""
        if not 0 <= index < self.n_configurations:
            raise IndexError(
                "configuration %d out of range (system has %d)"
                % (index, self.n_configurations))
        if self.configurations:
            for spec in self.configurations[index]:
                if "set" in spec and "value" not in spec:
                    raise KeyError(
                        "configuration spec %r has no 'value'" % spec)
                self._write(spec, spec.get("value"))
        if update:
            self.update()
        return self

    def at_configuration(self, index, update=True):
        """A deep copy of the system with configuration `index`
        applied (the original is untouched)."""
        import copy
        dup = copy.deepcopy(self)
        dup._pupil_cache = {}
        return dup.apply_configuration(index, update)

    def config_tables(self, wavelength=None, dtype=torch.float64,
                      device=None):
        """Stacked SurfaceTable over all configurations (leading
        config axis) -- the batched input of
        ops.geometric.trace_rays_final_multi and vmapped merits."""
        return stack_tables([
            self.at_configuration(i).table(wavelength, dtype, device)
            for i in range(self.n_configurations)])

    # -- structure ---------------------------------------------------

    @property
    def aperture(self):
        return self[self.stop]

    @aperture.setter
    def aperture(self, a):
        self.stop = self.index(a)

    def groups(self):
        """Yield index lists forming lens groups (reference
        system.py:92): solids accumulate; a closing non-solid (or a
        lone mirror) finishes the group; bare elements extend an open
        group."""
        members = []
        for idx, el in enumerate(self):
            if not hasattr(el, "material"):
                if members:
                    members.append(idx)
                continue
            mat = el.material
            if getattr(mat, "solid", False):
                members.append(idx)
            elif members or getattr(mat, "mirror", False):
                members.append(idx)
                yield members
                members = []
        if members:
            yield members

    def _walk(self, path):
        node = self
        for step in path:
            node = (getattr(node, step) if isinstance(step, str)
                    else node[step])
        return node

    def get_path(self, path):
        return self._walk(path)

    def set_path(self, path, value):
        node = self._walk(path[:-1])
        leaf = path[-1]
        if isinstance(leaf, str):
            setattr(node, leaf, value)
        else:
            node[leaf] = value

    # -- parametric constraints (reference system.py:134-191) ---------
    # The declarative pickup/solve/validator dicts share one accessor
    # vocabulary: get / get_eval / get_func read a value, set /
    # set_exec / set_func write one.

    def _read(self, spec, extra=None):
        value = None
        if "get" in spec:
            value = self.get_path(spec["get"])
        if "get_eval" in spec:
            scope = dict(self=self)
            if extra:
                scope.update(extra)
            value = eval(spec["get_eval"], scope, globals())
        if "get_func" in spec:
            fn = spec["get_func"]
            if isinstance(fn, str):
                fn = eval(fn)
            value = fn(self, spec, value) if extra is None else fn(
                self, spec)
        return value

    def _write(self, spec, value):
        if "set" in spec:
            self.set_path(spec["set"], value)
        if "set_exec" in spec:
            exec(spec["set_exec"], globals(),
                 dict(value=value, self=self, solve=spec))
        if "set_func" in spec:
            spec["set_func"](self, spec, value)

    def pickup(self):
        for spec in self.pickups:
            value = self._read(spec)
            if "factor" in spec:
                value = value*spec["factor"]
            if "offset" in spec:
                value = value + spec["offset"]
            self._write(spec, value)

    def solve(self):
        for spec in self.solves:
            target = spec.get("target", 0.)
            if "init" in spec:
                start = spec["init"]
            elif "set" in spec:
                start = self.get_path(spec["set"])
            else:
                start = 0.

            def residual(x, spec=spec):
                self._write(spec, x)
                self.pickup()
                return self._read(spec, extra={"solve": spec}) - target

            root = newton(residual, start, tol=spec.get("tol", 1e-8),
                          maxiter=spec.get("maxiter", 20))
            residual(root)
            if "init_current" in spec:
                spec["init"] = float(root)

    _CHECKS = {
        "minimum": (lambda v, lim: v >= lim, "<"),
        "maximum": (lambda v, lim: v <= lim, ">"),
        "equality": (None, "!="),  # tolerance-aware: _almost_equal
    }
    _EQ_RTOL = 1e-9
    _EQ_ATOL = 1e-12

    @classmethod
    def _almost_equal(cls, value, lim, tol=None):
        """Equality within tolerance: solves converge to a root
        tolerance, not exactly, so the reference's float `==`
        (reference system.py:213-247) misfires on any solved system.
        A spec may carry its own absolute `tolerance`; non-numeric
        values fall back to exact comparison."""
        try:
            if tol is not None:
                return abs(value - lim) <= tol
            return abs(value - lim) <= (cls._EQ_ATOL
                                        + cls._EQ_RTOL*abs(lim))
        except TypeError:
            return value == lim

    def validate(self, fix=False):
        for spec in self.validators:
            value = self._read(spec)
            if "exec" in spec:
                exec(spec["exec"], globals(),
                     dict(self=self, value=value))
            for key, (ok, sym) in self._CHECKS.items():
                if key not in spec:
                    continue
                lim = spec[key]
                if key == "equality":
                    if self._almost_equal(value, lim,
                                          spec.get("tolerance")):
                        continue
                elif ok(value, lim):
                    continue
                if fix and "get" in spec:
                    self.set_path(spec["get"], lim)
                else:
                    raise ValueError(
                        f"{value} {sym} {lim} ({spec})")

    # -- refresh pipeline (reference system.py:201) --------------------

    def refractive_index(self, wavelength, index):
        for element in self[index::-1]:
            try:
                return element.refractive_index(wavelength)
            except AttributeError:
                pass
        return 1.

    def update(self):
        self._pupil_cache.clear()
        self.pickup()
        self.solve()
        self.object.pupil.refractive_index = \
            self.refractive_index(self.wavelengths[0], 0)
        self.image.pupil.refractive_index = \
            self.refractive_index(self.wavelengths[0], -1)
        for e in self:
            if hasattr(e, "phase_coefficients"):
                # the diffractive paraxial power needs the wavelength in
                # system units; the element alone cannot know the scale
                e._scale = self.scale
        self.paraxial.update_conjugates()
        self.paraxial.update()
        self.validate()

    # -- global edits ---------------------------------------------------

    def reverse(self):
        """Flip the system end for end: each element inverts, takes the
        following element's spacing and the preceding one's medium."""
        next_dist = [e.distance for e in self[1:]] + [0.]
        prev_mat = [None] + [getattr(e, "material", None)
                             for e in self[:-1]]
        for el, dist, mat in zip(self, next_dist, prev_mat):
            el.reverse()
            el.distance = dist
            el.material = mat
        self[:] = self[::-1]
        self.object, self.image = self.image, self.object

    def rescale(self, scale=None):
        scale = self.scale/1e-3 if scale is None else scale
        self.scale /= scale
        for part in itertools.chain(self, (self.object, self.image)):
            part.rescale(scale)

    # -- text ----------------------------------------------------------

    def __str__(self):
        return "\n".join(self.text())

    def text(self):
        yield from self.base_text()
        yield ""

    def _element_row(self, i, e):
        curv = getattr(e, "curvature", 0)
        mat = getattr(e, "material", None)
        if mat is not None:
            tail = "%17s %7.3f %7.3f %7.2f" % (
                mat, self.refractive_index(self.wavelengths[0], i),
                getattr(mat, "nd", np.nan), getattr(mat, "vd", np.nan))
        else:
            # the image (or a dummy) surface carries no medium of its
            # own -- print a clean placeholder, not None/nan columns
            tail = "%17s %7s %7s %7s" % ("-", "", "", "")
        return "%2i %1s %10.5g %10.4g %10.5g %s" % (
            i, e.typeletter, e.distance,
            np.inf if curv == 0 else 1./curv, e.radius*2, tail)

    _COLUMNS = ("{:>2} {:>1} {:>10} {:>10} {:>10} {:>17} "
                "{:>7} {:>7} {:>7}")

    def base_text(self):
        nm = ", ".join("%.0f" % (w/1e-9) for w in self.wavelengths)
        fs = ", ".join("%g" % f for f in self.fields)
        yield "System: %s" % self.description
        yield "Scale: %s mm" % (self.scale/1e-3)
        yield "Wavelengths: %s nm" % nm
        yield "Fields: %s" % fs
        for name in ("object", "image"):
            yield name.capitalize() + ":"
            yield from (" " + line
                        for line in getattr(self, name).text())
        yield "Stop: %i" % self.stop
        yield "Elements:"
        yield self._COLUMNS.format("#", "T", "Distance", "Rad Curv",
                                   "Diameter", "Material", "n", "nd",
                                   "Vd")
        yield from itertools.starmap(self._element_row,
                                     enumerate(self))

    # -- geometry ------------------------------------------------------

    def edge_thickness(self, axis=1):
        """Axial gap at the aperture edge: vertex spacing corrected by
        the sag difference of the two bounding surfaces."""
        sags = []
        for el in self:
            try:
                sags.append(el.edge_sag(axis))
            except AttributeError:
                sags.append(0.)
        sags = np.asarray(sags)
        spacing = np.array([el.distance for el in self])
        return spacing - sags + np.concatenate([[0.], sags[:-1]])

    edge_y = property(lambda self: self.edge_thickness(axis=1))
    edge_x = property(lambda self: self.edge_thickness(axis=0))

    def resize_convex(self):
        """Enlarge convex surfaces to at least their closing surface
        (reference system.py:333): consecutive glass-entering faces
        pair up; the larger radius wins on the convex side."""
        faces = [el for el in self[1:-1] if hasattr(el, "material")]

        def enters_glass(el):
            return not el.material or el.material.solid

        for front, back in zip(faces, faces[1:]):
            if not enters_glass(front):
                continue
            grown = max(front.radius, back.radius)
            if getattr(back, "curvature", 0) <= 0:
                back.radius = grown
            if getattr(front, "curvature", 0) > 0:
                front.radius = grown

    @staticmethod
    def _close_solid(front, back):
        """Join two surface outlines into a closed lens cross-section
        (front drawn forward, back reversed, edges bridged)."""
        (fx, fz), (bx, bz) = front, back
        lower = (bx[0], fz[0]) if bx[0] < fx[0] else (fx[0], bz[0])
        upper = (bx[-1], fz[-1]) if bx[-1] > fx[-1] else (fx[-1], bz[-1])
        return np.c_[(fx, fz), upper, (bx[::-1], bz[::-1]), lower,
                     (fx[0], fz[0])]

    def surfaces_cut(self, axis=1, points=31):
        """Yield 2-D cut outlines; solids are closed
        (reference system.py:354)."""
        pos = np.zeros(3)
        open_solid = None
        for e in self:
            pos = pos + e.offset
            xyz = pos + e.from_normal(e.surface_cut(axis, points))
            cut = xyz[:, axis], xyz[:, 2]
            mat = getattr(e, "material", None)
            if mat is None:
                yield cut
                continue
            if open_solid:
                yield self._close_solid(open_solid, cut)
            elif not mat.solid or mat.mirror:
                yield cut
            if mat.solid or (open_solid and mat.mirror):
                open_solid = cut
            else:
                open_solid = None
        if open_solid:
            yield open_solid

    @staticmethod
    def _blank_axes(ax):
        ax.set_aspect("equal")
        for spine in ax.spines.values():
            spine.set_visible(False)
        ax.set_xticks(())
        ax.set_yticks(())

    def plot(self, ax, axis=1, npoints=31, adjust=True, **kwargs):
        style = dict(color="black")
        style.update(kwargs)
        if adjust:
            self._blank_axes(ax)
        for outline_x, outline_z in self.surfaces_cut(axis, npoints):
            ax.plot(outline_z, outline_x, **style)
        spine = self.origins
        ax.plot(spine[:, 2], spine[:, axis], ":", **style)

    def paraxial_matrices(self, l, start=1, stop=None):
        n = self.refractive_index(l, start - 1)
        for e in self[start:stop]:
            n, m = e.paraxial_matrix(n, l)
            yield n, m

    def paraxial_matrix(self, l, start=1, stop=None):
        n, m = 1., np.eye(4)
        for n, step in self.paraxial_matrices(l, start, stop):
            m = step @ m
        return n, m

    @property
    def origins(self):
        return np.cumsum([el.offset for el in self], axis=0)

    def close(self, index=-1):
        self[index].offset -= self.origins[-1]

    @property
    def path(self):
        return np.cumsum([el.distance for el in self])

    @property
    def track(self):
        return self.origins[:, 2]

    def align(self, n):
        """Re-aim every element's local frame at its successor's
        direction (scaled by the refraction ratio)."""
        pairs = zip(self[:-1], self[1:])
        for i, (el, succ) in enumerate(pairs):
            mu = (n[i - 1] if i else n[0])/n[i]
            el.align(succ.direction, mu)
        self[-1].angles = 0, 0, 0.

    @property
    def mirrored(self):
        signs = [-1. if getattr(getattr(el, "material", None),
                                "mirror", False) else 1.
                 for el in self]
        return np.cumprod(signs)

    # -- lowering to tensors ------------------------------------------

    def table(self, wavelength=None, dtype=torch.float64, device=None):
        """Lower to a SurfaceTable for one trace wavelength, on `device`
        (None: the package's default device)."""
        if wavelength is None:
            wavelength = self.wavelengths[0]
        s = len(self)
        kmax = max((len(getattr(e, "aspherics", None) or ())
                    for e in self), default=0)
        kmax_odd = max((len(getattr(e, "aspherics_odd", None) or ())
                        for e in self), default=0)
        curvature = np.zeros(s)
        conic = np.zeros(s)
        curvature_dx = np.zeros(s)
        conic_dx = np.zeros(s)
        toroidal = np.zeros(s)
        grating_dy = np.zeros(s)
        kd = max((len(getattr(e, "phase_coefficients", None) or ())
                  for e in self), default=0)
        doe = np.zeros((s, kd))
        # the freeform rows' denormalized monomials, every row padded to
        # the widest triangle
        xy_rows = [np.asarray(getattr(e, "_xy_arr", np.zeros(0)))
                   for e in self]
        kxy = max((r.size for r in xy_rows), default=0)
        xy_poly = np.zeros((s, kxy))
        if kxy:
            from .ops.kernels import xy_degree
            xy_degree(kxy)
            for j, r in enumerate(xy_rows):
                xy_poly[j, :r.size] = r
        aspherics = np.zeros((s, kmax))
        aspherics_odd = np.zeros((s, kmax_odd))
        offset = np.zeros((s, 3))
        rot = np.tile(np.eye(3), (s, 1, 1))
        radius = np.full(s, np.inf)
        alternate = np.zeros(s)
        mu = np.ones(s)
        n_before = np.ones(s)
        n_after = np.ones(s)
        distance = np.zeros(s)
        n0 = self.refractive_index(wavelength, 0)
        for j, e in enumerate(self):
            curvature[j] = getattr(e, "curvature", 0.)
            conic[j] = getattr(e, "conic", 0.)
            # the anamorphic x figure rides as differences from the y
            # figure (a Toroid's conic_x is 0)
            cx = getattr(e, "curvature_x", None)
            if cx is not None:
                curvature_dx[j] = cx - curvature[j]
            kx = getattr(e, "conic_x", None)
            if kx is not None:
                conic_dx[j] = kx - conic[j]
            if hasattr(e, "curvature_rotation"):
                toroidal[j] = 1.
            asp = getattr(e, "aspherics", None) or ()
            aspherics[j, :len(asp)] = asp
            asp_odd = getattr(e, "aspherics_odd", None) or ()
            aspherics_odd[j, :len(asp_odd)] = asp_odd
            offset[j] = e.offset
            if e.rotated:
                rot[j] = e.rot_normal
            radius[j] = e.radius
            alternate[j] = 1. if getattr(e, "alternate_intersection",
                                         False) else 0.
            distance[j] = e.distance
            n_before[j] = n0
            if hasattr(e, "get_n_mu"):
                n0, mu[j] = e.get_n_mu(n0, wavelength)
            n_after[j] = n0
            if getattr(e, "grating_frequency", 0.):
                # the dimensionless linear-grating term m lambda G / n'
                grating_dy[j] = (e.grating_order*(wavelength/self.scale)
                                 * e.grating_frequency/abs(n0))
            pc = getattr(e, "phase_coefficients", None)
            if pc and getattr(e, "diffraction_order", 1):
                # the radial kick potential psi(r^2) = m lambda phi(r)/
                # (2 pi n'): doe[j, i] multiplies r**(2i+2), phi = sum
                # A_i (r/R)**(2i)
                fac = (e.diffraction_order*(wavelength/self.scale)
                       / (2*np.pi*abs(n0)))
                for i, a in enumerate(pc):
                    doe[j, i] = fac*a/e.norm_radius**(2*(i + 1))
        return make_table(
            curvature=curvature, conic=conic, aspherics=aspherics,
            aspherics_odd=aspherics_odd, offset=offset, rot=rot,
            radius=radius, alternate=alternate, mu=mu,
            n_before=n_before, n_after=n_after, distance=distance,
            curvature_dx=curvature_dx, conic_dx=conic_dx,
            toroidal=toroidal, grating_dy=grating_dy, doe=doe,
            xy_poly=xy_poly, dtype=dtype, device=device)

    def tables(self, wavelengths=None, dtype=torch.float64, device=None):
        """Stacked SurfaceTable with a leading wavelength axis, for
        the polychromatic engines (ops.geometric.trace_rays_final_multi,
        ops.cuda_trace.trace_multi, glass.polychromatic_spot_rms)."""
        if wavelengths is None:
            wavelengths = self.wavelengths
        return stack_tables([self.table(l, dtype, device)
                             for l in wavelengths])

    # -- propagation drivers (reference system.py:444-464) -------------

    def propagate_paraxial(self, yu, n, l, start=1, stop=None):
        state = yu, n
        for e in self[start:stop]:
            state = e.propagate_paraxial(*state, l)
            yield state

    def propagate_gaussian(self, q, n, l, start=1, stop=None):
        state = q, n
        for e in self[start:stop]:
            state = e.propagate_gaussian(*state, l)
            yield state

    def trace_table(self, y, u, l, start=1, stop=None, clip=False,
                    table=None, device="cpu"):
        """Batched real-ray trace (generic walk, float64) on `device`:
        returns NumPy (y, u, i, t) stacked over surfaces
        start-1..stop-1 (row 0 = the given seed)."""
        if table is None:
            # host-side by design: numpy in and out, on `device`
            table = self.table(l, device=device)
        sub = table.rows(start - 1, stop)
        y = torch.as_tensor(np.atleast_2d(np.asarray(y, dtype=float)),
                            device=device)
        u = torch.as_tensor(np.atleast_2d(np.asarray(u, dtype=float)),
                            device=device)
        # anamorphic rows take the generic walk's anamorphic step (the
        # reference's trace_table off the accelerator)
        return tuple(a.cpu().numpy()
                     for a in trace_rays(sub, y, u, clip=clip,
                                         biconic=is_anamorphic(sub)))

    def propagate(self, y, u, n, l, start=1, stop=None, clip=False):
        """Generator API over the jitted trace (reference
        system.py:459): yields (y, u, n, i, t) per surface."""
        # host-side by design: numpy in and out of trace_table's CPU walk
        table = self.table(l, device="cpu")
        ys, us, iis, ts = self.trace_table(y, u, l, start, stop,
                                           clip, table)
        n_after = table.n_after.cpu().numpy()
        for j in range(1, ys.shape[0]):
            yield (ys[j], us[j], n_after[start - 1 + j], iis[j], ts[j])

