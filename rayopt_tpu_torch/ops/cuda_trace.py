"""The fused trace kernels on CUDA, with their plain versions.

K1 `trace_final` traces six (N,) ray components through the whole
specialized surface chain in one pass and returns the final state in
the last surface's frame plus the summed optical path.  It replaces
the JAX package's Pallas kernel `pallas_trace._trace_kernel`.

K2 `trace_merit` runs the same trace with no per-ray writeback and
reduces it to the five spot moments (count, sum x, sum y, sum x^2,
sum y^2) over the rays whose x, y and uz are finite.  It replaces
`pallas_trace._merit_kernel` + `_moment_row`; forward only, one launch
a call with the grid-wide sum fused.  Like the JAX package's kernels,
K1 and K2 are compiled for each (dtype, spec tuple, clip) key
(csrc/grad_spec.cuh, built and cached by ops.cuda_spec: a new spec
tuple costs one nvcc run at its first call).  K1 and K2 trace flat,
spherical, conic and even/odd aspheric rows (an aspheric row by the
seeded Newton intercept, its key carrying the table's coefficient
widths, `figure_widths`) and the anamorphic rows: conic cylinders in
closed form, biconics and toroids, with or without an aspheric figure,
by the seeded Newton (their key's rows carry curvature_dx and conic_dx,
`carries_anamorphic`), and the phase rows: a linear grating or a radial
diffractive phase (DOE) on any of these substrates, by the generalized
Spencer & Murty solve (their key's rows carry grating_dy,
`carries_grating`, and n_after and the DOE coefficients, `doe_width`;
K1 adds the DOE's phase to the optical path), and the freeform XY rows:
a conic or aspheric base plus a triangular XY-monomial figure, by the
seeded Newton with the vertex-plane restart and the freeform normal
(their key's rows carry the table's xy_poly coefficients, `xy_width`).

K3 `trace_multi` is their polychromatic twin: a stacked table (a
leading wavelength axis, System.tables) and ONE bundle traced through
every wavelength's chain with no aperture clip; it returns each
wavelength's final state and path, or (merit=True) each wavelength's
five count moments.  It replaces `pallas_trace._multi_kernel`, and is
compiled per (dtype, spec tuple, wavelength count) key too: its merit
mode is K2's template at the stack's wavelengths, its trace K1's chain
once a wavelength.  A stack past one key's wavelengths (cuda_spec.
multi_most) runs in balanced runs, one launch each.  K3 traces the
aspheric, the anamorphic, the phase and the freeform rows as K1 does,
its key carrying the stack's coefficient widths, anamorphic words,
phase words and XY width (each table of the stack packs its own
grating_dy, n_after, DOE and XY coefficients: the phase words differ by
wavelength while the specs are shared).

The kernels are hand-written CUDA C++ (csrc/grad_spec.cuh), built with
nvcc for sm_90a at first use (ops.cuda_build, ops.cuda_spec) and
launched on PyTorch's current stream through ctypes.  A wrapper takes
the plain PyTorch version (`trace_final_reference`,
`trace_merit_reference`, `trace_multi_reference`, all built from
kernels.surface_step_spec) only for a bundle on the CPU; for a CUDA
bundle it launches its kernel or raises.  Each wrapper counts its launches in
`<wrapper>.launches`.

The static `specs` select each row's branch; pass the same specs to
every engine that is compared (derive them from the float64 table
even when tracing in float32: a float32 cast can move a row's flags).
"""

import functools

import torch

from . import kernels as K
from .geometric import trace_components_final
from .tables import lower_pose, table_at

# packed row layout and flag bits: keep in sync with csrc/trace_common.cuh;
# a figured table's rows carry its even, then its odd aspheric
# coefficients after the ROW base words (P_ASP on), then an anamorphic
# table's curvature_dx and conic_dx, then a grating key's grating_dy,
# then a DOE key's n_after and its nd coefficients, then a freeform key's
# nxy XY-monomial coefficients
P_C, P_K, P_OFF, P_ROT, P_RAD, P_MU, P_NB, ROW = 0, 1, 2, 5, 14, 15, 16, 17
P_ASP = ROW
F_FLAT, F_SPHERICAL, F_ROTATED, F_OFF_AXIS = 1, 2, 4, 8
F_ALTERNATE, F_FINITE, KIND_SHIFT = 16, 32, 6
F_ASPHERIC, F_ODD = 256, 512
# the anamorphic rows: a conic cylinder curved in y or in x, a biconic,
# a toroid (one of them a row)
F_CYL_Y, F_CYL_X, F_BICONIC, F_TOROID = 1024, 2048, 4096, 8192
#: an anamorphic key's words a row (and K5's slots): curvature_dx, conic_dx
ANAM = 2
# the phase rows: a linear grating, a radial diffractive phase (DOE)
F_GRATING, F_DOE = 16384, 32768
# the freeform XY rows: the Newton on the sag less the XY figure
F_FREEFORM = 65536

SMEM_LIMIT = 48*1024  # static shared memory, or dynamic without an opt-in
SMEM_OPTIN = 227*1024  # what a block may opt in to on Hopper (the adjoints)


def _moments(x, y, uz):
    good = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(uz)
    xg = torch.where(good, x, 0.)
    yg = torch.where(good, y, 0.)
    return (good.to(x.dtype).sum(), xg.sum(), yg.sum(), (xg*xg).sum(),
            (yg*yg).sum())


def trace_final_reference(table, specs, state, clip=False):
    """Plain PyTorch version of K1 on any device: ((x, y, z, ux, uy,
    uz), t) after the last surface, traced in the state's dtype."""
    return trace_components_final(table, state, clip=clip, specs=specs)


def trace_merit_reference(table, specs, state, clip=False):
    """Plain PyTorch version of K2: the five spot moments (0-d tensors
    in the state's dtype) of the K1 trace."""
    out, _ = trace_final_reference(table, specs, state, clip)
    return _moments(out[0], out[1], out[5])


def trace_multi_reference(tables, specs, state, merit=False):
    """Plain PyTorch version of K3: each wavelength's table of the
    stack traces the same state with no clip (trace_rays_final_multi
    of the bundle, component by component).  Returns one ((x, y, z,
    ux, uy, uz), t) a wavelength, or with merit one 5-tuple of count
    moments a wavelength."""
    specs = multi_specs(tables, specs)
    outs = []
    for li in range(tables.curvature.shape[0]):
        out, t = trace_final_reference(table_at(tables, li), specs, state)
        outs.append(_moments(out[0], out[1], out[5]) if merit
                    else (out, t))
    return tuple(outs)


def multi_specs(tables, specs):
    """The static specs a stacked table shares: given, or derived from
    its first table (pallas_trace.pallas_trace_multi; specialize reads
    the table in float64).  A row whose kind depends on the wavelength
    (mu == 1 at one and not at another) is specialized as the first
    wavelength has it."""
    if specs is None:
        specs = K.specialize(table_at(tables, 0))
    return tuple(specs)


def spot_rms_from_moments(count, sx, sy, sxx, syy):
    """Centroid-referenced spot RMS from the five moments."""
    cx, cy = sx/count, sy/count
    var = (sxx + syy)/count - (cx*cx + cy*cy)
    return torch.sqrt(torch.clamp(var, min=0.))


def _flags(spec):
    return ((F_FLAT if spec.flat else 0)
            | (F_SPHERICAL if spec.spherical else 0)
            | (F_ROTATED if spec.rotated else 0)
            | (F_OFF_AXIS if spec.off_axis else 0)
            | (F_ALTERNATE if spec.alternate else 0)
            | (F_FINITE if spec.finite_aperture else 0)
            | (int(spec.kind) << KIND_SHIFT)
            | (F_ASPHERIC if spec.aspheric else 0)
            | (F_ODD if spec.odd else 0)
            | _anamorphic_flag(spec)
            | (F_GRATING if spec.grating else 0)
            | (F_DOE if spec.doe else 0)
            | (F_FREEFORM if spec.freeform else 0))


def _anamorphic_flag(spec):
    """A row's anamorphic flag: the cylinder first (a cylinder's
    biconic or toroidal flag is set too), then the toroid.  A grating or
    DOE on a cylinder keeps its origin beside the cylinder's flag
    (F_BICONIC or F_TOROID): its intercept is the cylinder's closed form,
    its phase solve takes the normal of the biconic or toroid that made
    it, as the reference's surface_step_spec."""
    if spec.cyl_axis:
        cyl = F_CYL_Y if spec.cyl_axis == 1 else F_CYL_X
        if K.is_phase(spec):
            cyl |= F_TOROID if spec.toroidal else F_BICONIC
        return cyl
    if spec.toroidal:
        return F_TOROID
    return F_BICONIC if spec.biconic else 0


def carries_anamorphic(specs):
    """Whether a packed row carries the ANAM anamorphic words after its
    coefficients (curvature_dx and conic_dx; K5's slots too): some row
    of `specs` is anamorphic."""
    return any(K.is_anamorphic_spec(s) for s in specs[1:])


def figure_widths(table, specs):
    """(even, odd) aspheric coefficients a packed row carries: the
    table's widths when some row of `specs` reads them (an aspheric
    row, a biconic or a toroid: its Newton reads every coefficient,
    kernels.reads_figure), else (0, 0)."""
    if not any(K.reads_figure(s) for s in specs[1:]):
        return (0, 0)
    return (int(table.aspherics.shape[-1]),
            int(table.aspherics_odd.shape[-1]))


def carries_grating(specs):
    """Whether a packed row carries grating_dy (K5's slots too): some
    row of `specs` is a grating."""
    return any(s.grating for s in specs[1:])


def doe_width(table, specs):
    """The DOE coefficients a packed row carries (after n_after; K5's
    slots: the coefficients): the table's doe width when some row of
    `specs` is a DOE, else 0."""
    if not any(s.doe for s in specs[1:]):
        return 0
    return int(table.doe.shape[-1])


def xy_width(table, specs):
    """The XY-monomial coefficients a packed row carries (last; K5's
    slots: the last columns): the table's xy_poly width when some row of
    `specs` is freeform, else 0."""
    if not any(s.freeform for s in specs[1:]):
        return 0
    return int(table.xy_poly.shape[-1])


def pack_values(table, dtype, device, widths=(0, 0), anamorphic=False,
                grating=False, nd=0, nxy=0):
    """The lowered table's values as one contiguous (S, ROW + na + no
    [+ ANAM] [+ 1] [+ 1 + nd] [+ nxy]) tensor in `dtype` on `device` --
    (L, S, ...) for a stacked table -- with `widths` = (na, no)
    (figure_widths) the aspheric coefficients a row carries after its
    ROW base words, then with `anamorphic` (carries_anamorphic) its
    curvature_dx and conic_dx, with `grating` (carries_grating) its
    grating_dy, with nd (doe_width) its n_after and nd DOE coefficients,
    and with nxy (xy_width) its XY-monomial coefficients."""
    table = lower_pose(table)
    na, no = widths
    cols = [table.curvature[..., None], table.conic[..., None], table.offset,
            table.rot.flatten(-2), table.radius[..., None],
            table.mu[..., None], table.n_before[..., None]]
    if na:
        cols.append(table.aspherics)
    if no:
        cols.append(table.aspherics_odd)
    if anamorphic:
        cols += [table.curvature_dx[..., None], table.conic_dx[..., None]]
    if grating:
        cols.append(table.grating_dy[..., None])
    if nd:
        cols += [table.n_after[..., None], table.doe]
    if nxy:
        cols.append(table.xy_poly)
    # cast first (the kernel traces in `dtype`), then move
    return torch.cat(cols, dim=-1).to(dtype=dtype).to(
        device=device).contiguous()


def pack_table(table, specs, dtype, device):
    """The lowered table as one contiguous (S, ROW + na + no [+ ANAM]
    [+ 1] [+ 1 + nd] [+ nxy]) tensor in `dtype` on `device`
    (figure_widths, carries_anamorphic, carries_grating, doe_width,
    xy_width) -- (L, S, ...) for a stacked table, whose tables share the
    specs -- plus the (S,) int32 flags that encode each row's
    SurfaceSpec."""
    nsurf = table.curvature.shape[-1]
    if len(specs) != nsurf:
        raise ValueError("%d specs for a table of %d rows"
                         % (len(specs), nsurf))
    flags = torch.tensor([_flags(s) for s in specs], dtype=torch.int32,
                         device=device)
    return pack_values(table, dtype, device, figure_widths(table, specs),
                       carries_anamorphic(specs), carries_grating(specs),
                       doe_width(table, specs), xy_width(table, specs)), flags


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The streaming multiprocessors of a CUDA device (cached)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_state(state):
    if len(state) != 6:
        raise ValueError("state must hold 6 components, got %d"
                         % len(state))
    x = state[0]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError("rays must be float32 or float64, got %s"
                        % x.dtype)
    for c in state:
        if c.device != x.device or c.dtype != x.dtype:
            raise ValueError("all 6 components must share device and "
                             "dtype (%s %s vs %s %s)"
                             % (c.device, c.dtype, x.device, x.dtype))
        if c.dim() != 1 or c.shape != x.shape:
            raise ValueError("components must be (N,) of one length, "
                             "got %s and %s"
                             % (tuple(x.shape), tuple(c.shape)))
        if not c.is_contiguous():
            raise ValueError("components must be contiguous")


@functools.lru_cache(maxsize=None)
def _trace_kernel(specs, dtype, clip, widths, nd=0, nxy=0):
    from . import cuda_spec as CS     # cuda_spec imports this module
    return CS.load(CS.trace_key(specs, dtype, clip, widths=widths, nd=nd,
                                nxy=nxy))


def trace_final(table, specs, state, clip=False):
    """K1: ((x, y, z, ux, uy, uz), t) after the last surface, for six
    contiguous (N,) components in float32 or float64.  CUDA bundles
    launch the kernel compiled for (dtype, specs, clip) (ops.cuda_spec:
    one launch, none for no rays); CPU bundles take
    trace_final_reference."""
    _check_state(state)
    x = state[0]
    if x.device.type == "cpu":
        return trace_final_reference(table, specs, state, clip)
    from .cuda_spec import packed, spec_launch
    device, n, stream = spec_launch(state)
    specs = tuple(specs)
    kern = _trace_kernel(specs, x.dtype, bool(clip),
                         figure_widths(table, specs), doe_width(table, specs),
                         xy_width(table, specs))
    tab = packed(table, specs, x)
    outs = [torch.empty_like(x) for _ in range(7)]
    if n:
        kern.check(kern.fn(tab.data_ptr(), *(c.data_ptr() for c in state),
                           *(o.data_ptr() for o in outs), n,
                           kern.grid(n, device), stream))
        trace_final.launches += 1
    return tuple(outs[:6]), outs[6]


trace_final.launches = 0


@functools.lru_cache(maxsize=None)
def _merit_kernel(specs, dtype, clip, widths, nd=0, nxy=0):
    from . import cuda_spec as CS     # cuda_spec imports this module
    return CS.load(CS.merit_key(specs, dtype, clip, widths=widths, nd=nd,
                                nxy=nxy))


def trace_merit(table, specs, state, clip=False):
    """K2: the five spot moments (count, sum x, sum y, sum x^2,
    sum y^2) of the K1 trace as 0-d tensors in the rays' dtype; feed
    spot_rms_from_moments.  CUDA bundles launch the kernel compiled for
    (dtype, specs, clip) (ops.cuda_spec: one launch, the grid-wide sum
    fused); CPU bundles take trace_merit_reference."""
    _check_state(state)
    x = state[0]
    if x.device.type == "cpu":
        return trace_merit_reference(table, specs, state, clip)
    from .cuda_spec import launch_moments, spec_launch
    spec_launch(state)
    specs = tuple(specs)
    out = launch_moments(_merit_kernel(specs, x.dtype, bool(clip),
                                       figure_widths(table, specs),
                                       doe_width(table, specs),
                                       xy_width(table, specs)),
                         table, specs, state)
    if x.shape[0]:
        trace_merit.launches += 1
    return tuple(out[0].unbind())


trace_merit.launches = 0


@functools.lru_cache(maxsize=None)
def _multi_kernel(specs, dtype, nlam, merit, widths=(0, 0), nd=0, nxy=0):
    from . import cuda_spec as CS     # cuda_spec imports this module
    return CS.load(CS.trace_multi_key(specs, dtype, nlam, merit,
                                      widths=widths, nd=nd, nxy=nxy))


def _multi_runs(specs, dtype, nlam, merit, widths=(0, 0), nd=0, nxy=0):
    """K3's launches for a stack of nlam tables (`widths` the stack's,
    figure_widths; `nd` its doe_width, `nxy` its xy_width): (l0, l1,
    loaded key) of each balanced run
    (cuda_spec.runs: 12 -> 6 + 6, 13 -> 7 + 6) of at most
    cuda_spec.multi_most wavelengths, equal runs on one key.  Each merit
    run reads the rays again, the price of the split (the trace,
    wavelengths outermost, reads them once a wavelength anyway)."""
    from . import cuda_spec as CS
    kernel = "k3m" if merit else "k3"
    most = CS.multi_most(kernel, specs, dtype, widths=widths, nd=nd,
                         nxy=nxy)
    if most < 1:
        # raises, saying why
        CS.trace_multi_key(specs, dtype, 1, merit, widths=widths, nd=nd,
                           nxy=nxy)
    return [(l0, l1, _multi_kernel(specs, dtype, l1 - l0, merit, widths,
                                   nd, nxy))
            for l0, l1 in CS.runs(nlam, most)]


def trace_multi(tables, specs, state, merit=False):
    """K3: ONE bundle of six contiguous (N,) components (float32 or
    float64) through every table of a stack (leading wavelength axis),
    with no aperture clip and the specs of the first wavelength
    (`specs=None` derives them, multi_specs).  Returns one ((x, y, z,
    ux, uy, uz), t) a wavelength, or with merit=True one 5-tuple of
    count moments (count, sum x, sum y, sum x^2, sum y^2) a wavelength
    -- feed spot_rms_from_moments.  CUDA bundles launch the kernel
    compiled for (dtype, specs, wavelength count) (ops.cuda_spec: one
    launch, the merit's grid-wide sum fused), a stack past one key's
    wavelengths in balanced runs, one launch each, every run writing
    its wavelengths' slice (_multi_runs); CPU bundles take
    trace_multi_reference."""
    _check_state(state)
    x = state[0]
    if x.device.type == "cpu":
        return trace_multi_reference(tables, specs, state, merit)
    from .cuda_spec import launch_moments, packed, spec_launch
    device, n, stream = spec_launch(state)
    specs = multi_specs(tables, specs)
    nlam = tables.curvature.shape[0]
    runs = _multi_runs(specs, x.dtype, nlam, merit,
                       figure_widths(tables, specs), doe_width(tables, specs),
                       xy_width(tables, specs))
    if merit:
        out = torch.cat([launch_moments(kern, table_at(tables, slice(l0, l1)),
                                        specs, state)
                         for l0, l1, kern in runs])
    else:
        out = torch.empty((nlam, 7, n), dtype=x.dtype, device=device)
        for l0, l1, kern in runs:
            tab = packed(table_at(tables, slice(l0, l1)), specs, x)
            if n:
                kern.check(kern.fn(tab.data_ptr(),
                                   *(c.data_ptr() for c in state),
                                   out[l0].data_ptr(), n,
                                   kern.grid(n, device), stream))
    if n:
        trace_multi.launches += len(runs)
    if merit:
        return tuple(tuple(out[li].unbind()) for li in range(nlam))
    return tuple((tuple(out[li, c] for c in range(6)), out[li, 6])
                 for li in range(nlam))


trace_multi.launches = 0
