"""The fused trace kernels on CUDA, with their plain versions.

K1 `trace_final` traces six (N,) ray components through the whole
specialized surface chain in one pass and returns the final state in
the last surface's frame plus the summed optical path.  It replaces
the JAX package's Pallas kernel `pallas_trace._trace_kernel`.

K2 `trace_merit` runs the same trace with no per-ray writeback and
reduces it to the five spot moments (count, sum x, sum y, sum x^2,
sum y^2) over the rays whose x, y and uz are finite.  It replaces
`pallas_trace._merit_kernel` + `_moment_row`; forward only.

K3 `trace_multi` is their polychromatic twin: a stacked table (a
leading wavelength axis, System.tables) and ONE bundle, read once and
traced through every wavelength's chain with no aperture clip; it
returns each wavelength's final state and path, or (merit=True) each
wavelength's five count moments.  It replaces
`pallas_trace._multi_kernel`.

The kernels are hand-written CUDA C++ (csrc/trace.cu), built with
nvcc for sm_90a at first use (ops.cuda_build) and launched on
PyTorch's current stream through ctypes.  A wrapper takes the plain
PyTorch version (`trace_final_reference`, `trace_merit_reference`,
`trace_multi_reference`, all built from kernels.surface_step_spec)
only for a bundle on the CPU; for a CUDA bundle it launches its
kernel or raises.  Each wrapper counts its launches in
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

# packed row layout and flag bits: keep in sync with csrc/trace.cu
P_C, P_K, P_OFF, P_ROT, P_RAD, P_MU, P_NB, ROW = 0, 1, 2, 5, 14, 15, 16, 17
F_FLAT, F_SPHERICAL, F_ROTATED, F_OFF_AXIS = 1, 2, 4, 8
F_ALTERNATE, F_FINITE, KIND_SHIFT = 16, 32, 6

BLOCK = 256          # threads a block (a power of two: K2's tree sum)
BLOCKS_PER_SM = 8    # grid-stride grid: this many blocks on each SM
SMEM_LIMIT = 48*1024  # dynamic shared memory without an opt-in
SMEM_OPTIN = 227*1024  # what a block may opt in to on Hopper (K3, K6, K7)


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
            | (int(spec.kind) << KIND_SHIFT))


def pack_values(table, dtype, device):
    """The lowered table's values as one contiguous (S, ROW) tensor in
    `dtype` on `device` -- (L, S, ROW) for a stacked table."""
    table = lower_pose(table)
    cols = torch.cat([
        table.curvature[..., None], table.conic[..., None], table.offset,
        table.rot.flatten(-2), table.radius[..., None],
        table.mu[..., None], table.n_before[..., None]], dim=-1)
    # cast first (the kernel traces in `dtype`), then move
    return cols.to(dtype=dtype).to(device=device).contiguous()


def pack_table(table, specs, dtype, device):
    """The lowered table as one contiguous (S, ROW) tensor in `dtype`
    on `device` -- (L, S, ROW) for a stacked table, whose tables share
    the specs -- plus the (S,) int32 flags that encode each row's
    SurfaceSpec.  Rows that need the extended vocabulary raise
    NotImplementedError."""
    nsurf = table.curvature.shape[-1]
    if len(specs) != nsurf:
        raise ValueError("%d specs for a table of %d rows"
                         % (len(specs), nsurf))
    for j, spec in enumerate(specs[1:], 1):
        K.check_supported(spec, j)
    flags = torch.tensor([_flags(s) for s in specs], dtype=torch.int32,
                         device=device)
    return pack_values(table, dtype, device), flags


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


def _launch_setup(table, specs, state, smem_extra_words=0):
    """Checks, packing and launch shape for a CUDA bundle; a stacked
    table (leading wavelength axis) packs to (L, S, ROW) and may use
    Hopper's opt-in shared memory."""
    _check_state(state)
    x = state[0]
    if x.device.type != "cuda":
        raise ValueError("expected a CUDA or CPU bundle, got %s"
                         % x.device)
    from .cuda_build import load_library
    lib = load_library()
    packed, flags = pack_table(table, specs, x.dtype, x.device)
    nsurf = packed.shape[-2]
    word = x.element_size()
    smem = (packed[..., 0].numel()*ROW + smem_extra_words)*word + nsurf*4
    limit = SMEM_OPTIN if packed.dim() == 3 else SMEM_LIMIT
    if smem > limit:
        raise ValueError("%d table(s) of %d surfaces need %d bytes of shared "
                         "memory, above %d" % (packed[..., 0, 0].numel(),
                                               nsurf, smem, limit))
    n = x.shape[0]
    grid = max(1, min(-(-n // BLOCK), sm_count(x.device)*BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    return lib, suffix, packed, flags, nsurf, n, grid, stream


def _raise_on(lib, err, name):
    if err:
        msg = lib.trace_error_string(err).decode()
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, msg))


def trace_final(table, specs, state, clip=False):
    """K1: ((x, y, z, ux, uy, uz), t) after the last surface, for six
    contiguous (N,) components in float32 or float64.  CUDA bundles
    launch the kernel; CPU bundles take trace_final_reference."""
    if state[0].device.type == "cpu":
        _check_state(state)
        return trace_final_reference(table, specs, state, clip)
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        table, specs, state)
    outs = [torch.empty_like(state[0]) for _ in range(7)]
    if n == 0:
        return tuple(outs[:6]), outs[6]
    err = getattr(lib, "trace_final_" + suffix)(
        packed.data_ptr(), flags.data_ptr(), nsurf, int(bool(clip)),
        *(c.data_ptr() for c in state), *(o.data_ptr() for o in outs),
        n, grid, BLOCK, stream)
    _raise_on(lib, err, "trace_final")
    trace_final.launches += 1
    return tuple(outs[:6]), outs[6]


trace_final.launches = 0


def trace_merit(table, specs, state, clip=False):
    """K2: the five spot moments (count, sum x, sum y, sum x^2,
    sum y^2) of the K1 trace as 0-d tensors in the rays' dtype; feed
    spot_rms_from_moments.  CUDA bundles launch the kernel (block
    partial sums, then one torch sum over blocks); CPU bundles take
    trace_merit_reference."""
    if state[0].device.type == "cpu":
        _check_state(state)
        return trace_merit_reference(table, specs, state, clip)
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        table, specs, state, smem_extra_words=5*BLOCK)
    partials = torch.zeros((grid, 5), dtype=state[0].dtype,
                           device=state[0].device)
    if n:
        err = getattr(lib, "trace_merit_" + suffix)(
            packed.data_ptr(), flags.data_ptr(), nsurf, int(bool(clip)),
            *(c.data_ptr() for c in state), partials.data_ptr(), n, grid,
            BLOCK, stream)
        _raise_on(lib, err, "trace_merit")
        trace_merit.launches += 1
    tot = partials.sum(0)
    return tuple(tot[i] for i in range(5))


trace_merit.launches = 0


def trace_multi(tables, specs, state, merit=False):
    """K3: ONE bundle of six contiguous (N,) components (float32 or
    float64) through every table of a stack (leading wavelength axis),
    with no aperture clip and the specs of the first wavelength
    (`specs=None` derives them, multi_specs).  Returns one ((x, y, z,
    ux, uy, uz), t) a wavelength, or with merit=True one 5-tuple of
    count moments (count, sum x, sum y, sum x^2, sum y^2) a wavelength
    -- feed spot_rms_from_moments.  CUDA bundles launch the kernel;
    CPU bundles take trace_multi_reference."""
    _check_state(state)
    if state[0].device.type == "cpu":
        return trace_multi_reference(tables, specs, state, merit)
    specs = multi_specs(tables, specs)
    nlam = tables.curvature.shape[0]
    lib, suffix, packed, flags, nsurf, n, grid, stream = _launch_setup(
        tables, specs, state, smem_extra_words=5*nlam*BLOCK if merit else 0)
    x = state[0]
    if merit:
        out = torch.zeros((grid, nlam, 5), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((nlam, 7, n), dtype=x.dtype, device=x.device)
    if n:
        name = ("trace_multi_merit_" if merit else "trace_multi_") + suffix
        err = getattr(lib, name)(
            packed.data_ptr(), flags.data_ptr(), nsurf, nlam,
            *(c.data_ptr() for c in state), out.data_ptr(), n, grid, BLOCK,
            stream)
        _raise_on(lib, err, "trace_multi")
        trace_multi.launches += 1
    if merit:
        tot = out.sum(0)
        return tuple(tuple(tot[li, q] for q in range(5))
                     for li in range(nlam))
    return tuple((tuple(out[li, c] for c in range(6)), out[li, 6])
                 for li in range(nlam))


trace_multi.launches = 0
