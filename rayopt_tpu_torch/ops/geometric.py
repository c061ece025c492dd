"""The geometric trace engine: a walk over the SurfaceTable rows.

Rays are carried as six (N,) component tensors; the (N, 3) layout is
only used at the API boundary.  The JAX package runs the generic walk
as one `lax.scan`; here it is a Python loop over rows, each a handful
of elementwise torch operations on the whole bundle.

* trace_rays            -- full history (S, N, 3) per quantity, the
                           analog of GeometricTrace's y/u/i/t arrays.
* trace_rays_final      -- carry-only variant: rays after the last
                           surface plus accumulated optical path.
* trace_rays_final_fast -- the throughput entry point: on a CUDA
                           bundle the hand-written fused kernel
                           (ops.cuda_trace.trace_final), on the CPU the
                           plain walk.
* trace_rays_final_multi -- the polychromatic/batched carry-only trace
                           of a stacked table (System.tables), one
                           bundle per table.
"""

import torch

from . import kernels as K
from .tables import lower_pose, table_at


def _entry(table, state, specs=None):
    # element-0 from_normal seeds the walk (reference
    # geometric_trace.py:75-76); static specs elide an identity
    if specs is None or specs[0].rotated:
        r0 = table.rot[0]
        state = (*K.rot_apply_t(r0, *state[:3]),
                 *K.rot_apply_t(r0, *state[3:]))
    return state


def _exit(table, state, specs=None):
    # state is from_normal'd; recover the last surface's local frame
    nsurf = table.curvature.shape[0]
    if specs is None or specs[nsurf - 1].rotated:
        rl = table.rot[nsurf - 1]
        return (*K.rot_apply(rl, *state[:3]), *K.rot_apply(rl, *state[3:]))
    return state


def _steps(table, state, clip, specs):
    """Yield (state, local outputs) after each row 1..S-1."""
    if specs is None:
        K.require_conic(table)
    for j in range(1, table.curvature.shape[0]):
        surf = table.row(j)
        if specs is None:
            state, out = K.surface_step(state, surf, clip)
        else:
            state, out = K.surface_step_spec(state, surf, specs[j], clip)
        yield state, out


def trace_rays(table, y0, u0, clip=False, specs=None):
    """Trace rays y0, u0 ((N, 3) tensors; element-0 local frame)
    through all surfaces.  Returns (y, u, i, t): (S, N, 3) x3 and
    (S, N), surface 0 holding the seed (t[0] = 0), matching
    GeometricTrace's layout (reference geometric_trace.py:37-47).
    With `specs` (from kernels.specialize) each row takes its
    specialized step; without, the generic one."""
    table = lower_pose(table).to(device=y0.device, dtype=y0.dtype)
    state = _entry(table, (*K.split(y0), *K.split(u0)), specs)
    ys, us, iis, ts = [y0], [u0], [u0], [torch.zeros_like(y0[..., 0])]
    for state, (yl, ul, il, t) in _steps(table, state, clip, specs):
        ys.append(K.join(*yl))
        us.append(K.join(*ul))
        iis.append(K.join(*il))
        ts.append(t)
    return (torch.stack(ys), torch.stack(us), torch.stack(iis),
            torch.stack(ts))


def trace_components_final(table, state, clip=False, specs=None):
    """Carry-only trace on component state (x, y, z, ux, uy, uz),
    each (N,).  Returns (state_local, t_total) after the last
    surface."""
    table = lower_pose(table).to(device=state[0].device,
                                 dtype=state[0].dtype)
    tacc = torch.zeros_like(state[0])
    state = _entry(table, tuple(state), specs)
    for state, (yl, ul, il, t) in _steps(table, state, clip, specs):
        tacc = tacc + t
    return _exit(table, state, specs), tacc


def trace_rays_final(table, y0, u0, clip=False, specs=None):
    """Carry-only trace: returns (y, u, t_total) after the last
    surface (local frame), with t_total the accumulated optical
    path."""
    out, tacc = trace_components_final(
        table, (*K.split(y0), *K.split(u0)), clip=clip, specs=specs)
    return K.join(*out[:3]), K.join(*out[3:]), tacc


def trace_rays_final_fast(table, y0, u0, clip=False, specs=None,
                          precision="fast"):
    """Fastest final-state trace for the bundle's device.

    On a CUDA bundle the fused kernel ops.cuda_trace.trace_final runs
    the whole specialized surface chain in one pass over the rays:
    precision="fast" traces in the rays' dtype; precision="parity"
    traces in float64 and returns float64.  That is the JAX package's
    own backend rule -- double-single (df32) only where float64 is
    emulated, native float64 where it is not -- and the H100 has native
    FP64.  The df32 engine itself is ops.df32 (plan, state_from_f64,
    the plain trace and merit) with its kernels in ops.cuda_df32
    (trace_final_df32, trace_merit_df32 and their multi-plan twins).
    `specs` default to kernels.specialize of the table.  On the CPU
    both precisions take the plain generic walk (parity in float64).

    Returns (y (N, 3), u (N, 3), t (N,)).  Not differentiable on the
    CUDA path."""
    if precision not in ("fast", "parity"):
        raise ValueError("precision must be 'fast' or 'parity', got %r"
                         % (precision,))
    if precision == "parity":
        y0, u0 = y0.double(), u0.double()
    if y0.device.type != "cuda":
        return trace_rays_final(table, y0, u0, clip=clip)
    from .cuda_trace import trace_final
    if specs is None:
        specs = K.specialize(table)
    state = tuple(c.contiguous() for c in (*K.split(y0), *K.split(u0)))
    out, tacc = trace_final(table, specs, state, clip=clip)
    return K.join(*out[:3]), K.join(*out[3:]), tacc


def trace_rays_final_multi(tables, y0, u0, clip=False, specs=None,
                           unroll=False, biconic=False):
    """Polychromatic/batched trace: `tables` is a SurfaceTable whose
    fields carry a leading batch axis (e.g. one row per wavelength,
    from System.tables), y0/u0 are (B, N, 3).  Each table traces its
    own bundle with trace_rays_final; the static specs are shared (the
    geometry is identical, only indices differ across wavelengths).
    Returns (y (B, N, 3), u (B, N, 3), t (B, N)).  `unroll` (a JAX
    compilation choice) is accepted and ignored; biconic=True raises
    NotImplementedError (the extended vocabulary)."""
    if biconic:
        from ..parallel.grad import _no_biconic
        _no_biconic(biconic)
    outs = [trace_rays_final(table_at(tables, b), y0[b], u0[b], clip=clip,
                             specs=specs)
            for b in range(tables.curvature.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))
