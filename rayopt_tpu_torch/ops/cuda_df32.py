"""The df32 parity-grade kernels on CUDA, with their plain versions.

K10 `trace_final_df32` traces six df32 (hi, lo) ray components through
a `df32.plan` and returns the final state in the last surface's frame
(and, with_path, the optical path).  It replaces the JAX package's
Pallas kernel `df32.pallas_trace_df32`.

K11 `trace_multi_df32` traces ONE bundle, read once, through several
plans (one a wavelength); it replaces `df32.pallas_trace_df32_multi`.

K12 `trace_merit_df32` runs the K10 trace with no per-ray writeback
and reduces it to the five df32 spot moments (count, sum x, sum y,
sum x^2, sum y^2) over the rays whose x, y and uz hi words are finite:
one (hi, lo) pair a moment a block, promoted exactly to float64 and
summed here.  K13 `trace_merit_multi_df32` does so for each plan.  They
replace `df32.pallas_trace_df32_merit` and
`df32.pallas_trace_df32_merit_multi`.

The kernels are hand-written CUDA C++ (csrc/df32.cu), built with nvcc
for sm_90a at first use (ops.cuda_build) and launched on PyTorch's
current stream through ctypes.  A wrapper takes the plain PyTorch
version (`*_reference`, ops.df32) only for a bundle on the CPU; for a
CUDA bundle it launches its kernel or raises.  Each wrapper counts its
launches in `<wrapper>.launches`.

`state` is six (hi, lo) pairs of contiguous (N,) float32 tensors on
one device (df32.state_from_f64).
"""

import torch

from . import df32 as D
from .cuda_trace import BLOCK, BLOCKS_PER_SM, SMEM_LIMIT, SMEM_OPTIN, _raise_on

# packed step layout and flag bits: keep in sync with csrc/df32.cu
DW = 36
W_C, W_MU, W_DZ, W_K1, W_K1C, W_DXY, W_ROT, W_RAD, W_NB = (
    0, 2, 4, 6, 8, 10, 14, 32, 33)
G_FLAT, G_CONIC, G_ALTERNATE, G_OFF_AXIS = 1 << 2, 1 << 3, 1 << 4, 1 << 5
G_PERM, G_ROT, G_CLIP, G_FAST, G_PERM_SHIFT = (1 << 6, 1 << 7, 1 << 8,
                                               1 << 9, 10)


def trace_final_df32_reference(steps, state, with_path=False):
    """Plain version of K10 (ops.df32.trace_df32_final)."""
    return D.trace_df32_final(steps, state, with_path=with_path)


def trace_multi_df32_reference(plans, state, with_path=False):
    """Plain version of K11 (ops.df32.trace_df32_final_multi)."""
    return D.trace_df32_final_multi(plans, state, with_path=with_path)


def trace_merit_df32_reference(steps, state):
    """Plain version of K12 (ops.df32.trace_df32_merit)."""
    return D.trace_df32_merit(steps, state)


def trace_merit_multi_df32_reference(plans, state):
    """Plain version of K13 (ops.df32.trace_df32_merit_multi)."""
    return D.trace_df32_merit_multi(plans, state)


def _step_words(st):
    w = [0.]*DW
    for key, at in (("c", W_C), ("mu", W_MU), ("dz", W_DZ), ("k1", W_K1),
                    ("k1c", W_K1C), ("nb", W_NB)):
        if st[key] is not None:
            w[at:at + 2] = (float(st[key][0]), float(st[key][1]))
    fl = st["kind"]
    if st["flat"]:
        fl |= G_FLAT
    if st["k1"] is not None:
        fl |= G_CONIC
    if st["alternate"]:
        fl |= G_ALTERNATE
    if st["dxy"] is not None:
        fl |= G_OFF_AXIS
        w[W_DXY:W_DXY + 4] = [float(v) for pair in st["dxy"] for v in pair]
    if st["rotm"] is not None:
        fl |= G_PERM
        for r, row in enumerate(st["rotm"]):
            col = [k for k in range(3) if row[k]]
            if len(col) != 1 or abs(row[col[0]]) != 1:
                raise ValueError("rotm row %s is not a signed permutation"
                                 % (row,))
            code = col[0] | (4 if row[col[0]] < 0 else 0)
            fl |= code << (G_PERM_SHIFT + 3*r)
    elif st["rot_df"] is not None:
        fl |= G_ROT
        w[W_ROT:W_ROT + 18] = [float(v) for row in st["rot_df"]
                               for pair in row for v in pair]
    if st["clip"] and st["radius"] is not None:
        fl |= G_CLIP
        w[W_RAD] = float(st["radius"])
    if st["fast"]:
        fl |= G_FAST
    return w, fl


def pack_plan(plans, device):
    """One plan (a list of steps) or a sequence of plans as the kernels
    read them: (S, DW) float32 words and (S,) int32 flags, or (L, S, DW)
    and (L, S) for L plans of S steps each, on `device`."""
    multi = bool(plans) and isinstance(plans[0], (list, tuple))
    group = list(plans) if multi else [plans]
    nsteps = {len(p) for p in group}
    if len(nsteps) != 1 or 0 in nsteps:
        raise ValueError("plans must share one nonzero step count, got %s"
                         % sorted(nsteps))
    packed = [[_step_words(st) for st in p] for p in group]
    words = torch.tensor([[w for w, _ in p] for p in packed],
                         dtype=torch.float32)
    flags = torch.tensor([[f for _, f in p] for p in packed],
                         dtype=torch.int32)
    if not multi:
        words, flags = words[0], flags[0]
    return words.to(device), flags.to(device)


def _words(state):
    """The 12 (N,) float32 input words, after checking them."""
    if len(state) != 6 or any(len(c) != 2 for c in state):
        raise ValueError("state must hold 6 (hi, lo) pairs")
    words = [w for c in state for w in c]
    x = words[0]
    for w in words:
        if not isinstance(w, torch.Tensor) or w.dtype != torch.float32:
            raise TypeError("df32 words must be float32 tensors")
        if w.device != x.device:
            raise ValueError("all 12 words must share a device (%s vs %s)"
                             % (w.device, x.device))
        if w.dim() != 1 or w.shape != x.shape:
            raise ValueError("words must be (N,) of one length, got %s and "
                             "%s" % (tuple(x.shape), tuple(w.shape)))
        if not w.is_contiguous():
            raise ValueError("words must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("expected a CUDA or CPU bundle, got %s" % x.device)
    return words


def _launch_setup(plans, words, extra_smem=0):
    from .cuda_build import load_library
    x = words[0]
    lib = load_library()
    packed, flags = pack_plan(plans, x.device)
    nsteps = flags.shape[-1]
    smem = packed.numel()*4 + flags.numel()*4 + extra_smem
    limit = SMEM_OPTIN if flags.dim() == 2 else SMEM_LIMIT
    if smem > limit:
        raise ValueError("%d plan(s) of %d steps need %d bytes of shared "
                         "memory, above %d" % (flags[..., 0].numel(), nsteps,
                                               smem, limit))
    n = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = max(1, min(-(-n // BLOCK), sms*BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lib, packed, flags, nsteps, n, grid, stream


def _pairs(out):
    """(2k, n) words -> k (hi, lo) pairs of row views."""
    return tuple((out[2*i], out[2*i + 1]) for i in range(out.shape[0] // 2))


def _final(out, with_path):
    comps = _pairs(out)
    return (comps[:6], comps[6]) if with_path else comps


def trace_final_df32(steps, state, with_path=False):
    """K10: the df32 trace of `state` through the plan `steps`, as
    ops.df32.trace_df32_final returns it: six (hi, lo) pairs, and with
    with_path=True also the optical path pair.  CUDA bundles launch the
    kernel; CPU bundles take trace_final_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_final_df32_reference(steps, state, with_path)
    lib, packed, flags, nsteps, n, grid, stream = _launch_setup(steps, words)
    out = torch.empty((14 if with_path else 12, n), dtype=torch.float32,
                      device=words[0].device)
    if n:
        err = lib.df32_trace_final(
            packed.data_ptr(), flags.data_ptr(), nsteps, int(bool(with_path)),
            *(w.data_ptr() for w in words), out.data_ptr(), n, grid, BLOCK,
            stream)
        _raise_on(lib, err, "df32_trace_final")
        trace_final_df32.launches += 1
    return _final(out, with_path)


trace_final_df32.launches = 0


def trace_multi_df32(plans, state, with_path=False):
    """K11: ONE bundle, read once, through every plan of `plans` (one a
    wavelength, equal step counts); returns one K10 result a plan.  CUDA
    bundles launch the kernel; CPU bundles take
    trace_multi_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_multi_df32_reference(plans, state, with_path)
    lib, packed, flags, nsteps, n, grid, stream = _launch_setup(
        list(plans), words)
    nplans = flags.shape[0]
    out = torch.empty((nplans, 14 if with_path else 12, n),
                      dtype=torch.float32, device=words[0].device)
    if n:
        err = lib.df32_trace_multi(
            packed.data_ptr(), flags.data_ptr(), nsteps, nplans,
            int(bool(with_path)), *(w.data_ptr() for w in words),
            out.data_ptr(), n, grid, BLOCK, stream)
        _raise_on(lib, err, "df32_trace_multi")
        trace_multi_df32.launches += 1
    return tuple(_final(out[li], with_path) for li in range(nplans))


trace_multi_df32.launches = 0


def _promote(partials):
    """(grid, ..., 5, 2) block pairs -> float64 totals (..., 5): each
    pair promoted exactly, then summed over blocks in float64."""
    return (partials[..., 0].double() + partials[..., 1].double()).sum(0)


def trace_merit_df32(steps, state):
    """K12: the five df32 spot moments (count, sum x, sum y, sum x^2,
    sum y^2) of the K10 trace as 0-d float64 tensors; feed
    ops.cuda_trace.spot_rms_from_moments.  CUDA bundles launch the
    kernel; CPU bundles take trace_merit_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_merit_df32_reference(steps, state)
    lib, packed, flags, nsteps, n, grid, stream = _launch_setup(
        steps, words, extra_smem=10*4*(BLOCK // 32))
    partials = torch.zeros((grid, 5, 2), dtype=torch.float32,
                           device=words[0].device)
    if n:
        err = lib.df32_merit(
            packed.data_ptr(), flags.data_ptr(), nsteps,
            *(w.data_ptr() for w in words), partials.data_ptr(), n, grid,
            BLOCK, stream)
        _raise_on(lib, err, "df32_merit")
        trace_merit_df32.launches += 1
    tot = _promote(partials)
    return tuple(tot[q] for q in range(5))


trace_merit_df32.launches = 0


def trace_merit_multi_df32(plans, state):
    """K13: K12 for each plan of `plans` (the bundle read once); one
    5-tuple of float64 moments a plan.  CUDA bundles launch the kernel;
    CPU bundles take trace_merit_multi_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_merit_multi_df32_reference(plans, state)
    nplans = len(plans)
    lib, packed, flags, nsteps, n, grid, stream = _launch_setup(
        list(plans), words,
        extra_smem=10*4*(BLOCK // 32) + 5*8*nplans*BLOCK)
    partials = torch.zeros((grid, nplans, 5, 2), dtype=torch.float32,
                           device=words[0].device)
    if n:
        err = lib.df32_merit_multi(
            packed.data_ptr(), flags.data_ptr(), nsteps, nplans,
            *(w.data_ptr() for w in words), partials.data_ptr(), n, grid,
            BLOCK, stream)
        _raise_on(lib, err, "df32_merit_multi")
        trace_merit_multi_df32.launches += 1
    tot = _promote(partials)
    return tuple(tuple(tot[li, q] for q in range(5)) for li in range(nplans))


trace_merit_multi_df32.launches = 0
