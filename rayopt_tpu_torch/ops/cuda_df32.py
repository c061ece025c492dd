"""The df32 parity-grade kernels on CUDA, with their plain versions.

K10 `trace_final_df32` traces six df32 (hi, lo) ray components through
a `df32.plan` and returns the final state in the last surface's frame
(and, with_path, the optical path).  It replaces the JAX package's
Pallas kernel `df32.pallas_trace_df32`.

K11 `trace_multi_df32` traces ONE bundle through several plans (one a
wavelength); it replaces `df32.pallas_trace_df32_multi`.

K12 `trace_merit_df32` runs the K10 trace with no per-ray writeback
and reduces it to the five df32 spot moments (count, sum x, sum y,
sum x^2, sum y^2) over the rays whose x, y and uz hi words are finite,
each block's (hi, lo) pairs promoted exactly to float64 and summed.
K13 `trace_merit_multi_df32` does so for each plan.  The grid-wide sum
is fused into the one launch.  They replace
`df32.pallas_trace_df32_merit` and `df32.pallas_trace_df32_merit_multi`.

The kernels are hand-written CUDA C++ (csrc/df32_spec.cuh), compiled
for sm_90a per plan key (ops.cuda_spec.df32_multi_key: the plans' flag
tuples, the path, where the chain reads the plan words, the block and
launch bound; K10 and K12 are the keys of one plan) at first use, and
launched on PyTorch's current stream through ctypes.  The plan words
are packed step after step (pack_plan: DW words a step, then a Newton
row's figure and a grating or DOE row's phase words, whose row kind,
phase bits, coefficient counts and, on a freeform row, XY term mask (or
dense degree) its 64-bit flag word carries: step_words) and passed
from the host as kernel parameters,
with no upload; only a single plan too long for the parameters is
uploaded, once a call, as device words.  A plan list whose words pass
the parameter limit is launched in balanced runs that fit
(cuda_spec.df32_runs), one launch a run.  A wrapper takes the plain
PyTorch version (`*_reference`, ops.df32) only for a bundle on the CPU;
for a CUDA bundle it launches its kernel or raises.  Each wrapper counts its launches in
`<wrapper>.launches`.

`state` is six (hi, lo) pairs of contiguous (N,) float32 tensors on
one device (df32.state_from_f64).
"""

import functools

import torch

from . import df32 as D
from .kernels import _xy_terms

# packed step layout and flag bits: keep in sync with csrc/df32_common.cuh
DW = 36              # the words of a step without a figure
W_C, W_MU, W_DZ, W_K1, W_K1C, W_DXY, W_ROT, W_RAD, W_NB = (
    0, 2, 4, 6, 8, 10, 14, 32, 33)
W_FIG = DW           # a figure's words, by its row kind (step_words)
A_C1, A_K1, A_K1C, A_BC, CYL_WORDS = 0, 2, 4, 6, 6
A_CX, A_CY, A_CR, A_BXC, A_BYC, A_KX, A_KY, A_COEF = (0, 2, 4, 6, 8, 10,
                                                      11, 12)
G_FLAT, G_CONIC, G_ALTERNATE, G_OFF_AXIS = 1 << 2, 1 << 3, 1 << 4, 1 << 5
G_PERM, G_ROT, G_CLIP, G_FAST, G_PERM_SHIFT = (1 << 6, 1 << 7, 1 << 8,
                                               1 << 9, 10)
G_FIG_SHIFT, G_NA_SHIFT, G_NO_SHIFT = 19, 22, 26
G_CYL_CONIC = 1 << 30    # a conic cylinder: |N| is not 1
# a phase row (a 64-bit flag word): a linear grating, a radial
# diffractive phase (DOE) and its coefficient count
G_GRATING, G_DOE, G_ND_SHIFT = 1 << 31, 1 << 32, 33
# a freeform row: bits 37-63 hold its XY term mask (FIG_FREEFORM, one bit
# a term of the triangular order, up to XY_MASK_TERMS: degree 6) or, for
# a row with a nonzero term past the mask (FIG_XY_DENSE), its degree
G_XY_SHIFT, XY_MASK_TERMS = 37, 27
FIG_RADIAL, FIG_CYL_Y, FIG_CYL_X, FIG_BICONIC, FIG_TOROID = 1, 2, 3, 4, 5
FIG_FREEFORM, FIG_XY_DENSE = 6, 7
F_KY, F_COEF = 0, 1      # a freeform row's words after DW (xy_at)
MAX_COEFFS = 15          # even, odd (or DOE) coefficients a flag word counts
_FIGS = {"cyl_y": FIG_CYL_Y, "cyl_x": FIG_CYL_X, "biconic": FIG_BICONIC,
         "toroid": FIG_TOROID}


def fig_of(fl):
    """The row kind of a step's flag word (0 none, FIG_*)."""
    return (fl >> G_FIG_SHIFT) & 7


def xy_terms(fl):
    """The (i, j) exponents of the XY terms whose pairs a freeform step
    holds, in term order: the mask's (FIG_FREEFORM) or every term of the
    degree (FIG_XY_DENSE, zeros included); () for another step."""
    fig, field = fig_of(fl), (fl >> G_XY_SHIFT) & ((1 << 27) - 1)
    if fig == FIG_XY_DENSE:
        return _xy_terms(field)
    if fig == FIG_FREEFORM:
        return tuple(ij for t, ij in enumerate(_xy_terms(6))
                     if field >> t & 1)
    return ()


def xy_at(fl, kind):
    """The first word of a freeform step's value (kind 0), x-slope (1) or
    y-slope (2) pairs, or (kind 3) the word after them: DW, the seed's
    float32 conic, the base's coefficients, then the pairs of each kind
    in term order (a value pair every term, an x-slope pair where i > 0,
    a y-slope pair where j > 0)."""
    terms = xy_terms(fl)
    at = DW + F_COEF + 2*(((fl >> G_NA_SHIFT) & 15)
                          + ((fl >> G_NO_SHIFT) & 15))
    counts = (len(terms), sum(i > 0 for i, _ in terms),
              sum(j > 0 for _, j in terms))
    return at + 2*sum(counts[:kind])


def phase_at(fl):
    """The first of a step's phase words: DW, then its figure's words: an
    aspheric row's even and odd coefficients (pairs); a conic cylinder's
    c1, 1 + k and (1 + k) c1 (pairs), and on a phase row (1 + k) c1^2
    (a pair, its normal's); a biconic's or toroid's cx, cy, cr, (1 + kx)
    cx^2, (1 + ky) cy^2 (pairs), its float32 seed's kx and ky, then its
    coefficients (pairs; the seed reads the hi words of those and of cx,
    cy and cr, its float32 values); a freeform row's words (xy_at: its
    base's c and 1 + conic are the step's own)."""
    fig = fig_of(fl)
    coef = 2*(((fl >> G_NA_SHIFT) & 15) + ((fl >> G_NO_SHIFT) & 15))
    if fig == FIG_RADIAL:
        return DW + coef
    if fig in (FIG_CYL_Y, FIG_CYL_X):
        return DW + CYL_WORDS + (2 if fl & (G_GRATING | G_DOE) else 0)
    if fig in (FIG_BICONIC, FIG_TOROID):
        return DW + A_COEF + coef
    if fig in (FIG_FREEFORM, FIG_XY_DENSE):
        return xy_at(fl, 3)
    return DW


def step_words(fl):
    """The words of a step with flag word fl: phase_at, then a phase
    row's grating_dy (a pair, G_GRATING), the DOE's nd kick coefficients
    2 (i + 1) a_i and its nd path coefficients a_i n_after / n_before
    (pairs, G_DOE)."""
    nd = (fl >> G_ND_SHIFT) & 15
    return phase_at(fl) + (2 if fl & G_GRATING else 0) \
        + (4*nd if fl & G_DOE else 0)


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


def _consts(consts):
    return [float(v) for pair in consts for v in pair]


def _freeform_words(st):
    """(row kind, XY flag bits, words after DW) of a freeform step:
    FIG_FREEFORM and its term mask where its nonzero terms fit
    XY_MASK_TERMS, else FIG_XY_DENSE and its degree, every term's pairs,
    zeros included (a
    zero term adds an exact zero on finite values, so the kernel keeps
    the plain version's words; one flag word stays enough at any
    degree).  The kernel reads the base's c and 1 + conic from the
    step's own words and the float32 seed's coefficients from the hi
    words of their pairs: both are checked here."""
    an, f = st["anam"], st["anam"]["f32"]
    k1 = st["k1"] if st["k1"] is not None else D._ONE
    same = (tuple(an["c"]) == tuple(st["c"]) and tuple(an["k1"]) == tuple(k1)
            and an["asp"] == st["asp"] and an["asp_odd"] == st["asp_odd"]
            and f["cy"] == an["c"][0]
            and f["asp"] == tuple(p[0] for p in an["asp"])
            and f["asp_odd"] == tuple(p[0] for p in an["asp_odd"]))
    terms = _xy_terms(an["deg"])
    index = {ij: t for t, ij in enumerate(terms)}
    held = [index[(i, j)] for _, i, j in an["xy"]]
    same = same and all(f["xy"][t] == (an["xy"][held.index(t)][0][0]
                                       if t in held else 0.)
                        for t in range(len(terms)))
    if not same:
        raise ValueError("a freeform step's base or seed differs from the "
                         "words the kernel reads for them")
    if max(held) < XY_MASK_TERMS:
        fig, bits = FIG_FREEFORM, sum(1 << t for t in held) << G_XY_SHIFT
        value, gx, gy = an["xy"], an["xy_gx"], an["xy_gy"]
    else:
        fig, bits = FIG_XY_DENSE, an["deg"] << G_XY_SHIFT
        # the plan's pairs where it holds the term (a slope term's
        # exponents name it), exact zeros elsewhere
        zero = (0., 0.)
        val, sx, sy = ({(i, j): p for p, i, j in an[k]}
                       for k in ("xy", "xy_gx", "xy_gy"))
        value = [(val.get((i, j), zero), i, j) for i, j in terms]
        gx = [(sx.get((i - 1, j), zero), i - 1, j) for i, j in terms if i]
        gy = [(sy.get((i, j - 1), zero), i, j - 1) for i, j in terms if j]
    ext = ([float(f["ky"])] + _consts(an["asp"]) + _consts(an["asp_odd"])
           + _consts([p for p, _, _ in (*value, *gx, *gy)]))
    return fig, bits, ext


def _figure_words(st):
    """(flag bits, words after DW) of a step's figure."""
    an = st["anam"]
    bits = 0
    if an is None:
        if not (st["asp"] or st["asp_odd"]):
            return 0, []
        fig, asp, asp_odd = FIG_RADIAL, st["asp"], st["asp_odd"]
        ext = _consts(asp) + _consts(asp_odd)
    elif an["mode"] in ("cyl_y", "cyl_x"):
        fl = _FIGS[an["mode"]] << G_FIG_SHIFT
        if not an["circular"]:
            fl |= G_CYL_CONIC
        return fl, _consts((an["c1"], an["k1"], an["k1c"])
                           + ((an["bc"],) if "bc" in an else ()))
    elif an["mode"] == "freeform":
        fig, bits, ext = _freeform_words(st)
        asp, asp_odd = an["asp"], an["asp_odd"]
    else:
        fig, asp, asp_odd = _FIGS[an["mode"]], an["asp"], an["asp_odd"]
        f = an["f32"]
        ext = (_consts([an[k] for k in ("cx", "cy", "cr", "bxc", "byc")])
               + [float(f["kx"]), float(f["ky"])] + _consts(asp)
               + _consts(asp_odd))
    if max(len(asp), len(asp_odd)) > MAX_COEFFS:
        raise ValueError("a df32 step holds at most %d even and %d odd "
                         "coefficients, got %d and %d" % (
                             MAX_COEFFS, MAX_COEFFS, len(asp), len(asp_odd)))
    return (fig << G_FIG_SHIFT | bits | len(asp) << G_NA_SHIFT
            | len(asp_odd) << G_NO_SHIFT), ext


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
        w[W_DXY:W_DXY + 4] = _consts(st["dxy"])
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
    fig, ext = _figure_words(st)
    fl |= fig
    if st.get("grat") is not None:
        fl |= G_GRATING
        ext = ext + _consts((st["grat"],))
    if st.get("doe") is not None:
        nd = len(st["doe"])
        if nd > MAX_COEFFS:
            raise ValueError("a df32 step holds at most %d DOE coefficients, "
                             "got %d" % (MAX_COEFFS, nd))
        fl |= G_DOE | nd << G_ND_SHIFT
        ext = ext + _consts(st["doe"]) + _consts(st["doe_path"])
    # the flag word as the kernels' signed 64-bit Flag holds it: bit 63,
    # the mask's last term, makes it negative
    return w + ext, fl - (1 << 64) if fl >> 63 else fl


def pack_plan(plans, device):
    """One plan (a list of steps) or a sequence of plans as the kernels
    read them: a plan's words, step after step (step_words of each
    step's flag word), as (W,) float32 and its (S,) int64 flags, or
    (L, W) and (L, S) for L plans of S steps each, a plan shorter than
    the longest padded with zeros to W, on `device`."""
    multi = bool(plans) and isinstance(plans[0], (list, tuple))
    group = list(plans) if multi else [plans]
    nsteps = {len(p) for p in group}
    if len(nsteps) != 1 or 0 in nsteps:
        raise ValueError("plans must share one nonzero step count, got %s"
                         % sorted(nsteps))
    packed = [[_step_words(st) for st in p] for p in group]
    rows = [[v for w, _ in p for v in w] for p in packed]
    most = max(len(r) for r in rows)
    words = torch.tensor([r + [0.]*(most - len(r)) for r in rows],
                         dtype=torch.float32)
    flags = torch.tensor([[f for _, f in p] for p in packed],
                         dtype=torch.int64)
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


@functools.lru_cache(maxsize=None)
def _multi_kernel(kernel, flags, with_path):
    """The loaded trace ("k11") or merit ("k13") build of the plans'
    flag tuples (cuda_spec.df32_key_of; K10 or K12 at one plan; built at
    first use)."""
    from . import cuda_spec as CS
    return CS.load(CS.df32_key_of(flags, kernel, with_path))


def _runs(kernel, plans, with_path=False):
    """The launches of `plans`: (l0, l1, loaded build) of each balanced
    run of plans whose words fit a key's kernel parameters
    (cuda_spec.df32_runs), and every plan's packed words on the host."""
    from .cuda_spec import df32_runs
    packed, flags = pack_plan(list(plans), "cpu")
    flags = tuple(map(tuple, flags.tolist()))
    return [(l0, l1, _multi_kernel(kernel, flags[l0:l1], bool(with_path)))
            for l0, l1 in df32_runs(flags, kernel)], packed


def _word_ptr(kern, packed, device):
    """The launcher's plan words (a run's rows of the packed words, cut to
    its key's plan words): the host-side words (copied into the kernel's
    parameters), or a device copy (device words), kept alive by the
    returned tensor."""
    packed = packed[:, :kern.key.plan_words].contiguous()
    if kern.key.device_words:
        packed = packed.to(device)
    return packed.data_ptr(), packed


def _trace(plans, words, with_path):
    """The (nlam, 12 or 14, n) output of the trace of `plans`: one launch
    a run (none for no rays); returns it and the launches."""
    from .cuda_spec import spec_launch
    device, n, stream = spec_launch(words)
    runs, packed = _runs("k11", plans, with_path)
    out = torch.empty((len(packed), 14 if with_path else 12, n),
                      dtype=torch.float32, device=device)
    if not n:
        return out, 0
    for l0, l1, kern in runs:
        ptr, _keep = _word_ptr(kern, packed[l0:l1], device)
        kern.check(kern.fn(ptr, *(w.data_ptr() for w in words),
                           out[l0].data_ptr(), n, kern.grid(n, device),
                           stream))
    return out, len(runs)


def _merit(plans, words):
    """The (nlam, 5) float64 moments of `plans`: one launch a run, the
    grid-wide sum fused (zeros and no launch for no rays); returns them
    and the launches."""
    from .cuda_spec import counter, spec_launch
    device, n, stream = spec_launch(words)
    runs, packed = _runs("k13", plans)
    if not n:
        return torch.zeros((len(packed), 5), dtype=torch.float64,
                           device=device), 0
    tot = torch.empty((len(packed), 5), dtype=torch.float64, device=device)
    # the kernel's last block resets the counter, so the runs, in order
    # on one stream, share it
    for l0, l1, kern in runs:
        grid = kern.grid(n, device)
        partials = torch.empty((grid, l1 - l0, 10), dtype=torch.float32,
                               device=device)
        ptr, _keep = _word_ptr(kern, packed[l0:l1], device)
        kern.check(kern.fn(ptr, *(w.data_ptr() for w in words),
                           partials.data_ptr(), counter(device).data_ptr(),
                           tot[l0].data_ptr(), n, grid, stream))
    return tot, len(runs)


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
    plan's key once (no launch for no rays); CPU bundles take
    trace_final_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_final_df32_reference(steps, state, with_path)
    out, launched = _trace([steps], words, with_path)
    trace_final_df32.launches += launched
    return _final(out[0], with_path)


trace_final_df32.launches = 0


def trace_multi_df32(plans, state, with_path=False):
    """K11: ONE bundle through every plan of `plans` (one a wavelength,
    equal step counts); returns one K10 result a plan.  CUDA bundles
    launch the plans' key once a run of plans that fits its parameters
    (no launch for no rays); CPU bundles take
    trace_multi_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_multi_df32_reference(plans, state, with_path)
    out, launched = _trace(plans, words, with_path)
    trace_multi_df32.launches += launched
    return tuple(_final(out[li], with_path) for li in range(out.shape[0]))


trace_multi_df32.launches = 0


def trace_merit_df32(steps, state):
    """K12: the five df32 spot moments (count, sum x, sum y, sum x^2,
    sum y^2) of the K10 trace as 0-d float64 tensors; feed
    ops.cuda_trace.spot_rms_from_moments.  CUDA bundles launch the
    plan's key once, the grid-wide sum fused (zeros and no launch for no
    rays); CPU bundles take trace_merit_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_merit_df32_reference(steps, state)
    tot, launched = _merit([steps], words)
    trace_merit_df32.launches += launched
    return tuple(tot[0, q] for q in range(5))


trace_merit_df32.launches = 0


def trace_merit_multi_df32(plans, state):
    """K13: K12 for each plan of `plans`; one 5-tuple of float64 moments
    a plan.  CUDA bundles launch the plans' key once a run of plans that
    fits its parameters, the grid-wide sum fused (zeros and no launch
    for no rays); CPU bundles take trace_merit_multi_df32_reference."""
    words = _words(state)
    if words[0].device.type == "cpu":
        return trace_merit_multi_df32_reference(plans, state)
    tot, launched = _merit(plans, words)
    trace_merit_multi_df32.launches += launched
    return tuple(tuple(tot[li, q] for q in range(5))
                 for li in range(tot.shape[0]))


trace_merit_multi_df32.launches = 0
