"""Chip smoke test of rayopt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout (K4 and K5 once
for each spec tuple, slot set and flag they run with, all keys in
parallel, with their ptxas registers, stack and spills), holds each
against its plain PyTorch version on the card (the specialized K5 for
each slot set, with and without ray cotangents; the repaired
cancellation-free intercept of K1, K2 and K4 on a paraboloid and on the
double Gauss with near-flat rows against the CPU float64 generic
trace), drives the port's four
main paths -- the forward path (double Gauss from YAML -> paraxial
solve -> pupil aiming -> fused trace and fused spot-moment merit at
three fields), the designer loop (bundles at 3 fields x 3
wavelengths -> optimize_grad on the weighted-moment and adjoint
kernels -> write back), the achromatization path (stacked
3-wavelength tables -> glass relaxation -> polychromatic union spot
RMS on the stacked-wavelength kernels at 3 fields -> Adam over
curvatures, distances and glasses, with the stacked trace reporting
the spots) and the design path (the composite merit of 9 spot
bundles, 3 wavefront-RMS bundles on the OPD kernel and its adjoint,
and a focal-length penalty -> optimize_grad -> write back -> Strehl,
PSF, MTF and the host OPD/Zernike cross-check) -- then the
parity-grade df32 path (the forward path's aimed bundles -> df32.plan
-> the df32 trace and moment merit, and their multi-wavelength twins,
against the CPU float64 trace) -- and times the kernels against their
plain versions (the stacked-wavelength ones also against their
monochromatic twins).
Every phase raises on a failure; the script exits non-zero and prints
no result without a CUDA device.  The last line of stdout is the
device JSON, the line before it the kernels JSON.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

DEVICE = "cuda"      # the card: every tensor but the CPU references
N_CHECK = 1 << 20    # rays in the kernel-vs-plain checks
N_AIMED = 1 << 22    # rays per field on the main path
N_BENCH = 1 << 26    # rays in the throughput phase
N_OPT = 1 << 20      # hexapolar nrays a bundle on the optimizer path
N_GRAD_TIME = 1 << 22  # rays in the K3-K7 kernel-vs-plain timings
N_OPT_BUNDLE = 1046071  # rays of one optimizer bundle (hexapolar, 2^20)
N_INTERCEPT = 1 << 16  # aimed rays a field in the intercept phase
N_GLASS = 1 << 20    # hexapolar nrays a field on the achromatization path
FIELDS = (0., .7, 1.)
SEED = 0
OPT_SELECT = ("curvature", "distance")
OPT_FIELDS = ("curvature", "offset")   # the table fields OPT_SELECT moves
OPT_STEPS = 10
OPT_LR = 1e-7        # Adam: the merit falls at every step on the CPU
FD_STEP = {"curvature": 1e-8, "distance": 1e-6}   # 1/mm, mm
FD_VD_STEP = 1e-3    # Abbe number
N_DESIGN = 1 << 20   # hexapolar nrays a bundle on the design path
DESIGN_STEPS = 10
DESIGN_LR = 1e-7     # Adam on the design path (curvature 1/mm, distance mm)
DESIGN_PENALTY = 1e-4  # weight of the focal-length penalty (as the bench)
N_HOST_OPD = 4000    # hexapolar nrays of the host OPD/Zernike cross-check
BREAKDOWN_REPS = 5   # design-step parts timed after the path
GLASS_STEPS = 10
# Adam on the achromatization path, per parameter group (1/mm, mm, and
# the glass-box logits of nd and vd)
GLASS_LR = {"curvature": 5e-8, "distance": 5e-8, "glass": 3e-5}

# tolerances (kernel vs plain on the card, live rays)
F64_REL = 1e-12      # float64: max |a - b| / max(1, max |b|) per output
F32_ABS = 5e-5       # float32: mm for positions, unitless directions
F32_T_REL = 1e-5     # float32 optical path t (~200 mm) relative
F32_NAN_FRAC = 1e-5  # float32: share of rays whose NaN masks differ
F32_MOM_REL = 1e-4   # float32 moment sums, relative to their scale
PARITY_REL = 1e-9    # float64 K1 spot RMS vs the CPU float64 trace
DF32_REL = 1e-13     # df32 kernel vs plain: of max(1, |value|) per output
#                      (words expected identical), moments of their scale
DF32_F64_ATOL = 1e-10  # mm: df32 K10 image positions vs float64 K1
GRAD_F64_REL = 1e-9  # float64 K5 cotangents, of their field's/kind's max
GRAD_F32_REL = 1e-3  # float32 K5 on axis: sums of 2^20 float32 terms
F32_RAY_REL = 1e-2   # float32 K5 ray cotangents: a float32 image
#                      coordinate carries K1's ~2e-5 mm on a ~0.03 mm
#                      spot, twice that on the weight cotangent's squares
FD_REL = 1e-5        # float64 K5 vs central differences of the K4 merit
OPT_MERIT_REL = 1e-9  # optimizer step 0 merit, card vs CPU plain
OPT_GRAD_REL = 1e-8   # optimizer step 0 gradient, of its field's max
OPD_F32_REL = 4e-6   # float32 K8 vs float32 plain, of max |k| (~1.1e5
#                      waves on the double Gauss: a float32 ulp is
#                      ~0.008); each is ~1e-6 of it off the float64 one
OPD_F32_SUM_REL = 1e-2  # float32 K9 parameter/centre sums vs the float64
#                        plain version, of its sum of |term|: each ray's
#                        reverse cancels (the path is stationary, Fermat)
#                        and the sums cancel; the plain float32 version
#                        is ~2e-3 of it off on the mu column
INTERCEPT_F64_REL = 1e-12  # float64 on the card vs the CPU float64 generic
#                           trace: spot RMS (K1, two-pass) and moments of
#                           their scale (K2, K4)
INTERCEPT_F32_REL = 1e-4   # float32: the same, of the float64 values
HOST_OPD_ATOL = 1e-7  # waves: K8 f64 on the card vs the host OPD (numpy);
#                      K8 sums the absolute ~3.4e5-wave path before
#                      subtracting the chief ray's, the host sums per-row
#                      differences: a float64 ulp of the path is ~5e-11
#                      waves, and the CPU plain K8 is ~5e-9 waves off


def log(*args):
    print(*args, flush=True)


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false;"
                         " this script needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("== card")
    log("device: %s (count %d), torch %s, CUDA %s, python %s"
        % (name, torch.cuda.device_count(), torch.__version__,
           torch.version.cuda, sys.version.split()[0]))
    log(smi)
    return name, smi.splitlines()[0]


def phase_build():
    from rayopt_tpu_torch.ops.cuda_build import load_library
    log("== build")
    t0 = time.perf_counter()
    lib = load_library()
    log("kernel library %s: nvcc %.2f s, load %.2f s wall"
        % (lib.path.name, lib.build_seconds, time.perf_counter() - t0))
    for line in lib.ptxas_lines():
        log("  " + line)


def bench_bundle(n, dtype, seed):
    """The bench bundle: x, y uniform in +-11.6 mm, u = (0, 0, 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.empty(n, dtype=torch.float64, device=DEVICE)
    y = torch.empty_like(x)
    x.uniform_(-11.6, 11.6, generator=gen)
    y.uniform_(-11.6, 11.6, generator=gen)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return tuple(c.to(dtype).contiguous()
                 for c in (x, y, zero, zero, zero, one))


def compare_final(got, want, dtype):
    """Max abs error over rays live in both, NaN-mask mismatches, and
    the pass/fail of one K1 comparison."""
    errs, rels, bad_masks = [], [], 0
    n = got[0].shape[0]
    for i, (a, b) in enumerate(zip(got, want)):
        na, nb = torch.isnan(a), torch.isnan(b)
        bad_masks = max(bad_masks, int((na != nb).sum()))
        live = ~(na | nb)
        diff = (a[live].double() - b[live].double()).abs()
        err = float(diff.max()) if diff.numel() else 0.
        # relative to the output's magnitude, floored at 1 (mm or a unit
        # direction): an exactly-zero output (z on a flat last row) is
        # held to an absolute 1e-12
        scale = float(b[live].double().abs().max()) if diff.numel() else 1.
        errs.append(err)
        rels.append(err/max(scale, 1.))
    if dtype == torch.float64:
        ok = bad_masks == 0 and max(rels) <= F64_REL
    else:
        ok = (bad_masks <= F32_NAN_FRAC*n and max(errs[:6]) <= F32_ABS
              and rels[6] <= F32_T_REL)
    return ok, max(errs[:6]), max(rels), bad_masks


def compare_moments(got, want, dtype, n):
    """Moment sums relative to their scale, floored at 1 mm per ray as
    in compare_final (a sum of x is held to cnt*sqrt(E[x^2]))."""
    cnt_g, cnt_w = float(got[0]), float(want[0])
    sxx, syy = float(want[3]), float(want[4])
    scale = (1., max((cnt_w*sxx)**.5, cnt_w), max((cnt_w*syy)**.5, cnt_w),
             max(sxx, cnt_w), max(syy, cnt_w))
    rel = max(abs(float(g) - float(w))/max(s, 1e-300)
              for g, w, s in zip(got[1:], want[1:], scale[1:]))
    if dtype == torch.float64:
        ok = cnt_g == cnt_w and rel <= F64_REL
    else:
        ok = abs(cnt_g - cnt_w) <= F32_NAN_FRAC*n and rel <= F32_MOM_REL
    return ok, rel, cnt_g - cnt_w


def phase_check(table, specs):
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_final_reference, trace_merit,
        trace_merit_reference, spot_rms_from_moments)
    log("== kernel vs plain on the card (double Gauss, %d bench rays)"
        % N_CHECK)
    worst = {"trace_final": 0., "trace_merit": 0.}
    rms = {}
    failures = []
    for dtype in (torch.float32, torch.float64):
        state = bench_bundle(N_CHECK, dtype, SEED)
        for clip in (False, True):
            tag = "%s clip=%s" % (str(dtype)[6:], clip)
            got = trace_final(table, specs, state, clip)
            want = trace_final_reference(table, specs, state, clip)
            torch.cuda.synchronize()
            ok, err, rel, masks = compare_final((*got[0], got[1]),
                                                (*want[0], want[1]), dtype)
            log("K1 %s: max abs err %.3e, max rel err %.3e, NaN masks "
                "differ on %d rays, NaN rays %d -> %s"
                % (tag, err, rel, masks, int(torch.isnan(got[0][3]).sum()),
                   "ok" if ok else "FAIL"))
            if dtype == torch.float32:
                worst["trace_final"] = max(worst["trace_final"], err)
            if not ok:
                failures.append("K1 " + tag)
            mg = trace_merit(table, specs, state, clip)
            mw = trace_merit_reference(table, specs, state, clip)
            ok, rel, dcount = compare_moments(mg, mw, dtype, N_CHECK)
            rg = float(spot_rms_from_moments(*mg))
            rw = float(spot_rms_from_moments(*mw))
            rms[(dtype, clip)] = rg
            log("K2 %s: moments rel err %.3e, count diff %d, spot RMS "
                "kernel %.9g plain %.9g -> %s"
                % (tag, rel, dcount, rg, rw, "ok" if ok else "FAIL"))
            if dtype == torch.float32:
                worst["trace_merit"] = max(worst["trace_merit"],
                                           abs(rg - rw))
            if not ok:
                failures.append("K2 " + tag)
    for clip in (False, True):
        r32, r64 = rms[(torch.float32, clip)], rms[(torch.float64, clip)]
        rel = abs(r32 - r64)/r64
        log("K2 on axis clip=%s: float32 spot RMS %.9g vs float64 %.9g,"
            " rel %.3e" % (clip, r32, r64, rel))
        if not rel <= 1e-4:
            failures.append("K2 float32 on axis clip=%s" % clip)
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def bench_weights(n, dtype, seed):
    """Seeded ray weights uniform in [0.5, 1.5], normalized to sum 1."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    w = torch.empty(n, dtype=torch.float64, device=DEVICE)
    w.uniform_(.5, 1.5, generator=gen)
    return (w/w.sum()).to(dtype)


def rms_cotangent(mom):
    """d spot_rms / d (the five weighted moments), in mom's dtype; for
    (nlam, 5) moments d union_spot_rms / d moments."""
    from rayopt_tpu_torch.ops.cuda_grad import union_spot_rms_from_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    m = mom.detach().double().requires_grad_()
    (union_spot_rms_from_moments(m) if m.dim() == 2
     else spot_rms_from_moments(*m)).backward()
    return m.grad.to(mom.dtype).contiguous()


def compare_wmoments(got, want, dtype):
    """Weighted moments relative to their scale, as compare_moments
    with the weight sum W in place of the count."""
    wsum, sxx, syy = (float(want[i]) for i in (0, 3, 4))
    scale = (wsum, max((wsum*sxx)**.5, wsum), max((wsum*syy)**.5, wsum),
             max(sxx, wsum), max(syy, wsum))
    rel = max(abs(float(g) - float(w))/max(s, 1e-300)
              for g, w, s in zip(got, want, scale))
    return rel <= (F64_REL if dtype == torch.float64 else F32_MOM_REL), rel


# K5's parameter cotangent columns, by table field
GRAD_FIELDS = (("curvature", slice(0, 1)), ("conic", slice(1, 2)),
               ("offset", slice(2, 5)), ("mu", slice(5, 6)))


def compare_param_grads(got, want, rel):
    """{field: (max abs error, max |plain|, ok)}: each field against its
    largest plain cotangent; a field the specialization bakes out on
    every row (plain all zero) must come out exactly zero."""
    out = {}
    for name, cols in GRAD_FIELDS:
        g, w = got[:, cols].double(), want[:, cols].double()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        out[name] = (err, scale,
                     bool(torch.isfinite(g).all()) and err <= rel*scale)
    return out


def compare_ray_grads(got, got_w, want, want_w, agree=None):
    """(max relative error, rays live in one version only, all finite)
    of the ray-state and weight cotangents.  Each kind (positions,
    directions, weights) is held to its largest plain value: an
    element-wise relative test fails on analytically zero entries (the
    initial z of a collimated ray).  A dead ray's cotangents are all
    zero, so a nonzero weight cotangent marks a live ray.  `agree`
    (for cotangents summed over wavelengths): the rays whose liveness
    the two versions agree on at every wavelength; the others count as
    live in one version only."""
    live_g, live_w = got_w != 0, want_w != 0
    both = live_g & live_w
    if agree is not None:
        both = both & agree
        live_g, live_w = live_g | ~agree, live_w & agree
    rel = 0.
    if bool(both.any()):
        for g, w in ((got[:3], want[:3]), (got[3:], want[3:]),
                     ((got_w,), (want_w,))):
            scale = max(float(c[both].double().abs().max()) for c in w)
            err = max(float((a[both].double() - b[both].double())
                            .abs().max()) for a, b in zip(g, w))
            rel = max(rel, err/scale if scale else err)
    finite = all(bool(torch.isfinite(c).all()) for c in (*got, got_w))
    return rel, int((live_g != live_w).sum()), finite


def phase_grad_check(table, specs):
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments, weighted_moments_reference, merit_adjoint,
        merit_adjoint_reference)
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    log("== K4/K5 vs plain on the card (double Gauss, %d bench rays, "
        "weights uniform in [0.5, 1.5])" % N_CHECK)
    worst = {"weighted_moments": 0., "merit_adjoint": 0.}
    failures = []
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        state = bench_bundle(N_CHECK, dtype, SEED)
        w = bench_weights(N_CHECK, dtype, SEED + 2)
        for clip in (False, True):
            tag = "%s clip=%s" % (str(dtype)[6:], clip)
            mom = weighted_moments(table, specs, state, w, clip)
            mref = weighted_moments_reference(table, specs, state, w, clip)
            ok, rel = compare_wmoments(mom, mref, dtype)
            rg = float(spot_rms_from_moments(*mom))
            rw = float(spot_rms_from_moments(*mref))
            ok = ok and abs(rg - rw) <= (1e-10 if f64 else 1e-4)*rw
            log("K4 %s: moments rel err %.3e, spot RMS kernel %.12g plain "
                "%.12g (rel %.2e) -> %s" % (tag, rel, rg, rw,
                                           abs(rg - rw)/rw,
                                           "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K4 " + tag)
            ct = rms_cotangent(mref)
            pg, cst, cw = merit_adjoint(table, specs, state, w, ct, clip)
            pr, sr, wr = merit_adjoint_reference(table, specs, state, w, ct,
                                                 clip)
            torch.cuda.synchronize()
            lim = GRAD_F64_REL if f64 else GRAD_F32_REL
            fields = compare_param_grads(pg, pr, lim)
            ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr)
            ok = (all(v[2] for v in fields.values()) and finite
                  and ray_rel <= (GRAD_F64_REL if f64 else F32_RAY_REL)
                  and masks <= (0 if f64 else F32_NAN_FRAC*N_CHECK))
            log("K5 %s: %s | rays and weights rel err %.3e, live masks "
                "differ on %d rays, dead rays %d, all finite %s -> %s"
                % (tag, "; ".join("%s err %.3e of max %.3e" % (k, *v[:2])
                                  for k, v in fields.items()),
                   ray_rel, masks, int((wr == 0).sum()), finite,
                   "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K5 " + tag)
            if not f64:
                worst["weighted_moments"] = max(worst["weighted_moments"],
                                                abs(rg - rw))
                worst["merit_adjoint"] = max(
                    worst["merit_adjoint"], *(v[0] for v in fields.values()))
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def spec_keys(specs, extra=()):
    """{tag: key} of the K4/K5 specializations this script runs: K4 and
    K5 on `specs` in float32 and float64, clip off and on, K5 for the
    optimizer's slot set and for all fields, with and without the ray
    cotangents; K4 on each spec tuple of `extra` (the intercept cases)
    unclipped."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    keys = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        for clip in (False, True):
            keys["K4 %s clip=%s" % (dt, clip)] = CS.moments_key(specs, dtype,
                                                                clip)
            for fields in (OPT_FIELDS, CS.FIELDS):
                for rays in (False, True):
                    keys["K5 %s clip=%s %s rays=%s" % (
                        dt, clip, "optimizer" if fields == OPT_FIELDS
                        else "all", rays)] = CS.adjoint_key(
                            specs, dtype, clip, fields, rays)
        for name, sp in extra:
            keys["K4 %s %s" % (dt, name)] = CS.moments_key(sp, dtype)
    return keys


def ptxas_stats(kern):
    """(registers, stack frame bytes, spill store + load bytes) of a
    one-kernel specialized library's -Xptxas -v report."""
    import re
    text = kern.build_log
    regs = re.search(r"Used (\d+) registers", text)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", text)
    if not (regs and frame):
        raise AssertionError("no ptxas report for %s" % kern.key.name)
    return (int(regs.group(1)), int(frame.group(1)),
            int(frame.group(2)) + int(frame.group(3)))


def phase_spec_build(keys):
    """Build every K4/K5 specialization at once (one nvcc a key, in
    parallel); log each key's build seconds and ptxas lines.  K5 for
    the optimizer's slot set must have no stack frame and no spill.
    Returns {tag: (registers, stack bytes, spill bytes)}."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    log("== K4/K5 specialized per spec tuple: %d keys" % len(keys))
    t0 = time.perf_counter()
    built = CS.prebuild(list(keys.values()))
    log("built in %.2f s wall" % (time.perf_counter() - t0))
    stats, failures = {}, []
    for tag, key in keys.items():
        kern = built[key]
        stats[tag] = ptxas_stats(kern)
        log("%s: %s, %d live slots, block %d, nvcc %.2f s | %s" % (
            tag, key.name, key.nlive, key.block, kern.build_seconds,
            " | ".join(ln for ln in kern.ptxas_lines()
                       if "Compiling" not in ln and "properties" not in ln)))
        if "optimizer rays=False" in tag and stats[tag][1:] != (0, 0):
            failures.append(tag)
    if failures:
        raise AssertionError("K5 for the optimizer's slot set has a stack "
                             "frame or spills: %s" % failures)
    return stats


def phase_spec_check(table, specs):
    """The specialized K5 against its plain version for the slot sets
    and ray-cotangent flags that phase_grad_check (all fields, with the
    ray cotangents) does not cover: the optimizer's slot set with and
    without the ray cotangents, all fields without; non-live slots must
    be exact zeros."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_reference, weighted_moments_reference)
    log("== specialized K5 slot sets vs plain on the card (double Gauss, "
        "%d bench rays)" % N_CHECK)
    failures = []
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        state = bench_bundle(N_CHECK, dtype, SEED)
        w = bench_weights(N_CHECK, dtype, SEED + 2)
        for clip in (False, True):
            ct = rms_cotangent(weighted_moments_reference(table, specs,
                                                          state, w, clip))
            pr, sr, wr = merit_adjoint_reference(table, specs, state, w, ct,
                                                 clip)
            for fields, rays in ((OPT_FIELDS, False), (OPT_FIELDS, True),
                                 (CS.FIELDS, False)):
                tag = "%s clip=%s %s rays=%s" % (
                    str(dtype)[6:], clip,
                    "optimizer" if fields == OPT_FIELDS else "all", rays)
                live = CS.live_mask(CS.live_slots(specs, fields)).to(DEVICE)
                pg, cst, cw = merit_adjoint(table, specs, state, w, ct, clip,
                                            fields=fields, rays=rays)
                torch.cuda.synchronize()
                lim = GRAD_F64_REL if f64 else GRAD_F32_REL
                cols = compare_param_grads(pg, torch.where(live, pr, 0.), lim)
                dead_zero = not bool(pg[~live].any())
                ok = all(v[2] for v in cols.values()) and dead_zero
                detail = ""
                if rays:
                    ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr)
                    ok = ok and finite and ray_rel <= (
                        GRAD_F64_REL if f64 else F32_RAY_REL) and masks <= (
                        0 if f64 else F32_NAN_FRAC*N_CHECK)
                    detail = " | rays and weights rel err %.3e, live masks " \
                        "differ on %d rays" % (ray_rel, masks)
                else:
                    ok = ok and cst is None and cw is None
                log("K5 %s: %d live slots, the rest exact zeros %s | %s%s -> "
                    "%s" % (tag, int(live.sum()), dead_zero, "; ".join(
                        "%s err %.3e of max %.3e" % (k, *v[:2])
                        for k, v in cols.items()), detail,
                        "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K5 " + tag)
    if failures:
        raise AssertionError("specialized K5 disagrees with its plain "
                             "version: " + ", ".join(failures))


def near_flat(table, c=1e-12):
    """The table with every flat traced row's curvature set to c."""
    cur = table.curvature.clone()
    flat = cur == 0
    flat[0] = False
    cur[flat] = c
    return table.replace(curvature=cur)


def intercept_cases():
    """(name, system, table on the card, fields): the f/2 paraboloid at
    half and full field, and the double Gauss with its flat rows at
    c = 1e-12 at fields 0, 0.7, 1 -- where the JAX package's specialized
    intercept -(d + g)/e cancels."""
    from rayopt_tpu_torch.models import double_gauss, parabolic_mirror
    para, dg = parabolic_mirror(), double_gauss()
    return (("paraboloid", para, para.table(), (.5, 1.)),
            ("near-flat double Gauss", dg, near_flat(dg.table()), FIELDS))


def phase_intercept():
    """The repaired specialized intercept on the card: float32 and
    float64 K1, K2 and K4 on the intercept cases' aimed bundles against
    the CPU float64 GENERIC trace (kernels.intercept_conic, no specs).
    K1 is held by its two-pass spot RMS, K2 and K4 by their moments of
    their scale; the moment spot RMS is reported."""
    from rayopt_tpu_torch.ops.cuda_grad import _wmoments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import (
        _moments, spot_rms_from_moments, trace_final, trace_merit)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    from rayopt_tpu_torch.ops.kernels import specialize
    log("== repaired intercept on the card: %d aimed rays a field against "
        "the CPU float64 generic trace" % N_INTERCEPT)
    rng = np.random.RandomState(SEED + 7)
    failures = []
    for name, s, table, fields in intercept_cases():
        specs = specialize(table)
        table_cpu = table.to(device="cpu")
        for field in fields:
            z, p = s.pupil((0., field))
            r = np.sqrt(rng.uniform(0, 1, N_INTERCEPT))
            th = rng.uniform(0, 2*np.pi, N_INTERCEPT)
            yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
            y0, u0 = s.aim((0., field), yp, z, p, filter=False)
            w64 = torch.from_numpy(rng.uniform(.5, 1.5, N_INTERCEPT))
            yh, uh, _ = trace_rays_final(table_cpu, torch.from_numpy(y0),
                                         torch.from_numpy(u0))
            ref_rms, ref_live = spot_rms(yh, uh)
            live = (torch.isfinite(yh[:, 0]) & torch.isfinite(yh[:, 1])
                    & torch.isfinite(uh[:, 2]))
            ref_mom = torch.stack(_moments(yh[:, 0], yh[:, 1], uh[:, 2]))
            ref_wmom = _wmoments(yh[:, 0], yh[:, 1], w64, live)
            parts = []
            for dtype in (torch.float32, torch.float64):
                f64 = dtype == torch.float64
                lim = INTERCEPT_F64_REL if f64 else INTERCEPT_F32_REL
                state = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(
                    DEVICE, dtype) for c in (*y0.T, *u0.T))
                w = w64.to(DEVICE, dtype)
                out, _ = trace_final(table, specs, state)
                rms1, live1 = spot_rms(torch.stack(out[:3], 1),
                                       torch.stack(out[3:], 1))
                rel1 = abs(rms1 - ref_rms)/ref_rms
                mom = torch.stack(trace_merit(table, specs, state))
                ok2, rel2m, _ = compare_moments(mom.double().cpu(), ref_mom,
                                                dtype, N_INTERCEPT)
                wmom = weighted_moments(table, specs, state, w)
                ok4, rel4m = compare_wmoments(wmom.double().cpu(), ref_wmom,
                                              dtype)
                rel2 = abs(float(spot_rms_from_moments(*mom.double()))
                           - ref_rms)/ref_rms
                ref4 = float(spot_rms_from_moments(*ref_wmom))
                rel4 = abs(float(spot_rms_from_moments(*wmom.double()))
                           - ref4)/ref4
                ok1 = rel1 <= lim and (live1 == ref_live or not f64)
                parts.append("%s: K1 spot RMS rel %.3e (%s), K2 moments rel "
                             "%.3e (%s; spot RMS rel %.3e), K4 moments rel "
                             "%.3e (%s; spot RMS rel %.3e)" % (
                                 str(dtype)[6:], rel1, "ok" if ok1 else
                                 "FAIL", rel2m, "ok" if ok2 else "FAIL", rel2,
                                 rel4m, "ok" if ok4 else "FAIL", rel4))
                failures += ["%s field %.1f %s %s" % (name, field, k,
                                                      str(dtype)[6:])
                             for k, ok in (("K1", ok1), ("K2", ok2),
                                           ("K4", ok4)) if not ok]
            log("%s, field %.1f: %d of %d rays live, CPU f64 generic spot "
                "RMS %.12g mm | %s" % (name, field, ref_live, N_INTERCEPT,
                                       ref_rms, " | ".join(parts)))
    if failures:
        raise AssertionError("repaired intercept misses the CPU generic "
                             "trace: " + ", ".join(failures))


def phase_fd_check(table, specs):
    """K5's float64 gradient against central differences of the K4
    merit, for the two curvatures and the distance (offset z) with the
    largest gradients."""
    from rayopt_tpu_torch.ops.cuda_grad import spot_moments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    log("== K5 vs central differences of the K4 merit (float64, %d bench "
        "rays, no clip; steps %s)" % (N_CHECK, FD_STEP))
    state = bench_bundle(N_CHECK, torch.float64, SEED)
    w = bench_weights(N_CHECK, torch.float64, SEED + 2)
    c = table.curvature.clone().requires_grad_()
    off = table.offset.clone().requires_grad_()
    with warnings.catch_warnings():
        # the flat rows' curvature and the transverse offsets are baked
        # out by the specs, as intended
        warnings.simplefilter("ignore")
        mom = spot_moments(table.replace(curvature=c, offset=off), state,
                           w, specs=specs)
    spot_rms_from_moments(*mom).backward()
    grads = {"curvature": c.grad.cpu(), "distance": off.grad[:, 2].cpu()}
    picks = [("curvature", int(j))
             for j in torch.argsort(-grads["curvature"].abs())[:2]]
    picks.append(("distance", int(torch.argmax(grads["distance"].abs()))))

    def merit(tab):
        return float(spot_rms_from_moments(*weighted_moments(tab, specs,
                                                             state, w)))
    failures = []
    for field, j in picks:
        h = FD_STEP[field]
        side = []
        for sgn in (1., -1.):
            if field == "curvature":
                v = table.curvature.clone()
                v[j] += sgn*h
                side.append(merit(table.replace(curvature=v)))
            else:
                v = table.offset.clone()
                v[j, 2] += sgn*h
                side.append(merit(table.replace(offset=v)))
        fd = (side[0] - side[1])/(2*h)
        g = float(grads[field][j])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s of row %d: K5 %.12g, central difference %.12g, rel %.2e "
            "-> %s" % (field, j, g, fd, rel, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s row %d" % (field, j))
    if failures:
        raise AssertionError("K5 disagrees with finite differences: "
                             + ", ".join(failures))


def spot_rms(y, u):
    """Centroid spot RMS (float64, two-pass) of the rays whose x, y
    and uz are finite."""
    good = (torch.isfinite(y[:, 0]) & torch.isfinite(y[:, 1])
            & torch.isfinite(u[:, 2]))
    pts = y[good, :2].double()
    return float(((pts - pts.mean(0))**2).sum(1).mean().sqrt()), int(
        good.sum())


def phase_main_path():
    """The port's main path, through the entry points a user calls.
    Returns the aimed bundles (on the card), their float64 K1 image
    positions and their CPU float64 spot RMS, for the df32 path."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    from rayopt_tpu_torch.ops.cuda_trace import (trace_merit,
                                                 spot_rms_from_moments)
    # unclipped, as GeometricTrace.rays_point traces by default: the
    # double Gauss's full-field image (24.5 mm) overfills its last
    # row's 24 mm aperture, so a clipped full-field bundle is all NaN
    log("== main path: double Gauss, %d aimed rays per field, no clip"
        % N_AIMED)
    t0 = time.perf_counter()
    s = double_gauss()
    table = s.table()                    # the default device: the card
    table_cpu = s.table(device="cpu")    # the CPU reference
    specs = specialize(table)
    log("System: EFL %.8f, %d surfaces, %.2f s"
        % (s.paraxial.focal_length[1], len(s), time.perf_counter() - t0))
    rng = np.random.RandomState(SEED)
    failures, aimed = [], []
    for field in FIELDS:
        t0 = time.perf_counter()
        z, p = s.pupil((0., field))
        r = np.sqrt(rng.uniform(0, 1, N_AIMED))
        th = rng.uniform(0, 2*np.pi, N_AIMED)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., field), yp, z, p, filter=False)
        t_aim = time.perf_counter() - t0
        yc = torch.from_numpy(y0).to(DEVICE)
        uc = torch.from_numpy(u0).to(DEVICE)
        t0 = time.perf_counter()
        y64, u64, _ = trace_rays_final_fast(table, yc, uc, clip=False,
                                            specs=specs,
                                            precision="parity")
        rms_k1, live = spot_rms(y64, u64)
        state64 = tuple(c.contiguous() for c in (*yc.T, *uc.T))
        mom64 = trace_merit(table, specs, state64, clip=False)
        rms_k2 = float(spot_rms_from_moments(*mom64))
        y32, u32, _ = trace_rays_final_fast(table, yc.float(), uc.float(),
                                            clip=False, specs=specs)
        rms_k1_32, _ = spot_rms(y32, u32)
        state32 = tuple(c.float() for c in state64)
        rms_k2_32 = float(spot_rms_from_moments(
            *trace_merit(table, specs, state32, clip=False)))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu, torch.from_numpy(y0),
                                          torch.from_numpy(u0), clip=False)
        rms_cpu, live_cpu = spot_rms(yh, uh)
        mom_cpu = trace_merit(table_cpu, specs,
                              tuple(c.cpu() for c in state64), clip=False)
        t_cpu = time.perf_counter() - t0
        rel1 = abs(rms_k1 - rms_cpu)/rms_cpu
        mom_ok, mom_rel, _ = compare_moments(mom64, mom_cpu, torch.float64,
                                             N_AIMED)
        ok = (np.isfinite(rms_k1) and live == live_cpu
              and rel1 <= PARITY_REL and mom_ok)
        log("field %.1f: pupil z %.6f, %d of %d rays live | spot RMS mm: "
            "CPU f64 %.12g | K1 f64 %.12g (rel %.2e) | K2 f64 %.12g (rel "
            "%.2e; moments vs CPU rel %.2e) | K1 f32 %.9g (rel %.2e) | K2 "
            "f32 %.9g (rel %.2e) | aim %.2f s, card %.2f s, CPU %.2f s -> %s"
            % (field, z, live, N_AIMED, rms_cpu, rms_k1, rel1, rms_k2,
               abs(rms_k2 - rms_cpu)/rms_cpu, mom_rel, rms_k1_32,
               abs(rms_k1_32 - rms_cpu)/rms_cpu, rms_k2_32,
               abs(rms_k2_32 - rms_cpu)/rms_cpu, t_aim, t_gpu, t_cpu,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("field %.1f" % field)
        aimed.append(dict(field=field, y=yc, u=uc, y64=y64,
                          rms_cpu=rms_cpu, live_cpu=live_cpu))
    if failures:
        raise AssertionError("main path parity failed at " +
                             ", ".join(failures))
    return aimed


def phase_opt_path():
    """The designer loop, through the entry points a user calls."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.parallel import (
        bundles_from_system, bundles_to, optimize_grad, write_back_table)
    log("== optimizer path: double Gauss, bundles_from_system (hexapolar, "
        "nrays %d) -> optimize_grad(engine='adjoint', select=%s), float64, "
        "%d Adam steps at lr %g" % (N_OPT, OPT_SELECT, OPT_STEPS, OPT_LR))
    t0 = time.perf_counter()
    s = double_gauss()
    efl0 = float(s.paraxial.focal_length[1])
    bundles = bundles_from_system(s, nrays=N_OPT, distribution="hexapolar")
    log("%d bundles (%d fields x %d wavelengths) of %d rays, %d rays in "
        "all, aimed in %.2f s" % (len(bundles), len(s.fields),
                                 len(s.wavelengths), bundles[0][0].shape[0],
                                 sum(b[0].shape[0] for b in bundles),
                                 time.perf_counter() - t0))
    table = s.table()        # the bundles and the table: the default device
    grads, ends = {}, []

    def keep(tag):
        def callback(i, value, params):
            ends.append(time.perf_counter())   # value synced the step
            if i == 0:
                grads[tag] = {k: v.grad.detach().double().cpu().clone()
                              for k, v in params.items()}
        return callback
    reset_launches()
    t0 = time.perf_counter()
    tab_opt, hist = optimize_grad(table, bundles, select=OPT_SELECT,
                                  steps=OPT_STEPS, lr=OPT_LR,
                                  engine="adjoint", callback=keep("card"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    steps = np.diff([t0] + ends[:OPT_STEPS])
    launches = read_launches()
    t0 = time.perf_counter()
    _, hist_cpu = optimize_grad(s.table(device="cpu"),
                                bundles_to(bundles, "cpu"),
                                select=OPT_SELECT, steps=1, lr=OPT_LR,
                                engine="adjoint", callback=keep("cpu"))
    t_cpu = time.perf_counter() - t0
    merit_rel = abs(hist[0] - hist_cpu[0])/abs(hist_cpu[0])
    grad_rel = {k: float((grads["card"][k] - grads["cpu"][k]).abs().max()
                         / grads["cpu"][k].abs().max())
                for k in OPT_SELECT}
    write_back_table(s, tab_opt, OPT_SELECT)
    efl1 = float(s.paraxial.focal_length[1])
    log("merit history (sum of %d spot RMS, mm): %s"
        % (len(bundles), " ".join("%.12g" % v for v in hist)))
    log("step 0 card vs CPU plain: merit %.15g vs %.15g (rel %.2e), "
        "gradient rel to its max %s | card %.2f s for %d steps (step 0 "
        "%.3f s, later steps mean %.4f s), CPU %.2f s for 1 step"
        % (hist[0], hist_cpu[0], merit_rel,
           {k: "%.2e" % v for k, v in grad_rel.items()}, t_card, OPT_STEPS,
           steps[0], steps[1:].mean(), t_cpu))
    log("write_back_table: EFL %.8f -> %.8f mm" % (efl0, efl1))
    log("== launch counts on the optimizer path: %s" % launches)
    failures = []
    if not hist[-1] < hist[0]:
        failures.append("the merit did not fall")
    if not merit_rel <= OPT_MERIT_REL:
        failures.append("step 0 merit")
    failures += ["step 0 gradient of " + k for k, v in grad_rel.items()
                 if not v <= OPT_GRAD_REL]
    if not np.isfinite(efl1):
        failures.append("EFL after write-back")
    if not (launches["weighted_moments"] and launches["merit_adjoint"]):
        failures.append("K4 or K5 never launched: %s" % launches)
    if failures:
        raise AssertionError("optimizer path failed: " + ", ".join(failures))
    return launches


def _live_of(out):
    """The rays whose final x, y and uz are finite."""
    return (torch.isfinite(out[0]) & torch.isfinite(out[1])
            & torch.isfinite(out[5]))


def phase_multi_check(tabs, specs):
    """K3, K6 and K7 against their plain versions on the card."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments_multi, weighted_moments_multi_reference,
        merit_adjoint_multi, merit_adjoint_multi_reference,
        union_spot_rms_from_moments)
    from rayopt_tpu_torch.ops.cuda_trace import (
        spot_rms_from_moments, trace_final, trace_final_reference,
        trace_multi, trace_multi_reference)
    from rayopt_tpu_torch.ops.tables import table_at
    nlam = tabs.curvature.shape[0]
    log("== K3/K6/K7 vs plain on the card (double Gauss, %d wavelengths, "
        "%d bench rays, weights uniform in [0.5, 1.5])" % (nlam, N_CHECK))
    worst = {"trace_multi": 0., "weighted_moments_multi": 0.,
             "merit_adjoint_multi": 0.}
    failures = []
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        dt = str(dtype)[6:]
        state = bench_bundle(N_CHECK, dtype, SEED)
        w = bench_weights(N_CHECK, dtype, SEED + 2)
        got = trace_multi(tabs, specs, state)
        want = trace_multi_reference(tabs, specs, state)
        mom = trace_multi(tabs, specs, state, merit=True)
        mref = trace_multi_reference(tabs, specs, state, merit=True)
        torch.cuda.synchronize()
        for li in range(nlam):
            ok, err, rel, masks = compare_final((*got[li][0], got[li][1]),
                                                (*want[li][0], want[li][1]),
                                                dtype)
            ok = ok and masks == 0
            mok, mrel, dcount = compare_moments(mom[li], mref[li], dtype,
                                                N_CHECK)
            log("K3 %s wavelength %d: trace max abs err %.3e, max rel err "
                "%.3e, NaN masks differ on %d rays; moments rel err %.3e, "
                "count diff %d, spot RMS kernel %.12g plain %.12g -> %s"
                % (dt, li, err, rel, masks, mrel, dcount,
                   float(spot_rms_from_moments(*mom[li])),
                   float(spot_rms_from_moments(*mref[li])),
                   "ok" if ok and mok else "FAIL"))
            if not (ok and mok):
                failures.append("K3 %s wavelength %d" % (dt, li))
            if not f64:
                worst["trace_multi"] = max(worst["trace_multi"], err)
        for clip in (False, True):
            tag = "%s clip=%s" % (dt, clip)
            if clip:
                # widen the bundle 1.5x so that the apertures vignette
                state = tuple(c*1.5 if i < 2 else c
                              for i, c in enumerate(state))
            mom = weighted_moments_multi(tabs, specs, state, w, clip)
            mref = weighted_moments_multi_reference(tabs, specs, state, w,
                                                    clip)
            rels = [compare_wmoments(mom[li], mref[li], dtype)
                    for li in range(nlam)]
            ug = float(union_spot_rms_from_moments(mom))
            uw = float(union_spot_rms_from_moments(mref))
            ok = (all(r[0] for r in rels)
                  and abs(ug - uw) <= (1e-10 if f64 else 1e-4)*uw)
            log("K6 %s: moments rel err %s, union spot RMS kernel %.12g "
                "plain %.12g (rel %.2e) -> %s"
                % (tag, " ".join("%.3e" % r[1] for r in rels), ug, uw,
                   abs(ug - uw)/uw, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K6 " + tag)
            ct = rms_cotangent(mref)
            pg, cst, cw = merit_adjoint_multi(tabs, specs, state, w, ct, clip)
            pr, sr, wr = merit_adjoint_multi_reference(tabs, specs, state, w,
                                                       ct, clip)
            torch.cuda.synchronize()
            lim = GRAD_F64_REL if f64 else GRAD_F32_REL
            per_lam = [compare_param_grads(pg[li], pr[li], lim)
                       for li in range(nlam)]
            # a float32 ray at an aperture's edge may be clipped at one
            # wavelength by one version only: its summed cotangents then
            # differ by that wavelength's term (K1 and the plain trace
            # judge each wavelength as K7 and its plain version do)
            agree = torch.ones_like(cw, dtype=torch.bool)
            for li in range(nlam):
                one = table_at(tabs, li)
                agree &= (_live_of(trace_final(one, specs, state, clip)[0])
                          == _live_of(trace_final_reference(one, specs, state,
                                                            clip)[0]))
            ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr,
                                                       agree)
            live = weighted_moments_multi_reference(
                tabs, specs, state, torch.ones_like(w), clip)[:, 0]
            dead = [N_CHECK - int(v) for v in live.tolist()]
            ok = (all(v[2] for f in per_lam for v in f.values()) and finite
                  and bool(torch.isfinite(pg).all()) and not pg[:, 0].any()
                  and ray_rel <= (GRAD_F64_REL if f64 else F32_RAY_REL)
                  and masks <= (0 if f64 else F32_NAN_FRAC*N_CHECK)
                  and (sum(dead) > 0) == clip)
            log("K7 %s: %s | rays and weights rel err %.3e, live masks "
                "differ on %d rays, dead rays per wavelength %s, all finite "
                "%s -> %s"
                % (tag, " | ".join(
                    "wavelength %d: %s" % (li, "; ".join(
                        "%s err %.3e of max %.3e" % (k, *v[:2])
                        for k, v in f.items()))
                    for li, f in enumerate(per_lam)),
                   ray_rel, masks, dead, finite, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K7 " + tag)
            if not f64:
                worst["weighted_moments_multi"] = max(
                    worst["weighted_moments_multi"], abs(ug - uw))
                worst["merit_adjoint_multi"] = max(
                    worst["merit_adjoint_multi"],
                    *(v[0] for f in per_lam for v in f.values()))
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def phase_glass_fd_check(s, tabs, specs):
    """K7's float64 gradient w.r.t. one glass slot's vd, through
    glass_tables' Abbe model, against central differences of the K6
    merit."""
    from rayopt_tpu_torch import glass
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    log("== K7 vs central differences of the K6 merit w.r.t. vd (float64, "
        "%d bench rays, no clip; step %g)" % (N_CHECK, FD_VD_STEP))
    state = bench_bundle(N_CHECK, torch.float64, SEED)
    w = bench_weights(N_CHECK, torch.float64, SEED + 2)
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    nd = torch.tensor(nd0, device=DEVICE)

    def merit(vd):
        return glass.polychromatic_spot_rms(
            glass.glass_tables(tabs, nd, vd, asg, s.wavelengths), y0, u0, w,
            specs=specs, engine="adjoint")
    vd = torch.tensor(vd0, device=DEVICE, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # mu of air/air rows: baked out
        merit(vd).backward()
    g = vd.grad.cpu()
    j = int(torch.argmax(g.abs()))
    side = []
    with torch.no_grad():
        for sgn in (1., -1.):
            v = torch.tensor(vd0, device=DEVICE)
            v[j] += sgn*FD_VD_STEP
            side.append(float(merit(v)))
    fd = (side[0] - side[1])/(2*FD_VD_STEP)
    rel = abs(float(g[j]) - fd)/abs(fd)
    log("vd of slot %d (element %d, vd %.4f): K7 %.12g, central difference "
        "%.12g, rel %.2e -> %s" % (j, asg[2][j], vd0[j], float(g[j]), fd, rel,
                                   "ok" if rel <= FD_REL else "FAIL"))
    if not rel <= FD_REL:
        raise AssertionError("K7 disagrees with finite differences of vd")


def phase_glass_path():
    """The achromatization path, through the entry points a user calls:
    stacked tables, glass relaxation, the polychromatic adjoint merit at
    three fields and torch.optim.Adam, with K3 reporting the spots."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import union_spot_rms_from_moments
    from rayopt_tpu_torch.ops.cuda_trace import (
        multi_specs, spot_rms_from_moments, trace_multi)
    from rayopt_tpu_torch.parallel import bundles_from_system, bundles_to
    log("== achromatization path: double Gauss, System.tables -> "
        "glass_assignment -> glass_tables(glass_box_decode(logits)) -> "
        "glass.polychromatic_spot_rms(engine='adjoint') at fields %s, "
        "float64, %d Adam steps, lr %s" % (FIELDS, GLASS_STEPS, GLASS_LR))
    t0 = time.perf_counter()
    s = double_gauss()
    tabs = s.tables()            # the default device: the card
    nlam = tabs.curvature.shape[0]
    specs = multi_specs(tabs, None)
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    log("%d wavelengths %s; %d glass slots owned by elements %s: nd %s, "
        "vd %s" % (nlam, s.wavelengths, len(asg[2]), asg[2],
                   np.round(nd0, 6).tolist(), np.round(vd0, 4).tolist()))
    if len(asg[2]) != 6:
        raise AssertionError("expected 6 glass slots, got %s" % (asg[2],))
    bundles = bundles_from_system(s, fields=FIELDS,
                                  wavelengths=[s.wavelengths[0]],
                                  nrays=N_GLASS, distribution="hexapolar")
    log("bundles: distribution hexapolar, nrays %d -> %s rays at fields %s,"
        " aimed at %g m in %.2f s" % (N_GLASS, [b[0].shape[0] for b in
                                                  bundles], FIELDS,
                                      s.wavelengths[0],
                                      time.perf_counter() - t0))
    # distance is optimized, the trace reads offset = unit * distance
    # (as parallel.grad.optimize_grad ties them)
    off0 = tabs.offset[0].detach().cpu().double().numpy()
    d0 = tabs.distance[0].detach().cpu().double().numpy()
    unit = torch.from_numpy(np.divide(
        off0, d0[:, None], where=d0[:, None] != 0,
        out=np.tile(np.array([0., 0., 1.]), (off0.shape[0], 1))))
    xi_nd0, xi_vd0 = glass.glass_box_encode(nd0, vd0)

    def start(device):
        return {"curvature": tabs.curvature[0].detach().to(device).clone(),
                "distance": torch.from_numpy(d0).to(device).clone(),
                "xi_nd": torch.from_numpy(xi_nd0).to(device).clone(),
                "xi_vd": torch.from_numpy(xi_vd0).to(device).clone()}

    def relaxed(params, tables):
        u = unit.to(params["distance"].device)
        tb = tables.replace(
            curvature=params["curvature"].expand(nlam, -1),
            offset=(u*params["distance"][:, None]).expand(nlam, -1, -1))
        nd, vd = glass.glass_box_decode(params["xi_nd"], params["xi_vd"])
        return glass.glass_tables(tb, nd, vd, asg, s.wavelengths)

    def merit(params, tables, bundles):
        tb = relaxed(params, tables)
        return sum(glass.polychromatic_spot_rms(tb, y0, u0, w, specs=specs,
                                                engine="adjoint")
                   for y0, u0, w, _ in bundles)

    def report(params, when):
        with torch.no_grad():
            tb = relaxed(params, tabs)
            for field, (y0, u0, _, _) in zip(FIELDS, bundles):
                state = tuple(c.contiguous() for c in (*y0.T, *u0.T))
                mom = trace_multi(tb, specs, state, merit=True)
                per = [float(spot_rms_from_moments(*m)) for m in mom]
                union = float(union_spot_rms_from_moments(
                    torch.stack([torch.stack(m) for m in mom])))
                log("K3 %s, field %.1f: spot RMS mm per wavelength %s, union "
                    "%.9g, live rays %s" % (when, field, " ".join(
                        "%.9g" % v for v in per), union,
                        [int(m[0]) for m in mom]))
            nd, vd = glass.glass_box_decode(params["xi_nd"],
                                            params["xi_vd"])
            log("relaxed glasses %s: nd %s, vd %s"
                % (when, np.round(nd.cpu().numpy(), 6).tolist(),
                   np.round(vd.cpu().numpy(), 4).tolist()))

    params = {k: v.requires_grad_() for k, v in start(DEVICE).items()}
    report(params, "before")
    opt = torch.optim.Adam([
        {"params": [params["curvature"]], "lr": GLASS_LR["curvature"]},
        {"params": [params["distance"]], "lr": GLASS_LR["distance"]},
        {"params": [params["xi_nd"], params["xi_vd"]],
         "lr": GLASS_LR["glass"]}])
    hist, grads0, ends = [], None, []
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # flat rows bake out their curvature, air/air rows their mu
        warnings.simplefilter("ignore")
        for i in range(GLASS_STEPS):
            opt.zero_grad()
            value = merit(params, tabs, bundles)
            value.backward()
            if i == 0:
                grads0 = {k: v.grad.detach().cpu().clone()
                          for k, v in params.items()}
            opt.step()
            hist.append(float(value.detach()))
            ends.append(time.perf_counter())
        steps = np.diff([t0] + ends)
        t0 = time.perf_counter()
        cpu = {k: v.requires_grad_() for k, v in start("cpu").items()}
        value = merit(cpu, s.tables(device="cpu"), bundles_to(bundles, "cpu"))
        value.backward()
        value = float(value.detach())
        t_cpu = time.perf_counter() - t0
    report(params, "after")
    merit_rel = abs(hist[0] - value)/abs(value)
    grad_rel = {k: float((grads0[k] - v.grad).abs().max()
                         / v.grad.abs().max()) for k, v in cpu.items()}
    log("merit history (sum of %d union spot RMS, mm): %s"
        % (len(bundles), " ".join("%.12g" % v for v in hist)))
    log("step 0 card vs CPU plain: merit %.15g vs %.15g (rel %.2e), "
        "gradient rel to its max %s | card: step 0 %.3f s, later steps mean "
        "%.4f s | CPU %.2f s for 1 merit and gradient"
        % (hist[0], value, merit_rel,
           {k: "%.2e" % v for k, v in grad_rel.items()}, steps[0],
           steps[1:].mean(), t_cpu))
    failures = []
    if not hist[-1] < hist[0]:
        failures.append("the merit did not fall")
    if not merit_rel <= OPT_MERIT_REL:
        failures.append("step 0 merit")
    failures += ["step 0 gradient of " + k for k, v in grad_rel.items()
                 if not v <= OPT_GRAD_REL]
    if failures:
        raise AssertionError("achromatization path failed: "
                             + ", ".join(failures))


def opd_aux(s, table, specs, state):
    """K8's aux vector for a bundle whose ray 0 is the chief ray: its
    image point (the plain one-ray trace), the exit pupil's reference-
    sphere radius and the first wavelength's scale, on the card."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
    yr, _, _ = trace_rays_final(table, y0, u0, specs=specs)
    return torch.cat([yr[0], torch.tensor(
        [-s.image.pupil.distance, s.wavelengths[0]/s.scale],
        dtype=torch.float64, device=DEVICE)]).to(state[0].dtype)


def opd_bundle(n, dtype, seed, widen=1.):
    """The bench bundle with ray 0 on axis (the chief ray); `widen`
    scales the footprint."""
    state = [c.clone() for c in bench_bundle(n, torch.float64, seed)]
    for i in range(6):
        if i < 2:
            state[i] = state[i]*widen
        state[i][0] = 1. if i == 5 else 0.
    return tuple(c.to(dtype).contiguous() for c in state)


def opd_cotangents(k, lx, ly, kind):
    """(ct_k, ct_lx, ct_ly) in k's dtype of the wavefront RMS
    (kind "wavefront": only k) or the tilt-removed Strehl ratio ("strehl":
    k and the landing) of K8's outputs, ray 0 the reference; computed in
    float64 by autograd.  The bench bundle's input-plane term is zero
    (u0[0] = (0, 0, 1), z0 = 0)."""
    from rayopt_tpu_torch.ops.cuda_grad import wavefront_rms_of
    from rayopt_tpu_torch.parallel.diffraction import strehl_of_samples
    leaves = [v.detach().double().requires_grad_() for v in (k, lx, ly)]
    k64, lx64, ly64 = leaves
    waves = k64 - k64[0]
    if kind == "wavefront":
        wavefront_rms_of(waves).backward()
        leaves[1].grad = torch.zeros_like(k64)
        leaves[2].grad = torch.zeros_like(k64)
    else:
        xy = torch.stack([lx64 - lx64[0], ly64 - ly64[0]], 1)
        good = torch.isfinite(waves) & torch.isfinite(xy).all(1)
        wg = torch.where(good, 1., 0.)
        strehl_of_samples(torch.where(good, waves, 0.),
                          torch.where(good[:, None], xy, 0.),
                          wg/wg.sum()).backward()
    return tuple(v.grad.to(k.dtype).contiguous() for v in leaves)


# K9's parameter cotangent columns, by table field
OPD_GRAD_FIELDS = GRAD_FIELDS + (("n_before", slice(6, 7)),)


def phase_opd_check(s, table, specs):
    """K8 and K9 against their plain versions on the card: K8's k and
    landing; K9's parameter (n_before included), ray and centre
    cotangents for the wavefront-RMS and the Strehl cotangents.  In
    float64 against the plain version; in float32 K8 against the plain
    float32 version, K9's sums against the float64 plain version on the
    same inputs (see below)."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        opd_adjoint, opd_adjoint_reference, opd_chain, opd_chain_reference)
    log("== K8/K9 vs plain on the card (double Gauss, %d bench rays, ray 0 "
        "the chief ray; reference sphere radius %.6f mm, wavelength %g m)"
        % (N_CHECK, -s.image.pupil.distance, s.wavelengths[0]))
    worst = {"opd_chain": 0., "opd_adjoint": 0.}
    failures = []

    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        dt = str(dtype)[6:]
        for clip in (False, True):
            tag = "%s clip=%s" % (dt, clip)
            # clipped: 1.5x wider, so that the apertures vignette
            state = opd_bundle(N_CHECK, dtype, SEED, 1.5 if clip else 1.)
            aux = opd_aux(s, table, specs, state)
            got = opd_chain(table, specs, state, aux, clip)
            want = opd_chain_reference(table, specs, state, aux, clip)
            # float32: the float64 plain version on the same inputs
            state64 = tuple(c.double() for c in state)
            aux64 = aux.double()
            want64 = want if f64 else opd_chain_reference(
                table, specs, state64, aux64, clip)
            torch.cuda.synchronize()
            live = torch.isfinite(want[0])
            live_got = torch.isfinite(got[0])
            masks = int((live_got != live).sum())
            both = live & live_got
            scale = max(float(want[0][both].double().abs().max()), 1.)
            errs = [err(g[both], w[both]) for g, w in zip(got, want)]
            rels = [e/max(float(w[both].double().abs().max()), 1.)
                    for e, w in zip(errs, want)]
            extra = ""
            if f64:
                ok = masks == 0 and max(rels) <= F64_REL
            else:
                ok = masks <= F32_NAN_FRAC*N_CHECK and max(rels) <= OPD_F32_REL
                all3 = both & torch.isfinite(want64[0])
                extra = (", kernel vs float64 plain %.3e, plain float32 vs "
                         "float64 plain %.3e of max |k|"
                         % (err(got[0][all3], want64[0][all3])/scale,
                            err(want[0][all3], want64[0][all3])/scale))
                worst["opd_chain"] = max(worst["opd_chain"], errs[0])
            log("K8 %s: k max abs err %.3e waves (%.3e of max |k| %.6g%s), "
                "landing %.3e / %.3e mm, NaN masks differ on %d rays, dead "
                "rays %d -> %s" % (tag, errs[0], rels[0], scale, extra,
                                   errs[1], errs[2], masks,
                                   int((~live).sum()), "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K8 " + tag)
            # the rays live in all the versions compared carry cotangents
            same = both & torch.isfinite(want64[0])
            for kind in ("wavefront", "strehl"):
                cts = tuple(torch.where(same, c, 0.)
                            for c in opd_cotangents(*want, kind))
                pg, cst, cc = opd_adjoint(table, specs, state, aux, cts, clip)
                pr, sr, cr = opd_adjoint_reference(table, specs, state, aux,
                                                   cts, clip)
                if f64:
                    lim, base, base_c = GRAD_F64_REL, pr, cr
                    mass, mass_c = pr, cr
                else:
                    # float32 sums of terms that cancel: the kernel (and,
                    # for the log, the plain float32 version) against the
                    # float64 plain version on the same inputs, within
                    # OPD_F32_SUM_REL of the sum of |term| (the float64
                    # plain version with |ct|)
                    cts64 = tuple(c.double() for c in cts)
                    lim = OPD_F32_SUM_REL
                    base, _, base_c = opd_adjoint_reference(
                        table, specs, state64, aux64, cts64, clip)
                    mass, _, mass_c = opd_adjoint_reference(
                        table, specs, state64, aux64,
                        tuple(c.abs() for c in cts64), clip)
                torch.cuda.synchronize()
                fields = {}
                for name, cols in OPD_GRAD_FIELDS:
                    e = err(pg[:, cols], base[:, cols])
                    ep = 0. if f64 else err(pr[:, cols], base[:, cols])
                    sc = float(mass[:, cols].double().abs().max())
                    fields[name] = (e, ep, sc,
                                    bool(torch.isfinite(pg[:, cols]).all())
                                    and e <= lim*sc)
                ce = err(cc, base_c)
                cep = 0. if f64 else err(cr, base_c)
                cscale = float(mass_c.double().abs().max())
                ray_rel = 0.
                for g3, w3 in ((cst[:3], sr[:3]), (cst[3:], sr[3:])):
                    sc = max(float(c.double().abs().max()) for c in w3)
                    e = max(err(a, b) for a, b in zip(g3, w3))
                    ray_rel = max(ray_rel, e/sc if sc else e)
                dead_zero = not any(bool(c[~live_got].any()) for c in cst)
                finite = all(bool(torch.isfinite(c).all()) for c in cst)
                ok = (all(v[3] for v in fields.values()) and finite
                      and dead_zero and ce <= lim*cscale
                      and ray_rel <= (GRAD_F64_REL if f64 else F32_RAY_REL)
                      and not pg[0].any())
                log("K9 %s %s: %s; centre err %.3e (plain %.3e) of scale "
                    "%.3e | rays rel err %.3e, dead rays all zero %s, all "
                    "finite %s -> %s"
                    % (tag, kind, "; ".join(
                        "%s err %.3e (plain %.3e) of scale %.3e" % (k, *v[:3])
                        for k, v in fields.items()), ce, cep, cscale, ray_rel,
                       dead_zero, finite, "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K9 %s %s" % (tag, kind))
                if not f64:
                    worst["opd_adjoint"] = max(
                        worst["opd_adjoint"],
                        *(v[0] for v in fields.values()))
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def phase_opd_fd_check(s, table, specs):
    """K9's float64 gradient of the K8 wavefront RMS against central
    differences, w.r.t. the curvature and the distance (offset z) with
    the largest gradients and one glass's vd through glass_tables (the
    n_before and mu slots).  The vd merit is taken at the second
    wavelength: at the first, the d line, the index is nd whatever
    vd."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_wavefront_rms
    from rayopt_tpu_torch.ops.tables import table_at
    log("== K9 vs central differences of the K8 wavefront RMS (float64, %d "
        "bench rays, ray 0 the chief ray; steps %s, vd %g)"
        % (N_CHECK, FD_STEP, FD_VD_STEP))
    state = opd_bundle(N_CHECK, torch.float64, SEED)
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    kw = dict(ref=0, radius=-s.image.pupil.distance,
              wavelength=s.wavelengths[0], scale=s.scale,
              finite=s.object.finite, specs=specs)
    tabs = s.tables()
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    nd = torch.tensor(nd0, device=DEVICE)

    def merit(tab=table, vd=None):
        if vd is None:
            return adjoint_wavefront_rms(tab, y0, u0, **kw)
        tab = table_at(glass.glass_tables(tabs, nd, vd, asg, s.wavelengths),
                       1)
        return adjoint_wavefront_rms(tab, y0, u0, **dict(
            kw, wavelength=s.wavelengths[1]))
    c = table.curvature.clone().requires_grad_()
    off = table.offset.clone().requires_grad_()
    vd = torch.tensor(vd0, device=DEVICE, requires_grad=True)
    with warnings.catch_warnings():
        # flat rows' curvature, on-axis rows' offsets, air/air rows' mu:
        # baked out by the specs, as intended
        warnings.simplefilter("ignore")
        value = merit(table.replace(curvature=c, offset=off))
        value.backward()
        merit(vd=vd).backward()
    grads = {"curvature": c.grad.cpu(), "distance": off.grad[:, 2].cpu(),
             "vd": vd.grad.cpu()}
    picks = [(f, int(torch.argmax(grads[f].abs()))) for f in grads]
    failures = []
    with torch.no_grad():
        for field, j in picks:
            h = FD_VD_STEP if field == "vd" else FD_STEP[field]
            side = []
            for sgn in (1., -1.):
                if field == "vd":
                    v = torch.tensor(vd0, device=DEVICE)
                    v[j] += sgn*h
                    side.append(float(merit(vd=v)))
                elif field == "curvature":
                    v = table.curvature.clone()
                    v[j] += sgn*h
                    side.append(float(merit(table.replace(curvature=v))))
                else:
                    v = table.offset.clone()
                    v[j, 2] += sgn*h
                    side.append(float(merit(table.replace(offset=v))))
            fd = (side[0] - side[1])/(2*h)
            g = float(grads[field][j])
            rel = abs(g - fd)/abs(fd)
            ok = rel <= FD_REL
            what = ("slot %d (element %d)" % (j, asg[2][j]) if field == "vd"
                    else "row %d" % j)
            log("%s of %s: K9 %.12g, central difference %.12g, rel %.2e -> %s"
                % (field, what, g, fd, rel, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s" % (field, what))
    log("wavefront RMS of the bench bundle: %.9g waves"
        % float(value.detach()))
    if failures:
        raise AssertionError("K9 disagrees with finite differences: "
                             + ", ".join(failures))


def phase_design_path():
    """The composite design step, through the entry points a user
    calls: 9 spot bundles (K4/K5), 3 wavefront bundles (K8/K9) and a
    focal-length penalty, optimize_grad, write_back_table; then the
    Strehl, PSF and MTF report and the host OPD/Zernike cross-check."""
    from rayopt_tpu_torch import GeometricTrace
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_opd_rays,
                                                adjoint_spot_rms,
                                                adjoint_wavefront_rms)
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.parallel import (
        bundles_from_system, bundles_to, composite_merit, first_order_penalty,
        mtf_radial, optimize_grad, paraxial_seed, psf_grid, psf_polychromatic,
        strehl_marechal, strehl_ratio, write_back_table)
    log("== design path: double Gauss, 9 spot bundles (3 fields x 3 "
        "wavelengths, adjoint_spot_rms) + 3 wavefront bundles (fields %s at "
        "%g m, adjoint_wavefront_rms) + %g x focal-length penalty -> "
        "optimize_grad(select=%s), float64, %d Adam steps at lr %g"
        % (FIELDS, 587.56e-9, DESIGN_PENALTY, OPT_SELECT, DESIGN_STEPS,
           DESIGN_LR))
    t0 = time.perf_counter()
    s = double_gauss()
    spot = bundles_from_system(s, fields=FIELDS, nrays=N_DESIGN,
                               distribution="hexapolar")
    wave = bundles_from_system(s, fields=FIELDS,
                               wavelengths=[s.wavelengths[0]],
                               nrays=N_DESIGN, distribution="hexapolar")
    log("%d spot and %d wavefront bundles of %d rays (ray 0 the chief ray), "
        "aimed in %.2f s" % (len(spot), len(wave), spot[0][0].shape[0],
                             time.perf_counter() - t0))
    table = s.table()
    specs = specialize(table)
    seed = paraxial_seed(s)
    efl0 = float(s.paraxial.focal_length[1])
    opd_kw = dict(ref=0, radius=-s.image.pupil.distance,
                  wavelength=s.wavelengths[0], scale=s.scale,
                  finite=s.object.finite, specs=specs)

    def merit_parts(spot, wave):
        def spots(tab):
            total = 0.
            for y0, u0, w, chroma in spot:
                ov = {k: v.to(tab.curvature.device)
                      for k, v in chroma.items() if k != "wavelength"}
                total = total + adjoint_spot_rms(tab.replace(**ov), y0, u0, w,
                                                 specs=specs)
            return total

        def wavefronts(tab):
            return sum(adjoint_wavefront_rms(tab, y0, u0, w, **opd_kw)
                       for y0, u0, w, _ in wave)

        def penalty(tab):
            return DESIGN_PENALTY*first_order_penalty(
                tab, seed, {"focal_length": (1, efl0)})
        return spots, wavefronts, penalty

    def report(tab, when):
        for field, (y0, u0, w, _) in zip(FIELDS, wave):
            st = float(strehl_ratio(tab, y0, u0, w, engine="adjoint",
                                    **opd_kw))
            sm = float(strehl_marechal(tab, y0, u0, w, engine="adjoint",
                                       **opd_kw))
            wf = float(adjoint_wavefront_rms(tab, y0, u0, w, **opd_kw))
            log("%s, field %.1f: wavefront RMS %.9g waves, Strehl %.9g, "
                "Marechal %.9g" % (when, field, wf, st, sm))
            if not (np.isfinite(st) and 0 <= st <= 1 + 1e-12
                    and np.isfinite(sm) and np.isfinite(wf)):
                raise AssertionError("Strehl report %s at field %.1f: %g %g"
                                     % (when, field, st, sm))

    grads, ends = {}, []

    def keep(tag):
        def callback(i, value, params):
            ends.append(time.perf_counter())   # value synced the step
            if i == 0:
                grads[tag] = {k: v.grad.detach().double().cpu().clone()
                              for k, v in params.items()}
        return callback
    with warnings.catch_warnings():
        # flat rows bake out their curvature, on-axis rows their
        # transverse offsets
        warnings.simplefilter("ignore")
        report(table, "before")
        reset_launches()
        t0 = time.perf_counter()
        tab_opt, hist = optimize_grad(table, spot, select=OPT_SELECT,
                                      steps=DESIGN_STEPS, lr=DESIGN_LR,
                                      merit=composite_merit(
                                          *merit_parts(spot, wave)),
                                      callback=keep("card"))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = read_launches()
        breakdown = step_breakdown(tab_opt, specs, wave,
                                   merit_parts(spot, wave))
        steps = np.diff([t0] + ends[:DESIGN_STEPS])
        t0 = time.perf_counter()
        spot_cpu, wave_cpu = bundles_to(spot, "cpu"), bundles_to(wave, "cpu")
        _, hist_cpu = optimize_grad(s.table(device="cpu"), spot_cpu,
                                    select=OPT_SELECT, steps=1, lr=DESIGN_LR,
                                    merit=composite_merit(
                                        *merit_parts(spot_cpu, wave_cpu)),
                                    callback=keep("cpu"))
        t_cpu = time.perf_counter() - t0
        report(tab_opt, "after")
    merit_rel = abs(hist[0] - hist_cpu[0])/abs(hist_cpu[0])
    grad_rel = {k: float((grads["card"][k] - grads["cpu"][k]).abs().max()
                         / grads["cpu"][k].abs().max())
                for k in OPT_SELECT}
    log("merit history (9 spot RMS mm + 3 wavefront RMS waves + penalty): %s"
        % " ".join("%.12g" % v for v in hist))
    log("step 0 card vs CPU plain: merit %.15g vs %.15g (rel %.2e), "
        "gradient rel to its max %s | card %.2f s for %d steps (step 0 "
        "%.3f s, later steps mean %.4f s, min %.4f s), CPU %.2f s for 1 step"
        % (hist[0], hist_cpu[0], merit_rel,
           {k: "%.2e" % v for k, v in grad_rel.items()}, t_card, DESIGN_STEPS,
           steps[0], steps[1:].mean(), steps[1:].min(), t_cpu))
    log("design step by part, forward and backward on the card (wall ms, "
        "mean of %d after one warm-up; not counted as launches of the "
        "path): %s" % (BREAKDOWN_REPS, ", ".join(
            "%s %.3f" % kv for kv in breakdown.items())))
    log("== launch counts on the design path: %s" % launches)
    write_back_table(s, tab_opt, OPT_SELECT)
    efl1 = float(s.paraxial.focal_length[1])
    log("write_back_table: EFL %.8f -> %.8f mm" % (efl0, efl1))
    # on axis after the steps: PSF, MTF, the polychromatic PSF
    y0, u0, w, _ = wave[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p, q, psf = psf_grid(tab_opt, y0, u0, w, ngrid=64, engine="adjoint",
                             **opd_kw)
        freq, mtf_x, mtf_y = mtf_radial(tab_opt, y0, u0, w, ngrid=64,
                                        engine="adjoint", **opd_kw)
        poly = [spot[li*len(FIELDS)] for li in range(len(s.wavelengths))]
        kw_poly = {k: v for k, v in opd_kw.items() if k != "wavelength"}
        pp, qp, psf_p = psf_polychromatic(tab_opt, poly, ngrid=64,
                                          engine="adjoint", **kw_poly)
    log("on axis after: PSF 128x128 peak %.6g (sum %.12g), MTF x at "
        "index 4/8/16 %.6g %.6g %.6g, y %.6g %.6g %.6g; polychromatic PSF "
        "(%d wavelengths) peak %.6g (sum %.12g)"
        % (float(psf.max()), float(psf.sum()), *(float(mtf_x[i])
                                                  for i in (4, 8, 16)),
           *(float(mtf_y[i]) for i in (4, 8, 16)), len(poly),
           float(psf_p.max()), float(psf_p.sum())))
    failures = []
    for name, v in (("PSF", psf), ("MTF x", mtf_x), ("MTF y", mtf_y),
                    ("polychromatic PSF", psf_p)):
        if not bool(torch.isfinite(v).all()):
            failures.append(name + " not finite")
    if abs(float(psf.sum()) - 1) > 1e-9 or abs(float(psf_p.sum()) - 1) > 1e-9:
        failures.append("PSF sum")
    if float(mtf_x[0]) != 1. or float(mtf_y[0]) != 1.:
        failures.append("MTF(0)")
    # the host OPD and Zernike fit on axis (numpy) against K8 on the card
    g = GeometricTrace(s)
    g.rays_point((0., 0.), nrays=N_HOST_OPD, distribution="hexapolar",
                 filter=False)
    hx, hy, hw = g.opd(resample=0)
    coeff, resid = g.zernike(nterms=11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # the written-back system's own exit pupil and wavelength
        kw_host = dict(opd_kw, specs=None, ref=g.ref, wavelength=g.l,
                       radius=-s.image.pupil.distance)
        cw, cl = adjoint_opd_rays(s.table(), torch.from_numpy(g.y[0]).to(DEVICE),
                                  torch.from_numpy(g.u[0]).to(DEVICE),
                                  with_pupil=True, **kw_host)
    cw, cl = cw.detach().cpu().numpy(), cl.detach().cpu().numpy()
    good = np.isfinite(hw)
    host_err = float(np.abs(cw[good] - hw[good]).max())
    land_err = float(max(np.abs(cl[good, 0] - hx[good]).max(),
                         np.abs(cl[good, 1] - hy[good]).max()))
    log("host cross-check on axis (%d rays): K8 f64 on the card vs "
        "GeometricTrace.opd max |diff| %.3e waves (landing %.3e mm); host "
        "wavefront peak-to-valley %.6g waves; Zernike (Noll) defocus %.6g, "
        "spherical %.6g waves, fit residual %.3e"
        % (int(good.sum()), host_err, land_err,
           float(np.ptp(hw[good])), coeff[3], coeff[10], resid))
    if not host_err <= HOST_OPD_ATOL:
        failures.append("host OPD cross-check")
    if not all(b < a for a, b in zip(hist[:-1], hist[1:])):
        failures.append("the merit did not fall at every step")
    if not merit_rel <= OPT_MERIT_REL:
        failures.append("step 0 merit")
    failures += ["step 0 gradient of " + k for k, v in grad_rel.items()
                 if not v <= OPT_GRAD_REL]
    if not np.isfinite(efl1):
        failures.append("EFL after write-back")
    path = ("weighted_moments", "merit_adjoint", "opd_chain", "opd_adjoint")
    if not all(launches[k] for k in path):
        failures.append("K4, K5, K8 or K9 never launched: %s" % launches)
    if failures:
        raise AssertionError("design path failed: " + ", ".join(failures))
    return launches


def step_breakdown(table, specs, wave, parts):
    """Wall milliseconds of each part of the design merit's forward and
    backward on the card (the gradients of curvature and offset), and
    of the 3 one-ray sphere-centre traces the wavefront terms hold."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final

    def centres(tab):
        return sum(trace_rays_final(tab, y0[:1], u0[:1], clip=False,
                                    specs=specs)[0].sum()
                   for y0, u0, _, _ in wave)
    named = dict(zip(("9 spot terms", "3 wavefront terms", "penalty",
                      "3 sphere-centre traces"), (*parts, centres)))
    out = {}
    for name, part in named.items():
        def run():
            tab = table.replace(
                curvature=table.curvature.detach().clone().requires_grad_(),
                offset=table.offset.detach().clone().requires_grad_())
            part(tab).backward()
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BREAKDOWN_REPS):
            run()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0)/BREAKDOWN_REPS*1e3
    return out


DF32_NAMES = ("trace_final_df32", "trace_multi_df32", "trace_merit_df32",
              "trace_merit_multi_df32")


def df32_state(state64, widen=1.):
    """The df32 state (ops.df32.state_from_f64) of six float64 (N,)
    components, x and y scaled by `widen`, on their device."""
    from rayopt_tpu_torch.ops.df32 import state_from_f64
    x, y, z, ux, uy, uz = state64
    return state_from_f64(torch.stack([x*widen, y*widen, z], 1),
                          torch.stack([ux, uy, uz], 1))


def df32_pairs(res, with_path):
    """The (hi, lo) pairs of a K10 result (the path pair last)."""
    return (*res[0], res[1]) if with_path else tuple(res)


def compare_df32(got, want):
    """Two lists of df32 (hi, lo) pairs: the words that differ (NaN
    equal to NaN), the most rays whose NaN masks differ in one output,
    and the max abs and max relative (of max(1, max |value|)) error of
    the float64 values hi + lo over the rays live in both."""
    words = masks = 0
    err = rel = 0.
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            words += int((~((a == b) | (torch.isnan(a) & torch.isnan(b))))
                         .sum())
        va, vb = g[0].double() + g[1].double(), w[0].double() + w[1].double()
        na, nb = torch.isnan(va), torch.isnan(vb)
        masks = max(masks, int((na != nb).sum()))
        live = ~(na | nb)
        if bool(live.any()):
            d = float((va[live] - vb[live]).abs().max())
            err = max(err, d)
            rel = max(rel, d/max(1., float(vb[live].abs().max())))
    return words, masks, err, rel


def phase_df32_check(s):
    """K10-K13 against their plain versions on the card: the bench
    bundle (1.5x wide when clipped), fast and exact plans, the optical
    path off and on; K11/K13 at the 3 wavelengths.  The kernels round
    every float32 operation as the plain versions do, so their words
    should be identical (counted); moments are summed in another order."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    from rayopt_tpu_torch.ops.tables import table_at
    table, tabs = s.table(), s.tables()
    nlam = tabs.curvature.shape[0]
    log("== K10-K13 vs plain on the card (double Gauss, %d bench rays, 1.5x "
        "wide when clipped; K11/K13 at %d wavelengths)" % (N_CHECK, nlam))
    worst = dict.fromkeys(DF32_NAMES, 0.)
    failures = []
    state64 = bench_bundle(N_CHECK, torch.float64, SEED)
    for clip in (False, True):
        state = df32_state(state64, 1.5 if clip else 1.)
        for fast in (True, False):
            tag = "clip=%s %s plan" % (clip, "fast" if fast else "exact")
            steps = D.plan(table, clip=clip, fast=fast)
            plans = [D.plan(table_at(tabs, li), clip=clip, fast=fast)
                     for li in range(nlam)]
            for wp in (False, True):
                got = CD.trace_final_df32(steps, state, with_path=wp)
                want = CD.trace_final_df32_reference(steps, state,
                                                     with_path=wp)
                words, masks, err, rel = compare_df32(df32_pairs(got, wp),
                                                      df32_pairs(want, wp))
                ok = masks == 0 and rel <= DF32_REL
                worst["trace_final_df32"] = max(worst["trace_final_df32"],
                                                err)
                log("K10 %s path=%s: differing words %d, NaN masks differ "
                    "on %d rays, NaN rays %d, max abs err %.3e, max rel err "
                    "%.3e -> %s" % (tag, wp, words, masks,
                                    int(torch.isnan(got[0][3][0] if wp
                                                    else got[3][0]).sum()),
                                    err, rel, "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K10 %s path=%s" % (tag, wp))
                got = CD.trace_multi_df32(plans, state, with_path=wp)
                want = CD.trace_multi_df32_reference(plans, state,
                                                     with_path=wp)
                res = [compare_df32(df32_pairs(g, wp), df32_pairs(w, wp))
                       for g, w in zip(got, want)]
                words = sum(r[0] for r in res)
                masks, err, rel = (max(r[i] for r in res) for i in (1, 2, 3))
                ok = len(got) == nlam and masks == 0 and rel <= DF32_REL
                worst["trace_multi_df32"] = max(worst["trace_multi_df32"],
                                                err)
                log("K11 %s path=%s: differing words %d over %d "
                    "wavelengths, NaN masks differ on %d rays, max abs err "
                    "%.3e, max rel err %.3e -> %s"
                    % (tag, wp, words, nlam, masks, err, rel,
                       "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K11 %s path=%s" % (tag, wp))
            moms = [(CD.trace_merit_df32(steps, state),
                     CD.trace_merit_df32_reference(steps, state))]
            moms += list(zip(CD.trace_merit_multi_df32(plans, state),
                             CD.trace_merit_multi_df32_reference(plans,
                                                                 state)))
            for i, (mg, mw) in enumerate(moms):
                name = "K12" if i == 0 else "K13 wavelength %d" % (i - 1)
                key = DF32_NAMES[2 if i == 0 else 3]
                _, rel, dcount = compare_moments(mg, mw, torch.float64,
                                                 N_CHECK)
                rg = float(spot_rms_from_moments(*mg))
                rw = float(spot_rms_from_moments(*mw))
                ok = dcount == 0 and rel <= DF32_REL
                worst[key] = max(worst[key], abs(rg - rw))
                log("%s %s: moments rel err %.3e, count %d (diff %d), spot "
                    "RMS kernel %.15g plain %.15g -> %s"
                    % (name, tag, rel, int(float(mw[0])), dcount, rg, rw,
                       "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("%s %s" % (name, tag))
        del state
    if failures:
        raise AssertionError("df32 kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def phase_df32_path(s, aimed):
    """The parity-grade df32 path on the main path's aimed bundles:
    df32.plan (fast and exact) -> state_from_f64 on the card -> K10 with
    the optical path and K12; System.tables -> table_at -> one plan a
    wavelength -> K11 (with the path) and K13.  Each spot RMS is held
    against the CPU float64 plain trace, K10's image positions against
    float64 K1 on the card."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_multi
    from rayopt_tpu_torch.ops.tables import table_at
    table, tabs = s.table(), s.tables()
    nlam = tabs.curvature.shape[0]
    log("== parity-grade df32 path: double Gauss, the main path's %d aimed "
        "rays per field -> df32.plan (fast and exact) -> state_from_f64 -> "
        "K10 (with the path), K12; System.tables -> %d plans -> K11, K13"
        % (N_AIMED, nlam))
    plans = {fast: D.plan(table, fast=fast) for fast in (True, False)}
    lam_plans = [D.plan(table_at(tabs, li), fast=True) for li in range(nlam)]
    # the CPU float64 references of the other wavelengths (the first is
    # the main path's: System.table() traces wavelengths[0])
    tabs_cpu = s.tables(s.wavelengths[1:], device="cpu")
    failures = []
    for a in aimed:
        field = a["field"]
        state = D.state_from_f64(a["y"], a["u"])
        for fast in (True, False):
            t0 = time.perf_counter()
            fin, path = CD.trace_final_df32(plans[fast], state,
                                            with_path=True)
            mom = CD.trace_merit_df32(plans[fast], state)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            xy = torch.stack([D.to_f64(fin[0]), D.to_f64(fin[1])], 1)
            uz = D.to_f64(fin[5])
            rms10, live = spot_rms(xy, uz[:, None].expand(-1, 3))
            rms12 = float(spot_rms_from_moments(*mom))
            good = torch.isfinite(a["y64"][:, 0])
            same = torch.equal(good, torch.isfinite(xy[:, 0]))
            pos = float((xy[good] - a["y64"][good, :2]).abs().max())
            path_ok = bool(torch.isfinite(D.to_f64(path)[good]).all())
            rel10 = abs(rms10 - a["rms_cpu"])/a["rms_cpu"]
            rel12 = abs(rms12 - a["rms_cpu"])/a["rms_cpu"]
            # K12's moments carry E[x^2] - c^2: off axis (centroid ~1e6
            # spot RMS) their df32 precision is reported, not gated
            ok = (same and live == a["live_cpu"] and pos <= DF32_F64_ATOL
                  and path_ok and rel10 <= PARITY_REL
                  and (field != 0. or rel12 <= PARITY_REL))
            log("field %.1f %s plan: %d rays live | K10 image positions vs "
                "f64 K1 max %.3e mm | spot RMS mm: CPU f64 %.15g | K10 "
                "%.15g (rel %.3e) | K12 %.15g (rel %.3e) | card %.3f s -> %s"
                % (field, "fast" if fast else "exact", live, pos,
                   a["rms_cpu"], rms10, rel10, rms12, rel12, t_gpu,
                   "ok" if ok else "FAIL"))
            if not ok:
                failures.append("field %.1f %s" % (
                    field, "fast" if fast else "exact"))
            del fin, path, xy, uz
        t0 = time.perf_counter()
        outs = CD.trace_multi_df32(lam_plans, state, with_path=True)
        moms = CD.trace_merit_multi_df32(lam_plans, state)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        ycpu, ucpu = a["y"].cpu(), a["u"].cpu()
        yh, uh, _ = trace_rays_final_multi(
            tabs_cpu, ycpu.expand(nlam - 1, -1, -1),
            ucpu.expand(nlam - 1, -1, -1), clip=False)
        ref = [a["rms_cpu"]] + [spot_rms(yh[li], uh[li])[0]
                                for li in range(nlam - 1)]
        t_cpu = time.perf_counter() - t0
        del yh, uh
        for li, ((fin, path), mom) in enumerate(zip(outs, moms)):
            xy = torch.stack([D.to_f64(fin[0]), D.to_f64(fin[1])], 1)
            rms11, live = spot_rms(xy, D.to_f64(fin[5])[:, None].expand(-1,
                                                                        3))
            rms13 = float(spot_rms_from_moments(*mom))
            rel11 = abs(rms11 - ref[li])/ref[li]
            rel13 = abs(rms13 - ref[li])/ref[li]
            ok = rel11 <= PARITY_REL and (field != 0. or rel13 <= PARITY_REL)
            log("field %.1f wavelength %d: %d rays live | spot RMS mm: CPU "
                "f64 %.15g | K11 %.15g (rel %.3e) | K13 %.15g (rel %.3e) -> "
                "%s" % (field, li, live, ref[li], rms11, rel11, rms13, rel13,
                        "ok" if ok else "FAIL"))
            if not ok:
                failures.append("field %.1f wavelength %d" % (field, li))
        log("field %.1f: K11 + K13 card %.3f s, CPU f64 trace of %d "
            "wavelengths %.2f s" % (field, t_gpu, nlam - 1, t_cpu))
        del outs, moms, state
    if failures:
        raise AssertionError("df32 path parity failed at " +
                             ", ".join(failures))


def _wrappers():
    from rayopt_tpu_torch.ops import cuda_df32, cuda_grad, cuda_trace
    return (cuda_trace.trace_final, cuda_trace.trace_merit,
            cuda_grad.weighted_moments, cuda_grad.merit_adjoint,
            cuda_trace.trace_multi, cuda_grad.weighted_moments_multi,
            cuda_grad.merit_adjoint_multi, cuda_grad.opd_chain,
            cuda_grad.opd_adjoint, cuda_df32.trace_final_df32,
            cuda_df32.trace_multi_df32, cuda_df32.trace_merit_df32,
            cuda_df32.trace_merit_multi_df32)


def reset_launches():
    for fn in _wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in _wrappers()}


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)/reps


def peak_gib(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()/2**30


def phase_throughput(table, specs, card):
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_final_reference, trace_merit,
        trace_merit_reference)
    nsurf = table.curvature.shape[0] - 1
    log("== throughput: %d bench rays, %d traced surfaces (%s)"
        % (N_BENCH, nsurf, card))
    times = {}
    for dtype in (torch.float32, torch.float64):
        state = bench_bundle(N_BENCH, dtype, SEED + 1)
        pairs = (
            ("trace_final",
             lambda: trace_final(table, specs, state),
             lambda: trace_final_reference(table, specs, state)),
            ("trace_merit",
             lambda: trace_merit(table, specs, state),
             lambda: trace_merit_reference(table, specs, state)))
        for name, kernel, plain in pairs:
            # in turns: plain, kernel, kernel, plain
            p1 = cuda_ms(plain, 3)
            k1 = cuda_ms(kernel, 20)
            k2 = cuda_ms(kernel, 20)
            p2 = cuda_ms(plain, 3)
            k, p = (k1 + k2)/2, (p1 + p2)/2
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | %.4g vs %.4g "
                "intersections/s | peak memory %.3f vs %.3f GiB | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   N_BENCH*nsurf/(k*1e-3), N_BENCH*nsurf/(p*1e-3), mem_k,
                   mem_p, card))
        del state
        torch.cuda.empty_cache()
    return times


def phase_grad_throughput(table, specs, card):
    """K4 and K5 (all fields, with the ray cotangents: the work of the
    earlier run-time-flag K5) against their plain versions at
    N_GRAD_TIME rays in float32 and float64, beside K5 for the
    optimizer's slot set without ray cotangents; then float64 at one
    optimizer bundle's N_OPT_BUNDLE rays, and float32 at N_BENCH rays,
    kernels alone."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments, weighted_moments_reference, merit_adjoint,
        merit_adjoint_reference)
    nsurf = table.curvature.shape[0] - 1
    log("== K4/K5 throughput: %d bench rays against the plain versions, "
        "then %d rays (float64) and %d rays (float32) kernel alone, %d "
        "traced surfaces (%s)" % (N_GRAD_TIME, N_OPT_BUNDLE, N_BENCH, nsurf,
                                  card))

    def pairs(state, w, ct):
        return (
            ("weighted_moments",
             lambda: weighted_moments(table, specs, state, w),
             lambda: weighted_moments_reference(table, specs, state, w)),
            ("merit_adjoint",
             lambda: merit_adjoint(table, specs, state, w, ct),
             lambda: merit_adjoint_reference(table, specs, state, w, ct)))

    def optimizer_k5(state, w, ct):
        return lambda: merit_adjoint(table, specs, state, w, ct,
                                     fields=OPT_FIELDS, rays=False)
    times = {}
    for dtype in (torch.float32, torch.float64):
        state = bench_bundle(N_GRAD_TIME, dtype, SEED + 1)
        w = bench_weights(N_GRAD_TIME, dtype, SEED + 3)
        ct = rms_cotangent(weighted_moments(table, specs, state, w))
        for name, kernel, plain in pairs(state, w, ct):
            # in turns: plain, kernel, kernel, plain
            p1 = cuda_ms(plain, 3)
            k1 = cuda_ms(kernel, 20)
            k2 = cuda_ms(kernel, 20)
            p2 = cuda_ms(plain, 3)
            k, p = (k1 + k2)/2, (p1 + p2)/2
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | %.4g ray-surfaces/s | "
                "peak memory %.3f vs %.3f GiB | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   N_GRAD_TIME*nsurf/(k*1e-3), mem_k, mem_p, card))
        k = cuda_ms(optimizer_k5(state, w, ct), 20)
        times[("merit_adjoint_optimizer", dtype)] = k
        log("merit_adjoint %s, the optimizer's slot set, no ray cotangents: "
            "kernel %.4f ms | %s" % (str(dtype)[6:], k, card))
        del state, w
        torch.cuda.empty_cache()
    state = bench_bundle(N_OPT_BUNDLE, torch.float64, SEED + 1)
    w = bench_weights(N_OPT_BUNDLE, torch.float64, SEED + 3)
    ct = rms_cotangent(weighted_moments(table, specs, state, w))
    cases = [(name, kernel) for name, kernel, _ in pairs(state, w, ct)]
    cases.append(("merit_adjoint_optimizer", optimizer_k5(state, w, ct)))
    for name, kernel in cases:
        k = cuda_ms(kernel, 20)
        times[(name, N_OPT_BUNDLE)] = k
        log("%s float64 at %d rays: kernel %.4f ms, %.4g ray-surfaces/s | %s"
            % (name, N_OPT_BUNDLE, k, N_OPT_BUNDLE*nsurf/(k*1e-3), card))
    del state, w
    state = bench_bundle(N_BENCH, torch.float32, SEED + 1)
    w = bench_weights(N_BENCH, torch.float32, SEED + 3)
    ct = rms_cotangent(weighted_moments(table, specs, state, w))
    for name, kernel, _ in pairs(state, w, ct):
        k = cuda_ms(kernel, 10)
        times[(name, N_BENCH)] = k
        log("%s float32 at %d rays: kernel %.4f ms, %.4g ray-surfaces/s, "
            "peak memory %.3f GiB | plain: not run (memory) | %s"
            % (name, N_BENCH, k, N_BENCH*nsurf/(k*1e-3), peak_gib(kernel),
               card))
    del state, w
    torch.cuda.empty_cache()
    return times


def phase_multi_throughput(tabs, specs, card):
    """K3 (merit), K6 and K7 against their plain versions and against
    nlam launches of their monochromatic twins (K2, K4, K5) on the same
    bundle; then the three alone at N_BENCH rays in float32."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        weighted_moments, weighted_moments_multi,
        weighted_moments_multi_reference)
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_merit, trace_multi, trace_multi_reference)
    from rayopt_tpu_torch.ops.tables import table_at
    nlam = tabs.curvature.shape[0]
    one = [table_at(tabs, li) for li in range(nlam)]
    log("== K3/K6/K7 throughput: %d bench rays x %d wavelengths against the "
        "plain versions and %d launches of the monochromatic twin, then %d "
        "rays kernel alone (%s)" % (N_GRAD_TIME, nlam, nlam, N_BENCH, card))

    def cases(state, w, ct):
        return (
            ("trace_multi",
             lambda: trace_multi(tabs, specs, state, merit=True),
             lambda: trace_multi_reference(tabs, specs, state, merit=True),
             lambda: [trace_merit(t, specs, state) for t in one]),
            ("weighted_moments_multi",
             lambda: weighted_moments_multi(tabs, specs, state, w),
             lambda: weighted_moments_multi_reference(tabs, specs, state, w),
             lambda: [weighted_moments(t, specs, state, w) for t in one]),
            ("merit_adjoint_multi",
             lambda: merit_adjoint_multi(tabs, specs, state, w, ct),
             lambda: merit_adjoint_multi_reference(tabs, specs, state, w,
                                                   ct),
             lambda: [merit_adjoint(t, specs, state, w, ct[li])
                      for li, t in enumerate(one)]))
    times, live = {}, {}
    for dtype in (torch.float32, torch.float64):
        state = bench_bundle(N_GRAD_TIME, dtype, SEED + 1)
        w = bench_weights(N_GRAD_TIME, dtype, SEED + 3)
        ct = rms_cotangent(weighted_moments_multi(tabs, specs, state, w))
        live[dtype] = sum(float(m[0]) for m in trace_multi(
            tabs, specs, state, merit=True))
        for name, kernel, plain, twin in cases(state, w, ct):
            # in turns: plain, kernel, twin, kernel, twin, plain
            p1 = cuda_ms(plain, 3)
            k1 = cuda_ms(kernel, 20)
            t1 = cuda_ms(twin, 20)
            k2 = cuda_ms(kernel, 20)
            t2 = cuda_ms(twin, 20)
            p2 = cuda_ms(plain, 3)
            k, p, t = (k1 + k2)/2, (p1 + p2)/2, (t1 + t2)/2
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p, t)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), %d twin launches %.4f "
                "ms (%.4f, %.4f), plain %.4f ms (%.4f, %.4f) | twins/kernel "
                "%.2fx, plain/kernel %.2fx | peak memory %.3f vs %.3f GiB | "
                "%s" % (name, str(dtype)[6:], k, k1, k2, nlam, t, t1, t2, p,
                        p1, p2, t/k, p/k, mem_k, mem_p, card))
        del state, w
        torch.cuda.empty_cache()
    state = bench_bundle(N_BENCH, torch.float32, SEED + 1)
    w = bench_weights(N_BENCH, torch.float32, SEED + 3)
    ct = rms_cotangent(weighted_moments_multi(tabs, specs, state, w))
    live[N_BENCH] = sum(float(m[0]) for m in trace_multi(
        tabs, specs, state, merit=True))
    for name, kernel, _, twin in cases(state, w, ct):
        k1 = cuda_ms(kernel, 10)
        t1 = cuda_ms(twin, 10)
        k2 = cuda_ms(kernel, 10)
        t2 = cuda_ms(twin, 10)
        k, t = (k1 + k2)/2, (t1 + t2)/2
        times[(name, N_BENCH)] = k
        times[(name, N_BENCH, "twin")] = t
        log("%s float32 at %d rays x %d wavelengths: kernel %.4f ms (%.4f, "
            "%.4f), %d twin launches %.4f ms (%.4f, %.4f), twins/kernel "
            "%.2fx, peak memory %.3f GiB | plain: not run (memory) | %s"
            % (name, N_BENCH, nlam, k, k1, k2, nlam, t, t1, t2, t/k,
               peak_gib(kernel), card))
    del state, w
    torch.cuda.empty_cache()
    return times, live


def phase_opd_throughput(s, table, specs, card):
    """K8 and K9 (wavefront-RMS cotangents) against their plain versions
    at N_GRAD_TIME rays in float32 and float64, then the two alone at
    N_BENCH rays in float32.  Returns the times and the live rays of
    the float32 timing bundle (K9's reverse runs for these only)."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        opd_adjoint, opd_adjoint_reference, opd_chain, opd_chain_reference)
    log("== K8/K9 throughput: %d bench rays (ray 0 the chief ray) against "
        "the plain versions, then %d rays kernel alone (%s)"
        % (N_GRAD_TIME, N_BENCH, card))

    def setup(n, dtype):
        state = opd_bundle(n, dtype, SEED + 1)
        aux = opd_aux(s, table, specs, state)
        k = opd_chain(table, specs, state, aux)
        return state, aux, opd_cotangents(*k, "wavefront"), \
            int(torch.isfinite(k[0]).sum())

    def pairs(state, aux, cts):
        return (
            ("opd_chain",
             lambda: opd_chain(table, specs, state, aux),
             lambda: opd_chain_reference(table, specs, state, aux)),
            ("opd_adjoint",
             lambda: opd_adjoint(table, specs, state, aux, cts),
             lambda: opd_adjoint_reference(table, specs, state, aux, cts)))
    times, live = {}, 0
    for dtype in (torch.float32, torch.float64):
        state, aux, cts, nlive = setup(N_GRAD_TIME, dtype)
        if dtype == torch.float32:
            live = nlive
        for name, kernel, plain in pairs(state, aux, cts):
            # in turns: plain, kernel, kernel, plain
            p1 = cuda_ms(plain, 3)
            k1 = cuda_ms(kernel, 20)
            k2 = cuda_ms(kernel, 20)
            p2 = cuda_ms(plain, 3)
            k, p = (k1 + k2)/2, (p1 + p2)/2
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | live rays %d | peak "
                "memory %.3f vs %.3f GiB | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k, nlive,
                   mem_k, mem_p, card))
        del state, cts
        torch.cuda.empty_cache()
    state, aux, cts, nlive = setup(N_BENCH, torch.float32)
    for name, kernel, _ in pairs(state, aux, cts):
        k = cuda_ms(kernel, 10)
        times[(name, N_BENCH)] = k
        log("%s float32 at %d rays: kernel %.4f ms, live rays %d, peak "
            "memory %.3f GiB | plain: not run (memory) | %s"
            % (name, N_BENCH, k, nlive, peak_gib(kernel), card))
    del state, cts
    torch.cuda.empty_cache()
    return times, live


def phase_df32_throughput(s, card):
    """K10 (with the optical path), K12, K11 (with the path) and K13,
    fast and exact plans, against their plain versions at N_GRAD_TIME
    bench rays, K11/K13 also against nlam launches of K10/K12 (the
    twin), beside float64 K1 on the same rays; then the kernels alone
    at N_BENCH rays, beside float64 K1 again.  Returns the times and
    the live rays of each bundle."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_trace import trace_final
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops.tables import table_at
    table, tabs = s.table(), s.tables()
    specs = specialize(table)
    nlam = tabs.curvature.shape[0]
    log("== K10-K13 throughput: %d bench rays against the plain versions "
        "and %d launches of K10/K12, then %d rays kernel alone, beside "
        "float64 K1 (%s)" % (N_GRAD_TIME, nlam, N_BENCH, card))

    def cases(state, fast):
        one = D.plan(table, fast=fast)
        lam = [D.plan(table_at(tabs, li), fast=fast) for li in range(nlam)]
        return (
            ("trace_final_df32",
             lambda: CD.trace_final_df32(one, state, with_path=True),
             lambda: CD.trace_final_df32_reference(one, state,
                                                   with_path=True), None),
            ("trace_merit_df32",
             lambda: CD.trace_merit_df32(one, state),
             lambda: CD.trace_merit_df32_reference(one, state), None),
            ("trace_multi_df32",
             lambda: CD.trace_multi_df32(lam, state, with_path=True),
             lambda: CD.trace_multi_df32_reference(lam, state,
                                                   with_path=True),
             lambda: [CD.trace_final_df32(p, state, with_path=True)
                      for p in lam]),
            ("trace_merit_multi_df32",
             lambda: CD.trace_merit_multi_df32(lam, state),
             lambda: CD.trace_merit_multi_df32_reference(lam, state),
             lambda: [CD.trace_merit_df32(p, state) for p in lam]))
    times, live = {}, {}
    for n in (N_GRAD_TIME, N_BENCH):
        state64 = bench_bundle(n, torch.float64, SEED + 1)
        state = df32_state(state64)
        live[n] = float(CD.trace_merit_df32(D.plan(table, fast=True),
                                            state)[0])
        k64 = [cuda_ms(lambda: trace_final(table, specs, state64), 10)]
        for fast in (True, False):
            plan = "fast" if fast else "exact"
            for name, kernel, plain, twin in cases(state, fast):
                # in turns: plain, kernel, twin, kernel, twin, plain (no
                # plain at N_BENCH: its temporaries outgrow the card)
                big = n == N_BENCH
                reps = 5 if big else 10
                p1 = None if big else cuda_ms(plain, 2)
                k1 = cuda_ms(kernel, reps)
                t1 = cuda_ms(twin, reps) if twin else None
                k2 = cuda_ms(kernel, reps)
                t2 = cuda_ms(twin, reps) if twin else None
                p2 = None if big else cuda_ms(plain, 2)
                k = (k1 + k2)/2
                p = None if big else (p1 + p2)/2
                t = (t1 + t2)/2 if twin else None
                times[(name, plan, n)] = (k, p, t)
                log("%s %s plan at %d rays: kernel %.4f ms (%.4f, %.4f)%s%s "
                    "| peak memory %.3f GiB | %s"
                    % (name, plan, n, k, k1, k2,
                       "" if twin is None else ", %d twin launches %.4f ms "
                       "(%.4f, %.4f), twins/kernel %.2fx"
                       % (nlam, t, t1, t2, t/k),
                       " | plain: not run (memory)" if big else
                       ", plain %.4f ms (%.4f, %.4f), plain/kernel %.2fx"
                       % (p, p1, p2, p/k), peak_gib(kernel), card))
        k64.append(cuda_ms(lambda: trace_final(table, specs, state64), 10))
        times[("f64_trace_final", n)] = sum(k64)/2
        log("float64 K1 at %d rays (before and after the df32 kernels): "
            "%.4f ms (%.4f, %.4f); K10 fast plan / f64 K1 %.2fx | %s"
            % (n, sum(k64)/2, k64[0], k64[1],
               times[("trace_final_df32", "fast", n)][0]/(sum(k64)/2), card))
        del state64, state
        torch.cuda.empty_cache()
    return times, live


# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s, and flop/s outside the tensor cores by dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def row_flops(spec):
    """Arithmetic operations (one per add, multiply, divide or square
    root) of one surface_step (csrc/trace_common.cuh) for a row of this
    spec."""
    f = 1 + (2 if spec.off_axis else 0) + (60 if spec.rotated else 0)
    if spec.flat:
        f += 2
    elif spec.spherical:
        f += 23
    else:
        f += 31
    f += 8                                    # transfer and optical path
    if spec.kind:
        f += 13 if spec.flat else (27 if spec.spherical else 37)
    return f


def chain_flops(specs):
    """Operations of one ray through the whole chain (trace_ray)."""
    return (sum(row_flops(sp) for sp in specs[1:])
            + 30*(int(specs[0].rotated) + int(specs[-1].rotated)))


# operations of K8's reference-sphere tail (image-row shift, the
# intercept's dot products, square root and divisions, k, lx, ly) and
# of its hand-written reverse
OPD_TAIL_FLOPS = 40
OPD_TAIL_VJP_FLOPS = 70


def kernel_bound(name, n, dtype, specs, nlam=1, live=0):
    """(bound_ms, bound_by) of one launch at n rays: the larger of the
    bytes it must move (each input read once, each output written once)
    over the HBM rate and its operations over the dtype's peak.  The
    reverse sweeps of K5/K7/K9 run only for live rays (`live`: live ray
    traces, summed over wavelengths) and are counted as 3x the forward
    chain (PERF.md's estimate for the adjoint) plus the seeding (K9:
    the tail's reverse)."""
    word = 4 if dtype == torch.float32 else 8
    chain = chain_flops(specs)
    # K8's chain stops at row S-2 and adds the sphere tail
    opd = chain - row_flops(specs[-1]) + OPD_TAIL_FLOPS
    words_in, words_out, flops = {
        "opd_chain": (6, 3, n*opd),
        "opd_adjoint": (9, 6, n*opd + live*(3*opd + OPD_TAIL_VJP_FLOPS)),
        "trace_final": (6, 7, n*chain),
        "trace_merit": (6, 0, n*(chain + 7)),
        "trace_multi": (6, 0, n*nlam*(chain + 7)),
        "weighted_moments": (7, 0, n*(chain + 11)),
        "weighted_moments_multi": (7, 0, n*nlam*(chain + 11)),
        "merit_adjoint": (7, 7, n*chain + live*(3*chain + 11)),
        # K5 for the optimizer's slot set writes nothing a ray
        "merit_adjoint_optimizer": (7, 0, n*chain + live*(3*chain + 11)),
        "merit_adjoint_multi": (7, 7, n*nlam*chain + live*(3*chain + 11)),
    }[name]
    # K9 also writes its parameter and centre cotangents
    slots = len(specs)*7 + 3 if name == "opd_adjoint" else 0
    nbytes = (n*(words_in + words_out) + nlam*len(specs)*17 + slots)*word \
        + 4*len(specs)
    t_bytes, t_ops = nbytes/PEAK_BYTES, flops/PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops)*1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


# float32 operations of csrc/df32.cu's df32 functions as written (one per
# add, subtract, multiply, divide or square root; a negation is a sign
# flip and not counted): two_prod is 17 (Dekker's split 4 a factor), so
# mul 24 and sqr 23; div and sqrt are the exact plan's two refinement
# rounds, div1 and sqrt1 the fast plan's one
DF_OPS = {"add": 11, "mul": 24, "sqr": 23, "scale": 2, "div": 89,
          "div1": 41, "sqrt": 88, "sqrt1": 41}


def df32_step_ops(step, path=False):
    """float32 operations of one surface_df of csrc/df32.cu for a
    planned step (ops.df32.plan), and of the path's s * n_before."""
    o = DF_OPS
    dv = o["div1"] if step["fast"] else o["div"]
    sq = o["sqrt1"] if step["fast"] else o["sqrt"]
    dot3 = 3*o["mul"] + 2*o["add"]
    flat, conic = step["flat"], step["k1"] is not None
    f = o["add"]                                    # z - dz
    if step["dxy"] is not None:
        f += 2*o["add"]
    if step["rot_df"] is not None:                  # in and out of the frame
        f += 4*3*dot3
    if flat:
        f += dv
    else:
        if conic:                                   # kz, u.y, y.y, u.u, e
            f += 3*o["mul"] + 2*dot3 + 2*o["add"] + 3*o["sqr"]
        else:
            f += 2*dot3
        f += (3*o["mul"] + 3*o["add"] + o["scale"] + o["sqr"]  # d, f, disc
              + sq + o["add"] + dv)                 # g, num or den, s
    f += 3*(o["mul"] + o["add"])                    # the transfer
    if step["clip"] and step["radius"] is not None:
        f += 3
    if step["kind"]:
        unit = flat or not conic
        if not flat:                                # nx, ny, nz, u.N
            f += 3*o["mul"] + o["add"] + dot3
            if conic:
                f += 3*o["sqr"] + 2*o["add"]        # |N|^2
        if step["kind"] == 2:
            f += o["scale"] + (0 if unit else dv)
            f += o["add"] if flat else 3*(o["mul"] + o["add"])
        else:
            f += o["sqr"] + o["add"]                # mu^2 - 1
            f += o["mul"] if unit else dv + 3*o["mul"]
            f += o["sqr"] + 2*o["add"] + sq         # g
            f += (3*o["mul"] + o["add"]) if flat else 3*(2*o["mul"]
                                                         + o["add"])
    if path:
        f += o["mul"] + o["add"]
    return f


def df32_chain_ops(steps, path=False):
    """float32 operations of one ray through a plan (trace_df), the last
    frame's rotation included."""
    last = 2*3*(3*DF_OPS["mul"] + 2*DF_OPS["add"]) \
        if steps[-1]["rot_df"] is not None else 0
    return sum(df32_step_ops(st, path) for st in steps) + last


# a live ray's five df32 moments in K12/K13: count, x, y (an add each),
# x^2 and y^2 (a mul and an add each)
DF32_MOMENT_OPS = 3*DF_OPS["add"] + 2*(DF_OPS["mul"] + DF_OPS["add"])


def df32_bound(name, n, plans, live):
    """(bound_ms, bound_by) of one df32 launch at n rays through `plans`
    (one plan for K10/K12, one a wavelength for K11/K13; K10/K11 with
    the optical path): 12 float32 words read a ray, 14 written a ray and
    plan (K10/K11) or 10 a block and plan (K12/K13, on the wrappers'
    grid), the plans' words and flags, over the HBM rate; the float32
    operations of df32_chain_ops (and DF32_MOMENT_OPS for each of the
    `live` rays, summed over plans) over 67 TFLOP/s, the float32 peak
    outside the tensor cores, as kernel_bound counts (one operation a
    flop)."""
    from rayopt_tpu_torch.ops.cuda_df32 import DW
    from rayopt_tpu_torch.ops.cuda_trace import BLOCK, BLOCKS_PER_SM
    merit = "merit" in name
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = max(1, min(-(-n // BLOCK), sms*BLOCKS_PER_SM))
    nlam = len(plans)
    out = grid*10*nlam if merit else n*14*nlam
    nbytes = (n*12 + out + nlam*len(plans[0])*(DW + 1))*4
    flops = n*sum(df32_chain_ops(p, path=not merit) for p in plans)
    if merit:
        flops += live*DF32_MOMENT_OPS
    t_bytes, t_ops = nbytes/PEAK_BYTES, flops/PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops)*1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


DF32_REPLACES = {
    "trace_final_df32": "rayopt_tpu/ops/df32.py:1094",
    "trace_multi_df32": "rayopt_tpu/ops/df32.py:1140",
    "trace_merit_df32": "rayopt_tpu/ops/df32.py:1285",
    "trace_merit_multi_df32": "rayopt_tpu/ops/df32.py:1321"}


def df32_entries(s, launches, worst, times, live):
    """The kernels-line entries of K10-K13: `ms`/`plain_ms` with the fast
    plan at N_GRAD_TIME rays, `ms_exact`/`plain_ms_exact` with the exact
    one, the N_BENCH times beside them; no float64 instance."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    tabs = s.tables()
    nlam = tabs.curvature.shape[0]
    entries = []
    for kname in DF32_NAMES:
        multi = "multi" in kname
        lam = nlam if multi else 1
        entry = {"name": kname, "route": "cuda",
                 "source": "rayopt_tpu_torch/csrc/df32.cu",
                 "replaces": DF32_REPLACES[kname],
                 "launches": launches[kname], "max_abs_err": worst[kname]}
        for plan in ("fast", "exact"):
            tabs_used = [table_at(tabs, li) for li in range(lam)] if multi \
                else [s.table()]
            plans = [D.plan(t, fast=plan == "fast") for t in tabs_used]
            sfx = "" if plan == "fast" else "_exact"
            k, p, t = times[(kname, plan, N_GRAD_TIME)]
            bound_ms, bound_by = df32_bound(kname, N_GRAD_TIME, plans,
                                            live[N_GRAD_TIME]*lam)
            entry.update({"ms" + sfx: k, "plain_ms" + sfx: p,
                          "bound_ms" + sfx: bound_ms})
            if plan == "fast":
                entry.update({"bound_by": bound_by, "library_ms": None,
                              "ms_f64": None, "plain_ms_f64": None,
                              "bound_ms_f64": None, "rays": N_GRAD_TIME,
                              "wavelengths": lam})
            big = times[(kname, plan, N_BENCH)]
            entry["ms%s_%d_rays" % (sfx, N_BENCH)] = big[0]
            entry["bound_ms%s_%d_rays" % (sfx, N_BENCH)] = df32_bound(
                kname, N_BENCH, plans, live[N_BENCH]*lam)[0]
            if multi:
                entry["twin_ms" + sfx] = t
                entry["twin_ms%s_%d_rays" % (sfx, N_BENCH)] = big[2]
        if kname == "trace_final_df32":
            entry["f64_trace_final_ms"] = times[("f64_trace_final",
                                                 N_GRAD_TIME)]
            entry["f64_trace_final_ms_%d_rays" % N_BENCH] = times[
                ("f64_trace_final", N_BENCH)]
        entries.append(entry)
    return entries


def main():
    name, card = phase_card()
    phase_build()
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs, trace_merit
    from rayopt_tpu_torch.ops.kernels import specialize
    s = double_gauss()
    table = s.table()           # the default device: the card
    specs = specialize(table)   # from the float64 table
    tabs = s.tables()           # 3 wavelengths
    mspecs = multi_specs(tabs, None)
    ptxas = phase_spec_build(spec_keys(specs, [
        (name, specialize(tab)) for name, _, tab, _ in intercept_cases()]))
    worst = phase_check(table, specs)
    phase_spec_check(table, specs)
    worst.update(phase_grad_check(table, specs))
    phase_fd_check(table, specs)
    worst.update(phase_multi_check(tabs, mspecs))
    phase_glass_fd_check(s, tabs, mspecs)
    worst.update(phase_opd_check(s, table, specs))
    phase_opd_fd_check(s, table, specs)
    worst.update(phase_df32_check(s))
    phase_intercept()
    reset_launches()
    aimed = phase_main_path()
    launches = read_launches()
    log("== launch counts on the forward main path: %s" % launches)
    if not (launches["trace_final"] and launches["trace_merit"]):
        raise AssertionError("a kernel of the main path never launched: "
                             "%s" % launches)
    reset_launches()
    phase_df32_path(s, aimed)
    df32_launches = read_launches()
    log("== launch counts on the parity-grade df32 path: %s" % df32_launches)
    if not all(df32_launches[k] for k in DF32_NAMES):
        raise AssertionError("a kernel of the df32 path never launched: %s"
                             % df32_launches)
    launches.update({k: df32_launches[k] for k in DF32_NAMES})
    del aimed
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in phase_opt_path().items()
                     if k in ("weighted_moments", "merit_adjoint")})
    reset_launches()
    phase_glass_path()
    glass_launches = read_launches()
    log("== launch counts on the achromatization path: %s" % glass_launches)
    multi = ("trace_multi", "weighted_moments_multi", "merit_adjoint_multi")
    if not all(glass_launches[k] for k in multi):
        raise AssertionError("a kernel of the achromatization path never "
                             "launched: %s" % glass_launches)
    launches.update({k: glass_launches[k] for k in multi})
    design_launches = phase_design_path()
    opd = ("opd_chain", "opd_adjoint")
    launches.update({k: design_launches[k] for k in opd})
    times = phase_throughput(table, specs, card)
    gtimes = phase_grad_throughput(table, specs, card)
    mtimes, mlive = phase_multi_throughput(tabs, mspecs, card)
    otimes, olive = phase_opd_throughput(s, table, specs, card)
    dtimes, dlive = phase_df32_throughput(s, card)
    # live rays of the K5 timing bundles (its reverse runs for these only)
    live_mono = float(trace_merit(table, specs, bench_bundle(
        N_GRAD_TIME, torch.float32, SEED + 1))[0])
    live_opt = float(trace_merit(table, specs, bench_bundle(
        N_OPT_BUNDLE, torch.float64, SEED + 1))[0])
    trace_cu, grad_cu, spec_cuh = ("rayopt_tpu_torch/csrc/trace.cu",
                                   "rayopt_tpu_torch/csrc/grad.cu",
                                   "rayopt_tpu_torch/csrc/grad_spec.cuh")
    sources = {
        "trace_final": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:82"),
        "trace_merit": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:170"),
        "weighted_moments": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:236"),
        "merit_adjoint": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:395"),
        "trace_multi": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:284"),
        "weighted_moments_multi": (grad_cu,
                                   "rayopt_tpu/ops/pallas_grad.py:248"),
        "merit_adjoint_multi": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:421"),
        "opd_chain": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:1077"),
        "opd_adjoint": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:1094")}
    nlam = tabs.curvature.shape[0]
    kernels = []
    for kname, (source, replaces) in sources.items():
        if kname in multi:
            tt, rays, lam, live = mtimes, N_GRAD_TIME, nlam, \
                mlive[torch.float32]
        elif kname in ("weighted_moments", "merit_adjoint"):
            tt, rays, lam, live = gtimes, N_GRAD_TIME, 1, live_mono
        elif kname in opd:
            tt, rays, lam, live = otimes, N_GRAD_TIME, 1, olive
        else:
            tt, rays, lam, live = times, N_BENCH, 1, 0
        k32, p32 = tt[(kname, torch.float32)][:2]
        k64, p64 = tt[(kname, torch.float64)][:2]
        kspecs = mspecs if lam > 1 else specs
        bound_ms, bound_by = kernel_bound(kname, rays, torch.float32,
                                          kspecs, lam, live)
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a ray trace
            "library_ms": None,
            "ms_f64": k64, "plain_ms_f64": p64,
            "bound_ms_f64": kernel_bound(kname, rays, torch.float64, kspecs,
                                         lam, live)[0],
            "rays": rays, "wavelengths": lam}
        if kname in ("weighted_moments", "merit_adjoint"):
            k = "K4" if kname == "weighted_moments" else "K5"
            main_key = " clip=False optimizer rays=False" if k == "K5" \
                else " clip=False"
            for dt in ("float32", "float64"):
                regs, stack, spill = ptxas["%s %s%s" % (k, dt, main_key)]
                sfx = "" if dt == "float64" else "_f32"
                entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                              "spill_bytes" + sfx: spill})
            big = "_%d_rays" % N_OPT_BUNDLE
            entry["ms_f64" + big] = tt[(kname, N_OPT_BUNDLE)]
            entry["bound_ms_f64" + big] = kernel_bound(
                kname, N_OPT_BUNDLE, torch.float64, specs, 1, live_opt)[0]
            if kname == "merit_adjoint":
                opt = "merit_adjoint_optimizer"
                entry.update({
                    "ms_optimizer": tt[(opt, torch.float32)],
                    "ms_optimizer_f64": tt[(opt, torch.float64)],
                    "ms_optimizer_f64" + big: tt[(opt, N_OPT_BUNDLE)],
                    "bound_ms_optimizer_f64" + big: kernel_bound(
                        opt, N_OPT_BUNDLE, torch.float64, specs, 1,
                        live_opt)[0]})
        if kname in multi:
            entry["twin_ms"] = tt[(kname, torch.float32)][2]
            entry["twin_ms_f64"] = tt[(kname, torch.float64)][2]
            entry["twin_ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH,
                                                         "twin")]
        if tt is not times:
            entry["ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH)]
        kernels.append(entry)
    kernels += df32_entries(s, launches, worst, dtimes, dlive)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
