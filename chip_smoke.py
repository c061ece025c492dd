"""Chip smoke test of rayopt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each
against its plain PyTorch version on the card, drives the port's two
main paths -- the forward path (double Gauss from YAML -> paraxial
solve -> pupil aiming -> fused trace and fused spot-moment merit at
three fields) and the designer loop (bundles at 3 fields x 3
wavelengths -> optimize_grad on the weighted-moment and adjoint
kernels -> write back) -- and times the kernels against their plain
versions.  Every phase raises on a failure; the script exits non-zero
and prints no result without a CUDA device.  The last line of stdout
is the device JSON.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_CHECK = 1 << 20    # rays in the kernel-vs-plain checks
N_AIMED = 1 << 22    # rays per field on the main path
N_BENCH = 1 << 26    # rays in the throughput phase
N_OPT = 1 << 20      # hexapolar nrays a bundle on the optimizer path
N_GRAD_TIME = 1 << 22  # rays in the K4/K5 kernel-vs-plain timings
FIELDS = (0., .7, 1.)
SEED = 0
OPT_SELECT = ("curvature", "distance")
OPT_STEPS = 10
OPT_LR = 1e-7        # Adam: the merit falls at every step on the CPU
FD_STEP = {"curvature": 1e-8, "distance": 1e-6}   # 1/mm, mm

# tolerances (kernel vs plain on the card, live rays)
F64_REL = 1e-12      # float64: max |a - b| / max(1, max |b|) per output
F32_ABS = 5e-5       # float32: mm for positions, unitless directions
F32_T_REL = 1e-5     # float32 optical path t (~200 mm) relative
F32_NAN_FRAC = 1e-5  # float32: share of rays whose NaN masks differ
F32_MOM_REL = 1e-4   # float32 moment sums, relative to their scale
PARITY_REL = 1e-9    # float64 K1 spot RMS vs the CPU float64 trace
GRAD_F64_REL = 1e-9  # float64 K5 cotangents, of their field's/kind's max
GRAD_F32_REL = 1e-3  # float32 K5 on axis: sums of 2^20 float32 terms
F32_RAY_REL = 1e-2   # float32 K5 ray cotangents: a float32 image
#                      coordinate carries K1's ~2e-5 mm on a ~0.03 mm
#                      spot, twice that on the weight cotangent's squares
FD_REL = 1e-5        # float64 K5 vs central differences of the K4 merit
OPT_MERIT_REL = 1e-9  # optimizer step 0 merit, card vs CPU plain
OPT_GRAD_REL = 1e-8   # optimizer step 0 gradient, of its field's max


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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(n, dtype=torch.float64, device="cuda")
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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.empty(n, dtype=torch.float64, device="cuda")
    w.uniform_(.5, 1.5, generator=gen)
    return (w/w.sum()).to(dtype)


def rms_cotangent(mom):
    """d spot_rms / d (the five weighted moments), in mom's dtype."""
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    m = mom.detach().double().requires_grad_()
    spot_rms_from_moments(*m).backward()
    return m.grad.to(mom.dtype)


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


def compare_ray_grads(got, got_w, want, want_w):
    """(max relative error, rays live in one version only, all finite)
    of the ray-state and weight cotangents.  Each kind (positions,
    directions, weights) is held to its largest plain value: an
    element-wise relative test fails on analytically zero entries (the
    initial z of a collimated ray).  A dead ray's cotangents are all
    zero, so a nonzero weight cotangent marks a live ray."""
    live_g, live_w = got_w != 0, want_w != 0
    both = live_g & live_w
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
    """The port's main path, through the entry points a user calls."""
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
    table = s.table()
    specs = specialize(table)
    log("System: EFL %.8f, %d surfaces, %.2f s"
        % (s.paraxial.focal_length[1], len(s), time.perf_counter() - t0))
    rng = np.random.RandomState(SEED)
    failures = []
    for field in FIELDS:
        t0 = time.perf_counter()
        z, p = s.pupil((0., field))
        r = np.sqrt(rng.uniform(0, 1, N_AIMED))
        th = rng.uniform(0, 2*np.pi, N_AIMED)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., field), yp, z, p, filter=False)
        t_aim = time.perf_counter() - t0
        yc = torch.from_numpy(y0).cuda()
        uc = torch.from_numpy(u0).cuda()
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
        yh, uh, _ = trace_rays_final_fast(table, torch.from_numpy(y0),
                                          torch.from_numpy(u0), clip=False)
        rms_cpu, live_cpu = spot_rms(yh, uh)
        mom_cpu = trace_merit(table, specs, tuple(c.cpu() for c in state64),
                              clip=False)
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
    if failures:
        raise AssertionError("main path parity failed at " +
                             ", ".join(failures))


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
    table = s.table()
    on_card = bundles_to(bundles, "cuda")
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
    tab_opt, hist = optimize_grad(table, on_card, select=OPT_SELECT,
                                  steps=OPT_STEPS, lr=OPT_LR,
                                  engine="adjoint", callback=keep("card"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    steps = np.diff([t0] + ends[:OPT_STEPS])
    launches = read_launches()
    t0 = time.perf_counter()
    _, hist_cpu = optimize_grad(table, bundles, select=OPT_SELECT, steps=1,
                                lr=OPT_LR, engine="adjoint",
                                callback=keep("cpu"))
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


def _wrappers():
    from rayopt_tpu_torch.ops import cuda_grad, cuda_trace
    return (cuda_trace.trace_final, cuda_trace.trace_merit,
            cuda_grad.weighted_moments, cuda_grad.merit_adjoint)


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
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments, weighted_moments_reference, merit_adjoint,
        merit_adjoint_reference)
    nsurf = table.curvature.shape[0] - 1
    log("== K4/K5 throughput: %d bench rays against the plain versions, "
        "then %d rays kernel alone, %d traced surfaces (%s)"
        % (N_GRAD_TIME, N_BENCH, nsurf, card))

    def pairs(state, w, ct):
        return (
            ("weighted_moments",
             lambda: weighted_moments(table, specs, state, w),
             lambda: weighted_moments_reference(table, specs, state, w)),
            ("merit_adjoint",
             lambda: merit_adjoint(table, specs, state, w, ct),
             lambda: merit_adjoint_reference(table, specs, state, w, ct)))
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
        del state, w
        torch.cuda.empty_cache()
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


def main():
    name, card = phase_card()
    phase_build()
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.kernels import specialize
    table = double_gauss().table()
    specs = specialize(table)   # from the float64 table
    worst = phase_check(table, specs)
    worst.update(phase_grad_check(table, specs))
    phase_fd_check(table, specs)
    reset_launches()
    phase_main_path()
    launches = read_launches()
    log("== launch counts on the main path: %s" % launches)
    if not (launches["trace_final"] and launches["trace_merit"]):
        raise AssertionError("a kernel of the main path never launched: "
                             "%s" % launches)
    launches.update({k: v for k, v in phase_opt_path().items()
                     if k in ("weighted_moments", "merit_adjoint")})
    times = phase_throughput(table, specs, card)
    gtimes = phase_grad_throughput(table, specs, card)
    sources = {"trace_final": ("rayopt_tpu_torch/csrc/trace.cu",
                               "rayopt_tpu/ops/pallas_trace.py:82"),
               "trace_merit": ("rayopt_tpu_torch/csrc/trace.cu",
                               "rayopt_tpu/ops/pallas_trace.py:170"),
               "weighted_moments": ("rayopt_tpu_torch/csrc/grad.cu",
                                    "rayopt_tpu/ops/pallas_grad.py:236"),
               "merit_adjoint": ("rayopt_tpu_torch/csrc/grad.cu",
                                 "rayopt_tpu/ops/pallas_grad.py:395")}
    kernels = []
    for kname, (source, replaces) in sources.items():
        grad = kname in ("weighted_moments", "merit_adjoint")
        tt = gtimes if grad else times
        k32, p32 = tt[(kname, torch.float32)]
        k64, p64 = tt[(kname, torch.float64)]
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "ms_f64": k64, "plain_ms_f64": p64,
            "rays": N_GRAD_TIME if grad else N_BENCH}
        if grad:
            entry["ms_f32_%d_rays" % N_BENCH] = gtimes[(kname, N_BENCH)]
        kernels.append(entry)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
