"""Chip smoke test of rayopt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each
against its plain PyTorch version on the card, drives the port's three
main paths -- the forward path (double Gauss from YAML -> paraxial
solve -> pupil aiming -> fused trace and fused spot-moment merit at
three fields), the designer loop (bundles at 3 fields x 3
wavelengths -> optimize_grad on the weighted-moment and adjoint
kernels -> write back) and the achromatization path (stacked
3-wavelength tables -> glass relaxation -> polychromatic union spot
RMS on the stacked-wavelength kernels at 3 fields -> Adam over
curvatures, distances and glasses, with the stacked trace reporting
the spots) -- and times the kernels against their plain versions (the
stacked-wavelength ones also against their monochromatic twins).
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
N_GLASS = 1 << 20    # hexapolar nrays a field on the achromatization path
FIELDS = (0., .7, 1.)
SEED = 0
OPT_SELECT = ("curvature", "distance")
OPT_STEPS = 10
OPT_LR = 1e-7        # Adam: the merit falls at every step on the CPU
FD_STEP = {"curvature": 1e-8, "distance": 1e-6}   # 1/mm, mm
FD_VD_STEP = 1e-3    # Abbe number
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
    table = s.table()                    # the default device: the card
    table_cpu = s.table(device="cpu")    # the CPU reference
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


def phase_multi_check(tabs, specs):
    """K3, K6 and K7 against their plain versions on the card."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments_multi, weighted_moments_multi_reference,
        merit_adjoint_multi, merit_adjoint_multi_reference,
        union_spot_rms_from_moments)
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_multi, trace_multi_reference, spot_rms_from_moments)
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
            ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr)
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


def _wrappers():
    from rayopt_tpu_torch.ops import cuda_grad, cuda_trace
    return (cuda_trace.trace_final, cuda_trace.trace_merit,
            cuda_grad.weighted_moments, cuda_grad.merit_adjoint,
            cuda_trace.trace_multi, cuda_grad.weighted_moments_multi,
            cuda_grad.merit_adjoint_multi)


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


def kernel_bound(name, n, dtype, specs, nlam=1, live=0):
    """(bound_ms, bound_by) of one launch at n rays: the larger of the
    bytes it must move (each input read once, each output written once)
    over the HBM rate and its operations over the dtype's peak.  The
    reverse sweeps of K5/K7 run only for live rays (`live`: live ray
    traces, summed over wavelengths) and are counted as 3x the forward
    chain (PERF.md's estimate for the adjoint) plus the seeding."""
    word = 4 if dtype == torch.float32 else 8
    chain = chain_flops(specs)
    words_in, words_out, flops = {
        "trace_final": (6, 7, n*chain),
        "trace_merit": (6, 0, n*(chain + 7)),
        "trace_multi": (6, 0, n*nlam*(chain + 7)),
        "weighted_moments": (7, 0, n*(chain + 11)),
        "weighted_moments_multi": (7, 0, n*nlam*(chain + 11)),
        "merit_adjoint": (7, 7, n*chain + live*(3*chain + 11)),
        "merit_adjoint_multi": (7, 7, n*nlam*chain + live*(3*chain + 11)),
    }[name]
    nbytes = (n*(words_in + words_out) + nlam*len(specs)*17)*word \
        + 4*len(specs)
    t_bytes, t_ops = nbytes/PEAK_BYTES, flops/PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops)*1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


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
    worst = phase_check(table, specs)
    worst.update(phase_grad_check(table, specs))
    phase_fd_check(table, specs)
    worst.update(phase_multi_check(tabs, mspecs))
    phase_glass_fd_check(s, tabs, mspecs)
    reset_launches()
    phase_main_path()
    launches = read_launches()
    log("== launch counts on the forward main path: %s" % launches)
    if not (launches["trace_final"] and launches["trace_merit"]):
        raise AssertionError("a kernel of the main path never launched: "
                             "%s" % launches)
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
    times = phase_throughput(table, specs, card)
    gtimes = phase_grad_throughput(table, specs, card)
    mtimes, mlive = phase_multi_throughput(tabs, mspecs, card)
    # live rays of the K5 timing bundle (its reverse runs for these only)
    live_mono = float(trace_merit(table, specs, bench_bundle(
        N_GRAD_TIME, torch.float32, SEED + 1))[0])
    trace_cu, grad_cu = ("rayopt_tpu_torch/csrc/trace.cu",
                         "rayopt_tpu_torch/csrc/grad.cu")
    sources = {
        "trace_final": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:82"),
        "trace_merit": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:170"),
        "weighted_moments": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:236"),
        "merit_adjoint": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:395"),
        "trace_multi": (trace_cu, "rayopt_tpu/ops/pallas_trace.py:284"),
        "weighted_moments_multi": (grad_cu,
                                   "rayopt_tpu/ops/pallas_grad.py:248"),
        "merit_adjoint_multi": (grad_cu, "rayopt_tpu/ops/pallas_grad.py:421")}
    nlam = tabs.curvature.shape[0]
    kernels = []
    for kname, (source, replaces) in sources.items():
        if kname in multi:
            tt, rays, lam, live = mtimes, N_GRAD_TIME, nlam, \
                mlive[torch.float32]
        elif kname in ("weighted_moments", "merit_adjoint"):
            tt, rays, lam, live = gtimes, N_GRAD_TIME, 1, live_mono
        else:
            tt, rays, lam, live = times, N_BENCH, 1, 0
        k32, p32 = tt[(kname, torch.float32)][:2]
        k64, p64 = tt[(kname, torch.float64)][:2]
        bound_ms, bound_by = kernel_bound(kname, rays, torch.float32,
                                          mspecs if lam > 1 else specs, lam,
                                          live)
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a ray trace
            "library_ms": None,
            "ms_f64": k64, "plain_ms_f64": p64, "rays": rays,
            "wavelengths": lam}
        if kname in multi:
            entry["twin_ms"] = tt[(kname, torch.float32)][2]
            entry["twin_ms_f64"] = tt[(kname, torch.float64)][2]
            entry["twin_ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH,
                                                         "twin")]
        if tt is not times:
            entry["ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH)]
        kernels.append(entry)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
