"""Chip smoke test of rayopt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout, holds each
against its plain PyTorch version on the card, drives the port's main
path (double Gauss from YAML -> paraxial solve -> pupil aiming ->
fused trace and fused spot-moment merit at three fields) and times
the kernels against their plain versions.  Every phase raises on a
failure; the script exits non-zero and prints no result without a
CUDA device.  The last line of stdout is the device JSON.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_CHECK = 1 << 20    # rays in the kernel-vs-plain checks
N_AIMED = 1 << 22    # rays per field on the main path
N_BENCH = 1 << 26    # rays in the throughput phase
FIELDS = (0., .7, 1.)
SEED = 0

# tolerances (kernel vs plain on the card, live rays)
F64_REL = 1e-12      # float64: max |a - b| / max(1, max |b|) per output
F32_ABS = 5e-5       # float32: mm for positions, unitless directions
F32_T_REL = 1e-5     # float32 optical path t (~200 mm) relative
F32_NAN_FRAC = 1e-5  # float32: share of rays whose NaN masks differ
F32_MOM_REL = 1e-4   # float32 moment sums, relative to their scale
PARITY_REL = 1e-9    # float64 K1 spot RMS vs the CPU float64 trace


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


def main():
    name, card = phase_card()
    phase_build()
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops import cuda_trace
    table = double_gauss().table()
    specs = specialize(table)   # from the float64 table
    worst = phase_check(table, specs)
    cuda_trace.trace_final.launches = 0
    cuda_trace.trace_merit.launches = 0
    phase_main_path()
    launches = {"trace_final": cuda_trace.trace_final.launches,
                "trace_merit": cuda_trace.trace_merit.launches}
    log("== launch counts on the main path: %s" % launches)
    if not all(launches.values()):
        raise AssertionError("a kernel of the main path never launched: "
                             "%s" % launches)
    times = phase_throughput(table, specs, card)
    replaces = {"trace_final": "rayopt_tpu/ops/pallas_trace.py:82",
                "trace_merit": "rayopt_tpu/ops/pallas_trace.py:170"}
    kernels = []
    for kname in ("trace_final", "trace_merit"):
        k32, p32 = times[(kname, torch.float32)]
        k64, p64 = times[(kname, torch.float64)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "rayopt_tpu_torch/csrc/trace.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "ms_f64": k64, "plain_ms_f64": p64, "rays": N_BENCH})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
