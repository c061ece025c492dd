"""Kernel and step times of the port on one CUDA card, to compare two
trees of the port on the same card in one call.

    python -m rayopt_tpu_torch.utils.kernel_times [--variants] [--steps N]

Times, with CUDA events (the mean of many launches after a warm-up),
on the double Gauss and the bench bundle (x, y uniform in +-11.6 mm,
u = (0, 0, 1)):

* K1 trace_final, K4 weighted_moments and K5 merit_adjoint (all
  fields, the ray cotangents written: the work every tree's K5 does)
  in float32 and float64 at 2^22 rays, float64 at one optimizer
  bundle's 1,046,071 rays and float32 at 2^26 rays; K5 for the
  optimizer's slot set without ray cotangents too, where the tree's
  merit_adjoint takes `fields` and `rays`;
* the optimizer step (optimize_grad(engine="adjoint"), 9 hexapolar
  bundles of nrays 2^20 at 3 fields x 3 wavelengths, float64, Adam lr
  1e-7 on curvature and distance) and the design step (those 9 spot
  bundles, 3 wavefront bundles and 1e-4 x the focal-length penalty):
  wall milliseconds of the steps after the first.

It calls the wrappers with the positional arguments every tree of the
port takes, so it also measures an older tree: copy this file into
that tree's rayopt_tpu_torch/utils/ and run it from that tree's root.
--variants (this tree only) times K5 for the optimizer's slot set in
float64 and float32 at other block sizes and launch bounds.  Prints
one JSON object; needs a CUDA card.
"""

import argparse
import inspect
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_OPT_BUNDLE = 1046071
SIZES = ((torch.float32, 1 << 22), (torch.float64, 1 << 22),
         (torch.float64, N_OPT_BUNDLE), (torch.float32, 1 << 26))
NRAYS = 1 << 20      # hexapolar nrays a bundle of the steps
OPT_SELECT = ("curvature", "distance")
OPT_FIELDS = ("curvature", "offset")


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


def bench_bundle(n, dtype, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(n, dtype=torch.float64, device="cuda")
    y = torch.empty_like(x)
    x.uniform_(-11.6, 11.6, generator=gen)
    y.uniform_(-11.6, 11.6, generator=gen)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    w = torch.empty_like(x).uniform_(.5, 1.5, generator=gen)
    return (tuple(c.to(dtype).contiguous() for c in (x, y, zero, zero, zero,
                                                     one)),
            (w/w.sum()).to(dtype))


def rms_cotangent(mom):
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    m = mom.detach().double().requires_grad_()
    spot_rms_from_moments(*m).backward()
    return m.grad.to(mom.dtype).contiguous()


def kernel_times(table, specs):
    from rayopt_tpu_torch.ops.cuda_grad import merit_adjoint, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import trace_final
    sliced = "fields" in inspect.signature(merit_adjoint).parameters
    out = {}
    for dtype, n in SIZES:
        state, w = bench_bundle(n, dtype)
        ct = rms_cotangent(weighted_moments(table, specs, state, w))
        reps = 10 if n > 1 << 22 else 20
        cases = {
            "K1": lambda: trace_final(table, specs, state),
            "K4": lambda: weighted_moments(table, specs, state, w),
            "K5": lambda: merit_adjoint(table, specs, state, w, ct)}
        if sliced:
            cases["K5 optimizer"] = lambda: merit_adjoint(
                table, specs, state, w, ct, fields=OPT_FIELDS, rays=False)
        for name, fn in cases.items():
            out["%s %s %d" % (name, str(dtype)[6:], n)] = cuda_ms(fn, reps)
        del state, w
        torch.cuda.empty_cache()
    return out


def variant_times(specs, table):
    """K5 for the optimizer's slot set at each block size and launch
    bound, float64 at N_OPT_BUNDLE rays and float32 at 2^22."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import _packed, weighted_moments
    variants = [(dt, b, m) for dt in (torch.float64, torch.float32)
                for b, m in ((64, 1), (128, 1), (256, 1), (128, 2), (128, 3),
                             (128, 4))]
    keys = {v: CS.adjoint_key(specs, v[0], False, OPT_FIELDS, False,
                              block=v[1], min_blocks=v[2]) for v in variants}
    built = CS.prebuild(list(keys.values()))
    out = {}
    for (dtype, block, minb), key in keys.items():
        kern = built[key]
        n = N_OPT_BUNDLE if dtype == torch.float64 else 1 << 22
        state, w = bench_bundle(n, dtype)
        ct = rms_cotangent(weighted_moments(table, specs, state, w))
        x = state[0]
        packed = _packed(table, specs, x)
        grid = kern.grid(n, x.device)
        pg = torch.empty((len(specs), 6), dtype=dtype, device=x.device)
        part = torch.empty((grid, key.nlive), dtype=dtype, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            kern.check(kern.fn(packed.data_ptr(),
                               *(c.data_ptr() for c in state), w.data_ptr(),
                               ct.data_ptr(), part.data_ptr(),
                               CS.counter(x.device).data_ptr(),
                               pg.data_ptr(), *(None,)*7, n, grid, stream))
        regs = [ln for ln in kern.ptxas_lines() if "registers" in ln
                or "stack frame" in ln]
        out["K5 optimizer %s %d block %d min_blocks %d" % (
            str(dtype)[6:], n, block, minb)] = {
                "ms": cuda_ms(run, 20), "grid": grid,
                "blocks_per_sm": kern.blocks_per_sm(x.device),
                "ptxas": regs}
        del state, w
    return out


def step_times(steps):
    """Wall ms of the optimizer and design steps after the first."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_spot_rms,
                                                adjoint_wavefront_rms)
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.parallel import (bundles_from_system,
                                           composite_merit,
                                           first_order_penalty,
                                           optimize_grad, paraxial_seed)
    s = double_gauss()
    t0 = time.perf_counter()
    spot = bundles_from_system(s, nrays=NRAYS, distribution="hexapolar")
    wave = bundles_from_system(s, wavelengths=[s.wavelengths[0]],
                               nrays=NRAYS, distribution="hexapolar")
    aim_s = time.perf_counter() - t0
    table = s.table()
    specs = specialize(table)
    seed = paraxial_seed(s)
    efl0 = float(s.paraxial.focal_length[1])
    opd_kw = dict(ref=0, radius=-s.image.pupil.distance,
                  wavelength=s.wavelengths[0], scale=s.scale,
                  finite=s.object.finite, specs=specs)

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
        return 1e-4*first_order_penalty(tab, seed,
                                        {"focal_length": (1, efl0)})
    out = {"aim_s": aim_s}
    for name, merit in (("optimizer", None),
                        ("design", composite_merit(spots, wavefronts,
                                                   penalty))):
        ends = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            kw = dict(merit=merit) if merit else dict(engine="adjoint")
            optimize_grad(table, spot, select=OPT_SELECT, steps=steps,
                          lr=1e-7, callback=lambda i, v, p: ends.append(
                              time.perf_counter()), **kw)
        ms = np.diff([t0] + ends)*1e3
        out[name + "_step_ms"] = [float(v) for v in ms[1:]]
        out[name + "_step_ms_mean"] = float(ms[1:].mean())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.kernels import specialize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    table = double_gauss().table()
    specs = specialize(table)
    out = {"card": card, "kernels_ms": kernel_times(table, specs)}
    out.update(step_times(args.steps))
    if args.variants:
        out["variants"] = variant_times(specs, table)
    print(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
