"""Kernel and step times of the port on one CUDA card, to compare two
trees of the port on the same card in one call.

    python -m rayopt_tpu_torch.utils.kernel_times [--variants] [--steps N]
                                                  [--df32] [--multi]
                                                  [--long-plan] [--newton]
                                                  [--registers] [--freeform]
    python -m rayopt_tpu_torch.utils.kernel_times --compare A.json B.json

Times, with CUDA events (the mean of many launches after a warm-up),
on the double Gauss and the bench bundle (x, y uniform in +-11.6 mm,
u = (0, 0, 1)):

* K1 trace_final, K2 trace_merit, K4 weighted_moments, K5
  merit_adjoint, K6 weighted_moments_multi and K7 merit_adjoint_multi
  (the 3-wavelength stack), K8 opd_chain and K9 opd_adjoint (ray 0 the
  chief ray, K9 with the wavefront-RMS cotangents), the adjoints for
  all fields with the
  ray cotangents written (the work every tree's adjoints do), in
  float32 and float64 at 2^22 rays, float64 at one loop bundle's
  1,046,071 rays and float32 at 2^26 rays, and K1 and K2 in float64 at
  2^26 rays; each adjoint also for its loop's slot set without ray
  cotangents (K5 the optimizer's, K7 the achromatization path's, K9 the
  design path's), where the tree's wrapper takes `fields` and `rays`;
* the optimizer step (optimize_grad(engine="adjoint"), 9 hexapolar
  bundles of nrays 2^20 at 3 fields x 3 wavelengths, float64, Adam lr
  1e-7 on curvature and distance), the design step (those 9 spot
  bundles, 3 wavefront bundles and 1e-4 x the focal-length penalty)
  and the achromatization step (the union polychromatic spot RMS of 3
  hexapolar bundles at 3 fields x 3 wavelengths, float64, Adam over
  curvatures, distances and the 6 glasses' box logits): wall
  milliseconds of the steps after the first;
* the df32 kernels: K10 trace_final_df32 (with the optical path) and
  K12 trace_merit_df32 on the first wavelength's plan, K11
  trace_multi_df32 (with the path) and K13 trace_merit_multi_df32 on
  the 3 wavelengths' plans, fast and exact plans, at 2^22 and 2^26
  rays (--df32 times these alone);
* K3 trace_multi, merit and trace, on the 3-wavelength stack in
  float32 and float64 at 2^22 and 2^26 rays, with K6 and K7 at 2^22
  float32 beside them as controls (--multi times these alone).

It calls the wrappers with the positional arguments every tree of the
port takes, so it also measures an older tree: copy this file into
that tree's rayopt_tpu_torch/utils/ and run it from that tree's root.
--variants (this tree only) times the loops' keys of K5, K7 and K9 in
float64 and float32 at other block sizes and launch bounds, and K2
(the double Gauss) and K6 (the 3-wavelength stack, the achromatization
path's key) at 128, 256 and 512 threads a block, K1 and K8 (unclipped)
at 128, 256 and 512 threads a block in float64 at 2^22 and 1,046,071
rays and in both dtypes at 2^26, through the wrapper and as the bare
launch, and K6 on stacks of NLAMS
wavelengths (400-700 nm) against as many launches of K4, with each K6
build's registers and spills; and K11 and K13 (the fast plans of the 3
wavelengths) reading their plan words straight from the kernel's
parameters and from a copy in shared memory, at 128, 256 and 512
threads a block (the direct form also at launch bounds of 3 blocks of
256 and 2 of 512), and K10 and K12 (the first of those plans) in those
two placements and from a device copy (device words), at the same
blocks and more launch bounds, through the wrapper and as the bare
launch, with each build's registers and SASS size (with --df32, these
variants alone).  --long-plan alone builds K10 and K12 for a 300-step
plan (the Cooke triplet's repeated), whose words take the device-words
placement, and reports their nvcc time, registers, SASS size, words
against the plain versions and ms.  --variants also sweeps K3's trace
in both loop orders (cuda_spec.trace_multi_key's `outer`) at 256 and
512 threads a block and its merit at 128, 256 and 512, as the bare
launch at K3's sizes, with each build's registers, stack, spills and
SASS size (with --multi, these variants alone).  Prints one JSON
object; needs a CUDA card.

--newton alone builds and times K10-K13 on the Newton lenses' fast and
exact plans (NEWTON_LENSES: the double Gauss with conics on rows 2 and
5 and an even asphere on row 7, models.anamorphic_pair, a split-conic
biconic singlet; K11/K13 on three plans: the double Gauss's three
wavelengths, the others' refracting rows' mu grown by 0, 1 and 2 % of
mu - 1) at 2^22 bench rays of each lens's half width, with each key's
registers, stack, spills and SASS size.

To compare a parent tree's K10-K13 (or K3) with this tree's on one
card, run --df32, --newton (or --multi) from each tree in one call
(parent, this, this, parent).

--registers alone builds the K1-K9 keys of REGISTER_LENSES (the double
Gauss, NEWTON_LENSES, the phase models and the freeform Schmidt
corrector) in both dtypes, clip off and on, and their K10-K13 plan keys
(K10 and K12 on the first wavelength's plan, K11 and K13 on the 3
wavelengths' plans; fast and exact, clip off and on), and the double
Gauss's pose loops' rot keys (K5, K7 and K9 for offset and rot without
the ray cotangents, every pose live, unclipped; a tree that refuses
"rot" leaves them out) (cuda_spec.prebuild), and
prints {tag: [registers, stack bytes, spill bytes, SASS instructions]};
--compare A.json B.json prints the tags whose entries differ between
two such outputs and the counts of equal ones.  A key a tree's
constructors refuse is left out of its output (an older tree's K3 and
K6-K9 on the freeform rows), so the two trees' outputs compare key for
key on the keys both build.

--freeform alone times K3 (merit and trace), K6, K7 (every field with
the ray cotangents, and the achromatization loop's key: curvature,
offset, mu and xy_poly without them), K8 and K9 (every field with the
ray cotangents, and the design step's key: xy_poly without them) on the
freeform Schmidt corrector (a degree-4 xypoly plate, 14 terms seeded at
1e-10, ahead of an f/2 R = -200 mirror; K3, K6 and K7 on its 3
wavelengths' stack) beside the same kernels on its freeform-free twin
(the plate with no XY coefficients; its loop keys without xy_poly), in
turns (key, twin, key, twin), at FREEFORM_SIZES on its bench bundle
(x, y uniform in +-17 mm, u = (0, 0, 1), ray 0 on the axis: the OPD's
chief ray), with each key's registers, stack and spills.  With --df32
it times K10 (with the optical path) and K12 on the Schmidt corrector's
first wavelength's plan, K11 (with the path) and K13 on its 3
wavelengths' plans, fast and exact, beside the same kernels on the
freeform-free twin's plans, in turns, at DF32_SIZES on that bench
bundle, with each key's registers, stack, spills and SASS size.
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
         (torch.float64, N_OPT_BUNDLE), (torch.float32, 1 << 26),
         (torch.float64, 1 << 26))
#: the kernels timed at a size, where not all of them are
ONLY = {(torch.float64, 1 << 26): ("K1", "K2")}
NRAYS = 1 << 20      # hexapolar nrays a bundle of the steps
OPT_SELECT = ("curvature", "distance")
OPT_FIELDS = ("curvature", "offset")
ACHROM_FIELDS = ("curvature", "offset", "mu")
FIELDS = (0., .7, 1.)
GLASS_LR = {"curvature": 5e-8, "distance": 5e-8, "glass": 3e-5}
NLAMS = (1, 2, 3, 4, 5, 7, 8, 10, 11, 12, 16)   # K6 in --variants


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


def ptxas_stats(kern):
    """[registers, stack bytes, spill bytes] of a built key, from its
    ptxas lines."""
    import re
    text = kern.build_log
    regs = re.search(r"Used (\d+) registers", text)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", text)
    return [int(regs.group(1)), int(frame.group(1)),
            int(frame.group(2)) + int(frame.group(3))]


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


def opd_inputs(s, table, specs, state):
    """K9's aux vector (the chief ray 0's image point, the exit pupil's
    sphere radius, the first wavelength's scale) and the wavefront-RMS
    cotangents of K8's outputs."""
    from rayopt_tpu_torch.ops.cuda_grad import opd_chain, wavefront_rms_of
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
    u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
    yr, _, _ = trace_rays_final(table, y0, u0, specs=specs)
    aux = torch.cat([yr[0], torch.tensor(
        [-s.image.pupil.distance, s.wavelengths[0]/s.scale],
        dtype=torch.float64, device="cuda")]).to(state[0].dtype)
    k = opd_chain(table, specs, state, aux)[0].detach().double()
    k.requires_grad_()
    wavefront_rms_of(k - k[0]).backward()
    ct_k = k.grad.to(state[0].dtype).contiguous()
    return aux, (ct_k, torch.zeros_like(ct_k), torch.zeros_like(ct_k))


def kernel_times(s, table, specs):
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, opd_adjoint, opd_chain,
        weighted_moments, weighted_moments_multi)
    from rayopt_tpu_torch.ops.cuda_trace import trace_final, trace_merit
    sliced = {fn: "fields" in inspect.signature(fn).parameters
              for fn in (merit_adjoint, merit_adjoint_multi, opd_adjoint)}
    tabs = s.tables()
    out = {}
    for dtype, n in SIZES:
        state, w = bench_bundle(n, dtype)
        reps = 10 if n > 1 << 22 else 20
        only = ONLY.get((dtype, n))
        if only:
            cases = {"K1": lambda: trace_final(table, specs, state),
                     "K2": lambda: trace_merit(table, specs, state)}
            for name in only:
                out["%s %s %d" % (name, str(dtype)[6:], n)] = cuda_ms(
                    cases[name], reps)
            del state, w
            torch.cuda.empty_cache()
            continue
        # ray 0 the chief ray of the OPD (the bench bundle is collimated)
        for c, v in zip(state, (0., 0., 0., 0., 0., 1.)):
            c[0] = v
        ct = rms_cotangent(weighted_moments(table, specs, state, w))
        ctm = torch.stack([rms_cotangent(m) for m in weighted_moments_multi(
            tabs, specs, state, w)])
        aux, cts = opd_inputs(s, table, specs, state)
        cases = {
            "K1": lambda: trace_final(table, specs, state),
            "K2": lambda: trace_merit(table, specs, state),
            "K4": lambda: weighted_moments(table, specs, state, w),
            "K6": lambda: weighted_moments_multi(tabs, specs, state, w),
            "K5": lambda: merit_adjoint(table, specs, state, w, ct),
            "K7": lambda: merit_adjoint_multi(tabs, specs, state, w, ctm),
            "K8": lambda: opd_chain(table, specs, state, aux),
            "K9": lambda: opd_adjoint(table, specs, state, aux, cts)}
        if sliced[merit_adjoint]:
            cases["K5 optimizer"] = lambda: merit_adjoint(
                table, specs, state, w, ct, fields=OPT_FIELDS, rays=False)
        if sliced[merit_adjoint_multi]:
            cases["K7 achromatization"] = lambda: merit_adjoint_multi(
                tabs, specs, state, w, ctm, fields=ACHROM_FIELDS,
                rays=False)
        if sliced[opd_adjoint]:
            cases["K9 design"] = lambda: opd_adjoint(
                table, specs, state, aux, cts, fields=OPT_FIELDS, rays=False)
        for name, fn in cases.items():
            out["%s %s %d" % (name, str(dtype)[6:], n)] = cuda_ms(fn, reps)
        del state, w, cts
        torch.cuda.empty_cache()
    return out


#: the rays of the df32 timings
DF32_SIZES = (1 << 22, 1 << 26)


def df32_state(n):
    """The bench bundle (float64, seed 1) as df32 words."""
    from rayopt_tpu_torch.ops.df32 import state_from_f64
    st, _ = bench_bundle(n, torch.float64)
    return state_from_f64(torch.stack(st[:3], 1), torch.stack(st[3:], 1))


def df32_plans(s, fast):
    """One plan a wavelength of the double Gauss's 3-wavelength stack."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    tabs = s.tables()
    return [D.plan(table_at(tabs, li), fast=fast)
            for li in range(tabs.curvature.shape[0])]


def df32_times(s):
    """K10 (with the path) and K12 on the first wavelength's plan, K11
    (with the path) and K13 on the 3 wavelengths' plans, fast and exact
    plans, at DF32_SIZES bench rays, through the wrappers every tree of
    the port has."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    out = {}
    for n in DF32_SIZES:
        state = df32_state(n)
        reps = 5 if n > 1 << 22 else 20
        for fast in (True, False):
            lam = df32_plans(s, fast)
            one = lam[0]
            cases = {
                "K10": lambda: CD.trace_final_df32(one, state, with_path=True),
                "K12": lambda: CD.trace_merit_df32(one, state),
                "K11": lambda: CD.trace_multi_df32(lam, state, with_path=True),
                "K13": lambda: CD.trace_merit_multi_df32(lam, state)}
            for name, fn in cases.items():
                out["%s %s %d" % (name, "fast" if fast else "exact", n)] = \
                    cuda_ms(fn, reps)
        del state
        torch.cuda.empty_cache()
    return out


#: K11's and K13's variants: (where the chain reads the plan words:
#: 0 the kernel's parameters, 1 a copy of them in shared memory, 2 a
#: device copy staged into shared memory (cuda_spec.WORDS_AT), threads a
#: block, the launch bound's blocks an SM); the last two ask ptxas to
#: fit more blocks of the direct form, whose plan words sit in
#: registers
DF32_VARIANTS = tuple((at, block, 1) for at in (0, 1)
                      for block in (128, 256, 512)) + ((0, 256, 3),
                                                       (0, 512, 2))
#: K10's and K12's (one plan): every placement at each block, and more
#: blocks an SM of the parameters' and the shared copy's forms
ONE_PLAN_VARIANTS = tuple((at, block, 1) for at in (0, 1, 2)
                          for block in (128, 256, 512)) + (
    (0, 256, 2), (0, 256, 3), (0, 512, 2), (1, 256, 3), (1, 512, 2))
PLACEMENTS = ("params", "staged", "device")


def _variant_keys(kernel, plans, variants):
    from rayopt_tpu_torch.ops import cuda_spec as CS
    return {(kernel, at, block, minb): CS.df32_multi_key(
        plans, kernel, kernel == "k11", block=block, min_blocks=minb,
        staged=at > 0, device_words=at == 2)
        for at, block, minb in variants}


#: --newton's lenses and their bench bundles' half widths, mm
NEWTON_LENSES = (("aspheric double Gauss", 11.6), ("anamorphic pair", 4.),
                 ("split-conic biconic", 4.))


def newton_system(name):
    """A lens of NEWTON_LENSES."""
    from rayopt_tpu_torch import System
    from rayopt_tpu_torch.models import anamorphic_pair, double_gauss
    if name == "anamorphic pair":
        return anamorphic_pair()
    if name == "aspheric double Gauss":
        s = double_gauss()
        s[2].conic = -.7
        s[5].conic = .4
        s[7].aspherics = [0., 1.2e-7, -3e-11]
        s.update()
        return s
    s = System([dict(material="air"),
                dict(type="biconic", roc=25.84, curvature_x=.013,
                     distance=5., material="SCHOTT-BK|N-BK7", radius=10.),
                dict(type="biconic", distance=3., material="air",
                     radius=10.),
                dict(distance=47., radius=10.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    s[1].conic = -.4
    s[1].conic_x = .25
    s.update()
    return s


def newton_times():
    """K10 (with the optical path) and K12 on each NEWTON_LENSES lens's
    plan, K11 (with the path) and K13 on its three plans, fast and exact,
    at 2^22 bench rays (x, y uniform in the lens's half width, seed 1):
    {"<lens> <kernel> <fast|exact>": {ms, registers, stack and spill
    bytes, SASS instructions}} and the keys' build seconds."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    from rayopt_tpu_torch.ops.tables import table_at
    n = 1 << 22
    cases = {}
    for name, half in NEWTON_LENSES:
        s = newton_system(name)
        table = s.table()
        if name == "aspheric double Gauss":
            tabs = s.tables()
            lam = [table_at(tabs, li) for li in range(tabs.curvature.shape[0])]
        else:
            lam = [table.replace(mu=1 + (table.mu - 1)*(1 + .01*li))
                   for li in range(3)]
        for fast in (True, False):
            one = D.plan(table, fast=fast)
            plans = [D.plan(t, fast=fast) for t in lam]
            tag = "%s %%s %s" % (name, "fast" if fast else "exact")
            cases[tag % "K10"] = (CS.df32_multi_key([one], "k11", True),
                                  half, lambda st, p=one: CD.trace_final_df32(
                                      p, st, with_path=True))
            cases[tag % "K12"] = (CS.df32_multi_key([one], "k13"), half,
                                  lambda st, p=one: CD.trace_merit_df32(p, st))
            cases[tag % "K11"] = (CS.df32_multi_key(plans, "k11", True), half,
                                  lambda st, p=plans: CD.trace_multi_df32(
                                      p, st, with_path=True))
            cases[tag % "K13"] = (CS.df32_multi_key(plans, "k13"), half,
                                  lambda st, p=plans:
                                      CD.trace_merit_multi_df32(p, st))
    t0 = time.perf_counter()
    built = CS.prebuild([c[0] for c in cases.values()])
    out = {"build_s": time.perf_counter() - t0}
    for tag, (key, half, fn) in cases.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.empty(n, dtype=torch.float64, device="cuda")
        y = torch.empty_like(x)
        x.uniform_(-half, half, generator=gen)
        y.uniform_(-half, half, generator=gen)
        zero = torch.zeros_like(x)
        state = D.state_from_f64(torch.stack([x, y, zero], 1),
                                 torch.stack([zero, zero, zero + 1], 1))
        kern = built[key]
        regs, stack, spill = ptxas_stats(kern)
        out[tag] = {"ms": cuda_ms(lambda: fn(state), 20),
                    "registers": regs, "stack_bytes": stack,
                    "spill_bytes": spill,
                    "sass_instructions": sass_size(kern.path,
                                                   kern.entry)[0]}
        del state
    torch.cuda.empty_cache()
    return out


#: --registers' lenses: the double Gauss, NEWTON_LENSES, the phase models
#: and the freeform Schmidt corrector
REGISTER_LENSES = (("double Gauss",) + tuple(n for n, _ in NEWTON_LENSES)
                   + ("hybrid achromat", "spectrograph", "schmidt corrector"))


def register_keys():
    """{tag: key} of --registers: K1, K2, K4, K8, K5 and K9 (every field,
    with the ray cotangents) and K5 for OPT_FIELDS without them, K3's two
    modes, K6 and K7 on the 3-wavelength stack, in float32 and float64,
    clip off and on, on each lens of REGISTER_LENSES (a key its
    constructor refuses, or whose XY width an older tree's constructor
    does not take, left out; the XY width passed only where a row is
    freeform)."""
    from rayopt_tpu_torch import models
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 multi_specs, xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize
    keys = {}
    for name in REGISTER_LENSES:
        if name in dict(NEWTON_LENSES):
            s = newton_system(name)
        elif name == "schmidt corrector":
            s = schmidt_system()
        else:
            s = getattr(models, name.lower().replace(" ", "_"))()
        table, tabs = s.table(), s.tables()
        keys.update(df32_register_keys(name, table, tabs))
        specs = specialize(table)
        mspecs = multi_specs(tabs, None)
        kw = dict(widths=figure_widths(table, specs),
                  nd=doe_width(table, specs))
        if xy_width(table, specs):
            kw["nxy"] = xy_width(table, specs)
        for dtype in (torch.float32, torch.float64):
            for clip in (False, True):
                tag = "%s %s clip=%s %%s" % (name, str(dtype)[6:], clip)
                make = {
                    "K1": lambda: CS.trace_key(specs, dtype, clip, **kw),
                    "K2": lambda: CS.merit_key(specs, dtype, clip, **kw),
                    "K4": lambda: CS.moments_key(specs, dtype, clip, **kw),
                    "K8": lambda: CS.opd_key(specs, dtype, clip, **kw),
                    "K5": lambda: CS.adjoint_key(specs, dtype, clip, **kw),
                    "K5 optimizer": lambda: CS.adjoint_key(
                        specs, dtype, clip, fields=OPT_FIELDS, rays=False,
                        **kw),
                    "K9": lambda: CS.opd_adjoint_key(specs, dtype, clip,
                                                     **kw),
                    "K3 merit": lambda: CS.trace_multi_key(
                        mspecs, dtype, 3, merit=True, **kw),
                    "K3 trace": lambda: CS.trace_multi_key(
                        mspecs, dtype, 3, **kw),
                    "K6": lambda: CS.moments_multi_key(mspecs, dtype, clip,
                                                       3, **kw),
                    "K7": lambda: CS.adjoint_multi_key(mspecs, dtype, clip,
                                                       **kw)}
                for kname, fn in make.items():
                    try:
                        keys[tag % kname] = fn()
                    except (NotImplementedError, ValueError, TypeError):
                        pass
        if name == "double Gauss":
            keys.update(pose_register_keys(specs, mspecs))
    return keys


def pose_register_keys(specs, mspecs):
    """{tag: key} of the double Gauss's pose loops: K5, K7 and K9 for
    offset and rot (the rot keys of optimize_grad(select=("tilt",
    "decenter"))) without the ray cotangents, every pose live
    (kernels.with_pose), unclipped, in both dtypes; none in a tree
    whose keys have no rot slots (no cuda_spec.ROT)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.kernels import with_pose
    if not hasattr(CS, "ROT"):
        return {}
    pspecs, pmspecs = with_pose(specs), with_pose(mspecs)
    fields = ("offset", "rot")
    keys = {}
    for dtype in (torch.float32, torch.float64):
        tag = "double Gauss %s pose %%s rot" % str(dtype)[6:]
        keys[tag % "K5"] = CS.adjoint_key(pspecs, dtype, False, fields,
                                          False)
        keys[tag % "K7"] = CS.adjoint_multi_key(pmspecs, dtype, False,
                                                fields, False)
        keys[tag % "K9"] = CS.opd_adjoint_key(pspecs, dtype, False, fields,
                                              False)
    return keys


def df32_register_keys(name, table, tabs):
    """{tag: key} of --registers' K10-K13 keys of one lens: K10 (with
    the optical path) and K12 on its first wavelength's plan, K11 (with
    the path) and K13 on its wavelengths' plans, fast and exact, clip off
    and on (none where an older tree's plan refuses a row)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    keys = {}
    for fast in (True, False):
        for clip in (False, True):
            try:
                one = D.plan(table, clip=clip, fast=fast)
                plans = [D.plan(table_at(tabs, li), clip=clip, fast=fast)
                         for li in range(tabs.curvature.shape[0])]
            except NotImplementedError:
                continue
            tag = "%s %s clip=%s %%s" % (name, "fast" if fast else "exact",
                                         clip)
            keys[tag % "K10"] = CS.df32_multi_key([one], "k11", True)
            keys[tag % "K12"] = CS.df32_multi_key([one], "k13")
            keys[tag % "K11"] = CS.df32_multi_key(plans, "k11", True)
            keys[tag % "K13"] = CS.df32_multi_key(plans, "k13")
    return keys


#: --freeform's sizes: (dtype, rays, whether the adjoints run there)
FREEFORM_SIZES = ((torch.float32, 1 << 22, True),
                  (torch.float64, 1 << 22, True),
                  (torch.float32, 1 << 26, False))
FREEFORM_HALF = 17.   # mm: the Schmidt corrector's bench half width
#: the Schmidt corrector's loops' K7 (achromatization) and K9 (design)
#: slot sets; its twin's without xy_poly
FF_ACHROM_FIELDS = ACHROM_FIELDS + ("xy_poly",)
FF_DESIGN_FIELDS = ("xy_poly",)


def schmidt_system(coefficients=None):
    """The JAX package's freeform Schmidt corrector (its
    tests/test_freeform.py): a degree-4 xypoly plate (14 terms seeded at
    1e-10, norm radius 25 mm, N-BK7) 5 mm ahead of an f/2 R = -200 mm
    mirror, a 25 mm pupil, on axis; `coefficients` replaces the seed
    (coefficients=[]: the freeform-free twin)."""
    from rayopt_tpu_torch import System
    s = System([
        dict(material="air"),
        dict(type="xypoly", xy_coefficients=[1e-10]*14 if coefficients
             is None else coefficients, norm_radius=25., distance=5.,
             material="SCHOTT-BK|N-BK7", radius=26.),
        dict(distance=4., material="air", radius=26.),
        dict(roc=-200., distance=100., material="mirror", radius=30.),
        dict(distance=-95., radius=5.)])
    s.object.pupil.radius = 25.
    s.object.pupil.update_radius = False
    s.update()
    return s


def freeform_times():
    """K3, K6-K9 on the Schmidt corrector against its freeform-free twin
    (the module docstring's --freeform), every key built first at once:
    ({"<kernel> <dtype> <rays>": {"ms": ..., "twin_ms": ...}},
    {"<kernel> <dtype>": [registers, stack bytes, spill bytes]} of the
    Schmidt corrector's keys)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint_multi, opd_adjoint, opd_chain, weighted_moments_multi)
    from rayopt_tpu_torch.ops.cuda_trace import (
        doe_width, figure_widths, multi_specs, trace_multi, xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize
    lenses = {}
    for which, coefficients in (("key", None), ("twin", [])):
        s = schmidt_system(coefficients)
        table, tabs = s.table(), s.tables()
        lenses[which] = (s, table, specialize(table), tabs,
                         multi_specs(tabs, None))
    loops = {"key": (FF_ACHROM_FIELDS, FF_DESIGN_FIELDS),
             "twin": (ACHROM_FIELDS, OPT_FIELDS)}

    def keys_of(which, dtype):
        _, table, specs, tabs, mspecs = lenses[which]
        ml, ol = loops[which]
        kw = dict(widths=figure_widths(table, specs),
                  nd=doe_width(table, specs), nxy=xy_width(table, specs))
        mkw = dict(widths=figure_widths(tabs, mspecs),
                   nd=doe_width(tabs, mspecs), nxy=xy_width(tabs, mspecs))
        return {
            "K3 merit": CS.trace_multi_key(mspecs, dtype, 3, True, **mkw),
            "K3 trace": CS.trace_multi_key(mspecs, dtype, 3, **mkw),
            "K6": CS.moments_multi_key(mspecs, dtype, False, 3, **mkw),
            "K7": CS.adjoint_multi_key(mspecs, dtype, **mkw),
            "K7 achromatization": CS.adjoint_multi_key(
                mspecs, dtype, False, ml, False, **mkw),
            "K8": CS.opd_key(specs, dtype, **kw),
            "K9": CS.opd_adjoint_key(specs, dtype, **kw),
            "K9 design": CS.opd_adjoint_key(specs, dtype, False, ol, False,
                                            **kw)}
    mine = {dtype: keys_of("key", dtype)
            for dtype in (torch.float32, torch.float64)}
    built = CS.prebuild([k for dtype in mine for k in mine[dtype].values()]
                        + [k for dtype in mine
                           for k in keys_of("twin", dtype).values()])
    regs = {}
    for dtype, keys in mine.items():
        for name, key in keys.items():
            regs["%s %s" % (name, str(dtype)[6:])] = ptxas_stats(built[key])

    def cases(which, state, w):
        s, table, specs, tabs, mspecs = lenses[which]
        ml, ol = loops[which]
        ctm = torch.stack([rms_cotangent(m) for m in weighted_moments_multi(
            tabs, mspecs, state, w)])
        aux, cts = opd_inputs(s, table, specs, state)
        return {
            "K3 merit": lambda: trace_multi(tabs, mspecs, state, merit=True),
            "K3 trace": lambda: trace_multi(tabs, mspecs, state),
            "K6": lambda: weighted_moments_multi(tabs, mspecs, state, w),
            "K8": lambda: opd_chain(table, specs, state, aux),
            "K7": lambda: merit_adjoint_multi(tabs, mspecs, state, w, ctm),
            "K7 achromatization": lambda: merit_adjoint_multi(
                tabs, mspecs, state, w, ctm, fields=ml, rays=False),
            "K9": lambda: opd_adjoint(table, specs, state, aux, cts),
            "K9 design": lambda: opd_adjoint(table, specs, state, aux, cts,
                                             fields=ol, rays=False)}
    out = {}
    for dtype, n, adjoints in FREEFORM_SIZES:
        state, w = bench_bundle(n, dtype)
        state = tuple(c*FREEFORM_HALF/11.6 if i < 2 else c
                      for i, c in enumerate(state))
        for c, v in zip(state, (0., 0., 0., 0., 0., 1.)):
            c[0] = v
        key, twin = cases("key", state, w), cases("twin", state, w)
        reps = 5 if n > 1 << 22 else 10
        for name in key:
            if name.startswith(("K7", "K9")) and not adjoints:
                continue
            k1 = cuda_ms(key[name], reps)
            t1 = cuda_ms(twin[name], reps)
            k2 = cuda_ms(key[name], reps)
            t2 = cuda_ms(twin[name], reps)
            out["%s %s %d" % (name, str(dtype)[6:], n)] = {
                "ms": (k1 + k2)/2, "twin_ms": (t1 + t2)/2}
        del state, w, key, twin
        torch.cuda.empty_cache()
    return out, regs


def df32_freeform_times():
    """K10-K13 on the Schmidt corrector's plans against the
    freeform-free twin's (the module docstring's --freeform --df32),
    every key built first at once: ({"<kernel> <fast|exact> <rays>":
    {"ms": ..., "twin_ms": ...}}, {"<kernel> <fast|exact>": [registers,
    stack bytes, spill bytes, SASS instructions]} of the Schmidt
    corrector's keys)."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    from rayopt_tpu_torch.ops.tables import table_at
    plans = {}
    for which, coefficients in (("key", None), ("twin", [])):
        s = schmidt_system(coefficients)
        table, tabs = s.table(), s.tables()
        for fast in (True, False):
            plans[(which, fast)] = (
                D.plan(table, fast=fast),
                [D.plan(table_at(tabs, li), fast=fast)
                 for li in range(tabs.curvature.shape[0])])
    kinds = {"K10": ("k11", True, 0), "K12": ("k13", False, 0),
             "K11": ("k11", True, 1), "K13": ("k13", False, 1)}
    keys = {(name, which, fast): CS.df32_multi_key(
                [p[0]] if not multi else p[1], kernel, path)
            for (which, fast), p in plans.items()
            for name, (kernel, path, multi) in kinds.items()}
    built = CS.prebuild(list(keys.values()))
    regs = {}
    for (name, which, fast), key in keys.items():
        if which != "key":
            continue
        regs["%s %s" % (name, "fast" if fast else "exact")] = ptxas_stats(
            built[key]) + [sass_size(built[key].path, built[key].entry)[0]]

    def call(name, which, fast, state):
        one, lam = plans[(which, fast)]
        return {"K10": lambda: CD.trace_final_df32(one, state,
                                                   with_path=True),
                "K12": lambda: CD.trace_merit_df32(one, state),
                "K11": lambda: CD.trace_multi_df32(lam, state,
                                                   with_path=True),
                "K13": lambda: CD.trace_merit_multi_df32(lam, state)}[name]
    out = {}
    for n in DF32_SIZES:
        st, _ = bench_bundle(n, torch.float64)
        st = tuple(c*FREEFORM_HALF/11.6 if i < 2 else c
                   for i, c in enumerate(st))
        state = D.state_from_f64(torch.stack(st[:3], 1),
                                 torch.stack(st[3:], 1))
        del st
        reps = 5 if n > 1 << 22 else 20
        for fast in (True, False):
            for name in kinds:
                key = call(name, "key", fast, state)
                twin = call(name, "twin", fast, state)
                k1, t1 = cuda_ms(key, reps), cuda_ms(twin, reps)
                k2, t2 = cuda_ms(key, reps), cuda_ms(twin, reps)
                out["%s %s %d" % (name, "fast" if fast else "exact", n)] = {
                    "ms": (k1 + k2)/2, "twin_ms": (t1 + t2)/2}
        del state
        torch.cuda.empty_cache()
    return out, regs


def register_stats():
    """{tag: [registers, stack bytes, spill bytes, SASS instructions]}
    of register_keys' keys, built at once."""
    from concurrent.futures import ThreadPoolExecutor
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    keys = register_keys()
    built = CS.prebuild(list(keys.values()))
    kerns = {key: built[key] for key in set(keys.values())}
    with ThreadPoolExecutor(max_workers=8) as pool:
        sass = dict(zip(kerns, pool.map(
            lambda k: sass_size(k.path, k.entry)[0], kerns.values())))
    out = {}
    for tag, key in keys.items():
        out[tag] = ptxas_stats(kerns[key]) + [sass[key]]
    return out


def compare_registers(path_a, path_b):
    """Print the tags whose --registers entries differ between two
    outputs, and the counts."""
    a, b = (json.load(open(p))["registers"] for p in (path_a, path_b))
    common = sorted(set(a) & set(b))
    differ = [t for t in common if a[t][:3] != b[t][:3]]
    sass = [t for t in common if a[t][3] != b[t][3]]
    for t in sorted(set(differ) | set(sass)):
        print("%s: %s -> %s" % (t, a[t], b[t]))
    print("%d common key tags (%d in one only): registers, stack and "
          "spills differ on %d, SASS instructions on %d"
          % (len(common), len(set(a) ^ set(b)), len(differ), len(sass)))


def df32_variant_times(s):
    """K11 (with the path) and K13 on the fast plans of the 3
    wavelengths at each of DF32_VARIANTS, and K10 (with the path) and
    K12 on the first one at each of ONE_PLAN_VARIANTS, at DF32_SIZES
    rays, with each build's registers, spills and SASS size.  Each
    variant is timed twice, the second round in the reverse order:
    through the wrapper ("ms", its kernel lookup pointed at the
    variant's build) and as the bare launch on words packed once
    ("launch_ms")."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    plans = df32_plans(s, True)
    groups = {"K11": ("k11", plans, DF32_VARIANTS),
              "K13": ("k13", plans, DF32_VARIANTS),
              "K10": ("k11", plans[:1], ONE_PLAN_VARIANTS),
              "K12": ("k13", plans[:1], ONE_PLAN_VARIANTS)}
    keys = {(name,) + v: key for name, (kernel, ps, variants)
            in groups.items()
            for v, key in _variant_keys(kernel, ps, variants).items()}
    t0 = time.perf_counter()
    built = CS.prebuild(list(keys.values()))
    build_s = time.perf_counter() - t0
    kerns = [(v, built[key]) for v, key in keys.items()]
    out = {"build_s": build_s}
    for n in DF32_SIZES:
        reps = 5 if n > 1 << 22 else 20
        state = df32_state(n)
        words = [w for c in state for w in c]
        device = words[0].device
        stream = torch.cuda.current_stream(device).cuda_stream
        rows = {}
        for order in (kerns, kerns[::-1]):
            for (name, kind, at, block, minb), kern in order:
                ps = groups[name][1]
                label = "%s %s %d block %d min_blocks %d" % (
                    name, PLACEMENTS[at], n, block, minb)
                row = rows.setdefault(label, {"runs_ms": [],
                                              "launch_runs_ms": []})
                row["runs_ms"].append(_wrapper_ms(CD, kern, kind, ps, state,
                                                  reps))
                row["launch_runs_ms"].append(_launch_ms(
                    CD, CS, kern, kind, ps, words, n, device, stream, reps))
                if "ptxas" not in row:
                    row.update(grid=kern.grid(n, device),
                               blocks_per_sm=kern.blocks_per_sm(device),
                               ptxas=[ln for ln in kern.ptxas_lines()
                                      if "registers" in ln
                                      or "stack frame" in ln],
                               sass_instructions=sass_size(
                                   kern.path, kern.entry)[0],
                               nvcc_s=kern.build_seconds)
        for row in rows.values():
            row["ms"] = float(np.mean(row["runs_ms"]))
            row["launch_ms"] = float(np.mean(row["launch_runs_ms"]))
        out.update(rows)
        del state, words
        torch.cuda.empty_cache()
    return out


def _wrapper_ms(CD, kern, kind, plans, state, reps):
    """ms of the wrapper's call with its key lookup pointed at kern."""
    one = len(plans) == 1
    calls = {("k11", False): lambda: CD.trace_multi_df32(plans, state,
                                                         with_path=True),
             ("k13", False): lambda: CD.trace_merit_multi_df32(plans, state),
             ("k11", True): lambda: CD.trace_final_df32(plans[0], state,
                                                        with_path=True),
             ("k13", True): lambda: CD.trace_merit_df32(plans[0], state)}
    real = CD._multi_kernel
    CD._multi_kernel = lambda *a, _kern=kern: _kern
    try:
        return cuda_ms(calls[(kind, one)], reps)
    finally:
        CD._multi_kernel = real


def _launch_ms(CD, CS, kern, kind, plans, words, n, device, stream, reps):
    """ms of kern's bare launch on words packed (and, device words,
    uploaded) once."""
    packed, _ = CD.pack_plan(list(plans), "cpu")
    if kern.key.device_words:
        packed = packed.to(device)
    grid = kern.grid(n, device)
    if kind == "k11":
        out = torch.empty((len(plans), 14, n), dtype=torch.float32,
                          device=device)
        args = [packed.data_ptr(), *(w.data_ptr() for w in words),
                out.data_ptr(), n, grid, stream]
    else:
        partials = torch.empty((grid, len(plans), 10), dtype=torch.float32,
                               device=device)
        tot = torch.empty((len(plans), 5), dtype=torch.float64,
                          device=device)
        args = [packed.data_ptr(), *(w.data_ptr() for w in words),
                partials.data_ptr(), CS.counter(device).data_ptr(),
                tot.data_ptr(), n, grid, stream]
    return cuda_ms(lambda: kern.check(kern.fn(*args)), reps)


#: the long plan's steps: about the most the run-time K10 and K12 took
#: (48 KB of shared memory a block), past the kernel parameters alone
LONG_STEPS = 300


def long_plan_times():
    """K10 (with the path) and K12 on a LONG_STEPS-step plan (the Cooke
    triplet's fast plan repeated), whose words take the device-words
    placement: each key's nvcc seconds (the two built in parallel),
    registers, stack, spills and SASS size, differing words and moments
    against the plain versions at 2^14 bench rays, and ms at
    DF32_SIZES rays through the wrapper."""
    from rayopt_tpu_torch.models import cooke_triplet
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    plan = D.plan(cooke_triplet().table(), fast=True)
    plan = (plan*(-(-LONG_STEPS // len(plan))))[:LONG_STEPS]
    keys = {"K10": CS.df32_multi_key([plan], "k11", True),
            "K12": CS.df32_multi_key([plan], "k13")}
    t0 = time.perf_counter()
    built = CS.prebuild(list(keys.values()))
    out = {"steps": LONG_STEPS, "build_wall_s": time.perf_counter() - t0}
    for name, key in keys.items():
        kern = built[key]
        out[name] = {"device_words": key.device_words,
                     "nvcc_s": kern.build_seconds,
                     "dynamic_smem": key.dynamic_smem,
                     "ptxas": [ln for ln in kern.ptxas_lines()
                               if "registers" in ln or "stack frame" in ln],
                     "sass_instructions": sass_size(kern.path,
                                                   kern.entry)[0]}
    st = df32_state(1 << 14)
    got = CD.trace_final_df32(plan, st, with_path=True)
    want = CD.trace_final_df32_reference(plan, st, with_path=True)
    words = [w for c in (*got[0], got[1]) for w in c]
    ref = [w for c in (*want[0], want[1]) for w in c]
    out["K10"]["differing_words"] = sum(
        int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
        for a, b in zip(words, ref))
    out["K10"]["live_rays"] = int(torch.isfinite(got[0][0][0]).sum())
    mom = CD.trace_merit_df32(plan, st)
    mref = CD.trace_merit_df32_reference(plan, st)
    out["K12"]["count"] = (float(mom[0]), float(mref[0]))
    out["K12"]["moments_abs_err"] = max(abs(float(a) - float(b))
                                        for a, b in zip(mom, mref))
    for n in DF32_SIZES:
        state = df32_state(n)
        reps = 3 if n > 1 << 22 else 10
        out["K10"]["ms %d" % n] = cuda_ms(
            lambda: CD.trace_final_df32(plan, state, with_path=True), reps)
        out["K12"]["ms %d" % n] = cuda_ms(
            lambda: CD.trace_merit_df32(plan, state), reps)
        del state
        torch.cuda.empty_cache()
    return out


def _timed_variant(module, lookup, kern, call, n, device):
    """ms of call() with module.lookup pointed at kern's build, and the
    build's launch shape and ptxas lines."""
    real = getattr(module, lookup)
    setattr(module, lookup, lambda *a, _kern=kern: _kern)
    try:
        ms = cuda_ms(call, 20)
    finally:
        setattr(module, lookup, real)
    return {"ms": ms, "grid": kern.grid(n, device),
            "blocks_per_sm": kern.blocks_per_sm(device),
            "ptxas": [ln for ln in kern.ptxas_lines()
                      if "registers" in ln or "stack frame" in ln]}


def variant_times(s, specs, table):
    """The loops' keys of K5 (the optimizer's slot set), K7 (the
    achromatization path's) and K9 (the design path's), no ray
    cotangents, at each block size and launch bound, and K2 and K6 (3
    wavelengths, unclipped) at each block size, float64 at N_OPT_BUNDLE
    rays and float32 at 2^22, through the wrappers (each wrapper's
    kernel lookup is pointed at the variant's build)."""
    from rayopt_tpu_torch.ops import cuda_grad as CG
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import cuda_trace as CT
    tabs = s.tables()
    nlam = tabs.curvature.shape[0]
    shapes = ((64, 1), (64, 6), (128, 1), (128, 2), (128, 3), (256, 1))
    kinds = {"K5": ("_adjoint_kernel", CS.adjoint_key, OPT_FIELDS),
             "K7": ("_adjoint_multi_kernel", CS.adjoint_multi_key,
                    ACHROM_FIELDS),
             "K9": ("_opd_adjoint_kernel", CS.opd_adjoint_key, OPT_FIELDS)}
    keys = {(k, dt, b, m): make(specs, dt, False, fields, False, block=b,
                                min_blocks=m)
            for k, (_, make, fields) in kinds.items()
            for dt in (torch.float64, torch.float32) for b, m in shapes}
    # the moment kernels: (module, lookup, key) at each block size
    moments = {(k, dt, b, 1): (mod, lookup, make(dt, b))
               for k, mod, lookup, make in (
                   ("K2", CT, "_merit_kernel", lambda dt, b: CS.merit_key(
                       specs, dt, False, block=b)),
                   ("K6", CG, "_moments_multi_kernel",
                    lambda dt, b: CS.moments_multi_key(specs, dt, False,
                                                       nlam, block=b)))
               for dt in (torch.float64, torch.float32)
               for b in (128, 256, 512)}
    built = CS.prebuild(list(keys.values())
                        + [v[2] for v in moments.values()])
    out = {}
    for dtype in (torch.float64, torch.float32):
        n = N_OPT_BUNDLE if dtype == torch.float64 else 1 << 22
        state, w = bench_bundle(n, dtype)
        device = state[0].device
        for c, v in zip(state, (0., 0., 0., 0., 0., 1.)):
            c[0] = v
        ct = rms_cotangent(CG.weighted_moments(table, specs, state, w))
        ctm = torch.stack([rms_cotangent(m) for m in
                           CG.weighted_moments_multi(tabs, specs, state, w)])
        aux, cts = opd_inputs(s, table, specs, state)
        calls = {
            "K2": lambda: CT.trace_merit(table, specs, state),
            "K5": lambda: CG.merit_adjoint(table, specs, state, w, ct,
                                           fields=OPT_FIELDS, rays=False),
            "K6": lambda: CG.weighted_moments_multi(tabs, specs, state, w),
            "K7": lambda: CG.merit_adjoint_multi(
                tabs, specs, state, w, ctm, fields=ACHROM_FIELDS,
                rays=False),
            "K9": lambda: CG.opd_adjoint(table, specs, state, aux, cts,
                                         fields=OPT_FIELDS, rays=False)}
        for (kind, dt, block, minb), key in keys.items():
            if dt == dtype:
                out["%s loop key %s %d block %d min_blocks %d" % (
                    kind, str(dtype)[6:], n, block, minb)] = _timed_variant(
                        CG, kinds[kind][0], built[key], calls[kind], n,
                        device)
        for (kind, dt, block, minb), (mod, lookup, key) in moments.items():
            if dt == dtype:
                out["%s %s %d block %d min_blocks %d" % (
                    kind, str(dtype)[6:], n, block, minb)] = _timed_variant(
                        mod, lookup, built[key], calls[kind], n, device)
        del state, w, cts
        torch.cuda.empty_cache()
    out.update(trace_variant_times(s, specs, table))
    out.update(nlam_times(s, specs))
    return out


#: K1's and K8's variants: threads a block
TRACE_BLOCKS = (128, 256, 512)


#: the (dtype, rays) of K1's and K8's variant timings
TRACE_SIZES = ((torch.float64, 1 << 22), (torch.float64, N_OPT_BUNDLE),
               (torch.float32, 1 << 22), (torch.float32, 1 << 26),
               (torch.float64, 1 << 26))


def trace_variant_times(s, specs, table):
    """K1 and K8 (unclipped) at each of TRACE_BLOCKS and TRACE_SIZES
    (float64 at 2^22, the forward path's aimed bundles, and at
    N_OPT_BUNDLE, a design bundle; float32 at 2^22; both at 2^26), with
    each build's registers and spills.  Each variant is timed twice, the
    second round in the reverse order: through the wrapper ("ms", its
    kernel lookup pointed at the variant's build; the wrapper packs the
    table each call) and as the bare launch on a table packed once
    ("launch_ms")."""
    from rayopt_tpu_torch.ops import cuda_grad as CG
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import cuda_trace as CT
    kinds = {"K1": (CT, "_trace_kernel", CS.trace_key),
             "K8": (CG, "_opd_kernel", CS.opd_key)}
    keys = {(k, dt, b): make(specs, dt, False, block=b)
            for k, (_, _, make) in kinds.items()
            for dt in (torch.float64, torch.float32) for b in TRACE_BLOCKS}
    built = CS.prebuild(list(keys.values()))
    kerns = {v: built[key] for v, key in keys.items()}
    out = {}
    for dtype, n in TRACE_SIZES:
        reps = 5 if n > 1 << 22 else 20
        state, _ = bench_bundle(n, dtype)
        device = state[0].device
        for c, v in zip(state, (0., 0., 0., 0., 0., 1.)):
            c[0] = v
        aux, _ = opd_inputs(s, table, specs, state)
        tab = CS.packed(table, specs, state[0])
        outs = [torch.empty_like(state[0]) for _ in range(7)]
        stream = torch.cuda.current_stream(device).cuda_stream
        calls = {"K1": lambda: CT.trace_final(table, specs, state),
                 "K8": lambda: CG.opd_chain(table, specs, state, aux)}
        ptrs = {"K1": [c.data_ptr() for c in (*state, *outs)],
                "K8": [c.data_ptr() for c in (*state, aux, *outs[:3])]}
        mine = [(v, kern) for v, kern in kerns.items() if v[1] == dtype]
        rows = {}
        for order in (mine, mine[::-1]):
            for (kind, _, block), kern in order:
                mod, lookup, _ = kinds[kind]
                name = "%s %s %d block %d" % (kind, str(dtype)[6:], n, block)
                grid = kern.grid(n, device)
                args = [tab.data_ptr(), *ptrs[kind], n, grid, stream]
                row = rows.setdefault(name, {"runs_ms": [],
                                             "launch_runs_ms": []})
                real = getattr(mod, lookup)
                setattr(mod, lookup, lambda *a, _kern=kern: _kern)
                try:
                    row["runs_ms"].append(cuda_ms(calls[kind], reps))
                finally:
                    setattr(mod, lookup, real)
                row["launch_runs_ms"].append(cuda_ms(
                    lambda: kern.check(kern.fn(*args)), reps))
                row.update(grid=grid, blocks_per_sm=kern.blocks_per_sm(
                    device), ptxas=[ln for ln in kern.ptxas_lines()
                                    if "registers" in ln
                                    or "stack frame" in ln])
        for row in rows.values():
            row["ms"] = float(np.mean(row["runs_ms"]))
            row["launch_ms"] = float(np.mean(row["launch_runs_ms"]))
        out.update(rows)
        del state, outs, tab
        torch.cuda.empty_cache()
    return out


def nlam_times(s, specs):
    """K6 (unclipped) on stacks of NLAMS wavelengths spread over 400-700
    nm, against as many K4 launches on the same bundle, float64 at
    N_OPT_BUNDLE rays and float32 at 2^22, with each K6 build's ptxas
    lines.  The keys past cuda_spec.MAX_NLAM, which the key refuses, are
    built here to measure that limit."""
    from rayopt_tpu_torch.ops import cuda_grad as CG
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.tables import table_at
    stacks = {nlam: s.tables(list(np.linspace(400e-9, 700e-9, nlam)))
              for nlam in NLAMS}
    keys = {(nlam, dt): CS.moments_multi_key(specs, dt, False, 1)._replace(
        nlam=nlam) for nlam in NLAMS for dt in (torch.float64, torch.float32)}
    built = CS.prebuild(list(keys.values()))
    out = {}
    for dtype in (torch.float64, torch.float32):
        n = N_OPT_BUNDLE if dtype == torch.float64 else 1 << 22
        state, w = bench_bundle(n, dtype)
        for nlam, tabs in stacks.items():
            one = [table_at(tabs, li) for li in range(nlam)]
            kern = built[keys[(nlam, dtype)]]
            out["K6 nlam %d %s %d" % (nlam, str(dtype)[6:], n)] = dict(
                _timed_variant(CG, "_moments_multi_kernel", kern,
                               lambda: CG.weighted_moments_multi(
                                   tabs, specs, state, w), n, state[0].device),
                k4_launches_ms=cuda_ms(lambda: [CG.weighted_moments(
                    t, specs, state, w) for t in one], 20))
        del state, w
        torch.cuda.empty_cache()
    return out


#: the (dtype, rays) of K3's timings (--multi)
MULTI_SIZES = ((torch.float32, 1 << 22), (torch.float64, 1 << 22),
               (torch.float32, 1 << 26), (torch.float64, 1 << 26))


def multi_times(s, specs):
    """K3 merit and trace through trace_multi (every tree's wrapper) on
    the 3-wavelength stack at MULTI_SIZES, and K6 and K7 (all fields,
    the ray cotangents written) at 2^22 float32 as controls."""
    from rayopt_tpu_torch.ops.cuda_grad import (merit_adjoint_multi,
                                                weighted_moments_multi)
    from rayopt_tpu_torch.ops.cuda_trace import trace_multi
    tabs = s.tables()
    out = {}
    for dtype, n in MULTI_SIZES:
        state, w = bench_bundle(n, dtype)
        reps = 5 if n > 1 << 22 else 20
        cases = {"K3 merit": lambda: trace_multi(tabs, specs, state, True),
                 "K3 trace": lambda: trace_multi(tabs, specs, state)}
        if (dtype, n) == MULTI_SIZES[0]:
            ctm = torch.stack([rms_cotangent(m) for m in
                               weighted_moments_multi(tabs, specs, state, w)])
            cases["K6"] = lambda: weighted_moments_multi(tabs, specs, state,
                                                         w)
            cases["K7"] = lambda: merit_adjoint_multi(tabs, specs, state, w,
                                                      ctm)
        for name, fn in cases.items():
            out["%s %s %d" % (name, str(dtype)[6:], n)] = cuda_ms(fn, reps)
        del state, w
        torch.cuda.empty_cache()
    return out


#: K3's variants: (mode, wavelengths outermost, threads a block)
MULTI_VARIANTS = tuple(("trace", outer, block) for outer in (False, True)
                       for block in (256, 512)) + tuple(
    ("merit", False, block) for block in (128, 256, 512))


def multi_variant_times(s, specs):
    """K3's MULTI_VARIANTS on the 3-wavelength stack, as the bare launch
    on the stack packed once, at MULTI_SIZES, each variant timed twice
    (the second round in the reverse order), with each build's launch
    shape, registers, stack, spills and SASS size."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_build import sass_size
    tabs = s.tables()
    nlam = tabs.curvature.shape[0]
    keys = {(mode, outer, block, dt): CS.trace_multi_key(
        specs, dt, nlam, mode == "merit", block=block, outer=outer)
        for mode, outer, block in MULTI_VARIANTS
        for dt in (torch.float32, torch.float64)}
    built = CS.prebuild(list(keys.values()))
    out = {}
    for dtype, n in MULTI_SIZES:
        reps = 5 if n > 1 << 22 else 20
        state, _ = bench_bundle(n, dtype)
        device = state[0].device
        stream = torch.cuda.current_stream(device).cuda_stream
        tab = CS.packed(tabs, specs, state[0])
        traced = torch.empty((nlam, 7, n), dtype=dtype, device=device)
        mom = torch.empty((nlam, 5), dtype=dtype, device=device)
        mine = [(v, built[key]) for v, key in keys.items() if v[3] == dtype]
        rows = {}
        for order in (mine, mine[::-1]):
            for (mode, outer, block, _), kern in order:
                name = "K3 %s %s %s %d block %d" % (
                    mode, "outer" if outer else "inner", str(dtype)[6:], n,
                    block)
                grid = kern.grid(n, device)
                ptrs = [tab.data_ptr(), *(c.data_ptr() for c in state)]
                if mode == "trace":
                    args = ptrs + [traced.data_ptr(), n, grid, stream]
                else:
                    partials = torch.empty((grid, 5*nlam), dtype=dtype,
                                           device=device)
                    args = ptrs + [None, partials.data_ptr(),
                                   CS.counter(device).data_ptr(),
                                   mom.data_ptr(), n, grid, stream]
                row = rows.setdefault(name, {"launch_runs_ms": []})
                row["launch_runs_ms"].append(cuda_ms(
                    lambda: kern.check(kern.fn(*args)), reps))
                if "ptxas" not in row:
                    try:
                        sass = sass_size(kern.path, kern.entry)[0]
                    except (OSError, subprocess.CalledProcessError):
                        sass = None
                    row.update(grid=grid, blocks_per_sm=kern.blocks_per_sm(
                        device), sass_instructions=sass,
                        ptxas=[ln for ln in kern.ptxas_lines()
                               if "registers" in ln or "stack frame" in ln])
        for row in rows.values():
            row["launch_ms"] = float(np.mean(row["launch_runs_ms"]))
        out.update(rows)
        del state, tab, traced
        torch.cuda.empty_cache()
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
    out = {"aim_s": aim_s,
           "achromatization_step_ms": achromatization_steps(steps)}
    out["achromatization_step_ms_mean"] = float(np.mean(
        out["achromatization_step_ms"]))
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


def achromatization_steps(steps):
    """Wall ms of the achromatization steps after the first: the union
    polychromatic spot RMS (glass.polychromatic_spot_rms, "adjoint") of
    3 hexapolar bundles at FIELDS through the 3-wavelength stack, the 6
    glasses relaxed through glass_box_decode, Adam at GLASS_LR."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.parallel import bundles_from_system
    s = double_gauss()
    tabs = s.tables()
    nlam = tabs.curvature.shape[0]
    specs = multi_specs(tabs, None)
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    bundles = bundles_from_system(s, fields=FIELDS,
                                  wavelengths=[s.wavelengths[0]],
                                  nrays=NRAYS, distribution="hexapolar")
    # distance is optimized, the trace reads offset = unit * distance
    d0 = tabs.distance[0].detach()
    off0 = tabs.offset[0].detach()
    unit = torch.where(d0[:, None] != 0, off0/torch.where(
        d0[:, None] != 0, d0[:, None], 1.), torch.tensor([0., 0., 1.],
                                                         device="cuda"))
    xi_nd, xi_vd = (torch.from_numpy(v).cuda().requires_grad_()
                    for v in glass.glass_box_encode(nd0, vd0))
    params = {"curvature": tabs.curvature[0].detach().clone()
              .requires_grad_(),
              "distance": d0.clone().requires_grad_(),
              "xi_nd": xi_nd, "xi_vd": xi_vd}
    opt = torch.optim.Adam([
        {"params": [params["curvature"]], "lr": GLASS_LR["curvature"]},
        {"params": [params["distance"]], "lr": GLASS_LR["distance"]},
        {"params": [xi_nd, xi_vd], "lr": GLASS_LR["glass"]}])
    ends = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.zero_grad()
            tb = tabs.replace(
                curvature=params["curvature"].expand(nlam, -1),
                offset=(unit*params["distance"][:, None]).expand(nlam, -1,
                                                                 -1))
            nd, vd = glass.glass_box_decode(xi_nd, xi_vd)
            tb = glass.glass_tables(tb, nd, vd, asg, s.wavelengths)
            value = sum(glass.polychromatic_spot_rms(
                tb, y0, u0, w, specs=specs, engine="adjoint")
                for y0, u0, w, _ in bundles)
            value.backward()
            opt.step()
            float(value.detach())    # the step's end: a host sync
            ends.append(time.perf_counter())
    ms = np.diff([t0] + ends)*1e3
    return [float(v) for v in ms[1:]]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--df32", action="store_true",
                    help="time K10-K13 (and with --variants their "
                    "variants) alone")
    ap.add_argument("--multi", action="store_true",
                    help="time K3 (and with --variants its variants) "
                    "alone")
    ap.add_argument("--newton", action="store_true",
                    help="build and time K10-K13 on the Newton lenses' "
                    "plans alone")
    ap.add_argument("--long-plan", action="store_true",
                    help="build and time K10 and K12 on a %d-step plan "
                    "(device words) alone" % LONG_STEPS)
    ap.add_argument("--registers", action="store_true",
                    help="build the K1-K9 keys of REGISTER_LENSES and "
                    "print their registers, stack, spills and SASS size "
                    "alone")
    ap.add_argument("--compare", nargs=2, metavar="JSON",
                    help="compare two --registers outputs")
    ap.add_argument("--freeform", action="store_true",
                    help="time K3, K6-K9 (with --df32: K10-K13) on the "
                    "freeform Schmidt corrector beside its freeform-free "
                    "twin alone")
    args = ap.parse_args()
    if args.compare:
        compare_registers(*args.compare)
        return
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.kernels import specialize
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    table = double_gauss().table()
    specs = specialize(table)
    if args.registers:
        print(json.dumps({"card": card, "registers": register_stats()}))
        sys.stdout.flush()
        return
    if args.freeform and args.df32:
        times, regs = df32_freeform_times()
        print(json.dumps({"card": card, "df32_freeform_ms": times,
                          "df32_freeform_registers": regs}))
        sys.stdout.flush()
        return
    if args.freeform:
        times, regs = freeform_times()
        print(json.dumps({"card": card, "freeform_ms": times,
                          "freeform_registers": regs}))
        sys.stdout.flush()
        return
    if args.newton:
        print(json.dumps({"card": card, "newton": newton_times()}))
        sys.stdout.flush()
        return
    if args.long_plan:
        print(json.dumps({"card": card,
                          "long_plan": long_plan_times()}))
        sys.stdout.flush()
        return
    if args.multi:
        out = {"card": card, "multi_ms": multi_times(double_gauss(), specs)}
        if args.variants:
            out["multi_variants"] = multi_variant_times(double_gauss(),
                                                        specs)
        print(json.dumps(out))
        sys.stdout.flush()
        return
    out = {"card": card, "df32_ms": df32_times(double_gauss())}
    if args.df32:
        if args.variants:
            out["df32_variants"] = df32_variant_times(double_gauss())
        print(json.dumps(out))
        sys.stdout.flush()
        return
    out["kernels_ms"] = kernel_times(double_gauss(), table, specs)
    out.update(step_times(args.steps))
    if args.variants:
        out["variants"] = variant_times(double_gauss(), specs, table)
        out["df32_variants"] = df32_variant_times(double_gauss())
        out["multi_variants"] = multi_variant_times(double_gauss(), specs)
    print(json.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
