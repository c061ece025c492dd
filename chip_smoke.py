"""Chip smoke test of rayopt_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout (K1-K9 once for
each spec tuple, wavelength count, slot set and flag they run with,
K10-K13 once for each plan key, all keys in parallel, with their ptxas
registers, stack and spills, and K3's and K10-K13's SASS size), holds
each against its plain PyTorch version on the card
(the specialized K5 for each slot set, with and without ray
cotangents, K7 and K9 for
every field with ray cotangents and for their loops' keys; the repaired
cancellation-free intercept of K1, K2 and K4 on a paraboloid and on the
double Gauss with near-flat rows against the CPU float64 generic
trace; K3 and K6/K7 on stacks past one key's wavelengths and K11/K13
on plans past one key's parameters, split by their wrappers), drives
the port's four main paths -- the forward path (double Gauss from YAML
-> paraxial solve -> pupil aiming, on the host and with System.pupils
on the card, which must agree -> fused trace and fused spot-moment
merit at three fields), the designer loop (bundles at 3 fields x 3
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
against the CPU float64 trace) -- then the aspheric path (the JAX
package's aspheric double Gauss: System.pupils on the card against the
host pupil, K1 and K2 on aimed bundles at three fields against the CPU
float64 plain trace with the Newton's misses counted, the designer
loop over curvatures and aspheric coefficients, the achromatization
loop (K3, K6, K7) and the composite design step (K4, K5, K8, K9) with
row 7's aspheric coefficients among their parameters, after K1-K9 on
its figured keys and on the odd singlet against their plain versions
and K5, K7 and K9 against central differences of A4, A6, a conic and a
glass's vd) and its df32 path on the same aimed bundles, then the
anamorphic path (the crossed-cylinder pair) and its df32 path, after
K10-K13 on every Newton lens (aspheric rows, cylinders, biconics and
toroids, figured or not) against their plain versions -- then the
phase paths (K1, K2, K4 and K5 on six grating and DOE lenses against
their plain versions and K5 against central differences of grating_dy
and two DOE coefficients; the concave-grating spectrograph's forward
path at each wavelength with its detector lines against the JAX
package's golden; the hybrid achromat's forward path on aimed bundles
and its designer loop over curvatures, distances and the kinoform's
coefficient) -- then the phase rows in df32 (K10-K13 on the six phase
lenses, the kinoform and two phase cylinders against their plain
versions, word for word; the parity-grade df32 path on the hybrid
achromat's aimed bundles, the spectrograph's detector lines against
the golden and the kinoform's optical path) and on a cylinder (K1-K9
on a grating on a biconic-made y-cylinder and a DOE on a toroid-made
one against their plain versions and central differences) -- then
the freeform XY rows (K1-K9 on seven freeform lenses against their
plain versions, K5, K7 and K9 against central differences of xy_poly,
K8 on the reference's Zernike imprint; the Schmidt and Zernike
correctors' forward paths; the Schmidt corrector's designer loop,
achromatization loop and design step with its plate's xy_poly among
their parameters) -- then the rot cotangent (the K5, K7 and K9 rot keys
on a tilted sphere, conic, asphere, biconic, toroid, DOE, grating,
freeform plate and image row against their plain versions and central
differences of tilt and decenter; on the misaligned double Gauss the
alignment-compensation loop, optimize_grad(select=("tilt", "decenter"),
engine="adjoint") on the designer loop's bundles, and one
achromatization and one design step over tilt and decenter, every
K5/K7/K9 launch under a rot key) -- and times the kernels against their plain
versions (the stacked-wavelength ones also against their monochromatic
twins, the aspheric keys against the double Gauss's, K10-K13 on the
Newton plans against their spherical twins', the grating and DOE keys
and the df32 phase plans against their phase-free twins', the phase
cylinders' keys against the plain cylinders', the freeform keys
against the freeform-free Schmidt plate's, the rot keys against their
twins without rot).
Every phase raises on a failure; the script exits non-zero and prints
no result without a CUDA device.  The last line of stdout is the
device JSON, the line before it the kernels JSON.
"""

import functools
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DEVICE = "cuda"      # the card: every tensor but the CPU references
N_CHECK = 1 << 20    # rays in the kernel-vs-plain checks
N_AIMED = 1 << 22    # rays per field on the main path
#: the main path's CPU float64 cross-check: the first N_MAIN_REF rays of
#: each field's float64 K1 and K2 output (the whole 2^22 took ~33 s of
#: CPU a field)
N_MAIN_REF = 1 << 20
#: aimed rays a field on the anamorphic pair's and the hybrid achromat's
#: forward paths (the host's numpy aim of 2^22 took ~2.5 s a field)
N_AIMED_LENS = 1 << 20
#: bench rays of the figured anamorphic keys' timings against their
#: plain versions (2^20 took ~17 s of the script)
N_FIGURED_TIME = 1 << 18
N_BENCH = 1 << 26    # rays in the throughput phase
N_OPT = 1 << 20      # hexapolar nrays a bundle on the optimizer path
N_GRAD_TIME = 1 << 22  # rays in the K3-K7 kernel-vs-plain timings
N_OPT_BUNDLE = 1046071  # rays of one optimizer bundle (hexapolar, 2^20)
N_INTERCEPT = 1 << 16  # aimed rays a field in the intercept phase
N_SPLIT = 1 << 16    # bench rays of the split phase
N_SPLIT_NLAM = (12, 13)  # K6/K7 stacks past MAX_NLAM (split 6+6, 7+6)
N_SPLIT_K3 = (12, 40)  # K3 stacks past MAX_NLAM (6+6, 4 x 10)
N_SPLIT_PLANS = 24   # K11/K13 plans past the kernel parameters (12+12)
N_GLASS = 1 << 20    # hexapolar nrays a field on the achromatization path
# the first rays of each aimed bundle whose CPU float64 traces at the df32
# path's other wavelengths hold K11 and K13 there (the first wavelength is
# held at full depth by the main path's reference)
N_DF32_REF = 1 << 18
FIELDS = (0., .7, 1.)
SEED = 0
OPT_SELECT = ("curvature", "distance")
OPT_FIELDS = ("curvature", "offset")   # the table fields OPT_SELECT moves
# the fields K7 reduces on the achromatization path (curvature, distance
# and, through the glasses, mu) and K9 on the design path
ACHROM_FIELDS = ("curvature", "offset", "mu")
DESIGN_FIELDS = OPT_FIELDS
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

ASPH_ROW = 7         # the aspheric double Gauss's even asphere
ASPH_SELECT = ("curvature", "aspherics")
#: Adam's preconditioning of its coefficient columns (the r^2, r^4 and r^6
#: terms; optimize_grad stores each divided by its scale): each column's
#: magnitude on the aspheric row -- A4 1.2e-7 /mm^3, A6 -3e-11 /mm^5, and
#: for A2, zero there, 1e-4 /mm (a small power change)
ASPH_SCALES = {"aspherics": (1e-4, 1e-7, 1e-11)}
#: central-difference steps of K5's aspheric check: ~1e-3 of A4 and A6,
#: and the conic (unitless)
ASPH_FD_STEP = {"A4": 1e-10, "A6": 3e-14, "conic": 1e-6}
N_ASPH = 1 << 16     # aimed rays a field on the aspheric forward path
#: the fields K7 reduces on the aspheric achromatization loop (curvature,
#: distance, row ASPH_ROW's coefficients and, through the glasses, mu)
#: and K5 and K9 on the aspheric design loop
ASPH_ACHROM_FIELDS = ("curvature", "offset", "mu", "aspherics")
ASPH_DESIGN_FIELDS = ("curvature", "offset", "aspherics")
ASPH_DESIGN_SELECT = OPT_SELECT + ("aspherics",)
#: hexapolar nrays a bundle of every loop's step-0 cross-check on both
#: devices (the CPU's plain step takes ~5 s a loop there, ~16x that at
#: the loops' 2^20: 15-40 s a double Gauss loop); the timed run's own
#: step 0 at 2^20 is logged beside it
N_LOOP_CHECK = 1 << 16

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
OPD_COLUMN_FLOOR = 1e-5  # K9 in float64: a field held to 1e-9 of its
#                      largest or of this share of the key's largest, 1e-14
#                      of it: each ray's cotangents carry the path to the
#                      reference sphere (~7e6 waves on the Schmidt plates)
#                      and the mu column's cancel to ~6e-8 of the key's
#                      largest, off by ~4e-16 of it (the order of a
#                      2^20-ray sum's float64 rounding)
COLUMN_FLOOR = 1e-9  # a parameter field is held to its largest plain
#                      cotangent, or to this share of the key's largest
#                      where that is more: a field that vanishes (mu
#                      through a flat plate at normal incidence, 1e-9 of
#                      the plate's xy_poly 2.5e5) is the rounding of the
#                      key's terms; a field at zero stays exact
F32_RAY_REL = 1e-2   # float32 K5 ray cotangents: a float32 image
#                      coordinate carries K1's ~2e-5 mm on a ~0.03 mm
#                      spot, twice that on the weight cotangent's squares
FD_REL = 1e-5        # float64 K5 vs central differences of the K4 merit
OPT_MERIT_REL = 1e-9  # optimizer step 0 merit, card vs CPU plain
AIM_REL = 1e-9       # System.pupils on the card vs the host pupil, z and boxes
AIM_HOST_TOL = 1e-12  # the host pupil's tolerance for that comparison
OPT_GRAD_REL = 1e-8   # optimizer step 0 gradient, of its field's max
OPD_F32_REL = 4e-6   # float32 K8 vs float32 plain, of max |k| (~1.1e5
#                      waves on the double Gauss: a float32 ulp is
#                      ~0.008); each is ~1e-6 of it off the float64 one
F32_SUM_REL = 1e-5   # a float32 K5/K7 column whose terms cancel (a phase
#                      cylinder's grating_dy, ~5e-5 of its sum of |term|)
#                      vs the float64 plain version, of that sum; the
#                      float32 versions ~1e-7 of it off (H100 and CPU)
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


T_START = time.perf_counter()


def log(*args):
    """Print a line; a phase's header ("== ...") also gets the seconds
    since the script started."""
    text = " ".join(str(a) for a in args)
    if text.startswith("== "):
        text += " [at %.1f s]" % (time.perf_counter() - T_START)
    print(text, flush=True)


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


def compare_final(got, want, dtype, f32_abs=F32_ABS):
    """Max abs error over rays live in both, NaN-mask mismatches, and
    the pass/fail of one K1 comparison (float32 positions and
    directions within `f32_abs`)."""
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
        ok = (bad_masks <= F32_NAN_FRAC*n and max(errs[:6]) <= f32_abs
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


def phase_check(table, specs, lens="double Gauss", bundle=bench_bundle,
                clips=(False, True), dtypes=(torch.float32, torch.float64)):
    """K1 and K2 against their plain versions on the card at N_CHECK
    rays of `bundle` (the aspheric lenses: unclipped only), float64 to
    F64_REL, float32 to its own limits, and, with both `dtypes` (the
    figured anamorphic lenses: float64 only), float32 K2's spot RMS
    against float64's.  Returns the float32 errors."""
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_final_reference, trace_merit,
        trace_merit_reference, spot_rms_from_moments)
    log("== kernel vs plain on the card (%s, %d rays)" % (lens, N_CHECK))
    worst = {"trace_final": 0., "trace_merit": 0.}
    rms = {}
    failures = []
    for dtype in dtypes:
        state = bundle(N_CHECK, dtype, SEED)
        for clip in clips:
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
    for clip in clips if len(dtypes) == 2 else ():
        r32, r64 = rms[(torch.float32, clip)], rms[(torch.float64, clip)]
        rel = abs(r32 - r64)/r64
        log("K2 clip=%s: float32 spot RMS %.9g vs float64 %.9g, rel %.3e"
            % (clip, r32, r64, rel))
        if not rel <= 1e-4:
            failures.append("K2 float32 vs float64 clip=%s" % clip)
    if failures:
        raise AssertionError("kernel disagrees with its plain version on "
                             "the %s: %s" % (lens, ", ".join(failures)))
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


def compare_param_grads(got, want, rel, fields=GRAD_FIELDS):
    """{field: (max abs error, max |plain|, ok)}: each field of `fields`
    (name, its columns) against its largest plain cotangent, floored at
    COLUMN_FLOOR of the largest over all fields; a field the
    specialization bakes out on every row (plain all zero) must come out
    exactly zero."""
    out = {}
    top = max(float(want[:, cols].double().abs().max())
              for _, cols in fields)
    for name, cols in fields:
        g, w = got[:, cols].double(), want[:, cols].double()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        held = max(scale, COLUMN_FLOOR*top) if scale else 0.
        out[name] = (err, scale,
                     bool(torch.isfinite(g).all()) and err <= rel*held)
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


def phase_grad_check(table, specs, lens="double Gauss", bundle=bench_bundle,
                     clips=(False, True), fields=GRAD_FIELDS,
                     dtypes=(torch.float32, torch.float64)):
    """K4 and K5 (every field, with the ray cotangents) against their
    plain versions on the card at N_CHECK rays of `bundle` in `dtypes`;
    K5's parameter cotangents by `fields` (the aspheric lenses: their
    coefficient columns too, asph_grad_fields; the anamorphic lenses
    also curvature_dx and conic_dx, anam_grad_fields).  Returns the
    float32 errors."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments, weighted_moments_reference, merit_adjoint,
        merit_adjoint_reference)
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    log("== K4/K5 vs plain on the card (%s, %d rays, weights uniform in "
        "[0.5, 1.5])" % (lens, N_CHECK))
    worst = {"weighted_moments": 0., "merit_adjoint": 0.}
    failures = []
    for dtype in dtypes:
        f64 = dtype == torch.float64
        state = bundle(N_CHECK, dtype, SEED)
        w = bench_weights(N_CHECK, dtype, SEED + 2)
        for clip in clips:
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
            errs = compare_param_grads(pg, pr, lim, fields)
            ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr)
            ok = (all(v[2] for v in errs.values()) and finite
                  and ray_rel <= (GRAD_F64_REL if f64 else F32_RAY_REL)
                  and masks <= (0 if f64 else F32_NAN_FRAC*N_CHECK))
            log("K5 %s: %s | rays and weights rel err %.3e, live masks "
                "differ on %d rays, dead rays %d, all finite %s -> %s"
                % (tag, "; ".join("%s err %.3e of max %.3e" % (k, *v[:2])
                                  for k, v in errs.items()),
                   ray_rel, masks, int((wr == 0).sum()), finite,
                   "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K5 " + tag)
            if not f64:
                worst["weighted_moments"] = max(worst["weighted_moments"],
                                                abs(rg - rw))
                worst["merit_adjoint"] = max(
                    worst["merit_adjoint"], *(v[0] for v in errs.values()))
    if failures:
        raise AssertionError("kernel disagrees with its plain version on "
                             "the %s: %s" % (lens, ", ".join(failures)))
    return worst


def spec_keys(specs, mspecs, nlam, extra=()):
    """{tag: key} of the specializations this script runs: K1, K8, K2, K4
    and K5 on `specs` in float32 and float64, clip off and on, K5 for the
    optimizer's slot set and for all fields, with and without the ray
    cotangents; K6 on the stack's `mspecs` and its `nlam` wavelengths,
    clip off and on; K7 on `mspecs` and K9 on `specs`, clip off and on,
    for all fields with the ray cotangents (the checks), and unclipped
    for their loops' keys without (the achromatization and the design
    path); the keys the finite-difference checks of a glass take (K7:
    mu; K9: mu and n_before, float64); K1 on `mspecs`, clip off and on
    (the multi check traces each wavelength's table with it); K2 on
    `mspecs` unclipped (K3's twin); K3 on `mspecs` and `nlam`, trace and
    merit, in both dtypes; K1, K2 and K4 on each spec tuple of `extra`
    (the intercept cases) unclipped."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    keys = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        for clip in (False, True):
            keys["K1 %s clip=%s" % (dt, clip)] = CS.trace_key(specs, dtype,
                                                              clip)
            keys["K1 %s clip=%s stack" % (dt, clip)] = CS.trace_key(
                mspecs, dtype, clip)
            keys["K8 %s clip=%s" % (dt, clip)] = CS.opd_key(specs, dtype,
                                                            clip)
            keys["K2 %s clip=%s" % (dt, clip)] = CS.merit_key(specs, dtype,
                                                              clip)
            keys["K4 %s clip=%s" % (dt, clip)] = CS.moments_key(specs, dtype,
                                                                clip)
            keys["K6 %s clip=%s nlam=%d" % (dt, clip, nlam)] = \
                CS.moments_multi_key(mspecs, dtype, clip, nlam)
            for fields in (OPT_FIELDS, CS.FIELDS):
                for rays in (False, True):
                    keys["K5 %s clip=%s %s rays=%s" % (
                        dt, clip, "optimizer" if fields == OPT_FIELDS
                        else "all", rays)] = CS.adjoint_key(
                            specs, dtype, clip, fields, rays)
            keys["K7 %s clip=%s all rays=True" % (dt, clip)] = \
                CS.adjoint_multi_key(mspecs, dtype, clip)
            keys["K9 %s clip=%s all rays=True" % (dt, clip)] = \
                CS.opd_adjoint_key(specs, dtype, clip)
        keys["K7 %s clip=False achromatization rays=False" % dt] = \
            CS.adjoint_multi_key(mspecs, dtype, False, ACHROM_FIELDS, False)
        keys["K9 %s clip=False design rays=False" % dt] = \
            CS.opd_adjoint_key(specs, dtype, False, DESIGN_FIELDS, False)
        keys["K2 %s clip=False stack" % dt] = CS.merit_key(mspecs, dtype)
        for mode in ("merit", "trace"):
            keys["K3 %s %s nlam=%d" % (dt, mode, nlam)] = \
                CS.trace_multi_key(mspecs, dtype, nlam, mode == "merit")
        for name, sp in extra:
            keys["K1 %s %s" % (dt, name)] = CS.trace_key(sp, dtype)
            keys["K2 %s %s" % (dt, name)] = CS.merit_key(sp, dtype)
            keys["K4 %s %s" % (dt, name)] = CS.moments_key(sp, dtype)
    keys["K7 float64 clip=False glass rays=False"] = CS.adjoint_multi_key(
        mspecs, torch.float64, False, ("mu",), False)
    keys["K9 float64 clip=False glass rays=False"] = CS.opd_adjoint_key(
        specs, torch.float64, False, ("mu", "n_before"), False)
    return keys


def df32_quad(tag, one, plans):
    """{tag: key} of K10 and K11 (with the optical path), K12 and K13 on
    one plan `one` and the plans of its wavelengths `plans`."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    return {"K10 %s path=True" % tag: CS.df32_multi_key([one], "k11", True),
            "K11 %s path=True" % tag: CS.df32_multi_key(plans, "k11", True),
            "K12 " + tag: CS.df32_multi_key([one], "k13"),
            "K13 " + tag: CS.df32_multi_key(plans, "k13")}


def df32_keys(s):
    """{tag: key} of the K10-K13 specializations this script runs: the
    double Gauss's plan (K10, K12) and the plans of its wavelengths
    (K11, K13), fast and exact, clip off and on, K10 and K11 with and
    without the optical path (the check), the df32 path's among them
    (fast, unclipped, K10 and K11 with the path); each Newton lens's
    (df32_newton_lenses: its plan, K10 with the path and K12, and its
    K11/K13 plans, K11 with the path; fast and exact, clip off and on;
    the df32 paths of the aspheric double Gauss and the pair among
    them), those of the timed Newton lenses' spherical twins; and the
    split phase's runs of N_SPLIT_PLANS fast plans."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    tabs = s.tables()
    keys = {}
    for fast in (True, False):
        for clip in (False, True):
            one = [D.plan(s.table(), clip=clip, fast=fast)]
            plans = [D.plan(table_at(tabs, li), clip=clip, fast=fast)
                     for li in range(tabs.curvature.shape[0])]
            tag = "%s clip=%s" % ("fast" if fast else "exact", clip)
            for wp in (False, True):
                keys["K10 %s path=%s" % (tag, wp)] = CS.df32_multi_key(
                    one, "k11", wp)
                keys["K11 %s path=%s" % (tag, wp)] = CS.df32_multi_key(
                    plans, "k11", wp)
            keys["K12 " + tag] = CS.df32_multi_key(one, "k13")
            keys["K13 " + tag] = CS.df32_multi_key(plans, "k13")
    for lens, (_, ltab, _, ltabs) in df32_newton_lenses().items():
        for fast in (True, False):
            for clip in (False, True):
                keys.update(df32_quad(
                    "%s %s clip=%s" % (lens, "fast" if fast else "exact",
                                       clip),
                    D.plan(ltab, clip=clip, fast=fast),
                    [D.plan(t, clip=clip, fast=fast) for t in ltabs]))
    # the timed Newton lenses' spherical twins (the aspheric double
    # Gauss's: the double Gauss's keys above)
    for lens in DF32_TIMED[1:]:
        for fast in (True, False):
            keys.update(df32_quad(
                "%s twin %s" % (lens, "fast" if fast else "exact"),
                *df32_timed_plans(lens, fast)[1]))
    plans = split_plans(s)
    for kernel, wp in (("k11", True), ("k13", False)):
        for l0, l1 in CS.df32_runs(CS.df32_flags(plans), kernel):
            keys["%s split %d-%d" % (kernel.upper(), l0, l1)] = \
                CS.df32_multi_key(plans[l0:l1], kernel, wp)
    return keys


def split_keys(s):
    """{tag: key} of the split phase's K6 runs and K7 key: float64,
    unclipped, on each stack of N_SPLIT_NLAM wavelengths; and its K3
    runs, trace and merit, in both dtypes, on each of N_SPLIT_K3."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    keys = {}
    for nlam in N_SPLIT_K3:
        specs = multi_specs(s.tables(split_wavelengths(nlam)), None)
        for dtype in (torch.float32, torch.float64):
            for mode in ("merit", "trace"):
                kernel = "k3m" if mode == "merit" else "k3"
                for l0, l1 in CS.runs(nlam, CS.multi_most(kernel, specs,
                                                          dtype)):
                    keys["K3 %s %s split %d: %d-%d" % (
                        str(dtype)[6:], mode, nlam, l0, l1)] = \
                        CS.trace_multi_key(specs, dtype, l1 - l0,
                                           mode == "merit")
    for nlam in N_SPLIT_NLAM:
        specs = multi_specs(s.tables(split_wavelengths(nlam)), None)
        for l0, l1 in CS.runs(nlam, CS.MAX_NLAM):
            keys["K6 float64 split %d: %d-%d" % (nlam, l0, l1)] = \
                CS.moments_multi_key(specs, torch.float64, False, l1 - l0)
        keys["K7 float64 split %d" % nlam] = CS.adjoint_multi_key(
            specs, torch.float64, False)
    return keys


def split_plans(s):
    """N_SPLIT_PLANS fast plans of the double Gauss, one a wavelength in
    400-700 nm: more than one K11/K13 key's parameters hold."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    tabs = s.tables(split_wavelengths(N_SPLIT_PLANS))
    return [D.plan(table_at(tabs, li), fast=True)
            for li in range(N_SPLIT_PLANS)]


def split_wavelengths(n):
    return [float(v) for v in np.linspace(400e-9, 700e-9, n)]


# the keys whose ptxas report must show no stack frame and no spill: the
# loops' and the forward path's (phase_spec_build), and the df32 path's
LOOP_KEYS = ("K1 float32 clip=False",
             "K1 float64 clip=False",
             "K8 float64 clip=False",
             "K2 float64 clip=False",
             "K6 float64 clip=False nlam=3",
             "K3 float64 merit nlam=3",
             "K5 float32 clip=False optimizer rays=False",
             "K5 float64 clip=False optimizer rays=False",
             "K5 float32 clip=True optimizer rays=False",
             "K5 float64 clip=True optimizer rays=False",
             "K7 float64 clip=False achromatization rays=False",
             "K9 float64 clip=False design rays=False",
             "K10 fast clip=False path=True",
             "K11 fast clip=False path=True",
             "K12 fast clip=False",
             "K13 fast clip=False",
             "K1 float32 anamorphic clip=False",
             "K1 float64 anamorphic clip=False",
             "K2 float64 anamorphic clip=False",
             "K5 float32 anamorphic designer rays=False",
             "K5 float64 anamorphic designer rays=False",
             "K3 float64 anamorphic merit",
             "K6 float64 anamorphic clip=False",
             "K7 float64 anamorphic achromatization rays=False",
             "K5 float64 anamorphic design rays=False",
             "K9 float64 anamorphic design rays=False",
             "K1 float32 hybrid-achromat clip=False",
             "K1 float64 hybrid-achromat clip=False",
             "K2 float64 hybrid-achromat clip=False",
             "K5 float32 hybrid-achromat designer rays=False",
             "K5 float64 hybrid-achromat designer rays=False")


def ptxas_stats(kern):
    """(registers, stack frame bytes, spill store + load bytes) of a
    key's -Xptxas -v report (its own kernel's lines)."""
    import re
    text = kern.build_log
    regs = re.search(r"Used (\d+) registers", text)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", text)
    if not (regs and frame):
        raise AssertionError("no ptxas report for %s" % kern.key.name)
    return (int(regs.group(1)), int(frame.group(1)),
            int(frame.group(2)) + int(frame.group(3)))


def sass_size(kern):
    """(instructions, bytes) of a key's kernel in its library's SASS
    (cuda_build.sass_size), or (None, None) without cuobjdump."""
    from rayopt_tpu_torch.ops.cuda_build import sass_size as size
    try:
        return size(kern.path, kern.entry)
    except (OSError, subprocess.CalledProcessError) as err:
        log("cuobjdump --dump-sass %s: not run (%s)" % (kern.path.name, err))
        return None, None


def phase_spec_build(keys):
    """Build every K1-K9 and K10-K13 specialization at once (cuda_spec.
    prebuild: a few keys a translation unit, one nvcc a unit, as many at
    a time as the process may use cores): every kernel of the port; log
    each key's build seconds (its unit's) and ptxas lines, and the SASS
    size of the path's K3 keys and the unclipped fast df32 keys.  The
    loops' keys (LOOP_KEYS: K1 of the forward path, float32 and float64,
    and K2, float64; K5 for the optimizer's slot set; K3, K6 and K7 for
    the achromatization path's and K8 and K9 for the design path's,
    float64; K10-K13 of the df32 path) must have no stack frame and no
    spill.  Returns {tag: (registers, stack bytes, spill bytes)} and
    {tag: (SASS instructions, bytes)} of those K3 and df32 keys."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    log("== build: K1-K9 per spec tuple, K10-K13 per plan key: %d key "
        "tags, %d keys" % (len(keys), len(set(keys.values()))))
    t0 = time.perf_counter()
    built = CS.prebuild(list(keys.values()))
    units = {k.path for k in built.values()}
    log("built in %.2f s wall: %d units, %.2f nvcc seconds in all" % (
        time.perf_counter() - t0, len(units),
        sum({k.path: k.build_seconds for k in built.values()}.values())))
    # the SASS size of each K3 key of the path and each unclipped fast
    # df32 key (the df32 paths' keys among them), once a key, the
    # cuobjdump runs in parallel
    counted = {key for tag, key in keys.items()
               if (isinstance(key, CS.Df32Key) and "fast clip=False" in tag)
               or (key.kernel in ("k3", "k3m") and "split" not in tag)}
    with ThreadPoolExecutor(max_workers=8) as pool:
        sizes = dict(zip(counted, pool.map(lambda k: sass_size(built[k]),
                                           counted)))
    stats, sass, failures = {}, {}, []
    for tag, key in keys.items():
        kern = built[key]
        stats[tag] = ptxas_stats(kern)
        what = ("%d plan(s), %d flag tuple(s), %s" % (
            key.nlam, len(key.tuples), key.words_at)
            if isinstance(key, CS.Df32Key) else "%d live slots" % key.nlive)
        if key in sizes:
            sass[tag] = sizes[key]
            what += ", SASS %s instructions" % (sass[tag][0],)
        log("%s: %s, %s, block %d, nvcc %.2f s | %s" % (
            tag, key.name, what, key.block, kern.build_seconds,
            " | ".join(ln for ln in kern.ptxas_lines()
                       if "Compiling" not in ln and "properties" not in ln)))
        if tag in LOOP_KEYS and stats[tag][1:] != (0, 0):
            failures.append(tag)
    if failures:
        raise AssertionError("a loop's key has a stack frame or spills: %s"
                             % failures)
    log_late_builds(set(keys.values()))
    return stats, sass


def log_late_builds(known):
    """From now on, log each key built at first use (one serial nvcc, a
    key missing from phase_spec_build) with the script's functions that
    asked for it, innermost last."""
    import traceback
    from rayopt_tpu_torch.ops import cuda_spec as CS
    build = CS.prebuild

    def prebuild(keys):
        late = [k.name for k in keys if k not in CS._LOADED
                and k not in known]
        if late:
            where = [f.name for f in traceback.extract_stack()
                     if f.filename == __file__][:-1]
            log("late key build %s from %s" % (late, " > ".join(where)))
        return build(keys)
    CS.prebuild = prebuild


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
    """The port's main path, through the entry points a user calls:
    N_AIMED aimed rays a field through float64 and float32 K1 and K2, the
    first N_MAIN_REF of float64 K1's and K2's own output held against the
    CPU float64 plain trace.  Returns the aimed bundles (on the card),
    their float64 K1 image positions and the CPU float64 spot RMS of
    their first N_MAIN_REF rays, for the df32 path."""
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
    phase_device_aiming(s)
    rng = np.random.RandomState(SEED)
    failures, aimed = [], []
    for field in FIELDS:
        t0 = time.perf_counter()
        z, p = s.pupil((0., field))
        t_pupil = time.perf_counter() - t0
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
        # the CPU cross-check on the first N_MAIN_REF rays of float64
        # K1's and K2's own output
        sub = slice(0, N_MAIN_REF)
        rms_sub, live_sub = spot_rms(y64[sub], u64[sub])
        mom_sub = trace_merit(table, specs, tuple(c[sub] for c in state64),
                              clip=False)
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu,
                                          torch.from_numpy(y0[sub]),
                                          torch.from_numpy(u0[sub]),
                                          clip=False)
        rms_cpu, live_cpu = spot_rms(yh, uh)
        mom_cpu = trace_merit(table_cpu, specs,
                              tuple(c[sub].cpu() for c in state64),
                              clip=False)
        t_cpu = time.perf_counter() - t0
        rel1 = abs(rms_sub - rms_cpu)/rms_cpu
        mom_ok, mom_rel, _ = compare_moments(mom_sub, mom_cpu, torch.float64,
                                             N_MAIN_REF)
        ok = (np.isfinite(rms_k1) and live_sub == live_cpu
              and rel1 <= PARITY_REL and mom_ok
              and abs(rms_k2 - rms_k1)/rms_k1 <= 1e-9)
        log("field %.1f: pupil z %.6f, %d of %d rays live | spot RMS mm: "
            "K1 f64 %.12g | K2 f64 %.12g (rel %.2e) | K1 f32 %.9g (rel "
            "%.2e) | K2 f32 %.9g (rel %.2e) | the first %d rays: K1 f64 "
            "%.12g vs CPU f64 %.12g (rel %.2e), K2 f64 moments vs CPU rel "
            "%.2e | aim %.2f s (host pupil %.3f s, numpy aim of the rays "
            "%.2f s), card %.2f s, CPU %.2f s -> %s"
            % (field, z, live, N_AIMED, rms_k1, rms_k2,
               abs(rms_k2 - rms_k1)/rms_k1, rms_k1_32,
               abs(rms_k1_32 - rms_k1)/rms_k1, rms_k2_32,
               abs(rms_k2_32 - rms_k1)/rms_k1, N_MAIN_REF, rms_sub, rms_cpu,
               rel1, mom_rel, t_aim, t_pupil, t_aim - t_pupil, t_gpu, t_cpu,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("field %.1f" % field)
        aimed.append(dict(field=field, y=yc, u=uc, y64=y64,
                          rms_cpu=rms_cpu, live_cpu=live_cpu,
                          n_ref=N_MAIN_REF))
    if failures:
        raise AssertionError("main path parity failed at " +
                             ", ".join(failures))
    return aimed


def phase_device_aiming(s):
    """The forward path's pupils, solved for the three fields at once on
    the card (System.pupils: ops.aiming's Newton and bisections as plain
    torch ops, no host round trip inside) and on the host, one `pupil` a
    field, at the host's default tolerance (as the path runs it) and at
    1e-12, which the card's z and boxes must match to AIM_REL.  Logs
    each one's time; the card's twice (the first call also pays the
    first launches of its torch ops)."""
    from rayopt_tpu_torch.models import double_gauss
    fields = [(0., f) for f in FIELDS]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # a host fallback fails
            z, boxes = s.pupils(fields)
        times.append(time.perf_counter() - t0)
    host = {}
    for tol in (None, AIM_HOST_TOL):
        h = double_gauss()
        t0 = time.perf_counter()
        sol = [h.pupil(f) if tol is None else h.pupil(f, tol=tol)
               for f in fields]
        host[tol] = (time.perf_counter() - t0, np.array([v[0] for v in sol]),
                     np.array([v[1] for v in sol]))
    t_tight, zh, bh = host[AIM_HOST_TOL]
    rel_z = float((np.abs(z - zh)/np.abs(zh)).max())
    rel_b = float((np.abs(boxes - bh)/np.abs(bh)).max())
    loose = max(float((np.abs(z - host[None][1])/np.abs(zh)).max()),
                float((np.abs(boxes - host[None][2])/np.abs(bh)).max()))
    ok = rel_z <= AIM_REL and rel_b <= AIM_REL
    log("== device aiming: System.pupils of %d fields on the card %.3f s "
        "(again %.3f s) | host pupil, one a field: %.3f s at its default "
        "tolerance (agrees to %.2e rel), %.3f s at tol %g | card vs host "
        "at %g: z rel %.3e, boxes rel %.3e -> %s"
        % (len(fields), times[0], times[1], host[None][0], loose, t_tight,
           AIM_HOST_TOL, AIM_HOST_TOL, rel_z, rel_b, "ok" if ok else "FAIL"))
    log("z %s | +mer %s" % (" ".join("%.12g" % v for v in z),
                            " ".join("%.12g" % v for v in boxes[:, 1, 1])))
    if not ok:
        raise AssertionError("System.pupils on the card disagrees with the "
                             "host pupil: z rel %.3e, boxes rel %.3e"
                             % (rel_z, rel_b))


def phase_opt_path():
    """The designer loop on the double Gauss, through the entry points a
    user calls, its step 0 against the CPU at N_LOOP_CHECK nrays a
    bundle.  Returns (launch counts, mean seconds of the later steps,
    the bundles)."""
    from rayopt_tpu_torch.models import double_gauss
    return designer_loop(double_gauss(), "optimizer path: double Gauss",
                         OPT_SELECT, check_nrays=N_LOOP_CHECK)


def step0_grads(out, ends=None):
    """An optimize_grad callback that keeps step 0's gradients in `out`
    (float64, on the CPU) and, with `ends`, the time each step ends."""
    def callback(i, value, params):
        if ends is not None:
            ends.append(time.perf_counter())   # value synced the step
        if i == 0:
            out.update({k: v.grad.detach().double().cpu().clone()
                        for k, v in params.items()})
    return callback


def step0_cross_check(step0, card0, bundles, aimed, check_nrays):
    """A loop's step 0 on the card held against the same call on the CPU
    plain versions.  step0(device, bundles) runs it on `bundles` (on the
    card) moved to `device` and returns (merit, {name: float64 CPU
    gradient}); card0 is that pair from the loop's timed run on
    `bundles`.  With check_nrays both devices run step 0 again on
    aimed(check_nrays) (the CPU's plain versions at the loops' 2^20
    nrays take ~16x as long), and the timed run's own step 0 is logged
    beside them, not cross-checked.  Returns (the bundles checked, the
    failures)."""
    check, timed = bundles, ""
    if check_nrays:
        check = aimed(check_nrays)
        timed = ("; the timed run's step 0 at the loop's bundles: merit "
                 "%.15g (not cross-checked)" % card0[0])
        card0 = step0(DEVICE, check)
    t0 = time.perf_counter()
    cpu0 = step0("cpu", check)
    t_cpu = time.perf_counter() - t0
    merit_rel = abs(card0[0] - cpu0[0])/abs(cpu0[0])
    grad_rel = {k: float((card0[1][k] - v).abs().max()/v.abs().max())
                for k, v in cpu0[1].items()}
    log("step 0 card vs CPU plain%s: merit %.15g vs %.15g (rel %.2e), "
        "gradient rel to its max %s, CPU %.2f s for 1 step%s"
        % (" at %d hexapolar nrays a bundle on both devices" % check_nrays
           if check_nrays else "", card0[0], cpu0[0], merit_rel,
           {k: "%.2e" % v for k, v in grad_rel.items()}, t_cpu, timed))
    failures = [] if merit_rel <= OPT_MERIT_REL else ["step 0 merit"]
    return check, failures + ["step 0 gradient of " + k
                              for k, v in grad_rel.items()
                              if not v <= OPT_GRAD_REL]


def designer_loop(s, title, select, scales=None, check_nrays=None,
                  fields=None, lr=OPT_LR):
    """bundles_from_system (3 fields -- or `fields` -- x 3 wavelengths,
    hexapolar nrays N_OPT) -> optimize_grad(engine="adjoint", select,
    scales) in float64 for OPT_STEPS Adam steps at `lr` on the card, its
    step 0 against the same call on the CPU plain versions
    (step0_cross_check), then write_back_table of the fields with an
    element attribute.  Returns (the launches of the card's run, counted
    from 0 at its start; mean seconds of the later steps; the bundles)."""
    from rayopt_tpu_torch.parallel import (
        bundles_from_system, bundles_to, optimize_grad, write_back_table)
    from rayopt_tpu_torch.parallel.grad import _WRITE_BACK
    log("== %s, bundles_from_system (hexapolar, nrays %d) -> "
        "optimize_grad(engine='adjoint', select=%s, scales=%s), float64, %d "
        "Adam steps at lr %g" % (title, N_OPT, select, scales and {
            k: getattr(v, "shape", v) for k, v in scales.items()},
            OPT_STEPS, lr))
    t0 = time.perf_counter()
    efl0 = float(s.paraxial.focal_length[1])
    fields = s.fields if fields is None else fields

    def aimed(nrays):
        return bundles_from_system(s, fields=fields, nrays=nrays,
                                   distribution="hexapolar")
    bundles = aimed(N_OPT)
    log("%d bundles (%d fields x %d wavelengths) of %d rays, %d rays in "
        "all, aimed in %.2f s" % (len(bundles), len(fields),
                                 len(s.wavelengths), bundles[0][0].shape[0],
                                 sum(b[0].shape[0] for b in bundles),
                                 time.perf_counter() - t0))
    table = s.table()        # the bundles and the table: the default device

    def step0(device, b):
        grads = {}
        _, (merit,) = optimize_grad(s.table(device=device),
                                    bundles_to(b, device), select=select,
                                    steps=1, lr=lr, scales=scales,
                                    engine="adjoint",
                                    callback=step0_grads(grads))
        return merit, grads
    grads0, ends = {}, []
    reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # the coefficients of the rows with no figure are baked out, as
        # intended
        warnings.simplefilter("ignore")
        tab_opt, hist = optimize_grad(table, bundles, select=select,
                                      steps=OPT_STEPS, lr=lr,
                                      scales=scales, engine="adjoint",
                                      callback=step0_grads(grads0, ends))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        steps = np.diff([t0] + ends[:OPT_STEPS])
        launches = read_launches()
        log("merit history (sum of %d spot RMS, mm): %s | card %.2f s for "
            "%d steps (step 0 %.3f s, later steps mean %.4f s)"
            % (len(bundles), " ".join("%.12g" % v for v in hist), t_card,
               OPT_STEPS, steps[0], steps[1:].mean()))
        _, failures = step0_cross_check(step0, (hist[0], grads0), bundles,
                                        aimed, check_nrays)
    written = [k for k in select if k in _WRITE_BACK]
    write_back_table(s, tab_opt, written)
    efl1 = float(s.paraxial.focal_length[1])
    log("write_back_table of %s: EFL %.8f -> %.8f mm" % (written, efl0,
                                                         efl1))
    log("== launch counts on the %s: %s" % (title.split(":")[0], launches))
    if not hist[-1] < hist[0]:
        failures.append("the merit did not fall")
    if np.isfinite(efl0) and not np.isfinite(efl1):
        # (an on-axis object, as the Schmidt corrector's, has no
        # paraxial chief ray: its EFL is NaN before and after)
        failures.append("EFL after write-back")
    if not (launches["weighted_moments"] and launches["merit_adjoint"]):
        failures.append("K4 or K5 never launched: %s" % launches)
    if failures:
        raise AssertionError("%s failed: %s" % (title, ", ".join(failures)))
    return launches, float(steps[1:].mean()), bundles


def _live_of(out):
    """The rays whose final x, y and uz are finite."""
    return (torch.isfinite(out[0]) & torch.isfinite(out[1])
            & torch.isfinite(out[5]))


def phase_multi_check(tabs, specs, lens="double Gauss", bundle=bench_bundle,
                      clips=(False, True), fields=GRAD_FIELDS,
                      loop=ACHROM_FIELDS,
                      dtypes=(torch.float32, torch.float64), moments=True):
    """K3, K6 and K7 against their plain versions on the card at N_CHECK
    rays of `bundle` in `dtypes` (the aspheric lenses: unclipped only);
    K7's parameter cotangents by `fields` (the aspheric lenses: the
    coefficient columns too; the anamorphic ones curvature_dx and
    conic_dx; the phase ones grating_dy and the DOE coefficients) and,
    unclipped, its loop key for the fields `loop` (None: none).  Without
    `moments`, K3's trace alone (the spectrograph's float32: its 56-85 mm
    off-axis centroid cancels the moment formula's float32 digits), its
    float32 positions held to F32_ABS scaled from the double Gauss's ~30
    mm coordinates to the image's (the same float32 ulps).  Returns the
    float32 errors."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import (
        _nslots, weighted_moments_multi, weighted_moments_multi_reference,
        merit_adjoint_multi, merit_adjoint_multi_reference,
        union_spot_rms_from_moments)
    from rayopt_tpu_torch.ops.cuda_trace import (
        doe_width, figure_widths, spot_rms_from_moments, trace_final,
        trace_final_reference, trace_multi, trace_multi_reference, xy_width)
    from rayopt_tpu_torch.ops.tables import table_at
    nlam = tabs.curvature.shape[0]
    # K7's columns: SLOTS, the table's coefficients, the anamorphic two
    nq = _nslots(tabs, specs)
    log("== K3/K6/K7 vs plain on the card (%s, %d wavelengths, %d rays, "
        "weights uniform in [0.5, 1.5])" % (lens, nlam, N_CHECK))
    rms = {}     # K3's and K6's spot RMS by (what, dtype)
    worst = {"trace_multi": 0., "weighted_moments_multi": 0.,
             "merit_adjoint_multi": 0.}
    failures = []
    for dtype in dtypes:
        f64 = dtype == torch.float64
        dt = str(dtype)[6:]
        state = bundle(N_CHECK, dtype, SEED)
        w = bench_weights(N_CHECK, dtype, SEED + 2)
        got = trace_multi(tabs, specs, state)
        want = trace_multi_reference(tabs, specs, state)
        if moments:
            mom = trace_multi(tabs, specs, state, merit=True)
            mref = trace_multi_reference(tabs, specs, state, merit=True)
        torch.cuda.synchronize()
        for li in range(nlam):
            f32_abs = F32_ABS
            if not moments:
                image = max(float(c[torch.isfinite(c)].double().abs().max())
                            for c in want[li][0][:3])
                f32_abs = F32_ABS*max(1., image/30.)
            ok, err, rel, masks = compare_final((*got[li][0], got[li][1]),
                                                (*want[li][0], want[li][1]),
                                                dtype, f32_abs)
            ok = ok and masks == 0
            if not moments:
                log("K3 %s wavelength %d: trace max abs err %.3e (limit "
                    "%.3e), max rel err %.3e, NaN masks differ on %d rays "
                    "-> %s" % (dt, li, err, f32_abs, rel, masks,
                               "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K3 %s wavelength %d" % (dt, li))
                if not f64:
                    worst["trace_multi"] = max(worst["trace_multi"], err)
                continue
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
            rms[("K3 merit wavelength %d" % li, dtype)] = float(
                spot_rms_from_moments(*mom[li]))
            if not f64:
                worst["trace_multi"] = max(worst["trace_multi"], err)
        for clip in clips if moments else ():
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
            rms[("K6 union clip=%s" % clip, dtype)] = ug
            ct = rms_cotangent(mref)
            pg, cst, cw = merit_adjoint_multi(tabs, specs, state, w, ct, clip)
            pr, sr, wr = merit_adjoint_multi_reference(tabs, specs, state, w,
                                                       ct, clip)
            torch.cuda.synchronize()
            lim = GRAD_F64_REL if f64 else GRAD_F32_REL
            per_lam = [compare_param_grads(pg[li], pr[li], lim, fields)
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
            if not clip and loop:
                # the achromatization path's key: its slots, no ray
                # cotangents, the rest exact zeros
                live_slots = CS.live_mask(CS.live_slots(
                    specs, loop, figure_widths(tabs, specs),
                    doe_width(tabs, specs), xy_width(tabs, specs)),
                    nq).to(DEVICE)
                pa, ca, wa = merit_adjoint_multi(tabs, specs, state, w, ct,
                                                 clip, fields=loop,
                                                 rays=False)
                torch.cuda.synchronize()
                per_lam = [compare_param_grads(
                    pa[li], torch.where(live_slots, pr[li], 0.), lim, fields)
                    for li in range(nlam)]
                dead_zero = not bool(pa[:, ~live_slots].any())
                ok = (all(v[2] for f in per_lam for v in f.values())
                      and dead_zero and ca is None and wa is None)
                log("K7 %s, the achromatization key (%d live slots a "
                    "wavelength, no ray cotangents): largest error %.3e, "
                    "the rest exact zeros %s -> %s"
                    % (tag, int(live_slots.sum()),
                       max(v[0] for f in per_lam for v in f.values()),
                       dead_zero, "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K7 %s achromatization key" % tag)
            if not f64:
                worst["weighted_moments_multi"] = max(
                    worst["weighted_moments_multi"], abs(ug - uw))
                worst["merit_adjoint_multi"] = max(
                    worst["merit_adjoint_multi"],
                    *(v[0] for f in per_lam for v in f.values()))
    for what in sorted({k[0] for k in rms}) if len(dtypes) == 2 else ():
        r32, r64 = rms[(what, torch.float32)], rms[(what, torch.float64)]
        rel = abs(r32 - r64)/r64
        log("%s: float32 spot RMS %.9g vs float64 %.9g, rel %.3e"
            % (what, r32, r64, rel))
        if not rel <= 1e-4:
            failures.append("%s float32 vs float64" % what)
    if failures:
        raise AssertionError("kernel disagrees with its plain version on "
                             "the %s: %s" % (lens, ", ".join(failures)))
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


def glass_slots(s):
    """(glass assignment, mirror rows) of a system: glass.
    glass_assignment's map, or for a system with a mirror (which it
    refuses: past a mirror the propagated indices flip sign) the same
    map of its solid elements ahead of the mirror, the mirror and every
    row after it fixed, and the mirror rows, whose mu (-1) glass_tables'
    n_before/n_after ratio would overwrite.  A solid element past a
    mirror raises."""
    from rayopt_tpu_torch import glass
    mirrors = [j for j, e in enumerate(s)
               if getattr(getattr(e, "material", None), "mirror", False)]
    if not mirrors:
        return glass.glass_assignment(s), mirrors
    a_before, a_after, owners, cur = [], [], [], -1
    for j, e in enumerate(s):
        a_before.append(cur)
        mat = getattr(e, "material", None)
        if mat is not None:
            solid = getattr(mat, "solid", False) and j not in mirrors
            if solid and j > mirrors[0]:
                raise NotImplementedError("a solid element past a mirror")
            if solid:
                owners.append(j)
            cur = len(owners) - 1 if solid else -1
        a_after.append(cur)
    return (np.asarray(a_before, np.int32), np.asarray(a_after, np.int32),
            owners), mirrors


def phase_glass_path(s=None, lens="double Gauss", check_nrays=None,
                     slots=6, fields=None):
    """The achromatization path, through the entry points a user calls:
    stacked tables, glass relaxation of the lens's `slots` glasses, the
    polychromatic adjoint merit at three fields (or `fields`) and
    torch.optim.Adam (over curvatures, distances, the glasses and, on an
    aspheric lens, row ASPH_ROW's coefficients over ASPH_SCALES, on an
    anamorphic lens curvature_dx at the curvatures' lr, on a lens with a
    kinoform its phase coefficient A at PHASE_A_LR, each wavelength's
    DOE row written as System.table writes it, m lambda/(2 pi n')
    A/R^2, on a freeform lens xy_poly over freeform_scales at FF_LR),
    with K3 reporting the spots.  Step 0 is held against
    the same call on the CPU plain versions (step0_cross_check; with
    check_nrays K3's float64 spot RMS on those bundles against the
    CPU's too).  Returns (the launches of the loop and its K3 reports,
    counted from 0 at their start; mean seconds of the later steps; the
    bundles)."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import union_spot_rms_from_moments
    from rayopt_tpu_torch.ops.cuda_trace import (
        carries_anamorphic, multi_specs, spot_rms_from_moments, trace_multi,
        trace_multi_reference)
    from rayopt_tpu_torch.parallel import (bundles_from_system, bundles_to,
                                           freeform_scales)
    s = s or double_gauss()
    fields = FIELDS if fields is None else fields
    tabs = s.tables()            # the default device: the card
    asph = bool(tabs.aspherics.shape[-1])
    specs = multi_specs(tabs, None)
    anam = carries_anamorphic(specs)
    # a freeform lens's XY coefficients, normalized (optimize_grad's
    # scales): the plate's figure in mm of sag at its norm radius
    ff = any(sp.freeform for sp in specs)
    xy_scale = torch.from_numpy(freeform_scales(s))
    xy0 = tabs.xy_poly[0].detach().cpu() if ff else None
    # a kinoform's row, element and the factor of its coefficient in each
    # wavelength's doe column (System.table's m lambda/(2 pi n') / R^2)
    kino = next((j for j, sp in enumerate(specs) if sp.doe), None)
    if kino is not None:
        el = s[kino]
        a_fac = torch.tensor([
            el.diffraction_order*(lam/s.scale)/(2*np.pi)/el.norm_radius**2
            for lam in s.wavelengths], dtype=torch.float64)
    asg, mirrors = glass_slots(s)
    log("== achromatization path: %s, System.tables -> %s -> "
        "glass_tables(glass_box_decode(logits)) -> "
        "glass.polychromatic_spot_rms(engine='adjoint') at fields %s, "
        "float64, %d Adam steps, lr %s%s%s%s%s" % (
            lens, "glass_slots (the solids ahead of mirror row(s) %s; "
            "their mu kept)" % mirrors if mirrors else "glass_assignment",
            fields, GLASS_STEPS, GLASS_LR,
            ", row %d's aspherics over scales %s at the curvatures' lr"
            % (ASPH_ROW, ASPH_SCALES["aspherics"]) if asph else "",
            ", curvature_dx at the curvatures' lr" if anam else "",
            ", row %d's kinoform coefficient A at lr %g" % (kino, PHASE_A_LR)
            if kino is not None else "",
            ", xy_poly over freeform_scales at lr %g" % FF_LR if ff
            else ""))
    t0 = time.perf_counter()
    nlam = tabs.curvature.shape[0]
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    log("%d wavelengths %s; %d glass slots owned by elements %s: nd %s, "
        "vd %s" % (nlam, s.wavelengths, len(asg[2]), asg[2],
                   np.round(nd0, 6).tolist(), np.round(vd0, 4).tolist()))
    if len(asg[2]) != slots:
        raise AssertionError("expected %d glass slots, got %s"
                             % (slots, asg[2]))

    def aimed(nrays):
        return bundles_from_system(s, fields=fields,
                                   wavelengths=[s.wavelengths[0]],
                                   nrays=nrays, distribution="hexapolar")
    bundles = aimed(N_GLASS)
    log("bundles: distribution hexapolar, nrays %d -> %s rays at fields %s,"
        " aimed at %g m in %.2f s" % (N_GLASS, [b[0].shape[0] for b in
                                                  bundles], fields,
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
    a0 = tabs.aspherics[0].detach().cpu()
    scales = torch.tensor(ASPH_SCALES["aspherics"], dtype=torch.float64)

    def start(device):
        out = {"curvature": tabs.curvature[0].detach().to(device).clone(),
               "distance": torch.from_numpy(d0).to(device).clone(),
               "xi_nd": torch.from_numpy(xi_nd0).to(device).clone(),
               "xi_vd": torch.from_numpy(xi_vd0).to(device).clone()}
        if asph:
            out["aspherics"] = (a0[ASPH_ROW]/scales).to(device)
        if anam:
            out["curvature_dx"] = tabs.curvature_dx[0].detach().to(
                device).clone()
        if kino is not None:
            out["phase_a"] = torch.tensor(
                [float(s[kino].phase_coefficients[0])], dtype=torch.float64,
                device=device)
        if ff:
            out["xy_poly"] = (xy0/xy_scale).to(device)
        return out

    def relaxed(params, tables):
        dev = params["distance"].device
        u = unit.to(dev)
        tb = tables.replace(
            curvature=params["curvature"].expand(nlam, -1),
            offset=(u*params["distance"][:, None]).expand(nlam, -1, -1))
        if asph:
            a = a0.to(dev)
            a = torch.cat([a[:ASPH_ROW], (params["aspherics"]
                                          * scales.to(dev))[None],
                           a[ASPH_ROW + 1:]])
            tb = tb.replace(aspherics=a.expand(nlam, -1, -1))
        if anam:
            tb = tb.replace(curvature_dx=params["curvature_dx"].expand(
                nlam, -1))
        if ff:
            tb = tb.replace(xy_poly=(params["xy_poly"]*xy_scale.to(dev))
                            .expand(nlam, -1, -1))
        nd, vd = glass.glass_box_decode(params["xi_nd"], params["xi_vd"])
        tb = glass.glass_tables(tb, nd, vd, asg, s.wavelengths)
        if mirrors:
            # the mirror rows keep their mu (-1)
            mu = tb.mu.clone()
            mu[:, mirrors] = -1.
            tb = tb.replace(mu=mu)
        if kino is not None:
            # each wavelength's psi(r^2) coefficient from A and its own
            # n' (System.table's), the other coefficients as they are
            doe = tb.doe.clone()
            doe[:, kino, 0] = (a_fac.to(dev)*params["phase_a"]
                               / tb.n_after[:, kino].abs())
            tb = tb.replace(doe=doe)
        return tb

    def merit(params, tables, bundles):
        tb = relaxed(params, tables)
        return sum(glass.polychromatic_spot_rms(tb, y0, u0, w, specs=specs,
                                                engine="adjoint")
                   for y0, u0, w, _ in bundles)

    def spots(tb, bundles, trace):
        """[(per-wavelength spot RMS, union, live rays)] a field."""
        out = []
        for y0, u0, _, _ in bundles:
            state = tuple(c.contiguous() for c in (*y0.T, *u0.T))
            mom = [tuple(map(torch.as_tensor, m))
                   for m in trace(tb, specs, state, merit=True)]
            out.append(([float(spot_rms_from_moments(*m)) for m in mom],
                        float(union_spot_rms_from_moments(
                            torch.stack([torch.stack(m) for m in mom]))),
                        [int(m[0]) for m in mom]))
        return out

    def report(params, when):
        with torch.no_grad():
            tb = relaxed(params, tabs)
            for field, (per, union, live) in zip(fields, spots(
                    tb, bundles, trace_multi)):
                log("K3 %s, field %.1f: spot RMS mm per wavelength %s, union "
                    "%.9g, live rays %s" % (when, field, " ".join(
                        "%.9g" % v for v in per), union, live))
            nd, vd = glass.glass_box_decode(params["xi_nd"],
                                            params["xi_vd"])
            log("relaxed glasses %s: nd %s, vd %s"
                % (when, np.round(nd.cpu().numpy(), 6).tolist(),
                   np.round(vd.cpu().numpy(), 4).tolist()))
            if asph:
                log("row %d's aspherics %s: %s" % (
                    ASPH_ROW, when, (params["aspherics"].cpu()
                                     * scales).tolist()))
            if kino is not None:
                log("row %d's kinoform coefficient A %s: %.12g" % (
                    kino, when, float(params["phase_a"])))
            if ff:
                rows = [j for j, sp in enumerate(specs) if sp.freeform]
                log("the freeform rows' normalized xy_poly %s: %s" % (
                    when, " | ".join(
                        " ".join("%.6g" % v for v in params["xy_poly"][j])
                        for j in rows)))

    def step0(device, b):
        p = {k: v.requires_grad_() for k, v in start(device).items()}
        value = merit(p, s.tables(device=device), bundles_to(b, device))
        value.backward()
        return float(value.detach()), {k: v.grad.detach().double().cpu()
                                       for k, v in p.items()}

    params = {k: v.requires_grad_() for k, v in start(DEVICE).items()}
    reset_launches()
    report(params, "before")
    groups = [{"params": [params["curvature"]], "lr": GLASS_LR["curvature"]},
              {"params": [params["distance"]], "lr": GLASS_LR["distance"]},
              {"params": [params["xi_nd"], params["xi_vd"]],
               "lr": GLASS_LR["glass"]}]
    if asph:
        groups.append({"params": [params["aspherics"]],
                       "lr": GLASS_LR["curvature"]})
    if anam:
        groups.append({"params": [params["curvature_dx"]],
                       "lr": GLASS_LR["curvature"]})
    if kino is not None:
        groups.append({"params": [params["phase_a"]], "lr": PHASE_A_LR})
    if ff:
        groups.append({"params": [params["xy_poly"]], "lr": FF_LR})
    opt = torch.optim.Adam(groups)
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
                grads0 = {k: v.grad.detach().double().cpu().clone()
                          for k, v in params.items()}
            opt.step()
            hist.append(float(value.detach()))
            ends.append(time.perf_counter())
        steps = np.diff([t0] + ends)
        report(params, "after")
        launches = read_launches()
        log("merit history (sum of %d union spot RMS, mm): %s | card: step 0 "
            "%.3f s, later steps mean %.4f s"
            % (len(bundles), " ".join("%.12g" % v for v in hist), steps[0],
               steps[1:].mean()))
        check, failures = step0_cross_check(step0, (hist[0], grads0),
                                            bundles, aimed, check_nrays)
        if check_nrays:
            # K3's float64 spots on the card against the CPU plain trace
            check_cpu = bundles_to(check, "cpu")
            with torch.no_grad():
                card = spots(relaxed(start(DEVICE), tabs), check,
                             trace_multi)
                host = spots(relaxed(start("cpu"), s.tables(device="cpu")),
                             check_cpu, trace_multi_reference)
            for field, (pc, uc, lc), (ph, uh, lh) in zip(fields, card, host):
                rel = max(abs(a - b)/b for a, b in zip(pc + [uc], ph + [uh]))
                ok = rel <= PARITY_REL and lc == lh
                log("K3 float64 vs the CPU plain trace, field %.1f (%d "
                    "rays): spot RMS mm per wavelength %s vs %s, union "
                    "%.12g vs %.12g, rel %.2e, live %s vs %s -> %s"
                    % (field, check[0][0].shape[0],
                       " ".join("%.12g" % v for v in pc),
                       " ".join("%.12g" % v for v in ph), uc, uh, rel, lc,
                       lh, "ok" if ok else "FAIL"))
                if not ok:
                    failures.append("K3 spots at field %.1f" % field)
    log("== launch counts on the achromatization path (%s): %s"
        % (lens, launches))
    if not hist[-1] < hist[0]:
        failures.append("the merit did not fall")
    multi = ("trace_multi", "weighted_moments_multi", "merit_adjoint_multi")
    if not all(launches[k] for k in multi):
        failures.append("K3, K6 or K7 never launched: %s" % launches)
    if failures:
        raise AssertionError("achromatization path on the %s failed: %s"
                             % (lens, ", ".join(failures)))
    return launches, float(steps[1:].mean()), bundles


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


def phase_opd_check(s, table, specs, lens="double Gauss", bundle=None,
                    clips=(False, True), fields=None, design=DESIGN_FIELDS,
                    dtypes=(torch.float64, torch.float32), hold_f32_k9=True):
    """K8 and K9 against their plain versions on the card: K8's k and
    landing; K9's parameter (n_before included; the aspheric lenses:
    the coefficient columns too, `fields`), ray and centre cotangents
    for the wavefront-RMS and the Strehl cotangents, and, unclipped, its
    loop key for the fields `design` (None: none).  In float64 against
    the plain version; in float32 K8 against the plain float32 version,
    K9's sums against the float64 plain version on the same inputs (see
    below).  `bundle(n, dtype, seed, widen)`: opd_bundle's (the aspheric
    lenses: unclipped only); `dtypes` (the figured anamorphic lenses:
    float64 only).  In float64 a parameter field is held to its scale
    floored at OPD_COLUMN_FLOOR of the largest field's, as
    compare_param_grads floors K5's at COLUMN_FLOOR.  Without
    `hold_f32_k9` K9's float32 sums are logged, not held
    (the Schmidt plates: their ~7e6-wave paths leave the float32 plain
    version's mu column ~6% of its sum of |term| off the float64 one).
    Returns the float32 errors."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import (
        _nslots, opd_adjoint, opd_adjoint_reference, opd_chain,
        opd_chain_reference)
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 xy_width)
    bundle = bundle or opd_bundle
    fields = fields or OPD_GRAD_FIELDS
    # K9's columns: OPD_SLOTS, the table's coefficients, the anamorphic two
    nq = _nslots(table, specs, CS.OPD_SLOTS)
    log("== K8/K9 vs plain on the card (%s, %d rays, ray 0 the chief ray; "
        "reference sphere radius %.6f mm, wavelength %g m)"
        % (lens, N_CHECK, -s.image.pupil.distance, s.wavelengths[0]))
    worst = {"opd_chain": 0., "opd_adjoint": 0.}
    failures = []

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    def held(scales, f64):
        # float64: each field's scale, floored at OPD_COLUMN_FLOOR of the
        # largest
        top = max(scales)*(OPD_COLUMN_FLOOR if f64 else 0.)
        return [max(sc, top) if sc else 0. for sc in scales]
    for dtype in dtypes:
        f64 = dtype == torch.float64
        dt = str(dtype)[6:]
        for clip in clips:
            tag = "%s clip=%s" % (dt, clip)
            # clipped: 1.5x wider, so that the apertures vignette
            state = bundle(N_CHECK, dtype, SEED, 1.5 if clip else 1.)
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
                errs = {}
                scales = held([float(mass[:, cols].double().abs().max())
                               for _, cols in fields], f64)
                for (name, cols), hs in zip(fields, scales):
                    e = err(pg[:, cols], base[:, cols])
                    ep = 0. if f64 else err(pr[:, cols], base[:, cols])
                    sc = float(mass[:, cols].double().abs().max())
                    errs[name] = (e, ep, sc,
                                  bool(torch.isfinite(pg[:, cols]).all())
                                  and e <= lim*hs)
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
                ok = (all(v[3] for v in errs.values()) and finite
                      and dead_zero and ce <= lim*cscale
                      and ray_rel <= (GRAD_F64_REL if f64 else F32_RAY_REL)
                      and not pg[0].any())
                held_here = f64 or hold_f32_k9
                log("K9 %s %s: %s; centre err %.3e (plain %.3e) of scale "
                    "%.3e | rays rel err %.3e, dead rays all zero %s, all "
                    "finite %s -> %s"
                    % (tag, kind, "; ".join(
                        "%s err %.3e (plain %.3e) of scale %.3e" % (k, *v[:3])
                        for k, v in errs.items()), ce, cep, cscale, ray_rel,
                       dead_zero, finite, ("ok" if ok else "FAIL")
                       if held_here else "not held (%s)"
                       % ("within" if ok else "outside")))
                if not ok and held_here:
                    failures.append("K9 %s %s" % (tag, kind))
                if not clip and kind == "wavefront" and design:
                    # the design path's key: its slots and the centre, no
                    # ray cotangents, the rest exact zeros
                    live_slots = CS.live_mask(CS.opd_live_slots(
                        specs, design, figure_widths(table, specs),
                        doe_width(table, specs), xy_width(table, specs)),
                        nq).to(DEVICE)
                    pd, sd, cd = opd_adjoint(table, specs, state, aux, cts,
                                             clip, fields=design,
                                             rays=False)
                    torch.cuda.synchronize()
                    derrs = [err(pd[:, cols], torch.where(
                        live_slots, base, 0.)[:, cols]) for _, cols in
                        fields]
                    scales = [float(mass[:, cols].double().abs().max())
                              for _, cols in fields]
                    dead_zero = not bool(pd[~live_slots].any())
                    ok = (all(e <= lim*sc for e, sc in zip(
                        derrs, held(scales, f64)))
                          and err(cd, base_c) <= lim*cscale and dead_zero
                          and sd is None)
                    log("K9 %s, the design key (%d live slots and the "
                        "centre, no ray cotangents): errors %s of scales %s, "
                        "centre %.3e, the rest exact zeros %s -> %s"
                        % (tag, int(live_slots.sum()), " ".join(
                            "%.3e" % e for e in derrs), " ".join(
                            "%.3e" % v for v in scales), err(cd, base_c),
                           dead_zero, "ok" if ok else "FAIL"))
                    if not ok:
                        failures.append("K9 %s design key" % tag)
                if not f64:
                    worst["opd_adjoint"] = max(
                        worst["opd_adjoint"],
                        *(v[0] for v in errs.values()))
    if failures:
        raise AssertionError("kernel disagrees with its plain version on "
                             "the %s: %s" % (lens, ", ".join(failures)))
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


def phase_design_path(s=None, lens="double Gauss", select=OPT_SELECT,
                      scales=None, check_nrays=None, fields=None,
                      lr=DESIGN_LR):
    """The composite design step, through the entry points a user
    calls: 9 spot bundles (K4/K5; 3 fields -- or `fields` -- x 3
    wavelengths), 3 wavefront bundles (K8/K9; a field each) and a
    focal-length penalty (none where the paraxial EFL is not finite: an
    on-axis object, as the Schmidt corrector's), optimize_grad over
    `select` (with `scales`) at `lr`, write_back_table; then the step's
    breakdown, the Strehl, PSF and MTF report and the host OPD/Zernike
    cross-check.  Step 0 is held against the same call on the CPU plain
    versions (step0_cross_check).  Returns the launches of the
    optimize_grad run, the mean seconds of its later steps and the (spot,
    wavefront) bundles."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_spot_rms,
                                                adjoint_wavefront_rms)
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.parallel import (
        bundles_from_system, bundles_to, composite_merit, first_order_penalty,
        mtf_radial, optimize_grad, paraxial_seed, psf_grid, psf_polychromatic,
        strehl_marechal, strehl_ratio, write_back_table)
    s = s or double_gauss()
    fields = FIELDS if fields is None else fields
    efl0 = float(s.paraxial.focal_length[1])
    nspot = len(fields)*len(s.wavelengths)
    log("== design path: %s, %d spot bundles (%d fields x %d wavelengths, "
        "adjoint_spot_rms) + %d wavefront bundles (fields %s at %g m, "
        "adjoint_wavefront_rms)%s -> optimize_grad(select=%s, scales=%s), "
        "float64, %d Adam steps at lr %g"
        % (lens, nspot, len(fields), len(s.wavelengths), len(fields),
           fields, s.wavelengths[0],
           " + %g x focal-length penalty" % DESIGN_PENALTY
           if np.isfinite(efl0) else " (no focal-length penalty: the "
           "paraxial EFL is %g)" % efl0, select, scales and {
               k: getattr(v, "shape", v) for k, v in scales.items()},
           DESIGN_STEPS, lr))
    t0 = time.perf_counter()

    def aimed(nrays):
        return (bundles_from_system(s, fields=fields, nrays=nrays,
                                    distribution="hexapolar"),
                bundles_from_system(s, fields=fields,
                                    wavelengths=[s.wavelengths[0]],
                                    nrays=nrays, distribution="hexapolar"))
    spot, wave = aimed(N_DESIGN)
    log("%d spot and %d wavefront bundles of %d rays (ray 0 the chief ray), "
        "aimed in %.2f s" % (len(spot), len(wave), spot[0][0].shape[0],
                             time.perf_counter() - t0))
    table = s.table()
    specs = specialize(table)
    seed = paraxial_seed(s)
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
            if not np.isfinite(efl0):
                return 0.*tab.curvature.sum()
            return DESIGN_PENALTY*first_order_penalty(
                tab, seed, {"focal_length": (1, efl0)})
        return spots, wavefronts, penalty

    def report(tab, when):
        for field, (y0, u0, w, _) in zip(fields, wave):
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

    def step0(device, b):
        spot_d, wave_d = (bundles_to(x, device) for x in b)
        grads = {}
        _, (merit,) = optimize_grad(s.table(device=device), spot_d,
                                    select=select, steps=1, lr=lr,
                                    scales=scales,
                                    merit=composite_merit(
                                        *merit_parts(spot_d, wave_d)),
                                    callback=step0_grads(grads))
        return merit, grads
    grads0, ends = {}, []
    with warnings.catch_warnings():
        # flat rows bake out their curvature, on-axis rows their
        # transverse offsets
        warnings.simplefilter("ignore")
        report(table, "before")
        reset_launches()
        t0 = time.perf_counter()
        tab_opt, hist = optimize_grad(table, spot, select=select,
                                      steps=DESIGN_STEPS, lr=lr,
                                      scales=scales,
                                      merit=composite_merit(
                                          *merit_parts(spot, wave)),
                                      callback=step0_grads(grads0, ends))
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        launches = read_launches()
        steps = np.diff([t0] + ends[:DESIGN_STEPS])
        log("merit history (%d spot RMS mm + %d wavefront RMS waves + "
            "penalty): %s | card %.2f s for %d steps (step 0 %.3f s, later "
            "steps mean %.4f s, min %.4f s)"
            % (nspot, len(fields), " ".join("%.12g" % v for v in hist),
               t_card, DESIGN_STEPS, steps[0], steps[1:].mean(),
               steps[1:].min()))
        _, failures = step0_cross_check(step0, (hist[0], grads0),
                                        (spot, wave), aimed, check_nrays)
        breakdown = step_breakdown(tab_opt, specs, wave,
                                   merit_parts(spot, wave), nspot)
        report(tab_opt, "after")
    log("design step by part, forward and backward on the card (wall ms, "
        "mean of %d after one warm-up; not counted as launches of the "
        "path): %s" % (BREAKDOWN_REPS, ", ".join(
            "%s %.3f" % kv for kv in breakdown.items())))
    log("== launch counts on the design path (%s): %s" % (lens, launches))
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
        poly = [spot[li*len(fields)] for li in range(len(s.wavelengths))]
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
    for name, v in (("PSF", psf), ("MTF x", mtf_x), ("MTF y", mtf_y),
                    ("polychromatic PSF", psf_p)):
        if not bool(torch.isfinite(v).all()):
            failures.append(name + " not finite")
    if abs(float(psf.sum()) - 1) > 1e-9 or abs(float(psf_p.sum()) - 1) > 1e-9:
        failures.append("PSF sum")
    if float(mtf_x[0]) != 1. or float(mtf_y[0]) != 1.:
        failures.append("MTF(0)")
    failures += host_opd_check(s, opd_kw)
    if not all(b < a for a, b in zip(hist[:-1], hist[1:])):
        failures.append("the merit did not fall at every step")
    if np.isfinite(efl0) and not np.isfinite(efl1):
        # (an on-axis object, as the Schmidt corrector's, has no
        # paraxial chief ray: its EFL is NaN before and after)
        failures.append("EFL after write-back")
    path = ("weighted_moments", "merit_adjoint", "opd_chain", "opd_adjoint")
    if not all(launches[k] for k in path):
        failures.append("K4, K5, K8 or K9 never launched: %s" % launches)
    if failures:
        raise AssertionError("design path on the %s failed: %s"
                             % (lens, ", ".join(failures)))
    return launches, float(steps[1:].mean()), (spot, wave)


def host_opd_check(s, opd_kw):
    """The host OPD and Zernike fit on axis (numpy) against K8 on the
    card, the written-back system's own exit pupil and wavelength.
    Returns the failures."""
    from rayopt_tpu_torch import GeometricTrace
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_opd_rays
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
    return [] if host_err <= HOST_OPD_ATOL else ["host OPD cross-check"]


# -- the aspheric rows: K1, K2, K4 and K5 on figured keys ---------------------

def aspheric_double_gauss():
    """The JAX package's aspheric double Gauss (its tests/test_df32.py,
    test_trace_parity_conic_aspheric): conics on rows 2 and 5, an even
    asphere on row 7; 12 traced surfaces, full width."""
    from rayopt_tpu_torch.models import double_gauss
    s = double_gauss()
    s[2].conic = -.7
    s[5].conic = .4
    s[ASPH_ROW].aspherics = [0., 1.2e-7, -3e-11]
    s.update()
    return s


def odd_singlet():
    """The JAX package's odd singlet (its tests/test_pallas.py,
    test_pallas_odd_aspherics): an even and odd figure on a conic
    front."""
    from rayopt_tpu_torch import Spheroid, System, air
    s = System()
    s.append(Spheroid(material=air, radius=9.))
    s.append(Spheroid(distance=8., curvature=1/45., conic=-.3,
                      aspherics=[0., 2e-7], aspherics_odd=[0., 1e-5, -2e-8],
                      material=1.6, radius=9.))
    s.append(Spheroid(distance=5., curvature=-1/80., material=air,
                      radius=9.))
    s.append(Spheroid(distance=70., material=None, radius=9.))
    s.wavelengths = [587.56e-9]
    s.update()
    return s


def asphere_cases():
    """{name: (system, table on the card, specs, figure widths)} of the
    two aspheric lenses."""
    from rayopt_tpu_torch.ops.cuda_trace import figure_widths
    from rayopt_tpu_torch.ops.kernels import specialize
    out = {}
    for name, build in (("aspheric double Gauss", aspheric_double_gauss),
                        ("odd singlet", odd_singlet)):
        s = build()
        table = s.table()
        specs = specialize(table)
        out[name] = (s, table, specs, figure_widths(table, specs))
    return out


def asphere_stack(name, s, table):
    """(stack of 3 tables, its specs) of an aspheric lens for K3, K6 and
    K7: the double Gauss's 3 wavelengths (System.tables); the singlet
    (one wavelength of a constant index) with its refracting rows' mu
    grown by 0, 1 and 2 % of mu - 1."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.ops.tables import stack_tables
    if name == "aspheric double Gauss":
        tabs = s.tables()
    else:
        tabs = stack_tables([table.replace(mu=1 + (table.mu - 1)*(1 + .01*li))
                             for li in range(3)])
    return tabs, multi_specs(tabs, None)


def singlet_opd_bundle(n, dtype, seed, widen=1.):
    """The singlet's bundle with ray 0 the chief ray, collimated at
    (0.5, 0.3) mm (off the axis, where its odd figure's gradient is
    NaN); `widen` scales the footprint."""
    state = [c.double().clone() for c in singlet_bundle(n, torch.float64,
                                                        seed)]
    for i, v in enumerate((.5, .3, 0., 0., 0., 1.)):
        if i < 2:
            state[i] = state[i]*widen
        state[i][0] = v
    return tuple(c.to(dtype).contiguous() for c in state)


def asphere_keys():
    """{tag: key} of the figured keys this script runs: on each aspheric
    lens, in both dtypes and unclipped, K1, K2, K4, K6, K8, K3 (merit
    and trace) and K1 on the stack's specs, and K5, K7 and K9 for every
    field with the ray cotangents (the checks and timings); on the
    double Gauss also the loops' keys without them -- K5 for the
    designer loop's fields (ASPH_SELECT) and the design loop's
    (ASPH_DESIGN_FIELDS), K7 for the achromatization loop's
    (ASPH_ACHROM_FIELDS), K9 for the design loop's -- and, in float64,
    the finite-difference checks' (K5: conic and aspherics; K7: mu and
    aspherics; K9: conic and aspherics) and the design step breakdown's
    (K5 and K9 for DESIGN_FIELDS)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    keys = {}
    for name, (s, table, specs, widths) in asphere_cases().items():
        tag = "aspheric" if name == "aspheric double Gauss" else "odd"
        _, mspecs = asphere_stack(name, s, table)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            keys["K1 %s %s" % (dt, tag)] = CS.trace_key(specs, dtype,
                                                        widths=widths)
            keys["K2 %s %s" % (dt, tag)] = CS.merit_key(specs, dtype,
                                                        widths=widths)
            keys["K4 %s %s" % (dt, tag)] = CS.moments_key(specs, dtype,
                                                          widths=widths)
            keys["K5 %s %s all rays=True" % (dt, tag)] = CS.adjoint_key(
                specs, dtype, fields=CS.FIELDS, widths=widths)
            for mode in ("merit", "trace"):
                keys["K3 %s %s %s" % (dt, tag, mode)] = CS.trace_multi_key(
                    mspecs, dtype, 3, mode == "merit", widths=widths)
            keys["K6 %s %s" % (dt, tag)] = CS.moments_multi_key(
                mspecs, dtype, False, 3, widths=widths)
            keys["K7 %s %s all rays=True" % (dt, tag)] = \
                CS.adjoint_multi_key(mspecs, dtype, widths=widths)
            keys["K1 %s %s stack" % (dt, tag)] = CS.trace_key(
                mspecs, dtype, widths=widths)
            keys["K8 %s %s" % (dt, tag)] = CS.opd_key(specs, dtype,
                                                      widths=widths)
            keys["K9 %s %s all rays=True" % (dt, tag)] = \
                CS.opd_adjoint_key(specs, dtype, widths=widths)
            if tag == "aspheric":
                keys["K5 %s aspheric designer rays=False" % dt] = \
                    CS.adjoint_key(specs, dtype, fields=ASPH_SELECT,
                                   rays=False, widths=widths)
                keys["K5 %s aspheric design rays=False" % dt] = \
                    CS.adjoint_key(specs, dtype, fields=ASPH_DESIGN_FIELDS,
                                   rays=False, widths=widths)
                keys["K7 %s aspheric achromatization rays=False" % dt] = \
                    CS.adjoint_multi_key(mspecs, dtype, False,
                                         ASPH_ACHROM_FIELDS, False,
                                         widths=widths)
                keys["K9 %s aspheric design rays=False" % dt] = \
                    CS.opd_adjoint_key(specs, dtype, False,
                                       ASPH_DESIGN_FIELDS, False,
                                       widths=widths)
        if tag == "aspheric":
            # the finite-difference checks' slot sets
            f64 = torch.float64
            keys["K5 float64 aspheric fd rays=False"] = CS.adjoint_key(
                specs, f64, fields=("conic", "aspherics"), rays=False,
                widths=widths)
            keys["K7 float64 aspheric fd rays=False"] = CS.adjoint_multi_key(
                mspecs, f64, False, ("mu", "aspherics"), False,
                widths=widths)
            keys["K9 float64 aspheric fd rays=False"] = CS.opd_adjoint_key(
                specs, f64, False, ("conic", "aspherics"), False,
                widths=widths)
            # the design step breakdown's (curvature and offset)
            keys["K5 float64 aspheric breakdown rays=False"] = \
                CS.adjoint_key(specs, f64, fields=DESIGN_FIELDS, rays=False,
                               widths=widths)
            keys["K9 float64 aspheric breakdown rays=False"] = \
                CS.opd_adjoint_key(specs, f64, False, DESIGN_FIELDS, False,
                                   widths=widths)
    return keys


def singlet_bundle(n, dtype, seed):
    """The odd singlet's bundle: x, y uniform in +-8 mm, slopes uniform
    in +-0.02 (no ray exactly on the axis, where an odd figure's
    gradient is NaN, as the reference's)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    xy = torch.empty((4, n), dtype=torch.float64, device=DEVICE)
    xy[:2].uniform_(-8., 8., generator=gen)
    xy[2:].uniform_(-.02, .02, generator=gen)
    uz = torch.sqrt(1 - xy[2]*xy[2] - xy[3]*xy[3])
    return tuple(c.to(dtype).contiguous()
                 for c in (xy[0], xy[1], torch.zeros_like(uz), xy[2], xy[3],
                           uz))


def asph_grad_fields(widths, opd=False):
    """K5's and K7's cotangent columns by table field, the
    coefficients' too; with `opd`, K9's (n_before before the
    coefficients)."""
    na, no = widths
    out = OPD_GRAD_FIELDS if opd else GRAD_FIELDS
    q0 = 7 if opd else 6
    if na:
        out += (("aspherics", slice(q0, q0 + na)),)
    if no:
        out += (("aspherics_odd", slice(q0 + na, q0 + na + no)),)
    return out


def phase_asphere_check():
    """Each figured key against its plain version on the card, unclipped,
    on the aspheric double Gauss and the odd singlet: K1, K2, K4 and K5
    (phase_check, phase_grad_check), K3, K6 and K7 on the lens's stack
    (phase_multi_check) and K8 and K9 (phase_opd_check), the adjoints
    with the coefficient columns and, on the double Gauss, the loops'
    keys; then K5's float64 gradient against central differences of the
    K4 merit for row 7's A4 and A6 and row 2's conic, and K7's and K9's
    (phase_asphere_fd_check).  Returns the float32 errors for the
    kernels line."""
    from rayopt_tpu_torch.ops.cuda_grad import spot_moments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    worst = {}
    for lens, (s, table, specs, widths) in asphere_cases().items():
        singlet = lens == "odd singlet"
        bundle = singlet_bundle if singlet else bench_bundle
        tabs, mspecs = asphere_stack(lens, s, table)
        for errs in (phase_check(table, specs, lens, bundle, (False,)),
                     phase_grad_check(table, specs, lens, bundle, (False,),
                                      asph_grad_fields(widths)),
                     phase_multi_check(
                         tabs, mspecs, lens + ", its stack", bundle,
                         (False,), asph_grad_fields(widths),
                         None if singlet else ASPH_ACHROM_FIELDS),
                     phase_opd_check(
                         s, table, specs, lens,
                         singlet_opd_bundle if singlet else None, (False,),
                         asph_grad_fields(widths, opd=True),
                         None if singlet else ASPH_DESIGN_FIELDS)):
            worst.update({k: max(v, worst.get(k, 0.))
                          for k, v in errs.items()})
    phase_asphere_fd_check()
    failures = []
    # K5 against central differences of the K4 merit, float64
    _, table, specs, _ = asphere_cases()["aspheric double Gauss"]
    state = bench_bundle(N_CHECK, torch.float64, SEED)
    w = bench_weights(N_CHECK, torch.float64, SEED + 2)
    a = table.aspherics.clone().requires_grad_()
    k = table.conic.clone().requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the baked rows, as intended
        mom = spot_moments(table.replace(aspherics=a, conic=k), state, w,
                           specs=specs)
    spot_rms_from_moments(*mom).backward()
    picks = (("A4", "aspherics", (ASPH_ROW, 1), a.grad[ASPH_ROW, 1]),
             ("A6", "aspherics", (ASPH_ROW, 2), a.grad[ASPH_ROW, 2]),
             ("conic", "conic", (2,), k.grad[2]))

    def merit(tab):
        return float(spot_rms_from_moments(*weighted_moments(tab, specs,
                                                             state, w)))
    log("== K5 on the aspheric double Gauss vs central differences of the "
        "K4 merit (float64, %d bench rays; steps %s)"
        % (N_CHECK, ASPH_FD_STEP))
    for what, field, idx, g in picks:
        h = ASPH_FD_STEP[what]
        side = []
        for sgn in (1., -1.):
            v = getattr(table, field).clone()
            v[idx] += sgn*h
            side.append(merit(table.replace(**{field: v})))
        fd = (side[0] - side[1])/(2*h)
        rel = abs(float(g) - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s of row %d: K5 %.12g, central difference %.12g, rel %.2e "
            "-> %s" % (what, idx[0], float(g), fd, rel,
                       "ok" if ok else "FAIL"))
        if not ok:
            failures.append("K5 vs finite differences, " + what)
    if failures:
        raise AssertionError("K5 on the aspheric double Gauss disagrees "
                             "with finite differences: "
                             + ", ".join(failures))
    return worst


def phase_asphere_fd_check():
    """On the aspheric double Gauss, float64, N_CHECK bench rays, against
    central differences: K7's gradient of the K6 merit (the union spot
    RMS of its 3 wavelengths) w.r.t. row ASPH_ROW's A4 and the vd of the
    glass slot with the largest gradient (through glass_tables), and
    K9's of the K8 wavefront RMS (ray 0 the chief ray) w.r.t. A4 and
    row 2's conic."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_wavefront_rms
    s, table, specs, _ = asphere_cases()["aspheric double Gauss"]
    tabs, mspecs = asphere_stack("aspheric double Gauss", s, table)
    nlam = tabs.curvature.shape[0]
    asg = glass.glass_assignment(s)
    nd0, vd0 = glass.initial_glass_params(s, asg[2])
    nd = torch.tensor(nd0, device=DEVICE)
    log("== K7 and K9 on the aspheric double Gauss vs central differences "
        "of the K6 merit and the K8 wavefront RMS (float64, %d bench rays; "
        "steps A4 %g, vd %g, conic %g)" % (N_CHECK, ASPH_FD_STEP["A4"],
                                           FD_VD_STEP, ASPH_FD_STEP["conic"]))
    state = bench_bundle(N_CHECK, torch.float64, SEED)
    w = bench_weights(N_CHECK, torch.float64, SEED + 2)
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    a0 = tabs.aspherics[0]

    def k6(a, vd):
        tb = glass.glass_tables(tabs.replace(aspherics=a.expand(
            nlam, -1, -1)), nd, vd, asg, s.wavelengths)
        return glass.polychromatic_spot_rms(tb, y0, u0, w, specs=mspecs,
                                            engine="adjoint")
    ostate = opd_bundle(N_CHECK, torch.float64, SEED)
    oy, ou = torch.stack(ostate[:3], 1), torch.stack(ostate[3:], 1)
    kw = dict(ref=0, radius=-s.image.pupil.distance,
              wavelength=s.wavelengths[0], scale=s.scale,
              finite=s.object.finite, specs=specs)

    def k8(tab):
        return adjoint_wavefront_rms(tab, oy, ou, **kw)
    a = a0.clone().requires_grad_()
    vd = torch.tensor(vd0, device=DEVICE, requires_grad=True)
    ak = table.aspherics.clone().requires_grad_()
    k = table.conic.clone().requires_grad_()
    with warnings.catch_warnings():
        # the baked rows, as intended
        warnings.simplefilter("ignore")
        k6(a, vd).backward()
        k8(table.replace(aspherics=ak, conic=k)).backward()
    j = int(torch.argmax(vd.grad.abs()))

    def bumped(base, idx, h):
        v = base.clone()
        v[idx] += h
        return v
    vd_t = torch.tensor(vd0, device=DEVICE)
    picks = (
        ("K7", "A4 of row %d" % ASPH_ROW, float(a.grad[ASPH_ROW, 1]),
         ASPH_FD_STEP["A4"],
         lambda h: k6(bumped(a0, (ASPH_ROW, 1), h), vd_t)),
        ("K7", "vd of slot %d (element %d)" % (j, asg[2][j]),
         float(vd.grad[j]), FD_VD_STEP,
         lambda h: k6(a0, bumped(vd_t, j, h))),
        ("K9", "A4 of row %d" % ASPH_ROW, float(ak.grad[ASPH_ROW, 1]),
         ASPH_FD_STEP["A4"],
         lambda h: k8(table.replace(aspherics=bumped(
             table.aspherics, (ASPH_ROW, 1), h)))),
        ("K9", "conic of row 2", float(k.grad[2]), ASPH_FD_STEP["conic"],
         lambda h: k8(table.replace(conic=bumped(table.conic, 2, h)))))
    failures = []
    with torch.no_grad():
        for kern, what, g, h, merit in picks:
            fd = (float(merit(h)) - float(merit(-h)))/(2*h)
            rel = abs(g - fd)/abs(fd)
            ok = rel <= FD_REL
            log("%s, %s: kernel %.12g, central difference %.12g, rel %.2e "
                "-> %s" % (kern, what, g, fd, rel, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s" % (kern, what))
    if failures:
        raise AssertionError("K7 or K9 on the aspheric double Gauss "
                             "disagrees with finite differences: "
                             + ", ".join(failures))


def newton_misses(table, specs, state, row):
    """The rays the Newton of figured row `row` declares a miss: live
    into the row with a finite conic seed and a NaN intercept (plain
    torch ops on the bundle's device)."""
    from rayopt_tpu_torch.ops import kernels as K
    from rayopt_tpu_torch.ops.geometric import _entry
    s = _entry(table, tuple(state), specs)
    for j in range(1, row):
        s, _ = K.surface_step_spec(s, table.row(j), specs[j], False)
    surf, spec = table.row(row), specs[row]
    x, y, z, ux, uy, uz = s
    if spec.off_axis:
        x, y = x - surf.offset[0], y - surf.offset[1]
    z = z - surf.offset[2]
    if spec.rotated:
        x, y, z = K.rot_apply(surf.rot, x, y, z)
        ux, uy, uz = K.rot_apply(surf.rot, ux, uy, uz)
    seed = K.intercept_conic(x, y, z, ux, uy, uz, surf.curvature,
                             surf.conic, surf.alternate)
    t = K.intercept(x, y, z, ux, uy, uz, surf.curvature, surf.conic,
                    surf.aspherics, surf.alternate,
                    aspherics_odd=surf.aspherics_odd)
    live = torch.isfinite(ux) & torch.isfinite(uy) & torch.isfinite(uz)
    return int((live & torch.isfinite(seed) & torch.isnan(t)).sum())


def phase_asphere_path(opt_step, glass_step, design_step):
    """The aspheric slice's main path through the entry points a user
    calls: the aspheric double Gauss aimed at fields 0, 0.7 and 1 (its
    pupils by System.pupils on the card against the host pupil at tol
    AIM_HOST_TOL, the rays by the host's), float64 K1 and K2 on N_ASPH
    rays a field against the CPU float64 plain trace (spot RMS to
    PARITY_REL, equal NaN masks, the Newton's misses counted), float32
    reported; then its three loops: the designer loop (designer_loop
    over ASPH_SELECT with ASPH_SCALES), the achromatization loop
    (phase_glass_path, K3, K6 and K7; row ASPH_ROW's coefficients too)
    and the composite design step (phase_design_path over
    ASPH_DESIGN_SELECT: K4, K5, K8 and K9), each loop's step 0 held
    against the CPU at N_LOOP_CHECK nrays a bundle on both devices and
    its later steps logged beside the spherical double Gauss's
    (`opt_step`, `glass_step`, `design_step` seconds).  Returns the
    path's launches (the forward part's, counted from the caller's
    reset, and each loop's), the loops' later-step seconds and the
    aimed bundles with their float64 K1 images and CPU references (the
    df32 path's)."""
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_merit)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    s, table, specs, widths = asphere_cases()["aspheric double Gauss"]
    table_cpu = s.table(device="cpu")
    log("== aspheric path: the aspheric double Gauss (conics on rows 2 and "
        "5, even asphere on row %d, widths %s), %d aimed rays a field, no "
        "clip" % (ASPH_ROW, widths, N_ASPH))
    fields = [(0., f) for f in FIELDS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a host fallback fails
        z, boxes = s.pupils(fields)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [s.pupil(f, tol=AIM_HOST_TOL) for f in fields]
    t_host = time.perf_counter() - t0
    zh = np.array([v[0] for v in host])
    bh = np.array([v[1] for v in host])
    rel_z = float((np.abs(z - zh)/np.abs(zh)).max())
    rel_b = float((np.abs(boxes - bh)/np.abs(bh)).max())
    failures = []
    ok = rel_z <= AIM_REL and rel_b <= AIM_REL
    log("System.pupils on the card %.3f s vs host pupil at tol %g %.3f s: z "
        "rel %.3e, boxes rel %.3e -> %s" % (t_card, AIM_HOST_TOL, t_host,
                                            rel_z, rel_b,
                                            "ok" if ok else "FAIL"))
    if not ok:
        failures.append("System.pupils")
    rng = np.random.RandomState(SEED + 5)
    aimed = []
    for (field, (zf, pf)) in zip(FIELDS, host):
        r = np.sqrt(rng.uniform(0, 1, N_ASPH))
        th = rng.uniform(0, 2*np.pi, N_ASPH)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., field), yp, zf, pf, filter=False)
        yc, uc = (torch.from_numpy(a).to(DEVICE) for a in (y0, u0))
        t0 = time.perf_counter()
        y64, u64, _ = trace_rays_final_fast(table, yc, uc, specs=specs,
                                            precision="parity")
        rms_k1, live = spot_rms(y64, u64)
        state64 = tuple(c.contiguous() for c in (*yc.T, *uc.T))
        mom64 = trace_merit(table, specs, state64)
        y32, u32, _ = trace_rays_final_fast(table, yc.float(), uc.float(),
                                            specs=specs)
        rms_k1_32, _ = spot_rms(y32, u32)
        rms_k2_32 = float(spot_rms_from_moments(*trace_merit(
            table, specs, tuple(c.float() for c in state64))))
        misses = newton_misses(table, specs, state64, ASPH_ROW)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu, torch.from_numpy(y0),
                                          torch.from_numpy(u0))
        rms_cpu, live_cpu = spot_rms(yh, uh)
        mom_cpu = trace_merit(table_cpu, specs,
                              tuple(c.cpu() for c in state64))
        t_cpu = time.perf_counter() - t0
        masks = int((torch.isnan(y64[:, 0].cpu())
                     != torch.isnan(yh[:, 0])).sum())
        rel1 = abs(rms_k1 - rms_cpu)/rms_cpu
        mom_ok, mom_rel, _ = compare_moments(mom64, mom_cpu, torch.float64,
                                             N_ASPH)
        ok = (np.isfinite(rms_k1) and masks == 0 and live == live_cpu
              and rel1 <= PARITY_REL and mom_ok)
        log("field %.1f: %d of %d rays live, the Newton's misses on row %d "
            "%d, NaN masks differ on %d | spot RMS mm: CPU f64 %.12g | K1 "
            "f64 %.12g (rel %.2e) | K2 f64 %.12g (moments vs CPU rel %.2e) "
            "| K1 f32 %.9g (rel %.2e) | K2 f32 %.9g (rel %.2e) | card %.2f "
            "s, CPU %.2f s -> %s"
            % (field, live, N_ASPH, ASPH_ROW, misses, masks, rms_cpu,
               rms_k1, rel1, float(spot_rms_from_moments(*mom64)), mom_rel,
               rms_k1_32, abs(rms_k1_32 - rms_cpu)/rms_cpu, rms_k2_32,
               abs(rms_k2_32 - rms_cpu)/rms_cpu, t_gpu, t_cpu,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("field %.1f" % field)
        aimed.append(dict(field=field, y=yc, u=uc, y64=y64,
                          rms_cpu=rms_cpu, live_cpu=live_cpu))
    if failures:
        raise AssertionError("aspheric path failed: " + ", ".join(failures))
    forward = read_launches()
    log("== launch counts on the aspheric forward path: %s" % forward)
    loop, step, _ = designer_loop(aspheric_double_gauss(),
                                  "aspheric designer loop: aspheric double "
                                  "Gauss", ASPH_SELECT, ASPH_SCALES,
                                  N_LOOP_CHECK)
    glass, gstep, _ = phase_glass_path(aspheric_double_gauss(),
                                       "aspheric double Gauss", N_LOOP_CHECK)
    design, dstep, _ = phase_design_path(aspheric_double_gauss(),
                                         "aspheric double Gauss",
                                         ASPH_DESIGN_SELECT, ASPH_SCALES,
                                         N_LOOP_CHECK)
    steps = {"designer": step, "achromatization": gstep, "design": dstep}
    log("later steps: %s" % ", ".join(
        "%s loop aspheric double Gauss %.4f s, double Gauss %.4f s (%.2fx)"
        % (k, v, t, v/t) for (k, v), t in zip(
            steps.items(), (opt_step, glass_step, design_step))))
    return ({k: v + loop[k] + glass[k] + design[k]
             for k, v in forward.items()}, steps, aimed)


# -- the anamorphic rows: every K1-K9 key on anamorphic rows -----------------

ANAM_SELECT = ("curvature", "curvature_dx")   # the anamorphic designer loop
# the design step on the pair, and the loops' K7 and K9 slot sets (the
# achromatization's and the design's fields and curvature_dx)
ANAM_DESIGN_SELECT = ANAM_SELECT + ("distance",)
ANAM_ACHROM_FIELDS = ACHROM_FIELDS + ("curvature_dx",)
ANAM_DESIGN_FIELDS = DESIGN_FIELDS + ("curvature_dx",)
# the figured anamorphic lenses: the toroid lens's generating-curve
# terms (y^2, y^4: the JAX package's test_zmx_toroidal_polynomial_terms)
# and an even figure (r^2, r^4) on the split-conic biconic's first row
TOROID_FIGURE = [1e-5, 2e-8]
BICONIC_FIGURE = [2e-4, -1e-6]
ANAM_FIG_FD_STEP = 1e-7   # the figured toroid's y^2 coefficient
# the lenses whose keys are timed: the cylinders' closed form, the Newton
ANAM_TIMED = ("anamorphic pair", "split-conic biconic")
N_ANAM = 1 << 16      # aimed rays a field of the CPU cross-check
ANAM_HALF = 4.        # the bench bundle's half width: the pupil radius
ANAM_FD_STEP = {"curvature_dx": 1e-8, "conic_dx": 1e-6}
# (lens, field, row) of the finite-difference checks of K5: the pair's
# x-cylinder, the split-conic biconic's x figure, the toroid's rotation
# curvature
ANAM_FD_PICKS = (("anamorphic pair", "curvature_dx", 3),
                 ("split-conic biconic", "curvature_dx", 1),
                 ("split-conic biconic", "conic_dx", 1),
                 ("toroid lens", "curvature_dx", 1))


def anam_grad_fields(widths=(0, 0), opd=False):
    """K5's and K7's cotangent columns by table field on an anamorphic
    key (with `opd`, K9's): asph_grad_fields' and curvature_dx and
    conic_dx after the coefficients."""
    q = (7 if opd else 6) + sum(widths)
    return asph_grad_fields(widths, opd) + (
        ("curvature_dx", slice(q, q + 1)), ("conic_dx", slice(q + 1, q + 2)))


ANAM_GRAD_FIELDS = anam_grad_fields()


def split_biconic():
    """The JAX package's split-conic biconic (its tests/test_anamorphic.py
    _cyl_system(cx=.013), conic -0.4 and conic_x 0.25 on the biconic
    row)."""
    from rayopt_tpu_torch import System
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


def toroid_lens():
    """The JAX package's toroid lens (its tests/test_anamorphic.py
    _toroid_system): a toroid and a flat toroid."""
    from rayopt_tpu_torch import System
    s = System([dict(material="air"),
                dict(type="toroid", roc=51.68, roc_rotation=200.,
                     distance=5., material="SCHOTT-BK|N-BK7", radius=10.),
                dict(type="toroid", distance=3., material="air",
                     radius=10.),
                dict(distance=95., radius=20.)])
    s.object.pupil.radius = 4.
    s.object.pupil.update_radius = False
    s.update()
    return s


def anamorphic_cases():
    """{name: (system, table on the card, specs)} of the three
    anamorphic lenses: the crossed-cylinder pair (models.anamorphic_pair,
    full width), the split-conic biconic and the toroid lens."""
    from rayopt_tpu_torch.models import anamorphic_pair
    from rayopt_tpu_torch.ops.kernels import specialize
    out = {}
    for name, build in (("anamorphic pair", anamorphic_pair),
                        ("split-conic biconic", split_biconic),
                        ("toroid lens", toroid_lens)):
        s = build()
        table = s.table()
        out[name] = (s, table, specialize(table))
    return out


def figured_anamorphic_cases():
    """{name: (system, table on the card, specs, figure widths)} of the
    figured anamorphic lenses: the toroid lens with TOROID_FIGURE on its
    first toroid's generating curve and the split-conic biconic with
    BICONIC_FIGURE on its first row."""
    from rayopt_tpu_torch.ops.cuda_trace import figure_widths
    from rayopt_tpu_torch.ops.kernels import specialize
    out = {}
    for name, build, figure in (("figured toroid", toroid_lens, TOROID_FIGURE),
                                ("figured biconic", split_biconic,
                                 BICONIC_FIGURE)):
        s = build()
        s[1].aspherics = list(figure)
        s.update()
        table = s.table()
        specs = specialize(table)
        out[name] = (s, table, specs, figure_widths(table, specs))
    return out


def anam_stack(table):
    """(stack of 3 tables, its specs) of an anamorphic lens for K3, K6
    and K7: the lens's table with its refracting rows' mu grown by 0, 1
    and 2 % of mu - 1 (the pair's glass is a constant index)."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.ops.tables import stack_tables
    tabs = stack_tables([table.replace(mu=1 + (table.mu - 1)*(1 + .01*li))
                         for li in range(3)])
    return tabs, multi_specs(tabs, None)


def nbk7_pair():
    """models.anamorphic_pair with its two lens materials N-BK7 (nd
    1.5168, the pair's constant index, and N-BK7's dispersion): the
    achromatization loop's lens.  The pair's own material has vd = inf:
    its three wavelength tables are equal and its glass cotangents say
    nothing."""
    from rayopt_tpu_torch.formats import system_from_yaml
    from rayopt_tpu_torch.models.prescriptions import ANAMORPHIC_YAML
    text = ANAMORPHIC_YAML.replace("material: 1.5168", "material: N-BK7")
    if text.count("N-BK7") != 2:
        raise AssertionError("the pair's prescription changed: %r" % text)
    s = system_from_yaml(text)
    s.update()
    return s


def spherical_twin(table):
    """The table with every anamorphic row made spherical of the same
    vertex curvature (its curved axis's: c, or c + curvature_dx where c
    is 0), its conics and x figure zeroed: the throughput phase's twin
    keys."""
    c = torch.where(table.curvature == 0, table.curvature
                    + table.curvature_dx, table.curvature)
    anam = (table.curvature_dx != 0) | (table.conic_dx != 0) \
        | (table.toroidal != 0)
    zero = torch.zeros_like(c)
    return table.replace(curvature=c, conic=torch.where(anam, zero,
                                                        table.conic),
                         curvature_dx=zero, conic_dx=zero, toroidal=zero)


def anamorphic_keys():
    """{tag: key} of the anamorphic keys this script runs: on each
    anamorphic lens, in both dtypes, clip off and on, K1, K2, K4, K6,
    K8 and K5, K7, K9 (every field, with the ray cotangents), and K3's
    two modes, K6 and K7 on its stack (anam_stack); on the pair and the
    biconic the loops' keys, no ray cotangents (the designer loop's K5
    for ANAM_SELECT, the achromatization's K7 and the design's K9 and,
    float64, K5, and the design step breakdown's K5 and K9; the pair's
    loops, both lenses' checks and timings) and
    their spherical twins' keys, unclipped (K5 for OPT_FIELDS, K7 for
    ACHROM_FIELDS, K9 for DESIGN_FIELDS as the loops'), for the timings;
    in float64 the finite-difference checks' K5, K7 and K9 (one field
    each); on the figured lenses, float64 and unclipped, K1-K9 with
    their widths."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.kernels import specialize
    keys = {}
    f64 = torch.float64
    for name, (s, table, specs) in anamorphic_cases().items():
        tag = name.split()[0]
        _, mspecs = anam_stack(table)
        ttab = spherical_twin(table)
        twin = specialize(ttab)
        _, tmspecs = anam_stack(ttab)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            for clip in (False, True):
                sfx = "%s %s clip=%s" % (dt, tag, clip)
                keys["K1 " + sfx] = CS.trace_key(specs, dtype, clip)
                keys["K2 " + sfx] = CS.merit_key(specs, dtype, clip)
                keys["K4 " + sfx] = CS.moments_key(specs, dtype, clip)
                keys["K5 %s all rays=True" % sfx] = CS.adjoint_key(
                    specs, dtype, clip)
                keys["K6 " + sfx] = CS.moments_multi_key(mspecs, dtype, clip,
                                                         3)
                keys["K7 %s all rays=True" % sfx] = CS.adjoint_multi_key(
                    mspecs, dtype, clip)
                keys["K8 " + sfx] = CS.opd_key(specs, dtype, clip)
                keys["K9 %s all rays=True" % sfx] = CS.opd_adjoint_key(
                    specs, dtype, clip)
            for mode in ("merit", "trace"):
                keys["K3 %s %s %s" % (dt, tag, mode)] = CS.trace_multi_key(
                    mspecs, dtype, 3, mode == "merit")
            if tag != "toroid":
                keys["K7 %s %s achromatization rays=False" % (dt, tag)] = \
                    CS.adjoint_multi_key(mspecs, dtype, False,
                                         ANAM_ACHROM_FIELDS, False)
                keys["K9 %s %s design rays=False" % (dt, tag)] = \
                    CS.opd_adjoint_key(specs, dtype, False,
                                       ANAM_DESIGN_FIELDS, False)
                tsfx = "%s %s twin" % (dt, tag)
                for mode in ("merit", "trace"):
                    keys["K3 %s %s" % (tsfx, mode)] = CS.trace_multi_key(
                        tmspecs, dtype, 3, mode == "merit")
                keys["K6 " + tsfx] = CS.moments_multi_key(tmspecs, dtype,
                                                          False, 3)
                keys["K7 %s all rays=True" % tsfx] = CS.adjoint_multi_key(
                    tmspecs, dtype)
                keys["K7 %s achromatization rays=False" % tsfx] = \
                    CS.adjoint_multi_key(tmspecs, dtype, False,
                                         ACHROM_FIELDS, False)
                keys["K8 " + tsfx] = CS.opd_key(twin, dtype)
                keys["K9 %s all rays=True" % tsfx] = CS.opd_adjoint_key(
                    twin, dtype)
                keys["K9 %s design rays=False" % tsfx] = CS.opd_adjoint_key(
                    twin, dtype, False, DESIGN_FIELDS, False)
            if tag != "toroid":
                # the designer loop's slot set (the pair's loop; both
                # lenses' timings)
                keys["K5 %s %s designer rays=False" % (dt, tag)] = \
                    CS.adjoint_key(specs, dtype, fields=ANAM_SELECT,
                                   rays=False)
                tsfx = "%s %s twin" % (dt, tag)
                keys["K1 " + tsfx] = CS.trace_key(twin, dtype)
                keys["K2 " + tsfx] = CS.merit_key(twin, dtype)
                keys["K4 " + tsfx] = CS.moments_key(twin, dtype)
                keys["K5 %s all rays=True" % tsfx] = CS.adjoint_key(twin,
                                                                    dtype)
                keys["K5 %s designer rays=False" % tsfx] = CS.adjoint_key(
                    twin, dtype, fields=OPT_FIELDS, rays=False)
        for lens, field, _ in ANAM_FD_PICKS:
            if lens == name:
                keys["K5 float64 %s fd %s rays=False" % (tag, field)] = \
                    CS.adjoint_key(specs, torch.float64, fields=(field,),
                                   rays=False)
        if tag == "anamorphic":
            # the design step's spot key; the finite-difference checks of
            # K7 and K9 (curvature_dx)
            keys["K5 float64 anamorphic design rays=False"] = CS.adjoint_key(
                specs, f64, False, ANAM_DESIGN_FIELDS, False)
            # the design step's breakdown (curvature and offset)
            keys["K5 float64 anamorphic breakdown rays=False"] = \
                CS.adjoint_key(specs, f64, False, OPT_FIELDS, False)
            keys["K9 float64 anamorphic breakdown rays=False"] = \
                CS.opd_adjoint_key(specs, f64, False, DESIGN_FIELDS, False)
            keys["K7 float64 anamorphic fd curvature_dx rays=False"] = \
                CS.adjoint_multi_key(mspecs, f64, False, ("curvature_dx",),
                                     False)
            keys["K9 float64 anamorphic fd curvature_dx rays=False"] = \
                CS.opd_adjoint_key(specs, f64, False, ("curvature_dx",),
                                   False)
    for name, (s, table, specs, widths) in figured_anamorphic_cases().items():
        sfx = "float64 " + name.replace(" ", "-")
        _, mspecs = anam_stack(table)
        kw = dict(widths=widths)
        keys["K1 " + sfx] = CS.trace_key(specs, f64, **kw)
        keys["K2 " + sfx] = CS.merit_key(specs, f64, **kw)
        keys["K4 " + sfx] = CS.moments_key(specs, f64, **kw)
        keys["K5 %s all rays=True" % sfx] = CS.adjoint_key(specs, f64, **kw)
        for mode in ("merit", "trace"):
            keys["K3 %s %s" % (sfx, mode)] = CS.trace_multi_key(
                mspecs, f64, 3, mode == "merit", **kw)
        keys["K6 " + sfx] = CS.moments_multi_key(mspecs, f64, False, 3, **kw)
        keys["K7 %s all rays=True" % sfx] = CS.adjoint_multi_key(mspecs, f64,
                                                                 **kw)
        keys["K8 " + sfx] = CS.opd_key(specs, f64, **kw)
        keys["K9 %s all rays=True" % sfx] = CS.opd_adjoint_key(specs, f64,
                                                               **kw)
        if name == "figured toroid":
            keys["K9 %s fd aspherics rays=False" % sfx] = CS.opd_adjoint_key(
                specs, f64, False, ("aspherics",), False, **kw)
    return keys


def anam_bundle(n, dtype, seed, widen=1.):
    """The anamorphic bench bundle: x, y uniform in +-ANAM_HALF mm (the
    pupil radius) times `widen`, u = (0, 0, 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.empty(n, dtype=torch.float64, device=DEVICE)
    y = torch.empty_like(x)
    half = ANAM_HALF*widen
    x.uniform_(-half, half, generator=gen)
    y.uniform_(-half, half, generator=gen)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return tuple(c.to(dtype).contiguous()
                 for c in (x, y, zero, zero, zero, one))


def anam_wide(n, dtype, seed):
    """The bench bundle 1.5x wide, for the clipped checks."""
    return anam_bundle(n, dtype, seed, 1.5)


def anam_opd_bundle(n, dtype, seed, widen=1.):
    """The anamorphic bench bundle with ray 0 the chief ray, on the
    axis; `widen` scales the footprint."""
    state = [c.double().clone() for c in anam_bundle(n, torch.float64, seed,
                                                      widen)]
    state[0][0] = state[1][0] = 0.
    return tuple(c.to(dtype).contiguous() for c in state)


def anam_wide2(n, dtype, seed, widen=1.):
    """The bench bundle twice as wide (times `widen`)."""
    return anam_bundle(n, dtype, seed, 2*widen)


def anam_opd_wide2(n, dtype, seed, widen=1.):
    """anam_opd_bundle twice as wide (times `widen`)."""
    return anam_opd_bundle(n, dtype, seed, 2*widen)


def phase_anamorphic_check():
    """Every K1-K9 key on each anamorphic lens against its plain version
    on the card at N_CHECK rays, in both dtypes: K1, K2, K4 and K5
    (phase_check, phase_grad_check) unclipped on the bench bundle and
    clipped on it 1.5x wide; K3, K6 and K7 on the lens's stack
    (anam_stack, phase_multi_check) and K8 and K9 (phase_opd_check,
    ray 0 the chief ray), clip off and on (clipped on the bundle twice
    as wide, which the checks widen 1.5x again); the adjoints with their
    curvature_dx and conic_dx columns and, on the pair and the biconic,
    K7's and K9's loop keys.  Then K1-K9 on the figured lenses, float64
    and unclipped, the adjoints with the coefficient columns too.  Then
    K5's, K7's and K9's float64 gradients against central differences
    (phase_anamorphic_fd_check).  Returns the float32 errors."""
    worst = {}

    def keep(errs):
        worst.update({k: max(v, worst.get(k, 0.)) for k, v in errs.items()})
    for lens, (s, table, specs) in anamorphic_cases().items():
        tabs, mspecs = anam_stack(table)
        looped = lens in ANAM_TIMED
        for bundle, clips in ((anam_bundle, (False,)), (anam_wide, (True,))):
            keep(phase_check(table, specs, lens, bundle, clips))
            keep(phase_grad_check(table, specs, lens, bundle, clips,
                                  ANAM_GRAD_FIELDS))
        # clipped, the check widens the bundle 1.5x: the bench bundle
        # twice as wide reaches past the biconic's and the toroid's 10 mm
        # apertures too
        for bundle, opd_bundle_, clips in (
                (anam_bundle, anam_opd_bundle, (False,)),
                (anam_wide2, anam_opd_wide2, (True,))):
            keep(phase_multi_check(tabs, mspecs, lens + ", its stack",
                                   bundle, clips, ANAM_GRAD_FIELDS,
                                   ANAM_ACHROM_FIELDS if looped else None))
            keep(phase_opd_check(s, table, specs, lens, opd_bundle_, clips,
                                 anam_grad_fields(opd=True),
                                 ANAM_DESIGN_FIELDS if looped else None))
    f64 = (torch.float64,)
    for lens, (s, table, specs, widths) in \
            figured_anamorphic_cases().items():
        tabs, mspecs = anam_stack(table)
        phase_check(table, specs, lens, anam_bundle, (False,), f64)
        phase_grad_check(table, specs, lens, anam_bundle, (False,),
                         anam_grad_fields(widths), f64)
        phase_multi_check(tabs, mspecs, lens + ", its stack", anam_bundle,
                          (False,), anam_grad_fields(widths), None, f64)
        phase_opd_check(s, table, specs, lens, anam_opd_bundle, (False,),
                        anam_grad_fields(widths, opd=True), None, f64)
    phase_anamorphic_fd_check()
    return worst


def phase_anamorphic_fd_check():
    """K5's float64 gradient of the K4 merit (the spot RMS of N_CHECK
    bench rays) against central differences: curvature_dx of the pair's
    x-cylinder (row 3), curvature_dx and conic_dx of the split-conic
    biconic (row 1), and the toroid's rotation curvature (curvature_dx
    of row 1); then K7's and K9's (phase_anamorphic_fd_adjoints)."""
    from rayopt_tpu_torch.ops.cuda_grad import spot_moments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    cases = anamorphic_cases()
    log("== K5 on the anamorphic lenses vs central differences of the K4 "
        "merit (float64, %d bench rays; steps %s)" % (N_CHECK, ANAM_FD_STEP))
    failures = []
    for lens, field, row in ANAM_FD_PICKS:
        _, table, specs = cases[lens]
        state = anam_bundle(N_CHECK, torch.float64, SEED)
        w = bench_weights(N_CHECK, torch.float64, SEED + 2)
        v = getattr(table, field).clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the baked rows, as intended
            mom = spot_moments(table.replace(**{field: v}), state, w,
                               specs=specs)
        spot_rms_from_moments(*mom).backward()

        def merit(tab):
            return float(spot_rms_from_moments(*weighted_moments(
                tab, specs, state, w)))
        h = ANAM_FD_STEP[field]
        side = []
        for sgn in (1., -1.):
            b = getattr(table, field).clone()
            b[row] += sgn*h
            side.append(merit(table.replace(**{field: b})))
        fd = (side[0] - side[1])/(2*h)
        g = float(v.grad[row])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s, %s of row %d: K5 %.12g, central difference %.12g, rel "
            "%.2e -> %s" % (lens, field, row, g, fd, rel,
                            "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s" % (lens, field))
    if failures:
        raise AssertionError("K5 on the anamorphic lenses disagrees with "
                             "finite differences: " + ", ".join(failures))
    phase_anamorphic_fd_adjoints()


def phase_anamorphic_fd_adjoints():
    """Float64, N_CHECK bench rays, against central differences: K7's
    gradient of the K6 merit (the union spot RMS of the pair's stack,
    anam_stack) w.r.t. curvature_dx of the x-cylinder (row 3, shared by
    the stack's tables), and K9's of the K8 wavefront RMS (ray 0 the
    chief ray) w.r.t. the same curvature_dx and the figured toroid's
    first generating-curve coefficient (its y^2 term, row 1)."""
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_wavefront_rms,
                                                polychromatic_spot_rms)
    cases = anamorphic_cases()
    s, table, specs = cases["anamorphic pair"]
    fs, ftab, fspecs, _ = figured_anamorphic_cases()["figured toroid"]
    tabs, mspecs = anam_stack(table)
    nlam = tabs.curvature.shape[0]
    log("== K7 and K9 on the anamorphic lenses vs central differences of "
        "the K6 merit and the K8 wavefront RMS (float64, %d bench rays; "
        "steps curvature_dx %g, the figured toroid's y^2 coefficient %g)"
        % (N_CHECK, ANAM_FD_STEP["curvature_dx"], ANAM_FIG_FD_STEP))
    state = anam_bundle(N_CHECK, torch.float64, SEED)
    w = bench_weights(N_CHECK, torch.float64, SEED + 2)
    y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    ostate = anam_opd_bundle(N_CHECK, torch.float64, SEED)
    oy, ou = torch.stack(ostate[:3], 1), torch.stack(ostate[3:], 1)

    def k6(cdx):
        return polychromatic_spot_rms(
            tabs.replace(curvature_dx=cdx.expand(nlam, -1)), y0, u0, w,
            specs=mspecs)

    def k8(sys, tab, sp):
        return adjoint_wavefront_rms(
            tab, oy, ou, ref=0, radius=-sys.image.pupil.distance,
            wavelength=sys.wavelengths[0], scale=sys.scale,
            finite=sys.object.finite, specs=sp)

    def bumped(base, idx, h):
        v = base.clone()
        v[idx] += h
        return v
    cdx0 = table.curvature_dx
    a0 = ftab.aspherics
    c7 = cdx0.clone().requires_grad_()
    c9 = cdx0.clone().requires_grad_()
    a9 = a0.clone().requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the baked rows, as intended
        k6(c7).backward()
        k8(s, table.replace(curvature_dx=c9), specs).backward()
        k8(fs, ftab.replace(aspherics=a9), fspecs).backward()
    h, ha = ANAM_FD_STEP["curvature_dx"], ANAM_FIG_FD_STEP
    picks = (
        ("K7", "curvature_dx of the pair's row 3", float(c7.grad[3]), h,
         lambda d: k6(bumped(cdx0, 3, d))),
        ("K9", "curvature_dx of the pair's row 3", float(c9.grad[3]), h,
         lambda d: k8(s, table.replace(curvature_dx=bumped(cdx0, 3, d)),
                      specs)),
        ("K9", "the figured toroid's y^2 coefficient (row 1)",
         float(a9.grad[1, 0]), ha,
         lambda d: k8(fs, ftab.replace(aspherics=bumped(a0, (1, 0), d)),
                      fspecs)))
    failures = []
    with torch.no_grad():
        for kern, what, g, step, merit in picks:
            fd = (float(merit(step)) - float(merit(-step)))/(2*step)
            rel = abs(g - fd)/abs(fd)
            ok = rel <= FD_REL
            log("%s, %s: kernel %.12g, central difference %.12g, rel %.2e "
                "-> %s" % (kern, what, g, fd, rel, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s" % (kern, what))
    if failures:
        raise AssertionError("K7 or K9 on the anamorphic lenses disagrees "
                             "with finite differences: "
                             + ", ".join(failures))


def phase_anamorphic_path(opt_step, glass_step, design_step):
    """The anamorphic slice's main path through the entry points a user
    calls, on the crossed-cylinder pair (models.anamorphic_pair): host
    pupils at fields 0, 0.7 and 1 of its 0.5 degree field, System.pupils
    on the card against the host pupil at tol AIM_HOST_TOL (the pair's
    pupil aimed, so that the card solves it), N_AIMED_LENS rays a field aimed
    by the host through float64 and float32 K1 and K2, and the spot RMS
    of float64 K1's output on the first N_ANAM of them against the CPU
    float64 plain trace (PARITY_REL, equal NaN masks); then its three
    loops: the designer loop over ANAM_SELECT (designer_loop), the
    achromatization loop (phase_glass_path: K3, K6 and K7, over
    curvature, curvature_dx, distance and the two glasses) on the pair
    in N-BK7 (nbk7_pair: the pair's constant index has no dispersion)
    and the composite design step (phase_design_path over
    ANAM_DESIGN_SELECT: K4, K5, K8 and K9, and the port's
    first_order_penalty), each loop's step 0 against the CPU at
    N_LOOP_CHECK nrays a bundle on both devices, its later steps logged beside the
    double Gauss's (`opt_step`, `glass_step`, `design_step` seconds).
    Returns the path's launches (the forward part's, counted from the
    caller's reset, and each loop's), the loops' later-step seconds and
    the aimed bundles with their float64 K1 images and the CPU
    reference of their first N_ANAM rays (the df32 path's)."""
    from rayopt_tpu_torch.models import anamorphic_pair
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_merit)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    s, table, specs = anamorphic_cases()["anamorphic pair"]
    table_cpu = s.table(device="cpu")
    log("== anamorphic path: the crossed-cylinder pair (a y-cylinder on "
        "row 1, an x-cylinder on row 3), %d aimed rays a field, no clip"
        % N_AIMED_LENS)
    fields = [(0., f) for f in FIELDS]
    aimed = anamorphic_pair()
    aimed.object.pupil.aim = True
    aimed.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a host fallback fails
        z, boxes = aimed.pupils(fields)
    t_card = time.perf_counter() - t0
    h = anamorphic_pair()
    h.object.pupil.aim = True
    h.update()
    t0 = time.perf_counter()
    tight = [h.pupil(f, tol=AIM_HOST_TOL) for f in fields]
    t_host = time.perf_counter() - t0
    zh = np.array([v[0] for v in tight])
    bh = np.array([v[1] for v in tight])
    rel_z = float((np.abs(z - zh)/np.abs(zh)).max())
    rel_b = float((np.abs(boxes - bh)/np.abs(bh)).max())
    failures = []
    ok = rel_z <= AIM_REL and rel_b <= AIM_REL
    log("System.pupils of the aimed pair on the card %.3f s vs host pupil "
        "at tol %g %.3f s: z rel %.3e, boxes rel %.3e -> %s"
        % (t_card, AIM_HOST_TOL, t_host, rel_z, rel_b,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("System.pupils")
    rng = np.random.RandomState(SEED + 7)
    aimed = []
    for field in FIELDS:
        t0 = time.perf_counter()
        zf, pf = s.pupil((0., field))
        r = np.sqrt(rng.uniform(0, 1, N_AIMED_LENS))
        th = rng.uniform(0, 2*np.pi, N_AIMED_LENS)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., field), yp, zf, pf, filter=False)
        t_aim = time.perf_counter() - t0
        yc, uc = (torch.from_numpy(a).to(DEVICE) for a in (y0, u0))
        t0 = time.perf_counter()
        y64, u64, _ = trace_rays_final_fast(table, yc, uc, specs=specs,
                                            precision="parity")
        rms_k1, live = spot_rms(y64, u64)
        state64 = tuple(c.contiguous() for c in (*yc.T, *uc.T))
        rms_k2 = float(spot_rms_from_moments(*trace_merit(table, specs,
                                                          state64)))
        y32, u32, _ = trace_rays_final_fast(table, yc.float(), uc.float(),
                                            specs=specs)
        rms_k1_32, _ = spot_rms(y32, u32)
        rms_k2_32 = float(spot_rms_from_moments(*trace_merit(
            table, specs, tuple(c.float() for c in state64))))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        # the CPU cross-check on the first N_ANAM rays of float64 K1's
        # own output
        rms_sub, live_sub = spot_rms(y64[:N_ANAM], u64[:N_ANAM])
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu, yc[:N_ANAM].cpu(),
                                          uc[:N_ANAM].cpu())
        rms_cpu, live_cpu = spot_rms(yh, uh)
        t_cpu = time.perf_counter() - t0
        masks = int((torch.isnan(y64[:N_ANAM, 0].cpu())
                     != torch.isnan(yh[:, 0])).sum())
        rel1 = abs(rms_sub - rms_cpu)/rms_cpu
        ok = (np.isfinite(rms_k1) and np.isfinite(rms_k2) and masks == 0
              and live_sub == live_cpu and rel1 <= PARITY_REL
              and abs(rms_k2 - rms_k1)/rms_k1 <= 1e-9)
        log("field %.1f: pupil z %.6f, %d of %d rays live | spot RMS mm: K1 "
            "f64 %.12g | K2 f64 %.12g | K1 f32 %.9g (rel %.2e) | K2 f32 "
            "%.9g (rel %.2e) | the first %d rays: K1 f64 %.12g vs CPU f64 "
            "%.12g (rel %.2e), NaN masks differ on %d | aim %.2f s, card "
            "%.2f s, CPU %.2f s -> %s"
            % (field, zf, live, N_AIMED_LENS, rms_k1, rms_k2, rms_k1_32,
               abs(rms_k1_32 - rms_k1)/rms_k1, rms_k2_32,
               abs(rms_k2_32 - rms_k1)/rms_k1, N_ANAM, rms_sub, rms_cpu,
               rel1, masks, t_aim, t_gpu, t_cpu, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("field %.1f" % field)
        aimed.append(dict(field=field, y=yc, u=uc, y64=y64,
                          rms_cpu=rms_cpu, live_cpu=live_cpu, n_ref=N_ANAM))
        del u64, y32, u32, state64
    if failures:
        raise AssertionError("anamorphic path failed: " + ", ".join(failures))
    forward = read_launches()
    log("== launch counts on the anamorphic forward path: %s" % forward)
    torch.cuda.empty_cache()
    loop, step, _ = designer_loop(anamorphic_pair(), "anamorphic designer "
                                  "loop: crossed-cylinder pair", ANAM_SELECT,
                                  None, N_LOOP_CHECK)
    log("the achromatization loop runs on a copy of the pair whose two "
        "lens materials are N-BK7 (nd 1.5168, as the pair's constant "
        "index): the constant index has vd = inf, equal wavelength tables "
        "and no glass gradient")
    glass, gstep, _ = phase_glass_path(nbk7_pair(),
                                       "anamorphic pair in N-BK7",
                                       N_LOOP_CHECK, slots=2)
    design, dstep, _ = phase_design_path(anamorphic_pair(), "anamorphic pair",
                                         ANAM_DESIGN_SELECT, None,
                                         N_LOOP_CHECK)
    steps = {"designer": step, "achromatization": gstep, "design": dstep}
    log("later steps: %s" % ", ".join(
        "%s loop anamorphic pair %.4f s, double Gauss %.4f s (%.2fx)"
        % (k, v, t, v/t) for (k, v), t in zip(
            steps.items(), (opt_step, glass_step, design_step))))
    return ({k: v + loop[k] + glass[k] + design[k]
             for k, v in forward.items()}, steps, aimed)


def phase_anamorphic_throughput(card):
    """Every K1-K9 key on the pair's and the split-conic biconic's keys
    (ANAM_TIMED), beside each lens's spherical twin (spherical_twin: the
    same rows made spherical of the same vertex curvature), on the
    anamorphic bench bundle: K1, K2, K4 and K5 (phase_throughput,
    phase_grad_throughput; K5 for ANAM_SELECT as the loop's key), K3,
    K6 and K7 on the lens's stack (phase_multi_throughput; K7 for
    ANAM_ACHROM_FIELDS) and K8 and K9 (phase_opd_throughput, ray 0 the
    chief ray; K9 for ANAM_DESIGN_FIELDS), in both dtypes at N_GRAD_TIME
    rays and float32 at N_BENCH, where the kernel outweighs the
    wrapper.  times[lens] = those phases' times (K3, K6-K9: kernel,
    plain, twin), live[lens] = the multi and OPD bundles' live rays."""
    from rayopt_tpu_torch.ops.kernels import specialize
    cases = anamorphic_cases()
    times, live = {}, {}
    for lens in ANAM_TIMED:
        s, table, specs = cases[lens]
        ttab = spherical_twin(table)
        twin = (ttab, specialize(ttab))
        kw = dict(lens=lens, bundle=anam_bundle, twin_name="spherical twin")
        times[lens] = phase_throughput(table, specs, card, N_GRAD_TIME, twin,
                                       N_BENCH, **kw)
        times[lens].update(phase_grad_throughput(table, specs, card, twin,
                                                 ANAM_SELECT, **kw))
        tabs, mspecs = anam_stack(table)
        mtimes, mlive = phase_multi_throughput(
            tabs, mspecs, card, anam_stack(ttab), ANAM_ACHROM_FIELDS, **kw)
        kw["bundle"] = anam_opd_bundle
        otimes, olive = phase_opd_throughput(
            s, table, specs, card, (s, *twin), ANAM_DESIGN_FIELDS, **kw)
        times[lens].update(mtimes)
        times[lens].update(otimes)
        live[lens] = {"multi": mlive, "opd": olive}
    return times, live


def phase_figured_throughput(card):
    """Every K1-K9 key of the figured anamorphic lenses
    (figured_anamorphic_cases), float64 at N_FIGURED_TIME anamorphic
    bench rays (ray 0 the chief ray; K3's merit, K6 and K7 on the lens's
    stack, anam_stack), each against its plain version in turns (plain,
    kernel, kernel, plain): N_FIGURED_TIME, not N_GRAD_TIME, for time
    (the plain versions took ~40 s of the script at N_GRAD_TIME, ~17 s
    at 2^20).  Returns
    times[lens][kernel] = (kernel, plain) ms and live[lens] = the
    bundle's live rays."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        merit_adjoint_reference, opd_adjoint, opd_adjoint_reference,
        opd_chain, opd_chain_reference, weighted_moments,
        weighted_moments_multi, weighted_moments_multi_reference,
        weighted_moments_reference)
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_final_reference, trace_merit,
        trace_merit_reference, trace_multi, trace_multi_reference)
    f64 = torch.float64
    times, live = {}, {}
    for lens, (s, tab, specs, widths) in figured_anamorphic_cases().items():
        log("== K1-K9 throughput (%s, widths %s): %d bench rays, float64, "
            "against the plain versions (%s)" % (lens, widths, N_FIGURED_TIME,
                                                 card))
        tabs, mspecs = anam_stack(tab)
        state = anam_opd_bundle(N_FIGURED_TIME, f64, SEED + 1)
        w = bench_weights(N_FIGURED_TIME, f64, SEED + 3)
        ct = rms_cotangent(weighted_moments(tab, specs, state, w))
        mct = rms_cotangent(weighted_moments_multi(tabs, mspecs, state, w))
        aux = opd_aux(s, tab, specs, state)
        cts = opd_cotangents(*opd_chain(tab, specs, state, aux), "wavefront")
        live[lens] = float(trace_merit(tab, specs, state)[0])
        cases = (
            ("trace_final", lambda: trace_final(tab, specs, state),
             lambda: trace_final_reference(tab, specs, state)),
            ("trace_merit", lambda: trace_merit(tab, specs, state),
             lambda: trace_merit_reference(tab, specs, state)),
            ("weighted_moments", lambda: weighted_moments(tab, specs, state,
                                                          w),
             lambda: weighted_moments_reference(tab, specs, state, w)),
            ("merit_adjoint", lambda: merit_adjoint(tab, specs, state, w, ct),
             lambda: merit_adjoint_reference(tab, specs, state, w, ct)),
            ("trace_multi", lambda: trace_multi(tabs, mspecs, state, True),
             lambda: trace_multi_reference(tabs, mspecs, state, True)),
            ("weighted_moments_multi",
             lambda: weighted_moments_multi(tabs, mspecs, state, w),
             lambda: weighted_moments_multi_reference(tabs, mspecs, state,
                                                      w)),
            ("merit_adjoint_multi",
             lambda: merit_adjoint_multi(tabs, mspecs, state, w, mct),
             lambda: merit_adjoint_multi_reference(tabs, mspecs, state, w,
                                                   mct)),
            ("opd_chain", lambda: opd_chain(tab, specs, state, aux),
             lambda: opd_chain_reference(tab, specs, state, aux)),
            ("opd_adjoint", lambda: opd_adjoint(tab, specs, state, aux, cts),
             lambda: opd_adjoint_reference(tab, specs, state, aux, cts)))
        times[lens] = {}
        for name, kernel, plain in cases:
            (k, p, _), (k1, k2, p1, p2, _, _) = in_turns(kernel, plain)
            times[lens][name] = (k, p)
            log("%s float64: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | %s"
                % (name, k, k1, k2, p, p1, p2, p/k, card))
        del state, w, cts
        torch.cuda.empty_cache()
    return times, live


#: flops of one biconic/toroid residual, slope (its normal and the dot
#: product) and refraction (the normal and the general Snell), and of
#: the reverse's normal and residual gradients (csrc/trace_common.cuh,
#: csrc/step_vjp.cuh, counted from the code)
ANAM_FLOPS = {"biconic": dict(res=25, slope=48, refract=70, normal_vjp=90,
                              res_vjp=40),
              "toroid": dict(res=29, slope=31, refract=52, normal_vjp=70,
                             res_vjp=50)}


def anam_figure_flops(na, no):
    """(residual, slope) operations the figure of a key's widths adds to
    a biconic's or toroid's residual and normal (csrc/trace_common.cuh):
    the even and odd polynomials' Horner loops and subtractions (the odd
    also its square root), and in the normal their derivatives' Horner
    loops, the odd's floor and division, and the (x, y) products and
    subtractions."""
    res = (1 + 2*na + 1 if na else 0) + (2*no + 3 if no else 0)
    slope = (2*na + 4 if na else 0) + (4*no + 8 if no else 0)
    return res, slope


def anam_row_flops(spec, widths=(0, 0)):
    """Operations of one surface_step on an anamorphic row: a cylinder's
    closed form and refraction counted as the conic's; a biconic's or
    toroid's seed (the conic's root, 33), ASPHERIC_ITERS Newton steps
    (residual, slope, update), the last residual and its test and the
    refraction by its general normal, each with the figure of the key's
    `widths` (anam_figure_flops)."""
    f = 1 + (2 if spec.off_axis else 0) + (60 if spec.rotated else 0) + 8
    if spec.cyl_axis:
        return f + 31 + (37 if spec.kind else 0)
    c = ANAM_FLOPS["toroid" if spec.toroidal else "biconic"]
    fr, fs = anam_figure_flops(*widths)
    res, slope = c["res"] + fr, c["slope"] + fs
    f += 33 + ASPHERIC_ITERS*(res + slope + 2) + res + 2
    return f + (c["refract"] + fs if spec.kind else 0)


def anam_vjp_extra(spec, widths=(0, 0)):
    """The reverse of a biconic or toroid row beyond 3x its forward:
    its recompute (the whole Newton once) and its reverse -- the
    refraction's (~75), the normal's, the transfer's (9) and the
    implicit step (one slope and the residual's gradient), with the
    figure's (its slope's and its sag's reverses: 6 and 3 operations a
    coefficient, 12 and 6 an odd one) -- less the 3x the estimate
    already counts.  A cylinder's reverse is the conic's (the 3x
    estimate)."""
    if spec.cyl_axis:
        return 0
    c = ANAM_FLOPS["toroid" if spec.toroidal else "biconic"]
    na, no = widths
    rf = anam_row_flops(spec, widths)
    rev = (75 + c["normal_vjp"] + 9 + c["slope"] + c["res_vjp"]
           + anam_figure_flops(na, no)[1] + 9*na + 18*no
           + (60 if spec.rotated else 0))
    return rf + rev - 3*rf


# ---- the grating and DOE rows (the phase rows) ----

#: the hybrid achromat's designer loop: its curvatures, distances and the
#: kinoform's DOE coefficient
PHASE_SELECT = ("curvature", "distance", "doe")
PHASE_LOOP_FIELDS = ("curvature", "offset", "doe")  # the loop's K5 slot set
#: the hybrid's achromatization loop: Adam's lr on the kinoform's phase
#: coefficient A (rad at rho = 1; -2.93 in models.hybrid_achromat), and
#: its K7's slot set (the glass moves mu, A the DOE coefficients)
PHASE_A_LR = 1e-3
PHASE_ACHROM_FIELDS = ACHROM_FIELDS + ("doe",)
#: the hybrid's design step's K9 slot set (PHASE_SELECT's fields)
PHASE_DESIGN_FIELDS = PHASE_LOOP_FIELDS
#: the lenses whose phase keys are timed, beside their phase-free twins
PHASE_TIMED = ("hybrid achromat", "spectrograph")
N_PHASE = 1 << 16     # aimed rays a field of the hybrid's CPU cross-check
#: the spectrograph's detector line positions (the JAX package's golden,
#: tests/test_goldens.py), mm at 450, 550 and 650 nm
SPECTROGRAPH_LINES = (-56.06593593485528, -69.89487421806105,
                      -84.67998616743552)
LINES_REL = 1e-9      # the line positions on the card vs the golden
#: (lens, field, index) of K5's finite-difference checks: the mirror
#: grating's grating_dy, the curved hybrid's two DOE coefficients
PHASE_FD_PICKS = (("mirror grating", "grating_dy", 1),
                  ("curved hybrid", "doe", (1, 0)),
                  ("curved hybrid", "doe", (1, 1)))
PHASE_FD_STEP = {"grating_dy": 1e-6, "doe": 1e-3}   # relative steps
#: K7's and K9's relative steps (the union spot RMS's curvature in a DOE
#: coefficient leaves 4.5e-6 of truncation at 1e-3, on the CPU at 2^11
#: rays)
PHASE_FD_ADJOINT_STEP = {"grating_dy": 1e-6, "doe": 1e-4, "n_after": 1e-6}
#: (kernel, lens, field, index) of K7's and K9's finite-difference
#: checks: grating_dy of the mirror grating, the curved hybrid's first
#: DOE coefficient and (K9) its DOE row's n_after (the path term's);
#: K7's on its stack's first table
PHASE_FD_ADJOINT_PICKS = (("K7", "mirror grating", "grating_dy", (0, 1)),
                          ("K7", "curved hybrid", "doe", (0, 1, 0)),
                          ("K9", "mirror grating", "grating_dy", 1),
                          ("K9", "curved hybrid", "doe", (1, 0)),
                          ("K9", "curved hybrid", "n_after", 1))
PHASE_LAM0 = 550e-9
PHASE_A1 = -np.pi/((PHASE_LAM0/1e-3)*100.)   # a kinoform of focal 100 mm


def _phase_lens(rows, wavelengths, radius, angle=None):
    from rayopt_tpu_torch import System
    obj = dict(pupil=dict(radius=radius, update_radius=False))
    if angle is not None:
        obj["angle_deg"] = angle
    s = System(rows, wavelengths=wavelengths, object=obj)
    s.update()
    return s


def phase_lenses():
    """{name: (system, table on the card, specs, bench half width)} of
    the phase lenses: the two published models (models.hybrid_achromat,
    models.spectrograph, full width) and four lenses of the JAX
    package's own grating and DOE tests (the curved-substrate hybrid
    with a two-term phase, the concave mirror grating, the refractive
    grating on an R = 80 N-BK7 substrate, the reflective zone plate)."""
    from rayopt_tpu_torch.models import hybrid_achromat, spectrograph
    from rayopt_tpu_torch.ops.kernels import specialize
    grating = dict(type="grating", grating_frequency=600., grating_order=1,
                   radius=30.)
    builds = {
        "hybrid achromat": (hybrid_achromat, 6.),
        "spectrograph": (spectrograph, 10.),
        "curved hybrid": (lambda: _phase_lens([
            dict(material="air"),
            dict(type="binary2", roc=120., phase_coefficients=[
                PHASE_A1, 1e-4], norm_radius=1., distance=5.,
                 material="glass/N-BK7", radius=10.),
            dict(roc=-150., distance=3., material="air", radius=10.),
            dict(distance=60., radius=10.)], [PHASE_LAM0], 3.), 3.),
        "mirror grating": (lambda: _phase_lens([
            dict(material="air"),
            dict(grating, distance=20., material="mirror", curvature=-.001),
            dict(distance=-50., radius=100.)], [500e-9], 5.), 5.),
        "bk7 grating": (lambda: _phase_lens([
            dict(material="air"),
            dict(grating, roc=80., distance=20., material="SCHOTT-BK|N-BK7"),
            dict(distance=5., material="air", radius=30.),
            dict(distance=50., radius=100.)], [500e-9], 5.), 5.),
        "zone plate": (lambda: _phase_lens([
            dict(material="vacuum"),
            dict(type="binary2", phase_coefficients=[PHASE_A1],
                 norm_radius=1., distance=50., material="mirror", radius=20.),
            dict(distance=-100., radius=20.)], [PHASE_LAM0], 5., .2), 5.)}
    out = {}
    for name, (build, half) in builds.items():
        s = build()
        table = s.table()
        out[name] = (s, table, specialize(table), half)
    return out


def phase_twin_system(name):
    """The phase-free twin of a timed lens: the hybrid achromat with
    `phase_coefficients: []`, the spectrograph with `grating_frequency:
    0`."""
    from rayopt_tpu_torch.models import hybrid_achromat, spectrograph
    if name == "hybrid achromat":
        s = hybrid_achromat()
        s[2].phase_coefficients = []
    else:
        s = spectrograph()
        s[1].grating_frequency = 0.
    s.update()
    return s


def phase_twin(name):
    """The phase-free twin of a timed lens (phase_twin_system): (table on
    the card, specs)."""
    from rayopt_tpu_torch.ops.kernels import specialize
    table = phase_twin_system(name).table()
    return table, specialize(table)


def phase_stack(s):
    """The stack of a phase lens's three wavelength tables on the card
    (System.tables: each table its own grating term and DOE
    coefficients; a lens of one wavelength at 1, 0.9 and 1.1 times it)
    and the specs they share (the first table's, multi_specs)."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    lam = list(s.wavelengths)
    if len(lam) < 3:
        lam = [lam[0], .9*lam[0], 1.1*lam[0]]
    tabs = s.tables(lam)
    return tabs, multi_specs(tabs, None)


def phase_opd_grad_fields(table, specs):
    """K9's cotangent columns by table field on a phase key:
    OPD_GRAD_FIELDS, then grating_dy, n_after and the nd DOE
    coefficients (the phase lenses have no figure, no anamorphic row)."""
    from rayopt_tpu_torch.ops.cuda_trace import carries_grating, doe_width
    q = 7
    out = OPD_GRAD_FIELDS
    if carries_grating(specs):
        out += (("grating_dy", slice(q, q + 1)),)
        q += 1
    nd = doe_width(table, specs)
    if nd:
        out += (("n_after", slice(q, q + 1)), ("doe", slice(q + 1,
                                                            q + 1 + nd)))
    return out


def kinoform():
    """The JAX package's kinoform of tests/test_doe.py (a flat zone lens
    of focal 100 mm in air at 550 nm, on axis), the lens of its
    test_doe_phase_enters_optical_path."""
    return _phase_lens([
        dict(material="air"),
        dict(type="binary2", phase_coefficients=[PHASE_A1], norm_radius=1.,
             distance=5., material="air", radius=10.),
        dict(distance=100., radius=10.)], [PHASE_LAM0], 3., 0.)


def phase_bundle_of(half):
    """The phase lenses' bench bundle: x, y uniform in +-half mm (the
    lens's pupil radius), u = (0, 0, 1), ray 0 on the axis."""
    def bundle(n, dtype, seed, widen=1.):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.empty(n, dtype=torch.float64, device=DEVICE)
        y = torch.empty_like(x)
        x.uniform_(-half*widen, half*widen, generator=gen)
        y.uniform_(-half*widen, half*widen, generator=gen)
        x[0] = y[0] = 0.
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        return tuple(c.to(dtype).contiguous()
                     for c in (x, y, zero, zero, zero, one))
    return bundle


def phase_grad_fields(table, specs):
    """K5's cotangent columns by table field on a phase key: GRAD_FIELDS,
    then a figured table's coefficients (none here), an anamorphic one's
    curvature_dx and conic_dx (none here), grating_dy and the nd DOE
    coefficients."""
    from rayopt_tpu_torch.ops.cuda_trace import carries_grating, doe_width
    q = 6 + sum(int(getattr(table, f).shape[-1])
                for f in ("aspherics", "aspherics_odd"))
    out = GRAD_FIELDS
    if carries_grating(specs):
        out += (("grating_dy", slice(q, q + 1)),)
        q += 1
    nd = doe_width(table, specs)
    if nd:
        out += (("doe", slice(q, q + nd)),)
    return out


def grating_keys():
    """{tag: key} of the phase keys this script runs: K1, K2, K4 and K5
    (every field, with the ray cotangents) in float64, unclipped, on
    every phase lens, and on the two timed lenses also float32 unclipped
    and float64 clipped; on the timed lenses the loops' K5 (the hybrid's
    PHASE_LOOP_FIELDS, the spectrograph's OPT_FIELDS and grating_dy, no
    ray cotangents) in both dtypes and their phase-free twins' keys
    (K1, K2, K4, K5 every field and OPT_FIELDS); the finite-difference
    checks' float64 K5 (one field each).  Then K3's two modes, K6 and K7
    (every field, with the ray cotangents) on each lens's stack
    (phase_stack) and K8 and K9 on its table: float64, clip off and on
    (K3 unclipped), and on the timed lenses also float32 (clip off and
    on; the spectrograph's K6 and K7 unclipped: their float32 moments
    are timed, not held); the hybrid's achromatization K7 and design K9
    (and the design step breakdown's K5 and K9), float64, and the timed
    lenses' loop K7 and K9 and their phase-free twins' K3, K6-K9 in
    float32 for the timings; the finite-difference checks' K7 and K9
    (one field each); the kinoform's K8."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import doe_width, figure_widths
    from rayopt_tpu_torch.ops.kernels import specialize
    keys = {}
    f64, f32 = torch.float64, torch.float32
    for name, (s, table, specs, _) in phase_lenses().items():
        tag = name.replace(" ", "-")
        kw = dict(widths=figure_widths(table, specs),
                  nd=doe_width(table, specs))
        tabs, mspecs = phase_stack(s)
        mkw = dict(widths=figure_widths(tabs, mspecs),
                   nd=doe_width(tabs, mspecs))
        timed = name in PHASE_TIMED
        for dtype in (f64, f32) if timed else (f64,):
            dt = str(dtype)[6:]
            if dtype == f64 or name == "hybrid achromat":
                # the clipped K7 check's agreement traces: K1 on each table
                # of the stack
                keys["K1 %s %s clip=True stack" % (dt, tag)] = CS.trace_key(
                    mspecs, dtype, True, **mkw)
            for mode in ("merit", "trace"):
                keys["K3 %s %s %s" % (dt, tag, mode)] = CS.trace_multi_key(
                    mspecs, dtype, 3, mode == "merit", **mkw)
            for clip in (False, True):
                sfx = "%s %s clip=%s" % (dt, tag, clip)
                keys["K8 " + sfx] = CS.opd_key(specs, dtype, clip, **kw)
                keys["K9 %s all rays=True" % sfx] = CS.opd_adjoint_key(
                    specs, dtype, clip, **kw)
                if clip and dtype == f32 and name == "spectrograph":
                    continue
                keys["K6 " + sfx] = CS.moments_multi_key(mspecs, dtype,
                                                         clip, 3, **mkw)
                keys["K7 %s all rays=True" % sfx] = CS.adjoint_multi_key(
                    mspecs, dtype, clip, **mkw)
        if timed:
            # the loops' K7 and K9 (the hybrid's achromatization and
            # design keys; the spectrograph's for its timings) and the
            # phase-free twins' keys, for the timings
            mloop = (PHASE_ACHROM_FIELDS if name == "hybrid achromat"
                     else ACHROM_FIELDS + ("grating_dy",))
            oloop = (PHASE_DESIGN_FIELDS if name == "hybrid achromat"
                     else DESIGN_FIELDS + ("grating_dy",))
            ts = phase_twin_system(name)
            ttable = ts.table()
            tspecs = specialize(ttable)
            _, tmspecs = phase_stack(ts)
            for dtype in (f64, f32):
                dt = str(dtype)[6:]
                keys["K7 %s %s achromatization rays=False" % (dt, tag)] = \
                    CS.adjoint_multi_key(mspecs, dtype, False, mloop, False,
                                         **mkw)
                keys["K9 %s %s design rays=False" % (dt, tag)] = \
                    CS.opd_adjoint_key(specs, dtype, False, oloop, False,
                                       **kw)
            tsfx = "float32 %s twin" % tag
            for mode in ("merit", "trace"):
                keys["K3 %s %s" % (tsfx, mode)] = CS.trace_multi_key(
                    tmspecs, f32, 3, mode == "merit")
            keys["K6 " + tsfx] = CS.moments_multi_key(tmspecs, f32, False, 3)
            keys["K7 %s all rays=True" % tsfx] = CS.adjoint_multi_key(
                tmspecs, f32)
            keys["K7 %s achromatization rays=False" % tsfx] = \
                CS.adjoint_multi_key(tmspecs, f32, False, ACHROM_FIELDS,
                                     False)
            keys["K8 " + tsfx] = CS.opd_key(tspecs, f32)
            keys["K9 %s all rays=True" % tsfx] = CS.opd_adjoint_key(tspecs,
                                                                   f32)
            keys["K9 %s design rays=False" % tsfx] = CS.opd_adjoint_key(
                tspecs, f32, False, DESIGN_FIELDS, False)
        if name == "hybrid achromat":
            # the design step's breakdown (curvature and offset)
            keys["K5 float64 %s breakdown rays=False" % tag] = \
                CS.adjoint_key(specs, f64, False, OPT_FIELDS, False, **kw)
            keys["K9 float64 %s breakdown rays=False" % tag] = \
                CS.opd_adjoint_key(specs, f64, False, DESIGN_FIELDS, False,
                                   **kw)
        for kern, lens, field, _ in PHASE_FD_ADJOINT_PICKS:
            if lens != name:
                continue
            if kern == "K7":
                keys["K7 float64 %s fd %s rays=False" % (tag, field)] = \
                    CS.adjoint_multi_key(mspecs, f64, False, (field,),
                                         False, **mkw)
            else:
                keys["K9 float64 %s fd %s rays=False" % (tag, field)] = \
                    CS.opd_adjoint_key(specs, f64, False, (field,), False,
                                       **kw)
        runs = [(f64, False)]
        if name in PHASE_TIMED:
            runs += [(torch.float32, False), (f64, True)]
        for dtype, clip in runs:
            sfx = "%s %s clip=%s" % (str(dtype)[6:], tag, clip)
            keys["K1 " + sfx] = CS.trace_key(specs, dtype, clip, **kw)
            keys["K2 " + sfx] = CS.merit_key(specs, dtype, clip, **kw)
            keys["K4 " + sfx] = CS.moments_key(specs, dtype, clip, **kw)
            keys["K5 %s all rays=True" % sfx] = CS.adjoint_key(
                specs, dtype, clip, **kw)
        if name in PHASE_TIMED:
            loop = (PHASE_LOOP_FIELDS if name == "hybrid achromat"
                    else OPT_FIELDS + ("grating_dy",))
            _, twin = phase_twin(name)
            for dtype in (torch.float32, f64):
                dt = str(dtype)[6:]
                keys["K5 %s %s designer rays=False" % (dt, tag)] = \
                    CS.adjoint_key(specs, dtype, fields=loop, rays=False,
                                   **kw)
                tsfx = "%s %s twin" % (dt, tag)
                keys["K1 " + tsfx] = CS.trace_key(twin, dtype)
                keys["K2 " + tsfx] = CS.merit_key(twin, dtype)
                keys["K4 " + tsfx] = CS.moments_key(twin, dtype)
                keys["K5 %s all rays=True" % tsfx] = CS.adjoint_key(twin,
                                                                    dtype)
                keys["K5 %s designer rays=False" % tsfx] = CS.adjoint_key(
                    twin, dtype, fields=OPT_FIELDS, rays=False)
        for lens, field, _ in PHASE_FD_PICKS:
            if lens == name:
                keys["K5 float64 %s fd %s rays=False" % (tag, field)] = \
                    CS.adjoint_key(specs, f64, fields=(field,), rays=False,
                                   **kw)
    kt = kinoform().table()
    ks = specialize(kt)
    keys["K8 float64 kinoform clip=False"] = CS.opd_key(
        ks, f64, widths=figure_widths(kt, ks), nd=doe_width(kt, ks))
    return keys


def phase_grating_check():
    """K1, K2, K4 and K5 (every field, with the ray cotangents) on every
    phase lens against their plain versions on the card at N_CHECK rays
    of the lens's bench bundle (phase_bundle_of): float64 unclipped on
    each (F64_REL of scale for K1 and K2, GRAD_F64_REL of a column's
    largest for K5, its grating_dy and DOE columns among them); on the
    timed lenses also float32 unclipped and float64 clipped on the
    bundle 1.5x wide.  Then K3, K6 and K7 on the lens's stack
    (phase_stack, phase_multi_check) and K8 and K9 (phase_opd_check, ray
    0 the chief ray), float64, clip off and on (clipped on the bundle
    phase_clip_bundle widens past the apertures), the adjoints with
    their grating_dy, n_after (K9) and DOE columns, the hybrid's loop
    keys among them; on the timed lenses also float32 (the
    spectrograph's K3 trace alone: its off-axis moments, as its K4's).
    Then K5's float64 gradient against central differences
    (phase_grating_fd_check), K7's and K9's (phase_grating_fd_adjoints)
    and K8 on the kinoform (phase_kinoform_check).  Returns the float32
    errors."""
    worst = {}

    def keep(errs):
        worst.update({k: max(v, worst.get(k, 0.)) for k, v in errs.items()})
    f64 = (torch.float64,)
    for lens, (s, table, specs, half) in phase_lenses().items():
        bundle = phase_bundle_of(half)
        fields = phase_grad_fields(table, specs)
        timed = lens in PHASE_TIMED
        dtypes = (torch.float32, torch.float64) if timed else f64
        if lens == "spectrograph":
            # its image sits 56-85 mm off the axis: a float32 spot RMS
            # from the five moments (E[y^2] - c^2, ROADMAP Queue 3)
            # cancels to ~1e-3, so each dtype is held to its own plain
            # version alone
            log("the spectrograph's float32 K2 is not held to float64's "
                "spot RMS, nor its float32 K4 and K5 to their plain "
                "versions' (float64 only): its 56-85 mm off-axis centroid "
                "cancels the moment formula's float32 digits")
            for dt in dtypes:
                keep(phase_check(table, specs, lens, bundle, (False,), (dt,)))
            phase_grad_check(table, specs, lens, bundle, (False,), fields,
                             f64)
        else:
            keep(phase_check(table, specs, lens, bundle, (False,), dtypes))
            keep(phase_grad_check(table, specs, lens, bundle, (False,),
                                  fields, dtypes))
        if timed:
            wide = functools.partial(bundle, widen=1.5)
            phase_check(table, specs, lens, wide, (True,), f64)
            phase_grad_check(table, specs, lens, wide, (True,), fields, f64)
        tabs, mspecs = phase_stack(s)
        mfields = phase_grad_fields(tabs, mspecs)
        ofields = phase_opd_grad_fields(table, specs)
        hybrid = lens == "hybrid achromat"
        mloop = PHASE_ACHROM_FIELDS if hybrid else None
        oloop = PHASE_DESIGN_FIELDS if hybrid else None
        f32 = (torch.float32,)
        mtypes = (torch.float32, torch.float64) if hybrid else f64
        otypes = (torch.float64, torch.float32) if timed else f64
        clipped = phase_clip_bundle(table, half)
        for bund, clips in ((bundle, (False,)), (clipped, (True,))):
            keep(phase_multi_check(tabs, mspecs, lens + ", its stack", bund,
                                   clips, mfields, mloop, mtypes))
            if lens == "spectrograph":
                phase_multi_check(tabs, mspecs, lens + ", its stack", bund,
                                  clips, mfields, None, f32, moments=False)
            keep(phase_opd_check(s, table, specs, lens, bund, clips,
                                 ofields, oloop, otypes))
    phase_grating_fd_check()
    phase_grating_fd_adjoints()
    phase_kinoform_check()
    return worst


def phase_clip_bundle(table, half):
    """The clipped checks' bench bundle of a phase lens: phase_bundle_of
    widened so that, 1.5x wide again (the checks' clip), it reaches 1.2x
    past the lens's smallest aperture."""
    rad = table.radius[1:].detach().cpu().double()
    rmin = float(rad[torch.isfinite(rad)].min())
    return phase_bundle_of(half*max(1., 1.2*rmin/(1.5*half)))


def phase_grating_fd_check():
    """K5's float64 gradient of the K4 merit (the spot RMS of N_CHECK
    bench rays) against central differences (steps PHASE_FD_STEP of
    the value): the mirror grating's grating_dy and the curved hybrid's
    two DOE coefficients."""
    from rayopt_tpu_torch.ops.cuda_grad import spot_moments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    cases = phase_lenses()
    log("== K5 on the phase lenses vs central differences of the K4 merit "
        "(float64, %d bench rays; relative steps %s)"
        % (N_CHECK, PHASE_FD_STEP))
    failures = []
    for lens, field, idx in PHASE_FD_PICKS:
        _, table, specs, half = cases[lens]
        state = phase_bundle_of(half)(N_CHECK, torch.float64, SEED)
        w = bench_weights(N_CHECK, torch.float64, SEED + 2)
        v = getattr(table, field).clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the baked rows, as intended
            mom = spot_moments(table.replace(**{field: v}), state, w,
                               specs=specs)
        spot_rms_from_moments(*mom).backward()

        def merit(tab):
            return float(spot_rms_from_moments(*weighted_moments(
                tab, specs, state, w)))
        h = PHASE_FD_STEP[field]*abs(float(getattr(table, field)[idx]))
        side = []
        for sgn in (1., -1.):
            b = getattr(table, field).clone()
            b[idx] += sgn*h
            side.append(merit(table.replace(**{field: b})))
        fd = (side[0] - side[1])/(2*h)
        g = float(v.grad[idx])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s, %s %s: K5 %.12g, central difference %.12g (step %.3g), rel "
            "%.2e -> %s" % (lens, field, idx, g, fd, h, rel,
                            "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s %s" % (lens, field, idx))
    if failures:
        raise AssertionError("K5 on the phase lenses disagrees with finite "
                             "differences: " + ", ".join(failures))


def phase_grating_fd_adjoints():
    """Float64, N_CHECK bench rays, against central differences (steps
    PHASE_FD_ADJOINT_STEP of the value): K7's gradient of the K6 merit
    (the union spot RMS of the lens's stack, phase_stack) w.r.t. one
    table's
    grating_dy of the mirror grating and DOE coefficient of the curved
    hybrid, and K9's of the K8 wavefront RMS (ray 0 the chief ray) w.r.t.
    the mirror grating's grating_dy, the curved hybrid's DOE coefficient
    and its DOE row's n_after (the phase term psi(r2) n_after)."""
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_wavefront_rms,
                                                polychromatic_spot_rms)
    cases = phase_lenses()
    log("== K7 and K9 on the phase lenses vs central differences of the K6 "
        "merit and the K8 wavefront RMS (float64, %d bench rays; relative "
        "steps %s)" % (N_CHECK, PHASE_FD_ADJOINT_STEP))
    failures = []
    for kern, lens, field, idx in PHASE_FD_ADJOINT_PICKS:
        s, table, specs, half = cases[lens]
        state = phase_bundle_of(half)(N_CHECK, torch.float64, SEED)
        w = bench_weights(N_CHECK, torch.float64, SEED + 2)
        y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
        if kern == "K7":
            tab, sp = phase_stack(s)

            def merit(tb, sp=sp):
                return polychromatic_spot_rms(tb, y0, u0, w, specs=sp)
        else:
            tab, sp = table, specs

            def merit(tb, s=s, sp=sp):
                return adjoint_wavefront_rms(
                    tb, y0, u0, w, ref=0, radius=-s.image.pupil.distance,
                    wavelength=s.wavelengths[0], scale=s.scale,
                    finite=s.object.finite, specs=sp)
        base = getattr(tab, field)
        v = base.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the baked rows, as intended
            merit(tab.replace(**{field: v})).backward()
        h = PHASE_FD_ADJOINT_STEP[field]*abs(float(base[idx]))
        side = []
        with torch.no_grad():
            for sgn in (1., -1.):
                b = base.clone()
                b[idx] += sgn*h
                side.append(float(merit(tab.replace(**{field: b}))))
        fd = (side[0] - side[1])/(2*h)
        g = float(v.grad[idx])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s, %s %s %s: kernel %.12g, central difference %.12g (step "
            "%.3g), rel %.2e -> %s" % (kern, lens, field, idx, g, fd, h, rel,
                                       "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s %s" % (kern, lens, field))
    if failures:
        raise AssertionError("K7 or K9 on the phase lenses disagrees with "
                             "finite differences: " + ", ".join(failures))


def phase_kinoform_check():
    """K8 on the JAX package's kinoform (kinoform(): a flat zone lens of
    focal 100 mm), as its test_doe_phase_enters_optical_path: 8 rays up
    the y axis to 2.5 mm through adjoint_opd_rays (K8, float64) on the
    card; the focused wavefront is flat to < 0.02 waves (the DOE's
    phase psi(r2) n_after in the path) and equals the CPU plain version
    to 1e-12 of the largest optical path; without that term (n_after 0
    on its row) it carries tens of waves.  Then N_CHECK rays of the 3 mm
    bench bundle: K8 against the CPU plain version to 1e-12 of the
    largest optical path, equal NaN masks."""
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_opd_rays, opd_chain
    from rayopt_tpu_torch.ops.kernels import specialize
    s = kinoform()
    table, cpu = s.table(), s.table(device="cpu")
    specs = specialize(table)
    n = 8
    y = torch.zeros((n, 3), dtype=torch.float64)
    y[:, 1] = torch.linspace(0., 2.5, n, dtype=torch.float64)
    u = torch.zeros_like(y)
    u[:, 2] = 1.
    kw = dict(ref=0, radius=-100., wavelength=PHASE_LAM0, specs=specs)
    before = opd_chain.launches
    card = adjoint_opd_rays(table, y.to(DEVICE), u.to(DEVICE), **kw)
    plain = adjoint_opd_rays(cpu, y, u, **kw)
    bare = adjoint_opd_rays(table.replace(n_after=torch.zeros_like(
        table.n_after)), y.to(DEVICE), u.to(DEVICE), **kw)
    state = phase_bundle_of(3.)(N_CHECK, torch.float64, SEED)
    yb, ub = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
    big = adjoint_opd_rays(table, yb, ub, **kw).detach().cpu()
    torch.cuda.synchronize()
    launched = opd_chain.launches - before
    big_plain = adjoint_opd_rays(cpu, yb.cpu(), ub.cpu(), **kw).detach()
    card, bare = card.detach().cpu(), bare.detach().cpu()
    flat = float(card.abs().max())
    err = float((card - plain.detach()).abs().max())
    path = 5.*1. + 100.       # the axial path to the sphere, mm
    scale = path/(PHASE_LAM0/s.scale)
    masks = int((torch.isnan(big) != torch.isnan(big_plain)).sum())
    good = torch.isfinite(big_plain)
    err_big = float((big[good] - big_plain[good]).abs().max())
    ok = (flat < .02 and err <= 1e-12*scale and float(bare.abs().max()) > 10.
          and masks == 0 and err_big <= 1e-12*scale and launched == 3)
    log("== K8 on the kinoform (f = 100 mm at %g m, 8 rays up y to 2.5 mm, "
        "float64): max |OPD| %.3e waves (the JAX package asserts < 0.02) | "
        "vs the CPU plain version %.3e waves (of |k| ~%.4g) | without the "
        "phase term %.4g waves | %d bench rays in +-3 mm: max |OPD| %.4g "
        "waves, vs the CPU plain version %.3e waves, NaN masks differ on %d "
        "| K8 launches %d -> %s"
        % (PHASE_LAM0, flat, err, scale, float(bare.abs().max()), N_CHECK,
           float(big_plain[good].abs().max()), err_big, masks, launched,
           "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("K8 on the kinoform failed")


def phase_spectrograph_path():
    """The spectrograph's forward path at each wavelength's own table
    (models.spectrograph, full width): N_AIMED bench rays (ray 0 the
    on-axis ray, the detector line) through float64 K1 and K2 on the
    card; the line position -- ray 0's image height -- against the JAX
    package's golden (LINES_REL), K2's spot RMS against K1's, and the
    first N_PHASE rays of K1's own output against the CPU float64 plain
    trace (PARITY_REL, equal NaN masks).  Then K3's trace of the same
    rays through the three wavelengths' stack (System.tables, one launch:
    each table its own grating term): its image positions against float64
    K1's at each wavelength's table (F64_REL of scale, equal NaN masks)
    and its detector lines against the golden (LINES_REL).  The forward
    path's launches are counted from the caller's reset."""
    from rayopt_tpu_torch.models import spectrograph
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_final, trace_merit,
                                                 trace_multi)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    from rayopt_tpu_torch.ops.kernels import specialize
    s = spectrograph()
    log("== spectrograph path: 600 lp/mm on an R = -400 mirror, order 1, "
        "%d bench rays a wavelength through float64 K1 and K2 at each "
        "wavelength's table" % N_AIMED)
    failures, k1 = [], []
    bundle = phase_bundle_of(10.)
    for lam, want in zip(s.wavelengths, SPECTROGRAPH_LINES):
        table = s.table(lam)
        table_cpu = s.table(lam, device="cpu")
        specs = specialize(table)
        state = bundle(N_AIMED, torch.float64, SEED + 11)
        t0 = time.perf_counter()
        out, _ = trace_final(table, specs, state)
        rms_k1, live = spot_rms(torch.stack(out[:3], 1),
                                torch.stack(out[3:], 1))
        rms_k2 = float(spot_rms_from_moments(*trace_merit(table, specs,
                                                          state)))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        line = float(out[1][0])
        y = torch.stack(state[:3], 1)[:N_PHASE].cpu()
        u = torch.stack(state[3:], 1)[:N_PHASE].cpu()
        yh, uh, _ = trace_rays_final_fast(table_cpu, y, u)
        rms_cpu, live_cpu = spot_rms(yh, uh)
        sub = torch.stack(out[:3], 1)[:N_PHASE]
        rms_sub, live_sub = spot_rms(sub, torch.stack(out[3:], 1)[:N_PHASE])
        masks = int((torch.isnan(sub[:, 0].cpu())
                     != torch.isnan(yh[:, 0])).sum())
        rel_line = abs(line - want)/abs(want)
        rel1 = abs(rms_sub - rms_cpu)/rms_cpu
        ok = (rel_line <= LINES_REL and masks == 0 and live_sub == live_cpu
              and rel1 <= PARITY_REL
              and abs(rms_k2 - rms_k1)/rms_k1 <= 1e-9)
        log("%.0f nm: line %.12f mm vs golden %.12f (rel %.2e) | %d of %d "
            "rays live | spot RMS mm: K1 f64 %.12g, K2 f64 %.12g | the "
            "first %d rays: K1 f64 %.12g vs CPU f64 %.12g (rel %.2e), NaN "
            "masks differ on %d | card %.2f s -> %s"
            % (lam*1e9, line, want, rel_line, live, N_AIMED, rms_k1, rms_k2,
               N_PHASE, rms_sub, rms_cpu, rel1, masks, t_gpu,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%.0f nm" % (lam*1e9))
        k1.append(torch.stack(out[:3], 1))
        del out
    t0 = time.perf_counter()
    tabs = s.tables()
    multi = trace_multi(tabs, None, state)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    for li, ((lam, want), y1) in enumerate(zip(zip(s.wavelengths,
                                                   SPECTROGRAPH_LINES), k1)):
        y3 = torch.stack(multi[li][0][:3], 1)
        masks = int((torch.isnan(y3[:, 0]) != torch.isnan(y1[:, 0])).sum())
        good = torch.isfinite(y3[:, 0]) & torch.isfinite(y1[:, 0])
        err = float((y3[good] - y1[good]).abs().max())
        scale = max(float(y1[good].abs().max()), 1.)
        line = float(y3[0, 1])
        rel_line = abs(line - want)/abs(want)
        ok = masks == 0 and err <= F64_REL*scale and rel_line <= LINES_REL
        log("K3 f64 trace of the 3-wavelength stack, %.0f nm: image "
            "positions vs f64 K1 at its table max %.3e mm (of %.6g), NaN "
            "masks differ on %d | line %.12f mm vs golden %.12f (rel %.2e) "
            "| card %.2f s for the stack -> %s"
            % (lam*1e9, err, scale, masks, line, want, rel_line, t_gpu,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("K3 %.0f nm" % (lam*1e9))
    del multi, k1, state
    if failures:
        raise AssertionError("spectrograph path failed: "
                             + ", ".join(failures))


def phase_hybrid_path(opt_step, glass_step, design_step):
    """The hybrid achromat's main path through the entry points a user
    calls (models.hybrid_achromat, full width): System.pupils of the
    aimed lens on the card against the host pupil at tol AIM_HOST_TOL,
    N_AIMED_LENS rays a field aimed by the host at fields 0, 0.7 and 1
    through float64 and float32 K1 and K2, and the spot RMS of float64
    K1's output on the first N_PHASE of them against the CPU float64
    plain trace (PARITY_REL, equal NaN masks); then its designer loop
    over PHASE_SELECT (designer_loop: 3 fields x 3 wavelengths, nrays
    N_OPT, float64, OPT_STEPS Adam steps; step 0 against the CPU at
    N_LOOP_CHECK nrays a bundle), its achromatization loop
    (phase_glass_path: K3, K6 and K7 over the three wavelengths, over the
    curvatures, the distances, the singlet's glass and the kinoform's
    phase coefficient A) and its design step (phase_design_path over
    PHASE_SELECT: K4, K5, K8 and K9, the DOE's phase in the optical path;
    the spot bundles' chroma does not override the DOE coefficients, as
    the reference's), each loop's step 0 against the CPU at N_LOOP_CHECK
    nrays a bundle, its later steps logged beside the double Gauss's
    (`opt_step`, `glass_step`, `design_step` seconds).  Returns the
    path's launches (the forward part's, counted from the caller's
    reset, and each loop's), the loops' later-step seconds and the
    aimed bundles (on the card, with their float64 K1 image positions
    and the CPU float64 spot RMS of their first N_PHASE rays: the df32
    path's)."""
    from rayopt_tpu_torch.models import hybrid_achromat
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_merit)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    s, table, specs, _ = phase_lenses()["hybrid achromat"]
    table_cpu = s.table(device="cpu")
    log("== hybrid achromat path: an N-BK7 singlet with a kinoform on its "
        "exit face (row 2), %d aimed rays a field, no clip" % N_AIMED_LENS)
    fields = [(0., f) for f in FIELDS]

    def aimed_lens():
        a = hybrid_achromat()
        a.object.pupil.aim = True
        a.update()
        return a
    a = aimed_lens()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a host fallback fails
        z, boxes = a.pupils(fields)
    t_card = time.perf_counter() - t0
    h = aimed_lens()
    t0 = time.perf_counter()
    tight = [h.pupil(f, tol=AIM_HOST_TOL) for f in fields]
    t_host = time.perf_counter() - t0
    zh = np.array([v[0] for v in tight])
    bh = np.array([v[1] for v in tight])
    rel_z = float((np.abs(z - zh)/np.abs(zh)).max())
    rel_b = float((np.abs(boxes - bh)/np.abs(bh)).max())
    failures = []
    ok = rel_z <= AIM_REL and rel_b <= AIM_REL
    log("System.pupils of the aimed hybrid on the card %.3f s vs host pupil "
        "at tol %g %.3f s: z rel %.3e, boxes rel %.3e -> %s"
        % (t_card, AIM_HOST_TOL, t_host, rel_z, rel_b,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("System.pupils")
    rng = np.random.RandomState(SEED + 9)
    aimed = []
    for field in FIELDS:
        t0 = time.perf_counter()
        zf, pf = s.pupil((0., field))
        r = np.sqrt(rng.uniform(0, 1, N_AIMED_LENS))
        th = rng.uniform(0, 2*np.pi, N_AIMED_LENS)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., field), yp, zf, pf, filter=False)
        t_aim = time.perf_counter() - t0
        yc, uc = (torch.from_numpy(v).to(DEVICE) for v in (y0, u0))
        t0 = time.perf_counter()
        y64, u64, _ = trace_rays_final_fast(table, yc, uc, specs=specs,
                                            precision="parity")
        rms_k1, live = spot_rms(y64, u64)
        state64 = tuple(c.contiguous() for c in (*yc.T, *uc.T))
        rms_k2 = float(spot_rms_from_moments(*trace_merit(table, specs,
                                                          state64)))
        y32, u32, _ = trace_rays_final_fast(table, yc.float(), uc.float(),
                                            specs=specs)
        rms_k1_32, _ = spot_rms(y32, u32)
        rms_k2_32 = float(spot_rms_from_moments(*trace_merit(
            table, specs, tuple(c.float() for c in state64))))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        rms_sub, live_sub = spot_rms(y64[:N_PHASE], u64[:N_PHASE])
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu, yc[:N_PHASE].cpu(),
                                          uc[:N_PHASE].cpu())
        rms_cpu, live_cpu = spot_rms(yh, uh)
        t_cpu = time.perf_counter() - t0
        masks = int((torch.isnan(y64[:N_PHASE, 0].cpu())
                     != torch.isnan(yh[:, 0])).sum())
        rel1 = abs(rms_sub - rms_cpu)/rms_cpu
        ok = (np.isfinite(rms_k1) and np.isfinite(rms_k2) and masks == 0
              and live_sub == live_cpu and rel1 <= PARITY_REL
              and abs(rms_k2 - rms_k1)/rms_k1 <= 1e-9)
        log("field %.1f: pupil z %.6f, %d of %d rays live | spot RMS mm: K1 "
            "f64 %.12g | K2 f64 %.12g | K1 f32 %.9g (rel %.2e) | K2 f32 "
            "%.9g (rel %.2e) | the first %d rays: K1 f64 %.12g vs CPU f64 "
            "%.12g (rel %.2e), NaN masks differ on %d | aim %.2f s, card "
            "%.2f s, CPU %.2f s -> %s"
            % (field, zf, live, N_AIMED_LENS, rms_k1, rms_k2, rms_k1_32,
               abs(rms_k1_32 - rms_k1)/rms_k1, rms_k2_32,
               abs(rms_k2_32 - rms_k1)/rms_k1, N_PHASE, rms_sub, rms_cpu,
               rel1, masks, t_aim, t_gpu, t_cpu, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("field %.1f" % field)
        aimed.append(dict(field=field, y=yc, u=uc, y64=y64,
                          rms_cpu=rms_cpu, live_cpu=live_cpu,
                          n_ref=N_PHASE))
        del u64, y32, u32, state64
    if failures:
        raise AssertionError("hybrid achromat path failed: "
                             + ", ".join(failures))
    forward = read_launches()
    log("== launch counts on the hybrid achromat's forward path: %s"
        % forward)
    torch.cuda.empty_cache()
    loop, step, _ = designer_loop(hybrid_achromat(), "phase designer loop: "
                                  "hybrid achromat", PHASE_SELECT, None,
                                  N_LOOP_CHECK)
    glass, gstep, _ = phase_glass_path(hybrid_achromat(), "hybrid achromat",
                                       N_LOOP_CHECK, slots=1)
    design, dstep, _ = phase_design_path(hybrid_achromat(), "hybrid achromat",
                                         PHASE_SELECT, None, N_LOOP_CHECK)
    steps = {"designer": step, "achromatization": gstep, "design": dstep}
    log("later steps: %s" % ", ".join(
        "%s loop hybrid achromat %.4f s, double Gauss %.4f s (%.2fx)"
        % (k, v, t, v/t) for (k, v), t in zip(
            steps.items(), (opt_step, glass_step, design_step))))
    return ({k: v + loop[k] + glass[k] + design[k]
             for k, v in forward.items()}, steps, aimed)


def phase_grating_throughput(card):
    """K1, K2, K4 and K5 on the timed phase lenses (PHASE_TIMED) beside
    their phase-free twins (phase_twin: the hybrid without its kinoform,
    the spectrograph at grating_frequency 0) on the lens's bench bundle:
    phase_throughput and phase_grad_throughput (K5 also for the loop's
    slot set) in both dtypes at N_GRAD_TIME rays and float32 at N_BENCH.
    times[lens] = their times."""
    cases = phase_lenses()
    times = {}
    for lens in PHASE_TIMED:
        s, table, specs, half = cases[lens]
        twin = phase_twin(lens)
        loop = (PHASE_LOOP_FIELDS if lens == "hybrid achromat"
                else OPT_FIELDS + ("grating_dy",))
        kw = dict(lens=lens, bundle=phase_bundle_of(half),
                  twin_name="phase-free twin")
        times[lens] = phase_throughput(table, specs, card, N_GRAD_TIME, twin,
                                       N_BENCH, **kw)
        times[lens].update(phase_grad_throughput(table, specs, card, twin,
                                                 loop, **kw))
    return times


def phase_multi_throughput_grating(card):
    """K3 (merit and trace), K6, K7 (every field with the ray
    cotangents, and the loop's key), K8 and K9 (the same two) on the
    timed phase lenses (PHASE_TIMED; K3, K6 and K7 on the lens's stack,
    phase_stack; ray 0 the chief ray) in float32 (multi_opd_throughput:
    against their plain versions at N_CHECK bench rays, against the
    phase-free twins' keys, phase_twin_system, at N_BENCH).  Returns
    times[lens][(name, n)] = (kernel, plain or twin) ms and
    live[lens][n] = (the multi bundle's live ray traces summed over the
    wavelengths, the OPD bundle's live rays)."""
    from rayopt_tpu_torch.ops.kernels import specialize
    cases = phase_lenses()
    times, live = {}, {}
    for lens in PHASE_TIMED:
        s, table, specs, half = cases[lens]
        ts = phase_twin_system(lens)
        ttable = ts.table()
        hybrid = lens == "hybrid achromat"
        mloop = (PHASE_ACHROM_FIELDS if hybrid
                 else ACHROM_FIELDS + ("grating_dy",))
        oloop = (PHASE_DESIGN_FIELDS if hybrid
                 else DESIGN_FIELDS + ("grating_dy",))
        times[lens], live[lens] = multi_opd_throughput(
            card, lens, "phase keys", (s, table, specs, *phase_stack(s)),
            (ts, ttable, specialize(ttable), *phase_stack(ts)),
            (mloop, oloop), (ACHROM_FIELDS, DESIGN_FIELDS),
            phase_bundle_of(half), "phase-free twin key")
    return times, live


def multi_opd_throughput(card, lens, what, mine, twin, loops, twin_loops,
                         bundle, twin_name, big=None):
    """K3 (merit and trace), K6, K7 (every field with the ray
    cotangents, and the loop's key for the fields loops[0]), K8 and K9
    (the same two, loops[1]) of one lens in float32: mine and twin are
    (system, table, specs, stack, stack specs) of the lens and of its
    twin (twin_loops its loop keys' fields).  At N_CHECK rays of
    `bundle` (ray 0 the chief ray) against their plain versions in turns
    (plain, kernel, kernel, plain), then at big[name] rays (N_BENCH when
    not given) against the twin's keys (kernel, twin, kernel, twin),
    where the kernel outweighs the wrapper's ~0.2 ms.  Returns
    (times[(name, n)] = (kernel, plain or twin) ms, live[n] = (the multi
    bundle's live ray traces summed over the wavelengths, the OPD
    bundle's live rays))."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint_multi, merit_adjoint_multi_reference, opd_adjoint,
        opd_adjoint_reference, opd_chain, opd_chain_reference,
        weighted_moments_multi, weighted_moments_multi_reference)
    from rayopt_tpu_torch.ops.cuda_trace import (trace_multi,
                                                 trace_multi_reference)
    f32 = torch.float32
    big = big or {}
    sizes = sorted({big.get(n, N_BENCH) for n in (
        "trace_multi", "trace_multi_trace", "weighted_moments_multi",
        "merit_adjoint_multi", "merit_adjoint_multi_loop", "opd_chain",
        "opd_adjoint", "opd_adjoint_loop")})
    log("== K3/K6-K9 throughput (%s, %s, float32): %d bench rays x 3 "
        "wavelengths against the plain versions, then %s rays against the "
        "%ss (%s)" % (lens, what, N_CHECK, big or N_BENCH, twin_name, card))

    def cases_of(state, w, sy, tb, sp, tbs, msp, ml, ol):
        ct = rms_cotangent(weighted_moments_multi(tbs, msp, state, w))
        aux = opd_aux(sy, tb, sp, state)
        k = opd_chain(tb, sp, state, aux)
        cts = opd_cotangents(*k, "wavefront")
        nlive = (sum(float(m[0]) for m in trace_multi(
            tbs, msp, state, merit=True)), int(torch.isfinite(k[0]).sum()))
        return (
            ("trace_multi",
             lambda: trace_multi(tbs, msp, state, merit=True),
             lambda: trace_multi_reference(tbs, msp, state, merit=True)),
            ("trace_multi_trace",
             lambda: trace_multi(tbs, msp, state),
             lambda: trace_multi_reference(tbs, msp, state)),
            ("weighted_moments_multi",
             lambda: weighted_moments_multi(tbs, msp, state, w),
             lambda: weighted_moments_multi_reference(tbs, msp, state, w)),
            ("merit_adjoint_multi",
             lambda: merit_adjoint_multi(tbs, msp, state, w, ct),
             lambda: merit_adjoint_multi_reference(tbs, msp, state, w, ct)),
            ("merit_adjoint_multi_loop",
             lambda: merit_adjoint_multi(tbs, msp, state, w, ct, fields=ml,
                                         rays=False), None),
            ("opd_chain", lambda: opd_chain(tb, sp, state, aux),
             lambda: opd_chain_reference(tb, sp, state, aux)),
            ("opd_adjoint", lambda: opd_adjoint(tb, sp, state, aux, cts),
             lambda: opd_adjoint_reference(tb, sp, state, aux, cts)),
            ("opd_adjoint_loop",
             lambda: opd_adjoint(tb, sp, state, aux, cts, fields=ol,
                                 rays=False), None)), nlive
    times, live = {}, {}
    for n in (N_CHECK, *sizes):
        state = bundle(n, f32, SEED + 1)
        w = bench_weights(n, f32, SEED + 3)
        mine_cases, live[n] = cases_of(state, w, *mine, *loops)
        twins = (cases_of(state, w, *twin, *twin_loops)[0]
                 if n != N_CHECK else None)
        for case, (name, kernel, plain) in enumerate(mine_cases):
            if n == N_CHECK:
                if plain is None:
                    continue
                (k, p, _), (k1, k2, p1, p2, _, _) = in_turns(kernel, plain,
                                                             reps=10)
                times[(name, n)] = (k, p)
                log("%s float32 at %d rays: kernel %.4f ms (%.4f, %.4f), "
                    "plain %.4f ms (%.4f, %.4f), plain/kernel %.2fx | %s"
                    % (name, n, k, k1, k2, p, p1, p2, p/k, card))
            elif big.get(name, N_BENCH) == n:
                (k, _, t), (k1, k2, _, _, t1, t2) = in_turns(
                    kernel, None, twins[case][1], 10)
                times[(name, n)] = (k, t)
                log("%s float32 at %d rays: kernel %.4f ms (%.4f, %.4f)%s | "
                    "%s" % (name, n, k, k1, k2, twin_note(k, t, t1, t2,
                                                          twin_name), card))
        del mine_cases, twins, state, w
        torch.cuda.empty_cache()
    return times, live


PHASE_SOLVE_FLOPS = 55   # the grating/phase solve without the kick
PHASE_RADIAL_FLOPS = 11  # a phase row's radial normal (kernels.normal_radial)


def phase_row_flops(spec, widths=(0, 0), nd=0, nxy=0):
    """Operations of one surface_step on a phase row: its substrate's
    intercept and transfer (row_flops of the row as a passthrough: a
    phase cylinder's closed form), the substrate's normal (a flat's
    none, the radial normal, a biconic's or toroid's general one, a
    phase cylinder's too: the biconic's or toroid's that made it), the
    generalized solve (the groove vector and
    its norm, b, Gamma's root and the new direction) and a DOE's kick
    (Horner, 2 a coefficient) and optical path term."""
    base = row_flops(spec._replace(kind=0, grating=False, doe=False),
                     widths, nxy=nxy)
    if spec.freeform:
        normal = slope_flops(*widths) - 6 + xy_flops(nxy)[1]
    elif spec.biconic or spec.toroidal:
        c = ANAM_FLOPS["toroid" if spec.toroidal else "biconic"]
        normal = c["refract"] - 37 + anam_figure_flops(*widths)[1]
    elif spec.flat and not (spec.aspheric or spec.odd):
        normal = 0
    else:
        normal = PHASE_RADIAL_FLOPS + (slope_flops(*widths) - 17
                                       if spec.aspheric or spec.odd else 0)
    kick = (2*nd + 7) + (2*nd + 4) if spec.doe else 0
    return base + normal + PHASE_SOLVE_FLOPS + kick


def grating_entries(sources, launches, worst, times, ptxas, step, dg_step):
    """The kernels line's entries of the phase keys: the phase paths'
    launches (the spectrograph's forward path, the hybrid's forward path
    and designer loop), the float32 errors of phase_grating_check, the
    times of phase_grating_throughput (the hybrid's DOE keys beside their
    plain versions and their phase-free twin's keys; the spectrograph's
    grating keys under "spectrograph_"), at N_GRAD_TIME rays in both
    dtypes and N_BENCH in float32, the bounds (kernel_bound, the phase
    rows by phase_row_flops), the keys' registers, stack and spills, and
    the hybrid's designer loop's later-step seconds beside the double
    Gauss's."""
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 trace_merit)
    cases = phase_lenses()
    live = {(lens, n, dtype): float(trace_merit(
        cases[lens][1], cases[lens][2], phase_bundle_of(cases[lens][3])(
            n, dtype, SEED + 1))[0])
        for lens in PHASE_TIMED for n, dtype in (
            (N_GRAD_TIME, torch.float32), (N_GRAD_TIME, torch.float64),
            (N_BENCH, torch.float32))}
    loop = {"trace_final": "K1 %s %s clip=False",
            "trace_merit": "K2 %s %s clip=False",
            "weighted_moments": "K4 %s %s clip=False",
            "merit_adjoint": "K5 %s %s designer rays=False"}
    big = "_f32_%d_rays" % N_BENCH
    out = []
    for kname, tag in loop.items():
        source, replaces = sources[kname]
        entry = {"name": kname + "_grating", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_GRAD_TIME, "wavelengths": 1}
        for lens, pre in zip(PHASE_TIMED, ("", "spectrograph_")):
            _, table, specs, _ = cases[lens]
            tt = times[lens]

            def bound(n, dtype, name=kname, tab=table, sp=specs, ln=lens):
                return kernel_bound(name, n, dtype, sp, 1,
                                    live[(ln, n, dtype)],
                                    figure_widths(tab, sp),
                                    doe_width(tab, sp))
            for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
                k, p = tt[(kname, dtype)]
                b, by = bound(N_GRAD_TIME, dtype)
                entry.update({pre + "ms" + sfx: k, pre + "plain_ms" + sfx: p,
                              pre + "ms_twin_key" + sfx:
                                  tt[(kname, dtype, "twin")],
                              pre + "bound_ms" + sfx: b})
                if not pre and not sfx:
                    entry["bound_by"] = by
                if kname == "merit_adjoint":
                    opt = "merit_adjoint_optimizer"
                    entry.update({
                        pre + "ms_designer" + sfx: tt[(opt, dtype)],
                        pre + "ms_twin_designer_key" + sfx:
                            tt[(opt, dtype, "twin")],
                        pre + "bound_ms_designer" + sfx:
                            bound(N_GRAD_TIME, dtype, opt)[0]})
            entry.update({pre + "ms" + big: tt[(kname, N_BENCH)],
                          pre + "ms_twin_key" + big:
                              tt[(kname, N_BENCH, "twin")],
                          pre + "bound_ms" + big:
                              bound(N_BENCH, torch.float32)[0]})
            for dt in ("float32", "float64"):
                lt = lens.replace(" ", "-")
                sfx = "" if dt == "float64" else "_f32"
                regs, stack, spill = ptxas[tag % (dt, lt)]
                entry.update({pre + "regs" + sfx: regs,
                              pre + "stack_bytes" + sfx: stack,
                              pre + "spill_bytes" + sfx: spill})
                regs, stack, spill = ptxas[(tag % (dt, lt + " twin"))
                                           .replace(" clip=False", "")]
                entry.update({pre + "regs_twin" + sfx: regs})
        if kname == "merit_adjoint":
            entry.update({"designer_step_s": step,
                          "double_gauss_designer_step_s": dg_step})
        out.append(entry)
    return out


def grating_multi_entries(sources, launches, worst, times, live, ptxas,
                          steps, dg_steps):
    """The kernels line's entries of K3, K6, K7, K8 and K9's phase keys:
    the phase paths' launches (the spectrograph's K3 trace, the hybrid's
    achromatization loop and design step), the float32 errors of
    phase_grating_check, the times of phase_multi_throughput_grating
    (the hybrid's at N_CHECK against the plain versions and at N_BENCH
    against the phase-free twin's keys; the spectrograph's under
    "spectrograph_"), the bounds (kernel_bound at each size's live rays,
    the phase rows by phase_row_flops), the keys' registers, stack and
    spills (float64: the hybrid's loop keys), and the hybrid's loops'
    later-step seconds beside the double Gauss's."""
    from rayopt_tpu_torch.ops.cuda_trace import doe_width, figure_widths
    cases = phase_lenses()
    # the tags in ptxas of each kernel's key (K3: its merit mode; K7 and
    # K9: every field with the ray cotangents) and its loop key
    tags = {"trace_multi": "K3 %s %s merit",
            "weighted_moments_multi": "K6 %s %s clip=False",
            "merit_adjoint_multi": "K7 %s %s clip=False all rays=True",
            "opd_chain": "K8 %s %s clip=False",
            "opd_adjoint": "K9 %s %s clip=False all rays=True"}
    loop_tags = {"trace_multi": "K3 %s %s trace",
                 "merit_adjoint_multi": "K7 %s %s achromatization rays=False",
                 "opd_adjoint": "K9 %s %s design rays=False"}
    big = "_f32_%d_rays" % N_BENCH
    out = []
    for kname, tag in tags.items():
        source, replaces = sources[kname]
        multi = kname in ("trace_multi", "weighted_moments_multi",
                          "merit_adjoint_multi")
        entry = {"name": kname + "_grating", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_CHECK,
                 "wavelengths": 3 if multi else 1}
        extra = {"trace_multi": "trace_multi_trace",
                 "merit_adjoint_multi": "merit_adjoint_multi_loop",
                 "opd_adjoint": "opd_adjoint_loop"}.get(kname)
        for lens, pre in zip(PHASE_TIMED, ("", "spectrograph_")):
            s, table, specs, _ = cases[lens]
            tabs, mspecs = phase_stack(s)
            tb, sp = (tabs, mspecs) if multi else (table, specs)
            tt = times[lens]

            def bound(name, n, tb=tb, sp=sp, ln=lens):
                nlive = live[ln][n][0 if multi else 1]
                return kernel_bound(name, n, torch.float32, sp,
                                    3 if multi else 1, nlive,
                                    figure_widths(tb, sp), doe_width(tb, sp))
            k, p = tt[(kname, N_CHECK)]
            b, by = bound(kname, N_CHECK)
            kb, tw = tt[(kname, N_BENCH)]
            entry.update({pre + "ms": k, pre + "plain_ms": p,
                          pre + "bound_ms": b, pre + "ms" + big: kb,
                          pre + "ms_twin_key" + big: tw,
                          pre + "bound_ms" + big: bound(kname, N_BENCH)[0]})
            if not pre:
                entry["bound_by"] = by
            if extra:
                sfx = "_trace" if kname == "trace_multi" else "_loop_key"
                if (extra, N_CHECK) in tt:
                    ke, pe = tt[(extra, N_CHECK)]
                    entry.update({pre + "ms" + sfx: ke,
                                  pre + "plain_ms" + sfx: pe,
                                  pre + "bound_ms" + sfx:
                                      bound(extra, N_CHECK)[0]})
                ke, te = tt[(extra, N_BENCH)]
                entry.update({pre + "ms" + sfx + big: ke,
                              pre + "ms_twin_key" + sfx + big: te,
                              pre + "bound_ms" + sfx + big:
                                  bound(extra, N_BENCH)[0]})
            lt = lens.replace(" ", "-")
            for dt in ("float32", "float64"):
                sfx = "" if dt == "float64" else "_f32"
                regs, stack, spill = ptxas[tag % (dt, lt)]
                entry.update({pre + "regs" + sfx: regs,
                              pre + "stack_bytes" + sfx: stack,
                              pre + "spill_bytes" + sfx: spill})
                if kname in loop_tags:
                    regs, stack, spill = ptxas[loop_tags[kname] % (dt, lt)]
                    lsfx = "_trace" if kname == "trace_multi" else "_loop_key"
                    entry.update({pre + "regs" + lsfx + sfx: regs,
                                  pre + "spill_bytes" + lsfx + sfx: spill})
            twin_tag = (tag % ("float32", lt + " twin")).replace(
                " clip=False", "")
            entry[pre + "regs_twin_f32"] = ptxas[twin_tag][0]
        if kname == "merit_adjoint_multi":
            entry.update({"achromatization_step_s": steps["achromatization"],
                          "double_gauss_achromatization_step_s":
                              dg_steps["achromatization"]})
        if kname == "opd_adjoint":
            entry.update({"design_step_s": steps["design"],
                          "double_gauss_design_step_s": dg_steps["design"]})
        out.append(entry)
    return out


# ---- the phase rows in df32 (K10-K13) and on a cylinder (K1-K9) ----

#: the phase cylinders (make_table keyword arguments; row 1 between the
#: object and an image plane, glass after it): a grating on a
#: biconic-made y-cylinder (cx = 0) and a DOE on a toroid-made one (cr =
#: 0)
PHASE_CYLINDERS = {
    "grating cylinder": dict(curvature=[0., 1/40., 0.],
                             curvature_dx=[0., -1/40., 0.],
                             conic=[0., -.3, 0.], conic_dx=[0., .5, 0.],
                             grating_dy=[0., .1, 0.]),
    "doe cylinder": dict(curvature=[0., 1/50., 0.],
                         curvature_dx=[0., -1/50., 0.],
                         toroidal=[0., 1., 0.], conic=[0., .2, 0.],
                         doe=[[0., 0.], [-1.5e-3, 2e-7], [0., 0.]])}
PHASE_CYL_HALF = 3.   # the cylinders' bench half width, mm
PHASE_CYL_OPD = dict(radius=-40., wavelength=550e-9, scale=1e-3)
#: the df32 phase cases of the df32 path (held at N_CHECK rays, fast
#: unclipped, exact unclipped and clipped: the path's plans and a clip);
#: the phase cylinders (N_CHECK rays) and the JAX package's four test
#: lenses (N_DF32_PHASE_CUT rays) at (fast, unclipped) and (exact,
#: clipped): fast and exact, clip off and on, in two pairs
DF32_PHASE_PATH = ("hybrid achromat", "spectrograph", "kinoform")
DF32_PHASE_CUT = ("curved hybrid", "mirror grating", "bk7 grating",
                  "zone plate")
N_DF32_PHASE_CUT = 1 << 18
#: (kernel, cylinder, field, index) of the phase cylinders' central
#: differences (K5 of the K4 merit, K7 of the K6 union merit on the
#: cylinder's stack, K9 of the K8 wavefront RMS) and their relative
#: steps; grating_dy by K9 alone: it shifts the spot, so the spot RMS
#: moves by 3e-4 of it and its central difference is at the float64
#: sum's noise (6e-6 rel on the CPU at 2^11 rays)
PHASE_CYL_FD_PICKS = (("K5", "grating cylinder", "curvature_dx", 1),
                      ("K5", "doe cylinder", "doe", (1, 0)),
                      ("K7", "grating cylinder", "curvature_dx", (0, 1)),
                      ("K7", "doe cylinder", "doe", (0, 1, 0)),
                      ("K9", "grating cylinder", "grating_dy", 1),
                      ("K9", "doe cylinder", "curvature_dx", 1))
PHASE_CYL_FD_STEP = {"curvature_dx": 1e-6, "grating_dy": 1e-6, "doe": 1e-4}
#: the df32 phase plans timed against their phase-free twins' at
#: N_GRAD_TIME and N_BENCH rays
DF32_PHASE_TIMED = PHASE_TIMED


def phase_cylinder_system():
    """What the K8/K9 checks read of a system for a phase cylinder: the
    reference sphere's radius (its image plane 40 mm on), the
    wavelength, the scale."""
    from types import SimpleNamespace
    return SimpleNamespace(
        image=SimpleNamespace(pupil=SimpleNamespace(
            distance=-PHASE_CYL_OPD["radius"])),
        wavelengths=[PHASE_CYL_OPD["wavelength"]],
        scale=PHASE_CYL_OPD["scale"], object=SimpleNamespace(finite=False))


def phase_cylinder_table(name, phase=True, device=None):
    """A phase cylinder's table (phase False: its plain-cylinder twin,
    grating_dy and the DOE coefficients zero)."""
    from rayopt_tpu_torch.ops.tables import make_table
    kw = dict(mu=[1., 1/1.5, 1.], n_before=[1., 1., 1.5],
              n_after=[1., 1.5, 1.5], distance=[0., 5., 40.],
              radius=[np.inf, 12., np.inf])
    kw.update(PHASE_CYLINDERS[name])
    if not phase:
        kw.pop("grating_dy", None)
        kw.pop("doe", None)
    return make_table(**kw, device=device or DEVICE)


def phase_cylinder_stack(table):
    """Three tables of a phase cylinder (mu grown by 0, 1 and 2 % of mu
    - 1, grating_dy and the DOE coefficients by 0, 5 and 10 %: each
    wavelength's own phase words) on its device, and the specs they
    share."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    tabs = type(table)(*(None if f is None else torch.stack([f]*3)
                         for f in table))
    grow = torch.tensor([0., 1., 2.], dtype=torch.float64,
                        device=table.curvature.device)
    tabs = tabs.replace(
        mu=1 + (tabs.mu - 1)*(1 + .01*grow[:, None]),
        grating_dy=tabs.grating_dy*(1 + .05*grow[:, None]),
        doe=tabs.doe*(1 + .05*grow[:, None, None]))
    return tabs, multi_specs(tabs, None)


@functools.lru_cache(maxsize=None)
def phase_cylinders():
    """{name: (table on the card, specs, stack, stack specs, twin table,
    twin specs)} of PHASE_CYLINDERS (the twin: the plain cylinder)."""
    from rayopt_tpu_torch.ops.kernels import specialize
    out = {}
    for name in PHASE_CYLINDERS:
        table = phase_cylinder_table(name)
        twin = phase_cylinder_table(name, phase=False)
        tabs, mspecs = phase_cylinder_stack(table)
        out[name] = (table, specialize(table), tabs, mspecs, twin,
                     specialize(twin))
    return out


def cyl_grad_fields(opd=False, nd=0):
    """K5's and K7's (with `opd`, K9's) cotangent columns by table field
    on a phase cylinder's key: GRAD_FIELDS (K9: and n_before), the
    anamorphic key's curvature_dx and conic_dx, then grating_dy (nd 0)
    or (K9: n_after and) the nd DOE coefficients."""
    q = 7 if opd else 6
    out = (OPD_GRAD_FIELDS if opd else GRAD_FIELDS) + (
        ("curvature_dx", slice(q, q + 1)), ("conic_dx", slice(q + 1, q + 2)))
    q += 2
    if not nd:
        return out + (("grating_dy", slice(q, q + 1)),)
    if opd:
        out += (("n_after", slice(q, q + 1)),)
        q += 1
    return out + (("doe", slice(q, q + nd)),)


@functools.lru_cache(maxsize=None)
def df32_phase_cases():
    """{name: (table on the card, its three wavelength tables, bench
    bundle function, [(fast, clip), ...] held)} of the df32 phase
    checks: the six phase lenses (their System.tables, or 1, 0.9 and 1.1
    times a lens's one wavelength), the kinoform and the two phase
    cylinders (phase_cylinder_stack)."""
    from rayopt_tpu_torch.ops.tables import table_at
    path = [(True, False), (False, False), (False, True)]
    cut = [(True, False), (False, True)]
    out = {}
    lenses = dict(phase_lenses())
    ks = kinoform()
    lenses["kinoform"] = (ks, ks.table(), None, 3.)
    for name, (s, table, _, half) in lenses.items():
        tabs, _ = phase_stack(s)
        out[name] = (table, [table_at(tabs, li) for li in range(3)],
                     phase_bundle_of(half),
                     path if name in DF32_PHASE_PATH else cut)
    for name, (table, _, tabs, _, _, _) in phase_cylinders().items():
        out[name] = (table, [table_at(tabs, li) for li in range(3)],
                     phase_bundle_of(PHASE_CYL_HALF), cut)
    return out


def df32_phase_twin_plans(lens, fast):
    """((one plan, the three wavelength plans) of a timed phase lens,
    the same of its phase-free twin (phase_twin_system))."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    table, lam_tabs, _, _ = df32_phase_cases()[lens]
    tw = phase_twin_system(lens)
    ttabs = phase_stack(tw)[0]
    return ((D.plan(table, fast=fast),
             [D.plan(t, fast=fast) for t in lam_tabs]),
            (D.plan(tw.table(), fast=fast),
             [D.plan(table_at(ttabs, li), fast=fast) for li in range(3)]))


def df32_phase_keys():
    """{tag: key} of the df32 phase checks, paths and timings: each case
    of df32_phase_cases at its (fast, clip) pairs, K10 (with the path)
    and K12 on its plan, K11 (with the path) and K13 on its three
    wavelength plans (the hybrid's df32 path, the spectrograph's and the
    kinoform's among them); and the timed lenses' phase-free twins' plans,
    fast and exact."""
    from rayopt_tpu_torch.ops import df32 as D
    keys = {}
    for name, (table, lam_tabs, _, pairs) in df32_phase_cases().items():
        for fast, clip in pairs:
            keys.update(df32_quad(
                "%s %s clip=%s" % (name, "fast" if fast else "exact", clip),
                D.plan(table, clip=clip, fast=fast),
                [D.plan(t, clip=clip, fast=fast) for t in lam_tabs]))
    for lens in DF32_PHASE_TIMED:
        for fast in (True, False):
            keys.update(df32_quad(
                "%s twin %s" % (lens, "fast" if fast else "exact"),
                *df32_phase_twin_plans(lens, fast)[1]))
    return keys


def phase_cylinder_keys():
    """{tag: key} of the phase cylinders' K1-K9 checks and timings: K1,
    K2, K4, K5, K6, K7, K8 and K9 (the adjoints every field, with the
    ray cotangents) in float64 clip off and on and in float32 clip off,
    K3's two modes in both dtypes; the central differences' K5, K7 and
    K9 (one field each, float64); and the plain-cylinder twins' keys in
    float32 for the timings."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import doe_width, figure_widths
    f64, f32 = torch.float64, torch.float32
    keys = {}
    for name, (table, specs, tabs, mspecs, twin, tspecs) in \
            phase_cylinders().items():
        tag = name.replace(" ", "-")
        kw = dict(widths=figure_widths(table, specs),
                  nd=doe_width(table, specs))
        for dtype, clips in ((f64, (False, True)), (f32, (False,))):
            dt = str(dtype)[6:]
            for mode in ("merit", "trace"):
                keys["K3 %s %s %s" % (dt, tag, mode)] = CS.trace_multi_key(
                    mspecs, dtype, 3, mode == "merit", **kw)
            for clip in clips:
                sfx = "%s %s clip=%s" % (dt, tag, clip)
                keys["K1 " + sfx] = CS.trace_key(specs, dtype, clip, **kw)
                keys["K2 " + sfx] = CS.merit_key(specs, dtype, clip, **kw)
                keys["K4 " + sfx] = CS.moments_key(specs, dtype, clip, **kw)
                keys["K5 %s all rays=True" % sfx] = CS.adjoint_key(
                    specs, dtype, clip, **kw)
                keys["K6 " + sfx] = CS.moments_multi_key(mspecs, dtype,
                                                         clip, 3, **kw)
                keys["K7 %s all rays=True" % sfx] = CS.adjoint_multi_key(
                    mspecs, dtype, clip, **kw)
                keys["K8 " + sfx] = CS.opd_key(specs, dtype, clip, **kw)
                keys["K9 %s all rays=True" % sfx] = CS.opd_adjoint_key(
                    specs, dtype, clip, **kw)
        for kern, cyl, field, _ in PHASE_CYL_FD_PICKS:
            if cyl != name:
                continue
            make = {"K5": CS.adjoint_key, "K7": CS.adjoint_multi_key,
                    "K9": CS.opd_adjoint_key}[kern]
            keys["%s float64 %s fd %s rays=False" % (kern, tag, field)] = \
                make(mspecs if kern == "K7" else specs, f64, False,
                     (field,), False, **kw)
        tsfx = "float32 %s twin" % tag
        for mode in ("merit", "trace"):
            keys["K3 %s %s" % (tsfx, mode)] = CS.trace_multi_key(
                tspecs, f32, 3, mode == "merit")
        keys["K1 " + tsfx] = CS.trace_key(tspecs, f32)
        keys["K2 " + tsfx] = CS.merit_key(tspecs, f32)
        keys["K4 " + tsfx] = CS.moments_key(tspecs, f32)
        keys["K5 %s all rays=True" % tsfx] = CS.adjoint_key(tspecs, f32)
        keys["K6 " + tsfx] = CS.moments_multi_key(tspecs, f32, False, 3)
        keys["K7 %s all rays=True" % tsfx] = CS.adjoint_multi_key(tspecs,
                                                                 f32)
        keys["K8 " + tsfx] = CS.opd_key(tspecs, f32)
        keys["K9 %s all rays=True" % tsfx] = CS.opd_adjoint_key(tspecs, f32)
    return keys


def phase_df32_phase_check():
    """K10-K13 against their plain versions on the card on the phase
    plans (df32_phase_cases): the hybrid achromat, the spectrograph and
    the kinoform at N_CHECK bench rays, fast unclipped, exact unclipped
    and clipped (1.5x wide when clipped); the two phase cylinders at
    N_CHECK and the JAX package's four test lenses at N_DF32_PHASE_CUT
    rays, (fast, unclipped) and (exact, clipped); K10 and K11 with the
    optical path (a DOE's
    phase term), K11/K13 on the three wavelength plans.  The kernels
    round every float32 operation as the plain versions do: the words
    that differ are counted (0 expected)."""
    from rayopt_tpu_torch.ops import df32 as D
    worst = dict.fromkeys(DF32_NAMES, 0.)
    failures = []
    for name, (table, lam_tabs, bundle, pairs) in df32_phase_cases().items():
        n = N_DF32_PHASE_CUT if name in DF32_PHASE_CUT else N_CHECK
        log("== K10-K13 vs plain on the card: %s (phase plans), %d bench "
            "rays (1.5x wide when clipped), K11/K13 on its 3 wavelength "
            "plans, with the path, at %s" % (
                name, n, ", ".join("%s clip=%s" % (
                    "fast" if f else "exact", c) for f, c in pairs)))
        state64 = bundle(n, torch.float64, SEED)
        for fast, clip in pairs:
            state = df32_state(state64, 1.5 if clip else 1.)
            tag = "%s clip=%s %s plan" % (name, clip,
                                          "fast" if fast else "exact")
            df32_check_case(tag, D.plan(table, clip=clip, fast=fast),
                            [D.plan(t, clip=clip, fast=fast)
                             for t in lam_tabs],
                            state, n, worst, failures, (True,))
            del state
    if failures:
        raise AssertionError("df32 kernel disagrees with its plain version "
                             "on a phase plan: " + ", ".join(failures))
    return worst


def phase_cylinder_check():
    """K1-K9 on the two phase cylinders against their plain versions on
    the card at N_CHECK rays of their bench bundle (ray 0 the chief
    ray): K1, K2 (phase_check), K4, K5 (phase_grad_check, curvature_dx,
    conic_dx and the phase columns among K5's), K3, K6, K7
    (phase_multi_check on the cylinder's stack) and K8, K9
    (phase_opd_check) in float64 clip off and on (clipped on the bundle
    phase_clip_bundle widens past the aperture) and in float32 clip
    off; then K5, K7 and K9 against central differences
    (phase_cylinder_fd_check).  Returns the float32 errors."""
    from rayopt_tpu_torch.ops.cuda_trace import doe_width
    worst = {}

    def keep(errs):
        worst.update({k: max(v, worst.get(k, 0.)) for k, v in errs.items()})
    bundle = phase_bundle_of(PHASE_CYL_HALF)
    s = phase_cylinder_system()
    for name, (table, specs, tabs, mspecs, _, _) in \
            phase_cylinders().items():
        nd = doe_width(table, specs)
        lens = "phase cylinder (%s)" % name
        fields, ofields = cyl_grad_fields(False, nd), cyl_grad_fields(True,
                                                                      nd)
        # float32: grating_dy shifts the whole spot, so its K5 and K7
        # column is a residual of cancelling float32 terms: held against
        # the float64 plain version (phase_f32_column_check)
        f32_fields = tuple(f for f in fields if f[0] != "grating_dy")
        # clipped: on a bundle that reaches past the 12 mm aperture
        clipped = phase_clip_bundle(table, PHASE_CYL_HALF)
        for dtypes, bund, clips in (((torch.float64,), bundle, (False,)),
                                    ((torch.float64,), clipped, (True,)),
                                    ((torch.float32,), bundle, (False,))):
            kf = f32_fields if dtypes[0] == torch.float32 else fields
            if len(kf) < len(fields):
                log("%s float32: K5's and K7's grating_dy column is held "
                    "against the float64 plain version below" % lens)
            keep(phase_check(table, specs, lens, bund, clips, dtypes))
            keep(phase_grad_check(table, specs, lens, bund, clips, kf,
                                  dtypes))
            keep(phase_multi_check(tabs, mspecs, lens + ", its stack",
                                   bund, clips, kf, None, dtypes))
            keep(phase_opd_check(s, table, specs, lens, bund, clips,
                                 ofields, None, dtypes))
        for field, cols in fields:
            if field == "grating_dy":
                keep(phase_f32_column_check(table, specs, tabs, mspecs,
                                            lens, bundle, field, cols))
    phase_cylinder_fd_check()
    return worst


def column_mass(tb, sp, state, w, ct, field):
    """The sum over rays of |each ray's term| of a K5 (`tb` one table,
    `ct` (5,)) or K7 (a stack, `ct` (nlam, 5)) parameter column, float64:
    w (ct . d(1, x, y, x^2, y^2)/dp) at the image, p the `field` of each
    row where it is nonzero (central differences of the plain float64
    trace, step 1e-6 of the value); the largest over those rows."""
    from rayopt_tpu_torch.ops.cuda_trace import trace_final_reference
    from rayopt_tpu_torch.ops.tables import table_at
    multi = ct.dim() == 2
    tables = [table_at(tb, li) for li in range(ct.shape[0])] if multi \
        else [tb]
    cts = ct if multi else ct[None]
    rows = torch.nonzero(getattr(tables[0], field) != 0)[:, 0].tolist()
    mass = 0.
    for row in rows:
        total = 0.
        for one, c in zip(tables, cts):
            base = getattr(one, field)
            h = 1e-6*abs(float(base[row]))
            x, y = trace_final_reference(one, sp, state)[0][:2]
            side = []
            for sgn in (1., -1.):
                v = base.clone()
                v[row] += sgn*h
                side.append(trace_final_reference(one.replace(**{field: v}),
                                                  sp, state)[0][:2])
            dx = (side[0][0] - side[1][0])/(2*h)
            dy = (side[0][1] - side[1][1])/(2*h)
            term = w*(c[1]*dx + c[2]*dy + 2*c[3]*x*dx + 2*c[4]*y*dy)
            total += float(torch.nansum(term.abs()))
        mass = max(mass, total)
    return mass


def phase_f32_column_check(table, specs, tabs, mspecs, lens, bundle, field,
                           cols):
    """Float32 K5 and K7 (unclipped, every field, with the ray
    cotangents) at N_CHECK rays of `bundle`: the parameter column
    `field` (`cols`), a sum whose terms cancel, against the float64
    plain version on the same inputs (the float32 rays, weights and
    moment cotangent in float64), within F32_SUM_REL of the sum of
    |term| (column_mass), as K9's float32 sums are held; the plain
    float32 version's error is logged beside the kernel's.  Returns the
    kernels' float32 errors."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        merit_adjoint_reference, weighted_moments_multi_reference,
        weighted_moments_reference)
    state = bundle(N_CHECK, torch.float32, SEED)
    w = bench_weights(N_CHECK, torch.float32, SEED + 2)
    s64, w64 = tuple(c.double() for c in state), w.double()
    worst, failures = {}, []
    for name, kern, ref, moments, tb, sp in (
            ("merit_adjoint", merit_adjoint, merit_adjoint_reference,
             weighted_moments_reference, table, specs),
            ("merit_adjoint_multi", merit_adjoint_multi,
             merit_adjoint_multi_reference, weighted_moments_multi_reference,
             tabs, mspecs)):
        ct = rms_cotangent(moments(tb, sp, state, w))
        got = kern(tb, sp, state, w, ct)[0][..., cols].double()
        plain = ref(tb, sp, state, w, ct)[0][..., cols].double()
        want = ref(tb, sp, s64, w64, ct.double())[0][..., cols]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        perr = float((plain - want).abs().max())
        mass = column_mass(tb, sp, s64, w64, ct.double(), field)
        ok = bool(torch.isfinite(got).all()) and err <= F32_SUM_REL*mass
        worst[name] = err
        log("%s %s float32 %s column vs the float64 plain version: kernel "
            "err %.3e, plain float32 err %.3e, of max |column| %.3e and "
            "sum of |term| %.3e (limit %.3e) -> %s"
            % ("K5" if name == "merit_adjoint" else "K7", lens, field, err,
               perr, float(want.abs().max()), mass, F32_SUM_REL*mass,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError("float32 %s column disagrees with the float64 "
                             "plain version on the %s: %s"
                             % (field, lens, ", ".join(failures)))
    return worst


def phase_cylinder_fd_check():
    """Float64, N_CHECK bench rays, against central differences (steps
    PHASE_CYL_FD_STEP of the value): K5's gradient of the K4 merit (the
    spot RMS), K7's of the K6 merit (the union spot RMS of the
    cylinder's stack) and K9's of the K8 wavefront RMS (ray 0 the chief
    ray), w.r.t. curvature_dx (read by the normal of the biconic or
    toroid that made the cylinder), grating_dy and a DOE coefficient
    (PHASE_CYL_FD_PICKS)."""
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_wavefront_rms,
                                                polychromatic_spot_rms,
                                                spot_moments,
                                                weighted_moments)
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    cases = phase_cylinders()
    log("== K5, K7 and K9 on the phase cylinders vs central differences "
        "(float64, %d bench rays; relative steps %s)"
        % (N_CHECK, PHASE_CYL_FD_STEP))
    failures = []
    opd = dict(PHASE_CYL_OPD, ref=0, finite=False)
    for kern, name, field, idx in PHASE_CYL_FD_PICKS:
        table, specs, tabs, mspecs, _, _ = cases[name]
        state = phase_bundle_of(PHASE_CYL_HALF)(N_CHECK, torch.float64, SEED)
        w = bench_weights(N_CHECK, torch.float64, SEED + 2)
        y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
        if kern == "K5":
            tab, sp = table, specs

            def merit(tb, sp=sp):
                return spot_rms_from_moments(*spot_moments(
                    tb, state, w, specs=sp))

            def value(tb, sp=sp):
                return spot_rms_from_moments(*weighted_moments(
                    tb, sp, state, w))
        elif kern == "K7":
            tab, sp = tabs, mspecs

            def merit(tb, sp=sp):
                return polychromatic_spot_rms(tb, y0, u0, w, specs=sp)
            value = merit
        else:
            tab, sp = table, specs

            def merit(tb, sp=sp):
                return adjoint_wavefront_rms(tb, y0, u0, w, specs=sp, **opd)
            value = merit
        base = getattr(tab, field)
        v = base.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the baked rows, as intended
            merit(tab.replace(**{field: v})).backward()
        h = PHASE_CYL_FD_STEP[field]*abs(float(base[idx]))
        side = []
        with torch.no_grad():
            for sgn in (1., -1.):
                b = base.clone()
                b[idx] += sgn*h
                side.append(float(value(tab.replace(**{field: b}))))
        fd = (side[0] - side[1])/(2*h)
        g = float(v.grad[idx])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s, %s %s %s: kernel %.12g, central difference %.12g (step "
            "%.3g), rel %.2e -> %s" % (kern, name, field, idx, g, fd, h,
                                       rel, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s %s" % (kern, name, field))
    if failures:
        raise AssertionError("K5, K7 or K9 on a phase cylinder disagrees "
                             "with finite differences: "
                             + ", ".join(failures))


def phase_df32_phase_path(hyb_aimed):
    """The parity-grade df32 path on the phase rows, its launches counted
    from the caller's reset: the hybrid achromat's aimed bundles at
    fields 0, 0.7 and 1 (phase_hybrid_path's: K10's spot RMS on their
    first N_PHASE rays against the CPU float64 plain trace, its image
    positions against float64 K1 on the card; K11/K13 at the other two
    wavelengths; phase_df32_path); the spectrograph's bench bundle at its
    three wavelengths' plans, K10 (fast and exact) and K11 (one launch):
    the detector lines (ray 0's image height) against the JAX package's
    golden (LINES_REL), the image positions against float64 K1 at each
    table (DF32_F64_ATOL), K12's and K13's moments against K10's and
    K11's own output; the kinoform (the JAX package's
    test_doe_phase_enters_optical_path): K10's optical path with_path of
    8 rays up y to 2.5 mm and of the 3 mm bench bundle against the CPU
    float64 path (1e-10 mm, as the reference asserts)."""
    from rayopt_tpu_torch.models import hybrid_achromat, spectrograph
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_final)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final
    from rayopt_tpu_torch.ops.kernels import specialize
    phase_df32_path(hybrid_achromat(), hyb_aimed, "hybrid achromat")
    s = spectrograph()
    log("== df32 path: the spectrograph's %d bench rays through its three "
        "wavelengths' plans: K10 (fast and exact, with the path), K12; "
        "K11 (with the path), K13" % N_AIMED)
    failures = []
    state64 = phase_bundle_of(10.)(N_AIMED, torch.float64, SEED + 11)
    state = df32_state(state64)
    k1 = []
    for lam in s.wavelengths:
        table = s.table(lam)
        k1.append(torch.stack(trace_final(table, specialize(table),
                                          state64)[0][:2], 1))
    for fast in (True, False):
        plans = [D.plan(s.table(lam), fast=fast) for lam in s.wavelengths]
        t0 = time.perf_counter()
        multi = CD.trace_multi_df32(plans, state, with_path=True)
        moms = CD.trace_merit_multi_df32(plans, state)
        torch.cuda.synchronize()
        t_multi = time.perf_counter() - t0
        for li, (lam, want) in enumerate(zip(s.wavelengths,
                                             SPECTROGRAPH_LINES)):
            fin, _ = CD.trace_final_df32(plans[li], state, with_path=True)
            mom = CD.trace_merit_df32(plans[li], state)
            xy = torch.stack([D.to_f64(fin[0]), D.to_f64(fin[1])], 1)
            xy11 = torch.stack([D.to_f64(multi[li][0][0]),
                                D.to_f64(multi[li][0][1])], 1)
            line, line11 = float(xy[0, 1]), float(xy11[0, 1])
            good = torch.isfinite(k1[li][:, 0])
            masks = int((torch.isfinite(xy[:, 0]) != good).sum())
            pos = float((xy[good] - k1[li][good]).abs().max())
            same11 = bool(torch.equal(xy11[good], xy[good]))
            uz = D.to_f64(fin[5])[:, None].expand(-1, 3)
            rms10, _ = spot_rms(xy, uz)
            rms12 = float(spot_rms_from_moments(*mom))
            rms13 = float(spot_rms_from_moments(*moms[li]))
            rel_line = abs(line - want)/abs(want)
            rel11 = abs(line11 - want)/abs(want)
            # the moments of a 56-85 mm off-axis spot cancel (E[y^2] -
            # c^2): reported against K10's output, held to 1e-6
            rel12 = abs(rms12 - rms10)/rms10
            rel13 = abs(rms13 - rms10)/rms10
            ok = (rel_line <= LINES_REL and rel11 <= LINES_REL
                  and masks == 0 and pos <= DF32_F64_ATOL and same11
                  and rel12 <= 1e-6 and rel13 <= 1e-6)
            log("%s plan, %.0f nm: K10 line %.12f mm, K11 %.12f, golden "
                "%.12f (rel %.2e, %.2e) | image positions vs f64 K1 max "
                "%.3e mm, NaN masks differ on %d, K11 equal to K10 %s | spot "
                "RMS mm: K10 %.12g, K12 %.12g (rel %.2e), K13 %.12g (rel "
                "%.2e) | K11 + K13 card %.3f s -> %s"
                % ("fast" if fast else "exact", lam*1e9, line, line11, want,
                   rel_line, rel11, pos, masks, same11, rms10, rms12, rel12,
                   rms13, rel13, t_multi, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("spectrograph %s %.0f nm" % (
                    "fast" if fast else "exact", lam*1e9))
        del multi, moms
    del state, state64, k1
    ks = kinoform()
    table, cpu = ks.table(), ks.table(device="cpu")
    n = 8
    y = torch.zeros((n, 3), dtype=torch.float64)
    y[:, 1] = torch.linspace(0., 2.5, n, dtype=torch.float64)
    u = torch.zeros_like(y)
    u[:, 2] = 1.
    bench = phase_bundle_of(3.)(N_CHECK, torch.float64, SEED)
    yb = torch.stack(bench[:3], 1).cpu()
    ub = torch.stack(bench[3:], 1).cpu()
    for what, (yy, uu) in (("8 rays up y", (y, u)),
                           ("%d bench rays" % N_CHECK, (yb, ub))):
        _, _, t64 = trace_rays_final(cpu, yy, uu, biconic=True)
        for fast in (False, True):
            st = D.state_from_f64(yy.to(DEVICE), uu.to(DEVICE))
            _, path = CD.trace_final_df32(D.plan(table, fast=fast), st,
                                          with_path=True)
            got = D.to_f64(path).cpu()
            good = torch.isfinite(t64)
            masks = int((torch.isfinite(got) != good).sum())
            err = float((got[good] - t64[good]).abs().max())
            ok = masks == 0 and err <= 1e-10
            log("kinoform, %s, %s plan: K10 optical path vs CPU f64 max "
                "%.3e mm (the JAX package asserts 1e-10), NaN masks differ "
                "on %d -> %s" % (what, "exact" if not fast else "fast", err,
                                 masks, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("kinoform %s %s" % (what, fast))
    if failures:
        raise AssertionError("df32 phase path failed: " + ", ".join(failures))


#: the K1-K9 wrappers of the phase cylinders' timings, by kernel name
CYL_KERNELS = ("trace_final", "trace_merit", "weighted_moments",
               "merit_adjoint", "trace_multi", "trace_multi_trace",
               "weighted_moments_multi", "merit_adjoint_multi", "opd_chain",
               "opd_adjoint")


def cyl_calls(kname, table, specs, tabs, mspecs, state, w):
    """(kernel call, plain call) of one K1-K9 wrapper on a cylinder's
    table (its stack for K3, K6, K7) and bench state: the adjoints every
    field with the ray cotangents, for a fixed moment (K5, K7) or
    wavefront (K9) cotangent."""
    from rayopt_tpu_torch.ops import cuda_grad as CG
    from rayopt_tpu_torch.ops import cuda_trace as CT
    dtype, device = state[0].dtype, state[0].device
    ct = torch.tensor([.3, -.2, .5, 1., .7], dtype=dtype, device=device)
    ct3 = ct.expand(3, -1).contiguous()
    if kname in ("opd_chain", "opd_adjoint"):
        from rayopt_tpu_torch.ops.geometric import trace_rays_final
        y0 = torch.stack([c[:1] for c in state[:3]], 1).double()
        u0 = torch.stack([c[:1] for c in state[3:]], 1).double()
        yr, _, _ = trace_rays_final(table, y0, u0, specs=specs)
        aux = torch.cat([yr[0], torch.tensor(
            [PHASE_CYL_OPD["radius"],
             PHASE_CYL_OPD["wavelength"]/PHASE_CYL_OPD["scale"]],
            dtype=torch.float64, device=device)]).to(dtype)
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        cts = tuple(torch.randn(state[0].shape[0], generator=gen,
                                dtype=dtype, device=device)
                    for _ in range(3))
    return {
        "trace_final": (lambda: CT.trace_final(table, specs, state),
                        lambda: CT.trace_final_reference(table, specs,
                                                         state)),
        "trace_merit": (lambda: CT.trace_merit(table, specs, state),
                        lambda: CT.trace_merit_reference(table, specs,
                                                         state)),
        "weighted_moments": (
            lambda: CG.weighted_moments(table, specs, state, w),
            lambda: CG.weighted_moments_reference(table, specs, state, w)),
        "merit_adjoint": (
            lambda: CG.merit_adjoint(table, specs, state, w, ct),
            lambda: CG.merit_adjoint_reference(table, specs, state, w, ct)),
        "trace_multi": (
            lambda: CT.trace_multi(tabs, mspecs, state, merit=True),
            lambda: CT.trace_multi_reference(tabs, mspecs, state,
                                             merit=True)),
        "trace_multi_trace": (
            lambda: CT.trace_multi(tabs, mspecs, state),
            lambda: CT.trace_multi_reference(tabs, mspecs, state)),
        "weighted_moments_multi": (
            lambda: CG.weighted_moments_multi(tabs, mspecs, state, w),
            lambda: CG.weighted_moments_multi_reference(tabs, mspecs,
                                                        state, w)),
        "merit_adjoint_multi": (
            lambda: CG.merit_adjoint_multi(tabs, mspecs, state, w, ct3),
            lambda: CG.merit_adjoint_multi_reference(tabs, mspecs, state,
                                                     w, ct3)),
        "opd_chain": (lambda: CG.opd_chain(table, specs, state, aux),
                      lambda: CG.opd_chain_reference(table, specs, state,
                                                     aux)),
        "opd_adjoint": (
            lambda: CG.opd_adjoint(table, specs, state, aux, cts),
            lambda: CG.opd_adjoint_reference(table, specs, state, aux,
                                             cts))}[kname]


def phase_cylinder_path():
    """The phase cylinders' K1-K9 keys driven once, as a user calls
    them, the launch counts read by the caller from a reset just before:
    on each phase cylinder, float32, unclipped, N_CHECK bench rays (its
    stack for K3, K6 and K7), every wrapper of CYL_KERNELS as cyl_calls
    calls it (the adjoints every field, with the ray cotangents).
    Every output must be finite: the bench bundle lies inside the
    aperture, so every ray is live."""
    log("== phase cylinder path: K1-K9 on the two phase cylinders, "
        "float32, %d bench rays, one call of each wrapper" % N_CHECK)
    failures = []
    for name, (table, specs, tabs, mspecs, _, _) in \
            phase_cylinders().items():
        state = phase_bundle_of(PHASE_CYL_HALF)(N_CHECK, torch.float32,
                                                SEED + 4)
        w = bench_weights(N_CHECK, torch.float32, SEED + 5)
        finite = {}
        for kname in CYL_KERNELS:
            out = cyl_calls(kname, table, specs, tabs, mspecs, state, w)[0]()
            flat = []
            todo = [out]
            while todo:
                o = todo.pop()
                if isinstance(o, torch.Tensor):
                    flat.append(o)
                elif o is not None:
                    todo.extend(o)
            finite[kname] = all(bool(torch.isfinite(o).all()) for o in flat)
        torch.cuda.synchronize()
        ok = all(finite.values())
        log("%s: every output finite %s -> %s"
            % (name, finite, "ok" if ok else "FAIL"))
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError("phase cylinder path failed: "
                             + ", ".join(failures))


def phase_cylinder_throughput(card):
    """K1-K9 on the phase cylinders' float32 keys (CYL_KERNELS, unclipped;
    the adjoints every field, with the ray cotangents) against their
    plain versions at N_GRAD_TIME bench rays and against the
    plain-cylinder twins' keys at N_GRAD_TIME and N_BENCH, in turns in
    one call (in_turns).  Returns {(kernel, cylinder, n): (ms, twin ms,
    plain ms or NaN)} and {(cylinder, n): live rays}."""
    from rayopt_tpu_torch.ops.cuda_trace import trace_merit
    log("== K1-K9 on the phase cylinders (float32) against their plain "
        "versions at %d rays and their plain-cylinder twins' keys at %d "
        "and %d rays, in turns (%s)" % (N_GRAD_TIME, N_GRAD_TIME, N_BENCH,
                                        card))
    times, live = {}, {}
    for name, (table, specs, tabs, mspecs, twin, tspecs) in \
            phase_cylinders().items():
        ttabs, tmspecs = phase_cylinder_stack(twin)
        for n in (N_GRAD_TIME, N_BENCH):
            big = n == N_BENCH
            state = phase_bundle_of(PHASE_CYL_HALF)(n, torch.float32,
                                                    SEED + 1)
            w = bench_weights(n, torch.float32, SEED + 2)
            live[(name, n)] = float(trace_merit(table, specs, state)[0])
            for kname in CYL_KERNELS:
                kern, plain = cyl_calls(kname, table, specs, tabs, mspecs,
                                        state, w)
                tw, _ = cyl_calls(kname, twin, tspecs, ttabs, tmspecs,
                                  state, w)
                (k, p, t), (k1, k2, p1, p2, t1, t2) = in_turns(
                    kern, None if big else plain, tw, 5 if big else 10, 1)
                times[(kname, name, n)] = (k, t, p)
                log("%s %s float32 at %d rays: kernel %.4f ms (%.4f, %.4f)"
                    "%s%s | %s"
                    % (kname, name, n, k, k1, k2,
                       twin_note(k, t, t1, t2, "plain-cylinder twin"),
                       "" if big else " | plain %.4f ms (%.4f, %.4f), "
                       "plain/kernel %.2fx" % (p, p1, p2, p/k), card))
            del state, w
            torch.cuda.empty_cache()
    return times, live


DF32_PHASE_SHORT = {"hybrid achromat": "hybrid", "spectrograph":
                    "spectrograph"}


def df32_phase_entries(launches, worst, times, live, ptxas, sass):
    """The kernels line's entries of K10-K13 on the phase plans (named
    "<kernel>_phase"): the phase df32 path's launches (counted from a
    reset just before it), the errors of phase_df32_phase_check, the
    times of phase_df32_phase_throughput (the hybrid's fast plan at
    N_GRAD_TIME rays as `ms`, its plain version's as `plain_ms`, the rest
    under the lens's short name, exact under "_exact", N_BENCH under
    "_<n>_rays"), each beside its phase-free twin's and its bound
    (df32_bound: df32_step_ops counts the phase step's operations), and
    the hybrid's and spectrograph's path keys' registers and SASS."""
    entries = []
    for kname in DF32_NAMES:
        multi = "multi" in kname
        entry = {"name": kname + "_phase", "route": "cuda",
                 "source": "rayopt_tpu_torch/csrc/df32_spec.cuh",
                 "replaces": DF32_REPLACES[kname],
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_GRAD_TIME,
                 "wavelengths": 3 if multi else 1}
        for lens in DF32_PHASE_TIMED:
            short = DF32_PHASE_SHORT[lens]
            for fast in (True, False):
                plan = "fast" if fast else "exact"
                phase, twin = df32_phase_twin_plans(lens, fast)
                pl = phase[1] if multi else [phase[0]]
                tpl = twin[1] if multi else [twin[0]]
                for n in (N_GRAD_TIME, N_BENCH):
                    k, t, p = times[(kname, lens, plan, n)]
                    nl = live[(lens, n)]*len(pl)
                    b, by = df32_bound(kname, n, pl, nl)
                    at = "%s%s%s" % ("" if lens == DF32_PHASE_TIMED[0]
                                     else short + "_",
                                     "" if fast else "exact_",
                                     "" if n == N_GRAD_TIME
                                     else "%d_rays_" % n)
                    entry.update({at + "ms": k, at + "twin_ms": t,
                                  at + "bound_ms": b,
                                  at + "twin_bound_ms": df32_bound(
                                      kname, n, tpl, nl)[0]})
                    if p == p:
                        entry[at + "plain_ms"] = p
                    if at == "":
                        entry["bound_by"] = by
            key = "%s %s fast clip=False%s" % (
                DF32_LOOP_KEYS[kname][:3], lens,
                " path=True" if "merit" not in kname else "")
            regs, stack, spill = ptxas[key]
            entry.update({"regs_f32_" + short: regs,
                          "spill_bytes_f32_" + short: spill,
                          "sass_instructions_" + short: sass[key][0]})
        entries.append(entry)
    return entries


def cylinder_entries(sources, launches, worst, times, live, ptxas):
    """The kernels line's entries of K1-K9 on the phase cylinders'
    float32 keys (named "<kernel>_phase_cylinder"): the launches of
    phase_cylinder_path (counted from a reset just before it; K3's two
    modes share its count), the float32 errors of
    phase_cylinder_check, the times of
    phase_cylinder_throughput (the grating cylinder's at N_GRAD_TIME as
    `ms`/`plain_ms`, the DOE cylinder's under "doe_", N_BENCH under
    "_<n>_rays") beside the plain-cylinder twins' and the bounds
    (kernel_bound: phase_row_flops counts a phase cylinder's row), and
    the keys' registers, stack and spills."""
    from rayopt_tpu_torch.ops.cuda_trace import doe_width, figure_widths
    cases = phase_cylinders()
    tags = {"trace_final": "K1 float32 %s clip=False",
            "trace_merit": "K2 float32 %s clip=False",
            "weighted_moments": "K4 float32 %s clip=False",
            "merit_adjoint": "K5 float32 %s clip=False all rays=True",
            "trace_multi": "K3 float32 %s merit",
            "trace_multi_trace": "K3 float32 %s trace",
            "weighted_moments_multi": "K6 float32 %s clip=False",
            "merit_adjoint_multi": "K7 float32 %s clip=False all rays=True",
            "opd_chain": "K8 float32 %s clip=False",
            "opd_adjoint": "K9 float32 %s clip=False all rays=True"}
    entries = []
    for kname in CYL_KERNELS:
        base = "trace_multi" if kname == "trace_multi_trace" else kname
        source, replaces = sources[base]
        entry = {"name": kname + "_phase_cylinder", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[base],
                 "max_abs_err": worst.get(base, 0.),
                 "library_ms": None, "rays": N_GRAD_TIME,
                 "wavelengths": 3 if "multi" in kname else 1}
        for name, (table, specs, _, mspecs, _, tspecs) in cases.items():
            pre = "" if name == "grating cylinder" else "doe_"
            multi = "multi" in kname
            sp = mspecs if multi else specs
            kw = dict(widths=figure_widths(table, specs),
                      nd=doe_width(table, specs))
            for n in (N_GRAD_TIME, N_BENCH):
                k, t, p = times[(kname, name, n)]
                nl = live[(name, n)]*(3 if multi else 1)
                b, by = kernel_bound(kname, n, torch.float32, sp,
                                     3 if multi else 1, nl, **kw)
                at = pre + ("" if n == N_GRAD_TIME else "%d_rays_" % n)
                entry.update({at + "ms": k, at + "twin_ms": t,
                              at + "bound_ms": b,
                              at + "twin_bound_ms": kernel_bound(
                                  kname, n, torch.float32, tspecs,
                                  3 if multi else 1, nl)[0]})
                if p == p:
                    entry[at + "plain_ms"] = p
                if at == "":
                    entry["bound_by"] = by
            regs, stack, spill = ptxas[tags[kname] % name.replace(" ", "-")]
            entry.update({pre + "regs_f32": regs,
                          pre + "stack_bytes_f32": stack,
                          pre + "spill_bytes_f32": spill})
        entries.append(entry)
    return entries


# -- the freeform XY rows ----------------------------------------------------

#: the freeform designer loop: Adam on the normalized XY coefficients
#: (optimize_grad's scales, freeform_scales), at the JAX package's
#: test_optimize_grad_xy_poly_scales rate
FF_LR = 2e-4
FF_SELECT = ("xy_poly",)
#: the freeform lens timed against its freeform-free twin
FF_TIMED = "schmidt corrector"
#: the CPU float64 check's rays of each forward-path bundle (its first)
N_FF_REF = 1 << 18
#: K5 vs central differences: a relative step of the XY singlet's
#: quadratic terms, and mm of sag at the norm radius of the Schmidt
#: plate's x^4 term (its value is the 1e-10 seed)
FF_FD_REL_STEP = 1e-6
FF_FD_SAG = 1e-6
FF_FD_PICKS = (("xy singlet", 2), ("xy singlet", 3), ("xy singlet", 4),
               ("schmidt corrector", 9))
#: K1's freeform key vs the biconic key on the quadratic pair, of scale
FF_TWIN_REL = 1e-13
#: a figured Schmidt plate (normalized coefficients, mm of sag at R): the
#: x^2/y^2 and x^4/x^2y^2/y^4 terms of a Schmidt profile, and small
#: asymmetric terms
SCHMIDT_FIGURE = [0., 0., -.02, .001, -.021, 0., 1e-4, 0., -2e-4, .012, 0.,
                  .024, 1e-4, .0118]


def schmidt_corrector(coefficients=None):
    """The JAX package's freeform Schmidt corrector
    (tests/test_freeform.py test_freeform_corrector_design): a degree-4
    xypoly plate (14 terms seeded at 1e-10: an exactly-zero row is baked
    out of the specialization; norm radius 25 mm, N-BK7) 5 mm ahead of
    an f/2 R = -200 mm mirror, a 25 mm pupil, on axis; `coefficients`
    replaces the seed (coefficients=[]: the freeform-free twin)."""
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


def zernike_corrector():
    """The JAX package's Zernike corrector (tests/test_freeform.py
    _zernike_system): Z11 = 0.002 at a 10 mm norm radius on an N-BK7
    plate, an R = -100 mirror fold."""
    from rayopt_tpu_torch import System
    s = System([
        dict(material="air"),
        dict(type="zernike", zernike_coefficients=[0.]*10 + [.002],
             norm_radius=10., distance=5., material="SCHOTT-BK|N-BK7",
             radius=10.),
        dict(distance=3., material="air", radius=10.),
        dict(roc=-100., distance=50., material="mirror", radius=12.),
        dict(distance=-48., radius=5.)])
    s.object.pupil.radius = 8.
    s.object.pupil.update_radius = False
    s.update()
    return s


def xy_singlet():
    """The JAX package's quadratic XY singlet (tests/test_freeform.py
    _xysystem): a degree-2 figure with an xy cross term."""
    from rayopt_tpu_torch import System
    s = System([
        dict(material="air"),
        dict(type="xypoly", xy_coefficients=[0, 0, .25, .02, .4],
             norm_radius=5., distance=5., material="SCHOTT-BK|N-BK7",
             radius=4.),
        dict(distance=3., material="air", radius=4.),
        dict(distance=40., radius=5.)])
    s.object.pupil.radius = 2.
    s.object.pupil.update_radius = False
    s.update()
    return s


def freeform_tables():
    """make_table keyword arguments of the table lenses (the freeform row
    is row 1): the JAX package's quadratic freeform singlet
    (_freeform_table) and its biconic paraboloid twin, a freeform on a
    curved conic base with an even aspheric term, a freeform on a
    grating row."""
    cx, cy = 1/80., 1/50.
    rows = dict(distance=[0., 10., 3., 40.], n_before=[1., 1., 1.5, 1.],
                n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.])
    return {
        "quadratic freeform": dict(
            rows, curvature=[0.]*4,
            xy_poly=[[0.]*5, [0., 0., cx/2, 0., cy/2], [0.]*5, [0.]*5]),
        "biconic paraboloid": dict(
            rows, curvature=[0., cy, 0., 0.], conic=[0., -1., 0., 0.],
            curvature_dx=[0., cx - cy, 0., 0.]),
        "aspheric base": dict(
            curvature=[0., 1/60., -1/80., 0.], conic=[0., -.6, 0., 0.],
            aspherics=[[0., 0.], [2e-6, -3e-9], [0., 0.], [0., 0.]],
            xy_poly=[[0.]*9, [1e-4, -2e-4, 3e-3, 1e-3, -2e-3, 2e-5, -1e-5,
                              3e-5, 1e-5], [0.]*9, [0.]*9],
            distance=[0., 10., 4., 40.], n_before=[1., 1., 1.5, 1.],
            n_after=[1., 1.5, 1., 1.], mu=[1., 1/1.5, 1.5, 1.],
            radius=[np.inf, 9., 9., 20.]),
        "freeform grating": dict(
            rows, curvature=[0., 1/70., 0., 0.], grating_dy=[0., .08, 0., 0.],
            xy_poly=[[0.]*5, [0., 0., 2e-3, -1e-3, 1.5e-3], [0.]*5, [0.]*5],
            radius=[np.inf, 9., 9., 20.])}


def freeform_lenses():
    """{name: (system or None, table on the card, specs, bench half
    width)} of the freeform lenses: the Schmidt corrector (seeded, as
    its designer loop runs it, and figured), the Zernike corrector, the
    quadratic XY singlet and three table lenses (freeform_tables: the
    quadratic freeform singlet, a freeform on an aspheric base and on a
    grating row)."""
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops.tables import make_table
    builds = {"schmidt corrector": (schmidt_corrector, 17.),
              "figured schmidt": (lambda: schmidt_corrector(SCHMIDT_FIGURE),
                                  17.),
              "zernike corrector": (zernike_corrector, 7.),
              "xy singlet": (xy_singlet, 2.5)}
    out = {}
    for name, (build, half) in builds.items():
        s = build()
        table = s.table()
        out[name] = (s, table, specialize(table), half)
    for name, kw in freeform_tables().items():
        if name == "biconic paraboloid":
            continue
        table = make_table(**kw)
        out[name] = (None, table, specialize(table), 5.)
    return out


def freeform_bundle_of(half, slope=.03):
    """The freeform checks' bench bundle: x, y uniform in +-half mm and
    direction slopes uniform in +-slope (0: collimated on the axis, as
    the Schmidt corrector's loop runs; its mu column then vanishes
    through the nearly flat plate, COLUMN_FLOOR), ray 0 on the axis."""
    def bundle(n, dtype, seed, widen=1.):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        c = torch.empty((4, n), dtype=torch.float64, device=DEVICE)
        c[:2].uniform_(-half*widen, half*widen, generator=gen)
        c[2:].uniform_(-slope, slope, generator=gen)
        c[:, 0] = 0.
        uz = torch.sqrt(1 - c[2]*c[2] - c[3]*c[3])
        return tuple(v.to(dtype).contiguous() for v in (
            c[0], c[1], torch.zeros_like(uz), c[2], c[3], uz))
    return bundle


def freeform_grad_fields(table, specs):
    """K5's cotangent columns by table field on a freeform key:
    GRAD_FIELDS, the table's aspheric coefficients (read by the freeform
    row), grating_dy where a row is a grating, then the XY coefficients
    (xy_width), last."""
    from rayopt_tpu_torch.ops.cuda_trace import (carries_grating,
                                                 figure_widths, xy_width)
    q = 6
    out = GRAD_FIELDS
    for f, w in zip(("aspherics", "aspherics_odd"),
                    figure_widths(table, specs)):
        if w:
            out += ((f, slice(q, q + w)),)
            q += w
    if carries_grating(specs):
        out += (("grating_dy", slice(q, q + 1)),)
        q += 1
    return out + (("xy_poly", slice(q, q + xy_width(table, specs))),)


def freeform_twin():
    """The Schmidt corrector's freeform-free twin (the plate with
    `xy_coefficients: []`): (table on the card, specs)."""
    from rayopt_tpu_torch.ops.kernels import specialize
    table = schmidt_corrector([]).table()
    return table, specialize(table)


def freeform_keys():
    """{tag: key} of the freeform keys this script runs: K1, K2, K4 and
    K5 (every field, with the ray cotangents) in float64, unclipped, on
    every freeform lens, and on the Schmidt correctors also float32
    unclipped and float64 clipped; the Schmidt corrector's loop K5
    (xy_poly, no ray cotangents) in both dtypes, its freeform-free
    twin's keys (K1, K2, K4, K5 every field and OPT_FIELDS) in both
    dtypes, the finite-difference checks' float64 K5 (xy_poly), the
    biconic twin of the quadratic freeform's K1 and the forward path's
    keys at each of the Schmidt corrector's and the Zernike corrector's
    wavelengths."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops.tables import make_table
    f64, f32 = torch.float64, torch.float32
    keys = {}

    def kw(table, specs):
        return dict(widths=figure_widths(table, specs),
                    nd=doe_width(table, specs), nxy=xy_width(table, specs))
    for name, (s, table, specs, _) in freeform_lenses().items():
        tag = name.replace(" ", "-")
        schmidt = name.endswith("schmidt") or name == FF_TIMED
        runs = [(f64, False)] + ([(f32, False), (f64, True)] if schmidt
                                 else [])
        for dtype, clip in runs:
            sfx = "%s %s clip=%s" % (str(dtype)[6:], tag, clip)
            keys["K1 " + sfx] = CS.trace_key(specs, dtype, clip,
                                             **kw(table, specs))
            keys["K2 " + sfx] = CS.merit_key(specs, dtype, clip,
                                             **kw(table, specs))
            keys["K4 " + sfx] = CS.moments_key(specs, dtype, clip,
                                               **kw(table, specs))
            keys["K5 %s all rays=True" % sfx] = CS.adjoint_key(
                specs, dtype, clip, **kw(table, specs))
        for lens, _ in FF_FD_PICKS:
            if lens == name:
                keys["K5 float64 %s fd xy_poly rays=False" % tag] = \
                    CS.adjoint_key(specs, f64, fields=FF_SELECT, rays=False,
                                   **kw(table, specs))
        if s is not None and name in (FF_TIMED, "zernike corrector"):
            # the forward path: each wavelength's table (its specs)
            for li, lam in enumerate(s.wavelengths):
                t = s.table(lam)
                sp = specialize(t)
                for dtype in (f64, f32):
                    dt = str(dtype)[6:]
                    keys["K1 %s %s path %d" % (dt, tag, li)] = CS.trace_key(
                        sp, dtype, **kw(t, sp))
                    keys["K2 %s %s path %d" % (dt, tag, li)] = CS.merit_key(
                        sp, dtype, **kw(t, sp))
        if name == FF_TIMED:
            twin, tspecs = freeform_twin()
            for dtype in (f32, f64):
                dt = str(dtype)[6:]
                keys["K5 %s %s designer rays=False" % (dt, tag)] = \
                    CS.adjoint_key(specs, dtype, fields=FF_SELECT,
                                   rays=False, **kw(table, specs))
                tsfx = "%s %s twin" % (dt, tag)
                keys["K1 " + tsfx] = CS.trace_key(tspecs, dtype)
                keys["K2 " + tsfx] = CS.merit_key(tspecs, dtype)
                keys["K4 " + tsfx] = CS.moments_key(tspecs, dtype)
                keys["K5 %s all rays=True" % tsfx] = CS.adjoint_key(tspecs,
                                                                    dtype)
                keys["K5 %s designer rays=False" % tsfx] = CS.adjoint_key(
                    tspecs, dtype, fields=OPT_FIELDS, rays=False)
    bt = make_table(**freeform_tables()["biconic paraboloid"])
    keys["K1 float64 biconic-paraboloid clip=False"] = CS.trace_key(
        specialize(bt), f64)
    return keys


def phase_freeform_check():
    """K1, K2, K4 and K5 (every field, with the ray cotangents) on every
    freeform lens against their plain versions on the card at N_CHECK
    rays of the lens's bench bundle (freeform_bundle_of): float64
    unclipped
    on each (F64_REL of scale for K1 and K2, GRAD_F64_REL of a column's
    largest for K5, its XY columns among them); on the Schmidt correctors
    also float32 unclipped and float64 clipped on the bundle 1.5x wide,
    and K4/K5 float64 unclipped on the collimated bundle.
    Then K1's freeform key against the biconic key on the quadratic pair
    (FF_TWIN_REL) and K5's float64 gradient against central differences
    (phase_freeform_fd_check).  The bundle: freeform_bundle_of, slopes
    within +-0.03.  Returns the float32 errors."""
    worst = {}

    def keep(errs):
        worst.update({k: max(v, worst.get(k, 0.)) for k, v in errs.items()})
    f64 = (torch.float64,)
    for lens, (s, table, specs, half) in freeform_lenses().items():
        bundle = freeform_bundle_of(half)
        fields = freeform_grad_fields(table, specs)
        schmidt = lens.endswith("schmidt") or lens == FF_TIMED
        dtypes = (torch.float32, torch.float64) if schmidt else f64
        keep(phase_check(table, specs, lens, bundle, (False,), dtypes))
        keep(phase_grad_check(table, specs, lens, bundle, (False,), fields,
                              dtypes))
        if schmidt:
            wide = functools.partial(bundle, widen=1.5)
            phase_check(table, specs, lens, wide, (True,), f64)
            phase_grad_check(table, specs, lens, wide, (True,), fields, f64)
            phase_grad_check(table, specs, lens + ", collimated",
                             freeform_bundle_of(half, 0.), (False,), fields,
                             f64)
    freeform_twin_check()
    phase_freeform_fd_check()
    return worst


def freeform_twin_check():
    """K1's freeform key on the quadratic freeform singlet against K1's
    biconic key on its biconic paraboloid twin (a quadratic freeform IS
    that biconic: the JAX package's exactness oracle), float64, N_CHECK
    rays of the bench bundle, each output within FF_TWIN_REL of its
    scale, equal NaN masks."""
    from rayopt_tpu_torch.ops.cuda_trace import trace_final
    from rayopt_tpu_torch.ops.kernels import specialize
    from rayopt_tpu_torch.ops.tables import make_table
    log("== K1's freeform key vs its biconic key on the quadratic pair "
        "(float64, %d rays)" % N_CHECK)
    kws = freeform_tables()
    state = phase_bundle_of(5.)(N_CHECK, torch.float64, SEED)
    out = []
    for name in ("quadratic freeform", "biconic paraboloid"):
        table = make_table(**kws[name])
        specs = specialize(table)
        out.append(trace_final(table, specs, state))
    torch.cuda.synchronize()
    masks, rel = 0, 0.
    for a, b in zip((*out[0][0], out[0][1]), (*out[1][0], out[1][1])):
        masks = max(masks, int((torch.isnan(a) != torch.isnan(b)).sum()))
        live = ~(torch.isnan(a) | torch.isnan(b))
        scale = max(float(b[live].abs().max()), 1.)
        rel = max(rel, float((a[live] - b[live]).abs().max())/scale)
    ok = masks == 0 and rel <= FF_TWIN_REL
    log("K1 freeform key vs biconic key: max rel err %.3e, NaN masks differ "
        "on %d rays -> %s" % (rel, masks, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("K1's freeform key disagrees with the biconic "
                             "key on the quadratic pair")


def phase_freeform_fd_check():
    """K5's float64 gradient of the K4 merit (the spot RMS of N_CHECK
    bench rays) in xy_poly against central differences: the XY
    singlet's x^2, xy and y^2 terms (a relative step FF_FD_REL_STEP) and
    the seeded Schmidt plate's x^4 term (FF_FD_SAG mm of sag at its norm
    radius)."""
    from rayopt_tpu_torch.ops.cuda_grad import spot_moments, weighted_moments
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    cases = freeform_lenses()
    log("== K5 on the freeform lenses vs central differences of the K4 "
        "merit (float64, %d bench rays)" % N_CHECK)
    failures = []
    for lens, idx in FF_FD_PICKS:
        _, table, specs, half = cases[lens]
        state = phase_bundle_of(half)(N_CHECK, torch.float64, SEED)
        w = bench_weights(N_CHECK, torch.float64, SEED + 2)
        v = table.xy_poly.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # the baked rows, as intended
            mom = spot_moments(table.replace(xy_poly=v), state, w,
                               specs=specs)
        spot_rms_from_moments(*mom).backward()

        def merit(tab):
            return float(spot_rms_from_moments(*weighted_moments(
                tab, specs, state, w)))
        value = float(table.xy_poly[1, idx])
        h = (FF_FD_SAG/25.**4 if lens == "schmidt corrector"
             else FF_FD_REL_STEP*abs(value))
        side = []
        for sgn in (1., -1.):
            b = table.xy_poly.clone()
            b[1, idx] += sgn*h
            side.append(merit(table.replace(xy_poly=b)))
        fd = (side[0] - side[1])/(2*h)
        g = float(v.grad[1, idx])
        rel = abs(g - fd)/abs(fd)
        ok = rel <= FD_REL
        log("%s, xy_poly[1, %d] (value %.6g): K5 %.12g, central difference "
            "%.12g (step %.3g), rel %.2e -> %s"
            % (lens, idx, value, g, fd, h, rel, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s xy_poly %d" % (lens, idx))
    if failures:
        raise AssertionError("K5 on the freeform lenses disagrees with "
                             "finite differences: " + ", ".join(failures))


def freeform_forward(s, title, n, n_ref):
    """One freeform lens's forward path at field 0: at each of its
    wavelengths, n rays aimed by the host into the pupil (uniform on the
    disc), float64 K1 (trace_rays_final_fast, precision "parity") and K2,
    float32 K1 and K2, and the spot RMS of float64 K1's output on the
    first n_ref rays against the CPU float64 plain trace (the generic
    walk, PARITY_REL, equal NaN masks).  Returns the failures and the
    first wavelength's aimed bundle with its float64 K1 image and the
    CPU's spot RMS and live rays (phase_df32_path's `aimed`)."""
    from rayopt_tpu_torch.ops.cuda_trace import (spot_rms_from_moments,
                                                 trace_merit)
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_fast
    from rayopt_tpu_torch.ops.kernels import specialize
    log("== %s forward path: field 0, %d aimed rays at each of its %d "
        "wavelengths, no clip" % (title, n, len(s.wavelengths)))
    rng = np.random.RandomState(SEED + 11)
    failures = []
    for lam in s.wavelengths:
        table = s.table(lam)
        table_cpu = s.table(lam, device="cpu")
        specs = specialize(table)
        t0 = time.perf_counter()
        zf, pf = s.pupil((0., 0.), l=lam)
        r = np.sqrt(rng.uniform(0, 1, n))
        th = rng.uniform(0, 2*np.pi, n)
        yp = np.stack([r*np.cos(th), r*np.sin(th)], 1)
        y0, u0 = s.aim((0., 0.), yp, zf, pf, filter=False)
        t_aim = time.perf_counter() - t0
        yc, uc = (torch.from_numpy(v).to(DEVICE) for v in (y0, u0))
        t0 = time.perf_counter()
        y64, u64, _ = trace_rays_final_fast(table, yc, uc, specs=specs,
                                            precision="parity")
        rms_k1, live = spot_rms(y64, u64)
        state64 = tuple(c.contiguous() for c in (*yc.T, *uc.T))
        rms_k2 = float(spot_rms_from_moments(*trace_merit(table, specs,
                                                          state64)))
        y32, u32, _ = trace_rays_final_fast(table, yc.float(), uc.float(),
                                            specs=specs)
        rms_k1_32, _ = spot_rms(y32, u32)
        rms_k2_32 = float(spot_rms_from_moments(*trace_merit(
            table, specs, tuple(c.float() for c in state64))))
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        rms_sub, live_sub = spot_rms(y64[:n_ref], u64[:n_ref])
        t0 = time.perf_counter()
        yh, uh, _ = trace_rays_final_fast(table_cpu, yc[:n_ref].cpu(),
                                          uc[:n_ref].cpu())
        rms_cpu, live_cpu = spot_rms(yh, uh)
        t_cpu = time.perf_counter() - t0
        masks = int((torch.isnan(y64[:n_ref, 0].cpu())
                     != torch.isnan(yh[:, 0])).sum())
        rel1 = abs(rms_sub - rms_cpu)/rms_cpu
        ok = (np.isfinite(rms_k1) and np.isfinite(rms_k2) and masks == 0
              and live_sub == live_cpu and rel1 <= PARITY_REL
              and abs(rms_k2 - rms_k1)/rms_k1 <= 1e-9)
        log("%.1f nm: pupil z %.6f, %d of %d rays live | spot RMS mm: K1 f64 "
            "%.12g | K2 f64 %.12g | K1 f32 %.9g (rel %.2e) | K2 f32 %.9g "
            "(rel %.2e) | the first %d rays: K1 f64 %.12g vs CPU f64 %.12g "
            "(rel %.2e), NaN masks differ on %d | aim %.2f s, card %.2f s, "
            "CPU %.2f s -> %s"
            % (lam*1e9, zf, live, n, rms_k1, rms_k2, rms_k1_32,
               abs(rms_k1_32 - rms_k1)/rms_k1, rms_k2_32,
               abs(rms_k2_32 - rms_k1)/rms_k1, n_ref, rms_sub, rms_cpu,
               rel1, masks, t_aim, t_gpu, t_cpu, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %.1f nm" % (title, lam*1e9))
        if lam == s.wavelengths[0]:
            aimed = [dict(field=0., y=yc, u=uc, y64=y64, rms_cpu=rms_cpu,
                          live_cpu=live_cpu, n_ref=n_ref)]
        del yc, uc, y64, u64, y32, u32, state64
    torch.cuda.empty_cache()
    return failures, aimed


def phase_freeform_path(opt_step):
    """The freeform main path through the entry points a user calls:
    the Schmidt corrector's forward path (freeform_forward: N_AIMED rays
    at field 0 and each of its 3 wavelengths, the CPU check on the first
    N_FF_REF), the Zernike corrector's (N_AIMED_LENS rays a wavelength),
    then the Schmidt corrector's designer loop (designer_loop: field 0 x
    3 wavelengths, hexapolar nrays N_OPT, float64, OPT_STEPS Adam steps
    at FF_LR over xy_poly with freeform_scales; step 0 against the CPU at
    N_LOOP_CHECK nrays a bundle), its later steps logged beside the
    double Gauss's (`opt_step` seconds).  Returns the path's launches
    (the forward part's, counted from the caller's reset, and the
    loop's), the loop's later-step seconds and the two correctors'
    aimed bundles ({lens: freeform_forward's aimed}, the df32 path's)."""
    from rayopt_tpu_torch.parallel import freeform_scales
    failures, schmidt = freeform_forward(schmidt_corrector(),
                                         "Schmidt corrector", N_AIMED,
                                         N_FF_REF)
    more, zernike = freeform_forward(zernike_corrector(),
                                     "Zernike corrector", N_AIMED_LENS,
                                     N_FF_REF)
    failures += more
    if failures:
        raise AssertionError("freeform forward path failed: "
                             + ", ".join(failures))
    forward = read_launches()
    log("== launch counts on the freeform forward path: %s" % forward)
    s = schmidt_corrector()
    loop, step, _ = designer_loop(s, "freeform designer loop: Schmidt "
                                  "corrector", FF_SELECT,
                                  {"xy_poly": freeform_scales(s)},
                                  N_LOOP_CHECK, fields=(0.,), lr=FF_LR)
    log("later steps: designer loop Schmidt corrector %.4f s, double Gauss "
        "%.4f s (%.2fx)" % (step, opt_step, step/opt_step))
    return ({k: v + loop[k] for k, v in forward.items()}, step,
            {FF_TIMED: schmidt, "zernike corrector": zernike})


def phase_freeform_throughput(card):
    """K1, K2, K4 and K5 on the Schmidt corrector (FF_TIMED) beside its
    freeform-free twin (freeform_twin) on the bench bundle:
    phase_throughput and phase_grad_throughput (K5 also for the loop's
    slot set, xy_poly) in both dtypes at N_GRAD_TIME rays and float32 at
    N_BENCH.  Returns their times."""
    _, table, specs, half = freeform_lenses()[FF_TIMED]
    kw = dict(lens=FF_TIMED, bundle=phase_bundle_of(half),
              twin_name="freeform-free twin")
    twin = freeform_twin()
    times = phase_throughput(table, specs, card, N_GRAD_TIME, twin, N_BENCH,
                             **kw)
    times.update(phase_grad_throughput(table, specs, card, twin, FF_SELECT,
                                       **kw))
    return times


# -- the freeform rows in K3 and K6-K9: the Schmidt corrector's loops ----

#: the Schmidt corrector's loops: on axis, at its 3 wavelengths
FF_FIELDS = (0.,)
#: the Schmidt corrector's achromatization loop's K7 slot set (the glass
#: moves mu, Adam the plate's xy_poly too) and its design step's K9 slot
#: set (FF_SELECT's field)
FF_ACHROM_FIELDS = ACHROM_FIELDS + ("xy_poly",)
FF_DESIGN_FIELDS = FF_SELECT
#: the table lenses' reference sphere for K8 and K9 (mm) and wavelength
FF_TABLE_SPHERE = (-40., 550e-9)
#: K7's and K9's central differences on FF_FD_PICKS: a relative step of
#: the XY singlet's terms, and mm of sag at the Schmidt plate's norm
#: radius (on the CPU plain versions: <= 9e-9 of the gradient, against
#: 1.3e-6 at K5's 1e-6 steps, whose wavefront RMS rounds at ~1e-9 waves)
FF_FD_ADJOINT_REL_STEP = 1e-4
FF_FD_ADJOINT_SAG = 1e-4
#: the reference's Zernike imprint (tests/test_freeform.py
#: test_zernike_sag_imprints_wavefront): Z11 of a ZernikeSag plate ahead
#: of an R = -400 paraboloid mirror, its hexapolar rays, and the
#: recovered Z11's tolerance, relative to (n - 1) Z11/(lambda/scale)
FF_IMPRINT_Z11 = 5e-4
FF_IMPRINT_NRAYS = 128
FF_IMPRINT_REL = 1e-3


def freeform_stack(s, table):
    """The stack of a freeform lens's three wavelength tables on the
    card and the specs they share (the first table's, multi_specs): a
    system's own (System.tables: the same XY coefficients, mu by
    wavelength); a table lens's with mu grown by 1 and 2 % of mu - 1 and
    its XY coefficients by 3 and 6 % (each table packs its own)."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.ops.tables import stack_tables
    if s is not None:
        tabs = s.tables()
    else:
        tabs = stack_tables([table.replace(
            mu=1 + (table.mu - 1)*(1 + .01*li),
            xy_poly=table.xy_poly*(1 + .03*li)) for li in range(3)])
    return tabs, multi_specs(tabs, None)


def freeform_opd_system(s):
    """What K8's aux reads of a lens (opd_aux): the system, or for a
    table lens its sphere (FF_TABLE_SPHERE) and wavelength at scale 1e-3,
    object at infinity."""
    import types
    if s is not None:
        return s
    radius, lam = FF_TABLE_SPHERE
    return types.SimpleNamespace(
        image=types.SimpleNamespace(pupil=types.SimpleNamespace(
            distance=-radius)), wavelengths=[lam], scale=1e-3,
        object=types.SimpleNamespace(finite=False))


def freeform_opd_grad_fields(table, specs):
    """K9's cotangent columns by table field on a freeform key:
    freeform_grad_fields' with n_before at 6 and the rest one further
    on."""
    return OPD_GRAD_FIELDS + tuple(
        (f, slice(c.start + 1, c.stop + 1))
        for f, c in freeform_grad_fields(table, specs)[len(GRAD_FIELDS):])


def freeform_multi_keys():
    """{tag: key} of the freeform K3, K6-K9 keys this script runs: K3's
    two modes, K6 and K7 (every field, with the ray cotangents) on each
    freeform lens's stack (freeform_stack) and K8 and K9 on its table,
    float64 unclipped, on the Schmidt plates also float32 unclipped and
    float64 clipped (K3 unclipped; the clipped K7 check's agreement
    traces K1 on each table), the K7 and K9 loop keys (FF_ACHROM_FIELDS,
    FF_DESIGN_FIELDS) in both dtypes and the design step's breakdown keys
    on the Schmidt corrector, its freeform-free twin's K3, K6-K9 in
    float32 for the timings, the finite-difference checks' float64 K7
    and K9 (xy_poly) and the Zernike imprint's K8 (the plate with and
    without its figure); and the host OPD checks' K8 on each design
    path's written-back lens (host_opd_keys)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize
    f64, f32 = torch.float64, torch.float32
    keys = {}

    def kw(table, specs):
        return dict(widths=figure_widths(table, specs),
                    nd=doe_width(table, specs), nxy=xy_width(table, specs))
    fd = {lens for lens, _ in FF_FD_PICKS}
    for name, (s, table, specs, _) in freeform_lenses().items():
        tag = name.replace(" ", "-")
        tabs, mspecs = freeform_stack(s, table)
        okw, mkw = kw(table, specs), kw(tabs, mspecs)
        schmidt = name.endswith("schmidt") or name == FF_TIMED
        runs = [(f64, False)] + ([(f32, False), (f64, True)] if schmidt
                                 else [])
        for dtype, clip in runs:
            dt = str(dtype)[6:]
            sfx = "%s %s clip=%s" % (dt, tag, clip)
            if not clip:
                for mode in ("merit", "trace"):
                    keys["K3 %s %s %s" % (dt, tag, mode)] = \
                        CS.trace_multi_key(mspecs, dtype, 3, mode == "merit",
                                           **mkw)
            else:
                keys["K1 %s %s clip=True stack" % (dt, tag)] = CS.trace_key(
                    mspecs, dtype, True, **mkw)
            keys["K6 " + sfx] = CS.moments_multi_key(mspecs, dtype, clip, 3,
                                                     **mkw)
            keys["K7 %s all rays=True" % sfx] = CS.adjoint_multi_key(
                mspecs, dtype, clip, **mkw)
            keys["K8 " + sfx] = CS.opd_key(specs, dtype, clip, **okw)
            keys["K9 %s all rays=True" % sfx] = CS.opd_adjoint_key(
                specs, dtype, clip, **okw)
        if name in fd:
            keys["K7 float64 %s fd xy_poly rays=False" % tag] = \
                CS.adjoint_multi_key(mspecs, f64, False, FF_SELECT, False,
                                     **mkw)
            keys["K9 float64 %s fd xy_poly rays=False" % tag] = \
                CS.opd_adjoint_key(specs, f64, False, FF_SELECT, False, **okw)
        if name != FF_TIMED:
            continue
        for dtype in (f64, f32):
            dt = str(dtype)[6:]
            keys["K7 %s %s achromatization rays=False" % (dt, tag)] = \
                CS.adjoint_multi_key(mspecs, dtype, False, FF_ACHROM_FIELDS,
                                     False, **mkw)
            keys["K9 %s %s design rays=False" % (dt, tag)] = \
                CS.opd_adjoint_key(specs, dtype, False, FF_DESIGN_FIELDS,
                                   False, **okw)
        # the design step's breakdown (curvature and offset)
        keys["K5 float64 %s breakdown rays=False" % tag] = CS.adjoint_key(
            specs, f64, False, OPT_FIELDS, False, **okw)
        keys["K9 float64 %s breakdown rays=False" % tag] = \
            CS.opd_adjoint_key(specs, f64, False, DESIGN_FIELDS, False, **okw)
        # the freeform-free twin's keys, for the timings
        ts = schmidt_corrector([])
        ttable = ts.table()
        tspecs = specialize(ttable)
        _, tmspecs = freeform_stack(ts, ttable)
        tsfx = "float32 %s twin" % tag
        for mode in ("merit", "trace"):
            keys["K3 %s %s" % (tsfx, mode)] = CS.trace_multi_key(
                tmspecs, f32, 3, mode == "merit")
        keys["K6 " + tsfx] = CS.moments_multi_key(tmspecs, f32, False, 3)
        keys["K7 %s all rays=True" % tsfx] = CS.adjoint_multi_key(tmspecs,
                                                                  f32)
        keys["K7 %s achromatization rays=False" % tsfx] = \
            CS.adjoint_multi_key(tmspecs, f32, False, ACHROM_FIELDS, False)
        keys["K8 " + tsfx] = CS.opd_key(tspecs, f32)
        keys["K9 %s all rays=True" % tsfx] = CS.opd_adjoint_key(tspecs, f32)
        keys["K9 %s design rays=False" % tsfx] = CS.opd_adjoint_key(
            tspecs, f32, False, DESIGN_FIELDS, False)
    for z11 in (0., FF_IMPRINT_Z11):
        t = imprint_system(z11).table()
        sp = specialize(t)
        keys["K8 float64 imprint z11=%g" % z11] = CS.opd_key(sp, f64,
                                                            **kw(t, sp))
    keys.update(host_opd_keys())
    return keys


def host_opd_keys():
    """{tag: key} of K8 on each design path's written-back lens
    (host_opd_check passes specs=None): the focal-length penalty moves
    the curvature of a flat refracting or reflecting row off zero (the
    spot and wavefront terms bake it out; the paraxial power (n' - n) c
    reads it, and its gradient is nonzero once the first step has moved
    the focal length off its target), so that row specializes as a
    sphere after write_back_table.  The lens is rebuilt with those
    rows' curvature at 1e-9 and specialized."""
    from rayopt_tpu_torch.models import (anamorphic_pair, double_gauss,
                                         hybrid_achromat)
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize
    paths = {"double-Gauss": (double_gauss, OPT_SELECT),
             "aspheric-double-Gauss": (aspheric_double_gauss,
                                       ASPH_DESIGN_SELECT),
             "anamorphic-pair": (anamorphic_pair, ANAM_DESIGN_SELECT),
             "hybrid-achromat": (hybrid_achromat, PHASE_SELECT),
             "schmidt-corrector": (schmidt_corrector, FF_SELECT)}
    keys = {}
    for tag, (build, select) in paths.items():
        s = build()
        if "curvature" in select and np.isfinite(
                float(s.paraxial.focal_length[1])):
            for j, sp in enumerate(specialize(s.table(device="cpu"))):
                if j and sp.flat and sp.kind:
                    s[j].curvature = 1e-9
            s.update()
        t = s.table()
        sp = specialize(t)
        keys["K8 float64 %s written back" % tag] = CS.opd_key(
            sp, torch.float64, widths=figure_widths(t, sp),
            nd=doe_width(t, sp), nxy=xy_width(t, sp))
    return keys


def imprint_system(z11):
    """The reference's Zernike imprint system (tests/test_freeform.py
    test_zernike_sag_imprints_wavefront): a ZernikeSag plate (Z11 =
    `z11` at an 8 mm norm radius, N-BK7, 3 mm thick) 5 mm ahead of an
    R = -400 paraboloid mirror, an 8 mm pupil, on axis."""
    from rayopt_tpu_torch import System
    s = System([
        dict(material="air"),
        dict(type="zernike", zernike_coefficients=[0.]*10 + [z11],
             norm_radius=8., distance=5., material="SCHOTT-BK|N-BK7",
             radius=9.),
        dict(distance=3., material="air", radius=9.),
        dict(roc=-400., conic=-1., distance=20., material="mirror",
             radius=12.),
        dict(distance=-200., radius=9.)])
    s.object.pupil.radius = 8.
    s.object.pupil.update_radius = False
    s.update()
    return s


def phase_freeform_multi_check():
    """K3, K6 and K7 on each freeform lens's stack (freeform_stack, three
    wavelengths; phase_multi_check) and K8 and K9 on its table
    (phase_opd_check; ray 0 the chief ray on the axis; a table lens's
    sphere FF_TABLE_SPHERE), the adjoints' XY columns among their
    fields, a field held to its largest or to COLUMN_FLOOR of the key's:
    float64 unclipped on the lens's bench bundle (freeform_bundle_of,
    slopes +-0.03) on each; on the Schmidt plates also float32 unclipped
    and float64 clipped (the bundle 1.5x wide), and float64 on the
    collimated on-axis bundle the loops run, with the Schmidt corrector's
    loop keys (FF_ACHROM_FIELDS, FF_DESIGN_FIELDS).  Then K7 and K9
    against central differences (phase_freeform_fd_adjoints) and K8 on
    the reference's Zernike imprint (phase_zernike_imprint_check).
    Returns the float32 errors."""
    worst = {}

    def keep(errs):
        worst.update({k: max(v, worst.get(k, 0.)) for k, v in errs.items()})
    f64 = (torch.float64,)
    for lens, (s, table, specs, half) in freeform_lenses().items():
        bundle = freeform_bundle_of(half)
        tabs, mspecs = freeform_stack(s, table)
        mfields = freeform_grad_fields(tabs, mspecs)
        ofields = freeform_opd_grad_fields(table, specs)
        sy = freeform_opd_system(s)
        schmidt = lens.endswith("schmidt") or lens == FF_TIMED
        loops = ((FF_ACHROM_FIELDS, FF_DESIGN_FIELDS) if lens == FF_TIMED
                 else (None, None))
        dtypes = (torch.float32, torch.float64) if schmidt else f64
        keep(phase_multi_check(tabs, mspecs, lens + ", its stack", bundle,
                               (False,), mfields, loops[0], dtypes))
        # float32 K9 on the Schmidt plates: logged, not held (its sums
        # cancel past the float32 plain version's own reach)
        keep(phase_opd_check(sy, table, specs, lens, bundle, (False,),
                             ofields, loops[1], dtypes[::-1],
                             hold_f32_k9=not schmidt))
        if schmidt:
            phase_multi_check(tabs, mspecs, lens + ", its stack", bundle,
                              (True,), mfields, None, f64)
            phase_opd_check(sy, table, specs, lens, bundle, (True,),
                            ofields, None, f64)
            flat = freeform_bundle_of(half, 0.)
            phase_multi_check(tabs, mspecs, lens + ", its stack, collimated",
                              flat, (False,), mfields, loops[0], f64)
            phase_opd_check(sy, table, specs, lens + ", collimated", flat,
                            (False,), ofields, loops[1], f64)
    phase_freeform_fd_adjoints()
    phase_zernike_imprint_check()
    return worst


def phase_freeform_fd_adjoints():
    """Float64, N_CHECK rays of the collimated on-axis bundle
    (freeform_bundle_of(half, 0)), against central differences (steps
    FF_FD_ADJOINT_REL_STEP of the value, or FF_FD_ADJOINT_SAG mm of sag
    at the Schmidt plate's norm radius) on FF_FD_PICKS: K7's gradient of
    the K6 merit (the union spot RMS of the lens's stack) w.r.t. the
    stack's first table's xy_poly coefficient, and K9's of the K8
    wavefront RMS (ray 0 the chief ray) w.r.t. the table's."""
    from rayopt_tpu_torch.ops.cuda_grad import (adjoint_wavefront_rms,
                                                polychromatic_spot_rms)
    cases = freeform_lenses()
    log("== K7 and K9 on the freeform lenses vs central differences of the "
        "K6 merit and the K8 wavefront RMS (float64, %d collimated rays)"
        % N_CHECK)
    failures = []
    for kern in ("K7", "K9"):
        for lens, idx in FF_FD_PICKS:
            s, table, specs, half = cases[lens]
            state = freeform_bundle_of(half, 0.)(N_CHECK, torch.float64, SEED)
            w = bench_weights(N_CHECK, torch.float64, SEED + 2)
            y0, u0 = torch.stack(state[:3], 1), torch.stack(state[3:], 1)
            if kern == "K7":
                tab, sp = freeform_stack(s, table)
                at = (0, 1, idx)

                def merit(tb, sp=sp):
                    return polychromatic_spot_rms(tb, y0, u0, w, specs=sp)
            else:
                tab, sp, at = table, specs, (1, idx)

                def merit(tb, s=s, sp=sp):
                    return adjoint_wavefront_rms(
                        tb, y0, u0, w, ref=0, radius=-s.image.pupil.distance,
                        wavelength=s.wavelengths[0], scale=s.scale,
                        finite=s.object.finite, specs=sp)
            base = tab.xy_poly
            v = base.clone().requires_grad_()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")    # the baked rows
                merit(tab.replace(xy_poly=v)).backward()
            value = float(base[at])
            h = (FF_FD_ADJOINT_SAG/25.**4 if lens == "schmidt corrector"
                 else FF_FD_ADJOINT_REL_STEP*abs(value))
            side = []
            with torch.no_grad():
                for sgn in (1., -1.):
                    b = base.clone()
                    b[at] += sgn*h
                    side.append(float(merit(tab.replace(xy_poly=b))))
            fd = (side[0] - side[1])/(2*h)
            g = float(v.grad[at])
            rel = abs(g - fd)/abs(fd)
            ok = rel <= FD_REL
            log("%s, %s xy_poly%s (value %.6g): kernel %.12g, central "
                "difference %.12g (step %.3g), rel %.2e -> %s"
                % (kern, lens, list(at), value, g, fd, h, rel,
                   "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s xy_poly %d" % (kern, lens, idx))
    if failures:
        raise AssertionError("K7 or K9 on the freeform lenses disagrees "
                             "with finite differences: "
                             + ", ".join(failures))


def phase_zernike_imprint_check():
    """K8 on the reference's Zernike imprint (imprint_system, its
    test_zernike_sag_imprints_wavefront): FF_IMPRINT_NRAYS hexapolar
    rays on axis (GeometricTrace.rays_point, unclipped) through
    adjoint_opd_rays (K8, float64, with the landing on the sphere) at
    Z11 = 0 and FF_IMPRINT_Z11, each wavefront fitted by
    utils.zernike.fit_zernike (16 Noll terms, the landing normalized to
    the unit disc, the host's weights): the baseline is stigmatic
    (|c[1:]| < 1e-6 waves), the Z11 difference equals (n - 1) Z11 /
    (lambda/scale) to FF_IMPRINT_REL, and every other mode but piston
    and defocus stays below FF_IMPRINT_REL of it; the host's
    GeometricTrace.zernike of the same rays beside it."""
    from rayopt_tpu_torch import GeometricTrace
    from rayopt_tpu_torch.ops.cuda_grad import adjoint_opd_rays, opd_chain
    from rayopt_tpu_torch.utils.zernike import fit_zernike
    coeff, host, launched = {}, {}, 0
    for z11 in (0., FF_IMPRINT_Z11):
        s = imprint_system(z11)
        g = GeometricTrace(s)
        g.rays_point((0., 0.), nrays=FF_IMPRINT_NRAYS,
                     distribution="hexapolar", clip=False)
        before = opd_chain.launches
        waves, land = adjoint_opd_rays(
            s.table(), torch.from_numpy(g.y[0]).to(DEVICE),
            torch.from_numpy(g.u[0]).to(DEVICE), ref=g.ref,
            radius=-s.image.pupil.distance, wavelength=s.wavelengths[0],
            scale=s.scale, finite=s.object.finite, with_pupil=True)
        launched += opd_chain.launches - before
        waves = waves.detach().cpu().numpy()
        land = land.detach().cpu().numpy()
        h = np.nanmax(np.hypot(land[:, 0], land[:, 1]))
        coeff[z11], _ = fit_zernike(land[:, 0]/h, land[:, 1]/h, waves,
                                    nterms=16, w=g.w)
        host[z11], _ = g.zernike(nterms=16)
    lam = s.wavelengths[0]
    n = s[1].material.refractive_index(lam)
    expected = (n - 1)*FF_IMPRINT_Z11/(lam/s.scale)
    d = coeff[FF_IMPRINT_Z11] - coeff[0.]
    dh = host[FF_IMPRINT_Z11] - host[0.]
    rel = abs(d[10] - expected)/expected
    other = float(np.abs(np.delete(d, [0, 3, 10])).max())
    base = float(np.abs(coeff[0.][1:]).max())
    ok = (rel <= FF_IMPRINT_REL and other <= FF_IMPRINT_REL*expected
          and base < 1e-6 and launched == 2)
    log("== K8 on the Zernike imprint (ZernikeSag Z11 = %g ahead of an "
        "R = -400 paraboloid, %d hexapolar rays, float64): Z11 difference "
        "%.9g waves vs (n - 1) Z11/(lambda/scale) %.9g (rel %.2e; the host "
        "%.9g), the largest other mode but piston and defocus %.3e waves "
        "(%.2e of it), the baseline's largest mode %.3e waves, K8 launches "
        "%d -> %s" % (FF_IMPRINT_Z11, FF_IMPRINT_NRAYS, d[10], expected, rel,
                      dh[10], other, other/expected, base, launched,
                      "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("K8 on the Zernike imprint failed")


def phase_freeform_loops(glass_step, design_step):
    """The Schmidt corrector's achromatization loop (phase_glass_path:
    K3, K6 and K7 at FF_FIELDS x its 3 wavelengths, over the curvatures,
    the distances, the plate's glass and, at FF_LR, its xy_poly over
    freeform_scales; K3 reporting the spots), on the figured plate
    (SCHMIDT_FIGURE: the seeded plate is flat, and collimated light
    meets it at normal incidence, so its glass has no first-order
    effect there: the glass logits' gradient is a ~1e-9 residue of the
    K7 mu column's cancellation, which card and CPU round apart by
    ~6e-7 of it), and its design step
    (phase_design_path over FF_SELECT with freeform_scales at FF_LR: K4,
    K5, K8 and K9 at FF_FIELDS; no focal-length term, its paraxial EFL is
    not finite on axis), each step 0 against the CPU at N_LOOP_CHECK
    nrays a bundle, their later steps logged beside the double Gauss's
    (`glass_step`, `design_step` seconds).  Returns (the loops'
    launches, their later-step seconds)."""
    from rayopt_tpu_torch.parallel import freeform_scales
    glass, gstep, _ = phase_glass_path(
        schmidt_corrector(SCHMIDT_FIGURE), "figured Schmidt corrector",
        N_LOOP_CHECK, slots=1, fields=FF_FIELDS)
    s = schmidt_corrector()
    design, dstep, _ = phase_design_path(
        s, "Schmidt corrector", FF_SELECT, {"xy_poly": freeform_scales(s)},
        N_LOOP_CHECK, fields=FF_FIELDS, lr=FF_LR)
    steps = {"achromatization": gstep, "design": dstep}
    log("later steps: %s" % ", ".join(
        "%s loop Schmidt corrector %.4f s, double Gauss %.4f s (%.2fx)"
        % (k, v, t, v/t) for (k, v), t in zip(
            steps.items(), (glass_step, design_step))))
    return {k: v + design[k] for k, v in glass.items()}, steps


def phase_freeform_multi_throughput(card):
    """K3 (merit and trace), K6, K7 (every field, and the loop's key),
    K8 and K9 (the same two) on the Schmidt corrector (FF_TIMED; K3, K6
    and K7 on its stack) beside its freeform-free twin's keys
    (multi_opd_throughput, float32): against their plain versions at
    N_CHECK bench rays, then the forward kernels at N_BENCH rays and the
    adjoints at N_GRAD_TIME against the twin's.  Returns (times, live)
    as multi_opd_throughput's."""
    from rayopt_tpu_torch.ops.kernels import specialize
    s, table, specs, half = freeform_lenses()[FF_TIMED]
    ts = schmidt_corrector([])
    ttable = ts.table()
    return multi_opd_throughput(
        card, FF_TIMED, "freeform keys",
        (s, table, specs, *freeform_stack(s, table)),
        (ts, ttable, specialize(ttable), *freeform_stack(ts, ttable)),
        (FF_ACHROM_FIELDS, FF_DESIGN_FIELDS), (ACHROM_FIELDS, DESIGN_FIELDS),
        phase_bundle_of(half), "freeform-free twin key",
        {name: N_GRAD_TIME for name in ("merit_adjoint_multi",
                                        "merit_adjoint_multi_loop",
                                        "opd_adjoint", "opd_adjoint_loop")})


def freeform_multi_entries(sources, launches, worst, times, live, ptxas,
                           steps, dg_steps):
    """The kernels line's entries of K3, K6, K7, K8 and K9's freeform
    keys: the freeform path's launches (the Schmidt corrector's
    achromatization loop and design step), the float32 errors of
    phase_freeform_multi_check, the times of
    phase_freeform_multi_throughput (at N_CHECK against the plain
    versions; the forward kernels at N_BENCH and the adjoints at
    N_GRAD_TIME against the freeform-free twin's keys), the bounds
    (kernel_bound at each size's live rays, the freeform row by
    freeform_row_flops and xy_flops), the keys' registers, stack and
    spills (float64 and float32; the loop keys' too), and the loops'
    later-step seconds beside the double Gauss's."""
    from rayopt_tpu_torch.ops.cuda_trace import figure_widths, xy_width
    s, table, specs, _ = freeform_lenses()[FF_TIMED]
    tabs, mspecs = freeform_stack(s, table)
    tags = {"trace_multi": "K3 %s %s merit",
            "weighted_moments_multi": "K6 %s %s clip=False",
            "merit_adjoint_multi": "K7 %s %s clip=False all rays=True",
            "opd_chain": "K8 %s %s clip=False",
            "opd_adjoint": "K9 %s %s clip=False all rays=True"}
    loop_tags = {"trace_multi": "K3 %s %s trace",
                 "merit_adjoint_multi": "K7 %s %s achromatization rays=False",
                 "opd_adjoint": "K9 %s %s design rays=False"}
    extras = {"trace_multi": "trace_multi_trace",
              "merit_adjoint_multi": "merit_adjoint_multi_loop",
              "opd_adjoint": "opd_adjoint_loop"}
    tag = FF_TIMED.replace(" ", "-")
    big = {n for _, n in times if n != N_CHECK}
    out = []
    for kname, ktag in tags.items():
        source, replaces = sources[kname]
        multi = kname in ("trace_multi", "weighted_moments_multi",
                          "merit_adjoint_multi")
        tb, sp = (tabs, mspecs) if multi else (table, specs)
        entry = {"name": kname + "_freeform", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_CHECK,
                 "wavelengths": 3 if multi else 1}

        def bound(name, n, tb=tb, sp=sp, multi=multi):
            return kernel_bound(name, n, torch.float32, sp,
                                3 if multi else 1, live[n][0 if multi else 1],
                                figure_widths(tb, sp), 0, xy_width(tb, sp))
        for name, sfx in ((kname, ""), (extras.get(kname), None)):
            if name is None:
                continue
            if sfx is None:
                sfx = "_trace" if kname == "trace_multi" else "_loop_key"
            if (name, N_CHECK) in times:
                k, p = times[(name, N_CHECK)]
                b, by = bound(name, N_CHECK)
                entry.update({"ms" + sfx: k, "plain_ms" + sfx: p,
                              "bound_ms" + sfx: b})
                if not sfx:
                    entry["bound_by"] = by
            for n in big:
                if (name, n) in times:
                    kb, tw = times[(name, n)]
                    at = "_f32_%d_rays" % n
                    entry.update({"ms" + sfx + at: kb,
                                  "ms_twin_key" + sfx + at: tw,
                                  "bound_ms" + sfx + at: bound(name, n)[0]})
        for dt in ("float32", "float64"):
            sfx = "" if dt == "float64" else "_f32"
            regs, stack, spill = ptxas[ktag % (dt, tag)]
            entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                          "spill_bytes" + sfx: spill})
            if kname in loop_tags:
                regs, stack, spill = ptxas[loop_tags[kname] % (dt, tag)]
                lsfx = "_trace" if kname == "trace_multi" else "_loop_key"
                entry.update({"regs" + lsfx + sfx: regs,
                              "spill_bytes" + lsfx + sfx: spill})
        entry["regs_twin_f32"] = ptxas[(ktag % ("float32", tag + " twin"))
                                       .replace(" clip=False", "")][0]
        if kname == "merit_adjoint_multi":
            entry.update({"achromatization_step_s": steps["achromatization"],
                          "double_gauss_achromatization_step_s":
                              dg_steps["achromatization"]})
        if kname == "opd_adjoint":
            entry.update({"design_step_s": steps["design"],
                          "double_gauss_design_step_s": dg_steps["design"]})
        out.append(entry)
    return out


# -- the freeform XY rows in K10-K13 -----------------------------------------

#: the degree-7 row of the df32 checks: the aspheric-base lens's row
#: widened to 35 terms, some zero, with nonzero terms of degree 7 (past
#: the degree-6 term mask: a dense step, cuda_df32.FIG_XY_DENSE)
DF32_FF_DEG7 = [1e-4, 0., 3e-3, 0., -2e-3, 2e-5, 0., 0., 1e-5, 1e-6, 0.,
                2e-6, 0., -1e-6, 0., 3e-8, 0., 0., 0., -2e-8, 1e-9, 0., 0.,
                0., 0., 0., 2e-9, 0., 0., 4e-11, 0., 0., 0., 0., -3e-11]
#: the freeform lenses held at all four (fast, clip) pairs and N_CHECK
#: rays (the Schmidt plates, and the Zernike corrector, whose df32 path
#: runs the unclipped plans); the others at N_DF32_FF_CUT rays, (fast,
#: unclipped) and (exact, clipped)
DF32_FF_FULL = ("schmidt corrector", "figured schmidt", "zernike corrector")
N_DF32_FF_CUT = 1 << 18
#: the freeform plans timed against the freeform-free twin's: the seeded
#: Schmidt plate (all 14 terms) with the plain versions, and the figured
#: plate (9 terms) beside it at N_GRAD_TIME
DF32_FF_TIMED = (FF_TIMED, "figured schmidt")
DF32_FF_SHORT = {FF_TIMED: "schmidt", "figured schmidt": "figured"}


def df32_freeform_tables():
    """make_table keyword arguments of the df32-only freeform lenses: the
    aspheric-base lens (freeform_tables) with the degree-7 row
    DF32_FF_DEG7, and with its freeform row decentered and tilted (a
    general df32 rotation)."""
    base = freeform_tables()["aspheric base"]
    zero = [[0.]*3]*4
    return {"degree-7 freeform": dict(base, xy_poly=[[0.]*35, DF32_FF_DEG7,
                                                     [0.]*35, [0.]*35]),
            "tilted freeform": dict(
                base, tilt=[zero[0], [.02, -.03, .01]] + zero[2:],
                decenter=[zero[0], [.2, -.1, 0.]] + zero[2:])}


@functools.lru_cache(maxsize=None)
def df32_freeform_cases():
    """{name: (table on the card, its three wavelength tables, bench
    bundle function, [(fast, clip), ...] held, rays)} of the df32
    freeform checks: every freeform lens (freeform_lenses: a system's
    System.tables, a table lens's anam_stack, mu grown by 0, 1 and 2 %)
    and the two df32-only tables (df32_freeform_tables)."""
    from rayopt_tpu_torch.ops.tables import make_table, table_at
    full = [(True, False), (True, True), (False, False), (False, True)]
    cut = [(True, False), (False, True)]
    lenses = {name: (s, table, half)
              for name, (s, table, _, half) in freeform_lenses().items()}
    for name, kw in df32_freeform_tables().items():
        lenses[name] = (None, make_table(**kw), 5.)
    out = {}
    for name, (s, table, half) in lenses.items():
        tabs = s.tables() if s is not None else anam_stack(table)[0]
        out[name] = (table, [table_at(tabs, li)
                             for li in range(tabs.curvature.shape[0])],
                     freeform_bundle_of(half),
                     full if name in DF32_FF_FULL else cut,
                     N_CHECK if name in DF32_FF_FULL else N_DF32_FF_CUT)
    return out


def df32_freeform_twin_plans(lens, fast):
    """((one plan, the three wavelength plans) of a timed freeform lens,
    the same of the Schmidt corrector's freeform-free twin)."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    table, lam_tabs = df32_freeform_cases()[lens][:2]
    tw = schmidt_corrector([])
    ttabs = tw.tables()
    return ((D.plan(table, fast=fast),
             [D.plan(t, fast=fast) for t in lam_tabs]),
            (D.plan(tw.table(), fast=fast),
             [D.plan(table_at(ttabs, li), fast=fast) for li in range(3)]))


def df32_freeform_keys():
    """{tag: key} of the df32 freeform checks, paths and timings: each
    case of df32_freeform_cases at its (fast, clip) pairs, K10 (with the
    path) and K12 on its plan, K11 (with the path) and K13 on its three
    wavelength plans (the Schmidt and Zernike correctors' df32 paths
    among them); and the freeform-free twin's plans, fast and exact."""
    from rayopt_tpu_torch.ops import df32 as D
    keys = {}
    for name, (table, lam_tabs, _, pairs, _) in \
            df32_freeform_cases().items():
        for fast, clip in pairs:
            keys.update(df32_quad(
                "%s %s clip=%s" % (name, "fast" if fast else "exact", clip),
                D.plan(table, clip=clip, fast=fast),
                [D.plan(t, clip=clip, fast=fast) for t in lam_tabs]))
    for fast in (True, False):
        keys.update(df32_quad(
            "freeform-free twin %s" % ("fast" if fast else "exact"),
            *df32_freeform_twin_plans(FF_TIMED, fast)[1]))
    return keys


def phase_df32_freeform_check():
    """K10-K13 against their plain versions on the card on the freeform
    plans (df32_freeform_cases): the Schmidt plates and the Zernike
    corrector at N_CHECK bench rays (freeform_bundle_of: slopes within
    +-0.03) at every (fast, clip) pair, and on the collimated on-axis
    bundle, fast and exact unclipped; the other lenses (the XY singlet,
    the quadratic freeform, the freeform on an aspheric base and on a
    grating row, the degree-7 row, the tilted row) at N_DF32_FF_CUT
    rays, (fast, unclipped) and (exact, clipped); 1.5x wide when
    clipped, K10 and K11 with the optical path, K11/K13 on the three
    wavelength plans.  The kernels round every float32 operation as the
    plain versions do: the words that differ are counted (0
    expected)."""
    from rayopt_tpu_torch.ops import df32 as D
    worst = dict.fromkeys(DF32_NAMES, 0.)
    failures = []
    for name, (table, lam_tabs, bundle, pairs, n) in \
            df32_freeform_cases().items():
        log("== K10-K13 vs plain on the card: %s (freeform plans), %d bench "
            "rays (1.5x wide when clipped), K11/K13 on its 3 wavelength "
            "plans, with the path, at %s" % (
                name, n, ", ".join("%s clip=%s" % (
                    "fast" if f else "exact", c) for f, c in pairs)))
        bundles = [("", bundle)]
        if name in DF32_FF_FULL:
            bundles.append((" collimated", freeform_bundle_of(
                freeform_lenses()[name][3], 0.)))
        for what, make in bundles:
            state64 = make(n, torch.float64, SEED)
            for fast, clip in pairs:
                if what and clip:
                    continue
                state = df32_state(state64, 1.5 if clip else 1.)
                tag = "%s%s clip=%s %s plan" % (name, what, clip,
                                                "fast" if fast else "exact")
                df32_check_case(tag, D.plan(table, clip=clip, fast=fast),
                                [D.plan(t, clip=clip, fast=fast)
                                 for t in lam_tabs],
                                state, n, worst, failures, (True,))
                del state
            del state64
    if failures:
        raise AssertionError("df32 kernel disagrees with its plain version "
                             "on a freeform plan: " + ", ".join(failures))
    return worst


def phase_df32_freeform_path(aimed):
    """The parity-grade df32 path on the freeform rows: newton_df32_path
    (its launches counted from a reset just before it) on the Schmidt
    corrector's and the Zernike corrector's aimed bundles (`aimed`:
    phase_freeform_path's, field 0; K10's spot RMS on their first
    N_FF_REF rays against the CPU float64 plain trace, its image
    positions against float64 K1 on the card, K11/K13 at the other two
    wavelengths).  Returns {lens: launches}."""
    return {lens: newton_df32_path(build(), aimed[lens], title)
            for lens, build, title in (
                (FF_TIMED, schmidt_corrector, "Schmidt corrector"),
                ("zernike corrector", zernike_corrector,
                 "Zernike corrector"))}


def phase_df32_freeform_throughput(card):
    """df32_twin_throughput on the timed freeform plans (DF32_FF_TIMED)
    against the Schmidt corrector's freeform-free twin's: the seeded
    plate at N_GRAD_TIME (with the plain versions) and N_BENCH rays, the
    figured plate at N_GRAD_TIME."""
    times, live = {}, {}
    for lens in DF32_FF_TIMED:
        seeded = lens == FF_TIMED
        t, lv = df32_twin_throughput(
            card, "the %s's freeform plans against its freeform-free twin's"
            % lens, "freeform-free twin",
            {lens: ((N_GRAD_TIME, N_BENCH) if seeded else (N_GRAD_TIME,),
                    functools.partial(df32_freeform_twin_plans, lens),
                    df32_freeform_cases()[lens][2])}, plain=seeded)
        times.update(t)
        live.update(lv)
    return times, live


def df32_freeform_entries(launches, worst, times, live, ptxas, sass):
    """The kernels line's entries of K10-K13 on the freeform plans (named
    "<kernel>_freeform"): the launches of the freeform df32 paths (the
    Schmidt and the Zernike correctors', each counted from a reset just
    before it; summed, and each under "launches_<lens>"), the errors of
    phase_df32_freeform_check, the times of
    phase_df32_freeform_throughput (the Schmidt corrector's fast plan at
    N_GRAD_TIME rays as `ms`, its plain version's as `plain_ms`, exact
    under "exact_", N_BENCH under "<n>_rays_", the figured plate's under
    "figured_"), each beside the freeform-free twin's and its bound
    (df32_bound: df32_newton_ops counts the freeform terms the step
    holds), and the path keys' registers, spills and SASS."""
    entries = []
    for kname in DF32_NAMES:
        multi = "multi" in kname
        entry = {"name": kname + "_freeform", "route": "cuda",
                 "source": "rayopt_tpu_torch/csrc/df32_spec.cuh",
                 "replaces": DF32_REPLACES[kname],
                 "launches": sum(c[kname] for c in launches.values()),
                 "max_abs_err": worst[kname], "library_ms": None,
                 "rays": N_GRAD_TIME, "wavelengths": 3 if multi else 1}
        for lens, counts in launches.items():
            entry["launches_" + lens.split()[0]] = counts[kname]
        for lens in DF32_FF_TIMED:
            short = DF32_FF_SHORT[lens]
            for fast in (True, False):
                plan = "fast" if fast else "exact"
                mine, twin = df32_freeform_twin_plans(lens, fast)
                pl = mine[1] if multi else [mine[0]]
                tpl = twin[1] if multi else [twin[0]]
                for n in (N_GRAD_TIME, N_BENCH):
                    if (kname, lens, plan, n) not in times:
                        continue
                    k, t, p = times[(kname, lens, plan, n)]
                    nl = live[(lens, n)]*len(pl)
                    b, by = df32_bound(kname, n, pl, nl)
                    at = "%s%s%s" % ("" if lens == FF_TIMED
                                     else short + "_",
                                     "" if fast else "exact_",
                                     "" if n == N_GRAD_TIME
                                     else "%d_rays_" % n)
                    entry.update({at + "ms": k, at + "twin_ms": t,
                                  at + "bound_ms": b,
                                  at + "twin_bound_ms": df32_bound(
                                      kname, n, tpl, nl)[0]})
                    if p == p:
                        entry[at + "plain_ms"] = p
                    if at == "":
                        entry["bound_by"] = by
        for lens in ("schmidt corrector", "zernike corrector"):
            key = "%s %s fast clip=False%s" % (
                DF32_LOOP_KEYS[kname][:3], lens,
                " path=True" if "merit" not in kname else "")
            regs, stack, spill = ptxas[key]
            short = lens.split()[0]
            entry.update({"regs_f32_" + short: regs,
                          "stack_bytes_f32_" + short: stack,
                          "spill_bytes_f32_" + short: spill,
                          "sass_instructions_" + short: sass[key][0]})
        entries.append(entry)
    return entries


def xy_flops(nxy):
    """Operations of a freeform row's XY figure for nxy terms
    (ops.kernels._xy_terms; csrc/trace_common.cuh poly_xy and dpoly_xy,
    csrc/step_vjp.cuh xy_normal_vjp and xy_sag_vjp), each shared
    expression counted once: (residual, slope, hoisted, reverse).  The
    residual at a point: the powers of x and y (2 (D - 1) products), the
    products x^i y^j where i and j are both nonzero, each term's scaling
    and sum (2), the subtraction from the base's.  The slopes at the same
    point add the monomials of the first derivatives not already made,
    each nonzero exponent's scaling and sum (2; its factor i a hoisted)
    and the two subtractions.  Hoisted, once a row: the factors i a and
    j a of the exponents past 1.  The reverse, all at the hit point whose
    monomials the recompute's last residual made: the slopes once (the
    normal's, the implicit step's and the residual gradient's), the
    second derivatives' new monomials, the coefficients' cotangents
    through the normal (2 or 4 a term) and the residual (2 a term), the
    point's through the second derivatives (3 or 5 an axis of a term,
    their constant factors past 1) and the residual (4)."""
    from rayopt_tpu_torch.ops.kernels import _xy_terms
    deg = 0
    while deg*(deg + 3)//2 < nxy:
        deg += 1
    terms = _xy_terms(deg)[:nxy]

    def mixed(pairs):
        return {(a, b) for a, b in pairs if a > 0 and b > 0}
    value = mixed(terms)
    first = mixed([(i - 1, j) for i, j in terms if i]
                  + [(i, j - 1) for i, j in terms if j]) - value
    second = mixed([(i - 2, j) for i, j in terms if i > 1]
                   + [(i - 1, j - 1) for i, j in terms if i and j]
                   + [(i, j - 2) for i, j in terms if j > 1]) - value - first
    nexp = sum((i > 0) + (j > 0) for i, j in terms)
    res = 2*max(deg - 1, 0) + len(value) + 2*nxy + 1
    slope = len(first) + 2*nexp + 2
    hoisted = sum((i > 1) + (j > 1) for i, j in terms)
    rev = slope + len(second) + 2*nxy + 4 + 2
    for i, j in terms:
        rev += 4 if i and j else 2            # gxy through the normal
        rev += (i > 1) + (j > 1)              # the slopes' factors
        hxx, hxy, hyy = i > 1, i > 0 and j > 0, j > 1
        rev += (i*(i - 1) > 1) + (i*j > 1) + (j*(j - 1) > 1)
        for a, b in ((hxx, hxy), (hxy, hyy)):
            rev += 5 if a and b else (3 if a or b else 0)
    return res, slope, hoisted, rev


def freeform_row_flops(spec, widths=(0, 0), nxy=0):
    """Operations of one surface_step on a freeform row: the conic seed
    (33), the vertex-plane restart (2), the hoisted constants,
    ASPHERIC_ITERS Newton steps on the residual less the XY figure (the
    base's residual and slope at every coefficient of the widths, the XY
    figure's, the update), the last residual and its test, the transfer,
    and the refraction by the freeform normal (the radial normal, the XY
    slopes, the general Snell or mirror: 37)."""
    f = 1 + (2 if spec.off_axis else 0) + (60 if spec.rotated else 0)
    res, slope, hoisted = figure_flops(*widths)
    xres, xslope, xhoisted, _ = xy_flops(nxy)
    f += 35 + hoisted + xhoisted + ASPHERIC_ITERS*(res + xres + slope + xslope + 2) \
        + res + xres + 2 + 8
    if spec.kind and not (spec.grating or spec.doe):
        f += slope_flops(*widths) - 6 + xslope + 37
    return f


def freeform_entries(sources, launches, worst, times, ptxas, step, dg_step):
    """The kernels line's entries of the freeform keys: the freeform
    path's launches (the Schmidt and Zernike correctors' forward paths,
    the Schmidt corrector's designer loop), the float32 errors of
    phase_freeform_check, the times of phase_freeform_throughput (the
    Schmidt corrector's keys beside their plain versions and their
    freeform-free twin's keys) at N_GRAD_TIME rays in both dtypes and
    N_BENCH in float32, the bounds (kernel_bound, the freeform row by
    freeform_row_flops), the keys' registers, stack and spills, and the
    designer loop's later-step seconds beside the double Gauss's."""
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 trace_merit, xy_width)
    _, table, specs, half = freeform_lenses()[FF_TIMED]
    bundle = phase_bundle_of(half)
    live = {(n, dtype): float(trace_merit(table, specs, bundle(
        n, dtype, SEED + 1))[0]) for n, dtype in (
            (N_GRAD_TIME, torch.float32), (N_GRAD_TIME, torch.float64),
            (N_BENCH, torch.float32))}
    loop = {"trace_final": "K1 %s %s clip=False",
            "trace_merit": "K2 %s %s clip=False",
            "weighted_moments": "K4 %s %s clip=False",
            "merit_adjoint": "K5 %s %s designer rays=False"}
    big = "_f32_%d_rays" % N_BENCH
    tag = FF_TIMED.replace(" ", "-")
    out = []
    for kname, ktag in loop.items():
        source, replaces = sources[kname]
        entry = {"name": kname + "_freeform", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_GRAD_TIME, "wavelengths": 1}

        def bound(n, dtype, name=kname):
            return kernel_bound(name, n, dtype, specs, 1, live[(n, dtype)],
                                figure_widths(table, specs),
                                doe_width(table, specs),
                                xy_width(table, specs))
        for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
            k, p = times[(kname, dtype)]
            b, by = bound(N_GRAD_TIME, dtype)
            entry.update({"ms" + sfx: k, "plain_ms" + sfx: p,
                          "ms_twin_key" + sfx: times[(kname, dtype, "twin")],
                          "bound_ms" + sfx: b})
            if not sfx:
                entry["bound_by"] = by
            if kname == "merit_adjoint":
                opt = "merit_adjoint_optimizer"
                entry.update({
                    "ms_designer" + sfx: times[(opt, dtype)],
                    "ms_twin_designer_key" + sfx: times[(opt, dtype,
                                                         "twin")],
                    "bound_ms_designer" + sfx:
                        bound(N_GRAD_TIME, dtype, opt)[0]})
        entry.update({"ms" + big: times[(kname, N_BENCH)],
                      "ms_twin_key" + big: times[(kname, N_BENCH, "twin")],
                      "bound_ms" + big: bound(N_BENCH, torch.float32)[0]})
        for dt in ("float32", "float64"):
            sfx = "" if dt == "float64" else "_f32"
            regs, stack, spill = ptxas[ktag % (dt, tag)]
            entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                          "spill_bytes" + sfx: spill})
            regs, _, _ = ptxas[(ktag % (dt, tag + " twin"))
                               .replace(" clip=False", "")]
            entry["regs_twin" + sfx] = regs
        if kname == "merit_adjoint":
            entry.update({"designer_step_s": step,
                          "double_gauss_designer_step_s": dg_step})
        out.append(entry)
    return out


def step_breakdown(table, specs, wave, parts, nspot=9):
    """Wall milliseconds of each part of the design merit's forward and
    backward on the card (the gradients of curvature and offset), and
    of the one-ray sphere-centre traces the wavefront terms hold (one a
    wavefront bundle)."""
    from rayopt_tpu_torch.ops.geometric import trace_rays_final

    def centres(tab):
        return sum(trace_rays_final(tab, y0[:1], u0[:1], clip=False,
                                    specs=specs)[0].sum()
                   for y0, u0, _, _ in wave)
    named = dict(zip(("%d spot terms" % nspot,
                      "%d wavefront terms" % len(wave), "penalty",
                      "%d sphere-centre traces" % len(wave)),
                     (*parts, centres)))
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


def df32_check_case(tag, steps, plans, state, n, worst, failures,
                    paths=(False, True)):
    """K10 and K11 (the optical path off and on, as `paths`), K12 and
    K13 against their plain versions on the card for one plan `steps`,
    the plans of its wavelengths `plans` and one df32 bundle of n rays:
    the words that differ (counted), equal NaN masks and DF32_REL of
    max(1, |value|); the moments within DF32_REL of their scale and the
    same count.  Adds to `worst` and `failures`."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    for wp in paths:
        got = CD.trace_final_df32(steps, state, with_path=wp)
        want = CD.trace_final_df32_reference(steps, state, with_path=wp)
        words, masks, err, rel = compare_df32(df32_pairs(got, wp),
                                              df32_pairs(want, wp))
        ok = masks == 0 and rel <= DF32_REL
        worst["trace_final_df32"] = max(worst["trace_final_df32"], err)
        log("K10 %s path=%s: differing words %d, NaN masks differ on %d "
            "rays, NaN rays %d, max abs err %.3e, max rel err %.3e -> %s"
            % (tag, wp, words, masks, int(torch.isnan(
                got[0][3][0] if wp else got[3][0]).sum()), err, rel,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("K10 %s path=%s" % (tag, wp))
        got = CD.trace_multi_df32(plans, state, with_path=wp)
        want = CD.trace_multi_df32_reference(plans, state, with_path=wp)
        res = [compare_df32(df32_pairs(g, wp), df32_pairs(w, wp))
               for g, w in zip(got, want)]
        words = sum(r[0] for r in res)
        masks, err, rel = (max(r[i] for r in res) for i in (1, 2, 3))
        ok = len(got) == len(plans) and masks == 0 and rel <= DF32_REL
        worst["trace_multi_df32"] = max(worst["trace_multi_df32"], err)
        log("K11 %s path=%s: differing words %d over %d plans, NaN masks "
            "differ on %d rays, max abs err %.3e, max rel err %.3e -> %s"
            % (tag, wp, words, len(plans), masks, err, rel,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("K11 %s path=%s" % (tag, wp))
        del got, want
    moms = [(CD.trace_merit_df32(steps, state),
             CD.trace_merit_df32_reference(steps, state))]
    moms += list(zip(CD.trace_merit_multi_df32(plans, state),
                     CD.trace_merit_multi_df32_reference(plans, state)))
    for i, (mg, mw) in enumerate(moms):
        name = "K12" if i == 0 else "K13 plan %d" % (i - 1)
        key = DF32_NAMES[2 if i == 0 else 3]
        _, rel, dcount = compare_moments(mg, mw, torch.float64, n)
        rg = float(spot_rms_from_moments(*mg))
        rw = float(spot_rms_from_moments(*mw))
        ok = dcount == 0 and rel <= DF32_REL
        worst[key] = max(worst[key], abs(rg - rw))
        log("%s %s: moments rel err %.3e, count %d (diff %d), spot RMS "
            "kernel %.15g plain %.15g -> %s"
            % (name, tag, rel, int(float(mw[0])), dcount, rg, rw,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("%s %s" % (name, tag))


@functools.lru_cache(maxsize=None)
def df32_newton_lenses():
    """{name: (system, table on the card, bundle function, the tables of
    its K11/K13 plans)} of the Newton lenses of the df32 checks: the
    aspheric double Gauss (its 3 wavelengths) and the odd singlet
    (asphere_stack), the three anamorphic lenses and the figured toroid
    and biconic (anam_stack: mu grown by 0, 1 and 2 %); built once."""
    from rayopt_tpu_torch.ops.tables import table_at
    out = {}
    for name, (s, table, _, _) in asphere_cases().items():
        bundle = bench_bundle if name == "aspheric double Gauss" \
            else singlet_bundle
        out[name] = (s, table, bundle, asphere_stack(name, s, table)[0])
    anam = {name: v[:2] for name, v in anamorphic_cases().items()}
    anam.update({name: v[:2]
                 for name, v in figured_anamorphic_cases().items()})
    for name, (s, table) in anam.items():
        out[name] = (s, table, anam_bundle, anam_stack(table)[0])
    return {name: (s, table, bundle, [table_at(tabs, li) for li in range(
        tabs.curvature.shape[0])]) for name, (s, table, bundle, tabs)
        in out.items()}


def phase_df32_check(s):
    """K10-K13 against their plain versions on the card: the double
    Gauss on the bench bundle (1.5x wide when clipped), fast and exact
    plans, the optical path off and on, K11/K13 at the 3 wavelengths;
    then every Newton lens (df32_newton_lenses: aspheric rows,
    cylinders, biconics and toroids, figured or not) on its own bench
    bundle the same way, with the path (the phase and freeform rows:
    phase_df32_phase_check, phase_df32_freeform_check).  The kernels
    round every float32 operation as the plain versions do, so their
    words should be identical (counted); moments are summed in another
    order."""
    from rayopt_tpu_torch.ops import df32 as D
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
            df32_check_case(tag, D.plan(table, clip=clip, fast=fast),
                            [D.plan(table_at(tabs, li), clip=clip, fast=fast)
                             for li in range(nlam)],
                            state, N_CHECK, worst, failures)
        del state
    for lens, (ls, ltab, bundle, ltabs) in df32_newton_lenses().items():
        log("== K10-K13 vs plain on the card: %s, %d bench rays (1.5x wide "
            "when clipped), K11/K13 on %d plans, with the path"
            % (lens, N_CHECK, len(ltabs)))
        state64 = bundle(N_CHECK, torch.float64, SEED)
        for clip in (False, True):
            state = df32_state(state64, 1.5 if clip else 1.)
            for fast in (True, False):
                tag = "%s clip=%s %s plan" % (lens, clip,
                                              "fast" if fast else "exact")
                df32_check_case(tag, D.plan(ltab, clip=clip, fast=fast),
                                [D.plan(t, clip=clip, fast=fast)
                                 for t in ltabs],
                                state, N_CHECK, worst, failures, (True,))
            del state
    if failures:
        raise AssertionError("df32 kernel disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def phase_split_check(s):
    """The wrappers' split of what one key cannot hold, on the card:
    K3, trace and merit, in both dtypes on stacks of N_SPLIT_K3
    wavelengths (past MAX_NLAM: balanced runs) against its plain
    version; K6 and K7 on float64 stacks of N_SPLIT_NLAM wavelengths (past
    MAX_NLAM: K6 in balanced runs, K7 in one launch) against their plain
    versions on the card, and glass.polychromatic_spot_rms(engine=
    "adjoint") on them (forward and backward) against the CPU plain
    versions; K11 and K13 on N_SPLIT_PLANS plans (past the kernel
    parameters: runs that fit) against theirs, word for word."""
    from rayopt_tpu_torch import glass
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import cuda_grad as CG
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops import cuda_trace as CT
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.parallel import bundles_from_system
    log("== split past one key (K3 at %s wavelengths, K6/K7 at %s, K11/K13 "
        "at %d plans, %d bench rays; the adjoint merit at 2048 hexapolar "
        "rays vs the CPU)" % (N_SPLIT_K3, N_SPLIT_NLAM, N_SPLIT_PLANS,
                              N_SPLIT))
    failures = []
    for nlam in N_SPLIT_K3:
        tabs = s.tables(split_wavelengths(nlam))
        specs = multi_specs(tabs, None)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            state = bench_bundle(N_SPLIT, dtype, SEED + 3)
            runs = {mode: CS.runs(nlam, CS.multi_most(kernel, specs, dtype))
                    for mode, kernel in (("trace", "k3"), ("merit", "k3m"))}
            before = CT.trace_multi.launches
            got = CT.trace_multi(tabs, specs, state)
            traced = CT.trace_multi.launches - before
            mom = CT.trace_multi(tabs, specs, state, merit=True)
            merited = CT.trace_multi.launches - before - traced
            want = CT.trace_multi_reference(tabs, specs, state)
            mref = CT.trace_multi_reference(tabs, specs, state, merit=True)
            torch.cuda.synchronize()
            res = [compare_final((*g[0], g[1]), (*r[0], r[1]), dtype)
                   for g, r in zip(got, want)]
            mres = [compare_moments(m, r, dtype, N_SPLIT)
                    for m, r in zip(mom, mref)]
            ok = (len(got) == len(mom) == nlam
                  and (traced, merited) == (len(runs["trace"]),
                                            len(runs["merit"]))
                  and all(r[0] and r[3] == 0 for r in res)
                  and all(m[0] for m in mres))
            log("K3 %s at %d wavelengths: trace %d launches (runs %s), max "
                "abs err %.3e, max rel err %.3e, NaN masks differ on %d rays "
                "| merit %d launches (runs %s), moments rel err max %.3e, "
                "counts differ %d -> %s"
                % (dt, nlam, traced, runs["trace"], max(r[1] for r in res),
                   max(r[2] for r in res), sum(r[3] for r in res), merited,
                   runs["merit"], max(m[1] for m in mres),
                   sum(abs(m[2]) for m in mres), "ok" if ok else "FAIL"))
            if not ok:
                failures.append("K3 %s at %d wavelengths" % (dt, nlam))
    state = bench_bundle(N_SPLIT, torch.float64, SEED + 3)
    w = bench_weights(N_SPLIT, torch.float64, SEED + 4)
    for nlam in N_SPLIT_NLAM:
        lams = split_wavelengths(nlam)
        tabs = s.tables(lams)
        specs = multi_specs(tabs, None)
        runs = CS.runs(nlam, CS.MAX_NLAM)
        before = (CG.weighted_moments_multi.launches,
                  CG.merit_adjoint_multi.launches)
        mom = CG.weighted_moments_multi(tabs, specs, state, w)
        mref = CG.weighted_moments_multi_reference(tabs, specs, state, w)
        ct = rms_cotangent(mref)
        pg, cst, cw = CG.merit_adjoint_multi(tabs, specs, state, w, ct)
        pr, sr, wr = CG.merit_adjoint_multi_reference(tabs, specs, state, w,
                                                      ct)
        torch.cuda.synchronize()
        launched = (CG.weighted_moments_multi.launches - before[0],
                    CG.merit_adjoint_multi.launches - before[1])
        rels = [compare_wmoments(mom[li], mref[li], torch.float64)
                for li in range(nlam)]
        grads = [compare_param_grads(pg[li], pr[li], GRAD_F64_REL)
                 for li in range(nlam)]
        ray_rel, masks, finite = compare_ray_grads(cst, cw, sr, wr)
        ok = (mom.shape == (nlam, 5) and launched == (len(runs), 1)
              and all(r[0] for r in rels) and finite and masks == 0
              and all(v[2] for f in grads for v in f.values())
              and ray_rel <= GRAD_F64_REL)
        log("K6 at %d wavelengths: %d launches (runs %s), moments rel err "
            "max %.3e | K7: %d launch, parameter cotangents max err %.3e, "
            "rays and weights rel err %.3e -> %s"
            % (nlam, launched[0], runs, max(r[1] for r in rels), launched[1],
               max(v[0] for f in grads for v in f.values()), ray_rel,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("K6/K7 at %d wavelengths" % nlam)
        # the user's entry point, card against CPU
        asg = glass.glass_assignment(s)
        nd0, vd0 = glass.initial_glass_params(s, asg[2])
        out = {}
        for dev in ("cpu", DEVICE):
            y0, u0, wb, _ = bundles_from_system(
                s, fields=(.7,), wavelengths=[s.wavelengths[0]], nrays=2048,
                distribution="hexapolar", device=dev)[0]
            nd = torch.tensor(nd0, device=dev, requires_grad=True)
            vd = torch.tensor(vd0, device=dev, requires_grad=True)
            v = glass.polychromatic_spot_rms(
                glass.glass_tables(s.tables(lams, device=dev), nd, vd, asg,
                                   lams), y0, u0, wb, engine="adjoint")
            v.backward()
            out[dev] = (float(v.detach()), nd.grad.cpu(), vd.grad.cpu())
        (vc, gnc, gvc), (vg, gng, gvg) = out["cpu"], out[DEVICE]
        rel = abs(vg - vc)/abs(vc)
        grel = max(float((g - r).abs().max())/float(r.abs().max())
                   for g, r in ((gng, gnc), (gvg, gvc)))
        ok = rel <= OPT_MERIT_REL and grel <= OPT_GRAD_REL
        log("polychromatic_spot_rms(engine=\"adjoint\") at %d wavelengths: "
            "merit card %.15g CPU %.15g (rel %.3e), (nd, vd) gradient err "
            "%.3e of its max -> %s" % (nlam, vg, vc, rel, grel,
                                       "ok" if ok else "FAIL"))
        if not ok:
            failures.append("polychromatic_spot_rms at %d wavelengths"
                            % nlam)
    plans = split_plans(s)
    st = df32_state(state)
    before = (CD.trace_multi_df32.launches,
              CD.trace_merit_multi_df32.launches)
    got = CD.trace_multi_df32(plans, st, with_path=True)
    want = CD.trace_multi_df32_reference(plans, st, with_path=True)
    res = [compare_df32(df32_pairs(g, True), df32_pairs(r, True))
           for g, r in zip(got, want)]
    moms = CD.trace_merit_multi_df32(plans, st)
    mrefs = CD.trace_merit_multi_df32_reference(plans, st)
    mres = [compare_moments(m, r, torch.float64, N_SPLIT)
            for m, r in zip(moms, mrefs)]
    launched = (CD.trace_multi_df32.launches - before[0],
                CD.trace_merit_multi_df32.launches - before[1])
    words = sum(r[0] for r in res)
    ok = (len(got) == len(moms) == N_SPLIT_PLANS and words == 0
          and max(r[1] for r in res) == 0
          and all(dc == 0 and rel <= DF32_REL for _, rel, dc in mres)
          and launched == tuple(len(CS.df32_runs(CS.df32_flags(plans), k))
                                for k in ("k11", "k13")))
    log("K11/K13 at %d plans: %s launches, differing words %d, NaN masks "
        "differ on %d rays, moments rel err max %.3e, counts differ %d -> %s"
        % (N_SPLIT_PLANS, launched, words, max(r[1] for r in res),
           max(m[1] for m in mres), sum(abs(m[2]) for m in mres),
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("K11/K13 at %d plans" % N_SPLIT_PLANS)
    if failures:
        raise AssertionError("split check failed: " + ", ".join(failures))


def phase_df32_path(s, aimed, lens="double Gauss"):
    """The parity-grade df32 path on a lens's aimed bundles: df32.plan
    (fast and exact) -> state_from_f64 on the card -> K10 with the
    optical path and K12; System.tables -> table_at -> one plan a
    wavelength -> K11 (with the path) and K13.  Each bundle's CPU
    float64 plain trace covers its first `n_ref` rays (all of them by
    default): K10's spot RMS there is held against it, K10's image
    positions against float64 K1 on the card (every ray), K12's moments
    of the whole bundle against the CPU (or, where the CPU covers a part,
    K10's spot RMS of the whole bundle); at the other wavelengths K11 is
    held on the first N_DF32_REF rays (at most n_ref) of each bundle,
    whose CPU traces cost a quarter of the full bundle's, and K13's
    moments of the whole bundle against the spot RMS of K11's whole
    output from the same call."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    from rayopt_tpu_torch.ops.geometric import trace_rays_final_multi
    from rayopt_tpu_torch.ops.tables import is_anamorphic, table_at
    table, tabs = s.table(), s.tables()
    nlam = tabs.curvature.shape[0]
    log("== parity-grade df32 path: %s, %d aimed rays per field -> df32.plan "
        "(fast and exact) -> state_from_f64 -> K10 (with the path), K12; "
        "System.tables -> %d plans -> K11, K13"
        % (lens, aimed[0]["y"].shape[0], nlam))
    plans = {fast: D.plan(table, fast=fast) for fast in (True, False)}
    lam_plans = [D.plan(table_at(tabs, li), fast=True) for li in range(nlam)]
    # the CPU float64 references of the other wavelengths (the first is
    # the main path's: System.table() traces wavelengths[0])
    tabs_cpu = s.tables(s.wavelengths[1:], device="cpu")
    failures = []
    for a in aimed:
        field = a["field"]
        n = a["y"].shape[0]
        n_ref = a.get("n_ref", n)
        ref = slice(0, n_ref)
        state = D.state_from_f64(a["y"], a["u"])
        for fast in (True, False):
            t0 = time.perf_counter()
            fin, path = CD.trace_final_df32(plans[fast], state,
                                            with_path=True)
            mom = CD.trace_merit_df32(plans[fast], state)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            xy = torch.stack([D.to_f64(fin[0]), D.to_f64(fin[1])], 1)
            uz = D.to_f64(fin[5])[:, None].expand(-1, 3)
            rms_all, _ = spot_rms(xy, uz)
            rms10, live = spot_rms(xy[ref], uz[ref])
            rms12 = float(spot_rms_from_moments(*mom))
            rms12_ref = a["rms_cpu"] if n_ref == n else rms_all
            good = torch.isfinite(a["y64"][:, 0])
            same = torch.equal(good, torch.isfinite(xy[:, 0]))
            pos = float((xy[good] - a["y64"][good, :2]).abs().max())
            path_ok = bool(torch.isfinite(D.to_f64(path)[good]).all())
            rel10 = abs(rms10 - a["rms_cpu"])/a["rms_cpu"]
            rel12 = abs(rms12 - rms12_ref)/rms12_ref
            # K12's moments carry E[x^2] - c^2: off axis (centroid ~1e6
            # spot RMS) their df32 precision is reported, not gated
            ok = (same and live == a["live_cpu"] and pos <= DF32_F64_ATOL
                  and path_ok and rel10 <= PARITY_REL
                  and (field != 0. or rel12 <= PARITY_REL))
            log("field %.1f %s plan: %d of the first %d rays live | K10 "
                "image positions vs f64 K1 max %.3e mm | spot RMS mm: CPU "
                "f64 %.15g | K10 %.15g (rel %.3e) | K12 %.15g (rel %.3e vs "
                "%s) | card %.3f s -> %s"
                % (field, "fast" if fast else "exact", live, n_ref, pos,
                   a["rms_cpu"], rms10, rel10, rms12, rel12,
                   "the CPU" if n_ref == n else "K10", t_gpu,
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
        sub = slice(0, min(N_DF32_REF, n_ref))
        t0 = time.perf_counter()
        ycpu, ucpu = a["y"][sub].cpu(), a["u"][sub].cpu()
        yh, uh, _ = trace_rays_final_multi(
            tabs_cpu, ycpu.expand(nlam - 1, -1, -1),
            ucpu.expand(nlam - 1, -1, -1), clip=False,
            biconic=is_anamorphic(tabs_cpu))
        cpu = [a["rms_cpu"]] + [spot_rms(yh[li], uh[li])[0]
                                for li in range(nlam - 1)]
        t_cpu = time.perf_counter() - t0
        del yh, uh
        for li, ((fin, path), mom) in enumerate(zip(outs, moms)):
            xy = torch.stack([D.to_f64(fin[0]), D.to_f64(fin[1])], 1)
            uz = D.to_f64(fin[5])[:, None].expand(-1, 3)
            rms11, live = spot_rms(xy, uz)
            rms13 = float(spot_rms_from_moments(*mom))
            # the first wavelength against the CPU on its reference rays
            # (and K13 too, where they are the whole bundle); the others
            # K11 against it on the first N_DF32_REF rays and K13
            # against K11's whole output
            rms_ref = spot_rms(xy[ref] if li == 0 else xy[sub],
                               uz[ref] if li == 0 else uz[sub])[0]
            rms13_ref = cpu[0] if li == 0 and n_ref == n else rms11
            rel11 = abs(rms_ref - cpu[li])/cpu[li]
            rel13 = abs(rms13 - rms13_ref)/rms13_ref
            ok = rel11 <= PARITY_REL and (field != 0. or rel13 <= PARITY_REL)
            log("field %.1f wavelength %d: %d of %d rays live | spot RMS "
                "mm: K11 %.15g | K13 %.15g (rel %.3e vs %s) | %s: CPU f64 "
                "%.15g, K11 %.15g (rel %.3e) -> %s"
                % (field, li, live, n, rms11, rms13, rel13,
                   "the CPU" if rms13_ref is cpu[0] else "K11",
                   "the first %d rays" % (n_ref if li == 0 else sub.stop),
                   cpu[li], rms_ref, rel11, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("field %.1f wavelength %d" % (field, li))
        log("field %.1f: K11 + K13 card %.3f s, CPU f64 trace of %d "
            "wavelengths at %d rays %.2f s" % (field, t_gpu, nlam - 1,
                                               sub.stop, t_cpu))
        del outs, moms, state
    if failures:
        raise AssertionError("df32 path parity failed on the %s at %s"
                             % (lens, ", ".join(failures)))


def newton_df32_path(s, aimed, lens):
    """A Newton lens's df32 path (phase_df32_path on the aimed bundles
    of its own path), its launches counted from a reset just before it
    and read just after; every kernel of it must have launched."""
    reset_launches()
    phase_df32_path(s, aimed, lens)
    counts = read_launches()
    log("== launch counts on the %s's df32 path: %s" % (lens, counts))
    if not all(counts[k] for k in DF32_NAMES):
        raise AssertionError("a kernel of the %s's df32 path never "
                             "launched: %s" % (lens, counts))
    return counts


# -- the rot cotangent: pose gradients through K5, K7 and K9 ------------

POSE_SELECT = ("tilt", "decenter")
#: the table fields POSE_SELECT moves: the slot set of the pose loops'
#: K5, K7 and K9 (rot keys)
POSE_FIELDS = ("offset", "rot")
#: the alignment loop's manufacturing error on the double Gauss: row 3's
#: tilt (rad) and row 9's decenter (mm), baked into the table
#: (tables.lower_pose); the loop moves every row's tilt and decenter from
#: zero, its step-0 merit at least POSE_HURT times the nominal lens's on
#: the same bundles (the reference's test_alignment_compensation)
POSE_ERROR = {"tilt": (3, (4e-3, -2e-3, 0.)), "decenter": (9, (.04, -.02, 0.))}
POSE_HURT = 1.5
POSE_LR = 1e-4       # Adam on tilt (rad) and decenter (mm): the merit falls
#                      at every step on the CPU (2000 nrays a bundle)
POSE_STEPS = 10
N_POSE = 1 << 18     # rays of the pose checks
POSE_FD_STEP = 1e-6  # central differences: rad of tilt, mm of decenter
POSE_FD_REL = 1e-6
#: (field, row, component) of the double Gauss's central differences: an
#: interior tilt, the image row's tilt (its two uses of the rotation in
#: K5 and K7, the sphere tail's in K9), two decenters
POSE_FD_PICKS = (("tilt", 3, 1), ("tilt", 12, 0), ("decenter", 9, 0),
                 ("decenter", 5, 1))
#: the image row's tilt on every pose case (rad)
POSE_IMAGE_TILT = (1e-3, 2e-3, 0.)


def pose_lenses():
    """{name: (build, {row: tilt}, {row: decenter}, bench bundle, with
    every pose live, float32 held)} of the pose checks: a tilted and
    decentred sphere (the double Gauss, with_pose: the loops' specs), a
    tilted conic and asphere (the aspheric double Gauss), a tilted
    biconic and toroid, a tilted DOE (the hybrid achromat) and grating
    (the spectrograph), the tilted freeform plate of the figured Schmidt
    corrector; the image row tilted on each.  The spectrograph's float32
    K5 and K7 are logged, not held (its 56-85 mm off-axis centroid
    cancels the moment formula's float32 digits, phase_grating_check),
    and so is the Schmidt plates' float32 K9 (phase_opd_check's
    hold_f32_k9)."""
    from rayopt_tpu_torch.models import (double_gauss, hybrid_achromat,
                                         spectrograph)
    img = POSE_IMAGE_TILT
    return {
        "posed double Gauss": (double_gauss, {3: (4e-3, -2e-3, 0.), 12: img},
                               {9: (.04, -.02, 0.)}, opd_bundle, True,
                               (True, True)),
        "posed aspheric double Gauss": (
            aspheric_double_gauss, {ASPH_ROW: (3e-3, -1e-3, 0.),
                                    2: (2e-3, 1e-3, 0.), 12: img},
            {5: (.03, .02, 0.)}, opd_bundle, False, (True, True)),
        "posed biconic": (split_biconic, {1: (8e-3, -5e-3, 0.), 3: img},
                          {1: (.05, -.03, 0.)}, anam_opd_bundle, False,
                          (True, True)),
        "posed toroid lens": (toroid_lens, {1: (6e-3, 4e-3, 0.), 3: img},
                              {2: (.04, .02, 0.)}, anam_opd_bundle, False,
                              (True, True)),
        "posed hybrid achromat": (
            hybrid_achromat, {2: (5e-3, -3e-3, 0.), 3: img},
            {1: (.03, 0., 0.)}, phase_bundle_of(6.), False, (True, True)),
        "posed spectrograph": (spectrograph, {1: (2e-3, -1e-3, 0.),
                                              2: img}, {},
                               phase_bundle_of(10.), False, (False, True)),
        "posed Schmidt corrector": (
            lambda: schmidt_corrector(SCHMIDT_FIGURE),
            {1: (4e-3, -3e-3, 0.), 4: img}, {1: (.1, -.05, 0.)},
            freeform_bundle_of(17.), False, (True, False))}


def posed(table, tilts, decs):
    """The table (or stack) with the given rows' tilt and decenter folded
    into its rot and offset (tables.lower_pose)."""
    from rayopt_tpu_torch.ops.tables import lower_pose
    shape = table.offset.shape
    t = torch.zeros(shape[-2:], dtype=torch.float64)
    d = torch.zeros_like(t)
    for j, v in tilts.items():
        t[j] = torch.tensor(v, dtype=torch.float64)
    for j, v in decs.items():
        d[j] = torch.tensor(v, dtype=torch.float64)
    dev = table.offset.device
    return lower_pose(table.replace(tilt=t.expand(shape).to(dev),
                                    decenter=d.expand(shape).to(dev)))


def pose_cases():
    """{name: (system, posed table on the card, its specs, posed stack of
    three tables, its specs, bundle, float32 held (K5/K7, K9))} of
    pose_lenses: the stack is the system's three wavelength tables, or
    for a lens of one glass its table with mu grown by 0, 1 and 2 % of
    mu - 1 (anam_stack) or at 1, 0.9 and 1.1 times its wavelength
    (phase_stack), each posed alike."""
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.ops.kernels import specialize, with_pose
    out = {}
    for name, (build, tilts, decs, bundle, live, hold) in \
            pose_lenses().items():
        s = build()
        if name in ("posed biconic", "posed toroid lens"):
            tabs = anam_stack(s.table())[0]
        elif name in ("posed hybrid achromat", "posed spectrograph"):
            tabs = phase_stack(s)[0]
        else:
            tabs = s.tables()
        table, tabs = posed(s.table(), tilts, decs), posed(tabs, tilts, decs)
        specs, mspecs = specialize(table), multi_specs(tabs, None)
        if live:
            specs, mspecs = with_pose(specs), with_pose(mspecs)
        out[name] = (s, table, specs, tabs, mspecs, bundle, hold)
    return out


def pose_keys(cases=None):
    """{tag: key} of the pose phases: the K5, K7 and K9 rot keys (every
    field and rot, with the ray cotangents; float64 and float32, clip off
    and on) of each pose case, with the K8 keys that give K9 its
    cotangents; on the posed double Gauss the forward keys K2 (the live
    rays of the timings, its table and its stack's specs), K4, K6 (3
    wavelengths) and K8 and the loops' rot keys (POSE_FIELDS, no ray
    cotangents) beside their twins without rot, in both dtypes; and the
    pose path's (the double Gauss with every pose live and row 3's tilt
    and row 9's decenter baked in, float64)."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_trace import (doe_width, figure_widths,
                                                 multi_specs, xy_width)
    from rayopt_tpu_torch.ops.kernels import specialize, with_pose
    cases = cases or pose_cases()
    keys = {}
    every, every9 = CS.FIELDS + ("rot",), CS.OPD_DIFF + ("rot",)
    for name, (s, table, specs, tabs, mspecs, _, _) in cases.items():
        kw = dict(widths=figure_widths(table, specs),
                  nd=doe_width(table, specs), nxy=xy_width(table, specs))
        mkw = dict(widths=figure_widths(tabs, mspecs),
                   nd=doe_width(tabs, mspecs), nxy=xy_width(tabs, mspecs))
        for dtype in (torch.float32, torch.float64):
            for clip in (False, True):
                tag = "%%s %s %s clip=%s rot" % (name, str(dtype)[6:], clip)
                keys[tag % "K5"] = CS.adjoint_key(specs, dtype, clip, every,
                                                  **kw)
                keys[tag % "K7"] = CS.adjoint_multi_key(mspecs, dtype, clip,
                                                        every, **mkw)
                keys[tag % "K9"] = CS.opd_adjoint_key(specs, dtype, clip,
                                                      every9, **kw)
                keys[tag % "K8"] = CS.opd_key(specs, dtype, clip, **kw)
    _, table, specs, tabs, mspecs, _, _ = cases["posed double Gauss"]
    s = double_gauss()
    err = posed(s.table(), *pose_error())
    errs = posed(s.tables(), *pose_error())
    pspecs = with_pose(specialize(err))
    pmspecs = with_pose(multi_specs(errs, None))
    loop = POSE_FIELDS
    twin = POSE_FIELDS[:-1]
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        for lens, sp, msp in (("posed double Gauss", specs, mspecs),
                              ("pose path", pspecs, pmspecs)):
            keys["K2 %s %s" % (lens, dt)] = CS.merit_key(sp, dtype)
            keys["K2 %s %s stack" % (lens, dt)] = CS.merit_key(msp, dtype)
            keys["K4 %s %s" % (lens, dt)] = CS.moments_key(sp, dtype)
            keys["K6 %s %s nlam=3" % (lens, dt)] = CS.moments_multi_key(
                msp, dtype, False, 3)
            keys["K8 %s %s" % (lens, dt)] = CS.opd_key(sp, dtype)
            for fields, what in ((loop, "rot"), (twin, "twin")):
                keys["K5 %s %s loop %s" % (lens, dt, what)] = \
                    CS.adjoint_key(sp, dtype, False, fields, False)
                keys["K7 %s %s loop %s" % (lens, dt, what)] = \
                    CS.adjoint_multi_key(msp, dtype, False, fields, False)
                keys["K9 %s %s loop %s" % (lens, dt, what)] = \
                    CS.opd_adjoint_key(sp, dtype, False, fields, False)
    return keys


def pose_error():
    """({row: tilt}, {row: decenter}) of POSE_ERROR."""
    (tr, tv), (dr, dv) = POSE_ERROR["tilt"], POSE_ERROR["decenter"]
    return {tr: tv}, {dr: dv}


def pose_columns(got, want, rel, floor):
    """(worst error of a column over its held scale, ok): each parameter
    column (the last axis) against its largest plain value, floored at
    `floor` of the key's largest; a column at zero must be exactly
    zero."""
    g, w = got.double(), want.double()
    dims = tuple(range(w.dim() - 1))
    scale = w.abs().amax(dim=dims)
    err = (g - w).abs().amax(dim=dims)
    top = float(scale.max())
    held = torch.where(scale > 0, torch.clamp(scale, min=floor*top),
                       torch.zeros_like(scale))
    ok = bool(torch.isfinite(g).all()) and bool((err <= rel*held).all())
    worst = float(torch.where(held > 0, err/torch.where(held > 0, held, 1.),
                              torch.where(err > 0, float("inf"), 0.)).max())
    return worst, ok


def pose_groups(table, specs, nq, k9=False):
    """K5's (K9's: `k9`) parameter columns of a table grouped by field
    ((name, column indices) of the nq columns, a rot key's rotation
    last: the groups compare_param_grads holds float32 to)."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import _table_widths
    from rayopt_tpu_torch.ops.cuda_trace import doe_width, xy_width
    na, no = _table_widths(table)
    head = CS.SLOT_FIELDS if k9 else CS.SLOT_FIELDS[:CS.SLOTS]
    phase = (CS._opd_phase if k9 else CS._phase)(specs, doe_width(table,
                                                                  specs))
    cols = (head + ("aspherics",)*na + ("aspherics_odd",)*no
            + CS._anamorphic(specs) + phase
            + ("xy_poly",)*xy_width(table, specs))
    cols = cols + ("rot",)*(nq - len(cols))
    groups = {}
    for q, f in enumerate(cols):
        groups.setdefault(f, []).append(q)
    return tuple(groups.items())


def pose_f32_groups(got, want, groups, rel, mass=None):
    """(worst error over its held scale, ok) of float32 parameter
    cotangents by field group: each held to its largest plain value
    floored at COLUMN_FLOOR of the largest group's (compare_param_grads),
    or with `mass` to that of the sums of |term|."""
    base = want if mass is None else mass
    scales = [float(base[..., c].double().abs().max()) for _, c in groups]
    top = max(scales)
    worst, ok = 0., bool(torch.isfinite(got).all())
    for (_, c), sc in zip(groups, scales):
        e = float((got[..., c].double() - want[..., c].double()).abs().max())
        held = max(sc, COLUMN_FLOOR*top) if mass is None else sc
        if held:
            worst = max(worst, e/held)
            ok = ok and e <= rel*held
        else:
            ok = ok and e == 0.
    return worst, ok


def phase_pose_check(cases):
    """The K5, K7 and K9 rot keys (every field and rot, with the ray
    cotangents) against their plain versions on the card, at N_POSE rays
    of each pose case's bench bundle (ray 0 the chief ray; 1.5x wide
    clipped), clip off and on: float64 each slot column within
    GRAD_F64_REL of its largest plain value, floored at COLUMN_FLOOR
    (K9: OPD_COLUMN_FLOOR) of the key's largest, the ray cotangents
    within GRAD_F64_REL; float32 by field group, K5 and K7 within
    GRAD_F32_REL of the float32 plain version (compare_param_grads), K9
    within OPD_F32_SUM_REL of the float64 plain version's sums of |term|
    (phase_opd_check).  Returns the float32 errors."""
    from rayopt_tpu_torch.ops import cuda_spec as CS
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        merit_adjoint_reference, opd_adjoint, opd_adjoint_reference,
        opd_chain, weighted_moments_multi_reference,
        weighted_moments_reference)
    every, every9 = CS.FIELDS + ("rot",), CS.OPD_DIFF + ("rot",)
    worst = {"merit_adjoint": 0., "merit_adjoint_multi": 0.,
             "opd_adjoint": 0.}
    failures = []
    log("== K5/K7/K9 rot keys vs plain on the card (every field and rot, "
        "with the ray cotangents; %d rays; float64 a slot column within "
        "%g of its largest, floored at %g (K9 %g) of the key's largest)"
        % (N_POSE, GRAD_F64_REL, COLUMN_FLOOR, OPD_COLUMN_FLOOR))
    for name, (s, table, specs, tabs, mspecs, bundle, hold) in \
            cases.items():
        rotated = [j for j, sp in enumerate(specs) if j and sp.rotated]
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            for clip in (False, True):
                tag = "%s %s clip=%s" % (name, str(dtype)[6:], clip)
                state = bundle(N_POSE, dtype, SEED, 1.5 if clip else 1.)
                w = bench_weights(N_POSE, dtype, SEED + 2)
                # K5
                ct = rms_cotangent(weighted_moments_reference(
                    table, specs, state, w, clip))
                pg, cst, cw = merit_adjoint(table, specs, state, w, ct, clip,
                                            fields=every)
                pr, sr, wr = merit_adjoint_reference(table, specs, state, w,
                                                     ct, clip, rot=True)
                # K7
                mct = rms_cotangent(weighted_moments_multi_reference(
                    tabs, mspecs, state, w, clip))
                pm, mst, mw = merit_adjoint_multi(tabs, mspecs, state, w,
                                                  mct, clip, fields=every)
                pmr, msr, mwr = merit_adjoint_multi_reference(
                    tabs, mspecs, state, w, mct, clip, rot=True)
                # K9, the wavefront RMS's cotangents
                aux = opd_aux(s, table, specs, state)
                k, lx, ly = opd_chain(table, specs, state, aux, clip)
                cts = opd_cotangents(k, lx, ly, "wavefront")
                po, ost, oc = opd_adjoint(table, specs, state, aux, cts,
                                          clip, fields=every9)
                torch.cuda.synchronize()
                nq, nq9 = pg.shape[-1], po.shape[-1]
                rot_live = bool(pr[rotated][:, nq - CS.ROT:].abs().max() > 0
                                and pmr[:, rotated][..., nq - CS.ROT:]
                                .abs().max() > 0)
                if f64:
                    por, osr, ocr = opd_adjoint_reference(
                        table, specs, state, aux, cts, clip, rot=True)
                    e5, ok5 = pose_columns(pg, pr, GRAD_F64_REL,
                                           COLUMN_FLOOR)
                    e7, ok7 = pose_columns(pm, pmr, GRAD_F64_REL,
                                           COLUMN_FLOOR)
                    e9, ok9 = pose_columns(po, por, GRAD_F64_REL,
                                           OPD_COLUMN_FLOOR)
                    r5 = compare_ray_grads(cst, cw, sr, wr)
                    r7 = compare_ray_grads(mst, mw, msr, mwr)
                    ray9 = max(float((a - b).abs().max())
                               / max(float(b.abs().max()), 1e-300)
                               for a, b in zip(ost, osr))
                    cen = float((oc - ocr).abs().max()) \
                        / max(float(ocr.abs().max()), 1e-300)
                    ok5 = ok5 and r5[0] <= GRAD_F64_REL and not r5[1]
                    ok7 = ok7 and r7[0] <= GRAD_F64_REL and not r7[1]
                    ok9 = (ok9 and ray9 <= GRAD_F64_REL
                           and cen <= GRAD_F64_REL)
                    log("%s: K5 columns %.3e, rays %.3e; K7 columns %.3e, "
                        "rays %.3e; K9 columns %.3e, rays %.3e, centre "
                        "%.3e (of the held scales); rot slots live on rows "
                        "%s: %s -> %s"
                        % (tag, e5, r5[0], e7, r7[0], e9, ray9, cen,
                           rotated, rot_live, "ok" if ok5 and ok7 and ok9
                           and rot_live else "FAIL"))
                    held = (True, True)
                else:
                    e5, ok5 = pose_f32_groups(pg, pr, pose_groups(
                        table, specs, nq), GRAD_F32_REL)
                    e7, ok7 = pose_f32_groups(pm, pmr, pose_groups(
                        tabs, mspecs, nq), GRAD_F32_REL)
                    s64 = tuple(c.double() for c in state)
                    a64 = aux.double()
                    c64 = tuple(c.double() for c in cts)
                    base = opd_adjoint_reference(table, specs, s64, a64, c64,
                                                 clip, rot=True)[0]
                    mass = opd_adjoint_reference(
                        table, specs, s64, a64, tuple(c.abs() for c in c64),
                        clip, rot=True)[0]
                    e9, ok9 = pose_f32_groups(po, base, pose_groups(
                        table, specs, nq9, True), OPD_F32_SUM_REL, mass)
                    held = hold
                    log("%s: K5 %.3e, K7 %.3e of GRAD_F32_REL's scales "
                        "(%s); K9 %.3e of the sums of |term| (%s) -> %s"
                        % (tag, e5, e7, "held" if hold[0] else "not held",
                           e9, "held" if hold[1] else "not held",
                           "ok" if (ok5 and ok7 or not hold[0])
                           and (ok9 or not hold[1]) else "FAIL"))
                    # the held keys' absolute errors, for the kernels
                    # line
                    for kname, got, want, h in (
                            ("merit_adjoint", pg, pr, hold[0]),
                            ("merit_adjoint_multi", pm, pmr, hold[0]),
                            ("opd_adjoint", po, base, hold[1])):
                        if h:
                            worst[kname] = max(worst[kname], float(
                                (got.double() - want.double()).abs().max()))
                if not ((ok5 and ok7) or not held[0]):
                    failures.append("K5/K7 " + tag)
                if not (ok9 or not held[1]):
                    failures.append("K9 " + tag)
                if f64 and not rot_live:
                    failures.append("rot slots %s" % tag)
                del state, w
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("a rot key disagrees with its plain version: "
                             + ", ".join(failures))
    return worst


def phase_pose_fd_check(cases):
    """On the posed double Gauss, float64, N_POSE rays, against central
    differences (step POSE_FD_STEP) of the forward kernels' merits at
    POSE_FD_PICKS: d/d(tilt, decenter) of K5 (the spot RMS of K4's
    moments), K7 (the union spot RMS of K6's) and K9 (the wavefront RMS
    of K8's k, ray 0 the chief ray), each through autograd of
    tables.lower_pose, within POSE_FD_REL."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        adjoint_wavefront_rms, spot_moments, spot_moments_multi,
        union_spot_rms_from_moments, wavefront_rms_of, weighted_moments,
        weighted_moments_multi, opd_chain)
    from rayopt_tpu_torch.ops.cuda_trace import spot_rms_from_moments
    s, table, specs, tabs, mspecs, bundle, _ = cases["posed double Gauss"]
    nsurf, nlam = table.curvature.shape[0], tabs.curvature.shape[0]
    state = bundle(N_POSE, torch.float64, SEED)
    w = bench_weights(N_POSE, torch.float64, SEED + 2)
    y0 = torch.stack(state[:3], 1)
    u0 = torch.stack(state[3:], 1)
    aux = opd_aux(s, table, specs, state)
    kw = dict(ref=0, radius=float(aux[3]), wavelength=s.wavelengths[0],
              scale=s.scale, finite=s.object.finite)
    zero = torch.zeros((nsurf, 3), dtype=torch.float64, device=DEVICE)

    def merits(tilt, dec):
        tb = table.replace(tilt=tilt, decenter=dec)
        tbs = tabs.replace(tilt=tilt.expand(nlam, -1, -1),
                           decenter=dec.expand(nlam, -1, -1))
        return {"K5": lambda: spot_rms_from_moments(*spot_moments(
                    tb, state, w, specs=specs)),
                "K7": lambda: union_spot_rms_from_moments(
                    spot_moments_multi(tbs, state, w/nlam, specs=mspecs)),
                "K9": lambda: adjoint_wavefront_rms(tb, y0, u0, w,
                                                    specs=specs, **kw)}

    def forward(tilt, dec):
        from rayopt_tpu_torch.ops.tables import lower_pose
        tb = lower_pose(table.replace(tilt=tilt, decenter=dec))
        tbs = lower_pose(tabs.replace(tilt=tilt.expand(nlam, -1, -1),
                                      decenter=dec.expand(nlam, -1, -1)))
        # the sphere centre follows the chief ray's image point
        k = opd_chain(tb, specs, state, opd_aux(s, tb, specs, state))[0]
        return {"K5": float(spot_rms_from_moments(*weighted_moments(
                    tb, specs, state, w))),
                "K7": float(union_spot_rms_from_moments(
                    weighted_moments_multi(tbs, mspecs, state, w/nlam))),
                "K9": float(wavefront_rms_of(k - k[0], w))}
    log("== K5/K7/K9 rot keys vs central differences of the K4/K6/K8 "
        "merits (posed double Gauss, float64, %d rays; step %g rad of tilt, "
        "%g mm of decenter; held to %g)" % (N_POSE, POSE_FD_STEP,
                                            POSE_FD_STEP, POSE_FD_REL))
    grads = {}
    for kname in ("K5", "K7", "K9"):
        tilt = zero.clone().requires_grad_()
        dec = zero.clone().requires_grad_()
        merits(tilt, dec)[kname]().backward()
        grads[kname] = {"tilt": tilt.grad, "decenter": dec.grad}
    failures = []
    for field, row, comp in POSE_FD_PICKS:
        side = []
        for sgn in (1., -1.):
            v = zero.clone()
            v[row, comp] = sgn*POSE_FD_STEP
            side.append(forward(v, zero) if field == "tilt"
                        else forward(zero, v))
        for kname in ("K5", "K7", "K9"):
            fd = (side[0][kname] - side[1][kname])/(2*POSE_FD_STEP)
            g = float(grads[kname][field][row, comp])
            rel = abs(g - fd)/abs(fd)
            ok = rel <= POSE_FD_REL
            log("%s d/d %s[%d, %d]: adjoint %.12g, central difference "
                "%.12g, rel %.2e -> %s" % (kname, field, row, comp, g, fd,
                                           rel, "ok" if ok else "FAIL"))
            if not ok:
                failures.append("%s %s[%d, %d]" % (kname, field, row, comp))
    for kname in ("K5", "K7", "K9"):
        if float(grads[kname]["tilt"][0].abs().max()) != 0.:
            failures.append("%s row 0's tilt gradient" % kname)
    if failures:
        raise AssertionError("a rot key disagrees with central differences: "
                             + ", ".join(failures))


def read_rot_launches():
    """The rot keys' launches of the three adjoints (their wrappers'
    rot_launches), counted from 0 at reset_launches."""
    from rayopt_tpu_torch.ops import cuda_grad
    return {fn.__name__: fn.rot_launches for fn in (
        cuda_grad.merit_adjoint, cuda_grad.merit_adjoint_multi,
        cuda_grad.opd_adjoint)}


def reset_rot_launches():
    from rayopt_tpu_torch.ops import cuda_grad
    for fn in (cuda_grad.merit_adjoint, cuda_grad.merit_adjoint_multi,
               cuda_grad.opd_adjoint):
        fn.rot_launches = 0


def phase_pose_path(base_steps, bundles):
    """The pose path on the double Gauss at full width, through the
    entry points a user calls, every K5/K7/K9 launch under a rot key:
    (a) the alignment-compensation loop: POSE_ERROR baked into the table
    (tables.lower_pose), the optimizer path's 9 bundles (3 fields x 3
    wavelengths, N_OPT_BUNDLE rays, float64), optimize_grad(select=
    POSE_SELECT, engine="adjoint") for POSE_STEPS Adam steps at POSE_LR
    (K4, K5); its step-0 merit at least POSE_HURT times the nominal
    table's on the same bundles, the merit falling at every step; (b) one
    achromatization step: the union polychromatic merit
    (polychromatic_spot_rms, K6/K7) at the 3 fields over tilt and
    decenter of the perturbed stack, every pose live; (c) one design step:
    9 spot bundles (K4/K5) and 3 wavefront bundles (K8/K9) over tilt and
    decenter.  Each step 0 held against the CPU plain versions at
    N_LOOP_CHECK nrays a bundle (step0_cross_check).  `base_steps`: the
    optimizer, achromatization and design paths' later-step seconds;
    `bundles`: their bundles (the same nominal lens: no aiming again).
    Returns (launches, rot launches, {loop: later-step seconds})."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_grad import (
        adjoint_spot_rms, adjoint_wavefront_rms, polychromatic_spot_rms)
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs
    from rayopt_tpu_torch.ops.kernels import specialize, with_pose
    from rayopt_tpu_torch.parallel import (bundles_from_system, bundles_to,
                                           composite_merit, optimize_grad)
    spot, gb, db = bundles
    s = double_gauss()
    fields = FIELDS
    table0 = s.table()
    err = posed(table0, *pose_error())
    errs = posed(s.tables(), *pose_error())
    specs = with_pose(specialize(err))
    mspecs = with_pose(multi_specs(errs, None))
    failures, steps = [], {}
    log("== pose path: double Gauss, row %d tilted %s rad and row %d "
        "decentred %s mm (baked into the table); every pose live "
        "(kernels.with_pose), float64, Adam at lr %g over %s"
        % (POSE_ERROR["tilt"][0], POSE_ERROR["tilt"][1],
           POSE_ERROR["decenter"][0], POSE_ERROR["decenter"][1], POSE_LR,
           POSE_SELECT))

    def spot_bundles(nrays):
        return bundles_from_system(s, fields=fields, nrays=nrays,
                                   distribution="hexapolar")
    log("(a) alignment loop: the optimizer path's %d bundles of %d rays"
        % (len(spot), spot[0][0].shape[0]))

    def nominal(tab, bundles):
        with torch.no_grad():
            return float(sum(adjoint_spot_rms(
                tab.replace(**{k: v.to(tab.curvature.device)
                               for k, v in ch.items() if k != "wavelength"}),
                y0, u0, w, specs=specs) for y0, u0, w, ch in bundles))
    m_nom = nominal(table0, spot)

    def step0_a(device, b):
        grads = {}
        _, (merit,) = optimize_grad(err.to(device=device),
                                    bundles_to(b, device),
                                    select=POSE_SELECT, steps=1, lr=POSE_LR,
                                    engine="adjoint",
                                    callback=step0_grads(grads))
        return merit, grads
    grads0, ends = {}, []
    reset_launches()
    reset_rot_launches()
    t0 = time.perf_counter()
    tab_fix, hist = optimize_grad(err, spot, select=POSE_SELECT,
                                  steps=POSE_STEPS, lr=POSE_LR,
                                  engine="adjoint",
                                  callback=step0_grads(grads0, ends))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    st = np.diff([t0] + ends[:POSE_STEPS])
    steps["alignment"] = float(st[1:].mean())
    log("merit history (sum of %d spot RMS, mm): %s | nominal lens %.12g, "
        "step 0 / nominal %.4f | card %.2f s for %d steps (step 0 %.3f s, "
        "later steps mean %.4f s)"
        % (len(spot), " ".join("%.12g" % v for v in hist), m_nom,
           hist[0]/m_nom, t_card, POSE_STEPS, st[0], st[1:].mean()))
    log("compensating tilt (rad) by row: %s" % " ".join(
        "%d:(%.3g, %.3g)" % (j, float(v[0]), float(v[1]))
        for j, v in enumerate(tab_fix.tilt.detach().cpu())))
    _, fa = step0_cross_check(step0_a, (hist[0], grads0), spot,
                              spot_bundles, N_LOOP_CHECK)
    failures += ["(a) " + f for f in fa]
    if not hist[0] >= POSE_HURT*m_nom:
        failures.append("(a) the error hurts by %.3fx only" % (hist[0]/m_nom))
    if not all(b < a for a, b in zip(hist[:-1], hist[1:])):
        failures.append("(a) the merit did not fall at every step")
    launches = read_launches()
    rot = read_rot_launches()
    log("== launch counts on the alignment loop: %s, rot keys %s"
        % (launches, rot))
    # (b) one achromatization step
    def glass_bundles(nrays):
        return bundles_from_system(s, fields=fields,
                                   wavelengths=[s.wavelengths[0]],
                                   nrays=nrays, distribution="hexapolar")
    log("(b) achromatization step: the union polychromatic merit over %d "
        "wavelengths at fields %s, the achromatization path's %d bundles "
        "of %d rays" % (errs.curvature.shape[0], fields, len(gb),
                        gb[0][0].shape[0]))
    nlam = errs.curvature.shape[0]

    def poly(tabs, bundles):
        def merit(tab):
            tb = tabs.replace(tilt=tab.tilt.expand(nlam, -1, -1),
                              decenter=tab.decenter.expand(nlam, -1, -1))
            return sum(polychromatic_spot_rms(tb, y0, u0, w, specs=mspecs)
                       for y0, u0, w, _ in bundles)
        return merit

    def one_step(device, tab, merit, b):
        grads = {}
        _, (value,) = optimize_grad(tab.to(device=device), b,
                                    select=POSE_SELECT, steps=1, lr=POSE_LR,
                                    merit=merit, callback=step0_grads(grads))
        return value, grads
    reset_launches()
    reset_rot_launches()
    grads0, ends = {}, []
    t0 = time.perf_counter()
    _, h = optimize_grad(err, gb, select=POSE_SELECT, steps=2, lr=POSE_LR,
                         merit=poly(errs, gb),
                         callback=step0_grads(grads0, ends))
    torch.cuda.synchronize()
    steps["achromatization"] = float(ends[1] - ends[0])
    log("merit (sum of %d union spot RMS, mm) before and after one step: "
        "%s | card: step 0 %.3f s, step 1 %.4f s"
        % (len(gb), " ".join("%.12g" % v for v in h), ends[0] - t0,
           steps["achromatization"]))
    glass_launches = read_launches()
    glass_rot = read_rot_launches()

    def step0_b(dev, b):
        bb = bundles_to(b, dev)
        return one_step(dev, err, poly(errs.to(device=dev), bb), bb)
    _, fb = step0_cross_check(step0_b, (h[0], grads0), gb, glass_bundles,
                              N_LOOP_CHECK)
    failures += ["(b) " + f for f in fb]
    if not h[1] < h[0]:
        failures.append("(b) the merit did not fall")
    log("== launch counts on the achromatization step: %s, rot keys %s"
        % (glass_launches, glass_rot))
    # (c) one design step
    def design_bundles(nrays):
        return (bundles_from_system(s, fields=fields, nrays=nrays,
                                    distribution="hexapolar"),
                bundles_from_system(s, fields=fields,
                                    wavelengths=[s.wavelengths[0]],
                                    nrays=nrays, distribution="hexapolar"))
    log("(c) design step: the design path's %d spot and %d wavefront "
        "bundles of %d rays" % (len(db[0]), len(db[1]),
                                db[0][0][0].shape[0]))
    opd_kw = dict(ref=0, radius=-s.image.pupil.distance,
                  wavelength=s.wavelengths[0], scale=s.scale,
                  finite=s.object.finite, specs=specs)

    def design_merit(b):
        spot_b, wave_b = b

        def spots(tab):
            return sum(adjoint_spot_rms(tab.replace(**{
                k: v.to(tab.curvature.device) for k, v in ch.items()
                if k != "wavelength"}), y0, u0, w, specs=specs)
                for y0, u0, w, ch in spot_b)

        def wavefronts(tab):
            return sum(adjoint_wavefront_rms(tab, y0, u0, w, **opd_kw)
                       for y0, u0, w, _ in wave_b)
        return composite_merit(spots, wavefronts)
    reset_launches()
    reset_rot_launches()
    grads0, ends = {}, []
    t0 = time.perf_counter()
    _, h = optimize_grad(err, db[0], select=POSE_SELECT, steps=2,
                            lr=POSE_LR, merit=design_merit(db),
                            callback=step0_grads(grads0, ends))
    torch.cuda.synchronize()
    steps["design"] = float(ends[1] - ends[0])
    log("merit (%d spot RMS mm + %d wavefront RMS waves) before and after "
        "one step: %s | card: step 0 %.3f s, step 1 %.4f s"
        % (len(db[0]), len(db[1]), " ".join("%.12g" % v for v in h),
           ends[0] - t0, steps["design"]))
    design_launches = read_launches()
    design_rot = read_rot_launches()

    def step0_c(dev, b):
        bb = tuple(bundles_to(x, dev) for x in b)
        return one_step(dev, err, design_merit(bb), bb[0])
    _, fc = step0_cross_check(step0_c, (h[0], grads0), db, design_bundles,
                              N_LOOP_CHECK)
    failures += ["(c) " + f for f in fc]
    if not h[1] < h[0]:
        failures.append("(c) the merit did not fall")
    log("== launch counts on the design step: %s, rot keys %s"
        % (design_launches, design_rot))
    total = {k: launches[k] + glass_launches[k] + design_launches[k]
             for k in launches}
    rot_total = {k: rot[k] + glass_rot[k] + design_rot[k] for k in rot}
    log("pose loops' later steps (s): alignment %.4f (the optimizer path's "
        "%.4f), achromatization %.4f (%.4f), design %.4f (%.4f)"
        % (steps["alignment"], base_steps[0], steps["achromatization"],
           base_steps[1], steps["design"], base_steps[2]))
    if not (rot_total["merit_adjoint"] and rot_total["merit_adjoint_multi"]
            and rot_total["opd_adjoint"]):
        failures.append("a rot key never launched: %s" % rot_total)
    if failures:
        raise AssertionError("pose path on the double Gauss failed: %s"
                             % ", ".join(failures))
    return total, rot_total, steps


#: float operations of a rotated row's rotation cotangent in a rot key's
#: reverse (csrc/step_vjp.cuh): leaving the row (rot_leave_vjp), (R so)
#: for the position and the direction (2 x 15) and 9 entries of two
#: products and a sum (27); entering it (rot_enter_vjp), 9 entries of two
#: products and two sums.  K5/K7 step every row 1..S-1 so; K9 steps rows
#: 1..S-2 so, and its sphere tail only enters the image row's frame
ROT_LEAVE_FLOPS = 57
ROT_ENTER_FLOPS = 36
#: K5/K7's second use of the image row's rotation, the moment frame
#: (moments_adjoint_ray): 6 products and their 6 sums into the slots
ROT_MOMENT_FLOPS = 12


def rot_vjp_flops(name, specs):
    """float operations a live ray of a rot key's rotation cotangents:
    each rotated row 1..S-1 of K5/K7 left and entered, and the moment
    frame's on a rotated image row; K9's rows 1..S-2 the same, its
    rotated image row entered only (the sphere tail)."""
    opd = name.startswith("opd_adjoint")
    flops = sum(ROT_LEAVE_FLOPS + ROT_ENTER_FLOPS
                for sp in specs[1:-1] if sp.rotated)
    if specs[-1].rotated:
        flops += (ROT_ENTER_FLOPS if opd else
                  ROT_LEAVE_FLOPS + ROT_ENTER_FLOPS + ROT_MOMENT_FLOPS)
    return flops


def phase_pose_throughput(card, cases):
    """The pose loops' rot keys -- K5, K7 (3 wavelengths) and K9 for
    POSE_FIELDS without the ray cotangents on the posed double Gauss,
    every pose live -- beside their plain versions (rot) and their twins
    without rot (the same specs and ("offset",)), at N_GRAD_TIME rays of
    its bench bundle (ray 0 the chief ray) in float32 and float64, in
    turns.  Returns ({(kernel, dtype): (ms, plain ms, twin ms)}, {(kernel,
    dtype): live ray traces})."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        merit_adjoint_reference, opd_adjoint, opd_adjoint_reference,
        opd_chain, weighted_moments, weighted_moments_multi)
    from rayopt_tpu_torch.ops.cuda_trace import trace_merit
    from rayopt_tpu_torch.ops.tables import table_at
    s, table, specs, tabs, mspecs, bundle, _ = cases["posed double Gauss"]
    log("== pose keys' throughput (posed double Gauss, every pose live): "
        "K5, K7 (%d wavelengths) and K9 for %s without ray cotangents at %d "
        "rays against the plain versions and the twin keys without rot "
        "(%s)" % (tabs.curvature.shape[0], POSE_FIELDS, N_GRAD_TIME, card))
    times, live = {}, {}
    for dtype in (torch.float32, torch.float64):
        state = bundle(N_GRAD_TIME, dtype, SEED + 1)
        w = bench_weights(N_GRAD_TIME, dtype, SEED + 3)
        ct = rms_cotangent(weighted_moments(table, specs, state, w))
        mct = rms_cotangent(weighted_moments_multi(tabs, mspecs, state, w))
        aux = opd_aux(s, table, specs, state)
        k, lx, ly = opd_chain(table, specs, state, aux)
        cts = opd_cotangents(k, lx, ly, "wavefront")
        live[("merit_adjoint", dtype)] = float(trace_merit(
            table, specs, state)[0])
        live[("merit_adjoint_multi", dtype)] = sum(
            float(trace_merit(table_at(tabs, li), mspecs, state)[0])
            for li in range(tabs.curvature.shape[0]))
        live[("opd_adjoint", dtype)] = float(torch.isfinite(k).sum())
        calls = {
            "merit_adjoint": (
                lambda f: merit_adjoint(table, specs, state, w, ct,
                                        fields=f, rays=False),
                lambda: merit_adjoint_reference(table, specs, state, w, ct,
                                                rot=True)),
            "merit_adjoint_multi": (
                lambda f: merit_adjoint_multi(tabs, mspecs, state, w, mct,
                                              fields=f, rays=False),
                lambda: merit_adjoint_multi_reference(
                    tabs, mspecs, state, w, mct, rot=True)),
            "opd_adjoint": (
                lambda f: opd_adjoint(table, specs, state, aux, cts,
                                      fields=f, rays=False),
                lambda: opd_adjoint_reference(table, specs, state, aux, cts,
                                              rot=True))}
        for name, (kern, plain) in calls.items():
            (km, pm, tm), (k1, k2, p1, p2, t1, t2) = in_turns(
                lambda: kern(POSE_FIELDS), plain,
                lambda: kern(POSE_FIELDS[:-1]), reps=10, plain_reps=1)
            times[(name, dtype)] = (km, pm, tm)
            log("%s %s rot key: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), twin without rot %.4f ms (%.4f, %.4f), "
                "rot/twin %.3fx | %s" % (name, str(dtype)[6:], km, k1, k2,
                                         pm, p1, p2, tm, t1, t2, km/tm,
                                         card))
        del state, w
        torch.cuda.empty_cache()
    return times, live


def pose_entries(sources, rot_launches, worst, times, live, ptxas, steps,
                 base_steps, cases):
    """The kernels line's entries of the rot keys: the pose path's rot
    launches, the float32 errors of phase_pose_check, the times of
    phase_pose_throughput (kernel, plain version, twin without rot) at
    N_GRAD_TIME rays in both dtypes, the bounds (kernel_bound of the
    loop key and rot_vjp_flops), the keys' registers,
    stack and spills beside the twins', and the pose loops' later-step
    seconds beside the earlier loops'."""
    _, table, specs, tabs, mspecs, _, _ = cases["posed double Gauss"]
    nlam = tabs.curvature.shape[0]
    rotated = sum(1 for j, sp in enumerate(specs) if j and sp.rotated)
    out = []
    for kname, bname, ktag, lam, loop in (
            ("merit_adjoint", "merit_adjoint_optimizer", "K5", 1,
             "alignment"),
            ("merit_adjoint_multi", "merit_adjoint_multi_loop", "K7", nlam,
             "achromatization"),
            ("opd_adjoint", "opd_adjoint_loop", "K9", 1, "design")):
        source, replaces = sources[kname]
        entry = {"name": kname + "_pose", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": rot_launches[kname],
                 "max_abs_err": worst[kname], "library_ms": None,
                 "rays": N_GRAD_TIME, "wavelengths": lam,
                 "rotated_rows": rotated, "fields": list(POSE_FIELDS)}
        for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
            k, p, t = times[(kname, dtype)]
            n_live = live[(kname, dtype)]
            sp = mspecs if lam > 1 else specs
            b = kernel_bound(bname, N_GRAD_TIME, dtype, sp, lam, n_live,
                             rot=True)
            entry.update({"ms" + sfx: k, "plain_ms" + sfx: p,
                          "ms_twin_key" + sfx: t, "bound_ms" + sfx: b[0],
                          "bound_ms_twin_key" + sfx: kernel_bound(
                              bname, N_GRAD_TIME, dtype, sp, lam,
                              n_live)[0]})
            if not sfx:
                entry["bound_by"] = b[1]
            dt = str(dtype)[6:]
            for what, key_sfx in (("rot", ""), ("twin", "_twin")):
                regs, stack, spill = ptxas["%s posed double Gauss %s loop %s"
                                           % (ktag, dt, what)]
                rs = "" if dt == "float64" else "_f32"
                entry.update({"regs%s%s" % (key_sfx, rs): regs,
                              "stack_bytes%s%s" % (key_sfx, rs): stack,
                              "spill_bytes%s%s" % (key_sfx, rs): spill})
        entry.update({"pose_%s_step_s" % loop: steps[loop],
                      "earlier_%s_step_s" % loop: base_steps[loop]})
        out.append(entry)
    return out


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


def in_turns(kernel, plain=None, twin=None, reps=20, plain_reps=3):
    """Mean ms of kernel, plain and twin on the card, in turns: plain,
    kernel, twin, kernel, twin, plain (NaN for one not given); then each
    run's (kernel, kernel, plain, plain, twin, twin)."""
    nan = float("nan")
    p1 = cuda_ms(plain, plain_reps) if plain else nan
    k1 = cuda_ms(kernel, reps)
    s1 = cuda_ms(twin, reps) if twin else nan
    k2 = cuda_ms(kernel, reps)
    s2 = cuda_ms(twin, reps) if twin else nan
    p2 = cuda_ms(plain, plain_reps) if plain else nan
    return ((k1 + k2)/2, (p1 + p2)/2, (s1 + s2)/2), (k1, k2, p1, p2, s1, s2)


def twin_note(k, sp_, s1, s2, what="double Gauss key"):
    """The log's note of a twin timing (empty without one)."""
    if sp_ != sp_:
        return ""
    return (" | %s %.4f ms (%.4f, %.4f), kernel/twin %.3fx"
            % (what, sp_, s1, s2, k/sp_))


def peak_gib(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()/2**30


def phase_throughput(table, specs, card, n=N_BENCH, twin=None, big=None,
                     lens="double Gauss", bundle=bench_bundle,
                     twin_name="double Gauss"):
    """K1 and K2 against their plain versions at n rays of `bundle` in
    float32 and float64, in turns (plain, kernel, kernel, plain).  With
    `twin` (another lens's (table, specs), named `twin_name`: the double
    Gauss beside the aspheric one, an anamorphic lens's spherical twin)
    its keys on the same bundle after each kernel run; with `big`,
    float32 kernels (and twins) alone at big rays.  times[(name, dtype)]
    = (kernel, plain) ms, times[(name, big)] the kernel's, and the twin's
    under the key + ("twin",)."""
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_final_reference, trace_merit,
        trace_merit_reference)
    nsurf = table.curvature.shape[0] - 1
    log("== throughput (%s): %d rays, %d traced surfaces%s (%s)"
        % (lens, n, nsurf, ", against the %s's keys" % twin_name if twin
           else "", card))
    times = {}

    def pairs(state, tab, sp):
        return (
            ("trace_final",
             lambda: trace_final(tab, sp, state),
             lambda: trace_final_reference(tab, sp, state)),
            ("trace_merit",
             lambda: trace_merit(tab, sp, state),
             lambda: trace_merit_reference(tab, sp, state)))
    for dtype in (torch.float32, torch.float64):
        state = bundle(n, dtype, SEED + 1)
        twins = pairs(state, *twin) if twin else ()
        for case, (name, kernel, plain) in enumerate(pairs(state, table,
                                                           specs)):
            (k, p, sp_), (k1, k2, p1, p2, s1, s2) = in_turns(
                kernel, plain, twins[case][1] if twin else None)
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p)
            if twin:
                times[(name, dtype, "twin")] = sp_
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | %.4g vs %.4g "
                "intersections/s | peak memory %.3f vs %.3f GiB%s | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   n*nsurf/(k*1e-3), n*nsurf/(p*1e-3), mem_k, mem_p,
                   twin_note(k, sp_, s1, s2, twin_name + " key"), card))
        del state, twins
        torch.cuda.empty_cache()
    if big:
        state = bundle(big, torch.float32, SEED + 1)
        twins = pairs(state, *twin) if twin else ()
        for case, (name, kernel, _) in enumerate(pairs(state, table,
                                                       specs)):
            times[(name, big)] = k = cuda_ms(kernel, 10)
            if twin:
                times[(name, big, "twin")] = sp_ = cuda_ms(twins[case][1],
                                                           10)
            log("%s float32 at %d rays: kernel %.4f ms%s | %s"
                % (name, big, k, ", %s key %.4f ms (kernel/twin %.3fx)"
                   % (twin_name, sp_, k/sp_) if twin else "", card))
        del state, twins
        torch.cuda.empty_cache()
    return times


def phase_grad_throughput(table, specs, card, twin=None,
                          loop_fields=OPT_FIELDS, lens="double Gauss",
                          bundle=bench_bundle, twin_name="double Gauss"):
    """K4 and K5 (all fields, with the ray cotangents: the work of the
    earlier run-time-flag K5) against their plain versions at
    N_GRAD_TIME rays of `bundle` in float32 and float64, beside K5 for
    the optimizer's slot set (`loop_fields`) without ray cotangents;
    then float64 at one optimizer bundle's N_OPT_BUNDLE rays, and
    float32 at N_BENCH rays, kernels alone.  With `twin`, as
    phase_throughput: the twin's keys (its OPT_FIELDS key for the
    loop's) timed after each kernel at N_GRAD_TIME rays, and alone at
    N_BENCH rays."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        weighted_moments, weighted_moments_reference, merit_adjoint,
        merit_adjoint_reference)
    nsurf = table.curvature.shape[0] - 1
    log("== K4/K5 throughput (%s): %d rays against the plain versions%s, "
        "then %d rays (float64) and %d rays (float32) kernel alone, %d "
        "traced surfaces (%s)" % (lens, N_GRAD_TIME, " and the %s's keys"
                                  % twin_name if twin else "", N_OPT_BUNDLE,
                                  N_BENCH, nsurf, card))

    def pairs(state, w, tab=table, sp=specs):
        ct = rms_cotangent(weighted_moments(tab, sp, state, w))
        return (
            ("weighted_moments",
             lambda: weighted_moments(tab, sp, state, w),
             lambda: weighted_moments_reference(tab, sp, state, w)),
            ("merit_adjoint",
             lambda: merit_adjoint(tab, sp, state, w, ct),
             lambda: merit_adjoint_reference(tab, sp, state, w, ct)),
            ("merit_adjoint_optimizer",
             lambda: merit_adjoint(
                 tab, sp, state, w, ct, rays=False,
                 fields=loop_fields if tab is table else OPT_FIELDS),
             None))
    times = {}
    note = twin_name + " key"
    for dtype in (torch.float32, torch.float64):
        state = bundle(N_GRAD_TIME, dtype, SEED + 1)
        w = bench_weights(N_GRAD_TIME, dtype, SEED + 3)
        twins = pairs(state, w, *twin) if twin else ()
        for case, (name, kernel, plain) in enumerate(pairs(state, w)):
            (k, p, sp_), (k1, k2, p1, p2, s1, s2) = in_turns(
                kernel, plain, twins[case][1] if twin else None)
            if twin:
                times[(name, dtype, "twin")] = sp_
            if plain is None:
                times[(name, dtype)] = k
                log("merit_adjoint %s, the optimizer's slot set, no ray "
                    "cotangents: kernel %.4f ms (%.4f, %.4f)%s | %s"
                    % (str(dtype)[6:], k, k1, k2,
                       twin_note(k, sp_, s1, s2, note), card))
                continue
            mem_k, mem_p = peak_gib(kernel), peak_gib(plain)
            times[(name, dtype)] = (k, p)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx | %.4g ray-surfaces/s | "
                "peak memory %.3f vs %.3f GiB%s | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   N_GRAD_TIME*nsurf/(k*1e-3), mem_k, mem_p,
                   twin_note(k, sp_, s1, s2, note), card))
        del state, w, twins
        torch.cuda.empty_cache()
    for n, dtype in ((N_OPT_BUNDLE, torch.float64),
                     (N_BENCH, torch.float32)):
        state = bundle(n, dtype, SEED + 1)
        w = bench_weights(n, dtype, SEED + 3)
        twins = pairs(state, w, *twin) if twin and n == N_BENCH else ()
        for case, (name, kernel, _) in enumerate(pairs(state, w)):
            if n == N_BENCH and name == "merit_adjoint_optimizer":
                continue
            k = cuda_ms(kernel, 20 if n == N_OPT_BUNDLE else 10)
            times[(name, n)] = k
            tw = ""
            if twins:
                times[(name, n, "twin")] = sp_ = cuda_ms(twins[case][1], 10)
                tw = ", %s %.4f ms (kernel/twin %.3fx)" % (note, sp_, k/sp_)
            log("%s %s at %d rays: kernel %.4f ms, %.4g ray-surfaces/s%s%s "
                "| %s" % (name, str(dtype)[6:], n, k, n*nsurf/(k*1e-3), tw,
                          "" if n == N_OPT_BUNDLE else
                          ", peak memory %.3f GiB | plain: not run "
                          "(memory)" % peak_gib(kernel), card))
        del state, w, twins
        torch.cuda.empty_cache()
    return times


def phase_multi_throughput(tabs, specs, card, twin=None,
                           loop=ACHROM_FIELDS, lens=None,
                           bundle=bench_bundle, twin_name="double Gauss"):
    """K3 (merit and trace), K6 and K7 against their plain versions and
    their twins on the same bundle, with K7 for every field and the ray
    cotangents (the work of the earlier run-time-flag K7) beside K7 for
    the achromatization path's key (the fields `loop`); K6 and K7 both
    ways in float64 at one achromatization bundle's N_OPT_BUNDLE rays;
    then the three alone at N_BENCH rays in float32, beside their
    twins.  The twins: nlam launches of the monochromatic twins (K2 and
    K1, K4, K5), or, with `twin` (another lens's stack and specs, named
    `twin_name`: the double Gauss's beside the aspheric one, an
    anamorphic lens's spherical twin), that lens's keys (its
    ACHROM_FIELDS key for the loop's).  `lens` names the lens, `bundle`
    makes the rays (bench_bundle's signature).  Returns the times
    (kernel, plain, twin) and the live ray traces (summed over the
    wavelengths) of each timing bundle."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        merit_adjoint, merit_adjoint_multi, merit_adjoint_multi_reference,
        weighted_moments, weighted_moments_multi,
        weighted_moments_multi_reference)
    from rayopt_tpu_torch.ops.cuda_trace import (
        trace_final, trace_merit, trace_multi, trace_multi_reference)
    from rayopt_tpu_torch.ops.tables import table_at
    nlam = tabs.curvature.shape[0]
    one = [table_at(tabs, li) for li in range(nlam)]
    what = ("the %s's keys" % twin_name if twin else
            "%d launches of the monochromatic twin" % nlam)
    log("== K3/K6/K7 throughput%s: %d bench rays x %d wavelengths against "
        "the plain versions and %s, then %d rays kernel alone (%s)"
        % (" (%s)" % lens if lens else "", N_GRAD_TIME, nlam, what, N_BENCH,
           card))

    def cases(state, w, ct, tb=tabs, sp=specs, lp=loop):
        return (
            ("trace_multi",
             lambda: trace_multi(tb, sp, state, merit=True),
             lambda: trace_multi_reference(tb, sp, state, merit=True),
             lambda: [trace_merit(t, sp, state) for t in one]),
            ("trace_multi_trace",
             lambda: trace_multi(tb, sp, state),
             lambda: trace_multi_reference(tb, sp, state),
             lambda: [trace_final(t, sp, state) for t in one]),
            ("weighted_moments_multi",
             lambda: weighted_moments_multi(tb, sp, state, w),
             lambda: weighted_moments_multi_reference(tb, sp, state, w),
             lambda: [weighted_moments(t, sp, state, w) for t in one]),
            ("merit_adjoint_multi",
             lambda: merit_adjoint_multi(tb, sp, state, w, ct),
             lambda: merit_adjoint_multi_reference(tb, sp, state, w, ct),
             lambda: [merit_adjoint(t, sp, state, w, ct[li])
                      for li, t in enumerate(one)]),
            ("merit_adjoint_multi_loop",
             lambda: merit_adjoint_multi(tb, sp, state, w, ct, fields=lp,
                                         rays=False), None, None))

    def setup(n, dtype):
        """The bench bundle, its weights and the kernel and twin
        cases (name, kernel, plain, twin); the live ray traces."""
        state = bundle(n, dtype, SEED + 1)
        w = bench_weights(n, dtype, SEED + 3)
        ct = rms_cotangent(weighted_moments_multi(tabs, specs, state, w))
        out = cases(state, w, ct)
        if twin:
            tct = rms_cotangent(weighted_moments_multi(*twin, state, w))
            out = [(name, k, p, t[1]) for (name, k, p, _), t in zip(
                out, cases(state, w, tct, *twin, ACHROM_FIELDS))]
        return out, sum(float(m[0]) for m in trace_multi(tabs, specs, state,
                                                         merit=True))
    times, live = {}, {}
    for dtype in (torch.float32, torch.float64):
        pairs, live[dtype] = setup(N_GRAD_TIME, dtype)
        for name, kernel, plain, twin_fn in pairs:
            (k, p, t), (k1, k2, p1, p2, t1, t2) = in_turns(kernel, plain,
                                                           twin_fn)
            times[(name, dtype)] = (k, p, t)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms (%.4f, "
                "%.4f), plain/kernel %.2fx%s | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   twin_note(k, t, t1, t2, what), card))
        del pairs
        torch.cuda.empty_cache()
    pairs, live[N_OPT_BUNDLE] = setup(N_OPT_BUNDLE, torch.float64)
    for name, kernel, _, twin_fn in pairs:
        if name in ("weighted_moments_multi", "merit_adjoint_multi",
                    "merit_adjoint_multi_loop") or twin:
            (k, _, t), (k1, k2, _, _, t1, t2) = in_turns(
                kernel, None, twin_fn if twin else None)
            times[(name, N_OPT_BUNDLE)] = k
            times[(name, N_OPT_BUNDLE, "twin")] = t
            log("%s float64 at %d rays x %d wavelengths: kernel %.4f ms "
                "(%.4f, %.4f)%s | %s" % (name, N_OPT_BUNDLE, nlam, k, k1, k2,
                                         twin_note(k, t, t1, t2, what),
                                         card))
    del pairs
    pairs, live[N_BENCH] = setup(N_BENCH, torch.float32)
    for name, kernel, _, twin_fn in pairs:
        if twin_fn is None:
            continue
        (k, _, t), (k1, k2, _, _, t1, t2) = in_turns(kernel, None, twin_fn,
                                                     10)
        times[(name, N_BENCH)] = k
        times[(name, N_BENCH, "twin")] = t
        log("%s float32 at %d rays x %d wavelengths: kernel %.4f ms (%.4f, "
            "%.4f)%s, peak memory %.3f GiB | plain: not run (memory) | %s"
            % (name, N_BENCH, nlam, k, k1, k2, twin_note(k, t, t1, t2, what),
               peak_gib(kernel), card))
    del pairs
    torch.cuda.empty_cache()
    return times, live


def phase_opd_throughput(s, table, specs, card, twin=None,
                         loop=DESIGN_FIELDS, lens=None, bundle=opd_bundle,
                         twin_name="double Gauss"):
    """K8 and K9 (wavefront-RMS cotangents; K9 for every field and the
    ray cotangents, the work of the earlier run-time-flag K9) against
    their plain versions at N_GRAD_TIME rays in float32 and float64,
    beside K9 for the design path's key (the fields `loop`); K8 and both
    K9s in float64 at one design bundle's N_OPT_BUNDLE rays; then K8 and
    K9 alone at N_BENCH rays in float32.  With `twin` (another lens's
    system, table and specs: the double Gauss beside the aspheric one),
    that lens's keys (its design key for the loop's) on the same rays,
    each with its own reference sphere and cotangents, in turns at
    N_GRAD_TIME (`twin_name` names it, `lens` the lens; `bundle` makes
    the rays, opd_bundle's signature).  Returns the times (kernel, plain,
    twin) and the live rays of each timing bundle (K9's reverse runs for
    these only)."""
    from rayopt_tpu_torch.ops.cuda_grad import (
        opd_adjoint, opd_adjoint_reference, opd_chain, opd_chain_reference)
    note = twin_name + " key"
    log("== K8/K9 throughput%s: %d bench rays (ray 0 the chief ray) against "
        "the plain versions%s, then %d rays kernel alone (%s)"
        % (" (%s)" % lens if lens else "", N_GRAD_TIME,
           " and the %s's keys" % twin_name if twin else "", N_BENCH, card))

    def pairs(state, sy=s, tb=table, sp=specs, lp=loop):
        aux = opd_aux(sy, tb, sp, state)
        k = opd_chain(tb, sp, state, aux)
        cts = opd_cotangents(*k, "wavefront")
        return (
            ("opd_chain",
             lambda: opd_chain(tb, sp, state, aux),
             lambda: opd_chain_reference(tb, sp, state, aux)),
            ("opd_adjoint",
             lambda: opd_adjoint(tb, sp, state, aux, cts),
             lambda: opd_adjoint_reference(tb, sp, state, aux, cts)),
            ("opd_adjoint_loop",
             lambda: opd_adjoint(tb, sp, state, aux, cts, fields=lp,
                                 rays=False), None)), \
            int(torch.isfinite(k[0]).sum())

    def setup(n, dtype):
        state = bundle(n, dtype, SEED + 1)
        mine, nlive = pairs(state)
        twins = pairs(state, *twin, DESIGN_FIELDS)[0] if twin else \
            ((None, None, None),)*3
        return [(name, k, p, t[1]) for (name, k, p), t in zip(mine, twins)], \
            nlive
    times, live = {}, {}
    for dtype in (torch.float32, torch.float64):
        cases, live[dtype] = setup(N_GRAD_TIME, dtype)
        for name, kernel, plain, twin_fn in cases:
            (k, p, t), (k1, k2, p1, p2, t1, t2) = in_turns(kernel, plain,
                                                           twin_fn)
            times[(name, dtype)] = (k, p, t)
            log("%s %s: kernel %.4f ms (%.4f, %.4f), plain %.4f ms "
                "(%.4f, %.4f), plain/kernel %.2fx%s | live rays %d | %s"
                % (name, str(dtype)[6:], k, k1, k2, p, p1, p2, p/k,
                   twin_note(k, t, t1, t2, note), live[dtype], card))
        del cases
        torch.cuda.empty_cache()
    cases, live[N_OPT_BUNDLE] = setup(N_OPT_BUNDLE, torch.float64)
    for name, kernel, _, twin_fn in cases:
        (k, _, t), (k1, k2, _, _, t1, t2) = in_turns(kernel, None, twin_fn)
        times[(name, N_OPT_BUNDLE)] = k
        times[(name, N_OPT_BUNDLE, "twin")] = t
        log("%s float64 at %d rays: kernel %.4f ms (%.4f, %.4f)%s, live "
            "rays %d | %s" % (name, N_OPT_BUNDLE, k, k1, k2,
                              twin_note(k, t, t1, t2, note),
                              live[N_OPT_BUNDLE], card))
    del cases
    cases, live[N_BENCH] = setup(N_BENCH, torch.float32)
    nlive = live[N_BENCH]
    for name, kernel, _, twin_fn in cases[:2]:
        # with a twin, in turns beside its key (kernel, twin, kernel, twin)
        (k, _, t), (_, _, _, _, t1, t2) = in_turns(kernel, None, twin_fn, 10)
        times[(name, N_BENCH)] = k
        if twin:
            times[(name, N_BENCH, "twin")] = t
        log("%s float32 at %d rays: kernel %.4f ms, live rays %d, peak "
            "memory %.3f GiB%s | plain: not run (memory) | %s"
            % (name, N_BENCH, k, nlive, peak_gib(kernel),
               twin_note(k, t, t1, t2, note), card))
    del cases
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


# the Newton lenses whose K10-K13 are timed against their spherical twins:
# the aspheric double Gauss at N_GRAD_TIME and N_BENCH bench rays, the
# anamorphic lenses at N_GRAD_TIME
DF32_TIMED = ("aspheric double Gauss", "anamorphic pair",
              "split-conic biconic")


def df32_timed_plans(lens, fast):
    """(one plan, the K11/K13 plans) of a timed Newton lens and of its
    spherical twin (the double Gauss for the aspheric double Gauss,
    spherical_twin's table for an anamorphic lens, its stack
    anam_stack's), and the lens's bench bundle function."""
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    s, table, bundle, tabs = df32_newton_lenses()[lens]
    if lens == "aspheric double Gauss":
        twin = double_gauss()
        ttab, ttabs = twin.table(), twin.tables()
    else:
        ttab = spherical_twin(table)
        ttabs = anam_stack(ttab)[0]
    ttabs = [table_at(ttabs, li) for li in range(ttabs.curvature.shape[0])]
    return ((D.plan(table, fast=fast), [D.plan(t, fast=fast) for t in tabs]),
            (D.plan(ttab, fast=fast), [D.plan(t, fast=fast) for t in ttabs]),
            bundle)


def df32_twin_throughput(card, title, twin_name, cases, plain=False):
    """K10 (with the optical path), K12, K11 (with the path) and K13 on
    the plans of `cases` against the same kernels on their twins' plans,
    fast and exact, in turns in one call (kernel, twin, kernel, twin;
    with `plain`, at N_GRAD_TIME rays, their plain versions first and
    last).  `cases`: {lens: (ray counts, plans(fast) -> ((one plan, the
    K11/K13 plans), the same of the twin), bench bundle function)}.
    Returns {(kernel, lens, plan, n): (ms, twin ms, plain ms or NaN)}
    and {(lens, n): live rays of the lens's one-plan trace}."""
    from rayopt_tpu_torch.ops import cuda_df32 as CD
    log("== K10-K13 on %s, in turns (%s)" % (title, card))
    calls = {"trace_final_df32": (
                 lambda p, st: CD.trace_final_df32(p[0], st, with_path=True),
                 lambda p, st: CD.trace_final_df32_reference(
                     p[0], st, with_path=True)),
             "trace_merit_df32": (
                 lambda p, st: CD.trace_merit_df32(p[0], st),
                 lambda p, st: CD.trace_merit_df32_reference(p[0], st)),
             "trace_multi_df32": (
                 lambda p, st: CD.trace_multi_df32(p[1], st, with_path=True),
                 lambda p, st: CD.trace_multi_df32_reference(
                     p[1], st, with_path=True)),
             "trace_merit_multi_df32": (
                 lambda p, st: CD.trace_merit_multi_df32(p[1], st),
                 lambda p, st: CD.trace_merit_multi_df32_reference(p[1],
                                                                   st))}
    times, live = {}, {}
    for lens, (sizes, plans_of, bundle) in cases.items():
        for n in sizes:
            state = df32_state(bundle(n, torch.float64, SEED + 1))
            for fast in (True, False):
                plan = "fast" if fast else "exact"
                mine, twin = plans_of(fast)
                if fast:
                    live[(lens, n)] = float(CD.trace_merit_df32(
                        mine[0], state)[0])
                for name, (fn, ref) in calls.items():
                    big = n == N_BENCH
                    (k, p, t), (k1, k2, p1, p2, t1, t2) = in_turns(
                        lambda: fn(mine, state),
                        None if big or not plain else
                        (lambda: ref(mine, state)),
                        lambda: fn(twin, state), 3 if big else 10, 1)
                    times[(name, lens, plan, n)] = (k, t, p)
                    log("%s %s %s plan at %d rays: kernel %.4f ms (%.4f, "
                        "%.4f)%s%s | %s"
                        % (name, lens, plan, n, k, k1, k2,
                           twin_note(k, t, t1, t2, twin_name),
                           "" if p != p else " | plain %.4f ms (%.4f, %.4f), "
                           "plain/kernel %.2fx" % (p, p1, p2, p/k), card))
            del state
            torch.cuda.empty_cache()
    return times, live


def phase_df32_newton_throughput(card):
    """df32_twin_throughput on the Newton lenses' plans (DF32_TIMED)
    against their spherical twins': the aspheric double Gauss at
    N_GRAD_TIME and N_BENCH rays, the anamorphic lenses at N_GRAD_TIME
    (the plain versions are timed on the double Gauss,
    phase_df32_throughput)."""
    return df32_twin_throughput(
        card, "the Newton plans against their spherical twins' (%s)"
        % ", ".join(DF32_TIMED), "spherical twin",
        {lens: ((N_GRAD_TIME, N_BENCH) if lens == "aspheric double Gauss"
                else (N_GRAD_TIME,),
                functools.partial(lambda ln, fast: df32_timed_plans(
                    ln, fast)[:2], lens), df32_timed_plans(lens, True)[2])
         for lens in DF32_TIMED})


def phase_df32_phase_throughput(card):
    """df32_twin_throughput on the timed phase lenses' plans
    (DF32_PHASE_TIMED) against their phase-free twins', at N_GRAD_TIME
    (with the plain versions) and N_BENCH rays."""
    return df32_twin_throughput(
        card, "the phase plans against their phase-free twins' (%s)"
        % ", ".join(DF32_PHASE_TIMED), "phase-free twin",
        {lens: ((N_GRAD_TIME, N_BENCH),
                functools.partial(df32_phase_twin_plans, lens),
                df32_phase_cases()[lens][2]) for lens in DF32_PHASE_TIMED},
        plain=True)


# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s, and flop/s outside the tensor cores by dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
ASPHERIC_ITERS = 10   # the Newton's steps (csrc/trace_common.cuh)


def figure_flops(na, no):
    """(residual, slope, hoisted) operations of a figured row's Newton
    (csrc/trace_common.cuh sag_residual and newton_slope) for na even
    and no odd coefficients, each shared expression counted once.  The
    residual: the point on the ray (6), r2 (3), the conic's sag (7:
    (1+k)c^2 r2, its square root, the division), Horner's two a
    coefficient and the subtraction (the odd also sqrt(r2) and its
    product).  The slope at the same point adds only what the residual
    has not: the conic factor's division, the even slopes' Horner (two
    a coefficient), the odd's derivative Horner, its floor's division
    and 2 r q', and the dot product with the ray (6).  Hoisted out of
    the loop, once a row: (1+k)c^2 and the slopes' constant factors."""
    res = 16 + (2*na + 1 if na else 0) + (2*no + 3 if no else 0)
    slope = 7 + (2*na + 1 if na else 0) + (2*no + 3 if no else 0)
    hoisted = 3 + na + max(no - 1, 0)
    return res, slope, hoisted


def slope_flops(na, no):
    """Operations of one newton_slope alone (K5's implicit step at the
    root): the point (4), r2 (3), the conic factor (4), the even and odd
    slopes in full and the dot product (6)."""
    return 17 + (2*na + 1 if na else 0) + (4*no + 4 if no else 0)


def row_flops(spec, widths=(0, 0), nd=0, nxy=0):
    """Arithmetic operations (one per add, multiply, divide or square
    root) of one surface_step (csrc/trace_common.cuh) for a row of this
    spec; an aspheric row with the table's `widths` (na, no): its conic
    seed (33) and the hoisted constants, ASPHERIC_ITERS Newton steps (a
    residual, the slope's own work and the update each), the last
    residual and its test, and the refraction by the radial normal with
    the flagged figures' slopes; a grating or DOE row (nd DOE
    coefficients) by phase_row_flops; a freeform row (nxy XY
    coefficients) by freeform_row_flops."""
    if spec.grating or spec.doe:
        return phase_row_flops(spec, widths, nd, nxy)
    if spec.freeform:
        return freeform_row_flops(spec, widths, nxy)
    if spec.biconic or spec.toroidal or spec.cyl_axis:
        return anam_row_flops(spec, widths)
    f = 1 + (2 if spec.off_axis else 0) + (60 if spec.rotated else 0)
    na, no = widths
    figured = spec.aspheric or spec.odd
    if figured:
        res, slope, hoisted = figure_flops(na, no)
        f += 33 + hoisted + ASPHERIC_ITERS*(res + slope + 2) + res + 2
    elif spec.flat:
        f += 2
    elif spec.spherical:
        f += 23
    else:
        f += 31
    f += 8                                    # transfer and optical path
    if spec.kind and figured:
        f += ((37 if spec.kind == 1 else 26)
              + (2*na + 1 if spec.aspheric else 0)
              + (4*no + 4 if spec.odd else 0))
    elif spec.kind:
        f += 13 if spec.flat else (27 if spec.spherical else 37)
    return f


def newton_flops(specs, widths=(0, 0)):
    """Operations of the Newton steps of one ray through the chain: the
    ASPHERIC_ITERS steps of every figured row (row_flops' loop)."""
    res, slope, _ = figure_flops(*widths)
    return sum(ASPHERIC_ITERS*(res + slope + 2) for sp in specs[1:]
               if sp.aspheric or sp.odd)


def chain_flops(specs, widths=(0, 0), nd=0, nxy=0):
    """Operations of one ray through the whole chain (trace_ray)."""
    return (sum(row_flops(sp, widths, nd, nxy) for sp in specs[1:])
            + 30*(int(specs[0].rotated) + int(specs[-1].rotated)))


def chain_vjp_flops(specs, widths=(0, 0), path=False, nd=0, nxy=0):
    """Operations of K5's and K7's reverse sweep for one live ray: 3x
    the forward chain (a row's recompute and its reverse, PERF.md's
    estimate), but an aspheric row counted from csrc/step_vjp.cuh
    figured_step_vjp -- its recompute (the whole Newton once), the
    refraction's reverse (~75 and the figures' terms), the transfer's,
    and the implicit step: one slope and the residual's gradient.  With
    `path` (K9's PATH form), an aspheric row also adds its optical
    path's cotangent to gt and takes n_before's (3).  A freeform row
    (nxy XY coefficients) is counted as an aspheric row of the table's
    widths, its recompute with the XY figure (freeform_row_flops) and
    its reverse with the XY figure's (xy_flops)."""
    na, no = widths
    total = 3*chain_flops(specs, widths, nd, nxy)
    for sp in specs[1:]:
        if sp.biconic or sp.toroidal or sp.cyl_axis:
            total += anam_vjp_extra(sp, widths)
        elif sp.aspheric or sp.odd or sp.freeform:
            ff = sp.freeform
            rf = row_flops(sp, widths, nd, nxy) if ff else row_flops(sp,
                                                                    widths)
            rev = (75 + (6*na if sp.aspheric or ff else 0)
                   + (12*no if sp.odd or ff else 0) + 9
                   + slope_flops(na, no) + 38 + 3*na + 6*no
                   + (60 if sp.rotated else 0) + (3 if path else 0)
                   + (xy_flops(nxy)[3] if ff else 0))
            total += rf + rev - 3*rf
    return total


# operations of K8's reference-sphere tail (image-row shift, the
# intercept's dot products, square root and divisions, k, lx, ly) and
# of its hand-written reverse
OPD_TAIL_FLOPS = 40
OPD_TAIL_VJP_FLOPS = 70


def kernel_bound(name, n, dtype, specs, nlam=1, live=0, widths=(0, 0),
                 nd=0, nxy=0, rot=False):
    """(bound_ms, bound_by) of one launch at n rays: the larger of the
    bytes it must move (each input read once, each output written once)
    over the HBM rate and its operations over the dtype's peak.  The
    reverse sweeps of K5/K7/K9 run only for live rays (`live`: live ray
    traces, summed over wavelengths) and are counted as 3x the forward
    chain (PERF.md's estimate for the adjoint; an aspheric row by
    chain_vjp_flops, K9's in its PATH form) plus the seeding (K9: the
    tail's reverse).  `widths`: a figured key's (na, no), its rows'
    coefficients; `nd`: a DOE key's coefficients (a phase row's reverse
    is counted as 3x its forward, as a conic row's); `nxy`: a freeform
    key's XY coefficients (its row's reverse counted so too); `rot`: a
    rot key, rot_vjp_flops a live ray (K9 also writes nine slots more a
    row)."""
    word = 4 if dtype == torch.float32 else 8
    chain = chain_flops(specs, widths, nd, nxy)
    vjp = chain_vjp_flops(specs, widths, nd=nd, nxy=nxy)
    # K8's chain stops at row S-2 and adds the sphere tail; K9's reverse
    # is 3x that, its aspheric rows counted as chain_vjp_flops' PATH form
    opd = chain - row_flops(specs[-1]) + OPD_TAIL_FLOPS
    opd_vjp = (3*opd + chain_vjp_flops(specs[:-1], widths, True, nd, nxy)
               - 3*chain_flops(specs[:-1], widths, nd, nxy))
    words_in, words_out, flops = {
        "opd_chain": (6, 3, n*opd),
        "opd_adjoint": (9, 6, n*opd + live*(opd_vjp + OPD_TAIL_VJP_FLOPS)),
        "trace_final": (6, 7, n*chain),
        "trace_merit": (6, 0, n*(chain + 7)),
        # K3's merit writes (nlam, 5) moments, its trace 7 words a ray
        # and wavelength
        "trace_multi": (6, 0, n*nlam*(chain + 7)),
        "trace_multi_trace": (6, 7*nlam, n*nlam*chain),
        "weighted_moments": (7, 0, n*(chain + 11)),
        "weighted_moments_multi": (7, 0, n*nlam*(chain + 11)),
        "merit_adjoint": (7, 7, n*chain + live*(vjp + 11)),
        # K5 for the optimizer's slot set (the aspheric designer loop's
        # too) writes nothing a ray
        "merit_adjoint_optimizer": (7, 0, n*chain + live*(vjp + 11)),
        "merit_adjoint_multi": (7, 7, n*nlam*chain + live*(vjp + 11)),
        # K7 for the achromatization path's key, K9 for the design
        # path's: nothing written a ray
        "merit_adjoint_multi_loop": (7, 0, n*nlam*chain + live*(vjp + 11)),
        "opd_adjoint_loop": (9, 0,
                             n*opd + live*(opd_vjp + OPD_TAIL_VJP_FLOPS)),
    }[name]
    # K9 also writes its parameter and centre cotangents, K3's merit its
    # moments
    grating = int(any(sp.grating for sp in specs))
    slots = (len(specs)*(7 + sum(widths) + grating + (1 + nd if nd else 0)
                         + nxy + (9 if rot else 0)) + 3
             if name.startswith("opd_adjoint") else 0)
    if rot:
        flops = flops + live*rot_vjp_flops(name, specs)
    if name == "trace_multi":
        slots = 5*nlam
    row = 17 + sum(widths) + grating + (1 + nd if nd else 0) + nxy
    nbytes = (n*(words_in + words_out) + nlam*len(specs)*row + slots)*word \
        + 4*len(specs)
    t_bytes, t_ops = nbytes/PEAK_BYTES, flops/PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops)*1e3, ("bytes" if t_bytes >= t_ops
                                     else "operations")


# float32 operations of the df32 functions in the least form that gives
# the same words (csrc/df32_common.cuh with two_prod's FMA form,
# as K10-K13 run it): one per add, subtract,
# multiply, divide or square root and two per fused multiply-add, as the
# 67 TFLOP/s peak counts them (a negation is a sign flip and not
# counted).  two_prod is 3, so mul 10 and sqr 9; div and sqrt are the
# exact plan's two refinement rounds, div1 and sqrt1 the fast plan's
# one (Dekker's split, as the plain version writes it: two_prod 17, mul
# 24, sqr 23, div 89, div1 41, sqrt 88, sqrt1 41).
DF_OPS = {"add": 11, "mul": 10, "sqr": 9, "scale": 2, "div": 61,
          "div1": 27, "sqrt": 60, "sqrt1": 27}
DF_ASPHERIC_ITERS = 8   # an aspheric row's df32 rounds (ops.df32)


def _df_figure_ops(na, no, dv, sq):
    """float32 operations of the df32 figure functions of
    csrc/df32_common.cuh at na even and no odd coefficients:
    (poly_even, dpoly_even, poly_odd, dpoly_odd); a floor's compare
    counts one."""
    o = DF_OPS
    def horner(n):
        return n*o["mul"] + (n - 1)*o["add"]
    pe = horner(na) if na else 0
    de = na*o["scale"] + (na - 1)*(o["mul"] + o["add"]) if na else 0
    po = horner(no) if no else 0
    do = ((no - 1)*(o["mul"] + o["add"]) + 1 + dv
          + ((no - 1)*o["scale"] + (no - 2)*(o["mul"] + o["add"]) + o["mul"]
             + o["scale"] + o["add"] if no > 1 else 0)) if no else 0
    return pe, de, po, do


def df32_newton_ops(step):
    """float32 operations of a Newton row's intercept and normal
    (csrc/df32_common.cuh): (intercept, normal).  An aspheric row: its
    conic root, DF_ASPHERIC_ITERS rounds (the point, sag_df,
    normal_radial_df, the slope and the update) and the residual test,
    then the radial factor of the generic normal; a biconic or toroid
    row: the float32 seed (intercept_conic_32, ANAM_F32_ITERS float32
    steps of the sag and normal, counted as float32 operations), the df32
    rounds and the residual test, then its df32 normal; a conic
    cylinder: its closed form, then its polynomial normal (N_w, N_z, u.N
    and, conic, |N|^2).  The generic normal's |N|^2 and u.N, and the
    refraction, are counted by df32_step_ops."""
    o = DF_OPS
    dv = o["div1"] if step["fast"] else o["div"]
    sq = o["sqrt1"] if step["fast"] else o["sqrt"]
    point = 3*(o["mul"] + o["add"])
    an = step["anam"]
    if an is None:
        na, no = len(step["asp"]), len(step["asp_odd"])
        pe, de, po, do = _df_figure_ops(na, no, dv, sq)
        sag = (2*o["sqr"] + 3*o["mul"] + 4*o["add"] + sq + dv
               + (o["add"] + pe if na else 0)
               + (o["add"] + sq + po if no else 0))
        normal = (3*o["sqr"] + 2*o["mul"] + 2*o["add"] + sq + dv
                  + (o["add"] + de if na else 0)
                  + (o["add"] + sq + do if no else 0))
        rnd = point + sag + normal + 4*o["mul"] + 3*o["add"] + dv
        return (DF_ASPHERIC_ITERS*rnd + point + sag + 3,
                normal + 2*o["mul"])
    if an["mode"] in ("cyl_y", "cyl_x"):
        cept = (8*o["mul"] + 3*o["sqr"] + 8*o["add"] + o["scale"] + sq
                + dv + 2)
        normal = (4*o["mul"] + 2*o["add"]
                  + (0 if an["circular"] else 2*o["sqr"] + o["add"]))
        return cept, normal
    if an["mode"] == "freeform":
        return df32_freeform_ops(step, dv, sq)
    na, no = len(an["asp"]), len(an["asp_odd"])
    pe, de, po, do = _df_figure_ops(na, no, dv, sq)
    if an["mode"] == "toroid":
        ycurve = (o["sqr"] + o["mul"] + o["add"] + sq + 2*o["mul"]
                  + o["add"] + 2*dv + 1
                  + (pe + de + o["mul"] + 2*o["add"] if na else 0)
                  + (sq + po + do + o["mul"] + 2*o["add"] if no else 0))
        sag = (ycurve + 3*o["mul"] + 5*o["add"] + 2*o["sqr"] + sq + 2*dv)
        normal = (ycurve + 3*o["mul"] + 2*o["add"] + 2*o["sqr"] + sq + 1
                  + 3*dv)
        sag32 = 30 + (6*na + 4 if na else 0) + (7*no + 6 if no else 0)
    else:
        fig = o["add"] if na or no else 0
        sag = (2*o["sqr"] + 4*o["mul"] + 5*o["add"] + sq + dv + fig
               + (o["add"] + pe if na else 0)
               + (o["add"] + sq + po if no else 0))
        normal = (2*o["sqr"] + 4*o["mul"] + 4*o["add"] + sq + 2*dv
                  + o["sqr"] + 1 + 2*(4*o["mul"] + o["scale"] + o["add"])
                  + (fig + de + do + (o["add"] if na and no else 0)
                     + (sq if no else 0) + 2*(o["mul"] + o["add"])
                     if na or no else 0))
        sag32 = 49 + (5*na + 5 if na else 0) + (5*no + 9 if no else 0)
    iters = 2 + (0 if step["fast"] else 1)
    seed = 37 + 6*(13 + sag32)
    rnd = point + sag + normal + 2*o["mul"] + 2*o["add"] + 1 + dv + o["add"]
    return seed + iters*rnd + point + sag + 3, normal


def df32_freeform_ops(step, dv, sq):
    """df32_newton_ops of a freeform row, over the XY terms its packed
    step holds (cuda_df32.xy_terms: the mask's, or every term of a dense
    row's degree): the float32 seed (intercept_conic_32, ANAM_F32_ITERS
    steps of sag_normal_freeform_32: the base's sag and radial factor,
    the powers, a product and a sum a value term, the slope terms'
    products and sums), the df32 rounds (the point, the powers, shared
    by the sag and the normal at one point, sag_freeform_df,
    normal_freeform_df, the slope and the update), the residual test,
    then the normal at the intercept with its powers."""
    from rayopt_tpu_torch.ops.cuda_df32 import _step_words, xy_terms
    o = DF_OPS
    an = step["anam"]
    terms = xy_terms(_step_words(step)[1])
    na, no = len(an["asp"]), len(an["asp_odd"])
    pe, de, po, do = _df_figure_ops(na, no, dv, sq)
    pw = (max(max(i for i, _ in terms) - 1, 0)
          + max(max(j for _, j in terms) - 1, 0))   # a product a power

    def poly(exps):
        # a product a monomial of two powers, one a term, a sum a term
        # after the first
        muls = sum((i > 0 or j > 0) + (i > 0 and j > 0) for i, j in exps)
        return muls*o["mul"] + (len(exps) - 1)*o["add"]
    sx = [(i - 1, j) for i, j in terms if i]
    sy = [(i, j - 1) for i, j in terms if j]
    sag = (2*o["sqr"] + 3*o["mul"] + 4*o["add"] + sq + dv
           + (o["add"] + pe if na else 0) + (o["add"] + sq + po if no else 0)
           + poly(terms) + o["add"])
    normal = (3*o["sqr"] + 4*o["mul"] + 2*o["add"] + sq + dv
              + (o["add"] + de if na else 0)
              + (o["add"] + sq + do if no else 0)
              + (poly(sx) + o["add"] if sx else 0)
              + (poly(sy) + o["add"] if sy else 0))
    powers = pw*o["mul"]
    t32 = sum(2 + (i > 0 and j > 0)
              + (2 + (i > 1 and j > 0) + (i > 1 or j > 0) if i else 0)
              + (2 + (j > 1 and i > 0) + (j > 1 or i > 0) if j else 0)
              for i, j in terms)
    sag32 = (16 + (2*na + 1 if na else 0) + (2*no + 3 if no else 0)
             + (3*na + 1 if na else 0) + (5*no + 4 if no else 0)
             + pw + t32 + 5)
    iters = 2 + (0 if step["fast"] else 1)
    seed = 37 + 6*(13 + sag32)
    point = 3*(o["mul"] + o["add"])
    rnd = (point + powers + sag + normal + 2*o["mul"] + 2*o["add"] + 1 + dv
           + o["add"])
    return seed + iters*rnd + point + powers + sag + 3, normal + powers


def df32_phase_ops(step):
    """float32 operations of a grating or DOE step's phase part
    (csrc/df32_common.cuh surface_df): the DOE's path term (r^2, Horner
    over its nd path coefficients, the product and the sum into s), the
    substrate's normal (a conic cylinder's normal_cyl_df, a biconic's or
    toroid's df32 normal by df32_newton_ops, the radial one of a curved
    or figured row; none on a plane), the DOE's kick (r^2, Horner, two
    products) and the solve (grating_refract_df: on a plane b and the
    root of 1 - bx^2 - by^2; else 1/|n|^2, the groove vector q and its
    norm's inverse (a floor's compare counts one) for a grating, b,
    b.n, |b|^2, Gamma's root, the mirror's select and the new
    direction)."""
    o = DF_OPS
    dv = o["div1"] if step["fast"] else o["div"]
    sq = o["sqrt1"] if step["fast"] else o["sqrt"]
    an, doe = step["anam"], step["doe"]
    nd = len(doe) if doe is not None else 0
    grat = step["grat"] is not None
    horner = (nd - 1)*(o["mul"] + o["add"])
    r2 = 2*o["sqr"] + o["add"]
    f = r2 + horner + o["mul"] + o["add"] if nd else 0      # the path term
    figured = bool(step["asp"] or step["asp_odd"])
    plane = an is None and step["flat"] and not figured
    if an is not None and an["mode"] in ("cyl_y", "cyl_x"):
        f += o["sqr"] + 3*o["mul"] + o["add"] + sq + dv
    elif an is not None:
        f += df32_newton_ops(step)[1]
    elif not plane:
        f += df32_newton_ops(step)[1]
    if nd:
        f += r2 + horner + 2*o["mul"] + 2*o["add"]           # the kick
    mirror = 1 if step["kind"] == 2 else 0
    if plane:
        f += (3*o["mul"] + (o["add"] if grat else 0) + 2*o["sqr"]
              + 2*o["add"] + sq + o["add"] + mirror + o["add"])
        return f
    f += 2*o["sqr"] + 2*o["add"] + dv + 3*o["mul"]            # 1/|n|^2, mu u
    if grat:
        f += (4*o["mul"] + o["sqr"] + o["add"]                # qx, qy, qz
              + 3*o["sqr"] + 2*o["add"] + sq + 1 + dv         # 1/|q|
              + 3*(2*o["mul"] + o["add"]))                    # b += T q
    f += (4*o["mul"] + 2*o["add"]                             # b.n/|n|^2
          + 3*o["sqr"] + 2*o["add"]                           # |b|^2
          + o["sqr"] + 2*o["add"] + o["mul"] + sq             # the root
          + o["add"] + mirror + 3*o["add"] + 2*o["mul"])      # Gamma, u'
    return f


def df32_step_ops(step, path=False):
    """float32 operations of one surface_df (csrc/df32_common.cuh) for a
    planned step (ops.df32.plan), and of the path's s * n_before; a
    Newton row's intercept and normal by df32_newton_ops, a grating or
    DOE row's phase part by df32_phase_ops."""
    o = DF_OPS
    dv = o["div1"] if step["fast"] else o["div"]
    sq = o["sqrt1"] if step["fast"] else o["sqrt"]
    dot3 = 3*o["mul"] + 2*o["add"]
    flat, conic = step["flat"], step["k1"] is not None
    an = step["anam"]
    figured = bool(step["asp"] or step["asp_odd"]) and an is None
    cyl = an is not None and an["mode"] in ("cyl_y", "cyl_x")
    f = o["add"]                                    # z - dz
    if step["dxy"] is not None:
        f += 2*o["add"]
    if step["rot_df"] is not None:                  # in and out of the frame
        f += 4*3*dot3
    newton = df32_newton_ops(step) if an is not None or figured else None
    if an is not None:
        f += newton[0]
    elif flat:
        f += dv
    else:
        if conic:                                   # kz, u.y, y.y, u.u, e
            f += 3*o["mul"] + 2*dot3 + 2*o["add"] + 3*o["sqr"]
        else:
            f += 2*dot3
        f += (3*o["mul"] + 3*o["add"] + o["scale"] + o["sqr"]  # d, f, disc
              + sq + o["add"] + dv)                 # g, num or den, s
    if figured:
        f += newton[0]                              # the polish
    f += 3*(o["mul"] + o["add"])                    # the transfer
    if step["clip"] and step["radius"] is not None:
        f += 3
    if step.get("grat") is not None or step.get("doe") is not None:
        f += df32_phase_ops(step)
    elif step["kind"] and (newton is not None and not cyl):
        # the generic normal (nx, ny, 1): |N|^2 and u.N, then the
        # refraction or reflection on it
        f += newton[1] + 2*o["sqr"] + 2*o["mul"] + 4*o["add"]
        if step["kind"] == 2:
            f += o["scale"] + dv + 2*(o["mul"] + o["add"]) + o["add"]
        else:
            f += (o["sqr"] + o["add"] + dv + 3*o["mul"] + o["sqr"]
                  + 2*o["add"] + sq + 5*o["mul"] + 3*o["add"])
    elif step["kind"] and cyl:
        unit = an["circular"]
        f += newton[1]
        if step["kind"] == 2:
            f += o["scale"] + (0 if unit else dv) + 2*(o["mul"] + o["add"])
        else:
            f += o["sqr"] + o["add"]                # mu^2 - 1
            f += o["mul"] if unit else dv + 3*o["mul"]
            f += o["sqr"] + 2*o["add"] + sq         # g
            f += 5*o["mul"] + 2*o["add"]
    elif step["kind"]:
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
    plan (K10/K11) or the 5 float64 moments a plan (K12/K13), the plans'
    words (as the key packs them, cuda_spec.df32_plan_words; their flags
    are compile-time), over the HBM rate; the float32
    operations of df32_chain_ops (and DF32_MOMENT_OPS for each of the
    `live` rays, summed over plans) over 67 TFLOP/s, the float32 peak
    outside the tensor cores, which counts a fused multiply-add as
    two."""
    from rayopt_tpu_torch.ops.cuda_spec import df32_flags, df32_plan_words
    merit = "merit" in name
    nlam = len(plans)
    out = nlam*5*2 if merit else n*14*nlam
    nbytes = (n*12 + out + nlam*df32_plan_words(df32_flags(plans)))*4
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


# the df32 path's key of K10-K13: its tag in phase_spec_build's stats
DF32_LOOP_KEYS = {"trace_final_df32": "K10 fast clip=False path=True",
                  "trace_multi_df32": "K11 fast clip=False path=True",
                  "trace_merit_df32": "K12 fast clip=False",
                  "trace_merit_multi_df32": "K13 fast clip=False"}


def df32_entries(s, launches, worst, times, live, ptxas, sass, newton):
    """The kernels-line entries of K10-K13: `ms`/`plain_ms` with the fast
    plan at N_GRAD_TIME rays, `ms_exact`/`plain_ms_exact` with the exact
    one, the N_BENCH times beside them; no float64 instance.  Each also
    carries its df32 path key's registers, stack, spills and SASS
    size, and the Newton plans' (`newton`: phase_df32_newton_throughput's
    times and live rays, the Newton df32 paths' launches): for each
    timed lens its time, its spherical twin's and its bound, fast and
    exact (the aspheric double Gauss's N_BENCH times too), the
    registers and SASS of its path keys, and the launches of
    the aspheric double Gauss's and the pair's df32 paths."""
    from rayopt_tpu_torch.ops import df32 as D
    from rayopt_tpu_torch.ops.tables import table_at
    ntimes, nlive, nlaunches = newton
    tabs = s.tables()
    nlam = tabs.curvature.shape[0]
    entries = []
    for kname in DF32_NAMES:
        multi = "multi" in kname
        lam = nlam if multi else 1
        entry = {"name": kname, "route": "cuda",
                 "source": "rayopt_tpu_torch/csrc/df32_spec.cuh",
                 "replaces": DF32_REPLACES[kname],
                 "launches": launches[kname], "max_abs_err": worst[kname]}
        tag = DF32_LOOP_KEYS[kname]
        regs, stack, spill = ptxas[tag]
        entry.update({"regs_f32": regs, "stack_bytes_f32": stack,
                      "spill_bytes_f32": spill,
                      "sass_instructions": sass[tag][0],
                      "sass_bytes": sass[tag][1]})
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
            for lens in DF32_TIMED:
                short = DF32_SHORT[lens]
                newton_plans = df32_timed_plans(lens, plan == "fast")[0]
                nplans = newton_plans[1] if multi else [newton_plans[0]]
                for n in (N_GRAD_TIME, N_BENCH):
                    if (kname, lens, plan, n) not in ntimes:
                        continue
                    k, t, _ = ntimes[(kname, lens, plan, n)]
                    at = "%s%s%s" % (short, sfx, "" if n == N_GRAD_TIME
                                     else "_%d_rays" % n)
                    bound = df32_bound(kname, n, nplans,
                                       nlive[(lens, n)]*len(nplans))[0]
                    entry.update({"ms_" + at: k, "twin_ms_" + at: t,
                                  "bound_ms_" + at: bound})
        for lens in DF32_TIMED:
            key = "%s %s fast clip=False%s" % (
                DF32_LOOP_KEYS[kname][:3], lens,
                " path=True" if "merit" not in kname else "")
            regs, stack, spill = ptxas[key]
            short = DF32_SHORT[lens]
            entry.update({"regs_f32_" + short: regs,
                          "spill_bytes_f32_" + short: spill,
                          "sass_instructions_" + short: sass[key][0]})
        for lens, counts in nlaunches.items():
            entry["launches_" + DF32_SHORT[lens]] = counts[kname]
        entries.append(entry)
    return entries


# the kernels line's names of the timed Newton lenses
DF32_SHORT = {"aspheric double Gauss": "aspheric", "anamorphic pair": "pair",
              "split-conic biconic": "biconic"}


def asphere_entries(sources, launches, worst, times, ptxas, steps, opt_step,
                    mtimes, mlive):
    """The kernels line's entries of the figured keys (the aspheric
    double Gauss): the aspheric path's launches, the float32 errors of
    phase_asphere_check, the times of the throughput phases run on it
    (beside the double Gauss's keys and the plain versions; K3 and K6-K9
    from phase_multi_throughput's and phase_opd_throughput's aspheric
    runs, `mtimes`, and their live rays under "multi" and "opd",
    `mlive`), the bounds counted with the Newton (kernel_bound's
    widths), and the loop keys' registers, stack and spills."""
    from rayopt_tpu_torch.ops.cuda_trace import trace_merit
    s, table, specs, widths = asphere_cases()["aspheric double Gauss"]
    # live rays of the K5 timing bundles (its reverse runs for these only)
    live = {key: float(trace_merit(table, specs, bench_bundle(
        n, dtype, SEED + 1))[0]) for key, n, dtype in (
            (torch.float32, N_GRAD_TIME, torch.float32),
            (torch.float64, N_GRAD_TIME, torch.float64),
            (N_OPT_BUNDLE, N_OPT_BUNDLE, torch.float64),
            (N_BENCH, N_BENCH, torch.float32))}
    newton, chain = newton_flops(specs, widths), chain_flops(specs, widths)
    k, sp_ = times[("trace_final", N_BENCH)], times[("trace_final", N_BENCH,
                                                     "twin")]
    log("aspheric double Gauss: the Newton's steps are %d of the chain's %d "
        "operations a ray (%.1f%%, counted from the code); K1 float32 at %d "
        "rays %.4f ms against the double Gauss key's %.4f ms: the figured "
        "rows take %.1f%% of the aspheric key's time (measured)"
        % (newton, chain, 100*newton/chain, N_BENCH, k, sp_,
           100*(k - sp_)/k))
    loop = {"trace_final": "K1 %s aspheric", "trace_merit": "K2 %s aspheric",
            "weighted_moments": "K4 %s aspheric",
            "merit_adjoint": "K5 %s aspheric designer rays=False"}
    out = []
    for kname, tag in loop.items():
        source, replaces = sources[kname]
        k32, p32 = times[(kname, torch.float32)]
        k64, p64 = times[(kname, torch.float64)]

        def bound(dtype, name=kname, n=N_GRAD_TIME, lv=None):
            return kernel_bound(name, n, dtype, specs, 1,
                                live[dtype] if lv is None else lv, widths)
        b32, by = bound(torch.float32)
        big = "_f32_%d_rays" % N_BENCH
        entry = {
            "name": kname + "_aspheric", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "bound_ms": b32, "bound_by": by, "library_ms": None,
            "ms_f64": k64, "plain_ms_f64": p64,
            "bound_ms_f64": bound(torch.float64)[0],
            "ms_spherical_key": times[(kname, torch.float32, "twin")],
            "ms_spherical_key_f64": times[(kname, torch.float64, "twin")],
            "rays": N_GRAD_TIME, "wavelengths": 1,
            "aspheric_widths": list(widths),
            "ms" + big: times[(kname, N_BENCH)],
            "bound_ms" + big: bound(torch.float32, n=N_BENCH,
                                    lv=live[N_BENCH])[0]}
        for dt in ("float32", "float64"):
            regs, stack, spill = ptxas[tag % dt]
            sfx = "" if dt == "float64" else "_f32"
            entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                          "spill_bytes" + sfx: spill})
        if kname in ("trace_final", "trace_merit"):
            entry["ms_spherical_key" + big] = times[(kname, N_BENCH, "twin")]
        else:
            opt = "_f64_%d_rays" % N_OPT_BUNDLE
            entry["ms" + opt] = times[(kname, N_OPT_BUNDLE)]
            entry["bound_ms" + opt] = bound(torch.float64, n=N_OPT_BUNDLE,
                                            lv=live[N_OPT_BUNDLE])[0]
        if kname == "merit_adjoint":
            opt = "merit_adjoint_optimizer"
            entry.update({
                "ms_designer": times[(opt, torch.float32)],
                "ms_designer_f64": times[(opt, torch.float64)],
                "ms_spherical_optimizer_key":
                    times[(opt, torch.float32, "twin")],
                "ms_spherical_optimizer_key_f64":
                    times[(opt, torch.float64, "twin")],
                "bound_ms_designer_f64": bound(torch.float64, opt)[0],
                "designer_step_s": steps["designer"],
                "spherical_optimizer_step_s": opt_step})
            for dt in ("float32", "float64"):
                regs, stack, spill = ptxas["K5 %s aspheric all rays=True"
                                           % dt]
                sfx = "" if dt == "float64" else "_f32"
                entry.update({"regs_all_rays" + sfx: regs,
                              "stack_bytes_all_rays" + sfx: stack,
                              "spill_bytes_all_rays" + sfx: spill})
        out.append(entry)
    # K3, K6-K9: the loop key's registers (K7, K9) and the key for every
    # field with the ray cotangents beside it
    _, mspecs = asphere_stack("aspheric double Gauss", s, table)
    multi = {"trace_multi": ("K3 %s aspheric merit", None, 3),
             "weighted_moments_multi": ("K6 %s aspheric", None, 3),
             "merit_adjoint_multi": (
                 "K7 %s aspheric achromatization rays=False",
                 "K7 %s aspheric all rays=True", 3),
             "opd_chain": ("K8 %s aspheric", None, 1),
             "opd_adjoint": ("K9 %s aspheric design rays=False",
                             "K9 %s aspheric all rays=True", 1)}
    for kname, (tag, all_tag, lam) in multi.items():
        source, replaces = sources[kname]
        kind = "multi" if lam > 1 else "opd"
        kspecs = mspecs if lam > 1 else specs
        k32, p32, t32 = mtimes[(kname, torch.float32)]
        k64, p64, t64 = mtimes[(kname, torch.float64)]

        def bound(dtype, name=kname, n=N_GRAD_TIME, lv=None):
            lv = mlive[kind][dtype if lv is None else lv]
            return kernel_bound(name, n, dtype, kspecs, lam, lv, widths)
        b32, by = bound(torch.float32)
        big = "_f64_%d_rays" % N_OPT_BUNDLE
        entry = {
            "name": kname + "_aspheric", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": k32, "plain_ms": p32,
            "bound_ms": b32, "bound_by": by, "library_ms": None,
            "ms_f64": k64, "plain_ms_f64": p64,
            "bound_ms_f64": bound(torch.float64)[0],
            "ms_spherical_key": t32, "ms_spherical_key_f64": t64,
            "rays": N_GRAD_TIME, "wavelengths": lam,
            "aspheric_widths": list(widths),
            "ms" + big: mtimes[(kname, N_OPT_BUNDLE)],
            "ms_spherical_key" + big: mtimes[(kname, N_OPT_BUNDLE, "twin")],
            "bound_ms" + big: bound(torch.float64, n=N_OPT_BUNDLE,
                                    lv=N_OPT_BUNDLE)[0]}
        loop = {"trace_multi": "trace_multi_trace",
                "merit_adjoint_multi": "merit_adjoint_multi_loop",
                "opd_adjoint": "opd_adjoint_loop"}.get(kname)
        if loop:
            # K3's trace mode, or the loop's key, beside the entry's
            sfx = "_trace" if kname == "trace_multi" else "_loop_key"
            lk32, lp32, lt32 = mtimes[(loop, torch.float32)]
            lk64, lp64, lt64 = mtimes[(loop, torch.float64)]
            entry.update({
                "ms" + sfx: lk32, "ms" + sfx + "_f64": lk64,
                "ms_spherical_key" + sfx: lt32,
                "ms_spherical_key" + sfx + "_f64": lt64,
                "bound_ms" + sfx: bound(torch.float32, loop)[0],
                "bound_ms" + sfx + "_f64": bound(torch.float64, loop)[0],
                "ms" + sfx + big: mtimes[(loop, N_OPT_BUNDLE)],
                "ms_spherical_key" + sfx + big:
                    mtimes[(loop, N_OPT_BUNDLE, "twin")]})
            if kname == "trace_multi":
                entry.update({"plain_ms_trace": lp32,
                              "plain_ms_trace_f64": lp64})
        for dt in ("float32", "float64"):
            sfx = "" if dt == "float64" else "_f32"
            for t, pre in ((tag, ""), (all_tag, "_all_rays")):
                if t:
                    regs, stack, spill = ptxas[t % dt]
                    entry.update({"regs" + pre + sfx: regs,
                                  "stack_bytes" + pre + sfx: stack,
                                  "spill_bytes" + pre + sfx: spill})
            if kname == "trace_multi":
                regs, stack, spill = ptxas["K3 %s aspheric trace" % dt]
                entry.update({"regs_trace" + sfx: regs,
                              "stack_bytes_trace" + sfx: stack,
                              "spill_bytes_trace" + sfx: spill})
        if kname in ("trace_multi", "weighted_moments_multi",
                     "merit_adjoint_multi"):
            entry["achromatization_step_s"] = steps["achromatization"]
        else:
            entry["design_step_s"] = steps["design"]
        out.append(entry)
    return out


def anamorphic_entries(sources, launches, worst, times, mlive, ptxas,
                       steps, dg_steps, figured):
    """The kernels line's entries of the anamorphic keys (the crossed-
    cylinder pair): the anamorphic path's launches, the float32 errors
    of phase_anamorphic_check, the times of phase_anamorphic_throughput
    (the pair's keys beside their plain versions and spherical twins,
    the split-conic biconic's -- the Newton -- beside its own, under
    "biconic_"; at N_GRAD_TIME rays in both dtypes and at N_BENCH in
    float32; K3, K6 and K7 on the lens's stack of 3 tables, with their
    live rays `mlive`), the bounds (row_flops: the cylinders as the
    conic, the biconic's 10 Newton steps), the loop keys' registers,
    stack and spills, and the loops' later-step seconds (`steps`) beside
    the double Gauss's (`dg_steps`: designer, achromatization,
    design); then each kernel's float64 times on the figured lenses
    (`figured`: phase_figured_throughput's times and live rays) beside
    their plain versions' and their bounds (with the figure's
    operations), under "figured_toroid_" and "figured_biconic_"."""
    from rayopt_tpu_torch.ops.cuda_trace import trace_merit
    cases = anamorphic_cases()
    fcases = figured_anamorphic_cases()
    ftimes, flive = figured

    def put_figured(entry, kname, lam):
        """The figured lenses' float64 times of `kname`'s key."""
        for lens, (_, ftab, fspecs, widths) in fcases.items():
            k, p = ftimes[lens][kname]
            sp = anam_stack(ftab)[1] if lam > 1 else fspecs
            lv = flive[lens]*lam
            pre = lens.replace(" ", "_") + "_"
            entry.update({pre + "ms_f64": k, pre + "plain_ms_f64": p,
                          pre + "rays": N_FIGURED_TIME,
                          pre + "bound_ms_f64": kernel_bound(
                              kname, N_FIGURED_TIME, torch.float64, sp, lam,
                              lv, widths)[0]})
    # live rays of the timing bundles (K5's reverse runs for these only)
    live = {(lens, n, dtype): float(trace_merit(
        cases[lens][1], cases[lens][2], anam_bundle(n, dtype, SEED + 1))[0])
        for lens in ANAM_TIMED for n, dtype in (
            (N_GRAD_TIME, torch.float32), (N_GRAD_TIME, torch.float64),
            (N_BENCH, torch.float32))}
    dg = dict(zip(("designer", "achromatization", "design"), dg_steps))
    loop = {"trace_final": "K1 %s anamorphic clip=False",
            "trace_merit": "K2 %s anamorphic clip=False",
            "weighted_moments": "K4 %s anamorphic clip=False",
            "merit_adjoint": "K5 %s anamorphic designer rays=False"}
    big = "_f32_%d_rays" % N_BENCH
    out = []
    for kname, tag in loop.items():
        source, replaces = sources[kname]
        entry = {"name": kname + "_anamorphic", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_GRAD_TIME, "wavelengths": 1}
        for lens, pre in zip(ANAM_TIMED, ("", "biconic_")):
            specs, tt = cases[lens][2], times[lens]

            def bound(n, dtype, name=kname, sp=specs, ln=lens):
                return kernel_bound(name, n, dtype, sp, 1,
                                    live[(ln, n, dtype)])
            for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
                k, p = tt[(kname, dtype)]
                b, by = bound(N_GRAD_TIME, dtype)
                entry.update({pre + "ms" + sfx: k, pre + "plain_ms" + sfx: p,
                              pre + "ms_spherical_key" + sfx:
                                  tt[(kname, dtype, "twin")],
                              pre + "bound_ms" + sfx: b})
                if not pre and not sfx:
                    entry["bound_by"] = by
                if kname == "merit_adjoint":
                    opt = "merit_adjoint_optimizer"
                    entry.update({
                        pre + "ms_designer" + sfx: tt[(opt, dtype)],
                        pre + "ms_spherical_designer_key" + sfx:
                            tt[(opt, dtype, "twin")],
                        pre + "bound_ms_designer" + sfx:
                            bound(N_GRAD_TIME, dtype, opt)[0]})
            entry.update({pre + "ms" + big: tt[(kname, N_BENCH)],
                          pre + "ms_spherical_key" + big:
                              tt[(kname, N_BENCH, "twin")],
                          pre + "bound_ms" + big:
                              bound(N_BENCH, torch.float32)[0]})
        for dt in ("float32", "float64"):
            regs, stack, spill = ptxas[tag % dt]
            sfx = "" if dt == "float64" else "_f32"
            entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                          "spill_bytes" + sfx: spill})
            for lens in ("anamorphic", "split-conic", "toroid"):
                knum = tag.split()[0]
                ktag = ("%s %s %s clip=False" % (knum, dt, lens)
                        + (" all rays=True" if knum == "K5" else ""))
                regs, stack, spill = ptxas[ktag]
                key = lens.split("-")[0]
                entry.update({"regs_%s%s" % (key, sfx): regs,
                              "spill_bytes_%s%s" % (key, sfx):
                                  stack + spill})
        if kname == "merit_adjoint":
            entry.update({"designer_step_s": steps["designer"],
                          "spherical_optimizer_step_s": dg["designer"]})
        put_figured(entry, kname, 1)
        out.append(entry)
    # K3, K6-K9 on each timed lens's keys (K3, K6, K7 on its stack):
    # (the loop key's tag, the key for every field with the ray
    # cotangents, wavelengths, the loop key's times, the loop's step)
    multi = {"trace_multi": ("K3 %s %s merit", None, 3, "trace_multi_trace",
                             "achromatization"),
             "weighted_moments_multi": ("K6 %s %s clip=False", None, 3, None,
                                        "achromatization"),
             "merit_adjoint_multi": (
                 "K7 %s %s achromatization rays=False",
                 "K7 %s %s clip=False all rays=True", 3,
                 "merit_adjoint_multi_loop", "achromatization"),
             "opd_chain": ("K8 %s %s clip=False", None, 1, None, "design"),
             "opd_adjoint": ("K9 %s %s design rays=False",
                             "K9 %s %s clip=False all rays=True", 1,
                             "opd_adjoint_loop", "design")}
    for kname, (tag, all_tag, lam, loop_name, path) in multi.items():
        source, replaces = sources[kname]
        kind = "multi" if lam > 1 else "opd"
        entry = {"name": kname + "_anamorphic", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": launches[kname], "max_abs_err": worst[kname],
                 "library_ms": None, "rays": N_GRAD_TIME, "wavelengths": lam}
        for lens, pre in zip(ANAM_TIMED, ("", "biconic_")):
            specs, tt = cases[lens][2], times[lens]
            kspecs = anam_stack(cases[lens][1])[1] if lam > 1 else specs
            lv = mlive[lens][kind]

            def bound(n, dtype, name=kname, sp=kspecs, lv=lv):
                return kernel_bound(name, n, dtype, sp, lam,
                                    lv[dtype if n == N_GRAD_TIME else n])
            for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
                k, p, t = tt[(kname, dtype)]
                b, by = bound(N_GRAD_TIME, dtype)
                entry.update({pre + "ms" + sfx: k, pre + "plain_ms" + sfx: p,
                              pre + "ms_spherical_key" + sfx: t,
                              pre + "bound_ms" + sfx: b})
                if not pre and not sfx:
                    entry["bound_by"] = by
                if loop_name:
                    lk, lp, lt = tt[(loop_name, dtype)]
                    lsfx = ("_trace" if kname == "trace_multi"
                            else "_loop_key") + sfx
                    entry.update({pre + "ms" + lsfx: lk,
                                  pre + "ms_spherical_key" + lsfx: lt,
                                  pre + "bound_ms" + lsfx:
                                      bound(N_GRAD_TIME, dtype,
                                            loop_name)[0]})
                    if kname == "trace_multi":
                        entry[pre + "plain_ms" + lsfx] = lp
            entry.update({pre + "ms" + big: tt[(kname, N_BENCH)],
                          pre + "ms_spherical_key" + big:
                              tt[(kname, N_BENCH, "twin")],
                          pre + "bound_ms" + big:
                              bound(N_BENCH, torch.float32)[0]})
        for dt in ("float32", "float64"):
            sfx = "" if dt == "float64" else "_f32"
            for t, pre in ((tag, ""), (all_tag, "_all_rays")):
                if t:
                    regs, stack, spill = ptxas[t % (dt, "anamorphic")]
                    entry.update({"regs" + pre + sfx: regs,
                                  "stack_bytes" + pre + sfx: stack,
                                  "spill_bytes" + pre + sfx: spill})
            if kname == "trace_multi":
                regs, stack, spill = ptxas["K3 %s anamorphic trace" % dt]
                entry.update({"regs_trace" + sfx: regs,
                              "stack_bytes_trace" + sfx: stack,
                              "spill_bytes_trace" + sfx: spill})
        entry.update({path + "_step_s": steps[path],
                      "double_gauss_" + path + "_step_s": dg[path]})
        put_figured(entry, kname, lam)
        out.append(entry)
    return out


def main():
    name, card = phase_card()
    from rayopt_tpu_torch.models import double_gauss
    from rayopt_tpu_torch.ops.cuda_trace import multi_specs, trace_merit
    from rayopt_tpu_torch.ops.kernels import specialize
    s = double_gauss()
    table = s.table()           # the default device: the card
    specs = specialize(table)   # from the float64 table
    tabs = s.tables()           # 3 wavelengths
    mspecs = multi_specs(tabs, None)
    keys = spec_keys(
        specs, mspecs, tabs.curvature.shape[0],
        [(name, specialize(tab)) for name, _, tab, _ in intercept_cases()])
    keys.update(df32_keys(s))
    keys.update(split_keys(s))
    keys.update(asphere_keys())
    keys.update(anamorphic_keys())
    keys.update(grating_keys())
    keys.update(df32_phase_keys())
    keys.update(phase_cylinder_keys())
    keys.update(freeform_keys())
    keys.update(freeform_multi_keys())
    keys.update(df32_freeform_keys())
    pcases = pose_cases()
    keys.update(pose_keys(pcases))
    ptxas, sass = phase_spec_build(keys)
    worst = phase_check(table, specs)
    phase_spec_check(table, specs)
    worst.update(phase_grad_check(table, specs))
    phase_fd_check(table, specs)
    worst.update(phase_multi_check(tabs, mspecs))
    phase_glass_fd_check(s, tabs, mspecs)
    worst.update(phase_opd_check(s, table, specs))
    phase_opd_fd_check(s, table, specs)
    worst.update(phase_df32_check(s))
    phase_split_check(s)
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
    # counts from its reset; the loops' bundles serve the pose path too
    opt_launches, opt_step, opt_bundles = phase_opt_path()
    launches.update({k: v for k, v in opt_launches.items()
                     if k in ("weighted_moments", "merit_adjoint")})
    # counts from its reset
    glass_launches, glass_step, glass_bundles = phase_glass_path(
        check_nrays=N_LOOP_CHECK)
    multi = ("trace_multi", "weighted_moments_multi", "merit_adjoint_multi")
    launches.update({k: glass_launches[k] for k in multi})
    design_launches, design_step, design_bundles = phase_design_path(
        check_nrays=N_LOOP_CHECK)
    opd = ("opd_chain", "opd_adjoint")
    launches.update({k: design_launches[k] for k in opd})
    # the rot cotangent: the rot keys against their plain versions and
    # central differences, then the pose path (counts from its resets)
    pworst = phase_pose_check(pcases)
    phase_pose_fd_check(pcases)
    pose_launches, pose_rot, pose_steps = phase_pose_path(
        (opt_step, glass_step, design_step),
        (opt_bundles, glass_bundles, design_bundles))
    log("== launch counts on the pose path: %s, rot keys %s"
        % (pose_launches, pose_rot))
    del opt_bundles, glass_bundles, design_bundles
    torch.cuda.empty_cache()
    aworst = phase_asphere_check()
    reset_launches()
    asph_launches, asph_steps, asph_aimed = phase_asphere_path(
        opt_step, glass_step, design_step)
    log("== launch counts on the aspheric path: %s" % asph_launches)
    asph = ("trace_final", "trace_merit", "weighted_moments",
            "merit_adjoint") + multi + opd
    if not all(asph_launches[k] for k in asph):
        raise AssertionError("a kernel of the aspheric path never launched: "
                             "%s" % asph_launches)
    newton_launches = {
        "aspheric double Gauss": newton_df32_path(
            aspheric_double_gauss(), asph_aimed, "aspheric double Gauss")}
    del asph_aimed
    nworst = phase_anamorphic_check()
    reset_launches()
    anam_launches, anam_steps, anam_aimed = phase_anamorphic_path(
        opt_step, glass_step, design_step)
    log("== launch counts on the anamorphic path: %s" % anam_launches)
    if not all(anam_launches[k] for k in asph):
        raise AssertionError("a kernel of the anamorphic path never "
                             "launched: %s" % anam_launches)
    from rayopt_tpu_torch.models import anamorphic_pair
    newton_launches["anamorphic pair"] = newton_df32_path(
        anamorphic_pair(), anam_aimed, "anamorphic pair")
    del anam_aimed
    torch.cuda.empty_cache()
    gworst = phase_grating_check()
    reset_launches()
    phase_spectrograph_path()
    spec_launches = read_launches()
    log("== launch counts on the spectrograph path: %s" % spec_launches)
    reset_launches()
    hyb_launches, hyb_steps, hyb_aimed = phase_hybrid_path(
        opt_step, glass_step, design_step)
    log("== launch counts on the hybrid achromat path: %s" % hyb_launches)
    phase_kernels = ("trace_final", "trace_merit", "weighted_moments",
                     "merit_adjoint") + multi + opd
    if not (spec_launches["trace_final"] and spec_launches["trace_merit"]
            and spec_launches["trace_multi"]
            and all(hyb_launches[k] for k in phase_kernels)):
        raise AssertionError("a kernel of the phase paths never launched: "
                             "%s, %s" % (spec_launches, hyb_launches))
    phase_launches = {k: spec_launches[k] + hyb_launches[k]
                      for k in phase_kernels}
    torch.cuda.empty_cache()
    dpworst = phase_df32_phase_check()
    reset_launches()
    phase_df32_phase_path(hyb_aimed)
    dp_launches = read_launches()
    log("== launch counts on the df32 phase path (the hybrid achromat, the "
        "spectrograph, the kinoform): %s" % dp_launches)
    if not all(dp_launches[k] for k in DF32_NAMES):
        raise AssertionError("a kernel of the df32 phase path never "
                             "launched: %s" % dp_launches)
    del hyb_aimed
    torch.cuda.empty_cache()
    cworst = phase_cylinder_check()
    reset_launches()
    phase_cylinder_path()
    cyl_launches = read_launches()
    log("== launch counts on the phase cylinder path: %s" % cyl_launches)
    if not all(cyl_launches[k] for k in CYL_KERNELS
               if k != "trace_multi_trace"):
        raise AssertionError("a kernel of the phase cylinder path never "
                             "launched: %s" % cyl_launches)
    torch.cuda.empty_cache()
    fworst = phase_freeform_check()
    fmworst = phase_freeform_multi_check()
    reset_launches()
    ff_launches, ff_step, ff_aimed = phase_freeform_path(opt_step)
    log("== launch counts on the freeform path: %s" % ff_launches)
    if not all(ff_launches[k] for k in ("trace_final", "trace_merit",
                                        "weighted_moments",
                                        "merit_adjoint")):
        raise AssertionError("a kernel of the freeform path never launched: "
                             "%s" % ff_launches)
    reset_launches()
    ffl_launches, ffl_steps = phase_freeform_loops(glass_step, design_step)
    log("== launch counts on the freeform loops: %s" % ffl_launches)
    if not all(ffl_launches[k] for k in multi + opd):
        raise AssertionError("a kernel of the freeform loops never "
                             "launched: %s" % ffl_launches)
    torch.cuda.empty_cache()
    dfworst = phase_df32_freeform_check()
    dff_launches = phase_df32_freeform_path(ff_aimed)
    del ff_aimed
    torch.cuda.empty_cache()
    ptimes = phase_grating_throughput(card)
    pmtimes, pmlive = phase_multi_throughput_grating(card)
    ntimes, nlive = phase_anamorphic_throughput(card)
    ftimes, flive = phase_figured_throughput(card)
    times = phase_throughput(table, specs, card)
    gtimes = phase_grad_throughput(table, specs, card)
    mtimes, mlive = phase_multi_throughput(tabs, mspecs, card)
    otimes, olive = phase_opd_throughput(s, table, specs, card)
    dtimes, dlive = phase_df32_throughput(s, card)
    dntimes, dnlive = phase_df32_newton_throughput(card)
    dptimes, dplive = phase_df32_phase_throughput(card)
    ctimes, clive = phase_cylinder_throughput(card)
    fftimes = phase_freeform_throughput(card)
    fmtimes, fmlive = phase_freeform_multi_throughput(card)
    dftimes, dflive = phase_df32_freeform_throughput(card)
    potimes, polive = phase_pose_throughput(card, pcases)
    _, atab, aspecs, _ = asphere_cases()["aspheric double Gauss"]
    atimes = phase_throughput(atab, aspecs, card, N_GRAD_TIME,
                              (table, specs), N_BENCH,
                              "aspheric double Gauss")
    atimes.update(phase_grad_throughput(atab, aspecs, card, (table, specs),
                                        ASPH_SELECT, "aspheric double Gauss"))
    as_, _, _, _ = asphere_cases()["aspheric double Gauss"]
    atabs, amspecs = asphere_stack("aspheric double Gauss", as_, atab)
    amtimes, amlive = phase_multi_throughput(atabs, amspecs, card,
                                             (tabs, mspecs),
                                             ASPH_ACHROM_FIELDS,
                                             "aspheric double Gauss")
    aotimes, aolive = phase_opd_throughput(as_, atab, aspecs, card,
                                           (s, table, specs),
                                           ASPH_DESIGN_FIELDS,
                                           "aspheric double Gauss")
    amtimes.update(aotimes)
    # live rays of the K5 timing bundles (its reverse runs for these only)
    live_mono = float(trace_merit(table, specs, bench_bundle(
        N_GRAD_TIME, torch.float32, SEED + 1))[0])
    live_opt = float(trace_merit(table, specs, bench_bundle(
        N_OPT_BUNDLE, torch.float64, SEED + 1))[0])
    spec_cuh = "rayopt_tpu_torch/csrc/grad_spec.cuh"
    sources = {
        "trace_final": (spec_cuh, "rayopt_tpu/ops/pallas_trace.py:82"),
        "trace_merit": (spec_cuh, "rayopt_tpu/ops/pallas_trace.py:170"),
        "weighted_moments": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:236"),
        "merit_adjoint": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:395"),
        "trace_multi": (spec_cuh, "rayopt_tpu/ops/pallas_trace.py:284"),
        "weighted_moments_multi": (spec_cuh,
                                   "rayopt_tpu/ops/pallas_grad.py:248"),
        "merit_adjoint_multi": (spec_cuh,
                                "rayopt_tpu/ops/pallas_grad.py:421"),
        "opd_chain": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:1077"),
        "opd_adjoint": (spec_cuh, "rayopt_tpu/ops/pallas_grad.py:1094")}
    # the loop key of each specialized kernel: its tag in `ptxas`
    loop_keys = {"trace_final": "K1 %s clip=False",
                 "trace_multi": "K3 %s merit nlam=%d" % (
                     "%s", tabs.curvature.shape[0]),
                 "opd_chain": "K8 %s clip=False",
                 "trace_merit": "K2 %s clip=False",
                 "weighted_moments": "K4 %s clip=False",
                 "weighted_moments_multi": "K6 %s clip=False nlam=%d" % (
                     "%s", tabs.curvature.shape[0]),
                 "merit_adjoint": "K5 %s clip=False optimizer rays=False",
                 "merit_adjoint_multi":
                     "K7 %s clip=False achromatization rays=False",
                 "opd_adjoint": "K9 %s clip=False design rays=False"}
    nlam = tabs.curvature.shape[0]
    kernels = []
    for kname, (source, replaces) in sources.items():
        if kname in multi:
            tt, rays, lam, live = mtimes, N_GRAD_TIME, nlam, \
                mlive[torch.float32]
        elif kname in ("weighted_moments", "merit_adjoint"):
            tt, rays, lam, live = gtimes, N_GRAD_TIME, 1, live_mono
        elif kname in opd:
            tt, rays, lam, live = otimes, N_GRAD_TIME, 1, \
                olive[torch.float32]
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
        if kname in loop_keys:
            tag = loop_keys[kname]
            for dt in ("float32", "float64"):
                regs, stack, spill = ptxas[tag % dt]
                sfx = "" if dt == "float64" else "_f32"
                entry.update({"regs" + sfx: regs, "stack_bytes" + sfx: stack,
                              "spill_bytes" + sfx: spill})
        big = "_%d_rays" % N_OPT_BUNDLE
        if kname in ("merit_adjoint_multi", "opd_adjoint"):
            # the loop's key beside the work of the earlier kernel, and
            # both at one loop bundle in float64
            loop = kname + "_loop"
            live_big = (mlive if kname in multi else olive)[N_OPT_BUNDLE]
            live64 = (mlive if kname in multi else olive)[torch.float64]
            entry.update({
                "ms_loop_key": tt[(loop, torch.float32)][0],
                "ms_loop_key_f64": tt[(loop, torch.float64)][0],
                "bound_ms_loop_key_f64": kernel_bound(
                    loop, N_GRAD_TIME, torch.float64, kspecs, lam,
                    live64)[0],
                "ms_f64" + big: tt[(kname, N_OPT_BUNDLE)],
                "bound_ms_f64" + big: kernel_bound(
                    kname, N_OPT_BUNDLE, torch.float64, kspecs, lam,
                    live_big)[0],
                "ms_loop_key_f64" + big: tt[(loop, N_OPT_BUNDLE)],
                "bound_ms_loop_key_f64" + big: kernel_bound(
                    loop, N_OPT_BUNDLE, torch.float64, kspecs, lam,
                    live_big)[0]})
        if kname == "opd_chain":
            entry["ms_f64" + big] = tt[(kname, N_OPT_BUNDLE)]
            entry["bound_ms_f64" + big] = kernel_bound(
                kname, N_OPT_BUNDLE, torch.float64, kspecs)[0]
        if kname == "weighted_moments_multi":
            entry["ms_f64" + big] = tt[(kname, N_OPT_BUNDLE)]
            entry["bound_ms_f64" + big] = kernel_bound(
                kname, N_OPT_BUNDLE, torch.float64, kspecs, lam)[0]
        if kname in ("weighted_moments", "merit_adjoint"):
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
        if kname == "trace_multi":
            # K3's trace mode beside its merit: times, bound, registers
            # and the SASS size of both keys
            tm, tag = "trace_multi_trace", "K3 %s trace nlam=%d"
            mtag = loop_keys[kname]
            entry.update({
                "ms_trace": tt[(tm, torch.float32)][0],
                "plain_ms_trace": tt[(tm, torch.float32)][1],
                "twin_ms_trace": tt[(tm, torch.float32)][2],
                "ms_trace_f64": tt[(tm, torch.float64)][0],
                "plain_ms_trace_f64": tt[(tm, torch.float64)][1],
                "twin_ms_trace_f64": tt[(tm, torch.float64)][2],
                "bound_ms_trace": kernel_bound(tm, rays, torch.float32,
                                               kspecs, lam)[0],
                "bound_ms_trace_f64": kernel_bound(tm, rays, torch.float64,
                                                   kspecs, lam)[0],
                "ms_trace_f32_%d_rays" % N_BENCH: tt[(tm, N_BENCH)],
                "bound_ms_trace_f32_%d_rays" % N_BENCH: kernel_bound(
                    tm, N_BENCH, torch.float32, kspecs, lam)[0]})
            for dt in ("float32", "float64"):
                sfx = "" if dt == "float64" else "_f32"
                regs, stack, spill = ptxas[tag % (dt, lam)]
                entry.update({"regs_trace" + sfx: regs,
                              "stack_bytes_trace" + sfx: stack,
                              "spill_bytes_trace" + sfx: spill,
                              "sass_instructions" + sfx:
                                  sass[mtag % dt][0],
                              "sass_instructions_trace" + sfx:
                                  sass[tag % (dt, lam)][0]})
        if kname in multi:
            entry["twin_ms"] = tt[(kname, torch.float32)][2]
            entry["twin_ms_f64"] = tt[(kname, torch.float64)][2]
            entry["twin_ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH,
                                                         "twin")]
        if tt is not times:
            entry["ms_f32_%d_rays" % N_BENCH] = tt[(kname, N_BENCH)]
        kernels.append(entry)
    kernels += asphere_entries(sources, asph_launches, aworst, atimes,
                               ptxas, asph_steps, opt_step, amtimes,
                               {"multi": amlive, "opd": aolive})
    kernels += anamorphic_entries(sources, anam_launches, nworst, ntimes,
                                  nlive, ptxas, anam_steps,
                                  (opt_step, glass_step, design_step),
                                  (ftimes, flive))
    kernels += grating_entries(sources, phase_launches, gworst, ptimes,
                               ptxas, hyb_steps["designer"], opt_step)
    kernels += grating_multi_entries(
        sources, phase_launches, gworst, pmtimes, pmlive, ptxas, hyb_steps,
        {"achromatization": glass_step, "design": design_step})
    kernels += df32_entries(s, launches, worst, dtimes, dlive, ptxas, sass,
                            (dntimes, dnlive, newton_launches))
    kernels += df32_phase_entries(dp_launches, dpworst, dptimes, dplive,
                                  ptxas, sass)
    kernels += cylinder_entries(sources, cyl_launches, cworst, ctimes,
                                clive, ptxas)
    kernels += freeform_entries(sources, ff_launches, fworst, fftimes, ptxas,
                                ff_step, opt_step)
    kernels += freeform_multi_entries(
        sources, ffl_launches, fmworst, fmtimes, fmlive, ptxas, ffl_steps,
        {"achromatization": glass_step, "design": design_step})
    kernels += df32_freeform_entries(dff_launches, dfworst, dftimes, dflive,
                                     ptxas, sass)
    kernels += pose_entries(sources, pose_rot, pworst, potimes, polive,
                            ptxas, pose_steps,
                            {"alignment": opt_step,
                             "achromatization": glass_step,
                             "design": design_step}, pcases)
    from rayopt_tpu_torch.ops import cuda_spec as CS
    late = sorted(k.name for k in CS._LOADED if k not in keys.values())
    log("== keys built at first use, outside phase_spec_build: %d %s"
        % (len(late), late))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
