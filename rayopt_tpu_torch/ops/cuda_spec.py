"""K1-K9 specialized per spec tuple at compile time, and the df32
kernels K10-K13 per plan key: every kernel of the port.

The fused trace K1 and its polychromatic twin K3 (trace mode "k3"), the
moment kernels -- the spot-moment merit K2, K3's merit mode ("k3m"),
the weighted-moment forward K4 and its polychromatic twin K6 --, the OPD
trace K8 and the adjoints -- K4's analytic adjoint K5, the
polychromatic adjoint K7 and the OPD adjoint K9 -- (csrc/grad_spec.cuh)
are compiled once for each key: the kernel, the dtype, one word a table
row (its SurfaceSpec flags, cuda_trace._flags, and for the adjoints
above LIVE_SHIFT the parameter slots it reduces), the aperture clip,
whether an adjoint writes the ray (and weight) cotangents, the block
size, the launch bound's blocks an SM, K3's and K6's wavelength count
(their wavelengths unroll; K7's count is a run-time argument) and the
order of K3's trace loops (`outer`).  A key's
translation unit is a few lines that instantiate the header's
templates with the row words as a template parameter pack, so the row
loop unrolls and every flag branch folds, and that export launchers
named by the key's hash.  nvcc builds it at first use into its own
shared library under build/torch_kernels/ (one nvcc run a new key,
seconds; `prebuild` runs several at once, a few keys a unit), cached
by a hash of the headers, the flags and the unit's text.  This is how
the JAX package's Pallas kernels are specialized too: on specs, clip
and diff_fields, and K3's and K6's wavelengths.

Every K1-K9 key also takes even- and odd-aspheric rows: it carries the
table's coefficient widths (Key.na, Key.no; cuda_trace.figure_widths, 0
and 0 without a row that reads them), which the translation unit defines
before the headers, so that a packed row grows by na + no words and the
Newton's Horner loops have compile-time bounds.  Every K1-K9 key takes
the anamorphic rows too (conic cylinders, biconics and toroids, the
latter two also with an aspheric figure): such a key's rows grow by
curvature_dx and conic_dx (Key.anamorphic, cuda_trace.
carries_anamorphic; RAYOPT_N_ANAM), an adjoint's slots by their
cotangents.  Every K1-K9 key takes the phase rows too -- a linear
grating or a radial diffractive phase (DOE) on a flat, spherical,
conic, aspheric, biconic or toroidal substrate --: such a key's rows
grow by grating_dy (Key.grating, cuda_trace.carries_grating;
RAYOPT_N_GRAT) and by n_after and the table's nd DOE coefficients
(Key.nd, cuda_trace.doe_width; RAYOPT_N_DOE), K5's and K7's slots by
the cotangents of grating_dy and of the coefficients, K9's by those of
grating_dy, of n_after (the DOE's optical path psi(r2) n_after) and of
the coefficients.  A phase row on a cylinder keeps the cylinder's
closed-form intercept and takes the normal of the biconic or toroid
that made it (its row word sets F_BICONIC or F_TOROID beside F_CYL_Y or
F_CYL_X, cuda_trace._anamorphic_flag).  Every K1-K9 key takes the
freeform XY rows too (F_FREEFORM): such a key's rows grow by the table's
nxy XY-monomial coefficients, last (Key.nxy, cuda_trace.xy_width;
RAYOPT_N_XY; K3 and K6 stage each table's own), an adjoint's slots by
their cotangents, last (K7 per table of the stack); a freeform row's
optical path is t n_before, as a figured row's.  Only a freeform figure
on an anamorphic base is refused (NotImplementedError, as `specialize`
refuses it).  A row word is 64 bits: its flags below LIVE_SHIFT, its
live slots above.  An adjoint key (K5, K7, K9) differentiates the rows'
rotation too when "rot" is among the fields asked for and some row of
its specs is rotated (`carries_rot`, the reference's _rot_diff_fields):
such a key (Key.rot; RAYOPT_ROT) has ROT = 9 slots more a row, R[i][j]
row-major, after every other slot, live on the rotated rows only (K9's
image row too: its reference-sphere tail reads its rotation).  A key
without it compiles to the code it did before.

The live slots of a row (curvature, conic, offset x, y, z, mu: K5's and
K7's six cotangent columns, then a figured key's na even and no odd
coefficients, then an anamorphic key's curvature_dx and conic_dx, then
a grating key's grating_dy, then a DOE key's nd coefficients, then a
freeform key's nxy XY coefficients, then a rot key's nine rotation
entries; K9 puts n_before between the six and the coefficients and
n_after before the DOE coefficients, OPD_SLOTS + na + no [+ 2] [+ 1]
[+ 1 + nd] + nxy [+ ROT] a row) are the fields
asked for, minus what the
row's specs bake out (cuda_grad._baked_out_rows: curvature of a flat
row, conic of a flat or spherical row -- both live on an aspheric row,
whose Newton reads them through the sag --, the transverse offset of an
on-axis row, mu of a passthrough row, the coefficients of a row that
reads no figure: neither aspheric nor a biconic or toroid, grating_dy
of a row that is no grating, the DOE coefficients -- and K9's n_after
-- of a row that is no DOE, the XY coefficients of a row that is not
freeform, the rotation of a row that is not rotated); the axial offset
is never baked out.
K9's image row is read only by the reference-sphere tail, which reads
its offset (the transverse part only off axis), its rotation (a rot
key's slots there) and its n_before, never its curvature, conic or mu; every other row's n_before
carries its optical path.  Row 0 has none.  A slot that is not live comes back as
an exact zero.

The df32 trace and merit (csrc/df32_spec.cuh) are keyed the same way
on their plans (`df32_multi_key`): the distinct flag tuples of the plans
(one cuda_df32 step flag word a step: every row kind, the freeform rows
too, whose XY term mask -- or a dense row's degree -- sits in bits 37-63
and makes the word negative at bit 63), the tuple each plan takes, the
optical path (the trace), where the chain reads the plan words (see
Df32Key), the block and the launch bound.  One plan is K10 (the trace)
or K12 (the merit), several are K11 or K13: one template each.  The
plan words stay run-time data, passed as kernel parameters, and the
wavelengths loop at run time over one compiled chain a tuple, so a key
has no wavelength cap: it is refused only past the parameter limit,
where a single plan reads its words from a device tensor instead.

A stack or plan list past a key's limit is split by its wrapper into
balanced runs (`runs`), one launch a run.
"""

import ctypes
import functools
import hashlib
from typing import NamedTuple

import torch

from . import kernels as K
from .cuda_trace import ANAM, ROW, SMEM_LIMIT, SMEM_OPTIN, _flags, \
    carries_anamorphic, carries_grating, doe_width, figure_widths, \
    pack_values, sm_count, xy_width

LIVE_SHIFT = 17    # a row word's live slots: keep in sync with grad_spec.cuh
LIVE_BITS = 63 - LIVE_SHIFT   # the slots a (64-bit) row word can hold
SLOTS = 6          # K5's and K7's cotangent columns a row (a figured
#                    key adds its table's aspheric coefficients, an
#                    anamorphic key then curvature_dx and conic_dx, a
#                    phase key grating_dy and the DOE coefficients)
OPD_SLOTS = 7      # K9's: SLOTS and n_before (then as K5's, with n_after
#                    before a DOE key's coefficients)
#: the table field of each of K9's first OPD_SLOTS cotangent columns
#: (K5/K7: the first SLOTS); the even, then the odd aspheric
#: coefficients follow them
SLOT_FIELDS = ("curvature", "conic", "offset", "offset", "offset", "mu",
               "n_before")
#: the fields K5 and K7 differentiate (a key of a table with no aspheric
#: row: the first four; curvature_dx and conic_dx only an anamorphic
#: key, grating_dy and doe only a key of a grating or DOE table, xy_poly
#: only a key of a freeform table)
FIELDS = ("curvature", "conic", "offset", "mu", "aspherics", "aspherics_odd",
          "curvature_dx", "conic_dx", "grating_dy", "doe", "xy_poly")
#: the fields K9 differentiates that K5 and K7 do, and n_before
OPD_FIELDS = FIELDS[:4] + ("n_before",) + FIELDS[4:]
#: every field K9 differentiates, in the order of cuda_grad._DIFF:
#: OPD_FIELDS and n_after, read only by a DOE row (its optical path
#: psi(r2) n_after) before doe; xy_poly last
OPD_DIFF = OPD_FIELDS[:10] + ("n_after",) + OPD_FIELDS[10:]
#: a rot key's slots a row: the rotation R[i][j], row-major, last.  "rot"
#: is differentiated only when asked for by name (never by default: a
#: rotated row's key without it is the key it was)
ROT = 9
ROT_FIELD = "rot"
HEADERS = ("trace_common.cuh", "step_vjp.cuh", "grad_spec.cuh",
           "df32_common.cuh", "df32_spec.cuh")
AUX = 5            # K9's aux vector: centre x, y, z, radius, lam_scale
BLOCK_TRACE = 512     # K1 and K8: measured fastest in both dtypes (PERF.md §6)
BLOCK_MOMENTS = 256   # K2, K4 and K6 (PERF.md §6)
#: K3's threads a block by dtype: its trace (wavelengths outermost, 60
#: registers in float64: two blocks of 512 an SM) and its merit, K2's
#: template at the stack's wavelengths (float32 6-8% faster at 512;
#: float64 4% faster at 256 at 2^26 rays); kernel_times --multi
#: --variants, PERF.md §6
BLOCK_MULTI = {"k3": {"f32": 512, "f64": 512},
               "k3m": {"f32": 512, "f64": 256}}
#: K3's trace loops: wavelengths outermost (one pass over the rays a
#: table, the chain compiled once), 1.12-1.17x faster than innermost in
#: float64 and 2.4% in float32 (PERF.md §6)
MULTI_OUTER = True
BLOCK_ADJOINT = 128   # measured fastest for K5 in float64 (PERF.md §6)
MIN_BLOCKS = 1        # __launch_bounds__'s blocks an SM (PERF.md §6)
#: K6's most wavelengths, and K3's merit's: the moments stay in
#: registers, 5 a wavelength, and the chain unrolls once a wavelength.
#: Measured on the double Gauss (PERF.md §6): at 11 both dtypes beat 11
#: K4 launches; at 12 the float32 build takes 138 registers, one
#: 256-thread block an SM, and ran 1.44x slower than 12 K4 launches; at
#: 16 the float64 build spilled.  K3's trace takes the same cap: with
#: the wavelengths outermost it reads the rays once a wavelength anyway,
#: so a split costs it no extra read.
MAX_NLAM = 11
#: the moment kernels (5 moments a table, no live slots)
MOMENTS = ("k2", "k3m", "k4", "k6")
#: the per-ray traces (outputs a ray, no reduction, no live slots)
TRACES = ("k1", "k3", "k8")
#: the kernels whose key carries a wavelength count
MULTI = ("k3", "k3m", "k6")
#: each kernel's macro in grad_spec.cuh
_MACROS = {"k1": "RAYOPT_SPEC_TRACE", "k2": "RAYOPT_SPEC_MERIT",
           "k3": "RAYOPT_SPEC_TRACE_MULTI", "k3m": "RAYOPT_SPEC_MERIT_MULTI",
           "k4": "RAYOPT_SPEC_MOMENTS", "k6": "RAYOPT_SPEC_MOMENTS_MULTI",
           "k8": "RAYOPT_SPEC_OPD", "k5": "RAYOPT_SPEC_ADJOINT",
           "k7": "RAYOPT_SPEC_ADJOINT_MULTI",
           "k9": "RAYOPT_SPEC_OPD_ADJOINT",
           "k11": "RAYOPT_DF32_TRACE", "k13": "RAYOPT_DF32_MERIT"}
#: the df32 keys' threads a block and whether each reads its plan words
#: from a shared-memory copy (else straight from the kernel's
#: parameters, where ptxas keeps them in registers across the ray loop),
#: by kernel: K11 and K13 (several plans), K10 and K12 (a "k11" or
#: "k13" key of one plan).  K11 runs faster direct (106 registers), K13
#: staged (direct, its 141 registers leave one block an SM); at one plan
#: both run fastest direct at 512 threads (64 and 72 registers);
#: kernel_times --df32 --variants, PERF.md §6
BLOCK_DF32 = {"k11": 256, "k13": 512, "k10": 512, "k12": 512}
DF32_STAGED = {"k11": False, "k13": True, "k10": False, "k12": False}
#: the kernel a df32 key of one plan is
ONE_PLAN = {"k11": "k10", "k13": "k12"}
#: the most bytes of kernel parameters a launch may pass (CUDA 12.1+ on
#: Volta and later), and those of K11/K13 beside the plan words: 12
#: input pointers, out (K13: partials, counter, out) and n
PARAM_LIMIT = 32764
DF32_PARAM_BYTES = {"k11": (12 + 1 + 1)*8, "k13": (12 + 3 + 1)*8}
#: the words' placement of each Df32Key (its C++ constant in
#: df32_spec.cuh)
WORDS_AT = ("WORDS_DIRECT", "WORDS_STAGED", "WORDS_DEVICE")


def baked_out_rows(specs, field):
    """Surface rows (1-indexed into the chain) whose static
    specialization never READS `field`, so its gradient there is
    structurally zero (specialized-engine semantics,
    pallas_grad._baked_out_rows).  An aspheric row's Newton reads its
    curvature and conic through the sag even when the row's flat or
    spherical flag is set, and every aspheric coefficient of both
    widths, as a biconic's or toroid's Newton does with or without a
    figure (kernels.reads_figure); another row reads none of them.  An
    anamorphic row reads its curvature and conic always; curvature_dx
    on an x-cylinder, a biconic and a toroid, conic_dx on an x-cylinder
    and a biconic.  A y-cylinder reads neither: the reference's rule
    keeps them (their gradient is zero there all the same), the port
    bakes them out, so that the call warns (ROADMAP Queue 3).  A
    grating or DOE on a y-cylinder reads curvature_dx (the normal of the
    biconic or toroid that made it: cx = c + curvature_dx, or the
    toroid's cr) and every coefficient of the table's widths
    (reads_figure); its conic_dx only through (1 + kx) cx^2 at cx = 0,
    whose cotangent is exactly zero, so it stays baked out as the plain
    y-cylinder's (the slot rule jax.grad of the reference gives, ROADMAP
    Queue 3).  A grating or DOE row keeps its curvature and conic live
    as the reference's rule does (the radial normal of its solve reads
    the conic of a spherical row); grating_dy is read by a grating row
    only and the DOE coefficients by a DOE row only, which the
    reference's rule does not name (it keeps them everywhere; the port
    bakes them out, so that the call warns: ROADMAP Queue 3).  A freeform
    row keeps its curvature and conic live (its Newton and normal read
    them through the base's sag) and reads every aspheric coefficient of
    the table's widths (reads_figure); xy_poly is read by a freeform row
    only, which the reference's rule does not name either (the port
    bakes it out elsewhere and warns: ROADMAP Queue 3)."""
    def fig(sp):
        return (K.is_figured(sp) or K.is_anamorphic_spec(sp)
                or K.is_phase(sp) or sp.freeform)

    def reads_cdx(sp):
        return sp.cyl_axis == 2 or (K.is_phase(sp) and sp.cyl_axis == 1) \
            or (not sp.cyl_axis and (sp.biconic or sp.toroidal))

    def reads_kdx(sp):
        return sp.cyl_axis == 2 or (not sp.cyl_axis and sp.biconic
                                    and not sp.toroidal)

    baked = {"curvature": lambda sp: sp.flat and not fig(sp),
             "conic": lambda sp: (sp.flat or sp.spherical) and not fig(sp),
             "curvature_dx": lambda sp: not reads_cdx(sp),
             "conic_dx": lambda sp: not reads_kdx(sp),
             "offset": lambda sp: not sp.off_axis,   # transverse x/y
             "mu": lambda sp: sp.kind == 0,
             "rot": lambda sp: not sp.rotated,
             "aspherics": lambda sp: not K.reads_figure(sp),
             "aspherics_odd": lambda sp: not K.reads_figure(sp),
             "grating_dy": lambda sp: not sp.grating,
             "doe": lambda sp: not sp.doe,
             "xy_poly": lambda sp: not sp.freeform}.get(field)
    if baked is None:
        return []
    return [j for j, sp in enumerate(specs) if j and baked(sp)]


def _coefficients(widths):
    """The slot fields of a figured key's na even and no odd
    coefficients."""
    na, no = widths
    return ("aspherics",)*na + ("aspherics_odd",)*no


def _anamorphic(specs):
    """The slot fields of an anamorphic key's two slots."""
    return ("curvature_dx", "conic_dx") if carries_anamorphic(specs) else ()


def _phase(specs, nd):
    """The slot fields of a phase key's last slots: grating_dy
    (carries_grating), then nd DOE coefficients."""
    return (("grating_dy",) if carries_grating(specs) else ()) \
        + ("doe",)*nd


def carries_rot(specs, fields):
    """Whether an adjoint key differentiates the rows' rotation (a rot
    key: ROT slots more a row, last): "rot" is among `fields` and some
    row of `specs` but row 0 is rotated (row 0's rotation is never a
    slot, as in the reference)."""
    return ROT_FIELD in fields and any(s.rotated for s in specs[1:])


def _rot(specs, fields):
    """The slot fields of a rot key's last slots (carries_rot)."""
    return (ROT_FIELD,)*ROT if carries_rot(specs, fields) else ()


def live_slots(specs, fields=FIELDS, widths=(0, 0), nd=0, nxy=0):
    """One mask a row of the slots K5 and K7 reduce -- SLOTS bits, then
    with `widths` = (na, no) (the key's, figure_widths) one a
    coefficient, then for anamorphic specs (carries_anamorphic)
    curvature_dx and conic_dx, then for grating specs (carries_grating)
    grating_dy and nd (the key's, doe_width) DOE coefficients, then nxy
    (the key's, xy_width) XY coefficients, then with "rot" in `fields`
    (carries_rot) the ROT rotation entries: the `fields` asked for,
    minus the rows the specs bake them out of (the axial offset, slot 4,
    never is; baked_out_rows).  Row 0 has none."""
    return _live_slots(specs, fields, FIELDS + (ROT_FIELD,),
                       SLOT_FIELDS[:SLOTS] + _coefficients(widths)
                       + _anamorphic(specs) + _phase(specs, nd)
                       + ("xy_poly",)*nxy + _rot(specs, fields))


def _opd_phase(specs, nd):
    """The slot fields of a K9 phase key's last slots: grating_dy
    (carries_grating), then with nd DOE coefficients n_after and the
    coefficients."""
    return (("grating_dy",) if carries_grating(specs) else ()) \
        + (("n_after",) + ("doe",)*nd if nd else ())


def opd_live_slots(specs, fields=OPD_DIFF, widths=(0, 0), nd=0, nxy=0):
    """One mask a row of the slots K9 reduces -- OPD_SLOTS bits, then
    with `widths` one a coefficient, then for anamorphic specs
    curvature_dx and conic_dx, then for grating specs grating_dy and
    with nd (the key's, doe_width) n_after and nd DOE coefficients, then
    nxy (the key's, xy_width) XY coefficients, then with "rot" in
    `fields` (carries_rot) the ROT rotation entries (live_slots' layout
    with n_before, slot 6, between mu and the coefficients, and n_after
    before the DOE's): OPD_SLOTS + na + no [+ 2] [+ 1] [+ 1 + nd] + nxy
    [+ ROT] slots, refused past LIVE_BITS; live_slots' rule with
    n_before on every row but row 0 and n_after on a DOE row only (the
    one row whose optical path reads it), except on the image row,
    which the reference-sphere tail reads only through its offset (the
    transverse part only off axis), its rotation (where rotated) and its
    n_before, whatever its figure."""
    if len(specs) < 3:
        raise ValueError("the OPD needs object, exit and image rows, got "
                         "%d rows" % len(specs))
    slot_fields = (SLOT_FIELDS + _coefficients(widths) + _anamorphic(specs)
                   + _opd_phase(specs, nd) + ("xy_poly",)*nxy
                   + _rot(specs, fields))
    masks = list(_live_slots(specs, fields, OPD_DIFF + (ROT_FIELD,),
                             slot_fields))
    if nd:
        q = slot_fields.index("n_after")
        masks = [m & ~(1 << q) if not sp.doe else m
                 for m, sp in zip(masks, specs)]
    tail = (1 << 4) | (1 << 6) | ((1 << 2) | (1 << 3)
                                  if specs[-1].off_axis else 0)
    if ROT_FIELD in slot_fields:
        q = slot_fields.index(ROT_FIELD)
        tail |= ((1 << ROT) - 1) << q
    masks[-1] &= tail
    return tuple(masks)


def _live_slots(specs, fields, known, slot_fields):
    fields = set(fields)
    unknown = fields - set(known)
    if unknown:
        raise ValueError("the adjoint differentiates %s, not %s"
                         % (", ".join(known), ", ".join(sorted(unknown))))
    if len(slot_fields) > LIVE_BITS:
        raise ValueError("%d slots a row, above the %d a row word holds"
                         "%s" % (len(slot_fields), LIVE_BITS,
                                 " (with the %d rotation slots)" % ROT
                                 if ROT_FIELD in slot_fields else ""))
    baked = {f: set(baked_out_rows(specs, f)) for f in known}
    masks = []
    for j in range(len(specs)):
        m = 0
        for q, f in enumerate(slot_fields):
            if j and f in fields and (q == 4 or j not in baked[f]):
                m |= 1 << q
        masks.append(m)
    return tuple(masks)


def live_mask(masks, nslots=SLOTS):
    """The (rows, nslots) bool mask of `live_slots`' (or, with nslots
    OPD_SLOTS, `opd_live_slots`') masks."""
    return torch.tensor([[bool(m >> q & 1) for q in range(nslots)]
                         for m in masks])


class Key(NamedTuple):
    """One specialization: kernel "k1", "k2", "k3" (K3's trace), "k3m"
    (K3's merit), "k4" ... "k9", dtype "f32" or "f64", one 64-bit word
    a row (flags | live slots << LIVE_SHIFT), clip, rays (an adjoint
    writes the ray and weight cotangents), threads a block, the blocks
    an SM that __launch_bounds__ asks ptxas to fit, the tables of the
    stack a launch traces (K3's and K6's wavelengths; 1 for every other
    kernel, K7 included: it stages one table at a time), whether K3's
    trace runs the wavelengths outermost, the even and odd aspheric
    coefficients a row carries (na, no: a figured table's widths; 0 and
    0 without an aspheric row), whether a row is anamorphic
    (anamorphic: a packed row then carries ANAM words more, its
    curvature_dx and conic_dx), whether a row is a grating (a packed row
    then carries grating_dy, an adjoint its slot) and the DOE
    coefficients a row carries (nd: a DOE table's width, 0 without a DOE
    row; a packed row then carries n_after and the nd coefficients, an
    adjoint their slots, K9 also n_after's) and the XY-monomial
    coefficients a row carries (nxy: a freeform table's xy_poly width, 0
    without a freeform row; a packed row then carries them last, an
    adjoint their slots, last) and, for an adjoint, whether it
    differentiates the rows' rotation (rot, carries_rot: ROT slots more a
    row, last; its saved states one row more, the state leaving the last
    row its reverse steps through)."""

    kernel: str
    dtype: str
    words: tuple
    clip: bool
    rays: bool
    block: int
    min_blocks: int = MIN_BLOCKS
    nlam: int = 1
    outer: bool = False
    na: int = 0
    no: int = 0
    anamorphic: bool = False
    grating: bool = False
    nd: int = 0
    nxy: int = 0
    rot: bool = False

    @property
    def name(self):
        """The launcher's symbol: the kernel and the key's hash."""
        text = repr((self.kernel, self.dtype, tuple(self.words),
                     bool(self.clip), bool(self.rays), int(self.block),
                     int(self.min_blocks), int(self.nlam)))
        if self.outer:
            text += " outer"
        if self.na or self.no:
            text += " figure %d %d" % (self.na, self.no)
        if self.anamorphic:
            text += " anamorphic"
        if self.grating:
            text += " grating"
        if self.nd:
            text += " doe %d" % self.nd
        if self.nxy:
            text += " xy %d" % self.nxy
        if self.rot:
            text += " rot"
        return "%s_%s" % (self.kernel,
                          hashlib.sha256(text.encode()).hexdigest()[:16])

    @property
    def rows(self):
        return len(self.words)

    @property
    def row_words(self):
        """A packed row's words: ROW, the aspheric coefficients, the
        anamorphic words, grating_dy, n_after with the DOE coefficients,
        and the XY coefficients."""
        return ROW + self.na + self.no + self.anam_words + int(self.grating) \
            + (1 + self.nd if self.nd else 0) + self.nxy

    @property
    def slots(self):
        """An adjoint's cotangent columns a row: SLOTS (K9: OPD_SLOTS),
        the coefficients, the anamorphic words, grating_dy, the DOE
        coefficients (K9: n_after, then the coefficients), the XY
        coefficients and a rot key's ROT."""
        k9 = self.kernel == "k9"
        return (OPD_SLOTS if k9 else SLOTS) \
            + self.na + self.no + self.anam_words + int(self.grating) \
            + (self.nd + int(k9) if self.nd else 0) + self.nxy \
            + (ROT if self.rot else 0)

    @property
    def anam_words(self):
        """The anamorphic words a row carries: ANAM on an anamorphic
        key, else 0."""
        return ANAM if self.anamorphic else 0

    @property
    def nlive(self):
        return sum(bin(w >> LIVE_SHIFT).count("1") for w in self.words)

    @property
    def word_bytes(self):
        return 4 if self.dtype == "f32" else 8

    @property
    def dynamic_smem(self):
        """An adjoint's saved states: (rows - 1) * 6 words a thread (K9:
        rows - 2, the rows its chain steps through before the sphere); a
        rot key's one row more (the state leaving its last stepped
        row)."""
        rows = {"k5": self.rows - 1, "k7": self.rows - 1,
                "k9": self.rows - 2}.get(self.kernel, 0)
        if rows and self.rot:
            rows += 1
        return rows*6*self.block*self.word_bytes

    @property
    def shared_bytes(self):
        """The shared memory a block takes: the saved states, the staged
        tables (K8, K9: and the aux vector), and the block reduction of
        the five moments a table (K2, K4, K6) or of the live slots (K9:
        and the 3 centre cotangents); K1 and K8 reduce nothing."""
        if self.kernel in MOMENTS:
            values = 5*self.nlam
        else:
            values = self.nlive + (3 if self.kernel == "k9" else 0)
        reduce = (0 if self.kernel in TRACES
                  else (self.block//32 + 1)*max(values, 1))
        words = (self.nlam*self.rows*self.row_words
                 + (AUX if self.kernel in ("k8", "k9") else 0) + reduce)
        return self.dynamic_smem + words*self.word_bytes


def _dtype_name(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError("rays must be float32 or float64, got %s" % dtype)


def _check_rows(specs, kernel):
    """Raise NotImplementedError for a row `kernel`'s key does not trace:
    a freeform figure on an anamorphic base (kernels.check_supported)."""
    for j, spec in enumerate(specs[1:], 1):
        K.check_supported(spec, j, kernel.upper() + "'s key", kernel)


def _words(specs, masks=None, kernel="k1"):
    """A key's row words (_check_rows first)."""
    _check_rows(specs, kernel)
    flags = [_flags(s) for s in specs]
    if masks is None:
        return tuple(flags)
    return tuple(f | m << LIVE_SHIFT for f, m in zip(flags, masks))


def _static(key):
    """The key, refused when what it stages in static shared memory
    (tables, aux vector, block reduction) is past SMEM_LIMIT."""
    if key.shared_bytes > SMEM_LIMIT:
        raise ValueError(
            "%s stages %d table(s) of %d rows in %s in static shared memory: "
            "%d bytes, above %d" % (key.kernel.upper(), key.nlam, key.rows,
                                    key.dtype, key.shared_bytes, SMEM_LIMIT))
    return key


def _widths(specs, widths, slots=SLOTS):
    """A key's (na, no): (0, 0) without a row that reads the figure
    (kernels.reads_figure; whatever the table's widths), else `widths`
    (figure_widths of the table), refused
    when `slots` (an adjoint's other slots: K9's OPD_SLOTS, an anamorphic
    key's two more) and the coefficients are more than a row word
    holds."""
    if not any(K.reads_figure(s) for s in specs[1:]):
        return (0, 0)
    na, no = (int(w) for w in widths)
    if na < 0 or no < 0 or slots + na + no > LIVE_BITS:
        raise ValueError("aspheric widths %s: %d slots a row, above the %d "
                         "a row word holds (%d + na + no)"
                         % ((na, no), slots + na + no, LIVE_BITS, slots))
    if (any(s.aspheric for s in specs) and not na) or \
            (any(s.odd for s in specs) and not no):
        raise ValueError("aspheric widths %s: an even (odd) aspheric row "
                         "needs the table's even (odd) coefficients "
                         "(cuda_trace.figure_widths)" % ((na, no),))
    return na, no


def _nd(specs, nd):
    """A key's DOE coefficients: 0 without a DOE row (whatever the
    table's width), else `nd` (doe_width of the table), refused at 0."""
    if not any(s.doe for s in specs[1:]):
        return 0
    if int(nd) < 1:
        raise ValueError("DOE width %r: a DOE row needs the table's doe "
                         "coefficients (cuda_trace.doe_width)" % (nd,))
    return int(nd)


def _nxy(specs, nxy):
    """A key's XY coefficients: 0 without a freeform row (whatever the
    table's width), else `nxy` (xy_width of the table), refused where it
    is no triangle deg (deg + 3)/2 of a degree >= 1."""
    if not any(s.freeform for s in specs[1:]):
        return 0
    if int(nxy) < 2:
        raise ValueError("XY width %r: a freeform row needs the table's "
                         "xy_poly coefficients (cuda_trace.xy_width)"
                         % (nxy,))
    K.xy_degree(int(nxy))
    return int(nxy)


def trace_key(specs, dtype, clip=False, block=None, min_blocks=MIN_BLOCKS,
              widths=(0, 0), nd=0, nxy=0):
    """The K1 key of a spec tuple; `widths` the table's (na, no) aspheric
    coefficients (figure_widths), read only when a row is figured; `nd`
    the table's DOE coefficients (doe_width), read only by a DOE row;
    `nxy` the table's XY coefficients (xy_width), read only by a
    freeform row."""
    words = _words(specs)
    na, no = _widths(specs, widths)
    return _static(Key("k1", _dtype_name(dtype), words, bool(clip), False,
                       int(block or BLOCK_TRACE), int(min_blocks),
                       na=na, no=no, anamorphic=carries_anamorphic(specs),
                       grating=carries_grating(specs), nd=_nd(specs, nd),
                       nxy=_nxy(specs, nxy)))


def opd_key(specs, dtype, clip=False, block=None, min_blocks=MIN_BLOCKS,
            widths=(0, 0), nd=0, nxy=0):
    """The K8 key of a spec tuple: object, exit and image rows at least
    (the chain runs rows 1..S-2, the sphere tail the image row);
    `widths`, `nd` and `nxy` as trace_key's (a DOE row adds its psi(r2)
    n_after to the optical path; a freeform row's path is t n_before, as
    a figured row's)."""
    if len(specs) < 3:
        raise ValueError("the OPD needs object, exit and image rows, got "
                         "%d rows" % len(specs))
    words = _words(specs, kernel="k8")
    na, no = _widths(specs, widths)
    return _static(Key("k8", _dtype_name(dtype), words, bool(clip), False,
                       int(block or BLOCK_TRACE), int(min_blocks),
                       na=na, no=no, anamorphic=carries_anamorphic(specs),
                       grating=carries_grating(specs), nd=_nd(specs, nd),
                       nxy=_nxy(specs, nxy)))


def _moments(kernel, specs, dtype, clip, nlam, block, min_blocks,
             widths=(0, 0), nd=0, nxy=0):
    """A moment kernel's key, refused when its staged tables and block
    reduction outgrow static shared memory, or (K3, K6) past MAX_NLAM
    wavelengths."""
    words = _words(specs, kernel=kernel)
    na, no = _widths(specs, widths)
    key = Key(kernel, _dtype_name(dtype), words, bool(clip), False,
              int(block or BLOCK_MOMENTS), int(min_blocks), int(nlam),
              na=na, no=no, anamorphic=carries_anamorphic(specs),
              grating=carries_grating(specs), nd=_nd(specs, nd),
              nxy=_nxy(specs, nxy))
    return _static(_unrolled(key))


def _unrolled(key):
    """The key, refused past MAX_NLAM wavelengths (or below one)."""
    if not 1 <= key.nlam <= MAX_NLAM:
        raise ValueError(
            "%s unrolls its wavelengths and keeps 5 moments a wavelength in "
            "registers: %d wavelengths, outside 1..%d (past %d the registers "
            "stop paying: float32 at 12 fits one block an SM and ran slower "
            "than 12 K4 launches, float64 at 16 spilled)"
            % (key.kernel.upper(), key.nlam, MAX_NLAM, MAX_NLAM))
    return key


def merit_key(specs, dtype, clip=False, block=None, min_blocks=MIN_BLOCKS,
              widths=(0, 0), nd=0, nxy=0):
    """The K2 key of a spec tuple (`widths`, `nd` and `nxy` as
    trace_key's)."""
    return _moments("k2", specs, dtype, clip, 1, block, min_blocks, widths,
                    nd, nxy)


def moments_key(specs, dtype, clip=False, block=None,
                min_blocks=MIN_BLOCKS, widths=(0, 0), nd=0, nxy=0):
    """The K4 key of a spec tuple (`widths`, `nd` and `nxy` as
    trace_key's)."""
    return _moments("k4", specs, dtype, clip, 1, block, min_blocks, widths,
                    nd, nxy)


def moments_multi_key(specs, dtype, clip, nlam, block=None,
                      min_blocks=MIN_BLOCKS, widths=(0, 0), nd=0, nxy=0):
    """The K6 key of the spec tuple a stack of `nlam` tables shares (the
    first wavelength's, cuda_trace.multi_specs); `widths`, `nd` and `nxy`
    as trace_key's (each table of the stack packs its own grating_dy,
    n_after, DOE and XY coefficients)."""
    return _moments("k6", specs, dtype, clip, nlam, block, min_blocks,
                    widths, nd, nxy)


def trace_multi_key(specs, dtype, nlam, merit=False, block=None,
                    min_blocks=MIN_BLOCKS, outer=None, widths=(0, 0), nd=0,
                    nxy=0):
    """The K3 key of the spec tuple a stack of `nlam` tables shares (the
    first wavelength's, cuda_trace.multi_specs): its merit mode ("k3m",
    K6's template unweighted) or its trace ("k3", wavelengths outermost
    as MULTI_OUTER when `outer` is None); block BLOCK_MULTI's for the
    mode and dtype when None; `widths`, `nd` and `nxy` as trace_key's
    (each table of the stack packs its own phase and XY words).  No
    clip, as the TPU
    kernel.  Refused past MAX_NLAM wavelengths or past static shared
    memory (multi_most: the stack a key takes)."""
    kernel = "k3m" if merit else "k3"
    block = int(block or BLOCK_MULTI[kernel][_dtype_name(dtype)])
    if merit:
        if outer:
            raise ValueError("K3's merit reads each ray once: it has no "
                             "outer order")
        return _moments(kernel, specs, dtype, False, nlam, block, min_blocks,
                        widths, nd, nxy)
    words = _words(specs, kernel=kernel)
    na, no = _widths(specs, widths)
    key = Key(kernel, _dtype_name(dtype), words, False, False, block,
              int(min_blocks), int(nlam),
              MULTI_OUTER if outer is None else bool(outer), na, no,
              carries_anamorphic(specs), carries_grating(specs),
              _nd(specs, nd), _nxy(specs, nxy))
    return _static(_unrolled(key))


def multi_most(kernel, specs, dtype, block=None, widths=(0, 0), nd=0,
               nxy=0):
    """The most wavelengths one key of `kernel` ("k3", "k3m" or "k6")
    takes for this spec tuple (and `widths`, a figured key's grown rows;
    an anamorphic key's rows grow by ANAM words, a phase key's by
    grating_dy and by n_after and `nd` DOE coefficients, a freeform
    key's by `nxy` XY coefficients): MAX_NLAM, or
    fewer where that many tables (and the moments' block reduction)
    outgrow static shared memory; 0 when one table alone does."""
    dt = _dtype_name(dtype)
    na, no = _widths(specs, widths)
    one = Key(kernel, dt, (0,)*len(specs), False, False,
              int(block or BLOCK_MULTI.get(kernel, {}).get(
                  dt, BLOCK_MOMENTS)), na=na, no=no,
              anamorphic=carries_anamorphic(specs),
              grating=carries_grating(specs), nd=_nd(specs, nd),
              nxy=_nxy(specs, nxy))
    # a key's static shared memory grows by one table's (and 5 reduced
    # moments') words a wavelength
    return min(MAX_NLAM, SMEM_LIMIT//one.shared_bytes)


def _adjoint(kernel, specs, masks, dtype, clip, rays, block, min_blocks,
             widths=(0, 0), nd=0, nxy=0, rot=False):
    """An adjoint's key, refused when a block's saved states and
    reduction outgrow the shared memory it may opt in to."""
    na, no = widths
    key = Key(kernel, _dtype_name(dtype), _words(specs, masks, kernel),
              bool(clip), bool(rays), int(block or BLOCK_ADJOINT),
              int(min_blocks), na=na, no=no,
              anamorphic=carries_anamorphic(specs),
              grating=carries_grating(specs), nd=nd, nxy=nxy, rot=bool(rot))
    if key.shared_bytes > SMEM_OPTIN:
        raise ValueError(
            "%s keeps %d rows of saved state at %d threads a block in %s: "
            "%d bytes of shared memory, above %d"
            % (kernel.upper(), key.rows, key.block, key.dtype,
               key.shared_bytes, SMEM_OPTIN))
    return key


def adjoint_key(specs, dtype, clip=False, fields=FIELDS, rays=True,
                block=None, min_blocks=MIN_BLOCKS, widths=(0, 0), nd=0,
                nxy=0):
    """The K5 key of a spec tuple, the fields whose cotangents are
    wanted (see live_slots), whether the ray and weight cotangents are,
    and `widths`, `nd` and `nxy` as trace_key's (a figured key's rows
    reduce their aspheric coefficients too, a grating key's grating_dy, a
    DOE key's DOE coefficients, a freeform key's XY coefficients, a rot
    key's ROT rotation entries -- "rot" in `fields` and a rotated row,
    carries_rot; SLOTS + na + no [+ 2] [+ 1] + nd + nxy [+ ROT] must fit
    a row word)."""
    rot = carries_rot(specs, fields)
    nd, nxy, widths = _adjoint_widths(specs, "k5", SLOTS, _phase, widths,
                                      nd, nxy, rot)
    return _adjoint("k5", specs, live_slots(specs, fields, widths, nd, nxy),
                    dtype, clip, rays, block, min_blocks, widths, nd, nxy,
                    rot)


def _adjoint_widths(specs, kernel, base, phase, widths, nd, nxy, rot=False):
    """An adjoint key's (nd, nxy, (na, no)): its other slots -- `base`,
    the anamorphic two, the `phase` slots (_phase, K9 _opd_phase), the
    XY coefficients and with `rot` the ROT rotation entries -- refused
    past LIVE_BITS with the coefficients (_check_rows first)."""
    _check_rows(specs, kernel)
    nd, nxy = _nd(specs, nd), _nxy(specs, nxy)
    other = base + len(_anamorphic(specs)) + len(phase(specs, nd)) + nxy \
        + (ROT if rot else 0)
    if other > LIVE_BITS:
        raise ValueError("XY width %d%s: %d slots a row, above the %d a row "
                         "word holds" % (nxy, " and %d rotation slots" % ROT
                                         if rot else "", other, LIVE_BITS))
    return nd, nxy, _widths(specs, widths, other)


def adjoint_multi_key(specs, dtype, clip=False, fields=FIELDS, rays=True,
                      block=None, min_blocks=MIN_BLOCKS, widths=(0, 0),
                      nd=0, nxy=0):
    """The K7 key of the spec tuple a stack of tables shares, as
    adjoint_key (the wavelength count is not part of it; a phase key's
    grating_dy and DOE coefficients and a freeform key's XY coefficients
    are reduced per table, as mu is, and so is a rot key's rotation)."""
    rot = carries_rot(specs, fields)
    nd, nxy, widths = _adjoint_widths(specs, "k7", SLOTS, _phase, widths,
                                      nd, nxy, rot)
    return _adjoint("k7", specs, live_slots(specs, fields, widths, nd, nxy),
                    dtype, clip, rays, block, min_blocks, widths, nd, nxy,
                    rot)


def opd_adjoint_key(specs, dtype, clip=False, fields=OPD_DIFF, rays=True,
                    block=None, min_blocks=MIN_BLOCKS, widths=(0, 0), nd=0,
                    nxy=0):
    """The K9 key of a spec tuple, the fields whose cotangents are
    wanted (see opd_live_slots), whether the ray cotangents are, and
    `widths`, `nd` and `nxy` as trace_key's (a figured key's rows reduce
    their aspheric coefficients after n_before, an anamorphic key's
    curvature_dx and conic_dx after them, a grating key's grating_dy,
    then a DOE key's n_after and DOE coefficients, then a freeform key's
    XY coefficients, then a rot key's ROT rotation entries, the image
    row's among them; OPD_SLOTS + na + no [+ 2] [+ 1] [+ 1 + nd] + nxy
    [+ ROT] must fit a row word); the three centre cotangents are always
    reduced."""
    rot = carries_rot(specs, fields)
    nd, nxy, widths = _adjoint_widths(specs, "k9", OPD_SLOTS, _opd_phase,
                                      widths, nd, nxy, rot)
    return _adjoint("k9", specs, opd_live_slots(specs, fields, widths, nd,
                                                nxy),
                    dtype, clip, rays, block, min_blocks, widths, nd, nxy,
                    rot)


class Df32Key(NamedTuple):
    """One df32 specialization: kernel "k11" (the trace: K11, or K10 at
    one plan) or "k13" (the merit: K13, or K12 at one plan), the
    distinct flag tuples of its plans (one cuda_df32 step flag word a
    step, one step count), the tuple each plan takes (its length the
    wavelength count), the optical path (the trace), whether the chain
    reads the plan words from a copy in shared memory, threads a block,
    the launch bound's blocks an SM, and whether the words come from a
    device tensor (staged into dynamic shared memory) instead of the
    kernel's parameters: the placement of one plan too long for them."""

    kernel: str
    tuples: tuple
    plan_map: tuple
    with_path: bool
    block: int
    min_blocks: int = MIN_BLOCKS
    staged: bool = False
    device_words: bool = False

    @property
    def name(self):
        """The launcher's symbol: the kernel and the key's hash."""
        text = repr((self.kernel, tuple(map(tuple, self.tuples)),
                     tuple(self.plan_map), bool(self.with_path),
                     int(self.block), int(self.min_blocks),
                     bool(self.staged), bool(self.device_words)))
        return "%s_%s" % (self.kernel,
                          hashlib.sha256(text.encode()).hexdigest()[:16])

    @property
    def nlam(self):
        return len(self.plan_map)

    @property
    def steps(self):
        return len(self.tuples[0])

    @property
    def words_at(self):
        """The placement's constant in df32_spec.cuh (WORDS_AT)."""
        return WORDS_AT[2 if self.device_words else int(bool(self.staged))]

    @property
    def plan_words(self):
        """The words of the key's longest plan (cuda_df32.step_words of
        each step's flags): the stride of its plans' words."""
        return df32_plan_words(self.tuples)

    @property
    def word_bytes(self):
        """The plan words: nlam * plan_words float32."""
        return self.nlam*self.plan_words*4

    @property
    def param_bytes(self):
        """The kernel's parameters: the plan words (or, device_words,
        their pointer), the pointers and n."""
        words = 8 if self.device_words else self.word_bytes
        return words + DF32_PARAM_BYTES[self.kernel]

    @property
    def shared_bytes(self):
        """Static shared memory a block: the staged plan words (from the
        parameters) and K13's block reduction (10 floats a warp)."""
        words = self.word_bytes if self.staged and not self.device_words \
            else 0
        return words + (10*4*(self.block//32) if self.kernel == "k13" else 0)

    @property
    def dynamic_smem(self):
        """Dynamic shared memory a block: the device words' copy."""
        return self.word_bytes if self.device_words else 0


def df32_flags(plans):
    """One flag word a step of each plan (cuda_df32._step_words)."""
    from .cuda_df32 import _step_words
    return tuple(tuple(_step_words(st)[1] for st in p) for p in plans)


def df32_multi_key(plans, kernel="k11", with_path=False, block=None,
                   min_blocks=MIN_BLOCKS, staged=None, device_words=None):
    """The K11 (kernel="k11") or K13 ("k13") key of a sequence of plans
    (ops.df32.plan, one a wavelength, one step count), K10 or K12 at one
    plan: the distinct flag tuples in order of first use and each plan's
    tuple; block and staged default to BLOCK_DF32's and DF32_STAGED's
    (K10's and K12's at one plan).  No wavelength cap: the wavelengths
    loop at run time over one chain a tuple.  Refused past PARAM_LIMIT
    bytes of kernel parameters, which carry the plan words; a staged
    copy of them (at most PARAM_LIMIT bytes) and K13's reduction (at
    most 1,280) stay under SMEM_LIMIT of static shared memory.  One
    plan past PARAM_LIMIT takes device_words (device_words None: only
    then), staged into dynamic shared memory, refused past
    SMEM_OPTIN."""
    return df32_key_of(df32_flags(plans), kernel, with_path, block,
                       min_blocks, staged, device_words)


def df32_key_of(flags, kernel="k11", with_path=False, block=None,
                min_blocks=MIN_BLOCKS, staged=None, device_words=None):
    """df32_multi_key from the plans' flag words (df32_flags)."""
    if kernel not in ("k11", "k13"):
        raise ValueError("a df32 plan key is k11 or k13, not %r" % (kernel,))
    if kernel == "k13" and with_path:
        raise ValueError("K13 sums no optical path")
    flags = tuple(tuple(int(f) for f in p) for p in flags)
    steps = {len(p) for p in flags}
    if not flags or len(steps) != 1 or 0 in steps:
        raise ValueError("plans must share one nonzero step count, got %s"
                         % sorted(steps))
    _check_phase_bits(flags)
    tuples = tuple(dict.fromkeys(flags))
    defaults = ONE_PLAN[kernel] if len(flags) == 1 else kernel
    key = Df32Key(kernel, tuples, tuple(tuples.index(p) for p in flags),
                  bool(with_path), int(block or BLOCK_DF32[defaults]),
                  int(min_blocks), DF32_STAGED[defaults] if staged is None
                  else bool(staged))
    if device_words is None:
        device_words = key.nlam == 1 and key.param_bytes > PARAM_LIMIT
    if device_words:
        if staged is not None and not staged:
            raise ValueError("device words are read from a shared-memory "
                             "copy: staged cannot be False")
        key = key._replace(staged=True, device_words=True)
    if key.param_bytes > PARAM_LIMIT:
        raise ValueError(
            "%s passes %d plan(s) of %d steps as kernel parameters: %d "
            "bytes, above %d" % (kernel.upper(), key.nlam, key.steps,
                                 key.param_bytes, PARAM_LIMIT))
    if key.shared_bytes + key.dynamic_smem > SMEM_OPTIN:
        raise ValueError(
            "%s stages a plan of %d steps from device words: %d bytes of "
            "shared memory, above %d" % (kernel.upper(), key.steps,
                                         key.shared_bytes + key.dynamic_smem,
                                         SMEM_OPTIN))
    return key


def _check_phase_bits(flags):
    """Refuse plans (one a wavelength) whose steps differ in their phase
    bits: a step is a grating or a DOE of nd coefficients at every
    wavelength (its values, the grating term and the coefficients, scale
    with the wavelength in each plan's words)."""
    from .cuda_df32 import G_DOE, G_GRATING, G_ND_SHIFT
    mask = G_GRATING | G_DOE | 15 << G_ND_SHIFT
    for j, step in enumerate(zip(*flags)):
        bits = sorted({f & mask for f in step})
        if len(bits) > 1:
            raise ValueError(
                "step %d of the plans is not the same phase row at every "
                "wavelength: grating/DOE/DOE-count bits %s (plans %s)"
                % (j, ", ".join("%#x" % b for b in bits),
                   ", ".join("%#x" % (f & mask) for f in step)))


def df32_plan_words(flags):
    """The words of the longest of the plans whose flag words are
    `flags` (one tuple a plan): what each plan's words take in a key's
    parameters."""
    from .cuda_df32 import step_words
    return max(sum(step_words(f) for f in p) for p in flags)


def df32_runs(flags, kernel):
    """The balanced runs (runs) of the plans whose flag words are `flags`
    (df32_flags) whose words each fit one key's kernel parameters, at
    the words of the longest plan; one plan a run when a plan alone does
    not (its key takes device words)."""
    most = (PARAM_LIMIT - DF32_PARAM_BYTES[kernel])//(
        df32_plan_words(flags)*4)
    return runs(len(flags), max(1, most))


def runs(n, most):
    """[(l0, l1), ...]: n items (wavelengths, plans) cut into the fewest
    runs of at most `most`, balanced: their lengths differ by one at
    most, the longer first (12 at most 11 -> 6 + 6, 13 -> 7 + 6), so
    equal runs share one key.  One run (0, n) for n <= most."""
    if n <= most:
        return [(0, n)]
    count = -(-n // most)
    base, extra = divmod(n, count)
    out, l0 = [], 0
    for r in range(count):
        l1 = l0 + base + (r < extra)
        out.append((l0, l1))
        l0 = l1
    return out


def _df32_unit(key):
    plans = ", ".join("Plan<%s>" % ", ".join(map(str, t))
                      for t in key.tuples)
    head = ("// %s, specialized by rayopt_tpu_torch.ops.cuda_spec\n"
            "// key: %r\n#include \"df32_spec.cuh\"\n\n"
            "namespace {\nusing Ps = Plans<%s>;\nusing Map = PlanMap<%s>;\n"
            "}  // namespace\n\n"
            % (key.name, tuple(key), plans,
               ", ".join(map(str, key.plan_map))))
    path = ("true, " if key.with_path else "false, ") \
        if key.kernel == "k11" else ""
    return head + "%s(%s, Ps, Map, %s%s, %d, %d)\n" % (
        _MACROS[key.kernel], key.name, path, key.words_at, key.block,
        key.min_blocks)


def translation_unit(key):
    """The source text that instantiates csrc/grad_spec.cuh (a Key) or
    csrc/df32_spec.cuh (a Df32Key) for `key`."""
    if isinstance(key, Df32Key):
        return _df32_unit(key)
    ctype = "float" if key.dtype == "f32" else "double"
    words = ", ".join(str(w) for w in key.words)
    # a figured key's coefficient widths, an anamorphic key's words, a
    # phase key's and a freeform key's, before the headers read them
    figure = ("#define RAYOPT_N_ASP %d\n#define RAYOPT_N_ODD %d\n"
              % (key.na, key.no) if key.na or key.no else "")
    if key.anamorphic:
        figure += "#define RAYOPT_N_ANAM %d\n" % ANAM
    if key.grating:
        figure += "#define RAYOPT_N_GRAT 1\n"
    if key.nd:
        figure += "#define RAYOPT_N_DOE %d\n" % key.nd
    if key.nxy:
        figure += "#define RAYOPT_N_XY %d\n" % key.nxy
    if key.rot:
        figure += "#define RAYOPT_ROT 1\n"
    head = ("// %s, specialized by rayopt_tpu_torch.ops.cuda_spec\n"
            "// key: %r\n%s#include \"grad_spec.cuh\"\n\n"
            "namespace {\nusing Rows = Chain<%s>;\n}  // namespace\n\n"
            % (key.name, tuple(key), figure, words))
    clip = "true" if key.clip else "false"
    if key.kernel == "k3":
        # no clip: the loops' order in its place
        clip = "true" if key.outer else "false"
    if key.kernel in MOMENTS + TRACES:
        nlam = "%d, " % key.nlam if key.kernel in MULTI else ""
    else:
        nlam = "true, " if key.rays else "false, "   # the adjoints' rays
    return head + "%s(%s, %s, Rows, %s, %s%d, %d)\n" % (
        _MACROS[key.kernel], key.name, ctype, clip, nlam, key.block,
        key.min_blocks)


class SpecKernel:
    """One key's loaded library: `fn` the launcher, `grid(n, device)`
    the launch shape (cached per device), `build_seconds` (its unit's),
    `build_log` (nvcc's output with the key's -Xptxas -v lines) and
    `entry` (its kernel's mangled name in a unit of several keys, else
    None)."""

    def __init__(self, key, path, build_seconds, build_log, entry=None):
        self.key = key
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.entry = entry
        self._lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.fn = getattr(self._lib, key.name)
        # K1: table, 6 rays, 7 outputs, n, grid, stream; K3: table, 6
        # rays, out, n, grid, stream; K8: table, 6 rays, aux, 3 outputs,
        # n, grid, stream; K2, K3m, K4, K6: table, 6 rays, w (K2, K3m:
        # null), partials, counter, out, n, grid, stream; K5: table, 6
        # rays, w, ct, partials, counter, out, 7 ray cotangents, n, grid,
        # stream; K7: K5's with nlam before grid; K9: table, 6 rays, aux,
        # 3 cotangents, partials, counter, out, 6 ray cotangents, n,
        # grid, stream; K11: plan words, 12 input words, out, n, grid,
        # stream; K13: plan words, 12 input words, partials, counter,
        # out, n, grid, stream
        words = {"k1": 14, "k3": 8, "k8": 11, "k2": 11, "k3m": 11,
                 "k4": 11, "k6": 11, "k5": 19, "k7": 19, "k9": 20,
                 "k11": 14, "k13": 16}[key.kernel]
        ints = [i64, i32, i32] if key.kernel == "k7" else [i64, i32]
        self.fn.argtypes = [ptr]*words + ints + [ptr]
        self.fn.restype = i32
        self._occupancy = getattr(self._lib, key.name + "_blocks_per_sm")
        self._occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        self._occupancy.restype = i32
        self._error = getattr(self._lib, key.name + "_error_string")
        self._error.argtypes = [i32]
        self._error.restype = ctypes.c_char_p
        self._grids = {}

    def blocks_per_sm(self, device):
        """Resident blocks an SM (the occupancy calculator)."""
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            self.check(self._occupancy(ctypes.byref(out)))
        return out.value

    def grid(self, n, device):
        """Blocks for n rays: one wave of resident blocks at most."""
        most = self._grids.get(device)
        if most is None:
            most = self._grids[device] = max(1, sm_count(device)
                                             * self.blocks_per_sm(device))
        return max(1, min(-(-n // self.key.block), most))

    def check(self, err):
        if err:
            raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                               % (self.key.name, err,
                                  self._error(err).decode()))

    def ptxas_lines(self):
        from .cuda_build import ptxas_lines
        return ptxas_lines(self.build_log)


_LOADED = {}
#: keys a translation unit at most when several build at once: a unit
#: parses the headers, and compiles and links its host side, once (~2 s
#: of a lone key's 3-4 s of nvcc on the H100's host, PERF.md §6)
GROUP_MOST = 8
#: the kernel template each key kind instantiates
_TEMPLATES = {"k1": "trace_spec", "k3": "trace_multi_spec",
              "k8": "opd_spec", "k2": "moments_spec", "k3m": "moments_spec",
              "k4": "moments_spec", "k6": "moments_spec",
              "k5": "merit_adjoint_spec", "k7": "merit_adjoint_multi_spec",
              "k9": "opd_adjoint_spec", "k11": "df32_trace_spec",
              "k13": "df32_merit_spec"}


def template_args(key):
    """(the kernel template `key` instantiates, its dtype's letter ("" for
    K10-K13), the integer template arguments in order): what the
    kernel's mangled name spells (`entry_args`)."""
    tmpl = _TEMPLATES[key.kernel]
    if isinstance(key, Df32Key):
        head = [f for t in key.tuples for f in t] + list(key.plan_map)
        path = [key.with_path] if key.kernel == "k11" else []
        return tmpl, "", tuple(int(v) for v in head + path + [
            WORDS_AT.index(key.words_at), key.block, key.min_blocks])
    if key.kernel == "k3":
        mid = [key.outer, key.nlam]
    elif key.kernel in MOMENTS:
        mid = [key.clip, key.kernel in ("k4", "k6"),
               key.nlam if key.kernel in MULTI else 1]
    elif key.kernel in TRACES:
        mid = [key.clip]
    else:
        mid = [key.clip, key.rays]
    return tmpl, "f" if key.dtype == "f32" else "d", tuple(
        int(v) for v in list(key.words) + mid + [key.block, key.min_blocks])


def entry_args(entry):
    """template_args read back from a kernel's mangled (Itanium) name,
    None for a name that is not one of the keys' kernels."""
    import re
    for tmpl in set(_TEMPLATES.values()):
        at = entry.find("%d%sI" % (len(tmpl), tmpl))
        if at < 0:
            continue
        rest = entry[at + len(tmpl) + len(str(len(tmpl))) + 1:]
        head = rest[:rest.find("Ev")]
        dtype = "" if tmpl.startswith("df32") else head[:1]
        return tmpl, dtype, tuple(
            int(d) * (-1 if neg else 1)
            for neg, d in re.findall(r"L[a-z](n?)(\d+)E", head))
    return None


def _unit_parts(key):
    """A key's translation unit cut in two: the defines and the header's
    include, then the key's own instantiation."""
    text = translation_unit(key)
    at = text.index("#include")
    end = text.index("\n", at) + 1
    return (text[:at].split("// key: ")[-1].partition("\n")[2]
            + text[at:end], text[end:])


def _group_units(keys, most):
    """{unit name: (text, keys)}: the keys with the same defines and
    header `most` a unit, each instantiation in a namespace of its own."""
    by_head = {}
    for k in keys:
        head, body = _unit_parts(k)
        by_head.setdefault(head, []).append((k, body))
    units = {}
    for head, members in by_head.items():
        for i in range(0, len(members), most):
            part = members[i:i + most]
            name = "g%d_%s" % (len(part), hashlib.sha256(" ".join(
                k.name for k, _ in part).encode()).hexdigest()[:16])
            units[name] = ("// %d keys, specialized by rayopt_tpu_torch."
                           "ops.cuda_spec\n" % len(part) + head + "".join(
                               "\nnamespace unit_%s {\n%s}  // namespace\n"
                               % (k.name, body) for k, body in part),
                           [k for k, _ in part])
    return units


def prebuild(keys):
    """Build every key not yet loaded and load them: one nvcc a unit, as
    many at a time as the process may use cores, up to GROUP_MOST keys
    a unit when there are more keys than twice the cores (each key's
    ptxas lines cut out of its unit's by its kernel's mangled name; a
    key not found there, or of a unit that fails, builds alone).
    Returns {key: SpecKernel}."""
    from .cuda_build import _cores, build_shared, entry_reports
    todo = list({k: None for k in keys if k not in _LOADED})
    most = min(GROUP_MOST, -(-len(todo) // (2 * _cores())))
    alone = todo
    if most > 1:
        units = _group_units(todo, most)
        built = build_shared({n: text for n, (text, _) in units.items()},
                             HEADERS, strict=False)
        alone = []
        for name, (_, members) in units.items():
            if name not in built:
                alone += members
                continue
            path, seconds, log = built[name]
            head, reports = entry_reports(log)
            found = {entry_args(e): (e, r) for e, r in reports.items()}
            for k in members:
                entry, report = found.get(template_args(k), (None, None))
                if entry is None:
                    alone.append(k)
                else:
                    _LOADED[k] = SpecKernel(k, path, seconds, head + report,
                                            entry)
    if alone:
        built = build_shared({k.name: translation_unit(k) for k in alone},
                             HEADERS)
        for k in alone:
            _LOADED[k] = SpecKernel(k, *built[k.name])
    return {k: _LOADED[k] for k in keys}


def load(key):
    """The loaded kernel of one key (built at first use)."""
    kern = _LOADED.get(key)
    return kern if kern is not None else prebuild([key])[key]


def spec_launch(state):
    """The device, the rays and the stream of a specialized kernel's
    launch on a CUDA bundle."""
    x = state[0]
    if x.device.type != "cuda":
        raise ValueError("expected a CUDA or CPU bundle, got %s" % x.device)
    return x.device, x.shape[0], torch.cuda.current_stream(
        x.device).cuda_stream


def packed(table, specs, x):
    """The table (or a stack of tables) packed in the rays' dtype on
    their device, with one spec a row (a figured table's rows with its
    aspheric coefficients, cuda_trace.figure_widths; an anamorphic
    table's with curvature_dx and conic_dx, carries_anamorphic; a
    grating table's with grating_dy, carries_grating; a DOE table's with
    n_after and its coefficients, doe_width; a freeform table's with its
    XY coefficients, xy_width)."""
    tab = pack_values(table, x.dtype, x.device, figure_widths(table, specs),
                      carries_anamorphic(specs), carries_grating(specs),
                      doe_width(table, specs), xy_width(table, specs))
    if tab.shape[-2] != len(specs):
        raise ValueError("%d specs for a table of %d rows"
                         % (len(specs), tab.shape[-2]))
    return tab


def launch_moments(kern, table, specs, state, w=None):
    """Launch a moment kernel (K2, K3's merit, K4, K6) once on a CUDA
    bundle, the grid-wide sum fused: the (nlam, 5) moments of each table
    of the key's stack in the rays' dtype, zeros (and no launch) for no
    rays.  w: the (N,) weights, None for K2 and K3."""
    x = state[0]
    device, n, stream = spec_launch(state)
    tab = packed(table, specs, x)
    shape = (kern.key.nlam, 5)
    if tab[..., 0, 0].numel() != kern.key.nlam:
        raise ValueError("%d table(s) for a key of %d"
                         % (tab[..., 0, 0].numel(), kern.key.nlam))
    if not n:
        return torch.zeros(shape, dtype=x.dtype, device=device)
    grid = kern.grid(n, device)
    out = torch.empty(shape, dtype=x.dtype, device=device)
    partials = torch.empty((grid, 5*kern.key.nlam), dtype=x.dtype,
                           device=device)
    kern.check(kern.fn(tab.data_ptr(), *(c.data_ptr() for c in state),
                       None if w is None else w.data_ptr(),
                       partials.data_ptr(), counter(device).data_ptr(),
                       out.data_ptr(), n, grid, stream))
    return out


@functools.lru_cache(maxsize=None)
def counter(device):
    """The zeroed uint32 the fused grid-wide sums count their blocks
    with; each launch's last block resets it.  One a device: launches
    that share it run in order on one stream."""
    return torch.zeros(1, dtype=torch.int32, device=device)
