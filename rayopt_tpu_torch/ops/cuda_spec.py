"""K4 and K5 specialized per spec tuple at compile time.

The weighted-moment forward K4 and its analytic adjoint K5
(csrc/grad_spec.cuh) are compiled once for each key: the kernel, the
dtype, one word a table row (its SurfaceSpec flags, cuda_trace._flags,
and for K5 above LIVE_SHIFT the parameter slots it reduces), the
aperture clip, whether K5 writes the ray and weight cotangents, and the
block size.  A key's translation unit is a few lines that instantiate
the header's templates with the row words as a template parameter pack,
so the row loop unrolls and every flag branch folds, and that export
launchers named by the key's hash.  nvcc builds it at first use into
its own shared library under build/torch_kernels/ (one nvcc run a new
key, seconds; `prebuild` starts several at once), cached by a hash of
the headers, the flags and the unit's text.  This is how the JAX
package's Pallas kernels are specialized too: on specs, clip and
diff_fields.

The live slots of a row (curvature, conic, offset x, y, z, mu: K5's
six cotangent columns) are the fields asked for, minus what the row's
specs bake out (cuda_grad._baked_out_rows: curvature of a flat row,
conic of a flat or spherical row, the transverse offset of an on-axis
row, mu of a passthrough row); the axial offset is never baked out.
Row 0 has none.  A slot that is not live comes back as an exact zero.
"""

import ctypes
import functools
import hashlib
from typing import NamedTuple

import torch

from . import kernels as K
from .cuda_trace import SMEM_OPTIN, _flags, sm_count

LIVE_SHIFT = 8     # a row word's live slots: keep in sync with grad_spec.cuh
SLOTS = 6          # K5's cotangent columns a row
#: the table field of each of K5's cotangent columns
SLOT_FIELDS = ("curvature", "conic", "offset", "offset", "offset", "mu")
#: the fields K5 differentiates
FIELDS = ("curvature", "conic", "offset", "mu")
HEADERS = ("trace_common.cuh", "step_vjp.cuh", "grad_spec.cuh")
BLOCK_MOMENTS = 256
BLOCK_ADJOINT = 128   # measured fastest in float64 (PERF.md §6)
MIN_BLOCKS = 1        # __launch_bounds__'s blocks an SM (PERF.md §6)


def baked_out_rows(specs, field):
    """Surface rows (1-indexed into the chain) whose static
    specialization never READS `field`, so its gradient there is
    structurally zero (specialized-engine semantics).  Only flat,
    spherical and conic rows reach the kernels (kernels.
    check_supported), so no row carries a figure."""
    baked = {"curvature": lambda sp: sp.flat,
             "conic": lambda sp: sp.flat or sp.spherical,
             "offset": lambda sp: not sp.off_axis,   # transverse x/y
             "mu": lambda sp: sp.kind == 0,
             "rot": lambda sp: not sp.rotated}.get(field)
    if baked is None:
        return []
    return [j for j, sp in enumerate(specs) if j and baked(sp)]


def live_slots(specs, fields=FIELDS):
    """One 6-bit mask a row of the slots K5 reduces: the `fields` asked
    for, minus the rows the specs bake them out of (the axial offset,
    slot 4, never is).  Row 0 has none."""
    fields = set(fields)
    unknown = fields - set(FIELDS)
    if unknown:
        raise ValueError("K5 differentiates %s, not %s"
                         % (", ".join(FIELDS), ", ".join(sorted(unknown))))
    baked = {f: set(baked_out_rows(specs, f)) for f in FIELDS}
    masks = []
    for j in range(len(specs)):
        m = 0
        for q, f in enumerate(SLOT_FIELDS):
            if j and f in fields and (q == 4 or j not in baked[f]):
                m |= 1 << q
        masks.append(m)
    return tuple(masks)


def live_mask(masks):
    """The (rows, SLOTS) bool mask of `live_slots`' masks."""
    return torch.tensor([[bool(m >> q & 1) for q in range(SLOTS)]
                         for m in masks])


class Key(NamedTuple):
    """One specialization: kernel "k4" or "k5", dtype "f32" or "f64",
    one word a row (flags | live slots << LIVE_SHIFT), clip, rays (K5
    writes the ray and weight cotangents), threads a block, and the
    blocks an SM that __launch_bounds__ asks ptxas to fit."""

    kernel: str
    dtype: str
    words: tuple
    clip: bool
    rays: bool
    block: int
    min_blocks: int = MIN_BLOCKS

    @property
    def name(self):
        """The launcher's symbol: the kernel and the key's hash."""
        text = repr((self.kernel, self.dtype, tuple(self.words),
                     bool(self.clip), bool(self.rays), int(self.block),
                     int(self.min_blocks)))
        return "%s_%s" % (self.kernel,
                          hashlib.sha256(text.encode()).hexdigest()[:16])

    @property
    def rows(self):
        return len(self.words)

    @property
    def nlive(self):
        return sum(bin(w >> LIVE_SHIFT).count("1") for w in self.words)

    @property
    def word_bytes(self):
        return 4 if self.dtype == "f32" else 8

    @property
    def dynamic_smem(self):
        """K5's saved states: (rows - 1) * 6 words a thread."""
        if self.kernel != "k5":
            return 0
        return (self.rows - 1)*6*self.block*self.word_bytes


def _dtype_name(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError("rays must be float32 or float64, got %s" % dtype)


def _words(specs, masks=None):
    for j, spec in enumerate(specs[1:], 1):
        K.check_supported(spec, j)
    flags = [_flags(s) for s in specs]
    if masks is None:
        return tuple(flags)
    return tuple(f | m << LIVE_SHIFT for f, m in zip(flags, masks))


def moments_key(specs, dtype, clip=False, block=None,
                min_blocks=MIN_BLOCKS):
    """The K4 key of a spec tuple."""
    return Key("k4", _dtype_name(dtype), _words(specs), bool(clip), False,
               int(block or BLOCK_MOMENTS), int(min_blocks))


def adjoint_key(specs, dtype, clip=False, fields=FIELDS, rays=True,
                block=None, min_blocks=MIN_BLOCKS):
    """The K5 key of a spec tuple, the fields whose cotangents are
    wanted (see live_slots) and whether the ray and weight cotangents
    are."""
    key = Key("k5", _dtype_name(dtype), _words(specs, live_slots(specs,
                                                                 fields)),
              bool(clip), bool(rays), int(block or BLOCK_ADJOINT),
              int(min_blocks))
    smem = (key.dynamic_smem + (key.rows*17 + (key.block//32 + 1)
                                * max(key.nlive, 1))*key.word_bytes)
    if smem > SMEM_OPTIN:
        raise ValueError(
            "K5 keeps %d rows of saved state at %d threads a block in %s: "
            "%d bytes of shared memory, above %d" % (key.rows, key.block,
                                                     key.dtype, smem,
                                                     SMEM_OPTIN))
    return key


def translation_unit(key):
    """The source text that instantiates csrc/grad_spec.cuh for `key`."""
    ctype = "float" if key.dtype == "f32" else "double"
    words = ", ".join(str(w) for w in key.words)
    head = ("// %s, specialized by rayopt_tpu_torch.ops.cuda_spec\n"
            "// key: %r\n#include \"grad_spec.cuh\"\n\n"
            "namespace {\nusing Rows = Chain<%s>;\n}  // namespace\n\n"
            % (key.name, tuple(key), words))
    clip = "true" if key.clip else "false"
    if key.kernel == "k4":
        return head + "RAYOPT_SPEC_MOMENTS(%s, %s, Rows, %s, %d, %d)\n" % (
            key.name, ctype, clip, key.block, key.min_blocks)
    return head + "RAYOPT_SPEC_ADJOINT(%s, %s, Rows, %s, %s, %d, %d)\n" % (
        key.name, ctype, clip, "true" if key.rays else "false", key.block,
        key.min_blocks)


class SpecKernel:
    """One key's loaded library: `fn` the launcher, `grid(n, device)`
    the launch shape (cached per device), `build_seconds` and
    `build_log` (nvcc's output with the -Xptxas -v lines)."""

    def __init__(self, key, path, build_seconds, build_log):
        self.key = key
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.fn = getattr(self._lib, key.name)
        # K4: table, 6 rays, w, partials, counter, out, n, grid, stream;
        # K5: table, 6 rays, w, ct, partials, counter, out, 7 ray
        # cotangents, n, grid, stream
        words = 11 if key.kernel == "k4" else 19
        self.fn.argtypes = [ptr]*words + [i64, i32, ptr]
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


def prebuild(keys):
    """Build every key not yet loaded, one nvcc each, in parallel, and
    load them.  Returns {key: SpecKernel}."""
    from .cuda_build import build_shared
    todo = {k.name: k for k in keys if k not in _LOADED}
    if todo:
        built = build_shared({name: translation_unit(k)
                              for name, k in todo.items()}, HEADERS)
        for name, k in todo.items():
            _LOADED[k] = SpecKernel(k, *built[name])
    return {k: _LOADED[k] for k in keys}


def load(key):
    """The loaded kernel of one key (built at first use)."""
    kern = _LOADED.get(key)
    return kern if kern is not None else prebuild([key])[key]


@functools.lru_cache(maxsize=None)
def counter(device):
    """The zeroed uint32 the fused grid-wide sums count their blocks
    with; each launch's last block resets it.  One a device: launches
    that share it run in order on one stream."""
    return torch.zeros(1, dtype=torch.int32, device=device)
