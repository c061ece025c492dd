"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles the sources into a shared library with a plain C
interface, which ctypes loads; nothing includes PyTorch's headers, so
a build takes seconds.  One nvcc per source runs in parallel, then one
links the objects.  It runs at first use, from the package's own
sources, into build/torch_kernels/ beside the package, and is cached
by a hash of the sources and flags.  `build_shared` builds the
translation units that ops.cuda_spec writes for each spec key (K1, K2,
K4-K9) and plan key (K10-K13) the same way, one nvcc a unit, in
parallel, cached by a hash of the headers, the flags and the unit's
text.  Fast math stays off: the kernels
rely on IEEE division, square root and NaN propagation.  The df32
kernels (df32_spec.cuh) need every float32 operation rounded as
written; they write each one with a round-to-nearest intrinsic (the
one fused multiply-add, two_prod's error word, with __fmaf_rn), which
nvcc never contracts, so all sources share one set of flags.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
SOURCES = ("trace.cu",)     # K3
HEADERS = ("trace_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH)")


class KernelLibrary:
    """The loaded kernel library, with how it was built.

    build_seconds: wall time of the nvcc run (0 when it came from the
    cache); build_log: nvcc's output, including the -Xptxas -v
    register and spill lines of every kernel."""

    def __init__(self, path, build_seconds, build_log):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # K3: table, flags, nsurf, nlam, 6 rays, out, n, grid, block,
        # stream
        for dt in ("f32", "f64"):
            for name in ("trace_multi_", "trace_multi_merit_"):
                fn = getattr(self._lib, name + dt)
                fn.argtypes = [ptr, ptr, i32, i32] + [ptr]*7 + [
                    i64, i32, i32, ptr]
                fn.restype = i32
        self._lib.trace_error_string.argtypes = [i32]
        self._lib.trace_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def ptxas_lines(self):
        """The register/shared-memory/spill lines of nvcc's -Xptxas -v
        report."""
        return ptxas_lines(self.build_log)


def ptxas_lines(log):
    """The register/shared-memory/spill lines of a -Xptxas -v report."""
    return [ln.strip() for ln in log.splitlines()
            if "ptxas info" in ln or "bytes stack frame" in ln]


def sass_size(path):
    """(instructions, bytes) of a built library's SASS (cuobjdump
    --dump-sass from the CUDA toolkit, 16 bytes an instruction on
    Hopper); raises OSError or CalledProcessError without cuobjdump."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    count = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", text, re.M))
    return count, 16*count


def _digest(*parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else p.encode())
    return h.hexdigest()


def build_shared(units, headers=()):
    """Compile translation units into shared libraries under BUILD_DIR,
    one nvcc each, all started together; a unit already built (same
    name, headers, flags and text) is taken from the cache.
    units: {name: source text} (the text includes the headers from
    csrc/).  Returns {name: (path, nvcc seconds (0 if cached), nvcc's
    output)}; raises RuntimeError when a build fails."""
    nvcc = _nvcc()
    head = b"".join((CSRC/h).read_bytes() for h in headers)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, []
    for name, text in units.items():
        digest = _digest(head, " ".join(NVCC_FLAGS), text)[:12]
        lib = BUILD_DIR / ("%s_%s.so" % (name, digest))
        log_path = lib.with_suffix(".log")
        if lib.exists() and log_path.exists():
            out[name] = (lib, 0., log_path.read_text())
            continue
        src = lib.with_name("%s.%d.cu" % (lib.stem, os.getpid()))
        src.write_text(text)
        tmp = lib.with_name(lib.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        jobs.append((name, lib, src, tmp, cmd, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, src, tmp, cmd, t0, proc in jobs:
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        src.unlink(missing_ok=True)
        if proc.returncode:
            failed.append("(exit %d) %s\n%s" % (proc.returncode,
                                                 " ".join(cmd), log))
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = (lib, seconds, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernel library; raises
    RuntimeError when nvcc is missing or the build fails."""
    nvcc = _nvcc()
    digest = _digest(*((CSRC/name).read_bytes() for name in SOURCES + HEADERS),
                     " ".join(NVCC_FLAGS))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / ("librayopt_trace_%s.so" % digest[:16])
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return KernelLibrary(lib, 0., log_path.read_text())
    tmp = lib.with_name(lib.name + ".%d.tmp" % os.getpid())
    objs = [lib.with_name("%s.%s.%d.o" % (lib.stem, Path(name).stem,
                                          os.getpid()))
            for name in SOURCES]
    t0 = time.perf_counter()
    # one nvcc a source, all started together, then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC/name)]
            for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, p.returncode, lg) for cmd, p, lg in zip(cmds, procs, logs)
              if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, proc.returncode, logs[-1]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            "(exit %d) %s\n%s" % (rc, " ".join(cmd), lg)
            for cmd, rc, lg in failed))
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib)
    return KernelLibrary(lib, seconds, log)
