"""Build the hand-written CUDA kernels (csrc/*.cuh) for each key.

ops.cuda_spec writes one small translation unit a key (K1-K9: a spec
tuple; K10-K13: a plan key) that instantiates a header's templates and
exports plain C launchers, which ctypes loads; nothing includes
PyTorch's headers, so a build takes seconds.  `build_shared` compiles
the units with nvcc for sm_90a at first use, one nvcc a unit, all
started together, from the package's own sources into
build/torch_kernels/ beside the package, each cached by a hash of the
headers, the flags and the unit's text.  Fast math stays off: the
kernels rely on IEEE division, square root and NaN propagation.  The
df32 kernels (df32_spec.cuh) need every float32 operation rounded as
written; they write each one with a round-to-nearest intrinsic (the
one fused multiply-add, two_prod's error word, with __fmaf_rn), which
nvcc never contracts, so all units share one set of flags.
"""

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
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
