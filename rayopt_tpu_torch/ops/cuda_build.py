"""Build the hand-written CUDA kernels (csrc/*.cuh) for each key.

ops.cuda_spec writes a small translation unit for a key (K1-K9: a spec
tuple; K10-K13: a plan key), or for a few keys that share a header's
defines, that instantiates the header's templates and exports plain C
launchers, which ctypes loads; nothing includes PyTorch's headers, so a
build takes seconds.  `build_shared` compiles the units with nvcc for
sm_90a at first use, one nvcc a unit, as many at a time as the process
may use cores, from the package's own sources into
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
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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


def entry_reports(log):
    """An nvcc log cut by kernel: (the lines before the first entry
    function, {entry function's mangled name: its -Xptxas -v lines})."""
    head, blocks, cur = [], {}, None
    for ln in log.splitlines(keepends=True):
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = blocks.setdefault(m.group(1), [])
        (head if cur is None else cur).append(ln)
    return "".join(head), {k: "".join(v) for k, v in blocks.items()}


def sass_size(path, entry=None):
    """(instructions, bytes) of a built library's SASS, or of its entry
    function `entry` alone (cuobjdump --dump-sass from the CUDA toolkit,
    16 bytes an instruction on Hopper); raises OSError or
    CalledProcessError without cuobjdump, KeyError for an entry the
    library lacks."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    if entry is not None:
        parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
        text = dict(zip(parts[1::2], parts[2::2]))[entry]
    count = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", text, re.M))
    return count, 16*count


def _digest(*parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else p.encode())
    return h.hexdigest()


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _compile(cmd):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build_shared(units, headers=(), strict=True):
    """Compile translation units into shared libraries under BUILD_DIR,
    one nvcc each, as many at a time as this process may use cores
    (every nvcc at once would hold hundreds of compilers in memory for
    no gain in speed); a unit already built (same name, headers, flags
    and text) is taken from the cache.
    units: {name: source text} (the text includes the headers from
    csrc/).  Returns {name: (path, nvcc seconds (0 if cached), nvcc's
    output)}; raises RuntimeError when a build fails (without `strict`,
    leaves the unit out instead)."""
    nvcc = _nvcc()
    head = b"".join((CSRC/h).read_bytes() for h in headers)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, todo = {}, []
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
        todo.append((name, lib, src, tmp,
                     [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC),
                      "-o", str(tmp), str(src)]))
    failed = []
    if todo:
        with ThreadPoolExecutor(max_workers=min(len(todo),
                                                _cores())) as pool:
            done = pool.map(_compile, [cmd for *_, cmd in todo])
            for (name, lib, src, tmp, cmd), (rc, log, seconds) in zip(todo,
                                                                    done):
                src.unlink(missing_ok=True)
                if rc:
                    failed.append("(exit %d) %s\n%s" % (rc, " ".join(cmd),
                                                         log))
                    continue
                lib.with_suffix(".log").write_text(log)
                os.replace(tmp, lib)
                out[name] = (lib, seconds, log)
    if failed and strict:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out
