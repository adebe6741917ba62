"""Build the port's CUDA sources into plain-C shared libraries.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
`paddle_tpu_torch/_build/<name>-<hash>.so`, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, at first use,
and loaded with `ctypes`; its `-Xptxas -v` output is
`<name>-<hash>.log` (a failed build leaves `<name>-<hash>.<pid>.log`,
the failing process's own). The sources
include no PyTorch header, so a build takes seconds. `build(names)`
starts one `nvcc` per source, all together, and waits for them.

Nothing here runs at import time: the CPU tests import every module of
the package, and this machine may have no CUDA toolkit.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}          # name -> ctypes.CDLL
build_seconds = {}  # name -> wall seconds of the nvcc run (0.0 if cached)


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit")
    return found


def _target(name):
    """(source, library path): the library is keyed by the source, the
    headers of csrc/ it may include, and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names):
    """Compile every source in `names` that has no up-to-date library,
    one nvcc process each, started together. Returns {name: path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, procs, paths = None, {}, {}
    for name in names:
        src, so = _target(name)
        paths[name] = so
        if os.path.exists(so):
            build_seconds.setdefault(name, 0.0)
            continue
        nvcc = nvcc or _nvcc()
        # per process, as the .tmp is: ranks of one launch that build at
        # once must not interleave one log
        tmp = f"{so}.{os.getpid()}.tmp"
        log = open(f"{so[:-3]}.{os.getpid()}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT), tmp, so, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        build_seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}, log {log.name})")
            continue
        os.replace(tmp, so)   # atomic: a reader never sees half a library
        os.replace(log.name, so[:-3] + ".log")   # the library's build log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + ", ".join(failed))
    return paths


def load(name):
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build([name])[name])
        return lib
