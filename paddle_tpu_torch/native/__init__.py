"""Host-side C++ for the data path (counterpart of paddle_tpu/native): the
DataLoader's batch assembler, `assemble_batch`.

`batch_assemble.cc` is built with the system g++ at its first use, into
`paddle_tpu_torch/_build/libpt_native-<hash>.so` (gitignored; the hash
covers the source), and loaded with ctypes: a plain C interface, no
PyTorch headers, so the build takes about a second. Nothing is built on
import. Without a compiler `assemble_batch` is `np.stack`, as the
reference's is (native/__init__.py:101). The sparse table and the slot
parser wait for the parameter server (ROADMAP A 2).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["get_lib", "is_available", "assemble_batch"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["batch_assemble.cc"]
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lib = None
_tried = False
_lock = threading.Lock()


def _source_hash():
    h = hashlib.sha1()
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _build(out_path):
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
           "-o", out_path] + [os.path.join(_DIR, s) for s in _SOURCES]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = os.path.join(_BUILD_DIR, f"libpt_native-{_source_hash()}.so")
        try:
            if not os.path.exists(path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = path + f".tmp{os.getpid()}"
                _build(tmp)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            # no g++, a failed build or a library that does not load:
            # the callers' np.stack path
            return None
        lib.pt_assemble_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        lib.pt_assemble_batch.restype = None
        _lib = lib
        return _lib


def get_lib():
    """The loaded CDLL, building it if needed; None when unavailable."""
    return _load()


def is_available():
    return _load() is not None


def assemble_batch(samples, out=None, n_threads=0):
    """Stack N equal-shaped numpy samples into one batch array with the
    native thread pool (GIL released). Falls back to np.stack when the
    library is missing, for object arrays and for ragged samples."""
    lib = get_lib()
    samples = [np.ascontiguousarray(s) for s in samples]
    if lib is None:
        return np.stack(samples)
    n = len(samples)
    if n == 0:
        raise ValueError("empty batch")
    shape, dtype = samples[0].shape, samples[0].dtype
    if dtype.hasobject:
        # raw memcpy of PyObject* would skip increfs → refcount corruption
        return np.stack(samples)
    for s in samples[1:]:
        if s.shape != shape or s.dtype != dtype:
            return np.stack(samples)  # ragged: numpy's error/semantics
    if out is None:
        out = np.empty((n,) + shape, dtype)
    ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in samples])
    lib.pt_assemble_batch(ptrs, n, samples[0].nbytes, out.ctypes.data,
                          n_threads)
    return out
