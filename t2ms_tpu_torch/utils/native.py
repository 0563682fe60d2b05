"""The port's loader for the repository's host C++ kernels (``native/*.cpp``,
counterpart of t2ms_tpu/utils/native.py): one shared object built with g++
at first use and bound with ctypes.

The object is keyed by a hash of the sources' contents (a stale build
never shadows edited sources: mtimes are unreliable after a checkout) and
lives under ``build/t2ms_tpu_torch/native/`` at the repository root
(listed in .gitignore). It is compiled to a temporary name and moved into
place, so processes that build at once never read half a file, and it
never touches ``native/``. A failed build raises with g++'s output; the
caller does not fall back to numpy.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

__all__ = ["load_native", "native_dir", "build_dir"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def native_dir() -> str:
    return os.path.join(_ROOT, "native")


def build_dir() -> str:
    return os.path.join(_ROOT, "build", "t2ms_tpu_torch", "native")


def _target(sources) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(), f"libt2ms_native_{h.hexdigest()[:16]}.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dp = ctypes.POINTER(ctypes.c_double)
    lib.t2ms_dtw_ndim.restype = ctypes.c_double
    lib.t2ms_dtw_ndim.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.t2ms_dtw_batch.restype = None
    lib.t2ms_dtw_batch.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   dp]
    return lib


def load_native() -> ctypes.CDLL:
    """The bound library, built first if its sources changed. Raises
    RuntimeError when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(native_dir(), "*.cpp")))
        if not sources:
            raise RuntimeError(f"no C++ sources under {native_dir()}")
        so = _target(sources)
        if not os.path.exists(so):
            os.makedirs(build_dir(), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, *sources],
                                   capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"native build: g++ not found ({e})") \
                    from e
            if r.returncode:
                raise RuntimeError(f"native build failed (g++ exit "
                                   f"{r.returncode}):\n{r.stderr}")
            os.replace(tmp, so)
        _lib = _bind(ctypes.CDLL(so))
        return _lib
