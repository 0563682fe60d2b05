"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), keyed
by a hash of the sources and flags, under ``build/t2ms_tpu_torch/`` at the
repository root (listed in .gitignore). Libraries load with ctypes. The
build runs at the first CUDA use of a kernel, never at import; ``build_all``
starts one nvcc per source at once. A missing nvcc or a failed compile
raises.

``launch`` calls a C entry on the current stream and counts it; ``supported``
asks a library's ``*_check`` entry whether its kernels take a shape.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

__all__ = ["load", "build_all", "build_logs", "sources", "launch_counts",
           "count_launch", "reset_launch_counts", "cuda_error_string",
           "launch", "supported", "refuse_autograd", "UNSUPPORTED_SHAPE"]

UNSUPPORTED_SHAPE = -1     # T2MS_UNSUPPORTED_SHAPE in dit_common.cuh

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "t2ms_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# library name -> nvcc's output of its build in this process (ptxas's
# registers, shared memory and spills of every kernel, from -Xptxas=-v)
build_logs: Dict[str, str] = {}
_lock = threading.Lock()
_counts_lock = threading.Lock()

# kernel name -> launches on CUDA tensors since the last reset
launch_counts: "collections.Counter[str]" = collections.Counter()


def count_launch(name: str) -> None:
    with _counts_lock:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _counts_lock:
        launch_counts.clear()


def sources() -> Dict[str, str]:
    """Kernel library name -> its .cu path."""
    return {f[:-3]: os.path.join(_CSRC, f)
            for f in sorted(os.listdir(_CSRC)) if f.endswith(".cu")}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the port's "
                       "CUDA kernels cannot be built")


def _target(name: str) -> str:
    h = hashlib.sha256()
    src = sources()[name]
    for path in [src] + sorted(
            os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
            if f.endswith((".cuh", ".h"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = None) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source started at once;
    returns name -> seconds (0 for a library already built)."""
    import time
    names = list(sources()) if names is None else list(names)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            secs[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, sources()[name]]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = log.decode(errors="replace")
        if p.returncode:
            failed.append(f"{name}: nvcc exit {p.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name))
            _declare(lib)
            _libs[name] = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    """Argument types of every C entry point: pointers and the stream are
    c_void_p (a plain int would be cut to 32 bits), strides c_longlong."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    sigs = {
        "dit_stack_forward": [P] * 13 + [I] * 6 + [F, F, P],
        "dit_stack_attention": [P] * 4 + [I] * 4 + [F, P],
        "dit_split_forward": [P] * 15 + [I] * 5 + [F, F, P],
        "dit_split_gemm": [P] * 6 + [I] * 5 + [F, P],
        "dit_block_backward": [P] * 22 + [I] * 5 + [F, F, P],
        "dit_block_attention_bwd": [P] * 4 + [I] * 4 + [F, P],
        "dit_block_mlp_bwd": [P] * 13 + [I] * 4 + [F, P],
        "dit_block_qkv_bwd": [P] * 7 + [I] * 3 + [F, P],
        "mod_ln_forward": [P, P, L, I, P] + [I] * 3 + [F, P],
        "mod_ln_backward": [P, P, L, I] + [P] * 4 + [I] * 3 + [F, P],
        "res_mod_ln_forward": [P] * 3 + [L, I, P, P] + [I] * 3 + [F, P],
        "res_mod_ln_backward": [P] * 3 + [L, I] + [P] * 6 + [I] * 3
                               + [F, P],
        "fused_heads_forward": [P] * 4 + [I] * 4 + [L] * 6 + [F, P],
        "fused_heads_forward_stats": [P] * 5 + [I] * 4 + [L] * 6 + [F, P],
        "fused_heads_backward": [P] * 8 + [I] * 4 + [L] * 8 + [I, F, F, P],
        "fused_heads_backward_lean": [P] * 9 + [I] * 4 + [L] * 8 + [F, F, P],
        "split_heads_forward": [P] * 4 + [I] * 4 + [L] * 12 + [I, I, F, P],
    }
    for base, argtypes in sigs.items():
        for fn in (f"{base}_bf16", f"{base}_f32"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = I
    for fn, n in (("dit_block_backward_workspace", 6),
                  ("mod_ln_backward_workspace", 3),
                  ("res_mod_ln_backward_workspace", 3),
                  ("fused_heads_backward_workspace", 5),
                  ("fused_heads_forward_smem", 1),
                  ("fused_heads_backward_smem", 3),
                  ("split_heads_smem", 4),
                  ("dit_stack_smem", 4),
                  ("dit_block_bwd_smem", 4),
                  ("dit_split_smem", 2)):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [I] * n
            getattr(lib, fn).restype = ctypes.c_longlong
    for fn, n in (("dit_stack_check", 4), ("dit_block_check", 4),
                  ("dit_split_check", 4), ("mod_ln_check", 2),
                  ("res_mod_ln_check", 2), ("fused_heads_check", 3),
                  ("split_heads_check", 2), ("dit_stack_tc_route", 5),
                  ("dit_split_route", 2)):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [I] * n
            getattr(lib, fn).restype = I
    if hasattr(lib, "t2ms_cuda_error_string"):
        lib.t2ms_cuda_error_string.argtypes = [I]
        lib.t2ms_cuda_error_string.restype = ctypes.c_char_p


def cuda_error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.t2ms_cuda_error_string(err).decode()})"


def supported(library: str, check: str, *args: int) -> bool:
    """Ask a kernel library's own check (the limits live in the CUDA
    sources only), which builds and loads it: needs nvcc and a card."""
    lib = load(library)
    err = getattr(lib, check)(*args)
    if err not in (0, UNSUPPORTED_SHAPE):
        raise RuntimeError(f"{check} failed: {cuda_error_string(lib, err)}")
    return err == 0


def launch(lib: ctypes.CDLL, entry: str, name: str, refused,
           dev: torch.device, *args) -> None:
    """Call the C entry ``entry`` of ``lib`` on dev's current stream, with
    each tensor of ``args`` passed as its pointer and each float as a C
    float. Raise ``refused`` (an exception, or a function that makes one)
    for a shape the kernels do not take and RuntimeError for a failed
    launch; count the launch under ``name``."""
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_float(a) if isinstance(a, float) else a
            for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*conv, ctypes.c_void_p(stream))
    if err == UNSUPPORTED_SHAPE:
        raise refused() if callable(refused) else refused
    if err:
        raise RuntimeError(f"{name} CUDA launch failed: "
                           f"{cuda_error_string(lib, err)}")
    count_launch(name)


def refuse_autograd(name: str, tensors, train_path: str) -> None:
    """A CUDA forward writes its output through a raw pointer, so the
    result carries no grad_fn: under grad mode, inputs that require grad
    would train nothing and raise nothing. Refuse them instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} on CUDA has no backward; an input requires grad under "
            f"grad mode, so train through {train_path} (or run this under "
            f"torch.no_grad())")
