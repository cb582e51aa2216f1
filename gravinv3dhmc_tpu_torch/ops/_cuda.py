"""Build and bind the hand-written CUDA kernels of ``csrc/leapfrog.cu``.

The source is compiled with nvcc for ``sm_90a`` into a shared library with
a plain C interface, at first use, from the package's own sources, into
the package's own ``_build/`` directory (named by a hash of the source
and flags, so an edit rebuilds and each checkout or install keeps its
own). It is loaded with ctypes: tensors pass as ``data_ptr()`` pointers
and the launch stream as PyTorch's current stream.
Each C entry returns ``cudaGetLastError()``; a non-zero code raises.

Nothing here runs at import time: the CPU-only test runs import this
module and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "leapfrog.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

_SIGNATURES = {
    "lf_refresh": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _U, _U, _U,
                   _P],
    "lf_drift": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "lf_residual": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lf_kick": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P],
    "lf_traj_finish": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _F, _F, _F, _I, _P],
    "lf_accept": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _U, _U, _U, _P],
    "lf_philox_bits": [_P, _I, _I, _U, _U, _U, _P],
}


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, path, build_seconds, build_log):
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.cdll.lf_error_string.argtypes = [ctypes.c_int]
        self.cdll.lf_error_string.restype = ctypes.c_char_p

    def call(self, name, *args):
        """Run one C entry and raise on a CUDA error."""
        code = getattr(self.cdll, name)(*args)
        if code != 0:
            msg = self.cdll.lf_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


_LIBRARY = None


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library():
    """The kernel library, compiled on first use in this process."""
    global _LIBRARY
    if _LIBRARY is None:
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libleapfrog_{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, "cached"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
        _LIBRARY = KernelLibrary(so, seconds, log)
    return _LIBRARY


def ptr(t, dtype, shape=None):
    """Checked data pointer of a contiguous CUDA tensor (None -> NULL)."""
    if t is None:
        return None
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("expected a contiguous, 16-byte aligned tensor")
    return t.data_ptr()


def stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream
