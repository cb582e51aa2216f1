"""Build and bind the hand-written CUDA kernels of ``csrc/*.cu``.

Each source is compiled with nvcc for ``sm_90a`` into its own shared
library with a plain C interface, at first use, from the package's own
sources, into the package's own ``_build/`` directory (named by a hash of
the source and flags, so an edit rebuilds and each checkout or install
keeps its own). :func:`build_all` starts one nvcc per source at once and
waits for all of them. Libraries are loaded with ctypes: tensors pass as
``data_ptr()`` pointers and the launch stream as PyTorch's current
stream. Each C entry returns ``cudaGetLastError()``; a non-zero code
raises.

This module also holds the registry of kernels (:class:`Kernel`): every
wrapper with its plain PyTorch version and launch count, whichever source
its kernel lives in.

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

from .. import profiling

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

#: library name -> (prefix of its C entries, source file)
SOURCES = {
    "leapfrog": ("lf", _CSRC / "leapfrog.cu"),
    "prism_gz": ("gz", _CSRC / "prism_gz.cu"),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

_SIGNATURES = {
    "leapfrog": {
        "lf_refresh": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _U, _U,
                       _U, _P],
        "lf_drift": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
        "lf_residual": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "lf_step_residual": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _F, _P],
        "lf_residual_occupancy": [_I, _P],
        "lf_kick": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
                    _P],
        "lf_step_misfit": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P],
        "lf_traj_finish": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _F, _F, _F, _I, _P],
        "lf_accept": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _I, _I, _U, _U, _U, _P],
        "lf_kick_occupancy": [_I, _P],
        "lf_draws": [_P, _P, _I, _I, _I, _I, _U, _U, _U, _P],
        "lf_philox_bits": [_P, _I, _I, _U, _U, _U, _P],
        "lf_draw_units": [_P, _P, _P, _I, _U, _U, _U, _P],
    },
    "prism_gz": {
        "gz_matrix": [_P, _P, _P, _I, _I, _F, _P],
        "gz_nodes_matrix": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _F, _P],
    },
}


class KernelLibrary:
    """One loaded shared library plus how it was built."""

    def __init__(self, name, path, build_seconds, build_log):
        self.path = Path(path)
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(str(path))
        for entry, argtypes in _SIGNATURES[name].items():
            fn = getattr(self.cdll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._error_string = getattr(self.cdll,
                                     f"{SOURCES[name][0]}_error_string")
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p

    def call(self, entry, *args):
        """Run one C entry and raise on a CUDA error."""
        code = getattr(self.cdll, entry)(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{entry}: CUDA error {code}: {msg}")


_LIBRARIES = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name):
    source = SOURCES[name][1]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode())
    return source, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None):
    """Build (or load) the named libraries, all of them by default: one
    nvcc per source not built yet, started together. Returns name ->
    :class:`KernelLibrary`."""
    names = list(SOURCES) if names is None else list(names)
    jobs = {}
    for name in names:
        if name in _LIBRARIES:
            continue
        source, so = _target(name)
        if so.exists():
            _LIBRARIES[name] = KernelLibrary(name, so, 0.0, "cached")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        _LIBRARIES[name] = KernelLibrary(name, so, seconds, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _LIBRARIES[name] for name in names}


def library(name="leapfrog"):
    """One kernel library, compiled on first use in this process."""
    if name not in _LIBRARIES:
        build_all([name])
    return _LIBRARIES[name]


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


# ---------------------------------------------------------------- registry

class Kernel:
    """One hand-written CUDA kernel with its plain version and launch count.

    Calling it launches the kernel when the first tensor argument lies on
    a CUDA device (and adds one to ``launches``), or runs ``plain`` when it
    lies on the CPU; either way it returns what they return. While tracing
    is on (:mod:`..profiling`) each call is a span ``kernel.<name>``: on
    the card the kernel's issue, from the pointer checks through the C
    entry's return; on the CPU the plain version's run. ``replaces``
    names the TPU kernel it stands for; ``lib_name`` is the key in
    :data:`SOURCES` of the CUDA file its kernel is written in, whose repo
    path is ``source``.
    """

    def __init__(self, name, plain, launch, replaces, lib_name):
        self.name = name
        self.plain = plain
        self.replaces = replaces
        self.source = ("gravinv3dhmc_tpu_torch/csrc/"
                       + SOURCES[lib_name][1].name)
        self.launches = 0
        self._launch = launch
        self.span_name = "kernel." + name

    def __call__(self, *args):
        index = profiling.begin(self.span_name) if profiling.ON else None
        try:
            device = args[0].device
            if device.type == "cpu":
                return self.plain(*args)
            if device.type != "cuda":
                raise ValueError(f"{self.name}: no kernel for {device}")
            out = self._launch(*args)
            self.launches += 1
            return out
        finally:
            if index is not None:
                profiling.end(index)


#: every kernel of the port by name (filled as ``ops.leapfrog`` and
#: ``ops.prism_gz`` are imported; ``ops/__init__`` imports both)
KERNELS = {}


def register(*kernels):
    for k in kernels:
        KERNELS[k.name] = k


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts():
    return {name: k.launches for name, k in KERNELS.items()}
