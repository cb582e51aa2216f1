"""ctypes bindings for the native sample sink (``native/gravsink.cpp``).

A copy of ``gravinv3dhmc_tpu/runtime/sink.py``:

* :class:`SampleSink` — a background-thread writer of the reference's
  ``model.dat`` / ``misfit.dat`` sample streams (``%.8f``, one row a line;
  the files are opened with ``"w"``, so stale ones are truncated);
* :func:`read_matrix` — a whitespace-float matrix reader for those files.

The library is built with ``g++`` at first use from the package's own
source into the package's git-ignored ``_build/`` directory, named by a
hash of the source and the flags (an edit rebuilds), and renamed into
place from a file of this process's own, as ``runtime/tessglq.py`` builds
its engine. Unlike the JAX package, nothing falls back to the Python sink
(``sink_py.py``) when the build or ``gravsink_open`` fails: that raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "gravsink.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libgravsink_{digest.hexdigest()[:16]}.so"


def get_lib():
    """The loaded library, built with ``g++`` first if need be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *FLAGS, str(_SRC), "-o", str(tmp), *LIBS],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC.name} "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.gravsink_open.restype = ctypes.c_void_p
        lib.gravsink_open.argtypes = [ctypes.c_char_p]
        lib.gravsink_append.restype = None
        lib.gravsink_append.argtypes = [ctypes.c_void_p, dptr,
                                        ctypes.c_int64, dptr, ctypes.c_int64]
        lib.gravsink_flush.restype = None
        lib.gravsink_flush.argtypes = [ctypes.c_void_p]
        lib.gravsink_close.restype = None
        lib.gravsink_close.argtypes = [ctypes.c_void_p]
        lib.gravsink_count_matrix.restype = ctypes.c_int64
        lib.gravsink_count_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gravsink_read_matrix.restype = ctypes.c_int64
        lib.gravsink_read_matrix.argtypes = [ctypes.c_char_p, dptr,
                                             ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


class SampleSink:
    """Background-threaded writer of one chain's ``<folder>/model.dat`` and
    ``misfit.dat`` (reference file format, inversion/hmc.py:241-249).
    :meth:`close` joins the writer thread: call it before reading the
    files."""

    def __init__(self, folder):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self._lib = get_lib()
        self._handle = self._lib.gravsink_open(folder.encode())
        if not self._handle:
            raise OSError(f"gravsink_open failed for {folder}")

    def append(self, model, misfit_row):
        model = np.ascontiguousarray(model, dtype=np.float64)
        misfit_row = np.ascontiguousarray(misfit_row, dtype=np.float64)
        self._lib.gravsink_append(self._handle, model, model.size,
                                  misfit_row, misfit_row.size)

    def flush(self):
        self._lib.gravsink_flush(self._handle)

    def close(self):
        if self._handle:
            self._lib.gravsink_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_matrix(path):
    """Load a whitespace-delimited float matrix (model.dat/misfit.dat)."""
    lib = get_lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.gravsink_count_matrix(path.encode(), ctypes.byref(rows),
                                 ctypes.byref(cols)) != 0:
        raise OSError(f"cannot open {path}")
    r, c = rows.value, cols.value
    if r == 0 or c == 0:
        return np.zeros((0, 0))
    out = np.empty(r * c, dtype=np.float64)
    n = lib.gravsink_read_matrix(path.encode(), out, r, c)
    if n != r * c:
        raise ValueError(f"{path}: parsed {n} values, expected {r}x{c}")
    return out.reshape(r, c)


def write_chains(save_folder, myrank, models, misfits, counts=None):
    """Write chain c's first ``counts[c]`` rows (all when None) of the host
    arrays ``models`` (C, N, M) and ``misfits`` (C, N, 7) to
    ``<save_folder><myrank + c>/`` through :class:`SampleSink`, one chain
    at a time, each sink closed before the next opens; returns the
    folders."""
    folders = []
    for c in range(models.shape[0]):
        sink = SampleSink(f"{save_folder}{myrank + c}")
        try:
            n = models.shape[1] if counts is None else int(counts[c])
            for i in range(n):
                sink.append(models[c, i], misfits[c, i])
        finally:
            sink.close()
        folders.append(sink.folder)
    return folders
