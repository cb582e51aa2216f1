"""ctypes bindings for the native tesseroid GLQ engine
(``native/tessglq.cpp``).

A copy of ``gravinv3dhmc_tpu/runtime/tessglq.py``: the dense kernel
matrix, the values of an explicit (observation, cell) pair subset and the
two-pass subdivision mask (the near field of the device builder,
``ops/tesseroid.tesseroid_kernel_device``). The engine is host C++ (OpenMP over observations), built with
``g++`` at first use from the package's own source into the package's
git-ignored ``_build/`` directory, the library named by a hash of the
source, the flags and the host's CPU as ``-march=native`` resolves it (an
edit rebuilds; a tree copied to another machine builds its own). It is
built into a file of this process's own and renamed into place, so
processes building at once do not see each other's half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "tessglq.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-std=c++17", "-shared",
         "-fPIC"]

_lock = threading.Lock()
_lib = None

FIELD_IDS = {
    "potential": 0, "gx": 1, "gy": 2, "gz": 3,
    "gxx": 4, "gxy": 5, "gxz": 6, "gyy": 7, "gyz": 8, "gzz": 9,
}


def library_path():
    """Where the library of this source, these flags and this host's CPU
    (``g++ -march=native -Q --help=target``) lives."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()
                            + target.encode())
    return BUILD_DIR / f"libtessglq_{digest.hexdigest()[:16]}.so"


def get_lib():
    """The loaded engine, built with ``g++`` first if need be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC.name} "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64ptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32ptr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tessglq_kernel_matrix.restype = None
        lib.tessglq_kernel_matrix.argtypes = [
            ctypes.c_int, dptr, dptr, dptr, ctypes.c_int64,
            dptr, ctypes.c_int64, ctypes.c_double, dptr]
        lib.tessglq_kernel_pairs.restype = None
        lib.tessglq_kernel_pairs.argtypes = [
            ctypes.c_int, dptr, dptr, dptr, i64ptr, i64ptr, ctypes.c_int64,
            dptr, ctypes.c_double, dptr]
        lib.tessglq_num_threads.restype = ctypes.c_int
        lib.tessglq_num_threads.argtypes = []
        lib.tessglq_subdiv_count.restype = None
        lib.tessglq_subdiv_count.argtypes = [
            dptr, dptr, dptr, dptr, ctypes.c_int64,
            dptr, dptr, dptr, dptr, dptr, ctypes.c_int64, i64ptr]
        lib.tessglq_subdiv_fill.restype = None
        lib.tessglq_subdiv_fill.argtypes = [
            dptr, dptr, dptr, dptr, ctypes.c_int64,
            dptr, dptr, dptr, dptr, dptr, ctypes.c_int64, i64ptr,
            i32ptr, i32ptr]
        _lib = lib
        return _lib


def kernel_matrix(field, lon, lat, height, cells, ratio):
    """(D, M) unscaled kernel matrix via the native adaptive GLQ engine."""
    lib = get_lib()
    lon = np.ascontiguousarray(lon, dtype=np.float64)
    lat = np.ascontiguousarray(lat, dtype=np.float64)
    height = np.ascontiguousarray(height, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.float64)
    D = lon.size
    M = cells.shape[0]
    out = np.empty((D, M), dtype=np.float64)
    lib.tessglq_kernel_matrix(FIELD_IDS[field], lon, lat, height, D,
                              cells, M, float(ratio), out)
    return out


def kernel_pairs(field, lon, lat, height, oi, ci, cells, ratio):
    """Unscaled kernel values of an explicit (obs, cell) pair subset: the
    near-field values of the device builder."""
    lib = get_lib()
    lon = np.ascontiguousarray(lon, dtype=np.float64)
    lat = np.ascontiguousarray(lat, dtype=np.float64)
    height = np.ascontiguousarray(height, dtype=np.float64)
    oi = np.ascontiguousarray(oi, dtype=np.int64)
    ci = np.ascontiguousarray(ci, dtype=np.int64)
    cells = np.ascontiguousarray(cells, dtype=np.float64)
    if oi.shape != ci.shape:
        raise ValueError(f"pair lists of shapes {oi.shape} and {ci.shape}")
    if oi.size and (oi.min() < 0 or oi.max() >= lon.size or ci.min() < 0
                    or ci.max() >= cells.shape[0]):
        raise ValueError("a pair index lies outside the observations or "
                         "the cells")
    out = np.empty(oi.size, dtype=np.float64)
    lib.tessglq_kernel_pairs(FIELD_IDS[field], lon, lat, height, oi, ci,
                             oi.size, cells, float(ratio), out)
    return out


def subdivision_pairs(lon_r, sinlat, coslat, radius, lont, sinlatt,
                      coslatt, rt, thr):
    """(oi, ci) int32 near-field pairs by the native two-pass mask: the f64
    pair test of ``ops/tesseroid.subdivision_mask``'s host path, OpenMP
    over observations, with no D x M temporaries."""
    lib = get_lib()
    obs = [np.ascontiguousarray(a, np.float64)
           for a in (lon_r, sinlat, coslat, radius)]
    cell = [np.ascontiguousarray(a, np.float64)
            for a in (lont, sinlatt, coslatt, rt, thr)]
    D = obs[0].size
    M = cell[0].size
    counts = np.empty(D, dtype=np.int64)
    lib.tessglq_subdiv_count(*obs, D, *cell, M, counts)
    offsets = np.zeros(D, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    total = int(counts.sum())
    oi = np.empty(total, dtype=np.int32)
    ci = np.empty(total, dtype=np.int32)
    lib.tessglq_subdiv_fill(*obs, D, *cell, M, offsets, oi, ci)
    return oi, ci
