"""Pure-Python sample sink: a copy of ``gravinv3dhmc_tpu/runtime/sink_py.py``.

The port never falls back to it (``sink.py`` raises when the native sink
cannot be built); it is the plain version the tests hold the native sink
against.

Writes the reference's append-style output files: ``model.dat`` (one
accepted sample per line, '%.8f' space-delimited) and the 7-column
``misfit.dat`` (reference: inversion/hmc.py:241-249). Stale files are
removed at start like the reference does (inversion/hmc.py:256-258).
"""
from __future__ import annotations

import os

import numpy as np


class PySampleSink:
    def __init__(self, folder):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        for name in ("model.dat", "misfit.dat"):
            path = os.path.join(folder, name)
            if os.path.exists(path):
                os.remove(path)
        self._model_f = open(os.path.join(folder, "model.dat"), "a")
        self._misfit_f = open(os.path.join(folder, "misfit.dat"), "a")

    def append(self, model, misfit_row):
        np.savetxt(self._model_f, np.asarray(model)[None, :], fmt="%.8f",
                   delimiter=" ")
        np.savetxt(self._misfit_f, np.asarray(misfit_row)[None, :],
                   fmt="%.8f", delimiter=" ")

    def flush(self):
        self._model_f.flush()
        self._misfit_f.flush()

    def close(self):
        self._model_f.close()
        self._misfit_f.close()
