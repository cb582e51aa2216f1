"""The port's sample sinks and reader (``runtime/sink.py``,
``runtime/sink_py.py``, ``runtime/native/gravsink.cpp``,
``diagnostics.load_chains``) against the JAX package's: the same f64 rows
give byte-identical ``model.dat`` and ``misfit.dat`` from all three
writers, and the readers give equal arrays, but past the reader's 4 MiB
read chunk, where the JAX package's reader shifts values and the port's
reads them as ``np.loadtxt`` does. The two JAX sinks treat a
stale file differently (the native one opens it with ``"w"``, truncating
it in place; the Python one deletes it and appends to a new file), and
each copy keeps its original's behaviour.
"""
import difflib
import fcntl
import os

import numpy as np
import pytest

from gravinv3dhmc_tpu import diagnostics as jdiag
from gravinv3dhmc_tpu.runtime import sink as jsink
from gravinv3dhmc_tpu.runtime import sink_py as jsink_py
from gravinv3dhmc_tpu_torch import diagnostics as tdiag
from gravinv3dhmc_tpu_torch.runtime import sink as tsink
from gravinv3dhmc_tpu_torch.runtime import sink_py as tsink_py

@pytest.fixture(scope="module", autouse=True)
def jax_sink_built():
    """Build the JAX package's native sink once, under a file lock: it
    compiles in place (``runtime/sink.py``: g++ writes the library where it
    is loaded from), so two test processes building at once could load a
    half-written library. The port's sink builds into a file of its own
    and renames it."""
    tsink.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(tsink.BUILD_DIR / "jax_gravsink.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jsink.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


SINKS = {"port": tsink.SampleSink, "port_py": tsink_py.PySampleSink,
         "jax": jsink.SampleSink, "jax_py": jsink_py.PySampleSink}


def _rows(seed=0, n=6, m=13):
    rng = np.random.RandomState(seed)
    models = rng.normal(scale=3.0, size=(n, m))
    models[0, :3] = [0.0, -1e-9, 123456.123456789]
    return models, rng.normal(size=(n, 7))


def _write(cls, folder, models, misfits):
    sink = cls(folder)
    for m, k in zip(models, misfits):
        sink.append(m, k)
    sink.close()
    return sink.folder


def test_source_is_the_jax_packages_but_the_reader_repair():
    """The port's ``gravsink.cpp`` is the JAX package's with one added
    statement (and its comment): the chunked reader's end of pass."""
    with open(tsink._SRC) as a, open(
            os.path.join(os.path.dirname(jsink.__file__), "native",
                         "gravsink.cpp")) as b:
        diff = [ln for ln in difflib.ndiff(b.read().splitlines(),
                                           a.read().splitlines())
                if ln[:2] in ("+ ", "- ")]
    assert all(ln.startswith("+ ") for ln in diff)
    code = [ln[2:].strip() for ln in diff
            if not ln[2:].strip().startswith("//")]
    assert code == ["pending[keep] = '\\0';"]
    assert tsink.library_path().parent == tsink.BUILD_DIR
    assert tsink.library_path().name.startswith("libgravsink_")


def test_sinks_write_identical_bytes(tmp_path):
    models, misfits = _rows()
    files = {}
    for name, cls in SINKS.items():
        folder = _write(cls, str(tmp_path / name), models, misfits)
        files[name] = [open(os.path.join(folder, f), "rb").read()
                       for f in ("model.dat", "misfit.dat")]
    for name in SINKS:
        assert files[name] == files["jax"], name
    text = files["port"][0].decode().splitlines()
    assert len(text) == 6 and text[0].split()[2] == "123456.12345679"


def test_read_matrix_matches_jax(tmp_path):
    models, misfits = _rows(1, n=40, m=300)
    folder = _write(tsink.SampleSink, str(tmp_path / "c"), models, misfits)
    for f, ref in (("model.dat", models), ("misfit.dat", misfits)):
        path = os.path.join(folder, f)
        got = tsink.read_matrix(path)
        np.testing.assert_array_equal(got, jsink.read_matrix(path))
        np.testing.assert_array_equal(got, np.loadtxt(path))
        # %.8f: half a unit of the eighth decimal, plus f64's spacing
        assert np.abs(got - ref).max() <= 5e-9 + 1e-15 * np.abs(ref).max()
    empty = tmp_path / "empty.dat"
    empty.write_text("")
    assert tsink.read_matrix(str(empty)).shape == (0, 0)
    with pytest.raises(OSError):
        tsink.read_matrix(str(tmp_path / "missing.dat"))


def test_read_matrix_across_its_read_chunks(tmp_path):
    """A file past the reader's 4 MiB read chunk whose boundary splits a
    value (64 x 6000 values in [0, 1), 11 bytes each): the port reads
    ``np.loadtxt``'s values. The JAX package's reader parses the split
    value's first part and then the value again, so every later value is
    one place late (ROADMAP.md queue 3); ``load_chains`` inherits it."""
    models = np.random.RandomState(0).uniform(0, 1, (64, 6000))
    folder = _write(tsink.SampleSink, str(tmp_path / "big0"), models,
                    np.zeros((64, 7)))
    path = os.path.join(folder, "model.dat")
    assert os.path.getsize(path) > 1 << 22
    assert (1 << 22) % 11 != 0
    want = np.loadtxt(path)
    np.testing.assert_array_equal(tsink.read_matrix(path), want)
    np.testing.assert_array_equal(
        tdiag.load_chains(str(tmp_path / "big"), 1)[0], want)
    jax = jsink.read_matrix(path)
    assert jax.shape == want.shape and not np.array_equal(jax, want)
    split = (1 << 22) // 11
    np.testing.assert_array_equal(jax.ravel()[:split],
                                  want.ravel()[:split])
    np.testing.assert_array_equal(jax.ravel()[split + 1:],
                                  want.ravel()[split:-1])


@pytest.mark.parametrize("ndraws,myrank", [(0, 0), (2, 3)])
def test_load_chains_matches_jax(tmp_path, ndraws, myrank):
    base = str(tmp_path / "chain")
    for c in range(myrank, myrank + 3):
        models, misfits = _rows(c, n=5 + c, m=9)
        _write(tsink.SampleSink, f"{base}{c}", models, misfits)
    got = tdiag.load_chains(base, 3, ndraws=ndraws, myrank=myrank)
    np.testing.assert_array_equal(
        got, jdiag.load_chains(base, 3, ndraws=ndraws, myrank=myrank))
    assert got.shape == (3, 5 + myrank - ndraws, 9)


@pytest.mark.parametrize("pair", [("port", "jax"), ("port_py", "jax_py")])
def test_stale_files_as_the_jax_sink_treats_them(tmp_path, pair):
    """A stale ``model.dat`` that is a link to another file: the native
    sink truncates the file it points to and writes through the link; the
    Python sink removes the link and writes a new file, leaving the other
    file as it was. Each port sink does what its JAX counterpart does."""
    models, misfits = _rows(2, n=2, m=4)
    outcome = []
    for name in pair:
        folder = tmp_path / name
        folder.mkdir()
        kept = folder / "kept.txt"
        kept.write_text("stale line\n" * 3)
        (folder / "model.dat").symlink_to(kept)
        (folder / "misfit.dat").write_text("stale\n")
        _write(SINKS[name], str(folder), models, misfits)
        outcome.append(((folder / "model.dat").is_symlink(),
                        kept.read_text(),
                        (folder / "model.dat").read_text(),
                        (folder / "misfit.dat").read_text()))
    assert outcome[0] == outcome[1]
    linked, kept, model, misfit = outcome[0]
    assert "stale" not in model and "stale" not in misfit
    assert linked == (pair[0] == "port")
    assert (kept == model) == (pair[0] == "port")


def test_write_chains_layout(tmp_path):
    """``write_chains``: folder ``<save_folder><myrank + c>`` and
    ``counts[c]`` rows for chain c, read back by ``load_chains``."""
    models = np.random.RandomState(4).normal(size=(3, 5, 6))
    misfits = np.zeros((3, 5, 7))
    base = str(tmp_path / "w")
    folders = tsink.write_chains(base, 2, models, misfits, [5, 3, 4])
    assert folders == [f"{base}{c}" for c in (2, 3, 4)]
    got = tdiag.load_chains(base, 3, myrank=2)
    assert got.shape == (3, 3, 6)
    assert np.abs(got - models[:, :3]).max() <= 5e-9
    assert tsink.read_matrix(os.path.join(folders[1], "misfit.dat")).shape \
        == (3, 7)
