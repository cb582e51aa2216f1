"""Sampler checkpoint/resume: a copy of ``gravinv3dhmc_tpu/checkpoint.py``
for a carry of torch tensors.

The sampler's whole state (chain positions, cached potential and
gradient, the sample buffers, acceptance counters, the chunk index and
the run's key) is one ``.npz`` written atomically (``<path>.tmp.npz``,
then ``os.replace``) with the JAX package's keys: ``leaf_<i>`` (the carry
in order, each leaf copied to the host on its own and written
uncompressed), ``n_chunks``, ``base_key`` (uint32[2]: here the Philox salt
words of the run's seed, ``ops/philox.py``; so JAX's ``wrap_key_data``
reads the file) and ``meta`` (JSON bytes as uint8). A resumed run is the
uninterrupted one's continuation because a chunk's draws depend only on
(seed, chunk index) (``inversion/hmc.py``).

``extra`` keys ride in the same file under names the JAX ``load_state``
does not read (:func:`load_extra`): ``HamiltonianMC.sample`` stores the
frozen kernel there (its step size, flag and inverse mass), which the
JAX package's snapshots lack.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

#: the keys of the JAX package's layout besides the leaves
_JAX_KEYS = ("n_chunks", "base_key", "meta")


def save_state(path, carry, n_chunks, base_key, meta=None, extra=None):
    """Atomically snapshot a sampler carry (a tuple of tensors), the loop
    counter, the run's key (two u32 words) and ``meta``; ``extra`` maps
    further key names to arrays."""
    payload = {f"leaf_{i}": leaf.detach().cpu().numpy()
               for i, leaf in enumerate(carry)}
    payload["n_chunks"] = np.asarray(n_chunks)
    payload["base_key"] = np.asarray(base_key, dtype=np.uint32)
    payload["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    for name, value in (extra or {}).items():
        if name in payload or name.startswith("leaf_"):
            raise ValueError(f"extra key {name!r} is one of the layout's")
        payload[name] = np.asarray(value)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_state(path, like_carry=None, dtype=None):
    """Load a snapshot; returns ``(carry, n_chunks, base_key, meta)`` with
    ``base_key`` the stored uint32[2] words as a tuple of ints.

    ``like_carry`` (optional) gives each leaf's device and dtype, and the
    leaf count, which must match (``ValueError``); otherwise the leaves
    come back in saved order as CPU tensors. ``dtype`` is unused, as in
    the JAX package's signature.
    """
    del dtype
    with np.load(path) as z:
        n_leaves = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n_leaves)]
        n_chunks = int(z["n_chunks"])
        base_key = tuple(int(w) for w in z["base_key"])
        meta = json.loads(bytes(z["meta"].tobytes()).decode() or "{}")
    if like_carry is not None:
        if len(like_carry) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, expected "
                f"{len(like_carry)} — config mismatch?")
        carry = tuple(torch.from_numpy(leaf).to(device=r.device,
                                                dtype=r.dtype)
                      for leaf, r in zip(leaves, like_carry))
    else:
        carry = tuple(torch.from_numpy(leaf) for leaf in leaves)
    return carry, n_chunks, base_key, meta


def load_extra(path):
    """The snapshot's keys beyond the JAX package's layout, as numpy
    arrays (empty for a file the JAX package wrote)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files
                if not k.startswith("leaf_") and k not in _JAX_KEYS}
