"""Philox4x32-10 counter-based random numbers in plain torch.

The TPU kernels draw momentum and the Metropolis uniform from the TPU's
hardware PRNG (``pltpu.prng_random_bits``), which has no GPU counterpart.
The port uses Philox4x32-10 (Salmon et al. 2011), the generator PyTorch
itself uses on CUDA (constants as in ``ATen/core/PhiloxRNGEngine.h``),
written once here in torch integer arithmetic and once in
``csrc/leapfrog.cu``; both draw identical u32 words from the same key and
counter, so a kernel and its plain version see the same random numbers.

Key and counter layout, with disjoint fields:

* key (2 x u32): a salt derived from the run seed by splitmix64;
* counter word 0: element group (4 words per call, one per momentum
  coordinate of the group);
* counter word 1: chain index;
* counter word 2: global iteration index (chunk * chunk_size + step);
* counter word 3: stream — 0 for momentum, 1 for the accept uniform.

Every (iteration, chain, element, stream) therefore has its own counter
under one key, so no two draws of a run can coincide. (The JAX sampler
instead folds a constant into its base key for the hardware-PRNG salt,
which collides with the key of chunk 21527, ``hmc.py:423``; this layout
does not copy that.)

Integers are held in int64 tensors masked to 32 bits; the 32x32->64-bit
product is split into 16-bit halves so no intermediate overflows int64.
"""
from __future__ import annotations

import numpy as np
import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF

STREAM_MOMENTUM = 0
STREAM_ACCEPT = 1

#: 2*pi rounded to float32, as the TPU kernel's ``2 * np.float32(pi)``
TWO_PI = float(np.float32(2.0 * np.float32(np.pi)))


def salt_from_seed(seed):
    """64-bit Philox key from an integer seed (splitmix64 finaliser),
    returned as two u32 words."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z ^= z >> 31
    return z & MASK32, z >> 32


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for u32 ``a`` (int64 tensor) and
    a u32 constant ``m``, without leaving int64."""
    t_lo = (a & 0xFFFF) * m              # < 2^48
    t_hi = (a >> 16) * m                 # < 2^48
    mid = t_lo + ((t_hi & 0xFFFF) << 16)  # < 2^49
    return (t_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0, c1, c2, c3, key):
    """Philox4x32-10 of the counter words (broadcastable int64 tensors in
    [0, 2^32)) under ``key = (k0, k1)``; returns the four output words."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _counters(n_groups, chains, iteration, stream, device, j0=0):
    c0 = torch.arange(j0, j0 + n_groups, dtype=torch.int64,
                      device=device)[None, :]
    c1 = torch.as_tensor(chains, dtype=torch.int64, device=device)[:, None]
    c2 = torch.full((1, 1), int(iteration) & MASK32, dtype=torch.int64,
                    device=device)
    c3 = torch.full((1, 1), stream, dtype=torch.int64, device=device)
    return c0, c1, c2, c3


def u24(word):
    """Top 24 bits of a u32 word as a float32 in [0, 1)."""
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def momentum_bits(key, iteration, n_chains, width, device="cpu", c0=0,
                  j0=0):
    """(C, width) int64 tensor of the raw u32 words behind the momentum
    normals of one iteration (``width`` a multiple of 4): chains c0 ..
    c0 + C - 1 and element groups j0 .. j0 + width/4 - 1, the block of a
    wider draw that starts at chain ``c0`` and element ``4 j0``."""
    if width % 4:
        raise ValueError(f"width {width} must be a multiple of 4")
    c = _counters(width // 4, torch.arange(c0, c0 + n_chains), iteration,
                  STREAM_MOMENTUM, device, j0)
    words = philox4x32(*c, key)
    return torch.stack(words, dim=-1).reshape(n_chains, width)


def normals_from_bits(bits):
    """Box-Muller over consecutive word pairs: words (2i, 2i+1) give the
    normals (R cos, R sin) at positions (2i, 2i+1). The first word of a
    pair is shifted by half a step so the logarithm stays finite."""
    w = bits.reshape(*bits.shape[:-1], -1, 2)
    u1 = u24(w[..., 0]) + (0.5 / (1 << 24))
    u2 = u24(w[..., 1])
    rad = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
    out = torch.stack([rad * torch.cos(theta), rad * torch.sin(theta)],
                      dim=-1)
    return out.reshape(bits.shape)


def momentum_normals(key, iteration, n_chains, width, device="cpu", c0=0,
                     j0=0):
    """(C, width) float32 standard normals of one iteration's momentum
    refresh: what ``refresh`` in ``csrc/leapfrog.cu`` draws; with offsets,
    the block of chains c0.. and elements 4 j0.. of a wider draw."""
    return normals_from_bits(
        momentum_bits(key, iteration, n_chains, width, device, c0, j0))


def accept_uniforms(key, iteration, n_chains, device="cpu", c0=0):
    """(C,) float32 uniforms in [0, 1) for the Metropolis test of one
    iteration: word 0 of counter (0, chain, iteration, 1), chains c0 ..
    c0 + C - 1."""
    c = _counters(1, torch.arange(c0, c0 + n_chains), iteration,
                  STREAM_ACCEPT, device)
    return u24(philox4x32(*c, key)[0][:, 0])
