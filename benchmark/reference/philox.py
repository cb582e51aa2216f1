"""Philox4x32-10 draws and trajectory lengths, as the sampler keys them.

The counter-based generator of Salmon et al. (2011), the one PyTorch uses
on CUDA, with the sampler's layout: key = splitmix64 of the run seed (two
u32 words); counter = (element group, chain, global iteration, stream),
stream 0 for the momentum normals (Box-Muller over consecutive words,
the first of a pair shifted half a step) and 1 for the accept uniform
(the top 24 bits of word 0). Each (chain, iteration) row gets its own
counters here, so any sample of chains and iterations is drawn at once.
The trajectory lengths come from a CPU ``torch.Generator`` seeded by
splitmix64 of ``(seed << 32) + chunk``: ``randint(Lmin, Lmax + 1)`` for
the chunk's iterations (one L each, shared by all chains).
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)


def splitmix64(seed):
    """``(lo, hi)`` u32 words of splitmix64's finaliser of ``seed``."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    z ^= z >> 31
    return z & M32, z >> 32


def _mul32(a, m):
    """High and low words of u32 ``a`` (int64 tensor) times constant m."""
    lo16 = (a & 0xFFFF) * m
    hi16 = (a >> 16) * m
    mid = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (mid >> 32), mid & M32


def philox(c, key):
    """The four output words of Philox4x32-10 for counters ``c`` (four
    broadcastable int64 tensors of u32 values) under ``key``."""
    c0, c1, c2, c3 = c
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _WEYL[0]) & M32, (k1 + _WEYL[1]) & M32
        h0, l0 = _mul32(c0, _MUL[0])
        h1, l1 = _mul32(c2, _MUL[1])
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def _unit(word):
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normals(seed, chains, iterations, width, device):
    """(R, width) float32 momentum normals of rows (chain, iteration):
    ``chains`` and ``iterations`` are (R,) integer tensors."""
    key = splitmix64(seed)
    ch = torch.as_tensor(chains, dtype=torch.int64, device=device)[:, None]
    it = torch.as_tensor(iterations, dtype=torch.int64,
                         device=device)[:, None] & M32
    grp = torch.arange(width // 4, dtype=torch.int64, device=device)[None]
    words = torch.stack(philox((grp, ch, it, torch.zeros_like(ch)), key),
                        dim=-1).reshape(ch.shape[0], width)
    pairs = words.reshape(ch.shape[0], width // 2, 2)
    u1 = _unit(pairs[..., 0]) + 0.5 / (1 << 24)
    u2 = _unit(pairs[..., 1])
    rad = torch.sqrt(-2.0 * torch.log(u1))
    theta = float(torch.tensor(2.0 * math.pi, dtype=torch.float32)) * u2
    return torch.stack([rad * torch.cos(theta), rad * torch.sin(theta)],
                       dim=-1).reshape(ch.shape[0], width)


def uniforms(seed, chains, iterations, device):
    """(R,) float32 accept uniforms of rows (chain, iteration)."""
    key = splitmix64(seed)
    ch = torch.as_tensor(chains, dtype=torch.int64, device=device)
    it = torch.as_tensor(iterations, dtype=torch.int64, device=device) & M32
    zero = torch.zeros_like(ch)
    return _unit(philox((zero, ch, it, torch.ones_like(ch)), key)[0])


def lengths(seed, chunk, chunk_size, lmin, lmax):
    """The trajectory lengths of chunk ``chunk``: (chunk_size,), one an
    iteration shared by all chains."""
    lo, hi = splitmix64((int(seed) << 32) + int(chunk))
    gen = torch.Generator().manual_seed(((hi << 32) | lo) & ((1 << 63) - 1))
    return torch.randint(lmin, lmax + 1, (chunk_size,), generator=gen)
