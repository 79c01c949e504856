"""Threefry-2x32 counter-based random bits, as pure functions of tensors.

The keyed sampler draws every token from a key that is a function of the
request's ``(seed, rid, position)`` alone.  The JAX package derives those
keys and draws with ``jax.random`` under its default PRNG, threefry2x32 with
``jax_threefry_partitionable`` on.  This module computes the same hash on
torch tensors, so the port's draws are bit-equal to the JAX package's:

- ``prng_key(seed)`` is the pair ``(0, seed)`` (a uint32 seed);
- ``fold_in(key, d)`` is ``threefry(key, (0, d))``;
- ``random_bits(key, n)`` is ``a ^ b`` of ``threefry(key, (0, i))`` for
  ``i = 0 .. n-1`` (the 32-bit draw over a flat ``n``-element shape);
- ``uniform(key, n)`` puts the top 23 bits in a float32 mantissa in
  ``[1, 2)``, subtracts 1 and lifts 0 to the smallest normal float32.

torch's ``uint32`` has no CUDA arithmetic, so every 32-bit word lives in an
``int64`` tensor and each add or shift is masked back to 32 bits.  There is
no generator state: the same keys give the same bits on any device.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
#: the key-schedule parity constant of Threefry (Salmon et al., 2011)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the smallest normal float32: JAX's uniform lifts an exact 0 to it
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    under the key ``(k0, k1)``; all int64 tensors of 32-bit words that
    broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed) -> tuple[torch.Tensor, torch.Tensor]:
    """The key of a uint32 ``seed`` (an int64 tensor of any shape)."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & MASK32
    return torch.zeros_like(seed), seed


def fold_in(key, data) -> tuple[torch.Tensor, torch.Tensor]:
    """A new key from ``key`` and the 32-bit word ``data`` (broadcast)."""
    k0, k1 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k0.device) & MASK32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(key, n: int) -> torch.Tensor:
    """``[..., n]`` 32-bit words drawn from the keys ``key`` (each word of
    the pair shaped ``[...]``)."""
    k0, k1 = (k[..., None] for k in key)
    count = torch.arange(n, dtype=torch.int64, device=k0.device)
    a, b = threefry2x32(k0, k1, torch.zeros_like(count), count)
    return a ^ b


def uniform(key, n: int) -> torch.Tensor:
    """``[..., n]`` float32 draws in ``[tiny, 1)`` from ``random_bits``."""
    mantissa = (random_bits(key, n) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats * (1.0 - F32_TINY) + F32_TINY, min=F32_TINY)
