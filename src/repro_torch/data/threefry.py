"""JAX's threefry2x32 PRNG in torch integer ops, bit for bit.

The reference's data stream (``repro/data/pipeline.py``) and its samplers
draw from ``jax.random`` with its default threefry keys. To give the same
batches, the port computes the same hash. Keys are ``(2,)`` int64 tensors
holding two uint32 words (torch's uint32 has too few ops); every word stays
in ``[0, 2**32)``, and sums and shifts are masked back into it.

This is the form JAX uses with ``jax_threefry_partitionable=True`` (the
default from jax 0.5): ``split`` and the random bits hash the 64-bit
row-major index of each output, its high and low words as the two counters,
and 32-bit draws are the XOR of the two hashed words. ``fold_in`` hashes the
counter pair ``(0, data)``, the same under either setting.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``x0``, ``x1``
    (int64 tensors of uint32 values, one shape) under ``key``; returns the
    two hashed words, as ``jax.random``'s ``threefry2x32_p``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([seed >> 32, seed & _M], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data)."""
    c = torch.tensor([0, int(data) & _M], dtype=torch.int64,
                     device=key.device)
    y0, y1 = threefry2x32(key, c[:1], c[1:])
    return torch.cat([y0, y1])


def _iota_words(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    hi, lo = _iota_words(num, key.device)
    y0, y1 = threefry2x32(key, hi, lo)
    return torch.stack([y0, y1], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32), as
    ``jax.random.bits(key, shape, jnp.uint32)``."""
    n = 1
    for d in shape:
        n *= int(d)
    hi, lo = _iota_words(n, key.device)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).view(tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1) from the top 23
    random bits as the mantissa of a number in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
