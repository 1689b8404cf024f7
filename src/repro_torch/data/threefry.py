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
counter pair ``(0, data)``, the same under either setting. Since each
element hashes its own index, a draw can be made in pieces of the flat
index (``start``/``stop``) with the same bits as the whole.

:func:`normal` is ``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)``
with ``u`` uniform in ``(-1, 1)``, and ``erf_inv`` as XLA compiles it for
the CPU: Giles' single-precision polynomial over ``w = -log1p(-u*u)``,
with XLA's own ``log1p`` (a Cephes rational near 0, ``log(1 + x)`` beyond),
``log`` (Cephes' polynomial on the mantissa) and ``sqrt`` (one corrected
step from the reciprocal root), each multiply-add that XLA fuses taken as
one rounding (an f64 product and sum, rounded to f32). Every step is an
IEEE operation, so the CPU and CUDA give the same bits; against jax 0.9 on
the CPU they agree bit for bit (``tests/test_torch_init.py``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "normal"]

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


def _iota_words(n: int, device, start: int = 0):
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return i >> 32, i & _M


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    hi, lo = _iota_words(num, key.device)
    y0, y1 = threefry2x32(key, hi, lo)
    return torch.stack([y0, y1], dim=1)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _flat_bits(key: torch.Tensor, start: int, stop: int,
               device=None) -> torch.Tensor:
    """The 32-bit draws of flat indices ``[start, stop)``, 1-D, on
    ``device`` (default the key's)."""
    device = key.device if device is None else device
    hi, lo = _iota_words(stop - start, device, start)
    y0, y1 = threefry2x32(key, hi, lo)
    return y0 ^ y1


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 holding uint32), as
    ``jax.random.bits(key, shape, jnp.uint32)``."""
    return _flat_bits(key, 0, _numel(shape)).view(tuple(shape))


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1): the top 23 bits as the mantissa of [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1)."""
    return _unit(random_bits(key, shape))


# ------------------------------------------------------------------ normal

# Giles' single-precision erf_inv coefficients (XLA's ErfInv32), for
# w = -log1p(-x*x) below 5 (in w - 2.5) and from 5 on (in sqrt(w) - 3)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x) (Cephes),
# highest degree first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's log: Cephes' polynomial on the mantissa m - 1, m in [sqrt(1/2),
# sqrt(2)), plus the exponent times log(2) in two parts
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# jax.random.normal's uniform: [nextafter(-1, 0), 1) in f32
_NEAR_MINUS_ONE = -0.99999994


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding to f32 (a fused multiply-add): the f32
    product is exact in f64, and the f64 sum rounds to the f32 result."""
    return (a.double() * b.double() + c.double()).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log for x > 0."""
    x = torch.clamp_min(x, 1.17549435e-38)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    below = m < _f32(0.707106781186547524, m)
    m = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.float()
    x2 = m * m
    x3 = x2 * m
    c = [_f32(v, m) for v in _LOG_P]
    y = _fma(_fma(m, c[0], c[1]), m, c[2])
    y1 = _fma(_fma(m, c[3], c[4]), m, c[5])
    y2 = _fma(_fma(m, c[6], c[7]), m, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1, m) * e)
    m = _fma(_f32(-0.5, m), x2, m) + y
    return _fma(_f32(_LOG_Q2, m), e, m)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c, x))
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p for x > -1."""
    x2 = x * x
    small = x + (-0.5 * x2 + x * x2 * (_horner(x, _LOG1P_P)
                                        / _horner(x, _LOG1P_Q)))
    return torch.where(x.abs() < _f32(0.41421356237309504880, x), small,
                       _log(1.0 + x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 sqrt for x > 0: s = x r from the reciprocal root r, then
    s + r (x - s s) / 2 rounded once."""
    r = (1.0 / torch.sqrt(x.double())).float()
    s = x * r
    s, r, xd = s.double(), r.double(), x.double()
    return (s + 0.5 * r * (xd - s * s)).float()


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv for |x| < 1."""
    w = -_log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, _sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, _f32(a, x), _f32(b, x))
        p = c if p is None else _fma(p, w, c)
    return p * x


def normal(key: torch.Tensor, shape, start: int = 0,
           stop: int | None = None, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32, or its flat elements
    ``[start, stop)`` as a 1-D tensor (any piece has the whole's bits),
    drawn on ``device`` (default the key's)."""
    n = _numel(shape)
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"[{start}, {stop}) is not a range of {n} elements")
    bits = _flat_bits(key, start, stop, device)
    lo = _f32(_NEAR_MINUS_ONE, bits)
    u = torch.maximum(lo, _unit(bits) * (_f32(1.0, bits) - lo) + lo)
    z = _f32(math.sqrt(2.0), u) * _erf_inv(u)
    return z.view(tuple(shape)) if (start, stop) == (0, n) else z
