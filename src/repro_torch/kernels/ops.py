"""K/V-cache entry points for the int8 kernels, at any row width.

The port of ``repro.kernels.ops.kv_quantize`` / ``kv_dequantize``
(ops.py:43, 52), which reshape a ``(..., 128)`` tensor into the Pallas
kernels' rows. Here the last dim is the row, whatever its width (the cache's
``head_dim``), so the model's ``quantize_kv_rows`` and ``_cache_read`` call
these directly. Each resolves :mod:`repro_torch.kernels.quantize`'s wrapper
when it is called, so a caller that swaps the wrapper for the plain version
(``chip_smoke.py`` does, to hold the decode path against it) swaps it here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import quantize

__all__ = ["kv_quantize", "kv_dequantize"]


def kv_quantize(x: torch.Tensor):
    """(..., W) f32/bf16 -> (q (..., W) int8, scale (..., 1) f32)."""
    lead, width = x.shape[:-1], x.shape[-1]
    q, s = quantize.quantize_int8(x.contiguous().view(-1, width))
    return q.view(*lead, width), s.view(*lead, 1)


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """(..., W) int8 codes and (..., 1) f32 scales -> (..., W) ``dtype``."""
    lead, width = q.shape[:-1], q.shape[-1]
    out = quantize.dequantize_int8(q.contiguous().view(-1, width),
                                   s.contiguous().view(-1, 1), dtype)
    return out.view(*lead, width)
