"""K/V-cache entry points for the int8 kernels, at any row width.

The port of ``repro.kernels.ops.kv_quantize`` / ``kv_dequantize``
(ops.py:43, 52), which reshape a ``(..., 128)`` tensor into the Pallas
kernels' rows. Here the last dim is the row, whatever its width (the cache's
``head_dim``). The model's decode step writes a token's K and V through
:func:`kv_quantize_write` (the reference's ``quantize_kv_rows`` and two
``dynamic_update_slice`` each for K and V, in one launch) and reads the
ring through :func:`kv_dequantize`. Each resolves
:mod:`repro_torch.kernels.quantize`'s wrapper when it is called, so a
caller that swaps the wrapper for the plain version (``chip_smoke.py``
does, to hold the decode path against it) swaps it here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import quantize

__all__ = ["kv_quantize", "kv_quantize_write", "kv_dequantize"]


def kv_quantize(x: torch.Tensor):
    """(..., W) f32/bf16 -> (q (..., W) int8, scale (..., 1) f32)."""
    lead, width = x.shape[:-1], x.shape[-1]
    q, s = quantize.quantize_int8(x.contiguous().view(-1, width))
    return q.view(*lead, width), s.view(*lead, 1)


def kv_quantize_write(k: torch.Tensor, v: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, scale_k: torch.Tensor,
                      scale_v: torch.Tensor, slot: int) -> None:
    """K and V (B, T, KV, W) quantized into the int8 rings (B, S, KV, W) and
    their f32 scales (B, S, KV, 1) at ``slot``, in place."""
    quantize.quantize_int8_into(k, v, cache_k, cache_v, scale_k, scale_v,
                                slot)


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """(..., W) int8 codes and (..., 1) f32 scales -> (..., W) ``dtype``."""
    lead, width = q.shape[:-1], q.shape[-1]
    out = quantize.dequantize_int8(q.contiguous().view(-1, width),
                                   s.contiguous().view(-1, 1), dtype)
    return out.view(*lead, width)
