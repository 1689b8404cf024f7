"""Plain PyTorch versions of the port's kernels (the bit-equality targets).

Each wrapper in :mod:`repro_torch.kernels.block_combine` and
:mod:`repro_torch.kernels.quantize` runs these for a tensor on the CPU;
``chip_smoke.py`` and the GPU tests hold each CUDA kernel against them on the
card. Two-op combines round the intermediate to the operand type, as the
reference's jnp oracles do.

The int8 scale is ``max(absmax, 1e-8) * f32(1/127)``: under ``jit`` (the
reference's decode step) and in the Pallas kernel XLA folds the reference's
``/ 127.0`` into that product, so this is the scale its K/V cache holds
(an eager ``jnp`` call divides instead, and differs by one ulp in a few
percent of rows).
"""

from __future__ import annotations

import torch

__all__ = ["OPS", "INV127", "combine2_ref", "combine3_ref",
           "compress_bf16_ref", "decompress_bf16_ref", "quantize_int8_ref",
           "dequantize_int8_ref"]

# f32(1/127) (bits 0x3c010204), exact as a Python float
INV127 = 0.007874015718698502

OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum,
       "mul": torch.mul}


def combine2_ref(a: torch.Tensor, b: torch.Tensor, *,
                 op: str = "add") -> torch.Tensor:
    return OPS[op](a, b)


def combine3_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                 op: str = "add") -> torch.Tensor:
    f = OPS[op]
    return f(f(a, b), c)


def compress_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def decompress_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def quantize_int8_ref(x: torch.Tensor):
    """(R, W) f32/bf16 -> (q (R, W) int8, scale (R, 1) f32)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(-1, keepdim=True).clamp_min(1e-8) * INV127
    # tensor / tensor: on the card a division by a Python scalar would be
    # computed as a product with its reciprocal
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
