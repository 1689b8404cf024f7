"""Plain PyTorch versions of the port's kernels (the bit-equality targets).

Each wrapper in :mod:`repro_torch.kernels.block_combine` and
:mod:`repro_torch.kernels.quantize` runs these for a tensor on the CPU;
``chip_smoke.py`` and the GPU tests hold each CUDA kernel against them on the
card. Two-op combines round the intermediate to the operand type, as the
reference's jnp oracles do.
"""

from __future__ import annotations

import torch

__all__ = ["OPS", "combine2_ref", "combine3_ref", "compress_bf16_ref",
           "decompress_bf16_ref"]

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
