"""bf16 wire compression for the hierarchical allreduce's slow stage.

* :func:`compress_bf16` — f32 -> bf16, round to nearest even
* :func:`decompress_bf16` — bf16 -> f32, exact (bf16 embeds into f32)

For a CUDA tensor each wrapper launches the hand-written cast kernel in
``csrc/quantize.cu`` (the port of the Pallas ``_cast_kernel`` in
``repro/kernels/quantize.py``) on the current stream, and counts the launch in
its ``launches`` attribute. For a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.ref`. Inputs are contiguous, of any shape.

The reference module also holds the int8 (de)quantization kernels of the K/V
cache; they are not on the collective path and are ported with the models.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["compress_bf16", "decompress_bf16"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "q_compress_bf16": ([_P, _P, _LL, _P], _I),
    "q_decompress_bf16": ([_P, _P, _LL, _P], _I),
    "q_error_string": ([_I], ctypes.c_char_p),
}


def _check(x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cast runs on cpu or cuda, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("cast input must be contiguous")


def _launch(fn: str, x: torch.Tensor, out: torch.Tensor) -> None:
    lib = _build.load("quantize", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.q_error_string(rc).decode()})")


def compress_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 wire compression, bit-identical to
    ``x.to(torch.bfloat16)`` on the same device."""
    _check(x, torch.float32)
    if x.device.type == "cpu":
        return ref.compress_bf16_ref(x)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if out.numel():
        _launch("q_compress_bf16", x, out)
        compress_bf16.launches += 1
    return out


def decompress_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 wire decompression; exact."""
    _check(x, torch.bfloat16)
    if x.device.type == "cpu":
        return ref.decompress_bf16_ref(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("q_decompress_bf16", x, out)
        decompress_bf16.launches += 1
    return out


compress_bf16.launches = 0
decompress_bf16.launches = 0
