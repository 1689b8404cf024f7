"""Payload compression: the bf16 wire and the int8 K/V cache rows.

* :func:`compress_bf16` — f32 -> bf16, round to nearest even
* :func:`decompress_bf16` — bf16 -> f32, exact (bf16 embeds into f32)
* :func:`quantize_int8` — (R, W) f32/bf16 rows -> int8 codes + f32 scale
  per row, W <= 256
* :func:`dequantize_int8` — codes * scale, as f32 or bf16

For a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/quantize.cu`` (the port of the Pallas ``_cast_kernel``,
``_quant_kernel`` and ``_dequant_kernel`` in ``repro/kernels/quantize.py``)
on the current stream, and counts the launch in its ``launches`` attribute.
For a CPU tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
Inputs are contiguous. The Pallas int8 kernels fix the row at 128 lanes; the
port's take the width from the input, so the K/V cache's rows of
``head_dim`` values (64 for MiniCPM-2B) go through them as they are.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["MAX_WIDTH", "compress_bf16", "decompress_bf16", "quantize_int8",
           "dequantize_int8"]

MAX_WIDTH = 256                      # quantize_int8: one warp, 8 per lane
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "q_compress_bf16": ([_P, _P, _LL, _P], _I),
    "q_decompress_bf16": ([_P, _P, _LL, _P], _I),
    "q_quantize_int8": ([_I, _P, _P, _P, _LL, _I, _P], _I),
    "q_dequantize_int8": ([_I, _P, _P, _P, _LL, _I, _P], _I),
    "q_error_string": ([_I], ctypes.c_char_p),
}


def _check(x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cast runs on cpu or cuda, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("cast input must be contiguous")


def _launch(fn: str, x: torch.Tensor, *args) -> None:
    """Call ``fn`` with ``args`` and the current stream of ``x``'s card."""
    lib = _build.load("quantize", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
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
        _launch("q_compress_bf16", x, x.data_ptr(), out.data_ptr(),
                x.numel())
        compress_bf16.launches += 1
    return out


def decompress_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 wire decompression; exact."""
    _check(x, torch.bfloat16)
    if x.device.type == "cpu":
        return ref.decompress_bf16_ref(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        _launch("q_decompress_bf16", x, x.data_ptr(), out.data_ptr(),
                x.numel())
        decompress_bf16.launches += 1
    return out


def _check_rows(x: torch.Tensor, dtypes, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what} takes (rows, width), got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what} takes {tuple(dtypes)}, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} input must be contiguous")


def quantize_int8(x: torch.Tensor):
    """Symmetric int8 per-row quantization of (R, W) f32 or bf16 rows,
    W <= :data:`MAX_WIDTH`: ``scale = max(absmax, 1e-8) * f32(1/127)``
    (the reference's ``/ 127.0`` as XLA compiles it) and
    ``q = clamp(round_half_even(x / scale), -127, 127)``. Returns
    ``(q (R, W) int8, scale (R, 1) f32)``."""
    _check_rows(x, _FLOAT_CODE, "quantize_int8")
    rows, width = x.shape
    if width > MAX_WIDTH:
        raise ValueError(f"quantize_int8 takes rows of at most {MAX_WIDTH} "
                         f"values, got {width}")
    if x.device.type == "cpu":
        return ref.quantize_int8_ref(x)
    q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if q.numel():
        _launch("q_quantize_int8", x, _FLOAT_CODE[x.dtype], x.data_ptr(),
                q.data_ptr(), scale.data_ptr(), rows, width)
        quantize_int8.launches += 1
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``(q * scale)`` in f32, then
    rounded to ``dtype`` (f32 or bf16). ``q`` is (R, W) int8 and ``scale``
    (R, 1) f32, on one device."""
    _check_rows(q, (torch.int8,), "dequantize_int8")
    _check_rows(scale, (torch.float32,), "dequantize_int8 scale")
    if scale.shape != (q.shape[0], 1) or scale.device != q.device:
        raise ValueError(f"scale must be ({q.shape[0]}, 1) on {q.device}, "
                         f"got {tuple(scale.shape)} on {scale.device}")
    if dtype not in _FLOAT_CODE:
        raise TypeError(f"dequantize_int8 writes {tuple(_FLOAT_CODE)}, "
                        f"got {dtype}")
    if q.device.type == "cpu":
        return ref.dequantize_int8_ref(q, scale, dtype)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if out.numel():
        _launch("q_dequantize_int8", q, _FLOAT_CODE[dtype], q.data_ptr(),
                scale.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1])
        dequantize_int8.launches += 1
    return out


compress_bf16.launches = 0
decompress_bf16.launches = 0
quantize_int8.launches = 0
dequantize_int8.launches = 0
