"""Payload compression: the bf16 wire and the int8 K/V cache rows.

* :func:`compress_bf16` — f32 -> bf16, round to nearest even
* :func:`decompress_bf16` — bf16 -> f32, exact (bf16 embeds into f32)
* :func:`quantize_int8` — (R, W) f32/bf16 rows -> int8 codes + f32 scale
  per row, W <= 256
* :func:`quantize_int8_into` — one step's K and V rows quantized straight
  into the int8 rings and their scales, in place, in one launch, with a
  start position and a token count per batch row, wrapping around the
  ring (the fixed-batch decode step and the continuous-batching engine's
  slots)
* :func:`dequantize_int8` — codes * scale, as f32 or bf16

For a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/quantize.cu`` (the port of the Pallas ``_cast_kernel``,
``_quant_kernel`` and ``_dequant_kernel`` in ``repro/kernels/quantize.py``)
on the current stream, and counts the launch in its ``launches`` attribute.
For a CPU tensor it runs the plain version in :mod:`repro_torch.kernels.ref`.
Inputs are contiguous, except that the fused write takes strided sources
and rings. The Pallas int8 kernels fix the row at 128 lanes; the port's
take the width from the input, so the K/V cache's rows of ``head_dim``
values (64 for MiniCPM-2B) go through them as they are.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["MAX_WIDTH", "PLAN_ROWS", "compress_bf16", "decompress_bf16",
           "quantize_int8", "quantize_int8_into", "dequantize_int8"]

MAX_WIDTH = 256                      # quantize_int8: one warp, 8 per lane
# rows whose positions and counts travel in the kernel's parameter block
# (kPlanRows in csrc/quantize.cu); more go as a device array
PLAN_ROWS = 256
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "q_compress_bf16": ([_P, _P, _LL, _P], _I),
    "q_decompress_bf16": ([_P, _P, _LL, _P], _I),
    "q_quantize_int8": ([_I, _P, _P, _P, _LL, _I, _P], _I),
    "q_quantize_int8_into": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
                             _I),
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


_FNS: dict = {}                      # entry name -> its ctypes function


def _fn(name: str):
    """The library's entry ``name``, loaded (and built) at the first call."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("quantize", _SIGNATURES), name)
    return fn


def _launch(fn: str, x: torch.Tensor, *args) -> None:
    """Call ``fn`` with ``args`` and the current stream of ``x``'s card,
    switching the current device only when ``x`` lies on another."""
    f, dev = _fn(fn), x.device
    if dev.index == torch.cuda.current_device():
        rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({_fn('q_error_string')(rc).decode()})")


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


def quantize_int8_into(k: torch.Tensor, v: torch.Tensor,
                       k_ring: torch.Tensor, v_ring: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       pos, n) -> None:
    """One step's K/V cache write, in place: ``k`` and ``v`` (B, T, KV, W)
    f32 or bf16, W <= :data:`MAX_WIDTH`, are quantized row by row as
    :func:`quantize_int8` does, and token ``t`` of batch row ``b`` lands in
    the int8 rings ``k_ring``/``v_ring`` (B, S, KV, W) at ring position
    ``(pos[b] + t) % S``, its scale in ``k_scale``/``v_scale`` (B, S, KV,
    1) f32, only while ``t < n[b]``: a prefill chunk's pad tokens and an
    inactive slot (``n[b] = 0``) write nothing, and nothing old is written
    back. The fixed-batch decode step is the case ``pos[b] = slot``,
    ``n[b] = T``. ``pos`` and ``n`` are B host integers (a sequence or a
    CPU tensor), ``pos[b] >= 0`` and ``0 <= n[b] <= min(T, S)``. On the
    card one launch does K and V from the sources', rings' and scales'
    strides (each row's W values contiguous); up to :data:`PLAN_ROWS`
    rows' positions and counts ride in its parameter block, more in a
    device array."""
    if k.dim() != 4 or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"quantize_int8_into takes K and V of one (B, T, KV,"
                         f" W) shape and dtype, got {tuple(k.shape)} "
                         f"{k.dtype} and {tuple(v.shape)} {v.dtype}")
    if k.dtype not in _FLOAT_CODE:
        raise TypeError(f"quantize_int8_into takes {tuple(_FLOAT_CODE)}, got "
                        f"{k.dtype}")
    B, T, KV, W = k.shape
    if W > MAX_WIDTH:
        raise ValueError(f"quantize_int8_into takes rows of at most "
                         f"{MAX_WIDTH} values, got {W}")
    S = k_ring.shape[1] if k_ring.dim() == 4 else -1
    for name, t, shape, dt in (
            ("k_ring", k_ring, (B, S, KV, W), torch.int8),
            ("v_ring", v_ring, (B, S, KV, W), torch.int8),
            ("k_scale", k_scale, (B, S, KV, 1), torch.float32),
            ("v_scale", v_scale, (B, S, KV, 1), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != k.device:
            raise ValueError(f"{name} must be {shape} {dt} on {k.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if v.device != k.device or k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_int8_into runs on cpu or cuda, got "
                         f"{k.device} and {v.device}")
    pos = [int(p) for p in pos]
    n = [int(c) for c in n]
    if len(pos) != B or len(n) != B:
        raise ValueError(f"quantize_int8_into takes {B} positions and "
                         f"counts, got {len(pos)} and {len(n)}")
    if any(p < 0 for p in pos) or any(not 0 <= c <= min(T, S) for c in n):
        raise ValueError(f"positions must be >= 0 and counts in [0, "
                         f"{min(T, S)}], got {pos} and {n}")
    if k.device.type == "cpu":
        ref.quantize_int8_into_ref(k, v, k_ring, v_ring, k_scale, v_scale,
                                   pos, n)
        return
    if k.stride(-1) != 1 or v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    if k_ring.stride(-1) != 1 or v_ring.stride() != k_ring.stride() or \
            v_scale.stride() != k_scale.stride():
        raise ValueError("the rings must share their strides, each row "
                         "contiguous, and so must the scale arrays")
    if not any(n) or W == 0 or KV == 0:
        return
    geo = (ctypes.c_longlong * 14)(B, T, KV, W, S, *k.stride()[:3],
                                   *k_ring.stride()[:3],
                                   *k_scale.stride()[:3])
    words = [p % S for p in pos] + n
    plan, dplan = None, None
    if B <= PLAN_ROWS:
        plan = (ctypes.c_int * (2 * B))(*words)
    else:
        dplan = torch.tensor(words, dtype=torch.int32).pin_memory().to(
            k.device, non_blocking=True)
    _launch("q_quantize_int8_into", k, _FLOAT_CODE[k.dtype], k.data_ptr(),
            v.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), geo, plan,
            None if dplan is None else dplan.data_ptr())
    quantize_int8_into.launches += 1


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
quantize_int8_into.launches = 0
dequantize_int8.launches = 0
