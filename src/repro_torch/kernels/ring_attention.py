"""Attention of a call's queries over each batch row's K/V ring, the same
bits for a query in any call (the serving engine's slot decode ticks,
prefill chunks and speculative verify calls).

For a CUDA tensor :func:`ring_attention` launches the hand-written kernel in
``csrc/ring_attention.cu`` on the current stream and counts the launch in
its ``launches`` attribute; for a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.ring_attention_ref`. The kernel replaces no
TPU kernel: the reference attends over its ring with two XLA einsums, as the
plain version does, and on the card those einsums round a query's output
by the shape of the call it is in (see the source).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = ["MAX_HEAD_DIM", "ring_attention"]

MAX_HEAD_DIM = 256
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ra_forward": ([_I, _P, _P, _P, _P, _P, _P, _F, _P], _I),
    "ra_error_string": ([_I], ctypes.c_char_p),
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("ring_attention", _SIGNATURES),
                                  name)
    return fn


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   plan: torch.Tensor, window: int | None = None,
                   chunk: int | None = None) -> torch.Tensor:
    """Each query's attention over its row's ring.

    q (B, T, H, D) and the rings k, v (B, S, KV, D), contiguous, of one
    dtype (f32 or bf16), H a multiple of KV, D <= :data:`MAX_HEAD_DIM`;
    ``plan`` (2, B) int64 on q's device: row b's call starts at position
    ``plan[0, b]`` and has written ``plan[1, b]`` tokens, so slot s holds
    position ``last - ((last - s) mod S)``, ``last = pos + n - 1``. Query t
    sits at ``pos + t`` and attends causally to the positions its ring
    holds, within ``window`` and its ``chunk`` where those are set.
    Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"ring_attention takes q (B, T, H, D) and rings "
                         f"(B, S, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _FLOAT_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"ring_attention takes f32 or bf16 of one dtype, "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if plan.shape != (2, B) or plan.dtype != torch.int64:
        raise ValueError(f"plan must be (2, {B}) int64, got "
                         f"{tuple(plan.shape)} {plan.dtype}")
    if any(t.device != q.device for t in (k, v, plan)) or \
            q.device.type not in ("cpu", "cuda"):
        raise ValueError("ring_attention's tensors must lie on one cpu or "
                         "cuda device")
    if q.device.type == "cpu":
        return ref.ring_attention_ref(q, k, v, plan, window, chunk)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"ring_attention takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {D}")
    if not all(t.is_contiguous() for t in (q, k, v, plan)):
        raise ValueError("ring_attention's tensors must be contiguous")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    geo = (ctypes.c_longlong * 8)(B, T, H, k.shape[2], D, k.shape[1],
                                  window or 0, chunk or 0)
    f, dev = _fn("ra_forward"), q.device
    args = (_FLOAT_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), geo, plan.data_ptr(), math.sqrt(D))
    if dev.index == torch.cuda.current_device():
        rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ring_attention launch failed: CUDA error {rc} "
                           f"({_fn('ra_error_string')(rc).decode()})")
    ring_attention.launches += 1
    return out


ring_attention.launches = 0
