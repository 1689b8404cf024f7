"""Blockwise elementwise combine for the pipelined allreduce.

The compute hot spot of the paper's algorithm is the blockwise reduction
``Y[j] <- t (.) Y[j]`` (``MPI_Reduce_local`` in the paper's MPI sketch). The
tree engine folds both child partials and the local block in one pass:

* :func:`combine2` — ``op(a, b)``
* :func:`combine3` — ``op(op(a, b), c)``, one memory pass instead of two

For a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/block_combine.cu`` (the port of the Pallas kernels in
``repro/kernels/block_combine.py``) on the current stream, and counts the
launch in its ``launches`` attribute. For a CPU tensor it runs the plain
version in :mod:`repro_torch.kernels.ref`. Operands are contiguous tensors of
one shape, dtype and device; the kernel treats them as flat vectors, so the
engine hands it a whole ``(p, blk)`` slab of stacked ranks in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

__all__ = ["OPS", "DTYPES", "combine2", "combine3"]

OPS = ("add", "max", "min", "mul")
_OP_CODE = {name: code for code, name in enumerate(OPS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
DTYPES = tuple(_DTYPE_CODE)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "bc_combine2": ([_I, _I, _P, _P, _P, _LL, _P], _I),
    "bc_combine3": ([_I, _I, _P, _P, _P, _P, _LL, _P], _I),
    "bc_error_string": ([_I], ctypes.c_char_p),
}


def _check(op: str, *xs: torch.Tensor) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"unknown op {op!r}; want one of {OPS}")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("combine operands differ in shape, dtype or "
                             f"device: {[(t.shape, t.dtype, t.device) for t in xs]}")
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(f"combine takes {DTYPES}, got {x0.dtype}")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"combine runs on cpu or cuda, got {x0.device}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("combine operands must be contiguous")


def _launch(fn: str, op: str, xs: tuple, out: torch.Tensor) -> None:
    lib = _build.load("block_combine", _SIGNATURES)
    x0 = xs[0]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = getattr(lib, fn)(_OP_CODE[op], _DTYPE_CODE[x0.dtype],
                              *[x.data_ptr() for x in xs], out.data_ptr(),
                              out.numel(), stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.bc_error_string(rc).decode()})")


def combine2(a: torch.Tensor, b: torch.Tensor, *,
             op: str = "add") -> torch.Tensor:
    """``op(a, b)`` elementwise, one kernel launch on a CUDA tensor."""
    _check(op, a, b)
    if a.device.type == "cpu":
        return ref.combine2_ref(a, b, op=op)
    out = torch.empty_like(a)
    if out.numel():
        _launch("bc_combine2", op, (a, b), out)
        combine2.launches += 1
    return out


def combine3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
             op: str = "add") -> torch.Tensor:
    """Fused ``op(op(a, b), c)`` elementwise, the intermediate rounded to the
    operand type; one kernel launch (one memory pass) on a CUDA tensor."""
    _check(op, a, b, c)
    if a.device.type == "cpu":
        return ref.combine3_ref(a, b, c, op=op)
    out = torch.empty_like(a)
    if out.numel():
        _launch("bc_combine3", op, (a, b, c), out)
        combine3.launches += 1
    return out


combine2.launches = 0
combine3.launches = 0
