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
_DEVICES = ("cpu", "cuda")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "bc_combine2": ([_I, _I, _P, _P, _P, _LL, _P], _I),
    "bc_combine3": ([_I, _I, _P, _P, _P, _P, _LL, _P], _I),
    "bc_error_string": ([_I], ctypes.c_char_p),
}


def _check(op: str, xs: tuple) -> None:
    """Raise unless ``xs`` are contiguous operands of one shape, dtype and
    device that the kernel takes. The common path compares each operand's
    shape, dtype and device once; the messages are built only on failure."""
    x0 = xs[0]
    shape, dtype, dev = x0.shape, x0.dtype, x0.device
    ok = op in _OP_CODE and dtype in _DTYPE_CODE and dev.type in _DEVICES
    for x in xs:
        ok = ok and x.shape == shape and x.dtype == dtype and \
            x.device == dev and x.is_contiguous()
    if not ok:
        _raise(op, xs)


def _raise(op: str, xs: tuple) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"unknown op {op!r}; want one of {OPS}")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("combine operands differ in shape, dtype or "
                             f"device: {[(t.shape, t.dtype, t.device) for t in xs]}")
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(f"combine takes {DTYPES}, got {x0.dtype}")
    if x0.device.type not in _DEVICES:
        raise ValueError(f"combine runs on cpu or cuda, got {x0.device}")
    raise ValueError("combine operands must be contiguous")


_FNS: dict = {}                      # entry name -> its ctypes function


def _fn(name: str):
    """The library's entry ``name``; the first call loads (and builds) the
    library and keeps every entry, so later calls take no lock."""
    fn = _FNS.get(name)
    if fn is None:
        lib = _build.load("block_combine", _SIGNATURES)
        _FNS.update({k: getattr(lib, k) for k in _SIGNATURES})
        fn = _FNS[name]
    return fn


def _launch(fn: str, op: str, xs: tuple, out: torch.Tensor) -> None:
    """Call ``fn`` on the current stream of ``out``'s card, switching the
    current device only when ``out`` lies on another. The stream comes from
    ``_cuda_getCurrentRawStream``, the call PyTorch's own generated kernels
    make: ``torch.cuda.current_stream`` builds a ``Stream`` object first and
    took 4.1 µs a call on the card against its 0.14 (PERF.md)."""
    f, dev = _fn(fn), out.device
    args = (_OP_CODE[op], _DTYPE_CODE[out.dtype],
            *[x.data_ptr() for x in xs], out.data_ptr(), out.numel())
    if dev.index == torch.cuda.current_device():
        rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = f(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({_fn('bc_error_string')(rc).decode()})")


def combine2(a: torch.Tensor, b: torch.Tensor, *,
             op: str = "add") -> torch.Tensor:
    """``op(a, b)`` elementwise, one kernel launch on a CUDA tensor."""
    _check(op, (a, b))
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
    _check(op, (a, b, c))
    if a.device.type == "cpu":
        return ref.combine3_ref(a, b, c, op=op)
    out = torch.empty_like(a)
    if out.numel():
        _launch("bc_combine3", op, (a, b, c), out)
        combine3.launches += 1
    return out


combine2.launches = 0
combine3.launches = 0
