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

:func:`route` picks the kernel's route from the dtype, the head dim and the
ring's length alone: bf16 at an even head dim up to 128 takes the
tensor-core kernel (its K and V blocks by TMA where the head dim is 64 or
128 and the ring a whole number of key blocks, else by ``cp.async``), and
everything else the CUDA-core kernel. :func:`query_range` gives each
query's positions, :func:`work` counts the bytes and operations a call
needs, for its bound, and :func:`same_bits_pairs` makes the calls that the
kernel's contract (a query's same bits in any call) holds equal.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = ["KEY_BLOCK", "MAX_HEAD_DIM", "ROUTES", "query_range",
           "ring_attention", "route", "same_bits_pairs", "valid", "work"]

MAX_HEAD_DIM = 256
KEY_BLOCK = 64          # the tensor-core kernel's key block, in positions
ROUTES = ("cuda_cores", "wgmma_tma", "wgmma_cp_async")   # the kernel's codes
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ra_forward": ([_I, _I, _P, _P, _P, _P, _P, _P, _F, _P], _I),
    "ra_error_string": ([_I], ctypes.c_char_p),
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("ring_attention", _SIGNATURES),
                                  name)
    return fn


def route(dtype: torch.dtype, head_dim: int, ring: int) -> str:
    """The kernel's route for a call: the dtype, the head dim and the
    ring's length S decide it, never the call's T, B or plan (so a query
    takes the same route, and keeps its bits, in any call)."""
    if dtype != torch.bfloat16 or head_dim > 128 or head_dim % 2:
        return "cuda_cores"
    if head_dim in (64, 128) and ring % KEY_BLOCK == 0:
        return "wgmma_tma"
    return "wgmma_cp_async"


def query_range(plan, T: int, S: int, window: int | None = None,
                chunk: int | None = None) -> tuple:
    """(lo, hi), each (B, T) int64 on the CPU: query t of row b reads the
    positions lo <= j <= hi, none where hi < lo (the plain version's mask,
    and the kernel's ``query_range``). ``plan`` (2, B) as the kernel takes
    it (any device, or nested lists)."""
    plan = torch.as_tensor(plan, dtype=torch.int64).cpu()
    pos, n = plan[0], plan[1]
    qp = pos[:, None] + torch.arange(T)[None]
    last = (pos + n - 1)[:, None]
    lo = torch.clamp(last - S + 1, min=0).expand_as(qp)
    if window:
        lo = torch.maximum(lo, qp - window + 1)
    if chunk:
        lo = torch.maximum(lo, qp // chunk * chunk)
    return lo, torch.minimum(qp, last)


def valid(plan, T: int, S: int, window: int | None = None,
          chunk: int | None = None) -> torch.Tensor:
    """(B, T) bools on the CPU: the queries that have a position to read
    (the kernel writes zeros for the others, the plain version averages
    V)."""
    lo, hi = query_range(plan, T, S, window, chunk)
    return hi >= lo


def work(plan, T: int, S: int, H: int, KV: int, D: int,
         window: int | None = None, chunk: int | None = None,
         itemsize: int = 2) -> tuple:
    """(bytes, operations) of one call, for its bound: q read and out
    written once, the plan, and each K and V row that some query of its
    batch row reads, once; 4 D operations (two products) per query head and
    valid (query, position) pair of the plain version's mask.

    A row's nonempty ranges (:func:`query_range`) leave no gap between
    them (lo and hi never fall as the query moves on, and lo never passes
    the previous query's hi + 1), so a row reads max hi - min lo + 1
    rows."""
    lo, hi = query_range(plan, T, S, window, chunk)
    some = hi >= lo
    pairs = int(torch.where(some, hi - lo + 1, 0).sum())
    big = torch.iinfo(torch.int64).max
    rows = torch.where(some, hi, -1).amax(1) - \
        torch.where(some, lo, big).amin(1) + 1
    rows = int(torch.where(some.any(1), rows, 0).sum())
    B = lo.shape[0]
    nbytes = (2 * B * T * H * D + 2 * rows * KV * D) * itemsize + 2 * B * 8
    return nbytes, 4 * D * H * pairs


def same_bits_pairs(q, k, v, first: torch.Tensor,
                    window: int | None = None) -> list:
    """Outputs that the kernel's contract makes bitwise equal: q's queries
    37 to 41 in calls of 1, of 5, of 40 and of all of q's T (at least 42)
    over the rings k, v. ``first`` (B,) is the position of q's query 0 in
    each row, and every call has the newest position of q's last query, so
    a query reads the same positions in each. The call of T starts 37
    queries before the checked ones and the call of 40 three, so a query
    lands in another row of its 64-row tile than in the smaller calls,
    beside rows whose ranges end in other key blocks. Returns ``[(what,
    a, b)]``, ``a`` from a call of one query."""
    T = q.shape[1]
    last = first + T - 1

    def call(start: int, n: int) -> torch.Tensor:
        plan = torch.stack([first + start, last - (first + start) + 1])
        return ring_attention(q[:, start:start + n].contiguous(), k, v, plan,
                              window)

    big, forty, five = call(0, T), call(34, 40), call(37, 5)
    pairs = []
    for t in range(5):
        one = call(37 + t, 1)[:, 0]
        pairs += [(f"query {t}: a call of 1 against a call of {n}", one,
                   got[:, at])
                  for n, got, at in ((5, five, t), (40, forty, 3 + t),
                                     (T, big, 37 + t))]
    return pairs


def _call_args(q, k, v, out, plan, window, chunk) -> tuple:
    """The kernel's arguments but the stream: the route's code first."""
    B, T, H, D = q.shape
    geo = (ctypes.c_longlong * 8)(B, T, H, k.shape[2], D, k.shape[1],
                                  window or 0, chunk or 0)
    return (ROUTES.index(route(q.dtype, D, k.shape[1])), _FLOAT_CODE[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo,
            plan.data_ptr(), math.sqrt(D))


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
    f, dev = _fn("ra_forward"), q.device
    args = _call_args(q, k, v, out, plan, window, chunk)
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
