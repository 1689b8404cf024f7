"""How the engine's ranks talk: the counterpart of the reference's
``shard_map`` + ``ppermute`` + ``axis_index``.

The tree engine, the ring stages and the collective API are written against
four members of a transport: ``p`` (ranks in the collective), ``device``,
``ranks()`` (the global ranks whose buffers this process holds, in row order)
and ``ppermute(x, pairs)`` / ``psum(x, op)``. Every buffer is a tensor whose
dim 0 walks those ranks. :class:`LocalTransport` holds all ``p`` ranks
stacked on one device, which is the only multi-rank form one GPU allows (NCCL
will not place two ranks on one card); a transport with one rank per
process holds a single row and keeps the same engine.
"""

from __future__ import annotations

import torch

__all__ = ["LocalTransport", "resolve_device", "host_to"]

_PRIMITIVE = {"add": "sum", "max": "amax", "min": "amin"}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. There is no silent fallback: asking for CUDA (or nothing) on a
    machine without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            # name the card, so the device compares equal to its tensors'
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``. To a card it goes through pinned memory
    without blocking, so the copy joins the stream's queue instead of
    waiting for the work already in it (a plain ``.to`` from pageable memory
    synchronizes the stream)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class LocalTransport:
    """All ``p`` ranks stacked on one device: rank ``r``'s buffer is row
    ``r`` of one ``(p, ...)`` tensor.

    ``ppermute`` is an index gather with a ``(p,)`` source index built once
    per pair set; ranks that receive nothing get zeros, as JAX's
    ``ppermute`` gives them.
    """

    def __init__(self, p: int, device=None):
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        self.p = int(p)
        self.device = resolve_device(device)
        self._ranks = torch.arange(self.p, device=self.device)
        self._perms: dict = {}

    def ranks(self) -> torch.Tensor:
        return self._ranks

    def _perm(self, pairs: tuple) -> tuple:
        hit = self._perms.get(pairs)
        if hit is None:
            src = [-1] * self.p
            for s, d in pairs:
                if src[d] != -1:
                    raise ValueError(f"rank {d} receives twice in {pairs}")
                src[d] = s
            idle = [r for r in range(self.p) if src[r] == -1]
            gather = torch.tensor([max(s, 0) for s in src], device=self.device)
            zero = (torch.tensor(idle, device=self.device) if idle else None)
            hit = self._perms[pairs] = (gather, zero)
        return hit

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """Row ``dst`` of the result is row ``src`` of ``x`` for every
        ``(src, dst)`` pair; rows that receive nothing are zero."""
        gather, zero = self._perm(tuple(pairs))
        out = x.index_select(0, gather)
        if zero is not None:
            out.index_fill_(0, zero, 0)
        return out

    def psum(self, x: torch.Tensor, op: str = "add") -> torch.Tensor:
        """The library reduction over the rank dim, on every rank: the
        counterpart of XLA's native allreduce (``psum``/``pmax``/``pmin``)."""
        if op not in _PRIMITIVE:
            raise ValueError("method='psum' supports only the 'add', 'max' "
                             "and 'min' ops; use a schedule-based method for "
                             "custom operators")
        if op == "add":
            red = x.sum(0, keepdim=True, dtype=x.dtype)
        else:
            red = getattr(x, _PRIMITIVE[op])(0, keepdim=True)
        return red.expand_as(x).contiguous()
