"""Public collective API of the port: every reduction goes through here.

The port of ``repro.core.collectives``. The central entry points are
:func:`all_reduce` (one stacked payload) and :func:`bucketed_all_reduce`
(a dict or list of stacked leaves). Algorithm selection follows the paper's
experimental lesson — Table 2 shows OpenMPI collapsing in the mid-range
because of a bad internal algorithm switch — so the ``auto`` method picks the
algorithm *and* the pipeline block count from the alpha-beta cost model
(:mod:`repro_torch.core.cost_model`), and both can be overridden per call.

Every function takes the transport ``comm``
(:class:`~repro_torch.core.transport.LocalTransport`) where the reference
takes ``(axis_name, p)``, and a payload whose dim 0 walks the transport's
ranks. ``op`` is a commutative op's name (``"add"``, ``"max"``, ``"min"``,
``"mul"``) or an associative callable on stacked operands.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.core import autotune
from repro_torch.core import cost_model as cm
from repro_torch.core.dptree import (COMMUTATIVE_OPS, Op, dptree_allreduce,
                                     hier_allreduce, redbcast_allreduce,
                                     ring_allreduce, sptree_allreduce)
from repro_torch.core.topology import resolve_levels

__all__ = [
    "METHODS",
    "CollectiveConfig",
    "all_reduce",
    "bucketed_all_reduce",
    "structured_all_reduce",
    "all_reduce_mean",
    "bucket_sizes",
]

METHODS = ("auto", "dptree", "sptree", "redbcast", "ring", "hier", "psum")


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """How reductions are executed (the reference's fields and meanings).

    ``method``       one of METHODS. ``auto`` = measured-autotuner hit if one
                     exists for (p, bytes, dtype, fabric), else the cost-model
                     switch per size.
    ``num_blocks``   pipeline block count; None = Pipelining-Lemma optimum
                     refined by local descent (and by the autotuner's measured
                     pick under ``auto``).
    ``compression``  None | 'bf16' — cast the WHOLE payload before any wire,
                     cast back at the end (every stage rides bf16). For the
                     hierarchical slow-stage-only variant with f32
                     combines, use ``compress_inter_group`` instead.
    ``bucket_bytes`` split leaf collections into buckets of at most this
                     many bytes per rank.
    ``comm_model``   alpha-beta constants for the INTER-group (slowest) fabric,
                     used by the auto switch/tuner. The port has no fit of
                     its own yet, so the default is the paper's cluster.
    ``group_size``   hierarchy spec for the hierarchical method: ranks per
                     fast-link group (int), or a tuple of per-level ring
                     sizes innermost-first; None = 4, then 2, then flat. Also
                     gates whether 'hier' competes in the ``auto`` switch.
    ``levels``       alias for an N-level ``group_size`` spec; when set it
                     takes precedence.
    ``intra_model``  alpha-beta constants for the intra-group fast links.
    ``compress_inter_group``
                     hierarchical method only: bf16-compress the slow
                     inter-group stage's wire (intra stages and the final
                     result stay full precision; tree combines run in f32).
    """

    method: str = "dptree"
    num_blocks: int | None = None
    compression: str | None = None
    bucket_bytes: int = 1 << 30
    comm_model: cm.CommModel = cm.PAPER_HYDRA
    group_size: int | tuple | None = None
    intra_model: cm.CommModel = cm.PAPER_HYDRA
    levels: tuple | None = None
    compress_inter_group: bool = False

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; want {METHODS}")
        if self.compression not in (None, "bf16"):
            raise ValueError(f"unknown compression {self.compression!r}")
        if self.levels is not None:
            object.__setattr__(self, "levels", tuple(int(s)
                                                     for s in self.levels))
        if isinstance(self.group_size, (list, tuple)):
            object.__setattr__(self, "group_size",
                               tuple(int(s) for s in self.group_size))

    @property
    def hier_spec(self):
        """The hierarchy spec hier/auto paths consume: ``levels`` if set,
        else ``group_size`` (int, tuple, or None)."""
        return self.levels if self.levels is not None else self.group_size


_RUNNABLE = ("dptree", "sptree", "redbcast", "ring", "hier", "psum")

# Ops the library reduction (psum) covers.
_PRIMITIVE_REDUCE = ("add", "max", "min")


def _is_named(op: Op, names) -> bool:
    return isinstance(op, str) and op in names


def _degrade_for_op(algo: str, op: Op, method: str) -> str:
    """Reroute an algorithm pick that cannot run this operator.

    ring/hier reduce in ring order (commutative ops only) and psum only has
    library equivalents for add/max/min. Under ``auto`` every such pick
    silently degrades to the rank-ordered dptree — auto must never raise on
    an op/model/cache combination. An EXPLICIT hier request raises; explicit
    ring/psum keep their documented behavior and error paths.
    """
    unsupported = ((algo in ("ring", "hier")
                    and not _is_named(op, COMMUTATIVE_OPS))
                   or (algo == "psum"
                       and not _is_named(op, _PRIMITIVE_REDUCE)))
    if not unsupported:
        return algo
    if method == "auto":
        return "dptree"
    if algo == "hier":
        raise ValueError(
            "method='hier' requires a commutative op ('add'/'max'/'min'/"
            "'mul'); use dptree for merely-associative ops")
    return algo


def _pick(method: str, p: int, nbytes: int, config: CollectiveConfig,
          dtype, axis_name: str | None = None) -> tuple:
    """(algorithm, measured_num_blocks | None, hier_spec | None, compress).

    ``hier_spec`` is the hierarchy level spec the hier path should execute
    with; ``compress`` is whether the slow inter-group stage rides the bf16
    wire. ``axis_name`` scopes the autotune probe to that axis's
    measurements (legacy axis-less entries still match any axis).
    """
    if method != "auto":
        return method, None, config.hier_spec, config.compress_inter_group
    # A measured (algorithm, blocks) for this exact (p, bytes, dtype, fabric,
    # axis) beats any model prediction — but only if the recorded setting is
    # runnable here ('auto' must degrade, never raise, on a stale entry).
    hit = autotune.lookup(p, int(max(nbytes, 1)), str(dtype),
                          config.comm_model.name, axis=axis_name)
    if hit is not None and hit.algorithm in _RUNNABLE:
        if hit.algorithm != "hier":
            return hit.algorithm, max(1, int(hit.num_blocks)), None, False
        # Replay ONLY the configuration the entry was measured with: the
        # exact group shape, and compression only if it was timed compressed
        # and this config opts into the lossy wire; else fall through.
        lv = (resolve_levels(p, hit.group_size)
              if hit.group_size is not None else None)
        if lv is not None and (not hit.compressed
                               or config.compress_inter_group):
            return "hier", max(1, int(hit.num_blocks)), lv, hit.compressed
    algo = cm.best_algorithm(p, float(max(nbytes, 1)), config.comm_model,
                             group_size=config.hier_spec,
                             intra_model=config.intra_model)
    return (algo, None, config.hier_spec,
            algo == "hier" and config.compress_inter_group)


def _nblocks(num_blocks, p, nbytes, model, algorithm, group_size=None,
             compression=None):
    if num_blocks is not None:
        return int(num_blocks)
    if algorithm in ("dptree", "sptree", "redbcast", "hier"):
        return cm.optimal_blocks(p, float(max(nbytes, 1)), model, algorithm,
                                 group_size=group_size,
                                 compression=compression)
    return 1


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype as the autotune cache keys it (``float32``, as in the
    reference's JSON, not ``torch.float32``)."""
    return str(dtype).removeprefix("torch.")


def all_reduce(x: torch.Tensor, comm,
               config: CollectiveConfig = CollectiveConfig(),
               op: Op = "add") -> torch.Tensor:
    """Allreduce the stacked payload ``x``: the reduction over all
    ``comm.p`` ranks lands in every row.

    ``x`` is ``(ranks, ...)``: one payload per rank the transport holds. The
    algorithm, pipeline block count, hierarchy shape, and compression all
    come from ``config`` (see :class:`CollectiveConfig`); ``op`` must be
    associative, and the ring-order methods (``ring``/``hier``) additionally
    require a commutative named op — under ``auto`` unsupported picks
    silently degrade to the rank-ordered dptree, explicit requests raise.

    Payload layout: scalar and 1-D payloads pipeline directly; payloads of
    2+ dims pipeline over their first dim with the rest riding along.
    """
    p = comm.p
    if p == 1:
        return x
    shape, dtype = x.shape, x.dtype
    n = x.shape[0]
    flat = x.reshape(n, -1) if x.ndim <= 2 else x
    if config.compression == "bf16" and flat.dtype == torch.float32:
        flat = flat.to(torch.bfloat16)
    nbytes = (flat.numel() // max(n, 1)) * flat.element_size()
    algo, nb_measured, hier_spec, hier_compress = _pick(
        config.method, p, nbytes, config, _dtype_name(flat.dtype))
    new_algo = _degrade_for_op(algo, op, config.method)
    if new_algo != algo:
        algo, nb_measured = new_algo, None
    nb = (nb_measured if config.num_blocks is None and nb_measured is not None
          else _nblocks(config.num_blocks, p, nbytes, config.comm_model,
                        algo, hier_spec,
                        "bf16" if hier_compress else None))
    if algo == "psum":
        if not _is_named(op, _PRIMITIVE_REDUCE):
            raise ValueError(
                "method='psum' supports only the 'add'/'max'/'min' ops; "
                "use a schedule-based method for custom operators")
        out = comm.psum(flat, op)
    elif algo == "dptree":
        out = dptree_allreduce(flat, comm, num_blocks=nb, op=op)
    elif algo == "sptree":
        out = sptree_allreduce(flat, comm, num_blocks=nb, op=op)
    elif algo == "redbcast":
        out = redbcast_allreduce(flat, comm, num_blocks=nb, op=op)
    elif algo == "ring":
        out = ring_allreduce(flat, comm, op=op)
    elif algo == "hier":
        out = hier_allreduce(flat, comm, group_size=hier_spec,
                             num_blocks=nb, op=op,
                             compress_inter_group=hier_compress)
    else:  # pragma: no cover
        raise AssertionError(algo)
    return out.to(dtype).reshape(shape)


def all_reduce_mean(x: torch.Tensor, comm,
                    config: CollectiveConfig = CollectiveConfig()
                    ) -> torch.Tensor:
    return all_reduce(x, comm, config) / comm.p


def _tree_flatten(tree) -> tuple:
    """Leaves of a tensor, dict (keys sorted, as JAX orders them), list or
    tuple — nested — and the function that rebuilds the structure."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        subs = [_tree_flatten(v) for v in tree]
    else:
        raise TypeError(f"unsupported tree node {type(tree).__name__}")
    leaves, counts = [], []
    for ls, _ in subs:
        leaves += ls
        counts.append(len(ls))

    def unflatten(ls):
        out, off = [], 0
        for (_, rebuild), c in zip(subs, counts):
            out.append(rebuild(ls[off:off + c]))
            off += c
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return leaves, unflatten


def _bucket_groups(items, size_of, bucket_bytes):
    """Greedy dtype-homogeneous bucketing shared by
    :func:`bucketed_all_reduce` and :func:`bucket_sizes`.
    ``size_of(item) -> (nelems, dtype)``."""
    items = sorted(items, key=lambda it: _dtype_name(size_of(it)[1]))
    i = 0
    while i < len(items):
        dt = size_of(items[i])[1]
        group, sz = [], 0
        while i < len(items) and size_of(items[i])[1] == dt \
                and (not group or sz < bucket_bytes):
            group.append(items[i])
            sz += size_of(items[i])[0] * dt.itemsize
            i += 1
        yield group


def _per_rank(leaf: torch.Tensor) -> int:
    return leaf.numel() // max(leaf.shape[0], 1)


def bucketed_all_reduce(tree: Any, comm,
                        config: CollectiveConfig = CollectiveConfig()) -> Any:
    """Allreduce a dict or list of stacked leaves with flat bucketing.

    Leaves are grouped by dtype, concatenated per rank into contiguous
    buckets of at most ``config.bucket_bytes``, reduced as single long
    vectors (the paper's ``m``), and scattered back: one long pipelined
    vector amortizes the latency term far better than per-tensor reductions.
    Every leaf is replicated (the port has no sharded layouts yet).
    """
    if comm.p == 1:
        return tree
    leaves, unflatten = _tree_flatten(tree)
    out = [None] * len(leaves)
    for group in _bucket_groups(range(len(leaves)),
                                lambda k: (_per_rank(leaves[k]),
                                           leaves[k].dtype),
                                config.bucket_bytes):
        n = leaves[group[0]].shape[0]
        flat = (torch.cat([leaves[k].reshape(n, -1) for k in group], dim=1)
                if len(group) > 1 else leaves[group[0]].reshape(n, -1))
        red = all_reduce(flat, comm, config)
        off = 0
        for k in group:
            w = _per_rank(leaves[k])
            out[k] = red[:, off:off + w].reshape(leaves[k].shape)
            off += w
    return unflatten(out)


def bucket_sizes(tree: Any, bucket_bytes: int = 1 << 30) -> list:
    """The ``(nelems, dtype)`` of each reduction :func:`bucketed_all_reduce`
    would issue for this collection of stacked leaves (per-rank element
    counts) — the vector lengths an autotune warm-up should measure."""
    leaves, _ = _tree_flatten(tree)
    out = []
    for group in _bucket_groups(range(len(leaves)),
                                lambda k: (_per_rank(leaves[k]),
                                           leaves[k].dtype),
                                bucket_bytes):
        out.append((sum(_per_rank(leaves[k]) for k in group),
                    leaves[group[0]].dtype))
    return out


def structured_all_reduce(tree: Any, comm,
                          combine: Callable[[Any, Any], Any],
                          method: str = "dptree") -> Any:
    """Latency-critical allreduce of a *structured* value under a custom
    associative ``combine`` (e.g. flash-decoding softmax partials: (max, sum,
    out) triples). Uses a single pipeline block (b=1), where the dual-root
    tree is the log-latency optimum — the regime the paper's algorithm
    targets — on the general (rank-ordered) path.

    ``combine(a, b)`` takes and returns trees shaped like ``tree``, whose
    leaves are stacked ``(ranks, ...)``; it must act row by row.
    """
    if comm.p == 1:
        return tree
    leaves, unflatten = _tree_flatten(tree)
    sizes = [_per_rank(l) for l in leaves]
    shapes = [tuple(l.shape[1:]) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    wide = functools.reduce(torch.promote_types, dtypes)

    def unpack(v):
        out, off = [], 0
        for s, sh, dt in zip(sizes, shapes, dtypes):
            out.append(v[:, off:off + s].reshape((v.shape[0],) + sh).to(dt))
            off += s
        return unflatten(out)

    def pack(t):
        ls, _ = _tree_flatten(t)
        return torch.cat([l.to(wide).reshape(l.shape[0], -1) for l in ls],
                         dim=1)

    def op(a, b):
        return pack(combine(unpack(a), unpack(b)))

    fn = {"dptree": dptree_allreduce, "sptree": sptree_allreduce}[method]
    red = fn(pack(tree), comm, num_blocks=1, op=op, op_rev=op)
    return unpack(red)
