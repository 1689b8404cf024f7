"""Linear (alpha-beta-gamma) cost model for the paper's collectives.

The paper analyses all algorithms in a round-based, uniform, linear-cost model:
a bidirectional exchange of ``n`` elements costs ``alpha + beta * n``; applying
the reduction operator costs ``gamma`` per element.

This module provides:

* closed-form ``T(b)`` for each implemented algorithm,
* the "Pipelining Lemma" optimal block count/size (the paper's open question #1
  is how to choose ``b`` — we expose both the analytic optimum and a tuner hook),
* the paper's OmniPath cluster fit as the one preset, so the same formulas
  drive the auto algorithm switch in :mod:`repro_torch.core.collectives`.

The port's copy of ``repro.core.cost_model``: every formula is the
reference's, held equal to it by ``tests/test_torch_topology.py``. The
reference's TPU presets are not carried over (they price a TPU's links);
until the port has a fit of its own, every default model here is
:data:`PAPER_HYDRA`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core.topology import (as_levels, build_dual_tree,
                                       build_single_tree, default_group_size,
                                       resolve_levels)

__all__ = [
    "CommModel",
    "PAPER_HYDRA",
    "dptree_time",
    "sptree_time",
    "redbcast_time",
    "ring_time",
    "hier_time",
    "tp_time",
    "COMPRESS_FACTOR",
    "optimal_blocks",
    "best_algorithm",
]


@dataclasses.dataclass(frozen=True)
class CommModel:
    """alpha [s], beta [s/byte], gamma [s/byte] linear communication model."""

    alpha: float
    beta: float
    gamma: float = 0.0
    name: str = "custom"

    def exchange(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


# Rough fit of the paper's Hydra cluster numbers (OmniPath, 36x32, MPI):
# alpha ~ 16.75us MPI_Allreduce at count=1; per-int time from the large-count
# column: ~56.2ms at 8.4M ints over p=288 -> beta ~ 1.6ns/B effective.
PAPER_HYDRA = CommModel(alpha=8e-6, beta=1.6e-9, gamma=0.2e-9, name="paper_hydra")


def _dual_tree_height(p: int) -> int:
    return build_dual_tree(p).max_depth


def _single_tree_height(p: int) -> int:
    return build_single_tree(p).max_depth


def _tree_steps(topo, b: int) -> int:
    """Active communication steps of the static schedule: macro-rounds times
    the number of non-empty edge classes (p=2 has ONE class — the bare dual
    exchange costs b steps, not 3b; the balanced case recovers 4h-3+3(b-1))."""
    return topo.num_macro_rounds(b) * max(1, len(topo.active_classes()))


def dptree_time(p: int, m_bytes: float, b: int, model: CommModel) -> float:
    """Doubly-pipelined dual-root allreduce: ``~(4h-3+3(b-1))*(alpha+beta*m/b)``
    via the actual topology schedule (exact for non-power-of-two p and for
    the degenerate p=2 dual-root exchange). The gamma term adds at most
    ``3*gamma*m/b`` per round (two child combines + the root's dual combine).
    """
    if p == 1:
        return 0.0
    steps = _tree_steps(build_dual_tree(p), b)
    per = model.exchange(m_bytes / b) + model.gamma * (m_bytes / b)
    return steps * per


def sptree_time(p: int, m_bytes: float, b: int, model: CommModel) -> float:
    """Single doubly-pipelined tree (paper §1.2): latency ``4h`` instead of 4h-3."""
    if p == 1:
        return 0.0
    h = _single_tree_height(p) + 1
    steps = 4 * h + 3 * (b - 1)
    per = model.exchange(m_bytes / b) + model.gamma * (m_bytes / b)
    return steps * per


def redbcast_time(p: int, m_bytes: float, b: int, model: CommModel) -> float:
    """Pipelined reduce followed by pipelined broadcast: ``2(2h+2(b-1))(..)``."""
    if p == 1:
        return 0.0
    h = _single_tree_height(p) + 1
    steps = 2 * (2 * h + 2 * (b - 1))
    per = model.exchange(m_bytes / b) + model.gamma * (m_bytes / b)
    return steps * per


def ring_time(p: int, m_bytes: float, model: CommModel,
              bidirectional: bool = True) -> float:
    """Ring reduce-scatter + all-gather. Bidirectional halves the beta term."""
    if p == 1:
        return 0.0
    steps = 2 * (p - 1)
    chunk = m_bytes / p
    if bidirectional:
        chunk = chunk / 2.0
    return steps * (model.exchange(chunk) + model.gamma * chunk)


# Wire-bytes multiplier of the slow inter-group stage per compression mode.
COMPRESS_FACTOR = {None: 1.0, "bf16": 0.5}


def tp_time(tp: int, m_bytes: float, model: CommModel) -> float:
    """Per-token tensor-parallel allreduce stage: the better of the
    doubly-pipelined dual-root tree (at its own block optimum) and the
    bidirectional ring, over ``tp`` ranks of the fastest fabric.

    Decode activations are tiny (``batch * d_model * itemsize`` bytes per
    sublayer reduction), i.e. the paper's latency-bound regime: the tree's
    ``O(log tp)`` startup beats the ring's ``O(tp)`` there, while at
    gradient-bucket sizes the ring's bandwidth term wins — exactly the
    crossover :func:`best_algorithm` ranks.
    """
    if tp <= 1:
        return 0.0
    b = optimal_blocks(tp, m_bytes, model, "dptree")
    return min(dptree_time(tp, m_bytes, b, model),
               ring_time(tp, m_bytes, model))


def hier_time(p: int, m_bytes: float, b: int, model: CommModel,
              group_size=4,
              intra_model: CommModel | None = None, *,
              level_models=None,
              compression: str | None = None,
              tp: int = 1, tp_bytes: float | None = None,
              tp_model: CommModel | None = None) -> float:
    """Hierarchical (2..N-level) allreduce on a heterogeneous fabric.

    ``model`` prices the slow inter-group links. ``group_size`` is a
    hierarchy spec (int, or a tuple of per-level ring sizes innermost-first
    — see :func:`repro_torch.core.topology.as_levels`).
    Each intra level is priced with its own ``(alpha, beta, gamma)``:
    ``level_models[j]`` if given (innermost first), else ``intra_model``
    (default :data:`PAPER_HYDRA`) for every level. Stage costs:

    * level-``j`` reduce-scatter + all-gather: ``2*(s_j - 1)`` steps of a
      bidirectional ring exchanging ``m_j / (2 s_j)`` bytes each, where
      ``m_j = m / prod(levels[:j])`` is the vector that reaches level ``j`` —
      the ``2*beta_j*m_j*(s_j-1)/s_j`` terms on the FAST links,
    * inter-group dptree over the ``m / prod(levels)``-byte shard stripes on
      the SLOW links — the wire term the hierarchy divides by the full group
      factor. ``compression='bf16'`` multiplies the slow-stage bytes by
      :data:`COMPRESS_FACTOR` (0.5: bf16 wire over f32 payloads); the fast
      levels always move full-precision bytes.

    Degenerate specs keep their closed forms: an infeasible spec prices as
    the flat dptree, a single all-covering group as the pure intra ring.

    ``tp > 1`` adds a tensor-parallel stage (:func:`tp_time`) on the
    innermost/fastest fabric: one per-token allreduce of ``tp_bytes``
    (default ``m_bytes``) across the ``tp`` model shards of each replica.
    The TP stage is additive and orthogonal to the replica hierarchy — it
    applies even at ``p == 1`` (a single tensor-parallel replica).
    """
    extra = 0.0
    if tp > 1:
        fast = tp_model or (tuple(level_models)[0] if level_models
                            else (intra_model or PAPER_HYDRA))
        extra = tp_time(tp, m_bytes if tp_bytes is None else tp_bytes, fast)
    if p == 1:
        return extra
    try:
        levels = as_levels(group_size)
    except (TypeError, ValueError):
        levels = None
    S = int(np.prod(levels)) if levels else 1
    if not levels or S <= 1 or p % S:
        return extra + dptree_time(p, m_bytes, b, model)
    if level_models is None:
        level_models = (intra_model or PAPER_HYDRA,) * len(levels)
    if len(level_models) != len(levels):
        raise ValueError(f"need one CommModel per level: "
                         f"{len(level_models)} models for {levels}")
    g = p // S
    t, cur = extra, m_bytes
    for s, lm in zip(levels, level_models):
        half = cur / s / 2.0
        t += 2 * (s - 1) * (lm.exchange(half) + lm.gamma * half)
        cur /= s
    if g == 1:
        return t
    return t + dptree_time(g, cur * COMPRESS_FACTOR[compression], b, model)


@functools.lru_cache(maxsize=4096)
def optimal_blocks(p: int, m_bytes: float, model: CommModel,
                   algorithm: str = "dptree",
                   group_size=None,
                   compression: str | None = None) -> int:
    """Pipelining-Lemma block count: balance the +3b alpha term vs beta*m/b.

    For ``T(b) = (L + c*b)(alpha + beta*m/b)``, the optimum is
    ``b* = sqrt(L * beta * m / (c * alpha))``, refined by the local descent of
    :func:`_refine_blocks` (integer macro-round effects). Clamped to
    [1, m_bytes/64] so a block never goes below 64 bytes (one cache line /
    lane group). ``model`` prices the fabric the pipelined stage runs on —
    for ``algorithm='hier'`` that is the slow inter-group fabric; the block
    count is re-derived for the shard-stripe dptree the hierarchy actually
    pipelines (``p // prod(levels)`` ranks, ``m / prod(levels)`` bytes,
    halved again under ``compression='bf16'``), NOT reused from the flat
    optimum — per-level traffic, per-level block count.
    """
    if p == 1 or m_bytes <= 0:
        return 1
    if algorithm == "hier":
        # blocks pipeline the slowest stage: a dptree over num_groups ranks
        # moving the m/prod(levels)-byte (possibly compressed) shard stripes.
        # group_size=None resolves the same way hier_allreduce resolves it
        # (4, then 2, then flat) so the block count matches the shape that
        # actually executes.
        try:
            levels = as_levels(group_size)
        except (TypeError, ValueError):
            levels = None
        if levels is None:
            levels = as_levels(default_group_size(p))
        S = int(np.prod(levels)) if levels else 1
        if S <= 1 or p % S or p // S == 1:
            return optimal_blocks(p, m_bytes, model, "dptree")
        return optimal_blocks(p // S, m_bytes / S * COMPRESS_FACTOR[compression],
                              model, "dptree")
    if algorithm == "dptree":
        topo = build_dual_tree(p)
        c = float(max(1, len(topo.active_classes())))
        # steps(b) ~ c*b + lat with lat = steps(1) - c; lat == 0 (p=2, the
        # bare dual exchange) means pipelining buys nothing: b* = 1.
        lat = _tree_steps(topo, 1) - c
        if lat <= 0:
            return 1
    elif algorithm == "sptree":
        h = _single_tree_height(p) + 1
        lat, c = 4 * h - 3, 3.0
    elif algorithm == "redbcast":
        h = _single_tree_height(p) + 1
        lat, c = 4 * h - 4, 4.0
    else:
        raise ValueError(f"no pipelined form for {algorithm!r}")
    lat = max(lat, 1)
    beta_eff = model.beta + model.gamma
    b = math.sqrt(lat * beta_eff * m_bytes / (c * model.alpha))
    b = int(max(1, min(b, m_bytes / 64)))
    return _refine_blocks(max(1, b), p, m_bytes, model, algorithm)


_TIME_FNS = {}  # populated below; algorithm -> T(p, m_bytes, b, model)


def _refine_blocks(b: int, p: int, m_bytes: float, model: CommModel,
                   algorithm: str) -> int:
    """Local descent around the analytic optimum.

    The continuous Pipelining-Lemma ``b*`` ignores integer macro-round effects
    (step counts only change every third block), which can leave the analytic
    pick several percent off at small ``m``. Descend over halvings/doublings
    and +-1 until no neighbor is faster — at termination ``T(b) <= T(b//2)``
    and ``T(b) <= T(2b)`` hold by construction.
    """
    time_fn = _TIME_FNS[algorithm]
    best, t_best = b, time_fn(p, m_bytes, b, model)
    for _ in range(40):
        moved = False
        for cand in {max(1, best // 2), max(1, best - 1), best + 1, 2 * best}:
            if cand == best:
                continue
            t = time_fn(p, m_bytes, cand, model)
            if t < t_best:
                best, t_best, moved = cand, t, True
        if not moved:
            return best
    return best


_TIME_FNS.update({
    "dptree": dptree_time,
    "sptree": sptree_time,
    "redbcast": redbcast_time,
})


def best_algorithm(p: int, m_bytes: float, model: CommModel,
                   group_size=None,
                   intra_model: CommModel | None = None,
                   level_models=None) -> str:
    """Size-adaptive switch (what OpenMPI got wrong in the paper's Table 2).

    Evaluates every implemented algorithm at its own best block size and picks
    the fastest. Small m -> tree (log-latency); huge m -> ring (bandwidth).
    With a feasible ``group_size`` hierarchy spec (int or level tuple, see
    :func:`repro_torch.core.topology.resolve_levels`) the hierarchical composition
    also competes — it wins on heterogeneous fabrics where ``model`` prices
    slow inter-group links and ``intra_model``/``level_models`` fast intra
    ones. Compression never competes here: it changes the numerics, so only
    an explicit ``CollectiveConfig(compress_inter_group=True)`` (via the
    autotuner's extra candidates) opts into it.
    """
    cands = {
        "dptree": dptree_time(p, m_bytes, optimal_blocks(p, m_bytes, model, "dptree"), model),
        "sptree": sptree_time(p, m_bytes, optimal_blocks(p, m_bytes, model, "sptree"), model),
        "redbcast": redbcast_time(p, m_bytes, optimal_blocks(p, m_bytes, model, "redbcast"), model),
        "ring": ring_time(p, m_bytes, model),
    }
    lv = resolve_levels(p, group_size) if group_size else None
    if lv is not None:
        b = optimal_blocks(p, m_bytes, model, "hier", group_size=lv)
        cands["hier"] = hier_time(p, m_bytes, b, model, group_size=lv,
                                  intra_model=intra_model,
                                  level_models=level_models)
    return min(cands, key=cands.get)


def predicted_table(p: int, sizes_bytes, model: CommModel, b_elems: int = 16000,
                    elem_bytes: int = 4) -> "np.ndarray":
    """Model-predicted analogue of the paper's Table 2 (fixed block *size*).

    The paper fixes the block size at 16000 elements; the number of blocks is
    then ``ceil(m / 16000)``. Returns rows of
    (bytes, dptree, sptree, redbcast, ring) times in seconds.
    """
    rows = []
    blk_bytes = b_elems * elem_bytes
    for m in sizes_bytes:
        b = max(1, int(math.ceil(m / blk_bytes)))
        rows.append((
            m,
            dptree_time(p, m, b, model),
            sptree_time(p, m, b, model),
            redbcast_time(p, m, b, model),
            ring_time(p, m, model),
        ))
    return np.array(rows)
