"""Per-tick serving telemetry, reduced across replicas with the b=1 tree
(the port of ``repro.serving.telemetry``).

Each engine tick produces a small stats vector (queue depth, busy slots,
tokens emitted, prefills, ...). A data-parallel fleet needs every
replica's global view of it, and the payload is a handful of floats: the
b=1 (single-block) latency-bound regime where the paper's dual-root tree
beats a ring. :func:`make_stats_reducer` therefore pins ``num_blocks=1``
and leaves the algorithm to ``method="auto"``. One replica sums on the
host. Several replicas, stacked as the rows of one tensor on one device,
go through the port's :func:`~repro_torch.core.collectives.all_reduce` on
a :class:`~repro_torch.core.transport.LocalTransport`. For the 64-byte row
the cost model's switch picks the ring at p = 4 and the dual-root tree at
p = 8 and above (as the reference's does); the tree's fused engine folds
each step's blocks with the ``combine3`` kernel on a card.
The reference's ``obs`` probe hook comes with queue 1's item 6.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.collectives import CollectiveConfig, all_reduce

__all__ = ["STATS_FIELDS", "STATS_COLLECTIVE", "stats_vector",
           "make_stats_reducer", "StepStats", "TelemetryLog"]

# field order of the per-tick stats vector (summed across replicas), the
# reference's: the counters of queue 1's items 2b and 2c (drafts,
# failovers, preemptions, shedding, prefix hits) stay 0 in the port until
# those items land; new counters are APPENDED, so positional slices hold
STATS_FIELDS = ("queue_depth", "active_slots", "new_tokens", "prefills",
                "prefill_chunks", "sampled_tokens", "drafted_tokens",
                "accepted_tokens", "failovers", "resumed_tokens",
                "quarantines", "preemptions", "shed_requests",
                "deadline_misses", "prefix_hits", "prefix_tokens_reused")

# b=1: the latency-bound single-block pipeline; "auto": a measured
# autotuner hit if one exists for (p, bytes, dtype, fabric), else the cost
# model's switch
STATS_COLLECTIVE = CollectiveConfig(method="auto", num_blocks=1)


def stats_vector(stats: dict) -> list:
    """Order a per-tick ``{field: value}`` dict into the STATS_FIELDS row,
    refusing any field missing or unknown (a skewed row would sum the
    wrong counters fleet-wide without any shape error)."""
    extra = set(stats) - set(STATS_FIELDS)
    missing = set(STATS_FIELDS) - set(stats)
    if extra or missing:
        raise ValueError(
            "per-tick stats drifted from telemetry.STATS_FIELDS: "
            f"missing={sorted(missing)} unexpected={sorted(extra)}")
    return [float(stats[f]) for f in STATS_FIELDS]


def make_stats_reducer(comm=None,
                       collective: CollectiveConfig = STATS_COLLECTIVE):
    """Build ``reduce(rows) -> summed (k,)`` over the replicas of ``comm``
    (a :class:`~repro_torch.core.transport.LocalTransport`; None is one
    replica).

    ``rows`` is a stacked ``(p, k)`` matrix, one stats row per replica, or
    a single ``(k,)``/``(1, k)`` row, which stands in for every replica
    (one engine standing in for the fleet, as in the reference). With one
    replica the rows are summed on the host; otherwise they go to
    ``comm``'s device as the ``(p, k)`` f32 payload of one ``all_reduce``
    under ``collective``, and every rank's row comes back equal."""
    p = 1 if comm is None else comm.p
    if p <= 1:
        return lambda rows: np.asarray(rows, np.float32).reshape(
            -1, np.shape(rows)[-1]).sum(0)

    def reduce(rows):
        arr = np.atleast_2d(np.asarray(rows, np.float32))
        if arr.shape[0] == 1:
            arr = np.tile(arr, (p, 1))
        if arr.shape[0] != p:
            raise ValueError(
                f"stats rows {arr.shape} do not match the {p} replicas "
                f"(want 1 or {p} rows)")
        x = torch.from_numpy(arr).to(comm.device)
        return all_reduce(x, comm, collective)[0].cpu().numpy()

    return reduce


@dataclasses.dataclass(frozen=True)
class StepStats:
    """One engine tick's (cross-replica-summed) counters (see STATS_FIELDS)."""
    tick: int
    queue_depth: float
    active_slots: float
    new_tokens: float
    prefills: float
    prefill_chunks: float = 0.0
    sampled_tokens: float = 0.0
    drafted_tokens: float = 0.0
    accepted_tokens: float = 0.0
    failovers: float = 0.0
    resumed_tokens: float = 0.0
    quarantines: float = 0.0
    preemptions: float = 0.0
    shed_requests: float = 0.0
    deadline_misses: float = 0.0
    prefix_hits: float = 0.0
    prefix_tokens_reused: float = 0.0


class TelemetryLog:
    """Collects per-tick stats and summarizes a finished run."""

    def __init__(self, reducer=None):
        self._reduce = reducer or (
            lambda stacked: np.asarray(stacked, np.float32).sum(0))
        self.steps: list = []

    def step(self, tick: int, local_vec) -> StepStats:
        """Record one tick. ``local_vec`` is this replica's row (k,) or a
        stacked (p, k) matrix of every replica's row."""
        vec = np.atleast_2d(np.asarray(local_vec, np.float32))
        red = self._reduce(vec)
        s = StepStats(tick, *(float(x) for x in red[:len(STATS_FIELDS)]))
        self.steps.append(s)
        return s

    def report(self, finished, wall_s: float, ticks: int) -> dict:
        """Aggregate a run. ``finished``: completed Request objects."""
        toks = [len(r.tokens) for r in finished]
        ttfts = [r.ttft for r in finished if r.ttft is not None]
        lats = [r.latency for r in finished if r.latency is not None]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else float("nan")

        total = int(sum(toks))
        return {
            "requests": len(finished),
            "total_tokens": total,
            "wall_s": float(wall_s),
            "tok_s": total / wall_s if wall_s > 0 else float("nan"),
            "tok_s_note": (None if wall_s > 0
                           else "wall_s <= 0: tok_s undefined"),
            "ticks": int(ticks),
            "ttft_ticks_mean": float(np.mean(ttfts)) if ttfts else float("nan"),
            "ttft_ticks_p50": pct(ttfts, 50),
            "ttft_ticks_p95": pct(ttfts, 95),
            "ttft_ticks_p99": pct(ttfts, 99),
            "latency_ticks_p50": pct(lats, 50),
            "latency_ticks_p95": pct(lats, 95),
            "latency_ticks_p99": pct(lats, 99),
            "steps": list(self.steps),
        }
