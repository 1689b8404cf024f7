"""SLO-aware scheduling: priority classes, deadlines, aging, preemption
plans, and overload shedding (the port of ``repro.serving.slo``, copied
whole: the scheduler subclasses its policies; the engine serves the FIFO
policy only until queue 1's item 2b ports the rest).

Why a policy layer in *this* repo: every engine tick costs one
latency-bound b=1 dual-root stats reduction (the paper's ``O(alpha log p)``
small-m regime — docs/serving.md), so the tick is the natural unit of
scheduling cost and WHICH requests occupy slots each tick is what decides
p99 TTFT under heavy mixed traffic. The FIFO scheduler is
kept, verbatim, as the reference policy; this module adds the pieces a
production mix needs:

* **priority classes** (:class:`PriorityClass`): interactive / batch /
  best-effort, smaller = more urgent;
* **aging**: a queued request's *effective* priority improves by one class
  per ``age_ticks`` waited, so batch and best-effort traffic cannot be
  starved by a steady interactive stream (the no-starvation property test
  in tests/test_scheduling_props.py);
* **deadline-aware admission + shedding**: a request may carry a TTFT
  deadline (``SLOParams.deadline_ticks``, relative to arrival). Best-effort
  work whose deadline already passed unserved is SHED instead of occupying
  a slot it can no longer use, and an optional ``max_queue`` bound sheds
  the worst-priority arrived tail under overload — load is dropped at the
  queue, never mid-stream;
* **preemption plans**: when a strictly-higher-priority request is waiting
  and no slot is free, the policy nominates the worst-priority preemptible
  occupant for eviction. The *mechanism* lives in the scheduler/engine
  (``SlotScheduler.preempt`` + the engine's slot reset): the evicted
  request keeps its committed-token journal and re-admits through the
  exact-resume machinery, so a preempted-and-resumed stream is
  bit-identical to an undisturbed one — same contract as failover
  (docs/scheduling.md, docs/robustness.md).

Everything here is host-side and deterministic: decisions are pure
functions of ``(queue, slot table, now)``, which is what lets the
tick-deterministic engine serve as a scheduling-policy testbed
(tests/test_scheduling_props.py, ``bench_serving --slo``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class PriorityClass(enum.IntEnum):
    """Request priority classes: smaller is more urgent."""

    INTERACTIVE = 0
    BATCH = 1
    BEST_EFFORT = 2


@dataclasses.dataclass(frozen=True)
class SLOParams:
    """Per-request service-level objectives.

    priority: the request's :class:`PriorityClass`.
    deadline_ticks: TTFT deadline relative to arrival — the first token
        must be emitted by ``arrival + deadline_ticks`` or the request
        counts as a deadline miss (telemetry ``deadline_misses``); None =
        no deadline.
    preemptible: may this request be evicted mid-decode for
        higher-priority work? None derives the default: everything below
        INTERACTIVE is preemptible. Preemption is exact — the journal
        resumes the stream bit-identically — so opting out is a latency
        choice, not a correctness one.
    """

    priority: PriorityClass = PriorityClass.BATCH
    deadline_ticks: int | None = None
    preemptible: bool | None = None

    def __post_init__(self):
        object.__setattr__(self, "priority", PriorityClass(self.priority))
        if self.deadline_ticks is not None and self.deadline_ticks < 1:
            raise ValueError(
                f"deadline_ticks must be >= 1, got {self.deadline_ticks}")


def req_priority(req) -> int:
    """The request's priority class (BATCH when it carries no SLO)."""
    slo = getattr(req, "slo", None)
    return int(slo.priority) if slo is not None else int(PriorityClass.BATCH)


def req_deadline(req) -> int | None:
    """Absolute TTFT deadline tick, or None for deadline-free requests."""
    slo = getattr(req, "slo", None)
    if slo is None or slo.deadline_ticks is None:
        return None
    return req.arrival + slo.deadline_ticks


def req_preemptible(req) -> bool:
    slo = getattr(req, "slo", None)
    if slo is not None and slo.preemptible is not None:
        return slo.preemptible
    return req_priority(req) > int(PriorityClass.INTERACTIVE)


class SchedulingPolicy:
    """Pluggable admission/preemption/shedding policy.

    A policy is pure decision logic over host-side request metadata — it
    never touches device state (the scheduler owns the slot table, the
    engine owns the caches). All three hooks must be deterministic
    functions of their arguments; ties are always broken by
    ``(arrival, rid)`` so two runs of the same workload make the same
    decisions tick for tick.
    """

    name = "base"

    def admission_order(self, queue, now: int) -> list:
        """Arrived requests in the order slots should be granted."""
        raise NotImplementedError

    def sheds(self, queue, now: int) -> list:
        """Queued requests to drop (overload / hopeless deadlines)."""
        return []

    def preemptions(self, waiting, occupants: dict, now: int) -> list:
        """Slots to evict for ``waiting`` (admission-ordered requests that
        did not fit the free slots). Returns slot ids."""
        return []


class FIFOPolicy(SchedulingPolicy):
    """The reference policy, unchanged semantics: strict queue order,
    and a request that has not arrived yet blocks everything behind it
    (no skip-ahead, so a long-prompt request cannot be starved). Never
    sheds, never preempts."""

    name = "fifo"

    def admission_order(self, queue, now: int) -> list:
        out = []
        for req in queue:
            if req.arrival > now:
                break               # unarrived head gates the tail
            out.append(req)
        return out


class SLOPolicy(SchedulingPolicy):
    """Priority scheduling with aging, deadline shedding, and preemption.

    age_ticks: a queued request's effective priority improves by one
        class per ``age_ticks`` waited (0 disables aging).
    preempt: nominate victims for waiting strictly-higher-priority work.
    shed_deadline: drop BEST_EFFORT requests whose TTFT deadline passed
        while still queued (they could only waste a slot).
    max_queue: overload bound — when more than this many arrived requests
        wait, the worst-priority tail is shed (None = unbounded).
    """

    name = "slo"

    def __init__(self, *, age_ticks: int = 16, preempt: bool = True,
                 shed_deadline: bool = True, max_queue: int | None = None):
        if age_ticks < 0:
            raise ValueError(f"age_ticks must be >= 0, got {age_ticks}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.age_ticks = age_ticks
        self.preempt = preempt
        self.shed_deadline = shed_deadline
        self.max_queue = max_queue

    # ------------------------------------------------------------ ordering
    def effective_priority(self, req, now: int) -> int:
        """Priority class after aging: one class better per ``age_ticks``
        waited, floored at INTERACTIVE — the no-starvation mechanism."""
        prio = req_priority(req)
        if self.age_ticks <= 0:
            return prio
        waited = max(0, now - req.arrival)
        return max(0, prio - waited // self.age_ticks)

    def _key(self, req, now: int):
        return (self.effective_priority(req, now), req.arrival, req.rid)

    def admission_order(self, queue, now: int) -> list:
        return sorted((r for r in queue if r.arrival <= now),
                      key=lambda r: self._key(r, now))

    # ------------------------------------------------------------ shedding
    def sheds(self, queue, now: int) -> list:
        arrived = [r for r in queue if r.arrival <= now]
        out = []
        if self.shed_deadline:
            for r in arrived:
                dl = req_deadline(r)
                if dl is not None and now > dl and \
                        req_priority(r) >= int(PriorityClass.BEST_EFFORT):
                    out.append(r)
        if self.max_queue is not None:
            keep = [r for r in arrived if r not in out]
            excess = len(keep) - self.max_queue
            if excess > 0:
                # shed the worst-effective-priority tail, newest first
                worst = sorted(keep, key=lambda r: self._key(r, now))
                out.extend(worst[-excess:])
        return sorted(out, key=lambda r: (r.arrival, r.rid))

    # ------------------------------------------------------------ preemption
    def preemptions(self, waiting, occupants: dict, now: int) -> list:
        """Greedy matching, best waiting request first: evict the
        worst-effective-priority preemptible occupant that is STRICTLY
        worse than the waiting request. Strictness is the anti-thrash
        rule — an evicted request can never immediately evict back, and
        an occupant aged up to the contender's class is safe."""
        if not self.preempt:
            return []
        victims = []
        pool = sorted(
            ((slot, req) for slot, req in occupants.items()
             if req_preemptible(req)),
            key=lambda kv: self._key(kv[1], now), reverse=True)
        for w in waiting:
            w_prio = self.effective_priority(w, now)
            picked = None
            for slot, occ in pool:
                if slot in victims:
                    continue
                if self.effective_priority(occ, now) > w_prio:
                    picked = slot
                    break
            if picked is None:
                break       # nothing worse exists for a better contender
            victims.append(picked)
        return victims


def make_policy(name: str, **kw) -> SchedulingPolicy:
    """CLI/bench factory: ``fifo`` or ``slo`` (kwargs go to the policy)."""
    if name == "fifo":
        return FIFOPolicy()
    if name == "slo":
        return SLOPolicy(**kw)
    raise ValueError(f"unknown scheduling policy {name!r} "
                     "(want 'fifo' or 'slo')")


def deadline_met(req) -> bool | None:
    """Did the request make its TTFT deadline? None = no deadline set."""
    dl = req_deadline(req)
    if dl is None:
        return None
    if req.t_first is None:
        return False            # shed / never served: a miss by definition
    return req.t_first <= dl


def slo_report(requests) -> dict:
    """Per-class SLO summary over a run's finished + shed requests.

    Returns ``{class_name: {n, shed, ttft_ticks_p50/p95/p99,
    deadline_total, deadline_hits, deadline_hit_rate}}`` plus an
    ``"overall"`` entry. TTFT percentiles are in ticks — deterministic,
    immune to shared-CPU wall noise — and shed requests (no first token)
    are excluded from the percentiles but counted as deadline misses.
    """
    out = {}
    groups: dict = {}
    for r in requests:
        groups.setdefault(PriorityClass(req_priority(r)).name.lower(),
                          []).append(r)
    groups["overall"] = list(requests)

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    for name, reqs in groups.items():
        ttfts = [r.ttft for r in reqs if r.ttft is not None]
        met = [deadline_met(r) for r in reqs]
        met = [m for m in met if m is not None]
        out[name] = {
            "n": len(reqs),
            "shed": sum(1 for r in reqs
                        if getattr(r.state, "value", None) == "shed"),
            "ttft_ticks_p50": pct(ttfts, 50),
            "ttft_ticks_p95": pct(ttfts, 95),
            "ttft_ticks_p99": pct(ttfts, 99),
            "deadline_total": len(met),
            "deadline_hits": sum(met),
            "deadline_hit_rate": (sum(met) / len(met) if met
                                  else float("nan")),
        }
    return out
