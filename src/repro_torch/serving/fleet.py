"""Replica fleet supervision: heartbeats feed the admission scheduler (the
port of ``repro.serving.fleet``).

A serving deployment runs N data-parallel replicas, each an independent
:class:`~repro_torch.serving.engine.ServingEngine` behind a shared dispatcher.
This module is the dispatcher's control plane, built on the training
stack's fault-tolerance runtime:

* each replica heartbeats a :class:`~repro_torch.runtime.fault_tolerance
  .HeartbeatMonitor` (transport-injectable, so tests kill replicas with a
  fake clock; ``misses``/``rejoin_backoff_s`` expose its flap-tolerant
  SUSPECT window and rejoin probation);
* when replicas miss their deadline — ALL of them found by one poll, so
  simultaneous deaths fail over atomically — their queued AND in-flight
  requests are re-queued at the *front* of survivors' schedulers, merged
  in original arrival order. Slots are device state and died with the
  replica (its caches are freed with its session), but each request's
  committed-token **journal** survives: the engine re-admits the orphan
  with exact resume
  (:class:`~repro_torch.serving.engine.EngineSession`) and the merged stream is
  bit-identical to an undisturbed run;
* a replica that resumes beating after being declared dead REJOINS: the
  monitor's probation admits it back, the fleet re-plans the collective to
  *grow* over the rejoined set (the dual-root tree is parametric in p —
  shrink and grow are one code path), and queued work re-balances onto it;
* a replica whose decode produced non-finite logits is QUARANTINED
  (:meth:`ReplicaFleet.quarantine`): same failover path, but it is never
  allowed to rejoin — poisoned state does not re-enter the fleet;
* the stats-reduction topology is re-planned over the members via
  :func:`~repro_torch.runtime.fault_tolerance.plan_remesh` — the b=1
  dual-root tree re-forms over any subset, so the telemetry collective
  never blocks on a dead rank.

:class:`FleetRunner` closes the loop: it drives one
:class:`~repro_torch.serving.engine.EngineSession` per replica in a lockstep
tick simulation under a :class:`~repro_torch.runtime.chaos.FaultInjector`,
which is how the chaos tests, ``serve.py --chaos-seed`` and
``chip_smoke.py``'s phase 11 show zero token divergence through kill /
flap / rejoin / poison events.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.runtime.chaos import FaultInjector, FaultPlan, poison_slot
from repro_torch.runtime.fault_tolerance import (ElasticPlan,
                                                 HeartbeatMonitor,
                                                 HostFailure, plan_remesh)
from repro_torch.serving.engine import PoisonedLogits
from repro_torch.serving.request import RequestState
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.telemetry import STATS_FIELDS, TelemetryLog

__all__ = ["FailoverPlan", "ReplicaFleet", "FleetRunner"]


@dataclasses.dataclass(frozen=True)
class FailoverPlan:
    """What a membership event changes: who is gone (or back), what work
    moved, and the re-planned stats-reduction topology. One plan covers
    EVERY replica found dead by the same poll — simultaneous deaths fail
    over atomically — plus any replicas readmitted by the same poll."""
    dead: tuple                # replica ids found dead by this poll
    survivors: tuple           # fleet membership AFTER the event
    requeued: tuple            # request ids moved back to a queue front
    elastic: ElasticPlan
    rejoined: tuple = ()       # replica ids readmitted by this poll
    quarantined: tuple = ()    # replica ids quarantined (never rejoin)


class ReplicaFleet:
    """Tracks request placement across replicas and fails work over."""

    def __init__(self, n_replicas: int, *, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 comm_model: cm.CommModel = cm.PAPER_HYDRA,
                 misses: int = 1, rejoin_backoff_s: float = 0.0):
        if n_replicas < 2:
            raise ValueError("a fleet needs at least two replicas")
        self.monitor = HeartbeatMonitor(n_replicas, timeout_s, clock,
                                        misses=misses,
                                        rejoin_backoff_s=rejoin_backoff_s)
        self.comm_model = comm_model
        self._alive = list(range(n_replicas))
        self._placement: dict = {r: [] for r in self._alive}
        self._quarantined: set = set()

    @property
    def alive(self) -> tuple:
        return tuple(self._alive)

    @property
    def quarantined(self) -> tuple:
        return tuple(sorted(self._quarantined))

    def beat(self, replica: int) -> None:
        self.monitor.beat(replica)

    # ------------------------------------------------------------ placement
    def assign(self, req) -> int:
        """Least-loaded placement; returns the chosen replica."""
        replica = min(self._alive, key=lambda r: len(self._placement[r]))
        self._placement[replica].append(req)
        return replica

    def complete(self, replica: int, req) -> bool:
        """Mark ``req`` finished on ``replica``; returns whether the fleet
        still had it placed there. Tolerant of stale notifications — a
        completion racing a failover (the request already moved, or the
        replica already died) is a no-op, not a crash."""
        lst = self._placement.get(replica)
        if lst is None or req not in lst:
            return False
        lst.remove(req)
        return True

    def transfer(self, reqs, frm: int, to: int) -> None:
        """Move placement bookkeeping for ``reqs`` (queue re-balancing onto
        a rejoined replica; the caller moves the queue entries)."""
        for req in reqs:
            if req in self._placement.get(frm, ()):
                self._placement[frm].remove(req)
                self._placement[to].append(req)

    # ------------------------------------------------------------ failover
    def _replan(self) -> ElasticPlan:
        stats_bytes = float(len(STATS_FIELDS) * 4)
        return plan_remesh(tuple(self._alive), stats_bytes, self.comm_model)

    def _evict(self, replicas) -> list:
        """Remove ``replicas`` from the fleet; returns their merged orphans
        in original arrival order."""
        orphans = []
        for d in replicas:
            self.monitor.drop(d)
            self._alive.remove(d)
            orphans.extend(self._placement.pop(d))
        if not self._alive:
            raise HostFailure(replicas[0], "every replica failed",
                              hosts=tuple(replicas))
        orphans.sort(key=lambda r: (r.arrival, r.rid))
        return orphans

    def _requeue(self, orphans, schedulers) -> None:
        """Re-place orphans (least-loaded) and push them to the front of
        their target's queue — journals intact (exact resume). A single
        scheduler serves every orphan; a dict routes per placement."""
        if isinstance(schedulers, SlotScheduler):
            schedulers.requeue_front(orphans)
            for req in orphans:
                target = min(self._alive,
                             key=lambda r: len(self._placement[r]))
                self._placement[target].append(req)
            return
        groups: dict = {}
        for req in orphans:
            target = min(self._alive,
                         key=lambda r: len(self._placement[r]))
            self._placement[target].append(req)
            groups.setdefault(target, []).append(req)
        for target, group in groups.items():
            schedulers[target].requeue_front(group)

    def poll(self, schedulers) -> FailoverPlan | None:
        """Check heartbeats; on deaths, re-queue the dead replicas' work
        into survivors' schedulers and re-plan the stats collective; on
        resumed beats, readmit rejoinable replicas and re-plan to GROW.

        ``schedulers`` is a single survivor :class:`SlotScheduler` (every
        orphan lands there) or a ``{replica: scheduler}`` dict (orphans
        land on their newly-placed replica's scheduler). Returns the
        :class:`FailoverPlan`, or None while membership is unchanged.
        Never raises on a survivable failure — serving degrades, it does
        not stop (losing EVERY replica is not survivable and raises).

        All replicas past their deadline are handled by ONE poll: their
        orphan sets are merged and re-queued in original arrival order
        (``SlotScheduler.requeue_front`` sorts), each orphan is re-placed
        exactly once, and only onto replicas that are still alive AFTER the
        whole death set is known. Handling one death per poll — the old
        behavior — could re-place orphans onto a replica that was already
        dead but not yet detected, and the next poll would then re-queue
        them a second time: duplicate queue entries and a scrambled order.
        Orphans are re-queued BEFORE rejoins are admitted, so failed-over
        work never lands on a replica whose fresh session does not exist
        yet.
        """
        dead = self.monitor.dead_hosts()
        orphans = []
        if dead:
            orphans = self._evict(dead)
            self._requeue(orphans, schedulers)
        rejoined = []
        for r in self.monitor.rejoinable():
            if r in self._quarantined:
                continue          # poisoned state never re-enters the fleet
            self.monitor.readmit(r)
            self._alive.append(r)
            self._alive.sort()
            self._placement[r] = []
            rejoined.append(r)
        if not dead and not rejoined:
            return None
        return FailoverPlan(tuple(dead), tuple(self._alive),
                            tuple(r.rid for r in orphans), self._replan(),
                            rejoined=tuple(rejoined))

    def quarantine(self, replica: int, schedulers) -> FailoverPlan:
        """Evict a replica whose decode produced poisoned logits and fail
        its work over (journals intact — the poisoned tick committed
        nothing, see :class:`~repro_torch.serving.engine.PoisonedLogits`). The
        replica keeps beating but is barred from rejoin for good."""
        if replica not in self._alive:
            raise ValueError(f"replica {replica} is not alive")
        self._quarantined.add(replica)
        orphans = self._evict([replica])
        self._requeue(orphans, schedulers)
        return FailoverPlan((), tuple(self._alive),
                            tuple(r.rid for r in orphans), self._replan(),
                            quarantined=(replica,))


class FleetRunner:
    """Lockstep fleet simulation: one :class:`EngineSession` per replica,
    sharing ONE engine's steps and weights (sessions own their caches,
    schedulers and sampler state), advanced tick-by-tick under
    a :class:`~repro_torch.runtime.chaos.FaultInjector` and the
    :class:`ReplicaFleet` control plane.

    Each tick: healthy replicas heartbeat (a silenced one — killed or
    flapping — does not), the fleet polls for deaths and rejoins, poison
    faults NaN a replica's busiest cache rows, straggling replicas skip
    their share of ticks, and every surviving session advances one engine
    iteration. A session that raises
    :class:`~repro_torch.serving.engine.PoisonedLogits` is quarantined on the
    spot. Requests failed over mid-flight resume EXACTLY (bit-identical
    streams) via their committed-token journals; a rejoining replica gets
    a fresh session and steals queued work from the most-loaded survivor.

    The virtual clock is the tick counter itself — ``timeout_s`` and
    ``rejoin_backoff_s`` are measured in ticks here — which is what makes
    every chaos scenario a pure function of ``(plan, workload)``. The
    default ``comm_model`` is the port's ``PAPER_HYDRA`` (the reference's
    is its TPU preset).
    """

    def __init__(self, engine, n_replicas: int, *,
                 plan: FaultPlan | None = None, timeout_s: float = 2.0,
                 misses: int = 1, rejoin_backoff_s: float = 0.0,
                 comm_model: cm.CommModel = cm.PAPER_HYDRA):
        self.engine = engine
        self.n_replicas = n_replicas
        self.now = 0
        # the monitor reads the tick through a weak reference: a cycle
        # through its clock would keep a dropped runner's sessions, and
        # their device caches, alive until the next garbage collection
        me = weakref.ref(self)
        self.fleet = ReplicaFleet(
            n_replicas, timeout_s=timeout_s, misses=misses,
            rejoin_backoff_s=rejoin_backoff_s, comm_model=comm_model,
            clock=lambda: float(me().now))
        self.injector = FaultInjector(plan) if plan is not None else None
        self.sessions = {r: engine.start() for r in range(n_replicas)}
        for r, s in self.sessions.items():
            s.trace_replica = r     # trace events carry the replica id
        self.finished: list = []
        self._harvested = {r: 0 for r in range(n_replicas)}
        self.log = TelemetryLog()   # host-side sum over replica rows
        self.events: list = []      # closed failover/rejoin/quarantine dicts
        self._open: list = []       # recovery tracking: [(tick, [(req, m)])]
        self._rejoins = 0

    # ------------------------------------------------------------ internals
    def _scheds(self) -> dict:
        return {r: s.sched for r, s in self.sessions.items()}

    def _harvest(self, replica: int) -> None:
        """Collect newly-finished requests off a session (and release the
        fleet's placement entry for each)."""
        sess = self.sessions[replica]
        done = sess.sched.finished
        for req in done[self._harvested[replica]:]:
            self.fleet.complete(replica, req)
            self.finished.append(req)
        self._harvested[replica] = len(done)

    def _discard(self, replica: int) -> None:
        self._harvest(replica)
        del self.sessions[replica]
        del self._harvested[replica]

    def _track(self, plan: FailoverPlan) -> None:
        """Record the event; open recovery tracking for requeued work."""
        self.events.append({
            "tick": self.now, "dead": list(plan.dead),
            "rejoined": list(plan.rejoined),
            "quarantined": list(plan.quarantined),
            "requeued": list(plan.requeued), "p": plan.elastic.new_p})
        moved = [req for r in self.fleet.alive
                 for req in self.fleet._placement[r]
                 if req.rid in plan.requeued]
        if moved:
            self._open.append((self.now, [(req, len(req.tokens))
                                          for req in moved]))
            for req in moved:
                req.failovers += 1
        tr = self.engine.tracer
        if tr is not None:
            # one engine-lane event per dead/quarantined replica, plus one
            # per orphan on the replica that inherited it (placement has
            # already moved), carrying the journal the exact resume will
            # replay.
            for d in list(plan.dead) + list(plan.quarantined):
                tr.event("failover", self.now, replica=d,
                         quarantined=d in plan.quarantined,
                         requeued=len(plan.requeued),
                         new_p=plan.elastic.new_p)
            for r in self.fleet.alive:
                for req in self.fleet._placement[r]:
                    if req.rid in plan.requeued:
                        tr.event("failover", self.now, rid=req.rid,
                                 replica=r,
                                 journal_tokens=len(req.tokens),
                                 new_p=plan.elastic.new_p)

    def _close_recovered(self) -> None:
        """A failover event is recovered when every orphan has committed a
        token PAST its journal (or finished); the gap is recovery ticks."""
        still = []
        for tick, entries in self._open:
            if all(len(req.tokens) > m or req.done for req, m in entries):
                self.events.append({"tick": self.now,
                                    "recovery_ticks": self.now - tick})
            else:
                still.append((tick, entries))
        self._open = still

    def _rebalance(self, replica: int) -> None:
        """Give a rejoined replica a fresh session and steal queued work
        from the most-loaded survivor (half its queue, FIFO preserved)."""
        self.sessions[replica] = self.engine.start()
        self.sessions[replica].trace_replica = replica
        self._harvested[replica] = 0
        self._rejoins += 1
        donors = [r for r in self.fleet.alive if r != replica
                  and r in self.sessions]
        if not donors:
            return
        donor = max(donors, key=lambda r: self.sessions[r].sched.queue_depth)
        depth = self.sessions[donor].sched.queue_depth
        stolen = self.sessions[donor].sched.steal_queued((depth + 1) // 2)
        for req in stolen:
            self.sessions[replica].sched.submit(req)
        self.fleet.transfer(stolen, donor, replica)

    # ------------------------------------------------------------ driving
    def run(self, requests, *, max_ticks: int = 100_000) -> dict:
        """Serve ``requests`` across the fleet to completion under the
        fault plan; returns a fleet-level telemetry report."""
        t0 = time.perf_counter()
        total = 0
        for req in requests:
            replica = self.fleet.assign(req)
            self.sessions[replica].submit(req)
            total += 1
        while len(self.finished) < total:
            if self.now >= max_ticks:
                raise RuntimeError(
                    f"fleet stalled after {max_ticks} ticks "
                    f"({len(self.finished)}/{total} requests done)")
            self.tick()
        report = self.report(time.perf_counter() - t0)
        return report

    def tick(self) -> None:
        """Advance the whole fleet by one tick (see class docstring)."""
        now, inj = self.now, self.injector
        failovers = 0
        quarantines = 0
        # heartbeats: every replica whose process is not stalled beats —
        # including dropped ones (resumed beats are what earn a rejoin)
        for r in range(self.n_replicas):
            if r in self.fleet._quarantined:
                continue
            if inj is None or not inj.silenced(now, r):
                self.fleet.beat(r)
        # membership: deaths evict sessions (orphans re-queue with their
        # journals); rejoins get fresh sessions + a share of queued work
        plan = self.fleet.poll(self._scheds())
        if plan is not None:
            for d in plan.dead:
                self._discard(d)
            failovers += len(plan.requeued)
            for r in plan.rejoined:
                self._rebalance(r)
            self._track(plan)
        # poison: NaN the victim's ACTIVE slots only — prefilling slots
        # have not reached the guarded decode path yet
        if inj is not None:
            for r in list(self.fleet.alive):
                if not inj.poisons(now, r):
                    continue
                sess = self.sessions[r]
                for slot, req in sess.sched.active.items():
                    if req.state is RequestState.ACTIVE:
                        sess.caches = poison_slot(sess.caches, slot)
        # advance every live session (stragglers skip their share of ticks
        # but keep beating — slow is not dead)
        rows = []
        for r in list(self.fleet.alive):
            if inj is not None and inj.skips_tick(now, r):
                continue
            sess = self.sessions[r]
            if not sess.running:
                continue
            try:
                rows.append(sess.tick())
            except PoisonedLogits:
                # the poisoned tick committed nothing: quarantine the
                # replica and fail its work over with exact resume
                qplan = self.fleet.quarantine(r, self._scheds())
                self._discard(r)
                failovers += len(qplan.requeued)
                quarantines += 1
                self._track(qplan)
            else:
                self._harvest(r)
        row = (np.sum(np.asarray(rows, np.float32), axis=0) if rows
               else np.zeros(len(STATS_FIELDS), np.float32))
        row[STATS_FIELDS.index("failovers")] += failovers
        row[STATS_FIELDS.index("quarantines")] += quarantines
        self.log.step(now, row)
        self._close_recovered()
        self.now += 1

    # ------------------------------------------------------------ reporting
    def report(self, wall_s: float) -> dict:
        report = self.log.report(self.finished, wall_s, self.now)
        report["mode"] = "fleet"
        report["n_replicas"] = self.n_replicas
        report["tokens"] = {r.rid: list(r.tokens) for r in self.finished}
        for field in ("sampled_tokens", "prefill_chunks", "drafted_tokens",
                      "accepted_tokens", "resumed_tokens", "failovers",
                      "quarantines", "preemptions", "shed_requests",
                      "deadline_misses"):
            report[field] = int(sum(getattr(s, field)
                                    for s in self.log.steps))
        report["rejoins"] = self._rejoins
        report["alive"] = list(self.fleet.alive)
        report["quarantined"] = list(self.fleet.quarantined)
        report["events"] = list(self.events)
        report["recovery_ticks"] = [e["recovery_ticks"] for e in self.events
                                    if "recovery_ticks" in e]
        return report
