"""Admission scheduling: pack queued requests into KV-cache slots (the
port of ``repro.serving.scheduler``, copied).

The scheduler owns the queue and the slot table; the engine owns the device
caches; a pluggable :class:`~repro_torch.serving.slo.SchedulingPolicy` owns the
*decisions* (who admits next, who is shed, who is preempted). Invariants
(tested in tests/test_serving.py and tests/test_scheduling_props.py):

* **no double-booking** — a slot holds at most one PREFILLING/ACTIVE
  request, and a request at most one slot — under any policy, any
  interleaving of admit/preempt/release;
* **policy-faithful admission** — ``admit`` grants free slots to exactly
  the prefix of ``policy.admission_order``: the default
  :class:`~repro_torch.serving.slo.FIFOPolicy` keeps the FIFO semantics (strict
  queue order; a request that has not arrived yet blocks everything behind
  it — no skip-ahead, so a long-prompt request cannot starve), while
  :class:`~repro_torch.serving.slo.SLOPolicy` orders by aged priority so a
  ready higher-priority request is never skipped and no class starves;
* **freed-slot reuse** — releasing (or preempting) a slot makes it
  immediately admissible again, with no device-side reallocation;
* **journaled eviction** — ``preempt`` and ``requeue_front`` keep the
  request's committed-token journal and first-token timestamp, so
  re-admission resumes the stream bit-identically (docs/robustness.md,
  docs/scheduling.md).

The ``batch_sync`` admission mode is the classic static-batching policy the
benchmark compares against: wait until the *next whole batch* of requests
has arrived AND every slot is free, then admit all of them at once. It is
defined only for the FIFO reference policy.
"""

from __future__ import annotations

from collections import deque

from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.slo import FIFOPolicy, SchedulingPolicy

__all__ = ["SlotScheduler"]


class SlotScheduler:
    """Queue + slot table for one serving replica."""

    def __init__(self, n_slots: int, policy: SchedulingPolicy | None = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.policy = policy if policy is not None else FIFOPolicy()
        self._queue: deque = deque()
        self._slots: list = [None] * n_slots     # slot -> Request | None
        self._finished: list = []
        self._shed: list = []
        # observability (queue 1's item 6): the engine session re-stamps these
        # every tick so shed/preempt decisions trace at the decision site;
        # None = tracing off (the default, one is-None check per event).
        self.tracer = None
        self.trace_replica = 0

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        if req.state is not RequestState.QUEUED:
            raise ValueError(f"request {req.rid} is {req.state}, not QUEUED")
        self._queue.append(req)

    def requeue_front(self, reqs, exact: bool = True) -> None:
        """Push failed-over requests at the FRONT of the queue (fleet
        failover: a dead replica's work must not lose its place in line).
        Slots are device state and died with the replica, but by default
        (``exact=True``) each request KEEPS its committed-token journal
        (``req.tokens``) and first-token timestamp: the engine re-admits it
        through the chunked-prefill machinery over ``prompt + committed``
        and the merged stream is bit-identical to an undisturbed run
        (docs/robustness.md). ``exact=False`` is the legacy lossy restart —
        the journal is discarded and generation restarts from the prompt.
        Under prefix caching the engine runs its trie lookup on that same
        normalized history at re-admission, so a preempted/failed-over
        request re-adopts its own earlier boundary snapshots instead of
        re-prefilling them (docs/prefix_caching.md) — the requeue itself
        stays cache-oblivious.

        Requests are re-queued in their ORIGINAL arrival order (ties by
        rid), not in the caller's iteration order: when several replicas
        die in one poll their orphan sets arrive merged, and interleaving
        them by replica would let a later-arriving request overtake an
        earlier one it never legitimately passed.
        """
        ordered = sorted(reqs, key=lambda r: (r.arrival, r.rid))
        for req in reversed(ordered):
            req.state = RequestState.QUEUED
            req.slot = None
            req.prefilled = 0
            req.t_admit = req.t_done = None
            if not exact or not req.tokens:
                req.tokens = []
                req.t_first = None
            self._queue.appendleft(req)

    def steal_queued(self, n: int) -> list:
        """Pop up to ``n`` requests from the BACK of the queue (the ones
        admitted last anyway) for re-balancing onto a rejoined replica.
        FIFO order is preserved both here and among the stolen set —
        nothing overtakes anything; work just changes lanes."""
        out = []
        while self._queue and len(out) < n:
            out.append(self._queue.pop())
        out.reverse()
        return out

    # ------------------------------------------------------------ queries
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def free_slots(self) -> list:
        return [i for i, r in enumerate(self._slots) if r is None]

    @property
    def active(self) -> dict:
        """slot -> Request for every occupied slot."""
        return {i: r for i, r in enumerate(self._slots) if r is not None}

    @property
    def finished(self) -> list:
        return list(self._finished)

    @property
    def shed_requests(self) -> list:
        """Requests the policy dropped unserved (state SHED)."""
        return list(self._shed)

    @property
    def pending(self) -> bool:
        return bool(self._queue)

    def arrived_depth(self, now: int) -> int:
        """Queued requests that have arrived by ``now`` (telemetry's queue
        depth: work that is actually waiting, not future arrivals)."""
        return sum(1 for r in self._queue if r.arrival <= now)

    # ------------------------------------------------------------ admission
    def admit(self, now: int, batch_sync: bool = False) -> list:
        """Grant free slots to arrived requests in the policy's admission
        order; returns [(slot, request)]. ``batch_sync`` is the static-
        batching reference policy (see module docstring; FIFO only).
        """
        if batch_sync:
            if not isinstance(self.policy, FIFOPolicy):
                raise ValueError(
                    "batch_sync (static batching) is defined only for the "
                    f"FIFO reference policy, not {self.policy.name!r}")
            if len(self.free_slots) < self.n_slots:
                return []                     # a batch in flight: wait it out
            k = min(self.n_slots, len(self._queue))
            if k == 0 or any(self._queue[i].arrival > now for i in range(k)):
                return []                     # wait for the full batch
        out = []
        free = deque(self.free_slots)
        for req in self.policy.admission_order(list(self._queue), now):
            if not free:
                break
            self._queue.remove(req)
            slot = free.popleft()
            assert self._slots[slot] is None, "slot double-booked"
            assert req.slot is None, f"request {req.rid} already has a slot"
            # the engine promotes PREFILLING -> ACTIVE when the final prompt
            # chunk lands and the first token is emitted
            req.state = RequestState.PREFILLING
            req.slot = slot
            req.t_admit = now
            self._slots[slot] = req
            out.append((slot, req))
        return out

    # ------------------------------------------------------------ SLO hooks
    def shed(self, now: int) -> list:
        """Drop the queued requests the policy declines to serve (hopeless
        deadlines, overload). Shed requests never held a slot; they leave
        the queue in SHED state and are reported separately from finished
        work. Returns the shed requests."""
        victims = self.policy.sheds(list(self._queue), now)
        for req in victims:
            self._queue.remove(req)
            req.state = RequestState.SHED
            req.t_done = now
            req.slot = None
            self._shed.append(req)
            if self.tracer is not None:
                self.tracer.event("shed", now, rid=req.rid,
                                  replica=self.trace_replica,
                                  waited_ticks=now - req.arrival,
                                  deadline=req.deadline)
        return victims

    def plan_preemptions(self, now: int) -> list:
        """Slots the policy wants evicted for arrived waiting work that the
        free slots cannot cover. Pure planning — the ENGINE must perform
        the eviction (it owns the device-side slot reset) and then call
        :meth:`preempt` per victim."""
        order = self.policy.admission_order(list(self._queue), now)
        waiting = order[len(self.free_slots):]
        if not waiting:
            return []
        return self.policy.preemptions(waiting, self.active, now)

    def preempt(self, slot: int, now: int) -> Request:
        """Evict the slot's request back into the queue — journal and
        first-token timestamp intact, so its eventual re-admission resumes
        the stream bit-identically through the exact-resume machinery
        (same contract as failover's ``requeue_front``, which this reuses:
        the requeue position is deterministic — arrival order for FIFO,
        and irrelevant under SLOPolicy, whose admission_order re-sorts the
        queue every tick). Returns the evicted request."""
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        self._slots[slot] = None
        req.preemptions += 1
        if self.tracer is not None:
            self.tracer.event("preempt", now, rid=req.rid,
                              replica=self.trace_replica, slot=int(slot),
                              journal_tokens=len(req.tokens),
                              preemptions=req.preemptions)
        self.requeue_front([req])
        return req

    # ------------------------------------------------------------ release
    def release(self, slot: int, now: int) -> Request:
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        req.state = RequestState.DONE
        req.t_done = now
        req.slot = None
        self._slots[slot] = None
        self._finished.append(req)
        return req

    def drain_active(self) -> list:
        """Evict every in-flight request (replica failover): clear the slot
        table and return the requests for re-queueing elsewhere."""
        out = [r for r in self._slots if r is not None]
        self._slots = [None] * self.n_slots
        for r in out:
            r.slot = None
        return out
