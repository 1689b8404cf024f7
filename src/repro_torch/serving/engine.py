"""Continuous-batching serving engine on per-slot caches (the port of
``repro.serving.engine``).

The engine owns the steps built by :mod:`repro_torch.launch.step_fns`:

* a cache-writing **prefill** step, one call per prompt CHUNK, that runs
  the chunk as a single row on views of the request's slot, so its K/V
  lands in the slot in place while every other slot stays bit-unchanged,
  and on the final chunk emits the request's first token (the seeded
  sampler's draw, greedy by default);
* a slot-aware **decode** step that advances every busy slot by one token
  a tick; free and prefilling slots write nothing and keep their
  positions;
* when requests opt into speculative decoding (``Request.spec``), a
  slot-aware **verify** step (one per draft budget) that scores each
  slot's draft proposals in one pass and advances every busy slot by the
  accepted length: up to k+1 tokens a tick, streams bit-identical to plain
  decoding, the rejected drafts' ring writes restored
  (:mod:`repro_torch.serving.speculative`).

Prompts longer than ``prefill_chunk`` are split into chunks fed one per
tick, interleaved with in-flight decode. Chunking is a pure function of
the prompt length and the engine constants, never of scheduling, so
continuous and static runs chunk identically and greedy streams are
bit-identical across policies. A slot is freed by zeroing its row and its
positions, so a finished request's slot is admissible again on the next
tick. With ``prefix_cache=True`` an admission whose history shares a
cached chunk-grid boundary with an earlier one adopts that boundary's row
(:mod:`repro_torch.serving.prefix`) and prefills only from the first
divergent chunk. Under the SLO policy (:mod:`repro_torch.serving.slo`)
queued requests may be shed and running ones preempted; a preempted
request keeps its journal and resumes exactly. Time runs on two clocks:
ticks (one loop iteration; arrival, TTFT and latency are counted in
ticks) and wall seconds (throughput). ``run(..., static=True)`` runs the
batch-synchronous reference policy through the same steps.

The tracer and the live metrics (:mod:`repro_torch.obs`) are optional
sinks, read each tick, so they may attach mid-run; every hook is one
``is None`` check when they are off, and they never feed back into the
tokens. Tensor parallelism is not ported yet and is refused with its
ROADMAP item (item 4).
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.transport import host_to, resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.serving import sampling
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.slo import slo_report
from repro_torch.serving.speculative import (AdaptiveDraftController,
                                             NgramDrafter, SpecParams,
                                             drafter_label)
from repro_torch.serving.telemetry import (STATS_FIELDS, TelemetryLog,
                                           stats_vector)

__all__ = ["ServingEngine", "EngineSession", "PoisonedLogits"]

_ITEM_4 = "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)"


def _pow2_at_least(n: int, floor: int) -> int:
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


class ServingEngine:
    """Continuous-batching decode engine for one replica on one device.

    ``n_slots`` is the cache batch (concurrent requests); ``max_len`` the
    per-slot ring length. ``prefill_chunk`` bounds how much prompt one
    prefill call writes (default: the largest single call the cache
    geometry allows); longer prompts stream in a chunk a tick.
    ``stats_reducer`` (:func:`repro_torch.serving.telemetry
    .make_stats_reducer`) sums the per-tick stats across replicas; None is
    one replica. ``params`` lie on ``device`` (CUDA unless named).

    ``drafter`` serves requests that opt into speculative decoding through
    ``Request.spec`` (a :class:`~repro_torch.serving.speculative
    .SpecParams`). Default: a :class:`~repro_torch.serving.speculative
    .NgramDrafter`, made when the first such request is submitted; a
    :class:`~repro_torch.serving.speculative.DraftModelDrafter` with this
    engine's ``n_slots`` drafts with a second model.

    ``draft_headroom`` widens window/chunk-bounded attention rings by that
    many slots (``init_cache(ring_slack=)``): a k-draft verify call writes
    k+1 tokens at once, and without the slack its later writes would wrap a
    window-sized ring over positions its earliest queries still read.
    Full-attention rings are never widened. Requests may speculate up to
    ``draft_k == draft_headroom`` on bounded rings. Default
    ``SpecParams().draft_k``.

    ``prefix_cache=True`` turns on cross-request prefix caching: each
    session keeps a trie of slot rows snapshotted at prefill-chunk-grid
    boundaries (:func:`repro_torch.models.transformer.extract_cache_row`),
    and an admission whose history shares a cached boundary adopts that row
    (:func:`~repro_torch.models.transformer.adopt_prefix`) and prefills
    only from the first divergent chunk. Streams stay bit-identical to cold
    prefill under every policy. ``prefix_cache_nodes`` bounds the trie (LRU
    eviction; nodes pinned by in-flight admissions are never evicted). With
    the prefix cache on and the default drafter, the trie is also the
    drafter's shared n-gram corpus.

    Observability (:mod:`repro_torch.obs`), all optional and all read each
    tick, so a tracer or metrics object may attach mid-run (after an
    untraced baseline, say): ``tracer`` an :class:`~repro_torch.obs.Tracer`
    event sink (pure observation); ``metrics`` a
    :class:`~repro_torch.obs.StreamingMetrics`, whose TTFT and latency
    histogram increments ride the per-tick stats row (the same b=1
    reduction, a wider payload); ``metrics_every`` emits a live snapshot
    every N ticks (0 is off) to ``metrics_sink(tick, snapshot)`` and to the
    tracer as a ``metrics`` event."""

    def __init__(self, cfg, pcfg: ParallelConfig | None, params, *,
                 n_slots: int = 4, max_len: int = 128,
                 min_prefill_bucket: int = 16,
                 prefill_chunk: int | None = None, stats_reducer=None,
                 drafter=None, draft_headroom: int | None = None,
                 prefix_cache: bool = False, prefix_cache_nodes: int = 256,
                 device=None, tracer=None, metrics=None,
                 metrics_every: int = 0, metrics_sink=None):
        if not tf.supports_slot_serving(cfg):
            raise ValueError(
                f"{cfg.name}: slot serving needs input_mode='tokens' and no "
                "encoder stack (stub-embed / encoder-decoder frontends have "
                "no token prompts to prefill)")
        if pcfg is not None and pcfg.tp_shards > 1:
            raise NotImplementedError(
                f"tensor-parallel serving is not ported yet: {_ITEM_4}")
        self.cfg, self.pcfg = cfg, pcfg
        self.device = resolve_device(device)
        self.n_slots, self.max_len = n_slots, max_len
        self.cache_kinds = tf.cache_layer_kinds(cfg)
        self._has_attn = "attn" in self.cache_kinds
        # longest single prefill or verify CALL: every attention sublayer
        # must fit the call in its (possibly window/chunk-bounded) ring;
        # longer prompts are chunked across calls, not rejected
        s_min = tf.prefill_call_bound(cfg, max_len)
        self.max_prompt_len = s_min
        # the speculative in-call wrap hazard exists only where a ring is
        # narrower than the absolute-position capacity _check enforces
        self._bounded_ring = s_min < max_len
        if draft_headroom is None:
            draft_headroom = SpecParams().draft_k
        self.draft_headroom = max(0, int(draft_headroom))
        self.prefill_chunk = (s_min if prefill_chunk is None
                              else min(prefill_chunk, s_min))
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.min_prefill_bucket = min(min_prefill_bucket, s_min)
        self._decode = step_fns.make_serve_step(cfg, pcfg, slots=True)
        self._prefill = step_fns.make_prefill_step(cfg, pcfg,
                                                   into_slots=True)
        self._verify_steps: dict = {}   # draft budget K -> verify step
        self.params = params
        self.caches = None            # allocated per run
        self.stats_reducer = stats_reducer
        self.drafter = drafter
        self.tracer = tracer
        self.metrics = metrics
        self.metrics_every = int(metrics_every)
        self.metrics_sink = metrics_sink
        self.prefix_enabled = bool(prefix_cache)
        self.prefix_cache_nodes = int(prefix_cache_nodes)
        if self.prefix_enabled and self.prefix_cache_nodes < 1:
            raise ValueError(f"prefix_cache_nodes must be >= 1, got "
                             f"{prefix_cache_nodes}")

    # ---------------------------------------------------------------- admin
    def _bucket(self, prompt_len: int) -> int:
        return min(_pow2_at_least(prompt_len, self.min_prefill_bucket),
                   self.max_prompt_len)

    def _check(self, req: Request) -> None:
        if self._has_attn and \
                len(req.prompt) + req.max_new_tokens > self.max_len:
            # ring capacity is absolute-position bound for full attention
            raise ValueError(
                f"request {req.rid}: prompt+generation "
                f"{len(req.prompt) + req.max_new_tokens} exceeds cache "
                f"length {self.max_len}")
        if req.spec is not None:
            if not tf.supports_speculation(self.cfg):
                raise ValueError(
                    f"request {req.rid}: {self.cfg.name} has a cached "
                    "sublayer without a verify rollback rule "
                    "(supports_speculation)")
            if self._bounded_ring and req.spec.draft_k > self.draft_headroom:
                raise ValueError(
                    f"request {req.rid}: draft_k {req.spec.draft_k} exceeds "
                    f"the engine's draft_headroom {self.draft_headroom} — on "
                    "window/chunk-bounded rings a wider verify call would "
                    "overwrite live window positions")

    def _get_verify(self, draft_k: int):
        """The verify step for draft budget K (one per K; the adaptive
        controller varies k per request within K through ``n_draft``)."""
        if draft_k not in self._verify_steps:
            self._verify_steps[draft_k] = step_fns.make_verify_step(
                self.cfg, self.pcfg, draft_k,
                ring_slack=self.draft_headroom)
        return self._verify_steps[draft_k]

    def _chunk_plan(self, prompt, start: int = 0) -> list:
        """Split a prompt into prefill chunks: a pure function of the
        prompt length and the engine constants (never of scheduling), so
        every policy chunks identically and token streams match.
        ``start`` (a multiple of ``prefill_chunk``: prefix lookups return
        chunk-grid boundaries only) skips tokens adopted from the prefix
        trie; the remaining chunks are the cold plan's tail, so a warm
        admission feeds ``ceil((len - start) / prefill_chunk)`` chunks."""
        c = self.prefill_chunk
        return [prompt[i:i + c] for i in range(start, len(prompt), c)]

    # ---------------------------------------------------------------- run
    def start(self, requests=(), *, static: bool = False,
              policy=None) -> "EngineSession":
        """Open an :class:`EngineSession`, the tick-stepping form of
        :meth:`run`. It owns its caches, scheduler, prefix trie and sampler
        state; more requests may be submitted while it runs. ``policy`` is
        a :class:`~repro_torch.serving.slo.SchedulingPolicy` (None is the
        FIFO reference). The caches a previous :meth:`run` left in
        ``self.caches`` are dropped first, so two runs never hold two
        sets."""
        self.caches = None
        return EngineSession(self, requests, static=static, policy=policy)

    def run(self, requests, *, static: bool = False,
            max_ticks: int = 100_000, policy=None) -> dict:
        """Serve ``requests`` to completion; returns the telemetry report.

        ``static=True`` runs the batch-synchronous reference policy (admit
        only full batches into an all-free slot table) through the same
        steps. Token streams are identical either way, and under any
        ``policy``: each row's computation depends only on its own request,
        chunk plans and sampler keys only on the request itself, and a
        preempted request resumes exactly from its journal, so policies
        change WHEN tokens land, never WHAT."""
        session = self.start(requests, static=static, policy=policy)
        while session.running:
            if session.now >= max_ticks:
                raise RuntimeError(f"serving stalled after {max_ticks} ticks")
            session.tick()
        self.caches = session.caches
        return session.report()


class PoisonedLogits(RuntimeError):
    """Raised by a session when a decode tick produced non-finite logits for
    one or more active slots (the step's ``-1`` sentinel). No token of the
    tick was committed: every affected request's journal still ends at its
    last good token."""

    def __init__(self, slots, rids):
        self.slots = tuple(slots)
        self.rids = tuple(rids)
        super().__init__(
            f"non-finite decode logits in slots {self.slots} "
            f"(requests {self.rids}); tick not committed")


class EngineSession:
    """One serving run in progress, advanced one :meth:`tick` at a time.

    Exact resume: a request admitted with a non-empty committed-token
    journal (``req.tokens``: a preempted request's, or one re-submitted
    with it) is re-prefilled over ``prompt + tokens[:-1]`` through the
    ordinary chunked admission (with the prefix cache on, it first adopts
    the longest cached boundary of that history, often its own); the
    prefill's token is discarded (the journal is authoritative), and decode
    resumes feeding ``tokens[-1]`` at sampler cursor ``len(tokens)``, so the
    stream is the undisturbed one for greedy and sampled requests alike. On
    window/chunk-bounded rings a resume restarts from the prompt instead
    (those rings keep chunk-plan determinism only).

    Speculative requests share the engine's one drafter slot table; run
    several concurrent sessions only with ``spec=None`` requests."""

    def __init__(self, engine: ServingEngine, requests=(), *,
                 static: bool = False, policy=None):
        if static and policy is not None and policy.name != "fifo":
            raise ValueError(
                "static batching is the batch-synchronous FIFO reference; "
                f"it is not defined for policy {policy.name!r}")
        self.engine = engine
        self.static = static
        self.sched = SlotScheduler(engine.n_slots, policy=policy)
        self.k_run = 0
        self._ctrls: dict = {}
        self.caches = tf.init_cache(engine.cfg, engine.n_slots,
                                    engine.max_len, device=engine.device,
                                    per_slot=True,
                                    ring_slack=engine.draft_headroom)
        self.last = np.zeros(engine.n_slots, np.int64)
        self.samp = sampling.slot_arrays(engine.n_slots)
        self.pending_chunks: dict = {}   # slot -> remaining prompt chunks
        self._resume_last: dict = {}     # slot -> journal tail to re-feed
        # the prefix trie is session state; pins hold in-flight adoptions
        # against LRU eviction, and _prefix_hist keeps each prefilling
        # slot's normalized history so boundary snapshots key on
        # history[:p] even after req.tokens grows
        self.prefix = (PrefixCache(grid=engine.prefill_chunk,
                                   max_nodes=engine.prefix_cache_nodes)
                       if engine.prefix_enabled else None)
        self._prefix_pins: dict = {}     # slot -> pinned trie key
        self._prefix_hist: dict = {}     # slot -> normalized history tuple
        self.log = TelemetryLog(engine.stats_reducer)
        self.now = 0
        self.decode_ticks = 0            # ticks that ran the decode step
        self.verify_ticks = 0            # ticks that ran the verify step
        self._t0 = time.perf_counter()
        # observability: the replica this session's trace events carry (the
        # fleet runner stamps it), and this tick's TTFT and latency
        # observations for the streaming histograms
        self.trace_replica = 0
        self._tick_ttfts: list = []
        self._tick_lats: list = []
        if self.prefix is not None:
            # through a weak reference: a cycle through the trie's hook
            # would hold the session's caches past its last use
            session = weakref.ref(self)
            self.prefix.on_event = (
                lambda name, **attrs: session()._prefix_event(name, **attrs))
        if self.prefix is not None and isinstance(engine.drafter,
                                                  NgramDrafter) \
                and engine.drafter.corpus is None:
            engine.drafter.corpus = self.prefix
        for req in requests:
            self.submit(req)

    def submit(self, req) -> None:
        """Queue one more request."""
        eng = self.engine
        eng._check(req)
        if req.spec is not None:
            if eng.drafter is None:
                eng.drafter = NgramDrafter()
                if self.prefix is not None:
                    # the trie doubles as the shared n-gram corpus
                    eng.drafter.corpus = self.prefix
            if getattr(eng.drafter, "n_slots", eng.n_slots) != eng.n_slots:
                raise ValueError(
                    "drafter slot table does not match the engine "
                    f"({eng.drafter.n_slots} != {eng.n_slots})")
            # one verify width per session: the largest requested draft
            # budget, bounded so a verify call never exceeds the per-call
            # ring limit (T <= S, as for prefill chunks)
            self.k_run = min(max(self.k_run, req.spec.draft_k),
                             eng.max_prompt_len - 1)
        self.sched.submit(req)

    @property
    def running(self) -> bool:
        return self.sched.pending or bool(self.sched.active)

    def _release(self, slot: int, req, freed) -> None:
        """Free a finished request's slot (and its drafter slot and
        controller)."""
        self.sched.release(slot, self.now)
        freed[slot] = True
        if req.latency is not None:
            self._tick_lats.append(req.latency)
        tr = self.engine.tracer
        if tr is not None:
            tr.event("commit", self.now, rid=req.rid,
                     replica=self.trace_replica, slot=int(slot),
                     n_tokens=len(req.tokens), done=True,
                     latency_ticks=req.latency)
        if req.spec is not None:
            self.engine.drafter.release(slot)
            self._ctrls.pop(req.rid, None)

    def _prefix_event(self, name: str, **attrs) -> None:
        """Prefix-trie detail events (insert, evict, hit) to the tracer;
        one ``is None`` check when tracing is off."""
        tr = self.engine.tracer
        if tr is not None:
            tr.event(name, self.now, replica=self.trace_replica, **attrs)

    def _unpin(self, slot: int) -> None:
        """Drop a slot's prefix-trie pin (if any) and its history note:
        when the slot's final chunk lands, on preemption and on
        :meth:`abort`."""
        self._prefix_hist.pop(slot, None)
        key = self._prefix_pins.pop(slot, None)
        if key is not None and self.prefix is not None:
            self.prefix.release(key)

    def tick(self) -> list:
        """Run one engine iteration; returns (and logs) this tick's local
        stats vector (``telemetry.STATS_FIELDS``). Raises
        :class:`PoisonedLogits`, committing nothing of the tick, if the
        decode or verify guard flagged non-finite logits."""
        eng = self.engine
        sched = self.sched
        samp = self.samp
        now = self.now
        dev = eng.device
        new_tokens = 0
        sampled_tokens = 0
        chunks_fed = 0
        drafted = 0
        accepted = 0
        resumed = 0
        deadline_misses = 0
        prefix_hits = 0
        prefix_reused = 0
        freed = np.zeros(eng.n_slots, bool)
        # observability: the sinks are read once a tick (they may attach
        # late), and the scheduler gets the tracer so that shed and preempt
        # events come from where they are decided
        tr = eng.tracer
        sched.tracer = tr
        sched.trace_replica = self.trace_replica
        self._tick_ttfts = []
        self._tick_lats = []

        # --- SLO hooks: shed hopeless queued work, then evict the slots
        # the policy wants for waiting higher-priority requests (no-ops
        # under FIFO). Eviction comes before admission so a freed slot is
        # granted in this tick, and the evicted rows are reset at once so
        # the incoming request prefills into a clean slot.
        shed_now = sched.shed(now)
        for req in shed_now:
            if req.deadline is not None and not req.deadline_counted:
                req.deadline_counted = True
                deadline_misses += 1
        preempt_slots = sched.plan_preemptions(now)
        if preempt_slots:
            mask = np.zeros(eng.n_slots, bool)
            for slot in preempt_slots:
                req = sched.active[slot]
                self.pending_chunks.pop(slot, None)
                self._resume_last.pop(slot, None)
                self._unpin(slot)
                sampling.set_slot(samp, slot, None)
                if req.spec is not None:
                    eng.drafter.release(slot)
                    self._ctrls.pop(req.rid, None)
                sched.preempt(slot, now)
                mask[slot] = True
            self.caches = tf.reset_cache_slots(self.caches, mask)

        # --- admission: grant free slots, stage the chunk plans --------
        admissions = sched.admit(now, batch_sync=self.static)
        for slot, req in admissions:
            history = req.prompt
            if req.tokens and eng._bounded_ring:
                # bounded rings are chunk-PLAN-deterministic only: replay
                # the original plan instead (same stream, more recompute)
                req.tokens = []
                req.t_first = None
            if req.tokens:
                # exact resume: rebuild the cache over the journal; the
                # last committed token is re-fed by decode, not re-derived
                history = req.prompt + tuple(req.tokens[:-1])
                self._resume_last[slot] = int(req.tokens[-1])
                resumed += len(req.tokens)
                req.resumed_tokens += len(req.tokens)
                if tr is not None:
                    tr.event("resume", now, rid=req.rid,
                             replica=self.trace_replica, slot=int(slot),
                             journal_tokens=len(req.tokens),
                             preemptions=req.preemptions,
                             failovers=req.failovers)
            start = 0
            if self.prefix is not None:
                # adoption AFTER history normalization: a resumed request
                # matches its journal-extended history, so a preempted one
                # re-adopts its own boundaries; lookup() caps the match at
                # len(history) - 1, so at least one chunk runs and emits
                p, node = self.prefix.lookup(history)
                if node is not None:
                    self.caches = tf.adopt_prefix(self.caches, node.row, slot)
                    self.prefix.acquire(node.key)
                    self._prefix_pins[slot] = node.key
                    start = p
                    req.prefilled = p    # resume=True from the first chunk
                    req.prefix_reused += p
                    prefix_hits += 1
                    prefix_reused += p
                    if tr is not None:
                        tr.event("prefix_adopt", now, rid=req.rid,
                                 replica=self.trace_replica,
                                 slot=int(slot), tokens_reused=p)
                self._prefix_hist[slot] = tuple(history)
            self.pending_chunks[slot] = eng._chunk_plan(history, start=start)
            if tr is not None:
                tr.event("admit", now, rid=req.rid,
                         replica=self.trace_replica, slot=int(slot),
                         prompt_len=len(req.prompt),
                         chunks=len(self.pending_chunks[slot]),
                         resumed=bool(req.tokens))
            sampling.set_slot(samp, slot, req.sampling)
            if req.spec is not None:
                self._ctrls[req.rid] = AdaptiveDraftController(req.spec)
                eng.drafter.admit(slot, req)

        # --- prefill: one chunk per admitting slot per tick ------------
        # one single-row call per chunk; the bucket keeps a chunk's shape a
        # function of its length alone. The final chunk emits the
        # request's first token, except on a resumed slot, whose next
        # token is already in the journal.
        for slot in sorted(self.pending_chunks):
            req = sched.active[slot]
            chunk = self.pending_chunks[slot].pop(0)
            final = not self.pending_chunks[slot]
            tc = eng._bucket(len(chunk))
            buf = np.zeros((1, tc), np.int64)
            buf[0, :len(chunk)] = chunk
            sampled_req = (req.sampling is not None
                           and not req.sampling.greedy
                           and slot not in self._resume_last)
            tok, self.caches = eng._prefill(
                eng.params, host_to(torch.from_numpy(buf), dev), self.caches,
                slot, len(chunk), resume=req.prefilled > 0,
                sampling_row=({k: v[slot] for k, v in samp.items()}
                              if sampled_req else None))
            req.prefilled += len(chunk)
            chunks_fed += 1
            if tr is not None:
                tr.event("prefill_chunk", now, rid=req.rid,
                         replica=self.trace_replica, slot=int(slot),
                         chunk_tokens=len(chunk), final=final,
                         prefilled=req.prefilled)
            if self.prefix is not None:
                # snapshot the row at every chunk-grid boundary: there it
                # is a pure function of history[:p] and the grid, so any
                # later request sharing those tokens may adopt it (on the
                # final chunk too: the row precedes the first token's draw)
                p = req.prefilled
                hist = self._prefix_hist.get(slot, ())
                if p % eng.prefill_chunk == 0 and p <= len(hist):
                    key = hist[:p]
                    if key not in self.prefix:
                        self.prefix.insert(
                            key, tf.extract_cache_row(self.caches, slot, p))
            if final:
                del self.pending_chunks[slot]
                self._unpin(slot)
                req.state = RequestState.ACTIVE
                if slot in self._resume_last:
                    # the journal is authoritative: discard the re-derived
                    # token, resume decode from the committed tail
                    self.last[slot] = self._resume_last.pop(slot)
                else:
                    tok = int(tok)
                    req.tokens.append(tok)
                    req.t_first = now
                    self._tick_ttfts.append(req.ttft)
                    if tr is not None:
                        tr.event("commit", now, rid=req.rid,
                                 replica=self.trace_replica, slot=int(slot),
                                 n_tokens=1, first_token=True,
                                 ttft_ticks=req.ttft)
                    if req.deadline is not None \
                            and not req.deadline_counted and now > req.deadline:
                        req.deadline_counted = True
                        deadline_misses += 1
                    self.last[slot] = tok
                    new_tokens += 1
                    if req.sampling is not None and not req.sampling.greedy:
                        sampled_tokens += 1
                    if req.done:
                        self._release(slot, req, freed)

        # --- draft: propose up to k tokens per speculative slot --------
        decodable = {slot: req for slot, req in sched.active.items()
                     if req.state is RequestState.ACTIVE}
        drafts: dict = {}
        for slot, req in decodable.items():
            if req.spec is None:
                continue
            # never draft past the request's budget: the verify call emits
            # at most k+1 tokens, and k <= remaining - 1 keeps every real
            # written position inside the ring bound _check admitted
            k_eff = min(self._ctrls[req.rid].current_k(), self.k_run,
                        req.max_new_tokens - len(req.tokens) - 1)
            if k_eff > 0:
                d = eng.drafter.propose(slot, req, k_eff)[:k_eff]
                if d:
                    drafts[slot] = [int(t) for t in d]
                if tr is not None:
                    tr.event("draft", now, rid=req.rid,
                             replica=self.trace_replica, slot=int(slot),
                             k_eff=int(k_eff), proposed=len(d),
                             drafter=drafter_label(eng.drafter))

        if decodable:
            active = np.zeros(eng.n_slots, bool)
            steps = np.zeros(eng.n_slots, np.int64)
            any_sampled = False
            for slot, req in decodable.items():
                active[slot] = True
                steps[slot] = len(req.tokens)
                any_sampled |= (req.sampling is not None
                                and not req.sampling.greedy)
            # all-greedy ticks take the argmax-only step; the sampled
            # step's greedy rows are the same argmax
            samp_in = ({"key": samp["key"], "step": steps,
                        "temperature": samp["temperature"],
                        "top_k": samp["top_k"], "top_p": samp["top_p"]}
                       if any_sampled else None)
            if drafts:
                # --- verify: score k+1 positions per slot in one pass and
                # emit the longest prefix the committed stream agrees with
                buf = np.zeros((eng.n_slots, self.k_run + 1), np.int64)
                buf[:, 0] = self.last
                n_draft = np.zeros(eng.n_slots, np.int64)
                for slot, d in drafts.items():
                    buf[slot, 1:1 + len(d)] = d
                    n_draft[slot] = len(d)
                out, acc, self.caches = eng._get_verify(self.k_run)(
                    eng.params, host_to(torch.from_numpy(buf), dev),
                    self.caches, active, n_draft, samp_in)
                self.verify_ticks += 1
                out, acc = out.numpy(), acc.numpy()
                self._guard(decodable, [out[s, :acc[s]].min(initial=0)
                                        for s in decodable])
                for slot, req in decodable.items():
                    n = int(acc[slot])
                    emit = [int(t) for t in out[slot, :n]]
                    req.tokens.extend(emit)
                    self.last[slot] = emit[-1]
                    new_tokens += len(emit)
                    if req.sampling is not None \
                            and not req.sampling.greedy:
                        sampled_tokens += len(emit)
                    nd = int(n_draft[slot])
                    drafted += nd
                    accepted += n - 1
                    if req.spec is not None:
                        self._ctrls[req.rid].update(nd, n - 1)
                    if tr is not None:
                        tr.event("verify", now, rid=req.rid,
                                 replica=self.trace_replica, slot=int(slot),
                                 n_draft=nd, accepted=n - 1,
                                 committed=len(emit))
                    if req.done:
                        self._release(slot, req, freed)
            else:
                # --- decode: one token per busy slot (no proposals) ----
                toks, self.caches = eng._decode(
                    eng.params,
                    {"tokens": host_to(torch.from_numpy(self.last[:, None]),
                                       dev)},
                    self.caches, active, samp_in)
                self.decode_ticks += 1
                toks = toks.cpu().numpy()
                self._guard(decodable, [toks[s] for s in decodable])
                if tr is not None:
                    tr.event("decode", now, replica=self.trace_replica,
                             n_active=len(decodable))
                for slot, req in decodable.items():
                    req.tokens.append(int(toks[slot]))
                    self.last[slot] = toks[slot]
                    new_tokens += 1
                    if req.sampling is not None \
                            and not req.sampling.greedy:
                        sampled_tokens += 1
                    if tr is not None:
                        tr.event("commit", now, rid=req.rid,
                                 replica=self.trace_replica, slot=int(slot),
                                 n_tokens=1)
                    if req.done:
                        self._release(slot, req, freed)

        if freed.any():
            self.caches = tf.reset_cache_slots(self.caches, freed)
            for slot in np.flatnonzero(freed):
                sampling.set_slot(samp, int(slot), None)
        # the stats row BY NAME through the drift guard; failovers and
        # quarantines are the fleet's control-plane counts (serving/fleet.py)
        vec = stats_vector({
            "queue_depth": sched.arrived_depth(now),
            "active_slots": len(sched.active),
            "new_tokens": new_tokens,
            "prefills": len(admissions),
            "prefill_chunks": chunks_fed,
            "sampled_tokens": sampled_tokens,
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "failovers": 0,
            "resumed_tokens": resumed,
            "quarantines": 0,
            "preemptions": len(preempt_slots),
            "shed_requests": len(shed_now),
            "deadline_misses": deadline_misses,
            "prefix_hits": prefix_hits,
            "prefix_tokens_reused": prefix_reused,
        })
        metrics = eng.metrics
        if metrics is not None:
            # the histogram increments ride the same b=1 stats reduction as
            # a fixed-width tail; counts land in the histograms only through
            # the reduced vector, so one engine and a fleet agree
            vec = vec + metrics.row(self._tick_ttfts, self._tick_lats)
        self.log.step(now, vec)
        if metrics is not None:
            metrics.absorb(self.log.last_reduced[len(STATS_FIELDS):])
            every = eng.metrics_every
            if every > 0 and (now + 1) % every == 0:
                snap = metrics.snapshot()
                if eng.metrics_sink is not None:
                    eng.metrics_sink(now, snap)
                if tr is not None:
                    tr.event("metrics", now, replica=self.trace_replica,
                             **snap)
        self.now += 1
        return vec

    def _guard(self, decodable, slot_tokens) -> None:
        """Refuse a tick whose guard flagged non-finite logits: raise with
        the poisoned slots BEFORE any of the tick's tokens commit."""
        bad = [slot for slot, tok in zip(decodable, slot_tokens)
               if int(tok) < 0]
        if bad:
            raise PoisonedLogits(bad, [decodable[s].rid for s in bad])

    def abort(self) -> list:
        """Evict every in-flight request; returns them, journals intact,
        for re-queueing. Their slots are zeroed, as a release does, and
        their prefix pins dropped."""
        self.pending_chunks.clear()
        self._resume_last.clear()
        for slot in list(self._prefix_pins):
            self._unpin(slot)
        self._prefix_hist.clear()
        out = self.sched.drain_active()
        self.caches = tf.reset_cache_slots(self.caches,
                                           np.ones(self.engine.n_slots, bool))
        return out

    def report(self) -> dict:
        wall = time.perf_counter() - self._t0
        log, sched = self.log, self.sched
        report = log.report(sched.finished, wall, self.now)
        report["mode"] = "static" if self.static else "continuous"
        report["tokens"] = {r.rid: list(r.tokens) for r in sched.finished}
        for field in ("sampled_tokens", "prefill_chunks", "drafted_tokens",
                      "accepted_tokens", "resumed_tokens", "failovers",
                      "quarantines", "preemptions", "shed_requests",
                      "deadline_misses", "prefix_hits",
                      "prefix_tokens_reused"):
            report[field] = int(sum(getattr(s, field) for s in log.steps))
        if self.prefix is not None:
            report["prefix_cache"] = self.prefix.stats()
        report["acceptance_rate"] = (
            report["accepted_tokens"] / report["drafted_tokens"]
            if report["drafted_tokens"] else float("nan"))
        report["decode_ticks"] = self.decode_ticks
        report["verify_ticks"] = self.verify_ticks
        report["policy"] = sched.policy.name
        report["slo"] = slo_report(sched.finished + sched.shed_requests)
        if self.engine.metrics is not None:
            report["live_metrics"] = self.engine.metrics.snapshot()
        return report
