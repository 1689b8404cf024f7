"""Continuous-batching serving engine on per-slot caches (the port of
``repro.serving.engine``'s core).

The engine owns two steps built by :mod:`repro_torch.launch.step_fns`:

* a cache-writing **prefill** step, one call per prompt CHUNK, that runs
  the chunk as a single row on views of the request's slot, so its K/V
  lands in the slot in place while every other slot stays bit-unchanged,
  and on the final chunk emits the request's first token (the seeded
  sampler's draw, greedy by default);
* a slot-aware **decode** step that advances every busy slot by one token
  a tick; free and prefilling slots write nothing and keep their
  positions.

Prompts longer than ``prefill_chunk`` are split into chunks fed one per
tick, interleaved with in-flight decode. Chunking is a pure function of
the prompt length and the engine constants, never of scheduling, so
continuous and static runs chunk identically and greedy streams are
bit-identical across policies. A slot is freed by zeroing its row and its
positions, so a finished request's slot is admissible again on the next
tick. Time runs on two clocks: ticks (one loop iteration; arrival, TTFT and
latency are counted in ticks) and wall seconds (throughput).
``run(..., static=True)`` runs the batch-synchronous reference policy
through the same steps.

Not ported yet, each refused with its ROADMAP item: speculative decoding,
the prefix cache and the SLO policies (queue 1's item 2b), the tracer and
live metrics (item 6), tensor parallelism (item 4).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.transport import host_to, resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.serving import sampling
from repro_torch.serving.request import Request, RequestState, SpecParams
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.slo import slo_report
from repro_torch.serving.telemetry import TelemetryLog, stats_vector

__all__ = ["ServingEngine", "EngineSession", "PoisonedLogits"]

_ITEM_2B = ("ROADMAP.md queue 1, 'Next' item 2b (speculation, prefixes, "
            "policies)")
_ITEM_6 = "ROADMAP.md queue 1, 'Next' item 6 (observability)"
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
    one replica. Window/chunk-bounded rings are ``SpecParams().draft_k``
    slots wider, as the reference's default ``draft_headroom`` makes them,
    so the caches have the reference's shapes. ``params`` lie on
    ``device`` (CUDA unless named). ``prefix_cache``, ``tracer`` and
    ``metrics`` are the reference's; any but the default is refused with
    the ROADMAP item that ports it."""

    def __init__(self, cfg, pcfg: ParallelConfig | None, params, *,
                 n_slots: int = 4, max_len: int = 128,
                 min_prefill_bucket: int = 16,
                 prefill_chunk: int | None = None, stats_reducer=None,
                 device=None, prefix_cache: bool = False, tracer=None,
                 metrics=None):
        if prefix_cache:
            raise NotImplementedError(
                f"the prefix cache is not ported yet: {_ITEM_2B}")
        if tracer is not None or metrics is not None:
            raise NotImplementedError(
                f"the tracer and live metrics are not ported yet: {_ITEM_6}")
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
        # longest single prefill CALL: every attention sublayer must fit the
        # chunk in its (possibly window/chunk-bounded) ring; longer prompts
        # are chunked across calls, not rejected
        s_min = tf.prefill_call_bound(cfg, max_len)
        self.max_prompt_len = s_min
        self._bounded_ring = s_min < max_len
        self.draft_headroom = SpecParams().draft_k
        self.prefill_chunk = (s_min if prefill_chunk is None
                              else min(prefill_chunk, s_min))
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.min_prefill_bucket = min(min_prefill_bucket, s_min)
        self._decode = step_fns.make_serve_step(cfg, pcfg, slots=True)
        self._prefill = step_fns.make_prefill_step(cfg, pcfg,
                                                   into_slots=True)
        self.params = params
        self.caches = None            # allocated per run
        self.stats_reducer = stats_reducer

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
            raise NotImplementedError(
                f"request {req.rid}: speculative decoding is not ported "
                f"yet: {_ITEM_2B}")

    def _chunk_plan(self, prompt, start: int = 0) -> list:
        """Split a prompt into prefill chunks: a pure function of the
        prompt length and the engine constants (never of scheduling), so
        every policy chunks identically and token streams match."""
        c = self.prefill_chunk
        return [prompt[i:i + c] for i in range(start, len(prompt), c)]

    # ---------------------------------------------------------------- run
    def start(self, requests=(), *, static: bool = False,
              policy=None) -> "EngineSession":
        """Open an :class:`EngineSession`, the tick-stepping form of
        :meth:`run`. It owns its caches, scheduler and sampler state; more
        requests may be submitted while it runs. ``policy`` must be None or
        the FIFO policy (the SLO policy waits for item 2b). The caches a
        previous :meth:`run` left in ``self.caches`` are dropped first, so
        two runs never hold two sets."""
        self.caches = None
        return EngineSession(self, requests, static=static, policy=policy)

    def run(self, requests, *, static: bool = False,
            max_ticks: int = 100_000, policy=None) -> dict:
        """Serve ``requests`` to completion; returns the telemetry report.

        ``static=True`` runs the batch-synchronous reference policy (admit
        only full batches into an all-free slot table) through the same
        steps. Token streams are identical either way: each row's
        computation depends only on its own request, and chunk plans and
        sampler keys only on the request itself."""
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
    journal (``req.tokens``) is re-prefilled over ``prompt + tokens[:-1]``
    through the ordinary chunked admission; the prefill's token is
    discarded (the journal is authoritative), and decode resumes feeding
    ``tokens[-1]`` at sampler cursor ``len(tokens)``, so the stream is the
    undisturbed one for greedy and sampled requests alike. On
    window/chunk-bounded rings a resume restarts from the prompt instead
    (those rings keep chunk-plan determinism only)."""

    def __init__(self, engine: ServingEngine, requests=(), *,
                 static: bool = False, policy=None):
        if policy is not None and policy.name != "fifo":
            raise NotImplementedError(
                f"scheduling policy {policy.name!r} is not ported yet: "
                f"{_ITEM_2B}")
        self.engine = engine
        self.static = static
        self.sched = SlotScheduler(engine.n_slots, policy=policy)
        self.caches = tf.init_cache(engine.cfg, engine.n_slots,
                                    engine.max_len, device=engine.device,
                                    per_slot=True,
                                    ring_slack=engine.draft_headroom)
        self.last = np.zeros(engine.n_slots, np.int64)
        self.samp = sampling.slot_arrays(engine.n_slots)
        self.pending_chunks: dict = {}   # slot -> remaining prompt chunks
        self._resume_last: dict = {}     # slot -> journal tail to re-feed
        self.log = TelemetryLog(engine.stats_reducer)
        self.now = 0
        self.decode_ticks = 0            # ticks that ran the decode step
        self._t0 = time.perf_counter()
        for req in requests:
            self.submit(req)

    def submit(self, req) -> None:
        """Queue one more request."""
        self.engine._check(req)
        self.sched.submit(req)

    @property
    def running(self) -> bool:
        return self.sched.pending or bool(self.sched.active)

    def _release(self, slot: int, freed) -> None:
        self.sched.release(slot, self.now)
        freed[slot] = True

    def tick(self) -> list:
        """Run one engine iteration; returns (and logs) this tick's local
        stats vector (``telemetry.STATS_FIELDS``). Raises
        :class:`PoisonedLogits`, committing nothing of the tick, if the
        decode guard flagged non-finite logits."""
        eng = self.engine
        sched = self.sched
        samp = self.samp
        now = self.now
        dev = eng.device
        new_tokens = 0
        sampled_tokens = 0
        chunks_fed = 0
        resumed = 0
        freed = np.zeros(eng.n_slots, bool)

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
            self.pending_chunks[slot] = eng._chunk_plan(history)
            sampling.set_slot(samp, slot, req.sampling)

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
            if final:
                del self.pending_chunks[slot]
                req.state = RequestState.ACTIVE
                if slot in self._resume_last:
                    # the journal is authoritative: discard the re-derived
                    # token, resume decode from the committed tail
                    self.last[slot] = self._resume_last.pop(slot)
                else:
                    tok = int(tok)
                    req.tokens.append(tok)
                    req.t_first = now
                    self.last[slot] = tok
                    new_tokens += 1
                    if req.sampling is not None and not req.sampling.greedy:
                        sampled_tokens += 1
                    if req.done:
                        self._release(slot, freed)

        # --- decode: one token per busy slot ---------------------------
        decodable = {slot: req for slot, req in sched.active.items()
                     if req.state is RequestState.ACTIVE}
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
            toks, self.caches = eng._decode(
                eng.params,
                {"tokens": host_to(torch.from_numpy(self.last[:, None]),
                                   dev)},
                self.caches, active, samp_in)
            self.decode_ticks += 1
            toks = toks.cpu().numpy()
            self._guard(decodable, [toks[s] for s in decodable])
            for slot, req in decodable.items():
                req.tokens.append(int(toks[slot]))
                self.last[slot] = toks[slot]
                new_tokens += 1
                if req.sampling is not None and not req.sampling.greedy:
                    sampled_tokens += 1
                if req.done:
                    self._release(slot, freed)

        if freed.any():
            self.caches = tf.reset_cache_slots(self.caches, freed)
            for slot in np.flatnonzero(freed):
                sampling.set_slot(samp, int(slot), None)
        # the stats row BY NAME through the drift guard; the counters of
        # items 2b and 2c stay 0 here
        vec = stats_vector({
            "queue_depth": sched.arrived_depth(now),
            "active_slots": len(sched.active),
            "new_tokens": new_tokens,
            "prefills": len(admissions),
            "prefill_chunks": chunks_fed,
            "sampled_tokens": sampled_tokens,
            "drafted_tokens": 0,
            "accepted_tokens": 0,
            "failovers": 0,
            "resumed_tokens": resumed,
            "quarantines": 0,
            "preemptions": 0,
            "shed_requests": 0,
            "deadline_misses": 0,
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
        })
        self.log.step(now, vec)
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
        for re-queueing. Their slots are zeroed, as a release does."""
        self.pending_chunks.clear()
        self._resume_last.clear()
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
        report["decode_ticks"] = self.decode_ticks
        report["policy"] = sched.policy.name
        report["slo"] = slo_report(sched.finished + sched.shed_requests)
        return report
