"""Request objects and their lifecycle for the serving engine (the port of
``repro.serving.request``, with the port's own copy of the reference's
:class:`SpecParams` until queue 1's item 2b ports speculative decoding).

A request is born QUEUED, becomes PREFILLING when the admission scheduler
packs it into a KV-cache slot (its prompt starts streaming into the slot,
one chunk per engine tick for prompts longer than the prefill chunk),
becomes ACTIVE the tick its final prompt chunk lands and its first token is
emitted, and becomes DONE when it has generated ``max_new_tokens``. Under
an overloaded :class:`~repro_torch.serving.slo.SLOPolicy` a queued request may
instead be SHED — dropped unserved (it never held a slot) — and a
PREFILLING/ACTIVE request may bounce back to QUEUED when preempted for
higher-priority work (journal intact; it later resumes bit-identically).
Short prompts pass through PREFILLING and ACTIVE in the same tick — the
one-chunk case is just a chunk plan of length one. Timestamps are recorded
in both clocks the engine runs: *ticks* (the virtual scheduling clock — one
engine iteration per tick, which is what arrival staggering and
TTFT/latency are measured in, deterministic across runs) and wall seconds
(what throughput is measured in).
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.slo import SLOParams, req_deadline

__all__ = ["MAX_DRAFT_K", "SpecParams", "RequestState", "Request"]

MAX_DRAFT_K = 16


@dataclasses.dataclass(frozen=True)
class SpecParams:
    """Per-request speculative-decoding controls (the reference's, copied;
    the engine refuses a request that carries one until item 2b).

    draft_k: maximum drafts per tick (the verify step's compiled width).
    min_k: adaptation floor — the controller never proposes fewer.
    ngram: longest trailing n-gram the lookup drafter tries to match.
    adapt: enable the acceptance-EWMA draft-length controller.
    low/high: acceptance-rate thresholds — below ``low`` the controller
        shrinks k by one, above ``high`` it grows k by one (within
        [min_k, draft_k]).
    ewma: smoothing weight of the newest tick's acceptance rate.
    """

    draft_k: int = 4
    min_k: int = 1
    ngram: int = 3
    adapt: bool = True
    low: float = 0.3
    high: float = 0.7
    ewma: float = 0.4

    def __post_init__(self):
        if not 1 <= self.draft_k <= MAX_DRAFT_K:
            raise ValueError(
                f"draft_k must be in [1, {MAX_DRAFT_K}], got {self.draft_k}")
        if not 1 <= self.min_k <= self.draft_k:
            raise ValueError(
                f"min_k must be in [1, draft_k={self.draft_k}], "
                f"got {self.min_k}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {self.ngram}")
        if not 0.0 <= self.low <= self.high <= 1.0:
            raise ValueError(
                f"need 0 <= low <= high <= 1, got {self.low}/{self.high}")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")


class RequestState(enum.Enum):
    QUEUED = "queued"      # submitted, waiting for a slot (or not yet arrived)
    PREFILLING = "prefilling"  # slot granted; prompt chunks streaming in
    ACTIVE = "active"      # fully prefilled; first token emitted; decoding
    DONE = "done"          # generated max_new_tokens; slot released
    SHED = "shed"          # dropped unserved by the overload policy


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a tuple of token ids; ``arrival`` is the tick at which the
    request becomes admissible (requests submitted ahead of time stay
    invisible to the scheduler until then — the staggered-arrival workload).
    ``sampling`` is None for greedy decoding (the bit-exact default) or a
    :class:`~repro_torch.serving.sampling.SamplingParams` for seeded
    temperature/top-k/top-p sampling. ``spec`` is None for plain
    one-token-per-tick decoding or a
    :class:`SpecParams` to opt this request into
    speculative decoding — the emitted stream is identical either way (the
    verify step accepts only tokens the committed greedy/sampled stream
    would have produced); speculation changes how many ticks the stream
    takes, never its content. ``slo`` is None for plain FIFO service or an
    :class:`~repro_torch.serving.slo.SLOParams` carrying the request's priority
    class, TTFT deadline, and preemptibility — like speculation, scheduling
    policy changes WHEN tokens are emitted, never WHAT (a preempted request
    resumes bit-identically from its journal; see docs/scheduling.md).

    ``tokens`` doubles as the request's **committed-token journal**: a
    token is appended exactly when the engine commits it to the stream, so
    on replica failover the journal survives
    (``SlotScheduler.requeue_front`` preserves it) and the engine
    re-admits the orphan by re-prefilling ``prompt + tokens[:-1]`` and
    resuming decode at ``sampler_cursor`` — the exact-resume invariant of
    docs/robustness.md. ``failovers``/``resumed_tokens`` count how often
    that happened to this request (telemetry).
    """

    rid: int
    prompt: tuple
    max_new_tokens: int
    arrival: int = 0
    sampling: SamplingParams | None = None
    spec: SpecParams | None = None
    slo: SLOParams | None = None     # priority class + TTFT deadline

    # runtime fields, owned by the scheduler/engine
    state: RequestState = RequestState.QUEUED
    slot: int | None = None
    tokens: list = dataclasses.field(default_factory=list)  # generated ids
    prefilled: int = 0               # prompt tokens already written to the slot
    t_admit: int | None = None       # tick the slot was granted
    t_first: int | None = None       # tick the first token was emitted
    t_done: int | None = None        # tick generation completed
    failovers: int = 0               # times re-queued off a dead replica
    resumed_tokens: int = 0          # journal tokens replayed across resumes
    preemptions: int = 0             # times evicted mid-flight for priority
    prefix_reused: int = 0           # prompt tokens adopted from the prefix
    #                                  trie across this request's admissions
    deadline_counted: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >=1")

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def committed(self) -> tuple:
        """The committed-token journal (immutable view of ``tokens``)."""
        return tuple(self.tokens)

    @property
    def sampler_cursor(self) -> int:
        """The next token index — the ``fold_in(seed, i)`` key cursor.
        Scheduling-independent by the sampling determinism contract, so a
        resumed request keeps sampling the undisturbed stream."""
        return len(self.tokens)

    @property
    def ttft(self) -> int | None:
        """Time-to-first-token in ticks (admission wait + prefill chunks)."""
        return None if self.t_first is None else self.t_first - self.arrival

    @property
    def latency(self) -> int | None:
        """End-to-end latency in ticks."""
        return None if self.t_done is None else self.t_done - self.arrival

    @property
    def deadline(self) -> int | None:
        """Absolute TTFT deadline tick (``arrival + slo.deadline_ticks``),
        or None for deadline-free requests."""
        return req_deadline(self)
