"""Speculative decoding over the slot machinery: drafters and the draft
length controller (the port of ``repro.serving.speculative``).

Every serving tick pays one latency-bound b=1 dual-root stats reduction,
the small-message ``O(alpha * log p)`` regime of the source paper's latency
term. Speculative decoding spreads that fixed cost: a cheap DRAFTER
proposes up to k next tokens per request, one VERIFY pass scores all k+1
positions against the per-slot caches
(:func:`repro_torch.launch.step_fns.make_verify_step`), and the engine
emits the longest draft prefix the model itself agrees with plus the
model's own token at the first disagreement. A tick still pays one
reduction but emits up to k+1 tokens, with streams bit-identical to the
non-speculative engine (greedy rows accept against the argmax, sampled
rows against the committed ``fold_in(seed, token_index)`` sampler of
:mod:`repro_torch.serving.sampling`).

Two drafters behind one duck-typed protocol (``admit(slot, req)`` /
``propose(slot, req, k) -> list[int]`` / ``release(slot)``):

* :class:`NgramDrafter`: prompt-lookup self-drafting, the tokens that
  followed the most recent earlier occurrence of the request's trailing
  n-gram. No second model, no device state; a pure function of the
  request's history (and of the shared corpus, when one is wired in).
* :class:`DraftModelDrafter`: a second, smaller parameter set on its own
  per-slot caches, driven by the same slot prefill and decode steps. Its
  caches hold only committed tokens between proposals: a proposal saves the
  ring slots its k draft steps will write, decodes them, then writes the
  saved bytes back and rewinds the slot's position (the port's rings are
  written in place, so there is no old cache to hold on to).

:class:`AdaptiveDraftController` shrinks a request's draft length when the
acceptance-rate EWMA drops and grows it back when acceptance recovers,
always within ``SpecParams.draft_k``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.transport import host_to, resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf

__all__ = ["MAX_DRAFT_K", "SpecParams", "AdaptiveDraftController",
           "drafter_label", "Drafter", "NgramDrafter", "DraftModelDrafter"]

# Hard ceiling on the per-request draft budget: the verify pass scores
# draft_k + 1 positions per tick, and a verify call must stay well under
# any ring-cache length (T <= S per call).
MAX_DRAFT_K = 16


@dataclasses.dataclass(frozen=True)
class SpecParams:
    """Per-request speculative-decoding controls.

    draft_k: maximum drafts per tick (the verify step's width).
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


class AdaptiveDraftController:
    """Per-request draft-length adaptation on an acceptance-rate EWMA.

    Deterministic: the state is a pure function of the request's own
    (drafted, accepted) history, never of scheduling. Starts optimistic
    (full ``draft_k``).
    """

    def __init__(self, spec: SpecParams):
        self.spec = spec
        self.k = spec.draft_k
        self.rate = 1.0
        self.drafted = 0
        self.accepted = 0

    def current_k(self) -> int:
        return self.k

    def snapshot(self) -> dict:
        """JSON-safe controller state: current k, the acceptance EWMA, and
        lifetime drafted/accepted totals."""
        return {"k": int(self.k), "rate": float(self.rate),
                "drafted": int(self.drafted), "accepted": int(self.accepted)}

    def update(self, n_draft: int, n_accept: int) -> int:
        """Record one verify tick's outcome; returns the next tick's k."""
        self.drafted += int(n_draft)
        self.accepted += int(n_accept)
        if not self.spec.adapt or n_draft == 0:
            return self.k
        a = self.spec.ewma
        self.rate = (1.0 - a) * self.rate + a * (n_accept / n_draft)
        if self.rate < self.spec.low:
            self.k = max(self.spec.min_k, self.k - 1)
        elif self.rate > self.spec.high:
            self.k = min(self.spec.draft_k, self.k + 1)
        return self.k


def drafter_label(drafter) -> str:
    """Short stable label of a drafting strategy (``"ngram"``,
    ``"draft_model"``, ``"none"``, or the class name of a custom
    drafter)."""
    if drafter is None:
        return "none"
    if isinstance(drafter, NgramDrafter):
        return "ngram"
    if isinstance(drafter, DraftModelDrafter):
        return "draft_model"
    return type(drafter).__name__


class Drafter:
    """Drafter protocol (base no-op implementation).

    ``admit`` is called when a speculative request is granted a slot,
    ``release`` when it completes or is evicted; ``propose`` may return
    FEWER than ``k`` tokens (or none — the tick then is a plain decode step
    for that slot). Proposals must depend only on the request's own
    history, never on scheduling, or run-to-run tick determinism is lost.
    """

    def admit(self, slot: int, req) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def propose(self, slot: int, req, k: int) -> list:
        return []


class NgramDrafter(Drafter):
    """Prompt-lookup self-drafting (no extra model).

    Find the most recent earlier occurrence of the request's trailing
    n-gram (longest first, down to a single token) in its own
    prompt + generated history, and propose the tokens that followed it.

    ``corpus`` (optional — the engine wires the session's
    :class:`~repro_torch.serving.prefix.PrefixCache` in when prefix caching
    is on) is a shared fallback searched AFTER the request's own history
    misses: anything with a ``sequences() -> list[tuple]`` view of cached
    token runs. Corpus proposals depend on what OTHER requests have
    prefilled, so they may change how many ticks a stream takes, never the
    stream itself. Own-history proposals keep their precedence.
    """

    def __init__(self, max_ngram: int = 3, corpus=None):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram
        self.corpus = corpus

    def propose(self, slot: int, req, k: int) -> list:
        hist = tuple(req.prompt) + tuple(req.tokens)
        # the request's own SpecParams.ngram takes precedence; the
        # drafter-level max_ngram is only the fallback default
        spec_n = getattr(getattr(req, "spec", None), "ngram", None)
        n_cap = spec_n if spec_n else self.max_ngram
        for n in range(min(n_cap, len(hist) - 1), 0, -1):
            suffix = hist[-n:]
            # most recent occurrence strictly before the trailing one
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == suffix:
                    follow = hist[start + n:start + n + k]
                    if follow:
                        return [int(t) for t in follow]
                    break               # suffix only recurs at the very end
        if self.corpus is not None:
            return self._propose_from_corpus(hist, n_cap, k)
        return []

    def _propose_from_corpus(self, hist: tuple, n_cap: int, k: int) -> list:
        """Shared-corpus fallback: longest trailing n-gram first, scanning
        the corpus sequences in their (deterministic) insertion order and
        taking the most recent in-sequence occurrence."""
        seqs = self.corpus.sequences()
        for n in range(min(n_cap, len(hist)), 0, -1):
            suffix = hist[-n:]
            for seq in seqs:
                for start in range(len(seq) - n, -1, -1):
                    if seq[start:start + n] == suffix:
                        follow = seq[start + n:start + n + k]
                        if follow:
                            return [int(t) for t in follow]
                        break       # match only at the sequence's very end
        return []


class DraftModelDrafter(Drafter):
    """Draft-model drafting: a second parameter set on its own slot caches.

    The draft model mirrors the engine's slot layout (same ``n_slots``, its
    own ``max_len``) and runs the slot prefill and decode steps on
    ``device`` (CUDA unless named). Invariant: between proposals the draft
    caches hold ONLY committed (prompt + emitted) tokens. ``propose`` first
    catches the slot up on tokens emitted since the last call, saves the
    ring slots the k draft steps will write
    (:func:`repro_torch.models.transformer.save_ring_slots`; a recurrent
    sublayer's whole row), greedily decodes up to ``k`` draft steps, then
    writes the saved bytes back and rewinds the slot's position: rejected
    drafts leave no trace, and accepted ones are fed again as the next
    catch-up.
    """

    def __init__(self, cfg, params, pcfg=None, *, n_slots: int,
                 max_len: int = 128, min_prefill_bucket: int = 8,
                 device=None):
        if not tf.supports_slot_serving(cfg):
            raise ValueError(f"{cfg.name}: draft model must support slot "
                             "serving (token prompts, decoder-only)")
        self.cfg, self.n_slots = cfg, n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self._bound = tf.prefill_call_bound(cfg, max_len)
        self._min_bucket = min(min_prefill_bucket, self._bound)
        self._decode = step_fns.make_serve_step(cfg, pcfg, slots=True)
        self._prefill = step_fns.make_prefill_step(cfg, pcfg,
                                                   into_slots=True)
        self.params = params
        self.caches = None
        self._fed: dict = {}            # slot -> committed tokens in cache

    # ------------------------------------------------------------ plumbing
    def _ensure_caches(self):
        if self.caches is None:
            self.caches = tf.init_cache(self.cfg, self.n_slots, self.max_len,
                                        device=self.device, per_slot=True)

    def _reset(self, slot: int) -> None:
        free = np.zeros(self.n_slots, bool)
        free[slot] = True
        self.caches = tf.reset_cache_slots(self.caches, free)

    def _feed(self, slot: int, tok: int) -> int:
        """Advance one slot by one token; returns the draft model's greedy
        next-token choice."""
        active = np.zeros(self.n_slots, bool)
        active[slot] = True
        toks = np.zeros((self.n_slots, 1), np.int64)
        toks[slot, 0] = tok
        out, self.caches = self._decode(
            self.params, {"tokens": host_to(torch.from_numpy(toks),
                                            self.device)},
            self.caches, active)
        return int(out[slot])

    # ------------------------------------------------------------ protocol
    def admit(self, slot: int, req) -> None:
        """Prefill the request's prompt into the draft slot (chunked by the
        draft model's own cache geometry; the emitted first token is
        discarded — the TARGET model's stream is the only stream)."""
        # lazy: the engine imports this module when it is imported
        from repro_torch.serving.engine import _pow2_at_least
        self._ensure_caches()
        self._reset(slot)
        prompt = tuple(req.prompt)
        pos = 0
        while pos < len(prompt):
            chunk = prompt[pos:pos + self._bound]
            tc = min(_pow2_at_least(len(chunk), self._min_bucket),
                     self._bound)
            buf = np.zeros((1, tc), np.int64)
            buf[0, :len(chunk)] = chunk
            _, self.caches = self._prefill(
                self.params, host_to(torch.from_numpy(buf), self.device),
                self.caches, slot, len(chunk), resume=pos > 0)
            pos += len(chunk)
        self._fed[slot] = len(prompt)

    def release(self, slot: int) -> None:
        self._fed.pop(slot, None)
        if self.caches is not None:
            self._reset(slot)

    def propose(self, slot: int, req, k: int) -> list:
        stream = tuple(req.prompt) + tuple(req.tokens)
        committed = len(stream) - 1     # the final token is fed speculatively
        for tok in stream[self._fed.get(slot, 0):committed]:
            self._feed(slot, tok)       # catch up on accepted tokens
        self._fed[slot] = committed
        n = np.zeros(self.n_slots, np.int64)
        n[slot] = k
        saved = tf.save_ring_slots(self.caches, n)
        last = int(stream[-1])
        drafts = []
        for _ in range(k):
            last = self._feed(slot, last)
            drafts.append(last)
        # drafts are speculative: write the saved slots back, rewind
        self.caches = tf.restore_ring_slots(self.caches, saved,
                                            np.zeros(self.n_slots, np.int64))
        return drafts
