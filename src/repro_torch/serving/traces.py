"""Seeded synthetic workload traces for the scheduling testbed (the port of
``repro.serving.traces``, plain numpy, copied).

Real serving traffic is neither uniform nor gentle: requests arrive in
bursts (sessions, retries, fan-out), prompt and output lengths are
heavy-tailed (most chats are short, a few dominate slot time), and the mix
spans service classes with different latency expectations. The FIFO-vs-SLO
comparison is only meaningful under such a trace — under smooth uniform
arrivals every policy looks the same — so this module generates one
deterministically from a seed:

* **bursty arrivals**: an on/off process — quiet gaps drawn geometric,
  then a burst of several requests landing on the same tick (plus small
  jitter), the classic flash-crowd shape;
* **heavy-tailed lengths**: prompt and output lengths drawn lognormal and
  clipped into engine bounds, so a few long requests contend with many
  short ones for the same slots;
* **per-class mixes**: each request is assigned a
  :class:`~repro_torch.serving.slo.PriorityClass` (with optional TTFT deadline
  and preemptibility) by seeded weighted choice.

Every draw comes from one ``np.random.default_rng(seed)`` in a fixed
order, so the same :class:`TraceSpec` + seed reproduces the same trace —
arrivals, lengths, classes, token ids — bit-for-bit on any host, and the
same trace as the reference's for the same spec and seed. Tick-count
metrics measured over a generated trace are therefore
wall-clock-independent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.serving.slo import PriorityClass, SLOParams


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One service class in the mix.

    weight: relative share of requests in this class (need not sum to 1).
    priority: the :class:`~repro_torch.serving.slo.PriorityClass` assigned.
    deadline_ticks: TTFT deadline for the class (None = no deadline).
    preemptible: explicit preemptibility (None = the class default:
        everything below INTERACTIVE).
    """

    weight: float
    priority: PriorityClass = PriorityClass.BATCH
    deadline_ticks: int | None = None
    preemptible: bool | None = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"class weight must be > 0, got {self.weight}")
        object.__setattr__(self, "priority", PriorityClass(self.priority))


# a plausible production mix: mostly latency-sensitive chat, a slab of
# batch work, a trickle of scavenger traffic with a hopeless-by-design
# deadline so overload shedding has something legitimate to drop
DEFAULT_MIX = (
    ClassSpec(weight=0.5, priority=PriorityClass.INTERACTIVE,
              deadline_ticks=24),
    ClassSpec(weight=0.35, priority=PriorityClass.BATCH),
    ClassSpec(weight=0.15, priority=PriorityClass.BEST_EFFORT,
              deadline_ticks=48),
)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Shape parameters for one synthetic trace.

    n_requests: total requests generated.
    mix: tuple of :class:`ClassSpec` (weighted class mix).
    gap_mean: mean quiet ticks between bursts (geometric).
    burst_mean: mean requests per burst (>= 1, geometric).
    prompt_median / prompt_sigma: lognormal prompt-length parameters
        (median in tokens; sigma is the log-space spread — the tail
        heaviness). Clipped to [1, max_prompt].
    out_median / out_sigma: same for generation lengths, clipped to
        [1, max_out].
    max_prompt / max_out: engine-geometry clip bounds — pick them so
        prompt + output fits the target engine's cache length.
    """

    n_requests: int = 32
    mix: tuple = DEFAULT_MIX
    gap_mean: float = 3.0
    burst_mean: float = 3.0
    prompt_median: float = 6.0
    prompt_sigma: float = 0.8
    out_median: float = 8.0
    out_sigma: float = 0.6
    max_prompt: int = 16
    max_out: int = 16

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if not self.mix:
            raise ValueError("mix must name at least one class")
        if self.gap_mean < 0 or self.burst_mean < 1:
            raise ValueError("want gap_mean >= 0 and burst_mean >= 1")
        if self.max_prompt < 1 or self.max_out < 1:
            raise ValueError("max_prompt/max_out must be >= 1")


def _lognormal_lengths(rng, n, median, sigma, bound):
    ln = rng.lognormal(mean=float(np.log(median)), sigma=sigma, size=n)
    return np.clip(np.rint(ln).astype(int), 1, bound)


def generate_trace(spec: TraceSpec, vocab: int, *, seed: int = 0,
                   base_rid: int = 0) -> list:
    """Generate a list of :class:`~repro_torch.serving.request.Request` (sorted
    by arrival, rids ``base_rid..``) — deterministic in (spec, vocab, seed).
    """
    if vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {vocab}")
    rng = np.random.default_rng(seed)
    n = spec.n_requests

    # arrivals: geometric quiet gaps between geometric-sized bursts; all
    # requests of a burst land on the same tick (the flash crowd)
    arrivals = []
    t = 0
    while len(arrivals) < n:
        if spec.gap_mean > 0:
            t += int(rng.geometric(1.0 / (1.0 + spec.gap_mean))) - 1
        burst = int(rng.geometric(1.0 / spec.burst_mean))
        arrivals.extend([t] * min(burst, n - len(arrivals)))
        t += 1

    prompt_lens = _lognormal_lengths(rng, n, spec.prompt_median,
                                     spec.prompt_sigma, spec.max_prompt)
    out_lens = _lognormal_lengths(rng, n, spec.out_median,
                                  spec.out_sigma, spec.max_out)
    weights = np.asarray([c.weight for c in spec.mix], float)
    classes = rng.choice(len(spec.mix), size=n, p=weights / weights.sum())

    reqs = []
    for i in range(n):
        cls = spec.mix[int(classes[i])]
        prompt = rng.integers(0, vocab, size=int(prompt_lens[i]))
        reqs.append(Request(
            rid=base_rid + i,
            prompt=tuple(int(x) for x in prompt),
            max_new_tokens=int(out_lens[i]),
            arrival=int(arrivals[i]),
            slo=SLOParams(priority=cls.priority,
                          deadline_ticks=cls.deadline_ticks,
                          preemptible=cls.preemptible),
        ))
    return reqs


def trace_summary(reqs) -> dict:
    """Small digest of a trace (class counts, length stats, burstiness) —
    handy for logging and for the determinism test's human-readable diff."""
    arrivals = [r.arrival for r in reqs]
    by_class: dict = {}
    for r in reqs:
        name = PriorityClass(int(r.slo.priority)).name.lower()
        by_class[name] = by_class.get(name, 0) + 1
    per_tick = np.bincount(arrivals) if arrivals else np.zeros(1, int)
    return {
        "n": len(reqs),
        "classes": by_class,
        "prompt_max": max((len(r.prompt) for r in reqs), default=0),
        "out_max": max((r.max_new_tokens for r in reqs), default=0),
        "span_ticks": (max(arrivals) - min(arrivals) + 1) if arrivals else 0,
        "peak_burst": int(per_tick.max()),
    }
