"""Continuous-batching serving (the port of ``repro.serving``'s core).

  request.py    — Request objects and their lifecycle
                  (QUEUED -> PREFILLING -> ACTIVE -> DONE)
  slo.py        — scheduling policies (the engine serves FIFO; the SLO
                  policy waits for ROADMAP queue 1's item 2b)
  scheduler.py  — admission into cache slots, and the static batch-sync
                  reference mode
  sampling.py   — temperature/top-k/top-p with per-request seeded keys;
                  greedy is the default
  telemetry.py  — per-tick stats, reduced across replicas with the b=1
                  dual-root tree
  engine.py     — the engine loop over the slot prefill and decode steps
                  (chunked long-prompt admission, exact resume)

Speculative decoding, the prefix cache, traces and the SLO policy (item
2b), the fleet (item 2c) and the tracer (item 6) are later slices.
"""

from repro_torch.serving.engine import (EngineSession, PoisonedLogits,
                                        ServingEngine)
from repro_torch.serving.request import (MAX_DRAFT_K, Request, RequestState,
                                         SpecParams)
from repro_torch.serving.sampling import GREEDY, SamplingParams, sample_tokens
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.slo import (FIFOPolicy, PriorityClass,
                                     SchedulingPolicy, SLOParams, SLOPolicy,
                                     deadline_met, make_policy, slo_report)
from repro_torch.serving.telemetry import (STATS_COLLECTIVE, STATS_FIELDS,
                                           StepStats, TelemetryLog,
                                           make_stats_reducer, stats_vector)

__all__ = [
    "ServingEngine", "EngineSession", "PoisonedLogits",
    "Request", "RequestState", "SlotScheduler",
    "TelemetryLog", "StepStats",
    "SamplingParams", "GREEDY", "sample_tokens",
    "SpecParams", "MAX_DRAFT_K",
    "PriorityClass", "SLOParams", "SchedulingPolicy", "FIFOPolicy",
    "SLOPolicy", "make_policy", "deadline_met", "slo_report",
    "make_stats_reducer", "STATS_FIELDS", "STATS_COLLECTIVE",
    "stats_vector",
]
