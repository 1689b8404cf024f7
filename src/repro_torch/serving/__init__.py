"""Continuous-batching serving (the port of ``repro.serving``).

  request.py     — Request objects and their lifecycle
                   (QUEUED -> PREFILLING -> ACTIVE -> DONE, or SHED)
  slo.py         — scheduling policies: FIFO, and the SLO policy (priority
                   classes, aging, deadline shedding, exact-resume
                   preemption)
  scheduler.py   — admission into cache slots, the SLO hooks, and the
                   static batch-sync reference mode
  sampling.py    — temperature/top-k/top-p with per-request seeded keys;
                   greedy is the default; a block of positions per row
                   for speculative verification
  speculative.py — drafters (n-gram lookup, a draft model) and the
                   adaptive draft length controller
  prefix.py      — the refcounted LRU trie of chunk-boundary cache rows
  traces.py      — seeded synthetic traces with bursts and class mixes
  telemetry.py   — per-tick stats, reduced across replicas with the b=1
                   dual-root tree
  engine.py      — the engine loop over the slot prefill, decode and
                   verify steps (chunked admission, prefix adoption, exact
                   resume), with the tracer and live metrics hooks
  fleet.py       — replica failover: heartbeats, the SUSPECT window,
                   rejoin and quarantine, plan_remesh shrink and grow;
                   FleetRunner drives one EngineSession per replica under
                   a chaos plan
"""

from repro_torch.serving.engine import (EngineSession, PoisonedLogits,
                                        ServingEngine)
from repro_torch.serving.fleet import FailoverPlan, FleetRunner, ReplicaFleet
from repro_torch.serving.prefix import PrefixCache, PrefixNode
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import (GREEDY, SamplingParams,
                                          sample_tokens, sample_tokens_block)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.slo import (FIFOPolicy, PriorityClass,
                                     SchedulingPolicy, SLOParams, SLOPolicy,
                                     deadline_met, make_policy, slo_report)
from repro_torch.serving.speculative import (MAX_DRAFT_K,
                                             AdaptiveDraftController,
                                             Drafter, DraftModelDrafter,
                                             NgramDrafter, SpecParams)
from repro_torch.serving.telemetry import (STATS_COLLECTIVE, STATS_FIELDS,
                                           StepStats, TelemetryLog,
                                           make_stats_reducer, stats_vector)
from repro_torch.serving.traces import (DEFAULT_MIX, ClassSpec, TraceSpec,
                                        generate_trace, trace_summary)

__all__ = [
    "ServingEngine", "EngineSession", "PoisonedLogits",
    "Request", "RequestState", "SlotScheduler",
    "PrefixCache", "PrefixNode",
    "ReplicaFleet", "FleetRunner", "FailoverPlan",
    "TelemetryLog", "StepStats",
    "SamplingParams", "GREEDY", "sample_tokens", "sample_tokens_block",
    "SpecParams", "Drafter", "NgramDrafter", "DraftModelDrafter",
    "AdaptiveDraftController", "MAX_DRAFT_K",
    "PriorityClass", "SLOParams", "SchedulingPolicy", "FIFOPolicy",
    "SLOPolicy", "make_policy", "deadline_met", "slo_report",
    "TraceSpec", "ClassSpec", "DEFAULT_MIX", "generate_trace",
    "trace_summary",
    "make_stats_reducer", "STATS_FIELDS", "STATS_COLLECTIVE",
    "stats_vector",
]
