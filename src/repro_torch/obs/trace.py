"""Structured tick tracing: every serving-plane event as data, not prints
(the port of ``repro.obs.trace``, copied: plain Python).

The serving stack runs on a deterministic tick clock (one engine iteration
per tick — docs/serving.md), which makes a trace of it unusually honest:
an event's timestamp is not a wall-clock sample racing the scheduler, it
IS the scheduling decision. :class:`Tracer` collects
:class:`TraceEvent` records — ``(name, tick, rid, replica, attrs)`` — from
the engine, scheduler, drafters, prefix trie, and fleet control plane, and
exports them two ways:

* **JSONL** (:meth:`Tracer.to_jsonl`): one event per line, trivially
  greppable / loadable into pandas;
* **Chrome trace** (:meth:`Tracer.to_chrome`): the ``chrome://tracing`` /
  Perfetto JSON array format — one process row per replica, one thread row
  per request, a lifetime span per request from its first to last event,
  and every event as a one-tick slice inside it, so a whole serving run
  (chunked prefill, speculation, preemption, failover) renders as a
  timeline.

Tracing is PURE OBSERVATION. The tracer is handed into the engine as an
optional sink; every hook is ``if tracer is not None``-guarded, records
only values the tick loop already computed, and never feeds anything back
— the bit-identity tests (tests/test_torch_obs.py) run the same workload
with tracing on and off and require identical token streams. With no tracer
attached the serving path pays a single ``is None`` check per hook.
"""

from __future__ import annotations

import dataclasses
import json

# The span taxonomy every producer emits from (extra detail events such as
# "prefix_insert" are allowed; these names are the documented minimum —
# docs/observability.md has the per-event attribute tables).
SPAN_NAMES = ("admit", "prefill_chunk", "decode", "draft", "verify",
              "commit", "preempt", "resume", "failover", "prefix_adopt",
              "shed")

# One engine tick rendered as this many Chrome-trace microseconds (ticks
# are the deterministic clock; the scale only affects zoom, never order).
TICK_US = 1000


def _json_safe(v):
    """Clamp attribute values to JSON scalars (arrays/objects -> str)."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    try:
        import numpy as np
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
    except ImportError:          # pragma: no cover
        pass
    return str(v)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One observed serving-plane event.

    ``tick`` is the session's deterministic tick stamp; ``seq`` a
    monotonically increasing intra-tracer sequence number (stable ordering
    for events on the same tick); ``rid`` the request id (None for
    engine-level events such as a decode tick); ``replica`` the emitting
    replica (0 for a standalone engine).
    """

    name: str
    tick: int
    seq: int
    rid: int | None = None
    replica: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"name": self.name, "tick": self.tick, "seq": self.seq,
             "replica": self.replica}
        if self.rid is not None:
            d["rid"] = self.rid
        if self.attrs:
            d["attrs"] = {k: _json_safe(v) for k, v in self.attrs.items()}
        return d


class Tracer:
    """Bounded in-memory event sink with JSONL and Chrome-trace exporters.

    ``max_events`` bounds memory on long runs: past the cap new events are
    counted in ``dropped`` instead of stored (the cap is generous — a
    trace that big should stream to disk, which ``to_jsonl`` after shorter
    segments covers). The tracer is deliberately dumb: no filtering, no
    sampling, no derived state — determinism of the serving clock means
    post-processing can reconstruct anything from the raw events.
    """

    def __init__(self, max_events: int = 200_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.events: list = []
        self.dropped = 0
        self._seq = 0

    def __len__(self) -> int:
        return len(self.events)

    def event(self, name: str, tick: int, *, rid: int | None = None,
              replica: int = 0, **attrs) -> None:
        """Record one event. ``attrs`` are free-form scalars (clamped to
        JSON-safe values at export, not at record time — the hot path
        stores references only)."""
        self._seq += 1
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(TraceEvent(name=str(name), tick=int(tick),
                                      seq=self._seq, rid=rid,
                                      replica=int(replica), attrs=attrs))

    def by_name(self, name: str) -> list:
        return [e for e in self.events if e.name == name]

    def names(self) -> set:
        return {e.name for e in self.events}

    # ---------------------------------------------------------- exporters
    def to_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number of lines written."""
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e.to_dict()) + "\n")
        return len(self.events)

    def to_chrome(self, path: str | None = None) -> dict:
        """Export the Chrome-trace / Perfetto JSON object (and write it to
        ``path`` when given). Layout:

        * ``pid`` = replica (one process row per replica, named);
        * ``tid`` = request id + 1 (one thread row per request, named;
          ``tid`` 0 is the engine lane for events with no request);
        * per request: one ``ph="X"`` lifetime span from its first to its
          last event tick, plus each event as a one-tick ``"X"`` slice
          nested inside (Perfetto nests by ts/dur containment);
        * engine-level events: one-tick slices on the engine lane.
        """
        evs = []
        lanes: dict = {}      # (pid, tid) -> thread label
        spans: dict = {}      # (replica, rid) -> [first_tick, last_tick]
        for e in self.events:
            tid = 0 if e.rid is None else int(e.rid) + 1
            lanes[(e.replica, tid)] = ("engine" if e.rid is None
                                       else f"req {e.rid}")
            if e.rid is not None:
                lo, hi = spans.setdefault((e.replica, e.rid),
                                          [e.tick, e.tick])
                spans[(e.replica, e.rid)] = [min(lo, e.tick),
                                             max(hi, e.tick)]
        for (pid, tid), label in sorted(lanes.items()):
            evs.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": f"replica {pid}"}})
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": label}})
        for (replica, rid), (lo, hi) in sorted(spans.items()):
            evs.append({"ph": "X", "name": f"req {rid}",
                        "cat": "request", "pid": replica, "tid": rid + 1,
                        "ts": lo * TICK_US,
                        "dur": (hi - lo + 1) * TICK_US,
                        "args": {"rid": rid}})
        for e in self.events:
            args = {k: _json_safe(v) for k, v in e.attrs.items()}
            args["tick"] = e.tick
            if e.rid is not None:
                args["rid"] = e.rid
            evs.append({"ph": "X", "name": e.name, "cat": "serving",
                        "pid": e.replica,
                        "tid": 0 if e.rid is None else int(e.rid) + 1,
                        "ts": e.tick * TICK_US, "dur": TICK_US,
                        "args": args})
        doc = {"traceEvents": evs, "displayTimeUnit": "ms",
               "otherData": {"tick_us": TICK_US,
                             "dropped_events": self.dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc
