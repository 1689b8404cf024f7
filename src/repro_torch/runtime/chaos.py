"""Deterministic fault injection for the runtime and serving stacks (the
port of ``repro.runtime.chaos``: everything copied but :func:`poison_slot`,
which writes into the port's torch caches).

Every failure scenario the fleet must survive — replica death, heartbeat
flapping, straggler ticks, NaN/Inf-poisoned logits, corrupted autotune
cache entries — is described by a :class:`FaultPlan`: an immutable schedule
of :class:`Fault` events pinned to engine *ticks*. A plan is either written
out explicitly (regression tests pin exact scenarios) or derived from a
seed (:meth:`FaultPlan.seeded`), so every scenario is a pure function of
``(seed, tick)`` and replays bit-for-bit in tests, benches, and the
``serve.py --chaos-seed`` demo.

The :class:`FaultInjector` is a *stateless* view over a plan: all queries
(``silenced``, ``skips_tick``, ``poisons``, ...) depend only on the plan
and the tick argument, never on call order. The injector decides *what*
goes wrong and *when*; the consequences run through the production paths —
a silenced replica simply stops heartbeating (the
:class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor` state
machine does the rest), a poisoned cache flows through the real decode
step (on a card, its kernels) and trips the engine's non-finite-logits
guard, a corrupted autotune entry exercises the cache's
degrade-never-raise contract.

Fault kinds:

``kill``      the replica stops beating at ``tick`` and never returns.
``flap``      the replica goes silent for ``duration`` ticks, then resumes
              beating — below the monitor's death threshold it survives
              (suspect -> alive); above it, it dies and later REJOINS.
``straggle``  for ``duration`` ticks the replica runs ``factor``x slower
              (it still heartbeats; in the tick simulation it processes
              only every ``round(factor)``-th tick).
``poison``    at ``tick`` the replica's busiest decode slot gets NaN
              written into its cache rows — the next decode produces
              non-finite logits and the engine must quarantine, not commit.
``corrupt``   an autotune-cache entry is corrupted on disk (see
              :func:`corrupt_autotune_cache`) — consumers must degrade to
              the cost-model switch, never raise.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

__all__ = ["KINDS", "Fault", "FaultPlan", "FaultInjector", "poison_slot",
           "corrupt_autotune_cache"]

KINDS = ("kill", "flap", "straggle", "poison", "corrupt")


@dataclasses.dataclass(frozen=True, order=True)
class Fault:
    """One scheduled failure event at a tick boundary."""

    tick: int
    kind: str = "kill"
    replica: int = 0
    duration: int = 0        # flap: silent ticks; straggle: affected ticks
    factor: float = 2.0      # straggle: slowdown multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; want {KINDS}")
        if self.tick < 0 or self.replica < 0:
            raise ValueError(f"tick/replica must be >= 0, got {self}")
        if self.kind in ("flap", "straggle") and self.duration < 1:
            raise ValueError(f"{self.kind} needs duration >= 1, got {self}")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, tick-sorted schedule of faults."""

    faults: tuple = ()

    def __post_init__(self):
        fs = tuple(sorted(self.faults))
        for f in fs:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan wants Fault entries, got {f!r}")
        object.__setattr__(self, "faults", fs)

    @classmethod
    def seeded(cls, seed: int, *, n_replicas: int, horizon: int,
               n_faults: int = 3,
               kinds=("kill", "flap", "straggle", "poison")) -> "FaultPlan":
        """A deterministic plan: the same ``(seed, n_replicas, horizon)``
        always yields the same schedule. Replica 0 is never killed outright
        so the fleet always keeps a survivor to fail over to."""
        if n_replicas < 1 or horizon < 2:
            raise ValueError("need n_replicas >= 1 and horizon >= 2")
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = str(kinds[int(rng.integers(len(kinds)))])
            lo = 1 if n_replicas > 1 and kind in ("kill", "flap") else 0
            replica = int(rng.integers(lo, n_replicas)) if n_replicas > lo \
                else 0
            tick = int(rng.integers(1, horizon))
            duration = (int(rng.integers(1, max(2, horizon // 2)))
                        if kind in ("flap", "straggle") else 0)
            factor = (float(2 ** int(rng.integers(1, 4)))
                      if kind == "straggle" else 2.0)
            faults.append(Fault(tick, kind, replica, duration, factor))
        return cls(tuple(faults))

    def at(self, tick: int) -> tuple:
        return tuple(f for f in self.faults if f.tick == tick)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)


class FaultInjector:
    """Stateless query interface over a :class:`FaultPlan`.

    Every method is a pure function of ``(plan, tick[, replica])`` — no
    internal counters, no call-order dependence — which is what makes a
    chaos run replayable from its seed alone."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def at(self, tick: int) -> tuple:
        return self.plan.at(tick)

    def silenced(self, tick: int, replica: int) -> bool:
        """True while the replica's process is stalled: killed for good, or
        inside a flap window. A silenced replica neither ticks nor beats."""
        for f in self.plan:
            if f.replica != replica:
                continue
            if f.kind == "kill" and tick >= f.tick:
                return True
            if f.kind == "flap" and f.tick <= tick < f.tick + f.duration:
                return True
        return False

    def straggle_factor(self, tick: int, replica: int) -> float:
        """The slowdown multiplier in effect (1.0 = healthy)."""
        fac = 1.0
        for f in self.plan:
            if (f.kind == "straggle" and f.replica == replica
                    and f.tick <= tick < f.tick + f.duration):
                fac = max(fac, f.factor)
        return fac

    def skips_tick(self, tick: int, replica: int) -> bool:
        """Tick-simulation form of a straggler: a ``factor``-x slower
        replica advances only every ``round(factor)``-th tick of the
        window (it keeps heartbeating — stragglers are slow, not dead)."""
        for f in self.plan:
            if (f.kind == "straggle" and f.replica == replica
                    and f.tick <= tick < f.tick + f.duration):
                if (tick - f.tick) % max(1, int(round(f.factor))) != 0:
                    return True
        return False

    def poisons(self, tick: int, replica: int) -> bool:
        return any(f.kind == "poison" and f.replica == replica
                   and f.tick == tick for f in self.plan)


def poison_slot(caches, slot: int):
    """NaN-poison one slot's cache rows, IN PLACE; returns ``caches``.

    ``caches`` is the port's per-slot cache tuple
    (:func:`repro_torch.models.transformer.init_cache` with
    ``per_slot=True``): one dict per attention sublayer, every leaf
    ``(n_periods, n_slots, ...)``. Floating-point leaves get their ``slot``
    row set to NaN (the bf16 ``k``/``v``, or under int8 the f32 scales
    ``ks``/``vs``); the int8 codes and the host positions ``pos`` are left
    alone, so the row still *looks* live. The poison surfaces where it
    would on real hardware: as non-finite decode logits, which the
    engine's guard must refuse to commit. The fleet assigns the result
    back to ``sess.caches``, as the reference's functional version
    needs."""
    for c in caches:
        for v in c.values():
            if v.ndim >= 2 and v.is_floating_point():
                v[:, slot] = float("nan")
    return caches


def corrupt_autotune_cache(path: str, seed: int = 0) -> str:
    """Deterministically corrupt an autotune cache file in place.

    Scrambles one existing entry (if any) into semantic garbage — an
    unknown algorithm and a non-positive block count — and appends a
    malformed entry. Returns the corrupted key. The degrade-never-raise
    contract (docs/autotuning.md) requires every consumer to treat such
    entries as cache misses."""
    rng = np.random.default_rng(seed)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {"schema": 1, "entries": {}}
    entries = doc.setdefault("entries", {})
    keys = sorted(entries)
    if keys:
        victim = keys[int(rng.integers(len(keys)))]
        entries[victim] = {"algorithm": "zz_bogus", "num_blocks": -7,
                           "time_s": float("1e300")}
    else:
        victim = "p=0|n=0|d=?|t=?"
        entries[victim] = {"algorithm": None, "num_blocks": "many"}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return victim
