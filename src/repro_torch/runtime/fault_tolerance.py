"""Fault-tolerance runtime: failure detection, elastic re-meshing,
straggler mitigation and the restarting training supervisor (the port of
``repro.runtime.fault_tolerance``).

The heartbeat transport is injectable, so tests and the serving fleet's
tick simulation kill "hosts" deterministically with a fake clock. The
dual-tree topology is parametric in ``p``: any surviving subset of hosts
re-forms a valid collective schedule, and the same property lets it grow
back over a rejoined host.

The :class:`HeartbeatMonitor` is a flap-tolerant state machine:

    ALIVE --missed deadline--> SUSPECT --``misses`` deadlines--> DEAD
      ^                           |                               |
      |____resumed beats__________|        resumed beats + backoff|
      |___________________________________________________________|
                              (rejoin)

``misses=1`` (the default) collapses SUSPECT into DEAD. A dropped host that
beats again becomes *rejoinable* once it has beaten steadily for its
backoff window, which doubles with every drop.

:func:`run_with_restarts` runs a training attempt and, when it raises
:class:`HostFailure`, runs another, which restores from the latest
checkpoint on entry (:func:`repro_torch.launch.train.train_loop` does).
Between attempts it waits an exponential backoff with a jitter drawn
deterministically from ``(seed, attempt)``, as the reference does.

The reference's cost-model default is its TPU preset; the port's is
``PAPER_HYDRA`` (:mod:`repro_torch.core.cost_model` carries no other).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.topology import build_dual_tree

__all__ = ["HostFailure", "HeartbeatMonitor", "ElasticPlan", "plan_remesh",
           "StragglerTuner", "run_with_restarts"]


class HostFailure(RuntimeError):
    """Raised (or injected) when hosts miss their heartbeat deadline.

    ``host`` is the first (lowest-id) dead host; ``hosts`` is the full dead
    set found by the same poll."""

    def __init__(self, host: int, msg: str = "", hosts=None):
        self.host = host
        self.hosts = tuple(hosts) if hosts else (host,)
        if not msg:
            ids = ", ".join(str(h) for h in self.hosts)
            noun = "hosts" if len(self.hosts) > 1 else "host"
            msg = f"{noun} {ids} failed heartbeat"
        super().__init__(msg)


class HeartbeatMonitor:
    """Tracks last-seen timestamps per host; see the module docstring for
    the ALIVE/SUSPECT/DEAD/rejoin state machine.

    ``timeout_s`` is one missed deadline; a host is SUSPECT past
    ``timeout_s`` and DEAD past ``misses * timeout_s``. ``rejoin_backoff_s``
    is the base probation a dropped host must beat through before
    :meth:`rejoinable` reports it (doubled per drop, capped at
    ``rejoin_cap_s``); 0 means a single resumed beat suffices."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic, *,
                 misses: int = 1, rejoin_backoff_s: float = 0.0,
                 rejoin_cap_s: float = 3600.0):
        if misses < 1:
            raise ValueError(f"misses must be >= 1, got {misses}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.misses = misses
        self.rejoin_backoff_s = rejoin_backoff_s
        self.rejoin_cap_s = rejoin_cap_s
        self._clock = clock
        now = clock()
        self._last = {h: now for h in range(n_hosts)}
        self._drops: dict = {}    # host -> times dropped (persists forever)
        # dropped host -> {"resumed": t or None, "last": t}
        self._gone: dict = {}

    def beat(self, host: int):
        if host in self._gone:
            # a dropped host talking again: start (or continue) probation
            info = self._gone[host]
            now = self._clock()
            if info["resumed"] is None:
                info["resumed"] = now
            info["last"] = now
            return
        self._last[host] = self._clock()

    def suspect_hosts(self) -> list:
        """Hosts past one deadline but not yet declared dead (the flap
        grace window; empty when ``misses == 1``)."""
        now = self._clock()
        return sorted(h for h, t in self._last.items()
                      if self.timeout_s < now - t <= self.misses
                      * self.timeout_s)

    def dead_hosts(self) -> list:
        """Every host past ``misses`` deadlines, ascending — one clock
        read, so two hosts that died in the same interval are BOTH reported
        by the same poll (the serving fleet must fail them over together;
        handling one per poll lets orphans be re-placed onto a replica that
        is already dead but not yet detected)."""
        now = self._clock()
        return sorted(h for h, t in self._last.items()
                      if now - t > self.misses * self.timeout_s)

    def check(self):
        dead = self.dead_hosts()
        if dead:
            raise HostFailure(dead[0], hosts=tuple(dead))

    def drop(self, host: int):
        self._last.pop(host, None)
        self._drops[host] = self._drops.get(host, 0) + 1
        self._gone[host] = {"resumed": None, "last": None}
        self.n_hosts -= 1

    def rejoin_backoff(self, host: int) -> float:
        """This host's current probation window (exponential per drop)."""
        k = max(1, self._drops.get(host, 1))
        return min(self.rejoin_cap_s, self.rejoin_backoff_s * 2 ** (k - 1))

    def rejoinable(self) -> list:
        """Dropped hosts that have resumed beating and beaten steadily
        through their backoff window. A host whose resumed beats go stale
        again (flapping during probation) restarts its probation."""
        now = self._clock()
        out = []
        for h in sorted(self._gone):
            info = self._gone[h]
            if info["resumed"] is None:
                continue
            if now - info["last"] > self.timeout_s:
                info["resumed"] = None          # flapped during probation
                continue
            if now - info["resumed"] >= self.rejoin_backoff(h):
                out.append(h)
        return out

    def readmit(self, host: int):
        """Move a rejoinable host back to the alive set."""
        if host not in self._gone:
            raise ValueError(f"host {host} was never dropped")
        del self._gone[host]
        self._last[host] = self._clock()
        self.n_hosts += 1


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Result of re-planning after a membership change."""
    survivors: tuple
    new_p: int
    topology_height: int
    predicted_allreduce_s: float
    new_num_blocks: int


def plan_remesh(survivors, grad_bytes: float,
                model: cm.CommModel = cm.PAPER_HYDRA) -> ElasticPlan:
    """Rebuild the collective plan for the surviving data-parallel ranks.

    The same call re-plans a *grow*: the dual-root tree is parametric in
    ``p``, so a rejoined rank simply yields a taller/wider schedule —
    shrink and grow are the one code path."""
    p = len(survivors)
    topo = build_dual_tree(p)
    b = cm.optimal_blocks(p, grad_bytes, model, "dptree")
    t = cm.dptree_time(p, grad_bytes, b, model)
    return ElasticPlan(tuple(survivors), p, topo.max_depth, t, b)


class StragglerTuner:
    """Pipelined trees are bulk-synchronous per macro-round: one slow link
    stretches every round. When observed step time exceeds the model's
    prediction by ``threshold``, shrink the block count (fewer, larger rounds
    amortize the straggler's per-round latency penalty alpha_hat). When the
    observed times later return to the base model's prediction, re-solve
    back to the unscaled optimum — a transient straggler must not
    permanently pessimize the collective (``recovery`` is the tolerance on
    "returned to prediction")."""

    def __init__(self, p: int, grad_bytes: float,
                 model: cm.CommModel = cm.PAPER_HYDRA, threshold: float = 1.5,
                 window: int = 20, recovery: float = 1.25):
        self.p, self.grad_bytes, self.model = p, grad_bytes, model
        self.threshold = threshold
        self.recovery = recovery
        self.window = window
        self.times: list = []
        self.num_blocks = cm.optimal_blocks(p, grad_bytes, model, "dptree")
        self._opt_blocks = self.num_blocks    # the unscaled-model optimum

    def observe(self, step_time_s: float) -> int:
        self.times.append(step_time_s)
        if len(self.times) >= self.window:
            med = float(np.median(self.times[-self.window:]))
            pred = cm.dptree_time(self.p, self.grad_bytes, self.num_blocks,
                                  self.model)
            if pred > 0 and med > self.threshold * pred:
                # effective alpha grew: re-solve with alpha_hat = alpha*ratio
                ratio = med / pred
                scaled = cm.CommModel(self.model.alpha * ratio,
                                      self.model.beta, self.model.gamma)
                self.num_blocks = max(1, cm.optimal_blocks(
                    self.p, self.grad_bytes, scaled, "dptree"))
                self.times.clear()
            elif (self.num_blocks != self._opt_blocks
                  and med <= self.recovery * pred):
                # observed times match the BASE model again at the current
                # block count: the straggler cleared — undo the ratchet
                self.num_blocks = self._opt_blocks
                self.times.clear()
        return self.num_blocks


def run_with_restarts(loop_fn: Callable[[int], object], max_restarts: int = 3,
                      *, backoff_s: float = 0.0, backoff_cap_s: float = 60.0,
                      jitter: float = 0.1, seed: int = 0,
                      sleep: Callable[[float], None] = time.sleep):
    """Supervise ``loop_fn(attempt)``; on :class:`HostFailure` run it again
    (``loop_fn`` restores from the latest checkpoint on entry), at most
    ``max_restarts`` times, then re-raise. Returns the last attempt's
    result with its ``restarts`` count set: a dict's ``"restarts"`` key, or
    the attribute of any other result (the port's ``TrainRun``).

    Between restarts the supervisor waits ``backoff_s * 2**(attempt-1)``
    seconds (capped at ``backoff_cap_s``) times ``1 + f``, with ``f`` in
    ``[0, jitter)`` drawn from ``np.random.default_rng(seed + attempt)``:
    every run with the same seed waits the same schedule. ``backoff_s=0``
    (the default) restarts at once."""
    attempt = 0
    while True:
        try:
            out = loop_fn(attempt)
            break
        except HostFailure:
            attempt += 1
            if attempt > max_restarts:
                raise
        # out of the handler: the failed attempt's frames, and the tensors
        # they held, are released before the wait and the next attempt
        if backoff_s > 0:
            delay = min(backoff_cap_s, backoff_s * 2 ** (attempt - 1))
            frac = float(np.random.default_rng(
                seed + attempt).uniform(0.0, max(jitter, 0.0)))
            sleep(delay * (1.0 + frac))
    if isinstance(out, dict):
        out["restarts"] = attempt
    else:
        out.restarts = attempt
    return out
