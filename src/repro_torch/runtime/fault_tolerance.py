"""The restarting training supervisor (the port of the part of
``repro.runtime.fault_tolerance`` that one host runs).

:func:`run_with_restarts` runs a training attempt and, when it raises
:class:`HostFailure`, runs another, which restores from the latest
checkpoint on entry (:func:`repro_torch.launch.train.train_loop` does).
Between attempts it waits an exponential backoff with a jitter drawn
deterministically from ``(seed, attempt)``, as the reference does. The
reference's heartbeat monitor, elastic re-meshing and straggler tuner serve
a fleet of hosts: ROADMAP.md queue 1, 'Next' items 2 and 4.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

__all__ = ["HostFailure", "run_with_restarts"]


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
