"""Collective timing probes: ``(p, nbytes, dtype, method, num_blocks) -> t``
(the port of ``repro.obs.probe``).

The cost model (:mod:`repro_torch.core.cost_model`) predicts collective
times from ``alpha + beta * n`` constants; fitting those constants from
measurement needs samples. This module is the measurement substrate: a
process-wide :class:`CollectiveProbe` that the collective layer reports
into whenever one is installed.

Two sample kinds, as in the reference. The port runs eagerly, so both are
taken per call:

* ``kind="trace"`` — noted by :func:`repro_torch.core.collectives
  .all_reduce` and :func:`repro_torch.core.dptree.hier_allreduce` on every
  call: which algorithm the switch picked, with how many pipeline blocks,
  for which ``(p, nbytes, dtype)``. No wall time: it records WHAT ran.
  (The reference notes one per compilation, at trace time.)
* ``kind="timed"`` — recorded at the host boundary by the stats reducer
  (:func:`repro_torch.serving.telemetry.make_stats_reducer`): the wall time
  of one reduction, CUDA events around it and a synchronize on the card,
  ``perf_counter`` on the CPU, with the method and blocks resolved through
  the same ``_pick`` the collective used.

Samples go into a bounded ring buffer (``collections.deque(maxlen=...)``)
so a probe can stay installed across a long run. ``predicted_s`` carries
the cost model's prediction for the same shape, so
:mod:`repro_torch.obs.fit` can report predicted-vs-measured residuals and
fit fresh ``(alpha, beta)`` estimates from the timed samples. The default
model is the port's ``PAPER_HYDRA`` (the reference's is its TPU preset,
which the port does not carry).

Zero overhead when off: the collective layer checks one module-level
``None`` before doing anything.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

from repro_torch.core import cost_model as cm


@dataclasses.dataclass(frozen=True)
class ProbeSample:
    """One observed (or trace-time noted) collective.

    ``wall_s`` is 0.0 for ``kind="trace"`` samples (no clock).
    ``levels`` is the hierarchy spec for ``method="hier"``; ``axis`` the
    mesh axis name when known (None in the port, whose transports have no
    axis names). ``predicted_s`` is the
    alpha-beta model's time for the same ``(p, nbytes, blocks)`` under
    ``model`` (None when the method has no closed form, e.g. psum).
    """

    p: int
    nbytes: int
    dtype: str
    method: str
    num_blocks: int
    wall_s: float = 0.0
    predicted_s: float | None = None
    kind: str = "timed"
    levels: tuple | None = None
    axis: str | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["levels"] is not None:
            d["levels"] = list(d["levels"])
        return d


def predict_time(method: str, p: int, nbytes: int, num_blocks: int,
                 model: cm.CommModel = cm.PAPER_HYDRA,
                 levels=None,
                 intra_model: cm.CommModel | None = None) -> float | None:
    """The cost model's prediction for one collective shape, or None for
    methods it has no closed form for (psum — XLA's own schedule)."""
    m, b = float(max(nbytes, 1)), max(1, int(num_blocks))
    if method == "dptree":
        return cm.dptree_time(p, m, b, model)
    if method == "sptree":
        return cm.sptree_time(p, m, b, model)
    if method == "redbcast":
        return cm.redbcast_time(p, m, b, model)
    if method == "ring":
        return cm.ring_time(p, m, model)
    if method == "hier":
        return cm.hier_time(p, m, b, model, group_size=levels,
                            intra_model=intra_model)
    return None


class CollectiveProbe:
    """Bounded ring buffer of :class:`ProbeSample` records."""

    def __init__(self, capacity: int = 4096,
                 model: cm.CommModel = cm.PAPER_HYDRA):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.model = model
        self.samples: collections.deque = collections.deque(maxlen=capacity)
        self.n_seen = 0            # total records, including ring-evicted

    def __len__(self) -> int:
        return len(self.samples)

    def record(self, sample: ProbeSample) -> None:
        self.samples.append(sample)
        self.n_seen += 1

    def note(self, method: str, p: int, nbytes: int, num_blocks: int, *,
             dtype: str = "float32", kind: str = "trace",
             wall_s: float = 0.0, levels=None, axis=None) -> ProbeSample:
        """Build + record one sample, filling ``predicted_s`` from the
        probe's cost model. Returns the recorded sample."""
        s = ProbeSample(
            p=int(p), nbytes=int(nbytes), dtype=str(dtype),
            method=str(method), num_blocks=max(1, int(num_blocks)),
            wall_s=float(wall_s),
            predicted_s=predict_time(method, int(p), int(nbytes),
                                     int(num_blocks), self.model,
                                     levels=levels),
            kind=kind,
            levels=tuple(levels) if levels is not None
            and not isinstance(levels, int) else levels,
            axis=axis)
        self.record(s)
        return s

    def timed(self) -> list:
        return [s for s in self.samples if s.kind == "timed"]

    def traced(self) -> list:
        return [s for s in self.samples if s.kind == "trace"]


# ---------------------------------------------------------------- install
# Process-wide active probe: the collective layer takes no probe argument,
# so installation is ambient (like a profiler). None (the default)
# short-circuits every hook.
_ACTIVE: CollectiveProbe | None = None


def install(probe: CollectiveProbe) -> CollectiveProbe:
    """Make ``probe`` the process-wide active probe; returns it."""
    global _ACTIVE
    _ACTIVE = probe
    return probe


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> CollectiveProbe | None:
    """The installed probe, or None (the zero-overhead default)."""
    return _ACTIVE


@contextlib.contextmanager
def probing(capacity: int = 4096, model: cm.CommModel = cm.PAPER_HYDRA):
    """``with probing() as probe:`` — install a fresh probe for the block,
    restoring whatever was installed before on exit."""
    global _ACTIVE
    prev = _ACTIVE
    probe = CollectiveProbe(capacity=capacity, model=model)
    _ACTIVE = probe
    try:
        yield probe
    finally:
        _ACTIVE = prev
