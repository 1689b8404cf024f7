"""Fleet-mergeable fixed-bucket histograms riding the b=1 stats tree (the
port of ``repro.obs.hist``, copied: numpy only).

A histogram with FIXED bucket edges is just a vector of counts, and
vectors of counts merge by elementwise addition — exactly the operation
the per-tick stats reduction already performs over the dual-root tree in
its b=1 latency-bound regime (docs/serving.md). So live fleet-wide
TTFT/latency percentiles cost no second collective: the engine appends
each tick's histogram increments to the stats row, the SAME
``make_stats_reducer`` reduction sums them across replicas (the reducer
is width-agnostic), and the session absorbs the reduced tail back into
its :class:`StreamingMetrics`. The payload grows from 16 to
``16 + 2 * n_buckets`` float32s — still well under the wire sizes where
the b=1 tree analysis in docs/serving.md holds.

Percentiles from fixed buckets are CONSERVATIVE: :meth:`TickHistogram
.percentile` returns the upper edge of the bucket containing the
quantile (inf-bucket -> the largest finite edge). That is the right bias
for SLO monitoring — a reported p99 is never better than reality.

Bucket edges are in TICKS (the serving clock), powers of two by default:
a request's TTFT or total latency lands in the first bucket whose upper
edge is >= the value.
"""

from __future__ import annotations

import numpy as np

# Default upper edges, in ticks; one overflow bucket past the last edge.
# Powers of two cover the simulator's realistic range (a few ticks of
# queueing through ~max_new_tokens of decode) with relative resolution.
DEFAULT_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class TickHistogram:
    """Fixed-bucket counting histogram over tick-valued observations.

    ``len(edges) + 1`` buckets: ``(-inf, e0], (e0, e1], ..., (e_last,
    inf)``. Counts are float64 on the host (they travel the wire as
    float32 rows; exact for counts < 2**24, far past any run here).
    """

    def __init__(self, edges=DEFAULT_EDGES):
        e = tuple(float(x) for x in edges)
        if len(e) < 1 or any(b <= a for a, b in zip(e, e[1:])):
            raise ValueError(
                f"edges must be non-empty and strictly increasing, got {e}")
        self.edges = e
        self.counts = np.zeros(len(e) + 1, np.float64)

    @property
    def n_buckets(self) -> int:
        return len(self.counts)

    def add(self, value: float) -> None:
        self.counts[int(np.searchsorted(self.edges, float(value)))] += 1

    def add_many(self, values) -> None:
        for v in values:
            self.add(v)

    def merge_counts(self, counts) -> None:
        """Fold in a same-shape count vector (e.g. a reduced stats tail)."""
        arr = np.asarray(counts, np.float64).reshape(-1)
        if arr.shape != self.counts.shape:
            raise ValueError(
                f"histogram merge shape {arr.shape} != {self.counts.shape}")
        self.counts += arr

    def total(self) -> float:
        return float(self.counts.sum())

    def percentile(self, q: float) -> float:
        """Conservative quantile: the upper edge of the bucket holding the
        q-th percentile (NaN when empty; the last finite edge for the
        overflow bucket)."""
        total = self.counts.sum()
        if total <= 0:
            return float("nan")
        target = (q / 100.0) * total
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, target, side="left"))
        return self.edges[min(idx, len(self.edges) - 1)]

    def to_dict(self) -> dict:
        return {"edges": list(self.edges),
                "counts": [float(c) for c in self.counts]}


class StreamingMetrics:
    """Live TTFT + latency histograms for one engine (or a whole fleet).

    The tick loop calls :meth:`row` with the tick's fresh observations; the
    returned increment vector is appended to the stats row and reduced
    with everything else. After the reduction the session hands the
    reduced tail to :meth:`absorb`, so under a p-way reducer the
    histograms accumulate the fleet-wide (single-controller: p-tiled)
    counts — the same semantic every other stats counter has.
    """

    def __init__(self, edges=DEFAULT_EDGES):
        self.ttft = TickHistogram(edges)
        self.latency = TickHistogram(edges)

    @property
    def width(self) -> int:
        """Payload floats this object appends to each stats row."""
        return self.ttft.n_buckets + self.latency.n_buckets

    def row(self, ttfts, latencies) -> list:
        """This tick's histogram INCREMENTS (not cumulative counts) as a
        flat float list: ttft buckets then latency buckets. Does not
        mutate the histograms — counts only land via :meth:`absorb`, so
        single-engine and fleet runs share one code path."""
        t = TickHistogram(self.ttft.edges)
        t.add_many(ttfts)
        la = TickHistogram(self.latency.edges)
        la.add_many(latencies)
        return [float(x) for x in t.counts] + [float(x) for x in la.counts]

    def absorb(self, tail) -> None:
        """Fold a reduced stats-row tail (``width`` floats) back in."""
        arr = np.asarray(tail, np.float64).reshape(-1)
        if arr.shape[0] != self.width:
            raise ValueError(
                f"metrics tail has {arr.shape[0]} floats, want {self.width}")
        n = self.ttft.n_buckets
        self.ttft.merge_counts(arr[:n])
        self.latency.merge_counts(arr[n:])

    def snapshot(self) -> dict:
        """Live percentiles + totals, JSON-safe (the ``metrics`` trace
        event / ``--metrics-every`` line)."""
        return {
            "ttft_n": self.ttft.total(),
            "ttft_ticks_p50": self.ttft.percentile(50),
            "ttft_ticks_p99": self.ttft.percentile(99),
            "latency_n": self.latency.total(),
            "latency_ticks_p50": self.latency.percentile(50),
            "latency_ticks_p99": self.latency.percentile(99),
        }
