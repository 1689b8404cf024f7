"""Observability plane: tracing, collective probes, streaming metrics (the
port of ``repro.obs``).

Three pillars, all zero-overhead when off:

* :mod:`repro_torch.obs.trace` — structured tick tracing with JSONL and
  Chrome-trace/Perfetto exporters; pure observation (the same tokens with
  tracing on and off).
* :mod:`repro_torch.obs.probe` + :mod:`repro_torch.obs.fit` — collective
  timing samples ``(p, nbytes, dtype, method, num_blocks) -> wall time``
  and the least-squares ``(alpha, beta)`` fitter that turns them into
  fresh CommModel constants with predicted-vs-measured residuals.
* :mod:`repro_torch.obs.hist` — fixed-bucket TTFT/latency histograms that
  ride the same b=1 dual-root stats reduction (counts merge by the
  addition the tree already does).
"""

from repro_torch.obs.fit import (FitResult, export_residuals, fit_alpha_beta,
                                 fit_hier, flat_coeffs, residual_report)
from repro_torch.obs.hist import DEFAULT_EDGES, StreamingMetrics, TickHistogram
from repro_torch.obs.probe import (CollectiveProbe, ProbeSample, active,
                                   install, predict_time, probing, uninstall)
from repro_torch.obs.trace import SPAN_NAMES, TICK_US, TraceEvent, Tracer

__all__ = [
    "SPAN_NAMES", "TICK_US", "TraceEvent", "Tracer",
    "CollectiveProbe", "ProbeSample", "active", "install", "predict_time",
    "probing", "uninstall",
    "FitResult", "export_residuals", "fit_alpha_beta", "fit_hier",
    "flat_coeffs", "residual_report",
    "DEFAULT_EDGES", "StreamingMetrics", "TickHistogram",
]
