"""Least-squares ``(alpha, beta)`` fitting from probe samples (the port of
``repro.obs.fit``, copied: numpy only).

The closed-form times in :mod:`repro_torch.core.cost_model` are all LINEAR in
the communication constants once ``gamma = 0``: every algorithm's
``T(p, m, b; alpha, beta)`` is ``c_a(p, m, b) * alpha + c_b(p, m, b) *
beta`` for shape-only coefficients. That makes fitting trivial and exact:
evaluate each time function twice — once under ``CommModel(1, 0)`` and
once under ``CommModel(0, 1)`` — to read off the coefficients, stack one
row per measured sample, and solve the least-squares system. The same
trick extends to the hierarchical composition, because ``hier_time`` is a
SUM of stage terms, each linear in its fabric's constants — though a
fixed level spec only identifies a SHARED intra pair plus the inter pair
(see :func:`fit_hier` for why per-level constants are collinear there).

This is the ROADMAP's "per-level CommModel constants fitted from
measurement" machinery, runnable today against the simulator's timed
samples and ready for a real multi-pod fabric: collect
:class:`~repro_torch.obs.probe.ProbeSample` records with
:func:`~repro_torch.obs.probe.probing`, call :func:`fit_alpha_beta` (flat
algorithms) or :func:`fit_hier` (per-level), and compare the refit model
against the presets with :func:`residual_report` /
:func:`export_residuals` (residuals land in the trace as
``probe_residual`` events). The property suite (tests/test_obs.py)
round-trips simulator-generated samples through the fitter and requires
the recovered constants within 10% under noise (tests/test_torch_obs.py
holds the port's fit to the reference's on the same samples).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.obs.probe import ProbeSample, predict_time

_UNIT_ALPHA = cm.CommModel(alpha=1.0, beta=0.0, gamma=0.0, name="unit_alpha")
_UNIT_BETA = cm.CommModel(alpha=0.0, beta=1.0, gamma=0.0, name="unit_beta")
_ZERO = cm.CommModel(alpha=0.0, beta=0.0, gamma=0.0, name="zero")

# Flat algorithms with a pipelined closed form; ring is handled explicitly
# (its time ignores the block count).
_FLAT = ("dptree", "sptree", "redbcast", "ring")


def flat_coeffs(method: str, p: int, m_bytes: float, b: int) -> tuple:
    """``(c_alpha, c_beta)`` such that ``T = c_alpha*alpha + c_beta*beta``
    for a flat algorithm at shape ``(p, m_bytes, b)``."""
    if method == "ring":
        return (cm.ring_time(p, m_bytes, _UNIT_ALPHA),
                cm.ring_time(p, m_bytes, _UNIT_BETA))
    fn = cm._TIME_FNS[method]
    return (fn(p, m_bytes, b, _UNIT_ALPHA), fn(p, m_bytes, b, _UNIT_BETA))


@dataclasses.dataclass(frozen=True)
class FitResult:
    """A fitted ``(alpha, beta)`` with its per-sample diagnostics.

    ``residuals[i]`` is ``measured_i - fitted_i`` seconds for the i-th
    accepted sample; ``max_rel_err`` the largest ``|residual| / measured``
    — the honesty number a refit must quote next to its constants.
    """

    alpha: float
    beta: float
    n_samples: int
    residuals: tuple
    max_rel_err: float

    def model(self, name: str = "fitted") -> cm.CommModel:
        """The fitted constants as a :class:`~repro_torch.core.cost_model
        .CommModel` (gamma 0 — the fit cannot separate it from beta)."""
        return cm.CommModel(alpha=self.alpha, beta=self.beta, gamma=0.0,
                            name=name)


def _solve(A: np.ndarray, y: np.ndarray, n_params: int) -> np.ndarray:
    if A.shape[0] < n_params:
        raise ValueError(
            f"need at least {n_params} samples to fit {n_params} "
            f"parameters, got {A.shape[0]}")
    if np.linalg.matrix_rank(A) < n_params:
        raise ValueError(
            "probe samples do not span the parameter space (all the same "
            "(p, nbytes, blocks) shape?) — vary the payload size")
    x, *_ = np.linalg.lstsq(A, y, rcond=None)
    return x


def _diag(A, y, x) -> tuple:
    fitted = A @ x
    resid = y - fitted
    rel = np.abs(resid) / np.maximum(np.abs(y), 1e-30)
    return tuple(float(r) for r in resid), float(rel.max())


def fit_alpha_beta(samples, *, methods=_FLAT) -> FitResult:
    """Fit one ``(alpha, beta)`` pair from timed flat-algorithm samples.

    ``samples`` is any iterable of :class:`~repro_torch.obs.probe.ProbeSample`;
    only ``kind="timed"`` samples whose method is in ``methods`` enter the
    system (trace-time notes have no wall clock). Samples may mix
    algorithms — each row uses its own method's coefficients, which is
    what lets a heterogeneous run (stats tree + TP tree + a ring bucket)
    constrain one fabric's constants together.
    """
    rows, y = [], []
    for s in samples:
        if s.kind != "timed" or s.method not in methods:
            continue
        rows.append(flat_coeffs(s.method, s.p, float(max(s.nbytes, 1)),
                                s.num_blocks))
        y.append(s.wall_s)
    A, yv = np.asarray(rows, np.float64), np.asarray(y, np.float64)
    x = _solve(A, yv, 2)
    resid, max_rel = _diag(A, yv, x)
    return FitResult(alpha=float(x[0]), beta=float(x[1]),
                     n_samples=len(yv), residuals=resid,
                     max_rel_err=max_rel)


def fit_hier(samples) -> dict:
    """Shared intra + inter ``(alpha, beta)`` from timed hier samples.

    Every sample must carry the SAME hierarchy spec (``levels``). The
    design has four columns — intra alpha/beta (one pair shared by every
    fast level) and inter alpha/beta — read off ``cost_model.hier_time``
    by evaluating it with unit constants on one side and zeros on the
    other. Returns ``{"intra": FitResult, "inter": FitResult, "spec":
    levels}`` where both FitResults share the joint fit's residuals.

    Why not per-level constants: at a FIXED spec, level ``j``'s alpha
    coefficient is the constant ``2 * (s_j - 1)`` for every sample and its
    beta coefficient is proportional to ``m`` — so the per-level columns
    are pairwise collinear and no amount of sampling separates them. A
    shared intra pair is the finest parameterization one spec identifies
    (``cost_model.hier_time``'s ``intra_model``); distinguishing the
    levels takes runs under DIFFERENT specs, fitted separately. Samples
    must still vary ``p`` (the inter stage's only lever against the
    intra columns) as well as the payload size.
    """
    samples = [s for s in samples if s.kind == "timed"
               and s.method == "hier"]
    if not samples:
        raise ValueError("no timed hier samples to fit")
    specs = {tuple(s.levels) if s.levels is not None else None
             for s in samples}
    if len(specs) != 1 or None in specs:
        raise ValueError(
            f"hier samples must share one explicit level spec, got {specs}")
    levels = specs.pop()

    def cols(s: ProbeSample) -> list:
        p, m, b = s.p, float(max(s.nbytes, 1)), s.num_blocks
        return [cm.hier_time(p, m, b, _ZERO, group_size=levels,
                             intra_model=unit)
                for unit in (_UNIT_ALPHA, _UNIT_BETA)] + \
               [cm.hier_time(p, m, b, unit, group_size=levels,
                             intra_model=_ZERO)
                for unit in (_UNIT_ALPHA, _UNIT_BETA)]

    A = np.asarray([cols(s) for s in samples], np.float64)
    y = np.asarray([s.wall_s for s in samples], np.float64)
    x = _solve(A, y, 4)
    resid, max_rel = _diag(A, y, x)
    intra, inter = [FitResult(alpha=float(x[2 * j]), beta=float(x[2 * j + 1]),
                              n_samples=len(y), residuals=resid,
                              max_rel_err=max_rel) for j in (0, 1)]
    return {"intra": intra, "inter": inter, "spec": levels}


def residual_report(samples, model: cm.CommModel = cm.PAPER_HYDRA,
                    intra_model: cm.CommModel | None = None) -> list:
    """Predicted-vs-measured rows for every timed sample: ``[{p, nbytes,
    method, num_blocks, measured_s, predicted_s, residual_s, rel_err}]``.
    ``model`` prices the (inter-group) fabric the prediction uses —
    pass a :meth:`FitResult.model` to score a refit against held-out
    samples, or a preset to see how far the hardware drifted from it."""
    rows = []
    for s in samples:
        if s.kind != "timed":
            continue
        pred = predict_time(s.method, s.p, s.nbytes, s.num_blocks, model,
                            levels=s.levels, intra_model=intra_model)
        if pred is None:
            continue
        resid = s.wall_s - pred
        rows.append({"p": s.p, "nbytes": s.nbytes, "method": s.method,
                     "num_blocks": s.num_blocks,
                     "measured_s": float(s.wall_s),
                     "predicted_s": float(pred),
                     "residual_s": float(resid),
                     "rel_err": float(abs(resid)
                                      / max(abs(s.wall_s), 1e-30))})
    return rows


def export_residuals(tracer, samples, *, tick: int = 0,
                     model: cm.CommModel = cm.PAPER_HYDRA,
                     intra_model: cm.CommModel | None = None) -> int:
    """Emit one ``probe_residual`` trace event per timed sample (the
    predicted-vs-measured view rides the same trace file the serving
    events land in). Returns the number of events emitted."""
    rows = residual_report(samples, model, intra_model)
    for r in rows:
        tracer.event("probe_residual", tick, **r)
    return len(rows)
