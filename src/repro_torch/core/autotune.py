"""Empirical (algorithm, num_blocks) autotuner for the collective stack.

The paper's open question #1 is how to pick the pipeline block count; its
experimental lesson (Table 2: OpenMPI collapsing mid-range on a bad internal
switch) is *never let the library guess*. The analytic alpha-beta model in
:mod:`repro_torch.core.cost_model` is the first line of defense; this module closes
the loop empirically:

* :func:`candidate_settings` enumerates ``(algorithm, num_blocks)`` candidates
  around the analytic optimum (the analytic pick, its half/double block
  neighbors, plus every other modeled algorithm at its own optimum).
* :func:`tune` times the candidates through a caller-supplied ``runner`` —
  measurement has to happen inside a real mesh, which only the caller owns —
  and records the winner in a JSON cache on disk.
* :func:`lookup` is consulted by ``CollectiveConfig(method="auto")`` on
  every call: a cache hit overrides the analytic choice with the measured one.

Cache entries are keyed by ``(p, nbytes, dtype, topology)`` — where
``topology`` is the :class:`~repro_torch.core.cost_model.CommModel` name (or any
caller-chosen topology tag, e.g. ``"cpu8"`` for the virtual-device bench) —
plus, when tagged, the mesh ``axis`` the result was measured on (``'tp'``
per-token reductions vs ``'data'`` gradient buckets vs the replica-stats
tree), so results from different fabrics or axis roles never
cross-contaminate. A ``hier`` winner additionally
records the exact hierarchy level spec it was timed with and whether the
slow-stage bf16 wire was on (``compressed``); ``auto`` replays only that
exact configuration — and the compressed variant only for configs that set
``compress_inter_group`` themselves. Format and contract:
``docs/autotuning.md``.

The port's copy of ``repro.core.autotune``, with the same JSON schema and
keys. Its cache lives apart from the reference's
(``~/.cache/repro_torch/autotune.json``, overridden by
``REPRO_TORCH_AUTOTUNE_CACHE``; ``REPRO_TORCH_AUTOTUNE=0`` turns lookups
off), so winners the JAX package measured on its own devices are never
replayed on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Callable, Sequence

from repro_torch.core import cost_model as cm
from repro_torch.core.topology import as_levels, default_group_size

__all__ = [
    "TuneResult",
    "AutotuneCache",
    "COMPRESSED_SUFFIX",
    "candidate_settings",
    "tune",
    "lookup",
    "default_cache_path",
    "get_cache",
    "reset_cache",
    "set_cache_path",
]

_ALGORITHMS = ("dptree", "sptree", "redbcast", "ring")

# Every algorithm a cache entry may legitimately name (the tunable set plus
# the hierarchical composition). Entries outside this set — or with a
# non-positive block count or a non-finite time — are treated as cache
# MISSES by :meth:`AutotuneCache.get`: a corrupted cache file must degrade
# to the analytic cost-model switch, never crash a consumer (the
# degrade-never-raise contract).
_VALID_ALGORITHMS = frozenset(_ALGORITHMS) | {"hier"}

# Block-count multipliers probed around the analytic optimum.
_BLOCK_SWEEP = (0.5, 1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    algorithm: str
    num_blocks: int
    time_s: float
    # group shape a 'hier' winner was measured with — an int (two-level) or
    # a level tuple (N-level, innermost ring first); replayed on cache hits
    # so the consumer never executes a configuration that was never timed.
    group_size: int | tuple | None = None
    # whether the winner was timed with the bf16 inter-group wire; replayed
    # only when the consuming config also opts into the lossy compression.
    compressed: bool = False
    # mesh-axis tag the winner was measured on ('data' gradient buckets,
    # 'tp' per-token tensor-parallel reductions, 'replica' stats trees, ...).
    # Axis-tagged entries are only replayed for lookups probing the SAME
    # axis: a decode-sized TP tuning must never replay onto a gradient-
    # bucket config that happens to share (p, nbytes, dtype, topology).
    # None keys the legacy axis-less entry, which any lookup may fall back
    # to — existing cache files stay valid.
    axis: str | None = None


def _key(p: int, nbytes: int, dtype: str, topology: str,
         axis: str | None = None) -> str:
    base = f"p={int(p)}/nbytes={int(nbytes)}/dtype={dtype}/topo={topology}"
    return f"{base}/axis={axis}" if axis else base


# Explicit path override; takes precedence over the
# REPRO_TORCH_AUTOTUNE_CACHE env var, which stays the deployment-level
# default. Per-deployment cache files are the ROADMAP's "persist per-mesh
# caches per deployment" remainder: two meshes sharing one home directory
# (e.g. two pod slices launched from the same image) would otherwise
# overwrite each other's measured winners on key collisions.
_PATH_OVERRIDE: str | None = None


def set_cache_path(path: str | None) -> None:
    """Install (or with None, clear) the process-wide cache-path override
    and drop the cached handle so the next consult reloads from it."""
    global _PATH_OVERRIDE
    _PATH_OVERRIDE = path
    reset_cache()


def default_cache_path() -> str:
    if _PATH_OVERRIDE:
        return _PATH_OVERRIDE
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", "autotune.json")


class AutotuneCache:
    """Disk-backed ``key -> {algorithm, num_blocks, time_us}`` store.

    Writes are atomic (tmp file + rename) so concurrent benchmark processes
    cannot corrupt the cache; reads tolerate a missing or malformed file by
    starting empty.
    """

    SCHEMA = 1

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._loaded = False

    # -------------------------------------------------- persistence
    def load(self) -> "AutotuneCache":
        with self._lock:
            self._entries = {}
            try:
                with open(self.path) as f:
                    doc = json.load(f)
                if isinstance(doc, dict) and doc.get("schema") == self.SCHEMA:
                    self._entries = dict(doc.get("entries", {}))
            except (OSError, ValueError):
                pass
            self._loaded = True
        return self

    def save(self) -> None:
        with self._lock:
            doc = {"schema": self.SCHEMA, "entries": self._entries}
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".autotune.tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    # -------------------------------------------------- access
    def _ensure(self):
        if not self._loaded:
            self.load()

    def get(self, p: int, nbytes: int, dtype: str, topology: str,
            axis: str | None = None) -> TuneResult | None:
        self._ensure()
        # axis-tagged entries take precedence for their own axis; every
        # lookup may fall back to the legacy axis-less key (old cache files,
        # axis-agnostic tunings), but never to a DIFFERENT axis's entry.
        e = None
        if axis:
            e = self._entries.get(_key(p, nbytes, dtype, topology, axis))
        if not e:
            e = self._entries.get(_key(p, nbytes, dtype, topology))
        if not e:
            return None
        try:
            gs = e.get("group_size")
            if gs is not None:
                # JSON round-trips level tuples as lists; ints stay ints.
                gs = tuple(int(s) for s in gs) if isinstance(gs, (list, tuple)) \
                    else int(gs)
            ax = e.get("axis")
            res = TuneResult(str(e["algorithm"]), int(e["num_blocks"]),
                             float(e.get("time_s", 0.0)), gs,
                             bool(e.get("compressed", False)),
                             str(ax) if ax else None)
        except (KeyError, TypeError, ValueError):
            return None
        # semantic validation: corrupted entries are misses, not winners
        if res.algorithm not in _VALID_ALGORITHMS or res.num_blocks < 1 \
                or not (0.0 <= res.time_s < 1e18):
            return None
        return res

    def put(self, p: int, nbytes: int, dtype: str, topology: str,
            result: TuneResult) -> None:
        self._ensure()
        with self._lock:
            gs = result.group_size
            self._entries[_key(p, nbytes, dtype, topology, result.axis)] = {
                "algorithm": result.algorithm,
                "num_blocks": int(result.num_blocks),
                "time_s": float(result.time_s),
                "group_size": list(gs) if isinstance(gs, tuple) else gs,
                "compressed": bool(result.compressed),
                "axis": result.axis,
            }

    def __len__(self) -> int:
        self._ensure()
        return len(self._entries)


# Process-wide cache instance; tests swap it via reset_cache(path).
_CACHE: AutotuneCache | None = None
_CACHE_PATH: str | None = None


def get_cache() -> AutotuneCache:
    global _CACHE, _CACHE_PATH
    path = default_cache_path()
    if _CACHE is None or path != _CACHE_PATH:
        _CACHE, _CACHE_PATH = AutotuneCache(path), path
    return _CACHE


def reset_cache() -> None:
    """Drop the process-wide cache (e.g. after changing the env var path)."""
    global _CACHE, _CACHE_PATH
    _CACHE, _CACHE_PATH = None, None


COMPRESSED_SUFFIX = "+bf16"


def candidate_settings(p: int, nbytes: int, model: cm.CommModel,
                       algorithms: Sequence[str] = _ALGORITHMS,
                       group_size=None,
                       compress_inter_group: bool = False) -> list:
    """``(algorithm, num_blocks)`` candidates around the analytic optimum.

    ``group_size`` is the hierarchy spec 'hier' candidates tune with (int or
    level tuple). With ``compress_inter_group=True`` every 'hier' candidate
    is doubled with a ``'hier+bf16'`` twin — the bf16 slow-stage wire at its
    own (smaller-bytes) block optimum — so a consenting config's autotune
    pass times the lossy variant head-to-head against the exact ones.
    """
    out = []
    seen = set()

    def add(algo, b):
        b = max(1, int(b))
        if (algo, b) not in seen:
            seen.add((algo, b))
            out.append((algo, b))

    for algo in algorithms:
        if algo == "ring":
            add("ring", 1)
            continue
        b0 = cm.optimal_blocks(p, float(max(nbytes, 1)), model, algo,
                               group_size=group_size)
        for mult in _BLOCK_SWEEP:
            add(algo, round(b0 * mult))
        if algo == "hier" and compress_inter_group:
            bc = cm.optimal_blocks(p, float(max(nbytes, 1)), model, "hier",
                                   group_size=group_size, compression="bf16")
            for mult in _BLOCK_SWEEP:
                add(algo + COMPRESSED_SUFFIX, round(bc * mult))
    return out


def tune(runner: Callable[[str, int], float], p: int, nbytes: int,
         dtype: str, topology: str, model: cm.CommModel,
         algorithms: Sequence[str] = _ALGORITHMS,
         group_size=None,
         compress_inter_group: bool = False,
         cache: AutotuneCache | None = None,
         save: bool = True,
         axis: str | None = None) -> TuneResult:
    """Measure candidates with ``runner(algorithm, num_blocks) -> seconds``.

    ``algorithm`` as handed to ``runner`` may carry the ``'+bf16'`` suffix
    (compressed-hier candidates, opted in via ``compress_inter_group``); the
    recorded :class:`TuneResult` normalizes it into ``compressed=True``. The
    best measured setting is recorded in the cache (and persisted when
    ``save``). ``runner`` failures (e.g. an algorithm unavailable on this
    backend) are skipped, not fatal — unless every candidate fails.
    """
    # `is None`, not truthiness: an empty caller-supplied cache has len 0
    # and must still receive the result (not the process-wide cache).
    cache = get_cache() if cache is None else cache
    # Resolve the shape hier actually runs with BEFORE measuring, so the
    # recorded TuneResult names the exact configuration that was timed.
    hier_lv = as_levels(group_size)
    if hier_lv is None:
        hier_lv = as_levels(default_group_size(p))
    best: TuneResult | None = None
    errors = []
    for algo, b in candidate_settings(p, nbytes, model, algorithms,
                                      group_size, compress_inter_group):
        try:
            t = float(runner(algo, b))
        except Exception as e:  # candidate unavailable — keep tuning
            errors.append((algo, b, e))
            continue
        if best is None or t < best.time_s:
            base = algo.removesuffix(COMPRESSED_SUFFIX)
            best = TuneResult(base, b, t,
                              hier_lv if base == "hier" else None,
                              compressed=algo.endswith(COMPRESSED_SUFFIX),
                              axis=axis)
    if best is None:
        raise RuntimeError(f"autotune: every candidate failed: {errors}")
    cache.put(p, nbytes, dtype, topology, best)
    if save:
        cache.save()
    return best


def lookup(p: int, nbytes: int, dtype: str, topology: str,
           axis: str | None = None) -> TuneResult | None:
    """Cache probe used by the ``auto`` method. Never raises.

    ``axis`` scopes the probe to that mesh axis's tunings (falling back to
    legacy axis-less entries only) — see :class:`TuneResult`.
    """
    if os.environ.get("REPRO_TORCH_AUTOTUNE", "1") in ("0", "off", "false"):
        return None
    try:
        return get_cache().get(p, nbytes, dtype, topology, axis)
    except Exception:
        return None
