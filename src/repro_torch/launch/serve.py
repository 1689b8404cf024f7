"""Serving driver: the continuous-batching engine or the fixed-batch
greedy decode loop (the port of ``repro.launch.serve``), on one device
(CUDA unless ``--device`` names another).

Continuous batching: a staggered-arrival synthetic workload through the
slot scheduler, prefill chunks interleaved with in-flight decode, per-tick
stats summed with the b=1 reducer, greedy or seeded sampling:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --continuous --requests 6 --slots 3 --prompt-len 20 80 \\
      --prefill-chunk 16 --device cpu

The fixed-batch loop: every row decodes in lockstep from an empty cache,
starting from token 0, with greedy argmax:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --device cpu

The config is the one the reference decodes with (``decode_config``):
bf16 parameters, and the int8 K/V cache where ``n_kv_heads * head_dim >=
2048`` (MiniCPM-2B at full width). Under bf16 compute, bf16 parameters give
the same numbers as the f32 ones the reference stores, since every weight
is cast to bf16 before use. The reference's other flags (speculation,
prefixes, policies, the fleet, tracing, the mesh) are later slices; each
is refused with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import decode_config, get_config, get_parallel
from repro_torch.core import autotune
from repro_torch.core.transport import resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf

__all__ = ["ServeRun", "serve_loop", "synthetic_workload",
           "serve_continuous", "main"]

_SPEC = ("ROADMAP.md queue 1, 'Next' item 2b (speculation, prefixes, "
         "policies)")
_FLEET = "ROADMAP.md queue 1, 'Next' item 2c (the fleet)"
_OBS = "ROADMAP.md queue 1, 'Next' item 6 (observability)"
_DIST = "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)"
# the reference's other flags -> the ROADMAP item that ports them
UNPORTED_FLAGS = {
    **{f: _SPEC for f in (
        "--speculate", "--draft-k", "--draft-model", "--policy",
        "--priority", "--deadline-ticks", "--prefix-cache",
        "--prefix-cache-nodes", "--shared-prefix")},
    **{f: _FLEET for f in (
        "--chaos-seed", "--replicas", "--heartbeat-timeout",
        "--heartbeat-misses", "--rejoin-backoff")},
    **{f: _OBS for f in ("--trace-out", "--trace-format", "--metrics-every",
                         "--probe")},
    "--mesh": _DIST,
}


@dataclasses.dataclass
class ServeRun:
    """What :func:`serve_loop` decoded: ``tokens`` (B, steps), the wall
    time of each step (host clock, each step ending in the copy of its
    tokens to the host, as the reference's loop does), and, when asked for,
    every step's logits (steps, B, V) f32 on the device."""
    tokens: np.ndarray
    step_seconds: list
    logits: torch.Tensor | None = None

    @property
    def seconds(self) -> float:
        return float(sum(self.step_seconds))


def serve_loop(args, cfg: tf.ModelConfig | None = None, params=None, *,
               keep_logits: bool = False) -> ServeRun:
    """Greedy fixed-batch decode: ``args.batch`` rows, ``args.steps`` steps,
    a ring cache of ``args.cache_len``. ``cfg`` defaults to
    ``decode_config`` of ``args.arch``; ``params`` default to
    ``init_params(cfg, args.seed)``."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = decode_config(get_config(args.arch, reduced=args.reduced))
    step = step_fns.make_serve_step(cfg, get_parallel(args.arch))
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    caches = tf.init_cache(cfg, args.batch, args.cache_len, device=dev)
    inputs = {"tokens": torch.zeros((args.batch, 1), dtype=torch.int64,
                                    device=dev)}

    tokens_out, step_seconds, logits_out = [], [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        logits, caches = step(params, inputs, caches)
        nxt = torch.argmax(logits, dim=-1)
        tokens_out.append(nxt.cpu())
        step_seconds.append(time.perf_counter() - t0)
        if keep_logits:
            logits_out.append(logits)
        inputs = {"tokens": nxt[:, None]}
    run = ServeRun(torch.stack(tokens_out, 1).numpy(), step_seconds,
                   torch.stack(logits_out) if keep_logits else None)
    toks = args.batch * args.steps
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"decoded {toks} tokens in {run.seconds:.2f}s "
          f"({toks / run.seconds:.1f} tok/s on {where})")
    # argmax over (B, V) logits must yield in-vocabulary token ids
    if not ((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all():
        raise RuntimeError("decode produced out-of-vocabulary token ids")
    return run


def synthetic_workload(n: int, vocab: int, *, gap: int = 2, seed: int = 0,
                       prompt_lens=(3, 12), max_new=(4, 24),
                       sampling=None) -> list:
    """The reference's deterministic staggered-arrival request stream
    (without its speculation, SLO and shared-prefix options): ``n``
    requests, request ``i`` arriving at tick ``i * gap`` with a prompt of
    i.i.d. tokens in ``[1, vocab)`` of a length drawn from ``prompt_lens``
    and ``max_new_tokens`` from ``max_new`` (both inclusive), from numpy's
    generator seeded with ``seed``. ``sampling`` is a base
    :class:`~repro_torch.serving.sampling.SamplingParams` or None (greedy);
    request ``i`` gets seed ``sampling.seed + i``."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [
        Request(i,
                tuple(int(t) for t in rng.integers(
                    1, vocab, int(rng.integers(prompt_lens[0],
                                               prompt_lens[1] + 1)))),
                max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
                arrival=i * gap,
                sampling=(None if sampling is None else
                          dataclasses.replace(sampling,
                                              seed=sampling.seed + i)))
        for i in range(n)
    ]


def serve_continuous(args, cfg: tf.ModelConfig | None = None,
                     params=None) -> dict:
    """Drive the continuous-batching engine on a synthetic workload:
    ``args.requests`` requests into ``args.slots`` slots of a
    ``args.cache_len`` ring, the reference's workload from seed
    ``args.seed + 1``. ``cfg`` defaults to ``decode_config`` of
    ``args.arch``, ``params`` to ``init_params(cfg, args.seed)``. Prints
    the report line and returns the report."""
    from repro_torch.serving import (SamplingParams, ServingEngine,
                                     make_stats_reducer)
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = decode_config(get_config(args.arch, reduced=args.reduced))
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    engine = ServingEngine(cfg, get_parallel(args.arch), params,
                           n_slots=args.slots, max_len=args.cache_len,
                           prefill_chunk=args.prefill_chunk,
                           stats_reducer=make_stats_reducer(), device=dev)
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed)
    reqs = synthetic_workload(args.requests, cfg.vocab_size,
                              gap=args.arrival_gap, seed=args.seed + 1,
                              prompt_lens=tuple(args.prompt_len),
                              sampling=sampling)
    report = engine.run(reqs, static=args.static)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"[{report['mode']}/{report['policy']}] "
          f"{report['requests']} requests, "
          f"{report['total_tokens']} tokens "
          f"({report['sampled_tokens']} sampled, "
          f"{report['prefill_chunks']} prefill chunks) "
          f"in {report['wall_s']:.2f}s "
          f"({report['tok_s']:.1f} tok/s on {where}, {report['ticks']} "
          f"ticks, ttft p50 {report['ttft_ticks_p50']:.1f} ticks, "
          f"latency p95 {report['latency_ticks_p95']:.1f} ticks)")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Continuous-batching or fixed-batch decode with the "
                    "PyTorch port.")
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--continuous", action="store_true",
                    help="run the continuous-batching engine on a "
                         "staggered-arrival synthetic workload")
    ap.add_argument("--static", action="store_true",
                    help="run the engine's batch-synchronous reference "
                         "policy on the synthetic workload (the same steps; "
                         "implies --continuous)")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous mode: number of synthetic requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous mode: K/V-cache slots (concurrency)")
    ap.add_argument("--arrival-gap", type=int, default=2,
                    help="continuous mode: ticks between request arrivals")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(3, 12),
                    metavar=("MIN", "MAX"),
                    help="continuous mode: synthetic prompt length range "
                         "(prompts longer than --prefill-chunk stream in a "
                         "chunk a tick)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous mode: max prompt tokens per prefill "
                         "call (default: the largest single call the cache "
                         "geometry allows)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="continuous mode: sampling temperature (0 = greedy, "
                         "the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="continuous mode: top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="continuous mode: nucleus (top-p) filter (1 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="continuous mode: base sampler seed (request i uses "
                         "seed + i; streams reproduce run to run)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="per-deployment autotune cache file; overrides "
                         "REPRO_TORCH_AUTOTUNE_CACHE and the default (what "
                         "the b=1 stats reduction's method='auto' consults)")
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported yet: {UNPORTED_FLAGS[flag]}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    _validate_args(ap, args)
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    if args.continuous or args.static:
        return serve_continuous(args)
    return serve_loop(args)


def _validate_args(ap, args) -> None:
    """Reject bad flag values before any model work (the reference's checks
    of the flags this slice ports)."""
    for name in ("batch", "cache_len", "steps", "requests", "slots"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        ap.error(f"--prefill-chunk must be >= 1, got {args.prefill_chunk}")
    if args.arrival_gap < 0:
        ap.error(f"--arrival-gap must be >= 0, got {args.arrival_gap}")
    lo, hi = args.prompt_len
    if lo < 1 or hi < lo:
        ap.error(f"--prompt-len needs 1 <= MIN <= MAX, got {lo} {hi}")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    if args.top_k < 0:
        ap.error(f"--top-k must be >= 0, got {args.top_k}")
    if not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p must be in (0, 1], got {args.top_p}")


if __name__ == "__main__":
    main()
