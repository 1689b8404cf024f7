"""Serving driver: the fixed-batch greedy decode loop (the port of
``repro.launch.serve``'s default path, ``serve_loop``).

Every row decodes in lockstep from an empty cache, starting from token 0,
with greedy argmax, on one device (CUDA unless ``--device`` names another):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --device cpu

The config is the one the reference decodes with (``decode_config``):
bf16 parameters, and the int8 K/V cache where ``n_kv_heads * head_dim >=
2048`` (MiniCPM-2B at full width). Under bf16 compute, bf16 parameters give
the same numbers as the f32 ones the reference's ``serve_loop`` stores,
since every weight is cast to bf16 before use. The reference's continuous
engine and its other flags are later slices; each such flag is refused with
the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import decode_config, get_config, get_parallel
from repro_torch.core.transport import resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf

__all__ = ["ServeRun", "serve_loop", "main"]

_ENGINE = "ROADMAP.md queue 1, 'Next' item 2 (the continuous engine)"
_OBS = "ROADMAP.md queue 1, 'Next' item 6 (observability)"
_DIST = "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)"
# the reference's other flags -> the ROADMAP item that ports them
UNPORTED_FLAGS = {
    **{f: _ENGINE for f in (
        "--continuous", "--static", "--requests", "--slots", "--arrival-gap",
        "--prompt-len", "--prefill-chunk", "--temperature", "--top-k",
        "--top-p", "--sample-seed", "--speculate", "--draft-k",
        "--draft-model", "--policy", "--priority", "--deadline-ticks",
        "--prefix-cache", "--prefix-cache-nodes", "--shared-prefix",
        "--autotune-cache", "--chaos-seed", "--replicas",
        "--heartbeat-timeout", "--heartbeat-misses", "--rejoin-backoff")},
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Greedy fixed-batch decode with the PyTorch port.")
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported yet: {UNPORTED_FLAGS[flag]}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    if args.cache_len < 1:
        ap.error(f"--cache-len must be >= 1, got {args.cache_len}")
    if args.steps < 1:
        ap.error(f"--steps must be >= 1, got {args.steps}")
    return serve_loop(args)


if __name__ == "__main__":
    main()
