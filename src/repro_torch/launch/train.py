"""Training driver (the port of ``repro.launch.train``), on one device.

Runs a registered architecture (reduced or full config) through the train
step of :mod:`repro_torch.launch.step_fns`, on the synthetic stream of
:mod:`repro_torch.data.pipeline` (the reference's batches bit for bit),
with AdamW on the arch's schedule (WSD for MiniCPM, cosine otherwise), on
the CUDA device unless ``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --steps 10 --seq-len 64 --global-batch 4 --device cpu

At ``--seq-len`` above 1024 attention takes the flash path (the hand-written
kernel on the card). The reference's data-parallel mesh, collective choice,
checkpointing, autotune warm-up and restart supervisor are later slices:
each of those flags is refused with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.base import get_arch, get_config, get_parallel
from repro_torch.core.transport import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import adamw, cosine_schedule, wsd_schedule

__all__ = ["UNPORTED_FLAGS", "TrainRun", "build_optimizer", "train_loop",
           "main"]

_DIST = "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)"
_CKPT = "ROADMAP.md queue 1, 'Next' item 1 (training: checkpoint and resume)"
_FT = "ROADMAP.md queue 1, 'Next' item 1 (training: fault tolerance)"
_TUNE = "ROADMAP.md queue 1, 'Next' item 1 (training: autotune warm-up)"
# the reference's other flags -> the ROADMAP item that ports them
UNPORTED_FLAGS = {"--collective": _DIST, "--ckpt-dir": _CKPT,
                  "--ckpt-every": _CKPT, "--max-restarts": _FT,
                  "--autotune-warmup": _TUNE, "--autotune-cache": _TUNE}


@dataclasses.dataclass
class TrainRun:
    """What :func:`train_loop` did: ``history`` ``[(step, loss)]`` at the
    logged steps, every step's metrics ``[loss, ce, aux, grad_norm]`` (f32,
    on the host), each step's wall time (host clock, each step ending in
    the copy of its metrics to the host), and the trained ``params``."""
    history: list
    metrics: list
    step_seconds: list
    params: dict

    @property
    def final_loss(self) -> float | None:
        return self.history[-1][1] if self.history else None


def build_optimizer(arch_mod, lr: float, steps: int):
    sched_name = getattr(arch_mod, "TRAIN_SCHEDULE", "cosine")
    warmup = max(5, steps // 20)
    if sched_name == "wsd":
        sched = wsd_schedule(lr, warmup, int(steps * 0.7),
                             steps - warmup - int(steps * 0.7) or 1)
    else:
        sched = cosine_schedule(lr, warmup, steps)
    return adamw(sched)


def train_loop(args, params=None, cfg: tf.ModelConfig | None = None
               ) -> TrainRun:
    """``args.steps`` steps from ``params`` (default ``init_params(cfg,
    args.seed)``); ``cfg`` defaults to ``args.arch``'s (reduced with
    ``args.reduced``). The params are trained in place."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, reduced=args.reduced)
    optimizer = build_optimizer(get_arch(args.arch), args.lr, args.steps)
    step = step_fns.make_train_step(cfg, get_parallel(args.arch), optimizer,
                                    accum=args.accum)
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    opt_state = optimizer.init(params)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.seq_len,
                                global_batch=args.global_batch,
                                seed=args.seed), dev)
    hist, metrics, secs = [], [], []
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        batch = ds.batch_at(i)
        params, opt_state, vec = step(params, opt_state, batch)
        v = vec.cpu().tolist()
        secs.append(time.perf_counter() - ts)
        metrics.append(v)
        if i % args.log_every == 0 or i == args.steps - 1:
            hist.append((i, v[0]))
            print(f"step {i:5d} loss {v[0]:.4f} ce {v[1]:.4f} "
                  f"gnorm {v[3]:.3f} ({time.time() - t0:.1f}s)", flush=True)
    return TrainRun(hist, metrics, secs, params)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train on the synthetic stream with the PyTorch port.")
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="only 1x1: one device, no data parallelism")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported yet: {UNPORTED_FLAGS[flag]}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh} is not ported yet (one device only): "
                 f"{_DIST}")
    for name in ("steps", "seq_len", "global_batch", "accum", "log_every"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.global_batch % args.accum:
        ap.error(f"--global-batch {args.global_batch} does not split into "
                 f"--accum {args.accum} microbatches")
    run = train_loop(args)
    print(f"done. final loss {run.final_loss:.4f}")
    return run


if __name__ == "__main__":
    main()
