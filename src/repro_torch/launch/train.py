"""Training driver (the port of ``repro.launch.train``), on one device.

Runs a registered architecture (reduced or full config) through the train
step of :mod:`repro_torch.launch.step_fns`, on the synthetic stream of
:mod:`repro_torch.data.pipeline` (the reference's batches bit for bit),
with AdamW on the arch's schedule (WSD for MiniCPM, cosine otherwise), on
the CUDA device unless ``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --steps 10 --seq-len 64 --global-batch 4 --device cpu

At ``--seq-len`` above 1024 attention takes the flash path (the hand-written
kernel on the card). With ``--ckpt-dir`` the loop writes the params and the
optimizer state every ``--ckpt-every`` steps and at the end, in the
reference's layout (:mod:`repro_torch.checkpoint.checkpointing`), and
resumes from the latest step on entry; ``--max-restarts`` runs it under
:func:`repro_torch.runtime.fault_tolerance.run_with_restarts`:

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --steps 10 --seq-len 64 --global-batch 4 --device cpu \\
      --ckpt-dir ckpt --ckpt-every 3 --max-restarts 1

The reference's data-parallel mesh and collective choice are a later slice:
``--mesh`` other than 1x1 and ``--collective`` are refused with the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint import checkpointing
from repro_torch.configs.base import get_arch, get_config, get_parallel
from repro_torch.core import autotune
from repro_torch.core.transport import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import adamw, cosine_schedule, wsd_schedule
from repro_torch.runtime.fault_tolerance import HostFailure, run_with_restarts

__all__ = ["UNPORTED_FLAGS", "TrainRun", "autotune_warmup",
           "build_optimizer", "train_loop", "main"]

_DIST = "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)"
# the reference's other flags -> the ROADMAP item that ports them
UNPORTED_FLAGS = {"--collective": _DIST}


@dataclasses.dataclass
class TrainRun:
    """What :func:`train_loop` did: ``history`` ``[(step, loss)]`` at the
    logged steps, every step's metrics ``[loss, ce, aux, grad_norm]`` (f32,
    on the host), each step's wall time (host clock, each step ending in
    the copy of its metrics to the host), and the trained ``params``; the
    step it resumed from (0 for a fresh start), and the restarts the
    supervisor made before this attempt."""
    history: list
    metrics: list
    step_seconds: list
    params: dict
    start: int = 0
    restarts: int = 0

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


def autotune_warmup(mesh: str = "1x1") -> list:
    """The reference's autotune warm-up (``repro.launch.train``'s
    ``autotune_warmup``): measure the collective candidates on each
    data-parallel axis of the mesh of more than one rank, before step 0.
    At ``--mesh 1x1``, the one mesh the port trains on, there is no such
    axis, so it measures nothing and returns ``[]``, as the reference does
    there. The measuring half comes with the data-parallel mesh: ROADMAP.md
    queue 1, 'Next' item 4."""
    shape = tuple(int(n) for n in mesh.split("x"))
    if any(n > 1 for n in shape[:-1]):
        raise NotImplementedError(f"autotune warm-up on mesh {mesh} is not "
                                  f"ported yet: {_DIST}")
    return []


def train_loop(args, params=None, cfg: tf.ModelConfig | None = None,
               fail_at: int | None = None) -> TrainRun:
    """One training attempt: steps up to ``args.steps`` from ``params``
    (default ``init_params(cfg, args.seed)``); ``cfg`` defaults to
    ``args.arch``'s (reduced with ``args.reduced``). The params are trained
    in place. With ``args.ckpt_dir`` it resumes from the latest checkpoint
    there, writes step ``i + 1`` after each step ``i > 0`` that
    ``args.ckpt_every`` divides and step ``args.steps`` at the end, each
    ``{"params", "opt"}`` with ``extra={"data_step": ...}``, as the
    reference does. ``fail_at`` raises :class:`HostFailure` after that step
    (tests), once the checkpoints already queued are written."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, reduced=args.reduced)
    optimizer = build_optimizer(get_arch(args.arch), args.lr, args.steps)
    step = step_fns.make_train_step(cfg, get_parallel(args.arch), optimizer,
                                    accum=args.accum)
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    if getattr(args, "autotune_warmup", False):
        autotune_warmup(getattr(args, "mesh", "1x1"))
    opt_state = optimizer.init(params)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=args.seq_len,
                                global_batch=args.global_batch,
                                seed=args.seed), dev)
    ckpt_dir = getattr(args, "ckpt_dir", None)
    start = 0
    if ckpt_dir and checkpointing.latest_step(ckpt_dir) is not None:
        state, _, start = checkpointing.restore(
            ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        del state
        print(f"resumed from step {start}", flush=True)
    mgr = checkpointing.CheckpointManager(ckpt_dir, keep=2) if ckpt_dir \
        else None
    hist, metrics, secs = [], [], []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            ts = time.perf_counter()
            batch = ds.batch_at(i)
            params, opt_state, vec = step(params, opt_state, batch)
            v = vec.cpu().tolist()
            secs.append(time.perf_counter() - ts)
            metrics.append(v)
            if fail_at is not None and i == fail_at:
                raise HostFailure(0, f"injected failure at step {i}")
            if i % args.log_every == 0 or i == args.steps - 1:
                hist.append((i, v[0]))
                print(f"step {i:5d} loss {v[0]:.4f} ce {v[1]:.4f} "
                      f"gnorm {v[3]:.3f} ({time.time() - t0:.1f}s)",
                      flush=True)
            if mgr and i and i % args.ckpt_every == 0:
                mgr.save_async(i + 1, {"params": params, "opt": opt_state},
                               extra={"data_step": i + 1})
        if mgr:
            mgr.save_async(args.steps, {"params": params, "opt": opt_state},
                           extra={"data_step": args.steps})
            mgr.wait()
    finally:
        if mgr:
            mgr.close()
    return TrainRun(hist, metrics, secs, params, start)


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--autotune-warmup", action="store_true",
                    help="before step 0, measure the collective candidates "
                         "on each data-parallel axis (none at --mesh 1x1)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="autotune cache file; overrides "
                         "REPRO_TORCH_AUTOTUNE_CACHE and the XDG default")
    ap.add_argument("--max-restarts", type=int, default=3)
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
    if args.max_restarts < 0:
        ap.error(f"--max-restarts must be >= 0, got {args.max_restarts}")
    for name in ("steps", "seq_len", "global_batch", "accum", "log_every",
                 "ckpt_every"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.global_batch % args.accum:
        ap.error(f"--global-batch {args.global_batch} does not split into "
                 f"--accum {args.accum} microbatches")
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    run = run_with_restarts(lambda attempt: train_loop(args),
                            max_restarts=args.max_restarts)
    print(f"done. final loss {run.final_loss:.4f} (restarts: "
          f"{run.restarts})")
    return run


if __name__ == "__main__":
    main()
