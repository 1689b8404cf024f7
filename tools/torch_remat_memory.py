"""Peak device memory and step time of full-width MiniCPM-2B training under
each remat policy and batch, on one card.

Each (policy, batch) runs in a process of its own, so that one that runs
out of memory leaves the next a clean card: the port's ``train_loop`` at
seq 4096 from the seeded weights, ``--steps`` steps, with
``remat_policy`` set to ``full`` or ``dots``:

  python3 tools/torch_remat_memory.py --batches 2 4 --steps 3

It prints the card's name and power limit, a line per run (peak memory
from ``torch.cuda.max_memory_allocated``, the card's memory, every step's
seconds and loss, or that the run ran out of memory), and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(policy: str, batch: int, steps: int) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("minicpm_2b"), remat_policy=policy)
    args = argparse.Namespace(arch="minicpm_2b", reduced=False, seq_len=4096,
                              global_batch=batch, accum=1, steps=steps,
                              lr=1e-4, seed=0, log_every=1, device="cuda")
    res = {"policy": policy, "batch": batch,
           "card_bytes": torch.cuda.get_device_properties(0).total_memory}
    torch.cuda.reset_peak_memory_stats()
    try:
        run = train.train_loop(args, cfg=cfg)
    except torch.OutOfMemoryError as e:
        res.update(oom=True, peak_bytes=torch.cuda.max_memory_allocated(),
                   error=str(e).splitlines()[0][:200])
        return res
    res.update(oom=False, peak_bytes=torch.cuda.max_memory_allocated(),
               step_seconds=run.step_seconds,
               losses=[m[0] for m in run.metrics])
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--policies", nargs="+", default=["full", "dots"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child[0], int(args.child[1]),
                               args.steps)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    for batch in args.batches:
        for policy in args.policies:
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--steps", str(args.steps), "--child",
                                  policy, str(batch)],
                                 capture_output=True, text=True, cwd=ROOT)
            if out.returncode != 0:
                print(out.stdout[-4000:], out.stderr[-4000:],
                      file=sys.stderr)
                return out.returncode
            res = json.loads(out.stdout.strip().splitlines()[-1])
            runs.append(res)
            what = ("out of memory" if res["oom"] else
                    f"steps {[round(t, 4) for t in res['step_seconds']]} s, "
                    f"losses {res['losses']}")
            print(f"  {policy:4s} batch {batch}: peak "
                  f"{res['peak_bytes'] / 1e9:.2f} GB of "
                  f"{res['card_bytes'] / 1e9:.2f} GB; {what}", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
