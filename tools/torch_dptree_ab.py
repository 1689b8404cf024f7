"""Hold the collective's main path of this tree against another tree on one
card, in turns.

Runs ``dptree`` f32 ``all_reduce`` at the paper's scale (p = 288 ranks
stacked on the card, m = 8,388,608 elements each, the engine's own block
count) from another checkout (``OTHER``, e.g. the parent commit unpacked by
``git archive``) and from this one, each in a process of its own, in the
order other, this, this, other:

  python3 tools/torch_dptree_ab.py build/parent

Each process builds its tree's kernels, draws the same input from one seed
on the card, runs the call once untimed, then ``--runs`` times (host clock
around a call that ends in ``torch.cuda.synchronize()``), then once under
``torch.profiler``: device busy time (the sum of the kernels' self device
time; one stream, so nothing overlaps) and the idle share of the traced
wall. It prints the card's name and power limit, a line per process, and
one JSON line; it fails if the trees' outputs differ (their SHA-256).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, M = 288, 8_388_608


def child(root: str, runs: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    os.environ["REPRO_TORCH_AUTOTUNE"] = "0"
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import CollectiveConfig, LocalTransport, all_reduce
    from repro_torch.kernels import block_combine

    comm = LocalTransport(P, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    X = torch.randn((P, M), generator=gen, device="cuda")
    cfg = CollectiveConfig(method="dptree")
    out = all_reduce(X, comm, cfg)           # builds the kernels, warms up
    torch.cuda.synchronize()
    digest = hashlib.sha256(out[0].cpu().numpy().tobytes()).hexdigest()
    del out
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce(X, comm, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    block_combine.combine3.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        all_reduce(X, comm, cfg)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    median = float(np.median(walls))
    return {"root": root, "wall_s": walls, "median_wall_s": median,
            "traced_wall_ms": traced * 1e3, "device_busy_ms": busy_ms,
            "idle_share_traced": max(0.0, 1 - busy_ms / (traced * 1e3)),
            "idle_share_untraced": max(0.0, 1 - busy_ms / (median * 1e3)),
            "device_ops": sum(e.count for e in rows),
            "combine3_launches": block_combine.combine3.launches,
            "out_sha256": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.other, args.runs)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    other = os.path.abspath(args.other)
    for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              root, "--runs", str(args.runs), "--child"],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        runs.append(res)
        print(f"  {side:5s} wall {[round(w, 4) for w in res['wall_s']]} s, "
              f"median {res['median_wall_s']:.4f} s; traced "
              f"{res['traced_wall_ms']:.1f} ms, device busy "
              f"{res['device_busy_ms']:.1f} ms ({res['device_ops']} "
              f"operations, {res['combine3_launches']} combine3), idle "
              f"{100 * res['idle_share_traced']:.1f} % traced, "
              f"{100 * res['idle_share_untraced']:.1f} % of the median "
              f"wall", flush=True)
    if len({r["out_sha256"] for r in runs}) != 1:
        print("the two trees reduced to different outputs", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
