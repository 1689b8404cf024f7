"""Time the port's full-width MiniCPM-2B int8 decode from two source trees,
in turns, on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_decode_ab.py OTHER_ROOT [--steps 32]

``OTHER_ROOT`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). Each run
is a process of its own that imports ``repro_torch`` from one tree (building
that tree's kernels there), draws the seed-0 weights on the card, runs
``serve_loop`` as ``chip_smoke.py``'s phase 5 does (batch 16, a ring of
8192, greedy) and traces one more step with ``torch.profiler``; then it
reads the host cost of one ``quantize_int8`` call at the decode path's
shape, one token's (576, 64) bf16 rows (the host clock over 1000 calls
issued without a synchronize). The runs go other, this, this, other, so
that neither tree always runs first. It prints the card's name and power
limit, each run's median step, its traced step's device operations and
busy time and the host cost, and one JSON line; it fails if the trees'
tokens differ.
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
DECODE = dict(arch="minicpm_2b", batch=16, cache_len=8192, seed=0)


def child(root: str, steps: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.kernels import quantize
    from repro_torch.launch import serve, step_fns
    from repro_torch.models import transformer as tf

    cfg = decode_config(get_config(DECODE["arch"]))
    args = argparse.Namespace(**DECODE, steps=steps, reduced=False,
                              device="cuda")
    params = tf.init_params(cfg, args.seed, "cuda")
    run = serve.serve_loop(args, cfg, params)
    steady = float(np.median(run.step_seconds[1:]))
    step = step_fns.make_serve_step(cfg)
    caches = tf.init_cache(cfg, args.batch, args.cache_len, device="cuda")
    inputs = {"tokens": torch.zeros((args.batch, 1), dtype=torch.int64,
                                    device="cuda")}
    step(params, inputs, caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, inputs, caches)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    x = torch.randn((args.batch * cfg.n_kv_heads, cfg.hdim),
                    device="cuda").to(torch.bfloat16)
    quantize.quantize_int8(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        quantize.quantize_int8(x)
    host_ms = (time.perf_counter() - t0) / 1000 * 1e3
    torch.cuda.synchronize()
    return {"root": root, "median_step_ms": steady * 1e3,
            "step_ms": [t * 1e3 for t in run.step_seconds],
            "device_ops_per_step": sum(e.count for e in rows),
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in rows) / 1e3,
            "quantize_int8_host_ms": host_ms,
            "tokens_sha256": hashlib.sha256(
                np.ascontiguousarray(run.tokens).tobytes()).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.other, args.steps)))
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
                              root, "--steps", str(args.steps), "--child"],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        runs.append(res)
        print(f"  {side:5s} median step {res['median_step_ms']:.3f} ms, "
              f"traced step {res['device_ops_per_step']} device operations,"
              f" {res['device_busy_ms']:.3f} ms busy; quantize_int8 host "
              f"{res['quantize_int8_host_ms']:.4f} ms a call", flush=True)
    if len({r["tokens_sha256"] for r in runs}) != 1:
        print("the two trees decoded different tokens", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
