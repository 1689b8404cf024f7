"""Time candidate designs of the port's combine2 on the card, in turns.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_combine_variants.py [--rows 288] [--cols 30505]
                                            [--rounds 4]

It builds ``tools/torch_combine_variants.cu`` (every candidate, described
there) with the port's nvcc flags into ``build/combine_variants/``, checks
each candidate bit for bit against ``torch.add`` (random values with
infinities, at ragged lengths), then times every candidate, the port's
wrapper ``block_combine.combine2`` and ``torch.add`` at the collective's
slab, (288, 30505) f32 by default: CUDA events around 50 back-to-back
calls (median of three), each round in a rotated and reversed order, after
one untimed pass of each. It prints the card's name and power limit and
one JSON line: for each entry its times over the rounds, their median and
spread, and its share of the bytes bound.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, block_combine  # noqa: E402

SRC = os.path.join(ROOT, "tools", "torch_combine_variants.cu")
VARIANTS = ("stride", "grid1", "grid1cs", "grid2cs")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
LENGTHS = (1, 3, 7, 8, 4097, (1 << 20) + 5)


def build() -> ctypes.CDLL:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()
                             + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(ROOT, "build", "combine_variants", f"lib-{tag[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, SRC],
                       check=True)
    lib = ctypes.CDLL(out)
    for v in VARIANTS:
        fn = getattr(lib, f"a_{v}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def call(lib, v: str, a, b, out) -> None:
    rc = getattr(lib, f"a_{v}")(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               a.numel(),
                               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"a_{v}: CUDA error {rc}")


def check(lib, dev) -> int:
    """Every candidate against ``torch.add``, bitwise; returns the checks."""
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = 0
    for n in LENGTHS:
        a, b = (torch.randn(n, generator=gen, device=dev) for _ in range(2))
        a[torch.rand(n, generator=gen, device=dev) < 0.02] = float("inf")
        want = torch.add(a, b)
        for v in VARIANTS:
            out = torch.full((n,), 7.0, device=dev)
            call(lib, v, a, b, out)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"a_{v} n={n}: differs from torch.add")
            checks += 1
    torch.cuda.synchronize()
    return checks


def time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    runs = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return float(np.median(runs))


def in_turns(entries: dict, rounds: int) -> dict:
    names = list(entries)
    for k in names:                     # one untimed pass of each
        time_ms(entries[k])
    got = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(time_ms(entries[k]))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=288)
    ap.add_argument("--cols", type=int, default=30505)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = build()
    print(f"bitwise checks passed: {check(lib, dev)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    a, b = (torch.randn((args.rows, args.cols), generator=gen, device=dev)
            for _ in range(2))
    out = torch.empty_like(a)
    bound = 12 * a.numel() / HBM_BYTES_PER_S * 1e3
    entries = {v: (lambda v=v: call(lib, v, a, b, out)) for v in VARIANTS}
    entries["wrapper"] = lambda: block_combine.combine2(a, b)
    entries["torch.add"] = lambda: torch.add(a, b)
    res = {"card": card, "shape": [args.rows, args.cols], "bound_ms": bound}
    for k, t in in_turns(entries, args.rounds).items():
        med = float(np.median(t))
        res[k] = {"ms": t, "median_ms": med, "spread": (max(t) - min(t)) / med,
                  "bound_share": bound / med}
    for k, r in sorted(((k, v) for k, v in res.items()
                        if isinstance(v, dict)),
                       key=lambda kv: kv[1]["median_ms"]):
        print(f"  {k:9s} median {r['median_ms']:.5f} ms (spread "
              f"{100 * r['spread']:.1f} %, {100 * r['bound_share']:.1f} % of "
              f"the bound), rounds " + " ".join(f"{t:.5f}" for t in r["ms"]),
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
