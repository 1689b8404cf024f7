"""Time candidate designs of the port's bf16 wire casts on the card, in turns.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_cast_variants.py [--rows 288] [--cols 1048576]
                                         [--rounds 4]

It builds ``tools/torch_cast_variants.cu`` (every candidate, described
there) with the port's nvcc flags into ``build/cast_variants/``, checks each
candidate bit for bit against PyTorch's cast on special values (infinities,
NaN payloads, subnormals, signed zeros, ties) and random bit patterns at
ragged lengths, then times every candidate, the port's wrappers
(``quantize.compress_bf16`` / ``decompress_bf16``) and PyTorch's
``.to(dtype)`` at the hier wire's shape, (288, 1,048,576) by default.
Each round times every entry once (CUDA events around 50 back-to-back
calls, median of three), the order rotated and reversed from round to
round, so that no entry always runs first. It prints the card's name and
power limit and one JSON line: for each entry its times over the rounds,
their median and its share of the bytes bound.
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

from repro_torch.kernels import _build, quantize  # noqa: E402

SRC = os.path.join(ROOT, "tools", "torch_cast_variants.cu")
COMPRESS = ("stride1", "grid1", "grid1cs", "grid2", "grid2cs", "grid2nc",
            "grid2pf", "grid4cs", "wide16")
DECOMPRESS = ("stride1", "grid2cs", "grid4cs", "wide16")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
LENGTHS = (1, 3, 7, 8, 4097, (1 << 20) + 5)


def build() -> ctypes.CDLL:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()
                             + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(ROOT, "build", "cast_variants", f"lib-{tag[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, SRC],
                       check=True)
    lib = ctypes.CDLL(out)
    for name in [f"c_{v}" for v in COMPRESS] + [f"d_{v}" for v in DECOMPRESS]:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def call(lib, name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    rc = getattr(lib, name)(x.data_ptr(), y.data_ptr(), x.numel(),
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def special_words(rng, n: int) -> np.ndarray:
    special = np.array([0x7f800000, 0xff800000, 0x7fc00000, 0xffc00000,
                        0x7f800001, 0xff812345, 0x00000001, 0x80000001,
                        0x007fffff, 0x00008000, 0x00018000, 0x3f808000,
                        0x3f818000, 0x3f808001, 0x00000000, 0x80000000,
                        0x7f7fffff], np.uint32)
    rnd = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([special, rnd])[:n]


def check(lib, dev) -> int:
    """Every candidate against ``.to()``, bitwise; returns the checks."""
    rng = np.random.default_rng(0)
    checks = 0
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(dev)
    for n in LENGTHS:
        x = torch.from_numpy(special_words(rng, n).view(np.float32)).to(dev)
        want = x.to(torch.bfloat16)
        for v in COMPRESS:
            y = torch.full((n,), 7, dtype=torch.int16, device=dev)
            call(lib, f"c_{v}", x, y)
            if not torch.equal(y, want.view(torch.int16)):
                raise AssertionError(f"c_{v} n={n}: differs from .to()")
            checks += 1
        for src in (want, every):
            back = src.to(torch.float32)
            for v in DECOMPRESS:
                y = torch.full(src.shape, 7, dtype=torch.int32, device=dev)
                call(lib, f"d_{v}", src, y)
                if not torch.equal(y, back.view(torch.int32)):
                    raise AssertionError(f"d_{v} n={src.numel()}: differs")
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
    got = {k: [] for k in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(time_ms(entries[k]))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=288)
    ap.add_argument("--cols", type=int, default=1 << 20)
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
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((args.rows, args.cols), generator=gen, device=dev)
    wh = w.to(torch.bfloat16)
    yh = torch.empty_like(wh)
    yf = torch.empty_like(w)
    bound = 6 * w.numel() / HBM_BYTES_PER_S * 1e3
    out = {"card": card, "shape": [args.rows, args.cols], "bound_ms": bound}
    for what, src, dst, lib_call, wrapper, variants, prefix in (
            ("compress", w, yh, lambda: w.to(torch.bfloat16),
             lambda: quantize.compress_bf16(w), COMPRESS, "c_"),
            ("decompress", wh, yf, lambda: wh.to(torch.float32),
             lambda: quantize.decompress_bf16(wh), DECOMPRESS, "d_")):
        entries = {v: (lambda v=v: call(lib, prefix + v, src, dst))
                   for v in variants}
        entries["wrapper"] = wrapper
        entries["library"] = lib_call
        got = in_turns(entries, args.rounds)
        res = {k: {"ms": t, "median_ms": float(np.median(t)),
                   "bound_share": bound / float(np.median(t))}
               for k, t in got.items()}
        out[what] = res
        for k, r in sorted(res.items(), key=lambda kv: kv[1]["median_ms"]):
            print(f"  {what:10s} {k:8s} median {r['median_ms']:.4f} ms "
                  f"({100 * r['bound_share']:.1f} % of the bound), rounds "
                  + " ".join(f"{t:.4f}" for t in r["ms"]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
