"""Time the WKV recurrence kernel ``wkv6`` against another tree's, in turns,
on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_wkv_ab.py OTHER_ROOT [--rounds 4] [--plans]

``OTHER_ROOT`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). Its
``csrc/wkv6.cu`` is built with the port's nvcc flags into ``build/wkv_ab/``,
and its own ``kernels/wkv.py`` is loaded as a module of its own bound to that
library, so both trees' kernels are called through their own wrappers
(checks, launch plan and arguments included). At phase 13's four shapes
(``chip_smoke.wkv_shapes``: 13b's decode tick, 13a's step, 13b's collecting
verify call and a 1,024-token chunk, RWKV-6 7B's 64 heads of 64, bf16) each
kernel is held against the plain version (``wkv.wkv_errors`` within
``WKV_TOL`` and ``WKV_STATE_TOL``), then both are timed in rounds, the order
rotated and reversed from round to round: CUDA events around 50 back-to-back
calls (median of three) for the verify call and the chunk, and the
profiler's device time a launch at every shape (back to back, a tick's
events read the host's launch cost, so the ticks take the profiler's
alone); then each wrapper's host cost a call (the host clock over calls
issued without a synchronize). ``--plans`` also times this tree's
kernel at each shape under every column group and a few tiles (``wkv.plan``
replaced), the sweep behind ``wkv.plan``'s choice. It prints the card's name
and power limit, a line per shape and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build, wkv  # noqa: E402

KERNELS = os.path.join("src", "repro_torch", "kernels")


def build_other(other: str):
    """The other tree's ``kernels/wkv.py`` as a module of its own (its
    imports of ``_build`` and ``ref`` are this tree's), bound to its
    ``csrc/wkv6.cu`` built here (the library is its ``_lib``)."""
    csrc = os.path.join(os.path.abspath(other), KERNELS, "csrc")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        if name == "wkv6.cu" or name.endswith(".cuh"):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    out = os.path.join(ROOT, "build", "wkv_ab",
                       f"libother-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", out, os.path.join(csrc, "wkv6.cu")],
                       check=True)
    spec = importlib.util.spec_from_file_location(
        "other_wkv", os.path.join(os.path.abspath(other), KERNELS, "wkv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(out)
    for name, (argtypes, restype) in mod._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        mod._FNS[name] = fn
    mod._lib = lib
    return mod


def in_turns(entries: dict, timer, rounds: int) -> dict:
    names = list(entries)
    got = {k: [] for k in names}
    for fn in entries.values():
        timer(fn)                         # one untimed pass each
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(timer(entries[k]))
    return got


def held(fn, args) -> tuple:
    got = fn()
    e_o, e_s = wkv.wkv_errors(got, *args)
    if not (e_o <= wkv.WKV_TOL[args[0].dtype] and
            e_s <= wkv.WKV_STATE_TOL):
        raise AssertionError(f"errors o {e_o:.3e}, state {e_s:.3e}")
    return e_o, e_s


def plan_sweep(args, B, T, H, K, timer) -> dict:
    """This tree's kernel at one shape under each column group and tile
    (held against the plain version first), in turns."""
    chosen = wkv.plan
    entries = {}
    for group in (16, 32, 64):
        for tile in sorted({min(T, t) for t in (8, 16, 32)}):
            fixed = chosen(B, T, H, K, 2, group=group, tile=tile)
            if fixed.smem > wkv.MAX_SMEM:
                continue

            def call(fixed=fixed):
                wkv.plan = lambda *a: fixed
                try:
                    return wkv.wkv6(*args)
                finally:
                    wkv.plan = chosen
            held(call, args)
            entries[f"group {group} tile {tile}"] = call
    times = in_turns(entries, timer, 2)
    return {k: float(np.median(t)) for k, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--plans", action="store_true",
                    help="also sweep this tree's launch plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    other = build_other(args.other)
    cfg = cs.rwkv_config()
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    gen = torch.Generator(device=dev).manual_seed(24)
    res = {}
    for what, (B, T, collect) in cs.wkv_shapes().items():
        call = cs.wkv_inputs(gen, B, T, H, K, collect, dev)
        kernels = {"this": lambda: wkv.wkv6(*call),
                   "other": lambda: other.wkv6(*call)}
        errs = {k_: held(fn, call) for k_, fn in kernels.items()}
        before = wkv.wkv6.launches
        timer = cs.device_ms if T == 1 else cs.time_ms
        times = in_turns(kernels, timer, args.rounds)
        med = {k_: float(np.median(t)) for k_, t in times.items()}
        # the profiler's device time a launch at every shape, in turns
        dev_times = (times if T == 1 else
                     in_turns(kernels, cs.device_ms, args.rounds))
        dev_med = {k_: float(np.median(t)) for k_, t in dev_times.items()}
        host = {k_: cs.host_ms(fn) for k_, fn in kernels.items()}
        if wkv.wkv6.launches == before:
            raise AssertionError("this tree's kernel was not launched")
        nbytes, nops = wkv.work(B, T, H, K, 2, collect)
        t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
        t_ops = nops / cs.F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        res[what] = {"shape": [B, T, H, K], "collect": collect,
                     "timer": "profiler" if T == 1 else "events",
                     "plan": wkv.plan(B, T, H, K, 2)._asdict(),
                     "ms": times, "median_ms": med,
                     "device_ms": dev_times, "device_median_ms": dev_med,
                     "host_ms": host,
                     "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "errors": errs}
        if args.plans:
            res[what]["plans_ms"] = plan_sweep(call, B, T, H, K, timer)
        print(f"{what} {[B, T, H, K]}{' collect' if collect else ''} "
              f"({res[what]['timer']}): this {med['this']:.4f} ms, other "
              f"{med['other']:.4f} ms ({med['other'] / med['this']:.2f}x); "
              f"device a launch this {dev_med['this']:.4f}, other "
              f"{dev_med['other']:.4f} ms; "
              f"bound {bound:.4f} ms ({res[what]['bound_by']}), this at "
              f"{bound / med['this']:.1%} of it; host "
              f"{host['this'] * 1e3:.2f} against {host['other'] * 1e3:.2f} "
              f"us a call" + (f"; plans {json.dumps(res[what]['plans_ms'])}"
                              if args.plans else ""), flush=True)
        del call
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.card_line(), "other": args.other,
                      "shapes": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
