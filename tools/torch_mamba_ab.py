"""Time the selective-scan kernel ``mamba_scan`` against another tree's, in
turns, on one card, and hold their outputs bitwise equal.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_mamba_ab.py OTHER_ROOT [--rounds 4] [--plans]

``OTHER_ROOT`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). Its
``csrc/mamba_scan.cu`` is built with the port's nvcc flags into
``build/mamba_ab/``, and its own ``kernels/mamba_scan.py`` is loaded as a
module of its own bound to that library, so both trees' kernels are called
through their own wrappers (checks, launch plan and arguments included). At
phase 14's four shapes (``chip_smoke.scan_shapes``: 14b's decode tick, 14a's
step, 14b's collecting verify call and a 1,024-token chunk, Jamba's 8192
channels of 16 states) each kernel is held against the plain version
(``mamba_scan.scan_errors`` within ``SCAN_TOL`` and ``SCAN_STATE_TOL``), and
the two trees' y and state are held bitwise equal, on the shape's inputs and
again with a fifth of the tokens invalid. Then both are timed in rounds, the
order rotated and reversed from round to round: CUDA events around 50
back-to-back calls (median of three) for the verify call and the chunk, and
the profiler's device time a launch at every shape (back to back, a tick's
events read the host's launch cost, so the ticks take the profiler's
alone); then each wrapper's host cost a call (the host clock over calls
issued without a synchronize). ``--plans`` also times this tree's kernel at
each shape on the direct path and under every channel group and a few tiles
of the staged path (``mamba_scan.plan`` replaced; each plan's outputs held
bitwise the chosen plan's), and the two paths against each other at B 1 and
8 and T 2 to 64, all by the profiler's device time a launch: the sweeps
behind ``mamba_scan.plan``'s choices. It prints
the card's name and power limit, a line per shape and one JSON line.
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

from repro_torch.kernels import _build, mamba_scan  # noqa: E402

KERNELS = os.path.join("src", "repro_torch", "kernels")


def build_other(other: str):
    """The other tree's ``kernels/mamba_scan.py`` as a module of its own
    (its imports of ``_build`` and ``ref`` are this tree's), bound to its
    ``csrc/mamba_scan.cu`` built here (the library is its ``_lib``)."""
    csrc = os.path.join(os.path.abspath(other), KERNELS, "csrc")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        if name == "mamba_scan.cu" or name.endswith(".cuh"):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    out = os.path.join(ROOT, "build", "mamba_ab",
                       f"libother-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", out, os.path.join(csrc, "mamba_scan.cu")],
                       check=True)
    spec = importlib.util.spec_from_file_location(
        "other_mamba_scan",
        os.path.join(os.path.abspath(other), KERNELS, "mamba_scan.py"))
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
    e_y, e_s = mamba_scan.scan_errors(got, *args)
    if not (e_y <= mamba_scan.SCAN_TOL and
            e_s <= mamba_scan.SCAN_STATE_TOL):
        raise AssertionError(f"errors y {e_y:.3e}, state {e_s:.3e}")
    return got, (e_y, e_s)


def bitwise(a: tuple, b: tuple, what: str) -> None:
    for x, z, name in zip(a, b, ("y", "state")):
        if x.shape != z.shape or not torch.equal(x.view(torch.int32),
                                                 z.view(torch.int32)):
            raise AssertionError(f"{what}: the two kernels' {name} differ")


def forced(args, fixed):
    """A call of this tree's kernel under the plan ``fixed``."""
    def call():
        chosen = mamba_scan.plan
        mamba_scan.plan = lambda *a, **kw: fixed
        try:
            return mamba_scan.mamba_scan(*args)
        finally:
            mamba_scan.plan = chosen
    return call


def plan_sweep(args, B, T, Di, N) -> dict:
    """This tree's kernel at one shape on the direct path and under each
    channel group and tile of the staged path, each held bitwise the
    chosen plan's output: the profiler's device time a launch, in
    turns."""
    want = mamba_scan.mamba_scan(*args)
    plans = {"direct": mamba_scan.plan(B, T, Di, N, staged=False)}
    for channels in mamba_scan.CHANNELS:
        for tile in sorted({min(T, t) for t in (8, 16, 32, 64)}):
            plans[f"channels {channels} tile {tile}"] = mamba_scan.plan(
                B, T, Di, N, tile=tile, channels=channels, staged=True)
    entries = {}
    for name, fixed in plans.items():
        entries[name] = forced(args, fixed)
        bitwise(entries[name](), want, f"plan {fixed}")
    times = in_turns(entries, cs.device_ms, 2)
    return {k: float(np.median(t)) for k, t in times.items()}


def crossover(dev, gen, Di, N) -> dict:
    """The direct path against the staged one (each under ``plan``'s
    other choices) at B 1 and 8 and T from 2 to 64 tokens: the profiler's
    device time a launch, in turns, each pair held bitwise equal; the
    evidence behind ``mamba_scan.DIRECT_TOKENS``."""
    out = {}
    for B in (1, 8):
        for T in (2, 4, 8, 16, 32, 64):
            args = cs.scan_inputs(gen, B, T, Di, N, False, dev)
            entries = {
                k: forced(args, mamba_scan.plan(B, T, Di, N, staged=st))
                for k, st in (("direct", False), ("staged", True))}
            bitwise(entries["direct"](), entries["staged"](),
                    f"direct against staged at {B} x {T}")
            times = in_turns(entries, cs.device_ms, 2)
            out[f"{B}x{T}"] = {k: float(np.median(t))
                               for k, t in times.items()}
    return out


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
    m = cs.jamba_config().mamba_cfg()
    Di, N = m.d_inner, m.d_state
    gen = torch.Generator(device=dev).manual_seed(26)
    res = {}
    for what, (B, T, collect) in cs.scan_shapes().items():
        call = cs.scan_inputs(gen, B, T, Di, N, collect, dev)
        kernels = {"this": lambda: mamba_scan.mamba_scan(*call),
                   "other": lambda: other.mamba_scan(*call)}
        outs, errs = {}, {}
        for k_, fn in kernels.items():
            outs[k_], errs[k_] = held(fn, call)
        bitwise(outs["this"], outs["other"], what)
        # again with a fifth of the tokens invalid
        masked = list(call)
        masked[6] = torch.rand((B, T), generator=gen, device=dev) < 0.8
        bitwise(held(lambda: mamba_scan.mamba_scan(*masked), masked)[0],
                held(lambda: other.mamba_scan(*masked), masked)[0],
                f"{what} masked")
        del outs, masked
        before = mamba_scan.mamba_scan.launches
        timer = cs.device_ms if T == 1 else cs.time_ms
        times = in_turns(kernels, timer, args.rounds)
        med = {k_: float(np.median(t)) for k_, t in times.items()}
        # the profiler's device time a launch at every shape, in turns
        dev_times = (times if T == 1 else
                     in_turns(kernels, cs.device_ms, args.rounds))
        dev_med = {k_: float(np.median(t)) for k_, t in dev_times.items()}
        host = {k_: cs.host_ms(fn) for k_, fn in kernels.items()}
        if mamba_scan.mamba_scan.launches == before:
            raise AssertionError("this tree's kernel was not launched")
        nbytes, nops = mamba_scan.work(B, T, Di, N, collect)
        t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
        t_ops = nops / cs.F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        res[what] = {"shape": [B, T, Di, N], "collect": collect,
                     "timer": "profiler" if T == 1 else "events",
                     "plan": mamba_scan.plan(B, T, Di, N)._asdict(),
                     "ms": times, "median_ms": med,
                     "device_ms": dev_times, "device_median_ms": dev_med,
                     "host_ms": host, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "errors": errs,
                     "bitwise": True}
        if args.plans:
            res[what]["plans_ms"] = plan_sweep(call, B, T, Di, N)
        print(f"{what} {[B, T, Di, N]}{' collect' if collect else ''} "
              f"({res[what]['timer']}): this {med['this']:.4f} ms, other "
              f"{med['other']:.4f} ms ({med['other'] / med['this']:.2f}x); "
              f"device a launch this {dev_med['this']:.4f}, other "
              f"{dev_med['other']:.4f} ms; "
              f"bound {bound:.4f} ms ({res[what]['bound_by']}), this at "
              f"{bound / dev_med['this']:.1%} of it; host "
              f"{host['this'] * 1e3:.2f} against {host['other'] * 1e3:.2f} "
              f"us a call; y and state bitwise equal (masked too); plan "
              f"{json.dumps(res[what]['plan'])}"
              + (f"; plans {json.dumps(res[what]['plans_ms'])}"
                 if args.plans else ""), flush=True)
        del call
        torch.cuda.empty_cache()
    cross = crossover(dev, gen, Di, N) if args.plans else None
    if cross:
        print(f"direct against staged, device ms a launch: "
              f"{json.dumps(cross)}", flush=True)
    print(json.dumps({"card": cs.card_line(), "other": args.other,
                      "shapes": res, "crossover": cross}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
