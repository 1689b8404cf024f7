"""Time the slot attention kernel ``ring_attention`` against another tree's
and against SDPA with a mask, in turns, on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_ring_ab.py OTHER_ROOT [--rounds 4]

``OTHER_ROOT`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). Its
``csrc/ring_attention.cu`` is built with the port's nvcc flags into
``build/ring_ab/``, and its own ``kernels/ring_attention.py`` is loaded as a
module of its own bound to that library, so both trees' kernels are called
through their own wrappers (checks, route and arguments included). This
tree's kernel is also called with the ``cp.async`` copy route forced where it
routes a call to TMA (the same wrapper, its ``route`` replaced), so the two
copy routes are timed against each other on the same inputs. At each of the
main path's shapes (``chip_smoke.ring_shapes``: phase 10's verify and decode
ticks and 512-token chunk, phase 5's step, phase 9's tick and 1024-token
chunk, at MiniCPM-2B's 36 heads of 64, bf16) every kernel entry is held
against the plain version (within ``FLASH_TOL`` of each element's size plus
its row's largest), then the entries and SDPA are timed in rounds (CUDA
events around 50 back-to-back calls, median of three), the order rotated and
reversed from round to round; then each kernel entry's device time a launch
(``torch.profiler``) and its wrapper's host cost a call (the host clock over
calls issued without a synchronize). It prints the card's name and power
limit, a line per shape and one JSON line: each entry's times, their median,
the device and host times, and the bound (``ring_attention.work``).
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

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build, ref, ring_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

KERNELS = os.path.join("src", "repro_torch", "kernels")


def wrapper(root: str, name: str):
    """``root``'s ``kernels/ring_attention.py`` as a module of its own,
    named ``name`` (its imports of ``_build`` and ``ref`` are this
    tree's)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.abspath(root), KERNELS,
                           "ring_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_other(other: str):
    """The other tree's wrapper, bound to its kernel built here."""
    csrc = os.path.join(os.path.abspath(other), KERNELS, "csrc")
    src = os.path.join(csrc, "ring_attention.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc)):
        if name == "ring_attention.cu" or name.endswith(".cuh"):
            with open(os.path.join(csrc, name), "rb") as f:
                h.update(f.read())
    out = os.path.join(ROOT, "build", "ring_ab",
                       f"libother-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    mod = wrapper(other, "other_ring_attention")
    for name, (argtypes, restype) in mod._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        mod._FNS[name] = fn
    return mod


def cp_async_wrapper():
    """This tree's wrapper and library with every tensor-core call routed
    to ``cp.async`` copies."""
    mod = wrapper(ROOT, "cp_async_ring_attention")
    mod._FNS = ring_attention._FNS

    def route(dtype, head_dim, ring):
        got = ring_attention.route(dtype, head_dim, ring)
        return "wgmma_cp_async" if got == "wgmma_tma" else got

    mod.route = route
    return mod


def in_turns(entries: dict, rounds: int) -> dict:
    names = list(entries)
    got = {k: [] for k in names}
    for fn in entries.values():
        cs.time_ms(fn)                    # one untimed pass each
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order if r % 2 == 0 else order[::-1]):
            got[k].append(cs.time_ms(entries[k]))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    other, cp_async = build_other(args.other), cp_async_wrapper()
    cfg = get_config(cs.SERVE["arch"])
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    gen = torch.Generator(device=dev).manual_seed(23)
    tol = fa.FLASH_TOL[torch.bfloat16]
    res = {}
    for what, (B, T, S, pos) in cs.ring_shapes().items():
        q, k, v = cs.ring_cases(gen, B, T, H, KV, D, S, torch.bfloat16, dev)
        plan = torch.tensor([pos, [T] * B], device=dev)
        keep = ring_attention.valid(plan, T, S)
        want = ref.ring_attention_ref(q, k, v, plan)
        kernels = {
            "this": lambda: ring_attention.ring_attention(q, k, v, plan),
            "cp_async": lambda: cp_async.ring_attention(q, k, v, plan),
            "other": lambda: other.ring_attention(q, k, v, plan)}
        errs = {k_: cs.ring_err(fn(), want, keep)
                for k_, fn in kernels.items()}
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{what}: errors {errs} above {tol}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qp = plan[0][:, None] + torch.arange(T, device=dev)[None]
        mask = (torch.arange(S, device=dev)[None, None]
                <= qp[..., None])[:, None]          # (B, 1, T, S); no wrap
        entries = dict(kernels, sdpa=lambda: torch.nn.functional
                       .scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask))
        times = in_turns(entries, args.rounds)
        bound, by, nbytes, nops = cs.ring_bound(plan, T, S, H, KV, D,
                                                torch.bfloat16)
        med = {k_: float(np.median(t)) for k_, t in times.items()}
        # each kernel's device time a launch (the profiler) and its
        # wrapper's host cost a call
        device = {k_: cs.device_ms(fn) for k_, fn in kernels.items()}
        host = {k_: cs.host_ms(fn) for k_, fn in kernels.items()}
        res[what] = {"shape": [list(q.shape), list(k.shape)], "pos": pos,
                     "route": ring_attention.route(q.dtype, D, S),
                     "cp_async_route": cp_async.route(q.dtype, D, S),
                     "ms": times, "median_ms": med, "device_ms": device,
                     "host_ms": host, "bound_ms": bound, "bound_by": by,
                     "bytes": nbytes, "ops": nops, "err_share": errs}
        print(f"{what} {res[what]['shape']}: " + ", ".join(
                  f"{k_} {med[k_]:.4f} ms (device {device[k_]:.4f}, host "
                  f"{host[k_]:.4f})" for k_ in kernels) +
              f", SDPA {med['sdpa']:.4f} ms, bound {bound:.4f} ms ({by}); "
              f"this at {bound / med['this']:.1%} of its bound", flush=True)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.card_line(), "other": args.other,
                      "shapes": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
