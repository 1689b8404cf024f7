"""Probe what holds ``wkv6`` at a prefill chunk, on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 tools/torch_wkv_probe.py

Each variant is this tree's ``csrc/wkv6.cu`` with one text patch, built
into a tree of its own under ``build/wkv_probe/`` and called through this
tree's wrapper (``tools/torch_wkv_ab.py``'s ``build_other``). ``stamps``
records ``clock64`` at block 0's first owner and first helper around each
tile's barriers and phases; the others change the work and are timed, not
checked (their outputs are wrong): ``no_sums`` skips the helpers' sums of
o after tile 1, ``no_prepare`` their exp and bonus after tile 1,
``no_register_cap`` lifts the two-blocks-an-SM register cap. At phase 13's
chunk (one row of 1,024 tokens, 64 heads of 64, bf16) it prints the
stamps' cycles a tile (median over the tiles) and each variant's device
time a launch in turns with the unpatched kernel, with the card's name and
power limit, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_wkv_ab as ab  # noqa: E402

KERNELS = os.path.join("src", "repro_torch", "kernels")
STAMP = """
__device__ long long g_stamps[64 * 8];
__device__ __forceinline__ void stamp(int i, int slot) {
  if (blockIdx.x == 0 && i < 64 &&
      (threadIdx.x == 0 || threadIdx.x == owners_for(64, 32)))
    g_stamps[i * 8 + slot] = clock64();
}
"""
# slots: helpers 0 tile's copies in, 1 prepared, 2 its partials done,
# 3 summed; owners 4 before the ready barrier, 5 after, 6 tile done
HELPERS_IN = ("        bar_sync(kBarHelpers, NH);"
              "      // every helper's copies are in")
READY = "    bar_sync(kBarReady + (i & 1), all);"
DONE = "    bar_arrive(kBarDone + (i & 1), all);"
ERR = 'extern "C" const char* wkv6_error_string'
READ = ('extern "C" int wkv6_stamps(void* host) {\n'
        '  return (int)cudaMemcpyFromSymbol(host, g_stamps,\n'
        '                                   sizeof(g_stamps));\n}\n\n')
ITEMS = "        const int items = (n * NQ + 31) & ~31;"
PATCHES = {
    "stamps": [
        ("template <class S>\nstruct Io;",
         STAMP + "template <class S>\nstruct Io;"),
        (HELPERS_IN, HELPERS_IN + "\n        stamp(i, 0);"),
        ("        keep = keep_next;",
         "        keep = keep_next;\n        stamp(i, 1);"),
        ("        sum(i - 1);", "        stamp(i - 1, 2);\n        sum(i - 1);"
         "\n        stamp(i - 1, 3);"),
        (READY, "    stamp(i, 4);\n" + READY + "\n    stamp(i, 5);"),
        (DONE, "    stamp(i, 6);\n" + DONE),
        (ERR, READ + ERR)],
    "no_sums": [("        sum(i - 1);", "        if (i < 2) sum(i - 1);")],
    "no_prepare": [(ITEMS, ITEMS.replace("= (", "= i < 2 ? (")
                    .replace(";", " : 0;"))],
    "no_register_cap": [("  return cols_for(G) == 16 ? 4 : 2;",
                         "  return cols_for(G) == 16 ? 4 : 1;")],
}


def variant(name: str, patches: list) -> str:
    """A tree holding this tree's wrapper and headers and its kernel source
    patched; each patch's anchor must occur once."""
    tree = os.path.join(ROOT, "build", "wkv_probe", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, KERNELS), os.path.join(tree, KERNELS))
    path = os.path.join(tree, KERNELS, "csrc", "wkv6.cu")
    with open(path) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return tree


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    mods = {"as_is": ab.build_other(ROOT)}
    mods.update((name, ab.build_other(variant(name, p)))
                for name, p in PATCHES.items())
    gen = torch.Generator(device=dev).manual_seed(24)
    args = cs.wkv_inputs(gen, 1, 1024, 64, 64, False, dev)
    ab.held(lambda: mods["as_is"].wkv6(*args), args)
    ab.held(lambda: mods["stamps"].wkv6(*args), args)
    tiles = -(-1024 // mods["as_is"].plan(1, 1024, 64, 64).tile)
    buf = np.zeros(64 * 8, np.int64)
    mods["stamps"].wkv6(*args)
    torch.cuda.synchronize()
    fn = mods["stamps"]._lib.wkv6_stamps
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    if fn(buf.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    st = buf.reshape(64, 8)[:tiles]
    phases = {"helpers: prepare": st[:, 1] - st[:, 0],
              "helpers: sum": st[:, 3] - st[:, 2],
              "owners: wait for a prepared tile": st[:, 5] - st[:, 4],
              "owners: a tile's recurrence": st[:, 6] - st[:, 5]}
    cycles = {k: float(np.median(v[1:-1])) for k, v in phases.items()}
    times = ab.in_turns({k: (lambda m=m: m.wkv6(*args))
                         for k, m in mods.items() if k != "stamps"},
                        cs.device_ms, 3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    for k, c in cycles.items():
        print(f"{k}: {c:.0f} cycles a tile (median)", flush=True)
    print("device ms a launch: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in ms.items()))
    print(json.dumps({"card": cs.card_line(), "tiles": tiles,
                      "cycles_a_tile": cycles, "device_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
