"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), then:

1. kernels: every kernel against its plain PyTorch version on the card,
   bitwise, over every op and dtype, including the main path's slab shape,
   and its time (CUDA events, median) beside its memory bound; the bf16
   cast and ``combine2`` timed in turns with their PyTorch calls
   (``.to(torch.bfloat16)``, ``torch.add``), and each kernel's device time
   per launch (profiler) and host cost per call (host clock, no sync);
   ``combine2``'s device time in turns with ``torch.add``'s, and its host
   cost split into the wrapper's parts;
2. collectives at p = 8: every ``all_reduce`` method, the kernel-carried
   outputs bitwise equal to the same engine with the plain combines and
   casts, every method within tolerance of a float64 sum, and a
   non-commutative operator through ``structured_all_reduce`` against the
   port's simulator;
3. the collective main path at the paper's scale, p = 288 ranks stacked
   on the card and m = 8,388,608 elements each: ``dptree`` in f32 and
   exactly in int32, and ``hier`` over 36 groups of 8 with the bf16
   slow-stage wire;
4. the int8 K/V kernels against their plain versions, bitwise, over widths
   12/64/128/256, f32 and bf16 inputs, zero rows, .5 ties, codes at +-127
   and unaligned codes, then at the decode path's own shapes (one token's
   (576, 64) bf16 rows; the fused write of one token's K and V, (16, 1, 36,
   64) each, into (16, 8192, 36, 64) int8 rings with every row at slot 0,
   4096 or 8191; the whole (4,718,592, 64) int8 ring to bf16), timed, the
   token-sized kernels by their device time per launch and host cost per
   call;
5. the serving main path at full width: MiniCPM-2B (40 layers, d_model
   2304, 36 heads, 36 K/V heads, vocab 122,753) with bf16 weights and the
   int8 K/V cache, through the port's ``serve_loop``: batch 16, a ring of
   8192, 32 greedy steps, one fused K/V quantize launch per layer and step,
   its tokens and logits bitwise equal to the same run with the plain int8
   versions, one step traced (device operations per step), and a reduced
   MiniCPM-2B on the card
   within bf16 tolerance of the port on the CPU (which the CPU tests hold
   against the JAX package);
6. the flash-attention kernel against its plain version (the port of the
   reference's ``_flash_sdpa``), each output element within ``FLASH_TOL``
   of its size plus its row's largest and the row log-sum-exp within
   ``FLASH_LSE_TOL`` (both in ``kernels/flash_attention.py``): 1 and 4
   query heads per K/V head, head_dim 64 and 128, causal, window, chunk
   and full masks, T = 1025, 1536 and 4096, f32 and bf16 (the window and
   chunks leave the first key tile of many rows fully masked); head_dim 12
   and 16 (zero-padded by the wrapper), 1 and 2 query heads per K/V head,
   at T = 1025 and 1088, every mask, f32 and bf16; then at the training
   path's shape (4, 4096, 36, 64) bf16 causal, timed in turns with SDPA
   (kernel, SDPA, kernel), with ptxas's report of the bf16 kernel;
7. the training main path at full width: MiniCPM-2B's seeded weights drawn
   on the card (timed) and checked against the CPU's draw, then the port's
   ``train_loop`` at seq 4096, batch 4, under full remat (``TRAIN_REMAT``;
   the config's own ``"dots"`` does not fit), for ``TRAIN["steps"]`` steps, its
   batches on the card equal to the CPU's, every step's loss and grad norm
   finite and within tolerance of the same steps with the plain flash
   version, the flash launches counted (forward and recompute, every layer,
   every step), one step traced; and a reduced MiniCPM-2B at its own
   head_dim 12 and T = 1088: its weights drawn on the card within 2 ulp of
   the CPU's, and trained on the card within bf16 tolerance of the port on
   the CPU;
8. training with checkpoints and a restart: MiniCPM-2B at full width cut to
   4 layers, seq 4096, batch 4, under its own ``"dots"`` remat: 8 steps in
   one run, then with a checkpoint every 3 steps and a failure injected
   after step 5 under ``run_with_restarts``: one restart, the restored
   params and AdamW moments bitwise what was saved, every loss after the
   resume within 2e-3 of the uninterrupted run's, the device memory at the
   restart back at its level before the failed attempt, each save's and the
   restore's seconds (under a directory of ``build/`` the phase removes);
   then ``"dots"`` against ``"full"`` at all 40 layers and batch 2 in
   turns: peak memory, median step, losses within ``TRAIN_TOL``;
9. continuous serving at full width: MiniCPM-2B with bf16 weights and the
   int8 K/V cache through the port's ``ServingEngine`` (16 slots, a ring of
   8192 as in phase 5, prefill chunks of 1024), 24 synthetic requests a
   tick apart with prompts of 256 to 2560 tokens and 8 to 32 new tokens:
   the fused K/V write held bitwise against its plain version at the
   path's two shapes, each row at its own position (a decode tick's 16
   rows at mixed positions, a 1024-token chunk that wraps the ring), and
   timed beside its byte bound; the greedy run with one fused write per
   layer for every decode tick and prefill chunk and two dequantizes for
   each, its streams bitwise those of the plain int8 run and of the static
   policy; a seeded sampled run twice, equal, the second timed call by
   call (so the greedy run's wall holds no extra sync); every request
   ending with its budget; the run's per-tick stats reduced over 4 and
   over 8 replicas stacked on the card (b = 1: the ring, then the
   dual-root tree), equal to numpy's sum; ticks, wall, tokens/s, TTFT and
   latency, the median decode tick and prefill chunk, the peak memory, the
   phase's seconds, and one prefill chunk traced.

In phases 3, 5, 7, 8 and 9 the kernels' launch counters are zeroed just before the
main path and read just after, and must show that the kernels carried it.
It prints the card's name and power limit, one JSON line of kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
raises before that line. Without a CUDA device it exits nonzero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ["REPRO_TORCH_AUTOTUNE"] = "0"   # auto picks from the cost model

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import checkpointing  # noqa: E402
from repro_torch.core import (CollectiveConfig, LocalTransport,  # noqa: E402
                              all_reduce, build_dual_tree, build_hierarchy,
                              cost_model, dptree, simulate_allreduce,
                              structured_all_reduce)
from repro_torch.configs.base import (decode_config, get_arch,  # noqa: E402
                                      get_config)
from repro_torch.data import threefry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, block_combine, quantize, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve, step_fns, train  # noqa: E402
from repro_torch.serving import (SamplingParams, ServingEngine,  # noqa: E402
                                 STATS_FIELDS, make_stats_reducer)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import fault_tolerance  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the f32 rate outside the
# tensor cores (the combine and cast kernels use no tensor core) and the
# dense bf16 tensor-core rate (the flash kernel's products).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

P_FULL, M_FULL = 288, 8_388_608      # the paper's cluster (cost_model.py)
P_SMALL, M_SMALL = 8, 1_000_003
OPS = ("add", "max", "min", "mul")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
KERNEL_FILES = {
    "combine2": ("src/repro_torch/kernels/csrc/block_combine.cu",
                 "src/repro/kernels/block_combine.py:46"),
    "combine3": ("src/repro_torch/kernels/csrc/block_combine.cu",
                 "src/repro/kernels/block_combine.py:50"),
    "compress_bf16": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:75"),
    "decompress_bf16": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:75"),
    "quantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:32"),
    "quantize_int8_into": ("src/repro_torch/kernels/csrc/quantize.cu",
                           "src/repro/kernels/quantize.py:32"),
    "dequantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:41"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:30"),
}
WRAPPERS = {"combine2": block_combine.combine2,
            "combine3": block_combine.combine3,
            "compress_bf16": quantize.compress_bf16,
            "decompress_bf16": quantize.decompress_bf16,
            "quantize_int8": quantize.quantize_int8,
            "quantize_int8_into": quantize.quantize_int8_into,
            "dequantize_int8": quantize.dequantize_int8,
            "flash_attention": fa.flash_attention}
# phase 5: MiniCPM-2B decode, cut from the reference's decode_32k cell
# (batch 128, 32,768 cached tokens) to what one 80 GB card holds
DECODE = dict(arch="minicpm_2b", batch=16, cache_len=8192, steps=32, seed=0)
# phase 9: MiniCPM-2B continuous serving on phase 5's cache (16 slots, a
# ring of 8192), prompts of up to three 1024-token prefill chunks
SERVE = dict(arch="minicpm_2b", slots=16, cache_len=8192, prefill_chunk=1024,
             requests=24, gap=1, prompt_lens=(256, 2560), max_new=(8, 32),
             seed=0)
SAMPLED = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=0)
# phase 7: MiniCPM-2B training, cut from the reference's train_4k cell
# (seq 4096, global batch 256) to the batch one 80 GB card holds
TRAIN = dict(arch="minicpm_2b", seq_len=4096, global_batch=4, accum=1,
             steps=3, lr=1e-4, seed=0, log_every=1)
# phase 7's remat policy, set explicitly: MiniCPM-2B's own "dots" keeps
# every layer's weight products, which do not fit beside full-width AdamW at
# batch 4 on an 80 GB card (tools/torch_remat_memory.py, PERF.md section 4)
TRAIN_REMAT = "full"
# phase 8: training with checkpoints and a restart, MiniCPM-2B at full width
# cut to 4 layers (one checkpoint of f32 params and AdamW moments is about
# 6.3 GB) at phase 7's seq 4096 and batch 4, under the config's own "dots"
CKPT = dict(layers=4, steps=8, ckpt_every=3, fail_at=5)
# each loss after the resume within 2e-3 of the uninterrupted run's (the
# bound of the reference's test_checkpoint_resume_matches_uninterrupted)
RESUME_TOL = 2e-3
# phase 8's "dots" against "full": all 40 layers, at the batch both fit
DOTS = dict(global_batch=2, steps=3)
FLASH_LENGTHS = (1025, 1536, 4096)
# the reduced configs' head_dims, which the wrapper zero-pads to 64
PADDED_DIMS, PADDED_LENGTHS = (12, 16), (1025, 1088)
# seeded weights, card against CPU: the draw is IEEE operations only, so
# equal in practice; the limit is the port's 2 ulp of f32
INIT_ULP = 2
# training, kernel vs plain flash (same params and batches): each step's
# loss and grad norm within TRAIN_TOL relative, about ten times the gaps a
# sound kernel reads (PERF.md); reduced training, card vs CPU: losses
# within 2**-8 (the CPU tests' bound against the JAX package)
TRAIN_TOL = {"loss": 5e-4, "grad_norm": 2.5e-3}
REDUCED_TOL = 2.0 ** -8
U = 2.0 ** -24                       # f32 unit roundoff
# bf16 bit patterns for the head of every max/min operand: +0, -0, quiet and
# signalling NaNs of both signs, +inf, -inf, 1. Each NaN's payload names
# its operand (add 0, 1 or 2), so a kernel that returns the wrong one of two
# NaNs shows. f32 operands take the same patterns in their top 16 bits.
SPECIALS = (0x0000, 0x8000, 0x7fc1, 0xffc1, 0x7f81, 0xff81, 0x7f80, 0xff80,
            0x3f80)
NAN_SLOTS = (2, 3, 4, 5)


def log(*a):
    print(*a, flush=True)


def from_words(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Unsigned bit patterns (int64) as the same-width signed integers
    that ``.view(dtype)`` turns into ``dtype``."""
    nbits = 8 * torch.empty(0, dtype=dtype).element_size()
    signed = words - (words >= 2 ** (nbits - 1)).long() * 2 ** nbits
    return signed.to({16: torch.int16, 32: torch.int32}[nbits])


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def check_bitwise(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    bad = int((bits(got) != bits(want)).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {got.numel()} elements "
                             "differ in bits")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.numel() == 0:
        return 0.0
    d = (got.double() - want.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0, posinf=0.0).max())


def zero_counters() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def counters() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def time_ms(fn, reps: int = 50) -> float:
    """Device time of one call: CUDA events around ``reps`` calls issued
    back to back (so the queue stays full and the host's launch cost hides
    behind the device's work), divided by ``reps``; median of three such
    runs."""
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


def in_turns(kernel, library, rounds: int = 4, timer=None) -> dict:
    """``timer`` (``time_ms`` by default) of a kernel and of the PyTorch
    call computing the same function, alternately (kernel, library,
    library, kernel, ...), so that neither always runs first, after one
    untimed pass of each (the card's clocks settle): each side's times,
    median and spread (the range over the median)."""
    timer = timer or time_ms
    timer(kernel)
    timer(library)
    got = {"kernel": [], "library": []}
    for r in range(rounds):
        for side in (("kernel", "library") if r % 2 == 0
                     else ("library", "kernel")):
            got[side].append(timer(kernel if side == "kernel"
                                   else library))
    out = {}
    for side, t in got.items():
        med = float(np.median(t))
        out[side] = {"ms": t, "median_ms": med,
                     "spread": (max(t) - min(t)) / med}
    return out


def device_ms(fn, reps: int = 50, sessions: int = 3) -> float:
    """Device time per launch of a call that launches one kernel: the
    profiler's self device time over ``reps`` calls, divided by the launches
    it recorded (the queue's gaps between launches are not in it). Raises
    unless the calls ran one kernel, at most once per call. A session that
    recorded no device activity at all (the profiler once returned none for
    a kernel it records in other sessions) is logged and run again, up to
    ``sessions`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for session in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if "CUDA" in str(e.device_type)
                and e.self_device_time_total > 0]
        if rows:
            break
        log(f"  profiler session {session + 1} recorded no device "
            "activity; running it again")
    if len(rows) != 1 or not 0 < rows[0].count <= reps:
        raise AssertionError(f"{reps} calls ran "
                             f"{[(e.key[:60], e.count) for e in rows]}")
    return rows[0].self_device_time_total / rows[0].count / 1e3


def host_ms(fn, calls: int = 200) -> float:
    """Host cost of one call: the host clock over ``calls`` calls issued
    without a synchronize, divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e3


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_breakdown(fn, top: int = 8) -> dict:
    """One traced run under ``torch.profiler``: the device time of each
    kernel name, summed, the count of device operations (kernels, copies
    and fills) and the device's busy share of the traced wall time (its
    idle share is the rest). Kernels overlap nothing here (one
    stream), so the busy time is the sum over kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"traced_wall_ms": secs * 1e3, "device_busy_ms": busy_ms,
            "device_ops": sum(r[2] for r in rows),
            "device_idle_share": max(0.0, 1.0 - busy_ms / (secs * 1e3)),
            "top_kernels": [{"name": k[:90], "ms": ms, "count": c}
                            for k, ms, c in rows[:top]]}


@contextlib.contextmanager
def plain_kernels():
    """Run the engine with the plain PyTorch combines and casts in place of
    the kernels (for the bitwise comparison; launches nothing counted)."""
    saved = (dptree._combine3_local, dptree._compress_wire,
             dptree._decompress_wire)
    dptree._combine3_local = \
        lambda a, b, c, op_name: ref.combine3_ref(a, b, c, op=op_name)
    dptree._compress_wire = lambda x: ref.compress_bf16_ref(x)
    dptree._decompress_wire = lambda x: ref.decompress_bf16_ref(x)
    try:
        yield
    finally:
        (dptree._combine3_local, dptree._compress_wire,
         dptree._decompress_wire) = saved


@contextlib.contextmanager
def plain_int8():
    """Run the K/V cache with the plain int8 quantize, fused write and
    dequantize in place of the kernels (the model reaches them through
    ``kernels.ops``, which looks the wrappers up at each call)."""
    saved = (quantize.quantize_int8, quantize.quantize_int8_into,
             quantize.dequantize_int8)
    quantize.quantize_int8 = ref.quantize_int8_ref
    quantize.quantize_int8_into = ref.quantize_int8_into_ref
    quantize.dequantize_int8 = ref.dequantize_int8_ref
    try:
        yield
    finally:
        (quantize.quantize_int8, quantize.quantize_int8_into,
         quantize.dequantize_int8) = saved


@contextlib.contextmanager
def plain_flash():
    """Run attention with the plain flash forward in place of the kernel
    (the autograd Function looks the wrapper up at each call)."""
    saved = fa.flash_attention
    fa.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        fa.flash_attention = saved


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- kernels

def operand(gen, n, dt, op, dev, which):
    """Operand ``which`` (0, 1, 2) of a combine. For max and min its first
    9**3 elements run through every triple of ``SPECIALS`` across the three
    operands; the rest is randn with 2 % infinities."""
    if dt == "i32":
        return torch.randint(-1000, 1001, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    x = torch.randn(n, generator=gen, device=dev)
    infs = (math.inf, -math.inf) if op in ("max", "min") else (math.inf,)
    for inf in infs:
        x[torch.rand(n, generator=gen, device=dev) < 0.02] = inf
    x = x.to(DTYPES[dt])
    if op in ("max", "min"):
        s = len(SPECIALS)
        k = min(n, s ** 3)
        words = torch.tensor([w + which if i in NAN_SLOTS else w
                              for i, w in enumerate(SPECIALS)], device=dev)
        words = words[(torch.arange(k, device=dev) // s ** which) % s]
        if dt == "f32":
            words = words << 16
        head = from_words(words, x.dtype)
        x.view(head.dtype)[:k] = head
    return x


def cast_inputs(gen, n, dev):
    special = torch.tensor([0x7f800000, 0xff800000, 0x7fc00000, 0xffc00000,
                            0x7f800001, 0x00000001, 0x80000001, 0x007fffff,
                            0x00008000, 0x00018000, 0x3f808000, 0x3f818000,
                            0x3f808001, 0x00000000, 0x80000000, 0x7f7fffff],
                           dtype=torch.int64)  # inf, NaN, subnormal, ties
    rnd = torch.randint(0, 2 ** 32, (n,), generator=gen, device=dev,
                        dtype=torch.int64)
    words = torch.cat([special.to(dev), rnd])
    return from_words(words, torch.float32).view(torch.float32)


def kernel_phase(dev, slab_n: int, slab_shape: tuple, wire_shape: tuple):
    gen = torch.Generator(device=dev).manual_seed(1)
    sizes = (1, 1000, (1 << 20) + 3, slab_n)
    errs = {k: 0.0 for k in WRAPPERS}
    checks = 0
    for op in OPS:
        for dt in DTYPES:
            for n in sizes:
                a, b, c = (operand(gen, n, dt, op, dev, i) for i in range(3))
                for x, y, z in ((a, b, c), (a[1:], b[1:], c[1:])):
                    got3 = block_combine.combine3(x, y, z, op=op)
                    want3 = ref.combine3_ref(x, y, z, op=op)
                    got2 = block_combine.combine2(x, y, op=op)
                    want2 = ref.combine2_ref(x, y, op=op)
                    check_bitwise(got3, want3, f"combine3 {op} {dt} n={n}")
                    check_bitwise(got2, want2, f"combine2 {op} {dt} n={n}")
                    errs["combine3"] = max(errs["combine3"],
                                           max_abs_err(got3, want3))
                    errs["combine2"] = max(errs["combine2"],
                                           max_abs_err(got2, want2))
                    checks += 2
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(dev)
    for n in sizes:
        x = cast_inputs(gen, n, dev)
        h, want = quantize.compress_bf16(x), ref.compress_bf16_ref(x)
        check_bitwise(h, want, f"compress_bf16 n={n}")
        errs["compress_bf16"] = max(errs["compress_bf16"], max_abs_err(h, want))
        for src in (h, every):
            back = quantize.decompress_bf16(src)
            want = ref.decompress_bf16_ref(src)
            check_bitwise(back, want, f"decompress_bf16 n={n}")
            errs["decompress_bf16"] = max(errs["decompress_bf16"],
                                          max_abs_err(back, want))
        checks += 3
    torch.cuda.synchronize()

    # ---- the shapes the main path gives each kernel: checked, then timed --
    a, b, c = (torch.randn(slab_shape, generator=gen, device=dev)
               for _ in range(3))
    n = a.numel()
    w = torch.randn(wire_shape, generator=gen, device=dev)
    wh = w.to(torch.bfloat16)
    nw = w.numel()
    for name, got, want in (
            ("combine3", block_combine.combine3(a, b, c),
             ref.combine3_ref(a, b, c)),
            ("combine2", block_combine.combine2(a, b), ref.combine2_ref(a, b)),
            ("compress_bf16", quantize.compress_bf16(w),
             ref.compress_bf16_ref(w)),
            ("decompress_bf16", quantize.decompress_bf16(wh),
             ref.decompress_bf16_ref(wh))):
        check_bitwise(got, want, f"{name} at {list(got.shape)}")
        errs[name] = max(errs[name], max_abs_err(got, want))
        checks += 1
        del got, want
    torch.cuda.synchronize()
    log(f"kernels: {checks} bitwise checks against the plain versions passed")
    work = {  # name: (kernel, plain, library call or None, bytes, ops)
        "combine3": (lambda: block_combine.combine3(a, b, c),
                     lambda: ref.combine3_ref(a, b, c), None,
                     16 * n, 2 * n),
        "combine2": (lambda: block_combine.combine2(a, b),
                     lambda: ref.combine2_ref(a, b),
                     lambda: torch.add(a, b), 12 * n, n),
        "compress_bf16": (lambda: quantize.compress_bf16(w),
                          lambda: ref.compress_bf16_ref(w),
                          lambda: w.to(torch.bfloat16), 6 * nw, nw),
        "decompress_bf16": (lambda: quantize.decompress_bf16(wh),
                            lambda: ref.decompress_bf16_ref(wh),
                            lambda: wh.to(torch.float32), 6 * nw, nw),
    }
    rows = {}
    for name, (kern, plain, lib, nbytes, nops) in work.items():
        turns = None
        if name in ("compress_bf16", "combine2"):
            turns = in_turns(kern, lib)
            t_k = turns["kernel"]["median_ms"]
            t_l = turns["library"]["median_ms"]
        else:
            t_k = time_ms(kern)
            t_l = time_ms(lib) if lib is not None else None
        t_p = time_ms(plain)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        src, replaces = KERNEL_FILES[name]
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": None,
                      "max_abs_err": errs[name], "ms": t_k,
                      "plain_ms": t_p, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": t_l, "device_ms": device_ms(kern),
                      "host_ms": host_ms(kern),
                      "library_device_ms": device_ms(lib)
                      if lib is not None else None,
                      "shape": list(slab_shape if name.startswith("combine")
                                    else wire_shape)}
        log(f"  {name:16s} {rows[name]['shape']}: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms "
            f"({rows[name]['bound_by']})"
            + (f", library {t_l:.4f} ms" if t_l is not None else "")
            + f"; device {rows[name]['device_ms']:.4f} ms a launch, host "
            f"{rows[name]['host_ms']:.4f} ms a call"
            + (f" (library device {rows[name]['library_device_ms']:.4f} ms)"
               if lib is not None else ""))
        if turns is not None:
            rows[name]["in_turns"] = turns
            log(f"    in turns (kernel, library, library, kernel, ...): "
                + "; ".join(f"{side} {v['ms']} ms, median "
                            f"{v['median_ms']:.4f}, spread "
                            f"{100 * v['spread']:.1f} %"
                            for side, v in turns.items()))
        if name == "combine2":
            dev_turns = in_turns(kern, lib, timer=device_ms)
            rows[name]["device_in_turns"] = dev_turns
            log(f"    device time per launch in turns: "
                + "; ".join(f"{side} {v['ms']} ms, median "
                            f"{v['median_ms']:.5f}, spread "
                            f"{100 * v['spread']:.1f} %"
                            for side, v in dev_turns.items()))
    split = combine_host_split(a, b)
    rows["combine2"]["host_split_ms"] = split
    log("  combine2 host cost per call, split (host clock over 200 calls "
        "without a sync, median of 3): " + ", ".join(
            f"{k} {v:.5f}" for k, v in split.items()) + " ms")
    del a, b, c, w, wh
    return rows


def combine_host_split(a, b, rounds: int = 3) -> dict:
    """The host cost of one ``combine2`` call on ``a`` and ``b`` split into
    its parts, each timed alone by ``host_ms``: the operand check (now and
    as it was), the output's allocation, the current-stream lookup (and PyTorch's raw
    stream call where it has one), the current-device query that now picks
    the path, entering a device context, ``_build.load`` (its lock and dict
    lookup), looking the ctypes function up on the library, and the ctypes
    call itself with the launch inside the library; then the whole call as
    the wrapper makes it now and as it made it before (load, device context
    and function lookup on every call). Medians of ``rounds`` passes."""
    dev, n = a.device, a.numel()
    out = torch.empty_like(a)
    lib = _build.load("block_combine", block_combine._SIGNATURES)
    fn = block_combine._fn("bc_combine2")
    stream = torch.cuda.current_stream(dev).cuda_stream
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()

    def device_context():
        with torch.cuda.device(dev):
            pass

    def check_before(op, *xs):      # the parent's _check, as it was
        if op not in block_combine._OP_CODE:
            raise ValueError(op)
        x0 = xs[0]
        for x in xs[1:]:
            if x.shape != x0.shape or x.dtype != x0.dtype or \
                    x.device != x0.device:
                raise ValueError("operands differ")
        if x0.dtype not in block_combine._DTYPE_CODE:
            raise TypeError(x0.dtype)
        if x0.device.type not in ("cpu", "cuda"):
            raise ValueError(x0.device)
        if not all(x.is_contiguous() for x in xs):
            raise ValueError("not contiguous")

    def before():
        check_before("add", a, b)
        o = torch.empty_like(a)
        f = _build.load("block_combine", block_combine._SIGNATURES)
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream(dev).cuda_stream
            rc = f.bc_combine2(0, 0, a.data_ptr(), b.data_ptr(),
                               o.data_ptr(), n, st)
        if rc:
            raise RuntimeError(f"bc_combine2 failed: {rc}")
        return o

    parts = {
        "check": lambda: block_combine._check("add", (a, b)),
        "check_before": lambda: check_before("add", a, b),
        "empty_like": lambda: torch.empty_like(a),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current_device": torch.cuda.current_device,
        "device_context": device_context,
        "build_load": lambda: _build.load("block_combine",
                                          block_combine._SIGNATURES),
        "getattr_fn": lambda: lib.bc_combine2,
        "ctypes_call": lambda: fn(0, 0, pa, pb, po, n, stream),
        "wrapper_now": lambda: block_combine.combine2(a, b),
        "wrapper_before": before,
    }
    got = {k: [] for k in parts}
    for _ in range(rounds):
        for k, f in parts.items():
            got[k].append(host_ms(f))
    return {k: float(np.median(v)) for k, v in got.items()}


# ------------------------------------------------------------- collectives

def f64_check(out: torch.Tensor, X: torch.Tensor, rel: float, what: str,
              cols: int = 1 << 20) -> float:
    """|out - sum| <= rel * sum|x| per column, the float64 sum taken in
    column chunks so that no (p, m) float64 buffer is needed. Returns the
    largest error as a share of sum|x|."""
    worst = 0.0
    for c0 in range(0, X.shape[1], cols):
        xs = X[:, c0:c0 + cols].double()
        want = xs.sum(0)
        scale = xs.abs().sum(0).clamp_min(1e-30)
        err = (out[:, c0:c0 + cols].double() - want).abs() / scale
        worst = max(worst, float(err.max()))
        del xs
    if not worst <= rel:
        raise AssertionError(f"{what}: error {worst:.3e} of sum|x| exceeds "
                             f"{rel:.3e}")
    return worst


def same_rows(out: torch.Tensor, what: str) -> None:
    if not bool((bits(out) == bits(out[:1])).all()):
        raise AssertionError(f"{what}: ranks disagree")


def mm(a, b):
    """2x2 matrix product per slot, written out (no fused multiply-add)."""
    e = lambda i, j: a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
    return torch.stack([torch.stack([e(i, 0), e(i, 1)], -1)
                        for i in range(2)], -2)


def mm_np(a, b):
    e = lambda i, j: a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
    return np.stack([np.stack([e(i, 0), e(i, 1)], -1) for i in range(2)], -2)


def small_phase(dev):
    p, m = P_SMALL, M_SMALL
    comm = LocalTransport(p, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    X = torch.randn((p, m), generator=gen, device=dev)
    h2 = int(math.ceil(math.log2(p)))
    methods = {
        "dptree": (CollectiveConfig(method="dptree"), (2 * h2 + 4) * U),
        "sptree": (CollectiveConfig(method="sptree"), (2 * h2 + 4) * U),
        "redbcast": (CollectiveConfig(method="redbcast"), (2 * h2 + 4) * U),
        "ring": (CollectiveConfig(method="ring"), p * U),
        "hier(4,)": (CollectiveConfig(method="hier", group_size=4),
                     (2 * h2 + 4) * U),
        "hier(2,2)": (CollectiveConfig(method="hier", group_size=(2, 2)),
                      (2 * h2 + 4) * U),
        "hier(4,)+bf16": (CollectiveConfig(method="hier", group_size=4,
                                           compress_inter_group=True),
                          (2 + 1) * 2.0 ** -8),
        "psum": (CollectiveConfig(method="psum"), p * U),
        "auto": (CollectiveConfig(method="auto"), (2 * h2 + 4) * U),
    }
    for name, (cfg, rel) in methods.items():
        out = all_reduce(X, comm, cfg)
        with plain_kernels():
            plain = all_reduce(X, comm, cfg)
        check_bitwise(out, plain, f"p={p} {name}: kernels vs plain")
        worst = f64_check(out, X, rel, f"p={p} {name}")
        log(f"  p={p} m={m} {name:14s} bitwise = plain, error "
            f"{worst:.2e} of sum|x| (limit {rel:.2e})")
    # exact int32 and the other fused ops
    Xi = torch.randint(-1000, 1001, (p, m), generator=gen, device=dev,
                       dtype=torch.int32)
    out = all_reduce(Xi, comm, CollectiveConfig(method="dptree"))
    if not bool((out == Xi.sum(0, dtype=torch.int32)).all()):
        raise AssertionError("p=8 int32 dptree is not exact")
    for op, want in (("max", X.amax(0)), ("min", X.amin(0))):
        got = all_reduce(X, comm, CollectiveConfig(method="dptree"), op=op)
        check_bitwise(got, want.expand_as(got), f"p={p} dptree {op}")
    # a non-commutative operator on the general path, against the simulator
    rng = np.random.default_rng(3)
    Xm = (rng.standard_normal((p, 64, 2, 2)) * 0.3 + np.eye(2)).astype(
        np.float32)
    sim = simulate_allreduce([Xm[i].reshape(-1) for i in range(p)], 1,
                             op=lambda a, b: mm_np(a.reshape(-1, 2, 2),
                                                   b.reshape(-1, 2, 2))
                             .reshape(-1))
    got = structured_all_reduce({"m": torch.from_numpy(Xm).to(dev)}, comm,
                                lambda a, b: {"m": mm(a["m"], b["m"])})["m"]
    got = got.reshape(p, -1).cpu().numpy()
    want = np.stack(sim.outputs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    log(f"  p={p} structured 2x2-matmul vs simulator: max diff "
        f"{np.abs(got - want).max():.2e} (bitwise: "
        f"{np.array_equal(got.view(np.int32), want.view(np.int32))})")
    log("  p=8 int32 exact, max/min bitwise: ok")


def full_phase(dev):
    p, m = P_FULL, M_FULL
    comm = LocalTransport(p, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    nbytes = m * 4
    nb = cost_model.optimal_blocks(p, float(nbytes), cost_model.PAPER_HYDRA,
                                   "dptree")
    topo = build_dual_tree(p)
    fused_steps = topo.num_macro_rounds(nb) * len(topo.active_classes())
    log(f"  p={p} m={m}: optimal_blocks = {nb} (block {-(-m // nb)} "
        f"elements), {fused_steps} fused steps")
    results = {}

    # -- dptree, f32 ---------------------------------------------------------
    X = torch.randn((p, m), generator=gen, device=dev)
    cfg = CollectiveConfig(method="dptree")
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    out, secs = wall(lambda: all_reduce(X, comm, cfg))
    got = counters()
    if got["combine3"] != fused_steps:
        raise AssertionError(f"dptree f32: combine3 launched "
                             f"{got['combine3']} times, want {fused_steps}")
    peak = torch.cuda.max_memory_allocated()
    same_rows(out, "dptree f32")
    worst = f64_check(out, X, (2 * topo.max_depth + 4) * U, "dptree f32")
    results["dptree_f32"] = {"seconds": secs, "launches": got,
                             "max_memory_bytes": peak,
                             "err_share_of_abs_sum": worst}
    log(f"  dptree f32: {secs:.3f} s, launches {got}, peak memory "
        f"{peak / 2**30:.2f} GiB, error {worst:.2e} of sum|x|")
    with plain_kernels():
        plain = all_reduce(X, comm, cfg)
    check_bitwise(out, plain, "dptree f32: kernels vs plain")
    log("  dptree f32: bitwise equal to the engine with the plain combines")
    del out, plain
    # The kernel against the plain combines end to end, in turns (plain,
    # kernel, kernel, plain) so that neither side gets the first call.
    ab = {"kernel": [], "plain": []}
    for side in ("plain", "kernel", "kernel", "plain"):
        with plain_kernels() if side == "plain" else contextlib.nullcontext():
            ab[side].append(wall(lambda: all_reduce(X, comm, cfg))[1])
    results["dptree_f32_turns_seconds"] = ab
    log(f"  dptree f32 in turns (plain, kernel, kernel, plain): kernel "
        f"{ab['kernel']} s, plain combines {ab['plain']} s")
    results["dptree_f32_trace"] = trace = device_breakdown(
        lambda: all_reduce(X, comm, cfg))
    log(f"  dptree f32 traced: {json.dumps(trace)}")

    # -- hier, 36 groups of 8, bf16 slow-stage wire ---------------------------
    hcfg = CollectiveConfig(method="hier", group_size=8,
                            compress_inter_group=True)
    h = build_hierarchy(p, 8)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    out, secs = wall(lambda: all_reduce(X, comm, hcfg))
    got = counters()
    if (got["compress_bf16"], got["decompress_bf16"], got["combine3"]) != \
            (1, 1, 0):
        raise AssertionError(f"hier bf16: launches {got}, want one cast each "
                             "way and no combine3 (wire combines run in f32)")
    peak = torch.cuda.max_memory_allocated()
    g = h.num_groups
    rel = (2 + int(math.ceil(math.log2(g)))) * 2.0 ** -8
    same_rows(out, "hier bf16")
    worst = f64_check(out, X, rel, "hier bf16")
    hb = cost_model.optimal_blocks(p, float(nbytes), cost_model.PAPER_HYDRA,
                                   "hier", group_size=8, compression="bf16")
    results["hier_bf16"] = {"seconds": secs, "launches": got,
                            "num_blocks": hb, "max_memory_bytes": peak,
                            "err_share_of_abs_sum": worst}
    log(f"  hier (8,) bf16 wire, {g} groups, {hb} blocks: {secs:.3f} s, "
        f"launches {got}, peak {peak / 2**30:.2f} GiB, error {worst:.2e} of "
        f"sum|x| (limit {rel:.2e})")
    with plain_kernels():
        plain = all_reduce(X, comm, hcfg)
    check_bitwise(out, plain, "hier bf16: kernels vs plain")
    log("  hier bf16: bitwise equal to the engine with the plain casts")
    del out, plain
    results["hier_bf16_trace"] = trace = device_breakdown(
        lambda: all_reduce(X, comm, hcfg))
    log(f"  hier bf16 traced: {json.dumps(trace)}")
    del X

    # -- dptree, int32, exact -------------------------------------------------
    Xi = torch.randint(-1000, 1001, (p, m), generator=gen, device=dev,
                       dtype=torch.int32)
    zero_counters()
    out, secs = wall(lambda: all_reduce(Xi, comm, cfg))
    got = counters()
    nb_i = cost_model.optimal_blocks(p, float(nbytes), cost_model.PAPER_HYDRA,
                                     "dptree")
    want_steps = topo.num_macro_rounds(nb_i) * len(topo.active_classes())
    if got["combine3"] != want_steps:
        raise AssertionError(f"dptree int32: combine3 launched "
                             f"{got['combine3']} times, want {want_steps}")
    ref_sum = Xi.sum(0, dtype=torch.int32)
    if not bool((out == ref_sum).all()):
        raise AssertionError("dptree int32 is not exact")
    results["dptree_i32"] = {"seconds": secs, "launches": got}
    log(f"  dptree int32: {secs:.3f} s, launches {got}, exact")
    del out, Xi
    return results

# ------------------------------------------------------------ int8 K/V rows

def int8_rows(gen, rows: int, width: int, dev) -> torch.Tensor:
    """f32 rows at scales 1e-3..1e3, then adversarial rows: zeros; absmax
    127 (scale exactly 1.0) with exact .5 ties of x/scale of both signs;
    +-absmax (codes +-127); a row under the 1e-8 floor."""
    x = torch.randn((rows, width), generator=gen, device=dev)
    x *= 10.0 ** (torch.rand((rows, 1), generator=gen, device=dev) * 6 - 3)
    special = [[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5,
                -3.5, 64.5], [-3.0, 3.0, 1.0, -1.0], [4e-9, -2e-9, 1e-12, 0.0],
               [0.0]]
    tail = [torch.tensor(r, device=dev).repeat(-(-width // len(r)))[:width]
            for r in special]
    return torch.cat([x, torch.stack(tail)])


def check_int8(x: torch.Tensor, errs: dict, what: str) -> int:
    """Both kernels on ``x`` against the plain versions, bitwise; returns
    the number of checks."""
    q, s = quantize.quantize_int8(x)
    qr, sr = ref.quantize_int8_ref(x)
    check_bitwise(q, qr, f"quantize_int8 codes {what}")
    check_bitwise(s, sr, f"quantize_int8 scales {what}")
    errs["quantize_int8"] = max(errs["quantize_int8"],
                                max_abs_err(q.float(), qr.float()),
                                max_abs_err(s, sr))
    checks = 2
    for dt in (torch.float32, torch.bfloat16):
        got = quantize.dequantize_int8(q, s, dt)
        want = ref.dequantize_int8_ref(q, s, dt)
        check_bitwise(got, want, f"dequantize_int8 to {dt} {what}")
        errs["dequantize_int8"] = max(errs["dequantize_int8"],
                                      max_abs_err(got, want))
        checks += 1
    # codes one byte into a buffer: not 16-byte aligned, the scalar path
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=q.device)
    qu = buf[1:].view(q.shape)
    qu.copy_(q)
    got = quantize.dequantize_int8(qu, s, torch.bfloat16)
    want = ref.dequantize_int8_ref(q, s, torch.bfloat16)
    check_bitwise(got, want, f"dequantize_int8 unaligned {what}")
    errs["dequantize_int8"] = max(errs["dequantize_int8"],
                                  max_abs_err(got, want))
    return checks + 1


def kv_write_inputs(gen, batch: int, kv: int, width: int, slots: int,
                    dtype, dev):
    """One decode step's K and V, (batch, 1, kv, width) each, from
    ``int8_rows`` (the adversarial rows land in V), and int8 rings of
    ``slots`` with f32 scales that already hold earlier tokens."""
    x = int8_rows(gen, 2 * batch * kv - 4, width, dev).to(dtype)
    k, v = (t.reshape(batch, 1, kv, width) for t in x.split(batch * kv))
    shape = (batch, slots, kv, width)
    rings = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
              for _ in range(2)]
    return k, v, (*rings, *scales)


def check_kv_write(gen, batch, kv, width, slots, errs, dev) -> int:
    """The fused K/V write against its plain version, bitwise on both rings
    and both scale arrays (so every other slot keeps its bytes), at slots
    0, the middle and the last, f32 and bf16 sources."""
    checks = 0
    for dt in (torch.float32, torch.bfloat16):
        k, v, bufs = kv_write_inputs(gen, batch, kv, width, slots, dt, dev)
        for slot in (0, slots // 2, slots - 1):
            got = [t.clone() for t in bufs]
            want = [t.clone() for t in bufs]
            quantize.quantize_int8_into(k, v, *got, [slot] * batch,
                                        [1] * batch)
            ref.quantize_int8_into_ref(k, v, *want, [slot] * batch,
                                       [1] * batch)
            for g, w, what in zip(got, want, ("K ring", "V ring",
                                              "K scales", "V scales")):
                check_bitwise(g, w, f"quantize_int8_into {what} {dt} "
                              f"{list(g.shape)} slot {slot}")
                errs["quantize_int8_into"] = max(
                    errs["quantize_int8_into"],
                    max_abs_err(g[:, slot].float(), w[:, slot].float()))
                checks += 1
            del got, want
    return checks


def int8_phase(dev, token_rows: int, ring_rows: int, width: int,
               kv_heads: int, slots: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {"quantize_int8": 0.0, "quantize_int8_into": 0.0,
            "dequantize_int8": 0.0}
    checks = 0
    for w in (12, 64, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            x = int8_rows(gen, 4096, w, dev).to(dt)
            checks += check_int8(x, errs, f"width {w} {dt}")
    # the decode path's shapes: one token's K rows (batch x kv heads, bf16)
    # and the whole int8 ring of one layer's K, made by the kernel itself
    xt = torch.randn((token_rows, width), generator=gen, device=dev).to(
        torch.bfloat16)
    checks += check_int8(xt, errs, f"{list(xt.shape)}")
    ring = torch.randn((ring_rows, width), generator=gen, device=dev).to(
        torch.bfloat16)
    q, s = quantize.quantize_int8(ring)
    qr, sr = ref.quantize_int8_ref(ring)
    check_bitwise(q, qr, f"quantize_int8 codes {list(ring.shape)}")
    check_bitwise(s, sr, f"quantize_int8 scales {list(ring.shape)}")
    del ring, qr, sr
    got = quantize.dequantize_int8(q, s, torch.bfloat16)
    want = ref.dequantize_int8_ref(q, s, torch.bfloat16)
    check_bitwise(got, want, f"dequantize_int8 {list(q.shape)} to bf16")
    errs["dequantize_int8"] = max(errs["dequantize_int8"],
                                  max_abs_err(got, want))
    checks += 3
    del got, want
    # the fused write at the decode path's shape: one token's K and V into
    # a layer's rings
    batch = token_rows // kv_heads
    checks += check_kv_write(gen, batch, kv_heads, width, slots, errs, dev)
    torch.cuda.synchronize()
    log(f"  int8: {checks} bitwise checks against the plain versions passed")
    k, v, bufs = kv_write_inputs(gen, batch, kv_heads, width, slots,
                                 torch.bfloat16, dev)
    nt, nr = xt.numel(), q.numel()
    mid, ones = [slots // 2] * batch, [1] * batch
    # name: (kernel, plain, bytes, ops, shape); ops: |x|, max, divide,
    # round per element (quantize), one product per element (dequantize)
    work = {
        "quantize_int8": (lambda: quantize.quantize_int8(xt),
                          lambda: ref.quantize_int8_ref(xt),
                          2 * nt + nt + 4 * token_rows, 4 * nt,
                          list(xt.shape)),
        "quantize_int8_into": (
            lambda: quantize.quantize_int8_into(k, v, *bufs, mid, ones),
            lambda: ref.quantize_int8_into_ref(k, v, *bufs, mid, ones),
            2 * (2 * nt + nt + 4 * token_rows), 2 * 4 * nt,
            [list(k.shape), list(bufs[0].shape)]),
        "dequantize_int8": (
            lambda: quantize.dequantize_int8(q, s, torch.bfloat16),
            lambda: ref.dequantize_int8_ref(q, s, torch.bfloat16),
            nr + 4 * ring_rows + 2 * nr, nr, list(q.shape)),
    }
    rows = {}
    for name, (kern, plain, nbytes, nops, shape) in work.items():
        t_events, t_p = time_ms(kern), time_ms(plain)
        t_dev, t_host = device_ms(kern), host_ms(kern)
        # a token's rows: the host sets the pace of back-to-back calls, so
        # the card's time is the device time per launch
        t_k = t_events if name == "dequantize_int8" else t_dev
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        src, replaces = KERNEL_FILES[name]
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": None,
                      "max_abs_err": errs[name], "ms": t_k, "plain_ms": t_p,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "library_ms": None, "device_ms": t_dev,
                      "host_ms": t_host, "events_ms": t_events,
                      "shape": shape}
        log(f"  {name:18s} {shape}: kernel {t_k:.4f} ms (device {t_dev:.4f}"
            f" ms a launch, host {t_host:.4f} ms a call, back to back "
            f"{t_events:.4f} ms), plain {t_p:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.7f} ms ({rows[name]['bound_by']}, "
            f"{nbytes} bytes)")
    # no single PyTorch call dequantizes; the nearest is three calls
    t3 = time_ms(lambda: q.float().mul_(s).to(torch.bfloat16))
    log(f"  dequantize_int8 three-call q.float().mul_(s).to(bf16): "
        f"{t3:.4f} ms")
    rows["dequantize_int8"]["three_call_ms"] = t3
    del q, s, xt, k, v, bufs
    return rows


# ------------------------------------------------------ flash attention

def flash_work(B, T, H, KV, dh):
    """(FLOP, bytes) one causal self-attention needs: the two products over
    the T (T + 1) / 2 (query, key) pairs the mask keeps, and q, k, v, out
    (bf16) read or written once, lse (f32) written once."""
    flops = 4 * B * H * dh * (T * (T + 1) // 2)
    nbytes = 2 * (2 * B * T * H * dh + 2 * B * T * KV * dh) + 4 * B * H * T
    return flops, nbytes


def flash_phase(dev, path_shape) -> dict:
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {(dt, what): 0.0 for dt in fa.FLASH_TOL
             for what in ("out", "lse")}

    def check(got, want, dt, what):
        share, lse_err = fa.flash_errors(*got, *want)
        if not bool(torch.isfinite(got[0].float()).all()):
            raise AssertionError(f"{what}: not finite")
        if not (share <= fa.FLASH_TOL[dt]
                and lse_err <= fa.FLASH_LSE_TOL[dt]):
            raise AssertionError(
                f"{what}: out error {share:.3e} of |want| + row max (limit "
                f"{fa.FLASH_TOL[dt]:.3e}), lse error {lse_err:.3e} (limit "
                f"{fa.FLASH_LSE_TOL[dt]:.3e})")
        worst[dt, "out"] = max(worst[dt, "out"], share)
        worst[dt, "lse"] = max(worst[dt, "lse"], lse_err)
        return share, lse_err

    cases = [(T, dh, rep) for T in FLASH_LENGTHS for dh in fa.HEAD_DIMS
             for rep in (1, 4)]
    cases += [(T, dh, rep) for T in PADDED_LENGTHS for dh in PADDED_DIMS
              for rep in (1, 2)]
    checks = 0
    for T, dh, rep in cases:
        for mask, (causal, window, chunk) in fa.FLASH_MASKS.items():
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn((1, T, n, dh), generator=gen,
                                       device=dev).to(dt)
                           for n in (rep * 2, 2, 2))
                kw = dict(causal=causal, window=window, chunk=chunk)
                check(fa.flash_attention(q, k, v, **kw),
                      ref.flash_attention_ref(q, k, v, **kw), dt,
                      f"flash T={T} dh={dh} rep={rep} {mask} {dt}")
                checks += 1
    torch.cuda.synchronize()
    log(f"  flash: {checks} cases within tolerance of the plain version; "
        "worst out error (share of |want| + row max) / lse error: "
        + ", ".join(
            f"{str(dt)[6:]} {worst[dt, 'out']:.2e} / {worst[dt, 'lse']:.2e} "
            f"(limits {fa.FLASH_TOL[dt]:.1e} / {fa.FLASH_LSE_TOL[dt]:.1e})"
            for dt in fa.FLASH_TOL))
    B, T, H, dh = path_shape
    q, k, v = (torch.randn(path_shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_attention(q, k, v)
    want, wlse = ref.flash_attention_ref(q, k, v)
    err = max_abs_err(out, want)
    share, lse_err = check((out, lse), (want, wlse), torch.bfloat16,
                           f"flash at {list(path_shape)}")
    del out, lse, want, wlse
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # in turns: kernel, SDPA, kernel
    t_k1 = time_ms(lambda: fa.flash_attention(q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    t_k2 = time_ms(lambda: fa.flash_attention(q, k, v))
    t_k = (t_k1 + t_k2) / 2
    t_p = time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=5)
    ptxas = _build.ptxas_info("flash_attention", "flash_fwd_wgmma")
    for line in ptxas:
        log(f"  ptxas: {line}")
    flops, nbytes = flash_work(B, T, H, H, dh)
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out, lse = fa.flash_attention(q, k, v)
    dout = torch.randn(path_shape, generator=gen, device=dev).to(q.dtype)
    t_b = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse,
                                                      dout), reps=3)
    src, replaces = KERNEL_FILES["flash_attention"]
    row = {"name": "flash_attention", "route": "cuda", "source": src,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "ms": t_k, "plain_ms": t_p, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": t_l, "shape": list(path_shape), "flops": flops,
           "bytes": nbytes, "tflops_per_s": flops / t_k / 1e9,
           "err_share": share, "lse_err": lse_err, "plain_backward_ms": t_b,
           "kernel_ms_in_turns": [t_k1, t_k2], "ptxas": ptxas}
    log(f"  flash_attention {list(path_shape)} bf16 causal: kernel {t_k:.4f}"
        f" ms (in turns {t_k1:.4f}, SDPA {t_l:.4f}, {t_k2:.4f}; "
        f"{row['tflops_per_s']:.1f} TFLOP/s), plain {t_p:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.4e} FLOP, "
        f"{nbytes} bytes), SDPA {t_l:.4f} ms; out error {share:.2e} of "
        f"|want| + row max, lse error {lse_err:.2e}; plain backward "
        f"{t_b:.3f} ms")
    del q, k, v, qt, kt, vt, out, lse, dout
    return row


# ---------------------------------------------------- the training path

def flash_calls(cfg) -> int:
    """Flash launches per microbatch: one per attention layer in the
    forward, and one more in the backward's recompute under remat."""
    return cfg.n_layers * (2 if cfg.remat else 1)


def train_args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**{**TRAIN, "reduced": False, "device": "cuda",
                                 **kw})


def close_rel(got, want, tol: float, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{what}: {got.tolist()} vs {want.tolist()}, "
                             f"relative error {err:.3e} > {tol:.3e}")
    return err


def train_phase(dev) -> dict:
    args = train_args(device=dev)
    own = get_config(args.arch)
    cfg = dataclasses.replace(own, remat_policy=TRAIN_REMAT)
    B, T, L, steps = args.global_batch, args.seq_len, cfg.n_layers, args.steps
    log(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.hdim}, vocab "
        f"{cfg.vocab_size}, remat {cfg.remat}, remat_policy "
        f"{cfg.remat_policy!r} (set explicitly; the config's own is "
        f"{own.remat_policy!r}, whose saved products do not fit batch {B} "
        f"on an 80 GB card); batch {B} x seq {T}, accum {args.accum}, "
        f"{steps} steps, lr {args.lr}")
    # the batches on the card are the CPU's, bit for bit
    dcfg = DataConfig(cfg.vocab_size, T, B, args.seed)
    card_ds, host_ds = SyntheticLM(dcfg, dev), SyntheticLM(dcfg, "cpu")
    for i in range(steps):
        a, b = card_ds.batch_at(i), host_ds.batch_at(i)
        for name in ("tokens", "labels"):
            if not torch.equal(a[name].cpu(), b[name]):
                raise AssertionError(f"step {i} {name}: card batch differs "
                                     "from the CPU's")
    log(f"  data: {steps} batches on the card bitwise equal to the CPU's")
    del card_ds, host_ds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    # the seeded weights, drawn on the card as train_loop draws them
    params, init_s = wall(lambda: tf.init_params(cfg, args.seed, dev))
    embed_ulp = embed_vs_cpu(params["embed"], cfg, args.seed)
    log(f"  full-width {cfg.name} weights drawn on the card in {init_s:.3f} s"
        f" ({sum(t.numel() for t in _leaves(params))} values); the first "
        f"{INIT_CHECK} of the embedding within {embed_ulp} ulp of the CPU's "
        f"(limit {INIT_ULP})")
    run = train.train_loop(args, params, cfg)
    del params
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    want = flash_calls(cfg) * args.accum * steps
    if launches["flash_attention"] != want:
        raise AssertionError(f"training launched the flash kernel "
                             f"{launches['flash_attention']} times, want "
                             f"{want} (forward and recompute, {L} layers, "
                             f"{args.accum} microbatches, {steps} steps)")
    for k in WRAPPERS:
        if k != "flash_attention" and launches[k]:
            raise AssertionError(f"training launched {k}: {launches}")
    met = np.array(run.metrics)
    n_all = sum(t.numel() for t in _leaves(run.params))
    secs = run.step_seconds
    steady = float(np.median(secs[1:]))
    # matmul FLOP of a step: 6 per parameter per token (forward, backward)
    # plus 2 more for the full remat's recompute, the attention products
    # (forward, recompute and 2.5x for the backward) beside them
    attn_flops, _ = flash_work(B, T, cfg.n_heads, cfg.n_kv_heads, cfg.hdim)
    model_flops = 8 * n_all * B * T + L * attn_flops * (2 + 2.5)
    res = {"params": n_all, "init_seconds": init_s,
           "remat_policy": cfg.remat_policy,
           "init_embed_ulp_vs_cpu": embed_ulp,
           "launches": launches, "max_memory_bytes": peak,
           "losses": met[:, 0].tolist(), "grad_norms": met[:, 3].tolist(),
           "step_seconds": secs, "median_step_s": steady,
           "tokens_per_step": B * T,
           "tokens_per_s": B * T * steps / sum(secs),
           "steady_tokens_per_s": B * T / steady,
           "model_flops_per_step": model_flops,
           "model_flop_share_of_bf16_peak":
               model_flops / steady / BF16_TC_OPS_PER_S}
    if not np.isfinite(met).all():
        raise AssertionError(f"training metrics not finite: {met.tolist()}")
    log(f"  train: losses {res['losses']}, grad norms {res['grad_norms']}, "
        f"step seconds {secs}, median {steady:.3f} s, "
        f"{res['steady_tokens_per_s']:.1f} tok/s steady, peak memory "
        f"{peak / 1e9:.2f} GB, flash launches {launches['flash_attention']}"
        f" (want {want}); {n_all} params")
    # one step traced, on the trained params with a fresh optimizer state
    optimizer = train.build_optimizer(get_arch(args.arch), args.lr,
                                      args.steps)
    step = step_fns.make_train_step(cfg, optimizer=optimizer,
                                    accum=args.accum)
    opt_state = optimizer.init(run.params)
    batch = SyntheticLM(dcfg, dev).batch_at(0)
    res["trace"] = trace = device_breakdown(
        lambda: step(run.params, opt_state, batch), top=12)
    res["idle_share_untraced"] = max(0.0, 1 - trace["device_busy_ms"]
                                     / (steady * 1e3))
    log(f"  train step traced: {json.dumps(trace)}")
    del run, step, opt_state, batch
    torch.cuda.empty_cache()
    # the same steps from the same params with the plain flash forward
    with plain_flash():
        plain = train.train_loop(args, cfg=cfg)
    pm = np.array(plain.metrics)
    del plain
    torch.cuda.empty_cache()
    res["plain"] = {"losses": pm[:, 0].tolist(),
                    "grad_norms": pm[:, 3].tolist()}
    res["loss_err"] = close_rel(met[:, 0], pm[:, 0], TRAIN_TOL["loss"],
                                "losses, kernel vs plain flash")
    res["grad_norm_err"] = close_rel(met[:, 3], pm[:, 3],
                                     TRAIN_TOL["grad_norm"],
                                     "grad norms, kernel vs plain flash")
    log(f"  train, kernel vs plain flash: losses {res['plain']['losses']}, "
        f"grad norms {res['plain']['grad_norms']}; relative error "
        f"{res['loss_err']:.2e} / {res['grad_norm_err']:.2e} (limits "
        f"{TRAIN_TOL['loss']:.2e} / {TRAIN_TOL['grad_norm']:.2e})")
    res["reduced_vs_cpu"] = train_reduced_check(dev)
    return res


INIT_CHECK = 1 << 20     # elements of the full-width embedding checked


def ulp_gap(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in f32 ulp between two f32 tensors."""
    a, b = (x.detach().to("cpu", torch.float32).contiguous().view(
        torch.int32).long() for x in (got, want))
    a, b = (torch.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (a, b))
    return int((a - b).abs().max()) if a.numel() else 0


def embed_vs_cpu(embed: torch.Tensor, cfg, seed: int) -> int:
    """The first ``INIT_CHECK`` values of the card's embedding against the
    CPU's draw of them (``init_params``' key 0 of ``split(key, 6)``, scale
    0.02): the largest ulp gap, which must be within ``INIT_ULP``."""
    key = threefry.split(threefry.prng_key(seed), 6)[0]
    want = threefry.normal(key, (cfg.vocab_size, cfg.d_model), 0,
                           INIT_CHECK, "cpu") * torch.tensor(
        0.02, dtype=torch.float32)
    got = embed.reshape(-1)[:INIT_CHECK]
    gap = ulp_gap(got.float(), want.to(embed.dtype).float())
    if gap > INIT_ULP:
        raise AssertionError(f"full-width embedding: card and CPU draws "
                             f"{gap} ulp apart (limit {INIT_ULP})")
    return gap


def weights_vs_cpu(cfg, seed: int, dev) -> int:
    """``init_params(cfg, seed)`` on the card against the CPU, every leaf:
    the largest ulp gap, which must be within ``INIT_ULP``."""
    card, host = tf.init_params(cfg, seed, dev), tf.init_params(cfg, seed,
                                                                "cpu")
    gap = max(ulp_gap(a.float(), b.float())
              for a, b in zip(_leaves(card), _leaves(host)))
    if gap > INIT_ULP:
        raise AssertionError(f"reduced {cfg.name} weights: card and CPU "
                             f"draws {gap} ulp apart (limit {INIT_ULP})")
    return gap


def train_reduced_check(dev) -> dict:
    """Reduced MiniCPM-2B at its own head_dim (12; the wrapper zero-pads it
    to the kernel's 64), T = 1088: its seeded weights drawn on the card
    against the CPU's, every leaf within ``INIT_ULP``; then trained 5 steps
    on the card (flash kernel) and on the CPU (the plain version, which the
    CPU tests hold against the JAX package) from the same params: losses
    within 2**-8 relative."""
    cfg = get_config(TRAIN["arch"], reduced=True)
    kw = dict(reduced=True, seq_len=1088, global_batch=2, steps=5, lr=1e-3)
    init_gap = weights_vs_cpu(cfg, 0, dev)
    log(f"  reduced {cfg.name} weights, card vs CPU: every leaf within "
        f"{init_gap} ulp (limit {INIT_ULP})")
    cpu = tf.init_params(cfg, 0, "cpu")
    zero_counters()
    card = train.train_loop(train_args(**kw, device=dev), _to(cpu, dev), cfg)
    got = counters()["flash_attention"]
    if got != flash_calls(cfg) * kw["steps"]:
        raise AssertionError(f"the reduced run launched the flash kernel "
                             f"{got} times, want "
                             f"{flash_calls(cfg) * kw['steps']}")
    host = train.train_loop(train_args(**kw, device="cpu"), cpu, cfg)
    a = np.array([loss for _, loss in card.history])
    b = np.array([loss for _, loss in host.history])
    err = close_rel(a, b, REDUCED_TOL, "reduced training, card vs CPU")
    log(f"  reduced {cfg.name} (head_dim {cfg.hdim}) at T=1088, card vs "
        f"CPU: losses {a.tolist()} vs {b.tolist()}, relative error "
        f"{err:.2e} (limit {REDUCED_TOL:.2e})")
    return {"card": a.tolist(), "cpu": b.tolist(), "max_rel_err": err,
            "head_dim": cfg.hdim, "init_ulp_vs_cpu": init_gap}


# ------------------------------------- checkpoints, restarts and "dots"

@contextlib.contextmanager
def recording_checkpoints(keep_step: int):
    """Record each checkpoint's host snapshot and write (seconds, bytes) and
    each restore (seconds), keep the host copy written as step
    ``keep_step``, and hold every restored tree bitwise against it on the
    spot, before training updates it in place."""
    rec = {"snapshots": [], "writes": [], "restores": [], "kept": None}
    save, restore = checkpointing.save, checkpointing.restore
    save_async = checkpointing.CheckpointManager.save_async

    def save_async_rec(self, step, tree, extra=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_async(self, step, tree, extra)
        rec["snapshots"].append({"step": step,
                                 "seconds": time.perf_counter() - t0})

    def save_rec(ckpt_dir, step, tree, extra=None, host=0):
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, extra, host)
        rec["writes"].append({"step": step,
                              "seconds": time.perf_counter() - t0,
                              "bytes": os.path.getsize(os.path.join(
                                  path, f"host_{host}.npz"))})
        if step == keep_step:
            rec["kept"] = tree
        return path

    def restore_rec(ckpt_dir, like, step=None, host=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, extra, got = restore(ckpt_dir, like, step, host)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if got != keep_step or rec["kept"] is None:
            raise AssertionError(f"restored step {got}, want {keep_step}")
        leaves, likes = tree_leaves(tree), tree_leaves(like)
        want = tree_leaves(rec["kept"])
        if not len(leaves) == len(likes) == len(want):
            raise AssertionError("restored tree differs in its leaves")
        for i, (a, b, w) in enumerate(zip(leaves, likes, want)):
            if a.device != b.device or a.dtype != b.dtype:
                raise AssertionError(f"restored leaf {i}: {a.dtype} on "
                                     f"{a.device}, want {b.dtype} on "
                                     f"{b.device}")
            check_bitwise(a.cpu(), w, f"restored leaf {i}")
        rec["restores"].append({"step": got, "seconds": secs,
                                "leaves": len(leaves), "bitwise": True})
        return tree, extra, got

    checkpointing.save, checkpointing.restore = save_rec, restore_rec
    checkpointing.CheckpointManager.save_async = save_async_rec
    try:
        yield rec
    finally:
        checkpointing.save, checkpointing.restore = save, restore
        checkpointing.CheckpointManager.save_async = save_async


def ckpt_phase(dev, phase7_peak: int) -> dict:
    """Phase 8: MiniCPM-2B at full width cut to ``CKPT["layers"]`` layers,
    at phase 7's seq and batch (so the flash kernel carries attention),
    under the config's own ``"dots"`` remat: ``CKPT["steps"]`` steps in one
    run, then the same steps with a checkpoint every ``ckpt_every`` and a
    failure injected after step ``fail_at``, under ``run_with_restarts``.
    Then ``"dots"`` against ``"full"`` at all 40 layers (``DOTS``)."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=CKPT["layers"])
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_phase_", dir=build)
    try:
        res = ckpt_runs(dev, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise AssertionError(f"{root} was not removed")
    res["dots_vs_full"] = dots_vs_full(dev, phase7_peak)
    return res


def ckpt_runs(dev, cfg, root: str) -> dict:
    steps, every, fail_at = CKPT["steps"], CKPT["ckpt_every"], CKPT["fail_at"]
    B, T, L = TRAIN["global_batch"], TRAIN["seq_len"], cfg.n_layers
    log(f"  {cfg.name} cut to {L} layers (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}, head_dim {cfg.hdim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), remat_policy {cfg.remat_policy!r}; batch {B} x "
        f"seq {T}, {steps} steps, a checkpoint every {every}, a failure "
        f"after step {fail_at}; under {root}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counters()
    run = train.train_loop(train_args(steps=steps, device=dev), cfg=cfg)
    got = counters()["flash_attention"]
    if got != flash_calls(cfg) * steps:
        raise AssertionError(f"the uninterrupted run launched the flash "
                             f"kernel {got} times, want "
                             f"{flash_calls(cfg) * steps}")
    ref_losses = [m[0] for m in run.metrics]
    n_params = sum(t.numel() for t in _leaves(run.params))
    state_bytes = 3 * 4 * n_params          # f32 params and two moments
    del run
    torch.cuda.synchronize()
    free = shutil.disk_usage(root).free
    need = 3 * state_bytes + (1 << 30)      # two kept, one staging
    log(f"  uninterrupted: losses {ref_losses}; {n_params} params, "
        f"{state_bytes / 1e9:.2f} GB a checkpoint, {free / 1e9:.1f} GB free "
        f"on disk (need {need / 1e9:.1f})")
    if free < need:
        raise AssertionError(f"{free} bytes free under {root}, the "
                             f"checkpoints need {need}")
    keep = max(i + 1 for i in range(1, fail_at) if i % every == 0)
    args = train_args(steps=steps, device=dev, ckpt_every=every,
                      ckpt_dir=os.path.join(root, "ck"))
    mem, attempts = {}, []

    def loop(attempt):
        torch.cuda.synchronize()
        mem[attempt] = torch.cuda.memory_allocated()
        attempts.append(attempt)
        return train.train_loop(args, cfg=cfg,
                                fail_at=fail_at if attempt == 0 else None)

    zero_counters()
    with recording_checkpoints(keep) as rec:
        out, secs = wall(lambda: fault_tolerance.run_with_restarts(
            loop, max_restarts=1))
    launches = counters()["flash_attention"]
    want = flash_calls(cfg) * (fail_at + 1 + steps - keep)
    if launches != want:
        raise AssertionError(f"the interrupted run launched the flash "
                             f"kernel {launches} times, want {want}")
    if out.restarts != 1 or attempts != [0, 1] or out.start != keep:
        raise AssertionError(f"restarts {out.restarts}, attempts {attempts},"
                             f" resumed from {out.start}: want 1, [0, 1], "
                             f"{keep}")
    if len(rec["restores"]) != 1:
        raise AssertionError(f"{len(rec['restores'])} restores, want 1")
    if mem[1] != mem[0]:
        raise AssertionError(f"device memory {mem[1]} bytes at the restart "
                             f"against {mem[0]} before the failed attempt")
    resumed = np.array([m[0] for m in out.metrics])
    gaps = np.abs(resumed - np.array(ref_losses[keep:]))
    if not (np.isfinite(resumed).all() and gaps.max() <= RESUME_TOL):
        raise AssertionError(f"losses after the resume {resumed.tolist()} "
                             f"against {ref_losses[keep:]}: gap "
                             f"{gaps.max():.3e} > {RESUME_TOL:.1e}")
    rec.pop("kept")
    res = {"layers": L, "params": n_params, "checkpoint_bytes": state_bytes,
           "uninterrupted_losses": ref_losses, "restarts": out.restarts,
           "resumed_from": out.start, "resumed_losses": resumed.tolist(),
           "max_loss_gap": float(gaps.max()),
           "memory_before_attempts": [mem[0], mem[1]],
           "flash_launches": launches, "seconds": secs, **rec}
    log(f"  interrupted: failed after step {fail_at}, restarts "
        f"{out.restarts}, resumed from step {out.start}, restored state "
        f"bitwise equal to the saved ({rec['restores'][0]['leaves']} "
        f"leaves); losses after the resume {resumed.tolist()}, largest gap "
        f"{gaps.max():.3e} to the uninterrupted run (limit {RESUME_TOL:.0e};"
        f" zero: {bool(gaps.max() == 0)}); device memory at each attempt's "
        f"start {mem[0]} / {mem[1]} bytes; flash launches {launches} (want "
        f"{want}); {secs:.1f} s in all")
    log("  checkpoint seconds: snapshots " + ", ".join(
        f"step {r['step']} {r['seconds']:.3f}" for r in rec["snapshots"])
        + "; writes " + ", ".join(
        f"step {r['step']} {r['seconds']:.3f} ({r['bytes'] / 1e9:.2f} GB)"
        for r in rec["writes"]) + f"; restore step {keep} "
        f"{rec['restores'][0]['seconds']:.3f}")
    return res


def dots_vs_full(dev, phase7_peak: int) -> dict:
    """``"dots"`` against ``"full"`` at full width and depth, at ``DOTS``'s
    batch, in turns (full, dots, dots, full): peak memory, median step,
    and the same losses and grad norms within ``TRAIN_TOL``; and the peak
    ``"dots"`` would reach at phase 7's batch, from its activations' share
    scaled by the batch."""
    args = train_args(device=dev, **DOTS)
    own = get_config(TRAIN["arch"])
    got = {"full": [], "dots": []}
    for policy in ("full", "dots", "dots", "full"):
        cfg = dataclasses.replace(own, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        run = train.train_loop(args, cfg=cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n = counters()["flash_attention"]
        if n != flash_calls(cfg) * args.steps:
            raise AssertionError(f"{policy}: {n} flash launches, want "
                                 f"{flash_calls(cfg) * args.steps}")
        met = np.array(run.metrics)
        got[policy].append({"peak_bytes": peak,
                            "step_seconds": run.step_seconds,
                            "median_step_s": float(np.median(
                                run.step_seconds[1:])),
                            "losses": met[:, 0].tolist(),
                            "grad_norms": met[:, 3].tolist()})
        del run
    full, dots = got["full"][0], got["dots"][0]
    loss_err = close_rel(dots["losses"], full["losses"], TRAIN_TOL["loss"],
                         "dots vs full losses")
    gn_err = close_rel(dots["grad_norms"], full["grad_norms"],
                       TRAIN_TOL["grad_norm"], "dots vs full grad norms")
    scale = TRAIN["global_batch"] / args.global_batch
    extra = (dots["peak_bytes"] - full["peak_bytes"]) * scale
    card = torch.cuda.get_device_properties(0).total_memory
    res = {"batch": args.global_batch, "runs": got, "loss_err": loss_err,
           "grad_norm_err": gn_err,
           "dots_peak_at_train_batch_predicted": phase7_peak + extra,
           "card_bytes": card}
    for policy, runs in got.items():
        log(f"  {policy} at batch {args.global_batch}: peak "
            f"{[round(r['peak_bytes'] / 1e9, 2) for r in runs]} GB, median "
            f"step {[round(r['median_step_s'], 4) for r in runs]} s, losses "
            f"{runs[0]['losses']}")
    log(f"  dots vs full: loss error {loss_err:.2e}, grad norm error "
        f"{gn_err:.2e} (limits {TRAIN_TOL['loss']:.1e} / "
        f"{TRAIN_TOL['grad_norm']:.1e}); dots at batch "
        f"{TRAIN['global_batch']} would peak at about "
        f"{(phase7_peak + extra) / 1e9:.1f} GB (phase 7's full "
        f"{phase7_peak / 1e9:.2f} GB plus the products it keeps, scaled "
        f"from batch {args.global_batch}), of {card / 1e9:.1f} GB")
    return res


# ------------------------------------------------------- the decode path

def serve_args(**kw) -> argparse.Namespace:
    return argparse.Namespace(**{**DECODE, "reduced": False,
                                 "device": "cuda", **kw})


def decode_phase(dev) -> dict:
    cfg = decode_config(get_config(DECODE["arch"]))
    if not cfg.kv_quant:
        raise AssertionError("MiniCPM-2B's decode config has no int8 cache")
    args = serve_args()
    B, S, steps, L = args.batch, args.cache_len, args.steps, cfg.n_layers
    ring_bytes = 2 * L * B * S * cfg.n_kv_heads * cfg.hdim
    log(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}; batch {B}, "
        f"ring {S}, {steps} steps; int8 ring {ring_bytes / 1e9:.2f} GB")
    params = tf.init_params(cfg, args.seed, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    run = serve.serve_loop(args, cfg, params, keep_logits=True)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    want = (L * steps, 0, 2 * L * steps)
    if (launches["quantize_int8_into"], launches["quantize_int8"],
            launches["dequantize_int8"]) != want:
        raise AssertionError(f"decode launches {launches}: want {want[0]} "
                             "fused K/V writes (every layer, every step), "
                             f"no separate quantize and {want[2]} "
                             "dequantizes (K and V)")
    logits = run.logits
    if logits.shape != (steps, B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"decode logits {tuple(logits.shape)}: not "
                             "finite or of the wrong shape")
    with plain_int8():
        plain = serve.serve_loop(args, cfg, params, keep_logits=True)
    if not np.array_equal(run.tokens, plain.tokens):
        raise AssertionError("decode tokens differ from the plain int8 run")
    check_bitwise(logits, plain.logits, "decode logits vs the plain int8 run")
    del plain
    secs = run.step_seconds
    steady = float(np.median(secs[1:]))
    res = {"params": n_params, "int8_ring_bytes": ring_bytes,
           "launches": launches, "max_memory_bytes": peak,
           "first_step_s": secs[0], "median_step_s": steady,
           "total_s": run.seconds,
           "tokens_per_s": B * steps / run.seconds,
           "steady_tokens_per_s": B / steady}
    log(f"  decode: {steps} steps in {run.seconds:.3f} s, first step "
        f"{secs[0]:.3f} s, median step {steady * 1e3:.2f} ms, "
        f"{res['tokens_per_s']:.1f} tok/s ({res['steady_tokens_per_s']:.1f} "
        f"steady), peak memory {peak / 1e9:.2f} GB, launches {launches}")
    log("  decode: tokens and logits bitwise equal to the plain int8 run")
    del run, logits
    # one step traced, on a fresh ring after a warm-up step
    step = step_fns.make_serve_step(cfg)
    caches = tf.init_cache(cfg, B, S, device=dev)
    inputs = {"tokens": torch.zeros((B, 1), dtype=torch.int64, device=dev)}
    step(params, inputs, caches)
    res["trace"] = trace = device_breakdown(
        lambda: step(params, inputs, caches), top=10)
    log(f"  decode step traced: {trace['device_ops']} device operations "
        f"({trace['device_ops'] / L:.2f} per layer): {json.dumps(trace)}")
    del caches, params
    torch.cuda.empty_cache()
    res["reduced_vs_cpu"] = reduced_check(dev)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def reduced_check(dev) -> dict:
    """Reduced MiniCPM-2B with the int8 cache on the card against the port
    on the CPU, the same params: logits within 6 * 2**-8 of the largest
    (the bf16 tolerance the CPU tests hold the port to against the JAX
    package), and the same greedy token wherever the CPU's top-2 margin
    exceeds twice that, over the steps whose inputs were still equal."""
    cfg = dataclasses.replace(
        decode_config(get_config(DECODE["arch"], reduced=True)),
        kv_quant=True)
    small = dict(reduced=True, batch=4, cache_len=16, steps=8)
    cpu = tf.init_params(cfg, 0, "cpu")
    zero_counters()
    card = serve.serve_loop(serve_args(**small), cfg, _to(cpu, dev),
                            keep_logits=True)
    if counters()["dequantize_int8"] == 0:
        raise AssertionError("the reduced run did not launch the kernels")
    host = serve.serve_loop(serve_args(**small, device="cpu"), cfg, cpu,
                            keep_logits=True)
    tol = 6 * 2.0 ** -8
    parted = np.nonzero((card.tokens != host.tokens).any(0))[0]
    last = int(parted[0]) if len(parted) else small["steps"] - 1
    worst, compared = 0.0, 0
    for i in range(last + 1):          # steps fed the same tokens
        a = card.logits[i].cpu().numpy()
        b = host.logits[i].numpy()
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        top2 = np.sort(b, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(b).max()
        if not np.array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear]):
            raise AssertionError(f"reduced step {i}: tokens differ at a "
                                 "clear margin")
        compared += int(clear.sum())
    if not worst <= tol:
        raise AssertionError(f"reduced card vs CPU: error {worst:.3e} of "
                             f"max|logit| > {tol:.3e}")
    log(f"  reduced {cfg.name} int8, card vs CPU: max error {worst:.2e} of "
        f"max|logit| (limit {tol:.2e}) over {last + 1} steps fed the same "
        f"tokens; {compared} clear-margin tokens equal")
    return {"max_err_share": worst, "steps_compared": last + 1,
            "tokens_compared": compared}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev, copy=True)


# ------------------------------------------------- continuous serving

def slot_write_case(gen, B, T, KV, W, S, dev):
    """A step's bf16 K and V (B, T, KV, W) and int8 rings of S slots with
    scales that already hold earlier tokens."""
    k, v = (torch.randn((B, T, KV, W), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    shape = (B, S, KV, W)
    rings = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
              for _ in range(2)]
    return k, v, (*rings, *scales)


def slot_write_shapes(dev) -> dict:
    """The fused K/V write at the continuous path's two shapes, each row at
    its own position, bitwise against its plain version and timed (device
    time per launch from the profiler, host cost per call, the plain
    version by CUDA events), beside its byte bound: each written token's
    bf16 K and V rows read once, their codes and scales written once."""
    cfg = get_config(SERVE["arch"])
    KV, W, S, B = cfg.n_kv_heads, cfg.hdim, SERVE["cache_len"], SERVE["slots"]
    gen = torch.Generator(device=dev).manual_seed(9)
    # a decode tick: rows at 0, 8191 and past the ring (a wrap), four
    # inactive rows, the rest spread over the ring
    pos = [0, S - 1, S + 5, 3 * S // 4] + [int(p) for p in torch.randint(
        0, 2 * S, (B - 4,), generator=torch.Generator().manual_seed(3))]
    n = [1, 1, 1, 0] + [0, 0, 0] + [1] * (B - 7)
    # a prefill chunk: 1024 tokens at 7680, 700 of them real, so the
    # write wraps from slot 8191 to slot 0
    T = SERVE["prefill_chunk"]
    cases = {"decode": ((B, 1), pos, n),
             "prefill": ((1, T), [S - S // 16], [T * 700 // 1024])}
    out, errs = {}, 0.0
    for what, ((rows, T), p, c) in cases.items():
        k, v, bufs = slot_write_case(gen, rows, T, KV, W, S, dev)
        got = [t.clone() for t in bufs]
        want = [t.clone() for t in bufs]
        quantize.quantize_int8_into(k, v, *got, p, c)
        ref.quantize_int8_into_ref(k, v, *want, p, c)
        for g, w, name in zip(got, want, ("K ring", "V ring", "K scales",
                                          "V scales")):
            check_bitwise(g, w, f"quantize_int8_into {what} {name} "
                          f"{list(g.shape)}")
            errs = max(errs, max_abs_err(g.float(), w.float()))
        del got, want
        tokens = sum(c)
        nbytes = 2 * tokens * KV * (2 * W + W + 4)
        nops = 2 * 4 * tokens * KV * W
        t_dev = device_ms(lambda: quantize.quantize_int8_into(
            k, v, *bufs, p, c))
        t_host = host_ms(lambda: quantize.quantize_int8_into(
            k, v, *bufs, p, c))
        t_plain = time_ms(lambda: ref.quantize_int8_into_ref(
            k, v, *bufs, p, c), reps=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        out[what] = {"shape": [list(k.shape), list(bufs[0].shape)],
                     "tokens_written": tokens, "device_ms": t_dev,
                     "host_ms": t_host, "plain_ms": t_plain,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes}
        log(f"  quantize_int8_into {what} {out[what]['shape']}, "
            f"{tokens} tokens written: device {t_dev:.4f} ms a launch, host "
            f"{t_host:.4f} ms a call, plain {t_plain:.4f} ms, bound "
            f"{out[what]['bound_ms']:.7f} ms ({out[what]['bound_by']}, "
            f"{nbytes} bytes)")
        del k, v, bufs
    out["max_abs_err"] = errs
    return out


@contextlib.contextmanager
def timed_steps(engine, times: dict):
    """Time each of the engine's prefill and decode calls on the host
    clock, the card synchronized before and after."""
    saved = engine._prefill, engine._decode

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return call

    engine._prefill = timed(saved[0], "prefill")
    engine._decode = timed(saved[1], "decode")
    try:
        yield
    finally:
        engine._prefill, engine._decode = saved


def workload(vocab: int, sampling=None) -> list:
    return serve.synthetic_workload(
        SERVE["requests"], vocab, gap=SERVE["gap"], seed=SERVE["seed"] + 1,
        prompt_lens=SERVE["prompt_lens"], max_new=SERVE["max_new"],
        sampling=sampling)


def continuous_phase(dev) -> dict:
    cfg = decode_config(get_config(SERVE["arch"]))
    if not cfg.kv_quant:
        raise AssertionError("MiniCPM-2B's decode config has no int8 cache")
    res = {"slot_write": slot_write_shapes(dev)}
    torch.cuda.empty_cache()
    L = cfg.n_layers
    log(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}; "
        f"{SERVE['slots']} slots, ring {SERVE['cache_len']}, prefill chunk "
        f"{SERVE['prefill_chunk']}; {SERVE['requests']} requests a tick "
        f"apart, prompts {SERVE['prompt_lens']}, new tokens "
        f"{SERVE['max_new']}")
    params = tf.init_params(cfg, SERVE["seed"], dev)
    engine = ServingEngine(cfg, None, params, n_slots=SERVE["slots"],
                           max_len=SERVE["cache_len"],
                           prefill_chunk=SERVE["prefill_chunk"], device=dev)
    reqs = workload(cfg.vocab_size)
    times = {"prefill": [], "decode": []}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    greedy = engine.run(reqs)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    calls = L * (greedy["decode_ticks"] + greedy["prefill_chunks"])
    want = {"quantize_int8_into": calls, "dequantize_int8": 2 * calls,
            "quantize_int8": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"continuous launches {launches}: want {want} "
                             f"({greedy['decode_ticks']} decode ticks and "
                             f"{greedy['prefill_chunks']} prefill chunks, "
                             f"{L} layers)")
    short = [r.rid for r in reqs if len(r.tokens) != r.max_new_tokens]
    if greedy["requests"] != len(reqs) or short:
        raise AssertionError(f"requests {short} did not end with their "
                             "max_new_tokens")
    log(f"  greedy: {greedy['ticks']} ticks ({greedy['decode_ticks']} "
        f"decode, {greedy['prefill_chunks']} prefill chunks), "
        f"{greedy['total_tokens']} tokens in {greedy['wall_s']:.3f} s, "
        f"{greedy['tok_s']:.1f} tok/s; TTFT p50/p95 "
        f"{greedy['ttft_ticks_p50']}/{greedy['ttft_ticks_p95']} ticks, "
        f"latency p50/p95 {greedy['latency_ticks_p50']}/"
        f"{greedy['latency_ticks_p95']} ticks; peak memory "
        f"{peak / 1e9:.2f} GB; launches {launches}")
    with plain_int8():
        plain = engine.run(workload(cfg.vocab_size))
    if plain["tokens"] != greedy["tokens"]:
        raise AssertionError("continuous streams differ from the plain "
                             "int8 run")
    static = engine.run(workload(cfg.vocab_size), static=True)
    if static["tokens"] != greedy["tokens"]:
        raise AssertionError("continuous streams differ from the static "
                             "policy's")
    log(f"  greedy streams bitwise those of the plain int8 run and of the "
        f"static policy ({static['ticks']} ticks, {static['wall_s']:.3f} s,"
        f" TTFT p50 {static['ttft_ticks_p50']} ticks)")
    # the second sampled run also times each prefill and decode call, with
    # a sync around each, so that the greedy run's wall has none
    sampled = [engine.run(workload(cfg.vocab_size, SAMPLED))]
    with timed_steps(engine, times):
        sampled.append(engine.run(workload(cfg.vocab_size, SAMPLED)))
    if sampled[0]["tokens"] != sampled[1]["tokens"]:
        raise AssertionError("the two sampled runs differ")
    if sampled[0]["sampled_tokens"] != sampled[0]["total_tokens"]:
        raise AssertionError(f"sampled run: {sampled[0]['sampled_tokens']} "
                             f"of {sampled[0]['total_tokens']} sampled")
    log(f"  sampled ({SAMPLED}): two runs equal, "
        f"{sampled[0]['total_tokens']} tokens in "
        f"{sampled[0]['wall_s']:.3f} / {sampled[1]['wall_s']:.3f} s (the "
        f"second timed call by call); median decode tick "
        f"{np.median(times['decode']) * 1e3:.2f} ms, median prefill chunk "
        f"{np.median(times['prefill']) * 1e3:.2f} ms (host clock, card "
        f"synchronized around each)")
    # the per-tick stats rows, as p replicas' sums, reduced on the card:
    # p = 4, where the alpha-beta switch picks the ring for 64 bytes, and
    # p = 8, where it picks the dual-root tree (combine3 on the card)
    rows = np.array([[getattr(s, f) for f in STATS_FIELDS]
                     for s in greedy["steps"]], np.float32)
    reduce_launches = {}
    for p in (4, 8):
        replicas = np.stack([part.sum(0)
                             for part in np.array_split(rows, p)])
        zero_counters()
        summed = make_stats_reducer(LocalTransport(p, dev))(replicas)
        reduce_launches[p] = counters()["combine3"]
        if not np.array_equal(summed, rows.sum(0)):
            raise AssertionError(f"stats reduction at p={p}: {summed} != "
                                 f"numpy {rows.sum(0)}")
    log(f"  stats of {len(rows)} ticks reduced over 4 and 8 replicas on the "
        f"card (b = 1; combine3 launches {reduce_launches}): equal to the "
        "numpy sum")
    # one prefill chunk of 1024 tokens into a fresh slot, traced
    session = engine.start()
    chunk = torch.randint(1, cfg.vocab_size, (1, SERVE["prefill_chunk"]),
                          device=dev)
    engine._prefill(params, chunk, session.caches, 0, chunk.shape[1])
    trace = device_breakdown(lambda: engine._prefill(
        params, chunk, session.caches, 0, chunk.shape[1]), top=10)
    log(f"  prefill chunk traced: {json.dumps(trace)}")
    del engine, params, session
    torch.cuda.empty_cache()
    res.update({
        "launches": launches, "max_memory_bytes": peak,
        "ticks": greedy["ticks"], "decode_ticks": greedy["decode_ticks"],
        "prefill_chunks": greedy["prefill_chunks"],
        "total_tokens": greedy["total_tokens"], "wall_s": greedy["wall_s"],
        "tokens_per_s": greedy["tok_s"],
        "ttft_ticks_p50": greedy["ttft_ticks_p50"],
        "ttft_ticks_p95": greedy["ttft_ticks_p95"],
        "latency_ticks_p50": greedy["latency_ticks_p50"],
        "latency_ticks_p95": greedy["latency_ticks_p95"],
        "median_decode_tick_s": float(np.median(times["decode"])),
        "median_prefill_chunk_s": float(np.median(times["prefill"])),
        "plain_wall_s": plain["wall_s"], "static": {
            "ticks": static["ticks"], "wall_s": static["wall_s"],
            "ttft_ticks_p50": static["ttft_ticks_p50"]},
        "sampled_wall_s": [r["wall_s"] for r in sampled],
        "stats_reduce_combine3_launches": reduce_launches,
        "prefill_chunk_trace": trace})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")

    nb = cost_model.optimal_blocks(P_FULL, float(M_FULL * 4),
                                   cost_model.PAPER_HYDRA, "dptree")
    blk = -(-M_FULL // nb)
    wire = (P_FULL, M_FULL // 8)        # hier's slow-stage stripe, per rank
    log("phase 1: kernels")
    rows = kernel_phase(dev, P_FULL * blk, (P_FULL, blk), wire)
    log("phase 2: collectives, every method")
    small_phase(dev)
    log("phase 3: the collective main path at the paper's scale")
    full = full_phase(dev)
    torch.cuda.empty_cache()
    main_launches = {k: full["dptree_f32"]["launches"][k]
                     + full["hier_bf16"]["launches"][k]
                     + full["dptree_i32"]["launches"][k] for k in WRAPPERS}
    log("main path: " + json.dumps(full))

    mcfg = get_config(DECODE["arch"])
    token_rows = DECODE["batch"] * mcfg.n_kv_heads
    ring_rows = token_rows * DECODE["cache_len"]
    log("phase 4: the int8 K/V kernels")
    rows.update(int8_phase(dev, token_rows, ring_rows, mcfg.hdim,
                           mcfg.n_kv_heads, DECODE["cache_len"]))
    log("phase 5: the serving main path, MiniCPM-2B at full width")
    decode = decode_phase(dev)
    for name in ("quantize_int8", "quantize_int8_into", "dequantize_int8"):
        main_launches[name] = decode["launches"][name]
    log("decode path: " + json.dumps(decode))
    tcfg = get_config(TRAIN["arch"])
    log("phase 6: the flash-attention kernel")
    rows["flash_attention"] = flash_phase(
        dev, (TRAIN["global_batch"] // TRAIN["accum"], TRAIN["seq_len"],
              tcfg.n_heads, tcfg.hdim))
    log("phase 7: the training main path, MiniCPM-2B at full width")
    training = train_phase(dev)
    main_launches["flash_attention"] = \
        training["launches"]["flash_attention"]
    log("training path: " + json.dumps(training))
    log("phase 8: training with checkpoints and a restart, and the dots "
        "remat, MiniCPM-2B at full width")
    ckpt = ckpt_phase(dev, training["max_memory_bytes"])
    log("checkpoint path: " + json.dumps(ckpt))
    log("phase 9: continuous serving, MiniCPM-2B at full width")
    t9 = time.perf_counter()
    cont = continuous_phase(dev)
    cont["seconds"] = time.perf_counter() - t9
    write = rows["quantize_int8_into"]
    write["slot_shapes"] = cont.pop("slot_write")
    write["max_abs_err"] = max(write["max_abs_err"],
                               write["slot_shapes"]["max_abs_err"])
    for name in ("quantize_int8_into", "dequantize_int8"):
        rows[name]["launches_by_path"] = {
            "decode": main_launches[name],
            "continuous": cont["launches"][name]}
        main_launches[name] += cont["launches"][name]
    log(f"phase 9 seconds {cont['seconds']:.2f}")
    log("continuous path: " + json.dumps(cont))
    for name in ("combine3", "compress_bf16", "decompress_bf16",
                 "quantize_int8_into", "dequantize_int8",
                 "flash_attention"):
        if main_launches[name] == 0:
            raise AssertionError(f"{name} was not launched on its main path")
    for name, row in rows.items():
        row["launches"] = main_launches[name]
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
