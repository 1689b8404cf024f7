"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--only 14`` or ``--only 4,9-11`` runs those phases alone, with the
phases they need; the default is every phase). It builds the port's CUDA
kernels from ``src/repro_torch/kernels/csrc`` (one
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
   8192, 32 greedy steps, one fused K/V quantize launch and one ring
   attention per layer and step,
   its tokens and logits bitwise equal to the same run with the plain int8
   versions; the same run with the plain ring attention in place of the
   kernel, its logits within ``LOGIT_TOL`` of the largest and its tokens
   equal wherever the plain run's top-2 margin exceeds twice that, and a
   run with an off-by-one ring attention (it skips the key just written)
   that must break that limit; one step traced (device operations per
   step), and a reduced
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
   phase's seconds, and one prefill chunk traced;
10. speculation, the prefix cache and the SLO policy at full width, on
   phase 9's weights: ``ServingEngine`` with 8 slots of a 4096 ring,
   prefill chunks of 512 and a prefix trie of 16 nodes: first the slot
   attention kernel ``ring_attention`` (which replaces no TPU kernel: it
   stands where the reference's einsums do, and gives a query the same bits
   in any call) against its plain version within ``FLASH_TOL``, bitwise the
   same for a query in calls of 1, 5 and 40, and over a wrapped ring in
   calls of 1, 5, 40 and 512 at offsets (1 and 2 query heads a K/V head),
   and held and timed at a decode tick's, a verify tick's and a prefill
   chunk's shape, at phase 5's step and at phase 9's tick and chunk, beside
   its bound, its plain version and SDPA; then serving workload
   W10 (12 requests a tick apart, a shared 1024-token system prompt and a
   repetitive suffix of 64 to 448 tokens, 16 to 32 new tokens, requests 0-7
   BATCH and 8-11 INTERACTIVE with a TTFT deadline of 8 ticks): the fused
   K/V write at the verify shape (8 rows of 5 tokens, counts 0 to 5, two
   rows wrapping) bitwise against its plain version and timed beside its
   byte bound; run A (FIFO, greedy, plain); B with n-gram speculation
   (k = 4), its streams bitwise A's in no more ticks, one fused write per
   layer for every decode or verify tick and prefill chunk and two
   dequantizes for each; C with the prefix cache (at least 10 hits, fewer
   chunks than A); D under the SLO policy with speculation and the prefix
   cache (at least one preemption, the interactive requests' TTFT p50 at
   most A's); E, A and B sampled, equal; F drafting with the same widths
   cut to 2 layers (seed 7, its own 8 slots) for requests 0-3; each
   stream bitwise A's; and B again with its decode and verify calls timed
   and, on a verify tick that rejects a draft, the rejected tokens' ring
   slots bitwise their bytes before the call; each run's ticks, wall,
   tokens/s and TTFT, the peak memory and the phase's seconds;
11. the replica fleet under chaos at full width, on phase 9's weights:
   ``FleetRunner`` over 3 replicas (engine sessions) of 4 slots of a 4096
   ring, prefill chunks of 512, workload W11 (12 requests a tick apart,
   prompts of 256 to 1024 tokens, 6 to 12 new tokens, the odd ones
   sampled): the undisturbed ``engine.run``, then (a) replica 1 killed at
   tick 5, (b) replica 1 flapping for 8 ticks while replica 0 straggles at
   factor 2 for 6 (it must rejoin), (c) replica 2 poisoned at tick 6 (NaN
   in its active slots' f32 scales), (d) (b) again, (e) (a) with a
   ``Tracer`` and live metrics every 4 ticks; every run's streams bitwise
   the undisturbed run's with failovers, one fused write and one ring
   attention per layer for every decode tick and prefill chunk and two
   dequantizes for each; (a) and (b) free a dead replica's caches and (b)
   comes back to within a replica's caches of its memory after the rejoin;
   (c) is quarantined through non-finite logits out of the card's kernels
   with nothing of the poisoned tick committed; (e) writes a Chrome trace
   under ``build/`` that reads back, its failover events counting as the
   reference's test counts them; then (b)'s per-replica stats rows reduced
   over its members at p = 3, 2, 3 (``plan_remesh``) on ``LocalTransport``
   under an installed probe, each sum numpy's, and the probe's alpha-beta
   fit (of the stacked transport on one card, not of a link) or the
   fitter's refusal;
12. the MoE sublayers at full width: Mixtral-8x22B and Llama-4 Scout with
   every published width (d_model, heads, head_dim 128, d_ff per expert,
   experts, top-k, vocabulary, Mixtral's window of 4096, Scout's chunk of
   8192), depth cut to 4 layers (Scout's whole period), bf16 weights drawn
   on the card, the int8 K/V cache forced on; (a) Mixtral through
   ``serve_loop`` at phase 5's step shape (batch 16, 32 steps), its logits
   within ``LOGIT_TOL`` of the run with the plain ring attention and the
   plain int8 kernels and its tokens equal at a clear margin; then the
   same step with each row its own random prompt of 4600 tokens (past the
   window; the ring wraps) and its own tokens: every kernel call held
   against its plain version on its own inputs (the fused write and the
   dequantize bitwise, ``ring_attention`` within ``FLASH_TOL``), the tokens
   against the plain run's at a clear margin with the routing held, the
   median step and one traced step's device split with the MoE sublayers'
   share and the routing's host syncs; (b) Mixtral through ``ServingEngine`` (8
   slots, prompts of 512 to 4608 tokens in chunks of 1024, 8 to 16 new
   tokens): run A at capacity factor ``n_experts`` (no slot dropped), B
   with n-gram speculation, its streams bitwise A's, C at the config's 1.25
   with the real tokens' slots dropped per prefill chunk, and A's per-tick
   stats reduced over 8 replicas (``combine3``); (c) Scout's continuous
   engine (4 slots, prompts of 8100 to 8400 tokens sharing 4096, across
   the 8192 chunk boundary) without and with the prefix cache, the streams
   bitwise equal; in (b) and (c) a prefill chunk across the window or the
   chunk boundary, a decode tick and a verify tick over every slot, at
   the engine's shapes, each kernel call held against its plain version
   as in (a) and the tokens against the plain calls'; one fused write and
   one ring attention per layer for
   every decode or verify tick and prefill chunk, two dequantizes each;
   each part's seconds and peak memory;
13. the RWKV-6 mixer at full width and depth: RWKV-6 7B (all 32 layers,
   d_model 4096, 64 heads of 64, channel mix 14,336, vocabulary 65,536,
   untied embeddings; about 7.5 B parameters) with bf16 weights drawn on
   the card, its recurrence through the WKV kernel ``wkv6`` (which replaces
   no TPU kernel: it stands where the reference's ``lax.scan`` does); (a)
   ``serve_loop`` at batch 16 for 32 steps, each row from its own random
   token, one launch per layer and step, then again with every kernel call
   held against its plain version on its own inputs (``wkv_held``: o and
   state within ``wkv.WKV_TOL`` and ``WKV_STATE_TOL``) and with the plain
   recurrence, its tokens equal at a clear margin; (b) ``ServingEngine`` (8
   slots, chunks of 1024; 16 requests a tick apart sharing a 2048-token
   prefix, prompts of 2560 to 4608 tokens, 8 to 16 new tokens): A plain,
   B with speculation (drafts replaying A's streams with one token
   changed, so that its verify commits keep each of 1 to 5 tokens) and C
   with the prefix cache, B's and C's streams and each request's carries
   at its release bitwise A's, one launch per layer for every decode or
   verify tick and prefill chunk; then a prefill chunk, a decode tick and a verify
   call at the engine's shapes held call by call and against the plain
   recurrence; (c) a 32,768-token prompt in 32 chunks and a 512-token one,
   each alone, 16 new tokens each: the same slot bytes; one decode tick and
   one chunk traced; the kernel timed at the decode tick's, the verify
   call's and the chunk's shapes beside its bound and its plain version;
   each part's seconds;
14. the Mamba mixer at full width: Jamba-v0.1 with every published width
   (d_model 4096, 32 heads of 128 over 8 K/V heads, 16 experts of d_ff
   14,336, top-2, vocabulary 65,536, untied embeddings; Mamba d_inner
   8192, d_state 16, dt_rank 256, d_conv 4), depth cut to one period of 8
   layers (7 Mamba, 1 attention, 4 MoE, 4 MLP; about 13.3 B parameters),
   bf16 weights drawn on the card, the int8 K/V cache forced on, its
   recurrence through the selective-scan kernel ``mamba_scan`` (which
   replaces no TPU kernel: it stands where the reference's ``lax.scan``
   does); (a) ``serve_loop`` at batch 16 for 32 steps, each row from its
   own random token, one scan a Mamba layer and one ring attention, fused
   write and two dequantizes an attention layer each step, then the same
   steps with every kernel call held against its plain version on its own
   inputs (``scan_held``: y and state within ``mamba_scan.SCAN_TOL`` and
   ``SCAN_STATE_TOL``; ``kernels_held``) and with the plain scan, ring
   attention and int8, routed alike, its tokens equal at a clear margin;
   (b) ``ServingEngine`` at capacity factor 16 (8 slots, chunks of 1024;
   16 requests a tick apart sharing a 2048-token prefix, prompts of 2560
   to 4608 tokens, 8 to 16 new tokens): A plain, B with speculation
   (drafts replaying A's streams with one token changed) and C with the
   prefix cache, B's and C's streams and each request's Mamba carries at
   its release bitwise A's; then a prefill chunk, a decode tick and a
   verify call at the engine's shapes held call by call and against the
   plain kernels; (c) a 32,768-token prompt in 32 chunks and a 512-token
   one, each alone, 16 new tokens each: the same carry bytes, the ring
   holding each prompt; one decode tick and one chunk traced; the scan
   timed at the decode tick's, 14a's step's, the verify call's and the
   chunk's shapes, each under the launch ``mamba_scan.plan`` gives it,
   beside its bound and its plain version; each part's seconds.

In phases 3, 5, 7, 8, 9, 10, 11, 12, 13 and 14 the kernels' launch
counters are zeroed just before the main path and read just after, and
must show that the kernels carried it.
It prints the card's name and power limit, one JSON line of kernel numbers,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
raises before that line. Without a CUDA device it exits nonzero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
from repro_torch.kernels import mamba_scan, ring_attention, wkv  # noqa: E402
from repro_torch.launch import serve, step_fns, train  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.runtime.chaos import Fault, FaultPlan  # noqa: E402
from repro_torch.serving import (DraftModelDrafter, Drafter,  # noqa: E402
                                 EngineSession, FleetRunner, PoisonedLogits,
                                 PriorityClass, Request, SamplingParams,
                                 ServingEngine, SLOParams, SpecParams,
                                 STATS_FIELDS, make_policy,
                                 make_stats_reducer)
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
    # no TPU kernel: it stands where the reference's two XLA einsums of
    # attention_decode_slots do (layers.py:589-593)
    "ring_attention": ("src/repro_torch/kernels/csrc/ring_attention.cu",
                       "src/repro/models/layers.py:589"),
    # no TPU kernel: it stands where the reference's lax.scan of
    # wkv_recurrent does (ssm.py:112-152)
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/models/ssm.py:112"),
    # no TPU kernel: it stands where the reference's lax.scan of
    # mamba_scan_recurrent does (ssm.py:390-424)
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/models/ssm.py:390"),
}
WRAPPERS = {"combine2": block_combine.combine2,
            "combine3": block_combine.combine3,
            "compress_bf16": quantize.compress_bf16,
            "decompress_bf16": quantize.decompress_bf16,
            "quantize_int8": quantize.quantize_int8,
            "quantize_int8_into": quantize.quantize_int8_into,
            "dequantize_int8": quantize.dequantize_int8,
            "flash_attention": fa.flash_attention,
            "ring_attention": ring_attention.ring_attention,
            "wkv6": wkv.wkv6,
            "mamba_scan": mamba_scan.mamba_scan}
# phase 5: MiniCPM-2B decode, cut from the reference's decode_32k cell
# (batch 128, 32,768 cached tokens) to what one 80 GB card holds
DECODE = dict(arch="minicpm_2b", batch=16, cache_len=8192, steps=32, seed=0)
# phase 9: MiniCPM-2B continuous serving on phase 5's cache (16 slots, a
# ring of 8192), prompts of up to three 1024-token prefill chunks
SERVE = dict(arch="minicpm_2b", slots=16, cache_len=8192, prefill_chunk=1024,
             requests=24, gap=1, prompt_lens=(256, 2560), max_new=(8, 32),
             seed=0)
SAMPLED = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=0)
# phase 10: speculation, the prefix cache and the SLO policy on phase 9's
# model, cut to 8 slots of a 4096 ring (a tick dequantizes a quarter of
# phase 9's ring). W10: a shared system prompt of two 512-token chunks and
# a repetitive suffix (a cold prompt is 3 chunks, a warm one 1); requests
# 0-7 BATCH, 8-11 INTERACTIVE with a TTFT deadline, arriving while every
# slot is busy. Run F drafts with the same widths cut to 2 layers. New
# tokens are cut from 32-64 to 16-32 to keep the phase under 90 s (its
# ticks are bound by the host's launches at this size; PERF.md section 6).
SPEC = dict(slots=8, cache_len=4096, prefill_chunk=512, prefix_nodes=16,
            requests=12, gap=1, seed=1, shared_prefix=1024,
            suffix=(64, 448), max_new=(16, 32), batch=8, deadline_ticks=8,
            draft_k=4, draft_layers=2, draft_seed=7, draft_requests=4)
# phase 11: the replica fleet under chaos on phase 9's model: 3 replicas of
# 4 slots of a 4096 ring (a replica's int8 caches are 3.2 GB), chunks of
# 512; W11: 12 requests a tick apart, prompts of 256-1024 tokens, 6-12 new
# tokens (cut from 16-32 to keep the phase under 75 s: it took 74 s at
# 16-32, 83 s at 12-24 and 78 s at 8-16 on H100 hosts of varying speed,
# PERF.md section 6), the odd ones sampled as in the reference's chaos
# test (tests/test_chaos.py); a heartbeat deadline of 2 ticks, a rejoin
# probation of 1 tick, live metrics every 4 ticks in the traced run
FLEET = dict(replicas=3, slots=4, cache_len=4096, prefill_chunk=512,
             requests=12, gap=1, seed=3, prompt_lens=(256, 1024),
             max_new=(6, 12), timeout=2.0, rejoin_backoff=1.0,
             metrics_every=4)
# phase 12: the MoE sublayers at full width, Mixtral-8x22B and Llama-4
# Scout. Every published width stays (d_model, heads, head_dim, d_ff per
# expert, experts, top-k, vocabulary, window, chunk); depth is cut from 56
# and 48 layers to 4 (Scout's one whole period: 3 chunked-RoPE layers and a
# global NoPE layer), about 10.4 B parameters (20.8 GB in bf16) each, which
# one 80 GB card holds beside the caches. Fewer layers make the host's
# share of a step larger. The int8 K/V cache is forced on (the dry run's
# rule keeps it off below n_kv_heads * head_dim = 2048; both are 8 * 128),
# so the path runs the fused write and the dequantize as phase 5 does.
MOE = dict(layers=4, seed=0)
# 12a: phase 5's step shape (batch 16, a ring of 8192, which Mixtral's
# window of 4096 bounds to 4096), 32 greedy steps
MOE_DECODE = dict(arch="mixtral_8x22b", batch=16, cache_len=8192, steps=32,
                  prompt_len=4600, prefill_chunk=1024)
# 12a's second run: the same step with each row its own random prompt of
# prompt_len tokens (prefilled in chunks of prefill_chunk), so reads cross
# the window and the ring wraps
# 12b: 16 requests a tick apart into 8 slots, prompts of 512-4608 (reads
# cross the window), chunks of 1024, 8-16 new tokens; repetitive text, so
# that n-gram drafts exist
MOE_SERVE = dict(arch="mixtral_8x22b", slots=8, cache_len=4736,
                 prefill_chunk=1024, requests=16, gap=1, seed=12,
                 prompt_lens=(512, 4608), max_new=(8, 16), draft_k=4,
                 repetitive=True)
# 12b's check of the slot path against the plain kernels: the slots
# prefilled to these lengths (distinct random tokens), then row 0's next
# chunk (3584..4607, across the window's 4096), a decode tick and a verify
# tick over every slot
MOE_SLOT_CHECK = dict(seed=14, lens=(3584, 4700, 4097, 2500, 1024, 333, 64, 7),
                      across=4096)
# 12c: 4 slots, prompts of 8100-8400 (a shared 4096-token prefix and a
# suffix of 4004-4304), so attention crosses the 8192 chunk boundary;
# chunks of 1024, 8-16 new tokens, a prefix trie of 16 nodes
SCOUT_SERVE = dict(arch="llama4_scout_17b_a16e", slots=4, cache_len=8448,
                   prefill_chunk=1024, requests=4, gap=1, seed=13,
                   shared_prefix=4096, prompt_lens=(4004, 4304),
                   max_new=(8, 16), prefix_nodes=16)
# 12c's check as 12b's: row 0's chunk 7400..8423 crosses the chunk
# boundary 8192
SCOUT_SLOT_CHECK = dict(seed=15, lens=(7400, 8300, 5000, 900), across=8192)
# phase 13: RWKV-6 7B at every published width and all 32 layers (about
# 7.5 B parameters, 15 GB in bf16: the first phase at full depth), bf16
# weights from seed 0; no attention, so the engine's cache_len only bounds
# a prefill call
RWKV = dict(arch="rwkv6_7b", seed=0)
# 13a: phase 5's step shape (batch 16, 32 greedy steps), each row from its
# own random first token
RWKV_DECODE = dict(batch=16, steps=32, cache_len=1024, seed=21)
# 13b: 16 requests a tick apart into 8 slots, chunks of 1024; a shared
# 2048-token prefix (two chunks, what the prefix cache reuses) and a
# repetitive suffix of 512-2560 tokens (prompts of 2560-4608), 8-16 new
# tokens; drafts of up to 4 tokens; a prefix trie of 16 nodes
RWKV_SERVE = dict(slots=8, cache_len=1024, prefill_chunk=1024, requests=16,
                  gap=1, seed=22, shared_prefix=2048, prompt_lens=(512, 2560),
                  max_new=(8, 16), draft_k=4, prefix_nodes=16,
                  repetitive=True)
# 13b's check of the slot path against the plain recurrence: the slots
# prefilled to these lengths, then row 0's next chunk, a decode tick and a
# verify call over every slot
RWKV_SLOT_CHECK = dict(seed=25, lens=(1024, 700, 1000, 300, 64, 100, 7,
                                      500))
# 13c: one request of 32768 prompt tokens (32 chunks) and one of 512, 16
# new tokens each
RWKV_LONG = dict(prompt_len=32768, short_len=512, max_new=16, seed=23)
# the layers of the traced prefill chunk
RWKV_TRACE_LAYERS = 4
# phase 14: Jamba-v0.1 with every published width (d_model 4096, 32 heads
# of 128 over 8 K/V heads, 16 experts of d_ff 14,336 top-2, vocabulary
# 65,536, untied embeddings; Mamba d_inner 8192, d_state 16, dt_rank 256,
# d_conv 4), depth cut from 32 layers to one period of 8 (7 Mamba and 1
# attention, 4 MoE and 4 MLP, each at its published place): about 13.3 B
# parameters, 26.6 GB in bf16, where all 32 layers (51.6 B, 103 GB) exceed
# the card's 80 GB. The int8 K/V cache is forced on (the dry run's rule
# keeps it off at 8 * 128), so the attention layer runs the fused write
# and the dequantize as phase 12 does.
JAMBA = dict(arch="jamba_v0_1_52b", layers=8, seed=0)
# 14a: phase 5's step shape (batch 16, 32 greedy steps), each row from its
# own random first token
JAMBA_DECODE = dict(batch=16, steps=32, cache_len=1024, seed=31)
# 14b: 16 requests a tick apart into 8 slots, chunks of 1024; a shared
# 2048-token prefix and a repetitive suffix of 512-2560 tokens (prompts of
# 2560-4608), 8-16 new tokens; drafts of up to 4 tokens; a prefix trie of
# 16 nodes; capacity factor n_experts (no slot dropped), so that streams
# do not depend on a call's T
JAMBA_SERVE = dict(slots=8, cache_len=4736, prefill_chunk=1024, requests=16,
                   gap=1, seed=28, shared_prefix=2048,
                   prompt_lens=(512, 2560), max_new=(8, 16), draft_k=4,
                   prefix_nodes=16, repetitive=True)
# 14b's check of the slot path against the plain kernels: the slots
# prefilled to these lengths, then row 0's next chunk, a decode tick and a
# verify call over every slot
JAMBA_SLOT_CHECK = dict(seed=29, lens=(3072, 4600, 4097, 2500, 1024, 333,
                                       64, 7))
# 14c: one request of 32768 prompt tokens (32 chunks) and one of 512, 16
# new tokens each, in slots of a 32,896-position ring
JAMBA_LONG = dict(prompt_len=32768, short_len=512, max_new=16, seed=30,
                  cache_len=32896)
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
# greedy decode logits of two runs that round attention differently (the
# ring kernel against its plain version; the card against the CPU): within
# LOGIT_TOL of the largest logit, the bf16 bound the CPU tests hold the port
# to against the JAX package, and the same token wherever the top-2 margin
# exceeds twice that, over the steps fed the same tokens
LOGIT_TOL = 6 * 2.0 ** -8
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


def device_breakdown(fn, top: int = 8, cpu: bool = True,
                     match: str | None = None) -> dict:
    """One traced run under ``torch.profiler``: the device time of each
    kernel name, summed, the count of device operations (kernels, copies
    and fills) and the device's busy share of the traced wall time (its
    idle share is the rest). Kernels overlap nothing here (one
    stream), so the busy time is the sum over kernels. ``cpu=False``
    records the device's activity alone: a call of some 10,000 launches
    then costs seconds of the profiler's processing, not tens. ``match``
    adds ``matched_ms``, the device time of every kernel whose name holds
    it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if cpu else [ProfilerActivity.CUDA]) as prof:
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
    extra = {} if match is None else {
        "matched_ms": sum(r[1] for r in rows if match in r[0])}
    return {**extra, "traced_wall_ms": secs * 1e3, "device_busy_ms": busy_ms,
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
def plain_ring(fn=ref.ring_attention_ref):
    """Run the slot and decode attention with ``fn`` (the plain version by
    default) in place of the ring kernel (the layers look the wrapper up
    at each call)."""
    saved = ring_attention.ring_attention
    ring_attention.ring_attention = fn
    try:
        yield
    finally:
        ring_attention.ring_attention = saved


def ring_off_by_one(q, k, v, plan, window=None, chunk=None):
    """A wrong ring attention for the decode check: the plain version told
    that one token fewer was written, so each query skips the key just
    written (a query with nothing to read averages V)."""
    return ref.ring_attention_ref(q, k, v, torch.stack([plan[0],
                                                        plan[1] - 1]),
                                  window, chunk)


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
    want = (L * steps, 0, 2 * L * steps, L * steps)
    if (launches["quantize_int8_into"], launches["quantize_int8"],
            launches["dequantize_int8"], launches["ring_attention"]) != want:
        raise AssertionError(f"decode launches {launches}: want {want[0]} "
                             "fused K/V writes (every layer, every step), "
                             f"no separate quantize, {want[2]} "
                             f"dequantizes (K and V) and {want[3]} ring "
                             "attentions")
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
    with plain_ring():
        plain = serve.serve_loop(args, cfg, params, keep_logits=True)
    with plain_ring(ring_off_by_one):
        wrong = serve.serve_loop(args, cfg, params, keep_logits=True)
    ring_gap, wrong_gap = (greedy_gap(r, plain, LOGIT_TOL)
                           for r in (run, wrong))
    del plain, wrong
    if ring_gap["wrong_tokens"] or not ring_gap["err_share"] <= LOGIT_TOL:
        raise AssertionError(f"decode with the ring kernel against its "
                             f"plain version: {ring_gap}, limit "
                             f"{LOGIT_TOL:.3e} of max|logit|")
    if not wrong_gap["err_share"] > LOGIT_TOL:
        raise AssertionError(f"an off-by-one ring attention reads "
                             f"{wrong_gap}: within the limit "
                             f"{LOGIT_TOL:.3e}, which would not catch it")
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
    log(f"  decode, ring kernel vs its plain version: logit error "
        f"{ring_gap['err_share']:.3e} of max|logit| (limit "
        f"{LOGIT_TOL:.3e}) over {ring_gap['steps']} steps fed the same "
        f"tokens, {ring_gap['clear_tokens']} clear-margin tokens equal, "
        f"tokens all equal: {ring_gap['same_tokens']}; an off-by-one ring "
        f"attention reads {wrong_gap['err_share']:.3e} "
        f"({wrong_gap['wrong_tokens']} clear-margin tokens differ)")
    res["ring_vs_plain"] = ring_gap
    res["off_by_one_vs_plain"] = wrong_gap
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


def logit_gap(got, want, tol: float) -> dict:
    """Two sequences of logits (..., V), one entry a call fed the same
    tokens: the largest |got - want| over max |want| of each entry, and the
    argmaxes that differ where ``want``'s top-2 margin exceeds twice ``tol``
    of max |want|."""
    worst, clear_n, wrong = 0.0, 0, 0
    for a, b in zip(got, want):
        b = b.double()
        a = a.to(b.device).double()
        top = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / top)
        top2 = torch.topk(b, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol * top
        wrong += int((a.argmax(-1) != b.argmax(-1))[clear].sum())
        clear_n += int(clear.sum())
    return {"err_share": worst, "clear_tokens": clear_n,
            "wrong_tokens": wrong}


def check_gap(what: str, gap: dict) -> None:
    if gap["wrong_tokens"] or not gap["err_share"] <= LOGIT_TOL:
        raise AssertionError(f"{what} against the plain ring attention and "
                             f"int8: {gap}, limit {LOGIT_TOL:.3e}")


def check_tokens(what: str, gap: dict) -> None:
    if gap["wrong_tokens"]:
        raise AssertionError(f"{what} against the plain ring attention and "
                             f"int8: clear-margin tokens differ: {gap}")


def held_line(held: dict) -> str:
    return ", ".join(f"{k} {v['calls']} calls, error {v['err']:.3e}"
                     for k, v in held.items())


def greedy_gap(got, want, tol: float) -> dict:
    """Two greedy ``serve_loop`` runs (``keep_logits``) on the same params:
    :func:`logit_gap` over the steps fed the same tokens."""
    parted = np.nonzero((got.tokens != want.tokens).any(0))[0]
    steps = int(parted[0]) + 1 if len(parted) else want.tokens.shape[1]
    return {**logit_gap(got.logits[:steps], want.logits[:steps], tol),
            "steps": steps,
            "same_tokens": bool(np.array_equal(got.tokens, want.tokens))}


def reduced_check(dev) -> dict:
    """Reduced MiniCPM-2B with the int8 cache on the card against the port
    on the CPU, the same params: :func:`greedy_gap` within
    ``LOGIT_TOL``."""
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
    gap = greedy_gap(card, host, LOGIT_TOL)
    if gap["wrong_tokens"] or not gap["err_share"] <= LOGIT_TOL:
        raise AssertionError(f"reduced card vs CPU: {gap}, limit "
                             f"{LOGIT_TOL:.3e} of max|logit|")
    log(f"  reduced {cfg.name} int8, card vs CPU: max error "
        f"{gap['err_share']:.2e} of max|logit| (limit {LOGIT_TOL:.2e}) over "
        f"{gap['steps']} steps fed the same tokens; {gap['clear_tokens']} "
        "clear-margin tokens equal")
    return {"max_err_share": gap["err_share"], "steps_compared": gap["steps"],
            "tokens_compared": gap["clear_tokens"]}


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


def serve_model(dev):
    """Phases 9 and 10's model: MiniCPM-2B's decode config (bf16 weights,
    the int8 K/V cache), weights from ``SERVE["seed"]``, drawn once."""
    cfg = decode_config(get_config(SERVE["arch"]))
    if not cfg.kv_quant:
        raise AssertionError("MiniCPM-2B's decode config has no int8 cache")
    return cfg, tf.init_params(cfg, SERVE["seed"], dev)


def continuous_phase(dev, cfg, params) -> dict:
    res = {"slot_write": slot_write_shapes(dev)}
    torch.cuda.empty_cache()
    L = cfg.n_layers
    log(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}; "
        f"{SERVE['slots']} slots, ring {SERVE['cache_len']}, prefill chunk "
        f"{SERVE['prefill_chunk']}; {SERVE['requests']} requests a tick "
        f"apart, prompts {SERVE['prompt_lens']}, new tokens "
        f"{SERVE['max_new']}")
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
            "ring_attention": calls, "quantize_int8": 0}
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
    del engine, session
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


# ------------------------------------------- speculation, prefixes, policies

def w10(vocab: int, sampling=None, spec=None, n=None) -> list:
    """Workload W10: ``SPEC["requests"]`` requests a tick apart, each the
    shared system prompt and a repetitive suffix; the first
    ``SPEC["batch"]`` BATCH (preemptible), the rest INTERACTIVE with a TTFT
    deadline."""
    reqs = serve.synthetic_workload(
        SPEC["requests"], vocab, gap=SPEC["gap"], seed=SPEC["seed"],
        prompt_lens=SPEC["suffix"], max_new=SPEC["max_new"],
        sampling=sampling, spec=spec, repetitive=True,
        shared_prefix=SPEC["shared_prefix"])
    for r in reqs:
        r.slo = (SLOParams(priority=PriorityClass.BATCH)
                 if r.rid < SPEC["batch"] else
                 SLOParams(priority=PriorityClass.INTERACTIVE,
                           deadline_ticks=SPEC["deadline_ticks"]))
    return reqs[:n]


def spec_engine(cfg, params, dev, **kw) -> ServingEngine:
    return ServingEngine(cfg, None, params, n_slots=SPEC["slots"],
                         max_len=SPEC["cache_len"],
                         prefill_chunk=SPEC["prefill_chunk"],
                         prefix_cache_nodes=SPEC["prefix_nodes"],
                         device=dev, **kw)


def run_line(name: str, rep: dict, reqs) -> dict:
    """One run's numbers (ticks, wall, tokens/s, TTFT in ticks), logged."""
    late = [r.ttft for r in reqs if r.rid >= SPEC["batch"]]
    out = {"ticks": rep["ticks"], "decode_ticks": rep["decode_ticks"],
           "verify_ticks": rep["verify_ticks"],
           "prefill_chunks": rep["prefill_chunks"],
           "total_tokens": rep["total_tokens"], "wall_s": rep["wall_s"],
           "tokens_per_s": rep["tok_s"],
           "ttft_ticks_p50": rep["ttft_ticks_p50"],
           "ttft_ticks_p95": rep["ttft_ticks_p95"],
           "interactive_ttft_ticks_p50": (float(np.median(late)) if late
                                          else float("nan"))}
    log(f"  {name}: {rep['ticks']} ticks ({rep['decode_ticks']} decode, "
        f"{rep['verify_ticks']} verify, {rep['prefill_chunks']} prefill "
        f"chunks), {rep['total_tokens']} tokens in {rep['wall_s']:.3f} s, "
        f"{rep['tok_s']:.2f} tok/s; TTFT p50/p95 {rep['ttft_ticks_p50']}/"
        f"{rep['ttft_ticks_p95']} ticks (interactive p50 "
        f"{out['interactive_ttft_ticks_p50']})")
    return out


def same_streams(got: dict, want: dict, what: str) -> None:
    if got["tokens"] != {r: t for r, t in want["tokens"].items()
                         if r in got["tokens"]}:
        raise AssertionError(f"{what}: streams differ from run A's")


def ring_cases(gen, B, T, H, KV, D, S, dt, dev):
    """q (B, T, H, D) and rings (B, S, KV, D) of ``dt``, random."""
    q = torch.randn((B, T, H, D), generator=gen, device=dev).to(dt)
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(dt)
            for _ in range(2))
    return q, k, v


def ring_err(got, want, keep) -> float:
    """The largest |got - want| / (|want| + max |want| over the query's
    head_dim) over the queries in ``keep``: the flash kernel's rule."""
    g, w = got.double()[keep], want.double()[keep]
    if not g.numel():
        return 0.0
    scale = w.abs() + w.abs().amax(-1, keepdim=True)
    return float(((g - w).abs() / scale.clamp_min(1e-300)).max())


def ring_shapes() -> dict:
    """The slot attention's shapes on the main path, ``{name: (rows,
    queries, ring, start positions)}``: phase 10's verify and decode ticks
    and chunk; phase 5's last step; phase 9's decode tick (16 slots at
    prompt lengths of 256 to 2560) and a 1024-token chunk."""
    spec_pos = [1400, 1100, 1300, 1250, 1200, 1350, 1150, 1450]
    return {
        "verify": (SPEC["slots"], SPEC["draft_k"] + 1, SPEC["cache_len"],
                   spec_pos),
        "decode": (SPEC["slots"], 1, SPEC["cache_len"], spec_pos),
        "prefill": (1, SPEC["prefill_chunk"], SPEC["cache_len"],
                    [2 * SPEC["prefill_chunk"]]),
        "decode_phase5": (DECODE["batch"], 1, DECODE["cache_len"],
                          [DECODE["steps"] - 1] * DECODE["batch"]),
        "decode_phase9": (SERVE["slots"], 1, SERVE["cache_len"],
                          [300, 2580, 1200, 900, 2000, 1700, 450, 2300, 800,
                           1500, 2550, 600, 1900, 1100, 350, 2200]),
        "prefill_phase9": (1, SERVE["prefill_chunk"], SERVE["cache_len"],
                           [SERVE["prefill_chunk"]]),
    }


def ring_bound(plan, T, S, H, KV, D, dt) -> tuple:
    """(bound ms, what bounds it, bytes, operations) of one call: its
    bytes over the HBM rate, its operations over the dense bf16
    tensor-core rate (bf16 products summed in f32) or the f32 rate."""
    nbytes, nops = ring_attention.work(plan, T, S, H, KV, D,
                                       itemsize=torch.finfo(dt).bits // 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / (BF16_TC_OPS_PER_S if dt == torch.bfloat16
                    else F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, nops)


def ring_same_bits(gen, H, KV, window, dev) -> int:
    """The same five queries of each of 4 rows over a wrapped ring of 4096
    (positions past 4096) in calls of 1, 5, 40 and 512 queries at offsets
    (``ring_attention.same_bits_pairs``), bitwise equal. Returns the
    queries compared."""
    B, S, D = 4, 4096, 64
    q, k, v = ring_cases(gen, B, 512, H, KV, D, S, torch.bfloat16, dev)
    first = torch.tensor([5000, 6100, 4200, 8000], device=dev) - 37
    for what, one, got in ring_attention.same_bits_pairs(q, k, v, first,
                                                         window):
        check_bitwise(one, got, f"ring_attention H={H} KV={KV} "
                      f"window={window} {what}")
    return 5 * B * H


def ring_attention_phase(dev) -> dict:
    """The slot attention kernel against its plain version (each output
    element within ``FLASH_TOL`` of its size plus its row's largest, over
    the queries that have a position to read), over dtypes, head_dims 12,
    64 and 128, 1 and 2 query heads per K/V head, windows and chunks,
    wrapped rings and an inactive row; the same queries in one call of 5
    and five calls of 1 and in a call of 40, bitwise equal; the same over a
    wrapped ring in calls of 1, 5, 40 and 512 at offsets, with 1 and 2
    query heads per K/V head; then timed at the paths' shapes
    (``ring_shapes``) beside its bound, the plain version and SDPA on the
    same inputs."""
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {dt: 0.0 for dt in fa.FLASH_TOL}
    checks = 0
    for dt in (torch.float32, torch.bfloat16):
        for D in (12, 64, 128):
            for rep in (1, 2):
                for window, chunk in ((None, None), (8, None), (None, 16)):
                    for T in (1, 5, 33):
                        S = 64 if window is None else max(T, 8 + 5)
                        q, k, v = ring_cases(gen, 3, T, 2 * rep, 2, D, S,
                                             dt, dev)
                        plan = torch.tensor([[0, 70, 30], [T, T, 0]],
                                            device=dev)
                        keep = ring_attention.valid(plan, T, S, window, chunk)
                        got = ring_attention.ring_attention(
                            q, k, v, plan, window, chunk)
                        want = ref.ring_attention_ref(q, k, v, plan, window,
                                                      chunk)
                        err = ring_err(got, want, keep)
                        if not err <= fa.FLASH_TOL[dt]:
                            raise AssertionError(
                                f"ring_attention {dt} D={D} rep={rep} "
                                f"window={window} chunk={chunk} T={T}: "
                                f"error {err:.3e} > {fa.FLASH_TOL[dt]:.1e}")
                        worst[dt] = max(worst[dt], err)
                        checks += 1
    # one query's bits in any call
    q, k, v = ring_cases(gen, 8, 40, 36, 36, 64, 4096, torch.bfloat16, dev)
    pos = torch.tensor([0, 17, 1000, 1500, 2047, 3000, 4000, 33], device=dev)
    five = ring_attention.ring_attention(
        q[:, :5].contiguous(), k, v, torch.stack([pos, torch.full_like(
            pos, 5)]))
    forty = ring_attention.ring_attention(
        q, k, v, torch.stack([pos, torch.full_like(pos, 40)]))
    for t in range(5):
        one = ring_attention.ring_attention(
            q[:, t:t + 1].contiguous(), k, v,
            torch.stack([pos + t, torch.ones_like(pos)]))
        check_bitwise(one[:, 0], five[:, t], f"ring_attention query {t}, "
                      "a call of 1 against a call of 5")
        check_bitwise(one[:, 0], forty[:, t], f"ring_attention query {t}, "
                      "a call of 1 against a call of 40")
    del q, k, v, five, forty, one
    same = sum(ring_same_bits(gen, H, KV, window, dev)
               for H, KV in ((36, 36), (36, 18)) for window in (None, 1000))
    log(f"  ring_attention: {checks} cases within tolerance of the plain "
        "version (worst " + ", ".join(f"{str(dt)[6:]} {w:.2e}"
                                       for dt, w in worst.items())
        + "); a query's output bitwise the same in calls of 1, 5 and 40, "
        f"and ({same} queries) in calls of 1, 5, 40 and 512 at offsets over "
        "a wrapped ring")
    cfg = get_config(SERVE["arch"])
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    out = {}
    for what, (B, T, S, pos) in ring_shapes().items():
        q, k, v = ring_cases(gen, B, T, H, KV, D, S, torch.bfloat16, dev)
        plan = torch.tensor([pos, [T] * B], device=dev)
        keep = ring_attention.valid(plan, T, S, None, None)
        got = ring_attention.ring_attention(q, k, v, plan)
        want = ref.ring_attention_ref(q, k, v, plan)
        err = ring_err(got, want, keep)
        if not err <= fa.FLASH_TOL[torch.bfloat16]:
            raise AssertionError(f"ring_attention at the {what} shape: error "
                                 f"{err:.3e}")
        abs_err = max_abs_err(got, want)
        # SDPA on the same inputs, laid out (B, H, T, D) beforehand
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qp = plan[0][:, None] + torch.arange(T, device=dev)[None]
        mask = (torch.arange(S, device=dev)[None, None] <= qp[..., None])
        mask = mask[:, None]                      # (B, 1, T, S); no wrap
        t_k = time_ms(lambda: ring_attention.ring_attention(q, k, v, plan))
        t_l = time_ms(lambda: torch.nn.functional
                      .scaled_dot_product_attention(qt, kt, vt,
                                                    attn_mask=mask))
        t_p = time_ms(lambda: ref.ring_attention_ref(q, k, v, plan), reps=5)
        bound, by, nbytes, nops = ring_bound(plan, T, S, H, KV, D, q.dtype)
        out[what] = {"shape": [list(q.shape), list(k.shape)], "pos": pos,
                     "route": ring_attention.route(q.dtype, D, S),
                     "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                     "ops": nops, "err_share": err, "max_abs_err": abs_err}
        log(f"  ring_attention {what} {out[what]['shape']}: kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, SDPA {t_l:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); error {err:.2e} of |want| + row max")
        del q, k, v, qt, kt, vt, got, want
    src, replaces = KERNEL_FILES["ring_attention"]
    head = out["verify"]
    return {"name": "ring_attention", "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(o["max_abs_err"] for o in out.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "checks": checks, "same_bits_queries": same,
            "worst_err_share": {
                str(dt)[6:]: w for dt, w in worst.items()}, "shapes": out}


def verify_write_shape(dev) -> dict:
    """The fused K/V write at a verify tick's shape: two (8, 5, 36, 64)
    bf16 sources into (8, 4096, 36, 64) rings, rows at mixed positions
    writing 0, 1, 3 or 5 tokens, two near the ring's end so their writes
    wrap; bitwise against its plain version, timed by device time per
    launch beside its byte bound."""
    cfg = get_config(SERVE["arch"])
    KV, W, S, B = cfg.n_kv_heads, cfg.hdim, SPEC["cache_len"], SPEC["slots"]
    T = SPEC["draft_k"] + 1
    gen = torch.Generator(device=dev).manual_seed(10)
    pos = [0, S - 2, 100, S // 2 - 1, S - 1, 777, 3 * S // 4, 12]
    n = [1, 5, 0, 3, 5, 1, 3, 0]
    k, v, bufs = slot_write_case(gen, B, T, KV, W, S, dev)
    got = [t.clone() for t in bufs]
    want = [t.clone() for t in bufs]
    quantize.quantize_int8_into(k, v, *got, pos, n)
    ref.quantize_int8_into_ref(k, v, *want, pos, n)
    err = 0.0
    for g, w, name in zip(got, want, ("K ring", "V ring", "K scales",
                                      "V scales")):
        check_bitwise(g, w, f"quantize_int8_into verify {name}")
        err = max(err, max_abs_err(g.float(), w.float()))
    del got, want
    tokens = sum(n)
    nbytes = 2 * tokens * KV * (2 * W + W + 4)
    nops = 2 * 4 * tokens * KV * W
    t_dev = device_ms(lambda: quantize.quantize_int8_into(k, v, *bufs, pos,
                                                           n))
    t_host = host_ms(lambda: quantize.quantize_int8_into(k, v, *bufs, pos,
                                                          n))
    t_plain = time_ms(lambda: ref.quantize_int8_into_ref(k, v, *bufs, pos,
                                                          n), reps=10)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    out = {"shape": [list(k.shape), list(bufs[0].shape)], "pos": pos,
           "n": n, "tokens_written": tokens, "device_ms": t_dev,
           "host_ms": t_host, "plain_ms": t_plain,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "max_abs_err": err}
    log(f"  quantize_int8_into verify {out['shape']}, {tokens} tokens "
        f"written: device {t_dev:.4f} ms a launch, host {t_host:.4f} ms a "
        f"call, plain {t_plain:.4f} ms, bound {out['bound_ms']:.7f} ms "
        f"({out['bound_by']}, {nbytes} bytes); bitwise its plain version")
    return out


@contextlib.contextmanager
def timed_ticks(engine, times: dict, rollback: dict):
    """Time each decode and verify call on the host clock (the card
    synchronized before and after), and on the first verify call that
    rejects a draft, hold every rejected token's ring slots (int8 codes
    and scales, every layer) bitwise to their bytes before the call, read
    by plain indexing before it."""
    decode, get_verify = engine._decode, engine._get_verify

    def timed_decode(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(*a, **kw)
        torch.cuda.synchronize()
        times["decode"].append(time.perf_counter() - t0)
        return out

    def checked_verify(k):
        step = get_verify(k)

        def call(params, tokens, caches, active, n_draft, sampling=None):
            snap = []
            if not rollback["checked"]:
                for ci, c in enumerate(caches):
                    S = c["k"].shape[2]
                    for b in np.flatnonzero(active):
                        slots = [(int(c["pos"][0, b]) + t) % S
                                 for t in range(int(n_draft[b]) + 1)]
                        snap.append((ci, int(b), slots, {
                            name: c[name][:, b, slots].clone()
                            for name in ("k", "v", "ks", "vs")}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, tokens, caches, active, n_draft, sampling)
            torch.cuda.synchronize()
            times["verify"].append(time.perf_counter() - t0)
            acc, new = out[1], out[2]
            checked = 0
            for ci, b, slots, old in snap:
                a = int(acc[b])
                for name, vals in old.items():
                    check_bitwise(new[ci][name][:, b, slots[a:]],
                                  vals[:, a:],
                                  f"verify rollback, slot {b}, {name}")
                    checked += (len(slots) - a) * vals.shape[0]
            if checked:
                rollback.update(checked=True, slots_checked=checked,
                                tick=len(times["verify"]))
            return out
        return call

    engine._decode = timed_decode
    engine._get_verify = checked_verify
    try:
        yield
    finally:
        engine._decode, engine._get_verify = decode, get_verify


def spec_phase(dev, cfg, params) -> dict:
    L = cfg.n_layers
    log(f"  {cfg.name}: {SPEC['slots']} slots, ring {SPEC['cache_len']}, "
        f"prefill chunk {SPEC['prefill_chunk']}, prefix trie of "
        f"{SPEC['prefix_nodes']} nodes; W10: {SPEC['requests']} requests a "
        f"tick apart, a shared prefix of {SPEC['shared_prefix']} tokens and "
        f"a repetitive suffix of {SPEC['suffix']}, new tokens "
        f"{SPEC['max_new']}, requests {SPEC['batch']}.. INTERACTIVE with a "
        f"deadline of {SPEC['deadline_ticks']} ticks")
    res = {"verify_write": verify_write_shape(dev),
           "ring_attention": ring_attention_phase(dev)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vocab = cfg.vocab_size
    spec = SpecParams(draft_k=SPEC["draft_k"])
    runs = {}
    # A, the baseline
    reqs = w10(vocab)
    a = spec_engine(cfg, params, dev).run(reqs)
    runs["A"] = run_line("A (FIFO, greedy, plain)", a, reqs)
    runs["A"]["interactive_ttft_ticks"] = [r.ttft for r in reqs
                                           if r.rid >= SPEC["batch"]]
    # B, speculation with the n-gram drafter; the kernels' launches
    reqs = w10(vocab, spec=spec)
    eng = spec_engine(cfg, params, dev)
    torch.cuda.synchronize()
    zero_counters()
    b = eng.run(reqs)
    torch.cuda.synchronize()
    launches = counters()
    same_streams(b, a, "B (speculation)")
    if b["ticks"] > a["ticks"]:
        raise AssertionError(f"B took {b['ticks']} ticks, A {a['ticks']}")
    calls = L * (b["decode_ticks"] + b["verify_ticks"] + b["prefill_chunks"])
    want = {"quantize_int8_into": calls, "dequantize_int8": 2 * calls,
            "ring_attention": calls, "quantize_int8": 0}
    if any(launches[k] != v for k, v in want.items()) or \
            not b["verify_ticks"]:
        raise AssertionError(f"B launches {launches}: want {want} "
                             f"({b['decode_ticks']} decode and "
                             f"{b['verify_ticks']} verify ticks, "
                             f"{b['prefill_chunks']} prefill chunks, {L} "
                             "layers)")
    runs["B"] = run_line("B (speculation, n-gram drafts)", b, reqs)
    runs["B"].update(drafted_tokens=b["drafted_tokens"],
                     accepted_tokens=b["accepted_tokens"],
                     acceptance_rate=b["acceptance_rate"],
                     launches=launches)
    log(f"  B: {b['drafted_tokens']} drafted, {b['accepted_tokens']} "
        f"accepted (rate {b['acceptance_rate']:.3f}); streams bitwise A's; "
        f"launches {launches}")
    del eng
    # C, the prefix cache
    reqs = w10(vocab)
    c = spec_engine(cfg, params, dev, prefix_cache=True).run(reqs)
    same_streams(c, a, "C (prefix cache)")
    if c["prefix_hits"] < 10 or c["prefill_chunks"] >= a["prefill_chunks"]:
        raise AssertionError(f"C: {c['prefix_hits']} prefix hits, "
                             f"{c['prefill_chunks']} chunks against A's "
                             f"{a['prefill_chunks']}")
    runs["C"] = run_line("C (prefix cache)", c, reqs)
    runs["C"].update(prefix_hits=c["prefix_hits"],
                     prefix_tokens_reused=c["prefix_tokens_reused"],
                     prefix_cache=c["prefix_cache"])
    log(f"  C: {c['prefix_hits']} hits, {c['prefix_tokens_reused']} tokens "
        f"reused; trie {c['prefix_cache']}; streams bitwise A's")
    # D, the SLO policy with speculation and the prefix cache
    reqs = w10(vocab, spec=spec)
    d = spec_engine(cfg, params, dev, prefix_cache=True).run(
        reqs, policy=make_policy("slo"))
    same_streams(d, a, "D (SLO policy, speculation, prefix cache)")
    runs["D"] = run_line("D (SLO, speculation, prefix cache)", d, reqs)
    late_d = runs["D"]["interactive_ttft_ticks_p50"]
    late_a = runs["A"]["interactive_ttft_ticks_p50"]
    if d["preemptions"] < 1 or d["resumed_tokens"] < 1 or late_d > late_a:
        raise AssertionError(f"D: {d['preemptions']} preemptions, "
                             f"{d['resumed_tokens']} resumed tokens, "
                             f"interactive TTFT p50 {late_d} against A's "
                             f"{late_a}")
    runs["D"].update(preemptions=d["preemptions"],
                     resumed_tokens=d["resumed_tokens"],
                     shed_requests=d["shed_requests"],
                     deadline_misses=d["deadline_misses"],
                     prefix_hits=d["prefix_hits"],
                     drafted_tokens=d["drafted_tokens"],
                     accepted_tokens=d["accepted_tokens"],
                     interactive_ttft_ticks=[r.ttft for r in reqs
                                             if r.rid >= SPEC["batch"]])
    log(f"  D: {d['preemptions']} preemptions ({d['resumed_tokens']} "
        f"tokens resumed), {d['shed_requests']} shed, "
        f"{d['deadline_misses']} deadline misses, {d['prefix_hits']} prefix "
        f"hits; interactive TTFT p50 {late_d} ticks against A's {late_a}; "
        "streams bitwise A's")
    # E, A and B sampled
    reqs = w10(vocab, SAMPLED)
    e_plain = spec_engine(cfg, params, dev).run(reqs)
    runs["E_plain"] = run_line("E (sampled, plain)", e_plain, reqs)
    reqs = w10(vocab, SAMPLED, spec)
    e_spec = spec_engine(cfg, params, dev).run(reqs)
    if e_spec["tokens"] != e_plain["tokens"] or \
            e_spec["sampled_tokens"] != e_spec["total_tokens"]:
        raise AssertionError("E: sampled speculative streams differ from "
                             "the plain sampled ones")
    runs["E_spec"] = run_line("E (sampled, speculation)", e_spec, reqs)
    runs["E_spec"].update(drafted_tokens=e_spec["drafted_tokens"],
                          accepted_tokens=e_spec["accepted_tokens"])
    log(f"  E: sampled speculative streams bitwise the plain sampled ones "
        f"({e_spec['accepted_tokens']}/{e_spec['drafted_tokens']} drafts "
        "accepted)")
    # F, a draft model: the same widths cut to a few layers, its own slots
    dcfg = dataclasses.replace(cfg, n_layers=SPEC["draft_layers"])
    drafter = DraftModelDrafter(
        dcfg, tf.init_params(dcfg, SPEC["draft_seed"], dev),
        n_slots=SPEC["slots"], max_len=SPEC["cache_len"], device=dev)
    reqs = w10(vocab, spec=spec, n=SPEC["draft_requests"])
    f = spec_engine(cfg, params, dev, drafter=drafter).run(reqs)
    same_streams(f, a, "F (draft model)")
    runs["F"] = run_line(f"F (draft model, {SPEC['draft_layers']} layers, "
                         f"requests 0..{SPEC['draft_requests'] - 1})", f,
                         reqs)
    runs["F"].update(drafted_tokens=f["drafted_tokens"],
                     accepted_tokens=f["accepted_tokens"])
    del drafter
    # B again, its decode and verify calls timed, the rollback checked
    times = {"decode": [], "verify": []}
    rollback = {"checked": False}
    eng = spec_engine(cfg, params, dev)
    with timed_ticks(eng, times, rollback):
        again = eng.run(w10(vocab, spec=spec))
    same_streams(again, a, "B, timed")
    if not rollback["checked"]:
        raise AssertionError("no verify tick of run B rejected a draft")
    med = {k: (float(np.median(v)) if v else float("nan"))
           for k, v in times.items()}
    log(f"  B timed: median verify tick {med['verify'] * 1e3:.2f} ms over "
        f"{len(times['verify'])}, median decode tick "
        f"{med['decode'] * 1e3:.2f} ms over {len(times['decode'])} (host "
        "clock, card synchronized around each); the rejected slots of "
        f"verify tick {rollback['tick']} ({rollback['slots_checked']} "
        "slot-layers) bitwise their bytes before the call")
    peak = torch.cuda.max_memory_allocated()
    log(f"  phase 10 peak memory {peak / 1e9:.2f} GB")
    del eng
    torch.cuda.empty_cache()
    res.update({"runs": runs, "launches": launches,
                "median_verify_tick_s": med["verify"],
                "median_decode_tick_s": med["decode"],
                "verify_calls_timed": len(times["verify"]),
                "decode_calls_timed": len(times["decode"]),
                "rollback": rollback, "max_memory_bytes": peak})
    return res


# ------------------------------------------------------ the fleet under chaos

def w11(vocab: int) -> list:
    """Workload W11: ``FLEET["requests"]`` requests a tick apart, the odd
    ones sampled (seed 11 + rid, temperature 0.9, top-k 20)."""
    reqs = serve.synthetic_workload(
        FLEET["requests"], vocab, gap=FLEET["gap"], seed=FLEET["seed"],
        prompt_lens=FLEET["prompt_lens"], max_new=FLEET["max_new"])
    for r in reqs:
        if r.rid % 2:
            r.sampling = SamplingParams(seed=11 + r.rid, temperature=0.9,
                                        top_k=20)
    return reqs


@contextlib.contextmanager
def fleet_watch(engine, watch: dict):
    """Count the engine's prefill and decode calls; log every session
    tick's stats row by (tick, replica); on a tick that raises
    ``PoisonedLogits``, note the poisoned requests' journal lengths before
    and after the tick and the ``ring_attention`` launches it made; and the
    device memory around each replica's discard and rejoin. The session
    and runner methods are wrapped on their classes (no reference cycle
    keeps a discarded session's caches alive)."""
    saved = (engine._prefill, engine._decode, EngineSession.tick,
             FleetRunner._discard, FleetRunner._rebalance)

    def counted(fn, key):
        def call(*a, **kw):
            watch["calls"][key] += 1
            return fn(*a, **kw)
        return call

    def tick(sess):
        held = {r.rid: len(r.tokens) for r in sess.sched.active.values()}
        ring0 = WRAPPERS["ring_attention"].launches
        try:
            row = saved[2](sess)
        except PoisonedLogits as e:
            now = {r.rid: len(r.tokens) for r in sess.sched.active.values()}
            watch["poisoned"].append({
                "replica": sess.trace_replica, "tick": sess.now,
                "slots": list(e.slots), "rids": list(e.rids),
                "journal_before": [held[r] for r in e.rids],
                "journal_after": [now[r] for r in e.rids],
                "ring_attention_launches": (WRAPPERS["ring_attention"]
                                            .launches - ring0),
                "device": sess.caches[0]["k"].device.type})
            raise
        watch["rows"].append((sess.now - 1, sess.trace_replica,
                              list(row[:len(STATS_FIELDS)])))
        return row

    def memory(fn, kind):
        def call(runner, replica):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            fn(runner, replica)
            torch.cuda.synchronize()
            watch["memory"].append({
                "event": kind, "replica": replica, "tick": runner.now,
                "before": before, "after": torch.cuda.memory_allocated()})
        return call

    engine._prefill = counted(saved[0], "prefill")
    engine._decode = counted(saved[1], "decode")
    EngineSession.tick = tick
    FleetRunner._discard = memory(saved[3], "discard")
    FleetRunner._rebalance = memory(saved[4], "rejoin")
    try:
        yield
    finally:
        engine._prefill, engine._decode = saved[:2]
        EngineSession.tick = saved[2]
        FleetRunner._discard, FleetRunner._rebalance = saved[3:]


def fleet_run(engine, name: str, faults, want: dict, L: int) -> tuple:
    """One ``FleetRunner`` run of W11 under ``faults``: its streams bitwise
    ``want``'s, failovers above 0, and one fused write and one ring
    attention per layer for every decode tick and prefill chunk, two
    dequantizes for each; the device memory back at its level before the
    run once the runner is dropped. Returns (report, watch)."""
    watch = {"calls": {"prefill": 0, "decode": 0}, "rows": [],
             "poisoned": [], "memory": []}
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated()
    runner = FleetRunner(engine, FLEET["replicas"], plan=FaultPlan(faults),
                         timeout_s=FLEET["timeout"],
                         rejoin_backoff_s=FLEET["rejoin_backoff"])
    torch.cuda.synchronize()
    zero_counters()
    with fleet_watch(engine, watch):
        rep = runner.run(w11(engine.cfg.vocab_size))
    torch.cuda.synchronize()
    launches = counters()
    del runner
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - level
    if left > 1 << 24:          # 16 MiB: a replica's caches are 3.2 GB
        raise AssertionError(f"fleet run {name}: {left} bytes still held "
                             "after the runner was dropped")
    if rep["tokens"] != want["tokens"]:
        parted = sorted(r for r in want["tokens"]
                        if rep["tokens"].get(r) != want["tokens"][r])
        raise AssertionError(f"fleet run {name}: streams {parted} differ "
                             "from the undisturbed run's")
    if rep["failovers"] < 1:
        raise AssertionError(f"fleet run {name}: no failover")
    calls = L * (watch["calls"]["prefill"] + watch["calls"]["decode"])
    need = {"quantize_int8_into": calls, "dequantize_int8": 2 * calls,
            "ring_attention": calls, "quantize_int8": 0}
    if any(launches[k] != v for k, v in need.items()):
        raise AssertionError(f"fleet run {name}: launches {launches}, want "
                             f"{need} ({watch['calls']} calls, {L} layers)")
    watch["launches"] = launches
    log(f"  {name}: {rep['ticks']} ticks, {rep['total_tokens']} tokens in "
        f"{rep['wall_s']:.3f} s, {rep['tok_s']:.2f} tok/s; TTFT p50/p95 "
        f"{rep['ttft_ticks_p50']}/{rep['ttft_ticks_p95']} ticks; "
        f"{rep['failovers']} failovers, {rep['quarantines']} quarantines, "
        f"{rep['rejoins']} rejoins, {rep['resumed_tokens']} resumed tokens, "
        f"recovery {rep['recovery_ticks']} ticks; alive {rep['alive']}; "
        f"{watch['calls']['decode']} decode calls and "
        f"{watch['calls']['prefill']} prefill chunks; streams bitwise the "
        "undisturbed run's")
    return rep, watch


def fleet_line(rep: dict, watch: dict) -> dict:
    return {"ticks": rep["ticks"], "total_tokens": rep["total_tokens"],
            "wall_s": rep["wall_s"], "tokens_per_s": rep["tok_s"],
            "ttft_ticks_p50": rep["ttft_ticks_p50"],
            "ttft_ticks_p95": rep["ttft_ticks_p95"],
            "failovers": rep["failovers"],
            "quarantines": rep["quarantines"], "rejoins": rep["rejoins"],
            "resumed_tokens": rep["resumed_tokens"],
            "recovery_ticks": rep["recovery_ticks"], "alive": rep["alive"],
            "events": rep["events"], "calls": watch["calls"],
            "memory": watch["memory"]}


def epochs(rep: dict, n: int) -> list:
    """The run's membership epochs from its failover events: [(first tick,
    members)], starting with all ``n`` replicas."""
    members, out = list(range(n)), [(0, tuple(range(n)))]
    for e in rep["events"]:
        if "p" not in e:
            continue
        members = sorted((set(members) - set(e["dead"])
                          - set(e["quarantined"])) | set(e["rejoined"]))
        out.append((e["tick"], tuple(members)))
    return out


def member_reduction(dev, rep: dict, watch: dict) -> dict:
    """Each membership epoch's per-replica stats rows, summed per member,
    reduced over the members on ``LocalTransport`` (p = the epoch's
    members, as ``plan_remesh`` plans it) under an installed probe; each
    sum equal to numpy's. Returns the p's, ``combine3`` launches per
    reduction and the probe's samples."""
    eps = epochs(rep, FLEET["replicas"])
    k = len(STATS_FIELDS)
    out = {"p": [], "combine3_launches": [], "methods": []}
    parts = []
    for i, (t0, members) in enumerate(eps):
        t1 = eps[i + 1][0] if i + 1 < len(eps) else rep["ticks"]
        part = np.zeros((len(members), k), np.float32)
        for tick, r, row in watch["rows"]:
            if t0 <= tick < t1 and r in members:
                part[members.index(r)] += np.asarray(row, np.float32)
        parts.append((members, part))
        # one unprobed call first, so the probe times no first-call set-up
        make_stats_reducer(LocalTransport(len(members), dev))(part)
    with obs.probing() as probe:
        for members, part in parts:
            plan = fault_tolerance.plan_remesh(members, float(k * 4))
            if plan.new_p != len(members):
                raise AssertionError(f"plan_remesh over {members}: {plan}")
            zero_counters()
            got = make_stats_reducer(LocalTransport(plan.new_p, dev))(part)
            out["combine3_launches"].append(counters()["combine3"])
            if not np.array_equal(got, part.sum(0)):
                raise AssertionError(f"stats over {members}: {got} != numpy "
                                     f"{part.sum(0)}")
            out["p"].append(plan.new_p)
            out["methods"].append(probe.traced()[-1].method)
    if out["p"] != [3, 2, 3]:
        raise AssertionError(f"membership p {out['p']}, want [3, 2, 3]")
    for p, m, c in zip(out["p"], out["methods"], out["combine3_launches"]):
        if m == "dptree" and c == 0:
            raise AssertionError(f"p={p}: dptree ran without combine3")
    timed = probe.timed()
    out["samples"] = {"seen": probe.n_seen, "timed": len(timed),
                      "trace": len(probe.traced())}
    out["timed_s"] = [s.wall_s for s in timed]
    try:
        fit = obs.fit_alpha_beta(timed)
        out["fit"] = {"alpha_s": fit.alpha, "beta_s_per_byte": fit.beta,
                      "n": fit.n_samples, "max_rel_err": fit.max_rel_err}
        note = (f"alpha {fit.alpha:.3e} s, beta {fit.beta:.3e} s/B over "
                f"{fit.n_samples} samples")
    except ValueError as e:
        out["fit"] = {"refused": str(e)}
        note = f"no fit: {e}"
    log(f"  stats over the members at p = {out['p']} (methods "
        f"{out['methods']}, combine3 launches {out['combine3_launches']}) "
        f"equal to numpy's sum; probe: {out['samples']}, timed "
        f"{[f'{s * 1e3:.4f} ms' for s in out['timed_s']]}; constants of "
        f"LocalTransport stacked on one card (the p ranks are rows of one "
        f"tensor), not of a link: {note}")
    return out


def fleet_phase(dev, cfg, params) -> dict:
    L = cfg.n_layers
    log(f"  {cfg.name}: {FLEET['replicas']} replicas of {FLEET['slots']} "
        f"slots, ring {FLEET['cache_len']}, prefill chunk "
        f"{FLEET['prefill_chunk']}; W11: {FLEET['requests']} requests a tick "
        f"apart, prompts {FLEET['prompt_lens']}, new tokens "
        f"{FLEET['max_new']}, the odd ones sampled; heartbeat deadline "
        f"{FLEET['timeout']} ticks, rejoin probation "
        f"{FLEET['rejoin_backoff']}")
    # earlier phases' cyclic garbage (device tensors among it) goes now,
    # not inside a run, where the memory readings around a death are taken
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, None, params, n_slots=FLEET["slots"],
                           max_len=FLEET["cache_len"],
                           prefill_chunk=FLEET["prefill_chunk"], device=dev)
    base = engine.run(w11(cfg.vocab_size))
    cache_bytes = sum(t.numel() * t.element_size() for c in engine.caches
                      for t in c.values() if t.device.type == dev.type)
    engine.caches = None
    short = [r for r, t in base["tokens"].items() if not t]
    if base["requests"] != FLEET["requests"] or short:
        raise AssertionError(f"undisturbed run: {base['requests']} requests, "
                             f"empty streams {short}")
    log(f"  undisturbed (one engine, {FLEET['slots']} slots): "
        f"{base['ticks']} ticks, {base['total_tokens']} tokens in "
        f"{base['wall_s']:.3f} s, {base['tok_s']:.2f} tok/s; TTFT p50/p95 "
        f"{base['ttft_ticks_p50']}/{base['ttft_ticks_p95']} ticks; a "
        f"replica's caches {cache_bytes / 1e9:.3f} GB")
    runs, launches = {}, {k: 0 for k in WRAPPERS}
    plans = {"a": (Fault(5, "kill", replica=1),),
             "b": (Fault(4, "flap", replica=1, duration=8),
                   Fault(3, "straggle", replica=0, duration=6, factor=2.0)),
             "c": (Fault(6, "poison", replica=2),)}
    plans["d"] = plans["b"]
    names = {"a": "(a) kill replica 1 at tick 5",
             "b": "(b) flap replica 1 for 8 ticks, replica 0 straggling",
             "c": "(c) poison replica 2 at tick 6",
             "d": "(d) (b) again"}
    watches = {}
    for key in "abcd":
        rep, watches[key] = fleet_run(engine, names[key], plans[key], base,
                                      L)
        runs[key] = fleet_line(rep, watches[key])
        for k in WRAPPERS:
            launches[k] += watches[key]["launches"][k]
        if key == "b":
            flap = rep
    # (a): the dead replica's caches are freed with its session
    dead = [m for m in watches["a"]["memory"] if m["event"] == "discard"]
    if not dead or dead[0]["before"] - dead[0]["after"] < cache_bytes:
        raise AssertionError(f"(a): the dead replica freed {dead} bytes, "
                             f"want {cache_bytes}")
    # (b): one rejoin, every replica alive again, journals resumed, the
    # device memory after the rejoin within a replica's caches of its level
    # before the flap's death
    b = runs["b"]
    mem = watches["b"]["memory"]
    gone = [m for m in mem if m["event"] == "discard"]
    back = [m for m in mem if m["event"] == "rejoin"]
    if b["rejoins"] != 1 or b["alive"] != [0, 1, 2] or \
            b["resumed_tokens"] < 1 or not b["recovery_ticks"] or \
            not gone or not back or \
            gone[0]["before"] - gone[0]["after"] < cache_bytes or \
            abs(back[0]["after"] - gone[0]["before"]) > cache_bytes:
        raise AssertionError(f"(b): {b['rejoins']} rejoins, alive "
                             f"{b['alive']}, {b['resumed_tokens']} resumed, "
                             f"recovery {b['recovery_ticks']}, memory {mem}")
    if runs["d"]["events"] != b["events"]:
        raise AssertionError("(d): the replay's events differ from (b)'s")
    # (c): quarantined through a non-finite logit from the card's kernels,
    # nothing of the poisoned tick committed
    c, pois = runs["c"], watches["c"]["poisoned"]
    if c["quarantines"] != 1 or c["alive"] != [0, 1] or len(pois) != 1 or \
            pois[0]["replica"] != 2 or pois[0]["device"] != dev.type or \
            pois[0]["ring_attention_launches"] < L or \
            pois[0]["journal_before"] != pois[0]["journal_after"]:
        raise AssertionError(f"(c): {c['quarantines']} quarantines, alive "
                             f"{c['alive']}, poisoned ticks {pois}")
    runs["c"]["poisoned"] = pois
    log(f"  (a) freed {(dead[0]['before'] - dead[0]['after']) / 1e9:.3f} GB "
        f"at the death of replica 1; (b) {gone[0]['before'] / 1e9:.3f} GB "
        f"before the flap's death, {gone[0]['after'] / 1e9:.3f} after, "
        f"{back[0]['after'] / 1e9:.3f} after the rejoin; (c) replica 2 "
        f"quarantined at tick {pois[0]['tick']}: slots {pois[0]['slots']} "
        f"(requests {pois[0]['rids']}) gave non-finite logits through "
        f"{pois[0]['ring_attention_launches']} ring_attention launches, "
        f"journals {pois[0]['journal_before']} kept; (d) replays (b)'s "
        "events")
    # (e): (a) traced, with live metrics every few ticks
    tracer, metrics = obs.Tracer(), obs.StreamingMetrics()
    engine.tracer, engine.metrics = tracer, metrics
    engine.metrics_every = FLEET["metrics_every"]
    try:
        rep, watches["e"] = fleet_run(engine, "(e) (a) traced", plans["a"],
                                      base, L)
    finally:
        engine.tracer = engine.metrics = None
        engine.metrics_every = 0
    runs["e"] = fleet_line(rep, watches["e"])
    for k in WRAPPERS:
        launches[k] += watches["e"]["launches"][k]
    fails = tracer.by_name("failover")
    if not any(e.rid is None and e.replica == 1 for e in fails) or \
            sum(1 for e in fails if e.rid is not None) != rep["failovers"]:
        raise AssertionError(f"(e): failover events {fails}, "
                             f"{rep['failovers']} failovers")
    path = os.path.join(ROOT, "build", "phase11_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracer.to_chrome(path)
    with open(path) as f:
        doc = json.load(f)
    snap = metrics.snapshot()
    if metrics.ttft.total() != FLEET["requests"] or \
            metrics.latency.total() != FLEET["requests"]:
        raise AssertionError(f"(e): live metrics {snap}")
    runs["e"].update(trace_events=len(tracer), chrome_events=len(
        doc["traceEvents"]), failover_events=len(fails),
        names=sorted(tracer.names()), live_metrics=snap)
    log(f"  (e): {len(tracer)} events ({len(fails)} failover), "
        f"{len(doc['traceEvents'])} Chrome trace entries in {path}, read "
        f"back; live metrics {snap}")
    stats = member_reduction(dev, flap, watches["b"])
    launches["combine3"] += sum(stats["combine3_launches"])
    peak = torch.cuda.max_memory_allocated()
    log(f"  phase 11 peak memory {peak / 1e9:.2f} GB")
    del engine
    torch.cuda.empty_cache()
    return {"undisturbed": {"ticks": base["ticks"],
                            "total_tokens": base["total_tokens"],
                            "wall_s": base["wall_s"],
                            "tokens_per_s": base["tok_s"],
                            "ttft_ticks_p50": base["ttft_ticks_p50"],
                            "ttft_ticks_p95": base["ttft_ticks_p95"]},
            "replica_cache_bytes": cache_bytes, "runs": runs,
            "launches": launches, "stats": stats, "max_memory_bytes": peak}


# --------------------------------------------------- MoE at full width

def moe_config(arch: str, cf: float | None = None):
    """``arch``'s decode config (bf16 weights) cut to ``MOE["layers"]``
    layers, the int8 K/V cache forced on, at capacity factor ``cf``
    (the config's own where None)."""
    cfg = decode_config(get_config(arch))
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=float(cf))
    return dataclasses.replace(cfg, n_layers=MOE["layers"], kv_quant=True,
                               moe=moe)


def active_params(cfg, params) -> tuple:
    """(all parameters, those a token touches): the reference's
    ``active_param_count``, the stacked experts counted at top_k of
    n_experts."""
    total = sum(t.numel() for t in _leaves(params))
    frac = 1.0 - cfg.moe.top_k / cfg.moe.n_experts
    idle = sum(sp[k].numel() * frac for layer in params["layers"]
               for sp in layer if "w_in" in sp and sp["w_in"].dim() == 4
               for k in ("w_in", "w_out", "w_gate") if k in sp)
    return total, int(total - idle)


@contextlib.contextmanager
def moe_watch(watch: dict):
    """Count the MoE sublayer calls (each copies its experts' counts to the
    host once: the routing's sync) and, where ``watch`` has ``"length"``
    set by the caller, the (token, choice) slots of real tokens that the
    dispatch drops in a call of more than one token per row."""
    saved = tf._moe_dispatch, tf.moe_route

    def dispatch(*a, **kw):
        watch["calls"] += 1
        return saved[0](*a, **kw)

    def route(logits, k, C):
        out = saved[1](logits, k, C)
        if logits.shape[1] > 1 and watch.get("length") is not None:
            order, keep = out[2], out[4]
            real = (order // k) < watch["length"]
            watch["dropped"][-1] += int((real & ~keep).sum())
        return out

    tf._moe_dispatch, tf.moe_route = dispatch, route
    try:
        yield
    finally:
        tf._moe_dispatch, tf.moe_route = saved


def moe_split(step, L: int) -> dict:
    """One traced call of ``step`` (warm): :func:`device_breakdown`, then a
    second traced call with each MoE sublayer inside a ``record_function``
    range: the device time of the kernels, copies and fills launched
    inside the ranges (matched by the launches' correlation ids in the
    profiler's Chrome trace) is the MoE's share of the busy time, and the
    ranges' host time its share of the step's host time."""
    trace = device_breakdown(step, top=10)
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = tf._moe_dispatch
    calls = [0]

    def ranged(*a, **kw):
        calls[0] += 1
        with record_function("moe_sublayer"):
            return saved(*a, **kw)

    tf._moe_dispatch = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        tf._moe_dispatch = saved
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "moe_step.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "moe_sublayer" and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans)}
    moe_ms = sum(e["dur"] for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e.get("args", {}).get("correlation") in launched) / 1e3
    host_ms = sum(b - a for a, b in spans) / 1e3
    if calls[0] != L or len(spans) != L or not moe_ms > 0:
        raise AssertionError(f"the traced step ran {calls[0]} MoE sublayers "
                             f"({len(spans)} ranges; want {L}) with "
                             f"{moe_ms} ms of device time")
    trace.update(moe_device_ms=moe_ms,
                 moe_share_of_busy=moe_ms / trace["device_busy_ms"],
                 moe_host_ms=host_ms, routing_host_syncs=calls[0])
    return trace


def moe_decode(dev, cfg, params) -> dict:
    """12a: Mixtral's fixed-batch greedy decode through ``serve_loop``, its
    logits within ``LOGIT_TOL`` of the run with the plain ring attention
    and the plain int8 kernels, tokens equal at a clear margin; then the
    same step at the same batch past the window, each row its own random
    prompt and tokens: every kernel call held against its plain version on
    its own inputs (:func:`kernels_held`), the tokens against the plain
    run's at a clear margin (:func:`against_plain`), timed and traced."""
    L, B, steps = cfg.n_layers, MOE_DECODE["batch"], MOE_DECODE["steps"]
    args = serve_args(arch=MOE_DECODE["arch"], batch=B,
                      cache_len=MOE_DECODE["cache_len"], steps=steps,
                      seed=MOE["seed"])
    watch = {"calls": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    with moe_watch(watch):
        run = serve.serve_loop(args, cfg, params, keep_logits=True)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    want = {"quantize_int8_into": L * steps, "dequantize_int8": 2 * L * steps,
            "ring_attention": L * steps, "quantize_int8": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"12a launches {launches}: want {want}")
    if watch["calls"] != L * steps:
        raise AssertionError(f"12a ran {watch['calls']} MoE sublayers")
    if run.logits.shape != (steps, B, cfg.vocab_size) or \
            not bool(torch.isfinite(run.logits).all()):
        raise AssertionError("12a logits not finite or of the wrong shape")
    with plain_ring(), plain_int8():
        plain = serve.serve_loop(args, cfg, params, keep_logits=True)
    gap = greedy_gap(run, plain, LOGIT_TOL)
    del plain
    check_gap("12a", gap)
    secs = run.step_seconds
    steady = float(np.median(secs[1:]))
    log(f"  12a decode: {steps} steps, batch {B}, median step "
        f"{steady * 1e3:.2f} ms ({B / steady:.1f} tokens/s), first "
        f"{secs[0]:.3f} s, peak {peak / 1e9:.2f} GB, launches {launches}; "
        f"against the plain ring attention and int8: logit error "
        f"{gap['err_share']:.3e} of max|logit| (limit {LOGIT_TOL:.3e}) over "
        f"{gap['steps']} steps, {gap['clear_tokens']} clear-margin tokens "
        f"equal, all tokens equal: {gap['same_tokens']}")
    del run
    # serve_loop starts every row at token 0, so its rows stay one stream
    # at positions 0..steps-1: the same step shape again, each row holding
    # its own random prompt past the window and fed its own random token a
    # step, as served text would route and read
    P = MOE_DECODE["prompt_len"]
    caches = fixed_prefilled(cfg, params, dev, B, MOE_DECODE["cache_len"],
                             P, MOE["seed"] + 5)
    gen = torch.Generator(device=dev).manual_seed(MOE["seed"] + 6)
    feed = [{"tokens": torch.randint(1, cfg.vocab_size, (B, 1),
                                     generator=gen, device=dev)}
            for _ in range(steps)]
    step = step_fns.make_serve_step(cfg)
    spread = []

    def run(cs, timed):
        out = []
        for inputs in feed:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            logits, cs = step(params, inputs, cs)
            torch.cuda.synchronize()
            if timed:
                spread.append(time.perf_counter() - ts)
            out.append(logits)
        return out, cs

    held = {}
    with kernels_held(held):
        run(clone_caches(caches), False)
    (got, caches), (want, _), routes = against_plain(
        run, (caches, True), (clone_caches(caches), False))
    fed = {**logit_gap(got, want, LOGIT_TOL), "moved_tokens": routes.moved,
           "moved_worst_margin": routes.worst_margin, "kernels": held}
    check_tokens("12a, a random prompt and token a row", fed)
    del got, want
    distinct = float(np.median(spread[1:]))
    ring = caches[0]["k"].shape[2]
    log(f"  12a with a random prompt of {P} tokens and a random token a "
        f"row (positions {P}..{P + steps - 1}, ring {ring}, window "
        f"{cfg.pattern[0][0].sliding_window}): median step "
        f"{distinct * 1e3:.2f} ms over {steps} steps; every kernel call "
        f"against its plain version on its own inputs: {held_line(held)}; "
        f"the logits against the plain run, routed as the kernels' run "
        f"({fed['moved_tokens']} router near-ties fell otherwise, margins "
        f"up to {fed['moved_worst_margin']:.3e}): error "
        f"{fed['err_share']:.3e} of max|logit|, {fed['clear_tokens']} "
        f"clear-margin tokens equal")
    trace = moe_split(lambda: step(params, feed[0], caches), L)
    log(f"  12a one step traced: "
        f"{trace['device_ops']} device operations, busy "
        f"{trace['device_busy_ms']:.2f} ms of {trace['traced_wall_ms']:.2f} "
        f"(idle {trace['device_idle_share']:.3f}); the MoE sublayers "
        f"{trace['moe_device_ms']:.2f} ms of device time "
        f"({trace['moe_share_of_busy']:.3f} of busy) and "
        f"{trace['moe_host_ms']:.2f} ms of host time, "
        f"{trace['routing_host_syncs']} routing host syncs a step: "
        f"{json.dumps(trace['top_kernels'])}")
    del caches, feed
    return {"launches": launches, "max_memory_bytes": peak,
            "median_step_s": steady, "first_step_s": secs[0],
            "tokens_per_s": B / steady, "vs_plain": gap,
            "distinct_rows_median_step_s": distinct,
            "distinct_rows_tokens_per_s": B / distinct,
            "distinct_rows_vs_plain": fed, "trace": trace,
            "routing_host_syncs_per_step": L}


class Routes:
    """The MoE routing of one run, to route a second run as the first did.
    A run under :meth:`record` keeps each router call's top-k ids, in call
    order; the same calls under :meth:`replay` take them, once every token
    whose own top-k differs is shown to sit at a near-tie of its router:
    two neighbours among its k+1 largest logits within ``LOGIT_TOL`` of the
    call's largest |logit|. The kernels and the plain versions round a
    hidden state differently, so such a tie may fall either way, and a
    token sent to another expert comes out another token; with the routing
    held, what is left between the two runs is the kernels' rounding."""

    def __init__(self):
        self.ids, self.moved, self.worst_margin = [], 0, 0.0

    @contextlib.contextmanager
    def _top_k(self, fn):
        saved = tf._top_k
        tf._top_k = fn
        try:
            yield
        finally:
            tf._top_k = saved

    def record(self):
        orig = tf._top_k

        def top_k(logits, k):
            v, i = orig(logits, k)
            self.ids.append(i)
            return v, i
        return self._top_k(top_k)

    def replay(self):
        orig, calls = tf._top_k, iter(self.ids)

        def top_k(logits, k):
            want = next(calls)
            v, mine = orig(logits, k + 1)
            gap = (v[..., :-1] - v[..., 1:]).amin(-1)
            differ = (mine[..., :k] != want).any(-1)
            if bool(differ.any()):
                margin = float(gap[differ].max() / logits.abs().amax())
                if not margin <= LOGIT_TOL:
                    raise AssertionError(
                        f"a token routed otherwise than in the kernels' run "
                        f"at a top-{k} margin of {margin:.3e} of max|logit| "
                        f"(a near-tie is within {LOGIT_TOL:.3e})")
                self.moved += int(differ.sum())
                self.worst_margin = max(self.worst_margin, margin)
            return torch.gather(logits, -1, want), want
        return self._top_k(top_k)


@contextlib.contextmanager
def kernels_held(worst: dict):
    """While the slot and decode paths run their kernels, hold every call
    of the three against its plain version on the same inputs: the fused
    write's ring bytes and scales (written by the plain version into
    copies) and the dequantize bitwise, ``ring_attention`` within
    ``FLASH_TOL`` by :func:`ring_err` over the queries with a position to
    read. ``worst`` gets each kernel's calls and its largest error (the
    count of differing elements for the bitwise two)."""
    into, deq, ring = saved = (quantize.quantize_int8_into,
                               quantize.dequantize_int8,
                               ring_attention.ring_attention)
    for name in ("quantize_int8_into", "dequantize_int8", "ring_attention"):
        worst.setdefault(name, {"calls": 0, "err": 0.0})

    def note(name: str, err: float, limit: float, what) -> None:
        worst[name]["calls"] += 1
        worst[name]["err"] = max(worst[name]["err"], err)
        if not err <= limit:
            raise AssertionError(f"{name} against its plain version at "
                                 f"{what}: error {err:.3e} > {limit:.1e}")

    def held_into(k, v, k_ring, v_ring, k_scale, v_scale, pos, n):
        rings = (k_ring, v_ring, k_scale, v_scale)
        copies = [t.clone() for t in rings]
        ref.quantize_int8_into_ref(k, v, *copies, pos, n)
        into(k, v, *rings, pos, n)
        note("quantize_int8_into",
             float(sum(int((a != b).sum()) for a, b in zip(rings, copies))),
             0.0, (tuple(k.shape), tuple(k_ring.shape)))

    def held_deq(q, scale, dtype=torch.float32):
        out = deq(q, scale, dtype)
        want = ref.dequantize_int8_ref(q, scale, dtype)
        note("dequantize_int8", float((out != want).sum()), 0.0,
             tuple(q.shape))
        return out

    def held_ring(q, k, v, plan, window=None, chunk=None):
        out = ring(q, k, v, plan, window, chunk)
        want = ref.ring_attention_ref(q, k, v, plan, window, chunk)
        keep = ring_attention.valid(plan, q.shape[1], k.shape[1], window,
                                    chunk)
        note("ring_attention", ring_err(out, want, keep),
             fa.FLASH_TOL[q.dtype],
             (tuple(q.shape), tuple(k.shape), window, chunk))
        return out

    # each wrapper counts its launches on the module's attribute
    for f in (held_into, held_deq, held_ring):
        f.launches = 0
    quantize.quantize_int8_into, quantize.dequantize_int8 = held_into, \
        held_deq
    ring_attention.ring_attention = held_ring
    try:
        yield
    finally:
        (quantize.quantize_int8_into, quantize.dequantize_int8,
         ring_attention.ring_attention) = saved


def against_plain(run, *args, held: dict | None = None) -> tuple:
    """``run(*args[0])`` with the kernels, then ``run(*args[1])`` with the
    plain ring attention, int8 and selective scan (each call its own
    arguments, where a call writes them), the second routed as the first
    (:class:`Routes`); with ``held``, the first under :func:`kernels_held`
    and :func:`scan_held`. Returns (kernels' result, plain result,
    routes)."""
    routes = Routes()
    with routes.record(), (kernels_held(held) if held is not None
                           else contextlib.nullcontext()), \
            (scan_held(held) if held is not None
             else contextlib.nullcontext()):
        got = run(*args[0])
    with routes.replay(), plain_ring(), plain_int8(), plain_scan():
        want = run(*args[1])
    return got, want, routes


def clone_caches(caches: tuple) -> tuple:
    return tuple({k: v.clone() for k, v in c.items()} for c in caches)


@torch.no_grad()
def fixed_prefilled(cfg, params, dev, B: int, cache_len: int, P: int,
                    seed: int) -> tuple:
    """Fixed-batch caches (``tf.init_cache``) at position ``P``, row ``b``
    holding its own ``P`` random tokens: prefilled with the kernels into
    per-slot caches of the same geometry, all rows in each call, in chunks
    of ``MOE_DECODE["prefill_chunk"]``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(1, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    caches = tf.init_cache(cfg, B, cache_len, device=dev, per_slot=True)
    C = MOE_DECODE["prefill_chunk"]
    for s in range(0, P, C):
        part = prompt[:, s:s + C]
        _, caches = tf.prefill_step(params, cfg, {"tokens": part}, caches,
                                    [part.shape[1]] * B, resume=s > 0)
    return tuple({**c, "pos": c["pos"][:, 0].clone()} for c in caches)


@torch.no_grad()
def slot_vs_plain(name: str, cfg, params, dev, spec: dict, plan: dict
                  ) -> dict:
    """Hold the slot path's kernels against their plain versions at the
    engine's shapes: per-slot caches of ``spec``'s geometry (the engine's
    ring slack), row ``b`` prefilled with the kernels with
    ``plan["lens"][b]`` distinct random tokens through the engine's
    prefill step, in its chunks and buckets; then row 0's next
    ``prefill_chunk`` random tokens as one chunk (across
    ``plan["across"]``), one decode tick and one verify tick of
    ``draft_headroom`` random drafts over every slot. Each of the three
    calls runs with the kernels, each kernel call held against its plain
    version on the same inputs (:func:`kernels_held`), and again from the
    same caches with the plain ring attention and int8, routed alike
    (:func:`against_plain`): the argmax equal at a clear margin, and the
    logits' error reported."""
    engine = ServingEngine(cfg, None, params, n_slots=spec["slots"],
                           max_len=spec["cache_len"],
                           prefill_chunk=spec["prefill_chunk"], device=dev)
    B, C, k = spec["slots"], engine.prefill_chunk, engine.draft_headroom
    caches = tf.init_cache(cfg, B, spec["cache_len"], device=dev,
                           per_slot=True, ring_slack=k)
    gen = torch.Generator(device=dev).manual_seed(plan["seed"])

    def rand(*shape):
        return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                             device=dev)

    for b, n in enumerate(plan["lens"]):
        prompt = rand(1, n)
        for s in range(0, n, C):
            part = prompt[:, s:s + C]
            buf = torch.zeros((1, engine._bucket(part.shape[1])),
                              dtype=torch.int64, device=dev)
            buf[:, :part.shape[1]] = part
            _, caches = engine._prefill(params, buf, caches, b,
                                        part.shape[1], resume=s > 0)
    start = int(caches[0]["pos"][0, 0])
    if not start < plan["across"] < start + C:
        raise AssertionError(f"{name}: the checked chunk {start}..."
                             f"{start + C - 1} does not cross "
                             f"{plan['across']}")
    gaps, held, act = {}, {}, np.ones(B, bool)
    calls = {
        "chunk": (lambda cs: tf.prefill_step(
            params, cfg, {"tokens": chunk}, tf.cache_row(cs, 0), [C],
            resume=True)),
        "decode": (lambda cs: tf.decode_step(
            params, cfg, {"tokens": tick}, cs, active=act)),
        "verify": (lambda cs: tf.verify_forward(
            params, cfg, {"tokens": drafts}, cs))}
    chunk, tick, drafts = rand(1, C), rand(B, 1), rand(B, k + 1)
    for what, call in calls.items():
        (got, rows), (want, _), routes = against_plain(
            call, (caches,), (clone_caches(caches),), held=held)
        if what == "chunk":
            caches = tf.splice_row_pos(caches, rows, 0)
        elif what == "decode":
            caches = rows
        gaps[what] = {**logit_gap([got], [want], LOGIT_TOL),
                      "moved_tokens": routes.moved,
                      "moved_worst_margin": routes.worst_margin}
        check_tokens(f"{name}'s {what}", gaps[what])
    pos = caches[0]["pos"][0].tolist()
    log(f"  {name}, the kernels against their plain versions at the "
        f"engine's shapes: a {C}-token chunk at {start}..."
        f"{start + C - 1} (across {plan['across']}), a decode tick and a "
        f"verify tick of {k + 1} tokens over {B} slots at positions {pos}; "
        f"every kernel call on its own inputs: {held_line(held)}; the "
        f"logits against the plain calls, routed as the kernels' "
        f"({sum(g['moved_tokens'] for g in gaps.values())} router near-ties "
        f"fell otherwise): error " + ", ".join(
            f"{w} {g['err_share']:.3e}" for w, g in gaps.items())
        + f" of max|logit|, "
        f"{sum(g['clear_tokens'] for g in gaps.values())} clear-margin "
        f"tokens equal")
    del caches, engine
    return {"chunk_start": start, "positions": pos, "gaps": gaps,
            "kernels": held}


def moe_workload(spec: dict, vocab: int, draft=None) -> list:
    return serve.synthetic_workload(
        spec["requests"], vocab, gap=spec["gap"], seed=spec["seed"],
        prompt_lens=spec["prompt_lens"], max_new=spec["max_new"],
        spec=draft, repetitive=spec.get("repetitive", False),
        shared_prefix=spec.get("shared_prefix", 0))


def moe_run(name: str, cfg, params, dev, spec: dict, draft=None,
            watch=None, **kw) -> tuple:
    """One engine run of ``spec``'s workload, the kernels' launches counted
    and held to one fused write and one ring attention per layer for every
    decode or verify tick and prefill chunk, two dequantizes each; every
    request ends with its budget. Returns (report, line)."""
    engine = ServingEngine(cfg, None, params, n_slots=spec["slots"],
                           max_len=spec["cache_len"],
                           prefill_chunk=spec["prefill_chunk"], device=dev,
                           **kw)
    reqs = moe_workload(spec, cfg.vocab_size, draft)
    watch = watch if watch is not None else {"calls": 0}
    if "dropped" in watch:
        prefill = engine._prefill

        def counted(params_, tokens, caches, slot, length, **kw_):
            watch["length"] = int(length)
            watch["dropped"].append(0)
            try:
                return prefill(params_, tokens, caches, slot, length, **kw_)
            finally:
                watch["length"] = None
        engine._prefill = counted
    torch.cuda.synchronize()
    zero_counters()
    with moe_watch(watch):
        rep = engine.run(reqs)
    torch.cuda.synchronize()
    launches = counters()
    L = cfg.n_layers
    calls = L * (rep["decode_ticks"] + rep["verify_ticks"]
                 + rep["prefill_chunks"])
    want = {"quantize_int8_into": calls, "dequantize_int8": 2 * calls,
            "ring_attention": calls, "quantize_int8": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{name} launches {launches}: want {want}")
    short = [r.rid for r in reqs if len(r.tokens) != r.max_new_tokens]
    if rep["requests"] != len(reqs) or short:
        raise AssertionError(f"{name}: requests {short} did not end with "
                             "their max_new_tokens")
    line = {"ticks": rep["ticks"], "decode_ticks": rep["decode_ticks"],
            "verify_ticks": rep["verify_ticks"],
            "prefill_chunks": rep["prefill_chunks"],
            "total_tokens": rep["total_tokens"], "wall_s": rep["wall_s"],
            "tokens_per_s": rep["tok_s"],
            "ttft_ticks_p50": rep["ttft_ticks_p50"],
            "ttft_ticks_p95": rep["ttft_ticks_p95"],
            "moe_calls": watch["calls"], "launches": launches}
    log(f"  {name}: {rep['ticks']} ticks ({rep['decode_ticks']} decode, "
        f"{rep['verify_ticks']} verify, {rep['prefill_chunks']} prefill "
        f"chunks), {rep['total_tokens']} tokens in {rep['wall_s']:.3f} s, "
        f"{rep['tok_s']:.2f} tokens/s; TTFT p50/p95 "
        f"{rep['ttft_ticks_p50']}/{rep['ttft_ticks_p95']} ticks; "
        f"{watch['calls']} MoE sublayer calls (one routing sync each)")
    del engine
    return rep, line


def add_launches(total: dict, line: dict) -> None:
    for k in WRAPPERS:
        total[k] += line["launches"][k]


def moe_phase(dev) -> dict:
    """12a-12c; returns each part's numbers and the launches of every main
    run (12a's kernel run, 12b's A, B and C, 12c's two runs)."""
    gc.collect()
    torch.cuda.empty_cache()
    res = {"launches": {k: 0 for k in WRAPPERS}}
    # ---- Mixtral-8x22B
    t0 = time.perf_counter()
    cfg = moe_config(MOE_DECODE["arch"])
    full = get_config(MOE_DECODE["arch"])
    log(f"  {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (depth cut "
        f"to fit one card; fewer layers make the host's share larger), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.hdim}, {cfg.moe.n_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, window "
        f"{cfg.pattern[0][0].sliding_window}; bf16 weights, int8 K/V")
    torch.cuda.reset_peak_memory_stats()
    ti = time.perf_counter()
    params = tf.init_params(cfg, MOE["seed"], dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - ti
    n, active = active_params(cfg, params)
    log(f"  weights drawn on the card in {init_s:.2f} s: {n} parameters "
        f"({active} active a token), {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB")
    mix = {"params": n, "active_params": active, "init_s": init_s}
    mix["decode"] = moe_decode(dev, cfg, params)
    add_launches(res["launches"], mix["decode"])
    log(f"  12a seconds {time.perf_counter() - t0:.2f}")
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    E = cfg.moe.n_experts
    full_cf = moe_config(MOE_DECODE["arch"], cf=E)
    runs = {}
    rep_a, runs["A"] = moe_run(f"12b A (FIFO, greedy, cf {E})", full_cf,
                               params, dev, MOE_SERVE)
    rep_b, runs["B"] = moe_run(
        f"12b B (n-gram speculation, k {MOE_SERVE['draft_k']})", full_cf,
        params, dev, MOE_SERVE, SpecParams(draft_k=MOE_SERVE["draft_k"]))
    same_streams(rep_b, rep_a, "12b B (speculation)")
    if not rep_b["verify_ticks"]:
        raise AssertionError("12b B ran no verify tick")
    runs["B"].update(drafted_tokens=rep_b["drafted_tokens"],
                     accepted_tokens=rep_b["accepted_tokens"])
    log(f"  12b B: streams bitwise A's; {rep_b['accepted_tokens']} of "
        f"{rep_b['drafted_tokens']} drafts accepted")
    drops = {"calls": 0, "dropped": []}
    rep_c, runs["C"] = moe_run(
        f"12b C (FIFO, greedy, cf {cfg.moe.capacity_factor})", cfg, params,
        dev, MOE_SERVE, watch=drops)
    per_chunk = drops["dropped"]
    runs["C"].update(dropped_per_chunk=per_chunk,
                     dropped_mean=float(np.mean(per_chunk)),
                     dropped_max=int(max(per_chunk)),
                     streams_equal_a=rep_c["tokens"] == rep_a["tokens"])
    log(f"  12b C: real tokens' (token, expert) slots dropped per prefill "
        f"chunk, summed over its {cfg.n_layers} layers: mean "
        f"{runs['C']['dropped_mean']:.1f}, max {runs['C']['dropped_max']} "
        f"over {len(per_chunk)} chunks; streams equal A's: "
        f"{runs['C']['streams_equal_a']}")
    for r in ("A", "B", "C"):
        add_launches(res["launches"], runs[r])
    vs_plain = slot_vs_plain("12b Mixtral", full_cf, params, dev, MOE_SERVE,
                             MOE_SLOT_CHECK)
    # A's per-tick stats rows as 8 replicas' sums, reduced on the card (b =
    # 1 at p = 8: the dual-root tree, combine3 on the card)
    rows = np.array([[getattr(t, f) for f in STATS_FIELDS]
                     for t in rep_a["steps"]], np.float32)
    replicas = np.stack([part.sum(0) for part in np.array_split(rows, 8)])
    zero_counters()
    summed = make_stats_reducer(LocalTransport(8, dev))(replicas)
    res["launches"]["combine3"] += counters()["combine3"]
    if not np.array_equal(summed, rows.sum(0)) or \
            not counters()["combine3"]:
        raise AssertionError(f"12b A's stats at p = 8: {summed} against "
                             f"numpy {rows.sum(0)}, combine3 launches "
                             f"{counters()['combine3']}")
    log(f"  12b A's stats of {len(rows)} ticks reduced over 8 replicas on "
        f"the card: numpy's sum, {counters()['combine3']} combine3 launches")
    mix["continuous"] = {"runs": runs, "vs_plain": vs_plain,
                         "max_memory_bytes": torch.cuda.max_memory_allocated(),
                         "seconds": time.perf_counter() - t1}
    log(f"  12b seconds {mix['continuous']['seconds']:.2f}, peak "
        f"{mix['continuous']['max_memory_bytes'] / 1e9:.2f} GB")
    mix["seconds"] = time.perf_counter() - t0
    res["mixtral"] = mix
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # ---- Llama-4 Scout
    t2 = time.perf_counter()
    full = get_config(SCOUT_SERVE["arch"])
    E = full.moe.n_experts
    cfg = moe_config(SCOUT_SERVE["arch"], cf=E)
    kinds = ["chunk" if s.chunk_size else "global NoPE"
             for layer in cfg.pattern for s in layer if s.kind == "attn"]
    log(f"  {cfg.name}: {cfg.n_layers} of {full.n_layers} layers ({kinds}), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.hdim}, {E} experts of d_ff {cfg.d_ff}, top-{cfg.moe.top_k} "
        f"at cf {E}, vocab {cfg.vocab_size}, chunk "
        f"{cfg.pattern[0][0].chunk_size}; bf16 weights, int8 K/V")
    torch.cuda.reset_peak_memory_stats()
    ti = time.perf_counter()
    params = tf.init_params(cfg, MOE["seed"], dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - ti
    n, active = active_params(cfg, params)
    log(f"  weights drawn on the card in {init_s:.2f} s: {n} parameters "
        f"({active} active a token)")
    scout = {"params": n, "active_params": active, "init_s": init_s,
             "runs": {}}
    rep_p, scout["runs"]["plain"] = moe_run("12c (FIFO, greedy)", cfg,
                                            params, dev, SCOUT_SERVE)
    rep_q, scout["runs"]["prefix"] = moe_run(
        "12c (prefix cache)", cfg, params, dev, SCOUT_SERVE,
        prefix_cache=True, prefix_cache_nodes=SCOUT_SERVE["prefix_nodes"])
    same_streams(rep_q, rep_p, "12c with the prefix cache")
    longest = max(len(r.prompt) for r in moe_workload(SCOUT_SERVE,
                                                      cfg.vocab_size))
    chunk = cfg.pattern[0][0].chunk_size
    if rep_q["prefix_hits"] < 1 or \
            rep_q["prefill_chunks"] >= rep_p["prefill_chunks"] or \
            longest <= chunk:
        raise AssertionError(f"12c: {rep_q['prefix_hits']} prefix hits, "
                             f"{rep_q['prefill_chunks']} chunks against "
                             f"{rep_p['prefill_chunks']}, longest prompt "
                             f"{longest} against the chunk {chunk}")
    scout["runs"]["prefix"].update(prefix_hits=rep_q["prefix_hits"],
                                   prefix_tokens_reused=rep_q[
                                       "prefix_tokens_reused"])
    log(f"  12c: streams with the prefix cache bitwise the plain run's "
        f"({rep_q['prefix_hits']} hits, {rep_q['prefix_tokens_reused']} "
        f"tokens reused), prompts up to {longest} tokens across the "
        f"{chunk}-token chunk boundary")
    for r in scout["runs"].values():
        add_launches(res["launches"], r)
    scout["vs_plain"] = slot_vs_plain("12c Scout", cfg, params, dev,
                                      SCOUT_SERVE, SCOUT_SLOT_CHECK)
    scout["max_memory_bytes"] = torch.cuda.max_memory_allocated()
    scout["seconds"] = time.perf_counter() - t2
    log(f"  12c seconds {scout['seconds']:.2f}, peak "
        f"{scout['max_memory_bytes'] / 1e9:.2f} GB")
    res["scout"] = scout
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# --------------------------------------------- RWKV-6 at full width and depth

def _first(tree, n: int):
    """The first ``n`` periods of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def rwkv_config():
    """RWKV-6 7B's decode config: every published width and all 32 layers,
    bf16 weights (its ``kv_quant`` has no K/V cache to touch)."""
    return decode_config(get_config(RWKV["arch"]))


@contextlib.contextmanager
def plain_wkv():
    """Run the WKV recurrence with its plain version in place of the kernel
    (the sublayer looks the wrapper up at each call)."""
    saved = wkv.wkv6
    wkv.wkv6 = ref.wkv6_recurrent_ref
    try:
        yield
    finally:
        wkv.wkv6 = saved


@contextlib.contextmanager
def wkv_held(worst: dict):
    """While the paths run the WKV kernel, hold every call against its
    plain version on the same inputs (:func:`wkv.wkv_errors` within
    ``WKV_TOL`` and ``WKV_STATE_TOL``). ``worst`` gets, for each kind of
    call (decode, chunk, verify), its calls and its largest errors."""
    kernel = wkv.wkv6

    def held(r, k, v, w_log, u, state, valid=None, collect=False):
        out = kernel(r, k, v, w_log, u, state, valid, collect)
        e_o, e_s = wkv.wkv_errors(out, r, k, v, w_log, u, state, valid,
                                  collect)
        what = "verify" if collect else ("decode" if r.shape[1] == 1
                                         else "chunk")
        w = worst.setdefault(what, {"calls": 0, "o_err": 0.0,
                                    "state_err": 0.0,
                                    "shape": list(r.shape)})
        w["calls"] += 1
        w["o_err"], w["state_err"] = max(w["o_err"], e_o), max(
            w["state_err"], e_s)
        if not (e_o <= wkv.WKV_TOL[r.dtype] and e_s <= wkv.WKV_STATE_TOL):
            raise AssertionError(
                f"wkv6 against its plain version at {what} "
                f"{tuple(r.shape)}: o error {e_o:.3e} (limit "
                f"{wkv.WKV_TOL[r.dtype]:.1e}), state error {e_s:.3e} "
                f"(limit {wkv.WKV_STATE_TOL:.1e})")
        return out

    held.launches = 0
    wkv.wkv6 = held
    try:
        yield
    finally:
        wkv.wkv6 = kernel


def wkv_line(held: dict) -> str:
    return ", ".join(f"{k} {v['calls']} calls {v['shape']}: o "
                     f"{v['o_err']:.2e}, state {v['state_err']:.2e}"
                     for k, v in held.items())


@torch.no_grad()
def rwkv_fed(cfg, params, dev, first, tokens) -> list:
    """The fixed-batch decode steps fed ``first`` and then a run's own
    ``tokens`` (B, steps) but its last: each step's logits."""
    step = step_fns.make_serve_step(cfg)
    caches = tf.init_cache(cfg, len(first), RWKV_DECODE["cache_len"],
                           device=dev)
    feed = torch.cat([torch.as_tensor(first)[:, None],
                      torch.as_tensor(tokens)[:, :-1]], 1).to(dev)
    out = []
    for t in range(feed.shape[1]):
        logits, caches = step(params, {"tokens": feed[:, t:t + 1]}, caches)
        out.append(logits)
    return out


def rwkv_decode(dev, cfg, params) -> dict:
    """13a: the fixed-batch loop through ``serve_loop``, each row from its
    own random first token: counted and timed; again with every kernel
    call held against its plain version; then the same steps fed the run's
    own tokens with the plain recurrence, its tokens equal at a clear
    margin."""
    L, B, steps = cfg.n_layers, RWKV_DECODE["batch"], RWKV_DECODE["steps"]
    args = serve_args(arch=RWKV["arch"], batch=B,
                      cache_len=RWKV_DECODE["cache_len"], steps=steps,
                      seed=RWKV["seed"])
    gen = torch.Generator().manual_seed(RWKV_DECODE["seed"])
    first = torch.randint(1, cfg.vocab_size, (B,), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    run = serve.serve_loop(args, cfg, params, keep_logits=True,
                           first_tokens=first)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    check_launches("13a", launches, path_want(cfg, steps))
    if run.logits.shape != (steps, B, cfg.vocab_size) or \
            not bool(torch.isfinite(run.logits).all()):
        raise AssertionError("13a logits not finite or of the wrong shape")
    if len(set(map(tuple, run.tokens.tolist()))) < B:
        raise AssertionError("13a: two rows gave one stream")
    held, th = {}, time.perf_counter()
    with wkv_held(held):
        again = serve.serve_loop(args, cfg, params, keep_logits=True,
                                 first_tokens=first)
    held_s = time.perf_counter() - th
    if not np.array_equal(again.tokens, run.tokens) or \
            not torch.equal(again.logits, run.logits):
        raise AssertionError("13a: the held run is not the counted run")
    del again
    tp = time.perf_counter()
    with plain_wkv():
        plain = rwkv_fed(cfg, params, dev, first, run.tokens)
    plain_s = time.perf_counter() - tp
    gap = logit_gap(list(run.logits), plain, LOGIT_TOL)
    del plain
    if gap["wrong_tokens"]:
        raise AssertionError(f"13a against the plain recurrence: {gap}")
    secs = run.step_seconds
    steady = float(np.median(secs[1:]))
    log(f"  13a decode: {steps} steps, batch {B} (each row from its own "
        f"token), median step {steady * 1e3:.2f} ms ({B / steady:.1f} "
        f"tokens/s), first {secs[0]:.3f} s, peak {peak / 1e9:.2f} GB, "
        f"launches {launches['wkv6']} wkv6; every kernel call against its "
        f"plain version: {wkv_line(held)}; the same steps fed the run's "
        f"tokens with the plain recurrence: logit error "
        f"{gap['err_share']:.3e} of max|logit|, {gap['clear_tokens']} of "
        f"{B * steps} tokens at a clear margin, all equal; the held run "
        f"{held_s:.2f} s, the plain run {plain_s:.2f} s")
    return {"launches": launches, "max_memory_bytes": peak,
            "median_step_s": steady, "first_step_s": secs[0],
            "tokens_per_s": B / steady, "vs_plain": gap, "kernels": held}


class ReplayDrafter(Drafter):
    """13b B's drafter: run A's own continuation of the request, with the
    token at ``(rid + done) % (k + 1)`` changed (none at k), ``done`` the
    tokens the request has. The verify calls then accept 1 to k + 1
    tokens, so their commits take every checkpoint index, where drafts
    from the request's text are not accepted on random weights. Its
    proposals depend on the request and its history alone."""

    def __init__(self, streams: dict, vocab: int):
        self.streams, self.vocab = streams, vocab

    def propose(self, slot: int, req, k: int) -> list:
        done = len(req.tokens)
        follow = [int(t) for t in self.streams[req.rid][done:done + k]]
        miss = (req.rid + done) % (k + 1)
        if miss < len(follow):
            follow[miss] = follow[miss] % (self.vocab - 1) + 1
        return follow


@contextlib.contextmanager
def released_carries(seen: dict, against: dict | None = None):
    """While an engine runs, each request's recurrent carries when it is
    released (after the prompt and all its tokens but the last; its cache
    row's carry caches, not its attention rings, whose slots past its
    position hold what the slot held before): kept in ``seen`` by request
    id, or, with ``against``, held bitwise to that run's (``seen`` gets
    True). Wraps ``EngineSession._release`` on the class, as
    :func:`fleet_watch` wraps ``tick``."""
    release = EngineSession._release

    def wrapped(self, slot, req, freed):
        row = [c for c in tf.cache_row(self.caches, slot) if "pos" not in c]
        if against is None:
            seen[req.rid] = tuple({k: v.clone() for k, v in c.items()}
                                  for c in row)
        else:
            if not all(torch.equal(c[k], w[k]) for c, w in
                       zip(row, against[req.rid]) for k in c):
                raise AssertionError(f"request {req.rid}'s carries at its "
                                     "release differ from run A's")
            seen[req.rid] = True
        return release(self, slot, req, freed)

    EngineSession._release = wrapped
    try:
        yield
    finally:
        EngineSession._release = release


@contextlib.contextmanager
def commits_seen(accepts: list):
    """Each verify commit's accepted counts on its active rows."""
    commit = tf.commit_verify_caches

    def wrapped(raw, old, accept, active=None):
        acc = np.asarray(accept).reshape(-1)
        rows = np.ones(len(acc), bool) if active is None else \
            np.asarray(active, bool).reshape(-1)
        accepts.extend(int(a) for a in acc[rows])
        return commit(raw, old, accept, active)

    tf.commit_verify_caches = wrapped
    try:
        yield
    finally:
        tf.commit_verify_caches = commit


def path_want(cfg, calls: int) -> dict:
    """Each kernel's launches for ``calls`` passes through a recurrent or
    hybrid stack (decode steps or ticks, verify ticks, prefill chunks): one
    ``wkv6`` an RWKV layer, one ``mamba_scan`` a Mamba layer, one fused K/V
    write, one ring attention and two dequantizes an attention layer (the
    int8 K/V cache), and nothing else."""
    kinds = tf.cache_layer_kinds(cfg)
    n = cfg.n_periods
    attns = kinds.count("attn") * n * calls
    want = {k: 0 for k in WRAPPERS}
    want.update(wkv6=kinds.count("rwkv") * n * calls,
                mamba_scan=kinds.count("mamba") * n * calls,
                quantize_int8_into=attns, dequantize_int8=2 * attns,
                ring_attention=attns)
    return want


def check_launches(what: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{what} launches {launches}: want {want}")


def slot_engine(spec: dict, cfg, params, dev, cache_len=None,
                **kw) -> ServingEngine:
    """The engine of ``spec`` (a phase's slots, ring and chunk), its ring
    ``cache_len`` where given."""
    return ServingEngine(cfg, None, params, n_slots=spec["slots"],
                         max_len=cache_len or spec["cache_len"],
                         prefill_chunk=spec["prefill_chunk"], device=dev,
                         **kw)


def carry_run(name: str, spec: dict, cfg, params, dev, reqs, **kw) -> tuple:
    """One run of ``spec``'s engine, the kernels' launches counted and held
    to :func:`path_want` of its decode and verify ticks and prefill chunks;
    every request ends with its budget. Returns (report, line)."""
    engine = slot_engine(spec, cfg, params, dev, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    launches = counters()
    check_launches(name, launches, path_want(
        cfg, rep["decode_ticks"] + rep["verify_ticks"]
        + rep["prefill_chunks"]))
    short = [r.rid for r in reqs if len(r.tokens) != r.max_new_tokens]
    if rep["requests"] != len(reqs) or short:
        raise AssertionError(f"{name}: requests {short} did not end with "
                             "their max_new_tokens")
    line = {"ticks": rep["ticks"], "decode_ticks": rep["decode_ticks"],
            "verify_ticks": rep["verify_ticks"],
            "prefill_chunks": rep["prefill_chunks"],
            "total_tokens": rep["total_tokens"], "wall_s": rep["wall_s"],
            "tokens_per_s": rep["tok_s"],
            "ttft_ticks_p50": rep["ttft_ticks_p50"],
            "ttft_ticks_p95": rep["ttft_ticks_p95"],
            "max_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches}
    log(f"  {name}: {rep['ticks']} ticks ({rep['decode_ticks']} decode, "
        f"{rep['verify_ticks']} verify, {rep['prefill_chunks']} prefill "
        f"chunks), {rep['total_tokens']} tokens in {rep['wall_s']:.3f} s, "
        f"{rep['tok_s']:.2f} tokens/s; TTFT p50/p95 "
        f"{rep['ttft_ticks_p50']}/{rep['ttft_ticks_p95']} ticks; peak "
        f"{line['max_memory_bytes'] / 1e9:.2f} GB")
    del engine
    return rep, line


def wkv_against_plain(run, *args, held: dict) -> tuple:
    """``run(*args[0])`` with the WKV kernel, every call held against its
    plain version (:func:`wkv_held`), then ``run(*args[1])`` with the
    plain recurrence. Returns (kernel's result, plain result, None)."""
    with wkv_held(held):
        got = run(*args[0])
    with plain_wkv():
        want = run(*args[1])
    return got, want, None


@torch.no_grad()
def carry_slot_check(tag: str, cfg, params, dev, spec: dict, check: dict,
                     against, held_text) -> dict:
    """The slot path's kernels against their plain versions at ``spec``'s
    engine's shapes: its slots prefilled with the kernels to
    ``check["lens"]`` (distinct random tokens) through the engine's
    prefill step, in its chunks and buckets; then row 0's next chunk, a
    decode tick and a verify call of ``draft_k + 1`` tokens (counts 1 to
    5) over every slot, each through ``against`` (every kernel call held
    against its plain version on its own inputs, then the same call from
    the same caches with the plain versions, routed alike where the model
    routes): the argmax equal at a clear margin, the logits' error
    reported; ``held_text`` writes the held calls' line."""
    engine = slot_engine(spec, cfg, params, dev)
    B, C = spec["slots"], engine.prefill_chunk
    k = spec["draft_k"]
    caches = tf.init_cache(cfg, B, spec["cache_len"], device=dev,
                           per_slot=True)
    gen = torch.Generator(device=dev).manual_seed(check["seed"])

    def rand(*shape):
        return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                             device=dev)

    tp = time.perf_counter()
    for b, n in enumerate(check["lens"]):
        prompt = rand(1, n)
        for s in range(0, n, C):
            part = prompt[:, s:s + C]
            buf = torch.zeros((1, engine._bucket(part.shape[1])),
                              dtype=torch.int64, device=dev)
            buf[:, :part.shape[1]] = part
            _, caches = engine._prefill(params, buf, caches, b,
                                        part.shape[1], resume=s > 0)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - tp
    act = np.ones(B, bool)
    counts = [1 + b % (k + 1) for b in range(B)]
    chunk, tick, drafts = rand(1, C), rand(B, 1), rand(B, k + 1)
    calls = {
        "chunk": lambda cs: tf.prefill_step(
            params, cfg, {"tokens": chunk}, tf.cache_row(cs, 0), [C],
            resume=True)[0],
        "decode": lambda cs: tf.decode_step(
            params, cfg, {"tokens": tick}, cs, active=act)[0],
        "verify": lambda cs: tf.verify_forward(
            params, cfg, {"tokens": drafts}, cs, lengths=counts,
            active=act)[0]}
    held, gaps = {}, {}
    for what, call in calls.items():
        got, want, routes = against(call, (clone_caches(caches),),
                                    (clone_caches(caches),), held=held)
        gaps[what] = logit_gap([got], [want], LOGIT_TOL)
        if routes is not None:
            gaps[what].update(moved_tokens=routes.moved,
                              moved_worst_margin=routes.worst_margin)
        check_tokens(f"{tag}'s {what}", gaps[what])
    moved = sum(g.get("moved_tokens", 0) for g in gaps.values())
    log(f"  {tag}, the kernels against their plain versions at the "
        f"engine's shapes: a {C}-token chunk after {check['lens'][0]} "
        f"tokens, a decode tick and a verify call of {k + 1} tokens "
        f"(counts {counts}) over {B} slots prefilled to "
        f"{list(check['lens'])}; every kernel call on its own inputs: "
        f"{held_text(held)}; the logits against the plain calls "
        f"({moved} router near-ties fell otherwise): error "
        + ", ".join(f"{w} {g['err_share']:.3e}" for w, g in gaps.items())
        + f" of max|logit|, "
        f"{sum(g['clear_tokens'] for g in gaps.values())} clear-margin "
        f"tokens equal; the slots prefilled in {prefill_s:.2f} s")
    del caches, engine
    return {"gaps": gaps, "kernels": held, "counts": counts}


def slot_bytes(caches: tuple, slot: int) -> int:
    return sum(v.numel() * v.element_size()
               for c in tf.cache_row(caches, slot) for v in c.values())


def rwkv_long(cfg, params, dev) -> dict:
    """13c: one request with a ``RWKV_LONG["prompt_len"]``-token prompt
    (chunks of 1024) and one of ``short_len``, each alone in the engine,
    16 new tokens each: the slot's cache bytes and the device memory in
    use when its prefill is done, equal for both (the O(1) state)."""
    out = {}
    gen = np.random.default_rng(RWKV_LONG["seed"])
    for what, n in (("long", RWKV_LONG["prompt_len"]),
                    ("short", RWKV_LONG["short_len"])):
        req = Request(0, tuple(int(t) for t in gen.integers(
            1, cfg.vocab_size, n)), max_new_tokens=RWKV_LONG["max_new"])
        engine = slot_engine(RWKV_SERVE, cfg, params, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        sess = engine.start([req])
        at_decode = None
        while sess.running:
            sess.tick()
            if at_decode is None and req.state.name == "ACTIVE":
                torch.cuda.synchronize()
                at_decode = {"slot_bytes": slot_bytes(sess.caches, 0),
                             "memory_allocated":
                                 torch.cuda.memory_allocated(),
                             "tick": sess.now}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rep = sess.report()
        if len(req.tokens) != req.max_new_tokens or at_decode is None:
            raise AssertionError(f"13c {what}: {len(req.tokens)} tokens")
        check_launches(f"13c {what}", counters(), path_want(
            cfg, rep["decode_ticks"] + rep["prefill_chunks"]))
        out[what] = {**at_decode, "prompt_len": n,
                     "prefill_chunks": rep["prefill_chunks"],
                     "ticks": rep["ticks"], "seconds": secs,
                     "max_memory_bytes": torch.cuda.max_memory_allocated(),
                     "launches": counters()["wkv6"]}
        del sess, engine
    if out["long"]["slot_bytes"] != out["short"]["slot_bytes"]:
        raise AssertionError(f"13c: slot bytes {out}")
    lg, sh = out["long"], out["short"]
    log(f"  13c: a {lg['prompt_len']}-token prompt in "
        f"{lg['prefill_chunks']} chunks, {lg['seconds']:.2f} s with "
        f"{RWKV_LONG['max_new']} new tokens; its slot holds {lg['slot_bytes']} bytes, as the "
        f"{sh['prompt_len']}-token request's ({sh['slot_bytes']}); device "
        f"memory in use at the first decode tick {lg['memory_allocated']} "
        f"against {sh['memory_allocated']} bytes, peaks "
        f"{lg['max_memory_bytes'] / 1e9:.2f} and "
        f"{sh['max_memory_bytes'] / 1e9:.2f} GB")
    return out


def wkv_shapes() -> dict:
    """``wkv6``'s calls on phase 13's main path, (B, T, collect): 13b's
    decode tick, 13a's step, 13b's verify call and a prefill chunk."""
    return {"decode": (RWKV_SERVE["slots"], 1, False),
            "decode_13a": (RWKV_DECODE["batch"], 1, False),
            "verify": (RWKV_SERVE["slots"], RWKV_SERVE["draft_k"] + 1, True),
            "chunk": (1, RWKV_SERVE["prefill_chunk"], False)}


def wkv_inputs(gen, B, T, H, K, collect, dev) -> tuple:
    """``wkv6``'s arguments at one shape, drawn on the card: bf16 r, k, v,
    the model's range of w_log, a nonzero state, every token valid."""
    r, k, v = (torch.randn((B, T, H, K), generator=gen, device=dev)
               .mul(0.5).to(torch.bfloat16) for _ in range(3))
    w_log = -torch.exp(torch.randn((B, T, H, K), generator=gen,
                                   device=dev) - 6.0)
    w_log = w_log.clamp(-8.0, -1e-4)
    u = torch.randn((H, K), generator=gen, device=dev) * 0.3
    S = torch.randn((B, H, K, K), generator=gen, device=dev) * 0.3
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    return r, k, v, w_log, u, S, valid, collect


def wkv_timings(dev, cfg) -> dict:
    """The kernel at the main path's shapes (13a's step, 13b's decode tick,
    its verify call and a 1024-token chunk, RWKV-6 7B's 64 heads of 64):
    against its plain version on the same inputs, timed (CUDA events; at
    the ticks also the profiler's device time a launch) beside its bound,
    the plain version's time and the wrapper's host cost a call; fails if
    ptxas spilled a register of any instantiation."""
    H, K = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    gen = torch.Generator(device=dev).manual_seed(24)
    out = {}
    for what, (B, T, collect) in wkv_shapes().items():
        args = wkv_inputs(gen, B, T, H, K, collect, dev)
        r = args[0]
        got = wkv.wkv6(*args)
        want = ref.wkv6_recurrent_ref(*args)
        e_o, e_s = wkv.wkv_errors(got, *args)
        if not (e_o <= wkv.WKV_TOL[r.dtype] and e_s <= wkv.WKV_STATE_TOL):
            raise AssertionError(f"wkv6 at the {what} shape: errors "
                                 f"{e_o:.3e}, {e_s:.3e}")
        abs_err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
        t_k = time_ms(lambda: wkv.wkv6(*args))
        # a tick's back-to-back events read the host's launch cost: its
        # device time a launch comes from the profiler
        dev_ms = device_ms(lambda: wkv.wkv6(*args)) if T == 1 else None
        host = host_ms(lambda: wkv.wkv6(*args))
        # the plain chunk is a Python loop of about 170 ms: one call a run
        t_p = time_ms(lambda: ref.wkv6_recurrent_ref(*args),
                      reps=1 if T > 8 else 20)
        nbytes, nops = wkv.work(B, T, H, K, 2, collect)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        out[what] = {"shape": [B, T, H, K], "collect": collect, "ms": t_k,
                     "device_ms": dev_ms, "host_ms": host,
                     "plan": wkv.plan(B, T, H, K, 2)._asdict(),
                     "plain_ms": t_p, "library_ms": None,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "ops": nops,
                     "o_err": e_o, "state_err": e_s, "max_abs_err": abs_err}
        log(f"  wkv6 {what} {[B, T, H, K]}{' collect' if collect else ''}: "
            f"kernel {t_k:.4f} ms"
            + (f" (device {dev_ms:.4f} ms a launch)" if dev_ms else "")
            + f", wrapper's host cost {host * 1e3:.2f} us a call, plain "
            f"{t_p:.4f} ms, bound {out[what]['bound_ms']:.5f} ms "
            f"({out[what]['bound_by']}); errors o {e_o:.2e}, state "
            f"{e_s:.2e}")
        del r, args, got, want
    ptxas = _build.ptxas_info("wkv6", "wkv6_kernel")
    spilled = [ln for ln in ptxas if "0 bytes spill stores" not in ln
               or "0 bytes spill loads" not in ln]
    if spilled:
        raise AssertionError(f"wkv6 spills registers: {spilled}")
    src, replaces = KERNEL_FILES["wkv6"]
    head = out["decode"]
    # a tick's time is its device time a launch, as the int8 rows'
    return {"name": "wkv6", "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(o["max_abs_err"] for o in out.values()),
            "ms": head["device_ms"], "events_ms": head["ms"],
            "host_ms": head["host_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": head["shape"],
            "ptxas": ptxas, "shapes": out}


def rwkv_phase(dev) -> dict:
    """13a-13c and the kernel's timings; returns each part's numbers and
    the kernel's launches over the main runs (13a's counted run, 13b's A,
    B and C, 13c's two)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch = launch_us(dev)
    log(f"  the host's cost of one small launch at the phase's start: "
        f"{launch:.2f} us")
    cfg = rwkv_config()
    H = cfg.d_model // cfg.rwkv_head_dim
    log(f"  {cfg.name}: {cfg.n_layers} layers (all), d_model "
        f"{cfg.d_model}, {H} heads of {cfg.rwkv_head_dim}, channel mix "
        f"{cfg.rwkv_cfg().d_cmix}, vocab {cfg.vocab_size}, untied "
        f"embeddings; bf16 weights")
    torch.cuda.reset_peak_memory_stats()
    ti = time.perf_counter()
    params = tf.init_params(cfg, RWKV["seed"], dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - ti
    n = sum(t.numel() for t in _leaves(params))
    log(f"  weights drawn on the card in {init_s:.2f} s: {n} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    res = {"params": n, "init_s": init_s, "launch_us": launch}
    ta = time.perf_counter()
    res["decode"] = rwkv_decode(dev, cfg, params)
    res["decode"]["seconds"] = time.perf_counter() - ta
    log(f"  13a seconds {res['decode']['seconds']:.2f}")
    launches = res["decode"]["launches"]["wkv6"]
    t1 = time.perf_counter()
    runs, rows_a, seen_b, seen_c, accepts = {}, {}, {}, {}, []
    k = RWKV_SERVE["draft_k"]
    with released_carries(rows_a):
        rep_a, runs["A"] = carry_run("13b A (FIFO, greedy)", RWKV_SERVE, cfg,
                                     params, dev,
                                     moe_workload(RWKV_SERVE, cfg.vocab_size))
    reqs = moe_workload(RWKV_SERVE, cfg.vocab_size,
                        SpecParams(draft_k=k, adapt=False))
    with released_carries(seen_b, rows_a), commits_seen(accepts):
        rep_b, runs["B"] = carry_run(
            f"13b B (speculation, k {k}, drafts replaying A's streams with "
            "one token changed)", RWKV_SERVE, cfg, params, dev, reqs,
            drafter=ReplayDrafter(rep_a["tokens"], cfg.vocab_size))
    same_streams(rep_b, rep_a, "13b B (speculation)")
    counts = {n: accepts.count(n) for n in range(1, k + 2)}
    if not rep_b["accepted_tokens"] or not all(counts.values()) or \
            len(seen_b) != len(reqs):
        raise AssertionError(f"13b B: {rep_b['accepted_tokens']} drafts "
                             f"accepted, commits of 1..{k + 1} tokens "
                             f"{counts}, {len(seen_b)} carries held")
    runs["B"].update(drafted_tokens=rep_b["drafted_tokens"],
                     accepted_tokens=rep_b["accepted_tokens"],
                     commits_by_tokens=counts)
    with released_carries(seen_c, rows_a):
        rep_c, runs["C"] = carry_run(
            "13b C (prefix cache)", RWKV_SERVE, cfg, params, dev,
            moe_workload(RWKV_SERVE, cfg.vocab_size), prefix_cache=True,
            prefix_cache_nodes=RWKV_SERVE["prefix_nodes"])
    same_streams(rep_c, rep_a, "13b C (prefix cache)")
    del rows_a
    if rep_c["prefix_hits"] < 1 or \
            rep_c["prefill_chunks"] >= rep_a["prefill_chunks"]:
        raise AssertionError(f"13b C: {rep_c['prefix_hits']} prefix hits, "
                             f"{rep_c['prefill_chunks']} chunks against "
                             f"{rep_a['prefill_chunks']}")
    runs["C"].update(prefix_hits=rep_c["prefix_hits"],
                     prefix_tokens_reused=rep_c["prefix_tokens_reused"])
    log(f"  13b: B's and C's streams bitwise A's, and each request's "
        f"carries at its release ({len(seen_b)} and {len(seen_c)}); B "
        f"accepted {rep_b['accepted_tokens']} of {rep_b['drafted_tokens']} "
        f"drafts, its commits by tokens kept {counts}; C "
        f"{rep_c['prefix_hits']} prefix hits, "
        f"{rep_c['prefix_tokens_reused']} tokens reused")
    launches += sum(r["launches"]["wkv6"] for r in runs.values())
    res["continuous"] = {"runs": runs,
                         "vs_plain": carry_slot_check(
                             "13b", cfg, params, dev, RWKV_SERVE,
                             RWKV_SLOT_CHECK, wkv_against_plain, wkv_line),
                         "seconds": time.perf_counter() - t1}
    res["continuous"]["vs_plain"]["seconds"] = \
        res["continuous"]["seconds"] - sum(r["wall_s"] for r in runs.values())
    log(f"  13b seconds {res['continuous']['seconds']:.2f}")
    tc = time.perf_counter()
    res["long"] = rwkv_long(cfg, params, dev)
    log(f"  13c seconds {time.perf_counter() - tc:.2f}")
    launches += sum(r["launches"] for r in res["long"].values())
    # one decode tick traced whole; a chunk through the first
    # RWKV_TRACE_LAYERS layers only (every layer runs the same kernels at
    # the same shapes): the profiler's processing of a whole chunk's 11,000
    # launches took about 10 s
    step_ticks = {}
    engine = slot_engine(RWKV_SERVE, cfg, params, dev)
    caches = tf.init_cache(cfg, RWKV_SERVE["slots"], RWKV_SERVE["cache_len"],
                           device=dev, per_slot=True)
    tick = {"tokens": torch.ones((RWKV_SERVE["slots"], 1), dtype=torch.int64,
                                 device=dev)}
    act = np.ones(RWKV_SERVE["slots"], bool)
    n = RWKV_TRACE_LAYERS
    cut = dataclasses.replace(cfg, n_layers=n)
    cut_params = {**params, "layers": [tuple(
        {k: _first(v, n) for k, v in sp.items()} for sp in layer)
        for layer in params["layers"]]}
    chunk = torch.ones((1, RWKV_SERVE["prefill_chunk"]), dtype=torch.int64,
                       device=dev)
    prefill = step_fns.make_prefill_step(cut)
    cut_caches = tf.init_cache(cut, 1, RWKV_SERVE["cache_len"], device=dev,
                               per_slot=True)
    ttr = time.perf_counter()
    step_ticks["decode"] = device_breakdown(
        lambda: engine._decode(params, tick, caches, act), cpu=False)
    step_ticks[f"chunk, {n} layers"] = device_breakdown(
        lambda: prefill(cut_params, chunk, cut_caches, 0, chunk.shape[1]),
        cpu=False)
    log(f"  13 traces seconds {time.perf_counter() - ttr:.2f}")
    for what, tr in step_ticks.items():
        log(f"  13 one {what} traced: {tr['device_ops']} device operations, "
            f"busy {tr['device_busy_ms']:.2f} ms of "
            f"{tr['traced_wall_ms']:.2f} (idle "
            f"{tr['device_idle_share']:.3f}): "
            f"{json.dumps(tr['top_kernels'][:5])}")
    res["traces"] = step_ticks
    del engine, caches, params, cut_params, cut_caches
    gc.collect()
    torch.cuda.empty_cache()
    tt = time.perf_counter()
    res["wkv6"] = wkv_timings(dev, cfg)
    log(f"  13 timings seconds {time.perf_counter() - tt:.2f}")
    res["launches"] = {"wkv6": launches}
    res["seconds"] = time.perf_counter() - t0
    return res


# ------------------------------ Jamba-v0.1 (the Mamba mixer) at full width

def jamba_config(cf: float | None = None):
    """Jamba-v0.1's decode config (bf16 weights) cut to ``JAMBA["layers"]``
    layers (one period: 7 Mamba and 1 attention layer, 4 MoE and 4 MLP,
    each at its published place), the int8 K/V cache forced on, at
    capacity factor ``cf`` (the config's own where None)."""
    cfg = decode_config(get_config(JAMBA["arch"]))
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=float(cf))
    return dataclasses.replace(cfg, n_layers=JAMBA["layers"], kv_quant=True,
                               moe=moe)


@contextlib.contextmanager
def plain_scan():
    """Run the selective scan with its plain version in place of the kernel
    (the sublayer looks the wrapper up at each call)."""
    saved = mamba_scan.mamba_scan
    mamba_scan.mamba_scan = ref.mamba_scan_recurrent_ref
    try:
        yield
    finally:
        mamba_scan.mamba_scan = saved


@contextlib.contextmanager
def scan_held(worst: dict):
    """While the paths run the scan kernel, hold every call against its
    plain version on the same inputs (:func:`mamba_scan.scan_errors` within
    ``SCAN_TOL`` and ``SCAN_STATE_TOL``). ``worst["mamba_scan"]`` gets, for
    each kind of call (decode, chunk, verify), its calls and its largest
    errors."""
    kernel = mamba_scan.mamba_scan

    def held(dt, dtx, Bm, C, A, state, valid=None, collect=False):
        out = kernel(dt, dtx, Bm, C, A, state, valid, collect)
        kinds = worst.setdefault("mamba_scan", {})
        e_y, e_s = mamba_scan.scan_errors(out, dt, dtx, Bm, C, A, state,
                                          valid, collect)
        what = "verify" if collect else ("decode" if dt.shape[1] == 1
                                         else "chunk")
        w = kinds.setdefault(what, {"calls": 0, "y_err": 0.0,
                                    "state_err": 0.0,
                                    "shape": list(dt.shape)})
        w["calls"] += 1
        w["y_err"], w["state_err"] = max(w["y_err"], e_y), max(
            w["state_err"], e_s)
        if not (e_y <= mamba_scan.SCAN_TOL and
                e_s <= mamba_scan.SCAN_STATE_TOL):
            raise AssertionError(
                f"mamba_scan against its plain version at {what} "
                f"{tuple(dt.shape)}: y error {e_y:.3e} (limit "
                f"{mamba_scan.SCAN_TOL:.1e}), state error {e_s:.3e} (limit "
                f"{mamba_scan.SCAN_STATE_TOL:.1e})")
        return out

    held.launches = 0
    mamba_scan.mamba_scan = held
    try:
        yield
    finally:
        mamba_scan.mamba_scan = kernel


def jamba_held_line(held: dict) -> str:
    scan = held.get("mamba_scan", {})
    rest = {k: v for k, v in held.items() if k != "mamba_scan"}
    return ", ".join(
        [f"mamba_scan {k} {v['calls']} calls {v['shape']}: y "
         f"{v['y_err']:.2e}, state {v['state_err']:.2e}"
         for k, v in scan.items()] + [held_line(rest)])


def jamba_decode(dev, cfg, params) -> dict:
    """14a: the fixed-batch loop through ``serve_loop``, each row from its
    own random first token: counted and timed; again with every kernel
    call held against its plain version on its own inputs (the routing
    recorded), equal to the counted run bitwise; then the same steps fed
    the run's own tokens with the plain scan, ring attention and int8,
    routed as the held run: its tokens equal at a clear margin."""
    B, steps = JAMBA_DECODE["batch"], JAMBA_DECODE["steps"]
    args = serve_args(arch=JAMBA["arch"], batch=B,
                      cache_len=JAMBA_DECODE["cache_len"], steps=steps,
                      seed=JAMBA["seed"])
    gen = torch.Generator().manual_seed(JAMBA_DECODE["seed"])
    first = torch.randint(1, cfg.vocab_size, (B,), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    run = serve.serve_loop(args, cfg, params, keep_logits=True,
                           first_tokens=first)
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    check_launches("14a", launches, path_want(cfg, steps))
    if run.logits.shape != (steps, B, cfg.vocab_size) or \
            not bool(torch.isfinite(run.logits).all()):
        raise AssertionError("14a logits not finite or of the wrong shape")
    if len(set(map(tuple, run.tokens.tolist()))) < B:
        raise AssertionError("14a: two rows gave one stream")
    step = step_fns.make_serve_step(cfg)
    feed = torch.cat([first[:, None], torch.as_tensor(run.tokens)[:, :-1]],
                     1).to(dev)

    def fed():
        caches = tf.init_cache(cfg, B, JAMBA_DECODE["cache_len"],
                               device=dev)
        out = []
        with torch.no_grad():
            for t in range(steps):
                logits, caches = step(params, {"tokens": feed[:, t:t + 1]},
                                      caches)
                out.append(logits)
        return out

    held, th = {}, time.perf_counter()
    (got, want, routes) = against_plain(fed, (), (), held=held)
    held_s = time.perf_counter() - th
    if not torch.equal(torch.stack(got), run.logits):
        raise AssertionError("14a: the held run is not the counted run")
    gap = {**logit_gap(got, want, LOGIT_TOL), "moved_tokens": routes.moved,
           "moved_worst_margin": routes.worst_margin}
    del got, want
    check_tokens("14a", gap)
    secs = run.step_seconds
    steady = float(np.median(secs[1:]))
    log(f"  14a decode: {steps} steps, batch {B} (each row from its own "
        f"token), median step {steady * 1e3:.2f} ms ({B / steady:.1f} "
        f"tokens/s), first {secs[0]:.3f} s, peak {peak / 1e9:.2f} GB, "
        f"launches {launches}; every kernel call against its plain version: "
        f"{jamba_held_line(held)}; the same steps with the plain scan, ring "
        f"attention and int8, routed alike ({gap['moved_tokens']} router "
        f"near-ties fell otherwise): logit error {gap['err_share']:.3e} of "
        f"max|logit|, {gap['clear_tokens']} of {B * steps} tokens at a "
        f"clear margin, all equal; the held and plain runs {held_s:.2f} s")
    return {"launches": launches, "max_memory_bytes": peak,
            "median_step_s": steady, "first_step_s": secs[0],
            "tokens_per_s": B / steady, "vs_plain": gap, "kernels": held}


def carry_bytes(caches: tuple, slot: int) -> tuple:
    """(a slot's bytes in its carry caches, its attention rings' bytes a
    cached position, its positions)."""
    row = tf.cache_row(caches, slot)
    carries = sum(v.numel() * v.element_size() for c in row
                  if "pos" not in c for v in c.values())
    per_pos = sum(v[:, :, :1].numel() * v.element_size() for c in row
                  if "pos" in c for k, v in c.items() if k != "pos")
    pos = [int(c["pos"][0, 0]) for c in row if "pos" in c]
    return carries, per_pos, pos


def jamba_long(cfg, params, dev) -> dict:
    """14c: one request with a ``JAMBA_LONG["prompt_len"]``-token prompt
    (chunks of 1024) and one of ``short_len``, each alone in the engine,
    16 new tokens each: once its prompt is in, the slot's Mamba carries
    hold the same bytes for both, and its attention ring a position for
    each token of the prompt and of its stream but the last."""
    out = {}
    gen = np.random.default_rng(JAMBA_LONG["seed"])
    for what, n in (("long", JAMBA_LONG["prompt_len"]),
                    ("short", JAMBA_LONG["short_len"])):
        req = Request(0, tuple(int(t) for t in gen.integers(
            1, cfg.vocab_size, n)), max_new_tokens=JAMBA_LONG["max_new"])
        engine = slot_engine(JAMBA_SERVE, cfg, params, dev,
                             cache_len=JAMBA_LONG["cache_len"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        sess = engine.start([req])
        at_decode = None
        while sess.running:
            sess.tick()
            if at_decode is None and req.state.name == "ACTIVE":
                torch.cuda.synchronize()
                carries, per_pos, pos = carry_bytes(sess.caches, 0)
                at_decode = {"carry_bytes": carries, "ring_positions": pos,
                             "emitted": len(req.tokens),
                             "ring_bytes_in_use": per_pos * pos[0],
                             "memory_allocated":
                                 torch.cuda.memory_allocated(),
                             "tick": sess.now}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rep = sess.report()
        if len(req.tokens) != req.max_new_tokens or at_decode is None:
            raise AssertionError(f"14c {what}: {len(req.tokens)} tokens")
        check_launches(f"14c {what}", counters(), path_want(
            cfg, rep["decode_ticks"] + rep["prefill_chunks"]))
        out[what] = {**at_decode, "prompt_len": n,
                     "prefill_chunks": rep["prefill_chunks"],
                     "ticks": rep["ticks"], "seconds": secs,
                     "max_memory_bytes": torch.cuda.max_memory_allocated(),
                     "launches": counters()}
        del sess, engine
    lg, sh = out["long"], out["short"]
    if lg["carry_bytes"] != sh["carry_bytes"] or any(
            o["ring_positions"] != [o["prompt_len"] + o["emitted"] - 1]
            for o in out.values()):
        raise AssertionError(f"14c: {out}")
    log(f"  14c: a {lg['prompt_len']}-token prompt in "
        f"{lg['prefill_chunks']} chunks, {lg['seconds']:.2f} s with "
        f"{JAMBA_LONG['max_new']} new tokens; its slot's Mamba carries hold "
        f"{lg['carry_bytes']} bytes, as the {sh['prompt_len']}-token "
        f"request's ({sh['carry_bytes']}); its ring holds "
        f"{lg['ring_bytes_in_use']} bytes of positions against "
        f"{sh['ring_bytes_in_use']}; device memory in use at the first "
        f"decode tick {lg['memory_allocated']} against "
        f"{sh['memory_allocated']} bytes, peaks "
        f"{lg['max_memory_bytes'] / 1e9:.2f} and "
        f"{sh['max_memory_bytes'] / 1e9:.2f} GB")
    return out


def scan_shapes() -> dict:
    """``mamba_scan``'s calls on phase 14's main path, (B, T, collect):
    14b's decode tick, 14a's step, 14b's verify call and a prefill
    chunk."""
    return {"decode": (JAMBA_SERVE["slots"], 1, False),
            "decode_14a": (JAMBA_DECODE["batch"], 1, False),
            "verify": (JAMBA_SERVE["slots"], JAMBA_SERVE["draft_k"] + 1,
                       True),
            "chunk": (1, JAMBA_SERVE["prefill_chunk"], False)}


def scan_inputs(gen, B, T, Di, N, collect, dev) -> tuple:
    """``mamba_scan``'s arguments at one shape, drawn on the card: dt in a
    softplus's range, dtx, B and C, Jamba's A (-1 to -N a channel), a
    nonzero state, every token valid."""
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, Di), generator=gen, device=dev) - 4.0)
    dtx = dt * torch.randn((B, T, Di), generator=gen, device=dev)
    Bm, C = (torch.randn((B, T, N), generator=gen, device=dev)
             for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(Di, N).contiguous()
    S = torch.randn((B, Di, N), generator=gen, device=dev) * 0.3
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    return dt, dtx, Bm, C, A, S, valid, collect


def scan_timings(dev, cfg) -> dict:
    """The kernel at the main path's shapes (14b's decode tick, 14a's step,
    the verify call and a 1024-token chunk, Jamba's 8192 channels of 16
    states), each under the launch ``mamba_scan.plan`` gives it (logged):
    against its plain version on the same inputs, timed (CUDA events; at
    the ticks and the verify call also the profiler's device time a
    launch) beside its bound, the plain version's time and the wrapper's
    host cost a call; fails if ptxas spilled a register of any of the
    kernel's eight instantiations (the staged and the direct path, N 8 and
    16, each with and without collect) or reported fewer."""
    m = cfg.mamba_cfg()
    Di, N = m.d_inner, m.d_state
    gen = torch.Generator(device=dev).manual_seed(26)
    out = {}
    for what, (B, T, collect) in scan_shapes().items():
        args = scan_inputs(gen, B, T, Di, N, collect, dev)
        got = mamba_scan.mamba_scan(*args)
        want = ref.mamba_scan_recurrent_ref(*args)
        e_y, e_s = mamba_scan.scan_errors(got, *args)
        if not (e_y <= mamba_scan.SCAN_TOL and
                e_s <= mamba_scan.SCAN_STATE_TOL):
            raise AssertionError(f"mamba_scan at the {what} shape: errors "
                                 f"{e_y:.3e}, {e_s:.3e}")
        abs_err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
        t_k = time_ms(lambda: mamba_scan.mamba_scan(*args))
        # a tick's and a verify call's back-to-back events read the host's
        # launch cost: their device time a launch comes from the profiler
        dev_ms = device_ms(lambda: mamba_scan.mamba_scan(*args)) \
            if T == 1 or collect else None
        host = host_ms(lambda: mamba_scan.mamba_scan(*args))
        launch = mamba_scan.plan(B, T, Di, N)._asdict()
        # the plain chunk is a Python loop of some 6,000 launches: one call
        t_p = time_ms(lambda: ref.mamba_scan_recurrent_ref(*args),
                      reps=1 if T > 8 else 20)
        nbytes, nops = mamba_scan.work(B, T, Di, N, collect)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        out[what] = {"shape": [B, T, Di, N], "collect": collect, "ms": t_k,
                     "device_ms": dev_ms, "host_ms": host, "plan": launch,
                     "plain_ms": t_p,
                     "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "ops": nops,
                     "y_err": e_y, "state_err": e_s, "max_abs_err": abs_err}
        log(f"  mamba_scan {what} {[B, T, Di, N]}"
            f"{' collect' if collect else ''}: kernel {t_k:.4f} ms"
            + (f" (device {dev_ms:.4f} ms a launch)" if dev_ms else "")
            + f", wrapper's host cost {host * 1e3:.2f} us a call, plain "
            f"{t_p:.4f} ms, bound {out[what]['bound_ms']:.5f} ms "
            f"({out[what]['bound_by']}); errors y {e_y:.2e}, state "
            f"{e_s:.2e}; plan {json.dumps(launch)}")
        del args, got, want
    ptxas = [line for path in ("mamba_scan_staged", "mamba_scan_direct")
             for line in _build.ptxas_info("mamba_scan", path)]
    spilled = [ln for ln in ptxas if "0 bytes spill stores" not in ln
               or "0 bytes spill loads" not in ln]
    if spilled or len(ptxas) != 4 * len(mamba_scan.D_STATES):
        raise AssertionError(f"mamba_scan spills registers or lacks an "
                             f"instantiation: {ptxas}")
    src, replaces = KERNEL_FILES["mamba_scan"]
    head = out["decode"]
    # a tick's time is its device time a launch, as wkv6's
    return {"name": "mamba_scan", "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(o["max_abs_err"] for o in out.values()),
            "ms": head["device_ms"], "events_ms": head["ms"],
            "host_ms": head["host_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": head["shape"],
            "ptxas": ptxas, "shapes": out}


def jamba_phase(dev) -> dict:
    """14a-14c and the scan's timings; returns each part's numbers and the
    kernels' launches over the main runs (14a's counted run, 14b's A, B
    and C, 14c's two)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch = launch_us(dev)
    log(f"  the host's cost of one small launch at the phase's start: "
        f"{launch:.2f} us")
    cfg = jamba_config()
    full = get_config(JAMBA["arch"])
    m = cfg.mamba_cfg()
    kinds = [s.kind for layer in cfg.pattern for s in layer]
    log(f"  {cfg.name}: {cfg.n_layers} of {full.n_layers} layers (one "
        f"period: {kinds.count('mamba')} Mamba, {kinds.count('attn')} "
        f"attention, {kinds.count('moe')} MoE, {kinds.count('mlp')} MLP; "
        f"depth cut to fit one card), d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hdim}, {cfg.moe.n_experts} "
        f"experts of d_ff {cfg.d_ff}, top-{cfg.moe.top_k}, vocab "
        f"{cfg.vocab_size}, untied embeddings; Mamba d_inner {m.d_inner}, "
        f"d_state {m.d_state}, dt_rank {m.dt_rank}, d_conv {m.d_conv}; bf16 "
        f"weights, int8 K/V")
    torch.cuda.reset_peak_memory_stats()
    ti = time.perf_counter()
    params = tf.init_params(cfg, JAMBA["seed"], dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - ti
    n, active = active_params(cfg, params)
    log(f"  weights drawn on the card in {init_s:.2f} s: {n} parameters "
        f"({active} active a token), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    res = {"params": n, "active_params": active, "init_s": init_s,
           "launch_us": launch}
    ta = time.perf_counter()
    res["decode"] = jamba_decode(dev, cfg, params)
    res["decode"]["seconds"] = time.perf_counter() - ta
    log(f"  14a seconds {res['decode']['seconds']:.2f}")
    launches = dict(res["decode"]["launches"])
    t1 = time.perf_counter()
    E = cfg.moe.n_experts
    ecfg = jamba_config(cf=E)
    runs, rows_a, seen_b, seen_c, accepts = {}, {}, {}, {}, []
    k = JAMBA_SERVE["draft_k"]
    with released_carries(rows_a):
        rep_a, runs["A"] = carry_run(f"14b A (FIFO, greedy, cf {E})",
                                     JAMBA_SERVE, ecfg, params, dev,
                                     moe_workload(JAMBA_SERVE,
                                                  cfg.vocab_size))
    reqs = moe_workload(JAMBA_SERVE, cfg.vocab_size,
                        SpecParams(draft_k=k, adapt=False))
    with released_carries(seen_b, rows_a), commits_seen(accepts):
        rep_b, runs["B"] = carry_run(
            f"14b B (speculation, k {k}, drafts replaying A's streams with "
            "one token changed)", JAMBA_SERVE, ecfg, params, dev, reqs,
            drafter=ReplayDrafter(rep_a["tokens"], cfg.vocab_size))
    same_streams(rep_b, rep_a, "14b B (speculation)")
    counts = {c: accepts.count(c) for c in range(1, k + 2)}
    if not rep_b["accepted_tokens"] or not all(counts.values()) or \
            len(seen_b) != len(reqs):
        raise AssertionError(f"14b B: {rep_b['accepted_tokens']} drafts "
                             f"accepted, commits of 1..{k + 1} tokens "
                             f"{counts}, {len(seen_b)} carries held")
    runs["B"].update(drafted_tokens=rep_b["drafted_tokens"],
                     accepted_tokens=rep_b["accepted_tokens"],
                     commits_by_tokens=counts)
    with released_carries(seen_c, rows_a):
        rep_c, runs["C"] = carry_run(
            "14b C (prefix cache)", JAMBA_SERVE, ecfg, params, dev,
            moe_workload(JAMBA_SERVE, cfg.vocab_size), prefix_cache=True,
            prefix_cache_nodes=JAMBA_SERVE["prefix_nodes"])
    same_streams(rep_c, rep_a, "14b C (prefix cache)")
    del rows_a
    if rep_c["prefix_hits"] < 1 or \
            rep_c["prefill_chunks"] >= rep_a["prefill_chunks"] or \
            len(seen_c) != len(reqs):
        raise AssertionError(f"14b C: {rep_c['prefix_hits']} prefix hits, "
                             f"{rep_c['prefill_chunks']} chunks against "
                             f"{rep_a['prefill_chunks']}, {len(seen_c)} "
                             "carries held")
    runs["C"].update(prefix_hits=rep_c["prefix_hits"],
                     prefix_tokens_reused=rep_c["prefix_tokens_reused"])
    log(f"  14b: B's and C's streams bitwise A's, and each request's Mamba "
        f"carries at its release ({len(seen_b)} and {len(seen_c)}); B "
        f"accepted {rep_b['accepted_tokens']} of {rep_b['drafted_tokens']} "
        f"drafts, its commits by tokens kept {counts}; C "
        f"{rep_c['prefix_hits']} prefix hits, "
        f"{rep_c['prefix_tokens_reused']} tokens reused")
    for r in runs.values():
        for name, c in r["launches"].items():
            launches[name] += c
    res["continuous"] = {"runs": runs,
                         "vs_plain": carry_slot_check(
                             "14b", ecfg, params, dev, JAMBA_SERVE,
                             JAMBA_SLOT_CHECK, against_plain,
                             jamba_held_line),
                         "seconds": time.perf_counter() - t1}
    res["continuous"]["vs_plain"]["seconds"] = \
        res["continuous"]["seconds"] - sum(r["wall_s"] for r in runs.values())
    log(f"  14b seconds {res['continuous']['seconds']:.2f}")
    tc = time.perf_counter()
    res["long"] = jamba_long(ecfg, params, dev)
    log(f"  14c seconds {time.perf_counter() - tc:.2f}")
    for r in res["long"].values():
        for name, c in r["launches"].items():
            launches[name] += c
    # one decode tick over 8 active slots and one 1024-token chunk, traced
    traces = {}
    engine = slot_engine(JAMBA_SERVE, ecfg, params, dev)
    caches = tf.init_cache(ecfg, JAMBA_SERVE["slots"],
                           JAMBA_SERVE["cache_len"], device=dev,
                           per_slot=True)
    tick = {"tokens": torch.ones((JAMBA_SERVE["slots"], 1),
                                 dtype=torch.int64, device=dev)}
    act = np.ones(JAMBA_SERVE["slots"], bool)
    chunk = torch.randint(1, cfg.vocab_size,
                          (1, JAMBA_SERVE["prefill_chunk"]), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              27))
    prefill = step_fns.make_prefill_step(ecfg)
    ttr = time.perf_counter()
    traces["decode"] = device_breakdown(
        lambda: engine._decode(params, tick, caches, act), top=10,
        match="mamba_scan")
    traces["chunk"] = device_breakdown(
        lambda: prefill(params, chunk, caches, 0, chunk.shape[1]), top=10,
        match="mamba_scan")
    log(f"  14 traces seconds {time.perf_counter() - ttr:.2f}")
    for what, tr in traces.items():
        scan_ms = tr["mamba_scan_ms"] = tr.pop("matched_ms")
        log(f"  14 one {what} traced: {tr['device_ops']} device operations, "
            f"busy {tr['device_busy_ms']:.2f} ms of "
            f"{tr['traced_wall_ms']:.2f} (idle "
            f"{tr['device_idle_share']:.3f}); mamba_scan {scan_ms:.3f} ms: "
            f"{json.dumps(tr['top_kernels'])}")
    res["traces"] = traces
    del engine, caches, params
    gc.collect()
    torch.cuda.empty_cache()
    tt = time.perf_counter()
    res["mamba_scan"] = scan_timings(dev, cfg)
    log(f"  14 timings seconds {time.perf_counter() - tt:.2f}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    return res


def launch_us(dev) -> float:
    """The host's cost of one small launch, in microseconds: 2,000 adds on
    16 elements of the card, no sync between them, after 100 unclocked.
    Phase 13's walls are the host's and follow it."""
    a = torch.zeros(16, device=dev)
    for _ in range(100):
        a = a + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        a = a + 1
    cost = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return cost


PHASES = tuple(range(1, 15))
# a phase that needs another's results: phase 8 reads phase 7's peak
# memory, phases 9 and 10 extend phase 4's row of the fused K/V write
NEEDS = {8: (7,), 9: (4,), 10: (4,)}


def phases_from(only: str | None) -> set:
    """The phases to run: all of them (the default), or those ``only``
    names ("13", "4,9-11"), with the phases they need."""
    if only is None:
        return set(PHASES)
    want = set()
    for part in only.split(","):
        lo, _, hi = part.strip().partition("-")
        want.update(range(int(lo), int(hi or lo) + 1))
    if not want <= set(PHASES):
        raise SystemExit(f"--only: phases {sorted(want - set(PHASES))} do "
                         f"not exist (1 to {PHASES[-1]})")
    for n in sorted(want, reverse=True):
        want.update(NEEDS.get(n, ()))
    return want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run only these phases, as '13' or '4,9-11' (and "
                         "the phases they need); default: every phase")
    run = phases_from(ap.parse_args(argv).only)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; phases {sorted(run)}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")

    rows, main_launches = {}, {k: 0 for k in WRAPPERS}
    if 1 in run:
        nb = cost_model.optimal_blocks(P_FULL, float(M_FULL * 4),
                                       cost_model.PAPER_HYDRA, "dptree")
        blk = -(-M_FULL // nb)
        wire = (P_FULL, M_FULL // 8)    # hier's slow-stage stripe, per rank
        log("phase 1: kernels")
        rows = kernel_phase(dev, P_FULL * blk, (P_FULL, blk), wire)
    if 2 in run:
        log("phase 2: collectives, every method")
        small_phase(dev)
    if 3 in run:
        log("phase 3: the collective main path at the paper's scale")
        full = full_phase(dev)
        torch.cuda.empty_cache()
        for k in WRAPPERS:
            main_launches[k] = sum(full[path]["launches"][k] for path in
                                   ("dptree_f32", "hier_bf16", "dptree_i32"))
        log("main path: " + json.dumps(full))
    if 4 in run:
        mcfg = get_config(DECODE["arch"])
        token_rows = DECODE["batch"] * mcfg.n_kv_heads
        ring_rows = token_rows * DECODE["cache_len"]
        log("phase 4: the int8 K/V kernels")
        rows.update(int8_phase(dev, token_rows, ring_rows, mcfg.hdim,
                               mcfg.n_kv_heads, DECODE["cache_len"]))
    decode = {"launches": {k: 0 for k in WRAPPERS}}
    if 5 in run:
        log("phase 5: the serving main path, MiniCPM-2B at full width")
        decode = decode_phase(dev)
        for name in ("quantize_int8", "quantize_int8_into",
                     "dequantize_int8", "ring_attention"):
            main_launches[name] = decode["launches"][name]
        log("decode path: " + json.dumps(decode))
    if 6 in run:
        tcfg = get_config(TRAIN["arch"])
        log("phase 6: the flash-attention kernel")
        rows["flash_attention"] = flash_phase(
            dev, (TRAIN["global_batch"] // TRAIN["accum"], TRAIN["seq_len"],
                  tcfg.n_heads, tcfg.hdim))
    if 7 in run:
        log("phase 7: the training main path, MiniCPM-2B at full width")
        training = train_phase(dev)
        main_launches["flash_attention"] = \
            training["launches"]["flash_attention"]
        log("training path: " + json.dumps(training))
    if 8 in run:
        log("phase 8: training with checkpoints and a restart, and the dots "
            "remat, MiniCPM-2B at full width")
        ckpt = ckpt_phase(dev, training["max_memory_bytes"])
        log("checkpoint path: " + json.dumps(ckpt))
    if run & {9, 10, 11}:
        scfg, sparams = serve_model(dev)
    if 9 in run:
        log("phase 9: continuous serving, MiniCPM-2B at full width")
        t9 = time.perf_counter()
        cont = continuous_phase(dev, scfg, sparams)
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
    if 10 in run:
        log("phase 10: speculation, prefixes and policies, MiniCPM-2B at "
            "full width")
        t10 = time.perf_counter()
        spec = spec_phase(dev, scfg, sparams)
        spec["seconds"] = time.perf_counter() - t10
        torch.cuda.empty_cache()
        write = rows["quantize_int8_into"]
        write["verify_shape"] = spec.pop("verify_write")
        write["max_abs_err"] = max(write["max_abs_err"],
                                   write["verify_shape"]["max_abs_err"])
        rows["ring_attention"] = spec.pop("ring_attention")
        rows["ring_attention"]["launches_by_path"] = {
            "decode": decode["launches"]["ring_attention"],
            "continuous": (cont["launches"]["ring_attention"] if 9 in run
                           else 0)}
        main_launches["ring_attention"] += \
            rows["ring_attention"]["launches_by_path"]["continuous"]
        for name in ("quantize_int8_into", "dequantize_int8",
                     "ring_attention"):
            rows[name].setdefault("launches_by_path", {})["speculative"] = \
                spec["launches"][name]
            main_launches[name] += spec["launches"][name]
        log(f"phase 10 seconds {spec['seconds']:.2f}")
        log("speculative path: " + json.dumps(spec))
    if 11 in run:
        log("phase 11: the replica fleet under chaos, MiniCPM-2B at full "
            "width")
        t11 = time.perf_counter()
        fleet = fleet_phase(dev, scfg, sparams)
        fleet["seconds"] = time.perf_counter() - t11
        for name in ("quantize_int8_into", "dequantize_int8",
                     "ring_attention"):
            if name in rows:
                rows[name].setdefault("launches_by_path", {})["fleet"] = \
                    fleet["launches"][name]
            main_launches[name] += fleet["launches"][name]
        if "combine3" in rows:
            rows["combine3"]["launches_by_path"] = {
                "collective": main_launches["combine3"],
                "fleet_stats": fleet["launches"]["combine3"]}
        main_launches["combine3"] += fleet["launches"]["combine3"]
        log(f"phase 11 seconds {fleet['seconds']:.2f}")
        log("fleet path: " + json.dumps(fleet))
    if run & {9, 10, 11}:
        del sparams
        torch.cuda.empty_cache()
    if 12 in run:
        log("phase 12: the MoE sublayers, Mixtral-8x22B and Llama-4 Scout "
            "at full width")
        t12 = time.perf_counter()
        moe = moe_phase(dev)
        moe["seconds"] = time.perf_counter() - t12
        for name in ("quantize_int8_into", "dequantize_int8",
                     "ring_attention", "combine3"):
            if name in rows:
                rows[name].setdefault("launches_by_path", {})["moe"] = \
                    moe["launches"][name]
            main_launches[name] += moe["launches"][name]
        log(f"phase 12 seconds {moe['seconds']:.2f}")
        log("moe path: " + json.dumps(moe))
    if 13 in run:
        log("phase 13: the RWKV-6 mixer, RWKV-6 7B at full width and depth")
        rwkv = rwkv_phase(dev)
        rows["wkv6"] = rwkv.pop("wkv6")
        main_launches["wkv6"] += rwkv["launches"]["wkv6"]
        log(f"phase 13 seconds {rwkv['seconds']:.2f}")
        log("rwkv path: " + json.dumps(rwkv))
    if 14 in run:
        log("phase 14: the Mamba mixer, Jamba-v0.1 at full width (one "
            "period of 8 layers)")
        jamba = jamba_phase(dev)
        rows["mamba_scan"] = jamba.pop("mamba_scan")
        for name in WRAPPERS:
            if name in rows and jamba["launches"][name]:
                rows[name].setdefault("launches_by_path", {})["jamba"] = \
                    jamba["launches"][name]
            main_launches[name] += jamba["launches"][name]
        log(f"phase 14 seconds {jamba['seconds']:.2f}")
        log("jamba path: " + json.dumps(jamba))
    log(card)
    # each kernel's main path, by the phases that drive it
    paths = {"combine3": {3}, "compress_bf16": {3}, "decompress_bf16": {3},
             "quantize_int8_into": {5}, "dequantize_int8": {5},
             "flash_attention": {7}, "ring_attention": {5}, "wkv6": {13},
             "mamba_scan": {14}}
    for name, by in paths.items():
        if by & run and main_launches[name] == 0:
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
