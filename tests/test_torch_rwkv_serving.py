"""The port's RWKV-6 model on its serving paths, against the JAX reference
and within the port, on the CPU.

Reduced RWKV-6 7B (2 layers, d_model 64, 4 heads of 16) with the
reference's parameters (``params_from_reference``):

* the continuous engine's greedy streams and counters against the JAX
  engine's through ``tests/_torch_engine_parity.py``: under f32 compute
  exactly equal (plain, with speculation and with the prefix cache), under
  the config's bf16 by that harness's margin rule;
* within the port, speculation (n-gram drafts, and a draft model that is
  itself RWKV) and the prefix cache give the plain run's streams bitwise;
* every slot op on RWKV caches: a decode tick leaves an inactive row's
  carries bit-unchanged, a freed row is zeroed, a first prefill chunk
  restarts only its own row, a row extracted and adopted lands whole, and a
  verify call's commit leaves the state the sequential decode ticks leave,
  bit for bit;
* ``serve.py`` end to end with ``--arch rwkv6_7b``, fixed-batch and
  ``--continuous`` with speculation and the prefix cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_engine_parity as par
from repro.configs import base as ref_base
from repro_torch import serving
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf

ARCH = "rwkv6_7b"
LEAVES = ("shift1", "shift2", "state")


def _rwkv_cfg(mod, param_dtype, **kw):
    return dataclasses.replace(mod.get_config(ARCH, reduced=True),
                               param_dtype=param_dtype, **kw)


# the engine harness's configs for RWKV-6: bf16 compute (the config's own)
# and f32 compute, f32 parameters as the harness draws them
RWKV_CONFIGS = {
    "rwkv": lambda: (_rwkv_cfg(ref_base, jnp.bfloat16),
                     _rwkv_cfg(base, torch.bfloat16)),
    "rwkv_f32": lambda: (
        _rwkv_cfg(ref_base, jnp.float32, compute_dtype=jnp.float32),
        _rwkv_cfg(base, torch.float32, compute_dtype=torch.float32)),
}


@pytest.fixture
def rwkv_configs(monkeypatch):
    """The RWKV configs in the harness's ``CONFIGS`` for one test only: the
    other engine tests parametrize over that dict when they are collected,
    so it must not change while files are imported."""
    for name, make in RWKV_CONFIGS.items():
        monkeypatch.setitem(par.CONFIGS, name, make)


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("name,spec,prefix", [("rwkv_f32", False, False),
                                              ("rwkv", False, False),
                                              ("rwkv_f32", True, False),
                                              ("rwkv_f32", False, True)])
def test_engine_matches_the_jax_engine(name, spec, prefix, rwkv_configs):
    got, want = par.check_against_jax(name, spec=spec, prefix=prefix)
    assert got["tokens"] == want["tokens"] or name == "rwkv"
    if spec:
        assert got["verify_ticks"] and got["drafted_tokens"]
    if prefix:
        assert got["prefix_hits"] >= 1


def test_speculation_and_prefix_give_the_plain_streams(rwkv_configs):
    """Within the port, under the config's bf16: n-gram speculation, a
    draft model (the same reduced RWKV-6 from another seed, whose own
    carries roll back after each proposal) and the prefix cache, each
    bitwise the plain run's streams."""
    cfg, eng = par.engine("rwkv", n_slots=3, max_len=64, prefill_chunk=8)
    plain = eng.run(par.workload(serving, cfg.vocab_size))
    spec = eng.run(par.workload(serving, cfg.vocab_size, spec=True))
    assert spec["tokens"] == plain["tokens"] and spec["verify_ticks"]
    drafter = serving.DraftModelDrafter(cfg, tf.init_params(cfg, 3, "cpu"),
                                        n_slots=3, max_len=64, device="cpu")
    _, deng = par.engine("rwkv", n_slots=3, max_len=64, prefill_chunk=8,
                         drafter=drafter)
    drafted = deng.run(par.workload(serving, cfg.vocab_size, spec=True))
    assert drafted["tokens"] == plain["tokens"]
    assert drafted["drafted_tokens"]
    _, peng = par.engine("rwkv", n_slots=3, max_len=64, prefill_chunk=8,
                         prefix_cache=True)
    warm = peng.run(par.workload(serving, cfg.vocab_size))
    assert warm["tokens"] == plain["tokens"]
    assert warm["prefix_hits"] >= 1
    assert warm["prefill_chunks"] < plain["prefill_chunks"]


# ------------------------------------------------------------ slot ops

def _model():
    cfg = base.get_config(ARCH, reduced=True)
    return cfg, tf.init_params(cfg, 0, "cpu")


def _prefilled(cfg, p, lens, seed=0) -> tuple:
    """Per-slot caches, row ``b`` prefilled with ``lens[b]`` random tokens
    in one call (right-padded); returns (caches, next tokens (B, 1))."""
    rng = np.random.default_rng(seed)
    B, T = len(lens), max(lens)
    caches = tf.init_cache(cfg, B, 64, device="cpu", per_slot=True)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, T)))
    with torch.no_grad():
        _, caches = tf.prefill_step(p, cfg, {"tokens": toks}, caches, lens)
    nxt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1)))
    return caches, nxt


def _copy(caches) -> tuple:
    return tuple({k: v.clone() for k, v in c.items()} for c in caches)


def _rows_equal(a, b, rows) -> bool:
    return all(torch.equal(x[name][:, rows], y[name][:, rows])
               for x, y in zip(a, b) for name in LEAVES)


@torch.no_grad()
def test_rwkv_caches_have_no_position_and_the_reference_shapes():
    cfg, _ = _model()
    caches = tf.init_cache(cfg, 3, 64, device="cpu", per_slot=True)
    assert tf.cache_layer_kinds(cfg) == ("rwkv",)
    c, n, D = caches[0], cfg.n_periods, cfg.d_model
    H, K = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert set(c) == set(LEAVES)
    assert c["shift1"].shape == c["shift2"].shape == (n, 3, 1, D)
    assert c["shift1"].dtype == cfg.compute_dtype
    assert c["state"].shape == (n, 3, H, K, K)
    assert c["state"].dtype == torch.float32
    # the int8 K/V setting has nothing to quantize here
    quant = tf.init_cache(dataclasses.replace(cfg, kv_quant=True), 3, 64,
                          device="cpu", per_slot=True)
    assert all(quant[0][k].dtype == c[k].dtype for k in LEAVES)
    assert tf.advance_pos(caches) == caches


@torch.no_grad()
def test_decode_tick_leaves_inactive_rows_and_reset_zeroes_freed_ones():
    cfg, p = _model()
    caches, nxt = _prefilled(cfg, p, [5, 9, 3])
    before = _copy(caches)
    active = np.array([True, False, True])
    _, caches = tf.decode_step(p, cfg, {"tokens": nxt}, caches, active)
    assert _rows_equal(caches, before, [1])
    assert not _rows_equal(caches, before, [0])
    assert not _rows_equal(caches, before, [2])
    # the active rows took the step a row takes alone
    alone = tuple({k: v[:, :1].clone() for k, v in c.items()}
                  for c in before)
    _, alone = tf.decode_step(p, cfg, {"tokens": nxt[:1]}, alone,
                              np.array([True]))
    assert _rows_equal(caches, alone, [0])
    kept = _copy(caches)
    caches = tf.reset_cache_slots(caches, np.array([False, True, False]))
    assert all(not c[k][:, 1].any() for c in caches for k in LEAVES)
    assert _rows_equal(caches, kept, [0, 2])


@torch.no_grad()
def test_first_chunk_restarts_only_its_row_and_rows_move_whole():
    cfg, p = _model()
    caches, _ = _prefilled(cfg, p, [5, 9, 3])
    before = _copy(caches)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 8)))
    _, caches = tf.prefill_step(p, cfg, {"tokens": toks}, caches, [8, 8, 8],
                                active=[False, True, False])
    assert _rows_equal(caches, before, [0, 2])
    fresh = tf.init_cache(cfg, 3, 64, device="cpu", per_slot=True)
    _, fresh = tf.prefill_step(p, cfg, {"tokens": toks}, fresh, [8, 8, 8])
    assert _rows_equal(caches, fresh, [1])
    # a row copied out and into another slot lands whole; the rest stay
    row = tf.extract_cache_row(caches, 1, 8)
    kept = _copy(caches)
    caches = tf.adopt_prefix(caches, row, 2)
    assert all(torch.equal(c[k][:, 2], c[k][:, 1])
               for c in caches for k in LEAVES)
    assert _rows_equal(caches, kept, [0, 1])
    # the engine's single-row prefill writes its slot through views
    step = serving.ServingEngine(cfg, None, p, n_slots=3, max_len=64,
                                 device="cpu")._prefill
    _, caches = step(p, toks[1:2], caches, 0, 8)
    assert all(torch.equal(c[k][:, 0], c[k][:, 1])
               for c in caches for k in LEAVES)


@torch.no_grad()
def test_verify_commit_is_the_sequential_decode_bit_for_bit():
    """A verify call of 4 positions over 4 rows (3, 0, 2 and 1 drafts, row
    2 inactive) and a commit of 3, 1, - and 2 tokens leave the carries
    that as many decode ticks leave, and score those positions with the
    ticks' logits, bitwise; the inactive row keeps its carries."""
    cfg, p = _model()
    caches, nxt = _prefilled(cfg, p, [5, 9, 3, 7])
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 4)))
    tokens[:, 0] = nxt[:, 0]
    n_draft = np.array([3, 0, 2, 1])
    active = np.array([True, True, False, True])
    accept = np.array([3, 1, 1, 2])
    seq = _copy(caches)
    logits, old = tf.verify_forward(p, cfg, {"tokens": tokens}, caches,
                                    lengths=n_draft + 1, active=active)
    caches = tf.commit_verify_caches(caches, old, accept, active)
    assert _rows_equal(caches, seq, [2])
    for t in range(int(accept.max())):
        rows = active & (accept > t)
        lg, seq = tf.decode_step(p, cfg, {"tokens": tokens[:, t:t + 1]}, seq,
                                 rows)
        for b in np.flatnonzero(rows):
            assert torch.equal(lg[b], logits[b, t]), (b, t)
    for b in (0, 1, 3):
        assert all(torch.equal(c[k][:, b], s[k][:, b])
                   for c, s in zip(caches, seq) for k in LEAVES), b


@torch.no_grad()
def test_saved_rows_come_back_whole_and_a_verify_saves_none():
    """``save_ring_slots`` keeps the whole RWKV rows that will be written
    (what a draft model rolls back), ``restore_ring_slots`` writes them
    back where ``keep`` is 0 and leaves the rows that keep their tokens;
    without ``carries`` (a verify call) nothing is saved. The slot norm is
    ``rmsnorm`` on the CPU (one call)."""
    cfg, p = _model()
    caches, nxt = _prefilled(cfg, p, [5, 9, 3])
    before = _copy(caches)
    n = np.array([2, 0, 2])
    saved = tf.save_ring_slots(caches, n)
    assert tf.save_ring_slots(caches, n, carries=False) == (None,) * len(
        caches)
    for _ in range(2):
        _, caches = tf.decode_step(p, cfg, {"tokens": nxt}, caches,
                                   n > 0)
    moved = _copy(caches)
    assert not _rows_equal(moved, before, [0]) and _rows_equal(
        moved, before, [1])
    caches = tf.restore_ring_slots(caches, saved, np.array([0, 0, 2]))
    assert _rows_equal(caches, before, [0, 1])
    assert _rows_equal(caches, moved, [2])
    x = torch.randn((2, 7, cfg.d_model)).to(cfg.compute_dtype)
    norm = p["layers"][0][0]["ln1"]
    scale = {"scale": norm["scale"][0]}
    assert torch.equal(L.serve_rmsnorm(scale, x), L.rmsnorm(scale, x))


# ------------------------------------------------------------ the CLI

def test_serve_cli_runs_rwkv(capsys):
    run = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "4"])
    assert run.tokens.shape == (2, 4)
    rep = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--continuous", "--speculate", "--prefix-cache",
                      "--shared-prefix", "16", "--prefill-chunk", "8",
                      "--requests", "4", "--slots", "2"])
    assert rep["requests"] == 4 and rep["prefix_hits"] >= 1
    assert "tok/s on cpu" in capsys.readouterr().out
