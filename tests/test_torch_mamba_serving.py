"""The port's Jamba model on its serving paths, against the JAX reference
and within the port, on the CPU.

Reduced Jamba-v0.1 (8 layers: Mamba mixers at 0-3 and 5-7, attention at
4, MoE on the odd layers; d_model 64, d_state 8, 4 experts) with the
reference's parameters (``params_from_reference``); its caches hold
attention rings and Mamba carries side by side:

* the continuous engine's greedy streams and counters against the JAX
  engine's through ``tests/_torch_engine_parity.py``: plain under the
  config's bf16 by that harness's margin rule, with speculation and with
  the prefix cache under f32 compute exactly equal (a prefix-cache run's
  decode ticks are the plain run's, so plain f32 adds no path);
* within the port, speculation (n-gram drafts, and a draft model that is
  itself reduced Jamba) and the prefix cache give the plain run's streams
  bitwise;
* every slot op on the mixed caches: a decode tick leaves an inactive
  row's rings and carries bit-unchanged, a freed row is zeroed, a first
  prefill chunk restarts only its own row, a row extracted and adopted
  lands whole, saved rows come back, and a verify call's commit leaves the
  caches the sequential decode ticks leave, bit for bit;
* ``serve.py`` end to end with ``--arch jamba_v0_1_52b``, fixed-batch and
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
from repro_torch.models import transformer as tf

ARCH = "jamba_v0_1_52b"


def _jamba_cfg(mod, param_dtype, **kw):
    return dataclasses.replace(mod.get_config(ARCH, reduced=True),
                               param_dtype=param_dtype, **kw)


# the engine harness's configs for Jamba: bf16 compute (the config's own)
# and f32 compute, f32 parameters as the harness draws them
JAMBA_CONFIGS = {
    "jamba": lambda: (_jamba_cfg(ref_base, jnp.bfloat16),
                      _jamba_cfg(base, torch.bfloat16)),
    "jamba_f32": lambda: (
        _jamba_cfg(ref_base, jnp.float32, compute_dtype=jnp.float32),
        _jamba_cfg(base, torch.float32, compute_dtype=torch.float32)),
}


@pytest.fixture
def jamba_configs(monkeypatch):
    """The Jamba configs in the harness's ``CONFIGS`` for one test only: the
    other engine tests parametrize over that dict when they are collected,
    so it must not change while files are imported."""
    for name, make in JAMBA_CONFIGS.items():
        monkeypatch.setitem(par.CONFIGS, name, make)


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("name,spec,prefix", [("jamba", False, False),
                                              ("jamba_f32", True, False),
                                              ("jamba_f32", False, True)])
def test_engine_matches_the_jax_engine(name, spec, prefix, jamba_configs):
    got, want = par.check_against_jax(name, spec=spec, prefix=prefix)
    assert got["tokens"] == want["tokens"] or name == "jamba"
    if spec:
        assert got["verify_ticks"] and got["drafted_tokens"]
    if prefix:
        assert got["prefix_hits"] >= 1


def test_speculation_and_prefix_give_the_plain_streams(jamba_configs):
    """Within the port, under the config's bf16: n-gram speculation, a
    draft model (the same reduced Jamba from another seed, whose own rings
    and carries roll back after each proposal) and the prefix cache, each
    bitwise the plain run's streams."""
    cfg, eng = par.engine("jamba", n_slots=3, max_len=64, prefill_chunk=8)
    plain = eng.run(par.workload(serving, cfg.vocab_size))
    spec = eng.run(par.workload(serving, cfg.vocab_size, spec=True))
    assert spec["tokens"] == plain["tokens"] and spec["verify_ticks"]
    drafter = serving.DraftModelDrafter(cfg, tf.init_params(cfg, 3, "cpu"),
                                        n_slots=3, max_len=64, device="cpu")
    _, deng = par.engine("jamba", n_slots=3, max_len=64, prefill_chunk=8,
                         drafter=drafter)
    drafted = deng.run(par.workload(serving, cfg.vocab_size, spec=True))
    assert drafted["tokens"] == plain["tokens"]
    assert drafted["drafted_tokens"]
    _, peng = par.engine("jamba", n_slots=3, max_len=64, prefill_chunk=8,
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
    """Rows ``rows`` of every leaf of every cache equal, positions
    included (a ring's ``pos`` is (n_periods, B) on the host)."""
    return all(torch.equal(x[name][:, rows], y[name][:, rows])
               for x, y in zip(a, b) for name in x)


@torch.no_grad()
def test_mixed_caches_have_the_reference_shapes():
    cfg, _ = _model()
    caches = tf.init_cache(cfg, 3, 64, device="cpu", per_slot=True)
    kinds = tf.cache_layer_kinds(cfg)
    assert kinds == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    n, m = cfg.n_periods, cfg.mamba_cfg()
    for c, kind in zip(caches, kinds):
        if kind == "attn":
            assert set(c) == {"pos", "k", "v"} and c["pos"].shape == (n, 3)
            continue
        assert set(c) == {"conv", "ssm"}
        assert c["conv"].shape == (n, 3, m.d_conv - 1, m.d_inner)
        assert c["conv"].dtype == cfg.compute_dtype
        assert c["ssm"].shape == (n, 3, m.d_inner, m.d_state)
        assert c["ssm"].dtype == torch.float32
    # the int8 K/V setting quantizes the ring and leaves the carries
    quant = tf.init_cache(dataclasses.replace(cfg, kv_quant=True), 3, 64,
                          device="cpu", per_slot=True)
    assert quant[4]["k"].dtype == torch.int8 and "ks" in quant[4]
    assert quant[0]["ssm"].dtype == torch.float32
    stepped = tf.advance_pos(caches)
    assert stepped[0] is caches[0]
    assert torch.equal(stepped[4]["pos"], caches[4]["pos"] + 1)


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
    assert all(not c[k][:, 1].any() for c in caches for k in c)
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
    assert _slots_equal(caches, 1, fresh, 1, 8)
    # a row copied out and into another slot lands whole (the ring trimmed
    # to its 8 positions, zeros past them); the rest stay
    row = tf.extract_cache_row(caches, 1, 8)
    assert row[4]["k"].shape[2] == 8 and row[0]["ssm"].shape[1] == 1
    kept = _copy(caches)
    caches = tf.adopt_prefix(caches, row, 2)
    assert _slots_equal(caches, 2, caches, 1, 8)
    assert not caches[4]["k"][:, 2, 8:].any()
    assert _rows_equal(caches, kept, [0, 1])
    # the engine's single-row prefill writes its slot through views
    # (cache_row), and splice_row_pos gives it the row's position
    step = serving.ServingEngine(cfg, None, p, n_slots=3, max_len=64,
                                 device="cpu")._prefill
    _, caches = step(p, toks[1:2], caches, 0, 8)
    assert _slots_equal(caches, 0, caches, 1, 8)


def _slots_equal(a, i, b, j, m) -> bool:
    """Slot ``i`` of caches ``a`` and slot ``j`` of ``b`` after a prefill of
    ``m`` tokens: the carries whole, a ring's position and its first ``m``
    slots (the ring's older slots are hidden by the position)."""
    for x, y in zip(a, b):
        for k in x:
            got, want = x[k][:, i], y[k][:, j]
            if "pos" in x and k != "pos":
                got, want = got[:, :m], want[:, :m]
            if not torch.equal(got, want):
                return False
    return True


@torch.no_grad()
def test_verify_commit_is_the_sequential_decode_bit_for_bit():
    """A verify call of 4 positions over 4 rows (3, 0, 2 and 1 drafts, row
    2 inactive) and a commit of 3, 1, - and 2 tokens leave the rings, the
    positions and the carries that as many decode ticks leave, and score
    those positions with the ticks' logits, bitwise; the inactive row
    keeps its caches."""
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
    assert set(old[0]) == {"steps"} and "pos" in old[4]
    caches = tf.commit_verify_caches(caches, old, accept, active)
    assert _rows_equal(caches, seq, [2])
    for t in range(int(accept.max())):
        rows = active & (accept > t)
        lg, seq = tf.decode_step(p, cfg, {"tokens": tokens[:, t:t + 1]}, seq,
                                 rows)
        for b in np.flatnonzero(rows):
            assert torch.equal(lg[b], logits[b, t]), (b, t)
    for b in (0, 1, 3):
        assert _rows_equal(caches, seq, [b]), b


@torch.no_grad()
def test_saved_rows_come_back_whole_and_a_verify_saves_no_carries():
    """``save_ring_slots`` keeps the ring slots and the whole Mamba rows
    that will be written (what a draft model rolls back),
    ``restore_ring_slots`` writes them back where ``keep`` is 0 and leaves
    the rows that keep their tokens; without ``carries`` (a verify call)
    no carry is saved, only the ring's slots."""
    cfg, p = _model()
    caches, nxt = _prefilled(cfg, p, [5, 9, 3])
    before = _copy(caches)
    n = np.array([2, 0, 2])
    saved = tf.save_ring_slots(caches, n)
    bare = tf.save_ring_slots(caches, n, carries=False)
    assert all(s is None for i, s in enumerate(bare) if i != 4)
    assert bare[4] is not None
    for _ in range(2):
        _, caches = tf.decode_step(p, cfg, {"tokens": nxt}, caches, n > 0)
    moved = _copy(caches)
    assert not _rows_equal(moved, before, [0]) and _rows_equal(
        moved, before, [1])
    caches = tf.restore_ring_slots(caches, saved, np.array([0, 0, 2]))
    assert _rows_equal(caches, before, [0, 1])
    assert _rows_equal(caches, moved, [2])


# ------------------------------------------------------------ the CLI

def test_serve_cli_runs_jamba(capsys):
    run = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "4"])
    assert run.tokens.shape == (2, 4)
    rep = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--continuous", "--speculate", "--prefix-cache",
                      "--shared-prefix", "16", "--prefill-chunk", "8",
                      "--requests", "4", "--slots", "2"])
    assert rep["requests"] == 4 and rep["prefix_hits"] >= 1
    assert "tok/s on cpu" in capsys.readouterr().out
