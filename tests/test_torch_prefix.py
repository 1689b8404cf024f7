"""The port's cross-request prefix cache against the JAX reference's
``repro.serving.prefix`` and ``transformer.extract_cache_row`` /
``adopt_prefix``, and against its own cold prefill, on the CPU.

Against the reference: the trie's lookups, evictions, pins and stats under
the same operations; an adopted row byte-equal to the reference's
whole-row adoption of the same caches (the port keeps only the first
``min(p, S)`` ring slots of a row and writes zeros past them); the
engine's streams and counters with the prefix cache on
(``tests/_torch_engine_parity.py``). Within the port: warm streams equal
cold ones, a warm admission issues ``ceil((len - k) / grid)`` chunks,
adoption into a reused slot leaves no residue, and LRU pressure keeps the
streams.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_engine_parity as par
from repro import serving as ref_serving
from repro.models import transformer as ref_tf
from repro_torch import serving
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import SubSpec

CHUNK = 8


def test_prefix_cache_is_the_references():
    """A random sequence of inserts, lookups, pins and releases: the same
    lookup results, keys (in order), evictions, leaf sequences and stats,
    and the same refusals."""
    rng = np.random.default_rng(0)
    got = serving.PrefixCache(grid=2, max_nodes=5)
    want = ref_serving.PrefixCache(grid=2, max_nodes=5)
    pinned = []
    for _ in range(400):
        op = rng.integers(0, 4)
        hist = tuple(int(t) for t in rng.integers(1, 3, int(
            rng.integers(1, 9))))
        if op == 0 and len(hist) % 2 == 0:
            assert got.insert(hist, "row") == want.insert(hist, "row")
        elif op == 1:
            (p, n), (q, m) = got.lookup(hist), want.lookup(hist)
            assert p == q and (n is None) == (m is None)
            if n is not None:
                assert n.key == m.key
                if rng.random() < 0.5:
                    got.acquire(n.key)
                    want.acquire(m.key)
                    pinned.append(n.key)
        elif op == 2 and pinned:
            key = pinned.pop(int(rng.integers(0, len(pinned))))
            got.release(key)
            want.release(key)
        assert got.keys() == want.keys()
        assert got.sequences() == want.sequences()
        assert got.stats() == want.stats()
    assert got.stats()["evictions"] > 0
    for trie in (got, want):
        with pytest.raises(ValueError, match="multiples"):
            trie.insert((1, 2, 3), "row")
        with pytest.raises(KeyError):
            trie.acquire((9, 9))


def _prefilled(cfg, p, rng, S):
    """Per-slot caches of 3 slots: slot 0 holds 16 prompt tokens, slot 2
    another request's 10 (a dirty target), slot 1 is free."""
    caches = tf.init_cache(cfg, 3, S, device="cpu", per_slot=True,
                           ring_slack=4)
    prefill = step_fns.make_prefill_step(cfg)
    for slot, n in ((0, 16), (2, 10)):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n)))
        pos = 0
        while pos < n:
            c = min(8, n - pos)
            _, caches = prefill(p, toks[:, pos:pos + c], caches, slot, c,
                                resume=pos > 0)
            pos += c
    return caches


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("ring", ["full", "wrapped"])
@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
def test_adopted_row_is_the_references_whole_row_adoption(name, ring):
    """A row of 16 tokens, trimmed to its written slots (a full-attention
    ring of 32) or whole (a sliding window of 8 plus 4 slots of slack,
    which 16 tokens wrap), adopted into a dirty slot: every leaf bitwise the
    reference's ``adopt_prefix(caches, extract_cache_row(caches, 0), 2)``,
    the adopted row the donor's, the other slots unchanged."""
    _, cfg, _, p = par.params(name)
    if ring == "wrapped":
        cfg = dataclasses.replace(cfg, name="prefix-swa", pattern=tuple(
            tuple(SubSpec(kind="attn", sliding_window=8)
                  if (s.kind if not isinstance(s, str) else s) == "attn"
                  else s for s in layer) for layer in cfg.pattern))
    caches = _prefilled(cfg, p, np.random.default_rng(1), 32)
    row = tf.extract_cache_row(caches, 0, 16)
    S = caches[0]["k"].shape[2]
    assert row[0]["k"].shape[2] == min(16, S)
    jc = jax.tree.map(lambda t: jnp.asarray(
        t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy()), caches)
    slot = jnp.asarray(2, jnp.int32)
    want = ref_tf.adopt_prefix(jc, ref_tf.extract_cache_row(
        jc, jnp.asarray(0, jnp.int32)), slot)
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    got = tf.adopt_prefix(caches, row, 2)
    for g, w, b in zip(got, want, before):
        for k in g:
            w_bits = np.asarray(w[k])
            w_bits = w_bits.view(np.int16) if w_bits.dtype == jnp.bfloat16 \
                else w_bits
            assert np.array_equal(_bits(g[k]), w_bits), k
            assert np.array_equal(_bits(g[k][:, 2]), _bits(b[k][:, 0])), k
            assert np.array_equal(_bits(g[k][:, :2]), _bits(b[k][:, :2])), k


@pytest.mark.parametrize("name", ["tiny_f32", "minicpm_int8"])
def test_engine_with_prefix_cache_matches_the_jax_engine(name):
    got, want = par.check_against_jax(name, prefix=True)
    assert want["prefix_hits"] > 0
    assert got["prefix_cache"] == want["prefix_cache"]


# ------------------------------------------------------------ within the port

def _shared_reqs(vocab, *, share=16, sampling=None, spec=None, gap=4,
                 max_new=5, seed=7):
    """A leader and two sharers of its first ``share`` prompt tokens, the
    third repeating the leader's whole prompt."""
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in rng.integers(1, vocab, share))
    t_lead = tuple(int(t) for t in rng.integers(1, vocab, 4))
    t_div = tuple(int(t) for t in rng.integers(1, vocab, 5))

    def samp(i):
        return None if sampling is None else \
            dataclasses.replace(sampling, seed=sampling.seed + i)

    return [serving.Request(0, shared + t_lead, max_new, arrival=0,
                            sampling=samp(0), spec=spec),
            serving.Request(1, shared + t_div, max_new, arrival=gap,
                            sampling=samp(1), spec=spec),
            serving.Request(2, shared + t_lead, max_new, arrival=2 * gap,
                            sampling=samp(2), spec=spec)]


def _warm_cold(name="tiny", *, n_slots=3, max_len=64, **kw):
    cfg, cold = par.engine(name, n_slots=n_slots, max_len=max_len,
                           prefill_chunk=CHUNK, **kw)
    _, warm = par.engine(name, n_slots=n_slots, max_len=max_len,
                         prefill_chunk=CHUNK, prefix_cache=True, **kw)
    return cfg, cold, warm


@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
def test_warm_streams_equal_cold_and_ttft_collapses(name):
    cfg, cold, warm = _warm_cold(name)
    a = cold.run(_shared_reqs(cfg.vocab_size))
    reqs = _shared_reqs(cfg.vocab_size)
    b = warm.run(reqs)
    assert a["tokens"] == b["tokens"]
    assert b["prefix_hits"] == 2 and b["prefix_tokens_reused"] == 32
    assert reqs[1].prefix_reused == 16 and reqs[2].prefix_reused == 16
    assert reqs[2].ttft == 0
    assert a["prefill_chunks"] == 9 and b["prefill_chunks"] == 5
    assert b["prefix_cache"]["pinned"] == 0
    assert "prefix_cache" not in a
    sp = serving.SamplingParams(temperature=0.9, top_p=0.85, seed=11)
    assert cold.run(_shared_reqs(cfg.vocab_size, sampling=sp))["tokens"] == \
        warm.run(_shared_reqs(cfg.vocab_size, sampling=sp))["tokens"]
    stat = warm.run(_shared_reqs(cfg.vocab_size, gap=0), static=True)
    assert stat["tokens"] == cold.run(_shared_reqs(cfg.vocab_size,
                                                   gap=0))["tokens"]


@pytest.mark.parametrize("share,plen", [(16, 17), (16, 22), (16, 24),
                                        (24, 25), (24, 30)])
def test_warm_admission_issues_ceil_len_minus_k_chunks(share, plen):
    cfg, warm = par.engine("tiny", n_slots=1, max_len=64,
                           prefill_chunk=CHUNK, prefix_cache=True)
    rng = np.random.default_rng(1)
    lead = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 26))
    sharer = lead[:share] + tuple(int(t) for t in rng.integers(
        1, cfg.vocab_size, plen - share))
    reqs = [serving.Request(0, lead, 2), serving.Request(1, sharer, 2)]
    report = warm.run(reqs)
    assert reqs[1].prefix_reused == share
    assert report["prefill_chunks"] == -(-len(lead) // CHUNK) + \
        -(-(plen - share) // CHUNK)
    assert report["prefix_tokens_reused"] == share


def test_adoption_into_reused_slot_leaves_no_residue():
    cfg, cold, warm = _warm_cold("minicpm_int8", n_slots=1)
    rng = np.random.default_rng(4)
    shared = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 16))
    other = tuple(int(t) for t in rng.integers(1, cfg.vocab_size, 11))
    reqs = lambda: [serving.Request(0, shared + (9, 9), 4),  # noqa: E731
                    serving.Request(1, other, 4),
                    serving.Request(2, shared + (9, 9), 4)]
    a, b = cold.run(reqs()), warm.run(reqs())
    assert a["tokens"] == b["tokens"]
    assert b["prefix_hits"] == 1                  # rid 2, through rid 1's slot


def test_swa_ring_warm_equals_cold():
    _, cfg, _, p = par.params("tiny")
    swcfg = dataclasses.replace(cfg, name="prefix-swa", pattern=(
        (SubSpec(kind="attn", sliding_window=16), "mlp"),))
    mk = lambda prefix: serving.ServingEngine(  # noqa: E731
        swcfg, None, p, n_slots=2, max_len=64, prefill_chunk=CHUNK,
        min_prefill_bucket=8, prefix_cache=prefix, device="cpu")
    rng = np.random.default_rng(5)
    shared = tuple(int(t) for t in rng.integers(1, 101, 24))
    reqs = lambda: [serving.Request(0, shared + (3, 1, 4), 4),  # noqa: E731
                    serving.Request(1, shared + (2, 7), 4, arrival=5)]
    a, b = mk(False).run(reqs()), mk(True).run(reqs())
    assert a["tokens"] == b["tokens"]
    assert b["prefix_hits"] == 1 and b["prefix_tokens_reused"] == 24


def test_lru_pressure_keeps_streams():
    cfg, cold, _ = _warm_cold()
    _, one = par.engine("tiny", n_slots=3, max_len=64, prefill_chunk=CHUNK,
                        prefix_cache=True, prefix_cache_nodes=1)
    a = cold.run(_shared_reqs(cfg.vocab_size))
    b = one.run(_shared_reqs(cfg.vocab_size))
    assert a["tokens"] == b["tokens"]
    assert b["prefix_cache"]["nodes"] <= 1
    assert b["prefix_cache"]["evictions"] > 0


def test_warm_speculative_streams_equal_cold_and_corpus_attached():
    cfg, cold, warm = _warm_cold()
    a = cold.run(_shared_reqs(cfg.vocab_size))
    b = warm.run(_shared_reqs(cfg.vocab_size,
                              spec=serving.SpecParams(draft_k=3)))
    assert a["tokens"] == b["tokens"]
    assert isinstance(warm.drafter, serving.NgramDrafter)
    assert warm.drafter.corpus is not None


def test_engine_rejects_bad_node_bound():
    with pytest.raises(ValueError, match="prefix_cache_nodes"):
        par.engine(prefix_cache=True, prefix_cache_nodes=0)
