"""The port's seeded sampler against ``jax.random`` and the reference's
``repro.serving.sampling``, on the CPU.

Keys, the vector ``fold_in``, the Gumbel noise and ``categorical`` are held
bitwise. ``sample_tokens`` is held token for token on greedy,
temperature-only and top-k rows. Top-p rows are equal too, except where
the sorted cumulative mass of a row lies within 1e-6 of its ``top_p``: the
two frameworks' softmax and cumulative sum round differently, so such a
row may keep one token more or less; the test counts those rows and skips
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as ref_sampling
from repro_torch.data import threefry
from repro_torch.serving import sampling

TOP_P_EDGE = 1e-6


def _keys(rng, B):
    return np.stack([ref_sampling.base_key(
        ref_sampling.SamplingParams(seed=int(s)))
        for s in rng.integers(0, 2 ** 31, B)])


def test_base_key_and_slot_arrays_are_the_references():
    for seed in (0, 1, 7, 2 ** 31 - 1):
        want = ref_sampling.base_key(ref_sampling.SamplingParams(seed=seed))
        got = sampling.base_key(sampling.SamplingParams(seed=seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    a, b = sampling.slot_arrays(3), ref_sampling.slot_arrays(3)
    p = sampling.SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=4)
    sampling.set_slot(a, 1, p)
    ref_sampling.set_slot(b, 1, ref_sampling.SamplingParams(
        temperature=0.7, top_k=5, top_p=0.9, seed=4))
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_rows_is_jax_vmap_fold_in(seed):
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 16)
    steps = rng.integers(0, 2 ** 31, 16).astype(np.int32)
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(steps))
    got = threefry.fold_in_rows(torch.from_numpy(keys.astype(np.int64)),
                                torch.from_numpy(steps))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("V", [1, 101, 4099])
def test_gumbel_and_categorical_are_jax_random(V):
    rng = np.random.default_rng(V)
    keys = jnp.asarray(_keys(rng, 8))
    tk = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys)
    got = threefry.gumbel_rows(tk, V)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    logits = (rng.standard_normal((8, V)) * 4).astype(np.float32)
    logits[:, ::5] = -np.inf
    logits[:, 0] = 0.0                  # a row never fully masked
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    got = threefry.categorical(tk, torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _top_p_edge(logits, temperature, top_k, top_p) -> np.ndarray:
    """Rows whose sorted cumulative mass (after the temperature and top-k,
    in f64) comes within TOP_P_EDGE of their top_p."""
    edge = np.zeros(len(logits), bool)
    for b in range(len(logits)):
        if top_p[b] >= 1.0 or temperature[b] == 0:
            continue
        s = logits[b].astype(np.float64) / max(temperature[b], 1e-6)
        if top_k[b] > 0:
            s = np.where(s >= np.sort(s)[::-1][top_k[b] - 1], s, -np.inf)
        p = np.exp(s - s.max())
        p = np.sort(p / p.sum())[::-1]
        edge[b] = (np.abs(np.cumsum(p) - top_p[b]) < TOP_P_EDGE).any()
    return edge


@pytest.mark.parametrize("kind", ["greedy", "temperature", "top_k", "top_p",
                                  "mixed"])
def test_sample_tokens_is_the_references(kind):
    rng = np.random.default_rng(len(kind))
    B, V = 96, 257
    logits = (rng.standard_normal((B, V)) * 2.5).astype(np.float32)
    keys = _keys(rng, B)
    steps = rng.integers(0, 100, B).astype(np.int32)
    temperature = rng.uniform(0.3, 1.7, B).astype(np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    if kind == "greedy":
        temperature[:] = 0
    if kind in ("top_k", "mixed"):
        top_k = rng.integers(1, 60, B).astype(np.int32)
    if kind in ("top_p", "mixed"):
        top_p = rng.uniform(0.3, 0.99, B).astype(np.float32)
    if kind == "mixed":
        temperature[::4] = 0
        top_k[1::3] = 0
        top_p[2::5] = 1.0
    want = np.asarray(jax.jit(ref_sampling.sample_tokens)(
        *(jnp.asarray(a) for a in (logits, keys, steps, temperature, top_k,
                                   top_p))))
    got = sampling.sample_tokens(torch.from_numpy(logits), keys, steps,
                                 temperature, top_k, top_p).numpy()
    edge = _top_p_edge(logits, temperature, top_k, top_p)
    if kind in ("greedy", "temperature", "top_k"):
        assert not edge.any()
    assert edge.sum() <= B // 10, f"{edge.sum()} rows at the top_p edge"
    assert np.array_equal(got[~edge], want[~edge])
    if kind == "greedy":
        assert np.array_equal(got, logits.argmax(-1))


def test_sample_tokens_topk1_and_tiny_topp_are_argmax():
    """top_k = 1, or top_p below the largest probability, keep only the
    argmax, whatever the key and temperature."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    keys = _keys(rng, 6)
    steps = np.arange(6, dtype=np.int32)
    temp = np.full(6, 1.3, np.float32)
    for top_k, top_p in ((1, 1.0), (0, 1e-4)):
        got = sampling.sample_tokens(
            torch.from_numpy(logits), keys, steps, temp,
            np.full(6, top_k, np.int32), np.full(6, top_p, np.float32))
        assert np.array_equal(got.numpy(), logits.argmax(-1))


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            sampling.SamplingParams(**bad)
    assert sampling.GREEDY.greedy
    assert not sampling.SamplingParams(temperature=0.5).greedy
