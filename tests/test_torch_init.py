"""The port's seeded weights against the JAX reference's, on the CPU.

``repro_torch.data.threefry.normal`` is ``jax.random.normal`` in f32 and
``repro_torch.models.transformer.init_params(cfg, seed)`` draws the
reference's ``init_params(jax.random.PRNGKey(seed), cfg)`` from the same
key tree, so one seed gives one set of weights in both packages. The limits
are the port's stated ones: every f32 value within 2 ulp of the
reference's, at least 95 % of the normal draws bit for bit (jax 0.9 on the
CPU gives all of them), and a bf16 leaf equal wherever its f32 value is not
within 2 ulp of a bf16 rounding midpoint. The card's draws are held to the
CPU's by ``chip_smoke.py`` phase 7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.data import threefry
from repro_torch.models import layers
from repro_torch.models import transformer as tf

PORTED_ARCHS = ("minicpm_2b", "nemotron_4_15b", "granite_3_8b",
                "minitron_8b")
ULP = 2


def _ordered(x: np.ndarray) -> np.ndarray:
    """f32 bit patterns as integers in the floats' order, so the difference
    of two is their distance in ulp."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _ulps(got, want) -> np.ndarray:
    return np.abs(_ordered(got) - _ordered(want))


@pytest.mark.parametrize("shape", [(1 << 20,), (3, 5, 7), (72, 12), (1,)])
@pytest.mark.parametrize("seed", [0, 1, 123456789, 2 ** 32 - 1])
def test_normal_matches_jax_random_normal(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = threefry.normal(threefry.prng_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    d = _ulps(got.numpy(), want)
    assert d.max() <= ULP
    assert (d == 0).mean() >= 0.95


def test_normal_tails_match_jax():
    """Draws beyond |z| = 3 take erf_inv's second branch (sqrt(w) - 3) and
    the large-argument log; a million draws hold about 2,700 of them."""
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.normal(key, (1 << 20,), jnp.float32))
    got = threefry.normal(threefry.prng_key(7), (1 << 20,)).numpy()
    tails = np.abs(want) > 3
    assert tails.sum() > 1000
    assert _ulps(got[tails], want[tails]).max() <= ULP


@pytest.mark.parametrize("start,stop", [(0, 1), (5, 1000), (999, 4096),
                                        (4095, 4096), (7, 7)])
def test_normal_pieces_have_the_wholes_bits(start, stop):
    key = threefry.prng_key(3)
    whole = threefry.normal(key, (64, 64)).reshape(-1)
    part = threefry.normal(key, (64, 64), start, stop)
    assert torch.equal(part.view(torch.int32),
                       whole[start:stop].view(torch.int32))
    with pytest.raises(ValueError):
        threefry.normal(key, (64, 64), 10, 5000)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _configs(arch: str, dt: str):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    return (dataclasses.replace(ref_base.get_config(arch, reduced=True),
                                param_dtype=jdt),
            dataclasses.replace(base.get_config(arch, reduced=True),
                                param_dtype=tdt))


def _near_bf16_midpoint(x: np.ndarray) -> np.ndarray:
    """Where f32 ``x`` lies within ``ULP`` ulp of a value halfway between
    two bf16 numbers (its low 16 bits within ULP of 0x8000)."""
    low = np.ascontiguousarray(x, np.float32).view(np.uint32) & 0xFFFF
    return np.abs(low.astype(np.int64) - 0x8000) <= ULP


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_init_params_are_the_references(arch, seed):
    """Every leaf of the reduced config in f32 and in bf16 parameters:
    the same tree, shapes and dtypes, f32 values within 2 ulp, bf16 values
    equal away from rounding midpoints."""
    f32_vals = {}
    for dt in ("f32", "bf16"):
        jcfg, cfg = _configs(arch, dt)
        want = dict(_leaves(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)),
            ref_tf.init_params(jax.random.PRNGKey(seed), jcfg))))
        got = dict(_leaves(tf.init_params(cfg, seed, "cpu")))
        assert got.keys() == want.keys()
        for name, t in got.items():
            g = t.to(torch.float32).numpy()
            assert g.shape == want[name].shape, name
            if dt == "f32":
                assert t.dtype == torch.float32, name
                assert _ulps(g, want[name]).max() <= ULP, name
                f32_vals[name] = g
            else:
                assert t.dtype == (torch.float32 if "norm" in name
                                   else torch.bfloat16), name
                differ = g != want[name]
                assert not (differ & ~_near_bf16_midpoint(
                    f32_vals[name])).any(), name


def test_chunked_draws_equal_unchunked(monkeypatch):
    """``dense_init`` draws in pieces of ``INIT_CHUNK`` flat elements; any
    piece size gives the same bits."""
    cfg = base.get_config("minicpm_2b", reduced=True)
    whole = dict(_leaves(tf.init_params(cfg, 11, "cpu")))
    monkeypatch.setattr(layers, "INIT_CHUNK", 1000)
    pieces = dict(_leaves(tf.init_params(cfg, 11, "cpu")))
    assert whole.keys() == pieces.keys()
    assert max(t.numel() for t in whole.values()) > 10 * 1000
    for name, t in whole.items():
        assert torch.equal(t.view(torch.int32), pieces[name].view(torch.int32)), \
            name


def test_dense_init_writes_in_place():
    key = threefry.prng_key(2)
    out = torch.full((2, 30, 20), float("nan"))
    layers.dense_init(key, (30, 20), dtype=torch.float32, out=out[1])
    assert bool(torch.isnan(out[0]).all())
    want = layers.dense_init(key, (30, 20))
    assert torch.equal(out[1], want)
    scale = np.float32(1 / np.sqrt(30))
    assert torch.equal(want, threefry.normal(key, (30, 20)) *
                       torch.tensor(scale))
