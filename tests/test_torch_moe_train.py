"""The port's MoE models' forward and loss against the JAX reference, on the
CPU: reduced Mixtral-8x22B and reduced Llama-4 Scout (the configs and
helpers of ``tests/test_torch_moe.py``).

Tolerances, on the reference's largest |value|:

* forward logits: ``1e-5`` in f32, ``6 * 2**-8`` in bf16 (the bound of
  ``tests/test_torch_models.py``);
* ``loss_fn``'s ce and aux: ``1e-5`` in f32, ``2**-8`` in bf16, and its
  gradients ``1e-5`` of each leaf's largest |gradient| in f32 (the bounds
  of ``tests/test_torch_train.py``);
* its bf16 gradients: ``6e-2`` of each leaf's norm, in the norm of the
  difference. The cross-entropy's gradient is softmax minus one-hot, so
  the logits' bf16 error, times their size, moves every gradient alike:
  measured at most 3.5 % of a leaf's norm on reduced Scout and 2.0 % on
  reduced Mixtral, where one element's gap reaches 6.5 % of a norm
  scale's largest, so the bound is on the norm, with room;
* a router near-tie under bf16: a top-k margin within ``2**-8`` of the
  layer's largest |router logit| (the one token that moves, reduced Scout
  seed 1, has a margin of 1.8e-3 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as optim
from test_torch_moe import ARCHS, B, T, _configs, _err, _np, _params

LOGIT_TOL = {"f32": 1e-5, "bf16": 6 * 2.0 ** -8}
LOSS_TOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
GRAD_TOL = {"f32": 1e-5, "bf16": 6e-2}  # largest element; bf16: leaf norm
TIE_TOL = 2.0 ** -8


def _batch(vocab: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, T)).astype(np.int32)
            for k in ("tokens", "labels")}


class _RefRoutes:
    """Records every ``jax.lax.top_k`` the reference runs (its router's, in
    each MoE sublayer), as (logits, ids), through ``jax.debug.callback``,
    so inside ``jit`` and ``value_and_grad`` too."""

    def __init__(self, monkeypatch):
        self.records = []
        orig = jax.lax.top_k

        def top_k(x, k):
            v, i = orig(x, k)
            jax.debug.callback(
                lambda a, b: self.records.append((np.asarray(a),
                                                  np.asarray(b))), x, i)
            return v, i

        monkeypatch.setattr(jax.lax, "top_k", top_k)

    def near(self, logits: np.ndarray) -> tuple:
        """The record whose logits are nearest ``logits``: the same
        sublayer's call on the reference's side."""
        cands = [r for r in self.records if r[0].shape == logits.shape]
        return min(cands, key=lambda r: np.abs(r[0] - logits).max())


def _port_routed_as(routes: _RefRoutes, monkeypatch, dt: str) -> list:
    """Route the port's MoE sublayers as the reference routed the same
    sublayer's tokens (its nearest record), after checking that any token
    the port would route otherwise sits at a near-tie of the reference's
    router: its k-th and (k+1)-th logits within ``TIE_TOL`` of the layer's
    largest |logit|. Returns the tokens routed otherwise."""
    orig = tf._top_k
    moved = []

    def top_k(logits, k):
        want_l, want_i = routes.near(logits.detach().numpy())
        _, mine = orig(logits, k)
        differ = (mine.numpy() != want_i).any(-1)
        srt = -np.sort(-want_l, axis=-1)
        margin = srt[..., k - 1] - srt[..., k]
        tie = TIE_TOL * np.abs(want_l).max()
        assert (margin[differ] <= tie).all(), (margin[differ], tie)
        moved.extend(map(tuple, np.argwhere(differ)))
        idx = torch.from_numpy(np.array(want_i, dtype=np.int64))
        return torch.gather(logits, -1, idx), idx

    monkeypatch.setattr(tf, "_top_k", top_k)
    return moved


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match(arch, dt, monkeypatch):
    """``forward``'s logits and aux, then ``loss_fn``'s ce, aux and
    gradients against ``jax.value_and_grad`` of the reference's.

    A router near-tie may fall either way under bf16 rounding, and a token
    routed to another expert comes out another token (reduced Scout, seed
    1: token 9 of row 0 in its second layer, a top-2 margin of 1.2e-3 on
    logits of about 0.5). So the port routes as the reference did, call by
    call, once every token it would route otherwise is shown to sit at such
    a tie; under f32 it routes as the reference in every call."""
    jcfg, cfg = _configs(arch, dt)
    jp, p = _params(jcfg)
    b = _batch(jcfg.vocab_size)
    routes = _RefRoutes(monkeypatch)

    def jfwd(params, tokens):
        x, aux = ref_tf.forward(params, jcfg, {"tokens": tokens})
        return ref_tf.unembed(params, jcfg, x), aux

    want, waux = jax.jit(jfwd)(jp, jnp.asarray(b["tokens"]))
    jax.effects_barrier()
    assert len(routes.records) == cfg.n_layers
    moved = _port_routed_as(routes, monkeypatch, dt)
    with torch.no_grad():
        x, aux = tf.forward(p, cfg, {"tokens": torch.from_numpy(
            b["tokens"])})
        got = tf.unembed(p, cfg, x)
    assert _err(got, want) <= LOGIT_TOL[dt]
    assert _err(aux, waux) <= LOSS_TOL[dt]
    assert float(aux) > 0
    routes.records.clear()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q, xb: ref_tf.loss_fn(q, jcfg, xb), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    jax.effects_barrier()
    leaves = optim.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss, mets = tf.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    loss.backward()
    assert _err(loss, jl) <= LOSS_TOL[dt]
    assert _err(mets["ce"], jm["ce"]) <= LOSS_TOL[dt]
    assert _err(mets["aux"], jm["aux"]) <= LOSS_TOL[dt]
    jleaves = jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for t, g in zip(leaves, jleaves):
        assert t.grad.shape == g.shape
        assert bool(torch.isfinite(t.grad).all())
        if dt == "f32":
            assert _err(t.grad, g) <= GRAD_TOL[dt]
        else:
            gap = np.linalg.norm(_np(t.grad) - _np(g))
            assert gap <= GRAD_TOL[dt] * np.linalg.norm(_np(g)), g.shape
    if dt == "f32":
        assert not moved
