"""Step builders (the port of ``repro.launch.step_fns``): the train step,
the fixed-batch and the slot decode steps and the slot prefill step, on one
device.

:func:`make_train_step` is the reference's train step at one data-parallel
rank: no mesh and no sharding specs. At p = 1 the reference's gradient
reduction (``bucketed_all_reduce`` over a 1-rank axis, collectives.py:327)
returns its input and its division by the rank count is by 1, so the port
calls no collective. :func:`make_serve_step` and
:func:`make_prefill_step` are the reference's builders for the
fixed-batch loop (``slots=False``) and for the continuous-batching engine
(``slots=True``, ``into_slots=True``). Nothing compiles, since PyTorch
runs eagerly. The
reference donates the params, optimizer state and caches to its jitted
steps; the port's steps update them in place, which is the same contract:
the caller uses what a step returns, not what it passed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (Optimizer, adamw, cosine_schedule,
                                         tree_leaves, tree_map)

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]

_TP = ("tensor-parallel decode is not ported yet: ROADMAP.md queue 1, "
       "'Next' item 4 (the dist transport)")


def _grad_leaves(params, grads):
    """A copy of ``params``' nesting whose leaves require grad and route it
    into ``grads`` (f32 buffers of the same shapes): each stacked layer leaf
    becomes a list of per-period leaves, views of its storage, so the
    backward of one period's slice adds into that period's rows of the
    buffer instead of materialising a gradient of the whole stack; every
    leaf's gradient is added into its buffer as it lands and then dropped
    (a leaf used twice, like the tied embedding, lands twice)."""
    def leaf(p, g):
        t = p.detach().requires_grad_(True)

        def land(t, g=g):
            g.add_(t.grad)
            t.grad = None
        t.register_post_accumulate_grad_hook(land)
        return t

    def conv(p, g, stacked):
        if isinstance(p, dict):
            return {k: conv(p[k], g[k], stacked) for k in p}
        if isinstance(p, (list, tuple)):
            return type(p)(conv(a, b, stacked) for a, b in zip(p, g))
        if stacked:
            return [leaf(p[i], g[i]) for i in range(p.shape[0])]
        return leaf(p, g)

    return {k: conv(v, grads[k], k == "layers") for k, v in params.items()}


def make_train_step(cfg: tf.ModelConfig, pcfg: ParallelConfig | None = None,
                    optimizer: Optimizer | None = None, accum: int = 1):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``metrics`` the f32 vector ``[loss, ce, aux,
    grad_norm]``. ``accum`` > 1 splits the batch into that many
    microbatches and averages their losses and f32-accumulated gradients,
    as the reference does. Parameters and optimizer state are updated in
    place (the reference donates them)."""
    if pcfg is not None and pcfg.tp_shards > 1:
        raise NotImplementedError(
            "tensor parallelism is not ported yet: ROADMAP.md queue 1, "
            "'Next' item 4 (the dist transport)")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    tf.check_supported(cfg)
    if optimizer is None:
        optimizer = adamw(cosine_schedule(3e-4, 100, 10000))

    def step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        mb = B // accum
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        leaves = _grad_leaves(params, grads)
        dev = batch["tokens"].device
        tot = torch.zeros(3, dtype=torch.float32, device=dev)
        for a in range(accum):
            part = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
            loss, mets = tf.loss_fn(leaves, cfg, part)
            loss.backward()
            tot += torch.stack([loss.detach(), mets["ce"].detach(),
                                mets["aux"].detach()]).to(torch.float32)
        del leaves
        if accum > 1:
            tot /= accum
            with torch.no_grad():
                for g in tree_leaves(grads):
                    g.div_(accum)
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, torch.cat([tot, om["grad_norm"][None]])

    return step


def _guard(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The decode-logits guard: a row whose logits hold a NaN or an inf
    reports the ``-1`` sentinel instead of a token, so the engine refuses
    to commit the tick (an argmax over non-finite logits still yields a
    plausible id)."""
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, tokens, torch.full_like(tokens, -1))


def make_serve_step(cfg: tf.ModelConfig, pcfg: ParallelConfig | None = None,
                    slots: bool = False):
    """The decode step.

    ``slots=False``: ``step(params, inputs, caches) -> (logits (B, V) f32,
    caches)``, the fixed-batch decode step (every row advances every call).

    ``slots=True``: ``step(params, inputs, caches, active, sampling=None)
    -> (tokens (B,) int64 on the device, caches)`` against per-slot caches,
    the continuous-batching engine's tick. ``active`` (B,) host bools marks
    the rows holding in-flight requests; the others write nothing and keep
    their positions. ``sampling`` is None (greedy argmax) or the per-slot
    sampler state ``{key (B, 2), step (B,), temperature (B,), top_k (B,),
    top_p (B,)}``; greedy rows take the same argmax either way. A row whose
    logits are not finite returns ``-1``."""
    if pcfg is not None and pcfg.tp_shards > 1:
        raise NotImplementedError(_TP)
    tf.check_supported(cfg)

    if not slots:
        @torch.no_grad()
        def step(params, inputs, caches):
            return tf.decode_step(params, cfg, inputs, caches)

        return step

    from repro_torch.serving.sampling import sample_tokens

    @torch.no_grad()
    def slot_step(params, inputs, caches, active, sampling=None):
        logits, caches = tf.decode_step(params, cfg, inputs, caches,
                                        active=active)
        if sampling is None:
            tokens = torch.argmax(logits, dim=-1)
        else:
            tokens = sample_tokens(logits, sampling["key"], sampling["step"],
                                   sampling["temperature"],
                                   sampling["top_k"], sampling["top_p"])
        return _guard(logits, tokens), caches

    return slot_step


def _splice_pos(caches: tuple, rows: tuple, slot: int) -> tuple:
    """``caches`` with slot ``slot``'s positions taken from the batch-of-1
    ``rows`` (the K/V rows are views, written already)."""
    out = []
    for c, r in zip(caches, rows):
        pos = c["pos"].clone()
        pos[:, slot] = r["pos"][:, 0]
        out.append({**c, "pos": pos})
    return tuple(out)


def make_prefill_step(cfg: tf.ModelConfig, pcfg: ParallelConfig | None = None,
                      into_slots: bool = True):
    """The serving engine's cache-writing prefill: ``step(params, tokens
    (1, Tc), caches, slot, length, resume=False, sampling_row=None) ->
    (first token (0-dim int64 on the device), caches)``.

    The prompt chunk runs through the stack as a single row, on views of
    the slot's row of the per-slot caches, so its K/V lands in the slot in
    place and every other slot stays bit-unchanged; the cost follows the
    chunk, not the slot count. ``resume=False`` starts the row at position
    0 (a first chunk), ``resume=True`` continues it (chunks 2..n). The
    token, meaningful on the final chunk, is the argmax of the last real
    position's logits, or with ``sampling_row`` (``{key (2,), temperature,
    top_k, top_p}``) the seeded sampler's draw at step 0. The reference's
    ``into_slots=False`` form (the dry run's prefill proxy) comes with
    queue 1's item 7."""
    if not into_slots:
        raise NotImplementedError(
            "the full-sequence prefill proxy is not ported yet: ROADMAP.md "
            "queue 1, 'Next' item 7 (tooling and benches)")
    if pcfg is not None and pcfg.tp_shards > 1:
        raise NotImplementedError(_TP)
    tf.check_supported(cfg)
    from repro_torch.serving.sampling import sample_tokens

    @torch.no_grad()
    def step(params, tokens, caches, slot, length, *, resume=False,
             sampling_row=None):
        slot, length = int(slot), int(length)
        logits, rows = tf.prefill_step(
            params, cfg, {"tokens": tokens}, tf.cache_row(caches, slot),
            [length], resume=resume)
        caches = _splice_pos(caches, rows, slot)
        if sampling_row is None:
            return torch.argmax(logits[0]), caches
        row = {k: np.asarray(v)[None] for k, v in sampling_row.items()}
        first = torch.zeros(1, dtype=torch.int64)     # the first token: step 0
        tok = sample_tokens(logits, row["key"], first, row["temperature"],
                            row["top_k"], row["top_p"])
        return tok[0], caches

    return step
