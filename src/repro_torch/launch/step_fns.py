"""Step builders (the port of ``repro.launch.step_fns``): the train step
and the fixed-batch decode step, on one device.

:func:`make_train_step` is the reference's train step at one data-parallel
rank: no mesh and no sharding specs. At p = 1 the reference's gradient
reduction (``bucketed_all_reduce`` over a 1-rank axis, collectives.py:327)
returns its input and its division by the rank count is by 1, so the port
calls no collective. :func:`make_serve_step` is the reference's
``slots=False`` branch. Nothing compiles, since PyTorch runs eagerly. The
reference donates the params, optimizer state and caches to its jitted
steps; the port's steps update them in place, which is the same contract:
the caller uses what a step returns, not what it passed.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (Optimizer, adamw, cosine_schedule,
                                         tree_leaves, tree_map)

__all__ = ["make_train_step", "make_serve_step"]


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


def make_serve_step(cfg: tf.ModelConfig, pcfg: ParallelConfig | None = None,
                    slots: bool = False):
    """Returns ``step(params, inputs, caches) -> (logits (B, V) f32,
    caches)``, the fixed-batch decode step (every row advances every
    call)."""
    if slots:
        raise NotImplementedError(
            "slot serving (per-row positions, prefill_step) is not ported "
            "yet: ROADMAP.md queue 1, 'Next' item 2 (the continuous engine)")
    if pcfg is not None and pcfg.tp_shards > 1:
        raise NotImplementedError(
            "tensor-parallel decode is not ported yet: ROADMAP.md queue 1, "
            "'Next' item 4 (the dist transport)")
    tf.check_supported(cfg)

    @torch.no_grad()
    def step(params, inputs, caches):
        return tf.decode_step(params, cfg, inputs, caches)

    return step
