"""Optimizers and LR schedules (the port of ``repro.optim.optimizers``).

AdamW and SGD-momentum with global-norm clipping over the port's parameter
trees (nested dicts, lists and tuples of tensors); cosine and WSD
(warmup-stable-decay, the MiniCPM schedule) schedules. Moments are f32 and
every operation runs in the reference's order, with its constants rounded
to f32 as JAX rounds weakly-typed Python scalars.

The reference is pure-functional; here ``update`` works in place: the
gradients are clipped, the moments advanced and the parameters written
where they lie, which saves a copy of each at full width (MiniCPM-2B's f32
parameters, gradients and moments take 43.6 GB). It returns the same
containers, so the caller's contract is the reference's: use what it
returns.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "tree_leaves", "tree_map", "clip_by_global_norm",
           "adamw", "sgdm", "Schedule", "wsd_schedule", "cosine_schedule"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``jax.tree.leaves`` order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the tensors of ``tree``, keeping its nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global L2 norm is at most
    ``max_norm``; returns ``(grads, norm)``, the norm an f32 0-dim tensor
    (the f32 sum of each leaf's f32 sum of squares, in leaf order)."""
    leaves = tree_leaves(grads)
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        g2 = g2 + torch.sum(torch.square(g.to(torch.float32)))
    norm = torch.sqrt(g2)
    scale = torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-12),
                        max=1.0)
    for g in leaves:
        g.mul_(scale)       # in f32, rounded to g's dtype
    return grads, norm


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        t = step.to(torch.float32)
        lr_t = lr_fn(step)
        c1 = 1.0 - torch.pow(_f32(b1, t), t)
        c2 = 1.0 - torch.pow(_f32(b2, t), t)
        for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g * (1 - b1))
            n.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            u = (m / c1).div_(torch.sqrt(n / c2).add_(eps))
            u.add_(p.to(torch.float32) * weight_decay)
            p.sub_(u.mul_(lr_t))        # in f32, rounded to p's dtype
            del u
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def sgdm(lr, momentum: float = 0.9, max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = lr_fn(step)
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            m.mul_(momentum).add_(g.to(torch.float32))
            p.sub_(lr_t * m)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


# ---------------------------- schedules -----------------------------------

Schedule = Callable[[torch.Tensor], torch.Tensor]


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.1) -> Schedule:
    """MiniCPM's warmup-stable-decay: linear warmup, long flat stage, then a
    fast exponential-ish decay to ``floor_frac * peak``."""
    def fn(step):
        s = step.to(torch.float32)
        wu = peak * s / max(warmup, 1)
        dec_t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak * torch.pow(_f32(floor_frac, s), dec_t)
        return torch.where(s < warmup, wu,
                           torch.where(s < warmup + stable, _f32(peak, s),
                                       dec))
    return fn


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Schedule:
    def fn(step):
        s = step.to(torch.float32)
        wu = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac * peak + (1 - floor_frac) * peak * 0.5 \
            * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, wu, cos)
    return fn
