"""Step builders (the port of ``repro.launch.step_fns``, decode only).

:func:`make_serve_step` is the reference's ``slots=False`` branch on one
device: no mesh, no sharding specs and no tensor parallelism, and nothing to
compile, since PyTorch runs eagerly. The reference donates the caches to its
jitted step; the port's step updates the K/V rings in place, which is the
same contract: the caller uses the returned caches, not the ones it passed.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.models import transformer as tf

__all__ = ["make_serve_step"]


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
