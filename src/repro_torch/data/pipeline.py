"""The synthetic data stream (the port of ``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step, shard)``, drawn with
threefry (:mod:`repro_torch.data.threefry`) exactly as the reference draws
it with ``jax.random``, so ``batch_at`` gives the reference's int32 tokens
and labels bit for bit, on the CPU or on the card. Tokens are Zipf-ish ids
(the CDF built in float64, then rounded to float32, searched on the left)
where, with probability 0.25, token ``t+1`` repeats token ``t``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.transport import resolve_device
from repro_torch.data import threefry

__all__ = ["DataConfig", "SyntheticLM", "build_batches"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Stateless-indexable LM dataset: ``batch_at(step, shard, n_shards)``,
    its tensors on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        cdf = np.cumsum(probs / probs.sum()).astype(np.float32)
        self._cdf = torch.from_numpy(cdf).to(self.device)

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        shape = (cfg.global_batch // n_shards, cfg.seq_len + 1)
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(cfg.seed, self.device), step), shard)
        k1, k2 = threefry.split(key)
        u = threefry.uniform(k1, shape)
        toks = torch.searchsorted(self._cdf, u).to(torch.int32)
        toks = toks.clamp(0, cfg.vocab_size - 1)
        # structure: with p=.25 copy the previous token (learnable bigram)
        rep = threefry.uniform(k2, shape) < 0.25
        toks = torch.where(rep, torch.roll(toks, 1, dims=1), toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def build_batches(cfg: DataConfig, start_step: int = 0, shard: int = 0,
                  n_shards: int = 1, device=None) -> Iterator[tuple]:
    """Resumable batch iterator; yields (step, batch)."""
    ds = SyntheticLM(cfg, device)
    step = start_step
    while True:
        yield step, ds.batch_at(step, shard, n_shards)
        step += 1
