"""Mixtral 8x22B [arXiv:2401.04088; hf] — sparse MoE, 8 experts top-2, SWA.

56L, d_model=6144, 48 heads, kv=8, d_ff=16384 per expert, vocab=32768,
sliding window 4096. ~141B total / ~39B active parameters -> FSDP regime.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import (ModelConfig, MoESettings, SubSpec)

_SWA = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        pattern=((SubSpec("attn", sliding_window=_SWA), "moe"),),
        moe=MoESettings(n_experts=8, top_k=2),
        activation="silu", gated_mlp=True, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        pattern=((SubSpec("attn", sliding_window=16), "moe"),),
        moe=MoESettings(n_experts=4, top_k=2),
        activation="silu", gated_mlp=True, tie_embeddings=False, remat=False,
    )


def parallel() -> ParallelConfig:
    # pod_sync='auto': mixtral's (d=6144, 56L) dims trip an XLA SPMD
    # gather-partitioner check failure under subgrouped manual axes at 512
    # devices; GSPMD handles the cross-pod reduction instead (DESIGN.md §5).
    return ParallelConfig(dp_mode="fsdp", pod_sync="auto")
