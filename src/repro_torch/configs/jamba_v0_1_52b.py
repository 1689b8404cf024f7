"""Jamba v0.1 52B [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7, MoE.

32L, d_model=4096, 32 heads, kv=8, d_ff=14336, vocab=65536, MoE 16e top-2 on
every other layer. Period-8 pattern with attention at index 4 (1 attention per
8 layers), Mamba elsewhere; O(1)-state Mamba layers + 4 attention layers make
long_500k decode tractable.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import (ModelConfig, MoESettings, SubSpec)


def _pattern():
    layers = []
    for idx in range(8):
        mixer = "attn" if idx == 4 else "mamba"
        ffn = "moe" if idx % 2 == 1 else "mlp"
        layers.append((mixer, ffn))
    return tuple(layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        pattern=_pattern(),
        moe=MoESettings(n_experts=16, top_k=2),
        activation="silu", gated_mlp=True, tie_embeddings=False,
        mamba_d_state=16,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-reduced",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=512,
        pattern=_pattern(),
        moe=MoESettings(n_experts=4, top_k=2),
        activation="silu", gated_mlp=True, tie_embeddings=False,
        mamba_d_state=8, remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="fsdp")
