"""Granite-3 8B [hf:ibm-granite] — dense, GQA kv=8.

40L, d_model=4096, 32 heads, kv=8, d_ff=12800, vocab=49155.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab_size=49155,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=True,
        # §Perf A7: save matmul outputs in remat — backward recompute drops
        # from 1.0x to ~0.1x of forward FLOPs for +1.3 GB/chip (7.5 -> 8.8)
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=True, remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
