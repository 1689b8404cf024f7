"""Nemotron-4 15B [arXiv:2402.16819] — dense, GQA kv=8, squared-ReLU MLP.

32L, d_model=6144, 48 heads, kv=8, d_ff=24576, vocab=256000. Non-gated MLP
with squared ReLU; untied embeddings.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab_size=256000,
        pattern=(("attn", "mlp"),),
        activation="relu2", gated_mlp=False, tie_embeddings=False,
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab_size=512,
        pattern=(("attn", "mlp"),),
        activation="relu2", gated_mlp=False, tie_embeddings=False,
        remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
