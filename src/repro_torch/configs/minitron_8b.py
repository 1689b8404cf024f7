"""Minitron-8B [arXiv:2407.14679; hf] — width-pruned Nemotron-4.

32L, d_model=4096, 32 heads, kv=8, d_ff=16384, vocab=256000. Inherits the
squared-ReLU non-gated MLP and untied embeddings from its Nemotron parent.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab_size=256000,
        pattern=(("attn", "mlp"),),
        activation="relu2", gated_mlp=False, tie_embeddings=False,
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        pattern=(("attn", "mlp"),),
        activation="relu2", gated_mlp=False, tie_embeddings=False,
        remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
