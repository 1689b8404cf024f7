"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay linear recurrence.

32L, d_model=4096, head_dim=64 (64 heads), channel-mix dim 14336 (3.5x),
vocab=65536. O(1)-state decode makes it a long_500k architecture.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab_size=65536,
        pattern=(("rwkv",),),
        tie_embeddings=False, rwkv_head_dim=64,
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=224, vocab_size=512,
        pattern=(("rwkv",),),
        tie_embeddings=False, rwkv_head_dim=16, remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
