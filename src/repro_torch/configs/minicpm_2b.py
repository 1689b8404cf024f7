"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, MHA (kv=36), WSD.

40L, d_model=2304, 36 heads (GQA kv=36 == MHA), d_ff=5760, vocab=122753.
Trains with the WSD (warmup-stable-decay) schedule — see repro.optim.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=True,
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-reduced",
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
        d_ff=160, vocab_size=512,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=True, remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")


TRAIN_SCHEDULE = "wsd"
