"""Qwen2-VL 7B [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

28L, d_model=3584, 28 heads, kv=4, d_ff=18944, vocab=152064. The vision
frontend is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings merged into the token stream, plus (t, h, w) position ids
for M-RoPE (head_dim 128 -> bands 16/24/24 frequency pairs).
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=False,
        mrope_sections=(16, 24, 24), input_mode="embeds",
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=512,
        pattern=(("attn", "mlp"),),
        activation="silu", gated_mlp=True, tie_embeddings=False,
        mrope_sections=(2, 3, 3), input_mode="embeds", remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
