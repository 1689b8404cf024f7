"""SeamlessM4T-large v2 [arXiv:2308.11596; hf] — encoder-decoder, multimodal.

d_model=1024, 16 heads (kv=16 == MHA), d_ff=8192, vocab=256206. The assigned
"24L" is realized as 24 encoder + 24 decoder layers (the published model's
speech-encoder/text-decoder depths). The speech frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings; the
decoder is a standard causal transformer with cross-attention.
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import ModelConfig, SubSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=256206,
        pattern=(("attn", "xattn", "mlp"),),
        n_enc_layers=24,
        enc_pattern=((SubSpec("attn", causal=False), "mlp"),),
        activation="gelu", gated_mlp=False, tie_embeddings=False,
        rope_theta=10000.0,
        # §Perf A7 (rolled out): matmul-saving remat — backward
        # recompute ~0.1x fwd instead of 1.0x; headroom verified in §Dry-run
        remat_policy="dots",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512,
        pattern=(("attn", "xattn", "mlp"),),
        n_enc_layers=2,
        enc_pattern=((SubSpec("attn", causal=False), "mlp"),),
        activation="gelu", gated_mlp=False, tie_embeddings=False, remat=False,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(dp_mode="manual")
