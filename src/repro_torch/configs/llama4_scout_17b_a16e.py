"""Llama-4 Scout 17B-A16E [hf:meta-llama] — MoE 16 experts top-1, iRoPE.

48L, d_model=5120, 40 heads, kv=8, d_ff=8192 per expert, vocab=202048.
iRoPE-style pattern: 3 chunked-attention RoPE layers then 1 global-attention
NoPE layer (the sub-quadratic chunked layers make long_500k runnable).
"""

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.transformer import (ModelConfig, MoESettings, SubSpec)

_CHUNK = 8192


def config() -> ModelConfig:
    local = SubSpec("attn", chunk_size=_CHUNK)
    glob = SubSpec("attn", use_rope=False)
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        pattern=((local, "moe"), (local, "moe"), (local, "moe"),
                 (glob, "moe")),
        moe=MoESettings(n_experts=16, top_k=1),
        activation="silu", gated_mlp=True, tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    local = SubSpec("attn", chunk_size=16)
    glob = SubSpec("attn", use_rope=False)
    return ModelConfig(
        name="llama4-scout-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=512,
        pattern=((local, "moe"), (local, "moe"), (local, "moe"),
                 (glob, "moe")),
        moe=MoESettings(n_experts=4, top_k=1),
        activation="silu", gated_mlp=True, tie_embeddings=False, remat=False,
    )


def parallel() -> ParallelConfig:
    # pod_sync='auto': the MoE-dispatch sharding pins + subgrouped manual pod
    # axis trip an XLA SPMD partitioner bug for this config at 512 devices;
    # GSPMD handles the cross-pod reduction (jamba keeps dptree over pods —
    # the technique is exercised there; see DESIGN.md §5).
    return ParallelConfig(dp_mode="fsdp", pod_sync="auto")
