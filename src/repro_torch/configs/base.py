"""Config substrate: architecture registry and shape suites.

The port of ``repro.configs.base``. Every architecture is a module
``repro_torch.configs.<id>`` exporting ``config()`` (the published figures)
and ``reduced()`` (a tiny same-family variant for CPU tests), with the
reference's numbers. Only the sublayer kinds this slice ports (``attn``,
``mlp``) build a model; the registry itself resolves every arch. The
reference's ``ShapeDtypeStruct`` input specs belong to its dry-run and have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.core.collectives import CollectiveConfig
from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCHS", "ALIASES", "ShapeSuite", "SHAPES", "ParallelConfig",
           "get_arch", "get_config", "get_parallel", "decode_config"]

ARCHS = (
    "minicpm_2b",
    "nemotron_4_15b",
    "granite_3_8b",
    "minitron_8b",
    "rwkv6_7b",
    "mixtral_8x22b",
    "llama4_scout_17b_a16e",
    "jamba_v0_1_52b",
    "qwen2_vl_7b",
    "seamless_m4t_large_v2",
)

# canonical external ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSuite("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a model maps onto devices: the reference's fields. This slice
    runs on one device, so only the fields' values are carried; ``dp_mode``
    is ``'manual'`` or ``'fsdp'`` and ``tp_shards`` counts tensor-parallel
    ranks (1 here)."""
    dp_mode: str = "manual"
    collective: CollectiveConfig = CollectiveConfig(method="dptree")
    zero1: bool = True
    grad_accum: int = 1
    pod_sync: str = "dptree"
    tp_shards: int = 1
    tp_collective: CollectiveConfig = CollectiveConfig(method="auto")


def get_arch(name: str):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = get_arch(name)
    return mod.reduced() if reduced else mod.config()


def get_parallel(name: str) -> ParallelConfig:
    mod = get_arch(name)
    return getattr(mod, "parallel", lambda: ParallelConfig())()


def decode_config(cfg: ModelConfig) -> ModelConfig:
    """The config the reference decodes with (``launch/dryrun.py:57-61``):
    bf16 parameters, and the int8 K/V cache where the cache is MHA-heavy,
    ``n_kv_heads * head_dim >= 2048`` (MiniCPM-2B: 36 * 64), because there
    int8 halves the dominant decode memory term."""
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    if cfg.n_kv_heads * cfg.hdim >= 2048:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg
