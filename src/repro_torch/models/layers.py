"""Neural layers of the decode path (the port of ``repro.models.layers``).

Plain functions on tensors with parameters in nested dicts, in the
reference's layouts: activations ``(B, T, D)``, heads ``(B, T, H, dh)``,
K/V rings ``(B, S, KV, dh)``, so the parity tests compare like with like.
This slice ports what the fixed-batch decode loop and the short-sequence
forward run: RMSNorm, the activations, RoPE (without M-RoPE), GQA attention
with causal, window and chunk masks, the ring K/V cache in bf16 or int8, and
the MLP. ``attention`` at T > ``FLASH_THRESHOLD`` takes the flash path,
as the reference does: :func:`repro_torch.kernels.flash_attention.flash_sdpa`,
the hand-written kernel on a CUDA tensor and the port of the reference's
``_flash_sdpa`` on the CPU, differentiable either way.

Compute follows the reference's dtype rules: matmuls in the activation
dtype, attention logits and softmax in f32, RoPE in f32 and rounded back.
The int8 cache rows go through :mod:`repro_torch.kernels.ops`, so on a CUDA
tensor they run the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.data import threefry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

__all__ = ["Params", "AttnConfig", "FLASH_THRESHOLD", "INIT_CHUNK",
           "dense_init", "rmsnorm_init", "rmsnorm", "act_fn", "rope_freqs", "apply_rope",
           "attention", "attention_decode", "mlp"]

Params = dict

FLASH_THRESHOLD = 1024   # direct sdpa at or below, flash above
# normal draws per piece in dense_init: 2**24 elements keep the threefry
# hash's int64 and the erf_inv's f64 temporaries to 128 MB each
INIT_CHUNK = 1 << 24


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------

def dense_init(key: torch.Tensor, shape, scale: float | None = None,
               dtype=torch.float32, device=None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's ``dense_init``: ``jax.random.normal(key, shape)``
    times ``scale`` (default ``1/sqrt(fan_in)``), both f32, cast to
    ``dtype``. ``key`` is a threefry key on the host; the values are drawn
    on ``device`` in pieces of ``INIT_CHUNK`` flat elements (each element
    hashes its own index, so the pieces change no bit), which bounds the
    hash's temporaries. With ``out`` (``shape``, ``dtype``, contiguous) the
    values are written there."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    s = torch.tensor(scale, dtype=torch.float32, device=out.device)
    n = flat.numel()
    for i0 in range(0, n, INIT_CHUNK):
        i1 = min(n, i0 + INIT_CHUNK)
        part = threefry.normal(key, shape, i0, i1, out.device).view(-1)
        flat[i0:i1] = (part * s).to(dtype)
    return out


def _stacked(keys, shapes: dict, dtype, device) -> Params:
    """``{name: (n, *shape)}`` leaves, period ``i`` of leaf ``j`` drawn by
    :func:`dense_init` from key ``j`` of ``keys[i]``; ``shapes`` maps each
    name to ``(shape, scale)``."""
    p = {name: torch.empty((len(keys), *shape), dtype=dtype, device=device)
         for name, (shape, _) in shapes.items()}
    for i, ks in enumerate(keys):
        for j, (name, (shape, scale)) in enumerate(shapes.items()):
            dense_init(ks[j], shape, scale, dtype, out=p[name][i])
    return p


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------

def rmsnorm_init(dim: int, device=None, periods: int | None = None
                 ) -> Params:
    shape = (dim,) if periods is None else (periods, dim)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * p["scale"]).to(dt)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu
    if name == "relu2":          # squared ReLU (nemotron-4)
        return _relu2
    raise ValueError(name)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """x: (B, T, H, dh); positions: (B, T) (or (B, T, 3), first component).
    Rotate-half convention, angles and products in f32, rounded back to
    x's dtype."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE is not ported yet: ROADMAP.md queue 1, 'Next' item 3 "
            "(other sublayer kinds and inputs)")
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)      # (dh/2,)
    if positions.dim() == 3:
        positions = positions[..., 0]
    ang = positions[..., None].to(torch.float32) * freqs   # (B, T, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, sliding-window, chunked, KV cache)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: int | None = None     # SWA width (mixtral)
    chunk_size: int | None = None         # chunked attention (llama4-scout)
    causal: bool = True                   # False for encoder self-attn
    mrope_sections: tuple | None = None   # (t, h, w) bands for M-RoPE
    use_rope: bool = True


def attn_init(keys, cfg: AttnConfig, dtype=torch.float32,
              device=None) -> Params:
    """The reference's ``attn_init`` for each key of ``keys`` (one per
    period), stacked along a leading period axis: each key splits in four,
    for ``wq``, ``wk``, ``wv`` and ``wo`` (scale ``1/sqrt(H * dh)``)."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": ((D, H * dh), None), "wk": ((D, KV * dh), None),
              "wv": ((D, KV * dh), None),
              "wo": ((H * dh, D), 1.0 / math.sqrt(H * dh))}
    return _stacked([threefry.split(k, 4) for k in keys], shapes, dtype,
                    device)


def _attn_mask(Tq: int, Tk: int, causal: bool, window: int | None,
               chunk: int | None, q_off: int = 0,
               device=None) -> torch.Tensor:
    qi = torch.arange(Tq, device=device)[:, None] + q_off
    ki = torch.arange(Tk, device=device)[None, :]
    m = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    if chunk is not None:
        m &= (ki // chunk) == (qi // chunk)
    return m


def _qkv(p: Params, cfg: AttnConfig, x: torch.Tensor, positions):
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).view(B, T, H, dh)
    k = (x @ p["wk"].to(x.dtype)).view(B, T, KV, dh)
    v = (x @ p["wv"].to(x.dtype)).view(B, T, KV, dh)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _scores(qg: torch.Tensor, k: torch.Tensor, dh: int) -> torch.Tensor:
    """Grouped logits ``(B, KV, rep, Tq, Tk)`` in f32: the product in the
    activation dtype, then the 1/sqrt(dh) scale in f32 (the reference
    divides its einsum by a NumPy scalar, which promotes to f32)."""
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k)
    return s.to(torch.float32) / math.sqrt(dh)


def _sdpa(q, k, v, mask, n_heads: int, n_kv: int) -> torch.Tensor:
    """q: (B,Tq,H,dh); k/v: (B,Tk,KV,dh); mask: (Tq,Tk) or None. The direct
    form: materializes the (Tq, Tk) logits."""
    B, Tq, H, dh = q.shape
    rep = n_heads // n_kv
    qg = q.reshape(B, Tq, n_kv, rep, dh)
    logits = _scores(qg, k, dh)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrts,bsgd->btgrd", w, v)
    return out.reshape(B, Tq, H * dh)


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (training / prefill): the direct form up to
    ``FLASH_THRESHOLD`` positions, flash attention above."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if T > FLASH_THRESHOLD:
        out = fa.flash_sdpa(q, k, v, causal=cfg.causal,
                            window=cfg.sliding_window,
                            chunk=cfg.chunk_size).reshape(B, T, -1)
    else:
        mask = _attn_mask(T, T, cfg.causal, cfg.sliding_window,
                          cfg.chunk_size, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.n_heads, cfg.n_kv_heads)
    return out @ p["wo"].to(x.dtype)


def _cache_write(cache: Params, k: torch.Tensor, v: torch.Tensor,
                 slot: int) -> None:
    """Write one step's ``k`` and ``v`` (B, T, KV, dh) into the rings at
    ``slot``, IN PLACE (the reference donates its caches, so it may too):
    an int8 ring takes the codes and the rows' scales from one fused
    quantize launch on the card, a bf16 ring the cast values."""
    if cache["k"].dtype == torch.int8:
        ops.kv_quantize_write(k, v, cache["k"], cache["v"], cache["ks"],
                              cache["vs"], slot)
        return
    end = slot + k.shape[1]
    cache["k"][:, slot:end] = k.to(cache["k"].dtype)
    cache["v"][:, slot:end] = v.to(cache["v"].dtype)


def _cache_read(cache_arr: torch.Tensor, scale_arr, dtype) -> torch.Tensor:
    """The ring as ``dtype``: the int8 dequantize kernel on a CUDA int8
    ring, a cast otherwise."""
    if cache_arr.dtype == torch.int8:
        return ops.kv_dequantize(cache_arr, scale_arr, dtype)
    return cache_arr.to(dtype)


def attention_decode(p: Params, cfg: AttnConfig, x: torch.Tensor,
                     cache: Params, cache_pos: int):
    """One-token decode against a ring KV cache.

    x: (B, 1, D); cache = {"k","v"[,"ks","vs"]} with k/v (B, S, KV, dh)
    (bf16, or int8 + f32 scales); cache_pos: tokens already cached, a host
    integer (the reference's scalar position). Writes the new token's K/V
    into the ring in place and returns (out, cache dict).
    """
    B = x.shape[0]
    S = cache["k"].shape[1]
    positions = torch.full((B, 1), cache_pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    _cache_write(cache, k, v, cache_pos % S)
    new_cache = {n: cache[n] for n in ("k", "v", "ks", "vs") if n in cache}
    cache_k = _cache_read(cache["k"], cache.get("ks"), q.dtype)
    cache_v = _cache_read(cache["v"], cache.get("vs"), q.dtype)
    # ring cache: slot s currently holds absolute position
    # pos - ((pos - s) mod S) (negative -> not yet written)
    ki = cache_pos - torch.remainder(
        cache_pos - torch.arange(S, device=x.device), S)
    valid = ki >= 0
    if cfg.sliding_window is not None:
        valid &= ki > cache_pos - cfg.sliding_window
    if cfg.chunk_size is not None:
        valid &= (ki // cfg.chunk_size) == (cache_pos // cfg.chunk_size)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    qg = q.reshape(B, 1, KV, rep, dh)
    logits = _scores(qg, cache_k, dh).masked_fill(~valid, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrts,bsgd->btgrd", w, cache_v)
    out = out.reshape(B, 1, H * dh) @ p["wo"].to(x.dtype)
    return out, new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(keys, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32, device=None) -> Params:
    """The reference's ``mlp_init`` for each key of ``keys`` (one per
    period), stacked: each key splits in three, for ``w_in``, ``w_out`` and
    ``w_gate``."""
    shapes = {"w_in": ((d_model, d_ff), None), "w_out": ((d_ff, d_model), None)}
    if gated:
        shapes["w_gate"] = ((d_model, d_ff), None)
    return _stacked([threefry.split(k, 3) for k in keys], shapes, dtype,
                    device)


def mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = act_fn(activation)(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = act_fn(activation)(h)
    return h @ p["w_out"].to(x.dtype)
