"""Config-driven transformer stack (the port of ``repro.models.transformer``).

A model is a *layer pattern*: a period of layers, each a tuple of sublayers.
The full depth is ``n_periods`` repetitions of the pattern, with parameters
stacked along a leading period axis, as in the reference; where the
reference scans over that axis, the port loops over it. Parameters and
caches are nested dicts in the reference's layout, so
:func:`repro_torch.interop.params_from_reference` carries the reference's
``init_params`` output across unchanged.

:func:`forward`, :func:`chunked_ce_loss` and :func:`loss_fn` run under
autograd for training: where ``cfg.remat`` is set each sublayer is
recomputed in the backward (``torch.utils.checkpoint``, the reference's
per-sublayer ``jax.checkpoint``), and so is each cross-entropy chunk, whole.
Under ``remat_policy="dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) a sublayer's checkpoint keeps the
outputs of its weight products, the 2-D ``aten.mm``/``aten.addmm`` that
``x @ w`` folds the batch and time dimensions into, and recomputes the rest:
the batched products (``bmm``), the flash attention, norms, RoPE and
activations. The policies change memory and time, not a number.

Decoding runs on two cache layouts: one position for the whole batch
(:func:`decode_step`, the fixed-batch loop) and one per row, the
continuous-batching engine's slots (``init_cache(per_slot=True)``,
:func:`decode_step` with ``active``, :func:`prefill_step`). Positions stay
on the host in both; the K/V rings are written in place, and a row that is
not written keeps its bytes (the reference writes every row and merges the
old ones back, ``merge_cache_rows``). A speculative verify call
(:func:`verify_forward`) writes in place too, so it saves the ring slots it
will write first and :func:`commit_verify_caches` writes the rejected
tokens' slots back; the reference scores into fresh arrays and restores
from the old ones.

This slice builds the decoders of sublayer kinds ``attn``, ``mlp``,
``moe``, ``rwkv`` and ``mamba`` (token inputs). A config with another kind
(``xattn``), M-RoPE, embeddings input or an encoder is a valid config, but
building or running its model raises ``NotImplementedError`` naming the
ROADMAP item that ports it.

An ``rwkv`` or ``mamba`` sublayer (:mod:`repro_torch.models.ssm`) carries
recurrent state instead of a ring: its cache is the token-shift carries
and the WKV state, or the conv window and the selective-scan state, per
row, with no position. A model may hold both kinds of cache (Jamba's
rings and Mamba carries); the slot ops tell them apart by ``"pos" in c``
and write a carry's rows in place too; a verify call collects a state per
token and :func:`commit_verify_caches` writes the accepted one.

MoE sublayers route each token to its ``top_k`` experts by the f32 router
logits, as the reference does, in one of its two forms (``MoESettings.impl``):
``dispatch`` (capacity per batch row, overflow dropped) and ``masked`` (every
expert over every token, weighted). The port's ``dispatch`` runs each
expert's products over its kept tokens only, which needs each expert's count
on the host: one device-to-host copy per MoE sublayer and call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.transport import host_to, resolve_device
from repro_torch.data import threefry
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.layers import Params

__all__ = ["MoESettings", "SubSpec", "ModelConfig", "PORTED_KINDS",
           "CARRY_KINDS", "check_supported", "moe_capacity", "moe_route",
           "init_params", "init_cache", "embed_inputs", "forward",
           "unembed", "chunked_ce_loss", "loss_fn", "decode_step",
           "advance_pos", "cache_layer_kinds", "prefill_call_bound",
           "supports_slot_serving", "reset_cache_slots", "cache_row",
           "splice_row_pos", "prefill_step", "extract_cache_row",
           "adopt_prefix",
           "supports_speculation", "save_ring_slots", "restore_ring_slots",
           "verify_forward", "commit_verify_caches", "verify_accept"]

PORTED_KINDS = ("attn", "mlp", "moe", "rwkv", "mamba")
# the kinds whose cache is a recurrent carry (no ring, no position)
CARRY_KINDS = ("rwkv", "mamba")
REMAT_POLICIES = ("full", "dots")
_KINDS_ITEM = ("ROADMAP.md queue 1, 'Next' item 3 (other sublayer kinds and "
               "inputs)")

# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    impl: str = "dispatch"          # 'dispatch' (sort-based) | 'masked'


@dataclasses.dataclass(frozen=True)
class SubSpec:
    kind: str                        # attn|xattn|mlp|moe|mamba|rwkv
    use_rope: bool = True
    sliding_window: int | None = None
    chunk_size: int | None = None
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple = (("attn", "mlp"),)   # tuple of layers; each layer is a
                                          # tuple of SubSpec or kind-strings
    head_dim: int | None = None
    activation: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    mrope_sections: tuple | None = None
    moe: MoESettings | None = None
    tie_embeddings: bool = True
    input_mode: str = "tokens"            # tokens | embeds (stub frontends)
    # encoder-decoder (seamless): encoder layers use its own pattern
    n_enc_layers: int = 0
    enc_pattern: tuple = ()
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    kv_quant: bool = False          # int8 KV cache (+ per-row scales)
    rwkv_head_dim: int = 64
    mamba_d_state: int = 16

    def __post_init__(self):
        object.__setattr__(self, "pattern", _norm_pattern(self.pattern))
        if self.enc_pattern:
            object.__setattr__(self, "enc_pattern",
                               _norm_pattern(self.enc_pattern))
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not "
                             f"a multiple of the pattern length "
                             f"{len(self.pattern)}")

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    def attn_cfg(self, s: SubSpec) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hdim,
            rope_theta=self.rope_theta, sliding_window=s.sliding_window,
            chunk_size=s.chunk_size, causal=s.causal,
            mrope_sections=self.mrope_sections,
            use_rope=s.use_rope)

    def rwkv_cfg(self) -> ssm.RWKVConfig:
        return ssm.RWKVConfig(d_model=self.d_model,
                              head_dim=self.rwkv_head_dim)

    def mamba_cfg(self) -> ssm.MambaConfig:
        return ssm.MambaConfig(d_model=self.d_model,
                               d_state=self.mamba_d_state)


def _norm_pattern(pattern):
    return tuple(tuple(SubSpec(kind=s) if isinstance(s, str) else s
                       for s in layer) for layer in pattern)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless this slice can build ``cfg``."""
    kinds = {s.kind for layer in cfg.pattern + cfg.enc_pattern
             for s in layer}
    extra = sorted(kinds - set(PORTED_KINDS))
    if extra:
        raise NotImplementedError(
            f"{cfg.name}: sublayer kinds {extra} are not ported yet: "
            f"{_KINDS_ITEM}")
    if cfg.n_enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet: {_KINDS_ITEM}")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported yet: "
                                  f"{_KINDS_ITEM}")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: {cfg.input_mode!r} input is "
                                  f"not ported yet: {_KINDS_ITEM}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _sub_init(keys, cfg: ModelConfig, s: SubSpec, device) -> Params:
    """The reference's ``_sub_init`` for each period key of ``keys``,
    stacked over periods: attention takes the first half of each key's
    split in two, the MLP, the MoE, the RWKV and the Mamba block the key
    itself. The RWKV block has no ``norm``: it norms inside (``ln1``,
    ``ln2``)."""
    dt = cfg.param_dtype
    if s.kind == "rwkv":
        return ssm.rwkv_block_init(keys, cfg.rwkv_cfg(), dt, device)
    norm = L.rmsnorm_init(cfg.d_model, device=device, periods=len(keys))
    if s.kind == "mamba":
        return {"norm": norm, **ssm.mamba_init(keys, cfg.mamba_cfg(), dt,
                                               device)}
    if s.kind == "attn":
        halves = [threefry.split(k, 2)[0] for k in keys]
        return {"norm": norm, **L.attn_init(halves, cfg.attn_cfg(s), dt,
                                            device)}
    if s.kind == "moe":
        return {"norm": norm, **L.moe_init(keys, cfg.d_model, cfg.d_ff,
                                           cfg.moe.n_experts, cfg.gated_mlp,
                                           dt, device)}
    return {"norm": norm, **L.mlp_init(keys, cfg.d_model, cfg.d_ff,
                                       cfg.gated_mlp, dt, device)}


def init_params(cfg: ModelConfig, seed: int, device=None) -> Params:
    """The reference's ``init_params(jax.random.PRNGKey(seed), cfg)``, drawn
    on ``device`` (CUDA unless named): the same threefry key tree
    (``split(key, 6)``: the embedding from key 0, the layers from key 1,
    the unembedding from key 2; pattern position ``pos``, sublayer ``si``
    from ``split(fold_in(key 1, pos * 31 + si), n_periods)``), the same
    ``jax.random.normal`` draws, scales and dtypes. The values are the
    reference's within 2 ulp of f32 (on the CPU against jax 0.9 they agree
    bit for bit, ``tests/test_torch_init.py``), and the card draws the same
    bits as the CPU."""
    check_supported(cfg)
    dev = resolve_device(device)
    ks = threefry.split(threefry.prng_key(seed), 6)
    layers = []
    for pos, layer in enumerate(cfg.pattern):
        subs = []
        for si, s in enumerate(layer):
            keys = threefry.split(threefry.fold_in(ks[1], pos * 31 + si),
                                  cfg.n_periods)
            subs.append(_sub_init(list(keys), cfg, s, dev))
        layers.append(tuple(subs))
    p: Params = {
        "embed": L.dense_init(ks[0], (cfg.vocab_size, cfg.d_model),
                              scale=0.02, dtype=cfg.param_dtype, device=dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(ks[2], (cfg.d_model, cfg.vocab_size),
                                    scale=0.02, dtype=cfg.param_dtype,
                                    device=dev)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device=None, per_slot: bool = False,
               ring_slack: int = 0) -> tuple:
    """Stacked ``(n_periods, ...)`` caches, one dict per attention, RWKV or
    Mamba sublayer of the pattern (:func:`cache_layer_kinds`). Attention: ring
    caches ``k``/``v`` ``(n_periods, batch, S, KV, dh)`` in ``kv_dtype``,
    or int8 with f32 scales ``ks``/``vs`` ``(n_periods, batch, S, KV, 1)``
    when ``cfg.kv_quant``; ``S`` is ``max_len``, or the window or chunk
    (plus ``ring_slack``) where one bounds it. ``pos`` counts the tokens
    cached: ``(n_periods,)`` int32, or ``(n_periods, batch)`` with
    ``per_slot`` (each row an independently paced slot of the serving
    engine). It stays on the host, so the write slot and the validity mask
    need no device sync. RWKV: the carries ``shift1``/``shift2``
    ``(n_periods, batch, 1, D)`` in the compute dtype and the WKV
    ``state`` ``(n_periods, batch, H, K, K)`` f32; Mamba: the conv window
    ``conv`` ``(n_periods, batch, d_conv - 1, Di)`` in the compute dtype
    and the scan state ``ssm`` ``(n_periods, batch, Di, N)`` f32. A carry
    is zeros, one row per batch row whatever ``per_slot``; ``max_len``,
    ``kv_dtype`` and ``cfg.kv_quant`` do not touch it."""
    check_supported(cfg)
    dev = resolve_device(device)
    KV, dh, n = cfg.n_kv_heads, cfg.hdim, cfg.n_periods
    caches = []
    for layer in cfg.pattern:
        for s in layer:
            if s.kind in CARRY_KINDS:
                spec = (ssm.rwkv_cache_spec(cfg.rwkv_cfg(), batch,
                                            cfg.compute_dtype)
                        if s.kind == "rwkv" else
                        ssm.mamba_cache_spec(cfg.mamba_cfg(), batch,
                                             cfg.compute_dtype))
                caches.append({name: torch.zeros((n, *shape), dtype=dt,
                                                 device=dev)
                               for name, (shape, dt) in spec.items()})
            if s.kind != "attn":
                continue
            S = max_len
            if s.sliding_window is not None:
                S = min(S, s.sliding_window + ring_slack)
            if s.chunk_size is not None:
                S = min(S, s.chunk_size + ring_slack)
            shape = (n, batch, S, KV, dh)
            c = {"pos": torch.zeros((n, batch) if per_slot else (n,),
                                    dtype=torch.int32)}
            if cfg.kv_quant:
                for name in ("k", "v"):
                    c[name] = torch.zeros(shape, dtype=torch.int8, device=dev)
                    c[name + "s"] = torch.zeros(shape[:-1] + (1,),
                                                dtype=torch.float32,
                                                device=dev)
            else:
                for name in ("k", "v"):
                    c[name] = torch.zeros(shape, dtype=kv_dtype, device=dev)
            caches.append(c)
    return tuple(caches)


def cache_layer_kinds(cfg: ModelConfig) -> tuple:
    """Kind of each entry of the caches tuple, in cache order: ``"attn"``
    (a ring and ``pos``), ``"rwkv"`` (the carries and the WKV state) or
    ``"mamba"`` (the conv window and the scan state)."""
    return tuple(s.kind for layer in cfg.pattern for s in layer
                 if s.kind in ("attn", "mamba", "rwkv"))


# --------------------------------------------------------------------------
# MoE implementations
# --------------------------------------------------------------------------

def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """The dispatch form's slots per expert and batch row for a call of
    ``T`` tokens: ``ceil(T * top_k * capacity_factor / n_experts)``."""
    m = cfg.moe
    return int(math.ceil(T * m.top_k * m.capacity_factor / m.n_experts))


def _top_k(logits: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, ties to the lower index (a stable descending sort; ``topk``
    promises no order among ties)."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_aux(logits: torch.Tensor, topi: torch.Tensor, E: int):
    """The Switch-style balance loss ``E * sum(mean softmax * mean
    one-hot)`` over the call's tokens."""
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    ce = F.one_hot(topi, E).to(torch.float32).sum(2).mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def _expert(p: Params, e: int, x: torch.Tensor, activation: str,
            matmul) -> torch.Tensor:
    """Expert ``e``'s gated MLP over the rows of ``x``."""
    w = {n: p[n][e] for n in ("w_in", "w_out", "w_gate") if n in p}
    return L.mlp(w, x, activation, matmul)


def moe_route(logits: torch.Tensor, k: int, C: int) -> tuple:
    """The dispatch form's routing of one call, per batch row: ``logits``
    (B, T, E) f32 -> ``(topi (B, T, k), gates (B, T, k) f32, order,
    seid, keep, dest)``, the last four (B, T * k) in the order of a stable
    sort of the row's (token, choice) slots by expert (``order`` their
    flat slot index ``t * k + j``, ``seid`` their expert). A slot is kept
    while its rank within its expert's group is below ``C``, and ``dest``
    is its place ``seid * C + rank`` in the reference's (E * C) buffer, or
    ``E * C`` where it is dropped: the reference's values exactly."""
    B, T, E = logits.shape
    topv, topi = _top_k(logits, k)
    gates = torch.softmax(topv, dim=-1)
    eid = topi.reshape(B, T * k)
    order = torch.argsort(eid, dim=1, stable=True)
    seid = torch.gather(eid, 1, order)
    experts = torch.arange(E, device=logits.device).expand(B, E)
    starts = torch.searchsorted(seid, experts.contiguous())
    rank = torch.arange(T * k, device=logits.device)[None] - \
        torch.gather(starts, 1, seid)
    keep = rank < C
    dest = torch.where(keep, seid * C + rank, E * C)
    return topi, gates, order, seid, keep, dest


def _moe_dispatch(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  matmul=torch.matmul, aux: bool = True) -> tuple:
    """The reference's sort-based capacity dispatch: per batch row each
    expert takes at most ``moe_capacity(cfg, T)`` of the (token, choice)
    slots routed to it, in token order, and a dropped slot contributes
    zero. The reference computes each expert over a zero-padded (B, C)
    buffer; here each expert's products run over its kept rows only, the
    same function with less work. Each token's kept contributions (its
    expert's output times its gate, both in x's dtype) are added into a
    zero output: with ``top_k <= 2`` that sum is the same in any order (0
    + a is exact and a + b = b + a), so ``index_add`` on the card gives the
    reference's bits. Returns (out, aux), aux None unless asked for."""
    m = cfg.moe
    B, T, D = x.shape
    E, k = m.n_experts, m.top_k
    logits = matmul(x.to(torch.float32), p["router"].to(torch.float32))
    topi, gates, order, seid, keep, _ = moe_route(logits, k,
                                                  moe_capacity(cfg, T))
    # the kept slots of every row, grouped by expert (a stable sort keeps
    # each group in row and rank order); E marks a dropped slot
    grouped = torch.where(keep, seid, E).reshape(-1)
    by_expert = torch.argsort(grouped, stable=True)
    counts = torch.bincount(grouped, minlength=E + 1).tolist()   # host sync
    rows = (torch.arange(B, device=x.device)[:, None] * T + order // k)
    rows = rows.reshape(-1)[by_expert]
    gate = torch.gather(gates.reshape(B, T * k), 1, order).reshape(-1)[
        by_expert]
    xf = x.reshape(B * T, D)
    kept = sum(counts[:E])
    ys, start = [], 0
    for e in range(E):
        n = counts[e]
        if n:
            y = _expert(p, e, xf[rows[start:start + n]], cfg.activation,
                        matmul)
            ys.append(y * gate[start:start + n, None].to(y.dtype))
        start += n
    out = torch.zeros_like(xf)
    if ys:
        out = out.index_add(0, rows[:kept], torch.cat(ys))
    return out.reshape(B, T, D), (_moe_aux(logits, topi, E) if aux
                                  else None)


def _moe_masked(p: Params, x: torch.Tensor, cfg: ModelConfig,
                matmul=torch.matmul, aux: bool = True) -> tuple:
    """The reference's loop over experts with combine masking: every expert
    over every token, its output times the token's combine weight (its gate
    where the expert is chosen, else 0) added in expert order, in x's dtype.
    E / top_k times the products of :func:`_moe_dispatch`, and no
    capacity."""
    m = cfg.moe
    E = m.n_experts
    logits = matmul(x.to(torch.float32), p["router"].to(torch.float32))
    topv, topi = _top_k(logits, m.top_k)
    comb = torch.zeros_like(logits).scatter(-1, topi,
                                            torch.softmax(topv, dim=-1))
    acc = torch.zeros_like(x)
    for e in range(E):
        y = _expert(p, e, x, cfg.activation, matmul)
        acc = acc + y * comb[..., e, None].to(x.dtype)
    return acc, (_moe_aux(logits, topi, E) if aux else None)


# --------------------------------------------------------------------------
# forward pass
# --------------------------------------------------------------------------

def _period(tree, i: int):
    """Period ``i`` of a stacked parameter or cache dict: views, so writes
    into a cache's period land in the stacked tensor. A leaf may also be a
    list of per-period tensors (the train step's gradient leaves)."""
    return {k: (_period(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _apply_sub(sp: Params, s: SubSpec, cfg: ModelConfig, x: torch.Tensor,
               positions, cache, lengths=None, active=None,
               serving: bool = False, aux: bool = True, collect=None):
    """One sublayer (``attn``, ``mlp``, ``moe``, ``rwkv`` or ``mamba``: the
    entry points have checked the config); returns (x, the MoE balance loss
    or None). A decode ``cache`` (one period's views) is written in place:
    per-slot caches (``pos`` per row) through ``attention_decode_slots``,
    with ``lengths`` (prefill pads; host integers, a recurrent block's on
    the device) and ``active`` (rows to write); an RWKV or Mamba cache by
    :func:`_write_carries`. ``serving`` (a call on per-slot caches)
    takes the norm, the MLP's, the Mamba block's and the MoE's router and
    expert products through ``layers.serve_rows``, as
    ``attention_decode_slots`` takes its own, so that a token's bits do not
    depend on how many tokens share its call or its expert. ``aux=False``
    (decoding) skips the balance loss. ``collect`` (a list; a verify call)
    takes a recurrent block's per-token checkpoints."""
    if s.kind == "rwkv":
        return _apply_rwkv(sp, cfg, x, cache, lengths, active, serving,
                           collect), None
    h = (L.serve_rmsnorm if serving else L.rmsnorm)(sp["norm"], x)
    mm = L.serve_matmul if serving else torch.matmul
    if s.kind == "mamba":
        o, new = ssm.mamba_block(sp, h, cfg.mamba_cfg(), cache,
                                 lengths=lengths,
                                 collect_states=collect is not None,
                                 matmul=mm)
        _write_carries(cache, new, active, collect)
        return x + o, None
    if s.kind == "moe":
        fn = _moe_dispatch if cfg.moe.impl == "dispatch" else _moe_masked
        o, a = fn(sp, h, cfg, mm, aux)
        return x + o, a
    if s.kind == "attn":
        acfg = cfg.attn_cfg(s)
        if cache is not None and cache["pos"].dim():
            o, _ = L.attention_decode_slots(sp, acfg, h, cache, cache["pos"],
                                            lengths=lengths, active=active)
        elif cache is not None:
            o, _ = L.attention_decode(sp, acfg, h, cache, int(cache["pos"]))
        else:
            o = L.attention(sp, acfg, h, positions)
    else:
        o = L.mlp(sp, h, cfg.activation, mm)
    return x + o, None


def _apply_rwkv(sp: Params, cfg: ModelConfig, x: torch.Tensor, cache,
                lengths, active, serving: bool, collect) -> torch.Tensor:
    """One RWKV block (``ssm.rwkv_block``), its products and norms through
    ``layers.serve_rows`` when ``serving``. ``lengths`` ((B,) int64 on x's
    device, or None) mark each row's real tokens; the new carries go
    through :func:`_write_carries`."""
    mm, norm = (L.serve_matmul, L.serve_rmsnorm) if serving \
        else (torch.matmul, L.rmsnorm)
    x, new = ssm.rwkv_block(sp, x, cfg.rwkv_cfg(), cache, lengths=lengths,
                            collect_states=collect is not None, matmul=mm,
                            norm=norm)
    _write_carries(cache, new, active, collect)
    return x


def _write_carries(cache, new: Params, active, collect) -> None:
    """A recurrent block's new cache ``new``: with ``collect`` (a verify
    call) its per-token checkpoints are appended to it and the cache is
    not written; else, with a decode ``cache`` (one period's views), it is
    written into the rows ``active`` marks (every row where None), in
    place."""
    if collect is not None:
        collect.append(new)
    elif cache is not None:
        _write_rows(cache, new, active)


def _leaf_device(cache: Params) -> torch.device:
    """The device of a carry cache's leaves (any leaf: an RWKV cache's
    ``state``, a Mamba cache's ``conv`` and ``ssm``)."""
    return next(iter(cache.values())).device


def _write_rows(cache: Params, new: Params, rows=None) -> None:
    """Copy ``new``'s leaves into ``cache``'s (batch first), in place: every
    row, or the rows where ``rows`` (B,) host bools is True."""
    if rows is None or bool(rows.all()):
        for name, leaf in cache.items():
            leaf.copy_(new[name])
        return
    picked = torch.nonzero(rows).flatten()
    if not len(picked):
        return
    idx = host_to(picked, _leaf_device(cache))
    for name, leaf in cache.items():
        leaf.index_copy_(0, idx, new[name].index_select(0, idx))


# the weight products that "dots" keeps: no batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_KW = {"full": {},
             "dots": {"context_fn": functools.partial(
                 create_selective_checkpoint_contexts, _dots_policy)}}


def _n_periods(tree) -> int:
    """The period count of a stacked sublayer: the length of its first leaf
    (a stacked tensor, or the train step's list of per-period leaves)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


def _run_stack(layer_params, pattern, cfg: ModelConfig, x: torch.Tensor,
               positions, caches=None, lengths=None, active=None,
               collect=None):
    """Loop over periods (the reference scans); returns (x, aux, caches),
    ``aux`` the MoE balance losses summed over every sublayer (None without
    MoE, and when decoding, where it is unused). Decode
    writes each period's new K/V and recurrent carries into the stacked
    caches in place (slot calls: ``lengths`` and ``active`` as in
    ``attention_decode_slots``). ``collect`` (a dict; a verify call) gets,
    for each carry cache's index, its per-token checkpoints period by
    period, and those caches are not written. Under autograd with
    ``cfg.remat`` each sublayer is checkpointed under
    ``cfg.remat_policy``."""
    n = _n_periods(layer_params[0][0])
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    serving = caches is not None and (active is not None
                                      or _per_slot(caches))
    want_aux = caches is None
    aux = None
    # a recurrent block reads the lengths on the device: one copy a call
    carry_lengths = None
    if lengths is not None and any(s.kind in CARRY_KINDS for layer in pattern
                                   for s in layer):
        carry_lengths = host_to(
            torch.as_tensor(lengths).to("cpu", torch.int64), x.device)
    if remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r}; "
                         f"want one of {REMAT_POLICIES}")
    for i in range(n):
        ci = 0
        for pos, layer in enumerate(pattern):
            for si, s in enumerate(layer):
                c = col = None
                if caches is not None and s.kind in ("attn",) + CARRY_KINDS:
                    c = _period(caches[ci], i)
                    if collect is not None and s.kind in CARRY_KINDS:
                        col = collect.setdefault(ci, [])
                    ci += 1
                sp = _period(layer_params[pos][si], i)
                if remat:
                    x, a = checkpoint(_apply_sub, sp, s, cfg, x, positions,
                                      c, use_reentrant=False,
                                      **_REMAT_KW[cfg.remat_policy])
                else:
                    x, a = _apply_sub(
                        sp, s, cfg, x, positions, c,
                        carry_lengths if s.kind in CARRY_KINDS else lengths,
                        active, serving, want_aux, col)
                if a is not None:
                    aux = a if aux is None else aux + a
    return x, aux, caches


def embed_inputs(params: Params, cfg: ModelConfig, inputs: dict) -> tuple:
    tokens = inputs["tokens"].long()
    # gather, then cast: the same values as the reference's cast-then-gather
    x = params["embed"][tokens].to(cfg.compute_dtype)
    B, T = x.shape[:2]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    return x, positions


def forward(params: Params, cfg: ModelConfig, inputs: dict) -> tuple:
    """Full-sequence forward -> (final hidden states, aux loss). The aux
    loss is the MoE balance term summed over the MoE sublayers (zero
    without them)."""
    check_supported(cfg)
    x, positions = embed_inputs(params, cfg, inputs)
    x, aux, _ = _run_stack(params["layers"], cfg.pattern, cfg, x, positions)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(params["final_norm"], x), aux


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor,
            matmul=torch.matmul) -> torch.Tensor:
    """Logits ``x @ embed.T`` (tied) or ``x @ unembed``; the slot paths
    pass ``layers.serve_matmul``."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return matmul(x, w.to(x.dtype))


def _ce_chunk(params: Params, cfg: ModelConfig, xc: torch.Tensor,
              yc: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: f32 logits, ``logsumexp`` minus
    the label's logit."""
    logits = unembed(params, cfg, xc).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(lse - ll)


def chunked_ce_loss(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over ``(B, T)`` without holding ``(B, T, V)``
    logits: sequence chunks of ``chunk`` positions (and the remainder),
    summed in order, as the reference scans them. Under autograd each chunk
    is checkpointed, so the backward recomputes its logits instead of
    keeping every chunk's ``(B, chunk, V)`` f32 logits alive."""
    B, T, _ = x.shape
    chunk = min(chunk, T)
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        xc, yc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if grad:
            tot = tot + checkpoint(_ce_chunk, params, cfg, xc, yc,
                                   use_reentrant=False)
        else:
            tot = tot + _ce_chunk(params, cfg, xc, yc)
    return tot / (B * T)


def loss_fn(params: Params, cfg: ModelConfig, inputs: dict,
            aux_weight: float = 0.01) -> tuple:
    """``(ce + aux_weight * aux, {"ce", "aux"})``; ``aux`` is the MoE
    balance loss, 0 for a model without MoE sublayers."""
    x, aux = forward(params, cfg, inputs)
    ce = chunked_ce_loss(params, cfg, x, inputs["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# decode (serving)
# --------------------------------------------------------------------------

def _per_slot(caches: tuple) -> bool:
    """Whether an attention cache keeps a position per row."""
    return any(c["pos"].dim() == 2 for c in caches if "pos" in c)


def _fixed_pos(caches: tuple) -> bool:
    """Whether an attention cache keeps one position for the whole batch
    (RWKV caches have none: a row of theirs serves either loop)."""
    return any(c["pos"].dim() == 1 for c in caches if "pos" in c)


def _host_rows(mask, B: int) -> torch.Tensor:
    """A (B,) host bool tensor from a bool sequence or tensor."""
    m = torch.as_tensor(mask).to("cpu", torch.bool).reshape(-1)
    if m.shape != (B,):
        raise ValueError(f"want {B} row flags, got {tuple(m.shape)}")
    return m


def decode_step(params: Params, cfg: ModelConfig, inputs: dict,
                caches: tuple, active=None) -> tuple:
    """One-token decode. inputs: {'tokens': (B, 1)}. Returns (logits (B, V)
    f32, caches with positions advanced). The K/V rings are updated in
    place: the returned caches share their tensors with ``caches``.

    ``active`` (per-slot caches only): (B,) host bools, the rows whose slot
    holds an in-flight request. The other rows compute (their logits mean
    nothing) but write no K/V or recurrent carries and keep their
    position: a free or a prefilling slot is left bit-unchanged."""
    check_supported(cfg)
    B = inputs["tokens"].shape[0]
    if active is not None:
        if _fixed_pos(caches):
            raise ValueError("active rows need per-slot caches "
                             "(init_cache(per_slot=True))")
        active = _host_rows(active, B)
    x, _ = embed_inputs(params, cfg, inputs)
    x, _, caches = _run_stack(params["layers"], cfg.pattern, cfg, x, None,
                              caches, active=active)
    if active is not None or _per_slot(caches):
        x = L.serve_rmsnorm(params["final_norm"], x)
        logits = unembed(params, cfg, x, L.serve_matmul)[:, -1]
    else:
        x = L.rmsnorm(params["final_norm"], x)
        logits = unembed(params, cfg, x)[:, -1]
    return logits.to(torch.float32), advance_pos(caches, active)


def advance_pos(caches: tuple, active=None) -> tuple:
    """Increment every attention cache's position by one: everywhere, or
    (per-slot caches) on the rows where ``active`` is True. Carry caches
    have no position."""
    step = 1 if active is None else torch.as_tensor(active).to(torch.int32)
    return tuple({**c, "pos": c["pos"] + step} if "pos" in c else c
                 for c in caches)


# --------------------------------------------------------------------------
# KV-cache slot ops (continuous-batching serving)
# --------------------------------------------------------------------------

def prefill_call_bound(cfg: ModelConfig, max_len: int) -> int:
    """Longest single slot prefill CALL the cache geometry allows: every
    attention sublayer must fit the call's tokens in its (possibly
    window/chunk-bounded) ring, or one call would write a ring slot
    twice."""
    s_min = max_len
    for layer in cfg.pattern:
        for s in layer:
            if s.kind == "attn":
                if s.sliding_window is not None:
                    s_min = min(s_min, s.sliding_window)
                if s.chunk_size is not None:
                    s_min = min(s_min, s.chunk_size)
    return s_min


def supports_slot_serving(cfg: ModelConfig) -> bool:
    """Whether the continuous-batching engine can drive this architecture:
    the reference's rule, any decoder-only token-prompt stack of the kinds
    this slice ports (attention, MLP, MoE, RWKV and Mamba)."""
    kinds = {s.kind for layer in cfg.pattern for s in layer}
    return (cfg.input_mode == "tokens" and not cfg.n_enc_layers
            and kinds <= {"attn", "mlp", "moe", "mamba", "rwkv"})


def _zero_rows(caches: tuple, rows: torch.Tensor) -> None:
    """Zero the batch rows ``rows`` (host integers) of every leaf but
    ``pos``, in place, one ``index_fill_`` per leaf."""
    for c in caches:
        leaves = [leaf for name, leaf in c.items() if name != "pos"]
        idx = host_to(rows, leaves[0].device)
        for leaf in leaves:
            leaf.index_fill_(1, idx, 0)


def reset_cache_slots(caches: tuple, free_mask) -> tuple:
    """Free the cache rows where ``free_mask`` (B,) is True: their K/V,
    scales and recurrent carries are zeroed in place and their positions
    set to 0 (which alone hides the old K/V from every later read; the
    zeros keep no request's data in a free slot, and are a carry row's
    fresh state)."""
    batch = next(v for c in caches for k, v in c.items() if k != "pos")
    free = _host_rows(free_mask, batch.shape[1])
    rows = torch.nonzero(free).flatten()
    if not len(rows):
        return caches
    _zero_rows(caches, rows)
    return tuple({**c, "pos": torch.where(free[None], 0, c["pos"])}
                 if "pos" in c else c for c in caches)


def splice_row_pos(caches: tuple, rows: tuple, slot: int) -> tuple:
    """``caches`` with slot ``slot``'s positions taken from the batch-of-1
    ``rows`` (:func:`cache_row` views, written already: K/V and recurrent
    carries need no copy, and a carry cache has no position)."""
    out = []
    for c, r in zip(caches, rows):
        if "pos" not in c:
            out.append(c)
            continue
        pos = c["pos"].clone()
        pos[:, slot] = r["pos"][:, 0]
        out.append({**c, "pos": pos})
    return tuple(out)


def cache_row(caches: tuple, slot: int) -> tuple:
    """One slot's row of per-slot caches as batch-of-1 VIEWS, positions
    included: what a call writes into the row (K/V, carries) lands in
    the caches, so a prefill chunk needs no splice (the prefix cache's
    copies are :func:`extract_cache_row` and :func:`adopt_prefix`)."""
    return tuple({k: v[:, slot:slot + 1] for k, v in c.items()}
                 for c in caches)


def prefill_step(params: Params, cfg: ModelConfig, inputs: dict,
                 caches: tuple, lengths, active=None,
                 resume: bool = False) -> tuple:
    """Prefill prompt chunks into per-slot caches (continuous-batching
    admission).

    inputs: {'tokens': (B, Tc)} right-padded chunks; lengths: (B,) host
    integers, the chunks' true lengths (<= Tc); active: (B,) host bools,
    the rows admitted by this call (default all). With ``resume=False`` an
    active row restarts at position 0 (its ring slots ``0..len-1`` take the
    chunk's K/V; position arithmetic hides the rest) and its recurrent
    carries are zeroed; with ``resume=True`` (chunks 2..n of a long prompt) it
    continues at its position and from its carries, which the chunk's pads
    leave unchanged and which are taken at its last real token. Inactive
    rows are not written and keep their positions. Returns (logits (B, V)
    f32 at each row's last real token, caches with the active rows'
    positions advanced by ``lengths``); the caches are written in place."""
    check_supported(cfg)
    B = inputs["tokens"].shape[0]
    lengths = torch.as_tensor(lengths).to("cpu", torch.int64).reshape(-1)
    act = torch.ones(B, dtype=torch.bool) if active is None \
        else _host_rows(active, B)
    if not resume:
        _zero_rows(tuple(c for c in caches if "pos" not in c),
                   torch.nonzero(act).flatten())
        caches = tuple({**c, "pos": torch.where(act[None], 0, c["pos"])}
                       if "pos" in c else c for c in caches)
    x, _ = embed_inputs(params, cfg, inputs)
    x, _, _ = _run_stack(params["layers"], cfg.pattern, cfg, x, None,
                         caches, lengths=lengths, active=act)
    x = L.serve_rmsnorm(params["final_norm"], x)
    idx = host_to((lengths - 1).clamp_min(0), x.device)
    last = x[torch.arange(B, device=x.device), idx][:, None]
    logits = unembed(params, cfg, last, L.serve_matmul)[:, 0].to(
        torch.float32)
    grow = (lengths * act).to(torch.int32)
    return logits, tuple({**c, "pos": c["pos"] + grow} if "pos" in c else c
                         for c in caches)


def extract_cache_row(caches: tuple, slot: int, length: int | None = None
                      ) -> tuple:
    """Copy one slot's row out of per-slot caches as a batch-of-1 tuple of
    COPIES (the prefix trie keeps them while the slot moves on; the views
    of :func:`cache_row` would change with it).

    ``length``: the tokens the row holds (its position ``p``). A row that
    started all zeros (a freed slot, pads never written) is zero in every
    ring slot at or past ``p`` while ``p <= S``, so only the first
    ``min(p, S)`` slots of each leaf are copied; on a wrapped ring (``p >
    S``), and with no ``length``, the whole ring is. :func:`adopt_prefix`
    writes the zeros back, so a trimmed row adopts to the same bytes as a
    whole one. A carry row (RWKV's or Mamba's) is copied whole."""
    out = []
    for c in caches:
        if "pos" not in c:
            out.append({k: v[:, slot:slot + 1].clone() for k, v in c.items()})
            continue
        S = c["k"].shape[2]
        m = S if length is None else min(int(length), S)
        row = {k: v[:, slot:slot + 1, :m].clone() for k, v in c.items()
               if k != "pos"}
        row["pos"] = c["pos"][:, slot:slot + 1].clone()
        out.append(row)
    return tuple(out)


def adopt_prefix(caches: tuple, row: tuple, slot: int) -> tuple:
    """Copy a batch-of-1 ``row`` (:func:`extract_cache_row`) into ``slot``
    in place: its ring slots, zeros past them, and its positions. Every
    other slot stays bit-unchanged. Returns the caches with the new
    positions."""
    out = []
    for c, r in zip(caches, row):
        if "pos" not in c:
            for name, leaf in c.items():
                leaf[:, slot].copy_(r[name][:, 0])
            out.append(c)
            continue
        for name, leaf in c.items():
            if name == "pos":
                continue
            dst = leaf[:, slot]
            m = r[name].shape[2]
            dst[:, :m].copy_(r[name][:, 0])
            dst[:, m:].zero_()
        pos = c["pos"].clone()
        pos[:, slot] = r["pos"][:, 0]
        out.append({**c, "pos": pos})
    return tuple(out)


# --------------------------------------------------------------------------
# speculative decoding: one-pass verify and the rollback of rejected writes
# --------------------------------------------------------------------------

def supports_speculation(cfg: ModelConfig) -> bool:
    """Whether the speculative verify step can drive this architecture: the
    reference's rule, slot serving plus a rollback rule for every cached
    sublayer kind (attention rings roll back their rejected writes; RWKV
    and Mamba keep a checkpoint per token and commit the accepted one)."""
    return (supports_slot_serving(cfg)
            and set(cache_layer_kinds(cfg)) <= {"attn", "mamba", "rwkv"})


def _ring_index(rows: torch.Tensor, slots: torch.Tensor, device) -> tuple:
    """Advanced-index tensors (period, row, slot), each (n_periods, N), on
    ``device``, for the entries of :func:`layers.ring_written_slots`: one
    host-to-device copy."""
    periods = torch.arange(slots.shape[0])[:, None].expand_as(slots)
    idx = host_to(torch.stack([periods, rows[None].expand_as(slots),
                               slots]), device)
    return tuple(idx.unbind(0))


def save_ring_slots(caches: tuple, n, carries: bool = True) -> tuple:
    """Before a call that writes ``n[b]`` tokens of row ``b`` from its
    position (host integers, ``0`` for a row that writes nothing): the
    pre-call bytes of every ring slot it will write, from every leaf over
    all periods at once (one gather per leaf), with the pre-call
    positions. A carry cache, which has no ring, saves the whole rows with
    ``n[b] > 0`` (one gather per leaf), or nothing (None) without
    ``carries``: a verify call writes none of them and commits its own
    checkpoints (:func:`commit_verify_caches`).
    :func:`restore_ring_slots` writes them back."""
    n = torch.as_tensor(n).to("cpu", torch.int64).reshape(-1)
    saved = []
    for c in caches:
        if "pos" not in c:
            rows = torch.nonzero(n > 0).flatten()
            if not carries or not len(rows):
                saved.append(None)
                continue
            idx = host_to(rows, _leaf_device(c))
            saved.append({"rows": rows, "carries": {
                k: v.index_select(1, idx) for k, v in c.items()}})
            continue
        rows, ts, slots = L.ring_written_slots(c["pos"], c["k"].shape[2], n)
        vals = {}
        if len(rows):
            idx = _ring_index(rows, slots, c["k"].device)
            vals = {k: v[idx] for k, v in c.items() if k != "pos"}
        saved.append({"pos": c["pos"].clone(), "rows": rows, "ts": ts,
                      "slots": slots, "vals": vals})
    return tuple(saved)


def restore_ring_slots(caches: tuple, saved: tuple, keep) -> tuple:
    """Undo a call's writes past each row's first ``keep[b]`` tokens (host
    integers): the slots that tokens ``t >= keep[b]`` wrote get their saved
    bytes back, in place (nothing is written when every row keeps all its
    tokens), and the positions become the saved ones plus ``keep``.
    ``keep`` of zeros undoes the call. A carry cache's saved rows come back
    whole where ``keep`` is 0 (carries cannot keep a part of a call); its
    other rows, and a carry cache that saved nothing, pass through."""
    keep = torch.as_tensor(keep).to("cpu", torch.int64).reshape(-1)
    out = []
    for c, sv in zip(caches, saved):
        if "pos" not in c:
            back = None if sv is None or "carries" not in sv \
                else keep[sv["rows"]] == 0
            if back is not None and bool(back.any()):
                dev = _leaf_device(c)
                rows = host_to(sv["rows"][back], dev)
                sel = host_to(torch.nonzero(back).flatten(), dev)
                for name, vals in sv["carries"].items():
                    c[name].index_copy_(1, rows, vals.index_select(1, sel))
            out.append(c)
            continue
        back = sv["ts"] >= keep[sv["rows"]]
        if bool(back.any()):
            dev = c["k"].device
            idx = _ring_index(sv["rows"][back], sv["slots"][:, back], dev)
            sel = host_to(torch.nonzero(back).flatten(), dev)
            for name, vals in sv["vals"].items():
                c[name].index_put_(idx, vals.index_select(1, sel))
        out.append({**c, "pos": sv["pos"] + keep.to(torch.int32)})
    return tuple(out)


def verify_forward(params: Params, cfg: ModelConfig, inputs: dict,
                   caches: tuple, lengths=None, active=None) -> tuple:
    """Score a verify call's tokens in ONE pass against per-slot caches.

    inputs: {'tokens': (B, T)}: per row, token 0 is the request's last
    emitted (not yet cached) token, tokens ``1..lengths[b]-1`` its draft
    proposals, the rest padding. ``lengths`` (B,) host integers (default
    T): the pad columns write nothing to the rings (near a ring's capacity
    a pad write would wrap over live K/V the real columns read).
    ``active`` (B,) host bools (default all): an inactive row writes
    nothing. The real columns' K/V is written into the rings in place and
    the positions are not advanced; the carry caches are not written (the
    pad columns' scan states repeat the last real one's). Returns (logits
    (B, T, V) f32, where position ``t`` scores the next token after input
    token ``t``, and ``old``: per cache, :func:`save_ring_slots` of the
    slots the call wrote, or ``{"steps": {leaf: (n_periods, B, T, ...)}}``,
    a carry cache's per-token checkpoints, stacked), which
    :func:`commit_verify_caches` needs to keep only the accepted tokens."""
    check_supported(cfg)
    B, T = inputs["tokens"].shape
    act = torch.ones(B, dtype=torch.bool) if active is None \
        else _host_rows(active, B)
    n = torch.full((B,), T, dtype=torch.int64) if lengths is None \
        else torch.as_tensor(lengths).to("cpu", torch.int64).reshape(-1)
    old = save_ring_slots(caches, n * act, carries=False)
    steps: dict = {}
    x, _ = embed_inputs(params, cfg, inputs)
    x, _, _ = _run_stack(params["layers"], cfg.pattern, cfg, x, None,
                         caches, lengths=n, active=act, collect=steps)
    x = L.serve_rmsnorm(params["final_norm"], x)
    old = tuple(sv if ci not in steps else {"steps": {
        name: torch.stack([p[name] for p in steps[ci]])
        for name in steps[ci][0]}} for ci, sv in enumerate(old))
    return unembed(params, cfg, x, L.serve_matmul).to(torch.float32), old


def commit_verify_caches(raw_caches: tuple, old: tuple, accept,
                         active=None) -> tuple:
    """Commit exactly the accepted prefix of a verify call, per slot.

    ``accept`` (B,) host integers in ``[1, T]``: how many of the call's
    input tokens each row keeps. The ring slots written by rejected tokens
    get their pre-call bytes back, in place, and the positions advance by
    ``accept`` only; a carry cache takes, in place, each row's checkpoint
    after its token ``accept - 1`` (the state the sequential decode would
    hold). An inactive row keeps its position and its carries (it wrote
    nothing)."""
    keep = torch.as_tensor(accept).to("cpu", torch.int64).reshape(-1)
    if active is not None:
        keep = keep * _host_rows(active, len(keep))
    rows = torch.nonzero(keep > 0).flatten()
    idx = None
    for c, sv in zip(raw_caches, old):
        if "pos" in c or not len(rows):
            continue
        if idx is None:       # (row, its accepted token's index), one copy
            idx = host_to(torch.stack([rows, keep[rows] - 1]),
                          _leaf_device(c))
        for name, leaf in c.items():      # one gather a leaf, all periods
            leaf.index_copy_(1, idx[0], sv["steps"][name][:, idx[0], idx[1]])
    return restore_ring_slots(raw_caches, old, keep)


def verify_accept(pred: torch.Tensor, tokens: torch.Tensor, n_draft) -> tuple:
    """Longest-matching-prefix acceptance for one verify call.

    pred: (B, T) the model's (argmax or committed sampler's) token after
    each input position; tokens: (B, T) the call's inputs (token 0 the last
    emitted, 1..T-1 drafts); n_draft: (B,) how many drafts are real.
    Returns (emitted (B, T), accept (B,)) int64 on ``pred``'s device: row
    ``b`` emits ``emitted[b, :accept[b]]``, the matched drafts followed by
    the model's own token at the first mismatch (or the bonus token when
    every draft matched), and ``-1`` after them; ``accept == 1 +
    matched``, so a row with no drafts is one plain decode step."""
    dev = pred.device
    B, T = tokens.shape
    k = T - 1
    pred = pred.to(torch.int64)
    tokens = tokens.to(dev, torch.int64)
    nd = torch.as_tensor(n_draft).to(torch.int64)
    nd = nd if nd.device == dev else host_to(nd.cpu(), dev)
    ok = (pred[:, :-1] == tokens[:, 1:]) & \
        (torch.arange(k, device=dev)[None] < nd[:, None])
    n_match = (torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1) if k
               else torch.zeros(B, dtype=torch.int64, device=dev))
    corr = torch.gather(pred, 1, n_match[:, None])
    drafts = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    idx = torch.arange(T, device=dev)[None]
    emitted = torch.where(idx < n_match[:, None], drafts,
                          torch.where(idx == n_match[:, None], corr,
                                      torch.full_like(corr, -1)))
    return emitted, n_match + 1
