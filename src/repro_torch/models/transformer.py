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
old ones back, ``merge_cache_rows``).

This slice builds the dense decoders (sublayer kinds ``attn`` and ``mlp``,
token inputs). A config with another kind, M-RoPE, embeddings input or an
encoder is a valid config, but building or running its model raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.transport import host_to, resolve_device
from repro_torch.data import threefry
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

__all__ = ["MoESettings", "SubSpec", "ModelConfig", "PORTED_KINDS",
           "check_supported", "init_params", "init_cache", "embed_inputs",
           "forward", "unembed", "chunked_ce_loss", "loss_fn", "decode_step",
           "advance_pos", "cache_layer_kinds", "prefill_call_bound",
           "supports_slot_serving", "reset_cache_slots", "cache_row",
           "prefill_step"]

PORTED_KINDS = ("attn", "mlp")
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
    split in two, the MLP the key itself."""
    dt = cfg.param_dtype
    norm = L.rmsnorm_init(cfg.d_model, device=device, periods=len(keys))
    if s.kind == "attn":
        halves = [threefry.split(k, 2)[0] for k in keys]
        return {"norm": norm, **L.attn_init(halves, cfg.attn_cfg(s), dt,
                                            device)}
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
    """Stacked ``(n_periods, ...)`` ring caches, one dict per attention
    sublayer of the pattern: ``k``/``v`` ``(n_periods, batch, S, KV, dh)``
    in ``kv_dtype``, or int8 with f32 scales ``ks``/``vs``
    ``(n_periods, batch, S, KV, 1)`` when ``cfg.kv_quant``; ``S`` is
    ``max_len``, or the window or chunk (plus ``ring_slack``) where one
    bounds it. ``pos`` counts the tokens cached: ``(n_periods,)`` int32, or
    ``(n_periods, batch)`` with ``per_slot`` (each row an independently
    paced slot of the serving engine). It stays on the host, so the write
    slot and the validity mask need no device sync."""
    check_supported(cfg)
    dev = resolve_device(device)
    KV, dh, n = cfg.n_kv_heads, cfg.hdim, cfg.n_periods
    caches = []
    for layer in cfg.pattern:
        for s in layer:
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
    """Kind of each entry of the caches tuple, in cache order (``"attn"``;
    the reference's ``"mamba"`` and ``"rwkv"`` caches come with queue 1's
    item 3)."""
    return tuple(s.kind for layer in cfg.pattern for s in layer
                 if s.kind in ("attn", "mamba", "rwkv"))


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
               positions, cache, lengths=None, active=None):
    """One sublayer (``attn`` or ``mlp``: the entry points have checked the
    config). A decode ``cache`` (one period's views) is written in place:
    per-slot caches (``pos`` per row) through ``attention_decode_slots``,
    with ``lengths`` (prefill pads) and ``active`` (rows to write)."""
    h = L.rmsnorm(sp["norm"], x)
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
        o = L.mlp(sp, h, cfg.activation)
    return x + o


# the weight products that "dots" keeps: no batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_KW = {"full": {},
             "dots": {"context_fn": functools.partial(
                 create_selective_checkpoint_contexts, _dots_policy)}}


def _run_stack(layer_params, pattern, cfg: ModelConfig, x: torch.Tensor,
               positions, caches=None, lengths=None, active=None):
    """Loop over periods (the reference scans); returns (x, caches). Decode
    writes each period's new K/V into the stacked caches in place (per-slot
    caches: ``lengths`` and ``active`` as in ``attention_decode_slots``). Under
    autograd with ``cfg.remat`` each sublayer is checkpointed under
    ``cfg.remat_policy``."""
    n = len(layer_params[0][0]["norm"]["scale"])
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: remat_policy {cfg.remat_policy!r}; "
                         f"want one of {REMAT_POLICIES}")
    for i in range(n):
        ci = 0
        for pos, layer in enumerate(pattern):
            for si, s in enumerate(layer):
                c = None
                if caches is not None and s.kind == "attn":
                    c = _period(caches[ci], i)
                    ci += 1
                sp = _period(layer_params[pos][si], i)
                if remat:
                    x = checkpoint(_apply_sub, sp, s, cfg, x, positions, c,
                                   use_reentrant=False,
                                   **_REMAT_KW[cfg.remat_policy])
                else:
                    x = _apply_sub(sp, s, cfg, x, positions, c, lengths,
                                   active)
    return x, caches


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
    loss is the MoE balance term, zero for the kinds this slice builds."""
    check_supported(cfg)
    x, positions = embed_inputs(params, cfg, inputs)
    x, _ = _run_stack(params["layers"], cfg.pattern, cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(params["final_norm"], x), aux


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(x.dtype)


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
    balance loss, 0 for the dense models this slice builds."""
    x, aux = forward(params, cfg, inputs)
    ce = chunked_ce_loss(params, cfg, x, inputs["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# decode (serving)
# --------------------------------------------------------------------------

def _per_slot(caches: tuple) -> bool:
    return any(c["pos"].dim() == 2 for c in caches if "pos" in c)


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
    nothing) but write no K/V and keep their position: a free or a
    prefilling slot is left bit-unchanged."""
    check_supported(cfg)
    B = inputs["tokens"].shape[0]
    if active is not None:
        if not _per_slot(caches):
            raise ValueError("active rows need per-slot caches "
                             "(init_cache(per_slot=True))")
        active = _host_rows(active, B)
    x, _ = embed_inputs(params, cfg, inputs)
    x, caches = _run_stack(params["layers"], cfg.pattern, cfg, x, None,
                           caches, active=active)
    x = L.rmsnorm(params["final_norm"], x)
    logits = unembed(params, cfg, x)[:, -1]
    return logits.to(torch.float32), advance_pos(caches, active)


def advance_pos(caches: tuple, active=None) -> tuple:
    """Increment every attention cache's position by one: everywhere, or
    (per-slot caches) on the rows where ``active`` is True."""
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
    the reference's rule, any decoder-only token-prompt stack. (Building
    one whose kinds this slice does not port still raises
    ``NotImplementedError``.)"""
    kinds = {s.kind for layer in cfg.pattern for s in layer}
    return (cfg.input_mode == "tokens" and not cfg.n_enc_layers
            and kinds <= {"attn", "mlp", "moe", "mamba", "rwkv"})


def reset_cache_slots(caches: tuple, free_mask) -> tuple:
    """Free the cache rows where ``free_mask`` (B,) is True: their K/V and
    scales are zeroed in place, one ``index_fill_`` per leaf, and their
    positions set to 0 (which alone hides the old K/V from every later
    read; the zeros keep no request's data in a free slot)."""
    first = next(c for c in caches if "pos" in c)
    free = _host_rows(free_mask, first["pos"].shape[-1])
    rows = torch.nonzero(free).flatten()
    if not len(rows):
        return caches
    out = []
    for c in caches:
        idx = host_to(rows, c["k"].device)
        for name, leaf in c.items():
            if name != "pos":
                leaf.index_fill_(1, idx, 0)
        out.append({**c, "pos": torch.where(free[None], 0, c["pos"])})
    return tuple(out)


def cache_row(caches: tuple, slot: int) -> tuple:
    """One slot's row of per-slot caches as batch-of-1 VIEWS, positions
    included: what a call writes into the row lands in the caches, so the
    port needs neither the reference's ``extract_cache_row`` copy nor its
    ``adopt_prefix`` splice."""
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
    chunk's K/V; position arithmetic hides the rest); with ``resume=True``
    (chunks 2..n of a long prompt) it continues at its position. Inactive
    rows are not written and keep their positions. Returns (logits (B, V)
    f32 at each row's last real token, caches with the active rows'
    positions advanced by ``lengths``); the rings are written in place."""
    check_supported(cfg)
    B = inputs["tokens"].shape[0]
    lengths = torch.as_tensor(lengths).to("cpu", torch.int64).reshape(-1)
    act = torch.ones(B, dtype=torch.bool) if active is None \
        else _host_rows(active, B)
    if not resume:
        caches = tuple({**c, "pos": torch.where(act[None], 0, c["pos"])}
                       for c in caches)
    x, _ = embed_inputs(params, cfg, inputs)
    x, _ = _run_stack(params["layers"], cfg.pattern, cfg, x, None, caches,
                      lengths=lengths, active=act)
    x = L.rmsnorm(params["final_norm"], x)
    idx = host_to((lengths - 1).clamp_min(0), x.device)
    last = x[torch.arange(B, device=x.device), idx][:, None]
    logits = unembed(params, cfg, last)[:, 0].to(torch.float32)
    grow = (lengths * act).to(torch.int32)
    return logits, tuple({**c, "pos": c["pos"] + grow} for c in caches)
