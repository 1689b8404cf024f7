"""The RWKV-6 ("Finch") sublayer: time mix (WKV) and channel mix (the port
of the RWKV half of ``repro.models.ssm``; its Mamba half comes with
ROADMAP.md queue 1, 'Next' item 3).

The WKV recurrence has two forms, as in the reference:

* the exact token recurrence, :func:`wkv_recurrent`: O(1) state per token,
  every serving call (decode ticks, prefill chunks with ``lengths``, verify
  calls that collect a state per token). On a CUDA tensor it is the
  hand-written kernel :func:`repro_torch.kernels.wkv.wkv6`, which gives a
  token the same bits in any call; on the CPU its plain version;
* the chunkwise form, :func:`wkv_chunked`: the state carried between chunks
  of ``chunk_size`` tokens and everything within a chunk dense products,
  as the reference's einsums are (a full-sequence forward whose length is a
  multiple of the chunk).

Shapes follow the reference: activations (B, T, D), heads (B, T, H, K), the
state (B, H, K, K). A decode cache is ``{"shift1", "shift2": (B, 1, D) in
the compute dtype, "state": (B, H, K, K) f32}``; :func:`rwkv_block`
returns a new one, and the stack (``transformer._apply_sub``) writes it
into the slot caches in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.data import threefry
from repro_torch.kernels import wkv
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

__all__ = ["RWKVConfig", "rwkv_block_init", "wkv_recurrent", "wkv_chunked",
           "rwkv_block", "rwkv_cache_spec"]


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk_size: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def d_cmix(self) -> int:
        """The channel mix's hidden width: 3.5 D down to a multiple of 32."""
        return int(3.5 * self.d_model) // 32 * 32


def rwkv_block_init(keys, cfg: RWKVConfig, dtype=torch.float32,
                    device=None) -> Params:
    """The reference's ``rwkv_block_init`` for each key of ``keys`` (one per
    period), stacked along a leading period axis: each key splits in 12,
    ``wr``, ``wk``, ``wv``, ``wg``, ``w_lora_a``, ``w_lora_b`` (scale 0.01)
    and ``wo`` of the time mix from keys 0-6, ``wk``, ``wv`` and ``wr`` of
    the channel mix from keys 7-9; the mixing weights 0.5, the decay bias
    -6 and the bonus ``u`` 0, in f32."""
    D, H, K, R = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.decay_lora
    n, f32 = len(keys), torch.float32
    ks = [threefry.split(k, 12) for k in keys]
    drawn = L._stacked([k[:7] for k in ks], {
        "wr": ((D, D), None), "wk": ((D, D), None), "wv": ((D, D), None),
        "wg": ((D, D), None), "w_lora_a": ((D, R), None),
        "w_lora_b": ((R, D), 0.01), "wo": ((D, D), None)}, dtype, device)
    cm = L._stacked([k[7:10] for k in ks], {
        "wk": ((D, cfg.d_cmix), None), "wv": ((cfg.d_cmix, D), None),
        "wr": ((D, D), None)}, dtype, device)

    def full(shape, value):
        return torch.full((n, *shape), value, dtype=f32, device=device)

    tmix = {f"mu_{c}": full((D,), 0.5) for c in "rkvwg"}
    tmix.update({name: drawn[name] for name in
                 ("wr", "wk", "wv", "wg", "w_lora_a", "w_lora_b")})
    tmix.update(w_bias=full((D,), -6.0), u=full((H, K), 0.0),
                ln_x=L.rmsnorm_init(D, device=device, periods=n),
                wo=drawn["wo"])
    return {"ln1": L.rmsnorm_init(D, device=device, periods=n),
            "tmix": tmix,
            "ln2": L.rmsnorm_init(D, device=device, periods=n),
            "cmix": {"mu_k": full((D,), 0.5), "mu_r": full((D,), 0.5),
                     **cm}}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """xx[t] = x[t - 1]; position 0 takes ``prev`` (the decode carry) or
    zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _tmix_inputs(p: Params, x: torch.Tensor, shifted: torch.Tensor,
                 cfg: RWKVConfig, matmul=torch.matmul) -> tuple:
    """(r, k, v (B, T, H, K), g (B, T, D), w_log (B, T, H, K) f32): the
    token-shift mixes, the four products and the f32 decay LoRA, with the
    reference's two clips of the log-decay."""
    d = shifted - x

    def mix(mu):
        return x + d * mu.to(x.dtype)
    B, T, _ = x.shape
    H, K = cfg.n_heads, cfg.head_dim
    r, k, v = (matmul(mix(p["mu_" + c]), p["w" + c].to(x.dtype))
               .reshape(B, T, H, K) for c in "rkv")
    g = matmul(mix(p["mu_g"]), p["wg"].to(x.dtype))
    f32 = torch.float32
    wl = mix(p["mu_w"]).to(f32)
    lora = matmul(torch.tanh(matmul(wl, p["w_lora_a"].to(f32))),
                  p["w_lora_b"].to(f32))
    w_log = -torch.exp(torch.clamp(lora + p["w_bias"], -8.0, 2.0))
    # per-channel log-decay in (-inf, 0); the clip keeps the chunked form
    # stable
    w_log = torch.clamp(w_log, -8.0, -1e-4).reshape(B, T, H, K)
    return r, k, v, g, w_log


def wkv_recurrent(r, k, v, w_log, u, state, valid=None, collect=False):
    """The exact recurrence. r/k/v/w_log (B, T, H, K), u (H, K), state (B,
    H, K, K) f32: ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``o_t = r_t .
    (S_{t-1} + diag(u) k_t v_t^T)``. Returns (o (B, T, H, K) in r's dtype,
    new state). ``valid`` (B, T) bool skips a token's state update (a pad
    leaves the state bit-unchanged); ``collect=True`` returns (o, states
    (B, T, H, K, K)), entry t the state after token t, what a verify call
    commits at its accepted length. The kernel on the card, the plain
    version on the CPU (:func:`repro_torch.kernels.wkv.wkv6`)."""
    return wkv.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                    w_log.to(torch.float32).contiguous(),
                    u.to(torch.float32).contiguous(),
                    state.to(torch.float32).contiguous(),
                    None if valid is None else valid.contiguous(), collect)


def wkv_chunked(r, k, v, w_log, u, state, chunk: int) -> tuple:
    """The chunkwise-parallel WKV6 of the reference, in f32: within a chunk
    of C tokens token j < i adds ``r_i . diag(exp(cw_{i-1} - cw_j)) k_j
    v_j`` to output i, ``cw`` the in-chunk cumulative log-decay (every
    exponent <= 0); history flows between chunks through the state."""
    B, T, H, K = r.shape
    C = chunk
    if T % C:
        raise ValueError(f"wkv_chunked: T {T} is not a multiple of {C}")
    n = T // C
    f32 = torch.float32
    rc, kc, vc, wc = (t.to(f32).reshape(B, n, C, H, K)
                      for t in (r, k, v, w_log))
    uu = u.to(f32)[None, None]
    mask = (torch.arange(C, device=r.device)[:, None]
            > torch.arange(C, device=r.device)[None, :])[:, :, None, None]
    S = state.to(f32)
    outs = []
    for c in range(n):
        rr, kk, vv, ww = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        cw = torch.cumsum(ww, dim=1)                  # sum_{s <= i}
        cw_im1 = cw - ww                              # sum_{s < i}
        diff = cw_im1[:, :, None] - cw[:, None, :]    # (B, C, C, H, K)
        A = torch.einsum("bihk,bjhk,bijhk->bhij", rr, kk,
                         torch.exp(torch.where(mask, diff, -1e30)))
        diag = torch.einsum("bihk,bihk->bhi", rr * uu, kk)
        o = torch.einsum("bhij,bjhv->bihv", A, vv) \
            + diag.permute(0, 2, 1)[..., None] * vv
        o = o + torch.einsum("bihk,bhkv->bihv", rr * torch.exp(cw_im1), S)
        wtot = cw[:, -1]                              # (B, H, K)
        kscal = kk * torch.exp(wtot[:, None] - cw)
        S = torch.exp(wtot)[..., None] * S + torch.einsum(
            "bjhk,bjhv->bhkv", kscal, vv)
        outs.append(o)
    out = torch.stack(outs, 1).reshape(B, T, H, K)
    return out.to(r.dtype), S


def _checkpoint_row(seq: torch.Tensor, lengths) -> torch.Tensor:
    """seq (B, T, D) -> (B, 1, D): token ``lengths - 1`` of each row (its
    last real token), or the last token when ``lengths`` is None. The carry
    after ``L`` tokens then depends on those tokens only, so a carry
    snapshotted after a shared prompt prefix is any later request's."""
    if lengths is None:
        return seq[:, -1:]
    idx = torch.clamp(lengths - 1, min=0)[:, None, None]
    return torch.gather(seq, 1, idx.expand(seq.shape[0], 1, seq.shape[2]))


def rwkv_block(p: Params, x: torch.Tensor, cfg: RWKVConfig,
               cache: Params | None = None, use_chunked: bool = True,
               lengths: torch.Tensor | None = None,
               collect_states: bool = False, matmul=torch.matmul,
               norm=L.rmsnorm) -> tuple:
    """The RWKV-6 block (time mix and channel mix, each with its residual)
    -> (x, new cache). ``cache`` is the decode cache (None: zeros, and the
    new cache is still returned).

    ``lengths`` (B,) int64 on x's device: the input is right-padded and
    tokens ``t >= lengths[b]`` are pads, left out of the state update, and
    the shift carries are taken at ``lengths - 1``. ``collect_states``
    (speculative verify) returns per-token checkpoints instead: ``shift1``
    and ``shift2`` (B, T, 1, D) and ``state`` (B, T, H, K, K), entry t the
    cache as if the call had ended at token t. Either, T = 1, ``use_chunked``
    False, or a T that is not a multiple of ``cfg.chunk_size`` runs the
    exact recurrence; anything else the chunked form. The slot paths pass
    ``matmul=layers.serve_matmul`` and ``norm=layers.serve_rmsnorm``."""
    B, T, D = x.shape
    tm, cm = p["tmix"], p["cmix"]
    xn = norm(p["ln1"], x)
    shifted = _token_shift(xn, cache["shift1"] if cache else None)
    r, k, v, g, w_log = _tmix_inputs(tm, xn, shifted, cfg, matmul)
    state = (cache["state"] if cache else torch.zeros(
        (B, cfg.n_heads, cfg.head_dim, cfg.head_dim), dtype=torch.float32,
        device=x.device))
    u = tm["u"].to(torch.float32)
    valid = None
    if lengths is not None:
        valid = torch.arange(T, device=x.device)[None] < lengths[:, None]
    states_all = None
    if collect_states:
        o, states_all = wkv_recurrent(r, k, v, w_log, u, state, valid,
                                      collect=True)
    elif lengths is not None or T == 1 or not use_chunked or \
            T % cfg.chunk_size:
        o, state = wkv_recurrent(r, k, v, w_log, u, state, valid)
    else:
        o, state = wkv_chunked(r, k, v, w_log, u, state, cfg.chunk_size)
    o = norm(tm["ln_x"], o.reshape(B, T, D))
    x = x + matmul(F.silu(g) * o, tm["wo"].to(x.dtype))

    xn2 = norm(p["ln2"], x)
    shifted2 = _token_shift(xn2, cache["shift2"] if cache else None)
    d2 = shifted2 - xn2

    def mix(mu):
        return xn2 + d2 * mu.to(x.dtype)
    kk = torch.square(F.relu(matmul(mix(cm["mu_k"]), cm["wk"].to(x.dtype))))
    x = x + torch.sigmoid(matmul(mix(cm["mu_r"]), cm["wr"].to(x.dtype))) \
        * matmul(kk, cm["wv"].to(x.dtype))

    if collect_states:
        # the shift carry after token t is the normed activation at t
        new = {"shift1": xn[:, :, None], "shift2": xn2[:, :, None],
               "state": states_all}
    else:
        new = {"shift1": _checkpoint_row(xn, lengths),
               "shift2": _checkpoint_row(xn2, lengths), "state": state}
    return x, new


def rwkv_cache_spec(cfg: RWKVConfig, batch: int, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one period's decode cache."""
    H, K, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"shift1": ((batch, 1, D), dtype),
            "shift2": ((batch, 1, D), dtype),
            "state": ((batch, H, K, K), torch.float32)}
