"""The recurrent sequence mixers: the RWKV-6 ("Finch") sublayer, time mix
(WKV) and channel mix, and the Mamba selective SSM (the port of
``repro.models.ssm``).

Each recurrence has two forms, as in the reference:

* the exact token recurrence, :func:`wkv_recurrent` and
  :func:`mamba_scan_recurrent`: O(1) state per token, every serving call
  (decode ticks, prefill chunks with ``lengths``, verify calls that collect
  a state per token). On a CUDA tensor each is a hand-written kernel
  (:func:`repro_torch.kernels.wkv.wkv6`,
  :func:`repro_torch.kernels.mamba_scan.mamba_scan`) that gives a token
  the same bits in any call; on the CPU its plain version;
* the chunkwise form, :func:`wkv_chunked` and :func:`mamba_scan_chunked`:
  the state carried between chunks of ``chunk_size`` tokens and everything
  within a chunk dense products or a log-depth scan, as the reference's
  are (a full-sequence forward; plain PyTorch, differentiable).

Shapes follow the reference: activations (B, T, D), heads (B, T, H, K),
the WKV state (B, H, K, K), Mamba's channels (B, T, Di) and its state (B,
Di, N). A decode cache is ``{"shift1", "shift2": (B, 1, D) in the compute
dtype, "state": (B, H, K, K) f32}`` for RWKV and ``{"conv": (B, d_conv -
1, Di) in the compute dtype, "ssm": (B, Di, N) f32}`` for Mamba;
:func:`rwkv_block` and :func:`mamba_block` return a new one, and the stack
(``transformer._apply_sub``) writes it into the slot caches in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.data import threefry
from repro_torch.kernels import mamba_scan, wkv
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

__all__ = ["RWKVConfig", "rwkv_block_init", "wkv_recurrent", "wkv_chunked",
           "rwkv_block", "rwkv_cache_spec", "MambaConfig", "mamba_init",
           "mamba_scan_chunked", "mamba_scan_recurrent", "mamba_block",
           "mamba_cache_spec"]


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


# --------------------------------------------------------------------------
# Mamba (selective SSM)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log`` of positive normal ``x`` as the reference's compiled
    ``jnp.log`` evaluates it on the CPU: the exponent split off, the
    mantissa moved to [sqrt(1/2), sqrt(2)) less 1, the rational (3, 3)
    approximation of log(1 + m), then ``e ln 2`` added, every step rounded
    to f32 (the fused multiply-adds through f64). ``torch.log`` rounds
    correctly and so differs at log 7 by one unit; this gives the
    reference's ``A_log`` bits (held for 1 to 16 by
    ``tests/test_torch_mamba.py``)."""
    f32, f64 = torch.float32, torch.float64

    def fma(a, b, c):
        return (a.to(f64) * b + c).to(f32)

    m, e = torch.frexp(x.to(f32))
    e = e.to(f32)
    small = m < 0.7071067811865476
    e = torch.where(small, e - 1, e)
    r = m - 1
    r = torch.where(small, r + m, r)
    c = {k: torch.tensor(v, dtype=f32).to(f64) for k, v in (
        ("p1", 1.0000000190281136), ("p2", 1.0000000190281063),
        ("p3", 0.18256296349849254), ("q1", 1.4999999999999927),
        ("q2", 0.59923249590823520), ("q3", 0.049616247954120038),
        ("ln2", 0.6931471805599453))}
    p = fma(r, c["p3"], c["p2"])
    p = r * fma(r, p, c["p1"])
    q = fma(r, c["q3"], c["q2"])
    q = fma(r, fma(r, q, c["q1"]), torch.tensor(1.0, dtype=f64))
    return fma(e, c["ln2"], p / q)


def mamba_init(keys, cfg: MambaConfig, dtype=torch.float32,
               device=None) -> Params:
    """The reference's ``mamba_init`` for each key of ``keys`` (one per
    period), stacked along a leading period axis: each key splits in 6,
    ``in_proj``, ``conv_w`` (scale 0.5), ``x_proj``, ``dt_proj`` and
    ``out_proj`` from keys 0-4 in ``dtype``; in f32 ``conv_b`` 0, ``dt_bias``
    ``log(expm1(0.01))``, ``A_log`` ``log(1 .. N)`` on every channel and
    ``D_skip`` 1, computed on the CPU (the same bits on any device)."""
    D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
    n, f32 = len(keys), torch.float32
    ks = [threefry.split(k, 6) for k in keys]
    drawn = L._stacked([k[:5] for k in ks], {
        "in_proj": ((D, 2 * Di), None), "conv_w": ((cfg.d_conv, Di), 0.5),
        "x_proj": ((Di, R + 2 * N), None), "dt_proj": ((R, Di), None),
        "out_proj": ((Di, D), None)}, dtype, device)
    dt_bias = torch.log(torch.expm1(torch.full((Di,), 0.01, dtype=f32)))
    a_log = _log_f32(torch.arange(1, N + 1, dtype=f32))

    def stack(t):
        return t.expand(n, *t.shape).contiguous().to(device)
    return {"in_proj": drawn["in_proj"], "conv_w": drawn["conv_w"],
            "conv_b": torch.zeros((n, Di), dtype=f32, device=device),
            "x_proj": drawn["x_proj"], "dt_proj": drawn["dt_proj"],
            "dt_bias": stack(dt_bias),
            "A_log": stack(a_log.expand(Di, N)),
            "D_skip": torch.ones((n, Di), dtype=f32, device=device),
            "out_proj": drawn["out_proj"]}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` rounds otherwise above 0 and returns
    x itself above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it: ``x * logistic(x)``,
    the logistic ``1 / (1 + exp(-x))`` with each operation rounded in x's
    dtype (so in bf16 these are its bits, where ``F.silu`` rounds once and
    parts from it in about 40 % of elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def _mamba_inner(p: Params, xin: torch.Tensor, cfg: MambaConfig,
                 matmul=torch.matmul) -> tuple:
    """xin (B, T, Di), after the conv and silu -> the scan's compact inputs
    (dt, dt * x (B, T, Di), B, C (B, T, N)), all f32: ``x_proj`` in the
    compute dtype, split in f32, then ``dt_proj`` in f32 and the softplus.
    The rank-4 coefficients are built inside the scan."""
    R, N = cfg.dt_rank, cfg.d_state
    f32 = torch.float32
    proj = matmul(xin, p["x_proj"].to(xin.dtype)).to(f32)
    dt, Bc, Cc = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = _softplus(matmul(dt, p["dt_proj"].to(f32)) + p["dt_bias"])
    return dt, dt * xin.to(f32), Bc, Cc


def _scan_pairs(la: torch.Tensor, b: torch.Tensor) -> tuple:
    """The inclusive scan over axis 1 of the pairs (la, b) under ``(la1, b1)
    then (la2, b2) -> (la1 + la2, b2 + exp(la2) b1)``, in log2 steps (each
    element combined with the one ``off`` before it, ``off`` doubling)."""
    T, off = la.shape[1], 1
    while off < T:
        la, b = (torch.cat([la[:, :off], la[:, :-off] + la[:, off:]], 1),
                 torch.cat([b[:, :off], b[:, off:]
                            + torch.exp(la[:, off:]) * b[:, :-off]], 1))
        off *= 2
    return la, b


def mamba_scan_chunked(dt, dtx, Bc, C, A, state, chunk: int) -> tuple:
    """``h_t = exp(dt_t A) h_{t-1} + dtx_t B_t``, ``y_t = C_t . h_t``, in
    chunks of ``chunk`` tokens: within a chunk a log-depth scan of the
    rank-4 coefficients (built per chunk, not over the sequence), the state
    carried between chunks; f32, differentiable. dt, dtx (B, T, Di), Bc, C
    (B, T, N), A (Di, N), state (B, Di, N); T a multiple of ``chunk``.
    Returns (y (B, T, Di), the final state). Its sums run in another tree
    than the reference's ``associative_scan`` and than the recurrence, so
    it agrees with either within a tolerance, not bitwise."""
    B, T, Di = dt.shape
    if T % chunk:
        raise ValueError(f"mamba_scan_chunked: T {T} is not a multiple of "
                         f"{chunk}")
    h, ys = state, []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        la, b = _scan_pairs(dt[:, sl, :, None] * A,
                            dtx[:, sl, :, None] * Bc[:, sl, None, :])
        h_all = torch.exp(la) * h[:, None] + b        # (B, chunk, Di, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C[:, sl]))
        h = h_all[:, -1]
    return torch.cat(ys, 1), h


def mamba_scan_recurrent(dt, dtx, Bc, C, A, state, valid=None,
                         collect: bool = False) -> tuple:
    """The exact token recurrence, op for op the T = 1 decode step: dt, dtx
    (B, T, Di), Bc, C (B, T, N), A (Di, N), state (B, Di, N), all f32.
    Returns (y (B, T, Di), new state). ``valid`` (B, T) bool skips a
    token's state update (a pad leaves the state bit-unchanged), so a
    prompt split across calls carries one call's bits; ``collect=True``
    returns (y, states (B, T, Di, N)), entry t the state after token t,
    what a verify call commits at its accepted length. The kernel on the
    card, the plain version on the CPU
    (:func:`repro_torch.kernels.mamba_scan.mamba_scan`)."""
    f32 = torch.float32
    return mamba_scan.mamba_scan(
        dt.to(f32).contiguous(), dtx.to(f32).contiguous(),
        Bc.to(f32).contiguous(), C.to(f32).contiguous(),
        A.to(f32).contiguous(), state.to(f32).contiguous(),
        None if valid is None else valid.contiguous(), collect)


def mamba_block(p: Params, x: torch.Tensor, cfg: MambaConfig,
                cache: Params | None = None,
                lengths: torch.Tensor | None = None,
                collect_states: bool = False, matmul=torch.matmul) -> tuple:
    """The Mamba block on x (B, T, D), already normed by the caller (its
    residual is the caller's too) -> (out (B, T, D), new cache). ``cache``
    is the decode cache (None: zeros, and the new cache is still returned).

    ``lengths`` (B,) int64 on x's device: the input is right-padded and
    tokens ``t >= lengths[b]`` are pads, left out of the state update, and
    the conv window is taken at the true length (the ``d_conv - 1`` inputs
    ending at token ``lengths - 1``). ``collect_states`` (speculative
    verify) returns per-token checkpoints instead: ``conv`` (B, T, d_conv -
    1, Di), entry t the window ending at token t, and ``ssm`` (B, T, Di,
    N). Either, or T = 1, runs the exact recurrence; anything else the
    chunked form (chunks of ``cfg.chunk_size``, or one of T where T is not
    a multiple). The depthwise causal conv sums ``xcat[:, k:k + T] *
    w[k]`` for k in order in the compute dtype, as the reference does.
    The slot paths pass ``matmul=layers.serve_matmul`` for the four
    products."""
    B, T, _ = x.shape
    Di, N, Kc = cfg.d_inner, cfg.d_state, cfg.d_conv
    f32 = torch.float32
    zx = matmul(x, p["in_proj"].to(x.dtype))
    z, xin = zx[..., :Di], zx[..., Di:]
    prev = (cache["conv"].to(x.dtype) if cache else
            torch.zeros((B, Kc - 1, Di), dtype=x.dtype, device=x.device))
    xcat = torch.cat([prev, xin], 1)
    if collect_states:
        # the window ending at token t: xcat[t + 1 : t + Kc] for every t
        idx = (torch.arange(T, device=x.device)[:, None] + 1
               + torch.arange(Kc - 1, device=x.device)[None])
        new_conv = xcat[:, idx]                      # (B, T, Kc - 1, Di)
    elif lengths is None:
        new_conv = xcat[:, -(Kc - 1):]
    else:
        # the Kc - 1 inputs ending at token lengths - 1
        idx = lengths[:, None] + torch.arange(Kc - 1, device=x.device)[None]
        new_conv = torch.gather(xcat, 1, idx[..., None].expand(
            B, Kc - 1, Di))
    w = p["conv_w"].to(x.dtype)
    xc = sum(xcat[:, k:k + T] * w[k] for k in range(Kc))
    xc = _silu(xc + p["conv_b"].to(x.dtype))

    dt, dtx, Bc, Cc = _mamba_inner(p, xc, cfg, matmul)
    A = -torch.exp(p["A_log"])                     # (Di, N), negative
    state = (cache["ssm"] if cache else torch.zeros(
        (B, Di, N), dtype=f32, device=x.device))
    valid = None
    if lengths is not None:
        valid = torch.arange(T, device=x.device)[None] < lengths[:, None]
    if collect_states or lengths is not None or T == 1:
        y, state = mamba_scan_recurrent(dt, dtx, Bc, Cc, A, state, valid,
                                        collect=collect_states)
    else:
        ck = cfg.chunk_size if T % cfg.chunk_size == 0 else T
        y, state = mamba_scan_chunked(dt, dtx, Bc, Cc, A, state, ck)
    y = (y + p["D_skip"] * xc.to(f32)).to(x.dtype)
    out = matmul(_silu(z) * y, p["out_proj"].to(x.dtype))
    return out, {"conv": new_conv.to(x.dtype), "ssm": state}


def mamba_cache_spec(cfg: MambaConfig, batch: int, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one period's decode cache."""
    return {"conv": ((batch, cfg.d_conv - 1, cfg.d_inner), dtype),
            "ssm": ((batch, cfg.d_inner, cfg.d_state), torch.float32)}
