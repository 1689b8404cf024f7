"""Plain PyTorch versions of the port's kernels (the bit-equality targets).

Each wrapper in :mod:`repro_torch.kernels.block_combine`,
:mod:`repro_torch.kernels.quantize`,
:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.ring_attention`, :mod:`repro_torch.kernels.wkv`
and :mod:`repro_torch.kernels.mamba_scan` runs these for a tensor on the CPU;
``chip_smoke.py`` and the GPU tests hold each CUDA kernel against them on the
card. Two-op combines round the intermediate to the operand type, as the
reference's jnp oracles do.

The int8 scale is ``max(absmax, 1e-8) * f32(1/127)``: under ``jit`` (the
reference's decode step) and in the Pallas kernel XLA folds the reference's
``/ 127.0`` into that product, so this is the scale its K/V cache holds
(an eager ``jnp`` call divides instead, and differs by one ulp in a few
percent of rows).
"""

from __future__ import annotations

import math

import torch

__all__ = ["OPS", "INV127", "combine2_ref", "combine3_ref",
           "compress_bf16_ref", "decompress_bf16_ref", "quantize_int8_ref",
           "quantize_int8_into_ref", "dequantize_int8_ref",
           "flash_attention_ref", "ring_attention_ref",
           "wkv6_recurrent_ref", "mamba_scan_recurrent_ref"]

# f32(1/127) (bits 0x3c010204), exact as a Python float
INV127 = 0.007874015718698502
# _flash_sdpa's query and key tiles (layers.py FLASH_BLOCK_Q, FLASH_BLOCK_K)
FLASH_BLOCK = 512

OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum,
       "mul": torch.mul}


def combine2_ref(a: torch.Tensor, b: torch.Tensor, *,
                 op: str = "add") -> torch.Tensor:
    return OPS[op](a, b)


def combine3_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                 op: str = "add") -> torch.Tensor:
    f = OPS[op]
    return f(f(a, b), c)


def compress_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def decompress_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def quantize_int8_ref(x: torch.Tensor):
    """(R, W) f32/bf16 -> (q (R, W) int8, scale (R, 1) f32)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(-1, keepdim=True).clamp_min(1e-8) * INV127
    # tensor / tensor: on the card a division by a Python scalar would be
    # computed as a product with its reciprocal
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_int8_into_ref(k, v, k_ring, v_ring, k_scale, v_scale,
                           pos, n) -> None:
    """The fused K/V cache write: :func:`quantize_int8_ref` of ``k``'s and
    ``v``'s (B, T, KV, W) rows, then token ``t`` of row ``b`` assigned to
    ring position ``(pos[b] + t) % S`` for ``t < n[b]`` (B host integers
    each), in place; the reference's slot write with its pad writes
    suppressed (``attention_decode_slots``)."""
    S = k_ring.shape[1]
    t = torch.arange(k.shape[1])
    bi, ti = torch.nonzero(t[None] < torch.as_tensor(n)[:, None],
                           as_tuple=True)
    si = (torch.as_tensor(pos, dtype=torch.int64)[bi] + ti) % S
    bi, ti, si = (i.to(k.device) for i in (bi, ti, si))
    for x, ring, scale in ((k, k_ring, k_scale), (v, v_ring, v_scale)):
        q, s = quantize_int8_ref(x.reshape(-1, x.shape[-1]))
        ring[bi, si] = q.view(x.shape)[bi, ti]
        scale[bi, si] = s.view(*x.shape[:-1], 1)[bi, ti]


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        chunk: int | None = None, scale: float | None = None):
    """The port of the reference's ``layers._flash_sdpa`` (layers.py:324),
    with its blocking (512-query by 512-key tiles) and its roundings: the
    logit tile is the product in the input dtype, then cast to f32 and
    multiplied by the f32 ``1/sqrt(dh)``; masked logits take the finite
    -1e30; ``p`` is cast to the input dtype for the PV product, whose
    result comes back in that dtype before the f32 accumulate; out =
    ``acc / max(l, 1e-30)`` in the input dtype.

    q: (B, T, H, dh); k, v: (B, T, KV, dh), H a multiple of KV. Returns
    ``(out (B, T, H, dh), lse (B, H, T) f32)``, ``lse = m + log(l)`` per row
    (what the backward needs; the reference does not return it). ``scale``
    defaults to the reference's ``1/sqrt(dh)``; a caller that zero-pads
    head_dim passes the true width's."""
    B, Tq, H, dh = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    dt = q.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    bq, bk = min(FLASH_BLOCK, Tq), min(FLASH_BLOCK, Tk)
    pad_q, pad_k = (-Tq) % bq, (-Tk) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Tq + pad_q) // bq, (Tk + pad_k) // bk
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * bq:(qi + 1) * bq].reshape(B, bq, KV, rep, dh)
        qpos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, bq, KV, rep), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, bq, KV, rep), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, bq, KV, rep, dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk = k[:, ki * bk:(ki + 1) * bk]
            vblk = v[:, ki * bk:(ki + 1) * bk]
            s = torch.einsum("bqgrd,bkgd->bqgrk", qblk, kblk)
            s = s.to(torch.float32) * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            msk = (kpos[None, :] < Tk).expand(bq, bk)
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                msk = msk & (kpos[None, :] > qpos[:, None] - window)
            if chunk is not None:
                msk = msk & ((kpos[None, :] // chunk)
                             == (qpos[:, None] // chunk))
            s = s.masked_fill(~msk[None, :, None, None, :], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqgrk,bkgd->bqgrd", p.to(dt), vblk).to(torch.float32)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(dt))
        lses.append(m + torch.log(l))
    out = torch.cat(outs, 1)[:, :Tq].reshape(B, Tq, H, dh)
    lse = torch.cat(lses, 1)[:, :Tq].reshape(B, Tq, H).permute(0, 2, 1)
    return out, lse.contiguous()


def ring_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       plan: torch.Tensor, window: int | None = None,
                       chunk: int | None = None) -> torch.Tensor:
    """Each query's attention over its row's K/V ring (the reference's
    ``attention_decode_slots`` einsums): q (B, T, H, D), k and v (B, S, KV,
    D), plan (2, B) int64, the call's start positions and token counts.
    Slot s of row b holds position ``last - ((last - s) mod S)``, ``last =
    pos + n - 1`` (negative: never written); query t at ``pos + t`` reads
    the held positions up to its own, within ``window`` and its ``chunk``.
    The scores are the einsum in the input dtype, then f32 over sqrt(D);
    the softmax in f32, rounded to the input dtype before the second
    einsum. A query with no position to read averages V."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    pos, n = plan[0], plan[1]
    qpos = (pos[:, None] + torch.arange(T, device=q.device)[None])[..., None]
    last = (pos + n - 1)[:, None]
    ki = last - torch.remainder(last - torch.arange(S, device=q.device), S)
    ki = ki[:, None, :]                                       # (B, 1, S)
    valid = (ki >= 0) & (ki <= qpos)
    if window is not None:
        valid &= ki > qpos - window
    if chunk is not None:
        valid &= (ki // chunk) == (qpos // chunk)
    qg = q.reshape(B, T, KV, H // KV, D)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k).to(torch.float32) \
        / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None], -1e30)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrts,bsgd->btgrd", w, v).reshape(B, T, H, D)


def wkv6_recurrent_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w_log: torch.Tensor, u: torch.Tensor,
                       state: torch.Tensor, valid: torch.Tensor | None = None,
                       collect: bool = False) -> tuple:
    """The RWKV-6 WKV recurrence, token by token (the reference's
    ``ssm.wkv_recurrent`` scan): r, k, v (B, T, H, K) in f32 or bf16,
    w_log (B, T, H, K) f32, u (H, K) f32, state (B, H, K, K) f32, valid
    (B, T) bool or None. In f32, with ``w = exp(w_log)``:
    ``o_t = r_t . (S + diag(u) k_t v_t^T)``, then ``S <- diag(w_t) S +
    k_t v_t^T`` where ``valid`` (an invalid token leaves S unchanged).
    Returns (o (B, T, H, K) in r's dtype, the final state), or with
    ``collect`` (o, states (B, T, H, K, K)), entry t the state after token
    t."""
    f32 = torch.float32
    w = torch.exp(w_log.to(f32))
    rs, ks, vs = (t.to(f32) for t in (r, k, v))
    uu = u.to(f32)[None, :, :, None]
    S = state.to(f32)
    outs, states = [], []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]
        outs.append((rs[:, t, :, :, None] * (S + uu * kv)).sum(-2))
        nxt = w[:, t, :, :, None] * S + kv
        S = nxt if valid is None else torch.where(
            valid[:, t, None, None, None], nxt, S)
        if collect:
            states.append(S)
    B, T, H, K = r.shape
    o = (torch.stack(outs, 1) if outs else
         torch.zeros((B, 0, H, K), dtype=f32, device=r.device)).to(r.dtype)
    if collect:
        return o, (torch.stack(states, 1) if states else
                   torch.zeros((B, 0, H, K, K), dtype=f32, device=r.device))
    return o, S


def mamba_scan_recurrent_ref(dt: torch.Tensor, dtx: torch.Tensor,
                             Bm: torch.Tensor, C: torch.Tensor,
                             A: torch.Tensor, state: torch.Tensor,
                             valid: torch.Tensor | None = None,
                             collect: bool = False) -> tuple:
    """The Mamba selective scan, token by token (the reference's
    ``ssm.mamba_scan_recurrent``, op for op): dt, dtx (B, T, Di) f32, Bm, C
    (B, T, N) f32, A (Di, N) f32 (negative), state (B, Di, N) f32, valid
    (B, T) bool or None. For each token, ``h' = exp(dt A) * h + dtx Bm``
    (a product, a product, an exp, a product and a sum, each rounded), ``y
    = sum_n h'[n] C[n]``, and ``h <- h'`` where ``valid`` (an invalid token
    leaves h unchanged; its y is still h' . C). Returns (y (B, T, Di) f32,
    the final state), or with ``collect`` (y, states (B, T, Di, N)), entry
    t the state after token t."""
    f32 = torch.float32
    h = state.to(f32)
    ys, states = [], []
    for t in range(dt.shape[1]):
        a0 = dt[:, t, :, None] * A[None]
        b0 = dtx[:, t, :, None] * Bm[:, t, None, :]
        nxt = torch.exp(a0) * h + b0
        h = nxt if valid is None else torch.where(valid[:, t, None, None],
                                                  nxt, h)
        ys.append(torch.einsum("bdn,bn->bd", nxt, C[:, t]))
        if collect:
            states.append(h)
    B, T, Di = dt.shape
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, Di), dtype=f32, device=dt.device))
    if collect:
        return y, (torch.stack(states, 1) if states else torch.zeros(
            (B, 0, Di, A.shape[1]), dtype=f32, device=dt.device))
    return y, h
