"""Plain PyTorch versions of the port's kernels (the bit-equality targets).

Each wrapper in :mod:`repro_torch.kernels.block_combine`,
:mod:`repro_torch.kernels.quantize` and
:mod:`repro_torch.kernels.flash_attention` runs these for a tensor on the CPU;
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
           "flash_attention_ref"]

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
                           slot: int) -> None:
    """The fused K/V cache write: :func:`quantize_int8_ref` of ``k``'s and
    ``v``'s (B, T, KV, W) rows, then the slice assignments into the rings
    (B, S, KV, W) and scales (B, S, KV, 1) at ``slot``, in place (the
    reference's ``_cache_write``, with its ``dynamic_update_slice``)."""
    end = slot + k.shape[1]
    for x, ring, scale in ((k, k_ring, k_scale), (v, v_ring, v_scale)):
        q, s = quantize_int8_ref(x.reshape(-1, x.shape[-1]))
        ring[:, slot:end] = q.view(x.shape)
        scale[:, slot:end] = s.view(*x.shape[:-1], 1)


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
