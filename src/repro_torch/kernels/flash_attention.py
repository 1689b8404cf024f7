"""Flash attention: the hand-written forward kernel, its autograd Function
and the plain backward.

* :func:`flash_attention` — ``(out, lse)`` of blocked online-softmax
  attention on the model's layouts, q ``(B, T, H, dh)`` and k, v
  ``(B, T, KV, dh)`` (grouped-query heads read in place), with causal,
  window and chunk masks. For a CUDA tensor it launches the kernel in
  ``csrc/flash_attention.cu`` (the port of the Pallas ``_kernel`` of
  ``repro/kernels/flash_attention.py``, which is the tiled form of the
  model's ``layers._flash_sdpa``) on the current stream and counts the
  launch in ``flash_attention.launches``. The kernel takes bf16 or f32 at
  head_dim 64 or 128; any other head_dim up to 128 is zero-padded to the
  next of the two and the output sliced back (:func:`padded_flash`), and a
  wider one is refused. For a CPU tensor it runs the plain version,
  :func:`repro_torch.kernels.ref.flash_attention_ref`.
* :func:`flash_attention_backward` — the standard flash backward from the
  saved ``(q, k, v, out, lse)``, in plain PyTorch on either device (the
  reference has no backward kernel: its gradient is XLA's derivative of
  ``_flash_sdpa``'s checkpointed scan). Per block of query rows it holds
  at most ``(BACKWARD_BLOCK, keys in range)`` scores per head.
* :class:`FlashAttention` / :func:`flash_sdpa` — the two as one
  differentiable op, what ``layers.attention`` runs above
  ``FLASH_THRESHOLD``. The forward looks :func:`flash_attention` up in this
  module at each call, so a caller can swap in the plain version to hold a
  whole run against it (``chip_smoke.py`` does).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

__all__ = ["HEAD_DIMS", "FLASH_MASKS", "FLASH_TOL", "FLASH_LSE_TOL",
           "flash_errors", "kernel_head_dim", "padded_flash",
           "flash_attention", "flash_attention_backward", "FlashAttention",
           "flash_sdpa", "key_range"]

# the kernel's widths; a narrower head_dim runs zero-padded to one of them
HEAD_DIMS = (64, 128)
# the mask kinds the kernel is held to its plain version at: (causal,
# window, chunk)
FLASH_MASKS = {"causal": (True, None, None), "window": (True, 200, None),
               "chunk": (True, None, 96), "full": (False, None, None)}
# kernel against plain version (:func:`flash_errors`). f32 differs only in
# the order of its sums and in expf. bf16 also rounds p to bf16 against
# another running max (2**-9 of each weight), takes exp as ex2 of a fused
# multiply-add (a few ulp of p), and the plain version rounds each 512-key
# tile's PV product to bf16 before the sum; both round the output to bf16,
# so the two may lie two bf16 steps apart (2**-6 of a value at the bottom of
# its binade). Both take the same bf16 logits, so their lse differ only in
# sum order and exp's ulps. The limits are about two (bf16 out) to ten times
# what the kernel reads on an H100 (PERF.md); a kernel that drops one
# 128-key tile reads 0.600 and 0.192.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
FLASH_LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}
BACKWARD_BLOCK = 256
_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fa_forward": ([_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _F, _P], _I),
    "fa_error_string": ([_I], ctypes.c_char_p),
}


def key_range(q0: int, q1: int, T: int, causal: bool, window, chunk):
    """Keys ``[lo, hi)`` that any query in ``[q0, q1)`` can see."""
    lo, hi = 0, T
    if causal:
        hi = min(hi, q1)
    if window is not None:
        lo = max(lo, q0 - window + 1)
    if chunk is not None:
        lo = max(lo, (q0 // chunk) * chunk)
        hi = min(hi, ((q1 - 1) // chunk + 1) * chunk)
    return lo, hi


def flash_errors(out, lse, want, want_lse) -> tuple[float, float]:
    """How far the kernel's ``(out, lse)`` lie from the plain version's.

    ``out`` is held element by element: the first number is the largest
    ``|out - want| / (|want| + max |want| over the element's row)``, a row
    being one query's head_dim. A row's own maximum sets its scale, so a
    late causal row, whose values are small, is held as tightly as row 0.
    The second number is the largest ``|lse - want_lse|``, absolute.
    The kernel passes where they are within ``FLASH_TOL`` and
    ``FLASH_LSE_TOL`` of its dtype."""
    g, w = out.double(), want.double()
    if not g.numel():
        return 0.0, 0.0
    scale = w.abs() + w.abs().amax(-1, keepdim=True)
    share = ((g - w).abs() / scale.clamp_min(torch.finfo(torch.float64).tiny))
    return (float(share.max()),
            float((lse.double() - want_lse.double()).abs().max()))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window,
           chunk) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, dh) and k, v "
                         f"(B, T, KV, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, length or head_dim")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} "
                         "K/V heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FLOAT_CODE:
        raise TypeError(f"flash_attention takes one of {tuple(_FLOAT_CODE)} "
                        f"for q, k and v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device) or \
            q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k, v must lie on one cpu or cuda device, got "
                         f"{q.device}, {k.device}, {v.device}")
    for name, x in (("window", window), ("chunk", chunk)):
        if x is not None and x < 1:
            raise ValueError(f"{name} must be >= 1 or None, got {x}")


def kernel_head_dim(dh: int) -> int:
    """The kernel width that head_dim ``dh`` runs at: the least of
    ``HEAD_DIMS`` that holds it. Raises above the widest."""
    for width in HEAD_DIMS:
        if dh <= width:
            return width
    raise ValueError(f"the flash kernel takes head_dim up to {HEAD_DIMS[-1]},"
                     f" got {dh}")


def padded_flash(run, q, k, v, *, causal: bool = True,
                 window: int | None = None, chunk: int | None = None):
    """``run(q, k, v, scale=, causal=, window=, chunk=)`` at the kernel's
    width: q, k and v zero-padded on head_dim to :func:`kernel_head_dim`,
    the scale ``1/sqrt(dh)`` of the true head_dim, and ``out`` sliced back
    to it. The zero columns add nothing to a logit or to an output column,
    so ``out`` and ``lse`` are those of the unpadded call. ``run`` is the
    kernel's launch on the card; the CPU tests pass the plain version."""
    dh = q.shape[-1]
    width = kernel_head_dim(dh)
    if width != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, width - dh))
                   for x in (q, k, v))
    out, lse = run(q, k, v, scale=1.0 / math.sqrt(dh), causal=causal,
                   window=window, chunk=chunk)
    if width != dh:
        out = out[..., :dh].contiguous()
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk: int | None = None):
    """Self-attention over ``T`` positions: returns ``(out (B, T, H, dh)``
    in q's dtype, ``lse (B, H, T) f32)``."""
    _check(q, k, v, window, chunk)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous q, k and v")
    return padded_flash(_launch, q, k, v, causal=causal, window=window,
                        chunk=chunk)


def _launch(q, k, v, *, scale: float, causal: bool, window, chunk):
    """One launch of the kernel on contiguous CUDA q, k, v of a head_dim in
    ``HEAD_DIMS``."""
    B, T, H, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel():
        lib = _build.load("flash_attention", _SIGNATURES)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.fa_forward(_FLOAT_CODE[q.dtype], dh, q.data_ptr(),
                                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                lse.data_ptr(), B, T, H, k.shape[2],
                                int(causal), window or 0, chunk or 0,
                                scale, stream)
        if rc:
            raise RuntimeError(f"fa_forward launch failed: CUDA error {rc} "
                               f"({lib.fa_error_string(rc).decode()})")
        flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int | None = None,
                             chunk: int | None = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention`'s ``out`` from
    the saved forward and ``dout``, in plain PyTorch. ``D = rowsum(dO * O)``;
    per block of query rows, over the keys the mask lets it see:
    ``P = exp(S * scale - lse)``, ``dV += P^T dO``, ``dS = P * (dO V^T -
    D)``, ``dQ = dS K * scale``, ``dK += dS^T Q * scale``; grouped heads are
    summed per K/V head. Products run in the input dtype (f32 accumulate,
    as the reference's derivative takes them); elementwise work and the
    dK/dV accumulators are f32. Query blocks are ``BACKWARD_BLOCK`` rows,
    which bounds the f32 score blocks' memory."""
    B, T, H, dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    dt = q.dtype
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32
    # (B, KV, rep, T, dh) views of the query-side tensors, (B, KV, T, dh) K/V
    qh = q.view(B, T, KV, rep, dh).permute(0, 2, 3, 1, 4)
    doh = dout.view(B, T, KV, rep, dh).permute(0, 2, 3, 1, 4)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    lse = lse.view(B, KV, rep, T)
    D = (dout.to(f32) * out.to(f32)).sum(-1)            # (B, T, H)
    D = D.view(B, T, KV, rep).permute(0, 2, 3, 1)
    dq = torch.empty((B, KV, rep, T, dh), dtype=dt, device=q.device)
    dk = torch.zeros((B, KV, T, dh), dtype=f32, device=q.device)
    dv = torch.zeros((B, KV, T, dh), dtype=f32, device=q.device)
    for i0 in range(0, T, BACKWARD_BLOCK):
        i1 = min(i0 + BACKWARD_BLOCK, T)
        n = i1 - i0
        lo, hi = key_range(i0, i1, T, causal, window, chunk)
        qb = qh[:, :, :, i0:i1].reshape(B, KV, rep * n, dh)
        dob = doh[:, :, :, i0:i1].reshape(B, KV, rep * n, dh)
        kk, vv = kh[:, :, lo:hi], vh[:, :, lo:hi]
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        msk = torch.ones((n, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            msk &= kpos <= qpos
        if window is not None:
            msk &= kpos > qpos - window
        if chunk is not None:
            msk &= (kpos // chunk) == (qpos // chunk)
        s = torch.matmul(qb, kk.transpose(-1, -2)).to(f32) * scale
        s = s.view(B, KV, rep, n, hi - lo).masked_fill_(~msk, -math.inf)
        p = torch.exp_(s.sub_(lse[:, :, :, i0:i1, None]))
        p = p.view(B, KV, rep * n, hi - lo)
        del s
        dv[:, :, lo:hi] += torch.matmul(p.to(dt).transpose(-1, -2),
                                        dob).to(f32)
        dp = torch.matmul(dob, vv.transpose(-1, -2)).to(f32)
        ds = p.mul_(dp.sub_(D[:, :, :, i0:i1].reshape(B, KV, rep * n, 1)))
        del dp
        ds = ds.to(dt)
        dq[:, :, :, i0:i1] = (torch.matmul(ds, kk).to(f32) * scale).view(
            B, KV, rep, n, dh).to(dt)
        dk[:, :, lo:hi] += torch.matmul(ds.transpose(-1, -2), qb).to(f32) \
            * scale
        del ds, p
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, dh)
    return (dq, dk.permute(0, 2, 1, 3).to(dt).contiguous(),
            dv.permute(0, 2, 1, 3).to(dt).contiguous())


class FlashAttention(torch.autograd.Function):
    """``out = flash_attention(q, k, v)[0]``, differentiable in q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk = ctx.masks
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, chunk=chunk)
        return dq, dk, dv, None, None, None


def flash_sdpa(q, k, v, *, causal: bool = True, window: int | None = None,
               chunk: int | None = None) -> torch.Tensor:
    """Differentiable flash attention: ``(B, T, H, dh)`` in q's dtype."""
    return FlashAttention.apply(q, k, v, causal, window, chunk)
