"""The port's flash attention on the CPU against the JAX reference.

On the CPU, :func:`repro_torch.kernels.flash_attention.flash_attention`
runs its plain version (the port of ``layers._flash_sdpa``); the CUDA
kernel is held against that plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``). The reference's
Pallas kernel cannot run here (``pl.load`` is gone from jax 0.9), so the
oracles are the jitted ``_flash_sdpa`` and the direct ``_sdpa`` +
``_attn_mask``. Inputs are made by numpy from a seed and handed to both.

Tolerances, as a share of the reference's largest |value|:

* f32: ``1e-5``. Both sides compute in f32 and differ in the order of
  their sums.
* bf16 against ``_flash_sdpa``: ``2**-8``. The port rounds at the same
  points with the same tiles; an f32 sum taken in another order can land
  on the other side of a bf16 rounding, one bf16 ulp of the output.
* bf16 against ``_sdpa`` and bf16 gradients: ``6 * 2**-8``. The direct
  form rounds its softmax weights once over all keys instead of per tile,
  and the gradients pass through the bf16 products of the backward, which
  the two frameworks round at different points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import layers

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
TOL_LOOSE = {"f32": 1e-5, "bf16": 6 * 2.0 ** -8}
# (B, T, H, KV, dh, causal, window, chunk): GQA and MHA, every mask kind,
# T above the threshold and not a multiple of the 512-row tile. With the
# window (300) and the chunks (520) the first key tile is fully masked for
# the later rows of a query tile.
CASES = {
    "causal-gqa2": (2, 1100, 4, 2, 16, True, None, None),
    "full-mha": (1, 1030, 4, 4, 12, False, None, None),
    "window-gqa4": (1, 1300, 4, 1, 16, True, 300, None),
    "chunk-gqa2": (1, 1300, 2, 1, 16, True, None, 520),
    "window-nocausal": (1, 1025, 2, 2, 8, False, 200, None),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _err(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _inputs(case, dt, seed=0):
    B, T, H, KV, dh, causal, window, chunk = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, T, n, dh)).astype(np.float32)
            for n in (H, KV, KV)]
    jdt, tdt = DTYPES[dt]
    return (arrs, [jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs],
            dict(causal=causal, window=window, chunk=chunk), (H, KV))


def _ref_flash(masks, heads):
    return jax.jit(lambda q, k, v: ref_layers._flash_sdpa(
        q, k, v, heads[0], heads[1], **masks))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_flash_sdpa_and_sdpa(case, dt):
    _, jin, tin, masks, heads = _inputs(case, dt)
    B, T, H, dh = tin[0].shape
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention(*tin, **masks)
    assert fa.flash_attention.launches == before     # plain on the CPU
    assert out.dtype == tin[0].dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, T)
    want = _ref_flash(masks, heads)(*jin)
    assert _err(out.reshape(B, T, H * dh), want) <= TOL[dt]
    mask = ref_layers._attn_mask(T, T, masks["causal"], masks["window"],
                                 masks["chunk"])
    direct = jax.jit(lambda q, k, v: ref_layers._sdpa(q, k, v, mask,
                                                      *heads))(*jin)
    assert _err(out.reshape(B, T, H * dh), direct) <= TOL_LOOSE[dt]


@pytest.mark.parametrize("case", list(CASES))
def test_lse_is_the_rows_logsumexp(case):
    """``lse`` is log sum exp of each row's scaled, masked f32 logits."""
    arrs, _, tin, masks, heads = _inputs(case, "f32")
    _, lse = fa.flash_attention(*tin, **masks)
    q, k = (a.astype(np.float64) for a in arrs[:2])
    B, T, H, dh = q.shape
    rep = heads[0] // heads[1]
    k = np.repeat(k, rep, axis=2)
    s = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(dh)
    mask = np.asarray(ref_layers._attn_mask(T, T, masks["causal"],
                                            masks["window"], masks["chunk"]))
    s = np.where(mask, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    assert np.abs(lse.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_function_gradients_match_jax_grad(case, dt):
    arrs, jin, tin, masks, heads = _inputs(case, dt, seed=1)
    B, T, H, dh = arrs[0].shape
    dout = np.random.default_rng(2).standard_normal(
        (B, T, H * dh)).astype(np.float32)
    f = _ref_flash(masks, heads)
    jg = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32) * dout),
        argnums=(0, 1, 2)))(*jin)
    leaves = [t.requires_grad_(True) for t in tin]
    out = fa.flash_sdpa(*leaves, **masks)
    out.backward(torch.from_numpy(dout).to(out.dtype).reshape(out.shape))
    for name, t, g in zip("qkv", leaves, jg):
        assert t.grad.dtype == t.dtype
        assert _err(t.grad, g) <= TOL_LOOSE[dt], name


def test_backward_blocks_do_not_change_the_gradients(monkeypatch):
    """The query-block size of the plain backward bounds its memory only."""
    _, _, tin, masks, _ = _inputs("window-gqa4", "f32")
    out, lse = fa.flash_attention(*tin, **masks)
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal(
        tuple(out.shape)).astype(np.float32))
    a = fa.flash_attention_backward(*tin, out, lse, dout, **masks)
    monkeypatch.setattr(fa, "BACKWARD_BLOCK", 97)
    b = fa.flash_attention_backward(*tin, out, lse, dout, **masks)
    for x, y in zip(a, b):
        assert _err(x, y) <= 1e-6


@pytest.mark.parametrize("q0,q1,T,causal,window,chunk,want", [
    (0, 64, 100, True, None, None, (0, 64)),
    (64, 128, 100, True, None, None, (0, 100)),
    (640, 704, 4096, True, 200, None, (441, 704)),
    (64, 128, 4096, True, None, 96, (0, 128)),
    (192, 256, 4096, False, None, 96, (192, 288)),
    (0, 64, 4096, False, None, None, (0, 4096)),
])
def test_key_range(q0, q1, T, causal, window, chunk, want):
    assert fa.key_range(q0, q1, T, causal, window, chunk) == want


def test_attention_above_the_threshold_takes_the_flash_path(monkeypatch):
    """``layers.attention`` at T > FLASH_THRESHOLD calls the wrapper (so on
    a CUDA tensor the kernel runs), at T <= FLASH_THRESHOLD it does not."""
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    acfg = layers.AttnConfig(d_model=16, n_heads=2, n_kv_heads=1,
                             head_dim=8)
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) / 4)
         for k, s in (("wq", (16, 16)), ("wk", (16, 8)), ("wv", (16, 8)),
                      ("wo", (16, 16)))}
    for T, n in ((layers.FLASH_THRESHOLD, 0), (layers.FLASH_THRESHOLD + 1, 1)):
        x = torch.from_numpy(rng.standard_normal((1, T, 16)).astype(
            np.float32))
        pos = torch.arange(T)[None]
        out = layers.attention(p, acfg, x, pos)
        assert out.shape == (1, T, 16) and len(calls) == n


# (B, T, H, KV, dh, causal, window, chunk): head_dims the kernel lacks, each
# run zero-padded to its kernel width (64 or 128) as the wrapper runs it on
# the card, every mask kind, T ragged
PADDED = {
    "causal-gqa2-dh12": (1, 1100, 4, 2, 12, True, None, None),
    "window-mha-dh16": (1, 1030, 2, 2, 16, True, 300, None),
    "chunk-gqa2-dh16": (1, 1300, 2, 1, 16, True, None, 520),
    "full-mha-dh12": (1, 1025, 2, 2, 12, False, None, None),
    "causal-mha-dh40": (1, 1088, 2, 2, 40, True, None, None),
    "causal-gqa2-dh96": (1, 1030, 4, 2, 96, True, None, None),
}


def _padded_inputs(case, dt, seed=4):
    B, T, H, KV, dh, causal, window, chunk = PADDED[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, T, n, dh)).astype(np.float32)
            for n in (H, KV, KV)]
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs],
            dict(causal=causal, window=window, chunk=chunk), (H, KV))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(PADDED))
def test_padded_head_dim_matches_the_true_width(case, dt):
    """The card's route for a head_dim other than 64 or 128: q, k, v
    zero-padded to the kernel width, the scale of the true head_dim, out
    sliced back. Run here with the plain version in the kernel's place, it
    matches the plain version at the true width (f32 within 1e-5, bf16
    within one bf16 step: the padded products sum the same terms with
    zeros between them) and the reference's ``_flash_sdpa``."""
    jin, tin, masks, heads = _padded_inputs(case, dt)
    B, T, H, dh = tin[0].shape
    width = fa.kernel_head_dim(dh)
    assert width in fa.HEAD_DIMS and width >= dh and width - dh < 64
    seen = []

    def plain(q, k, v, **kw):
        seen.append((q.shape[-1], kw["scale"]))
        return ref.flash_attention_ref(q, k, v, **kw)

    out, lse = fa.padded_flash(plain, *tin, **masks)
    assert seen == [(width, 1.0 / np.sqrt(dh))]
    assert out.shape == tin[0].shape and out.is_contiguous()
    want, want_lse = ref.flash_attention_ref(*tin, **masks)
    assert _err(out, want) <= TOL[dt]
    assert np.abs(_np(lse) - _np(want_lse)).max() <= 1e-5 * \
        np.abs(_np(want_lse)).max()
    ref_out = _ref_flash(masks, heads)(*jin)
    assert _err(out.reshape(B, T, H * dh), ref_out) <= TOL[dt]


def test_kernel_head_dim():
    assert [fa.kernel_head_dim(d) for d in (1, 12, 16, 63, 64, 65, 96, 128)] \
        == [64, 64, 64, 64, 64, 128, 128, 128]
    for dh in (129, 192, 256):
        with pytest.raises(ValueError, match="head_dim up to 128"):
            fa.kernel_head_dim(dh)


def test_wrapper_refuses_bad_inputs():
    q = torch.zeros((1, 8, 3, 4))
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q, torch.zeros((1, 8, 2, 4)),
                           torch.zeros((1, 8, 2, 4)))
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)
    out, lse = ref.flash_attention_ref(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 3, 8)


def _attention_f64(q, k, v, keep):
    """Exact attention in float64 under the boolean mask ``keep (T, T)``:
    ``(out (T, dh), lse (T,))`` for one head."""
    s = (q @ k.T) / np.sqrt(q.shape[-1])
    s = s.masked_fill(~keep, -torch.inf)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[:, None]) @ v, lse


@pytest.mark.parametrize("rows", [(2112, 2176), (4032, 4096)])
def test_flash_errors_catch_a_dropped_key_tile(rows):
    """The kernel-vs-plain limits admit a rounding of each output to bf16
    and reject an output that left out one 64-key tile (keys 2048 to 2111)
    for one 64-row query block, at the training path's length: the rows
    just past the tile and the last rows, whose values are smallest."""
    T, dh = 4096, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((T, dh))) for _ in
               range(3))
    causal = torch.ones((T, T), dtype=torch.bool).tril()
    want, want_lse = _attention_f64(q, k, v, causal)
    dropped = causal.clone()
    dropped[rows[0]:rows[1], 2048:2112] = False
    bad, bad_lse = _attention_f64(q, k, v, dropped)
    tol, lse_tol = fa.FLASH_TOL[torch.bfloat16], \
        fa.FLASH_LSE_TOL[torch.bfloat16]
    share, lse_err = fa.flash_errors(want.to(torch.bfloat16), want_lse,
                                     want, want_lse)
    assert share <= tol and lse_err == 0.0
    share, lse_err = fa.flash_errors(bad, bad_lse, want, want_lse)
    assert share > 4 * tol and lse_err > 4 * lse_tol
