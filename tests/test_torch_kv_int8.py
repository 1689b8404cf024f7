"""The port's int8 K/V-cache kernels against the reference, on the CPU.

On the CPU ``quantize_int8`` / ``dequantize_int8`` run their plain versions,
which are held here bit for bit (codes and scales) against:

* the Pallas kernels (``repro.kernels.quantize``, interpret mode) at their
  fixed width of 128;
* the model's own ``quantize_kv_rows`` and ``_cache_read`` arithmetic at the
  K/V caches' widths, 64 (MiniCPM-2B's head_dim) and 12 (its reduced
  config's), as the reference's jitted decode step computes them;
* the decode step's fused K/V cache write (``ops.kv_quantize_write``, whose
  plain version runs here) against the reference's jitted ``_cache_write``
  applied to K and to V, rings, scales and untouched slots included.

Under ``jit`` XLA folds the reference's ``/ 127.0`` into a product with
f32(1/127), and so does the Pallas kernel; an eager ``jnp`` call divides.
The port computes the compiled form, which is what the reference's K/V cache
holds. Inputs come from numpy with a seed and include zero rows, exact .5
ties of ``x / scale``, codes at +-127 and rows below the 1e-8 floor. The
CUDA kernels are held against the same plain versions on the card in
``tests/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as ref_quantize
from repro.models import layers as ref_layers
from repro_torch.kernels import ops, quantize, ref

WIDTHS = [12, 64, 128]


def _rows(rng, rows, width):
    """f32 rows at scales from 1e-3 to 1e3, then adversarial rows: zeros;
    absmax 127 (scale exactly 1.0) with exact .5 ties of both signs; a row
    of +-absmax (codes +-127); a row under the 1e-8 floor."""
    x = (rng.standard_normal((rows, width))
         * 10.0 ** rng.uniform(-3, 3, (rows, 1))).astype(np.float32)
    ties = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                               126.5, -126.5, 3.5, -3.5, 64.5],
                              np.float32), width)
    ext = np.resize(np.array([-3.0, 3.0, 1.0, -1.0], np.float32), width)
    tiny = np.resize(np.array([4e-9, -2e-9, 1e-12, 0.0], np.float32), width)
    return np.concatenate([x, np.zeros((1, width), np.float32), ties[None],
                           ext[None], tiny[None]])


def _pair(x32: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor (bf16 rounded once,
    by JAX, and carried over bit for bit)."""
    j = jnp.asarray(x32)
    if dt == "bf16":
        j = j.astype(jnp.bfloat16)
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy())
        return j, t.view(torch.bfloat16)
    return j, torch.from_numpy(x32.copy())


def _eq(got: torch.Tensor, want, what: str):
    g = got.contiguous()
    g = (g.view(torch.int16) if g.dtype == torch.bfloat16 else g).numpy()
    w = np.asarray(want)
    w = w.view(np.int16) if w.dtype.name == "bfloat16" else w
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.count_nonzero(g.view(np.uint8) != w.view(np.uint8))
    assert bad == 0, f"{what}: {bad} bytes differ"


def test_inverse_127_is_the_f32_reciprocal():
    assert ref.INV127 == float(np.float32(1) / np.float32(127))
    assert np.float32(ref.INV127).view(np.uint32) == 0x3c010204


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_matches_pallas_at_128(dt):
    x32 = _rows(np.random.default_rng(11), 600, 128)
    j, t = _pair(x32, dt)
    before = quantize.quantize_int8.launches
    q, s = quantize.quantize_int8(t)
    assert quantize.quantize_int8.launches == before   # CPU: plain version
    qj, sj = ref_quantize.quantize_int8(j, interpret=True)
    _eq(q, qj, "codes")
    _eq(s, sj, "scales")
    # the adversarial rows do what they are for
    qn = q.numpy()
    assert (qn[-4] == 0).all()
    assert list(qn[-3, :12]) == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, -4,
                                 64]
    assert set(np.unique(qn[-2])) == {-127, 127, 42, -42}
    for out_dt, tdt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
        _eq(quantize.dequantize_int8(q, s, tdt),
            ref_quantize.dequantize_int8(qj, sj, out_dt, interpret=True),
            f"dequantize to {tdt}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_kv_rows_match_the_models_quantize_and_read(width, dt):
    """The model's arithmetic as the jitted decode step runs it, on a
    (B, T, KV, dh) block of K/V rows."""
    x32 = _rows(np.random.default_rng(width), 300, width).reshape(-1, 2, 2,
                                                                 width)
    j, t = _pair(x32, dt)
    q, s = ops.kv_quantize(t)
    qj, sj = jax.jit(ref_layers.quantize_kv_rows)(j)
    assert q.shape == x32.shape and s.shape == x32.shape[:-1] + (1,)
    _eq(q, qj, "codes")
    _eq(s, sj, "scales")
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(ref_layers._cache_read, static_argnums=2)(qj, sj, jdt)
        _eq(ops.kv_dequantize(q, s, tdt), want, f"cache read to {tdt}")


def test_eager_jnp_divides_and_the_port_follows_the_compiled_form():
    """Documents the one place eager and compiled reference disagree: the
    scale of a row whose absmax / 127 and absmax * f32(1/127) round apart."""
    am = np.float32(9.0)     # 9 / 127 and 9 * f32(1/127) round apart in f32
    x = np.full((1, 64), am, np.float32)
    eager = np.asarray(ref_layers.quantize_kv_rows(jnp.asarray(x))[1])
    compiled = np.asarray(jax.jit(ref_layers.quantize_kv_rows)(
        jnp.asarray(x))[1])
    assert eager[0, 0] == am / np.float32(127)
    assert compiled[0, 0] == am * np.float32(ref.INV127)
    assert eager[0, 0] != compiled[0, 0]
    _eq(quantize.quantize_int8(torch.from_numpy(x))[1], compiled, "scale")


def test_nan_rows_propagate_to_the_scale():
    """absmax is a NaN-propagating max (``fmaxf`` would drop the NaN)."""
    x = np.ones((2, 64), np.float32)
    x[1, 5] = np.nan
    _, s = quantize.quantize_int8(torch.from_numpy(x))
    assert np.isfinite(s[0, 0].item()) and np.isnan(s[1, 0].item())


def test_wrappers_reject_what_the_int8_kernels_do_not_take():
    with pytest.raises(ValueError, match="at most 256"):
        quantize.quantize_int8(torch.zeros(4, 257))
    with pytest.raises(ValueError):
        quantize.quantize_int8(torch.zeros(64, 4).t())
    with pytest.raises(ValueError):
        quantize.quantize_int8(torch.zeros(4, 8, 2))
    with pytest.raises(TypeError):
        quantize.quantize_int8(torch.zeros(4, 8, dtype=torch.float64))
    q = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        quantize.dequantize_int8(q, torch.zeros(3, 1))
    with pytest.raises(TypeError):
        quantize.dequantize_int8(q.float(), torch.zeros(4, 1))
    with pytest.raises(TypeError):
        quantize.dequantize_int8(q, torch.zeros(4, 1), torch.float64)
    # an empty block is fine and launches nothing
    q0, s0 = quantize.quantize_int8(torch.zeros(0, 64))
    assert q0.shape == (0, 64) and s0.shape == (0, 1)


def _rings(rng, B, S, KV, W):
    """int8 rings and f32 scales already holding earlier tokens."""
    q = rng.integers(-127, 128, size=(B, S, KV, W)).astype(np.int8)
    sc = rng.uniform(1e-3, 1.0, size=(B, S, KV, 1)).astype(np.float32)
    return q, sc


@pytest.mark.parametrize("slot", ["first", "last"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [12, 64])
def test_fused_write_matches_the_references_cache_write(width, dt, slot):
    """One decode step's K and V rows, (B, 1, KV, W), into int8 rings of S
    slots at slot 0 or S - 1, against ``jax.jit(_cache_write)`` on K and on
    V; every other slot keeps its bytes."""
    B, S, KV = 3, 7, 4
    rng = np.random.default_rng(width + (dt == "bf16"))
    at = 0 if slot == "first" else S - 1
    x32 = _rows(rng, 2 * B * KV - 4, width)
    kj, kt = _pair(x32[: B * KV].reshape(B, 1, KV, width), dt)
    vj, vt = _pair(x32[B * KV:].reshape(B, 1, KV, width), dt)
    rings = [_rings(rng, B, S, KV, width) for _ in range(2)]
    tk, tv = (torch.from_numpy(q.copy()) for q, _ in rings)
    tks, tvs = (torch.from_numpy(sc.copy()) for _, sc in rings)
    ops.kv_quantize_write(kt, vt, tk, tv, tks, tvs, [at] * B, [1] * B)
    write = jax.jit(ref_layers._cache_write)
    for (q0, s0), val, got_q, got_s, what in (
            (rings[0], kj, tk, tks, "K"), (rings[1], vj, tv, tvs, "V")):
        want_q, want_s = write(jnp.asarray(q0), jnp.asarray(s0), val, at)
        _eq(got_q, want_q, f"{what} ring")
        _eq(got_s, want_s, f"{what} scales")
        keep = np.arange(S) != at
        assert np.array_equal(got_q.numpy()[:, keep], q0[:, keep])
        assert np.array_equal(got_s.numpy()[:, keep], s0[:, keep])


def test_fused_write_refuses_what_the_kernel_does_not_take():
    k = torch.zeros(2, 1, 3, 8)
    ring = torch.zeros(2, 5, 3, 8, dtype=torch.int8)
    scale = torch.zeros(2, 5, 3, 1)
    before = quantize.quantize_int8_into.launches
    for pos, n in (([0, -1], [1, 1]),          # a negative position
                   ([0, 0], [1, 2]),           # more tokens than the step
                   ([0, 0], [-1, 1])):
        with pytest.raises(ValueError, match="positions must be"):
            ops.kv_quantize_write(k, k, ring, ring.clone(), scale,
                                  scale.clone(), pos, n)
    with pytest.raises(ValueError, match="takes 2 positions"):
        ops.kv_quantize_write(k, k, ring, ring.clone(), scale,
                              scale.clone(), [0], [1])
    with pytest.raises(ValueError, match="positions must be"):  # T > S
        ops.kv_quantize_write(torch.zeros(2, 6, 3, 8), torch.zeros(2, 6, 3, 8),
                              ring, ring.clone(), scale, scale.clone(),
                              [0, 0], [6, 6])
    wide = torch.zeros(2, 1, 3, 257)
    wring = torch.zeros(2, 5, 3, 257, dtype=torch.int8)
    one = ([0, 0], [1, 1])
    with pytest.raises(ValueError, match="at most 256"):
        ops.kv_quantize_write(wide, wide, wring, wring.clone(), scale,
                              scale.clone(), *one)
    with pytest.raises(ValueError, match="one"):      # K and V differ
        ops.kv_quantize_write(k, k.to(torch.bfloat16), ring, ring.clone(),
                              scale, scale.clone(), *one)
    with pytest.raises(TypeError):
        ops.kv_quantize_write(k.double(), k.double(), ring, ring.clone(),
                              scale, scale.clone(), *one)
    with pytest.raises(ValueError, match="v_ring"):    # a bf16 ring
        ops.kv_quantize_write(k, k, ring, ring.to(torch.bfloat16), scale,
                              scale.clone(), *one)
    with pytest.raises(ValueError, match="k_scale"):
        ops.kv_quantize_write(k, k, ring, ring.clone(), scale[:, :4],
                              scale.clone(), *one)
    # the last slot, and a position past it that wraps to slot 0; the CPU
    # runs the plain version and counts nothing
    ops.kv_quantize_write(k + 1, k - 1, ring, ring.clone(), scale,
                          scale.clone(), [4, 5], [1, 1])
    assert (ring[0, 4] == 127).all() and (ring[0, :4] == 0).all()
    assert (ring[1, 0] == 127).all() and (ring[1, 1:] == 0).all()
    assert quantize.quantize_int8_into.launches == before
