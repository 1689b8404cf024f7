"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Bitwise, NaN bits included: each kernel and its plain version run on the
same device on the same inputs (made by numpy from a seed). The flash
attention kernel is held within a tolerance instead
(``flash_attention.flash_errors``): its products accumulate in another
order and its 128-key tiles (bf16; 64 in f32) round ``p`` to bf16 against
another running max than the plain version's 512-key tiles. The seeded
weights are held between the card and the CPU. The file imports
no JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Without a card every test skips (a CUDA kernel has no CPU mode).
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_combine, flash_attention, quantize, ref

pytestmark = pytest.mark.gpu

OPS = ["add", "max", "min", "mul"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
SIZES = [1, 1000, (1 << 20) + 3]
# bf16 bit patterns at the head of every max/min operand: +0, -0, quiet and
# signalling NaNs of both signs, +inf, -inf, 1. Each NaN's payload names its
# operand (add 0, 1 or 2). f32 operands take them in their top 16 bits.
SPECIALS = np.array([0x0000, 0x8000, 0x7fc1, 0xffc1, 0x7f81, 0xff81, 0x7f80,
                     0xff80, 0x3f80], np.uint32)
NAN_SLOTS = [2, 3, 4, 5]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operand(rng, n, dt, op, device, which):
    """Operand ``which`` (0, 1, 2) of a combine. For max and min its first
    9**3 elements run through every triple of ``SPECIALS`` across the three
    operands."""
    if dt == "i32":
        v = torch.from_numpy(rng.integers(-1000, 1001, size=n).astype(np.int32))
    else:
        x = rng.standard_normal(n).astype(np.float32)
        # both signs of infinity for max/min; +inf only for add/mul
        for inf in ((np.inf, -np.inf) if op in ("max", "min") else (np.inf,)):
            x[rng.random(n) < 0.02] = inf
        v = torch.from_numpy(x).to(DTYPES[dt])
        if op in ("max", "min"):
            words = SPECIALS.copy()
            words[NAN_SLOTS] += which
            k = min(n, len(words) ** 3)
            words = words[(np.arange(k) // len(words) ** which) % len(words)]
            if dt == "f32":
                v.view(torch.int32)[:k] = torch.from_numpy(
                    (words << 16).view(np.int32))
            else:
                v.view(torch.int16)[:k] = torch.from_numpy(
                    words.astype(np.uint16).view(np.int16))
    return v.to(device)


def _assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = {1: torch.int8, 2: torch.int16,
            4: torch.int32}[got.element_size()]
    assert torch.equal(got.contiguous().view(ints), want.contiguous().view(ints))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_combine_kernels_match_plain(op, dt, n, cuda):
    rng = np.random.default_rng(n + 7)
    a, b, c = (_operand(rng, n, dt, op, cuda, i) for i in range(3))
    before = (block_combine.combine2.launches,
              block_combine.combine3.launches)
    got3 = block_combine.combine3(a, b, c, op=op)
    got2 = block_combine.combine2(a, b, op=op)
    torch.cuda.synchronize()
    assert (block_combine.combine2.launches,
            block_combine.combine3.launches) == (before[0] + 1, before[1] + 1)
    _assert_bitwise(got3, ref.combine3_ref(a, b, c, op=op))
    _assert_bitwise(got2, ref.combine2_ref(a, b, op=op))
    # views one element in are not 16-byte aligned: the scalar path
    _assert_bitwise(block_combine.combine3(a[1:], b[1:], c[1:], op=op),
                    ref.combine3_ref(a[1:], b[1:], c[1:], op=op))
    _assert_bitwise(block_combine.combine2(a[1:], b[1:], op=op),
                    ref.combine2_ref(a[1:], b[1:], op=op))


def test_combine_wrappers_take_no_lock_and_no_device_context(cuda,
                                                             monkeypatch):
    """After the first call the wrappers neither take the build lock nor
    enter a device context for operands on the current card: a call made
    while another thread holds the lock, with ``torch.cuda.device``
    replaced by a function that raises, still launches."""
    import threading

    from repro_torch.kernels import _build
    rng = np.random.default_rng(5)
    a, b, c = (_operand(rng, 4099, "f32", "add", cuda, i) for i in range(3))
    block_combine.combine2(a, b)            # loads the library

    def refuse(*args, **kwargs):
        raise AssertionError("entered a device context")

    monkeypatch.setattr(torch.cuda, "device", refuse)
    got = {}
    worker = threading.Thread(target=lambda: got.update(
        two=block_combine.combine2(a, b),
        three=block_combine.combine3(a, b, c)))
    with _build._LOCK:
        worker.start()
        worker.join(timeout=60)
        alive = worker.is_alive()
    worker.join(timeout=60)
    monkeypatch.undo()                      # synchronize enters a context
    assert not alive, "a wrapper waited for the build lock"
    assert set(got) == {"two", "three"}
    torch.cuda.synchronize()
    _assert_bitwise(got["two"], ref.combine2_ref(a, b))
    _assert_bitwise(got["three"], ref.combine3_ref(a, b, c))


def test_combine_on_another_card_launches_there(cuda):
    """Operands on a card other than the current one: the wrapper switches
    to that card for the launch, on its current stream, and back."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", (torch.cuda.current_device() + 1)
                         % torch.cuda.device_count())
    rng = np.random.default_rng(6)
    a, b, c = (_operand(rng, (1 << 20) + 3, "bf16", "max", other, i)
               for i in range(3))
    before = torch.cuda.current_device()
    side = torch.cuda.Stream(device=other)
    side.wait_stream(torch.cuda.current_stream(other))
    with torch.cuda.device(other), torch.cuda.stream(side):
        want3 = ref.combine3_ref(a, b, c, op="max")
        want2 = ref.combine2_ref(a, b, op="max")
    side.synchronize()
    got3 = block_combine.combine3(a, b, c, op="max")
    got2 = block_combine.combine2(a, b, op="max")
    assert torch.cuda.current_device() == before
    assert got3.device == got2.device == other
    torch.cuda.synchronize(other)
    _assert_bitwise(got3, want3)
    _assert_bitwise(got2, want2)


def _cast_inputs(rng, n):
    special = np.array([0x7f800000, 0xff800000, 0x7fc00000, 0xffc00000,
                        0x7f800001, 0x00000001, 0x80000001, 0x007fffff,
                        0x00008000, 0x00018000, 0x3f808000, 0x3f818000,
                        0x3f808001, 0x00000000, 0x80000000, 0x7f7fffff],
                       np.uint32)   # inf, NaN, subnormals, ties, zeros, max
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(np.concatenate([special, bits]).view(np.float32))


@pytest.mark.parametrize("n", SIZES)
def test_cast_kernels_match_plain(n, cuda):
    x = _cast_inputs(np.random.default_rng(n), n).to(cuda)
    h = quantize.compress_bf16(x)
    _assert_bitwise(h, ref.compress_bf16_ref(x))
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    every = every.view(torch.bfloat16).to(cuda)   # all 65536 bf16 patterns
    for src in (h, every):
        _assert_bitwise(quantize.decompress_bf16(src),
                        ref.decompress_bf16_ref(src))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 7, 4097, (1 << 20) + 5])
def test_compress_bf16_ragged_and_misaligned(n, offset, cuda):
    """The streaming cast at ragged lengths and at views 1 to 3 elements
    past a 16-byte boundary (the one-element-per-thread path), special
    values at the head: bit for bit ``.to(torch.bfloat16)``."""
    x = _cast_inputs(np.random.default_rng(n + offset), n + offset).to(cuda)
    x = x[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = quantize.compress_bf16.launches
    h = quantize.compress_bf16(x)
    torch.cuda.synchronize()
    assert quantize.compress_bf16.launches == before + 1
    _assert_bitwise(h, x.to(torch.bfloat16))


def _int8_rows(rng, rows, width):
    """f32 rows at scales 1e-3..1e3, then zeros, exact .5 ties of x/scale
    (absmax 127, so the scale is 1.0), +-absmax (codes +-127) and a row
    under the 1e-8 floor."""
    x = (rng.standard_normal((rows, width))
         * 10.0 ** rng.uniform(-3, 3, (rows, 1))).astype(np.float32)
    ties = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                               -126.5, 3.5, -3.5, 64.5], np.float32), width)
    ext = np.resize(np.array([-3.0, 3.0, 1.0, -1.0], np.float32), width)
    tiny = np.resize(np.array([4e-9, -2e-9, 1e-12, 0.0], np.float32), width)
    return torch.from_numpy(np.concatenate(
        [x, np.zeros((1, width), np.float32), ties[None], ext[None],
         tiny[None]]))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [12, 64, 128, 256])
def test_int8_kernels_match_plain(width, dt, cuda):
    x = _int8_rows(np.random.default_rng(width), 5000, width)
    x = x.to(DTYPES[dt]).to(cuda)
    before = (quantize.quantize_int8.launches,
              quantize.dequantize_int8.launches)
    q, s = quantize.quantize_int8(x)
    qr, sr = ref.quantize_int8_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, qr)
    _assert_bitwise(s, sr)
    for out in (torch.float32, torch.bfloat16):
        _assert_bitwise(quantize.dequantize_int8(q, s, out),
                        ref.dequantize_int8_ref(q, s, out))
    assert (quantize.quantize_int8.launches,
            quantize.dequantize_int8.launches) == (before[0] + 1,
                                                   before[1] + 2)
    # codes one byte into a buffer: not 16-byte aligned, the scalar path
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
    qu = buf[1:].view(q.shape)
    qu.copy_(q)
    _assert_bitwise(quantize.dequantize_int8(qu, s, torch.bfloat16),
                    ref.dequantize_int8_ref(q, s, torch.bfloat16))


def test_int8_nan_rows_match_plain(cuda):
    """A NaN in a row makes its scale NaN in both versions (a NaN-propagating
    absmax); the other rows' codes and scales stay bitwise equal."""
    x = _int8_rows(np.random.default_rng(3), 64, 64).to(cuda)
    x[5, 7] = float("nan")
    q, s = quantize.quantize_int8(x)
    qr, sr = ref.quantize_int8_ref(x)
    assert torch.isnan(s[5]).all() and torch.isnan(sr[5]).all()
    ok = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    ok[5] = False
    assert torch.equal(q[ok], qr[ok])
    _assert_bitwise(s[ok], sr[ok])


def _kv_step(rng, B, KV, W, S, dt, device):
    """One decode step's K and V rows, (B, 1, KV, W), and int8 rings of S
    slots (with scales) that already hold earlier tokens."""
    x = _int8_rows(rng, 2 * B * KV - 4, W).to(DTYPES[dt])
    k, v = (t.reshape(B, 1, KV, W).to(device) for t in x.split(B * KV))
    rings = [torch.from_numpy(rng.integers(-127, 128, (B, S, KV, W)).astype(
        np.int8)).to(device) for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(1e-3, 1, (B, S, KV, 1)).astype(
        np.float32)).to(device) for _ in range(2)]
    return k, v, rings, scales


@pytest.mark.parametrize("slot", ["first", "middle", "last"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [12, 16, 64, 128, 256])
def test_fused_kv_write_matches_plain(width, dt, slot, cuda):
    """The fused K/V write against its plain version (quantize, then the
    slice assignments), bit for bit on both rings and both scale arrays:
    the new slot holds the codes and scales, every other slot its old
    bytes, and the call is one launch."""
    B, KV, S = 3, 5, 9
    at = {"first": 0, "middle": S // 2, "last": S - 1}[slot]
    k, v, rings, scales = _kv_step(np.random.default_rng(width), B, KV,
                                   width, S, dt, cuda)
    got = [t.clone() for t in (*rings, *scales)]
    want = [t.clone() for t in (*rings, *scales)]
    before = quantize.quantize_int8_into.launches
    quantize.quantize_int8_into(k, v, *got, at)
    torch.cuda.synchronize()
    assert quantize.quantize_int8_into.launches == before + 1
    ref.quantize_int8_into_ref(k, v, *want, at)
    for g, w, old in zip(got, want, (*rings, *scales)):
        _assert_bitwise(g, w)
        keep = torch.arange(S, device=cuda) != at
        _assert_bitwise(g[:, keep], old[:, keep])


def test_fused_kv_write_at_the_decode_shape(cuda):
    """MiniCPM-2B's decode rows, batch 16 x 36 K/V heads of head_dim 64 in
    bf16, into rings of 64 slots, from strided sources (the K/V heads of a
    wider projection): bitwise the plain version's."""
    B, KV, W, S = 16, 36, 64, 64
    rng = np.random.default_rng(5)
    k, v, rings, scales = _kv_step(rng, B, KV, W, S, "bf16", cuda)
    wide = torch.zeros((B, 1, 2 * KV, W), dtype=k.dtype, device=cuda)
    wide[:, :, ::2], wide[:, :, 1::2] = k, v
    ks, vs = wide[:, :, ::2], wide[:, :, 1::2]
    assert not ks.is_contiguous()
    for at in (0, 37, S - 1):
        got = [t.clone() for t in (*rings, *scales)]
        want = [t.clone() for t in (*rings, *scales)]
        quantize.quantize_int8_into(ks, vs, *got, at)
        ref.quantize_int8_into_ref(k, v, *want, at)
        for g, w in zip(got, want):
            _assert_bitwise(g, w)


def test_launch_counters_count_only_launches(cuda):
    before = block_combine.combine2.launches
    empty = torch.empty(0, device=cuda)
    assert block_combine.combine2(empty, empty).numel() == 0
    assert block_combine.combine2.launches == before
    before = quantize.quantize_int8.launches
    q, s = quantize.quantize_int8(torch.empty((0, 64), device=cuda))
    assert q.shape == (0, 64) and quantize.quantize_int8.launches == before


def test_int8_decode_runs_the_kernels_and_matches_plain(cuda, monkeypatch):
    """Reduced MiniCPM-2B with the int8 cache through ``serve_loop`` on the
    card, the ring wrapping (6 steps, 4 slots): every step writes K and V
    with one fused quantize launch per layer and dequantizes each once, and
    tokens and logits are bitwise those of the same run with the plain
    versions."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.launch import serve
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    args = argparse.Namespace(arch="minicpm_2b", reduced=True, batch=3,
                              steps=6, cache_len=4, seed=0, device="cuda")
    before = (quantize.quantize_int8_into.launches,
              quantize.quantize_int8.launches,
              quantize.dequantize_int8.launches)
    run = serve.serve_loop(args, cfg, keep_logits=True)
    steps = cfg.n_layers * args.steps
    assert (quantize.quantize_int8_into.launches - before[0],
            quantize.quantize_int8.launches - before[1],
            quantize.dequantize_int8.launches - before[2]) == \
        (steps, 0, 2 * steps)
    monkeypatch.setattr(quantize, "quantize_int8_into",
                        ref.quantize_int8_into_ref)
    monkeypatch.setattr(quantize, "quantize_int8", ref.quantize_int8_ref)
    monkeypatch.setattr(quantize, "dequantize_int8", ref.dequantize_int8_ref)
    plain = serve.serve_loop(args, cfg, keep_logits=True)
    assert np.array_equal(run.tokens, plain.tokens)
    _assert_bitwise(run.logits, plain.logits)


# flash kernel vs plain: each output element against its own size plus its
# row's largest, the lse absolutely (flash_attention.flash_errors)
FLASH_MASKS = flash_attention.FLASH_MASKS


def _flash_inputs(rng, B, T, H, KV, dh, dtype, device):
    return [torch.from_numpy(rng.standard_normal((B, T, n, dh)).astype(
        np.float32)).to(dtype).to(device) for n in (H, KV, KV)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mask", list(FLASH_MASKS))
@pytest.mark.parametrize("T", [1025, 1088, 1536])
@pytest.mark.parametrize("dh", [12, 16, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_flash_kernel_matches_plain(rep, dh, T, mask, dt, cuda):
    """Every mask kind, T a multiple of the query block and not (1025 leaves
    one row in the last block), grouped heads read in place, the kernel's
    two widths and the reduced configs' head_dims 12 and 16 (zero-padded
    to 64 by the wrapper). The window (200) and the chunks (96) leave the
    first key tile of many rows fully masked."""
    causal, window, chunk = FLASH_MASKS[mask]
    q, k, v = _flash_inputs(np.random.default_rng(T + dh + rep), 2, T,
                            2 * rep, 2, dh, DTYPES[dt], cuda)
    before = flash_attention.flash_attention.launches
    out, lse = flash_attention.flash_attention(
        q, k, v, causal=causal, window=window, chunk=chunk)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window, chunk=chunk)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.shape == (2, 2 * rep, T) and lse.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all())
    share, lse_err = flash_attention.flash_errors(out, lse, want, want_lse)
    assert share <= flash_attention.FLASH_TOL[DTYPES[dt]]
    assert lse_err <= flash_attention.FLASH_LSE_TOL[DTYPES[dt]]


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(np.random.default_rng(0), 1, 1100, 2, 2, 192,
                            torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q, k, v)
    q, k, v = _flash_inputs(np.random.default_rng(0), 1, 1100, 2, 2, 64,
                            torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2).contiguous()
                                        .transpose(1, 2), k, v)


def test_flash_training_step_runs_the_kernel(cuda, monkeypatch):
    """Reduced MiniCPM-2B at its own head_dim (12, zero-padded to the
    kernel's 64) and T = 1088 through the port's train step on the card:
    each layer's attention launches the kernel in the forward and again in
    the recompute, and the loss and gradient norm agree with the same step
    on the plain version: within 2.5e-3 relative, about ten times the gap
    an H100 reads (PERF.md)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import step_fns
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import adamw
    cfg = dataclasses.replace(get_config("minicpm_2b", reduced=True),
                              remat=True)
    assert cfg.hdim not in flash_attention.HEAD_DIMS
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1088))
                                 .astype(np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    kernel = flash_attention.flash_attention
    vecs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(flash_attention, "flash_attention",
                                ref.flash_attention_ref)
        opt = adamw(1e-3)
        step = step_fns.make_train_step(cfg, optimizer=opt)
        params = tf.init_params(cfg, 0, cuda)
        before = kernel.launches
        _, _, vec = step(params, opt.init(params), batch)
        # forward and recompute in every layer; none on the plain run
        assert kernel.launches - before == (0 if plain else 2 * cfg.n_layers)
        vecs.append(vec.cpu().numpy())
    assert np.isfinite(vecs[0]).all()
    np.testing.assert_allclose(vecs[0], vecs[1], rtol=2.5e-3)


def test_init_params_on_the_card_are_the_cpus(cuda):
    """One seed gives the same weights on the card as on the CPU (where
    ``tests/test_torch_init.py`` holds them to the reference's): every
    leaf within 2 ulp of f32, and in practice equal, since the draw is
    IEEE operations only."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("minicpm_2b", reduced=True)
    card, host = tf.init_params(cfg, 3, cuda), tf.init_params(cfg, 3, "cpu")
    pairs = [(card, host)]
    while pairs:
        a, b = pairs.pop()
        if isinstance(a, dict):
            pairs += [(a[k], b[k]) for k in b]
        elif isinstance(a, (list, tuple)):
            pairs += list(zip(a, b))
        else:
            assert a.device.type == "cuda" and a.dtype == b.dtype
            ai = a.cpu().view(torch.int32).long()
            bi = b.view(torch.int32).long()
            order = [torch.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ai, bi)]
            assert int((order[0] - order[1]).abs().max()) <= 2
