"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Bitwise, NaN bits included: each kernel and its plain version run on the
same device on the same inputs (made by numpy from a seed). The flash
attention kernel is held within a tolerance instead
(``flash_attention.flash_errors``): its products accumulate in another
order and its 128-key tiles (bf16; 64 in f32) round ``p`` to bf16 against
another running max than the plain version's 512-key tiles; so are
``ring_attention``, the WKV recurrence (``wkv.wkv_errors``: fused
multiply-adds and another order of the sums over k) and the Mamba scan
(``mamba_scan.scan_errors``: another order of y's sum over n), each of
which gives a token the same bits in any call, bitwise. The seeded
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

from repro_torch.kernels import (block_combine, flash_attention,
                                 mamba_scan, quantize, ref, ring_attention,
                                 wkv)
from repro_torch.launch import step_fns

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
    """The fused K/V write of a decode step (every row at one slot) against
    its plain version, bit for bit on both rings and both scale arrays:
    the new slot holds the codes and scales, every other slot its old
    bytes, and the call is one launch."""
    B, KV, S = 3, 5, 9
    at = {"first": 0, "middle": S // 2, "last": S - 1}[slot]
    k, v, rings, scales = _kv_step(np.random.default_rng(width), B, KV,
                                   width, S, dt, cuda)
    got = [t.clone() for t in (*rings, *scales)]
    want = [t.clone() for t in (*rings, *scales)]
    before = quantize.quantize_int8_into.launches
    quantize.quantize_int8_into(k, v, *got, [at] * B, [1] * B)
    torch.cuda.synchronize()
    assert quantize.quantize_int8_into.launches == before + 1
    ref.quantize_int8_into_ref(k, v, *want, [at] * B, [1] * B)
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
        quantize.quantize_int8_into(ks, vs, *got, [at] * B, [1] * B)
        ref.quantize_int8_into_ref(k, v, *want, [at] * B, [1] * B)
        for g, w in zip(got, want):
            _assert_bitwise(g, w)


def _rows_case(rng, B, T, KV, W, S, dt, device):
    """A step's K and V rows, (B, T, KV, W), and int8 rings of S slots
    (with scales) that already hold earlier tokens."""
    x = _int8_rows(rng, 2 * B * T * KV - 4, W).to(DTYPES[dt])
    k, v = (t.reshape(B, T, KV, W).to(device)
            for t in x.split(B * T * KV))
    rings = [torch.from_numpy(rng.integers(-127, 128, (B, S, KV, W)).astype(
        np.int8)).to(device) for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(1e-3, 1, (B, S, KV, 1)).astype(
        np.float32)).to(device) for _ in range(2)]
    return k, v, rings, scales


def _check_rows_write(k, v, rings, scales, pos, n):
    """The per-row write against its plain version, bitwise on both rings
    and both scale arrays, in one launch; the positions no token of the
    call lands on keep their old bytes."""
    got = [t.clone() for t in (*rings, *scales)]
    want = [t.clone() for t in (*rings, *scales)]
    before = quantize.quantize_int8_into.launches
    quantize.quantize_int8_into(k, v, *got, pos, n)
    torch.cuda.synchronize()
    assert quantize.quantize_int8_into.launches == before + (
        1 if any(n) else 0)
    ref.quantize_int8_into_ref(k, v, *want, pos, n)
    S = rings[0].shape[1]
    for g, w, old in zip(got, want, (*rings, *scales)):
        _assert_bitwise(g, w)
        for b, (p, c) in enumerate(zip(pos, n)):
            keep = torch.ones(S, dtype=torch.bool)
            keep[[(p + t) % S for t in range(c)]] = False
            _assert_bitwise(g[b, keep.to(g.device)], old[b, keep.to(g.device)])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("width", [12, 64, 256])
def test_per_row_kv_write_matches_plain(width, dt, cuda):
    """Each row at its own position: a row that wraps the ring, one at the
    last slot, an inactive row (count 0), a position past S, pad tokens
    past a row's count."""
    B, T, KV, S = 5, 4, 3, 9
    k, v, rings, scales = _rows_case(np.random.default_rng(width), B, T, KV,
                                     width, S, dt, cuda)
    _check_rows_write(k, v, rings, scales, [0, 7, 8, 3, 20], [4, 2, 0, 1, 4])


def test_fused_kv_write_at_one_slot_is_quantize_int8_in_the_slot(cuda):
    """``pos[b] = slot``, ``n[b] = T`` for every row writes, bit for bit,
    the codes and scales that ``quantize_int8`` (the same kernel into fresh
    buffers) gives for K's and V's rows, at slots ``slot`` to ``slot + T -
    1``."""
    B, T, KV, W, S = 3, 2, 5, 64, 8
    k, v, rings, scales = _rows_case(np.random.default_rng(9), B, T, KV, W,
                                     S, "bf16", cuda)
    got = [t.clone() for t in (*rings, *scales)]
    quantize.quantize_int8_into(k, v, *got, [5] * B, [T] * B)
    for x, ring, scale in zip((k, v), got[:2], got[2:]):
        q, s = quantize.quantize_int8(x.reshape(-1, W))
        _assert_bitwise(ring[:, 5:5 + T], q.view(B, T, KV, W))
        _assert_bitwise(scale[:, 5:5 + T], s.view(B, T, KV, 1))


def test_per_row_kv_write_above_the_plan_cap(cuda):
    """More rows than the parameter block holds: the plan goes as a device
    array, with the same bits."""
    B = quantize.PLAN_ROWS + 3
    rng = np.random.default_rng(11)
    k, v, rings, scales = _rows_case(rng, B, 2, 2, 16, 5, "bf16", cuda)
    pos = [int(p) for p in rng.integers(0, 12, B)]
    n = [int(c) for c in rng.integers(0, 3, B)]
    _check_rows_write(k, v, rings, scales, pos, n)


def test_per_row_kv_write_at_the_engine_shapes(cuda):
    """MiniCPM-2B's slot rows (36 K/V heads of head_dim 64, bf16): a decode
    tick of 16 rows at mixed positions with inactive rows, and a prefill
    chunk of one row that wraps the ring, its pads not written."""
    rng = np.random.default_rng(12)
    k, v, rings, scales = _rows_case(rng, 16, 1, 36, 64, 1024, "bf16", cuda)
    pos = [0, 1023, 1024 + 5, 77] + [int(p) for p in rng.integers(0, 1024,
                                                                   12)]
    n = [1, 1, 1, 0] + [int(c) for c in rng.integers(0, 2, 12)]
    _check_rows_write(k, v, rings, scales, pos, n)
    k, v, rings, scales = _rows_case(rng, 1, 256, 36, 64, 1024, "bf16", cuda)
    _check_rows_write(k, v, rings, scales, [900], [200])


def test_per_row_kv_write_at_the_verify_shape(cuda):
    """A speculative verify tick of MiniCPM-2B's slots (36 K/V heads of
    head_dim 64, bf16, a ring of 4096): 8 rows of k + 1 = 5 tokens at mixed
    positions writing 0, 1, 3 or 5 of them, two near the ring's end so
    their writes wrap."""
    rng = np.random.default_rng(13)
    k, v, rings, scales = _rows_case(rng, 8, 5, 36, 64, 4096, "bf16", cuda)
    _check_rows_write(k, v, rings, scales,
                      [0, 4094, 100, 2047, 4095, 777, 3000, 12],
                      [1, 5, 0, 3, 5, 1, 3, 0])


def test_engine_speculation_runs_the_kernels_and_matches_plain(
        cuda, monkeypatch):
    """Reduced MiniCPM-2B with the int8 cache, speculating on the card:
    one per-row write per layer for every decode or verify tick and
    prefill chunk, two dequantizes for each, the streams those of plain
    decoding and of the same run with the plain int8 versions."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine, SpecParams
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    params = tf.init_params(cfg, 0, cuda)

    def run(spec):
        eng = ServingEngine(cfg, None, params, n_slots=3, max_len=64,
                            prefill_chunk=16, device=cuda)
        return eng.run(serve.synthetic_workload(
            6, cfg.vocab_size, gap=1, seed=1, prompt_lens=(5, 40),
            max_new=(4, 12), spec=spec, repetitive=True))

    before = (quantize.quantize_int8_into.launches,
              quantize.dequantize_int8.launches)
    got = run(SpecParams(draft_k=4))
    calls = cfg.n_layers * (got["decode_ticks"] + got["verify_ticks"]
                            + got["prefill_chunks"])
    assert got["verify_ticks"] > 0
    assert (quantize.quantize_int8_into.launches - before[0],
            quantize.dequantize_int8.launches - before[1]) == \
        (calls, 2 * calls)
    assert run(None)["tokens"] == got["tokens"]
    monkeypatch.setattr(quantize, "quantize_int8_into",
                        ref.quantize_int8_into_ref)
    monkeypatch.setattr(quantize, "dequantize_int8", ref.dequantize_int8_ref)
    assert run(SpecParams(draft_k=4))["tokens"] == got["tokens"]


def test_engine_sampled_speculation_with_accepted_drafts(cuda):
    """Reduced MiniCPM-2B with the int8 cache, sampled, drafting with a
    draft model that is the target: drafts are accepted, and the tokens
    each verify tick commits at positions t >= 1 give the plain sampled
    streams on the card."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (DraftModelDrafter, SamplingParams,
                                     ServingEngine, SpecParams)
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    params = tf.init_params(cfg, 0, cuda)
    sp = SamplingParams(temperature=0.5, top_k=3, seed=5)

    def run(spec, drafter=None):
        eng = ServingEngine(cfg, None, params, n_slots=3, max_len=64,
                            prefill_chunk=16, device=cuda, drafter=drafter)
        return eng.run(serve.synthetic_workload(
            5, cfg.vocab_size, gap=1, seed=2, prompt_lens=(5, 30),
            max_new=(6, 14), sampling=sp, spec=spec))

    drafter = DraftModelDrafter(cfg, params, n_slots=3, max_len=64,
                                device=cuda)
    got = run(SpecParams(draft_k=4), drafter)
    assert got["accepted_tokens"] > 0
    assert got["sampled_tokens"] == got["total_tokens"]
    assert got["tokens"] == run(None)["tokens"]


def _ring_case(rng, B, T, H, KV, D, S, dt, device):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(DTYPES[dt]).to(device)
            for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D))]


def _check_ring_close(got, want, keep, dt):
    g, w = got.double()[keep], want.double()[keep]
    scale = w.abs() + w.abs().amax(-1, keepdim=True)
    assert float(((g - w).abs() / scale).max()) <= \
        flash_attention.FLASH_TOL[dt]
    assert bool((got[~keep] == 0).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [12, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 5, 6])
@pytest.mark.parametrize("mask", [(None, None), (8, None), (None, 16)])
def test_ring_attention_matches_plain(mask, rep, D, dt, cuda):
    """Rows at a fresh ring, a wrapped ring and an inactive row, 1 to 200
    queries (more than one 64-row tile, and more than the ring holds),
    rings of a whole number of key blocks and not: each output element
    within the flash kernel's tolerance of its size plus its row's largest,
    over the queries with a position to read; one launch a call. 5 and 6
    query heads a K/V head are Llama-4 Scout's and Mixtral-8x22B's groups
    (a query's heads then straddle the 64-row tiles)."""
    window, chunk = mask
    rng = np.random.default_rng(D + rep)
    for T in (1, 5, 33, 64, 200):
        for S in ((64, 100) if window is None else (max(T, 13),)):
            q, k, v = _ring_case(rng, 3, T, 2 * rep, 2, D, S, dt, cuda)
            plan = torch.tensor([[0, 70, 30], [T, T, 0]], device=cuda)
            before = ring_attention.ring_attention.launches
            got = ring_attention.ring_attention(q, k, v, plan, window, chunk)
            torch.cuda.synchronize()
            assert ring_attention.ring_attention.launches == before + 1
            want = ref.ring_attention_ref(q, k, v, plan, window, chunk)
            keep = ring_attention.valid(plan, T, S, window, chunk)
            _check_ring_close(got, want, keep.to(cuda), DTYPES[dt])


@pytest.mark.parametrize("dt, D", [("f32", 64), ("f32", 12), ("bf16", 192),
                                   ("bf16", 33)])
def test_ring_attention_keeps_the_cuda_core_kernel(dt, D, cuda):
    """f32, an odd head dim and one above 128 take the CUDA-core kernel
    (TF32 would break f32's limit), and it matches the plain version."""
    assert ring_attention.route(DTYPES[dt], D, 64) == "cuda_cores"
    rng = np.random.default_rng(D)
    for T, window in ((1, None), (40, None), (40, 8)):
        q, k, v = _ring_case(rng, 3, T, 4, 2, D, 64, dt, cuda)
        plan = torch.tensor([[0, 70, 30], [T, T, 0]], device=cuda)
        before = ring_attention.ring_attention.launches
        got = ring_attention.ring_attention(q, k, v, plan, window)
        torch.cuda.synchronize()
        assert ring_attention.ring_attention.launches == before + 1
        want = ref.ring_attention_ref(q, k, v, plan, window)
        keep = ring_attention.valid(plan, T, 64, window)
        _check_ring_close(got, want, keep.to(cuda), DTYPES[dt])


def test_ring_attention_routes_give_the_same_bits(cuda):
    """The tensor-core kernel by TMA and by cp.async on the same inputs:
    the copy route moves bytes only."""
    rng = np.random.default_rng(5)
    for T, rep, D in ((1, 1, 64), (77, 2, 64), (9, 1, 128)):
        q, k, v = _ring_case(rng, 3, T, 4 * rep, 4, D, 256, "bf16", cuda)
        plan = torch.tensor([[0, 300, 100], [T, T, 0]], device=cuda)
        outs = []
        for name in ("wgmma_tma", "wgmma_cp_async"):
            out = torch.empty_like(q)
            args = ring_attention._call_args(q, k, v, out, plan, None, None)
            assert ring_attention._fn("ra_forward")(
                ring_attention.ROUTES.index(name), *args[1:],
                torch.cuda.current_stream().cuda_stream) == 0
            outs.append(out)
        _assert_bitwise(outs[1], outs[0])


def test_ring_attention_gives_a_query_the_same_bits_in_any_call(cuda):
    """MiniCPM-2B's heads over a ring of 4096: the same queries in five
    calls of one, a call of 5 and a call of 40 (a decode tick, a verify
    call, a prefill chunk) give bitwise the same outputs."""
    rng = np.random.default_rng(3)
    q, k, v = _ring_case(rng, 8, 40, 36, 36, 64, 4096, "bf16", cuda)
    pos = torch.tensor([0, 17, 1000, 1500, 2047, 3000, 4000, 33],
                       device=cuda)
    five = ring_attention.ring_attention(
        q[:, :5].contiguous(), k, v, torch.stack([pos, torch.full_like(
            pos, 5)]))
    forty = ring_attention.ring_attention(
        q, k, v, torch.stack([pos, torch.full_like(pos, 40)]))
    for t in range(5):
        one = ring_attention.ring_attention(
            q[:, t:t + 1].contiguous(), k, v,
            torch.stack([pos + t, torch.ones_like(pos)]))
        _assert_bitwise(one[:, 0], five[:, t])
        _assert_bitwise(one[:, 0], forty[:, t])
    # over a wrapped ring in calls of 1, 5, 40 and 512 at offsets
    # (ring_attention.same_bits_pairs), H = KV and H = 2 KV, with and
    # without a window
    first = torch.tensor([5000, 6100, 4200, 8000], device=cuda) - 37
    for H, KV in ((36, 36), (36, 18)):
        q, k, v = _ring_case(rng, 4, 512, H, KV, 64, 4096, "bf16", cuda)
        for window in (None, 1000):
            for _, one, got in ring_attention.same_bits_pairs(q, k, v, first,
                                                              window):
                _assert_bitwise(one, got)


def test_slot_steps_give_a_token_the_same_bits_in_any_call(cuda):
    """Reduced MiniCPM-2B with the int8 cache: five tokens fed through one
    verify call and through five decode ticks leave the same ring bytes
    and logits, and a journal re-prefilled in a chunk leaves the bytes its
    decode ticks wrote."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    params = tf.init_params(cfg, 0, cuda)
    prefill = step_fns.make_prefill_step(cfg)
    rng = np.random.default_rng(4)
    caches = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True)
    for slot in range(4):
        toks = rng.integers(1, cfg.vocab_size, 20 + 7 * slot)
        caches = _prefill_all(prefill, params, caches, slot, toks, cuda)
    seq = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 5))).to(cuda)
    clone = lambda cs: tuple({n: t.clone() for n, t in c.items()}  # noqa
                             for c in cs)
    with torch.no_grad():
        dec, logits = clone(caches), []
        for t in range(5):
            lg, dec = tf.decode_step(params, cfg, {"tokens": seq[:, t:t + 1]},
                                     dec, active=np.ones(4, bool))
            logits.append(lg)
        ver = clone(caches)
        vl, old = tf.verify_forward(params, cfg, {"tokens": seq}, ver,
                                    lengths=[5] * 4,
                                    active=np.ones(4, bool))
        ver = tf.commit_verify_caches(ver, old, [5] * 4, np.ones(4, bool))
    for t in range(5):
        _assert_bitwise(logits[t], vl[:, t])
    for a, b in zip(dec, ver):
        for n in ("k", "v", "ks", "vs"):
            _assert_bitwise(a[n], b[n])
    # a journal: slot 0 holds 20 prompt tokens, then 5 decoded ones; slot
    # 3 takes prompt + journal in prefill chunks
    prompt = rng.integers(1, cfg.vocab_size, 20)
    first = _prefill_all(prefill, params, tf.init_cache(
        cfg, 4, 96, device=cuda, per_slot=True), 0, prompt, cuda)
    act = np.zeros(4, bool)
    act[0] = True
    journal = rng.integers(1, cfg.vocab_size, 5)
    with torch.no_grad():
        for t in journal:
            tk = torch.zeros((4, 1), dtype=torch.int64, device=cuda)
            tk[0, 0] = int(t)
            _, first = tf.decode_step(params, cfg, {"tokens": tk}, first,
                                      active=act)
    first = _prefill_all(prefill, params, first, 3,
                         np.concatenate([prompt, journal]), cuda)
    for c in first:
        for n in ("k", "v", "ks", "vs"):
            _assert_bitwise(c[n][:, 0, :25], c[n][:, 3, :25])


def test_ring_attention_same_bits_at_the_moe_heads(cuda):
    """Mixtral-8x22B's 48 query heads over 8 K/V heads and Llama-4 Scout's
    40 over 8, head_dim 128, over a wrapped ring of 4096 (TMA) and of 4100
    (a window's ring with the engine's draft slack: cp.async): the calls
    of ``ring_attention.same_bits_pairs`` give bitwise the same outputs,
    and the outputs are within the tolerance of the plain version."""
    rng = np.random.default_rng(8)
    first = torch.tensor([5000, 6100, 4200, 8000], device=cuda) - 37
    for H, S, window in ((48, 4096, None), (48, 4100, 4096),
                         (40, 4096, None), (40, 4100, 1000)):
        q, k, v = _ring_case(rng, 4, 512, H, 8, 128, S, "bf16", cuda)
        for what, one, got in ring_attention.same_bits_pairs(q, k, v, first,
                                                             window):
            _assert_bitwise(one, got)
        plan = torch.stack([first, torch.full_like(first, 512)])
        got = ring_attention.ring_attention(q, k, v, plan, window)
        want = ref.ring_attention_ref(q, k, v, plan, window)
        keep = ring_attention.valid(plan, 512, S, window)
        _check_ring_close(got, want, keep.to(cuda), torch.bfloat16)


def test_per_row_kv_write_at_the_moe_shapes(cuda):
    """The MoE configs' slot rows (8 K/V heads of head_dim 128, bf16): a
    decode tick of 16 rows at mixed positions over Mixtral's window ring
    (4100 slots), inactive rows among them, a verify tick of 8 rows of 5,
    and a 1024-token chunk of Scout's that wraps its chunk ring (8196)."""
    rng = np.random.default_rng(14)
    k, v, rings, scales = _rows_case(rng, 16, 1, 8, 128, 4100, "bf16", cuda)
    pos = [0, 4099, 4100 + 5, 77] + [int(p) for p in rng.integers(0, 8200,
                                                                   12)]
    n = [1, 1, 1, 0] + [int(c) for c in rng.integers(0, 2, 12)]
    _check_rows_write(k, v, rings, scales, pos, n)
    k, v, rings, scales = _rows_case(rng, 8, 5, 8, 128, 4100, "bf16", cuda)
    _check_rows_write(k, v, rings, scales,
                      [0, 4098, 100, 2047, 4099, 777, 3000, 12],
                      [1, 5, 0, 3, 5, 1, 3, 0])
    k, v, rings, scales = _rows_case(rng, 1, 1024, 8, 128, 8196, "bf16",
                                     cuda)
    _check_rows_write(k, v, rings, scales, [7600], [900])


def _moe_layer(cuda, E=8, D=6144, F=16384, top_k=2):
    """Mixtral-8x22B's MoE sublayer at its published widths with random
    bf16 experts and an f32 router, at capacity factor E (nothing drops),
    and its config."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("mixtral_8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=E, top_k=top_k, capacity_factor=float(E)))
    g = torch.Generator(device=cuda).manual_seed(21)
    p = {"router": torch.randn((D, E), generator=g, device=cuda) * 0.02}
    for name, shape in (("w_in", (E, D, F)), ("w_gate", (E, D, F)),
                        ("w_out", (E, F, D))):
        p[name] = (torch.randn(shape, generator=g, device=cuda)
                   / shape[1] ** 0.5).to(torch.bfloat16)
    return tf, cfg, p


def test_expert_products_give_a_row_the_same_bits_in_any_call(cuda):
    """An expert's product through ``layers.serve_rows`` and the whole
    dispatch sublayer on the slot path: a token's output row has the same
    bits whether 1, 5, 40 or 512 tokens share the call (and its expert),
    at Mixtral-8x22B's widths."""
    from repro_torch.models import layers
    tf, cfg, p = _moe_layer(cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    x = torch.randn((1, 512, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    w = p["w_in"][3]
    rows = {n: layers.serve_matmul(x[0, :n], w) for n in (1, 5, 40, 512)}
    outs = {}
    with torch.no_grad():
        for n in (1, 5, 40, 512):
            outs[n], _ = tf._moe_dispatch(p, x[:, :n], cfg,
                                          layers.serve_matmul, aux=False)
    for small, big in ((1, 5), (1, 40), (1, 512), (5, 40), (5, 512),
                       (40, 512)):
        _assert_bitwise(rows[big][:small], rows[small])
        _assert_bitwise(outs[big][:, :small], outs[small])
    assert bool(torch.isfinite(outs[512]).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_serve_rmsnorm_is_rmsnorm_in_calls_of_serve_rows(dt, cuda):
    """The slot paths' norm, its mean of squares through ``serve_rows`` and
    the rest over every row at once, gives each row the bits of ``rmsnorm``
    over calls of ``SERVE_ROWS`` rows, at 8, 40, 700 and 1024 rows of 4096
    (a decode tick, a verify call and prefill chunks)."""
    from repro_torch.models import layers
    g = torch.Generator(device=cuda).manual_seed(23)
    p = {"scale": torch.rand(4096, generator=g, device=cuda) + 0.5}
    for M in (8, 40, 700, 1024):
        x = (torch.randn((1, M, 4096), generator=g, device=cuda)
             * 3).to(DTYPES[dt])
        want = layers.serve_rows(lambda r: layers.rmsnorm(p, r), x)
        _assert_bitwise(layers.serve_rmsnorm(p, x), want)


def test_moe_slot_steps_give_a_token_the_same_bits_in_any_call(cuda):
    """Reduced Mixtral-8x22B with the int8 cache at full capacity: five
    tokens through one verify call and through five decode ticks leave
    the same ring bytes and logits."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.models import transformer as tf
    cfg = decode_config(get_config("mixtral_8x22b", reduced=True))
    cfg = dataclasses.replace(cfg, kv_quant=True, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    params = tf.init_params(cfg, 0, cuda)
    prefill = step_fns.make_prefill_step(cfg)
    rng = np.random.default_rng(5)
    caches = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True,
                           ring_slack=4)
    for slot in range(4):
        toks = rng.integers(1, cfg.vocab_size, 10 + 3 * slot)
        caches = _prefill_all(prefill, params, caches, slot, toks, cuda,
                              chunk=8)
    seq = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 5))).to(cuda)
    clone = lambda cs: tuple({n: t.clone() for n, t in c.items()}  # noqa
                             for c in cs)
    with torch.no_grad():
        dec, logits = clone(caches), []
        for t in range(5):
            lg, dec = tf.decode_step(params, cfg, {"tokens": seq[:, t:t + 1]},
                                     dec, active=np.ones(4, bool))
            logits.append(lg)
        ver = clone(caches)
        vl, old = tf.verify_forward(params, cfg, {"tokens": seq}, ver,
                                    lengths=[5] * 4,
                                    active=np.ones(4, bool))
        ver = tf.commit_verify_caches(ver, old, [5] * 4, np.ones(4, bool))
    for t in range(5):
        _assert_bitwise(logits[t], vl[:, t])
    for a, b in zip(dec, ver):
        for n in ("k", "v", "ks", "vs"):
            _assert_bitwise(a[n], b[n])


def _prefill_all(prefill, params, caches, slot, toks, device, chunk=16):
    pos = 0
    while pos < len(toks):
        c = min(chunk, len(toks) - pos)
        buf = torch.zeros((1, chunk), dtype=torch.int64, device=device)
        buf[0, :c] = torch.from_numpy(np.asarray(toks[pos:pos + c]))
        _, caches = prefill(params, buf, caches, slot, c, resume=pos > 0)
        pos += c
    return caches


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


def test_engine_runs_the_per_row_write_and_matches_plain(cuda, monkeypatch):
    """Reduced MiniCPM-2B with the int8 cache through the continuous engine
    on the card (chunked prompts, more requests than slots): one per-row
    write per layer for every decode tick and prefill chunk, two
    dequantizes for each, and the streams those of the plain versions."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    params = tf.init_params(cfg, 0, cuda)

    def run():
        eng = ServingEngine(cfg, None, params, n_slots=3, max_len=64,
                            prefill_chunk=16, device=cuda)
        reqs = serve.synthetic_workload(6, cfg.vocab_size, gap=1, seed=1,
                                        prompt_lens=(5, 40), max_new=(2, 6))
        return eng.run(reqs)

    before = (quantize.quantize_int8_into.launches,
              quantize.dequantize_int8.launches)
    got = run()
    calls = cfg.n_layers * (got["decode_ticks"] + got["prefill_chunks"])
    assert (quantize.quantize_int8_into.launches - before[0],
            quantize.dequantize_int8.launches - before[1]) == \
        (calls, 2 * calls)
    monkeypatch.setattr(quantize, "quantize_int8_into",
                        ref.quantize_int8_into_ref)
    monkeypatch.setattr(quantize, "dequantize_int8", ref.dequantize_int8_ref)
    assert run()["tokens"] == got["tokens"]


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


def _fleet_engine(cuda):
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(
        decode_config(get_config("minicpm_2b", reduced=True)), kv_quant=True)
    params = tf.init_params(cfg, 0, cuda)
    return cfg, ServingEngine(cfg, None, params, n_slots=2, max_len=64,
                              prefill_chunk=16, device=cuda)


def test_fleet_under_chaos_on_the_card_keeps_the_streams(cuda):
    """Reduced MiniCPM-2B with the int8 cache, 3 replicas on the card under
    a kill, a flap with a straggler, and poison: every stream bitwise the
    undisturbed run's (the orphans resume through prefill chunks beside
    other neighbours), the poisoned replica quarantined."""
    from repro_torch.launch import serve
    from repro_torch.runtime.chaos import Fault, FaultPlan
    from repro_torch.serving import FleetRunner, SamplingParams
    cfg, eng = _fleet_engine(cuda)

    def reqs():
        out = serve.synthetic_workload(8, cfg.vocab_size, gap=1, seed=3,
                                       prompt_lens=(5, 40), max_new=(8, 16))
        for r in out:
            if r.rid % 2:
                r.sampling = SamplingParams(seed=11 + r.rid,
                                            temperature=0.9, top_k=20)
        return out

    want = eng.run(reqs())["tokens"]
    plans = {"kill": (Fault(5, "kill", replica=1),),
             "flap": (Fault(4, "flap", replica=1, duration=8),
                      Fault(3, "straggle", replica=0, duration=6,
                            factor=2.0)),
             "poison": (Fault(6, "poison", replica=2),)}
    for name, faults in plans.items():
        rep = FleetRunner(eng, 3, plan=FaultPlan(faults), timeout_s=2.0,
                          rejoin_backoff_s=1.0).run(reqs())
        assert rep["tokens"] == want, name
        assert rep["failovers"] > 0, name
        if name == "flap":
            assert rep["rejoins"] == 1 and rep["alive"] == [0, 1, 2]
        if name == "poison":
            assert rep["quarantined"] == [2]


def test_nan_scale_slot_gives_nonfinite_logits_through_the_kernels(cuda):
    """A slot whose int8 scales are NaN (``poison_slot``) gives non-finite
    logits out of the card's dequantize and ``ring_attention``, and only
    that slot: the guard sees the poison the CPU's plain versions carry."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.chaos import poison_slot
    from repro_torch.serving import Request
    cfg, eng = _fleet_engine(cuda)
    sess = eng.start([Request(i, tuple(range(3 + i, 23 + i)),
                              max_new_tokens=8) for i in range(2)])
    while len(sess.sched.active) < 2 or \
            any(r.state.name != "ACTIVE" for r in sess.sched.active.values()):
        sess.tick()
    sess.caches = poison_slot(sess.caches, 1)
    assert all(bool(c["ks"][:, 1].isnan().all()) and
               not bool(c["ks"][:, 0].isnan().any()) for c in sess.caches)
    before = ring_attention.ring_attention.launches
    logits, _ = tf.decode_step(
        eng.params, cfg,
        {"tokens": torch.tensor([[5], [7]], device=cuda)}, sess.caches,
        active=np.ones(2, bool))
    assert ring_attention.ring_attention.launches - before == cfg.n_layers
    assert bool(torch.isfinite(logits[0]).all())
    assert not bool(torch.isfinite(logits[1]).any())


# ------------------------------------------------------------ wkv6

def _wkv_case(rng, B, T, H, K, dt, device, masked=False):
    """r, k, v in ``dt``, w_log, u, a nonzero state (f32) and a (B, T)
    valid mask (every token valid unless ``masked``)."""
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, K)).astype(
        np.float32) * 0.5).to(DTYPES[dt]).to(device) for _ in range(3))
    w_log = torch.from_numpy(np.clip(
        -np.exp(rng.standard_normal((B, T, H, K)) - 2.0), -8,
        -1e-4).astype(np.float32)).to(device)
    u = torch.from_numpy((rng.standard_normal((H, K)) * 0.3).astype(
        np.float32)).to(device)
    S = torch.from_numpy((rng.standard_normal((B, H, K, K)) * 0.3).astype(
        np.float32)).to(device)
    valid = torch.from_numpy(rng.random((B, T)) < (0.8 if masked else 2.0))
    return r, k, v, w_log, u, S, valid.to(device)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1, 5, 33, 1024])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wkv6_matches_plain(dt, K, T, masked, collect, cuda):
    rng = np.random.default_rng(K * 7 + T)
    r, k, v, w, u, S, valid = _wkv_case(rng, 3, T, 4, K, dt, cuda, masked)
    m = valid if masked else None
    before = wkv.wkv6.launches
    o, st = wkv.wkv6(r, k, v, w, u, S, m, collect)
    assert wkv.wkv6.launches == before + 1
    assert o.dtype == r.dtype and st.dtype == torch.float32
    assert st.shape == ((3, T, 4, K, K) if collect else (3, 4, K, K))
    e_o, e_s = wkv.wkv_errors((o, st), r, k, v, w, u, S, m, collect)
    assert e_o <= wkv.WKV_TOL[r.dtype] and e_s <= wkv.WKV_STATE_TOL, \
        (e_o, e_s)
    if collect and masked:
        # a pad leaves the state bit-unchanged
        prev = torch.cat([S[:, None], st[:, :-1]], 1)
        _assert_bitwise(st[~valid], prev[~valid])


@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wkv6_gives_a_token_the_same_bits_in_any_call(dt, K, cuda,
                                                       monkeypatch):
    """A row of 1,024 tokens with pads inside the token tiles (H heads of
    K: RWKV-6 7B's 64 of 64, the reduced 4 of 16): the call of all of it,
    the collecting call, calls of 1, 5, 31, 32 and 33 tokens and of 1,000
    then 24 threading the state, and the row beside 7 and 15 other rows
    (B = 8, 16: another column grouping at K = 64 in bf16) and beside rows
    with other masks, and the row under a plan forced to groups of 16
    columns, give each token's output and state bitwise the same. Each
    call's rows lie within ``WKV_TOL`` and ``WKV_STATE_TOL`` of the plain
    version."""
    H, T = (64 if K == 64 else 4), 1024
    rng = np.random.default_rng(11 + K)
    r, k, v, w, u, S, valid = _wkv_case(rng, 16, T, H, K, dt, cuda,
                                        masked=True)
    one = [x[:1] for x in (r, k, v, w)]
    S1, m1 = S[:1], valid[:1]
    plans = {B: wkv.plan(B, T, H, K, r.element_size()) for B in (1, 8, 16)}
    assert len({p.rows for p in plans.values()}) == 1
    if K == 64 and dt == "bf16":
        assert plans[1].group != plans[16].group
    o, st = wkv.wkv6(*one, u, S1, m1)
    if K == 64:
        forced = wkv.plan(1, T, H, K, r.element_size(), group=16)
        assert forced.group != plans[1].group
        with monkeypatch.context() as m:
            m.setattr(wkv, "plan", lambda *a, **kw: forced)
            by16 = wkv.wkv6(*one, u, S1, m1)
        _assert_bitwise(by16[0], o)
        _assert_bitwise(by16[1], st)
    oc, states = wkv.wkv6(*one, u, S1, m1, collect=True)
    _assert_bitwise(oc, o)
    _assert_bitwise(states[:, -1], st)
    e_o, e_s = wkv.wkv_errors((oc, states), *one, u, S1, m1, collect=True)
    assert e_o <= wkv.WKV_TOL[r.dtype] and e_s <= wkv.WKV_STATE_TOL, \
        (e_o, e_s)
    cuts = {n: list(range(0, T, n)) for n in (1, 5, 31, 32, 33)}
    cuts["1000+24"] = [0, 1000]
    for n, starts in cuts.items():
        state, outs = S1, []
        for t0, t1 in zip(starts, starts[1:] + [T]):
            part, state = wkv.wkv6(*(x[:, t0:t1].contiguous() for x in one),
                                   u, state, m1[:, t0:t1].contiguous())
            outs.append(part)
            _assert_bitwise(state, states[:, t1 - 1])
        _assert_bitwise(torch.cat(outs, 1), o)
    rows = {}
    for B in (8, 16):
        rows[B] = wkv.wkv6(r[:B], k[:B], v[:B], w[:B], u, S[:B], valid[:B])
        _assert_bitwise(rows[B][0][:1], o)
        _assert_bitwise(rows[B][1][:1], st)
    _assert_bitwise(rows[16][0][:8], rows[8][0])
    _assert_bitwise(rows[16][1][:8], rows[8][1])
    for b in range(16):
        e_o, e_s = wkv.wkv_errors((rows[16][0][b:b + 1], rows[16][1][b:b + 1]),
                                  r[b:b + 1], k[b:b + 1], v[b:b + 1],
                                  w[b:b + 1], u, S[b:b + 1], valid[b:b + 1])
        assert e_o <= wkv.WKV_TOL[r.dtype] and e_s <= wkv.WKV_STATE_TOL, \
            (b, e_o, e_s)
    other = valid.clone()
    other[1:] = ~other[1:]
    moved = wkv.wkv6(r, k, v, w, u, S, other)
    _assert_bitwise(moved[0][:1], o)
    _assert_bitwise(moved[1][:1], st)


def test_wkv6_builds_without_spills(cuda):
    """ptxas spills no register of any instantiation, and each fits two
    blocks of its threads on an SM's 65,536 registers."""
    import re
    from repro_torch.kernels import _build
    _build.load("wkv6", wkv._SIGNATURES)
    info = _build.ptxas_info("wkv6", "wkv6_kernel")
    assert info
    for line in info:
        assert "0 bytes spill stores" in line and \
            "0 bytes spill loads" in line, line
        K, G = map(int, re.search(r"Li(\d+)ELi(\d+)E", line).groups())
        threads = wkv.plan(1, 1, 64, K, group=G).threads
        regs = int(re.search(r"Used (\d+) registers", line)[1])
        assert 2 * threads * regs <= 65536, line


def test_wkv6_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(12)
    r, k, v, w, u, S, valid = _wkv_case(rng, 2, 5, 4, 64, "bf16", cuda)
    with pytest.raises(TypeError, match="f32 or bf16"):
        wkv.wkv6(r.half(), k.half(), v.half(), w, u, S)
    with pytest.raises(TypeError, match="w_log, u and state"):
        wkv.wkv6(r, k, v, w.bfloat16(), u, S)
    with pytest.raises(ValueError, match="one shape"):
        wkv.wkv6(r, k, v[:, :4], w, u, S)
    with pytest.raises(ValueError, match="one cpu or cuda"):
        wkv.wkv6(r, k, v, w, u.cpu(), S)
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w,
                 u, S)
    shifted = torch.empty(r.numel() + 4, dtype=r.dtype, device=cuda)[4:]
    with pytest.raises(ValueError, match="16 bytes"):
        wkv.wkv6(shifted.view(r.shape).copy_(r), k, v, w, u, S)
    r48, k48, v48, w48, u48, S48, _ = _wkv_case(rng, 2, 5, 4, 48, "bf16",
                                                cuda)
    with pytest.raises(ValueError, match="K in"):
        wkv.wkv6(r48, k48, v48, w48, u48, S48)
    before = wkv.wkv6.launches
    with pytest.raises(RuntimeError, match="no backward"):
        wkv.wkv6(r.float().requires_grad_(), k.float(), v.float(), w, u, S)
    assert wkv.wkv6.launches == before
    with torch.no_grad():
        wkv.wkv6(r.float().requires_grad_(), k.float(), v.float(), w, u, S)
    assert wkv.wkv6.launches == before + 1


def test_rwkv_slot_steps_give_a_token_the_same_bits_in_any_call(cuda):
    """Reduced RWKV-6 7B (head_dim 16) on the card: five tokens through one
    verify call and through five decode ticks leave the same carries and
    logits, and a prompt prefilled in chunks of 16 leaves the carries of
    the same prompt in one call, through the engine's prefill step."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.models import transformer as tf
    cfg = decode_config(get_config("rwkv6_7b", reduced=True))
    params = tf.init_params(cfg, 0, cuda)
    prefill = step_fns.make_prefill_step(cfg)
    rng = np.random.default_rng(5)
    caches = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True)
    prompts = [rng.integers(1, cfg.vocab_size, 20 + 7 * s) for s in range(4)]
    for slot in range(4):
        caches = _prefill_all(prefill, params, caches, slot, prompts[slot],
                              cuda)
    whole = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True)
    for slot in range(4):
        whole = _prefill_all(prefill, params, whole, slot, prompts[slot],
                             cuda, chunk=64)
    names = ("shift1", "shift2", "state")
    for a, b in zip(caches, whole):
        for n in names:
            _assert_bitwise(a[n], b[n])
    seq = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 5))).to(cuda)
    clone = lambda cs: tuple({n: t.clone() for n, t in c.items()}  # noqa
                             for c in cs)
    before = wkv.wkv6.launches
    with torch.no_grad():
        dec, logits = clone(caches), []
        for t in range(5):
            lg, dec = tf.decode_step(params, cfg, {"tokens": seq[:, t:t + 1]},
                                     dec, active=np.ones(4, bool))
            logits.append(lg)
        ver = clone(caches)
        vl, old = tf.verify_forward(params, cfg, {"tokens": seq}, ver,
                                    lengths=[5] * 4,
                                    active=np.ones(4, bool))
        ver = tf.commit_verify_caches(ver, old, [5] * 4, np.ones(4, bool))
    assert wkv.wkv6.launches - before == 6 * cfg.n_layers
    for t in range(5):
        _assert_bitwise(logits[t], vl[:, t])
    for a, b in zip(dec, ver):
        for n in names:
            _assert_bitwise(a[n], b[n])


def test_ring_attention_same_bits_at_the_jamba_heads(cuda):
    """Jamba's 32 query heads over 8 K/V heads of 128 (4 a K/V head), over
    a wrapped ring of 4096 (TMA) and one with the engine's draft slack
    (cp.async): the calls of ``ring_attention.same_bits_pairs`` give
    bitwise the same outputs, within the tolerance of the plain version."""
    rng = np.random.default_rng(9)
    first = torch.tensor([5000, 6100, 4200, 8000], device=cuda) - 37
    for S in (4096, 4100):
        q, k, v = _ring_case(rng, 4, 512, 32, 8, 128, S, "bf16", cuda)
        for what, one, got in ring_attention.same_bits_pairs(q, k, v, first,
                                                             None):
            _assert_bitwise(one, got)
        plan = torch.stack([first, torch.full_like(first, 512)])
        got = ring_attention.ring_attention(q, k, v, plan)
        want = ref.ring_attention_ref(q, k, v, plan)
        keep = ring_attention.valid(plan, 512, S)
        _check_ring_close(got, want, keep.to(cuda), torch.bfloat16)


# ------------------------------------------------------------ mamba_scan

def _scan_case(rng, B, T, Di, N, device, masked=False):
    """dt (a softplus's range), dtx, B, C, A (negative), a nonzero state,
    all f32, and a (B, T) valid mask (every token valid unless
    ``masked``)."""
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    dt = f32(np.log1p(np.exp(rng.standard_normal((B, T, Di)) - 3)))
    dtx = dt * f32(rng.standard_normal((B, T, Di)))
    Bm, C = (f32(rng.standard_normal((B, T, N))) for _ in range(2))
    A = -f32(np.tile(np.arange(1, N + 1), (Di, 1)) * np.exp(
        rng.standard_normal((Di, 1)) * 0.3))
    S = f32(rng.standard_normal((B, Di, N)) * 0.3)
    valid = torch.from_numpy(rng.random((B, T)) < (0.8 if masked else 2.0))
    return dt, dtx, Bm, C, A, S, valid.to(device)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1, 5, 33, 1024])
@pytest.mark.parametrize("N,Di", [(8, 128), (16, 8192)])
def test_mamba_scan_matches_plain(N, Di, T, masked, collect, cuda):
    rng = np.random.default_rng(N * 7 + T)
    B = 3 if T < 1024 or Di < 8192 else 1
    dt, dtx, Bm, C, A, S, valid = _scan_case(rng, B, T, Di, N, cuda, masked)
    m = valid if masked else None
    before = mamba_scan.mamba_scan.launches
    y, st = mamba_scan.mamba_scan(dt, dtx, Bm, C, A, S, m, collect)
    assert mamba_scan.mamba_scan.launches == before + 1
    assert y.shape == (B, T, Di)
    assert st.shape == ((B, T, Di, N) if collect else (B, Di, N))
    e_y, e_s = mamba_scan.scan_errors((y, st), dt, dtx, Bm, C, A, S, m,
                                      collect)
    assert e_y <= mamba_scan.SCAN_TOL and \
        e_s <= mamba_scan.SCAN_STATE_TOL, (e_y, e_s)
    if collect and masked:
        # a pad leaves the state bit-unchanged
        prev = torch.cat([S[:, None], st[:, :-1]], 1)
        _assert_bitwise(st[~valid], prev[~valid])


@pytest.mark.parametrize("N,Di", [(8, 128), (16, 8192)])
def test_mamba_scan_gives_a_token_the_same_bits_in_any_call(N, Di, cuda):
    """A row of 1,024 tokens with pads (Jamba's 8192 channels of 16 states,
    the reduced 128 of 8): the call of all of it, the collecting call,
    calls of 1, 5, 31, 32 and 33 tokens and of 1,000 then 24 threading the
    state, the row beside 7 and 15 other rows (B = 8, 16) and beside rows
    with other masks give each token's y and state bitwise the same; each
    row lies within ``SCAN_TOL`` and ``SCAN_STATE_TOL`` of the plain
    version."""
    T = 1024
    rng = np.random.default_rng(13 + N)
    dt, dtx, Bm, C, A, S, valid = _scan_case(rng, 16, T, Di, N, cuda,
                                             masked=True)
    one = [x[:1] for x in (dt, dtx, Bm, C)]
    S1, m1 = S[:1], valid[:1]
    y, st = mamba_scan.mamba_scan(*one, A, S1, m1)
    yc, states = mamba_scan.mamba_scan(*one, A, S1, m1, collect=True)
    _assert_bitwise(yc, y)
    _assert_bitwise(states[:, -1], st)
    e_y, e_s = mamba_scan.scan_errors((yc, states), *one, A, S1, m1,
                                      collect=True)
    assert e_y <= mamba_scan.SCAN_TOL and \
        e_s <= mamba_scan.SCAN_STATE_TOL, (e_y, e_s)
    cuts = {n: list(range(0, T, n)) for n in (1, 5, 31, 32, 33)}
    cuts["1000+24"] = [0, 1000]
    for n, starts in cuts.items():
        state, outs = S1, []
        for t0, t1 in zip(starts, starts[1:] + [T]):
            part, state = mamba_scan.mamba_scan(
                *(x[:, t0:t1].contiguous() for x in one), A, state,
                m1[:, t0:t1].contiguous())
            outs.append(part)
            _assert_bitwise(state, states[:, t1 - 1])
        _assert_bitwise(torch.cat(outs, 1), y)
    rows = {}
    for B in (8, 16):
        rows[B] = mamba_scan.mamba_scan(dt[:B], dtx[:B], Bm[:B], C[:B], A,
                                        S[:B], valid[:B])
        _assert_bitwise(rows[B][0][:1], y)
        _assert_bitwise(rows[B][1][:1], st)
    _assert_bitwise(rows[16][0][:8], rows[8][0])
    _assert_bitwise(rows[16][1][:8], rows[8][1])
    for b in range(16):
        sl = slice(b, b + 1)
        e_y, e_s = mamba_scan.scan_errors(
            (rows[16][0][sl], rows[16][1][sl]), dt[sl], dtx[sl], Bm[sl],
            C[sl], A, S[sl], valid[sl])
        assert e_y <= mamba_scan.SCAN_TOL and \
            e_s <= mamba_scan.SCAN_STATE_TOL, (b, e_y, e_s)
    other = valid.clone()
    other[1:] = ~other[1:]
    moved = mamba_scan.mamba_scan(dt, dtx, Bm, C, A, S, other)
    _assert_bitwise(moved[0][:1], y)
    _assert_bitwise(moved[1][:1], st)


@pytest.mark.parametrize("N,Di", [(8, 128), (16, 8192)])
def test_mamba_scan_gives_the_same_bits_under_every_plan(N, Di, cuda,
                                                         monkeypatch):
    """Rows of 70 tokens with pads (B = 1, 8 and 16), collecting and not:
    the launch forced to the direct path, to a staged tile of 1 token, a
    small odd tile (7), 32 and the largest (64; 70 tokens leave a partial
    last tile) and to channel groups of 16, 32 and 64 gives each token's y
    and state bitwise the chosen plan's, which lies within ``SCAN_TOL``
    and ``SCAN_STATE_TOL`` of the plain version; the order of y's sum
    (``mamba_scan.ORDER``) is N's alone."""
    T = 70
    rng = np.random.default_rng(21 + N)
    dt, dtx, Bm, C, A, S, valid = _scan_case(rng, 16, T, Di, N, cuda,
                                             masked=True)
    forced = [dict(tile=1, channels=16), dict(tile=7, channels=32),
              dict(tile=64, channels=64), dict(tile=32, channels=16),
              dict(tile=7, channels=64), dict(staged=False, channels=16),
              dict(staged=False)]
    chosen = mamba_scan.plan
    for B in (1, 8, 16):
        args = (dt[:B], dtx[:B], Bm[:B], C[:B], A, S[:B], valid[:B])
        for collect in (False, True):
            want = mamba_scan.mamba_scan(*args, collect=collect)
            e_y, e_s = mamba_scan.scan_errors(want, *args, collect=collect)
            assert e_y <= mamba_scan.SCAN_TOL and \
                e_s <= mamba_scan.SCAN_STATE_TOL, (B, collect, e_y, e_s)
            for kw in forced:
                p = chosen(B, T, Di, N, **kw)
                assert (p.stages == 0) == (kw.get("staged") is False)
                assert p.tile == kw.get("tile", 1)
                assert p.channels == kw.get("channels", p.channels)
                assert (p.quad, p.lanes) == mamba_scan.ORDER[N]
                with monkeypatch.context() as m:
                    m.setattr(mamba_scan, "plan", lambda *a, **kw: p)
                    got = mamba_scan.mamba_scan(*args, collect=collect)
                _assert_bitwise(got[0], want[0])
                _assert_bitwise(got[1], want[1])


def test_mamba_scan_builds_without_spills(cuda):
    """ptxas spills no register of any instantiation (the staged and the
    direct path, N 8 and 16, each with and without collect)."""
    from repro_torch.kernels import _build
    _build.load("mamba_scan", mamba_scan._SIGNATURES)
    info = [line for path in ("mamba_scan_staged", "mamba_scan_direct")
            for line in _build.ptxas_info("mamba_scan", path)]
    assert len(info) == 4 * len(mamba_scan.D_STATES)
    for line in info:
        assert "0 bytes spill stores" in line and \
            "0 bytes spill loads" in line, line


def test_mamba_scan_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(14)
    dt, dtx, Bm, C, A, S, valid = _scan_case(rng, 2, 5, 128, 16, cuda)
    with pytest.raises(TypeError, match="f32"):
        mamba_scan.mamba_scan(dt.bfloat16(), dtx, Bm, C, A, S)
    with pytest.raises(ValueError, match="one cpu or cuda"):
        mamba_scan.mamba_scan(dt, dtx, Bm, C, A.cpu(), S)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan.mamba_scan(dt.transpose(0, 1).contiguous().transpose(
            0, 1), dtx, Bm, C, A, S)
    shifted = torch.empty(dt.numel() + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="16 bytes"):
        mamba_scan.mamba_scan(shifted.view(dt.shape).copy_(dt), dtx, Bm, C,
                              A, S)
    d4, x4, b4, c4, a4, s4, _ = _scan_case(rng, 2, 5, 128, 4, cuda)
    with pytest.raises(ValueError, match="N in"):
        mamba_scan.mamba_scan(d4, x4, b4, c4, a4, s4)
    d8, x8, b8, c8, a8, s8, _ = _scan_case(rng, 2, 5, 24, 8, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        mamba_scan.mamba_scan(d8, x8, b8, c8, a8, s8)
    before = mamba_scan.mamba_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        mamba_scan.mamba_scan(dt.clone().requires_grad_(), dtx, Bm, C, A, S)
    assert mamba_scan.mamba_scan.launches == before
    with torch.no_grad():
        mamba_scan.mamba_scan(dt.clone().requires_grad_(), dtx, Bm, C, A, S)
    assert mamba_scan.mamba_scan.launches == before + 1


def test_jamba_slot_steps_give_a_token_the_same_bits_in_any_call(cuda):
    """Reduced Jamba-v0.1 on the card (its rings and Mamba carries side by
    side): five tokens through one verify call and through five decode
    ticks leave the same caches and logits, and a prompt prefilled in
    chunks of 16 leaves the caches of the same prompt in chunks of 64,
    through the engine's prefill step; every call of a Mamba layer
    launches the scan kernel."""
    from repro_torch.configs.base import decode_config, get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(
        decode_config(get_config("jamba_v0_1_52b", reduced=True)),
        moe=dataclasses.replace(get_config("jamba_v0_1_52b",
                                           reduced=True).moe,
                                capacity_factor=4.0))
    params = tf.init_params(cfg, 0, cuda)
    prefill = step_fns.make_prefill_step(cfg)
    rng = np.random.default_rng(6)
    caches = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True,
                           ring_slack=8)
    prompts = [rng.integers(1, cfg.vocab_size, 20 + 7 * s) for s in range(4)]
    for slot in range(4):
        caches = _prefill_all(prefill, params, caches, slot, prompts[slot],
                              cuda)
    whole = tf.init_cache(cfg, 4, 96, device=cuda, per_slot=True,
                          ring_slack=8)
    for slot in range(4):
        whole = _prefill_all(prefill, params, whole, slot, prompts[slot],
                             cuda, chunk=64)
    for a, b in zip(caches, whole):
        for n in a:
            _assert_bitwise(a[n], b[n])
    seq = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 5))).to(cuda)
    clone = lambda cs: tuple({n: t.clone() for n, t in c.items()}  # noqa
                             for c in cs)
    before = mamba_scan.mamba_scan.launches
    with torch.no_grad():
        dec, logits = clone(caches), []
        for t in range(5):
            lg, dec = tf.decode_step(params, cfg, {"tokens": seq[:, t:t + 1]},
                                     dec, active=np.ones(4, bool))
            logits.append(lg)
        ver = clone(caches)
        vl, old = tf.verify_forward(params, cfg, {"tokens": seq}, ver,
                                    lengths=[5] * 4,
                                    active=np.ones(4, bool))
        ver = tf.commit_verify_caches(ver, old, [5] * 4, np.ones(4, bool))
    mambas = tf.cache_layer_kinds(cfg).count("mamba") * cfg.n_periods
    assert mamba_scan.mamba_scan.launches - before == 6 * mambas
    for t in range(5):
        _assert_bitwise(logits[t], vl[:, t])
    for a, b in zip(dec, ver):
        for n in a:
            _assert_bitwise(a[n], b[n])
