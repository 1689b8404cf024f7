"""The port's kernels: plain versions against the reference, CUDA kernels
against the plain versions.

On the CPU every wrapper runs its plain PyTorch version, which is held here
against ``repro.kernels.ref`` and against the Pallas kernels in interpret
mode, on the same inputs made by numpy from a seed. The comparison is
bitwise for f32, bf16 and int32 combines and for the casts on every input
that is not NaN; for NaN inputs the two frameworks pick different NaN bit
patterns on the CPU (PyTorch's CPU cast writes 0xffff, XLA keeps the sign
and quiets), so there only the NaN positions must agree. On the card the
kernel is held bitwise, NaN bits included, against the plain version on the
same device: that is ``tests/test_torch_kernels_gpu.py``, which imports no
JAX so that it runs on the machine with the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_combine as ref_block_combine
from repro.kernels import quantize as ref_quantize
from repro.kernels import ref as ref_jnp
from repro_torch.kernels import block_combine, quantize, ref

OPS = ["add", "max", "min", "mul"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "i32": (jnp.int32, torch.int32)}
SIZES = [1, 1000, 70001]


def _operands(rng, n, dt, count, op):
    """``count`` operands as (jax, torch) pairs of the same bits. Floats
    carry infinities: both signs for max/min, +inf only for add/mul, whose
    inf - inf would make NaNs (compared separately, by the casts' tests)."""
    jdt, tdt = DTYPES[dt]
    infs = (np.inf, -np.inf) if op in ("max", "min") else (np.inf,)
    out = []
    for _ in range(count):
        if dt == "i32":
            v = rng.integers(-1000, 1001, size=n).astype(np.int32)
        else:
            v = rng.standard_normal(n).astype(np.float32)
            for inf in infs:
                v[rng.random(n) < 0.02] = inf
        j = jnp.asarray(v).astype(jdt)
        raw = np.array(j).view({2: np.int16, 4: np.int32}[j.dtype.itemsize])
        out.append((j, torch.from_numpy(raw).view(tdt)))
    return out


def _bits(x) -> np.ndarray:
    """The raw bits of a torch or jax array, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        a = t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()
    else:
        a = np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_bitwise(got, want, msg=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    bad = np.count_nonzero(g != w)
    assert bad == 0, f"{msg}: {bad} of {g.size} elements differ in bits"


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_combine_plain_matches_reference(op, dt, n):
    rng = np.random.default_rng(n * 31 + OPS.index(op))
    (ja, ta), (jb, tb), (jc, tc) = _operands(rng, n, dt, 3, op)
    before = (block_combine.combine2.launches,
              block_combine.combine3.launches)
    got2 = block_combine.combine2(ta, tb, op=op)
    got3 = block_combine.combine3(ta, tb, tc, op=op)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert (block_combine.combine2.launches,
            block_combine.combine3.launches) == before
    _assert_bitwise(got2, ref_jnp.combine2_ref(ja, jb, op=op), "combine2_ref")
    _assert_bitwise(got3, ref_jnp.combine3_ref(ja, jb, jc, op=op),
                    "combine3_ref")
    _assert_bitwise(got2, ref_block_combine.combine2(ja, jb, op=op,
                                                     interpret=True),
                    "pallas combine2")
    _assert_bitwise(got3, ref_block_combine.combine3(ja, jb, jc, op=op,
                                                     interpret=True),
                    "pallas combine3")


def _cast_inputs(rng, n):
    special = np.array([0x7f800000, 0xff800000, 0x7fc00000, 0xffc00000,
                        0x7f800001, 0x00000001, 0x80000001, 0x007fffff,
                        0x00008000, 0x00018000, 0x3f808000, 0x3f818000,
                        0x3f808001, 0x00000000, 0x80000000, 0x7f7fffff],
                       np.uint32)   # inf, NaN, subnormals, ties, zeros, max
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([special, bits]).view(np.float32)


@pytest.mark.parametrize("n", [0, 1000, 70001])
def test_compress_plain_matches_reference(n):
    x = _cast_inputs(np.random.default_rng(n), n)
    got = quantize.compress_bf16(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = ref_quantize.compress_bf16(jnp.asarray(x), interpret=True)
    nan = np.isnan(x)
    g, w = _bits(got), _bits(want)
    assert np.array_equal(g[~nan], w[~nan])
    assert np.isnan(got.float().numpy()[nan]).all()
    _assert_bitwise(got, ref.compress_bf16_ref(torch.from_numpy(x)))


@pytest.mark.parametrize("n", [1000, 70001])
def test_decompress_plain_matches_reference(n):
    h = np.random.default_rng(n).integers(0, 2 ** 16, size=n,
                                          dtype=np.uint64).astype(np.uint16)
    t = torch.from_numpy(h.view(np.int16).copy()).view(torch.bfloat16)
    got = quantize.decompress_bf16(t)
    want = ref_quantize.decompress_bf16(jnp.asarray(h.view(jnp.bfloat16)),
                                        interpret=True)
    nan = np.isnan(np.asarray(want))
    assert np.array_equal(_bits(got)[~nan], _bits(want)[~nan])
    assert np.isnan(got.numpy()[nan]).all()
    # the exact embedding: the 16 bits move to the top of the word
    assert np.array_equal(_bits(got), h.astype(np.uint32) << 16)


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(8)
    with pytest.raises(ValueError):
        block_combine.combine2(a, torch.zeros(9))
    with pytest.raises(ValueError):
        block_combine.combine3(a, a, torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        block_combine.combine2(a.double(), a.double())
    with pytest.raises(ValueError):
        block_combine.combine2(a, a, op="sub")
    with pytest.raises(ValueError):
        block_combine.combine2(torch.zeros(4, 4).t(), torch.zeros(4, 4).t())
    with pytest.raises(TypeError):
        quantize.compress_bf16(a.bfloat16())
    with pytest.raises(TypeError):
        quantize.decompress_bf16(a)


def test_entry_points_refuse_a_missing_gpu():
    """No silent CPU fallback: without a card, asking for CUDA (or for no
    device at all) raises; ``device='cpu'`` is the explicit way to the CPU."""
    from repro_torch.core import LocalTransport
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTransport(4)
    with pytest.raises(RuntimeError):
        LocalTransport(4, device="cuda")
    assert LocalTransport(4, device="cpu").device.type == "cpu"
