"""The port's Mamba sublayer and Jamba model against the JAX reference, on
the CPU.

Inputs are made by numpy from a seed and handed to both sides; parameters
come from the reference's ``mamba_init`` or ``init_params`` (carried
across as numpy arrays), except in the init test, which draws both. The
selective scan runs its plain version here
(``kernels.ref.mamba_scan_recurrent_ref``; the kernel is held against it
on the card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``).

Tolerances, on the largest |value| of the reference: f32 ``1e-5`` (both
sides compute in f32 and differ in the order of their sums and by a unit
of exp or log1p); the chunked form against the reference's chunked form
and against the recurrence ``1e-4`` (its log-depth scan sums in another
tree than ``associative_scan`` and than the sequential scan); with the
int8 K/V cache ``2**-7`` under f32 compute (a code may round the other
way). The Mamba block under bf16 compute, through the recurrence: its f32
scan state within ``1e-5`` and its bf16 output and conv window within one
bf16 unit of the largest, ``2**-8`` (its silu is the reference's ``x *
logistic(x)``, each op rounded in bf16, and only a unit of the f32 exp or
log1p can tip a rounding); through the chunked form within ``6 * 2**-8``
(the bound of ``tests/test_torch_models.py``). The whole model's
logits are held under f32 compute, as ``tests/test_torch_moe_serving.py``
holds the MoE models': under bf16 the reduced model's 16 sublayers (the
MLPs' and experts' ``F.silu`` rounds once where the reference's rounds
three times) put its router logits 1-3 % of their largest apart by the
first MoE sublayer, which routes tokens to other experts, and such a
token's logits differ wholly; the engine's bf16 streams follow the
margin rule of ``tests/_torch_engine_parity.py``
(``tests/test_torch_mamba_serving.py``). The init is bitwise the
reference's; within the port a pad token and a prompt split across calls
give the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.interop import params_from_reference
from repro_torch.kernels import mamba_scan, ref
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

ARCH = "jamba_v0_1_52b"
TOL = {"f32": 1e-5, "f32_int8": 2.0 ** -7, "bf16": 6 * 2.0 ** -8}
CHUNKED_TOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol: float, what: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: error {err:.3e} of max|ref| > {tol:.3e}"


def _same(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got, want), what


def _scan_inputs(seed: int, B=2, T=13, Di=16, N=8) -> tuple:
    """dt (a softplus's range), dtx, B, C, A (negative), a nonzero state and
    a (B, T) valid mask."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Di)) - 2)).astype(
        np.float32)
    dtx = (dt * rng.standard_normal((B, T, Di))).astype(np.float32)
    Bm, C = (rng.standard_normal((B, T, N)).astype(np.float32)
             for _ in range(2))
    A = -np.exp(rng.standard_normal((Di, N)) * 0.5).astype(np.float32)
    S0 = (rng.standard_normal((B, Di, N)) * 0.3).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    return dt, dtx, Bm, C, A, S0, valid


# ------------------------------------------------------------ the scans

@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_recurrence_matches_the_reference(masked, collect):
    dt, dtx, Bm, C, A, S0, valid = _scan_inputs(0)
    vm = valid if masked else None
    want = ref_ssm.mamba_scan_recurrent(
        *map(jnp.asarray, (dt, dtx, Bm, C, A, S0)),
        valid=None if vm is None else jnp.asarray(vm), collect=collect)
    got = ssm.mamba_scan_recurrent(
        *map(torch.from_numpy, (dt, dtx, Bm, C, A, S0)),
        valid=None if vm is None else torch.from_numpy(vm), collect=collect)
    _close(got[0], want[0], TOL["f32"], "y")
    _close(got[1], want[1], TOL["f32"], "states" if collect else "state")
    if collect:
        assert got[1].shape == (2, 13, 16, 8)
    if collect and masked:
        # a pad leaves the state bit-unchanged
        states = got[1]
        prev = torch.cat([torch.from_numpy(S0)[:, None], states[:, :-1]], 1)
        keep = ~torch.from_numpy(valid)
        assert torch.equal(states[keep], prev[keep])


def test_chunked_matches_the_reference_and_the_recurrence():
    dt, dtx, Bm, C, A, S0, _ = _scan_inputs(1, T=64)
    args = tuple(map(torch.from_numpy, (dt, dtx, Bm, C, A, S0)))
    rec = ssm.mamba_scan_recurrent(*args)
    for chunk in (32, 64):
        want = ref_ssm.mamba_scan_chunked(
            *map(jnp.asarray, (dt, dtx, Bm, C, A, S0)), chunk=chunk)
        got = ssm.mamba_scan_chunked(*args, chunk=chunk)
        _close(got[0], want[0], CHUNKED_TOL, f"y, chunks of {chunk}")
        _close(got[1], want[1], CHUNKED_TOL, f"state, chunks of {chunk}")
        _close(got[0], rec[0], CHUNKED_TOL, "chunked y against the scan")
        _close(got[1], rec[1], CHUNKED_TOL, "chunked state against the scan")
    with pytest.raises(ValueError, match="multiple"):
        ssm.mamba_scan_chunked(*args, chunk=48)
    # the chunked form carries a gradient (training takes it)
    dtg = args[0].clone().requires_grad_(True)
    y, _ = ssm.mamba_scan_chunked(dtg, *args[1:], chunk=32)
    y.square().sum().backward()
    assert torch.isfinite(dtg.grad).all() and dtg.grad.abs().sum() > 0


def test_scan_wrapper_refuses_bad_inputs():
    dt, dtx, Bm, C, A, S0, valid = map(torch.from_numpy, _scan_inputs(2))
    with pytest.raises(ValueError, match="one shape"):
        mamba_scan.mamba_scan(dt, dtx[:, :3], Bm, C, A, S0)
    with pytest.raises(ValueError, match="A"):
        mamba_scan.mamba_scan(dt, dtx, Bm, C, A[:3], S0)
    with pytest.raises(ValueError, match="state"):
        mamba_scan.mamba_scan(dt, dtx, Bm, C, A, S0[:1])
    with pytest.raises(TypeError, match="f32"):
        mamba_scan.mamba_scan(dt, dtx.double(), Bm, C, A, S0)
    with pytest.raises(ValueError, match="valid"):
        mamba_scan.mamba_scan(dt, dtx, Bm, C, A, S0, valid.to(torch.int32))
    y, S = mamba_scan.mamba_scan(dt, dtx, Bm, C, A, S0, valid)
    want = ref.mamba_scan_recurrent_ref(dt, dtx, Bm, C, A, S0, valid)
    _same(y, want[0], "y")
    _same(S, want[1], "state")
    # Jamba's chunk: 6 f32 operations and one exp a state element and token
    assert mamba_scan.work(1, 1024, 8192, 16)[1] == 7 * 1024 * 8192 * 16


def test_scan_errors_pass_the_plain_version_and_catch_wrong_ones():
    """The kernel's check (``mamba_scan.scan_errors`` within ``SCAN_TOL``
    and ``SCAN_STATE_TOL``): the plain version passes itself, with
    collected states too; a scan that updates the state at a pad, that
    reads y off the state before its token, or that drops the skip of
    ``dtx B`` fails it."""
    dt, dtx, Bm, C, A, S, valid = map(torch.from_numpy,
                                      _scan_inputs(3, T=40, Di=32, N=16))
    args = (dt, dtx, Bm, C, A, S, valid)
    for collect in (False, True):
        got = ref.mamba_scan_recurrent_ref(*args, collect=collect)
        assert mamba_scan.scan_errors(got, *args, collect=collect) == (0.0,
                                                                        0.0)
    y, states = ref.mamba_scan_recurrent_ref(*args, collect=True)
    prev = torch.cat([S[:, None], states[:, :-1]], 1)
    wrong = {
        "pads update": ref.mamba_scan_recurrent_ref(dt, dtx, Bm, C, A, S),
        "y before the token": ((prev * C[:, :, None]).sum(-1), states[:, -1]),
        "no input": ref.mamba_scan_recurrent_ref(dt, torch.zeros_like(dtx),
                                                 Bm, C, A, S, valid),
    }
    for what, got in wrong.items():
        e_y, e_s = mamba_scan.scan_errors(got, *args)
        assert e_y > mamba_scan.SCAN_TOL or \
            e_s > mamba_scan.SCAN_STATE_TOL, (what, e_y, e_s)


@pytest.mark.parametrize("N", mamba_scan.D_STATES)
def test_kernel_plan_covers_every_state_once_in_an_order_fixed_by_n(N):
    """``mamba_scan.plan``, the kernel's launch, for B in 1..16, T at and
    around the direct path's 8 tokens, a warp's 32 and a chunk's 1,024, Di
    128 and 8192: its blocks' threads own every (row, channel, quad of
    states) exactly once (``mamba_scan.state_quads``, the kernel's thread map),
    the order of y's sum (``ORDER``: 4 states a lane, then the butterfly
    over N / 4 lanes) is N's alone, the threads are whole warps, the tile
    is 1 to ``min(T, 64)`` tokens and the shared memory fits the card's
    227 KB; short calls take the direct path (no stages, no shared
    memory), and one row of Jamba's 8192 channels still fills the card. A
    forced plan is honoured; what the kernel does not take raises."""
    assert mamba_scan.ORDER[N] == (4, N // 4)
    maps = {}
    for Di in (128, 8192):
        for B in range(1, 17):
            for T in (1, 5, 8, 9, 31, 32, 33, 1024):
                p = mamba_scan.plan(B, T, Di, N)
                assert (p.quad, p.lanes) == mamba_scan.ORDER[N]
                assert p.channels in mamba_scan.CHANNELS
                assert Di % p.channels == 0
                assert p.threads == p.channels * p.lanes
                assert p.threads % 32 == 0 and p.threads <= 256
                assert 1 <= p.tile <= min(T, mamba_scan.MAX_TILE)
                if T <= mamba_scan.DIRECT_TOKENS:
                    assert (p.tile, p.stages, p.smem) == (1, 0, 0)
                    assert p.threads <= mamba_scan.DIRECT_THREADS
                else:
                    assert p.stages == min(-(-T // p.tile), 3)
                    assert 0 < p.smem <= mamba_scan.MAX_SMEM
                assert p.blocks == B * Di // p.channels
                maps[(B, Di, p.channels)] = p
    for (B, Di, _), p in maps.items():
        own = mamba_scan.state_quads(p, B, Di)
        assert own.shape == (p.blocks * p.threads, 3)
        slot = (own[:, 0] * Di + own[:, 1]) * N + own[:, 2]
        assert (own[:, 2] % p.quad == 0).all()
        counts = torch.bincount(slot // p.quad, minlength=B * Di * N // 4)
        assert (counts == 1).all(), p
    chunk = mamba_scan.plan(1, 1024, 8192, N)
    assert chunk.blocks >= mamba_scan.MIN_BLOCKS
    assert chunk.tile == mamba_scan.MAX_TILE and chunk.stages == 3
    forced = mamba_scan.plan(1, 1024, 8192, N, tile=7, channels=16)
    assert (forced.tile, forced.channels, forced.blocks) == (7, 16, 512)
    assert (forced.quad, forced.lanes) == mamba_scan.ORDER[N]
    assert mamba_scan.plan(8, 1, 8192, N, staged=True).stages == 1
    assert mamba_scan.plan(1, 1024, 8192, N, staged=False).stages == 0
    with pytest.raises(ValueError, match="N in"):
        mamba_scan.plan(1, 8, 128, 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        mamba_scan.plan(1, 8, 24, N)
    with pytest.raises(ValueError, match="channels"):
        mamba_scan.plan(1, 8, 48, N, channels=32)
    with pytest.raises(ValueError, match="tile"):
        mamba_scan.plan(1, 80, 128, N, tile=65)
    with pytest.raises(ValueError, match="a token at a time"):
        mamba_scan.plan(1, 80, 128, N, tile=8, staged=False)


def test_softplus_and_the_a_log_ladder_are_the_references():
    x = np.concatenate([np.linspace(-30, 30, 2001),
                        np.random.default_rng(4).standard_normal(999) * 5]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm._softplus(torch.from_numpy(x)).numpy()
    # a unit of exp or log1p between the two libraries, at most
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)
    n = np.arange(1, 17, dtype=np.float32)
    assert np.array_equal(ssm._log_f32(torch.from_numpy(n)).numpy().view(
        np.int32), np.asarray(jnp.log(jnp.asarray(n))).view(np.int32))


# ------------------------------------------------------------ the block

MCFG = dict(d_model=16, d_state=8)


def _block_params(seed: int = 0) -> tuple:
    """The reference's block parameters with a random conv bias and skip
    (its init sets them constant), and the port's copy."""
    mcfg = ref_ssm.MambaConfig(**MCFG)
    jp = jax.tree.map(np.asarray, ref_ssm.mamba_init(
        jax.random.PRNGKey(seed), mcfg))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "D_skip"):
        jp[name] = rng.standard_normal(jp[name].shape).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return mcfg, ssm.MambaConfig(**MCFG), jp, tp


def _cache(seed: int, B: int) -> dict:
    rng = np.random.default_rng(seed)
    Di, N = 2 * MCFG["d_model"], MCFG["d_state"]
    return {"conv": rng.standard_normal((B, 3, Di)).astype(np.float32),
            "ssm": (rng.standard_normal((B, Di, N)) * 0.3).astype(
                np.float32)}


CASES = {
    # (T, a cache, lengths, collect_states): the chunked form (chunks of 32,
    # and one of T), a decode tick with and without a cache, a padded
    # prefill chunk and a verify call
    "chunked": (64, False, None, False),
    "one_chunk": (13, False, None, False),
    "decode": (1, True, None, False),
    "first_token": (1, False, None, False),
    "lengths": (16, True, (11, 2), False),
    "collect": (5, True, (5, 3), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_block_matches_the_reference(case):
    T, cached, lens, collect = CASES[case]
    jcfg, cfg, jp, tp = _block_params()
    x = np.random.default_rng(3).standard_normal((2, T, 16)).astype(
        np.float32)
    _block_case(jcfg, cfg, jp, tp, x, _cache(4, 2) if cached else None,
                lens, collect,
                CHUNKED_TOL if case in ("chunked", "one_chunk")
                else TOL["f32"])


@pytest.mark.parametrize("T", [1, 13, 64])
def test_block_under_bf16_is_the_references(T):
    """bf16 weights and activations: through the recurrence (a decode tick
    from a cache, a padded chunk, a verify call) the f32 state within
    ``1e-5`` and the output and conv window within a bf16 unit; the
    chunked form at T = 64 within the bf16 bound."""
    jcfg, cfg, jp, tp = _block_params()
    jp = {k: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
          if k not in ("conv_b", "dt_bias", "A_log", "D_skip") else a
          for k, a in jp.items()}
    tp = params_from_reference(jp, device="cpu")
    x = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, T, 16)), jnp.bfloat16))
    c = {k: np.asarray(jnp.asarray(a, jnp.bfloat16)) if k == "conv" else a
         for k, a in _cache(4, 2).items()}
    if T == 64:
        _block_case(jcfg, cfg, jp, tp, x, None, None, False, TOL["bf16"])
        return
    for lens, collect in ((None, False), ((T, max(1, T - 5)), False),
                          ((T, 1), True)):
        _block_case(jcfg, cfg, jp, tp, x, c, lens, collect, 2.0 ** -8,
                    TOL["f32"])


def _block_case(jcfg, cfg, jp, tp, x, c, lens, collect, tol,
                state_tol=None) -> None:
    """One ``mamba_block`` call on both sides: its output and conv window
    within ``tol`` of the reference's largest |value|, its scan state
    within ``state_tol`` (``tol`` where None)."""
    want_x, want_c = ref_ssm.mamba_block(
        jp, jnp.asarray(x), jcfg,
        None if c is None else jax.tree.map(jnp.asarray, c),
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
        collect_states=collect)
    got_x, got_c = ssm.mamba_block(
        tp, params_from_reference(x, device="cpu"), cfg,
        None if c is None else params_from_reference(c, device="cpu"),
        lengths=None if lens is None else torch.tensor(lens),
        collect_states=collect)
    T = x.shape[1]
    _close(got_x, want_x, tol, "out")
    _close(got_c["conv"], want_c["conv"], tol, "conv")
    _close(got_c["ssm"], want_c["ssm"], tol if state_tol is None
           else state_tol, "ssm")
    if collect:
        assert got_c["conv"].shape == (2, T, 3, 32)
        assert got_c["ssm"].shape == (2, T, 32, 8)


def test_pads_and_split_calls_give_one_calls_bits():
    """The serving-prefill contract: with ``lengths``, right pads leave the
    conv window and the scan state bit-unchanged, and a prompt split across
    calls carries the same bits as one call over it."""
    _, cfg, _, tp = _block_params(1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 16)).astype(np.float32))
    c0 = {k: torch.zeros_like(torch.from_numpy(a))
          for k, a in _cache(0, 2).items()}

    def run(xs, cache, n):
        return ssm.mamba_block(tp, xs, cfg, cache,
                               lengths=torch.tensor([n, n]))

    out_pad, pad = run(x, c0, 11)
    out_exact, exact = run(x[:, :11], c0, 11)
    _, c1 = run(x[:, :2], c0, 2)
    out2, c2 = run(x[:, 2:11], c1, 9)
    for name in ("conv", "ssm"):
        _same(pad[name], exact[name], f"{name}: pads against none")
        _same(c2[name], exact[name], f"{name}: two calls against one")
    _same(out_pad[:, :11], out_exact, "outputs: pads against none")
    _same(out2, out_exact[:, 2:], "outputs: two calls against one")


# ------------------------------------------------------------ the model

def _configs(dt: str, **kw):
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(ref_base.get_config(ARCH, reduced=True),
                               compute_dtype=jdt, **kw)
    cfg = dataclasses.replace(base.get_config(ARCH, reduced=True),
                              compute_dtype=tdt, **kw)
    return jcfg, cfg


def test_check_supported_takes_both_jamba_configs():
    for reduced in (False, True):
        cfg = base.get_config(ARCH, reduced=reduced)
        tf.check_supported(cfg)
        assert tf.supports_slot_serving(cfg) and tf.supports_speculation(cfg)
        assert tf.cache_layer_kinds(cfg) == ("mamba",) * 4 + ("attn",) + \
            ("mamba",) * 3
        m = cfg.mamba_cfg()
        assert (m.d_inner, m.dt_rank, m.d_conv) == (
            (8192, 256, 4) if not reduced else (128, 4, 4))


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_init_params_are_the_references_bit_for_bit(param_dtype):
    jcfg, cfg = _configs("bf16", param_dtype=DTYPES[param_dtype][0])
    cfg = dataclasses.replace(cfg, param_dtype=DTYPES[param_dtype][1])
    want = params_from_reference(
        jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0),
                                                    jcfg)), device="cpu")
    got = tf.init_params(cfg, 0, "cpu")
    assert set(got["layers"][0][0]) == {
        "norm", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
        "dt_bias", "A_log", "D_skip", "out_proj"}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        _same(g, flat_want[path], jax.tree_util.keystr(path))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_and_decode_logits_match_the_reference(kv_quant):
    """Under f32 compute: ``forward`` at T = 64 (the chunked form) and 13
    (one chunk), and six ``decode_step`` ticks with the K/V cache in bf16
    or int8, their logits and the Mamba caches against the jitted
    reference's."""
    dt = "f32"
    jcfg, cfg = _configs(dt, kv_quant=kv_quant)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    tol = TOL[dt + ("_int8" if kv_quant else "")]
    rng = np.random.default_rng(7)
    if not kv_quant:                # the forward has no K/V cache
        for T in (64, 13):
            toks = rng.integers(1, cfg.vocab_size, (2, T))
            hx, _ = ref_tf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
            want = ref_tf.unembed(jp, jcfg, hx).astype(jnp.float32)
            with torch.no_grad():
                h, _ = tf.forward(p, cfg, {"tokens": torch.from_numpy(toks)})
                got = tf.unembed(p, cfg, h).to(torch.float32)
            _close(got, want, max(tol, CHUNKED_TOL), f"forward T={T}")
    jc = ref_tf.init_cache(jcfg, 3, 16)
    caches = tf.init_cache(cfg, 3, 16, device="cpu")
    step = jax.jit(lambda p_, i, c: ref_tf.decode_step(p_, jcfg, i, c))
    toks = rng.integers(1, cfg.vocab_size, (3, 6))
    for t in range(toks.shape[1]):
        want, jc = step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc)
        with torch.no_grad():
            got, caches = tf.decode_step(
                p, cfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                caches)
        _close(got, want, tol, f"decode step {t}")
    kinds = tf.cache_layer_kinds(cfg)
    for c, jcache, kind in zip(caches, jc, kinds):
        if kind == "mamba":
            for name in ("conv", "ssm"):
                _close(c[name], jcache[name], tol, f"{kind} {name}")
    if kv_quant:
        assert caches[kinds.index("attn")]["k"].dtype == torch.int8
