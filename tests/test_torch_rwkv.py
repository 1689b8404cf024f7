"""The port's RWKV-6 sublayer and model against the JAX reference, on the CPU.

Inputs are made by numpy from a seed and handed to both sides; parameters
come from the reference's ``rwkv_block_init`` or ``init_params`` (carried
across as numpy arrays), except in the init test, which draws both. The
WKV recurrence runs its plain version here
(``kernels.ref.wkv6_recurrent_ref``; the kernel is held against it on the
card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``).

Tolerances, on the largest |value| of the reference: f32 ``1e-5`` (both
sides compute in f32 and differ in the order of their sums); bf16 compute
``6 * 2**-8`` (the bound of ``tests/test_torch_models.py``: each bf16
stage rounds to 2**-8 relative, at other points in the two frameworks).
Within the port, a pad token, a prompt split across calls and a verify
call against decode ticks give the same bits (the contract the slot paths
rest on).
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
from repro_torch.kernels import ref, wkv
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

TOL = {"f32": 1e-5, "bf16": 6 * 2.0 ** -8}
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


def _wkv_inputs(seed: int, B=2, T=13, H=3, K=8) -> tuple:
    """r, k, v, w_log, u, a nonzero state and a (B, T) valid mask."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) * 0.5
               for _ in range(3))
    w_log = np.clip(-np.exp(rng.standard_normal((B, T, H, K))), -8,
                    -1e-4).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    S0 = (rng.standard_normal((B, H, K, K)) * 0.3).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    return r, k, v, w_log, u, S0, valid


# ------------------------------------------------------------ recurrences

@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_recurrence_matches_the_reference(masked, collect):
    r, k, v, w, u, S0, valid = _wkv_inputs(0)
    vm = valid if masked else None
    want = ref_ssm.wkv_recurrent(
        *map(jnp.asarray, (r, k, v, w, u, S0)),
        valid=None if vm is None else jnp.asarray(vm), collect=collect)
    got = ssm.wkv_recurrent(
        *map(torch.from_numpy, (r, k, v, w, u, S0)),
        valid=None if vm is None else torch.from_numpy(vm), collect=collect)
    _close(got[0], want[0], TOL["f32"], "o")
    _close(got[1], want[1], TOL["f32"], "states" if collect else "state")
    if collect and masked:
        # a pad leaves the state bit-unchanged
        states = got[1]
        prev = torch.cat([torch.from_numpy(S0)[:, None], states[:, :-1]], 1)
        keep = ~torch.from_numpy(valid)
        assert torch.equal(states[keep], prev[keep])


def test_chunked_matches_the_reference_and_the_recurrence():
    r, k, v, w, u, S0, _ = _wkv_inputs(1, T=64)
    want = ref_ssm.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, S0)),
                               chunk=16)
    args = tuple(map(torch.from_numpy, (r, k, v, w, u, S0)))
    got = ssm.wkv_chunked(*args, chunk=16)
    _close(got[0], want[0], TOL["f32"], "o")
    _close(got[1], want[1], TOL["f32"], "state")
    # the two forms, as the reference's own test holds them
    rec = ssm.wkv_recurrent(*args)
    _close(got[0], rec[0], 2e-4, "chunked o against the recurrence")
    _close(got[1], rec[1], 2e-4, "chunked state against the recurrence")


def test_recurrence_wrapper_refuses_bad_inputs():
    r, k, v, w, u, S0, valid = map(torch.from_numpy, _wkv_inputs(2))
    with pytest.raises(ValueError, match="one shape"):
        wkv.wkv6(r, k[:, :3], v, w, u, S0)
    with pytest.raises(ValueError, match="state"):
        wkv.wkv6(r, k, v, w, u, S0[:1])
    with pytest.raises(TypeError, match="f32 or bf16"):
        wkv.wkv6(r, k.to(torch.bfloat16), v, w, u, S0)
    with pytest.raises(TypeError, match="w_log, u and state"):
        wkv.wkv6(r, k, v, w.double(), u, S0)
    with pytest.raises(ValueError, match="valid"):
        wkv.wkv6(r, k, v, w, u, S0, valid.to(torch.int32))
    # bf16 inputs: the output in bf16, the state in f32
    o, S = wkv.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, S0)
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    want = ref.wkv6_recurrent_ref(r.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  w, u, S0)
    _same(o, want[0], "bf16 o")
    assert wkv.work(1, 1024, 64, 64)[1] == 1024 * 64 * (5 * 64 * 64
                                                       + 5 * 64)


@pytest.mark.parametrize("K", wkv.HEAD_DIMS)
def test_kernel_plan_covers_the_state_once_in_an_order_fixed_by_k(K):
    """``wkv.plan``, the kernel's launch, for B in 1..32, H 4 and 64, T at
    and around a tile's 32 and a chunk's 1,024, bf16 and f32 inputs: its
    blocks' threads own every element of a head's state exactly once
    (``wkv.state_tiles``, the kernel's thread map), the rows a thread sums
    in order (what fixes every sum's order) are K's alone, the owner and
    helper threads are whole warps, the tile is at most T and 32 tokens and
    the shared memory fits the card's 227 KB; the column grouping follows B
    H, so one row of 64 heads still fills the card."""
    seen_plans = set()
    for H in (4, 64):
        for B in range(1, 33):
            for T in (1, 5, 31, 32, 33, 1024):
                for itemsize in (2, 4):
                    p = wkv.plan(B, T, H, K, itemsize)
                    assert p.rows == wkv.ROWS[K]
                    assert K % p.group == 0 and p.group >= 16
                    assert p.owners == K // p.rows * p.group // p.cols
                    assert p.owners % 32 == 0 and p.threads % 32 == 0
                    assert 1 <= p.tile <= min(T, wkv.MAX_TILE)
                    assert 0 < p.smem <= wkv.MAX_SMEM
                    assert p.blocks == B * H * (K // p.group)
                    seen_plans.add(p)
    for p in seen_plans:
        owned = np.zeros((K, K), np.int64)
        for r0, c0 in wkv.state_tiles(p, K):
            owned[r0:r0 + p.rows, c0:c0 + 4] += 1
        assert (owned == 1).all(), p
    if K == 64:
        assert {p.group for p in seen_plans} == {16, 32, 64}
        assert wkv.plan(1, 1024, 64, 64).blocks >= wkv.MIN_BLOCKS
        assert wkv.plan(1, 1024, 64, 64).tile == wkv.MAX_TILE
        assert wkv.plan(8, 1, 64, 64).group == 64
    with pytest.raises(ValueError, match="K in"):
        wkv.plan(1, 1, 4, 48)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wkv_errors_pass_the_plain_version_and_catch_wrong_ones(dt):
    """The kernel's check (``wkv.wkv_errors`` within ``WKV_TOL`` and
    ``WKV_STATE_TOL``): the plain version passes itself, with collected
    states too; a recurrence that drops the bonus ``u``, that updates the
    state at a pad, or that reads the state after its token fails it."""
    r, k, v, w, u, S, valid = map(torch.from_numpy, _wkv_inputs(3, T=40,
                                                                K=16))
    r, k, v = (t.to(DTYPES[dt][1]) for t in (r, k, v))
    args = (r, k, v, w, u, S, valid)
    tol = wkv.WKV_TOL[r.dtype]
    for collect in (False, True):
        got = ref.wkv6_recurrent_ref(*args, collect=collect)
        assert wkv.wkv_errors(got, *args, collect=collect) == (0.0, 0.0)
    wrong = {
        "no bonus": ref.wkv6_recurrent_ref(r, k, v, w, torch.zeros_like(u),
                                           S, valid),
        "pads update": ref.wkv6_recurrent_ref(r, k, v, w, u, S),
    }
    o, states = ref.wkv6_recurrent_ref(*args, collect=True)
    o_after = (r.float()[..., None] * states).sum(-2).to(r.dtype)
    wrong["state after the token"] = (o_after, states[:, -1])
    for what, got in wrong.items():
        e_o, e_s = wkv.wkv_errors(got, *args)
        assert e_o > tol or e_s > wkv.WKV_STATE_TOL, (what, e_o, e_s)


# ------------------------------------------------------------ the block

RCFG = dict(d_model=32, head_dim=8)


def _block_params(seed: int = 0) -> tuple:
    """The reference's block parameters with random mixing weights and
    bonus (its init sets them constant), and the port's copy."""
    rcfg = ref_ssm.RWKVConfig(**RCFG)
    jp = jax.tree.map(np.asarray, ref_ssm.rwkv_block_init(
        jax.random.PRNGKey(seed), rcfg))
    rng = np.random.default_rng(seed)
    for part in ("tmix", "cmix"):
        for name, a in jp[part].items():
            if name.startswith("mu_") or name == "u":
                jp[part][name] = rng.random(a.shape).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return rcfg, ssm.RWKVConfig(**RCFG), jp, tp


def _cache(seed: int, B: int) -> dict:
    rng = np.random.default_rng(seed)
    D, H, K = RCFG["d_model"], RCFG["d_model"] // RCFG["head_dim"], \
        RCFG["head_dim"]
    return {"shift1": rng.standard_normal((B, 1, D)).astype(np.float32),
            "shift2": rng.standard_normal((B, 1, D)).astype(np.float32),
            "state": (rng.standard_normal((B, H, K, K)) * 0.3).astype(
                np.float32)}


CASES = {
    # (T, a cache, lengths, collect_states): the chunked form and the
    # recurrence without a cache, a decode tick, a padded prefill chunk and
    # a verify call
    "chunked": (64, False, None, False),
    "recurrent": (13, False, None, False),
    "decode": (1, True, None, False),
    "lengths": (16, True, (11, 5), False),
    "collect": (5, True, (5, 3), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_block_matches_the_reference(case):
    T, cached, lens, collect = CASES[case]
    jcfg, cfg, jp, tp = _block_params()
    x = np.random.default_rng(3).standard_normal((2, T, 32)).astype(
        np.float32)
    c = _cache(4, 2) if cached else None
    want_x, want_c = ref_ssm.rwkv_block(
        jp, jnp.asarray(x), jcfg,
        None if c is None else jax.tree.map(jnp.asarray, c),
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
        collect_states=collect)
    got_x, got_c = ssm.rwkv_block(
        tp, torch.from_numpy(x), cfg,
        None if c is None else {k: torch.from_numpy(a) for k, a in c.items()},
        lengths=None if lens is None else torch.tensor(lens),
        collect_states=collect)
    _close(got_x, want_x, TOL["f32"], "x")
    for name in ("shift1", "shift2", "state"):
        _close(got_c[name], want_c[name], TOL["f32"], name)


def test_pads_and_split_calls_give_one_calls_bits():
    """The serving-prefill contract (``tests/test_models.py``'s
    ``test_ssm_blocks_pad_and_chunk_invariant``): with ``lengths``, right
    pads leave the carries bit-unchanged, and a prompt split across calls
    carries the same bits as one call over it."""
    _, cfg, _, tp = _block_params(1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 32)).astype(np.float32))
    c0 = {k: torch.zeros_like(torch.from_numpy(a))
          for k, a in _cache(0, 2).items()}

    def run(xs, cache, n):
        return ssm.rwkv_block(tp, xs, cfg, cache,
                              lengths=torch.tensor([n, n]))

    _, pad = run(x, c0, 11)
    _, exact = run(x[:, :11], c0, 11)
    _, c1 = run(x[:, :6], c0, 6)
    _, c2 = run(x[:, 6:11], c1, 5)
    for name in ("shift1", "shift2", "state"):
        _same(pad[name], exact[name], f"{name}: pads against none")
        _same(c2[name], exact[name], f"{name}: two calls against one")


# ------------------------------------------------------------ the model

def _configs(dt: str):
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(ref_base.get_config("rwkv6_7b", reduced=True),
                               compute_dtype=jdt)
    cfg = dataclasses.replace(base.get_config("rwkv6_7b", reduced=True),
                              compute_dtype=tdt)
    return jcfg, cfg


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_init_params_are_the_references_bit_for_bit(param_dtype):
    jcfg, cfg = _configs("bf16")
    jcfg = dataclasses.replace(jcfg, param_dtype=DTYPES[param_dtype][0])
    cfg = dataclasses.replace(cfg, param_dtype=DTYPES[param_dtype][1])
    want = params_from_reference(
        jax.tree.map(np.asarray, ref_tf.init_params(jax.random.PRNGKey(0),
                                                    jcfg)), device="cpu")
    got = tf.init_params(cfg, 0, "cpu")
    assert "norm" not in got["layers"][0][0]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        w = dict(jax.tree_util.tree_flatten_with_path(want)[0])[path]
        _same(g, w, jax.tree_util.keystr(path))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_and_decode_logits_match_the_reference(dt):
    jcfg, cfg = _configs(dt)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    for T in (64, 13):                       # the chunked form, the recurrence
        toks = rng.integers(1, cfg.vocab_size, (2, T))
        hx, _ = ref_tf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        want = ref_tf.unembed(jp, jcfg, hx).astype(jnp.float32)
        with torch.no_grad():
            h, _ = tf.forward(p, cfg, {"tokens": torch.from_numpy(toks)})
            got = tf.unembed(p, cfg, h).to(torch.float32)
        _close(got, want, TOL[dt], f"forward T={T}")
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
        _close(got, want, TOL[dt], f"decode step {t}")
    for name in ("shift1", "shift2", "state"):
        _close(caches[0][name], jc[0][name], TOL[dt], name)
