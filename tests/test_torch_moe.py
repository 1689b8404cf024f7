"""The port's MoE sublayer against the JAX reference, on the CPU.

Reduced Mixtral-8x22B (4 experts, top-2, a sliding window) and reduced
Llama-4 Scout (4 experts, top-1, chunked RoPE layers and a global NoPE
layer). Parameters are the reference's ``init_params`` carried across with
``params_from_reference`` (or the port's own draw, held bitwise against
it); every other input is made by numpy from a seed.

Tolerances, on the reference's largest |value|:

* the routing (expert ids, the kept mask, each slot's destination in the
  reference's expert buffer): exactly equal, ties and drops included;
* one MoE sublayer's output and balance loss in f32: ``1e-5`` (the order
  of f32 sums);
* forward logits, ``loss_fn`` and its gradients: see
  ``tests/test_torch_moe_train.py``;
* prefill against decode at full capacity: ``3e-3`` relative and absolute,
  the bound of the reference's own test (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.interop import params_from_reference
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as optim

ARCHS = ("mixtral_8x22b", "llama4_scout_17b_a16e")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SUB_TOL = 1e-5
B, T = 2, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _err(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _configs(arch: str, dt: str = "f32", cf=None, impl=None,
             param_dt: str | None = None):
    """(reference cfg, port cfg): the reduced config with compute dtype
    ``dt``, parameters in ``param_dt`` (f32 by default), and the MoE's
    capacity factor and form where given."""
    jdt, tdt = DTYPES[dt]
    out = []
    for mod, ddt in ((ref_base, jdt), (base, tdt)):
        cfg = mod.get_config(arch, reduced=True)
        moe = cfg.moe
        if cf is not None:
            moe = dataclasses.replace(moe, capacity_factor=float(cf))
        if impl is not None:
            moe = dataclasses.replace(moe, impl=impl)
        kw = {}
        if param_dt is not None:
            kw["param_dtype"] = DTYPES[param_dt][0 if mod is ref_base else 1]
        out.append(dataclasses.replace(cfg, compute_dtype=ddt, moe=moe,
                                       **kw))
    return tuple(out)


_PARAMS: dict = {}


def _params(jcfg, seed: int = 0):
    """The reference's ``init_params`` and the port's copy, drawn once per
    config name, parameter dtype and seed (the MoE's capacity factor and
    form do not enter the draw)."""
    key = (jcfg.name, jnp.dtype(jcfg.param_dtype).name, seed)
    if key not in _PARAMS:
        jp = ref_tf.init_params(jax.random.PRNGKey(seed), jcfg)
        _PARAMS[key] = jp, params_from_reference(
            jax.tree.map(np.asarray, jp), device="cpu")
    jp, p = _PARAMS[key]
    return jp, jax.tree.map(lambda t: t.detach().clone(), p)


def _moe_sub(jp, p, cfg, pos: int = 0, period: int = 0):
    """Period ``period`` of the MoE sublayer at pattern position ``pos``,
    on both sides."""
    si = next(i for i, s in enumerate(cfg.pattern[pos]) if s.kind == "moe")
    return (jax.tree.map(lambda a: a[period], jp["layers"][pos][si]),
            tf._period(p["layers"][pos][si], period))


def _ref_route(logits, k: int, C: int) -> tuple:
    """The routing of the reference's ``_moe_dispatch``, its own lines:
    (top-k ids, order, kept mask, destinations)."""
    Bq, Tq, E = logits.shape
    _, topi = jax.lax.top_k(logits, k)
    eid = topi.reshape(Bq, Tq * k)
    order = jnp.argsort(eid, axis=1, stable=True)
    seid = jnp.take_along_axis(eid, order, axis=1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(E)))(seid)
    rank = jnp.arange(Tq * k)[None, :] - jnp.take_along_axis(
        starts, seid, axis=1)
    keep = rank < C
    dest = jnp.where(keep, seid * C + rank, E * C)
    return tuple(np.asarray(a) for a in (topi, order, keep, dest))


def _x(D: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)


def _sublayer_case(arch, cf, impl, zero_router=False):
    jcfg, cfg = _configs(arch, "f32", cf, impl)
    jp, p = _params(jcfg)
    jsp, sp = _moe_sub(jp, p, cfg)
    if zero_router:
        jsp = {**jsp, "router": jnp.zeros_like(jsp["router"])}
        sp = {**sp, "router": torch.zeros_like(sp["router"])}
    x = _x(cfg.d_model)
    fn = {"dispatch": ref_tf._moe_dispatch, "masked": ref_tf._moe_masked}
    want, waux = fn[impl](jsp, jnp.asarray(x), jcfg)
    got_fn = tf._moe_dispatch if impl == "dispatch" else tf._moe_masked
    with torch.no_grad():
        got, aux = got_fn(sp, torch.from_numpy(x), cfg)
    return jcfg, cfg, jsp, sp, x, (want, waux), (got, aux)


def _routes(jcfg, cfg, jsp, sp, x):
    C = tf.moe_capacity(cfg, T)
    assert C == int(np.ceil(T * jcfg.moe.top_k
                            * jcfg.moe.capacity_factor / jcfg.moe.n_experts))
    want = _ref_route(jnp.asarray(x) @ jsp["router"], jcfg.moe.top_k, C)
    with torch.no_grad():
        logits = torch.from_numpy(x) @ sp["router"]
        topi, _, order, _, keep, dest = tf.moe_route(logits,
                                                     cfg.moe.top_k, C)
    got = tuple(t.numpy() for t in (topi, order, keep, dest))
    return got, want


# ----------------------------------------------------------- one sublayer

@pytest.mark.parametrize("impl", ["dispatch", "masked"])
@pytest.mark.parametrize("cf", [None, 0.5, "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sublayer_matches_the_reference(arch, cf, impl):
    """The routing exactly, the output and the balance loss within 1e-5, at
    the config's capacity factor (1.25), at 0.5 (tokens drop) and at
    ``n_experts`` (none can)."""
    if cf == "full":
        cf = base.get_config(arch, reduced=True).moe.n_experts
    jcfg, cfg, jsp, sp, x, (want, waux), (got, aux) = _sublayer_case(
        arch, cf, impl)
    got_r, want_r = _routes(jcfg, cfg, jsp, sp, x)
    for g, w, name in zip(got_r, want_r, ("expert ids", "order", "kept",
                                          "destinations")):
        assert np.array_equal(g, w), name
    if cf == 0.5:
        assert not got_r[2].all(), "cf 0.5 drops no slot"
    if cf == cfg.moe.n_experts:
        assert got_r[2].all()
    assert _err(got, want) <= SUB_TOL
    assert _err(aux, waux) <= SUB_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_drops_contribute_nothing(arch):
    """At cf 0.5 the dispatch form drops slots; a token whose every choice
    is dropped gets exactly zero, and the rest are the reference's."""
    jcfg, cfg, jsp, sp, x, (want, _), (got, _) = _sublayer_case(
        arch, 0.5, "dispatch")
    (_, order, keep, _), _ = _routes(jcfg, cfg, jsp, sp, x)
    k = cfg.moe.top_k
    kept_tok = np.zeros((B, T), bool)
    for b in range(B):
        kept_tok[b, order[b][keep[b]] // k] = True
    assert (~kept_tok).any()
    assert not np.asarray(got)[~kept_tok].any()
    assert not np.asarray(want)[~kept_tok].any()
    assert _err(got, want) <= SUB_TOL


@pytest.mark.parametrize("impl", ["dispatch", "masked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lower_expert(arch, impl):
    """A zero router ties every logit: both sides take experts 0..k-1 for
    every token (``jax.lax.top_k``'s rule), and the dispatch form then
    drops what overflows their capacity."""
    jcfg, cfg, jsp, sp, x, (want, waux), (got, aux) = _sublayer_case(
        arch, None, impl, zero_router=True)
    (topi, _, keep, _), want_r = _routes(jcfg, cfg, jsp, sp, x)
    k = cfg.moe.top_k
    assert np.array_equal(topi, np.broadcast_to(np.arange(k), (B, T, k)))
    assert np.array_equal(topi, want_r[0])
    assert np.array_equal(keep, want_r[2])
    assert not keep.all()
    assert _err(got, want) <= SUB_TOL
    assert _err(aux, waux) <= SUB_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_equals_masked_at_full_capacity(arch):
    """The counterpart of the reference's
    ``test_moe_dispatch_equals_masked``: the two forms' forward at cf =
    n_experts, f32, within its 1e-4."""
    E = base.get_config(arch, reduced=True).moe.n_experts
    _, cfg_d = _configs(arch, "f32", E, "dispatch")
    _, cfg_m = _configs(arch, "f32", E, "masked")
    p = tf.init_params(cfg_d, 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg_d.vocab_size, (B, T)))
    with torch.no_grad():
        h1, a1 = tf.forward(p, cfg_d, {"tokens": toks})
        h2, a2 = tf.forward(p, cfg_m, {"tokens": toks})
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)
    assert float(a1) == pytest.approx(float(a2), rel=1e-6)


# ------------------------------------------------------------------ weights

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_are_the_references(arch, dt):
    """The port's own draw, every leaf: the same tree, shapes and dtypes
    (the router f32 whatever the parameter dtype), bitwise."""
    jcfg, cfg = _configs(arch, "bf16", param_dt=dt)
    want = ref_tf.init_params(jax.random.PRNGKey(5), jcfg)
    got = tf.init_params(cfg, 5, "cpu")
    wl, gl = jax.tree.leaves(want), optim.tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype) == "torch." + jnp.dtype(w.dtype).name
        w32 = np.asarray(w.astype(jnp.float32))
        assert np.array_equal(g.to(torch.float32).numpy(), w32)
    for pos in range(len(cfg.pattern)):
        moe = got["layers"][pos][1]
        E, D, Fd = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["router"].shape) == (cfg.n_periods, D, E)
        assert tuple(moe["w_in"].shape) == (cfg.n_periods, E, D, Fd)
        assert tuple(moe["w_out"].shape) == (cfg.n_periods, E, Fd, D)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_the_expert_stacks(arch):
    """The stacked expert leaves (n_periods, E, D, F) in bf16 and the f32
    router cross over with their bits, and back."""
    jcfg, _ = _configs(arch, "bf16", param_dt="bf16")
    jp, p = _params(jcfg)
    for jsub, sub in zip(jp["layers"], p["layers"]):
        moe, jmoe = sub[1], jsub[1]
        for name in ("router", "w_in", "w_out", "w_gate"):
            a, t = np.asarray(jmoe[name]), moe[name]
            assert tuple(t.shape) == a.shape
            assert str(t.dtype) == "torch." + a.dtype.name
            bits = np.int32 if a.dtype == np.float32 else np.int16
            back = t.view(torch.int32 if bits is np.int32 else torch.int16)
            assert np.array_equal(back.numpy(), a.view(bits)), name
        assert moe["w_in"].dim() == 4 and moe["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decode_at_full_capacity(arch):
    """The counterpart of the reference's
    ``test_moe_prefill_equals_decode_at_full_capacity``: with no slot
    dropped, the forward's last logits, the fixed-batch decode loop's and a
    slot prefill chunk's agree (f32 compute)."""
    E = base.get_config(arch, reduced=True).moe.n_experts
    _, cfg = _configs(arch, "f32", E)
    p = tf.init_params(cfg, 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T)))
    with torch.no_grad():
        hs, _ = tf.forward(p, cfg, {"tokens": toks})
        want = tf.unembed(p, cfg, hs)[:, -1].numpy()
        caches = tf.init_cache(cfg, B, 32, kv_dtype=torch.float32,
                               device="cpu")
        for t in range(T):
            logits, caches = tf.decode_step(p, cfg,
                                            {"tokens": toks[:, t:t + 1]},
                                            caches)
        slots = tf.init_cache(cfg, B, 32, kv_dtype=torch.float32,
                              device="cpu", per_slot=True)
        chunk, _ = tf.prefill_step(p, cfg, {"tokens": toks}, slots, [T] * B)
    np.testing.assert_allclose(logits.numpy(), want, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(chunk.numpy(), want, rtol=3e-3, atol=3e-3)


# --------------------------------------------------------------- refusals

def test_check_supported_takes_moe_and_refuses_the_rest():
    assert {"moe", "rwkv", "mamba"} <= set(tf.PORTED_KINDS)
    for arch in ARCHS + ("rwkv6_7b", "jamba_v0_1_52b"):
        for reduced in (False, True):
            cfg = base.get_config(arch, reduced=reduced)
            tf.check_supported(cfg)
            assert tf.supports_slot_serving(cfg)
            assert tf.supports_speculation(cfg)
    for arch in ("qwen2_vl_7b", "seamless_m4t_large_v2"):
        cfg = base.get_config(arch, reduced=True)
        with pytest.raises(NotImplementedError, match="item 3"):
            tf.check_supported(cfg)
