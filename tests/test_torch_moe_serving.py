"""The port's MoE models on its serving paths, against the JAX reference and
within the port, on the CPU.

Reduced Mixtral-8x22B (4 experts, top-2, a window of 16) and reduced
Llama-4 Scout (4 experts, top-1, chunks of 16 and a global NoPE layer) with
the reference's parameters (``params_from_reference``):

* the fixed-batch and the slot decode steps against the reference's, f32
  compute within ``1e-5`` of the largest |logit| (``2**-7`` with the int8
  cache: the bound of ``tests/test_torch_models.py``);
* the continuous engine's greedy streams and counters against the JAX
  engine's through ``tests/_torch_engine_parity.py``: under f32 exactly
  equal, with speculation in one case; under bf16 by that harness's margin
  rule. The config's own capacity factor (1.25) drops slots in prefill
  chunks, so the two engines' routing must agree there too;
* a verify call and decode ticks, and a prefill chunk and decode ticks,
  within the port at full capacity: within ``1e-5`` (on the CPU a product
  of another row count may sum in another order; on the card
  ``layers.serve_rows`` makes the rows bitwise equal, which the GPU tests
  check);
* ``serve.py`` end to end with ``--arch mixtral_8x22b`` and ``--arch
  llama4_scout_17b_a16e``, fixed-batch and ``--continuous``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_engine_parity as par
from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

ARCHS = ("mixtral_8x22b", "llama4_scout_17b_a16e")
TOL = {"f32": 1e-5, "f32_int8": 2.0 ** -7}


def _moe_cfg(mod, arch, param_dtype, **kw):
    return dataclasses.replace(mod.get_config(arch, reduced=True),
                               param_dtype=param_dtype, **kw)


# the engine harness's configs for the MoE archs: bf16 compute (the
# configs' own) and f32 compute, f32 parameters as the harness draws them
MOE_CONFIGS = {}
for _arch, _short in (("mixtral_8x22b", "mixtral"),
                      ("llama4_scout_17b_a16e", "scout")):
    MOE_CONFIGS[_short] = lambda a=_arch: (
        _moe_cfg(ref_base, a, jnp.bfloat16),
        _moe_cfg(base, a, torch.bfloat16))
    MOE_CONFIGS[_short + "_f32"] = lambda a=_arch: (
        _moe_cfg(ref_base, a, jnp.float32, compute_dtype=jnp.float32),
        _moe_cfg(base, a, torch.float32, compute_dtype=torch.float32))


@pytest.fixture
def moe_configs(monkeypatch):
    """The MoE configs in the harness's ``CONFIGS`` for one test only: the
    other engine tests parametrize over that dict when they are collected,
    so it must not change while files are imported."""
    for name, make in MOE_CONFIGS.items():
        monkeypatch.setitem(par.CONFIGS, name, make)


def _err(got, want) -> float:
    g = got.detach().to(torch.float32).numpy()
    w = np.asarray(want).astype(np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ----------------------------------------------------------- decode steps

@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch, kv_quant):
    """Twelve decode steps on the fixed-batch path and on the slot path
    (per-slot caches), each against the reference's own, f32 compute."""
    jcfg = _moe_cfg(ref_base, arch, jnp.float32, compute_dtype=jnp.float32,
                    kv_quant=kv_quant)
    cfg = _moe_cfg(base, arch, torch.float32, compute_dtype=torch.float32,
                   kv_quant=kv_quant)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    tol = TOL["f32_int8" if kv_quant else "f32"]
    Bq, S, steps = 3, 24, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (Bq, steps)).astype(np.int32)
    jstep = jax.jit(lambda q, i, c: ref_tf.decode_step(q, jcfg, i, c))
    jc = ref_tf.init_cache(jcfg, Bq, S, kv_dtype=jnp.float32)
    c = tf.init_cache(cfg, Bq, S, kv_dtype=torch.float32, device="cpu")
    js = ref_tf.init_cache(jcfg, Bq, S, kv_dtype=jnp.float32, per_slot=True)
    cs = tf.init_cache(cfg, Bq, S, kv_dtype=torch.float32, device="cpu",
                       per_slot=True)
    for t in range(steps):
        inp = toks[:, t:t + 1]
        want, jc = jstep(jp, {"tokens": jnp.asarray(inp)}, jc)
        with torch.no_grad():
            got, c = tf.decode_step(p, cfg, {"tokens": torch.from_numpy(
                inp)}, c)
            slot, cs = tf.decode_step(p, cfg, {"tokens": torch.from_numpy(
                inp)}, cs, active=[True] * Bq)
        want_slot, js = jstep(jp, {"tokens": jnp.asarray(inp)}, js)
        assert _err(got, want) <= tol, t
        assert _err(slot, want_slot) <= tol, t


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("name,spec", [("mixtral_f32", False),
                                       ("mixtral_f32", True),
                                       ("scout_f32", False),
                                       ("mixtral", False)])
def test_engine_matches_the_jax_engine(name, spec, moe_configs):
    """The JAX engine and the port's on the same workload (prompts of
    18-27 tokens in chunks of 8, the last chunk bucketed): exactly equal
    streams and counters under f32, the margin rule under bf16."""
    got, want = par.check_against_jax(name, spec=spec)
    assert got["prefill_chunks"] == want["prefill_chunks"] > 0
    if spec:
        assert got["drafted_tokens"] > 0


def _slot_engine(arch, **kw):
    cfg = _moe_cfg(base, arch, torch.float32, compute_dtype=torch.float32)
    moe = dataclasses.replace(cfg.moe,
                              capacity_factor=float(cfg.moe.n_experts))
    cfg = dataclasses.replace(cfg, moe=moe)
    return cfg, tf.init_params(cfg, 3, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_and_prefill_rows_equal_decode_ticks(arch):
    """Within the port at full capacity (no slot dropped): a verify call of
    four tokens, a resumed prefill chunk of four and four decode ticks
    give the same logits (f32, within 1e-5)."""
    cfg, p = _slot_engine(arch)
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 8)))
    nxt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 4)))
    with torch.no_grad():
        def primed():
            c = tf.init_cache(cfg, 2, 32, kv_dtype=torch.float32,
                              device="cpu", per_slot=True, ring_slack=4)
            _, c = tf.prefill_step(p, cfg, {"tokens": prompt}, c, [8, 8])
            return c
        ticks, c = [], primed()
        for t in range(4):
            lg, c = tf.decode_step(p, cfg, {"tokens": nxt[:, t:t + 1]}, c,
                                   active=[True, True])
            ticks.append(lg)
        ticks = torch.stack(ticks, 1)
        ver, _ = tf.verify_forward(p, cfg, {"tokens": nxt}, primed())
        chunk, _ = tf.prefill_step(p, cfg, {"tokens": nxt}, primed(), [4, 4],
                                   resume=True)
    assert _err(ver, ticks.numpy()) <= TOL["f32"]
    assert _err(chunk, ticks[:, -1].numpy()) <= TOL["f32"]


# ---------------------------------------------------------------- the CLI

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_moe_archs(arch, capsys):
    run = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "3", "--cache-len", "24"])
    assert run.tokens.shape == (2, 3)
    assert "decoded 6 tokens" in capsys.readouterr().out
    rep = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--continuous", "--requests", "2", "--slots", "2",
                      "--prompt-len", "10", "20", "--prefill-chunk", "8",
                      "--cache-len", "48"])
    assert rep["requests"] == 2 and rep["total_tokens"] >= 2
    assert rep["prefill_chunks"] > 2
