"""Shared harness of the tests that hold the port's serving engine against
the JAX reference's with speculation, the prefix cache and the SLO policy
(``tests/test_torch_speculative.py``, ``test_torch_prefix.py`` and
``test_torch_slo.py``).

Configs: the tiny config of ``tests/test_speculative.py`` and reduced
MiniCPM-2B with the int8 K/V cache forced on, each under bf16 compute (the
configs of ``tests/test_torch_serving.py``) and under f32 compute. Under
f32 the two engines' logits agree within 1e-5 (``2**-7`` with the int8
cache), far inside every top-2 margin of these workloads, so the greedy
streams are equal and so is every counter, including those that follow
the tokens (drafted and accepted tokens, ticks under speculation). Under
bf16 a stream may part where the reference's top-2 margin is within twice
the bf16 tolerance (``tests/test_torch_serving.py``'s rule), and only the
counters that do not follow token values are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import serving as ref_serving
from repro.configs import base as ref_base
from repro.launch.mesh import make_mesh
from repro.models import transformer as ref_tf
from repro_torch import serving
from repro_torch.configs import base
from repro_torch.interop import params_from_reference
from repro_torch.models import transformer as tf

BF16_TOL = 6 * 2.0 ** -8
# the counters that do not follow token values (without speculation)
SCHED_COUNTERS = ("prefill_chunks", "prefix_hits", "prefix_tokens_reused",
                  "preemptions", "shed_requests", "resumed_tokens",
                  "deadline_misses", "ticks")
COUNTERS = SCHED_COUNTERS + ("drafted_tokens", "accepted_tokens",
                             "total_tokens")


def _tiny(mod, **kw):
    cfg = dict(name="spec-tiny", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=2, d_ff=64, vocab_size=101, remat=False)
    cfg.update(kw)
    return mod.ModelConfig(**cfg)


def _minicpm(mod, param_dtype, **kw):
    return dataclasses.replace(
        mod.get_config("minicpm_2b", reduced=True), param_dtype=param_dtype,
        kv_quant=True, **kw)


CONFIGS = {
    "tiny": lambda: (_tiny(ref_tf), _tiny(tf)),
    "tiny_f32": lambda: (_tiny(ref_tf, compute_dtype=jnp.float32),
                         _tiny(tf, compute_dtype=torch.float32)),
    "minicpm_int8": lambda: (_minicpm(ref_base, jnp.bfloat16),
                             _minicpm(base, torch.bfloat16)),
    "minicpm_int8_f32": lambda: (
        _minicpm(ref_base, jnp.float32, compute_dtype=jnp.float32),
        _minicpm(base, torch.float32, compute_dtype=torch.float32)),
}
_PARAMS: dict = {}


def params(name):
    """(reference cfg, port cfg, reference params, port params on the
    CPU): the reference's ``init_params`` from key 0, carried across."""
    if name not in _PARAMS:
        jcfg, cfg = CONFIGS[name]()
        jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[name] = (jcfg, cfg, jp, params_from_reference(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[name]


def engine(name="tiny", n_slots=2, max_len=48, **kw):
    """The port's engine on the CPU with the reference's weights."""
    _, cfg, _, p = params(name)
    kw.setdefault("min_prefill_bucket", 8)
    return cfg, serving.ServingEngine(cfg, None, p, n_slots=n_slots,
                                      max_len=max_len, device="cpu", **kw)


def workload(mod, vocab, *, spec=False, n=6, seed=5, share=16):
    """``n`` requests a tick apart: a shared ``share``-token system prompt
    and a short repetitive suffix (draftable text), 6 to 13 new tokens; the
    last two are INTERACTIVE with a TTFT deadline of 6 ticks, the rest
    BATCH."""
    rng = np.random.default_rng(seed)
    shared = tuple(int(t) for t in rng.integers(1, vocab, share))
    out = []
    for i in range(n):
        period = rng.integers(1, vocab, int(rng.integers(2, 4)))
        plen = int(rng.integers(2, 12))
        late = i >= n - 2
        out.append(mod.Request(
            i, shared + tuple(int(period[j % len(period)])
                              for j in range(plen)),
            max_new_tokens=int(rng.integers(6, 14)), arrival=i,
            spec=mod.SpecParams(draft_k=3) if spec else None,
            slo=mod.SLOParams(
                priority=(mod.PriorityClass.INTERACTIVE if late
                          else mod.PriorityClass.BATCH),
                deadline_ticks=6 if late else None)))
    return out


def _ref_logits(jcfg, jp, history) -> np.ndarray:
    """The reference's scalar decode over ``history``: the logits after its
    last token."""
    step = jax.jit(lambda p, i, c: ref_tf.decode_step(p, jcfg, i, c))
    caches = ref_tf.init_cache(jcfg, 1, len(history) + 1)
    for t in history:
        logits, caches = step(jp, {"tokens": jnp.asarray([[t]], jnp.int32)},
                              caches)
    return np.asarray(logits)[0]


def check_against_jax(name, *, spec=False, prefix=False, slo=False,
                      n_slots=3, max_len=64, prefill_chunk=8):
    """Run the workload through both engines and hold the port to the
    reference: the streams (exactly under f32 compute, by the margin rule
    under bf16) and the counters."""
    jcfg, cfg, jp, p = params(name)
    kw = dict(n_slots=n_slots, max_len=max_len, prefill_chunk=prefill_chunk,
              min_prefill_bucket=8, prefix_cache=prefix)
    mesh = make_mesh((1, 1), ("data", "model"))
    want = ref_serving.ServingEngine(
        jcfg, ref_base.ParallelConfig(), mesh, jp, **kw).run(
        workload(ref_serving, cfg.vocab_size, spec=spec),
        policy=ref_serving.SLOPolicy() if slo else None)
    reqs = workload(serving, cfg.vocab_size, spec=spec)
    got = serving.ServingEngine(cfg, None, p, device="cpu", **kw).run(
        reqs, policy=serving.SLOPolicy() if slo else None)
    assert got["requests"] == want["requests"] == len(reqs)
    prompts = {r.rid: r.prompt for r in reqs}
    parted = 0
    for rid, toks in want["tokens"].items():
        mine = got["tokens"][rid]
        if mine == toks:
            continue
        assert not name.endswith("_f32"), (name, rid)
        i = next(j for j, (a, b) in enumerate(zip(mine, toks)) if a != b)
        logits = _ref_logits(jcfg, jp, prompts[rid] + tuple(toks[:i]))
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * BF16_TOL * np.abs(logits).max(), \
            (rid, i)
        parted += 1
    exact = parted == 0
    for k in (COUNTERS if exact else () if spec else SCHED_COUNTERS):
        assert got[k] == want[k], (k, got[k], want[k])
    return got, want
