"""The port's model stack and decode loop against the JAX reference, on the CPU.

Parameters come from the reference's own ``init_params`` and cross over with
``repro_torch.interop.params_from_reference``; every other input is made by
numpy from a seed and handed to both sides. The reference runs jitted, as its
decode step does.

Tolerances, on the largest |logit| (or |output|) of the reference:

* f32 compute: ``1e-5``. Both sides compute in f32 and differ only in the
  order of their sums.
* f32 compute with the int8 cache: ``2**-7``. A code whose ``x / scale``
  lies within rounding noise of a .5 tie may round the other way; that moves
  one cached K or V entry by one quantization step, at most 1/127 of its
  row's absmax. The codes themselves must agree except for such +-1 flips,
  each at an ``x / scale`` within 1e-3 of a tie, on at most 1 % of them.
* bf16 compute (the configs' own): ``6 * 2**-8``. Each bf16 stage (the
  embedding, q/k/v, attention output, MLP, residual, logits) rounds to 2**-8
  relative, and the two frameworks round at different points.

Greedy tokens must equal the reference's wherever its top-2 logit margin
exceeds twice the tolerance (each of the two logits may move by it).
"""

import argparse
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import base
from repro_torch.interop import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve, step_fns
from repro_torch.models import layers
from repro_torch.models import transformer as tf

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "f32_int8": 2.0 ** -7, "bf16": 6 * 2.0 ** -8}
PORTED_ARCHS = ("minicpm_2b", "nemotron_4_15b", "granite_3_8b",
                "minitron_8b")


def _tol(dt: str, kv_quant: bool = False) -> float:
    return TOL["f32_int8"] if (dt == "f32" and kv_quant) else TOL[dt]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol: float, what: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: error {err:.3e} of max|ref| > {tol:.3e}"


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _configs(arch: str, dt: str = "bf16", kv_quant: bool = False):
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(ref_base.get_config(arch, reduced=True),
                               compute_dtype=jdt, kv_quant=kv_quant)
    cfg = dataclasses.replace(base.get_config(arch, reduced=True),
                              compute_dtype=tdt, kv_quant=kv_quant)
    return jcfg, cfg


def _params(jcfg, seed: int = 0):
    jp = ref_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# --------------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ref_base.ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_are_the_references(arch, reduced):
    want = dataclasses.asdict(ref_base.get_config(arch, reduced=reduced))
    got = dataclasses.asdict(base.get_config(arch, reduced=reduced))
    for k in ("param_dtype", "compute_dtype"):
        assert str(got.pop(k)).split(".")[-1] == jnp.dtype(want.pop(k)).name
    assert got == want
    # the port's collectives default to the paper's cluster, not a TPU model
    par = [dataclasses.asdict(f(arch)) for f in (base.get_parallel,
                                                 ref_base.get_parallel)]
    for d in par:
        for k in ("collective", "tp_collective"):
            d[k].pop("comm_model")
            d[k].pop("intra_model")
    assert par[0] == par[1]
    assert base.ALIASES == ref_base.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


def test_decode_config_is_the_dryrun_rule():
    """bf16 params always; the int8 cache exactly where n_kv_heads * hdim
    >= 2048, which among the dense archs is MiniCPM-2B at full width."""
    for arch in PORTED_ARCHS:
        for reduced in (False, True):
            cfg = base.decode_config(base.get_config(arch, reduced=reduced))
            assert cfg.param_dtype == torch.bfloat16
            assert cfg.kv_quant == (arch == "minicpm_2b" and not reduced)
    full = base.get_config("minicpm_2b")
    assert full.n_kv_heads * full.hdim == 2304


@pytest.mark.parametrize("arch", sorted(set(ref_base.ARCHS) - set(PORTED_ARCHS)))
def test_unported_kinds_raise_naming_the_roadmap(arch):
    cfg = base.get_config(arch, reduced=True)
    for build in (lambda: tf.init_params(cfg, 0, "cpu"),
                  lambda: tf.init_cache(cfg, 1, 8, device="cpu"),
                  lambda: step_fns.make_serve_step(cfg)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build()


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_params_and_caches_have_the_references_layout(arch):
    jcfg, cfg = _configs(arch, "bf16", kv_quant=True)
    jp, p = _params(jcfg)
    mine = tf.init_params(cfg, 0, "cpu")
    for tree in (p, mine):
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), tree)
        want = jax.tree.map(lambda a: (tuple(a.shape), "torch." +
                                       jnp.dtype(a.dtype).name), jp)
        assert got == want
    jc = ref_tf.init_cache(jcfg, 2, 8)
    c = tf.init_cache(cfg, 2, 8, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), c) == \
        jax.tree.map(lambda a: (tuple(a.shape),
                                "torch." + jnp.dtype(a.dtype).name), jc)


def test_params_from_reference_keeps_bf16_bits():
    jcfg = dataclasses.replace(ref_base.get_config("minicpm_2b",
                                                   reduced=True),
                               param_dtype=jnp.bfloat16)
    jp, p = _params(jcfg)
    assert p["embed"].dtype == torch.bfloat16 and "unembed" not in p
    assert p["final_norm"]["scale"].dtype == torch.float32
    want = np.asarray(jp["layers"][0][0]["wq"]).view(np.int16)
    got = p["layers"][0][0]["wq"].view(torch.int16).numpy()
    assert want.shape == (jcfg.n_periods,) + want.shape[1:]
    assert np.array_equal(got, want)


# ---------------------------------------------------------------- the layers

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_rope_and_mlp_match(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    B, T, H, dh, D, F = 2, 7, 4, 12, 48, 80
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)},
                          _tensor(x, tdt)),
           ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                              jnp.asarray(x, jdt)), TOL[dt], "rmsnorm")
    hx = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    pos = rng.integers(0, 5000, (B, T)).astype(np.int32)
    _close(layers.apply_rope(_tensor(hx, tdt), torch.from_numpy(pos)),
           ref_layers.apply_rope(jnp.asarray(hx, jdt), jnp.asarray(pos)),
           TOL[dt], "apply_rope")
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_in", (D, F)), ("w_gate", (D, F)),
                      ("w_out", (F, D)))}
    for act in ("silu", "gelu", "relu2"):
        for gated in (True, False):
            pw = {k: v for k, v in w.items() if gated or k != "w_gate"}
            _close(layers.mlp({k: torch.from_numpy(v) for k, v in pw.items()},
                              _tensor(x, tdt), act),
                   ref_layers.mlp({k: jnp.asarray(v) for k, v in pw.items()},
                                  jnp.asarray(x, jdt), act),
                   TOL[dt], f"mlp {act} gated={gated}")


def _attn_case(rng, kv_quant: bool, dt: str, S: int = 8, window=None):
    """Params, a pre-filled ring and one new token for GQA (rep 2)."""
    jdt, tdt = DTYPES[dt]
    acfg_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=12,
                   sliding_window=window)
    B, D, KV, dh = 3, 32, 2, 12
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (D, 48)), ("wk", (D, KV * dh)),
                      ("wv", (D, KV * dh)), ("wo", (48, D)))}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, S, KV, dh)).astype(np.float32)
    if kv_quant:
        jq = [ref_layers.quantize_kv_rows(jnp.asarray(a)) for a in kv]
        jc = {"k": jq[0][0], "v": jq[1][0], "ks": jq[0][1], "vs": jq[1][1]}
    else:                     # a ring in the compute dtype
        jc = {"k": jnp.asarray(kv[0], jdt), "v": jnp.asarray(kv[1], jdt)}
    c = params_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    return (ref_layers.AttnConfig(**acfg_kw), layers.AttnConfig(**acfg_kw),
            {k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()},
            jnp.asarray(x, jdt), _tensor(x, tdt), jc, c)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [5, 13])
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_decode_matches(dt, kv_quant, pos, window):
    """One token against a ring of 8, before (pos 5) and after (pos 13) it
    wraps, with the bf16 and the int8 cache."""
    jacfg, acfg, jw, w, jx, x, jc, c = _attn_case(
        np.random.default_rng(pos), kv_quant, dt, window=window)
    jout, jnew = jax.jit(ref_layers.attention_decode, static_argnums=1)(
        jw, jacfg, jx, jc, jnp.int32(pos))
    with torch.no_grad():
        out, new = layers.attention_decode(w, acfg, x, c, pos)
    _close(out, jout, _tol(dt, kv_quant), "attention_decode")
    slot = pos % 8
    for name in new:
        got, want = new[name], np.asarray(jnew[name])
        if got.dtype == torch.int8:    # codes: +-1 at most, only at ties
            assert np.abs(got.numpy().astype(int)
                          - want.astype(int)).max() <= 1
        else:
            _close(got[:, slot], want[:, slot], TOL[dt], name)
        # only the written slot changed
        keep = torch.arange(8) != slot
        bits = got[:, keep].contiguous()
        bits = bits.view(torch.int16) if bits.dtype == torch.bfloat16 else bits
        old = np.asarray(jc[name])[:, np.asarray(keep)]
        assert np.array_equal(bits.numpy().view(np.uint8),
                              old.view(np.uint8)), name


# ---------------------------------------------------------- the slice whole

@pytest.mark.parametrize("arch,dt,T", [
    (arch, dt, 16) for arch in ("minicpm_2b", "granite_3_8b")
    for dt in ("f32", "bf16")] + [("minicpm_2b", "f32", 1024)])
def test_forward_logits_match(arch, dt, T):
    """T = 1024 is the longest sequence on the direct path."""
    jcfg, cfg = _configs(arch, dt)
    jp, p = _params(jcfg)
    B = 3 if T == 16 else 1
    tok = np.random.default_rng(T).integers(0, jcfg.vocab_size, (B, T))

    def jfwd(params, tokens):
        x, _ = ref_tf.forward(params, jcfg, {"tokens": tokens})
        return ref_tf.unembed(params, jcfg, x)

    want = jax.jit(jfwd)(jp, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        x, aux = tf.forward(p, cfg, {"tokens": torch.from_numpy(tok)})
        got = tf.unembed(p, cfg, x)
    assert float(aux) == 0.0
    _close(got, want, TOL[dt], f"{arch} forward logits")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["minicpm_2b", "granite_3_8b"])
def test_attention_flash_path_matches(arch, dt):
    """T = FLASH_THRESHOLD + 1, the shortest sequence on the flash path:
    the port's ``attention`` against the reference's, with the first
    attention sublayer's params (MiniCPM-2B is MHA, Granite-3-8B groups 4
    query heads over 2 K/V heads)."""
    jcfg, cfg = _configs(arch, dt)
    jp, p = _params(jcfg)
    s = cfg.pattern[0][0]
    T = layers.FLASH_THRESHOLD + 1
    x = np.random.default_rng(T).standard_normal(
        (2, T, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jsp = jax.tree.map(lambda a: a[0], jp["layers"][0][0])
    want = jax.jit(ref_layers.attention, static_argnums=1)(
        {k: jsp[k] for k in ("wq", "wk", "wv", "wo")},
        jcfg.attn_cfg(jcfg.pattern[0][0]), jnp.asarray(x, DTYPES[dt][0]),
        jnp.asarray(pos))
    sp = tf._period(p["layers"][0][0], 0)
    with torch.no_grad():
        got = layers.attention(sp, cfg.attn_cfg(s), _tensor(x, DTYPES[dt][1]),
                               torch.from_numpy(pos.copy()))
    _close(got, want, TOL[dt], f"{arch} attention at T={T}")


def _record_quantize(monkeypatch):
    """Record ``x / scale`` of every K/V row the port quantizes, in order
    (K, then V, at each of the decode step's fused cache writes)."""
    ratios = []
    real = ops.kv_quantize_write

    def spy(k, v, cache_k, cache_v, scale_k, scale_v, slot):
        real(k, v, cache_k, cache_v, scale_k, scale_v, slot)
        end = slot + k.shape[1]
        for x, s in ((k, scale_k), (v, scale_v)):
            ratios.append((x.to(torch.float32) / s[:, slot:end]).numpy())

    monkeypatch.setattr(ops, "kv_quantize_write", spy)
    return ratios


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["minicpm_2b", "granite_3_8b"])
def test_decode_steps_match(arch, dt, kv_quant, monkeypatch):
    """Eight decode steps from distinct start tokens per row, each side fed
    the reference's greedy tokens. Without int8 the ring holds the compute
    dtype (a bf16 ring under f32 compute would add bf16 rounding flips)."""
    jcfg, cfg = _configs(arch, dt, kv_quant)
    jp, p = _params(jcfg)
    B, S, steps = 4, 16, 8
    tol = _tol(dt, kv_quant)
    ratios = _record_quantize(monkeypatch)
    jstep = jax.jit(lambda pp, i, c: ref_tf.decode_step(pp, jcfg, i, c))
    step = step_fns.make_serve_step(cfg)
    jc = ref_tf.init_cache(jcfg, B, S, kv_dtype=DTYPES[dt][0])
    c = tf.init_cache(cfg, B, S, kv_dtype=DTYPES[dt][1], device="cpu")
    tok = (np.arange(B) * 37 + 3) % jcfg.vocab_size
    compared = 0
    for i in range(steps):
        jl, jc = jstep(jp, {"tokens": jnp.asarray(tok[:, None], jnp.int32)},
                       jc)
        tl, c = step(p, {"tokens": torch.from_numpy(tok[:, None])}, c)
        jl = np.asarray(jl)
        _close(tl, jl, tol, f"step {i} logits")
        scale = tol * np.abs(jl).max()
        clear = _margin(jl) > 2 * scale
        assert np.array_equal(tl.numpy().argmax(-1)[clear],
                              jl.argmax(-1)[clear]), f"step {i} tokens"
        compared += int(clear.sum())
        tok = jl.argmax(-1)
    assert compared >= B          # the margin gate left something to check
    for jci, ci in zip(jc, c):
        assert np.array_equal(np.asarray(jci["pos"]), ci["pos"].numpy())
        if not kv_quant:
            _close(ci["k"], jci["k"], tol, "K ring")
            _close(ci["v"], jci["v"], tol, "V ring")
    if kv_quant and dt == "f32":
        # ratios: per step, per period, K then V, each (B, 1, KV, dh)
        n = jcfg.n_periods
        r = np.stack(ratios).reshape(steps, n, 2, B, jcfg.n_kv_heads,
                                     jcfg.hdim)
        for which, name in enumerate(("k", "v")):
            got = c[0][name].numpy()[:, :, :steps].astype(int)
            want = np.asarray(jc[0][name])[:, :, :steps].astype(int)
            diff = np.abs(got - want)
            assert diff.max() <= 1
            near = np.moveaxis(r[:, :, which], 0, 2)   # (n, B, steps, KV, dh)
            off_tie = np.abs(np.abs(near - np.trunc(near)) - 0.5)
            assert (off_tie[diff == 1] < 1e-3).all()
            assert diff.sum() <= 0.01 * diff.size


def test_serve_loop_matches_the_references_serve_loop():
    """The entry points on both sides: the reference's ``serve_loop`` (1x1
    mesh, f32 params) and the port's (``--device cpu --reduced``, its
    decode config: the same params in bf16, which under bf16 compute give
    the same numbers). Greedy streams feed back their own tokens, so they
    stay equal until the first step whose top-2 margin is within the
    tolerance; every step of the port's stream is also held against the
    reference's decode step fed the port's tokens."""
    for arch in ("minicpm_2b", "granite_3_8b"):
        ns = dict(arch=arch, reduced=True, batch=4, steps=16, cache_len=128,
                  seed=0)
        want = ref_serve.serve_loop(argparse.Namespace(**ns, mesh="1x1"))
        jcfg = dataclasses.replace(ref_base.get_config(arch, reduced=True),
                                   param_dtype=jnp.bfloat16)
        jp, p = _params(jcfg, seed=0)
        run = serve.serve_loop(argparse.Namespace(**ns, device="cpu"),
                               params=p, keep_logits=True)
        got = run.tokens
        assert got.shape == want.shape == (4, 16)
        assert ((got >= 0) & (got < jcfg.vocab_size)).all()
        # the reference's decode step along the port's stream
        jcfg32 = ref_base.get_config(arch, reduced=True)
        jp32 = ref_tf.init_params(jax.random.PRNGKey(0), jcfg32)
        jstep = jax.jit(lambda pp, i, c: ref_tf.decode_step(pp, jcfg32, i, c))
        jc = ref_tf.init_cache(jcfg32, 4, 128)
        tok = np.zeros((4, 1), np.int32)
        first_split = int(np.argmax((got != want).any(0))) \
            if (got != want).any() else 16
        for i in range(16):
            jl, jc = jstep(jp32, {"tokens": jnp.asarray(tok)}, jc)
            jl = np.asarray(jl)
            _close(run.logits[i], jl, TOL["bf16"], f"{arch} step {i}")
            scale = TOL["bf16"] * np.abs(jl).max()
            clear = _margin(jl) > 2 * scale
            assert np.array_equal(got[clear, i], jl.argmax(-1)[clear])
            if i <= first_split:      # same inputs as the reference's loop
                assert np.array_equal(jl.argmax(-1), want[:, i])
            if i == first_split:      # and they part only at a near-tie
                assert not clear.all()
            tok = got[:, i:i + 1].astype(np.int32)


def test_serve_cli_runs_and_refuses_unported_flags(capsys):
    run = serve.main(["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "3", "--cache-len", "8"])
    assert run.tokens.shape == (2, 3) and len(run.step_seconds) == 3
    assert "decoded 6 tokens" in capsys.readouterr().out
    for flag in ("--continuous", "--mesh=1x2", "--trace-out"):
        with pytest.raises(SystemExit) as e:
            serve.main(["--reduced", "--device", "cpu", flag])
        assert e.value.code == 2
        assert "ROADMAP.md" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--no-such-flag"])
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--batch", "0"])


def test_serving_needs_a_device_or_the_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "minicpm_2b", "--reduced", "--steps", "1"])


def test_make_serve_step_refuses_unported_modes():
    with pytest.raises(NotImplementedError, match="continuous engine"):
        step_fns.make_serve_step(base.get_config("minicpm_2b", True),
                                 slots=True)
    with pytest.raises(NotImplementedError, match="dist transport"):
        step_fns.make_serve_step(base.get_config("minicpm_2b", True),
                                 base.ParallelConfig(tp_shards=2))


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
