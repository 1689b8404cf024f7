"""The port's training slice on the CPU against the JAX reference.

Covers the data stream (threefry and ``batch_at``, bitwise), the optimizers
and schedules, ``loss_fn`` and its gradients at T = 1088 (above
``FLASH_THRESHOLD``, so attention takes the flash path), the train step and
``train_loop`` against the reference's ``train_loop`` at ``--mesh 1x1``,
and the driver's command line. Parameters cross over with
``params_from_reference``; every other input is made by numpy from a seed.

Tolerances:

* data: bitwise (int32 tokens and labels, uint32 keys and bits, f32
  uniforms).
* optimizer updates: ``1e-6`` of each leaf's largest |value|; both sides
  run the same f32 operations in the same order, and differ only where
  ``pow`` or ``sqrt`` round differently.
* loss and gradients with f32 compute: ``1e-5`` of the reference's
  largest |value| (the order of f32 sums).
* loss with bf16 compute (the configs' own): ``2**-8``, gradients
  ``8 * 2**-8`` of each leaf's largest |gradient|: the forward's six bf16
  stages give the logits' ``6 * 2**-8``, and the backward adds the bf16
  roundings of its own products' outputs and, in the reference, a bf16
  scatter-add into the embedding's gradient.
* ``train_loop`` losses, bf16: ``2**-8`` relative. A loss is a mean over
  every token of the batch, and AdamW's normalised updates move a
  gradient's bf16 noise into the next losses only through the learning
  rate.
"""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import collectives as ref_collectives
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro.models import transformer as ref_tf
from repro.optim import optimizers as ref_optim
from repro_torch.configs import base
from repro_torch.data import pipeline, threefry
from repro_torch.interop import params_from_reference
from repro_torch.launch import step_fns, train
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as optim

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOSS_TOL = {"f32": 1e-5, "bf16": 2.0 ** -8}
GRAD_TOL = {"f32": 1e-5, "bf16": 8 * 2.0 ** -8}
T_FLASH = 1088


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def _err(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _key(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1])
def test_threefry_primitives_match_jax_random(seed):
    k = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert np.array_equal(_key(k), tk.numpy())
    for data in (0, 1, 7, 12345, 2 ** 32 - 1):
        assert np.array_equal(_key(jax.random.fold_in(k, data)),
                              threefry.fold_in(tk, data).numpy())
    for num in (2, 3, 8):
        assert np.array_equal(_key(jax.random.split(k, num)),
                              threefry.split(tk, num).numpy())
    for shape in ((1,), (7,), (3, 77), (2, 5, 9)):
        bits = jax.random.bits(k, shape, jnp.uint32)
        assert np.array_equal(np.asarray(bits).astype(np.int64),
                              threefry.random_bits(tk, shape).numpy())
        u = np.asarray(jax.random.uniform(k, shape))
        got = threefry.uniform(tk, shape).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(u.view(np.int32), got.view(np.int32))


def test_threefry_is_the_partitionable_form():
    """The port reproduces the bits jax draws with the flag this container
    has on (it changes ``split`` and ``uniform``)."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 512, 64, 4), (3, 122_753, 129, 2), (7, 49_155, 33, 6)])
def test_batch_at_is_bitwise_the_references(seed, vocab, seq, batch):
    rds = ref_pipeline.SyntheticLM(
        ref_pipeline.DataConfig(vocab, seq, batch, seed))
    tds = pipeline.SyntheticLM(pipeline.DataConfig(vocab, seq, batch, seed),
                               device="cpu")
    for step in (0, 1, 17, 1000):
        for shard, n in ((0, 1), (1, 2), (0, 2)):
            want = rds.batch_at(step, shard, n)
            got = tds.batch_at(step, shard, n)
            for name in ("tokens", "labels"):
                w = np.asarray(want[name])
                assert got[name].dtype == torch.int32
                assert np.array_equal(got[name].numpy(), w), (step, name)


def test_build_batches_resumes_where_asked():
    cfg = pipeline.DataConfig(512, 16, 2, seed=5)
    it = pipeline.build_batches(cfg, start_step=3, device="cpu")
    ds = pipeline.SyntheticLM(cfg, device="cpu")
    for want_step in (3, 4):
        step, batch = next(it)
        assert step == want_step
        assert torch.equal(batch["tokens"], ds.batch_at(step)["tokens"])


# -------------------------------------------------------------- optimizers

def _tree(rng):
    """A small parameter tree with the model's nesting (dict, list, tuple)."""
    return {"embed": rng.standard_normal((7, 5)).astype(np.float32),
            "final_norm": {"scale": rng.standard_normal(5).astype(np.float32)},
            "layers": [({"w": rng.standard_normal((2, 5, 3)).astype(
                np.float32)}, {"b": rng.standard_normal((2, 3)).astype(
                    np.float32)})]}


@pytest.mark.parametrize("kind", ["adamw-wsd", "adamw-cosine", "adamw-const",
                                  "sgdm-cosine"])
def test_optimizer_updates_match_the_reference(kind):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    if kind == "adamw-wsd":
        ref_opt = ref_optim.adamw(ref_optim.wsd_schedule(1e-2, 2, 1, 2))
        opt = optim.adamw(optim.wsd_schedule(1e-2, 2, 1, 2))
    elif kind == "adamw-cosine":
        ref_opt = ref_optim.adamw(ref_optim.cosine_schedule(1e-2, 2, 5))
        opt = optim.adamw(optim.cosine_schedule(1e-2, 2, 5))
    elif kind == "adamw-const":
        ref_opt, opt = ref_optim.adamw(3e-3), optim.adamw(3e-3)
    else:
        ref_opt = ref_optim.sgdm(ref_optim.cosine_schedule(1e-2, 2, 5))
        opt = optim.sgdm(optim.cosine_schedule(1e-2, 2, 5))
    jp = jax.tree.map(jnp.asarray, p0)
    js = ref_opt.init(jp)
    tp = params_from_reference(p0, device="cpu")
    ts = opt.init(tp)
    update = jax.jit(ref_opt.update)
    for i in range(5):
        # gradients large enough that the clip acts on some steps
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (0.2 + i)).astype(np.float32), p0)
        jp, js, jm = update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = opt.update(params_from_reference(g, device="cpu"),
                                ts, tp)
        assert _err(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert _err(tm["lr"], jm["lr"]) <= 1e-6
        for got, want in zip(optim.tree_leaves(tp), jax.tree.leaves(jp)):
            assert _err(got, want) <= 1e-6, i
        for name in ("mu", "nu", "m"):
            if name in js:
                for got, want in zip(optim.tree_leaves(ts[name]),
                                     jax.tree.leaves(js[name])):
                    assert _err(got, want) <= 1e-6, (i, name)
        assert int(ts["step"]) == int(js["step"]) == i + 1


@pytest.mark.parametrize("sched", ["wsd", "cosine"])
def test_schedules_match_the_reference(sched):
    if sched == "wsd":
        f, g = ref_optim.wsd_schedule(3e-4, 5, 7, 9), \
            optim.wsd_schedule(3e-4, 5, 7, 9)
    else:
        f, g = ref_optim.cosine_schedule(3e-4, 5, 30), \
            optim.cosine_schedule(3e-4, 5, 30)
    steps = np.arange(0, 40, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(f))(jnp.asarray(steps)))
    got = g(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_reference_gradient_reduction_is_the_identity_at_one_rank():
    """At one data-parallel rank the reference's gradient reduction returns
    its input, so the port's train step calls no collective."""
    tree = {"a": jnp.ones((3, 2)), "b": [jnp.arange(4.0)]}
    out = ref_collectives.bucketed_all_reduce(
        tree, "data", 1, ref_collectives.CollectiveConfig(method="dptree"))
    assert out is tree


# ---------------------------------------------------------- loss and grads

def _configs(arch: str, dt: str):
    jdt, tdt = DTYPES[dt]
    jcfg = dataclasses.replace(ref_base.get_config(arch, reduced=True),
                               compute_dtype=jdt)
    cfg = dataclasses.replace(base.get_config(arch, reduced=True),
                              compute_dtype=tdt)
    return jcfg, cfg


def _params(jcfg, seed: int = 0):
    jp = ref_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _batch(vocab: int, B: int, T: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, T)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["minicpm_2b", "granite_3_8b"])
def test_loss_and_gradients_match_value_and_grad(arch, dt):
    """T = 1088: attention on the flash path, and two CE chunks of 512 plus
    a remainder of 64."""
    jcfg, cfg = _configs(arch, dt)
    jp, p = _params(jcfg)
    b = _batch(jcfg.vocab_size, 2, T_FLASH)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q, x: ref_tf.loss_fn(q, jcfg, x), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = optim.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss, mets = tf.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    loss.backward()
    assert float(mets["aux"]) == 0.0
    assert _err(loss, jl) <= LOSS_TOL[dt]
    assert _err(mets["ce"], jm["ce"]) <= LOSS_TOL[dt]
    for t, g in zip(leaves, jax.tree.leaves(jg)):
        assert t.grad.shape == g.shape
        assert _err(t.grad, g) <= GRAD_TOL[dt]


def test_remat_and_ce_chunks_change_no_number():
    """Checkpointed sublayers and CE chunks recompute the same forward, so
    the loss is equal; the gradients differ only in the order in which the
    backward adds a leaf's contributions (the tied embedding's two)."""
    _, cfg = _configs("granite_3_8b", "f32")
    p = tf.init_params(cfg, 0, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 2,
                                                   600).items()}
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        tree = optim.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), p)
        leaves = optim.tree_leaves(tree)
        loss, _ = tf.loss_fn(tree, c, b)
        loss.backward()
        grads.append([float(loss.detach())] + [t.grad for t in leaves])
    assert grads[0][0] == grads[1][0]
    for a, b_ in zip(grads[0][1:], grads[1][1:]):
        assert _err(a, b_) <= 1e-6


def test_train_step_matches_the_references_step():
    """One step of the port's train step (with two microbatches) against
    the reference's at mesh 1x1, f32 compute: the metrics and the gradients
    each hands its optimizer (an optimizer that returns the gradients as
    the new params, so the step's output is what the backward and the
    microbatch average made)."""
    from repro.launch import step_fns as ref_step_fns
    from repro.launch.mesh import make_mesh
    jcfg, cfg = _configs("granite_3_8b", "f32")
    jp, p = _params(jcfg)
    b = _batch(jcfg.vocab_size, 4, 1040, seed=3)
    mesh = make_mesh((1, 1), ("data", "model"))
    ref_opt = ref_optim.Optimizer(
        lambda q: {"step": jnp.zeros((), jnp.int32)},
        lambda g, st, q, _=None: (g, st, {"grad_norm": jnp.zeros(())}))
    jstep, sh = ref_step_fns.make_train_step(
        jcfg, ref_base.get_parallel("granite_3_8b"), mesh, ref_opt, accum=2)
    jg, _, jvec = jstep(jp, sh["opt_init"](jp),
                        {k: jnp.asarray(v) for k, v in b.items()})
    opt = optim.Optimizer(
        lambda q: {}, lambda g, st, q: (g, st, {"grad_norm": torch.zeros(())}))
    step = step_fns.make_train_step(cfg, base.get_parallel("granite_3_8b"),
                                    opt, accum=2)
    g, _, vec = step(p, {}, {k: torch.from_numpy(v) for k, v in b.items()})
    assert vec.shape == (4,) and vec.dtype == torch.float32
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=1e-5)
    for got, want in zip(optim.tree_leaves(g), jax.tree.leaves(jg)):
        assert got.dtype == torch.float32
        assert _err(got, want) <= 1e-5


# -------------------------------------------------------------- the driver

def _args(**kw) -> argparse.Namespace:
    base_kw = dict(arch="minicpm_2b", reduced=True, steps=5,
                   seq_len=T_FLASH, global_batch=2, lr=1e-3, accum=1, seed=0,
                   log_every=1)
    base_kw.update(kw)
    return argparse.Namespace(**base_kw)


@pytest.mark.parametrize("arch,accum", [("minicpm_2b", 1),
                                        ("granite_3_8b", 2)])
def test_train_loop_losses_match_the_references(arch, accum):
    """Five steps at T = 1088 from the same params and batches: the
    reference's ``train_loop`` at ``--mesh 1x1`` and the port's, both in
    the config's own bf16 compute."""
    a = _args(arch=arch, accum=accum)
    ref = ref_train.train_loop(argparse.Namespace(
        **vars(a), mesh="1x1", ckpt_dir=None, ckpt_every=100,
        collective=None, max_restarts=0))
    jp = ref_tf.init_params(jax.random.PRNGKey(a.seed),
                            ref_base.get_config(arch, reduced=True))
    p = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    run = train.train_loop(argparse.Namespace(**vars(a), device="cpu"),
                           params=p)
    want = np.array([loss for _, loss in ref["history"]])
    got = np.array([loss for _, loss in run.history])
    assert [i for i, _ in run.history] == list(range(a.steps))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8)
    assert len(run.metrics) == len(run.step_seconds) == a.steps


def test_loss_decreases_over_ten_steps():
    """As the reference's integration test: a reduced model learns the
    synthetic stream's bigram structure."""
    run = train.train_loop(_args(arch="granite_3_8b", steps=10, seq_len=64,
                                 global_batch=8, accum=2, log_every=2,
                                 device="cpu"))
    losses = [loss for _, loss in run.history]
    assert losses[-1] < losses[0] - 0.1, losses


def test_main_trains_on_the_cpu(capsys):
    run = train.main(["--arch", "minicpm_2b", "--reduced", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "2",
                      "--log-every", "1", "--device", "cpu"])
    assert len(run.history) == 2 and np.isfinite(run.final_loss)
    assert "done. final loss" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x1"], "dist transport"),
    (["--collective", "dptree"], "dist transport"),
])
def test_refused_flags_name_their_roadmap_item(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--device", "cpu", *argv])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err


@pytest.mark.parametrize("flag", ["--ckpt-dir", "--ckpt-every",
                                  "--max-restarts", "--autotune-warmup",
                                  "--autotune-cache"])
def test_ported_flags_train(flag, tmp_path, capsys):
    """Each flag the reference's ``train.py`` takes for checkpoints,
    restarts and the autotune warm-up runs through the port's with its
    meaning:
    ``--ckpt-every`` with a directory writes step 2 (after step 1) and the
    last, ``--ckpt-dir`` alone writes the last step and a second run
    resumes there, ``--max-restarts`` sets the supervisor's budget (no
    failure here: 0 restarts)."""
    from repro_torch.checkpoint import checkpointing
    from repro_torch.core import autotune
    d = str(tmp_path / "ck")
    value = {"--ckpt-dir": [d], "--ckpt-every": ["1", "--ckpt-dir", d],
             "--max-restarts": ["0"], "--autotune-warmup": [],
             "--autotune-cache": [str(tmp_path / "tune.json")]}[flag]
    argv = ["--arch", "minicpm_2b", "--reduced", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
            "--device", "cpu", flag, *value]
    try:
        run = train.main(argv)
        assert run.restarts == 0 and len(run.history) == 3
        assert np.isfinite(run.final_loss)
        if flag == "--ckpt-every":
            assert sorted(os.listdir(d)) == ["step_0000000002",
                                             "step_0000000003"]
        if flag == "--ckpt-dir":
            assert checkpointing.latest_step(d) == 3
            again = train.main(argv[:4] + ["4"] + argv[5:])
            assert again.start == 3 and [i for i, _ in again.history] == [3]
            assert "resumed from step 3" in capsys.readouterr().out
        if flag == "--autotune-cache":
            assert autotune.default_cache_path() == value[0]
    finally:
        autotune.set_cache_path(None)


def test_main_defaults_to_the_card():
    """Without ``--device`` the driver asks for CUDA, and without a card
    that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "minicpm_2b", "--reduced", "--steps", "1"])
