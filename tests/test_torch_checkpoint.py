"""The port's checkpoints, restart supervisor and ``"dots"`` remat against the
JAX reference, on the CPU.

Checkpoints cross between the packages both ways and must come back bit for
bit: the reference's reduced MiniCPM-2B params and AdamW state (after one
update, so the moments are not zero), and bf16 leaves. The resume and
restart tests are the counterparts of the reference's
``tests/test_train_integration.py``: a resumed run's final loss within
``2e-3`` of the uninterrupted run's (that test's bound), and one restart
after an injected failure. The backoff schedule must equal the
reference's for the same seed. ``"dots"`` must give the loss of ``"full"``
and of no remat exactly, and gradients within ``1e-6`` of each leaf's
largest (the bound of ``test_remat_and_ce_chunks_change_no_number``: only
the order in which the backward adds a leaf's contributions differs).
"""

import argparse
import collections
import dataclasses
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpointing as ref_ckpt
from repro.configs import base as ref_base
from repro.launch import train as ref_train
from repro.models import transformer as ref_tf
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import base
from repro_torch.core import autotune
from repro_torch.interop import params_from_reference
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as optim
from repro_torch.runtime import fault_tolerance as ft

ARCH = "minicpm_2b"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _assert_trees_bitwise(got, want):
    gl, wl = optim.tree_leaves(got), optim.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))


def _reference_state():
    """The reference's reduced MiniCPM-2B params and AdamW state after one
    update with seeded gradients."""
    jcfg = ref_base.get_config(ARCH, reduced=True)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
    opt = ref_train.build_optimizer(ref_base.get_arch(ARCH), 1e-3, 8)
    js = opt.init(jp)
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jp)
    jp, js, _ = jax.jit(opt.update)(g, js, jp)
    return {"params": jp, "opt": js}


def _port_like():
    """A port state of the same structure and other values."""
    cfg = base.get_config(ARCH, reduced=True)
    p = tf.init_params(cfg, 1, "cpu")
    opt = train.build_optimizer(base.get_arch(ARCH), 1e-3, 8)
    return {"params": p, "opt": opt.init(p)}


def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path):
    state = _reference_state()
    d = str(tmp_path / "ck")
    ref_ckpt.save(d, 3, state, extra={"data_step": 3})
    got, extra, step = ckpt.restore(d, _port_like())
    assert (step, extra) == (3, {"data_step": 3})
    want = params_from_reference(jax.tree.map(np.asarray, state),
                                 device="cpu")
    _assert_trees_bitwise(got, want)
    assert int(got["opt"]["step"]) == 1
    with open(os.path.join(d, "step_0000000003", "manifest.json")) as f:
        assert json.load(f)["treedef"] == \
            f"PyTreeDef({ckpt.treedef(got)})"


def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path):
    state = params_from_reference(jax.tree.map(np.asarray,
                                               _reference_state()),
                                  device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, state, extra={"data_step": 5})
    like = _reference_state()
    got, extra, step = ref_ckpt.restore(d, like)
    assert (step, extra) == (5, {"data_step": 5})
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for g, w in zip(jax.tree.leaves(got), optim.tree_leaves(state)):
        g = np.asarray(g)
        assert g.dtype == w.numpy().dtype
        assert g.shape == w.shape and g.tobytes() == w.numpy().tobytes()
    with open(os.path.join(d, "step_0000000005", "manifest.json")) as f:
        assert json.load(f)["treedef"] == \
            str(jax.tree.flatten(like)[1])


def test_bf16_leaves_cross_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16),
             "rest": [jnp.asarray(x[0]), jnp.arange(4, dtype=jnp.int32)]}
    ttree = params_from_reference(jax.tree.map(np.asarray, jtree),
                                  device="cpu")
    assert ttree["w"].dtype == torch.bfloat16
    ref_ckpt.save(str(tmp_path / "a"), 1, jtree)
    ckpt.save(str(tmp_path / "b"), 1, ttree)
    like = optim.tree_map(torch.zeros_like, ttree)
    for d in ("a", "b"):
        got, _, _ = ckpt.restore(str(tmp_path / d), like)
        _assert_trees_bitwise(got, ttree)
    # both packages store a bf16 leaf as the same bytes
    a = np.load(str(tmp_path / "a" / "step_0000000001" / "host_0.npz"))
    b = np.load(str(tmp_path / "b" / "step_0000000001" / "host_0.npz"))
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_restore_puts_each_leaf_on_its_like_leafs_dtype(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.ones(2, dtype=torch.int32),)}
    ckpt.save(str(tmp_path), 2, tree)
    like = {"a": torch.zeros((2, 3), dtype=torch.float64),
            "b": (torch.zeros(2, dtype=torch.int64),)}
    got, _, _ = ckpt.restore(str(tmp_path), like)
    assert got["a"].dtype == torch.float64 and isinstance(got["b"], tuple)
    assert torch.equal(got["a"], tree["a"].double())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"a": like["a"]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), like)


def test_manager_keeps_the_newest_two(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree, extra={"data_step": s})
    mgr.wait()
    mgr.close()
    assert not mgr._thread.is_alive()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_latest_step_skips_staging_and_unfinished_directories(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 3, {"x": torch.zeros(2)})
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))     # a crash mid-write
    ckpt.save(d, 8, {"x": torch.zeros(2)})
    os.rename(os.path.join(d, "step_0000000008"),
              os.path.join(d, "step_0000000008.tmp"))
    os.makedirs(os.path.join(d, "step_0000000007"))         # no manifest
    assert ckpt.latest_step(d) == ref_ckpt.latest_step(d) == 3
    got, _, step = ckpt.restore(d, {"x": torch.ones(2)})
    assert step == 3 and torch.equal(got["x"], torch.zeros(2))


def test_save_async_writes_the_values_of_the_call(tmp_path):
    """The port trains its params in place: the writer must see the values
    as they were when ``save_async`` was called."""
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3)
    x = torch.arange(1 << 16, dtype=torch.float32)
    state = {"params": {"w": x}, "opt": {"step": torch.tensor(7)}}
    mgr.save_async(1, state)
    x.add_(1.0)                 # the next step's in-place update
    state["opt"]["step"].fill_(8)
    mgr.save_async(2, state)
    mgr.wait()
    mgr.close()
    for s, off, st in ((1, 0.0, 7), (2, 1.0, 8)):
        got, _, _ = ckpt.restore(str(tmp_path), state, step=s)
        assert torch.equal(got["params"]["w"],
                           torch.arange(1 << 16, dtype=torch.float32) + off)
        assert int(got["opt"]["step"]) == st


def test_wait_raises_the_writers_error(tmp_path):
    (tmp_path / "file").write_text("")
    mgr = ckpt.CheckpointManager(str(tmp_path / "file"), keep=2)
    mgr.save_async(1, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()


# ------------------------------------------------------ the supervisor

@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_schedule_equals_the_references(seed):
    def run(mod):
        slept, calls = [], []

        def loop(attempt):
            calls.append(attempt)
            if attempt < 4:
                raise mod.HostFailure(attempt)
            return {"attempt": attempt}

        out = mod.run_with_restarts(loop, max_restarts=5, backoff_s=0.5,
                                    backoff_cap_s=3.0, jitter=0.25,
                                    seed=seed, sleep=slept.append)
        return out, slept, calls

    (got, gs, gc_), (want, ws, wc) = run(ft), run(ref_ft)
    assert got == want == {"attempt": 4, "restarts": 4}
    assert gc_ == wc == [0, 1, 2, 3, 4]
    assert len(gs) == 4 and gs == ws


def test_supervisor_reraises_past_max_restarts_and_sets_attributes():
    def always(attempt):
        raise ft.HostFailure(2, hosts=[2, 5])

    with pytest.raises(ft.HostFailure, match="hosts 2, 5") as e:
        ft.run_with_restarts(always, max_restarts=2)
    assert e.value.hosts == (2, 5)
    with pytest.raises(ValueError):     # only HostFailure restarts
        ft.run_with_restarts(lambda a: int("x"), max_restarts=2)
    run = train.TrainRun([], [], [], {})
    assert ft.run_with_restarts(lambda a: run) is run and run.restarts == 0


# ------------------------------------------------- resume and restart

def _args(**kw) -> argparse.Namespace:
    a = dict(arch="granite_3_8b", reduced=True, seq_len=32, global_batch=4,
             lr=1e-3, accum=1, seed=0, ckpt_every=4, log_every=1,
             device="cpu", ckpt_dir=None)
    a.update(kw)
    return argparse.Namespace(**a)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """The counterpart of the reference's test of the same name: 8 steps
    against 5 steps with a checkpoint at step 5 (after step 4), then a
    fresh loop that resumes there and runs to 8."""
    ref = train.train_loop(_args(steps=8))
    d = str(tmp_path / "ck")
    first = train.train_loop(_args(steps=5, ckpt_dir=d))
    assert ckpt.latest_step(d) == 5 and first.start == 0
    saved, _, _ = ckpt.restore(d, {"params": first.params,
                                   "opt": train.build_optimizer(
                                       base.get_arch("granite_3_8b"), 1e-3,
                                       5).init(first.params)})
    _assert_trees_bitwise(saved["params"], first.params)
    got = train.train_loop(_args(steps=8, ckpt_dir=d))
    assert got.start == 5
    assert [i for i, _ in got.history] == [5, 6, 7]
    assert abs(ref.final_loss - got.final_loss) < 2e-3, (ref.final_loss,
                                                         got.final_loss)
    assert sorted(os.listdir(d)) == ["step_0000000005", "step_0000000008"]


def test_injected_failure_restart(tmp_path):
    """The counterpart of the reference's test of the same name: a failure
    after step 5, with checkpoints every 3 steps, restarts once from the
    checkpoint written after step 3. The failed attempt's tensors are
    released, without the cycle collector, before the next attempt."""
    d = str(tmp_path / "ck")
    args = _args(arch=ARCH, steps=8, ckpt_every=3, log_every=2, ckpt_dir=d)
    cfg = base.get_config(ARCH, reduced=True)
    attempts, refs, released = [], [], []

    def loop(attempt):
        attempts.append(attempt)
        if attempt == 0:
            p = tf.init_params(cfg, 0, "cpu")
            refs.extend(weakref.ref(t) for t in optim.tree_leaves(p))
            return train.train_loop(args, p, cfg, fail_at=5)
        released.append(all(r() is None for r in refs))
        return train.train_loop(args)

    gc.disable()
    try:
        out = ft.run_with_restarts(loop, max_restarts=2)
    finally:
        gc.enable()
    assert out.restarts == 1 and attempts == [0, 1]
    assert refs and released == [True]
    assert out.start == 4
    assert [i for i, _ in out.history] == [4, 6, 7]
    assert np.isfinite(out.final_loss)
    assert ckpt.latest_step(d) == 8


# ------------------------------------------------------- the "dots" remat

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("T", [600, 1088])
def test_dots_saves_the_weight_products_and_recomputes_the_rest(T):
    """Reduced Granite in f32 at T = 600 (plain attention) and 1088 (the
    flash path): the backward under ``"dots"`` runs the products of no
    remat (the gradients' and the CE chunks' recompute) and no product of
    the forward again; ``"full"`` runs the sublayers' products again. Both
    recompute the batched products of attention (``bmm``)."""
    cfg = dataclasses.replace(base.get_config("granite_3_8b", reduced=True),
                              compute_dtype=torch.float32)
    p = tf.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T)).astype(
        np.int32)) for k in ("tokens", "labels")}
    mm = torch.ops.aten.mm.default
    bmm = torch.ops.aten.bmm.default
    got = {}
    for name, kw in (("none", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **kw)
        tree = optim.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), p)
        leaves = optim.tree_leaves(tree)
        with _CountOps() as fwd:
            loss, _ = tf.loss_fn(tree, c, b)
        with _CountOps() as bwd:
            loss.backward()
        got[name] = (float(loss.detach()), [t.grad for t in leaves],
                     fwd.ops, bwd.ops)
    none, full, dots = got["none"], got["full"], got["dots"]
    assert dots[0] == full[0] == none[0]
    for g in (full[1], dots[1]):
        for a, w in zip(g, none[1]):
            assert float((a - w).abs().max() / w.abs().max()) <= 1e-6
    assert dots[2][mm] == full[2][mm] == none[2][mm] > 0
    assert dots[3][mm] == none[3][mm] < full[3][mm]
    assert dots[3][bmm] == full[3][bmm] > none[3][bmm]


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(base.get_config("granite_3_8b", reduced=True),
                              remat=True, remat_policy="everything")
    p = tf.init_params(cfg, 0, "cpu")
    b = {k: torch.zeros((1, 8), dtype=torch.int32)
         for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="remat_policy"):
        tf.loss_fn(p, cfg, b)


def test_full_configs_ask_for_the_references_policy():
    for arch in ("minicpm_2b", "granite_3_8b"):
        assert base.get_config(arch).remat_policy == \
            ref_base.get_config(arch).remat_policy == "dots"


# ------------------------------------------------------ the command line

def test_autotune_cache_flag_sets_the_cache_path(tmp_path):
    path = str(tmp_path / "tune.json")
    try:
        train.main(["--arch", ARCH, "--reduced", "--steps", "1",
                    "--seq-len", "16", "--global-batch", "2",
                    "--device", "cpu", "--autotune-cache", path])
        assert autotune.default_cache_path() == path
    finally:
        autotune.set_cache_path(None)
    assert autotune.default_cache_path() != path


def test_autotune_warmup_measures_nothing_at_one_rank():
    assert train.autotune_warmup("1x1") == []
    with pytest.raises(NotImplementedError, match="item 4"):
        train.autotune_warmup("2x1")
