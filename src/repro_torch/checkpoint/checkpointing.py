"""Atomic checkpoints of the training state, written on a background thread
(the port of ``repro.checkpoint.checkpointing``).

The layout is the reference's::

    <dir>/step_<N:010d>.tmp/            # staged while writing
    <dir>/step_<N:010d>/host_0.npz      # the leaves, as leaf_<i>
    <dir>/step_<N:010d>/manifest.json   # step, n_leaves, treedef, extra

A step is published by renaming its staging directory, so a crash during a
write never leaves a directory that :func:`latest_step` would pick.
:class:`CheckpointManager` keeps the newest ``keep`` steps. The leaves go in
``jax.tree.flatten`` order, which is :func:`optim.tree_leaves` (dict keys
sorted, sequences in order), so a checkpoint of ``{"params": ..., "opt":
...}`` written by either package restores into the other. numpy has no
bf16: a bf16 leaf is stored as the two-byte void type numpy gives the
reference's bf16 arrays, and read back through an int16 view.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]


def treedef(tree) -> str:
    """The tree's structure in the form of ``str(jax.tree.flatten(tree)[1])``
    (leaves as ``*``), which the manifest records."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {treedef(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(treedef(v) for v in tree) + "]"
    return "*"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         host: int = 0) -> str:
    """Write ``tree`` (tensors or numpy arrays) as step ``step``,
    synchronously; returns the published directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_leaves(tree)
    arrs = {f"leaf_{i}": _to_numpy(x) if isinstance(x, torch.Tensor)
            else np.asarray(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, f"host_{host}.npz"), **arrs)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": f"PyTreeDef({treedef(tree)})",
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest published step under ``ckpt_dir``: staging directories
    and directories without a manifest do not count."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like, step: int | None = None,
            host: int = 0) -> tuple:
    """Step ``step`` (default: the latest) in the structure of ``like``:
    returns ``(tree, extra, step)``, each leaf a new tensor of its ``like``
    leaf's dtype on that leaf's device."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = tree_leaves(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"step {step} holds {manifest['n_leaves']} leaves, "
                         f"the tree to restore into {len(leaves_like)}")
    with np.load(os.path.join(path, f"host_{host}.npz")) as data:
        count = iter(range(len(leaves_like)))
        tree = _rebuild(like, lambda x: _from_numpy(
            data[f"leaf_{next(count)}"], x))
    return tree, manifest["extra"], step


def _rebuild(like, take):
    """``like``'s nesting with each leaf replaced by ``take(leaf)``, called
    in ``tree_leaves`` order."""
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], take) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, take) for v in like)
    return take(like)


class CheckpointManager:
    """Writes checkpoints on a background thread and keeps the newest
    ``keep`` steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, extra = item
            try:
                save(self.dir, step, tree, extra)
                self._retain()
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _retain(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Queue step ``step``. The host copy of every leaf is taken before
        this returns, so the caller may go on updating ``tree`` in place."""
        snapshot = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._q.put((step, snapshot, extra))

    def wait(self):
        """Block until every queued save is written; raise the first error
        the writer met."""
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self):
        """Write what is queued and stop the writer thread."""
        self._q.put(None)
        self._q.join()
        self._thread.join()
