"""Carry the reference's host-side state into the port.

Two kinds of state cross from ``repro`` to ``repro_torch``, both as plain
Python containers of numpy arrays, so this module imports nothing of
``repro``:

* :func:`from_reference` takes the topology constants and the cost model's
  fields (``dataclasses.asdict`` of the reference's ``TreeTopology``,
  ``HierarchicalTopology`` or ``CommModel``) and builds the port's object;
* :func:`params_from_reference` takes the reference's model parameters (its
  ``init_params`` output with every leaf as a numpy array) and gives the
  port's, in the same nesting: the stacked ``(n_periods, ...)`` layer
  leaves and, for tied embeddings, the one ``embed`` matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cost_model import CommModel
from repro_torch.core.topology import HierarchicalTopology, TreeTopology
from repro_torch.core.transport import resolve_device

__all__ = ["from_reference", "params_from_reference"]

_TREE_ARRAYS = ("parent", "child0", "child1", "depth", "phi", "tree_id")


def _pairs(classes) -> tuple:
    return tuple(tuple((int(s), int(d)) for s, d in cls) for cls in classes)


def _tree(f: dict) -> TreeTopology:
    arrays = {k: np.asarray(f[k], dtype=np.int32) for k in _TREE_ARRAYS}
    return TreeTopology(p=int(f["p"]), dual=bool(f["dual"]),
                        roots=tuple(int(r) for r in f["roots"]),
                        up_pairs=_pairs(f["up_pairs"]),
                        down_pairs=_pairs(f["down_pairs"]), **arrays)


def _hierarchy(f: dict) -> HierarchicalTopology:
    return HierarchicalTopology(
        p=int(f["p"]), levels=tuple(int(s) for s in f["levels"]),
        strides=tuple(int(s) for s in f["strides"]),
        group_size=int(f["group_size"]), num_groups=int(f["num_groups"]),
        group_tree=_tree(f["group_tree"]), inter_topo=_tree(f["inter_topo"]),
        level_rings=tuple((tuple((int(a), int(b)) for a, b in fwd),
                           tuple((int(a), int(b)) for a, b in bwd))
                          for fwd, bwd in f["level_rings"]))


def from_reference(fields: dict):
    """The port's counterpart of a reference object given as a field dict:
    a :class:`CommModel` (keys ``alpha``, ``beta``, ...), a
    :class:`HierarchicalTopology` (``levels``, ``inter_topo``, ...) or a
    :class:`TreeTopology` (``parent``, ``phi``, ...)."""
    if "alpha" in fields:
        return CommModel(alpha=float(fields["alpha"]),
                         beta=float(fields["beta"]),
                         gamma=float(fields.get("gamma", 0.0)),
                         name=str(fields.get("name", "custom")))
    if "levels" in fields:
        return _hierarchy(fields)
    if "parent" in fields:
        return _tree(fields)
    raise ValueError(f"not a reference topology or CommModel: "
                     f"keys {sorted(fields)}")


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: move the bits through int16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree, device=None):
    """The reference's parameter tree (nested dicts, lists and tuples of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's:
    the same nesting, every leaf a tensor of the same dtype (bf16 included)
    and bits on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf(node, dev)

    return conv(tree)
