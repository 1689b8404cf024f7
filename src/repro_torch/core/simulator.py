"""Round-based message-passing simulator of the doubly-pipelined dual-root
allreduce.

This is a *reference executor* of the exact global schedule the tree engine
runs (see :mod:`repro_torch.core.dptree`): global steps ``s`` proceed
in macro-rounds of three residue classes; at each step the static edge class
``E_{s mod 3}`` carries one up-permutation (partial blocks child->parent, plus
the dual-root exchange) and one down-permutation (result blocks parent->child).

It serves three purposes:

1. validate correctness of the schedule — including for *non-commutative*
   (merely associative) operators, which exercises the paper's ordering rules
   (first child = ``i-1`` reduces as ``t . Y``, lower root combines ``Y . t``);
2. count the exact number of active communication steps and compare against the
   paper's ``4h - 3 + 3(b-1)`` latency formula;
3. provide an oracle for the engine's unit tests.

The port's own numpy-only copy of ``repro.core.simulator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.topology import NO_NODE, TreeTopology, build_dual_tree

__all__ = ["SimResult", "simulate_allreduce", "count_active_steps"]


@dataclasses.dataclass
class SimResult:
    outputs: list          # per-rank result vectors
    num_steps: int         # global steps executed (incl. idle residue classes)
    active_steps: int      # steps where at least one edge carried a real block
    blocks_sent: int       # total non-masked block transmissions (both perms)


def _blockify(x: np.ndarray, b: int) -> np.ndarray:
    m = x.shape[0]
    blk = -(-m // b)
    pad = b * blk - m
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x.reshape(b, blk, *x.shape[1:])


def simulate_allreduce(
    inputs: Sequence[np.ndarray],
    num_blocks: int,
    op: Callable[[np.ndarray, np.ndarray], np.ndarray] = np.add,
    topo: TreeTopology | None = None,
) -> SimResult:
    """Run Algorithm 1 under the static SPMD schedule and return all outputs.

    ``op(a, b)`` must be associative; it is applied in the paper's rank order so
    commutativity is NOT required. ``inputs[i]`` is rank ``i``'s vector.
    """
    p = len(inputs)
    topo = topo or build_dual_tree(p)
    assert topo.p == p
    b = num_blocks
    m = inputs[0].shape[0]
    Y = [_blockify(np.array(x, copy=True), b) for x in inputs]
    trail = inputs[0].shape[1:]
    if p == 1:
        return SimResult([Y[0].reshape(-1, *trail)[:m]], 0, 0, 0)

    phi, dep = topo.phi, topo.depth
    c0, c1, par = topo.child0, topo.child1, topo.parent
    r_lo = topo.roots[0]
    dual = {topo.roots[0]: topo.roots[-1], topo.roots[-1]: topo.roots[0]} \
        if topo.dual and len(topo.roots) == 2 else {}

    S = topo.num_steps(b)
    active_steps = 0
    blocks_sent = 0

    def valid(j):
        return 0 <= j < b

    for s in range(S):
        e = s % 3
        up_msgs = {}    # dst -> block payload (partial blocks going up / dual)
        down_msgs = {}  # dst -> block payload (result blocks going down)
        step_active = False
        # ---- sends (mirror of the two ppermutes with masked payloads) ----
        for (src, dst) in topo.up_pairs[e]:
            j = (s - 2 - phi[src]) // 3  # src is in C-role on this edge class
            if (s - phi[src]) % 3 == 2 and valid(j):
                up_msgs[dst] = (src, j, Y[src][j].copy())
                step_active = True
                blocks_sent += 1
        for (src, dst) in topo.down_pairs[e]:
            # src is the parent, in A-role (dst==child0) or B-role (dst==child1).
            rel = s - phi[src]
            jj = rel // 3 if rel % 3 == 0 else (rel - 1) // 3
            jd = jj - dep[src] - 1
            if valid(jd):
                down_msgs[dst] = (src, jd, Y[src][jd].copy())
                step_active = True
                blocks_sent += 1
        # ---- receives + combines ----
        for dst, (src, j, blk) in up_msgs.items():
            if dst in dual and src == dual[dst]:
                # Dual-root exchange: lower-ranked root combines Y . t.
                if dst == r_lo:
                    Y[dst][j] = op(Y[dst][j], blk)
                else:
                    Y[dst][j] = op(blk, Y[dst][j])
            else:
                # Parent receives a child partial; Algorithm 1 lines 4/6: t . Y.
                Y[dst][j] = op(blk, Y[dst][j])
        for dst, (src, jd, blk) in down_msgs.items():
            Y[dst][jd] = blk  # finished result block from the parent
        if step_active:
            active_steps += 1

    outs = [y.reshape(-1, *trail)[:m] for y in Y]
    return SimResult(outs, S, active_steps, blocks_sent)


def count_active_steps(p: int, num_blocks: int) -> tuple:
    """(simulated_active_steps, paper_formula_steps) for perfectly balanced p.

    Paper: ``4h - 3 + 3(b-1)`` for ``p = 2^h - 2``. For general p we report the
    formula with ``h = max_depth + 1`` as the comparable quantity.
    """
    topo = build_dual_tree(p)
    xs = [np.zeros(num_blocks, dtype=np.float64) for _ in range(p)]
    res = simulate_allreduce(xs, num_blocks, topo=topo)
    h = topo.max_depth + 1
    paper = (4 * h - 3) + 3 * (num_blocks - 1) if p > 2 else num_blocks
    return res.active_steps, paper
