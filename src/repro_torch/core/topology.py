"""Post-order binary-tree topologies for the doubly-pipelined dual-root allreduce.

The paper (Träff 2021) organizes ``p`` processors into two post-order numbered,
as-balanced-as-possible binary trees whose roots exchange data ("dual roots").
This module builds those trees for *arbitrary* ``p`` (the paper's ``p = 2^h - 2``
is the perfectly-balanced special case), plus the static schedule constants the
SPMD implementation needs:

* ``parent/child0/child1`` — tree edges. Following the paper, the subtree rooted
  at post-order node ``i`` covers ranks ``[i', i'']`` (left) and ``[i''+1, i-1]``
  (right); the *first* child is ``i-1`` (root of the right range) and the
  *second* child is ``i''`` (root of the left range). This ordering is what makes
  the reduction correct for non-commutative operators.
* ``depth`` — ``d_i`` in Algorithm 1 (root depth 0).
* ``phi`` — per-node schedule offset. Node ``i`` executes its round-``j``
  A-step (exchange with child0), B-step (child1) and C-step (parent / dual root)
  at global steps ``phi[i]+3j``, ``phi[i]+3j+1``, ``phi[i]+3j+2``. The recursion
  ``phi[c0] = phi[i]-2``, ``phi[c1] = phi[i]-1`` aligns a child's C-step with its
  parent's A/B-step on the shared edge, reproducing Algorithm 1's indices
  exactly (parent sends ``Y[j-(d_i+1)]`` down, child receives ``Y[j-d_i]``).
* 3 static *edge classes*: every edge is active only at global steps with a fixed
  residue ``(phi[child]+2) mod 3``, so the full edge set partitions into three
  static ``ppermute`` permutations — the key to an SPMD realization.

This is the port's own copy of ``repro.core.topology`` (numpy only): importing
the reference module would run ``repro/core/__init__.py`` and with it JAX.
Parity with the reference is held by ``tests/test_torch_topology.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

__all__ = [
    "TreeTopology",
    "HierarchicalTopology",
    "build_dual_tree",
    "build_single_tree",
    "build_hierarchy",
    "expand_tree_over_stripes",
    "validate_topology",
    "as_levels",
    "resolve_levels",
    "resolve_group_size",
    "default_group_size",
]

NO_NODE = -1


def _build_postorder(lo: int, hi: int, parent: np.ndarray, c0: np.ndarray,
                     c1: np.ndarray, depth: np.ndarray, par_depth: int) -> int:
    """Recursively build a balanced post-order tree over ranks [lo, hi].

    Returns the root of the range (== hi). The remaining ``n-1`` nodes split
    into a left range of ``ceil((n-1)/2)`` and a right range of the rest, so the
    tree is as balanced and complete as possible for any ``n``.
    """
    root = hi
    depth[root] = par_depth
    n = hi - lo + 1
    if n == 1:
        return root
    n_left = (n - 1 + 1) // 2  # ceil((n-1)/2)
    left_lo, left_hi = lo, lo + n_left - 1
    right_lo, right_hi = lo + n_left, hi - 1
    # Second child = root of the left range [i', i''].
    lroot = _build_postorder(left_lo, left_hi, parent, c0, c1, depth, par_depth + 1)
    c1[root] = lroot
    parent[lroot] = root
    # First child = root of the right range [i''+1, i-1] (== i-1), if non-empty.
    if right_hi >= right_lo:
        rroot = _build_postorder(right_lo, right_hi, parent, c0, c1, depth, par_depth + 1)
        c0[root] = rroot
        parent[rroot] = root
    return root


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """Static schedule description for a (dual- or single-rooted) tree allreduce."""

    p: int
    dual: bool
    parent: np.ndarray      # (p,) int32, NO_NODE for roots
    child0: np.ndarray      # (p,) int32, NO_NODE if absent (first child, rank i-1)
    child1: np.ndarray      # (p,) int32, NO_NODE if absent (second child)
    depth: np.ndarray       # (p,) int32, d_i
    phi: np.ndarray         # (p,) int32 schedule offsets
    roots: tuple            # (root0,) or (root0, root1); root0 owns the LOWER ranks
    tree_id: np.ndarray     # (p,) int32: 0 = lower tree, 1 = upper tree
    # Static ppermute pairs per step-residue class e in {0,1,2}:
    #   up_pairs[e]   : child -> parent edges + both root->root pairs
    #   down_pairs[e] : parent -> child edges
    up_pairs: tuple         # tuple of 3 tuples of (src, dst)
    down_pairs: tuple

    @property
    def max_depth(self) -> int:
        return int(self.depth.max(initial=0))

    def num_steps(self, num_blocks: int) -> int:
        """Global steps until every node holds every result block.

        Node ``i`` receives result block ``j - depth[i]`` at its C-step
        ``phi[i] + 3j + 2``; the last one (``j = num_blocks-1+depth[i]``) lands at
        ``phi[i] + 3*(num_blocks-1+depth[i]) + 2``.
        """
        if self.p == 1:
            return 0
        last = int(np.max(self.phi + 3 * self.depth))
        return last + 3 * (num_blocks - 1) + 3

    def num_macro_rounds(self, num_blocks: int) -> int:
        return -(-self.num_steps(num_blocks) // 3)

    def active_classes(self) -> tuple:
        """Residue classes that actually carry an edge (e.g. p=2 has one)."""
        return tuple(e for e in range(3) if self.up_pairs[e] or self.down_pairs[e])


def _edge_classes(p: int, parent: np.ndarray, phi: np.ndarray,
                  roots: Sequence[int]) -> tuple:
    up = [[], [], []]
    down = [[], [], []]
    for i in range(p):
        pa = int(parent[i])
        if pa == NO_NODE:
            continue
        e = int((phi[i] + 2) % 3)
        up[e].append((i, pa))
        down[e].append((pa, i))
    if len(roots) == 2:
        r0, r1 = roots
        e = int((phi[r0] + 2) % 3)
        # Both directions of the dual-root exchange ride the up-permutation.
        up[e].append((r0, r1))
        up[e].append((r1, r0))
    return tuple(tuple(c) for c in up), tuple(tuple(c) for c in down)


def _assign_phi(p: int, c0: np.ndarray, c1: np.ndarray, roots: Sequence[int],
                depth: np.ndarray) -> np.ndarray:
    phi = np.full(p, NO_NODE, dtype=np.int32)
    dmax = int(depth.max(initial=0))
    stack = [(r, 2 * dmax) for r in roots]
    while stack:
        node, val = stack.pop()
        phi[node] = val
        if c0[node] != NO_NODE:
            stack.append((int(c0[node]), val - 2))
        if c1[node] != NO_NODE:
            stack.append((int(c1[node]), val - 1))
    assert (phi >= 0).all()
    return phi


@functools.lru_cache(maxsize=1024)
def build_dual_tree(p: int) -> TreeTopology:
    """The paper's topology: two post-order trees over ranks [0, p0) and [p0, p).

    ``p0 = ceil(p/2)`` so the lower tree is never the smaller one. ``p == 1``
    degenerates to a single node; ``p == 2`` to the bare dual-root exchange.
    Memoized: the cost model's block-count descent evaluates T(b) many times
    per call and each evaluation needs the topology; treat the result (and
    its numpy arrays) as read-only.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    parent = np.full(p, NO_NODE, dtype=np.int32)
    c0 = np.full(p, NO_NODE, dtype=np.int32)
    c1 = np.full(p, NO_NODE, dtype=np.int32)
    depth = np.zeros(p, dtype=np.int32)
    tree_id = np.zeros(p, dtype=np.int32)
    if p == 1:
        roots = (0,)
        phi = np.zeros(1, dtype=np.int32)
        up, down = _edge_classes(p, parent, phi, roots)
        return TreeTopology(p, True, parent, c0, c1, depth, phi, roots, tree_id,
                            up, down)
    p0 = (p + 1) // 2
    r0 = _build_postorder(0, p0 - 1, parent, c0, c1, depth, 0)
    r1 = _build_postorder(p0, p - 1, parent, c0, c1, depth, 0)
    tree_id[p0:] = 1
    roots = (r0, r1)
    phi = _assign_phi(p, c0, c1, roots, depth)
    up, down = _edge_classes(p, parent, phi, roots)
    return TreeTopology(p, True, parent, c0, c1, depth, phi, roots, tree_id,
                        up, down)


@functools.lru_cache(maxsize=1024)
def build_single_tree(p: int) -> TreeTopology:
    """Single doubly-pipelined tree (paper §1.2 remark): root = p-1, no dual.
    Memoized; treat the result as read-only."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    parent = np.full(p, NO_NODE, dtype=np.int32)
    c0 = np.full(p, NO_NODE, dtype=np.int32)
    c1 = np.full(p, NO_NODE, dtype=np.int32)
    depth = np.zeros(p, dtype=np.int32)
    tree_id = np.zeros(p, dtype=np.int32)
    root = _build_postorder(0, p - 1, parent, c0, c1, depth, 0)
    roots = (root,)
    phi = _assign_phi(p, c0, c1, roots, depth)
    up, down = _edge_classes(p, parent, phi, roots)
    return TreeTopology(p, False, parent, c0, c1, depth, phi, roots, tree_id,
                        up, down)


@dataclasses.dataclass(frozen=True)
class HierarchicalTopology:
    """N-level topology: ``p`` ranks factored into nested contiguous groups.

    ``levels`` lists the ring sizes of the *intra*-group levels, innermost
    (fastest links) first — e.g. ``(4,)`` is the classic two-level node/pod
    split (4-chip ICI node, dual tree over nodes) and ``(4, 2)`` is a
    three-level chip/node/pod shape (4-chip ICI ring inside a node, 2-node
    ring inside a pod, dual tree over the ``p // 8`` pods). The slowest level
    is always the dual tree over the ``num_groups = p // prod(levels)``
    top-level groups; ``group_size`` is ``prod(levels)``, the ranks per
    top-level group.

    Ranks are laid out contiguously and level coordinates nest little-endian:
    rank ``i`` sits in top-level group ``i // group_size`` and its level-``j``
    ring coordinate is ``(i // strides[j]) % levels[j]`` with
    ``strides[j] = prod(levels[:j])``.

    ``inter_topo`` instantiates the group tree once per shard stripe
    ``j in [0, group_size)`` — stripe ``j`` is the rank set
    ``{q * group_size + j}`` — expanded into a single p-rank
    :class:`TreeTopology` whose three ppermute classes carry all stripes'
    (disjoint) edges at once. ``level_rings[j]`` holds the
    ``(forward, backward)`` ppermute pairs of the level-``j`` ring for the
    reduce-scatter / all-gather stages (``ring_fwd``/``ring_bwd`` alias
    level 0 for the two-level call sites).
    """

    p: int
    levels: tuple               # intra-level ring sizes, innermost first
    strides: tuple              # rank stride of each level: prod(levels[:j])
    group_size: int             # prod(levels): ranks per top-level group
    num_groups: int             # p // group_size
    group_tree: TreeTopology    # dual tree over the num_groups groups
    inter_topo: TreeTopology    # group tree expanded over all stripes
    level_rings: tuple          # per level: (fwd_pairs, bwd_pairs)

    @property
    def ring_fwd(self) -> tuple:
        """Innermost-level ring, +1 direction (two-level compatibility)."""
        return self.level_rings[0][0] if self.level_rings else ()

    @property
    def ring_bwd(self) -> tuple:
        return self.level_rings[0][1] if self.level_rings else ()


def expand_tree_over_stripes(gt: TreeTopology, s: int) -> TreeTopology:
    """Instantiate a g-node tree once per stripe ``j in [0, s)``.

    Group-tree node ``q`` of stripe ``j`` becomes global rank ``q*s + j``;
    the stripes are rank-disjoint, so the union of their edges still forms
    three valid (each src/dst at most once) ppermute classes.

    NOTE: the result is an *engine schedule*, not a paper tree —
    :func:`validate_topology` does not apply to it. ``roots`` lists only the
    stripe-0 representatives (the engine tests ``len(roots) == 2`` for the
    dual exchange; per-rank root-ness comes from ``parent == NO_NODE``), and
    ``child0 == i-1`` holds per group tree, not per expanded rank. The
    contract is checked by ``test_hierarchy_stripe_expansion_invariants``.
    """
    if s == 1:
        return gt
    g, p = gt.p, gt.p * s

    def node_map(arr):
        out = np.full(p, NO_NODE, dtype=np.int32)
        for q in range(g):
            if arr[q] != NO_NODE:
                out[q * s:(q + 1) * s] = \
                    int(arr[q]) * s + np.arange(s, dtype=np.int32)
        return out

    def val_map(arr):
        return np.repeat(np.asarray(arr), s).astype(arr.dtype)

    expand_pairs = lambda classes: tuple(
        tuple((a * s + j, c * s + j) for (a, c) in cls for j in range(s))
        for cls in classes)

    return TreeTopology(
        p=p, dual=gt.dual,
        parent=node_map(gt.parent), child0=node_map(gt.child0),
        child1=node_map(gt.child1), depth=val_map(gt.depth),
        phi=val_map(gt.phi),
        roots=tuple(int(r) * s for r in gt.roots),  # stripe-0 representatives
        tree_id=val_map(gt.tree_id),
        up_pairs=expand_pairs(gt.up_pairs),
        down_pairs=expand_pairs(gt.down_pairs))


def default_group_size(p: int) -> int:
    """Largest of {4, 2} dividing p, else 1 (flat)."""
    for s in (4, 2):
        if p % s == 0 and p // s >= 1:
            return s
    return 1


def as_levels(spec) -> tuple | None:
    """Normalize a hierarchy spec to a level tuple (or None for 'default').

    Accepted forms, all meaning "ring sizes of the intra levels, innermost
    first": ``None`` (caller resolves a default), an ``int`` (the classic
    two-level group size), or a sequence of ints (N-level). Size-1 levels are
    dropped — a one-rank ring is a no-op stage.
    """
    if spec is None:
        return None
    if isinstance(spec, (int, np.integer)):
        spec = (int(spec),)
    lv = tuple(int(s) for s in spec)
    if any(s < 1 for s in lv):
        raise ValueError(f"level sizes must be >= 1, got {lv}")
    return tuple(s for s in lv if s > 1)


def resolve_levels(p: int, spec=None) -> tuple | None:
    """The level spec a hierarchical allreduce would execute with, or None if
    no *proper* hierarchy is feasible at this ``p`` (every level must divide
    out of ``p`` and leave >= 2 top-level groups for the slow-stage tree).
    THE single feasibility rule — the auto switch, the cost model, and the
    benches must all consult this."""
    try:
        lv = as_levels(spec)
    except (TypeError, ValueError):
        return None
    if lv is None:
        lv = as_levels(default_group_size(p))
    S = int(np.prod(lv)) if lv else 1
    return lv if (S > 1 and p % S == 0 and p // S >= 2) else None


def resolve_group_size(p: int, group_size=None) -> int | None:
    """Two-level compatibility wrapper over :func:`resolve_levels`: the ranks
    per top-level group the hierarchy would execute with, or None."""
    lv = resolve_levels(p, group_size)
    return int(np.prod(lv)) if lv else None


def _level_ring(p: int, size: int, stride: int) -> tuple:
    """Forward ppermute pairs of the ring that advances one level coordinate:
    rank ``i`` sends to the rank whose level coordinate ``(i//stride) % size``
    is one higher (mod ``size``), all other coordinates equal."""
    out = []
    for i in range(p):
        c = (i // stride) % size
        out.append((i, i + (((c + 1) % size) - c) * stride))
    return tuple(out)


def build_hierarchy(p: int, group_size=None) -> HierarchicalTopology:
    """Nested contiguous groups per ``group_size`` + a dual tree over the
    top-level groups.

    ``group_size`` is a hierarchy spec as accepted by :func:`as_levels`:
    ``None`` (auto: 4, then 2, then flat), an int (two-level), or a tuple of
    per-level ring sizes innermost-first (N-level, e.g. ``(4, 2)`` = 4-chip
    node ring, 2-node pod ring, dual tree over pods). Memoized; treat the
    result (and its numpy arrays) as read-only.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    lv = as_levels(group_size)
    if lv is None:
        lv = as_levels(default_group_size(p))
    return _build_hierarchy_cached(p, lv)


@functools.lru_cache(maxsize=512)
def _build_hierarchy_cached(p: int, levels: tuple) -> HierarchicalTopology:
    S = int(np.prod(levels)) if levels else 1
    if p % S != 0:
        raise ValueError(f"level spec {levels} (prod {S}) must divide p={p}")
    g = p // S
    gt = build_dual_tree(g)
    inter = expand_tree_over_stripes(gt, S)
    strides, rings, t = [], [], 1
    for s in levels:
        strides.append(t)
        fwd = _level_ring(p, s, t)
        rings.append((fwd, tuple((dst, src) for (src, dst) in fwd)))
        t *= s
    return HierarchicalTopology(p, levels, tuple(strides), S, g, gt, inter,
                                tuple(rings))


def validate_topology(topo: TreeTopology) -> None:
    """Structural invariants; raises AssertionError on violation."""
    p = topo.p
    # Every non-root has a parent; roots have none.
    for i in range(p):
        if i in topo.roots:
            assert topo.parent[i] == NO_NODE
        else:
            assert 0 <= topo.parent[i] < p
    # Child pointers are mutual and post-order: child0 == i-1 when present.
    for i in range(p):
        for c in (topo.child0[i], topo.child1[i]):
            if c != NO_NODE:
                assert topo.parent[c] == i
                assert topo.depth[c] == topo.depth[i] + 1
        if topo.child0[i] != NO_NODE:
            assert topo.child0[i] == i - 1, (i, topo.child0[i])
    # phi recursion.
    for i in range(p):
        if topo.child0[i] != NO_NODE:
            assert topo.phi[topo.child0[i]] == topo.phi[i] - 2
        if topo.child1[i] != NO_NODE:
            assert topo.phi[topo.child1[i]] == topo.phi[i] - 1
    # Subtrees cover contiguous rank ranges (post-order property).
    def span(i):
        lo = hi = i
        for c in (topo.child0[i], topo.child1[i]):
            if c != NO_NODE:
                clo, chi = span(c)
                lo, hi = min(lo, clo), max(hi, chi)
        return lo, hi
    for r in topo.roots:
        lo, hi = span(r)
        assert hi == r  # post-order: root is the highest rank in its tree
        sub = sorted(_collect(topo, r))
        assert sub == list(range(lo, hi + 1))
    # Balance: depth within ceil(log2(n+1)) + 1 of optimal.
    for t, r in enumerate(topo.roots):
        n = len(_collect(topo, r))
        dmax = max(topo.depth[i] for i in _collect(topo, r))
        assert dmax <= int(np.ceil(np.log2(n + 1))), (n, dmax)
    # Edge classes: each device appears at most once as src / once as dst per perm.
    for pairs in topo.up_pairs + topo.down_pairs:
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        assert len(set(srcs)) == len(srcs)
        assert len(set(dsts)) == len(dsts)


def _collect(topo: TreeTopology, r: int) -> list:
    out, stack = [], [r]
    while stack:
        i = stack.pop()
        out.append(i)
        for c in (topo.child0[i], topo.child1[i]):
            if c != NO_NODE:
                stack.append(int(c))
    return out
