"""PyTorch implementations of the paper's collectives over a transport.

The port of ``repro.core.dptree``. Every function takes the stacked buffer
``x`` of the ranks a transport holds (dim 0 walks ``comm.ranks()``; on
:class:`~repro_torch.core.transport.LocalTransport` that is all ``p`` ranks,
rank ``r`` in row ``r``) and returns the reduction over all ``p`` ranks, in
every row. ``x`` is ``(n, m)`` or ``(n, m, *trail)``: payloads pipeline over
dim 1, trailing dims ride along.

The schedule is static: each step's per-rank block indices and masks come
from the topology alone, so they are computed once on the host with numpy
and uploaded as ``(steps, n)`` tensors; a step is then a handful of gathers,
two ``ppermute`` s, one combine and one in-place scatter.

The shared tree engine is *fused* for the commutative ops (named ``"add"``,
``"max"``, ``"min"``, ``"mul"``): the child0 partial a node receives at its
A-step is deferred in a carried ``pend`` and folded into its B-step, so the
two child combines plus the local block are ONE three-operand pass,
``op(op(t_up, pend), cur)`` — the ``combine3`` kernel over the whole
``(n, blk)`` slab of stacked ranks in one launch — and the root's
dual-combine rides the same pass. Masked writes land in a per-rank scratch
block row ``b``, updated in place. A callable ``op`` (merely associative, not
necessarily commutative) takes the general path, which keeps Algorithm 1's
``t (.) Y`` / lower-root ``Y (.) t`` order; it is called on stacked
``(n, blk, *trail)`` operands and must act row by row.

Implemented algorithms:

* :func:`dptree_allreduce`  — doubly-pipelined dual-root (the paper, Alg. 1)
* :func:`sptree_allreduce`  — single-tree doubly-pipelined variant (§1.2)
* :func:`redbcast_allreduce`— pipelined reduce + pipelined bcast (User-Allreduce1)
* :func:`ring_allreduce`    — bidirectional ring reduce-scatter + all-gather
* :func:`hier_allreduce`    — hierarchical (2..N levels): per-level ring
  reduce-scatter down, dptree over shard stripes at the slowest level
  (optionally on a bf16 wire with f32 combines), per-level all-gather up
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from repro_torch.core.topology import (NO_NODE, HierarchicalTopology,
                                       TreeTopology, build_dual_tree,
                                       build_hierarchy, build_single_tree)
from repro_torch.kernels import block_combine, quantize, ref
from repro_torch.obs import probe as _obs_probe

__all__ = [
    "dptree_allreduce",
    "sptree_allreduce",
    "redbcast_allreduce",
    "ring_allreduce",
    "hier_allreduce",
]

Op = Union[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]

# Operators the fused engine may reassociate/commute, by kernel name.
COMMUTATIVE_OPS = block_combine.OPS


def _op_fn(op: Op) -> Callable:
    if callable(op):
        return op
    if op not in COMMUTATIVE_OPS:
        raise ValueError(f"unknown op {op!r}; want one of {COMMUTATIVE_OPS} "
                         "or a callable")
    return ref.OPS[op]


def _op_identity(op_name: str, dtype: torch.dtype):
    if op_name == "add":
        return 0
    if op_name == "mul":
        return 1
    if dtype.is_floating_point:
        # True infinities, not finfo.min/max: payloads legitimately contain
        # -inf (masked logits), which must win against the identity.
        return float("-inf") if op_name == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op_name == "max" else info.max


def _combine3_local(a, b, c, op_name: str) -> torch.Tensor:
    """Fused ``op(op(a, b), c)``: the combine3 kernel for the dtypes it
    takes (the plain version on the CPU), the plain ops for any other."""
    if a.dtype in block_combine.DTYPES:
        return block_combine.combine3(a, b, c, op=op_name)
    f = ref.OPS[op_name]
    return f(f(a, b), c)


def _check_stacked(x: torch.Tensor, comm) -> None:
    if x.device != comm.device:
        raise ValueError(f"payload on {x.device}, transport on {comm.device}")
    if x.ndim < 2 or x.shape[0] != len(comm.ranks()):
        raise ValueError(f"payload must be (ranks={len(comm.ranks())}, m, ...),"
                         f" got {tuple(x.shape)}")


def _blockify(x: torch.Tensor, b: int) -> tuple:
    """Split dim 1 into b pipeline blocks plus one zero scratch block row:
    ``(n, m, *trail) -> (n, b + 1, blk, *trail)``, a fresh buffer the engine
    updates in place."""
    n, m, trail = x.shape[0], x.shape[1], tuple(x.shape[2:])
    blk = -(-m // b)
    Y = x.new_zeros((n, b + 1, blk) + trail)
    Y[:, :b].view((n, b * blk) + trail)[:, :m].copy_(x)
    return Y, m


def _unblockify(Y: torch.Tensor, b: int, m: int) -> torch.Tensor:
    n, blk, trail = Y.shape[0], Y.shape[2], tuple(Y.shape[3:])
    return Y[:, :b].view((n, b * blk) + trail)[:, :m]


def _host_ranks(comm) -> np.ndarray:
    return comm.ranks().cpu().numpy()


def _upload(tables: list, dev, n_trail: int) -> tuple:
    """Stack equally shaped host tables into one device tensor. Bool tables
    gain ``n_trail + 1`` unit dims so a step's row broadcasts over a block."""
    t = torch.from_numpy(np.stack(tables)).to(dev)
    if t.dtype == torch.bool:
        t = t.reshape(t.shape + (1,) * (n_trail + 1))
    return t.unbind(0)


def _tree_allreduce(x: torch.Tensor, comm, topo: TreeTopology,
                    num_blocks: int, op: Op, op_rev: Op | None) -> torch.Tensor:
    """Shared fused engine for the dual-root and single-tree variants."""
    p = topo.p
    if p == 1:
        return x
    _check_stacked(x, comm)
    b = int(num_blocks)
    fused = isinstance(op, str) and (op_rev is None or op_rev == op)
    op_name = op if fused else None
    if fused:
        _op_fn(op)  # rejects an unknown name
    op_rev = op_rev or op
    Y, m = _blockify(x, b)
    n, blk, trail = Y.shape[0], Y.shape[2], tuple(Y.shape[3:])
    Yf = Y.view((n * (b + 1), blk) + trail)
    dev = x.device

    # ---- the static schedule, per (step, local row), on the host ----------
    rk = _host_ranks(comm)
    base = (np.arange(n, dtype=np.int64) * (b + 1))[None, :]
    phi = topo.phi.astype(np.int64)[rk][None, :]
    dep = topo.depth.astype(np.int64)[rk][None, :]
    has_c0 = (topo.child0 != NO_NODE)[rk][None, :]
    has_c1 = (topo.child1 != NO_NODE)[rk][None, :]
    has_par = (topo.parent != NO_NODE)[rk][None, :]
    is_root = (topo.parent == NO_NODE)[rk][None, :]
    is_lower_root = is_root & (topo.tree_id[rk][None, :] == 0)
    dual_active = topo.dual and len(topo.roots) == 2

    classes = topo.active_classes()
    R = topo.num_macro_rounds(b)
    cls = np.tile(np.asarray(classes, np.int64), R)
    s = (3 * np.repeat(np.arange(R, dtype=np.int64), len(classes)) + cls)
    rel = s[:, None] - phi
    mod = rel % 3
    jA, jB, jC = rel // 3, (rel - 1) // 3, (rel - 2) // 3
    in_range = lambda j: (j >= 0) & (j < b)
    clip = lambda j: np.clip(j, 0, b - 1)
    amC_par = (mod == 2) & has_par
    amC_root = (mod == 2) & is_root & dual_active
    jRecv = jC - dep

    if op_name is not None:
        slotB = mod == 1
        amA = (mod == 0) & has_c0
        jAB = np.where(mod == 0, jA, jB)
        validA = amA & in_range(jA)
        upd_idx = np.where(slotB, jB, np.where(amC_root, jC, jRecv))
        do_upd = ((slotB & has_c1 & in_range(jB))
                  | (amC_root & in_range(jC))
                  | (amC_par & in_range(jRecv)))
        row = np.where(do_upd, clip(upd_idx), b)
        # The combine's third operand, where(slotB, cur_b, up_out), is read
        # straight from the row it selects: one gather instead of two.
        i_up, i_down, i_cur, i_row = _upload(
            [base + clip(jC), base + clip(jAB - dep - 1),
             base + np.where(slotB, clip(jB), clip(jC)), base + row],
            dev, len(trail))
        m_validA, m_par = _upload([validA, amC_par], dev, len(trail))
        ident = _op_identity(op_name, Y.dtype)
        pend = torch.full((n, blk) + trail, ident, dtype=Y.dtype, device=dev)
        for k, e in enumerate(cls.tolist()):
            up_out = Yf.index_select(0, i_up[k])   # C-role: partial up / dual
            t_up = comm.ppermute(up_out, topo.up_pairs[e])
            t_down = (comm.ppermute(Yf.index_select(0, i_down[k]),
                                    topo.down_pairs[e])
                      if topo.down_pairs[e] else None)
            # No operand masking: wherever the write lands in a REAL row,
            # t_up is a genuine partial and pend is identity except at the
            # B-slot by construction; other writes go to the scratch row.
            comb = _combine3_local(t_up, pend, Yf.index_select(0, i_cur[k]),
                                   op_name)
            pend = torch.where(m_validA[k], t_up, ident)
            # amC_par never holds in a class without down edges.
            upd = comb if t_down is None else torch.where(m_par[k], t_down,
                                                          comb)
            Yf.index_copy_(0, i_row[k], upd)  # in place: masked write
        return _unblockify(Y, b, m)

    # ---- general path: seed-ordered, for non-commutative operators ---------
    f, f_rev = _op_fn(op), _op_fn(op_rev)
    amA = (mod == 0) & has_c0
    amB = (mod == 1) & has_c1
    amAB = amA | amB
    jAB = np.where(amA, jA, jB)
    upd_idx = np.where(amAB, jAB, np.where(amC_root, jC, jRecv))
    do_upd = ((amAB & in_range(jAB))
              | (amC_root & in_range(jC))
              | (amC_par & in_range(jRecv)))
    row = np.where(do_upd, clip(upd_idx), b)
    i_up, i_down, i_ab, i_row = _upload(
        [base + clip(jC), base + clip(jAB - dep - 1), base + clip(jAB),
         base + row], dev, len(trail))
    m_ab, m_root = _upload([amAB, amC_root], dev, len(trail))
    m_lower = _upload([is_lower_root[0]], dev, len(trail))[0]
    for k, e in enumerate(cls.tolist()):
        up_out = Yf.index_select(0, i_up[k])   # C-role payload AND own block
        down_out = Yf.index_select(0, i_down[k])
        t_up = comm.ppermute(up_out, topo.up_pairs[e])
        t_down = (comm.ppermute(down_out, topo.down_pairs[e])
                  if topo.down_pairs[e] else torch.zeros_like(down_out))
        red_ab = f(t_up, Yf.index_select(0, i_ab[k]))   # Alg. 1: t (.) Y
        red_root = torch.where(m_lower, f_rev(up_out, t_up),  # Y (.) t
                               f(t_up, up_out))              # t (.) Y
        upd = torch.where(m_ab[k], red_ab,
                          torch.where(m_root[k], red_root, t_down))
        Yf.index_copy_(0, i_row[k], upd)  # in place: masked write
    return _unblockify(Y, b, m)


def dptree_allreduce(x: torch.Tensor, comm, *, num_blocks: int = 16,
                     op: Op = "add", op_rev: Op | None = None,
                     topo: TreeTopology | None = None) -> torch.Tensor:
    """The paper's doubly-pipelined, dual-root reduction-to-all (Algorithm 1).

    ``x`` is the stacked ``(n, m, ...)`` buffer of the transport's ranks;
    returns the elementwise reduction over all ``comm.p`` ranks in every row.
    ``op`` is a commutative op's name (fused path) or an associative
    callable; for non-commutative callables pass ``op_rev`` (same operator —
    the engine applies arguments in rank order; ``op_rev(a, b)`` must equal
    the operator applied as ``a (.) b``, which for plain functions is just
    ``op``).
    """
    topo = topo or build_dual_tree(comm.p)
    nb = max(1, min(int(num_blocks), x.shape[1]))
    return _tree_allreduce(x, comm, topo, nb, op, op_rev)


def sptree_allreduce(x: torch.Tensor, comm, *, num_blocks: int = 16,
                     op: Op = "add", op_rev: Op | None = None,
                     topo: TreeTopology | None = None) -> torch.Tensor:
    """Single doubly-pipelined binary tree (paper §1.2 remark): one tree over
    all p ranks, latency ``4h`` instead of ``4h-3``, but the root performs at
    most two reductions per round."""
    topo = topo or build_single_tree(comm.p)
    nb = max(1, min(int(num_blocks), x.shape[1]))
    return _tree_allreduce(x, comm, topo, nb, op, op_rev)


# --------------------------------------------------------------------------
# Shared ring machinery. ring_allreduce runs it over the whole axis
# (idx = rank, size = p); hier_allreduce runs it within each group
# (idx = local rank, size = group_size, per-group perms). ``idx`` is the
# host vector of each held rank's ring coordinate.
# --------------------------------------------------------------------------

def _ring_layout(x: torch.Tensor, n: int, bidirectional: bool) -> tuple:
    """Chunk the payloads for an n-way ring: (halves, chunk, m, trail).

    Each half is a fresh contiguous ``(ranks, n, width, *trail)`` buffer the
    ring stages update in place. An odd per-rank chunk is padded up to even
    under ``bidirectional`` so the two opposite-direction half-schedules
    move the same byte count.
    """
    r, m, trail = x.shape[0], x.shape[1], tuple(x.shape[2:])
    chunk = -(-m // n)
    if bidirectional and chunk >= 2 and chunk % 2:
        chunk += 1
    X = x.new_zeros((r, n * chunk) + trail)
    X[:, :m].copy_(x)
    X = X.view((r, n, chunk) + trail)
    halves = ([X[:, :, :chunk // 2].contiguous(),
               X[:, :, chunk // 2:].contiguous()]
              if (bidirectional and chunk >= 2) else [X])
    return halves, chunk, m, trail


def _ring_unlayout(out_halves, n: int, chunk: int, m: int,
                   trail) -> torch.Tensor:
    X = (torch.cat(out_halves, dim=2) if len(out_halves) > 1
         else out_halves[0])
    return X.reshape((X.shape[0], n * chunk) + tuple(trail))[:, :m]


def _ring_rows(H: torch.Tensor, size: int, cols: list) -> tuple:
    """Flat view of H and the device row index of each host column vector."""
    r = H.shape[0]
    Hf = H.view((r * size,) + tuple(H.shape[2:]))
    base = np.arange(r, dtype=np.int64) * size
    idx = torch.from_numpy(np.stack([base + c for c in cols])).to(H.device)
    return Hf, idx.unbind(0)


def _ring_reduce_scatter(H, comm, idx, size, perm, sg, op):
    """size-1 steps, in place on H; afterwards the chunk
    ``mod(idx + sg, size)`` is fully reduced on each rank."""
    f = _op_fn(op)
    cols = []
    for t in range(size - 1):
        cols += [np.mod(idx - sg * t, size), np.mod(idx - sg * (t + 1), size)]
    Hf, rows = _ring_rows(H, size, cols)
    for t in range(size - 1):
        send, recv = rows[2 * t], rows[2 * t + 1]
        buf = comm.ppermute(Hf.index_select(0, send), perm)
        Hf.index_copy_(0, recv, f(Hf.index_select(0, recv), buf))
    return H


def _ring_all_gather(H, comm, idx, size, perm, sg):
    """size-1 steps, in place on H, circulating each rank's owned chunk
    ``mod(idx + sg, size)``."""
    cols = []
    for t in range(size - 1):
        cols += [np.mod(idx + sg * (1 - t), size), np.mod(idx - sg * t, size)]
    Hf, rows = _ring_rows(H, size, cols)
    for t in range(size - 1):
        send, recv = rows[2 * t], rows[2 * t + 1]
        Hf.index_copy_(0, recv, comm.ppermute(Hf.index_select(0, send), perm))
    return H


def ring_allreduce(x: torch.Tensor, comm, *, op: Op = "add",
                   bidirectional: bool = True) -> torch.Tensor:
    """Ring allreduce; with ``bidirectional=True`` the vector is split in two
    halves circulating in opposite directions, halving the beta term on
    full-duplex links. An odd per-rank chunk is padded up to even so the two
    half-schedules move the same byte count."""
    p = comm.p
    if p == 1:
        return x
    _check_stacked(x, comm)
    halves, chunk, m, trail = _ring_layout(x, p, bidirectional)
    i = _host_ranks(comm)
    fwd = tuple((k, (k + 1) % p) for k in range(p))
    bwd = tuple(((k + 1) % p, k) for k in range(p))
    out_halves = []
    for H, perm, sg in zip(halves, [fwd, bwd], [1, -1]):
        H = _ring_reduce_scatter(H, comm, i, p, perm, sg, op)
        out_halves.append(_ring_all_gather(H, comm, i, p, perm, sg))
    return _ring_unlayout(out_halves, p, chunk, m, trail)


# --------------------------------------------------------------------------
# Hierarchical (N-level) allreduce: per-level bidirectional-ring
# reduce-scatter down the fast levels -> dptree over the scattered shard
# stripes at the slowest level -> per-level all-gather back up.
# --------------------------------------------------------------------------

def _compress_wire(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 for the slow-stage wire: the cast kernel."""
    return quantize.compress_bf16(x.contiguous())


def _decompress_wire(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 after the slow stage: the cast kernel."""
    return quantize.decompress_bf16(x.contiguous())


def _bf16_wire_op(op: Op) -> Callable:
    """Combine for bf16 wire payloads: decompress both operands to f32,
    reduce in full precision, recompress the result for the next hop."""
    f = _op_fn(op)

    def wire_op(a, b):
        return f(a.float(), b.float()).bfloat16()
    return wire_op


def hier_allreduce(x: torch.Tensor, comm, *, group_size=None,
                   num_blocks: int = 16, op: Op = "add",
                   htopo: HierarchicalTopology | None = None,
                   bidirectional: bool = True,
                   compress_inter_group: bool = False) -> torch.Tensor:
    """Hierarchical allreduce (fabric-aware composition, 2..N levels).

    ``op`` must be commutative and associative (the ring stages reduce in
    ring order, not rank order). ``group_size`` is a hierarchy spec (see
    :func:`repro_torch.core.topology.as_levels`): an int for the classic
    two-level split, a tuple of per-level ring sizes innermost-first, or
    ``None`` (4, then 2, then flat). Stripe ``j`` — the ranks with local
    index ``j`` in each top-level group — runs its own inter-group dual-root
    tree, all stripes at once through the same three ppermute classes.

    ``compress_inter_group=True`` casts the (f32) shard stripes to bf16 with
    the cast kernel before the slow inter-group stage only; every tree
    combine decompresses to f32, reduces, and recompresses, and the result
    is cast back to f32 before the full-precision all-gather. Non-f32
    payloads pass through uncompressed.
    """
    p = comm.p
    if p == 1:
        return x
    h = htopo or build_hierarchy(p, group_size)
    if h.p != p:
        raise ValueError(f"hierarchy is for p={h.p}, transport has p={p}")
    _check_stacked(x, comm)
    probe = _obs_probe.active()
    if probe is not None and h.levels:
        # the note for direct hier calls; all_reduce's hier branch defers
        # to this one, so a sample is never counted twice (the no-level
        # shape is a flat dptree, and all_reduce notes it)
        probe.note("hier", p, x[0].numel() * x.element_size(), num_blocks,
                   dtype=str(x.dtype).removeprefix("torch."), kind="trace",
                   levels=tuple(h.levels))
    if not h.levels:  # one rank per group: plain flat dptree over all ranks
        nb = max(1, min(int(num_blocks), x.shape[1]))
        return _tree_allreduce(x, comm, h.inter_topo, nb, op, None)
    i = _host_ranks(comm)
    loc = torch.arange(x.shape[0], device=x.device)

    # ---- stage down: per-level bidirectional ring reduce-scatter ---------
    vec, down = x, []
    for s, stride, (fwd, bwd) in zip(h.levels, h.strides, h.level_rings):
        li = np.mod(i // stride, s)
        halves, chunk, m, trail = _ring_layout(vec, s, bidirectional)
        perms, signs = [fwd, bwd][:len(halves)], [1, -1][:len(halves)]
        reduced, shards = [], []
        for H, perm, sg in zip(halves, perms, signs):
            H = _ring_reduce_scatter(H, comm, li, s, perm, sg, op)
            own = torch.from_numpy(np.mod(li + sg, s)).to(x.device)
            reduced.append(H)
            shards.append(H[loc, own])
        down.append((reduced, perms, signs, li, s, chunk, m, trail,
                     tuple(hh.shape[2] for hh in halves)))
        vec = torch.cat(shards, dim=1) if len(shards) > 1 else shards[0]

    # ---- slowest stage: dptree allreduce over the shard stripes ----------
    if h.num_groups > 1:
        nb = max(1, min(int(num_blocks), vec.shape[1]))
        if compress_inter_group and vec.dtype == torch.float32:
            wire_op = _bf16_wire_op(op)
            wire = _tree_allreduce(_compress_wire(vec), comm, h.inter_topo,
                                   nb, wire_op, wire_op)
            vec = _decompress_wire(wire)
        else:
            vec = _tree_allreduce(vec, comm, h.inter_topo, nb, op, None)

    # ---- stage up: per-level ring all-gather, outermost level first ------
    for reduced, perms, signs, li, s, chunk, m, trail, widths in \
            reversed(down):
        pieces = torch.split(vec, list(widths), dim=1)
        outs = []
        for H, perm, sg, piece in zip(reduced, perms, signs, pieces):
            own = torch.from_numpy(np.mod(li + sg, s)).to(x.device)
            H[loc, own] = piece                 # in place
            outs.append(_ring_all_gather(H, comm, li, s, perm, sg))
        vec = _ring_unlayout(outs, s, chunk, m, trail)
    return vec


# --------------------------------------------------------------------------
# User-Allreduce1: pipelined binary-tree reduce followed by pipelined bcast.
# Period-2 schedules; sends to the parent overlap receives from a child in the
# same step (different partners — MPI_Sendrecv-style), so one permutation per
# step suffices in each phase.
# --------------------------------------------------------------------------

def _phase_classes(p, parent, key, roots):
    cls = [[], []]
    for i in range(p):
        pa = int(parent[i])
        if pa == NO_NODE:
            continue
        cls[int(key[i]) % 2].append((i, pa))
    return tuple(tuple(c) for c in cls)


def redbcast_allreduce(x: torch.Tensor, comm, *, num_blocks: int = 16,
                       op: Op = "add",
                       topo: TreeTopology | None = None) -> torch.Tensor:
    """Pipelined reduce-to-root then pipelined broadcast (User-Allreduce1)."""
    p = comm.p
    topo = topo or build_single_tree(p)
    if p == 1:
        return x
    _check_stacked(x, comm)
    f = _op_fn(op)
    b = max(1, min(int(num_blocks), x.shape[1]))
    Y, m = _blockify(x, b)
    n, blk, trail = Y.shape[0], Y.shape[2], tuple(Y.shape[3:])
    Yf = Y.view((n * (b + 1), blk) + trail)
    dev = x.device
    rk = _host_ranks(comm)
    base = (np.arange(n, dtype=np.int64) * (b + 1))[None, :]
    clip = lambda j: np.clip(j, 0, b - 1)
    dmax = topo.max_depth

    # ---------------- reduce phase (period 2, up-traffic only) -----------
    # phi1 follows the same recursion as the dual-root schedule.
    phi1_np = np.zeros(p, np.int64)
    stack = [(topo.roots[0], 2 * dmax)]
    while stack:
        nd, v = stack.pop()
        phi1_np[nd] = v
        if topo.child0[nd] != NO_NODE:
            stack.append((int(topo.child0[nd]), v - 2))
        if topo.child1[nd] != NO_NODE:
            stack.append((int(topo.child1[nd]), v - 1))
    up_cls = _phase_classes(p, topo.parent, phi1_np, topo.roots)
    has_c0 = (topo.child0 != NO_NODE)[rk][None, :]
    has_c1 = (topo.child1 != NO_NODE)[rk][None, :]
    has_par = (topo.parent != NO_NODE)[rk][None, :]
    S1 = int(phi1_np[topo.roots[0]]) + 2 * b
    R1 = -(-S1 // 2)
    steps = np.asarray([2 * r + e for r in range(R1) for e in (0, 1)
                        if up_cls[e]], np.int64)
    if len(steps):
        rel = steps[:, None] - phi1_np[rk][None, :]
        even = rel % 2 == 0
        jr = np.where(even, rel // 2, (rel - 1) // 2)
        ok = (((even & has_c0) | (~even & has_c1)) & (jr >= 0) & (jr < b))
        i_send, i_cur, i_row = _upload(
            [base + clip((rel - 2) // 2), base + clip(jr),
             base + np.where(ok, clip(jr), b)], dev, len(trail))
        for k, s in enumerate(steps.tolist()):
            t = comm.ppermute(Yf.index_select(0, i_send[k]), up_cls[s % 2])
            Yf.index_copy_(0, i_row[k], f(t, Yf.index_select(0, i_cur[k])))

    # ---------------- broadcast phase (period 2, down-traffic only) ------
    sig_np = np.zeros(p, np.int64)
    stack = [(topo.roots[0], 0)]
    while stack:
        nd, v = stack.pop()
        sig_np[nd] = v
        if topo.child0[nd] != NO_NODE:
            stack.append((int(topo.child0[nd]), v + 1))
        if topo.child1[nd] != NO_NODE:
            stack.append((int(topo.child1[nd]), v + 2))
    # edge (i -> c0) active at sigma(i)+2j; (i -> c1) at sigma(i)+2j+1.
    dn_cls = [[], []]
    for nd in range(p):
        for c, off in ((topo.child0[nd], 0), (topo.child1[nd], 1)):
            if c != NO_NODE:
                dn_cls[(int(sig_np[nd]) + off) % 2].append((nd, int(c)))
    dn_cls = tuple(tuple(c) for c in dn_cls)
    S2 = int(sig_np.max()) + 2 * b
    R2 = -(-S2 // 2)
    steps = np.asarray([2 * r + e for r in range(R2) for e in (0, 1)
                        if dn_cls[e]], np.int64)
    if len(steps):
        rel = steps[:, None] - sig_np[rk][None, :]
        even = rel % 2 == 0
        j_rcv = (rel + 1) // 2
        ok = has_par & ~even & (j_rcv >= 0) & (j_rcv < b)
        i_send, i_row = _upload(
            [base + clip(np.where(even, rel // 2, (rel - 1) // 2)),
             base + np.where(ok, clip(j_rcv), b)], dev, len(trail))
        for k, s in enumerate(steps.tolist()):
            t = comm.ppermute(Yf.index_select(0, i_send[k]), dn_cls[s % 2])
            Yf.index_copy_(0, i_row[k], t)
    return _unblockify(Y, b, m)
