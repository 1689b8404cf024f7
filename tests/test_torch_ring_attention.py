"""The slot attention wrapper's bookkeeping on the CPU: each query's
positions, the work it counts for its bound, the calls that hold a query's
bits, and the route it picks.

``ring_attention.query_range``, ``valid`` and ``work`` are held against a
brute-force count over the plain version's mask
(``kernels/ref.py::ring_attention_ref``), transcribed here position by
position and itself held against the support of the plain
version's weights; ``ring_attention.route`` and the arguments the wrapper
hands the kernel are held to depend on the dtype, the head dim and the
ring's length alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, ring_attention

# (plan [[pos], [n]], T, S, window, chunk): fresh and wrapped rings, an
# inactive row (n = 0), a call longer than its ring, counts past T (a
# later newest position), windows and chunks over wrapped rings
CASES = [
    ([[0, 5], [8, 8]], 8, 64, None, None),
    ([[70, 100, 30], [6, 6, 0]], 6, 64, None, None),
    ([[0, 3], [40, 2]], 40, 13, None, None),
    ([[90, 20, 7], [20, 3, 0]], 9, 33, 8, None),
    ([[90, 20, 7], [20, 3, 0]], 9, 33, None, 16),
    ([[150, 64], [40, 1]], 12, 64, 20, 32),
    ([[5000 - 37, 8000], [512, 30]], 17, 4096, 1000, None),
]


def brute_mask(plan, T: int, S: int, window, chunk) -> np.ndarray:
    """(B, T, S) bools: the plain version's mask, slot by slot."""
    pos, n = plan
    out = np.zeros((len(pos), T, S), bool)
    for b in range(len(pos)):
        last = pos[b] + n[b] - 1
        for s in range(S):
            ki = last - (last - s) % S
            for t in range(T):
                qp = pos[b] + t
                ok = 0 <= ki <= qp
                if window is not None:
                    ok = ok and ki > qp - window
                if chunk is not None:
                    ok = ok and ki // chunk == qp // chunk
                out[b, t, s] = ok
    return out


@pytest.mark.parametrize("case", CASES[:-1])
def test_brute_mask_is_the_plain_versions(case):
    """The transcription against ``ring_attention_ref`` itself: with equal
    scores and a one-hot V per slot, a query's output is 1 / count on its
    valid slots and 0 elsewhere (uniform over every slot for a query with
    none)."""
    plan, T, S, window, chunk = case
    B = len(plan[0])
    q = torch.zeros((B, T, 2, S))
    k = torch.zeros((B, S, 1, S))
    v = torch.eye(S).expand(B, S, S)[:, :, None].contiguous()
    w = ref.ring_attention_ref(q, k, v, torch.tensor(plan), window, chunk)
    want = brute_mask(plan, T, S, window, chunk)
    for h in range(2):
        got = w[:, :, h].numpy()
        some = want.any(-1)
        assert np.array_equal(got[some] > 0, want[some])
        assert np.allclose(got[~some], 1.0 / S)


@pytest.mark.parametrize("case", CASES)
def test_query_range_is_the_plain_masks(case):
    """Each query's [lo, hi] holds exactly the positions of its valid slots,
    and ``valid`` the queries with one."""
    plan, T, S, window, chunk = case
    mask = brute_mask(plan, T, S, window, chunk)
    lo, hi = (x.tolist() for x in ring_attention.query_range(
        plan, T, S, window, chunk))
    pos, n = plan
    for b in range(len(pos)):
        last = pos[b] + n[b] - 1
        held = {last - (last - s) % S for s in range(S)}
        for t in range(T):
            got = {j for j in held if lo[b][t] <= j <= hi[b][t]}
            want = {last - (last - s) % S for s in np.nonzero(mask[b, t])[0]}
            assert got == want
    assert np.array_equal(ring_attention.valid(plan, T, S, window,
                                               chunk).numpy(),
                          mask.any(-1))


@pytest.mark.parametrize("window", [None, 20])
def test_same_bits_pairs_give_each_call_the_same_positions(window):
    """The calls of ``same_bits_pairs`` over a wrapped ring, run by the
    plain version here: each pair agrees to f32 rounding (a wrong plan in
    any call would read other positions), fifteen pairs of (B, H, D)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 48, 4, 8), (2, 64, 2, 8), (2, 64, 2, 8)))
    pairs = ring_attention.same_bits_pairs(q, k, v, torch.tensor([100, 9]),
                                           window)
    assert len(pairs) == 15
    for what, one, got in pairs:
        assert one.shape == (2, 4, 8), what
        torch.testing.assert_close(one, got, rtol=1e-5, atol=1e-6, msg=what)


@pytest.mark.parametrize("case", CASES)
def test_work_counts_the_plain_masks_pairs_and_rows(case):
    plan, T, S, window, chunk = case
    B, H, KV, D = len(plan[0]), 4, 2, 12
    mask = brute_mask(plan, T, S, window, chunk)
    rows = int(mask.any(1).sum())
    pairs = int(mask.sum())
    nbytes, nops = ring_attention.work(torch.tensor(plan), T, S, H, KV, D,
                                       window, chunk)
    assert nops == 4 * D * H * pairs
    assert nbytes == (2 * B * T * H * D + 2 * rows * KV * D) * 2 + 2 * B * 8
    assert ring_attention.work(plan, T, S, H, KV, D, window, chunk,
                               itemsize=4)[0] == \
        (2 * B * T * H * D + 2 * rows * KV * D) * 4 + 2 * B * 8


def test_route_depends_on_dtype_head_dim_and_ring_alone():
    """The route code the wrapper hands the kernel, over calls of other T,
    B and plans: the same for one dtype, head dim and ring."""
    want = {(torch.bfloat16, 64, 4096): "wgmma_tma",
            (torch.bfloat16, 128, 8192): "wgmma_tma",
            (torch.bfloat16, 64, 100): "wgmma_cp_async",
            (torch.bfloat16, 12, 64): "wgmma_cp_async",
            (torch.bfloat16, 40, 13): "wgmma_cp_async",
            (torch.bfloat16, 33, 64): "cuda_cores",
            (torch.bfloat16, 192, 64): "cuda_cores",
            (torch.float32, 64, 4096): "cuda_cores",
            (torch.float32, 12, 13): "cuda_cores"}
    calls = [(1, 1, [[0], [1]]), (3, 5, [[70, 0, 30], [5, 5, 0]]),
             (2, 40, [[4000, 9], [40, 100]]), (1, 512, [[1024], [512]])]
    for (dt, D, S), name in want.items():
        assert ring_attention.route(dt, D, S) == name
        codes = set()
        for B, T, plan in calls:
            q = torch.zeros((B, T, 4, D), dtype=dt)
            k = torch.zeros((B, S, 2, D), dtype=dt)
            args = ring_attention._call_args(q, k, k, q, torch.tensor(plan),
                                             None, None)
            codes.add(args[0])
        assert codes == {ring_attention.ROUTES.index(name)}
