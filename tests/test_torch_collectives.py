"""The port's collectives against the JAX reference, bitwise, on the CPU.

One subprocess with 8 virtual CPU devices runs every reference case through
``jax.shard_map(..., check_vma=False)`` — the reference's own fused engine,
unmodified — and returns its outputs as ``.npz``. The port runs the same
inputs (made by numpy from a seed) on ``LocalTransport(p, device="cpu")``
and must match bit for bit: the fused path folds ``op(op(t_up, pend), cur)``
and the general path ``t (.) Y`` twice, which differ in the last bit, so
these cases tell the two combine orders apart. The general path is also held
bitwise against the port's ``simulate_allreduce`` for a non-commutative
operator.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch

from repro.core import collectives as ref_collectives
from repro.core import cost_model as ref_cm
from repro_torch.core import collectives as port_collectives
from repro_torch.core import (CollectiveConfig, LocalTransport, all_reduce,
                              bucketed_all_reduce, dptree_allreduce,
                              hier_allreduce, redbcast_allreduce,
                              ring_allreduce, simulate_allreduce,
                              sptree_allreduce, structured_all_reduce)
from repro_torch.core.topology import build_single_tree
from repro_torch.interop import from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 103  # odd length: ragged last block, odd ring chunk padded to even


def _cases():
    out = []
    for p in (7, 8):
        out += [
            (f"dptree_add_b1_p{p}", p, "dptree", {"op": "add", "nb": 1}, "f32"),
            (f"dptree_add_b4_p{p}", p, "dptree", {"op": "add", "nb": 4}, "f32"),
            (f"dptree_add_bm_p{p}", p, "dptree", {"op": "add", "nb": M}, "f32"),
            (f"dptree_max_b4_p{p}", p, "dptree", {"op": "max", "nb": 4}, "f32_ninf"),
            (f"dptree_min_b4_p{p}", p, "dptree", {"op": "min", "nb": 4}, "f32_pinf"),
            (f"dptree_mul_b4_p{p}", p, "dptree", {"op": "mul", "nb": 4}, "f32_one"),
            (f"dptree_int32_b4_p{p}", p, "dptree", {"op": "add", "nb": 4}, "i32"),
            (f"sptree_add_b5_p{p}", p, "sptree", {"op": "add", "nb": 5}, "f32"),
            (f"redbcast_add_b4_p{p}", p, "redbcast", {"op": "add", "nb": 4}, "f32"),
            (f"ring_bidir_p{p}", p, "ring", {"op": "add", "bidir": True}, "f32"),
            (f"ring_unidir_p{p}", p, "ring", {"op": "add", "bidir": False}, "f32"),
            (f"dptree_2d_b5_p{p}", p, "dptree", {"op": "add", "nb": 5}, "f32_2d"),
        ]
    out += [
        ("dptree_max_b1_p8", 8, "dptree", {"op": "max", "nb": 1}, "f32_ninf"),
        ("dptree_max_bm_p8", 8, "dptree", {"op": "max", "nb": M}, "f32_ninf"),
        ("dptree_min_b1_p8", 8, "dptree", {"op": "min", "nb": 1}, "f32_pinf"),
        ("dptree_mul_bm_p8", 8, "dptree", {"op": "mul", "nb": M}, "f32_one"),
        ("ring_2d_p8", 8, "ring", {"op": "add", "bidir": True}, "f32_2d"),
        ("hier_4_p8", 8, "hier", {"op": "add", "nb": 3, "gs": [4]}, "f32"),
        ("hier_2x2_p8", 8, "hier", {"op": "add", "nb": 3, "gs": [2, 2]}, "f32"),
        ("hier_4_max_p8", 8, "hier", {"op": "max", "nb": 3, "gs": [4]}, "f32_ninf"),
        ("hier_4_bf16_p8", 8, "hier",
         {"op": "add", "nb": 3, "gs": [4], "compress": True}, "f32"),
        ("hier_2x2_bf16_p8", 8, "hier",
         {"op": "add", "nb": 3, "gs": [2, 2], "compress": True}, "f32"),
        ("auto_hydra_p8", 8, "auto", {"model": "PAPER_HYDRA", "gs": None}, "f32"),
        ("auto_v5e_hier_p8", 8, "auto",
         {"model": "TPU_V5E_INTERPOD", "intra": "TPU_V5E", "gs": 4}, "f32_big"),
        ("bucketed_p8", 8, "bucketed", {"model": "PAPER_HYDRA"}, "tree"),
    ]
    return out


CASES = _cases()


def _inputs(name, p, kind):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if kind == "tree":
        return {"a": rng.standard_normal((p, 3, 7)).astype(np.float32),
                "b": rng.standard_normal((p, 11)).astype(np.float32)}
    if kind == "i32":
        return rng.integers(-1000, 1001, size=(p, M)).astype(np.int32)
    if kind == "f32_2d":
        return rng.standard_normal((p, 37, 8)).astype(np.float32)
    if kind == "f32_big":
        return rng.standard_normal((p, 4099)).astype(np.float32)
    x = rng.standard_normal((p, M)).astype(np.float32)
    if kind == "f32_ninf":
        x[:, :8] = -np.inf                      # every rank masked
        x[rng.random((p, M)) < 0.1] = -np.inf   # scattered masks
    elif kind == "f32_pinf":
        x[:, :8] = np.inf
        x[rng.random((p, M)) < 0.1] = np.inf
    elif kind == "f32_one":
        x = (1.0 + 0.1 * x).astype(np.float32)
    return x


REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[2])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core import cost_model as cm
    from repro.core.collectives import (CollectiveConfig, all_reduce,
                                        bucketed_all_reduce)
    from repro.core.dptree import (dptree_allreduce, hier_allreduce,
                                   redbcast_allreduce, ring_allreduce,
                                   sptree_allreduce)
    OPS = {"add": jnp.add, "max": jnp.maximum, "min": jnp.minimum,
           "mul": jnp.multiply}

    def fn_for(kind, kw, p):
        op = OPS.get(kw.get("op", "add"))
        if kind == "dptree":
            return lambda x: dptree_allreduce(x, "data", p, num_blocks=kw["nb"], op=op)
        if kind == "sptree":
            return lambda x: sptree_allreduce(x, "data", p, num_blocks=kw["nb"], op=op)
        if kind == "redbcast":
            return lambda x: redbcast_allreduce(x, "data", p, num_blocks=kw["nb"], op=op)
        if kind == "ring":
            return lambda x: ring_allreduce(x, "data", p, op=op, bidirectional=kw["bidir"])
        if kind == "hier":
            return lambda x: hier_allreduce(
                x, "data", p, group_size=tuple(kw["gs"]), num_blocks=kw["nb"],
                op=op, compress_inter_group=kw.get("compress", False))
        model = getattr(cm, kw["model"])
        cfg = CollectiveConfig(method="auto" if kind == "auto" else "dptree",
                               comm_model=model,
                               intra_model=getattr(cm, kw.get("intra", kw["model"])),
                               group_size=kw.get("gs"))
        if kind == "auto":
            return lambda x: all_reduce(x, "data", p, cfg)
        return lambda t: bucketed_all_reduce(t, "data", p, cfg)

    d = sys.argv[1]
    cases = json.load(open(os.path.join(d, "cases.json")))
    inputs = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    for name, p, kind, kw in cases:
        mesh = Mesh(np.array(jax.devices()[:p]), ("data",))
        fn = fn_for(kind, kw, p)
        if kind == "bucketed":
            x = {k: inputs[name + "/" + k] for k in ("a", "b")}
            spec = {k: P("data") for k in x}
            body = lambda t: jax.tree.map(lambda l: l[None],
                                          fn(jax.tree.map(lambda l: l[0], t)))
        else:
            x = inputs[name]
            spec = P("data", *([None] * (x.ndim - 1)))
            body = lambda v: fn(v[0])[None]
        sm = jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec,
                           check_vma=False)
        res = jax.jit(sm)(x)
        if kind == "bucketed":
            for k in res:
                out[name + "/" + k] = np.asarray(res[k])
        else:
            out[name] = np.asarray(res)
    np.savez(os.path.join(d, "outputs.npz"), **out)
""")


@pytest.fixture(scope="module")
def ref_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_collectives_ref")
    inputs = {}
    for name, p, kind, kw, inp in CASES:
        x = _inputs(name, p, inp)
        if isinstance(x, dict):
            inputs.update({f"{name}/{k}": v for k, v in x.items()})
        else:
            inputs[name] = x
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(
        [[name, p, kind, kw] for name, p, kind, kw, _ in CASES]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_AUTOTUNE="0")
    r = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(d), os.path.join(ROOT, "src")],
        capture_output=True, text=True, timeout=400, env=env)
    assert r.returncode == 0, f"\nSTDOUT:{r.stdout[-2000:]}\nERR:{r.stderr[-3000:]}"
    return inputs, dict(np.load(d / "outputs.npz"))


def _model(name):
    return from_reference(dataclasses.asdict(getattr(ref_cm, name)))


def _port(name, p, kind, kw, x):
    comm = LocalTransport(p, device="cpu")
    op = kw.get("op", "add")
    if kind == "dptree":
        return dptree_allreduce(x, comm, num_blocks=kw["nb"], op=op)
    if kind == "sptree":
        return sptree_allreduce(x, comm, num_blocks=kw["nb"], op=op)
    if kind == "redbcast":
        return redbcast_allreduce(x, comm, num_blocks=kw["nb"], op=op)
    if kind == "ring":
        return ring_allreduce(x, comm, op=op, bidirectional=kw["bidir"])
    if kind == "hier":
        return hier_allreduce(x, comm, group_size=tuple(kw["gs"]),
                              num_blocks=kw["nb"], op=op,
                              compress_inter_group=kw.get("compress", False))
    cfg = CollectiveConfig(method="auto" if kind == "auto" else "dptree",
                           comm_model=_model(kw["model"]),
                           intra_model=_model(kw.get("intra", kw["model"])),
                           group_size=kw.get("gs"))
    if kind == "auto":
        return all_reduce(x, comm, cfg)
    return bucketed_all_reduce(x, comm, cfg)


def assert_bitwise(got: np.ndarray, want: np.ndarray, msg=""):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (msg, got.shape, want.shape, got.dtype, want.dtype)
    u = np.uint32 if got.dtype.itemsize == 4 else np.uint16
    bad = np.count_nonzero(got.view(u) != want.view(u))
    assert bad == 0, f"{msg}: {bad} of {got.size} elements differ in bits"


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_matches_reference_bitwise(case, ref_outputs):
    name, p, kind, kw, _ = case
    inputs, outputs = ref_outputs
    if kind == "bucketed":
        tree = {k: torch.from_numpy(inputs[f"{name}/{k}"]) for k in ("a", "b")}
        got = _port(name, p, kind, kw, tree)
        for k in tree:
            assert_bitwise(got[k].numpy(), outputs[f"{name}/{k}"], f"{name}/{k}")
        return
    got = _port(name, p, kind, kw, torch.from_numpy(inputs[name]))
    assert_bitwise(got.contiguous().numpy(), outputs[name], name)


def test_fused_and_general_orders_differ():
    """The bitwise cases above can tell the two combine orders apart: on
    these inputs the general path's f32 sum differs from the fused one."""
    x = torch.from_numpy(_inputs("dptree_add_b4_p8", 8, "f32"))
    comm = LocalTransport(8, device="cpu")
    fused = dptree_allreduce(x, comm, num_blocks=4, op="add")
    general = dptree_allreduce(x, comm, num_blocks=4,
                               op=lambda a, b: a + b)
    assert not torch.equal(fused, general)
    torch.testing.assert_close(fused, general, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["auto", "dptree", "hier"])
@pytest.mark.parametrize("model", ["PAPER_HYDRA", "TPU_V5E",
                                   "TPU_V5E_INTERPOD"])
def test_pick_and_block_count_match_reference(method, model, monkeypatch):
    """The algorithm and block count ``all_reduce`` picks are the
    reference's, with the port's model built from the reference preset."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    rm = getattr(ref_cm, model)
    pm = _model(model)
    for p in (2, 7, 8, 16, 288):
        for nbytes in (4, 4096, 1 << 20, 1 << 25):
            for gs in (None, 4, (2, 2)):
                rc = ref_collectives.CollectiveConfig(
                    method=method, comm_model=rm, intra_model=rm,
                    group_size=gs)
                pc = CollectiveConfig(method=method, comm_model=pm,
                                      intra_model=pm, group_size=gs)
                want = ref_collectives._pick(method, p, nbytes, rc, "float32")
                got = port_collectives._pick(method, p, nbytes, pc, "float32")
                assert got == want, (p, nbytes, gs)
                algo = want[0]
                comp = "bf16" if want[3] else None
                assert port_collectives._nblocks(
                    None, p, nbytes, pm, algo, want[2], comp) == \
                    ref_collectives._nblocks(None, p, nbytes, rm, algo,
                                             want[2], comp)


def _mm(lib):
    """2x2 matrix product per slot, written out so numpy and torch round the
    same way (no fused multiply-add, no library matmul)."""
    def mm(a, b):
        e = lambda i, j: (a[..., i, 0] * b[..., 0, j]
                          + a[..., i, 1] * b[..., 1, j])
        rows = [lib.stack([e(i, 0), e(i, 1)], -1) for i in range(2)]
        return lib.stack(rows, -2)
    return mm


@pytest.mark.parametrize("p", [7, 8])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("single", [False, True])
def test_general_path_matches_simulator_non_commutative(p, nb, single):
    rng = np.random.default_rng(p * 10 + nb)
    X = (rng.standard_normal((p, 12, 2, 2)) * 0.3
         + np.eye(2)).astype(np.float32)
    topo = build_single_tree(p) if single else None
    sim = simulate_allreduce([X[i] for i in range(p)], nb, op=_mm(np),
                             topo=topo)
    comm = LocalTransport(p, device="cpu")
    fn = sptree_allreduce if single else dptree_allreduce
    got = fn(torch.from_numpy(X), comm, num_blocks=nb, op=_mm(torch),
             op_rev=_mm(torch)).numpy()
    for r in range(p):
        assert_bitwise(got[r], sim.outputs[r], f"rank {r}")


def test_structured_all_reduce_matches_simulator():
    p = 8
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((p, 5, 2, 2)) * 0.3 + np.eye(2)).astype(np.float32)
    sim = simulate_allreduce([X[i].reshape(-1) for i in range(p)], 1,
                             op=lambda a, b: _mm(np)(a.reshape(-1, 2, 2),
                                                     b.reshape(-1, 2, 2))
                             .reshape(-1))
    comm = LocalTransport(p, device="cpu")
    got = structured_all_reduce(
        {"m": torch.from_numpy(X)}, comm,
        lambda a, b: {"m": _mm(torch)(a["m"], b["m"])})["m"].numpy()
    for r in range(p):
        assert_bitwise(got[r].reshape(-1), sim.outputs[r], f"rank {r}")


def test_psum_and_mean_within_tolerance():
    p = 8
    rng = np.random.default_rng(11)
    X = rng.standard_normal((p, 5, 9)).astype(np.float32)
    comm = LocalTransport(p, device="cpu")
    x = torch.from_numpy(X)
    for op, want in (("add", X.sum(0)), ("max", X.max(0)), ("min", X.min(0))):
        got = all_reduce(x, comm, CollectiveConfig(method="psum"), op=op)
        for r in range(p):
            np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    mean = port_collectives.all_reduce_mean(x, comm)
    np.testing.assert_allclose(mean[0].numpy(), X.mean(0), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        all_reduce(x, comm, CollectiveConfig(method="psum"), op="mul")
    with pytest.raises(ValueError):
        all_reduce(x, comm, CollectiveConfig(method="hier"),
                   op=lambda a, b: a + b)


def test_bucket_sizes_follow_bucketing():
    p = 4
    tree = {"w": torch.zeros(p, 3, 5), "b": torch.zeros(p, 7),
            "h": torch.zeros(p, 6, dtype=torch.bfloat16)}
    assert port_collectives.bucket_sizes(tree) == [
        (6, torch.bfloat16), (22, torch.float32)]
    assert port_collectives.bucket_sizes(tree, bucket_bytes=8) == [
        (6, torch.bfloat16), (7, torch.float32), (15, torch.float32)]
