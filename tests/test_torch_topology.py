"""The port's host-side modules against the JAX package's, on the CPU.

``repro_torch`` keeps its own copies of the numpy-only modules (topology,
simulator, cost model, autotuner) so that it never imports JAX. These tests
hold every field, count and formula equal to the reference's, with the
port's cost models built from the reference presets' fields, and check that
``interop.from_reference`` carries the reference's state across.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import autotune as ref_autotune
from repro.core import cost_model as ref_cm
from repro.core import simulator as ref_sim
from repro.core import topology as ref_topo
from repro_torch.core import autotune, cost_model, simulator, topology
from repro_torch.interop import from_reference

MODELS = ["PAPER_HYDRA", "TPU_V5E", "TPU_V5E_INTERPOD"]


def _port_model(name):
    return from_reference(dataclasses.asdict(getattr(ref_cm, name)))


def _assert_tree_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name


def _assert_hier_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("group_tree", "inter_topo"):
            _assert_tree_equal(g, w)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("p", range(1, 65))
def test_trees_equal_reference(p):
    for build in ("build_dual_tree", "build_single_tree"):
        got, want = getattr(topology, build)(p), getattr(ref_topo, build)(p)
        _assert_tree_equal(got, want)
        assert got.num_steps(5) == want.num_steps(5)
        assert got.active_classes() == want.active_classes()
    topology.validate_topology(topology.build_dual_tree(p))


LEVEL_SPECS = ([(g * s, s) for g in range(1, 41) for s in (1, 2, 3, 4, 8)]
               + [(g * s0 * s1, (s0, s1)) for g in range(1, 13)
                  for s0 in (2, 3, 4) for s1 in (2, 3)]
               + [(p, None) for p in (1, 2, 5, 6, 8, 12, 288)]
               + [(288, 8), (288, (4, 2)), (16, (2, 2, 2))])


@pytest.mark.parametrize("p,spec", LEVEL_SPECS)
def test_hierarchies_equal_reference(p, spec):
    _assert_hier_equal(topology.build_hierarchy(p, spec),
                       ref_topo.build_hierarchy(p, spec))
    assert topology.resolve_levels(p, spec) == ref_topo.resolve_levels(p, spec)
    assert (topology.resolve_group_size(p, spec)
            == ref_topo.resolve_group_size(p, spec))


def test_level_rules_equal_reference():
    for spec in (None, 4, (1, 2, 1, 4), (2, 3), "junk", 0, (2, 0)):
        for p in (5, 8, 16, 24):
            assert (topology.resolve_levels(p, spec)
                    == ref_topo.resolve_levels(p, spec)), (p, spec)
    for spec in (None, 4, (1, 2, 1, 4)):
        assert topology.as_levels(spec) == ref_topo.as_levels(spec)
    for bad in (3, (2, 3)):
        with pytest.raises(ValueError):
            topology.build_hierarchy(8, bad)


@pytest.mark.parametrize("p", range(2, 41))
def test_active_steps_equal_reference(p):
    for b in (1, 2, 5):
        assert (simulator.count_active_steps(p, b)
                == ref_sim.count_active_steps(p, b))


@pytest.mark.parametrize("model", MODELS)
def test_cost_model_equals_reference(model):
    rm, pm = getattr(ref_cm, model), _port_model(model)
    assert pm == cost_model.CommModel(rm.alpha, rm.beta, rm.gamma, rm.name)
    for p in (1, 2, 3, 7, 8, 16, 36, 288):
        for nbytes in (4.0, 4096.0, float(1 << 20), 8388608 * 4.0):
            for b in (1, 3, 64):
                assert (cost_model.dptree_time(p, nbytes, b, pm)
                        == ref_cm.dptree_time(p, nbytes, b, rm))
            for algo in ("dptree", "sptree", "redbcast"):
                assert (cost_model.optimal_blocks(p, nbytes, pm, algo)
                        == ref_cm.optimal_blocks(p, nbytes, rm, algo))
            assert (cost_model.ring_time(p, nbytes, pm)
                    == ref_cm.ring_time(p, nbytes, rm))
            for gs in (None, 2, 4, 8, (2, 2), (4, 2)):
                for comp in (None, "bf16"):
                    assert (cost_model.optimal_blocks(
                        p, nbytes, pm, "hier", group_size=gs,
                        compression=comp)
                        == ref_cm.optimal_blocks(
                            p, nbytes, rm, "hier", group_size=gs,
                            compression=comp))
                    assert (cost_model.hier_time(
                        p, nbytes, 4, pm, group_size=gs or 4, intra_model=pm,
                        compression=comp)
                        == ref_cm.hier_time(
                            p, nbytes, 4, rm, group_size=gs or 4,
                            intra_model=rm, compression=comp))
                assert (cost_model.best_algorithm(p, nbytes, pm,
                                                  group_size=gs,
                                                  intra_model=pm)
                        == ref_cm.best_algorithm(p, nbytes, rm,
                                                 group_size=gs,
                                                 intra_model=rm))
    np.testing.assert_array_equal(
        cost_model.predicted_table(288, [4e3, 4e6, 3.3e7], pm),
        ref_cm.predicted_table(288, [4e3, 4e6, 3.3e7], rm))


def test_port_states_no_tpu_rates():
    assert not hasattr(cost_model, "TPU_V5E")
    assert not hasattr(cost_model, "TPU_V5E_INTERPOD")
    assert cost_model.PAPER_HYDRA == _port_model("PAPER_HYDRA")


@pytest.mark.parametrize("spec", [(8, 4), (8, (2, 2)), (36, None), (288, 8)])
def test_from_reference_carries_topologies(spec):
    p, gs = spec
    _assert_tree_equal(
        from_reference(dataclasses.asdict(ref_topo.build_dual_tree(p))),
        topology.build_dual_tree(p))
    if topology.resolve_levels(p, gs) is not None:
        _assert_hier_equal(
            from_reference(dataclasses.asdict(ref_topo.build_hierarchy(p, gs))),
            topology.build_hierarchy(p, gs))
    with pytest.raises(ValueError):
        from_reference({"weights": np.zeros(3)})


def test_autotune_cache_round_trips_in_reference_schema(tmp_path):
    """The port reads what the reference writes and the reference reads what
    the port writes: same schema, same keys (p, nbytes, dtype, topology,
    axis), same legacy axis-less fallback."""
    path = str(tmp_path / "autotune.json")
    rc = ref_autotune.AutotuneCache(path)
    rc.put(8, 4096, "float32", "paper_hydra",
           ref_autotune.TuneResult("hier", 6, 1.5e-5, (2, 2), True, "data"))
    rc.put(8, 4096, "float32", "paper_hydra",
           ref_autotune.TuneResult("ring", 1, 2e-5))
    rc.save()
    pc = autotune.AutotuneCache(path)
    got = pc.get(8, 4096, "float32", "paper_hydra", axis="data")
    assert dataclasses.astuple(got) == ("hier", 6, 1.5e-5, (2, 2), True,
                                        "data")
    assert pc.get(8, 4096, "float32", "paper_hydra", axis="tp").algorithm \
        == "ring"                                  # legacy axis-less match
    pc.put(16, 64, "bfloat16", "paper_hydra",
           autotune.TuneResult("dptree", 3, 1e-6, axis="tp"))
    pc.save()
    back = ref_autotune.AutotuneCache(path).load()
    assert dataclasses.astuple(back.get(16, 64, "bfloat16", "paper_hydra",
                                        axis="tp")) == \
        ("dptree", 3, 1e-6, None, False, "tp")
    assert len(back) == 3


def test_autotune_cache_lives_apart_from_reference(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.default_cache_path() != ref_autotune.default_cache_path()
    assert autotune.default_cache_path().endswith(
        "repro_torch/autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert "jax.json" not in autotune.default_cache_path()
