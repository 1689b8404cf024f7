"""The port's replica fleet under chaos (``serving/fleet.py``,
``runtime/chaos.py`` and the fleet half of ``runtime/fault_tolerance.py``)
against the JAX reference and within the port, on the CPU.

Against the reference: ``FaultPlan.seeded`` and every ``FaultInjector``
query; the ``HeartbeatMonitor``'s transitions under a fake clock;
``plan_remesh`` and the ``StragglerTuner`` (both packages given
``PAPER_HYDRA``, the port's default, explicitly); the fleet control plane
(placement, polls, quarantine); and ``FleetRunner``'s streams, counters,
events, trace events and recovery ticks for a kill, a flap with a
rejoin, a straggler and poison, on the configs of
``tests/_torch_engine_parity.py``: under f32 compute all of it equal;
under bf16 a greedy stream may part from the reference's by the margin
rule, and every stream equals the port's own undisturbed run's. Within
the port: poison commits nothing of its tick; the survivors' stats
reduction on ``LocalTransport`` is exact at p = 8, then 5, then 7; the
counts ride the stats vector; a corrupted autotune entry degrades to the
cost model; and ``serve.py --chaos-seed`` runs on the CPU.
"""

import json

import numpy as np
import pytest

import _torch_engine_parity as par
from repro import serving as ref_serving
from repro.configs import base as ref_base
from repro.core import cost_model as ref_cm
from repro.launch.mesh import make_mesh
from repro.obs import Tracer as RefTracer
from repro.runtime import chaos as ref_chaos
from repro.runtime import fault_tolerance as ref_ft
from repro_torch import serving
from repro_torch.core import LocalTransport
from repro_torch.core import cost_model as cm
from repro_torch.launch import serve
from repro_torch.obs import Tracer
from repro_torch.runtime import chaos, fault_tolerance as ft


# ==========================================================================
# fault plans, the injector (host only)
# ==========================================================================

@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_plans_and_injector_queries_are_the_references(seed):
    for n, horizon, k in ((2, 12, 3), (3, 30, 6), (5, 50, 8)):
        got = chaos.FaultPlan.seeded(seed, n_replicas=n, horizon=horizon,
                                     n_faults=k)
        want = ref_chaos.FaultPlan.seeded(seed, n_replicas=n,
                                          horizon=horizon, n_faults=k)
        assert [tuple(vars(f).values()) for f in got] == \
            [tuple(vars(f).values()) for f in want]
        a, b = chaos.FaultInjector(got), ref_chaos.FaultInjector(want)
        for t in range(horizon + 5):
            assert [tuple(vars(f).values()) for f in a.at(t)] == \
                [tuple(vars(f).values()) for f in b.at(t)]
            for r in range(n):
                assert (a.silenced(t, r), a.straggle_factor(t, r),
                        a.skips_tick(t, r), a.poisons(t, r)) == \
                    (b.silenced(t, r), b.straggle_factor(t, r),
                     b.skips_tick(t, r), b.poisons(t, r)), (t, r)
    bad = [dict(tick=0, kind="meteor"), dict(tick=-1),
           dict(tick=0, kind="flap", duration=0),
           dict(tick=0, kind="straggle", duration=4, factor=0.5)]
    for kw in bad:
        for mod in (chaos, ref_chaos):
            with pytest.raises(ValueError):
                mod.Fault(**kw)
    with pytest.raises(TypeError):
        chaos.FaultPlan(("not a fault",))


def _monitor_script(mod):
    """A fixed sequence of beats, drops and readmits under a fake clock;
    returns every observation the monitor makes along it."""
    t = [0.0]
    mon = mod.HeartbeatMonitor(4, 2.0, clock=lambda: t[0], misses=2,
                               rejoin_backoff_s=3.0, rejoin_cap_s=20.0)
    seen = []
    beats = {1: (0, 1, 2, 3), 2: (0, 2), 3: (0, 2, 3), 5: (0, 3),
             6: (0, 1, 3), 7: (0, 1, 3), 9: (0, 1, 3), 10: (0, 1, 2, 3),
             11: (0, 1, 2), 12: (0, 1, 2), 14: (0, 1, 2), 15: (0, 1, 2),
             16: (0, 1, 2), 17: (0, 2), 22: (0, 1, 2), 23: (0, 1, 2),
             24: (0, 1, 2), 25: (0, 1, 2), 30: (0, 1, 2)}
    for tick in range(32):
        t[0] = float(tick)
        for h in beats.get(tick, ()):
            mon.beat(h)
        dead = mon.dead_hosts()
        for h in dead:
            mon.drop(h)
        back = mon.rejoinable()
        for h in back:
            mon.readmit(h)
        seen.append((tick, mon.suspect_hosts(), dead, back, mon.n_hosts,
                     [mon.rejoin_backoff(h) for h in range(4)]))
    try:
        mon.readmit(0)
    except ValueError as e:
        seen.append(str(e))
    t[0] = 100.0
    try:
        mon.check()
    except mod.HostFailure as e:
        seen.append((e.host, e.hosts, str(e)))
    return seen


def test_heartbeat_monitor_transitions_are_the_references():
    got, want = _monitor_script(ft), _monitor_script(ref_ft)
    assert got == want
    assert any(obs[3] for obs in got[:-2])         # a rejoin happened
    assert any(obs[1] for obs in got[:-2])         # and a SUSPECT window
    with pytest.raises(ValueError):
        ft.HeartbeatMonitor(2, 1.0, misses=0)


def test_plan_remesh_and_straggler_tuner_are_the_references():
    for members in ((0,), (0, 2), (0, 1, 2), (0, 2, 3, 5, 6),
                    tuple(range(7)), tuple(range(8)), tuple(range(288))):
        for nbytes in (64.0, 4096.0, 1e8):
            got = ft.plan_remesh(members, nbytes, cm.PAPER_HYDRA)
            want = ref_ft.plan_remesh(members, nbytes, ref_cm.PAPER_HYDRA)
            assert tuple(vars(got).values()) == tuple(vars(want).values())
    assert ft.plan_remesh((0, 1, 2), 64.0) == \
        ft.plan_remesh((0, 1, 2), 64.0, cm.PAPER_HYDRA)
    for p, nbytes in ((16, 1e8), (8, 1e6)):
        a = ft.StragglerTuner(p, nbytes, cm.PAPER_HYDRA, window=4)
        b = ref_ft.StragglerTuner(p, nbytes, ref_cm.PAPER_HYDRA, window=4)
        pred = cm.dptree_time(p, nbytes, a.num_blocks, cm.PAPER_HYDRA)
        for ratio in (5.0,) * 4 + (2.0,) * 4 + (0.5,) * 8 + (3.0,) * 4:
            assert a.observe(ratio * pred) == b.observe(ratio * pred)
        assert a.num_blocks == b.num_blocks


def test_fleet_control_plane_is_the_references():
    """Placement, a double death in one poll, a rejoin that grows the plan
    back, a quarantine that never rejoins, and stale completions."""
    out = []
    for mod in (serving, ref_serving):
        t = [0.0]
        fleet = mod.ReplicaFleet(4, timeout_s=1.0, clock=lambda: t[0],
                                 rejoin_backoff_s=2.0,
                                 **({"comm_model": ref_cm.PAPER_HYDRA}
                                    if mod is ref_serving else {}))
        reqs = [mod.Request(i, (1, 2), 4, arrival=i) for i in range(10)]
        got = [fleet.assign(r) for r in reqs]
        scheds = {r: mod.SlotScheduler(2) for r in range(4)}
        t[0] = 1.5
        fleet.beat(0)
        fleet.beat(1)
        t[0] = 2.0
        plans = [fleet.poll(scheds)]                 # 2 and 3 die together
        got.append([[q.rid for q in s._queue] for s in scheds.values()])
        got.append((fleet.complete(0, reqs[0]), fleet.complete(0, reqs[0]),
                    fleet.complete(3, reqs[3])))
        fleet.transfer(reqs[4:6], 0, 1)
        for tick in (3.0, 4.0, 5.0, 6.0):
            t[0] = tick
            for h in range(4):
                fleet.beat(h)
            plans.append(fleet.poll(scheds))
        plans.append(fleet.quarantine(1, scheds))
        for tick in (7.0, 8.0, 9.0, 10.0):
            t[0] = tick
            for h in range(4):
                fleet.beat(h)
            plans.append(fleet.poll(scheds))
        got.append([None if pl is None else
                    (pl.dead, pl.survivors, pl.requeued, pl.rejoined,
                     pl.quarantined, tuple(vars(pl.elastic).values()))
                    for pl in plans])
        got.append((fleet.alive, fleet.quarantined,
                    {r: [q.rid for q in v]
                     for r, v in fleet._placement.items()}))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][-1][1] == (1,)
    with pytest.raises(ValueError):
        serving.ReplicaFleet(1)


# ==========================================================================
# FleetRunner against the reference
# ==========================================================================

_PLANS = {
    "kill": lambda m: (m.Fault(5, "kill", replica=1),),
    "flap_rejoin": lambda m: (m.Fault(4, "flap", replica=1, duration=8),
                              m.Fault(3, "straggle", replica=0, duration=6,
                                      factor=2.0)),
    "straggle": lambda m: (m.Fault(2, "straggle", replica=0, duration=7,
                                   factor=4.0),),
    "poison": lambda m: (m.Fault(5, "poison", replica=1),),
}


def _chaos_reqs(mod, vocab, sampled=True):
    rng = np.random.default_rng(3)
    out = [mod.Request(i, tuple(int(t) for t in rng.integers(
        1, vocab, int(rng.integers(2, 12)))),
        max_new_tokens=int(rng.integers(8, 16)), arrival=i)
        for i in range(8)]
    for i, r in enumerate(out):
        if sampled and i % 2:
            r.sampling = mod.SamplingParams(seed=11 + i, temperature=0.9,
                                            top_k=20)
    return out


_ENGINES: dict = {}


def _engines(name):
    """(reference engine, port engine) on one config: 2 slots of 64,
    prefill chunks of 8 (prompts of up to 11 tokens take two)."""
    if name not in _ENGINES:
        jcfg, cfg, jp, p = par.params(name)
        kw = dict(n_slots=2, max_len=64, prefill_chunk=8,
                  min_prefill_bucket=8)
        _ENGINES[name] = (
            ref_serving.ServingEngine(jcfg, ref_base.ParallelConfig(),
                                      make_mesh((1, 1), ("data", "model")),
                                      jp, **kw),
            serving.ServingEngine(cfg, None, p, device="cpu", **kw), cfg)
    return _ENGINES[name]


_EVENT_COUNTERS = ("failovers", "quarantines", "rejoins", "alive",
                   "quarantined", "events", "recovery_ticks",
                   "resumed_tokens", "ticks", "prefill_chunks", "requests")


def _events(tr):
    return [(e.name, e.tick, e.rid, e.replica, e.attrs) for e in tr.events]


@pytest.mark.parametrize("name", ["minicpm_int8_f32", "minicpm_int8"])
def test_fleet_runner_matches_the_jax_fleet(name):
    reng, peng, cfg = _engines(name)
    exact = name.endswith("_f32")
    want = peng.run(_chaos_reqs(serving, cfg.vocab_size))["tokens"]
    margins = {}        # (rid, position): the reference's top-2 margin
    for kind, faults in _PLANS.items():
        if kind == "straggle" and not exact:
            continue              # no failover: f32 holds it, bit for bit
        rtr, ptr = RefTracer(), Tracer()
        reng.tracer, peng.tracer = rtr, ptr
        try:
            ref = ref_serving.FleetRunner(
                reng, 2, plan=ref_chaos.FaultPlan(faults(ref_chaos)),
                timeout_s=2.0, rejoin_backoff_s=1.0,
                comm_model=ref_cm.PAPER_HYDRA).run(
                _chaos_reqs(ref_serving, cfg.vocab_size))
            reqs = _chaos_reqs(serving, cfg.vocab_size)
            got = serving.FleetRunner(
                peng, 2, plan=chaos.FaultPlan(faults(chaos)), timeout_s=2.0,
                rejoin_backoff_s=1.0).run(reqs)
        finally:
            reng.tracer = peng.tracer = None
        assert got["tokens"] == want, (name, kind)
        for k in _EVENT_COUNTERS:
            assert got[k] == ref[k], (name, kind, k)
        assert (kind == "straggle") == (got["failovers"] == 0)
        if kind == "flap_rejoin":
            assert got["rejoins"] == 1 and got["alive"] == [0, 1]
            assert got["recovery_ticks"] and got["resumed_tokens"] > 0
        if kind == "poison":
            assert got["quarantines"] == 1 and got["quarantined"] == [1]
        if exact:
            assert got["tokens"] == ref["tokens"], (name, kind)
            assert got["total_tokens"] == ref["total_tokens"]
            assert _events(ptr) == _events(rtr), (name, kind)
            continue
        # bf16: the greedy streams by the margin rule; trace events agree
        # but for the token values they carry
        jcfg, _, jp, _ = par.params(name)
        prompts = {r.rid: r.prompt for r in reqs}
        for r in reqs:
            if r.sampling is not None or \
                    got["tokens"][r.rid] == ref["tokens"][r.rid]:
                continue
            mine, theirs = got["tokens"][r.rid], ref["tokens"][r.rid]
            i = next(j for j, (a, b) in enumerate(zip(mine, theirs))
                     if a != b)
            if (r.rid, i) not in margins:
                logits = par._ref_logits(jcfg, jp,
                                         prompts[r.rid] + tuple(theirs[:i]))
                top2 = np.sort(logits)[-2:]
                margins[r.rid, i] = (top2[1] - top2[0]) / \
                    np.abs(logits).max()
            assert margins[r.rid, i] <= 2 * par.BF16_TOL, (kind, r.rid, i)
        assert [e[:4] for e in _events(ptr)] == \
            [e[:4] for e in _events(rtr)], (name, kind)


def test_fleet_replays_and_counts_ride_the_stats_vector():
    _, eng, cfg = _engines("minicpm_int8_f32")
    plan = chaos.FaultPlan(_PLANS["flap_rejoin"](chaos))
    reps = [serving.FleetRunner(eng, 2, plan=plan, timeout_s=2.0,
                                rejoin_backoff_s=1.0).run(
        _chaos_reqs(serving, cfg.vocab_size)) for _ in range(2)]
    assert reps[0]["tokens"] == reps[1]["tokens"]
    assert reps[0]["events"] == reps[1]["events"]
    rep = reps[0]
    assert serving.STATS_FIELDS[8:11] == ("failovers", "resumed_tokens",
                                          "quarantines")
    assert rep["failovers"] == sum(s.failovers for s in rep["steps"]) > 0
    assert rep["resumed_tokens"] == \
        sum(s.resumed_tokens for s in rep["steps"])
    assert rep["events"][0]["dead"] == [1] and rep["mode"] == "fleet"


# ==========================================================================
# within the port: poison, the survivors' reduction, the CLI
# ==========================================================================

def test_poison_slot_writes_nan_into_the_float_leaves_only():
    from repro_torch.models import transformer as tf
    _, _, cfg = _engines("minicpm_int8_f32")
    caches = tf.init_cache(cfg, 3, 16, device="cpu", per_slot=True)
    for c in caches:
        c["k"].fill_(3)
        c["pos"].fill_(5)
    out = chaos.poison_slot(caches, 1)
    assert out is caches                       # in place
    for c in caches:
        assert bool(c["ks"][:, 1].isnan().all())
        assert bool(c["vs"][:, 1].isnan().all())
        assert not bool(c["ks"][:, [0, 2]].isnan().any())
        assert bool((c["k"] == 3).all()) and bool((c["pos"] == 5).all())
    bf = tf.init_cache(par.params("tiny")[1], 2, 8, device="cpu",
                       per_slot=True)
    chaos.poison_slot(bf, 0)
    assert all(bool(c["k"][:, 0].isnan().all()) and
               not bool(c["v"][:, 1].isnan().any()) for c in bf)


def test_poison_commits_nothing_of_its_tick():
    _, eng, cfg = _engines("minicpm_int8_f32")
    reqs = _chaos_reqs(serving, cfg.vocab_size, sampled=False)[:2]
    for r in reqs:
        r.arrival = 0
    session = eng.start(reqs)
    while not any(r.tokens for r in reqs):
        session.tick()
    lens = {r.rid: len(r.tokens) for r in reqs}
    slot = next(s for s, r in session.sched.active.items() if r.tokens)
    session.caches = chaos.poison_slot(session.caches, slot)
    with pytest.raises(serving.PoisonedLogits) as ei:
        for _ in range(4):
            session.tick()
    assert slot in ei.value.slots
    for r in reqs:
        if r.rid in ei.value.rids:
            assert len(r.tokens) == lens[r.rid] > 0


def test_survivor_stats_reduction_is_exact_through_shrink_and_grow():
    """Eight replicas' rows reduced on ``LocalTransport``; three die (p =
    5), two rejoin (p = 7): each sum numpy's, bit for bit, with the plan
    ``plan_remesh`` makes."""
    k = len(serving.STATS_FIELDS)
    rows = np.arange(1, 8 * k + 1, dtype=np.float32).reshape(8, k)
    for members in (tuple(range(8)), (0, 2, 3, 5, 6),
                    (0, 1, 2, 3, 5, 6, 7)):
        plan = ft.plan_remesh(members, float(k * 4))
        assert plan.new_p == len(members) and plan.new_num_blocks >= 1
        red = serving.make_stats_reducer(LocalTransport(plan.new_p, "cpu"))
        got = red(rows[list(members)])
        assert np.array_equal(got, rows[list(members)].sum(0))
    with pytest.raises(ValueError, match="do not match the 5 replicas"):
        serving.make_stats_reducer(LocalTransport(5, "cpu"))(rows[:3])


def test_corrupt_autotune_entry_degrades_to_the_cost_model(tmp_path,
                                                           monkeypatch):
    from repro_torch.core import autotune as at
    from repro_torch.core.collectives import CollectiveConfig, _pick
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    path = str(tmp_path / "autotune.json")
    try:
        at.set_cache_path(path)
        cfg = CollectiveConfig(method="auto")
        at.get_cache().put(8, 4096, "float32", cfg.comm_model.name,
                           at.TuneResult("sptree", 4, 1e-6))
        at.get_cache().save()
        assert _pick("auto", 8, 4096, cfg, "float32")[:2] == ("sptree", 4)
        victim = chaos.corrupt_autotune_cache(path, seed=0)
        assert victim.startswith("p=8/nbytes=4096/dtype=float32/")
        at.reset_cache()
        assert at.lookup(8, 4096, "float32", cfg.comm_model.name) is None
        algo, blocks, _, _ = _pick("auto", 8, 4096, cfg, "float32")
        assert algo in ("dptree", "sptree", "redbcast", "ring", "hier")
        assert blocks is None
        missing = str(tmp_path / "none.json")
        chaos.corrupt_autotune_cache(missing)
        assert json.load(open(missing))["entries"]
    finally:
        at.set_cache_path(None)


def test_chaos_cli_runs_on_the_cpu(capsys):
    rep = serve.main(["--arch", "minicpm_2b", "--reduced", "--chaos-seed",
                      "7", "--replicas", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[chaos seed=7] faults:" in out
    assert "0 diverged streams" in out
    assert rep["mode"] == "fleet" and rep["n_replicas"] == 3
    for bad in (["--chaos-seed", "1", "--replicas", "1"],
                ["--chaos-seed", "1", "--speculate"],
                ["--chaos-seed", "1", "--static"],
                ["--chaos-seed", "1", "--prefix-cache"],
                ["--chaos-seed", "1", "--policy", "slo"],
                ["--heartbeat-timeout", "0"], ["--heartbeat-misses", "0"],
                ["--rejoin-backoff", "-1"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--reduced", "--device", "cpu", *bad])
        assert e.value.code == 2, bad
