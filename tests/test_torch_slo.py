"""The port's SLO policy in the engine, its traces and the serve CLI's
speculation, prefix and policy flags, against the JAX reference and
within the port, on the CPU.

Against the reference: ``generate_trace`` and ``trace_summary`` on the
same specs and seeds; ``synthetic_workload`` with its speculation, SLO,
repetitive and shared-prefix options; the engine's streams and counters
under the SLO policy, alone and with speculation and the prefix cache
(``tests/_torch_engine_parity.py``). Within the port: a preempted request
resumes to the undisturbed FIFO stream with the prefix cache and
speculation on; static batching refuses the SLO policy; the CLI runs the
new flags end to end on the CPU and refuses bad values before any model
work.
"""

import numpy as np
import pytest

import _torch_engine_parity as par
from repro import serving as ref_serving
from repro.launch import serve as ref_serve
from repro_torch import serving
from repro_torch.launch import serve


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_trace_and_summary_are_the_references(seed):
    specs = [dict(), dict(n_requests=50, gap_mean=0.0, burst_mean=5.0,
                          prompt_median=20.0, max_prompt=64, max_out=40),
             dict(n_requests=9, mix=((1.0, 2, 5, True), (2.0, 0, None,
                                                          None)))]
    for kw in specs:
        mix = kw.pop("mix", None)
        got = serving.generate_trace(serving.TraceSpec(**kw, **(
            {"mix": tuple(serving.ClassSpec(*m) for m in mix)} if mix
            else {})), 500, seed=seed, base_rid=3)
        want = ref_serving.generate_trace(ref_serving.TraceSpec(**kw, **(
            {"mix": tuple(ref_serving.ClassSpec(*m) for m in mix)} if mix
            else {})), 500, seed=seed, base_rid=3)
        assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival,
                 int(r.slo.priority), r.slo.deadline_ticks,
                 r.slo.preemptible) for r in got] == \
            [(r.rid, r.prompt, r.max_new_tokens, r.arrival,
              int(r.slo.priority), r.slo.deadline_ticks, r.slo.preemptible)
             for r in want]
        assert serving.trace_summary(got) == ref_serving.trace_summary(want)


def test_synthetic_workload_options_are_the_references():
    got = serve.synthetic_workload(
        7, 300, gap=2, seed=3, prompt_lens=(4, 30), max_new=(2, 9),
        spec=serving.SpecParams(draft_k=3), repetitive=True,
        slo=serving.SLOParams(priority=serving.PriorityClass.INTERACTIVE,
                              deadline_ticks=5), shared_prefix=12)
    want = ref_serve.synthetic_workload(
        7, 300, gap=2, seed=3, prompt_lens=(4, 30), max_new=(2, 9),
        spec=ref_serving.SpecParams(draft_k=3), repetitive=True,
        slo=ref_serving.SLOParams(
            priority=ref_serving.PriorityClass.INTERACTIVE,
            deadline_ticks=5), shared_prefix=12)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival, r.spec.draft_k,
             int(r.slo.priority), r.slo.deadline_ticks) for r in got] == \
        [(r.rid, r.prompt, r.max_new_tokens, r.arrival, r.spec.draft_k,
          int(r.slo.priority), r.slo.deadline_ticks) for r in want]
    assert all(r.prompt[:12] == got[0].prompt[:12] for r in got)


@pytest.mark.parametrize("name", ["tiny_f32", "minicpm_int8"])
def test_engine_with_slo_policy_matches_the_jax_engine(name):
    got, want = par.check_against_jax(name, slo=True)
    assert want["preemptions"] > 0 and want["resumed_tokens"] > 0
    assert got["policy"] == "slo"


@pytest.mark.parametrize("name", ["minicpm_int8_f32", "minicpm_int8"])
def test_engine_with_everything_matches_the_jax_engine(name):
    """The SLO policy with speculation and the prefix cache together."""
    got, want = par.check_against_jax(name, spec=True, prefix=True, slo=True)
    assert want["preemptions"] > 0 and want["prefix_hits"] > 0


@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
@pytest.mark.parametrize("spec", [False, True])
def test_warm_preempt_resume_matches_undisturbed(name, spec):
    """A BATCH victim preempted for an INTERACTIVE arrival, with the prefix
    cache (and speculation) on: it re-adopts a boundary of its own
    journal-extended history and its stream equals the undisturbed FIFO
    run's; every pin is released."""
    cfg, cold = par.engine(name, n_slots=1, max_len=48, prefill_chunk=8)
    _, warm = par.engine(name, n_slots=1, max_len=48, prefill_chunk=8,
                         prefix_cache=True)
    victim = tuple(int(t) for t in
                   np.random.default_rng(3).integers(1, 101, 17))
    sp = serving.SpecParams(draft_k=3) if spec else None

    def mk():
        return [serving.Request(0, victim, 16, slo=serving.SLOParams(
                    priority=serving.PriorityClass.BATCH), spec=sp),
                serving.Request(1, (7, 3), 3, arrival=4,
                                slo=serving.SLOParams(
                                    priority=serving.PriorityClass.INTERACTIVE,
                                    deadline_ticks=8), spec=sp)]

    base = cold.run(mk())
    slo = warm.run(mk(), policy=serving.SLOPolicy(age_ticks=100))
    assert slo["preemptions"] >= 1 and slo["resumed_tokens"] > 0
    assert slo["tokens"] == base["tokens"]
    assert slo["prefix_hits"] >= 1
    assert slo["prefix_cache"]["pinned"] == 0
    assert slo["slo"]["interactive"]["ttft_ticks_p50"] < \
        base["slo"]["interactive"]["ttft_ticks_p50"]


def test_static_batching_refuses_the_slo_policy():
    _, eng = par.engine()
    with pytest.raises(ValueError, match="static"):
        eng.run([serving.Request(0, (1, 2), 2)], static=True,
                policy=serving.SLOPolicy())
    assert eng.run([serving.Request(0, (1, 2), 2)], static=True,
                   policy=serving.FIFOPolicy())["requests"] == 1


def test_shed_requests_are_counted():
    """A BEST_EFFORT request whose deadline passes in the queue is shed
    and counted as a deadline miss; the rest are served."""
    _, eng = par.engine(n_slots=1)
    reqs = [serving.Request(0, (1, 2, 3), 10),
            serving.Request(1, (4, 5), 3, slo=serving.SLOParams(
                priority=serving.PriorityClass.BEST_EFFORT,
                deadline_ticks=2))]
    report = eng.run(reqs, policy=serving.SLOPolicy())
    assert report["shed_requests"] == 1 and report["deadline_misses"] == 1
    assert report["requests"] == 1
    assert report["slo"]["best_effort"]["shed"] == 1


CLI = ["--arch", "minicpm_2b", "--reduced", "--requests", "6", "--slots",
       "3", "--device", "cpu"]


def test_cli_runs_speculation_prefixes_and_policies(capsys):
    spec = serve.main(CLI + ["--speculate"])
    assert spec["mode"] == "continuous" and spec["drafted_tokens"] > 0
    out = capsys.readouterr().out
    assert "drafts accepted" in out
    warm = serve.main(CLI + ["--prefix-cache", "--shared-prefix", "16",
                             "--prefill-chunk", "8"])
    assert warm["prefix_hits"] > 0 and "prefix_cache" in warm
    assert "prefix cache:" in capsys.readouterr().out
    slo = serve.main(CLI + ["--policy", "slo", "--priority", "interactive",
                            "--deadline-ticks", "8"])
    assert slo["policy"] == "slo"
    assert "deadline misses" in capsys.readouterr().out
    every = serve.main(CLI + ["--continuous", "--speculate", "--prefix-cache",
                              "--shared-prefix", "16", "--policy", "slo",
                              "--priority", "interactive",
                              "--deadline-ticks", "8"])
    line = capsys.readouterr().out
    assert "[continuous/slo]" in line and "drafts accepted" in line \
        and "preemptions" in line and "prefix cache:" in line
    assert every["requests"] == 6


def test_cli_refuses_bad_values_and_later_flags(capsys, monkeypatch):
    called = []
    monkeypatch.setattr(serve, "serve_continuous",
                        lambda *a, **k: called.append(a))
    monkeypatch.setattr(serve, "serve_loop", lambda *a, **k: called.append(a))
    for bad in (["--speculate", "--draft-k", "0"],
                ["--speculate", "--draft-k", "17"],
                ["--deadline-ticks", "0"],
                ["--prefix-cache-nodes", "8"],
                ["--prefix-cache", "--prefix-cache-nodes", "0"],
                ["--shared-prefix", "-1"],
                ["--policy", "slo", "--static"],
                ["--policy", "edf"],
                ["--priority", "urgent"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--reduced", "--device", "cpu", *bad])
        assert e.value.code == 2, bad
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--device", "cpu", "--mesh=1x2"])
    assert e.value.code == 2
    assert "item 4" in capsys.readouterr().err
    assert not called
    serve.main(["--reduced", "--device", "cpu", "--policy", "slo"])
    serve.main(["--reduced", "--device", "cpu", "--draft-model",
                "minicpm_2b"])
    assert len(called) == 2
    # the flags of items 2c and 6 run: the fleet's go to the chaos driver,
    # the observability flags imply the continuous engine
    chaos = []
    monkeypatch.setattr(serve, "serve_chaos", lambda *a, **k: chaos.append(a))
    serve.main(["--reduced", "--device", "cpu", "--chaos-seed=1",
                "--replicas=2", "--heartbeat-timeout=2"])
    for flag in ("--trace-out=x", "--metrics-every=2", "--probe"):
        serve.main(["--reduced", "--device", "cpu", flag])
    assert len(chaos) == 1 and len(called) == 5
