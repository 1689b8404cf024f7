"""The port's observability plane (``src/repro_torch/obs/`` and the
engine's hooks) against the JAX reference and within the port, on the CPU.

Against the reference: the ``Tracer``'s events and its JSONL and Chrome
exports; ``TickHistogram`` and ``StreamingMetrics``; the alpha-beta fit
(``fit_alpha_beta``, ``fit_hier``, ``residual_report``,
``export_residuals``) on the same samples, and within 10 % of the true
constants as ``tests/test_obs.py`` asks; the probe's notes for the same
``all_reduce`` calls (the reference's traced on an abstract 8-device mesh,
which runs its Python without devices; both priced with ``PAPER_HYDRA``);
and the engine's trace events (name, tick, rid, replica, attributes) for
chunked prefill, speculation, preemption, the prefix trie and shedding
under f32 compute. Within the port: traced and untraced runs give
bitwise the same tokens (bf16 and f32); the stats reducer lands one
timed sample a reduction; ``--trace-out``, ``--metrics-every`` and
``--probe`` run on the CPU.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import _torch_engine_parity as par
from repro import obs as ref_obs
from repro import serving as ref_serving
from repro.configs import base as ref_base
from repro.core import collectives as ref_coll
from repro.core import cost_model as ref_cm
from repro.launch.mesh import make_mesh
from repro_torch import obs, serving
from repro_torch.core import CollectiveConfig, LocalTransport, all_reduce
from repro_torch.core import cost_model as cm
from repro_torch.core.collectives import _pick
from repro_torch.launch import serve


# ==========================================================================
# tracer, histograms (host only)
# ==========================================================================

def _trace_script(mod):
    tr = mod.Tracer(max_events=9)
    tr.event("admit", 0, rid=3, replica=1, prompt_len=7, resumed=False)
    tr.event("decode", 1, n_active=np.int64(2))
    tr.event("commit", 1, rid=3, n_tokens=1, ttft_ticks=np.float32(2.0))
    tr.event("failover", 4, replica=2, quarantined=True, requeued=3,
             new_p=2)
    tr.event("failover", 4, rid=0, replica=0, journal_tokens=5, new_p=2)
    tr.event("metrics", 5, ttft_ticks_p50=float("inf"), blob=(1, 2))
    for t in range(6, 10):
        tr.event("commit", t, rid=0, n_tokens=t)
    return tr


def test_tracer_events_and_exports_are_the_references(tmp_path):
    got, want = _trace_script(obs), _trace_script(ref_obs)
    assert (len(got), got.dropped) == (len(want), want.dropped) == (9, 1)
    assert [e.to_dict() for e in got.events] == \
        [e.to_dict() for e in want.events]
    assert got.names() == want.names()
    assert [e.seq for e in got.by_name("commit")] == \
        [e.seq for e in want.by_name("commit")]
    paths = {}
    for name, tr in (("got", got), ("want", want)):
        paths[name] = (tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json")
        assert tr.to_jsonl(str(paths[name][0])) == 9
        tr.to_chrome(str(paths[name][1]))
    for i in (0, 1):
        assert paths["got"][i].read_bytes() == paths["want"][i].read_bytes()
    assert json.loads(paths["got"][1].read_text())["otherData"] == \
        {"tick_us": obs.TICK_US, "dropped_events": 1}
    assert obs.SPAN_NAMES == ref_obs.SPAN_NAMES
    assert obs.TICK_US == ref_obs.TICK_US
    with pytest.raises(ValueError):
        obs.Tracer(max_events=0)


def _same(a, b):
    return (math.isnan(a) and math.isnan(b)) or a == b


def test_histograms_and_streaming_metrics_are_the_references():
    rng = np.random.default_rng(0)
    for edges in (obs.DEFAULT_EDGES, (1.0, 2.0, 4.0), (0.5, 3.0)):
        h, r = obs.TickHistogram(edges), ref_obs.TickHistogram(edges)
        assert _same(h.percentile(50), r.percentile(50))
        vals = rng.integers(0, 100, 300).tolist() + [0, 1, 2, 64, 65]
        h.add_many(vals)
        r.add_many(vals)
        extra = rng.integers(0, 5, len(h.counts)).astype(float)
        h.merge_counts(extra)
        r.merge_counts(extra)
        assert h.to_dict() == r.to_dict() and h.total() == r.total()
        for q in (1, 50, 90, 95, 99, 100):
            assert h.percentile(q) == r.percentile(q)
        m, mr = obs.StreamingMetrics(edges), ref_obs.StreamingMetrics(edges)
        for _ in range(5):
            tt = rng.integers(0, 40, int(rng.integers(0, 4))).tolist()
            la = rng.integers(0, 80, int(rng.integers(0, 4))).tolist()
            row = m.row(tt, la)
            assert row == mr.row(tt, la)
            m.absorb(row)
            mr.absorb(row)
        a, b = m.snapshot(), mr.snapshot()
        assert a.keys() == b.keys()
        assert all(_same(a[k], b[k]) for k in a)
        assert m.width == mr.width
    for bad in ((), (1.0, 1.0), (4.0, 2.0)):
        with pytest.raises(ValueError):
            obs.TickHistogram(bad)
    with pytest.raises(ValueError, match="metrics tail has 2 floats"):
        obs.StreamingMetrics((1.0, 2.0)).absorb([0.0, 0.0])
    log = serving.TelemetryLog()
    log.step(0, list(range(len(serving.STATS_FIELDS))) + [7.0, 9.0])
    assert list(log.last_reduced[len(serving.STATS_FIELDS):]) == [7.0, 9.0]


# ==========================================================================
# the fit and the probe
# ==========================================================================

def _samples(mod, model, *, seed, noise, n=40):
    """The reference test's simulator samples, as ``mod``'s ProbeSample:
    small payloads at varied p (alpha) and large ones (beta)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        method = ["dptree", "sptree", "ring"][int(rng.integers(3))]
        p = int(2 ** rng.integers(2, 7))
        nbytes = int(2 ** rng.integers(6, 21))
        b = 1 if method == "ring" else int(rng.integers(1, 5))
        t = ref_obs.predict_time(method, p, nbytes, b, model)
        t *= 1.0 + noise * float(rng.standard_normal())
        out.append(mod.ProbeSample(p=p, nbytes=nbytes, dtype="float32",
                                   method=method, num_blocks=b, wall_s=t,
                                   kind="timed"))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_fit_is_the_references_and_recovers_alpha_beta(seed):
    true = ref_cm.CommModel(alpha=2.4e-6, beta=9.0e-12, gamma=0.0,
                            name="true")
    got = obs.fit_alpha_beta(_samples(obs, true, seed=seed, noise=0.005))
    want = ref_obs.fit_alpha_beta(_samples(ref_obs, true, seed=seed,
                                           noise=0.005))
    assert np.isclose(got.alpha, want.alpha, rtol=1e-9)
    assert np.isclose(got.beta, want.beta, rtol=1e-9)
    assert np.allclose(got.residuals, want.residuals, rtol=1e-9,
                       atol=1e-15)
    assert abs(got.alpha - true.alpha) / true.alpha < 0.10
    assert abs(got.beta - true.beta) / true.beta < 0.10
    samples = _samples(obs, true, seed=seed, noise=0.0, n=6)
    mine = obs.residual_report(samples, got.model("refit"))
    theirs = ref_obs.residual_report(
        _samples(ref_obs, true, seed=seed, noise=0.0, n=6),
        ref_cm.CommModel(got.alpha, got.beta, 0.0, "refit"))
    assert mine == theirs
    a, b = obs.Tracer(), ref_obs.Tracer()
    assert obs.export_residuals(a, samples, tick=7, model=cm.PAPER_HYDRA) \
        == ref_obs.export_residuals(b, _samples(ref_obs, true, seed=seed,
                                                noise=0.0, n=6), tick=7,
                                    model=ref_cm.PAPER_HYDRA) == 6
    assert [e.to_dict() for e in a.events] == [e.to_dict() for e in b.events]
    for method in ("dptree", "sptree", "redbcast", "ring"):
        assert obs.flat_coeffs(method, 16, 8192.0, 2) == \
            ref_obs.flat_coeffs(method, 16, 8192.0, 2)
        assert obs.predict_time(method, 16, 8192, 2) == \
            ref_obs.predict_time(method, 16, 8192, 2, ref_cm.PAPER_HYDRA)
    assert obs.predict_time("psum", 16, 8192, 2) is None


def test_fit_hier_and_refusals_are_the_references():
    levels = (4, 2)
    intra = ref_cm.CommModel(2e-7, 3e-12, 0.0, name="intra")
    inter = ref_cm.CommModel(5e-6, 1e-10, 0.0, name="inter")
    rng = np.random.default_rng(3)
    shapes = [(int(8 * 2 ** rng.integers(1, 5)), int(2 ** rng.integers(8, 24)),
               int(rng.integers(1, 9))) for _ in range(30)]
    mk = [[mod.ProbeSample(p=p, nbytes=n, dtype="float32", method="hier",
                           num_blocks=b, kind="timed", levels=levels,
                           wall_s=ref_cm.hier_time(p, float(n), b, inter,
                                                   group_size=levels,
                                                   intra_model=intra))
           for p, n, b in shapes] for mod in (obs, ref_obs)]
    got, want = obs.fit_hier(mk[0]), ref_obs.fit_hier(mk[1])
    assert got["spec"] == want["spec"] == levels
    for side in ("intra", "inter"):
        for f in ("alpha", "beta"):
            assert np.isclose(getattr(got[side], f), getattr(want[side], f),
                              rtol=1e-9)
    assert np.isclose(got["inter"].alpha, inter.alpha, rtol=1e-6)
    one = obs.ProbeSample(p=8, nbytes=64, dtype="float32", method="dptree",
                          num_blocks=1, wall_s=1e-4, kind="timed")
    for samples, match in (([one], "at least 2 samples"),
                           ([one] * 10, "do not span")):
        with pytest.raises(ValueError, match=match):
            obs.fit_alpha_beta(samples)
    with pytest.raises(ValueError, match="no timed hier samples"):
        obs.fit_hier([])
    with pytest.raises(ValueError, match="do not span"):
        obs.fit_hier([dataclasses.replace(s, p=16) for s in mk[0]])


_CALLS = [  # (method, per-rank f32 elements, num_blocks, group_size)
    ("auto", 16, 1, None), ("auto", 1024, None, None),
    ("auto", 1 << 18, None, None), ("dptree", 4096, 4, None),
    ("sptree", 4096, 3, None), ("redbcast", 4096, 2, None),
    ("ring", 4096, None, None), ("hier", 4096, 4, (4,)),
    ("hier", 4096, 2, (2, 2)),
]


def _ref_notes(p):
    mesh = AbstractMesh((p,), ("data",))
    with ref_obs.probing(model=ref_cm.PAPER_HYDRA) as pr:
        for method, n, nb, gs in _CALLS:
            cfg = ref_coll.CollectiveConfig(
                method=method, num_blocks=nb, group_size=gs,
                comm_model=ref_cm.PAPER_HYDRA)
            f = jax.shard_map(
                lambda v, cfg=cfg: ref_coll.all_reduce(v.reshape(-1), "data",
                                                       p, cfg),
                mesh=mesh, in_specs=PartitionSpec("data"),
                out_specs=PartitionSpec(), axis_names={"data"},
                check_vma=False)
            jax.eval_shape(f, jax.ShapeDtypeStruct((p, n), jnp.float32))
    return pr


def test_probe_notes_are_the_references_for_the_same_all_reduce_calls():
    p = 8
    want = _ref_notes(p)
    comm = LocalTransport(p, "cpu")
    x = {n: torch.randn(p, n) for _, n, _, _ in _CALLS}
    with obs.probing() as got:
        for method, n, nb, gs in _CALLS:
            all_reduce(x[n], comm, CollectiveConfig(
                method=method, num_blocks=nb, group_size=gs))
    assert obs.probe.active() is None
    def note(s):
        # hier's prediction prices its fast levels with the package's
        # default intra model (the reference's TPU preset; PAPER_HYDRA in
        # the port), so it is held below with the intra model named
        return {k: v for k, v in s.to_dict().items()
                if k != "axis" and (k != "predicted_s" or s.method != "hier")}

    assert [note(s) for s in got.samples] == [note(s) for s in want.samples]
    for s in got.samples:
        if s.method == "hier":
            assert s.predicted_s == ref_cm.hier_time(
                s.p, float(s.nbytes), s.num_blocks, ref_cm.PAPER_HYDRA,
                group_size=s.levels, intra_model=ref_cm.PAPER_HYDRA)
    assert len(got.traced()) == len(_CALLS) and not got.timed()
    assert {s.method for s in got.samples} >= {"dptree", "ring", "hier"}
    ring = obs.CollectiveProbe(capacity=2)
    for i in range(3):
        ring.note("dptree", 8, 64 << i, 1, kind="timed", wall_s=1e-4)
    assert (len(ring), ring.n_seen) == (2, 3)
    with pytest.raises(ValueError):
        obs.CollectiveProbe(capacity=0)
    outer = obs.install(obs.CollectiveProbe())
    with obs.probing() as inner:
        assert obs.active() is inner
    assert obs.active() is outer
    obs.uninstall()
    assert obs.active() is None


def test_stats_reducer_lands_one_timed_sample_a_reduction():
    p, k = 8, len(serving.STATS_FIELDS) + 4
    rows = np.arange(p * k, dtype=np.float32).reshape(p, k)
    reduce = serving.make_stats_reducer(LocalTransport(p, "cpu"))
    want = reduce(rows)
    with obs.probing() as pr:
        got = reduce(rows)
        one = reduce(rows[:1])
        with pytest.raises(ValueError, match="do not match the 8 replicas"):
            reduce(rows[:3])
    assert np.array_equal(got, want) and np.array_equal(one, 8 * rows[0])
    timed = pr.timed()
    algo, nb, lv, _ = _pick("auto", p, k * 4, serving.STATS_COLLECTIVE,
                            "float32")
    assert len(timed) == 2 and len(pr.traced()) == 2
    for s in timed:
        assert (s.p, s.nbytes, s.method, s.num_blocks, s.levels) == \
            (p, k * 4, algo, nb or 1, lv)
        assert s.wall_s > 0 and s.predicted_s is not None


# ==========================================================================
# the engine's hooks
# ==========================================================================

_DRAFTY = (5, 9, 2, 5, 9, 2, 5, 9, 2, 5, 9, 2, 5, 9, 2, 5)


def _matrix_reqs(mod, sampled):
    """A speculating BATCH victim with a two-chunk prompt and an
    INTERACTIVE interloper that preempts it from the single slot."""
    sp = mod.SamplingParams(temperature=0.9, top_p=0.85, seed=11) \
        if sampled else None
    return [mod.Request(0, _DRAFTY, max_new_tokens=12, arrival=0,
                        sampling=sp, spec=mod.SpecParams(draft_k=4),
                        slo=mod.SLOParams(priority=mod.PriorityClass.BATCH)),
            mod.Request(1, (7, 3), max_new_tokens=3, arrival=2,
                        sampling=None if sp is None else
                        dataclasses.replace(sp, seed=12),
                        slo=mod.SLOParams(
                            priority=mod.PriorityClass.INTERACTIVE,
                            deadline_ticks=8))]


def _shared_reqs(mod, vocab):
    rng = np.random.default_rng(7)
    shared = tuple(int(t) for t in rng.integers(1, vocab, 16))
    lead = tuple(int(t) for t in rng.integers(1, vocab, 4))
    div = tuple(int(t) for t in rng.integers(1, vocab, 5))
    return [mod.Request(0, shared + lead, max_new_tokens=5, arrival=0),
            mod.Request(1, shared + div, max_new_tokens=5, arrival=4),
            mod.Request(2, shared + lead, max_new_tokens=5, arrival=8)]


def _shed_reqs(mod):
    return [mod.Request(0, (3, 1), max_new_tokens=10, arrival=0,
                        slo=mod.SLOParams(priority=mod.PriorityClass.BATCH)),
            mod.Request(1, (2, 2), max_new_tokens=2, arrival=1,
                        slo=mod.SLOParams(
                            priority=mod.PriorityClass.BEST_EFFORT,
                            deadline_ticks=1))]


def _events(tr):
    return [(e.name, e.tick, e.rid, e.replica, e.attrs) for e in tr.events]


def _same_events(a, b) -> bool:
    """Equal event lists, a NaN attribute (an empty histogram's
    percentile) equal to a NaN."""
    return json.dumps(a, default=str) == json.dumps(b, default=str)


def _both(name, reqs_of, policy_of, **kw):
    """The workload through the reference's engine and the port's, each
    traced with live metrics every 2 ticks; the port's run again
    untraced. Returns (port report, port events, reference report,
    reference events, untraced port report)."""
    jcfg, cfg, jp, p = par.params(name)
    kw = dict(min_prefill_bucket=8, **kw)
    rt, pt = ref_obs.Tracer(), obs.Tracer()
    ref = ref_serving.ServingEngine(
        jcfg, ref_base.ParallelConfig(), make_mesh((1, 1), ("data", "model")),
        jp, tracer=rt, metrics=ref_obs.StreamingMetrics(), metrics_every=2,
        **kw).run(reqs_of(ref_serving, cfg.vocab_size),
                  policy=policy_of(ref_serving))
    eng = serving.ServingEngine(cfg, None, p, device="cpu", tracer=pt,
                                metrics=obs.StreamingMetrics(),
                                metrics_every=2, **kw)
    got = eng.run(reqs_of(serving, cfg.vocab_size),
                  policy=policy_of(serving))
    eng.tracer = eng.metrics = None
    eng.metrics_every = 0
    plain = eng.run(reqs_of(serving, cfg.vocab_size),
                    policy=policy_of(serving))
    return got, _events(pt), ref, _events(rt), plain


@pytest.mark.parametrize("sampled", [False, True])
def test_engine_trace_events_are_the_references(sampled):
    """Chunked prefill, speculation, a preemption and live metrics under
    f32 compute: the same events with the same attributes, the same live
    percentiles, and tracing changes no token."""
    got, ev, ref, rev, plain = _both(
        "tiny_f32", lambda m, v: _matrix_reqs(m, sampled),
        lambda m: m.SLOPolicy(age_ticks=100), n_slots=1, max_len=48,
        prefill_chunk=8)
    assert got["tokens"] == ref["tokens"] == plain["tokens"]
    assert _same_events(ev, rev)
    assert got["preemptions"] >= 1 and got["live_metrics"] == \
        ref["live_metrics"]
    assert {e[0] for e in ev} >= {"admit", "prefill_chunk", "decode",
                                  "draft", "commit", "preempt", "resume",
                                  "metrics"}
    assert "live_metrics" not in plain


def test_prefix_and_shed_events_are_the_references():
    got, ev, ref, rev, plain = _both(
        "tiny_f32", _shared_reqs, lambda m: None, n_slots=3, max_len=64,
        prefill_chunk=8, prefix_cache=True)
    assert got["tokens"] == ref["tokens"] == plain["tokens"]
    assert _same_events(ev, rev)
    assert [e[4]["tokens_reused"] for e in ev if e[0] == "prefix_adopt"] \
        == [16, 16]
    assert sum(e[0] == "prefix_insert" for e in ev) >= 1
    got, ev, ref, rev, _ = _both(
        "tiny_f32", lambda m, v: _shed_reqs(m),
        lambda m: m.SLOPolicy(age_ticks=0), n_slots=1, max_len=48,
        prefill_chunk=8)
    assert _same_events(ev, rev) and got["shed_requests"] == 1
    assert [e[2] for e in ev if e[0] == "shed"] == [1]


def test_traced_bf16_int8_run_keeps_its_tokens():
    """Reduced MiniCPM-2B with the int8 cache under bf16 compute: tracing
    and live metrics attached change no token and no counter."""
    cfg, eng = par.engine("minicpm_int8", n_slots=3, max_len=64,
                          prefill_chunk=8)
    reqs = lambda: par.workload(serving, cfg.vocab_size, spec=True)  # noqa
    want = eng.run(reqs(), policy=serving.SLOPolicy())
    eng.tracer, eng.metrics = obs.Tracer(), obs.StreamingMetrics()
    got = eng.run(reqs(), policy=serving.SLOPolicy())
    assert got["tokens"] == want["tokens"]
    for k in par.COUNTERS:
        assert got[k] == want[k], k
    assert len(eng.tracer) > 0
    assert got["live_metrics"]["ttft_n"] == got["requests"]


def test_trace_metrics_and_probe_flags_run_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "run.json")
    argv = ["--arch", "minicpm_2b", "--reduced", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--prompt-len", "10", "20",
            "--prefill-chunk", "16"]
    rep = serve.main(argv + ["--trace-out", path, "--trace-format", "both",
                             "--metrics-every", "3", "--probe"])
    out = capsys.readouterr().out
    assert rep["requests"] == 3 and "live_metrics" in rep
    assert "[metrics t=2]" in out and f"-> {path} (chrome" in out
    doc = json.load(open(path))
    lines = open(path + ".jsonl").read().splitlines()
    assert len(lines) == sum(e.get("cat") == "serving"
                             for e in doc["traceEvents"])
    assert {json.loads(x)["name"] for x in lines} >= {"admit", "commit"}
    chaos = serve.main(argv + ["--chaos-seed", "3", "--replicas", "3",
                               "--trace-out", path, "--probe"])
    assert chaos["mode"] == "fleet"
    assert "0 diverged streams" in capsys.readouterr().out
    for bad in (["--trace-format", "jsonl"], ["--metrics-every", "-1"],
                ["--mesh", "1x2"]):
        with pytest.raises(SystemExit) as e:
            serve.main(["--reduced", "--device", "cpu", *bad])
        assert e.value.code == 2, bad
    assert "item 4" in capsys.readouterr().err
