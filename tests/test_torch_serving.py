"""The port's continuous-batching engine against the JAX reference's
``repro.serving``, and against itself, on the CPU.

Configs: the tiny inline config of ``tests/test_serving.py`` (2 layers,
d_model 32, vocab 101, bf16 compute, a bf16 ring) and reduced MiniCPM-2B
with its decode config (bf16 params) and the int8 K/V cache forced on.
Both engines get the same config, the reference's parameters
(``interop.params_from_reference``) and the same requests.

Tolerances, as in ``tests/test_torch_models.py``: layer outputs within
``2**-7`` of the largest |output| under f32 compute with the int8 cache (a
code at a .5 tie may round the other way) and ``1e-5`` without it;
``6 * 2**-8`` under bf16. Greedy streams are equal token for token unless
they part at a step whose reference top-2 logit margin is within twice the
bf16 tolerance of its largest |logit| (each of the two may move by it).
Scheduling numbers (ticks, prefill chunks, TTFT) do not depend on token
values and are equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch.mesh import make_mesh
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro import serving as ref_serving
from repro.serving import scheduler as ref_scheduler
from repro.serving import telemetry as ref_telemetry
from repro_torch import serving
from repro_torch.configs import base
from repro_torch.core.transport import LocalTransport
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve, step_fns
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.serving import scheduler, telemetry

TOL = {"f32": 1e-5, "f32_int8": 2.0 ** -7, "bf16": 6 * 2.0 ** -8}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tiny(mod, **kw):
    cfg = dict(name="serve-tiny", n_layers=2, d_model=32, n_heads=2,
               n_kv_heads=2, d_ff=64, vocab_size=101, remat=False)
    cfg.update(kw)
    return mod.ModelConfig(**cfg)


def _minicpm(mod, param_dtype):
    return dataclasses.replace(
        mod.get_config("minicpm_2b", reduced=True), param_dtype=param_dtype,
        kv_quant=True)


CONFIGS = {
    "tiny": lambda: (_tiny(ref_tf), _tiny(tf)),
    "minicpm_int8": lambda: (_minicpm(ref_base, jnp.bfloat16),
                             _minicpm(base, torch.bfloat16)),
}
_PARAMS: dict = {}


def _params(name):
    if name not in _PARAMS:
        jcfg, cfg = CONFIGS[name]()
        jp = ref_tf.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[name] = (jcfg, cfg, jp, params_from_reference(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[name]


def _engine(name="tiny", n_slots=3, max_len=32, **kw):
    _, cfg, _, p = _params(name)
    kw.setdefault("min_prefill_bucket", 8)
    return cfg, serving.ServingEngine(cfg, None, p, n_slots=n_slots,
                                      max_len=max_len, device="cpu", **kw)


def _requests(mod, n, vocab, *, gap=0, seed=0, max_new=(2, 8), plen=(2, 7),
              sampling=None):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, tuple(int(t) for t in rng.integers(
        1, vocab, int(rng.integers(*plen)))),
        max_new_tokens=int(rng.integers(*max_new)), arrival=i * gap,
        sampling=sampling)
        for i in range(n)]


# ---------------------------------------------------------------- host side

def _drive(mod, ops, n_slots):
    """Apply a sequence of (op, arg) to a scheduler: submit a request,
    admit at a tick (continuous or batch-sync), or release a slot."""
    sched = mod.SlotScheduler(n_slots)
    reqs, log = {}, []
    req_mod = ref_serving if mod is ref_scheduler else serving
    for op, arg in ops:
        if op == "submit":
            rid, arrival = arg
            reqs[rid] = req_mod.Request(rid, (1, 2), 3, arrival=arrival)
            sched.submit(reqs[rid])
        elif op == "admit":
            now, sync = arg
            log.append([(s, r.rid) for s, r in sched.admit(now, sync)])
        elif arg in sched.active:
            log.append(("release", arg, sched.release(arg, 0).rid))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_admits_the_references_slots(seed):
    rng = np.random.default_rng(seed)
    ops, rid = [], 0
    for now in range(40):
        for _ in range(int(rng.integers(0, 3))):
            ops.append(("submit", (rid, now + int(rng.integers(0, 4)))))
            rid += 1
        ops.append(("admit", (now, bool(seed % 2 and rng.random() < 0.5))))
        for s in rng.choice(4, int(rng.integers(0, 3)), replace=False):
            ops.append(("release", int(s)))
    assert _drive(scheduler, ops, 4) == _drive(ref_scheduler, ops, 4)


def test_stats_fields_and_vector_are_the_references():
    assert telemetry.STATS_FIELDS == ref_telemetry.STATS_FIELDS
    stats = {f: i * 1.5 for i, f in enumerate(telemetry.STATS_FIELDS)}
    assert telemetry.stats_vector(stats) == ref_telemetry.stats_vector(stats)
    with pytest.raises(ValueError, match="drifted"):
        telemetry.stats_vector({**stats, "bogus": 1})
    assert [f.name for f in dataclasses.fields(telemetry.StepStats)] == \
        [f.name for f in dataclasses.fields(ref_telemetry.StepStats)]


@pytest.mark.parametrize("p", [4, 8])
def test_stats_reducer_over_replicas_is_the_numpy_sum(p):
    """p replicas stacked on one device, reduced through the port's
    all_reduce at b = 1 (the cost model picks the ring at p = 4 and the
    dual-root tree at p = 8), equal to numpy's sum (small integer counters
    sum exactly in any order); a single row stands in for every replica;
    one replica sums on the host."""
    rows = np.random.default_rng(p).integers(
        0, 50, (p, len(telemetry.STATS_FIELDS))).astype(np.float32)
    red = telemetry.make_stats_reducer(LocalTransport(p, "cpu"))
    assert np.array_equal(red(rows), rows.sum(0))
    assert np.array_equal(red(rows[:1]), p * rows[0])
    with pytest.raises(ValueError, match="replicas"):
        red(rows[:3])
    assert np.array_equal(telemetry.make_stats_reducer()(rows), rows.sum(0))
    log = telemetry.TelemetryLog(red)
    s = log.step(0, rows)
    assert s.new_tokens == rows[:, 2].sum()


# ------------------------------------------------------ attention with slots

def _slot_case(rng, kv_quant, dt, S=8):
    jdt, tdt = DTYPES[dt]
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=12)
    B, D, KV, dh = 3, 32, 2, 12
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (D, 48)), ("wk", (D, KV * dh)),
                      ("wv", (D, KV * dh)), ("wo", (48, D)))}
    kv = rng.standard_normal((2, B, S, KV, dh)).astype(np.float32)
    if kv_quant:
        jq = [ref_layers.quantize_kv_rows(jnp.asarray(a)) for a in kv]
        jc = {"k": jq[0][0], "v": jq[1][0], "ks": jq[0][1], "vs": jq[1][1]}
    else:
        jc = {"k": jnp.asarray(kv[0], jdt), "v": jnp.asarray(kv[1], jdt)}
    c = params_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    return (ref_layers.AttnConfig(**kw), layers.AttnConfig(**kw),
            {k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()}, jc, c)


# (positions, lengths or None, active): a fresh chunk, a resumed chunk
# whose bucket wraps the ring of 8 (its pads past lengths not written), an
# inactive row; and a decode tick with an inactive row
SLOT_CASES = {
    "prefill": (4, [0, 5, 6], [4, 2, 3], [True, False, True]),
    "decode": (1, [3, 9, 0], None, [True, True, False]),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_decode_slots_matches(dt, kv_quant, case):
    """The port against the reference's ``attention_decode_slots`` followed
    by its ``merge_cache_rows`` (inactive rows keep their old cache)."""
    T, pos, lengths, active = SLOT_CASES[case]
    rng = np.random.default_rng(T + len(dt) + kv_quant)
    jacfg, acfg, jw, w, jc, c = _slot_case(rng, kv_quant, dt)
    jdt, tdt = DTYPES[dt]
    x = rng.standard_normal((3, T, 32)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jout, jnew = jax.jit(ref_layers.attention_decode_slots,
                         static_argnums=1)(
        jw, jacfg, jnp.asarray(x, jdt), jc, jnp.asarray(pos, jnp.int32), jl)
    old = {k: np.asarray(v) for k, v in jc.items()}
    with torch.no_grad():
        out, new = layers.attention_decode_slots(
            w, acfg, torch.from_numpy(x).to(tdt), c,
            torch.tensor(pos, dtype=torch.int32),
            lengths=None if lengths is None else torch.tensor(lengths),
            active=torch.tensor(active))
    tol = TOL["f32_int8" if (kv_quant and dt == "f32") else dt]
    act = np.asarray(active)
    got_out = out.to(torch.float32).numpy()[act]
    want_out = np.asarray(jout).astype(np.float32)[act]
    if lengths is not None:          # pad queries' outputs mean nothing
        for i, b in enumerate(np.flatnonzero(act)):
            got_out[i, lengths[b]:] = want_out[i, lengths[b]:] = 0
    err = np.abs(got_out - want_out).max() / np.abs(want_out).max()
    assert err <= tol, (case, err)
    n = [(lengths[b] if lengths else T) if active[b] else 0 for b in range(3)]
    for name in new:
        got = new[name]
        got = (got.view(torch.int16) if got.dtype == torch.bfloat16
               else got).numpy()
        want = np.asarray(jnew[name])
        before = old[name]
        before = before.view(np.int16) if before.dtype == jnp.bfloat16 \
            else before
        for b in range(3):
            written = [(pos[b] + t) % 8 for t in range(n[b])]
            keep = [s for s in range(8) if s not in written]
            assert np.array_equal(got[b, keep], before[b, keep]), (name, b)
            if not written:
                continue
            g = new[name][b, written].to(torch.float32).numpy()
            r = np.asarray(jnew[name])[b, written].astype(np.float32)
            if name in ("k", "v") and kv_quant:     # codes: +-1 at ties
                assert np.abs(g - r).max() <= 1, (name, b)
            else:
                assert np.abs(g - r).max() <= tol * max(np.abs(r).max(),
                                                        1e-30), (name, b)
        del want


# ----------------------------------------------------- against the JAX engine

def _ref_logits(jcfg, jp, history) -> np.ndarray:
    """The reference's scalar decode over ``history``: the logits after its
    last token."""
    step = jax.jit(lambda p, i, c: ref_tf.decode_step(p, jcfg, i, c))
    caches = ref_tf.init_cache(jcfg, 1, len(history) + 1)
    for t in history:
        logits, caches = step(jp, {"tokens": jnp.asarray([[t]], jnp.int32)},
                              caches)
    return np.asarray(logits)[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_the_jax_engine(name):
    """Staggered arrivals, more requests than slots, prompts of several
    chunks: the same greedy streams (margin rule) and the same ticks,
    prefill chunks and TTFT as the JAX ``ServingEngine``."""
    jcfg, cfg, jp, p = _params(name)
    kw = dict(n_slots=3, max_len=64, prefill_chunk=16, min_prefill_bucket=8)
    mesh = make_mesh((1, 1), ("data", "model"))
    want = ref_serving.ServingEngine(jcfg, ref_base.ParallelConfig(), mesh,
                                     jp, **kw).run(
        _requests(ref_serving, 7, cfg.vocab_size, gap=1, seed=3,
                  plen=(3, 40)))
    got = serving.ServingEngine(cfg, None, p, device="cpu", **kw).run(
        _requests(serving, 7, cfg.vocab_size, gap=1, seed=3, plen=(3, 40)))
    for k in ("requests", "ticks", "prefill_chunks", "ttft_ticks_p50",
              "latency_ticks_p95", "total_tokens"):
        assert got[k] == want[k], k
    prompts = {r.rid: r.prompt for r in _requests(
        serving, 7, cfg.vocab_size, gap=1, seed=3, plen=(3, 40))}
    parted = 0
    for rid, toks in want["tokens"].items():
        mine = got["tokens"][rid]
        if mine == toks:
            continue
        i = next(j for j, (a, b) in enumerate(zip(mine, toks)) if a != b)
        logits = _ref_logits(jcfg, jp, prompts[rid] + tuple(toks[:i]))
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * TOL["bf16"] * np.abs(logits).max(), \
            (rid, i)
        parted += 1
    assert parted <= 1


# ------------------------------------------------------------ within the port

def test_continuous_equals_static_at_gap_zero():
    cfg, eng = _engine()
    cont = eng.run(_requests(serving, 6, cfg.vocab_size, seed=11))
    stat = eng.run(_requests(serving, 6, cfg.vocab_size, seed=11),
                   static=True)
    assert cont["tokens"] == stat["tokens"]
    assert stat["mode"] == "static" and cont["mode"] == "continuous"
    cont2 = eng.run(_requests(serving, 6, cfg.vocab_size, gap=3, seed=11))
    assert cont2["tokens"] == cont["tokens"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_prefill_equals_one_shot(name):
    _, cfg, _, _ = _params(name)
    prompt = tuple(int(t) for t in
                   np.random.default_rng(0).integers(1, 101, 20))
    reqs = lambda: [serving.Request(0, prompt, max_new_tokens=5),  # noqa
                    serving.Request(1, (7, 3), max_new_tokens=4, arrival=1)]
    _, chunked = _engine(name, n_slots=2, max_len=64, prefill_chunk=8)
    _, oneshot = _engine(name, n_slots=2, max_len=64, prefill_chunk=32)
    a, b = chunked.run(reqs()), oneshot.run(reqs())
    c = chunked.run(reqs(), static=True)
    assert a["tokens"] == b["tokens"] == c["tokens"]
    assert a["prefill_chunks"] == 4 and b["prefill_chunks"] == 2


def test_reused_slot_equals_a_fresh_engine():
    _, eng = _engine("minicpm_int8", n_slots=1, max_len=32)
    first = serving.Request(0, (7, 3, 11), max_new_tokens=6)
    probe = serving.Request(1, (23, 2, 5, 8), max_new_tokens=5)
    report = eng.run([first, probe])                  # probe reuses slot 0
    fresh = eng.run([serving.Request(2, (23, 2, 5, 8), max_new_tokens=5)])
    assert report["tokens"][1] == fresh["tokens"][2]


def test_inactive_and_prefilling_slots_stay_bit_unchanged():
    """A decode tick writes no K/V into a free or a prefilling slot, and a
    prefill chunk none into its neighbours."""
    cfg, eng = _engine("minicpm_int8", n_slots=3, max_len=64,
                       prefill_chunk=8)
    long = serving.Request(0, tuple(range(1, 30)), max_new_tokens=3)
    short = serving.Request(1, (5, 9), max_new_tokens=8)
    session = eng.start([short, long])
    session.tick()                 # short: prefill + decode; long: chunk 1
    snap = [{k: v.clone() for k, v in c.items()} for c in session.caches]
    session.tick()                 # long: chunk 2 (slot 1), short decodes
    for c, old in zip(session.caches, snap):
        for k in ("k", "v", "ks", "vs"):
            assert torch.equal(c[k][:, 2], old[k][:, 2])      # free slot
        assert c["pos"][0, 1] == old["pos"][0, 1] + 8
        assert c["pos"][0, 0] == old["pos"][0, 0] + 1
        assert c["pos"][0, 2] == 0
    snap = [{k: v.clone() for k, v in c.items()} for c in session.caches]
    step = eng._decode
    caches = session.caches
    active = np.array([True, False, False])
    _, caches = step(eng.params, {"tokens": torch.zeros((3, 1),
                                                        dtype=torch.long)},
                     caches, active)
    for c, old in zip(caches, snap):
        for k in ("k", "v", "ks", "vs"):
            assert torch.equal(c[k][:, 1:], old[k][:, 1:])
        assert c["pos"][:, 1:].equal(old["pos"][:, 1:])


def test_engine_matches_legacy_scalar_decode():
    """Slot prefill and slot decode give the port's scalar-position decode
    path token for token."""
    cfg, eng = _engine(n_slots=2, max_len=16)
    prompt = (5, 9, 2, 17)
    report = eng.run([serving.Request(0, prompt, max_new_tokens=4)])
    params = _params("tiny")[3]
    caches = tf.init_cache(cfg, 1, 16, device="cpu")
    toks, out = list(prompt), []
    with torch.no_grad():
        for i in range(len(prompt) + 3):
            logits, caches = tf.decode_step(
                params, cfg, {"tokens": torch.tensor([[toks[i]]])}, caches)
            if i >= len(prompt) - 1:
                out.append(int(logits[0].argmax()))
                toks.append(out[-1])
    assert report["tokens"][0] == out


@pytest.mark.parametrize("sampled", [False, True])
def test_journal_resume_yields_the_undisturbed_stream(sampled):
    """A request re-submitted with the first k tokens of its stream as its
    journal re-prefills prompt + journal and continues with the same
    tokens (greedy and seeded top-p alike)."""
    cfg, eng = _engine("minicpm_int8", n_slots=2, max_len=64,
                       prefill_chunk=8)
    sp = serving.SamplingParams(temperature=0.9, top_p=0.85, seed=5) \
        if sampled else None
    prompt = tuple(range(3, 22))
    whole = eng.run([serving.Request(0, prompt, 9, sampling=sp)])
    stream = whole["tokens"][0]
    assert whole["sampled_tokens"] == (9 if sampled else 0)
    for k in (1, 4, 8):
        req = serving.Request(1, prompt, 9, sampling=sp)
        req.tokens = list(stream[:k])
        report = eng.run([req])
        assert report["tokens"][1] == stream
        assert report["resumed_tokens"] == k


def test_bucket_wrap_leaves_the_rings_live_kv_unchanged():
    """A resumed final chunk whose bucket wraps the ring (prompt 28, chunks
    of 8, ring 32, bucket 16: ring slots 24..31 then 0..7) writes only its
    4 real tokens: slots 0..23 keep the earlier chunks' K/V bit for bit,
    and the streams equal the one-shot prefill's."""
    prompt = tuple(int(t) for t in
                   np.random.default_rng(5).integers(1, 101, 28))
    _, chunked = _engine("minicpm_int8", n_slots=2, max_len=32,
                         prefill_chunk=8, min_prefill_bucket=16)
    session = chunked.start([serving.Request(0, prompt, max_new_tokens=4)])
    for _ in range(3):
        session.tick()
    snap = [{k: v[:, 0].clone() for k, v in c.items() if k != "pos"}
            for c in session.caches]
    session.tick()           # the final chunk, then the first decode
    for c, old in zip(session.caches, snap):
        for k, v in old.items():
            assert torch.equal(c[k][:, 0, :24], v[:, :24]), k
            assert torch.equal(c[k][:, 0, 29:], v[:, 29:]), k
            assert not torch.equal(c[k][:, 0, 24:29], v[:, 24:29]), k
    while session.running:
        session.tick()
    a = session.report()
    _, oneshot = _engine("minicpm_int8", n_slots=2, max_len=32,
                         prefill_chunk=32, min_prefill_bucket=16)
    b = oneshot.run([serving.Request(0, prompt, max_new_tokens=4)])
    assert a["tokens"] == b["tokens"]


def test_poisoned_logits_commit_nothing():
    cfg, eng = _engine(n_slots=2)
    session = eng.start([serving.Request(0, (4, 5, 6), max_new_tokens=5)])
    session.tick()
    before = list(session.sched.active[0].tokens)
    eng.params["final_norm"]["scale"][0] = float("nan")
    try:
        with pytest.raises(serving.PoisonedLogits, match="slots"):
            session.tick()
    finally:
        eng.params["final_norm"]["scale"][0] = 1.0
    assert session.sched.active[0].tokens == before


def test_engine_refuses_what_is_not_ported():
    cfg, eng = _engine()
    with pytest.raises(NotImplementedError, match="item 2b"):
        eng.run([serving.Request(0, (1, 2), 2, spec=serving.SpecParams())])
    with pytest.raises(NotImplementedError, match="item 2b"):
        eng.run([], policy=serving.SLOPolicy())
    p = _params("tiny")[3]
    for kw, item in ((dict(prefix_cache=True), "item 2b"),
                     (dict(tracer=object()), "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            serving.ServingEngine(cfg, None, p, device="cpu", **kw)
    with pytest.raises(ValueError, match="exceeds"):
        eng.run([serving.Request(0, (1,) * 4, max_new_tokens=30)])
    with pytest.raises(NotImplementedError, match="item 7"):
        step_fns.make_prefill_step(cfg, into_slots=False)
    with pytest.raises(ValueError, match="slot serving"):
        serving.ServingEngine(base.get_config("qwen2_vl_7b", reduced=True),
                              None, p, device="cpu")


def test_continuous_cli_runs_and_refuses_later_flags(capsys, tmp_path):
    """``--continuous`` end to end on reduced MiniCPM-2B on the CPU (its
    decode config, greedy then sampled); the flags of items 2b, 2c, 6 and
    4 stay refused with their item; ``--autotune-cache`` sets the cache
    path."""
    argv = ["--arch", "minicpm_2b", "--reduced", "--continuous",
            "--requests", "6", "--slots", "3", "--prompt-len", "20", "80",
            "--prefill-chunk", "16", "--device", "cpu"]
    report = serve.main(argv)
    assert report["requests"] == 6 and report["mode"] == "continuous"
    assert report["prefill_chunks"] > 6
    assert "[continuous/fifo] 6 requests" in capsys.readouterr().out
    sampled = serve.main(argv + ["--temperature", "0.8", "--top-k", "50",
                                 "--top-p", "0.95", "--static"])
    assert sampled["mode"] == "static"
    assert sampled["sampled_tokens"] == sampled["total_tokens"]
    from repro_torch.core import autotune
    path = str(tmp_path / "tune.json")
    try:
        serve.main(["--reduced", "--device", "cpu", "--steps", "1",
                    "--autotune-cache", path])
        assert autotune.default_cache_path() == path
    finally:
        autotune.set_cache_path(None)
    for flag, item in (("--speculate", "item 2b"), ("--policy=slo", "2b"),
                       ("--prefix-cache", "2b"), ("--replicas=2", "2c"),
                       ("--chaos-seed=1", "2c"), ("--trace-out=x", "item 6"),
                       ("--mesh=1x2", "item 4")):
        with pytest.raises(SystemExit) as e:
            serve.main(["--reduced", "--device", "cpu", flag])
        assert e.value.code == 2
        assert item in capsys.readouterr().err
    for bad in (["--slots", "0"], ["--prompt-len", "5", "2"],
                ["--top-p", "0"], ["--arrival-gap", "-1"]):
        with pytest.raises(SystemExit):
            serve.main(["--reduced", "--device", "cpu", "--continuous", *bad])


def test_synthetic_workload_is_the_references():
    """The same prompts, budgets, arrivals and per-request seeds as the
    reference's ``synthetic_workload`` from the same seed."""
    from repro.launch import serve as ref_serve
    want = ref_serve.synthetic_workload(
        9, 500, gap=3, seed=4, prompt_lens=(5, 60), max_new=(2, 9),
        sampling=ref_serving.SamplingParams(temperature=0.5, seed=10))
    got = serve.synthetic_workload(
        9, 500, gap=3, seed=4, prompt_lens=(5, 60), max_new=(2, 9),
        sampling=serving.SamplingParams(temperature=0.5, seed=10))
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival, r.sampling.seed)
            for r in got] == \
        [(r.rid, r.prompt, r.max_new_tokens, r.arrival, r.sampling.seed)
         for r in want]
