"""The port's speculative decoding against the JAX reference's
``repro.serving.speculative`` and ``transformer.verify_*``, and against
its own plain decoding, on the CPU.

Against the reference: ``verify_accept``, the n-gram drafter (own history
and corpus), the adaptive controller and ``sample_tokens_block`` on the
same inputs and seeds; ``verify_forward`` with ``commit_verify_caches`` on
fresh and wrapping rows with rejections and an idle row (logits within the
tolerances of ``tests/test_torch_models.py``: ``1e-5`` of the largest
|logit| under f32 compute, ``2**-7`` with the int8 cache, ``6 * 2**-8``
under bf16; written K/V within the same share, int8 codes within one;
every slot not kept bitwise its pre-call bytes); and the engine's streams
and counters (``tests/_torch_engine_parity.py``). Within the port:
speculative streams equal plain ones, greedy and sampled, on a
sliding-window ring that wraps and on a ring run to full capacity, and
the rejected tokens' ring slots get their bytes back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_engine_parity as par
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro import serving as ref_serving
from repro.serving import sampling as ref_sampling
from repro_torch import serving
from repro_torch.interop import params_from_reference
from repro_torch.launch import step_fns
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import SubSpec
from repro_torch.serving import sampling

REP_PROMPT = (5, 9, 2, 5, 9, 2, 5, 9)
TOL = {"tiny": 6 * 2.0 ** -8, "minicpm_int8": 6 * 2.0 ** -8,
       "tiny_f32": 1e-5, "minicpm_int8_f32": 2.0 ** -7}


# ------------------------------------------------------------ host pieces

@pytest.mark.parametrize("T", [1, 2, 5])
def test_verify_accept_is_the_references(T):
    rng = np.random.default_rng(T)
    B = 64
    tokens = rng.integers(0, 4, (B, T)).astype(np.int32)
    pred = rng.integers(-1, 4, (B, T)).astype(np.int32)
    pred[::3, :-1] = tokens[::3, 1:]           # rows that accept everything
    n_draft = rng.integers(0, T, B).astype(np.int32)
    we, wa = ref_tf.verify_accept(jnp.asarray(pred), jnp.asarray(tokens),
                                  jnp.asarray(n_draft))
    ge, ga = tf.verify_accept(torch.from_numpy(pred), torch.from_numpy(tokens),
                              n_draft)
    assert np.array_equal(ge.numpy(), np.asarray(we))
    assert np.array_equal(ga.numpy(), np.asarray(wa))


def _history(rng, n, alphabet):
    return tuple(int(t) for t in rng.integers(1, alphabet, n))


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_proposes_the_references(seed):
    """Own-history lookups over short alphabets (many recurrences), with
    and without a shared corpus (a prefix trie holding other requests'
    boundaries), and the request's ``SpecParams.ngram`` override."""
    rng = np.random.default_rng(seed)
    tries = (serving.PrefixCache(grid=4, max_nodes=6),
             ref_serving.PrefixCache(grid=4, max_nodes=6))
    for _ in range(8):
        key = _history(rng, 4 * int(rng.integers(1, 4)), 6)
        for trie in tries:
            trie.insert(key, None)
    for i in range(60):
        prompt = _history(rng, int(rng.integers(1, 12)), int(
            rng.integers(3, 9)))
        gen = list(_history(rng, int(rng.integers(0, 6)), 6))
        ngram = int(rng.integers(1, 5))
        k = int(rng.integers(1, 6))
        corpus = i % 2
        got = serving.NgramDrafter(max_ngram=3,
                                   corpus=tries[0] if corpus else None)
        want = ref_serving.NgramDrafter(max_ngram=3,
                                        corpus=tries[1] if corpus else None)
        r1 = serving.Request(i, prompt, 4, spec=serving.SpecParams(
            ngram=ngram))
        r2 = ref_serving.Request(i, prompt, 4, spec=ref_serving.SpecParams(
            ngram=ngram))
        r1.tokens, r2.tokens = list(gen), list(gen)
        assert got.propose(0, r1, k) == want.propose(0, r2, k), (prompt, gen)
    assert tries[0].sequences() == tries[1].sequences()


def test_adaptive_controller_is_the_references():
    rng = np.random.default_rng(0)
    for _ in range(6):
        kw = dict(draft_k=int(rng.integers(1, 9)), ewma=float(
            rng.uniform(0.1, 1.0)), low=0.3, high=0.7,
            adapt=bool(rng.random() < 0.8))
        kw["min_k"] = int(rng.integers(1, kw["draft_k"] + 1))
        got = serving.AdaptiveDraftController(serving.SpecParams(**kw))
        want = ref_serving.AdaptiveDraftController(
            ref_serving.SpecParams(**kw))
        for _ in range(40):
            nd = int(rng.integers(0, kw["draft_k"] + 1))
            na = int(rng.integers(0, nd + 1))
            assert got.update(nd, na) == want.update(nd, na)
            assert got.snapshot() == want.snapshot()


@pytest.mark.parametrize("kind", ["greedy", "temperature", "top_k", "top_p"])
def test_sample_tokens_block_is_the_references(kind):
    """Position ``t`` of row ``b`` draws with ``fold_in(key_b, steps[b] +
    t)``: bitwise the reference's on greedy, temperature-only and top-k
    rows; top-p rows within ``tests/test_torch_sampling.py``'s rule."""
    import test_torch_sampling as ts
    rng = np.random.default_rng(len(kind))
    B, T, V = 12, 5, 257
    logits = (rng.standard_normal((B, T, V)) * 2.5).astype(np.float32)
    keys = ts._keys(rng, B)
    steps = rng.integers(0, 100, B).astype(np.int32)
    temperature = rng.uniform(0.3, 1.7, B).astype(np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    if kind == "greedy":
        temperature[:] = 0
    if kind == "top_k":
        top_k = rng.integers(1, 60, B).astype(np.int32)
    if kind == "top_p":
        top_p = rng.uniform(0.3, 0.99, B).astype(np.float32)
    want = np.asarray(jax.jit(ref_sampling.sample_tokens_block)(
        *(jnp.asarray(a) for a in (logits, keys, steps, temperature, top_k,
                                   top_p))))
    got = sampling.sample_tokens_block(torch.from_numpy(logits), keys, steps,
                                       temperature, top_k, top_p).numpy()
    assert got.shape == (B, T)
    rep = lambda a: np.repeat(a, T, axis=0)  # noqa: E731
    edge = ts._top_p_edge(logits.reshape(B * T, V), rep(temperature),
                          rep(top_k), rep(top_p)).reshape(B, T)
    if kind != "top_p":
        assert not edge.any()
    assert edge.sum() <= B * T // 10
    assert np.array_equal(got[~edge], want[~edge])
    # each position is the plain sampler's draw at its token index
    plain = sampling.sample_tokens(
        torch.from_numpy(logits[:, 2]), keys, steps + 2, temperature, top_k,
        top_p).numpy()
    assert np.array_equal(got[:, 2], plain)


# ------------------------------------------------- verify against the JAX

# rows: fresh (position 0), wrapping the ring of 16, idle, an already
# wrapped ring; drafts per row and the tokens each row keeps
VERIFY_CASE = dict(pos=[0, 13, 7, 30], n_draft=[2, 4, 3, 1],
                   active=[True, True, False, True], accept=[2, 3, 1, 1])


def _random_caches(jcfg, rng, B, S, pos):
    """Per-slot reference caches holding random K/V, rows at ``pos``."""
    caches = ref_tf.init_cache(jcfg, B, S, per_slot=True)
    out = []
    for c in caches:
        shape = c["k"].shape
        new = {"pos": jnp.broadcast_to(jnp.asarray(pos, jnp.int32),
                                       c["pos"].shape)}
        for name in ("k", "v"):
            x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
            if "ks" in c:
                new[name], new[name + "s"] = ref_layers.quantize_kv_rows(x)
            else:
                new[name] = x.astype(c[name].dtype)
        out.append(new)
    return tuple(out)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("name", list(par.CONFIGS))
def test_verify_forward_and_commit_match_the_reference(name):
    jcfg, cfg, jp, p = par.params(name)
    rng = np.random.default_rng(len(name))
    c = VERIFY_CASE
    B, T, S = 4, 5, 16
    jcaches = _random_caches(jcfg, rng, B, S, c["pos"])
    old = jax.tree.map(np.asarray, jcaches)
    tokens = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    n_draft = np.asarray(c["n_draft"], np.int32)
    lengths = n_draft + 1
    active = np.asarray(c["active"])
    accept = np.asarray(c["accept"], np.int32)
    jlogits, raw = jax.jit(ref_tf.verify_forward, static_argnums=1)(
        jp, jcfg, {"tokens": jnp.asarray(tokens)}, jcaches,
        jnp.asarray(lengths))
    jnew = jax.tree.map(np.asarray, ref_tf.commit_verify_caches(
        raw, jcaches, T, jnp.asarray(accept), jnp.asarray(active)))
    caches = params_from_reference(old, device="cpu")
    with torch.no_grad():
        logits, saved = tf.verify_forward(
            p, cfg, {"tokens": torch.from_numpy(tokens)}, caches,
            lengths=lengths, active=active)
        new = tf.commit_verify_caches(caches, saved, accept, active)
    tol = TOL[name]
    want = np.asarray(jlogits)
    got = logits.numpy()
    for b in np.flatnonzero(active):
        err = np.abs(got[b, :lengths[b]] - want[b, :lengths[b]]).max()
        assert err <= tol * np.abs(want[b, :lengths[b]]).max(), (b, err)
    for ci, (nc, jc, oc) in enumerate(zip(new, jnew, old)):
        assert np.array_equal(nc["pos"].numpy(), jc["pos"]), ci
        for leaf in ("k", "v", "ks", "vs"):
            if leaf not in oc:
                continue
            g = nc[leaf].to(torch.float32).numpy()
            g_raw = (nc[leaf].view(torch.int16) if nc[leaf].dtype ==
                     torch.bfloat16 else nc[leaf]).numpy()
            w, o = _bits(jc[leaf]), _bits(oc[leaf])
            for b in range(B):
                kept = [(c["pos"][b] + t) % S
                        for t in range(accept[b] if active[b] else 0)]
                rest = [s for s in range(S) if s not in kept]
                assert np.array_equal(g_raw[:, b, rest], o[:, b, rest]), \
                    (ci, leaf, b)
                assert np.array_equal(w[:, b, rest], o[:, b, rest])
                if not kept:
                    continue
                gv = np.asarray(g[:, b, kept], np.float32)
                wv = np.asarray(jc[leaf][:, b, kept], np.float32)
                step = 0.0
                if leaf in ("k", "v") and "ks" in oc:
                    # int8 codes: compare the values they stand for,
                    # within one code step beyond the tolerance
                    ws = jc[leaf + "s"][:, b, kept]
                    gv = gv * nc[leaf + "s"][:, b, kept].numpy()
                    wv = wv * ws
                    step = ws.max()
                assert np.abs(gv - wv).max() <= \
                    tol * max(np.abs(wv).max(), 1e-30) + step, (ci, leaf, b)


@pytest.mark.parametrize("name", list(par.CONFIGS))
def test_engine_with_speculation_matches_the_jax_engine(name):
    got, want = par.check_against_jax(name, spec=True)
    assert want["drafted_tokens"] > 0 and want["accepted_tokens"] > 0


# ------------------------------------------------------------ within the port

def _reqs(spec, *, max_new=12):
    return [serving.Request(0, REP_PROMPT, max_new_tokens=max_new, spec=spec),
            serving.Request(1, (7, 3, 7, 3, 7), max_new_tokens=max_new - 4,
                            arrival=1, spec=spec)]


@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
def test_spec_streams_equal_plain_and_take_fewer_ticks(name):
    _, eng = par.engine(name, n_slots=2, max_len=64)
    reqs = lambda spec: [serving.Request(  # noqa: E731
        i, REP_PROMPT, max_new_tokens=20, arrival=i, spec=spec)
        for i in range(3)]
    plain = eng.run(reqs(None))
    fast = eng.run(reqs(serving.SpecParams(draft_k=4)))
    stat = eng.run(_reqs(serving.SpecParams(draft_k=4)), static=True)
    assert fast["tokens"] == plain["tokens"]
    assert stat["tokens"] == eng.run(_reqs(None))["tokens"]
    assert fast["ticks"] < plain["ticks"]
    assert 0 < fast["accepted_tokens"] <= fast["drafted_tokens"]
    assert fast["verify_ticks"] > 0
    assert fast["drafted_tokens"] == sum(s.drafted_tokens
                                         for s in fast["steps"])
    assert np.isnan(plain["acceptance_rate"])


@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
def test_spec_sampled_streams_equal_plain(name):
    _, eng = par.engine(name, n_slots=2, max_len=48)
    sp = serving.SamplingParams(temperature=0.9, top_p=0.85, seed=11)
    mk = lambda spec: [serving.Request(0, REP_PROMPT, max_new_tokens=12,  # noqa
                                       sampling=sp, spec=spec),
                       serving.Request(1, (7, 3, 7, 3), max_new_tokens=9,
                                       sampling=sp, spec=spec, arrival=1)]
    plain = eng.run(mk(None))
    fast = eng.run(mk(serving.SpecParams(draft_k=4)))
    assert fast["tokens"] == plain["tokens"]
    assert fast["sampled_tokens"] == fast["total_tokens"]
    assert fast["drafted_tokens"] > 0


@pytest.mark.parametrize("sampled", [False, True])
def test_spec_swa_ring_wrap_rolls_back_clean(sampled):
    """40 tokens through a window of 12 (a ring of 12 + 4 slots) with
    drafts that mostly reject: the streams equal plain decoding."""
    jcfg, cfg, jp, p = par.params("tiny")
    import dataclasses
    swcfg = dataclasses.replace(cfg, name="spec-swa", pattern=(
        (SubSpec(kind="attn", sliding_window=12), "mlp"),))
    eng = serving.ServingEngine(swcfg, None, p, n_slots=2, max_len=64,
                                min_prefill_bucket=8, device="cpu")
    sp = serving.SamplingParams(temperature=0.9, top_p=0.85, seed=3) \
        if sampled else None
    mk = lambda spec: [serving.Request(0, (3, 7, 3, 7, 3, 7),  # noqa: E731
                                       max_new_tokens=40, spec=spec,
                                       sampling=sp)]
    plain = eng.run(mk(None))
    fast = eng.run(mk(serving.SpecParams(draft_k=4)))
    assert fast["tokens"] == plain["tokens"]
    assert fast["drafted_tokens"] > fast["accepted_tokens"]


def test_spec_full_ring_capacity_pad_writes_suppressed():
    """prompt + max_new == max_len: near the ring's end the verify call's
    pad columns would wrap over live prompt K/V if they wrote."""
    _, eng = par.engine("tiny", n_slots=2, max_len=24)
    prompt = tuple(int(t) for t in
                   np.random.default_rng(0).integers(1, 101, 8))
    plain = eng.run([serving.Request(0, prompt, max_new_tokens=16)])
    fast = eng.run([serving.Request(1, prompt, max_new_tokens=16,
                                    spec=serving.SpecParams(draft_k=4))])
    assert fast["tokens"][1] == plain["tokens"][0]
    assert fast["accepted_tokens"] > 0


def test_rejected_ring_slots_get_their_bytes_back():
    """Every verify call of a run with rejections: the int8 codes and
    scales of every slot but the accepted tokens' are bitwise their
    pre-call bytes, in every row."""
    _, eng = par.engine("minicpm_int8", n_slots=3, max_len=48,
                        prefill_chunk=8)
    seen = {"calls": 0, "rejected": 0}
    inner = eng._get_verify

    def checked(k):
        step = inner(k)

        def call(params, tokens, caches, active, n_draft, sampling=None):
            before = [{n: v.clone() for n, v in c.items()} for c in caches]
            out, acc, new = step(params, tokens, caches, active, n_draft,
                                 sampling)
            seen["calls"] += 1
            for c, old in zip(new, before):
                S = c["k"].shape[2]
                for b in range(c["k"].shape[1]):
                    n = int(acc[b]) if active[b] else 0
                    seen["rejected"] += (active[b]
                                         and n < int(n_draft[b]) + 1)
                    kept = [(int(old["pos"][0, b]) + t) % S
                            for t in range(n)]
                    rest = [s for s in range(S) if s not in kept]
                    for leaf in ("k", "v", "ks", "vs"):
                        assert torch.equal(c[leaf][:, b, rest],
                                           old[leaf][:, b, rest])
                    assert torch.equal(c["pos"][:, b],
                                       old["pos"][:, b] + n)
            return out, acc, new
        return call

    eng._get_verify = checked
    spec = serving.SpecParams(draft_k=4)
    reqs = [serving.Request(i, REP_PROMPT + (i,), max_new_tokens=14,
                            arrival=i, spec=spec) for i in range(4)]
    eng.run(reqs)
    assert seen["calls"] > 0 and seen["rejected"] > 0


def test_draft_model_that_is_the_target_accepts_every_draft():
    _, cfg, _, p = par.params("tiny")
    drafter = serving.DraftModelDrafter(cfg, p, n_slots=2, max_len=48,
                                        device="cpu")
    _, eng = par.engine("tiny", n_slots=2, max_len=48, drafter=drafter)
    spec = serving.SpecParams(draft_k=4)
    fast = eng.run([serving.Request(0, (5, 9, 2, 17), 12, spec=spec),
                    serving.Request(1, (7, 3), 6, arrival=1, spec=spec)])
    _, plain_eng = par.engine("tiny", n_slots=2, max_len=48)
    plain = plain_eng.run([serving.Request(0, (5, 9, 2, 17), 12),
                           serving.Request(1, (7, 3), 6, arrival=1)])
    assert fast["tokens"] == plain["tokens"]
    assert fast["accepted_tokens"] == fast["drafted_tokens"] > 0
    assert fast["ticks"] < plain["ticks"]
    # the drafter's slot, reused: its caches held only committed tokens
    again = eng.run([serving.Request(2, (5, 9, 2, 17), 12, spec=spec)])
    assert again["tokens"][2] == plain["tokens"][0]


@pytest.mark.parametrize("name", ["tiny", "minicpm_int8"])
def test_spec_sampled_accepted_drafts_equal_plain(name):
    """Sampled speculation that accepts drafts (the draft model is the
    target, sampling near its argmax): the tokens a verify tick commits at
    positions t >= 1, drawn with the keys of steps ``step + t``, are the
    plain sampled stream's."""
    _, cfg, _, p = par.params(name)
    drafter = serving.DraftModelDrafter(cfg, p, n_slots=2, max_len=48,
                                        device="cpu")
    _, eng = par.engine(name, n_slots=2, max_len=48, drafter=drafter)
    _, plain_eng = par.engine(name, n_slots=2, max_len=48)
    sp = serving.SamplingParams(temperature=0.5, top_k=3, seed=11)
    mk = lambda spec: [serving.Request(0, (5, 9, 2, 17),  # noqa: E731
                                       max_new_tokens=14, sampling=sp,
                                       spec=spec),
                       serving.Request(1, (7, 3), max_new_tokens=9,
                                       sampling=sp, spec=spec, arrival=1)]
    plain = plain_eng.run(mk(None))
    fast = eng.run(mk(serving.SpecParams(draft_k=4)))
    assert fast["tokens"] == plain["tokens"]
    assert fast["sampled_tokens"] == fast["total_tokens"]
    assert fast["accepted_tokens"] > 0


def test_spec_slot_reuse_leaves_no_residue():
    _, eng = par.engine("minicpm_int8", n_slots=1, max_len=48)
    spec = serving.SpecParams(draft_k=3)
    report = eng.run([serving.Request(0, REP_PROMPT, 8, spec=spec),
                      serving.Request(1, (23, 2, 5, 8), 5, spec=spec)])
    fresh = eng.run([serving.Request(2, (23, 2, 5, 8), 5, spec=spec)])
    assert report["tokens"][1] == fresh["tokens"][2]


def test_speculation_gates():
    import dataclasses
    _, cfg, _, p = par.params("tiny")
    swcfg = dataclasses.replace(cfg, name="spec-swa", pattern=(
        (SubSpec(kind="attn", sliding_window=12), "mlp"),))
    eng = serving.ServingEngine(swcfg, None, p, n_slots=2, max_len=64,
                                draft_headroom=2, device="cpu")
    with pytest.raises(ValueError, match="draft_headroom"):
        eng.run([serving.Request(0, (3, 7), 4,
                                 spec=serving.SpecParams(draft_k=4))])
    assert eng.run([serving.Request(0, (3, 7), 4, spec=serving.SpecParams(
        draft_k=2))])["requests"] == 1
    with pytest.raises(ValueError, match="ring slack"):
        step_fns.make_verify_step(swcfg, None, 4, ring_slack=2)
    from repro_torch.configs.base import get_config
    from repro.configs.base import get_config as ref_get_config
    for arch in ("minicpm_2b", "rwkv6_7b", "jamba_v0_1_52b", "qwen2_vl_7b",
                 "seamless_m4t_large_v2"):
        assert tf.supports_speculation(get_config(arch, reduced=True)) == \
            ref_tf.supports_speculation(ref_get_config(arch, reduced=True))
    assert tf.supports_speculation(cfg)
    with pytest.raises(ValueError, match="draft_k"):
        serving.SpecParams(draft_k=serving.MAX_DRAFT_K + 1)


def test_ring_written_slots_is_the_references_restore_mask():
    rng = np.random.default_rng(0)
    for S, T in ((8, 5), (16, 1), (5, 5)):
        pos = rng.integers(0, 3 * S, (2, 6)).astype(np.int32)
        accept = rng.integers(1, T + 1, 6).astype(np.int32)
        want = np.asarray(ref_layers.ring_restore_mask(
            jnp.asarray(pos), S, T, jnp.asarray(accept)))
        rows, ts, slots = layers.ring_written_slots(torch.from_numpy(pos), S,
                                                    [T] * 6)
        got = np.zeros_like(want)
        back = (ts >= torch.from_numpy(accept).long()[rows]).numpy()
        for per in range(2):
            got[per, rows.numpy()[back], slots[per].numpy()[back]] = True
        assert np.array_equal(got, want)
