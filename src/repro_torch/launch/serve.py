"""Serving driver: the continuous-batching engine or the fixed-batch
greedy decode loop (the port of ``repro.launch.serve``), on one device
(CUDA unless ``--device`` names another).

Continuous batching: a staggered-arrival synthetic workload through the
slot scheduler, prefill chunks interleaved with in-flight decode, per-tick
stats summed with the b=1 reducer, greedy or seeded sampling:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --continuous --requests 6 --slots 3 --prompt-len 20 80 \\
      --prefill-chunk 16 --device cpu

Speculative decoding (n-gram self-drafting, or ``--draft-model`` with a
second reduced model), the prefix cache over a shared system prompt, and
the SLO policy with priorities and deadlines:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --continuous --speculate --prefix-cache --shared-prefix 16 \\
      --policy slo --priority interactive --deadline-ticks 8 \\
      --requests 6 --slots 3 --device cpu

Chaos mode serves the same workload across a replica fleet under a
seeded fault plan (replica kills, heartbeat flaps, stragglers, poisoned
logits) and checks that the merged streams are the undisturbed run's, bit
for bit; ``--trace-out`` writes the run's events (Chrome trace or JSONL),
``--metrics-every`` prints live TTFT and latency percentiles and
``--probe`` the collective probe's fit (these three work on
``--continuous`` too):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --chaos-seed 7 --replicas 3 --heartbeat-timeout 2 \\
      --heartbeat-misses 2 --trace-out build/chaos.json --probe --device cpu

The fixed-batch loop: every row decodes in lockstep from an empty cache,
starting from token 0, with greedy argmax:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm_2b \\
      --reduced --device cpu

RWKV-6 (recurrent state, no attention: ``--cache-len`` only bounds a
prefill call) runs both ways:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b \\
      --reduced --continuous --speculate --prefix-cache --shared-prefix 16 \\
      --prefill-chunk 8 --requests 6 --slots 3 --device cpu

Jamba-v0.1 (Mamba carries beside one attention ring a period, MoE on the
odd layers) too:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b \\
      --reduced --continuous --speculate --prefix-cache --shared-prefix 16 \\
      --prefill-chunk 8 --requests 6 --slots 3 --device cpu

The config is the one the reference decodes with (``decode_config``):
bf16 parameters, and the int8 K/V cache where ``n_kv_heads * head_dim >=
2048`` (MiniCPM-2B at full width). Under bf16 compute, bf16 parameters give
the same numbers as the f32 ones the reference stores, since every weight
is cast to bf16 before use. The reference's ``--mesh`` (data and tensor
parallelism over several devices) is a later slice and is refused with
the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import decode_config, get_config, get_parallel
from repro_torch.core import autotune
from repro_torch.core.transport import resolve_device
from repro_torch.launch import step_fns
from repro_torch.models import transformer as tf
from repro_torch.serving.speculative import MAX_DRAFT_K

__all__ = ["ServeRun", "serve_loop", "synthetic_workload",
           "serve_continuous", "serve_chaos", "main"]

# the reference's other flags -> the ROADMAP item that ports them
UNPORTED_FLAGS = {
    "--mesh": "ROADMAP.md queue 1, 'Next' item 4 (the dist transport)",
}


@dataclasses.dataclass
class ServeRun:
    """What :func:`serve_loop` decoded: ``tokens`` (B, steps), the wall
    time of each step (host clock, each step ending in the copy of its
    tokens to the host, as the reference's loop does), and, when asked for,
    every step's logits (steps, B, V) f32 on the device."""
    tokens: np.ndarray
    step_seconds: list
    logits: torch.Tensor | None = None

    @property
    def seconds(self) -> float:
        return float(sum(self.step_seconds))


def serve_loop(args, cfg: tf.ModelConfig | None = None, params=None, *,
               keep_logits: bool = False, first_tokens=None) -> ServeRun:
    """Greedy fixed-batch decode: ``args.batch`` rows, ``args.steps`` steps,
    a ring cache of ``args.cache_len``. ``cfg`` defaults to
    ``decode_config`` of ``args.arch``; ``params`` default to
    ``init_params(cfg, args.seed)``; ``first_tokens`` ((batch,) integers)
    are the rows' first inputs, token 0 where None."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = decode_config(get_config(args.arch, reduced=args.reduced))
    step = step_fns.make_serve_step(cfg, get_parallel(args.arch))
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    caches = tf.init_cache(cfg, args.batch, args.cache_len, device=dev)
    inputs = {"tokens": torch.zeros((args.batch, 1), dtype=torch.int64,
                                    device=dev)}
    if first_tokens is not None:
        inputs["tokens"][:, 0] = torch.as_tensor(first_tokens).to(dev)

    tokens_out, step_seconds, logits_out = [], [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        logits, caches = step(params, inputs, caches)
        nxt = torch.argmax(logits, dim=-1)
        tokens_out.append(nxt.cpu())
        step_seconds.append(time.perf_counter() - t0)
        if keep_logits:
            logits_out.append(logits)
        inputs = {"tokens": nxt[:, None]}
    run = ServeRun(torch.stack(tokens_out, 1).numpy(), step_seconds,
                   torch.stack(logits_out) if keep_logits else None)
    toks = args.batch * args.steps
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"decoded {toks} tokens in {run.seconds:.2f}s "
          f"({toks / run.seconds:.1f} tok/s on {where})")
    # argmax over (B, V) logits must yield in-vocabulary token ids
    if not ((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all():
        raise RuntimeError("decode produced out-of-vocabulary token ids")
    return run


def synthetic_workload(n: int, vocab: int, *, gap: int = 2, seed: int = 0,
                       prompt_lens=(3, 12), max_new=(4, 24),
                       sampling=None, spec=None, repetitive=False,
                       slo=None, shared_prefix: int = 0) -> list:
    """The reference's deterministic staggered-arrival request stream:
    ``n`` requests, request ``i`` arriving at tick ``i * gap`` with a prompt
    of a length drawn from ``prompt_lens`` and ``max_new_tokens`` from
    ``max_new`` (both inclusive), from numpy's generator seeded with
    ``seed``. Prompt tokens are i.i.d. in ``[1, vocab)``, or with
    ``repetitive=True`` a cycle over a per-request alphabet of 2 to 4
    tokens (text the n-gram drafter can draft from). ``shared_prefix``
    prepends one common system prompt of that many tokens to every
    request (what the prefix cache reuses). ``sampling`` is a base
    :class:`~repro_torch.serving.sampling.SamplingParams` or None (greedy);
    request ``i`` gets seed ``sampling.seed + i``. ``spec`` (a
    :class:`~repro_torch.serving.speculative.SpecParams`) and ``slo`` (an
    :class:`~repro_torch.serving.slo.SLOParams`) go to every request."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    common = tuple(int(t) for t in rng.integers(1, vocab, shared_prefix)) \
        if shared_prefix else ()

    def prompt(plen):
        if not repetitive:
            return common + tuple(int(t) for t in rng.integers(1, vocab,
                                                               plen))
        period = rng.integers(1, vocab, int(rng.integers(2, 5)))
        return common + tuple(int(period[j % len(period)])
                              for j in range(plen))

    return [
        Request(i,
                prompt(int(rng.integers(prompt_lens[0],
                                        prompt_lens[1] + 1))),
                max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
                arrival=i * gap,
                sampling=(None if sampling is None else
                          dataclasses.replace(sampling,
                                              seed=sampling.seed + i)),
                spec=spec, slo=slo)
        for i in range(n)
    ]


def _obs_build(args):
    """Observability sinks from the CLI flags: ``(tracer, metrics_kwargs)``.
    One Tracer serves the whole run (continuous or chaos); metrics attach
    only when ``--metrics-every`` asks for live snapshots."""
    from repro_torch.obs import StreamingMetrics, Tracer
    tracer = Tracer() if args.trace_out else None
    kwargs = {}
    if args.metrics_every > 0:
        kwargs["metrics"] = StreamingMetrics()
        kwargs["metrics_every"] = args.metrics_every
        kwargs["metrics_sink"] = (
            lambda tick, s: print(
                f"[metrics t={tick}] "
                f"ttft p50/p99 {s['ttft_ticks_p50']:.0f}/"
                f"{s['ttft_ticks_p99']:.0f} ticks "
                f"({s['ttft_n']:.0f} obs), "
                f"latency p50/p99 {s['latency_ticks_p50']:.0f}/"
                f"{s['latency_ticks_p99']:.0f} ticks "
                f"({s['latency_n']:.0f} obs)"))
    return tracer, kwargs


def _obs_finish(args, tracer, probe=None):
    """Write the trace file(s) and print the probe's fit and residual
    summary."""
    if probe is not None and len(probe):
        from repro_torch.obs import fit_alpha_beta, residual_report
        timed = probe.timed()
        print(f"[probe] {probe.n_seen} samples "
              f"({len(timed)} timed, {len(probe.traced())} trace-time)")
        rows = residual_report(timed, probe.model)
        if rows:
            worst = max(rows, key=lambda r: r["rel_err"])
            print(f"[probe] vs {probe.model.name}: worst residual "
                  f"{worst['rel_err']:.1%} at p={worst['p']} "
                  f"{worst['nbytes']}B ({worst['method']})")
        try:
            fr = fit_alpha_beta(timed)
            print(f"[probe] fitted alpha={fr.alpha:.3e}s "
                  f"beta={fr.beta:.3e}s/B over {fr.n_samples} samples "
                  f"(max rel err {fr.max_rel_err:.1%})")
        except ValueError as e:
            print(f"[probe] no fit: {e}")
        if tracer is not None:
            from repro_torch.obs import export_residuals
            export_residuals(tracer, timed, model=probe.model)
    if tracer is not None:
        path = args.trace_out
        if args.trace_format in ("chrome", "both"):
            tracer.to_chrome(path)
            dropped = (f", {tracer.dropped} dropped" if tracer.dropped
                       else "")
            print(f"[trace] {len(tracer)} events -> {path} "
                  f"(chrome://tracing / Perfetto{dropped})")
        if args.trace_format in ("jsonl", "both"):
            jl = path if args.trace_format == "jsonl" else path + ".jsonl"
            n = tracer.to_jsonl(jl)
            print(f"[trace] {n} events -> {jl} (jsonl)")


def _probed(args, fn):
    """``fn()`` under a fresh installed probe when ``--probe`` asks for one;
    returns ``(result, probe or None)``."""
    if not args.probe:
        return fn(), None
    from repro_torch.obs import CollectiveProbe, install, uninstall
    probe = install(CollectiveProbe())
    try:
        return fn(), probe
    finally:
        uninstall()


def serve_continuous(args, cfg: tf.ModelConfig | None = None,
                     params=None) -> dict:
    """Drive the continuous-batching engine on a synthetic workload:
    ``args.requests`` requests into ``args.slots`` slots of a
    ``args.cache_len`` ring, the reference's workload from seed
    ``args.seed + 1``, with the speculation, SLO and prefix-cache flags.
    ``cfg`` defaults to ``decode_config`` of ``args.arch``, ``params`` to
    ``init_params(cfg, args.seed)``; a ``--draft-model`` is the reduced
    arch's ``decode_config`` with weights from ``args.seed + 7``. With
    ``--trace-out``, ``--metrics-every`` or ``--probe`` the run is traced,
    reports live percentiles or is probed. Prints the report line and
    returns the report."""
    from repro_torch.serving import (DraftModelDrafter, PriorityClass,
                                     SamplingParams, ServingEngine,
                                     SLOParams, SpecParams, make_policy,
                                     make_stats_reducer)
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = decode_config(get_config(args.arch, reduced=args.reduced))
    if params is None:
        params = tf.init_params(cfg, args.seed, dev)
    drafter = None
    if args.draft_model:
        dcfg = decode_config(get_config(args.draft_model, reduced=True))
        if dcfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"--draft-model {args.draft_model}: vocab "
                f"{dcfg.vocab_size} != target vocab {cfg.vocab_size}")
        drafter = DraftModelDrafter(
            dcfg, tf.init_params(dcfg, args.seed + 7, dev),
            get_parallel(args.draft_model), n_slots=args.slots,
            max_len=args.cache_len, device=dev)
    tracer, obs_kwargs = _obs_build(args)
    engine = ServingEngine(cfg, get_parallel(args.arch), params,
                           n_slots=args.slots, max_len=args.cache_len,
                           prefill_chunk=args.prefill_chunk,
                           stats_reducer=make_stats_reducer(),
                           drafter=drafter, prefix_cache=args.prefix_cache,
                           prefix_cache_nodes=(args.prefix_cache_nodes
                                               or 256), device=dev,
                           tracer=tracer, **obs_kwargs)
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed)
    spec = None
    if args.speculate or args.draft_model:
        spec = SpecParams(draft_k=args.draft_k)
    slo = None
    if args.priority is not None or args.deadline_ticks is not None:
        slo = SLOParams(
            priority=PriorityClass[(args.priority or "batch").upper()],
            deadline_ticks=args.deadline_ticks)
    reqs = synthetic_workload(args.requests, cfg.vocab_size,
                              gap=args.arrival_gap, seed=args.seed + 1,
                              prompt_lens=tuple(args.prompt_len),
                              sampling=sampling, spec=spec,
                              repetitive=spec is not None
                              and not args.draft_model,
                              slo=slo, shared_prefix=args.shared_prefix)
    policy = make_policy(args.policy) if args.policy != "fifo" else None
    report, probe = _probed(args, lambda: engine.run(
        reqs, static=args.static, policy=policy))
    _obs_finish(args, tracer, probe)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    spec_note = (f", {report['accepted_tokens']}/"
                 f"{report['drafted_tokens']} drafts accepted"
                 if report["drafted_tokens"] else "")
    slo_note = (f", {report['preemptions']} preemptions, "
                f"{report['shed_requests']} shed, "
                f"{report['deadline_misses']} deadline misses"
                if report["policy"] != "fifo" else "")
    prefix_note = ""
    if "prefix_cache" in report:
        pc = report["prefix_cache"]
        prefix_note = (f", prefix cache: {report['prefix_hits']} hits / "
                       f"{report['prefix_tokens_reused']} tokens reused, "
                       f"{pc['nodes']} nodes ({pc['evictions']} evicted)")
    print(f"[{report['mode']}/{report['policy']}] "
          f"{report['requests']} requests, "
          f"{report['total_tokens']} tokens "
          f"({report['sampled_tokens']} sampled, "
          f"{report['prefill_chunks']} prefill chunks{spec_note}) "
          f"in {report['wall_s']:.2f}s "
          f"({report['tok_s']:.1f} tok/s on {where}, {report['ticks']} "
          f"ticks, ttft p50 {report['ttft_ticks_p50']:.1f} ticks, "
          f"latency p95 {report['latency_ticks_p95']:.1f} ticks"
          f"{slo_note}{prefix_note})")
    return report


def serve_chaos(args) -> dict:
    """Serve the synthetic workload across ``args.replicas`` engine sessions
    under the fault plan seeded by ``args.chaos_seed`` and check that no
    stream parts from the undisturbed single-engine run (raises
    ``SystemExit`` if one does); the model as in :func:`serve_continuous`.
    The tracer and the live metrics attach after the undisturbed run, so
    they cover the chaos run only. Prints the fault plan and the fleet's
    counts and returns the fleet's report."""
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.serving import (FleetRunner, SamplingParams,
                                     ServingEngine, make_stats_reducer)
    dev = resolve_device(args.device)
    cfg = decode_config(get_config(args.arch, reduced=args.reduced))
    engine = ServingEngine(cfg, get_parallel(args.arch),
                           tf.init_params(cfg, args.seed, dev),
                           n_slots=args.slots, max_len=args.cache_len,
                           prefill_chunk=args.prefill_chunk,
                           stats_reducer=make_stats_reducer(), device=dev)
    sampling = None
    if args.temperature > 0:
        sampling = SamplingParams(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed)

    def workload():
        return synthetic_workload(args.requests, cfg.vocab_size,
                                  gap=args.arrival_gap, seed=args.seed + 1,
                                  prompt_lens=tuple(args.prompt_len),
                                  sampling=sampling)

    base = engine.run(workload())
    tracer, obs_kwargs = _obs_build(args)
    engine.tracer = tracer
    engine.metrics = obs_kwargs.get("metrics")
    engine.metrics_every = obs_kwargs.get("metrics_every", 0)
    engine.metrics_sink = obs_kwargs.get("metrics_sink")
    plan = FaultPlan.seeded(args.chaos_seed, n_replicas=args.replicas,
                            horizon=max(2, base["ticks"]))
    runner = FleetRunner(engine, args.replicas, plan=plan,
                         timeout_s=args.heartbeat_timeout,
                         misses=args.heartbeat_misses,
                         rejoin_backoff_s=args.rejoin_backoff)
    report, probe = _probed(args, lambda: runner.run(workload()))
    _obs_finish(args, tracer, probe)
    diverged = sum(report["tokens"][rid] != base["tokens"][rid]
                   for rid in base["tokens"])
    faults = ", ".join(f"t{f.tick}:{f.kind}@r{f.replica}" for f in plan) \
        or "none"
    print(f"[chaos seed={args.chaos_seed}] faults: {faults}")
    print(f"[chaos] {report['requests']} requests over "
          f"{report['n_replicas']} replicas: {report['failovers']} "
          f"failovers, {report['quarantines']} quarantines, "
          f"{report['rejoins']} rejoins, {report['resumed_tokens']} "
          f"resumed tokens, recovery {report['recovery_ticks']} ticks, "
          f"{diverged} diverged streams (want 0)")
    if diverged:
        raise SystemExit(f"chaos run diverged on {diverged} streams")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Continuous-batching or fixed-batch decode with the "
                    "PyTorch port.")
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--continuous", action="store_true",
                    help="run the continuous-batching engine on a "
                         "staggered-arrival synthetic workload")
    ap.add_argument("--static", action="store_true",
                    help="run the engine's batch-synchronous reference "
                         "policy on the synthetic workload (the same steps; "
                         "implies --continuous)")
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous mode: number of synthetic requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous mode: K/V-cache slots (concurrency)")
    ap.add_argument("--arrival-gap", type=int, default=2,
                    help="continuous mode: ticks between request arrivals")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(3, 12),
                    metavar=("MIN", "MAX"),
                    help="continuous mode: synthetic prompt length range "
                         "(prompts longer than --prefill-chunk stream in a "
                         "chunk a tick)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous mode: max prompt tokens per prefill "
                         "call (default: the largest single call the cache "
                         "geometry allows)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="continuous mode: sampling temperature (0 = greedy, "
                         "the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="continuous mode: top-k filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="continuous mode: nucleus (top-p) filter (1 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="continuous mode: base sampler seed (request i uses "
                         "seed + i; streams reproduce run to run)")
    ap.add_argument("--speculate", action="store_true",
                    help="continuous mode: speculative decoding with the "
                         "prompt-lookup (n-gram) self-drafter: several "
                         "tokens a tick, the same streams")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="continuous mode: max draft tokens per verify "
                         "tick (1..MAX_DRAFT_K)")
    ap.add_argument("--draft-model", default=None,
                    help="continuous mode: draft with this REDUCED arch as "
                         "the draft model instead of prompt lookup "
                         "(implies --speculate; vocab must match)")
    ap.add_argument("--policy", choices=("fifo", "slo"), default="fifo",
                    help="continuous mode: scheduling policy, 'fifo' (the "
                         "reference) or 'slo' (priority classes, aging, "
                         "deadline shedding, exact-resume preemption; "
                         "implies --continuous)")
    ap.add_argument("--priority", default=None,
                    choices=("interactive", "batch", "best_effort"),
                    help="continuous mode: priority class every synthetic "
                         "request carries (default: no SLO metadata)")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="continuous mode: TTFT deadline in ticks after "
                         "each request's arrival (>= 1; misses are counted "
                         "in telemetry)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous mode: cross-request prefix caching; "
                         "admissions sharing a cached prompt prefix adopt "
                         "its slot row and prefill only from the first "
                         "divergent chunk, with the same streams (implies "
                         "--continuous)")
    ap.add_argument("--prefix-cache-nodes", type=int, default=None,
                    help="prefix cache: max cached boundary rows before "
                         "LRU eviction (>= 1; default 256; requires "
                         "--prefix-cache)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common N-token system prompt to "
                         "every synthetic request (>= 0; the workload "
                         "shape --prefix-cache accelerates)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="per-deployment autotune cache file; overrides "
                         "REPRO_TORCH_AUTOTUNE_CACHE and the default (what "
                         "the b=1 stats reduction's method='auto' consults)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a structured trace of the run (admissions, "
                         "prefill chunks, commits, preemptions, failovers, "
                         "...) to PATH; tracing is pure observation, the "
                         "streams are the same with it on or off (implies "
                         "--continuous)")
    ap.add_argument("--trace-format", choices=("chrome", "jsonl", "both"),
                    default="chrome",
                    help="--trace-out format: 'chrome' (chrome://tracing / "
                         "Perfetto JSON, the default), 'jsonl' (one event "
                         "a line), or 'both' (chrome at PATH, jsonl at "
                         "PATH.jsonl)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print live fleet-wide TTFT/latency percentiles "
                         "every N ticks: fixed-bucket histograms riding the "
                         "same b=1 stats reduction as the counters (0 = "
                         "off; implies --continuous)")
    ap.add_argument("--probe", action="store_true",
                    help="record (p, nbytes, method, blocks) -> wall-time "
                         "samples from every collective in the run and "
                         "print the alpha-beta fit and the predicted-vs-"
                         "measured residuals (implies --continuous)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="serve the workload across --replicas engines "
                         "under the seeded fault plan (kills, flaps, "
                         "stragglers, poisoned logits) and check that no "
                         "stream parts from the undisturbed run")
    ap.add_argument("--replicas", type=int, default=3,
                    help="chaos mode: fleet size (>= 2)")
    ap.add_argument("--heartbeat-timeout", type=float, default=2.0,
                    help="chaos mode: heartbeat deadline in ticks (the "
                         "fleet simulation's virtual clock)")
    ap.add_argument("--heartbeat-misses", type=int, default=1,
                    help="chaos mode: missed deadlines before a SUSPECT "
                         "replica is declared dead (flap tolerance)")
    ap.add_argument("--rejoin-backoff", type=float, default=1.0,
                    help="chaos mode: base rejoin probation in ticks "
                         "(doubles per drop)")
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            ap.error(f"{flag} is not ported yet: {UNPORTED_FLAGS[flag]}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    _validate_args(ap, args)
    if args.autotune_cache:
        autotune.set_cache_path(args.autotune_cache)
    if args.chaos_seed is not None:
        return serve_chaos(args)
    if args.continuous or args.static or args.speculate or args.draft_model \
            or args.policy != "fifo" or args.priority is not None \
            or args.deadline_ticks is not None or args.prefix_cache \
            or args.trace_out is not None or args.metrics_every > 0 \
            or args.probe:
        return serve_continuous(args)
    return serve_loop(args)


def _validate_args(ap, args) -> None:
    """Reject bad flag values before any model work (the reference's checks
    of the flags this slice ports)."""
    for name in ("batch", "cache_len", "steps", "requests", "slots"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, name)}")
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        ap.error(f"--prefill-chunk must be >= 1, got {args.prefill_chunk}")
    if args.arrival_gap < 0:
        ap.error(f"--arrival-gap must be >= 0, got {args.arrival_gap}")
    lo, hi = args.prompt_len
    if lo < 1 or hi < lo:
        ap.error(f"--prompt-len needs 1 <= MIN <= MAX, got {lo} {hi}")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    if args.top_k < 0:
        ap.error(f"--top-k must be >= 0, got {args.top_k}")
    if not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p must be in (0, 1], got {args.top_p}")
    if not 1 <= args.draft_k <= MAX_DRAFT_K:
        ap.error(f"--draft-k must be in [1, {MAX_DRAFT_K}], "
                 f"got {args.draft_k}")
    if args.deadline_ticks is not None and args.deadline_ticks < 1:
        ap.error(f"--deadline-ticks must be >= 1, got {args.deadline_ticks}")
    if args.prefix_cache_nodes is not None:
        if not args.prefix_cache:
            ap.error("--prefix-cache-nodes requires --prefix-cache "
                     "(the node bound configures the prefix trie)")
        if args.prefix_cache_nodes < 1:
            ap.error(f"--prefix-cache-nodes must be >= 1, "
                     f"got {args.prefix_cache_nodes}")
    if args.shared_prefix < 0:
        ap.error(f"--shared-prefix must be >= 0, got {args.shared_prefix}")
    if args.heartbeat_timeout <= 0:
        ap.error(f"--heartbeat-timeout must be > 0, "
                 f"got {args.heartbeat_timeout}")
    if args.heartbeat_misses < 1:
        ap.error(f"--heartbeat-misses must be >= 1, "
                 f"got {args.heartbeat_misses}")
    if args.rejoin_backoff < 0:
        ap.error(f"--rejoin-backoff must be >= 0, got {args.rejoin_backoff}")
    if args.metrics_every < 0:
        ap.error(f"--metrics-every must be >= 0, got {args.metrics_every}")
    if args.trace_out is None and args.trace_format != "chrome":
        ap.error("--trace-format requires --trace-out (there is no trace "
                 "file to format without it)")
    if args.prefix_cache and args.chaos_seed is not None:
        ap.error("--prefix-cache is incompatible with --chaos-seed: the "
                 "trie is per-session state and the chaos baseline/fleet "
                 "comparison assumes identical tick accounting")
    if args.policy != "fifo":
        if args.static:
            ap.error("--policy slo is incompatible with --static: static "
                     "batching IS the batch-synchronous FIFO reference")
        if args.chaos_seed is not None:
            ap.error("--policy slo is incompatible with --chaos-seed: the "
                     "fleet's exact-resume accounting assumes FIFO "
                     "(shedding would strand the run-to-completion loop)")
    if args.chaos_seed is not None:
        if args.replicas < 2:
            ap.error(f"--chaos-seed needs --replicas >= 2, "
                     f"got {args.replicas}")
        if args.speculate or args.draft_model:
            ap.error("--chaos-seed is incompatible with --speculate/"
                     "--draft-model: the drafter slot table is engine-"
                     "global, and the fleet runs one session per replica")
        if args.static:
            ap.error("--chaos-seed is incompatible with --static "
                     "(the fleet is continuous-batching only)")


if __name__ == "__main__":
    main()
