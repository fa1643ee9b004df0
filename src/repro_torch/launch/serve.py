"""Serving CLI: synthetic offered load through the serving engine.

Counterpart of ``repro/launch/serve.py`` with the same flags and messages,
running on the CUDA device (it raises where there is none).  Default path
is the continuous-batching engine (slot admission, per-slot KV
accounting); every request's latency decomposition — queue wait, TTFT,
prefill, per-token decode — is printed per request, with a throughput
summary at the end.  ``--static`` routes the same workload through the
run-to-completion reference engine instead (``serve/engine.py``; no
per-stage stamps there; it reports tokens and wall time only), with every
refusal the reference makes for it.

``--tp-size N`` makes the continuous engine tensor-parallel over N rank
processes (``--devices N`` gives the run N ranks; in the reference it
fabricates N host devices): rank 0 runs the engine's host loop and
prints, every other rank runs the same cells on its shards
(``serve/ranks.py``), exchanging over gloo — through pinned host memory
on a card, as ranks on one card must.  ``--tp-size`` above ``--devices``,
and ``--static`` with ``--tp-size > 1``, are refused as the reference
refuses them.  Every arch the engines take serves over the ranks — the
dense, MoE (experts split over the ranks), RWKV-6 and hybrid ones
(``models/transformer.py``); a width the axis does not split (heads,
experts, ``d_ff``, Mamba's ``d_inner``) is refused up front.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --requests 8 --rate 20 --max-new 16 --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --static --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \
        --tp-size 4 --devices 4
    PYTHONPATH=src python -m repro_torch.launch.serve --fabric straggler
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --tp-size 2 --devices 2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-3-4b --prompt-lens 8,24 --max-new 16

``--arch`` takes every arch the engines serve, each smoke-reduced: the
dense archs (``olmo-1b``, ``h2o-danube-3-4b``, ``mistral-nemo-12b``,
``command-r-plus-104b``), the MoE archs (``moonshot-v1-16b-a3b``,
``qwen3-moe-235b-a22b``), RWKV-6 (``rwkv6-7b``) and the hybrid
``jamba-1.5-large-398b``.  RWKV-6, Jamba and the sliding-window
H2O-Danube3 keep the dense path: ``--paged`` with any of them is refused
by the engine with the reference's error ("paged KV serving needs an
all-attention, non-windowed arch"); a windowed arch's slot cache is its
ring of ``window`` positions whatever ``--cache-len`` is.  An RWKV prompt
longer than 64 tokens must be a multiple of 64, a Jamba prompt longer
than 256 a multiple of 256 (the chunked scans' contracts).  The engines
pass only tokens, as the reference's do, so ``whisper-base`` (which needs
frames) and ``internvl2-26b`` (patches) are refused up front with an
error that says so.

``--rate 0`` (the default) submits everything as one burst; a positive
rate drives evenly spaced arrivals at that many requests per second —
the load-generator behind the ``serve.load_sweep`` experiment.

``--fabric NAME`` mounts one of the canonical degraded-fabric conditions
(``repro_torch.fabric``: clean, jitter, straggler, lossy, throttle) on the
continuous engine's admission and decode hooks and prints what it
injected into each stage.

``--paged`` switches the continuous engine's KV residency to the
physical page pool (``serve/paged.py``): decode attends through the
ragged paged-attention kernel (``--buffer-depth`` is validated and
recorded; the first CUDA kernel does not schedule by it).  Token streams are identical to the dense engine; the latency
decomposition shows what the paging indirection costs (or saves).

``--trace FILE`` replays a recorded JSONL trace (arrivals, prompts,
generation budgets, priority classes — ``serve/loadgen.py``) instead of
generating synthetic load; ``--save-trace FILE`` records whatever stream
was served so a run can be re-offered verbatim.  ``--slo`` arms the
scheduler with the ``serve_slo_targets`` runtime policy: admission goes
priority-aware with preemption and shed, and the summary reports
per-class SLO attainment (DESIGN.md section 15).  ``--classes`` cycles
the given priority classes over generated requests when no trace
supplies them.

``--trace-out PATH`` attaches the unified span tracer (``repro_torch.obs``,
DESIGN.md section 16) to the run and saves the Chrome-trace-event JSON —
engine-loop phases, scheduler decision instants, one track per decode
slot, pool/queue counters — loadable in Perfetto or chrome://tracing.
``--log-cap N`` ring-buffers the engine's step log and the scheduler's
admit/shed logs at N entries (evictions counted and reported).
"""
from __future__ import annotations

import argparse
import time


def _fmt_ms(v) -> str:
    return f"{v * 1e3:.1f}ms" if v is not None else "-"


def main(argv=None, device="cuda"):
    """Run the CLI.  ``device`` is a Python-level argument for tests
    (``"cpu"``); the command line always runs on the CUDA device."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a synthetic request stream and report "
                    "per-request latency decomposition.")
    ap.add_argument("--arch", default="olmo-1b",
                    help="architecture (smoke-reduced; see configs/): "
                         "olmo-1b, rwkv6-7b, h2o-danube-3-4b (sliding "
                         "window, dense path only), mistral-nemo-12b, "
                         "command-r-plus-104b, moonshot-v1-16b-a3b, "
                         "qwen3-moe-235b-a22b, jamba-1.5-large-398b "
                         "(dense path only); the encoder-decoder and VLM "
                         "archs need frames or patches, which the engines "
                         "do not pass")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (continuous) / batch size (static)")
    ap.add_argument("--cache-len", type=int, default=128,
                    help="per-slot KV cache positions")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV allocator block granularity, in tokens")
    ap.add_argument("--max-new", type=int, default=16,
                    help="new tokens generated per request")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of synthetic requests")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s (0 = one burst)")
    ap.add_argument("--prompt-lens", default="8,16",
                    help="comma-separated prompt lengths, cycled")
    ap.add_argument("--arrivals", choices=("uniform", "poisson"),
                    default="uniform",
                    help="arrival process at --rate: evenly spaced or "
                         "seeded poisson")
    ap.add_argument("--seed", type=int, default=0,
                    help="load-generator seed (prompts + poisson arrivals)")
    ap.add_argument("--static", action="store_true",
                    help="use the static run-to-completion engine "
                         "(burst submission only)")
    ap.add_argument("--fabric", default="clean",
                    help="degraded-fabric condition injected into the "
                         "engine's admission/decode path: one of the "
                         "canonical scenarios (clean, jitter, straggler, "
                         "lossy, throttle; repro_torch.fabric)")
    ap.add_argument("--tp-size", type=int, default=1,
                    help="tensor-parallel decode over this many devices "
                         "(continuous engine; params + per-slot KV "
                         "sequence sharded over a 'model' axis)")
    ap.add_argument("--paged", action="store_true",
                    help="physical paged-KV serving: one preallocated "
                         "page pool per layer, per-request block tables, "
                         "ragged paged-attention decode (continuous "
                         "engine only; serve/paged.py)")
    ap.add_argument("--buffer-depth", type=int, default=2,
                    help="paged-attention page buffers in flight (page-"
                         "gather width of the plain version; validated "
                         "and recorded by the CUDA kernel); needs --paged")
    ap.add_argument("--devices", type=int, default=0,
                    help="rank processes the run may start for "
                         "--tp-size, one a rank over gloo (the reference "
                         "fabricates host devices)")
    ap.add_argument("--trace", default="",
                    help="replay a recorded JSONL trace file (arrivals, "
                         "prompts, budgets, priority classes) instead of "
                         "generating synthetic load (continuous engine "
                         "only)")
    ap.add_argument("--save-trace", default="",
                    help="record the served request stream to this JSONL "
                         "file, replayable via --trace")
    ap.add_argument("--slo", action="store_true",
                    help="SLO-driven admission: priority classes, "
                         "preemption and shed per the serve_slo_targets "
                         "runtime policy (continuous engine only)")
    ap.add_argument("--classes", default="",
                    help="comma-separated priority classes cycled over "
                         "generated requests (e.g. interactive,batch); "
                         "ignored when --trace supplies classes")
    ap.add_argument("--trace-out", default="",
                    help="save the run's unified span trace (engine loop, "
                         "scheduler decisions, per-slot request spans, "
                         "pool counters — repro_torch.obs) as Chrome-trace-event "
                         "JSON at this path; open in Perfetto or "
                         "chrome://tracing (continuous engine only)")
    ap.add_argument("--log-cap", type=int, default=0,
                    help="ring-buffer cap on the engine's step log and the "
                         "scheduler's admit/shed logs (0 = unbounded); "
                         "evictions are counted and reported, not silent")
    args = ap.parse_args(argv)
    from repro_torch.fabric import canonical_conditions
    canon = canonical_conditions()
    if args.fabric not in canon:
        ap.error(f"--fabric {args.fabric!r}: unknown condition "
                 f"(canonical: {', '.join(sorted(canon))})")
    if args.static and args.fabric != "clean":
        ap.error("--fabric injects into the continuous engine's "
                 "admission/decode path; the static engine has no such "
                 "hooks (drop --static)")
    if args.static and args.rate:
        # the static engine has no arrival model — chunks run back to
        # back; reporting a tok/s against a never-offered rate would make
        # the two engines' numbers incomparable
        ap.error("--static serves one burst; it cannot pace arrivals "
                 "(drop --rate or use the continuous engine)")
    if args.tp_size < 1:
        ap.error("--tp-size must be >= 1")
    if args.static and args.tp_size > 1:
        ap.error("--tp-size shards the continuous engine's decode cells; "
                 "the static engine has no sharded path (drop --static)")
    if args.devices < 0:
        ap.error("--devices must be >= 0")
    visible = args.devices or 1
    if args.tp_size > visible:
        ap.error(f"--tp-size {args.tp_size} exceeds the {visible} visible "
                 f"device(s) (give more with --devices N)")
    if args.static and args.paged:
        ap.error("--paged swaps the continuous engine's KV residency; "
                 "the static engine has no paged path (drop --static)")
    if args.buffer_depth < 1:
        ap.error("--buffer-depth must be >= 1")
    if args.buffer_depth != 2 and not args.paged:
        ap.error("--buffer-depth tunes the paged-attention walk; it "
                 "needs --paged")
    if args.paged and args.cache_len % args.block_size:
        ap.error(f"--paged needs --cache-len divisible by --block-size "
                 f"({args.cache_len} % {args.block_size} != 0): blocks "
                 f"are physical pool pages")
    if args.static and (args.trace or args.slo):
        ap.error("--trace/--slo drive the continuous engine's arrival "
                 "pacing and admission policy; the static engine has "
                 "neither (drop --static)")
    if args.trace and args.classes:
        ap.error("--classes assigns priorities to generated requests; "
                 "a --trace already carries its own (drop one)")
    if args.static and args.save_trace:
        ap.error("--save-trace records the continuous engine's request "
                 "stream (drop --static)")
    if args.static and (args.trace_out or args.log_cap):
        ap.error("--trace-out/--log-cap instrument the continuous "
                 "engine's loop; the static engine has no span "
                 "instrumentation (drop --static)")
    if args.log_cap < 0:
        ap.error("--log-cap must be >= 0 (0 = unbounded)")

    import torch
    from repro_torch.configs import all_archs, smoke
    from repro_torch.models import registry
    from repro_torch.runtime import resolve_device
    from repro_torch.serve.step import check_tokens_only
    from repro_torch.models.transformer import check_tp
    cfg = smoke(all_archs()[args.arch])
    try:
        check_tokens_only(cfg)
        if args.tp_size > 1:
            check_tp(cfg, args.tp_size)
    except ValueError as e:
        ap.error(f"--arch {args.arch}: {e}")
    device = resolve_device(device)
    prompt_lens = tuple(int(x) for x in args.prompt_lens.split(","))
    params = None
    if args.tp_size == 1:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = registry.init_params(cfg, gen)

    if args.static:
        from repro_torch.serve.engine import Engine, Request
        from repro_torch.serve.loadgen import make_requests
        eng = Engine(cfg, None, batch_size=args.batch,
                     cache_len=args.cache_len, params=params, device=device)
        reqs = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                for r in make_requests(_load_spec(args, cfg, prompt_lens))]
        t0 = time.perf_counter()
        for i in range(0, len(reqs), args.batch):
            eng.generate(reqs[i:i + args.batch])
        elapsed = time.perf_counter() - t0
        for i, r in enumerate(reqs):
            print(f"[serve] req {i}: prompt={len(r.prompt)} "
                  f"tokens={len(r.generated)} (static batch — no "
                  f"per-stage stamps)")
    elif args.tp_size > 1:
        from repro_torch.parallel.dist import run_ranks
        from repro_torch.serve.ranks import prebuild, serve_rank
        prebuild(device)
        rank0 = run_ranks(serve_rank, args.tp_size, backend="gloo",
                          device=device,
                          args=(cfg, ("seed", 0), _continuous,
                                (args, prompt_lens)))[0]
        lines, reqs, elapsed = rank0["result"]
        for line in lines:
            print(line)
    else:
        lines, reqs, elapsed = _continuous(None, cfg, params, args,
                                           prompt_lens, device, say=print)
    toks = sum(len(r.generated) for r in reqs)
    mode = "static" if args.static else (
        f"continuous tp={args.tp_size}" if args.tp_size > 1 else
        "continuous")
    if args.paged:
        mode += f" paged(depth={args.buffer_depth})"
    if args.slo:
        mode += " slo"
    offered = "trace" if args.trace else f"{args.rate or 'burst'} req/s"
    print(f"[serve] {mode}: {len(reqs)} requests, {toks} tokens in "
          f"{elapsed:.2f}s -> {toks / elapsed:.1f} tok/s "
          f"(offered {offered})")


def _load_spec(args, cfg, prompt_lens):
    from repro_torch.serve.loadgen import LoadSpec
    return LoadSpec(n_requests=args.requests, rate_rps=args.rate,
                    prompt_lens=prompt_lens, max_new_tokens=args.max_new,
                    vocab_size=cfg.vocab_size, seed=args.seed,
                    arrivals=args.arrivals)


def _continuous(mesh, cfg, params, args, prompt_lens, device=None, say=None):
    """The continuous engine's run and report: in this process (``mesh``
    None), or as rank 0's job over rank processes (``serve/ranks.py``),
    whose lines the parent prints.  Returns (lines, requests, seconds)."""
    from repro_torch.fabric import ServeFabric, canonical_conditions
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.loadgen import load_trace, make_requests, save_trace
    from repro_torch.serve.scheduler import SLOPolicy
    lines = []
    if say is None:
        say = lines.append
    if mesh is not None:
        device = mesh.axis.device
    canon = canonical_conditions()

    def build_requests():
        if args.trace:
            return load_trace(args.trace).requests
        reqs = make_requests(_load_spec(args, cfg, prompt_lens))
        if args.classes:
            names = [c.strip() for c in args.classes.split(",") if c.strip()]
            for i, r in enumerate(reqs):
                r.priority = names[i % len(names)]
        return reqs

    policy = SLOPolicy.from_runtime() if args.slo else None
    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer(metadata={"cli": "repro_torch.launch.serve",
                                  "arch": cfg.name,
                                  "fabric": args.fabric})
    fabric = None
    if args.fabric != "clean":
        fabric = ServeFabric(canon[args.fabric])
    eng = ContinuousEngine(cfg, params, n_slots=args.batch,
                           cache_len=args.cache_len,
                           block_size=args.block_size, fabric=fabric,
                           paged=args.paged,
                           page_buffer_depth=args.buffer_depth,
                           slo=policy, tracer=tracer,
                           log_cap=args.log_cap or None, mesh=mesh,
                           device=device)
    reqs = build_requests()
    if args.save_trace:
        save_trace(reqs, args.save_trace)
        say(f"[serve] trace saved to {args.save_trace} "
            f"({len(reqs)} requests)")
    t0 = time.perf_counter()
    eng.run(reqs)
    elapsed = time.perf_counter() - t0
    if fabric is not None:
        say(f"[serve] fabric '{args.fabric}': "
            f"{canon[args.fabric].describe()} — injected "
            f"{fabric.stalled_s['admit'] * 1e3:.0f}ms into admission, "
            f"{fabric.stalled_s['decode'] * 1e3:.0f}ms into decode "
            "ticks")
    for i, r in enumerate(reqs):
        tag = f" [{r.priority}]" if (args.slo or args.trace
                                     or args.classes) else ""
        shed = f" SHED({r.shed_reason})" if r.t_shed is not None else ""
        say(f"[serve] req {i}{tag}: prompt={len(r.prompt)} "
            f"tokens={len(r.generated)} "
            f"queue={_fmt_ms(r.queue_wait_s)} "
            f"ttft={_fmt_ms(r.ttft_s)} "
            f"prefill={_fmt_ms(r.prefill_s)} "
            f"tpot={_fmt_ms(r.tpot_s)}{shed}")
    if policy is not None:
        sched = eng.scheduler
        for cname in sorted({r.priority for r in reqs}):
            cls = policy.slo_for(cname)
            creqs = [r for r in reqs if r.priority == cname]
            hits = [r for r in creqs if r.done
                    and r.ttft_s is not None and r.ttft_s <= cls.ttft_s
                    and (r.tpot_s is None or r.tpot_s <= cls.tpot_s)]
            say(f"[serve] class {cname}: "
                f"{len(hits)}/{len(creqs)} in SLO "
                f"(ttft<={cls.ttft_s * 1e3:.0f}ms, "
                f"tpot<={cls.tpot_s * 1e3:.0f}ms), "
                f"{sum(r.t_shed is not None for r in creqs)} shed, "
                f"{sum(r.n_preempted for r in creqs)} preempt "
                f"cycle(s)")
        say(f"[serve] slo: {len(sched.admit_log)} admissions, "
            f"{len(sched.preempt_log)} preemptions, "
            f"{len(sched.shed_log)} shed")
    if args.log_cap:
        dropped = (eng.step_log.dropped
                   + eng.scheduler.admit_log.dropped
                   + eng.scheduler.shed_log.dropped)
        say(f"[serve] log cap {args.log_cap}: "
            f"{len(eng.step_log)} step events kept, "
            f"{dropped} evicted (step={eng.step_log.dropped}, "
            f"admit={eng.scheduler.admit_log.dropped}, "
            f"shed={eng.scheduler.shed_log.dropped})")
    if tracer is not None:
        tracer.save(args.trace_out)
        say(f"[serve] trace: {args.trace_out} "
            f"({len(tracer.events)} events; load in Perfetto or "
            f"chrome://tracing)")
    return lines, reqs, elapsed


if __name__ == "__main__":
    main()
