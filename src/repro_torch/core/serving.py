"""Serving characterization — the paper's headroom question under load.

The paper asks how much processing margin survives on a device that is
*sustaining traffic*, and answers it with a pktgen sweep: drive the link,
inject work, find where throughput drops.  ``load_sweep`` transposes that
to serving: the synthetic load generator replaces pktgen (offered load in
requests/s is the independent variable), the continuous-batching engine
replaces the forwarding path, and the injected work becomes a *probe
kernel* mounted on the engine's idle hook — its achieved FLOP/s at each
load level is the compute headroom left beside the traffic.  Per-stage
latency decomposition (queue wait, TTFT, TPOT — the stamps
``serve.scheduler`` keeps per request) is what makes the sweep
actionable, the same way the DPU studies decompose per-stage datapath
latency rather than reporting a single number.

``sharded_sweep`` is the same sweep with the engine tensor-parallel over
the visible devices (``ContinuousEngine(tp_size=N)`` — decode routed
through the mesh-aware cells in ``serve/step.py``): now the probe kernel
contends with live decode *collectives*, not just the decode compute, so
planner rule 5's serve-offload verdict is re-derived where the
contention is real.  The stream additionally pins the decode step's
per-kind collective counts from compiled HLO (``collectives_per_step``)
— a resharding that silently creeps into the hot loop changes that row
before it changes any latency quantile.

``continuous_vs_static`` is the engine-level comparison: the same mixed
workload through the static run-to-completion engine (the seed's serving
path) and the slot-admission engine, reported as sustained token
throughput.

``slo_sweep`` closes the loop the other sweeps only observe: the engine
runs trace-shaped traffic (bursty arrivals, heavy-tailed lengths, two
priority classes at equal weight) under an ``SLOPolicy`` whose targets
are derived from the run's own measured prefill/TPOT medians — so
*attainment* is host-speed independent the same way the throughput
relatives are.  Per offered-load level the stream carries SLO attainment
per class, the shed fraction, and the probe headroom beside the
controlled traffic; planner rule 5 conditions its serve-offload verdict
on the highest-priority class's attainment when these rows are present
(DESIGN.md section 15).

All emit the unified ``Record`` stream and register through
``@experiment`` in ``repro_torch.experiments.defs`` (family ``serve``).

This is the port's counterpart of ``repro/core/serving.py``, with the
reference's constants and record rows.  What differs:

* **Device.**  Every family takes ``device`` (``"cuda"`` by default,
  raising where there is no card; the tests pass ``"cpu"``).  The probe
  is the reference's chained ``tanh(c @ m)`` in ``torch.matmul``; each
  call ends in ``torch.cuda.synchronize()`` on the card, as the
  reference's ends in ``block_until_ready``, and it runs on the engine's
  stream, so it contends with decode as the reference's single JAX stream
  does.  At ``PROBE_DIM`` 96 on an H100 the probe is launch-bound: its
  "headroom" is mostly the host's.
* **Width.**  Every family takes ``width``: ``"smoke"`` (the default)
  reproduces the reference's ``smoke(all_archs()[arch])``; ``"full"``
  takes the published config unchanged, so that the sweep can run at the
  full width of a model on the card.  It is the one keyword the reference
  lacks.
* ``sharded_sweep`` runs its engine tensor-parallel over ``devices`` rank
  processes (``serve/ranks.py``: rank 0 runs the sweep and the probe on
  its idle hook, the other ranks run the same cells on their shards),
  exchanging over gloo.  Its ``collectives_per_step`` row counts the
  port's own schedule — the exchanges one decode tick makes, by kind
  (``2 L + 1`` all-reduces and one all-gather for ``L`` sequential
  layers) — not the reference's trip-count-weighted HLO count.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs import all_archs, smoke
from repro_torch.experiments.measure import measure
from repro_torch.experiments.record import Record
from repro_torch.models import registry
from repro_torch.runtime import resolve_device
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.loadgen import (LoadSpec, TraceSpec, make_requests,
                                 make_stream, make_trace)

EXPERIMENT_LOAD = "serve.load_sweep"
EXPERIMENT_SHARDED = "serve.sharded_sweep"
EXPERIMENT_ENGINE = "serve.continuous_vs_static"
EXPERIMENT_PAGED = "serve.paged_attention"
EXPERIMENT_SLO = "serve.slo_sweep"
EXPERIMENT_TIMELINE = "serve.timeline"

# page-size x buffer-depth grid for the paged-attention microbench.  The
# depth knob's win is page-granularity amortization (pages in flight per
# walk step), so the sweep tops out at the engine's smoke block size —
# at this container's smoke dims the per-step dispatch it amortizes
# dominates exactly in that range (larger pages already move enough per
# step that extra width costs more than the saved steps).
PAGED_PAGE_SIZES = (2, 4, 8)
PAGED_DEPTHS = (1, 2, 4)

# offered-load multiples of measured capacity: two under, at, and past
# saturation — the knee the paper's delay sweep looks for, in request rate
OFFERED_MULTS = (0.25, 0.5, 1.0, 2.0)

PROBE_DIM = 96
PROBE_ITERS = 4

WIDTHS = ("smoke", "full")


def _config(arch: str, width: str):
    """The reference's smoke reduction of ``arch``, or (``"full"``) its
    published config unchanged."""
    if width not in WIDTHS:
        raise ValueError(f"width {width!r}; expected one of {WIDTHS}")
    cfg = all_archs()[arch]
    return smoke(cfg) if width == "smoke" else cfg


def _init(arch: str, width: str, device):
    """(cfg, params on the device, the device): random weights from seed
    0, made on the device itself (a full-width model never passes through
    the host)."""
    cfg = _config(arch, width)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, registry.init_params(cfg, gen), dev


def _smoke_engine(arch: str, n_slots: int, cache_len: int, block_size: int,
                  width: str = "smoke", device="cuda"):
    cfg, params, dev = _init(arch, width, device)
    eng = ContinuousEngine(cfg, params, n_slots=n_slots,
                           cache_len=cache_len, block_size=block_size,
                           device=dev)
    return cfg, params, eng


def _wait(dev: torch.device) -> None:
    """Wait for the card's work, as ``block_until_ready`` does."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_probe(dim: int = PROBE_DIM, iters: int = PROBE_ITERS,
                device="cuda"):
    """A chained-matmul probe kernel and its FLOP count per call."""
    dev = resolve_device(device)
    a = torch.tensor(np.random.default_rng(7).standard_normal((dim, dim)),
                     dtype=torch.float32, device=dev) / dim

    @torch.no_grad()
    def probe():
        c = a
        for _ in range(iters):
            c = torch.tanh(c @ a)
        _wait(dev)
        return c

    flops = iters * 2 * dim ** 3
    return probe, flops


def _pct(vals: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _offered_sweep(eng, cfg, experiment: str, base_params: dict,
                   duration: float, offered: Sequence[float],
                   prompt_lens: tuple, max_new: int,
                   max_requests: int,
                   run_deadline_s: Optional[float] = None) -> list[Record]:
    """The shared sweep body behind ``load_sweep`` and ``sharded_sweep``:
    probe-idle reference, burst capacity calibration, then one run per
    offered-load level with the probe mounted on the engine's idle hook.

    ``run_deadline_s`` bounds each level on the engine clock (unfinished
    requests shed — see ``ContinuousEngine.run``); a level can then end
    with zero completions, so every percentile row is guarded on its
    sample pool being non-empty (an overloaded level is reported as
    ``completed=0`` rows, not a crash).
    """
    run_probe, probe_flops = _make_probe(device=eng.device)
    records: list[Record] = []

    # probe alone: the idle-FLOP/s reference every level is normalized to
    m_idle = measure(run_probe, min(max(duration, 0.05), 0.25))
    idle_fps = probe_flops * m_idle.calls_per_sec
    records.append(Record(
        experiment, "probe_idle", "headroom_flops_per_s", idle_fps,
        unit="flop/s", relative=1.0,
        params=dict(base_params, probe_dim=PROBE_DIM,
                    probe_iters=PROBE_ITERS, probe_flops=probe_flops)))

    # burst calibration: saturated capacity; also warms every compile
    # (prefill per prompt length, decode, slot insert) out of the sweep
    cal = make_requests(LoadSpec(n_requests=2 * eng.n_slots, rate_rps=0.0,
                                 prompt_lens=prompt_lens,
                                 max_new_tokens=max_new,
                                 vocab_size=cfg.vocab_size))
    eng.generate(cal)                       # compile pass, untimed
    cal2 = make_requests(LoadSpec(n_requests=2 * eng.n_slots, rate_rps=0.0,
                                  prompt_lens=prompt_lens,
                                  max_new_tokens=max_new,
                                  vocab_size=cfg.vocab_size, seed=1))
    t0 = time.perf_counter()
    eng.generate(cal2)
    cal_el = time.perf_counter() - t0
    cap_tps = sum(len(r.generated) for r in cal2) / cal_el
    cap_rps = cap_tps / max_new
    records.append(Record(
        experiment, "capacity", "tokens_per_sec", cap_tps,
        unit="tok/s", relative=1.0,
        params=dict(base_params, wall_s=cal_el,
                    requests_per_sec=cap_rps, mode="burst")))

    window = max(2 * duration, 0.4)
    for k, mult in enumerate(offered):
        rate = mult * cap_rps
        n = int(min(max(rate * window, 4), max_requests))
        stream = make_stream(LoadSpec(n_requests=n, rate_rps=rate,
                                      prompt_lens=prompt_lens,
                                      max_new_tokens=max_new,
                                      vocab_size=cfg.vocab_size,
                                      seed=10 + k))
        reqs = stream.requests
        # the sweep's denominator is the rate the stream actually offers
        # (a Poisson draw spans what it spans; == rate for uniform)
        realized_rps = stream.realized_rps or rate
        probe_calls = 0

        def hook():
            nonlocal probe_calls
            run_probe()
            probe_calls += 1

        t0 = time.perf_counter()
        eng.run(reqs, idle_hook=hook, deadline_s=run_deadline_s)
        el = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in reqs)
        tps = toks / el
        offered_tps = realized_rps * max_new
        sustained = tps >= 0.9 * offered_tps
        ttft = [v for v in (r.ttft_s for r in reqs) if v is not None]
        qwait = [v for v in (r.queue_wait_s for r in reqs) if v is not None]
        prefill = [v for v in (r.prefill_s for r in reqs) if v is not None]
        tok_lat = [t for r in reqs for t in r.decode_token_s]
        name = f"load_{mult:g}x"
        level = dict(base_params, offered_mult=mult, requested_rps=rate,
                     offered_rps=realized_rps,
                     offered_tokens_per_sec=offered_tps, n_requests=n,
                     completed=sum(r.done for r in reqs), wall_s=el,
                     sustained=bool(sustained))
        if qwait:
            level.update(queue_wait_p50_s=_pct(qwait, 50),
                         queue_wait_p99_s=_pct(qwait, 99))
        if prefill:
            level.update(prefill_p50_s=_pct(prefill, 50))
        records.append(Record(experiment, name, "tokens_per_sec", tps,
                              unit="tok/s", relative=tps / cap_tps,
                              params=dict(level)))
        if ttft:        # an overloaded level can complete nothing inside
            #             its deadline — report completed=0, not a crash
            records.append(Record(experiment, name, "ttft_p50_s",
                                  _pct(ttft, 50), unit="s",
                                  params=dict(level)))
            records.append(Record(experiment, name, "ttft_p99_s",
                                  _pct(ttft, 99), unit="s",
                                  params=dict(level)))
        if tok_lat:     # max_new=1 has no decode stage, hence no TPOT rows
            records.append(Record(experiment, name, "tpot_p50_s",
                                  _pct(tok_lat, 50), unit="s",
                                  params=dict(level)))
            records.append(Record(experiment, name, "tpot_p99_s",
                                  _pct(tok_lat, 99), unit="s",
                                  params=dict(level)))
        headroom_fps = probe_calls * probe_flops / el
        records.append(Record(
            experiment, name, "headroom_flops_per_s", headroom_fps,
            unit="flop/s", relative=headroom_fps / idle_fps if idle_fps
            else None,
            params=dict(level, probe_calls=probe_calls,
                        probe_flops=probe_flops)))
    return records


def load_sweep(duration: float = 0.3,
               offered: Sequence[float] = OFFERED_MULTS,
               arch: str = "olmo-1b", n_slots: int = 4,
               cache_len: int = 64, block_size: int = 8,
               prompt_lens: tuple = (8, 16), max_new: int = 8,
               max_requests: int = 32, width: str = "smoke",
               device="cuda") -> list[Record]:
    """Offered-load sweep over the continuous-batching engine.

    Per load level (a multiple of the measured burst capacity) the stream
    carries: sustained token throughput (relative = fraction of
    capacity), p50/p99 TTFT and TPOT, queue-wait quantiles in params, and
    the probe kernel's achieved FLOP/s (relative = fraction of its idle
    rate) — compute headroom while the engine sustains that traffic.
    ``duration`` scales the measurement window per level.
    """
    cfg, _, eng = _smoke_engine(arch, n_slots, cache_len, block_size,
                                width, device)
    base_params = {"arch": cfg.name, "n_slots": n_slots,
                   "cache_len": cache_len, "block_size": block_size,
                   "kv_blocks": eng.kv.n_blocks,
                   "prompt_lens": list(prompt_lens),
                   "max_new_tokens": max_new}
    return _offered_sweep(eng, cfg, EXPERIMENT_LOAD, base_params, duration,
                          offered, prompt_lens, max_new, max_requests)


def sharded_sweep(duration: float = 0.3,
                  offered: Sequence[float] = OFFERED_MULTS,
                  arch: str = "olmo-1b", tp_size: Optional[int] = None,
                  n_slots: int = 4, cache_len: int = 64,
                  block_size: int = 8, prompt_lens: tuple = (8, 16),
                  max_new: int = 8, max_requests: int = 24,
                  width: str = "smoke", device="cuda",
                  devices: int = 1) -> list[Record]:
    """``load_sweep`` with the engine tensor-parallel over ``tp_size`` rank
    processes (default: all ``devices`` up to 4), so the probe kernel on
    rank 0's idle hook contends with the decode step's *collectives*.
    One extra row pins the decode tick's exchanges
    (``collectives_per_step``, per-kind breakdown in params): a change to
    the tensor-parallel schedule moves this deterministic row before any
    latency quantile drifts."""
    if tp_size is None:
        tp_size = min(4, devices)
    if tp_size < 2:
        raise RuntimeError(
            f"serve.sharded_sweep needs a tensor-parallel axis "
            f"(tp_size={tp_size}, {devices} visible device(s)); give it "
            f"ranks with --devices N")
    from repro_torch.parallel.dist import run_ranks
    from repro_torch.serve.ranks import prebuild, serve_rank
    cfg = _config(arch, width)
    prebuild(device)
    rank0 = run_ranks(serve_rank, tp_size, backend="gloo", device=device,
                      args=(cfg, ("seed", 0), _sharded_job,
                            (duration, tuple(offered), n_slots, cache_len,
                             block_size, tuple(prompt_lens), max_new,
                             max_requests, devices)))[0]
    return rank0["result"]


def _sharded_job(mesh, cfg, params, duration, offered, n_slots, cache_len,
                 block_size, prompt_lens, max_new, max_requests,
                 devices) -> list[Record]:
    """``sharded_sweep``'s body, rank 0's job over the rank processes."""
    eng = ContinuousEngine(cfg, params, n_slots=n_slots,
                           cache_len=cache_len, block_size=block_size,
                           mesh=mesh, device=mesh.axis.device)
    base_params = {"arch": cfg.name, "n_slots": n_slots,
                   "cache_len": cache_len, "block_size": block_size,
                   "kv_blocks": eng.kv.n_blocks,
                   "prompt_lens": list(prompt_lens),
                   "max_new_tokens": max_new,
                   "tp_size": mesh.tp_size, "n_devices": devices,
                   "mesh_axes": dict(mesh.shape)}
    counts = eng.cells.decode_collective_counts(eng.params)
    records = [Record(
        EXPERIMENT_SHARDED, "decode_step", "collectives_per_step",
        float(sum(counts.values())), unit="ops",
        params=dict(base_params,
                    per_kind={k: float(v) for k, v in sorted(counts.items())}))]
    records += _offered_sweep(eng, cfg, EXPERIMENT_SHARDED, base_params,
                              duration, offered, prompt_lens, max_new,
                              max_requests)
    return records


def paged_sweep(duration: float = 0.3, arch: str = "olmo-1b",
                page_sizes: Sequence[int] = PAGED_PAGE_SIZES,
                buffer_depths: Sequence[int] = PAGED_DEPTHS,
                n_seqs: int = 8, kv_tokens: int = 512,
                offered: Sequence[float] = (0.5, 1.0),
                n_slots: int = 4, cache_len: int = 64, block_size: int = 8,
                prompt_lens: tuple = (8, 16), max_new: int = 8,
                max_requests: int = 16, width: str = "smoke",
                device="cuda") -> list[Record]:
    """Paged-attention characterization: page-size x buffer-depth grid,
    a bytes-moved model per page size, and probe headroom beside a
    *paged* engine.

    The microbench drives ``kernels/ops.paged_attention`` directly — one
    decode token for each of ``n_seqs`` ragged sequences against a page
    pool, every (page size, depth) combination measured as attention
    tokens/s (relative = speedup over depth 1 at the same page size, so
    the double-buffering knob's win is read straight off the stream).
    ``page{ps}_bytes`` rows carry the deterministic traffic model —
    page-granular bytes touched per token vs the valid-token ideal, the
    wire-bytes idiom applied to KV reads (relative = utilization; the
    page-size knob trades this against table length).  The engine half
    re-runs the offered-load sweep with ``paged=True`` so planner rule
    5's ``load_*`` headroom rows exist beside *paged* decode traffic.
    """
    from repro_torch.kernels import ops as kops

    cfg, params, dev = _init(arch, width, device)
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    impl = runtime.impl("paged_attention_impl")
    itemsize = torch.empty((), dtype=torch.float32).element_size()
    rng = np.random.default_rng(0)
    # ragged lengths: longest sequence uses the full budget, the rest
    # step down so page counts differ across the batch
    lens_np = np.clip(kv_tokens - np.arange(n_seqs) * 37, 1, kv_tokens)
    lengths = torch.tensor(lens_np, dtype=torch.int32, device=dev)
    q = torch.tensor(rng.standard_normal((n_seqs, H, hd)),
                     dtype=torch.float32, device=dev)
    records: list[Record] = []
    base = {"arch": cfg.name, "n_seqs": n_seqs, "kv_tokens": kv_tokens,
            "impl": impl, "backend": dev.type,
            "n_heads": H, "n_kv_heads": Kv, "head_dim": hd}

    for ps in page_sizes:
        max_pages = kv_tokens // ps
        n_pages = n_seqs * max_pages + 1          # + trash page
        pool = torch.tensor(
            rng.standard_normal((n_pages, ps, 2 * Kv, hd)),
            dtype=torch.float32, device=dev)
        perm = rng.permutation(n_pages - 1)
        tables = torch.tensor(
            perm[:n_seqs * max_pages].reshape(n_seqs, max_pages),
            dtype=torch.int32, device=dev)

        # deterministic traffic model: the kernel walks ceil(len/ps)
        # pages per sequence, so page-granular bytes touched per decode
        # token vs the valid-token ideal is pure arithmetic — the
        # wire-bytes idiom for KV reads
        row_bytes = 2 * Kv * hd * itemsize
        touched = int(np.sum(-(-lens_np // ps)) * ps) * row_bytes
        ideal = int(np.sum(lens_np)) * row_bytes
        records.append(Record(
            EXPERIMENT_PAGED, f"page{ps}_bytes", "kv_bytes_per_token",
            touched / n_seqs, unit="bytes", relative=ideal / touched,
            params=dict(base, page_size=ps, max_pages=max_pages,
                        ideal_bytes_per_token=ideal / n_seqs)))

        tps_d1 = None
        for d in buffer_depths:
            def fn(d=d):
                out = kops.paged_attention(q, pool, tables, lengths,
                                           buffer_depth=d)
                _wait(dev)
                return out
            fn()                                   # first call, untimed
            m = measure(fn, duration)
            tps = n_seqs * m.calls_per_sec
            if tps_d1 is None:
                tps_d1 = tps
            records.append(Record(
                EXPERIMENT_PAGED, f"page{ps}_depth{d}",
                "attn_tokens_per_sec", tps, unit="tok/s",
                relative=tps / tps_d1,
                params=dict(base, page_size=ps, depth=d,
                            max_pages=max_pages,
                            attn_s_per_token=1.0 / tps if tps else None)))

    # probe headroom beside *paged* decode traffic: the offered-load
    # sweep re-run with the paged engine, feeding planner rule 5
    eng = ContinuousEngine(cfg, params, n_slots=n_slots,
                           cache_len=cache_len, block_size=block_size,
                           paged=True, device=dev)
    eng_params = {"arch": cfg.name, "n_slots": n_slots,
                  "cache_len": cache_len, "block_size": block_size,
                  "kv_blocks": eng.kv.n_blocks, "paged": True,
                  "page_buffer_depth": eng.cells.buffer_depth,
                  "prompt_lens": list(prompt_lens),
                  "max_new_tokens": max_new}
    records += _offered_sweep(eng, cfg, EXPERIMENT_PAGED, eng_params,
                              duration, offered, prompt_lens, max_new,
                              max_requests)
    return records


# offered multiples for the SLO sweep: comfortable, at capacity, past the
# knee, and deep overload (where the shed budget visibly binds)
SLO_OFFERED_MULTS = (0.5, 1.0, 2.0, 4.0)
# the two trace classes: interactive outranks batch; equal offered weight
SLO_CLASSES = (("interactive", 1.0), ("batch", 1.0))

# SLO targets as multiples of the run's own measured medians — attainment
# stays host-speed independent (the same trick as the throughput
# relatives).  Interactive is tight; batch is loose but carries a
# queue-wait shed budget so overload sheds stale batch work instead of
# serving it arbitrarily late.
SLO_TARGET_FACTORS = {
    "interactive": {"rank": 0, "ttft": 8.0, "tpot": 4.0, "shed": None},
    "batch": {"rank": 1, "ttft": 40.0, "tpot": 16.0, "shed": 40.0},
}


def _slo_policy_from_measured(prefill_med: float, tpot_med: float):
    """Per-class targets scaled off the calibration run's decomposition."""
    from repro_torch.serve.scheduler import ClassSLO, SLOPolicy
    classes = {}
    for name, f in SLO_TARGET_FACTORS.items():
        classes[name] = ClassSLO(
            rank=f["rank"], ttft_s=f["ttft"] * prefill_med,
            tpot_s=f["tpot"] * tpot_med,
            shed_after_s=None if f["shed"] is None
            else f["shed"] * prefill_med)
    return SLOPolicy(classes=classes, default_class="batch")


def slo_sweep(duration: float = 0.3,
              offered: Sequence[float] = SLO_OFFERED_MULTS,
              arch: str = "olmo-1b", n_slots: int = 4,
              cache_len: int = 64, block_size: int = 8,
              max_requests: int = 24,
              fabric_condition: str = "clean",
              seed: int = 0, width: str = "smoke",
              device="cuda") -> list[Record]:
    """SLO-driven admission under trace-shaped load — the control loop.

    Calibrates burst capacity and the prefill/TPOT medians FIFO-style,
    derives per-class SLO targets from those medians
    (``SLO_TARGET_FACTORS``), arms the scheduler with the policy, then
    serves a bursty two-class trace at each offered multiple with the
    probe kernel on the idle hook.  Per level the stream carries token
    throughput, guarded TTFT/TPOT quantiles, shed fraction, probe
    headroom, and one ``slo_attainment`` row per class (fraction of the
    class's offered requests that completed inside BOTH its TTFT and
    TPOT targets).  ``fabric_condition`` composes the degraded-fabric
    layer in (``repro_torch.fabric``): the straggler condition is the
    acceptance experiment — attainment is re-measured while every decode
    tick drags.
    """
    cfg, params, dev = _init(arch, width, device)
    fabric = None
    if fabric_condition != "clean":
        from repro_torch.fabric import ServeFabric, canonical_conditions
        conds = canonical_conditions()
        if fabric_condition not in conds:
            raise ValueError(f"unknown fabric condition "
                             f"{fabric_condition!r}; one of {sorted(conds)}")
        fabric = ServeFabric(conds[fabric_condition])
    eng = ContinuousEngine(cfg, params, n_slots=n_slots,
                           cache_len=cache_len, block_size=block_size,
                           fabric=fabric, device=dev)
    prompt_buckets, max_new_buckets = (8, 16), (4, 8)
    base_params = {"arch": cfg.name, "n_slots": n_slots,
                   "cache_len": cache_len, "block_size": block_size,
                   "kv_blocks": eng.kv.n_blocks,
                   "prompt_len_buckets": list(prompt_buckets),
                   "max_new_buckets": list(max_new_buckets),
                   "fabric_condition": fabric_condition,
                   "classes": [c for c, _ in SLO_CLASSES]}
    run_probe, probe_flops = _make_probe(device=dev)
    records: list[Record] = []

    m_idle = measure(run_probe, min(max(duration, 0.05), 0.25))
    idle_fps = probe_flops * m_idle.calls_per_sec
    records.append(Record(
        EXPERIMENT_SLO, "probe_idle", "headroom_flops_per_s", idle_fps,
        unit="flop/s", relative=1.0,
        params=dict(base_params, probe_flops=probe_flops)))

    # burst calibration, FIFO: capacity + the measured decomposition the
    # policy targets scale from; warms every compile out of the sweep
    max_new_cal = max(max_new_buckets)
    cal_spec = dict(n_requests=2 * n_slots, rate_rps=0.0,
                    prompt_lens=prompt_buckets, max_new_tokens=max_new_cal,
                    vocab_size=cfg.vocab_size)
    eng.generate(make_requests(LoadSpec(**cal_spec)))    # compile, untimed
    cal = make_requests(LoadSpec(**cal_spec, seed=1))
    t0 = time.perf_counter()
    eng.generate(cal)
    cal_el = time.perf_counter() - t0
    cap_tps = sum(len(r.generated) for r in cal) / cal_el
    cap_rps = cap_tps / max_new_cal
    prefill_med = _pct([r.prefill_s for r in cal], 50)
    tpot_med = _pct([t for r in cal for t in r.decode_token_s], 50)
    records.append(Record(
        EXPERIMENT_SLO, "capacity", "tokens_per_sec", cap_tps,
        unit="tok/s", relative=1.0,
        params=dict(base_params, wall_s=cal_el, requests_per_sec=cap_rps,
                    prefill_p50_s=prefill_med, tpot_p50_s=tpot_med,
                    mode="burst")))

    policy = _slo_policy_from_measured(prefill_med, tpot_med)
    eng.scheduler.slo = policy
    targets = {name: {"ttft_s": c.ttft_s, "tpot_s": c.tpot_s,
                      "shed_after_s": c.shed_after_s, "rank": c.rank}
               for name, c in policy.classes.items()}

    window = max(2 * duration, 0.4)
    for k, mult in enumerate(offered):
        rate = mult * cap_rps
        n = int(min(max(rate * window, 8), max_requests))
        stream = make_trace(TraceSpec(
            n_requests=n, base_rps=rate, classes=SLO_CLASSES,
            bursts=((0.25 * window, 0.25 * window, 3.0),),
            prompt_len_buckets=prompt_buckets,
            max_new_buckets=max_new_buckets,
            vocab_size=cfg.vocab_size, seed=seed * 1000 + 20 + k))
        reqs = stream.requests
        realized_rps = stream.realized_rps or rate
        mean_new = float(np.mean([r.max_new_tokens for r in reqs]))
        span = reqs[-1].arrival_s if reqs else 0.0
        probe_calls = 0

        def hook():
            nonlocal probe_calls
            run_probe()
            probe_calls += 1

        n_preempt0 = len(eng.scheduler.preempt_log)
        t0 = time.perf_counter()
        # deadline: the stream's own arrival span plus a backlog-drain
        # allowance — overload levels end bounded, comfortable ones don't
        # get clipped
        eng.run(reqs, idle_hook=hook, deadline_s=span + 2 * window)
        el = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in reqs)
        tps = toks / el
        offered_tps = realized_rps * mean_new
        sustained = bool(tps >= 0.9 * offered_tps)
        shed = [r for r in reqs if r.t_shed is not None]
        ttft = [v for v in (r.ttft_s for r in reqs) if v is not None]
        tok_lat = [t for r in reqs for t in r.decode_token_s]
        name = f"load_{mult:g}x"
        level = dict(base_params, offered_mult=mult, requested_rps=rate,
                     offered_rps=realized_rps,
                     offered_tokens_per_sec=offered_tps, n_requests=n,
                     completed=sum(r.done for r in reqs), wall_s=el,
                     sustained=sustained,
                     preemptions=len(eng.scheduler.preempt_log) - n_preempt0)
        records.append(Record(EXPERIMENT_SLO, name, "tokens_per_sec", tps,
                              unit="tok/s", relative=tps / cap_tps,
                              params=dict(level)))
        records.append(Record(EXPERIMENT_SLO, name, "shed_fraction",
                              len(shed) / n, unit="fraction",
                              relative=len(shed) / n,
                              params=dict(level, shed_reasons=sorted(
                                  {r.shed_reason for r in shed}))))
        if ttft:
            records.append(Record(EXPERIMENT_SLO, name, "ttft_p50_s",
                                  _pct(ttft, 50), unit="s",
                                  params=dict(level)))
            records.append(Record(EXPERIMENT_SLO, name, "ttft_p99_s",
                                  _pct(ttft, 99), unit="s",
                                  params=dict(level)))
        if tok_lat:
            records.append(Record(EXPERIMENT_SLO, name, "tpot_p99_s",
                                  _pct(tok_lat, 99), unit="s",
                                  params=dict(level)))
        headroom_fps = probe_calls * probe_flops / el
        records.append(Record(
            EXPERIMENT_SLO, name, "headroom_flops_per_s", headroom_fps,
            unit="flop/s",
            relative=headroom_fps / idle_fps if idle_fps else None,
            params=dict(level, probe_calls=probe_calls)))
        # per-class attainment — the row the planner's SLO arm gates on.
        # Named slo_<class>_<mult>x, NOT load_*: the level loops in
        # report.serve_table and planner headroom scans key on load_*.
        for cname, _ in SLO_CLASSES:
            creqs = [r for r in reqs if r.priority == cname]
            if not creqs:
                continue
            cls = policy.classes[cname]
            hits = [r for r in creqs if r.done
                    and r.ttft_s is not None and r.ttft_s <= cls.ttft_s
                    and (r.tpot_s is None or r.tpot_s <= cls.tpot_s)]
            att = len(hits) / len(creqs)
            records.append(Record(
                EXPERIMENT_SLO, f"slo_{cname}_{mult:g}x",
                "slo_attainment", att, unit="fraction", relative=att,
                params=dict(level, slo_class=cname, rank=cls.rank,
                            class_requests=len(creqs),
                            class_completed=sum(r.done for r in creqs),
                            class_shed=sum(
                                r.t_shed is not None for r in creqs),
                            class_preempt_cycles=sum(
                                r.n_preempted for r in creqs),
                            targets=targets[cname])))
    return records


def continuous_vs_static(duration: float = 0.3, arch: str = "olmo-1b",
                         batch: int = 4, cache_len: int = 64,
                         block_size: int = 8,
                         n_requests: Optional[int] = None,
                         width: str = "smoke",
                         device="cuda") -> list[Record]:
    """Same mixed workload through both engines, as token throughput.

    The workload mixes generation lengths (short and long requests
    alternate), which is where run-to-completion loses: the static batch
    decodes until its *longest* member finishes while done slots ride
    along empty, the continuous engine refills them.  Prompt lengths stay
    uniform so the comparison isolates scheduling (the static engine
    left-pads mixed prompts, which changes its logits).
    """
    from repro_torch.serve.engine import Engine, Request

    cfg, params, dev = _init(arch, width, device)
    if n_requests is None:
        n_requests = int(min(max(8 * duration / 0.3, 2 * batch), 24))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(n_requests)]
    # a wide generation-length mix: run-to-completion decodes every batch
    # to its longest member (short requests ride along done), continuous
    # batching refills those slots from the queue
    news = [2 if i % 2 else 24 for i in range(n_requests)]

    static = Engine(cfg, None, batch_size=batch, cache_len=cache_len,
                    params=params, device=dev)
    cont = ContinuousEngine(cfg, params, n_slots=batch,
                            cache_len=cache_len, block_size=block_size,
                            device=dev)

    def run_static():
        reqs = [Request(prompt=p.copy(), max_new_tokens=m)
                for p, m in zip(prompts, news)]
        for i in range(0, len(reqs), batch):
            static.generate(reqs[i:i + batch])
        return reqs

    def run_cont():
        from repro_torch.serve.scheduler import ServeRequest
        return cont.generate([ServeRequest(prompt=p.copy(),
                                           max_new_tokens=m)
                              for p, m in zip(prompts, news)])

    results = []
    for name, fn in (("static", run_static), ("continuous", run_cont)):
        done = fn()                                   # warm-up pass
        t0 = time.perf_counter()
        done = fn()
        el = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in done)
        results.append((name, toks / el, el, toks))
    base = results[0][1]
    return [Record(
        EXPERIMENT_ENGINE, name, "tokens_per_sec", tps, unit="tok/s",
        relative=tps / base,
        params={"arch": cfg.name, "batch": batch, "cache_len": cache_len,
                "n_requests": n_requests, "wall_s": el, "tokens": toks,
                "max_new_mix": sorted(set(news))})
        for name, tps, el, toks in results]


# offered multiples for the timeline runs: one comfortable, one at the
# measured knee — enough to show the decomposition shifting from
# idle-dominated to decode-dominated without a long sweep
TIMELINE_OFFERED_MULTS = (0.5, 1.0)


def timeline(duration: float = 0.3,
             offered: Sequence[float] = TIMELINE_OFFERED_MULTS,
             arch: str = "olmo-1b", n_slots: int = 4,
             cache_len: int = 64, block_size: int = 8,
             prompt_lens: tuple = (8, 16), max_new: int = 8,
             max_requests: int = 16,
             fabric_condition: str = "clean", slo: bool = False,
             paged: bool = False, tp_size: int = 1,
             trace_out: Optional[str] = None,
             seed: int = 0, width: str = "smoke",
             device="cuda") -> list[Record]:
    """Traced serve runs: span-time decomposition per load level.

    Runs the continuous engine per offered-load level with the unified
    tracer attached (``repro_torch.obs``), then reports where each level's wall
    time went as ``span_time_s`` rows — one per engine-track phase
    (admit, prefill, decode, idle, fabric_stall), named
    ``load_<mult>x.<phase>`` with ``relative`` the fraction of the
    level's wall clock.  The same trace also carries the scheduler's
    decision instants, per-slot request spans, and pool/queue counters;
    ``trace_out`` saves it as Chrome-trace-event JSON (Perfetto /
    chrome://tracing load it directly, ``scripts/check_trace.py``
    validates it).  A short eager bucket-chain demo (serial then
    pipelined ``run_schedule``) lands "overlap" stage spans in the same
    file, so one artifact shows scheduler-to-kernel structure.

    Composes the serving layers: ``fabric_condition`` injects degraded
    wire stalls (spans labeled by condition), ``slo`` arms SLO-driven
    admission off the run's own measured medians (shed/preempt instants
    carry the projected TTFT that justified them), ``paged``/``tp_size``
    swap the KV residency / shard the decode.
    """
    from repro_torch.obs import trace as obs_trace

    cfg, params, dev = _init(arch, width, device)
    fabric = None
    if fabric_condition != "clean":
        from repro_torch.fabric import ServeFabric, canonical_conditions
        conds = canonical_conditions()
        if fabric_condition not in conds:
            raise ValueError(f"unknown fabric condition "
                             f"{fabric_condition!r}; one of {sorted(conds)}")
        fabric = ServeFabric(conds[fabric_condition])

    # the thread-local tracer (CLI --trace-out) wins; otherwise this run
    # owns a fresh one — timeline is the one experiment that is always
    # traced, its Records are *about* the trace
    tr = obs_trace.current()
    if not tr.enabled:
        tr = obs_trace.Tracer(metadata={"experiment": EXPERIMENT_TIMELINE})
    eng = ContinuousEngine(cfg, params, n_slots=n_slots,
                           cache_len=cache_len, block_size=block_size,
                           fabric=fabric, tp_size=tp_size, paged=paged,
                           tracer=tr, device=dev)
    base_params = {"arch": cfg.name, "n_slots": n_slots,
                   "cache_len": cache_len, "block_size": block_size,
                   "kv_blocks": eng.kv.n_blocks,
                   "prompt_lens": list(prompt_lens),
                   "max_new_tokens": max_new,
                   "fabric_condition": fabric_condition,
                   "slo": bool(slo), "paged": bool(paged),
                   "tp_size": eng.tp_size}
    records: list[Record] = []

    # burst calibration (also the compile pass): capacity + the measured
    # medians the optional SLO policy scales from
    cal_spec = dict(n_requests=2 * n_slots, rate_rps=0.0,
                    prompt_lens=prompt_lens, max_new_tokens=max_new,
                    vocab_size=cfg.vocab_size)
    eng.generate(make_requests(LoadSpec(**cal_spec)))    # compile, untimed
    cal = make_requests(LoadSpec(**cal_spec, seed=1))
    t0 = time.perf_counter()
    eng.generate(cal)
    cal_el = time.perf_counter() - t0
    cap_tps = sum(len(r.generated) for r in cal) / cal_el
    cap_rps = cap_tps / max_new
    records.append(Record(
        EXPERIMENT_TIMELINE, "capacity", "tokens_per_sec", cap_tps,
        unit="tok/s", relative=1.0,
        params=dict(base_params, wall_s=cal_el, requests_per_sec=cap_rps,
                    mode="burst")))

    if slo:
        prefill_med = _pct([r.prefill_s for r in cal], 50)
        tpot_med = _pct([t for r in cal for t in r.decode_token_s], 50)
        eng.scheduler.slo = _slo_policy_from_measured(prefill_med, tpot_med)

    window = max(2 * duration, 0.4)
    for k, mult in enumerate(offered):
        rate = mult * cap_rps
        n = int(min(max(rate * window, 4), max_requests))
        if slo:
            # the slo_sweep-shaped trace: bursty, two classes
            stream = make_trace(TraceSpec(
                n_requests=n, base_rps=rate, classes=SLO_CLASSES,
                bursts=((0.25 * window, 0.25 * window, 3.0),),
                prompt_len_buckets=prompt_lens,
                max_new_buckets=(max_new // 2, max_new),
                vocab_size=cfg.vocab_size, seed=seed * 1000 + 20 + k))
        else:
            stream = make_stream(LoadSpec(
                n_requests=n, rate_rps=rate, prompt_lens=prompt_lens,
                max_new_tokens=max_new, vocab_size=cfg.vocab_size,
                seed=seed * 1000 + 10 + k))
        reqs = stream.requests
        span = reqs[-1].arrival_s if reqs else 0.0
        n0 = len(tr.events)
        t0 = time.perf_counter()
        eng.run(reqs, idle_hook=lambda: None,
                deadline_s=span + 2 * window)
        el = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in reqs)
        name = f"load_{mult:g}x"
        level = dict(base_params, offered_mult=mult, requested_rps=rate,
                     n_requests=n, completed=sum(r.done for r in reqs),
                     wall_s=el, shed=sum(r.t_shed is not None for r in reqs))
        records.append(Record(
            EXPERIMENT_TIMELINE, name, "tokens_per_sec", toks / el,
            unit="tok/s", relative=(toks / el) / cap_tps if cap_tps else None,
            params=dict(level)))
        # the tentpole row family: this level's engine-track span-time
        # decomposition — seconds per phase, relative = share of wall
        phases = obs_trace.span_times(tr.events[n0:], track="engine")
        for phase in sorted(phases):
            d = phases[phase]
            records.append(Record(
                EXPERIMENT_TIMELINE, f"{name}.{phase}", "span_time_s",
                d["total_s"], unit="s",
                relative=d["total_s"] / el if el else None,
                params=dict(level, span_count=d["count"])))

    # eager bucket-chain demo: the overlap stage spans land in the same
    # trace as real host timings
    with obs_trace.use(tr):
        a = torch.ones((32, 32), dtype=torch.float32, device=dev)
        for ov in (False, True):
            run_schedule_overlap = ov
            from repro_torch.parallel.overlap import run_schedule
            run_schedule(3, lambda i: a * (i + 1),
                         lambda buf: torch.tanh(buf),
                         run_schedule_overlap)

    snap = tr.metrics.snapshot()
    records.append(Record(
        EXPERIMENT_TIMELINE, "trace_summary", "trace_events",
        float(len(tr.events)), unit="events",
        params=dict(base_params, counters=snap["counters"],
                    kv_watermark=eng.kv.watermark(),
                    tracks=sorted({e["track"] for e in tr.events}))))
    if trace_out:
        tr.save(trace_out)
    return records
