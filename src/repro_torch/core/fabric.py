"""Degraded-fabric characterization — every clean number, re-measured
under a misbehaving wire.

Counterpart of ``repro/core/fabric.py``.  The paper's offload verdict is
only trustworthy if it survives a degraded data path; this family re-runs
the two decision-driving measurements with a
:class:`repro_torch.fabric.FabricCondition` injected:

``fabric.collectives_degraded``
    ``inpath.headroom_overlap``'s rig — the bucketed reduction beside a
    synthetic compute payload — swept over condition x method x schedule,
    over ``devices`` ranks, one process a rank (``parallel/dist.py``,
    gloo), each injecting the condition into its own chains
    (``fabric/inject.py``; the straggler is one rank).  Per (method,
    condition): ``overlap_efficiency`` (t_pipelined / t_serial, the
    paired-median protocol of ``inpath``), ``degradation_x`` (serial wall
    vs the clean serial wall) and ``wire_goodput_bytes_per_s`` (modeled
    wire bytes over the degraded wall).  Rank 0's timings are the
    records.  On the card every rank shares the one card and the ranks
    exchange over gloo through host memory: the wire is loopback, not
    NVLink.

``fabric.serve_tail``
    The continuous-batching load sweep pinned at one offered level and
    re-run per condition with a ``ServeFabric`` mounted on the engine:
    p99 TTFT/TPOT inflation vs the clean run (rule 5's input), sustained
    throughput, and the idle-hook probe's surviving FLOP/s.  The token
    streams themselves stay identical across conditions (greedy decode,
    same requests) — only the latency surface moves.  It takes the
    serving family's ``width`` and ``device`` (``core/serving.py``).

The clean condition goes first so every degraded row can carry its
inflation vs clean in the same stream.
"""
from __future__ import annotations

import time
from typing import Sequence

import torch

from repro_torch import runtime
from repro_torch.core.inpath import _paired_ratio, _wire_bytes, \
    synth_compute
from repro_torch.experiments.measure import measure as _measure
from repro_torch.experiments.record import Record
from repro_torch.fabric import ChainInjector, FabricCondition, ServeFabric, \
    canonical_conditions
from repro_torch.parallel import collectives as C
from repro_torch.parallel import overlap as O
from repro_torch.parallel.dist import run_ranks
from repro_torch.parallel.pods import DistPodAxis

EXPERIMENT_COLLECTIVES = "fabric.collectives_degraded"
EXPERIMENT_SERVE = "fabric.serve_tail"

# condition x method defaults: ring isolates the schedule effect (no
# transform), int8_ring is the production compressed wire — the pair rule
# 1 compares under degradation
DEGRADED_METHODS = ("ring", "int8_ring")
DEGRADED_CONDITIONS = ("clean", "jitter", "straggler", "lossy")
SERVE_CONDITIONS = ("clean", "jitter", "straggler")

FABRIC_BUCKETS = 4
FABRIC_BUCKET_ELEMS = 1 << 14
# the compute payload riding beside the wire: sized so its wall is the
# same order as the clean reduction (a few ms) — small enough that a
# degraded wire dominates it, which is the effect under test
FABRIC_COMPUTE_DIM = 128
FABRIC_COMPUTE_ITERS = 8
FABRIC_DEVICES = 4


def _resolve(names: Sequence[str]) -> list[FabricCondition]:
    """Named canonical conditions, clean forced to the front — degraded
    rows are relative to the clean row of the same run."""
    canon = canonical_conditions()
    conds = []
    for name in names:
        if name not in canon:
            raise ValueError(f"unknown fabric condition {name!r} "
                             f"(canonical: {sorted(canon)})")
        conds.append(canon[name])
    conds.sort(key=lambda c: 0 if c.is_clean else 1)
    if not conds or not conds[0].is_clean:
        conds.insert(0, FabricCondition.clean())
    return conds


def measure_collectives_degraded(
        duration: float = 0.3,
        methods: Sequence[str] = DEGRADED_METHODS,
        conditions: Sequence[str] = DEGRADED_CONDITIONS,
        n_buckets: int = FABRIC_BUCKETS,
        bucket_elems: int = FABRIC_BUCKET_ELEMS,
        compute_dim: int = FABRIC_COMPUTE_DIM,
        compute_iters: int = FABRIC_COMPUTE_ITERS,
        devices: int = FABRIC_DEVICES, device="cuda") -> list[Record]:
    """Condition x method x schedule sweep of the bucketed reduction
    beside a compute payload (the headroom_overlap rig, degraded), over
    ``devices`` gloo ranks on ``device``; rank 0's records."""
    if devices < 2:
        raise RuntimeError("degraded-collectives measurement needs >= 2 "
                           f"ranks, got {devices}")
    conds = _resolve(conditions)
    for cond in conds:
        if cond.straggler_device is not None \
                and cond.straggler_device >= devices:
            raise RuntimeError(
                f"condition {cond.name!r} designates straggler device "
                f"{cond.straggler_device}, only {devices} ranks present")
    return run_ranks(_collectives_degraded_rank, devices, backend="gloo",
                     device=device,
                     args=(duration, tuple(methods),
                           tuple(c.name for c in conds), n_buckets,
                           bucket_elems, compute_dim, compute_iters))[0]


def _collectives_degraded_rank(pods: DistPodAxis, duration, methods,
                               conditions, n_buckets, bucket_elems,
                               compute_dim, compute_iters) -> list[Record]:
    """One rank of :func:`measure_collectives_degraded`: every rank draws
    the whole ``(n, ...)`` inputs from seed 0 and keeps its row."""
    from repro_torch.fabric.inject import calibrate
    n, r, dev = pods.n, pods.rank, pods.device
    conds = _resolve(conditions)
    calibrate(pods, dev)
    gen = torch.Generator().manual_seed(0)
    full = {f"w{i}": torch.randn((n, bucket_elems), generator=gen)
            for i in range(n_buckets)}
    tree = {k: v[r:r + 1].to(dev) for k, v in full.items()}
    want = {k: v.mean(dim=0, keepdim=True).to(dev) for k, v in full.items()}
    payloads = [4 * bucket_elems] * n_buckets
    d = compute_dim
    a = (torch.randn((n, d, d), generator=gen) / d)[r:r + 1].to(dev)

    def step(method, overlapped, cond):
        def f(t, m):
            return O.overlap_compute(
                lambda: C.reduce_gradients(
                    t, pods, method, None, bucketed=True,
                    bucket_bytes=bucket_elems * 4, overlap=overlapped,
                    fabric=cond)[0],
                lambda x: synth_compute(x, compute_iters), m,
                overlap=overlapped)
        return f

    def max_err(out):
        return max(float((out[0][k] - want[k]).abs().max()) for k in tree)

    records: list[Record] = []
    # pin the transform impl, as in inpath: this sweep isolates the wire
    # scenario, not a kernel-placement switch
    with runtime.use_policy(quant_impl="torch"):
        for method in methods:
            eff_clean = t_serial_clean = t_over_clean = None
            wire = n_buckets * _wire_bytes(n, bucket_elems, method)
            for cond in conds:
                f_serial = step(method, False, cond)
                f_over = step(method, True, cond)
                # correctness probe: the injection must be value-neutral
                err = max(max_err(f_serial(tree, a)),
                          max_err(f_over(tree, a)))
                eff, t_serial, t_over, rounds = _paired_ratio(
                    f_serial, f_over, (tree, a), duration,
                    agree=pods.all_true)
                # what this condition injected, re-sampled from the same
                # seed the chains used
                inj = ChainInjector(cond, pods, payloads)
                base = dict(cond.params(), condition=cond.name,
                            method=method, devices=n, n_buckets=n_buckets,
                            bucket_elems=bucket_elems,
                            compute_dim=d, compute_iters=compute_iters,
                            t_serial_s=t_serial, t_overlapped_s=t_over,
                            injected_common_s=inj.injected_s,
                            paired_rounds=rounds, max_error=err,
                            wire_bytes_per_device=wire)
                if cond.is_clean:
                    eff_clean, t_serial_clean, t_over_clean = \
                        eff, t_serial, t_over
                name = f"{method}[{cond.name}]"
                records.append(Record(
                    EXPERIMENT_COLLECTIVES, name, "overlap_efficiency",
                    eff, unit="x", relative=eff,
                    params=dict(base, overlap_efficiency_clean=eff_clean,
                                overlap_efficiency_delta=eff - eff_clean)))
                deg_serial = t_serial / t_serial_clean
                deg_over = t_over / t_over_clean
                records.append(Record(
                    EXPERIMENT_COLLECTIVES, name, "degradation_x",
                    deg_serial, unit="x", relative=deg_serial,
                    params=dict(base, schedule="serial",
                                pipelined_degradation_x=deg_over)))
                goodput = wire / t_serial
                records.append(Record(
                    EXPERIMENT_COLLECTIVES, name,
                    "wire_goodput_bytes_per_s", goodput, unit="B/s",
                    relative=goodput / (wire / t_serial_clean),
                    params=dict(base)))
    return records


def measure_serve_tail(duration: float = 0.3,
                       conditions: Sequence[str] = SERVE_CONDITIONS,
                       arch: str = "olmo-1b", n_slots: int = 4,
                       cache_len: int = 64, block_size: int = 8,
                       prompt_lens: tuple = (8, 16), max_new: int = 8,
                       offered_mult: float = 0.5,
                       max_requests: int = 24, width: str = "smoke",
                       device="cuda") -> list[Record]:
    """One load level, re-served per fabric condition: tail inflation."""
    from repro_torch.core.serving import _make_probe, _pct, _smoke_engine
    from repro_torch.serve.loadgen import LoadSpec, make_requests

    cfg, _, eng = _smoke_engine(arch, n_slots, cache_len, block_size,
                                width, device)
    run_probe, probe_flops = _make_probe(device=eng.device)
    conds = _resolve(conditions)
    records: list[Record] = []

    # burst calibration (also warms every compile out of the sweep)
    cal = make_requests(LoadSpec(n_requests=2 * n_slots, rate_rps=0.0,
                                 prompt_lens=prompt_lens,
                                 max_new_tokens=max_new,
                                 vocab_size=cfg.vocab_size))
    eng.generate(cal)
    cal2 = make_requests(LoadSpec(n_requests=2 * n_slots, rate_rps=0.0,
                                  prompt_lens=prompt_lens,
                                  max_new_tokens=max_new,
                                  vocab_size=cfg.vocab_size, seed=1))
    t0 = time.perf_counter()
    eng.generate(cal2)
    cal_el = time.perf_counter() - t0
    cap_rps = sum(len(r.generated) for r in cal2) / cal_el / max_new

    m_idle = _measure(run_probe, min(max(duration, 0.05), 0.25))
    idle_fps = probe_flops * m_idle.calls_per_sec

    window = max(2 * duration, 0.4)
    rate = offered_mult * cap_rps
    n_req = int(min(max(rate * window, 4), max_requests))
    spec = LoadSpec(n_requests=n_req, rate_rps=rate,
                    prompt_lens=prompt_lens, max_new_tokens=max_new,
                    vocab_size=cfg.vocab_size, seed=10)
    base_params = {"arch": cfg.name, "n_slots": n_slots,
                   "cache_len": cache_len, "block_size": block_size,
                   "offered_mult": offered_mult, "offered_rps": rate,
                   "n_requests": n_req, "max_new_tokens": max_new,
                   "prompt_lens": list(prompt_lens),
                   "probe_flops_per_s_idle": idle_fps}

    clean = {}
    for cond in conds:
        # the engine is condition-independent (the hooks are host-side
        # sleeps); swap the fabric on the shared engine instead of
        # rebuilding it per condition
        fab = ServeFabric(cond)
        eng.fabric = None if fab.is_clean else fab
        reqs = make_requests(spec)      # same stream every condition
        probe_calls = 0

        def hook():
            nonlocal probe_calls
            run_probe()
            probe_calls += 1

        t0 = time.perf_counter()
        eng.run(reqs, idle_hook=hook)
        el = time.perf_counter() - t0
        eng.fabric = None
        toks = sum(len(r.generated) for r in reqs)
        tps = toks / el
        ttft = [r.ttft_s for r in reqs]
        tok_lat = [t for r in reqs for t in r.decode_token_s]
        ttft_p99 = _pct(ttft, 99)
        tpot_p99 = _pct(tok_lat, 99) if tok_lat else 0.0
        headroom_fps = probe_calls * probe_flops / el
        if cond.is_clean:
            clean = {"tps": tps, "ttft_p99": ttft_p99,
                     "tpot_p99": tpot_p99, "headroom": headroom_fps}
        level = dict(base_params, **cond.params(), condition=cond.name,
                     wall_s=el, completed=sum(r.done for r in reqs),
                     sustained=bool(tps >= 0.9 * rate * max_new),
                     stalled_admit_s=fab.stalled_s["admit"],
                     stalled_decode_s=fab.stalled_s["decode"],
                     ttft_p50_s=_pct(ttft, 50),
                     tpot_p50_s=_pct(tok_lat, 50) if tok_lat else 0.0,
                     probe_calls=probe_calls)
        records.append(Record(
            EXPERIMENT_SERVE, cond.name, "tokens_per_sec", tps,
            unit="tok/s", relative=tps / clean["tps"], params=dict(level)))
        records.append(Record(
            EXPERIMENT_SERVE, cond.name, "ttft_p99_s", ttft_p99, unit="s",
            params=dict(level)))
        records.append(Record(
            EXPERIMENT_SERVE, cond.name, "ttft_p99_inflation_x",
            ttft_p99 / clean["ttft_p99"] if clean["ttft_p99"] else 1.0,
            unit="x",
            relative=ttft_p99 / clean["ttft_p99"] if clean["ttft_p99"]
            else 1.0, params=dict(level)))
        if tok_lat:
            records.append(Record(
                EXPERIMENT_SERVE, cond.name, "tpot_p99_s", tpot_p99,
                unit="s", params=dict(level)))
            records.append(Record(
                EXPERIMENT_SERVE, cond.name, "tpot_p99_inflation_x",
                tpot_p99 / clean["tpot_p99"] if clean["tpot_p99"] else 1.0,
                unit="x",
                relative=tpot_p99 / clean["tpot_p99"] if clean["tpot_p99"]
                else 1.0, params=dict(level)))
        records.append(Record(
            EXPERIMENT_SERVE, cond.name, "headroom_flops_per_s",
            headroom_fps, unit="flop/s",
            relative=headroom_fps / clean["headroom"]
            if clean["headroom"] else None,
            params=dict(level)))
    return records
