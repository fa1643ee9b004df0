"""Degraded-fabric characterization — the serving half.

Counterpart of ``repro/core/fabric.py``.  The paper's offload verdict is
only trustworthy if it survives a degraded data path; this family re-runs
a decision-driving measurement with a
:class:`repro_torch.fabric.FabricCondition` injected:

``fabric.serve_tail``
    The continuous-batching load sweep pinned at one offered level and
    re-run per condition with a ``ServeFabric`` mounted on the engine:
    p99 TTFT/TPOT inflation vs the clean run (rule 5's input), sustained
    throughput, and the idle-hook probe's surviving FLOP/s.  The token
    streams themselves stay identical across conditions (greedy decode,
    same requests) — only the latency surface moves.  It takes the
    serving family's ``width`` and ``device`` (``core/serving.py``).

``fabric.collectives_degraded`` re-measures the bucketed gradient
reduction over a degraded wire between ranks; the port runs one rank per
process group so far, and it raises until the multi-rank slice (ROADMAP
Queue 1 item 9).

The clean condition goes first so every degraded row can carry its
inflation vs clean in the same stream.
"""
from __future__ import annotations

import time
from typing import Sequence

from repro_torch.experiments.measure import measure as _measure
from repro_torch.experiments.record import Record
from repro_torch.fabric import FabricCondition, ServeFabric, \
    canonical_conditions

EXPERIMENT_COLLECTIVES = "fabric.collectives_degraded"
EXPERIMENT_SERVE = "fabric.serve_tail"

SERVE_CONDITIONS = ("clean", "jitter", "straggler")


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


def measure_collectives_degraded(duration: float = 0.3,
                                 device="cuda") -> list[Record]:
    """The bucketed reduction beside a compute payload, per condition x
    method x schedule — over ranks joined by a wire, a later slice of the
    port (ROADMAP Queue 1 item 9)."""
    raise NotImplementedError(
        "fabric.collectives_degraded needs collectives over more than one "
        "rank, a later slice of the port (ROADMAP Queue 1 item 9)")


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
