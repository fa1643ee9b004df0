"""Render tables from experiment ``Record`` streams and dry-run JSONs.

Two consumers of the unified schema:

  * ``dryrun_records`` lifts compiled dry-run JSONs into Records — this is
    what the ``roofline.table`` experiment emits through the Runner.
  * ``records_table`` renders any Record stream (from ``Runner.run`` or
    read back via ``read_jsonl``) as a markdown table, replacing the
    per-module formatting the seed scattered across ``benchmarks/``.

``table`` keeps the original EXPERIMENTS.md roofline view.
"""
from __future__ import annotations

import glob
import json
import sys
from typing import Iterable

from repro_torch.experiments.record import Record

ROOFLINE_EXPERIMENT = "roofline.table"


def dryrun_records(dirname: str = "experiments/dryrun",
                   mesh: str = None) -> list[Record]:
    """One Record per dry-run cell: value = roofline fraction, params carry
    the three terms and the bottleneck."""
    records = []
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        d = json.load(open(f))
        if mesh and d["mesh"] != mesh:
            continue
        name = f"{d['arch']}.{d['shape']}.{d['mesh']}"
        records.append(Record(
            ROOFLINE_EXPERIMENT, name, "roofline_fraction",
            round(d["roofline_fraction"], 4),
            params={"bottleneck": d["bottleneck"],
                    "compute_s": d["compute_s"], "memory_s": d["memory_s"],
                    "collective_s": d["collective_s"],
                    "n_chips": d["n_chips"],
                    "useful_ratio": round(d["useful_ratio"], 4),
                    "peak_memory_bytes": d["peak_memory_bytes"]}))
    if not records:
        records.append(Record(
            ROOFLINE_EXPERIMENT, "-", "skip", skipped=True,
            reason=f"no dry-run artifacts in {dirname}; run: "
                   "python -m repro_torch.launch.dryrun --all --mesh both"))
    return records


def records_table(records: Iterable[Record]) -> str:
    """Markdown table over any unified-schema Record stream."""
    out = ["| experiment | name | metric | value | unit | relative | note |",
           "|---|---|---|---|---|---|---|"]
    for r in records:
        if r.skipped or r.error:
            note = ("ERROR: " if r.error else "SKIP: ") + r.reason
            out.append(f"| {r.experiment} | {r.name} | {r.metric} "
                       f"| | | | {note} |")
            continue
        val = (f"{r.value:.4g}" if isinstance(r.value, float) else
               "" if r.value is None else str(r.value))
        rel = f"{r.relative:.3f}" if r.relative is not None else ""
        out.append(f"| {r.experiment} | {r.name} | {r.metric} "
                   f"| {val} | {r.unit} | {rel} | |")
    return "\n".join(out)


SERVE_SWEEPS = ("serve.load_sweep", "serve.sharded_sweep",
                "serve.paged_attention", "serve.slo_sweep")


def serve_table(records: Iterable[Record]) -> str:
    """Latency-decomposition view of a serve-sweep Record stream
    (``serve.load_sweep``, ``serve.sharded_sweep`` and/or the engine half
    of ``serve.paged_attention``).

    One row per offered-load level: sustained throughput (and its
    fraction of burst capacity), the per-stage latency quantiles (TTFT /
    TPOT from the metrics, queue wait from params), and the probe
    kernel's headroom FLOP/s beside the engine.  Sharded-sweep levels are
    labelled with their tensor-parallel width, paged-engine levels with
    ``paged``, SLO-sweep levels with ``slo`` — a combined stream keeps
    the data paths distinguishable.  A ``serve.slo_sweep`` stream gets a
    second block: per (class, level) SLO attainment with the shed and
    preemption accounting (DESIGN.md section 15).
    """
    by_level: dict[tuple, dict] = {}
    slo_rows = []
    for r in records:
        if r.experiment not in SERVE_SWEEPS or r.skipped or r.error:
            continue
        if r.metric == "slo_attainment":
            slo_rows.append(r)
            continue
        if not r.name.startswith("load_"):
            continue
        d = by_level.setdefault((r.experiment, r.name), {"params": {}})
        d[r.metric] = r
        d["params"].update(r.params)
    out = ["| level | offered rps | tok/s | of cap | queue p50 ms | "
           "ttft p50/p99 ms | tpot p50/p99 ms | headroom GFLOP/s |",
           "|---|---|---|---|---|---|---|---|"]

    def ms(level, metric):
        r = level.get(metric)
        return f"{r.value * 1e3:.1f}" if r and r.value is not None else "-"

    def key(k):
        p = by_level[k]["params"]
        return (p.get("offered_mult", p.get("offered_rps", 0.0)), k[0])

    for exp, name in sorted(by_level, key=key):
        lvl = by_level[(exp, name)]
        p = lvl["params"]
        if exp == "serve.sharded_sweep":
            label = f"{name} tp{p.get('tp_size', '?')}"
        elif exp == "serve.paged_attention":
            label = f"{name} paged"
        elif exp == "serve.slo_sweep":
            label = f"{name} slo"
        else:
            label = name
        tps = lvl.get("tokens_per_sec")
        hr = lvl.get("headroom_flops_per_s")
        out.append(
            f"| {label} | {p.get('offered_rps', 0.0):.1f} "
            f"| {tps.value:.0f} | {tps.relative:.0%} "
            f"| {p.get('queue_wait_p50_s', 0.0) * 1e3:.1f} "
            f"| {ms(lvl, 'ttft_p50_s')}/{ms(lvl, 'ttft_p99_s')} "
            f"| {ms(lvl, 'tpot_p50_s')}/{ms(lvl, 'tpot_p99_s')} "
            f"| {hr.value / 1e9:.2f} |" if tps and hr else f"| {label} | "
            "incomplete level (missing tokens_per_sec/headroom rows) "
            "| | | | | | |")
    if slo_rows:
        out += ["",
                "| class level | class | attainment | requests | "
                "shed | preempt cycles | ttft target ms | tpot target ms |",
                "|---|---|---|---|---|---|---|---|"]
        for r in sorted(slo_rows, key=lambda r: (
                r.params.get("offered_mult", 0.0),
                r.params.get("rank", 0))):
            p = r.params
            t = p.get("targets", {})
            out.append(
                f"| {r.name} | {p.get('slo_class', '?')} "
                f"| {r.value:.0%} | {p.get('class_requests', 0)} "
                f"| {p.get('class_shed', 0)} "
                f"| {p.get('class_preempt_cycles', 0)} "
                f"| {t.get('ttft_s', 0.0) * 1e3:.1f} "
                f"| {t.get('tpot_s', 0.0) * 1e3:.1f} |")
    return "\n".join(out)


TIMELINE_EXPERIMENT = "serve.timeline"


def timeline_table(records: Iterable[Record]) -> str:
    """Span-time decomposition view of a ``serve.timeline`` Record stream.

    One row per offered-load level: throughput beside the fraction of
    engine wall time spent in each phase span (admit / prefill / decode /
    idle / fabric_stall), read off the ``span_time_s`` rows the
    experiment derives from its own trace.  The phase fractions are the
    trace *telling on* the engine: an overloaded level shows idle
    collapsing to zero while admit+decode saturate; a degraded-fabric
    level shows the stall column absorbing the difference.
    """
    by_level: dict[str, dict] = {}
    summary = None
    for r in records:
        if r.experiment != TIMELINE_EXPERIMENT or r.skipped or r.error:
            continue
        if r.metric == "trace_events":
            summary = r
            continue
        if not r.name.startswith("load_"):
            continue
        # level names carry dots (``load_0.5x``); phase names do not, so
        # split span rows (``load_0.5x.idle``) on the LAST dot and key
        # throughput rows by their whole name
        if r.metric == "span_time_s":
            level, _, phase = r.name.rpartition(".")
            if not level:
                continue
            d = by_level.setdefault(level, {"params": {}, "phases": {}})
            d["phases"][phase] = r
        elif r.metric == "tokens_per_sec":
            d = by_level.setdefault(r.name, {"params": {}, "phases": {}})
            d["tokens_per_sec"] = r
        else:
            continue
        d["params"].update(r.params)
    phase_names = sorted({p for d in by_level.values() for p in d["phases"]})
    out = ["| level | offered rps | tok/s | of cap | "
           + " | ".join(f"{p} %" for p in phase_names) + " |",
           "|---|---|---|---|" + "---|" * len(phase_names)]

    def frac(lvl, phase):
        r = lvl["phases"].get(phase)
        if r is None or r.relative is None:
            return "-"
        return f"{r.relative:.0%}"

    def key(level):
        return by_level[level]["params"].get("offered_mult", 0.0)

    for level in sorted(by_level, key=key):
        lvl = by_level[level]
        p = lvl["params"]
        tps = lvl.get("tokens_per_sec")
        if not tps:
            out.append(f"| {level} | incomplete level "
                       f"(no tokens_per_sec row) |" + " |" * (
                           2 + len(phase_names)))
            continue
        cols = " | ".join(frac(lvl, ph) for ph in phase_names)
        out.append(f"| {level} | {p.get('requested_rps', 0.0):.1f} "
                   f"| {tps.value:.0f} | {tps.relative:.0%} | {cols} |")
    if summary is not None:
        p = summary.params
        wm = p.get("kv_watermark", {})
        out += ["",
                f"trace: {summary.value} events across tracks "
                f"{', '.join(p.get('tracks', []))}; "
                f"kv peak {wm.get('peak_used', '?')} slots "
                f"({wm.get('peak_frac', 0.0):.0%} of pool)"]
    return "\n".join(out)


def fabric_table(records: Iterable[Record]) -> str:
    """Degraded-fabric view of a ``fabric.*`` Record stream.

    Collectives block: one row per (method, condition) with the two
    schedules' degradation, the overlap efficiency and its delta vs the
    clean wire.  Serve block: one row per condition with throughput, p99
    inflation and surviving probe headroom.
    """
    coll: dict[str, dict] = {}
    serve: dict[str, dict] = {}
    for r in records:
        if r.skipped or r.error:
            continue
        if r.experiment == "fabric.collectives_degraded":
            d = coll.setdefault(r.name, {"params": {}})
            d[r.metric] = r
            d["params"].update(r.params)
        elif r.experiment == "fabric.serve_tail":
            d = serve.setdefault(r.name, {"params": {}})
            d[r.metric] = r
            d["params"].update(r.params)
    out = []
    if coll:
        out += ["| method[condition] | serial x | pipelined x | "
                "overlap eff | vs clean | goodput MB/s |",
                "|---|---|---|---|---|---|"]
        for name in sorted(coll):
            lvl = coll[name]
            deg = lvl.get("degradation_x")
            eff = lvl.get("overlap_efficiency")
            gp = lvl.get("wire_goodput_bytes_per_s")
            if not (deg and eff):
                out.append(f"| {name} | incomplete row | | | | |")
                continue
            out.append(
                f"| {name} | {deg.value:.2f} "
                f"| {deg.params.get('pipelined_degradation_x', 0):.2f} "
                f"| {eff.value:.3f} "
                f"| {eff.params.get('overlap_efficiency_delta', 0):+.3f} "
                f"| {gp.value / 1e6:.1f} |" if gp else "")
    if serve:
        if out:
            out.append("")
        out += ["| condition | tok/s | vs clean | ttft p99 x | tpot p99 x "
                "| headroom GFLOP/s | stalled ms |",
                "|---|---|---|---|---|---|---|"]

        def x(lvl, metric):
            r = lvl.get(metric)
            return f"{r.value:.2f}" if r and r.value is not None else "-"

        for name in sorted(serve, key=lambda n: (n != "clean", n)):
            lvl = serve[name]
            p = lvl["params"]
            tps = lvl.get("tokens_per_sec")
            hr = lvl.get("headroom_flops_per_s")
            if not (tps and hr):
                out.append(f"| {name} | incomplete row | | | | | |")
                continue
            stalled = 1e3 * (p.get("stalled_admit_s", 0.0)
                             + p.get("stalled_decode_s", 0.0))
            out.append(
                f"| {name} | {tps.value:.0f} | {tps.relative:.0%} "
                f"| {x(lvl, 'ttft_p99_inflation_x')} "
                f"| {x(lvl, 'tpot_p99_inflation_x')} "
                f"| {hr.value / 1e9:.2f} | {stalled:.0f} |")
    return "\n".join(out)


def table(dirname: str = "experiments/dryrun", mesh: str = None) -> str:
    """The original roofline table over dry-run JSONs."""
    rows = []
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        d = json.load(open(f))
        if mesh and d["mesh"] != mesh:
            continue
        rows.append(d)
    rows.sort(key=lambda d: (d["arch"], d["shape"], d["mesh"]))
    out = ["| arch | shape | mesh | compute s | memory s | collective s | "
           "bound | peak GB/dev | MODEL/HLO | roofline |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['compute_s']:.3f} | {d['memory_s']:.3f} "
            f"| {d['collective_s']:.3f} | {d['bottleneck']} "
            f"| {d['peak_memory_bytes']/1e9:.2f} "
            f"| {d['useful_ratio']:.2f} | {d['roofline_fraction']:.2%} |")
    return "\n".join(out)


if __name__ == "__main__":
    print(table(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun",
                sys.argv[2] if len(sys.argv) > 2 else None))
