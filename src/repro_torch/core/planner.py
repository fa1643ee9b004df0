"""Offload planner — the paper's "what is profitable to offload" decision,
turned into configuration.

Inputs: the cell's roofline terms (from the dry-run) + the stressor
profitability ranking (from the suite).  Output: an ``OffloadPlan`` that
configures the training step — the paper's Table III, made executable.

Decision rules (each traceable to a paper finding, see DESIGN.md section 6):
  1. collective-bound + compute headroom  -> in-path int8 compression
     (paper: offload transparent compression/encryption into the path).
  2. compute-bound -> nothing extra in-path (paper: the BF-2's cores cannot
     even saturate the link through the kernel stack; don't add work).
  3. memory-bound  -> prefer dots_saveable remat (recompute less, keep
     matmul outputs) and larger microbatches.
  4. quant kernel placement: use the Pallas int8 kernel only if the quant
     stressor shows the device beats the reference platform (paper: offload
     only operations the device is relatively good at).
  5. serve-side offload: extra work rides beside the serving engine only
     while the serve-sweep probe keeps clearing a FLOP/s floor at every
     *sustained* load level (paper: headroom measured under traffic, not
     at idle, decides what the device can absorb).  A
     ``serve.sharded_sweep`` stream — headroom beside tensor-parallel
     decode, where the probe contends with live collectives — outranks
     the single-device ``serve.load_sweep`` when both are present.

Degraded-fabric arm (``fabric_records``, the ``fabric.*`` family): when a
degraded-wire stream is present the clean-wire verdicts are re-litigated
under it — the paper's offload win evaporates exactly when the data path
misbehaves, so a decision that only holds on a clean wire is not a
decision.  Rule 1 withdraws the int8 in-path transform if its degraded
wall falls behind the uncompressed method's; rule 1b withdraws the
pipelined schedule when degradation erases its advantage (degraded
``overlap_efficiency`` ~ 1: the injected delay dominates both schedules'
critical paths, so the pipeline's extra structure buys nothing); rule 5
withdraws the serve offload when degraded p99 TTFT/TPOT inflation
exceeds the ``fabric_p99_inflation_max`` policy knob or the degraded
probe headroom falls under the serving floor.  The whole analysis is
recorded on ``OffloadPlan.fabric_sensitivity``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.core.classes import ranking
from repro_torch.core.headroom import RooflineTerms, derived_headroom
from repro_torch.experiments.record import Record


@dataclass
class OffloadPlan:
    dp_method: str = "stock"
    use_quant_kernel: bool = False
    dp_bucket_bytes: Optional[int] = None   # bucket-granularity compression
    dp_overlap: Optional[bool] = None       # bucket-chain schedule: True =
    #                                 software-pipelined (chain i in flight
    #                                 while bucket i+1 packs), False =
    #                                 strictly serial, None = auto at trace
    #                                 time (pipeline when >1 bucket)
    remat: str = "full"
    microbatches: int = 1
    serve_offload: Optional[bool] = None    # rule 5: extra work beside the
    #                                 serving engine — None when no
    #                                 serve.load_sweep stream was provided
    fabric_sensitivity: Optional[dict] = None   # degraded-fabric analysis
    #                                 (fabric_sensitivity_assessment) —
    #                                 None when no fabric.* stream was
    #                                 provided, i.e. the plan is clean-wire
    #                                 only and its verdicts are unhedged
    notes: list = field(default_factory=list)
    ranking: list = field(default_factory=list)


# Rule 5 reads these sweeps in preference order: the sharded sweep —
# where the probe contends with live decode collectives, not just decode
# compute — is the trustworthy measurement when present; the SLO sweep is
# next (probe beside policy-controlled trace traffic — the admission
# regime an offloaded deployment would actually run); then the paged
# sweep (probe beside paged-pool decode traffic); the single-device dense
# sweep is the fallback.
SERVE_SWEEP_EXPERIMENTS = ("serve.sharded_sweep", "serve.slo_sweep",
                           "serve.paged_attention", "serve.load_sweep")


def serve_offload_assessment(serve_records: Iterable[Record],
                             min_headroom_flops: Optional[float] = None
                             ) -> dict:
    """Rule 5's input: probe headroom per offered-load level.

    Reads the serve-sweep rows (``headroom_flops_per_s`` per ``load_*``
    level — the probe kernel's achieved FLOP/s beside the engine) and
    decides whether serve-side offloaded work is profitable: the *worst*
    headroom across levels that sustained their offered load must clear
    ``min_headroom_flops`` (default: the ``serve_headroom_min_gflops``
    runtime policy knob).  Levels past saturation (offered load not
    sustained) are excluded — at those the engine itself is already
    failing its traffic, and the paper's rule 2 applies instead: don't
    add work to a saturated processor.

    When the stream carries both ``serve.sharded_sweep`` and
    ``serve.load_sweep`` rows the sharded sweep wins (the offload
    verdict is only trustworthy where decode collectives and the probe
    genuinely contend); ``source`` records which stream decided.

    SLO arm: when the stream carries ``serve.slo_sweep`` attainment
    rows, the headroom floor is no longer the whole verdict — the
    highest-priority class must also attain its SLO at fraction
    ``min_slo_attainment`` (default: the ``serve_slo_attainment_min``
    policy knob) at every *sustained* level.  An engine whose probe
    still clears the FLOP/s floor while its interactive traffic misses
    its targets has no headroom to sell — the static floor graduated to
    an SLO-conditional verdict (DESIGN.md section 15).  ``slo_ok`` is
    None when no attainment evidence was provided (verdict unchanged),
    True/False otherwise.
    """
    from repro_torch import runtime
    if min_headroom_flops is None:
        min_headroom_flops = \
            float(runtime.policy()["serve_headroom_min_gflops"]) * 1e9
    min_slo_attainment = \
        float(runtime.policy()["serve_slo_attainment_min"])
    by_exp: dict[str, dict[str, float]] = {}
    sustained: dict[tuple[str, str], bool] = {}
    slo_rows: list[Record] = []
    for r in serve_records:
        if r.skipped or r.error:
            continue
        if r.experiment == "serve.slo_sweep" \
                and r.metric == "slo_attainment":
            slo_rows.append(r)
            continue
        if r.metric != "headroom_flops_per_s":
            continue
        if r.experiment not in SERVE_SWEEP_EXPERIMENTS:
            continue        # a combined run stream carries other families
        if not r.name.startswith("load_"):
            continue        # the probe_idle reference row is not a level
        by_exp.setdefault(r.experiment, {})[r.name] = float(r.value)
        sustained[(r.experiment, r.name)] = \
            bool(r.params.get("sustained", True))
    source = next((e for e in SERVE_SWEEP_EXPERIMENTS if by_exp.get(e)),
                  None)
    levels = by_exp.get(source, {})
    usable = {n: v for n, v in levels.items() if sustained[(source, n)]}
    worst = min(usable.values()) if usable else 0.0

    slo_ok: Optional[bool] = None
    slo_class = None
    worst_att = None
    slo_levels: dict[str, float] = {}
    if slo_rows:
        top_rank = min(int(r.params.get("rank", 0)) for r in slo_rows)
        top = [r for r in slo_rows
               if int(r.params.get("rank", 0)) == top_rank]
        slo_class = top[0].params.get("slo_class")
        gated = [r for r in top if r.params.get("sustained", True)]
        slo_levels = {r.name: float(r.value) for r in gated}
        if gated:
            worst_att = min(slo_levels.values())
            slo_ok = worst_att >= min_slo_attainment
        # attainment rows exist but no level sustained: the engine is
        # saturated everywhere — no usable SLO evidence either way
    profitable = bool(usable) and worst >= min_headroom_flops
    if slo_ok is False:
        profitable = False
    return {
        "profitable": profitable,
        "worst_headroom_flops": worst,
        "threshold_flops": min_headroom_flops,
        "levels": levels,
        "sustained_levels": sorted(usable),
        "source": source,
        "slo_ok": slo_ok,
        "slo_class": slo_class,
        "worst_slo_attainment": worst_att,
        "slo_attainment_min": min_slo_attainment,
        "slo_levels": slo_levels,
    }


# Degraded overlap_efficiency at or above this means the pipelined
# schedule's advantage did not survive the degradation (t_pipelined ~
# t_serial: the injected delay owns both critical paths) — rule 1b's
# futility cutoff, applied to the median across degraded conditions.
OVERLAP_FUTILE_EFF = 0.95


def _median(vals):
    s = sorted(vals)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def fabric_sensitivity_assessment(fabric_records: Iterable[Record],
                                  max_p99_inflation_x: Optional[float]
                                  = None,
                                  min_headroom_flops: Optional[float]
                                  = None) -> dict:
    """The degraded-fabric arm's input: how each clean-wire verdict held
    up under the ``fabric.*`` stream.

    From ``fabric.collectives_degraded``: per-method walls under each
    degraded condition (rule 1 — does the int8 transform still beat the
    uncompressed wire when the wire misbehaves?) and the degraded
    ``overlap_efficiency`` (rule 1b — did the pipelined schedule's
    advantage survive?).  From ``fabric.serve_tail``: worst p99 TTFT/TPOT
    inflation vs clean and worst degraded probe headroom (rule 5).
    Fields for an absent experiment stay None — each rule hedges only on
    evidence it actually has.
    """
    from repro_torch import runtime
    if max_p99_inflation_x is None:
        max_p99_inflation_x = \
            float(runtime.policy()["fabric_p99_inflation_max"])
    if min_headroom_flops is None:
        min_headroom_flops = \
            float(runtime.policy()["serve_headroom_min_gflops"]) * 1e9

    eff: dict[tuple, float] = {}          # (method, condition) -> eff
    wall: dict[tuple, float] = {}         # (method, condition) -> serial s
    inflation: dict[tuple, float] = {}    # (metric, condition) -> x
    headroom: dict[str, float] = {}       # condition -> flop/s
    for r in fabric_records:
        if r.skipped or r.error:
            continue
        cond = r.params.get("condition")
        if r.experiment == "fabric.collectives_degraded":
            method = r.params.get("method")
            if r.metric == "overlap_efficiency":
                eff[(method, cond)] = float(r.value)
                wall[(method, cond)] = float(r.params.get("t_serial_s", 0))
        elif r.experiment == "fabric.serve_tail":
            if r.metric in ("ttft_p99_inflation_x", "tpot_p99_inflation_x"):
                inflation[(r.metric, cond)] = float(r.value)
            elif r.metric == "headroom_flops_per_s":
                headroom[cond] = float(r.value)

    degraded = sorted({c for _, c in eff if c != "clean"}
                      | {c for _, c in inflation if c != "clean"}
                      | {c for c in headroom if c != "clean"})

    # rule 1b evidence: median degraded efficiency across (method, cond)
    deg_effs = [v for (_, c), v in eff.items() if c != "clean"]
    overlap_futile = (_median(deg_effs) >= OVERLAP_FUTILE_EFF
                      if deg_effs else None)

    # rule 1 evidence: per degraded condition, the int8 wall vs the
    # uncompressed wall (ring if measured, else stock); 10% slack keeps a
    # timing wobble from withdrawing a genuinely-held win
    methods = {m for m, _ in eff}
    plain = "ring" if "ring" in methods else (
        "stock" if "stock" in methods else None)
    int8s = sorted(m for m in methods if m.startswith("int8"))
    compression_robust = None
    losing: list = []
    if plain and int8s:
        checked = False
        for c in degraded:
            pw = wall.get((plain, c))
            for m in int8s:
                iw = wall.get((m, c))
                if pw and iw:
                    checked = True
                    if iw > 1.1 * pw:
                        losing.append({"method": m, "condition": c,
                                       "wall_s": iw, "plain_wall_s": pw})
        compression_robust = not losing if checked else None

    # rule 5 evidence; the headroom clause binds only when the clean run
    # itself cleared the floor — a probe starved even on the clean wire is
    # a clean-wire problem (serve_offload_assessment's job), not fabric
    # damage, and must not masquerade as it
    deg_infl = [v for (_, c), v in inflation.items() if c != "clean"]
    worst_inflation = max(deg_infl) if deg_infl else None
    deg_head = [v for c, v in headroom.items() if c != "clean"]
    min_degraded_headroom = min(deg_head) if deg_head else None
    headroom_binds = (min_degraded_headroom is not None
                      and headroom.get("clean", 0.0) >= min_headroom_flops)
    serve_ok = None
    if worst_inflation is not None or headroom_binds:
        serve_ok = ((worst_inflation is None
                     or worst_inflation <= max_p99_inflation_x)
                    and (not headroom_binds
                         or min_degraded_headroom >= min_headroom_flops))

    return {
        "conditions": degraded,
        "overlap_efficiency": {f"{m}[{c}]": v
                               for (m, c), v in sorted(eff.items())},
        "overlap_futile": overlap_futile,
        "overlap_futile_eff": OVERLAP_FUTILE_EFF,
        "compression_robust": compression_robust,
        "compression_losing": losing,
        "worst_p99_inflation_x": worst_inflation,
        "p99_inflation_max_x": max_p99_inflation_x,
        "min_degraded_headroom_flops": min_degraded_headroom,
        "headroom_floor_flops": min_headroom_flops,
        "serve_offload_ok": serve_ok,
    }


def make_plan(terms: RooflineTerms, stressor_records: Iterable[Record],
              multi_pod: bool = True,
              bytes_per_device: Optional[float] = None,
              hbm_bytes: float = 80e9,  # NVIDIA H100 80GB HBM3
              grad_bytes: Optional[float] = None,
              serve_records: Optional[Iterable[Record]] = None,
              fabric_records: Optional[Iterable[Record]] = None
              ) -> OffloadPlan:
    """Decide the offload configuration from the roofline terms plus the
    unified ``Record`` stream of the stressor suite (``stressors.suite``
    rows, as emitted by the experiment Runner or read back from JSONL).

    ``fabric_records`` (a ``fabric.*`` stream) arms the degraded-fabric
    rules: rules 1/1b/5 re-check their clean-wire verdicts against the
    degraded measurements and withdraw any that did not survive (module
    docstring; the analysis lands on ``plan.fabric_sensitivity``)."""
    plan = OffloadPlan()
    fab = (fabric_sensitivity_assessment(fabric_records)
           if fabric_records is not None else None)
    hr = derived_headroom(terms)
    plan.notes.append(f"bottleneck={hr['bottleneck']} "
                      f"headroom={hr['headroom_fraction']:.1%} "
                      f"({hr['free_offload_gflops']:.1f} GFLOP free per step)")

    rank = ranking(stressor_records)
    plan.ranking = [(r.name, r.relative) for r in rank]
    by_name = {r.name: r for r in rank}

    # rule 1/2: in-path compression across the slow axis
    if multi_pod and hr["bottleneck"] == "collective" \
            and hr["headroom_fraction"] > 0.05:
        plan.dp_method = "int8_a2a"
        from repro_torch.parallel.buckets import DEFAULT_BUCKET_BYTES
        plan.dp_bucket_bytes = DEFAULT_BUCKET_BYTES
        plan.notes.append("collective-bound with headroom: int8 in-path "
                          "gradient compression enabled at bucket "
                          "granularity — one chain per fusion buffer, not "
                          "per leaf (paper sec. III-B3: transparent "
                          "compression is a profitable offload only while "
                          "the transform keeps up with the link)")
        # rule 1b: overlap the bucket chains only when there will be more
        # than one — a single chain has nothing to pipeline against (the
        # paper's headroom-during-transfer: compute is free only while a
        # transfer is actually in flight).  Without a gradient-size
        # estimate, leave the trace-time auto rule (same >1-bucket cutoff,
        # resolved against the real bucket plan) in charge.
        if grad_bytes is not None:
            n_buckets = -(-int(grad_bytes) // plan.dp_bucket_bytes)
            plan.dp_overlap = n_buckets > 1
            plan.notes.append(
                f"~{n_buckets} gradient bucket(s) at "
                f"{plan.dp_bucket_bytes >> 20} MiB: bucket-chain overlap "
                + ("ON (pipelined schedule hides pack/quantize behind the "
                   "in-flight exchange)" if plan.dp_overlap else
                   "left serial (single chain, nothing to overlap)"))
        # rule 1, degraded arm: the transform must win on the degraded
        # wire too — a compression that collapses under jitter/straggler
        # loses the offload decision outright
        if fab is not None and fab["compression_robust"] is False:
            worst = fab["compression_losing"][0]
            plan.dp_method = "stock"
            plan.dp_bucket_bytes = None
            plan.notes.append(
                f"rule 1 WITHDRAWN under degraded fabric: "
                f"{worst['method']} wall {worst['wall_s'] * 1e3:.1f} ms vs "
                f"uncompressed {worst['plain_wall_s'] * 1e3:.1f} ms under "
                f"'{worst['condition']}' — the int8 transform wins the "
                "clean wire but loses the degraded one; falling back to "
                "the stock reduction")
        # rule 1b, degraded arm: keep the pipelined schedule only if its
        # advantage survives degradation; when degraded efficiency sits
        # at ~1 the injected delay owns both schedules' critical paths
        if fab is not None and fab["overlap_futile"] \
                and plan.dp_overlap is not False:
            plan.dp_overlap = False
            plan.notes.append(
                "rule 1b WITHDRAWN under degraded fabric: median degraded "
                "overlap_efficiency >= "
                f"{fab['overlap_futile_eff']:.2f} across "
                f"{len(fab['conditions'])} condition(s) — the pipelined "
                "schedule's advantage does not survive a degraded wire; "
                "bucket chains stay serial")
    else:
        plan.notes.append("in-path compression NOT enabled "
                          "(paper sec. II-B1: don't add work to a saturated "
                          "processor)" if hr["bottleneck"] == "compute" else
                          "in-path compression not needed (not collective-bound)")

    # rule 3: memory pressure
    if hr["bottleneck"] == "memory" or (
            bytes_per_device is not None and bytes_per_device > 0.75 * hbm_bytes):
        plan.remat = "full"
        plan.microbatches = 2
        plan.notes.append("memory-pressured: full remat + 2 microbatches")
    elif hr["bottleneck"] == "compute":
        plan.remat = "dots_saveable"
        plan.notes.append("compute-bound: dots_saveable remat (don't "
                          "recompute matmuls)")

    # rule 4: quant kernel only where the device is relatively strong
    q = by_name.get("quant-int8")
    if q is not None and q.relative is not None and q.relative > 1.0:
        plan.use_quant_kernel = True
        plan.notes.append(
            f"quant-int8 stressor relative={q.relative:.1f}x reference: "
            "Pallas quant kernel placed in the collective path")

    # rule 5: serve-side offload only while measured headroom under load
    # clears the floor (paper: the decision is made under sustained
    # traffic, not from the idle rate)
    if serve_records is not None:
        a = serve_offload_assessment(serve_records)
        plan.serve_offload = a["profitable"]
        plan.notes.append(
            f"serve offload {'ON' if a['profitable'] else 'OFF'}: worst "
            f"sustained-load probe headroom "
            f"{a['worst_headroom_flops'] / 1e9:.2f} GFLOP/s vs "
            f"{a['threshold_flops'] / 1e9:.2f} floor over "
            f"{len(a['sustained_levels'])} sustained level(s) "
            f"[{a['source'] or 'no sweep rows'}]"
            + ("" if a["sustained_levels"] else
               " — no level sustained its offered load; rule 2 applies "
               "(don't add work to a saturated engine)"))
        if a["slo_ok"] is not None:
            plan.notes.append(
                f"rule 5 SLO arm {'OK' if a['slo_ok'] else 'FAILED'}: "
                f"'{a['slo_class']}' class worst attainment "
                f"{a['worst_slo_attainment']:.2f} vs "
                f"{a['slo_attainment_min']:.2f} floor over "
                f"{len(a['slo_levels'])} sustained level(s)"
                + ("" if a["slo_ok"] else
                   " — headroom beside traffic that misses its SLOs is "
                   "not sellable; offload withheld"))
        # rule 5, degraded arm: a verdict earned on a clean wire is
        # withdrawn when degraded tails blow past the tolerated p99
        # inflation or the degraded probe headroom falls under the floor
        if plan.serve_offload and fab is not None \
                and fab["serve_offload_ok"] is False:
            plan.serve_offload = False
            why = []
            if fab["worst_p99_inflation_x"] is not None and \
                    fab["worst_p99_inflation_x"] > fab["p99_inflation_max_x"]:
                why.append(f"p99 inflation {fab['worst_p99_inflation_x']:.1f}x "
                           f"> tolerated {fab['p99_inflation_max_x']:.1f}x")
            if fab["min_degraded_headroom_flops"] is not None and \
                    fab["min_degraded_headroom_flops"] \
                    < fab["headroom_floor_flops"]:
                why.append(
                    "degraded probe headroom "
                    f"{fab['min_degraded_headroom_flops'] / 1e9:.2f} GFLOP/s "
                    f"< {fab['headroom_floor_flops'] / 1e9:.2f} floor")
            plan.notes.append("rule 5 WITHDRAWN under degraded fabric: "
                              + "; ".join(why))
    if fab is not None:
        plan.fabric_sensitivity = fab
    return plan
