"""Built-in experiment registrations of the port — the paper's serving
figures as registry entries.

Counterpart of ``repro/experiments/defs.py`` for the families ported so
far: ``serve.*`` and ``fabric.serve_tail`` under the reference's names,
classes, figures and descriptions.  Each adapter takes the Runner's
``duration`` and the ``device`` the run is on (the card unless the
caller asks for the CPU).  ``serve.sharded_sweep`` and
``fabric.collectives_degraded`` need more than one device: on one card
the Runner SKIPs them, as the reference's does on one device, and their
bodies raise until the port runs more than one rank (ROADMAP Queue 1
item 9).  The ``headroom``, ``stressors``, ``classes``, ``inpath`` and
``roofline`` families are not ported yet and are not registered.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.experiments.record import Record
from repro_torch.experiments.registry import experiment


@experiment("serve.load_sweep", classes=("CPU", "MEMORY"),
            figure="Fig. 2/4 (transposed to serving)",
            description="offered-load sweep of the continuous-batching "
                        "engine: sustained throughput, p50/p99 TTFT/TPOT, "
                        "probe-kernel headroom beside the traffic")
def _serve_load_sweep(*, duration: float,
                      device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.load_sweep(duration=duration, device=device)


@experiment("serve.sharded_sweep", classes=("CPU", "NETWORK"),
            requires_devices=2, figure="Fig. 2/4 (serving, sharded)",
            description="offered-load sweep with tensor-parallel decode "
                        "over the mesh: p50/p99 TTFT/TPOT, pinned decode "
                        "collective counts, probe headroom beside the "
                        "sharded traffic")
def _serve_sharded_sweep(*, duration: float,
                         device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.sharded_sweep(duration=duration, device=device)


@experiment("serve.paged_attention", classes=("CPU", "MEMORY"),
            figure="(paged-KV decode characterization)",
            description="page-size x buffer-depth sweep of the ragged "
                        "paged-attention walk: attention tokens/s per "
                        "combination, page-granular KV bytes vs ideal, "
                        "probe headroom beside a paged engine")
def _serve_paged(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.paged_sweep(duration=duration, device=device)


@experiment("serve.slo_sweep", classes=("CPU", "MEMORY"),
            figure="(SLO-driven admission control loop)",
            description="bursty two-class trace at offered-load multiples "
                        "under SLO-driven admission (priority, preemption, "
                        "shed): attainment per class x level, shed "
                        "fraction, probe headroom beside the traffic")
def _serve_slo(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.slo_sweep(duration=duration, device=device)


@experiment("serve.timeline", classes=("CPU",),
            figure="(span-time decomposition)",
            description="traced serve runs: engine-track span-time "
                        "decomposition per load level (admit/prefill/"
                        "decode/idle/fabric_stall), scheduler decision "
                        "instants and pool counters in the same "
                        "Chrome-trace file (--trace-out saves it)")
def _serve_timeline(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.timeline(duration=duration, device=device)


@experiment("serve.continuous_vs_static", classes=("CPU",),
            figure="(engine comparison)",
            description="mixed-length workload: slot-admission continuous "
                        "batching vs static run-to-completion batches")
def _serve_engines(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.continuous_vs_static(duration=duration, device=device)


@experiment("fabric.collectives_degraded", classes=("NETWORK", "CPU"),
            requires_devices=2, figure="(degraded-wire offload decision)",
            description="bucketed reduction under degraded-fabric "
                        "conditions: overlap efficiency, degradation, "
                        "wire goodput per condition x method x schedule")
def _fabric_collectives(*, duration: float,
                        device="cuda") -> Iterable[Record]:
    from repro_torch.core import fabric
    return fabric.measure_collectives_degraded(duration=duration,
                                               device=device)


@experiment("fabric.serve_tail", classes=("CPU", "NETWORK"),
            figure="(tail latency under degraded fabric)",
            description="continuous-batching load level re-served per "
                        "fabric condition: p99 TTFT/TPOT inflation and "
                        "probe headroom")
def _fabric_serve_tail(*, duration: float,
                       device="cuda") -> Iterable[Record]:
    from repro_torch.core import fabric
    return fabric.measure_serve_tail(duration=duration, device=device)
