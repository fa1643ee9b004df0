"""Built-in experiment registrations of the port — the paper's figures as
registry entries.

Counterpart of ``repro/experiments/defs.py``, under the reference's names,
classes, figures, descriptions and presets: the offload characterization
(``headroom.*``, ``stressors.suite``, ``classes.aggregate``,
``inpath.*``), the serving families (``serve.*``) and
``fabric.serve_tail``.  Each adapter takes the Runner's ``duration`` and
the ``device`` the run is on (the card unless the caller asks for the
CPU); the rank families also take ``devices``, the number of ranks the
run may start (``--devices``; one process a rank, ``parallel/dist.py``).
The ``inpath.*`` families run over 4 pods emulated on one device
(``core/inpath.py``), so they need one device where the reference's need
two.  ``fabric.collectives_degraded``
and the collective stressors of ``stressors.suite`` and
``classes.aggregate`` run over ``devices`` gloo ranks and SKIP on one, as
the reference's do on one device.  ``serve.sharded_sweep`` runs its
engine tensor-parallel over ``devices`` rank processes and SKIPs on one.
``roofline.table`` waits for the analysis package (ROADMAP Queue 1 item
10) and is not registered.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.experiments.record import Record
from repro_torch.experiments.registry import experiment

KB, MB = 1 << 10, 1 << 20


@experiment("headroom.transfer_nic", classes=("NETWORK", "MEMORY"),
            figure="Fig. 1",
            description="transfer throughput, SmartNIC-like worker budget")
def _transfer_nic(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import headroom
    return headroom.transfer_sweep([4 * KB, 64 * KB, MB], workers=[1, 2],
                                   duration=duration,
                                   experiment="headroom.transfer_nic",
                                   device=device)


@experiment("headroom.transfer_host", classes=("NETWORK", "MEMORY"),
            figure="Fig. 3",
            description="transfer throughput, host-like worker budget")
def _transfer_host(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import headroom
    return headroom.transfer_sweep([64 * KB, MB], workers=[4, 8],
                                   duration=duration,
                                   experiment="headroom.transfer_host",
                                   device=device)


@experiment("headroom.delay_sweep", classes=("NETWORK", "CPU"),
            figure="Fig. 2/4",
            description="max injected compute before transfer rate drops")
def _delay_sweep(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import headroom
    return headroom.delay_sweep(MB, [16, 48, 96, 160, 256],
                                duration=duration, device=device)


@experiment("stressors.suite", figure="Fig. 7 / Table III",
            description="stressor battery vs the numpy reference platform")
def _stressors(*, duration: float, device="cuda",
               devices: int = 1) -> Iterable[Record]:
    from repro_torch.core import stressors
    return stressors.run_suite(duration=duration, device=device,
                               devices=devices)


@experiment("classes.aggregate", figure="Fig. 8",
            description="class-level mean/std of stressor relatives")
def _classes(*, duration: float, device="cuda",
             devices: int = 1) -> Iterable[Record]:
    from repro_torch.core import classes, stressors
    return classes.aggregate(stressors.run_suite(
        duration=duration, device=device, devices=devices))


@experiment("inpath.collectives", classes=("NETWORK", "CRYPTO"),
            figure="Fig. 5/6",
            description="in-path int8 transforms inside the all-reduce")
def _inpath(*, duration: float, device="cuda") -> Iterable[Record]:
    from repro_torch.core import inpath
    return inpath.measure(size=1 << 18, duration=duration, device=device)


@experiment("inpath.bucketing", classes=("NETWORK", "CPU"),
            figure="Fig. 5/6 (launch side)",
            description="leaf-wise vs bucketed compressed gradient reduction")
def _inpath_bucketing(*, duration: float,
                      device="cuda") -> Iterable[Record]:
    from repro_torch.core import inpath
    return inpath.measure_bucketing(duration=duration, device=device)


@experiment("inpath.headroom_overlap", classes=("NETWORK", "CPU"),
            figure="Tables IV/V (headroom in transfer)",
            description="compute FLOP/s with a collective in flight: "
                        "serial vs overlapped schedule per method")
def _inpath_headroom_overlap(*, duration: float,
                             device="cuda") -> Iterable[Record]:
    from repro_torch.core import inpath
    return inpath.measure_headroom_overlap(duration=duration, device=device)


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
def _serve_sharded_sweep(*, duration: float, device="cuda",
                         devices: int = 1) -> Iterable[Record]:
    from repro_torch.core import serving
    return serving.sharded_sweep(duration=duration, device=device,
                                 devices=devices)


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
def _fabric_collectives(*, duration: float, device="cuda",
                        devices: int = 1) -> Iterable[Record]:
    from repro_torch.core import fabric
    return fabric.measure_collectives_degraded(duration=duration,
                                               devices=devices,
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
