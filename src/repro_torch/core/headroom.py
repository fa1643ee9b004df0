"""Processing-headroom characterization — the pktgen delay-sweep analogue.

Counterpart of ``repro/core/headroom.py``.  The paper's method (section
II): drive the link at full rate, inject an artificial per-burst delay,
and find the maximum delay the device absorbs before throughput drops;
that delay (minus the no-delay burst time) is the headroom available for
offloaded computation.

Two modes:

* **Measured** (on the CUDA device, or the CPU when the caller asks):
  ``transfer_sweep`` maps throughput vs message size / workers (Fig.
  1/3); ``delay_sweep`` injects synthetic compute beside the transfer
  step and finds the knee (Fig. 2/4).  Both emit the unified ``Record``
  schema and time through the shared ``experiments.measure`` harness.

* **Derived** (from roofline terms): ``derived_headroom`` converts a
  cell's (compute, memory, collective) seconds into the headroom available
  while the dominant resource is saturated — how many FLOPs of offloaded
  work the step absorbs for free (the "22.8% CPU time" analogue).

The transfer proxy is one elementwise pass over a worker's buffer,
``1 + 2x`` (:func:`stream`): ONE kernel that reads the buffer once and
writes its result once, so ``message_bytes * workers * 2`` is the bytes a
call moves.  Eager ``x * 2.0 + 1.0`` would be two kernels and four
passes, and the rate computed from that byte count half the real one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.experiments.measure import measure
from repro_torch.experiments.record import Record
from repro_torch.runtime import resolve_device


# ---------------------------------------------------------------------------
# measured mode
# ---------------------------------------------------------------------------

def stream(one: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``1 + 2x`` in one elementwise kernel (``one`` is a 0-dim 1.0 on
    ``x``'s device): one read of ``x``, one write of the result."""
    return torch.add(one, x, alpha=2.0)


def _one(device) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=device)


def transfer_sweep(message_bytes: list[int], workers: list[int],
                   duration: float = 0.3,
                   experiment: str = "headroom.transfer",
                   device="cuda") -> list[Record]:
    """Throughput (GB/s) of a streaming 'transfer' vs message size & workers.

    The transfer proxy is a memory-rate stream op per worker buffer (on a
    real deployment this is the link's send; the shape of the curve —
    small messages can't fill the pipe — is the object of study, as in
    Fig. 1/3)."""
    device = resolve_device(device)
    one = _one(device)
    records = []
    for w in workers:
        for nbytes in message_bytes:
            n = max(nbytes // 4, 1)
            bufs = [torch.ones((n,), dtype=torch.float32, device=device)
                    for _ in range(w)]
            m = measure(lambda: [stream(one, x) for x in bufs], duration)
            records.append(Record(
                experiment, f"w{w}_m{nbytes}", "gbytes_per_sec",
                m.calls_per_sec * nbytes * w * 2 / 1e9, unit="GB/s",
                params={"workers": w, "message_bytes": nbytes,
                        "ops_per_sec": m.calls_per_sec,
                        "median_s": m.median_s, "p90_s": m.p90_s}))
            del bufs
    return records


def delay_sweep(message_bytes: int, matmul_sizes: list[int],
                duration: float = 0.3, tol: float = 0.10,
                experiment: str = "headroom.delay_sweep",
                device="cuda") -> list[Record]:
    """Inject synthetic offloaded compute into the transfer step (Fig. 2/4).

    Emits one Record per injected-compute size (metric ``relative`` — the
    throughput fraction of baseline) and summary Records for the knee (the
    largest size staying within ``1 - tol`` of baseline) and the implied
    headroom seconds per burst.  The injected compute is an f32 ``(m, m)``
    matmul at PyTorch's default f32 precision."""
    device = resolve_device(device)
    one = _one(device)
    n = max(message_bytes // 4, 1)
    buf = torch.ones((n,), dtype=torch.float32, device=device)

    base = measure(lambda: stream(one, buf), duration).calls_per_sec
    records = [Record(experiment, "matmul0", "ops_per_sec", base,
                      unit="ops/s", relative=1.0, params={"matmul": 0})]
    knee, headroom_s = 0, 0.0
    for m in matmul_sizes:
        w = torch.ones((m, m), dtype=torch.float32, device=device)
        thr = measure(lambda: (stream(one, buf), w @ w),
                      duration).calls_per_sec
        rel = thr / base
        records.append(Record(experiment, f"matmul{m}", "ops_per_sec", thr,
                              unit="ops/s", relative=rel,
                              params={"matmul": m}))
        if rel >= 1.0 - tol:
            knee = m
            # injected work absorbed per burst, in seconds
            headroom_s = max(headroom_s, 1.0 / thr - 1.0 / base)
        del w
    headroom_s = max(headroom_s, 0.0)
    records.append(Record(experiment, "knee", "matmul_size", knee,
                          params={"tol": tol}))
    records.append(Record(experiment, "headroom", "s_per_burst", headroom_s,
                          unit="s"))
    records.append(Record(experiment, "headroom", "fraction",
                          headroom_s * base))
    return records


def sweep_summary(records: list[Record]) -> dict:
    """Pull the delay-sweep summary values back out of the Record stream."""
    by = {(r.name, r.metric): r for r in records}
    return {
        "baseline_ops_per_sec": by[("matmul0", "ops_per_sec")].value,
        "knee_matmul": by[("knee", "matmul_size")].value,
        "headroom_s_per_burst": by[("headroom", "s_per_burst")].value,
        "headroom_fraction": by[("headroom", "fraction")].value,
    }


# ---------------------------------------------------------------------------
# derived mode (from roofline terms)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap step-time model: the dominant term."""
        return max(self.compute_s, self.memory_s, self.collective_s)


# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak
H100_BF16_FLOPS_PER_S = 989e12


def derived_headroom(t: RooflineTerms,
                     peak_flops: float = H100_BF16_FLOPS_PER_S) -> dict:
    """Headroom while the dominant resource is saturated (the paper's Q1).

    When the step is collective-bound, compute sits idle for
    (collective - compute) seconds — offloaded transforms (compression,
    checksums, re-quantization) are FREE up to that budget.  Mirrors the
    paper's max-delay-per-burst: delay_max = T_dominant, burst time =
    T_compute, headroom = delay_max - burst."""
    dom = t.bottleneck
    headroom_s = max(0.0, t.step_s - t.compute_s)
    return {
        "bottleneck": dom,
        "step_s": t.step_s,
        "headroom_s": headroom_s,
        "headroom_fraction": headroom_s / t.step_s if t.step_s else 0.0,
        "free_offload_gflops": headroom_s * peak_flops / 1e9,
        "advice": _advice(t),
    }


def _advice(t: RooflineTerms) -> str:
    dom = t.bottleneck
    if dom == "collective":
        return ("collective-bound: enable in-path compression "
                "(dp_method=int8_a2a/int8_ring) — transform rides for free "
                "in the compute headroom")
    if dom == "memory":
        return ("memory-bound: increase arithmetic intensity (fuse, larger "
                "blocks, avoid remat of matmuls) before offloading anything")
    return ("compute-bound: do NOT offload extra work into this step; "
            "paper's separated-host-mode lesson — the in-path processor "
            "is already saturated")
