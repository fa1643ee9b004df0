"""Injection of fabric degradation into the gradient collective chains.

Counterpart of ``repro/fabric/inject.py``.  A :class:`FabricCondition`
slows the bucket chains ``parallel/collectives.py`` issues by a **burn**
spliced into the chain it degrades: a device-side spin
(``kernels/burn.py``) queued on a bucket's stream just before its chain,
so the chain's exchange waits for it.  The reference needs a runtime-false
select to keep XLA from eliminating its ``while_loop`` and a probe of the
buffer to keep the burn inside the schedule's dependencies; eager PyTorch
eliminates nothing and orders work by stream, so here:

  * the burn writes only a scratch float of its own, and the buffer passes
    through untouched: outputs stay bit-identical to the clean run;
  * where the burn sits is the schedule's business (``run_schedule``'s
    ``perturb``): serial, it waits behind the previous chain; pipelined,
    only behind its own bucket's pack.

A straggler is per-device in the reference: the designated device burns
the extra trips.  On a ``DistPodAxis`` that is the rank
``condition.straggler_device``; on an emulated ``PodAxis`` every rank
shares one stream, so it burns the common and the straggler's trips.

Trip counts come from seconds through a measured rate
(:func:`iters_per_second`: CUDA events around the kernel on the card, the
host clock around the plain loop on the CPU; :func:`calibrate` measures
it one rank at a time where ranks share a card), and each chain's *common*
delay (latency, loss retries, jitter, bandwidth stretch) is sampled once
per injector from the condition's seeded Generator, by chain position, so
the serial and pipelined arms of one condition see the same delays.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from repro_torch.fabric.condition import FabricCondition
from repro_torch.kernels import burn as kburn
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.pods import DistPodAxis, Pods

# Nominal clean wire rate used only to turn a bucket's payload bytes into
# a transfer time for the bandwidth-throttle term.  A model constant, not
# a measurement (the reference's): 200 MB/s.
REF_BYTES_PER_S = 2e8

# Floor for the calibrated burn rate: a descheduled timing slice must not
# make delays explode.
_MIN_ITERS_PER_S = 1e5
_CALIBRATED: dict = {}      # device type -> trips a second


def iters_per_second(device="cuda", calibrate_s: float = 0.05,
                     force: bool = False) -> float:
    """Measured burn rate on ``device``'s type (cached per process)."""
    kind = torch.device(device).type
    if kind not in _CALIBRATED or force:
        _CALIBRATED[kind] = _calibrate(torch.device(device), calibrate_s)
    return _CALIBRATED[kind]


def calibrate(pods: Pods, device) -> float:
    """:func:`iters_per_second` on ``device``, measured anew, one rank at
    a time on a ``DistPodAxis`` (the others wait at a barrier): ranks that
    share a card and burn at once each read a share of the rate, as the
    card runs one process's kernels at a time, and their burns would
    then last a fraction of the delays they stand for."""
    if not isinstance(pods, DistPodAxis):
        return iters_per_second(device, force=True)
    rate = None
    for r in range(pods.n):
        if r == pods.rank:
            rate = iters_per_second(device, force=True)
        pods.barrier()
    return rate


def _calibrate(device: torch.device, calibrate_s: float) -> float:
    """Grow a probe burn until it runs ``calibrate_s``, then take the
    fastest of three probes of that size: a probe can only be slowed (a
    descheduled slice, another process's kernels), and a rate read low
    makes every later burn short."""
    iters = 1 << 16 if device.type != "cuda" else 1 << 20
    kburn.burn(iters, device)                        # build, load, warm

    def seconds() -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kburn.burn(iters, device)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        kburn.burn(iters, device)
        return time.perf_counter() - t0

    while seconds() < calibrate_s and iters < 200_000_000:
        iters *= 4
    dt = min(seconds() for _ in range(3))
    return max(iters / max(dt, 1e-9), _MIN_ITERS_PER_S)


def stall(buf: torch.Tensor, iters: int) -> torch.Tensor:
    """Queue ``iters`` burn trips on ``buf``'s device (its current stream)
    and return ``buf`` itself: whatever the stream runs next waits."""
    if iters > 0:
        kburn.burn(iters, buf.device)
    return buf


class ChainInjector:
    """One condition applied to a sequence of chains over ``pods``.

    Chain ``i``'s common delay is sampled up front from
    ``payload_bytes[i]`` (so the serial and pipelined arms of the same
    condition, built from separate injectors, see identical delays), and
    the straggler term is constant per segment.  ``perturb`` has the
    ``run_schedule(..., perturb=)`` signature.  ``rate`` (trips a second)
    defaults to :func:`iters_per_second` of the device of the first
    buffer perturbed."""

    def __init__(self, condition: FabricCondition, pods: Pods,
                 payload_bytes: Sequence[int],
                 rate: Optional[float] = None):
        self.condition = condition
        self.pods = pods
        self._payload_bytes = list(payload_bytes)
        self._rate = rate
        rng = condition.rng()
        self.common_delays_s = (
            [0.0] * len(self._payload_bytes) if condition.is_clean else
            [condition.segment_delay_s(rng, transfer_s=pb / REF_BYTES_PER_S)
             for pb in self._payload_bytes])
        self._common_iters = None
        self.straggler_iters = 0
        if rate is not None:
            self._convert(rate)

    def _convert(self, rate: float) -> None:
        self._rate = rate
        self._common_iters = [int(d * rate) for d in self.common_delays_s]
        self.straggler_iters = (
            int(self.condition.straggler_delay_s * rate)
            if self.condition.straggler_device is not None
            and not self.condition.is_clean else 0)

    def _iters(self, i: int, device) -> int:
        """Trips this process burns before chain ``i``."""
        if self.condition.is_clean:
            return 0
        if self._common_iters is None:
            self._convert(self._rate or iters_per_second(device))
        ci = self._common_iters[i] if i < len(self._common_iters) else 0
        device_no = self.condition.straggler_device
        straggles = (device_no is not None and
                     (self.pods.rank == device_no
                      if isinstance(self.pods, DistPodAxis)
                      else device_no < self.pods.n))
        return ci + (self.straggler_iters if straggles else 0)

    @property
    def injected_s(self) -> float:
        """Total sampled common delay (straggler term excluded) — goes in
        Record params so a run documents what it injected."""
        return float(sum(self.common_delays_s))

    def perturb(self, i: int, buf: torch.Tensor) -> torch.Tensor:
        """Delay chain ``i``'s buffer by this condition's burn."""
        iters = self._iters(i, buf.device)
        if iters <= 0:
            return buf
        tr = obs_trace.current()
        if tr.enabled:
            tr.instant("fabric", "burn", "fabric", chain=i,
                       condition=self.condition.name,
                       delay_s=self.common_delays_s[i]
                       if i < len(self.common_delays_s) else 0.0,
                       straggler_iters=self.straggler_iters)
        return stall(buf, iters)

    def perturb_tree(self, leaves: list) -> list:
        """Delay a whole list of leaves by one shared burn (segment 0) —
        the enforcement point of the unbucketed ``stock`` path."""
        if not leaves:
            return leaves
        iters = self._iters(0, leaves[0].device)
        if iters > 0:
            stall(leaves[0], iters)
        return leaves
