"""Serve-side fabric enforcement: delayed admission and decode ticks.

The serving path runs on the host between device dispatches, so its
enforcement point is much simpler than the collective burn: a
:class:`ServeFabric` wraps a condition plus an injectable ``sleep`` (real
``time.sleep`` in wall-clock runs, a virtual-clock advance in tests) and
``ContinuousEngine`` calls its two hooks —

  * ``stall_admit``  before a newly admitted request's prefill, so the
    delay lands in the prefill stage of the latency decomposition (TTFT
    inflates, queue_wait does not);
  * ``stall_decode`` at the top of each decode tick, inside the
    tick's timing window, so TPOT inflates.

The straggler term applies to decode ticks only — a continuous-batching
step advances *all* slots together, so one slow device drags every
decode tick exactly like the slowest rank drags a collective.  Delays
are sampled from the condition's seeded Generator in hook-call order;
with a virtual clock the whole degraded run is deterministic.

Stall time is accounted per hook (``stalled_s``) so launch output and
the ``fabric.serve_tail`` records can report what was injected next to
what was measured.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.fabric.condition import FabricCondition


class ServeFabric:
    """Condition + sleep injected into ``ContinuousEngine``."""

    def __init__(self, condition: FabricCondition,
                 sleep: Optional[Callable[[float], None]] = None):
        self.condition = condition
        self.sleep = sleep if sleep is not None else time.sleep
        self._rng = condition.rng()
        self.stalled_s = {"admit": 0.0, "decode": 0.0}

    @property
    def is_clean(self) -> bool:
        return self.condition.is_clean

    def _stall(self, kind: str, delay_s: float) -> float:
        if delay_s > 0.0:
            self.sleep(delay_s)
            self.stalled_s[kind] += delay_s
        return delay_s

    def stall_admit(self) -> float:
        """Delay one admission (called after the scheduler admits, before
        prefill).  Returns the injected seconds."""
        if self.condition.is_clean:
            return 0.0
        return self._stall("admit", self.condition.segment_delay_s(self._rng))

    def stall_decode(self) -> float:
        """Delay one decode tick (called inside the tick's timing window).
        Includes the straggler term: one slow device drags the whole
        batched step.  Returns the injected seconds."""
        if self.condition.is_clean:
            return 0.0
        d = self.condition.segment_delay_s(self._rng)
        if self.condition.straggler_device is not None:
            d += self.condition.straggler_delay_s
        return self._stall("decode", d)

    def total_stalled_s(self) -> float:
        return sum(self.stalled_s.values())
