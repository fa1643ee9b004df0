"""Ring-buffer-capped list for the engine's decision logs.

``ContinuousEngine.step_log`` and ``SlotScheduler.admit_log``/
``shed_log`` grow with work done; on a long trace that is unbounded
history nobody reads back more than a window of.  ``BoundedLog`` is a
``list`` subclass (tier-1 tests compare these logs to plain lists with
``==``; subclassing keeps that contract) whose ``append`` evicts the
oldest entry past ``cap`` and counts the eviction in ``dropped`` — the
cap is honest, not silent.

Default is uncapped (``cap=None``): every existing caller and test sees
exactly the old list semantics; ``launch.serve --log-cap N`` and the
``log_cap=`` engine/scheduler arguments opt in.

``preempt_log`` deliberately stays a plain list: the engine reads it by
index slice (``preempt_log[n:]``) to find the victims of one admission,
and eviction would shift those indices under it.
"""
from __future__ import annotations

from typing import Optional


class BoundedLog(list):
    def __init__(self, cap: Optional[int] = None):
        super().__init__()
        if cap is not None and cap < 1:
            raise ValueError(f"log cap must be >= 1 or None, got {cap}")
        self.cap = cap
        self.dropped = 0

    def append(self, item) -> None:
        super().append(item)
        if self.cap is not None and len(self) > self.cap:
            del self[0]
            self.dropped += 1
