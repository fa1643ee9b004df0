"""The shared measurement harness.

Counterpart of ``repro/experiments/measure.py``: every timing loop of the
port's experiments goes through ``measure``, which guarantees at least
one timed call, waits for the device once at the end (so throughput is
end-to-end, not launch rate), and reports per-call launch-side quantiles
alongside.

``measure(fn, duration, warmup)`` returns a ``Measurement``:
``calls_per_sec`` (synchronized end-to-end rate — the number Records
usually carry as ``value``), ``n`` timed calls, ``total_s`` wall time,
and ``median_s``/``p10_s``/``p90_s`` per-call *launch-side* quantiles
(they exclude the final sync, so on the card they bound launch cost, not
device time).  Experiments put the rate or ``s_per_call`` in
``Record.value`` and stash quantiles in ``Record.params``.

The reference waits through ``jax.block_until_ready``; PyTorch returns
from a CUDA call before the card has done the work, so here the wait is
``torch.cuda.synchronize()`` (:func:`_sync`).  Without it ``measure``
would time launches.

A rank of a group (``parallel/dist.py``) that times a collective must
make exactly as many calls as every other rank, or the last call waits
for partners that never come: ``agree(done) -> bool`` (a
``DistPodAxis.all_true``) makes the stop decision after each call one
that all ranks share, and its own time is left out of ``total_s``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class Measurement:
    calls_per_sec: float      # synchronized: n / (wall time incl. final sync)
    n: int                    # timed calls (always >= 1, even at duration=0)
    total_s: float
    median_s: float           # per-call launch-side wall time quantiles,
    p10_s: float              # over at most the first _MAX_SAMPLES calls
    p90_s: float

    @property
    def s_per_call(self) -> float:
        return 1.0 / self.calls_per_sec if self.calls_per_sec else float("inf")


_MAX_SAMPLES = 100_000  # per-call quantiles use at most this many samples


def _sync(out) -> None:
    """Wait for the card: ``torch.cuda.synchronize()`` whenever CUDA is
    initialised — always so where ``out`` holds a CUDA tensor, and also
    where the work of ``fn`` left no tensor in its result.  A no-op in a
    process that never touched the card."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable[[], object], duration: float = 0.3,
            warmup: int = 1,
            agree: Optional[Callable[[bool], bool]] = None) -> Measurement:
    """Call ``fn`` repeatedly for ~``duration`` seconds.

    ``warmup`` un-timed calls absorb first-call costs (kernel images,
    library handles).  At least one timed call always runs —
    ``duration=0`` degrades to a single-shot timing.  ``agree``, when
    given, turns each call's "past the deadline" into the decision every
    rank shares (module docstring).
    """
    out = None
    for _ in range(max(warmup, 0)):
        out = fn()
    _sync(out)

    times: list[float] = []
    n = 0
    spent = 0.0                 # in ``agree``, left out of the total
    t0 = time.perf_counter()
    deadline = t0 + duration
    while True:
        s = time.perf_counter()
        out = fn()
        e = time.perf_counter()
        n += 1
        if n <= _MAX_SAMPLES:   # bound memory on nanosecond-scale fns
            times.append(e - s)
        done = e >= deadline
        if agree is not None:
            done = agree(done)
            spent += time.perf_counter() - e
        if done:
            break
    _sync(out)
    total = time.perf_counter() - t0 - spent

    times.sort()

    ns = len(times)

    def q(frac: float) -> float:
        return times[min(ns - 1, round(frac * (ns - 1)))]

    return Measurement(
        calls_per_sec=n / total if total > 0 else float("inf"),
        n=n, total_s=total,
        median_s=q(0.50), p10_s=q(0.10), p90_s=q(0.90),
    )
