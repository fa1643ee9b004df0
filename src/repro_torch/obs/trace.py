"""Span tracer with Chrome-trace-event export — virtual-clock aware.

A :class:`Tracer` records nested spans (begin/end with name, category,
args), instant events and counter series on named *tracks* (one per
engine loop, scheduler, KV pool, decode slot, bucket chain...).  Export
is the Chrome trace-event JSON format (``{"traceEvents": [...]}``) that
Perfetto and ``chrome://tracing`` load directly.

**Virtual-clock awareness is a hard contract, not a convenience.**  The
serve engine's injectable clock (``ContinuousEngine(clock=...)``) is
*stateful* in tests — every call advances virtual time — so the tracer
must never take its own timestamp on an engine path: every engine and
scheduler emission passes ``t=`` explicitly, reusing a time value the
engine already computed for its own decisions.  A traced run therefore
makes exactly the same clock calls as an untraced one, which is what the
tier-1 non-interference test pins (traced and untraced token streams
bit-identical on the virtual clock).  ``Tracer.clock`` exists for layers
*off* the engine clock (bucket-chain schedules at trace time, the train
loop) where the ``span()`` context manager stamps wall time itself.

The disabled path is a null object: ``NULL`` (and any tracer with
``enabled=False``) turns every emission into a no-op method call, so
instrumented hot loops guard with one truthiness check —

    tr = self.tracer
    if tr.enabled:
        tr.begin("engine", "decode", "engine", t=t_start)

Timestamps are float seconds on whatever clock produced them; export
converts to the format's microseconds.  Per-track begin/end pairing is
validated at emission (an unmatched ``end`` is an instrumentation bug
and raises), so an exported trace is well-formed by construction —
``obs.validate`` re-checks it from the outside for CI.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry, _NullMetrics


class Tracer:
    """Collects events; one instance per traced run (not thread-safe —
    the serve engine is a single host loop, and each thread installs its
    own via the thread-local ``current()``)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 metadata: Optional[dict] = None):
        self.clock = clock
        self.metadata = dict(metadata or {})
        self.events: list[dict] = []
        self.metrics = MetricsRegistry()
        self._tracks: dict[str, int] = {}       # name -> tid, issue order
        self._open: dict[str, list[str]] = {}   # track -> begin-name stack

    # -- emission ----------------------------------------------------------

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
        return tid

    def begin(self, track: str, name: str, cat: str = "",
              t: Optional[float] = None, **args) -> None:
        """Open a span on ``track``.  Pass ``t`` explicitly on any path
        driven by a stateful clock (the serve engine); omitted, the
        tracer's own clock stamps it."""
        self._open.setdefault(track, []).append(name)
        self.events.append({"ph": "B", "track": track, "name": name,
                            "cat": cat,
                            "t": self.clock() if t is None else t,
                            "args": args})

    def end(self, track: str, t: Optional[float] = None, **args) -> None:
        """Close the innermost open span on ``track``."""
        stack = self._open.get(track)
        if not stack:
            raise RuntimeError(f"end() on track {track!r} with no open span")
        name = stack.pop()
        self.events.append({"ph": "E", "track": track, "name": name,
                            "cat": "", "t": self.clock() if t is None else t,
                            "args": args})

    @contextmanager
    def span(self, track: str, name: str, cat: str = "", **args):
        """Wall-clock span for layers off the engine clock (overlap
        schedules, train steps).  Never use inside the serve loop — it
        calls ``self.clock`` and a stateful virtual clock would advance."""
        self.begin(track, name, cat, **args)
        try:
            yield
        finally:
            self.end(track)

    def instant(self, track: str, name: str, cat: str = "",
                t: Optional[float] = None, **args) -> None:
        self.events.append({"ph": "i", "track": track, "name": name,
                            "cat": cat,
                            "t": self.clock() if t is None else t,
                            "args": args})

    def counter(self, track: str, name: str, t: Optional[float] = None,
                **series) -> None:
        """A counter sample: ``series`` are the stacked values Perfetto
        plots (e.g. ``free=12, used=4``)."""
        self.events.append({"ph": "C", "track": track, "name": name,
                            "cat": "counter",
                            "t": self.clock() if t is None else t,
                            "args": series})

    # -- export ------------------------------------------------------------

    def chrome_trace(self, process_name: str = "repro") -> dict:
        """The event list as Chrome trace-event JSON (Perfetto loads it).

        Track registration order fixes the tid assignment, so two
        identical runs export byte-identical JSON (the span-tree
        stability test keys on this)."""
        for e in self.events:          # register tracks in emission order
            self._tid(e["track"])
        ev: list[dict] = [{"ph": "M", "pid": 1, "tid": 0,
                           "name": "process_name",
                           "args": {"name": process_name}}]
        for track, tid in self._tracks.items():
            ev.append({"ph": "M", "pid": 1, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
        for e in self.events:
            ev.append({"ph": e["ph"], "pid": 1, "tid": self._tid(e["track"]),
                       "name": e["name"], "cat": e["cat"] or "default",
                       "ts": round(e["t"] * 1e6, 3), "args": e["args"]})
        out = {"traceEvents": ev, "displayTimeUnit": "ms"}
        if self.metadata:
            out["otherData"] = dict(self.metadata)
        return out

    def save(self, path: str, process_name: str = "repro") -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(process_name), fh)
        return path


class _NullTracer:
    """The disabled default: every emission is a no-op; ``enabled`` is
    False so hot loops skip even argument construction."""

    enabled = False
    events: tuple = ()
    metrics = _NullMetrics()

    def begin(self, *a, **k) -> None:
        pass

    def end(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    @contextmanager
    def span(self, *a, **k):
        yield


NULL = _NullTracer()

_local = threading.local()


def current():
    """The thread's installed tracer (``NULL`` unless one was set) —
    how layers without an injection point (overlap schedules, fabric
    burns, the train loop) reach the run's tracer."""
    return getattr(_local, "tracer", NULL)


def set_current(tracer) -> None:
    _local.tracer = tracer if tracer is not None else NULL


@contextmanager
def use(tracer):
    prev = current()
    set_current(tracer)
    try:
        yield tracer
    finally:
        set_current(prev)


def resolve(clock: Callable[[], float] = time.perf_counter):
    """Tracer for a new engine: the ``obs_trace`` runtime knob wins (a
    fresh tracer; engine emissions stamp the engine clock explicitly),
    else the thread-local current tracer (CLI-installed), else NULL."""
    from repro_torch import runtime
    if runtime.policy().get("obs_trace"):
        return Tracer(clock=clock)
    return current()


def span_times(events, track: Optional[str] = None,
               cat: Optional[str] = None) -> dict[str, dict]:
    """Aggregate closed B/E pairs into a per-phase decomposition:
    ``{name: {"count": n, "total_s": s}}``, optionally filtered by track
    and/or category.  Nested spans each count their full extent (the
    table reports them as rows, not as a partition)."""
    out: dict[str, dict] = {}
    open_: dict[str, list] = {}
    for e in events:
        if track is not None and e["track"] != track:
            continue
        if e["ph"] == "B":
            open_.setdefault(e["track"], []).append(e)
        elif e["ph"] == "E":
            stack = open_.get(e["track"])
            if not stack:
                continue
            b = stack.pop()
            if cat is not None and b["cat"] != cat:
                continue
            d = out.setdefault(b["name"], {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] += e["t"] - b["t"]
    return out
