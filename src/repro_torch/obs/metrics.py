"""Counter/gauge/histogram registry attached to each tracer.

Counters accumulate (preemptions, sheds, admits, chains issued), gauges
hold the latest sample (queue depth, slot occupancy, KV pages free),
histograms keep a bounded reservoir of observations (decode tick
seconds) summarized as count/mean/quantiles in ``snapshot()``.

The registry is deliberately dumb — plain dicts, no locks, no export
thread: the serve engine is a single host loop and the snapshot rides
out in Record params.  The disabled path (``_NullMetrics``) makes every
update a no-op method call, matching the tracer's null object.
"""
from __future__ import annotations


class MetricsRegistry:
    HIST_CAP = 1024   # per-histogram reservoir: newest observations win

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list] = {}

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.setdefault(name, [])
        h.append(value)
        if len(h) > self.HIST_CAP:
            del h[: len(h) - self.HIST_CAP]

    def snapshot(self) -> dict:
        """JSON-ready view: counters and gauges verbatim, histograms as
        count/mean/p50/p99/max summaries."""
        out = {"counters": dict(self.counters), "gauges": dict(self.gauges),
               "histograms": {}}
        for name, vals in self.histograms.items():
            if not vals:
                continue
            s = sorted(vals)
            n = len(s)
            out["histograms"][name] = {
                "count": n, "mean": sum(s) / n,
                "p50": s[n // 2], "p99": s[min(n - 1, (99 * n) // 100)],
                "max": s[-1]}
        return out


class _NullMetrics:
    """No-op twin installed on the NULL tracer."""

    def count(self, *a, **k) -> None:
        pass

    def gauge(self, *a, **k) -> None:
        pass

    def observe(self, *a, **k) -> None:
        pass

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}
