"""Class-level aggregation of stressor results (the paper's Fig. 8).

The paper's finding: class-level averages carry standard deviations as
large as the means, so only individual-stressor profiles are actionable.
``aggregate`` reproduces that analysis over the unified ``Record`` stream
and emits Records itself (experiment ``classes.aggregate``, one per
class); ``significant_classes`` returns the classes (if any) whose mean
exceeds one standard deviation — expected to be few/none, matching the
paper.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.experiments.record import Record

EXPERIMENT = "classes.aggregate"

ALL_CLASSES = ["CPU", "CPU_CACHE", "MEMORY", "VM", "NETWORK", "PIPE_IO",
               "IO", "FILESYSTEM", "SCHEDULER", "INTERRUPT", "OS", "CRYPTO"]


def aggregate(results: Iterable[Record]) -> list[Record]:
    """Per-class mean relative performance over stressor Records.

    Each output Record: value = mean relative, ``params`` carries n and
    std_relative (the paper's error bar)."""
    results = list(results)
    out = []
    for cls in ALL_CLASSES:
        vals = [r.relative for r in results
                if cls in r.classes and not r.skipped and r.relative]
        if not vals:
            continue
        arr = np.array(vals, np.float64)
        out.append(Record(EXPERIMENT, cls, "mean_relative",
                          float(arr.mean()), relative=float(arr.mean()),
                          params={"n": len(vals),
                                  "std_relative": float(arr.std())}))
    return out


def is_significant(summary: Record) -> bool:
    """Mean exceeds one std with >= 2 samples — the paper's actionability
    bar (rarely met, by design of the analysis)."""
    return (summary.params.get("n", 0) >= 2
            and summary.value is not None
            and summary.value > summary.params.get("std_relative", 0.0))


def significant_classes(summaries: Iterable[Record]) -> list[str]:
    return [s.name for s in summaries if is_significant(s)]


def ranking(results: Iterable[Record]) -> list[Record]:
    """Stressors ordered by relative performance (best offload targets
    first), the paper's Table III analogue."""
    live = [r for r in results if not r.skipped and r.relative is not None]
    return sorted(live, key=lambda r: -r.relative)
