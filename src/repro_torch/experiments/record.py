"""The unified result schema for every paper characterization.

One row of any experiment — a stressor's bogo-ops rate, a transfer-sweep
point, an in-path collective timing, a roofline cell — is a ``Record``.
Replaces the per-module result types the seed grew (``stressors.Result``,
``inpath.InPathResult``, ``classes.ClassSummary``, and the ad-hoc
``name,metric,value`` tuples in ``benchmarks/``).

Schema (one ``Record``):

  ``experiment``   registry name of the owning experiment, dotted
                   ``family.variant`` (e.g. ``"stressors.suite"``).
  ``name``         row within the experiment (e.g. ``"quant-int8"``,
                   a message size, a roofline cell); ``"-"`` for
                   experiment-level SKIP/ERROR rows.
  ``metric``       what was measured (``"bogo_ops_per_sec"``,
                   ``"wall_s_per_call"``); ``"skip"``/``"error"`` for
                   status rows.
  ``value``        the measurement: float/int/str, or None on status rows.
  ``unit``         unit string for ``value`` (``"s"``, ``"ops/s"``, "").
  ``relative``     ``value`` normalized against the experiment's declared
                   reference — the paper's RPi4-reference idiom (stock
                   collective, numpy platform); reference rows carry 1.0.
  ``params``       experiment-specific inputs and side measurements
                   (classes, message sizes, wire bytes, error bounds);
                   must stay JSON-serializable.
  ``skipped``      True for a stress-ng-style SKIP: a *declared*
                   capability was missing (device count, backend), the
                   experiment was not attempted.  Never an error.
  ``reason``       human-readable SKIP/ERROR explanation.
  ``error``        True when an exception escaped the experiment; the
                   Runner records it and the CLI exits nonzero.
  ``wall_time``    unix timestamp when the row was measured.
  ``elapsed_s``    seconds since the owning experiment started (shared
                   across an experiment's rows).

SKIP and ERROR are disjoint by construction (``skip()`` / ``failure()``
below); consumers rank/aggregate only rows with neither flag set.

Emitters: ``write_jsonl`` / ``read_jsonl`` round-trip losslessly;
``write_csv`` flattens ``params`` into a JSON-encoded column for
spreadsheet use.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import IO, Iterable, Iterator, Optional, Union

Value = Union[float, int, str, None]

CSV_FIELDS = ("experiment", "name", "metric", "value", "unit", "relative",
              "skipped", "error", "reason", "wall_time", "elapsed_s",
              "params")


@dataclass
class Record:
    """One measured (or skipped) data point of one experiment.

    ``experiment`` is the registry name (e.g. ``"stressors.suite"``),
    ``name`` the row within it (e.g. ``"quant-int8"``), ``metric`` what was
    measured (e.g. ``"bogo_ops_per_sec"``).  ``relative`` is the value
    normalized against the experiment's reference (the paper's
    RPi4-reference idiom); ``params`` carries experiment-specific inputs
    and side measurements (classes, message sizes, wire bytes, ...).
    """
    experiment: str
    name: str
    metric: str
    value: Value = None
    unit: str = ""
    relative: Optional[float] = None
    params: dict = field(default_factory=dict)
    skipped: bool = False
    reason: str = ""
    error: bool = False
    wall_time: Optional[float] = None    # unix timestamp when measured
    elapsed_s: Optional[float] = None    # wall-clock seconds since the
    #                                      owning experiment started (shared
    #                                      across an experiment's rows, since
    #                                      experiments return complete lists)

    @property
    def classes(self) -> tuple[str, ...]:
        """Stressor-taxonomy classes, when the experiment declares them."""
        return tuple(self.params.get("classes", ()))

    def stamp(self, t0: float) -> "Record":
        """Fill wall-clock metadata in place (t0 = perf_counter at start)."""
        if self.wall_time is None:
            self.wall_time = time.time()
        if self.elapsed_s is None:
            self.elapsed_s = time.perf_counter() - t0
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "Record":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_csv_row(self) -> list:
        d = dataclasses.asdict(self)
        d["params"] = json.dumps(self.params, sort_keys=True)
        return [d[k] for k in CSV_FIELDS]


def skip(experiment: str, reason: str, name: str = "-") -> Record:
    """A stress-ng-style SKIP row (capability missing, not a failure)."""
    return Record(experiment, name, "skip", skipped=True, reason=reason)


def failure(experiment: str, exc: BaseException, name: str = "-") -> Record:
    """An ERROR row; the Runner turns any of these into a nonzero exit."""
    return Record(experiment, name, "error", error=True,
                  reason=f"{type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

def write_jsonl(records: Iterable[Record], fh: IO[str]) -> None:
    for r in records:
        fh.write(r.to_json() + "\n")


def read_jsonl(fh: IO[str]) -> Iterator[Record]:
    for line in fh:
        line = line.strip()
        if line:
            yield Record.from_json(line)


def write_csv(records: Iterable[Record], fh: IO[str]) -> None:
    w = csv.writer(fh)
    w.writerow(CSV_FIELDS)
    for r in records:
        w.writerow(r.to_csv_row())


def read_csv(fh: IO[str]) -> Iterator[Record]:
    for row in csv.DictReader(fh):
        yield Record(
            experiment=row["experiment"], name=row["name"],
            metric=row["metric"],
            value=_num(row["value"]), unit=row["unit"],
            relative=_opt_float(row["relative"]),
            params=json.loads(row["params"] or "{}"),
            skipped=row["skipped"] in ("True", "true", "1"),
            reason=row["reason"],
            error=row["error"] in ("True", "true", "1"),
            wall_time=_opt_float(row["wall_time"]),
            elapsed_s=_opt_float(row["elapsed_s"]))


def _num(s: str) -> Value:
    if s in ("", "None"):
        return None
    try:
        f = float(s)
    except ValueError:
        return s
    return int(f) if f.is_integer() and "." not in s and "e" not in s.lower() \
        else f


def _opt_float(s: str) -> Optional[float]:
    return None if s in ("", "None") else float(s)
