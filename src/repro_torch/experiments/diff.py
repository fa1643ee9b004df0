"""Diff two persisted Record streams (JSONL), per experiment.

    PYTHONPATH=src python -m repro_torch.experiments diff old.jsonl new.jsonl \
        [--threshold METRIC=REL ...]

The regression-diff direction in ROADMAP.md: Runner persists one JSONL
stream per run under ``experiments/records/`` (each Record stamped with
the producing git commit in ``params``); this command compares two of
them row by row.  Rows are keyed by ``(experiment, name, metric)``; for
keys present in both streams with numeric values the absolute and
relative delta is printed, and rows only in one stream are reported as
added/removed.  SKIP/ERROR flag changes are called out explicitly (a row
silently flipping to skipped is how coverage regressions hide).

Either stream argument may also be a *directory*: its ``*.jsonl`` files
are read in sorted order and concatenated (later files win on repeated
keys).  That is how the curated baseline works — CI diffs a fresh run
against ``experiments/records/baseline/``, a small hand-kept stream per
release rather than just the previous commit, so a regression that
creeps in over many commits still trips the gate.

Without thresholds this is a *report*: exit status is 0 whenever both
files parse.  ``--threshold METRIC=[+|-]REL`` turns it into a *gate* for
that metric: a row whose relative delta ``(new-old)/|old|`` exceeds REL in
the gated direction is a violation and the exit status becomes 1.  A bare
``REL`` gates both directions; ``+REL`` gates only increases (wall-clock
regressions), ``-REL`` only drops (rate-metric regressions) — so a large
improvement never fails the build.  Thresholds are per-metric because
noise is: wall-clock metrics on shared CI runners need loose bounds
(catastrophic-regression catches only), while modeled metrics (wire
bytes) can be held to 0.

Gated comparisons additionally require the two streams' environment
stamps (``params["env"]``, written by the Runner: backend, device count,
platform, hostname) to be *comparable* — same JAX backend and OS
platform; a mismatch is exit 2 (refused), not a pass or a fail, because
a CPU-vs-TPU wall-clock delta measures the hardware swap rather than the
code.  Device count and hostname deliberately do not gate (CI fabricates
varying host-device counts on purpose).  ``--ignore-env`` overrides.
"""
from __future__ import annotations

import itertools
import os
import sys
from typing import Callable, Dict, Iterable

from repro_torch.experiments.record import Record, read_jsonl

Key = tuple  # (experiment, name, metric)


def _index(records: Iterable[Record]) -> dict[Key, Record]:
    out: dict[Key, Record] = {}
    for r in records:   # last row wins for a repeated key
        out[(r.experiment, r.name, r.metric)] = r
    return out


def read_stream(path: str) -> dict[Key, Record]:
    """Index one stream argument: a JSONL file, or a directory whose
    ``*.jsonl`` files are concatenated in sorted order (the curated
    baseline layout, ``experiments/records/baseline/``)."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path) if n.endswith(".jsonl"))
        if not names:
            raise OSError(f"{path}: directory holds no .jsonl streams")
        out: dict[Key, Record] = {}
        for n in names:
            with open(os.path.join(path, n)) as fh:
                out.update(_index(read_jsonl(fh)))
        return out
    with open(path) as fh:
        return _index(read_jsonl(fh))


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _delta_line(name: str, metric: str, old: Record, new: Record) -> str:
    head = f"  {name}.{metric}: "
    flags = []
    if old.skipped != new.skipped:
        flags.append(f"skipped {old.skipped} -> {new.skipped}")
    if old.error != new.error:
        flags.append(f"error {old.error} -> {new.error}")
    if flags:
        return head + ", ".join(flags)
    ov, nv = old.value, new.value
    if isinstance(ov, (int, float)) and isinstance(nv, (int, float)):
        if ov == nv:
            return ""
        rel = f" ({(nv - ov) / ov:+.1%})" if ov else ""
        return head + f"{_fmt_val(ov)} -> {_fmt_val(nv)}{rel}"
    if ov != nv:
        return head + f"{_fmt_val(ov)} -> {_fmt_val(nv)}"
    return ""


def _rel_delta(old, new):
    """Signed (new-old)/|old| for numeric pairs; None when not comparable."""
    if not isinstance(old, (int, float)) or not isinstance(new, (int, float)):
        return None
    if old == new:
        return 0.0
    if old == 0:
        return float("inf") if new > old else float("-inf")
    return (new - old) / abs(old)


# the env-metadata keys a threshold gate requires to match between the
# two streams.  Deliberately NOT device_count (CI steps legitimately vary
# fabricated host-device counts) and NOT hostname (every runner differs):
# backend (cpu/tpu/gpu) and OS platform are what invalidate a wall-clock
# comparison outright.
ENV_COMPARABLE_KEYS = ("backend", "platform")


def env_mismatches(old_idx: dict, new_idx: dict,
                   thresholds: Dict[str, "Threshold"]) -> list[str]:
    """Threshold-gated row pairs whose environment stamps are not
    comparable: both rows carry ``params["env"]`` and disagree on any of
    ``ENV_COMPARABLE_KEYS``.  A CPU-vs-TPU delta gated at a noise bound
    is a comparison error, not a measurement — the diff refuses (exit 2)
    rather than passing or failing it.  Rows without env stamps (streams
    predating the metadata) are compared as before."""
    out = []
    for k in sorted(set(old_idx) & set(new_idx)):
        exp, name, metric = k
        if metric not in thresholds:
            continue
        oe = old_idx[k].params.get("env")
        ne = new_idx[k].params.get("env")
        if not isinstance(oe, dict) or not isinstance(ne, dict):
            continue
        bad = [f"{key} {oe.get(key)!r} -> {ne.get(key)!r}"
               for key in ENV_COMPARABLE_KEYS if oe.get(key) != ne.get(key)]
        if bad:
            out.append(f"{exp}/{name}.{metric}: {', '.join(bad)}")
    return out


def threshold_violations(old_idx: dict, new_idx: dict,
                         thresholds: Dict[str, "Threshold"]) -> list[str]:
    """Rows whose metric is thresholded and whose relative delta exceeds
    the bound in the gated direction.  Rows present in only one stream
    never violate (added and removed rows are reported, not gated —
    device-count-dependent SKIPs would make them flap)."""
    out = []
    for k in sorted(set(old_idx) & set(new_idx)):
        exp, name, metric = k
        if metric not in thresholds:
            continue
        o, n = old_idx[k], new_idx[k]
        if o.skipped or n.skipped or o.error or n.error:
            continue
        rel = _rel_delta(o.value, n.value)
        if rel is None:
            continue
        t = thresholds[metric]
        if t.violated(rel):
            out.append(f"{exp}/{name}.{metric}: "
                       f"{_fmt_val(o.value)} -> {_fmt_val(n.value)} "
                       f"(delta {rel:+.1%} outside {t.describe()})")
    return out


def diff_streams(old: Iterable[Record], new: Iterable[Record],
                 out: Callable[[str], None] = print) -> int:
    """Print per-experiment deltas; returns the number of changed rows."""
    oidx, nidx = _index(old), _index(new)
    changed = 0
    all_keys = sorted(set(oidx) | set(nidx))   # sorts by experiment first
    for exp, group in itertools.groupby(all_keys, key=lambda k: k[0]):
        lines = []
        for k in group:
            _, name, metric = k
            if k not in oidx:
                lines.append(f"  {name}.{metric}: added "
                             f"({_fmt_val(nidx[k].value)})")
            elif k not in nidx:
                lines.append(f"  {name}.{metric}: removed "
                             f"(was {_fmt_val(oidx[k].value)})")
            else:
                line = _delta_line(name, metric, oidx[k], nidx[k])
                if line:
                    lines.append(line)
        if lines:
            out(f"{exp}:")
            for line in lines:
                out(line)
            changed += len(lines)
    if not changed:
        out("no per-experiment deltas")
    return changed


class Threshold:
    """A per-metric noise bound, optionally direction-gated.

    ``REL`` gates both directions (|delta| > REL); ``+REL`` gates only
    increases (wall-clock regressions), ``-REL`` only drops (rate-metric
    regressions) — so a big *improvement* in a gated-direction metric
    never fails the build."""

    def __init__(self, spec: str):
        self.direction = spec[0] if spec[:1] in ("+", "-") else ""
        self.bound = float(spec[1:] if self.direction else spec)
        if self.bound < 0:
            raise ValueError(f"threshold bound must be >= 0: {spec!r}")

    def violated(self, rel: float) -> bool:
        if self.direction == "+":
            return rel > self.bound
        if self.direction == "-":
            return -rel > self.bound
        return abs(rel) > self.bound

    def describe(self) -> str:
        return f"{self.direction or '±'}{self.bound:.1%}"


def _parse_thresholds(args: list[str]) -> Dict[str, Threshold]:
    out: Dict[str, Threshold] = {}
    for a in args:
        metric, _, bound = a.partition("=")
        if not metric or not bound:
            raise ValueError(f"bad --threshold {a!r}; want METRIC=[+|-]REL")
        try:
            out[metric] = Threshold(bound)
        except ValueError:
            raise ValueError(f"bad --threshold {a!r}; want METRIC=[+|-]REL")
    return out


def main(argv: list[str]) -> int:
    paths, thr_args, ignore_env = [], [], False
    it = iter(argv)
    for a in it:
        if a == "--threshold":
            nxt = next(it, None)
            if nxt is None:
                print("--threshold needs METRIC=REL", file=sys.stderr)
                return 2
            thr_args.append(nxt)
        elif a.startswith("--threshold="):
            thr_args.append(a.split("=", 1)[1])
        elif a == "--ignore-env":
            ignore_env = True
        else:
            paths.append(a)
    if len(paths) != 2:
        print("usage: python -m repro_torch.experiments diff OLD NEW "
              "[--threshold METRIC=[+|-]REL ...] [--ignore-env]\n"
              "  OLD/NEW: a Record-stream .jsonl file, or a directory of "
              "them (e.g. experiments/records/baseline)", file=sys.stderr)
        return 2
    try:
        thresholds = _parse_thresholds(thr_args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    try:
        try:
            oidx = read_stream(paths[0])
            nidx = read_stream(paths[1])
        except OSError as e:
            print(f"diff: cannot read stream: {e}", file=sys.stderr)
            return 2
        present = {k[2] for k in set(oidx) | set(nidx)}
        for m in thresholds:
            if m not in present:
                # a typo'd metric name would otherwise silently gate nothing
                print(f"warning: --threshold metric {m!r} matches no rows "
                      "in either stream", file=sys.stderr)
        diff_streams(oidx.values(), nidx.values())
        if thresholds and not ignore_env:
            mism = env_mismatches(oidx, nidx, thresholds)
            if mism:
                for m in mism:
                    print(f"ENV MISMATCH {m}", file=sys.stderr)
                print("diff: refusing to gate thresholds across "
                      "environments (--ignore-env overrides)",
                      file=sys.stderr)
                return 2
        violations = threshold_violations(oidx, nidx, thresholds)
        for v in violations:
            print(f"THRESHOLD EXCEEDED {v}", file=sys.stderr)
        if violations:
            return 1
    except BrokenPipeError:
        # downstream closed early (`diff ... | head`): not an error, but
        # stdout must be detached or the interpreter tracebacks on exit
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0
