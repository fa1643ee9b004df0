"""Chrome-trace-event schema validation, shared by tests and CI.

``validate_chrome_trace`` checks an exported trace dict the way a
loader would trip over it: the ``traceEvents`` envelope, known phase
codes, begin/end pairing per (pid, tid) track with matching names,
timestamps monotone (non-decreasing) per track in file order, and —
optionally — a set of categories that must be present
(``scripts/check_trace.py`` requires the serve-loop categories on the
CI artifact).  Returns a list of problem strings; empty means valid.
"""
from __future__ import annotations

from typing import Iterable

ALLOWED_PH = {"B", "E", "X", "i", "I", "C", "M"}


def validate_chrome_trace(data, require_categories: Iterable[str] = ()
                          ) -> list[str]:
    problems: list[str] = []
    if not isinstance(data, dict) or not isinstance(
            data.get("traceEvents"), list):
        return ["trace is not a dict with a 'traceEvents' list"]
    events = data["traceEvents"]
    seen_cats: set[str] = set()
    stacks: dict[tuple, list] = {}       # (pid, tid) -> open begin names
    last_ts: dict[tuple, float] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ALLOWED_PH:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":                    # metadata: no timestamp required
            if "name" not in e:
                problems.append(f"event {i}: metadata without a name")
            continue
        missing = [k for k in ("name", "ts", "pid", "tid") if k not in e]
        if missing:
            problems.append(f"event {i} ({ph}): missing {missing}")
            continue
        key = (e["pid"], e["tid"])
        ts = e["ts"]
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts {ts!r}")
            continue
        if key in last_ts and ts < last_ts[key]:
            problems.append(
                f"event {i} ({e['name']}): ts {ts} < {last_ts[key]} — "
                f"timestamps not monotone on track {key}")
        last_ts[key] = ts
        if e.get("cat"):
            seen_cats.add(e["cat"])
        if ph == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                problems.append(
                    f"event {i}: 'E' {e['name']!r} with no open span on "
                    f"track {key}")
            elif stack[-1] != e["name"]:
                problems.append(
                    f"event {i}: 'E' {e['name']!r} does not match open "
                    f"span {stack[-1]!r} on track {key}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"track {key}: unclosed spans {stack}")
    missing_cats = set(require_categories) - seen_cats
    if missing_cats:
        problems.append(
            f"required categories absent: {sorted(missing_cats)} "
            f"(present: {sorted(seen_cats)})")
    return problems
