"""The single entry point for running the port's characterizations.

Counterpart of ``repro/experiments/runner.py``; what differs: the device
count and the environment stamp come from PyTorch and ``nvidia-smi``, the
default records directory is ``experiments/records_torch/`` (H100 streams
are never diffed against the reference's ``experiments/records/``), and a
Runner built with a ``device`` passes it to every experiment it calls,
with ``devices``: the number of ranks the run may start, one process a
rank (``parallel/dist.py``) — the port's counterpart of the reference's
fabricated devices, and the count the SKIP rule reads (by default the
CUDA devices visible, or 1 on the CPU).

The Runner walks selected registry specs, enforces declared requirements,
stamps wall-clock metadata on every Record, persists the Record stream,
and keeps error Records separate so callers can exit nonzero — the seed's
``benchmarks/run.py`` swallowed exceptions into a CSV row and always
exited 0.

SKIP vs ERROR semantics (the stress-ng convention, see also
``registry``): an experiment whose **declared** requirement is unmet
(``requires_devices`` > available) is never called — the Runner emits one
Record with ``skipped=True`` and a human-readable ``reason``.  SKIPs are
informational and leave ``RunReport.ok`` True.  An exception *escaping* an
experiment becomes a Record with ``error=True``; errors flip ``ok`` and
the CLI exit status.  Records an experiment yields itself (including its
own skip rows) pass through unchanged apart from ``stamp()``.

Persistence: unless ``records_dir=None``, every run streams its Records
to ``<records_dir>/run-<timestamp>-<pid>-<seq>.jsonl`` (default
``experiments/records_torch/``) as they are produced — a crash mid-run leaves
the rows measured so far on disk.  Every emitted Record is stamped with
the producing git commit (``params["git_commit"]``, when a repo is
reachable) so a persisted stream identifies its code version.
``RunReport.records_path`` names the file; ``python -m
repro_torch.experiments diff old.jsonl new.jsonl [--threshold
METRIC=[+|-]REL]`` compares two such streams and can gate on per-metric,
direction-aware noise thresholds (see ``repro_torch.experiments.diff``).
"""
from __future__ import annotations

import inspect
import itertools
import os
import subprocess
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from repro_torch.experiments import record as rec
from repro_torch.experiments import registry as reg
from repro_torch.experiments.record import Record

DEFAULT_RECORDS_DIR = os.path.join("experiments", "records_torch")

_RUN_SEQ = itertools.count()   # disambiguates same-second runs in-process


@dataclass
class RunReport:
    records: list[Record] = field(default_factory=list)
    errors: list[Record] = field(default_factory=list)   # subset of records
    skips: list[Record] = field(default_factory=list)    # subset of records
    records_path: Optional[str] = None   # persisted JSONL stream, if any

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_experiment(self, name: str) -> list[Record]:
        return [r for r in self.records if r.experiment == name]


def _git_commit() -> Optional[str]:
    """The commit of the checkout this code runs from, or None when it is
    not a git repo / git is unavailable.

    Resolved against this file's directory, NOT the process cwd — a run
    launched from inside some other repository must not stamp Records with
    that repo's HEAD.  Every Record a Runner emits carries the sha
    (``params["git_commit"]``) so a persisted stream identifies the code
    that produced it — the regression-diff CI job keys on this."""
    try:
        p = subprocess.run(["git", "rev-parse", "HEAD"],
                           capture_output=True, text=True, timeout=10,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    except Exception:
        return None
    sha = p.stdout.strip()
    return sha if p.returncode == 0 and sha else None


def _backend(device: Optional[str]) -> str:
    """``"cuda"`` or ``"cpu"``: the device's type, or, for a Runner built
    without one, whether the process sees a card."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _device_count(device: Optional[str] = None) -> int:
    """CUDA devices visible to the run, or 1 on the CPU."""
    if _backend(device) == "cuda":
        return torch.cuda.device_count()
    return 1


def _card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    name, limit = p.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"card": name.strip(), "power_limit": limit.strip()}


def _environment(ndev: int, device: Optional[str] = None) -> dict:
    """Uniform environment stamp every emitted Record carries
    (``params["env"]``): the backend (``"cuda"`` or ``"cpu"``), device
    count, platform and hostname, and on the card its name and power
    limit — a number measured on a card set below its full power runs
    slower under load, so every record on the card says which it was.
    ``diff`` refuses to gate thresholds across rows whose (backend,
    platform) differ — a CPU-vs-GPU "regression" is a comparison error,
    not a regression (``--ignore-env`` overrides)."""
    import platform
    import sys as _sys
    backend = _backend(device)
    env = {"backend": backend, "device_count": ndev,
           "platform": _sys.platform, "hostname": platform.node()}
    if backend == "cuda":
        env.update(_card())
    return env


class Runner:
    """Run registered experiments and emit the unified Record stream.

    ``records_dir`` is where the per-run JSONL stream lands (created on
    demand); pass ``None`` to disable persistence (unit tests, dry probes).
    ``device`` (``"cuda"`` or ``"cpu"``), when given, is passed to every
    experiment as ``device=`` (the built-in ones take it; the CLI always
    gives it), and the rank count as ``devices=`` to those whose function
    takes it (the rank families); ``None`` calls each with ``duration``
    alone, on its own default device.  ``devices`` (None: the devices
    visible) is the number of ranks the run may start.
    """

    def __init__(self, duration: float = 0.25,
                 only: Optional[Iterable[str]] = None,
                 load_builtin: bool = True,
                 records_dir: Optional[str] = DEFAULT_RECORDS_DIR,
                 device: Optional[str] = None,
                 devices: Optional[int] = None):
        if load_builtin:
            reg.load_builtin()
        if devices is not None and devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.duration = duration
        self.specs = reg.select(only)
        self.records_dir = records_dir
        self.device = device
        self.devices = devices

    def _open_stream(self):
        """(path, fh) for this run's JSONL stream, or (None, None)."""
        if not self.records_dir:
            return None, None
        os.makedirs(self.records_dir, exist_ok=True)
        name = (f"run-{time.strftime('%Y%m%d-%H%M%S')}"
                f"-{os.getpid()}-{next(_RUN_SEQ)}.jsonl")
        path = os.path.join(self.records_dir, name)
        return path, open(path, "w")

    def run(self, emit: Optional[Callable[[Record], None]] = None,
            verbose: bool = False) -> RunReport:
        report = RunReport()
        ndev = (_device_count(self.device) if self.devices is None
                else self.devices)
        commit = _git_commit()
        env = _environment(ndev, self.device)
        kw = {} if self.device is None else {"device": self.device}
        report.records_path, stream = self._open_stream()

        def out(r: Record) -> Record:
            if commit is not None:
                r.params.setdefault("git_commit", commit)
            r.params.setdefault("env", dict(env))
            report.records.append(r)
            if r.error:
                report.errors.append(r)
            if r.skipped:
                report.skips.append(r)
            if stream:
                stream.write(r.to_json() + "\n")
                stream.flush()   # crash mid-run keeps the rows so far
            if emit:
                emit(r)
            return r

        try:
            for spec in self.specs:
                t0 = time.perf_counter()
                if ndev < spec.requires_devices:
                    out(rec.skip(spec.name,
                                 f"needs >= {spec.requires_devices} devices, "
                                 f"have {ndev}").stamp(t0))
                    continue
                # pull records manually so only *experiment* exceptions
                # become ERROR rows — a failing emit callback (closed pipe,
                # full disk) propagates to the caller instead of being
                # misattributed to the experiment under measurement
                takes = inspect.signature(spec.fn).parameters
                ranks = ({"devices": ndev}
                         if kw and "devices" in takes else {})
                try:
                    it = iter(spec.fn(duration=self.duration, **kw,
                                      **ranks))
                except Exception as e:
                    if verbose:
                        traceback.print_exc()
                    out(rec.failure(spec.name, e).stamp(t0))
                    continue
                while True:
                    try:
                        r = next(it)
                    except StopIteration:
                        break
                    except Exception as e:
                        if verbose:
                            traceback.print_exc()
                        out(rec.failure(spec.name, e).stamp(t0))
                        break
                    out(r.stamp(t0))
        finally:
            if stream:
                stream.close()
        return report


def run_experiments(duration: float = 0.25,
                    only: Optional[Iterable[str]] = None,
                    records_dir: Optional[str] = DEFAULT_RECORDS_DIR,
                    device: Optional[str] = None) -> RunReport:
    """One-call convenience wrapper."""
    return Runner(duration=duration, only=only, records_dir=records_dir,
                  device=device).run()
