"""Decorator-based experiment registry with declared requirements.

An *experiment* is a callable ``fn(*, duration: float) -> Iterable[Record]``
registered under a dotted name (``family.variant``).  Device/mesh
requirements are declared, not probed inside the experiment — the Runner
generalizes the stress-ng SKIP semantics the seed implemented ad hoc in
``stressors.run_suite``: an experiment whose requirements are unmet yields
a single skipped Record instead of raising.

SKIP semantics, precisely: ``requires_devices`` is checked by the Runner
*before* the experiment runs; unmet means one ``Record(skipped=True)``
with the shortfall in ``reason`` and the experiment is never called (the
paper's rdrand-on-ARM case).  An experiment may also yield its own skip
rows for per-row capability gaps (e.g. one stressor of a suite needing a
missing backend).  SKIPs never fail a run; exceptions *escaping* ``fn``
become ``Record(error=True)`` rows and do — declared-unmet is a SKIP,
unexpected-broken is an ERROR.

    @experiment("headroom.delay_sweep", classes=("NETWORK",), figure="2/4")
    def delay(*, duration: float):
        yield Record(...)

Names group by their first dotted component: ``--only headroom`` selects
every ``headroom.*`` registration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Optional, Protocol, \
    runtime_checkable

from repro_torch.experiments.record import Record


@runtime_checkable
class Experiment(Protocol):
    """What the Runner calls: keyword-only duration, yields Records."""

    def __call__(self, *, duration: float) -> Iterable[Record]: ...


@dataclass(frozen=True)
class ExperimentSpec:
    name: str                         # dotted: "family.variant"
    fn: Experiment
    classes: tuple[str, ...] = ()     # stressor-taxonomy classes touched
    requires_devices: int = 1
    figure: str = ""                  # paper figure/table this reproduces
    description: str = ""

    @property
    def family(self) -> str:
        return self.name.split(".", 1)[0]


_REGISTRY: dict[str, ExperimentSpec] = {}


def experiment(name: str, *, classes: Iterable[str] = (),
               requires_devices: int = 1, figure: str = "",
               description: str = "") -> Callable[[Experiment], Experiment]:
    """Register ``fn`` as an experiment; returns ``fn`` unchanged."""
    def deco(fn: Experiment) -> Experiment:
        register(ExperimentSpec(
            name=name, fn=fn, classes=tuple(classes),
            requires_devices=requires_devices, figure=figure,
            description=description or (fn.__doc__ or "").strip().split("\n")[0]))
        return fn
    return deco


def register(spec: ExperimentSpec) -> None:
    if spec.name in _REGISTRY:
        raise ValueError(f"experiment {spec.name!r} already registered")
    if not spec.name or spec.name.startswith("."):
        raise ValueError(f"bad experiment name {spec.name!r}")
    _REGISTRY[spec.name] = spec


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get(name: str) -> ExperimentSpec:
    return _REGISTRY[name]


def all_experiments() -> list[ExperimentSpec]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def select(only: Optional[Iterable[str]] = None) -> list[ExperimentSpec]:
    """Specs matching any of ``only`` (full name or family prefix)."""
    specs = all_experiments()
    if not only:
        return specs
    wanted = set(only)
    return [s for s in specs if s.name in wanted or s.family in wanted]


_BUILTIN_LOADED = False


def load_builtin() -> None:
    """Import the built-in registrations (idempotent).

    Lives behind a function, not a package-level import, so that
    ``repro_torch.experiments.record``/``measure`` stay importable from
    ``repro_torch.core`` without a cycle.
    """
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    from repro_torch.experiments import defs  # noqa: F401  (registers on import)
    _BUILTIN_LOADED = True  # only after the import succeeds, so a failed
    #                         load surfaces again instead of yielding an
    #                         empty registry on retry
