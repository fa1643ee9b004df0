"""The port's Experiment API: one registry, schema, and runner for the
characterizations ported so far.

    from repro_torch.experiments import Record, Runner, experiment, measure

Counterpart of ``repro/experiments``.  Submodules:
  record    — the ``Record`` schema + JSONL/CSV emitters (reference text)
  measure   — the shared timing harness (warmup / CUDA sync / quantiles)
  registry  — ``@experiment`` decorator, specs, SKIP requirements
              (reference text)
  runner    — ``Runner``/``run_experiments`` over the registry; streams
              persist under ``experiments/records_torch/``
  diff      — compare two persisted streams (reference text)
  defs      — built-in registrations (loaded lazily via ``load_builtin``)

CLI: ``PYTHONPATH=src python -m repro_torch.experiments --help``.
"""
from repro_torch.experiments.measure import Measurement, measure  # noqa: F401
from repro_torch.experiments.record import (Record, read_csv,  # noqa: F401
                                            read_jsonl, write_csv,
                                            write_jsonl)
from repro_torch.experiments.registry import (Experiment,  # noqa: F401
                                              ExperimentSpec,
                                              all_experiments, experiment,
                                              load_builtin, select)
from repro_torch.experiments.runner import (Runner, RunReport,  # noqa: F401
                                            run_experiments)
