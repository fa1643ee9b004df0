"""CLI: run registered experiments and emit the unified Record stream.

    PYTHONPATH=src python -m repro_torch.experiments [--only serve,fabric]
        [--duration 0.25] [--format csv|jsonl] [--out FILE]
        [--records-dir DIR | --no-records] [--list]
    PYTHONPATH=src python -m repro_torch.experiments diff old.jsonl \
        new.jsonl [--threshold METRIC=REL ...]

Counterpart of ``python -m repro.experiments``, with its flags and exit
codes: nonzero when any experiment errors (SKIPs are not errors), 2 for a
selection that matches nothing.  The experiments run on the CUDA device
(the command raises where there is none; ``main(argv, device="cpu")`` is
the tests' way onto the CPU).  ``--devices N`` fabricates host devices in
the reference; here it is the number of ranks, one process each, that the
rank families (``fabric.collectives_degraded``, the collective stressors)
may start over gloo (``parallel/dist.py``), and the count the Runner's
SKIP rule reads; without it, the CUDA devices visible.  Every run
persists its Record stream as JSONL under ``experiments/records_torch/``
(``--records-dir`` moves it, ``--no-records`` turns it off), each Record
stamped with the producing git commit and, on the card, its name and
power limit; ``diff`` compares two persisted streams per experiment and
exits nonzero when a ``--threshold``-gated metric moves more than its
noise bound.  Either ``diff`` argument may be a directory of ``*.jsonl``
streams.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Optional


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments",
        description="Run paper characterization experiments.",
        epilog="subcommand: 'diff OLD NEW [--threshold "
               "METRIC=[+|-]REL ...]' compares two persisted Record streams "
               "per experiment (each argument a .jsonl file or a directory "
               "of them, e.g. experiments/records/baseline); --threshold "
               "gates that metric's relative delta (+ = increases only, "
               "- = drops only) and flips the exit status when exceeded.")
    ap.add_argument("--only", default=None,
                    help="comma-separated experiment names or family "
                         "prefixes (e.g. 'serve,fabric.serve_tail')")
    ap.add_argument("--duration", type=float, default=0.25,
                    help="seconds of timed calls per measurement")
    ap.add_argument("--format", choices=("csv", "jsonl"), default="csv")
    ap.add_argument("--out", default=None,
                    help="write records to FILE instead of stdout")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks the multi-rank families may start, one "
                         "process each over gloo (default: the CUDA "
                         "devices visible)")
    recs = ap.add_mutually_exclusive_group()
    recs.add_argument("--records-dir", default=None, metavar="DIR",
                      help="directory for the persisted per-run JSONL Record "
                           "stream (default: experiments/records_torch)")
    recs.add_argument("--no-records", action="store_true",
                      help="do not persist the per-run Record stream")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a unified span trace (repro_torch.obs) "
                         "across the run and save it as Chrome-trace-event "
                         "JSON at PATH (open in Perfetto / chrome://tracing)")
    ap.add_argument("--list", action="store_true",
                    help="list registered experiments and exit")
    ap.add_argument("--verbose", action="store_true",
                    help="print tracebacks for failing experiments")
    return ap.parse_args(argv)


def main(argv: Optional[list[str]] = None, device="cuda") -> int:
    """Run the CLI.  ``device`` is a Python-level argument for tests
    (``"cpu"``); the command line always runs on the CUDA device."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "diff":
        from repro_torch.experiments.diff import main as diff_main
        return diff_main(argv[1:])
    if argv and argv[0] == "run":   # optional subcommand: running is the
        argv = argv[1:]             # default action, 'run' names it

    args = _parse(argv)
    if args.devices is not None and args.devices < 1:
        print(f"--devices {args.devices}: need at least one",
              file=sys.stderr)
        return 2

    from repro_torch.experiments import record as rec
    from repro_torch.experiments import registry as reg
    from repro_torch.experiments.runner import Runner

    if args.list:
        reg.load_builtin()
        for s in reg.all_experiments():
            req = f" [>= {s.requires_devices} dev]" \
                if s.requires_devices > 1 else ""
            print(f"{s.name:24s} {s.figure:18s}{req} {s.description}")
        return 0

    from repro_torch.experiments.runner import DEFAULT_RECORDS_DIR
    from repro_torch.runtime import resolve_device
    device = str(resolve_device(device))
    records_dir = (None if args.no_records
                   else args.records_dir or DEFAULT_RECORDS_DIR)
    only = args.only.split(",") if args.only else None
    runner = Runner(duration=args.duration, only=only,
                    records_dir=records_dir, device=device,
                    devices=args.devices)
    if not runner.specs:
        print(f"no experiments match --only {args.only!r}", file=sys.stderr)
        return 2

    tracer = None
    if args.trace_out:
        # installed thread-locally: every traced layer (serve engines,
        # overlap schedules, train steps) reaches it via obs.current()
        from repro_torch.obs import Tracer
        tracer = Tracer(metadata={"cli": "repro_torch.experiments",
                                  "only": args.only or "all"})

    try:
        with contextlib.ExitStack() as stack:
            if tracer is not None:
                from repro_torch.obs import trace as obs_trace
                stack.enter_context(obs_trace.use(tracer))
            fh = (stack.enter_context(open(args.out, "w")) if args.out
                  else sys.stdout)
            if args.format == "csv":
                import csv
                w = csv.writer(fh)
                w.writerow(rec.CSV_FIELDS)
                emit = lambda r: w.writerow(r.to_csv_row())  # noqa: E731
            else:
                emit = lambda r: fh.write(r.to_json() + "\n")  # noqa: E731
            report = runner.run(emit=emit, verbose=args.verbose)
            fh.flush()
    except BrokenPipeError:
        # stdout consumer closed early (`... | head`): truncation was asked
        # for, not an error; detach stdout so the interpreter exits quietly
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0

    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"[experiments] trace: {args.trace_out} "
              f"({len(tracer.events)} events)", file=sys.stderr)

    n = len(report.records)
    print(f"[experiments] {n} records, {len(report.skips)} skipped, "
          f"{len(report.errors)} errors", file=sys.stderr)
    if report.records_path:
        print(f"[experiments] record stream: {report.records_path}",
              file=sys.stderr)
    for r in report.errors:
        print(f"[experiments] ERROR {r.experiment}: {r.reason}",
              file=sys.stderr)
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())
