"""Overlap scheduler: software-pipelined bucket-chain issue order.

Counterpart of ``repro/parallel/overlap.py``.  A bucket's collective chain
(quantize→exchange→dequantize, ``parallel/collectives.py``) is the
analogue of the paper's transfer; packing the next bucket is the
processing that could run while it is in flight.  Two schedules, with the
reference's issue order:

``serial``
    Bucket *i+1* packs only after bucket *i*'s chain has returned.

``pipelined``
    Bucket *i+1* is packed before bucket *i*'s chain is issued, so the
    two are ready together.

Both issue exactly the same chains in the same count and compute the same
values; only the order of the packs differs.  The reference pins that
order in XLA's graph with ``optimization_barrier``s (``after``,
``staged``, ``probe``).  Eager PyTorch on one stream runs every call in
the order it is made, so those three are value pass-throughs here and
order nothing: the Python order below *is* the schedule.  Running a chain
on a stream of its own while the next bucket packs is a later PR.

``resolve_overlap`` turns the three-way knob (explicit argument >
``runtime.policy()["overlap_schedule"]`` > auto) into a bool; auto
pipelines only when there is more than one bucket.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

from repro_torch import runtime
from repro_torch.obs import trace as obs_trace


# ---------------------------------------------------------------------------
# dependency edges (value pass-throughs: eager execution is already ordered)
# ---------------------------------------------------------------------------

def probe(tree):
    """The reference's scalar dependency handle; here the value itself."""
    return tree


def after(x, *deps):
    """``x``, unchanged: the reference gates its consumers on ``deps``;
    eager PyTorch has computed ``deps`` already."""
    return x


def staged(*xs):
    """``xs``, unchanged: the reference groups them into one stage."""
    return xs


# ---------------------------------------------------------------------------
# schedule resolution
# ---------------------------------------------------------------------------

def resolve_overlap(overlap: Optional[bool], n_buckets: int) -> bool:
    """Explicit argument > ``runtime.policy()["overlap_schedule"]`` > auto.

    Auto pipelines only multi-bucket trees: a single chain has nothing to
    overlap with."""
    if overlap is not None:
        return bool(overlap)
    mode = runtime.policy().get("overlap_schedule", "auto")
    if mode == "serial":
        return False
    if mode == "pipelined":
        return True
    if mode != "auto":
        raise ValueError(f"overlap_schedule policy {mode!r} "
                         "(want auto | serial | pipelined)")
    return n_buckets > 1


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def run_schedule(n: int, pack: Callable[[int], object],
                 exchange: Callable[[object], object],
                 overlap: bool) -> list:
    """Issue ``n`` pack→exchange chains under the chosen schedule.

    ``pack(i)`` materializes bucket ``i``'s fused buffer; ``exchange(buf)``
    runs its collective chain and may return anything.  Returns the list
    of ``exchange`` results in bucket order — identical values under both
    schedules.  (The reference's ``perturb`` hook, which splices fabric
    degradation into the schedule, comes with ``fabric/inject.py`` in a
    later slice of the port.)

    With a tracer installed (``obs.trace.use``) each pack and chain is a
    span on the ``overlap`` track, labelled with the schedule, and the
    ``chains_issued`` / ``chains_retired`` counters count the chains —
    the reference's spans and counters; eager, they time the stages
    themselves (host time: a stage ends when its last launch is
    issued)."""
    outs: list = []
    if n == 0:        # every leaf below the compress threshold: nothing
        return outs   # to schedule (the grouped pmean is the caller's)
    tr = obs_trace.current()
    if tr.enabled:
        lbl = "pipelined" if overlap else "serial"
        _pack, _exchange, _chain_no = pack, exchange, itertools.count()

        def pack(i):
            with tr.span("overlap", f"pack{i}", "overlap",
                         schedule=lbl, bucket=i):
                return _pack(i)

        def exchange(buf):
            i = next(_chain_no)
            tr.metrics.count("chains_issued")
            with tr.span("overlap", f"chain{i}", "overlap",
                         schedule=lbl, bucket=i):
                out = _exchange(buf)
            tr.metrics.count("chains_retired")
            return out
    if not overlap:
        done = None
        for i in range(n):
            buf = pack(i)
            if done is not None:
                buf = after(buf, done)
            out = exchange(buf)
            outs.append(out)
            done = probe(out)
        return outs

    # software pipeline: pack bucket 0, then (pack i+1, chain i)
    nxt = pack(0)
    for i in range(n):
        buf = nxt
        if i + 1 < n:
            nxt = pack(i + 1)
            buf, nxt = staged(buf, nxt)
        outs.append(exchange(buf))
    return outs
