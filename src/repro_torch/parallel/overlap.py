"""Overlap scheduler: software-pipelined bucket-chain issue order.

Counterpart of ``repro/parallel/overlap.py``.  A bucket's collective chain
(quantize→exchange→dequantize, ``parallel/collectives.py``) is the
analogue of the paper's transfer; packing the next bucket is the
processing that could run while it is in flight.  Two schedules, with the
reference's issue order:

``serial``
    Bucket *i+1* packs only after bucket *i*'s chain has returned, all on
    the caller's stream: one transfer in flight at a time.

``pipelined``
    Bucket *i+1* is packed before bucket *i*'s chain is issued.  On CUDA
    tensors bucket *i+1* packs on a side ``torch.cuda.Stream`` while
    chain *i* runs on the caller's stream: each pack waits on an event
    recorded on the caller's stream as it is issued (the leaves, and
    chain *i-1*, are done), and each chain on an event recorded after
    its pack.

Both issue exactly the same chains in the same count and compute the same
values, bit for bit; only the order (and, on the card, the stream) of the
work differs.  The reference pins that order in XLA's graph with
``optimization_barrier``s (``after``, ``staged``, ``probe``); eager
PyTorch runs every call in the order it is made, so those three are value
pass-throughs here and the Python order below is the schedule.  On CPU
tensors there is one stream and nothing runs concurrently.

Why the packs, not the chains, take the side stream, and why a pack's
buffer comes from the caller's pool (``empty_on_caller``): the caching
allocator keeps a pool of blocks per stream, and a block goes back to
the pool of the stream that allocated it.  A chain's scratch (a bucket's
chunks, int8 copies, dequantized partial sums: several times the
bucket) and its outputs on a side stream filled a second pool beside the
one the backward pass has warmed; at full-width OLMo-1B over 4 pods on
an NVIDIA H100 80GB HBM3 (700.00 W) that split left ~21 GiB reserved
that the step could not use and ran out of memory.  Bucket buffers
allocated on the side stream stranded 16 GiB there and slowed the
step's reduction (PERF.md §6).  Allocated from the caller's pool, a
buffer is safe to write on the side stream because the pack waits on
the caller's stream as it was when the block was handed out.

``overlap_compute`` is the same choice for one collective beside one
compute payload (``inpath.headroom_overlap``): serial runs the compute
after the collective on the caller's stream; overlapped runs it on a side
stream, gated on an event recorded when its inputs are ready.

Allocator safety: a tensor allocated on one stream and used on another is
marked with ``record_stream`` (the packed buffers on the caller's stream,
the leaves a pack reads on the side stream — ``mark_used`` —, the
compute's inputs and outputs likewise), so the caching allocator does not
hand its memory out again while the other stream may still read it.

``resolve_overlap`` turns the three-way knob (explicit argument >
``runtime.policy()["overlap_schedule"]`` > auto) into a bool; auto
pipelines only when there is more than one bucket.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

import torch

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
# streams
# ---------------------------------------------------------------------------

def _tensors(obj):
    """Every tensor in ``obj`` (nested tuples, lists and dict values)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _cuda_device(obj):
    """The device of the first CUDA tensor in ``obj``, or None."""
    return next((t.device for t in _tensors(obj) if t.is_cuda), None)


def _used_on(obj, stream) -> None:
    """Mark every CUDA tensor in ``obj`` as used on ``stream``."""
    for t in _tensors(obj):
        if t.is_cuda:
            t.record_stream(stream)


def mark_used(*tensors) -> None:
    """Mark CUDA ``tensors`` as used on the current stream: a pack that
    runs on the side stream and lets go of the leaves it read calls this
    first, so their memory is not handed out again before the side stream
    has read them (a no-op on the stream that allocated them)."""
    for t in tensors:
        if t is not None and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


# The caller's stream of each device while a pipelined schedule packs on
# the side stream (``empty_on_caller``).
_CALLER: dict = {}


def empty_on_caller(shape, dtype, device) -> torch.Tensor:
    """``torch.empty`` from the pool of the stream that issued the
    running pipelined schedule (the caller's; outside one, the current
    stream's): a pack's buffer, consumed and freed on the caller's
    stream, returns to the pool the rest of the step allocates from."""
    home = _CALLER.get(torch.device(device))
    if home is None:
        return torch.empty(shape, dtype=dtype, device=device)
    with torch.cuda.stream(home):
        return torch.empty(shape, dtype=dtype, device=device)


# One side stream per (device, role), kept for the life of the process.
# The caching allocator keeps a pool of blocks per stream, and
# ``torch.cuda.Stream()`` hands out the next of a rotating pool of
# streams: a fresh stream a call would find no cached block of its own
# and allocate (and, once memory runs short, free with a device sync) its
# scratch anew on every call.
_SIDE_STREAMS: dict = {}


def _side_stream(device, role: str):
    key = (device, role)
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=device)
    return _SIDE_STREAMS[key]


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

    Pipelined, with CUDA tensors in bucket 0's packed buffer, buckets 1
    to n-1 pack on the device's side stream and the chains run on the
    caller's (module docstring); a ``pack`` allocates its buffer with
    ``empty_on_caller``, and one that frees what it read must call
    ``mark_used`` on it first.

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
    dev = _cuda_device(nxt)
    if dev is None:
        for i in range(n):
            buf = nxt
            if i + 1 < n:
                nxt = pack(i + 1)
                buf, nxt = staged(buf, nxt)
            outs.append(exchange(buf))
        return outs

    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev, "packs")
    ready = None
    _CALLER[dev] = main
    try:
        for i in range(n):
            buf, packed = nxt, ready
            if i + 1 < n:
                issued = torch.cuda.Event()
                issued.record(main)         # the leaves, chain i-1
                side.wait_event(issued)
                with torch.cuda.stream(side):   # pack i+1 beside chain i
                    nxt = pack(i + 1)
                    ready = torch.cuda.Event()
                    ready.record(side)
            if packed is not None:
                main.wait_event(packed)     # chain i after its pack
                _used_on(buf, main)
            outs.append(exchange(buf))
            del buf
    finally:
        del _CALLER[dev]
    return outs


def overlap_compute(collective: Callable[[], object],
                    compute: Callable, compute_inputs,
                    overlap: bool) -> tuple:
    """One collective beside one compute payload — the
    headroom-during-transfer shape (``inpath.headroom_overlap``).

    ``collective()`` is a thunk; ``compute(compute_inputs)`` consumes its
    inputs *through this function* so the serial arm can order them.
    Serial: the compute runs after the whole collective, on the caller's
    stream (transfer, then process — the single-stream model).
    Overlapped, with CUDA inputs: the compute is issued first, on a side
    stream gated by an event recorded when its inputs are ready, so it
    runs while the collective's work goes through the caller's stream;
    the caller's stream waits on the compute's completion event before
    this returns.  On CPU tensors both arms run the collective, then the
    compute.  Returns ``(collective_result, compute_result)``."""
    dev = _cuda_device(compute_inputs)
    if not overlap or dev is None:
        r = collective()
        return r, compute(compute_inputs)
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev, "compute")
    ready = torch.cuda.Event()
    ready.record(main)
    _used_on(compute_inputs, side)
    side.wait_event(ready)
    with torch.cuda.stream(side):
        out = compute(compute_inputs)
        done = torch.cuda.Event()
        done.record(side)
    r = collective()
    _used_on(out, main)
    main.wait_event(done)
    return r, out
