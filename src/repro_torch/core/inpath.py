"""In-path transform measurement — the embedded-function-mode experiment.

Counterpart of ``repro/core/inpath.py``.  The paper's Fig. 5/6: put the
processor *in the data path* (embedded function mode) and measure how
much CPU remains; compare the kernel network stack against a user-space
stack (DPDK).

The mapping: run an all-reduce over the ``pod`` axis five ways and
measure (a) wall time and (b) wire bytes per rank:

  stock         — ``PodAxis.pmean`` (the library reduction = "kernel stack")
  ring          — explicit ring of shifts            ("user-space stack")
  int8_a2a      — all_to_all with int8 compression   ("+ offloaded transform")
  int8_ring     — ring with per-hop int8 compression AND an int8 all-gather
                  (the deepest in-path variant, fully compressed wire)
  int8_pairwise — shape-preserving int8 ring broadcast-accumulate

**Emulated ranks.**  The reference runs these over fabricated host
devices, one rank a device.  The port's ranks are the leading dimension
of every tensor on ONE device (``parallel/pods.py``), so the registrations
need one device (``requires_devices=1``) and ``params["devices"]``
carries the pod count.  Every exchange is an on-device copy: the wall
times say what the transforms, the packing and the copies cost on the
card, never what a wire does.  The wire bytes come from the reference's
model (:func:`_wire_bytes`) with ``n`` = the pod count.

A second experiment, ``inpath.bucketing``, measures the *launch* side of
the profitability rule: a multi-leaf gradient tree reduced leaf-wise (one
collective chain per leaf) vs bucketed (one chain per fusion buffer plus
one grouped pmean), with the chain counts of one call and wall time per
step.

A third, ``inpath.headroom_overlap``, is the analogue of the paper's
headroom-during-transfer tables: how much of a synthetic compute kernel's
idle FLOP/s survives while a collective is in flight, serial (compute
after the transfer, one stream) vs overlapped (each next bucket packs and
the compute runs on side streams while the chains run on the caller's
stream, ``parallel/overlap.py``), per method.

Emits the unified ``Record`` schema; ``relative`` is the slowdown vs the
stock stack (stock == 1.0; for bucketing, vs the leaf-wise path; for
headroom_overlap, the overlapped step vs the serial one).
"""
from __future__ import annotations

import statistics
import time

import torch

from repro_torch import runtime
from repro_torch.experiments.measure import measure as _measure
from repro_torch.experiments.record import Record
from repro_torch.parallel import collectives as C
from repro_torch.parallel import overlap as O
from repro_torch.parallel.pods import PodAxis
from repro_torch.runtime import resolve_device

EXPERIMENT = "inpath.collectives"
EXPERIMENT_BUCKETING = "inpath.bucketing"
EXPERIMENT_OVERLAP = "inpath.headroom_overlap"

SCALE_BYTES = 4  # fp32 quantization scale carried per compressed block


def _wire_bytes(n: int, size: int, method: str) -> int:
    """Per-device wire bytes for an all-reduce of ``size`` fp32 elements.

    Compressed methods ship 1 B/element payload plus one fp32 scale per
    block.  ``int8_a2a`` quantizes per chunk row (n blocks of size/n
    elements, see ``collectives.compressed_psum``) in both exchange
    phases.  ``int8_ring`` requantizes per reduce-scatter hop (one chunk +
    scale per hop) and also quantizes the accumulator before the
    all-gather, so both phases cost ~1 B/element — ~2/8 of the stock fp32
    wire at large n.  ``int8_pairwise`` ships the whole payload (not a
    chunk) per hop with one rowwise scale — the measured payload here is a
    single row per device.  The reference checks these models against
    bytes counted from its compiled collective HLO."""
    full = size * 4
    if method == "stock":
        return int(2 * (n - 1) / n * full)          # ring all-reduce, fp32
    if method == "ring":
        return int(2 * (n - 1) / n * full)          # same schedule, explicit
    if method == "int8_a2a":
        # n chunk-blocks, each int8 payload + fp32 scale, both phases
        return int(2 * (n - 1) / n * (size + n * SCALE_BYTES))
    if method == "int8_ring":
        # reduce-scatter: int8 chunk + fp32 scale per hop;
        # all-gather: int8 owned chunk + fp32 scale, ring-gathered
        rs = (n - 1) / n * size + (n - 1) * SCALE_BYTES
        ag = (n - 1) / n * size + (n - 1) * SCALE_BYTES
        return int(rs + ag)
    if method == "int8_pairwise":
        # (n-1) hops, each the full int8 payload + one fp32 rowwise scale
        return int((n - 1) * (size + SCALE_BYTES))
    raise ValueError(method)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard-normal f32 ``shape`` on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device)


def _setup(pods: int, device, what: str):
    """(PodAxis, device, a generator seeded 0 on it)."""
    if pods < 2:
        raise RuntimeError(f"{what} needs >= 2 pods, got {pods}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return PodAxis(pods), device, gen


def _max_err(out: torch.Tensor, want: torch.Tensor) -> float:
    return float((out - want).abs().max())


def measure(size: int = 1 << 20, duration: float = 0.3, pods: int = 4,
            device="cuda") -> list[Record]:
    """The five all-reduce methods on every pod's ``(size,)`` f32 payload,
    under the ``quant_impl`` policy (``auto``: the int8 kernels from
    ``PALLAS_QUANT_MIN_SIZE`` elements a rank)."""
    ax, device, gen = _setup(pods, device, "in-path measurement")
    n = ax.n
    x = _normal(gen, (n, size))
    want = torch.mean(x, dim=0)

    def run(fn, method, stock_s=None):
        m = _measure(lambda: fn(x), duration)
        out = fn(x)
        err = _max_err(out, want[None])
        wall = m.s_per_call
        return Record(
            EXPERIMENT, method, "wall_s_per_call", wall, unit="s",
            relative=wall / stock_s if stock_s else 1.0,
            params={"wire_bytes_per_device": _wire_bytes(n, size, method),
                    "max_error": err, "size": size, "devices": n,
                    "median_s": m.median_s, "p90_s": m.p90_s})

    # the stock arm writes every rank's (size,) result, as the reference's
    # pmean(g) + 0 * g does (PodAxis.pmean alone is a broadcast view)
    stock = run(lambda g: ax.pmean(g) + 0 * g, "stock")
    stock_s = stock.value
    return [
        stock,
        run(lambda g: C.ring_allreduce(g, ax)[0], "ring", stock_s),
        run(lambda g: C.compressed_psum(g, ax)[0], "int8_a2a", stock_s),
        run(lambda g: C.ring_allreduce(g, ax, wire_int8=True)[0],
            "int8_ring", stock_s),
        run(lambda g: C.pairwise_int8_allreduce(g, ax)[0],
            "int8_pairwise", stock_s),
    ]


# ---------------------------------------------------------------------------
# bucketed vs leaf-wise gradient reduction
# ---------------------------------------------------------------------------

# A gradient-tree silhouette: a few compressible weight leaves plus small
# bias/norm leaves that stay below collectives.MIN_COMPRESS_SIZE.
BUCKETING_LEAF_SIZES = {
    "w_embed": 1 << 15, "w_attn": 1 << 14, "w_mlp": 3 * (1 << 13),
    "w_head": 1 << 14, "b_attn": 256, "b_mlp": 512, "ln_scale": 128,
}


def measure_bucketing(duration: float = 0.3, method: str = "int8_ring",
                      pods: int = 4, device="cuda") -> list[Record]:
    """Leaf-wise vs bucketed ``reduce_gradients`` over a multi-leaf tree:
    the collective-chain counts of one call and wall time per step."""
    ax, device, gen = _setup(pods, device, "bucketing measurement")
    n = ax.n
    tree = {name: _normal(gen, (n, s))
            for name, s in BUCKETING_LEAF_SIZES.items()}
    want = {k: torch.mean(v, dim=0, keepdim=True) for k, v in tree.items()}
    n_compressible = sum(
        1 for s in BUCKETING_LEAF_SIZES.values() if s >= C.MIN_COMPRESS_SIZE)

    def run(bucketed, base=None):
        def f(t):
            return C.reduce_gradients(t, ax, method, None,
                                      bucketed=bucketed)[0]
        C.reset_chain_count()
        out = f(tree)                       # one call -> chain count
        chains = C.chain_count()
        err = max(_max_err(out[k], want[k]) for k in tree)
        m = _measure(lambda: f(tree), duration)
        wall = m.s_per_call
        return Record(
            EXPERIMENT_BUCKETING, "bucketed" if bucketed else "leafwise",
            "wall_s_per_call", wall, unit="s",
            relative=wall / base if base else 1.0,
            params={"collective_chains": chains,
                    "leaves": len(BUCKETING_LEAF_SIZES),
                    "compressible_leaves": n_compressible,
                    "method": method, "quant_impl": "torch",
                    "max_error": err, "devices": n,
                    "median_s": m.median_s, "p90_s": m.p90_s})

    # pin ONE transform implementation for both arms (the reference pins
    # its "xla"; here the plain PyTorch version): the fused buffers cross
    # the kernel's auto-dispatch threshold while the individual leaves do
    # not, and this experiment isolates launch overhead (chain count), not
    # a kernel-impl switch
    with runtime.use_policy(quant_impl="torch"):
        leafwise = run(False)
        bucketed = run(True, base=leafwise.value)
    return [leafwise, bucketed]


# ---------------------------------------------------------------------------
# headroom during transfer: compute FLOP/s with a collective in flight
# ---------------------------------------------------------------------------

# "ring" rides along with the four wire variants: it is the chunked method
# with no quantize transform, so it shows the *schedule* effect cleanest.
OVERLAP_METHODS = ("stock", "int8_a2a", "int8_ring", "int8_pairwise", "ring")

OVERLAP_BUCKETS = 4          # gradient leaves == fusion buckets in the rig
OVERLAP_BUCKET_ELEMS = 1 << 17


def _wait() -> None:
    """Wait for the card (a no-op in a process that never touched it)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _paired_ratio(f_serial, f_over, args, duration: float, calls: int = 2):
    """``t_overlapped / t_serial`` as a ratio of per-arm *medians* over
    alternating serial/overlapped segments (``calls`` timed calls apiece).

    Interleaving the arms round by round cancels slow load drift on a
    shared host, and the per-arm median discards the stall-inflated
    segments a single co-tenant hiccup produces (a stall lands in one
    arm's segment, not both — a plain per-round ratio would keep it).
    Each segment ends with ``torch.cuda.synchronize()``.  Returns
    ``(ratio, t_serial_med, t_over_med, rounds)``."""
    f_serial(*args)                         # first calls of both arms
    f_over(*args)
    _wait()
    ts, to = [], []
    deadline = time.perf_counter() + max(2 * duration, 0.2)
    while time.perf_counter() < deadline or len(ts) < 3:
        t0 = time.perf_counter()
        for _ in range(calls):
            f_serial(*args)
        _wait()
        t1 = time.perf_counter()
        for _ in range(calls):
            f_over(*args)
        _wait()
        t2 = time.perf_counter()
        ts.append((t1 - t0) / calls)
        to.append((t2 - t1) / calls)
    ts_med, to_med = statistics.median(ts), statistics.median(to)
    return to_med / ts_med, ts_med, to_med, len(ts)


def synth_compute(m: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained ``c = tanh(c @ m)`` from ``c = m``, every rank's
    ``(d, d)`` at once (the backward segments a real step overlaps)."""
    c = m
    for _ in range(iters):
        c = torch.tanh(torch.matmul(c, m))
    return c


def overlap_step(ax: PodAxis, method: str, overlapped: bool,
                 bucket_elems: int, compute_iters: int):
    """One step of ``measure_headroom_overlap``: ``f(tree, m)`` reduces
    ``tree`` (one bucket a leaf) by ``method`` under the schedule and runs
    the synthetic compute on ``m`` beside it
    (``overlap.overlap_compute``).  Returns ``(reduced tree, compute
    output)``."""
    def reduce_tree(t):
        if method == "stock":
            return C.reduce_gradients(t, ax, "stock")[0]
        return C.reduce_gradients(t, ax, method, None,
                                  bucketed=None if method == "int8_pairwise"
                                  else True,
                                  bucket_bytes=bucket_elems * 4,
                                  overlap=overlapped)[0]

    def f(t, m):
        return O.overlap_compute(
            lambda: reduce_tree(t),
            lambda a: synth_compute(a, compute_iters), m,
            overlap=overlapped)
    return f


def measure_headroom_overlap(duration: float = 0.3,
                             n_buckets: int = OVERLAP_BUCKETS,
                             bucket_elems: int = OVERLAP_BUCKET_ELEMS,
                             compute_dim: int = 192,
                             compute_iters: int = 12, pods: int = 4,
                             device="cuda") -> list[Record]:
    """The paper's headroom-during-transfer tables, on the emulated pods.

    One step reduces an ``n_buckets``-leaf gradient tree (one fusion
    bucket per leaf) next to a synthetic compute kernel
    (``compute_iters`` chained (d x d) matmuls at PyTorch's default f32
    precision, standing in for the backward segments that overlap bucket
    chains in a real step).  Two schedules (``parallel/overlap.py``):
    *serial* issues one chain at a time on the caller's stream and runs
    the compute after the reduction (transfer, then process);
    *overlapped* packs each next bucket on a side stream while the
    chains run on the caller's stream, and runs the compute on a stream
    of its own beside them.

    ``overlap_efficiency = t_overlapped / t_serial`` per method (< 1.0
    means overlap recovered headroom; each method's serial arm is its own
    baseline, so the ratio isolates scheduling from wire format), measured
    as a ratio of per-arm medians over interleaved segments.  Params carry
    the idle vs in-flight FLOP/s of the compute kernel — the paper's "how
    much processing survives the transfer" number — counted per rank, as
    the reference counts per device (the card runs all ``pods`` ranks'
    compute, ``pods`` times that).  ``int8_pairwise`` stays serial on the
    chain side (its leaf-wise, shape-preserving exchanges have no pack
    stage to pipeline), so its overlapped arm frees only the compute.
    """
    ax, device, gen = _setup(pods, device, "headroom-overlap measurement")
    n = ax.n
    d = compute_dim
    tree = {f"w{i}": _normal(gen, (n, bucket_elems))
            for i in range(n_buckets)}
    want = {k: torch.mean(v, dim=0, keepdim=True) for k, v in tree.items()}
    a = _normal(gen, (n, d, d)) / d
    flops = compute_iters * 2 * d ** 3   # per rank, matmuls only

    records = []
    # the compute kernel alone: the idle-FLOP/s reference
    synth_compute(a, compute_iters)
    t_idle = _measure(lambda: synth_compute(a, compute_iters),
                      duration).s_per_call
    records.append(Record(
        EXPERIMENT_OVERLAP, "compute_idle", "flops_per_s", flops / t_idle,
        unit="flop/s", relative=1.0,
        params={"compute_dim": d, "compute_iters": compute_iters,
                "flops": flops, "devices": n, "wall_s_per_call": t_idle}))

    # pin the transform impl (the reference's "xla"; here the plain
    # PyTorch version): this experiment isolates the *schedule*, not the
    # kernel placement (cf. bucketing); the schedule itself is pinned per
    # arm through reduce_gradients(overlap=...)
    with runtime.use_policy(quant_impl="torch"):
        for method in OVERLAP_METHODS:
            f_serial = overlap_step(ax, method, False, bucket_elems,
                                    compute_iters)
            f_over = overlap_step(ax, method, True, bucket_elems,
                                  compute_iters)
            out = f_over(tree, a)          # correctness probe, both arms
            err = max(_max_err(out[0][k], want[k]) for k in tree)
            outs = f_serial(tree, a)
            err = max(err, max(_max_err(outs[0][k], want[k])
                               for k in tree))
            del out, outs
            eff, t_serial, t_over, rounds = _paired_ratio(
                f_serial, f_over, (tree, a), duration)
            records.append(Record(
                EXPERIMENT_OVERLAP, method, "overlap_efficiency", eff,
                unit="x", relative=eff,
                params={"t_serial_s": t_serial, "t_overlapped_s": t_over,
                        "t_compute_idle_s": t_idle,
                        "flops_per_s_idle": flops / t_idle,
                        "flops_per_s_in_flight": flops / t_over,
                        "paired_rounds": rounds,
                        "max_error": err,
                        "wire_bytes_per_device": n_buckets * _wire_bytes(
                            n, bucket_elems, method),
                        "n_buckets": n_buckets,
                        "bucket_elems": bucket_elems, "devices": n,
                        "compute_dim": d, "compute_iters": compute_iters}))
    return records
