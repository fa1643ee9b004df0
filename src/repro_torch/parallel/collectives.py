"""Hand-scheduled collectives with in-path transforms, over emulated pods.

Counterpart of ``repro/parallel/collectives.py``: the paper's "embedded
function mode" — int8 quantization with error feedback fused into the
gradient all-reduce that crosses the slow ``pod`` axis — with the
reference's formulations, operation for operation:

  * ``compressed_psum``  — all_to_all + local reduce + all_gather, int8
    wire format in both phases.
  * ``pairwise_int8_allreduce`` — int8 ring broadcast-accumulate without
    reshaping the payload (plain quantization on purpose, as in the
    reference).
  * ``ring_allreduce``   — explicit ring reduce-scatter/all-gather, with
    ``wire_int8`` requantizing every hop and the final all-gather.

Every tensor here holds all ranks' values stacked on its leading dimension
and every exchange is a ``PodAxis`` operation on one device
(``parallel/pods.py``: a copy, not a wire).  The quantize/dequantize hot
spots route through ``kernels/ops.py`` — the one policy-dispatch door —
with all ranks' rows in ONE launch: the quantization is rowwise, so that
is bit-equal to each rank quantizing its own rows, and the size rule reads
one rank's payload, as the reference's per-device rule does.
``reduce_gradients`` fuses the gradient tree into bucket buffers
(``parallel/buckets.py``) and issues one chain per bucket under a schedule
(``parallel/overlap.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quant import PALLAS_QUANT_MIN_SIZE  # noqa: F401 —
#   the auto-dispatch threshold, re-exported for callers/tests of this module
from repro_torch.kernels.ref import INV127, SCALE_FLOOR
from repro_torch.models.common import tree_leaves, tree_structure, tree_unflatten
from repro_torch.parallel import buckets as B
from repro_torch.parallel import overlap as O
from repro_torch.parallel.pods import PodAxis

DEFAULT_BUCKET_BYTES = B.DEFAULT_BUCKET_BYTES
MIN_COMPRESS_SIZE = B.MIN_COMPRESS_SIZE
METHODS = ("stock", "int8_a2a", "int8_ring", "int8_pairwise", "ring")


# ---------------------------------------------------------------------------
# collective-chain accounting
# ---------------------------------------------------------------------------

# Number of collective chains (quantize->exchange->dequantize sequences, or
# grouped pmean calls) issued, as the reference counts them at trace time.
_CHAIN_COUNT = 0


def _count_chain() -> None:
    global _CHAIN_COUNT
    _CHAIN_COUNT += 1


def reset_chain_count() -> None:
    global _CHAIN_COUNT
    _CHAIN_COUNT = 0


def chain_count() -> int:
    return _CHAIN_COUNT


# ---------------------------------------------------------------------------
# int8 (de)quantization — the in-path transform
# ---------------------------------------------------------------------------

def _quantize_int8_plain(x: torch.Tensor, axis: int = -1):
    """Shape-preserving plain quantization along ``axis`` (the
    reference's ``_quantize_int8_jnp``; the pairwise form's transform)."""
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, SCALE_FLOOR) * INV127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_int8_plain(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def quantize_int8(x: torch.Tensor, axis: int = -1):
    """Symmetric per-slice int8 quantization of every rank's ``x (n, ...,
    C)``.  Returns (q, scale).

    Last-axis payloads route through ``kernels.ops`` — all ranks' rows in
    one launch, the size rule on one rank's payload; other axes quantize
    in plain PyTorch (the kernels are rowwise-only)."""
    if x.dim() >= 2 and axis in (-1, x.dim() - 1):
        C = x.shape[-1]
        q, s = ops.quantize_int8(x.reshape(-1, C).contiguous(),
                                 size=x[0].numel())
        return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))
    return _quantize_int8_plain(x, axis)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Every rank's ``q (n, ..., C)`` times its rowwise ``scale (n, ...,
    1)``, in one launch (any other scale shape: plain PyTorch)."""
    if (q.dim() >= 2 and scale.dim() == q.dim()
            and scale.shape[:-1] == q.shape[:-1] and scale.shape[-1] == 1):
        C = q.shape[-1]
        out = ops.dequantize_int8(q.reshape(-1, C).contiguous(),
                                  scale.reshape(-1, 1).contiguous(),
                                  size=q[0].numel())
        return out.reshape(q.shape)
    return _dequantize_int8_plain(q, scale)


# ---------------------------------------------------------------------------
# compressed all-reduce (all_to_all formulation)
# ---------------------------------------------------------------------------

def _to_chunks(x: torch.Tensor, n: int):
    """Every rank's payload, flattened to f32 and cut into ``n`` chunks:
    ``(n ranks, n chunks, c)`` and the zero padding added."""
    flat = x.reshape(x.shape[0], -1).float()
    pad = (-flat.shape[1]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(x.shape[0], n, -1), pad


def _from_chunks(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(n, n, c)`` (or ``(n, n*c)``) back to ``x``'s shape and dtype,
    dropping the padding."""
    y = y.reshape(x.shape[0], -1)
    return y[:, :x[0].numel()].reshape(x.shape).to(x.dtype)


def compressed_psum(x: torch.Tensor, pods: PodAxis, mean: bool = True):
    """int8-wire all-reduce of every rank's ``x (n, ...)``.

    Both exchange phases are compressed: the all_to_all ships int8 chunk
    rows + fp32 scales, and the second phase all_gathers the requantized
    partial sums the same way.  Returns (reduced, residual) where
    ``residual = x - dequant(quant(x))`` is each rank's local quantization
    error for error feedback."""
    _count_chain()
    n = pods.n
    chunks, _ = _to_chunks(x, n)                         # (n, n, c)
    q, s = quantize_int8(chunks)                         # int8, (n, n, 1)
    residual = _from_chunks(chunks - dequantize_int8(q, s), x)

    # exchange: rank i receives chunk i from every rank
    q = pods.all_to_all(q)                               # (n, n, c)
    s = pods.all_to_all(s)                               # (n, n, 1)
    partial = torch.sum(dequantize_int8(q, s), dim=1)    # (n, c)
    if mean:
        partial = partial / n
    q2, s2 = quantize_int8(partial[:, None])             # (n, 1, c)
    q2 = pods.all_gather(q2[:, 0])                       # (n, n, c)
    s2 = pods.all_gather(s2[:, 0])                       # (n, n, 1)
    return _from_chunks(dequantize_int8(q2, s2), x), residual


# ---------------------------------------------------------------------------
# shape-preserving pairwise int8 exchange (small pod counts)
# ---------------------------------------------------------------------------

def pairwise_int8_allreduce(x: torch.Tensor, pods: PodAxis,
                            mean: bool = True):
    """int8 ring broadcast-accumulate WITHOUT reshaping the payload: each
    rank ppermutes its int8 copy around the ring and accumulates.  The
    transform is plain PyTorch on purpose, as the reference keeps its
    shape-preserving jnp form (there: so GSPMD can partition it)."""
    _count_chain()
    n = pods.n
    xf = x.float()
    q, s = _quantize_int8_plain(xf)               # rowwise scales, same shape
    residual = (xf - _dequantize_int8_plain(q, s)).to(x.dtype)
    acc = _dequantize_int8_plain(q, s)
    for _ in range(n - 1):
        q = pods.ring_shift(q)
        s = pods.ring_shift(s)
        acc = acc + _dequantize_int8_plain(q, s)
    if mean:
        acc = acc / n
    return acc.to(x.dtype), residual


# ---------------------------------------------------------------------------
# explicit ring all-reduce (ppermute formulation)
# ---------------------------------------------------------------------------

def ring_allreduce(x: torch.Tensor, pods: PodAxis, mean: bool = True,
                   wire_int8: bool = False):
    """Ring reduce-scatter + all-gather via ring shifts.

    With ``wire_int8`` every hop carries int8 payloads (per-hop
    requantize) AND the final all-gather ships the requantized owned chunk.
    Returns (reduced, residual)."""
    _count_chain()
    n = pods.n
    rows = pods.axis_index(x.device)                     # each rank's index
    chunks, _ = _to_chunks(x, n)                         # (n, n, c)

    residual = torch.zeros_like(x)
    if wire_int8:
        q, s = quantize_int8(chunks)
        residual = _from_chunks(chunks - dequantize_int8(q, s), x)
        chunks = dequantize_int8(q, s)
        del q, s

    def hop(z):                                          # z: (n, c)
        if not wire_int8:
            return pods.ring_shift(z)
        qz, sz = quantize_int8(z[:, None])               # (n,1,c), (n,1,1)
        qz = pods.ring_shift(qz[:, 0])
        # keep sz at (1, 1) a rank: a (1,)-shaped scale fails the rowwise
        # guard and would silently drop the hot per-hop dequant to plain
        sz = pods.ring_shift(sz)
        return dequantize_int8(qz[:, None], sz)[:, 0]

    # reduce-scatter: after n-1 hops, rank i owns chunk (i+1) % n
    acc = chunks[rows, rows]
    for t in range(n - 1):
        acc = hop(acc)
        acc = acc + chunks[rows, (rows - 1 - t) % n]
    del chunks
    if mean:
        acc = acc / n
    # all-gather of owned chunks, rotated back into order (row j holds
    # chunk j+1); with wire_int8 the gather phase is compressed too
    # (quantize acc before all_gather), and the rotation moves the int8
    # rows and their scales before the rowwise dequantize — the same
    # values, a quarter of the bytes
    if wire_int8:
        qa, sa = quantize_int8(acc[:, None])             # (n,1,c), (n,1,1)
        qg = pods.all_gather(qa[:, 0])                   # (n, n, c) int8
        sg = pods.all_gather(sa[:, 0])                   # (n, n, 1) fp32
        out = dequantize_int8(torch.roll(qg, 1, dims=1),
                              torch.roll(sg, 1, dims=1))
    else:
        out = torch.roll(pods.all_gather(acc), 1, dims=1)
    return _from_chunks(out, x), residual


# ---------------------------------------------------------------------------
# gradient-tree reduction with error feedback
# ---------------------------------------------------------------------------

def _chain(x, pods: PodAxis, method: str):
    """One compressed (or explicit) all-reduce chain for one payload."""
    if method == "int8_a2a":
        return compressed_psum(x, pods)
    if method == "int8_pairwise":
        return pairwise_int8_allreduce(x, pods)
    if method == "int8_ring":
        return ring_allreduce(x, pods, wire_int8=True)
    if method == "ring":
        return ring_allreduce(x, pods)
    raise ValueError(method)


def _grouped_pmean(leaves, pods: PodAxis):
    """One pmean *call* for a whole list of leaves — one collective chain,
    as the reference's single variadic all-reduce."""
    _count_chain()
    return [pods.pmean(g) for g in leaves]


def reduce_gradients(grads, pods: PodAxis, method: str = "stock",
                     errors=None, *, bucketed: Optional[bool] = None,
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     overlap: Optional[bool] = None, fabric=None):
    """Cross-pod gradient reduction with error feedback.

    ``grads`` (and ``errors``, the error-feedback tree, or None) are nested
    dicts whose leaves hold every rank's value, ``(n, *shape)``.  method:
    stock | int8_a2a | int8_ring | int8_pairwise | ring.  Returns (grads,
    errors), both with the input tree structure and every rank's value.

    ``bucketed`` (None: on for the chunked forms, off for
    ``int8_pairwise``), ``bucket_bytes`` and ``overlap`` (None: the
    ``overlap_schedule`` policy) are the reference's.  The bucketed path
    releases its references to a leaf once the leaf is packed, so a
    caller that passes trees it holds no other reference to gets each
    bucket's inputs freed before the next chain.  A ``fabric`` condition
    other than a clean one raises: degraded-fabric injection
    (``fabric/inject.py``) is a later slice of the port."""
    if method not in METHODS:
        raise ValueError(method)
    if fabric is not None and not fabric.is_clean:
        raise NotImplementedError(
            "degraded-fabric injection into the gradient chains "
            "(fabric/inject.py) is a later slice of the port")
    if bucketed is None:
        bucketed = method != "int8_pairwise"
    structure = tree_structure(grads)
    flat = tree_leaves(grads)
    if method == "stock":
        return tree_unflatten(structure, [pods.pmean(g) for g in flat]), \
            errors
    if errors is None:
        eflat = [torch.zeros_like(g) for g in flat]
    else:
        if tree_structure(errors) != structure:
            raise ValueError("errors tree does not match grads tree")
        eflat = tree_leaves(errors)
    grads = errors = None
    if bucketed:
        outs, ress = _reduce_bucketed(flat, eflat, pods, method,
                                      bucket_bytes, overlap)
    else:
        outs, ress = _reduce_leafwise(flat, eflat, pods, method)
    return tree_unflatten(structure, outs), tree_unflatten(structure, ress)


def _reduce_leafwise(flat, eflat, pods: PodAxis, method: str):
    """One collective chain per compressible leaf (the pre-bucketing path)."""
    outs, ress = [], []
    for g, e in zip(flat, eflat):
        if g[0].numel() < MIN_COMPRESS_SIZE:
            _count_chain()
            outs.append(pods.pmean(g))
            ress.append(torch.zeros_like(e))
            continue
        out, res = _chain(g + e.to(g.dtype), pods, method)
        outs.append(out)
        ress.append(res.to(e.dtype))
    return outs, ress


def _reduce_bucketed(flat, eflat, pods: PodAxis, method: str,
                     bucket_bytes: int, overlap: Optional[bool] = None):
    """One collective chain per fusion bucket; error feedback is packed
    into the buckets and each chain's outputs are scattered back to
    per-leaf tensors as soon as the chain returns."""
    n = pods.n
    plan = B.plan_buckets([g.shape[1:] for g in flat],
                          [g.dtype for g in flat], bucket_bytes=bucket_bytes,
                          min_compress_size=MIN_COMPRESS_SIZE)
    overlap = O.resolve_overlap(overlap, plan.n_buckets)
    gdt = [g.dtype for g in flat]
    edt = [e.dtype for e in eflat]

    def pack_one(i):
        # gradient bucket + its error-feedback bucket, summed in f32 as the
        # reference sums the two packed buffers (in place: one buffer)
        buf = B.pack_bucket(plan, i, flat, empty=O.empty_on_caller)
        for s in plan.buckets[i]:
            buf[:, s.offset:s.offset + s.size] += eflat[s.leaf].reshape(n, -1)
            # packed: let it go (read on this stream, which may be the
            # pipelined schedule's side stream)
            O.mark_used(flat[s.leaf], eflat[s.leaf])
            flat[s.leaf] = eflat[s.leaf] = None
        return i, buf

    def exchange(item):
        i, buf = item
        out, res = _chain(buf, pods, method)
        return (B.unpack_bucket(plan, i, out, gdt),
                B.unpack_bucket(plan, i, res, edt))

    chains = O.run_schedule(plan.n_buckets, pack_one, exchange, overlap)
    outs = [None] * plan.n_leaves
    ress = [None] * plan.n_leaves
    for out, res in chains:
        for leaf in out:
            outs[leaf], ress[leaf] = out[leaf], res[leaf]
    if plan.passthrough:
        small = _grouped_pmean([flat[i] for i in plan.passthrough], pods)
        for j, i in enumerate(plan.passthrough):
            outs[i] = small[j]
            ress[i] = torch.zeros(eflat[i].shape, dtype=edt[i],
                                  device=eflat[i].device)
    return outs, ress
