"""Gradient bucketing: fuse a gradient tree into a few contiguous buffers.

Counterpart of ``repro/parallel/buckets.py``.  The paper's profitability
rule for in-path offloads is that the transform must keep up with the link
— launch overhead is the silent killer.  A leaf-wise compressed reduction
issues one quantize→exchange→dequantize chain per gradient leaf;
bucketing flattens the tree into a small number of size-capped fp32
fusion buffers so the whole tree crosses the slow axis in a few chains.

A ``BucketPlan`` is pure shape metadata, computed from one rank's leaf
shapes exactly as the reference computes it (the tests hold the two plans
equal): which leaves land in which bucket at which offset, and which
leaves stay out (``min_compress_size`` — tiny leaves reduce at full
precision, grouped into a single ``pmean``).  ``pack``/``unpack`` take the
leaves of all emulated ranks at once (``parallel/pods.py``): a leaf is
``(n, *shape)`` and a bucket buffer ``(n, size)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

DEFAULT_BUCKET_BYTES = 4 << 20   # fp32 bytes per fusion buffer
MIN_COMPRESS_SIZE = 4096         # leaves below this stay out of the buckets


@dataclass(frozen=True)
class Slot:
    """One leaf's placement inside a bucket."""
    leaf: int            # index into the flattened-leaf order
    offset: int          # element offset into the bucket buffer
    size: int
    shape: tuple
    dtype: torch.dtype


@dataclass(frozen=True)
class BucketPlan:
    """Partition of a leaf list into fusion buckets + passthrough leaves."""
    buckets: tuple       # tuple of tuples of Slot
    passthrough: tuple   # leaf indices that reduce at full precision
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def bucket_sizes(self) -> list:
        return [sum(s.size for s in b) for b in self.buckets]


def plan_buckets(shapes: Sequence[tuple], dtypes: Sequence[torch.dtype], *,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 min_compress_size: int = MIN_COMPRESS_SIZE) -> BucketPlan:
    """Greedy size-capped packing of one rank's leaves (``shapes`` and
    ``dtypes`` in flatten order).  A leaf bigger than the cap gets a bucket
    of its own; leaves below ``min_compress_size`` elements go to
    ``passthrough``."""
    cap = max(1, bucket_bytes // 4)   # buckets are fp32 buffers
    buckets, passthrough = [], []
    cur, cur_size = [], 0
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        size = 1
        for d in shape:
            size *= d
        if size < min_compress_size:
            passthrough.append(i)
            continue
        if cur and cur_size + size > cap:
            buckets.append(tuple(cur))
            cur, cur_size = [], 0
        cur.append(Slot(i, cur_size, size, tuple(shape), dtype))
        cur_size += size
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(tuple(buckets), tuple(passthrough), len(shapes))


def pack_bucket(plan: BucketPlan, i: int, leaves: Sequence) -> torch.Tensor:
    """Concatenate bucket ``i``'s leaves (``(n, *shape)`` each) into one
    ``(n, size)`` fp32 buffer.

    Split out of ``pack`` so a schedule (``parallel/overlap.py``) can
    materialize buckets one at a time."""
    return torch.cat([leaves[s.leaf].reshape(leaves[s.leaf].shape[0], -1)
                      .float() for s in plan.buckets[i]], dim=1)


def pack(plan: BucketPlan, leaves: Sequence) -> list:
    """Concatenate each bucket's leaves into one ``(n, size)`` fp32
    buffer."""
    return [pack_bucket(plan, i, leaves) for i in range(plan.n_buckets)]


def unpack_bucket(plan: BucketPlan, i: int, buf: torch.Tensor,
                  dtypes: Optional[Sequence] = None) -> dict:
    """Bucket ``i``'s buffer ``(n, size)`` back into its leaves:
    ``{leaf index: (n, *shape)}``, each in ``dtypes[leaf]`` when given,
    else the plan's dtype."""
    n = buf.shape[0]
    out = {}
    for s in plan.buckets[i]:
        dtype = dtypes[s.leaf] if dtypes is not None else s.dtype
        out[s.leaf] = buf[:, s.offset:s.offset + s.size].reshape(
            (n,) + s.shape).to(dtype)
    return out


def unpack(plan: BucketPlan, buffers: Sequence,
           dtypes: Optional[Sequence] = None) -> list:
    """Scatter bucket buffers back into a leaf list.

    Returns a list of ``plan.n_leaves`` entries: bucketed positions hold
    the restored leaf (shape from the plan, dtype from ``dtypes`` when
    given, else from the plan), passthrough positions hold ``None`` for
    the caller to fill."""
    out = [None] * plan.n_leaves
    for i, buf in enumerate(buffers):
        for leaf, t in unpack_bucket(plan, i, buf, dtypes).items():
            out[leaf] = t
    return out
