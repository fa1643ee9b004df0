"""The wire model of a step's collectives, and the rank axis that records
them.

Counterpart of ``repro/analysis/hlo.py``.  The reference parses every
collective out of a compiled module's HLO text; the port has no HLO, so
the collectives come from :class:`RecordingAxis`: a stand-in for
``parallel/pods.DistPodAxis`` that exchanges nothing.  Each exchange
reaches ``DistPodAxis._exchange`` (``ring_shift`` and ``ring_unshift``
through ``_shift``, ``psum`` and ``pmax`` as all-reduces, ``all_gather``
and ``all_gather_dim``, ``all_to_all``, and ``reduce_scatter``, which
gloo runs as an all-to-all of the ranks' chunks), and there the
recording axis logs one :class:`CollectiveOp` — kind, bytes in and out,
the dtype it exchanges, the axis's group — and hands back an empty
tensor of the result's shape on the input's device (the meta device in a
dry run).  ``DistModelAxis`` delegates to a pods object, so one recording
class serves ``model``, ``data`` and ``pod`` alike.  ``all_true`` and
``barrier``, the host-side agreement over the ``control`` group, answer
at once.

Wire bytes per op (ring schedules, ``n`` = the group's size), as the
reference's:

  all-reduce          2 (n-1)/n x bytes(operand)
  all-gather            (n-1)/n x bytes(result)
  reduce-scatter        (n-1)/n x bytes(operand)
  all-to-all            (n-1)/n x bytes(operand)
  collective-permute              bytes(operand)

**Links of the H100.**  The ranks sit row-major on the mesh, as
``parallel/dist.grid_axes`` lays them out, in nodes of :data:`NODE_CARDS`
(8) cards.  A group whose ranks all lie in one node is ``ici``: NVLink,
450 GB/s a direction a card (900 GB/s in all, the H100 SXM data sheet);
a group that spans nodes is ``dcn``: one InfiniBand NDR port a card,
400 Gb/s, 50 GB/s (``analysis/roofline.py`` holds both rates).  The
JSON keys keep the reference's names, ``wire_ici`` and ``wire_dcn``.

**The dtype on the wire** is the one the port exchanges: ``psum`` and
``pmean`` widen a bf16 or f16 tensor to f32 before the all-reduce
(``DistPodAxis.psum``), so such an all-reduce moves twice the bf16 bytes.
The reference instead halves every f32 payload as a TPU correction
(``wire_bytes_tpu``); the port makes no correction, and ``summarize``'s
totals are the bytes the port would send.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch

from repro_torch.parallel.pods import DistPodAxis

NODE_CARDS = 8          # H100 SXM cards a node, joined by NVLink

# the port's exchange kinds -> the reference's HLO op names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "ring_shift": "collective-permute"}


@dataclass
class CollectiveOp:
    kind: str
    comp: str               # the mesh axis that exchanged
    operand_bytes: int
    result_bytes: int
    group_size: int
    n_groups: int
    is_dcn: bool
    count: float = 1.0
    is_f32: bool = False

    @property
    def wire_bytes(self) -> float:
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2 * (n - 1) / n * self.operand_bytes
        if self.kind == "all-gather":
            return (n - 1) / n * self.result_bytes
        if self.kind in ("reduce-scatter", "all-to-all"):
            return (n - 1) / n * self.operand_bytes
        return float(self.operand_bytes)  # collective-permute


@dataclass
class CollectiveSummary:
    total_wire_bytes: float = 0.0
    raw_wire_bytes: float = 0.0
    ici_wire_bytes: float = 0.0
    dcn_wire_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)
    n_ops: int = 0

    def to_dict(self):
        return {"total_wire_bytes": self.total_wire_bytes,
                "raw_wire_bytes": self.raw_wire_bytes,
                "ici_wire_bytes": self.ici_wire_bytes,
                "dcn_wire_bytes": self.dcn_wire_bytes,
                "by_kind": self.by_kind, "n_ops": self.n_ops}


def collective_counts(ops: list[CollectiveOp]) -> dict[str, float]:
    """Collective counts by kind (each op weighted by its ``count``)."""
    out: dict[str, float] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0.0) + op.count
    return out


def summarize(ops: list[CollectiveOp]) -> CollectiveSummary:
    """Totals of the wire bytes as exchanged (no dtype correction:
    ``raw_wire_bytes`` equals ``total_wire_bytes``)."""
    s = CollectiveSummary()
    for op in ops:
        wb = op.wire_bytes * op.count
        s.total_wire_bytes += wb
        s.raw_wire_bytes += wb
        if op.is_dcn:
            s.dcn_wire_bytes += wb
        else:
            s.ici_wire_bytes += wb
        k = s.by_kind.setdefault(op.kind, {"wire_bytes": 0.0, "count": 0.0})
        k["wire_bytes"] += wb
        k["count"] += op.count
        s.n_ops += 1
    return s


# ---------------------------------------------------------------------------
# the recording rank axis
# ---------------------------------------------------------------------------

_LOGS: list = []        # the open recordings (recording())


@contextlib.contextmanager
def recording():
    """Collect the :class:`CollectiveOp` of every recording axis's
    exchange while the block runs, into the yielded list."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def spans_nodes(ranks) -> bool:
    """Whether the global ranks ``ranks`` lie in more than one node."""
    return len({r // NODE_CARDS for r in ranks}) > 1


@dataclass
class RecordingAxis(DistPodAxis):
    """Rank ``rank`` of a group of ``n`` that exchanges nothing: each
    exchange is logged (:func:`recording`) and returns an empty tensor of
    its result's shape.  ``name``: the mesh axis; ``ranks``: the group's
    global ranks, in the axis's order; ``n_groups``: how many such groups
    the mesh has."""
    backend: str = "record"
    name: str = ""
    ranks: tuple = ()
    n_groups: int = 1

    def __post_init__(self):
        if not 0 <= self.rank < self.n:
            raise ValueError(f"rank {self.rank} of {self.n}")
        if len(self.ranks) != self.n:
            raise ValueError(f"a group of {self.n} ranks named "
                             f"{self.ranks}")

    def _exchange(self, kind: str, x: torch.Tensor, run, out_shape):
        self.exchanges[kind] = self.exchanges.get(kind, 0) + 1
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        op = CollectiveOp(KINDS[kind], self.name,
                          x.numel() * x.element_size(),
                          out.numel() * out.element_size(), self.n,
                          self.n_groups, spans_nodes(self.ranks),
                          is_f32=x.dtype == torch.float32)
        for log in _LOGS:
            log.append(op)
        return out

    def all_true(self, flag: bool) -> bool:
        return bool(flag)

    def barrier(self) -> None:
        pass


def grid_axis(shape: dict, name: str, coords: dict) -> RecordingAxis:
    """The recording axis ``name`` of the rank at ``coords`` on a mesh of
    ``shape`` (``{axis: size}`` in mesh order), its ranks numbered
    row-major as ``parallel/dist.grid_axes`` numbers them."""
    from repro_torch.parallel.dist import _rank_of
    sizes = tuple(shape.values())
    ranks = tuple(_rank_of([k if a == name else coords[a] for a in shape],
                           sizes) for k in range(shape[name]))
    return RecordingAxis(shape[name], coords[name],
                         device=torch.device("meta"), name=name,
                         ranks=ranks,
                         n_groups=math.prod(sizes) // shape[name])
