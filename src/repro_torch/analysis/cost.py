"""What one rank's step costs, counted on meta tensors.

Counterpart of ``repro/analysis/hlocost.py``.  The reference compiles a
cell and walks its HLO; the port runs one rank's real step function on
meta tensors (no storage, no kernel) under :func:`measure`:

  * ``flops``        — the matrix products' ``2·M·N·K``, as
                       ``torch.utils.flop_counter.FlopCounterMode``
                       counts them (``mm``, ``bmm``, ``addmm``,
                       convolutions, attention calls), as ``hlocost``
                       counts dots; elementwise work is not counted;
  * ``hbm_bytes``    — the operand and result bytes of every op, each
                       operand and result counted whole: the port's
                       unfused upper bound (views and bookkeeping ops —
                       ``empty``, ``detach``, aliases — left out);
  * ``collectives``  — the :class:`~repro_torch.analysis.collectives.
                       CollectiveOp` of every exchange of the mesh's
                       recording axes;
  * ``peak_bytes``   — the high-water mark of the bytes held by live
                       storages, the arguments' included: the port's
                       stand-in for XLA's ``memory_analysis()``.  A
                       storage counts from the op that creates it until
                       it is released (a weak reference to it expires);
                       ``argument_bytes`` are the arguments' storages,
                       ``output_bytes`` the result's storages that the
                       step created.

**Meta runs take the plain versions.**  A kernel wrapper runs its plain
PyTorch version on any tensor that is not a CUDA tensor
(``kernels/flash_attention.py``: ``if not q.is_cuda``), so a dry run
counts what the plain versions compute: attention over the whole key
length of each query chunk, as the reference's compiled chunked path
(``repro/models/attention.py``) computes it, and the products of the
plain WKV-6 and Mamba scans.

**Autograd computes one product fewer than XLA.**  For a scan of ``G``
layers of ``tanh(x @ w)`` over ``x (B, D)``, forward and backward, the
reference counts ``6·G·B·D²``: XLA's scan body also forms the first
layer's input gradient.  Autograd does not form a gradient nobody asked
for, so the port counts ``(6·G - 2)·B·D²`` when ``x`` takes no gradient
(``tests/test_torch_analysis.py`` holds both closed forms).

No host read may happen inside a measured step: a meta tensor has no
value (``.item()`` raises), which is why the dry run calls the step
functions and never the loops or engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.collectives import (CollectiveSummary, recording,
                                              summarize)
from repro_torch.parallel.overlap import _tensors as tensors

aten = torch.ops.aten
_BOOKKEEPING = {aten.empty, aten.empty_like, aten.empty_strided,
                aten.new_empty, aten.new_empty_strided, aten.detach,
                aten.alias, aten.lift_fresh, aten.lift_fresh_copy,
                aten._local_scalar_dense}


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list = field(default_factory=list)
    peak_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0

    @property
    def temp_bytes(self) -> float:
        """The high-water mark beyond the arguments and the result."""
        return max(self.peak_bytes - self.argument_bytes
                   - self.output_bytes, 0.0)

    def summary(self) -> CollectiveSummary:
        return summarize(self.collectives)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Bytes of every op and the live storages' high-water mark."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._held: dict = {}       # storage id -> (weak ref, bytes)

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now on (once)."""
        st = t.untyped_storage()
        key = st._cdata
        have = self._held.get(key)
        if have is not None and not have[0].expired():
            return
        n = st.nbytes()
        if self.live + n > self.peak:
            self._sweep()
        self._held[key] = (StorageWeakRef(st), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._held.items()
                    if ref.expired()]:
            self.live -= self._held.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _BOOKKEEPING:
            for t in tensors(out):
                self.hold(t)
            return out
        moved = sum(_nbytes(t) for t in tensors((args, kwargs or {})))
        for t in tensors(out):
            moved += _nbytes(t)
            self.hold(t)
        self.hbm_bytes += moved
        return out


def measure(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Costs)``: ``fn`` run once under the
    counters (module docstring), its arguments' storages live from the
    start."""
    meter = _Meter()
    held = set()
    for t in tensors((args, kwargs)):
        held.add(t.untyped_storage()._cdata)
        meter.hold(t)
    argument_bytes = meter.live
    flops = FlopCounterMode(display=False)
    with recording() as log, flops, meter:
        out = fn(*args, **kwargs)
    meter._sweep()
    made = {}
    for t in tensors(out):
        st = t.untyped_storage()
        if st._cdata not in held:
            made[st._cdata] = st.nbytes()
    return out, Costs(flops=float(flops.get_total_flops()),
                      hbm_bytes=meter.hbm_bytes, collectives=list(log),
                      peak_bytes=float(meter.peak),
                      argument_bytes=float(argument_bytes),
                      output_bytes=float(sum(made.values())))
