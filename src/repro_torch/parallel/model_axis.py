"""The ``model`` axis of tensor parallelism, two ways: emulated in one
process, or one process a rank.

Stand-in for the reference's ``model`` mesh axis, over which GSPMD splits
heads, the FFN width and the vocabulary (``parallel/sharding.py``'s
rules).  The port follows ``parallel/pods.py``'s convention: a per-rank
tensor leads with the ranks this process holds.  :class:`ModelAxis` holds
all ``n`` in one process (the reference's ``ContinuousEngine(tp_size=N)``
over fabricated devices); :class:`DistModelAxis` holds one, its own, in a
process of a ``torch.distributed`` group (``parallel/dist.run_ranks``),
the analogue of real chips.  The two operations the model code needs:

=====================  ======================  ==========================
operation              :class:`ModelAxis`      :class:`DistModelAxis`
=====================  ======================  ==========================
``psum``               ``x.sum(0)``            ``all_reduce(SUM)``
``all_gather`` (last   concatenation of the    ``all_gather`` then the
dim)                   ranks' values           same concatenation
=====================  ======================  ==========================

Each returns a per-rank tensor again (every held rank holds the result;
on the emulated axis a broadcast view).  ``exchanges`` counts the
operations by kind, once per call whatever the ranks held; over gloo a
CUDA tensor is staged through pinned host memory and ``staged_bytes``
counts both copies, as ``DistPodAxis`` counts them, and ``wire_s`` is the
host time inside the collectives (nothing crosses a wire on the emulated
axis).  A bf16 ``psum`` sums in f32 and rounds once on either axis.

:class:`DistModelAxis` also has ``broadcast_object`` (from rank 0) and
``barrier``, the host-side agreement of the rank-process engine
(``serve/ranks.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.parallel.pods import DistPodAxis


@dataclass
class ModelAxis:
    """``n`` emulated ranks in this process."""
    n: int
    exchanges: dict = field(default_factory=dict)
    staged_bytes: int = 0
    wire_s: float = 0.0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"a model axis needs at least one rank, got "
                             f"{self.n}")

    @property
    def held(self) -> tuple:
        return tuple(range(self.n))

    def _ranks(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.n:
            raise ValueError(f"per-rank tensor must lead with {self.n} "
                             f"ranks, got {tuple(x.shape)}")

    def _count(self, kind: str) -> None:
        self.exchanges[kind] = self.exchanges.get(kind, 0) + 1

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x (n, ...)``: the sum over the ranks, held by every rank."""
        self._ranks(x)
        self._count("all_reduce")
        return x.sum(dim=0).unsqueeze(0).expand(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x (n, ..., d)`` -> ``(n, ..., n * d)``: every rank's value
        along the last dim, in rank order, held by every rank."""
        self._ranks(x)
        self._count("all_gather")
        y = torch.cat(list(x), dim=-1)
        return y.unsqueeze(0).expand((self.n,) + tuple(y.shape))


@dataclass
class DistModelAxis:
    """This process's rank of a ``torch.distributed`` group, over the
    exchanges of its :class:`~repro_torch.parallel.pods.DistPodAxis`."""
    pods: DistPodAxis

    @property
    def n(self) -> int:
        return self.pods.n

    @property
    def held(self) -> tuple:
        return self.pods.held

    @property
    def device(self) -> torch.device:
        return self.pods.device

    @property
    def exchanges(self) -> dict:
        return self.pods.exchanges

    @property
    def staged_bytes(self) -> int:
        return self.pods.staged_bytes

    @property
    def wire_s(self) -> float:
        return self.pods.wire_s

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x (1, ...)``: the sum over the ranks."""
        return self.pods.psum(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x (1, ..., d)`` -> ``(1, ..., n * d)``."""
        g = self.pods.all_gather(x)[0]                  # (n, ..., d)
        return torch.cat(list(g), dim=-1)[None]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled, over the host-side
        group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.pods.control)
        return box[0]

    def barrier(self) -> None:
        self.pods.barrier()
