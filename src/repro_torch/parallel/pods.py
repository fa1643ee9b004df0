"""The ``pod`` axis on one device: per-rank values as a leading dimension.

Stand-in for the reference's ``shard_map(..., axis_names={"pod"})``: where
each of ``n`` devices there holds its own value of a tensor, the port
holds one tensor whose leading dimension of size ``n`` indexes the ranks,
on one device.  The ``jax.lax`` collectives that
``repro/parallel/collectives.py`` calls over the ``pod`` axis become
tensor operations on that dimension:

============================  ==========================================
reference (per rank)          here (ranks stacked on dim 0)
============================  ==========================================
``axis_size("pod")``          :attr:`PodAxis.n`
``axis_index("pod")``         :meth:`PodAxis.axis_index` (``arange(n)``)
``all_to_all`` (tiled, split  :meth:`PodAxis.all_to_all`: ``x.transpose(0,
and concat on axis 0)         1)`` of the ``(rank, chunk, ...)`` stack
``all_gather``                :meth:`PodAxis.all_gather`: a broadcast view
                              of the stack, not ``n`` copies
``ppermute`` ring i -> i+1    :meth:`PodAxis.ring_shift`: ``torch.roll(x,
                              1, 0)``
``pmean``                     :meth:`PodAxis.pmean`
============================  ==========================================

**The exchange is an on-device copy, not a wire.**  Nothing here crosses
a link: what the reference sends over the slow ``pod`` axis is a
transpose, a roll or a view of memory on one card, so a step's time says
what the transforms and the packing cost, and nothing about a network.
The same ``pod`` axis over NCCL across four cards (one process a rank,
``torch.distributed``) is a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PodAxis:
    """``n`` emulated ranks: every per-rank tensor carries them as its
    leading dimension."""
    n: int

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"a pod axis needs at least one rank, got "
                             f"{self.n}")

    def _ranks(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.n:
            raise ValueError(f"per-rank tensor must lead with {self.n} "
                             f"ranks, got {tuple(x.shape)}")

    def axis_index(self, device) -> torch.Tensor:
        """Each rank's index, ``(n,)`` int64."""
        return torch.arange(self.n, device=device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_to_all with split and concat on the per-rank axis 0:
        ``x (n, n, ...)`` where ``x[r, j]`` is the chunk rank ``r`` sends
        to rank ``j``; rank ``j`` receives ``out[j, r] = x[r, j]``.  A
        transposed view."""
        self._ranks(x)
        if x.dim() < 2 or x.shape[1] != self.n:
            raise ValueError(f"all_to_all splits a per-rank axis of {self.n} "
                             f"chunks, got {tuple(x.shape)}")
        return x.transpose(0, 1)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x (n, ...)`` -> ``(n, n, ...)``: every rank holds all ranks'
        values, in rank order.  A broadcast view of the stack."""
        self._ranks(x)
        return x.unsqueeze(0).expand((self.n,) + tuple(x.shape))

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """``ppermute`` over the ring ``i -> i + 1``: rank ``i + 1``
        receives what rank ``i`` held."""
        self._ranks(x)
        return torch.roll(x, 1, 0)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks, held by every rank (a broadcast view)."""
        self._ranks(x)
        return (x.sum(dim=0) / self.n).unsqueeze(0).expand(x.shape)
