"""The ``pod`` axis, two ways: emulated on one device, or one process a rank.

Stand-in for the reference's ``shard_map(..., axis_names={"pod"})``: where
each of ``n`` devices there holds its own value of a tensor, the port
holds per-rank tensors whose leading dimension indexes the ranks this
process holds.  :class:`PodAxis` holds all ``n`` on one device;
:class:`DistPodAxis` holds one, its own, in a process of a
``torch.distributed`` group (``parallel/dist.py`` starts the group).  The
``jax.lax`` collectives that ``repro/parallel/collectives.py`` calls over
the ``pod`` axis become:

============================  ==================  =========================
reference (per rank)          :class:`PodAxis`    :class:`DistPodAxis`
                              (ranks on dim 0)    (dim 0 is this rank)
============================  ==================  =========================
``axis_size("pod")``          ``n``               ``n``
``axis_index("pod")``         ``arange(n)``       ``[rank]``
``all_to_all`` (tiled, split  ``x.transpose(0,    ``all_to_all_single``
and concat on axis 0)         1)``
``all_gather``                a broadcast view    ``all_gather_into_tensor``
``ppermute`` ring i -> i+1    ``torch.roll(x, 1,  ``batch_isend_irecv``: send
                              0)``                to r+1, receive from r-1
``psum`` / ``pmean``          ``x.sum(0)``        ``all_reduce(SUM)`` (/ n)
============================  ==================  =========================

``held`` names the global ranks whose values lead this process's
tensors, so code that indexes chunks by rank (``collectives.ring_allreduce``)
or slices a batch by rank (``train/step.py``) runs on either axis.

**What crosses a wire.**  On a :class:`PodAxis` nothing does: what the
reference sends over the slow ``pod`` axis is a transpose, a roll or a
view of memory on one card, so a step's time says what the transforms
and the packing cost, and nothing about a network.  A
:class:`DistPodAxis` exchanges between processes.  Over ``gloo`` a CUDA
tensor is always copied to a pinned host buffer, exchanged there, and
copied back (``staged_bytes`` counts both copies); on one machine that
wire is loopback through host memory, not NVLink.  Over ``nccl`` the
card's tensors are exchanged as they are (one card a rank).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Union

import torch
import torch.distributed as dist

# ``all_gather_into_tensor`` was renamed ``all_gather_single`` in torch 2.13
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


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

    @property
    def held(self) -> tuple:
        """The ranks whose values lead a per-rank tensor: all of them."""
        return tuple(range(self.n))

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

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, held by every rank (a broadcast view)."""
        self._ranks(x)
        return x.sum(dim=0).unsqueeze(0).expand(x.shape)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks, held by every rank (a broadcast view)."""
        self._ranks(x)
        return (x.sum(dim=0) / self.n).unsqueeze(0).expand(x.shape)

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x (n, ...)``: every rank's value concatenated in rank order
        along per-rank dim ``dim``, held by every rank (a broadcast
        view)."""
        self._ranks(x)
        y = torch.cat(list(x), dim=dim)
        return y.unsqueeze(0).expand((self.n,) + tuple(y.shape))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x (n, ..., n * k, ...)``: the sum over the ranks, of which
        rank ``r`` keeps chunk ``r`` along per-rank dim ``dim``.  A bf16
        or f16 sum accumulates in f32 and rounds once."""
        self._ranks(x)
        return torch.stack(x.sum(dim=0).chunk(self.n, dim=dim))


BACKENDS = ("gloo", "nccl")


@dataclass
class DistPodAxis:
    """Rank ``rank`` of ``n``, one process a rank, over an initialised
    ``torch.distributed`` default group of ``backend``: every per-rank
    tensor leads with a dimension of 1, this rank's value, on ``device``.

    ``group`` is the process group of the axis (``None``: the default
    group) and ``rank`` this process's rank within it: a sub-group of a
    mesh's rank grid (``parallel/dist.grid_groups``) is an axis of its
    own.  ``control`` is a gloo group over the same ranks for host-side
    agreement (:meth:`all_true`); ``staged_bytes`` counts the bytes a gloo
    exchange copied between the card and pinned host memory (both ways);
    ``exchanges`` counts the exchanges by kind; ``wire_s`` is the host
    time spent inside the collectives themselves (waiting for the other
    ranks included, the copies to and from the card not)."""
    n: int
    rank: int
    backend: str
    device: torch.device = torch.device("cpu")
    control: object = None
    staged_bytes: int = 0
    exchanges: dict = field(default_factory=dict)
    wire_s: float = 0.0
    group: object = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}; expected one of "
                             f"{BACKENDS}")
        if not 0 <= self.rank < self.n:
            raise ValueError(f"rank {self.rank} of {self.n}")

    @property
    def held(self) -> tuple:
        return (self.rank,)

    def _ranks(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != 1:
            raise ValueError(f"per-rank tensor must lead with this rank's "
                             f"dimension of 1, got {tuple(x.shape)}")

    def _exchange(self, kind: str, x: torch.Tensor, run, out_shape):
        """``run(src, dst)`` on a contiguous ``src`` into a new ``dst`` of
        ``out_shape``: on the host when gloo moves a CUDA tensor (copied
        into pinned memory and back, counted), else where ``x`` lies."""
        self.exchanges[kind] = self.exchanges.get(kind, 0) + 1
        if self.backend == "gloo" and x.is_cuda:
            src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            src.copy_(x)                    # waits for x on this stream
            dst = torch.empty(out_shape, dtype=x.dtype, pin_memory=True)
            self._run(run, src, dst)
            self.staged_bytes += src.numel() * src.element_size() \
                + dst.numel() * dst.element_size()
            return dst.to(x.device, non_blocking=True)
        src = x.contiguous()
        dst = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        self._run(run, src, dst)
        return dst

    def _run(self, run, src, dst) -> None:
        t0 = time.perf_counter()
        run(src, dst)
        self.wire_s += time.perf_counter() - t0

    def axis_index(self, device) -> torch.Tensor:
        """This rank's index, ``(1,)`` int64."""
        return torch.tensor([self.rank], device=device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x (1, n, ...)``, ``x[0, j]`` the chunk for rank ``j`` ->
        ``(1, n, ...)`` holding at ``[0, r]`` what rank ``r`` sent here."""
        self._ranks(x)
        if x.dim() < 2 or x.shape[1] != self.n:
            raise ValueError(f"all_to_all splits a per-rank axis of {self.n} "
                             f"chunks, got {tuple(x.shape)}")
        return self._exchange(
            "all_to_all", x[0],
            lambda src, dst: dist.all_to_all_single(dst, src,
                                                    group=self.group),
            tuple(x.shape[1:]))[None]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x (1, ...)`` -> ``(1, n, ...)``: every rank's value, in rank
        order."""
        self._ranks(x)
        return self._exchange(
            "all_gather", x,
            lambda src, dst: _all_gather_single(dst, src, group=self.group),
            (self.n,) + tuple(x.shape[1:]))[None]

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send to rank ``r + 1``, receive from rank ``r - 1`` (one rank:
        its own value)."""
        self._ranks(x)
        if self.n == 1:
            return x.clone()

        return self._shift(x, 1)

    def _peer(self, r: int) -> int:
        """The default group's rank of this axis's rank ``r``."""
        r %= self.n
        return r if self.group is None \
            else dist.get_global_rank(self.group, r)

    def _shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Send to rank ``r + step``, receive from rank ``r - step``."""
        def run(src, dst):
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, src, self._peer(self.rank + step),
                               group=self.group),
                    dist.P2POp(dist.irecv, dst, self._peer(self.rank - step),
                               group=self.group)]):
                req.wait()
        return self._exchange("ring_shift", x, run, tuple(x.shape))

    def ring_unshift(self, x: torch.Tensor) -> torch.Tensor:
        """The reverse of :meth:`ring_shift`: send to rank ``r - 1``,
        receive from rank ``r + 1``."""
        self._ranks(x)
        if self.n == 1:
            return x.clone()
        return self._shift(x, -1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; a bf16 or f16 ``x`` is summed in f32 and
        rounded once, as ``PodAxis.psum``'s reduction accumulates."""
        self._ranks(x)
        wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) \
            else x

        def run(src, dst):
            dst.copy_(src)
            dist.all_reduce(dst, op=dist.ReduceOp.SUM, group=self.group)
        return self._exchange("all_reduce", wide, run,
                              tuple(x.shape)).to(x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the ranks."""
        self._ranks(x)

        def run(src, dst):
            dst.copy_(src)
            dist.all_reduce(dst, op=dist.ReduceOp.MAX, group=self.group)
        return self._exchange("all_reduce", x, run, tuple(x.shape))

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x (1, ...)``: every rank's value concatenated in rank order
        along per-rank dim ``dim`` (one ``all_gather``)."""
        return torch.cat(list(self.all_gather(x)[0]), dim=dim)[None]

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x (1, ..., n * k, ...)``: this rank's chunk, along per-rank dim
        ``dim``, of the sum over the ranks.  Gloo has no reduce-scatter:
        one ``all_to_all`` hands rank ``j`` every rank's chunk ``j``, which
        it sums in rank order (a bf16 or f16 sum in f32, rounded once, as
        ``PodAxis.reduce_scatter``'s)."""
        self._ranks(x)
        chunks = torch.stack(x[0].chunk(self.n, dim=dim))
        got = self._exchange(
            "reduce_scatter", chunks,
            lambda src, dst: dist.all_to_all_single(dst, src,
                                                    group=self.group),
            tuple(chunks.shape))
        return got.sum(dim=0, dtype=torch.float32 if x.dtype in (
            torch.bfloat16, torch.float16) else None).to(x.dtype)[None]

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks (the sum as :meth:`psum`, then ``/ n``)."""
        if x.dtype in (torch.bfloat16, torch.float16):
            return (self.psum(x.float()) / self.n).to(x.dtype)
        return self.psum(x) / self.n

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (over the host-side gloo
        ``control`` group): how ranks agree to stop a timing loop
        together, since each must issue the same collectives."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for every rank (on the ``control`` group)."""
        dist.barrier(group=self.control)


Pods = Union[PodAxis, DistPodAxis]     # what the collective code takes
