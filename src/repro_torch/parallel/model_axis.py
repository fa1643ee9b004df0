"""The ``model`` axis of tensor parallelism, two ways: emulated in one
process, or one process a rank.

Stand-in for the reference's ``model`` mesh axis, over which GSPMD splits
heads, the FFN width and the vocabulary (``parallel/sharding.py``'s
rules).  The port follows ``parallel/pods.py``'s convention: a per-rank
tensor leads with the ranks this process holds.  :class:`ModelAxis` holds
all ``n`` in one process (the reference's ``ContinuousEngine(tp_size=N)``
over fabricated devices); :class:`DistModelAxis` holds one, its own, in a
process of a ``torch.distributed`` group (``parallel/dist.run_ranks``),
the analogue of real chips.  The two operations serving needs:

=====================  ======================  ==========================
operation              :class:`ModelAxis`      :class:`DistModelAxis`
=====================  ======================  ==========================
``psum``               ``x.sum(0)``            ``all_reduce(SUM)``
``gather`` (last dim)  concatenation of the    ``all_gather`` then the
                       ranks' values           same concatenation
=====================  ======================  ==========================

``psum`` returns a per-rank tensor again (every held rank holds the
result; on the emulated axis a broadcast view), ``gather`` a replicated
one.

**Training** differentiates through the axis with Megatron's conjugate
pairs, on both axes the same: a *replicated* tensor (what every rank
holds alike: one tensor, no rank dim) enters a tensor-parallel region
through :meth:`~ModelAxis.copy` and leaves it through
:meth:`~ModelAxis.reduce`; under sequence parallelism the residual
stream is held a sequence slice a rank and the pair is
:meth:`~ModelAxis.gather_seq` / :meth:`~ModelAxis.scatter_seq`:

=================  =======================  =======================
operation          forward                  backward
=================  =======================  =======================
``copy``           identity                 all-reduce
``reduce``         all-reduce               identity
``gather_seq``     all-gather (sequence)    reduce-scatter
``scatter_seq``    reduce-scatter           all-gather
``gather``         all-gather (a dim)       the rank's slice (none)
``split_seq``      the rank's slice (none)  all-gather
``pmax``           all-reduce (max)         none (detached)
=================  =======================  =======================

``gather`` is Megatron's gather-from-region: each rank's slice of a
tensor along a dim (the last by default) put together into a
*replicated* one, whose gradient every rank holds whole, so each keeps
its own slice of it with no exchange.  ``split_seq`` is its conjugate,
scatter-to-region: a replicated tensor cut into the ranks' slices, each
rank's gradient of its slice all-gathered into the whole one.
(``gather_seq``'s reduce-scatter is for a gathered copy that feeds
rank-local work, each rank's gradient a partial one; it gathers any
per-rank dim, as RWKV-6's channel-mix gate gathers its channels under
sequence parallelism.)

On :class:`ModelAxis` a replicated tensor is held once, so ``copy``'s
backward sums the ranks' gradients once (a loss summed over ``n``
emulated copies of a replicated activation would come out ``n`` times
too large: the loss is computed once, from the one copy).  ``exchanges``
counts each exchange where it happens, forward or backward.  Training
never gathers the logits (``transformer.xent_vocab_parallel``): serving
does, along the vocabulary.  ``exchanges`` counts the
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


    # -- training: the conjugate pairs (module docstring) ----------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated ``x`` -> ``(n, ...)``, every rank's copy (a view);
        backward: the sum of the ranks' gradients."""
        return _Emulated.apply(self, "copy", x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``(n, ...)`` partial values -> their sum, replicated; backward:
        the gradient to every rank."""
        self._ranks(x)
        return _Emulated.apply(self, "reduce", x)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``(n, ..., S/n, ...)`` sequence slices -> ``(n, ..., S, ...)``,
        every rank's copy of the whole sequence (per-rank ``dim``);
        backward: reduce-scatter."""
        self._ranks(x)
        return _Emulated.apply(self, "gather_seq", x, dim)

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``(n, ..., S, ...)`` partial values -> ``(n, ..., S/n, ...)``,
        each rank's slice of their sum; backward: all-gather."""
        self._ranks(x)
        return _Emulated.apply(self, "scatter_seq", x, dim)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``(n, ..., d, ...)`` the ranks' slices -> ``(..., n * d,
        ...)``, put together in rank order along per-rank ``dim``,
        replicated; backward: each rank's slice of the gradient."""
        self._ranks(x)
        return _Emulated.apply(self, "gather", x, dim)

    def split_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Replicated ``(..., S, ...)`` -> ``(n, ..., S/n, ...)``, each
        rank's slice along ``dim``; backward: all-gather."""
        return _Emulated.apply(self, "split_seq", x, dim)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``(n, ...)`` -> the maximum over the ranks, replicated
        (detached)."""
        self._ranks(x)
        self._count("all_reduce")
        return x.detach().amax(dim=0)


def _split(y: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    return torch.stack(y.chunk(n, dim=dim))


class _Emulated(torch.autograd.Function):
    """The training operations of a :class:`ModelAxis`, counted forward
    and backward (``kind`` and ``dim`` as the methods')."""

    @staticmethod
    def forward(ctx, axis, kind, x, dim=1):
        ctx.axis, ctx.kind, ctx.dim = axis, kind, dim
        n = axis.n
        if kind == "copy":
            return x.unsqueeze(0).expand((n,) + tuple(x.shape))
        if kind == "reduce":
            axis._count("all_reduce")
            return x.sum(dim=0)
        if kind == "gather_seq":
            axis._count("all_gather")
            y = torch.cat(list(x), dim=dim)
            return y.unsqueeze(0).expand((n,) + tuple(y.shape))
        if kind == "gather":
            axis._count("all_gather")
            return torch.cat(list(x), dim=dim)
        if kind == "split_seq":
            return _split(x, n, dim)
        axis._count("reduce_scatter")                  # scatter_seq
        return _split(x.sum(dim=0), n, dim)

    @staticmethod
    def backward(ctx, g):
        axis, kind, dim, n = ctx.axis, ctx.kind, ctx.dim, ctx.axis.n
        if kind == "copy":
            axis._count("all_reduce")
            return None, None, g.sum(dim=0), None
        if kind == "reduce":
            return None, None, g.unsqueeze(0).expand((n,) + tuple(g.shape)), \
                None
        if kind == "gather_seq":
            axis._count("reduce_scatter")
            return None, None, _split(g.sum(dim=0), n, dim), None
        if kind == "gather":
            return None, None, _split(g, n, dim), None
        axis._count("all_gather")
        y = torch.cat(list(g), dim=dim)
        if kind == "split_seq":
            return None, None, y, None
        return None, None, y.unsqueeze(0).expand((n,) + tuple(y.shape)), \
            None                                       # scatter_seq


class _Ranked(torch.autograd.Function):
    """The training operations of a :class:`DistModelAxis` (one rank: a
    per-rank tensor leads with 1), each exchange counted by the axis's
    ``DistPodAxis``."""

    @staticmethod
    def forward(ctx, pods, kind, x, dim=1):
        ctx.pods, ctx.kind, ctx.dim = pods, kind, dim
        if kind == "copy":
            return x.unsqueeze(0)
        if kind == "reduce":
            return pods.psum(x)[0]
        if kind == "gather_seq":
            return pods.all_gather_dim(x, dim)
        if kind == "gather":
            return pods.all_gather_dim(x, dim)[0]
        if kind == "split_seq":
            return x.chunk(pods.n, dim=dim)[pods.rank][None].clone()
        return pods.reduce_scatter(x, dim)             # scatter_seq

    @staticmethod
    def backward(ctx, g):
        pods, kind, dim = ctx.pods, ctx.kind, ctx.dim
        if kind == "copy":
            return None, None, pods.psum(g.contiguous())[0], None
        if kind == "reduce":
            return None, None, g.unsqueeze(0), None
        if kind == "gather_seq":
            return None, None, pods.reduce_scatter(g.contiguous(), dim), None
        if kind == "gather":
            return None, None, g.chunk(pods.n, dim=dim)[pods.rank][None], \
                None
        y = pods.all_gather_dim(g.contiguous(), dim)
        return None, None, y[0] if kind == "split_seq" else y, None


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

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated ``x`` -> ``(1, ...)``; backward: all-reduce."""
        return _Ranked.apply(self.pods, "copy", x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``(1, ...)`` partial value -> the sum over the ranks."""
        return _Ranked.apply(self.pods, "reduce", x)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``(1, ..., S/n, ...)`` -> ``(1, ..., S, ...)``; backward:
        reduce-scatter."""
        return _Ranked.apply(self.pods, "gather_seq", x, dim)

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """``(1, ..., S, ...)`` -> ``(1, ..., S/n, ...)``; backward:
        all-gather."""
        return _Ranked.apply(self.pods, "scatter_seq", x, dim)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``(1, ..., d, ...)`` this rank's slice -> ``(..., n * d,
        ...)`` along per-rank ``dim``, replicated; backward: this rank's
        slice of the gradient."""
        return _Ranked.apply(self.pods, "gather", x, dim)

    def split_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Replicated ``(..., S, ...)`` -> ``(1, ..., S/n, ...)``, this
        rank's slice; backward: all-gather."""
        return _Ranked.apply(self.pods, "split_seq", x, dim)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``(1, ...)`` -> the maximum over the ranks (detached)."""
        return self.pods.pmax(x.detach())[0]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled, over the host-side
        group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.pods.control)
        return box[0]

    def barrier(self) -> None:
        self.pods.barrier()
