"""Pipeline parallelism: a skewed microbatch schedule over a stage axis.

Counterpart of ``repro/parallel/pipeline.py``: GPipe's schedule, where
tick ``t`` runs microbatch ``t - s`` on stage ``s`` and each stage's
output hops to stage ``s + 1`` (``ppermute``, here the axis's
``ring_shift``).  The stage axis is a pod-like axis of
``parallel/pods.py``: a ``PodAxis`` emulates the stages on one device
(per-stage tensors lead with the stages), a ``DistPodAxis`` is one
process a stage.  Autograd runs back through the schedule: on a
``PodAxis`` the shift is ``torch.roll`` and the broadcast a sum, which
autograd differentiates as they are; over ranks both are
``torch.autograd.Function``\\s whose backward is the reversed
permutation (``ring_unshift``) and, for the broadcast of the last
stage's outputs to every stage, the identity — each rank's gradient of
its own copy, which the mask to the last stage keeps single, as the
reference's ``psum`` transposes under ``shard_map``'s replication check.

``pipelined_loss`` computes the loss on every stage's copy of the
outputs, masks it to the last stage and sums over the stages: every
stage returns the same scalar, and the backward runs one chain (no
``n_stages`` overcount).  Differentiate stage ``j``'s copy of it
(``loss[0]`` a process over ranks; any one index emulated).
"""
from __future__ import annotations

import torch

from repro_torch.parallel.pods import DistPodAxis


class _Shift(torch.autograd.Function):
    """``ring_shift`` over ranks; backward the reverse shift."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return axis.ring_shift(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.axis.ring_unshift(g.contiguous())


class _Broadcast(torch.autograd.Function):
    """``psum`` over ranks of a value only one rank holds non-zero;
    backward the identity."""

    @staticmethod
    def forward(ctx, axis, x):
        return axis.psum(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _shift(axis, x):
    return _Shift.apply(axis, x) if isinstance(axis, DistPodAxis) \
        else axis.ring_shift(x)


def _psum(axis, x):
    return _Broadcast.apply(axis, x) if isinstance(axis, DistPodAxis) \
        else axis.psum(x)


def pipeline(stage_fn, n_stages: int, axis):
    """Wrap ``stage_fn(stage_params, x) -> y`` into a pipelined apply.

    Returns ``apply(stage_params, microbatches)``:
      stage_params: the held stages' parameters, leading with them
                    (a tensor or a dict tree of tensors);
      microbatches: ``(n_micro, mb, ...)``, every stage's input alike.
    Output: ``(len(held), n_micro, mb, ...)``, every held stage's copy of
    the last stage's outputs."""
    if axis.n != n_stages:
        raise ValueError(f"{n_stages} stages over an axis of {axis.n}")

    def index(tree, j):
        if isinstance(tree, dict):
            return {k: index(v, j) for k, v in tree.items()}
        return tree[j]

    def apply(stage_params, microbatches):
        held = axis.held
        n_micro = microbatches.shape[0]
        me = torch.tensor(held, device=microbatches.device)
        first = (me == 0).reshape((-1,) + (1,) * (microbatches.dim() - 1))
        pad = torch.zeros((n_stages - 1,) + tuple(microbatches.shape[1:]),
                          dtype=microbatches.dtype,
                          device=microbatches.device)
        feed = torch.cat([microbatches, pad], dim=0)
        carry = torch.zeros((len(held),) + tuple(feed.shape[1:]),
                            dtype=feed.dtype, device=feed.device)
        outs = []
        for t in range(n_micro + n_stages - 1):
            x = torch.where(first, feed[t].unsqueeze(0), carry)
            y = torch.stack([stage_fn(index(stage_params, j), x[j])
                             for j in range(len(held))])
            outs.append(y)             # the last stage's y is an output
            carry = _shift(axis, y)
        # stage s emits microbatch m at tick m + s: the last stage's
        outs = torch.stack(outs, dim=1)[:, n_stages - 1:]
        sel = (me == n_stages - 1).to(outs.dtype).reshape(
            (-1,) + (1,) * (outs.dim() - 1))
        return _psum(axis, outs * sel)

    return apply


def pipelined_loss(stage_fn, loss_fn, n_stages: int, axis):
    """``fn(stage_params, microbatches, targets)``: ``loss_fn(outputs,
    targets)`` over the pipelined model, ``(len(held),)``, the same value
    on every stage (module docstring)."""
    apply = pipeline(stage_fn, n_stages, axis)

    def fn(stage_params, microbatches, targets):
        outs = apply(stage_params, microbatches)
        me = torch.tensor(axis.held, device=outs.device)
        losses = torch.stack([loss_fn(outs[j], targets)
                              for j in range(len(axis.held))])
        return _psum(axis, torch.where(me == n_stages - 1, losses,
                                       torch.zeros_like(losses)))

    return fn
