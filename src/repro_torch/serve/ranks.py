"""Tensor-parallel serving one process a rank: rank 0 drives, the others
follow.

The reference serves tensor-parallel from one controller: one process
runs the engine's host loop and XLA runs each compiled step on every
device of the mesh.  The port's rank processes (``parallel/dist.py``)
reach the same shape this way:

* **Rank 0 alone** runs the engine's host loop — scheduler, allocator,
  clock, tracer, fabric stalls, argmax — on a *leading* mesh
  (``Mesh.leading()``).  Its cells (``serve/step.py``) first broadcast
  each call and its host-side arguments (tokens, positions, table rows,
  the slot) over the group's host-side channel, then run.
* **Every other rank** holds its shards only, and :func:`follow` runs the
  same cell on them for each call it receives: ``build`` (the cells of a
  new engine, with fresh caches or pool), ``prefill``, ``insert``,
  ``decode``, ``count`` (one scratch tick), ``reset`` / ``snapshot`` of
  the kernel launch counts, ``call`` of a body every rank runs on its
  own shards (:func:`call_all_ranks`: a model the engines do not drive,
  through ``models/registry``), until ``stop``.
* :func:`serve_rank` is the rank body for ``parallel/dist.run_ranks``: it
  makes the rank's mesh and shards, runs ``job(mesh, cfg, params, *args)``
  in rank 0 and :func:`follow` elsewhere (:func:`serve_jobs`: several
  jobs in turn, each on its own model, over one group).  Rank 0
  broadcasts the stop in a ``finally``, so a failure in its host loop
  ends the followers instead of leaving them waiting in a collective
  until the group's timeout (and ``run_ranks`` fails the call with rank
  0's traceback).

Each rank returns what it saw: launches by kernel (at the last
``snapshot``), exchanges by kind, bytes staged through host memory and
its device memory peak; rank 0 adds its job's result.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import resolve_device
from repro_torch.serve.step import make_continuous_cells, make_paged_cells


def prebuild(device) -> None:
    """Build the kernel library once, in the parent, before rank
    processes on a card each load it (they would otherwise each compile
    it at their first launch)."""
    if resolve_device(device).type == "cuda":      # raises without a card
        from repro_torch.kernels import _build
        _build.build()


def _dev(a, device):
    return a.to(device) if torch.is_tensor(a) else a


def _counts(device) -> dict:
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    return {"launches": ops.launch_counts(), "peak_bytes": int(peak)}


def _reset(device) -> None:
    ops.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def reset_counts(mesh, device) -> None:
    """Zero every rank's kernel launch counts and device memory peak (rank
    0 calls it on a leading mesh; the others follow)."""
    if mesh.lead:
        mesh.axis.broadcast_object(("reset",))
    _reset(torch.device(device))


def snapshot_counts(mesh) -> None:
    """Have every other rank keep its launch counts as they are now, for
    the result it returns (rank 0 reads its own)."""
    if mesh.lead:
        mesh.axis.broadcast_object(("snapshot",))


def call_all_ranks(mesh, params, fn: Callable, *args):
    """``fn(mesh, params, *args)`` on every rank of a leading ``mesh``,
    each on its own shards (rank 0 sends the call to the others first):
    an SPMD body whose collectives every rank makes alike.  Returns rank
    0's result.  ``fn`` must be a module-level function."""
    if mesh.lead:
        mesh.axis.broadcast_object(("call", fn, args))
    return fn(mesh, params, *args)


def follow(mesh, params, device) -> dict:
    """Serve rank 0's calls on this rank's shards until it sends a stop.
    Returns the rank's counts (:func:`serve_rank`)."""
    cells = state = base = dev_params = None
    kind = None
    seen = {"calls": 0}
    snap = _counts(device)
    while True:
        op, *args = mesh.axis.broadcast_object(None)
        if op == "stop":
            break
        seen["calls"] += 1
        args = [_dev(a, device) for a in args]
        if op == "build":
            kind, cfg, kw = args
            cells = state = base = dev_params = None
            make = make_paged_cells if kind == "paged" \
                else make_continuous_cells
            cells = make(cfg, mesh=mesh, device=device, **kw)
            dev_params = cells.put_params(params)
            state = cells.init_pool() if kind == "paged" \
                else cells.init_slot_caches()
        elif op == "prefill":
            _, base = cells.prefill(dev_params, *args)
        elif op == "insert":
            state = cells.insert(state, base, *args)
        elif op == "decode":
            tok, idx, *tables = args
            cells.decode(dev_params, tok, idx, state, *tables)
        elif op == "count":
            cells.count(dev_params)
        elif op == "reset":
            _reset(device)
        elif op == "snapshot":
            snap = _counts(device)
        elif op == "call":
            fn, fn_args = args
            fn(mesh, params, *fn_args)
        else:
            raise ValueError(f"unknown call {op!r} from rank 0")
    return dict(seen, **snap)


def load_weights(cfg, weights, n: int, held, device):
    """The held ranks' shards: ``("seed", s)`` draws the model from seed
    ``s`` on ``device`` leaf by leaf (``bridge.init_shards``); ``("numpy",
    tree)`` carries a reference tree over (``bridge.shards_from_numpy``)."""
    how, what = weights
    if how == "seed":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(what))
        return bridge.init_shards(cfg, gen, n, held)
    if how == "numpy":
        return bridge.shards_from_numpy(cfg, what, n, held, device)
    raise ValueError(f"weights {how!r}: expected 'seed' or 'numpy'")


def serve_rank(pods, cfg, weights, job: Callable, job_args: tuple = ()):
    """Rank body (``run_ranks(serve_rank, n, args=(cfg, weights, job,
    job_args))``): rank 0 runs ``job(mesh, cfg, params, *job_args)`` on a
    leading mesh, every other rank follows.  Returns the rank's counts,
    with ``"result"`` in rank 0."""
    return serve_jobs(pods, [(cfg, weights, job, job_args)])[0]


def serve_jobs(pods, jobs: list) -> list:
    """Rank body running several jobs ``(cfg, weights, job, job_args)`` in
    turn over one group, each on its own model (one group's start-up for
    them all).  Returns the rank's counts of each job (its exchanges and
    staged bytes, that job's alone), with ``"result"`` in rank 0's."""
    mesh = make_host_mesh(1, pods.n, ranks=pods)
    device = pods.device
    axis = mesh.axis
    outs = []
    for cfg, weights, job, job_args in jobs:
        before, staged = dict(axis.exchanges), axis.staged_bytes
        params = load_weights(cfg, weights, pods.n, pods.held, device)
        if pods.rank != 0:
            out = follow(mesh, params, device)
        else:
            try:
                result = job(mesh.leading(), cfg, params, *job_args)
            finally:
                axis.broadcast_object(("stop",))
            out = dict(_counts(device), result=result)
        del params
        if device.type == "cuda":
            # the next job's model is another size: hand this one's blocks
            # back rather than keep them cached beside it
            torch.cuda.empty_cache()
        out.update(rank=pods.rank, staged_bytes=axis.staged_bytes - staged,
                   exchanges={k: v - before.get(k, 0)
                              for k, v in axis.exchanges.items()})
        outs.append(out)
    return outs
