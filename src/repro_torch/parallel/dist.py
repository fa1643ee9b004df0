"""One process a rank over ``torch.distributed``: the port's multi-device
runtime.

Counterpart of the reference's devices on a mesh (``--xla_force_host_
platform_device_count`` on the CPU, the chips of a slice on a TPU).
:func:`run_ranks` starts ``n`` processes, joins them into one group and
runs ``fn(pods, *args)`` in each, where ``pods`` is that rank's
:class:`~repro_torch.parallel.pods.DistPodAxis`; it returns every rank's
result, in rank order, and fails if any rank fails or dies.

* The processes start with the ``spawn`` method (CUDA cannot fork), so
  ``fn``, ``args`` and the results are pickled: ``fn`` lives at module
  level in an importable module (``parallel/rank_bodies.py`` holds the
  port's), and a child imports nothing its parent's ``fn`` does not need.
* The group meets through a ``FileStore`` in a temporary directory, so no
  address or port is needed; gloo's connections go over the loopback
  interface (``GLOO_SOCKET_IFNAME=lo``).
* ``backend`` is ``"gloo"`` or ``"nccl"``, never chosen for the caller.
  Over gloo every rank of a CUDA run uses the given card (a CUDA tensor is
  staged through pinned host memory for each exchange, ``DistPodAxis``);
  over nccl rank ``r`` uses card ``r``, and asking for more ranks than
  cards raises here, before NCCL starts (NCCL refuses two ranks on one
  device).  Every rank also gets a gloo ``control`` group for host-side
  agreement (``DistPodAxis.all_true``).
* The ranks share the host's cores: each takes an equal share of them as
  its intra-op threads.
* A mesh's axes are sub-groups of the rank grid (:func:`grid_axes`): the
  ranks of a group laid out row-major over the mesh's shape, one
  ``DistPodAxis`` an axis over the ranks that differ only along it.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.pods import BACKENDS, DistPodAxis, PodAxis
from repro_torch.runtime import resolve_device

TIMEOUT_S = 1800.0      # a group's whole run, and each collective's wait


def check_group(n: int, backend: str, device) -> torch.device:
    """Validate a group before any process starts; returns the device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; expected one of {BACKENDS}")
    if n < 1:
        raise ValueError(f"a rank group needs at least one rank, got {n}")
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl exchanges CUDA tensors: a group over "
                             f"nccl runs on cuda, not {device.type}")
        have = torch.cuda.device_count()
        if n > have:
            raise RuntimeError(
                f"nccl over {n} ranks needs {n} CUDA devices, one a rank; "
                f"this process sees {have}.  NCCL refuses two ranks on one "
                "device; run the ranks over backend='gloo'")
    return device


def _rank_device(device: torch.device, rank: int,
                backend: str) -> torch.device:
    """The device rank ``rank`` runs on."""
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def _rank_main(fn, rank: int, n: int, backend: str, device: str,
               store_path: str, results, args: tuple,
               timeout_s: float) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    # the ranks share the host's cores: intra-op threads beyond a share
    # each spin against the other ranks' (a 128 x 128 matmul took 60 ms
    # with 4 ranks of 8 threads on 8 cores)
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n))
    try:
        dev = _rank_device(torch.device(device), rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=timedelta(seconds=timeout_s))
        control = dist.new_group(backend="gloo") if backend != "gloo" \
            else None
        pods = DistPodAxis(n, rank, backend, dev, control)
        results.put((rank, True, fn(pods, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def grid_axes(world: DistPodAxis, shape: Sequence[int],
              names: Sequence[str]) -> dict:
    """This rank's ``DistPodAxis`` along each axis of a grid of ``shape``
    over the ranks of ``world`` (row-major: the last axis varies
    fastest, as a mesh's devices do).  Every rank of ``world`` must call
    this with the same grid: each axis's line of ranks gets a group (and,
    over nccl, a gloo control group) in the same order on every rank, as
    ``torch.distributed.new_group`` requires.  An axis of one rank is a
    ``PodAxis(1)`` (nothing to exchange), and an axis that spans the
    whole group is ``world`` itself.  ``world`` must be the default
    group's axis."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world.n or world.group is not None:
        raise ValueError(f"a grid of {shape} over {world.n} ranks of the "
                         f"default group")
    me = [int(c) for c in _coords(world.rank, shape)]
    out = {}
    for a, name in enumerate(names):
        if shape[a] == world.n:
            out[name] = world
            continue
        if shape[a] == 1:
            out[name] = PodAxis(1)
            continue
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            line = []
            for k in range(shape[a]):
                c = list(rest)
                c.insert(a, k)
                line.append(_rank_of(c, shape))
            group = dist.new_group(ranks=line, backend=world.backend)
            control = group if world.backend == "gloo" \
                else dist.new_group(ranks=line, backend="gloo")
            if world.rank in line:
                out[name] = DistPodAxis(len(line), line.index(world.rank),
                                        world.backend, world.device,
                                        control, group=group)
    assert [out[n].held[0] for n in names] == me
    return out


def _coords(rank: int, shape) -> list:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _rank_of(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def run_ranks(fn: Callable, n: int, *, backend: str, device="cuda",
              args: Sequence = (), timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(pods, *args)`` in ``n`` spawned rank processes and return
    their results in rank order.

    Raises if the group is invalid (:func:`check_group`), if a rank
    raises (with its traceback), if a rank process dies without a result,
    or after ``timeout_s``; the processes are stopped either way."""
    device = check_group(n, backend, device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, str(device),
                               os.path.join(tmp, "store"), results,
                               tuple(args), timeout_s))
             for r in range(n)]
    out, got = [None] * n, 0
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while got < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} of {n} died with "
                                       f"exit code {dead[0][1]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank group of {n} still running "
                                       f"after {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
            got += 1
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
