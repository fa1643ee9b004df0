"""What the ranks of a group run for the port's own checks.

``parallel/dist.run_ranks`` pickles the function each rank runs, by its
import path, so the bodies live here, at module level in the port: a rank
imports this module and what it needs, never the JAX package, whatever
imported the caller.  The CPU tests (``tests/test_torch_dist.py``,
``tests/test_torch_fabric.py``, ``tests/test_torch_tp.py``) and
``chip_smoke.py``'s ``train_ranks`` phase call them through ``run_ranks``
(the serving jobs through ``serve/ranks.serve_rank``); :func:`fabric_guard`
also runs on an emulated ``PodAxis`` as it is.

Inputs cross as numpy arrays holding every rank's values, ``(n, ...)``;
each body takes the rows of the ranks its axis holds (``pods.held``) and
returns numpy arrays of those rows.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.kernels import burn as kburn
from repro_torch.parallel import collectives as C
from repro_torch.parallel.pods import DistPodAxis, Pods


def rows(pods: Pods, x: np.ndarray, device=None) -> torch.Tensor:
    """The held ranks' rows of ``x (n, ...)`` as a tensor on ``device``
    (a ``DistPodAxis``'s own device by default)."""
    device = device or getattr(pods, "device", "cpu")
    return torch.from_numpy(np.ascontiguousarray(x[list(pods.held)])).to(
        device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def loaded_reference(pods: Pods, *_) -> list:
    """The modules of the JAX package or of JAX this process has loaded
    (none, in a rank of the port).  Also a job of ``serve/ranks.
    serve_rank``, which calls it with the mesh, config and shards."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "jaxlib", "repro")
                  or m.startswith(("jax.", "jaxlib.", "repro.")))


def axis_ops(pods: Pods, x: np.ndarray, chunks: np.ndarray) -> dict:
    """Every operation of the axis on the held rows: ``x (n, ...)`` for
    the per-rank ones, ``chunks (n, n, ...)`` for ``all_to_all``."""
    t, c = rows(pods, x), rows(pods, chunks)
    return {"axis_index": _np(pods.axis_index(t.device)),
            "all_to_all": _np(pods.all_to_all(c)),
            "all_gather": _np(pods.all_gather(t)),
            "all_gather_int8": _np(pods.all_gather(t.to(torch.int8))),
            "ring_shift": _np(pods.ring_shift(t)),
            "psum": _np(pods.psum(t)), "pmean": _np(pods.pmean(t)),
            "pmean_bf16": _np(pods.pmean(t.bfloat16()))}


def model_axis_ops(pods: Pods, x: np.ndarray) -> dict:
    """The ``model`` axis's operations on the held rows of ``x (n, ...)``
    (``parallel/model_axis.DistModelAxis`` over ``pods``), rank 0's
    object broadcast, and the exchanges counted."""
    from repro_torch.parallel.model_axis import DistModelAxis
    axis = DistModelAxis(pods)
    t = rows(pods, x)
    out = {"psum": _np(axis.psum(t)), "psum_bf16": _np(axis.psum(t.bfloat16())),
           "gather": _np(axis.gather(t)),
           "object": axis.broadcast_object({"from": pods.rank})}
    axis.barrier()
    return dict(out, exchanges=dict(axis.exchanges))


def reduce_cases(pods: Pods, grads: dict, errs: dict, cases: list,
                 bucket_bytes: int) -> dict:
    """``reduce_gradients`` of the held rows of ``grads``/``errs``
    (``{leaf: (n, *shape)}``) for each case ``(name, method, bucketed,
    overlap, quant_impl)``: ``{name: {"out": {...}, "res": {...},
    "chains": int}}``."""
    out = {}
    for name, method, bucketed, overlap, impl in cases:
        g = {k: rows(pods, v) for k, v in grads.items()}
        e = {k: rows(pods, v) for k, v in errs.items()}
        with runtime.use_policy(quant_impl=impl):
            C.reset_chain_count()
            red, res = C.reduce_gradients(g, pods, method, e,
                                          bucketed=bucketed,
                                          bucket_bytes=bucket_bytes,
                                          overlap=overlap)
        out[name] = {"out": {k: _np(v) for k, v in red.items()},
                     "res": {k: _np(v) for k, v in res.items()},
                     "chains": C.chain_count()}
    return out


def digest(t: torch.Tensor, chunk: int = 1 << 24) -> int:
    """A 64-bit fingerprint of ``t``'s bits, computed where ``t`` lies:
    the sum, modulo 2**64, of each element's bit pattern times a weight
    that depends on its position.  Equal tensors give equal digests;
    tensors that differ in any bit almost surely do not."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total = 0
    for lo in range(0, bits.numel(), chunk):
        part = bits[lo:lo + chunk].long()
        w = torch.arange(lo, lo + part.numel(), device=part.device)
        w = (w * 2654435761 + 40503) & 0xFFFFFFFF
        total = (total + int((part * w).sum())) & (2 ** 64 - 1)
    return total


def train_steps(pods: Pods, cfg, options, steps: int, seq_len: int,
                global_batch: int, seed: int = 0,
                return_params: bool = False, device=None,
                masked_rows: int = 0) -> dict:
    """``steps`` train steps of ``cfg`` over ``pods`` from parameters
    drawn from ``seed`` on ``device`` (default: a ``DistPodAxis``'s own,
    else the CPU), each on ``synth_batch`` ``s`` of the global batch
    (:func:`mask_labels` of its first ``masked_rows`` rows): every step's
    ``loss`` and ``loss_per_pod`` (``None`` where the step has none), a
    digest of each parameter after each step, and (``return_params``)
    the initial and the final parameters."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import common
    from repro_torch.train import step as tstep

    dev = torch.device(device or getattr(pods, "device", "cpu"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = tstep.make_train_state(cfg, options, gen, pods=pods)
    step = tstep.make_train_step(cfg, None, pods, options)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    from repro_torch import bridge
    out = {"losses": [], "loss": [], "digests": []}
    if return_params:
        out["initial"] = {path: _np(p).copy() for path, p in
                          bridge.flatten(state["params"])}
    for s in range(steps):
        batch = synth_batch(dcfg, s)
        batch["labels"] = mask_labels(batch["labels"], masked_rows)
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, m = step(state, batch)
        per_pod = m.get("loss_per_pod")
        out["losses"].append(None if per_pod is None
                             else _np(per_pod).tolist())
        out["loss"].append(float(m["loss"]))
        out["digests"].append([digest(p) for p in
                               common.tree_leaves(state["params"])])
    if return_params:
        out["params"] = {path: _np(p) for path, p in
                         bridge.flatten(state["params"])}
    return out


def mask_labels(labels: torch.Tensor, rows: int) -> torch.Tensor:
    """``labels`` with three of every four labels of the first ``rows``
    rows masked (-100): data ranks then hold unequal counts."""
    labels = labels.clone()
    cols = torch.arange(labels.shape[1]) % 4 != 0
    labels[:rows, cols] = -100
    return labels


def mesh_train(pods, shape, axes, cfg, options, steps: int, seq_len: int,
               global_batch: int, source=("seed", 0), record=None,
               device=None, masked_rows: int = 0,
               grads: bool = False) -> dict:
    """``steps`` train steps of ``cfg`` on a mesh of ``shape`` over
    ``axes`` — over the rank group of ``pods``, or emulated in this
    process where ``pods`` is ``None`` — each on ``synth_batch`` ``s``,
    from parameters ``source``: ``("seed", s)`` drawn from a generator
    seeded ``s`` on the device, or ``("numpy", tree)`` the full tree.
    After each step in ``record`` (default: all): the loss, every pod's,
    the aux losses, the gradient norm, the learning rate and the full
    parameters (the mesh's lead process only; gathered over the mesh), and
    a digest of each of this process's shards.  Also the exchanges by kind of the
    ``model`` and ``data`` axes and the bytes they staged.  ``grads`` (a
    mesh without a ``pod`` axis): also the first batch's gradient of
    every leaf, before the first step, gathered over the mesh (the lead
    process's; its exchanges not counted)."""
    from repro_torch import bridge
    from repro_torch.data.pipeline import for_arch, synth_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep

    dev = torch.device(device or getattr(pods, "device", "cpu"))
    mesh = make_mesh(shape, axes, ranks=pods)
    gen = torch.Generator(device=dev)
    gen.manual_seed(source[1] if source[0] == "seed" else 0)
    state = tstep.make_train_state(cfg, options, gen, pods=mesh)
    on_mesh = tstep._on_mesh(mesh)
    specs = tstep.mesh_layout(cfg, mesh)[0] if on_mesh else None
    if source[0] == "numpy":
        state["params"] = bridge.mesh_from_numpy(cfg, source[1], mesh, dev) \
            if on_mesh else bridge.params_from_numpy(cfg, source[1], dev)
        state["opt"] = opt.init_state(options.opt, state["params"], specs)
    step = tstep.make_train_step(cfg, None, mesh, options)
    dcfg = for_arch(cfg, seq_len, global_batch)
    out = {"steps": {}}
    if grads:
        if mesh.pod is not None or not on_mesh:
            raise ValueError("a first-step gradient needs a (data, model) "
                             "mesh without a pod axis")
        batch = synth_batch(dcfg, 0)
        batch["labels"] = mask_labels(batch["labels"], masked_rows)
        g, _ = tstep._mesh_grads(cfg, options, mesh, specs,
                                 tstep.mesh_layout(cfg, mesh)[1],
                                 state["params"],
                                 {k: v.to(dev) for k, v in batch.items()})
        full = bridge.gather_mesh(g, specs, mesh)
        out["grads"] = {path: _np(t).copy() for path, t in
                        bridge.flatten(full)} if mesh.is_lead else None
        del g, full
    axes = {"model": getattr(mesh.axis, "pods", mesh.axis),
            "data": mesh.data}
    # an axis may be the group's own, which earlier runs counted on too
    before = {name: (dict(getattr(a, "exchanges", {})),
                     getattr(a, "staged_bytes", 0))
              for name, a in axes.items()}
    for s in range(1, steps + 1):
        batch = synth_batch(dcfg, s - 1)
        batch["labels"] = mask_labels(batch["labels"], masked_rows)
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, m = step(state, batch)
        if record is not None and s not in record:
            continue
        full = bridge.gather_mesh(state["params"], specs, mesh) \
            if on_mesh else state["params"]
        out["steps"][s] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "lb_loss": float(m["lb_loss"]),
            "z_loss": float(m["z_loss"]),
            "loss_per_pod": _np(m["loss_per_pod"]).tolist()
            if "loss_per_pod" in m else None,
            "params": {path: _np(p).copy() for path, p in
                       bridge.flatten(full)} if mesh.is_lead else None,
            "digests": [digest(p) for p in
                        common.tree_leaves(state["params"])]}
        del full
    for name, axis in axes.items():
        was, staged = before[name]
        out[f"exchanges_{name}"] = {
            k: v - was.get(k, 0)
            for k, v in getattr(axis, "exchanges", {}).items()
            if v - was.get(k, 0)}
        out[f"staged_{name}"] = getattr(axis, "staged_bytes", 0) - staged
    return out


GUARD_BUCKETS, GUARD_ELEMS = 3, 1 << 12    # the reference guard's sizes
GUARD_SCALE = 8     # its burn a segment over its clean segment, ~8 ms / 1


def _counts(pods: Pods) -> dict:
    """Exchanges by kind so far (an emulated axis: the chains issued)."""
    if isinstance(pods, DistPodAxis):
        return dict(pods.exchanges)
    return {"chains": C.chain_count()}


def fabric_guard(pods: Pods, method: str = "ring", walls: int = 5,
                 device=None) -> dict:
    """The four parts of the reference's degraded-fabric guard
    (``tests/test_fabric.py``'s 4-device script, at its sizes) on the
    held rows: (a) ``fabric=None`` and a clean condition give
    bit-identical outputs and equal exchange counts under both
    schedules; (b) under the canonical straggler the outputs stay
    bit-identical, the counts equal, and only the straggler burns; (c)
    the median serial wall under the straggler over the clean one; (d)
    the single-bucket edge under the straggler reduces correctly.
    ``wall_ratio`` is (c) with the straggler's delay raised to
    GUARD_SCALE clean segments where the canonical 8 ms is less
    (``wall_ratio_canonical`` is the canonical one's); the conditions'
    runs are interleaved and each wall is a median of ``walls``.  The burn is the
    kernel on a CUDA device, its plain loop on the CPU.
    ``device``: a ``DistPodAxis``'s own by default, else the CPU."""
    from repro_torch.fabric import FabricCondition, canonical_conditions
    from repro_torch.fabric.inject import calibrate

    n = pods.n
    dev = torch.device(device or getattr(pods, "device", "cpu"))
    calibrate(pods, dev)            # before counting trips
    gen = torch.Generator().manual_seed(0)
    full = {f"w{i}": torch.randn((n, GUARD_ELEMS), generator=gen).numpy()
            for i in range(GUARD_BUCKETS)}
    want = {k: rows(pods, np.broadcast_to(v.mean(0, keepdims=True),
                                          v.shape).copy(), dev)
            for k, v in full.items()}

    def reduce(overlap, fabric, bb=GUARD_ELEMS * 4):
        tree = {k: rows(pods, v, dev) for k, v in full.items()}
        C.reset_chain_count()
        before = _counts(pods)
        trips, launches = kburn.TRIPS, kburn.LAUNCHES
        out = C.reduce_gradients(tree, pods, method, None, bucketed=True,
                                 bucket_bytes=bb, overlap=overlap,
                                 fabric=fabric)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        after = _counts(pods)
        counts = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        return out, counts, (kburn.TRIPS - trips,
                             kburn.LAUNCHES - launches)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    strag = canonical_conditions()["straggler"]
    res = {"clean_identical": True, "clean_counts_equal": True,
           "clean_burns": 0, "straggler_identical": True,
           "straggler_counts_equal": True, "straggler_trips": 0,
           "straggler_launches": 0, "single_bucket_ok": True,
           "single_bucket_err": 0.0}
    for ov in (False, True):
        o0, c0, b0 = reduce(ov, None)
        o1, c1, b1 = reduce(ov, FabricCondition.clean())
        res["clean_identical"] &= same(o0, o1)
        res["clean_counts_equal"] &= c0 == c1
        res["clean_burns"] += b0[0] + b1[0]
        o2, c2, b2 = reduce(ov, strag)
        res["straggler_identical"] &= same(o0, o2)
        res["straggler_counts_equal"] &= c0 == c2
        res["straggler_trips"] += b2[0]
        res["straggler_launches"] += b2[1]
        o3, _, _ = reduce(ov, strag, bb=GUARD_BUCKETS * GUARD_ELEMS * 4)
        err = max(float((o3[k] - want[k]).abs().max()) for k in o3)
        res["single_bucket_err"] = max(res["single_bucket_err"], err)
        res["single_bucket_ok"] &= err <= 1e-6
        res["counts"] = c0

    def walls_of(*conditions) -> list:
        """Median serial walls, the conditions' runs interleaved."""
        for cond in conditions:
            reduce(False, cond)
        ts = [[] for _ in conditions]
        for _ in range(walls):
            for t, cond in zip(ts, conditions):
                if isinstance(pods, DistPodAxis):
                    pods.barrier()
                t0 = time.perf_counter()
                reduce(False, cond)
                t.append(time.perf_counter() - t0)
        return [statistics.median(t) for t in ts]

    res["wall_clean_s"], res["wall_straggler_s"] = walls_of(None, strag)
    res["wall_ratio_canonical"] = res["wall_straggler_s"] \
        / res["wall_clean_s"]
    # (c) at the reference's proportion: its guard burns 8 ms a segment
    # against segments of ~1 ms; where a clean segment costs more (gloo
    # between processes: several ms on the CPU, ~10-20 ms on one card),
    # the straggler burns GUARD_SCALE clean segments a segment, so that
    # ">3x" asks the same question: does every rank's wall carry the
    # straggler's burn
    delay = max(strag.straggler_delay_s,
                GUARD_SCALE * res["wall_clean_s"] / GUARD_BUCKETS)
    res["straggler_delay_s"] = delay
    clean, res["wall_scaled_s"] = walls_of(None, dataclasses.replace(
        strag, name="straggler_scaled", straggler_delay_s=delay))
    res["wall_ratio"] = res["wall_scaled_s"] / clean
    res["rank"] = getattr(pods, "rank", None)
    return res


def in_turn(pods: Pods, calls: list) -> list:
    """Several bodies in one group, in order (one start-up for all):
    ``calls`` is ``[(fn, args), ...]``; returns their results."""
    return [fn(pods, *args) for fn, args in calls]


# ---------------------------------------------------------------------------
# jobs of serve/ranks.serve_rank: rank 0's side of tensor-parallel serving
# ---------------------------------------------------------------------------

def streams(reqs) -> list:
    return [list(r.generated) for r in reqs]


def burst(mesh, cfg, params, engine_kw: dict, requests: list) -> dict:
    """``requests`` through a ``ContinuousEngine(**engine_kw)`` on
    ``mesh``: their streams, the admission log, whether the pool was
    recycled and the decode tick's exchanges by kind."""
    from repro_torch.serve.continuous import ContinuousEngine
    eng = ContinuousEngine(cfg, params, mesh=mesh, **engine_kw)
    eng.run(requests)
    eng.scheduler.check()
    return {"streams": streams(requests),
            "admit_log": list(eng.scheduler.admit_log),
            "pool_recycled": eng.kv.n_free == eng.kv.n_blocks,
            "collectives": eng.cells.decode_collective_counts(eng.params)}


def failing(mesh, cfg, params, engine_kw: dict, requests: list,
            after: int) -> None:
    """A host loop that fails: the engine's clock raises on its
    ``after``-th reading, between two calls of the cells."""
    from repro_torch.serve.continuous import ContinuousEngine
    reads = {"n": 0}

    def clock():
        reads["n"] += 1
        if reads["n"] > after:
            raise RuntimeError("rank 0's clock failed")
        return time.perf_counter()

    ContinuousEngine(cfg, params, mesh=mesh, clock=clock,
                     **engine_kw).run(requests)


def greedy(mesh, params, cfg, batch: dict, steps: int,
           cache_len: int) -> dict:
    """A prefill of ``batch`` (numpy or tensors: ``tokens`` and, for an
    encoder-decoder or a VLM, ``frames`` or ``patches``) then ``steps``
    greedy decode steps at one scalar position, through
    ``models/registry`` over ``mesh``'s model axis (one device where
    ``mesh`` is ``None``), on ``params`` (the held ranks' shards): the
    token streams, the seconds to the first token and of each step.  Run
    on every rank of a group alike (``serve/ranks.call_all_ranks``)."""
    from repro_torch.models import registry
    axis = None if mesh is None else mesh.axis
    dev = next(iter(params["embed"].values())).device
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = registry.prefill(cfg, params, b,
                                          cache_len=cache_len, axis=axis)
        tok = torch.argmax(logits[:, -1], dim=-1)
        streams = [tok.cpu().tolist()]
        ttft = time.perf_counter() - t0
        index = b["tokens"].shape[1] + (
            b["patches"].shape[1] if "patches" in b else 0)
        step_s = []
        for i in range(steps):
            t1 = time.perf_counter()
            out, caches = registry.decode_step(
                cfg, params, {"tokens": tok[:, None].to(torch.int32),
                              "index": index + i}, caches, axis=axis)
            tok = torch.argmax(out[:, -1], dim=-1)
            streams.append(tok.cpu().tolist())
            step_s.append(time.perf_counter() - t1)
    return {"streams": [list(r) for r in zip(*streams)], "ttft_s": ttft,
            "step_s": step_s}


def greedy_job(mesh, cfg, params, batch: dict, steps: int,
               cache_len: int) -> dict:
    """``serve/ranks.serve_rank``'s job: :func:`greedy` on every rank."""
    from repro_torch.serve import ranks
    return ranks.call_all_ranks(mesh, params, greedy, cfg, batch, steps,
                                cache_len)


def pipeline_run(pods, ws: np.ndarray, mbs: np.ndarray,
                 tgt: np.ndarray) -> dict:
    """``parallel/pipeline.py`` with ``stage_fn = tanh(x @ w)`` over
    ``pods`` as the stage axis (``ws (n, D, D)``, stage ``s``'s weights
    ``ws[s]``): the held stages' outputs of ``pipeline`` and gradients of
    ``pipelined_loss`` (the mean squared error against ``tgt``)."""
    from repro_torch.parallel import pipeline as PP
    n = ws.shape[0]
    dev = getattr(pods, "device", "cpu")
    w = rows(pods, ws, dev).requires_grad_(True)
    m = torch.from_numpy(np.ascontiguousarray(mbs)).to(dev)
    t = torch.from_numpy(np.ascontiguousarray(tgt)).to(dev)

    def stage_fn(w, x):
        return torch.tanh(x @ w)
    out = PP.pipeline(stage_fn, n, pods)(w, m)
    loss = PP.pipelined_loss(stage_fn, lambda o, t: torch.mean((o - t) ** 2),
                             n, pods)(w, m, t)
    grad, = torch.autograd.grad(loss[0], w)
    return {"out": _np(out), "loss": _np(loss), "grad": _np(grad)}


def train_cli(pods: Pods, args, prog: str) -> list:
    """``launch/train.py``'s run in one rank of its ``--devices`` group:
    the history of the steps (rank 0 prints)."""
    import argparse

    from repro_torch.launch import train
    return train.run(args, pods.device, argparse.ArgumentParser(prog=prog),
                     ranks=pods)


def mesh_axes(pods: Pods, cases: list) -> list:
    """For each ``(shape, axes)`` mesh over the group: each named axis's
    ``(this rank's index, size, the group's ranks in it)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    out = []
    for shape, axes in cases:
        mesh = make_mesh(shape, axes, ranks=pods)
        got = {}
        for name in axes:
            a = {"model": getattr(mesh.axis, "pods", None),
                 "data": mesh.data, "pod": mesh.pod}[name]
            if isinstance(a, DistPodAxis):
                members = list(range(a.n)) if a.group is None \
                    else dist.get_process_group_ranks(a.group)
            else:
                members = [pods.rank]
            got[name] = (a.held[0], a.n, members)
        out.append(got)
    return out


def adafactor_shards(pods, params: np.ndarray, grads: list,
                     cfg: dict) -> dict:
    """Adafactor (``cfg``: ``OptConfig``'s fields) on the shards of a 2-D
    leaf ``params`` split over data (rows) and model (columns) of a (2,
    2) mesh over ``pods`` (emulated where ``None``), one update a gradient
    of ``grads``: the leaf put back together, the last update's gradient
    norm and that of the whole gradient."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.mesh_tree import LeafSpec, MeshTree
    from repro_torch.train import optimizer as opt

    mesh = make_host_mesh(2, 2, ranks=pods)
    tree = MeshTree(mesh)
    spec = {"w": LeafSpec(tuple(params.shape), data=0, model=1)}
    p = {"w": tree.shard(torch.from_numpy(params), spec["w"])}
    ocfg = opt.OptConfig(**cfg)
    state = opt.init_state(ocfg, p, spec)
    for g in grads:
        m = opt.apply_updates(ocfg, p, {"w": tree.shard(torch.from_numpy(g),
                                                        spec["w"])},
                              state, spec, tree)
    return {"w": _np(tree.gather(p["w"], spec["w"])),
            "grad_norm": float(m["grad_norm"]),
            "ref_norm": float(np.sqrt((grads[-1].astype(np.float64) ** 2)
                                      .sum()))}


def pipeline_exchanges(pods: Pods, ws: np.ndarray, mbs: np.ndarray,
                       tgt: np.ndarray) -> dict:
    """:func:`pipeline_run`'s exchanges by kind in this rank."""
    before = dict(pods.exchanges)
    pipeline_run(pods, ws, mbs, tgt)
    return {k: v - before.get(k, 0) for k, v in pods.exchanges.items()}
