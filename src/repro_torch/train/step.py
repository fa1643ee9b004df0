"""Train-step factory: loss, grad, pod reduction, optimizer.

Counterpart of ``repro/train/step.py``, with the ``pod`` axis of
``parallel/pods.py``: emulated on one device (``PodAxis``) or one process
a rank (``DistPodAxis``, started by ``parallel/dist.run_ranks``).  Two
modes, as the reference's:

  * ``dp_method="stock"`` on an emulated axis, or one pod — one backward
    over the whole batch (the reference's GSPMD path, where every
    collective is implicit);
  * ``dp_method in {int8_a2a, int8_ring, int8_pairwise, ring}`` with ``n``
    pods, or any method over a ``DistPodAxis`` — pod ``i`` runs forward
    and backward on batch rows ``[i·B/n, (i+1)·B/n)`` (the reference's
    ``P("pod")``), and the per-pod gradients cross the pod axis through
    ``parallel/collectives.reduce_gradients`` (int8 wire format and
    error feedback for the compressed methods).  ``stock`` over a
    ``DistPodAxis`` still computes the reference's one global step
    (:func:`make_loss_fn`'s ``glob``): every rank holds the global batch
    and counts its unmasked labels, each pod's ``Σ nll`` is divided by
    that count (times the pod count, as the reduction is a ``pmean``), a
    MoE's per-expert density is reduced over ``pod`` before the load
    balance's product, and the metrics are the global ones.

What each pod holds follows the reference's shard_map, measured: the
reduced gradients, and so the parameters and optimizer state, are equal on
every pod, so on an emulated axis ONE copy is kept (pod 0's; under
``int8_pairwise`` each pod sums the ring in its own order, and the pods'
sums differ in the last bits, in the reference too); the error-feedback
residuals ``err`` and the losses differ per pod, so one copy a held pod is
kept (``err`` as ``(L, *shape)`` bf16, ``L`` = ``n`` emulated, 1 a rank
process).  Over a ``DistPodAxis`` each rank keeps its own reduced
gradients, parameters and optimizer state, as each device of the
reference does.  ``metrics["loss_per_pod"]`` holds every pod's loss, its
own rows' mean (gathered over the axis); under a compressed method
``metrics["loss"]`` is pod 0's, as reading the reference's
replicated-looking shard_map output gives pod 0's value, and under
``stock`` it is the global loss.

**On a mesh** (``launch/mesh.Mesh`` with a ``data`` or ``model`` axis
above one; its ``pod`` axis, if any, above them) every leaf of the state
is a rank's shard, leading with its rank dims ``(Dl, Ml)``
(``parallel/mesh_tree.py``; ``err`` leads with the held pods as well).
Pod ``p`` takes rows ``[p·B/P, (p+1)·B/P)`` of the global batch and data
rank ``d`` its ``d``-th ``1/D`` of those (stock on an emulated pod axis
takes the whole batch at once, as above).  Each held data rank gathers
the FSDP shards of the parameters over ``data``, runs forward and
backward on its rows (and their ``frames`` or ``patches``) — over the
``model`` axis through ``transformer.loss_tp`` (Megatron's conjugate
pairs, vocab-parallel cross entropy, ``sequence_parallel``; every family,
with or without sequence parallelism) — and its
gradients are reduce-scattered over ``data``.  The loss is the pod's
``Σ nll / Σ mask``, both sums reduced over ``data`` (never a mean of the
ranks' means), and a MoE's load balance the product of its two means
reduced over ``data``, as the reference's global batch gives them;
``stock`` over ranked pods divides by the global batch's count instead
and reduces the load-balance density over ``pod`` as well (the global
step, as :func:`make_loss_fn`'s ``glob``).  With
a compressed ``dp_method`` each ``(data, model)`` rank then reduces its
local gradient shards over ``pod`` (``collectives.reduce_gradients``:
its own buckets, K3a and K3b in the int8 chains), with its own ``err``
for each held pod.  The optimizer runs on the shards
(``optimizer.apply_updates(..., specs, tree)``).

The step updates ``state`` in place and returns it: parameters and
optimizer state are written by ``optimizer.apply_updates``, ``err`` is
replaced.  The loss runs under ``attention_impl="chunked"``, the
reference's training attention, and ``rwkv_impl="torch"``, the plain
chunked WKV-6 scan the reference trains the ``ssm`` family through (the
flash kernel and the scan kernel have no backward).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from repro_torch import runtime
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common, moe, registry, transformer
from repro_torch.parallel import collectives
from repro_torch.parallel.mesh_tree import MeshTree
from repro_torch.parallel.pods import DistPodAxis, PodAxis, Pods
from repro_torch.train import optimizer as opt

LB_WEIGHT = 0.01
Z_WEIGHT = 1e-3


@dataclass(frozen=True)
class TrainOptions:
    dp_method: str = "stock"       # stock | int8_a2a | int8_ring |
    #                                int8_pairwise | ring
    microbatches: int = 1
    remat: bool = True
    sequence_parallel: bool = False  # Megatron-SP over the 'model' axis
    #                                (a no-op without one, as the
    #                                reference's seq_sp rule)
    dp_bucketed: Optional[bool] = None   # fuse grads into bucket buffers;
    #                                None = auto: on for chunked methods,
    #                                off for shape-preserving int8_pairwise
    dp_bucket_bytes: int = collectives.DEFAULT_BUCKET_BYTES
    dp_overlap: Optional[bool] = None    # bucket-chain schedule: True
    #                                pipelines, False serializes, None =
    #                                policy auto (parallel/overlap.py)
    opt: opt.OptConfig = field(default_factory=opt.OptConfig)


def check_trainable(options: TrainOptions) -> None:
    if options.dp_method not in collectives.METHODS:
        raise ValueError(f"dp_method {options.dp_method!r}; expected one of "
                         f"{collectives.METHODS}")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def xent_loss(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor):
    """logits: (B, S, V) fp32; labels: (B, S) int32 (-100 = masked).  A
    VLM's logits span its patches too: the loss takes the text positions,
    the last ``S``."""
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(cfg: ArchConfig, options: TrainOptions, glob=None):
    """``loss_fn(params, batch) -> (total, metrics)``: the mean nll over
    ``batch``'s unmasked labels plus the weighted aux losses.

    ``glob``: ``(pods, count)`` for ``stock`` over ranked pods (a
    ``DistPodAxis``, each rank one pod on its rows of the global batch),
    ``count`` the unmasked labels of every pod's rows of this microbatch.
    The nll term is then ``P · Σ nll / count``, so that the ``pmean``
    over ``pod`` the gradient reduction takes is the reference's ``Σ nll
    / Σ mask``; the load balance is the product of the per-expert density
    reduced over ``pod`` with the pod's router mean, whose ``pmean`` is
    the global means' product; the z-loss is a mean over tokens, as many
    in every pod.  The metrics are then the pod's share of each global
    one (``loss``: ``Σ nll / count``) and its own mean (``own``)."""
    def loss_fn(params, batch):
        if glob is not None:
            return _pod_share(cfg, options, params, batch, *glob)
        with runtime.use_policy(attention_impl="chunked",
                                rwkv_impl="torch"):
            logits, aux = registry.forward(cfg, params, batch,
                                           remat=options.remat)
        loss = xent_loss(cfg, logits, batch["labels"])
        total = loss + LB_WEIGHT * aux["lb_loss"] + Z_WEIGHT * aux["z_loss"]
        return total, {"loss": loss, "lb_loss": aux["lb_loss"],
                       "z_loss": aux["z_loss"]}
    return loss_fn


def _pod_share(cfg, options, params, batch, pods, count):
    """``make_loss_fn``'s loss under ``glob = (pods, count)``."""
    sums = _forward_sums(cfg, options, params, batch)
    share = sums["nll"] / count
    lb = torch.zeros((), device=share.device)
    if sums["lb_means"]:
        dens = pods.pmean(torch.stack([d.detach() for d, _ in
                                       sums["lb_means"]])[None])[0]
        lb = sum(moe.load_balance(cfg, dens[layer], rm)
                 for layer, (_, rm) in enumerate(sums["lb_means"]))
    total = pods.n * share + LB_WEIGHT * lb + Z_WEIGHT * sums["z"]
    own = sums["nll"] / torch.clamp_min(sums["count"], 1.0)
    return total, {"loss": share, "lb_loss": lb, "z_loss": sums["z"],
                   "own": own}


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def _axis(pods) -> Pods:
    if isinstance(pods, Mesh):
        return pods.pod or PodAxis(1)
    return pods if isinstance(pods, (PodAxis, DistPodAxis)) \
        else PodAxis(int(pods))


def _on_mesh(pods) -> bool:
    """Whether ``pods`` is a mesh with a data or model axis above one."""
    return isinstance(pods, Mesh) and (pods.dp_size > 1 or pods.tp_size > 1)


def make_train_state(cfg: ArchConfig, options: TrainOptions,
                     gen: torch.Generator, pods: Union[int, Pods] = 1):
    """Parameters drawn from ``gen`` on its device, optimizer state, step
    counter, and — for a compressed ``dp_method`` — one bf16 error-feedback
    tree a held pod, stacked ``(L, *shape)``.  Every rank of a
    ``DistPodAxis`` draws the same parameters from a generator seeded
    alike."""
    check_trainable(options)
    if _on_mesh(pods):
        return _mesh_state(cfg, options, gen, pods)
    params = registry.init_params(cfg, gen)
    state = {"params": params,
             "opt": opt.init_state(options.opt, params),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device)}
    if options.dp_method != "stock":
        n = len(_axis(pods).held)
        state["err"] = common.tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape),
                                  dtype=torch.bfloat16, device=p.device),
            params)
    return state


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _grads_and_metrics(cfg, options, params, batch, glob=None):
    """Gradients of the loss over ``batch`` (microbatch-accumulated in f32
    when ``options.microbatches > 1``) and its metrics, detached (each a
    mean over the microbatches).  ``glob``: ``(pods, counts)``, the global
    batch's count of each microbatch (``make_loss_fn``'s ``glob``)."""
    def loss_fn(params, batch, i=0):
        count = None if glob is None else (glob[0], glob[1][i])
        return make_loss_fn(cfg, options, count)(params, batch)
    structure = common.tree_structure(params)
    leaves = common.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    n = options.microbatches
    if n <= 1:
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves)
        return (common.tree_unflatten(structure, grads),
                {k: v.detach() for k, v in metrics.items()})
    # microbatch gradient accumulation (fp32 accumulator)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows is not {n} microbatches")
    b = rows // n
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    met = None
    for i in range(n):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        total, metrics = loss_fn(params, mb, i)
        for a, g in zip(acc, torch.autograd.grad(total, leaves)):
            a += g.float() / n
        metrics = {k: v.detach() / n for k, v in metrics.items()}
        met = metrics if met is None else {k: met[k] + metrics[k]
                                           for k in met}
    return common.tree_unflatten(structure, acc), met


def _apply(options, state, grads, metrics, errors=None, specs=None,
           tree=None):
    """The optimizer's step on ``grads`` (``specs``, ``tree``: a mesh's
    shards), ``err`` replaced by ``errors`` where given; ``(state,
    metrics)``."""
    om = opt.apply_updates(options.opt, state["params"], grads, state["opt"],
                           specs, tree)
    state["step"] += 1
    if errors is not None:
        state["err"] = errors
    return state, dict(metrics, **om)


def _per_pod(cfg, options, params, batch, pods: Union[int, Pods],
             glob: bool = False) -> dict:
    """Each held pod's gradients on its rows of the global ``batch``,
    stacked ``(L, *shape)`` (one pod's autograd output alive at a time),
    and each held pod's metrics.  ``glob``: each pod's share of the
    reference's global step (``stock`` over ranked pods:
    ``make_loss_fn``'s ``glob``), microbatch ``i`` every pod's ``i``-th
    slice of its rows."""
    pods = _axis(pods)
    n, held = pods.n, pods.held
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"global batch of {rows} rows does not split over "
                         f"{n} pods")
    b = rows // n
    counts = None
    if glob:
        micro = max(options.microbatches, 1)
        mb = b // micro
        counts = (pods, _global_counts(batch["labels"], [[
            slice(p * b + i * mb, p * b + (i + 1) * mb) for p in range(n)]
            for i in range(micro)]))
    stacked, metrics = None, []
    for j, i in enumerate(held):
        grads, m = _grads_and_metrics(
            cfg, options, params, {k: v[i * b:(i + 1) * b]
                                   for k, v in batch.items()}, counts)
        structure = common.tree_structure(grads)
        leaves = common.tree_leaves(grads)
        del grads
        if len(held) == 1:          # one rank: its gradients, not a copy
            stacked = [g.unsqueeze(0) for g in leaves]
        else:
            if stacked is None:
                stacked = [torch.empty((len(held),) + tuple(g.shape),
                                       dtype=g.dtype, device=g.device)
                           for g in leaves]
            for dst, g in zip(stacked, leaves):
                dst[j].copy_(g)
        del leaves
        metrics.append(m)
    return {"grads": common.tree_unflatten(structure, stacked),
            "metrics": metrics}


def _forward_sums(cfg, options, params, batch) -> dict:
    """One forward on ``batch``: ``{"nll", "count", "z", "lb_means"}``
    (sums of the nll and the unmasked labels; the MoE's z-loss and
    load-balance means, none for the other families)."""
    with runtime.use_policy(attention_impl="chunked", rwkv_impl="torch"):
        logits, aux = registry.forward(cfg, params, batch,
                                       remat=options.remat)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    nll, count = transformer._xent_sum(logits, labels)
    return {"nll": nll, "count": count, "z": aux["z_loss"],
            "lb_means": aux.get("lb_means", [])}


def _global_counts(labels, chunks: list) -> torch.Tensor:
    """The unmasked labels of the global batch's rows in each microbatch
    (``chunks[i]``: its row slices over every pod and data rank), at
    least one; every rank holds the global batch, so no exchange."""
    return torch.stack([torch.clamp_min(sum(
        (labels[s] >= 0).sum().float() for s in rows), 1.0)
        for rows in chunks])


def make_train_step(cfg: ArchConfig, shape: Optional[ShapeConfig],
                    pods: Union[int, Pods, Mesh] = 1,
                    options: TrainOptions = TrainOptions()):
    """Returns ``step_fn(state, batch) -> (state, metrics)`` (``shape`` is
    kept for the reference's signature; nothing here depends on it).
    ``pods``: a pod count, a pod axis, or a ``Mesh`` (module docstring).
    ``batch`` holds the global batch's ``tokens`` and ``labels`` ``(B, S)``
    on the state's device (every rank of a ``DistPodAxis`` is given the
    same batch and takes its rows)."""
    check_trainable(options)
    if _on_mesh(pods):
        return _mesh_step(cfg, options, pods)
    pods = _axis(pods)
    n = pods.n

    if isinstance(pods, PodAxis) and (options.dp_method == "stock"
                                      or n == 1):
        def step(state, batch):
            grads, metrics = _grads_and_metrics(cfg, options,
                                                state["params"], batch)
            return _apply(options, state, grads, metrics,
                          errors=state.get("err"))
        return step

    stock = options.dp_method == "stock"

    def step(state, batch):
        per_pod = _per_pod(cfg, options, state["params"], batch, pods, stock)
        # hand the stacked gradients and the old residuals over without
        # keeping a reference here: the bucketed reduction frees each
        # bucket's inputs once packed
        red, errors = collectives.reduce_gradients(
            per_pod.pop("grads"), pods, options.dp_method,
            state.pop("err", None), bucketed=options.dp_bucketed,
            bucket_bytes=options.dp_bucket_bytes,
            overlap=options.dp_overlap)
        if errors is not None:
            errors = common.tree_map(lambda e: e.to(torch.bfloat16), errors)
        # every pod's reduced gradients are equal: the first held pod's
        # drive the one copy of the parameters and optimizer state
        grads = common.tree_map(lambda r: r[0], red)
        del red
        held = per_pod["metrics"]
        pod_losses = pods.all_gather(torch.stack([
            m.pop("own") if stock else m["loss"] for m in held]))[0]
        if stock:
            # the global metrics: the pods' shares of the loss summed, the
            # aux losses' means averaged (one pod a rank)
            tot = pods.psum(torch.stack([held[0]["loss"],
                                         held[0]["lb_loss"] / pods.n,
                                         held[0]["z_loss"] / pods.n])[None])[0]
            metrics = {"loss": tot[0], "lb_loss": tot[1], "z_loss": tot[2]}
        else:
            metrics = dict(held[0], loss=pod_losses[0])
        return _apply(options, state, grads,
                      dict(metrics, loss_per_pod=pod_losses), errors)

    return step


# ---------------------------------------------------------------------------
# the step on a mesh (module docstring)
# ---------------------------------------------------------------------------

def _mesh_state(cfg, options, gen, mesh):
    """The held ranks' shards of the parameters drawn from ``gen`` (the
    one-device draw's slices), optimizer state on them, and for a
    compressed ``dp_method`` one bf16 ``err`` a held pod and shard."""
    params = bridge.init_mesh_shards(cfg, gen, mesh)
    specs = bridge.mesh_specs(cfg, mesh)
    state = {"params": params,
             "opt": opt.init_state(options.opt, params, specs),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device)}
    if options.dp_method != "stock":
        n = len(_axis(mesh).held)
        state["err"] = common.tree_map(
            lambda p: torch.zeros((n,) + tuple(p.shape),
                                  dtype=torch.bfloat16, device=p.device),
            params)
    return state


def mesh_layout(cfg: ArchConfig, mesh):
    """``(specs, tree)`` of ``cfg``'s parameters on ``mesh``: a
    ``LeafSpec`` a leaf and the ``MeshTree`` over the mesh."""
    return bridge.mesh_specs(cfg, mesh), MeshTree(mesh)


def _rank_forward(cfg, options, mesh, model_in, split, batch):
    """One data rank's forward on its rows: ``{"nll", "count", "z",
    "lb_means"}`` (sums of the nll and the unmasked labels; the MoE's
    z-loss and load-balance means, none for the other families), on one
    device or over the model axis alike (an encoder-decoder's ``frames``
    and a VLM's ``patches`` with the rows; a VLM's loss on its text
    positions).  ``split``: over a model axis, whether it splits each
    leaf."""
    with runtime.use_policy(attention_impl="chunked", rwkv_impl="torch"):
        if mesh.tp_size > 1:
            nll, count, aux = transformer.loss_tp(
                cfg, model_in, split, batch["tokens"], batch["labels"],
                mesh.axis,
                sequence_parallel=options.sequence_parallel,
                remat=options.remat, frames=batch.get("frames"),
                patches=batch.get("patches"))
            if aux is None:
                return {"nll": nll, "count": count, "z": None,
                        "lb_means": []}
            return {"nll": nll, "count": count, "z": aux["z_loss"],
                    "lb_means": aux["lb_means"]}
    return _forward_sums(cfg, options, model_in, batch)


def _mesh_grads(cfg, options, mesh, specs, tree, params, batch,
                glob=None):
    """One pod's gradients on its rows ``batch``, each leaf ``(Dl, Ml,
    *local)`` (reduced over ``data``), and the pod's metrics (``own``: the
    pod's own loss).  ``glob``: ``(pods, the global batch's count of each
    microbatch)`` for ``stock`` over ranked pods — each pod's loss term is
    then its share of the global loss times the pod count (the reduction
    over ``pod`` is a ``pmean``), its ``loss`` metric that share, and the
    load-balance density is reduced over ``pod`` too (as
    :func:`make_loss_fn`'s ``glob``)."""
    data, held = mesh.data, tree.held["data"]
    D, Dh = mesh.dp_size, len(tree.held["data"])
    rows = next(iter(batch.values())).shape[0]
    n = options.microbatches
    if rows % (D * n):
        raise ValueError(f"a pod's batch of {rows} rows does not split over "
                         f"{D} data ranks of {n} microbatches")
    b, mb = rows // D, rows // (D * n)
    structure = common.tree_structure(params)
    sflat = common.tree_leaves(specs)
    full = [tree.gather_data(x, s).detach().requires_grad_(True)
            for x, s in zip(common.tree_leaves(params), sflat)]
    gathered = common.tree_unflatten(structure, full)
    model_in = gathered if mesh.tp_size > 1 \
        else common.tree_index(gathered, 0)
    split = common.tree_map(lambda s: s.model is not None, specs)
    acc = [None] * Dh
    met = {"loss": 0.0, "lb_loss": 0.0, "z_loss": 0.0, "own": 0.0}
    pods, scale = (None, 1) if glob is None else (glob[0], glob[0].n)
    for i in range(n):
        parts = [{k: v[d * b + i * mb:d * b + (i + 1) * mb]
                  for k, v in batch.items()} for d in held]
        counts = torch.stack([(p["labels"] >= 0).sum().float()
                              for p in parts])
        own = torch.clamp_min(data.psum(counts)[0], 1.0)
        total = own if glob is None else glob[1][i]

        def backward(j, out, lb=None):
            loss = scale * out["nll"] / total
            z = out["z"]
            if z is not None:
                loss = loss + Z_WEIGHT * z / D
            if lb is not None:
                loss = loss + LB_WEIGHT * lb
            grads = torch.autograd.grad(loss / n, full)
            if acc[j] is None:
                acc[j] = [g.float() if n > 1 else g for g in grads]
            else:
                for a, g in zip(acc[j], grads):
                    a += g.float()

        outs = []
        for j, p in enumerate(parts):
            out = _rank_forward(cfg, options, mesh, model_in, split, p)
            outs.append({"nll": out["nll"].detach(),
                         "z": out["z"].detach() / D
                         if out["z"] is not None else None})
            if out["lb_means"]:
                outs[-1]["graph"] = out        # backward once all are in
            else:
                backward(j, out)
        lbs = [None] * Dh
        if any("graph" in o for o in outs):
            # the load balance of the pod's rows: the per-expert means
            # reduced over data, their product taken once
            layers = len(outs[0]["graph"]["lb_means"])
            dens = [data.psum(torch.stack([o["graph"]["lb_means"][layer][0]
                                           .detach() for o in outs])) / D
                    for layer in range(layers)]
            if pods is not None:        # and over pod: the global means
                dens = [pods.pmean(dn[None])[0] for dn in dens]
            for j, o in enumerate(outs):
                lbs[j] = sum(moe.load_balance(
                    cfg, dens[layer][j], o["graph"]["lb_means"][layer][1])
                    for layer in range(layers)) / D
                backward(j, o.pop("graph"), lbs[j])
        zero = torch.zeros((), device=total.device)
        sums = data.psum(torch.stack([torch.stack([
            o["nll"] / total, zero if lb is None else lb.detach(),
            zero if o["z"] is None else o["z"], o["nll"] / own])
            for o, lb in zip(outs, lbs)]))[0] / n      # one all-reduce
        for k, key in enumerate(("loss", "lb_loss", "z_loss", "own")):
            met[key] = met[key] + sums[k]
    grads = []
    for k, s in enumerate(sflat):
        g = torch.stack([acc[j][k] for j in range(Dh)])
        for j in range(Dh):
            acc[j][k] = None
        grads.append(tree.reduce_data(g, s))
        del g
    return common.tree_unflatten(structure, grads), met


def reduction_classes(sflat) -> list:
    """The leaves' indices (of ``sflat``, their ``LeafSpec``s in
    ``tree_leaves`` order) by the axes that split them: each class is
    reduced over ``pod`` in buckets of its own.  A bucket row quantizes
    with the largest value it holds, so a leaf that an axis does not
    split, packed beside another's shards, would be rounded otherwise on
    each rank of that axis, and the ranks' copies of it would part; in a
    class of its own every such rank packs and reduces it alike."""
    classes: dict = {}
    for k, s in enumerate(sflat):
        classes.setdefault((s.data is None, s.model is None), []).append(k)
    return list(classes.values())


def _mesh_step(cfg, options, mesh):
    """The step over a mesh's ``(data, model)`` ranks, and its ``pod``
    axis above them (module docstring)."""
    if mesh.tp_size > 1:
        transformer.check_tp_train(cfg, mesh.tp_size,
                                   options.sequence_parallel)
    specs, tree = mesh_layout(cfg, mesh)
    pods = _axis(mesh)
    Dh, Mh = (len(tree.held[a]) for a in ("data", "model"))
    compressed = options.dp_method != "stock"

    def step(state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % pods.n:
            raise ValueError(f"global batch of {rows} rows does not split "
                             f"over {pods.n} pods")
        # stock on an emulated pod axis: one pass over the whole batch and
        # its global loss, as the one-device path and the reference's
        # GSPMD step (every pod's reduced gradients would be equal)
        whole = mesh.pod is None or (not compressed
                                     and isinstance(pods, PodAxis))
        b = rows if whole else rows // pods.n
        # stock over ranked pods: the global step (_mesh_grads' glob)
        glob = None
        if not whole and not compressed:
            D, n = mesh.dp_size, max(options.microbatches, 1)
            bd, mb = b // D, b // (D * n)
            glob = (pods, _global_counts(batch["labels"], [[
                slice(p * b + d * bd + i * mb, p * b + d * bd + (i + 1) * mb)
                for p in range(pods.n) for d in range(D)]
                for i in range(n)]))
        per_pod, metrics = [], []
        for p in ((0,) if whole else pods.held):
            g, m = _mesh_grads(cfg, options, mesh, specs, tree,
                               state["params"],
                               {k: v[p * b:(p + 1) * b]
                                for k, v in batch.items()}, glob)
            per_pod.append(common.tree_leaves(g))
            metrics.append(m)
            del g
        structure = common.tree_structure(state["params"])
        if whole:
            metrics[0].pop("own")
            return _apply(options, state,
                          common.tree_unflatten(structure, per_pod[0]),
                          metrics[0], specs=specs, tree=tree)
        # each (data, model) rank reduces its own shards over pod: its own
        # buckets, its own err (a replicated leaf's copy is reduced by
        # every rank that holds it, as each rank process does), a class
        # of leaves at a time (reduction_classes)
        sflat = common.tree_leaves(specs)
        stacked = [torch.stack([leaves[k] for leaves in per_pod])
                   for k in range(len(sflat))]
        del per_pod
        eflat = common.tree_leaves(state["err"]) if compressed else None
        reduced = {}
        for d in range(Dh):
            for m in range(Mh):
                at = [(min(d, g.shape[1] - 1), min(m, g.shape[2] - 1))
                      for g in stacked]
                red, res = [None] * len(sflat), [None] * len(sflat)
                for ks in reduction_classes(sflat):
                    r, e = collectives.reduce_gradients(
                        {f"{k:06d}": stacked[k][:, at[k][0], at[k][1]]
                         for k in ks},
                        pods, options.dp_method,
                        {f"{k:06d}": eflat[k][:, at[k][0], at[k][1]]
                         for k in ks} if compressed else None,
                        bucketed=options.dp_bucketed,
                        bucket_bytes=options.dp_bucket_bytes,
                        overlap=options.dp_overlap)
                    errs = common.tree_leaves(e) if compressed \
                        else [None] * len(ks)
                    for k, rk, ek in zip(ks, common.tree_leaves(r), errs):
                        red[k], res[k] = rk, ek
                    del r, e, errs
                reduced[d, m] = (at, red, res)
                del red, res
        del stacked
        gflat = [torch.empty_like(x)
                 for x in common.tree_leaves(state["params"])]
        for (at, red, res) in reduced.values():
            for k, (i, j) in enumerate(at):
                gflat[k][i, j] = red[k][0]
                if compressed:
                    eflat[k][:, i, j] = res[k].to(torch.bfloat16)
        del reduced
        pod_losses = pods.all_gather(torch.stack([m.pop("own")
                                                  for m in metrics]))[0]
        if glob is None:
            met = dict(metrics[0], loss=pod_losses[0])
        else:
            met = {"loss": pods.psum(torch.stack([m["loss"]
                                                  for m in metrics]))[0]}
            lb_z = pods.pmean(torch.stack([torch.stack([
                torch.as_tensor(m[k], device=pod_losses.device)
                for k in ("lb_loss", "z_loss")]) for m in metrics]))[0]
            met.update(lb_loss=lb_z[0], z_loss=lb_z[1])
        return _apply(options, state,
                      common.tree_unflatten(structure, gflat),
                      dict(met, loss_per_pod=pod_losses), specs=specs,
                      tree=tree)

    return step


class MeshCheckpoint:
    """What ``checkpoint/manager.CheckpointManager(layout=)`` needs to
    save a mesh's train state as full arrays and restore each rank's
    shards: the layout of the one-device state, so that a mesh run resumes
    a one-device checkpoint and the reverse (the reference restores with
    shardings).  ``err`` is saved as every pod's full tree, ``(P,
    *shape)``.  Over rank processes every rank gathers; the mesh's lead
    process writes (``writes``)."""

    def __init__(self, cfg: ArchConfig, mesh):
        self.mesh = mesh
        self.specs, self.tree = mesh_layout(cfg, mesh)
        self.pods = _axis(mesh)
        self.writes = mesh.is_lead

    def _stat_specs(self, opt_state):
        """The specs of the optimizer state's leaves: AdamW's moments are
        the parameters'; Adafactor's row and column statistics drop the
        dim they reduce."""
        from repro_torch.parallel.mesh_tree import LeafSpec
        from repro_torch.train.optimizer import _factored

        def vr(s):
            if not _factored(s.shape):
                return s
            n = len(s.shape)
            keep = {a: d for a in ("data", "model")
                    if (d := s.split(a)) is not None and d < n - 1}
            return LeafSpec(s.shape[:-1], keep.get("data"), keep.get("model"))

        def vc(s):
            if not _factored(s.shape):
                return LeafSpec((1,))
            n = len(s.shape)
            move = {n - 1: n - 2}
            keep = {a: move.get(d, d) for a in ("data", "model")
                    if (d := s.split(a)) is not None and d != n - 2}
            # the column statistics keep the last dim: a fused leaf's
            # parts with it
            return LeafSpec(s.shape[:-2] + s.shape[-1:], keep.get("data"),
                            keep.get("model"),
                            s.parts if keep.get("model") is not None else 1)
        out = {}
        for key in opt_state:
            if key == "count":
                continue
            fn = {"vr": vr, "vc": vc}.get(key, lambda s: s)
            out[key] = common.tree_map(fn, self.specs)
        return out

    def to_full(self, state):
        """The state with every sharded leaf gathered to its full shape
        (a collective over rank processes)."""
        g = self.tree.gather
        out = {"params": common.tree_map(g, state["params"], self.specs),
               "step": state["step"]}
        stats = self._stat_specs(state["opt"])
        out["opt"] = {k: (v if k == "count" else
                          common.tree_map(g, v, stats[k]))
                      for k, v in state["opt"].items()}
        if "err" in state:
            def err(e, s):
                rows = torch.stack([g(e[j], s) for j in range(e.shape[0])])
                if isinstance(self.pods, DistPodAxis):
                    rows = self.pods.all_gather(rows)[0]
                return rows
            out["err"] = common.tree_map(err, state["err"], self.specs)
        return out

    def full_like(self, state):
        """``state``'s tree with each leaf at its saved (full) shape, on
        the meta device."""
        def meta(x, s, lead=()):
            return torch.empty(lead + tuple(s.shape), dtype=x.dtype,
                               device="meta")
        out = {"params": common.tree_map(meta, state["params"], self.specs),
               "step": state["step"]}
        stats = self._stat_specs(state["opt"])
        out["opt"] = {k: (v if k == "count" else
                          common.tree_map(meta, v, stats[k]))
                      for k, v in state["opt"].items()}
        if "err" in state:
            out["err"] = common.tree_map(
                lambda e, s: meta(e, s, (self.pods.n,)), state["err"],
                self.specs)
        return out

    def from_full(self, full, like, device=None):
        """Each held rank's shards of the restored full ``state``, at
        ``like``'s shapes and dtypes, on ``device`` (default: ``like``'s
        leaves' own)."""
        def dev(lk):
            return lk.device if device is None else device

        def shard(x, s, lk):
            return self.tree.shard(x.to(dev(lk)), s).expand(
                lk.shape).contiguous()
        out = {"params": common.tree_map(shard, full["params"], self.specs,
                                         like["params"]),
               "step": full["step"].to(dev(like["step"]))}
        stats = self._stat_specs(like["opt"])
        out["opt"] = {k: (full["opt"][k].to(dev(like["opt"][k]))
                          if k == "count" else
                          common.tree_map(shard, full["opt"][k], stats[k],
                                          like["opt"][k]))
                      for k in like["opt"]}
        if "err" in like:
            def err(x, s, lk):
                return torch.stack([shard(x[p], s, lk[j])
                                    for j, p in enumerate(self.pods.held)])
            out["err"] = common.tree_map(err, full["err"], self.specs,
                                         like["err"])
        return out
