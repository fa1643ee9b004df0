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
    error feedback for the compressed methods).

What each pod holds follows the reference's shard_map, measured: the
reduced gradients, and so the parameters and optimizer state, are equal on
every pod, so on an emulated axis ONE copy is kept (pod 0's; under
``int8_pairwise`` each pod sums the ring in its own order, and the pods'
sums differ in the last bits, in the reference too); the error-feedback
residuals ``err`` and the losses differ per pod, so one copy a held pod is
kept (``err`` as ``(L, *shape)`` bf16, ``L`` = ``n`` emulated, 1 a rank
process).  Over a ``DistPodAxis`` each rank keeps its own reduced
gradients, parameters and optimizer state, as each device of the
reference does.  ``metrics["loss_per_pod"]`` holds every pod's loss
(gathered over the axis) and ``metrics["loss"]`` is pod 0's, as reading
the reference's replicated-looking output gives pod 0's value.

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
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import common, registry
from repro_torch.parallel import collectives
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
    sequence_parallel: bool = False  # Megatron-SP over a 'model' axis: a
    #                                later slice (ROADMAP Queue 1 item 9c)
    dp_bucketed: Optional[bool] = None   # fuse grads into bucket buffers;
    #                                None = auto: on for chunked methods,
    #                                off for shape-preserving int8_pairwise
    dp_bucket_bytes: int = collectives.DEFAULT_BUCKET_BYTES
    dp_overlap: Optional[bool] = None    # bucket-chain schedule: True
    #                                pipelines, False serializes, None =
    #                                policy auto (parallel/overlap.py)
    opt: opt.OptConfig = field(default_factory=opt.OptConfig)


def check_trainable(options: TrainOptions) -> None:
    if options.sequence_parallel:
        raise NotImplementedError(
            "sequence parallelism needs a 'model' axis in training: mesh "
            "training is a later slice of the port (ROADMAP Queue 1 item "
            "9c)")
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


def make_loss_fn(cfg: ArchConfig, options: TrainOptions):
    def loss_fn(params, batch):
        with runtime.use_policy(attention_impl="chunked",
                                rwkv_impl="torch"):
            logits, aux = registry.forward(cfg, params, batch,
                                           remat=options.remat)
        loss = xent_loss(cfg, logits, batch["labels"])
        total = loss + LB_WEIGHT * aux["lb_loss"] + Z_WEIGHT * aux["z_loss"]
        return total, {"loss": loss, "lb_loss": aux["lb_loss"],
                       "z_loss": aux["z_loss"]}
    return loss_fn


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def _axis(pods: Union[int, Pods]) -> Pods:
    return pods if isinstance(pods, (PodAxis, DistPodAxis)) \
        else PodAxis(int(pods))


def make_train_state(cfg: ArchConfig, options: TrainOptions,
                     gen: torch.Generator, pods: Union[int, Pods] = 1):
    """Parameters drawn from ``gen`` on its device, optimizer state, step
    counter, and — for a compressed ``dp_method`` — one bf16 error-feedback
    tree a held pod, stacked ``(L, *shape)``.  Every rank of a
    ``DistPodAxis`` draws the same parameters from a generator seeded
    alike."""
    check_trainable(options)
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

def _grads_and_metrics(cfg, options, params, batch):
    """Gradients of the loss over ``batch`` (microbatch-accumulated in f32
    when ``options.microbatches > 1``) and its metrics, detached."""
    loss_fn = make_loss_fn(cfg, options)
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
        total, metrics = loss_fn(params, mb)
        for a, g in zip(acc, torch.autograd.grad(total, leaves)):
            a += g.float() / n
        metrics = {k: v.detach() / n for k, v in metrics.items()}
        met = metrics if met is None else {k: met[k] + metrics[k]
                                           for k in met}
    return common.tree_unflatten(structure, acc), met


def _apply(options, state, grads, metrics, errors=None):
    om = opt.apply_updates(options.opt, state["params"], grads, state["opt"])
    state["step"] += 1
    if errors is not None:
        state["err"] = errors
    return state, dict(metrics, **om)


def _per_pod(cfg, options, params, batch, pods: Union[int, Pods]) -> dict:
    """Each held pod's gradients on its rows of the global ``batch``,
    stacked ``(L, *shape)`` (one pod's autograd output alive at a time),
    and each held pod's metrics."""
    pods = _axis(pods)
    n, held = pods.n, pods.held
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"global batch of {rows} rows does not split over "
                         f"{n} pods")
    b = rows // n
    stacked, metrics = None, []
    for j, i in enumerate(held):
        grads, m = _grads_and_metrics(
            cfg, options, params, {k: v[i * b:(i + 1) * b]
                                   for k, v in batch.items()})
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


def make_train_step(cfg: ArchConfig, shape: Optional[ShapeConfig],
                    pods: Union[int, Pods] = 1,
                    options: TrainOptions = TrainOptions()):
    """Returns ``step_fn(state, batch) -> (state, metrics)`` (``shape`` is
    kept for the reference's signature; nothing here depends on it).
    ``batch`` holds the global batch's ``tokens`` and ``labels`` ``(B, S)``
    on the state's device (every rank of a ``DistPodAxis`` is given the
    same batch and takes its rows)."""
    check_trainable(options)
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

    def step(state, batch):
        per_pod = _per_pod(cfg, options, state["params"], batch, pods)
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
        held_losses = torch.stack([m["loss"] for m in per_pod["metrics"]])
        pod_losses = pods.all_gather(held_losses)[0]
        metrics = dict(per_pod["metrics"][0], loss=pod_losses[0],
                       loss_per_pod=pod_losses)
        return _apply(options, state, grads, metrics, errors)

    return step
