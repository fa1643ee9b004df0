"""Optimizers: AdamW and Adafactor, configurable state dtype.

Counterpart of ``repro/train/optimizer.py``, with the same arithmetic
leaf by leaf.  State is a plain dict tree mirroring the parameters.  Where
the reference returns new parameters and a new state, ``apply_updates``
here writes them into the given tensors **in place** (under ``no_grad``):
at full width that keeps one copy of the parameters and of ``m`` / ``v``
on the card instead of two, and the caller's references stay valid.
AdamW's update is elementwise, so a leaf of more than ``SLICE`` elements
is updated a slice at a time (the same operations on every element): its
f32 temporaries take a slice's memory, not eight copies of the leaf in
f32 (8.6 GB for one 268M-element leaf of OLMo-1B, more than four ranks of
a model that size leave free on one card).

**On a mesh** (``tree=`` a ``parallel/mesh_tree.MeshTree``, ``specs=`` a
``LeafSpec`` a leaf) every leaf is a rank's shard, leading with its rank
dims ``(Dl, Ml)``.  AdamW runs on each shard as it is.  The gradient norm
is the global one: each rank sums the squares of its shards, a leaf no
axis splits counted by one rank only (``MeshTree.counts``), and the sums
are reduced over ``data`` and ``model``.  Adafactor decides whether to
factor by a leaf's **global** shape, and its row and column means and
the RMS of its relative-update clip are sums over the local dims reduced
over the axis that splits the dim, divided by the global size.  One
device's state is updated as the mesh of one rank, through views of its
leaves leading with ``(1, 1)``: one update a leaf and one norm for both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel.mesh_tree import LEAD, LeafSpec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (f32, on step's
    device)."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def init_state(cfg: OptConfig, params, specs=None) -> dict:
    """``specs`` (a ``LeafSpec`` a leaf): ``params`` are mesh shards
    leading with their rank dims (module docstring), and Adafactor's
    statistics lead with the same dims."""
    dt = _DTYPES[cfg.state_dtype]
    dev = tree_leaves(params)[0].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adamw":
        zeros = lambda p, *_: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}
    if cfg.name == "adafactor":
        def shapes(p, spec):
            lead = tuple(p.shape[:LEAD]) if spec is not None else ()
            local = tuple(p.shape[len(lead):])
            full = spec.shape if spec is not None else local
            if _factored(full):
                return lead + local[:-1], lead + local[:-2] + local[-1:]
            return lead + local, lead + (1,)

        def vrow(p, spec=None):
            return torch.zeros(shapes(p, spec)[0], dtype=dt, device=p.device)

        def vcol(p, spec=None):
            return torch.zeros(shapes(p, spec)[1], dtype=dt, device=p.device)
        rest = (specs,) if specs is not None else ()
        return {"vr": tree_map(vrow, params, *rest),
                "vc": tree_map(vcol, params, *rest), "count": count}
    raise ValueError(cfg.name)


SLICE = 1 << 25     # elements of a leaf AdamW updates at a time


def _adamw_leaf(cfg, lr, c, p, g, m, v, scale, spec):
    """One AdamW step of leaf ``p`` in place, a slice of at most SLICE
    elements at a time; ``g`` is scaled by the clip factor ``scale``
    (``spec``: the leaf's, whose global rank decides the decay)."""
    # decoupled weight decay on matrices only
    decay = len(spec.shape) >= 2
    parts = [(p, g, m, v)]
    if p.numel() > SLICE and all(t.is_contiguous() for t in (p, m, v)):
        flat = [t.reshape(-1) for t in (p, g, m, v)]   # views of p, m, v
        parts = [tuple(t[lo:lo + SLICE] for t in flat)
                 for lo in range(0, p.numel(), SLICE)]
    for ps, gs, ms, vs in parts:
        gs = gs.float() * scale
        mf = ms.float() * cfg.b1 + (1 - cfg.b1) * gs
        vf = vs.float() * cfg.b2 + (1 - cfg.b2) * gs * gs
        mhat = mf / (1 - cfg.b1 ** c)
        vhat = vf / (1 - cfg.b2 ** c)
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            upd = upd + cfg.weight_decay * ps.float()
        ps.copy_(ps.float() - lr * upd)
        ms.copy_(mf)
        vs.copy_(vf)


def _adafactor_leaf(cfg, lr, c, p, g, vr, vc, spec, tree):
    """One Adafactor step of the shard ``p (Dl, Ml, *local)`` of a leaf of
    global shape ``spec.shape``, in place: every mean over a global dim is
    a local sum, reduced over the axis that splits that dim.  A statistic
    an axis no longer splits is equal on the ranks that hold it."""
    full = spec.shape
    nd = len(full)

    def mean(x, dim):
        """Mean of ``x`` over global dim ``dim`` (local dim ``LEAD +
        dim`` of ``x``), keeping it as a dim of 1."""
        s = x.sum(dim=LEAD + dim, keepdim=True)
        return tree.psum(s, [a for a in ("data", "model")
                             if spec.split(a) == dim]) / full[dim]

    g = g.float()
    g2 = g * g + 1e-30
    d = 1 - cfg.b2
    if _factored(full):
        vrf = vr.float() * cfg.b2 + d * mean(g2, nd - 1).squeeze(-1)
        vcf = vc.float() * cfg.b2 + d * mean(g2, nd - 2).squeeze(-2)
        rmean = mean(vrf.unsqueeze(-1), nd - 2).squeeze(-1)  # over dim -2
        denom = torch.sqrt(vrf[..., None] * vcf[..., None, :]
                           / torch.clamp_min(rmean, 1e-30)[..., None])
    else:
        vrf = vr.float() * cfg.b2 + d * g2
        vcf = vc.float()
        denom = torch.sqrt(vrf)
    upd = g / torch.clamp_min(denom, 1e-30)
    sq = (upd * upd).sum(dim=tuple(range(LEAD, upd.dim())))
    split = [a for a in ("data", "model") if spec.split(a) is not None]
    rms = torch.sqrt(tree.psum(sq, split) / math.prod(full) + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0).reshape(
        tuple(rms.shape) + (1,) * (upd.dim() - LEAD))
    if nd >= 2:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    vr.copy_(vrf)
    vc.copy_(vcf)


def global_norm(grads, specs, tree) -> torch.Tensor:
    """The global norm of a mesh's gradient shards (module docstring):
    each held rank's squares summed shard by shard, at the shapes a rank
    process sums, then reduced over ``data`` and then ``model``."""
    Dh, Mh = (len(tree.held[a]) for a in ("data", "model"))
    flat = list(zip(tree_leaves(grads), tree_leaves(specs)))
    dev = flat[0][0].device
    grid = torch.zeros((Dh, Mh), dtype=torch.float32, device=dev)
    for d in range(Dh):
        for m in range(Mh):
            parts = [torch.sum(torch.square(g[min(d, g.shape[0] - 1),
                                              min(m, g.shape[1] - 1)].float()))
                     for g, spec in flat
                     if tree.counts(spec)
                     and (d == 0 or spec.data is not None)
                     and (m == 0 or spec.model is not None)]
            if parts:
                grid[d, m] = torch.sum(torch.stack(parts))
    return torch.sqrt(tree.psum(grid, ("data", "model"))[0, 0])


class _OneDevice:
    """A one-device state's layout as a mesh of one rank: no axis splits
    a leaf, and a sum over an axis is the value itself."""
    held = {"data": (0,), "model": (0,)}

    @staticmethod
    def psum(x, axes):
        return x

    @staticmethod
    def counts(spec):
        return True


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state, specs=None,
                  tree=None) -> dict:
    """Clip by the global norm, then one AdamW or Adafactor step, written
    into ``params`` and ``state`` in place.  Returns the metrics
    ``{"grad_norm", "lr"}``.  ``specs`` and ``tree``: mesh shards (module
    docstring); without them the leaves are one device's, updated through
    ``(1, 1)``-leading views as a mesh of one rank."""
    stats = [k for k in ("m", "v", "vr", "vc") if k in state]
    if tree is None:
        def lead(t):
            return t[None, None]
        params, grads = tree_map(lead, params), tree_map(lead, grads)
        state = dict(state, **{k: tree_map(lead, state[k]) for k in stats})
        specs = tree_map(lambda p: LeafSpec(tuple(p.shape[LEAD:])), params)
        tree = _OneDevice
    gnorm = global_norm(grads, specs, tree)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                         max=1.0) if cfg.grad_clip
             else torch.ones((), device=gnorm.device))
    state["count"] += 1
    c = state["count"].float()
    lr = schedule(cfg, state["count"])
    if cfg.name == "adamw":
        tree_map(lambda p, g, m, v, spec: _adamw_leaf(
            cfg, lr, c, p, g, m, v, scale, spec),
            params, grads, state["m"], state["v"], specs)
    else:
        tree_map(lambda p, g, vr, vc, spec: _adafactor_leaf(
            cfg, lr, c, p, g.float() * scale, vr, vc, spec, tree),
            params, grads, state["vr"], state["vc"], specs)
    return {"grad_norm": gnorm, "lr": lr}
