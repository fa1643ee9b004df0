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
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map

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


def init_state(cfg: OptConfig, params) -> dict:
    dt = _DTYPES[cfg.state_dtype]
    dev = tree_leaves(params)[0].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adamw":
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}
    if cfg.name == "adafactor":
        def vrow(p):
            shape = p.shape[:-1] if _factored(p.shape) else p.shape
            return torch.zeros(shape, dtype=dt, device=p.device)

        def vcol(p):
            shape = (p.shape[:-2] + p.shape[-1:] if _factored(p.shape)
                     else (1,))
            return torch.zeros(shape, dtype=dt, device=p.device)
        return {"vr": tree_map(vrow, params), "vc": tree_map(vcol, params),
                "count": count}
    raise ValueError(cfg.name)


SLICE = 1 << 25     # elements of a leaf AdamW updates at a time


def _adamw_leaf(cfg, lr, c, p, g, m, v, scale):
    """One AdamW step of leaf ``p`` in place, a slice of at most SLICE
    elements at a time; ``g`` is scaled by the clip factor ``scale``."""
    decay = p.dim() >= 2      # decoupled weight decay on matrices only
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


def _adafactor_leaf(cfg, lr, c, p, g, vr, vc):
    g = g.float()
    g2 = g * g + 1e-30
    d = 1 - cfg.b2
    if _factored(p.shape):
        vrf = vr.float() * cfg.b2 + d * torch.mean(g2, dim=-1)
        vcf = vc.float() * cfg.b2 + d * torch.mean(g2, dim=-2)
        denom = torch.sqrt(vrf[..., None] * vcf[..., None, :]
                           / torch.clamp_min(torch.mean(vrf, -1, keepdim=True),
                                             1e-30)[..., None])
    else:
        vrf = vr.float() * cfg.b2 + d * g2
        vcf = vc.float()
        denom = torch.sqrt(vrf)
    upd = g / torch.clamp_min(denom, 1e-30)
    # relative update clipping (Adafactor's d=1.0 rule)
    rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
    upd = upd / torch.clamp_min(rms, 1.0)
    if p.dim() >= 2:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    vr.copy_(vrf)
    vc.copy_(vcf)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state) -> dict:
    """Clip by the global norm, then one AdamW or Adafactor step, written
    into ``params`` and ``state`` in place.  Returns the metrics
    ``{"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                         max=1.0) if cfg.grad_clip
             else torch.ones((), device=gnorm.device))
    state["count"] += 1
    c = state["count"].float()
    lr = schedule(cfg, state["count"])
    if cfg.name == "adamw":
        tree_map(lambda p, g, m, v: _adamw_leaf(cfg, lr, c, p, g, m, v,
                                                 scale),
                  params, grads, state["m"], state["v"])
    else:
        tree_map(lambda p, g, vr, vc: _adafactor_leaf(
            cfg, lr, c, p, g.float() * scale, vr, vc),
            params, grads, state["vr"], state["vc"])
    return {"grad_norm": gnorm, "lr": lr}
