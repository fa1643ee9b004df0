"""Top-k MoE FFN with grouped one-hot dispatch and combine.

Counterpart of ``repro/models/moe.py`` on one device (``dp = 1``).  Tokens
are cut into ``G`` groups of ``Ng`` (the largest power of two up to 1024
that divides the token count); in each group every expert has ``C =
max(1, int(Ng * K / E * capacity_factor))`` slots, filled in token order
from a cumulative sum over the one-hot expert choices.  An assignment past
its expert's capacity gets no slot and is dropped, as in the reference —
at a decode step of 8 or 16 slots that gives ``C = 1`` for 64 experts
top-6, so idle slots take capacity too; the port keeps that.  Dispatch and
combine are ``(G, Ng, E, C)`` one-hots, so every shape is static.

The router runs in f32 (its kernel is an f32 leaf in a bf16 model; the
activations are cast up), top-k by ``torch.topk``; the aux losses
(load balance, router z-loss) are returned in f32 for the train step,
with the load balance's two per-expert means (``lb_means``, a list a
layer) that a data-parallel step reduces over its ``data`` axis.

Over a ``model`` axis the experts split by whole experts
(:func:`moe_parts`: expert parallelism, ``E % n``).  The group size
follows the ``data`` size only, as the reference's
(``repro/models/moe.py``: ``dp`` is the ``batch`` axes' size), so a
serving mesh groups the tokens as one device does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, mlp


def moe_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = common.dtype_of(cfg)

    def expert_kernels(in_dim, out_dim):
        return {"kernel": common._normal(gen, (E, in_dim, out_dim),
                                         1.0 / math.sqrt(in_dim), dt)}

    p = {
        "router": common.dense_init(gen, D, E, torch.float32),
        "wi": expert_kernels(D, Fd),
        "wo": expert_kernels(Fd, D),
    }
    if cfg.act == "swiglu":
        p["wg"] = expert_kernels(D, Fd)
    if cfg.shared_experts:
        p["shared_mlp"] = mlp.mlp_init(gen, cfg,
                                       d_ff=cfg.d_ff * cfg.shared_experts)
    return p


def _group_size(n_tokens_per_shard: int) -> int:
    g = 1
    while g < 1024 and n_tokens_per_shard % (g * 2) == 0:
        g *= 2
    return g


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def routing(cfg: ArchConfig, p: dict, x: torch.Tensor) -> dict:
    """The router's decisions for ``x (B, S, D)``: group geometry, f32
    logits and probabilities, top-k gates and expert ids, and each
    assignment's slot (``>= C`` where it is dropped)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * S
    Ng = _group_size(max(N, 1))
    G = N // Ng
    C = max(1, int(Ng * K / E * cfg.capacity_factor))
    xg = x.reshape(G, Ng, D)
    logits = xg.float() @ p["router"]["kernel"].float()          # (G,Ng,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)                    # (G,Ng,K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # slot assignment: order tokens within a group, count per expert
    emask = _one_hot(idx, E, torch.int32)                        # (G,Ng,K,E)
    flat = emask.reshape(G, Ng * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, Ng, K, E)
    slot = (pos * emask).sum(-1)                                 # (G,Ng,K)
    return {"G": G, "Ng": Ng, "C": C, "xg": xg, "logits": logits,
            "probs": probs, "gates": gates, "idx": idx, "emask": emask,
            "slot": slot}


def load_balance(cfg: ArchConfig, density: torch.Tensor,
                 router_mean: torch.Tensor) -> torch.Tensor:
    """The load-balance loss of the per-expert token density and mean
    router probability, ``(E,)`` each."""
    return cfg.num_experts * torch.sum(density / cfg.experts_per_token
                                       * router_mean)


def _dispatch(r: dict, dtype, experts=slice(None), gates=None):
    """The ``(G, Ng, E, C)`` dispatch and combine one-hots of routing
    ``r``, on the columns of ``experts``; ``gates`` (default ``r``'s) are
    the combine's weights."""
    slot_oh = _one_hot(r["slot"], r["C"], dtype)     # >= C -> all-zero row
    emask = r["emask"][..., experts]
    disp = torch.einsum("gnke,gnkc->gnec", emask.to(dtype), slot_oh)
    comb = torch.einsum("gnke,gnkc,gnk->gnec", emask.float(),
                        slot_oh.float(),
                        r["gates"] if gates is None else gates).to(dtype)
    return disp, comb


def _experts(cfg: ArchConfig, p: dict, xg, disp, comb):
    """The experts ``p`` holds (all, or a rank's ``E / n``) on their
    columns of the dispatch: ``(G, Ng, D)``."""
    xe = torch.einsum("gnec,gnd->gecd", disp, xg)                # (G,E,C,D)
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"]["kernel"])
    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                                p["wg"]["kernel"])) * h
    else:
        h = common.act_fn(cfg.act)(h)
    out = torch.einsum("gecf,efd->gecd", h, p["wo"]["kernel"])
    return torch.einsum("gecd,gnec->gnd", out, comb.to(out.dtype))


def _aux(cfg: ArchConfig, r: dict) -> dict:
    """The aux losses (f32) of routing ``r``."""
    density = r["emask"].float().sum(2).mean(dim=(0, 1))         # (E,)
    router_mean = r["probs"].mean(dim=(0, 1))
    lb_loss = load_balance(cfg, density, router_mean)
    z_loss = torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1)))
    # the load balance's two means, for a train step whose batch rows a
    # data axis splits: the loss is the product of the global means
    # (train/step.py reduces them)
    return {"lb_loss": lb_loss, "z_loss": z_loss,
            "lb_means": [(density, router_mean)]}


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (y, aux) with aux = {'lb_loss', 'z_loss',
    'lb_means'} (f32)."""
    B, S, D = x.shape
    r = routing(cfg, p, x)
    disp, comb = _dispatch(r, x.dtype)
    y = _experts(cfg, p, r["xg"], disp, comb).reshape(B, S, D)
    if "shared_mlp" in p:
        y = y + mlp.mlp_apply(cfg, p["shared_mlp"], x)
    return y, _aux(cfg, r)


def moe_parts(cfg: ArchConfig, ranks: list, h, hs, axis):
    """Expert parallelism over a ``model`` axis: each held rank's partial
    output on its copy ``hs[j]`` of the replicated input ``h``, the aux
    losses and the shared MLP's ``wo`` bias (added once, after the sum).

    The router is replicated and routes ``h`` once, outside the
    tensor-parallel region (in f32), so every rank takes the same ``(G,
    Ng, E, C)`` dispatch and drops what the one-device layer drops; each
    rank runs its ``E / n`` experts on its columns of the dispatch, and
    its column/row-parallel share of the shared MLP
    (``mlp.local_params``), summed in the rank.  The caller reduces the
    partial outputs once a layer.

    Training: the gates enter the region through ``axis.copy``, since a
    rank's combine weighs its own experts' columns only, so its gradient
    of the gates is a partial one, summed over the ranks in the backward.
    The aux losses come from the replicated routing, once: over rank
    processes each rank computes the same whole gradient of them, which
    no exchange may sum again (the router entering through ``copy``
    would count it ``n`` times)."""
    B, S, D = h.shape
    r = routing(cfg, ranks[0], h)
    gates = axis.copy(r["gates"])
    parts, bias = [], None
    for j, (rank, p) in enumerate(zip(axis.held, ranks)):
        El = p["wi"]["kernel"].shape[0]
        disp, comb = _dispatch(r, hs[j].dtype,
                               slice(rank * El, (rank + 1) * El), gates[j])
        y = _experts(cfg, p, hs[j].reshape(r["G"], r["Ng"], D),
                     disp, comb).reshape(B, S, D)
        if "shared_mlp" in p:
            lp, bias = mlp.local_params(p["shared_mlp"], rank, axis.n)
            y = y + mlp.mlp_apply(cfg, lp, hs[j])
        parts.append(y)
    return parts, _aux(cfg, r), bias
