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
(:func:`moe_parts`: expert parallelism, ``E % n``; in training under
sequence parallelism :func:`moe_parts_sp`, the router on each rank's
slice of the sequence).  The group size follows the ``data`` size only,
as the reference's (``repro/models/moe.py``: ``dp`` is the ``batch``
axes' size), so a serving mesh groups the tokens as one device does.
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


def _geometry(cfg: ArchConfig, n_tokens: int) -> tuple:
    """``(G, Ng, C)``: the groups of ``n_tokens``, their size and each
    expert's slots in a group."""
    Ng = _group_size(max(n_tokens, 1))
    C = max(1, int(Ng * cfg.experts_per_token / cfg.num_experts
                   * cfg.capacity_factor))
    return n_tokens // Ng, Ng, C


def _choose(cfg: ArchConfig, logits: torch.Tensor) -> tuple:
    """``(probs, gates, idx)`` of f32 router logits, token by token."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _slots(cfg: ArchConfig, idx: torch.Tensor) -> tuple:
    """``(emask, slot)`` of the expert ids ``idx (G, Ng, K)``: tokens
    ordered within a group, each assignment's slot counted per expert."""
    G, Ng, K = idx.shape
    E = cfg.num_experts
    emask = _one_hot(idx, E, torch.int32)                        # (G,Ng,K,E)
    flat = emask.reshape(G, Ng * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, Ng, K, E)
    return emask, (pos * emask).sum(-1)                          # (G,Ng,K)


def routing(cfg: ArchConfig, p: dict, x: torch.Tensor) -> dict:
    """The router's decisions for ``x (B, S, D)``: group geometry, f32
    logits and probabilities, top-k gates and expert ids, and each
    assignment's slot (``>= C`` where it is dropped)."""
    B, S, D = x.shape
    G, Ng, C = _geometry(cfg, B * S)
    xg = x.reshape(G, Ng, D)
    logits = xg.float() @ p["router"]["kernel"].float()          # (G,Ng,E)
    probs, gates, idx = _choose(cfg, logits)                     # (G,Ng,K)
    emask, slot = _slots(cfg, idx)
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
    return _aux_of(cfg, r["emask"], r["probs"].mean(dim=(0, 1)),
                   torch.mean(torch.square(torch.logsumexp(r["logits"],
                                                           dim=-1))))


def _aux_of(cfg: ArchConfig, emask, router_mean, z_loss) -> dict:
    """The aux losses of the assignments ``emask (G, Ng, K, E)``, the mean
    router probability and the z-loss."""
    density = emask.float().sum(2).mean(dim=(0, 1))              # (E,)
    lb_loss = load_balance(cfg, density, router_mean)
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


def moe_parts_sp(cfg: ArchConfig, ranks: list, hn, hs, axis):
    """:func:`moe_parts` under sequence parallelism: each held rank's
    partial output on its copy ``hs[j]`` of the gathered sequence, and
    the aux losses; ``hn (n, B, L, D)`` the ranks' slices of the same
    normed input.

    The router runs on each rank's own slice, on the rank's copy of its
    kernel (every replicated leaf enters through ``copy`` under sequence
    parallelism): logits, softmax and top-k are token by token.  The
    gates and the expert ids (as f32, exact) are then gathered along the
    sequence (``gather_seq``) for the slots, which a cumulative sum over
    each of the reference's groups assigns in token order — the groups
    follow the batch axes only, so the routing is the one-device
    function's — and each rank runs its ``E / n`` experts on the gathered
    sequence.  The aux losses' means come from per-slice sums (the
    router's probabilities and the squared log-sum-exps) summed by one
    ``reduce``; the density has no gradient and comes from the gathered
    ids.  So every gradient of the routing enters once: a rank's router
    and its slice see its own positions only, ``gather_seq``'s backward
    sums the ranks' partial gradients of the gates (each combine weighs
    its own experts), and ``reduce``'s hands each rank the aux losses'
    gradient of its own sums.  (Routing the gathered sequence on every
    rank, as :func:`moe_parts` routes the replicated one, would give each
    rank process the whole gradient of the router and of the aux losses,
    which the router's ``copy`` and the sequence's ``reduce_scatter``
    would then sum ``n`` times; the emulated axis, routing once, would
    hide it.)"""
    _, B, _, D = hn.shape
    S = hs.shape[2]
    E, K = cfg.num_experts, cfg.experts_per_token
    picks, sums = [], []
    for j, p in enumerate(ranks):
        logits = hn[j].float() @ p["router"]["kernel"].float()   # (B,L,E)
        probs, gates, idx = _choose(cfg, logits)
        picks.append(torch.cat([gates, idx.to(gates.dtype)], dim=-1))
        sums.append(torch.cat([probs.sum(dim=(0, 1)), torch.square(
            torch.logsumexp(logits, dim=-1)).sum()[None]]))
    picked = axis.gather_seq(torch.stack(picks))                 # (n,B,S,2K)
    total = axis.reduce(torch.stack(sums)) / (B * S)             # (E + 1,)
    G, Ng, C = _geometry(cfg, B * S)
    emask, slot = _slots(cfg, picked[0][..., K:].detach().long()
                         .reshape(G, Ng, K))
    r = {"C": C, "emask": emask, "slot": slot}
    parts = []
    for j, (rank, p) in enumerate(zip(axis.held, ranks)):
        El = p["wi"]["kernel"].shape[0]
        disp, comb = _dispatch(r, hs[j].dtype,
                               slice(rank * El, (rank + 1) * El),
                               picked[j][..., :K].reshape(G, Ng, K))
        y = _experts(cfg, p, hs[j].reshape(G, Ng, D),
                     disp, comb).reshape(B, S, D)
        if "shared_mlp" in p:       # its wo bias: the caller's, a slice
            lp, _ = mlp.local_params(p["shared_mlp"], rank, axis.n)
            y = y + mlp.mlp_apply(cfg, lp, hs[j])
        parts.append(y)
    return parts, _aux_of(cfg, emask, total[:E], total[E])
