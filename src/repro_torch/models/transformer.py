"""Decoder-only LM assembly: dense and SSM (RWKV-6) families.

Counterpart of ``repro/models/transformer.py``.  Parameters keep the
reference's layout — a nested dict whose ``"layers"`` leaves are stacked
over groups of ``cfg.layer_group`` layers — and the reference's scan over
groups is a Python loop over that leading axis (PyTorch runs eagerly;
sharding constraints drop out on one device).  Decode updates the caches
in place: attention writes its K/V rows, an RWKV layer copies its new
recurrent state into the slot cache.  MoE, hybrid, encoder-decoder and
VLM families are later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mlp, rwkv6


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "ssm") or cfg.num_experts \
            or cfg.attn_period:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — the "
            f"port covers the dense transformer and RWKV-6 (ssm) families; "
            f"MoE, hybrid, encoder-decoder and VLM families are later "
            f"slices")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig) -> dict:
    dev = gen.device
    p: dict = {"norm1": common.norm_init(cfg, dev)}
    if cfg.family == "ssm":
        p["rwkv"] = rwkv6.time_mix_init(gen, cfg)
        p["norm2"] = common.norm_init(cfg, dev)
        p["cmlp"] = rwkv6.channel_mix_init(gen, cfg)
        return p
    p["attn"] = attention.attn_init(gen, cfg)
    if not cfg.parallel_block:
        p["norm2"] = common.norm_init(cfg, dev)
    p["mlp"] = mlp.mlp_init(gen, cfg)
    return p


def _group_init(gen, cfg: ArchConfig) -> dict:
    return {f"l{i}": _layer_init(gen, cfg) for i in range(cfg.layer_group)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device`` (the port's
    own initialisation: same distributions as the reference, other
    numbers — tests carry reference weights over with ``bridge``)."""
    check_family(cfg)
    dt = common.dtype_of(cfg)
    p = {
        "embed": common.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "layers": common.stacked_init(gen, cfg.num_groups(),
                                      lambda g: _group_init(g, cfg)),
        "final_norm": common.norm_init(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    return p


# ---------------------------------------------------------------------------
# layer apply (full-sequence and decode variants)
# ---------------------------------------------------------------------------

def _layer_apply(cfg: ArchConfig, p: dict, x, positions, *, cache_len=None):
    """Full-sequence layer.  Returns (x, cache_or_None)."""
    cache = None
    h = common.norm_apply(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        y, st = rwkv6.time_mix_apply(cfg, p["rwkv"], h)
        x = x + y
        h2 = common.norm_apply(cfg, p["norm2"], x)
        y2, st2 = rwkv6.channel_mix_apply(cfg, p["cmlp"], h2)
        if cache_len is not None:
            cache = {"tm": st, "cm": st2}
        return x + y2, cache
    if cache_len is not None:
        y, cache = attention.attn_apply(
            cfg, p["attn"], h, positions=positions, causal=True,
            window=cfg.sliding_window, return_cache=True,
            cache_len=cache_len)
    else:
        y = attention.attn_apply(cfg, p["attn"], h, positions=positions,
                                 causal=True, window=cfg.sliding_window)
    if cfg.parallel_block:
        return x + y + _ffn(cfg, p, h), cache
    x = x + y
    h2 = common.norm_apply(cfg, p["norm2"], x)
    return x + _ffn(cfg, p, h2), cache


def _ffn(cfg, p, h):
    return mlp.mlp_apply(cfg, p["mlp"], h)


def _layer_decode(cfg: ArchConfig, p: dict, x, cache: dict, index):
    """One-token layer step.  Returns (x, cache), the cache updated in
    place."""
    h = common.norm_apply(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        y, st = rwkv6.time_mix_apply(cfg, p["rwkv"], h, state=cache["tm"])
        x = x + y
        h2 = common.norm_apply(cfg, p["norm2"], x)
        y2, st2 = rwkv6.channel_mix_apply(cfg, p["cmlp"], h2,
                                          state=cache["cm"])
        # the cache is a view of the slot-stacked caches, which
        # backbone_decode hands back as they are: write the state into it
        cache["tm"]["shift"].copy_(st["shift"])
        cache["tm"]["wkv"].copy_(st["wkv"])
        cache["cm"].copy_(st2)
        return x + y2, cache
    y, cache = attention.attn_decode(cfg, p["attn"], h, cache, index=index,
                                     window=cfg.sliding_window)
    if cfg.parallel_block:
        return x + y + _ffn(cfg, p, h), cache
    x = x + y
    h2 = common.norm_apply(cfg, p["norm2"], x)
    return x + _ffn(cfg, p, h2), cache


# ---------------------------------------------------------------------------
# backbone: loop over groups
# ---------------------------------------------------------------------------

def _group_apply(cfg: ArchConfig, gp, x, positions):
    for i in range(cfg.layer_group):
        x, _ = _layer_apply(cfg, gp[f"l{i}"], x, positions)
    return x


def apply_backbone(cfg: ArchConfig, layers, x, positions, *, remat=False,
                   cache_len=None):
    """x: (B, S, D) embeddings.  Returns x, or (x, caches) with caches
    stacked over groups when ``cache_len`` is given.

    ``remat`` with ``cfg.remat != "none"`` recomputes each group in the
    backward pass (``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` on the group body).  Both of the
    reference's policies, ``full`` and ``dots_saveable``, recompute the
    whole group here: the values are the same, the memory/time trade
    differs for ``dots_saveable``."""
    if remat and cfg.remat != "none" and cache_len is None:
        from torch.utils.checkpoint import checkpoint

        # the recomputation runs in the backward pass, outside any policy
        # context of the forward (and, on the card, on autograd's own
        # thread): it replays the forward's policy
        pol = dict(runtime.policy())

        def group(gp, x):
            with runtime.use_policy(**pol):
                return _group_apply(cfg, gp, x, positions)

        for g in range(cfg.num_groups()):
            x = checkpoint(group, common.tree_index(layers, g), x,
                           use_reentrant=False)
        return x
    per_group = []
    for g in range(cfg.num_groups()):
        gp = common.tree_index(layers, g)
        caches = {}
        for i in range(cfg.layer_group):
            x, cache = _layer_apply(cfg, gp[f"l{i}"], x, positions,
                                    cache_len=cache_len)
            caches[f"l{i}"] = cache
        per_group.append(caches)
    if cache_len is not None:
        return x, common.tree_stack(per_group)
    return x


def backbone_decode(cfg: ArchConfig, layers, x, caches, index):
    """One-token step through all groups.  caches: stacked over groups,
    updated in place (each group's slice is a view)."""
    for g in range(cfg.num_groups()):
        gp = common.tree_index(layers, g)
        cache_g = common.tree_index(caches, g)
        for i in range(cfg.layer_group):
            x, _ = _layer_decode(cfg, gp[f"l{i}"], x, cache_g[f"l{i}"], index)
    return x, caches


# ---------------------------------------------------------------------------
# public LM API
# ---------------------------------------------------------------------------

def _logits(cfg, params, x):
    """Tied: ``x @ embedding.T`` in the working dtype, then cast to f32."""
    if cfg.tie_embeddings:
        y = x @ params["embed"]["embedding"].T
    else:
        y = common.dense(params["lm_head"], x)
    return y.float()


def _embed(params, tokens):
    return params["embed"]["embedding"][tokens.long()]


def zero_aux(device) -> dict:
    """The auxiliary losses of a family without experts: zero."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero}


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            remat: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) f32, aux {lb_loss, z_loss})."""
    check_family(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = apply_backbone(cfg, params["layers"], x, positions, remat=remat)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), zero_aux(x.device)


def _layer_cache(cfg: ArchConfig, batch: int, cache_len: int, device):
    if cfg.family == "ssm":        # recurrent state: cache_len plays no part
        H, dh = rwkv6._dims(cfg)
        dt = common.dtype_of(cfg)
        return {
            "tm": {"shift": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                        device=device),
                   "wkv": torch.zeros((batch, H, dh, dh),
                                      dtype=torch.float32, device=device)},
            "cm": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                              device=device),
        }
    # a windowed layer's cache is its ring, whatever cache_len is (the
    # reference's "SWA: full ring always")
    return attention.init_cache(cfg, batch, cfg.sliding_window or cache_len,
                                device)


def init_decode_caches(cfg: ArchConfig, batch: int, cache_len: int, device):
    """Stacked (over groups) decode caches for every layer position."""
    check_family(cfg)
    group = {f"l{i}": _layer_cache(cfg, batch, cache_len, device)
             for i in range(cfg.layer_group)}
    G = cfg.num_groups()
    return common.tree_map(
        lambda a: a[None].repeat((G,) + (1,) * a.dim()), group)


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            cache_len: Optional[int] = None):
    """Full forward that also returns decode caches sized ``cache_len``
    (default: exactly the prompt length).  Returns (last-position logits
    (B, 1, V) f32, caches stacked over groups)."""
    check_family(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, caches = apply_backbone(cfg, params["layers"], x, positions,
                               cache_len=cache_len or x.shape[1])
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                caches, index):
    """tokens: (B, 1); index: scalar or (B,) positions.  Returns (logits
    (B, 1, V) f32, caches) — the caches are updated in place."""
    check_family(cfg)
    x = _embed(params, tokens)
    x, caches = backbone_decode(cfg, params["layers"], x, caches, index)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), caches
