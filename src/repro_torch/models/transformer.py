"""Decoder-only LM assembly: dense / MoE / hybrid (Jamba) / SSM (RWKV-6).

Counterpart of ``repro/models/transformer.py``.  Parameters keep the
reference's layout — a nested dict whose ``"layers"`` leaves are stacked
over groups of ``cfg.layer_group`` layers — and the reference's scan over
groups is a Python loop over that leading axis (PyTorch runs eagerly;
sharding constraints drop out on one device).  Heterogeneous interleaves
(Jamba: Mamba layers with one attention layer per ``attn_period``, MoE on
every ``moe_every``-th layer) follow the position ``l`` within a group, as
in the reference, through ``cfg.is_attn_layer(l)`` and
``cfg.is_moe_layer(l)``.  The MoE layers' aux losses are summed over the
layers (group by group, as the reference's scan carries them); a model
without experts returns zero ones.

Decode updates the caches in place: attention writes its K/V rows, an
RWKV or Mamba layer copies its new recurrent state (WKV state and token
shift; SSM state and conv ring) into the slot cache.

**Tensor parallelism** (``axis=``, a ``model`` axis of
``parallel/model_axis.py``; every family serves and trains over one,
:func:`loss_tp`) is Megatron's, with the
split ``parallel/sharding.PARAM_RULES`` gives: ``params`` is then the
per-rank tree of ``sharding.shard_params`` (held ranks on dim 0), and so
are the caches.  ``q`` / ``k`` / ``v`` and ``wi`` / ``wg`` are
column-parallel, so each rank holds ``H / n`` query heads and ``Kv / n``
kv heads (one, where there are fewer kv heads than ranks); ``o`` and
``wo`` are row-parallel, summed over the axis (``psum``), their biases
added once after the sum.  A ``parallel_block`` layer sums its two
partial outputs in the rank and reduces once.  The embedding is
vocab-parallel (a masked lookup, then ``psum``) and so are the logits
(then ``all_gather`` along the vocabulary); a tied embedding's one shard
serves both.  Norms are replicated.  A decode tick of ``L`` sequential
layers thus makes ``2 L + 1`` all-reduces and one all-gather
(``L + 1`` and one for a parallel block; no embedding reduction or
logits gather where the axis does not divide the vocabulary).  Each
rank's share runs in turn through the single-device code, at a local
config of its heads (``attention.local_params``).  Without ``axis`` the
code path is the single-device one, unchanged.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mamba, mlp, moe, rwkv6


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, l: int) -> dict:
    """One layer's params; ``l`` is the position within a group."""
    dev = gen.device
    p: dict = {"norm1": common.norm_init(cfg, dev)}
    if cfg.family == "ssm":
        p["rwkv"] = rwkv6.time_mix_init(gen, cfg)
        p["norm2"] = common.norm_init(cfg, dev)
        p["cmlp"] = rwkv6.channel_mix_init(gen, cfg)
        return p
    if cfg.is_attn_layer(l):
        p["attn"] = attention.attn_init(gen, cfg)
    else:
        p["mamba"] = mamba.mamba_init(gen, cfg)
    if not cfg.parallel_block:
        p["norm2"] = common.norm_init(cfg, dev)
    if cfg.is_moe_layer(l):
        p["moe"] = moe.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp.mlp_init(gen, cfg)
    return p


def _group_init(gen, cfg: ArchConfig) -> dict:
    return {f"l{i}": _layer_init(gen, cfg, i) for i in range(cfg.layer_group)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen`` on ``gen.device`` (the port's
    own initialisation: same distributions as the reference, other
    numbers — tests carry reference weights over with ``bridge``)."""
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

def _add_aux(total, aux):
    """Running sum of aux-loss dicts; ``None`` stands for zero."""
    if aux is None:
        return total
    if total is None:
        return aux
    return {k: total[k] + aux[k] for k in total}


def _layer_apply(cfg: ArchConfig, p: dict, x, positions, *, cache_len=None):
    """Full-sequence layer.  Returns (x, aux or None, cache or None)."""
    cache = None
    make_cache = cache_len is not None
    h = common.norm_apply(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        y, st = rwkv6.time_mix_apply(cfg, p["rwkv"], h)
        x = x + y
        h2 = common.norm_apply(cfg, p["norm2"], x)
        y2, st2 = rwkv6.channel_mix_apply(cfg, p["cmlp"], h2)
        if make_cache:
            cache = {"tm": st, "cm": st2}
        return x + y2, None, cache
    if "attn" in p:
        if make_cache:
            y, cache = attention.attn_apply(
                cfg, p["attn"], h, positions=positions, causal=True,
                window=cfg.sliding_window, return_cache=True,
                cache_len=cache_len)
        else:
            y = attention.attn_apply(cfg, p["attn"], h, positions=positions,
                                     causal=True, window=cfg.sliding_window)
    elif make_cache:
        y, cache = mamba.mamba_apply(cfg, p["mamba"], h, return_state=True)
    else:
        y = mamba.mamba_apply(cfg, p["mamba"], h)
    if cfg.parallel_block:
        f, aux = _ffn(cfg, p, h)
        return x + y + f, aux, cache
    x = x + y
    h2 = common.norm_apply(cfg, p["norm2"], x)
    f, aux = _ffn(cfg, p, h2)
    return x + f, aux, cache


def _ffn(cfg, p, h):
    """The layer's FFN: ``(y, aux)``, aux the MoE's losses or ``None``."""
    if "moe" in p:
        return moe.moe_apply(cfg, p["moe"], h)
    return mlp.mlp_apply(cfg, p["mlp"], h), None


def _write_state(cache, new) -> None:
    """Copy a recurrent layer's new state into its (slot-cache view)
    cache, leaf by leaf."""
    if isinstance(cache, dict):
        for key in cache:
            _write_state(cache[key], new[key])
        return
    cache.copy_(new)


def _layer_decode(cfg: ArchConfig, p: dict, x, cache: dict, index):
    """One-token layer step.  Returns (x, cache), the cache updated in
    place (the cache is a view of the slot-stacked caches, which
    backbone_decode hands back as they are)."""
    h = common.norm_apply(cfg, p["norm1"], x)
    if cfg.family == "ssm":
        y, st = rwkv6.time_mix_apply(cfg, p["rwkv"], h, state=cache["tm"])
        x = x + y
        h2 = common.norm_apply(cfg, p["norm2"], x)
        y2, st2 = rwkv6.channel_mix_apply(cfg, p["cmlp"], h2,
                                          state=cache["cm"])
        _write_state(cache, {"tm": st, "cm": st2})
        return x + y2, cache
    if "attn" in p:
        y, cache = attention.attn_decode(cfg, p["attn"], h, cache,
                                         index=index,
                                         window=cfg.sliding_window)
    else:
        y, st = mamba.mamba_decode(cfg, p["mamba"], h, cache)
        _write_state(cache, st)
    if cfg.parallel_block:
        return x + y + _ffn(cfg, p, h)[0], cache
    x = x + y
    h2 = common.norm_apply(cfg, p["norm2"], x)
    return x + _ffn(cfg, p, h2)[0], cache


# ---------------------------------------------------------------------------
# backbone: loop over groups
# ---------------------------------------------------------------------------

def _group_apply(cfg: ArchConfig, gp, x, positions, cache_len=None):
    """One group's layers: (x, summed aux or None, caches by layer)."""
    aux, caches = None, {}
    for i in range(cfg.layer_group):
        x, a, caches[f"l{i}"] = _layer_apply(cfg, gp[f"l{i}"], x, positions,
                                             cache_len=cache_len)
        aux = _add_aux(aux, a)
    return x, aux, caches


def apply_backbone(cfg: ArchConfig, layers, x, positions, *, remat=False,
                   cache_len=None):
    """x: (B, S, D) embeddings.  Returns (x, aux), or (x, aux, caches) with
    caches stacked over groups when ``cache_len`` is given; ``aux`` is the
    MoE layers' summed aux losses, ``None`` where there is none.

    ``remat`` with ``cfg.remat != "none"`` recomputes each group in the
    backward pass (``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` on the group body).  Both of the
    reference's policies, ``full`` and ``dots_saveable``, recompute the
    whole group here: the values are the same, the memory/time trade
    differs for ``dots_saveable``."""
    aux = None
    if remat and cfg.remat != "none" and cache_len is None:
        from torch.utils.checkpoint import checkpoint

        # the recomputation runs in the backward pass, outside any policy
        # context of the forward (and, on the card, on autograd's own
        # thread): it replays the forward's policy
        pol = dict(runtime.policy())

        def group(gp, x):
            with runtime.use_policy(**pol):
                return _group_apply(cfg, gp, x, positions)[:2]

        for g in range(cfg.num_groups()):
            x, a = checkpoint(group, common.tree_index(layers, g), x,
                              use_reentrant=False)
            aux = _add_aux(aux, a)
        return x, aux
    per_group = []
    for g in range(cfg.num_groups()):
        x, a, caches = _group_apply(cfg, common.tree_index(layers, g), x,
                                    positions, cache_len)
        aux = _add_aux(aux, a)
        per_group.append(caches)
    if cache_len is not None:
        return x, aux, common.tree_stack(per_group)
    return x, aux


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


def _embed(params, tokens, extra_embeds=None):
    """Token embeddings, with ``extra_embeds (B, P, D)`` (a VLM's projected
    patches) prepended in the embeddings' dtype."""
    x = params["embed"]["embedding"][tokens.long()]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def zero_aux(device) -> dict:
    """The auxiliary losses of a family without experts: zero."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "z_loss": zero}


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            remat: bool = False,
            extra_embeds: Optional[torch.Tensor] = None, axis=None):
    """tokens: (B, S) -> (logits (B, [P +] S, V) f32, aux {lb_loss,
    z_loss})."""
    if axis is not None:
        logits, aux = _prefill_tp(cfg, params, tokens, None, axis,
                                  all_positions=True,
                                  extra_embeds=extra_embeds)
        return logits, aux or zero_aux(logits.device)
    x = _embed(params, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = apply_backbone(cfg, params["layers"], x, positions, remat=remat)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), aux or zero_aux(x.device)


def _layer_cache(cfg: ArchConfig, l: int, batch: int, cache_len: int,
                 device, n: int = 1):
    """One layer position's decode cache; ``n``: a rank's of a model axis
    of ``n`` (its kv heads, RWKV-6 heads or Mamba channels)."""
    if cfg.family == "ssm":        # recurrent state: cache_len plays no part
        H, dh = rwkv6._dims(cfg)
        H //= n
        dt = common.dtype_of(cfg)
        return {
            "tm": {"shift": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                        device=device),
                   "wkv": torch.zeros((batch, H, dh, dh),
                                      dtype=torch.float32, device=device)},
            "cm": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                              device=device),
        }
    if cfg.is_attn_layer(l):
        # a windowed layer's cache is its ring, whatever cache_len is (the
        # reference's "SWA: full ring always")
        if n > 1:
            cfg = dataclasses.replace(
                cfg, num_kv_heads=attention.local_kv_heads(cfg, n),
                head_dim=cfg.hd)
        return attention.init_cache(cfg, batch,
                                    cfg.sliding_window or cache_len, device)
    # conv ring + SSM state
    return mamba.init_state(cfg, batch, device, mamba._dims(cfg)[0] // n)


def init_decode_caches(cfg: ArchConfig, batch: int, cache_len: int, device,
                       axis=None):
    """Stacked (over groups) decode caches for every layer position; with
    ``axis``, each held rank's — at its local kv heads, RWKV-6 heads or
    Mamba channels — ranks on dim 0."""
    n = 1
    if axis is not None:
        check_tp(cfg, axis.n)
        n = axis.n
    group = {f"l{i}": _layer_cache(cfg, i, batch, cache_len, device, n)
             for i in range(cfg.layer_group)}
    G = cfg.num_groups()
    one = common.tree_map(
        lambda a: a[None].repeat((G,) + (1,) * a.dim()), group)
    if axis is None:
        return one
    return common.tree_map(
        lambda a: a[None].repeat((len(axis.held),) + (1,) * a.dim()), one)


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None, axis=None):
    """Full forward that also returns decode caches sized ``cache_len``
    (default: exactly the prompt length, patches included).  Returns
    (last-position logits (B, 1, V) f32, caches stacked over groups)."""
    if axis is not None:
        return _prefill_tp(cfg, params, tokens, cache_len, axis,
                           extra_embeds=extra_embeds)
    x = _embed(params, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, _, caches = apply_backbone(cfg, params["layers"], x, positions,
                                  cache_len=cache_len or x.shape[1])
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                caches, index, axis=None):
    """tokens: (B, 1); index: scalar or (B,) positions.  Returns (logits
    (B, 1, V) f32, caches) — the caches are updated in place."""
    if axis is not None:
        return _decode_step_tp(cfg, params, tokens, caches, index, axis)
    x = _embed(params, tokens)
    x, caches = backbone_decode(cfg, params["layers"], x, caches, index)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), caches


# ---------------------------------------------------------------------------
# tensor parallelism over a model axis (module docstring)
# ---------------------------------------------------------------------------

def check_tp(cfg: ArchConfig, n: int) -> None:
    """Whether ``cfg`` serves over a ``model`` axis of ``n`` (every
    family): whole query heads a rank where it has attention layers
    (``attention.check_heads``), and each split width divisible by ``n``
    — the dense FFN's ``d_ff``, the experts (``E % n``) and the shared
    experts' FFN, Mamba's ``d_inner``, RWKV-6's heads and channel-mix
    ``d_ff``."""
    def even(what: str, size: int) -> None:
        if size % n:
            raise ValueError(f"{cfg.name}: {what} {size} does not split "
                             f"over a model axis of {n}")
    if cfg.family == "ssm":
        even("RWKV-6 heads", cfg.d_model // cfg.rwkv_head_dim)
        even("d_ff", cfg.d_ff)
        return
    layers = range(max(cfg.layer_group, 1))
    if cfg.family == "encdec" or any(cfg.is_attn_layer(l) for l in layers):
        attention.check_heads(cfg, n)
    if cfg.family == "encdec" or not all(cfg.is_moe_layer(l)
                                         for l in layers):
        even("d_ff", cfg.d_ff)
    if cfg.num_experts:
        even("experts", cfg.num_experts)
        if cfg.shared_experts:
            even("shared experts' d_ff", cfg.d_ff * cfg.shared_experts)
    if not all(cfg.is_attn_layer(l) for l in layers):
        even("Mamba d_inner", mamba._dims(cfg)[0])


def check_tp_train(cfg: ArchConfig, n: int, sequence_parallel: bool = False,
                   seq: Optional[int] = None) -> None:
    """Whether ``cfg`` trains over a ``model`` axis of ``n``
    (:func:`loss_tp`): every family, with or without sequence
    parallelism, each split width as :func:`check_tp` has it.  Under
    sequence parallelism the split sequence — ``seq`` tokens, after a
    VLM's ``num_patches`` patches — must be a multiple of ``n`` (an
    encoder-decoder's residual stream is never split:
    ``encdec.loss_tp``)."""
    check_tp(cfg, n)
    if not (sequence_parallel and n > 1 and seq is not None) \
            or cfg.family == "encdec":
        return
    split = seq + (cfg.num_patches if cfg.family == "vlm" else 0)
    if split % n:
        raise ValueError(f"{cfg.name}: sequence parallelism splits the "
                         f"sequence of {split} positions over a model axis "
                         f"of {n}: not a multiple")


def _rank_trees(tree, axis) -> list:
    """Each held rank's tree (views)."""
    return [common.tree_index(tree, j) for j in range(len(axis.held))]


def _reduce(axis, parts, *biases):
    """The sum over the axis of the held ranks' partial outputs (the
    exit of a tensor-parallel region: identity backward), then each
    (replicated) bias once."""
    y = axis.reduce(torch.stack(parts))
    for b in biases:
        if b is not None:
            y = y + b
    return y


def _vocab_rows(ranks, tokens, axis) -> list:
    """Each held rank's rows of its slice of a vocab-parallel table at
    ``tokens``: the token's row where it falls in the slice, zero
    elsewhere."""
    Vl = ranks[0]["embed"]["embedding"].shape[0]
    parts = []
    for r, p in zip(axis.held, ranks):
        local = tokens.long() - r * Vl
        hit = (local >= 0) & (local < Vl)
        rows = p["embed"]["embedding"][local.clamp(0, Vl - 1)]
        parts.append(torch.where(hit[..., None], rows, torch.zeros_like(rows)))
    return parts


def _embed_tp(cfg, ranks, tokens, axis):
    """Vocab-parallel lookup: each rank's rows (:func:`_vocab_rows`),
    summed over the axis."""
    table = ranks[0]["embed"]["embedding"]
    if table.shape[0] == cfg.vocab_size:             # replicated
        return table[tokens.long()]
    return _reduce(axis, _vocab_rows(ranks, tokens, axis))


def _logits_tp(cfg, ranks, x, axis):
    """Vocab-parallel logits, gathered along the vocabulary."""
    parts = [x @ p["embed"]["embedding"].T if cfg.tie_embeddings
             else common.dense(p["lm_head"], x) for p in ranks]
    if parts[0].shape[-1] == cfg.vocab_size:         # replicated
        return parts[0].float()
    return axis.gather(torch.stack(parts)).float()


def _mixer_tp(cfg, ranks, axis, run):
    """The attention of every held rank through ``run(lcfg, lp, j)``:
    (partial outputs, what ``run`` returned beside each, the o bias)."""
    parts, extra, bias = [], [], None
    for j, (r, p) in enumerate(zip(axis.held, ranks)):
        lcfg, lp, bias = attention.local_params(cfg, p["attn"], r, axis.n)
        y, e = run(lcfg, lp, j)
        parts.append(y)
        extra.append(e)
    return parts, extra, bias


def _ffn_tp(cfg, ranks, h, hs, axis):
    """(partial FFN outputs of each held rank's copy ``hs[j]`` of the
    replicated input ``h``, the wo bias, the MoE's aux losses or
    ``None``).  The MoE routes ``h`` itself (``moe.moe_parts``)."""
    if "moe" in ranks[0]:
        parts, aux, bias = moe.moe_parts(cfg, [p["moe"] for p in ranks], h,
                                         hs, axis)
        return parts, bias, aux
    parts, bias = [], None
    for j, (r, p) in enumerate(zip(axis.held, ranks)):
        lp, bias = mlp.local_params(p["mlp"], r, axis.n)
        parts.append(mlp.mlp_apply(cfg, lp, hs[j]))
    return parts, bias, None


def _block_tp(cfg, ranks, x, h, hs, parts, o_bias, axis):
    """The rest of a layer after its mixer's partial outputs: the
    residual sums and the FFN, reduced over the axis (``h``: the mixer's
    replicated input, ``hs`` the ranks' copies of it, which a parallel
    block's FFN reads too).  Returns ``(x, aux or None)``."""
    if cfg.parallel_block:
        f, wo_bias, aux = _ffn_tp(cfg, ranks, h, hs, axis)
        return x + _reduce(axis, [a + b for a, b in zip(parts, f)], o_bias,
                           wo_bias), aux
    x = x + _reduce(axis, parts, o_bias)
    h2 = common.norm_apply(cfg, ranks[0]["norm2"], x)
    f, wo_bias, aux = _ffn_tp(cfg, ranks, h2, axis.copy(h2), axis)
    return x + _reduce(axis, f, wo_bias), aux


def _mamba_tp(cfg, ranks, hs, axis, states):
    """A Mamba layer's mixer over the axis, each held rank at its
    ``d_inner / n`` channels: ``x_proj``'s partial outputs summed between
    the two halves (``mamba.front`` / ``mamba.back``).  ``states[j]``:
    the rank's decode state, written in place, or ``None`` (a sequence).
    Returns (partial outputs, each rank's new state).

    The sum leaves one region and enters the next: ``reduce``, then
    ``copy`` (forward an all-reduce, backward an all-reduce).  Each rank's
    ``back`` reads the summed ``proj`` at its own channels only (its
    columns of ``dt_proj``, its rows of the scan), so the gradient a rank
    holds of ``proj`` is a partial one, and the sum over the ranks is
    what every rank's ``x_proj`` rows need.  (``reduce`` alone, identity
    backward, gives each rank process its own channels' part; the
    emulated axis, which holds ``proj`` once, would hide it.)"""
    fronts = [mamba.front(cfg, p["mamba"], hs[j],
                          None if states[j] is None else states[j]["conv"])
              for j, p in enumerate(ranks)]
    projs = axis.copy(_reduce(axis, [f[3] for f in fronts]))
    parts, made = [], []
    for j, (p, (xc, z, conv, _)) in enumerate(zip(ranks, fronts)):
        y, h = mamba.back(cfg, p["mamba"], xc, z, projs[j],
                          None if states[j] is None else states[j]["ssm"])
        new = {"conv": conv, "ssm": h}
        if states[j] is not None:
            _write_state(states[j], new)
        parts.append(y)
        made.append(new)
    return parts, made


def _rwkv_tp(cfg, ranks, x, axis, states):
    """An RWKV-6 layer over the axis: the time mix at each held rank's
    heads, its row-parallel ``o`` reduced; the channel mix's ``wv``
    reduced, and ``sigmoid(r)`` on each rank's slice of the receptance,
    gathered (``models/rwkv6.py``).  ``states`` as :func:`_mamba_tp`'s.
    Returns (x, each rank's new state).

    The gate is gathered, then multiplied by the replicated ``kv``, not
    taken on each rank's slice of ``kv`` and gathered: so the gradient of
    ``kv`` is whole on every rank, as ``wv``'s rows need it (a rank's
    slice of ``kv`` would give it the gradient of its slice alone), and
    ``axis.gather``'s backward hands each rank its slice of the gate's
    gradient, which its columns of ``wr`` need.  The values are the
    product's, element for element."""
    def st(j, key):
        return None if states[j] is None else states[j][key]
    hs = axis.copy(common.norm_apply(cfg, ranks[0]["norm1"], x))
    parts, tms = [], []
    for j, (r, p) in enumerate(zip(axis.held, ranks)):
        y, tm = rwkv6.time_mix_apply(cfg, rwkv6.local_time_mix(
            p["rwkv"], r, axis.n), hs[j], state=st(j, "tm"))
        parts.append(y)
        tms.append(tm)
    x = x + _reduce(axis, parts)
    hs = axis.copy(common.norm_apply(cfg, ranks[0]["norm2"], x))
    outs = [rwkv6.channel_mix_parts(cfg, p["cmlp"], hs[j], state=st(j, "cm"))
            for j, p in enumerate(ranks)]
    kv = _reduce(axis, [o[0] for o in outs])
    y = axis.gather(torch.stack([torch.sigmoid(o[1]) for o in outs])) * kv
    made = []
    for j, (tm, o) in enumerate(zip(tms, outs)):
        new = {"tm": tm, "cm": o[2]}
        if states[j] is not None:
            _write_state(states[j], new)
        made.append(new)
    return x + y, made


def _replay(remat: bool, cfg, fn, *args):
    """``fn(*args)``, under the policy it is called in; where ``remat``
    (and ``cfg`` remats), recomputed in the backward pass
    (``torch.utils.checkpoint``): the whole call is replayed, its
    exchanges with it (early stopping would skip a group's last exit, as
    its output is not among the saved tensors)."""
    pol = dict(runtime.policy())

    def run(*a):
        with runtime.use_policy(**pol):
            return fn(*a)
    if not (remat and cfg.remat != "none"):
        return run(*args)
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
    with set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False)


def _group_tp(cfg, ranks, x, g, axis, attend, state=None):
    """Group ``g`` of the backbone over the axis: (its output, [layer][held
    rank] of what each layer made beside its output, the MoE layers'
    summed aux losses or ``None``).  Each layer position follows
    ``cfg.is_attn_layer`` / ``cfg.is_moe_layer`` (or is RWKV-6's time and
    channel mix): attention through ``attend``, a Mamba or RWKV-6 layer
    from ``state(j, g, i)`` (held rank j's decode state of the layer,
    written in place; ``None`` for a sequence), making its new state."""
    granks = [common.tree_index(p["layers"], g) for p in ranks]
    row, aux = [], None
    for i in range(cfg.layer_group):
        lranks = [gp[f"l{i}"] for gp in granks]
        states = [None if state is None else state(j, g, i)
                  for j in range(len(lranks))]
        if cfg.family == "ssm":
            x, made = _rwkv_tp(cfg, lranks, x, axis, states)
            row.append(made)
            continue
        h = common.norm_apply(cfg, lranks[0]["norm1"], x)
        hs = axis.copy(h)          # enters the region: one copy a rank
        if "attn" in lranks[0]:
            parts, made, o_bias = _mixer_tp(
                cfg, lranks, axis,
                lambda lcfg, lp, j: attend(lcfg, lp, hs[j], j, g, i))
        else:
            (parts, made), o_bias = _mamba_tp(cfg, lranks, hs, axis,
                                              states), None
        x, a = _block_tp(cfg, lranks, x, h, hs, parts, o_bias, axis)
        aux = _add_aux(aux, a)
        row.append(made)
    return x, row, aux


def _backbone_tp(cfg, params, tokens, axis, attend, remat: bool = False,
                 state=None, extra_embeds=None):
    """The backbone over the axis, ``attend(lcfg, lp, h, j, g, i)`` giving
    held rank j's attention of ``h`` at layer i of group g as (its
    partial output, anything beside it), ``state`` as :func:`_group_tp`'s.
    ``extra_embeds`` (a VLM's projected patches, replicated) are
    prepended to the token embeddings.  Returns (the held ranks' trees,
    the final-normed activations, [group][layer][held rank] of what each
    layer made, the summed aux losses or ``None``).  ``remat``: each
    group is recomputed in the backward pass (:func:`_replay`)."""
    check_tp(cfg, axis.n)
    ranks = _rank_trees(params, axis)
    x = _embed_tp(cfg, ranks, tokens, axis)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    extras, aux = [], None
    for g in range(cfg.num_groups()):
        x, row, a = _replay(remat, cfg, _group_tp, cfg, ranks, x, g, axis,
                            attend, state)
        extras.append(row)
        aux = _add_aux(aux, a)
    return ranks, common.norm_apply(cfg, ranks[0]["final_norm"], x), \
        extras, aux


def _prefill_tp(cfg, params, tokens, cache_len, axis, all_positions=False,
                extra_embeds=None):
    """``prefill`` (or, ``all_positions``, ``forward``'s logits and aux)
    over the axis: caches per held rank, at its local kv heads, heads and
    channels."""
    S = tokens.shape[1] + (0 if extra_embeds is None
                           else extra_embeds.shape[1])
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)

    def attend(lcfg, lp, h, j, g, i):
        if all_positions:
            return attention.attn_apply(
                lcfg, lp, h, positions=positions, causal=True,
                window=cfg.sliding_window), None
        return attention.attn_apply(
            lcfg, lp, h, positions=positions, causal=True,
            window=cfg.sliding_window, return_cache=True,
            cache_len=cache_len or S)

    ranks, x, made, aux = _backbone_tp(cfg, params, tokens, axis, attend,
                                       extra_embeds=extra_embeds)
    if all_positions:
        return _logits_tp(cfg, ranks, x, axis), aux
    caches = [common.tree_stack([
        {f"l{i}": layer[j] for i, layer in enumerate(group)}
        for group in made]) for j in range(len(ranks))]
    return _logits_tp(cfg, ranks, x[:, -1:], axis), common.tree_stack(caches)


def _decode_step_tp(cfg, params, tokens, caches, index, axis):
    """``decode_step`` over the axis; each held rank's caches written in
    place."""
    cranks = _rank_trees(caches, axis)

    def attend(lcfg, lp, h, j, g, i):
        cache = common.tree_index(cranks[j][f"l{i}"], g)
        return attention.attn_decode(lcfg, lp, h, cache, index=index,
                                     window=cfg.sliding_window)[0], None

    def state(j, g, i):
        return common.tree_index(cranks[j][f"l{i}"], g)

    ranks, x, _, _ = _backbone_tp(cfg, params, tokens, axis, attend,
                                  state=state)
    return _logits_tp(cfg, ranks, x, axis), caches


def decode_exchanges(cfg: ArchConfig, n: int) -> dict:
    """The exchanges one decode tick makes over a ``model`` axis of ``n``
    ranks, by kind, derived from the layers (``{}`` for one rank).

    A region's exit is one all-reduce: an attention layer's ``o``, a
    Mamba layer's ``x_proj`` (between its halves) and ``out_proj``, an
    RWKV-6 layer's time-mix ``o`` and channel-mix ``wv``, and the FFN —
    dense, or the MoE's experts and shared MLP summed in the rank — once
    a layer (a parallel block sums its mixer and FFN in the rank: one
    exit).  An RWKV-6 layer adds one all-gather, of ``sigmoid(r) * kv``
    on each rank's slice.  Where the axis splits the vocabulary the
    embedding adds one all-reduce and the logits one all-gather.  So for
    ``L`` layers: dense, moe and vlm ``2 L + 1`` all-reduces and one
    all-gather (``L + 1`` for a parallel block); ssm ``2 L + 1`` and ``L
    + 1``; hybrid 3 a Mamba layer and 2 an attention layer, plus the
    embedding.  (The encoder-decoder family: ``encdec.decode_exchanges``.)"""
    if n == 1:
        return {}
    ends = 0 if cfg.vocab_size % n else 1
    G = cfg.num_groups()
    ar, ag = ends, ends
    for l in range(cfg.layer_group):
        if cfg.family == "ssm":
            ar, ag = ar + 2 * G, ag + G
            continue
        mixer = 1 if cfg.is_attn_layer(l) else 2
        ar += G * (mixer + (0 if cfg.parallel_block else 1))
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


# ---------------------------------------------------------------------------
# training over a model axis: the loss, sequence parallelism
# ---------------------------------------------------------------------------

def _sp_bias(p: dict, path: str):
    """The bias of the dense leaf at ``path`` of a layer's tree, or
    ``None``."""
    for key in path.split("/"):
        p = p.get(key, {})
    return p.get("bias")


def _rwkv_sp(cfg, lranks, x, axis, normed, out):
    """An RWKV-6 layer under sequence parallelism (:func:`_layer_sp`'s
    ``normed`` and ``out``): the time mix and the channel mix on the
    gathered sequence, so the token shifts and the scan see every
    position, each at the rank's heads or columns; ``o`` and ``wv`` leave
    through ``scatter_seq``, and the channel mix's gate multiplies each
    rank's slice of the summed ``kv`` after the exit, as it multiplies
    the replicated ``kv`` without sequence parallelism (the same values).

    The gate, each rank's channels of ``sigmoid(r)`` at every position,
    is gathered along the channels by ``gather_seq(dim=-1)``, whose
    backward reduce-scatters over the channels.  ``gather``'s backward
    (the rank's slice of the gradient, with no exchange) is not enough
    here: a rank's residual is its own positions only, so its gradient of
    the gathered gate is zero at the other ranks' positions, and its
    columns of ``wr`` need the sum over the ranks.  (The emulated axis,
    which holds the gathered gate once, would hide it.)"""
    hs = axis.gather_seq(normed("norm1", x))
    x = x + out([rwkv6.time_mix_apply(cfg, rwkv6.local_time_mix(
        p["rwkv"], r, axis.n), hs[j])[0]
        for j, (r, p) in enumerate(zip(axis.held, lranks))])
    hs = axis.gather_seq(normed("norm2", x))
    outs = [rwkv6.channel_mix_parts(cfg, p["cmlp"], hs[j])
            for j, p in enumerate(lranks)]
    gates = axis.gather_seq(torch.stack([torch.sigmoid(o[1]) for o in outs]),
                            dim=-1)
    kv = out([o[0] for o in outs])
    L = kv.shape[2]
    return x + torch.stack([gates[j][:, r * L:(r + 1) * L] * kv[j]
                            for j, r in enumerate(axis.held)])


def _layer_sp(cfg, lranks, x, positions, axis):
    """One layer under sequence parallelism, differentiable, every family
    but the encoder-decoder's (``encdec.loss_tp``): ``(x, aux or
    None)``.  ``x`` is each held rank's slice of the residual stream,
    ``(n, B, L, D)``: the norms run on the slices; each region gathers
    the sequence on entry (``gather_seq``), runs its mixer or FFN on the
    whole sequence at the rank's heads, experts or channels, and
    reduce-scatters on exit (``scatter_seq``), where each rank adds its
    copy of a bias to its slice.  The layer positions follow
    :func:`_group_tp`'s: attention, or a Mamba mixer (:func:`_mamba_tp`
    on the gathered sequence: the conv and the scan see every position);
    a dense or MoE FFN (``moe.moe_parts_sp``: the router on each rank's
    slice); RWKV-6 (:func:`_rwkv_sp`)."""
    def normed(name, x):
        return torch.stack([common.norm_apply(cfg, p[name], x[j])
                            for j, p in enumerate(lranks)])

    def out(parts, *paths):
        y = axis.scatter_seq(torch.stack(parts))
        rows = []
        for j, p in enumerate(lranks):
            row = y[j]
            for path in paths:
                bias = _sp_bias(p, path)
                if bias is not None:
                    row = row + bias
            rows.append(row)
        return torch.stack(rows)

    def ffn(hn, hs):
        if "moe" in lranks[0]:
            parts, aux = moe.moe_parts_sp(cfg, [p["moe"] for p in lranks],
                                          hn, hs, axis)
            return parts, aux, "moe/shared_mlp/wo"
        return _ffn_tp(cfg, lranks, None, hs, axis)[0], None, "mlp/wo"

    if cfg.family == "ssm":
        return _rwkv_sp(cfg, lranks, x, axis, normed, out), None
    hn = normed("norm1", x)
    hs = axis.gather_seq(hn)
    if "attn" in lranks[0]:
        parts = _mixer_tp(cfg, lranks, axis, lambda lcfg, lp, j: (
            attention.attn_apply(lcfg, lp, hs[j], positions=positions,
                                 causal=True, window=cfg.sliding_window),
            None))[0]
    else:
        parts = _mamba_tp(cfg, lranks, hs, axis, [None] * len(lranks))[0]
    if cfg.parallel_block:
        f, aux, path = ffn(hn, hs)
        return x + out([a + b for a, b in zip(parts, f)], "attn/o",
                       path), aux
    x = x + out(parts, "attn/o")
    hn = normed("norm2", x)
    f, aux, path = ffn(hn, axis.gather_seq(hn))
    return x + out(f, path), aux


def _group_sp(cfg, ranks, x, g, positions, axis):
    """Group ``g`` under sequence parallelism: ``(x, the MoE layers'
    summed aux losses or None)``."""
    granks = [common.tree_index(p["layers"], g) for p in ranks]
    aux = None
    for i in range(cfg.layer_group):
        x, a = _layer_sp(cfg, [gp[f"l{i}"] for gp in granks], x, positions,
                         axis)
        aux = _add_aux(aux, a)
    return x, aux


def _embed_sp(cfg, ranks, tokens, axis, split_vocab: bool, patches=None):
    """Each held rank's slice of the embedded sequence, ``(n, B, L, D)``
    with ``L = (P + S) / n``: a VLM's ``P`` projected patches first, then
    the ``S`` tokens.  A vocab-parallel lookup reduce-scatters the ranks'
    masked rows (``scatter_seq``, zero rows at the patches' positions).
    A replicated table, and the connector, are read whole on every rank
    (the patches projected once, on the first held rank's copy of the
    connector; every token looked up) and the sequence split
    (``split_seq``, backward an all-gather): their gradients are then
    whole on every rank, with no exchange of their own
    (:data:`_READ_WHOLE`)."""
    B, S = tokens.shape
    P = 0 if patches is None else patches.shape[1]
    if P:
        from repro_torch.models import vlm
        patch = vlm._project(ranks[0], patches)
    if not split_vocab:
        x = ranks[0]["embed"]["embedding"][tokens.long()]
        if P:
            x = torch.cat([patch.to(x.dtype), x], dim=1)
        return axis.split_seq(x)
    parts = _vocab_rows(ranks, tokens, axis)
    if P:
        parts = [torch.cat([rows.new_zeros((B, P) + rows.shape[2:]), rows],
                           dim=1) for rows in parts]
    x = axis.scatter_seq(torch.stack(parts))
    if not P:
        return x
    patch = patch.to(x.dtype)
    return x + axis.split_seq(torch.cat(
        [patch, patch.new_zeros((B, S) + patch.shape[2:])], dim=1))


def xent_vocab_parallel(axis, parts, labels):
    """Cross entropy of vocab-parallel logits ``parts (n, B, S, V/n)``
    (f32, each held rank's slice of the vocabulary) against ``labels (B,
    S)`` (-100 masked): ``(Σ nll, Σ mask)``, replicated.  The logits are
    never gathered: the maximum is all-reduced (detached), then each
    rank's sum of exponentials, then the target's logit from the rank
    whose slice holds it.  ``train/step.xent_loss``'s value within f32
    rounding."""
    Vl = parts.shape[-1]
    m = axis.pmax(parts.amax(dim=-1))
    se = axis.reduce(torch.exp(parts - m[..., None]).sum(dim=-1))
    lab = labels.long()
    tgt = []
    for j, r in enumerate(axis.held):
        local = lab - r * Vl
        hit = (local >= 0) & (local < Vl)
        t = torch.gather(parts[j], -1, local.clamp(0, Vl - 1)[..., None])
        tgt.append(torch.where(hit, t[..., 0], torch.zeros_like(t[..., 0])))
    ll = axis.reduce(torch.stack(tgt))
    mask = (labels >= 0).float()
    nll = (torch.log(se) + m - ll) * mask
    return nll.sum(), mask.sum()


def _xent_sum(logits, labels):
    """``(Σ nll, Σ mask)`` of replicated f32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


# replicated leaves a rank reads on its own though the axis does not split
# them, so that its gradient there is a partial one: the biases
# ``attention.local_params`` and ``mlp.local_params`` cut to the rank's
# heads or columns (an encoder-decoder's encoder, self and cross attention
# alike: the patterns are unanchored), and a ``k`` / ``v`` kernel whose kv
# heads the axis does not divide (each rank reads the head of its group);
# RWKV-6's decay LoRA and ``ln_x`` cut to the rank's
# channels (``rwkv6.local_time_mix``) and its token-shift mixes and LoRAs,
# read whole on the rank's copy of the layer's input, whose outputs feed
# only the rank's heads or columns.  Each enters through ``axis.copy``
# (once a step, the leaf stacked over groups), not its computation moved
# before the region's entry: that would copy the five ddlerp outputs and
# the decay, activations of ``(B, S, D)`` each, where the leaves are
# vectors and rank-R factors
_RANK_SLICED = (r"attn/(q|k|v)/bias$|attn/(k|v)/kernel$|mlp/w(i|g)/bias$"
                r"|rwkv/(mix_|w_lora_|ln_x/)|cmlp/mix_")


# replicated leaves that every rank reads whole under sequence parallelism
# (:func:`_embed_sp`, the replicated logits of :func:`loss_tp`): their
# gradients are whole on every rank, so they do not enter through a copy
_READ_WHOLE = r"^(embed|lm_head|vit_proj)/"


def _train_ranks(params, split, axis, sp: bool):
    """The per-rank tree of :func:`loss_tp`'s ``params``: a leaf the axis
    splits as it is; a replicated one entering through ``axis.copy``
    where a rank reads it on its own (a bias cut to the rank's slice, or
    under sequence parallelism every one read on the rank's slice of the
    sequence: all but :data:`_READ_WHOLE`), so that its gradient sums
    over the ranks; else a view of its one copy for each held rank."""
    Mh = len(axis.held)

    def one(path, x, is_split):
        if is_split:
            return x
        if (sp and not re.search(_READ_WHOLE, path)) \
                or re.search(_RANK_SLICED, path):
            return axis.copy(x[0])
        return x.expand((Mh,) + tuple(x.shape[1:]))

    def walk(t, s, prefix):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], prefix + (k,)) for k in t}
        return one("/".join(prefix), t, s)
    return walk(params, split, ())


def _xent_tp(cfg, ranks, x, labels, axis, split_vocab: bool):
    """``(Σ nll, Σ mask)`` of the final-normed replicated ``x (B, S,
    D)``: :func:`xent_vocab_parallel` on each rank's slice of the logits,
    or, where the axis does not split the vocabulary, the plain cross
    entropy of the replicated logits."""
    if not split_vocab:
        return _xent_sum(_logits(cfg, ranks[0], x), labels)
    xs = axis.copy(x)
    return xent_vocab_parallel(axis, torch.stack([
        _logits(cfg, p, xs[j]) for j, p in enumerate(ranks)]), labels)


def loss_tp(cfg: ArchConfig, params, split, tokens: torch.Tensor,
            labels: torch.Tensor, axis, *, sequence_parallel: bool = False,
            remat: bool = False, frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None):
    """The training loss over a model axis, every family: ``(Σ nll, Σ
    mask, aux)`` over ``tokens``/``labels (B, S)``, replicated,
    differentiable through the axis (``parallel/model_axis.py``'s
    conjugate pairs); ``aux`` is the MoE layers' summed aux losses
    (``z_loss``, ``lb_loss``, ``lb_means``, each counted once), ``None``
    for the families without experts.  ``params``: each leaf leading with
    the held ranks' slices where the axis splits it (``split``: a bool a
    leaf), with one copy (a leading 1) where it does not
    (:func:`_train_ranks`).  ``frames (B, T, D)``: an encoder-decoder's
    (which hands over to ``encdec.loss_tp``); ``patches (B, P, D)``: a
    VLM's, projected by the replicated connector and prepended, the loss
    taken over the last ``S`` positions only, the text's.

    Without sequence parallelism this is :func:`_backbone_tp`'s forward
    (a hybrid's layer positions as ``_group_tp`` follows them: attention,
    or Mamba through :func:`_mamba_tp`; an MoE FFN through
    ``moe.moe_parts``), the connector run once (``vlm.connector``).
    Under it (:func:`_layer_sp`) the residual stream is each rank's slice
    of the ``P + S`` positions (:func:`_embed_sp`), and every replicated
    leaf a rank reads on its own positions enters through ``copy`` (all
    but :data:`_READ_WHOLE`).  The embedding is vocab-parallel (each
    rank's rows, then ``reduce``, or under sequence parallelism
    ``scatter_seq``); the loss
    is :func:`xent_vocab_parallel` on each rank's slice of the logits,
    or, where the axis does not split the vocabulary, the plain cross
    entropy of the replicated logits (under sequence parallelism of the
    final activations gathered by ``gather``, whose backward keeps each
    rank's slice: every rank reads the replicated ``lm_head`` whole, as
    :func:`_embed_sp` reads the table and the connector).  ``remat``
    recomputes each group in the backward pass, its exchanges with it
    (:func:`_replay`)."""
    B, S = tokens.shape
    check_tp_train(cfg, axis.n, sequence_parallel, S)
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.loss_tp(cfg, params, split, tokens, frames, labels,
                              axis, sequence_parallel=sequence_parallel,
                              remat=remat)
    n = axis.n
    sp = sequence_parallel and n > 1
    params = _train_ranks(params, split, axis, sp)
    split_vocab = params["embed"]["embedding"].shape[1] != cfg.vocab_size
    vlm_patches = patches if cfg.family == "vlm" else None
    if not sp:
        extra = None
        if vlm_patches is not None:
            from repro_torch.models import vlm
            extra = vlm.connector(params, vlm_patches)
        positions = torch.arange(S + (0 if extra is None else extra.shape[1]),
                                 dtype=torch.int32, device=tokens.device)

        def attend(lcfg, lp, h, j, g, i):
            return attention.attn_apply(lcfg, lp, h, positions=positions,
                                        causal=True,
                                        window=cfg.sliding_window), None
        ranks, x, _, aux = _backbone_tp(cfg, params, tokens, axis, attend,
                                        remat, extra_embeds=extra)
        return (*_xent_tp(cfg, ranks, x[:, -S:], labels, axis,
                          split_vocab), aux)
    ranks = _rank_trees(params, axis)
    P = 0 if vlm_patches is None else vlm_patches.shape[1]
    positions = torch.arange(P + S, dtype=torch.int32, device=tokens.device)
    x = _embed_sp(cfg, ranks, tokens, axis, split_vocab, vlm_patches)
    aux = None
    for g in range(cfg.num_groups()):
        x, a = _replay(remat, cfg, _group_sp, cfg, ranks, x, g, positions,
                       axis)
        aux = _add_aux(aux, a)
    normed = torch.stack([common.norm_apply(cfg, p["final_norm"], x[j])
                          for j, p in enumerate(ranks)])
    if not split_vocab:
        xs = axis.gather(normed, dim=1)
        return (*_xent_sum(_logits(cfg, ranks[0], xs[:, P:]), labels), aux)
    xs = axis.gather_seq(normed)
    parts = torch.stack([_logits(cfg, p, xs[j][:, P:])
                         for j, p in enumerate(ranks)])
    return (*xent_vocab_parallel(axis, parts, labels), aux)


def _splits_sequence(cfg: ArchConfig, sequence_parallel: bool) -> bool:
    """Whether sequence parallelism splits ``cfg``'s residual stream (an
    encoder-decoder's stays whole: ``encdec.loss_tp``)."""
    return sequence_parallel and cfg.family != "encdec"


def copied_leaves(cfg: ArchConfig, n: int,
                  sequence_parallel: bool = False) -> list:
    """The paths of ``cfg``'s leaves that enter a model axis of ``n``
    through ``axis.copy`` in training (:func:`_train_ranks`): the
    replicated ones a rank reads on its own (``_RANK_SLICED``), or where
    sequence parallelism splits the residual stream every replicated one
    but those every rank reads whole (``_READ_WHOLE``)."""
    from repro_torch.bridge import param_shapes
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh_tree import mesh_spec
    heads = sharding.head_counts(cfg)
    sp = _splits_sequence(cfg, sequence_parallel)
    return [p for p, shape in param_shapes(cfg).items()
            if mesh_spec(p, shape, {"data": 1, "model": n}, heads).model
            is None and ((sp and not re.search(_READ_WHOLE, p))
                         or re.search(_RANK_SLICED, p))]


def _layer_exchanges(cfg: ArchConfig, l: int, sp: bool) -> tuple:
    """``(forward, backward)`` exchanges by kind of layer position ``l``
    in training (:func:`train_exchanges`)."""
    fwd: dict = {}
    bwd: dict = {}

    def add(into, kind, k=1):
        into[kind] = into.get(kind, 0) + k

    def region(k=1):
        # entry: copy (backward all-reduce) or gather_seq (all-gather,
        # backward reduce-scatter); exit: reduce (all-reduce, backward
        # none) or scatter_seq (reduce-scatter, backward all-gather)
        for kind in ((("all_gather", "reduce_scatter")) if sp
                     else ("all_reduce",)):
            add(fwd, kind, k)
            add(bwd, kind, k)
    if cfg.family == "ssm":
        region(2)
        # the channel mix's gate: all-gather, backward none (``gather``)
        # or a reduce-scatter (``gather_seq`` over the channels)
        add(fwd, "all_gather")
        if sp:
            add(bwd, "reduce_scatter")
        return fwd, bwd
    if cfg.is_attn_layer(l):
        region()
    elif sp:            # the region, and x_proj's copy(reduce(...))
        region()
        add(fwd, "all_reduce")
        add(bwd, "all_reduce")
    else:
        region(2)
    if not cfg.parallel_block:
        region()
    if cfg.is_moe_layer(l):
        if sp:          # the routing gathered; the aux losses' sums
            add(fwd, "all_gather")
            add(bwd, "reduce_scatter")
            add(fwd, "all_reduce")
        else:           # the gates' copy
            add(bwd, "all_reduce")
    return fwd, bwd


def train_exchanges(cfg: ArchConfig, n: int, *, sequence_parallel: bool,
                    remat: bool) -> dict:
    """The exchanges one :func:`loss_tp` forward and backward makes over a
    model axis of ``n`` ranks, by kind, derived from the layers.

    A region enters with a copy (backward: an all-reduce) and exits with
    an all-reduce (backward: none), or under sequence parallelism gathers
    (backward: reduce-scatter) and reduce-scatters (backward:
    all-gather).  A dense layer has two regions (a parallel block one),
    an MoE layer too; without sequence parallelism its gates enter the
    region through a copy of their own (the router runs outside it), and
    under it the routing is gathered (all-gather, backward
    reduce-scatter) and the aux losses' sums all-reduced
    (``moe.moe_parts_sp``).  An RWKV-6 layer has two regions and gathers
    the channel mix's gate (backward: none, or under sequence parallelism
    a reduce-scatter, :func:`_rwkv_sp`).  A Mamba mixer has two regions,
    its ``x_proj`` sum leaving one and entering the next
    (:func:`_mamba_tp`), or under sequence parallelism one region and
    that sum's ``copy(reduce(...))``; so a hybrid's Mamba layer three
    regions and its attention layer two.  An encoder-decoder's encoder
    layer has two (attention, MLP), its decoder layer three (self and
    cross attention, MLP), and the encoder's output one copy into the
    cross attention (``encdec.loss_tp``), with or without sequence
    parallelism (its residual stream stays whole).  A VLM's layers are
    the dense family's.  Each replicated leaf a rank reads on its own
    (:func:`copied_leaves`: a cut bias, a kv kernel the axis leaves
    whole, RWKV-6's mixes, LoRAs and ``ln_x``; under sequence parallelism
    every replicated leaf) enters through a copy once a step, its groups
    stacked.  The embedding adds one exit, the logits one entry, the
    vocab-parallel cross entropy three all-reduces (maximum, sums of
    exponentials, target logits).  Remat replays each replayed layer's
    forward exchanges in the backward (every group; an encoder-decoder's
    decoder layers, as the reference checkpoints them; the leaves' copies
    stay outside it); under sequence parallelism a VLM's patches join a
    vocab-parallel embedding through one split (backward: all-gather).
    Where the axis does not split the vocabulary the embedding and the
    logits are replicated: no exchange, and the loss is a plain cross
    entropy (under sequence parallelism the embedded sequence is split,
    backward an all-gather, and the final activations gathered, an
    all-gather).  ``{}`` for one rank."""
    if n == 1:
        return {}
    check_tp_train(cfg, n, sequence_parallel)
    sp = _splits_sequence(cfg, sequence_parallel)
    replayed = bool(remat and cfg.remat != "none")
    out: dict = {}

    def add(counts, k):
        for kind, v in counts.items():
            out[kind] = out.get(kind, 0) + k * v
    if cfg.family == "encdec":
        for layers, regions, replay in (
                (cfg.encoder_layers, 2, False),
                (cfg.num_layers, 3, replayed)):
            add({"all_reduce": regions}, layers * (2 + replay))
        add({"all_reduce": 1}, 1)          # the encoder's output's copy
    else:
        G = cfg.num_groups()
        for l in range(cfg.layer_group):
            fwd, bwd = _layer_exchanges(cfg, l, sp)
            add(fwd, G * (1 + replayed))
            add(bwd, G)
    add({"all_reduce": len(copied_leaves(cfg, n, sequence_parallel))}, 1)
    if cfg.vocab_size % n == 0:            # embedding, logits: one each
        add({"reduce_scatter": 2, "all_gather": 2} if sp
            else {"all_reduce": 2}, 1)
        add({"all_reduce": 3}, 1)          # the vocab-parallel loss
        if sp and cfg.family == "vlm":    # the patches' split
            add({"all_gather": 1}, 1)
    elif sp:                               # the split, the final gather
        add({"all_gather": 2}, 1)
    return {k: v for k, v in out.items() if v}
