"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro/models/encdec.py``.  The conv/mel frontend is a
stub, as in the reference: the batch carries precomputed frame embeddings
``frames (B, T_frames, d_model)``, which feed the encoder after a linear
``frame_proj``.  Positions are fixed sinusoids (no RoPE), activations GELU,
norms parametric LayerNorm.

The encoder's self attention is non-causal full-sequence attention, so on
the card it runs the flash kernel (``kernels/ops.flash_attention``); the
decoder's causal self attention in a prefill runs it too.  Cross attention
takes the reference's plain chunked branch (``models/attention.py``).
The encoder layers and the decoder layers are each stacked over their
count (``encoder_layers``, ``num_layers``), not over groups.  Decode
writes each layer's self-attention cache in place and reads the cross
K/V (``xk``, ``xv``) that the prefill stored once.

Over a ``model`` axis (``axis=``, ``parallel/model_axis.py``; ``params``
then the held ranks' shards) the encoder's self attention, the decoder's
self and cross attention run at each rank's local heads
(``attention.local_params``: non-causal K2 at the rank's heads in the
encoder, the cross K/V each rank's heads of the encoder output), the MLP
is column/row-parallel, and each region's partial outputs are summed
over the axis with its biases added once after the sum
(``models/transformer.py``'s helpers).  Whisper's vocabulary (51,865)
does not split over 2 or 4, so its embedding and logits stay
replicated; ``frame_proj`` is replicated too.  A decode tick then makes
``3 L`` all-reduces (:func:`decode_exchanges`).

Training over the axis (:func:`loss_tp`) is the same forward,
differentiable: each region enters through ``axis.copy`` and leaves
through ``reduce`` (``parallel/model_axis.py``); the encoder's output
enters the decoder layers' cross attention through one ``copy`` (each
rank's cross K/V read it at the rank's heads, so its gradient on a rank
is a partial one); the biases cut to a rank's heads or columns (q/k/v
of every attention, ``wi``) enter through ``copy`` once a step
(``transformer._RANK_SLICED``); the tied embedding takes the gradient of
its lookup and of the logits, on each rank its rows of the vocabulary
where the axis splits it, whole where it does not (replicated, as its
two uses are); ``frame_proj`` runs once, outside any region, on the
replicated frames.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mlp, transformer


def _enc_layer_init(gen, cfg):
    dev = gen.device
    return {"norm1": common.norm_init(cfg, dev),
            "attn": attention.attn_init(gen, cfg),
            "norm2": common.norm_init(cfg, dev),
            "mlp": mlp.mlp_init(gen, cfg)}


def _dec_layer_init(gen, cfg):
    dev = gen.device
    return {"norm1": common.norm_init(cfg, dev),
            "attn": attention.attn_init(gen, cfg),
            "norm2": common.norm_init(cfg, dev),
            "xattn": attention.attn_init(gen, cfg),
            "norm3": common.norm_init(cfg, dev),
            "mlp": mlp.mlp_init(gen, cfg)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    dt = common.dtype_of(cfg)
    return {
        "frame_proj": common.dense_init(gen, cfg.d_model, cfg.d_model, dt),
        "embed": common.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "enc_layers": common.stacked_init(
            gen, cfg.encoder_layers, lambda g: _enc_layer_init(g, cfg)),
        "enc_norm": common.norm_init(cfg, gen.device),
        "layers": common.stacked_init(
            gen, cfg.num_layers, lambda g: _dec_layer_init(g, cfg)),
        "final_norm": common.norm_init(cfg, gen.device),
    }


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _frames_in(cfg, proj, frames):
    x = common.dense(proj, frames.to(proj["kernel"].dtype))
    return x + common.sinusoid_pos(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, axis=None):
    """frames: (B, T, D) precomputed frame embeddings (frontend stub),
    cast to the model's dtype (bf16 frames into an f32 model: the
    reference's type promotion)."""
    if axis is not None:
        return _encode_tp(cfg, transformer._rank_trees(params, axis),
                          frames, axis)
    x = _frames_in(cfg, params["frame_proj"], frames)
    positions = _arange(x.shape[1], x.device)
    for i in range(cfg.encoder_layers):
        lp = common.tree_index(params["enc_layers"], i)
        h = common.norm_apply(cfg, lp["norm1"], x)
        x = x + attention.attn_apply(cfg, lp["attn"], h, positions=positions,
                                     causal=False, use_rope=False)
        h = common.norm_apply(cfg, lp["norm2"], x)
        x = x + mlp.mlp_apply(cfg, lp["mlp"], h)
    return common.norm_apply(cfg, params["enc_norm"], x)


def _embed(cfg, params, tokens):
    x = params["embed"]["embedding"][tokens.long()]
    return x + common.sinusoid_pos(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)


def _logits(params, x):
    return (x @ params["embed"]["embedding"].T).float()


def _cross(cfg, lp, x, enc_out, positions, enc_positions):
    h = common.norm_apply(cfg, lp["norm2"], x)
    return x + attention.attn_apply(cfg, lp["xattn"], h, positions=positions,
                                    causal=False, kv_x=enc_out,
                                    kv_positions=enc_positions,
                                    use_rope=False)


def _dec_layer(cfg, lp, x, enc_out, positions, enc_positions):
    h = common.norm_apply(cfg, lp["norm1"], x)
    x = x + attention.attn_apply(cfg, lp["attn"], h, positions=positions,
                                 causal=True, use_rope=False)
    x = _cross(cfg, lp, x, enc_out, positions, enc_positions)
    h = common.norm_apply(cfg, lp["norm3"], x)
    return x + mlp.mlp_apply(cfg, lp["mlp"], h)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor, remat: bool = False, axis=None):
    """Teacher-forced training forward.  Returns (logits, aux); ``remat``
    recomputes each decoder layer in the backward pass, as the reference
    checkpoints its decoder layers."""
    if axis is not None:
        return _decoder_tp(cfg, params, tokens, frames, None, axis,
                           all_positions=True)
    enc_out = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens)
    positions = _arange(x.shape[1], x.device)
    enc_positions = _arange(enc_out.shape[1], x.device)
    layer = _dec_layer
    if remat and cfg.remat != "none":
        from torch.utils.checkpoint import checkpoint

        # the recomputation runs in the backward pass, outside the
        # forward's policy context: it replays the forward's policy
        pol = dict(runtime.policy())

        def replay(*args):
            with runtime.use_policy(**pol):
                return _dec_layer(*args)

        def layer(*args):
            return checkpoint(replay, *args, use_reentrant=False)
    for i in range(cfg.num_layers):
        lp = common.tree_index(params["layers"], i)
        x = layer(cfg, lp, x, enc_out, positions, enc_positions)
    x = common.norm_apply(cfg, params["final_norm"], x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x), {"lb_loss": zero, "z_loss": zero}


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor, cache_len=None, axis=None):
    """Encode + teacher-forced decoder pass, returning decode caches.

    Cross-attention K/V are computed once from the encoder output and
    stored in the cache (``xk``, ``xv``: (L, B, T_frames, Kv, hd)); the
    self-attention caches hold the prompt tokens, padded to
    ``cache_len``."""
    if axis is not None:
        return _decoder_tp(cfg, params, tokens, frames, cache_len, axis)
    enc_out = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens)
    positions = _arange(x.shape[1], x.device)
    enc_positions = _arange(enc_out.shape[1], x.device)
    Kv, hd = cfg.num_kv_heads, cfg.hd
    B, T = enc_out.shape[:2]
    caches = []
    for i in range(cfg.num_layers):
        lp = common.tree_index(params["layers"], i)
        h = common.norm_apply(cfg, lp["norm1"], x)
        y, self_cache = attention.attn_apply(
            cfg, lp["attn"], h, positions=positions, causal=True,
            use_rope=False, return_cache=True, cache_len=cache_len)
        x = _cross(cfg, lp, x + y, enc_out, positions, enc_positions)
        h = common.norm_apply(cfg, lp["norm3"], x)
        x = x + mlp.mlp_apply(cfg, lp["mlp"], h)
        xk = common.dense(lp["xattn"]["k"], enc_out)
        xv = common.dense(lp["xattn"]["v"], enc_out)
        caches.append({"self": self_cache,
                       "xk": xk.reshape(B, T, Kv, hd),
                       "xv": xv.reshape(B, T, Kv, hd)})
    x = common.norm_apply(cfg, params["final_norm"], x[:, -1:])
    return _logits(params, x), common.tree_stack(caches)


def init_decode_caches(cfg: ArchConfig, batch: int, cache_len: int,
                       enc_len: int, device, axis=None):
    """Empty caches stacked over the decoder layers; with ``axis``, each
    held rank's at its local kv heads, ranks on dim 0."""
    if axis is not None:
        transformer.check_tp(cfg, axis.n)
        lcfg = dataclasses.replace(
            cfg, num_kv_heads=attention.local_kv_heads(cfg, axis.n),
            head_dim=cfg.hd)
        one = init_decode_caches(lcfg, batch, cache_len, enc_len, device)
        return common.tree_map(
            lambda a: a[None].repeat((len(axis.held),) + (1,) * a.dim()), one)
    Kv, hd = cfg.num_kv_heads, cfg.hd
    dt = common.dtype_of(cfg)
    one = {"self": attention.init_cache(cfg, batch, cache_len, device),
           "xk": torch.zeros((batch, enc_len, Kv, hd), dtype=dt,
                             device=device),
           "xv": torch.zeros((batch, enc_len, Kv, hd), dtype=dt,
                             device=device)}
    L = cfg.num_layers
    return common.tree_map(
        lambda a: a[None].repeat((L,) + (1,) * a.dim()), one)


def _decode_pos(cfg, x, index):
    """``x`` plus the absolute sinusoid at each row's decode index."""
    D = cfg.d_model
    idx = torch.as_tensor(index, device=x.device).to(torch.float32)
    ang = idx[..., None] * common.sinusoid_freqs(D, x.device)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :D]
    return x + (pe[:, None] if pe.dim() == 2 else pe).to(x.dtype)


def _cross_decode(cfg, p, h, xk, xv):
    """One token's cross attention against the cached encoder K/V (over a
    ``model`` axis, a rank's heads: its partial output)."""
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B = h.shape[0]
    q = common.dense(p["q"], h).reshape(B, 1, Kv, H // Kv, hd)
    scores = attention._gqa_scores(q * (hd ** -0.5), xk)
    probs = torch.softmax(scores, dim=-1)
    out = attention._gqa_out(probs, xv).reshape(B, 1, H * hd)
    return common.dense(p["o"], out)


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                caches, index, axis=None):
    """tokens: (B, 1); index: a scalar or (B,) positions.  Cross attention
    reads the cached encoder K/V; the self-attention caches are written in
    place.  Returns (logits (B, 1, V) f32, caches)."""
    if axis is not None:
        return _decode_step_tp(cfg, params, tokens, caches, index, axis)
    x = _decode_pos(cfg, params["embed"]["embedding"][tokens.long()], index)
    for i in range(cfg.num_layers):
        lp = common.tree_index(params["layers"], i)
        cache = common.tree_index(caches, i)
        h = common.norm_apply(cfg, lp["norm1"], x)
        y, _ = attention.attn_decode(cfg, lp["attn"], h, cache["self"],
                                     index=index, use_rope=False)
        x = x + y
        h = common.norm_apply(cfg, lp["norm2"], x)
        x = x + _cross_decode(cfg, lp["xattn"], h, cache["xk"], cache["xv"])
        h = common.norm_apply(cfg, lp["norm3"], x)
        x = x + mlp.mlp_apply(cfg, lp["mlp"], h)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(params, x), caches


# ---------------------------------------------------------------------------
# tensor parallelism over a model axis (module docstring)
# ---------------------------------------------------------------------------

def _heads_tp(cfg, ranks, name, axis, run):
    """The attention ``name`` of every held rank at its local heads,
    ``run(lcfg, lp, j)`` giving (partial output, anything beside it):
    (the sum over the axis with the ``o`` bias once, what ``run`` gave
    beside each)."""
    parts, extra, bias = [], [], None
    for j, (r, p) in enumerate(zip(axis.held, ranks)):
        lcfg, lp, bias = attention.local_params(cfg, p[name], r, axis.n)
        y, e = run(lcfg, lp, j)
        parts.append(y)
        extra.append(e)
    return transformer._reduce(axis, parts, bias), extra


def _mlp_tp(cfg, ranks, h, axis):
    f, bias, _ = transformer._ffn_tp(cfg, ranks, h, axis.copy(h), axis)
    return transformer._reduce(axis, f, bias)


def _encode_tp(cfg, ranks, frames, axis):
    x = _frames_in(cfg, ranks[0]["frame_proj"], frames)
    positions = _arange(x.shape[1], x.device)
    for i in range(cfg.encoder_layers):
        lranks = [common.tree_index(p["enc_layers"], i) for p in ranks]
        hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm1"], x))
        y, _ = _heads_tp(cfg, lranks, "attn", axis, lambda lcfg, lp, j: (
            attention.attn_apply(lcfg, lp, hs[j], positions=positions,
                                 causal=False, use_rope=False), None))
        x = x + y
        x = x + _mlp_tp(cfg, lranks, common.norm_apply(
            cfg, lranks[0]["norm2"], x), axis)
    return common.norm_apply(cfg, ranks[0]["enc_norm"], x)


def _dec_layer_tp(cfg, lranks, x, encs, positions, enc_positions, axis):
    """One decoder layer over the axis on a whole sequence, no caches:
    ``encs`` the ranks' copies of the encoder output (``axis.copy``)."""
    hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm1"], x))
    x = x + _heads_tp(cfg, lranks, "attn", axis, lambda lcfg, lp, j: (
        attention.attn_apply(lcfg, lp, hs[j], positions=positions,
                             causal=True, use_rope=False), None))[0]
    hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm2"], x))
    x = x + _heads_tp(cfg, lranks, "xattn", axis, lambda lcfg, lp, j: (
        attention.attn_apply(lcfg, lp, hs[j], positions=positions,
                             causal=False, kv_x=encs[j],
                             kv_positions=enc_positions, use_rope=False),
        None))[0]
    return x + _mlp_tp(cfg, lranks, common.norm_apply(
        cfg, lranks[0]["norm3"], x), axis)


def _sequence_tp(cfg, ranks, tokens, frames, axis, remat=False):
    """The encoder and the teacher-forced decoder over the axis: the
    final-normed decoder output, replicated.  ``remat`` recomputes each
    decoder layer in the backward pass (``transformer._replay``)."""
    encs = axis.copy(_encode_tp(cfg, ranks, frames, axis))
    x = transformer._embed_tp(cfg, ranks, tokens, axis)
    x = x + common.sinusoid_pos(x.shape[1], cfg.d_model,
                                x.device).to(x.dtype)
    positions = _arange(x.shape[1], x.device)
    enc_positions = _arange(encs.shape[-2], x.device)
    for i in range(cfg.num_layers):
        lranks = [common.tree_index(p["layers"], i) for p in ranks]
        x = transformer._replay(remat, cfg, _dec_layer_tp, cfg, lranks, x,
                                encs, positions, enc_positions, axis)
    return common.norm_apply(cfg, ranks[0]["final_norm"], x)


def loss_tp(cfg: ArchConfig, params, split, tokens: torch.Tensor,
            frames: torch.Tensor, labels: torch.Tensor, axis, *,
            sequence_parallel: bool = False, remat: bool = False):
    """The training loss over a model axis (``transformer.loss_tp``'s
    form, which hands over here): ``(Σ nll, Σ mask, None)``, replicated,
    differentiable through the axis (module docstring).

    ``sequence_parallel`` takes this same path, each region's exit one
    all-reduce.  The reference keeps the residual stream whole between
    Whisper's layers (``constrain(x, "batch", "seq", None)`` at each
    layer's end) and marks only the attention's and the MLP's outputs
    ``seq_sp``: each such exit is a reduce-scatter whose slices the next
    norm's region, or the layer's end, gathers again at once.  A ring
    all-reduce is that reduce-scatter and all-gather: the same bytes, the
    same values, with no norm on slices and no per-rank copy of the
    replicated leaves; so the exchanges are the ones without sequence
    parallelism (``transformer.train_exchanges``)."""
    params = transformer._train_ranks(params, split, axis, False)
    ranks = transformer._rank_trees(params, axis)
    x = _sequence_tp(cfg, ranks, tokens, frames, axis, remat)
    split_vocab = params["embed"]["embedding"].shape[1] != cfg.vocab_size
    return (*transformer._xent_tp(cfg, ranks, x, labels, axis, split_vocab),
            None)


def _decoder_tp(cfg, params, tokens, frames, cache_len, axis,
                all_positions=False):
    """``prefill`` (or, ``all_positions``, ``forward``) over the axis:
    each held rank's self-attention caches and cross K/V at its local kv
    heads."""
    transformer.check_tp(cfg, axis.n)
    ranks = transformer._rank_trees(params, axis)
    if all_positions:
        x = _sequence_tp(cfg, ranks, tokens, frames, axis)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return transformer._logits_tp(cfg, ranks, x, axis), \
            {"lb_loss": zero, "z_loss": zero}
    enc_out = _encode_tp(cfg, ranks, frames, axis)
    x = transformer._embed_tp(cfg, ranks, tokens, axis)
    x = x + common.sinusoid_pos(x.shape[1], cfg.d_model,
                                x.device).to(x.dtype)
    positions = _arange(x.shape[1], x.device)
    enc_positions = _arange(enc_out.shape[1], x.device)
    B, T = enc_out.shape[:2]
    per_layer = []
    for i in range(cfg.num_layers):
        lranks = [common.tree_index(p["layers"], i) for p in ranks]
        hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm1"], x))
        y, made = _heads_tp(cfg, lranks, "attn", axis, lambda lcfg, lp, j: (
            attention.attn_apply(lcfg, lp, hs[j], positions=positions,
                                 causal=True, use_rope=False,
                                 return_cache=True, cache_len=cache_len)))
        x = x + y
        hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm2"], x))

        def cross(lcfg, lp, j):
            y = attention.attn_apply(
                lcfg, lp, hs[j], positions=positions, causal=False,
                kv_x=enc_out, kv_positions=enc_positions, use_rope=False)
            Kvl, hd = lcfg.num_kv_heads, lcfg.hd
            return y, (common.dense(lp["k"], enc_out).reshape(B, T, Kvl, hd),
                       common.dense(lp["v"], enc_out).reshape(B, T, Kvl, hd))
        y, kv = _heads_tp(cfg, lranks, "xattn", axis, cross)
        x = x + y
        x = x + _mlp_tp(cfg, lranks, common.norm_apply(
            cfg, lranks[0]["norm3"], x), axis)
        per_layer.append([{"self": s, "xk": k, "xv": v}
                          for s, (k, v) in zip(made, kv)])
    x = common.norm_apply(cfg, ranks[0]["final_norm"], x[:, -1:])
    caches = common.tree_stack([common.tree_stack([layer[j] for layer in
                                                   per_layer])
                                for j in range(len(ranks))])
    return transformer._logits_tp(cfg, ranks, x, axis), caches


def _decode_step_tp(cfg, params, tokens, caches, index, axis):
    transformer.check_tp(cfg, axis.n)
    ranks = transformer._rank_trees(params, axis)
    cranks = transformer._rank_trees(caches, axis)
    x = _decode_pos(cfg, transformer._embed_tp(cfg, ranks, tokens, axis),
                    index)
    for i in range(cfg.num_layers):
        lranks = [common.tree_index(p["layers"], i) for p in ranks]
        cache = [common.tree_index(c, i) for c in cranks]
        hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm1"], x))
        y, _ = _heads_tp(cfg, lranks, "attn", axis, lambda lcfg, lp, j: (
            attention.attn_decode(lcfg, lp, hs[j], cache[j]["self"],
                                  index=index, use_rope=False)[0], None))
        x = x + y
        hs = axis.copy(common.norm_apply(cfg, lranks[0]["norm2"], x))
        y, _ = _heads_tp(cfg, lranks, "xattn", axis, lambda lcfg, lp, j: (
            _cross_decode(lcfg, lp, hs[j], cache[j]["xk"], cache[j]["xv"]),
            None))
        x = x + y
        x = x + _mlp_tp(cfg, lranks, common.norm_apply(
            cfg, lranks[0]["norm3"], x), axis)
    x = common.norm_apply(cfg, ranks[0]["final_norm"], x)
    return transformer._logits_tp(cfg, ranks, x, axis), caches


def decode_exchanges(cfg: ArchConfig, n: int) -> dict:
    """The exchanges one decode tick makes over a ``model`` axis of ``n``
    ranks, by kind (``{}`` for one rank): each decoder layer's self
    attention, cross attention and MLP exit with one all-reduce each, ``3
    L``; where the axis splits the vocabulary the embedding adds one
    all-reduce and the logits one all-gather (not Whisper's 51,865)."""
    if n == 1:
        return {}
    ends = 0 if cfg.vocab_size % n else 1
    return {k: v for k, v in (("all-reduce", 3 * cfg.num_layers + ends),
                              ("all-gather", ends)) if v}
