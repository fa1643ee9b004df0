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
"""
from __future__ import annotations

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mlp


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


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor):
    """frames: (B, T, D) precomputed frame embeddings (frontend stub),
    cast to the model's dtype (bf16 frames into an f32 model: the
    reference's type promotion)."""
    proj = params["frame_proj"]
    x = common.dense(proj, frames.to(proj["kernel"].dtype))
    x = x + common.sinusoid_pos(x.shape[1], cfg.d_model,
                                x.device).to(x.dtype)
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
            frames: torch.Tensor, remat: bool = False):
    """Teacher-forced training forward.  Returns (logits, aux); ``remat``
    recomputes each decoder layer in the backward pass, as the reference
    checkpoints its decoder layers."""
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
            frames: torch.Tensor, cache_len=None):
    """Encode + teacher-forced decoder pass, returning decode caches.

    Cross-attention K/V are computed once from the encoder output and
    stored in the cache (``xk``, ``xv``: (L, B, T_frames, Kv, hd)); the
    self-attention caches hold the prompt tokens, padded to
    ``cache_len``."""
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
                       enc_len: int, device):
    """Empty caches stacked over the decoder layers."""
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


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                caches, index):
    """tokens: (B, 1); index: a scalar or (B,) positions.  Cross attention
    reads the cached encoder K/V; the self-attention caches are written in
    place.  Returns (logits (B, 1, V) f32, caches)."""
    x = params["embed"]["embedding"][tokens.long()]
    # the absolute sinusoid at each row's decode index
    D = cfg.d_model
    idx = torch.as_tensor(index, device=x.device).to(torch.float32)
    ang = idx[..., None] * common.sinusoid_freqs(D, x.device)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :D]
    x = x + (pe[:, None] if pe.dim() == 2 else pe).to(x.dtype)
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B = x.shape[0]
    for i in range(cfg.num_layers):
        lp = common.tree_index(params["layers"], i)
        cache = common.tree_index(caches, i)
        h = common.norm_apply(cfg, lp["norm1"], x)
        y, _ = attention.attn_decode(cfg, lp["attn"], h, cache["self"],
                                     index=index, use_rope=False)
        x = x + y
        h = common.norm_apply(cfg, lp["norm2"], x)
        # cross attention against the cached encoder K/V
        q = common.dense(lp["xattn"]["q"], h).reshape(B, 1, Kv, H // Kv, hd)
        scores = attention._gqa_scores(q * (hd ** -0.5), cache["xk"])
        probs = torch.softmax(scores, dim=-1)
        out = attention._gqa_out(probs, cache["xv"]).reshape(B, 1, H * hd)
        x = x + common.dense(lp["xattn"]["o"], out)
        h = common.norm_apply(cfg, lp["norm3"], x)
        x = x + mlp.mlp_apply(cfg, lp["mlp"], h)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return _logits(params, x), caches
