"""Grouped-query attention: full-sequence path + KV-cache decode path.

Counterpart of ``repro/models/attention.py``.  Full-sequence self
attention (forward, prefill, an encoder) goes through
``kernels/ops.flash_attention`` — the hand-written CUDA kernel on the
card, its plain blockwise version on the CPU — so the (S x S) score matrix
is never materialised.  Under ``attention_impl="chunked"`` it takes the
reference's XLA branch instead (queries in chunks of ``_chunk_size(S)``, a
masked softmax over all keys with the detached max): plain PyTorch that
autograd differentiates, the path training runs, as the reference trains
through it.  Cross attention (``kv_x``, an encoder's output as keys and
values) always takes that branch, as the reference routes only self
attention with as many keys as queries to its kernel.

Decode keeps a cache ``{"k", "v": (B, L, Kv, hd), "pos": (B, L)}``.  Where
the reference carries ONE scalar position for the whole batch and gets a
per-slot position by vmapping a batch-1 step, the port's ``attn_decode``
takes an ``index`` that is a scalar or a ``(B,)`` vector, and ``pos`` has
a row per batch element.  ``attn_decode`` writes the new token into the
cache **in place** (the reference donates the buffer to the same end).

A sliding-window layer keeps its cache as a ring, as the reference does
(``repro/models/attention.py:144-216``): slot = position % window, so the
cache never holds more than ``window`` slots however long the request
runs, and decode masks with ``cpos > index - window`` as well.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common

NEG_INF = -1e30      # mask value: finite, so a fully masked row stays NaN-free


def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    H, Kv, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    dt = common.dtype_of(cfg)
    return {
        "q": common.dense_init(gen, D, H * hd, dt, cfg.use_bias),
        "k": common.dense_init(gen, D, Kv * hd, dt, cfg.use_bias),
        "v": common.dense_init(gen, D, Kv * hd, dt, cfg.use_bias),
        "o": common.dense_init(gen, H * hd, D, dt, cfg.use_bias,
                               scale=float((H * hd) ** -0.5)),
    }


# ---------------------------------------------------------------------------
# tensor parallelism: one rank's heads
# ---------------------------------------------------------------------------

def check_heads(cfg: ArchConfig, n: int) -> None:
    """A ``model`` axis of ``n`` splits whole query heads, and the kv heads
    either evenly or, where there are fewer than ``n``, one a rank."""
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    if H % n or (Kv % n and n % Kv):
        raise ValueError(
            f"{cfg.name}: {H} query and {Kv} kv heads do not split over a "
            f"model axis of {n} (the query heads must divide evenly, and "
            f"the kv heads divide evenly or divide the axis)")


def local_kv_heads(cfg: ArchConfig, n: int) -> int:
    """The kv heads a rank of a ``model`` axis of ``n`` holds."""
    return cfg.num_kv_heads // n if cfg.num_kv_heads % n == 0 else 1


def local_params(cfg: ArchConfig, p: dict, rank: int, n: int):
    """``(local cfg, params, o bias)`` of rank ``rank`` of a ``model`` axis
    of ``n``: its ``H / n`` query heads (column-parallel ``q``), the kv
    heads they read (its ``k`` / ``v`` columns, or, where the kv heads are
    fewer than the ranks and so replicated, the one head of its group),
    and its rows of the row-parallel ``o`` without the bias, which the
    caller adds once after the reduction.  Views, no copies."""
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    Hl, Kvl = H // n, local_kv_heads(cfg, n)
    lp = {"q": {"kernel": p["q"]["kernel"]}, "o": {"kernel": p["o"]["kernel"]}}
    if "bias" in p["q"]:
        lp["q"]["bias"] = p["q"]["bias"][rank * Hl * hd:(rank + 1) * Hl * hd]
    kv_split = p["k"]["kernel"].shape[-1] == Kvl * hd
    head = rank * Kvl if Kv % n == 0 else rank // (n // Kv)
    cols = slice(head * hd, (head + Kvl) * hd)
    for part in ("k", "v"):
        kernel = p[part]["kernel"]
        lp[part] = {"kernel": kernel if kv_split else kernel[:, cols]}
        if "bias" in p[part]:
            lp[part]["bias"] = p[part]["bias"][cols]
    lcfg = dataclasses.replace(cfg, num_heads=Hl, num_kv_heads=Kvl,
                               head_dim=hd)
    return lcfg, lp, p["o"].get("bias")


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _softmax_masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = torch.where(mask, scores, scores.new_tensor(NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m.detach())
    return e / e.sum(dim=-1, keepdim=True)


def _chunk_size(seq: int) -> int:
    if seq <= 1024:
        return seq
    return 256 if seq >= 16384 else 512


def _gqa_scores(q, k):
    """q: (B, cq, Kv, rep, hd), k: (B, S, Kv, hd) -> (B, Kv, rep, cq, S)
    f32 (products of the working dtype summed in f32, as the reference's
    ``preferred_element_type``)."""
    return torch.einsum("bqgrh,bsgh->bgrqs", q.float(), k.float())


def _gqa_out(probs, v):
    """probs: (B, Kv, rep, cq, S), v: (B, S, Kv, hd) -> (B, cq, Kv, rep, hd)."""
    return torch.einsum("bgrqs,bsgh->bqgrh", probs.to(v.dtype), v)


def _chunked_attention(cfg: ArchConfig, q, k, v, positions, causal, window,
                       kv_pos=None):
    """The reference's XLA branch: q (B,S,H,hd), k, v (B,Sk,Kv,hd) ->
    (B, S, H*hd); ``kv_pos`` (Sk,) are the keys' positions (default: the
    queries').  Its ``lax.scan`` over query chunks is a loop here."""
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B, S = q.shape[:2]
    kv_pos = positions if kv_pos is None else kv_pos
    Sk = k.shape[1]
    q = q.reshape(B, S, Kv, H // Kv, hd) * (hd ** -0.5)
    cq = _chunk_size(S)
    if S % cq:
        raise ValueError(f"sequence {S} is not a multiple of its query "
                         f"chunk {cq} (the reference asserts the same)")
    outs = []
    for c0 in range(0, S, cq):
        pos_q = positions[c0:c0 + cq]
        mask = torch.ones((cq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_pos[None, :] <= pos_q[:, None]
        if window:
            mask &= kv_pos[None, :] > pos_q[:, None] - window
        probs = _softmax_masked(_gqa_scores(q[:, c0:c0 + cq], k), mask)
        outs.append(_gqa_out(probs, v))                # (B,cq,Kv,rep,hd)
    return torch.cat(outs, dim=1).reshape(B, S, H * hd)


def attn_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
               positions: torch.Tensor, causal: bool = True,
               window: int = 0, kv_x: Optional[torch.Tensor] = None,
               kv_positions: Optional[torch.Tensor] = None,
               use_rope: bool = True, return_cache: bool = False,
               cache_len: Optional[int] = None):
    """Full-sequence attention (forward / prefill / encoder / cross).

    x: (B, S, D); kv_x: the keys' and values' source for cross attention
    (default x); positions: (S,) absolute positions of the queries,
    kv_positions those of the keys (default positions).
    Returns y (B, S, D) and, if return_cache, the {k, v, pos} cache.
    """
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    B, S, _ = x.shape
    kv_src = x if kv_x is None else kv_x
    kv_pos = positions if kv_positions is None else kv_positions
    Sk = kv_src.shape[1]
    q = _split_heads(common.dense(p["q"], x), H, hd)          # (B,S,H,hd)
    k = _split_heads(common.dense(p["k"], kv_src), Kv, hd)    # (B,Sk,Kv,hd)
    v = _split_heads(common.dense(p["v"], kv_src), Kv, hd)
    if use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, kv_pos, cfg.rope_theta)
    if runtime.impl("attention_impl") == "chunked" or kv_x is not None:
        out = _chunked_attention(cfg, q, k, v, positions, causal, window,
                                 kv_pos)
    else:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    y = common.dense(p["o"], out.reshape(B, S, H * hd))
    if not return_cache:
        return y
    return y, _make_prefill_cache(cfg, k, v, kv_pos, window,
                                  cache_len or Sk)


def _make_prefill_cache(cfg, k, v, kv_pos, window, cache_len):
    """Cache from prefill keys/values, sized for continued decoding: full
    attention pads out to ``cache_len`` (pos = -1 marks empty slots).

    A windowed layer's cache is a ring (slot = position % window).  A
    prompt longer than the window keeps its last ``window`` keys, rolled
    by ``S % window`` so that each lands in its ring slot; a shorter one
    keeps its ``S`` keys in slots 0..S-1 (slot = position) and pads out to
    ``min(cache_len, window)`` — with the default ``cache_len = S`` that is
    no padding at all, and with ``cache_len >= window`` it is the
    reference's full ring."""
    B, S = k.shape[:2]
    pos = kv_pos.to(torch.int32)
    if window:
        if S > window:
            k, v, pos = k[:, -window:], v[:, -window:], pos[-window:]
            r = S % window
            if r:
                k = torch.roll(k, r, dims=1)
                v = torch.roll(v, r, dims=1)
                pos = torch.roll(pos, r, dims=0)
        target = max(k.shape[1], min(cache_len, window))
    else:
        target = max(cache_len, S)
    pos = pos[None].expand(B, k.shape[1])
    if k.shape[1] < target:
        pad = target - k.shape[1]
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    return {"k": k, "v": v, "pos": pos.contiguous()}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """Empty decode cache (``cache_len`` is the ring's size for a windowed
    layer)."""
    Kv, hd = cfg.num_kv_heads, cfg.hd
    dt = common.dtype_of(cfg)
    return {"k": torch.zeros((batch, cache_len, Kv, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, cache_len, Kv, hd), dtype=dt,
                             device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


def attn_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict, *,
                index, window: int = 0, use_rope: bool = True):
    """One-token decode step.  x: (B, 1, D); index: the current position,
    a scalar or a (B,) tensor (one position per batch row).  The cache is
    updated in place and returned; a windowed layer writes each row at
    ring slot ``index % window``."""
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = H // Kv
    B = x.shape[0]
    idx = torch.as_tensor(index, device=x.device).to(torch.int64)
    idx = idx.expand(B) if idx.dim() == 0 else idx

    q = _split_heads(common.dense(p["q"], x), H, hd)
    k = _split_heads(common.dense(p["k"], x), Kv, hd)
    v = _split_heads(common.dense(p["v"], x), Kv, hd)
    pos = idx[:, None]                                        # (B, 1)
    if use_rope:
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)

    rows = torch.arange(B, device=x.device)
    slot = idx % window if window else idx
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = idx.to(cpos.dtype)

    qh = q.reshape(B, 1, Kv, rep, hd) * (hd ** -0.5)
    scores = _gqa_scores(qh, ck)                              # (B,Kv,rep,1,L)
    valid = (cpos >= 0) & (cpos <= idx[:, None])              # (B, L)
    if window:
        valid &= cpos > (idx - window)[:, None]
    probs = _softmax_masked(scores, valid[:, None, None, None, :])
    out = torch.einsum("bgrqs,bsgh->bqgrh", probs.to(cv.dtype), cv)
    y = common.dense(p["o"], out.reshape(B, 1, H * hd))
    return y, cache
