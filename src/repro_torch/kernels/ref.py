"""Naive PyTorch oracles for the kernels (the ground truth in tests).

Counterparts of ``repro/kernels/ref.py``: full-softmax attention with the
whole score matrix materialised, no blocking and no online softmax, and
the WKV-6 recurrence one step at a time, so they share no arithmetic with
the kernels or their plain versions; the int8 quantization is the
reference's formula as written (its kernel is that formula already).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, sm_scale=None):
    """Naive full-softmax GQA attention.

    q: (B, S, H, hd); k, v: (B, Sk, Kv, hd).  Returns (B, S, H, hd).
    """
    B, S, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    qh = q.reshape(B, S, Kv, rep, hd).float() * sm_scale
    scores = torch.einsum("bqgrh,bsgh->bgrqs", qh, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqs,bsgh->bqgrh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def paged_attention_ref(q, pool, tables, lengths, *, sm_scale=None):
    """Naive paged decode attention: gather every table page, full softmax.

    q: (S, H, hd) one decode token per sequence; pool: (n_pages,
    page_size, 2*Kv, hd) head-interleaved K/V; tables: (S, max_pages)
    page ids; lengths: (S,) valid tokens.  Returns (S, H, hd).
    """
    S, H, hd = q.shape
    _, page_size, kv2, _ = pool.shape
    n_kv = kv2 // 2
    rep = H // n_kv
    max_pages = tables.shape[1]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    kv = pool[tables.long()].reshape(          # (S, max_pages, ps, 2Kv, hd)
        S, max_pages * page_size, n_kv, 2, hd).float()
    k, v = kv[..., 0, :], kv[..., 1, :]
    qh = q.reshape(S, n_kv, rep, hd).float() * sm_scale
    scores = torch.einsum("sgrh,stgh->sgrt", qh, k)
    pos = torch.arange(max_pages * page_size, device=q.device)
    mask = pos[None] < lengths[:, None]
    scores = torch.where(mask[:, None, None], scores,
                         scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("sgrt,stgh->sgrh", probs, v)
    return out.reshape(S, H, hd).to(q.dtype)


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """Naive per-step WKV-6 recurrence.

    r,k,v,w: (B, T, H, dh) f32 (w in (0,1)); u: (H, dh).
    Returns (y (B,T,H,dh), S_T (B,H,dh,dh))."""
    B, T, H, dh = r.shape
    S = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device) \
        if s0 is None else s0
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]      # (B,H,dh)
        y = torch.einsum("bhd,bhde->bhe", rt, S)
        y = y + torch.sum(rt * u * kt, -1, keepdim=True) * vt
        S = wt[..., None] * S + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), S


SCALE_FLOOR = 1e-12
# f32(1/127), exactly representable as a Python float: the reference's scale
# is amax * this, not amax / 127.  XLA rewrites a division by a constant into
# a product with its f32 reciprocal, in the Pallas kernel
# (``repro/kernels/quant.py:_quant_kernel``) and in the jnp path under jit
# alike, and the two differ in the last bit for about 4% of rows; only an
# eager jnp call divides.  ``x / scale`` stays a true division everywhere.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8_ref(x):
    """Rowwise symmetric int8 quantization.  x: (..., C)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, SCALE_FLOOR) * INV127
    q = torch.clip(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.float()


def dequantize_int8_ref(q, scale):
    return q.float() * scale
