"""FlashAttention-2 forward: CUDA kernel wrapper + plain PyTorch version.

Causal and/or sliding-window attention with GQA (kv head = q head //
rep, no materialised repeat) over ``q (B,S,H,hd)``, ``k, v (B,S,Kv,hd)``,
any ``S`` (the ragged tail is masked, never padded).

* :func:`flash_attention_fwd` — the wrapper of the CUDA kernel
  ``csrc/flash_attention.cu`` (counterpart of the TPU kernel
  ``repro/kernels/flash_attention.py:flash_attention_fwd``): bf16 runs
  both products on the tensor cores (``wgmma``, P rounded to bf16 for the
  second one, as SDPA does), f32 on the CUDA cores (no TF32).  On a CUDA
  tensor it launches the kernel or raises; only a tensor that lies on the
  CPU takes the plain version.  Head dim 120 runs on tiles padded to
  128 zero columns in shared memory (no padded copy in device memory);
  its ``sm_scale`` stays ``120 ** -0.5``.
* :func:`flash_attention_torch` — the plain version: the same blockwise
  online softmax over key blocks, in PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 120, 128)   # 120 (H2O-Danube3-4B): tiles padded
#                                      to 128 columns in shared memory only

LAUNCHES = 0      # kernel launches made by flash_attention_fwd


def _geometry(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (B,S,H,hd) and k, v "
                         f"(B,S,Kv,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd \
            or Kv == 0 or H % Kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (self-attention, H % Kv == 0)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return B, S, H, Kv, hd


def flash_attention_torch(q, k, v, *, causal=True, window=0, sm_scale=None,
                          block_k=128):
    """Plain PyTorch blockwise attention (any device, any ``S``): key
    blocks of ``block_k`` folded into an f32 online softmax ``(acc, m,
    l)``; masked entries are *selected* to probability 0, which also
    guards key blocks a query row cannot see at all."""
    B, S, H, Kv, hd = _geometry(q, k, v, window)
    rep = H // Kv
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    dev = q.device
    qh = q.reshape(B, S, Kv, rep, hd).float() * sm_scale
    acc = torch.zeros((B, Kv, rep, S, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Kv, rep, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, rep, S), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    qpos = torch.arange(S, device=dev)[:, None]
    for k0 in range(0, S, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        kpos = torch.arange(k0, min(k0 + block_k, S), device=dev)[None, :]
        mask = torch.ones((S, kpos.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.einsum("bqgrh,bsgh->bgrqs", qh, kb)
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), zero)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqs,bsgh->bgrqh",
                                                    p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]           # (B,Kv,rep,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, sm_scale=None):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd) -> (B, S, H, hd) in q's dtype.

    On CUDA tensors this launches ``flash_attention_fwd`` on the current
    stream (no synchronisation) and counts the launch in ``LAUNCHES``; the
    ``(B,S,H,hd)`` layout is read through its strides (no transpose, no
    padded copy).  It raises on a type, shape or layout the kernel does
    not take.  CPU tensors take :func:`flash_attention_torch`."""
    global LAUNCHES
    _build.check_no_grad("flash_attention_fwd", q, k, v)
    if not q.is_cuda:
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)
    B, S, H, Kv, hd = _geometry(q, k, v, window)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    vec = 16 // q.element_size()          # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows of hd must be dense and "
                             f"16-byte aligned (strides {t.stride()})")
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = _build.lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Kv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(sm_scale), int(bool(causal)), int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention_fwd")
    LAUNCHES += 1
    return out
