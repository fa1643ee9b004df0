"""RWKV-6 "Finch": time mix with data-dependent decay + channel mix.

Counterpart of ``repro/models/rwkv6.py``.  The WKV recurrence per head
(state S in R^{dk x dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = S_{t-1}^T r_t + (r_t . u . k_t) v_t
A prompt of more than one token goes through ``ops.rwkv6_scan`` (the
chunked form: the CUDA kernel ``csrc/rwkv6_scan.cu``, or its plain
version under ``rwkv_impl="torch"``); one token takes :func:`wkv_step`, in
plain PyTorch, as in the reference, which has no kernel for it.

The dtype flow is the reference's: the f32 leaves (``mix_x``,
``mix_base``, ``time_decay``, ``time_first``, ``ln_x``, ``mix_k``,
``mix_r``) stay f32 in a bf16 model; the token-shift mixes are cast to the
activation dtype, the decay LoRA's second product runs in f32, the scan
takes f32 heads, and the per-head group norm runs in f32 and casts back.

Both ``*_apply`` functions are functional, as the reference's: they
return the new state, and the caller (``transformer._layer_decode``)
writes it into the slot cache in place.

Over a ``model`` axis (``models/transformer.py``) a rank's time mix runs
at its ``H / n`` heads (:func:`local_time_mix`: its columns of ``r`` /
``k`` / ``v`` / ``g``, of ``time_decay`` and ``time_first``, of the
replicated decay LoRA's output and of ``ln_x``; its rows of the
row-parallel ``o``); the token-shift LoRA factors are replicated (the
reference's rule: sharding them would turn each LoRA into an all-reduce),
and ``_group_norm`` is per head, so it stays in the rank.  The decode
state's ``wkv`` lives in the rank at its heads, the token shifts are
replicated.  In the channel mix ``wk`` is column-parallel and ``wv``
row-parallel, summed over the ranks; ``wr`` is split on its output, so
``sigmoid(r) * kv`` is taken on the rank's slice and gathered
(:func:`channel_mix_parts`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import common

N_MIX = 5  # w, k, v, r, g
GROUP_NORM_EPS = 1e-5     # ln_x's eps (the shared norms use 1e-6)


def _dims(cfg: ArchConfig):
    dh = cfg.rwkv_head_dim
    H = cfg.d_model // dh
    return H, dh


def _full(shape, value, device):
    return torch.full(shape, value, dtype=torch.float32, device=device)


def time_mix_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    R = cfg.rwkv_lora_rank
    dt = common.dtype_of(cfg)
    dev = gen.device
    return {
        "r": common.dense_init(gen, D, D, dt),
        "k": common.dense_init(gen, D, D, dt),
        "v": common.dense_init(gen, D, D, dt),
        "g": common.dense_init(gen, D, D, dt),
        "o": common.dense_init(gen, D, D, dt, scale=float(D ** -0.5) * 0.5),
        "mix_x": _full((D,), 0.5, dev),
        "mix_base": _full((N_MIX, D), 0.5, dev),
        "mix_lora_a": common.dense_init(gen, D, N_MIX * R, dt),
        "mix_lora_b": {"kernel": common._normal(gen, (N_MIX, R, D), 0.01,
                                                dt)},
        # mild decay spectrum: the base log-log decay of each channel
        "time_decay": torch.linspace(-6.0, -0.5, D, dtype=torch.float32,
                                     device=dev),
        "w_lora_a": common.dense_init(gen, D, R, dt),
        "w_lora_b": common.dense_init(gen, R, D, dt, scale=0.01),
        "time_first": _full((D,), 0.5, dev),    # bonus u, flat (H*dh,)
        "ln_x": {"scale": _full((D,), 1.0, dev),
                 "bias": _full((D,), 0.0, dev)},
    }


def _token_shift(x, prev):
    """x_{t-1} stream.  prev: (B, 1, D) carried last token, or None."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x, xprev):
    """Data-dependent token-shift mixes -> (w, k, v, r, g) inputs, each
    (B, T, D)."""
    sx = xprev - x
    xxx = x + sx * p["mix_x"].to(x.dtype)
    R = p["mix_lora_a"]["kernel"].shape[1] // N_MIX
    lora = torch.tanh(common.dense(p["mix_lora_a"], xxx))
    lora = lora.reshape(*lora.shape[:-1], N_MIX, R)
    mixes = torch.einsum("btnr,nrd->btnd", lora, p["mix_lora_b"]["kernel"])
    mixes = mixes + p["mix_base"].to(x.dtype)
    return [x + sx * mixes[:, :, i] for i in range(N_MIX)]


def wkv_step(r, k, v, w, u, S):
    """Single-token WKV.  r, k, v, w: (B, H, dh); S: (B, H, dh, dh).
    Returns (y (B, H, dh), new S)."""
    y = torch.einsum("bhd,bhde->bhe", r, S)
    y = y + torch.sum(r * u * k, dim=-1, keepdim=True) * v
    S = w[..., None] * S + k[..., None] * v[:, :, None, :]
    return y, S


def _group_norm(p: dict, x, H: int):
    """Per-head layer norm (ln_x) in f32.  x: (B, T, D) -> f32."""
    B, T, D = x.shape
    xh = x.reshape(B, T, H, D // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = torch.mean(torch.square(xh - mean), dim=-1, keepdim=True)
    xh = (xh - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    return xh.reshape(B, T, D) * p["scale"] + p["bias"]


def local_time_mix(p: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s time-mix params over a ``model`` axis of ``n``
    (module docstring): the split leaves as they are, the replicated
    leaves it reads at its channels sliced to them (views)."""
    Dl = p["o"]["kernel"].shape[0]
    cols = slice(rank * Dl, (rank + 1) * Dl)
    return dict(p, w_lora_b={"kernel": p["w_lora_b"]["kernel"][:, cols]},
                ln_x={k: v[cols] for k, v in p["ln_x"].items()})


def time_mix_apply(cfg: ArchConfig, p: dict, x, state=None):
    """x: (B, T, D).  state: None | {'shift': (B,1,D), 'wkv': (B,H,dk,dv)}.
    ``p`` may be a rank's (:func:`local_time_mix`): it then runs at the
    rank's heads, and the output is its partial sum.

    Returns (y, new_state); ``new_state['shift']`` is the last token of
    ``x`` (the block's normed input)."""
    B, T, _ = x.shape
    dh = cfg.rwkv_head_dim
    H = p["time_first"].shape[-1] // dh
    D = H * dh
    prev = state["shift"] if state else None
    xw, xk, xv, xr, xg = _ddlerp(p, x, _token_shift(x, prev))
    r = common.dense(p["r"], xr)
    k = common.dense(p["k"], xk)
    v = common.dense(p["v"], xv)
    g = F.silu(common.dense(p["g"], xg))
    ww = p["time_decay"] + torch.tanh(common.dense(p["w_lora_a"], xw)
                                      ).float() \
        @ p["w_lora_b"]["kernel"].float()
    w = torch.exp(-torch.exp(ww))                     # (B,T,D) in (0,1)

    def heads(z):
        return z.reshape(B, T, H, dh).float()

    u = p["time_first"].float().reshape(H, dh)
    s0 = state["wkv"] if state else None
    if T == 1:
        if s0 is None:
            s0 = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                             device=x.device)
        y1, S = wkv_step(heads(r)[:, 0], heads(k)[:, 0], heads(v)[:, 0],
                         heads(w)[:, 0], u, s0)
        y = y1[:, None]
    else:
        y, S = ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(w), u, s0)
    y = _group_norm(p["ln_x"], y.reshape(B, T, D), H).to(x.dtype)
    out = common.dense(p["o"], y * g)
    return out, {"shift": x[:, -1:], "wkv": S}


def channel_mix_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg)
    return {
        "mix_k": _full((D,), 0.5, gen.device),
        "mix_r": _full((D,), 0.5, gen.device),
        "wk": common.dense_init(gen, D, Fd, dt),
        "wv": common.dense_init(gen, Fd, D, dt),
        "wr": common.dense_init(gen, D, D, dt),
    }


def channel_mix_parts(cfg: ArchConfig, p: dict, x, state=None):
    """``(kv, r, new state)`` of the channel mix: over a ``model`` axis
    ``kv`` is the rank's partial sum (``wv`` row-parallel) and ``r`` its
    slice of the receptance (``wr`` split on its output)."""
    xprev = _token_shift(x, state)
    xk = x + (xprev - x) * p["mix_k"].to(x.dtype)
    xr = x + (xprev - x) * p["mix_r"].to(x.dtype)
    k = torch.square(torch.relu(common.dense(p["wk"], xk)))
    return common.dense(p["wv"], k), common.dense(p["wr"], xr), x[:, -1:]


def channel_mix_apply(cfg: ArchConfig, p: dict, x, state=None):
    """x: (B, T, D); state: None | (B, 1, D) carried last token.
    Returns (y, new_state = the last token of x)."""
    kv, r, shift = channel_mix_parts(cfg, p, x, state)
    return torch.sigmoid(r) * kv, shift
