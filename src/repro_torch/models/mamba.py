"""Mamba-1 selective-SSM block (Jamba's sequence mixer).

Counterpart of ``repro/models/mamba.py``.  The selective scan
``h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t x_t``, ``y_t = h_t . C_t`` runs over
chunks of ``CHUNK`` steps (the reference's blocking; a sequence longer
than one chunk must be a whole number of them, as the reference asserts).
Where the reference evaluates a chunk with ``jax.lax.associative_scan``,
the port steps through it sequentially: the same recurrence, in f32, with
the products taken in another order (held within 2e-5 of the reference at
f32 by ``tests/test_torch_families.py``).  There is no kernel here — the
reference's scan is jnp too.

The casts are the reference's, line for line: ``dt``, ``B_`` and ``C_`` in
f32, ``A = -exp(A_log)`` in f32 (``A_log`` and ``D`` are f32 leaves in a
bf16 model), the scan's output cast back to ``x``'s dtype.  Decode is the
single-step recurrence with a carried conv ring and SSM state; like
``models/rwkv6.py`` it returns the new state and the caller writes it into
the slot cache.

Over a ``model`` axis (``models/transformer.py``) a rank holds its
``d_inner / n`` channels: its ``[x_r | z_r]`` columns of the fused
``in_proj`` (``parallel/sharding.FUSED``), of the conv, ``dt_proj``,
``A_log`` and ``D``, and its rows of ``x_proj`` and ``out_proj``.  The
block runs in two halves, :func:`front` and :func:`back`, because
``x_proj`` is row-parallel: its small ``(dt_rank + 2 * d_state)`` output
is summed over the ranks between them.  The conv ring and the SSM state
live at the rank's channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common

CHUNK = 256


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, int(math.ceil(cfg.d_model / 16)))
    return d_inner, dt_rank, cfg.ssm_d_state


def mamba_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    d_inner, dt_rank, d_state = _dims(cfg)
    dt = common.dtype_of(cfg)
    dev = gen.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(d_inner, 1)
    return {
        "in_proj": common.dense_init(gen, D, 2 * d_inner, dt),
        "conv": {"kernel": common._normal(gen, (cfg.ssm_conv_width, d_inner),
                                          0.1, dt)},
        "x_proj": common.dense_init(gen, d_inner, dt_rank + 2 * d_state, dt),
        "dt_proj": common.dense_init(gen, dt_rank, d_inner, dt,
                                     use_bias=True),
        "A_log": torch.log(A),                    # f32 (d_inner, d_state)
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": common.dense_init(gen, d_inner, D, dt),
    }


def _conv_causal(p: dict, x: torch.Tensor, state=None):
    """Depthwise causal conv via shifted adds.  x: (B, T, d_inner)."""
    w = p["kernel"].to(x.dtype)                           # (W, d_inner)
    W = w.shape[0]
    if state is None:
        hist = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        hist = state.to(x.dtype)
    ext = torch.cat([hist, x], dim=1)                     # (B, T+W-1, d)
    T = x.shape[1]
    y = ext[:, 0:T] * w[0]
    for i in range(1, W):
        y = y + ext[:, i:i + T] * w[i]
    new_state = ext[:, ext.shape[1] - (W - 1):]
    return y, new_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0), without
    ``F.softplus``'s linear branch above its threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _local_inner(p: dict) -> int:
    """The channels ``p`` holds: ``d_inner``, or a rank's ``d_inner / n``
    over a ``model`` axis (module docstring)."""
    return p["conv"]["kernel"].shape[-1]


def _ssm_params(cfg, p, proj):
    """proj: (B, T, dt_rank + 2 * state), ``x_proj``'s output (over a
    ``model`` axis: summed over the ranks) -> dt (B,T,d_inner), B_
    (B,T,state), C_ (B,T,state), all f32."""
    _, dt_rank, d_state = _dims(cfg)
    dt_in = proj[..., :dt_rank]
    B_ = proj[..., dt_rank:dt_rank + d_state]
    C_ = proj[..., dt_rank + d_state:]
    dt_full = _softplus(common.dense(p["dt_proj"], dt_in).float())
    return dt_full, B_.float(), C_.float()


def _scan_chunked(cfg, p, xc, proj, h0=None):
    """Chunked selective scan.  xc: (B, T, d_inner) -> (y (B,T,d_inner) in
    xc's dtype, h_T (B, d_inner, state) f32)."""
    Bsz, T, d_inner = xc.shape
    A = -torch.exp(p["A_log"].float())                    # (d_inner, state)
    dt_full, B_, C_ = _ssm_params(cfg, p, proj)
    chunk = min(CHUNK, T)
    if T % chunk:
        raise ValueError(f"sequence {T} is not a multiple of the scan's "
                         f"chunk {chunk} (the reference asserts the same)")
    xf = xc.float()
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, d_inner, cfg.ssm_d_state), dtype=torch.float32,
        device=xc.device)
    ys = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        dtc = dt_full[:, sl]
        a = torch.exp(dtc[..., None] * A)                 # (B,c,d_inner,st)
        b = (dtc * xf[:, sl])[..., None] * B_[:, sl, None, :]
        Cc = C_[:, sl]
        if xf.is_meta:
            # a dry run (launch/dryrun.py): the chunk's steps as one op
            # each — the same products and bytes, no values to carry
            hs = a * h[:, None] + b
            ys.append(torch.einsum("bcds,bcs->bcd", hs, Cc))
            h = hs[:, -1]
            continue
        for t in range(chunk):
            h = a[:, t] * h + b[:, t]
            ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t])[:, None])
    y = torch.cat(ys, dim=1)
    return (y + p["D"] * xf).to(xc.dtype), h


def front(cfg: ArchConfig, p: dict, x: torch.Tensor, conv_state=None):
    """The block up to ``x_proj``: ``(xc, z, conv state, proj)``, ``proj``
    the ``x_proj`` output — over a ``model`` axis each rank's partial sum
    of it (``x_proj`` is row-parallel), which the caller reduces before
    :func:`back`."""
    d_inner = _local_inner(p)
    xz = common.dense(p["in_proj"], x)
    xc, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, conv_state = _conv_causal(p["conv"], xc, conv_state)
    xc = F.silu(xc)
    return xc, z, conv_state, common.dense(p["x_proj"], xc)


def back(cfg: ArchConfig, p: dict, xc, z, proj, ssm_state=None):
    """The rest of the block after :func:`front`: the scan (a sequence)
    or one step from ``ssm_state`` (one token), the gate and
    ``out_proj`` (over a ``model`` axis a partial sum: row-parallel).
    Returns ``(out, h)``."""
    if ssm_state is None:
        y, h = _scan_chunked(cfg, p, xc, proj)
    else:
        A = -torch.exp(p["A_log"].float())
        dt_full, B_, C_ = _ssm_params(cfg, p, proj)
        xf = xc.float()[:, 0]                             # (B, d_inner)
        dt1, B1, C1 = dt_full[:, 0], B_[:, 0], C_[:, 0]
        a = torch.exp(dt1[..., None] * A)                 # (B,d_inner,state)
        h = a * ssm_state + (dt1 * xf)[..., None] * B1[:, None, :]
        y = (torch.einsum("bds,bs->bd", h, C1) + p["D"] * xf)[:, None]
        y = y.to(xc.dtype)
    y = y * F.silu(z)
    return common.dense(p["out_proj"], y), h


def mamba_apply(cfg: ArchConfig, p: dict, x: torch.Tensor,
                return_state: bool = False):
    """x: (B, T, D) -> (B, T, D) [, final {'conv', 'ssm'} state]."""
    xc, z, conv_state, proj = front(cfg, p, x)
    out, h_T = back(cfg, p, xc, z, proj)
    if return_state:
        return out, {"conv": conv_state, "ssm": h_T}
    return out


def init_state(cfg: ArchConfig, batch: int, device, d_inner=None) -> dict:
    """Empty conv ring and SSM state (``d_inner``: a rank's channels)."""
    d_inner = d_inner or _dims(cfg)[0]
    d_state = cfg.ssm_d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner),
                            dtype=common.dtype_of(cfg), device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, state: dict):
    """One-token step.  x: (B, 1, D).  Returns (y, new state)."""
    xc, z, conv_state, proj = front(cfg, p, x, state["conv"])
    out, h = back(cfg, p, xc, z, proj, state["ssm"])
    return out, {"conv": conv_state, "ssm": h}
