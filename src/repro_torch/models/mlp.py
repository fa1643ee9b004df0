"""Dense FFN (SwiGLU / GELU / ReLU^2).  Counterpart of
``repro/models/mlp.py``; the projections stay ``torch.matmul``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common


def mlp_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: int | None = None) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = common.dtype_of(cfg)
    p = {"wi": common.dense_init(gen, D, F, dt, cfg.use_bias),
         "wo": common.dense_init(gen, F, D, dt, cfg.use_bias)}
    if cfg.act == "swiglu":
        p["wg"] = common.dense_init(gen, D, F, dt, cfg.use_bias)
    return p


def mlp_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = common.dense(p["wi"], x)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(common.dense(p["wg"], x)) * h
    else:
        h = common.act_fn(cfg.act)(h)
    return common.dense(p["wo"], h)


def local_params(p: dict, rank: int, n: int):
    """``(params, wo bias)`` of rank ``rank`` of a ``model`` axis of ``n``:
    its columns of the column-parallel ``wi`` / ``wg`` (their biases
    sliced to match) and its rows of the row-parallel ``wo`` without the
    bias, which the caller adds once after the reduction."""
    F = p["wo"]["kernel"].shape[0]
    cols = slice(rank * F, (rank + 1) * F)
    lp = {"wo": {"kernel": p["wo"]["kernel"]}}
    for part in ("wi", "wg"):
        if part in p:
            lp[part] = {"kernel": p[part]["kernel"]}
            if "bias" in p[part]:
                lp[part]["bias"] = p[part]["bias"][cols]
    return lp, p["wo"].get("bias")
