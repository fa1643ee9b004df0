"""Family dispatch: one uniform API over all assigned architectures.

  init_params(cfg, gen)                     -> param tree
  forward(cfg, params, batch, remat)        -> (logits, aux)     [train]
  prefill(cfg, params, batch, cache_len)    -> (last_logits, caches)
  decode_step(cfg, params, batch, caches)   -> (logits, caches)
  init_decode_caches(cfg, batch_size, cache_len, device)

Counterpart of ``repro/models/registry.py``; ``batch`` is the same dict:
``{"tokens": ...}``, with ``"frames" (B, T, D)`` for the encoder-decoder
family and ``"patches" (B, P, D)`` for the VLM family; decode adds
``"index"`` (which the RWKV-6 family ignores).  The dense, MoE, hybrid
and ssm families go through ``models/transformer.py``, encdec through
``models/encdec.py``, vlm through ``models/vlm.py``.  ``axis`` (a
``model`` axis, ``parallel/model_axis.py``) runs any family
tensor-parallel over per-rank parameters and caches
(``models/transformer.py``, ``models/encdec.py``, ``models/vlm.py``),
once ``transformer.check_tp`` admits its widths.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer, vlm


def init_params(cfg: ArchConfig, gen):
    if cfg.family == "encdec":
        return encdec.init_params(cfg, gen)
    if cfg.family == "vlm":
        return vlm.init_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def _check_axis(cfg: ArchConfig, axis) -> None:
    if axis is not None:
        transformer.check_tp(cfg, axis.n)


def forward(cfg: ArchConfig, params, batch: dict, remat: bool = False,
            axis=None):
    """``(logits, aux)``; ``aux`` holds the MoE layers' summed
    ``lb_loss`` / ``z_loss``, zero for the families without experts, as
    the reference's does."""
    _check_axis(cfg, axis)
    if cfg.family == "encdec":
        return encdec.forward(cfg, params, batch["tokens"], batch["frames"],
                              remat=remat, axis=axis)
    if cfg.family == "vlm":
        return vlm.forward(cfg, params, batch["tokens"], batch["patches"],
                           remat=remat, axis=axis)
    return transformer.forward(cfg, params, batch["tokens"], remat=remat,
                               axis=axis)


def prefill(cfg: ArchConfig, params, batch: dict, cache_len=None, axis=None):
    _check_axis(cfg, axis)
    if cfg.family == "encdec":
        return encdec.prefill(cfg, params, batch["tokens"], batch["frames"],
                              cache_len=cache_len, axis=axis)
    if cfg.family == "vlm":
        return vlm.prefill(cfg, params, batch["tokens"], batch["patches"],
                           cache_len=cache_len, axis=axis)
    return transformer.prefill(cfg, params, batch["tokens"],
                               cache_len=cache_len, axis=axis)


def decode_step(cfg: ArchConfig, params, batch: dict, caches, axis=None):
    _check_axis(cfg, axis)
    if cfg.family == "encdec":
        return encdec.decode_step(cfg, params, batch["tokens"], caches,
                                  batch["index"], axis=axis)
    return transformer.decode_step(cfg, params, batch["tokens"], caches,
                                   batch["index"], axis=axis)


def decode_exchanges(cfg: ArchConfig, n: int) -> dict:
    """The exchanges of one decode tick over a ``model`` axis of ``n``, by
    kind, derived from the layers (``transformer.decode_exchanges``,
    ``encdec.decode_exchanges``)."""
    if cfg.family == "encdec":
        return encdec.decode_exchanges(cfg, n)
    return transformer.decode_exchanges(cfg, n)


def init_decode_caches(cfg: ArchConfig, batch_size: int, cache_len: int,
                       device, axis=None):
    """An encoder-decoder's cross K/V hold ``cache_len`` encoder positions,
    as the reference sizes them."""
    _check_axis(cfg, axis)
    if cfg.family == "encdec":
        return encdec.init_decode_caches(cfg, batch_size, cache_len,
                                         enc_len=cache_len, device=device,
                                         axis=axis)
    return transformer.init_decode_caches(cfg, batch_size, cache_len, device,
                                          axis=axis)
