"""Family dispatch: one uniform API over the ported architectures.

  init_params(cfg, gen)                     -> param tree
  forward(cfg, params, batch, remat)        -> (logits, aux)     [train]
  prefill(cfg, params, batch, cache_len)    -> (last_logits, caches)
  decode_step(cfg, params, batch, caches)   -> (logits, caches)
  init_decode_caches(cfg, batch_size, cache_len, device)

Counterpart of ``repro/models/registry.py``; ``batch`` is the same dict
(``{"tokens": ...}``, decode adds ``"index"``, which the RWKV-6 family
ignores).  The dense and SSM (RWKV-6) families are ported, both through
``models/transformer.py``; the others raise ``NotImplementedError``
naming the later slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def init_params(cfg: ArchConfig, gen):
    return transformer.init_params(cfg, gen)


def forward(cfg: ArchConfig, params, batch: dict, remat: bool = False):
    """``(logits, aux)``; ``aux`` holds the zero ``lb_loss`` / ``z_loss``
    of the families without experts, as the reference's does."""
    return transformer.forward(cfg, params, batch["tokens"], remat=remat)


def prefill(cfg: ArchConfig, params, batch: dict, cache_len=None):
    return transformer.prefill(cfg, params, batch["tokens"],
                               cache_len=cache_len)


def decode_step(cfg: ArchConfig, params, batch: dict, caches):
    return transformer.decode_step(cfg, params, batch["tokens"], caches,
                                   batch["index"])


def init_decode_caches(cfg: ArchConfig, batch_size: int, cache_len: int,
                       device):
    return transformer.init_decode_caches(cfg, batch_size, cache_len, device)
