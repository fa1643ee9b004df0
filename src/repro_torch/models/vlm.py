"""InternVL-style VLM: stub vision frontend + decoder-only LM backbone.

Counterpart of ``repro/models/vlm.py``.  The ViT is a stub, as in the
reference: the batch carries precomputed patch embeddings ``patches (B, P,
d_model)``, which ``vit_proj`` (the connector) projects and
``transformer`` prepends to the text embeddings (``extra_embeds``).
Everything downstream is the standard backbone, so a prefill's full
sequence (patches and text) runs the flash kernel on the card.

Over a ``model`` axis (``axis=``; ``params`` the held ranks' shards)
``vit_proj`` is replicated (its rule is ``(None, "embed")``), so the
connector runs once on rank 0's copy (:func:`connector`); the patches are
prepended and the dense backbone runs over the axis
(``models/transformer.py``), in training too (``transformer.loss_tp``,
which scores the text positions only).  Under sequence parallelism the
connector runs so too, and the ``P + S`` positions are split over the
ranks (``transformer._embed_sp``).  InternVL2's vocabulary (92,553)
does not split over 2 or 4: its embedding and logits stay replicated.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, transformer


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    p = transformer.init_params(cfg, gen)
    p["vit_proj"] = common.dense_init(gen, cfg.d_model, cfg.d_model,
                                      common.dtype_of(cfg))
    return p


def _project(params, patches):
    """The connector, on patches cast to the model's dtype (bf16 patches
    into an f32 model: the reference's type promotion)."""
    proj = params["vit_proj"]
    return common.dense(proj, patches.to(proj["kernel"].dtype))


def connector(params, patches):
    """The projected patches over a ``model`` axis, from the held ranks'
    tree ``params``: the replicated ``vit_proj`` runs once, on its one
    copy (rank 0's).  Its output joins the replicated residual stream
    outside any region, whose gradient every rank holds whole (each
    region's entry sums it over the ranks), so every rank's copy of the
    connector gets the whole gradient, with no exchange of its own."""
    return _project({"vit_proj": common.tree_index(params["vit_proj"], 0)},
                    patches)


def _images(params, patches, axis):
    """The projected patches (over an axis: :func:`connector`)."""
    return _project(params, patches) if axis is None \
        else connector(params, patches)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            patches: torch.Tensor, remat: bool = False, axis=None):
    """tokens: (B, S_text); patches: (B, P, D) precomputed patch
    embeddings.  Returns logits over the FULL (P + S_text) sequence and the
    aux losses; the train step applies its loss on the text positions."""
    return transformer.forward(cfg, params, tokens, remat=remat,
                               extra_embeds=_images(params, patches, axis),
                               axis=axis)


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            patches: torch.Tensor, cache_len=None, axis=None):
    return transformer.prefill(cfg, params, tokens,
                               extra_embeds=_images(params, patches, axis),
                               cache_len=cache_len, axis=axis)


decode_step = transformer.decode_step
init_decode_caches = transformer.init_decode_caches
