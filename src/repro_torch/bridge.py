"""Carry a reference parameter tree over to the port.

The reference's parameters are a nested dict of arrays whose ``"layers"``
leaves are stacked over groups (``common.stacked_init``) and whose dense
``"kernel"`` leaves are stored ``(in, out)``.  The port keeps exactly that
layout, so the bridge is a leaf-wise copy: numpy array -> ``torch.Tensor``
on ``device`` in ``dtype``, checked against the shapes the port's own
``init_params`` would make.  The caller turns reference arrays into numpy
(``np.asarray`` leaf by leaf); nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, transformer
from repro_torch.runtime import resolve_device


def param_shapes(cfg: ArchConfig) -> dict:
    """``{path: shape}`` of the parameter tree ``init_params`` makes for a
    dense-family config (computed from the dims: nothing is allocated)."""
    transformer.check_family(cfg)
    H, Kv, hd, D, F = (cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model,
                       cfg.d_ff)
    dense = {"attn/q": (D, H * hd), "attn/k": (D, Kv * hd),
             "attn/v": (D, Kv * hd), "attn/o": (H * hd, D),
             "mlp/wi": (D, F), "mlp/wo": (F, D)}
    if cfg.act == "swiglu":
        dense["mlp/wg"] = (D, F)
    layer = {}
    for name, (i, o) in dense.items():
        layer[f"{name}/kernel"] = (i, o)
        if cfg.use_bias:
            layer[f"{name}/bias"] = (o,)
    norms = ["norm1"] + ([] if cfg.parallel_block else ["norm2"])
    norm_leaves = {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"),
                   "ln_nonparam": ()}[cfg.norm]
    for n in norms:
        for leaf in norm_leaves:
            layer[f"{n}/{leaf}"] = (D,)
    G = cfg.num_groups()
    shapes = {"embed/embedding": (cfg.vocab_size, D)}
    for i in range(cfg.layer_group):
        for path, shape in layer.items():
            shapes[f"layers/l{i}/{path}"] = (G,) + shape
    for leaf in norm_leaves:
        shapes[f"final_norm/{leaf}"] = (D,)
    if not cfg.tie_embeddings:
        shapes["lm_head/kernel"] = (D, cfg.vocab_size)
    return shapes


def flatten(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, paths joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda",
                      dtype=None) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters.

    ``dtype`` defaults to ``cfg.dtype``.  Raises if the tree's paths or
    shapes differ from what the port's model expects."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else common.dtype_of(cfg)
    want = param_shapes(cfg)
    got = {path: tuple(np.shape(a)) for path, a in flatten(tree)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"{diff[:6]}")

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind not in "fiub":   # e.g. an ml_dtypes bfloat16 array
            a = a.astype(np.float32)
        return torch.tensor(a).to(device=dev, dtype=dt)

    return common.tree_map(leaf, tree)
