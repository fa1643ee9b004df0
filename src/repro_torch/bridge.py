"""Carry a reference parameter tree over to the port.

The reference's parameters are a nested dict of arrays whose ``"layers"``
leaves are stacked over groups (``common.stacked_init``) and whose dense
``"kernel"`` leaves are stored ``(in, out)``.  The port keeps exactly that
layout, so the bridge is a leaf-wise copy: numpy array -> ``torch.Tensor``
on ``device``, checked against the shapes the port's own ``init_params``
would make.  Each leaf keeps its array's own dtype (an ml_dtypes bfloat16
array becomes ``torch.bfloat16``): the reference tree already says which
leaves stay f32 in a bf16 model, as the port's ``init_params`` does.  The
caller turns reference arrays into numpy (``np.asarray`` leaf by leaf);
nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, rwkv6, transformer
from repro_torch.runtime import resolve_device


def _layer_shapes(cfg: ArchConfig) -> dict:
    """``{path: shape}`` of one layer's parameters."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        R, n = cfg.rwkv_lora_rank, rwkv6.N_MIX
        layer = {f"rwkv/{name}/kernel": (D, D)
                 for name in ("r", "k", "v", "g", "o")}
        layer.update({
            "rwkv/mix_x": (D,), "rwkv/mix_base": (n, D),
            "rwkv/mix_lora_a/kernel": (D, n * R),
            "rwkv/mix_lora_b/kernel": (n, R, D),
            "rwkv/time_decay": (D,),
            "rwkv/w_lora_a/kernel": (D, R), "rwkv/w_lora_b/kernel": (R, D),
            "rwkv/time_first": (D,),
            "rwkv/ln_x/scale": (D,), "rwkv/ln_x/bias": (D,),
            "cmlp/mix_k": (D,), "cmlp/mix_r": (D,),
            "cmlp/wk/kernel": (D, F), "cmlp/wv/kernel": (F, D),
            "cmlp/wr/kernel": (D, D)})
        norms = ["norm1", "norm2"]
    else:
        H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
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
    for n in norms:
        for leaf in _norm_leaves(cfg):
            layer[f"{n}/{leaf}"] = (D,)
    return layer


def _norm_leaves(cfg: ArchConfig) -> tuple:
    return {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"),
            "ln_nonparam": ()}[cfg.norm]


def param_shapes(cfg: ArchConfig) -> dict:
    """``{path: shape}`` of the parameter tree ``init_params`` makes for a
    ported config (computed from the dims: nothing is allocated)."""
    transformer.check_family(cfg)
    D = cfg.d_model
    G = cfg.num_groups()
    shapes = {"embed/embedding": (cfg.vocab_size, D)}
    for i in range(cfg.layer_group):
        for path, shape in _layer_shapes(cfg).items():
            shapes[f"layers/l{i}/{path}"] = (G,) + shape
    for leaf in _norm_leaves(cfg):
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


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameters,
    each leaf in its array's own dtype.

    Raises if the tree's paths or shapes differ from what the port's model
    expects."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    got = {path: tuple(np.shape(a)) for path, a in flatten(tree)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"{diff[:6]}")

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # ml_dtypes: carried bit for bit
            return torch.tensor(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.tensor(a, device=dev)

    return common.tree_map(leaf, tree)
