"""Shared model building blocks: dense layers, norms, RoPE, init helpers.

Counterpart of ``repro/models/common.py``.  All modules are functional:
``*_init(gen, ...) -> params`` (nested dict of tensors) and
``*_apply(params, x, ...) -> y``.  Kernels are stored 2D
``(in_features, out_features)`` as in the reference, so
``bridge.params_from_numpy`` carries a reference parameter tree over
unchanged.  Initialisation draws from an explicit ``torch.Generator``
(made on the parameters' device) in place of a ``jax.random`` key.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the initialisers, which
    place every tensor on ``gen.device``, then build the tree on the meta
    device — shapes and dtypes, no storage, nothing drawn."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _normal(gen: torch.Generator, shape, scale: float, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               use_bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": _normal(gen, (in_dim, out_dim), scale, dtype)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, device, dim: Optional[int] = None) -> dict:
    dim = dim or cfg.d_model
    dt = dtype_of(cfg)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dt, device=device),
                "bias": torch.zeros((dim,), dtype=dt, device=device)}
    if cfg.norm == "ln_nonparam":
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 compute, eps 1e-6; ``ln_nonparam`` has no parameters."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        return (y * p["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    if cfg.norm == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """(hd//2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: (S,) or (..., S).  Split-half
    layout (first half pairs with second half), angles in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)              # (half,)
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:2 * half].float()
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    out = torch.cat([o1, o2], dim=-1)
    if hd % 2:  # odd head dims pass the tail through (not used by our archs)
        out = torch.cat([out, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(seq_len: int, dim: int, device):
    """(seq_len, dim) fixed sinusoidal embeddings (whisper-style), f32."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoid_freqs(dim, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :dim]


def sinusoid_freqs(dim: int, device) -> torch.Tensor:
    """(ceil(dim / 2),) inverse frequencies of :func:`sinusoid_pos`."""
    return torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device)
                     * (math.log(10000.0) / max(dim // 2 - 1, 1)))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    return {
        "silu": torch.nn.functional.silu,
        # the reference's jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu2": lambda x: torch.square(torch.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# stacked init
# ---------------------------------------------------------------------------

def stacked_init(gen: torch.Generator, n: int, init_fn, keep=None):
    """Run ``init_fn(gen)`` ``n`` times and stack every leaf along a new
    leading dim (the reference's group-stacked parameter layout).

    Each stacked leaf is allocated once, from the first tree's shapes, and
    filled tree by tree as the trees are drawn (in the order the draws
    always came), so the peak is one copy of the weights plus one group's
    tree, not two copies.  ``keep(tree)``, where given, maps each drawn
    tree before it is stacked (a rank's slice of it: ``bridge.init_shards``)."""
    def draw():
        tree = init_fn(gen)
        return tree if keep is None else keep(tree)

    first = draw()
    stacked = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    _fill(stacked, first, 0)
    del first
    for i in range(1, n):
        _fill(stacked, draw(), i)
    return stacked


def _fill(stacked, tree, i: int) -> None:
    if isinstance(stacked, dict):
        for k in stacked:
            _fill(stacked[k], tree[k], i)
        return
    stacked[i].copy_(tree)


def tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Leaf-wise ``tree[i]`` (views, no copy): one group's parameters."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over ``tree`` and any trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order — the order
    ``jax.tree_util`` flattens a dict in, so leaf ``i`` here is leaf ``i``
    of the reference's tree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_structure(tree):
    """The nested dicts of ``tree`` with ``None`` for every leaf (empty
    dicts, such as a parameter-free norm's, kept)."""
    return tree_map(lambda _: None, tree)


def tree_unflatten(structure, leaves):
    """Inverse of :func:`tree_leaves` over ``structure``.  (A module-level
    helper, not a recursive closure: a closure that calls itself is a
    reference cycle, which would keep ``leaves`` — a step's gradients —
    alive until the cyclic garbage collector happens to run.)"""
    return _unflatten(structure, iter(leaves))


def _unflatten(node, it):
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> dict:
    return {"embedding": _normal(gen, (vocab, dim), 1.0 / math.sqrt(dim),
                                 dtype)}
