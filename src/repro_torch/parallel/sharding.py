"""Logical-axis sharding rules and the split of a parameter tree over the
``model`` axis.

Counterpart of ``repro/parallel/sharding.py``.  The rule tables are the
reference's, as data: ``train_rules`` / ``decode_rules`` map logical axes
("heads", "mlp", "vocab", ...) to mesh axes, ``PARAM_RULES`` maps a
parameter's path to the logical axis of each of its dims, and
``CACHE_RULES`` (the reference keeps it in ``serve/step.py`` as
``_CACHE_RULES``) does the same for decode caches.  ``safe_spec`` prunes
as the reference's does: a mesh axis that does not divide a dim leaves
that dim replicated.

What the reference hands to GSPMD (``with_sharding_constraint``, sharded
``jit`` arguments) has no counterpart in eager PyTorch: here placement is
explicit.  :func:`spec_for_param` names the one dim of a leaf split over
``model`` (or ``None``), and :func:`shard_params` keeps each held rank's
slice of every leaf, ranks on dim 0 (the convention of
``parallel/pods.py``).  The model code (``models/transformer.py``) then
runs each rank's slice and reduces over the axis where the reference's
compiler would insert the collective.  These are the serving split (the
decode rules, ``model`` only); a training mesh splits each leaf by
``train_rules`` — its ``embed`` dim over ``data`` too — with the same
pruning and whole-head rule (``parallel/mesh_tree.mesh_spec``).

One rule differs from the flattened-dim view the reference's compiler
can take: an attention projection is split by **whole heads**.  The
reference's ``safe_spec`` checks ``Kv * hd`` against the axis, and GSPMD
reshards a split that cuts a head; eager code cannot, so a ``k`` / ``v``
kernel whose kv heads the axis does not divide stays replicated, and each
rank reads the kv heads its query heads need (``models/attention.py``).
RWKV-6's time-mix projections, decay and bonus split by whole heads the
same way (``H % n``; each rank runs the WKV scan at its ``H / n`` heads).

Two leaves of the hybrid family's Mamba layers need a whole-unit split the
flattened view does not give:

* the fused ``mamba/in_proj`` kernel ``(D, 2 * d_inner)`` holds ``[x |
  z]``.  A contiguous split over ``model`` would give rank 0 of 2 all of
  ``x`` and none of ``z``; each rank instead holds its channels of both
  halves, ``[x_r | z_r]`` (:data:`FUSED`, :func:`slice_leaf`'s
  ``parts``).  It is the same function under another layout: the rank's
  ``x_r`` and its gate ``z_r`` cover the same channels, so the scan, the
  gate and the row-parallel ``out_proj`` stay local to the rank;
* ``mamba/D`` is ``(d_inner,)`` a layer, ``(G, d_inner)`` stacked; the
  rule's ``("mlp", None)`` would name the group dim, so the port reads it
  as ``("mlp",)`` (:data:`PORT_RULES`), the channels ``A_log`` splits.

``bridge.param_shapes`` and the checkpoint layout do not change: only a
rank's slice of a leaf does.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

LogicalRules = dict[str, tuple[str, ...]]


def train_rules(multi_pod: bool, sequence_parallel: bool = False) -> LogicalRules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": (),             # sequence replicated during training
        # Megatron-SP: the residual stream is sequence-sharded over 'model'
        # between TP regions, turning per-layer activation all-reduces into
        # all-gather + reduce-scatter pairs (half the wire bytes).
        "seq_sp": ("model",) if sequence_parallel else (),
        "kv_seq": (),
        "embed": ("data",),    # FSDP/ZeRO param dim
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "cache_seq": ("model",),   # flash-decode style cache split
        "stage": (),
    }


def decode_rules(multi_pod: bool, long_context: bool) -> LogicalRules:
    r = train_rules(multi_pod)
    if long_context:
        # batch=1: every mesh axis shards the KV-cache / state sequence
        r["batch"] = ()
        r["cache_seq"] = (("pod", "data", "model") if multi_pod
                          else ("data", "model"))
    return r


# path regex -> logical axes per dim (None: replicated leaf); stacked
# layer params get a leading group dim, handled by the "layers/" prefix
PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"embed/embedding$",        ("vocab", None)),
    (r"pos_embed/embedding$",    (None, "embed")),
    (r"lm_head/kernel$",         ("embed", "vocab")),
    (r"attn/(q|k|v)/kernel$",    ("embed", "heads")),
    (r"attn/o/kernel$",          ("heads", "embed")),
    (r"attn/(q|k|v|o)/bias$",    (None,)),
    (r"(mlp|shared_mlp)/w(i|g)/kernel$", ("embed", "mlp")),
    (r"(mlp|shared_mlp)/wo/kernel$",     ("mlp", "embed")),
    (r"(mlp|shared_mlp)/w./bias$",       (None,)),
    (r"moe/router/kernel$",      ("embed", None)),
    (r"moe/w(i|g)/kernel$",      ("expert", "embed", None)),
    (r"moe/wo/kernel$",          ("expert", None, "embed")),
    (r"mamba/in_proj/kernel$",   ("embed", "mlp")),
    (r"mamba/conv/kernel$",      (None, "mlp")),
    (r"mamba/x_proj/kernel$",    ("mlp", None)),
    (r"mamba/dt_proj/kernel$",   (None, "mlp")),
    (r"mamba/dt_proj/bias$",     ("mlp",)),
    (r"mamba/(A_log|D)$",        ("mlp", None)),
    (r"mamba/out_proj/kernel$",  ("mlp", "embed")),
    (r"rwkv/(r|k|v|g)/kernel$",  ("embed", "heads")),
    (r"rwkv/o/kernel$",          ("heads", "embed")),
    (r"rwkv/(w_lora_a|mix_lora_a)/kernel$", ("embed", None)),
    (r"rwkv/w_lora_b/kernel$",   (None, None)),
    (r"rwkv/mix_lora_b/kernel$", (None, None, None)),
    (r"rwkv/(time_decay|time_first|bonus)$", ("heads",)),
    (r"rwkv/(mix_.*|ln_x/.*)$",  (None,)),
    (r"cmlp/wk/kernel$",         ("embed", "mlp")),
    (r"cmlp/wv/kernel$",         ("mlp", "embed")),
    (r"cmlp/wr/kernel$",         ("embed", "heads")),
    (r"(vit_proj|frame_proj)/kernel$", (None, "embed")),
    # norms / small vectors: replicated
    (r".*(scale|bias|mix|gamma|beta)$", None),
    (r".*$",                     None),
]

# decode caches: (key suffix, logical axes per dim after the group dim)
CACHE_RULES = [
    (("k", "v", "xk", "xv"), ("batch", "cache_seq", None, None)),
    (("conv",),              ("batch", None, "mlp")),
    (("ssm",),               ("batch", "mlp", None)),
    (("wkv",),               ("batch", "heads", None, None)),
    (("shift", "cm"),        ("batch", None, None)),
]

# attention projections (and RWKV-6's per-head leaves) whose "heads" dim
# is split by whole heads
_HEAD_KERNELS = {r"attn/(q|o)/kernel$": "q", r"attn/(k|v)/kernel$": "kv",
                 r"rwkv/(r|k|v|g|o)/kernel$|rwkv/(time_decay|time_first)$":
                 "rwkv"}

# the port's reading of a leaf whose reference rule names another dim than
# the one a whole-unit split needs (module docstring); looked up first
PORT_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"mamba/D$",                ("mlp",)),
]

# fused leaves: the number of halves (parts) a split takes its share of
FUSED = {r"mamba/in_proj/kernel$": 2}


def safe_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
              rules: LogicalRules, mesh_shape: dict) -> tuple:
    """The mesh axes of each dim of ``shape`` (a name, a tuple of names,
    or ``None``): each logical axis's mesh axes, pruned greedily to the
    longest prefix whose product divides the dim, as the reference's
    ``safe_spec``."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} against logical axes "
                         f"{tuple(logical)}")
    out = []
    for dim, name in zip(shape, logical):
        axes = [a for a in rules.get(name, ()) if a in mesh_shape] \
            if name is not None else []
        kept, prod = [], 1
        for a in axes:
            if dim % (prod * mesh_shape[a]) == 0:
                kept.append(a)
                prod *= mesh_shape[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def logical_axes(path: str, ndim: int) -> Optional[tuple]:
    """The logical axis of each dim of the leaf at ``path`` by
    ``PARAM_RULES`` (the group dim of a stacked leaf prepended), or
    ``None`` for a replicated leaf."""
    # an encoder-decoder's encoder layers are stacked too (the reference's
    # test names ``layers/`` only, and so leaves them replicated)
    stacked = path.startswith(("layers/", "enc_layers/")) \
        or "/layers/" in path
    for pat, logical in PORT_RULES + PARAM_RULES:
        if re.search(pat, path):
            if logical is None:
                return None
            logical = tuple(logical)
            if stacked and len(logical) == ndim - 1:
                logical = (None,) + logical
            return logical if len(logical) == ndim else None
    return None


def spec_for_param(path: str, shape: Sequence[int], n: int,
                   heads: Optional[dict] = None) -> Optional[int]:
    """The dim of the leaf at ``path`` split over a ``model`` axis of
    ``n`` ranks under the decode rules, or ``None`` (replicated).

    ``heads`` (``{"q": H, "kv": Kv, "rwkv": H_rwkv}``) makes an
    attention projection's (and an RWKV-6 leaf's) split whole-head: its
    head dim splits only where ``n`` divides the head count."""
    logical = logical_axes(path, len(shape))
    if logical is None or n == 1:
        return None
    spec = safe_spec(shape, logical, decode_rules(False, False),
                     {"data": 1, "model": n})
    dims = [d for d, axes in enumerate(spec)
            if axes == "model" or (isinstance(axes, tuple) and "model" in axes)]
    if not dims:
        return None
    dim = dims[0]
    if heads is not None:
        for pat, kind in _HEAD_KERNELS.items():
            if re.search(pat, path) and heads[kind] % n:
                return None
    return dim


def head_counts(cfg) -> dict:
    return {"q": cfg.num_heads, "kv": cfg.num_kv_heads,
            "rwkv": cfg.d_model // cfg.rwkv_head_dim}


def fused_parts(path: str) -> int:
    """How many fused halves the leaf at ``path`` holds side by side on
    its split dim (1: none; :data:`FUSED`)."""
    for pat, parts in FUSED.items():
        if re.search(pat, path):
            return parts
    return 1


class Shards(dict):
    """A parameter tree split over a ``model`` axis: every leaf leads with
    the held ranks (``(len(held), ...)``), rank ``held[j]``'s slice at
    ``[j]``.  A plain ``dict`` otherwise; the type tells the serving cells
    that the tree is split already."""
    n: int = 1
    held: tuple = (0,)


def slice_leaf(leaf: torch.Tensor, dim: Optional[int], n: int,
               held: Sequence[int], parts: int = 1) -> torch.Tensor:
    """``(len(held), ...)``: each held rank's slice of ``leaf`` along
    ``dim`` (the whole leaf where ``dim`` is ``None``, as a broadcast view
    when more than one rank is held).  ``parts``: the leaf holds that many
    fused halves side by side along ``dim``, and a rank's slice is its
    share of each, concatenated in order (:data:`FUSED`)."""
    if dim is None:
        return leaf.unsqueeze(0).expand((len(held),) + tuple(leaf.shape))
    part = leaf.shape[dim] // parts
    size = part // n
    return torch.stack([torch.cat([
        leaf.narrow(dim, h * part + r * size, size) for h in range(parts)],
        dim=dim) if parts > 1 else leaf.narrow(dim, r * size, size)
        for r in held])



def shard_params(params: dict, n: int, held: Sequence[int],
                 heads: Optional[dict] = None) -> Shards:
    """Each held rank's slice of every leaf of ``params`` (the full tree),
    by :func:`spec_for_param`."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        path = "/".join(prefix)
        return slice_leaf(tree, spec_for_param(path, tree.shape, n, heads),
                          n, held, fused_parts(path))
    out = Shards(walk(params, ()))
    out.n, out.held = n, tuple(held)
    return out
