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

For a ``model`` axis (tensor parallelism) the same tree is carried into
per-rank shards by ``parallel/sharding.shard_params``
(:func:`shards_from_numpy`), so that a test feeds identical weights to the
reference at one device and to the port at ``n`` ranks (every family).  A
rank process that draws its weights from a seed draws the full tree leaf
by leaf, in ``init_params``' order, and keeps its slice
(:func:`init_shards`): its shards are the slices of the one-rank draw bit
for bit, at a peak of one layer's tree beyond them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, mamba, registry, rwkv6, transformer
from repro_torch.parallel import sharding
from repro_torch.runtime import resolve_device


def _dense(name: str, i: int, o: int, bias: bool) -> dict:
    out = {f"{name}/kernel": (i, o)}
    if bias:
        out[f"{name}/bias"] = (o,)
    return out


def _attn_shapes(cfg: ArchConfig, name: str = "attn") -> dict:
    D, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    out = {}
    for part, (i, o) in {"q": (D, H * hd), "k": (D, Kv * hd),
                         "v": (D, Kv * hd), "o": (H * hd, D)}.items():
        out.update(_dense(f"{name}/{part}", i, o, cfg.use_bias))
    return out


def _mlp_shapes(cfg: ArchConfig, name: str = "mlp", d_ff: int = 0) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    out = {**_dense(f"{name}/wi", D, F, cfg.use_bias),
           **_dense(f"{name}/wo", F, D, cfg.use_bias)}
    if cfg.act == "swiglu":
        out.update(_dense(f"{name}/wg", D, F, cfg.use_bias))
    return out


def _moe_shapes(cfg: ArchConfig) -> dict:
    """The router (an f32 leaf in a bf16 model), the expert kernels and
    the shared experts' MLP."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    out = {"moe/router/kernel": (D, E), "moe/wi/kernel": (E, D, F),
           "moe/wo/kernel": (E, F, D)}
    if cfg.act == "swiglu":
        out["moe/wg/kernel"] = (E, D, F)
    if cfg.shared_experts:
        out.update(_mlp_shapes(cfg, "moe/shared_mlp",
                               cfg.d_ff * cfg.shared_experts))
    return out


def _mamba_shapes(cfg: ArchConfig) -> dict:
    """Mamba's projections, conv and SSM leaves (``A_log`` and ``D`` are
    f32 leaves in a bf16 model)."""
    D = cfg.d_model
    d_inner, dt_rank, d_state = mamba._dims(cfg)
    return {"mamba/in_proj/kernel": (D, 2 * d_inner),
            "mamba/conv/kernel": (cfg.ssm_conv_width, d_inner),
            "mamba/x_proj/kernel": (d_inner, dt_rank + 2 * d_state),
            "mamba/dt_proj/kernel": (dt_rank, d_inner),
            "mamba/dt_proj/bias": (d_inner,),
            "mamba/A_log": (d_inner, d_state), "mamba/D": (d_inner,),
            "mamba/out_proj/kernel": (d_inner, D)}


def _norms(cfg: ArchConfig, names) -> dict:
    D = cfg.d_model
    return {f"{n}/{leaf}": (D,) for n in names for leaf in _norm_leaves(cfg)}


def _layer_shapes(cfg: ArchConfig, l: int) -> dict:
    """``{path: shape}`` of the parameters of the layer at position ``l``
    within a group."""
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
        return {**layer, **_norms(cfg, ["norm1", "norm2"])}
    layer = _attn_shapes(cfg) if cfg.is_attn_layer(l) else _mamba_shapes(cfg)
    layer.update(_moe_shapes(cfg) if cfg.is_moe_layer(l)
                 else _mlp_shapes(cfg))
    norms = ["norm1"] + ([] if cfg.parallel_block else ["norm2"])
    return {**layer, **_norms(cfg, norms)}


def _enc_layer_shapes(cfg: ArchConfig) -> dict:
    return {**_attn_shapes(cfg), **_mlp_shapes(cfg),
            **_norms(cfg, ["norm1", "norm2"])}


def _dec_layer_shapes(cfg: ArchConfig) -> dict:
    return {**_attn_shapes(cfg), **_attn_shapes(cfg, "xattn"),
            **_mlp_shapes(cfg), **_norms(cfg, ["norm1", "norm2", "norm3"])}


def _norm_leaves(cfg: ArchConfig) -> tuple:
    return {"rmsnorm": ("scale",), "layernorm": ("scale", "bias"),
            "ln_nonparam": ()}[cfg.norm]


def _stacked(prefix: str, n: int, layer: dict) -> dict:
    return {f"{prefix}/{path}": (n,) + shape for path, shape in layer.items()}


def param_shapes(cfg: ArchConfig) -> dict:
    """``{path: shape}`` of the parameter tree ``registry.init_params``
    makes for ``cfg`` (computed from the dims: nothing is allocated).  The
    decoder-only families stack ``layers/l{i}`` over groups; an
    encoder-decoder stacks ``enc_layers`` over ``encoder_layers`` and
    ``layers`` over ``num_layers``."""
    D, V = cfg.d_model, cfg.vocab_size
    shapes = {"embed/embedding": (V, D), **_norms(cfg, ["final_norm"])}
    if cfg.family == "encdec":
        shapes.update({
            "frame_proj/kernel": (D, D), **_norms(cfg, ["enc_norm"]),
            **_stacked("enc_layers", cfg.encoder_layers,
                       _enc_layer_shapes(cfg)),
            **_stacked("layers", cfg.num_layers, _dec_layer_shapes(cfg))})
        return shapes
    G = cfg.num_groups()
    for i in range(cfg.layer_group):
        shapes.update(_stacked(f"layers/l{i}", G, _layer_shapes(cfg, i)))
    if not cfg.tie_embeddings:
        shapes["lm_head/kernel"] = (D, V)
    if cfg.family == "vlm":
        shapes["vit_proj/kernel"] = (D, D)
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


def shards_from_numpy(cfg: ArchConfig, tree: dict, n: int, held,
                      device="cuda") -> sharding.Shards:
    """:func:`params_from_numpy`, then each held rank's slice over a
    ``model`` axis of ``n`` (``sharding.shard_params``)."""
    transformer.check_tp(cfg, n)
    return sharding.shard_params(params_from_numpy(cfg, tree, device), n,
                                 held, sharding.head_counts(cfg))


def init_shards(cfg: ArchConfig, gen: torch.Generator, n: int,
                held) -> sharding.Shards:
    """The held ranks' slices of ``registry.init_params(cfg, gen)`` over a
    ``model`` axis of ``n``, drawn leaf by leaf on ``gen.device`` in
    ``init_params``' order (every family: the decoder-only tree, an
    encoder-decoder's, a VLM's with its connector last) without the full
    tree ever being held: one layer group's tree beyond the slices."""
    transformer.check_tp(cfg, n)
    heads = sharding.head_counts(cfg)

    def keep(path, leaf, lead=()):
        dim = sharding.spec_for_param(path, lead + tuple(leaf.shape), n,
                                      heads)
        return sharding.slice_leaf(leaf, None if dim is None
                                   else dim - len(lead), n, held,
                                   sharding.fused_parts(path))

    def stacked(prefix: str, count: int, init_fn):
        def keep_group(tree, path=(prefix,)):
            if isinstance(tree, dict):
                return {k: keep_group(v, path + (k,)) for k, v in tree.items()}
            return keep("/".join(path), tree, (count,))
        layers = common.stacked_init(gen, count, init_fn, keep=keep_group)
        return common.tree_map(lambda a: a.movedim(1, 0), layers)

    def norm(name):
        return common.tree_map(lambda a: keep(f"{name}/scale", a),
                               common.norm_init(cfg, gen.device))

    def dense(name, i, o):
        return {"kernel": keep(f"{name}/kernel", common.dense_init(
            gen, i, o, dt)["kernel"])}

    dt = common.dtype_of(cfg)
    D = cfg.d_model
    out = {}
    if cfg.family == "encdec":
        out["frame_proj"] = dense("frame_proj", D, D)
    out["embed"] = {"embedding": keep("embed/embedding", common.embed_init(
        gen, cfg.vocab_size, D, dt)["embedding"])}
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        out["enc_layers"] = stacked("enc_layers", cfg.encoder_layers,
                                    lambda g: encdec._enc_layer_init(g, cfg))
        out["enc_norm"] = norm("enc_norm")
        out["layers"] = stacked("layers", cfg.num_layers,
                                lambda g: encdec._dec_layer_init(g, cfg))
    else:
        out["layers"] = stacked("layers", cfg.num_groups(),
                                lambda g: transformer._group_init(g, cfg))
    out["final_norm"] = norm("final_norm")
    if cfg.family != "encdec" and not cfg.tie_embeddings:
        out["lm_head"] = dense("lm_head", D, cfg.vocab_size)
    if cfg.family == "vlm":
        out["vit_proj"] = dense("vit_proj", D, D)
    shards = sharding.Shards(out)
    shards.n, shards.held = n, tuple(held)
    return shards


# ---------------------------------------------------------------------------
# a (data, model) mesh: each rank's shards (parallel/mesh_tree.py)
# ---------------------------------------------------------------------------

def _nest(flat: dict, cfg: ArchConfig) -> dict:
    """``{"a/b/c": v}`` -> ``{"a": {"b": {"c": v}}}``, with the empty
    dicts of ``cfg``'s parameter-free norms where the parameter tree has
    them."""
    out: dict = {}
    if not _norm_leaves(cfg):
        import dataclasses
        for path in param_shapes(dataclasses.replace(cfg, norm="rmsnorm")):
            if path.endswith("/scale"):
                flat = {path[:-len("/scale")]: {}, **flat}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def mesh_specs(cfg: ArchConfig, mesh) -> dict:
    """A ``LeafSpec`` for every leaf of ``cfg``'s parameter tree on
    ``mesh`` (``parallel/mesh_tree.mesh_spec``), as a tree."""
    from repro_torch.parallel.mesh_tree import mesh_spec
    sizes = {"data": mesh.dp_size, "model": mesh.tp_size}
    if mesh.tp_size > 1:
        transformer.check_tp_train(cfg, mesh.tp_size)
    heads = sharding.head_counts(cfg)
    return _nest({path: mesh_spec(path, shape, sizes, heads)
                  for path, shape in param_shapes(cfg).items()}, cfg)


def mesh_shards(cfg: ArchConfig, params: dict, mesh) -> dict:
    """The held ranks' shards of the full tree ``params`` on ``mesh``,
    every leaf ``(Dl, Ml, *local)``."""
    from repro_torch.parallel.mesh_tree import MeshTree
    tree = MeshTree(mesh)
    return common.tree_map(tree.shard, params, mesh_specs(cfg, mesh))


def mesh_from_numpy(cfg: ArchConfig, tree: dict, mesh, device="cuda") -> dict:
    """:func:`params_from_numpy`, then :func:`mesh_shards`."""
    return mesh_shards(cfg, params_from_numpy(cfg, tree, device), mesh)


def gather_mesh(shards: dict, specs: dict, mesh) -> dict:
    """The full tree back from a mesh's shards (over rank processes,
    every rank gets it: all-gathers over ``model`` and ``data``)."""
    from repro_torch.parallel.mesh_tree import MeshTree
    return common.tree_map(MeshTree(mesh).gather, shards, specs)


def init_mesh_shards(cfg: ArchConfig, gen: torch.Generator, mesh) -> dict:
    """The held ranks' shards of ``transformer.init_params(cfg, gen)`` on
    ``mesh``, drawn leaf by leaf on ``gen.device`` without the full tree
    ever being held (a layer group's tree at a time, as
    :func:`init_shards`): the slices of the one-rank draw bit for bit."""
    from repro_torch.parallel.mesh_tree import LeafSpec, MeshTree
    if cfg.family in ("encdec", "vlm"):
        return mesh_shards(cfg, registry.init_params(cfg, gen), mesh)
    tree = MeshTree(mesh)
    specs = mesh_specs(cfg, mesh)
    dt = common.dtype_of(cfg)

    def group_spec(spec):
        def shift(d):
            return None if d is None else d - 1
        return LeafSpec(spec.shape[1:], shift(spec.data), shift(spec.model),
                        spec.parts)

    def keep_group(t, sp):
        if isinstance(t, dict):
            return {k: keep_group(v, sp[k]) for k, v in t.items()}
        return tree.shard(t, group_spec(sp))

    out = {"embed": {"embedding": tree.shard(common.embed_init(
        gen, cfg.vocab_size, cfg.d_model, dt)["embedding"],
        specs["embed"]["embedding"])}}
    layers = common.stacked_init(gen, cfg.num_groups(),
                                 lambda g: transformer._group_init(g, cfg),
                                 keep=lambda t: keep_group(t, specs["layers"]))
    out["layers"] = common.tree_map(lambda a: a.movedim(0, 2).contiguous(),
                                    layers)
    out["final_norm"] = common.tree_map(
        tree.shard, common.norm_init(cfg, gen.device), specs["final_norm"])
    if not cfg.tie_embeddings:
        out["lm_head"] = {"kernel": tree.shard(common.dense_init(
            gen, cfg.d_model, cfg.vocab_size, dt)["kernel"],
            specs["lm_head"]["kernel"])}
    return out
