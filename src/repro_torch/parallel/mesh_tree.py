"""A parameter tree over a ``(data, model)`` mesh: what each rank holds.

Counterpart of what the reference hands GSPMD as the train state's
shardings (``repro/parallel/sharding.py``'s ``train_rules``: each
parameter's ``embed`` dim over ``data`` — FSDP/ZeRO — and its ``heads``,
``mlp`` and ``vocab`` dims over ``model``).  Here placement is explicit:
every leaf of a mesh's train state leads with two rank dims, ``(Dl, Ml,
*local)``, where ``Dl`` is the number of data ranks this process holds if
the leaf is split over ``data`` and 1 if it is not, ``Ml`` likewise for
``model``.  A leaf an axis does not split is held once a process: once
on an emulated mesh, once in each rank process (where every rank of that
axis holds an equal copy).  So a rank process's leaves all lead with
``(1, 1)``.

:func:`mesh_spec` names the dim each axis splits (``LeafSpec``), by the
reference's rules and ``safe_spec``'s pruning, with the port's
whole-head rule for attention projections (``parallel/sharding.py``).
:class:`MeshTree` moves leaves between the layouts: each held rank's
shard of a full leaf (:meth:`MeshTree.shard`), the full leaf back
(:meth:`MeshTree.gather`, over both axes), the FSDP gather of a leaf's
data shards before use (:meth:`MeshTree.gather_data`) and the gradients'
reduction over ``data`` after (:meth:`MeshTree.reduce_data`:
reduce-scatter of a split leaf, all-reduce of the others), and the sums
over the axes that split a leaf, which the optimizer's global statistics
need (:meth:`MeshTree.psum`, :meth:`MeshTree.counts`).

A fused leaf (``sharding.FUSED``: the hybrid family's Mamba ``in_proj``,
``[x | z]`` side by side) splits over ``model`` by its parts: a rank's
shard is ``[x_r | z_r]``, its channels of each half, as serving's
``sharding.slice_leaf(parts=)`` cuts it (``LeafSpec.parts``).  The
gather puts the halves back in order, ``[x_0 .. x_n | z_0 .. z_n]``, not
the ranks' shards end to end.  The ``data`` axis never splits a fused
dim (it splits ``embed``), so the gradients' reduce-scatter over
``data`` is the same for a fused leaf as for any other.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.parallel import sharding
from repro_torch.parallel.pods import PodAxis

LEAD = 2        # the rank dims a mesh leaf leads with: (data, model)


@dataclass(frozen=True)
class LeafSpec:
    """``shape``: the global shape; ``data`` / ``model``: the dim split
    over that axis, or ``None``; ``parts``: the fused halves the
    ``model`` dim holds side by side (1: none; module docstring)."""
    shape: tuple
    data: Optional[int] = None
    model: Optional[int] = None
    parts: int = 1

    def split(self, axis: str) -> Optional[int]:
        return self.data if axis == "data" else self.model

    def local(self, sizes: dict) -> tuple:
        out = list(self.shape)
        for axis in ("data", "model"):
            d = self.split(axis)
            if d is not None:
                out[d] //= sizes[axis]
        return tuple(out)


def mesh_spec(path: str, shape: Sequence[int], sizes: dict,
              heads: Optional[dict] = None) -> LeafSpec:
    """The dims of the leaf at ``path`` that a mesh of ``sizes`` (``{"data":
    D, "model": M}``) splits under the train rules.  An attention
    projection's head dim splits over ``model`` only by whole heads
    (``heads``: ``{"q": H, "kv": Kv}``), and a fused leaf by its parts
    (``sharding.fused_parts``)."""
    shape = tuple(int(s) for s in shape)
    logical = sharding.logical_axes(path, len(shape))
    if logical is None:
        return LeafSpec(shape)
    spec = sharding.safe_spec(shape, logical, sharding.train_rules(False),
                              {"data": sizes["data"], "model": sizes["model"]})
    dims = {}
    for d, axes in enumerate(spec):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None and sizes[a] > 1:
                dims[a] = d
    if "model" in dims and heads is not None:
        for pat, kind in sharding._HEAD_KERNELS.items():
            if re.search(pat, path) and heads[kind] % sizes["model"]:
                del dims["model"]
    model = dims.get("model")
    return LeafSpec(shape, dims.get("data"), model,
                    1 if model is None else sharding.fused_parts(path))


def _cut(t: torch.Tensor, dim: int, n: int, r: int,
         parts: int = 1) -> torch.Tensor:
    """Rank ``r`` of ``n``'s slice of ``t`` along ``dim``: its share of
    each of the ``parts`` halves, concatenated in order."""
    part = t.shape[dim] // parts
    k = part // n
    if parts == 1:
        return t.narrow(dim, r * k, k)
    return torch.cat([t.narrow(dim, h * part + r * k, k)
                      for h in range(parts)], dim=dim)


def _unfuse(t: torch.Tensor, dim: int, n: int, parts: int) -> torch.Tensor:
    """The ranks' ``[x_r | z_r]`` shards put end to end along ``dim`` ->
    the leaf's order, ``[x_0 .. x_n | z_0 .. z_n]``."""
    if parts == 1:
        return t
    chunks = t.chunk(n * parts, dim=dim)
    return torch.cat([chunks[r * parts + h] for h in range(parts)
                      for r in range(n)], dim=dim)


def _model_pods(mesh):
    """The model axis as a pod-like axis (ranks on dim 0): a ``PodAxis``
    emulated, the ``DistPodAxis`` of its sub-group over ranks."""
    axis = mesh.axis
    return axis.pods if hasattr(axis, "pods") else PodAxis(axis.n)


class MeshTree:
    """Layout operations on one leaf at a time, over ``mesh``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = {"data": mesh.dp_size, "model": mesh.tp_size}
        self.axes = {"data": mesh.data, "model": _model_pods(mesh)}
        self.held = {a: tuple(self.axes[a].held) for a in self.axes}

    def shard(self, leaf: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
        """``(Dl, Ml, *local)``: each held rank's shard of the full
        ``leaf`` (a new tensor)."""
        rows = []
        for d in (self.held["data"] if spec.data is not None else (0,)):
            row = []
            for m in (self.held["model"] if spec.model is not None
                      else (0,)):
                t = leaf
                for axis, r in (("data", d), ("model", m)):
                    dim = spec.split(axis)
                    if dim is not None:
                        t = _cut(t, dim, self.sizes[axis], r,
                                 spec.parts if axis == "model" else 1)
                row.append(t)
            rows.append(torch.stack(row))
        return torch.stack(rows).contiguous()

    def _gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """All-gather along per-rank dim ``dim`` of ``x``, whose leading
        dim holds the axis's held ranks: the concatenation, held once
        (a leading 1)."""
        return self.axes[axis].all_gather_dim(x, dim)[:1]

    def gather(self, x: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
        """The full leaf from its ``(Dl, Ml, *local)`` shards (every rank
        process gets it)."""
        if spec.model is not None:
            x = _unfuse(self._gather(x.movedim(1, 0), "model",
                                     spec.model + 1).movedim(0, 1),
                        spec.model + 2, self.sizes["model"], spec.parts)
        if spec.data is not None:
            x = self._gather(x, "data", spec.data + 1)
        return x[0, 0]

    def gather_data(self, x: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
        """FSDP: ``(Dl, Ml, *local)`` -> ``(Ml, *model-local)``, the data
        shards put together (one all-gather over ``data``)."""
        if spec.data is None:
            return x[0]
        return self._gather(x, "data", spec.data + 1)[0]

    def reduce_data(self, g: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
        """``(Dh, Ml, *model-local)``, each held data rank's gradient ->
        ``(Dl, Ml, *local)``: reduce-scattered over ``data`` where the
        leaf is split, all-reduced (and held once) where it is not."""
        if spec.data is not None:
            return self.axes["data"].reduce_scatter(g, spec.data + 1)
        return self.axes["data"].psum(g)[:1].contiguous()

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``x`` leading with ``(Dl, Ml)``: its sum over each axis in
        ``axes`` (the result held by every rank)."""
        if "data" in axes:
            x = self.axes["data"].psum(x)
        if "model" in axes:
            x = self.axes["model"].psum(x.movedim(1, 0)).movedim(0, 1)
        return x

    def counts(self, spec: LeafSpec) -> bool:
        """Whether this process counts the leaf's elements in a global
        sum: a leaf an axis does not split is counted once, by the
        process holding that axis's rank 0."""
        return all(spec.split(a) is not None or 0 in self.held[a]
                   for a in ("data", "model"))
