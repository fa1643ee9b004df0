"""Meshes of the port: ``pod``, ``data`` and ``model`` axes.

Counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is the axis
sizes and an implementation of each axis: emulated in this process (the
reference's mesh over fabricated host devices) or this process's rank of
a group of rank processes (``ranks=`` the ``DistPodAxis`` that
``parallel/dist.run_ranks`` gives each rank), whose axes are sub-groups
of the rank grid (``parallel/dist.grid_axes``: the ranks laid out
row-major over the shape, as a mesh's devices are).

* ``model`` — :class:`~repro_torch.parallel.model_axis.ModelAxis`
  emulated, :class:`~repro_torch.parallel.model_axis.DistModelAxis` over
  its sub-group: tensor parallelism (heads, FFN width, vocabulary).
* ``data`` — a ``PodAxis`` emulated, a ``DistPodAxis`` over its
  sub-group: batch rows, and the FSDP shards of each parameter's
  ``embed`` dim (``parallel/mesh_tree.mesh_spec``).
* ``pod`` — the same two: batch rows above ``data``, reduced over the
  slow link by ``parallel/collectives.reduce_gradients``.

An axis the mesh does not name has size one.  ``make_production_mesh``
comes with its only user, ``launch/dryrun.py`` (ROADMAP Queue 1 item
10).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.parallel.model_axis import DistModelAxis, ModelAxis
from repro_torch.parallel.pods import DistPodAxis, PodAxis

AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class Mesh:
    """``shape``: the named axes' sizes, in ``AXES`` order (``data`` and
    ``model`` always present); ``axis``: the model axis; ``data`` and
    ``pod``: the data and pod axes (``pod`` ``None`` without one).
    ``lead`` marks the mesh of a rank-process engine's rank 0, whose
    serving cells send each call to the other ranks (``serve/ranks.py``);
    ``world`` is the rank's axis over the whole group (``None``
    emulated)."""
    shape: dict
    axis: object
    data: object = None
    pod: object = None
    lead: bool = False
    world: Optional[DistPodAxis] = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def tp_size(self) -> int:
        return self.shape["model"]

    @property
    def dp_size(self) -> int:
        return self.shape["data"]

    @property
    def distributed(self) -> bool:
        return isinstance(self.axis, DistModelAxis)

    @property
    def is_lead(self) -> bool:
        """Whether this process holds rank 0 of every axis (emulated:
        always)."""
        return self.world is None or self.world.rank == 0

    def leading(self) -> "Mesh":
        return dataclasses.replace(self, lead=True)


def _check(shape: tuple, axes: tuple) -> dict:
    if len(shape) != len(axes) or not set(axes) <= set(AXES) \
            or len(set(axes)) != len(axes) \
            or list(axes) != [a for a in AXES if a in axes]:
        raise ValueError(f"mesh axes {axes} of shape {shape}: the port's "
                         f"meshes take the axes {AXES}, in that order")
    if min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} needs sizes >= 1")
    sizes = dict(zip(axes, shape))
    out = {"pod": sizes["pod"]} if "pod" in sizes else {}
    out.update(data=sizes.get("data", 1), model=sizes.get("model", 1))
    return out


def make_mesh(shape, axes, ranks=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (a subsequence of ``AXES``:
    ``("data", "model")``, ``("model",)``, ``("pod", "model")``,
    ``("pod", "data", "model")``, ...); ``ranks``: this process's
    ``DistPodAxis`` over the whole group when each rank of the mesh is a
    process (the group's size is the mesh's; every rank must build the
    same mesh)."""
    sizes = _check(tuple(int(s) for s in shape), tuple(axes))
    if ranks is None:
        pod = PodAxis(sizes["pod"]) if "pod" in sizes else None
        return Mesh(sizes, ModelAxis(sizes["model"]), PodAxis(sizes["data"]),
                    pod)
    n = math.prod(sizes.values())
    if ranks.n != n:
        raise ValueError(f"a mesh of {n} ranks {sizes} over a group of "
                         f"{ranks.n} ranks")
    from repro_torch.parallel.dist import grid_axes
    sub = grid_axes(ranks, tuple(sizes.values()), tuple(sizes))
    return Mesh(sizes, DistModelAxis(sub["model"]), sub["data"],
                sub.get("pod"), world=ranks)


def make_host_mesh(n_data: int = 1, n_model: int = 1, ranks=None) -> Mesh:
    """A ``(n_data, n_model)`` mesh over ``("data", "model")``."""
    return make_mesh((n_data, n_model), ("data", "model"), ranks=ranks)
