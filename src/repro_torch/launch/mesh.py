"""Meshes of the port: a ``data`` axis of one and a ``model`` axis.

Counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is the axis
sizes and the implementation of its ``model`` axis: emulated in this
process (:class:`~repro_torch.parallel.model_axis.ModelAxis`, the
reference's mesh over fabricated host devices) or this process's rank of
a group (``ranks=`` a ``DistPodAxis`` from ``parallel/dist.run_ranks``).
A ``data`` axis above one is mesh training and serving, ROADMAP Queue 1
item 9c, and raises.  ``make_production_mesh`` comes with its only user,
``launch/dryrun.py`` (item 10).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.parallel.model_axis import DistModelAxis, ModelAxis

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """``shape``: ``{"data": 1, "model": n}``; ``axis``: the model axis.
    ``lead`` marks the mesh of a rank-process engine's rank 0, whose
    serving cells send each call to the other ranks (``serve/ranks.py``)."""
    shape: dict
    axis: object
    lead: bool = False

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def tp_size(self) -> int:
        return self.shape["model"]

    @property
    def distributed(self) -> bool:
        return isinstance(self.axis, DistModelAxis)

    def leading(self) -> "Mesh":
        return dataclasses.replace(self, lead=True)


def make_mesh(shape, axes, ranks=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (``("data", "model")`` or
    ``("model",)``); ``ranks``: this process's ``DistPodAxis`` when each
    rank of ``model`` is a process."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or not set(axes) <= set(AXES) \
            or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} of shape {shape}: the port's "
                         f"meshes take the axes {AXES}")
    sizes = {"data": 1, "model": 1, **dict(zip(axes, shape))}
    if min(sizes.values()) < 1:
        raise ValueError(f"mesh shape {shape} needs sizes >= 1")
    if sizes["data"] > 1:
        raise NotImplementedError(
            f"a data axis of {sizes['data']}: meshes with a data axis "
            "(mesh training, sequence parallelism, the pipeline) are a "
            "later slice of the port (ROADMAP Queue 1 item 9c)")
    if ranks is None:
        return Mesh(sizes, ModelAxis(sizes["model"]))
    if ranks.n != sizes["model"]:
        raise ValueError(f"a model axis of {sizes['model']} over a group "
                         f"of {ranks.n} ranks")
    return Mesh(sizes, DistModelAxis(ranks))


def make_host_mesh(n_data: int = 1, n_model: int = 1, ranks=None) -> Mesh:
    """A ``(n_data, n_model)`` mesh over ``("data", "model")``."""
    return make_mesh((n_data, n_model), AXES, ranks=ranks)
