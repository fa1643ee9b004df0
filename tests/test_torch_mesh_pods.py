"""Mesh training of the port against the JAX package, on the CPU: the
pod axis above a ``(data, model)`` mesh with ``int8_ring``.

The cases, tolerances and their reasons are
``tests/test_torch_mesh_train.py``'s (its ``CASES``; this module runs the
ones that module does not, so that each module's reference subprocess
stays short): ``ring_2x1x2`` and ``ring_2x2x1`` on ``("pod", "data",
"model")`` — each emulated in this process and over gloo rank processes,
against the reference's ``jit_train_step`` on 4 forced host devices.
Also ``stock_pods_2x1x2``, stock on that mesh with three of every four
labels of pod 0's rows masked, emulated (one pass over the whole batch)
and over gloo rank processes (each pod's rows on its ranks, each pod's
``Σ nll`` over the global batch's count, the load-balance means over
``pod``): the reference's global loss and step either way (a pod's own
loss, or a mean of the pods' means, would be off by far more than the
tolerance).
"""
import pytest

import test_torch_mesh_train as base
from repro_torch.parallel import rank_bodies

HERE = ("ring_2x1x2", "ring_2x2x1")
STOCK = "stock_pods_2x1x2"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return base.run_reference(tmp_path_factory, HERE + (STOCK,))


@pytest.fixture(scope="module")
def ranked():
    return base.run_ranked(HERE + (STOCK,))


@pytest.fixture(scope="module")
def emulated():
    return {c: rank_bodies.mesh_train(None, *base._case_args(c))
            for c in HERE + (STOCK,)}


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_mesh_step_matches_the_reference(name, at, reference,
                                                  emulated):
    base._hold(emulated[name], reference, name, at)


@pytest.mark.parametrize("at", base.RECORD)
def test_stock_on_an_emulated_pod_mesh_is_the_global_step(at, reference,
                                                          emulated):
    base._hold(emulated[STOCK], reference, STOCK, at)
    assert emulated[STOCK]["steps"][at]["loss_per_pod"] is None


@pytest.mark.parametrize("at", base.RECORD)
def test_stock_on_a_ranked_pod_mesh_is_the_global_step(at, reference,
                                                       ranked):
    """The masked stock case over 4 rank processes: rank 0's gathered
    parameters, loss and gradient norm against the reference's global
    step, every rank's loss the same; each pod's own loss kept beside
    it."""
    runs = ranked[STOCK]
    base._hold(runs[0], reference, STOCK, at)
    pods = runs[0]["steps"][at]["loss_per_pod"]
    assert pods[0] != pods[1]
    for r in runs:
        assert r["steps"][at]["loss"] == runs[0]["steps"][at]["loss"]
        assert r["steps"][at]["loss_per_pod"] == pods


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                ranked, emulated):
    base.test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                     ranked, emulated)


def test_pods_above_the_mesh_keep_their_own_losses(ranked):
    """Over the ranks each pod's loss is its own rows' (the pods' losses
    differ), gathered alike on every rank, and the reported loss is pod
    0's."""
    for name in ("ring_2x1x2", "ring_2x2x1"):
        for at in base.RECORD:
            pods = [r["steps"][at]["loss_per_pod"] for r in ranked[name]]
            assert all(p == pods[0] for p in pods)
            assert pods[0][0] != pods[0][1]
            assert ranked[name][0]["steps"][at]["loss"] == pods[0][0]
