"""Mesh training of the port against the JAX package, on the CPU: a data
axis alone on the ssm and moe families, and the model axis on a dense
model with biases.

The cases, tolerances and their reasons are
``tests/test_torch_mesh_train.py``'s (its ``CASES``; this module runs the
ones that module does not, so that each module's reference subprocess
stays short): ``rwkv_2x1`` and ``moe_2x1`` on ``(data, model)``, and
``bias_1x2``, OLMo with a bias on every dense layer, whose q/k/v and
wi/wg biases each rank of the model axis reads cut to its slice — each
emulated in this process and over gloo rank processes,
against the reference's ``jit_train_step`` on 4 forced host devices.
Also ``moe_pods_2x1x1``: Moonlight stock over two ranked pods (a
``DistPodAxis``, each pod routing its own rows, as the reference's stock
step on a pod mesh routes each pod's shard), three of every four labels
of pod 0's rows masked, against the reference's global step — its loss,
load balance, z-loss, gradient norm and parameters.  (Emulated, stock
takes the whole batch in one pass and routes it as one, so it has no
emulated form here.)
"""
import pytest

import test_torch_mesh_train as base
from repro_torch.parallel import rank_bodies

HERE = ("rwkv_2x1", "moe_2x1", "bias_1x2")
MOE_PODS = "moe_pods_2x1x1"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return base.run_reference(tmp_path_factory, HERE + (MOE_PODS,))


@pytest.fixture(scope="module")
def ranked():
    return base.run_ranked(HERE + (MOE_PODS,))


@pytest.fixture(scope="module")
def emulated():
    return {c: rank_bodies.mesh_train(None, *base._case_args(c))
            for c in HERE}


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_mesh_step_matches_the_reference(name, at, reference,
                                                  emulated):
    base._hold(emulated[name], reference, name, at)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                ranked, emulated):
    base.test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                     ranked, emulated)



@pytest.mark.parametrize("at", base.RECORD)
def test_moe_stock_over_ranked_pods_is_the_global_step(at, reference,
                                                       ranked):
    """Rank 0's loss, gradient norm and parameters against the reference's
    global step (``base._hold``), and its load balance and z-loss by the
    loss's tolerances: the load balance is the product of the global
    batch's per-expert density and router mean, each pod's density
    reduced over ``pod`` before the product.  Every rank reports the same
    global metrics beside the pods' own losses, which differ."""
    runs = ranked[MOE_PODS]
    base._hold(runs[0], reference, MOE_PODS, at)
    tol = 1e-5 if at == 1 else 1e-4
    got = runs[0]["steps"][at]
    for k in ("lb_loss", "z_loss"):
        want = float(reference[f"{MOE_PODS}/{at}/{k}"])
        assert want > 0 and abs(got[k] - want) < tol, (k, got[k], want)
    assert got["loss_per_pod"][0] != got["loss_per_pod"][1]
    for r in runs:
        for k in ("loss", "lb_loss", "z_loss", "loss_per_pod"):
            assert r["steps"][at][k] == got[k], k
