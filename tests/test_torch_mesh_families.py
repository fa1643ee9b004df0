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
"""
import pytest

import test_torch_mesh_train as base
from repro_torch.parallel import rank_bodies

HERE = ("rwkv_2x1", "moe_2x1", "bias_1x2")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return base.run_reference(tmp_path_factory, HERE)


@pytest.fixture(scope="module")
def ranked():
    return base.run_ranked(HERE)


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

