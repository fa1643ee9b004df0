"""``parallel/pipeline.py`` against the reference's, on the CPU.

The pipeline half of ``tests/test_collectives.py`` on the same sizes — 4
stages, ``D`` 8, microbatches of 4 rows, 6 of them, ``stage_fn = tanh(x
@ w)`` — with inputs drawn by numpy from fixed seeds: the reference's
``pipeline`` and the gradient of its ``pipelined_loss`` (a mean squared
error against zeros) under ``shard_map`` over a ``stage`` mesh of 4
forced host devices, in one JAX subprocess; the port's on an emulated
``PodAxis(4)`` and over 4 gloo rank processes, one a stage.  The forward
is held within 1e-5 and the gradient within 1e-4 (the reference's own
test's tolerances against the sequential composition), and both against
that composition too.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel import dist, rank_bodies
from repro_torch.parallel.pods import PodAxis

ROOT = Path(__file__).resolve().parents[1]
STAGES, D, MB, NM = 4, 8, 4, 6

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.parallel import compat, pipeline as PP
d = np.load(sys.argv[1])
ws, mbs, tgt = (jnp.asarray(d[k]) for k in ("ws", "mbs", "tgt"))
mesh = make_mesh((4,), ("stage",))
stage_fn = lambda w, x: jnp.tanh(x @ w)
app = PP.pipeline(stage_fn, 4)
out = jax.jit(compat.shard_map(lambda w, m: app(w, m), mesh=mesh,
                               in_specs=(P("stage", None, None), P(None)),
                               out_specs=P(None), axis_names={"stage"},
                               check=True))(ws, mbs)
lf = PP.pipelined_loss(stage_fn, lambda o, t: jnp.mean((o - t) ** 2), 4)
grad = jax.jit(compat.shard_map(jax.grad(lambda w: lf(w, mbs, tgt)),
                                mesh=mesh,
                                in_specs=(P("stage", None, None),),
                                out_specs=P("stage", None, None),
                                axis_names={"stage"}, check=True))(ws)
np.savez(sys.argv[2], out=np.asarray(out), grad=np.asarray(grad))
print("REF_OK")
"""


def _inputs():
    ws = (np.random.default_rng(1).standard_normal((STAGES, D, D))
          * 0.5).astype(np.float32)
    mbs = np.random.default_rng(2).standard_normal((NM, MB, D)).astype(
        np.float32)
    return ws, mbs, np.zeros_like(mbs)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    ws, mbs, tgt = _inputs()
    np.savez(d / "in.npz", ws=ws, mbs=mbs, tgt=tgt)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(d / "in.npz"),
                          str(d / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def sequential():
    """The stages composed one after another, and the loss's gradient."""
    ws, mbs, tgt = _inputs()
    w = torch.tensor(ws, requires_grad=True)
    x = torch.tensor(mbs)
    for s in range(STAGES):
        x = torch.tanh(x @ w[s])
    grad, = torch.autograd.grad(torch.mean((x - torch.tensor(tgt)) ** 2), w)
    return x.detach().numpy(), grad.numpy()


@pytest.fixture(scope="module")
def runs():
    ws, mbs, tgt = _inputs()
    emu = rank_bodies.pipeline_run(PodAxis(STAGES), ws, mbs, tgt)
    ranked = dist.run_ranks(rank_bodies.pipeline_run, STAGES,
                            backend="gloo", device="cpu",
                            args=(ws, mbs, tgt))
    return {"emulated": emu,
            "ranked": {k: np.concatenate([r[k] for r in ranked])
                       for k in ("out", "loss", "grad")}}


@pytest.mark.parametrize("form", ["emulated", "ranked"])
def test_pipeline_forward_matches_the_reference(form, runs, reference,
                                                sequential):
    out = runs[form]["out"]
    assert out.shape == (STAGES, NM, MB, D)
    for s in range(STAGES):          # every stage holds the last's outputs
        assert np.abs(out[s] - reference["out"]).max() < 1e-5
        assert np.abs(out[s] - sequential[0]).max() < 1e-5


@pytest.mark.parametrize("form", ["emulated", "ranked"])
def test_pipelined_loss_gradient_matches_the_reference(form, runs, reference,
                                                       sequential):
    """The gradient flows back through the shifts (over ranks, the
    reversed permutation) once: no ``n_stages`` overcount; every stage
    returns the same loss."""
    got = runs[form]
    assert np.abs(got["grad"] - reference["grad"]).max() < 1e-4
    assert np.abs(got["grad"] - sequential[1]).max() < 1e-4
    want = float(np.mean(sequential[0] ** 2))
    assert np.abs(got["loss"] - want).max() < 1e-6


def test_pipeline_counts_its_shifts_over_ranks(runs):
    """Over ranks, forward shifts once a tick, backward once a tick but
    the last (the last tick's shifted output feeds nothing)."""
    ws, mbs, tgt = _inputs()
    res = dist.run_ranks(rank_bodies.pipeline_exchanges, 2, backend="gloo",
                         device="cpu", args=(ws[:2], mbs, tgt))
    ticks = NM + 2 - 1
    for r in res:
        # forward: pipeline + pipelined_loss, each one shift a tick;
        # backward of the loss: one reversed shift a tick but the last
        assert r["ring_shift"] == 2 * ticks + ticks - 1
