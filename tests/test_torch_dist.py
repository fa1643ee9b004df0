"""The ``pod`` axis over ``torch.distributed``, one process a rank, on the
CPU: 4 gloo ranks against the emulated ``PodAxis(4)`` and the reference.

ONE rank group for the module (``parallel/dist.run_ranks``, 4 spawned
processes; the bodies are ``repro_torch.parallel.rank_bodies``'s, which
import nothing of the reference) runs every case; each test asserts one
of them:

* ``DistPodAxis``'s operations against ``PodAxis``'s, row by row;
* ``reduce_gradients`` for every method, leafwise and bucketed, serial and
  pipelined (the cases of ``tests/test_torch_collectives.py``) against the
  emulated axis — bit-equal, except ``stock``'s ``pmean``, whose sum order
  gloo chooses: within ``n`` f32 spacings of the largest value — and
  against the reference's per-device outputs from its subprocess over 4
  forced host devices, by that module's tolerances (``int8_pairwise``
  rank by rank: each rank sums the ring in its own order);
* the train step over 4 ranks at smoke size against the emulated step:
  per-rank losses and parameters by ``tests/test_torch_train.py``'s
  tolerances (the ranks run their matmuls with other thread counts, so
  the sums may differ in the last bits), and parameters bit-equal across
  the ranks after every step;
* ``stock`` over the 4 ranks with three of every four labels of pod 0's
  rows masked, so that the pods hold different numbers of unmasked
  labels: the reference's global step — its first loss against the
  reference's loss on the global batch from the same parameters, its
  losses and parameters against the emulated one-pass step by the same
  tolerances (a mean of the pods' means would be off by far more);
* ``nccl`` with more ranks than cards is refused before any process
  starts, and a rank that fails fails the call.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, smoke
from repro_torch.parallel import collectives, dist, rank_bodies
from repro_torch.parallel.pods import PodAxis
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

import test_torch_collectives as tc

ROOT = Path(__file__).resolve().parents[1]
N = tc.N
EPS32 = float(np.finfo(np.float32).eps)
X_SHAPE = (N, 3, 40)
TRAIN = dict(steps=2, seq_len=32, global_batch=8)
TRAIN_OPTS = tstep.TrainOptions(dp_method="int8_ring", remat=False,
                                dp_bucket_bytes=64 << 10,
                                opt=topt.OptConfig(lr=1e-3, warmup_steps=2,
                                                   decay_steps=10))
STOCK_OPTS = dataclasses.replace(TRAIN_OPTS, dp_method="stock")
MASKED_ROWS = TRAIN["global_batch"] // N        # pod 0's rows


def _axis_inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(X_SHAPE) * 10).astype(np.float32)
    chunks = rng.standard_normal((N, N, 5, 7)).astype(np.float32)
    return x, chunks


def _cases():
    return [(tc._name(c), c[0], c[1], c[2],
             "kernel" if c[3] == "pallas" else "auto") for c in tc.CASES]


def _train_cfg():
    return dataclasses.replace(smoke(all_archs()["olmo-1b"]),
                               dtype="float32")


@pytest.fixture(scope="module")
def group():
    """Every rank's results, from one group of 4 gloo ranks."""
    g, e = tc._inputs()
    x, chunks = _axis_inputs()
    return dist.run_ranks(rank_bodies.in_turn, N, backend="gloo",
                          device="cpu", args=([
                              (rank_bodies.loaded_reference, ()),
                              (rank_bodies.axis_ops, (x, chunks)),
                              (rank_bodies.reduce_cases,
                               (g, e, _cases(), tc.BUCKET_BYTES)),
                              (rank_bodies.train_steps,
                               (_train_cfg(), TRAIN_OPTS, TRAIN["steps"],
                                TRAIN["seq_len"], TRAIN["global_batch"], 0,
                                True)),
                              (rank_bodies.train_steps,
                               (_train_cfg(), STOCK_OPTS, TRAIN["steps"],
                                TRAIN["seq_len"], TRAIN["global_batch"], 0,
                                True, None, MASKED_ROWS)),
                          ],), timeout_s=600)


@pytest.fixture(scope="module")
def emulated():
    """The same cases over ``PodAxis(4)`` in this process."""
    g, e = tc._inputs()
    x, chunks = _axis_inputs()
    pods = PodAxis(N)
    return {"axis": rank_bodies.axis_ops(pods, x, chunks),
            "reduce": rank_bodies.reduce_cases(pods, g, e, _cases(),
                                               tc.BUCKET_BYTES),
            "train": rank_bodies.train_steps(
                pods, _train_cfg(), TRAIN_OPTS, TRAIN["steps"],
                TRAIN["seq_len"], TRAIN["global_batch"], 0, True),
            "stock": rank_bodies.train_steps(
                pods, _train_cfg(), STOCK_OPTS, TRAIN["steps"],
                TRAIN["seq_len"], TRAIN["global_batch"], 0, True, None,
                MASKED_ROWS)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-device outputs of the same cases (the
    subprocess of ``tests/test_torch_collectives.py``)."""
    path = tmp_path_factory.mktemp("ref") / "collectives.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", tc.SCRIPT, str(path),
                          str(Path(tc.__file__).resolve())],
                         env=env, capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


def test_ranks_import_nothing_of_the_reference(group):
    assert [r[0] for r in group] == [[]] * N


@pytest.mark.parametrize("op", ["axis_index", "all_to_all", "all_gather",
                                "all_gather_int8", "ring_shift", "psum",
                                "pmean", "pmean_bf16"])
def test_axis_operations_match_the_emulated_axis(op, group, emulated):
    want = emulated["axis"][op]
    for r, res in enumerate(group):
        got = res[1][op]
        assert got.shape == (1,) + want.shape[1:], (op, got.shape)
        if op in ("psum", "pmean"):     # gloo's sum order
            tol = N * EPS32 * np.abs(want).max() * N
            assert np.abs(got[0] - want[r]).max() <= tol, op
        elif op == "pmean_bf16":        # f32 sums, one bf16 rounding
            spacing = 2.0 ** (np.floor(np.log2(np.abs(want[r]) + 1e-30))
                              - 7)
            assert (np.abs(got[0] - want[r]) <= spacing).all(), op
        else:
            assert (got[0] == want[r]).all(), op


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_reduce_gradients_over_ranks(case, group, emulated, reference):
    """Leaves reduced by ``pmean`` (``stock``, and every method's leaves
    below ``MIN_COMPRESS_SIZE``) within the sum-order bound; every other
    output and every residual bit-equal to the emulated axis's row."""
    name, method = case[0], case[1]
    g, e = tc._inputs()
    emu = emulated["reduce"][name]
    for r, res in enumerate(group):
        got = res[2][name]
        assert got["chains"] == emu["chains"] \
            == int(reference[name + "/chains"])
        for k, shape in tc.SHAPES.items():
            out, want = got["out"][k][0], emu["out"][k][r]
            ref = reference[f"{name}/out/{k}"].reshape((N,) + shape)[r]
            if method == "stock" or \
                    np.prod(shape) < collectives.MIN_COMPRESS_SIZE:
                tol = N * EPS32 * np.abs(g[k]).max()
                assert np.abs(out - want).max() <= tol, (k, r)
                assert np.abs(out - ref).max() <= tol, (k, r)
            else:
                assert (out == want).all(), (k, r)
                # the reference's device r, by test_torch_collectives'
                # rules
                step = 0.0 if method == "ring" \
                    else np.abs(ref).max() / 127 * 1.01
                assert np.abs(out - ref).max() <= step, (k, r)
            if method == "stock":
                continue
            assert (got["res"][k][0] == emu["res"][k][r]).all(), (k, r)
            ref_r = reference[f"{name}/res/{k}"].reshape((N,) + shape)[r]
            x = np.abs(g[k] + e[k]).max()
            tol = 0.0 if method == "ring" else EPS32 * x
            assert np.abs(got["res"][k][0] - ref_r).max() <= tol, k


@pytest.mark.parametrize("at", range(TRAIN["steps"]))
def test_train_step_over_ranks_matches_the_emulated_step(at, group,
                                                         emulated):
    emu = emulated["train"]
    tol = 1e-5 if at == 0 else 1e-4
    for r, res in enumerate(group):
        run = res[3]
        assert np.abs(np.array(run["losses"][at])
                      - np.array(emu["losses"][at])).max() < tol
        # every rank holds bit-equal parameters after every step
        assert run["digests"][at] == group[0][3]["digests"][at]
    if at == TRAIN["steps"] - 1:
        tol_p = 0.2 * TRAIN["steps"] * TRAIN_OPTS.opt.lr
        for path, want in emu["params"].items():
            got = group[0][3]["params"][path]
            assert np.abs(got - want).max() <= tol_p, path


def _reference_loss(params: dict, masked_rows: int) -> float:
    """The reference's loss of the global first batch (its rows masked as
    the ranks' are) at ``params`` (flat numpy leaves), in this process."""
    import jax
    import jax.numpy as jnp
    from repro.configs import all_archs as j_all_archs
    from repro.configs import smoke as j_smoke
    from repro.train import step as jstep
    from repro_torch.data import pipeline

    jcfg = dataclasses.replace(j_smoke(j_all_archs()["olmo-1b"]),
                               dtype="float32")
    from repro_torch import bridge
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  bridge._nest(params, _train_cfg()))
    dcfg = pipeline.DataConfig(vocab_size=jcfg.vocab_size,
                               seq_len=TRAIN["seq_len"],
                               global_batch=TRAIN["global_batch"])
    batch = pipeline.synth_batch(dcfg, 0)
    batch["labels"] = rank_bodies.mask_labels(batch["labels"], masked_rows)
    _, met = jstep.make_loss_fn(jcfg, jstep.TrainOptions(remat=False))(
        tree, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return float(jax.device_get(met["loss"]))


@pytest.mark.parametrize("at", range(TRAIN["steps"]))
def test_stock_over_ranks_is_the_global_step(at, group, emulated):
    """``stock`` over 4 rank processes whose pods hold unequal counts of
    unmasked labels: the reference's global loss (one ``Σ nll / Σ mask``
    over every pod's rows), where the parent step reported pod 0's and
    averaged the pods' mean gradients."""
    emu = emulated["stock"]
    tol = 1e-5 if at == 0 else 1e-4
    own = group[0][4]["losses"][at]
    for r, res in enumerate(group):
        run = res[4]
        assert abs(run["loss"][at] - emu["loss"][at]) < tol, r
        assert run["losses"][at] == own          # each pod's own mean
        assert run["digests"][at] == group[0][4]["digests"][at]
    # pod 0's own loss differs from the global one by far more than the
    # tolerance, and on the first batch so does the mean of the means
    assert abs(own[0] - emu["loss"][at]) > 10 * tol
    if at == 0:
        assert abs(np.mean(own) - emu["loss"][at]) > 10 * tol
        want = _reference_loss(group[0][4]["initial"], MASKED_ROWS)
        assert abs(group[0][4]["loss"][0] - want) < 1e-5
    if at == TRAIN["steps"] - 1:
        tol_p = 0.2 * TRAIN["steps"] * STOCK_OPTS.opt.lr
        for path, want in emu["params"].items():
            got = group[0][4]["params"][path]
            assert np.abs(got - want).max() <= tol_p, path


def test_nccl_with_more_ranks_than_cards_is_refused(monkeypatch):
    """Refused by the port before NCCL starts, never swapped for gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        dist.run_ranks(rank_bodies.loaded_reference, N, backend="nccl",
                       device="cuda")
    with pytest.raises(ValueError, match="exchanges CUDA tensors"):
        dist.check_group(1, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend 'auto'"):
        dist.check_group(2, "auto", "cpu")


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
        dist.run_ranks(int, 2, backend="gloo", device="cpu", timeout_s=120)
