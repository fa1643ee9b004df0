"""Mesh training of the port against the JAX package, on the CPU.

The reference's ``jit_train_step`` on meshes of 4 forced host devices
(one JAX subprocess for the module, saved to an ``.npz``) against the
port's mesh step (``train/step.py`` on a ``launch/mesh.Mesh``), emulated
in this process and over gloo rank processes (``parallel/dist.run_ranks``:
one group of 4 for the module's 4-rank meshes, one of 2 for the ``(2,
1)`` ones).  Each case trains f32 smoke models 3 steps from the
reference's initial parameters, on ``synth_batch``:

* OLMo at ``(data, model)`` ``(2, 2)`` and ``(1, 4)``, stock, with and
  without ``sequence_parallel`` (the other families' sequence
  parallelism: ``tests/test_torch_mesh_train_sp_families.py``);
* OLMo on ``("pod", "data", "model")`` ``(2, 1, 2)`` and ``(2, 2, 1)``
  with ``int8_ring`` (64 KiB buckets);
* RWKV-6 and Moonlight at ``(2, 1)``: a data axis alone is
  family-agnostic (Moonlight's load balance is the product of its two
  means over the global batch, the reference's);
* OLMo at ``(2, 2)`` with three of every four labels of data rank 0's
  rows masked, so the data ranks hold unequal counts: a mean of the
  ranks' means would be off by far more than the tolerance;
* OLMo with a bias on every dense layer at ``(1, 2)``, stock on
  ``("pod", "data", "model")`` ``(2, 1, 2)`` with pod 0's labels masked
  so, and Moonlight stock over ``(2, 1, 1)`` (two ranked pods, pod 0's
  labels masked so; its aux losses held too)
  (``tests/test_torch_mesh_families.py``,
  ``tests/test_torch_mesh_pods.py``).

Tolerances, those of ``tests/test_torch_train.py`` and for its reasons
(autograd and XLA sum in other orders, ~1e-7 relative): loss 1e-5 after
one step and 1e-4 after three; ``grad_norm`` 1e-5 relative; parameters
within 2% of the step's ``lr`` after one step and 20% of the most three
steps' ``lr`` can sum to after three, their mean difference within 1e-6.

The reference's subprocess also saves its first-step gradient of the
global batch, under the stock step's shardings on the case's mesh, the
batch sharded over ``pod`` too where the mesh has one (so an MoE routes
each pod's and data shard's tokens on their own, as the reference's
step does).  The elements that keep a looser bound are chosen by that
gradient, never by the port's:

* after one step, an element whose gradient is within f32 rounding of
  zero (below 1e-5 of its leaf's largest, where sums of the leaf's larger
  terms leave ~1e-7 relative noise) may move by anything up to ``2 lr``:
  AdamW's first update is ``g / (|g| + eps)``.  Such elements were at
  most 0.15 % of a leaf (Moonlight's; 62 % of RWKV's embedding, the rows
  of tokens absent from the batch, whose gradient is zero) when this
  test was written.

The pod-above-mesh cases differ from the reference by design: each
``(data, model)`` rank packs its own local shards into its buckets, and
the reference packs the pod's whole leaves, so the two quantize other
rows and the int8 roundings fall differently.  The loss of the first
step (before any reduction) keeps 1e-5.  After a reduction an element
may differ by one int8 step of either side's row scale, a few 1e-3 of
the row's largest gradient: the gradient norm is held within 1e-3
relative, the losses after three steps within 1e-3.  Neither side's row
scale is known here (a row spans other leaves, and holds one pod's
half-batch gradient, up to about twice the global one), so an element
counts as resolved where its gradient is at least ``RESOLVED``, 8 int8
steps of its leaf's largest: it keeps its sign through the ring's three
quantizations (before the hop, at the hop, before the gather) with room
for those factors, and keeps the stock rule (2 % of ``lr`` after one
step, 20 % of three steps' ``lr`` after three).  An element below that
may quantize to zero on one side and not the other, or flip its sign:
AdamW's normalized update then moves it by up to ``2 lr`` (times ``1 +
wd |p|``, under 1.1 here) more on one side, so it is held within ``2.2
lr`` a step, and the mean difference of all elements within ``0.1 lr``
a step.  When this test was written 55 % of the elements were resolved
(at least 24 % of every leaf); they differed by at most 3e-5 of
``OPT["lr"]`` after one step and 0.39 of it after three, where the
stock rule allows 0.6.

Further: Adafactor on a 2-D leaf split over both axes against the
reference's update of the whole leaf, emulated and over 4 ranks; a
checkpoint saved on a ``(2, 2)`` mesh resumed on one device and the
reverse, against 4 one-device steps.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import all_archs, smoke
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import common
from repro_torch.parallel import dist, rank_bodies
from repro_torch.parallel.mesh_tree import LeafSpec, MeshTree
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, STEPS = 32, 8, 3
RECORD = (1, 3)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
BUCKET = 64 << 10
MASKED_ROWS = BATCH // 2            # data rank 0's rows at (2, 2)
# name: (arch, shape, axes, dp_method, sequence_parallel, masked rows)
CASES = {
    "stock_2x2": ("olmo-1b", (2, 2), ("data", "model"), "stock", False, 0),
    "stock_1x4": ("olmo-1b", (1, 4), ("data", "model"), "stock", False, 0),
    "sp_2x2": ("olmo-1b", (2, 2), ("data", "model"), "stock", True, 0),
    "sp_1x4": ("olmo-1b", (1, 4), ("data", "model"), "stock", True, 0),
    "ring_2x1x2": ("olmo-1b", (2, 1, 2), ("pod", "data", "model"),
                   "int8_ring", False, 0),
    "ring_2x2x1": ("olmo-1b", (2, 2, 1), ("pod", "data", "model"),
                   "int8_ring", False, 0),
    "rwkv_2x1": ("rwkv6-7b", (2, 1), ("data", "model"), "stock", False, 0),
    "moe_2x1": ("moonshot-v1-16b-a3b", (2, 1), ("data", "model"), "stock",
                False, 0),
    "masked_2x2": ("olmo-1b", (2, 2), ("data", "model"), "stock", False,
                   MASKED_ROWS),
    "bias_1x2": ("olmo-1b+bias", (1, 2), ("data", "model"), "stock", False,
                 0),
    "stock_pods_2x1x2": ("olmo-1b", (2, 1, 2), ("pod", "data", "model"),
                         "stock", False, MASKED_ROWS),
    "moe_pods_2x1x1": ("moonshot-v1-16b-a3b", (2, 1, 1),
                       ("pod", "data", "model"), "stock", False,
                       MASKED_ROWS),
    # the moe and ssm families over the model axis
    # (``tests/test_torch_mesh_train_tp_families.py``)
    "moe_1x2": ("moonshot-v1-16b-a3b", (1, 2), ("data", "model"), "stock",
                False, 0),
    "rwkv_1x2": ("rwkv6-7b", (1, 2), ("data", "model"), "stock", False, 0),
    "moe_2x2": ("moonshot-v1-16b-a3b", (2, 2), ("data", "model"), "stock",
                False, 0),
    "rwkv_2x2": ("rwkv6-7b", (2, 2), ("data", "model"), "stock", False, 0),
    "moe_ring_2x1x2": ("moonshot-v1-16b-a3b", (2, 1, 2),
                       ("pod", "data", "model"), "int8_ring", False, 0),
    "rwkv_ring_2x1x2": ("rwkv6-7b", (2, 1, 2), ("pod", "data", "model"),
                        "int8_ring", False, 0),
    # the hybrid, encdec and vlm families over the model axis
    # (``tests/test_torch_mesh_train_tp_{hybrid,encdec_vlm}.py``)
    "jamba_2x2": ("jamba-1.5-large-398b", (2, 2), ("data", "model"),
                  "stock", False, 0),
    "jamba_attn_2x2": ("jamba-1.5-large-398b+attn", (2, 2),
                       ("data", "model"), "stock", False, 0),
    "jamba_ring_2x1x2": ("jamba-1.5-large-398b", (2, 1, 2),
                         ("pod", "data", "model"), "int8_ring", False, 0),
    "whisper_2x2": ("whisper-base", (2, 2), ("data", "model"), "stock",
                    False, 0),
    "vlm_2x2": ("internvl2-26b", (2, 2), ("data", "model"), "stock", False,
                0),
    "vlm_odd_2x2": ("internvl2-26b+odd", (2, 2), ("data", "model"), "stock",
                    False, 0),
    # sequence parallelism on the moe, ssm, hybrid, encdec and vlm families
    # (``tests/test_torch_mesh_train_sp_families.py``)
    "moe_sp_2x2": ("moonshot-v1-16b-a3b", (2, 2), ("data", "model"),
                   "stock", True, 0),
    "rwkv_sp_2x2": ("rwkv6-7b", (2, 2), ("data", "model"), "stock", True, 0),
    "jamba_sp_2x2": ("jamba-1.5-large-398b", (2, 2), ("data", "model"),
                     "stock", True, 0),
    "jamba_attn_sp_2x2": ("jamba-1.5-large-398b+attn", (2, 2),
                          ("data", "model"), "stock", True, 0),
    "whisper_sp_2x2": ("whisper-base", (2, 2), ("data", "model"), "stock",
                       True, 0),
    "vlm_sp_2x2": ("internvl2-26b", (2, 2), ("data", "model"), "stock", True,
                   0),
    "vlm_odd_sp_2x2": ("internvl2-26b+odd", (2, 2), ("data", "model"),
                       "stock", True, 0),
}
# the smoke Jamba has no attention layer (its groups of 2 hold Mamba
# layers only): ``+attn`` is the one with groups of 4, the last attention
# (``tests/test_torch_archs.py``'s ``JAMBA_ATTN``)
JAMBA_ATTN = dict(layer_group=4, attn_period=4, num_layers=8)
ODD_VOCAB = 511     # no model axis of 2 or 4 splits it: replicated logits


def changes(arch: str) -> tuple:
    """``(registry name, dataclasses.replace changes)`` of a case's arch:
    f32; ``+bias`` for biases on every dense layer (no decoder-only
    config of the repo has them; the model axis cuts the q/k/v and wi/wg
    biases to each rank's slice), ``+attn`` for Jamba with an attention
    layer, ``+odd`` for a vocabulary the model axis does not split."""
    name, _, extra = arch.partition("+")
    return name, dict(dtype="float32", **{
        "": {}, "bias": dict(use_bias=True), "attn": JAMBA_ATTN,
        "odd": dict(vocab_size=ODD_VOCAB)}[extra])

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import all_archs, smoke
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, synth_batch
from repro.launch.mesh import make_mesh
from repro.models import registry as jregistry
from repro.parallel import sharding as jsharding
from repro.train import step as tstep
from repro.train.optimizer import OptConfig
sys.path.insert(0, os.path.dirname(sys.argv[2]))
from test_torch_mesh_train import (BATCH, BUCKET, CASES, OPT, RECORD, SEQ,
                                   STEPS, changes, mask_labels)
keystr = jax.tree_util.keystr
out = {}
for name in sys.argv[3].split(","):
    arch, shape, axes, method, sp, masked = CASES[name]
    arch, change = changes(arch)
    cfg = dataclasses.replace(smoke(all_archs()[arch]), **change)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH,
                      frames_dim=cfg.d_model if cfg.family == "encdec" else 0,
                      patches=cfg.num_patches, d_model=cfg.d_model)
    opts = tstep.TrainOptions(dp_method=method, remat=False,
                              sequence_parallel=sp, dp_bucket_bytes=BUCKET,
                              opt=OptConfig(**OPT))
    mesh = make_mesh(shape, axes)
    shape_cfg = ShapeConfig("t", "train", SEQ, BATCH)
    step, ctx, abstract = tstep.jit_train_step(cfg, shape_cfg, mesh, opts)
    shardings = tstep.state_shardings(abstract, ctx)
    state = tstep.make_train_state(cfg, opts, jax.random.key(0))
    # the first step's gradient of the global batch, under the stock step's
    # shardings on this mesh (an MoE routes each data shard's tokens on
    # their own; on a pod mesh the batch is sharded over pod too, as every
    # method's step splits it by pod): what the parameter tolerances are
    # scaled by
    gctx = jsharding.ShardingCtx(mesh, jsharding.train_rules(
        "pod" in axes, sp))
    batch = synth_batch(dcfg, 0)
    batch["labels"] = mask_labels(batch["labels"], masked)
    with jsharding.use_ctx(gctx):
        grads = jax.jit(lambda p, b: tstep._grads_and_metrics(
            cfg, opts, p, b)[0])(
            jax.device_put(state["params"],
                           tstep.state_shardings(abstract, gctx)["params"]),
            jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           tstep.batch_shardings(jregistry.input_specs(
                               cfg, shape_cfg), gctx)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{name}/grad" + keystr(path)] = np.asarray(leaf)
    for s in range(1, STEPS + 1):
        batch = synth_batch(dcfg, s - 1)
        batch["labels"] = mask_labels(batch["labels"], masked)
        state = jax.device_put(state, shardings)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        if s not in RECORD:
            continue
        key = f"{name}/{s}"
        for k in ("loss", "grad_norm", "lr", "lb_loss", "z_loss"):
            out[f"{key}/{k}"] = np.float32(float(m[k]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            # a copy: the next step donates the state's buffers
            out[key + "/params" + keystr(path)] = np.array(leaf, copy=True)
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@contextlib.contextmanager
def one_thread():
    """Run this process's torch, and the processes it spawns, on one
    thread each.  At smoke sizes an op gains nothing from intra-op
    threads, and beside the other xdist workers' processes on a loaded
    machine each parallel region waits on descheduled threads: such a
    test ran ~100 times slower than alone."""
    was, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(was)
        if env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = env


def mask_labels(labels: np.ndarray, rows: int) -> np.ndarray:
    """``rank_bodies.mask_labels`` on a numpy array (the reference's
    batch)."""
    return rank_bodies.mask_labels(torch.from_numpy(labels), rows).numpy()


def _keystr(path) -> str:
    return "".join(f"['{p}']" for p in path.split("/"))


def _cfgs(arch):
    arch, change = changes(arch)
    return (dataclasses.replace(j_smoke(j_all_archs()[arch]), **change),
            dataclasses.replace(smoke(all_archs()[arch]), **change))


def _np_params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.tree_util.tree_map(
        np.asarray, jregistry.init_params(jcfg, jax.random.key(0)))


def _opts(method, sp, name="adamw"):
    return tstep.TrainOptions(dp_method=method, remat=False,
                              sequence_parallel=sp, dp_bucket_bytes=BUCKET,
                              opt=topt.OptConfig(name=name, **OPT))


def _case_args(name):
    arch, shape, axes, method, sp, masked = CASES[name]
    cfg = _cfgs(arch)[1]
    return (shape, axes, cfg, _opts(method, sp), STEPS, SEQ, BATCH,
            ("numpy", _np_params(arch)), RECORD, None, masked)


# this module's cases; ``tests/test_torch_mesh_pods.py``,
# ``tests/test_torch_mesh_families.py`` and
# ``tests/test_torch_mesh_train_tp_{families,hybrid,encdec_vlm}.py`` and
# ``tests/test_torch_mesh_train_sp_families.py`` hold the others (seven
# modules, so that each module's reference run stays short)
HERE = ("stock_2x2", "stock_1x4", "sp_2x2", "sp_1x4", "masked_2x2")


def start_reference(tmp_path_factory, names):
    """Start the reference's runs of ``names`` in one JAX subprocess on 4
    forced host devices; :func:`finish_reference` collects them (the
    port's runs may go on meanwhile)."""
    path = tmp_path_factory.mktemp("ref") / "mesh.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, str(path),
                             str(Path(__file__).resolve()), ",".join(names)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
    return proc, path


def finish_reference(started) -> dict:
    proc, path = started
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        proc.kill()
    assert "REF_OK" in out, out + err
    return dict(np.load(path))


def run_reference(tmp_path_factory, names):
    """The reference's runs of ``names`` in one JAX subprocess on 4 forced
    host devices."""
    return finish_reference(start_reference(tmp_path_factory, names))


def run_ranked(names, grads=()):
    """``names`` over rank processes: the 4-rank meshes in one group of 4,
    the 2-rank ones in one group of 2; every rank's results (with the
    first-step gradients of the cases in ``grads``)."""
    out = {}
    for n in (4, 2):
        group = [c for c in names if np.prod(CASES[c][1]) == n]
        if not group:
            continue
        res = dist.run_ranks(rank_bodies.in_turn, n, backend="gloo",
                             device="cpu",
                             args=([(rank_bodies.mesh_train,
                                     _case_args(c) + (c in grads,))
                                    for c in group],))
        for i, c in enumerate(group):
            out[c] = [r[i] for r in res]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, HERE)


@pytest.fixture(scope="module")
def ranked():
    return run_ranked(HERE)


@pytest.fixture(scope="module")
def emulated():
    return {c: rank_bodies.mesh_train(None, *_case_args(c)) for c in HERE}


RESOLVED = 8 / 127     # of a leaf's largest gradient: 8 int8 steps


def _hold(run, reference, name, at, ring_tol=(1e-3, 1e-3),
          resolved=RESOLVED, floor=0.0):
    """``run``'s step ``at`` (a ``mesh_train`` result) against the
    reference's, by the module docstring's tolerances (under a compressed
    reduction, ``ring_tol``: the loss's and the gradient norm's, relative,
    after a reduction, and ``resolved``: the share of its leaf's largest
    gradient from which an element keeps the tight bound).  Which elements
    keep the tight bound is decided by the reference's first-step
    gradient (``{name}/grad...``), never by the port's.  ``floor``: an
    element whose gradient is below that share of the whole tree's
    largest takes the loose bound too, where the rule above gives one (a
    family's own reason, stated where it is passed; 0 here)."""
    key = f"{name}/{at}"
    got = run["steps"][at]
    ring = CASES[name][3] != "stock"
    lr = float(reference[key + "/lr"])
    assert abs(got["lr"] - lr) < 1e-9
    tol_loss = 1e-5 if at == 1 else (ring_tol[0] if ring else 1e-4)
    assert abs(got["loss"] - reference[key + "/loss"]) < tol_loss, (
        got["loss"], reference[key + "/loss"])
    gn = float(reference[key + "/grad_norm"])
    assert abs(got["grad_norm"] - gn) <= (ring_tol[1] if ring else 1e-5) \
        * gn, (got["grad_norm"], gn)
    tight = 0.02 * lr if at == 1 else 0.2 * at * OPT["lr"]
    loose_bound = 2.2 * at * OPT["lr"] if ring else 2 * lr
    tol_mean = 0.1 * OPT["lr"] * at if ring else 1e-6
    diffs = []
    top = max(float(np.abs(v).max()) for k, v in reference.items()
              if k.startswith(f"{name}/grad")) if floor else 0.0
    for path, t in got["params"].items():
        want = reference[f"{key}/params{_keystr(path)}"]
        assert t.shape == want.shape, path
        g = np.abs(reference[f"{name}/grad{_keystr(path)}"])
        if ring:
            loose = (g <= resolved * g.max()) | (g <= floor * top)
        elif at == 1:
            loose = (g < 1e-5 * g.max()) | (g < floor * top)
        else:
            loose = np.zeros(g.shape, dtype=bool)
        d = np.abs(t - want)
        assert d[loose].max(initial=0) <= loose_bound, path
        assert d[~loose].max(initial=0) <= tight, (
            path, d[~loose].max(), tight)
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() < tol_mean


@pytest.mark.parametrize("at", RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_mesh_step_matches_the_reference(name, at, reference,
                                                  emulated):
    _hold(emulated[name], reference, name, at)


@pytest.mark.parametrize("at", RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                ranked, emulated):
    """Rank 0's gathered parameters against the reference; every rank's
    losses and gradient norms equal rank 0's; and where every axis has two
    ranks, the parameters bit-equal to the emulated mesh's (each rank runs
    the emulated mesh's arithmetic on its shards, and a sum of two values
    is the same in either order; over a 4-rank axis gloo sums in an order
    of its own)."""
    runs = ranked[name]
    _hold(runs[0], reference, name, at)
    for r in runs:
        assert r["steps"][at]["loss"] == runs[0]["steps"][at]["loss"]
        assert r["steps"][at]["grad_norm"] == \
            runs[0]["steps"][at]["grad_norm"]
    if max(CASES[name][1]) > 2:
        return
    emu = emulated[name]["steps"][at]
    for path, t in runs[0]["steps"][at]["params"].items():
        assert np.array_equal(t, emu["params"][path]), path


def test_masked_case_would_fail_as_a_mean_of_means(reference):
    """The masked case's data ranks hold unequal counts: the mean of the
    two ranks' mean losses differs from the reference's global loss by
    far more than the tolerance (the port's loss is the global one)."""
    _, cfg = _cfgs("olmo-1b")
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    batch = pipeline.synth_batch(dcfg, 0)
    labels = rank_bodies.mask_labels(batch["labels"], MASKED_ROWS)
    counts = [(labels[:MASKED_ROWS] >= 0).sum(),
              (labels[MASKED_ROWS:] >= 0).sum()]
    assert counts[0] * 3 < counts[1]
    from repro_torch import bridge
    params = bridge.params_from_numpy(cfg, _np_params("olmo-1b"), "cpu")
    with torch.no_grad():
        logits, _ = tstep.registry.forward(cfg, params, batch)
    from repro_torch.models.transformer import _xent_sum
    halves = [_xent_sum(logits[:MASKED_ROWS], labels[:MASKED_ROWS]),
              _xent_sum(logits[MASKED_ROWS:], labels[MASKED_ROWS:])]
    mean_of_means = float(sum(n / c for n, c in halves)) / 2
    assert abs(mean_of_means - reference["masked_2x2/1/loss"]) > 1e-4


def test_exchanges_a_step_are_the_derived_counts(ranked):
    """Over the ranks the model axis makes, per step, the exchanges
    ``transformer.train_exchanges`` derives from the layer count, and one
    all-reduce for the gradient norm; recording a step gathers each
    model-split leaf (one all-gather)."""
    from repro_torch.models.transformer import train_exchanges
    cfg = _cfgs("olmo-1b")[1]
    leaves = len(common.tree_leaves(_np_params("olmo-1b")))
    for name in ("stock_2x2", "sp_2x2", "stock_1x4", "sp_1x4"):
        shape, sp = CASES[name][1], CASES[name][4]
        want = train_exchanges(cfg, shape[1], sequence_parallel=sp,
                               remat=False)
        want = {k: v * STEPS for k, v in want.items()}
        want["all_reduce"] = want.get("all_reduce", 0) + STEPS
        want["all_gather"] = want.get("all_gather", 0) + leaves * len(RECORD)
        assert ranked[name][0]["exchanges_model"] == want, name


def _adafactor_case():
    rng = np.random.default_rng(7)
    shape = (16, 24)
    params = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return params, grads


def test_adafactor_on_a_split_leaf_matches_the_reference():
    """A 2-D leaf split over data (rows) and model (columns) of a (2, 2)
    mesh, three Adafactor updates: the shards put together against the
    reference's updates of the whole leaf, emulated and over 4 ranks."""
    params, grads = _adafactor_case()
    cfg = dict(name="adafactor", lr=1e-2, warmup_steps=2, decay_steps=6)
    jp, js = {"w": jnp.asarray(params)}, None
    js = jopt.init_state(jopt.OptConfig(**cfg), jp)
    for g in grads:
        jp, js, _ = jax.jit(lambda p, g, s: jopt.apply_updates(
            jopt.OptConfig(**cfg), p, g, s))(jp, {"w": jnp.asarray(g)}, js)
    want = np.asarray(jp["w"])
    emu = rank_bodies.adafactor_shards(None, params, grads, cfg)
    res = dist.run_ranks(rank_bodies.adafactor_shards, 4, backend="gloo",
                         device="cpu", args=(params, grads, cfg))
    for got in [emu] + res:
        assert np.abs(got["w"] - want).max() < 1e-6
        assert np.abs(got["grad_norm"] - got["ref_norm"]) < 1e-5


@pytest.mark.parametrize("arch", ["olmo-1b", "moonshot-v1-16b-a3b",
                                  "rwkv6-7b", "jamba-1.5-large-398b"])
@one_thread()
def test_checkpoints_cross_between_a_mesh_and_one_device(arch, tmp_path):
    """Two steps on a (2, 2) mesh, saved, two more on one device; and two
    on one device, saved, two more on the mesh: both against four
    one-device steps (AdamW and Adafactor).  Moonlight's experts and
    RWKV-6's heads split over the mesh's model axis, and Jamba's fused
    ``mamba/in_proj`` by its parts (its Adafactor column statistics
    too), saved and restored in the leaf's own order.  Moonlight runs at
    the capacity factor ``E / K``, the least at which no assignment drops
    (``C`` is the group's size), and so does Jamba: a data rank routes
    its own rows in groups of their own (the reference's grouping), so
    with drops the mesh's step is another function than one device's."""
    _, cfg = _cfgs(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    mesh = make_host_mesh(2, 2)
    from repro_torch import bridge
    for name in ("adamw", "adafactor"):
        opts = _opts("stock", False, name)

        def run(where, state=None, steps=range(4)):
            if state is None:
                gen = torch.Generator()
                gen.manual_seed(0)
                state = tstep.make_train_state(cfg, opts, gen, where)
            f = tstep.make_train_step(cfg, None, where, opts)
            for s in steps:
                state, m = f(state, pipeline.synth_batch(dcfg, s))
            return state, m

        def full(state, where):
            if where == 1:
                return state["params"]
            specs, _ = tstep.mesh_layout(cfg, mesh)
            return bridge.gather_mesh(state["params"], specs, mesh)

        want, wm = run(1)
        layout = tstep.MeshCheckpoint(cfg, mesh)
        for first, then in ((mesh, 1), (1, mesh)):
            d = tmp_path / f"{name}_{first == 1}"
            state, _ = run(first, steps=range(2))
            CheckpointManager(str(d), async_save=False,
                              layout=None if first == 1 else layout).save(
                2, state)
            gen = torch.Generator()
            gen.manual_seed(1)
            like = tstep.make_train_state(cfg, opts, gen, then)
            like, at = CheckpointManager(
                str(d), layout=None if then == 1 else layout).restore(like)
            assert at == 2 and int(like["step"]) == 2
            got, m = run(then, like, steps=range(2, 4))
            assert abs(float(m["loss"]) - float(wm["loss"])) < 1e-4
            for a, b in zip(common.tree_leaves(full(got, then)),
                            common.tree_leaves(want["params"])):
                assert float((a - b).abs().max()) < 0.2 * 4 * OPT["lr"]


def test_meshes_build_emulated_and_over_rank_subgroups():
    """``make_mesh`` with a data axis and with the pod axis above a mesh,
    emulated; over 4 ranks each rank's axes are the sub-groups of its row
    and column of the rank grid."""
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    assert mesh.pod.n == 2 and mesh.size == 4 and mesh.is_lead
    res = dist.run_ranks(rank_bodies.mesh_axes, 4, backend="gloo",
                         device="cpu",
                         args=([((2, 2), ("data", "model")),
                                ((2, 2), ("pod", "model")),
                                ((2, 1, 2), ("pod", "data", "model"))],))
    for r, got in enumerate(res):
        # rank r of the row-major grid
        assert got[0] == {"data": (r // 2, 2, [r % 2, 2 + r % 2]),
                          "model": (r % 2, 2, [2 * (r // 2),
                                               2 * (r // 2) + 1])}
        assert got[1]["pod"] == (r // 2, 2, [r % 2, 2 + r % 2])
        assert got[2]["data"] == (0, 1, [r])


def test_a_model_axis_on_another_family_names_item_9d():
    # every family trains over a model axis (the hybrid, encdec and vlm
    # families since item 9f; 9d serves them over one), with sequence
    # parallelism too: one step of Jamba on a (1, 2) mesh with it gives
    # the step's loss without it
    jamba = _cfgs("jamba-1.5-large-398b")[1]
    dcfg = pipeline.DataConfig(vocab_size=jamba.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    losses = []
    for sp in (False, True):
        opts = _opts("stock", sp)
        gen = torch.Generator()
        gen.manual_seed(0)
        mesh = make_host_mesh(1, 2)
        state = tstep.make_train_state(jamba, opts, gen, mesh)
        with one_thread():
            _, m = tstep.make_train_step(jamba, None, mesh, opts)(
                state, pipeline.synth_batch(dcfg, 0))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and abs(losses[1] - losses[0]) < 1e-5


@pytest.mark.parametrize("remat,micro,sp", [(True, 1, False), (False, 2, False),
                                            (True, 1, True), (False, 2, True)])
def test_remat_and_microbatches_on_the_mesh(remat, micro, sp):
    """Remat (each group replayed in the backward, its exchanges with it)
    and two microbatches on the emulated (2, 2) mesh: the plain step's
    loss and gradient norm, and on the model axis the exchanges
    ``train_exchanges`` derives, once for each data rank and
    microbatch."""
    from repro_torch.models.transformer import train_exchanges
    _, cfg = _cfgs("olmo-1b")
    cfg = dataclasses.replace(cfg, remat="full")
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    got = []
    for r, n in ((False, 1), (remat, micro)):
        mesh = make_host_mesh(2, 2)
        opts = dataclasses.replace(_opts("stock", sp), remat=r,
                                   microbatches=n)
        gen = torch.Generator()
        gen.manual_seed(0)
        state = tstep.make_train_state(cfg, opts, gen, mesh)
        state, m = tstep.make_train_step(cfg, None, mesh, opts)(
            state, pipeline.synth_batch(dcfg, 0))
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    dict(mesh.axis.exchanges)))
    assert abs(got[1][0] - got[0][0]) < 1e-6
    assert abs(got[1][1] - got[0][1]) <= 1e-6 * got[0][1]
    want = train_exchanges(cfg, 2, sequence_parallel=sp, remat=remat)
    assert got[1][2] == {k: v * 2 * micro for k, v in want.items()}
