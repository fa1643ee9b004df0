"""The port's training path against the JAX package, on the CPU.

* One and three train steps of f32 smoke OLMo over 4 pods — ``stock``,
  ``int8_ring`` (64 KiB buckets: several, pipelined) and ``int8_a2a`` —
  against the reference's ``shard_map`` step on 4 forced host devices (one
  JAX subprocess for the module, saved to an ``.npz``): pod 0's loss and
  every pod's, ``grad_norm``, the parameters and every pod's ``err``.
* The loss gradient of one step, AdamW and Adafactor, the schedule,
  ``synth_batch``, checkpoints and the fault-restore loop.

Tolerances, with their reason.  Gradients come out of autograd and XLA in
another order of f32 sums (~1e-7 relative), so: loss and per-pod losses
1e-5 after one step, 1e-4 after three; ``grad_norm`` 1e-5 relative.  A
last-bit gradient difference can move a quantization across a rounding
boundary, so each pod's ``err`` is held within one int8 step of its row
(2.5 x the largest residual, which is half a step) and the share of
elements that moved at all is bounded.  AdamW's normalized update moves a
parameter whose gradient is near zero by up to ``lr`` either way, so the
parameters are held within 2% of the step's ``lr`` after one step and 20%
of the most three steps' ``lr`` can sum to after three, and their mean
difference within 1e-6.
"""
import dataclasses
import json
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
from repro.data import pipeline as jpipeline
from repro.models import registry as jregistry
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import bridge, runtime
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import all_archs, smoke
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.parallel import collectives
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
N = 4
SEQ, BATCH = 32, 8
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
METHODS = {"stock": 4 << 20, "int8_ring": 64 << 10, "int8_a2a": 4 << 20}
RECORD = (1, 3)             # steps after which the reference is recorded

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import all_archs, smoke
from repro.configs.base import ShapeConfig
from repro.data.pipeline import DataConfig, synth_batch
from repro.parallel import compat
from repro.train import step as tstep
from repro.train.optimizer import OptConfig
sys.path.insert(0, os.path.dirname(sys.argv[2]))
from test_torch_train import BATCH, METHODS, N, OPT, RECORD, SEQ
mesh = compat.make_mesh((N,), ("pod",))
cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
keystr = jax.tree_util.keystr
out = {}
for method, bb in METHODS.items():
    opts = tstep.TrainOptions(dp_method=method, remat=False,
                              dp_bucket_bytes=bb, opt=OptConfig(**OPT))
    step, _ = tstep.make_train_step(cfg, ShapeConfig("t", "train", SEQ,
                                                     BATCH), mesh, opts)
    step = jax.jit(step)
    state = tstep.make_train_state(cfg, opts, jax.random.key(0))
    for s in range(1, max(RECORD) + 1):
        batch = {k: jnp.asarray(v) for k, v in synth_batch(dcfg, s - 1).items()}
        state, m = step(state, batch)
        if s not in RECORD:
            continue
        key = f"{method}/{s}"
        out[key + "/loss"] = np.float32(float(m["loss"]))   # pod 0's
        out[key + "/loss_pods"] = np.array(
            [float(np.asarray(sh.data)) for sh in m["loss"].addressable_shards])
        out[key + "/grad_norm"] = np.float32(float(m["grad_norm"]))
        out[key + "/lr"] = np.float32(float(m["lr"]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            out[key + "/params" + keystr(path)] = np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state.get("err", {}))[0]:
            out[key + "/err" + keystr(path)] = np.stack(
                [np.asarray(sh.data).astype(np.float32)
                 for sh in leaf.addressable_shards])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


def _keystr(path) -> str:
    return "".join(f"['{p}']" for p in path)


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "train.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(path),
                          str(Path(__file__).resolve())],
                         env=env, capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke(j_all_archs()["olmo-1b"]),
                               dtype="float32")
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    return jcfg, cfg, jparams, np_params, dcfg


def _port_state(cfg, np_params, opts, pods=N):
    """A train state of the port holding the reference's initial
    parameters."""
    gen = torch.Generator()
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, pods=pods)
    state["params"] = bridge.params_from_numpy(cfg, np_params, device="cpu")
    state["opt"] = topt.init_state(opts.opt, state["params"])
    return state


@pytest.fixture(scope="module")
def port_runs(setup):
    """The port's steps, recorded after each step in RECORD."""
    _, cfg, _, np_params, dcfg = setup
    runs = {}
    for method, bb in METHODS.items():
        opts = tstep.TrainOptions(dp_method=method, remat=False,
                                  dp_bucket_bytes=bb,
                                  opt=topt.OptConfig(**OPT))
        state = _port_state(cfg, np_params, opts)
        step = tstep.make_train_step(cfg, None, N, opts)
        for s in range(1, max(RECORD) + 1):
            state, m = step(state, pipeline.synth_batch(dcfg, s - 1))
            if s in RECORD:
                runs[f"{method}/{s}"] = (
                    {k: v.detach().clone() for k, v in m.items()},
                    {p: t.detach().clone() for p, t in _walk(state["params"])},
                    {p: t.float().clone() for p, t in
                     _walk(state.get("err", {}))})
    return runs


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("at", RECORD)
def test_train_steps_match_the_reference(method, at, reference, port_runs):
    key = f"{method}/{at}"
    metrics, params, err = port_runs[key]
    tol_loss = 1e-5 if at == 1 else 1e-4
    assert abs(float(metrics["loss"]) - reference[key + "/loss"]) < tol_loss
    if method != "stock":         # every pod's own loss; reported: pod 0's
        pods = metrics["loss_per_pod"].numpy()
        assert np.abs(pods - reference[key + "/loss_pods"]).max() < tol_loss
        assert float(metrics["loss"]) == pods[0]
        assert np.ptp(pods) > 1e-3            # the pods' rows differ
    gn = float(reference[key + "/grad_norm"])
    assert abs(float(metrics["grad_norm"]) - gn) <= 1e-5 * gn
    # 2% of step 1's lr; after three steps 20% of the most they can sum to
    tol_p = (0.02 * float(reference[key + "/lr"]) if at == 1
             else 0.2 * at * OPT["lr"])
    diffs = []
    for path, t in params.items():
        want = reference[f"{key}/params{_keystr(path)}"]
        d = np.abs(t.numpy() - want)
        assert d.max() <= tol_p, (path, d.max(), tol_p)
        diffs.append(d)
    assert np.concatenate([d.ravel() for d in diffs]).mean() < 1e-6
    if method == "stock":
        assert not err
        return
    moved = total = 0
    for path, t in err.items():
        want = reference[f"{key}/err{_keystr(path)}"]
        assert t.shape == want.shape == (N,) + want.shape[1:]
        d = np.abs(t.numpy() - want)
        assert d.max() <= 2.5 * np.abs(want).max(), (path, d.max())
        # a moved rounding changes a residual by a whole step (twice the
        # largest residual); bf16 storage of a last-bit difference, by far
        # less than half of one
        moved += int((d > 0.5 * np.abs(want).max()).sum())
        total += d.size
    assert moved / total < (0.005 if at == 1 else 0.05), moved / total


def test_reference_pods_keep_their_own_err_and_loss(reference):
    """The reference facts the port's state follows: each pod's err is its
    own, and so is each pod's loss."""
    errs = [v for k, v in reference.items()
            if k.startswith("int8_ring/1/err")]
    assert errs and any(np.abs(e[0] - e[1]).max() > 0 for e in errs)
    pods = reference["int8_ring/1/loss_pods"]
    assert np.ptp(pods) > 1e-3 and reference["int8_ring/1/loss"] == \
        np.float32(pods[0])


def test_loss_gradient_matches_the_reference(setup):
    """One backward of the port (chunked attention, with and without
    remat) against ``jax.value_and_grad`` of the reference's loss."""
    jcfg, cfg, jparams, np_params, dcfg = setup
    batch = pipeline.synth_batch(dcfg, 0)
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    jpipeline.synth_batch(dcfg, 0))
    jloss = jstep.make_loss_fn(jcfg, jstep.TrainOptions(remat=False))
    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jbatch)
    params = bridge.params_from_numpy(cfg, np_params, device="cpu")
    grads = {}
    for remat in (False, True):
        g, m = tstep._grads_and_metrics(
            cfg, tstep.TrainOptions(remat=remat), params, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
        grads[remat] = g
    for (path, g), (_, want) in zip(_walk(grads[False]), _walk(
            jax.tree_util.tree_map(np.asarray, jg))):
        scale = np.abs(want).max()
        assert np.abs(g.numpy() - want).max() <= 1e-4 * scale, path
    for (_, a), (_, b) in zip(_walk(grads[False]), _walk(grads[True])):
        assert torch.equal(a, b)                # remat recomputes exactly


def test_chunked_attention_is_the_training_path(setup, monkeypatch):
    """The loss attends through the chunked softmax, never through a
    kernel (the kernels have no backward): no flash call, even in remat's
    recomputation."""
    _, cfg, _, np_params, dcfg = setup
    from repro_torch.kernels import flash_attention
    monkeypatch.setattr(flash_attention, "flash_attention_fwd",
                        lambda *a, **k: pytest.fail("flash kernel called"))
    params = bridge.params_from_numpy(cfg, np_params, device="cpu")
    tstep._grads_and_metrics(cfg, tstep.TrainOptions(remat=True), params,
                             pipeline.synth_batch(dcfg, 1))
    assert runtime.policy()["attention_impl"] == "kernel"


def test_xent_loss_with_masked_labels(setup):
    jcfg, cfg = setup[:2]
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, size=(2, 5)).astype(np.int32)
    labels[0, :2] = -100
    want = jstep.xent_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels))
    got = tstep.xent_loss(cfg, torch.tensor(logits), torch.tensor(labels))
    assert abs(float(got) - float(want)) < 1e-6


@pytest.mark.parametrize("name,state_dtype", [("adamw", "float32"),
                                              ("adafactor", "float32"),
                                              ("adamw", "bfloat16")])
def test_optimizers_match_the_reference(name, state_dtype):
    """Three updates of random parameters (matrices, a vector, a stacked
    tensor) with random gradients, clipped, through both."""
    rng = np.random.default_rng(5)
    shapes = {"w": (16, 24), "b": (24,), "s": (2, 8, 12)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=6,
               state_dtype=state_dtype, grad_clip=1.0)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_state(jcfg, jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = topt.init_state(tcfg, tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jax.jit(lambda p, g, s: jopt.apply_updates(
            jcfg, p, g, s))(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                            js)
        tm = topt.apply_updates(tcfg, tp,
                                {k: torch.tensor(v) for k, v in grads.items()},
                                ts)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < 1e-5
        assert abs(float(tm["lr"]) - float(jm["lr"])) < 1e-9
        for k in shapes:
            assert np.abs(tp[k].numpy() - np.asarray(jp[k])).max() < 1e-6, k
    for key in js:
        if key == "count":
            assert int(ts["count"]) == int(js["count"]) == 3
            continue
        for k in shapes:
            want = np.asarray(js[key][k]).astype(np.float32)
            got = ts[key][k].float().numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-6 + 1e-2 * np.abs(
                want).max() * (state_dtype == "bfloat16"), (key, k)


def test_adamw_updates_a_large_leaf_slice_by_slice(monkeypatch):
    """A leaf of more than ``SLICE`` elements is updated a slice at a
    time: parameters and both moments bit-equal to the whole-leaf
    update."""
    gen = torch.Generator().manual_seed(2)
    shapes = {"w": (3, 50, 40), "b": (700,)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, state_dtype="bfloat16")
    runs = []
    for size in (topt.SLICE, 257):
        monkeypatch.setattr(topt, "SLICE", size)
        p = {k: v.clone() for k, v in params.items()}
        state = topt.init_state(cfg, p)
        for _ in range(3):
            topt.apply_updates(cfg, p, grads, state)
        runs.append((p, state))
    (p0, s0), (p1, s1) = runs
    for k in shapes:
        assert torch.equal(p0[k], p1[k])
        assert torch.equal(s0["m"][k], s1["m"][k])
        assert torch.equal(s0["v"][k], s1["v"][k])


def test_schedule_matches_the_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=50)
    for s in (0, 1, 5, 10, 11, 30, 50, 80):
        want = float(jopt.schedule(jopt.OptConfig(**cfg), jnp.int32(s)))
        got = float(topt.schedule(topt.OptConfig(**cfg), torch.tensor(s)))
        assert abs(got - want) <= 1e-7 * 3e-4 * 10, s


def test_synth_batch_is_bit_equal_to_the_reference():
    cfg = dict(vocab_size=50304, seq_len=17, global_batch=3, seed=7,
               frames_dim=8, patches=2, d_model=4)
    for step in (0, 5):
        want = jpipeline.synth_batch(jpipeline.DataConfig(**cfg), step)
        got = pipeline.synth_batch(pipeline.DataConfig(**cfg), step)
        assert set(got) == set(want)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert (got[k].numpy() == want[k]).all()
        for k in ("frames", "patches"):
            assert got[k].dtype == torch.bfloat16
            assert (got[k].view(torch.int16).numpy()
                    == np.asarray(want[k]).view(np.int16)).all()


def test_loader_yields_the_synthetic_batches():
    cfg = pipeline.DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    loader = pipeline.Loader(cfg, device="cpu", start_step=3)
    try:
        for want_step in (3, 4):
            s, batch = next(loader)
            assert s == want_step
            assert torch.equal(batch["tokens"],
                               pipeline.synth_batch(cfg, s)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_loader_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """Like every entry point of the port, the loader places batches on
    the card unless the caller asks for the CPU: no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pipeline.DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pipeline.Loader(cfg)


def _ckpt_state():
    return {"params": {"a": torch.arange(6, dtype=torch.float32).reshape(
        2, 3), "b": torch.tensor([1.5, -2.25, 3e-3, 7.0]).to(torch.bfloat16)},
        "empty": {}, "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_round_trip_retention_and_atomic_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = _ckpt_state()
    mgr.save(3, state)
    meta = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    assert meta["leaves"]["params.b"]["dtype"] == "bfloat16"
    got, step = mgr.restore(state)
    assert step == 3 and got["empty"] == {}
    for (p, a), (_, b) in zip(_walk(state), _walk(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    for s in (4, 5, 6):
        mgr.save(s, state)
    assert mgr.all_steps() == [5, 6]
    assert all(not d.startswith("tmp.") for d in os.listdir(tmp_path))
    bad = dict(state, params=dict(state["params"], a=torch.zeros(3, 2)))
    with pytest.raises(ValueError, match="params.a"):
        mgr.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(state)


def test_async_save_snapshots_before_the_state_moves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _ckpt_state()
    mgr.save(1, state)
    state["params"]["a"].add_(100.0)          # in place, as the step does
    mgr.wait()
    got, _ = mgr.restore(state)
    assert float(got["params"]["a"].max()) == 5.0


@pytest.mark.parametrize("method", ["stock", "int8_ring"])
def test_fault_tolerant_loop_replays_deterministically(method, setup,
                                                       tmp_path):
    """A fault at step 7 restores the step-5 checkpoint (parameters,
    optimizer state and every pod's err) and replays steps 5 and 6 with the
    same losses."""
    _, cfg, _, np_params, _ = setup
    opts = tstep.TrainOptions(dp_method=method, remat=False,
                              opt=topt.OptConfig(**OPT))
    state = _port_state(cfg, np_params, opts, pods=2)
    step = tstep.make_train_step(cfg, None, 2, opts)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    faults = {7}
    logs = []

    def fault_hook(s):
        if s in faults:
            faults.discard(s)
            raise RuntimeError("injected preemption")

    state, hist = tloop.train_loop(
        step, state, dcfg, "cpu", mgr,
        tloop.LoopConfig(total_steps=9, checkpoint_every=5, log_every=0,
                         max_restarts=1),
        fault_hook=fault_hook, log=logs.append)
    steps = [h["step"] for h in hist]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    by_step = {}
    for h in hist:
        by_step.setdefault(h["step"], []).append(h["loss"])
    assert all(len(set(v)) == 1 for v in by_step.values()), by_step
    assert any("FAILURE" in line for line in logs)
    assert int(state["step"]) == 9
    assert ("err" in state) == (method != "stock")
    assert mgr.all_steps() == [5]


def test_the_ssm_family_and_sequence_parallel_name_the_later_slice(setup):
    """Sequence parallelism trains: without a model axis it changes
    nothing (the reference's ``seq_sp`` rule maps to no mesh axis), and
    on a ``(1, 2)`` mesh one step gives the one-device step's loss
    (``tests/test_torch_mesh_train.py`` holds it to the reference); an
    unknown ``dp_method`` is refused; the ssm family trains
    (``test_rwkv6_train_step_matches_the_reference``), over a model axis
    too (``tests/test_torch_mesh_train_tp_families.py``), with sequence
    parallelism too: one step on a ``(1, 2)`` mesh gives the step's loss
    without it
    (``tests/test_torch_mesh_train_sp_families.py`` holds it to the
    reference)."""
    from repro_torch.launch.mesh import make_host_mesh
    _, cfg, _, np_params, dcfg = setup

    def one_step(cfg, mesh, sp, batch):
        opts = tstep.TrainOptions(sequence_parallel=sp, remat=False,
                                  opt=topt.OptConfig(**OPT))
        gen = torch.Generator()
        gen.manual_seed(0)
        state = tstep.make_train_state(cfg, opts, gen, mesh)
        _, m = tstep.make_train_step(cfg, None, mesh, opts)(state, batch)
        return float(m["loss"])
    batch = pipeline.synth_batch(dcfg, 0)
    losses = [one_step(cfg, mesh, sp, batch) for mesh, sp in (
        (1, False), (1, True), (make_host_mesh(1, 2), True))]
    assert losses[0] == losses[1] and abs(losses[2] - losses[0]) < 1e-5
    with pytest.raises(ValueError, match="dp_method"):
        tstep.make_train_step(cfg, None, 1,
                              tstep.TrainOptions(dp_method="psum"))
    rwkv = dataclasses.replace(smoke(all_archs()["rwkv6-7b"]),
                               dtype="float32")
    batch = pipeline.synth_batch(pipeline.DataConfig(
        vocab_size=rwkv.vocab_size, seq_len=dcfg.seq_len,
        global_batch=dcfg.global_batch), 0)
    got = [one_step(rwkv, make_host_mesh(1, 2), sp, batch)
           for sp in (False, True)]
    assert np.isfinite(got).all() and abs(got[1] - got[0]) < 1e-5


def test_rwkv6_train_step_matches_the_reference(monkeypatch):
    """One stock step of f32 smoke RWKV-6 from the reference's parameters
    against the reference's jitted step on one device: the loss, the
    gradient norm and the updated parameters within the OLMo parity
    test's tolerances.  The loss runs the plain chunked WKV-6 scan (the
    kernel has no backward), as the reference trains through its jnp
    scan."""
    from repro.configs.base import ShapeConfig
    from repro.launch.mesh import make_mesh
    from repro_torch.kernels import rwkv6_scan
    jcfg = dataclasses.replace(j_smoke(j_all_archs()["rwkv6-7b"]),
                               dtype="float32")
    cfg = dataclasses.replace(smoke(all_archs()["rwkv6-7b"]),
                              dtype="float32")
    opts = dict(remat=False, opt=OPT)
    jopts = jstep.TrainOptions(remat=False, opt=jopt.OptConfig(**OPT))
    jstate = jstep.make_train_state(jcfg, jopts, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jstate["params"])
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    jstepf, _ = jstep.make_train_step(
        jcfg, ShapeConfig("t", "train", SEQ, BATCH),
        make_mesh((1, 1), ("data", "model")), jopts)
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    jpipeline.synth_batch(dcfg, 0))
    jstate, jm = jax.jit(jstepf)(jstate, jbatch)

    topts = tstep.TrainOptions(remat=opts["remat"],
                               opt=topt.OptConfig(**OPT))
    state = _port_state(cfg, np_params, topts, pods=1)
    monkeypatch.setattr(rwkv6_scan, "rwkv6_scan_fwd",
                        lambda *a, **k: pytest.fail("scan kernel called"))
    step = tstep.make_train_step(cfg, None, 1, topts)
    state, m = step(state, pipeline.synth_batch(dcfg, 0))
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
    gn = float(jm["grad_norm"])
    assert abs(float(m["grad_norm"]) - gn) <= 1e-5 * gn
    tol_p = 0.02 * float(jm["lr"])
    diffs = []
    for (path, t), (_, want) in zip(_walk(state["params"]), _walk(
            jax.tree_util.tree_map(np.asarray, jstate["params"]))):
        d = np.abs(t.detach().numpy() - want)
        assert d.max() <= tol_p, (path, d.max(), tol_p)
        diffs.append(d)
    assert np.concatenate([d.ravel() for d in diffs]).mean() < 1e-6
    assert int(state["step"]) == 1


def test_microbatches_accumulate_the_same_gradients(setup):
    _, cfg, _, np_params, dcfg = setup
    params = bridge.params_from_numpy(cfg, np_params, device="cpu")
    batch = pipeline.synth_batch(dcfg, 2)
    one, m1 = tstep._grads_and_metrics(
        cfg, tstep.TrainOptions(remat=False), params, batch)
    two, m2 = tstep._grads_and_metrics(
        cfg, tstep.TrainOptions(remat=False, microbatches=2), params, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for (_, a), (_, b) in zip(_walk(one), _walk(two)):
        assert torch.allclose(a, b, atol=1e-6)


def test_cli_trains_on_the_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import train
    hist = train.main(["--smoke", "--steps", "3", "--batch", "2", "--seq",
                       "16", "--ckpt-every", "2", "--dp-method", "int8_ring",
                       "--ckpt-dir", str(tmp_path / "ck")], device="cpu")
    out = capsys.readouterr().out
    assert len(hist) == 3 and "[train] done" in out and "pods=1" in out
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2]
    again = train.main(["--smoke", "--steps", "4", "--batch", "2", "--seq",
                        "16", "--ckpt-every", "0", "--dp-method", "int8_ring",
                        "--ckpt-dir", str(tmp_path / "ck")], device="cpu")
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in again] == [2, 3]
    assert ops.launch_counts()["quantize_int8"] == 0      # CPU: no launch


@pytest.mark.parametrize("argv,msg", [
    (["--smoke", "--data-mesh", "2", "--model-mesh", "2", "--devices", "2"],
     "must be --data-mesh x --model-mesh = 4"),
    # every family trains over a model axis; one that does not split the
    # family's widths is still refused (the smoke Jamba's 4 experts over 3)
    (["--smoke", "--arch", "jamba-1.5-large-398b", "--model-mesh", "3"],
     "experts 4 does not split over a model axis of 3"),
    (["--arch", "nonsense"], "ported archs")])
def test_cli_rejections(argv, msg, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as exc:
        train.main(argv, device="cpu")
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--model-mesh", "2"], ["--data-mesh", "2"],
    ["--arch", "rwkv6-7b", "--model-mesh", "2"],
    ["--arch", "moonshot-v1-16b-a3b", "--model-mesh", "2"],
    ["--arch", "jamba-1.5-large-398b", "--model-mesh", "2"],
    ["--arch", "whisper-base", "--model-mesh", "2"],
    ["--arch", "internvl2-26b", "--model-mesh", "2"]])
def test_cli_trains_on_a_mesh(argv, capsys, tmp_path):
    """The two meshes the CLI refused before mesh training, and the model
    axis on the ssm, moe, hybrid, encdec and vlm families (the last two
    with their frames and patches), at the smoke width, emulated: the
    mesh printed, two steps, a checkpoint of the full arrays
    (``tests/test_torch_mesh_train.py`` runs the CLI over ranks)."""
    from repro_torch.launch import train
    hist = train.main(["--smoke", "--steps", "2", "--batch", "4", "--seq",
                       "16", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path)] + argv, device="cpu")
    out = capsys.readouterr().out
    want = {"data": 2, "model": 1} if "--data-mesh" in argv \
        else {"data": 1, "model": 2}
    assert f"mesh={want}" in out and "[train] done" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--smoke", "--ckpt-dir", str(tmp_path)])


def test_cli_flags_are_the_reference_flags():
    """The reference's flags, and one of the port's own: ``--devices``,
    the rank processes a mesh runs over (the reference's CLI runs on the
    devices JAX sees)."""
    import re
    src = ROOT / "src"
    flags = [set(re.findall(r'add_argument\("(--[\w-]+)"',
                            (src / pkg / "launch" / "train.py").read_text()))
             for pkg in ("repro", "repro_torch")]
    assert flags[1] - flags[0] == {"--devices"} and flags[0] <= flags[1]
    assert len(flags[0]) > 10


def test_reduce_gradients_frees_each_bucket_once_packed(monkeypatch):
    """Handed trees it holds the only reference to, the bucketed reduction
    lets each leaf go once it is packed (what keeps full-width OLMo-1B's
    reduction inside the card): serially, one leaf a bucket, chain i sees
    only the leaves not yet packed."""
    import weakref
    for overlap, want in ((False, [2, 1, 0]), (True, [1, 0, 0])):
        leaves = [torch.randn(2, 9000) for _ in range(3)]
        refs = [weakref.ref(t) for t in leaves]
        holder = [{f"w{i}": t for i, t in enumerate(leaves)}]
        del leaves
        seen = []
        real = collectives._chain

        def chain(x, pods, method, real=real):
            seen.append(sum(r() is not None for r in refs))
            return real(x, pods, method)

        monkeypatch.setattr(collectives, "_chain", chain)
        collectives.reduce_gradients(holder.pop(), collectives.PodAxis(2),
                                     "int8_ring", bucket_bytes=36000,
                                     overlap=overlap)
        monkeypatch.setattr(collectives, "_chain", real)
        assert seen == want, (overlap, seen)


def test_a_step_frees_its_gradients_without_the_garbage_collector(setup):
    """Tree helpers must not build reference cycles around a step's
    tensors: with the cyclic collector off, the gradients of a step are
    gone once the caller drops them (a cycle kept every pod's gradients of
    a full-width step alive until the collector happened to run)."""
    import gc
    import weakref
    _, cfg, _, np_params, dcfg = setup
    params = bridge.params_from_numpy(cfg, np_params, device="cpu")
    gc.collect()
    gc.disable()
    try:
        per = tstep._per_pod(cfg, tstep.TrainOptions(remat=False), params,
                             pipeline.synth_batch(dcfg, 0), 2)
        refs = [weakref.ref(t) for t in
                collectives.tree_leaves(per.pop("grads"))]
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("S,window", [(24, 0), (1536, 0), (1536, 300)])
def test_chunked_attention_matches_the_reference_branch(S, window, setup):
    """``attention_impl="chunked"`` against the reference's XLA branch,
    one chunk (S <= 1024) and three chunks of 512, with and without a
    window."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    from repro_torch.models import common as tcommon
    jcfg, cfg, jparams, np_params, _ = setup
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["l0"]["attn"])
    params = bridge.params_from_numpy(cfg, np_params, device="cpu")
    p = tcommon.tree_index(params["layers"]["l0"]["attn"], 0)
    x = np.random.default_rng(S).standard_normal((1, S, 64)).astype(
        np.float32)
    want = jattn.attn_apply(jcfg, jp, jnp.asarray(x),
                            positions=jnp.arange(S), window=window)
    with runtime.use_policy(attention_impl="chunked"):
        got = tattn.attn_apply(cfg, p, torch.tensor(x),
                               positions=torch.arange(S), window=window)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5
