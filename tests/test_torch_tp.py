"""Tensor-parallel serving over a ``model`` axis against the reference's
single-device functions and engine, on the CPU.

The reference's weights (bridged through numpy) go to the reference at
one device and, split by ``parallel/sharding.shard_params``, to the port
at 2 and 4 ranks — emulated in one process (``ModelAxis``) and, for the
engine, over 4 gloo rank processes (``serve/ranks.py``).  At f32:

* ``forward``, ``prefill`` and a decode step of the four dense smoke
  configs (OLMo, Mistral-NeMo with GQA, H2O-Danube with a sliding window,
  Command-R with a parallel block) within 2e-5 of the reference's — the
  ranks' partial sums add in another order, never bit for bit; a variant
  with non-zero biases shows the row-parallel biases added once;
* the engine, dense and paged, mirrors ``tests/test_serve_sharded.py``:
  (a) a burst's streams and admission log equal to the reference's
  single-device engine at tp 1/2/4, (b) mixed arrivals on a virtual clock,
  (c) the decode tick's exchanges equal at tp 2 and 4 (the port's own
  schedule: ``2 L + 1`` all-reduces and one all-gather) and none at tp 1,
  (d) a straggler inflating TPOT more than 10x with the tokens unchanged;
* the same burst over 4 rank processes, a failing rank 0 ending the group
  long before its timeout, and ``serve.sharded_sweep`` whose rows carry
  the reference's names, metrics and parameter keys (the reference's run
  over 4 forced host devices in a subprocess).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro.serve.continuous import ContinuousEngine as JEngine
from repro.serve.loadgen import LoadSpec as JLoadSpec
from repro.serve.loadgen import make_requests as j_make_requests
from repro.serve.scheduler import ServeRequest as JServeRequest
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.core import serving
from repro_torch.fabric import ServeFabric, canonical_conditions
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.parallel import rank_bodies
from repro_torch.parallel.dist import run_ranks
from repro_torch.parallel.model_axis import ModelAxis
from repro_torch.serve import ranks
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.loadgen import LoadSpec, make_requests
from repro_torch.serve.scheduler import ServeRequest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ("olmo-1b", "mistral-nemo-12b", "h2o-danube-3-4b",
         "command-r-plus-104b")
TOL_F32 = 2e-5
ENGINE = dict(n_slots=4, cache_len=64, block_size=8)
MAX_NEW = 6
SPEC = dict(n_requests=6, rate_rps=0.0, prompt_lens=(8, 16),
            max_new_tokens=MAX_NEW, seed=3)

_MODELS: dict = {}


def _model(arch, bias=False):
    """(jcfg, cfg, jparams, numpy tree) of the f32 smoke config, made
    once; ``bias`` gives every projection a non-zero bias."""
    key = (arch, bias)
    if key not in _MODELS:
        change = dict(dtype="float32", use_bias=True) if bias \
            else dict(dtype="float32")
        jcfg = dataclasses.replace(j_smoke(j_all_archs()[arch]), **change)
        cfg = dataclasses.replace(smoke(all_archs()[arch]), **change)
        tree = jax.tree_util.tree_map(
            np.asarray, jregistry.init_params(jcfg, jax.random.key(0)))
        if bias:
            rng = np.random.default_rng(1)

            def perturb(path, a):
                if path[-1].key == "bias":
                    return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
                return a
            tree = jax.tree_util.tree_map_with_path(perturb, tree)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        _MODELS[key] = (jcfg, cfg, jparams, tree)
    return _MODELS[key]


def _shards(cfg, tree, n):
    return bridge.shards_from_numpy(cfg, tree, n, range(n), device="cpu")


def _err(got, want) -> float:
    return float(np.max(np.abs(got.detach().float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", DENSE + ("olmo-1b+bias",))
def test_model_functions_at_tp_match_the_reference(arch, n):
    arch, bias = arch.split("+")[0], arch.endswith("+bias")
    jcfg, cfg, jparams, tree = _model(arch, bias)
    axis = ModelAxis(n)
    shards = _shards(cfg, tree, n)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    want, _ = jregistry.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = registry.forward(cfg, shards, {"tokens": torch.tensor(tokens)},
                                axis=axis)
    assert got.shape == want.shape and _err(got, want) <= TOL_F32
    assert float(aux["lb_loss"]) == 0.0
    jl, jc = jregistry.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                               cache_len=32)
    tl, tc = registry.prefill(cfg, shards, {"tokens": torch.tensor(tokens)},
                              cache_len=32, axis=axis)
    assert _err(tl, jl) <= TOL_F32
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tok),
                            "index": jnp.int32(24 + step)}, jc)
        tl, tc = registry.decode_step(
            cfg, shards, {"tokens": torch.tensor(tok), "index": 24 + step},
            tc, axis=axis)
        assert _err(tl, jl) <= TOL_F32, step
    # each rank's caches hold its local kv heads, ranks leading
    k = tc["l0"]["k"]
    assert k.shape[0] == n and k.shape[-2] == max(1, cfg.num_kv_heads // n)


def _reference_burst(arch, paged, clock=None):
    jcfg, _, jparams, _ = _model(arch)
    kw = {"clock": clock} if clock is not None else {}
    eng = JEngine(jcfg, jparams, paged=paged, **ENGINE, **kw)
    reqs = eng.generate(j_make_requests(JLoadSpec(vocab_size=jcfg.vocab_size,
                                                  **SPEC)))
    return rank_bodies.streams(reqs), list(eng.scheduler.admit_log)


def _port_engine(arch, tp, paged, **kw):
    _, cfg, _, tree = _model(arch)
    params = bridge.params_from_numpy(cfg, tree, device="cpu")
    return ContinuousEngine(cfg, params, paged=paged, tp_size=tp,
                            device="cpu", **ENGINE, **kw)


@pytest.mark.parametrize("arch,paged", [("olmo-1b", False), ("olmo-1b", True),
                                        ("mistral-nemo-12b", True),
                                        ("h2o-danube-3-4b", False)])
def test_burst_streams_and_admissions_equal_the_reference(arch, paged):
    """(a) and (c): tp 1/2/4 serve the reference's single-device streams
    and admission log; the decode tick's exchanges are the same at tp 2
    and 4, none at tp 1."""
    want, want_log = _reference_burst(arch, paged)
    counts = {}
    for tp in (1, 2, 4):
        eng = _port_engine(arch, tp, paged)
        reqs = eng.generate(make_requests(
            LoadSpec(vocab_size=eng.cfg.vocab_size, **SPEC)))
        assert rank_bodies.streams(reqs) == want, tp
        assert list(eng.scheduler.admit_log) == want_log, tp
        eng.scheduler.check()
        assert eng.kv.n_free == eng.kv.n_blocks and eng.tp_size == tp
        assert eng.cells.n_devices == tp
        counts[tp] = eng.cells.decode_collective_counts(eng.params)
    L = eng.cfg.num_layers
    assert counts[1] == {}
    assert counts[2] == counts[4] == {"all-reduce": 2 * L + 1,
                                      "all-gather": 1}


def test_a_parallel_block_reduces_once_a_layer():
    eng = _port_engine("command-r-plus-104b", 2, True)
    L = eng.cfg.num_layers
    assert eng.cells.decode_collective_counts(eng.params) == {
        "all-reduce": L + 1, "all-gather": 1}


def test_mixed_arrivals_on_a_virtual_clock():
    """(b): a late request joins mid-stream at tp 4 as on one device, and
    the streams are the reference's."""
    def run(make, req, tp=None):
        tick = {"t": 0.0}

        def vclock():
            tick["t"] += 1.0
            return tick["t"]
        eng = make(vclock) if tp is None else make(vclock, tp)
        a = req(prompt=np.arange(8, dtype=np.int32), max_new_tokens=12,
                arrival_s=0.0)
        b = req(prompt=np.arange(8, dtype=np.int32) + 5, max_new_tokens=4,
                arrival_s=25.0)
        eng.run([a, b])
        assert a.t_first_token < b.t_admit < a.t_done
        return rank_bodies.streams([a, b])

    jcfg, _, jparams, _ = _model("olmo-1b")
    want = run(lambda c: JEngine(jcfg, jparams, clock=c, **ENGINE),
               JServeRequest)
    for paged in (False, True):
        got = run(lambda c, tp: _port_engine("olmo-1b", tp, paged, clock=c),
                  ServeRequest, 4)
        assert got == want


def test_a_straggler_drags_the_sharded_tick():
    """(d): host-side stalls drag the whole tensor-parallel decode tick —
    TPOT inflates on the virtual clock, tokens do not move."""
    want, _ = _reference_burst("olmo-1b", False)

    def run(cond):
        tick = {"t": 0.0}

        def vclock():
            tick["t"] += 1e-4
            return tick["t"]
        fab = None if cond is None else ServeFabric(
            cond, sleep=lambda s: tick.__setitem__("t", tick["t"] + s))
        eng = _port_engine("olmo-1b", 4, True, clock=vclock, fabric=fab)
        reqs = eng.generate(make_requests(
            LoadSpec(vocab_size=eng.cfg.vocab_size, **SPEC)))
        return rank_bodies.streams(reqs), [r.tpot_s for r in reqs], fab

    clean, clean_tpot, _ = run(None)
    slow, slow_tpot, fab = run(canonical_conditions()["straggler"])
    assert slow == clean == want
    assert fab.stalled_s["decode"] > 0.0 and fab.stalled_s["admit"] == 0.0
    assert min(slow_tpot) > 10 * max(clean_tpot)


def test_rank_processes_serve_the_reference_streams():
    """The burst over 4 gloo rank processes (rank 0 drives, the others
    follow): the reference's streams and admission log, the pool
    recycled, and every rank made the same exchanges; then rank 0 failing
    in its host loop ends the whole group long before its timeout."""
    jcfg, cfg, _, tree = _model("olmo-1b")
    want, want_log = _reference_burst("olmo-1b", True)
    kw = dict(ENGINE, paged=True, device="cpu")
    reqs = make_requests(LoadSpec(vocab_size=cfg.vocab_size, **SPEC))
    out = run_ranks(ranks.serve_rank, 4, backend="gloo", device="cpu",
                    args=(cfg, ("numpy", tree), rank_bodies.burst, (kw, reqs)),
                    timeout_s=240)
    res = out[0]["result"]
    assert res["streams"] == want and res["admit_log"] == want_log
    assert res["pool_recycled"]
    L = cfg.num_layers
    assert res["collectives"] == {"all-reduce": 2 * L + 1, "all-gather": 1}
    assert all(o["exchanges"] == out[0]["exchanges"] for o in out)
    assert all(o["calls"] > 0 for o in out[1:])
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 0's clock failed"):
        run_ranks(ranks.serve_rank, 4, backend="gloo", device="cpu",
                  args=(cfg, ("numpy", tree), rank_bodies.failing,
                        (kw, reqs, 20)), timeout_s=600)
    assert time.perf_counter() - t0 < 120


def test_tp_size_above_the_visible_ranks_names_devices(capsys):
    """The serve CLI refuses a tensor-parallel width above the rank
    processes ``--devices`` gives it, naming the flag.  The emulated
    engine has no device count to bound: any width that splits the heads
    and the FFN runs, and one that does not raises."""
    from repro_torch.launch import serve
    for argv, visible in ((["--tp-size", "4", "--devices", "2"], 2),
                          (["--tp-size", "2"], 1)):
        with pytest.raises(SystemExit):
            serve.main(argv, device="cpu")
        err = capsys.readouterr().err
        assert f"exceeds the {visible} visible" in err and "--devices" in err
    _, cfg, _, tree = _model("olmo-1b")
    params = bridge.params_from_numpy(cfg, tree, device="cpu")
    eng = ContinuousEngine(cfg, params, tp_size=4, device="cpu", **ENGINE)
    assert eng.tp_size == 4 and eng.kv.n_shards == 4
    with pytest.raises(ValueError, match="model axis of 3"):
        ContinuousEngine(cfg, params, tp_size=3, device="cpu", **ENGINE)


def test_over_ranks_the_engine_runs_in_rank_zero_alone():
    """An engine on a rank group's mesh must be rank 0's, leading: a
    follower runs the cells, never a host loop of its own."""
    from repro_torch.parallel.pods import DistPodAxis
    _, cfg, _, tree = _model("olmo-1b")
    params = bridge.params_from_numpy(cfg, tree, device="cpu")
    mesh = make_mesh((1, 2), ("data", "model"),
                     ranks=DistPodAxis(2, 1, "gloo"))
    assert mesh.distributed and not mesh.lead
    with pytest.raises(ValueError, match="rank 0 alone"):
        ContinuousEngine(cfg, params, mesh=mesh, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="group of 2"):
        make_mesh((1, 4), ("data", "model"), ranks=DistPodAxis(2, 1, "gloo"))


def test_a_non_dense_family_under_a_mesh_names_its_slice():
    """Every family serves over a model axis now (the other families'
    tests: ``tests/test_torch_{tp_moe,tp_ssm,tp_encdec_vlm}.py``), and
    every family trains over one too, with sequence parallelism: one step
    of each on a (1, 2) mesh with it gives the step's loss without it."""
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.train import step as tstep
    mesh = make_mesh((1, 2), ("data", "model"))
    for arch in ("rwkv6-7b", "moonshot-v1-16b-a3b", "whisper-base"):
        cfg = smoke(all_archs()[arch])
        caches = registry.init_decode_caches(cfg, 2, 16, "cpu",
                                             axis=mesh.axis)
        assert all(a.shape[0] == 2 for _, a in bridge.flatten(caches))
        gen = torch.Generator()
        gen.manual_seed(0)
        assert bridge.init_shards(cfg, gen, 2, (0, 1)).n == 2
        transformer.check_tp_train(cfg, 2)
        transformer.check_tp_train(cfg, 2, sequence_parallel=True)
        cfg = dataclasses.replace(cfg, dtype="float32")
        batch = pipeline.synth_batch(pipeline.for_arch(cfg, 16, 2), 0)
        losses = []
        for sp in (False, True):
            opts = tstep.TrainOptions(sequence_parallel=sp)
            gen = torch.Generator()
            gen.manual_seed(0)
            state = tstep.make_train_state(cfg, opts, gen, mesh)
            _, m = tstep.make_train_step(cfg, None, mesh, opts)(state, batch)
            losses.append(float(m["loss"]))
        assert np.isfinite(losses).all() \
            and abs(losses[1] - losses[0]) < 1e-5, (arch, losses)


REFERENCE_SWEEP = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from repro.core import serving
recs = serving.sharded_sweep(duration=0.0, offered=(1.0,), max_requests=4)
print("ROWS" + json.dumps([[r.name, r.metric, sorted(r.params)]
                           for r in recs]))
"""


def test_sharded_sweep_over_four_ranks_has_the_reference_rows():
    out = subprocess.run([sys.executable, "-c", REFERENCE_SWEEP],
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    line = [x for x in out.stdout.splitlines() if x.startswith("ROWS")]
    assert line, out.stdout + out.stderr
    want = json.loads(line[0][4:])
    recs = serving.sharded_sweep(duration=0.0, offered=(1.0,),
                                 max_requests=4, device="cpu", devices=4)
    assert [[r.name, r.metric, sorted(r.params)] for r in recs] == want
    assert recs[0].params["per_kind"] == {"all-gather": 1.0,
                                          "all-reduce": 5.0}
    assert recs[0].params["mesh_axes"] == {"data": 1, "model": 4}
    assert not any(r.error for r in recs)


def test_cli_serves_over_rank_processes(capsys):
    from repro_torch.launch import serve
    argv = ["--requests", "4", "--max-new", "4", "--cache-len", "64",
            "--block-size", "8", "--paged"]
    serve.main(argv + ["--tp-size", "2", "--devices", "2"], device="cpu")
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 4 and "tokens=4" in out
    assert "continuous tp=2 paged(depth=2): 4 requests, 16 tokens" in out
    serve.main(argv + ["--devices", "4"], device="cpu")
    assert "continuous paged(depth=2): 4 requests" in capsys.readouterr().out
