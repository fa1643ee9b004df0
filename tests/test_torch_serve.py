"""The serving slice as a whole: the port's engine against the reference's.

Both engines serve the same seeded request set on the f32 smoke config
(``n_slots=4, cache_len=64, block_size=8`` — the set-up of
``tests/test_serve_paged.py``) with the same weights (bridged through
numpy) on the CPU, each on its own copy of the same virtual clock.  Greedy
token streams, admission logs and every latency stamp must be equal;
the page pool must be recycled and the tables back to all-trash.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro.serve.continuous import ContinuousEngine as JEngine
from repro.serve.loadgen import LoadSpec as JLoadSpec
from repro.serve.loadgen import make_requests as j_make_requests
from repro_torch import bridge, runtime
from repro_torch.configs import all_archs, smoke
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.obs import Tracer
from repro_torch.serve import step
from repro_torch.serve.continuous import ContinuousEngine, StepEvent
from repro_torch.serve.loadgen import LoadSpec, make_requests

ENGINE = dict(n_slots=4, cache_len=64, block_size=8)
SPEC = dict(n_requests=6, rate_rps=0.0, prompt_lens=(8, 16),
            max_new_tokens=6, seed=3)
STAMPS = ("t_enqueue", "t_admit", "t_first_token", "t_done", "t_shed")


def _clock():
    """A virtual clock: every read advances one millisecond."""
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke(j_all_archs()["olmo-1b"]),
                               dtype="float32")
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def reference_runs(setup):
    """The reference engine's runs, by (paged, depth), made once."""
    jcfg, _, jparams, _ = setup
    runs = {}

    def run(paged, depth):
        key = (paged, depth)
        if key not in runs:
            eng = JEngine(jcfg, jparams, clock=_clock(), paged=paged,
                          page_buffer_depth=depth, **ENGINE)
            reqs = eng.run(j_make_requests(
                JLoadSpec(vocab_size=jcfg.vocab_size, **SPEC)))
            runs[key] = (eng, reqs)
        return runs[key]
    return run


def _port_run(setup, **kw):
    _, cfg, _, params = setup
    eng = ContinuousEngine(cfg, params, clock=_clock(), device="cpu",
                           **ENGINE, **kw)
    reqs = eng.run(make_requests(LoadSpec(vocab_size=cfg.vocab_size, **SPEC)))
    return eng, reqs


@pytest.mark.parametrize("paged,depth", [(False, 2), (True, 1), (True, 2)])
def test_engine_matches_reference(paged, depth, setup, reference_runs):
    jeng, jreqs = reference_runs(paged, depth)
    eng, reqs = _port_run(setup, paged=paged, page_buffer_depth=depth,
                          debug=paged)
    assert [list(r.generated) for r in reqs] \
        == [list(r.generated) for r in jreqs]
    assert all(len(r.generated) == 6 for r in reqs)
    assert list(eng.scheduler.admit_log) == list(jeng.scheduler.admit_log)
    for r, jr in zip(reqs, jreqs):
        assert [r.prompt.tolist(), r.rid] == [jr.prompt.tolist(), jr.rid]
        for name in STAMPS:
            assert getattr(r, name) == getattr(jr, name), (r.rid, name)
        assert r.decode_token_s == jr.decode_token_s, r.rid
    assert [dataclasses.astuple(e) for e in eng.step_log] \
        == [dataclasses.astuple(e) for e in jeng.step_log]
    assert isinstance(eng.step_log[0], StepEvent)
    assert eng.idle_iters == jeng.idle_iters
    eng.scheduler.check()
    assert eng.kv.n_free == eng.kv.n_blocks
    if paged:
        assert (eng._tables_np == eng.kv.trash_page).all()
        assert eng.cells.buffer_depth == depth


def test_paged_equals_dense_and_plain_impl(setup):
    """Paged is a KV-residency change only; impl='torch' calls the plain
    versions outright — both give the dense engine's streams."""
    _, dense = _port_run(setup)
    _, paged = _port_run(setup, paged=True)
    with runtime.use_policy(attention_impl="torch",
                            paged_attention_impl="torch"):
        _, plain = _port_run(setup, paged=True)
    toks = [list(r.generated) for r in dense]
    assert [list(r.generated) for r in paged] == toks
    assert [list(r.generated) for r in plain] == toks
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "paged_attention": 0,
                                   "rwkv6_scan": 0, "quantize_int8": 0,
                                   "dequantize_int8": 0}   # CPU: no launch


def test_paced_arrivals_and_deadline(setup):
    """Arrivals offered on the virtual clock, then a deadline that sheds
    what is unfinished: pages released, slots reset."""
    _, cfg, _, params = setup
    spec = LoadSpec(vocab_size=cfg.vocab_size, **dict(SPEC, rate_rps=20.0))
    eng = ContinuousEngine(cfg, params, clock=_clock(), device="cpu",
                           paged=True, **ENGINE)
    idle = []
    reqs = eng.run(make_requests(spec), idle_hook=lambda: idle.append(1))
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    assert eng.idle_iters == len(idle) > 0
    eng2 = ContinuousEngine(cfg, params, clock=_clock(), device="cpu",
                            paged=True, **ENGINE)
    cut = eng2.run(make_requests(spec), idle_hook=lambda: None,
                   deadline_s=0.12)
    assert any(r.shed_reason == "deadline" for r in cut)
    assert eng2.kv.n_free == eng2.kv.n_blocks
    assert (eng2._tables_np == eng2.kv.trash_page).all()


def test_traced_run_equals_untraced(setup):
    """Tracing makes exactly the same clock calls: same tokens, same
    stamps; and the trace holds the engine's spans."""
    _, plain = _port_run(setup, paged=True)
    tracer = Tracer(clock=_clock())
    eng, traced = _port_run(setup, paged=True, tracer=tracer)
    for r, t in zip(plain, traced):
        assert list(r.generated) == list(t.generated)
        assert r.t_first_token == t.t_first_token and r.t_done == t.t_done
    names = {e["name"] for e in tracer.events}
    assert {"run_begin", "pool_geometry", "admit", "prefill", "insert",
            "decode"} <= names


def test_log_cap_ring_buffers_the_logs(setup):
    eng, _ = _port_run(setup, paged=True, log_cap=3)
    assert len(eng.step_log) == 3 and eng.step_log.dropped > 0
    assert len(eng.scheduler.admit_log) == 3


def test_paged_rejects_untileable_cache(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="divisible by block_size"):
        ContinuousEngine(cfg, params, n_slots=2, cache_len=60, block_size=8,
                         paged=True, device="cpu")


@pytest.mark.parametrize("change", [dict(sliding_window=16),
                                    dict(family="ssm"),
                                    dict(family="hybrid", attn_period=4)])
def test_paged_rejects_unsupported_arch(change, setup):
    _, cfg, _, params = setup
    bad = dataclasses.replace(cfg, **change)
    with pytest.raises(ValueError, match="keeps the dense path"):
        ContinuousEngine(bad, params, n_slots=2, cache_len=64, block_size=8,
                         paged=True, device="cpu")


@pytest.mark.parametrize("kw", [dict(tp_size=2), dict(mesh="emulated")])
def test_tensor_parallel_names_the_later_slice(kw, setup, reference_runs):
    """Tensor-parallel serving runs: the paged engine at ``tp_size=2`` (or
    on an explicit emulated mesh of 2) serves the reference's streams and
    admission log; the other families the engines take build their cells
    under the mesh too (their streams: ``tests/test_torch_tp_moe.py``,
    ``tests/test_torch_tp_ssm.py``)."""
    from repro_torch.launch.mesh import make_mesh
    if kw.get("mesh") == "emulated":
        kw = dict(mesh=make_mesh((1, 2), ("data", "model")))
    jeng, jreqs = reference_runs(True, 2)
    eng, reqs = _port_run(setup, paged=True, page_buffer_depth=2, **kw)
    assert eng.tp_size == 2 and eng.kv.n_shards == 2
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert list(eng.scheduler.admit_log) == list(jeng.scheduler.admit_log)
    rwkv = dataclasses.replace(smoke(all_archs()["rwkv6-7b"]),
                               dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    rparams = registry.init_params(rwkv, gen)
    mesh = kw.get("mesh") or make_mesh((1, 2), ("data", "model"))
    assert ContinuousEngine(rwkv, rparams, device="cpu", **kw).tp_size == 2
    assert step.make_continuous_cells(rwkv, 2, 64, mesh=mesh,
                                      device="cpu").tp_size == 2
    moe = dataclasses.replace(smoke(all_archs()["moonshot-v1-16b-a3b"]),
                              dtype="float32")
    assert step.make_paged_cells(moe, 2, 64, 8, 17, mesh=mesh,
                                 device="cpu").tp_size == 2


def test_entry_points_default_to_the_card_and_raise_without_one(
        setup, monkeypatch):
    """No silent CPU fallback: without a CUDA device the default entry
    points raise; only an explicit device='cpu' runs on the CPU."""
    _, cfg, _, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ContinuousEngine(cfg, params, paged=True, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA device"):
        step.make_paged_cells(cfg, 4, 64, 8, 33)
    with pytest.raises(RuntimeError, match="CUDA device"):
        step.make_continuous_cells(cfg, 4, 64)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--requests", "2"])


def test_request_validation(setup):
    _, cfg, _, params = setup
    eng = ContinuousEngine(cfg, params, device="cpu", paged=True, **ENGINE)
    spec = LoadSpec(vocab_size=cfg.vocab_size, **dict(SPEC, prompt_lens=(60,)))
    with pytest.raises(ValueError, match="cache positions"):
        eng.run(make_requests(spec))


def test_cli_serves_on_the_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import serve
    trace = tmp_path / "trace.json"
    serve.main(["--requests", "4", "--max-new", "5", "--cache-len", "64",
                "--block-size", "8", "--paged", "--buffer-depth", "1",
                "--trace-out", str(trace)], device="cpu")
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 4 and "tokens=5" in out
    assert "continuous paged(depth=1): 4 requests, 20 tokens" in out
    assert trace.exists()


@pytest.mark.parametrize("arch,paged", [("moonshot-v1-16b-a3b", True),
                                        ("qwen3-moe-235b-a22b", True),
                                        ("jamba-1.5-large-398b", False)])
def test_cli_serves_the_moe_and_hybrid_archs(arch, paged, capsys):
    """The MoE archs through the paged engine, Jamba (Mamba + MoE) through
    the dense one, smoke-reduced, on the CPU."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                "--cache-len", "64", "--block-size", "8"]
               + ["--paged"] * paged, device="cpu")
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 3 and "tokens=4" in out
    assert ("paged(depth=2)" in out) == paged


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_engines_refuse_what_needs_more_than_tokens(arch):
    """The engines pass only tokens, as the reference's do: an
    encoder-decoder or VLM arch is refused up front, saying why."""
    cfg = dataclasses.replace(smoke(all_archs()[arch]), dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = registry.init_params(cfg, gen)
    for paged in (False, True):
        with pytest.raises(ValueError, match="pass only tokens"):
            ContinuousEngine(cfg, params, n_slots=2, cache_len=64,
                             block_size=8, paged=paged, device="cpu")
    from repro_torch.serve.engine import Engine
    with pytest.raises(ValueError, match="pass only tokens"):
        Engine(cfg, None, batch_size=2, cache_len=64, params=params,
               device="cpu")


@pytest.mark.parametrize("argv,msg", [
    (["--static", "--tp-size", "2", "--devices", "2"], "no sharded path"),
    (["--fabric", "straggler", "--tp-size", "2"], "exceeds the 1 visible"),
    (["--fabric", "nonsense"], "unknown condition"),
    (["--tp-size", "0"], "must be >= 1"),
    (["--tp-size", "4", "--devices", "2"], "exceeds the 2 visible"),
    (["--buffer-depth", "3"], "needs --paged"),
    (["--paged", "--cache-len", "60", "--block-size", "8"], "divisible"),
    (["--arch", "whisper-base"], "needs frames"),
    (["--arch", "internvl2-26b"], "needs patches"),
])
def test_cli_rejections(argv, msg, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(argv, device="cpu")
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_flags_are_the_reference_flags():
    """Same flags as ``python -m repro.launch.serve`` — none added."""
    import re
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    flags = [set(re.findall(r'add_argument\("(--[\w-]+)"',
                            (src / pkg / "launch" / "serve.py").read_text()))
             for pkg in ("repro", "repro_torch")]
    assert flags[0] == flags[1] and len(flags[0]) > 15
