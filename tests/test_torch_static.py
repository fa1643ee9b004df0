"""The static run-to-completion engine against the reference's.

The port's ``serve/engine.Engine`` and the reference's serve the same
prompts with the same weights (bridged through numpy) on the CPU: at f32
their greedy token streams must be equal, on equal-length prompts and on
mixed prompts the batch left-pads (pad tokens are attended in both, so
the streams are the reference's, not the ones a prompt would get alone).
Three smoke configs: OLMo-1B (dense attention), H2O-Danube3-4B (sliding
window 16: prompts past it, decoded past it) and RWKV6-7B (recurrent
state).  On equal-length prompts the static engine also gives the port's
continuous engine's streams.  Then the errors, the refused mesh, and the
serve CLI's ``--static`` with each refusal the reference makes for it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.launch.mesh import make_mesh
from repro.models import registry as jregistry
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.serve import step
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import ServeRequest

ARCHS = ("olmo-1b", "h2o-danube-3-4b", "rwkv6-7b")
BATCH, CACHE_LEN = 4, 64
# prompt lengths of one batch: equal, and mixed (left-padded to the
# longest; Danube's 21 and 37 pass its window of 16)
PROMPTS = {"equal": (12, 12, 12, 12), "mixed": (5, 21, 12, 37)}
MAX_NEW = (6, 9, 3, 7)

_MODELS: dict = {}


def _model(arch):
    """(jcfg, cfg, jparams, params) of the f32 smoke config, made once."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_smoke(j_all_archs()[arch]),
                                   dtype="float32")
        cfg = dataclasses.replace(smoke(all_archs()[arch]), dtype="float32")
        jparams = jregistry.init_params(jcfg, jax.random.key(0))
        params = bridge.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        _MODELS[arch] = (jcfg, cfg, jparams, params)
    return _MODELS[arch]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _reference(arch, lens, max_new, batch=BATCH):
    jcfg, _, jparams, _ = _model(arch)
    eng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")),
                  batch_size=batch, cache_len=CACHE_LEN, params=jparams)
    reqs = [JRequest(prompt=p, max_new_tokens=m)
            for p, m in zip(_prompts(jcfg.vocab_size, lens), max_new)]
    return [list(r.generated) for r in eng.generate(reqs)]


def _port_engine(arch, batch=BATCH, mesh=None):
    _, cfg, _, params = _model(arch)
    return Engine(cfg, mesh, batch_size=batch, cache_len=CACHE_LEN,
                  params=params, device="cpu")


def _port(arch, lens, max_new, batch=BATCH):
    _, cfg, _, _ = _model(arch)
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, m in zip(_prompts(cfg.vocab_size, lens), max_new)]
    out = _port_engine(arch, batch).generate(reqs)
    assert out is reqs
    assert all(r.done and len(r.generated) == m
               for r, m in zip(reqs, max_new))
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("prompts", sorted(PROMPTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_matches_reference(arch, prompts):
    lens = PROMPTS[prompts]
    assert _port(arch, lens, MAX_NEW) == _reference(arch, lens, MAX_NEW)


def test_static_engine_pads_a_short_batch_with_dummies():
    """Two requests in a batch of four: dummies fill it, and the two
    streams are still the reference's."""
    lens, max_new = (9, 14), (5, 4)
    assert _port("olmo-1b", lens, max_new) \
        == _reference("olmo-1b", lens, max_new)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_equals_continuous_on_equal_prompts(arch):
    """Equal-length prompts need no padding: the run-to-completion batch
    and the slot-admission engine decode the same greedy tokens."""
    _, cfg, _, params = _model(arch)
    lens = PROMPTS["equal"]
    cont = ContinuousEngine(cfg, params, n_slots=BATCH, cache_len=CACHE_LEN,
                            block_size=8, device="cpu")
    reqs = cont.generate([ServeRequest(prompt=p, max_new_tokens=m)
                          for p, m in zip(_prompts(cfg.vocab_size, lens),
                                          MAX_NEW)])
    assert [list(r.generated) for r in reqs] == _port(arch, lens, MAX_NEW)


def test_static_engine_errors():
    eng = _port_engine("olmo-1b", batch=2)
    assert eng.generate([]) == []
    prompt = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="exceeds engine batch_size=2"):
        eng.generate([Request(prompt=prompt) for _ in range(3)])


def test_static_engine_refuses_a_mesh_and_defaults_to_the_card(
        monkeypatch):
    """A mesh no longer refused: the static engine at emulated tp 2
    serves the single-device streams (the steps run the dense family over
    the mesh's model axis); it still defaults to the card."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"))
    _, cfg, _, params = _model("olmo-1b")
    for lens in PROMPTS.values():
        reqs = [Request(prompt=p, max_new_tokens=m)
                for p, m in zip(_prompts(cfg.vocab_size, lens), MAX_NEW)]
        _port_engine("olmo-1b", mesh=mesh).generate(reqs)
        assert [list(r.generated) for r in reqs] \
            == _port("olmo-1b", lens, MAX_NEW)
    caches = {}
    for m in (None, mesh):
        prefill = step.make_prefill_step(cfg, mesh=m, cache_len=16)
        decode = step.make_decode_step(cfg, mesh=m)
        put = step.put_params(cfg, m, params, "cpu")
        toks = torch.tensor(np.stack(_prompts(cfg.vocab_size, (12, 12))))
        logits, c = prefill(put, {"tokens": toks})
        logits2, c = decode(put, c, {"tokens": toks[:, :1], "index": 12})
        caches[m is None] = (logits, logits2, c)
    for a, b in zip(caches[True][:2], caches[False][:2]):
        assert float((a - b).abs().max()) <= 2e-5
    full_k, rank_k = caches[True][2]["l0"]["k"], caches[False][2]["l0"]["k"]
    assert rank_k.shape == (2,) + full_k.shape[:-2] \
        + (cfg.num_kv_heads // 2, cfg.hd)              # ranks lead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        Engine(cfg, None, batch_size=2, cache_len=CACHE_LEN, params=params)


def test_cli_static_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--static", "--requests", "6", "--batch", "4",
                "--max-new", "5", "--cache-len", "64"], device="cpu")
    out = capsys.readouterr().out
    assert out.count("(static batch — no per-stage stamps)") == 6
    assert "tokens=5" in out
    assert "[serve] static: 6 requests, 30 tokens in " in out
    assert "(offered burst req/s)" in out


@pytest.mark.parametrize("argv,msg", [
    (["--fabric", "jitter"], "the static engine has no such hooks"),
    (["--rate", "5"], "it cannot pace arrivals"),
    (["--tp-size", "2"], "the static engine has no sharded path"),
    (["--paged"], "the static engine has no paged path"),
    (["--trace", "t.jsonl"], "the static engine has neither"),
    (["--slo"], "the static engine has neither"),
    (["--save-trace", "t.jsonl"], "records the continuous engine's"),
    (["--trace-out", "t.json"], "the static engine has no span"),
    (["--log-cap", "8"], "the static engine has no span"),
])
def test_cli_static_refusals_are_the_reference_ones(argv, msg, capsys):
    """Each refusal the reference makes for ``--static`` combined with a
    continuous-engine flag, with the reference's message."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(["--static", *argv], device="cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert msg in err and "drop" in err
