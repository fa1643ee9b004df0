"""Tensor-parallel serving of the encoder-decoder (Whisper) and VLM
(InternVL2) families against the reference's single-device functions, on
the CPU, at f32 (``tests/test_torch_tp_moe.py``'s helpers and
tolerances):

* ``forward``, ``prefill`` and 3 decode steps through
  ``models/registry`` with ``frames`` / ``patches`` at emulated tp 2 and
  4, within 2e-5 of the reference's and of the port's at one device;
* each rank's caches at its local kv heads — Whisper's self-attention
  caches and cross K/V alike;
* the decode tick's exchanges equal to ``registry.decode_exchanges``:
  Whisper ``3 L`` all-reduces (self attention, cross attention, MLP; at
  full width no embedding reduction and no logits gather, its vocabulary
  of 51,865 does not split), InternVL2 the dense schedule, ``2 L`` at
  full width (92,553 does not split either); the smoke vocabulary of 512
  splits, so the smoke configs add the embedding's all-reduce and the
  logits' all-gather;
* Whisper's greedy streams at tp 2 over 2 gloo rank processes
  (``serve/ranks.call_all_ranks``: every rank runs the same
  ``models/registry`` calls on its shards) equal to the reference's;
* the engines still refuse both families over a model axis (they pass
  only tokens, as the reference's).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tp_moe as tp
from repro.models import registry as jregistry
from repro_torch.configs import all_archs, smoke
from repro_torch.models import registry
from repro_torch.parallel import rank_bodies
from repro_torch.parallel.dist import run_ranks
from repro_torch.serve import ranks
from repro_torch.serve.continuous import ContinuousEngine

ARCHS = ("whisper-base", "internvl2-26b")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_encdec_and_vlm_functions_at_tp_match_the_reference(arch, n):
    out = tp.hold_functions(arch, n)
    _, cfg, _, _ = tp.model(arch)
    c = out["caches"]
    kv = cfg.num_kv_heads // n
    if cfg.family == "encdec":
        assert c["xk"].shape[0] == n and c["xk"].shape[-2] == kv
        assert c["self"]["k"].shape[-2] == kv
        assert out["ticks"][0] == {"all-reduce": 3 * cfg.num_layers + 1,
                                   "all-gather": 1}
    else:
        assert c["l0"]["k"].shape[-2] == max(1, kv)
        assert out["ticks"][0] == {"all-reduce": 2 * cfg.num_layers + 1,
                                   "all-gather": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_schedules_have_no_vocabulary_exchange(arch):
    """At full width neither vocabulary splits over 2 or 4: Whisper's tick
    is ``3 L`` all-reduces, InternVL2's ``2 L``, no gather."""
    cfg = all_archs()[arch]
    per = 3 if cfg.family == "encdec" else 2
    for n in (2, 4):
        assert cfg.vocab_size % n
        assert registry.decode_exchanges(cfg, n) == {
            "all-reduce": per * cfg.num_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_engines_still_refuse_them_over_a_model_axis(arch):
    cfg = dataclasses.replace(smoke(all_archs()[arch]), dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = registry.init_params(cfg, gen)
    with pytest.raises(ValueError, match="pass only tokens"):
        ContinuousEngine(cfg, params, tp_size=2, device="cpu", **tp.ENGINE)


def test_whisper_over_rank_processes_serves_the_reference_streams():
    """Whisper's prefill and 6 greedy decode steps over 2 rank processes
    (rank 0 sends each rank the body, every rank runs it on its shards):
    the reference's streams, and the emulated axis's."""
    jcfg, cfg, jparams, tree = tp.model("whisper-base")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 4)).astype(np.int32)
    batch = {"tokens": tokens, **tp.extras(cfg)}
    steps, cache_len = 6, 16
    jl, jc = jregistry.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v
                                               in batch.items()},
                               cache_len=cache_len)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    want = [tok.tolist()]
    for i in range(steps):
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tok)[:, None],
                            "index": jnp.int32(4 + i)}, jc)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        want.append(tok.tolist())
    want = [list(r) for r in zip(*want)]
    out = run_ranks(ranks.serve_rank, 2, backend="gloo", device="cpu",
                    args=(cfg, ("numpy", tree), rank_bodies.greedy_job,
                          (batch, steps, cache_len)), timeout_s=300)
    assert out[0]["result"]["streams"] == want
    assert all(o["exchanges"] == out[0]["exchanges"] for o in out)
    assert out[1]["calls"] == 1
    from repro_torch.launch.mesh import make_host_mesh
    emu = rank_bodies.greedy(make_host_mesh(1, 2), tp.shards(cfg, tree, 2),
                             cfg, batch, steps, cache_len)
    assert emu["streams"] == want
