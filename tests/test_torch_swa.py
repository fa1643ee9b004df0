"""The remaining dense configs and the sliding-window ring, against the
JAX reference on the CPU.

H2O-Danube3-4B (sliding window; smoke window 16), Mistral-NeMo-12B (GQA,
hd != d_model / H) and Command-R+ (parallel attention + FFN block, tied
embeddings), each at its smoke size, with the reference's weights bridged
through numpy and tokens made with numpy from a seed.  At f32 logits agree
within 2e-5 (sums taken in another order over two layers); at bf16 within
one bf16 spacing at the largest logit's size, as
``test_torch_models.test_decode_step_bf16_dense_cache`` holds them (the
reference runs op by op under ``jax.disable_jit``, the MLP is ``relu2``
and both sides attend through the reference's chunked softmax, so both
round after the same operations).  Caches are compared on their live ring
slots only (positions and K/V), never as whole tensors.
"""
import contextlib
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro.serve import paged as jpaged
from repro.serve.continuous import ContinuousEngine as JEngine
from repro.serve.loadgen import LoadSpec as JLoadSpec
from repro.serve.loadgen import make_requests as j_make_requests
from repro_torch import bridge, runtime
from repro_torch.configs import all_archs, smoke
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import registry
from repro_torch.serve import paged
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.loadgen import LoadSpec, make_requests

DANUBE, NEMO, COMMAND_R = ("h2o-danube-3-4b", "mistral-nemo-12b",
                           "command-r-plus-104b")
ARCHS = (DANUBE, NEMO, COMMAND_R)
TOL_F32 = 2e-5

# variant -> config changes on top of the smoke reduction
VARIANTS = {
    "f32": dict(dtype="float32"),
    "bf16": dict(act="relu2"),
    "hd120": dict(dtype="float32", head_dim=120),
}
CASES = [(a, v) for a in ARCHS for v in ("f32", "bf16")] \
    + [(DANUBE, "hd120")]

_MODELS: dict = {}


def _model(arch, variant, **extra):
    """(jcfg, cfg, jparams, params) of a smoke config, made once."""
    key = (arch, variant, tuple(sorted(extra.items())))
    if key not in _MODELS:
        change = dict(VARIANTS[variant], **extra)
        jcfg = dataclasses.replace(j_smoke(j_all_archs()[arch]), **change)
        cfg = dataclasses.replace(smoke(all_archs()[arch]), **change)
        jparams = jregistry.init_params(jcfg, jax.random.key(0))
        params = bridge.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        _MODELS[key] = (jcfg, cfg, jparams, params)
    return _MODELS[key]


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.detach().float().numpy()
                               - np.asarray(want, np.float32))))


def _tol(variant, want) -> float:
    if variant != "bf16":
        return TOL_F32
    top = float(np.max(np.abs(np.asarray(want, np.float32))))
    return 2.0 ** (int(np.floor(np.log2(top))) - 7)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _reference(variant):
    """The reference's context: op by op at bf16 (as PyTorch rounds)."""
    return jax.disable_jit() if variant == "bf16" \
        else contextlib.nullcontext()


def _port(variant):
    """The port's context: the reference's chunked softmax at bf16."""
    return runtime.use_policy(attention_impl="chunked") \
        if variant == "bf16" else contextlib.nullcontext()


def _live_slots_equal(tc, jc, variant):
    """Each layer's live ring slots (reference pos >= 0) hold the same
    positions, and K/V within the logits' tolerance at their own size
    (the projections' sums are taken in another order).  The port keeps
    ``pos`` per batch row, the reference once for the batch."""
    for layer in jc:
        jpos = np.asarray(jc[layer]["pos"])                  # (G, L)
        tpos = tc[layer]["pos"].numpy()                     # (G, B, L)
        assert tpos.shape[2] == jpos.shape[1], layer
        live = jpos >= 0
        for b in range(tpos.shape[1]):
            assert (tpos[:, b] == jpos).all(), (layer, b)
            for leaf in ("k", "v"):
                got = tc[layer][leaf][:, b].float().numpy()[live]
                want = np.asarray(jc[layer][leaf][:, b], np.float32)[live]
                assert np.max(np.abs(got - want)) < _tol(variant, want), \
                    (layer, leaf, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    """The port's copy of each config (and its smoke reduction) holds the
    reference's values field by field."""
    want, got = j_all_archs()[arch], all_archs()[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke(got)) == dataclasses.asdict(j_smoke(want))


def test_full_width_sizes():
    """The two configs served at full width on the card, and their KV."""
    danube, nemo = all_archs()[DANUBE], all_archs()[NEMO]
    assert (danube.num_layers, danube.d_model, danube.num_heads,
            danube.num_kv_heads, danube.hd, danube.d_ff, danube.vocab_size,
            danube.sliding_window) == (24, 3840, 32, 8, 120, 10240, 32000,
                                       4096)
    assert (nemo.num_layers, nemo.d_model, nemo.hd) == (40, 5120, 128)
    n = {a: sum(int(np.prod(s)) for s in bridge.param_shapes(
        all_archs()[a]).values()) for a in ARCHS}
    assert 3.9e9 < n[DANUBE] < 4.0e9
    assert 12.0e9 < n[NEMO] < 12.5e9
    assert 1.0e11 < n[COMMAND_R] < 1.1e11
    # a windowed arch's decode cache is its ring, whatever cache_len is
    caches = registry.init_decode_caches(smoke(danube), 2, 64, "cpu")
    assert caches["l0"]["k"].shape == (2, 2, 16, 2, 16)
    assert paged.pool_geometry(nemo, 2049, 16)["pool_bytes"] \
        == 40 * 2049 * 16 * 16 * 128 * 2


@pytest.mark.parametrize("arch,variant", CASES)
def test_forward_logits(arch, variant):
    jcfg, cfg, jparams, params = _model(arch, variant)
    tokens = _tokens(cfg, 2, 40)
    with _reference(variant):
        want, _ = jregistry.forward(jcfg, jparams,
                                    {"tokens": jnp.asarray(tokens)})
    with _port(variant):
        got, _ = registry.forward(cfg, params,
                                  {"tokens": torch.tensor(tokens)})
    assert got.shape == want.shape
    assert _err(got, want) < _tol(variant, want)


@pytest.mark.parametrize("arch,variant", CASES)
def test_prefill_then_decode(arch, variant):
    """Prefill a 24-token prompt (past Danube's window of 16, 24 % 16 = 8:
    the rolled ring) into a 32-position cache, then three greedy decode
    steps; logits at each step and the live slots after the last."""
    jcfg, cfg, jparams, params = _model(arch, variant)
    tokens = _tokens(cfg, 2, 24, seed=1)
    S = tokens.shape[1]
    with _reference(variant):
        jl, jc = jregistry.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(tokens)},
                                   cache_len=32)
    with _port(variant):
        tl, tc = registry.prefill(cfg, params,
                                  {"tokens": torch.tensor(tokens)},
                                  cache_len=32)
    assert _err(tl, jl) < _tol(variant, jl)
    ring = cfg.sliding_window or 32
    assert tc["l0"]["k"].shape[2] == ring
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        with _reference(variant):
            jl, jc = jregistry.decode_step(
                jcfg, jparams, {"tokens": jnp.asarray(tok),
                                "index": jnp.int32(S + step)}, jc)
        index = S + step if step % 2 else torch.full((2,), S + step)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tok), "index": index}, tc)
        assert _err(tl, jl) < _tol(variant, jl), step
    _live_slots_equal(tc, jc, variant)


@pytest.mark.parametrize("arch,variant", [c for c in CASES
                                          if c[1] != "hd120"])
def test_decode_from_empty_cache(arch, variant):
    """Twenty positions decoded from an empty cache (past Danube's window
    of 16: the ring wraps)."""
    jcfg, cfg, jparams, params = _model(arch, variant)
    tokens = _tokens(cfg, 2, 20, seed=2)
    with _reference(variant):
        jc = jregistry.init_decode_caches(jcfg, 2, 24)
    tc = registry.init_decode_caches(cfg, 2, 24, "cpu")
    assert tc["l0"]["k"].shape[2] == (cfg.sliding_window or 24)
    for i in range(tokens.shape[1]):
        with _reference(variant):
            jl, jc = jregistry.decode_step(
                jcfg, jparams, {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                                "index": jnp.int32(i)}, jc)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tokens[:, i:i + 1]),
                          "index": torch.full((2,), i)}, tc)
        assert _err(tl, jl) < _tol(variant, jl), i
    _live_slots_equal(tc, jc, variant)


def test_swa_ring_wraps_correctly():
    """The reference's own case (``tests/test_serving.py``): window 8, 32
    positions decoded from scratch, one token at a time.  Here at f32, the
    port's decode logits against the reference's at every position, and
    against the port's own full-sequence forward (the ring sees exactly
    the last ``window`` positions)."""
    jcfg, cfg, jparams, params = _model(DANUBE, "f32", sliding_window=8)
    B, S = 1, 32
    tokens = _tokens(cfg, B, S, seed=9)
    full, _ = registry.forward(cfg, params, {"tokens": torch.tensor(tokens)})
    jc = jregistry.init_decode_caches(jcfg, B, cache_len=S)
    tc = registry.init_decode_caches(cfg, B, S, "cpu")
    assert tc["l0"]["k"].shape[2] == 8
    for i in range(S):
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                            "index": jnp.int32(i)}, jc)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tokens[:, i:i + 1]),
                          "index": i}, tc)
        assert _err(tl, jl) < TOL_F32, i
        assert float((tl[:, 0] - full[:, i]).abs().max()) < TOL_F32, i
    assert sorted(tc["l0"]["pos"][0, 0].tolist()) == list(range(S - 8, S))


@pytest.mark.parametrize("S", [21, 37])
def test_rolled_prefill_then_decode(S):
    """A prompt longer than the window, not a multiple of it: prefill keeps
    the last 16 keys rolled by S % 16 into their ring slots (the
    reference's roll path), with the engine's default cache (exactly the
    ring: no cache_len), then decodes across the next wrap."""
    jcfg, cfg, jparams, params = _model(DANUBE, "f32")
    tokens = _tokens(cfg, 2, S, seed=S)
    jl, jc = jregistry.prefill(jcfg, jparams,
                               {"tokens": jnp.asarray(tokens)})
    tl, tc = registry.prefill(cfg, params, {"tokens": torch.tensor(tokens)})
    assert _err(tl, jl) < TOL_F32
    pos = tc["l0"]["pos"][0, 0].numpy()
    assert pos.shape == (16,) and (pos % 16 == np.arange(16)).all()
    assert sorted(pos.tolist()) == list(range(S - 16, S))
    _live_slots_equal(tc, jc, "f32")
    for step in range(20):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tok),
                            "index": jnp.int32(S + step)}, jc)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tok),
                          "index": torch.full((2,), S + step)}, tc)
        assert _err(tl, jl) < TOL_F32, step
    _live_slots_equal(tc, jc, "f32")


def test_windowed_prefill_cache_sizes():
    """A prompt within the window keeps its S keys at slot = position: no
    padding by default, padded (pos = -1) to the ring when a cache_len of
    at least the window is asked for, as the reference pads it."""
    _, cfg, _, params = _model(DANUBE, "f32")
    p = tcommon.tree_index(params["layers"]["l0"]["attn"], 0)
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (1, 10, cfg.d_model)).astype(np.float32))
    for cache_len, slots in ((None, 10), (12, 12), (64, 16)):
        _, c = tattn.attn_apply(cfg, p, x, positions=torch.arange(10),
                                window=16, return_cache=True,
                                cache_len=cache_len)
        assert c["k"].shape[1] == slots
        assert c["pos"][0].tolist() == list(range(10)) + [-1] * (slots - 10)


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


ENGINE = dict(n_slots=4, cache_len=64, block_size=8)


def _engines(arch, paged_kv, prompt_lens, max_new):
    """The reference's and the port's continuous engines on one request
    set, each on its own virtual clock -> (jreqs, reqs, port engine)."""
    jcfg, cfg, jparams, params = _model(arch, "f32")
    spec = dict(n_requests=6, rate_rps=0.0, prompt_lens=prompt_lens,
                max_new_tokens=max_new, seed=5)
    jeng = JEngine(jcfg, jparams, clock=_clock(), paged=paged_kv, **ENGINE)
    jreqs = jeng.run(j_make_requests(
        JLoadSpec(vocab_size=jcfg.vocab_size, **spec)))
    eng = ContinuousEngine(cfg, params, clock=_clock(), paged=paged_kv,
                           device="cpu", **ENGINE)
    reqs = eng.run(make_requests(LoadSpec(vocab_size=cfg.vocab_size,
                                          **spec)))
    eng.scheduler.check()
    assert eng.kv.n_free == eng.kv.n_blocks
    assert list(eng.scheduler.admit_log) == list(jeng.scheduler.admit_log)
    return jreqs, reqs, eng


def test_dense_engine_serves_danube_like_the_reference():
    """Prompts within, at and past the window (16), decoded past it: the
    dense engine's greedy streams equal the reference's ContinuousEngine
    at f32, and the slot rings hold 16 positions."""
    jreqs, reqs, eng = _engines(DANUBE, False, (8, 16, 37), 20)
    assert [list(r.generated) for r in reqs] \
        == [list(r.generated) for r in jreqs]
    assert all(len(r.generated) == 20 for r in reqs)
    assert eng._caches["l0"]["k"].shape == (2, 4, 16, 2, 16)


def test_paged_engine_serves_command_r_like_the_reference():
    """Command-R+ (parallel block, tied embeddings) through the paged
    engine: greedy streams equal the reference's paged engine at f32."""
    jreqs, reqs, _ = _engines(COMMAND_R, True, (8, 16, 21), 6)
    assert [list(r.generated) for r in reqs] \
        == [list(r.generated) for r in jreqs]


@pytest.mark.parametrize("depth", [1, 2])
def test_command_r_paged_decode_step(depth):
    """insert_pages + paged_decode_step on Command-R+ smoke against the
    reference's, slots at ragged positions, one free slot on the trash
    page."""
    jcfg, cfg, jparams, params = _model(COMMAND_R, "f32")
    tokens = _tokens(cfg, 2, 24, seed=6)
    n_slots, cache_len, bs = 3, 32, 8
    n_pages = n_slots * (cache_len // bs) + 1
    trash = n_pages - 1
    lens = (24, 9)
    jpool = jpaged.init_kv_pool(jcfg, n_pages, bs)
    tpool = paged.init_kv_pool(cfg, n_pages, bs, "cpu")
    tables = np.full((n_slots, cache_len // bs), trash, np.int32)
    perm = np.random.default_rng(4).permutation(trash)
    used = 0
    for s, n in enumerate(lens):
        need = -(-(n + 3) // bs)
        tables[s, :need] = perm[used:used + need]
        used += need
        _, jc = jregistry.prefill(
            jcfg, jparams, {"tokens": jnp.asarray(tokens[s:s + 1, :n])},
            cache_len=cache_len)
        jpool = jpaged.insert_pages(jcfg, jpool, jc, jnp.asarray(tables[s]))
        _, tc = registry.prefill(
            cfg, params, {"tokens": torch.tensor(tokens[s:s + 1, :n])})
        tpool = paged.insert_pages(cfg, tpool, tc, torch.tensor(tables[s]))
    idx = np.asarray(lens + (0,), np.int32)
    tok = np.asarray([[5], [6], [0]], np.int32)
    for _ in range(3):
        jl, jpool = jpaged.paged_decode_step(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(idx), jpool,
            jnp.asarray(tables), buffer_depth=depth)
        tl, tpool = paged.paged_decode_step(
            cfg, params, torch.tensor(tok), torch.tensor(idx), tpool,
            torch.tensor(tables), buffer_depth=depth)
        assert _err(tl[:2], jl[:2]) < TOL_F32
        assert bool(torch.isfinite(tl).all())
        tok[:2] = np.asarray(jnp.argmax(jl[:2, 0], -1), np.int32)[:, None]
        idx[:2] += 1
    live = sorted(set(tables[:2].ravel().tolist()) - {trash})
    assert _err(tpool["l0"][:, live], np.asarray(jpool["l0"])[:, live]) \
        < TOL_F32


def test_cli_serves_danube_dense_and_refuses_it_paged(capsys):
    """``--arch h2o-danube-3-4b`` serves through the dense engine; with
    ``--paged`` the engine refuses it with the reference's error."""
    from repro_torch.launch import serve
    serve.main(["--arch", DANUBE, "--requests", "3", "--max-new", "4",
                "--prompt-lens", "8,24", "--cache-len", "32"], device="cpu")
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="keeps the dense path"):
        serve.main(["--arch", DANUBE, "--paged", "--requests", "2"],
                   device="cpu")
