"""The port's dense model against the JAX reference, on the CPU, at f32
(and one decode test at bf16).

Weights come from the reference's ``registry.init_params(cfg,
jax.random.key(0))`` turned to numpy and carried over by
``repro_torch.bridge.params_from_numpy``; tokens are made with numpy from
a seed.  Logits agree within 1e-4 (f32 sums taken in another order over
the smoke config's layers); single modules within 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import registry as jregistry
from repro.serve import paged as jpaged
from repro_torch import bridge, runtime
from repro_torch.configs import all_archs, smoke
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import encdec, registry, transformer
from repro_torch.serve import paged

TOL_LOGITS = 1e-4
TOL_MODULE = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.detach().float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke(j_all_archs()["olmo-1b"]),
                               dtype="float32")
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def test_config_copy_matches_reference():
    """The port's own copy of the config (and its smoke reduction) holds
    the reference's values field by field."""
    want = j_all_archs()["olmo-1b"]
    got = all_archs()["olmo-1b"]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke(got)) == dataclasses.asdict(j_smoke(want))
    assert (got.num_layers, got.d_model, got.num_heads, got.hd, got.d_ff,
            got.vocab_size, got.dtype) == (16, 2048, 16, 128, 8192, 50304,
                                           "bfloat16")


ARCHS = sorted(j_all_archs())
PUBLISHED_DIMS = {   # tests/test_configs.py's published dims
    # name: (layers, d_model, heads, kv, d_ff, vocab)
    "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
    "h2o-danube-3-4b": (24, 3840, 32, 8, 10240, 32000),
    "mistral-nemo-12b": (40, 5120, 32, 8, 14336, 131072),
    "olmo-1b": (16, 2048, 16, 16, 8192, 50304),
    "jamba-1.5-large-398b": (72, 8192, 64, 8, 24576, 65536),
    "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536),
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
    "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
    "whisper-base": (6, 512, 8, 8, 2048, 51865),
    "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
}


def test_the_port_registers_the_ten_archs():
    assert set(all_archs()) == set(j_all_archs()) == set(PUBLISHED_DIMS)


@pytest.mark.parametrize("name", ARCHS)
def test_config_copies_and_exact_dims(name):
    """Each copy holds the reference's config field by field (and its
    smoke reduction); the dims are the published ones
    (``tests/test_configs.py``)."""
    got, want = all_archs()[name], j_all_archs()[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(smoke(got)) == dataclasses.asdict(
        j_smoke(want))
    assert (got.num_layers, got.d_model, got.num_heads, got.num_kv_heads,
            got.d_ff, got.vocab_size) == PUBLISHED_DIMS[name]


@pytest.mark.parametrize("name", ARCHS)
def test_param_shapes_match_the_reference_tree(name):
    """At the published widths: the paths and shapes ``bridge`` expects
    are the reference's abstract tree's (nothing allocated)."""
    cfg = all_archs()[name]
    tree = jregistry.abstract_params(j_all_archs()[name])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert bridge.param_shapes(cfg) == want


def test_bridge_checks_the_tree(setup):
    _, cfg, jparams, params, _ = setup
    tree = _np_tree(jparams)
    assert params["layers"]["l0"]["attn"]["q"]["kernel"].shape == (2, 64, 64)
    assert params["embed"]["embedding"].dtype == torch.float32
    assert set(bridge.param_shapes(cfg)) == {
        path for path, _ in bridge.flatten(tree)}
    bad = dict(tree, embed={"embedding": tree["embed"]["embedding"][:-1]})
    with pytest.raises(ValueError, match="does not match"):
        bridge.params_from_numpy(cfg, bad, device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = registry.init_params(cfg, gen)
    assert {p: tuple(t.shape) for p, t in bridge.flatten(own)} \
        == bridge.param_shapes(cfg)
    full = bridge.param_shapes(all_archs()["olmo-1b"])
    n = sum(int(np.prod(s)) for s in full.values())
    assert 1.1e9 < n < 1.3e9             # OLMo-1B, tied embeddings


def test_bridge_default_device_is_the_card(setup, monkeypatch):
    _, cfg, jparams, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bridge.params_from_numpy(cfg, _np_tree(jparams))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "ln_nonparam"])
def test_norm_apply(norm, setup):
    jcfg, cfg = (dataclasses.replace(c, norm=norm) for c in setup[:2])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {}
    if norm != "ln_nonparam":
        p["scale"] = rng.standard_normal(64).astype(np.float32)
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    want = jcommon.norm_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = tcommon.norm_apply(cfg, {k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x))
    assert _err(got, want) < TOL_MODULE
    assert tcommon.norm_init(cfg, "cpu").keys() == p.keys()


@pytest.mark.parametrize("pos_shape", ["S", "S1"])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(2)
    if pos_shape == "S":          # full sequence: positions (S,)
        x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
        pos = np.arange(3, 10, dtype=np.int32)
    else:                         # batched decode: positions (S, 1)
        x = rng.standard_normal((5, 1, 4, 16)).astype(np.float32)
        pos = np.asarray([[0], [3], [17], [40], [63]], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tcommon.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0)
    assert _err(got, want) < TOL_MODULE


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp_apply(act, setup):
    jcfg, cfg = (dataclasses.replace(c, act=act) for c in setup[:2])
    jp = jmlp.mlp_init(jax.random.key(3), jcfg)
    p = tcommon.tree_map(torch.tensor, _np_tree(jp))
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jmlp.mlp_apply(jcfg, jp, jnp.asarray(x))
    assert _err(tmlp.mlp_apply(cfg, p, torch.tensor(x)), want) < TOL_MODULE
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = tmlp.mlp_init(gen, cfg)
    assert {k: v["kernel"].shape for k, v in own.items()} \
        == {k: v["kernel"].shape for k, v in p.items()}


@pytest.mark.parametrize("S", [16, 24, 37])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_attn_apply_and_prefill_cache(S, ref_impl, setup):
    """Prefill attention through the port's flash path against the
    reference's default chunked path and its Pallas flash kernel
    (interpret mode), with the cache it hands to decode."""
    jcfg, cfg, jparams, params, _ = setup
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["layers"]["l0"]["attn"])
    p = tcommon.tree_index(params["layers"]["l0"]["attn"], 0)
    x = np.random.default_rng(S).standard_normal((1, S, 64)).astype(
        np.float32)
    with jruntime.use_policy(attention_impl=ref_impl, pallas_interpret=True):
        want_y, want_c = jattn.attn_apply(
            jcfg, jp, jnp.asarray(x), positions=jnp.arange(S),
            return_cache=True, cache_len=40)
    got_y, got_c = tattn.attn_apply(
        cfg, p, torch.tensor(x), positions=torch.arange(S),
        return_cache=True, cache_len=40)
    assert _err(got_y, want_y) < TOL_MODULE
    assert got_c["k"].shape == (1, 40, 4, 16)
    assert _err(got_c["k"], want_c["k"]) < TOL_MODULE
    assert _err(got_c["v"], want_c["v"]) < TOL_MODULE
    assert (got_c["pos"][0].numpy() == np.asarray(want_c["pos"])).all()


def test_forward_logits(setup):
    jcfg, cfg, jparams, params, tokens = setup
    want, _ = jregistry.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = registry.forward(cfg, params, {"tokens": torch.tensor(tokens)})
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) < TOL_LOGITS
    with runtime.use_policy(attention_impl="torch"):
        again, _ = registry.forward(cfg, params,
                                    {"tokens": torch.tensor(tokens)})
    assert _err(again, want) < TOL_LOGITS


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_prefill_logits_and_caches(ref_impl, setup):
    jcfg, cfg, jparams, params, tokens = setup
    with jruntime.use_policy(attention_impl=ref_impl, pallas_interpret=True):
        want, want_c = jregistry.prefill(
            jcfg, jparams, {"tokens": jnp.asarray(tokens)}, cache_len=32)
    got, got_c = registry.prefill(cfg, params,
                                  {"tokens": torch.tensor(tokens)},
                                  cache_len=32)
    assert got.shape == (2, 1, cfg.vocab_size)
    assert _err(got, want) < TOL_LOGITS
    assert got_c["l0"]["k"].shape == (2, 2, 32, 4, 16)    # (G, B, L, Kv, hd)
    assert _err(got_c["l0"]["k"], want_c["l0"]["k"]) < TOL_LOGITS
    assert _err(got_c["l0"]["v"], want_c["l0"]["v"]) < TOL_LOGITS
    # default: a cache of exactly the prompt's length
    _, exact = registry.prefill(cfg, params, {"tokens": torch.tensor(tokens)})
    assert exact["l0"]["k"].shape[2] == tokens.shape[1]


def test_decode_step_logits(setup):
    """Three greedy decode steps after a prefill, the port's batched step
    (scalar and per-row index) against the reference's."""
    jcfg, cfg, jparams, params, tokens = setup
    S = tokens.shape[1]
    jl, jc = jregistry.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                               cache_len=32)
    tl, tc = registry.prefill(cfg, params, {"tokens": torch.tensor(tokens)},
                              cache_len=32)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tok),
                            "index": jnp.int32(S + step)}, jc)
        index = S + step if step % 2 else torch.full((2,), S + step)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tok), "index": index}, tc)
        assert tl.shape == (2, 1, cfg.vocab_size)
        assert _err(tl, jl) < TOL_LOGITS
    assert _err(tc["l0"]["k"], jc["l0"]["k"]) < TOL_LOGITS


def test_decode_step_bf16_dense_cache():
    """At bf16, three decode steps through the dense cache against the
    reference's, which keeps the attention scores f32 (``_gqa_scores``,
    ``preferred_element_type``).  The reference runs op by op
    (``jax.disable_jit``), so it rounds to bf16 after every operation as
    PyTorch does; under ``jit`` XLA keeps f32 between fused operations and
    the two differ by 1-2 bf16 spacings wherever they meet.  The MLP is
    ``relu2``: ``jax.nn.silu`` rounds ``x * sigmoid(x)`` twice where
    ``torch.nn.functional.silu`` rounds once.  The prefill takes the
    reference's XLA branch (``attention_impl="chunked"``), so both sides
    decode from the same cache.  The logits are then held within one bf16
    spacing at the largest logit's size: scores rounded to bf16 move
    them by 2-4 spacings."""
    jcfg = dataclasses.replace(j_smoke(j_all_archs()["olmo-1b"]),
                               act="relu2")
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), act="relu2")
    assert cfg.dtype == "bfloat16"
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    S = tokens.shape[1]
    with jax.disable_jit():
        jl, jc = jregistry.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(tokens)},
                                   cache_len=32)
    with runtime.use_policy(attention_impl="chunked"):
        tl, tc = registry.prefill(cfg, params,
                                  {"tokens": torch.tensor(tokens)},
                                  cache_len=32)
    assert tc["l0"]["k"].dtype == torch.bfloat16
    assert _err(tl, jl) == 0.0
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        with jax.disable_jit():
            jl, jc = jregistry.decode_step(
                jcfg, jparams, {"tokens": jnp.asarray(tok),
                                "index": jnp.int32(S + step)}, jc)
        index = S + step if step % 2 else torch.full((2,), S + step)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(tok), "index": index}, tc)
        top = float(np.max(np.abs(np.asarray(jl, np.float32))))
        spacing = 2.0 ** (int(np.floor(np.log2(top))) - 7)
        assert _err(tl, jl) < spacing, (step, _err(tl, jl), spacing)


def test_decode_step_per_slot_positions(setup):
    """Rows at different positions in one batched step equal the same
    rows decoded one by one (what the reference gets by vmapping)."""
    _, cfg, _, params, tokens = setup
    lens = (24, 9)
    caches = transformer.init_decode_caches(cfg, 2, 32, "cpu")
    singles = []
    for b, n in enumerate(lens):
        _, c = registry.prefill(cfg, params,
                                {"tokens": torch.tensor(tokens[b:b + 1, :n])},
                                cache_len=32)
        for key in caches:
            for leaf in ("k", "v", "pos"):
                caches[key][leaf][:, b] = c[key][leaf][:, 0]
        lg, _ = registry.decode_step(
            cfg, params, {"tokens": torch.tensor([[7 + b]]), "index": n}, c)
        singles.append(lg[0])
    got, _ = registry.decode_step(
        cfg, params, {"tokens": torch.tensor([[7], [8]]),
                      "index": torch.tensor(lens)}, caches)
    assert float((got - torch.stack(singles)).abs().max()) < TOL_MODULE


@pytest.mark.parametrize("depth", [1, 2])
def test_paged_decode_step_logits(depth, setup):
    """insert_pages + paged_decode_step against the reference's, slots at
    ragged positions, one free slot on the trash page."""
    jcfg, cfg, jparams, params, tokens = setup
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
    for step in range(3):
        jl, jpool = jpaged.paged_decode_step(
            jcfg, jparams, jnp.asarray(tok), jnp.asarray(idx), jpool,
            jnp.asarray(tables), buffer_depth=depth)
        tl, tpool = paged.paged_decode_step(
            cfg, params, torch.tensor(tok), torch.tensor(idx), tpool,
            torch.tensor(tables), buffer_depth=depth)
        assert tl.shape == (n_slots, 1, cfg.vocab_size)
        assert _err(tl[:2], jl[:2]) < TOL_LOGITS
        assert bool(torch.isfinite(tl).all())
        tok[:2] = np.asarray(jnp.argmax(jl[:2, 0], -1), np.int32)[:, None]
        idx[:2] += 1
    # the live pages hold the same K/V on both sides
    live = sorted(set(tables[:2].ravel().tolist()) - {trash})
    assert _err(tpool["l0"][:, live], np.asarray(jpool["l0"])[:, live]) \
        < TOL_LOGITS


def test_fuse_kv_and_pool_geometry(setup):
    jcfg, cfg = setup[:2]
    rng = np.random.default_rng(6)
    k = rng.standard_normal((3, 4, 16)).astype(np.float32)
    v = rng.standard_normal((3, 4, 16)).astype(np.float32)
    want = np.asarray(jpaged.fuse_kv(jnp.asarray(k), jnp.asarray(v)))
    got = paged.fuse_kv(torch.tensor(k), torch.tensor(v)).numpy()
    assert (got == want).all()
    assert paged.pool_geometry(cfg, 9, 8) == jpaged.pool_geometry(jcfg, 9, 8)
    full = all_archs()["olmo-1b"]
    geo = paged.pool_geometry(full, 2049, 16)
    assert geo["pool_bytes"] == 16 * 2049 * 16 * 32 * 128 * 2


FAMILY_ARCHS = {"moe": "moonshot-v1-16b-a3b", "hybrid": "jamba-1.5-large-398b",
                "encdec": "whisper-base", "vlm": "internvl2-26b",
                "ssm+experts": "rwkv6-7b"}


@pytest.mark.parametrize("family", ["moe", "hybrid", "encdec", "vlm",
                                    "ssm+experts"])
def test_other_families_name_the_later_slice(family):
    """Once refused as later slices, every family is ported now: each
    family's smoke config initialises and runs a forward (an ssm config
    with experts too, whose layers, as the reference's, take no expert).
    Their parity with the reference is ``tests/test_torch_archs.py``'s."""
    cfg = dataclasses.replace(smoke(all_archs()[FAMILY_ARCHS[family]]),
                              dtype="float32")
    if family == "ssm+experts":
        cfg = dataclasses.replace(cfg, num_experts=4)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = registry.init_params(cfg, gen)
    assert {p: tuple(t.shape) for p, t in bridge.flatten(params)} \
        == bridge.param_shapes(cfg)
    S = 8 + cfg.num_patches
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, 16, cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((1, cfg.num_patches, cfg.d_model))
    logits, aux = registry.forward(cfg, params, batch)
    assert logits.shape == (1, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert (float(aux["lb_loss"]) > 0) == (family in ("moe", "hybrid"))


def test_stacked_init_is_bit_identical_to_stacking_the_trees():
    """``stacked_init`` fills each stacked leaf as the trees are drawn; for
    the same generator it gives exactly what stacking the trees drawn one
    after another gives."""
    for name in ("jamba-1.5-large-398b", "moonshot-v1-16b-a3b",
                 "whisper-base"):
        cfg = smoke(all_archs()[name])

        def init(g):
            if cfg.family == "encdec":
                return encdec._dec_layer_init(g, cfg)
            return transformer._group_init(g, cfg)

        gen = torch.Generator(device="cpu")
        gen.manual_seed(3)
        got = tcommon.stacked_init(gen, 3, init)
        gen.manual_seed(3)
        want = tcommon.tree_stack([init(gen) for _ in range(3)])
        pairs = list(zip(bridge.flatten(got), bridge.flatten(want)))
        assert len(pairs) == len(list(bridge.flatten(want))) > 10
        for (pa, a), (pb, b) in pairs:
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


def test_sliding_window_cache_names_the_later_slice(setup):
    """The windowed forward, and the windowed prefill cache, which the
    ring layout now gives (it raised before the windowed configs were
    ported): a prompt past the window keeps its last ``window`` keys, each
    in ring slot position % window."""
    _, cfg, _, params, _ = setup
    p = tcommon.tree_index(params["layers"]["l0"]["attn"], 0)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (1, 10, 64)).astype(np.float32))
    y = tattn.attn_apply(cfg, p, x, positions=torch.arange(10), window=4)
    assert y.shape == (1, 10, 64)          # the windowed forward is ported
    y2, c = tattn.attn_apply(cfg, p, x, positions=torch.arange(10), window=4,
                             return_cache=True)
    assert torch.equal(y, y2)
    assert c["k"].shape == (1, 4, 4, 16)
    assert c["pos"][0].tolist() == [8, 9, 6, 7]
    _, full = tattn.attn_apply(cfg, p, x, positions=torch.arange(10),
                               return_cache=True)
    assert torch.equal(c["k"][:, [2, 3, 0, 1]], full["k"][:, 6:])
