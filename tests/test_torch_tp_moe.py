"""Tensor-parallel serving of the moe family against the reference's
single-device functions and engine, on the CPU.

The reference's weights (bridged through numpy) go to the reference at
one device and, split by ``parallel/sharding.shard_params``, to the port
at 2 and 4 ranks of an emulated ``model`` axis and, for the engine, over
4 gloo rank processes.  At f32, for the f32 smoke Moonlight (4 experts
top-2 and a shared expert) and Qwen3-MoE (GQA):

* ``forward``, ``prefill`` and 3 decode steps within 2e-5 of the
  reference's (``TOL_F32``: the ranks' partial sums add in another order,
  never bit for bit) and of the port's at one device, the aux losses
  within 1e-6 (relative, past 1) of the reference's; the MoE layer alone
  (``moe.moe_parts`` summed over the ranks) within 2e-5 of the
  reference's ``moe_apply``;
* expert parallelism keeps the one-device routing: at a decode step of 8
  slots with a capacity of one slot an expert, the same expert ids, slots
  and drops as tp 1 in every layer;
* the decode tick's exchanges equal to ``registry.decode_exchanges`` (the
  dense schedule: ``2 L + 1`` all-reduces and one all-gather);
* the engines' burst streams and admission logs, dense and paged, equal
  to the reference's single-device dense engine at tp 1/2/4, and the
  paged burst over 4 rank processes.  The reference's engine decodes a
  slot at a time (a vmapped batch-1 step: each slot's token a group of
  its own) where the port's decode groups the slots, so their capacity
  drops differ by design; the engine cases run at a capacity factor
  (``NO_DROPS``) at which no assignment is dropped either way (the
  routing case above holds the drops), and against the reference's dense
  engine, as its paged engine fails on an MoE arch ("Attempt to donate
  the same buffer twice").

The helpers here serve ``tests/test_torch_tp_ssm.py`` and
``tests/test_torch_tp_encdec_vlm.py`` too.  None starts a reference
subprocess: the reference runs in this process on one device.
"""
import dataclasses

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
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.models import moe, registry
from repro_torch.parallel import rank_bodies, sharding
from repro_torch.parallel.dist import run_ranks
from repro_torch.parallel.model_axis import ModelAxis
from repro_torch.serve import ranks
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.loadgen import LoadSpec, make_requests

TOL_F32 = 2e-5
TOL_AUX = 1e-6
# whole f32 smoke models of the families whose one-device port differs
# from the reference by more than 2e-5 already (RWKV-6's chunked scan,
# Mamba's stepped scan): tests/test_torch_rwkv.py's and
# tests/test_torch_families.py's whole-model tolerance
TOL_LOGITS = 1e-4
ENGINE = dict(n_slots=4, cache_len=64, block_size=8)
SPEC = dict(n_requests=6, rate_rps=0.0, prompt_lens=(8, 16),
            max_new_tokens=6, seed=3)
MOE = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b")
NO_DROPS = dict(capacity_factor=8.0)
# a Jamba with one attention layer in each group of 4 (the smoke Jamba has
# none): tests/test_torch_archs.py's
JAMBA_ATTN = dict(layer_group=4, attn_period=4, num_layers=8)

_MODELS: dict = {}


def model(name: str, **extra):
    """(jcfg, cfg, jparams, numpy tree) of the f32 smoke config ``name``
    (``jamba-with-attention``: ``JAMBA_ATTN``) with ``extra`` changes,
    drawn once by the reference."""
    key = (name, tuple(sorted(extra.items())))
    if key not in _MODELS:
        arch, change = name, dict(extra)
        if name == "jamba-with-attention":
            arch, change = "jamba-1.5-large-398b", dict(JAMBA_ATTN, **extra)
        jcfg = dataclasses.replace(j_smoke(j_all_archs()[arch]),
                                   dtype="float32", **change)
        cfg = dataclasses.replace(smoke(all_archs()[arch]), dtype="float32",
                                  **change)
        tree = jax.tree_util.tree_map(
            np.asarray, jregistry.init_params(jcfg, jax.random.key(0)))
        _MODELS[key] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray,
                                                          tree), tree)
    return _MODELS[key]


def shards(cfg, tree, n):
    return bridge.shards_from_numpy(cfg, tree, n, range(n), device="cpu")


def err(got, want) -> float:
    return float(np.max(np.abs(got.detach().float().numpy()
                               - np.asarray(want, np.float32))))


def extras(cfg, batch: int = 2) -> dict:
    """The batch's frames or patches beside the tokens, numpy from a
    seed."""
    rng = np.random.default_rng(5)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (batch, 16, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (batch, 8, cfg.d_model)).astype(np.float32)}
    return {}


_ONE_DEVICE: dict = {}


def one_device(name: str, seq: int) -> dict:
    """The reference's and the port's one-device ``forward``, ``prefill``
    and 3 greedy decode steps of ``name`` on seeded inputs (made once a
    model and length: each tp holds against the same ones)."""
    key = (name, seq)
    if key in _ONE_DEVICE:
        return _ONE_DEVICE[key]
    jcfg, cfg, jparams, tree = model(name)
    one = bridge.params_from_numpy(cfg, tree, device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, seq)).astype(np.int32)
    more = extras(cfg)
    jb = {"tokens": jnp.asarray(tokens),
          **{k: jnp.asarray(v) for k, v in more.items()}}
    tb = {"tokens": torch.tensor(tokens),
          **{k: torch.tensor(v) for k, v in more.items()}}
    out = {"batch": tb, "base": seq + (8 if cfg.family == "vlm" else 0)}
    out["forward"], out["aux"] = jregistry.forward(jcfg, jparams, jb)
    out["forward_one"] = registry.forward(cfg, one, tb)[0]
    cache_len = out["base"] + 8
    jl, jc = jregistry.prefill(jcfg, jparams, jb, cache_len=cache_len)
    ol, oc = registry.prefill(cfg, one, tb, cache_len=cache_len)
    out["steps"] = [(None, jl, ol)]
    for s in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(tok),
                            "index": jnp.int32(out["base"] + s)}, jc)
        ol, oc = registry.decode_step(
            cfg, one, {"tokens": torch.tensor(tok),
                       "index": out["base"] + s}, oc)
        out["steps"].append((tok, jl, ol))
    _ONE_DEVICE[key] = out
    return out


def hold_functions(name: str, n: int, seq: int = 24,
                   tol_ref: float = TOL_F32) -> dict:
    """``forward``, ``prefill`` and 3 decode steps of ``name`` at emulated
    tp ``n`` against the reference's at one device, within ``tol_ref``,
    and against the port's at one device within ``TOL_F32`` (what the
    split itself adds); returns the port's last caches and each decode
    tick's exchanges."""
    _, cfg, _, tree = model(name)
    ref = one_device(name, seq)
    axis = ModelAxis(n)
    sh = shards(cfg, tree, n)
    tb, base = ref["batch"], ref["base"]
    want = ref["forward"]
    got, aux = registry.forward(cfg, sh, tb, axis=axis)
    assert got.shape == want.shape and err(got, want) <= tol_ref
    assert err(got, ref["forward_one"]) <= TOL_F32
    for k in ("lb_loss", "z_loss"):       # f32 sums over the layers
        want_k = float(ref["aux"][k])
        assert abs(float(aux[k]) - want_k) \
            <= TOL_AUX * max(1.0, abs(want_k)), k
    _, jl, ol = ref["steps"][0]
    tl, tc = registry.prefill(cfg, sh, tb, cache_len=base + 8, axis=axis)
    assert err(tl, jl) <= tol_ref and err(tl, ol.numpy()) <= TOL_F32
    ticks = []
    for s, (tok, jl, ol) in enumerate(ref["steps"][1:]):
        before = dict(axis.exchanges)
        tl, tc = registry.decode_step(
            cfg, sh, {"tokens": torch.tensor(tok), "index": base + s}, tc,
            axis=axis)
        ticks.append({k.replace("_", "-"): v - before.get(k, 0)
                      for k, v in axis.exchanges.items()
                      if v - before.get(k, 0)})
        assert err(tl, jl) <= tol_ref and err(tl, ol.numpy()) <= TOL_F32, s
    assert all(t == registry.decode_exchanges(cfg, n) for t in ticks), ticks
    return {"caches": tc, "ticks": ticks}


def _engine_extra(name: str) -> dict:
    _, cfg, _, _ = model(name)
    return NO_DROPS if cfg.num_experts else {}


def reference_burst(name: str, paged: bool):
    """The reference's single-device engine (its dense engine for an MoE
    arch, module docstring)."""
    jcfg, _, jparams, _ = model(name, **_engine_extra(name))
    eng = JEngine(jcfg, jparams, paged=paged and not jcfg.num_experts,
                  **ENGINE)
    reqs = eng.generate(j_make_requests(JLoadSpec(vocab_size=jcfg.vocab_size,
                                                  **SPEC)))
    return rank_bodies.streams(reqs), list(eng.scheduler.admit_log)


def hold_engines(name: str, paged: bool) -> None:
    """The burst at tp 1/2/4: the reference's streams and admission log,
    the pool recycled, the tick's exchanges as derived."""
    want, want_log = reference_burst(name, paged)
    _, cfg, _, tree = model(name, **_engine_extra(name))
    params = bridge.params_from_numpy(cfg, tree, device="cpu")
    for tp in (1, 2, 4):
        eng = ContinuousEngine(cfg, params, paged=paged, tp_size=tp,
                               device="cpu", **ENGINE)
        reqs = eng.generate(make_requests(
            LoadSpec(vocab_size=cfg.vocab_size, **SPEC)))
        assert rank_bodies.streams(reqs) == want, tp
        assert list(eng.scheduler.admit_log) == want_log, tp
        eng.scheduler.check()
        assert eng.kv.n_free == eng.kv.n_blocks and eng.tp_size == tp
        assert eng.cells.decode_collective_counts(eng.params) \
            == registry.decode_exchanges(cfg, tp), tp


def hold_ranked_burst(name: str, paged: bool) -> None:
    """The burst over 4 gloo rank processes: the reference's streams and
    admission log, and every rank made the same exchanges."""
    _, cfg, _, tree = model(name, **_engine_extra(name))
    want, want_log = reference_burst(name, paged)
    kw = dict(ENGINE, paged=paged, device="cpu")
    reqs = make_requests(LoadSpec(vocab_size=cfg.vocab_size, **SPEC))
    out = run_ranks(ranks.serve_rank, 4, backend="gloo", device="cpu",
                    args=(cfg, ("numpy", tree), rank_bodies.burst,
                          (kw, reqs)), timeout_s=300)
    res = out[0]["result"]
    assert res["streams"] == want and res["admit_log"] == want_log
    assert res["pool_recycled"]
    assert res["collectives"] == registry.decode_exchanges(cfg, 4)
    assert all(o["exchanges"] == out[0]["exchanges"] for o in out)
    assert all(o["calls"] > 0 for o in out[1:])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_moe_functions_at_tp_match_the_reference(arch, n):
    out = hold_functions(arch, n)
    # each rank's pool-free caches hold its local kv heads, ranks leading
    _, cfg, _, _ = model(arch)
    k = out["caches"]["l0"]["k"]
    assert k.shape[0] == n and k.shape[-2] == max(1, cfg.num_kv_heads // n)
    assert out["ticks"][0] == {"all-reduce": 2 * cfg.num_layers + 1,
                               "all-gather": 1}


@pytest.mark.parametrize("n", [2, 4])
def test_the_moe_layer_over_ranks_is_the_reference_layer(n):
    """``moe.moe_parts`` (each rank's experts on its columns of the one
    dispatch, its share of the shared MLP) summed over the ranks against
    the reference's ``moe_apply`` of the whole layer, and the aux losses
    from the replicated router."""
    import jax
    from repro.models import moe as jmoe
    jcfg, cfg, _, _ = model("moonshot-v1-16b-a3b")
    jp = jmoe.moe_init(jax.random.key(1), jcfg)
    full = bridge.common.tree_map(torch.tensor,
                                  jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(1).standard_normal((2, 48, 64)).astype(
        np.float32)
    want_y, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    heads = sharding.head_counts(cfg)
    ranked = sharding.shard_params({"layers": {"l0": {"moe": full}}}, n,
                                   range(n), heads)
    ranks_p = [bridge.common.tree_index(ranked["layers"]["l0"]["moe"], j)
               for j in range(n)]
    axis = ModelAxis(n)
    parts, aux, bias = moe.moe_parts(cfg, ranks_p, torch.tensor(x),
                                     axis.copy(torch.tensor(x)), axis)
    assert bias is None and len(parts) == n
    assert err(sum(parts), want_y) <= TOL_F32
    for k in ("lb_loss", "z_loss"):
        assert abs(float(aux[k]) - float(want_aux[k])) <= TOL_AUX, k


def _routes(cfg, params, tp: int) -> list:
    """Every MoE layer's (expert ids, slots, capacity) at one decode step
    of 8 slots at tp ``tp`` (the router's decisions, recorded)."""
    seen = []
    real = moe.routing

    def record(cfg_, p, x):
        r = real(cfg_, p, x)
        seen.append((r["idx"].clone(), r["slot"].clone(), r["C"]))
        return r
    axis = None if tp == 1 else ModelAxis(tp)
    sh = params if tp == 1 else sharding.shard_params(
        params, tp, range(tp), sharding.head_counts(cfg))
    caches = registry.init_decode_caches(cfg, 8, 32, "cpu", axis=axis)
    tokens = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(8, 1)), dtype=torch.int32)
    moe.routing = record
    try:
        registry.decode_step(cfg, sh, {"tokens": tokens,
                                       "index": torch.arange(8)},
                             caches, axis=axis)
    finally:
        moe.routing = real
    return seen


@pytest.mark.parametrize("arch", MOE)
def test_expert_parallelism_keeps_the_routing_and_the_drops(arch):
    """At a decode step of 8 slots with one slot an expert (capacity
    factor 0.25: ``C = max(1, int(8 * 2 / 4 * 0.25)) = 1``), tp 2 and 4
    route every layer's tokens as tp 1 does — the same expert ids, slots
    and drops (``tests/test_torch_families.py`` holds tp 1's against the
    reference's)."""
    _, cfg, _, tree = model(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    params = bridge.params_from_numpy(cfg, tree, device="cpu")
    one = _routes(cfg, params, 1)
    assert len(one) == cfg.num_layers and one[0][2] == 1
    assert sum(int((s >= c).sum()) for _, s, c in one) > 0   # drops
    for tp in (2, 4):
        got = _routes(cfg, params, tp)
        assert len(got) == len(one)
        for (i, s, c), (wi, ws, wc) in zip(got, one):
            assert c == wc and torch.equal(i, wi) and torch.equal(s, ws)


@pytest.mark.parametrize("paged", [True, False])
def test_moe_engines_serve_the_reference_streams(paged):
    hold_engines("moonshot-v1-16b-a3b", paged)


def test_moe_rank_processes_serve_the_reference_streams():
    hold_ranked_burst("moonshot-v1-16b-a3b", True)


def _unshard(ranks: list, dim: int, parts: int) -> torch.Tensor:
    """The whole leaf back from every rank's slice, each holding its share
    of each of ``parts`` fused halves."""
    halves = [r.chunk(parts, dim=dim) for r in ranks]
    return torch.cat([h[p] for p in range(parts) for h in halves], dim=dim)


@pytest.mark.parametrize("arch", MOE + ("rwkv6-7b", "jamba-1.5-large-398b",
                                        "whisper-base", "internvl2-26b"))
def test_every_family_draws_its_slices_of_the_one_rank_draw(arch):
    """``bridge.init_shards`` draws a rank's slices leaf by leaf in
    ``init_params``' order: bit-equal to slicing the one-rank draw, for
    held ranks (1, 3) of 4; the full tree comes back from all ranks'
    slices (the Mamba ``in_proj`` by its halves)."""
    cfg = dataclasses.replace(smoke(all_archs()[arch]), dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    full = registry.init_params(cfg, gen)
    gen.manual_seed(0)
    got = bridge.init_shards(cfg, gen, 4, (1, 3))
    want = sharding.shard_params(full, 4, (1, 3), sharding.head_counts(cfg))
    a, b = list(bridge.flatten(got)), list(bridge.flatten(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    every = sharding.shard_params(full, 4, range(4),
                                  sharding.head_counts(cfg))
    shapes = bridge.param_shapes(cfg)
    for path, leaf in bridge.flatten(every):
        dim = sharding.spec_for_param(path, shapes[path], 4,
                                      sharding.head_counts(cfg))
        back = leaf[0] if dim is None else _unshard(
            list(leaf), dim, sharding.fused_parts(path))
        assert torch.equal(back, dict(bridge.flatten(full))[path]), path
