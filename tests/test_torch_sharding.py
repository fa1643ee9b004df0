"""The ``model`` axis's placement: the sharding rules, the split of a
parameter tree, the meshes and the axis itself.

``parallel/sharding.py``'s tables are held equal to the reference's as
data, its ``spec_for_param`` to the reference's on every leaf of the four
dense smoke configs (where it splits by whole heads it may only replicate
what the reference splits), ``shard_params`` to that spec leaf by leaf,
and the shards put together give back the full tree.  A rank that draws
its weights from a seed (``bridge.init_shards``) holds the slices of the
one-rank draw bit for bit.  The axis's operations run emulated and over 4
gloo rank processes on the CPU, with the same results.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro.parallel import sharding as jsharding
from repro.serve import step as jstep
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import registry
from repro_torch.parallel import rank_bodies, sharding
from repro_torch.parallel.dist import run_ranks
from repro_torch.parallel.model_axis import ModelAxis

DENSE = ("olmo-1b", "mistral-nemo-12b", "h2o-danube-3-4b",
         "command-r-plus-104b")


def _cfg(arch):
    return smoke(all_archs()[arch])


def _params(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return registry.init_params(cfg, gen)


def test_rule_tables_are_the_reference_tables():
    assert sharding.PARAM_RULES == jsharding.PARAM_RULES
    assert sharding.CACHE_RULES == jstep._CACHE_RULES
    for mp, sp in itertools.product((False, True), repeat=2):
        assert sharding.train_rules(mp, sp) == jsharding.train_rules(mp, sp)
        assert sharding.decode_rules(mp, sp) == jsharding.decode_rules(mp, sp)


def _reference_dim(path, shape, n):
    """The dim the reference's ``spec_for_param`` splits over ``model``
    on a (1, n) mesh (a stand-in mesh: the spec reads only its shape)."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": n})
    ctx = jsharding.ShardingCtx(mesh, jsharding.decode_rules(False, False))
    spec = jsharding.spec_for_param(path, shape, ctx)
    dims = [d for d, a in enumerate(spec)
            if a == "model" or (isinstance(a, tuple) and "model" in a)]
    return dims[0] if dims else None


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_spec_for_param_is_the_reference_spec(arch, n):
    """Leaf by leaf the reference's split; by whole heads, a ``k`` / ``v``
    kernel whose kv heads the axis does not divide is replicated (the
    reference's compiler splits inside a head there)."""
    cfg = _cfg(arch)
    heads = sharding.head_counts(cfg)
    split = 0
    for path, shape in bridge.param_shapes(cfg).items():
        want = _reference_dim(path, shape, n)
        assert sharding.spec_for_param(path, shape, n) == want, path
        got = sharding.spec_for_param(path, shape, n, heads)
        if got != want:
            assert got is None and path.endswith(("k/kernel", "v/kernel")) \
                and cfg.num_kv_heads % n, path
        split += got is not None
    assert split >= 6          # embedding, q, o, wi, wg, wo at least


def _unshard(shards, n, shapes, heads):
    """The full tree back from all ``n`` ranks' slices: split leaves
    concatenated along their dim, replicated ones taken from rank 0."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        path = "/".join(prefix)
        dim = sharding.spec_for_param(path, shapes[path], n, heads)
        return tree[0] if dim is None else torch.cat(list(tree), dim=dim)
    return walk(shards, ())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", DENSE)
def test_shard_params_splits_by_the_spec_and_puts_back(arch, n):
    cfg = _cfg(arch)
    heads = sharding.head_counts(cfg)
    full = _params(cfg)
    shapes = bridge.param_shapes(cfg)
    shards = sharding.shard_params(full, n, range(n), heads)
    for path, leaf in bridge.flatten(shards):
        whole = dict(bridge.flatten(full))[path]
        dim = sharding.spec_for_param(path, shapes[path], n, heads)
        assert leaf.shape[0] == n
        for r in range(n):
            want = whole if dim is None else whole.chunk(n, dim)[r]
            assert torch.equal(leaf[r], want), (path, r)
    back = _unshard(shards, n, shapes, heads)
    assert [p for p, _ in bridge.flatten(back)] \
        == [p for p, _ in bridge.flatten(full)]
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(bridge.flatten(back), bridge.flatten(full)))


@pytest.mark.parametrize("held", [(0, 1, 2, 3), (2,)])
@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-nemo-12b"])
def test_a_rank_draws_its_slices_of_the_one_rank_draw(arch, held):
    cfg = _cfg(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = bridge.init_shards(cfg, gen, 4, held)
    want = sharding.shard_params(_params(cfg), 4, held,
                                 sharding.head_counts(cfg))
    assert (got.n, got.held) == (4, held)
    a, b = list(bridge.flatten(got)), list(bridge.flatten(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_meshes():
    mesh = make_host_mesh(1, 4)
    assert mesh.shape == {"data": 1, "model": 4} and mesh.tp_size == 4
    assert mesh.size == 4 and mesh.axis_names == ("data", "model")
    assert isinstance(mesh.axis, ModelAxis) and mesh.axis.n == 4
    assert not mesh.distributed and mesh.leading().lead
    assert make_mesh((2,), ("model",)).shape == {"data": 1, "model": 2}
    # a data axis and a pod axis above the mesh build (mesh training)
    mesh = make_host_mesh(2, 2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.dp_size == 2
    assert mesh.data.n == 2 and mesh.axis.n == 2 and mesh.pod is None
    pm = make_mesh((2, 2), ("pod", "model"))
    assert pm.shape == {"pod": 2, "data": 1, "model": 2} and pm.pod.n == 2
    with pytest.raises(ValueError, match="axes"):
        make_mesh((2, 2), ("model", "pod"))
    with pytest.raises(ValueError, match="axes"):
        make_mesh((2, 2), ("stage", "model"))
    with pytest.raises(ValueError, match="sizes"):
        make_mesh((1, 0), ("data", "model"))


def _axis_ops_emulated(x):
    axis = ModelAxis(x.shape[0])
    t = torch.from_numpy(x)
    out = {"psum": axis.psum(t).numpy(),
           "psum_bf16": axis.psum(t.bfloat16()).float().numpy(),
           "gather": axis.gather(t).numpy()}
    return out, dict(axis.exchanges)


def test_model_axis_emulated_and_over_four_ranks():
    """``psum`` and ``gather`` along the last dim, emulated and over 4
    gloo rank processes: the same values (f32 exactly; bf16 summed in f32
    and rounded once on both), the same per-kind counts, rank 0's object
    on every rank."""
    x = np.random.default_rng(0).standard_normal((4, 3, 5)).astype(np.float32)
    want, counts = _axis_ops_emulated(x)
    assert np.array_equal(want["psum"][1], x.sum(0))
    assert np.array_equal(want["gather"], np.concatenate(list(x), axis=-1))
    assert counts == {"all_reduce": 2, "all_gather": 1}
    got = run_ranks(rank_bodies.model_axis_ops, 4, backend="gloo",
                    device="cpu", args=(x,), timeout_s=240)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["psum"][0], want["psum"][r],
                                   rtol=1e-6, atol=1e-6)
        assert np.array_equal(res["psum_bf16"][0], want["psum_bf16"][r])
        assert np.array_equal(res["gather"], want["gather"])
        assert res["object"] == {"from": 0}
        assert res["exchanges"] == counts
    with pytest.raises(ValueError, match="lead with 4"):
        ModelAxis(4).psum(torch.zeros(3, 2))
