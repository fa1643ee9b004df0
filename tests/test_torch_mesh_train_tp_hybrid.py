"""Training the hybrid family (Jamba) over a ``model`` axis, against the
JAX package, on the CPU.

Jamba's f32 smoke model, 3 steps on ``synth_batch``: as the reference's
smoke config (groups of 2 Mamba layers, MoE on the second: no attention
layer) and as ``+attn`` (groups of 4, the last an attention layer,
``tests/test_torch_archs.py``'s ``JAMBA_ATTN``), both at ``(data,
model)`` ``(2, 2)``, stock; and the smoke config on ``("pod", "data",
"model")`` ``(2, 1, 2)`` under ``int8_ring`` with 64-KiB buckets
(``tests/test_torch_mesh_train.py``'s ``CASES``).  Each runs emulated in
this process and over one gloo group of 4 rank processes, against the
reference's ``jit_train_step`` on 4 forced host devices (one JAX
subprocess for the module, running while the port's runs do).  The
loss, the gradient norm and the parameters are held by that module's
``_hold`` and tolerances; the load balance and z-loss by the loss's
(``tests/test_torch_mesh_train_tp_families.py``'s ``_hold_aux``).
Every axis has two ranks, so the ranked parameters are bit-equal to the
emulated ones.

**The Mamba scan's f32 noise.**  The port steps the selective scan
sequentially where the reference runs ``jax.lax.associative_scan``
(``models/mamba.py``): the same recurrence, its products in another
order.  The first-step gradients then differ by up to 1.11e-5 of a
leaf's largest element (``in_proj`` of the second layer, measured when
this test was written; 3.6e-6 with the attention layer), where the
dense family's sit within ~1e-7 relative.  So ``GRAD_BOUND`` is 5e-5
(4.5x the measured, the moe family's margin), and after the first step an
element whose reference gradient is below ``ZERO`` (1e-6) of the whole
tree's largest counts as within rounding of zero (``_hold``'s
``floor``): there that noise is a few percent of the element, and
AdamW's first update ``g / (|g| + eps)`` moves it by up to ``2 lr``
anyway (one element of ``in_proj`` at 1.1e-5 of its leaf's largest,
7e-7 of the tree's, moved 0.033 ``lr`` apart when this was written).

**Under ``int8_ring``** each ``(data, model)`` rank packs its own
shards, a class of leaves at a time (``train/step.reduction_classes``),
where the reference packs the pod's whole leaves; a bucket row
quantizes with the largest value it holds.  Jamba's ``A_log`` and
``dt_proj`` gradients are 3e-4 and 1e-4 of the tree's largest (the
embedding's), so in a row beside larger leaves every element rounds to
zero on one side and not on the other: the element moves by ``lr`` on
one side only, whatever its share of its own leaf.  So an element is
resolved where its gradient is ``RESOLVED`` (8 int8 steps) of the tree's
largest too, which bounds any row's scale on either side (``floor``);
below, the loose bound (``2.2 lr`` a step).  After a reduction the loss
and the gradient norm keep ``RING_TOL`` (the moe and ssm families'), and
every element the loose bound, as there.

**Planted faults.**  A contiguous ``model`` split of the fused
``mamba/in_proj`` kernel gives rank 0 of 2 all of ``x`` and none of
``z``: the first step's loss is far off the reference's.  The layout
checks hold the fused parts and whole experts and heads.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_mesh_train as base
import test_torch_mesh_train_tp_families as fam
from repro_torch import bridge
from repro_torch.configs import all_archs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common, transformer
from repro_torch.parallel import rank_bodies, sharding
from repro_torch.parallel.mesh_tree import MeshTree

HERE = ("jamba_2x2", "jamba_attn_2x2", "jamba_ring_2x1x2")
STOCK = tuple(c for c in HERE if base.CASES[c][3] == "stock")
GRAD_BOUND = 5e-5
ZERO = 1e-6


def _floor(name: str) -> float:
    """``_hold``'s ``floor`` for the case (module docstring)."""
    return ZERO if base.CASES[name][3] == "stock" else base.RESOLVED


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return base.start_reference(tmp_path_factory, HERE)


@pytest.fixture(scope="module")
def ranked(started):
    with base.one_thread():
        return base.run_ranked(HERE, grads=STOCK)


@pytest.fixture(scope="module")
def emulated(started):
    with base.one_thread():
        return {c: rank_bodies.mesh_train(None, *base._case_args(c),
                                          c in STOCK) for c in HERE}


@pytest.fixture(scope="module")
def reference(started, ranked, emulated):
    # the port's runs first: the reference's subprocess runs meanwhile
    return base.finish_reference(started)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_mesh_step_matches_the_reference(name, at, reference,
                                                  emulated):
    base._hold(emulated[name], reference, name, at, fam.RING_TOL,
               fam._resolved(at), _floor(name))
    fam._hold_aux(emulated[name], reference, name, at)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                ranked, emulated):
    """Rank 0 against the reference, every rank's loss and gradient norm
    equal to rank 0's (and its aux losses on the ranks of rank 0's pod),
    and the gathered parameters bit-equal to the emulated mesh's."""
    runs = ranked[name]
    base._hold(runs[0], reference, name, at, fam.RING_TOL,
               fam._resolved(at), _floor(name))
    fam._hold_aux(runs[0], reference, name, at)
    shape, axes = base.CASES[name][1:3]
    per_pod = int(np.prod(shape)) // (shape[0] if axes[0] == "pod" else 1)
    for r, run in enumerate(runs):
        got, want = run["steps"][at], runs[0]["steps"][at]
        keys = ("loss", "grad_norm") + (("lb_loss", "z_loss")
                                        if r < per_pod else ())
        for k in keys:
            assert got[k] == want[k], (r, k)
    emu = emulated[name]["steps"][at]
    for path, t in runs[0]["steps"][at]["params"].items():
        assert np.array_equal(t, emu["params"][path]), path


@pytest.mark.parametrize("form", ["emulated", "ranked"])
@pytest.mark.parametrize("name", STOCK)
def test_first_step_gradients_leaf_by_leaf(name, form, reference, ranked,
                                           emulated):
    """Every leaf's first-step gradient, gathered over the mesh, within
    ``GRAD_BOUND`` of its largest element from the reference's (module
    docstring); over ranks, rank 0's."""
    run = emulated[name] if form == "emulated" else ranked[name][0]
    worst, path = fam._worst_grad(run["grads"], reference, name)
    assert worst <= GRAD_BOUND, (path, worst)


def test_a_contiguous_split_of_the_fused_leaf_would_fail(reference,
                                                          monkeypatch):
    """With ``sharding.FUSED`` emptied, the mesh splits ``mamba/in_proj``
    end to end (rank 0 all of ``x``, rank 1 all of ``z``): the first
    step's loss is far off the reference's, which the fused split holds
    within 1e-5 (``test_emulated_mesh_step_matches_the_reference``)."""
    name = "jamba_2x2"
    monkeypatch.setattr(sharding, "FUSED", {})
    args = list(base._case_args(name))
    args[4], args[8] = 1, (1,)              # one step, recorded
    with base.one_thread():
        run = rank_bodies.mesh_train(None, *args)
    want = float(reference[f"{name}/1/loss"])
    assert abs(run["steps"][1]["loss"] - want) > 100 * 1e-5


@pytest.mark.parametrize("name", HERE)
def test_exchanges_a_step_are_the_derived_counts(name, ranked):
    """Over the ranks the model axis makes, per step, the exchanges
    ``transformer.train_exchanges`` derives (a Mamba layer three regions,
    an attention layer two, the MoE's gates a copy), one all-reduce for
    the gradient norm, and one all-gather a model-split leaf a recorded
    step."""
    fam.test_exchanges_a_step_are_the_derived_counts(name, ranked)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "jamba-1.5-large-398b+attn"])
def test_the_derived_counts_follow_the_layers(arch):
    """``train_exchanges`` for Jamba at published width and at the smoke
    width with attention, counted from the layer positions: 3 regions a
    Mamba layer, 2 an attention layer (a region: an entry copy's
    backward all-reduce and an exit's forward one), a copy a MoE layer's
    gates, the embedding and the vocab-parallel loss 5 where the axis
    splits the vocabulary; remat replays every region's forward."""
    # published width (groups of 8, remat) and the smoke width (no remat)
    cfg = base._cfgs(arch)[1] if "+" in arch else all_archs()[arch]
    G, layers = cfg.num_groups(), range(cfg.layer_group)
    attn = sum(cfg.is_attn_layer(l) for l in layers)
    regions = G * (2 * attn + 3 * (cfg.layer_group - attn))
    gates = G * sum(cfg.is_moe_layer(l) for l in layers)
    for remat in (False, True):
        got = transformer.train_exchanges(cfg, 2, sequence_parallel=False,
                                          remat=remat)
        replay = regions if remat and cfg.remat != "none" else 0
        assert got == {"all_reduce": 2 * regions + replay + gates + 5}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_the_layout_keeps_the_fused_parts(shape):
    """At published width the mesh splits ``mamba/in_proj`` over
    ``model`` by its two parts, each rank ``[x_r | z_r]`` as serving's
    ``sharding.slice_leaf(parts=2)``, gathered back in the leaf's order;
    the experts whole, the attention heads whole; no leaf a rank reads
    on its own (no bias), and the fused leaf in the reduction class of
    the axes that split it."""
    from repro_torch.train import step as tstep
    cfg = all_archs()["jamba-1.5-large-398b"]
    mesh = make_mesh(shape, ("data", "model"))
    flat = dict(bridge.flatten(bridge.mesh_specs(cfg, mesh)))
    sizes = {"data": shape[0], "model": shape[1]}
    spec = flat["layers/l0/mamba/in_proj/kernel"]
    assert (spec.model, spec.parts) == (2, 2)
    assert spec.data == (1 if shape[0] > 1 else None)
    for w in ("wi", "wg", "wo"):
        s = flat[f"layers/l1/moe/{w}/kernel"]
        assert s.model == 1 and s.local(sizes)[1] == cfg.num_experts \
            // shape[1], w
    attn = [l for l in range(cfg.layer_group) if cfg.is_attn_layer(l)][0]
    for w, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads)):
        s = flat[f"layers/l{attn}/attn/{w}/kernel"]
        assert s.local(sizes)[2] == heads // shape[1] * cfg.hd, w
    assert transformer.copied_leaves(cfg, shape[1]) == []
    leaves = common.tree_leaves(bridge.mesh_specs(cfg, mesh))
    k = [i for i, s in enumerate(leaves) if s is spec or s == spec][0]
    cls = [c for c in tstep.reduction_classes(leaves) if k in c][0]
    assert all(leaves[i].model is not None and
               (leaves[i].data is None) == (spec.data is None) for i in cls)
    # a small fused leaf through the layout: shard, gather, serving's cut
    leaf = torch.arange(3 * 2 * 8, dtype=torch.float32).reshape(3, 2, 8)
    small = dataclasses.replace(spec, shape=tuple(leaf.shape), data=None)
    tree = MeshTree(mesh)
    shards = tree.shard(leaf, small)
    want = sharding.slice_leaf(leaf, 2, shape[1], range(shape[1]), parts=2)
    assert torch.equal(shards[0], want)
    assert torch.equal(tree.gather(shards, small), leaf)
