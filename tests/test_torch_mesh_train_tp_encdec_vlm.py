"""Training the encoder-decoder and VLM families over a ``model`` axis,
against the JAX package, on the CPU.

Whisper-base (encdec: every projection with a bias, the embedding tied)
and InternVL2 (vlm: 4 patches a row prepended by the connector), f32
smoke models, 3 steps on ``synth_batch`` with its frames and patches, at
``(data, model)`` ``(2, 2)``, stock; and InternVL2 with an odd
vocabulary (``+odd``, 511), which no model axis splits, so that its
embedding and logits stay replicated and the loss takes the replicated
branch, as InternVL2's 92,553 and Whisper's 51,865 do at full width
(``tests/test_torch_mesh_train.py``'s ``CASES``).  Each runs emulated in
this process and over one gloo group of 4 rank processes, against the
reference's ``jit_train_step`` on 4 forced host devices (one JAX
subprocess for the module, running while the port's runs do), held by
that module's ``_hold`` and tolerances; every axis has two ranks, so the
ranked parameters are bit-equal to the emulated ones.

**First-step gradients, leaf by leaf** (the emulated axis holds a
replicated leaf once, so only the gradient shows a rank's partial one):
within ``GRAD_BOUND`` of the leaf's largest element, 1e-5 for both
families; the emulated and ranked meshes sat within 2.0e-6 (InternVL2)
and 2.4e-6 (Whisper) when this test was written.

**Zero gradients.**  Softmax is shift-invariant along the keys, so the
gradient of every attention's key bias is zero: the reference's holds
f32 rounding (at most 2.5e-9, where the tree's largest is 0.16), and
AdamW's first update ``g / (|g| + eps)`` turns that into any move up to
``lr``.  So at the first step an element whose reference gradient is
below ``ZERO`` (1e-7, f32's rounding) of the tree's largest takes the
loose bound (``_hold``'s ``floor``), and a leaf whose whole reference
gradient is below it is held to be zero on the port's side too, within
the same floor.

**Planted faults.**  A cut bias (q, v or ``wi``; encoder, decoder or
cross attention) given each rank a copy of its own instead of entering
through ``axis.copy``: the ranks' gradients sum to the reference's, and
rank 0's alone — what a rank process keeps — misses the other rank's
heads or columns.  The VLM's loss scored over the first ``S`` positions
(the patches' and the text's start) instead of the last ``S``: the loss
is far off the reference's.
"""
import numpy as np
import pytest
import torch

import test_torch_mesh_train as base
import test_torch_mesh_train_tp_families as fam
from repro_torch import bridge, runtime
from repro_torch.configs import all_archs
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import common, transformer
from repro_torch.parallel import rank_bodies

HERE = ("whisper_2x2", "vlm_2x2", "vlm_odd_2x2")
GRAD_BOUND = 1e-5
ZERO = 1e-7


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return base.start_reference(tmp_path_factory, HERE)


@pytest.fixture(scope="module")
def ranked(started):
    with base.one_thread():
        return base.run_ranked(HERE, grads=HERE)


@pytest.fixture(scope="module")
def emulated(started):
    with base.one_thread():
        return {c: rank_bodies.mesh_train(None, *base._case_args(c), True)
                for c in HERE}


@pytest.fixture(scope="module")
def reference(started, ranked, emulated):
    # the port's runs first: the reference's subprocess runs meanwhile
    return base.finish_reference(started)


def _top(reference, name) -> float:
    """The largest element of the reference's first-step gradient."""
    return max(float(np.abs(v).max()) for k, v in reference.items()
               if k.startswith(f"{name}/grad"))


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_mesh_step_matches_the_reference(name, at, reference,
                                                  emulated):
    base._hold(emulated[name], reference, name, at, floor=ZERO)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_mesh_step_matches_the_reference(name, at, reference,
                                                ranked, emulated):
    """Rank 0 against the reference, every rank's loss and gradient norm
    equal to rank 0's, the gathered parameters bit-equal to the emulated
    mesh's."""
    runs = ranked[name]
    base._hold(runs[0], reference, name, at, floor=ZERO)
    for r in runs:
        assert r["steps"][at]["loss"] == runs[0]["steps"][at]["loss"]
        assert r["steps"][at]["grad_norm"] == \
            runs[0]["steps"][at]["grad_norm"]
    emu = emulated[name]["steps"][at]
    for path, t in runs[0]["steps"][at]["params"].items():
        assert np.array_equal(t, emu["params"][path]), path


@pytest.mark.parametrize("form", ["emulated", "ranked"])
@pytest.mark.parametrize("name", HERE)
def test_first_step_gradients_leaf_by_leaf(name, form, reference, ranked,
                                           emulated):
    """Every leaf's first-step gradient, gathered over the mesh, within
    ``GRAD_BOUND`` of its largest element from the reference's; a leaf
    whose reference gradient is zero to f32 rounding (a key bias) zero on
    the port's side too (module docstring).  Over ranks, rank 0's."""
    run = emulated[name] if form == "emulated" else ranked[name][0]
    floor = ZERO * _top(reference, name)
    grads, zero = {}, []
    for path, g in run["grads"].items():
        want = reference[f"{name}/grad{base._keystr(path)}"]
        if np.abs(want).max() < floor:
            zero.append(path)
            assert np.abs(g).max() < floor, path
        else:
            grads[path] = g
    worst, path = fam._worst_grad(grads, reference, name)
    assert worst <= GRAD_BOUND, (path, worst)
    if name == "whisper_2x2":
        assert sorted(zero) == sorted(
            f"{s}/{a}/k/bias" for s, a in (("enc_layers", "attn"),
                                           ("layers", "attn"),
                                           ("layers", "xattn")))


def _one_device(arch):
    """The f32 smoke config, the reference's parameters on the CPU, and
    batch 0 with its frames or patches (the stock cases' first batch)."""
    cfg = base._cfgs(arch)[1]
    params = bridge.params_from_numpy(cfg, base._np_params(arch), "cpu")
    return cfg, params, pipeline.synth_batch(
        pipeline.for_arch(cfg, base.SEQ, base.BATCH), 0)


@pytest.mark.parametrize("leaf", ["enc_layers/attn/q/bias",
                                  "layers/xattn/v/bias",
                                  "layers/mlp/wi/bias"])
def test_whisper_bias_would_fail_with_one_ranks_partial_gradient(
        leaf, reference):
    """A cut bias given each emulated rank a copy of its own (marked
    split, so that no copy sums the ranks' gradients), on a (1, 2) mesh:
    the two ranks' gradients sum to the reference's within the bound,
    and rank 0's alone — what a rank process keeps without ``axis.copy``
    — is off by far more."""
    name = "whisper_2x2"
    cfg, params, batch = _one_device("whisper-base")
    mesh = make_host_mesh(1, 2)
    specs = bridge.mesh_specs(cfg, mesh)
    model_in = common.tree_map(lambda x: x[0],
                               bridge.mesh_shards(cfg, params, mesh))
    split = common.tree_map(lambda s: s.model is not None, specs)
    node, snode = model_in, split
    *head, last = leaf.split("/")
    for k in head:
        node, snode = node[k], snode[k]
    mine = node[last].expand((2,) + tuple(node[last].shape[1:])).clone() \
        .requires_grad_(True)
    node[last], snode[last] = mine, True
    with runtime.use_policy(attention_impl="chunked"):
        nll, count, _ = transformer.loss_tp(
            cfg, model_in, split, batch["tokens"], batch["labels"],
            mesh.axis, frames=batch["frames"])
    g, = torch.autograd.grad(nll / count, mine)
    want = reference[f"{name}/grad{base._keystr(leaf)}"]
    scale = np.abs(want).max()
    assert np.abs(g.sum(0).numpy() - want).max() <= GRAD_BOUND * scale
    assert np.abs(g[0].numpy() - want).max() > 100 * GRAD_BOUND * scale


@pytest.mark.parametrize("fault", [False, True])
def test_vlm_loss_over_the_patch_positions_would_fail(fault, reference,
                                                      monkeypatch):
    """The VLM's mesh loss on a (1, 2) mesh (one data rank: batch 0 whole,
    the reference's first-step loss of the global batch) within 1e-5 of
    the reference's; with the patches' positions scored (the backbone's
    output rolled by the patch count, so that the loss's last ``S``
    positions are the first ``S``: the patches' and the text's start) it
    is off by far more."""
    name = "vlm_2x2"
    cfg, params, batch = _one_device("internvl2-26b")
    P = batch["patches"].shape[1]
    if fault:
        backbone = transformer._backbone_tp

        def rolled(*args, **kw):
            ranks, x, made, aux = backbone(*args, **kw)
            return ranks, x.roll(P, dims=1), made, aux
        monkeypatch.setattr(transformer, "_backbone_tp", rolled)
    mesh = make_host_mesh(1, 2)
    specs = bridge.mesh_specs(cfg, mesh)
    model_in = common.tree_map(lambda x: x[0],
                               bridge.mesh_shards(cfg, params, mesh))
    split = common.tree_map(lambda s: s.model is not None, specs)
    with runtime.use_policy(attention_impl="chunked"), torch.no_grad():
        nll, count, _ = transformer.loss_tp(
            cfg, model_in, split, batch["tokens"], batch["labels"],
            mesh.axis, patches=batch["patches"])
    d = abs(float(nll / count) - float(reference[f"{name}/1/loss"]))
    assert (d > 100 * 1e-5) if fault else (d < 1e-5), d


@pytest.mark.parametrize("name", HERE)
def test_exchanges_a_step_are_the_derived_counts(name, ranked):
    """Over the ranks the model axis makes, per step, the exchanges
    ``transformer.train_exchanges`` derives (an encoder layer two regions,
    a decoder layer three, the encoder's output one copy, each cut bias
    one; a VLM's layers the dense family's, the embedding and loss none
    where the vocabulary stays replicated), one all-reduce for the
    gradient norm, and one all-gather a model-split leaf a recorded
    step."""
    fam.test_exchanges_a_step_are_the_derived_counts(name, ranked)


@pytest.mark.parametrize("arch,remat,want", [
    # 2 x (2 x 6 encoder + 3 x 6 decoder regions) + the encoder's copy +
    # 11 cut biases; remat replays the 18 decoder regions' exits;
    # Whisper's odd vocabulary: no embedding or loss exchange
    ("whisper-base", False, 72), ("whisper-base", True, 90),
    # 2 x 2 x 48 regions; remat replays all 96 exits
    ("internvl2-26b", False, 192), ("internvl2-26b", True, 288)])
def test_the_derived_counts_at_published_width(arch, remat, want):
    cfg = all_archs()[arch]
    assert transformer.train_exchanges(
        cfg, 2, sequence_parallel=False, remat=remat) == {"all_reduce": want}


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_the_layout_splits_whole_heads(arch):
    """At published width on a (2, 2) mesh every attention projection
    splits over ``model`` by whole heads, the connector and
    ``frame_proj`` stay whole over ``model``, the vocabularies stay
    replicated over it, and the leaves a rank reads on its own are
    Whisper's cut biases (11: q/k/v of each attention, ``wi``), none of
    InternVL2's."""
    cfg = all_archs()[arch]
    mesh = make_mesh((2, 2), ("data", "model"))
    flat = dict(bridge.flatten(bridge.mesh_specs(cfg, mesh)))
    sizes = {"data": 2, "model": 2}
    names = ("attn", "xattn") if cfg.family == "encdec" else ("attn",)
    for path, spec in flat.items():
        if any(f"{a}/{w}/kernel" in path for a in names
               for w in ("q", "k", "v")):
            assert spec.local(sizes)[spec.model] % cfg.hd == 0, path
            assert spec.local(sizes)[spec.model] // cfg.hd in (
                cfg.num_heads // 2, cfg.num_kv_heads // 2), path
    for path in ("vit_proj/kernel", "frame_proj/kernel", "embed/embedding"):
        if path in flat:
            assert flat[path].model is None, path
    copied = transformer.copied_leaves(cfg, 2)
    assert all(flat[p].model is None for p in copied)
    assert len(copied) == (11 if cfg.family == "encdec" else 0)
