"""Sequence parallelism when training the moe, ssm, hybrid, encdec and
vlm families over a ``model`` axis, against the JAX package, on the CPU.

Moonlight (moe), RWKV-6 (ssm), Jamba without and with an attention
layer (hybrid; ``+attn`` as ``tests/test_torch_mesh_train.py``'s
``JAMBA_ATTN``), Whisper (encdec) and InternVL2 (vlm, 4 patches a row
before the 32 tokens; and with an odd vocabulary, ``+odd``, which the
model axis does not split, as at full width: the table, ``lm_head`` and
the connector read whole on every rank), f32 smoke models, 3 steps on
``synth_batch`` at ``(data, model)`` ``(2, 2)``, stock, with
``sequence_parallel`` (``tests/test_torch_mesh_train.py``'s ``CASES``):
each emulated in this process and over one gloo group of 4 rank
processes, against the reference's
``jit_train_step(sequence_parallel=True)`` on 4 forced host devices (one
JAX subprocess for the module, running while the port's runs do).  The loss, the gradient norm and the parameters are held by
that module's ``_hold`` at steps ``RECORD``, Moonlight's aux losses by
``tests/test_torch_mesh_train_tp_families.py``'s ``_hold_aux``, with each
family's tolerances from its module without sequence parallelism:

* every leaf's first-step gradient, gathered over the mesh, within
  ``GRAD_BOUND`` of its largest element from the reference's: moe 1e-5
  and ssm 1e-4 (``..._tp_families.py``), hybrid 5e-5 (the Mamba scan's
  f32 noise, ``..._tp_hybrid.py``), encdec and vlm 1e-5
  (``..._tp_encdec_vlm.py``, whose leaves with a zero reference gradient,
  the key biases, are held to zero within its floor);
* ``_hold``'s ``floor`` (an element within rounding of zero takes the
  loose bound after the first step): the hybrid module's 1e-6 and the
  encdec and vlm module's 1e-7 of the tree's largest gradient.

Every axis has two ranks, so the ranked parameters are bit-equal to the
emulated ones; the model axis makes, per step, the exchanges
``transformer.train_exchanges(sequence_parallel=True)`` derives.

**Planted faults.**  The emulated axis holds a replicated tensor once,
so it hides the faults a rank process makes when each computes the same
gradient whole; each fault below passes emulated and fails on ranks,
where the faulty code runs in the rank processes themselves
(:class:`_Planted`: the body's pickle carries the fault's source, which
the rank plants before it trains):

* ``router``: the gathered sequence routed on every rank, as
  ``moe.moe_parts`` routes a replicated input, so that each rank holds
  the whole gradient of the router and of the aux losses, which the
  router's ``copy`` then sums twice;
* ``rwkv_gate``: RWKV-6's channel-mix gate gathered along its channels
  by ``gather``, whose backward keeps the rank's slice of a gradient
  that under sequence parallelism is the rank's partial one (its own
  ``kv``).
"""
import numpy as np
import pytest
import torch

import test_torch_mesh_train as base
import test_torch_mesh_train_tp_encdec_vlm as ev
import test_torch_mesh_train_tp_families as fam
import test_torch_mesh_train_tp_hybrid as hyb
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import common, transformer
from repro_torch.parallel import dist, rank_bodies
from repro_torch.train import step as tstep

HERE = ("moe_sp_2x2", "rwkv_sp_2x2", "jamba_sp_2x2", "jamba_attn_sp_2x2",
        "whisper_sp_2x2", "vlm_sp_2x2", "vlm_odd_sp_2x2")
GRAD_BOUND = {"moe": fam.GRAD_BOUND["moe"], "ssm": fam.GRAD_BOUND["ssm"],
              "hybrid": hyb.GRAD_BOUND, "encdec": ev.GRAD_BOUND,
              "vlm": ev.GRAD_BOUND}
FLOOR = {"moe": 0.0, "ssm": 0.0, "hybrid": hyb.ZERO, "encdec": ev.ZERO,
         "vlm": ev.ZERO}
# name: (case, the leaves the fault shows in, the fault's source: it
# plants itself when run)
FAULTS = {
    "router": ("moe_sp_2x2", "moe/router/kernel", """
from repro_torch.models import moe


def fault(cfg, ranks, hn, hs, axis):
    parts, aux, _ = moe.moe_parts(cfg, ranks, hs[0], hs, axis)
    return parts, aux


moe.moe_parts_sp = fault
"""),
    "rwkv_gate": ("rwkv_sp_2x2", "cmlp/wr/kernel", """
from repro_torch.parallel import model_axis


def planted(orig):
    def fault(self, x, dim=1):
        if dim != -1:
            return orig(self, x, dim)
        g = self.gather(x)
        return g.unsqueeze(0).expand((len(self.held),) + tuple(g.shape))
    return fault


for cls in (model_axis.ModelAxis, model_axis.DistModelAxis):
    cls.gather_seq = planted(cls.gather_seq)
"""),
}


class _Planted:
    """A rank body that plants ``source`` in its process, then runs
    ``rank_bodies.mesh_train``.  It pickles as the text of a lambda
    (``eval``'d when the rank unpickles its arguments), so the fault is
    planted only when the body runs, after the bodies before it in the
    group."""

    def __init__(self, source: str):
        self.source = source

    def __reduce__(self):
        return (eval, (
            f"lambda pods, *args: (exec({self.source!r}, {{}}), "
            f"__import__('repro_torch.parallel.rank_bodies', "
            f"fromlist=['mesh_train']).mesh_train(pods, *args))[1]", {}))


def _family(name: str) -> str:
    return base._cfgs(base.CASES[name][0])[1].family


def _fault_args(name: str) -> tuple:
    """The first-step gradient alone (no step) of case ``name``."""
    args = list(base._case_args(name))
    args[4], args[8] = 0, ()
    return tuple(args) + (True,)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return base.start_reference(tmp_path_factory, HERE)


@pytest.fixture(scope="module")
def ranked(started):
    """Every case over one group of 4 rank processes, then the planted
    faults' first-step gradients in the same group."""
    calls = [(rank_bodies.mesh_train, base._case_args(c) + (True,))
             for c in HERE]
    calls += [(_Planted(src), _fault_args(c))
              for c, _, src in FAULTS.values()]
    with base.one_thread():
        res = dist.run_ranks(rank_bodies.in_turn, 4, backend="gloo",
                             device="cpu", args=(calls,))
    out = {c: [r[i] for r in res] for i, c in enumerate(HERE)}
    for i, fault in enumerate(FAULTS):
        out[fault] = res[0][len(HERE) + i]
    return out


def _planted_here(source: str):
    """A context in which ``source`` is planted in this process, its
    targets restored after."""
    from repro_torch.models import moe
    from repro_torch.parallel import model_axis
    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "moe_parts_sp", moe.moe_parts_sp)
    for cls in (model_axis.ModelAxis, model_axis.DistModelAxis):
        mp.setattr(cls, "gather_seq", cls.gather_seq)
    exec(source, {})
    return mp


@pytest.fixture(scope="module")
def emulated(started):
    with base.one_thread():
        out = {c: rank_bodies.mesh_train(None, *base._case_args(c), True)
               for c in HERE}
        for fault, (c, _, src) in FAULTS.items():
            mp = _planted_here(src)
            try:
                out[fault] = rank_bodies.mesh_train(None, *_fault_args(c))
            finally:
                mp.undo()
    return out


@pytest.fixture(scope="module")
def reference(started, ranked, emulated):
    # the port's runs first: the reference's subprocess runs meanwhile
    return base.finish_reference(started)


def _worst(grads, reference, name) -> tuple:
    """The largest difference of a leaf's first-step gradient from the
    reference's over the leaf's largest element, ``(ratio, path)``; the
    encdec and vlm families' leaves whose reference gradient is zero to
    rounding (``ev``'s floor) held to zero instead."""
    if _family(name) in ("encdec", "vlm"):
        floor = ev.ZERO * ev._top(reference, name)
        kept = {}
        for path, g in grads.items():
            want = reference[f"{name}/grad{base._keystr(path)}"]
            if np.abs(want).max() < floor:
                assert np.abs(g).max() < floor, path
            else:
                kept[path] = g
        grads = kept
    return fam._worst_grad(grads, reference, name)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_emulated_sp_step_matches_the_reference(name, at, reference,
                                                emulated):
    base._hold(emulated[name], reference, name, at,
               floor=FLOOR[_family(name)])
    fam._hold_aux(emulated[name], reference, name, at)


@pytest.mark.parametrize("at", base.RECORD)
@pytest.mark.parametrize("name", HERE)
def test_ranked_sp_step_matches_the_reference(name, at, reference, ranked,
                                              emulated):
    """Rank 0 against the reference, every rank's losses and gradient
    norm equal to rank 0's, and the gathered parameters bit-equal to the
    emulated mesh's."""
    runs = ranked[name]
    base._hold(runs[0], reference, name, at, floor=FLOOR[_family(name)])
    fam._hold_aux(runs[0], reference, name, at)
    for r, run in enumerate(runs):
        for k in ("loss", "grad_norm", "lb_loss", "z_loss"):
            assert run["steps"][at][k] == runs[0]["steps"][at][k], (r, k)
    emu = emulated[name]["steps"][at]
    for path, t in runs[0]["steps"][at]["params"].items():
        assert np.array_equal(t, emu["params"][path]), path


@pytest.mark.parametrize("form", ["emulated", "ranked"])
@pytest.mark.parametrize("name", HERE)
def test_first_step_gradients_leaf_by_leaf(name, form, reference, ranked,
                                           emulated):
    """Every leaf's first-step gradient, gathered over the mesh, within
    the family's ``GRAD_BOUND`` of its largest element from the
    reference's; over ranks, rank 0's."""
    run = emulated[name] if form == "emulated" else ranked[name][0]
    worst, path = _worst(run["grads"], reference, name)
    assert worst <= GRAD_BOUND[_family(name)], (path, worst)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_passes_emulated_and_fails_on_ranks(fault, reference,
                                                          ranked, emulated):
    """Each planted fault's first-step gradient: emulated, every leaf
    within the bound, as the sound code's; over ranks, the leaves the
    fault reaches off by more than 100 times it."""
    name, leaf, _ = FAULTS[fault]
    bound = GRAD_BOUND[_family(name)]
    worst, path = _worst(emulated[fault]["grads"], reference, name)
    assert worst <= bound, (path, worst)
    reached = {p: g for p, g in ranked[fault]["grads"].items()
               if p.endswith(leaf)}
    assert reached
    for path, g in reached.items():
        want = reference[f"{name}/grad{base._keystr(path)}"]
        assert np.abs(g - want).max() > 100 * bound * np.abs(want).max(), \
            path


@pytest.mark.parametrize("name", HERE)
def test_exchanges_a_step_are_the_derived_counts(name, ranked):
    """Over the ranks the model axis makes, per step, the exchanges
    ``transformer.train_exchanges(sequence_parallel=True)`` derives, one
    all-reduce for the gradient norm, and one all-gather a model-split
    leaf a recorded step."""
    arch, shape, axes = base.CASES[name][:3]
    cfg = base._cfgs(arch)[1]
    split = [s for s in common.tree_leaves(bridge.mesh_specs(
        cfg, make_mesh(shape, axes))) if s.model is not None]
    want = transformer.train_exchanges(cfg, shape[-1],
                                       sequence_parallel=True, remat=False)
    want = {k: v * base.STEPS for k, v in want.items()}
    want["all_reduce"] += base.STEPS
    want["all_gather"] = want.get("all_gather", 0) \
        + len(split) * len(base.RECORD)
    for r, run in enumerate(ranked[name]):
        assert run["exchanges_model"] == want, (r, run["exchanges_model"])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "rwkv6-7b",
                                  "jamba-1.5-large-398b", "whisper-base",
                                  "internvl2-26b"])
def test_the_derived_counts_at_published_width(arch):
    """``train_exchanges(sequence_parallel=True)`` at published width,
    counted from the layer positions: a region's entry gathers and its
    exit reduce-scatters (each with the other backward); an MoE layer
    gathers its routing (backward: reduce-scatter) and sums its aux
    losses (one all-reduce); a Mamba mixer is one region and its
    ``x_proj`` pair; RWKV-6 gathers its gate (backward:
    reduce-scatter); every replicated leaf read on a slice one copy;
    InternVL2's odd vocabulary (92553) replicated, the sequence split and
    gathered around it; Whisper's counts those without sequence
    parallelism."""
    cfg = all_archs()[arch]
    got = transformer.train_exchanges(cfg, 2, sequence_parallel=True,
                                      remat=False)
    plain = transformer.train_exchanges(cfg, 2, sequence_parallel=False,
                                        remat=False)
    if cfg.family == "encdec":
        assert got == plain
        return
    G, layers = cfg.num_groups(), range(cfg.layer_group)
    regions = gathers = reduces = 0
    for l in layers:
        if cfg.family == "ssm":
            regions, gathers = regions + 2, gathers + 1
            continue
        regions += 2
        if cfg.is_moe_layer(l):
            gathers, reduces = gathers + 1, reduces + 1
        if not cfg.is_attn_layer(l):
            reduces += 2
    leaves = len(transformer.copied_leaves(cfg, 2, True))
    seq = 2 * G * regions + G * gathers
    if cfg.vocab_size % 2 == 0:
        # the embedding's exit and the final entry, the vocab-parallel
        # loss's three all-reduces (and a VLM's patches split)
        want = {"all_gather": seq + 2 + (cfg.family == "vlm"),
                "reduce_scatter": seq + 2,
                "all_reduce": G * reduces + leaves + 3}
    else:
        # the embedded sequence split, the final activations gathered
        want = {"all_gather": seq + 2, "reduce_scatter": seq,
                "all_reduce": G * reduces + leaves}
    assert got == want
    # every replicated leaf but the embedding's, the logits' and the
    # connector's, which every rank reads whole
    flat = bridge.flatten(bridge.mesh_specs(cfg, make_host_mesh(1, 2)))
    assert leaves == sum(s.model is None and not path.startswith(
        ("embed/", "lm_head/", "vit_proj/")) for path, s in flat)


@pytest.mark.parametrize("arch,seq,ok", [
    ("moonshot-v1-16b-a3b", 32, True), ("rwkv6-7b", 31, False),
    # 4 patches a row before the tokens: 4 + 30 splits over 2, 4 + 31 not
    ("internvl2-26b", 30, True), ("internvl2-26b", 31, False),
    # an encoder-decoder's residual stream is never split
    ("whisper-base", 31, True)])
def test_a_split_sequence_not_a_multiple_of_the_axis_is_refused(arch, seq,
                                                                ok):
    """The one refusal left under sequence parallelism: a split sequence
    (a VLM's patches and tokens) that the model axis does not divide, at
    ``check_tp_train`` and at the step."""
    cfg = smoke(all_archs()[arch])
    transformer.check_tp_train(cfg, 2, True)
    if ok:
        transformer.check_tp_train(cfg, 2, True, seq)
        return
    with pytest.raises(ValueError, match="not a multiple"):
        transformer.check_tp_train(cfg, 2, True, seq)
    mesh = make_host_mesh(1, 2)
    opts = base._opts("stock", True)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, mesh)
    batch = pipeline.synth_batch(pipeline.for_arch(cfg, seq, 2), 0)
    with pytest.raises(ValueError, match="not a multiple"):
        tstep.make_train_step(cfg, None, mesh, opts)(state, batch)
