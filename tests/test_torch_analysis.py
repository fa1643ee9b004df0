"""The port's analysis package and dry run against the reference's.

``analysis/roofline.py``'s arithmetic, ``registry.abstract_params``, the
wire model and ``report.py`` are held to the reference's on the same
configs; the cost counter (``analysis/cost.py``) to closed forms and to
``hlocost`` on the reference's compiled smoke forward; the collectives a
recording mesh logs (``analysis/collectives.RecordingAxis``) to the
counts ``transformer.train_exchanges`` and ``registry.decode_exchanges``
derive.  Everything runs on meta tensors: nothing is allocated for a
weight, at published width or at smoke size.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.analysis import hlocost
from repro.analysis import refresh as jrefresh
from repro.analysis import report as jreport
from repro.analysis import roofline as jrf
from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.analysis import collectives as col
from repro_torch.analysis import cost, refresh, report
from repro_torch.analysis import roofline as rf
from repro_torch.configs import all_archs, live_shapes, smoke
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_recording_mesh
from repro_torch.models import registry, transformer

ARCHS = sorted(all_archs())
FAMILIES = {"dense": "olmo-1b", "moe": "moonshot-v1-16b-a3b",
            "ssm": "rwkv6-7b", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base", "vlm": "internvl2-26b"}
G, B, D = 8, 32, 128            # tests/test_analysis.py's scan


# the reference's abstract trees, each traced once for the module (its
# roofline functions trace the init again on every call otherwise)
_reference_abstract = functools.lru_cache(maxsize=None)(
    jregistry.abstract_params)


def _reference_tree(name: str) -> dict:
    """The reference's abstract tree at published width, ``path ->
    (shape, dtype name)`` (``jax.eval_shape``: nothing allocated)."""
    tree = _reference_abstract(j_all_archs()[name])
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jroofline():
    """The reference's roofline module over the cached abstract trees."""
    orig = jregistry.abstract_params
    jregistry.abstract_params = _reference_abstract
    yield jrf
    jregistry.abstract_params = orig


# ---------------------------------------------------------------------------
# abstract parameters and the copied arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_abstract_params_are_the_reference_tree(name):
    """At published width, leaf by leaf: the reference's paths, shapes and
    dtypes, every leaf on the meta device (no storage)."""
    tree = registry.abstract_params(all_archs()[name])
    leaves = list(bridge.flatten(tree))
    assert all(t.is_meta for _, t in leaves)
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in leaves}
    assert got == _reference_tree(name)


@pytest.mark.parametrize("name", ARCHS)
def test_roofline_arithmetic_is_the_reference(name, jroofline):
    """``param_count``, ``active_param_count``, ``model_flops`` and
    ``analytic_memory_bytes`` equal the reference's at every live shape
    on 256 and 512 cards."""
    cfg, jcfg = all_archs()[name], j_all_archs()[name]
    assert rf.param_count(cfg) == jroofline.param_count(jcfg)
    assert rf.active_param_count(cfg) == jroofline.active_param_count(jcfg)
    for shape in live_shapes(cfg):
        assert rf.model_flops(cfg, shape) == jroofline.model_flops(jcfg,
                                                                   shape)
        for n_chips in (256, 512):
            assert rf.analytic_memory_bytes(cfg, shape, n_chips) == \
                jroofline.analytic_memory_bytes(jcfg, shape, n_chips)


def test_roofline_counts_are_sane():
    """``tests/test_core_feature.py``'s ranges and
    ``tests/test_analysis.py``'s ordering, on the port's functions; one
    card's memory model does not divide by zero."""
    n = rf.param_count(all_archs()["command-r-plus-104b"])
    assert 95e9 < n < 115e9, n
    qwen = all_archs()["qwen3-moe-235b-a22b"]
    assert 210e9 < rf.param_count(qwen) < 260e9
    assert 18e9 < rf.active_param_count(qwen) < 30e9
    mf = rf.model_flops(all_archs()["olmo-1b"], SHAPES["train_4k"])
    assert 6e15 < mf < 9e15, mf
    nemo = all_archs()["mistral-nemo-12b"]
    train = rf.analytic_memory_bytes(nemo, SHAPES["train_4k"], 256)
    decode = rf.analytic_memory_bytes(nemo, SHAPES["decode_32k"], 256)
    assert train > decode > 0
    assert rf.analytic_memory_bytes(nemo, SHAPES["train_4k"], 1) > train


def test_input_specs_are_the_reference_specs():
    for name in ("olmo-1b", "whisper-base", "internvl2-26b"):
        cfg, jcfg = all_archs()[name], j_all_archs()[name]
        for shape in SHAPES.values():
            got = registry.input_specs(cfg, shape)
            want = jregistry.input_specs(jcfg, shape)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.is_meta and tuple(v.shape) == want[k].shape
                assert str(v.dtype).replace("torch.", "") == \
                    str(want[k].dtype)


def test_abstract_decode_caches_are_meta():
    cfg = all_archs()["jamba-1.5-large-398b"]
    caches = registry.abstract_decode_caches(cfg, 128, 32768)
    leaves = list(bridge.flatten(caches))
    assert leaves and all(t.is_meta for _, t in leaves)


# ---------------------------------------------------------------------------
# the wire model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_f32", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_are_the_reference_model(kind, n, is_f32):
    """The reference's wire bytes for each kind and group size.  The port
    makes no dtype correction (``wire_bytes_tpu`` halves an f32 payload
    in the reference): its summary totals the bytes as exchanged."""
    args = (kind, "c", 1200, 1200 * n, n, 3, False)
    ours = col.CollectiveOp(*args, is_f32=is_f32)
    theirs = jhlo.CollectiveOp(*args, is_f32=is_f32)
    assert ours.wire_bytes == theirs.wire_bytes
    summ = col.summarize([ours, dataclasses.replace(ours, is_dcn=True)])
    assert summ.total_wire_bytes == summ.raw_wire_bytes == 2 * ours.wire_bytes
    assert summ.ici_wire_bytes == summ.dcn_wire_bytes == ours.wire_bytes
    assert col.collective_counts([ours, ours]) == \
        jhlo.collective_counts([theirs, theirs])


def test_production_mesh_links():
    """Rank 0's axes on the production meshes: ``model`` ranks 0-15 and
    ``data`` ranks 0, 16, ... span nodes of 8 cards (dcn), as does
    ``pod``; a group of 8 consecutive ranks is one node's (ici)."""
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.size == 512 and mesh.shape == {"pod": 2, "data": 16,
                                               "model": 16}
    model, data, pod = mesh.axis.pods, mesh.data, mesh.pod
    assert model.ranks == tuple(range(16)) and model.n_groups == 32
    assert data.ranks == tuple(range(0, 256, 16))
    assert pod.ranks == (0, 256)
    assert all(col.spans_nodes(a.ranks) for a in (model, data, pod))
    assert not col.spans_nodes(range(8))
    assert make_recording_mesh((2, 4), ("data", "model")).axis.pods.ranks \
        == (0, 1, 2, 3)


# ---------------------------------------------------------------------------
# the counter: closed forms
# ---------------------------------------------------------------------------

def _scan(ws, x):
    for w in ws:
        x = torch.tanh(x @ w)
    return x.sum()


def _reference_scan_flops() -> float:
    ws, x = jnp.ones((G, D, D)), jnp.ones((B, D))

    def fwd(ws, x):
        def body(x, w):
            return jnp.tanh(x @ w), ()
        x, _ = jax.lax.scan(body, x, ws)
        return x.sum()
    c = jax.jit(jax.grad(fwd)).lower(ws, x).compile()
    return hlocost.analyze_text(c.as_text()).flops


def test_counter_closed_forms_on_the_scan():
    """Forward ``2·G·B·D²`` exactly; forward and backward ``(6·G - 2)·B·D²``
    — autograd forms no gradient of ``x``, which takes none, where XLA's
    scan body also computes the first layer's input gradient: the
    reference counts ``6·G·B·D²``, ``2·B·D²`` more."""
    ws = torch.empty((G, D, D), device="meta")
    x = torch.empty((B, D), device="meta")
    _, fwd = cost.measure(_scan, ws, x)
    assert fwd.flops == 2 * G * B * D * D

    def grad(ws, x):
        ws = ws.requires_grad_(True)
        return torch.autograd.grad(_scan(ws, x), ws)[0]
    _, both = cost.measure(grad, ws, x)
    assert both.flops == (6 * G - 2) * B * D * D
    assert _reference_scan_flops() - both.flops == 2 * B * D * D
    assert fwd.collectives == [] and fwd.hbm_bytes > 0
    assert fwd.argument_bytes == (G * D * D + B * D) * 4
    assert fwd.peak_bytes >= fwd.argument_bytes


def test_counter_on_a_recording_mesh():
    """``w`` split over ``model`` of a (2, 4) mesh and ``x`` over ``data``:
    a rank's FLOPs are an eighth of the forward's, and each layer gathers
    its output's columns once (one all-gather over ``model``)."""
    mesh = make_recording_mesh((2, 4), ("data", "model"))
    ws = torch.empty((G, D, D // 4), device="meta")
    x = torch.empty((B // 2, D), device="meta")

    def rank(ws, x):
        for w in ws:
            x = torch.tanh(mesh.axis.gather((x @ w)[None]))
        return x.sum()
    _, c = cost.measure(rank, ws, x)
    assert c.flops * 8 == 2 * G * B * D * D
    counts = col.collective_counts(c.collectives)
    assert counts == {"all-gather": G}
    op = c.collectives[0]
    assert (op.comp, op.group_size, op.operand_bytes, op.result_bytes) == \
        ("model", 4, B // 2 * D // 4 * 4, B // 2 * D * 4)
    assert c.summary().dcn_wire_bytes == 0       # 4 ranks in one node


def test_smoke_forward_counts_the_reference_dots():
    """The smoke dense forward on one device: the port's counted FLOPs
    are ``hlocost``'s over the reference's compiled forward."""
    name, Bs, S = "olmo-1b", 2, 32
    jcfg, cfg = j_smoke(j_all_archs()[name]), smoke(all_archs()[name])
    tok = jax.ShapeDtypeStruct((Bs, S), jnp.int32)
    c = jax.jit(lambda p, t: jregistry.forward(jcfg, p, {"tokens": t})[0]) \
        .lower(jregistry.abstract_params(jcfg), tok).compile()
    want = hlocost.analyze_text(c.as_text()).flops
    _, got = cost.measure(
        lambda p, t: registry.forward(cfg, p, {"tokens": t})[0],
        registry.abstract_params(cfg),
        torch.empty((Bs, S), dtype=torch.int32, device="meta"))
    assert got.flops == want


# ---------------------------------------------------------------------------
# recorded collectives against the derived counts
# ---------------------------------------------------------------------------

def _by_kind(ops, axis: str) -> dict:
    out = {}
    for op in ops:
        if op.comp == axis:
            out[op.kind] = out.get(op.kind, 0) + 1
    return out


def _derived(counts: dict) -> dict:
    return {col.KINDS.get(k, k): v for k, v in counts.items() if v}


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "model")])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_cell_records_the_derived_exchanges(family, axes, sp):
    """One train step at smoke size on a (2, 2) recording mesh: the
    ``model`` axis logs what ``transformer.train_exchanges`` derives,
    plus the gradient norm's all-reduce; over ``pod`` the int8 reduction
    exchanges too."""
    cfg = smoke(all_archs()[FAMILIES[family]])
    mesh = make_recording_mesh((2, 2), axes)
    lowered, _ = dryrun.lower_cell(cfg, ShapeConfig("smoke", "train", 32, 4),
                                   mesh, sp=sp)
    _, c = lowered.cost()
    want = _derived(transformer.train_exchanges(
        cfg, 2, sequence_parallel=sp, remat=cfg.remat != "none"))
    want["all-reduce"] = want.get("all-reduce", 0) + 1
    assert _by_kind(c.collectives, "model") == want
    assert c.flops > 0 and c.peak_bytes > c.argument_bytes > 0
    if axes[0] == "pod":
        assert _by_kind(c.collectives, "pod")
        assert "data" not in {op.comp for op in c.collectives}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_cell_records_the_derived_exchanges(family):
    """One decode step at smoke size on a (data 2, model 2) recording
    mesh: the ``model`` axis logs ``registry.decode_exchanges``."""
    cfg = smoke(all_archs()[FAMILIES[family]])
    mesh = make_recording_mesh((2, 2), ("data", "model"))
    lowered, _ = dryrun.lower_cell(cfg, ShapeConfig("smoke", "decode", 32,
                                                    4), mesh)
    (logits, _), c = lowered.cost()
    assert logits.is_meta and logits.shape[0] == 2     # a data rank's rows
    assert _by_kind(c.collectives, "model") == _derived(
        registry.decode_exchanges(cfg, 2))


def test_a_refused_cell_fails():
    """Whisper-base's 8 heads do not split over the production mesh's
    model axis of 16: the cell raises, it is not skipped."""
    with pytest.raises(ValueError, match="do not split"):
        dryrun.run_cell(all_archs()["whisper-base"], SHAPES["decode_32k"],
                        "pod", verbose=False)


# ---------------------------------------------------------------------------
# the JSON, report, refresh, roofline.table and --plan
# ---------------------------------------------------------------------------

REPORT_KEYS = ("arch", "shape", "mesh", "roofline_fraction", "bottleneck",
               "compute_s", "memory_s", "collective_s", "n_chips",
               "useful_ratio", "peak_memory_bytes")
REFRESH_KEYS = ("arch", "shape", "flops_per_device", "n_chips",
                "compute_s", "collective_s")
DRYRUN_KEYS = ("lower_s", "compile_s", "output_bytes", "temp_bytes",
               "wire_ici", "wire_dcn", "step_s", "argument_bytes",
               "model_flops", "hlo_flops_global", "collectives")


@pytest.fixture(scope="module")
def cell_dir(tmp_path_factory):
    """``launch.dryrun.main`` on one published-width cell (OLMo-1B's
    decode_32k on the pod mesh): its JSON."""
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--mesh",
                 "pod", "--out", str(out)])
    return out


def test_dryrun_json_carries_the_reference_keys(cell_dir):
    (path,) = cell_dir.glob("*.json")
    assert path.name == "olmo-1b__decode_32k__pod.json"
    d = json.loads(path.read_text())
    for key in REPORT_KEYS + REFRESH_KEYS + DRYRUN_KEYS:
        assert key in d, key
    assert d["n_chips"] == 256 and d["compile_s"] == 0.0
    assert d["step_s"] == max(d["compute_s"], d["memory_s"],
                              d["collective_s"])
    assert d["wire_dcn"] > 0 and d["wire_ici"] == 0    # model spans nodes
    assert d["peak_memory_bytes"] >= d["argument_bytes"] > 0
    assert refresh.refresh_record(dict(d)) == d
    jrefresh.refresh_record(dict(d))         # the reference's reads too


def test_report_renders_the_port_json(cell_dir):
    for rep in (report, jreport):
        recs = rep.dryrun_records(str(cell_dir))
        assert [r.name for r in recs] == ["olmo-1b.decode_32k.pod"]
        assert not recs[0].skipped
        assert "| olmo-1b | decode_32k | pod |" in rep.table(str(cell_dir))


def test_roofline_table_runs_through_the_runner(cell_dir, tmp_path,
                                                monkeypatch):
    from repro_torch.experiments import Runner
    monkeypatch.chdir(tmp_path)
    skip = Runner(duration=0.0, only=["roofline.table"], records_dir=None,
                  device="cpu").run()
    assert skip.ok and skip.records[0].skipped
    out = tmp_path / dryrun.DEFAULT_OUT
    out.mkdir(parents=True)
    for f in cell_dir.glob("*.json"):
        (out / f.name).write_text(f.read_text())
    rep = Runner(duration=0.0, only=["roofline.table"], records_dir=None,
                 device="cpu").run()
    (rec,) = rep.records
    assert rep.ok and rec.metric == "roofline_fraction" and rec.value > 0


def test_train_cli_plans_on_the_dryrun_json(cell_dir, tmp_path, capsys):
    """``launch.train --smoke --plan`` takes the dry run's JSON as it is
    (its memory-bound terms: two microbatches)."""
    from repro_torch.launch import train
    (path,) = cell_dir.glob("*.json")
    hist = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                       "32", "--plan", str(path), "--ckpt-dir",
                       str(tmp_path / "ckpt")], device="cpu")
    out = capsys.readouterr().out
    assert "[plan]" in out and "bottleneck=memory" in out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])


def test_mamba_scan_on_meta_counts_the_stepped_products():
    """On meta the scan takes a chunk's steps as one op each: the same
    products as the stepped scan on the CPU, forward and backward."""
    from repro_torch.models import common, mamba
    cfg = smoke(all_archs()["jamba-1.5-large-398b"])
    gen = torch.Generator()
    gen.manual_seed(0)
    p = mamba.mamba_init(gen, cfg)
    d_inner, dt_rank, d_state = mamba._dims(cfg)
    counts = []
    for dev in ("cpu", "meta"):
        pd = common.tree_map(lambda a: a.to(dev).requires_grad_(
            a.is_floating_point()), p)
        dt = common.dtype_of(cfg)
        xc = torch.ones((2, 16, d_inner), dtype=dt, device=dev)
        proj = torch.ones((2, 16, dt_rank + 2 * d_state), dtype=dt,
                          device=dev)

        def run(pd, xc, proj):
            y, _ = mamba._scan_chunked(cfg, pd, xc, proj)
            leaves = [t for t in common.tree_leaves(pd) if t.requires_grad]
            return torch.autograd.grad(y.float().sum(), leaves,
                                       allow_unused=True)
        counts.append(cost.measure(run, pd, xc, proj)[1].flops)
    assert counts[0] == counts[1] > 0
