"""The port's offload characterization (``repro_torch.core.{headroom,
stressors,classes,planner}``) and ``launch/train.py --plan`` against the
JAX package, on the CPU.

* The stressor battery is the reference's: names, order, classes,
  ``work_items``, ``requires_devices`` and which have a numpy reference.
* Each deterministic stressor op gives the reference's output on the same
  numpy-seeded inputs: bit for bit where the result is an integer, exact
  or a selection; within 2e-5 relative for f32 arithmetic (another
  summation order, another ``tanh``/``exp``).
* The ops that the reference's XLA materializes (transpose, pad + slice,
  layout churn) write their result here too, and the transfer proxy is
  one elementwise pass.
* ``run_suite``'s SKIP set on one device is the reference's, plus
  ``jit-compile``: the CPU has no device compile service.
* The headroom sweeps give the reference's record names, metrics and
  ``params`` keys; ``derived_headroom`` its numbers at the same peak.
* ``make_plan`` reaches the reference's decisions on the same record
  streams (the reference's own planner cases and a serving stream).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.core import classes as jclasses
from repro.core import headroom as jheadroom
from repro.core import planner as jplanner
from repro.core import stressors as jstressors
from repro.experiments.record import Record as JRecord
from repro_torch import runtime
from repro_torch.core import classes, headroom, planner, stressors
from repro_torch.experiments.record import Record

TOL_F32 = 2e-5


# ---------------------------------------------------------------------------
# the stressor battery
# ---------------------------------------------------------------------------

def test_battery_is_the_reference_battery():
    ours, theirs = stressors._registry("cpu"), jstressors._registry()
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        assert (a.classes, a.work_items, a.requires_devices,
                a.make_ref is None) == (b.classes, b.work_items,
                                        b.requires_devices,
                                        b.make_ref is None), a.name
    assert stressors.EXPERIMENT == jstressors.EXPERIMENT


def _np_normal(shape):
    seed = int(np.prod(shape)) % 9973
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np_randint(shape, high):
    seed = (int(np.prod(shape)) + high) % 9973
    return np.random.default_rng(seed).integers(0, high, shape)


@pytest.fixture
def same_random_inputs(monkeypatch):
    """Both batteries draw their random inputs from the same numpy
    arrays (keyed by shape) instead of their own generators."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_np_normal(tuple(shape)), dtype))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi:
                        jnp.asarray(_np_randint(tuple(shape), hi)
                                    .astype(np.int32)))
    monkeypatch.setattr(stressors, "_normal", lambda gen, shape:
                        torch.tensor(_np_normal(tuple(shape))))
    monkeypatch.setattr(stressors, "_randint", lambda gen, high, shape:
                        torch.tensor(_np_randint(tuple(shape), high)))


# name -> how its output is held: "exact" (bit for bit, as integers or
# exactly representable values) or "f32" (TOL_F32 relative to the largest)
DETERMINISTIC = {
    "matmul-512-f32": "exact", "matmul-512-bf16": "exact",
    "matmul-odd-513": "exact", "vecmath": "f32", "branch-select": "exact",
    "quant-int8": "exact", "hash-mix": "exact", "memrate-64m": "exact",
    "memrate-1m": "exact", "transpose-copy": "exact", "gather-rows": "exact",
    "scatter-add": "exact", "cache-chain-matmul": "f32",
    "assoc-scan": "exact", "sort-64k": "exact", "topk-router": "exact",
    "layout-churn": "exact", "pad-slice": "exact", "h2d-transfer": "exact",
    "d2h-transfer": "exact", "host-callback": "exact",
    "dispatch-noop": "exact", "dispatch-storm": "exact",
    "ckpt-write-read": "exact", "ckpt-metadata": "exact",
}
# the reference's XLA writes these results; a PyTorch view would not
MATERIALIZED = ("transpose-copy", "pad-slice", "layout-churn")


def _as_numpy(out):
    if isinstance(out, torch.Tensor):
        return out.float().numpy() if out.dtype == torch.bfloat16 \
            else out.numpy()
    if isinstance(out, jax.Array):
        return np.asarray(out.astype(jnp.float32) if out.dtype == jnp.bfloat16
                          else out)
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_stressor_op_matches_the_reference(name, same_random_inputs):
    ours = {s.name: s for s in stressors._registry("cpu")}[name]
    theirs = {s.name: s for s in jstressors._registry()}[name]
    got, want = ours.make()(), theirs.make()()
    if name == "ckpt-metadata":
        assert got == want
        return
    if name == "topk-router":                      # values; indices of ties
        got, want = got.values, want[0]            # may differ
    if name in MATERIALIZED:
        assert got.is_contiguous() and got._base is None, name
    g, w = _as_numpy(got), _as_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if DETERMINISTIC[name] == "exact":
        assert (g.astype(np.float64) == w.astype(np.float64)).all(), name
    else:
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= TOL_F32 * scale, name


def test_hash_mix_is_uint32_arithmetic():
    """int64 masked after each multiply: numpy's wrapping uint32 result,
    over the whole 32-bit range (not only the battery's small inputs)."""
    x = np.random.default_rng(5).integers(0, 2**32, 4096, dtype=np.uint64)
    x[:3] = [0, 2**32 - 1, 2**31]
    u = x.astype(np.uint32)
    y = (u ^ (u >> 16)) * np.uint32(0x45D9F3B)
    y = (y ^ (y >> 16)) * np.uint32(0x45D9F3B)
    want = y ^ (y >> 16)
    got = stressors.hash_mix(torch.tensor(x.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()


def test_transfer_proxy_is_one_pass():
    """``1 + 2x`` is one ``aten::add`` a buffer (one read, one write) —
    the byte count ``transfer_sweep`` divides by."""
    from torch.profiler import ProfilerActivity, profile
    one, x = torch.ones(()), torch.ones(1 << 12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = headroom.stream(one, x)
    names = [e.key for e in prof.key_averages()]
    assert names.count("aten::add") == 1
    assert not {"aten::mul", "aten::add_", "aten::mul_"} & set(names)
    assert torch.equal(out, x * 2.0 + 1.0)


def test_run_suite_skips_as_the_reference_on_one_device():
    ours = stressors.run_suite(duration=0.0, device="cpu")
    theirs = jstressors.run_suite(duration=0.0)
    assert [r.name for r in ours] == [r.name for r in theirs]
    skipped = {r.name: r.reason for r in ours if r.skipped}
    want = {r.name: r.reason for r in theirs if r.skipped}
    assert set(skipped) == set(want) | {"jit-compile"}
    assert "jit-compile" not in want
    assert "no device compile service on cpu" in skipped.pop("jit-compile")
    assert skipped == want                  # "needs >= 2 devices"
    for a, b in zip(ours, theirs):
        assert (a.experiment, a.metric, a.params["classes"]) == \
            (b.experiment, b.metric, b.params["classes"])
        if not a.skipped and not b.skipped:
            assert a.unit == b.unit == "ops/s"
            assert sorted(a.params) == sorted(b.params), a.name
            assert (a.relative is None) == (b.relative is None), a.name
            assert a.value > 0


def test_run_suite_runs_the_collective_stressors_over_ranks():
    """With 4 ranks the NETWORK stressors run, one gloo group timing each
    collective on every rank (rank 0's rate is the record), with the
    reference's record keys; without, they SKIP (the test above)."""
    names = ["allreduce", "all-to-all", "allreduce-int8"]
    recs = stressors.run_suite(duration=0.0, names=names, device="cpu",
                               devices=4)
    assert [r.name for r in recs] == names
    for r in recs:
        assert not r.skipped, r.reason
        assert r.value > 0 and r.unit == "ops/s" and r.relative is None
        assert sorted(r.params) == ["classes", "median_s", "p90_s"]
    assert recs[2].params["classes"] == ["NETWORK", "CRYPTO"]


def test_class_aggregates_follow_the_reference():
    rows = [(n, cls, rel) for n, cls, rel in (
        ("a", ("CPU",), 2.0), ("b", ("CPU", "MEMORY"), 0.5),
        ("c", ("MEMORY",), 4.0), ("d", ("OS",), None))]

    def stream(R):
        return [R("stressors.suite", n, "bogo_ops_per_sec", 1.0,
                  relative=rel, params={"classes": list(c)})
                for n, c, rel in rows]
    ours = classes.aggregate(stream(Record))
    theirs = jclasses.aggregate(stream(JRecord))
    assert [(r.name, r.value, r.params) for r in ours] == \
        [(r.name, r.value, r.params) for r in theirs]
    assert classes.significant_classes(ours) == \
        jclasses.significant_classes(theirs)
    assert [r.name for r in classes.ranking(stream(Record))] == \
        [r.name for r in jclasses.ranking(stream(JRecord))]


# ---------------------------------------------------------------------------
# headroom
# ---------------------------------------------------------------------------

def _schema(records):
    return [(r.experiment, r.name, r.metric, r.unit, sorted(r.params),
             r.relative is None) for r in records]


def test_transfer_sweep_schema_is_the_reference():
    kw = dict(message_bytes=[4096, 1 << 16], workers=[1, 2], duration=0.0,
              experiment="headroom.transfer_nic")
    ours = headroom.transfer_sweep(**kw, device="cpu")
    assert _schema(ours) == _schema(jheadroom.transfer_sweep(**kw))
    assert all(r.value > 0 for r in ours)
    assert ours[0].params["workers"] == 1


def test_delay_sweep_schema_and_summary_are_the_reference():
    kw = dict(message_bytes=1 << 16, matmul_sizes=[16, 48], duration=0.0)
    ours = headroom.delay_sweep(**kw, device="cpu")
    theirs = jheadroom.delay_sweep(**kw)
    assert _schema(ours) == _schema(theirs)
    s, t = headroom.sweep_summary(ours), jheadroom.sweep_summary(theirs)
    assert sorted(s) == sorted(t)
    assert s["knee_matmul"] in (0, 16, 48)


@pytest.mark.parametrize("terms", [(0.010, 0.004, 0.018),
                                   (0.03, 0.004, 0.002),
                                   (0.01, 0.05, 0.002), (0.0, 0.0, 0.0)])
def test_derived_headroom_is_the_reference(terms):
    ours = headroom.derived_headroom(headroom.RooflineTerms(*terms),
                                     peak_flops=197e12)
    theirs = jheadroom.derived_headroom(jheadroom.RooflineTerms(*terms),
                                        peak_flops=197e12)
    assert ours == theirs
    # the default peak is the card's: the H100 SXM's dense bf16 rate
    card = headroom.derived_headroom(headroom.RooflineTerms(*terms))
    assert card["free_offload_gflops"] == pytest.approx(
        ours["headroom_s"] * 989e12 / 1e9)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_planner_knobs_are_the_reference_values():
    for knob in ("serve_headroom_min_gflops", "fabric_p99_inflation_max",
                 "serve_slo_attainment_min"):
        assert runtime.policy()[knob] == jruntime.policy()[knob], knob


def _stress(R):
    return [R("stressors.suite", "quant-int8", "bogo_ops_per_sec", 100.0,
              relative=2.0, params={"classes": ["CRYPTO"]}),
            R("stressors.suite", "memrate-64m", "bogo_ops_per_sec", 50.0,
              relative=0.5, params={"classes": ["MEMORY"]})]


def _eff(R, method, cond, eff, wall_s):
    return R("fabric.collectives_degraded", f"{method}[{cond}]",
             "overlap_efficiency", eff, unit="x",
             params={"method": method, "condition": cond,
                     "t_serial_s": wall_s})


def _tail(R, cond, metric, x):
    return R("fabric.serve_tail", cond, metric, x, unit="x",
             params={"condition": cond})


def _serve(R):
    return [R("serve.load_sweep", "load_050", "headroom_flops_per_s", 5e9,
              params={"sustained": True}),
            R("serve.load_sweep", "load_200", "headroom_flops_per_s", 0.0,
              params={"sustained": False}),
            R("serve.slo_sweep", "load_050", "slo_attainment", 0.95,
              params={"rank": 0, "slo_class": "interactive",
                      "sustained": True}),
            R("serve.slo_sweep", "load_100", "slo_attainment", 0.7,
              params={"rank": 0, "slo_class": "interactive",
                      "sustained": True}),
            R("serve.slo_sweep", "load_050", "slo_attainment", 0.5,
              params={"rank": 1, "slo_class": "batch", "sustained": True})]


COLL, COMP, MEM = (0.01, 0.004, 0.02), (0.03, 0.004, 0.002), \
    (0.01, 0.05, 0.002)
# (terms, keywords built from a Record class) — test_core_feature.py's
# planner rules, test_fabric.py's degraded-fabric cases, a serving stream
PLAN_CASES = {
    "collective": (COLL, lambda R: {}),
    "compute": (COMP, lambda R: {}),
    "memory": (MEM, lambda R: {}),
    "single_pod": (COLL, lambda R: {"multi_pod": False,
                                    "grad_bytes": 4e9}),
    "overlap_earned": (COLL, lambda R: {"grad_bytes": 3 * (4 << 20)}),
    "rule_1b_withdrawn": (COLL, lambda R: {
        "grad_bytes": 3 * (4 << 20), "fabric_records": [
            _eff(R, "ring", "clean", 0.88, 1.0),
            _eff(R, "ring", "jitter", 0.99, 9.0),
            _eff(R, "ring", "straggler", 1.01, 30.0)]}),
    "rule_1_withdrawn": (COLL, lambda R: {"fabric_records": [
        _eff(R, "ring", "clean", 0.9, 1.0e-3),
        _eff(R, "int8_ring", "clean", 0.9, 0.8e-3),
        _eff(R, "ring", "straggler", 0.9, 10e-3),
        _eff(R, "int8_ring", "straggler", 0.9, 14e-3)]}),
    "rule_5_withdrawn": (COLL, lambda R: {
        "serve_records": _serve(R)[:1], "fabric_records": [
            _tail(R, "clean", "ttft_p99_inflation_x", 1.0),
            _tail(R, "jitter", "ttft_p99_inflation_x", 48.0),
            _tail(R, "jitter", "tpot_p99_inflation_x", 4.3)]}),
    "headroom_clause": (COLL, lambda R: {
        "serve_records": _serve(R)[:1], "fabric_records": [
            R("fabric.serve_tail", c, "headroom_flops_per_s", v,
              params={"condition": c})
            for c, v in (("clean", 5e9), ("jitter", 0.2e9))]}),
    "serve_slo": (COLL, lambda R: {"serve_records": _serve(R)}),
    "serve_headroom_only": (COMP, lambda R: {
        "serve_records": _serve(R)[:2]}),
    "memory_pressure": (COMP, lambda R: {"bytes_per_device": 15e9,
                                         "hbm_bytes": 16e9}),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_make_plan_reaches_the_reference_decisions(case):
    terms, kw = PLAN_CASES[case]
    ours = planner.make_plan(headroom.RooflineTerms(*terms), _stress(Record),
                             **kw(Record))
    theirs = jplanner.make_plan(jheadroom.RooflineTerms(*terms),
                                _stress(JRecord), **kw(JRecord))
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    # the first note names the free GFLOP at the default peak: the card's
    # 989 TFLOP/s here, the reference's TPU rate there
    na, nb = a.pop("notes"), b.pop("notes")
    assert a == b
    assert na[1:] == nb[1:]
    assert na[0].split(" (")[0] == nb[0].split(" (")[0]


def test_make_plan_memory_default_is_the_card():
    """``hbm_bytes`` defaults to the H100's 80 GB: 15 GB a device is
    memory pressure on the reference's 16-GB default, not on the card."""
    t = headroom.RooflineTerms(*COMP)
    assert planner.make_plan(t, [], bytes_per_device=15e9).microbatches == 1
    assert planner.make_plan(t, [], bytes_per_device=61e9).microbatches == 2
    assert jplanner.make_plan(jheadroom.RooflineTerms(*COMP), [],
                              bytes_per_device=15e9).microbatches == 2


# ---------------------------------------------------------------------------
# launch/train.py --plan
# ---------------------------------------------------------------------------

def test_train_cli_plans_and_trains(tmp_path, capsys):
    from repro_torch.launch import train
    terms = tmp_path / "terms.json"
    terms.write_text(json.dumps({"compute_s": 0.03, "memory_s": 0.004,
                                 "collective_s": 0.002}))
    hist = train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "32", "--plan", str(terms), "--ckpt-dir",
                       str(tmp_path / "ckpt")], device="cpu")
    out = capsys.readouterr().out
    assert "[plan]" in out and "bottleneck=compute" in out
    assert "dots_saveable" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_train_cli_plan_needs_the_card(tmp_path, monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    terms = tmp_path / "terms.json"
    terms.write_text(json.dumps({"compute_s": 1, "memory_s": 1,
                                 "collective_s": 1}))
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--smoke", "--steps", "1", "--plan", str(terms)])
