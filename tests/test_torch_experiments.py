"""The port's Experiment API (``repro_torch.experiments``): the
counterparts of ``tests/test_experiments.py`` — the measurement harness,
Record JSON/CSV emission, the registry and its SKIP semantics, the
Runner's error records, stamps and persisted streams, the CLI's exit
codes and the stream diff — plus what the port does differently: the
CUDA synchronisation of ``measure``, the environment stamp (backend,
card and power limit), the built-in registrations of the ported families,
and ``--devices``: the ranks the multi-rank families start."""
import importlib
import io
import json
import subprocess
import types

import pytest
import torch

from repro_torch.experiments import (Record, Runner, all_experiments,
                                     experiment, measure, read_csv,
                                     read_jsonl, select, write_csv,
                                     write_jsonl)
from repro_torch.experiments import registry as reg
from repro_torch.experiments import runner as runner_mod
from repro_torch.experiments.__main__ import main

# the module, not the function the package exports under its name
measure_mod = importlib.import_module("repro_torch.experiments.measure")

OFFLOAD = {"headroom.transfer_nic", "headroom.transfer_host",
           "headroom.delay_sweep", "stressors.suite", "classes.aggregate",
           "inpath.collectives", "inpath.bucketing",
           "inpath.headroom_overlap"}
# over pods emulated on one device: the reference's need two devices
EMULATED_RANKS = {"inpath.collectives", "inpath.bucketing",
                  "inpath.headroom_overlap"}
PORTED = {"serve.load_sweep", "serve.paged_attention", "serve.slo_sweep",
          "serve.timeline", "serve.continuous_vs_static",
          "fabric.serve_tail"} | OFFLOAD
MULTI_RANK = {"serve.sharded_sweep", "fabric.collectives_degraded"}


# ---------------------------------------------------------------------------
# measurement harness
# ---------------------------------------------------------------------------

def test_measure_zero_duration_regression():
    calls = []
    m = measure(lambda: calls.append(1), duration=0.0)
    assert m.n >= 1
    assert len(calls) >= 2  # warmup + at least one timed call
    assert m.calls_per_sec > 0
    assert m.p10_s <= m.median_s <= m.p90_s


def test_measure_counts_calls():
    m = measure(lambda: None, duration=0.02, warmup=0)
    assert m.n > 1
    assert m.total_s >= 0.02


def test_measure_synchronizes_the_card(monkeypatch):
    """A CUDA result means CUDA is initialised: ``measure`` then waits
    with ``torch.cuda.synchronize`` after the warm-up and after the timed
    calls (without it, it would time launches); a process that never
    touched the card syncs nothing."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(1))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    measure(lambda: torch.zeros(1), duration=0.0)
    assert synced == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    m = measure(lambda: torch.zeros(1), duration=0.0)
    assert synced == [1, 1] and m.n >= 1
    measure_mod._sync(None)
    assert len(synced) == 3


# ---------------------------------------------------------------------------
# Record schema + emitters
# ---------------------------------------------------------------------------

def _sample_records():
    return [
        Record("fam.exp", "row1", "ops_per_sec", 123.5, unit="ops/s",
               relative=1.5, params={"classes": ["CPU"], "size": 4096},
               wall_time=1e9, elapsed_s=0.1),
        Record("fam.exp", "row2", "skip", skipped=True, reason="no devices"),
        Record("fam.other", "row3", "error", error=True, reason="boom"),
    ]


def test_record_jsonl_roundtrip():
    recs = _sample_records()
    buf = io.StringIO()
    write_jsonl(recs, buf)
    buf.seek(0)
    assert list(read_jsonl(buf)) == recs


def test_record_csv_roundtrip():
    recs = _sample_records()
    buf = io.StringIO()
    write_csv(recs, buf)
    buf.seek(0)
    back = list(read_csv(buf))
    assert len(back) == len(recs)
    assert back[0].value == pytest.approx(123.5)
    assert back[0].params == {"classes": ["CPU"], "size": 4096}
    assert back[1].skipped and back[1].reason == "no devices"
    assert back[2].error


# ---------------------------------------------------------------------------
# registry + SKIP semantics
# ---------------------------------------------------------------------------

@pytest.fixture
def temp_experiment():
    names = []

    def make(name, fn=None, **kw):
        fn = fn or (lambda *, duration, device=None:
                    [Record(name, "x", "m", 1.0)])
        experiment(name, **kw)(fn)
        names.append(name)
        return name

    yield make
    for n in names:
        reg.unregister(n)


def test_registry_roundtrip(temp_experiment):
    name = temp_experiment("zztest.alpha", classes=("CPU",), figure="Fig. 0")
    spec = reg.get(name)
    assert spec.name == name and spec.family == "zztest"
    assert spec.classes == ("CPU",)
    assert spec in all_experiments()
    assert [s.name for s in select(["zztest"])] == [name]
    assert [s.name for s in select([name])] == [name]
    with pytest.raises(ValueError):
        experiment(name)(lambda *, duration: [])


def test_runner_skips_on_unmet_device_requirement(temp_experiment):
    name = temp_experiment("zztest.needsmany", requires_devices=99)
    report = Runner(duration=0.0, only=[name], load_builtin=False,
                    records_dir=None, device="cpu").run()
    assert len(report.records) == 1
    r = report.records[0]
    assert r.skipped and not r.error and "99 devices" in r.reason
    assert report.ok


def test_runner_turns_exceptions_into_error_records(temp_experiment):
    def boom(*, duration):
        raise ValueError("broken rig")

    name = temp_experiment("zztest.boom", fn=boom)
    report = Runner(duration=0.0, only=[name], load_builtin=False,
                    records_dir=None).run()
    assert not report.ok
    assert report.errors[0].reason == "ValueError: broken rig"
    assert report.errors[0].experiment == name


def test_runner_emit_failures_propagate_not_recorded(temp_experiment):
    name = temp_experiment("zztest.emitboom")

    def emit(r):
        raise BrokenPipeError("consumer went away")

    with pytest.raises(BrokenPipeError):
        Runner(duration=0.0, only=[name], load_builtin=False,
               records_dir=None).run(emit=emit)


def test_runner_stamps_and_passes_the_device(temp_experiment):
    seen = []

    def fn(*, duration, device=None):
        seen.append(device)
        return [Record("zztest.dev", "x", "m", 1.0)]

    name = temp_experiment("zztest.dev", fn=fn)
    report = Runner(duration=0.0, only=[name], load_builtin=False,
                    records_dir=None, device="cpu").run()
    Runner(duration=0.0, only=[name], load_builtin=False,
           records_dir=None).run()
    assert seen == ["cpu", None]
    r = report.records[0]
    assert r.wall_time is not None and r.elapsed_s is not None
    sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                         text=True, cwd=runner_mod.os.path.dirname(
                             runner_mod.__file__)).stdout.strip()
    assert r.params.get("git_commit") == (sha or None)


def test_environment_stamp_fields(monkeypatch):
    """On the CPU: backend, one device, platform, hostname.  On the card
    also its name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    env = runner_mod._environment(runner_mod._device_count("cpu"), "cpu")
    assert env["backend"] == "cpu" and env["device_count"] == 1
    assert {"platform", "hostname"} <= set(env)
    assert "card" not in env and "power_limit" not in env

    def smi(cmd, **kw):
        assert cmd == ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"]
        return types.SimpleNamespace(
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", returncode=0)

    monkeypatch.setattr(runner_mod.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    env = runner_mod._environment(runner_mod._device_count("cuda"), "cuda")
    assert env["backend"] == "cuda" and env["device_count"] == 1
    assert env["card"] == "NVIDIA H100 80GB HBM3"
    assert env["power_limit"] == "700.00 W"


def test_builtin_registrations_are_the_ported_families():
    reg.load_builtin()
    names = {s.name for s in all_experiments()}
    assert PORTED | MULTI_RANK <= names
    assert "roofline" not in {s.family for s in all_experiments()}
    for name in PORTED:
        assert reg.get(name).requires_devices == 1
    for name in MULTI_RANK:
        assert reg.get(name).requires_devices == 2
    # the reference's names, figures and descriptions, and its device
    # requirement wherever the port's ranks are not emulated
    from repro.experiments import registry as jreg
    jreg.load_builtin()
    for name in PORTED | MULTI_RANK:
        ours, theirs = reg.get(name), jreg.get(name)
        assert (ours.classes, ours.figure, ours.description) == \
            (theirs.classes, theirs.figure, theirs.description)
        want = 2 if name in EMULATED_RANKS else ours.requires_devices
        assert theirs.requires_devices == want, name


def test_multi_rank_families_skip_on_one_device_and_run_over_ranks():
    report = Runner(duration=0.0, only=sorted(MULTI_RANK), records_dir=None,
                    device="cpu").run()
    assert report.ok and len(report.records) == 2
    assert all(r.skipped and "needs >= 2 devices, have 1" in r.reason
               for r in report.records)
    # over 4 ranks the Runner calls both: the degraded collectives run
    # (the CLI test below), and so does tensor-parallel decode over 4 rank
    # processes, its first row the decode tick's exchanges by kind
    report = Runner(duration=0.0, only=["serve.sharded_sweep"],
                    records_dir=None, device="cpu", devices=4).run()
    assert report.ok and not report.skips and not report.errors
    r = report.records[0]
    assert (r.name, r.metric) == ("decode_step", "collectives_per_step")
    assert r.params["per_kind"] == {"all-gather": 1.0, "all-reduce": 5.0}
    assert r.params["tp_size"] == r.params["n_devices"] == 4
    assert r.params["mesh_axes"] == {"data": 1, "model": 4}
    assert r.params["env"]["device_count"] == 4
    assert {x.name for x in report.records} >= {"probe_idle", "capacity",
                                                 "load_1x"}
    # the in-path families run their ranks on one device: the Runner
    # calls them there, where the reference's SKIP
    report = Runner(duration=0.0, only=["inpath.bucketing"],
                    records_dir=None, device="cpu").run()
    assert report.ok and not report.skips
    assert [r.name for r in report.records] == ["leafwise", "bucketed"]
    assert all(r.params["devices"] == 4 for r in report.records)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_serve_family_on_the_cpu(tmp_path):
    """The serve family end to end, records persisted nowhere: exit 0,
    SKIP rows for ``serve.sharded_sweep`` only, every ported family's
    records stamped for the CPU."""
    out = tmp_path / "serve.jsonl"
    rc = main(["--only", "serve", "--duration", "0.05", "--format", "jsonl",
               "--out", str(out), "--no-records"], device="cpu")
    assert rc == 0
    recs = list(read_jsonl(open(out)))
    skipped = {r.experiment for r in recs if r.skipped}
    assert skipped == {"serve.sharded_sweep"}
    assert not any(r.error for r in recs)
    assert {r.experiment for r in recs} == \
        {n for n in PORTED | MULTI_RANK if n.startswith("serve.")}
    assert all(r.params["env"]["backend"] == "cpu" for r in recs)


def test_cli_stressors_family_on_the_cpu(tmp_path):
    """``--only stressors`` on the CPU: every stressor has its row; the
    three NETWORK ones and ``jit-compile`` (no device compile service on
    the CPU) SKIP, nothing errs."""
    out = tmp_path / "stressors.jsonl"
    rc = main(["--only", "stressors", "--duration", "0.02", "--format",
               "jsonl", "--out", str(out), "--no-records"], device="cpu")
    assert rc == 0
    recs = list(read_jsonl(open(out)))
    assert {r.experiment for r in recs} == {"stressors.suite"}
    assert len(recs) == 30 and not any(r.error for r in recs)
    assert {r.name for r in recs if r.skipped} == {
        "allreduce", "all-to-all", "allreduce-int8", "jit-compile"}


def test_cli_list(capsys):
    assert main(["--list"]) == 0
    listed = {line.split()[0] for line in
              capsys.readouterr().out.splitlines()}
    assert listed == PORTED | MULTI_RANK


def test_cli_rejects_unknown_selection():
    assert main(["--only", "no.such.experiment"], device="cpu") == 2


def test_cli_runs_the_degraded_collectives_over_devices(capsys, tmp_path):
    """``--devices 4``: ``fabric.collectives_degraded`` over 4 gloo ranks,
    rows of the reference's names, metrics and keys (the injection
    value-neutral: ``max_error`` as clean); tensor-parallel decode runs
    over the same 4 ranks, no SKIP; ``--devices 0`` refused."""
    out = tmp_path / "f.jsonl"
    assert main(["--only", "fabric.collectives_degraded,serve.sharded_sweep",
                 "--devices", "4", "--duration", "0", "--format", "jsonl",
                 "--out", str(out), "--no-records"], device="cpu") == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert not any(r["skipped"] or r["error"] for r in rows)
    sharded = [r for r in rows if r["experiment"] == "serve.sharded_sweep"]
    assert sharded[0]["metric"] == "collectives_per_step"
    assert sharded[0]["params"]["tp_size"] == 4
    rows = [r for r in rows if r["experiment"] != "serve.sharded_sweep"]
    assert [(r["name"], r["metric"]) for r in rows] == [
        (f"{m}[{c}]", metric) for m in ("ring", "int8_ring")
        for c in ("clean", "jitter", "straggler", "lossy")
        for metric in ("overlap_efficiency", "degradation_x",
                       "wire_goodput_bytes_per_s")]
    assert not any(r["error"] for r in rows)
    for r in rows:
        p = r["params"]
        assert p["devices"] == 4 and p["n_buckets"] == 4
        assert {"t_serial_s", "t_overlapped_s", "injected_common_s",
                "paired_rounds", "wire_bytes_per_device",
                "fabric_straggler_device"} <= set(p)
        clean = next(q for q in rows if q["name"] == r["name"].split("[")[0]
                     + "[clean]" and q["metric"] == r["metric"])
        assert p["max_error"] == clean["params"]["max_error"]
    assert main(["--only", "serve", "--devices", "0"], device="cpu") == 2
    assert "need at least one" in capsys.readouterr().err


def test_cli_runs_on_the_card_or_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--only", "serve.timeline", "--no-records",
              "--out", str(tmp_path / "r.csv")])


def test_cli_nonzero_on_error(tmp_path, temp_experiment):
    def boom(*, duration, device):
        raise RuntimeError("rig fell over")

    name = temp_experiment("zztest.clifail", fn=boom)
    rc = main(["--only", name, "--duration", "0.0",
               "--out", str(tmp_path / "r.csv"), "--no-records"],
              device="cpu")
    assert rc == 1


# ---------------------------------------------------------------------------
# per-run Record persistence + diff
# ---------------------------------------------------------------------------

def test_runner_persists_jsonl_stream(tmp_path, temp_experiment):
    name = temp_experiment("zztest.persist")
    rdir = tmp_path / "records"
    report = Runner(duration=0.0, only=[name], load_builtin=False,
                    records_dir=str(rdir)).run()
    files = sorted(rdir.glob("run-*.jsonl"))
    assert [str(f) for f in files] == [report.records_path]
    assert list(read_jsonl(open(report.records_path))) == report.records


def test_runner_persisted_streams_get_distinct_paths(tmp_path,
                                                     temp_experiment):
    name = temp_experiment("zztest.persist2")
    rdir = str(tmp_path / "records")
    paths = {Runner(duration=0.0, only=[name], load_builtin=False,
                    records_dir=rdir).run().records_path for _ in range(3)}
    assert len(paths) == 3


def test_default_records_dir_is_the_ports_own():
    assert runner_mod.DEFAULT_RECORDS_DIR == "experiments/records_torch"


def _write(path, recs):
    with open(path, "w") as fh:
        write_jsonl(recs, fh)


def test_diff_cli_reports_per_experiment_deltas(tmp_path, capsys):
    old = [Record("fam.a", "r1", "ops", 100.0),
           Record("fam.a", "r2", "ops", 5.0),
           Record("fam.b", "r3", "ops", 1.0)]
    new = [Record("fam.a", "r1", "ops", 150.0),
           Record("fam.a", "r2", "ops", 5.0),
           Record("fam.b", "r3", "ops", 1.0, skipped=True),
           Record("fam.c", "r4", "ops", 9.0)]
    po, pn = tmp_path / "old.jsonl", tmp_path / "new.jsonl"
    _write(po, old)
    _write(pn, new)
    assert main(["diff", str(po), str(pn)]) == 0
    out = capsys.readouterr().out
    assert "fam.a:" in out and "r1.ops: 100 -> 150 (+50.0%)" in out
    assert "r2" not in out
    assert "skipped False -> True" in out
    assert "r4.ops: added (9)" in out
    assert main(["diff", "only-one.jsonl"]) == 2


def test_diff_thresholds_and_environment_refusal(tmp_path, capsys):
    """Thresholds gate by direction; a gated comparison across backends
    (a CPU stream against one from the card) is refused unless
    ``--ignore-env``."""
    cpu = {"backend": "cpu", "platform": "linux"}
    gpu = {"backend": "cuda", "platform": "linux"}
    old = [Record("serve.load_sweep", "capacity", "tokens_per_sec", 100.0,
                  params={"env": cpu})]
    slow = [Record("serve.load_sweep", "capacity", "tokens_per_sec", 40.0,
                   params={"env": cpu})]
    card = [Record("serve.load_sweep", "capacity", "tokens_per_sec", 40.0,
                   params={"env": gpu})]
    po, ps, pc = (tmp_path / f"{n}.jsonl" for n in ("old", "slow", "card"))
    _write(po, old)
    _write(ps, slow)
    _write(pc, card)
    gate = ["--threshold", "tokens_per_sec=-0.5"]
    assert main(["diff", str(po), str(ps), *gate]) == 1
    assert "THRESHOLD EXCEEDED" in capsys.readouterr().err
    assert main(["diff", str(po), str(ps), "--threshold",
                 "tokens_per_sec=+0.5"]) == 0
    assert main(["diff", str(po), str(pc), *gate]) == 2
    assert "refusing to gate thresholds across environments" \
        in capsys.readouterr().err
    assert main(["diff", str(po), str(pc), *gate, "--ignore-env"]) == 1
    assert main(["diff", str(po), str(ps), "--threshold", "nonsense"]) == 2


def test_records_are_json_lines(tmp_path, temp_experiment):
    name = temp_experiment("zztest.lines")
    out = tmp_path / "r.jsonl"
    assert main(["--only", name, "--format", "jsonl", "--out", str(out),
                 "--no-records"], device="cpu") == 0
    rows = [json.loads(line) for line in open(out)]
    assert rows[0]["experiment"] == name
    assert rows[0]["params"]["env"]["backend"] == "cpu"
