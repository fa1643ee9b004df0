"""The serving characterization (``repro_torch.core.serving``,
``repro_torch.core.fabric``) and the degraded-fabric hook
(``repro_torch.fabric``) against the reference's.

Each ported family runs at ``width="smoke"`` on the CPU with a tiny
``duration`` beside the reference's function called with the same
arguments.  Their timings differ by nature; what must not differ is the
stream's shape — the ``(experiment, name, metric, unit)`` key set — and
the rows that are arithmetic: the page-granular byte model, the probe's
FLOP count, and the engine comparison's token counts.
The fabric hook gives the reference's stall sequence on a virtual clock
for every canonical condition, drags every decode tick under the
straggler, and the serve CLI's ``--fabric`` takes each condition.
"""
import numpy as np
import pytest
import torch

from repro.core import fabric as jfabric
from repro.core import serving as jserving
from repro.fabric import ServeFabric as JServeFabric
from repro.fabric import canonical_conditions as j_canonical_conditions
from repro_torch.configs import all_archs, smoke
from repro_torch.core import fabric, serving
from repro_torch.fabric import ServeFabric, canonical_conditions
from repro_torch.models import registry
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.scheduler import ServeRequest

CONDITIONS = ("clean", "jitter", "straggler", "lossy", "throttle")
# family -> (port function, reference function, arguments of both)
FAMILIES = {
    "load_sweep": (serving.load_sweep, jserving.load_sweep, dict(
        duration=0.0, offered=(0.5, 2.0), n_slots=2, max_new=4,
        max_requests=4)),
    "paged_sweep": (serving.paged_sweep, jserving.paged_sweep, dict(
        duration=0.0, n_seqs=4, kv_tokens=64, offered=(1.0,), max_new=4,
        max_requests=4)),
    "slo_sweep": (serving.slo_sweep, jserving.slo_sweep, dict(
        duration=0.0, offered=(0.5, 4.0), max_requests=8)),
    "timeline": (serving.timeline, jserving.timeline, dict(
        duration=0.0, offered=(0.5, 1.0), max_requests=4)),
    "continuous_vs_static": (serving.continuous_vs_static,
                             jserving.continuous_vs_static, dict(
                                 duration=0.0, batch=2, n_requests=4)),
    "serve_tail": (fabric.measure_serve_tail, jfabric.measure_serve_tail,
                   dict(duration=0.0, conditions=CONDITIONS,
                        max_requests=4)),
}

_RUNS: dict = {}


def _runs(family):
    """(port records, reference records) of one family, made once."""
    if family not in _RUNS:
        ours, theirs, kw = FAMILIES[family]
        _RUNS[family] = (ours(device="cpu", **kw), theirs(**kw))
    return _RUNS[family]


def _by_key(records):
    return {(r.experiment, r.name, r.metric): r for r in records}


def _keys(records):
    """The stream's ``(experiment, name, metric, unit)`` keys, less a
    timeline level's idle span: only a gap in the traffic makes one."""
    return {(r.experiment, r.name, r.metric, r.unit) for r in records
            if not r.name.endswith(".idle")}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_emits_the_reference_record_keys(family):
    ours, theirs = _runs(family)
    assert not any(r.error or r.skipped for r in ours + theirs)
    assert _keys(theirs) and _keys(ours) == _keys(theirs), (
        sorted(_keys(theirs) - _keys(ours)),
        sorted(_keys(ours) - _keys(theirs)))


def test_deterministic_rows_equal_the_reference():
    ours, theirs = map(_by_key, _runs("paged_sweep"))
    pages = [k for k in theirs if k[2] == "kv_bytes_per_token"]
    assert len(pages) == len(serving.PAGED_PAGE_SIZES)
    for k in pages:
        assert ours[k].value == theirs[k].value
        assert ours[k].relative == theirs[k].relative
        assert ours[k].params["ideal_bytes_per_token"] \
            == theirs[k].params["ideal_bytes_per_token"]
    for family in ("load_sweep", "paged_sweep", "slo_sweep"):
        ours, theirs = map(_by_key, _runs(family))
        idle = [k for k in theirs if k[1] == "probe_idle"]
        assert idle and all(ours[k].params["probe_flops"]
                            == theirs[k].params["probe_flops"]
                            == serving.PROBE_ITERS * 2 * serving.PROBE_DIM ** 3
                            for k in idle)
    ours, theirs = map(_by_key, _runs("continuous_vs_static"))
    for k in theirs:
        for p in ("tokens", "max_new_mix", "n_requests"):
            assert ours[k].params[p] == theirs[k].params[p], (k, p)


def test_serve_fabric_stalls_are_the_reference_sequence():
    """On a virtual clock, each canonical condition's admission and decode
    stalls, drawn in the engine's call order, are the reference's."""
    canon, jcanon = canonical_conditions(), j_canonical_conditions()
    assert list(canon) == list(jcanon) == list(CONDITIONS)
    for name in CONDITIONS:
        slept = {"port": [], "ref": []}
        fab = ServeFabric(canon[name], sleep=slept["port"].append)
        jfab = JServeFabric(jcanon[name], sleep=slept["ref"].append)
        seq = [(f.stall_admit() if i % 5 == 0 else f.stall_decode())
               for f in (fab, jfab) for i in range(60)]
        assert seq[:60] == seq[60:], name
        assert slept["port"] == slept["ref"]
        assert fab.stalled_s == jfab.stalled_s
        assert fab.is_clean == (name == "clean") == (fab.total_stalled_s()
                                                     == 0.0)


@pytest.fixture(scope="module")
def fabric_engine():
    cfg = smoke(all_archs()["olmo-1b"])
    gen = torch.Generator()
    gen.manual_seed(0)
    params = registry.init_params(cfg, gen)
    tick = {"t": 0.0}

    def vclock():
        tick["t"] += 1e-4
        return tick["t"]

    eng = ContinuousEngine(cfg, params, n_slots=2, cache_len=64,
                           block_size=8, clock=vclock, device="cpu")
    return cfg, eng, tick


def _reqs(cfg, n=4):
    return [ServeRequest(prompt=(np.arange(8, dtype=np.int32) + i)
                         % cfg.vocab_size, max_new_tokens=4)
            for i in range(n)]


def test_straggler_inflates_every_decode_tick(fabric_engine):
    """As ``tests/test_fabric.py``: the straggler term lands on each
    decode tick (a batched step moves at its slowest device's pace), the
    stall is accounted under 'decode', and the tokens do not move."""
    cfg, eng, tick = fabric_engine
    clean = eng.generate(_reqs(cfg))
    reqs = _reqs(cfg)
    fab = ServeFabric(canonical_conditions()["straggler"],
                      sleep=lambda s: tick.__setitem__("t", tick["t"] + s))
    eng.fabric = fab
    eng.generate(reqs)
    eng.fabric = None
    assert fab.stalled_s["decode"] > 0.0 and fab.stalled_s["admit"] == 0.0
    assert min(t for r in reqs for t in r.decode_token_s) >= 8e-3
    assert max(t for r in clean for t in r.decode_token_s) < 8e-3
    assert [r.generated for r in reqs] == [r.generated for r in clean]


@pytest.mark.parametrize("name", CONDITIONS)
def test_cli_serves_under_each_condition(name, capsys):
    from repro_torch.launch import serve
    serve.main(["--requests", "3", "--max-new", "4", "--fabric", name],
               device="cpu")
    out = capsys.readouterr().out
    assert out.count("[serve] req ") == 3
    assert "continuous: 3 requests, 12 tokens" in out
    line = [x for x in out.splitlines() if x.startswith("[serve] fabric")]
    if name == "clean":
        assert line == []
    else:
        cond = canonical_conditions()[name]
        assert line[0].startswith(f"[serve] fabric '{name}': "
                                  f"{cond.describe()} — injected ")
        assert line[0].endswith("into decode ticks")


def test_overloaded_level_reports_zero_completions(fabric_engine):
    """As ``tests/test_serve_slo.py``: a level whose deadline expires
    before any completion emits ``completed=0`` rows and no percentile
    rows, not a crash."""
    cfg, _, _ = fabric_engine
    gen = torch.Generator()
    gen.manual_seed(0)
    eng = ContinuousEngine(cfg, registry.init_params(cfg, gen), n_slots=2,
                           cache_len=32, block_size=8, device="cpu")
    recs = serving._offered_sweep(eng, cfg, "serve.load_sweep",
                                  {"arch": cfg.name}, duration=0.0,
                                  offered=(4.0,), prompt_lens=(8,),
                                  max_new=2, max_requests=4,
                                  run_deadline_s=0.0)
    assert not any(r.error for r in recs)
    lvl = {r.metric: r for r in recs if r.name == "load_4x"}
    assert lvl["tokens_per_sec"].value == 0.0
    assert lvl["tokens_per_sec"].params["completed"] == 0
    assert not lvl["tokens_per_sec"].params["sustained"]
    assert "ttft_p50_s" not in lvl and "tpot_p50_s" not in lvl
    assert "headroom_flops_per_s" in lvl


def test_width_and_the_multi_rank_families():
    assert serving._config("olmo-1b", "full") == all_archs()["olmo-1b"]
    assert serving._config("olmo-1b", "smoke") \
        == smoke(all_archs()["olmo-1b"])
    with pytest.raises(ValueError, match="width"):
        serving._config("olmo-1b", "half")
    # tensor-parallel decode runs over ranks (tests/test_torch_tp.py runs
    # the sweep over 4): one is refused before any rank starts
    with pytest.raises(RuntimeError, match="needs a tensor-parallel axis"):
        serving.sharded_sweep(duration=0.0, device="cpu")
    # the degraded-collectives family runs over ranks (tests/
    # test_torch_experiments.py runs it over 4): fewer than 2 is refused
    # before any rank starts
    with pytest.raises(RuntimeError, match="needs >= 2 ranks"):
        fabric.measure_collectives_degraded(duration=0.0, devices=1,
                                            device="cpu")
    with pytest.raises(ValueError, match="unknown fabric condition"):
        serving.slo_sweep(duration=0.0, offered=(),
                          fabric_condition="no-such-wire", device="cpu")
