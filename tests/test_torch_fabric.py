"""Degraded-fabric injection into the gradient chains
(``fabric/inject.py``), on the CPU.

* ``ChainInjector`` samples the reference's delays: the common delay of
  every chain and the straggler's trips, for every canonical condition,
  at the same burn rate.
* The reference's guard (``tests/test_fabric.py``'s 4-device script, its
  four parts at its sizes) over 4 gloo ranks, one process a rank, and on
  the emulated ``PodAxis(4)``: clean and ``None`` bit-identical with equal
  exchange counts; under the straggler bit-identical outputs, equal
  counts, the burn on the straggler only, and a serial wall more than 3x
  the clean one; the single-bucket edge correct.  The burn is its plain
  loop here (the CUDA kernel runs on the card, ``chip_smoke.py``).
* Where ``run_schedule`` calls ``perturb`` in each schedule.
"""
import numpy as np
import pytest
import torch

from repro.fabric import canonical_conditions as j_canonical
from repro.fabric.inject import ChainInjector as JChainInjector
from repro_torch.fabric import ChainInjector, FabricCondition, \
    canonical_conditions
from repro_torch.fabric import inject
from repro_torch.kernels import burn as kburn
from repro_torch.parallel import dist, overlap, rank_bodies
from repro_torch.parallel.pods import PodAxis

N = 4
PAYLOADS = [4 << 12, 4 << 14, 4 << 20, 4 << 12]


@pytest.mark.parametrize("name", sorted(canonical_conditions()))
def test_injector_samples_the_reference_delays(name):
    ours = ChainInjector(canonical_conditions()[name], PodAxis(N), PAYLOADS,
                         rate=3e8)
    theirs = JChainInjector(j_canonical()[name], "pod", PAYLOADS, rate=3e8)
    assert ours.common_delays_s == theirs.common_delays_s
    assert ours.straggler_iters == theirs.straggler_iters
    assert ours.injected_s == theirs.injected_s
    assert ours._common_iters == theirs._common_iters


def test_plain_burn_is_the_loop_and_counts_trips_not_launches():
    trips, launches = kburn.TRIPS, kburn.LAUNCHES
    v = kburn.burn(1000, "cpu")
    want = np.float32(1.0)
    for _ in range(1000):
        want = want * np.float32(1.000000119) + np.float32(1e-9)
    assert v.dtype == torch.float32 and v.item() == want
    assert kburn.TRIPS - trips == 1000 and kburn.LAUNCHES == launches
    with pytest.raises(ValueError, match="iters >= 0"):
        kburn.burn(-1, "cpu")
    assert inject.stall(torch.ones(3), 0).sum() == 3


def _check_guard(res, straggler: bool):
    assert res["clean_identical"] and res["clean_counts_equal"]
    assert res["clean_burns"] == 0
    assert res["straggler_identical"] and res["straggler_counts_equal"]
    assert (res["straggler_trips"] > 0) == straggler, res
    assert res["single_bucket_ok"], res["single_bucket_err"]


@pytest.fixture(scope="module")
def ranks():
    return dist.run_ranks(rank_bodies.fabric_guard, N, backend="gloo",
                          device="cpu", timeout_s=600)


@pytest.mark.parametrize("rank", range(N))
def test_guard_over_ranks(rank, ranks):
    """Only rank ``straggler_device`` (1) burns; every rank waits for it:
    every rank's serial wall is more than 3x the clean one under a
    straggler that burns what the reference's does against its chains
    (``GUARD_SCALE`` clean segments a segment; the chains here are gloo
    exchanges between processes that share the CPU with the test run,
    whose walls swing with the load by more than the canonical 8 ms)."""
    res = ranks[rank]
    strag = canonical_conditions()["straggler"]
    assert res["rank"] == rank
    _check_guard(res, rank == strag.straggler_device)
    assert set(res["counts"]) == {"ring_shift", "all_gather"}
    assert res["straggler_delay_s"] >= strag.straggler_delay_s
    assert res["wall_ratio"] > 3.0, res


def test_guard_on_the_emulated_axis():
    res = rank_bodies.fabric_guard(PodAxis(N))
    _check_guard(res, True)
    assert res["counts"] == {"chains": 3}
    assert res["wall_ratio"] > 3.0, res


@pytest.mark.parametrize("pipelined", [False, True])
def test_perturb_sits_inside_each_schedule(pipelined):
    """Serial: pack i, perturb i, chain i.  Pipelined: perturb i right
    after pack i, on its stream, before chain i-1 — the reference's
    dependency structure (a burn waits only behind its own pack)."""
    log = []

    def pack(i):
        log.append(f"pack{i}")
        return torch.full((2,), float(i))

    def perturb(i, buf):
        log.append(f"perturb{i}")
        return buf

    def exchange(buf):
        log.append(f"chain{int(buf[0])}")
        return buf

    outs = overlap.run_schedule(3, pack, exchange, pipelined, perturb)
    assert [int(o[0]) for o in outs] == [0, 1, 2]
    if pipelined:
        assert log == ["pack0", "perturb0", "pack1", "perturb1", "chain0",
                       "pack2", "perturb2", "chain1", "chain2"]
    else:
        assert log == ["pack0", "perturb0", "chain0", "pack1", "perturb1",
                       "chain1", "pack2", "perturb2", "chain2"]


def test_a_clean_condition_never_calibrates(monkeypatch):
    monkeypatch.setattr(inject, "iters_per_second",
                        lambda *a, **k: pytest.fail("calibrated"))
    inj = ChainInjector(FabricCondition.clean(), PodAxis(N), PAYLOADS)
    buf = torch.ones(4)
    assert inj.perturb(0, buf) is buf
    assert inj.common_delays_s == [0.0] * len(PAYLOADS)
