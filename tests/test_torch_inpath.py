"""The port's in-path transform measurements (``repro_torch.core.inpath``)
and the stream-concurrent schedules (``parallel/overlap.py``) against the
JAX package, on the CPU.

``measure``, ``measure_bucketing`` and ``measure_headroom_overlap`` run
at the reference's sizes over 4 pods: the port's pods are emulated on
one device, the reference's are 4 forced host devices, so the
reference's side comes from ONE JAX subprocess that writes its records'
schemas, its chain counts and the values each arm computed to an
``.npz``.  Both sides draw their inputs from the same numpy generator,
and both time nothing: ``_measure`` and ``_paired_ratio`` are replaced
by one call of each arm whose outputs are kept.

Tolerances, as ``tests/test_torch_collectives.py`` states them: ``stock``
and ``ring`` are exact; the int8 methods within one int8 step of the last
quantization (XLA on the CPU fuses ``acc + q*s`` into a fused
multiply-add, which can move one rounding).  The synthetic compute (f32
matmuls and ``tanh``) within 2e-5 relative to its largest value.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import inpath as jinpath
from repro_torch.core import inpath
from repro_torch.experiments.measure import Measurement
from repro_torch.parallel import collectives, overlap
from repro_torch.parallel.pods import PodAxis

ROOT = Path(__file__).resolve().parents[1]
N = 4
EPS32 = float(np.finfo(np.float32).eps)
TOL_F32 = 2e-5
METHODS = ("stock", "ring", "int8_a2a", "int8_ring", "int8_pairwise")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_wire_bytes_are_the_reference_model(method, n):
    for size in (1 << 10, 1 << 18, 1_000_003):
        assert inpath._wire_bytes(n, size, method) == \
            jinpath._wire_bytes(n, size, method)
    with pytest.raises(ValueError):
        inpath._wire_bytes(n, 64, "carrier_pigeon")


SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.core import inpath
from repro.experiments.measure import Measurement
rng = np.random.default_rng(0)
jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.asarray(
    rng.standard_normal(shape).astype(np.float32), dtype)
outs = []
def once(fn, duration):
    outs.append(jax.device_get(fn()))
    return Measurement(1.0, 1, 1.0, 1.0, 1.0, 1.0)
def paired(f_serial, f_over, args, duration, calls=2):
    outs.append(jax.device_get(f_serial(*args)))
    outs.append(jax.device_get(f_over(*args)))
    return 1.0, 1.0, 1.0, 3
inpath._measure, inpath._paired_ratio = once, paired
records = (inpath.measure(size=1 << 18, duration=0.0)
           + inpath.measure_bucketing(duration=0.0)
           + inpath.measure_headroom_overlap(duration=0.0))
flat = {}
def put(prefix, v):
    if isinstance(v, dict):
        for k, x in v.items():
            put(f"{prefix}/{k}", x)
    elif isinstance(v, (tuple, list)):
        for i, x in enumerate(v):
            put(f"{prefix}/{i}", x)
    else:
        flat[prefix] = np.asarray(v)
for i, o in enumerate(outs):
    put(f"out{i}", o)
flat["records"] = np.array(json.dumps([
    {"experiment": r.experiment, "name": r.name, "metric": r.metric,
     "unit": r.unit, "relative_none": r.relative is None,
     "params": sorted(r.params),
     "chains": r.params.get("collective_chains"),
     "wire": r.params.get("wire_bytes_per_device"),
     "devices": r.params.get("devices"),
     "quant_impl": r.params.get("quant_impl")} for r in records]))
np.savez(sys.argv[1], **flat)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "inpath.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                         env=env, capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ported():
    """The port's records and arm outputs, on the same inputs, untimed."""
    rng = np.random.default_rng(0)
    outs = []

    def once(fn, duration):
        outs.append(fn())
        return Measurement(1.0, 1, 1.0, 1.0, 1.0, 1.0)

    def paired(f_serial, f_over, args, duration, calls=2):
        outs.append(f_serial(*args))
        outs.append(f_over(*args))
        return 1.0, 1.0, 1.0, 3

    saved = inpath._normal, inpath._measure, inpath._paired_ratio
    inpath._normal = lambda gen, shape: torch.tensor(
        rng.standard_normal(shape).astype(np.float32))
    inpath._measure, inpath._paired_ratio = once, paired
    try:
        records = (inpath.measure(size=1 << 18, duration=0.0, device="cpu")
                   + inpath.measure_bucketing(duration=0.0, device="cpu")
                   + inpath.measure_headroom_overlap(duration=0.0,
                                                     device="cpu"))
    finally:
        inpath._normal, inpath._measure, inpath._paired_ratio = saved
    return records, outs


def _held(got, want, method):
    """``got`` against ``want`` by the method's tolerance."""
    got = got.detach().numpy().reshape(want.shape)
    if method in ("stock", "ring"):
        assert (got == want).all(), method
        return
    step = np.abs(want).max() / 127 * 1.01
    diff = np.abs(got - want)
    assert diff.max() <= step, (method, diff.max(), step)
    assert (diff > 4 * EPS32 * np.abs(want).max()).mean() < 0.01, method


def test_records_are_the_reference_schema(reference, ported):
    want = json.loads(str(reference["records"]))
    records, _ = ported
    assert len(records) == len(want) == 5 + 2 + 6
    for r, w in zip(records, want):
        assert (r.experiment, r.name, r.metric, r.unit,
                r.relative is None, sorted(r.params)) == \
            (w["experiment"], w["name"], w["metric"], w["unit"],
             w["relative_none"], w["params"])
        assert r.params.get("wire_bytes_per_device") == w["wire"]
        assert r.params.get("collective_chains") == w["chains"]
        assert r.params.get("devices") == w["devices"] == N
        if w["quant_impl"] is not None:      # the reference's "xla" pin is
            assert (r.params["quant_impl"], w["quant_impl"]) == \
                ("torch", "xla")             # the port's plain version
        if "max_error" in r.params:
            assert np.isfinite(r.params["max_error"])


def test_collectives_arms_match_the_reference(reference, ported):
    """``inpath.measure``: the five methods' outputs, every rank's."""
    _, outs = ported
    for i, method in enumerate(METHODS):
        want = reference[f"out{i}"]
        assert want.shape == (N, 1 << 18)
        _held(outs[i], want, method)


def test_bucketing_arms_match_the_reference(reference, ported):
    _, outs = ported
    for i in (5, 6):                         # leafwise, bucketed
        for name, size in jinpath.BUCKETING_LEAF_SIZES.items():
            want = reference[f"out{i}/{name}"]
            assert want.shape == (N, size)
            _held(outs[i][name], want, "int8_ring")


def test_headroom_overlap_arms_match_the_reference(reference, ported):
    _, outs = ported
    idle = reference["out7"]
    assert idle.shape == (N, 192, 192)
    scale = np.abs(idle).max()
    assert np.abs(outs[7].numpy() - idle).max() <= TOL_F32 * scale
    for j, method in enumerate(jinpath.OVERLAP_METHODS):
        for arm in (0, 1):                   # serial, overlapped
            k = 8 + 2 * j + arm
            red, comp = outs[k]
            for leaf in red:
                _held(red[leaf], reference[f"out{k}/0/{leaf}"], method)
            w = reference[f"out{k}/1"]
            assert np.abs(comp.numpy() - w).max() <= TOL_F32 * scale
        # the two arms of the port: the same values, bit for bit
        (r0, c0), (r1, c1) = outs[8 + 2 * j], outs[9 + 2 * j]
        assert all(torch.equal(r0[k], r1[k]) for k in r0), method
        assert torch.equal(c0, c1), method


def test_stock_arm_writes_every_rank():
    """``PodAxis.pmean`` is a broadcast view; the measured stock arm
    writes a full ``(n, size)`` result, as the reference's does."""
    seen = []
    saved = inpath._measure
    inpath._measure = lambda fn, duration: (
        seen.append(fn()), Measurement(1.0, 1, 1.0, 1.0, 1.0, 1.0))[1]
    try:
        inpath.measure(size=1 << 10, duration=0.0, device="cpu")
    finally:
        inpath._measure = saved
    assert seen[0].shape == (N, 1 << 10)
    assert seen[0].stride() == (1 << 10, 1)
    assert PodAxis(N).pmean(torch.ones(N, 8)).stride(0) == 0


def test_overlap_compute_arms_are_equal():
    rng = np.random.default_rng(4)
    tree = {f"w{i}": torch.tensor(rng.standard_normal((N, 70_000))
                                  .astype(np.float32)) for i in range(3)}
    a = torch.tensor(rng.standard_normal((N, 32, 32)).astype(np.float32))
    for method in jinpath.OVERLAP_METHODS:
        outs = [inpath.overlap_step(PodAxis(N), method, ov, 70_000, 3)(
            tree, a) for ov in (False, True)]
        (r0, c0), (r1, c1) = outs
        assert all(torch.equal(r0[k], r1[k]) for k in r0)
        assert torch.equal(c0, c1)
    seen = []
    r, c = overlap.overlap_compute(lambda: seen.append("collective") or 1,
                                   lambda x: seen.append("compute") or x + 1,
                                   torch.zeros(2), overlap=True)
    assert seen == ["collective", "compute"] and r == 1   # CPU: in order
    assert torch.equal(c, torch.ones(2))


@pytest.mark.parametrize("method", ["int8_ring", "int8_a2a", "ring"])
def test_pipelined_and_serial_reductions_are_bit_equal(method):
    """The two schedules of ``reduce_gradients`` (the same chains in
    another order) give the same values and residuals, bit for bit."""
    rng = np.random.default_rng(6)
    sizes = (300_000, 70_000, 5_000, 262_147)
    g = {f"w{i}": torch.tensor(rng.standard_normal((N, s)),
                               dtype=torch.float32)
         for i, s in enumerate(sizes)}
    arms = [collectives.reduce_gradients(g, PodAxis(N), method,
                                         bucket_bytes=1 << 20, overlap=ov)
            for ov in (False, True)]
    for k in g:
        assert torch.equal(arms[0][0][k], arms[1][0][k])
        assert torch.equal(arms[0][1][k], arms[1][1][k])


def test_stream_helpers_find_cuda_tensors_only():
    nested = (1, [torch.zeros(2)], {"a": torch.ones(3)})
    assert [t.numel() for t in overlap._tensors(nested)] == [2, 3]
    assert overlap._cuda_device(nested) is None
    overlap._used_on(nested, None)          # CPU tensors: nothing to mark


@pytest.mark.parametrize("size", [1 << 17, 1 << 18])
def test_chip_smoke_derives_the_phase_k3_launches(size, monkeypatch):
    """The K3 count ``chip_smoke.py``'s ``offload_families`` phase holds
    the kernels to — derived from every chain it issues, its payload and
    the policy at the call — is the number of times the in-path families
    route to the kernel wrappers (counted here on the CPU, where the
    wrappers run their plain versions)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import quant
    calls = {"q": 0, "d": 0}
    rq, rd = quant.quantize_int8, quant.dequantize_int8
    monkeypatch.setattr(quant, "quantize_int8", lambda x: calls.__setitem__(
        "q", calls["q"] + 1) or rq(x))
    monkeypatch.setattr(quant, "dequantize_int8",
                        lambda q, s, dt: calls.__setitem__(
                            "d", calls["d"] + 1) or rd(q, s, dt))
    with chip_smoke.derived_quant_launches() as derived:
        inpath.measure(size=size, duration=0.0, device="cpu")
        inpath.measure_bucketing(duration=0.0, device="cpu")   # pinned
    assert (calls["q"], calls["d"]) == tuple(derived) and min(derived) > 0
    assert collectives.compressed_psum.__name__ == "compressed_psum"
