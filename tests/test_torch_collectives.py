"""The port's int8 quantization (K3a/K3b) and gradient collectives against
the JAX package, on the CPU.

* The plain quantize/dequantize — what the CUDA kernels are held to on the
  card — is bit-equal to the reference's Pallas kernels in interpret mode.
* The bucket plan equals the reference's (a test tree and the full-width
  OLMo-1B tree).
* ``reduce_gradients`` over 4 emulated pods against the reference's
  ``shard_map`` over 4 forced host devices, every ``dp_method``, leafwise
  and bucketed, serial and pipelined, with error feedback, under the
  reference's ``quant_impl="auto"`` and ``"pallas"``.  The reference's
  outputs come from ONE JAX subprocess per module (4 host devices must be
  forced before JAX starts), saved to an ``.npz``.

Tolerances, with their reason: ``stock`` and ``ring`` are exact (adds in
the same order).  Where the reference dequantizes into a subtraction or a
sum (``x - q*s``, ``acc + q*s``), XLA on the CPU fuses the product into a
fused multiply-add, so the residual carries one rounding less: the port's
residual is within one f32 ulp of the largest payload value of the leaf,
and the reduced values within one int8 step of the last quantization
(a last-bit difference of a partial sum can move one rounding of its
requantization).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.parallel import buckets as jbuckets
from repro_torch import bridge, runtime
from repro_torch.configs import all_archs
from repro_torch.kernels import ops, quant, ref
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer
from repro_torch.parallel import buckets, collectives, overlap
from repro_torch.parallel.pods import PodAxis

ROOT = Path(__file__).resolve().parents[1]
N = 4
SHAPES = {"a": (64, 128), "b": (100,), "c": (130, 77), "d": (5001,),
          "e": (16384,)}
BUCKET_BYTES = 32 << 10     # 8192 f32: the test tree packs into 4 buckets
EPS32 = float(np.finfo(np.float32).eps)


def _inputs():
    """Every pod's gradients and error-feedback residuals, ``(N, *shape)``
    f32, from a numpy seed (the reference script builds the same)."""
    rng = np.random.default_rng(0)
    g = {k: (rng.standard_normal((N,) + s) * (1 + i)).astype(np.float32)
         for i, (k, s) in enumerate(SHAPES.items())}
    e = {k: (rng.standard_normal((N,) + s) * 0.01).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, e


# method, bucketed, overlap, the reference's quant_impl
CASES = [("stock", None, None, "auto")] + [
    (m, v != "leafwise", {"leafwise": None, "serial": False,
                          "pipelined": True}[v], "auto")
    for m in ("int8_a2a", "int8_ring", "int8_pairwise", "ring")
    for v in ("leafwise", "serial", "pipelined")] + [
    (m, v != "leafwise", {"leafwise": None, "pipelined": True}[v], "pallas")
    for m in ("int8_a2a", "int8_ring") for v in ("leafwise", "pipelined")]


def _name(case) -> str:
    return "-".join(str(c) for c in case)


SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import runtime
from repro.parallel import collectives as C, compat
sys.path.insert(0, os.path.dirname(sys.argv[2]))
from test_torch_collectives import (BUCKET_BYTES, CASES, N, SHAPES,
                                    _inputs, _name)
mesh = compat.make_mesh((N,), ("pod",))
g, e = _inputs()
glob = lambda t: {k: jnp.asarray(v.reshape((N * v.shape[1],) + v.shape[2:]))
                  for k, v in t.items()}
specs = {k: P("pod") for k in SHAPES}
out = {}
for case in CASES:
    m, bucketed, overlap, qi = case
    f = jax.jit(compat.shard_map(
        lambda t, er: C.reduce_gradients(t, "pod", m, er, bucketed=bucketed,
                                         bucket_bytes=BUCKET_BYTES,
                                         overlap=overlap),
        mesh=mesh, in_specs=(specs, specs), out_specs=(specs, specs),
        check=False))
    with runtime.use_policy(quant_impl=qi, pallas_interpret=True):
        C.reset_chain_count()
        f.lower(glob(g), glob(e))
        out[_name(case) + "/chains"] = np.int64(C.chain_count())
        red, res = f(glob(g), glob(e))
    for k in SHAPES:
        out[f"{_name(case)}/out/{k}"] = np.asarray(red[k])
        if m != "stock":
            out[f"{_name(case)}/res/{k}"] = np.asarray(res[k])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "collectives.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(path),
                          str(Path(__file__).resolve())],
                         env=env, capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# K3a / K3b: plain versions bit-equal to the Pallas kernels
# ---------------------------------------------------------------------------

def _quant_input(N_, C_, seed, kind):
    x = (np.random.default_rng(seed).standard_normal((N_, C_)) * 3).astype(
        np.float32)
    if kind == "special":
        x[0] = 0.0                                  # an all-zero row
        if N_ > 1:                                  # exact .5 ties: amax 127
            x[1] = (np.arange(C_) % 9 - 4.5).astype(np.float32)
            x[1, 0] = 127.0                         # -> scale exactly 1.0
        if N_ > 2:
            x[2] = -x[2]                            # negatives
    return x


@pytest.mark.parametrize("N_,C_,dtype,kind", [
    (300, 256, "float32", "random"), (130, 64, "float32", "special"),
    (7, 128, "float32", "special"), (1, 32, "float32", "random"),
    (66, 40, "bfloat16", "special"), (64, 96, "bfloat16", "random")])
def test_quant_plain_is_bit_equal_to_the_pallas_kernel(N_, C_, dtype, kind):
    """Ragged N (block_rows=64 pads), an all-zero row, exact .5 ties
    (round half to even), bf16 input: q, scale and the dequantized values
    bit for bit."""
    x = _quant_input(N_, C_, N_ + C_, kind)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jq, js = jquant.quantize_int8(jx, block_rows=64, interpret=True)
    tq, ts = quant.quantize_int8_torch(tx)
    assert tq.dtype == torch.int8 and ts.shape == (N_, 1)
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.numpy() == np.asarray(js)).all()             # bit for bit
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jd = jquant.dequantize_int8(jq, js, jdt, block_rows=64,
                                    interpret=True)
        td = quant.dequantize_int8_torch(tq, ts, tdt)
        assert (td.float().numpy() == np.asarray(jd).astype(np.float32)).all()
    # the wrapper on a CPU tensor is the plain version; the port's oracle
    # and the reference's jitted jnp path agree too
    wq, ws = quant.quantize_int8(tx)
    assert torch.equal(wq, tq) and torch.equal(ws, ts)
    oq, os_ = ref.quantize_int8_ref(tx)
    assert torch.equal(oq, tq) and torch.equal(os_, ts)
    rq, rs = jax.jit(jref.quantize_int8_ref)(jx)
    assert (np.asarray(rq) == tq.numpy()).all()
    assert (np.asarray(rs) == ts.numpy()).all()
    if kind == "special":
        assert (tq[0] == 0).all()
        if N_ > 1:
            half = tq[1, 1:9].tolist()    # -4.5 .. 3.5 -> half to even
            assert half == [-4, -2, -2, 0, 0, 2, 2, 4]


def test_scale_is_the_product_with_the_reciprocal():
    """Why the scale is ``amax * f32(1/127)``: the reference's kernel and
    its jitted jnp path compute that (XLA rewrites the division by the
    constant); an eager division differs in the last bit on some rows."""
    x = (np.random.default_rng(1).standard_normal((4096, 64)) * 3).astype(
        np.float32)
    amax = np.abs(x).max(-1, keepdims=True)
    div = amax / np.float32(127)
    _, js = jax.jit(jref.quantize_int8_ref)(jnp.asarray(x))
    _, ts = quant.quantize_int8_torch(torch.tensor(x))
    assert (ts.numpy() == np.asarray(js)).all()
    assert (ts.numpy() != div).any()


def test_quant_wrappers_validate_on_every_device():
    x = torch.ones((4, 8))
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        quant.quantize_int8(torch.ones(8))
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8(torch.ones((8, 4)).t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant.quantize_int8(x.double())
    q, s = quant.quantize_int8(x)
    with pytest.raises(ValueError, match="scale must be"):
        quant.dequantize_int8(q, s[:2])
    with pytest.raises(TypeError, match="int8"):
        quant.dequantize_int8(q.int(), s)
    with pytest.raises(RuntimeError, match="no backward"):
        quant.quantize_int8(x.requires_grad_())
    # 16-byte moves only where the row width and the pointers allow them
    assert quant.vec_ok(8, torch.float32, torch.empty(8))
    assert not quant.vec_ok(6, torch.float32, torch.empty(8))
    assert not quant.vec_ok(12, torch.bfloat16, torch.empty(12))
    assert not quant.vec_ok(8, torch.float32, torch.empty(9)[1:])


def test_ops_size_rule_is_the_reference_rule(monkeypatch):
    """``auto`` takes the kernel wrapper from PALLAS_QUANT_MIN_SIZE
    elements on, reading the payload it is told (one rank's)."""
    assert quant.PALLAS_QUANT_MIN_SIZE == jquant.PALLAS_QUANT_MIN_SIZE
    assert runtime.policy()["quant_impl"] == "auto"
    calls = []
    monkeypatch.setattr(quant, "quantize_int8",
                        lambda x: calls.append(("k3a", x.numel())) or "k")
    monkeypatch.setattr(quant, "quantize_int8_torch",
                        lambda x: calls.append(("plain", x.numel())) or "p")
    big, small = torch.zeros((4, 1 << 14)), torch.zeros((4, 64))
    ops.quantize_int8(big)
    ops.quantize_int8(small)
    ops.quantize_int8(big, size=(1 << 14))          # one rank's payload
    with runtime.use_policy(quant_impl="kernel"):
        ops.quantize_int8(small)
    with runtime.use_policy(quant_impl="torch"):
        ops.quantize_int8(big)
    assert [c[0] for c in calls] == ["k3a", "plain", "plain", "k3a",
                                     "plain"]
    for impl in ("xla", "pallas"):
        with runtime.use_policy(quant_impl=impl):
            with pytest.raises(ValueError, match="quant_impl"):
                ops.use_kernel_quant(1)


# ---------------------------------------------------------------------------
# the pod axis, bucket plans, schedules
# ---------------------------------------------------------------------------

def test_pod_axis_collectives():
    pods = PodAxis(3)
    x = torch.arange(3 * 3 * 2).reshape(3, 3, 2)
    a2a = pods.all_to_all(x)
    for r in range(3):
        for j in range(3):
            assert torch.equal(a2a[j, r], x[r, j])
    g = pods.all_gather(x[:, 0])
    assert g.shape == (3, 3, 2) and g.stride(0) == 0    # a view, no copies
    assert all(torch.equal(g[r], x[:, 0]) for r in range(3))
    assert torch.equal(pods.ring_shift(x)[1], x[0])     # rank i -> i + 1
    m = pods.pmean(x.float())
    assert torch.allclose(m[2], x.float().mean(0))
    with pytest.raises(ValueError, match="lead with 3 ranks"):
        pods.ring_shift(torch.zeros(2, 3))


def _port_plan(shapes, dtype=torch.float32, **kw):
    return buckets.plan_buckets(shapes, [dtype] * len(shapes), **kw)


@pytest.mark.parametrize("bucket_bytes", [32 << 10, 64 << 10, 4 << 20])
def test_bucket_plan_equals_the_reference(bucket_bytes):
    shapes = [SHAPES[k] for k in sorted(SHAPES)]
    want = jbuckets.plan_buckets(
        [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes],
        bucket_bytes=bucket_bytes)
    got = _port_plan(shapes, bucket_bytes=bucket_bytes)
    assert got.passthrough == want.passthrough
    assert [[(s.leaf, s.offset, s.size, s.shape) for s in b]
            for b in got.buckets] == [[(s.leaf, s.offset, s.size, s.shape)
                                       for s in b] for b in want.buckets]


def test_bucket_plan_of_full_width_olmo_1b():
    """The main path's plan: 8 leaves, each over the 4 MiB cap, 8 buckets
    of 67,108,864 to 268,435,456 elements — the reference's plan of its
    abstract parameter tree."""
    cfg = all_archs()["olmo-1b"]
    shapes = bridge.param_shapes(cfg)
    order = sorted(shapes, key=lambda p: tuple(p.split("/")))
    got = _port_plan([shapes[p] for p in order], torch.bfloat16)
    leaves = jax.tree_util.tree_leaves(
        jregistry.abstract_params(j_all_archs()["olmo-1b"]))
    want = jbuckets.plan_buckets(leaves)
    assert [s.shape for s in leaves] == [shapes[p] for p in order]
    assert got.bucket_sizes() == want.bucket_sizes()
    assert got.passthrough == want.passthrough == ()
    assert got.n_buckets == 8
    assert min(got.bucket_sizes()) == 67_108_864
    assert max(got.bucket_sizes()) == 268_435_456


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(3)
    leaves = [torch.tensor(rng.standard_normal((N,) + s).astype(np.float32))
              .to(dt) for s, dt in zip(SHAPES.values(),
                                       (torch.float32, torch.bfloat16) * 3)]
    plan = buckets.plan_buckets([t.shape[1:] for t in leaves],
                                [t.dtype for t in leaves],
                                bucket_bytes=BUCKET_BYTES)
    back = buckets.unpack(plan, buckets.pack(plan, leaves))
    for i, t in enumerate(leaves):
        if i in plan.passthrough:
            assert back[i] is None
        else:
            assert back[i].dtype == t.dtype and torch.equal(back[i], t)


def test_pack_bucket_allocates_with_the_given_empty():
    """A bucket buffer comes from the ``empty`` it is given (the
    pipelined schedule passes ``overlap.empty_on_caller``, which outside
    a schedule is ``torch.empty``), with the same packed values."""
    rng = np.random.default_rng(4)
    leaves = [torch.tensor(rng.standard_normal((N,) + s).astype(np.float32))
              .to(torch.bfloat16) for s in SHAPES.values()]
    plan = buckets.plan_buckets([t.shape[1:] for t in leaves],
                                [t.dtype for t in leaves],
                                bucket_bytes=BUCKET_BYTES)
    asked = []

    def empty(shape, dtype, device):
        asked.append((tuple(shape), dtype, device))
        return overlap.empty_on_caller(shape, dtype=dtype, device=device)

    for i in range(plan.n_buckets):
        got = buckets.pack_bucket(plan, i, leaves, empty=empty)
        assert torch.equal(got, buckets.pack_bucket(plan, i, leaves))
        assert asked[-1] == (tuple(got.shape), torch.float32,
                             torch.device("cpu"))
    assert len(asked) == plan.n_buckets > 0


def test_schedules_issue_order_spans_and_counters():
    """Serial packs bucket i+1 after chain i; pipelined packs it before;
    both return the same results, and a tracer sees the reference's spans
    and chain counters."""
    for ov, want in ((False, ["p0", "c0", "p1", "c1", "p2", "c2"]),
                     (True, ["p0", "p1", "c0", "p2", "c1", "c2"])):
        seen = []
        tracer = Tracer()
        with obs_trace.use(tracer):
            outs = overlap.run_schedule(
                3, lambda i: seen.append(f"p{i}") or i,
                lambda b: seen.append(f"c{b}") or b * 10, ov)
        assert seen == want and outs == [0, 10, 20]
        assert tracer.metrics.snapshot()["counters"] == {
            "chains_issued": 3, "chains_retired": 3}
        names = [e["name"] for e in tracer.events if e.get("ph") == "B"]
        assert names == [{"p": "pack", "c": "chain"}[n[0]] + n[1:]
                         for n in want]
    assert overlap.run_schedule(0, None, None, True) == []
    assert overlap.resolve_overlap(None, 2) and not overlap.resolve_overlap(
        None, 1)
    with runtime.use_policy(overlap_schedule="serial"):
        assert not overlap.resolve_overlap(None, 5)
    with runtime.use_policy(overlap_schedule="bogus"):
        with pytest.raises(ValueError, match="overlap_schedule"):
            overlap.resolve_overlap(None, 5)


# ---------------------------------------------------------------------------
# reduce_gradients against the reference's shard_map over 4 devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_name)
def test_reduce_gradients_matches_the_reference(case, reference):
    method, bucketed, ov, ref_impl = case
    g, e = _inputs()
    impl = "kernel" if ref_impl == "pallas" else "auto"
    with runtime.use_policy(quant_impl=impl):
        collectives.reset_chain_count()
        red, res = collectives.reduce_gradients(
            {k: torch.tensor(v) for k, v in g.items()}, PodAxis(N), method,
            {k: torch.tensor(v) for k, v in e.items()}, bucketed=bucketed,
            bucket_bytes=BUCKET_BYTES, overlap=ov)
    name = _name(case)
    assert collectives.chain_count() == int(reference[name + "/chains"])
    exact = method in ("stock", "ring")
    for k, shape in SHAPES.items():
        want = reference[f"{name}/out/{k}"].reshape((N,) + shape)
        got = red[k].numpy()
        assert got.shape == want.shape and red[k].dtype == torch.float32
        if exact:
            assert (got == want).all(), k
        else:
            # within one int8 step of the last quantization; nearly all
            # elements within a few ulps
            step = np.abs(want).max() / 127 * 1.01
            diff = np.abs(got - want)
            assert diff.max() <= step, (k, diff.max(), step)
            assert (diff > 4 * EPS32 * np.abs(want).max()).mean() < 0.01
        # every pod holds the same result, except under int8_pairwise,
        # where each pod sums the ring in its own order (the reference's
        # pods differ in the last bits too)
        spread = np.abs(got - got[:1]).max()
        assert spread <= (8 * EPS32 * np.abs(want).max()
                          if method == "int8_pairwise" else 0.0), spread
        if method == "stock":
            continue
        want_r = reference[f"{name}/res/{k}"].reshape((N,) + shape)
        x = np.abs(g[k] + e[k]).max()
        tol = 0.0 if exact else EPS32 * x
        assert np.abs(res[k].numpy() - want_r).max() <= tol, k


@pytest.mark.parametrize("method", ["stock", "int8_ring"])
def test_reduce_gradients_injects_a_degraded_fabric(method):
    """A clean condition is no condition; a straggler burns (here the
    plain loop) before each bucket's chain, or once before the stock
    pmeans, and leaves every value as it was."""
    from repro_torch.fabric import FabricCondition, canonical_conditions
    from repro_torch.kernels import burn as kburn
    g = {"w": torch.randn((N, 8192)), "v": torch.randn((N, 4096))}

    def run(fabric):
        trips = kburn.TRIPS
        red, res = collectives.reduce_gradients(
            dict(g), PodAxis(N), method, bucket_bytes=4 * 4096,
            fabric=fabric)
        return red, res, kburn.TRIPS - trips
    red0, res0, t0 = run(None)
    red1, res1, t1 = run(FabricCondition.clean())
    red2, res2, t2 = run(canonical_conditions()["straggler"])
    assert t0 == t1 == 0 and t2 > 0
    for k in g:
        assert torch.equal(red0[k], red1[k]) and torch.equal(red0[k],
                                                             red2[k])
        if method != "stock":
            assert torch.equal(res0[k], res2[k])


def test_rowwise_guard_keeps_per_hop_scales_on_the_kernel_route(monkeypatch):
    """The ring's per-hop scale is (1, 1) a rank, so its dequantize takes
    the rowwise route (``ops``), as the reference's guard intends."""
    seen = []
    real = ops.dequantize_int8
    monkeypatch.setattr(ops, "dequantize_int8",
                        lambda q, s, dtype=torch.float32, size=None:
                        seen.append(tuple(q.shape)) or real(q, s, dtype,
                                                            size=size))
    x = torch.randn(N, 1000)
    collectives.ring_allreduce(x, PodAxis(N), wire_int8=True)
    # chunks (twice), 3 hops, final: all rowwise, all ranks in one call
    assert seen == [(N * N, 250)] * 2 + [(N, 250)] * 3 + [(N * N, 250)]


def test_plain_quantization_of_other_axes():
    x = torch.randn(N, 6, 5)
    q, s = collectives.quantize_int8(x, axis=1)
    assert s.shape == (N, 1, 5)
    back = collectives.dequantize_int8(q, s)
    assert (back - x).abs().max() <= s.max() * 0.5 + 1e-6


@pytest.mark.parametrize("method", ["int8_ring", "int8_a2a"])
@pytest.mark.parametrize("bucket_bytes", [64 << 10, 1 << 20])
def test_chip_smoke_derives_the_k3_launches(method, bucket_bytes,
                                            monkeypatch):
    """The launch count ``chip_smoke.py`` holds the train phase to,
    derived from the plan and the size rule, is the number of times the
    reduction routes to the kernel wrappers (counted here on the CPU,
    where the wrappers run their plain versions)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    calls = {"q": 0, "d": 0}
    rq, rd = quant.quantize_int8, quant.dequantize_int8
    monkeypatch.setattr(quant, "quantize_int8", lambda x: calls.__setitem__(
        "q", calls["q"] + 1) or rq(x))
    monkeypatch.setattr(quant, "dequantize_int8",
                        lambda q, s, dt: calls.__setitem__(
                            "d", calls["d"] + 1) or rd(q, s, dt))
    rng = np.random.default_rng(2)
    sizes = (300_000, 70_000, 5_000, 262_147)
    g = {f"w{i}": torch.tensor(rng.standard_normal((N, s)),
                               dtype=torch.float32)
         for i, s in enumerate(sizes)}
    collectives.reduce_gradients(g, PodAxis(N), method,
                                 bucket_bytes=bucket_bytes)
    plan = buckets.plan_buckets([(s,) for s in sizes], [torch.float32] * 4,
                                bucket_bytes=bucket_bytes)
    want = chip_smoke.expected_quant_launches(plan.bucket_sizes(), N, method)
    assert (calls["q"], calls["d"]) == want and min(want) > 0
