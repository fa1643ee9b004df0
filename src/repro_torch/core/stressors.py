"""Stressor suite — the stress-ng analogue for a PyTorch/CUDA runtime.

Counterpart of ``repro/core/stressors.py``: the same battery, in the same
order, with the same names, classes, sizes, ``work_items``,
``requires_devices`` and numpy reference versions.  Mirrors the paper's
methodology (section III): a battery of small single-purpose
"stressors", each thrashing one aspect of the runtime, reporting
bogo-ops/s.  Results are normalized against a *reference platform*
implementation (single-thread numpy — our RPi4 analogue), so
cross-stressor numbers are comparable the same way the paper's Fig. 7 is.

Stressors that need capabilities the runtime lacks (collective stressors
on a single device; a device compile service on the CPU) are SKIPPED and
reported as such — exactly like stress-ng's ``rdrand`` on the
BlueField's ARM cores.  The collective (NETWORK) stressors run when the
run may start ``devices >= 2`` ranks: one rank group
(``parallel/dist.py``, gloo) times each collective on every rank with the
same ``measure`` protocol, the ranks agreeing on when to stop, and rank
0's rate is the record.  On the card every rank shares the one card and
the ranks exchange over gloo through pinned host memory: loopback, not
NVLink.

Classes follow the paper's taxonomy, re-interpreted for the GPU stack:
  CPU        -> tensor-core / CUDA-core compute   CPU_CACHE -> small working sets
  MEMORY     -> HBM-bandwidth streaming           VM        -> layout/copy/reshape
  NETWORK    -> collectives                       PIPE_IO   -> host<->device copy
  IO         -> checkpoint (disk)                 FILESYSTEM-> checkpoint metadata
  SCHEDULER  -> kernel launch                     INTERRUPT -> host callbacks
  OS         -> runtime services (NVRTC)          CRYPTO    -> PRNG / hashing / quant

Eager PyTorch differs from XLA in three ways a stressor must respect:

* a transpose, slice or permute is a free view, so the layout stressors
  end in ``.contiguous()`` and write what the reference's write;
* ``torch.uint32`` lacks multiply and shift kernels on many builds, so
  ``hash-mix`` computes in int64 and masks to 32 bits after each
  multiply (bit-equal to numpy's uint32 arithmetic);
* random inputs come from an explicit ``torch.Generator`` on the device
  (seed 0), never from the global one.

f32 matmuls run at PyTorch's default f32 precision; nothing here changes
it (``torch.set_float32_matmul_precision`` would outlive the suite).
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.headroom import stream
from repro_torch.experiments.measure import measure
from repro_torch.experiments.record import Record
from repro_torch.kernels import ref as kref
from repro_torch.parallel.dist import run_ranks
from repro_torch.runtime import resolve_device

EXPERIMENT = "stressors.suite"

MASK32 = 0xFFFFFFFF


@dataclass
class Stressor:
    name: str
    classes: tuple[str, ...]
    make: Callable[[], Callable[[], object]]        # device op
    make_ref: Optional[Callable[[], Callable[[], object]]]  # numpy reference
    work_items: int = 1                              # ops per invocation
    requires_devices: int = 1


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard-normal f32 ``shape`` on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device)


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    """Integers in ``[0, high)`` of ``shape`` on the generator's device."""
    return torch.randint(0, high, shape, generator=gen, device=gen.device)


def hash_mix(x: torch.Tensor) -> torch.Tensor:
    """Two rounds of the 32-bit integer mixer of ``x`` (int64 holding
    uint32 values), exact: every product is masked back to 32 bits."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    return x ^ (x >> 16)


def _no_pods():
    raise RuntimeError("a collective stressor runs inside a rank group "
                       "(run_suite(devices=N), N >= 2)")


# ---------------------------------------------------------------------------
# stressor definitions
# ---------------------------------------------------------------------------

def _registry(device="cuda", pods=None) -> list[Stressor]:
    """The battery on ``device``; the collective stressors run over
    ``pods``, a ``DistPodAxis`` (None outside a rank group)."""
    S: list[Stressor] = []
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32 = torch.float32

    def add(name, classes, make, make_ref=None, work=1, devices=1):
        S.append(Stressor(name, tuple(classes), make, make_ref, work, devices))

    # ---- CPU (compute) ----
    def mk_matmul(n, dtype):
        def m():
            a = torch.ones((n, n), dtype=dtype, device=dev)
            return lambda: a @ a
        return lambda: m()

    add("matmul-512-f32", ["CPU"], mk_matmul(512, f32),
        lambda: (lambda a=np.ones((512, 512), np.float32): (lambda: a @ a))())
    add("matmul-512-bf16", ["CPU"], mk_matmul(512, torch.bfloat16),
        lambda: (lambda a=np.ones((512, 512), np.float32): (lambda: a @ a))())
    add("matmul-odd-513", ["CPU"], mk_matmul(513, f32),
        lambda: (lambda a=np.ones((513, 513), np.float32): (lambda: a @ a))())

    def mk_vecmath():
        x = torch.linspace(0.1, 1.0, 1 << 16, device=dev)
        return lambda: torch.sin(x) * torch.exp(x) + torch.sqrt(x)

    def mk_vecmath_ref():
        x = np.linspace(0.1, 1.0, 1 << 16).astype(np.float32)
        return lambda: np.sin(x) * np.exp(x) + np.sqrt(x)

    add("vecmath", ["CPU"], mk_vecmath, mk_vecmath_ref)

    def mk_branchless():
        x = torch.arange(1 << 16, device=dev) % 7
        return lambda: torch.where(x > 3, x * 3, x + 1).sum()

    def mk_branchless_ref():
        x = np.arange(1 << 16) % 7
        return lambda: np.where(x > 3, x * 3, x + 1).sum()

    add("branch-select", ["CPU"], mk_branchless, mk_branchless_ref)

    # ---- CRYPTO-ish: PRNG / hashing / quantization ----
    def mk_prng():
        return lambda: torch.randint(0, 1 << 32, (1 << 16,), generator=gen,
                                     device=dev, dtype=torch.int64)

    def mk_prng_ref():
        rng = np.random.Generator(np.random.Philox(7))
        return lambda: rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)

    add("prng-bits", ["CPU", "CRYPTO"], mk_prng, mk_prng_ref)

    def mk_quant():
        x = _normal(gen, (256, 1024))
        return lambda: kref.quantize_int8_ref(x)[0]

    def mk_quant_ref():
        x = np.random.randn(256, 1024).astype(np.float32)
        def q():
            s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / 127
            return np.clip(np.round(x / s), -127, 127).astype(np.int8)
        return q

    add("quant-int8", ["CPU", "CRYPTO", "MEMORY"], mk_quant, mk_quant_ref)

    def mk_hash():
        x = torch.arange(1 << 16, dtype=torch.int64, device=dev)
        return lambda: hash_mix(x)

    def mk_hash_ref():
        x = np.arange(1 << 16, dtype=np.uint32)
        def h():
            y = (x ^ (x >> 16)) * np.uint32(0x45D9F3B)
            y = (y ^ (y >> 16)) * np.uint32(0x45D9F3B)
            return y ^ (y >> 16)
        return h

    add("hash-mix", ["CPU", "CRYPTO"], mk_hash, mk_hash_ref)

    # ---- MEMORY ----
    def mk_stream(n):
        def m():
            x = torch.ones((n,), dtype=f32, device=dev)
            one = torch.ones((), dtype=f32, device=dev)
            return lambda: stream(one, x)
        return lambda: m()

    add("memrate-64m", ["MEMORY"], mk_stream(1 << 24),
        lambda: (lambda x=np.ones(1 << 24, np.float32): (lambda: x * 2.0 + 1.0))())
    add("memrate-1m", ["MEMORY", "CPU_CACHE"], mk_stream(1 << 18),
        lambda: (lambda x=np.ones(1 << 18, np.float32): (lambda: x * 2.0 + 1.0))())

    def mk_transpose():
        x = torch.ones((2048, 2048), device=dev)
        return lambda: x.t().contiguous()

    add("transpose-copy", ["MEMORY", "VM"], mk_transpose,
        lambda: (lambda x=np.ones((2048, 2048), np.float32):
                 (lambda: np.ascontiguousarray(x.T)))())

    def mk_gather():
        x = torch.ones((1 << 16, 64), device=dev)
        idx = _randint(gen, 1 << 16, (1 << 14,))
        return lambda: x[idx]

    def mk_gather_ref():
        x = np.ones((1 << 16, 64), np.float32)
        idx = np.random.randint(0, 1 << 16, 1 << 14)
        return lambda: x[idx]

    add("gather-rows", ["MEMORY", "VM"], mk_gather, mk_gather_ref)

    def mk_scatter():
        x = torch.zeros((1 << 16, 64), device=dev)
        idx = _randint(gen, 1 << 16, (1 << 14,))
        upd = torch.ones((1 << 14, 64), device=dev)
        return lambda: x.index_add(0, idx, upd)

    def mk_scatter_ref():
        idx = np.random.randint(0, 1 << 16, 1 << 14)
        upd = np.ones((1 << 14, 64), np.float32)
        def s():
            x = np.zeros((1 << 16, 64), np.float32)
            np.add.at(x, idx, upd)
            return x
        return s

    add("scatter-add", ["MEMORY", "VM"], mk_scatter, mk_scatter_ref)

    # ---- CPU_CACHE ----
    def mk_small_loop():
        x = torch.full((128, 128), 0.005, device=dev)
        def l():
            a = x
            for _ in range(64):
                a = a @ x
            return a
        return l

    def mk_small_loop_ref():
        x = np.full((128, 128), 0.005, np.float32)
        def l():
            a = x
            for _ in range(64):
                a = a @ x
            return a
        return l

    add("cache-chain-matmul", ["CPU_CACHE", "CPU"], mk_small_loop,
        mk_small_loop_ref, work=64)

    # ---- scan / sort / search (CPU class in the paper) ----
    def mk_scan():
        x = torch.ones((1 << 20,), device=dev)
        return lambda: torch.cumsum(x, 0)

    add("assoc-scan", ["CPU", "MEMORY"], mk_scan,
        lambda: (lambda x=np.ones(1 << 20, np.float32): (lambda: np.cumsum(x)))())

    def mk_sort():
        x = _normal(gen, (1 << 16,))
        return lambda: torch.sort(x).values

    def mk_sort_ref():
        x = np.random.randn(1 << 16).astype(np.float32)
        return lambda: np.sort(x)

    add("sort-64k", ["CPU"], mk_sort, mk_sort_ref)

    def mk_topk():
        x = _normal(gen, (256, 4096))
        return lambda: torch.topk(x, 8)

    def mk_topk_ref():
        x = np.random.randn(256, 4096).astype(np.float32)
        return lambda: np.argpartition(x, -8, axis=-1)[:, -8:]

    add("topk-router", ["CPU"], mk_topk, mk_topk_ref)

    # ---- VM (layout churn) ----
    def mk_reshape_churn():
        x = torch.ones((64, 64, 64), device=dev)
        return lambda: (x.permute(2, 0, 1).reshape(64, -1)
                        .t().reshape(64, 64, 64).permute(1, 2, 0)
                        .contiguous())

    def mk_reshape_ref():
        x = np.ones((64, 64, 64), np.float32)
        return lambda: np.ascontiguousarray(
            np.ascontiguousarray(x.transpose(2, 0, 1)).reshape(64, -1)
            .T).reshape(64, 64, 64).transpose(1, 2, 0)

    add("layout-churn", ["VM", "MEMORY"], mk_reshape_churn, mk_reshape_ref)

    def mk_pad_slice():
        x = torch.ones((1000, 1000), device=dev)
        return lambda: torch.nn.functional.pad(
            x, (12, 12, 12, 12))[7:-7, 7:-7].contiguous()

    add("pad-slice", ["VM", "MEMORY"], mk_pad_slice,
        lambda: (lambda x=np.ones((1000, 1000), np.float32):
                 (lambda: np.pad(x, 12)[7:-7, 7:-7]))())

    # ---- PIPE_IO: host <-> device ----
    def mk_h2d():
        x = np.ones((1 << 20,), np.float32)
        return lambda: torch.from_numpy(x).to(dev)

    add("h2d-transfer", ["PIPE_IO"], mk_h2d,
        lambda: (lambda x=np.ones(1 << 20, np.float32): (lambda: x.copy()))())

    def mk_d2h():
        x = torch.ones((1 << 20,), device=dev)
        return lambda: x.cpu().numpy()

    add("d2h-transfer", ["PIPE_IO"], mk_d2h,
        lambda: (lambda x=np.ones(1 << 20, np.float32): (lambda: x.copy()))())

    # ---- INTERRUPT: host callbacks (device -> host -> device) ----
    def mk_callback():
        def cb(x):
            return x + 1.0
        x = torch.ones((16,), device=dev)
        return lambda: torch.from_numpy(cb(x.cpu().numpy())).to(dev)

    add("host-callback", ["INTERRUPT", "OS"], mk_callback,
        lambda: (lambda x=np.ones(16, np.float32): (lambda: x + 1.0))())

    # ---- SCHEDULER: launch overhead ----
    def mk_dispatch():
        x = torch.zeros((), device=dev)
        return lambda: x + 1

    add("dispatch-noop", ["SCHEDULER", "OS"], mk_dispatch,
        lambda: (lambda: (lambda: None))())

    def mk_manytiny():
        xs = [torch.zeros((), device=dev) for _ in range(32)]
        def run():
            for x in xs:
                out = x + 1
            return out
        return run

    add("dispatch-storm", ["SCHEDULER", "OS"], mk_manytiny, None, work=32)

    # ---- OS: compilation as a runtime service ----
    def mk_compile():
        # the card's counterpart of XLA's per-call compile is NVRTC, reached
        # through the jiterator: a fresh kernel name and body per call is a
        # fresh compile (and load) of an elementwise kernel
        if dev.type != "cuda":
            raise RuntimeError(f"no device compile service on {dev.type} "
                               "(NVRTC through torch.cuda.jiterator needs a "
                               "CUDA device)")
        x = torch.ones((8,), device=dev)
        counter = [0]
        def run():
            counter[0] += 1
            c = counter[0]
            fn = torch.cuda.jiterator._create_jit_fn(
                f"template <typename T> T stress_jit_{c}(T x) "
                f"{{ return x * T({c}) + T({c}); }}")
            return fn(x)
        return run

    add("jit-compile", ["OS"], mk_compile, None)

    # ---- IO / FILESYSTEM: checkpoint path ----
    def mk_ckpt_io():
        tmp = tempfile.mkdtemp(prefix="stress_io_")
        x = np.ones((1 << 18,), np.float32)
        def run():
            p = os.path.join(tmp, "a.npy")
            np.save(p, x)
            return np.load(p)
        return run

    add("ckpt-write-read", ["IO"], mk_ckpt_io,
        None)

    def mk_meta():
        tmp = tempfile.mkdtemp(prefix="stress_fs_")
        def run():
            p = os.path.join(tmp, "m.json")
            with open(p, "w") as f:
                json.dump({"step": 1, "leaves": {str(i): i for i in range(64)}}, f)
            with open(p) as f:
                return json.load(f)
        return run

    add("ckpt-metadata", ["FILESYSTEM"], mk_meta, None)

    # ---- NETWORK: collectives (need >= 2 devices) ----
    # Over ranks of a group, at the reference's sizes: each rank's (1, 64K)
    # f32 summed, its (n, 4096) f32 chunks exchanged, its (1, 64K) f32
    # through the int8 all_to_all formulation.
    def mk_psum():
        x = torch.ones((1, 1 << 16), device=dev)
        return lambda: pods.psum(x)

    def mk_a2a():
        x = torch.ones((1, pods.n, 1 << 12), device=dev)
        return lambda: pods.all_to_all(x)

    def mk_compressed_ar():
        from repro_torch.parallel import collectives as C
        x = torch.ones((1, 1 << 16), device=dev)
        return lambda: C.compressed_psum(x, pods)[0]

    def over_pods(mk):
        return _no_pods if pods is None else mk

    add("allreduce", ["NETWORK"], over_pods(mk_psum), None, devices=2)
    add("all-to-all", ["NETWORK"], over_pods(mk_a2a), None, devices=2)
    add("allreduce-int8", ["NETWORK", "CRYPTO"], over_pods(mk_compressed_ar),
        None, devices=2)

    return S


def _run_one(s: Stressor, duration: float, with_reference: bool,
             agree=None) -> Record:
    """One stressor's record: its rate beside the numpy reference's, or a
    SKIP naming what it lacks."""
    params = {"classes": list(s.classes)}
    try:
        fn = s.make()
        m = measure(fn, duration, agree=agree)
        ops = m.calls_per_sec * s.work_items
        rel = None
        if with_reference and s.make_ref is not None:
            rfn = s.make_ref()
            ref_ops = measure(rfn, duration).calls_per_sec * s.work_items
            params["ref_ops_per_sec"] = ref_ops
            rel = ops / ref_ops if ref_ops else None
        params["median_s"] = m.median_s
        params["p90_s"] = m.p90_s
        return Record(EXPERIMENT, s.name, "bogo_ops_per_sec", ops,
                      unit="ops/s", relative=rel, params=params)
    except Exception as e:  # capability-missing, like stress-ng skips
        return Record(EXPERIMENT, s.name, "bogo_ops_per_sec", params=params,
                      skipped=True, reason=f"{type(e).__name__}: {e}")


def _collectives_rank(pods, names: list, duration: float,
                      with_reference: bool) -> list[Record]:
    """One rank of the collective stressors: each named one, timed."""
    return [_run_one(s, duration, with_reference, agree=pods.all_true)
            for s in _registry(pods.device, pods) if s.name in names]


def run_suite(duration: float = 0.5, names: Optional[list[str]] = None,
              with_reference: bool = True, device="cuda",
              devices: int = 1) -> list[Record]:
    """Run the battery; one ``Record`` per stressor (bogo-ops/s, with the
    numpy-reference relative when a reference implementation exists).
    ``devices`` is the number of ranks the run may start: the stressors
    that need more SKIP, as the reference's do on fewer devices."""
    device = resolve_device(device)
    records, over_ranks = [], []
    for s in _registry(device):
        if names and s.name not in names:
            continue
        if devices < s.requires_devices:
            records.append(Record(
                EXPERIMENT, s.name, "bogo_ops_per_sec",
                params={"classes": list(s.classes)}, skipped=True,
                reason=f"needs >= {s.requires_devices} devices"))
        elif s.requires_devices > 1:
            over_ranks.append((len(records), s.name))
            records.append(None)
        else:
            records.append(_run_one(s, duration, with_reference))
    if over_ranks:
        ranked = run_ranks(_collectives_rank, devices, backend="gloo",
                           device=device,
                           args=([name for _, name in over_ranks], duration,
                                 with_reference))[0]
        for (slot, _), r in zip(over_ranks, ranked):
            records[slot] = r
    return records
