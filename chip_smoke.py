#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` — K1
paged-attention decode, K2 flash-attention forward (head dims 16 to 128,
and 120), K3a/K3b rowwise int8 quantize/dequantize, K4 the chunked WKV-6
scan — holds each against its plain PyTorch version on the card, and
drives the port's paths at full width with random weights from a seed: a
burst of requests through the paged continuous-batching engine on OLMo-1B
(16 layers, d_model 2048, bf16; K1 and K2), a burst through the dense
engine on RWKV6-7B (32 layers, d_model 4096, bf16; K4), one through the
dense engine on H2O-Danube3-4B (24 layers, d_model 3840, hd 120, sliding
window 4096 kept as a ring; K2), one through the paged engine on
Mistral-NeMo-12B (40 layers, d_model 5120, GQA rep 4; K1 and K2), one
through the paged engine on Moonlight-16B-A3B (48 layers of 64 experts
top-6 plus 2 shared, d_model 2048; K1 and K2), InternVL2-26B (48 layers,
d_model 6144, 256 patches prepended; K2 at rep 6) and Whisper-base in f32
(6 + 6 layers, 16 x 1500 frames; K2 non-causal at hd 64) through the
registry's prefill and decode, the
serving families of the paper's question on OLMo-1B (K1, K2; the static
engine's batched prefill held first), tensor-parallel serving of
OLMo-1B and Mistral-NeMo-12B over a ``model`` axis (K1 and K2 in each
rank at its local heads), three training steps of OLMo-1B
over 4 emulated pods with the int8 ring all-reduce of its gradients (K3a,
K3b), the same over 4 rank processes (K3a, K3b in each), OLMo-1B on a
(data 2, model 2) mesh and over (pod 2, model 2) with the int8 ring
(K3a, K3b in each rank at its local buckets), Moonlight-16B-A3B,
RWKV6-7B, InternVL2-26B and Whisper-base trained on (data 2, model 2)
and Moonlight and the smoke Jamba over (pod 2, model 2) with the int8
ring (K3a, K3b in each rank), and the paper's offload characterization
(K3a, K3b in the in-path transforms).
Each phase prints one JSON line and its seconds; any failure exits
non-zero.  Without a CUDA device the script exits non-zero
before printing any result.

Phases: device, build, kernels, serve_f32_smoke, serve, serve_rwkv,
serve_swa, serve_nemo, serve_moe, serve_vlm, serve_encdec,
serve_families, serve_tp, serve_tp_families, train_f32_smoke, train,
train_ranks, train_mesh, dryrun, offload_families.  ``dryrun`` costs
cells on meta tensors (``launch/dryrun.py``): full-width OLMo-1B training
2 x 1024 tokens on one card, the cell ``offload_families``' ``--plan``
run trains, and Command-R+ 104B, Qwen3-MoE-235B and Jamba-398B at
train_4k on the (16, 16) production mesh (three niced ``python -m
repro_torch.launch.dryrun`` processes, started after the kernels phase
so that they run beside the serving phases; no storage), checking
``roofline.param_count`` against the counts this script's models hold.
``serve_tp_families`` serves
the other families over a model axis: K1, K2 and K4 at the ranks' local
shapes, Moonlight-16B-A3B at tp 4 and RWKV6-7B at tp 2 and 4 over rank
processes (the kernel arm against the plain arm on the same ranks, the
logits and Moonlight's top-6 expert choices against tp 1's, a planted
expert offset that must fail), InternVL2-26B at tp 4 emulated (run at
``serve_vlm``'s end on its weights), Whisper-base in f32 at tp 2, the f32
smoke of every family at tp 1/2/4, and ``launch.serve --arch rwkv6-7b
--tp-size 2 --devices 2``.  ``train_mesh`` trains on a mesh:
full-width OLMo-1B on (data 2, model 2) emulated (its first step beside
the one-device step; the f32 smoke OLMo at (2, 2) against (1, 1)) and
over 4 rank processes against it, with sequence parallelism (exchanges
a step against ``transformer.train_exchanges``), on (pod 2, model 2)
with int8_ring over 4 ranks against its emulated form (K3a/K3b at the
count derived from each rank's local buckets, bit-equal to their plain
versions at those shapes), ``parallel/pipeline.py`` at 4 stages of
d 2048 emulated and over 4 ranks against the composed stages,
``launch.train --data-mesh 2 --model-mesh 2`` emulated and (Moonlight's
smoke) with ``--devices 4``, and every other family over the model
axis: Moonlight-16B-A3B, RWKV6-7B and InternVL2-26B at published width,
depth cut, and Whisper-base whole, on (data 2, model 2) emulated and
over 4 ranks (bit-equal), Jamba's smoke width so (its training state
at published width does not fit the card), each of those again with
sequence parallelism (its loss against its own without it), and
Moonlight and the smoke Jamba on (pod 2, model 2) with int8_ring
(K3a/K3b at their local buckets).  ``train_ranks``' reduction sweep runs
on 2 layers' leaves (cut for time).  ``serve_tp`` serves tensor-parallel:
K1 and K2 at the ranks' local head shapes against their plain versions,
OLMo-1B's burst at tp 2 and 4 over rank processes (gloo through host
memory, rank 0 driving; ``serve/ranks.py``) and at tp 4 emulated, each
run's logits against tp 1's, the f32 smoke OLMo, NeMo and Danube at tp
1/2/4 with equal streams, and the serve CLI over 2 rank processes.
``train_ranks`` runs the ``pod`` axis one process a rank: 4 rank
processes on the card over gloo, through pinned host memory (NCCL
refuses two ranks on one device), holding ``reduce_gradients`` at every
method and schedule on OLMo-1B's leaves against the emulated pods,
training full-width OLMo-1B 2 steps over the ranks (int8_ring, K3a/K3b
in every rank) against the emulated step, the degraded-fabric guard on
the burn kernel (``csrc/fabric_burn.cu``) and
``fabric.collectives_degraded``, the collective stressors, and nccl
with one rank.  The smoke
phases also run the five new archs' smoke configs (and a Jamba with an
attention layer in each group) kernel against plain, and one train step
of smoke RWKV-6 and Moonlight on the card against the CPU.
``offload_families`` runs the eight offload families (``headroom.*``,
``stressors.suite``, ``classes.aggregate``, ``inpath.*`` over 4 emulated
pods) at the reference's presets and the same core functions at the
card's sizes (the stressor battery and the card-size sweeps' points at
shorter windows, ``OFFLOAD_SHORT``; transfers of 4 KiB to 256 MiB over
1-8 workers, the delay
sweep at 256 MiB beside matmuls up to 8192, ``inpath.measure`` at 1 << 26
elements a pod, the overlap step at the train phase's 8 buckets beside
d_model 2048) through the port's Runner, one JSON line each, streams
under ``build/offload_families/``; it holds K3a/K3b against their plain
versions inside the int8 chains at the in-path shapes (outputs and
residuals bit-equal), both arms of the overlap
step and of the train phase's reduction bit-equal, K3's launches to the
count derived from every chain it issues, and then trains full-width
OLMo-1B for 3 steps through ``launch.train --plan`` with stressors
measured on the card and the dry run's roofline terms of that cell; the
steps after the first must take no less than the dry run's ``step_s``
(a roofline is a lower bound), and it prints the measured MFU (model
FLOPs over 989 TFLOP/s and the step) and the dry run's peak bytes over
the run's ``max_memory_allocated``.
``serve_families`` asks the paper's question of full-width OLMo-1B on
the card: the port's serving families (``repro_torch.core``: offered-load
sweep with probe headroom, SLO sweep, span timeline, degraded-fabric tail
under the five canonical conditions, continuous vs static engine, and the
paged-attention page-size x depth sweep) through the port's experiment
Runner, one JSON line each; their Record streams and the timeline's trace
land under ``build/serve_families/``.  Then one ``{"kernels": [...]}``
line with every kernel's launches on its main paths, summed (K1 in
``serve``, ``serve_nemo``, ``serve_moe`` and ``serve_families``; K2 in
``serve``, ``serve_swa``, ``serve_nemo``, ``serve_moe``, ``serve_vlm``,
``serve_encdec`` and ``serve_families``; K4 in
``serve_rwkv``; K3a, K3b in ``train``, ``train_ranks`` (summed over the
ranks), ``train_mesh`` (the (pod, model) runs, emulated and summed over
the ranks) and ``offload_families``), its
error against the plain
version, its time, the plain version's time, the bound (the larger of
bytes / 3.35 TB/s and operations / the peak of the kernel's type: 989
TFLOP/s bf16 tensor cores for K1 and K2, 67 TFLOP/s f32 CUDA cores for
K4; K3 is bytes only; H100 SXM data-sheet peaks) and the time of the
PyTorch library call that computes the same function where there is one
(a yardstick: the port never calls it; K2 and its yardstick, K4 at the
serve path's prompt lengths 64, 512 and 1024, and K1 at buffer_depth 1,
2 and 4 and other split sizes, are also timed as device time from a
``torch.profiler`` window, in the ``kernels`` phase's line); the card's
name and power limit;
and the last line ``{"ok": true, "device": {...}}``.

``--phases a,b`` runs a subset (``--phases kernels --verbose-build`` is
the short first run of a new kernel; ``--phases device,build,kernels,train``
the training path); with no arguments everything runs.  ``--profile`` adds
traced decode-tick and 1024-token-prefill breakdowns, with K1's, K2's and
K4's shares of the device time.  ``--k1-sources SRC ...`` times other K1
sources (an earlier kernel copied under ``build/``, say) beside K1.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import resource
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import bridge, runtime  # noqa: E402
from repro_torch.configs import all_archs, smoke  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant as qk  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, for_arch, synth_batch  # noqa: E402,E501
from repro_torch.fabric import canonical_conditions  # noqa: E402
from repro_torch.fabric import inject as fabric_inject  # noqa: E402
from repro_torch.kernels import burn as kburn  # noqa: E402
from repro_torch.models import common, registry  # noqa: E402
from repro_torch.parallel import buckets, collectives, overlap  # noqa: E402
from repro_torch.parallel import rank_bodies  # noqa: E402
from repro_torch.parallel.pods import PodAxis  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.loadgen import LoadSpec, make_requests  # noqa: E402
from repro_torch.serve.paged import paged_supported  # noqa: E402
from repro_torch.serve.scheduler import ServeRequest  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda")      # never touched before main() has checked
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
F32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, f32 on CUDA cores
TOL_F32 = 2e-5                  # f32 sums in another order (as the
#                                 reference's kernel tests)
TOL_SCAN = 1e-3                 # the WKV scan in f32: the reference's own
#                                 tolerance (tests/test_kernels.py), which
#                                 covers the chunked form's clipped
#                                 exponents against the per-step oracle
TOL_BF16 = 2e-2                 # one bf16 rounding of O(1) outputs
BF16_ULPS = 2                   # and, element by element, a bf16 K2 output
ROW_SHARE = 2.0 ** -5           # within BF16_ULPS spacings of the plain
#                                 output's magnitude plus ROW_SHARE of the
#                                 RMS of its row: rounding P to bf16 before
#                                 P V moves an output by ~2**-9 of its row's
#                                 size (the design, written out on the CPU,
#                                 stays under half this bound), while a key
#                                 tile lost at the window's edge moves it
#                                 past the bound (tests/
#                                 test_torch_kernels.py holds both)
TOL_LOGITS_ULPS = 4             # full-width logits come out of a bf16
#                                 product: the two attention paths differ by
#                                 single bf16 roundings that 16 layers carry
#                                 into the logits, so they are held within 4
#                                 bf16 spacings at the largest logit (0.125
#                                 for |logit| in [4, 8)); 5e-2 absolute was
#                                 tried first and measured 0.078 = 2.5
#                                 spacings of 2**-5 on an H100


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profiled_ms(fn, iters: int = 20, windows: int = 3,
                by_kernel: bool = False, warmup: int = 3,
                calls: bool = False):
    """Mean device time of one call of ``fn`` from a ``torch.profiler``
    window (the sum of the device kernels it launches, without the host's
    launch path), and the names of those kernels (with ``by_kernel``, a
    dict of each one's mean device ms a call).  With ``calls``, a dict of
    one call's mean wall ms (host clock, ending in a sync), device ms (a
    sum above the wall means kernels of several streams ran at once) and
    kernel launches.  ``warmup`` calls run first.  A window in which the
    profiler recorded no device activity at all (seen once on an H100, in
    a process's first window) is taken again, up to ``windows`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows:
            total = sum(e.self_device_time_total for e in rows) / iters / 1e3
            if calls:
                return {"wall_ms": wall / iters * 1e3, "device_ms": total,
                        "kernels": sum(e.count for e in rows) / iters}
            if by_kernel:
                return total, {e.key[:80]: e.self_device_time_total / iters
                               / 1e3 for e in rows}
            return total, sorted({e.key[:80] for e in rows})
    raise AssertionError(f"the profiler saw no device time in {windows} "
                         f"windows")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_spacing(x):
    """The bf16 spacing at each element's magnitude."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_excess(got, want) -> float:
    """The largest ``|got - want|`` over its element's bound, ``BF16_ULPS``
    spacings of ``|want|`` plus ``ROW_SHARE`` of the RMS of ``want``'s row
    (the last axis): at most 1 where a bf16 attention output agrees with
    its plain version."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    bound = BF16_ULPS * bf16_spacing(w) + ROW_SHARE * rms
    return float(((g - w).abs() / bound).max())


def logits_tol(logits) -> float:
    """``TOL_LOGITS_ULPS`` bf16 spacings at the largest logit's size."""
    top = float(logits.abs().max())
    return TOL_LOGITS_ULPS * 2.0 ** (int(np.floor(np.log2(top))) - 7)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase: device
# ---------------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    card = smi_line()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


# ---------------------------------------------------------------------------
# phase: build
# ---------------------------------------------------------------------------

def sass_mma_counts(path) -> dict | None:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in each
    function's SASS, from ``cuobjdump -sass`` on the built library (None
    where the toolkit has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[fn][op] += 1
    return counts


def phase_build(verbose: bool) -> None:
    t0 = time.perf_counter()
    _build.lib(verbose=verbose)
    extra = {}
    if verbose:
        extra["sass_mma"] = sass_mma_counts(_build.build())
        # K4: registers, local (spill) bytes, shared memory, blocks a SM
        extra["rwkv6_scan"] = {dh: rs.kernel_info(dh) for dh in rs.HEAD_DIMS}
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds,
         sources=[os.path.relpath(str(p), os.path.dirname(
             os.path.abspath(__file__))) for p in _build.sources()], **extra)


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def paged_case(seed, S, H, Kv, hd, page_size, max_pages, lengths, dtype):
    """Random pool + per-sequence page tables (distinct pages, trash-padded
    rows), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    n_blocks = S * max_pages
    trash = n_blocks
    q = rng.standard_normal((S, H, hd), dtype=np.float32)
    pool = rng.standard_normal((n_blocks + 1, page_size, 2 * Kv, hd),
                               dtype=np.float32)
    perm = rng.permutation(n_blocks)
    tables = np.full((S, max_pages), trash, np.int32)
    k = 0
    for s, n in enumerate(lengths):
        need = min(-(-n // page_size), max_pages)    # a length may pass
        tables[s, :need] = perm[k:k + need]          # the table's reach
        k += need
    to = lambda a: torch.tensor(a, device=DEV)        # noqa: E731
    return (to(q).to(dtype), to(pool).to(dtype), to(tables),
            to(np.asarray(lengths, np.int32)))


def flash_case(seed, B, S, H, Kv, hd, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.tensor(                  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32), device=DEV).to(dtype)
    return mk(B, S, H, hd), mk(B, S, Kv, hd), mk(B, S, Kv, hd)


def fused_case(seed, B, S, H, Kv, hd, dtype):
    """q, k and v as views of one fused (B, S, H + 2 Kv, hd) tensor, the
    layout of a fused qkv projection: strided rows, as the wrapper takes."""
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, S, H + 2 * Kv, hd),
                                           dtype=np.float32),
                       device=DEV).to(dtype)
    return qkv[:, :, :H], qkv[:, :, H:H + Kv], qkv[:, :, H + Kv:]


PAGED_GRID = [  # S, H, Kv, hd, ps, max_pages, lengths
    (4, 4, 2, 16, 8, 6, (1, 13, 40, 48)),
    (3, 8, 8, 32, 4, 8, (32, 7, 19)),
    (2, 2, 1, 64, 16, 2, (16, 31)),
]
FLASH_GRID = [(2, 128, 4, 2, 64), (1, 256, 4, 4, 32), (2, 64, 8, 2, 16),
              (1, 128, 2, 1, 128)]
FLASH_MASKS = [(True, 0), (True, 64), (False, 0)]
FLASH_RAGGED = [(130, True, 0), (100, True, 0), (77, False, 0),
                (130, True, 48)]
FLASH_MAIN_S = (128, 512, 1000, 1024)   # K2's shapes on the serve path


def flash_bf16_grid():
    """Every case the bf16 kernel takes a form of: each hd, rep 1/2/4,
    each mask at ragged and tiny S (1 to 16: one partial key tile), the
    ragged cases, the f32 grid's shapes, and q/k/v as strided views of one
    fused tensor -> ((B, S, H, Kv, hd), causal, window, strided)."""
    for hd in fa.HEAD_DIMS:
        for rep in (1, 2, 4):
            for S in (1, 7, 8, 16, 77, 100, 130):
                for causal, window in FLASH_MASKS:
                    yield (2, S, 2 * rep, 2, hd), causal, window, False
            for S, causal, window in FLASH_RAGGED:
                yield (2, S, 2 * rep, 2, hd), causal, window, False
    for case in FLASH_GRID:
        for causal, window in FLASH_MASKS:
            yield case, causal, window, False
    for hd in (64, 128):
        for causal, window in FLASH_MASKS + [(True, 48)]:
            yield (2, 130, 4, 2, hd), causal, window, True


# serve_families' paged_sweep at full width: OLMo-1B's heads, 16
# sequences over 2048 positions in f32 pools, the reference's page sizes
# and the main path's 16, at the reference's depths
SWEEP_SEQS, SWEEP_TOKENS = 16, 2048
SWEEP_PAGE_SIZES = (2, 4, 8, 16)


def sweep_lengths() -> tuple:
    """paged_sweep's ragged lengths: the longest uses the whole budget,
    the others step down by 37 (``core/serving.paged_sweep``)."""
    return tuple(int(n) for n in np.clip(
        SWEEP_TOKENS - np.arange(SWEEP_SEQS) * 37, 1, SWEEP_TOKENS))


def paged_edges(dtype):
    """K1's cases at the edges of its split design, for ``dtype``: lengths
    at and one past the end of a split (the plan's span at that dtype), a
    length past the table's reach and one of 1 in the serve path's
    geometry; rep 8 (two passes of 4 heads); at f32, pages of 256 KiB,
    which the ring holds in two tiles, and paged_sweep's geometry at each
    of its page sizes (at page 2 a split spans 32 pages of 2 positions)."""
    item = torch.empty((), dtype=dtype).element_size()
    span, _ = pa._split_plan(4, 16, 128, 16, 128, item)
    edge = span * 16
    yield (4, 16, 16, 128, 16, 128, (edge, edge + 1, 128 * 16 + 77, 1))
    yield (3, 16, 2, 64, 16, 8, (1, 100, 128))
    if dtype == torch.float32:
        yield (2, 2, 1, 128, 256, 3, (300, 700))
        for ps in SWEEP_PAGE_SIZES:
            yield (SWEEP_SEQS, 16, 16, 128, ps, SWEEP_TOKENS // ps,
                   sweep_lengths())


K1_SPLIT_BYTES = (32 * 1024, 64 * 1024, 128 * 1024, 256 * 1024)
# the lengths of the traced decode tick (--profile): the serve phase's
# prompts 512, 1000, 128, 77 and one token each, four times
K1_TICK_LENGTHS = (513, 1001, 129, 78) * 4


def k1_sources_start(sources):
    """Start building other K1 sources into ``build/k1_sources/`` beside
    the main build (one nvcc each, all at once); :func:`kernels_paged`
    times each against the repository's kernel in the same process.  A
    source has the single-pass kernel's C interface (21 parameters) or the
    split kernel's (the repository's)."""
    import pathlib
    import re
    jobs = []
    out_dir = _build.build_dir() / "k1_sources"
    for src in sources or ():
        src = pathlib.Path(src)
        m = re.search(r'extern "C" int paged_attention_decode\s*\((.*?)\)',
                      src.read_text(), re.S)
        check(m is not None, f"{src}: no paged_attention_decode")
        n_params = len(m.group(1).split(","))
        split = n_params == len(_build.SIGNATURES["paged_attention_decode"])
        check(split or n_params == 21, f"{src}: {n_params} parameters")
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"{src.stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o",
               str(so)]
        jobs.append((src, split, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return jobs


class _OneFunction:
    """A stand-in for the kernel library holding one source's K1 only."""

    def __init__(self, fn):
        self.paged_attention_decode = fn


def k1_source_call(job, q, pool, tables, lens, depth=2):
    """A function that runs one built source's kernel on these inputs:
    a split-interface source through the wrapper (its plan, its scratch),
    a single-pass one directly."""
    import ctypes
    src, split, so, proc = job
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"K1 build of {src}:\n{log}")
    fn = ctypes.CDLL(str(so)).paged_attention_decode
    fn.restype = ctypes.c_int
    if split:
        fn.argtypes = _build.SIGNATURES["paged_attention_decode"]
        handle = _OneFunction(fn)

        def call():
            saved, _build._LIB = _build._LIB, handle
            try:
                return pa.paged_attention_fwd(q, pool, tables, lens,
                                              buffer_depth=depth)
            finally:
                _build._LIB = saved
        return call
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P] * 5 + [I] * 6 + [L] * 7 + [ctypes.c_float, I, P]
    S, H, hd = q.shape
    _, ps, kv2, _ = pool.shape

    def call():
        out = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), pool.data_ptr(), tables.data_ptr(),
                        lens.data_ptr(), out.data_ptr(), S, H, kv2 // 2, hd,
                        ps, tables.shape[1], *q.stride()[:2],
                        *pool.stride()[:3], *out.stride()[:2],
                        hd ** -0.5, int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream),
                     f"K1 from {src}")
        return out
    return call


def kernels_paged(k1_jobs=()) -> dict:
    worst, sweep = 0.0, {}
    for case in PAGED_GRID + list(paged_edges(torch.float32)):
        q, pool, tables, lens = paged_case(17, *case, torch.float32)
        want = ref.paged_attention_ref(q, pool, tables, lens)
        for depth in (1, 2, 4):
            got = pa.paged_attention_fwd(q, pool, tables, lens,
                                         buffer_depth=depth)
            plain = pa.paged_attention_torch(q, pool, tables, lens,
                                             buffer_depth=depth)
            torch.cuda.synchronize()
            e = max(max_err(got, plain), max_err(got, want))
            check(e < TOL_F32, f"paged f32 {case} depth {depth}: {e}")
            worst = max(worst, e)
            S, _, Kv, hd, ps, mp, _ = case
            if (S, ps * mp) == (SWEEP_SEQS, SWEEP_TOKENS):
                # paged_sweep's shape: the plan, and the device time
                # beside the bound (K and V of the live positions, f32)
                span, n_split = pa._split_plan(S, Kv, mp, ps, hd, 4)
                tile, slots = pa._ring_plan(ps, hd, 4, min(depth, mp), span)
                byts = sum(case[-1]) * 2 * Kv * hd * 4
                sweep[f"page{ps}_depth{depth}"] = {
                    "max_abs_err": e, "span": span, "n_split": n_split,
                    "tile": tile, "slots": slots,
                    "device_ms": profiled_ms(
                        lambda: pa.paged_attention_fwd(
                            q, pool, tables, lens, buffer_depth=depth))[0],
                    "bound_ms": byts / HBM_BYTES_PER_S * 1e3}
        del q, pool, tables, lens, want
    # bf16 on the small grid as well (every hd / rep instantiation)
    worst_bf16 = 0.0
    for case in PAGED_GRID + [(2, 8, 2, 128, 16, 4, (5, 64)),
                              (2, 6, 2, 32, 8, 4, (9, 32))] \
            + list(paged_edges(torch.bfloat16)):
        q, pool, tables, lens = paged_case(19, *case, torch.bfloat16)
        got = pa.paged_attention_fwd(q, pool, tables, lens)
        plain = pa.paged_attention_torch(q, pool, tables, lens)
        e = max_err(got, plain)
        check(e < TOL_BF16, f"paged bf16 {case}: {e}")
        worst_bf16 = max(worst_bf16, e)

    # poisoned pool: trash page, unowned pages and the past-length tail of
    # each last page set to 1e6 must not move the output at all
    lengths = (5, 17, 26)
    q, pool, tables, lens = paged_case(23, 3, 4, 2, 16, 8, 4, lengths,
                                       torch.float32)
    base = pa.paged_attention_fwd(q, pool, tables, lens)
    tbl = tables.cpu().numpy()
    owned = set()
    for s, n in enumerate(lengths):
        owned.update(tbl[s, :-(-n // 8)].tolist())
    poisoned = pool.clone()
    for p in range(poisoned.shape[0]):
        if p not in owned:
            poisoned[p] = 1e6
    for s, n in enumerate(lengths):
        last = int(tbl[s, (n - 1) // 8])
        poisoned[last, n % 8 or 8:] = 1e6
    got = pa.paged_attention_fwd(q, poisoned, tables, lens)
    poison_diff = max_err(got, base)
    check(poison_diff == 0.0, f"poisoned pool moved the output: "
                              f"{poison_diff}")

    # the main path's shape: 16 slots, OLMo-1B heads, 16-token pages,
    # ragged lengths up to the 2048-token cache, bf16
    S, H, Kv, hd, ps, mp = 16, 16, 16, 128, 16, 128
    rng = np.random.default_rng(5)
    lengths = [int(x) for x in rng.integers(129, 2049, size=S)]
    lengths[0], lengths[1] = 2048, 1
    q, pool, tables, lens = paged_case(29, S, H, Kv, hd, ps, mp, lengths,
                                       torch.bfloat16)
    got = pa.paged_attention_fwd(q, pool, tables, lens, buffer_depth=2)
    plain = pa.paged_attention_torch(q, pool, tables, lens, buffer_depth=2)
    err = max_err(got, plain)
    check(err < TOL_BF16, f"paged bf16 main shape: {err}")
    check(bool(torch.isfinite(got.float()).all()), "paged output not finite")
    check(torch.equal(got, pa.paged_attention_fwd(q, pool, tables, lens,
                                                  buffer_depth=2)),
          "paged: two calls on the same inputs differ")
    kernel = lambda depth: lambda: pa.paged_attention_fwd(  # noqa: E731
        q, pool, tables, lens, buffer_depth=depth)
    depth_err = {d: max_err(kernel(d)(), plain) for d in (1, 4)}
    check(max(depth_err.values()) < TOL_BF16,
          f"paged bf16 main shape at depth 1, 4: {depth_err}")
    ms = time_ms(kernel(2))
    plain_ms = time_ms(lambda: pa.paged_attention_torch(
        q, pool, tables, lens, buffer_depth=2), warmup=1, iters=3)
    # device time (both kernels of a call, and each) at buffer_depth 1, 2,
    # 4; at depth 2 with other split sizes; then each other source in turns
    # with the repository's kernel: other, kernel, kernel, other
    device_ms, by_kernel = {}, {}
    for depth in (1, 2, 4):
        device_ms[depth], by_kernel[depth] = profiled_ms(kernel(depth),
                                                         by_kernel=True)
    # the same at the traced decode tick's lengths (Σ 6,884)
    tick = paged_case(31, S, H, Kv, hd, ps, mp, K1_TICK_LENGTHS,
                      torch.bfloat16)
    tick_plain = pa.paged_attention_torch(*tick, buffer_depth=2)
    tick_kernel = lambda depth: lambda: pa.paged_attention_fwd(  # noqa: E731
        *tick, buffer_depth=depth)
    tick_ms = {depth: profiled_ms(tick_kernel(depth))[0]
               for depth in (1, 2, 4)}
    by_split_bytes = {}
    for nbytes in K1_SPLIT_BYTES:
        saved = pa.SPLIT_BYTES
        pa.SPLIT_BYTES = nbytes
        pa._split_plan.cache_clear()
        try:
            e = max(max_err(kernel(2)(), plain),
                    max_err(tick_kernel(2)(), tick_plain))
            check(e < TOL_BF16, f"paged bf16 main shape, split {nbytes}: {e}")
            by_split_bytes[nbytes] = {
                "span": pa._split_plan(S, Kv, mp, ps, hd, 2)[0],
                "device_ms": profiled_ms(kernel(2))[0],
                "tick_device_ms": profiled_ms(tick_kernel(2))[0]}
        finally:
            pa.SPLIT_BYTES = saved
            pa._split_plan.cache_clear()
    others = []
    for job in k1_jobs:
        other = k1_source_call(job, q, pool, tables, lens)
        other_err = max_err(other(), plain)
        check(other_err < TOL_BF16, f"K1 from {job[0]}: {other_err}")
        timed = {"other": [], "kernel": []}
        for who, fn in (("other", other), ("kernel", kernel(2)),
                        ("kernel", kernel(2)), ("other", other)):
            dev, seen = profiled_ms(fn)
            timed[who].append(dev)
        others.append({"source": str(job[0]), "max_abs_err": other_err,
                       "device_ms": timed["other"],
                       "kernel_device_ms": timed["kernel"],
                       "ms": time_ms(other), "kernels": seen})
    item = 2
    n_tok = sum(lengths)
    n_tbl = sum(-(-n // ps) for n in lengths)
    byts = (n_tok * 2 * Kv * hd * item          # K and V rows of live tokens
            + 2 * S * H * hd * item             # q read, out written
            + 4 * n_tbl + 4 * S)                # table entries used, lengths
    flops = 4 * n_tok * H * hd
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {
        "name": "paged_attention_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:130",
        "shape": {"S": S, "H": H, "Kv": Kv, "hd": hd, "page_size": ps,
                  "max_pages": mp, "sum_lengths": n_tok, "dtype": "bf16"},
        "max_abs_err": err, "max_err_f32_grid": worst,
        "sweep_f32": sweep,
        "max_err_bf16_grid": worst_bf16, "poisoned_pool_diff": poison_diff,
        "max_err_depth": depth_err, "bit_identical": True,
        "split_plan": dict(zip(("span", "n_split"), pa._split_plan(
            S, Kv, mp, ps, hd, item))),
        "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms[2],
        "device_ms_by_depth": device_ms, "device_ms_by_kernel": by_kernel,
        "device_kernels": sorted(by_kernel[2]),
        "device_ms_by_split_bytes": by_split_bytes, "other_sources": others,
        "tick_device_ms_by_depth": tick_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "bytes": byts, "flops": flops, "library_ms": None,
    }


def band_pairs(S, causal, window=0) -> int:
    """The (query, key) pairs a mask lets through: key <= query when
    causal, key > query - window when windowed."""
    if not window:
        return S * (S + 1) // 2 if causal else S * S
    w = min(window, S)
    if causal:                      # query q sees min(q + 1, window) keys
        return w * (w + 1) // 2 + (S - w) * window
    q = np.arange(S)                # and every later key when not causal
    return int(np.sum(S - np.maximum(q - window + 1, 0)))


def flash_bound(B, S, H, Kv, hd, item, causal, window=0):
    flops = 4 * B * H * hd * band_pairs(S, causal, window)
    byts = item * B * S * hd * (2 * H + 2 * Kv)      # q, out, k, v
    return byts, flops


# K2 at head dim 120 (H2O-Danube3-4B: 32 heads over 8 kv heads, window
# 4096): each mask at each length of the grid, rep 1 and 4, both dtypes
SWA_MASKS = [(c, w) for c in (True, False) for w in (0, 64, 4096)]
SWA_S = (64, 130, 1024, 4064, 4608)
SWA_MAIN = (1, 4608, 32, 8, 120)        # Danube's longest serve_swa prompt
SWA_WINDOW = 4096


def sdpa_banded(q, k, v, window):
    """The library yardstick for windowed K2: one
    ``scaled_dot_product_attention`` call on the (B, H, S, hd) views of the
    same tensors, GQA by ``enable_gqa``, the causal band as a boolean
    mask."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def window_edge_fault(q, k, v, *, causal, window, block=64):
    """A planted fault, to show what the bf16 bound rejects: the plain
    version with the first key tile dropped from each query block whose
    window binds (its first visible key past 0), that is K2's key-block
    range one tile short at the window's edge.  Head by head over a dense
    mask; a row the drop would leave without keys keeps its own."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    first = pos // block * block - window + 1     # the block's first key
    lo = torch.where(first > 0, first // block * block, -block)
    drop = (pos[None, :] >= lo[:, None]) & (pos[None, :] < lo[:, None]
                                              + block)
    kept = mask & ~drop
    kept = torch.where(kept.any(1, keepdim=True), kept, mask)
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            s = q[b, :, h].float() @ k[b, :, h // rep].float().T * hd ** -0.5
            p = torch.softmax(s.masked_fill(~kept, -torch.inf), -1)
            out[b, :, h] = (p @ v[b, :, h // rep].float()).to(q.dtype)
    return out


# the planted fault's cases: the window binds on the last 512 query rows
# at S = 4608, window 4096, and past the first block at S = 4064, window 64
SWA_FAULTS = [(S, c, w) for S, w in ((4608, 4096), (4064, 64))
              for c in (True, False)]


def kernels_flash_hd120() -> dict:
    """K2 at head dim 120 against its plain version (and the oracle where
    S is small enough for its S x S scores) on the grid above, bf16 also
    element by element (``bf16_excess``), with the planted window-edge
    fault shown to fail that bound; then the device time at Danube's
    prefill shape with its bound, SDPA's time for the same function and
    hd 128's at the same S and window (the cost of the padded columns).
    Returns K2's row of the kernels line at that shape."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    tol = {"float32": TOL_F32, "bfloat16": TOL_BF16}
    worst_excess, n_cases = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for S in SWA_S:
            for rep in (1, 4):
                q, k, v = flash_case(120 + S, 1, S, 2 * rep, 2, 120, dtype)
                for causal, window in SWA_MASKS:
                    got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                 window=window)
                    plain = fa.flash_attention_torch(q, k, v, causal=causal,
                                                     window=window)
                    e = max_err(got, plain)
                    if S <= 1024:
                        e = max(e, max_err(got, ref.flash_attention_ref(
                            q, k, v, causal=causal, window=window)))
                    x = (bf16_excess(got, plain) if name == "bfloat16"
                         else 0.0)
                    check(got.shape == q.shape and e < tol[name] and x <= 1,
                          f"flash hd 120 {name} S={S} rep={rep} causal="
                          f"{causal} window={window}: {e} (bound used "
                          f"{x:.3f} times)")
                    worst[name] = max(worst[name], e)
                    worst_excess = max(worst_excess, x)
                    n_cases += 1
    faults = []
    for S, causal, window in SWA_FAULTS:
        q, k, v = flash_case(120 + S, 1, S, 8, 2, 120, torch.bfloat16)
        plain = fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        bad = window_edge_fault(q, k, v, causal=causal, window=window)
        faults.append({"S": S, "causal": causal, "window": window,
                       "max_abs_err": max_err(bad, plain),
                       "excess": bf16_excess(bad, plain)})
    B, S, H, Kv, hd = SWA_MAIN
    main = {}
    for width in (120, 128):
        q, k, v = flash_case(5, B, S, H, Kv, width, torch.bfloat16)
        kernel = lambda: fa.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=True, window=SWA_WINDOW)
        got = kernel()
        plain = fa.flash_attention_torch(q, k, v, causal=True,
                                         window=SWA_WINDOW)
        err, excess = max_err(got, plain), bf16_excess(got, plain)
        check(err < TOL_BF16 and excess <= 1, f"flash hd {width} at the "
              f"Danube shape: {err} (bound used {excess:.3f} times)")
        check(bool(torch.isfinite(got.float()).all()),
              "flash output not finite")
        row = {"max_abs_err": err, "excess": excess,
               "device_ms": profiled_ms(kernel)[0]}
        if width == 120:
            bad = window_edge_fault(q, k, v, causal=True, window=SWA_WINDOW)
            faults.append({"S": S, "causal": True, "window": SWA_WINDOW,
                           "H": H, "Kv": Kv,
                           "max_abs_err": max_err(bad, plain),
                           "excess": bf16_excess(bad, plain)})
            del bad
            sdpa = sdpa_banded(q, k, v, SWA_WINDOW)
            lib_err = max_err(got, sdpa().transpose(1, 2))
            check(lib_err < TOL_BF16, f"flash hd 120 vs library: {lib_err}")
            byts, flops = flash_bound(B, S, H, Kv, hd, 2, True, SWA_WINDOW)
            t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            lib_dev_ms, lib_kernels = profiled_ms(sdpa)
            row.update({
                "ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: fa.flash_attention_torch(
                    q, k, v, causal=True, window=SWA_WINDOW), warmup=1,
                    iters=3),
                "library_ms": time_ms(sdpa), "library_err": lib_err,
                "library_device_ms": lib_dev_ms,
                "library_kernels": lib_kernels,
                "band_pairs": band_pairs(S, True, SWA_WINDOW),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": byts, "flops": flops})
        main[f"hd{width}"] = row
        del q, k, v, got, plain
    check(all(f["excess"] > 1 for f in faults),
          f"the bf16 bound passes a planted window-edge fault: {faults}")
    head = main["hd120"]
    return {
        "name": "flash_attention_fwd_hd120", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "shape": {"B": B, "S": S, "H": H, "Kv": Kv, "hd": hd,
                  "causal": True, "window": SWA_WINDOW, "dtype": "bf16"},
        **{key: head[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "device_ms", "library_device_ms")},
        "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "cases": n_cases, "max_err_bf16_grid": worst["bfloat16"],
        "max_err_f32_grid": worst["float32"],
        "max_excess_bf16": max(worst_excess, head["excess"]),
        "bf16_bound": {"ulps": BF16_ULPS, "row_share": ROW_SHARE},
        "planted_faults": faults, "main": main}


# K2 at the new families' shapes: hd 128 at GQA rep 6 (InternVL2-26B: 48
# heads over 8), 8 (Jamba) and 16 (Qwen3-MoE), causal and not, at ragged
# and whole-tile S; and hd 64 non-causal at Whisper's encoder shape (1500
# frames, 8 heads, batch 16), each in both dtypes, bf16 element by element
FAMILY_REPS = (6, 8, 16)
FAMILY_REP_S = (1, 77, 130, 1024)
VLM_SHAPE = (4, 1024, 48, 8, 128)       # serve_vlm's prefill: 256 + 768
WHISPER_SHAPE = (16, 1500, 8, 8, 64)    # serve_encdec's encoder


def flash_check(q, k, v, causal, what, oracle=False) -> tuple:
    """K2 against its plain version (and the oracle) on ``q, k, v``:
    (largest difference, bf16 excess); fails past TOL_F32 / TOL_BF16 or
    an excess over 1."""
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    plain = fa.flash_attention_torch(q, k, v, causal=causal)
    e = max_err(got, plain)
    if oracle:
        e = max(e, max_err(got, ref.flash_attention_ref(q, k, v,
                                                        causal=causal)))
    bf16 = q.dtype == torch.bfloat16
    x = bf16_excess(got, plain) if bf16 else 0.0
    check(got.shape == q.shape and e < (TOL_BF16 if bf16 else TOL_F32)
          and x <= 1 and bool(torch.isfinite(got.float()).all()),
          f"flash {what} causal={causal}: {e} (bound used {x:.3f} times)")
    return e, x


def kernels_flash_families() -> dict:
    """K2 at the grid above, then at InternVL2's prefill shape (rep 6)
    and at Whisper's encoder shape, where it is timed (f32, the dtype
    serve_encdec runs; bf16 beside it) with its bound and SDPA's time.
    Returns the hd-64 row of the kernels line."""
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for rep in FAMILY_REPS:
            for S in FAMILY_REP_S:
                q, k, v = flash_case(60 + rep + S, 2, S, 2 * rep, 2, 128,
                                     dtype)
                for causal in (True, False):
                    e, x = flash_check(q, k, v, causal, f"{name} rep={rep} "
                                       f"S={S}", oracle=S <= 130)
                    worst[name] = [max(worst[name][0], e),
                                   max(worst[name][1], x)]
                    n_cases += 1
        for case in (VLM_SHAPE, WHISPER_SHAPE):
            q, k, v = flash_case(61, *case, dtype)
            for causal in ((True,) if case is VLM_SHAPE else (False, True)):
                e, x = flash_check(q, k, v, causal, f"{name} {case}")
                worst[name] = [max(worst[name][0], e),
                               max(worst[name][1], x)]
                n_cases += 1
            del q, k, v
    B, S, H, Kv, hd = WHISPER_SHAPE
    timed = {}
    for dtype, peak in ((torch.float32, F32_FLOPS_PER_S),
                        (torch.bfloat16, BF16_FLOPS_PER_S)):
        q, k, v = flash_case(62, B, S, H, Kv, hd, dtype)
        kernel = lambda: fa.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=False)
        got = kernel()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            qt, kt, vt)
        lib_err = max_err(got, sdpa().transpose(1, 2))
        check(lib_err < (TOL_F32 if dtype == torch.float32 else TOL_BF16),
              f"flash hd 64 vs library ({dtype}): {lib_err}")
        byts, flops = flash_bound(B, S, H, Kv, hd, q.element_size(), False)
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / peak
        timed[str(dtype).split(".")[1]] = {
            "max_abs_err": max_err(got, fa.flash_attention_torch(
                q, k, v, causal=False)),
            "library_err": lib_err, "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: fa.flash_attention_torch(
                q, k, v, causal=False), warmup=1, iters=3),
            "library_ms": time_ms(sdpa),
            "device_ms": profiled_ms(kernel)[0],
            "library_device_ms": profiled_ms(sdpa)[0],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": ("f32 CUDA cores, 67 TFLOP/s"
                           if dtype == torch.float32
                           else "bf16 tensor cores, 989 TFLOP/s"),
            "bytes": byts, "flops": flops}
        del q, k, v, got, qt, kt, vt
    head = timed["float32"]
    return {
        "name": "flash_attention_fwd_hd64", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "shape": {"B": B, "S": S, "H": H, "Kv": Kv, "hd": hd,
                  "causal": False, "dtype": "f32"},
        **{key: head[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "device_ms", "library_device_ms",
                                      "bound_peak")},
        "bf16": timed["bfloat16"], "cases": n_cases,
        "reps": list(FAMILY_REPS), "rep_S": list(FAMILY_REP_S),
        "max_err_bf16_grid": worst["bfloat16"][0],
        "max_excess_bf16": worst["bfloat16"][1],
        "max_err_f32_grid": worst["float32"][0]}


def kernels_flash() -> dict:
    worst = 0.0
    for (B, S, H, Kv, hd) in FLASH_GRID:
        for causal, window in FLASH_MASKS:
            q, k, v = flash_case(42, B, S, H, Kv, hd, torch.float32)
            got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
            plain = fa.flash_attention_torch(q, k, v, causal=causal,
                                             window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            e = max(max_err(got, plain), max_err(got, want))
            check(e < TOL_F32, f"flash f32 {(B, S, H, Kv, hd)} causal="
                               f"{causal} window={window}: {e}")
            worst = max(worst, e)
    for S, causal, window in FLASH_RAGGED:
        q, k, v = flash_case(21, 2, S, 4, 2, 16, torch.float32)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        e = max_err(got, want)
        check(got.shape == want.shape and e < TOL_F32,
              f"flash ragged S={S} causal={causal} window={window}: {e}")
        worst = max(worst, e)
    worst_bf16 = 0.0
    for case, causal, window, strided in flash_bf16_grid():
        q, k, v = (fused_case if strided else flash_case)(
            1, *case, torch.bfloat16)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        plain = fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        e = max(max_err(got, plain), max_err(got, want))
        check(got.shape == want.shape and e < TOL_BF16,
              f"flash bf16 {case} causal={causal} window={window} "
              f"strided={strided}: {e}")
        worst_bf16 = max(worst_bf16, e)

    # the main path's shapes: batch-1 prefill at the serve burst's prompt
    # lengths (and one that is not a whole number of blocks), OLMo-1B
    # heads, bf16, causal
    B, H, Kv, hd = 1, 16, 16, 128
    shapes = []
    for S in FLASH_MAIN_S:
        q, k, v = flash_case(7, B, S, H, Kv, hd, torch.bfloat16)
        got = fa.flash_attention_fwd(q, k, v, causal=True)
        plain = fa.flash_attention_torch(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        err = max(max_err(got, plain), max_err(got, want))
        check(err < TOL_BF16, f"flash bf16 main shape S={S}: {err}")
        check(bool(torch.isfinite(got.float()).all()),
              "flash output not finite")
        del want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            qt, kt, vt, is_causal=True)
        lib_err = max_err(got, sdpa().transpose(1, 2))
        check(lib_err < TOL_BF16, f"flash vs library S={S}: {lib_err}")
        kernel = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: fa.flash_attention_torch(
            q, k, v, causal=True), warmup=1, iters=5)
        library_ms = time_ms(sdpa)
        dev_ms, _ = profiled_ms(kernel)
        lib_dev_ms, lib_kernels = profiled_ms(sdpa)
        byts, flops = flash_bound(B, S, H, Kv, hd, 2, True)
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        shapes.append({
            "S": S, "max_abs_err": err, "library_err": lib_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "library_kernels": lib_kernels,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts, "flops": flops})
    head = shapes[-1]                                   # S = 1024
    # S = 1024 without the causal mask: every block does the same work
    # (16 key tiles), so its time beside the causal one says what the
    # causal grid's uneven blocks cost
    got = fa.flash_attention_fwd(q, k, v, causal=False)
    full_err = max_err(got, fa.flash_attention_torch(q, k, v, causal=False))
    check(full_err < TOL_BF16, f"flash bf16 S=1024 non-causal: {full_err}")
    full = {"max_abs_err": full_err,
            "device_ms": profiled_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=False))[0],
            "library_device_ms": profiled_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt))[0]}
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "shape": {"B": B, "S": head["S"], "H": H, "Kv": Kv, "hd": hd,
                  "causal": True, "dtype": "bf16"},
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_err_f32_grid": worst, "max_err_bf16_grid": worst_bf16,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "library_ms": head["library_ms"], "device_ms": head["device_ms"],
        "library_device_ms": head["library_device_ms"], "shapes": shapes,
        "non_causal_1024": full,
    }


def rwkv_case(seed, B, T, H, dh, with_s0=True, decays="recipe"):
    """The reference kernel test's recipe (tests/test_kernels.py), made
    with numpy: r, k, v ~ N(0, 1), w = sigmoid(N) * 0.5 + 0.45, u = 0.3 N,
    s0 = 0.1 N.  ``decays="strong"``: w ~ U(0, 0.1), a tenth of it 0 (the
    1e-12 floor), so the log-decay sum passes -30 within a chunk and the
    clip of k_d binds; ``"near1"``: w = 1 - U(0, 1e-4)."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa
    r, k, v = n(B, T, H, dh), n(B, T, H, dh), n(B, T, H, dh)
    w = 1.0 / (1.0 + np.exp(-n(B, T, H, dh))) * 0.5 + 0.45
    if decays == "strong":
        w = np.where(rng.uniform(size=w.shape) < 0.1, 0.0,
                     rng.uniform(0.0, 0.1, w.shape))
    elif decays == "near1":
        w = 1.0 - rng.uniform(0.0, 1e-4, w.shape)
    u = n(H, dh) * 0.3
    s0 = n(B, H, dh, dh) * 0.1 if with_s0 else None
    return tuple(None if a is None else torch.tensor(
        np.asarray(a, np.float32), device=DEV) for a in (r, k, v, w, u, s0))


RWKV_GRID = [  # B, T, H, dh, chunk, with s0, decays
    (2, 128, 2, 16, 32, True, "recipe"), (1, 64, 4, 32, 16, True, "recipe"),
    (2, 96, 1, 64, 32, True, "recipe"),   # tests/test_kernels.py's grid
    (2, 8, 2, 16, 64, True, "recipe"),    # one ragged chunk
    (1, 48, 3, 64, 64, True, "recipe"),
    (2, 64, 2, 32, 16, False, "recipe"),  # s0 = None (zeros)
    (1, 1, 4, 64, 64, True, "recipe"),    # ragged single chunks
    (2, 7, 2, 64, 64, True, "recipe"), (1, 33, 3, 32, 64, True, "recipe"),
    (1, 33, 2, 16, 64, False, "strong"),
    (1, 256, 4, 64, 64, True, "strong"),  # the clip of k_d binds
    (2, 128, 2, 32, 32, True, "strong"), (1, 96, 2, 16, 16, True, "strong"),
    (1, 256, 4, 64, 64, True, "near1"),   # w near 1
    (1, 64, 2, 16, 8, True, "near1"),
]
# K4's prompt lengths on the serve path (serve_rwkv's LoadSpec) at RWKV6-7B's
# 64 heads of 64; the last is the main shape
RWKV_LENGTHS = (64, 512, 1024)


def rwkv_bound(B, T, H, dh, L):
    """Bytes (r, k, v, w, u, s0 read once; y, S_T written once; f32) and
    operations: a chunk and head does the strictly causal scores and
    scores @ v over L (L - 1) / 2 pairs (2 dh each), r_d @ S and the state
    update (2 L dh^2 each), which is 2 dh (L - 1 + 2 dh) a step."""
    byts = 4 * (5 * B * T * H * dh + H * dh + 2 * B * H * dh * dh)
    flops = 2 * B * H * T * dh * (L - 1 + 2 * dh)
    return byts, flops


def kernels_rwkv() -> dict:
    worst = worst_oracle = 0.0
    for (B, T, H, dh, chunk, with_s0, decays) in RWKV_GRID:
        args = rwkv_case(7, B, T, H, dh, with_s0, decays)
        got = rs.rwkv6_scan_fwd(*args, chunk=chunk)
        plain = rs.rwkv6_scan_torch(*args, chunk=chunk)
        e = max(max_err(g, p) for g, p in zip(got, plain))
        check(e < TOL_SCAN, f"rwkv6 scan {(B, T, H, dh, chunk, with_s0, decays)}"
                            f" vs plain: {e}")
        worst = max(worst, e)
        # where the clip binds, the chunked form (the reference's kernel and
        # the plain version alike) leaves the per-step oracle by design
        if decays != "strong":
            want = ref.rwkv6_scan_ref(*args)
            e = max(max_err(g, p) for g, p in zip(got, want))
            check(e < TOL_SCAN, f"rwkv6 scan {(B, T, H, dh, chunk, with_s0, decays)}"
                                f" vs oracle: {e}")
            worst_oracle = max(worst_oracle, e)

    # the main path's shapes: RWKV6-7B prefills (64 heads of 64), chunk 64
    B, H, dh, L = 1, 64, 64, 64
    by_T = {}
    for T in RWKV_LENGTHS:
        args = rwkv_case(13, B, T, H, dh)
        got = rs.rwkv6_scan_fwd(*args, chunk=L)
        plain = rs.rwkv6_scan_torch(*args, chunk=L)
        err = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
        check(err < TOL_SCAN, f"rwkv6 scan T={T}: {err}")
        check(all(bool(torch.isfinite(t).all()) for t in got),
              "rwkv6 scan output not finite")
        byts, flops = rwkv_bound(B, T, H, dh, L)
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        by_T[T] = {
            "max_abs_err": err, "max_abs_y": float(plain[0].abs().max()),
            "ms": time_ms(lambda: rs.rwkv6_scan_fwd(*args, chunk=L)),
            "device_ms": profiled_ms(
                lambda: rs.rwkv6_scan_fwd(*args, chunk=L))[0],
            "plain_ms": time_ms(lambda: rs.rwkv6_scan_torch(*args, chunk=L),
                                warmup=1, iters=5),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts, "flops": flops,
        }
    head = by_T[RWKV_LENGTHS[-1]]
    return {
        "name": "rwkv6_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:93",
        "shape": {"B": B, "T": RWKV_LENGTHS[-1], "H": H, "dh": dh,
                  "chunk": L, "dtype": "f32"},
        **head,
        "max_err_f32_grid": worst, "max_err_oracle_grid": worst_oracle,
        "grid_cases": len(RWKV_GRID),
        # the operations at the CUDA cores' f32 peak; at dh 64 the kernel
        # runs them as three TF32 products on the tensor cores (495 TFLOP/s,
        # 3 x 1.6 GFLOP in 9.7 us): the bytes bound it either way
        "bound_peak": "f32 CUDA cores, 67 TFLOP/s",
        "by_T": by_T,
        "build": {dh_: rs.kernel_info(dh_) for dh_ in rs.HEAD_DIMS},
        "library_ms": None,           # no single PyTorch call computes WKV
    }


QUANT_GRID = [  # N, C, dtype, kind — the reference's tests' shapes, ties,
    # an all-zero row, bf16, widths that take the one-element path, and a
    # row longer than one tile
    (300, 256, torch.float32, "random"), (130, 64, torch.float32, "special"),
    (7, 128, torch.float32, "special"), (1, 32, torch.float32, "random"),
    (66, 40, torch.bfloat16, "special"), (64, 96, torch.bfloat16, "random"),
    (5, 77, torch.float32, "random"), (3, 20001, torch.float32, "special"),
    (2, 8193, torch.bfloat16, "random"),
]
# the training path's K3 shapes: int8_ring over 4 pods on full-width
# OLMo-1B's largest buckets (268,435,456 elements a rank, chunks of
# 67,108,864): every rank's chunks (16 rows), and the per-hop and final
# rows of every rank (4 rows)
QUANT_MAIN = [(4, 67_108_864), (16, 67_108_864)]


def quant_case(N, C, dtype, kind, seed):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    x = torch.randn((N, C), generator=gen, device=DEV) * 3
    if kind == "special":
        x[0] = 0.0                                    # an all-zero row
        if N > 1:                                     # exact .5 ties
            x[1] = torch.arange(C, device=DEV) % 9 - 4.5
            x[1, 0] = 127.0                           # scale exactly 1.0
    return x.to(dtype)


def quant_equal(x) -> None:
    """K3a and K3b against their plain versions on ``x``: q, scale and the
    dequantized values (f32 and bf16) bit for bit."""
    q, s = qk.quantize_int8(x)
    pq, ps = qk.quantize_int8_torch(x)
    check(torch.equal(q, pq) and torch.equal(s, ps),
          f"K3a {tuple(x.shape)} {x.dtype}: q or scale differ")
    for dt in (torch.float32, torch.bfloat16):
        d = qk.dequantize_int8(q, s, dt)
        check(torch.equal(d, qk.dequantize_int8_torch(pq, ps, dt)),
              f"K3b {tuple(x.shape)} -> {dt}: differs")


def kernels_quant() -> list:
    for i, (N, C, dt, kind) in enumerate(QUANT_GRID):
        x = quant_case(N, C, dt, kind, i)
        quant_equal(x)
        if N > 2:            # rows one element off 16-byte alignment
            quant_equal(x.reshape(-1)[1:1 + (N - 1) * C].reshape(N - 1, C))
    shapes = []
    for N, C in QUANT_MAIN:
        x = quant_case(N, C, torch.float32, "random", N)
        q, s = qk.quantize_int8(x)
        pq, ps = qk.quantize_int8_torch(x)
        check(qk.vec_ok(C, torch.float32, x, q), "main shape not vectorised")
        quant_err = max(max_err(q, pq), max_err(s, ps))
        check(torch.equal(q, pq) and torch.equal(s, ps),
              f"K3a main shape {(N, C)}: q or scale differ by {quant_err}")
        d = qk.dequantize_int8(q, s)
        pd = qk.dequantize_int8_torch(pq, ps)
        dequant_err = max_err(d, pd)
        check(torch.equal(d, pd), f"K3b main shape {(N, C)}: differs by "
                                  f"{dequant_err}")
        del pq, ps, pd
        lib = torch.mul(q, s)          # int8 * f32 promotes to f32
        check(torch.equal(lib, d), "K3b vs torch.mul differs")
        del lib
        byts = 4 * N * C + N * C + 4 * N   # x / out f32, q int8, scales
        t_bytes = byts / HBM_BYTES_PER_S
        shapes.append({
            "N": N, "C": C, "bytes": byts, "bound_ms": t_bytes * 1e3,
            "quant_err": quant_err, "dequant_err": dequant_err,
            "quant_ms": time_ms(lambda: qk.quantize_int8(x), iters=10),
            "quant_plain_ms": time_ms(lambda: qk.quantize_int8_torch(x),
                                      warmup=1, iters=3),
            "dequant_ms": time_ms(lambda: qk.dequantize_int8(q, s), iters=10),
            "dequant_plain_ms": time_ms(
                lambda: qk.dequantize_int8_torch(q, s), warmup=1, iters=3),
            "dequant_library_ms": time_ms(lambda: torch.mul(q, s), iters=10)})
        del x, q, s, d
        torch.cuda.empty_cache()
    head = shapes[0]                                    # (4, 67,108,864)
    shared = {"route": "cuda", "source": "src/repro_torch/csrc/quant_int8.cu",
              "bound_ms": head["bound_ms"],
              "bound_by": "bytes", "bytes": head["bytes"],
              "shape": {"N": head["N"], "C": head["C"], "dtype": "f32"},
              "grid": [[N, C, str(dt).replace("torch.", ""), kind]
                       for N, C, dt, kind in QUANT_GRID], "shapes": shapes}
    return [
        dict(shared, name="quantize_int8",
             replaces="src/repro/kernels/quant.py:67", ms=head["quant_ms"],
             max_abs_err=max(r["quant_err"] for r in shapes),
             plain_ms=head["quant_plain_ms"],
             library_ms=None),          # no single PyTorch call quantizes
        dict(shared, name="dequantize_int8",
             replaces="src/repro/kernels/quant.py:89", ms=head["dequant_ms"],
             max_abs_err=max(r["dequant_err"] for r in shapes),
             plain_ms=head["dequant_plain_ms"],
             library_ms=head["dequant_library_ms"]),   # torch.mul(q, s)
    ]


def phase_kernels(k1_jobs=()) -> list:
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not use TF32 in these comparisons")
    rows = [kernels_paged(k1_jobs), kernels_flash(), kernels_flash_hd120(),
            kernels_flash_families(), kernels_rwkv()] + kernels_quant()
    torch.cuda.synchronize()
    emit("kernels", tol_f32=TOL_F32, tol_bf16=TOL_BF16, tol_scan=TOL_SCAN,
         kernels=rows)
    return rows


# ---------------------------------------------------------------------------
# phase: serve_f32_smoke
# ---------------------------------------------------------------------------

def make_params(cfg, seed: int):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return registry.init_params(cfg, gen)


def phase_serve_f32_smoke() -> None:
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    params = make_params(cfg, 0)
    spec = LoadSpec(n_requests=6, rate_rps=0.0, prompt_lens=(8, 16),
                    max_new_tokens=6, vocab_size=cfg.vocab_size, seed=3)
    rcfg = dataclasses.replace(smoke(all_archs()["rwkv6-7b"]),
                               dtype="float32")
    rparams = make_params(rcfg, 0)
    rspec = dataclasses.replace(spec, prompt_lens=(8, 16, 48),
                                vocab_size=rcfg.vocab_size)
    # the sliding-window ring (window 16): prompts within, at and past the
    # window, decoded past it
    dcfg = dataclasses.replace(smoke(all_archs()["h2o-danube-3-4b"]),
                               dtype="float32")
    dparams = make_params(dcfg, 0)
    dspec = dataclasses.replace(spec, prompt_lens=(8, 16, 37),
                                max_new_tokens=20,
                                vocab_size=dcfg.vocab_size)

    def run(arch_cfg, arch_params, load, **kw):
        eng = ContinuousEngine(arch_cfg, arch_params, n_slots=4,
                               cache_len=64, block_size=8, **kw)
        reqs = eng.generate(make_requests(load))
        eng.scheduler.check()
        check(eng.kv.n_free == eng.kv.n_blocks, "smoke pool not recycled")
        check(all(len(r.generated) == load.max_new_tokens for r in reqs),
              "smoke: short stream")
        return [list(r.generated) for r in reqs]

    # the static engine: left-padded mixed prompts in one batch (K2 at
    # B = 4), and equal-length prompts, which the continuous engine serves
    # with the same streams
    rng = np.random.default_rng(7)
    static_prompts = {name: [rng.integers(0, cfg.vocab_size, size=n)
                             .astype(np.int32) for n in lens]
                      for name, lens in (("mixed", (5, 21, 12, 37)),
                                         ("equal", (12,) * 4))}

    def run_static(prompts):
        eng = Engine(cfg, None, batch_size=4, cache_len=64, params=params)
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        check(all(len(r.generated) == 6 for r in reqs),
              "static smoke: short stream")
        return [list(r.generated) for r in reqs]

    def run_both():
        return {name: run_static(p) for name, p in static_prompts.items()}

    ops.reset_launch_counts()
    with_kernels = run(cfg, params, spec, paged=True, debug=True)
    rwkv_kernels = run(rcfg, rparams, rspec)
    swa_kernels = run(dcfg, dparams, dspec)
    static_kernels = run_both()
    cont = ContinuousEngine(cfg, params, n_slots=4, cache_len=64,
                            block_size=8, paged=True)
    cont_equal = [list(r.generated) for r in cont.generate(
        [ServeRequest(prompt=p, max_new_tokens=6)
         for p in static_prompts["equal"]])]
    serving = ("flash_attention", "paged_attention", "rwkv6_scan")
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in serving),
          f"f32 smoke did not reach every serving kernel: {counts}")
    with runtime.use_policy(attention_impl="torch",
                            paged_attention_impl="torch", rwkv_impl="torch"):
        ops.reset_launch_counts()
        plain = run(cfg, params, spec, paged=True)
        dense = run(cfg, params, spec, paged=False)
        rwkv_plain = run(rcfg, rparams, rspec)
        swa_plain = run(dcfg, dparams, dspec)
        static_plain = run_both()
        check(all(v == 0 for v in ops.launch_counts().values()),
              "impl='torch' launched a kernel")
    check(with_kernels == plain, f"f32 smoke token streams differ: "
                                 f"{with_kernels} vs {plain}")
    check(with_kernels == dense, "f32 smoke: paged differs from dense")
    check(rwkv_kernels == rwkv_plain, f"f32 RWKV smoke token streams "
                                      f"differ: {rwkv_kernels} vs "
                                      f"{rwkv_plain}")
    check(swa_kernels == swa_plain, f"f32 windowed smoke token streams "
                                    f"differ: {swa_kernels} vs {swa_plain}")
    check(static_kernels == static_plain, f"f32 static engine token streams "
                                          f"differ: {static_kernels} vs "
                                          f"{static_plain}")
    check(static_kernels["equal"] == cont_equal,
          f"f32 static engine differs from the continuous engine on equal "
          f"prompts: {static_kernels['equal']} vs {cont_equal}")

    # the new families at smoke size: the MoE archs through the paged
    # engine, Jamba through the dense one (the reference's smoke Jamba has
    # no attention layer, so also a Jamba with one in a group of 4), the
    # encoder-decoder and the VLM through registry (no engine passes frames
    # or patches)
    fams = family_smoke_models()
    ops.reset_launch_counts()
    fam_kernels = {n: run_family(cfg_, p_, run, spec)
                   for n, (cfg_, p_) in fams.items()}
    fam_counts = ops.launch_counts()
    check(fam_counts["flash_attention"] > 0
          and fam_counts["paged_attention"] > 0,
          f"the families' f32 smoke missed a kernel: {fam_counts}")
    with runtime.use_policy(attention_impl="torch",
                            paged_attention_impl="torch"):
        ops.reset_launch_counts()
        fam_plain = {n: run_family(cfg_, p_, run, spec)
                     for n, (cfg_, p_) in fams.items()}
        check(all(v == 0 for v in ops.launch_counts().values()),
              "impl='torch' launched a kernel")
    for n in fams:
        check(fam_kernels[n] == fam_plain[n],
              f"f32 {n} smoke token streams differ: {fam_kernels[n]} vs "
              f"{fam_plain[n]}")
    emit("serve_f32_smoke", equal_streams=True, launches=counts,
         family_launches=fam_counts, families=sorted(fams),
         n_requests=len(with_kernels), n_rwkv_requests=len(rwkv_kernels),
         n_swa_requests=len(swa_kernels), swa_window=dcfg.sliding_window,
         swa_prompt_lens=list(dspec.prompt_lens),
         swa_max_new=dspec.max_new_tokens)


FAMILY_SMOKE = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
                "jamba-1.5-large-398b", "whisper-base", "internvl2-26b")
JAMBA_ATTN = dict(layer_group=4, attn_period=4, num_layers=8)


def family_smoke_models() -> dict:
    """name -> (f32 smoke config, parameters on the card) of the new
    families, and a Jamba with an attention layer in each group of 4."""
    out = {}
    for name in FAMILY_SMOKE:
        cfg = dataclasses.replace(smoke(all_archs()[name]), dtype="float32")
        out[name] = (cfg, make_params(cfg, 0))
    cfg = dataclasses.replace(out["jamba-1.5-large-398b"][0], **JAMBA_ATTN)
    out["jamba-with-attention"] = (cfg, make_params(cfg, 0))
    return out


def run_family(cfg, params, run, spec) -> list:
    """One family's smoke streams: an engine's (``run(cfg, params, load,
    paged=...)``) where one serves it, else ``greedy`` through registry."""
    if cfg.family in ("encdec", "vlm"):
        rng = np.random.default_rng(9)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(9)
        batch = {"tokens": torch.tensor(rng.integers(
            0, cfg.vocab_size, (2, 12)).astype(np.int32), device=DEV)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((2, 40, cfg.d_model),
                                          generator=gen, device=DEV)
        else:
            batch["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                           generator=gen, device=DEV)
        return greedy(cfg, params, batch, 6, 12 + cfg.num_patches + 6)[
            "streams"]
    load = dataclasses.replace(spec, prompt_lens=(8, 16, 37),
                               vocab_size=cfg.vocab_size)
    return run(cfg, params, load, paged=paged_supported(cfg))


# ---------------------------------------------------------------------------
# phase: serve (full width)
# ---------------------------------------------------------------------------

def profile_tick(name: str, tick, card: str, ticks: int = 20,
                 share_of: tuple = ()) -> None:
    """Where one engine step's time goes (``--profile``): ``ticks`` calls
    of ``tick`` (a cell as the engine drives it, ending in its host copy),
    timed on the host clock and traced with ``torch.profiler`` for the
    device's share; ``share_of`` names kernels (substrings of their names)
    whose device ms and share of the device time are reported."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    # device-side rows only: the host-side op rows carry their kernels'
    # time a second time
    rows = [(e.key, e.self_device_time_total / ticks / 1e3, e.count // ticks)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    kernel_ms = {sub: sum(ms for k, ms, _ in rows if sub in k)
                 for sub in share_of}
    emit("profile", of=name, card=card, ticks=ticks, tick_ms=tick_ms,
         kernel_ms_per_tick=kernel_ms,
         kernel_share={sub: ms / device_ms if device_ms else None
                       for sub, ms in kernel_ms.items()},
         device_ms_per_tick=device_ms or None,
         device_idle_share=(1 - device_ms / tick_ms) if device_ms else None,
         device_launches_per_tick=sum(r[2] for r in rows),
         top=[{"name": k[:60], "ms_per_tick": ms, "per_tick": n}
              for k, ms, n in rows[:8]])


def decode_tick(cells, args):
    """One decode tick as the engine drives it: cell, argmax, host copy."""
    def tick():
        logits, _ = cells.decode(*args)
        return torch.argmax(logits[:, 0], dim=-1).cpu()
    return tick


def paged_burst(eng, spec):
    """A warm-up (cuBLAS handles, kernel images; not counted), then the
    burst ``spec`` through the paged engine ``eng`` with the launches
    counted: (requests, seconds, launches, peak memory before any check's
    prefill, decode ticks).  Checks every stream, the pool's and tables'
    recycling, and K1 = ticks x layers, K2 = requests x layers."""
    cfg = eng.cfg
    n_layers = cfg.num_layers
    warm = LoadSpec(n_requests=2, rate_rps=0.0, prompt_lens=(128,),
                    max_new_tokens=4, vocab_size=cfg.vocab_size, seed=1)
    eng.generate(make_requests(warm))
    torch.cuda.synchronize()
    reqs = make_requests(spec)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    ticks = sum(1 for e in eng.step_log if e.decoded)
    max_new = spec.max_new_tokens
    check(all(len(r.generated) == max_new for r in reqs),
          f"a request did not get its {max_new} tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "page pool not recycled")
    check(bool((eng._tables_np == eng.kv.trash_page).all()),
          "tables not back to all-trash")
    check(counts["paged_attention"] == ticks * n_layers,
          f"K1 launches {counts['paged_attention']} != ticks {ticks} x "
          f"{n_layers} layers")
    check(counts["flash_attention"] == len(reqs) * n_layers,
          f"K2 launches {counts['flash_attention']} != {len(reqs)} x "
          f"{n_layers} layers")
    return reqs, elapsed, counts, peak, ticks


def phase_serve(card: str, do_profile: bool = False, arch: str = "olmo-1b",
                phase: str = "serve", n_requests: int = 24,
                prompt_lens: tuple = (128, 512, 1024), max_new: int = 64,
                check_lens: tuple = (512, 1000, 128, 77),
                hand: Handoff = None) -> dict:
    """A burst through the paged engine at full width (OLMo-1B in
    ``serve``, Mistral-NeMo-12B in ``serve_nemo``), K1's and K2's launches
    counted; then prefill logits at ``check_lens`` and one decode tick,
    kernels against the plain path."""
    gc.collect()
    torch.cuda.empty_cache()                      # the previous model is gone
    cfg = all_archs()[arch]                       # published widths, bf16
    n_layers = cfg.num_layers
    params = make_params(cfg, 0)
    n_params = sum(t.numel() for _, t in bridge.flatten(params))
    n_slots, cache_len, block_size, depth = 16, 2048, 16, 2
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                           block_size=block_size, paged=True,
                           page_buffer_depth=depth)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in eng._pool.values())

    spec = LoadSpec(n_requests=n_requests, rate_rps=0.0,
                    prompt_lens=prompt_lens, max_new_tokens=max_new,
                    vocab_size=cfg.vocab_size, seed=0)
    reqs, elapsed, counts, peak, ticks = paged_burst(eng, spec)
    if hand is not None and hand.wants("serve_tp") and arch in TP_BURSTS:
        # serve_tp's tp-1 logits, on this engine's free pool (TP_ENGINE's)
        hand.tp1[arch] = probe_logits(eng, tp_prompts(cfg))

    # one prefill and one decode tick, kernels vs impl="torch", on the card
    cells = eng.cells
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in check_lens * (n_slots // len(check_lens))]
    torch_impl = dict(attention_impl="torch", paged_attention_impl="torch")
    tables = np.full((n_slots, cells.max_pages), eng.kv.trash_page, np.int32)
    idx = np.zeros((n_slots,), np.int32)
    tok = np.zeros((n_slots,), np.int32)
    prefill_err, prefill_tol = 0.0, float("inf")
    next_page = 0
    for slot, prompt in enumerate(prompts):
        toks = torch.tensor(prompt, device=DEV)[None]
        lk, caches = cells.prefill(eng.params, toks)
        with runtime.use_policy(**torch_impl):
            lt, _ = cells.prefill(eng.params, toks)
        check(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        check(lk.shape == (1, 1, cfg.vocab_size), f"prefill logits {lk.shape}")
        prefill_err = max(prefill_err, max_err(lk, lt))
        prefill_tol = min(prefill_tol, logits_tol(lt))
        need = -(-(len(prompt) + 1) // block_size)
        tables[slot, :need] = np.arange(next_page, next_page + need)
        next_page += need
        cells.insert(eng._pool, caches, torch.tensor(tables[slot],
                                                     device=DEV))
        idx[slot] = len(prompt)
        tok[slot] = int(torch.argmax(lk[0, -1]))
    check(prefill_err <= prefill_tol,
          f"prefill logits: kernels vs plain differ by {prefill_err} "
          f"(tolerance {prefill_tol})")
    args = (eng.params, torch.tensor(tok, device=DEV)[:, None],
            torch.tensor(idx, device=DEV), eng._pool,
            torch.tensor(tables, device=DEV))
    dk, _ = cells.decode(*args)
    with runtime.use_policy(**torch_impl):
        dt, _ = cells.decode(*args)      # rewrites the same token: idempotent
    live = slice(0, len(prompts))
    check(bool(torch.isfinite(dk).all()), "decode logits not finite")
    check(dk.shape == (n_slots, 1, cfg.vocab_size), f"decode logits {dk.shape}")
    decode_err, decode_tol = max_err(dk[live], dt[live]), logits_tol(dt[live])
    check(decode_err <= decode_tol,
          f"decode logits: kernels vs plain differ by {decode_err} "
          f"(tolerance {decode_tol})")
    decode_mean_err = float((dk[live] - dt[live]).abs().mean())
    if do_profile:
        profile_tick(f"{cfg.name} decode tick", decode_tick(cells, args),
                     card, share_of=("paged_decode",))
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, size=1024),
                            device=DEV)[None]
        profile_tick(f"{cfg.name} prefill, 1024 tokens", lambda: torch.argmax(
            cells.prefill(eng.params, toks)[0][0, -1]).cpu(), card, ticks=5,
            share_of=("flash_fwd",))

    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "n_layers": n_layers, "d_model": cfg.d_model,
        "n_slots": n_slots, "cache_len": cache_len, "block_size": block_size,
        "pool_bytes": pool_bytes, "n_requests": len(reqs),
        "prompt_lens": list(spec.prompt_lens), "tokens": n_tok,
        "seconds": elapsed, "tok_per_s": n_tok / elapsed,
        "ttft_median_s": statistics.median(ttft),
        "tpot_median_s": statistics.median(tpot),
        "decode_ticks": ticks, "launches": counts,
        "prefill_logits_err": prefill_err, "prefill_logits_tol": prefill_tol,
        "decode_logits_err": decode_err, "decode_logits_tol": decode_tol,
        "decode_logits_mean_err": decode_mean_err,
        "peak_memory_bytes": peak,
    }
    emit(phase, **out)
    return out


def phase_serve_nemo(card: str, do_profile: bool = False,
                     hand: Handoff = None) -> dict:
    """Mistral-NeMo-12B at full width through the paged engine: K1 at GQA
    rep 4 on a model path, K2 at rep 4."""
    return phase_serve(card, do_profile, arch="mistral-nemo-12b",
                       phase="serve_nemo", n_requests=8,
                       prompt_lens=(128, 1024), max_new=32,
                       check_lens=(1024, 1000, 128, 77), hand=hand)


# ---------------------------------------------------------------------------
# phases: serve_moe, serve_vlm, serve_encdec (the new families, full width)
# ---------------------------------------------------------------------------

START_BYTES = 1 << 30       # a full-width phase starts with at most this
#                             much device memory allocated: the phase
#                             before it has freed its weights and caches
MOONSHOT_PARAMS = 28_552_923_136
INTERNVL2_PARAMS = 19_899_009_024
WHISPER_PARAMS = 70_957_568
MOE_ENGINE = dict(n_slots=8, cache_len=2048, block_size=16)
MOE_LOAD = dict(n_requests=8, prompt_lens=(128, 1024), max_new=32)
MOE_CHECK_LENS = (1024, 1000, 128, 77)
VLM_BATCH, VLM_TEXT, VLM_STEPS = 4, 768, 32     # + 256 patches: S = 1024
WHISPER_BATCH, WHISPER_FRAMES = 16, 1500        # Whisper's 30-s window
WHISPER_PROMPT, WHISPER_STEPS = 4, 60           # within its 448 positions
PAGED = (pa, "paged_attention_torch", {"paged_attention_impl": "torch"})


def phase_start(phase: str) -> int:
    """Free what earlier phases left (their weights and caches are out of
    scope), print the device memory still allocated, and fail past
    START_BYTES."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    emit(phase, at="start", memory_allocated=held)
    check(held <= START_BYTES, f"{phase} starts with {held} bytes allocated")
    return held


def phase_end() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def n_params_of(params) -> int:
    return sum(t.numel() for _, t in bridge.flatten(params))


INIT_PEAK_SHARE = 1.25  # the peak of drawing a model's weights, over the
#                         weights' bytes: one copy, one group's tree and
#                         one leaf's f32 draw (stacking drawn trees would
#                         take two copies)


def init_model(cfg) -> tuple:
    """The model's random weights (seed 0) and the device memory peak of
    drawing them, checked against INIT_PEAK_SHARE of their bytes."""
    torch.cuda.reset_peak_memory_stats()
    params = make_params(cfg, 0)
    peak = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size()
                  for _, t in bridge.flatten(params))
    check(peak <= INIT_PEAK_SHARE * weights, f"drawing {cfg.name} peaked at "
          f"{peak} bytes for {weights} bytes of weights")
    return params, {"weight_bytes": weights, "init_peak_bytes": peak}


def greedy(cfg, params, batch: dict, steps: int, cache_len: int) -> dict:
    """A prefill of ``batch`` then ``steps`` greedy decode steps through
    ``registry`` at one scalar position (no engine passes frames or
    patches): the token streams, the seconds to the first token and of
    each decode step (each ends in its host copy), and the prefill's
    logits."""
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = registry.prefill(cfg, params, batch,
                                          cache_len=cache_len)
        tok = torch.argmax(logits[:, -1], dim=-1)
        streams = [tok.cpu().tolist()]
        ttft = time.perf_counter() - t0
        index = batch["tokens"].shape[1] + (
            cfg.num_patches if "patches" in batch else 0)
        step_s = []
        for i in range(steps):
            t1 = time.perf_counter()
            out, caches = registry.decode_step(
                cfg, params, {"tokens": tok[:, None].to(torch.int32),
                              "index": index + i}, caches)
            tok = torch.argmax(out[:, -1], dim=-1)
            streams.append(tok.cpu().tolist())
            step_s.append(time.perf_counter() - t1)
    del caches
    return {"streams": [list(r) for r in zip(*streams)], "ttft_s": ttft,
            "step_s": step_s, "seconds": time.perf_counter() - t0,
            "prefill_logits": logits}


def arm_contexts(records: list, paged_records=None):
    """The arms of a kernel-vs-plain check: the kernel path; the plain
    path with K2 (and K1, given ``paged_records``) probed beside each plain
    call on its real inputs; and the nudged plain arms that give the
    floor (``NUDGE_SEEDS``)."""
    def plain():
        stack = contextlib.ExitStack()
        stack.enter_context(plain_path(*ATTENTION, probe_attention(records)))
        if paged_records is not None:
            stack.enter_context(plain_path(*PAGED,
                                           probe_paged(paged_records)))
        return stack

    def nudged(seed):
        stack = contextlib.ExitStack()
        stack.enter_context(plain_path(*ATTENTION, nudge_attention(seed)))
        if paged_records is not None:
            stack.enter_context(plain_path(*PAGED,
                                           nudge_attention(seed + 100)))
        return stack

    return {"kernel": contextlib.nullcontext, "torch": plain,
            **{f"nudged{s}": (lambda s=s: nudged(s)) for s in NUDGE_SEEDS}}


def probe_paged(records: list):
    """Run K1 beside each plain paged-attention call on the same inputs
    (every layer's real pool and tables) and keep the plain output."""
    def around(plain, q, pool, tables, lengths, **kw):
        out = plain(q, pool, tables, lengths, **kw)
        got = pa.paged_attention_fwd(q, pool, tables, lengths, **kw)
        records.append({"err": max_err(got, out),
                        "moved": float((got != out).float().mean())})
        return out
    return around


def probe_summary(records: list) -> dict:
    return {key: max(r[key] for r in records) for key in records[0]}


def phase_serve_moe(card: str, do_profile: bool = False,
                    hand: Handoff = None) -> dict:
    """Moonlight-16B-A3B (moonshot-v1-16b-a3b) at full width through the
    paged engine: 48 attention layers (K1, K2 at rep 1), an MoE FFN of 64
    experts top-6 plus 2 shared on each; then one forward's aux losses and
    the logits of prefills at MOE_CHECK_LENS and of one decode tick of the
    same 8-slot batch in every arm, held by the rule for deep random-weight
    bf16 models (kernel arm within max(4 spacings, 2 x the nudged floor),
    K2 and K1 probed on the real inputs)."""
    held = phase_start("serve_moe")
    cfg = all_archs()["moonshot-v1-16b-a3b"]       # published widths, bf16
    n_layers = cfg.num_layers
    params, init = init_model(cfg)
    n_params = n_params_of(params)
    check(n_params == MOONSHOT_PARAMS, f"moonshot has {n_params} params")
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, params, paged=True, **MOE_ENGINE)
    del params
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in eng._pool.values())
    n_slots, block_size = MOE_ENGINE["n_slots"], MOE_ENGINE["block_size"]
    spec = LoadSpec(n_requests=MOE_LOAD["n_requests"], rate_rps=0.0,
                    prompt_lens=MOE_LOAD["prompt_lens"],
                    max_new_tokens=MOE_LOAD["max_new"],
                    vocab_size=cfg.vocab_size, seed=0)
    reqs, elapsed, counts, peak, ticks = paged_burst(eng, spec)
    if hand is not None and hand.wants("serve_tp_families"):
        # serve_tp_families' tp-1 probe and routing, on the free pool
        routes: list = []
        with recorded_routes(routes):
            hand.tp1[cfg.name] = probe_logits(eng, tpf_prompts(cfg)) \
                + (routes,)

    cells = eng.cells
    rng = np.random.default_rng(11)
    with torch.no_grad():
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, size=128),
                            device=DEV)[None]
        _, aux = registry.forward(cfg, eng.params, {"tokens": toks})
    aux = {k: float(aux[k]) for k in ("lb_loss", "z_loss")}
    check(all(np.isfinite(v) for v in aux.values()),
          f"aux losses not finite: {aux}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in MOE_CHECK_LENS * (n_slots // len(MOE_CHECK_LENS))]
    records, paged_records = [], []
    arms = arm_contexts(records, paged_records)
    nudged = [a for a in arms if a.startswith("nudged")]
    tables = np.full((n_slots, cells.max_pages), eng.kv.trash_page, np.int32)
    idx = np.zeros((n_slots,), np.int32)
    tok = np.zeros((n_slots,), np.int32)
    by_len = {n: logits_row() for n in MOE_CHECK_LENS}
    next_page = 0
    for slot, prompt in enumerate(prompts):
        ptoks = torch.tensor(prompt, device=DEV)[None]
        logits = {}
        for arm, context in arms.items():
            with context():
                logits[arm], base = cells.prefill(eng.params, ptoks)
            if arm == "kernel":
                need = -(-(len(prompt) + 1) // block_size)
                tables[slot, :need] = np.arange(next_page, next_page + need)
                next_page += need
                cells.insert(eng._pool, base,
                             torch.tensor(tables[slot], device=DEV))
            del base
        lk = logits["kernel"]
        check(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        compare_logits(by_len[len(prompt)], lk, logits["torch"],
                       [logits[a] for a in nudged])
        idx[slot] = len(prompt)
        tok[slot] = int(torch.argmax(lk[0, -1]))
    check(len(records) == len(prompts) * n_layers,
          f"K2 probed in {len(records)} calls")
    args = (eng.params, torch.tensor(tok, device=DEV)[:, None],
            torch.tensor(idx, device=DEV), eng._pool,
            torch.tensor(tables, device=DEV))
    dlog = {}
    for arm, context in arms.items():       # each rewrites its own token
        with context():
            dlog[arm], _ = cells.decode(*args)
    check(bool(torch.isfinite(dlog["kernel"]).all()),
          "decode logits not finite")
    decode = logits_row()
    compare_logits(decode, dlog["kernel"], dlog["torch"],
                   [dlog[a] for a in nudged])
    check(len(paged_records) == n_layers, f"K1 probed in "
                                          f"{len(paged_records)} calls")
    k2, k1 = probe_summary(records), probe_summary(paged_records)
    emit("serve_moe_logits", prefill=by_len, decode=decode,
         k2_on_real_inputs=k2, k1_on_real_inputs=k1,
         nudge_share=NUDGE_SHARE, nudge_seeds=list(NUDGE_SEEDS))
    check(k2["excess"] <= 1, f"K2 vs plain on real inputs: bf16 bound used "
                             f"{k2['excess']} times")
    check(k1["err"] < TOL_BF16, f"K1 vs plain on real inputs: {k1['err']}")
    check_logits({**by_len, "decode": decode})
    if do_profile:
        profile_tick(f"{cfg.name} decode tick, {n_slots} slots",
                     decode_tick(cells, args), card,
                     share_of=("paged_decode",))
        ptoks = torch.tensor(prompts[0], device=DEV)[None]    # 1024 tokens
        profile_tick(f"{cfg.name} prefill, {len(prompts[0])} tokens",
                     lambda: torch.argmax(cells.prefill(
                         eng.params, ptoks)[0][0, -1]).cpu(), card, ticks=3,
                     share_of=("flash_fwd",))

    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "n_layers": n_layers, "d_model": cfg.d_model,
        "experts": [cfg.num_experts, cfg.experts_per_token,
                    cfg.shared_experts], **MOE_ENGINE,
        "n_pages": cells.n_pages, "pool_bytes": pool_bytes,
        "n_requests": len(reqs), "prompt_lens": list(spec.prompt_lens),
        "tokens": n_tok, "seconds": elapsed, "tok_per_s": n_tok / elapsed,
        "ttft_median_s": statistics.median(ttft),
        "tpot_median_s": statistics.median(tpot), "decode_ticks": ticks,
        "launches": counts, "aux": aux,
        "prefill_logits_err": max(r["err"] for r in by_len.values()),
        "prefill_logits_floor": max(r["floor"] for r in by_len.values()),
        "decode_logits_err": decode["err"],
        "decode_logits_floor": decode["floor"],
        "k2_real_excess": k2["excess"], "k1_real_err": k1["err"],
        "peak_memory_bytes": peak, "start_memory_bytes": held, **init}
    emit("serve_moe", **out)
    del eng, cells, args, dlog
    phase_end()
    return out


def phase_serve_vlm(card: str, do_profile: bool = False,
                    hand: Handoff = None) -> dict:
    """InternVL2-26B at full width through ``registry.prefill`` and
    ``decode_step`` on dense caches (no engine passes patches): a batch of
    4 x (256 patches + 768 text tokens) -> K2 at rep 6, S 1024 -- then 32
    greedy decode steps; then the prefill logits and one decode tick in
    every arm, each arm decoding from its own caches, held by the rule for
    deep random-weight bf16 models."""
    held = phase_start("serve_vlm")
    cfg = all_archs()["internvl2-26b"]            # published widths, bf16
    n_layers = cfg.num_layers
    params, init = init_model(cfg)
    n_params = n_params_of(params)
    check(n_params == INTERNVL2_PARAMS, f"internvl2 has {n_params} params")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    rng = np.random.default_rng(12)
    batch = {"tokens": torch.tensor(rng.integers(
                 0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT)).astype(np.int32),
                 device=DEV),
             "patches": torch.randn((VLM_BATCH, cfg.num_patches, cfg.d_model),
                                    generator=gen, device=DEV).to(
                 torch.bfloat16)}
    S = VLM_TEXT + cfg.num_patches
    cache_len = S + VLM_STEPS
    greedy(cfg, params, {k: v[:1, :64] if k == "tokens" else v[:1]
                         for k, v in batch.items()}, 2,
           64 + cfg.num_patches + 2)                             # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = greedy(cfg, params, batch, VLM_STEPS, cache_len)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == n_layers,
          f"K2 launches {counts['flash_attention']} != {n_layers} layers")
    check(counts["paged_attention"] == 0, f"K1 ran on dense caches: {counts}")
    check(all(len(r) == VLM_STEPS + 1 and all(0 <= t < cfg.vocab_size
                                              for t in r)
              for r in run["streams"]), "a short or out-of-range stream")

    records = []
    arms = arm_contexts(records)
    nudged = [a for a in arms if a.startswith("nudged")]
    prefill, dlog = logits_row(), logits_row()
    logits, caches = {}, {}
    with torch.no_grad():
        for arm, context in arms.items():
            with context():
                logits[arm], caches[arm] = registry.prefill(
                    cfg, params, batch, cache_len=cache_len)
        tok = torch.argmax(logits["kernel"][:, -1], dim=-1)[:, None]
        step = {"tokens": tok.to(torch.int32), "index": S}
        dec = {arm: registry.decode_step(cfg, params, step, caches[arm])[0]
               for arm in arms}
        if do_profile:              # each call rewrites the same position
            profile_tick(f"{cfg.name} decode step, batch {VLM_BATCH}",
                         lambda: torch.argmax(registry.decode_step(
                             cfg, params, step, caches["kernel"])[0][:, -1],
                             dim=-1).cpu(), card)
            profile_tick(f"{cfg.name} prefill, {VLM_BATCH} x {S} tokens",
                         lambda: torch.argmax(registry.prefill(
                             cfg, params, batch, cache_len=cache_len)[0][
                             :, -1], dim=-1).cpu(), card, ticks=3,
                         share_of=("flash_fwd",))
    del caches
    for row, got in ((prefill, logits), (dlog, dec)):
        check(bool(torch.isfinite(got["kernel"]).all()), "logits not finite")
        compare_logits(row, got["kernel"], got["torch"],
                       [got[a] for a in nudged])
    check(len(records) == n_layers, f"K2 probed in {len(records)} calls")
    k2 = probe_summary(records)
    emit("serve_vlm_logits", prefill=prefill, decode=dlog,
         k2_on_real_inputs=k2, nudge_share=NUDGE_SHARE)
    check(k2["excess"] <= 1, f"K2 vs plain on real inputs: bf16 bound used "
                             f"{k2['excess']} times")
    check_logits({"prefill": prefill, "decode": dlog})
    if hand is not None and hand.wants("serve_tp_families"):
        # serve_tp_families (d): tp 4 emulated on these weights, split in
        # place (its launches its own, counted apart from this phase's)
        hand.vlm.update(vlm_tp(cfg, params, batch, cache_len,
                               (logits["kernel"], dec["kernel"])))
    n_tok = VLM_BATCH * (VLM_STEPS + 1)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "n_layers": n_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.hd],
        "batch": VLM_BATCH, "patches": cfg.num_patches, "text": VLM_TEXT,
        "cache_len": cache_len, "tokens": n_tok, "seconds": run["seconds"],
        "tok_per_s": n_tok / run["seconds"], "ttft_median_s": run["ttft_s"],
        "tpot_median_s": statistics.median(run["step_s"]),
        "decode_steps": VLM_STEPS, "launches": counts,
        "prefill_logits_err": prefill["err"],
        "prefill_logits_floor": prefill["floor"],
        "decode_logits_err": dlog["err"], "decode_logits_floor": dlog["floor"],
        "k2_real_excess": k2["excess"], "peak_memory_bytes": peak,
        "start_memory_bytes": held, **init}
    emit("serve_vlm", **out)
    del params, batch, run, logits, dec
    phase_end()
    return out


def phase_serve_encdec(card: str, hand: Handoff = None) -> dict:
    """Whisper-base at full width (6 + 6 layers, d_model 512), in f32:
    16 x 1500 frames through the encoder (K2 non-causal at hd 64), a
    4-token decoder prompt (K2 causal), then 60 greedy decode steps; the
    kernel arm's token streams equal the plain arm's."""
    held = phase_start("serve_encdec")
    cfg = dataclasses.replace(all_archs()["whisper-base"], dtype="float32")
    params = make_params(cfg, 0)
    n_params = n_params_of(params)
    check(n_params == WHISPER_PARAMS, f"whisper has {n_params} params")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    rng = np.random.default_rng(13)
    batch = {"tokens": torch.tensor(rng.integers(
                 0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT)).astype(
                 np.int32), device=DEV),
             "frames": torch.randn((WHISPER_BATCH, WHISPER_FRAMES,
                                    cfg.d_model), generator=gen, device=DEV)}
    cache_len = WHISPER_PROMPT + WHISPER_STEPS
    greedy(cfg, params, {k: v[:2] for k, v in batch.items()}, 2, cache_len)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = greedy(cfg, params, batch, WHISPER_STEPS, cache_len)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_k2 = cfg.encoder_layers + cfg.num_layers
    check(counts["flash_attention"] == n_k2,
          f"K2 launches {counts['flash_attention']} != {n_k2}")
    with runtime.use_policy(attention_impl="torch"):
        ops.reset_launch_counts()
        plain = greedy(cfg, params, batch, WHISPER_STEPS, cache_len)
        check(sum(ops.launch_counts().values()) == 0,
              "impl='torch' launched a kernel")
    check(run["streams"] == plain["streams"],
          "whisper f32 token streams differ between the kernel and plain "
          "arms")
    if hand is not None:
        hand.tp1[cfg.name] = run["streams"]
    check(all(len(r) == WHISPER_STEPS + 1 for r in run["streams"]),
          "a short stream")
    logits_err = max_err(run["prefill_logits"], plain["prefill_logits"])
    n_tok = WHISPER_BATCH * (WHISPER_STEPS + 1)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "layers": [cfg.encoder_layers, cfg.num_layers],
        "d_model": cfg.d_model, "batch": WHISPER_BATCH,
        "frames": WHISPER_FRAMES, "prompt": WHISPER_PROMPT,
        "tokens": n_tok, "seconds": run["seconds"],
        "tok_per_s": n_tok / run["seconds"], "ttft_median_s": run["ttft_s"],
        "tpot_median_s": statistics.median(run["step_s"]),
        "decode_steps": WHISPER_STEPS, "launches": counts,
        "equal_streams": True, "prefill_logits_err": logits_err,
        "peak_memory_bytes": peak, "start_memory_bytes": held}
    emit("serve_encdec", **out)
    del params, batch, run, plain
    phase_end()
    return out


# ---------------------------------------------------------------------------
# phase: serve_families (full width: the paper's serving question)
# ---------------------------------------------------------------------------

FAMILY_ARCH = "olmo-1b"
FAMILY_ENGINE = dict(n_slots=16, cache_len=2048, block_size=16)  # serve's
# 16 new tokens (64 until serve_tp_families joined the script): a level's
# drain, its queued requests finishing after the window, set most of the
# phase's time
FAMILY_LOAD = dict(prompt_lens=(128, 512, 1024), max_new=16)
# Each level's arrival window is 2 x duration (the reference's
# max(2 * duration, 0.4)).  At full width a request of FAMILY_LOAD's 16 new
# tokens lives ~0.7 s (16 host-bound ticks of ~45 ms on an H100), so 1 s
# makes the window ~3 lifetimes: the 2x level still fills the 16 slots
# and queues, and a level serves ~0.5 x rate x 2 s requests.  (4 s, and
# 64 new tokens, until serve_tp_families joined the script, whose first
# whole-script run took 1381.9 s, over the 1200-s budget; 2 s, then 1.5
# s, until the rank paths that run left for time came back and took the
# script to 1155.3 s.)  paged_sweep times each of its 12 (page size,
# depth) microbench pairs for `duration` as well, so it takes half of
# that (0.5 s; 2, 1 and 0.75 s until then).  max_requests caps the
# fastest host's 2x level (capacity ~8 requests/s) above what the window
# offers.
FAMILY_DURATION = {"serve.load_sweep": 1.0, "serve.slo_sweep": 1.0,
                   "serve.timeline": 1.0, "fabric.serve_tail": 1.0,
                   "serve.continuous_vs_static": 1.0,
                   "serve.paged_attention": 0.5}
FAMILY_MAX_REQUESTS = {"serve.load_sweep": 128, "serve.slo_sweep": 96,
                       "serve.timeline": 64, "fabric.serve_tail": 64,
                       "serve.paged_attention": 64}
FAMILY_CONDITIONS = ("clean", "jitter", "straggler", "lossy", "throttle")
# load_sweep's levels below its own (0.25, 0.5, 1, 2) x capacity.  Its
# arrivals are evenly spaced, and at 0.25x a request (~0.75 s on an H100)
# outlives the gap to the next one, so the engine never idles and the
# probe on its idle hook never runs: the probe then ran only where the
# slo_sweep's Poisson gaps happened to open one (one level a run), and
# on one host on none.  At 0.05x the spacing is 20 / capacity-in-rps,
# above one request's lifetime even were the 16 slots' burst perfectly
# efficient, so the engine idles between requests on any host (4
# requests, ~6 s)
FAMILY_IDLE_LEVELS = (0.05,)
STATIC_BATCH = 16
STATIC_PROMPTS = (1024, 512, 128, 77)   # left-padded to 1024 in one batch
STATIC_REQUESTS = 14                    # + 2 dummies fill the batch
STATIC_MAX_NEW = (1, 4)                 # lockstep decode past the prefill


def family_calls(trace_out: str) -> dict:
    """Experiment name -> (function, keywords) of each serving family at
    the full width of OLMo-1B, with the serve phase's engine sizes."""
    from repro_torch.core import fabric, serving
    full = dict(arch=FAMILY_ARCH, width="full")
    engine = dict(full, **FAMILY_ENGINE)
    calls = {
        "serve.load_sweep": (serving.load_sweep, dict(
            engine, **FAMILY_LOAD,
            offered=FAMILY_IDLE_LEVELS + serving.OFFERED_MULTS)),
        "serve.slo_sweep": (serving.slo_sweep, engine),
        "serve.timeline": (serving.timeline, dict(
            engine, **FAMILY_LOAD, trace_out=trace_out)),
        "fabric.serve_tail": (fabric.measure_serve_tail, dict(
            engine, **FAMILY_LOAD, conditions=FAMILY_CONDITIONS)),
        "serve.continuous_vs_static": (serving.continuous_vs_static, dict(
            full, batch=STATIC_BATCH, cache_len=FAMILY_ENGINE["cache_len"],
            block_size=FAMILY_ENGINE["block_size"])),
        "serve.paged_attention": (serving.paged_sweep, dict(
            engine, **FAMILY_LOAD, n_seqs=SWEEP_SEQS,
            kv_tokens=SWEEP_TOKENS, page_sizes=SWEEP_PAGE_SIZES)),
    }
    for name, n in FAMILY_MAX_REQUESTS.items():
        calls[name][1]["max_requests"] = n
    return calls


# the rows a level carries only where its sample pool is not empty; the
# rest of a stream's schema follows from the arguments alone and is held
# to the reference's on the CPU (tests/test_torch_serving.py)
GUARDED_ROWS = {"serve.load_sweep": ("ttft_p99_s", "tpot_p99_s"),
                "serve.paged_attention": ("ttft_p99_s", "tpot_p99_s"),
                "serve.slo_sweep": ("ttft_p99_s", "tpot_p99_s"),
                "fabric.serve_tail": ("tpot_p99_s",)}


def check_levels(name: str, records) -> int:
    """Every load level (or fabric condition) completed requests and
    carries its latency rows; every row the probe ran on holds a headroom
    in (0, 1] of the probe alone.  Returns the number of such rows."""
    by_level: dict = {}
    for r in records:
        by_level.setdefault(r.name, {})[r.metric] = r
    idle = by_level.get("probe_idle", {}).get("headroom_flops_per_s")
    probed = 0
    for level, rows in by_level.items():
        tps = rows.get("tokens_per_sec")
        if tps is None or "completed" not in tps.params:
            continue                            # capacity, microbench
        check(tps.params["completed"] > 0,
              f"{name} {level}: no request completed of "
              f"{tps.params.get('n_requests')}")
        missing = [m for m in GUARDED_ROWS.get(name, ()) if m not in rows]
        check(not missing, f"{name} {level}: no {missing} rows")
        head = rows.get("headroom_flops_per_s")
        if head is None or not head.params.get("probe_calls"):
            continue
        idle_fps = idle.value if idle is not None \
            else head.params["probe_flops_per_s_idle"]
        share = head.value / idle_fps
        check(0 < share <= 1, f"{name} {level}: probe headroom {share} of "
                              f"the probe alone, not in (0, 1]")
        probed += 1
    return probed


def static_prefill_check() -> dict:
    """The static engine at full width through ``Engine.generate``:
    ``STATIC_REQUESTS`` prompts left-padded to the longest, two dummy
    requests filling the batch, one batched prefill (K2 at B = 16) and a
    few lockstep decode steps.  The prefill's logits are captured; K2 runs
    beside each plain attention call on the same real inputs (held to
    ``bf16_excess`` <= 1), and the kernel arm's logits are held against
    the plain arm's by ``check_logits`` (4 spacings, or twice the floor of
    nudged plain arms)."""
    cfg = all_archs()[FAMILY_ARCH]
    eng = Engine(cfg, None, batch_size=STATIC_BATCH,
                 cache_len=FAMILY_ENGINE["cache_len"],
                 params=make_params(cfg, 0))
    rng = np.random.default_rng(13)
    lens = [STATIC_PROMPTS[i % len(STATIC_PROMPTS)]
            for i in range(STATIC_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    max_new = [STATIC_MAX_NEW[i % len(STATIC_MAX_NEW)]
               for i in range(STATIC_REQUESTS)]
    prefill = eng._prefill
    captured = []

    def capture(params, batch):
        logits, caches = prefill(params, batch)
        captured.append(logits)
        return logits, caches

    eng._prefill = capture

    def generate():
        reqs = [Request(prompt=p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        eng.generate(reqs)
        check(all(len(r.generated) == r.max_new_tokens for r in reqs),
              "static engine: a request did not get its tokens")
        return captured.pop(), [r.generated for r in reqs]

    ops.reset_launch_counts()
    got, streams = generate()
    launches = ops.launch_counts()["flash_attention"]
    check(launches == cfg.num_layers,
          f"static generate launched K2 {launches} times, not "
          f"{cfg.num_layers}")
    check(got.shape == (STATIC_BATCH, 1, cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "static prefill logits")
    probes = []
    with plain_path(*ATTENTION, probe_attention(probes)):
        want, plain_streams = generate()
    noisy = []
    for seed in NUDGE_SEEDS:
        with plain_path(*ATTENTION, nudge_attention(seed)):
            noisy.append(generate()[0])
    # the dummies' rows are copies of request 0's prompt: held too
    row = logits_row()
    compare_logits(row, got, want, noisy)
    check(len(probes) == cfg.num_layers, f"K2 probed {len(probes)} times")
    row["k2_on_real_inputs"] = {k: max(p[k] for p in probes)
                                for k in probes[0]}
    check(row["k2_on_real_inputs"]["excess"] <= 1,
          f"K2 vs plain at the static prefill: bf16 bound used "
          f"{row['k2_on_real_inputs']['excess']} times")
    check_logits({"static_prefill": row})
    same = sum(a == b for a, b in zip(streams, plain_streams))
    return dict(row, batch=STATIC_BATCH, requests=STATIC_REQUESTS,
                prompt_lens=lens, padded_to=max(lens), max_new=max_new,
                streams_equal_plain=f"{same}/{STATIC_REQUESTS}")


def compact(records) -> list:
    return [{"name": r.name, "metric": r.metric, "value": r.value,
             "relative": r.relative} for r in records]


def phase_serve_families(card: str) -> dict:
    """The serving families of ``core/serving.py`` and
    ``core/fabric.measure_serve_tail`` at the full width of OLMo-1B,
    each through the port's ``Runner`` (so that the Record path, its
    environment stamp and its persisted stream run on the card): no error
    record, every level served and carrying its latency rows, the probe's
    headroom in (0, 1] of the probe alone wherever it ran, and on at least
    one level.  The static engine is held first; the launches counted are
    the families' own, K1's split into the microbench's (f32 pools) and
    the paged engine's decode ticks."""
    from repro_torch.experiments import Runner, experiment
    from repro_torch.experiments import registry as reg
    gc.collect()
    torch.cuda.empty_cache()
    static = static_prefill_check()
    emit("serve_families_static_prefill", **static)
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = os.path.join(ROOT, "build", "serve_families")
    os.makedirs(out_dir, exist_ok=True)
    calls = family_calls(os.path.join(out_dir, "serve_timeline_trace.json"))
    records_dir = os.path.join(out_dir, "records_torch")
    seconds, launches, summary, probed = {}, {}, {}, 0
    k1 = ops.paged_attention
    k1_f32 = []

    def k1_tally(q, *a, **kw):
        if q.dtype == torch.float32:
            k1_f32.append(1)
        return k1(q, *a, **kw)

    ops.reset_launch_counts()
    ops.paged_attention = k1_tally
    try:
        for name, (fn, kw) in calls.items():
            spec = f"chip_smoke.{name}"
            experiment(spec)(functools.partial(fn, **kw))
            before = ops.launch_counts()
            try:
                t0 = time.perf_counter()
                report = Runner(duration=FAMILY_DURATION[name], only=[spec],
                                load_builtin=False, records_dir=records_dir,
                                device="cuda").run()
                seconds[name] = time.perf_counter() - t0
            finally:
                reg.unregister(spec)
            after = ops.launch_counts()
            launches[name] = {k: after[k] - before[k] for k in after
                              if after[k] > before[k]}
            recs = report.records
            check(report.ok and not report.skips,
                  f"{name}: "
                  f"{[r.reason for r in report.errors + report.skips]}")
            env = recs[0].params["env"]
            check(env["backend"] == "cuda" and env.get("card"),
                  f"{name}: environment stamp {env}")
            for r in recs:
                check(r.value is not None and bool(np.isfinite(r.value))
                      and r.value >= 0,
                      f"{name} {r.name}.{r.metric}: {r.value}")
            probed += check_levels(name, recs)
            emit("serve_families", family=name, seconds=seconds[name],
                 duration=FAMILY_DURATION[name], launches=launches[name],
                 records=compact(recs), card=env.get("card"),
                 power_limit=env.get("power_limit"),
                 records_path=os.path.relpath(report.records_path, ROOT))
            summary[name] = recs
            del report, recs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ops.paged_attention = k1
    counts = ops.launch_counts()
    check(probed > 0, "the probe ran on no level of any family: the "
                      "engine's idle hook was never called")
    check(os.path.exists(calls["serve.timeline"][1]["trace_out"]),
          "timeline trace not saved")
    paged = launches["serve.paged_attention"].get("paged_attention", 0)
    out = {"card": card, "arch": FAMILY_ARCH, "width": "full",
           **FAMILY_ENGINE, **FAMILY_LOAD, "duration": FAMILY_DURATION,
           "max_requests": FAMILY_MAX_REQUESTS,
           "conditions": list(FAMILY_CONDITIONS),
           "page_sizes": list(SWEEP_PAGE_SIZES), "seconds": seconds,
           "probed_levels": probed, "launches_by_family": launches,
           "k1_microbench_launches": len(k1_f32),
           "k1_paged_engine_launches": paged - len(k1_f32),
           "launches": counts}
    emit("serve_families_summary", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_swa (full width, sliding window, dense engine)
# ---------------------------------------------------------------------------

DANUBE_PARAMS = 3_961_839_360
SWA_PROMPTS = (512, 4064, 4608)     # within the window; wraps the ring in
#                                     decode (4064 + 64 > 4096); rolled at
#                                     prefill (4608 > 4096)


# The kernel path's logits against the plain path's, in serve_rwkv and
# serve_swa: a random-weight bf16 model carries single roundings through its
# layers chaotically (on an H100, Danube's 24 layers carry its attention
# outputs moved by one spacing on 0.1 % of their elements to ~5 spacings of
# the logits, at every prompt length), so the kernel arm is held to what the
# plain path does when its own outputs move by a rounding -- the floor, the
# largest of NUDGE_SEEDS draws of "nudged" plain arms -- as well as to
# TOL_LOGITS_ULPS spacings.  The kernel itself is held, on the same real
# inputs, to its plain version (a probe beside the plain arm).
FLOOR_FACTOR = 2.0      # kernel-vs-plain logits may differ by twice the
#                         floor, in their largest and in their mean absolute
#                         difference; the largest may also reach
#                         TOL_LOGITS_ULPS spacings
NUDGE_SEEDS = (0, 1, 2)
NUDGE_SHARE = 0.125     # a nudged attention arm moves this share of its
#                         outputs by one bf16 spacing: fixed, of the order of
#                         the share K2's roundings move on serve_swa's real
#                         inputs (reported as k2_moved_share), so that the
#                         floor does not follow the kernel under test


def logits_row() -> dict:
    return {"err": 0.0, "mean_err": 0.0, "floor": 0.0, "mean_floor": 0.0,
            "tol": float("inf")}


def compare_logits(row, got, want, noisy) -> None:
    """Fold the kernel arm's logits ``got`` and the nudged arms' ``noisy``
    against the plain arm's ``want`` into ``row``."""
    def mean_err(a):
        return float((a.float() - want.float()).abs().mean())

    row["err"] = max(row["err"], max_err(got, want))
    row["mean_err"] = max(row["mean_err"], mean_err(got))
    for other in noisy:
        row["floor"] = max(row["floor"], max_err(other, want))
        row["mean_floor"] = max(row["mean_floor"], mean_err(other))
    row["tol"] = min(row["tol"], logits_tol(want))


def check_logits(rows: dict) -> None:
    for n, row in rows.items():
        bound = max(row["tol"], FLOOR_FACTOR * row["floor"])
        check(row["err"] <= bound,
              f"logits ({n}): kernels vs plain differ by {row['err']} "
              f"(tolerance {bound})")
        check(row["mean_err"] <= FLOOR_FACTOR * row["mean_floor"],
              f"logits ({n}): kernels vs plain differ by {row['mean_err']} "
              f"on average (tolerance {FLOOR_FACTOR * row['mean_floor']})")


# the plain version of an op, by module and name, and the policy that makes
# the model call it
ATTENTION = (fa, "flash_attention_torch", {"attention_impl": "torch"})
SCAN = (rs, "rwkv6_scan_torch", {"rwkv_impl": "torch"})


@contextlib.contextmanager
def plain_path(module, name: str, policy: dict, around):
    """The plain path (``runtime.use_policy(**policy)``) with each call of
    ``module.name``, the plain version of an op, run as ``around(plain,
    *args, **kw)``."""
    plain = getattr(module, name)
    setattr(module, name, lambda *a, **kw: around(plain, *a, **kw))
    try:
        with runtime.use_policy(**policy):
            yield
    finally:
        setattr(module, name, plain)


def probe_attention(records: list):
    """Run K2 beside each plain attention call on the same inputs (every
    layer's real ones), keep the plain output, and append the call's
    largest difference, its ``bf16_excess`` and the share of output
    elements that differ."""
    def around(plain, q, k, v, **kw):
        out = plain(q, k, v, **kw)
        got = fa.flash_attention_fwd(q, k, v, **kw)
        records.append({"err": max_err(got, out),
                        "excess": bf16_excess(got, out),
                        "moved": float((got != out).float().mean())})
        return out
    return around


def nudge_attention(seed: int):
    """Move each plain attention output by one bf16 spacing, of random
    sign, on a random ``NUDGE_SHARE`` of its elements."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def around(plain, *args, **kw):
        out = plain(*args, **kw)
        x = out.float()
        pick = torch.rand(x.shape, generator=gen, device=x.device) \
            < NUDGE_SHARE
        sign = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        spacing = bf16_spacing(x)
        moved = x + torch.where(sign, spacing, -spacing)
        return torch.where(pick, moved.to(out.dtype), out)
    return around


def phase_serve_swa(card: str, do_profile: bool = False) -> dict:
    """H2O-Danube3-4B at full width through the dense engine: every
    prefill runs K2 at hd 120 with the 4096 window; decode attends over
    each slot's 4096-slot ring in plain PyTorch (the paged engine refuses
    windowed archs, as the reference's does)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = all_archs()["h2o-danube-3-4b"]     # published widths, bf16
    n_layers, window = cfg.num_layers, cfg.sliding_window
    params = make_params(cfg, 0)
    n_params = sum(t.numel() for _, t in bridge.flatten(params))
    check(n_params == DANUBE_PARAMS, f"h2o-danube-3-4b has {n_params} params")
    n_slots, cache_len, max_new = 16, 8192, 64
    check(max(SWA_PROMPTS) > window and any(
        n <= window < n + max_new for n in SWA_PROMPTS),
        "the burst must roll the ring at prefill and wrap it in decode")
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                           paged=False)
    ring = eng._caches["l0"]
    check(tuple(ring["k"].shape) == (n_layers, n_slots, window,
                                     cfg.num_kv_heads, cfg.hd),
          f"ring {tuple(ring['k'].shape)}")
    ring_bytes = sum(t.numel() * t.element_size()
                     for _, t in bridge.flatten(eng._caches))

    warm = LoadSpec(n_requests=2, rate_rps=0.0, prompt_lens=(512,),
                    max_new_tokens=4, vocab_size=cfg.vocab_size, seed=1)
    eng.generate(make_requests(warm))
    torch.cuda.synchronize()

    # 12 requests (24 until serve_tp_families joined the script): each of
    # SWA_PROMPTS still admitted 4 times
    spec = LoadSpec(n_requests=12, rate_rps=0.0, prompt_lens=SWA_PROMPTS,
                    max_new_tokens=max_new, vocab_size=cfg.vocab_size,
                    seed=0)
    reqs = make_requests(spec)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    ticks = sum(1 for e in eng.step_log if e.decoded)
    check(all(len(r.generated) == max_new for r in reqs),
          f"a request did not get its {max_new} tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "KV blocks not recycled")
    check(counts["flash_attention"] == len(reqs) * n_layers,
          f"K2 launches {counts['flash_attention']} != {len(reqs)} x "
          f"{n_layers} layers")
    check(counts["paged_attention"] == 0,
          f"the paged kernel ran on the dense engine: {counts}")

    # prefill logits at each prompt length and one decode tick, kernels vs
    # impl="torch", each arm decoding from the rings its own prefills left
    # (decode itself runs no kernel: only the prefills' K/V differ).  The
    # plain arm runs K2 beside each of its attention calls on the same real
    # inputs (held to bf16_excess <= 1); further arms, the plain path with
    # NUDGE_SHARE of its attention outputs moved by one spacing, give the
    # floor
    cells = eng.cells
    rng = np.random.default_rng(11)
    lens = (4608, 4064, 512, 77)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens * (n_slots // len(lens))]
    records = []
    nudged = [f"nudged{s}" for s in NUDGE_SEEDS]
    arms = {"kernel": contextlib.nullcontext,
            "torch": lambda: plain_path(*ATTENTION, probe_attention(records)),
            **{arm: (lambda s=s: plain_path(*ATTENTION, nudge_attention(s)))
               for arm, s in zip(nudged, NUDGE_SEEDS)}}
    caches = {arm: eng._caches if arm == "kernel"
              else cells.init_slot_caches() for arm in arms}
    idx = np.zeros((n_slots,), np.int32)
    tok = np.zeros((n_slots,), np.int32)
    by_len = {n: logits_row() for n in lens}
    probes = {n: [] for n in lens}
    for slot, prompt in enumerate(prompts):
        toks = torch.tensor(prompt, device=DEV)[None]
        logits = {}
        for arm, context in arms.items():
            with context():
                logits[arm], base = cells.prefill(eng.params, toks)
            cells.insert(caches[arm], base, slot)
            del base
        probes[len(prompt)] += records
        records.clear()
        lk = logits["kernel"]
        check(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        check(lk.shape == (1, 1, cfg.vocab_size), f"prefill logits {lk.shape}")
        compare_logits(by_len[len(prompt)], lk, logits["torch"],
                       [logits[arm] for arm in nudged])
        idx[slot] = len(prompt)
        tok[slot] = int(torch.argmax(lk[0, -1]))
    n_calls = len(prompts) * n_layers
    check(sum(map(len, probes.values())) == n_calls,
          f"K2 compared on real inputs in {sum(map(len, probes.values()))} "
          f"calls, not {n_calls}")
    live = caches["kernel"]["l0"]["pos"][0]         # (n_slots, window)
    check(int((live >= 0).sum(1).max()) == window, "a ring is not full")
    step_args = (eng.params, torch.tensor(tok, device=DEV)[:, None],
                 torch.tensor(idx, device=DEV))
    dlog = {arm: cells.decode(*step_args, caches[arm])[0] for arm in arms}
    dk = dlog["kernel"]
    check(bool(torch.isfinite(dk).all()), "decode logits not finite")
    check(dk.shape == (n_slots, 1, cfg.vocab_size), f"decode logits {dk.shape}")
    decode = logits_row()
    compare_logits(decode, dk, dlog["torch"], [dlog[arm] for arm in nudged])
    for n, recs in probes.items():
        by_len[n]["k2_on_real_inputs"] = {
            key: max(r[key] for r in recs) for key in recs[0]}
    real = [r for recs in probes.values() for r in recs]
    moved = statistics.mean(r["moved"] for r in real)
    real_excess = max(r["excess"] for r in real)
    emit("serve_swa_logits", prefill=by_len, decode=decode,
         nudge_share=NUDGE_SHARE, k2_moved_share=moved,
         nudge_seeds=list(NUDGE_SEEDS), probed_calls=len(real),
         k2_real_excess=real_excess)
    if do_profile:
        profile_tick(f"{cfg.name} decode tick, 16 rings of {window}",
                     decode_tick(cells, step_args + (caches["kernel"],)),
                     card,
                     share_of=("flash_fwd",))
        toks = torch.tensor(prompts[0], device=DEV)[None]    # 4608 tokens
        profile_tick(f"{cfg.name} prefill, {len(prompts[0])} tokens",
                     lambda: torch.argmax(cells.prefill(
                         eng.params, toks)[0][0, -1]).cpu(), card, ticks=3,
                     share_of=("flash_fwd",))
    check(real_excess <= 1, f"K2 vs plain on real inputs: bf16 bound used "
                            f"{real_excess} times")
    check_logits({**by_len, "decode": decode})
    del caches

    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "n_layers": n_layers, "d_model": cfg.d_model,
        "hd": cfg.hd, "window": window, "n_slots": n_slots,
        "cache_len": cache_len, "ring_bytes": ring_bytes,
        "n_requests": len(reqs), "prompt_lens": list(spec.prompt_lens),
        "tokens": n_tok, "seconds": elapsed, "tok_per_s": n_tok / elapsed,
        "ttft_median_s": statistics.median(ttft),
        "tpot_median_s": statistics.median(tpot),
        "decode_ticks": ticks, "launches": counts,
        "prefill_logits_err": max(r["err"] for r in by_len.values()),
        "prefill_logits_floor": max(r["floor"] for r in by_len.values()),
        "decode_logits_err": decode["err"],
        "decode_logits_floor": decode["floor"],
        "decode_logits_mean_err": decode["mean_err"],
        "decode_logits_mean_floor": decode["mean_floor"],
        "nudge_share": NUDGE_SHARE, "k2_moved_share": moved,
        "k2_real_excess": real_excess, "peak_memory_bytes": peak,
    }
    emit("serve_swa", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_rwkv (full width, dense engine)
# ---------------------------------------------------------------------------

RWKV6_7B_PARAMS = 7_618_695_168
RWKV6_7B_SLOT_STATE_BYTES = 34_078_720   # 32 x (shift + wkv + cm)


def nudge_scan(seed: int):
    """Move the plain scan's f32 output ``y`` by one rounding, a relative
    2**-23 of random sign per element: the size of what summing in another
    order does to it."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def around(plain, *args, **kw):
        y, s_t = plain(*args, **kw)
        sign = torch.randint(0, 2, y.shape, generator=gen, device=y.device,
                             dtype=torch.int8) * 2 - 1
        return y * (1.0 + sign * 2.0 ** -23), s_t
    return around


def probe_scan(errs: list):
    """Run K4 beside each plain scan on the same inputs (every layer's real
    ones), keep the plain outputs, and append to ``errs`` the call's largest
    difference in ``y`` and ``S_T``, relative to max(1, the plain output's
    largest magnitude)."""
    def around(plain, *args, **kw):
        y, s_t = plain(*args, **kw)
        ky, ks = rs.rwkv6_scan_fwd(*args, **kw)
        errs.append(max(max_err(a, b) / max(1.0, float(b.abs().max()))
                        for a, b in ((ky, y), (ks, s_t))))
        return y, s_t
    return around


def phase_serve_rwkv(card: str, do_profile: bool = False,
                     hand: Handoff = None) -> dict:
    gc.collect()
    torch.cuda.empty_cache()              # the OLMo engine is gone
    cfg = all_archs()["rwkv6-7b"]         # published widths, bf16
    n_layers = cfg.num_layers
    params = make_params(cfg, 0)
    n_params = sum(t.numel() for _, t in bridge.flatten(params))
    check(n_params == RWKV6_7B_PARAMS, f"rwkv6-7b has {n_params} params")
    n_slots, cache_len = 16, 2048
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                           paged=False)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in bridge.flatten(eng._caches))
    check(state_bytes == n_slots * RWKV6_7B_SLOT_STATE_BYTES,
          f"slot state {state_bytes} bytes")

    # warm-up (cuBLAS handles, kernel images): not part of the counted run
    warm = LoadSpec(n_requests=2, rate_rps=0.0, prompt_lens=(64,),
                    max_new_tokens=4, vocab_size=cfg.vocab_size, seed=1)
    eng.generate(make_requests(warm))
    torch.cuda.synchronize()

    # 12 requests of 32 new tokens (24 of 64 until serve_tp_families
    # joined the script): every prompt length still admitted 4 times
    spec = LoadSpec(n_requests=12, rate_rps=0.0,
                    prompt_lens=(64, 512, 1024), max_new_tokens=32,
                    vocab_size=cfg.vocab_size, seed=0)
    reqs = make_requests(spec)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()   # before the checks' states

    ticks = sum(1 for e in eng.step_log if e.decoded)
    check(all(len(r.generated) == spec.max_new_tokens for r in reqs),
          f"a request did not get its {spec.max_new_tokens} tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "KV blocks not recycled")
    check(counts["rwkv6_scan"] == len(reqs) * n_layers,
          f"K4 launches {counts['rwkv6_scan']} != {len(reqs)} x "
          f"{n_layers} layers")
    check(counts["paged_attention"] == 0 and counts["flash_attention"] == 0,
          f"an attention kernel ran on RWKV: {counts}")
    if hand is not None and hand.wants("serve_tp_families"):
        hand.tp1[cfg.name] = probe_dense(eng, tpf_prompts(cfg))

    # prefill logits and one decode tick, kernels vs impl="torch", each arm
    # decoding from the states its own prefills left.  The plain arm runs
    # K4 beside each of its scans on the same real inputs (y and S_T of
    # every layer, held to TOL_SCAN); further arms, the plain path with its
    # scan output nudged by one f32 rounding, measure how far 32 bf16
    # layers carry a difference of that size (the floor)
    cells = eng.cells
    rng = np.random.default_rng(11)
    lens = (1024, 512, 48, 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens * (n_slots // 4)]
    scan_errs = []
    nudged = [f"nudged{s}" for s in NUDGE_SEEDS]
    arms = {"kernel": contextlib.nullcontext,
            "torch": lambda: plain_path(*SCAN, probe_scan(scan_errs)),
            **{arm: (lambda s=s: plain_path(*SCAN, nudge_scan(s)))
               for arm, s in zip(nudged, NUDGE_SEEDS)}}
    caches = {arm: cells.init_slot_caches() for arm in arms}
    idx = np.zeros((n_slots,), np.int32)
    tok = np.zeros((n_slots,), np.int32)

    new_row, compare = logits_row, compare_logits
    by_len = {n: new_row() for n in lens}
    for slot, prompt in enumerate(prompts):
        toks = torch.tensor(prompt, device=DEV)[None]
        logits = {}
        for arm, context in arms.items():
            with context():
                logits[arm], state = cells.prefill(eng.params, toks)
            cells.insert(caches[arm], state, slot)
        lk = logits["kernel"]
        check(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        check(lk.shape == (1, 1, cfg.vocab_size), f"prefill logits {lk.shape}")
        compare(by_len[len(prompt)], lk, logits["torch"],
                [logits[arm] for arm in nudged])
        idx[slot] = len(prompt)
        tok[slot] = int(torch.argmax(lk[0, -1]))
    n_scans = sum(len(p) > 1 for p in prompts) * n_layers
    check(len(scan_errs) == n_scans,
          f"{len(scan_errs)} scans compared on real inputs, not {n_scans}")
    step_args = (eng.params, torch.tensor(tok, device=DEV)[:, None],
                 torch.tensor(idx, device=DEV))
    dlog = {}
    for arm, context in arms.items():
        with context():
            dlog[arm], _ = cells.decode(*step_args, caches[arm])
    dk = dlog["kernel"]
    decode = new_row()
    compare(decode, dk, dlog["torch"], [dlog[arm] for arm in nudged])
    emit("serve_rwkv_logits", prefill=by_len, decode=decode,
         nudge_seeds=list(NUDGE_SEEDS), real_scans=len(scan_errs),
         real_scan_err=max(scan_errs))
    if do_profile:
        profile_tick("rwkv6-7b decode tick",
                     decode_tick(cells, step_args + (caches["kernel"],)),
                     card)
        toks = torch.tensor(prompts[0], device=DEV)[None]    # 1024 tokens
        profile_tick("rwkv6-7b prefill, 1024 tokens", lambda: torch.argmax(
            cells.prefill(eng.params, toks)[0][0, -1]).cpu(), card, ticks=5,
            share_of=("wkv6_",))
    check(bool(torch.isfinite(dk).all()), "decode logits not finite")
    check(dk.shape == (n_slots, 1, cfg.vocab_size), f"decode logits {dk.shape}")
    check(max(scan_errs) <= TOL_SCAN,
          f"K4 vs plain on real inputs: relative {max(scan_errs)}")
    check_logits({**by_len, "decode": decode})

    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "n_layers": n_layers, "d_model": cfg.d_model,
        "n_slots": n_slots, "cache_len": cache_len,
        "state_bytes": state_bytes, "n_requests": len(reqs),
        "prompt_lens": list(spec.prompt_lens), "tokens": n_tok,
        "seconds": elapsed, "tok_per_s": n_tok / elapsed,
        "ttft_median_s": statistics.median(ttft),
        "tpot_median_s": statistics.median(tpot),
        "decode_ticks": ticks, "launches": counts,
        "prefill_logits_err": max(r["err"] for r in by_len.values()),
        "prefill_logits_floor": max(r["floor"] for r in by_len.values()),
        "decode_logits_err": decode["err"],
        "decode_logits_floor": decode["floor"],
        "decode_logits_mean_err": decode["mean_err"],
        "decode_logits_mean_floor": decode["mean_floor"],
        "real_scan_err": max(scan_errs),
        "peak_memory_bytes": peak,
    }
    emit("serve_rwkv", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_tp (tensor-parallel serving over a model axis)
# ---------------------------------------------------------------------------

TP_ENGINE = dict(n_slots=16, cache_len=2048, block_size=16, paged=True,
                 page_buffer_depth=2)
TP_WARM = dict(n_requests=1, rate_rps=0.0, prompt_lens=(128,),
               max_new_tokens=2, seed=1)
# the serve and serve_nemo phases' bursts, cut for time: OLMo-1B 4 of the
# 24 requests (12 until serve_tp_families joined the script, 6 until
# NeMo's burst came back beside it), 8 of the 64 new tokens (a ranked
# tick at tp 4 took 248-820 ms of host on an H100, and a burst that fits
# the 16 slots lasts as many ticks as its new tokens: 64 until train_mesh
# joined the script, 16 until serve_tp_families did); Mistral-NeMo-12B 2
# requests, one of each prompt length (its 1024-token prefill over gloo
# sets the run's time; 4 took ~32 s on an H100), 4 of the 32 new tokens
# (0.67-1.6 s a tick): its only run over ranks at GQA local heads (8 q /
# 2 kv), K1 and K2 on the main path there
TP_BURSTS = {
    "olmo-1b": dict(n_requests=4, rate_rps=0.0,
                    prompt_lens=(128, 512, 1024), max_new_tokens=8, seed=0),
    "mistral-nemo-12b": dict(n_requests=2, rate_rps=0.0,
                             prompt_lens=(128, 1024), max_new_tokens=4,
                             seed=0)}
TP_PROBE = (128, 77)                # two of the serve phase's check prompts
TP_F32 = ("olmo-1b", "mistral-nemo-12b", "h2o-danube-3-4b")
# (6 requests of 12 new tokens until serve_tp_families joined the script)
TP_F32_SPEC = dict(n_requests=4, rate_rps=0.0, prompt_lens=(8, 16, 37),
                   max_new_tokens=6, seed=3)
TP_F32_ENGINE = dict(n_slots=4, cache_len=64, block_size=8)
# the local shapes: (name, query heads, kv heads) a rank holds
TP_LOCAL = (("olmo_tp2", 8, 8), ("olmo_tp4", 4, 4), ("nemo_tp4", 8, 2))
TP_K2_S = 1024                      # the bursts' longest prompt


def measured_ms(ms: float, bound_ms: float):
    """A profiler's device time, or ``None`` where it is below the least
    time the card could take: that window dropped kernels."""
    return ms if ms >= bound_ms else None


def k1_local(name: str, S: int, H: int, Kv: int, rng,
             plain_time: bool = True) -> dict:
    """K1 at a rank's local heads (``S`` slots over a 2048-token table of
    16-token pages, bf16) against its plain version, by device time beside
    its bound: ragged lengths, two of them at and one past the end of a
    split of the plan at these heads (``_split_plan`` halves its span as S
    x Kv shrinks)."""
    hd, ps, mp = 128, 16, 128
    span, n_split = pa._split_plan(S, Kv, mp, ps, hd, 2)
    lengths = [int(x) for x in rng.integers(129, 2049, size=S)]
    lengths[0], lengths[1], lengths[2] = span * ps, span * ps + 1, 2048
    q, pool, tables, lens = paged_case(43, S, H, Kv, hd, ps, mp, lengths,
                                       torch.bfloat16)
    kernel = lambda: pa.paged_attention_fwd(                # noqa: E731
        q, pool, tables, lens, buffer_depth=2)
    plain = lambda: pa.paged_attention_torch(               # noqa: E731
        q, pool, tables, lens, buffer_depth=2)
    err = max_err(kernel(), plain())
    bound = (sum(lengths) * 2 * Kv + 2 * S * H) * hd * 2 \
        / HBM_BYTES_PER_S * 1e3
    check(err < TOL_BF16, f"K1 at {name}'s heads: {err}")
    return {"S": S, "H": H, "Kv": Kv, "span": span, "n_split": n_split,
            "lengths_at_split": [span * ps, span * ps + 1],
            "max_abs_err": err,
            "device_ms": measured_ms(profiled_ms(kernel)[0], bound),
            "plain_device_ms": profiled_ms(plain, iters=3)[0]
            if plain_time else None,
            "bound_ms": bound, "bound_by": "bytes"}


def k2_local(name: str, B: int, S: int, H: int, Kv: int, hd: int = 128,
             dtype=torch.bfloat16, causal: bool = True,
             plain_time: bool = True) -> dict:
    """K2 at a rank's local heads against its plain version (bf16: by
    ``bf16_excess``; f32: within TOL_F32), by device time beside its
    bound and SDPA's."""
    q, k, v = flash_case(47, B, S, H, Kv, hd, dtype)
    kernel = lambda: fa.flash_attention_fwd(                 # noqa: E731
        q, k, v, causal=causal)
    plain = lambda: fa.flash_attention_torch(                # noqa: E731
        q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    got, want = kernel(), plain()
    f32 = dtype == torch.float32
    excess = None if f32 else bf16_excess(got, want)
    byts, flops = flash_bound(B, S, H, Kv, hd, q.element_size(), causal)
    peak = F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
    bound = max(byts / HBM_BYTES_PER_S, flops / peak)
    if f32:
        check(max_err(got, want) < TOL_F32,
              f"K2 at {name}'s heads: {max_err(got, want)}")
    else:
        check(excess <= 1.0, f"K2 at {name}'s heads: {excess}")
    return {"B": B, "S": S, "H": H, "Kv": Kv, "hd": hd,
            "dtype": str(dtype).split(".")[1], "causal": causal,
            "max_abs_err": max_err(got, want), "bf16_excess": excess,
            "device_ms": measured_ms(profiled_ms(kernel)[0], bound * 1e3),
            "plain_device_ms": profiled_ms(plain, iters=3)[0]
            if plain_time else None,
            "library_device_ms": measured_ms(profiled_ms(library)[0],
                                             bound * 1e3),
            "library_max_abs_err": max_err(library().transpose(1, 2), want),
            "bound_ms": bound * 1e3,
            "bound_by": "bytes" if byts / HBM_BYTES_PER_S >= flops / peak
            else "operations"}


def tp_kernels() -> dict:
    """K1 and K2 at the local head shapes of serve_tp's ranks (16 slots;
    K2 causal over one 1024-token prompt).  Their plain versions' times
    at these shapes were taken when they first ran (PERF.md §6)."""
    out = {}
    rng = np.random.default_rng(41)
    for name, H, Kv in TP_LOCAL:
        out[f"k1_{name}"] = k1_local(name, TP_ENGINE["n_slots"], H, Kv, rng,
                                     plain_time=False)
    for name, H, Kv in TP_LOCAL:
        out[f"k2_{name}"] = k2_local(name, 1, TP_K2_S, H, Kv,
                                     plain_time=False)
    return out


# launch.serve over two rank processes at the smoke width
TP_CLI = ("--paged", "--tp-size", "2", "--devices", "2", "--requests", "4",
          "--max-new", "4", "--cache-len", "64", "--block-size", "8")
TP_CLI_SUMMARY = "continuous tp=2 paged(depth=2): 4 requests, 16 tokens"


def tp_cli() -> dict:
    """``launch.serve --tp-size 2 --devices 2`` on the card: its parent
    (this process) calls ``serve/ranks.prebuild``, which finds the kernel
    library the build phase left, and its two rank processes load it."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(list(TP_CLI))
    out = buf.getvalue()
    lines = out.splitlines()
    reqs = [x for x in lines if x.startswith("[serve] req ")]
    check(len(reqs) == 4 and all("tokens=4" in x for x in reqs)
          and TP_CLI_SUMMARY in out, f"launch.serve over 2 ranks:\n{out}")
    return {"argv": list(TP_CLI), "seconds": time.perf_counter() - t0,
            "summary": lines[-1]}


def in_fresh_process(fns: tuple = ("tp_kernels",)) -> dict:
    """``chip_smoke.<fn>()`` for each of ``fns`` (``tp_kernels``,
    ``tpf_kernels``; ``offload_families``' ``transfer_kernels_check`` and
    ``overlap_arms_check``) in one process of their own: after the
    earlier phases' traces, the profiler in this process saw K1 and SDPA
    below their bounds (dropped kernels), the transfer proxy's kernels in
    part and the overlap arms' not at all, where a fresh process sees
    them whole.  Returns each one's result by name."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps({f: getattr(chip_smoke, f)() "
            "for f in sys.argv[2:]}))")
    run = subprocess.run([sys.executable, "-c", code, ROOT, *fns],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"{fns}:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def probe_logits(eng, prompts) -> tuple:
    """The prefill logits of ``prompts`` (last position) and one decode
    tick's, each prompt inserted into fresh pages of ``eng``'s pool (after
    a run, every page is free): (prefill (n, V), decode (n, V)) f32 numpy,
    the same calls on every rank of a leading mesh."""
    cells, dev = eng.cells, eng.device
    tables = np.full((cells.n_slots, cells.max_pages), eng.kv.trash_page,
                     np.int32)
    idx = np.zeros((cells.n_slots,), np.int32)
    tok = np.zeros((cells.n_slots,), np.int32)
    pre, next_page = [], 0
    for slot, prompt in enumerate(prompts):
        lk, caches = cells.prefill(eng.params,
                                   torch.tensor(prompt, device=dev)[None])
        pre.append(lk[0, -1].float().cpu())
        need = -(-(len(prompt) + 1) // cells.block_size)
        tables[slot, :need] = np.arange(next_page, next_page + need)
        next_page += need
        cells.insert(eng._pool, caches, torch.tensor(tables[slot],
                                                     device=dev))
        idx[slot], tok[slot] = len(prompt), int(torch.argmax(lk[0, -1]))
    dk, _ = cells.decode(eng.params, torch.tensor(tok, device=dev)[:, None],
                         torch.tensor(idx, device=dev), eng._pool,
                         torch.tensor(tables, device=dev))
    return (torch.stack(pre).numpy(),
            dk[:len(prompts), 0].float().cpu().numpy())


def tp_prompts(cfg) -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in TP_PROBE]


def tp_job(mesh, cfg, params, burst: dict, profile_tick: bool) -> dict:
    """The main path on ``mesh``: a warm-up, then ``burst`` through the
    paged engine with every rank's launches counted, one decode tick's
    exchanges, staged bytes and host time (and, with ``profile_tick``,
    its device time from a profiler window, whose first costs a process
    several seconds), then the probe logits.  Rank 0's job on a leading
    mesh, or the emulated run."""
    from repro_torch.serve import ranks
    dev = mesh.axis.device if mesh.distributed else DEV
    axis = mesh.axis
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        parts[name], t = now - t, now

    eng = ContinuousEngine(cfg, params, mesh=mesh, device=dev, **TP_ENGINE)
    eng.generate(make_requests(LoadSpec(vocab_size=cfg.vocab_size,
                                        **TP_WARM)))
    torch.cuda.synchronize(dev)
    lap("build_and_warm")
    ranks.reset_counts(mesh, dev)
    reqs = make_requests(LoadSpec(vocab_size=cfg.vocab_size, **burst))
    ex0, st0 = dict(axis.exchanges), axis.staged_bytes
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    ranks.snapshot_counts(mesh)
    launches, peak = ops.launch_counts(), torch.cuda.max_memory_allocated(dev)
    run_exchanges = {k: v - ex0.get(k, 0) for k, v in axis.exchanges.items()}
    run_staged = axis.staged_bytes - st0
    ticks = sum(1 for e in eng.step_log if e.decoded)
    check(all(len(r.generated) == burst["max_new_tokens"] for r in reqs),
          "a tensor-parallel request did not get its tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "page pool not recycled")
    lap("run")
    st1 = axis.staged_bytes
    counts = eng.cells.decode_collective_counts(eng.params)
    staged_tick = axis.staged_bytes - st1
    w0 = axis.wire_s                    # the tick above was the warm-up
    if profile_tick:
        tick = profiled_ms(lambda: eng.cells.count(eng.params), iters=2,
                           warmup=0, calls=True)
    else:
        t0 = time.perf_counter()
        for _ in range(2):
            eng.cells.count(eng.params)
        torch.cuda.synchronize(dev)
        tick = {"wall_ms": (time.perf_counter() - t0) / 2 * 1e3,
                "device_ms": None}
    tick_wire_ms = (axis.wire_s - w0) / 2 * 1e3
    lap("tick")
    pre, dec = probe_logits(eng, tp_prompts(cfg))
    lap("probe")
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    return {"tp_size": mesh.tp_size, "distributed": mesh.distributed,
            "n_requests": len(reqs), "tokens": n_tok, "seconds": elapsed,
            "tok_per_s": n_tok / elapsed,
            "ttft_median_s": statistics.median(ttft),
            "tpot_median_s": statistics.median(tpot), "decode_ticks": ticks,
            "launches": launches, "peak_memory_bytes": peak,
            "run_exchanges": run_exchanges, "run_staged_bytes": run_staged,
            "tick_collectives": counts, "tick_staged_bytes": staged_tick,
            "tick_host_ms": tick["wall_ms"], "tick_wire_ms": tick_wire_ms,
            "tick_device_ms": tick["device_ms"], "tick_idle_share":
            None if tick["device_ms"] is None
            else 1.0 - tick["device_ms"] / tick["wall_ms"],
            "seconds_by_part": parts,
            "prefill_logits": pre, "decode_logits": dec}


def tp_smoke_job(mesh, cfg, params, spec: dict = TP_F32_SPEC) -> dict:
    """An f32 smoke config's burst ``spec`` on ``mesh`` (paged where the
    arch takes pages, else dense): streams and admission log."""
    dev = mesh.axis.device if mesh is not None and mesh.distributed else DEV
    eng = ContinuousEngine(cfg, params, mesh=mesh, device=dev,
                           paged=paged_supported(cfg), **TP_F32_ENGINE)
    reqs = eng.generate(make_requests(LoadSpec(vocab_size=cfg.vocab_size,
                                               **spec)))
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "smoke pool not recycled")
    return {"streams": [list(r.generated) for r in reqs],
            "admit_log": list(eng.scheduler.admit_log)}


def tp_logits_check(name: str, got: dict, want: tuple) -> dict:
    """The prefill and decode logits of a tensor-parallel run against tp
    1's, within the serve phase's rule (TOL_LOGITS_ULPS bf16 spacings at
    the largest tp-1 logit)."""
    row = {}
    for key, w in zip(("prefill_logits", "decode_logits"), want):
        g = got.pop(key)
        err = float(np.max(np.abs(g - w)))
        tol = logits_tol(torch.from_numpy(w))
        row[key.replace("logits", "err")] = err
        row[key.replace("logits", "tol")] = tol
        row[key.replace("logits", "argmax_equal")] = float(
            np.mean(g.argmax(-1) == w.argmax(-1)))
        check(bool(np.isfinite(g).all()), f"{name}: {key} not finite")
    return row


def phase_serve_tp(card: str, hand: Handoff) -> dict:
    """Tensor-parallel serving over a ``model`` axis (full width, bf16,
    seed 0): (a) K1 and K2 at the ranks' local head shapes; (b) OLMo-1B's
    burst through the paged engine at tp 2 and 4 over rank processes
    (gloo through pinned host memory: ranks on one card) and at tp 4
    emulated; (c) Mistral-NeMo-12B's at tp 4 over ranks; each run's
    prefill and decode logits against tp 1 (the serve and serve_nemo
    phases' where they ran); (d) the f32 smoke OLMo, NeMo and Danube at tp
    1/2/4, emulated and over ranks: equal streams and admission logs; and
    ``launch.serve --paged --tp-size 2 --devices 2`` at the smoke width.
    K1's and K2's launches are summed over every rank of every run of (b)
    and (c).  Where serve_tp_families follows, its kernels share (a)'s
    process and its rank jobs (b)'s groups (``hand``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.dist import run_ranks
    from repro_torch.serve import ranks
    phase_start("serve_tp")
    t_step = time.perf_counter()
    families = hand.wants("serve_tp_families")

    def step(name, **kw):
        nonlocal t_step
        now = time.perf_counter()
        emit("serve_tp", step=name, seconds=now - t_step, **kw)
        t_step = now

    both = in_fresh_process(("tp_kernels", "tpf_kernels") if families
                            else ("tp_kernels",))
    out = {"card": card, "kernels": both["tp_kernels"]}
    hand.kernels.update(both.get("tpf_kernels", {}))
    step("kernels", kernels=out["kernels"])

    out["cli"] = tp_cli()
    step("cli", cli=out["cli"])

    # (d) the f32 smoke configs on this process: tp 1 and emulated 2, 4
    smoke_cfgs = {a: dataclasses.replace(smoke(all_archs()[a]),
                                         dtype="float32") for a in TP_F32}
    smoke_runs = {}
    for a, c in smoke_cfgs.items():
        p = make_params(c, 0)
        for tp in (1, 2, 4):
            mesh = make_host_mesh(1, tp) if tp > 1 else None
            smoke_runs[(a, tp, "emulated")] = tp_smoke_job(mesh, c, p)
    step("f32_smoke_emulated")

    # tp 1's logits of each full-width model (the serve and serve_nemo
    # phases' where they ran), and OLMo-1B at tp 4 emulated
    want, runs = {}, {}
    for arch in TP_BURSTS:
        cfg = all_archs()[arch]
        want[arch] = hand.tp1.get(arch)
        if want[arch] is not None and arch != "olmo-1b":
            continue
        params = make_params(cfg, 0)
        if want[arch] is None:
            eng = ContinuousEngine(cfg, params, device=DEV, **TP_ENGINE)
            want[arch] = probe_logits(eng, tp_prompts(cfg))
            del eng
        if arch == "olmo-1b":
            ops.reset_launch_counts()
            runs[(arch, 4, "emulated")] = tp_job(
                make_host_mesh(1, 4), cfg, params, TP_BURSTS[arch], False)
        del params
        phase_end()
    step("tp1_logits_and_olmo-1b_tp4_emulated")

    # over rank processes: one group of 2, one of 4, every model's job
    group_jobs = {2: [("olmo-1b", 2)],
                  4: [("olmo-1b", 4), ("mistral-nemo-12b", 4)]}
    for n, full in group_jobs.items():
        # the tick's device time in the ranked OLMo-1B run at tp 2 alone
        # (PERF.md §5), under --profile: a rank's first profiler window
        # costs ~6 s
        jobs = [(all_archs()[a], ("seed", 0), tp_job,
                 (TP_BURSTS[a], a == "olmo-1b" and n == 2 and hand.profile))
                for a, _ in full]
        jobs += [(smoke_cfgs[a], ("seed", 0), tp_smoke_job, ())
                 for a in TP_F32]
        # serve_tp_families' jobs of this size ride the same group
        fam = tpf_group_jobs(hand.profile)[n] if families else []
        jobs += [(c, ("seed", 0), job, args) for _, c, job, args in fam]
        res = run_ranks(ranks.serve_jobs, n, backend="gloo", device=DEV,
                        args=(jobs,))
        step(f"group_{n}", jobs=[a for a, _ in full]
             + [f"{a} f32 smoke" for a in TP_F32]
             + [label for label, *_ in fam])
        if fam:
            k0 = len(jobs) - len(fam)
            hand.groups[n] = ([label for label, *_ in fam],
                              [r[k0:] for r in res])
        for i, (a, _) in enumerate(full):
            # rank 0's counts as its job read them after the burst, the
            # others' as they kept them then (ranks.snapshot_counts)
            r = dict(res[0][i]["result"])
            r["launches_by_rank"] = [r["launches"]] + [
                res[k][i]["launches"] for k in range(1, n)]
            r["peak_memory_by_rank"] = [r["peak_memory_bytes"]] + [
                res[k][i]["peak_bytes"] for k in range(1, n)]
            r["exchanges_by_rank"] = [res[k][i]["exchanges"]
                                      for k in range(n)]
            runs[(a, n, "ranks")] = r
        for j, a in enumerate(TP_F32):
            smoke_runs[(a, n, "ranks")] = res[0][len(full) + j]["result"]

    # the checks, after every number is in
    summary = {}
    launches = {"paged_attention": 0, "flash_attention": 0}
    for (arch, tp, how), r in runs.items():
        cfg = all_archs()[arch]
        key = f"{arch}_tp{tp}_{how}"
        row = tp_logits_check(key, r, want[arch])
        by_rank = r.get("launches_by_rank", [r["launches"]])
        k1 = sum(x["paged_attention"] for x in by_rank)
        k2 = sum(x["flash_attention"] for x in by_rank)
        launches["paged_attention"] += k1
        launches["flash_attention"] += k2
        L = cfg.num_layers
        row.update({k: v for k, v in r.items() if k != "launches_by_rank"},
                   k1_launches=k1, k2_launches=k2)
        summary[key] = row
        emit("serve_tp", run=key, **row)
        check(k1 == r["decode_ticks"] * L * tp,
              f"{key}: K1 launches {k1} != ticks {r['decode_ticks']} x "
              f"{L} layers x {tp} ranks")
        check(k2 == r["n_requests"] * L * tp,
              f"{key}: K2 launches {k2} != {r['n_requests']} x {L} x {tp}")
        check(r["tick_collectives"] == {"all-gather": 1,
                                        "all-reduce": 2 * L + 1},
              f"{key}: decode tick exchanges {r['tick_collectives']}")
        for part in ("prefill", "decode"):
            check(row[f"{part}_err"] <= row[f"{part}_tol"],
                  f"{key}: {part} logits differ from tp 1 by "
                  f"{row[part + '_err']} (tolerance {row[part + '_tol']})")
    for a in TP_F32:
        base = smoke_runs[(a, 1, "emulated")]
        for (b, tp, how), r in smoke_runs.items():
            if b == a and tp > 1:
                check(r == base, f"f32 smoke {a} at tp {tp} ({how}): "
                                 f"streams or admissions differ from tp 1")
    out.update(runs=summary, f32_smoke_equal=sorted(
        f"{a}_tp{tp}_{how}" for a, tp, how in smoke_runs if tp > 1),
        launches=launches)
    emit("serve_tp", launches=launches,
         f32_smoke_equal=out["f32_smoke_equal"])
    phase_end()
    return out


# ---------------------------------------------------------------------------
# phase: serve_tp_families (tensor parallelism of the other families)
# ---------------------------------------------------------------------------

TPF_MOE_ENGINE = dict(MOE_ENGINE, paged=True, page_buffer_depth=2)
TPF_MOE_BURST = dict(n_requests=4, rate_rps=0.0, prompt_lens=(1024, 128),
                     max_new_tokens=4, seed=0)
TPF_RWKV_ENGINE = dict(n_slots=16, cache_len=2048, paged=False)  # serve_rwkv's
TPF_RWKV_BURST = dict(n_requests=3, rate_rps=0.0,
                      prompt_lens=(64, 512, 1024), max_new_tokens=2, seed=0)
TPF_WARM = dict(n_requests=1, rate_rps=0.0, prompt_lens=(16,),
                max_new_tokens=2, seed=1)
TPF_F32_SPEC = dict(n_requests=4, rate_rps=0.0, prompt_lens=(8, 16),
                    max_new_tokens=6, seed=3)
# the prompt whose prefill logits (last position) and one decode tick are
# held at tp N against the plain arm and against tp 1 (short and one:
# over gloo a prompt's prefill costs its tokens in every arm; the bursts
# carry the 1024-token prefills)
TPF_PROBE = {"moe": (128,), "ssm": (128,)}            # by family
# the kernel arm is held by the rule of the one-device phases of these
# deep random-weight bf16 models (check_logits: max(4 spacings, 2 x the
# nudged floor)), the floor from NUDGE_SEEDS' nudged arms (each arm a
# prefill and a tick over gloo), with each kernel also run beside its
# plain version on every rank's real inputs in the plain arm (ARM_PROBES)
TPF_NUDGED = tuple(f"nudged{s}" for s in NUDGE_SEEDS)
TPF_MOE_ARMS = ("kernel", "torch") + TPF_NUDGED + ("fault1",)
TPF_RWKV_ARMS = ("kernel", "torch") + TPF_NUDGED
TPF_VLM_TP, TPF_VLM_STEPS = 4, 4
TPF_WHISPER_TP, TPF_WHISPER_STEPS = 2, 16
# the share of (token, layer) top-6 expert choices at tp 4 equal to tp 1's
# must reach this: set from the readings of two H100 calls (0.634 over the
# probe prompts of 128 and 77 tokens, 0.574 over the one of 128; a bf16
# partial sum in another order flips a near-tie, and a flipped choice
# moves the next layers' inputs), far above the planted fault's (rank 1's
# experts offset by one: 0.094 and 0.105), which must fail it
TPF_ROUTE_SHARE_MIN = 0.35
TPF_SMOKE_ENGINES = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
                     "rwkv6-7b", "jamba-1.5-large-398b",
                     "jamba-with-attention")
TPF_SMOKE_REGISTRY = ("whisper-base", "internvl2-26b")
# over rank processes (the group of 4): one arch a family the engines take
TPF_SMOKE_RANKED = ("moonshot-v1-16b-a3b", "rwkv6-7b", "jamba-with-attention")
TPF_CLI = ("--arch", "rwkv6-7b", "--tp-size", "2", "--devices", "2",
           "--requests", "4", "--max-new", "4")
TPF_CLI_SUMMARY = "continuous tp=2: 4 requests, 16 tokens"
# the local shapes of the phase's ranks (name, slots or batch, S, query
# heads, kv heads, head dim, dtype, causal)
TPF_K1 = (("moonshot_tp4", MOE_ENGINE["n_slots"], 4, 4),)
TPF_K2 = (("moonshot_tp4", 1, 1024, 4, 4, 128, torch.bfloat16, True),
          ("internvl2_tp4", VLM_BATCH, 1024, 12, 2, 128, torch.bfloat16,
           True),
          ("whisper_tp2", WHISPER_BATCH, WHISPER_FRAMES, 4, 4, 64,
           torch.float32, False))
TPF_K4_HEADS = (32, 16)              # RWKV6-7B's 64 heads at tp 2 and 4
# the phases whose hand-offs serve_tp_families needs: main() adds them to
# a run that asks for it
TPF_PROVIDERS = ("serve_moe", "serve_rwkv", "serve_vlm", "serve_encdec")


@dataclasses.dataclass
class Handoff:
    """What earlier phases leave on the host for serve_tp and
    serve_tp_families, in one place: main() makes it and passes it to
    every phase that gives or takes.  ``phases``: the run's phases (a
    phase computes a hand-off only for a taker that runs); ``profile``:
    --profile (serve_tp's and serve_tp_families' rank jobs trace their
    decode tick for its device time; a rank's first profiler window costs
    it ~15-30 s).  ``tp1``: by arch, tp 1's probes of the same prompts at
    the same seed (serve, serve_nemo, serve_moe, serve_rwkv) and Whisper's
    tp-1 streams (serve_encdec); ``vlm``: InternVL2-26B at tp 4, run at
    serve_vlm's end on its weights.  No model is drawn twice for them.
    Where serve_tp runs first, serve_tp_families' kernels (``kernels``,
    in serve_tp's kernels process) and rank jobs (``groups``: group size
    -> (labels, every rank's results), in serve_tp's rank groups: one
    group's start-up for both).  ``dryrun``: the ``--plan`` cell's dry
    run (phase dryrun, for offload_families); ``dryrun_procs``: the
    production cells' processes (``dryrun_start``, from main())."""
    phases: tuple = ()
    profile: bool = False
    tp1: dict = dataclasses.field(default_factory=dict)
    vlm: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    dryrun: dict = dataclasses.field(default_factory=dict)
    dryrun_procs: dict = dataclasses.field(default_factory=dict)

    def wants(self, phase: str) -> bool:
        return phase in self.phases

    def take_tp1(self, arch: str, provider: str):
        check(arch in self.tp1, f"serve_tp_families: no tp-1 run of {arch} "
                                f"(phase {provider} gives it)")
        return self.tp1[arch]


def smoke_cfg(name: str):
    """The f32 smoke config of ``name`` (``jamba-with-attention``: the
    smoke Jamba with an attention layer in each group of 4)."""
    if name == "jamba-with-attention":
        return dataclasses.replace(smoke(all_archs()["jamba-1.5-large-398b"]),
                                   dtype="float32", **JAMBA_ATTN)
    return dataclasses.replace(smoke(all_archs()[name]), dtype="float32")


def tpf_prompts(cfg) -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in TPF_PROBE[cfg.family]]


def probe_dense(eng, prompts) -> tuple:
    """``probe_logits`` for the dense engine: each prompt prefilled into a
    slot of ``eng``'s own slot caches (a leading mesh's followers insert
    into theirs), then one decode tick."""
    cells, dev = eng.cells, eng.device
    idx = np.zeros((cells.n_slots,), np.int32)
    tok = np.zeros((cells.n_slots,), np.int32)
    pre = []
    for slot, prompt in enumerate(prompts):
        lk, base = cells.prefill(eng.params,
                                 torch.tensor(prompt, device=dev)[None])
        pre.append(lk[0, -1].float().cpu())
        cells.insert(eng._caches, base, slot)
        idx[slot], tok[slot] = len(prompt), int(torch.argmax(lk[0, -1]))
    dk, _ = cells.decode(eng.params, torch.tensor(tok, device=dev)[:, None],
                         torch.tensor(idx, device=dev), eng._caches)
    return (torch.stack(pre).numpy(),
            dk[:len(prompts), 0].float().cpu().numpy())


def tpf_probe(eng, prompts) -> tuple:
    return (probe_logits if eng.paged else probe_dense)(eng, prompts)


@contextlib.contextmanager
def recorded_routes(out: list):
    """Every MoE layer's top-k expert ids, sorted a token, appended to
    ``out`` as it routes (one call a layer)."""
    from repro_torch.models import moe
    real = moe.routing

    def record(cfg, p, x):
        r = real(cfg, p, x)
        idx = r["idx"].reshape(-1, r["idx"].shape[-1])
        out.append(torch.sort(idx, dim=-1)[0].cpu().numpy())
        return r
    moe.routing = record
    try:
        yield
    finally:
        moe.routing = real


def route_share(got: list, want: list) -> float:
    """The share of (token, layer) top-k choices of ``got`` equal to
    ``want``'s."""
    check(len(got) == len(want), f"{len(got)} routings against {len(want)}")
    same = sum(int((g == w).all(-1).sum()) for g, w in zip(got, want))
    return same / sum(w.shape[0] for w in want)


@contextlib.contextmanager
def expert_fault(rank: int):
    """A planted fault: in rank ``rank`` of the group, each MoE layer's
    experts offset by one (expert e runs e - 1's weights)."""
    import torch.distributed as dist
    from repro_torch.models import moe
    real = moe._experts
    if dist.is_initialized() and dist.get_rank() == rank:
        def shifted(cfg, p, xg, disp, comb):
            q = {k: ({"kernel": torch.roll(v["kernel"], 1, dims=0)}
                     if k in ("wi", "wg", "wo") else v) for k, v in p.items()}
            return real(cfg, q, xg, disp, comb)
        moe._experts = shifted
    try:
        yield
    finally:
        moe._experts = real


# the plain arm's probes in this process (a rank's own, on its real
# inputs): tp_arm("torch") fills them, arm_probes reads them
ARM_PROBES = {"k1": [], "k2": [], "k4": []}


@contextlib.contextmanager
def tp_arm(name: str):
    """An arm of a check, entered on every rank alike
    (``arm_on_all_ranks``): ``kernel``; ``torch``, the plain
    attention, paged attention and WKV-6 scan, with K2, K1 and K4 each
    run beside its plain version on the same inputs (``probe_attention``,
    ``probe_paged``, ``probe_scan`` into ARM_PROBES); ``nudged<seed>``,
    the plain path with those outputs nudged (``nudge_attention``,
    ``nudge_scan``): the floor; ``fault<rank>``, the kernel path with
    that rank's experts offset by one."""
    with contextlib.ExitStack() as stack:
        if name == "torch":
            for records in ARM_PROBES.values():
                records.clear()
            stack.enter_context(plain_path(*ATTENTION,
                                           probe_attention(ARM_PROBES["k2"])))
            stack.enter_context(plain_path(*PAGED,
                                           probe_paged(ARM_PROBES["k1"])))
            stack.enter_context(plain_path(*SCAN,
                                           probe_scan(ARM_PROBES["k4"])))
        elif name.startswith("nudged"):
            seed = int(name[len("nudged"):])
            stack.enter_context(plain_path(*ATTENTION, nudge_attention(seed)))
            stack.enter_context(plain_path(*PAGED,
                                           nudge_attention(seed + 100)))
            stack.enter_context(plain_path(*SCAN, nudge_scan(seed)))
        elif name.startswith("fault"):
            stack.enter_context(expert_fault(int(name[len("fault"):])))
        yield


ARM_STACK: list = []     # the arms this process is in (a rank's own)


def enter_arm(mesh, params, name: str) -> None:
    """``tp_arm(name)`` entered in this process until ``leave_arm``."""
    stack = contextlib.ExitStack()
    stack.enter_context(tp_arm(name))
    ARM_STACK.append(stack)


def leave_arm(mesh, params) -> None:
    ARM_STACK.pop().close()


@contextlib.contextmanager
def arm_on_all_ranks(mesh, params, name: str):
    """``tp_arm(name)`` on every rank of a leading ``mesh`` alike, entered
    and left together (``serve/ranks.call_all_ranks``: rank 0 sends each
    call to the others first)."""
    from repro_torch.serve import ranks
    ranks.call_all_ranks(mesh, params, enter_arm, name)
    try:
        yield
    finally:
        ranks.call_all_ranks(mesh, params, leave_arm)


def arm_probes(mesh, params=None) -> dict:
    """The plain arm's probes (ARM_PROBES) over every rank: per kernel,
    the fewest and most calls a rank probed and the largest error (K2's
    also its ``bf16_excess``; K4's relative, as ``probe_scan``'s).  On a
    leading mesh every rank runs it (``serve/ranks.call_all_ranks``): one
    all-reduce of the maximum."""
    def top(records, key):
        return max((r[key] for r in records), default=0.0)
    k1, k2, k4 = (ARM_PROBES[k] for k in ("k1", "k2", "k4"))
    row = [len(k1), -len(k1), top(k1, "err"), len(k2), -len(k2),
           top(k2, "err"), top(k2, "excess"), len(k4), -len(k4),
           max(k4, default=0.0)]
    if mesh is not None and mesh.distributed:
        row = mesh.axis.pmax(torch.tensor(
            row, dtype=torch.float32, device=mesh.axis.device)[None])
        row = [float(x) for x in row.cpu()]
    out = {}
    for name, at in (("k1", 0), ("k2", 3), ("k4", 7)):
        out[name] = {"calls": [int(-row[at + 1]), int(row[at])],
                     "err": row[at + 2]}
    out["k2"]["excess"] = row[6]
    return out


def check_arm_probes(key: str, real: dict, calls: dict) -> None:
    """The plain arm's probes (``arm_probes``) held as the one-device
    phases hold theirs: each kernel in ``calls`` probed that many times
    on every rank, K2 within its bf16 bound, K1 within TOL_BF16, K4 within
    TOL_SCAN."""
    for name, n in calls.items():
        check(real[name]["calls"] == [n, n],
              f"{key}: {name} probed {real[name]['calls']} times a rank "
              f"(fewest, most), not {n}")
    if "k2" in calls:
        check(real["k2"]["excess"] <= 1, f"{key}: K2 vs plain on the ranks' "
              f"real inputs: bf16 bound used {real['k2']['excess']} times")
    if "k1" in calls:
        check(real["k1"]["err"] < TOL_BF16, f"{key}: K1 vs plain on the "
              f"ranks' real inputs: {real['k1']['err']}")
    if "k4" in calls:
        check(real["k4"]["err"] <= TOL_SCAN, f"{key}: K4 vs plain on the "
              f"ranks' real inputs: relative {real['k4']['err']}")


def tpf_tick(eng, axis, dev, profile: bool) -> dict:
    """One decode tick on scratch state: its exchanges by kind, bytes
    staged, host ms, wire ms (host time inside the collectives) and, with
    ``profile``, device ms from a profiler window."""
    st1 = axis.staged_bytes
    counts = eng.cells.decode_collective_counts(eng.params)
    staged = axis.staged_bytes - st1
    w0 = axis.wire_s                    # the tick above was the warm-up
    if profile:
        tick = profiled_ms(lambda: eng.cells.count(eng.params), iters=2,
                           warmup=0, calls=True)
    else:
        t0 = time.perf_counter()
        for _ in range(2):
            eng.cells.count(eng.params)
        torch.cuda.synchronize(dev)
        tick = {"wall_ms": (time.perf_counter() - t0) / 2 * 1e3,
                "device_ms": None}
    return {"tick_collectives": counts, "tick_staged_bytes": staged,
            "tick_host_ms": tick["wall_ms"],
            "tick_wire_ms": (axis.wire_s - w0) / 2 * 1e3,
            "tick_device_ms": tick["device_ms"], "tick_idle_share":
            None if tick["device_ms"] is None
            else 1.0 - tick["device_ms"] / tick["wall_ms"]}


def tpf_job(mesh, cfg, params, engine_kw: dict, burst: dict, arms: tuple,
            profile: bool = False) -> dict:
    """A family's main path on ``mesh`` (rank 0's job on a leading mesh):
    a warm-up, then ``burst`` through the engine with every rank's
    launches counted, one decode tick (``tpf_tick``), then the probe
    prompts' logits in each of ``arms`` (entered on every rank; an MoE's
    routing recorded in rank 0, which routes as every rank does)."""
    from repro_torch.serve import ranks
    dev = mesh.axis.device if mesh.distributed else DEV
    axis = mesh.axis
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        parts[name], t = now - t, now

    eng = ContinuousEngine(cfg, params, mesh=mesh, device=dev, **engine_kw)
    eng.generate(make_requests(LoadSpec(vocab_size=cfg.vocab_size,
                                        **TPF_WARM)))
    torch.cuda.synchronize(dev)
    lap("build_and_warm")
    ranks.reset_counts(mesh, dev)
    reqs = make_requests(LoadSpec(vocab_size=cfg.vocab_size, **burst))
    ex0, st0 = dict(axis.exchanges), axis.staged_bytes
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    ranks.snapshot_counts(mesh)
    launches, peak = ops.launch_counts(), torch.cuda.max_memory_allocated(dev)
    run_exchanges = {k: v - ex0.get(k, 0) for k, v in axis.exchanges.items()}
    run_staged = axis.staged_bytes - st0
    ticks = sum(1 for e in eng.step_log if e.decoded)
    check(all(len(r.generated) == burst["max_new_tokens"] for r in reqs),
          f"{cfg.name}: a tensor-parallel request did not get its tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{cfg.name}: token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, f"{cfg.name}: KV not recycled")
    lap("run")
    tick = tpf_tick(eng, axis, dev, profile)
    lap("tick")
    prompts = tpf_prompts(cfg)
    probes = {}
    for arm in arms:
        routes: list = []
        with arm_on_all_ranks(mesh, eng.params, arm), \
                (recorded_routes(routes) if cfg.num_experts
                 else contextlib.nullcontext()):
            probes[arm] = tpf_probe(eng, prompts) + (routes,)
    real = ranks.call_all_ranks(mesh, eng.params, arm_probes)
    lap("arms")
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs if r.tpot_s is not None]
    n_tok = sum(len(r.generated) for r in reqs)
    return {"tp_size": mesh.tp_size, "distributed": mesh.distributed,
            "n_requests": len(reqs), "tokens": n_tok, "seconds": elapsed,
            "tok_per_s": n_tok / elapsed,
            "ttft_median_s": statistics.median(ttft),
            "tpot_median_s": statistics.median(tpot), "decode_ticks": ticks,
            "launches": launches, "peak_memory_bytes": peak,
            "run_exchanges": run_exchanges, "run_staged_bytes": run_staged,
            **tick, "seconds_by_part": parts, "probes": probes,
            "real_probes": real}


def tpf_greedy_job(mesh, cfg, params, batch: dict, steps: int,
                   cache_len: int) -> dict:
    """``rank_bodies.greedy`` on every rank of a leading mesh, each rank's
    launches counted around it."""
    from repro_torch.serve import ranks
    dev = mesh.axis.device
    ranks.reset_counts(mesh, dev)
    ex0 = dict(mesh.axis.exchanges)
    t0 = time.perf_counter()
    run = ranks.call_all_ranks(mesh, params, rank_bodies.greedy, cfg, batch,
                               steps, cache_len)
    torch.cuda.synchronize(dev)
    ranks.snapshot_counts(mesh)
    return dict(run, seconds=time.perf_counter() - t0,
                launches=ops.launch_counts(),
                peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
                run_exchanges={k: v - ex0.get(k, 0)
                               for k, v in mesh.axis.exchanges.items()})


def shard_in_place(params: dict, n: int, heads: dict):
    """``params`` (a full tree on the card) split over an emulated model
    axis of ``n`` leaf by leaf, each full leaf freed once its slices are
    made: the peak is the weights and one leaf's slices, not two
    copies."""
    from repro_torch.parallel import sharding

    def walk(tree, prefix):
        for key in list(tree):
            if isinstance(tree[key], dict):
                walk(tree[key], prefix + (key,))
                continue
            path = "/".join(prefix + (key,))
            leaf = tree.pop(key)
            dim = sharding.spec_for_param(path, leaf.shape, n, heads)
            tree[key] = sharding.slice_leaf(leaf, dim, n, range(n),
                                            sharding.fused_parts(path))
            del leaf
    walk(params, ())
    out = sharding.Shards(params)
    out.n, out.held = n, tuple(range(n))
    return out


def logits_vs(got, want) -> dict:
    """A tensor-parallel run's logits against another arm's: the largest
    difference, its tolerance (TOL_LOGITS_ULPS spacings at the largest of
    ``want``) and the share of rows whose argmax is equal."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    check(bool(np.isfinite(g).all()), "logits not finite")
    return {"err": float(np.max(np.abs(g - w))),
            "tol": logits_tol(torch.from_numpy(w)),
            "argmax_equal": float(np.mean(g.argmax(-1) == w.argmax(-1)))}


def vlm_tp(cfg, params: dict, batch: dict, cache_len: int,
           tp1: tuple) -> dict:
    """InternVL2-26B at tp ``TPF_VLM_TP`` emulated on ``params`` (split in
    place; serve_vlm's weights): its prefill and ``TPF_VLM_STEPS`` greedy
    decode steps with K2's launches counted, each decode tick's exchanges
    against the derived count, then the prefill logits and one decode tick
    in the plain arm (K2's plain version, with K2 probed beside each call
    on its real inputs) and the nudged arms, held by ``check_logits``
    (serve_vlm's rule), and against tp 1's (``tp1``: serve_vlm's kernel
    arm)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    n = TPF_VLM_TP
    t0 = time.perf_counter()
    sh = shard_in_place(params, n, sharding.head_counts(cfg))
    mesh = make_host_mesh(1, n)
    axis = mesh.axis
    shard_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = rank_bodies.greedy(mesh, sh, cfg, batch, TPF_VLM_STEPS, cache_len)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    S = batch["tokens"].shape[1] + cfg.num_patches
    out = {}
    with torch.no_grad():
        for arm in ("kernel", "torch") + TPF_NUDGED:
            with tp_arm(arm):
                pre, caches = registry.prefill(cfg, sh, batch,
                                               cache_len=cache_len, axis=axis)
                tok = torch.argmax(tp1[0][:, -1], dim=-1)[:, None]
                ex0 = dict(axis.exchanges)
                dec, _ = registry.decode_step(
                    cfg, sh, {"tokens": tok.to(torch.int32), "index": S},
                    caches, axis=axis)
                tick = {k.replace("_", "-"): v - ex0.get(k, 0)
                        for k, v in axis.exchanges.items()
                        if v - ex0.get(k, 0)}
            out[arm] = (pre[:, -1].float(), dec[:, -1].float(), tick)
            del caches
    # K2 beside each plain attention call of every emulated rank's prefill
    real = arm_probes(None)
    check_arm_probes("InternVL2 tp 4", real, {"k2": cfg.num_layers * n})
    rows = {}
    for i, part in enumerate(("prefill", "decode")):
        rows[part] = logits_row()
        compare_logits(rows[part], out["kernel"][i], out["torch"][i],
                       [out[a][i] for a in TPF_NUDGED])
    return {"tp_size": n, "distributed": False, "shard_seconds": shard_s,
            "ttft_s": run["ttft_s"], "step_s": run["step_s"],
            "streams": run["streams"], "launches": launches,
            "peak_memory_bytes": peak, "tick_collectives": out["kernel"][2],
            "kernel_vs_plain": rows, "real_probes": real,
            "vs_tp1": {
                "prefill": logits_vs(out["kernel"][0].cpu().numpy(),
                                     tp1[0][:, -1].float().cpu().numpy()),
                "decode": logits_vs(out["kernel"][1].cpu().numpy(),
                                    tp1[1][:, -1].float().cpu().numpy())}}


def whisper_batch(cfg) -> dict:
    """serve_encdec's batch (its seeds), on the card."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4)
    rng = np.random.default_rng(13)
    return {"tokens": torch.tensor(rng.integers(
                0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT)).astype(
                np.int32), device=DEV),
            "frames": torch.randn((WHISPER_BATCH, WHISPER_FRAMES,
                                   cfg.d_model), generator=gen, device=DEV)}


def tpf_kernels() -> dict:
    """K1, K2 and K4 at this phase's local shapes, each against its plain
    version, timed by device time beside its bound (and SDPA's for K2):
    K1 and K2 at Moonlight's 4 q / 4 kv heads of a rank of 4, K2 at
    InternVL2's 12 / 2 (rep 6) and, in f32, non-causal, at Whisper's 4 /
    4 of a rank of 2 (hd 64); K4 at RWKV6-7B's 32 and 16 heads of 64 at
    the burst's prefill lengths (64, 512, 1024)."""
    out = {}
    rng = np.random.default_rng(41)
    for name, S, H, Kv in TPF_K1:
        out[f"k1_{name}"] = k1_local(name, S, H, Kv, rng, plain_time=False)
    for name, B, S, H, Kv, hd, dtype, causal in TPF_K2:
        out[f"k2_{name}"] = k2_local(name, B, S, H, Kv, hd, dtype, causal,
                                     plain_time=False)
    dh, L = 64, 64
    for H in TPF_K4_HEADS:
        for T in RWKV_LENGTHS:          # timed at the longest prefill only
            args = rwkv_case(13, 1, T, H, dh)
            got = rs.rwkv6_scan_fwd(*args, chunk=L)
            plain = rs.rwkv6_scan_torch(*args, chunk=L)
            err = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
            check(err < TOL_SCAN, f"K4 at {H} heads, T={T}: {err}")
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"K4 at {H} heads: output not finite")
            row = {"B": 1, "T": T, "H": H, "dh": dh, "max_abs_err": err}
            if T == RWKV_LENGTHS[-1]:
                byts, flops = rwkv_bound(1, T, H, dh, L)
                t_bytes = byts / HBM_BYTES_PER_S
                t_ops = flops / F32_FLOPS_PER_S
                bound = max(t_bytes, t_ops) * 1e3
                row.update(
                    device_ms=measured_ms(profiled_ms(
                        lambda: rs.rwkv6_scan_fwd(*args, chunk=L))[0],
                        bound),
                    plain_device_ms=profiled_ms(
                        lambda: rs.rwkv6_scan_torch(*args, chunk=L),
                        iters=3)[0],
                    bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
            out[f"k4_h{H}_t{T}"] = row
    return out


def tpf_cli() -> dict:
    """``launch.serve --arch rwkv6-7b --tp-size 2 --devices 2`` at the
    smoke width on the card."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(list(TPF_CLI))
    out = buf.getvalue()
    reqs = [x for x in out.splitlines() if x.startswith("[serve] req ")]
    check(len(reqs) == 4 and all("tokens=4" in x for x in reqs)
          and TPF_CLI_SUMMARY in out,
          f"launch.serve --arch rwkv6-7b over 2 ranks:\n{out}")
    return {"argv": list(TPF_CLI), "seconds": time.perf_counter() - t0,
            "summary": out.splitlines()[-1]}


def tpf_check_run(key: str, cfg, r: dict, want: tuple, tp: int) -> dict:
    """A ranked family run's checks: every rank's launches against the
    derived counts, the tick's exchanges against ``decode_exchanges``, each
    kernel against its plain version on every rank's real inputs, the
    kernel arm against the plain arm, and the report against tp 1
    (``want``: tp 1's probe, from the family's one-device phase)."""
    probes = r.pop("probes")
    by_rank = r["launches_by_rank"]
    L = cfg.num_layers
    k = {name: sum(x[name] for x in by_rank)
         for name in ("paged_attention", "flash_attention", "rwkv6_scan")}
    if cfg.family == "ssm":
        check(k["rwkv6_scan"] == r["n_requests"] * L * tp,
              f"{key}: K4 launches {k['rwkv6_scan']} != {r['n_requests']} x "
              f"{L} x {tp}")
    else:
        check(k["paged_attention"] == r["decode_ticks"] * L * tp,
              f"{key}: K1 launches {k['paged_attention']} != ticks "
              f"{r['decode_ticks']} x {L} x {tp}")
        check(k["flash_attention"] == r["n_requests"] * L * tp,
              f"{key}: K2 launches {k['flash_attention']} != "
              f"{r['n_requests']} x {L} x {tp}")
    derived = registry.decode_exchanges(cfg, tp)
    check(r["tick_collectives"] == derived,
          f"{key}: decode tick exchanges {r['tick_collectives']} != "
          f"{derived}")
    n_probed = len(TPF_PROBE[cfg.family]) * L
    check_arm_probes(key, r["real_probes"],
                     {"k4": n_probed} if cfg.family == "ssm"
                     else {"k1": L, "k2": n_probed})
    kern, plain = probes["kernel"], probes["torch"]
    nudged = [a for a in probes if a.startswith("nudged")]
    row = {}
    for i, part in enumerate(("prefill", "decode")):
        rr = logits_row()
        compare_logits(rr, torch.from_numpy(kern[i]),
                       torch.from_numpy(plain[i]),
                       [torch.from_numpy(probes[a][i]) for a in nudged])
        row[f"{part}_vs_plain"] = rr
        row[f"{part}_vs_tp1"] = logits_vs(kern[i], want[i])
    try:
        check_logits({p: row[f"{p}_vs_plain"] for p in ("prefill",
                                                        "decode")})
    except AssertionError as exc:
        raise AssertionError(f"{key} at tp {tp}: {exc}") from None
    row["within_4_spacings"] = all(
        row[f"{p}_vs_plain"]["err"] <= row[f"{p}_vs_plain"]["tol"]
        for p in ("prefill", "decode"))
    if cfg.num_experts:
        row["fault_vs_plain"] = logits_vs(probes["fault1"][0], plain[0])
        if cfg.num_experts // tp > 1:     # an offset within a rank's experts
            check(row["fault_vs_plain"]["err"] > row["fault_vs_plain"]["tol"],
                  f"{key}: the planted expert offset passed the logits "
                  f"bound")
        row["route_share_vs_tp1"] = route_share(kern[2], want[2])
        row["fault_route_share_vs_tp1"] = route_share(probes["fault1"][2],
                                                      want[2])
        check(row["route_share_vs_tp1"] >= TPF_ROUTE_SHARE_MIN,
              f"{key}: {row['route_share_vs_tp1']} of the top-6 choices "
              f"equal to tp 1's")
        check(row["fault_route_share_vs_tp1"] < TPF_ROUTE_SHARE_MIN,
              f"{key}: the planted expert offset passed the route-share "
              f"limit")
    row.update({k2: v for k2, v in r.items()},
               k1_launches=k["paged_attention"],
               k2_launches=k["flash_attention"], k4_launches=k["rwkv6_scan"])
    return row


def tpf_group_jobs(profile: bool) -> dict:
    """Group size -> ``[(label, cfg, job, job_args)]``: this phase's jobs
    over rank processes (``serve/ranks.serve_jobs``); ``profile``: trace
    each engine job's decode tick."""
    moe_cfg, rwkv_cfg = (all_archs()[a] for a in ("moonshot-v1-16b-a3b",
                                                  "rwkv6-7b"))
    wcfg = dataclasses.replace(all_archs()["whisper-base"], dtype="float32")
    wbatch = {k: v.cpu() for k, v in whisper_batch(wcfg).items()}
    return {
        2: [("rwkv6-7b", rwkv_cfg, tpf_job,
             (TPF_RWKV_ENGINE, TPF_RWKV_BURST, TPF_RWKV_ARMS, profile)),
            ("whisper-base", wcfg, tpf_greedy_job,
             (wbatch, TPF_WHISPER_STEPS, WHISPER_PROMPT + TPF_WHISPER_STEPS))],
        4: [("moonshot-v1-16b-a3b", moe_cfg, tpf_job,
             (TPF_MOE_ENGINE, TPF_MOE_BURST, TPF_MOE_ARMS, profile)),
            ("rwkv6-7b", rwkv_cfg, tpf_job,
             (TPF_RWKV_ENGINE, TPF_RWKV_BURST, TPF_RWKV_ARMS, profile))]
        + [(f"{a} f32 smoke", smoke_cfg(a), tp_smoke_job, (TPF_F32_SPEC,))
           for a in TPF_SMOKE_RANKED]}


def phase_serve_tp_families(card: str, hand: Handoff) -> dict:
    """Tensor-parallel serving of the other families over a ``model`` axis
    (full width, bf16 unless stated, seed 0): (a) K1, K2 and K4 at the
    ranks' local shapes, in a process of their own; (b) Moonlight-16B-A3B
    through the paged engine at tp 4 over 4 rank processes (16 experts a
    rank), a burst of 4, its logits against the plain arm and a planted
    fault on the same ranks and against tp 1's (serve_moe's), with the
    share of top-6 expert choices equal to tp 1's; (c) RWKV6-7B through
    the dense engine at tp 2 and 4 over ranks (K4 at 32 and 16 heads),
    held by serve_rwkv's rule; (d) InternVL2-26B at tp 4 emulated, run at
    serve_vlm's end on its weights; (e) Whisper-base in f32 at tp 2,
    emulated and over 2 ranks, 16 greedy steps equal to serve_encdec's;
    (f) the f32 smoke configs of every family at tp 1/2/4 (emulated; the
    engines' families over ranks too), streams and admission logs equal;
    (g) ``launch.serve --arch rwkv6-7b --tp-size 2 --devices 2``.  The
    launches are summed over every rank of every run's main path.  The
    tp-1 runs and InternVL2's come from the phases main() runs before this
    one (TPF_PROVIDERS, through ``hand``); this phase fails without
    them."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.dist import run_ranks
    from repro_torch.serve import ranks
    phase_start("serve_tp_families")
    t_step = time.perf_counter()

    def step_done(name, **kw):
        nonlocal t_step
        now = time.perf_counter()
        emit("serve_tp_families", step=name, seconds=now - t_step, **kw)
        t_step = now

    out = {"card": card, "kernels": hand.kernels or in_fresh_process(
        ("tpf_kernels",))["tpf_kernels"]}
    step_done("kernels", kernels=out["kernels"])
    out["cli"] = tpf_cli()
    step_done("cli", cli=out["cli"])
    launches = {"paged_attention": 0, "flash_attention": 0,
                "flash_attention_hd64": 0, "rwkv6_scan": 0}

    # (f) the f32 smoke configs, emulated: tp 1, 2, 4
    smoke_runs = {}
    for name in TPF_SMOKE_ENGINES:
        c = smoke_cfg(name)
        p = make_params(c, 0)
        for tp in (1, 2, 4):
            mesh = make_host_mesh(1, tp) if tp > 1 else None
            smoke_runs[(name, tp, "emulated")] = tp_smoke_job(mesh, c, p,
                                                              TPF_F32_SPEC)
    for name in TPF_SMOKE_REGISTRY:
        c = smoke_cfg(name)
        p = make_params(c, 0)
        rng = np.random.default_rng(14)
        batch = {"tokens": rng.integers(0, c.vocab_size, (2, 8)).astype(
            np.int32)}
        extra = {"encdec": "frames", "vlm": "patches"}[c.family]
        batch[extra] = rng.standard_normal((2, 16, c.d_model)).astype(
            np.float32)
        for tp in (1, 2, 4):
            mesh = make_host_mesh(1, tp) if tp > 1 else None
            sh = p if tp == 1 else sharding.shard_params(
                p, tp, range(tp), sharding.head_counts(c))
            smoke_runs[(name, tp, "emulated")] = rank_bodies.greedy(
                mesh, sh, c, batch, 8, 48)["streams"]
    step_done("f32_smoke_emulated")

    # (e) Whisper at tp 2 emulated, against serve_encdec's streams
    wcfg = dataclasses.replace(all_archs()["whisper-base"], dtype="float32")
    wbatch = whisper_batch(wcfg)
    wcache = WHISPER_PROMPT + TPF_WHISPER_STEPS
    wp = make_params(wcfg, 0)
    ops.reset_launch_counts()
    wrun = rank_bodies.greedy(
        make_host_mesh(1, TPF_WHISPER_TP), sharding.shard_params(
            wp, TPF_WHISPER_TP, range(TPF_WHISPER_TP),
            sharding.head_counts(wcfg)),
        wcfg, wbatch, TPF_WHISPER_STEPS, wcache)
    torch.cuda.synchronize()
    wrun["launches"] = ops.launch_counts()
    del wp
    runs = {"whisper-base_tp2_emulated": wrun}
    step_done("whisper_tp2_emulated")

    # over rank processes: one group of 2 and one of 4 (serve_tp's, where
    # that phase ran first)
    for n, fam in tpf_group_jobs(hand.profile).items():
        labels = [label for label, *_ in fam]
        if n in hand.groups:
            labels, res = hand.groups.pop(n)
        else:
            res = run_ranks(ranks.serve_jobs, n, backend="gloo", device=DEV,
                            args=([(c, ("seed", 0), job, args)
                                   for _, c, job, args in fam],))
            step_done(f"group_{n}", jobs=labels)
        for i, label in enumerate(labels):
            if label.endswith(" f32 smoke"):
                smoke_runs[(label[:-len(" f32 smoke")], n, "ranks")] = \
                    res[0][i]["result"]
                continue
            r = dict(res[0][i]["result"])
            r["launches_by_rank"] = [r["launches"]] + [
                res[k][i]["launches"] for k in range(1, n)]
            r["peak_memory_by_rank"] = [r["peak_memory_bytes"]] + [
                res[k][i]["peak_bytes"] for k in range(1, n)]
            r["exchanges_by_rank"] = [res[k][i]["exchanges"]
                                      for k in range(n)]
            runs[f"{label}_tp{n}_ranks"] = r

    # the checks, after every number is in
    summary = {}
    for key, r in runs.items():
        arch, tp = key.split("_tp")[0], int(key.split("_tp")[1][0])
        if arch == "whisper-base":
            by_rank = r.get("launches_by_rank", [r["launches"]])
            k2 = sum(x["flash_attention"] for x in by_rank)
            n_k2 = (wcfg.encoder_layers + wcfg.num_layers) * tp
            check(k2 == n_k2, f"{key}: K2 launches {k2} != {n_k2}")
            launches["flash_attention_hd64"] += k2
            want = hand.take_tp1("whisper-base", "serve_encdec")
            check([s[:TPF_WHISPER_STEPS + 1] for s in want]
                  == r["streams"], f"{key}: streams differ from tp 1's")
            row = {k: v for k, v in r.items() if k != "streams"}
            row.update(k2_launches=k2, streams_equal_tp1=True)
        else:
            row = tpf_check_run(key, all_archs()[arch], r, hand.take_tp1(
                arch, "serve_moe" if arch.startswith("moonshot")
                else "serve_rwkv"), tp)
            for name in ("paged_attention", "flash_attention", "rwkv6_scan"):
                launches[name] += sum(x[name] for x in r["launches_by_rank"])
        summary[key] = row
        emit("serve_tp_families", run=key, **row)
    check(bool(hand.vlm), "serve_tp_families: no InternVL2-26B tp-4 run "
                          "(phase serve_vlm gives it)")
    v = dict(hand.vlm)
    L = all_archs()["internvl2-26b"].num_layers
    k2 = v["launches"]["flash_attention"]
    check(k2 == L * TPF_VLM_TP, f"InternVL2 tp 4: K2 launches {k2}")
    launches["flash_attention"] += k2
    derived = registry.decode_exchanges(all_archs()["internvl2-26b"],
                                        TPF_VLM_TP)
    check(v["tick_collectives"] == derived,
          f"InternVL2 tp 4: tick exchanges {v['tick_collectives']}")
    try:
        check_logits(v["kernel_vs_plain"])
    except AssertionError as exc:
        raise AssertionError(f"InternVL2 tp 4: {exc}") from None
    summary["internvl2-26b_tp4_emulated"] = v
    emit("serve_tp_families", run="internvl2-26b_tp4_emulated", **v)
    for name in TPF_SMOKE_ENGINES + TPF_SMOKE_REGISTRY:
        base = smoke_runs[(name, 1, "emulated")]
        for (b, tp, how), r in smoke_runs.items():
            if b == name and tp > 1:
                check(r == base, f"f32 smoke {name} at tp {tp} ({how}): "
                                 f"streams or admissions differ from tp 1")
    out.update(runs=summary, f32_smoke_equal=sorted(
        f"{a}_tp{tp}_{how}" for a, tp, how in smoke_runs if tp > 1),
        launches=launches)
    emit("serve_tp_families", launches=launches,
         f32_smoke_equal=out["f32_smoke_equal"])
    phase_end()
    return out


# ---------------------------------------------------------------------------
# phases: train_f32_smoke, train (full width)
# ---------------------------------------------------------------------------

def expected_quant_launches(bucket_sizes, n: int, method: str):
    """(K3a, K3b) launches of one ``reduce_gradients`` under
    ``quant_impl="auto"``, derived from the bucket plan and the size rule:
    each call site quantizes every rank's rows in one launch, and takes
    the kernel when ONE rank's payload has at least PALLAS_QUANT_MIN_SIZE
    elements.  A rank's bucket of S elements is n chunks of c = ceil(S/n)."""
    def big(size):
        return int(size >= qk.PALLAS_QUANT_MIN_SIZE)
    k3a = k3b = 0
    for S in bucket_sizes:
        c = -(-S // n)
        if method == "int8_ring":
            # chunks; n-1 hops; the final gather (rows of 1 x c, n x c)
            k3a += big(n * c) + (n - 1) * big(c) + big(c)
            k3b += 2 * big(n * c) + (n - 1) * big(c) + big(n * c)
        elif method == "int8_a2a":
            # chunks and the partial sum; residual, received, gathered
            k3a += big(n * c) + big(c)
            k3b += 3 * big(n * c)
        else:
            raise ValueError(method)
    return k3a, k3b


def reduce_arms(grads, err, pods, method, by_leaf=False):
    """``reduce_gradients`` on the same per-pod gradients and residuals
    under ``quant_impl="auto"`` and ``"torch"`` (autograd's atomics differ
    from run to run, so both arms get the same inputs): every pod's
    reduced gradients and residuals bit-equal between the arms, and every
    pod holding the same reduced gradients.  ``by_leaf`` reduces one leaf
    at a time, which is the same computation when every leaf is a bucket
    of its own (full-width OLMo-1B); the kernel arm's outputs wait on the
    host while the plain arm runs.  Returns the kernel arm's reduced
    gradients of pod 0, its launch counts (summed), and the number of
    leaves."""
    g_leaves, e_leaves = bridge.flatten(grads), dict(bridge.flatten(err))
    parts = ([{path: g} for path, g in g_leaves] if by_leaf
             else [dict(g_leaves)])
    red0, total = {}, {}
    for part in parts:
        errs = {path: e_leaves[path] for path in part}
        with runtime.use_policy(quant_impl="auto"):
            ops.reset_launch_counts()
            red, res = collectives.reduce_gradients(part, pods, method, errs)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        kept = {}
        for path, r in red.items():
            check(all(torch.equal(r[i], r[0]) for i in range(1, pods.n)),
                  f"{path}: the pods' reduced gradients differ")
            red0[path] = r[0].clone()
            kept[path] = (r.cpu(), res[path].cpu())
        del red, res
        with runtime.use_policy(quant_impl="torch"):
            ops.reset_launch_counts()
            red, res = collectives.reduce_gradients(part, pods, method, errs)
            counts = ops.launch_counts()
        check(all(v == 0 for v in counts.values()),
              f"quant_impl='torch' launched a kernel: {counts}")
        for path, (r, e) in kept.items():
            check(torch.equal(red[path].cpu(), r),
                  f"{path}: reduced gradients, kernel arm vs plain")
            check(torch.equal(res[path].cpu(), e),
                  f"{path}: residuals, kernel arm vs plain")
        del red, res, kept
    return red0, total, len(red0)


def ring_bound_err(grads, err, red0, n: int) -> float:
    """The largest of |reduced - mean(g + e)| / bound over the leaves, the
    mean taken in float64.  Bound, with A the largest |g + e| of a leaf
    over the pods: the first quantization errs by at most A/254 an
    element, each of the n-1 hops by at most n*A/254 before the division
    by n, the final gather by A/254 — (n+1)*A/254 in all — and the bf16
    gradient by A/512."""
    worst = 0.0
    for (path, g), (_, e) in zip(bridge.flatten(grads), bridge.flatten(err)):
        A = max(float((g[i].float() + e[i].float()).abs().max())
                for i in range(n))
        mean = torch.zeros(g.shape[1:], dtype=torch.float64, device=g.device)
        for i in range(n):
            mean += g[i].double() + e[i].double()
        mean /= n
        diff = float((red0[path].double() - mean).abs().max())
        worst = max(worst, diff / (A * ((n + 1) / 254 + 1 / 512)))
        del mean
    return worst


CARD_VS_CPU = ("rwkv6-7b", "moonshot-v1-16b-a3b")
TOL_TRAIN_LOSS = 1e-5       # one step's f32 loss, summed in another order
#                             (tests/test_torch_train.py's one-step bound)


def card_vs_cpu_step(name: str) -> dict:
    """One stock train step of ``name``'s f32 smoke config on the card and
    on the CPU from the same parameters (drawn on the CPU) and batch: both
    losses finite and within TOL_TRAIN_LOSS.  RWKV-6 trains through the
    plain chunked scan, so no kernel launches."""
    cfg = dataclasses.replace(smoke(all_archs()[name]), dtype="float32")
    opts = tstep.TrainOptions(remat=True, opt=OptConfig(
        lr=1e-3, warmup_steps=2, decay_steps=10))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu = tstep.make_train_state(cfg, opts, gen)
    card = common.tree_map(lambda t: t.to(DEV, copy=True), cpu)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4), 0)
    step = tstep.make_train_step(cfg, None, 1, opts)
    ops.reset_launch_counts()
    _, m_card = step(card, {k: v.to(DEV) for k, v in batch.items()})
    launches = ops.launch_counts()
    _, m_cpu = step(cpu, batch)
    loss = {"card": float(m_card["loss"]), "cpu": float(m_cpu["loss"])}
    check(all(np.isfinite(v) for v in loss.values())
          and abs(loss["card"] - loss["cpu"]) < TOL_TRAIN_LOSS,
          f"{name} train step, card vs CPU: {loss}")
    check(sum(launches.values()) == 0, f"{name} training launched a "
                                       f"kernel: {launches}")
    return {**loss, "lb_loss": float(m_card["lb_loss"]),
            "z_loss": float(m_card["z_loss"])}


def phase_train_f32_smoke() -> dict:
    """Smoke-width OLMo in f32 on the card over 4 emulated pods,
    int8_a2a: one step's reduction in both arms, then the loop with a
    checkpoint every 2 steps and a fault injected at step 3, and a
    checkpoint restored onto the card."""
    cfg = dataclasses.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    pods = PodAxis(4)
    opts = tstep.TrainOptions(dp_method="int8_a2a", remat=True,
                              opt=OptConfig(lr=1e-3, warmup_steps=2,
                                            decay_steps=10))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, pods=pods)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    batch = {k: v.to(DEV) for k, v in synth_batch(dcfg, 0).items()}
    per = tstep._per_pod(cfg, opts, state["params"], batch, pods.n)
    _, counts, n_leaves = reduce_arms(per["grads"], state["err"], pods,
                                      "int8_a2a")
    plan = buckets.plan_buckets(
        [t.shape[1:] for t in common.tree_leaves(per["grads"])],
        [t.dtype for t in common.tree_leaves(per["grads"])])
    want = expected_quant_launches(plan.bucket_sizes(), pods.n, "int8_a2a")
    check((counts["quantize_int8"], counts["dequantize_int8"]) == want
          and min(want) > 0, f"smoke K3 launches {counts} != {want}")
    del per

    ckpt = _build.build_dir() / "train_f32_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=2, async_save=True)
    faults = {3}

    def fault_hook(s):
        if s in faults:
            faults.discard(s)
            raise RuntimeError("injected fault")

    logs = []
    step = tstep.make_train_step(cfg, None, pods, opts)
    state, hist = tloop.train_loop(
        step, state, dcfg, DEV, mgr,
        tloop.LoopConfig(total_steps=5, checkpoint_every=2, log_every=0,
                         max_restarts=1), fault_hook=fault_hook,
        log=logs.append)
    steps = [h["step"] for h in hist]
    check(steps == [0, 1, 2, 2, 3, 4], f"fault replay: steps {steps}")
    check(abs(hist[2]["loss"] - hist[3]["loss"]) < 1e-6,
          f"replayed step 2: {hist[2]['loss']} vs {hist[3]['loss']}")
    check(all(np.isfinite(h["loss"]) for h in hist), "smoke loss not finite")
    mgr.save(5, state)
    mgr.wait()
    back, at = mgr.restore(state, device=DEV)
    check(at == 5 and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        bridge.flatten(state), bridge.flatten(back))),
        "checkpoint round trip differs")
    check(all(t.device.type == DEV.type for _, t in bridge.flatten(back)),
          "restore did not land on the card")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {"method": "int8_a2a", "pods": pods.n, "leaves": n_leaves,
           "launches": counts, "steps": steps,
           "losses": [h["loss"] for h in hist],
           "fault_logged": any("FAILURE" in line for line in logs),
           "card_vs_cpu": {name: card_vs_cpu_step(name)
                           for name in CARD_VS_CPU}}
    emit("train_f32_smoke", **out)
    return out


TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 3
# rounds of the reduction's schedule arms, timed in turns inside steps
# (10 until train_mesh joined the script: cut for time)
SCHEDULE_ROUNDS = 3     # each arm first once
SCHEDULE_ARMS = ("serial", "one_stream", "side_stream")
OLMO_1B_PARAMS = 1_176_764_416


def step_breakdown(prof, top: int = 10) -> tuple:
    """(K3's device ms, all device ms, the ``top`` device rows by time) of
    a profiled step: device-side rows only (host op rows carry their
    kernels' time a second time)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    k3 = sum(ms for key, ms, _ in rows
             if any(k in key for k in ("absmax_kernel", "quant_kernel",
                                       "dequant_kernel")))
    return k3, sum(r[1] for r in rows), [
        {"name": key[:70], "ms": ms, "count": n} for key, ms, n in rows[:top]]


@contextlib.contextmanager
def one_stream_packs():
    """``run_schedule``'s pipelined order with every pack on the caller's
    stream, as before the packs took a side stream: ``overlap`` sees no
    CUDA tensor in a bucket and takes its one-stream branch."""
    real = overlap._cuda_device
    overlap._cuda_device = lambda obj: None
    try:
        yield
    finally:
        overlap._cuda_device = real


def pool_bytes() -> dict:
    """The caching allocator's reserved and allocated bytes by the stream
    whose pool holds them (``main``, a side stream's role, or the
    stream's handle), from ``torch.cuda.memory_snapshot()``."""
    names = {torch.cuda.current_stream().cuda_stream: "main"}
    names.update({st.cuda_stream: role
                  for (_, role), st in overlap._SIDE_STREAMS.items()})
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pool = out.setdefault(names.get(seg["stream"], str(seg["stream"])),
                              {"reserved": 0, "allocated": 0})
        pool["reserved"] += seg["total_size"]
        pool["allocated"] += seg["allocated_size"]
    return out


def phase_train(card: str) -> dict:
    """Full-width OLMo-1B (bf16, seed 0) over 4 emulated pods, int8_ring,
    4 MiB buckets (8), overlap auto (pipelined): TRAIN_STEPS steps of a
    4 x 1024-token global batch (one sequence a pod) through train_loop,
    checkpointing off; then a timed step, SCHEDULE_ROUNDS rounds of a
    step under each schedule arm (serial; pipelined with the packs on the
    caller's stream, ``one_stream_packs``; pipelined with the packs on
    the side stream) in rotating order, a profiled step, and the
    reduction of one more step's gradients in both quant arms."""
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    cfg = all_archs()["olmo-1b"]                  # published widths, bf16
    pods = PodAxis(TRAIN_PODS)
    opts = tstep.TrainOptions(dp_method="int8_ring", remat=False,
                              opt=OptConfig(lr=3e-4, warmup_steps=20,
                                            decay_steps=1000))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, pods=pods)
    leaves = common.tree_leaves(state["params"])
    n_params = sum(t.numel() for t in leaves)
    check(n_params == OLMO_1B_PARAMS, f"olmo-1b has {n_params} params")
    plan = buckets.plan_buckets([t.shape for t in leaves],
                                [t.dtype for t in leaves],
                                bucket_bytes=opts.dp_bucket_bytes)
    check(plan.n_buckets == 8 and not plan.passthrough,
          f"plan: {plan.bucket_sizes()} + {plan.passthrough}")
    pipelined = overlap.resolve_overlap(opts.dp_overlap, plan.n_buckets)
    k3a, k3b = expected_quant_launches(plan.bucket_sizes(), pods.n,
                                       opts.dp_method)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    step = tstep.make_train_step(cfg, None, pods, opts)
    mgr = CheckpointManager(str(_build.build_dir() / "train_ckpt"))

    ops.reset_launch_counts()
    state, hist = tloop.train_loop(
        step, state, dcfg, DEV, mgr,
        tloop.LoopConfig(total_steps=TRAIN_STEPS, checkpoint_every=0,
                         log_every=0), log=lambda *_: None)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(h["loss"])
                                           for h in hist),
          f"train losses: {[h['loss'] for h in hist]}")
    check(counts["quantize_int8"] == TRAIN_STEPS * k3a > 0
          and counts["dequantize_int8"] == TRAIN_STEPS * k3b > 0,
          f"K3 launches {counts} != {TRAIN_STEPS} x ({k3a}, {k3b})")
    check(counts["flash_attention"] == counts["paged_attention"]
          == counts["rwkv6_scan"] == 0, f"a serving kernel ran: {counts}")

    # a timed step: the reduction's share, host clock around synchronised
    # stages (what follows the reduction waits for it anyway)
    def batch_of(s):
        return {k: v.to(DEV) for k, v in synth_batch(dcfg, s).items()}

    red_s = []
    real = collectives.reduce_gradients

    def timed_reduce(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        red_s.append(time.perf_counter() - t0)
        return out

    batch = batch_of(TRAIN_STEPS)
    collectives.reduce_gradients = timed_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        timed_step_s = time.perf_counter() - t0
    finally:
        collectives.reduce_gradients = real
    # the reduction under each schedule arm, in turns (the order rotated
    # every round), inside a whole step: its wall, the caching
    # allocator's device allocations, frees and retries, and each
    # stream's pool after the step (the largest over the rounds)
    by_schedule = {arm: [] for arm in SCHEDULE_ARMS}
    allocator = {arm: {} for arm in SCHEDULE_ARMS}
    pools = {arm: {} for arm in SCHEDULE_ARMS}
    collectives.reduce_gradients = timed_reduce
    try:
        for k in range(SCHEDULE_ROUNDS):
            for j, arm in enumerate(SCHEDULE_ARMS[k % 3:]
                                    + SCHEDULE_ARMS[:k % 3]):
                batch = batch_of(TRAIN_STEPS + 3 + 3 * k + j)
                before = torch.cuda.memory_stats()
                sched = "serial" if arm == "serial" else "pipelined"
                with runtime.use_policy(overlap_schedule=sched), \
                        (one_stream_packs() if arm == "one_stream"
                         else contextlib.nullcontext()):
                    state, m = step(state, batch)
                    m["loss"].item()
                after = torch.cuda.memory_stats()
                by_schedule[arm].append(red_s[-1])
                for key in ("num_device_alloc", "num_device_free",
                            "num_alloc_retries"):
                    allocator[arm][key] = (allocator[arm].get(key, 0)
                                           + after.get(key, 0)
                                           - before.get(key, 0))
                for stream, pool in pool_bytes().items():
                    most = pools[arm].setdefault(stream, dict(pool))
                    for key, v in pool.items():
                        most[key] = max(most[key], v)
    finally:
        collectives.reduce_gradients = real
    spread = {arm: {"median": statistics.median(v), "min": min(v),
                    "max": max(v)} for arm, v in by_schedule.items()}
    reserved = torch.cuda.memory_reserved()
    batch = batch_of(TRAIN_STEPS + 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        profiled_step_s = time.perf_counter() - t0
    k3_ms, device_ms, top = step_breakdown(prof)
    del prof
    mem_steps = torch.cuda.memory_allocated()

    # the reduction of one more step's gradients in both arms, with the
    # residuals the steps left; the optimizer state is let go first
    params, err = state["params"], state["err"]
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    mem_check = torch.cuda.memory_allocated()
    emit("train_memory", peak_over_steps=peak, after_steps=mem_steps,
         before_check=mem_check)
    per = tstep._per_pod(cfg, opts, params, batch_of(TRAIN_STEPS + 2),
                         pods.n)
    grads = per.pop("grads")
    red0, arm_counts, n_leaves = reduce_arms(grads, err, pods,
                                             opts.dp_method, by_leaf=True)
    check((arm_counts["quantize_int8"], arm_counts["dequantize_int8"])
          == (k3a, k3b), f"check step's K3 launches {arm_counts}")
    bound_ratio = ring_bound_err(grads, err, red0, pods.n)
    check(bound_ratio <= 1.0, f"reduced gradients exceed the int8 bound: "
                              f"{bound_ratio} of it")
    del params, err, per, grads, red0
    gc.collect()
    torch.cuda.empty_cache()

    steady = [h["time_s"] for h in hist[1:]]
    step_s = statistics.mean(steady)
    out = {
        "card": card, "arch": cfg.name, "dtype": cfg.dtype,
        "n_params": n_params, "pods": pods.n, "method": opts.dp_method,
        "bucket_sizes": plan.bucket_sizes(),
        "schedule": "pipelined" if pipelined else "serial",
        "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "losses": [h["loss"] for h in hist],
        "step_s": [h["time_s"] for h in hist], "steady_step_s": step_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "timed_step_s": timed_step_s, "reduce_s": red_s[0],
        "reduce_share": red_s[0] / timed_step_s,
        "reduce_s_by_schedule": by_schedule,
        "reduce_s_spread": spread,
        "allocator_by_schedule": allocator,
        "pools_by_schedule": pools,
        "reserved_after_schedules": reserved,
        "k3_device_ms_per_step": k3_ms, "device_ms_per_step": device_ms,
        "profiled_step_s": profiled_step_s,
        "device_idle_share": 1 - device_ms / 1e3 / profiled_step_s,
        "top_device_items": top,
        "launches": counts, "k3_per_step": [k3a, k3b],
        "arms_bit_equal_leaves": n_leaves, "int8_bound_ratio": bound_ratio,
        "peak_memory_bytes": peak,
        "allocated_after_steps": mem_steps,
        "allocated_before_check": mem_check,
        "check_peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("train", **out)
    return out


# ---------------------------------------------------------------------------
# phase: train_ranks (the pod axis over torch.distributed, one process a rank)
# ---------------------------------------------------------------------------

RANKS = 4                   # rank processes on the one card, over gloo
RANK_SEED = 1000            # rank r draws its gradients from RANK_SEED + r
RANK_STEPS = 2               # (3 until train_mesh joined the script): the
#                             second step consumes the first's int8_ring
#                             error-feedback residual
RANK_SCHEDULE_ROUNDS = 1    # timed steps a schedule, in turns, after those
#                             (2 until train_mesh joined the script)
RANK_SWEEP_LAYERS = 2       # part (a)'s reduce_gradients sweep runs on the
#                             leaves of OLMo-1B's published widths cut to
#                             this depth (every leaf still its own bucket,
#                             at 1/8 of the bytes): cut for time, the
#                             script's budget after train_mesh
SCHEDULED = ("int8_a2a", "int8_ring", "ring")   # a schedule applies to
TOL_RANK_LOSS = 1e-3        # a rank's loss after its first step against
#                             the emulated step's: both start from the same
#                             parameters and rows, but each backward sums
#                             with atomics in an order of its own, and a
#                             last-bit gradient difference can move an int8
#                             rounding; the first step's losses must be
#                             bit-equal (the forward is the same computation)
DEGRADED_DURATION = 0.1     # fabric.collectives_degraded's window (its
#                             preset 0.3 until train_mesh joined the
#                             script, 0.15 until NeMo's tp-4 burst came
#                             back: cut for time)
DEGRADED_KEYS = {"condition", "method", "devices", "n_buckets",
                 "bucket_elems", "compute_dim", "compute_iters", "t_serial_s",
                 "t_overlapped_s", "injected_common_s", "paired_rounds",
                 "max_error", "wire_bytes_per_device"}   # the reference's
GUARD_KEYS = ("wall_clean_s", "wall_straggler_s", "wall_ratio_canonical",
              "straggler_delay_s", "wall_scaled_s", "wall_ratio")


def sync(device) -> None:
    """Wait for ``device`` when it is a card (a rank rehearsed on the CPU
    has none)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def leaf_inputs(cfg, device):
    """Every rank's gradients and error-feedback residuals at the shapes
    of ``cfg``'s parameters, bf16 as the train step's, one leaf at a
    time: ``(path, g (RANKS, *shape), e (RANKS, *shape))``.  Rank r draws
    from seed RANK_SEED + r, a leaf's g then its e, as
    :func:`rank_inputs` does."""
    gens = []
    for r in range(RANKS):
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(RANK_SEED + r)
    for path, shape in bridge.param_shapes(cfg).items():
        g, e = [], []
        for gen in gens:
            g.append((torch.randn(shape, generator=gen, device=device)
                      * 1e-2).bfloat16())
            e.append((torch.randn(shape, generator=gen, device=device)
                      * 1e-4).bfloat16())
        yield path, torch.stack(g), torch.stack(e)


def rank_inputs(cfg, device, rank: int):
    """Rank ``rank``'s rows of :func:`leaf_inputs`, ``{path: (1,
    *shape)}``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(RANK_SEED + rank)
    g, e = {}, {}
    for path, shape in bridge.param_shapes(cfg).items():
        g[path] = (torch.randn((1,) + shape, generator=gen, device=device)
                   * 1e-2).bfloat16()
        e[path] = (torch.randn((1,) + shape, generator=gen, device=device)
                   * 1e-4).bfloat16()
    return g, e


def emulated_digests(cfg) -> dict:
    """The emulated ``PodAxis(RANKS)`` reduction of the same inputs on
    the card, one leaf at a time (every leaf of full-width OLMo-1B is a
    bucket of its own, so that is the whole tree's computation): for
    every method but stock, each rank's ``(digest of its output, of its
    residual)`` by leaf."""
    pods = PodAxis(RANKS)
    want = {m: {} for m in collectives.METHODS if m != "stock"}
    for path, g, e in leaf_inputs(cfg, DEV):
        for m in want:
            red, res = collectives.reduce_gradients({path: g}, pods, m,
                                                    {path: e})
            want[m][path] = [(rank_bodies.digest(red[path][r]),
                              rank_bodies.digest(res[path][r]))
                             for r in range(RANKS)]
            del red, res
        del g, e
    return want


def stock_spacings(cfg, got: dict) -> float:
    """The largest |got - emulated pmean| in bf16 spacings of the
    emulated value, over the leaves: the emulated sum is f32 over the
    ranks in one order, gloo's in another, each rounded once to bf16."""
    worst = 0.0
    for path, g, _ in leaf_inputs(cfg, next(iter(got.values())).device):
        want = PodAxis(RANKS).pmean(g)[0].float()
        spacing = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))) - 7)
        worst = max(worst, float(((got[path][0].float() - want).abs()
                                  / spacing).max()))
        del g, want, spacing
    return worst


def ranks_collectives(pods, cfg, want: dict, bucket_bytes: int) -> dict:
    """Part (a), in each rank: ``reduce_gradients`` of this rank's inputs
    over every method, at both schedules where a schedule applies: the
    wall (from a barrier), K3's launches, the bytes staged through host
    memory, and the outputs and residuals against the emulated
    reduction's digests (stock: rank 0 against the emulated pmean, every
    rank's output digested)."""
    gc.collect()
    torch.cuda.empty_cache()
    g, e = rank_inputs(cfg, pods.device, pods.rank)
    plan = buckets.plan_buckets([t.shape[1:] for t in g.values()],
                                [t.dtype for t in g.values()],
                                bucket_bytes=bucket_bytes)
    out = {"wall_s": {}, "staged_bytes": {}, "k3": {}, "k3_expected": {},
           "mismatched": [], "stock_digests": None, "stock_spacings": None}
    for method in collectives.METHODS:
        arms = (("serial", False), ("pipelined", True)) \
            if method in SCHEDULED else (("none", None),)
        for sched, ov in arms:
            key = f"{method}/{sched}"
            pods.barrier()
            sync(pods.device)
            ops.reset_launch_counts()
            staged = pods.staged_bytes
            t0 = time.perf_counter()
            red, res = collectives.reduce_gradients(
                dict(g), pods, method, dict(e), bucket_bytes=bucket_bytes,
                overlap=ov)
            sync(pods.device)
            out["wall_s"][key] = time.perf_counter() - t0
            out["staged_bytes"][key] = pods.staged_bytes - staged
            counts = ops.launch_counts()
            out["k3"][key] = [counts["quantize_int8"],
                              counts["dequantize_int8"]]
            out["k3_expected"][key] = list(
                expected_quant_launches(plan.bucket_sizes(), pods.n, method)
                if method in ("int8_a2a", "int8_ring") else (0, 0))
            if method == "stock":
                out["stock_digests"] = [rank_bodies.digest(red[p][0])
                                        for p in red]
                if pods.rank == 0:
                    out["stock_spacings"] = stock_spacings(cfg, red)
            else:
                for p in red:
                    got = (rank_bodies.digest(red[p][0]),
                           rank_bodies.digest(res[p][0]))
                    if got != tuple(want[method][p][pods.rank]):
                        out["mismatched"].append(f"{key}:{p}")
            del red, res
    return out


def ranks_train(pods, cfg, opts, steps: int, seq: int, batch: int,
                rounds: int) -> dict:
    """Part (b), in each rank: ``steps`` train steps over the rank group
    from the parameters of seed 0 (K3's launches counted over exactly
    those steps: the main path), every step's ``loss_per_pod``, wall and
    parameter digests, then ``rounds`` steps under each schedule in turns
    with the reduction timed inside; the rank's peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    pods.barrier()                  # every rank has let part (a) go
    dev = pods.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, pods=pods)
    step = tstep.make_train_step(cfg, None, pods, opts)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)

    def batch_of(s):
        return {k: v.to(dev) for k, v in synth_batch(dcfg, s).items()}

    losses, digests, step_s = [], [], []
    ops.reset_launch_counts()
    for s in range(steps):
        b = batch_of(s)
        pods.barrier()
        sync(pods.device)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss_per_pod"].float().cpu().tolist())
        sync(pods.device)
        step_s.append(time.perf_counter() - t0)
        digests.append([rank_bodies.digest(p) for p in
                        common.tree_leaves(state["params"])])
        torch.cuda.empty_cache()    # the ranks share the card: give back
        #                             what this rank's cache holds free
    counts = ops.launch_counts()
    red_s = []
    # the bucket chains are timed around ``_reduce_bucketed``: its leaf
    # lists are emptied as the buckets pack, so a wrapper holding them
    # (unlike one holding ``reduce_gradients``' trees) keeps no gradient
    # alive past its pack
    real = collectives._reduce_bucketed

    def timed_reduce(*a, **kw):
        sync(pods.device)
        t0 = time.perf_counter()
        out = real(*a, **kw)
        sync(pods.device)
        red_s.append(time.perf_counter() - t0)
        return out

    by_schedule = {"serial": [], "pipelined": []}
    collectives._reduce_bucketed = timed_reduce
    try:
        for k in range(rounds):
            order = ("serial", "pipelined") if k % 2 == 0 \
                else ("pipelined", "serial")
            for j, sched in enumerate(order):
                b = batch_of(steps + 2 * k + j)
                pods.barrier()
                sync(pods.device)
                t0 = time.perf_counter()
                with runtime.use_policy(overlap_schedule=sched):
                    state, m = step(state, b)
                    m["loss"].item()
                wall = time.perf_counter() - t0
                torch.cuda.empty_cache()
                by_schedule[sched].append({"step_s": wall,
                                           "reduce_s": red_s[-1],
                                           "share": red_s[-1] / wall})
    finally:
        collectives._reduce_bucketed = real
    return {"losses": losses, "digests": digests, "step_s": step_s,
            "launches": counts, "by_schedule": by_schedule,
            "staged_bytes": pods.staged_bytes,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)
            if dev.type == "cuda" else None}


def nccl_one_rank(pods) -> dict:
    """Part (e), in a group of one over nccl: ``reduce_gradients`` of a
    small tree through the ``DistPodAxis`` and through ``PodAxis(1)``,
    every method, bit for bit."""
    gen = torch.Generator(device=pods.device)
    gen.manual_seed(7)
    tree = {"a": torch.randn((1, 64, 1024), generator=gen,
                             device=pods.device),
            "b": torch.randn((1, 300), generator=gen, device=pods.device)}
    err = {k: v * 1e-2 for k, v in tree.items()}
    equal = {}
    for m in collectives.METHODS:
        got = collectives.reduce_gradients(dict(tree), pods, m, dict(err),
                                           bucket_bytes=1 << 16)
        want = collectives.reduce_gradients(dict(tree), PodAxis(1), m,
                                            dict(err), bucket_bytes=1 << 16)
        equal[m] = all(torch.equal(got[0][k], want[0][k]) for k in tree) \
            and (m == "stock" or all(torch.equal(got[1][k], want[1][k])
                                     for k in tree))
    return {"equal": equal, "exchanges": dict(pods.exchanges),
            "staged_bytes": pods.staged_bytes}


def _nccl_same_card(rank: int, path: str, results) -> None:
    """Two nccl ranks on card 0, past the port's check: what NCCL says."""
    import torch.distributed as tdist
    try:
        torch.cuda.set_device(0)
        tdist.init_process_group("nccl", store=tdist.FileStore(path, 2),
                                 rank=rank, world_size=2)
        t = torch.ones(4, device="cuda")
        tdist.all_reduce(t)
        torch.cuda.synchronize()
        results.put((rank, "no error"))
    except Exception as exc:                    # what NCCL refuses with
        results.put((rank, f"{type(exc).__name__}: {exc}"))


def nccl_same_card() -> list:
    """NCCL's own answer to two ranks on one card (each rank's error)."""
    import multiprocessing as mp
    import queue
    import tempfile
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nccl_same_card_")
    procs = [ctx.Process(target=_nccl_same_card, daemon=True,
                         args=(r, os.path.join(tmp, "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    said = []
    try:
        for _ in procs:
            said.append(results.get(timeout=180))
    except queue.Empty:
        said.append((None, "no answer within 180 s"))
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return sorted(said, key=lambda x: (x[0] is None, x[0]))


def burn_check() -> dict:
    """The burn kernel against its plain loop (the sink's f32 value bit
    for bit, the launch counted) and its rate on the card."""
    launches = kburn.LAUNCHES
    got = kburn.burn(1000, DEV)
    sync(DEV)
    want = kburn.burn_torch(1000)
    check(torch.equal(got.cpu(), want), f"burn {got.item()} != "
                                        f"{want.item()}")
    check(kburn.LAUNCHES == launches + 1, "the burn launch not counted")
    rate = fabric_inject.iters_per_second(DEV, force=True)
    return {"sink": got.item(), "iters_per_s": rate}


def phase_train_ranks(card: str) -> dict:
    """The ``pod`` axis over ``torch.distributed``: RANKS rank processes
    on the one card, exchanging over gloo through pinned host memory
    (NCCL refuses two ranks on one device).  (a) ``reduce_gradients``
    at full-width OLMo-1B's leaves over every method and schedule against
    the emulated ``PodAxis(RANKS)``; (b) the main path, full-width
    OLMo-1B trained RANK_STEPS steps over the ranks (int8_ring, 4-MiB
    buckets, a 1024-token sequence a rank, AdamW with bf16 moments)
    against the emulated step; (c) the degraded-fabric guard on the burn
    kernel, then ``fabric.collectives_degraded`` at its presets; (d) the
    three collective stressors; (e) a group of one over nccl against
    ``PodAxis(1)``, the port's refusal of nccl past the cards, and
    NCCL's own answer to two ranks on one card."""
    from repro_torch.core import fabric as core_fabric
    from repro_torch.core import stressors
    from repro_torch.parallel.dist import check_group, run_ranks
    phase_start("train_ranks")
    cfg = all_archs()["olmo-1b"]                  # published widths, bf16
    opts = tstep.TrainOptions(dp_method="int8_ring", remat=False,
                              opt=OptConfig(lr=3e-4, warmup_steps=20,
                                            decay_steps=1000,
                                            state_dtype="bfloat16"))
    shapes = list(bridge.param_shapes(cfg).values())
    plan = buckets.plan_buckets(shapes, [torch.bfloat16] * len(shapes),
                                bucket_bytes=opts.dp_bucket_bytes)
    check(plan.n_buckets == len(shapes) and not plan.passthrough,
          f"every leaf a bucket: {plan.bucket_sizes()}")
    k3a, k3b = expected_quant_launches(plan.bucket_sizes(), RANKS,
                                       opts.dp_method)
    out = {"card": card, "ranks": RANKS, "backend": "gloo"}

    # the emulated references, computed first and copied to the host
    t0 = time.perf_counter()
    sweep = dataclasses.replace(cfg, num_layers=RANK_SWEEP_LAYERS)
    want = emulated_digests(sweep)
    emu = rank_bodies.train_steps(PodAxis(RANKS), cfg, opts, RANK_STEPS,
                                  TRAIN_SEQ, RANKS, 0, device=DEV)
    emu_s = time.perf_counter() - t0
    phase_end()
    check(torch.cuda.memory_allocated() <= START_BYTES,
          "the emulated references left memory allocated")

    # (a), (b) and the guard of (c) in one group.  Four ranks of
    # full-width OLMo-1B peak at ~17 GB each on a card of 79 GiB: their
    # caching allocators map memory in expandable segments, so that freed
    # blocks are not stranded in fragments (the ranks inherit this)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        res = run_ranks(rank_bodies.in_turn, RANKS, backend="gloo",
                        device=DEV,
                        args=([(ranks_collectives,
                                (sweep, want, opts.dp_bucket_bytes)),
                               (ranks_train, (cfg, opts, RANK_STEPS,
                                              TRAIN_SEQ, RANKS,
                                              RANK_SCHEDULE_ROUNDS)),
                               (rank_bodies.fabric_guard, ())],))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    group_s = time.perf_counter() - t0
    coll = [r[0] for r in res]
    for r, c in enumerate(coll):
        check(not c["mismatched"], f"rank {r}: outputs or residuals differ "
                                   f"from the emulated axis: "
                                   f"{c['mismatched'][:4]}")
        check(c["stock_digests"] == coll[0]["stock_digests"],
              f"rank {r}: stock pmean differs from rank 0's")
        check(c["k3"] == c["k3_expected"], f"rank {r}: K3 {c['k3']} != "
                                           f"{c['k3_expected']}")
    check(coll[0]["stock_spacings"] <= 1.0,
          f"stock pmean {coll[0]['stock_spacings']} bf16 spacings off")
    emit("train_ranks_collectives", layers=RANK_SWEEP_LAYERS,
         method_schedules=list(coll[0]["wall_s"]),
         wall_s={r: c["wall_s"] for r, c in enumerate(coll)},
         staged_bytes=coll[0]["staged_bytes"], k3_per_rank=coll[0]["k3"],
         stock_bf16_spacings=coll[0]["stock_spacings"],
         emulated_s=emu_s, bucket_sizes=plan.bucket_sizes())

    runs = [r[1] for r in res]
    for r, run in enumerate(runs):
        check(run["digests"] == runs[0]["digests"],
              f"rank {r}: parameters differ from rank 0's after a step")
        check(run["losses"] == runs[0]["losses"],
              f"rank {r}: gathered losses differ from rank 0's")
        check((run["launches"]["quantize_int8"],
               run["launches"]["dequantize_int8"])
              == (RANK_STEPS * k3a, RANK_STEPS * k3b),
              f"rank {r}: K3 {run['launches']} != {RANK_STEPS} x "
              f"({k3a}, {k3b})")
        check(all(run["launches"][k] == 0 for k in
                  ("flash_attention", "paged_attention", "rwkv6_scan")),
              f"a serving kernel ran: {run['launches']}")
    got, emu_l = np.array(runs[0]["losses"]), np.array(emu["losses"])
    check(np.isfinite(got).all(), f"losses {got}")
    check((got[0] == emu_l[0]).all(), f"step 1: {got[0]} != emulated "
                                      f"{emu_l[0]}")
    loss_diff = float(np.abs(got - emu_l).max())
    check(loss_diff <= TOL_RANK_LOSS, f"losses {got} vs emulated {emu_l}")
    launches = {k: sum(run["launches"][k] for run in runs)
                for k in runs[0]["launches"]}
    emit("train_ranks_main", arch=cfg.name, steps=RANK_STEPS,
         losses=runs[0]["losses"], emulated_losses=emu["losses"],
         loss_max_diff=loss_diff,
         params_equal_emulated=[d == e for d, e in
                                zip(runs[0]["digests"], emu["digests"])],
         step_s={r: run["step_s"] for r, run in enumerate(runs)},
         by_schedule={r: run["by_schedule"] for r, run in enumerate(runs)},
         peak_memory_bytes=[run["peak_memory_bytes"] for run in runs],
         peak_reserved_bytes=[run["peak_reserved_bytes"] for run in runs],
         staged_bytes=[run["staged_bytes"] for run in runs],
         k3_per_rank=[(run["launches"]["quantize_int8"],
                       run["launches"]["dequantize_int8"]) for run in runs],
         k3_per_step=[k3a, k3b], group_s=group_s)

    # (c) the degraded-fabric guard (the reference's four parts) and the
    # family at its presets
    guard = [r[2] for r in res]
    launches0 = kburn.LAUNCHES
    emu_guard = rank_bodies.fabric_guard(PodAxis(RANKS), device=DEV)
    emu_launches = kburn.LAUNCHES - launches0
    burn = burn_check()
    t0 = time.perf_counter()
    degraded = core_fabric.measure_collectives_degraded(
        duration=DEGRADED_DURATION, device=DEV)
    degraded_s = time.perf_counter() - t0
    emit("train_ranks_fabric", burn=burn,
         guard={r: {k: gd[k] for k in GUARD_KEYS + ("straggler_launches",
                                                     "counts")}
                for r, gd in enumerate(guard)},
         emulated_guard={k: emu_guard[k] for k in GUARD_KEYS},
         emulated_burn_launches=emu_launches,
         degraded={f"{r.name}/{r.metric}": r.value for r in degraded},
         degraded_t_serial_s={r.name: r.params["t_serial_s"]
                              for r in degraded
                              if r.metric == "degradation_x"},
         degraded_s=degraded_s)
    strag = canonical_conditions()["straggler"].straggler_device
    for r, gd in enumerate(guard):
        check(gd["clean_identical"] and gd["clean_counts_equal"]
              and gd["clean_burns"] == 0, f"rank {r}: clean guard {gd}")
        check(gd["straggler_identical"] and gd["straggler_counts_equal"],
              f"rank {r}: straggler guard {gd}")
        check((gd["straggler_launches"] > 0) == (r == strag),
              f"rank {r}: burn launches {gd['straggler_launches']}")
        check(gd["wall_ratio"] > 3.0, f"rank {r}: straggler wall ratio "
                                      f"{gd['wall_ratio']}")
        check(gd["single_bucket_ok"], f"rank {r}: single bucket {gd}")
    check(emu_guard["clean_identical"] and emu_guard["straggler_identical"]
          and emu_guard["single_bucket_ok"] and emu_guard["clean_burns"] == 0
          and emu_guard["wall_ratio"] > 3.0 and emu_launches > 0,
          f"emulated guard {emu_guard}")
    check(len(degraded) == 24 and not any(r.error or r.skipped
                                          for r in degraded),
          f"collectives_degraded rows {len(degraded)}")
    for r in degraded:
        check(DEGRADED_KEYS <= set(r.params) and r.params["devices"] == RANKS,
              f"{r.name} {r.metric}: keys {sorted(r.params)}")

    # (d) the collective stressors over the ranks
    t0 = time.perf_counter()
    recs = stressors.run_suite(duration=OFFLOAD_SHORT["stressors.suite"],
                               names=sorted(NETWORK_STRESSORS), device=DEV,
                               devices=RANKS)
    check(len(recs) == 3 and not any(r.skipped for r in recs),
          f"collective stressors: {[(r.name, r.reason) for r in recs]}")
    emit("train_ranks_stressors", ops_per_s={r.name: r.value for r in recs},
         median_s={r.name: r.params["median_s"] for r in recs},
         seconds=time.perf_counter() - t0)

    # (e) nccl: a group of one, the port's refusal, NCCL's own answer
    one = run_ranks(nccl_one_rank, 1, backend="nccl", device=DEV)[0]
    check(all(one["equal"].values()), f"nccl group of one: {one}")
    try:
        check_group(RANKS, "nccl", DEV)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    check(refused is not None and "NCCL refuses" in refused,
          f"nccl over {RANKS} ranks on one card: {refused}")
    said = nccl_same_card()
    check(all("Duplicate GPU" in s for _, s in said),
          f"NCCL on two ranks of one card: {said}")
    emit("train_ranks_nccl", one_rank=one, port_refusal=refused,
         nccl_says=said)
    phase_end()
    out.update(launches=launches, k3_per_step=[k3a, k3b])
    return out


# ---------------------------------------------------------------------------
# phase: train_mesh (a data axis, the model axis in training, sequence
# parallelism, the pod axis above a mesh, the pipeline)
# ---------------------------------------------------------------------------

MESH = ((2, 2), ("data", "model"))
POD_MESH = ((2, 2), ("pod", "model"))
MESH_BATCH, MESH_SEQ = 4, 1024      # the train phase's 4 x 1024 tokens
# (MESH_STEPS 3 until serve_tp_families joined the script, 2 until the
# moe and ssm families' arms did)
MESH_STEPS, SP_STEPS, POD_STEPS = 1, 1, 1
MESH_OPT = OptConfig(lr=3e-4, warmup_steps=20, decay_steps=1000,
                     state_dtype="bfloat16")    # train_ranks' optimizer
# the emulated (2, 2) mesh's first step against the one-device step on the
# same card: both are bf16 through 16 layers, but the mesh's matmuls have
# other shapes (half the heads and FFN columns, half the rows) and its
# row-parallel outputs add two bf16-rounded partials.  Measured on an H100
# (deterministic, equal in every run): loss 1.30e-5 and grad norm 4.07e-5
# relative.  The limits sit ~15x above those and below what other rows
# give: the loss of the mesh's next steps' batches differs by 4.2e-4 to
# 1.3e-3 relative, their grad norm by 1.5e-2 to 3.9e-2
TOL_MESH_LOSS_REL, TOL_MESH_GNORM_REL = 2e-4, 5e-4
PIPE = dict(stages=4, d=2048, rows=256, n_micro=8)
TOL_PIPE_OUT, TOL_PIPE_GRAD = 1e-5, 1e-4        # the reference test's
# the moe and ssm families over the model axis (train_mesh (g), (h)): the
# published widths, the depth cut to the layers kept here (one of
# Moonlight's groups of 2; RWKV-6's groups are single layers) so that the
# arms fit the script's time; each rank's state, the 4 ranks sharing the
# card, fits it at 4 layers too (PERF.md §4)
FAM_LAYERS = {"moonshot-v1-16b-a3b": 2, "rwkv6-7b": 2}
# (FAM_STEPS and TP9F_STEPS 2 until arm (l) joined the script)
FAM_STEPS, FAM_RANKED_STEPS, FAM_POD_STEPS = 1, 1, 1
FAM_POD_ARCH = "moonshot-v1-16b-a3b"    # (pod 2, model 2) under int8_ring
# the CLI's runs at the smoke width on (data 2, model 2): OLMo emulated,
# Moonlight over 4 ranks (OLMo's run over ranks until the families' arms
# joined the script: the same path through run_ranks, a process group's
# start-up a run, ~15 s on an H100's host; (b) trains OLMo over ranks),
# RWKV-6 emulated
FAM_CLI = (("emulated", []),
           ("moe_ranked", ["--arch", "moonshot-v1-16b-a3b", "--devices",
                           "4"]),
           ("ssm_emulated", ["--arch", "rwkv6-7b"]))
# the hybrid, encdec and vlm families over the model axis (train_mesh (i),
# (j), (k)): InternVL2-26B at published width, its depth cut to the layers
# kept here as FAM_LAYERS cuts (g)'s, 768 text tokens a row after its 256
# patches (serve_vlm's prefill: the training attention's chunks, as the
# reference's, take a sequence of at most 1024 or a multiple of 512, and
# 256 + 1024 is neither); Whisper-base whole (6 + 6 layers, 1024 tokens;
# synth_batch gives the encoder as many frames as the decoder has
# tokens); name -> (layers kept (None: all), tokens a row)
TP9F_ARCHS = {"internvl2-26b": (2, 768), "whisper-base": (None, MESH_SEQ)}
TP9F_STEPS, TP9F_RANKED_STEPS = 1, 1
# Jamba's training state at published width does not fit the card its 4
# ranks share (one group of 8 layers is 44.7 B parameters): (k) trains
# the reference's smoke config (no attention layer) and the one with an
# attention layer in each group of 4 (JAMBA_ATTN), bf16, on (data 2,
# model 2) stock and the smoke config on (pod 2, model 2) with int8_ring,
# 4 rows of JAMBA_SEQ tokens (the CPU tests' 32), one step each: the Mamba
# scan steps the positions in turn, so an emulated step took 10.8 s at
# 256 tokens (3.3 s with attention; 2 steps at 256 until the whole
# script's time was counted)
JAMBA_ARMS = {"jamba": {}, "jamba_attn": JAMBA_ATTN}
JAMBA_SEQ = 32
JAMBA_STEPS, JAMBA_RANKED_STEPS, JAMBA_POD_STEPS = 1, 1, 1


def mesh_opts(method="stock", sp=False) -> tstep.TrainOptions:
    return tstep.TrainOptions(dp_method=method, remat=False,
                              sequence_parallel=sp, opt=MESH_OPT)


MESH_DIR = os.path.join(ROOT, "build", "train_mesh")


def mesh_run(pods, shape, axes, cfg, opts, steps: int, keep: str = "",
             device=None, want=None, keep_at=None, seq: int = MESH_SEQ,
             host: bool = True) -> dict:
    """``steps`` train steps of ``cfg`` on the mesh ``shape`` over
    ``axes`` — over the rank group of ``pods``, emulated where it is
    ``None`` — from the parameters of seed 0, on the global batch of
    MESH_BATCH rows of ``seq`` tokens (with an encoder-decoder's frames or
    a VLM's patches, ``for_arch``): each step's loss, every pod's, aux
    losses, gradient norm, seconds and seconds inside the collectives,
    the exchanges and bytes staged a step by axis, K3's launches over the
    steps, peak memory, and (``keep``, a name) a digest of every held
    rank's shard of each leaf after step ``keep_at`` (default: the last),
    with the shards in a file under MESH_DIR (emulated, unless ``host`` is
    false: a run held bit-equal needs the digests only) or, in a rank
    process, the
    shards whose digests differ from ``want``'s (the emulated run's) in a
    file under MESH_DIR named by ``keep`` (a pipe would carry them at a
    small share of a file's rate).  Also the process's peak resident
    host memory so far (``host_peak_bytes``), its resident memory at the
    run's end (``host_rss_bytes``) and the run's peak of pinned
    staging buffers (``pinned_peak_bytes``; the pinned cache is emptied
    first): the ranks' staging and the emulated runs' host shards share
    the machine's memory."""
    from repro_torch.launch.mesh import make_mesh
    t_start = time.perf_counter()
    dev = torch.device(device or pods.device)
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()     # earlier runs' pinned staging
        torch.cuda.reset_peak_host_memory_stats()
    if pods is not None:
        pods.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(shape, axes, ranks=pods)
    axes_of = {"model": getattr(mesh.axis, "pods", mesh.axis),
               "data": mesh.data}
    if mesh.pod is not None:
        axes_of["pod"] = mesh.pod
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, mesh)
    step = tstep.make_train_step(cfg, None, mesh, opts)
    dcfg = for_arch(cfg, seq, MESH_BATCH)

    def snap():
        return {k: (dict(getattr(a, "exchanges", {})),
                    getattr(a, "staged_bytes", 0), getattr(a, "wire_s", 0.0))
                for k, a in axes_of.items()}
    out = {"loss": [], "loss_per_pod": [], "lb_loss": [], "z_loss": [],
           "grad_norm": [], "step_s": [], "wire_s": [],
           "setup_s": time.perf_counter() - t_start}

    def snapshot():
        tree = tstep.mesh_layout(cfg, mesh)[1]
        shards, out["digests"] = {}, {}
        for d, dr in enumerate(tree.held["data"]):
            for j, mr in enumerate(tree.held["model"]):
                leaves = {path: t[min(d, t.shape[0] - 1),
                                  min(j, t.shape[1] - 1)]
                          for path, t in bridge.flatten(state["params"])}
                out["digests"][dr, mr] = {
                    path: rank_bodies.digest(t) for path, t in leaves.items()}
                shards[dr, mr] = {
                    path: t.cpu() for path, t in leaves.items()
                    if (pods is not None or host) and (
                        want is None or want[dr, mr][path]
                        != out["digests"][dr, mr][path])}
        if pods is None:
            if host:
                # on disk, not in this process: the ranks' pinned staging
                # shares the machine's memory with it (PERF.md §7)
                os.makedirs(MESH_DIR, exist_ok=True)
                out["shards_file"] = os.path.join(MESH_DIR,
                                                  f"{keep}_emulated.pt")
                torch.save(shards, out["shards_file"])
        elif any(shards.values()):
            os.makedirs(MESH_DIR, exist_ok=True)
            out["shards_file"] = os.path.join(
                MESH_DIR, f"{keep}_rank{pods.rank}.pt")
            torch.save(shards, out["shards_file"])
    ops.reset_launch_counts()
    before = snap()
    for s in range(steps):
        batch = {k: v.to(dev) for k, v in synth_batch(dcfg, s).items()}
        if pods is not None:
            pods.barrier()
        sync(dev)
        w0 = snap()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        out["loss"].append(float(m["loss"]))
        sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        w1 = snap()
        out["wire_s"].append(sum(w1[k][2] - w0[k][2] for k in w1))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lb_loss"].append(float(m["lb_loss"]))
        out["z_loss"].append(float(m["z_loss"]))
        if "loss_per_pod" in m:
            out["loss_per_pod"].append(m["loss_per_pod"].float().cpu()
                                       .tolist())
        torch.cuda.empty_cache()    # ranks share the card
        if keep and s + 1 == (keep_at or steps):
            snapshot()          # digests only: no kernel of the path
    counts = ops.launch_counts()
    after = snap()
    out["launches"] = {k: counts[k] for k in ("quantize_int8",
                                              "dequantize_int8",
                                              "flash_attention",
                                              "paged_attention",
                                              "rwkv6_scan")}
    out["exchanges_per_step"] = {
        k: {kind: (n - before[k][0].get(kind, 0)) / steps
            for kind, n in after[k][0].items()
            if n - before[k][0].get(kind, 0)} for k in after}
    out["staged_per_step"] = {k: (after[k][1] - before[k][1]) / steps
                              for k in after}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["host_peak_bytes"] = 1024 * resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    with open("/proc/self/statm") as f:
        out["host_rss_bytes"] = int(f.read().split()[1]) \
            * os.sysconf("SC_PAGE_SIZE")
    out["pinned_peak_bytes"] = torch.cuda.host_memory_stats().get(
        "allocated_bytes.peak", 0) if hasattr(torch._C, "_host_emptyCache") \
        else 0
    out["tokens_per_s"] = [MESH_BATCH * seq / t for t in out["step_s"]]
    out["wire_share"] = [w / t for w, t in zip(out["wire_s"],
                                               out["step_s"])] \
        if pods is not None else None
    del state, step
    out["body_s"] = time.perf_counter() - t_start
    return out


def timed_body(pods, fn, args) -> tuple:
    """``fn(pods, *args)`` and its seconds, in a rank."""
    t0 = time.perf_counter()
    return fn(pods, *args), time.perf_counter() - t0


def spacing_diff(runs: list, emu: dict) -> float:
    """The largest difference, in bf16 spacings of the emulated value,
    between the ranks' shards (``mesh_run`` results with ``keep``) and
    the emulated mesh's: 0 where every digest agrees, else measured on
    the card on the leaves whose digests differ, from the rank's file and
    the emulated run's (both removed after)."""
    worst = 0.0
    emu_path = emu.pop("shards_file")
    emu_shards = None
    for run in runs:
        path = run.pop("shards_file", None)
        differ = [(key, leaf) for key, dg in run["digests"].items()
                  for leaf, v in dg.items() if v != emu["digests"][key][leaf]]
        if differ:
            saved = torch.load(path)
            if emu_shards is None:
                emu_shards = torch.load(emu_path)
            for key, leaf in differ:
                t = saved[key][leaf].to(DEV).float()
                w = emu_shards[key][leaf].to(DEV).float()
                sp = torch.exp2(torch.floor(torch.log2(
                    w.abs().clamp_min(2.0 ** -126))) - 7)
                worst = max(worst, float(((t - w).abs() / sp).max()))
            del saved
            os.remove(path)
    os.remove(emu_path)
    return worst


def differing_shards(runs: list, emu: dict) -> list:
    """The (rank, leaf) pairs whose shard digest in the ranks' runs
    (``mesh_run`` results with ``keep``) differs from the emulated run's;
    the ranks' files of such shards removed."""
    out = []
    for run in runs:
        path = run.pop("shards_file", None)
        out += [(key, leaf) for key, dg in run["digests"].items()
                for leaf, v in dg.items() if v != emu["digests"][key][leaf]]
        if path:
            os.remove(path)
    return out


def pipeline_inputs():
    rng = np.random.default_rng(11)
    n, d = PIPE["stages"], PIPE["d"]
    ws = (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32)
    mbs = rng.standard_normal((PIPE["n_micro"], PIPE["rows"], d)).astype(
        np.float32)
    return ws, mbs, np.zeros_like(mbs)


def pipeline_body(pods) -> dict:
    """``rank_bodies.pipeline_run`` on :func:`pipeline_inputs`, drawn in
    the rank (64 MB of weights a rank would cross a pipe slowly)."""
    return rank_bodies.pipeline_run(pods, *pipeline_inputs())


def pipeline_sequential(ws, mbs, tgt):
    w = torch.tensor(ws, device=DEV, requires_grad=True)
    x = torch.tensor(mbs, device=DEV)
    for s in range(ws.shape[0]):
        x = torch.tanh(x @ w[s])
    loss = torch.mean((x - torch.tensor(tgt, device=DEV)) ** 2)
    g, = torch.autograd.grad(loss, w)
    return x.detach().cpu().numpy(), g.cpu().numpy()


def local_bucket_sizes(cfg, shape, axes, bucket_bytes) -> list:
    """The bucket sizes one ``(data, model)`` rank packs its local
    gradient shards into, a class of leaves at a time
    (``train/step.reduction_classes``)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, axes)
    sizes = {"data": mesh.dp_size, "model": mesh.tp_size}
    specs = common.tree_leaves(bridge.mesh_specs(cfg, mesh))
    out = []
    for ks in tstep.reduction_classes(specs):
        local = [specs[k].local(sizes) for k in ks]
        out += buckets.plan_buckets(local, [torch.bfloat16] * len(local),
                                    bucket_bytes=bucket_bytes).bucket_sizes()
    return out


def mesh_summary(run: dict) -> dict:
    return {k: run[k] for k in ("loss", "loss_per_pod", "lb_loss", "z_loss",
                                "grad_norm", "setup_s", "body_s",
                                "step_s", "tokens_per_s", "wire_s",
                                "wire_share", "exchanges_per_step",
                                "staged_per_step", "peak_memory_bytes",
                                "host_peak_bytes", "host_rss_bytes",
                                "pinned_peak_bytes", "launches")}


def quant_at_buckets(sizes) -> None:
    """K3a and K3b against their plain versions at the shapes an int8_ring
    reduction over POD_MESH's pods gives a rank's buckets of ``sizes``
    elements: the n chunks and one chunk of each."""
    n = POD_MESH[0][0]
    for S in sorted(set(sizes)):
        c = -(-S // n)
        for rows in (n, 1):
            gen = torch.Generator(device=DEV)
            gen.manual_seed(S + rows)
            quant_equal(torch.randn((rows, c), generator=gen, device=DEV))


def family_arm(phase: str, name: str, cfg, emu: dict, runs: list,
               seq: int = MESH_SEQ, sp: bool = False,
               plain: float = None) -> None:
    """A family trained on (data 2, model 2), emulated (``emu``) and over
    4 ranks (``runs``, ``mesh_run`` results), held: every run's losses,
    aux losses and gradient norm finite (an MoE's aux losses above zero),
    the model axis's exchanges a step those ``train_exchanges`` derives
    (over ranks one all-reduce more, the gradient norm's; emulated, each
    held data rank's), every rank's losses equal, and the ranked mesh
    bit-equal to the emulated one after its steps (losses and every
    shard); ``sp``: the runs are sequence parallel, and their first
    emulated loss is held within TOL_MESH_LOSS_REL of ``plain``, the
    family's first emulated loss without it.  One JSON line ``phase``."""
    from repro_torch.models.transformer import train_exchanges
    derived = train_exchanges(cfg, MESH[0][1], sequence_parallel=sp,
                              remat=False)
    got = emu["exchanges_per_step"]["model"]
    check(got == {k: float(MESH[0][0] * v) for k, v in derived.items()},
          f"{name} emulated: model exchanges {got} != {MESH[0][0]} x "
          f"{derived}")
    want = dict(derived, all_reduce=derived["all_reduce"] + 1)
    moe = bool(cfg.num_experts)
    for r, run in enumerate([emu] + runs):
        check(all(np.isfinite(run[k]).all() for k in
                  ("loss", "lb_loss", "z_loss", "grad_norm")),
              f"{name} run {r}: {mesh_summary(run)}")
        check(not moe or min(run["lb_loss"] + run["z_loss"]) > 0,
              f"{name} run {r}: aux losses {run['lb_loss']} "
              f"{run['z_loss']}")
    keys = ("loss", "lb_loss", "z_loss")
    for r, run in enumerate(runs):
        got = run["exchanges_per_step"]["model"]
        check(got == {k: float(v) for k, v in want.items()},
              f"{name} rank {r}: model exchanges {got} != {want}")
        check([run[k] for k in keys] == [runs[0][k] for k in keys],
              f"{name} rank {r}: losses differ")
    check([runs[0][k][0] for k in keys] == [emu[k][0] for k in keys],
          f"{name} ranked step 1 {runs[0]['loss']} != emulated "
          f"{emu['loss']}")
    differ = differing_shards(runs, emu)
    check(not differ, f"{name} ranked vs emulated: shards differ {differ}")
    extra = {}
    if plain is not None:
        extra = dict(plain_loss=plain,
                     loss_rel_to_plain=abs(emu["loss"][0] - plain) / plain)
        check(extra["loss_rel_to_plain"] <= TOL_MESH_LOSS_REL,
              f"{name} sequence parallel step 1 loss {emu['loss'][0]} vs "
              f"{plain} without it")
    emit(phase, arch=name, layers=cfg.num_layers, seq=seq,
         params=sum(int(np.prod(v)) for v in
                    bridge.param_shapes(cfg).values()),
         mesh=dict(zip(MESH[1], MESH[0])), sequence_parallel=sp,
         derived_model_exchanges=want, differing_shards=len(differ),
         **extra, emulated=mesh_summary(emu),
         per_rank=[mesh_summary(run) for run in runs])


def pod_family_arm(phase: str, name: str, cfg, emu: dict, runs: list,
                   sizes: list, k3: tuple, steps: int) -> None:
    """A family on (pod 2, model 2) with int8_ring, emulated (``emu``)
    and over 4 ranks (``runs``), held: K3a/K3b in every rank at ``k3`` a
    step (derived from its local buckets of ``sizes``), twice that
    emulated, every rank's pod losses equal, finite metrics, and the
    ranked mesh bit-equal to the emulated one; one JSON line ``phase``."""
    for r, run in enumerate(runs):
        check((run["launches"]["quantize_int8"],
               run["launches"]["dequantize_int8"])
              == (steps * k3[0], steps * k3[1]),
              f"{name} rank {r}: K3 {run['launches']} != {steps} x {k3}")
        check(run["loss_per_pod"] == runs[0]["loss_per_pod"],
              f"{name} rank {r}: pod losses differ")
        check(all(np.isfinite(run[k]).all() for k in
                  ("loss", "lb_loss", "z_loss", "grad_norm")),
              f"{name} (pod, model) rank {r}: {mesh_summary(run)}")
    check(runs[0]["loss_per_pod"][0] == emu["loss_per_pod"][0],
          f"{name} (pod, model) step 1 {runs[0]['loss_per_pod'][0]} != "
          f"emulated {emu['loss_per_pod'][0]}")
    differ = differing_shards(runs, emu)
    check(not differ, f"{name} (pod, model): shards differ from the "
                      f"emulated {differ}")
    m = POD_MESH[0][1]
    check((emu["launches"]["quantize_int8"],
           emu["launches"]["dequantize_int8"])
          == (steps * m * k3[0], steps * m * k3[1]),
          f"{name} emulated K3 {emu['launches']}")
    emit(phase, arch=name, layers=cfg.num_layers,
         mesh=dict(zip(POD_MESH[1], POD_MESH[0])),
         local_bucket_sizes=sizes, k3_per_rank_step=list(k3),
         differing_shards=len(differ), emulated=mesh_summary(emu),
         per_rank=[mesh_summary(run) for run in runs])


def phase_train_mesh(card: str) -> dict:
    """Mesh training at full-width OLMo-1B (bf16, AdamW with bf16
    moments, 4 x 1024 tokens a step): (a) the emulated (data 2, model 2)
    mesh, ``MESH_STEPS`` steps, its first against the one-device step, and
    the f32 smoke OLMo at (2, 2) against (1, 1); (b) the same mesh over 4 rank
    processes (gloo through pinned host memory) against (a); (c)
    ``sequence_parallel`` on the ranked mesh, its exchanges against
    ``transformer.train_exchanges``; (d) (pod 2, model 2) with int8_ring
    over 4 ranks against its emulated form, K3a/K3b in every rank at the
    count derived from its local buckets and bit-equal to their plain
    versions there; (e) ``parallel/pipeline.py`` at 4 stages of d 2048, 8
    microbatches, emulated and over 4 ranks, against the stages composed;
    (f) ``launch.train --smoke --data-mesh 2 --model-mesh 2``, OLMo's and
    RWKV-6's emulated and Moonlight's with ``--devices 4``; (g)
    Moonlight-16B-A3B and RWKV6-7B at published width, depth cut
    (``FAM_LAYERS``), on (data 2, model 2): one step emulated and over
    4 ranks, bit-equal to the emulated mesh, the model
    axis's exchanges against ``train_exchanges``, the aux losses finite;
    (h) Moonlight on (pod 2, model 2) with int8_ring over
    4 ranks against its emulated form, K3a/K3b as in (d); (i)
    InternVL2-26B at published width, depth cut (``TP9F_ARCHS``), and (j)
    Whisper-base whole, as (g); (k) Jamba at the smoke width
    (``JAMBA_ARMS``: without and with an attention layer) as (g), and on
    (pod 2, model 2) with int8_ring as (h); (l) the configs of (g), (i)
    and (k) with ``sequence_parallel``, one step emulated and one over 4
    ranks, as (g), each first loss against its family's emulated one
    without it."""
    import tempfile

    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import train_exchanges
    from repro_torch.parallel.dist import run_ranks
    from repro_torch.parallel.pods import PodAxis as Pod
    phase_start("train_mesh")
    cfg = all_archs()["olmo-1b"]
    out = {"card": card}

    # (a) the emulated mesh, and the one-device first step beside it
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    opts = mesh_opts()
    state = tstep.make_train_state(cfg, opts, gen, 1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_SEQ,
                      global_batch=MESH_BATCH)
    state, m = tstep.make_train_step(cfg, None, 1, opts)(
        state, {k: v.to(DEV) for k, v in synth_batch(dcfg, 0).items()})
    one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    del state, m
    phase_end()
    emu = mesh_run(None, *MESH, cfg, opts, MESH_STEPS, "mesh", DEV)
    phase_end()
    loss_rel = abs(emu["loss"][0] - one["loss"]) / one["loss"]
    gn_rel = abs(emu["grad_norm"][0] - one["grad_norm"]) / one["grad_norm"]
    check(np.isfinite(emu["loss"]).all(), f"mesh losses {emu['loss']}")
    check(loss_rel <= TOL_MESH_LOSS_REL, f"(2,2) loss {emu['loss'][0]} vs "
          f"one device {one['loss']}")
    check(gn_rel <= TOL_MESH_GNORM_REL, f"(2,2) grad norm "
          f"{emu['grad_norm'][0]} vs one device {one['grad_norm']}")
    import dataclasses as dc
    small = dc.replace(smoke(all_archs()["olmo-1b"]), dtype="float32")
    f32 = {}
    for name, shape in (("1x1", (1, 1)), ("2x2", (2, 2))):
        g = torch.Generator(device=DEV)
        g.manual_seed(0)
        o = tstep.TrainOptions(remat=False, opt=OptConfig(
            lr=1e-3, warmup_steps=2, decay_steps=10))
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(*shape) if shape != (1, 1) else 1
        st = tstep.make_train_state(small, o, g, mesh)
        st, mm = tstep.make_train_step(small, None, mesh, o)(st, {
            k: v.to(DEV) for k, v in synth_batch(DataConfig(
                vocab_size=small.vocab_size, seq_len=32, global_batch=8),
                0).items()})
        f32[name] = (float(mm["loss"]), float(mm["grad_norm"]))
    check(abs(f32["2x2"][0] - f32["1x1"][0]) < TOL_TRAIN_LOSS
          and abs(f32["2x2"][1] - f32["1x1"][1]) <= 1e-5 * f32["1x1"][1],
          f"f32 smoke (2,2) {f32['2x2']} vs (1,1) {f32['1x1']}")
    emit("train_mesh_emulated", arch=cfg.name, mesh=dict(zip(MESH[1],
                                                             MESH[0])),
         one_device=one, loss_rel=loss_rel, grad_norm_rel=gn_rel,
         f32_smoke=f32, **mesh_summary(emu))

    # (d) emulated first, then (b), (c), (d), (e) in one group of ranks
    pod_opts = mesh_opts("int8_ring")
    pod_emu = mesh_run(None, *POD_MESH, cfg, pod_opts, POD_STEPS, "pods",
                       DEV)
    phase_end()
    sizes = local_bucket_sizes(cfg, *POD_MESH, pod_opts.dp_bucket_bytes)
    k3a, k3b = expected_quant_launches(sizes, POD_MESH[0][0], "int8_ring")
    quant_at_buckets(sizes)
    # (g), (h): the moe and ssm families, emulated first; the ranked mesh
    # is held to the emulated one after its first step
    fam = {a: dataclasses.replace(all_archs()[a], num_layers=n)
           for a, n in FAM_LAYERS.items()}
    fam_emu = {}
    for a, c in fam.items():
        fam_emu[a] = mesh_run(None, *MESH, c, opts, FAM_STEPS, f"fam_{a}",
                              DEV, keep_at=FAM_RANKED_STEPS, host=False)
        phase_end()
    fam_pod_cfg = fam[FAM_POD_ARCH]
    fam_pod_emu = mesh_run(None, *POD_MESH, fam_pod_cfg, pod_opts,
                           FAM_POD_STEPS, "fam_pods", DEV, host=False)
    phase_end()
    fam_sizes = local_bucket_sizes(fam_pod_cfg, *POD_MESH,
                                   pod_opts.dp_bucket_bytes)
    fk3a, fk3b = expected_quant_launches(fam_sizes, POD_MESH[0][0],
                                         "int8_ring")
    quant_at_buckets(set(fam_sizes) - set(sizes))
    # (i), (j), (k): the hybrid, encdec and vlm families, emulated first
    tp9f = {a: dataclasses.replace(all_archs()[a], **(
        {"num_layers": n} if n else {})) for a, (n, _) in TP9F_ARCHS.items()}
    tp9f_emu = {}
    for a, c in tp9f.items():
        tp9f_emu[a] = mesh_run(None, *MESH, c, opts, TP9F_STEPS,
                               f"tp9f_{a}", DEV, keep_at=TP9F_RANKED_STEPS,
                               seq=TP9F_ARCHS[a][1], host=False)
        phase_end()
    jamba = {k: dataclasses.replace(
        smoke(all_archs()["jamba-1.5-large-398b"]), **v)
        for k, v in JAMBA_ARMS.items()}
    jamba_emu = {}
    for k, c in jamba.items():
        jamba_emu[k] = mesh_run(None, *MESH, c, opts, JAMBA_STEPS,
                                f"jamba_{k}", DEV,
                                keep_at=JAMBA_RANKED_STEPS, seq=JAMBA_SEQ,
                                host=False)
        phase_end()
    jpod_cfg = jamba["jamba"]
    jpod_emu = mesh_run(None, *POD_MESH, jpod_cfg, pod_opts,
                        JAMBA_POD_STEPS, "jamba_pods", DEV, seq=JAMBA_SEQ,
                        host=False)
    phase_end()
    # (l): the five families with sequence parallelism, FAM_STEPS each,
    # emulated first: name -> (config, tokens a row, the emulated run
    # without it)
    sp_fam = {**{a: (c, MESH_SEQ, fam_emu[a]) for a, c in fam.items()},
              **{a: (c, TP9F_ARCHS[a][1], tp9f_emu[a])
                 for a, c in tp9f.items()},
              **{f"jamba-1.5-large-398b smoke ({k})":
                 (c, JAMBA_SEQ, jamba_emu[k]) for k, c in jamba.items()}}
    sp_opts = mesh_opts(sp=True)
    sp_emu = {}
    for a, (c, seq, _) in sp_fam.items():
        sp_emu[a] = mesh_run(None, *MESH, c, sp_opts, FAM_STEPS,
                             f"sp_{len(sp_emu)}", DEV, seq=seq, host=False)
        phase_end()
    jsizes = local_bucket_sizes(jpod_cfg, *POD_MESH,
                                pod_opts.dp_bucket_bytes)
    jk3a, jk3b = expected_quant_launches(jsizes, POD_MESH[0][0],
                                         "int8_ring")
    quant_at_buckets(set(jsizes) - set(sizes) - set(fam_sizes))
    ws, mbs, tgt = pipeline_inputs()
    seq_out, seq_grad = pipeline_sequential(ws, mbs, tgt)
    pipe_emu = rank_bodies.pipeline_run(Pod(PIPE["stages"]), ws, mbs, tgt)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        res = run_ranks(rank_bodies.in_turn, RANKS, backend="gloo",
                        device=DEV, args=([
                            (mesh_run, (*MESH, cfg, opts, MESH_STEPS,
                                        "mesh", None, emu["digests"])),
                            (mesh_run, (*MESH, cfg, mesh_opts(sp=True),
                                        SP_STEPS)),
                            (mesh_run, (*POD_MESH, cfg, pod_opts, POD_STEPS,
                                        "pods", None, pod_emu["digests"])),
                            (timed_body, (pipeline_body, ())),
                            *[(mesh_run, (*MESH, c, opts, FAM_RANKED_STEPS,
                                          f"fam_{a}", None,
                                          fam_emu[a]["digests"]))
                              for a, c in fam.items()],
                            (mesh_run, (*POD_MESH, fam_pod_cfg, pod_opts,
                                        FAM_POD_STEPS, "fam_pods", None,
                                        fam_pod_emu["digests"])),
                            *[(mesh_run, (*MESH, c, opts, TP9F_RANKED_STEPS,
                                          f"tp9f_{a}", None,
                                          tp9f_emu[a]["digests"], None,
                                          TP9F_ARCHS[a][1]))
                              for a, c in tp9f.items()],
                            *[(mesh_run, (*MESH, c, opts, JAMBA_RANKED_STEPS,
                                          f"jamba_{k}", None,
                                          jamba_emu[k]["digests"], None,
                                          JAMBA_SEQ))
                              for k, c in jamba.items()],
                            (mesh_run, (*POD_MESH, jpod_cfg, pod_opts,
                                        JAMBA_POD_STEPS, "jamba_pods", None,
                                        jpod_emu["digests"], None,
                                        JAMBA_SEQ)),
                            *[(mesh_run, (*MESH, c, sp_opts, FAM_STEPS,
                                          f"sp_{i}", None,
                                          sp_emu[a]["digests"], None, seq))
                              for i, (a, (c, seq, _))
                              in enumerate(sp_fam.items())]],))
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    group_s = time.perf_counter() - t0

    # (b) the ranked mesh against the emulated one
    ranked = [r[0] for r in res]
    for r, run in enumerate(ranked):
        check(run["loss"] == ranked[0]["loss"], f"rank {r}: losses differ")
    check(ranked[0]["loss"][0] == emu["loss"][0],
          f"ranked step 1 {ranked[0]['loss'][0]} != emulated {emu['loss'][0]}")
    loss_sp = max(abs(a - b) / float(bf16_spacing(torch.tensor(b)))
                  for a, b in zip(ranked[0]["loss"], emu["loss"]))
    param_sp = spacing_diff(ranked, emu)
    check(loss_sp <= 1.0 and param_sp <= 1.0,
          f"ranked vs emulated: losses {loss_sp}, parameters {param_sp} "
          f"bf16 spacings")
    emit("train_mesh_ranked", ranks=RANKS, backend="gloo",
         loss_bf16_spacings=loss_sp, param_bf16_spacings=param_sp,
         emulated_losses=emu["loss"], group_s=group_s,
         per_rank=[mesh_summary(run) for run in ranked])

    # (c) sequence parallelism: exchanges a step against the derived count
    sp_runs = [r[1] for r in res]
    derived = {}
    for sp, runs in ((False, ranked), (True, sp_runs)):
        want = train_exchanges(cfg, MESH[0][1], sequence_parallel=sp,
                               remat=False)
        want["all_reduce"] = want.get("all_reduce", 0) + 1  # the norm
        derived[sp] = want
        for r, run in enumerate(runs):
            got = run["exchanges_per_step"]["model"]
            check(got == {k: float(v) for k, v in want.items()},
                  f"rank {r} sp={sp}: model exchanges {got} != {want}")
    check(all(np.isfinite(r["loss"]).all() for r in sp_runs),
          f"sp losses {[r['loss'] for r in sp_runs]}")
    sp_rel = abs(sp_runs[0]["loss"][0] - emu["loss"][0]) / emu["loss"][0]
    check(sp_rel <= TOL_MESH_LOSS_REL, f"sp step 1 loss "
          f"{sp_runs[0]['loss'][0]} vs {emu['loss'][0]} without it")
    emit("train_mesh_sp", loss_rel_to_plain=sp_rel,
         derived_model_exchanges=derived[True],
         derived_without_sp=derived[False],
         staged_per_step_sp=[r["staged_per_step"] for r in sp_runs],
         staged_per_step=[r["staged_per_step"] for r in ranked],
         per_rank=[mesh_summary(run) for run in sp_runs])

    # (d) the pod axis above the mesh
    pod_runs = [r[2] for r in res]
    for r, run in enumerate(pod_runs):
        check((run["launches"]["quantize_int8"],
               run["launches"]["dequantize_int8"])
              == (POD_STEPS * k3a, POD_STEPS * k3b),
              f"rank {r}: K3 {run['launches']} != {POD_STEPS} x "
              f"({k3a}, {k3b})")
        check(run["loss_per_pod"] == pod_runs[0]["loss_per_pod"],
              f"rank {r}: pod losses differ")
    check(pod_runs[0]["loss_per_pod"][0] == pod_emu["loss_per_pod"][0],
          f"(pod, model) step 1 {pod_runs[0]['loss_per_pod'][0]} != "
          f"emulated {pod_emu['loss_per_pod'][0]}")
    pod_sp = spacing_diff(pod_runs, pod_emu)      # equal on every pod
    check(pod_sp <= 1.0, f"(pod, model) parameters {pod_sp} bf16 spacings "
                         f"from the emulated")
    check((pod_emu["launches"]["quantize_int8"],
           pod_emu["launches"]["dequantize_int8"])
          == (POD_STEPS * POD_MESH[0][1] * k3a,
              POD_STEPS * POD_MESH[0][1] * k3b),
          f"emulated K3 {pod_emu['launches']}")
    emit("train_mesh_pods", mesh=dict(zip(POD_MESH[1], POD_MESH[0])),
         local_bucket_sizes=sizes, k3_per_rank_step=[k3a, k3b],
         param_bf16_spacings=pod_sp, emulated=mesh_summary(pod_emu),
         per_rank=[mesh_summary(run) for run in pod_runs])

    # (e) the pipeline
    pipe = {"emulated": pipe_emu,
            "ranked": {k: np.concatenate([r[3][0][k] for r in res])
                       for k in ("out", "grad", "loss")}}
    errs = {}
    for form, got in pipe.items():
        errs[form] = (float(np.abs(got["out"] - seq_out[None]).max()),
                      float(np.abs(got["grad"] - seq_grad).max()))
        check(errs[form][0] <= TOL_PIPE_OUT and errs[form][1] <= TOL_PIPE_GRAD,
              f"pipeline {form}: out/grad errors {errs[form]}")
    emit("train_mesh_pipeline", **PIPE, errors=errs,
         ranked_s=[r[3][1] for r in res])

    # (g) the moe and ssm families on (data 2, model 2): the ranked mesh
    # bit-equal to the emulated one, the model axis's exchanges a step
    # those train_exchanges derives
    for i, (a, c) in enumerate(fam.items()):
        family_arm("train_mesh_families", a, c, fam_emu[a],
                   [r[4 + i] for r in res])

    # (h) Moonlight on (pod 2, model 2) with int8_ring, as (d)
    fam_pod_runs = [r[4 + len(fam)] for r in res]
    pod_family_arm("train_mesh_families_pods", FAM_POD_ARCH, fam_pod_cfg,
                   fam_pod_emu, fam_pod_runs, fam_sizes, (fk3a, fk3b),
                   FAM_POD_STEPS)

    # (i), (j) InternVL2-26B and Whisper-base, (k) Jamba at the smoke
    # width, as (g) and (h)
    at = 5 + len(fam)
    for i, (a, c) in enumerate(tp9f.items()):
        family_arm("train_mesh_tp9f", a, c, tp9f_emu[a],
                   [r[at + i] for r in res], seq=TP9F_ARCHS[a][1])
    at += len(tp9f)
    for i, (k, c) in enumerate(jamba.items()):
        family_arm("train_mesh_tp9f", f"jamba-1.5-large-398b smoke ({k})",
                   c, jamba_emu[k], [r[at + i] for r in res],
                   seq=JAMBA_SEQ)
    jpod_runs = [r[at + len(jamba)] for r in res]
    pod_family_arm("train_mesh_tp9f_pods", "jamba-1.5-large-398b smoke",
                   jpod_cfg, jpod_emu, jpod_runs, jsizes, (jk3a, jk3b),
                   JAMBA_POD_STEPS)

    # (l) sequence parallelism on the five families, as (g), each held to
    # its family's first emulated loss without it
    at += len(jamba) + 1
    for i, (a, (c, seq, plain)) in enumerate(sp_fam.items()):
        family_arm("train_mesh_sp_families", a, c, sp_emu[a],
                   [r[at + i] for r in res], seq=seq, sp=True,
                   plain=plain["loss"][0])
    del res, pipe

    # (f) the CLI, emulated and over ranks; the moe and ssm families too
    cli = {}
    for name, extra in FAM_CLI:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            hist = launch_train.main(
                ["--smoke", "--steps", "3", "--batch", "4", "--seq", "64",
                 "--data-mesh", "2", "--model-mesh", "2", "--ckpt-every",
                 "2", "--ckpt-dir", d] + extra, device=DEV)
            cli[name] = {"losses": [h["loss"] for h in hist],
                         "seconds": time.perf_counter() - t0}
        check(len(hist) == 3 and np.isfinite(cli[name]["losses"]).all(),
              f"CLI {name}: {cli[name]}")
    emit("train_mesh_cli", **cli)
    phase_end()
    launches = {k: sum(run["launches"][k] for run in
                       [pod_emu, fam_pod_emu, jpod_emu] + pod_runs
                       + fam_pod_runs + jpod_runs)
                for k in pod_emu["launches"]}
    out.update(launches=launches, k3_per_rank_step=[k3a, k3b],
               k3_families_per_rank_step=[fk3a, fk3b],
               k3_jamba_per_rank_step=[jk3a, jk3b])
    return out


# ---------------------------------------------------------------------------
# phase: offload_families (the paper's offload characterization)
# ---------------------------------------------------------------------------

# each run's window (s): 1 s, shorter where the phase would otherwise
# outgrow the script's time budget — the stressor battery (both families
# run all of it, each stressor timed beside its numpy reference; at
# 0.25 s the slowest, jit-compile at ~12 compiles/s on an H100, still
# times 3 calls), each point of the card-size sweeps, and (0.5 s since
# serve_tp_families joined the script; 1 s until then) the two transfer
# families, the in-path collectives and bucketing and the overlap step, at
# the presets and at the card's size.  The delay sweep keeps 1 s: its
# burst-absorbed reading holds only there
OFFLOAD_DURATION = 1.0
OFFLOAD_SHORT = {"stressors.suite": 0.25, "classes.aggregate": 0.25,
                 "card.transfer": 0.5, "card.delay_sweep": 0.5,
                 "headroom.transfer_nic": 0.5, "headroom.transfer_host": 0.5,
                 "inpath.collectives": 0.5, "inpath.bucketing": 0.5,
                 "card.inpath": 0.5, "inpath.headroom_overlap": 0.5,
                 "card.headroom_overlap": 0.5}
OFFLOAD_FAMILIES = ("headroom.transfer_nic", "headroom.transfer_host",
                    "headroom.delay_sweep", "stressors.suite",
                    "classes.aggregate", "inpath.collectives",
                    "inpath.bucketing", "inpath.headroom_overlap")
NETWORK_STRESSORS = {"allreduce", "all-to-all", "allreduce-int8"}
PODS = 4
# the card's sizes: messages 4 KiB ... 256 MiB (x16 apart) over 1-8
# workers; the delay sweep's 256-MiB burst beside f32 matmuls up to 8192;
# one OLMo-1B attention-projection gradient bucket a pod (2048 x 2048 x 16
# layers = 1 << 26 elements, K3's (4, 67,108,864) shape); the train
# phase's 8 buckets beside OLMo-1B's d_model
CARD_MESSAGES = tuple(4096 << (4 * i) for i in range(5))
CARD_WORKERS = (1, 2, 4, 8)
CARD_DELAY_BYTES = 256 << 20
CARD_MATMULS = (256, 512, 1024, 2048, 4096, 8192)
CARD_INPATH_SIZE = 1 << 26
CARD_OVERLAP = dict(n_buckets=8, bucket_elems=1 << 26, compute_dim=2048,
                    compute_iters=12)
TRANSFER_CEILING = 1.05 * HBM_BYTES_PER_S / 1e9     # GB/s
TOL_COMPUTE_ARMS = 1e-5     # cuBLAS may pick another kernel on a stream
EPS32 = float(np.finfo(np.float32).eps)
# the dry run (phase dryrun, launch/dryrun.py): offload_families' --plan
# run's cell, costed on one card — 2 rows of 1024 tokens: at one row the
# optimizer's update makes the cell memory-bound, and the plan's two
# microbatches would not split one row — and the published-width configs
# the card cannot hold, at train_4k on the production (16, 16) mesh
DRYRUN_PLAN = ("olmo-1b", 2, 1024)          # arch, batch rows, tokens a row
DRYRUN_POD = ("command-r-plus-104b", "qwen3-moe-235b-a22b",
              "jamba-1.5-large-398b")
# parameter counts of the models the serve phases draw (PERF.md section 4)
DRYRUN_PARAMS = {"olmo-1b": 1_176_764_416, "rwkv6-7b": 7_618_695_168,
                 "h2o-danube-3-4b": 3_961_839_360,
                 "mistral-nemo-12b": 12_247_782_400}
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")


def dryrun_plan_cell() -> dict:
    """The dry run of ``--plan``'s cell on one card, written to
    DRYRUN_DIR: the one-device train step, stock, no remat, as
    ``launch.train`` runs it."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    arch, rows, seq = DRYRUN_PLAN
    cell = dryrun.run_cell(
        all_archs()[arch], ShapeConfig("plan", "train", seq, rows), "one",
        verbose=False, remat="none", mesh=make_host_mesh(1, 1),
        options=tstep.TrainOptions(remat=False))
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    cell["path"] = os.path.join(DRYRUN_DIR, f"{arch}__plan__one.json")
    with open(cell["path"], "w") as f:
        json.dump(cell, f, indent=1)
    return cell


def dryrun_start() -> dict:
    """Start the DRYRUN_POD cells at train_4k on the production mesh, each
    through the dry run's CLI in a process of its own, niced: they take
    the host's spare cores while the card's phases run (main() starts
    them after the kernels phase, whose timings they would disturb;
    ``phase_dryrun`` reads them)."""
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", "train_4k", "--mesh", "pod", "--out", DRYRUN_DIR],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, preexec_fn=lambda: os.nice(19)) for a in DRYRUN_POD}
    atexit.register(dryrun_stop, procs)
    return procs


def dryrun_stop(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_dryrun(card: str, hand: Handoff) -> dict:
    """``launch/dryrun.py`` on the host: the parameter counts, the
    ``--plan`` cell on one card (left in ``hand.dryrun`` for
    offload_families) and the DRYRUN_POD cells (``dryrun_start``'s
    processes, started here if main() did not)."""
    from repro_torch.analysis import roofline as rf
    counts = {a: rf.param_count(all_archs()[a]) for a in DRYRUN_PARAMS}
    check(counts == DRYRUN_PARAMS,
          f"param_count {counts} != the drawn models' {DRYRUN_PARAMS}")
    procs = hand.dryrun_procs or dryrun_start()
    t0 = time.perf_counter()
    hand.dryrun = dryrun_plan_cell()
    plan_s = time.perf_counter() - t0
    cells = {}
    for a, proc in procs.items():
        said = proc.communicate(timeout=900)[0]
        check(proc.returncode == 0 and "all cells passed" in said,
              f"dryrun {a}: rc {proc.returncode}\n{said[-3000:]}")
        with open(os.path.join(DRYRUN_DIR, f"{a}__train_4k__pod.json")) as f:
            cells[a] = json.load(f)
    check(hand.dryrun["flops_per_device"] > 0
          and hand.dryrun["collective_s"] == 0.0,
          f"the one-card cell: {hand.dryrun}")
    rows = {}
    for a, c in [(DRYRUN_PLAN[0], hand.dryrun)] + list(cells.items()):
        check(c["step_s"] > 0 and c["flops_per_device"] > 0
              and c["peak_memory_bytes"] > 0, f"{a}: {c}")
        rows[f"{a}.{c['shape']}.{c['mesh']}"] = {
            k: c[k] for k in ("n_chips", "compute_s", "memory_s",
                              "collective_s", "bottleneck", "step_s",
                              "roofline_fraction", "useful_ratio",
                              "peak_memory_bytes", "wire_ici", "wire_dcn",
                              "lower_s")}
    out = {"card": card, "param_counts": counts, "cells": rows,
           "plan_cell_s": plan_s}
    emit("dryrun", **out)
    return out


@contextlib.contextmanager
def derived_quant_launches():
    """Yield ``[K3a, K3b]``, summed over every compressed chain issued
    inside: each ``compressed_psum`` / int8 ``ring_allreduce`` call adds
    the launches ``expected_quant_launches`` derives for one rank's
    payload under the ``quant_impl`` policy at the call (``torch``: none).
    The kernels' own counters are never read here."""
    tally = [0, 0]
    psum, ring = collectives.compressed_psum, collectives.ring_allreduce

    def add(method, x, pods):
        impl = runtime.impl("quant_impl")
        check(impl in ("auto", "torch"), f"quant_impl {impl!r} in the phase")
        if impl == "auto":
            a, b = expected_quant_launches([x[0].numel()], pods.n, method)
            tally[0] += a
            tally[1] += b

    def psum_(x, pods, mean=True):
        add("int8_a2a", x, pods)
        return psum(x, pods, mean)

    def ring_(x, pods, mean=True, wire_int8=False):
        if wire_int8:
            add("int8_ring", x, pods)
        return ring(x, pods, mean, wire_int8)

    collectives.compressed_psum, collectives.ring_allreduce = psum_, ring_
    try:
        yield tally
    finally:
        collectives.compressed_psum, collectives.ring_allreduce = psum, ring


def inpath_amplitude(shapes) -> float:
    """The largest |x| over the inputs an ``inpath`` function draws, in
    order, from its generator (seed 0 on the card)."""
    from repro_torch.core import inpath
    _, _, gen = inpath._setup(PODS, DEV, "amplitude")
    return max(float(inpath._normal(gen, s).abs().max()) for s in shapes)


def inpath_bound(method: str, A: float) -> float:
    """The largest error a reduction by ``method`` may leave against the
    f32 mean of payloads bounded by ``A``: f32 rounding of a 4-way mean
    (stock, ring); each int8 quantization errs by at most A/254 an
    element after the mean — one (pairwise: each rank's own), two
    (int8_a2a: chunks, partial sums), n + 1 (int8_ring: chunks, n - 1
    hops, the gather; ``ring_bound_err``) — plus that rounding."""
    hops = {"stock": 0, "ring": 0, "int8_pairwise": 1, "int8_a2a": 2,
            "int8_ring": PODS + 1}[method]
    return hops * A / 254 + PODS * EPS32 * A


def offload_calls() -> dict:
    """Spec -> (experiment, function, keywords, the inputs' shapes for the
    error bound) of the card-size runs of the core functions."""
    from repro_torch.core import headroom, inpath
    n, size = PODS, CARD_INPATH_SIZE
    ov = CARD_OVERLAP
    return {
        "card.transfer": ("headroom.transfer", headroom.transfer_sweep,
                          dict(message_bytes=list(CARD_MESSAGES),
                               workers=list(CARD_WORKERS)), None),
        "card.delay_sweep": ("headroom.delay_sweep", headroom.delay_sweep,
                             dict(message_bytes=CARD_DELAY_BYTES,
                                  matmul_sizes=list(CARD_MATMULS)), None),
        "card.inpath": ("inpath.collectives", inpath.measure,
                        dict(size=size, pods=n), [(n, size)]),
        "card.headroom_overlap": (
            "inpath.headroom_overlap", inpath.measure_headroom_overlap,
            dict(ov, pods=n), [(n, ov["bucket_elems"])] * ov["n_buckets"]),
    }


def preset_shapes(name: str):
    from repro_torch.core import inpath
    n = PODS
    return {"inpath.collectives": [(n, 1 << 18)],
            "inpath.bucketing": [(n, s) for s in
                                 inpath.BUCKETING_LEAF_SIZES.values()],
            "inpath.headroom_overlap": [(n, inpath.OVERLAP_BUCKET_ELEMS)]
            * inpath.OVERLAP_BUCKETS}.get(name)


def check_offload(experiment: str, records, shapes) -> None:
    """The phase's checks of one family's records (module docstring)."""
    from repro_torch.core import stressors
    for r in records:
        if r.skipped:
            continue
        check(r.value is not None and bool(np.isfinite(r.value))
              and r.value >= 0, f"{experiment} {r.name}.{r.metric}: "
                                f"{r.value}")
    if experiment.startswith("headroom.transfer"):
        for r in records:
            check(r.value <= TRANSFER_CEILING,
                  f"{experiment} {r.name}: {r.value} GB/s is over "
                  f"{TRANSFER_CEILING} (a view or a wrong byte count)")
    if experiment == "stressors.suite":
        with_ref = {s.name for s in stressors._registry(DEV)
                    if s.make_ref is not None}
        for r in records:
            if r.name in NETWORK_STRESSORS:
                check(r.skipped, f"{r.name} ran on one card")
                continue
            check(not r.skipped, f"stressor {r.name} skipped: {r.reason}")
            check(r.name not in with_ref or r.relative is not None,
                  f"stressor {r.name}: no relative beside its reference")
    if experiment == "classes.aggregate":
        check(len(records) > 0, "no class aggregates")
    if shapes is not None:
        A = inpath_amplitude(shapes)
        for r in records:
            if "max_error" not in r.params:
                continue
            method = r.params.get("method", r.name)
            bound = inpath_bound(method, A)
            check(r.params["max_error"] <= bound,
                  f"{experiment} {r.name}: max_error "
                  f"{r.params['max_error']} over {bound}")


def transfer_kernels_check(workers: int = 4) -> dict:
    """The transfer proxy launches one kernel a buffer (``headroom.stream``:
    one read and one write of each, the bytes ``transfer_sweep``
    counts), traced on the card at 1 MiB and 256 MiB a buffer."""
    from repro_torch.core import headroom
    one = torch.ones((), device=DEV)
    out = {}
    for nbytes in (1 << 20, 256 << 20):
        bufs = [torch.ones(nbytes // 4, device=DEV) for _ in range(workers)]
        call = profiled_ms(lambda: [headroom.stream(one, x) for x in bufs],
                           iters=1, warmup=0, calls=True)
        check(call["kernels"] == workers,
              f"the transfer proxy launched {call['kernels']} kernels for "
              f"{workers} buffers of {nbytes} bytes")
        out[nbytes] = call
        del bufs
    return out


def inpath_arms_check() -> dict:
    """K3a/K3b held against their plain versions at the shapes the in-path
    families give them: ``compressed_psum`` and the int8
    ``ring_allreduce`` on PODS ranks of 1 << 18 (the families' preset) and
    of CARD_INPATH_SIZE (``offload_calls``), each on the inputs the
    family draws first, under ``quant_impl="auto"`` and ``"torch"``:
    reduced values and residuals bit-equal, as ``reduce_arms`` holds them
    at the train tree.  The auto arm's launches equal the count derived
    from the chain; the plain arm launches nothing."""
    from repro_torch.core import inpath
    chains = {"int8_a2a": collectives.compressed_psum,
              "int8_ring": functools.partial(collectives.ring_allreduce,
                                             wire_int8=True)}
    out = {}
    for size in (1 << 18, CARD_INPATH_SIZE):
        ax, _, gen = inpath._setup(PODS, DEV, "arms")
        x = inpath._normal(gen, (PODS, size))
        for method, chain in chains.items():
            outs, launched = {}, {}
            for impl in ("auto", "torch"):
                with runtime.use_policy(quant_impl=impl):
                    ops.reset_launch_counts()
                    outs[impl] = chain(x, ax)
                    torch.cuda.synchronize()
                    c = ops.launch_counts()
                    launched[impl] = (c["quantize_int8"],
                                      c["dequantize_int8"])
            want = expected_quant_launches([size], PODS, method)
            check(launched["auto"] == want and min(want) > 0,
                  f"{method} at {size} a pod: K3 launches "
                  f"{launched['auto']} != derived {want}")
            check(launched["torch"] == (0, 0),
                  f"quant_impl='torch' launched {launched['torch']}")
            for what, got, plain in zip(("reduced", "residual"),
                                        outs["auto"], outs["torch"]):
                check(torch.equal(got, plain),
                      f"{method} at {size} a pod: {what}, kernel arm vs "
                      f"plain (max diff {max_err(got, plain)})")
            out[f"{method}@{size}"] = list(want)
            del outs
        del x
    ops.reset_launch_counts()
    return out


def overlap_arms_check() -> dict:
    """Both arms of ``measure_headroom_overlap``'s step at the card's
    sizes, on the same inputs under the family's pin: every method's
    reduced values bit-equal, the compute within TOL_COMPUTE_ARMS
    relative (cuBLAS may pick another kernel on another stream); then
    one profiled call of each arm (``profiled_ms``'s wall, device ms and
    launches)."""
    from repro_torch.core import inpath
    ov = CARD_OVERLAP
    ax, _, gen = inpath._setup(PODS, DEV, "arms")
    tree = {f"w{i}": inpath._normal(gen, (PODS, ov["bucket_elems"]))
            for i in range(ov["n_buckets"])}
    a = inpath._normal(gen, (PODS, ov["compute_dim"], ov["compute_dim"])) \
        / ov["compute_dim"]
    out = {}
    with runtime.use_policy(quant_impl="torch"):
        for method in inpath.OVERLAP_METHODS:
            steps = [inpath.overlap_step(ax, method, ovl, ov["bucket_elems"],
                                         ov["compute_iters"])
                     for ovl in (False, True)]
            (r0, c0), (r1, c1) = [f(tree, a) for f in steps]
            check(all(torch.equal(r0[k], r1[k]) for k in r0),
                  f"headroom_overlap {method}: reduced values differ "
                  f"between the serial and overlapped arms")
            rel = float((c0 - c1).abs().max() / c0.abs().max())
            check(rel <= TOL_COMPUTE_ARMS,
                  f"headroom_overlap {method}: compute arms differ by {rel}")
            del r0, r1, c0, c1
            out[method] = {"compute_rel": rel, **{
                arm: profiled_ms(functools.partial(f, tree, a), iters=1,
                                 warmup=0, calls=True)
                for arm, f in zip(("serial", "overlapped"), steps)}}
    del tree, a
    return out


def schedule_arms_check() -> dict:
    """``reduce_gradients`` at the train phase's tree (full-width OLMo-1B,
    bf16 gradients of 4 pods, int8_ring, 4-MiB buckets: 8 chains) under
    ``quant_impl="auto"``, serial and pipelined (each next bucket packed
    on a side stream while the chains run on the caller's stream):
    reduced values and residuals bit-equal, leaf by leaf (the serial
    arm's kept on the card: kept on the host, its copies took most of
    the check's 23.4 s on an H100 80GB HBM3, 700 W)."""
    cfg = all_archs()["olmo-1b"]
    shapes = bridge.param_shapes(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    grads = {p: torch.randn((PODS,) + tuple(s), generator=gen, device=DEV)
             .to(torch.bfloat16) for p, s in shapes.items()}
    pods = PodAxis(PODS)
    kept = None
    for pipelined in (False, True):
        with runtime.use_policy(quant_impl="auto"):
            red, res = collectives.reduce_gradients(
                grads, pods, "int8_ring", overlap=pipelined)
        torch.cuda.synchronize()
        if kept is None:
            kept = {p: (red[p], res[p]) for p in red}
        else:
            for p, (r, e) in kept.items():
                check(torch.equal(red[p], r) and torch.equal(res[p], e),
                      f"{p}: serial and pipelined reductions differ")
        del red, res
    plan = buckets.plan_buckets([tuple(s) for s in shapes.values()],
                                [torch.bfloat16] * len(shapes))
    del grads, kept
    return {"leaves": len(shapes), "buckets": plan.n_buckets}


def phase_offload_families(card: str, hand: Handoff) -> dict:
    """The paper's offload characterization on the card, through the
    port's ``Runner`` at ``OFFLOAD_DURATION`` (``OFFLOAD_SHORT`` where
    named): the eight families at the
    reference's presets, then the same core functions at the card's
    sizes (``offload_calls``); both arms of the overlap step and of the
    train phase's reduction held bit-equal; then ``launch.train --plan``
    at full-width OLMo-1B with stressors measured on the card and the
    dry run's terms of that cell (``hand.dryrun``, or costed here), its
    steady steps held to be no faster than the dry run's bound.  K3's
    launches are held to the count derived from every chain the phase
    issues (``derived_quant_launches``)."""
    from repro_torch.experiments import Runner, experiment
    from repro_torch.experiments import registry as reg
    from repro_torch.launch import train as train_cli
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(ROOT, "build", "offload_families")
    records_dir = os.path.join(out_dir, "records_torch")
    os.makedirs(out_dir, exist_ok=True)
    seconds, launches = {}, {}
    runs = [(name, name, None, preset_shapes(name))
            for name in OFFLOAD_FAMILIES]
    runs += [(spec, exp, functools.partial(fn, **kw), shapes)
             for spec, (exp, fn, kw, shapes) in offload_calls().items()]
    # both traced checks in one fresh process (in_fresh_process): after a
    # traced full-width train step in the same process the profiler saw 1
    # or 2 of the proxy's 4 kernels and no device time of the overlap
    # arms on an H100 (one process each cost a start-up more)
    t0 = time.perf_counter()
    apart = in_fresh_process(("transfer_kernels_check",
                              "overlap_arms_check"))
    stream_calls = apart["transfer_kernels_check"]
    overlap_rel = apart["overlap_arms_check"]
    seconds["traced_checks_apart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernel_arms = inpath_arms_check()
    seconds["inpath_arms_check"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    with derived_quant_launches() as derived:
        for spec, exp, fn, shapes in runs:
            duration = OFFLOAD_SHORT.get(spec, OFFLOAD_DURATION)
            if fn is not None:
                spec = f"chip_smoke.{spec}"
                experiment(spec)(fn)
            before = ops.launch_counts()
            try:
                t0 = time.perf_counter()
                report = Runner(duration=duration, only=[spec],
                                records_dir=records_dir,
                                device="cuda").run()
                seconds[spec] = time.perf_counter() - t0
            finally:
                if fn is not None:
                    reg.unregister(spec)
            after = ops.launch_counts()
            launches[spec] = {k: after[k] - before[k] for k in after
                              if after[k] > before[k]}
            recs = report.records
            check(report.ok and recs,
                  f"{spec}: {[r.reason for r in report.errors]}")
            env = recs[0].params["env"]
            check(env["backend"] == "cuda" and env.get("card")
                  and env.get("power_limit"),
                  f"{spec}: environment stamp {env}")
            check_offload(exp, recs, shapes)
            emit("offload_families", family=spec, seconds=seconds[spec],
                 duration=duration, launches=launches[spec],
                 records=compact(recs), card=env.get("card"),
                 power_limit=env.get("power_limit"),
                 records_path=os.path.relpath(report.records_path, ROOT))
            del report, recs
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        schedule = schedule_arms_check()
        seconds["schedule_arms_check"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    derived = tuple(derived)
    counts = ops.launch_counts()
    check((counts["quantize_int8"], counts["dequantize_int8"]) == derived
          and min(derived) > 0,
          f"K3 launches {counts} != derived {derived}")

    cell = hand.dryrun or dryrun_plan_cell()
    emit("offload_plan_terms", path=os.path.relpath(cell["path"], ROOT),
         synthetic=False, **{k: cell[k] for k in (
             "compute_s", "memory_s", "collective_s", "step_s",
             "model_flops", "peak_memory_bytes")})
    ckpt = os.path.join(out_dir, "plan_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    phase_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch, rows, seq = DRYRUN_PLAN
    t0 = time.perf_counter()
    hist = train_cli.main(["--arch", arch, "--scale", "1.0", "--batch",
                           str(rows), "--seq", str(seq), "--steps", "3",
                           "--plan", cell["path"], "--ckpt-dir", ckpt,
                           "--ckpt-every", "0"])
    seconds["train_plan"] = time.perf_counter() - t0
    plan_peak = torch.cuda.max_memory_allocated()
    check(len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist),
          f"--plan losses {[h['loss'] for h in hist]}")
    # the roofline is a lower bound: a step faster than it is a miscount
    steady = [h["time_s"] for h in hist[1:]]
    check(min(steady) >= cell["step_s"],
          f"--plan steps {steady} s beat the dry run's bound "
          f"{cell['step_s']} s")
    step_s = statistics.median(steady)
    emit("offload_plan_bound", card=card, steady_step_s=steady,
         bound_step_s=cell["step_s"], bottleneck=cell["bottleneck"],
         step_over_bound=step_s / cell["step_s"],
         roofline_fraction=cell["model_flops"] / (BF16_FLOPS_PER_S * step_s),
         modeled_roofline_fraction=cell["roofline_fraction"],
         peak_memory_bytes=plan_peak,
         dryrun_peak_bytes=cell["peak_memory_bytes"],
         memory_estimate_ratio=cell["peak_memory_bytes"] / plan_peak)
    check(ops.launch_counts() == counts,
          f"--plan (one device, stock reduction, chunked attention) "
          f"launched a kernel: {ops.launch_counts()} after {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "duration": OFFLOAD_DURATION,
           "durations": OFFLOAD_SHORT, "pods": PODS,
           "seconds": seconds, "launches_by_family": launches,
           "k3_derived": list(derived),
           "transfer_proxy_calls": stream_calls,
           "inpath_kernel_arms_bit_equal": kernel_arms,
           "overlap_arms": overlap_rel,
           "schedule_arms_bit_equal": schedule,
           "plan_losses": [h["loss"] for h in hist],
           "plan_step_s": [h["time_s"] for h in hist],
           "peak_memory_bytes": max(phase_peak, plan_peak),
           "launches": counts}
    emit("offload_families_summary", **out)
    return out


# ---------------------------------------------------------------------------
# --k4-phases: where one chunk's cycles go inside K4
# ---------------------------------------------------------------------------

K4_PROBE_CHUNK = 8      # chunks 8 and 9 of a 1024-token scan are recorded


def k4_probe_source(text: str):
    """An instrumented copy of a WKV-6 kernel source (written to the build
    directory, never into the repository) and the comments of its chunk
    loop's barriers: lane 0 of every warp of block (0, 0) records
    ``clock64()`` as it reaches each barrier of the loop, in chunks
    K4_PROBE_CHUNK and K4_PROBE_CHUNK + 1 (every kernel of the source that
    has the loop is instrumented, the one launched records; the names are
    the last kernel's, dh 64's).  Built with
    ``-DK4_FAST_MATH``, ``expf`` and ``logf`` become ``__expf`` and
    ``__logf``."""
    import re
    loop = "  const int n_chunks = T / L;\n  for (int c = 0; c < n_chunks; ++c) {"
    check(loop in text, "K4 probe: no chunk loop found")
    head = ("\n__device__ long long k4_arrivals[2 * 8 * 16];\n"
            "#ifdef K4_FAST_MATH\n#define expf __expf\n#define logf __logf\n"
            "#endif\n")
    text = text.replace("namespace {\n", head + "namespace {\n", 1)
    names = None
    for a in reversed([m.start() for m in re.finditer(re.escape(loop),
                                                      text)]):
        depth, b = 0, a + len(loop) - 1      # the loop's opening brace
        for b in range(b, len(text)):
            depth += {"{": 1, "}": -1}.get(text[b], 0)
            if depth == 0:
                break
        body = text[a:b]
        bars = list(re.finditer(r"\n( +)__syncthreads\(\);([^\n]*)", body))
        check(0 < len(bars) <= 8, f"K4 probe: {len(bars)} barriers")
        n = 2 * len(bars) * 16              # as little shared memory as
        out, pos = [], 0                    # the records take
        for i, m in enumerate(bars):
            out += [body[pos:m.start()],
                    f"\n{m.group(1)}if ((threadIdx.x & 31) == 0 && (c == "
                    f"{K4_PROBE_CHUNK} || c == {K4_PROBE_CHUNK + 1})) "
                    f"k4_arr[(c - {K4_PROBE_CHUNK}) * {n // 2} + {i} * 16 + "
                    f"(threadIdx.x >> 5)] = clock64();", m.group(0)]
            pos = m.end()
        out.append(body[pos:])
        text = (text[:a] + f"  __shared__ long long k4_arr[{n}];\n"
                f"  for (int i = threadIdx.x; i < {n}; i += blockDim.x) "
                "k4_arr[i] = 0;\n"
                + "".join(out) + "}\n  __syncthreads();\n"
                "  if (blockIdx.x == 0 && blockIdx.y == 0)\n"
                f"    for (int i = threadIdx.x; i < {n}; i += blockDim.x)\n"
                "      k4_arrivals[i] = k4_arr[i];\n" + text[b + 1:])
        if names is None:      # the last kernel in the file (dh 64's)
            names = [m.group(2).strip(" /")[:48] for m in bars]
    text += ('\nextern "C" int k4_probe_read(void* out) {\n  return '
             'static_cast<int>(cudaMemcpyFromSymbol(out, k4_arrivals, '
             'sizeof(k4_arrivals)));\n}\n')
    return text, names


def k4_phases(sources, card: str) -> None:
    """Build each source instrumented (and the repository's kernel also
    with fast intrinsics), run it at the main shape (1, 1024, 64, 64),
    hold it against the plain version, and print a line each: CUDA-event
    and profiler times, and for the recorded chunk each barrier's critical
    path (its last arrival minus the last arrival at the barrier before)
    and each warp's work in that phase (its arrival minus that release),
    in SM cycles."""
    import ctypes
    import pathlib
    out_dir = _build.build_dir() / "k4_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    repo_src = _build.CSRC / "rwkv6_scan.cu"
    jobs = []
    for src in sources:
        src = pathlib.Path(src)
        text, names = k4_probe_source(src.read_text())
        for fast in ((False, True) if src.resolve() == repo_src.resolve()
                     else (False,)):
            tag = f"{src.stem}{'_fast' if fast else ''}"
            cu = out_dir / f"{tag}.cu"
            cu.write_text(text)
            so = out_dir / f"{tag}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                   *(["-DK4_FAST_MATH"] if fast else []), str(cu), "-o",
                   str(so)]
            jobs.append((src, fast, names, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    B, T, H, dh, L = 1, 1024, 64, 64, 64
    args = rwkv_case(13, B, T, H, dh)
    plain = rs.rwkv6_scan_torch(*args, chunk=L)
    for src, fast, names, so, proc in jobs:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"K4 probe build of {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.rwkv6_scan_fwd
        fn.argtypes = _build.SIGNATURES["rwkv6_scan_fwd"]
        fn.restype = ctypes.c_int
        lib.k4_probe_read.argtypes = [ctypes.c_void_p]

        def call():
            r, k, v, w, u, s0 = args
            y = torch.empty_like(r)
            s_t = torch.empty_like(s0)
            _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                            y.data_ptr(), s_t.data_ptr(), B, T, H, dh, L,
                            *r.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *w.stride()[:3],
                            *y.stride()[:3],
                            torch.cuda.current_stream().cuda_stream),
                         "k4 probe")
            return y, s_t

        got = call()
        torch.cuda.synchronize()
        err = max(max_err(g, p) for g, p in zip(got, plain))
        if not err < TOL_SCAN:
            emit("k4_phases", card=card, source=str(src), fast_math=fast,
                 max_abs_err=err, wrong=True)
            continue
        ms = time_ms(call)
        dev_ms = profiled_ms(call)[0]
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_longlong * 256)()
        _build.check(lib.k4_probe_read(ctypes.addressof(raw)), "k4 probe read")
        nb = len(names)
        warps = [wi for wi in range(16) if raw[wi]]   # the block's warps
        arr = [[[raw[cc * nb * 16 + i * 16 + wi] for wi in warps]
                for i in range(nb)] for cc in range(2)]
        rel = [[max(arr[cc][i]) for i in range(nb)] for cc in range(2)]
        phases = []
        for i in range(nb):
            start = rel[1][i - 1] if i else rel[0][nb - 1]
            phases.append({"ends_at": names[i],
                           "critical_cycles": rel[1][i] - start,
                           "warp_cycles": [a - start for a in arr[1][i]]})
        chunk = rel[1][nb - 1] - rel[0][nb - 1]
        emit("k4_phases", card=card, source=str(src), fast_math=fast,
             shape=[B, T, H, dh], chunk=L, max_abs_err=err, ms=ms,
             device_ms=dev_ms, chunk_cycles=chunk,
             sm_ghz_estimate=chunk * (T // L) / (dev_ms * 1e6),
             phases=phases)


# ---------------------------------------------------------------------------

PHASES = ("device", "build", "kernels", "serve_f32_smoke", "serve",
          "serve_rwkv", "serve_swa", "serve_nemo", "serve_moe", "serve_vlm",
          "serve_encdec", "serve_families", "serve_tp", "serve_tp_families",
          "train_f32_smoke",
          "train", "train_ranks", "train_mesh", "dryrun", "offload_families")
LINE_KEYS = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
# each row's main paths: the phases whose runs count its launches (summed
# over them), and the kernel's key in the phase's launch counts (one key,
# or one a phase).  K2 has a row for each head dim it serves, timed at that
# head dim's shape: hd 128 (OLMo-1B, Mistral-NeMo-12B, Moonlight-16B-A3B,
# InternVL2-26B), hd 120 (H2O-Danube3-4B) and hd 64 (Whisper-base);
# serve_tp_families counts its hd-64 launches (Whisper's) apart
MAIN_PATH = {"paged_attention_decode": (("serve", "serve_nemo", "serve_moe",
                                         "serve_families", "serve_tp",
                                         "serve_tp_families"),
                                        "paged_attention"),
             "flash_attention_fwd": (("serve", "serve_nemo", "serve_moe",
                                      "serve_vlm", "serve_families",
                                      "serve_tp", "serve_tp_families"),
                                     "flash_attention"),
             "flash_attention_fwd_hd120": (("serve_swa",),
                                           "flash_attention"),
             "flash_attention_fwd_hd64": (
                 ("serve_encdec", "serve_tp_families"),
                 {"serve_encdec": "flash_attention",
                  "serve_tp_families": "flash_attention_hd64"}),
             "rwkv6_scan_fwd": (("serve_rwkv", "serve_tp_families"),
                                "rwkv6_scan"),
             "quantize_int8": (("train", "train_ranks", "train_mesh",
                                "offload_families"), "quantize_int8"),
             "dequantize_int8": (("train", "train_ranks", "train_mesh",
                                  "offload_families"), "dequantize_int8")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="time and trace 20 decode ticks and a few "
                         "prefills at full width after the serve, "
                         "serve_rwkv, serve_swa, serve_moe and serve_vlm "
                         "phases (one JSON line each), and trace each "
                         "serve_tp_families rank job's decode tick")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v output, count the "
                         "tensor-core instructions in each kernel's SASS "
                         "and give K4's registers, local bytes, shared "
                         "memory and blocks a SM")
    ap.add_argument("--k1-sources", nargs="+", metavar="SRC",
                    help="also build each SRC, another K1 source (the "
                         "single-pass kernel's C interface or the split "
                         "kernel's), and time it at the main shape in turns "
                         "with the repository's K1 (kernels phase)")
    ap.add_argument("--k4-phases", nargs="*", metavar="SRC",
                    help="after the build, time K4 (or each given WKV-6 "
                         "kernel source) built with clock64() stamps at "
                         "its barriers, and print where a chunk's cycles go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA device\n")
        sys.exit(1)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "serve_tp_families" in phases:
        phases += [p for p in TPF_PROVIDERS if p not in phases]
    hand = Handoff(phases=tuple(phases), profile=args.profile)

    seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        emit("seconds", **{name: seconds[name]})
        return result

    card = timed("device", phase_device)
    k1_jobs = k1_sources_start(args.k1_sources) \
        if "kernels" in phases else []
    timed("build", phase_build, args.verbose_build)
    if args.k4_phases is not None:
        timed("k4_phases", k4_phases,
              args.k4_phases or [str(_build.CSRC / "rwkv6_scan.cu")], card)
    rows = timed("kernels", phase_kernels, k1_jobs) \
        if "kernels" in phases else []
    if "dryrun" in phases:      # beside the phases that follow, not K's
        hand.dryrun_procs = dryrun_start()
    if "serve_f32_smoke" in phases:
        timed("serve_f32_smoke", phase_serve_f32_smoke)
    served = {}
    if "serve" in phases:
        served["serve"] = timed("serve", phase_serve, card, args.profile,
                                hand=hand)
    if "serve_rwkv" in phases:
        served["serve_rwkv"] = timed("serve_rwkv", phase_serve_rwkv, card,
                                     args.profile, hand)
    if "serve_swa" in phases:
        served["serve_swa"] = timed("serve_swa", phase_serve_swa, card,
                                    args.profile)
    if "serve_nemo" in phases:
        served["serve_nemo"] = timed("serve_nemo", phase_serve_nemo, card,
                                     False, hand)
    for name, fn in (("serve_moe", phase_serve_moe),
                     ("serve_vlm", phase_serve_vlm)):
        if name in phases:
            served[name] = timed(name, fn, card, args.profile, hand)
    if "serve_encdec" in phases:
        served["serve_encdec"] = timed("serve_encdec", phase_serve_encdec,
                                       card, hand)
    if "serve_families" in phases:
        served["serve_families"] = timed("serve_families",
                                         phase_serve_families, card)
    if "serve_tp" in phases:
        served["serve_tp"] = timed("serve_tp", phase_serve_tp, card, hand)
    if "serve_tp_families" in phases:
        served["serve_tp_families"] = timed(
            "serve_tp_families", phase_serve_tp_families, card, hand)
    if "train_f32_smoke" in phases:
        timed("train_f32_smoke", phase_train_f32_smoke)
    if "train" in phases:
        served["train"] = timed("train", phase_train, card)
    if "train_ranks" in phases:
        served["train_ranks"] = timed("train_ranks", phase_train_ranks, card)
    if "train_mesh" in phases:
        served["train_mesh"] = timed("train_mesh", phase_train_mesh, card)
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun, card, hand)
    if "offload_families" in phases:
        served["offload_families"] = timed("offload_families",
                                           phase_offload_families, card,
                                           hand)
    for row in rows:
        paths, key = MAIN_PATH[row["name"]]
        ran = [p for p in paths if p in served]
        if ran:
            def count(p):
                return served[p]["launches"][
                    key if isinstance(key, str) else key[p]]
            row["launches"] = sum(count(p) for p in ran)
            row["launches_by_path"] = {p: count(p) for p in ran}
            for p in ran:
                check(count(p) > 0,
                      f"{row['name']} never launched on its main path {p}")
    if set(PHASES) <= set(phases):
        print(json.dumps({"kernels": [
            {**{k: row[k] for k in LINE_KEYS},
             "launches_by_path": row["launches_by_path"]}
            for row in rows]}), flush=True)
    print(card, flush=True)
    if set(PHASES) <= set(phases):
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    else:
        print(json.dumps({"ok": False, "partial": phases}), flush=True)


if __name__ == "__main__":
    main()
