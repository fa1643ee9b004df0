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
Mistral-NeMo-12B (40 layers, d_model 5120, GQA rep 4; K1 and K2), the
serving families of the paper's question on OLMo-1B (K1, K2; the static
engine's batched prefill held first), three training steps of OLMo-1B
over 4 emulated pods with the int8 ring all-reduce of its gradients (K3a,
K3b), and the paper's offload characterization (K3a, K3b in the in-path
transforms).  Each phase prints one JSON line and its seconds; any
failure exits non-zero.  Without a CUDA device the script exits non-zero
before printing any result.

Phases: device, build, kernels, serve_f32_smoke, serve, serve_rwkv,
serve_swa, serve_nemo, serve_families, train_f32_smoke, train,
offload_families.
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
measured on the card and canned (synthetic) roofline terms.
``serve_families`` asks the paper's question of full-width OLMo-1B on
the card: the port's serving families (``repro_torch.core``: offered-load
sweep with probe headroom, SLO sweep, span timeline, degraded-fabric tail
under the five canonical conditions, continuous vs static engine, and the
paged-attention page-size x depth sweep) through the port's experiment
Runner, one JSON line each; their Record streams and the timeline's trace
land under ``build/serve_families/``.  Then one ``{"kernels": [...]}``
line with every kernel's launches on its main paths, summed (K1 in
``serve``, ``serve_nemo`` and ``serve_families``; K2 in ``serve``,
``serve_swa``, ``serve_nemo`` and ``serve_families``; K4 in
``serve_rwkv``; K3a, K3b in ``train`` and ``offload_families``), its
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
import contextlib
import dataclasses
import functools
import gc
import json
import os
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
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.models import common, registry  # noqa: E402
from repro_torch.parallel import buckets, collectives, overlap  # noqa: E402
from repro_torch.parallel.pods import PodAxis  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.loadgen import LoadSpec, make_requests  # noqa: E402
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
            kernels_rwkv()] + kernels_quant()
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
    emit("serve_f32_smoke", equal_streams=True, launches=counts,
         n_requests=len(with_kernels), n_rwkv_requests=len(rwkv_kernels),
         n_swa_requests=len(swa_kernels), swa_window=dcfg.sliding_window,
         swa_prompt_lens=list(dspec.prompt_lens),
         swa_max_new=dspec.max_new_tokens)


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


def phase_serve(card: str, do_profile: bool = False, arch: str = "olmo-1b",
                phase: str = "serve", n_requests: int = 24,
                prompt_lens: tuple = (128, 512, 1024), max_new: int = 64,
                check_lens: tuple = (512, 1000, 128, 77)) -> dict:
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

    # warm-up (cuBLAS handles, kernel images): not part of the counted run
    warm = LoadSpec(n_requests=2, rate_rps=0.0, prompt_lens=(128,),
                    max_new_tokens=4, vocab_size=cfg.vocab_size, seed=1)
    eng.generate(make_requests(warm))
    torch.cuda.synchronize()

    spec = LoadSpec(n_requests=n_requests, rate_rps=0.0,
                    prompt_lens=prompt_lens, max_new_tokens=max_new,
                    vocab_size=cfg.vocab_size, seed=0)
    reqs = make_requests(spec)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()   # before the checks' prefills

    ticks = sum(1 for e in eng.step_log if e.decoded)
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


def phase_serve_nemo(card: str, do_profile: bool = False) -> dict:
    """Mistral-NeMo-12B at full width through the paged engine: K1 at GQA
    rep 4 on a model path, K2 at rep 4."""
    return phase_serve(card, do_profile, arch="mistral-nemo-12b",
                       phase="serve_nemo", n_requests=8,
                       prompt_lens=(128, 1024), max_new=32,
                       check_lens=(1024, 1000, 128, 77))


# ---------------------------------------------------------------------------
# phase: serve_families (full width: the paper's serving question)
# ---------------------------------------------------------------------------

FAMILY_ARCH = "olmo-1b"
FAMILY_ENGINE = dict(n_slots=16, cache_len=2048, block_size=16)  # serve's
FAMILY_LOAD = dict(prompt_lens=(128, 512, 1024), max_new=64)
# Each level's arrival window is 2 x duration (the reference's
# max(2 * duration, 0.4)).  At full width a request of 64 new tokens lives
# ~3 s (64 host-bound ticks of ~45 ms on an H100), so 4 s makes the window
# ~2.7 lifetimes: the 2x level fills the 16 slots and queues, and a level
# serves ~0.5 x rate x 8 s requests (11 at 0.25x, ~90 at 2x).  paged_sweep
# times each of its 12 (page size, depth) microbench pairs for `duration`
# as well, so it takes half of that.  max_requests caps the fastest host's
# 2x level (capacity ~8 requests/s) above what the window offers.
FAMILY_DURATION = {"serve.load_sweep": 4.0, "serve.slo_sweep": 4.0,
                   "serve.timeline": 4.0, "fabric.serve_tail": 4.0,
                   "serve.continuous_vs_static": 4.0,
                   "serve.paged_attention": 2.0}
FAMILY_MAX_REQUESTS = {"serve.load_sweep": 128, "serve.slo_sweep": 96,
                       "serve.timeline": 64, "fabric.serve_tail": 64,
                       "serve.paged_attention": 64}
FAMILY_CONDITIONS = ("clean", "jitter", "straggler", "lossy", "throttle")
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
        "serve.load_sweep": (serving.load_sweep,
                             dict(engine, **FAMILY_LOAD)),
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

    spec = LoadSpec(n_requests=24, rate_rps=0.0, prompt_lens=SWA_PROMPTS,
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


def phase_serve_rwkv(card: str, do_profile: bool = False) -> dict:
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

    spec = LoadSpec(n_requests=24, rate_rps=0.0,
                    prompt_lens=(64, 512, 1024), max_new_tokens=64,
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
    check(all(len(r.generated) == 64 for r in reqs),
          "a request did not get its 64 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "token out of range")
    eng.scheduler.check()
    check(eng.kv.n_free == eng.kv.n_blocks, "KV blocks not recycled")
    check(counts["rwkv6_scan"] == len(reqs) * n_layers,
          f"K4 launches {counts['rwkv6_scan']} != {len(reqs)} x "
          f"{n_layers} layers")
    check(counts["paged_attention"] == 0 and counts["flash_attention"] == 0,
          f"an attention kernel ran on RWKV: {counts}")

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
           "fault_logged": any("FAILURE" in line for line in logs)}
    emit("train_f32_smoke", **out)
    return out


TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 3
# rounds of the reduction's schedule arms, timed in turns inside steps
SCHEDULE_ROUNDS = 10
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
# phase: offload_families (the paper's offload characterization)
# ---------------------------------------------------------------------------

# each run's window (s): 1 s, shorter where the phase would otherwise
# outgrow the script's time budget — the stressor battery (both families
# run all of it, each stressor timed beside its numpy reference; at
# 0.25 s the slowest, jit-compile at ~12 compiles/s on an H100, still
# times 3 calls) and each point of the card-size sweeps
OFFLOAD_DURATION = 1.0
OFFLOAD_SHORT = {"stressors.suite": 0.25, "classes.aggregate": 0.25,
                 "card.transfer": 0.5, "card.delay_sweep": 0.5}
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
# canned roofline terms for --plan (seconds; not measured): compute-bound,
# so the plan keeps one microbatch for the one-sequence batch
PLAN_TERMS = {"compute_s": 0.6, "memory_s": 0.25, "collective_s": 0.24,
              "synthetic": True}


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


def transfer_kernels_apart() -> dict:
    """``transfer_kernels_check`` in a process of its own: after a traced
    full-width train step in the same process, the profiler on an H100
    saw 1 or 2 of the 4 kernels in every later window of the proxy,
    where a fresh process sees all 4 in every window."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.transfer_kernels_check()))")
    run = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"transfer proxy trace:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


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
    arm's kept on the host)."""
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
            kept = {p: (red[p].cpu(), res[p].cpu()) for p in red}
        else:
            for p, (r, e) in kept.items():
                check(torch.equal(red[p].cpu(), r)
                      and torch.equal(res[p].cpu(), e),
                      f"{p}: serial and pipelined reductions differ")
        del red, res
    plan = buckets.plan_buckets([tuple(s) for s in shapes.values()],
                                [torch.bfloat16] * len(shapes))
    del grads, kept
    return {"leaves": len(shapes), "buckets": plan.n_buckets}


def phase_offload_families(card: str) -> dict:
    """The paper's offload characterization on the card, through the
    port's ``Runner`` at ``OFFLOAD_DURATION`` (``OFFLOAD_SHORT`` where
    named): the eight families at the
    reference's presets, then the same core functions at the card's
    sizes (``offload_calls``); both arms of the overlap step and of the
    train phase's reduction held bit-equal; then ``launch.train --plan``
    at full-width OLMo-1B with stressors measured on the card and canned
    terms.  K3's launches are held to the count derived from every chain
    the phase issues (``derived_quant_launches``)."""
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
    t0 = time.perf_counter()
    stream_calls = transfer_kernels_apart()
    seconds["transfer_kernels_check"] = time.perf_counter() - t0
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
        overlap_rel = overlap_arms_check()
        seconds["overlap_arms_check"] = time.perf_counter() - t0
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

    terms = os.path.join(out_dir, "plan_terms.json")
    with open(terms, "w") as f:
        json.dump(PLAN_TERMS, f)
    emit("offload_plan_terms", **PLAN_TERMS)
    ckpt = os.path.join(out_dir, "plan_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    hist = train_cli.main(["--arch", "olmo-1b", "--scale", "1.0", "--batch",
                           "1", "--seq", "1024", "--steps", "3", "--plan",
                           terms, "--ckpt-dir", ckpt, "--ckpt-every", "0"])
    seconds["train_plan"] = time.perf_counter() - t0
    check(len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist),
          f"--plan losses {[h['loss'] for h in hist]}")
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
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
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
          "serve_rwkv", "serve_swa", "serve_nemo", "serve_families",
          "train_f32_smoke", "train", "offload_families")
LINE_KEYS = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
# each row's main paths: the phases whose runs count its launches (summed
# over them), and the kernel's key in ops.launch_counts().  K2 has a row for
# each head dim it serves, timed at that head dim's shape: hd 128 (OLMo-1B,
# Mistral-NeMo-12B) and hd 120 (H2O-Danube3-4B)
MAIN_PATH = {"paged_attention_decode": (("serve", "serve_nemo",
                                         "serve_families"),
                                        "paged_attention"),
             "flash_attention_fwd": (("serve", "serve_nemo",
                                      "serve_families"), "flash_attention"),
             "flash_attention_fwd_hd120": (("serve_swa",),
                                           "flash_attention"),
             "rwkv6_scan_fwd": (("serve_rwkv",), "rwkv6_scan"),
             "quantize_int8": (("train", "offload_families"),
                               "quantize_int8"),
             "dequantize_int8": (("train", "offload_families"),
                                 "dequantize_int8")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="time and trace 20 decode ticks and 5 "
                         "1024-token prefills at full width after the "
                         "serve phase and after serve_rwkv (one JSON line "
                         "each)")
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

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
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
    if "serve_f32_smoke" in phases:
        timed("serve_f32_smoke", phase_serve_f32_smoke)
    served = {}
    if "serve" in phases:
        served["serve"] = timed("serve", phase_serve, card, args.profile)
    if "serve_rwkv" in phases:
        served["serve_rwkv"] = timed("serve_rwkv", phase_serve_rwkv, card,
                                     args.profile)
    if "serve_swa" in phases:
        served["serve_swa"] = timed("serve_swa", phase_serve_swa, card,
                                    args.profile)
    if "serve_nemo" in phases:
        served["serve_nemo"] = timed("serve_nemo", phase_serve_nemo, card)
    if "serve_families" in phases:
        served["serve_families"] = timed("serve_families",
                                         phase_serve_families, card)
    if "train_f32_smoke" in phases:
        timed("train_f32_smoke", phase_train_f32_smoke)
    if "train" in phases:
        served["train"] = timed("train", phase_train, card)
    if "offload_families" in phases:
        served["offload_families"] = timed("offload_families",
                                           phase_offload_families, card)
    for row in rows:
        paths, key = MAIN_PATH[row["name"]]
        ran = [p for p in paths if p in served]
        if ran:
            row["launches"] = sum(served[p]["launches"][key] for p in ran)
            row["launches_by_path"] = {p: served[p]["launches"][key]
                                       for p in ran}
            for p in ran:
                check(served[p]["launches"][key] > 0,
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
