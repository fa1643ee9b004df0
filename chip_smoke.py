#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, and serves a burst of
requests through the paged continuous-batching engine on full-width
OLMo-1B (16 layers, d_model 2048, bf16, random weights from a seed).
Each phase prints one JSON line; any failure exits non-zero.  Without a
CUDA device the script exits non-zero before printing any result.

Phases: device, build, kernels, serve_f32_smoke, serve.  Then one
``{"kernels": [...]}`` line with every kernel's launches on the main path,
its error against the plain version, its time, the plain version's time,
the bound (the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s,
H100 SXM data-sheet peaks) and the time of the PyTorch library call that
computes the same function (a yardstick: the port never calls it); the
card's name and power limit; and the last line
``{"ok": true, "device": {...}}``.

``--phases a,b`` runs a subset (for a short first run of new kernels);
with no arguments everything runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine  # noqa: E402
from repro_torch.serve.loadgen import LoadSpec, make_requests  # noqa: E402

DEV = torch.device("cuda")      # never touched before main() has checked
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
TOL_F32 = 2e-5                  # f32 sums in another order (as the
#                                 reference's kernel tests)
TOL_BF16 = 2e-2                 # one bf16 rounding of O(1) outputs
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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

def phase_build(verbose: bool) -> None:
    t0 = time.perf_counter()
    _build.lib(verbose=verbose)
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds,
         sources=[os.path.relpath(str(p), os.path.dirname(
             os.path.abspath(__file__))) for p in _build.sources()])


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
        need = -(-n // page_size)
        tables[s, :need] = perm[k:k + need]
        k += need
    to = lambda a: torch.tensor(a, device=DEV)        # noqa: E731
    return (to(q).to(dtype), to(pool).to(dtype), to(tables),
            to(np.asarray(lengths, np.int32)))


def flash_case(seed, B, S, H, Kv, hd, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.tensor(                  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32), device=DEV).to(dtype)
    return mk(B, S, H, hd), mk(B, S, Kv, hd), mk(B, S, Kv, hd)


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


def kernels_paged() -> dict:
    worst = 0.0
    for case in PAGED_GRID:
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
    # bf16 on the small grid as well (every hd / rep instantiation)
    worst_bf16 = 0.0
    for case in PAGED_GRID + [(2, 8, 2, 128, 16, 4, (5, 64)),
                              (2, 6, 2, 32, 8, 4, (9, 32))]:
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
    ms = time_ms(lambda: pa.paged_attention_fwd(q, pool, tables, lens,
                                                buffer_depth=2))
    plain_ms = time_ms(lambda: pa.paged_attention_torch(
        q, pool, tables, lens, buffer_depth=2), warmup=1, iters=3)
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
        "max_err_bf16_grid": worst_bf16, "poisoned_pool_diff": poison_diff,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": byts, "flops": flops, "library_ms": None,
    }


def flash_bound(B, S, H, Kv, hd, item, causal):
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    byts = item * B * S * hd * (2 * H + 2 * Kv)      # q, out, k, v
    return byts, flops


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
    for (B, S, H, Kv, hd) in FLASH_GRID + [(1, 8, 4, 4, 16), (1, 16, 4, 4, 16)]:
        q, k, v = flash_case(1, B, S, H, Kv, hd, torch.bfloat16)
        got = fa.flash_attention_fwd(q, k, v)
        plain = fa.flash_attention_torch(q, k, v)
        e = max_err(got, plain)
        check(e < TOL_BF16, f"flash bf16 {(B, S, H, Kv, hd)}: {e}")
        worst_bf16 = max(worst_bf16, e)

    # the main path's shapes: batch-1 prefill at the exact prompt length,
    # OLMo-1B heads, bf16, causal
    B, H, Kv, hd = 1, 16, 16, 128
    shapes = []
    for S in (128, 1000, 1024):
        q, k, v = flash_case(7, B, S, H, Kv, hd, torch.bfloat16)
        got = fa.flash_attention_fwd(q, k, v, causal=True)
        plain = fa.flash_attention_torch(q, k, v, causal=True)
        err = max_err(got, plain)
        check(err < TOL_BF16, f"flash bf16 main shape S={S}: {err}")
        check(bool(torch.isfinite(got.float()).all()),
              "flash output not finite")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True).transpose(1, 2)
        lib_err = max_err(got, lib)
        check(lib_err < TOL_BF16, f"flash vs library S={S}: {lib_err}")
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        plain_ms = time_ms(lambda: fa.flash_attention_torch(
            q, k, v, causal=True), warmup=1, iters=5)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
        byts, flops = flash_bound(B, S, H, Kv, hd, 2, True)
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        shapes.append({
            "S": S, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts, "flops": flops})
    head = shapes[-1]                                   # S = 1024
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
        "library_ms": head["library_ms"], "shapes": shapes,
    }


def phase_kernels() -> list:
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must not use TF32 in these comparisons")
    rows = [kernels_paged(), kernels_flash()]
    torch.cuda.synchronize()
    emit("kernels", tol_f32=TOL_F32, tol_bf16=TOL_BF16, kernels=rows)
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

    def run(**kw):
        eng = ContinuousEngine(cfg, params, n_slots=4, cache_len=64,
                               block_size=8, **kw)
        reqs = eng.generate(make_requests(spec))
        eng.scheduler.check()
        check(eng.kv.n_free == eng.kv.n_blocks, "smoke pool not recycled")
        return [list(r.generated) for r in reqs]

    ops.reset_launch_counts()
    with_kernels = run(paged=True, debug=True)
    counts = ops.launch_counts()
    check(counts["paged_attention"] > 0 and counts["flash_attention"] > 0,
          f"f32 smoke did not reach the kernels: {counts}")
    with runtime.use_policy(attention_impl="torch",
                            paged_attention_impl="torch"):
        ops.reset_launch_counts()
        plain = run(paged=True)
        dense = run(paged=False)
        check(ops.launch_counts() == {"flash_attention": 0,
                                      "paged_attention": 0},
              "impl='torch' launched a kernel")
    check(all(len(t) == 6 for t in with_kernels), "smoke: short stream")
    check(with_kernels == plain, f"f32 smoke token streams differ: "
                                 f"{with_kernels} vs {plain}")
    check(with_kernels == dense, "f32 smoke: paged differs from dense")
    emit("serve_f32_smoke", equal_streams=True, launches=counts,
         n_requests=len(with_kernels))


# ---------------------------------------------------------------------------
# phase: serve (full width)
# ---------------------------------------------------------------------------

def profile_decode(cells, args, card: str, ticks: int = 20) -> None:
    """Where a decode tick's time goes (``--profile``): ``ticks`` ticks as
    the engine drives them (decode cell, argmax, host copy), timed on the
    host clock and traced with ``torch.profiler`` for the device's share."""
    from torch.profiler import ProfilerActivity, profile

    def tick():
        logits, _ = cells.decode(*args)
        return torch.argmax(logits[:, 0], dim=-1).cpu()

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
    emit("profile", card=card, ticks=ticks, tick_ms=tick_ms,
         device_ms_per_tick=device_ms or None,
         device_idle_share=(1 - device_ms / tick_ms) if device_ms else None,
         device_launches_per_tick=sum(r[2] for r in rows),
         top=[{"name": k[:60], "ms_per_tick": ms, "per_tick": n}
              for k, ms, n in rows[:8]])


def phase_serve(card: str, do_profile: bool = False) -> dict:
    cfg = all_archs()["olmo-1b"]                  # published widths, bf16
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

    spec = LoadSpec(n_requests=24, rate_rps=0.0,
                    prompt_lens=(128, 512, 1024), max_new_tokens=64,
                    vocab_size=cfg.vocab_size, seed=0)
    reqs = make_requests(spec)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()

    ticks = sum(1 for e in eng.step_log if e.decoded)
    check(all(len(r.generated) == 64 for r in reqs),
          "a request did not get its 64 tokens")
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
               for n in (512, 1000, 128, 77) * (n_slots // 4)]
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
        profile_decode(cells, args, card)

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
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("serve", **out)
    return out


# ---------------------------------------------------------------------------

PHASES = ("device", "build", "kernels", "serve_f32_smoke", "serve")
LINE_KEYS = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after the serve phase, time and trace 20 decode "
                         "ticks at full width (one more JSON line)")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA device\n")
        sys.exit(1)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    card = phase_device()
    phase_build(args.verbose_build)
    rows = phase_kernels() if "kernels" in phases else []
    if "serve_f32_smoke" in phases:
        phase_serve_f32_smoke()
    if "serve" in phases:
        served = phase_serve(card, args.profile)
        launches = {"paged_attention_decode":
                    served["launches"]["paged_attention"],
                    "flash_attention_fwd":
                    served["launches"]["flash_attention"]}
        for row in rows:
            row["launches"] = launches[row["name"]]
            check(row["launches"] > 0, f"{row['name']} never launched on "
                                       f"the main path")
    if set(PHASES) <= set(phases):
        print(json.dumps({"kernels": [{k: row[k] for k in LINE_KEYS}
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
