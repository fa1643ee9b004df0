"""Build and load the CUDA kernels: nvcc by hand, bound with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one nvcc per source, all
started together) and linked into ONE shared library with a plain C
interface under ``build/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``).  The library's name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
loaded as it is.  Nothing here runs at import: the first kernel launch
calls :func:`lib`.  A failed build raises; nothing catches it and carries
on with a plain version.

A launch goes on PyTorch's current stream and returns at once; its
tensors may be released by the caller right after, because PyTorch's
allocator hands memory freed on a stream only to later work of that stream.

Pointers and the stream cross the boundary as Python ints; every function
has its ``argtypes`` set (``c_void_p`` for each pointer and the stream),
without which ctypes would pass them as 32-bit ints and cut the pointers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures (see the ``extern "C"`` functions at the end of each source)
SIGNATURES = {
    # q, pool, tables, lengths, out, part | S, H, Kv, hd, page_size,
    # max_pages, span, n_split, tile, slots | q strides (s, h), pool
    # strides (page, tok, head), out strides (s, h) | sm_scale, is_bf16,
    # stream
    "paged_attention_decode": [_P] * 6 + [_I] * 10 + [_L] * 7
    + [_F, _I, _P],
    # q, k, v, out | B, S, H, Kv, hd | q, k, v, out strides (b, s, h) each |
    # sm_scale, causal, window, is_bf16, stream
    "flash_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 12
    + [_F, _I, _I, _I, _P],
    # r, k, v, w, u, s0, y, s_T | B, T, H, dh, chunk | r, k, v, w, y
    # strides (b, t, h) each | stream
    "rwkv6_scan_fwd": [_P] * 8 + [_I] * 5 + [_L] * 15 + [_P],
    # dh | out: registers, local bytes, shared bytes, blocks a SM, threads
    "rwkv6_scan_info": [_I, _P],
    # x, q, scale, amax scratch | N, C | is_bf16, vec, stream
    "quantize_int8": [_P] * 4 + [_L] * 2 + [_I] * 2 + [_P],
    # q, scale, out | N, C | out_bf16, vec, stream
    "dequantize_int8": [_P] * 3 + [_L] * 2 + [_I] * 2 + [_P],
    # sink | iters | stream
    "fabric_burn": [_P, _L, _P],
}

_LIB = None
build_seconds = None      # wall time of the build this process ran (or None)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in list(srcs) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if not already built for these sources) and return the
    path of the shared library."""
    global build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = build_dir()
    target = out_dir / f"librepro_torch_kernels_{_digest(srcs)}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{target.stem}.{os.getpid()}"
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in srcs:
        obj = out_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        elif verbose and log:
            print(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in jobs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, target)           # atomic: concurrent builds agree
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return target


def lib(verbose: bool = False):
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check_no_grad(what: str, *tensors) -> None:
    """Raise if autograd would record through a kernel: the kernels have
    no backward (the TPU kernels they replace have none either), so their
    outputs carry no ``grad_fn`` and every gradient upstream of them would
    come out silently wrong.  Checked on every device, the CPU's plain
    versions included, so that a path is wrong nowhere rather than only
    on the card."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on "
            f"tensors that do not require grad (training attends through "
            f"attention_impl='chunked')")


def check(code: int, what: str) -> None:
    """Raise on the non-zero return of a kernel's C entry point (a CUDA
    error code from ``cudaGetLastError``, or -1 for an unsupported shape)."""
    if code != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed with code {code}"
            + (" (shape or type the kernel does not take)" if code < 0
               else " (cudaError_t)"))
