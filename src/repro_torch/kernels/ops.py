"""The one dispatch point of the kernels, with their launch counts.

``runtime.policy()`` decides here, and only here, which function backs
each hot-spot op; callers (``models/attention.py``, ``models/rwkv6.py``,
``serve/paged.py``, ``parallel/collectives.py``) go through these wrappers
rather than re-reading the policy.  ``"kernel"`` calls the kernel wrapper
(which launches on a CUDA tensor or raises, and takes the plain version
only for a CPU tensor); ``"torch"`` calls the plain PyTorch version
outright.  ``quant_impl="auto"`` applies the reference's size rule
(:func:`use_kernel_quant`).  There is no choice by device here.
"""
from __future__ import annotations

import torch

from repro_torch import runtime
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quant as _q
from repro_torch.kernels import rwkv6_scan as _rs


def flash_attention(q, k, v, *, causal=True, window=0):
    if runtime.impl("attention_impl") == "torch":
        return _fa.flash_attention_torch(q, k, v, causal=causal,
                                         window=window)
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)


def paged_attention(q, pool, tables, lengths, *, buffer_depth=None):
    """Policy-dispatched ragged paged-attention decode (see
    ``kernels/paged_attention.py`` for shapes).  ``buffer_depth=None``
    reads the ``paged_buffer_depth`` policy knob."""
    if buffer_depth is None:
        buffer_depth = int(runtime.policy()["paged_buffer_depth"])
    if runtime.impl("paged_attention_impl") == "torch":
        return _pa.paged_attention_torch(q, pool, tables, lengths,
                                         buffer_depth=buffer_depth)
    return _pa.paged_attention_fwd(q, pool, tables, lengths,
                                   buffer_depth=buffer_depth)


def rwkv6_scan(r, k, v, w, u, s0=None, *, chunk=_rs.CHUNK):
    """Policy-dispatched chunked WKV-6 (see ``kernels/rwkv6_scan.py``)."""
    if runtime.impl("rwkv_impl") == "torch":
        return _rs.rwkv6_scan_torch(r, k, v, w, u, s0, chunk=chunk)
    return _rs.rwkv6_scan_fwd(r, k, v, w, u, s0, chunk=chunk)


def use_kernel_quant(size: int) -> bool:
    """Whether a quant payload of ``size`` elements takes the kernel under
    the current policy (``kernel`` forces, ``torch`` forbids, ``auto`` keys
    on ``quant.PALLAS_QUANT_MIN_SIZE``)."""
    impl = runtime.impl("quant_impl")
    return impl == "kernel" or (impl == "auto"
                                and size >= _q.PALLAS_QUANT_MIN_SIZE)


def quantize_int8(x, *, size=None):
    """Rowwise int8 quantization of ``x (N, C)`` (see ``kernels/quant.py``).
    ``size`` is the payload the size rule reads — one rank's elements
    when the rows of several emulated ranks go in one launch
    (``parallel/collectives.py``); ``None`` means ``x.numel()``."""
    if use_kernel_quant(x.numel() if size is None else size):
        return _q.quantize_int8(x)
    return _q.quantize_int8_torch(x)


def dequantize_int8(q, scale, dtype=torch.float32, *, size=None):
    if use_kernel_quant(q.numel() if size is None else size):
        return _q.dequantize_int8(q, scale, dtype)
    return _q.dequantize_int8_torch(q, scale, dtype)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel (plain integers
    kept on the wrappers; each adds one where it launches and nowhere
    else)."""
    return {"flash_attention": _fa.LAUNCHES, "paged_attention": _pa.LAUNCHES,
            "rwkv6_scan": _rs.LAUNCHES, "quantize_int8": _q.QUANT_LAUNCHES,
            "dequantize_int8": _q.DEQUANT_LAUNCHES}


def reset_launch_counts() -> None:
    _fa.LAUNCHES = 0
    _pa.LAUNCHES = 0
    _rs.LAUNCHES = 0
    _q.QUANT_LAUNCHES = 0
    _q.DEQUANT_LAUNCHES = 0
