"""Rowwise symmetric int8 quantize (K3a) / dequantize (K3b): CUDA kernel
wrappers + plain PyTorch versions.

The compute hot spot of the in-path gradient compression (the paper's
offloaded transform): ``x (N, C)`` f32 or bf16 -> ``q int8 (N, C)``,
``scale f32 (N, 1)`` and back, per row

    scale = max(max|x|, 1e-12) * f32(1/127)
    q     = clip(round_half_even(x / scale), -127, 127)

bit for bit as the reference computes it (see ``ref.quantize_int8_ref``
for why the scale is a product with the reciprocal).

* :func:`quantize_int8` / :func:`dequantize_int8` — the wrappers of the
  CUDA kernels ``csrc/quant_int8.cu`` (counterparts of the TPU kernels
  ``repro/kernels/quant.py:quantize_int8`` / ``dequantize_int8``).  On a
  CUDA tensor each launches its kernel or raises; only a tensor that lies
  on the CPU takes the plain version.  Any ``N`` (the TPU kernel's
  ``block_rows`` padding has no counterpart: the CUDA grid tiles each row).
* :func:`quantize_int8_torch` / :func:`dequantize_int8_torch` — the plain
  versions, the same arithmetic in PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import INV127, SCALE_FLOOR

# Payload size (elements) above which the quantize/dequantize transform is
# worth a kernel launch — below it the launch overhead beats the saving (the
# paper's offload-profitability rule, applied to the transform itself).
# ``kernels/ops.py`` keys the ``quant_impl="auto"`` policy on it; the value
# is the reference's.
PALLAS_QUANT_MIN_SIZE = 1 << 16

QUANT_LAUNCHES = 0      # kernel launches made by quantize_int8 (K3a)
DEQUANT_LAUNCHES = 0    # kernel launches made by dequantize_int8 (K3b)

_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements in 16 bytes


def quantize_int8_torch(x: torch.Tensor):
    """Plain version of K3a: x (N, C) -> (q int8 (N, C), scale f32 (N, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, SCALE_FLOOR) * INV127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_torch(q: torch.Tensor, scale: torch.Tensor,
                          dtype=torch.float32):
    """Plain version of K3b: (q (N, C), scale (N, 1)) -> (N, C) ``dtype``."""
    return (q.float() * scale).to(dtype)


def vec_ok(width: int, dtype: torch.dtype, *tensors) -> bool:
    """Whether the kernels may move 16 bytes a thread: rows of ``width``
    elements of ``dtype`` fill whole 16-byte words and every pointer is
    16-byte aligned."""
    return width % _VEC[dtype] == 0 \
        and all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.shape[1] == 0:
        raise ValueError(f"{name} must be (N, C) with C > 0, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (strides {t.stride()})")


def quantize_int8(x: torch.Tensor):
    """x: (N, C) f32 or bf16, contiguous -> (q int8 (N, C), scale f32
    (N, 1)).

    Raises on a shape, type or layout the kernel does not take, on any
    device.  On a CUDA tensor it then launches ``quantize_int8`` on the
    current stream (no synchronisation) and counts the launch in
    ``QUANT_LAUNCHES`` (``N = 0`` launches nothing).  CPU tensors take
    :func:`quantize_int8_torch`."""
    global QUANT_LAUNCHES
    _check_2d("x", x)
    _build.check_no_grad("quantize_int8", x)
    if x.dtype not in _VEC:
        raise TypeError(f"kernel takes float32 or bfloat16 x, got {x.dtype}")
    if not x.is_cuda:
        return quantize_int8_torch(x)
    N, C = x.shape
    q = torch.empty((N, C), dtype=torch.int8, device=x.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    if N == 0:
        return q, scale
    amax = torch.empty((N,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.lib().quantize_int8(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(),
            N, C, int(x.dtype == torch.bfloat16),
            int(vec_ok(C, x.dtype, x, q)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "quantize_int8")
    QUANT_LAUNCHES += 1
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32):
    """q: (N, C) int8, scale: (N, 1) f32, both contiguous -> (N, C)
    ``dtype`` (float32 or bfloat16).

    Raises on a shape, type or layout the kernel does not take, on any
    device.  On CUDA tensors it then launches ``dequantize_int8`` on the
    current stream and counts the launch in ``DEQUANT_LAUNCHES`` (``N = 0``
    launches nothing).  CPU tensors take
    :func:`dequantize_int8_torch`."""
    global DEQUANT_LAUNCHES
    _check_2d("q", q)
    _build.check_no_grad("dequantize_int8", scale)
    if q.dtype != torch.int8:
        raise TypeError(f"kernel takes int8 q, got {q.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (q.shape[0], 1) \
            or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous f32 ({q.shape[0]}, 1), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != q.device:
        raise ValueError(f"scale is on {scale.device}, q on {q.device}")
    if dtype not in _VEC:
        raise TypeError(f"kernel writes float32 or bfloat16, not {dtype}")
    if not q.is_cuda:
        return dequantize_int8_torch(q, scale, dtype)
    N, C = q.shape
    out = torch.empty((N, C), dtype=dtype, device=q.device)
    if N == 0:
        return out
    with torch.cuda.device(q.device):
        code = _build.lib().dequantize_int8(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), N, C,
            int(dtype == torch.bfloat16), int(vec_ok(C, dtype, q, out)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "dequantize_int8")
    DEQUANT_LAUNCHES += 1
    return out
