"""Chunked WKV-6 scan: CUDA kernel wrapper + plain PyTorch version.

The RWKV-6 time mix's recurrence per head, with state ``S`` (dh x dh),
evaluated a chunk of ``L`` steps at a time: within a chunk the strictly
causal part is an ``L x L`` masked product of decay-rescaled ``r`` and
``k``, the cross-chunk part applies the carried state, the bonus term is
``sum(r * u * k) * v``; decays live in log space and the rescale exponents
are clipped at 30 (``models/rwkv6.py`` of the reference, lines 81-118).

* :func:`rwkv6_scan_fwd` — the wrapper of the CUDA kernel
  ``csrc/rwkv6_scan.cu`` (counterpart of the TPU kernel
  ``repro/kernels/rwkv6_scan.py:rwkv6_scan_fwd``).  It validates shapes,
  strides, dtype and head dim for every device; on a CUDA tensor it then
  launches the kernel or raises, and only a tensor that lies on the CPU
  takes the plain version.
* :func:`rwkv6_scan_torch` — the plain version: the same chunked form in
  PyTorch, a Python loop over chunks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 64           # the reference's chunk (models/rwkv6.py CHUNK)
MAX_CHUNK = 64       # the longest chunk the kernel takes
CLIP = 30.0          # exponent clip of the 1/decay rescale
HEAD_DIMS = (16, 32, 64)

LAUNCHES = 0      # kernel launches made by rwkv6_scan_fwd


def _geometry(r, k, v, w, u, s0, chunk):
    """(B, T, H, dh, L) of a scan, ``L = min(chunk, T)`` dividing ``T`` —
    the reference's contract (``rwkv6.py:86-87``)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"the scan takes r, k, v, w of one shape "
                         f"(B,T,H,dh); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    B, T, H, dh = r.shape
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"u must be (H, dh) = {(H, dh)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, dh, dh):
        raise ValueError(f"s0 must be (B, H, dh, dh) = {(B, H, dh, dh)}, "
                         f"got {tuple(s0.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} is not a multiple of the chunk {L}")
    return B, T, H, dh, L


def rwkv6_scan_torch(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """Plain PyTorch chunked WKV-6 (any device, any head dim).

    r, k, v, w: (B, T, H, dh), w in (0, 1); u: (H, dh); s0: (B, H, dh, dh)
    or None (zeros).  Returns (y (B,T,H,dh) f32, S_T (B,H,dh,dh) f32)."""
    B, T, H, dh, L = _geometry(r, k, v, w, u, s0, chunk)
    dev = r.device
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
         if s0 is None else s0.float())
    n = T // L

    def chunks(z):
        return z.float().reshape(B, n, L, H, dh)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    uf = u.float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev),
                      diagonal=-1)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    ys = []
    for c in range(n):
        rr, kk, vv, ww = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,L,H,dh)
        lw = torch.log(torch.clamp_min(ww, 1e-12))
        cl = torch.cumsum(lw, dim=1)                    # inclusive
        cl_ex = cl - lw                                 # exclusive
        r_d = rr * torch.exp(cl_ex)
        k_d = kk * torch.exp(torch.clamp_max(-cl, CLIP))
        scores = torch.einsum("blhd,bmhd->bhlm", r_d, k_d)
        scores = torch.where(mask, scores, zero)        # strictly causal
        y = torch.einsum("bhlm,bmhd->blhd", scores, vv)  # intra-chunk
        y = y + torch.einsum("blhd,bhde->blhe", r_d, S)  # cross-chunk
        bonus = torch.sum(rr * uf * kk, dim=-1)          # (B,L,H)
        y = y + bonus[..., None] * vv
        dl = cl[:, -1]                                  # (B,H,dh) total decay
        k_end = kk * torch.exp(torch.clamp_max(dl[:, None] - cl, CLIP))
        S = torch.exp(dl)[..., None] * S \
            + torch.einsum("bmhd,bmhe->bhde", k_end, vv)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def rwkv6_scan_fwd(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """r, k, v, w: (B, T, H, dh) f32; u: (H, dh); s0: (B, H, dh, dh) or
    None -> (y (B,T,H,dh) f32, S_T (B,H,dh,dh) f32).

    ``chunk = min(chunk, T)`` must divide ``T`` (a prompt of up to 64
    tokens is one chunk of any length).  Raises on a shape, type, head dim
    or layout the kernel does not take, on any device.  On CUDA tensors
    it then launches ``rwkv6_scan_fwd`` on the current stream (no
    synchronisation) and counts the launch in ``LAUNCHES``; the
    ``(B,T,H,dh)`` layout is read through its strides.  CPU tensors take
    :func:`rwkv6_scan_torch`."""
    global LAUNCHES
    _build.check_no_grad("rwkv6_scan_fwd", r, k, v, w, u, s0)
    B, T, H, dh, L = _geometry(r, k, v, w, u, s0, chunk)
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)) \
        + ((("s0", s0),) if s0 is not None else ())
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 tensors; {name} is "
                            f"{t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel takes dh in {HEAD_DIMS}, got {dh}")
    if L > MAX_CHUNK:
        raise ValueError(f"kernel takes a chunk of at most {MAX_CHUNK} "
                         f"steps, got {L}")
    for name, t in named[:4]:
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows of dh must be dense and 16-byte "
                             f"aligned (strides {t.stride()})")
    for name, t in named[4:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not r.is_cuda:
        return rwkv6_scan_torch(r, k, v, w, u, s0, chunk=chunk)
    if s0 is None:
        s0 = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                         device=r.device)
    y = torch.empty((B, T, H, dh), dtype=torch.float32, device=r.device)
    s_t = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = _build.lib().rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_t.data_ptr(),
            B, T, H, dh, L,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *y.stride()[:3],
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "rwkv6_scan_fwd")
    LAUNCHES += 1
    return y, s_t


def kernel_info(dh: int) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory
    and threads a block, and blocks resident a SM, of the kernel built for
    head dim ``dh`` on the current CUDA device (from the CUDA runtime's
    function attributes and occupancy calculator)."""
    import ctypes
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel takes dh in {HEAD_DIMS}, got {dh}")
    out = (ctypes.c_int * 5)()
    _build.check(_build.lib().rwkv6_scan_info(dh, ctypes.addressof(out)),
                 "rwkv6_scan_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "threads"), list(out)))
