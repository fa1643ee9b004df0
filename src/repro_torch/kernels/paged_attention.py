"""Ragged paged-attention decode: CUDA kernel wrapper + plain PyTorch version.

One query token per sequence attends over that sequence's KV pages in a
physical block-paged pool (``serve/kv.py`` + ``serve/paged.py``): pool
layout ``(n_pages, page_size, 2*Kv, hd)`` with K/V *head-interleaved*
along the fused head axis (``[k0, v0, k1, v1, ...]``).  The tail page is
ragged: positions past ``lengths[s]`` never contribute, so sequences need
not fill their last page, and table rows are padded with a trash page
that is never read unmasked.

* :func:`paged_attention_fwd` — the wrapper of the CUDA kernel
  ``csrc/paged_attention.cu`` (counterpart of the TPU kernel
  ``repro/kernels/paged_attention.py:paged_attention_fwd``).  On a CUDA
  tensor it launches the kernel or raises; only a tensor that lies on the
  CPU takes the plain version.  :func:`_split_plan` and :func:`_ring_plan`
  fix the kernel's split of each sequence and its page ring from static
  sizes alone.
* :func:`paged_attention_torch` — the plain version: the page walk of the
  reference's ``paged_attention_xla`` as a Python loop, ``buffer_depth``
  pages gathered per step and folded into one online softmax.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
SPLIT_BYTES = 64 * 1024    # K and V bytes a split reads at most: 128
#                            positions at hd 128 in bf16
MIN_BLOCKS = 2 * 132       # blocks the split grid offers when every split
#                            is live: two waves on the H100's 132 SMs
SMEM_BYTES = 232_448       # dynamic shared memory a block can use (H100)
MAX_SLOTS = 8              # ring slots the kernel takes

LAUNCHES = 0      # kernel launches made by paged_attention_fwd


def _geometry(q, pool, tables, lengths, buffer_depth):
    if q.dim() != 3 or pool.dim() != 4 or tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError(
            f"paged attention takes q (S,H,hd), pool (n_pages,ps,2Kv,hd), "
            f"tables (S,max_pages), lengths (S,); got {tuple(q.shape)}, "
            f"{tuple(pool.shape)}, {tuple(tables.shape)}, "
            f"{tuple(lengths.shape)}")
    S, H, hd = q.shape
    _, page_size, kv2, hd_p = pool.shape
    n_kv = kv2 // 2
    if hd_p != hd or kv2 % 2 or n_kv == 0 or H % n_kv:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool.shape)} (need 2*Kv fused heads, "
                         f"H % Kv == 0, equal hd)")
    if tables.shape[0] != S or lengths.shape[0] != S:
        raise ValueError("tables/lengths need one row per sequence")
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    max_pages = tables.shape[1]
    depth = max(1, min(int(buffer_depth), max_pages))
    return S, H, hd, page_size, n_kv, H // n_kv, max_pages, depth


def paged_attention_torch(q, pool, tables, lengths, *, buffer_depth=2,
                          sm_scale=None):
    """Plain PyTorch paged decode attention (any device).

    Walks the block table in chunks of ``buffer_depth`` pages (gathered
    together, folded into the same online softmax the kernel keeps);
    masked positions are *selected* out, so their probability is exactly
    0 whatever the trash page holds."""
    S, H, hd, page_size, n_kv, rep, max_pages, depth = _geometry(
        q, pool, tables, lengths, buffer_depth)
    n_pages_tot = pool.shape[0]
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    n_chunks = -(-max_pages // depth)
    pad = n_chunks * depth - max_pages
    tbl = tables.long()
    if pad:
        # ragged chunk tail: pad with the trash page (the pool's last page
        # by construction, serve/paged.py) — masked below
        tbl = torch.nn.functional.pad(tbl, (0, pad), value=n_pages_tot - 1)
    dev = q.device
    lengths = lengths.to(dev)
    qh = q.reshape(S, n_kv, rep, hd).float() * sm_scale
    acc = torch.zeros((S, n_kv, rep, hd), dtype=torch.float32, device=dev)
    m = torch.full((S, n_kv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, n_kv, rep), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.tensor(0.0, dtype=torch.float32, device=dev)
    T = depth * page_size
    offs = torch.arange(T, device=dev)
    for c in range(n_chunks):
        kv = pool[tbl[:, c * depth:(c + 1) * depth]].float().reshape(
            S, T, n_kv, 2, hd)
        k, v = kv[..., 0, :], kv[..., 1, :]
        sc = torch.einsum("sgrh,stgh->sgrt", qh, k)           # (S,Kv,rep,T)
        mask = (c * T + offs)[None] < lengths[:, None]        # (S, T)
        mask = mask[:, None, None]
        sc = torch.where(mask, sc, neg)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), zero)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("sgrt,stgh->sgrh", p, v)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(S, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=256)
def _split_plan(S: int, Kv: int, max_pages: int, page_size: int, hd: int,
                itemsize: int) -> tuple[int, int]:
    """``(span, n_split)``: the kernel's split of every sequence into
    ``n_split = ceil(max_pages / span)`` runs of ``span`` pages, split i
    covering pages ``[i * span, min((i + 1) * span, max_pages))``.

    Static sizes only — never the lengths, which lie on the device and
    would cost a synchronisation to read.  A split reads at most
    ``SPLIT_BYTES`` of K and V (8 pages of 16 positions at hd 128 in
    bf16: at the serve path's decode lengths, up to ~1,100 positions,
    shorter chains of pages a block beat fuller blocks); where ``S * Kv``
    is too small for the grid to offer ``MIN_BLOCKS`` blocks with every
    split live, the span is halved until it does or is one page."""
    row = 2 * hd * itemsize                  # one position's K and V bytes
    span = min(max_pages, max(1, SPLIT_BYTES // (page_size * row)))
    while span > 1 and S * Kv * -(-max_pages // span) < MIN_BLOCKS:
        span //= 2
    return span, -(-max_pages // span)


@functools.lru_cache(maxsize=256)
def _ring_plan(page_size: int, hd: int, itemsize: int, depth: int,
               span: int) -> tuple[int, int]:
    """``(tile, slots)``: positions a ring slot holds and the ring's
    slots.  A tile is one page's K and V rows of a kv head, or, where a
    page does not fit in the block's shared memory (large pages at f32),
    as many positions of it as do.  ``slots`` is ``depth`` where that many
    tiles fit beside the split's table slice, else as many as fit (at
    least one), at most ``MAX_SLOTS`` and at most the split's tiles."""
    row = 2 * hd * itemsize
    budget = SMEM_BYTES - 4 * span - 16      # the table slice, alignment
    tile = max(1, min(page_size, budget // row))
    tiles = span * -(-page_size // tile)
    slots = max(1, min(depth, MAX_SLOTS, budget // (tile * row), tiles))
    return tile, slots


def paged_attention_fwd(q, pool, tables, lengths, *, buffer_depth=2,
                        sm_scale=None):
    """q: (S, H, hd) one decode token per sequence;
    pool: (n_pages, page_size, 2*Kv, hd) head-interleaved K/V pages;
    tables: (S, max_pages) int32 page ids (trash-padded past each
    sequence's pages); lengths: (S,) int32 valid tokens per sequence
    (``>= 1``).  Returns (S, H, hd) in q's dtype.

    On CUDA tensors this launches ``paged_attention_decode`` on the
    current stream (no synchronisation: ``lengths`` is read on the device
    only) and counts the call in ``LAUNCHES``; it raises on a type, shape
    or layout the kernel does not take.  The kernel is bound by the bytes
    of K and V it reads.  It splits every sequence into runs of pages
    (:func:`_split_plan`) so that a long sequence does not keep one block
    busy while the others idle, reads each split's slice of the block
    table once, streams the split's pages through a ring in shared memory
    and merges the splits' partial softmax states in a second kernel, in
    split order (bit-identical from call to call).  ``buffer_depth``
    (``>= 1``, clamped to ``max_pages``, as in the reference) is the ring's
    depth on the card: pages j+1 .. j+depth-1 are in flight while page j
    is computed, where that many fit (:func:`_ring_plan`).  CPU tensors
    take :func:`paged_attention_torch`, where it is the gather width."""
    global LAUNCHES
    _build.check_no_grad("paged_attention_fwd", q, pool)
    if not q.is_cuda:
        return paged_attention_torch(q, pool, tables, lengths,
                                     buffer_depth=buffer_depth,
                                     sm_scale=sm_scale)
    S, H, hd, page_size, n_kv, rep, max_pages, depth = _geometry(
        q, pool, tables, lengths, buffer_depth)
    for name, t in (("pool", pool), ("tables", tables),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or pool.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q and pool of "
                        f"one dtype; got {q.dtype}, {pool.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    if not tables.is_contiguous() or not lengths.is_contiguous():
        raise ValueError("tables and lengths must be contiguous")
    vec = 16 // q.element_size()          # elements per 16-byte load
    for name, t in (("q", q), ("pool", pool)):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows of hd must be dense and "
                             f"16-byte aligned (strides {t.stride()})")
    item = q.element_size()
    span, n_split = _split_plan(S, n_kv, max_pages, page_size, hd, item)
    tile, slots = _ring_plan(page_size, hd, item, depth, span)
    sm_scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty((S, H, hd), dtype=q.dtype, device=q.device)
    # each split's partial state: acc (hd), then m and l
    part = torch.empty((S, H, n_split, hd + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        code = _build.lib().paged_attention_decode(
            q.data_ptr(), pool.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            S, H, n_kv, hd, page_size, max_pages,
            span, n_split, tile, slots,
            q.stride(0), q.stride(1),
            pool.stride(0), pool.stride(1), pool.stride(2),
            out.stride(0), out.stride(1),
            float(sm_scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "paged_attention_decode")
    LAUNCHES += 1
    return out
