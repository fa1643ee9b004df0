"""Physical block-paged KV: pool tensors, page insertion, paged decode.

Counterpart of ``repro/serve/paged.py``.  ONE preallocated pool tensor per
attention layer-in-group — shape ``(G, n_pages, block_size, 2*Kv, hd)``
(group dim, then pages) with K/V *head-interleaved* on the fused head
axis (``[k0, v0, k1, v1, ...]``): a page is the unit of allocation
(``serve/kv.py`` block ids ARE page ids).  Requests own pages through the
allocator's block tables; the device sees fixed-width table rows padded
with the trash page (id ``n_blocks``), so the decode step's shapes never
depend on how many pages a request holds.

* ``init_kv_pool`` — the pool dict (zeros; one leaf per layer-in-group,
  all layers share one block table).
* ``insert_pages`` — admission: write a batch-1 prefill cache into the
  request's pages with ONE indexed write per layer.
* ``paged_decode_step`` — the batched decode step over all slots: project
  q/k/v per slot, write each slot's new token into its current page (one
  indexed write per layer), then attend over the block table via
  ``kernels/ops.paged_attention``.

An MoE layer's FFN runs over the decode batch of every slot (its aux
losses are dropped, as in the reference).  The pool is updated **in place** (the reference donates the pool buffer to
its compiled step to the same end); the functions return it for symmetry
with the reference's signatures.  Paged serving supports all-attention
families with full (non-windowed) attention.

Over a ``model`` axis (``axis=``: the dense and moe families) each held
rank has a pool of its own at its local kv heads — the reference's pool
spec splits the fused head axis over ``model`` — with the rank on dim 0:
``{"l{i}":
(ranks, G, n_pages, bs, 2*Kv_local, hd)}``.  Every rank shares the block
tables; insertion writes each rank's heads into its pool, and the
paged-attention kernel runs in each rank on its local heads
(``models/transformer.py`` has the rest of the tensor-parallel layer: an
MoE layer's experts split over the ranks, ``models/moe.moe_parts``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, common, transformer


def paged_supported(cfg: ArchConfig) -> bool:
    """Every layer an attention layer, no sliding window."""
    return (cfg.family != "ssm" and cfg.sliding_window == 0
            and all(cfg.is_attn_layer(i) for i in range(cfg.layer_group)))


def check_paged(cfg: ArchConfig, cache_len: int, block_size: int) -> None:
    if not paged_supported(cfg):
        raise ValueError(
            f"paged KV serving needs an all-attention, non-windowed arch; "
            f"{cfg.name} (family={cfg.family}, "
            f"sliding_window={cfg.sliding_window}) keeps the dense path")
    if cache_len % block_size:
        raise ValueError(
            f"paged KV needs cache_len divisible by block_size "
            f"({cache_len} % {block_size} != 0): pages tile the cache")


def fuse_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Interleave K/V along the head axis: (..., Kv, hd) x2 ->
    (..., 2*Kv, hd) ordered [k0, v0, k1, v1, ...]."""
    stacked = torch.stack([k, v], dim=-2)       # (..., Kv, 2, hd)
    return stacked.reshape(stacked.shape[:-3]
                           + (2 * k.shape[-2], k.shape[-1]))


def init_kv_pool(cfg: ArchConfig, n_pages: int, block_size: int, device,
                 axis=None):
    """Zeroed pool dict: ``{"l{i}": (G, n_pages, bs, 2*Kv, hd)}``; with
    ``axis``, each held rank's at its local kv heads, ranks on dim 0."""
    shape = (cfg.num_groups(), n_pages, block_size, 2 * cfg.num_kv_heads,
             cfg.hd)
    if axis is not None:
        transformer.check_tp(cfg, axis.n)
        shape = (len(axis.held),) + shape[:3] + (
            2 * attention.local_kv_heads(cfg, axis.n), cfg.hd)
    return {f"l{i}": torch.zeros(shape, dtype=common.dtype_of(cfg),
                                 device=device)
            for i in range(cfg.layer_group)}


def pool_geometry(cfg: ArchConfig, n_pages: int, block_size: int) -> dict:
    """Physical footprint of the pool ``init_kv_pool`` materializes, for
    the tracer's pool-geometry instant: page count, bytes per page across
    every layer-group leaf, and total pool bytes."""
    itemsize = torch.empty((), dtype=common.dtype_of(cfg)).element_size()
    page_bytes = (cfg.num_groups() * block_size * 2 * cfg.num_kv_heads
                  * cfg.hd * itemsize) * cfg.layer_group
    return {"n_pages": n_pages, "block_size": block_size,
            "page_bytes": page_bytes, "pool_bytes": page_bytes * n_pages}


def insert_pages(cfg: ArchConfig, pool, base_caches, table_row, axis=None):
    """Write a batch-1 prefill cache into the pages of ``table_row``.

    ``base_caches``: the prefill cell's output (``{"l{i}": {"k": (G, 1,
    S, Kv, hd), ...}}``, S = the cached positions); ``table_row``:
    (max_pages,) int page ids, trash-padded.  One indexed in-place write
    per layer: position t goes to ``(table_row[t // bs], t % bs)``.  Only
    the positions the cache holds are written — where the reference
    rewrites every page of the row with zero padding, the stale tail of
    the last page here stays as it was; it lies past the sequence length,
    where decode never reads unmasked and each new token is written
    before it is attended, so token streams do not change.  With
    ``axis``, each held rank's cache goes into its own pool.
    """
    if axis is not None:
        for j in range(len(axis.held)):
            insert_pages(cfg, common.tree_index(pool, j),
                         common.tree_index(base_caches, j), table_row)
        return pool
    bs = next(iter(pool.values())).shape[2]
    for key, pool_l in pool.items():
        cache = base_caches[key]
        fused = fuse_kv(cache["k"][:, 0], cache["v"][:, 0])  # (G,S,2Kv,hd)
        S = fused.shape[1]
        if -(-S // bs) > table_row.shape[0]:
            raise ValueError(f"{S} cached positions need more than the "
                             f"{table_row.shape[0]} pages of a table row")
        t = torch.arange(S, device=fused.device)
        pages = table_row.long()[t // bs]
        pool_l[:, pages, t % bs] = fused.to(pool_l.dtype)
    return pool


# ---------------------------------------------------------------------------
# paged decode step
# ---------------------------------------------------------------------------

def _paged_attn_decode(cfg: ArchConfig, p: dict, x, pool_l, idx, tables, *,
                       buffer_depth):
    """Batched one-token paged attention for one layer.

    x: (S, 1, D) normed activations for every slot; pool_l: (n_pages, bs,
    2*Kv, hd) — one group's view of the pool; idx: (S,) per-slot
    positions; tables: (S, max_pages) int32.  Returns y (S, 1, D); pool_l
    is written in place.  Mirrors ``models/attention.attn_decode``
    (projection, rope at ``idx``, write-then-attend, output projection)
    with the cache swapped for pool pages.
    """
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    S = x.shape[0]
    bs = pool_l.shape[1]

    q = common.dense(p["q"], x).reshape(S, 1, H, hd)
    k = common.dense(p["k"], x).reshape(S, 1, Kv, hd)
    v = common.dense(p["v"], x).reshape(S, 1, Kv, hd)
    pos = idx[:, None]                                   # (S, 1)
    q = common.apply_rope(q, pos, cfg.rope_theta)
    k = common.apply_rope(k, pos, cfg.rope_theta)

    # write each slot's new token into its current page: ONE scatter.
    # Free slots sit at idx 0 with all-trash tables, so they all write
    # position 0 of the trash page — duplicate indices, whose winner is
    # unspecified.  That is harmless: the trash page is never read
    # unmasked by a live slot, and a free slot's own output (garbage
    # either way) is masked on the host.
    fused = fuse_kv(k[:, 0], v[:, 0]).to(pool_l.dtype)   # (S, 2Kv, hd)
    idx_l = idx.long()
    pages = tables.long().gather(1, (idx_l // bs)[:, None])[:, 0]
    pool_l[pages, idx_l % bs] = fused

    out = kops.paged_attention(q[:, 0], pool_l, tables,
                               (idx + 1).to(torch.int32),
                               buffer_depth=buffer_depth)    # (S, H, hd)
    return common.dense(p["o"], out.reshape(S, 1, H * hd))


def _paged_layer_decode(cfg: ArchConfig, p: dict, x, pool_l, idx, tables, *,
                        buffer_depth):
    """``transformer._layer_decode`` with paged attention."""
    h = common.norm_apply(cfg, p["norm1"], x)
    y = _paged_attn_decode(cfg, p["attn"], h, pool_l, idx, tables,
                           buffer_depth=buffer_depth)
    if cfg.parallel_block:
        return x + y + transformer._ffn(cfg, p, h)[0]
    x = x + y
    h2 = common.norm_apply(cfg, p["norm2"], x)
    return x + transformer._ffn(cfg, p, h2)[0]


def paged_decode_step(cfg: ArchConfig, params: dict, tokens, idx, pool,
                      tables, *, buffer_depth=2, axis=None):
    """One decode step for every slot against the paged pool.

    tokens: (S, 1) int; idx: (S,) int32 per-slot positions; pool: the
    ``init_kv_pool`` dict (written in place); tables: (S, max_pages)
    int32.  Returns (logits (S, 1, V) f32, pool).
    """
    if axis is not None:
        return _paged_decode_tp(cfg, params, tokens, idx, pool, tables,
                                buffer_depth, axis)
    x = transformer._embed(params, tokens)               # (S, 1, D)
    for g in range(cfg.num_groups()):
        gp = common.tree_index(params["layers"], g)
        for i in range(cfg.layer_group):
            x = _paged_layer_decode(cfg, gp[f"l{i}"], x, pool[f"l{i}"][g],
                                    idx, tables, buffer_depth=buffer_depth)
    x = common.norm_apply(cfg, params["final_norm"], x)
    return transformer._logits(cfg, params, x), pool


def _paged_decode_tp(cfg, params, tokens, idx, pool, tables, buffer_depth,
                     axis):
    """``paged_decode_step`` over a ``model`` axis: each held rank attends
    through its own pool at its local heads."""
    def attend(lcfg, lp, h, j, g, i):
        return _paged_attn_decode(lcfg, lp, h, pool[f"l{i}"][j][g], idx,
                                  tables, buffer_depth=buffer_depth), None

    ranks, x, _, _ = transformer._backbone_tp(cfg, params, tokens, axis,
                                              attend)
    return transformer._logits_tp(cfg, ranks, x, axis), pool
