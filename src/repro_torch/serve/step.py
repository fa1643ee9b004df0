"""Serving steps and cells, single device.

Counterpart of ``repro/serve/step.py``: ``make_prefill_step`` and
``make_decode_step`` are the static engine's two steps (a batched prefill
and a lockstep decode at one scalar position); ``make_continuous_cells``
and ``make_paged_cells`` package the three cells the continuous engine
drives — batch-1 prefill, batched slot decode, slot insertion.  PyTorch
runs eagerly, so a step or cell is a plain closure under
``torch.no_grad()``; where the reference donates the cache or pool buffer
to a compiled step, the steps and cells here update it **in place** and
return the same object.

The reference gets a per-slot position by vmapping a batch-1 decode step
over slot-stacked caches; here the decode cells are written batched, with
an ``(n_slots,)`` index vector.  Tensor-parallel cells (``mesh`` /
``tp_size > 1``) arrive with the tensor-parallel slice of the port
(ROADMAP Queue 1 item 9b); the reference's sharding contexts have no
counterpart on one device, so the steps come without one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, registry
from repro_torch.runtime import resolve_device
from repro_torch.serve import paged


def _reject_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel serving cells (mesh / tp_size > 1) are a later "
            "slice of the port (ROADMAP Queue 1 item 9b); this build is "
            "single-device")


def check_tokens_only(cfg: ArchConfig) -> None:
    """The serving steps and cells take a batch of ``tokens`` only, as the
    reference's engines pass; an encoder-decoder arch needs ``frames`` and
    a VLM ``patches`` beside them, so either is refused here, up front (the
    reference's engines fail later, inside the model)."""
    extra = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if extra:
        raise ValueError(
            f"{cfg.name}: the serving engines pass only tokens, and the "
            f"{cfg.family} family needs {extra} as well; run it through "
            f"models/registry.prefill and decode_step with a batch that "
            f"carries them")


def _no_grad(fn):
    def cell(*args):
        with torch.no_grad():
            return fn(*args)
    return cell


def make_prefill_step(cfg: ArchConfig, mesh=None, cache_len=None):
    """``step(params, batch) -> (last logits (B, 1, V), caches)``: one
    prefill of ``batch["tokens"] (B, S)`` whose caches hold ``cache_len``
    positions (default: exactly ``S``)."""
    _reject_mesh(mesh)
    check_tokens_only(cfg)

    def step(params, batch):
        return registry.prefill(cfg, params, batch, cache_len=cache_len)
    return _no_grad(step)


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``step(params, caches, batch) -> (logits (B, 1, V), caches)``: one
    decode token per row at ``batch["index"]`` (a scalar or ``(B,)``); the
    caches are written in place and returned."""
    _reject_mesh(mesh)
    check_tokens_only(cfg)

    def step(params, caches, batch):
        return registry.decode_step(cfg, params, batch, caches)
    return _no_grad(step)


class _Cells:
    """Shared placements of both cell kinds."""
    tp_size = 1
    n_devices = 1

    def put_params(self, params):
        return common.tree_map(lambda a: a.to(self.device), params)


@dataclass
class ServeCells(_Cells):
    """The dense engine's three cells.

    Slot caches: the family's decode caches with ``n_slots`` as the batch
    axis (axis 1, after the group axis) of ``registry.decode_step`` — for
    attention ``{"l{i}": {"k", "v": (G, n_slots, L, Kv, hd),
    "pos": (G, n_slots, L)}}`` with ``L = cache_len``, or the window for a
    sliding-window arch (a ring), for RWKV-6 ``{"l{i}": {"tm":
    {"shift": (G, n_slots, 1, D), "wkv": (G, n_slots, H, dh, dh)},
    "cm": (G, n_slots, 1, D)}}``.
    """
    cfg: ArchConfig
    n_slots: int
    cache_len: int
    device: torch.device
    prefill: Callable        # (params, tokens[1,S]) -> (logits, base caches)
    decode: Callable         # (params, tok[slot,1], idx[slot], slot caches)
    insert: Callable         # (slot caches, base caches, slot) -> slot caches

    def init_slot_caches(self):
        return registry.init_decode_caches(self.cfg, self.n_slots,
                                           self.cache_len, self.device)


@dataclass
class PagedServeCells(_Cells):
    """The paged engine's three cells.

    The KV state is ONE physical page pool per layer (``serve/paged.py``)
    and the slot dimension lives in the block *tables* — decode takes
    every slot's token/position plus the (n_slots, max_pages) table array
    and writes the pool in place.
    """
    cfg: ArchConfig
    n_slots: int
    cache_len: int
    block_size: int
    n_pages: int
    buffer_depth: int
    device: torch.device
    prefill: Callable        # (params, tokens[1,S]) -> (logits, base caches)
    decode: Callable         # (params, tok[S,1], idx[S], pool, tables[S,mp])
    insert: Callable         # (pool, base caches, table_row[mp]) -> pool

    @property
    def max_pages(self) -> int:
        return self.cache_len // self.block_size

    def init_pool(self):
        return paged.init_kv_pool(self.cfg, self.n_pages, self.block_size,
                                  self.device)


def make_paged_cells(cfg: ArchConfig, n_slots: int, cache_len: int,
                     block_size: int, n_pages: int, mesh=None,
                     buffer_depth: int = 2,
                     device="cuda") -> PagedServeCells:
    """Build the paged engine's cells on ``device`` (default: the card;
    raises where there is none).

    ``n_pages`` counts *physical* pages (the allocator's blocks plus its
    trash page); ``buffer_depth`` is fixed into the decode cell as the
    knob of the paged-attention walk.  Prefill returns a cache of exactly
    the prompt's length (no padding to ``cache_len``): insertion writes
    only the pages the prompt covers.
    """
    _reject_mesh(mesh)
    check_tokens_only(cfg)
    dev = resolve_device(device)
    paged.check_paged(cfg, cache_len, block_size)
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")

    def _prefill(params, tokens):
        return registry.prefill(cfg, params, {"tokens": tokens})

    def _decode(params, tokens, index, pool, tables):
        return paged.paged_decode_step(cfg, params, tokens, index, pool,
                                       tables, buffer_depth=buffer_depth)

    def _insert(pool, base_caches, table_row):
        return paged.insert_pages(cfg, pool, base_caches, table_row)

    return PagedServeCells(
        cfg=cfg, n_slots=n_slots, cache_len=cache_len,
        block_size=block_size, n_pages=n_pages, buffer_depth=buffer_depth,
        device=dev, prefill=_no_grad(_prefill), decode=_no_grad(_decode),
        insert=_no_grad(_insert))


def make_continuous_cells(cfg: ArchConfig, n_slots: int, cache_len: int,
                          mesh=None, device="cuda") -> ServeCells:
    """Build the dense engine's cells on ``device`` (default: the card;
    raises where there is none)."""
    _reject_mesh(mesh)
    check_tokens_only(cfg)
    dev = resolve_device(device)

    def _prefill(params, tokens):
        return registry.prefill(cfg, params, {"tokens": tokens})

    def _decode(params, tokens, index, caches):
        return registry.decode_step(
            cfg, params, {"tokens": tokens, "index": index}, caches)

    def _insert(caches, base_caches, slot):
        # every leaf's slot row takes the prefill's row 0 (the reference's
        # tree-mapped insert): all of a recurrent state; the prefill's
        # slots of an attention cache, whose tail is then marked empty
        # (pos = -1) — stale keys past them are unreachable.  A windowed
        # layer's prefill hands over min(S, window) slots already in ring
        # order (slot = position % window), so they go to the ring's
        # first slots as they are; the engine's lifetime check stays on
        # logical positions, so cache_len may pass the window
        def put(cache, base):
            if isinstance(cache, dict):
                for key in cache:
                    put(cache[key], base[key])
                if "pos" in cache:
                    cache["pos"][:, slot, base["pos"].shape[2]:] = -1
                return
            cover = tuple(slice(0, n) for n in base.shape[2:])
            cache[(slice(None), slot) + cover] = base[:, 0].to(cache.dtype)

        put(caches, base_caches)
        return caches

    return ServeCells(
        cfg=cfg, n_slots=n_slots, cache_len=cache_len, device=dev,
        prefill=_no_grad(_prefill), decode=_no_grad(_decode),
        insert=_no_grad(_insert))
