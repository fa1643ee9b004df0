"""Serving steps and cells, on one device or over a ``model`` axis.

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
an ``(n_slots,)`` index vector.

**Tensor parallelism.**  Every factory takes the port's ``mesh``
(``launch/mesh.py``): the model then runs over its ``model`` axis
(``models/transformer.py``: every family the engines take — dense, moe,
ssm, hybrid), emulated in this process or one process a rank.
``put_params`` splits a full parameter tree into the held ranks' shards
(``parallel/sharding.shard_params``; shards already split pass as they
are), the slot caches and the page pool hold each rank's local kv heads
(a recurrent state at its RWKV-6 heads or Mamba channels), and
``tp_size`` / ``n_devices`` report the mesh.  Where the reference pins
the compiled decode step's collectives from its HLO,
``decode_collective_counts`` runs one decode tick on scratch state and
returns the exchanges the axis counted, by kind (``{}`` without a mesh):
the port's own schedule, not the reference's trip-count-weighted HLO
count.  ``registry.decode_exchanges`` derives it from the layers: for
``L`` layers, dense and moe ``2 L + 1`` all-reduces and one all-gather;
ssm ``2 L + 1`` and ``L + 1`` (each RWKV-6 layer gathers ``sigmoid(r) *
kv``); hybrid 3 all-reduces a Mamba layer and 2 an attention layer, plus
the embedding's; the embedding's all-reduce and the logits' all-gather
only where the axis splits the vocabulary.  On a *leading* mesh (rank 0
of a rank-process engine, ``serve/ranks.py``) each cell first sends its
call and the host-side arguments to the other ranks, which run the same
cell on their shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, registry, transformer
from repro_torch.parallel import sharding
from repro_torch.runtime import resolve_device
from repro_torch.serve import paged


def _axis(cfg: ArchConfig, mesh):
    """The mesh's model axis (``None`` without a mesh), once the family
    and the head counts are checked against it."""
    if mesh is None:
        return None
    transformer.check_tp(cfg, mesh.tp_size)
    return mesh.axis


def _host(a):
    return a.cpu() if torch.is_tensor(a) else a


def _lead(mesh, op: str, fn, host: tuple = ()):
    """``fn``, which on a leading mesh first broadcasts ``(op, the
    arguments at positions host)`` to the other ranks."""
    if mesh is None or not mesh.lead:
        return fn

    def cell(*args):
        mesh.axis.broadcast_object((op,) + tuple(_host(args[i])
                                                 for i in host))
        return fn(*args)
    return cell


def _announce(mesh, kind: str, cfg: ArchConfig, kwargs: dict) -> None:
    """On a leading mesh: have the other ranks build the same cells."""
    if mesh is not None and mesh.lead:
        mesh.axis.broadcast_object(("build", kind, cfg, kwargs))


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
    positions (default: exactly ``S``).  Over a mesh, ``params`` are the
    held ranks' shards and so are the caches."""
    check_tokens_only(cfg)
    axis = _axis(cfg, mesh)

    def step(params, batch):
        return registry.prefill(cfg, params, batch, cache_len=cache_len,
                                axis=axis)
    return _no_grad(step)


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``step(params, caches, batch) -> (logits (B, 1, V), caches)``: one
    decode token per row at ``batch["index"]`` (a scalar or ``(B,)``); the
    caches are written in place and returned."""
    check_tokens_only(cfg)
    axis = _axis(cfg, mesh)

    def step(params, caches, batch):
        return registry.decode_step(cfg, params, batch, caches, axis=axis)
    return _no_grad(step)


def put_params(cfg: ArchConfig, mesh, params, device):
    """``params`` on ``device``: as they are without a mesh; over one, the
    held ranks' shards (a full tree is split, ``sharding.Shards`` pass)."""
    axis = _axis(cfg, mesh)
    moved = common.tree_map(lambda a: a.to(device), params)
    if axis is None:
        return moved
    if isinstance(params, sharding.Shards):
        if (params.n, params.held) != (axis.n, axis.held):
            raise ValueError(f"shards of ranks {params.held} of "
                             f"{params.n}; this mesh holds {axis.held} of "
                             f"{axis.n}")
        out = sharding.Shards(moved)
        out.n, out.held = params.n, params.held
        return out
    return sharding.shard_params(moved, axis.n, axis.held,
                                 sharding.head_counts(cfg))


class _Cells:
    """Shared placements of both cell kinds."""

    @property
    def axis(self):
        return None if self.mesh is None else self.mesh.axis

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.tp_size

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def put_params(self, params):
        return put_params(self.cfg, self.mesh, params, self.device)

    def decode_collective_counts(self, params) -> dict:
        """The exchanges of one decode tick on scratch state, by kind
        (``all-reduce``, ``all-gather``); ``{}`` without a mesh.  Equal
        to ``registry.decode_exchanges`` of the config and the axis."""
        if self.axis is None:
            return {}
        before = dict(self.axis.exchanges)
        self.count(params)
        return {k.replace("_", "-"): v - before.get(k, 0)
                for k, v in sorted(self.axis.exchanges.items())
                if v - before.get(k, 0)}


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
    count: Callable          # (params) -> one decode tick on scratch caches
    mesh: Optional[object] = None

    def init_slot_caches(self):
        return registry.init_decode_caches(self.cfg, self.n_slots,
                                           self.cache_len, self.device,
                                           axis=self.axis)


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
    count: Callable          # (params) -> one decode tick on a scratch pool
    mesh: Optional[object] = None

    @property
    def max_pages(self) -> int:
        return self.cache_len // self.block_size

    def init_pool(self):
        return paged.init_kv_pool(self.cfg, self.n_pages, self.block_size,
                                  self.device, axis=self.axis)


def make_paged_cells(cfg: ArchConfig, n_slots: int, cache_len: int,
                     block_size: int, n_pages: int, mesh=None,
                     buffer_depth: int = 2,
                     device="cuda") -> PagedServeCells:
    """Build the paged engine's cells on ``device`` (default: the card;
    raises where there is none), over ``mesh`` where given.

    ``n_pages`` counts *physical* pages (the allocator's blocks plus its
    trash page); ``buffer_depth`` is fixed into the decode cell as the
    knob of the paged-attention walk.  Prefill returns a cache of exactly
    the prompt's length (no padding to ``cache_len``): insertion writes
    only the pages the prompt covers.
    """
    check_tokens_only(cfg)
    dev = resolve_device(device)
    paged.check_paged(cfg, cache_len, block_size)
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    axis = _axis(cfg, mesh)
    _announce(mesh, "paged", cfg, dict(
        n_slots=n_slots, cache_len=cache_len, block_size=block_size,
        n_pages=n_pages, buffer_depth=buffer_depth))

    def _prefill(params, tokens):
        return registry.prefill(cfg, params, {"tokens": tokens}, axis=axis)

    def _decode(params, tokens, index, pool, tables):
        return paged.paged_decode_step(cfg, params, tokens, index, pool,
                                       tables, buffer_depth=buffer_depth,
                                       axis=axis)

    def _insert(pool, base_caches, table_row):
        return paged.insert_pages(cfg, pool, base_caches, table_row,
                                  axis=axis)

    def _count(params):
        # every slot idle at position 0 of a one-page scratch pool
        scratch = paged.init_kv_pool(cfg, 1, block_size, dev, axis=axis)
        zeros = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        tables = torch.zeros((n_slots, cache_len // block_size),
                             dtype=torch.int32, device=dev)
        _decode(params, zeros[:, None], zeros, scratch, tables)

    return PagedServeCells(
        cfg=cfg, n_slots=n_slots, cache_len=cache_len,
        block_size=block_size, n_pages=n_pages, buffer_depth=buffer_depth,
        device=dev, mesh=mesh,
        prefill=_lead(mesh, "prefill", _no_grad(_prefill), (1,)),
        decode=_lead(mesh, "decode", _no_grad(_decode), (1, 2, 4)),
        insert=_lead(mesh, "insert", _no_grad(_insert), (2,)),
        count=_lead(mesh, "count", _no_grad(_count)))


def make_continuous_cells(cfg: ArchConfig, n_slots: int, cache_len: int,
                          mesh=None, device="cuda") -> ServeCells:
    """Build the dense engine's cells on ``device`` (default: the card;
    raises where there is none), over ``mesh`` where given."""
    check_tokens_only(cfg)
    dev = resolve_device(device)
    axis = _axis(cfg, mesh)
    _announce(mesh, "dense", cfg, dict(n_slots=n_slots, cache_len=cache_len))

    def _prefill(params, tokens):
        return registry.prefill(cfg, params, {"tokens": tokens}, axis=axis)

    def _decode(params, tokens, index, caches):
        return registry.decode_step(
            cfg, params, {"tokens": tokens, "index": index}, caches,
            axis=axis)

    def _insert(caches, base_caches, slot):
        # every leaf's slot row takes the prefill's row 0 (the reference's
        # tree-mapped insert): all of a recurrent state; the prefill's
        # slots of an attention cache, whose tail is then marked empty
        # (pos = -1) — stale keys past them are unreachable.  A windowed
        # layer's prefill hands over min(S, window) slots already in ring
        # order (slot = position % window), so they go to the ring's
        # first slots as they are; the engine's lifetime check stays on
        # logical positions, so cache_len may pass the window.  Over a
        # mesh, each held rank's caches take its own prefill's
        def put(cache, base):
            if isinstance(cache, dict):
                for key in cache:
                    put(cache[key], base[key])
                if "pos" in cache:
                    cache["pos"][:, slot, base["pos"].shape[2]:] = -1
                return
            cover = tuple(slice(0, n) for n in base.shape[2:])
            cache[(slice(None), slot) + cover] = base[:, 0].to(cache.dtype)

        if axis is None:
            put(caches, base_caches)
        else:
            for j in range(len(axis.held)):
                put(common.tree_index(caches, j),
                    common.tree_index(base_caches, j))
        return caches

    def _count(params):
        # every slot idle at position 0 of one-position scratch caches
        scratch = registry.init_decode_caches(cfg, n_slots, 1, dev,
                                              axis=axis)
        zeros = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        _decode(params, zeros[:, None], zeros, scratch)

    return ServeCells(
        cfg=cfg, n_slots=n_slots, cache_len=cache_len, device=dev,
        mesh=mesh,
        prefill=_lead(mesh, "prefill", _no_grad(_prefill), (1,)),
        decode=_lead(mesh, "decode", _no_grad(_decode), (1, 2)),
        insert=_lead(mesh, "insert", _no_grad(_insert), (2,)),
        count=_lead(mesh, "count", _no_grad(_count)))
