"""Per-request KV-cache accounting: fixed-size block allocation + recycling.

The serving engine admits a request only when the shared block pool can
cover its whole lifetime (prompt + ``max_new_tokens``), vLLM-style block
granularity with conservative up-front reservation: an admitted request
can never stall mid-decode waiting for memory, so the scheduler needs no
preemption path.  The pool being *shared* across slots is what makes
admission a memory decision, not just a slot decision — a free slot with
an exhausted pool stays empty, which is exactly the HBM-pressure behavior
the ``serve.load_sweep`` characterization wants observable.

Blocks are *physical* in the paged engine (DESIGN.md section 14): block
id ``b`` names page ``b`` of the preallocated ``[n_pages, block_size,
2*n_kv_heads, head_dim]`` pool tensor ``serve/paged.py`` materializes per
attention layer, so the table this allocator hands out is exactly the
page indirection the ragged paged-attention kernel walks.  One extra
*trash page* (id ``n_blocks``) sits past the allocatable pool: device
block tables are fixed-width, and rows are padded with the trash id so
unreserved pages have somewhere harmless to point — it is never
allocated, and reads from it are always masked by the per-sequence
length.  The dense per-slot engine (``paged=False``) keeps using the same
allocator as pure bookkeeping over its slot caches (DESIGN.md sec. 11).

The allocator is **device-count-blind**: every decision (``can_reserve``,
``reserve``, ``release``) is made in *logical token positions*, never in
bytes-per-device — whether the per-slot cache lives on one device or is
sequence-split over a tensor-parallel 'model' axis (``serve/step.py``),
the same workload produces the same block tables in the same order.
``placement`` is the one shard-aware view: it maps an owned table onto
the per-shard position ranges the sharded cache materializes, and the
property tests hold it to an exact partition for shard counts 1/2/4
while the decisions stay identical.

Invariants (property-tested in ``tests/test_serve_scheduler.py``):
every block is free or owned by exactly one request; a request's table
never shrinks while live; ``release`` returns every owned block, so after
a full sweep the pool is back to ``n_blocks`` free.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks covering ``n_tokens`` positions at ``block_size`` granularity."""
    assert block_size > 0
    return -(-max(n_tokens, 0) // block_size)


@dataclass
class KVBlockAllocator:
    """Fixed-size block pool with per-request block tables.

    ``n_shards`` records how many devices the fronted cache's sequence
    axis is split over (the engine passes its tensor-parallel width).  It
    is the default frame for ``placement`` and *nothing else*: no
    capacity or lifecycle decision may read it — the property tests
    drive identical workloads at shard counts 1/2/4 and hold every
    decision equal.
    """
    n_blocks: int
    block_size: int
    n_shards: int = 1
    _free: list = field(default_factory=list)       # LIFO free stack
    _tables: dict = field(default_factory=dict)     # rid -> [block ids]
    _sizes: dict = field(default_factory=dict)      # rid -> reserved tokens

    peak_used: int = 0                              # high-water mark

    def __post_init__(self):
        assert self.n_blocks > 0 and self.block_size > 0
        assert self.n_shards >= 1
        self._free = list(range(self.n_blocks - 1, -1, -1))

    # -- capacity ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def watermark(self) -> dict:
        """Pool pressure snapshot for the tracer/Record params: current
        and peak occupancy, in blocks and as a fraction of the pool."""
        return {"used": self.n_used, "free": self.n_free,
                "peak_used": self.peak_used,
                "peak_frac": self.peak_used / self.n_blocks}

    # -- physical frame (the paged pool's page space) ----------------------

    @property
    def trash_page(self) -> int:
        """Page id fixed-width table rows are padded with: one past the
        allocatable blocks, never reserved, reads always length-masked."""
        return self.n_blocks

    @property
    def n_pages(self) -> int:
        """Physical pages the pool tensor allocates (blocks + trash)."""
        return self.n_blocks + 1

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_reserve(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= len(self._free)

    # -- lifecycle ---------------------------------------------------------

    def reserve(self, rid: int, n_tokens: int) -> list[int]:
        """Allocate the full block table for a request's lifetime tokens."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds KV blocks")
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            raise ValueError(
                f"KV pool exhausted: request {rid} needs {need} blocks "
                f"({n_tokens} tokens at block_size={self.block_size}), "
                f"{len(self._free)} free of {self.n_blocks}")
        table = [self._free.pop() for _ in range(need)]
        self._tables[rid] = table
        self._sizes[rid] = max(n_tokens, 0)
        self.peak_used = max(self.peak_used, self.n_used)
        return list(table)

    def table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def tokens_for(self, rid: int) -> int:
        """Token count ``rid`` reserved for (its admission lifetime)."""
        return self._sizes[rid]

    def padded_table(self, rid: int, max_pages: int) -> list[int]:
        """``rid``'s table as a fixed-width device-table row: the owned
        page ids, then ``trash_page`` out to ``max_pages`` entries."""
        table = self._tables[rid]
        assert len(table) <= max_pages, (rid, len(table), max_pages)
        return table + [self.trash_page] * (max_pages - len(table))

    def free_table_row(self, max_pages: int) -> list[int]:
        """The table row of a slot holding no request: all trash."""
        return [self.trash_page] * max_pages

    def page_spans(self, rid: int) -> list[tuple[int, int, int]]:
        """``(page_id, token_start, token_end)`` per owned page — an exact
        partition of ``rid``'s reserved tokens (property-tested): spans
        are contiguous, disjoint, and cover ``[0, tokens_for(rid))``."""
        bs = self.block_size
        n = self._sizes[rid]
        return [(b, i * bs, min((i + 1) * bs, n))
                for i, b in enumerate(self._tables[rid])]

    def release(self, rid: int) -> int:
        """Return every block owned by ``rid`` to the pool."""
        if rid not in self._tables:
            raise KeyError(f"request {rid} holds no KV blocks")
        table = self._tables.pop(rid)
        self._sizes.pop(rid)
        self._free.extend(reversed(table))
        return len(table)

    # -- shard-aware view ----------------------------------------------------

    def placement(self, rid: int, cache_len: int,
                  n_shards: Optional[int] = None
                  ) -> list[tuple[int, int, int, int]]:
        """Map ``rid``'s table onto per-shard slices of the sharded cache.

        The i-th table entry covers the request's logical positions
        ``[i*block_size, (i+1)*block_size)``; when the per-slot cache
        sequence is split contiguously over ``n_shards`` devices (the
        tensor-parallel layout ``serve/step.py`` materializes), shard
        ``d`` holds positions ``[d*cache_len/n, (d+1)*cache_len/n)``.
        Returns ``(block_index, shard, local_start, length)`` covering
        each block's positions exactly once — purely a *view*: allocation
        never consults the shard count, which is the blindness the
        property tests pin.
        """
        if n_shards is None:
            n_shards = self.n_shards
        assert n_shards >= 1 and cache_len % n_shards == 0, \
            (cache_len, n_shards)
        per = cache_len // n_shards
        out = []
        for i in range(len(self._tables[rid])):
            # the last block may round past the physical cache; only
            # positions that exist in the sharded buffer are placed
            lo = i * self.block_size
            hi = min((i + 1) * self.block_size, cache_len)
            if lo >= hi:
                continue
            for d in range(lo // per, (hi - 1) // per + 1):
                s, e = max(lo, d * per), min(hi, (d + 1) * per)
                if s < e:
                    out.append((i, d, s - d * per, e - s))
        return out

    # -- invariants --------------------------------------------------------

    def check(self) -> None:
        """Assert the pool invariants (tests call this after every step)."""
        owned = [b for t in self._tables.values() for b in t]
        assert len(owned) == len(set(owned)), "block double-assigned"
        assert not set(owned) & set(self._free), "owned block also free"
        assert len(owned) + len(self._free) == self.n_blocks, \
            (len(owned), len(self._free), self.n_blocks)
        assert self.trash_page not in owned, "trash page allocated"
        assert set(self._sizes) == set(self._tables), "size/table drift"
        for rid, table in self._tables.items():
            assert len(table) == self.blocks_for(self._sizes[rid]), \
                (rid, len(table), self._sizes[rid])
