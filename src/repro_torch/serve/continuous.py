"""Continuous-batching serve engine: slot admission + per-slot decode.

The static ``engine.Engine`` runs one batch to completion; this engine
keeps a fixed set of decode *slots* live and admits queued requests as
slots (and KV blocks) free, interleaving each admission's prefill with
the in-flight decode batch — a late request joins mid-stream instead of
waiting for the current batch to drain.

Mechanics (DESIGN.md section 11):

* **Per-slot caches.**  The slot axis is the batch axis of the decode
  caches, and every slot carries its *own* position: the decode step
  takes an ``(n_slots,)`` index vector (the reference vmaps a batch-1
  step over slot-stacked caches to the same end).  The dense path is
  blind to what the caches hold: attention K/V rows, or the recurrent
  state of an RWKV-6 model (which ignores the index).
* **Admission.**  ``SlotScheduler`` + ``KVBlockAllocator``: FIFO, a
  request is admitted only when a slot is free AND the shared block pool
  covers prompt + ``max_new_tokens`` (conservative reservation, no
  preemption).  Prefill runs batch-1 at the exact prompt length (no
  left-padding — pad tokens would attend), and its caches are written
  into the slot with one in-place write per cache leaf.
* **Latency decomposition.**  Every request's lifecycle stamps (queue
  wait / TTFT / per-token decode) are taken on the engine clock; the
  clock is injectable (``clock=...``) so tests drive arrivals on virtual
  time and the ``serve.load_sweep`` experiment uses the wall clock.
* **Idle hook.**  When a loop iteration has nothing to decode or admit
  (traffic gap), ``run(..., idle_hook=...)`` invokes the hook — the
  load-sweep experiment mounts a probe kernel there and reports its
  achieved FLOP/s as the compute headroom left beside the traffic, the
  paper's question transposed to serving.

* **Tensor parallelism.**  ``tp_size=N`` builds an emulated ``(1, N)``
  mesh (``launch/mesh.py``: N ranks of a ``model`` axis in this
  process), and an explicit ``mesh=``
  wins, as in the reference: the cells then run the model over the
  mesh's axis (``serve/step.py``; the dense engine takes the dense, moe,
  ssm and hybrid families, the paged engine the all-attention ones).  A
  mesh whose axis is a rank group runs the engine in rank 0 and the same
  cells in every other rank
  (``serve/ranks.py``).  The host loop, the scheduler and the allocator
  (``n_shards=tp_size`` frames only its placement view) are unchanged,
  so the token streams are the single-device engine's at f32.

* **Device.**  ``device="cuda"`` by default — the engine raises where
  there is no card; tests pass ``device="cpu"``.  The two host reads of
  device results (the ``int(argmax)`` after prefill, the host copy of the
  decode argmax) are the synchronisation points that make
  ``t_first_token`` and the per-token stamps honest on CUDA: each comes
  before the clock read that stamps it.  KV state (slot caches, page
  pool) is updated in place where the reference donates buffers.

* **Paged KV (``paged=True``).**  The per-slot caches are replaced by the
  physical page pool of ``serve/paged.py``: the allocator's block tables
  become device arrays (one fixed-width row per slot, trash-padded), slot
  insertion scatters the prefill cache into the request's pages, and the
  decode step attends through the ragged paged-attention kernel
  (``kernels/paged_attention.py``).  The host loop, scheduler and
  allocator decisions are IDENTICAL to the dense engine — paged is
  purely a KV-residency change — so greedy token streams equal the dense
  engine's at f32 (``tests/test_torch_serve.py``).

Inactive slots decode garbage (fixed shapes keep one compiled step); the
results are masked on the host and every admission overwrites the whole
slot cache, so garbage never leaks into a live request.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.logbuf import BoundedLog
from repro_torch.serve.kv import KVBlockAllocator, blocks_for
from repro_torch.serve.scheduler import ServeRequest, SlotScheduler
from repro_torch.serve.step import make_continuous_cells, make_paged_cells


@dataclass(frozen=True)
class StepEvent:
    """One working engine-loop iteration, for observability (tests assert
    on it).  Idle iterations (traffic gaps) are not logged — they are
    counted in ``ContinuousEngine.idle_iters`` — so ``step_log`` growth is
    bounded by work done, not by wall time spent waiting."""
    now: float
    admitted: tuple            # rids whose prefill ran this iteration
    decoded: tuple             # rids advanced by this iteration's decode step
    queued: int                # requests still waiting after admission


class ContinuousEngine:
    """Slot-based continuous batching over the family decode step.

    ``n_slots`` is the decode batch width; ``cache_len`` the per-slot KV
    capacity; ``block_size``/``kv_blocks`` configure the shared block
    pool (default: exactly enough blocks to cover every slot, so memory
    admission binds only when configured tighter than the slots).
    """

    IDLE_SLEEP_S = 5e-4   # traffic-gap wait when no idle_hook is mounted:
    #                       well under a decode step, so arrival latency
    #                       stays negligible while the loop stops spinning

    def __init__(self, cfg: ArchConfig, params, *, n_slots: int = 4,
                 cache_len: int = 128, block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_per_step: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 fabric=None, mesh=None, tp_size: int = 1,
                 paged: bool = False, page_buffer_depth: int = 2,
                 slo=None, tracer=None, log_cap: Optional[int] = None,
                 debug: bool = False, device="cuda"):
        # fabric: an optional duck-typed degraded-wire hook (is_clean,
        # stall_admit, stall_decode, stalled_s, condition.name —
        # repro_torch.fabric.ServeFabric) — the enforcement point for
        # serving.  Its stall_admit runs before each admitted prefill
        # (TTFT inflates, queue_wait does not) and stall_decode inside
        # each decode tick's timing window (TPOT inflates).  None or a
        # clean condition changes nothing: token streams stay identical.
        # Both hooks are host-side.
        #
        # mesh / tp_size: tensor-parallel decode.  ``tp_size=N`` builds a
        # (1, N) ("data", "model") mesh of N emulated ranks; an explicit
        # ``mesh=`` (launch/mesh.py, emulated or a rank group) wins.
        #
        # slo: an optional scheduler.SLOPolicy — admission goes
        # priority-aware with shed + preemption (DESIGN.md section 15).
        # None keeps exact FIFO.  Swappable between runs via
        # ``engine.scheduler.slo``.
        #
        # paged / page_buffer_depth: physical paged-KV serving (module
        # docstring).  debug=True re-checks the allocator invariants on
        # every slot recycle (KVBlockAllocator.check) — cheap at serve
        # scale, and it catches table corruption at the step that caused
        # it rather than at teardown.
        #
        # tracer: repro_torch.obs span tracing — None resolves via the
        # ``obs_trace`` runtime knob, then the thread-local current tracer
        # (CLI --trace-out), then the disabled null tracer.  Every engine
        # emission passes a timestamp the loop already computed (the
        # virtual-clock contract: a traced run makes exactly the same
        # clock calls as an untraced one, so token streams stay
        # bit-identical — DESIGN.md section 16).  log_cap ring-buffers
        # step_log and the scheduler's admit/shed logs (evictions counted
        # in each log's ``dropped``); None keeps them unbounded.
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.clock = clock
        self.paged = bool(paged)
        self.debug = bool(debug)
        self.fabric = fabric if fabric is not None \
            and not fabric.is_clean else None
        if tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {tp_size}")
        if mesh is None and tp_size > 1:
            # emulated ranks have no device count to bound: the width
            # need only split the model (transformer.check_tp); the CLI
            # bounds rank processes by --devices (launch/serve.py)
            mesh = make_mesh((1, tp_size), ("data", "model"))
        if mesh is not None and mesh.distributed and not mesh.lead:
            # every rank running its own host loop would take its own
            # clock's decisions, and the ranks' collectives would part
            raise ValueError(
                "over rank processes the engine runs in rank 0 alone, on "
                "a leading mesh (serve/ranks.serve_rank); the other ranks "
                "follow its cells")
        if kv_blocks is None:
            kv_blocks = n_slots * blocks_for(cache_len, block_size)
        if self.paged:
            # pool pages = allocatable blocks + the trash page the padded
            # table rows point at (serve/kv.py)
            self.cells = make_paged_cells(
                cfg, n_slots, cache_len, block_size, kv_blocks + 1,
                mesh=mesh, buffer_depth=page_buffer_depth, device=device)
        else:
            self.cells = make_continuous_cells(cfg, n_slots, cache_len,
                                               mesh=mesh, device=device)
        self.device = self.cells.device
        self.tp_size = self.cells.tp_size
        self.params = self.cells.put_params(params)
        # n_shards frames the allocator's placement() view only — every
        # admission decision stays in logical positions, device-blind
        self.kv = KVBlockAllocator(n_blocks=kv_blocks,
                                   block_size=block_size,
                                   n_shards=self.tp_size)
        self.tracer = tracer if tracer is not None \
            else obs_trace.resolve(clock=clock)
        self.log_cap = log_cap
        self.scheduler = SlotScheduler(n_slots, self.kv, slo=slo,
                                       tracer=self.tracer, log_cap=log_cap)
        if prefill_per_step is None:
            prefill_per_step = int(runtime.policy()["serve_prefill_per_step"])
        self.prefill_per_step = max(1, prefill_per_step)
        self.step_log: BoundedLog = BoundedLog(log_cap)
        self.idle_iters = 0
        # trace bookkeeping: which slot tracks have an open request span,
        # and whether a merged idle span is open on the engine track
        self._slot_open = [False] * n_slots
        self._idle_open = False
        self._t0 = 0.0

        self._prefill = self.cells.prefill
        self._decode = self.cells.decode
        self._insert = self.cells.insert
        if self.paged:
            self._pool = self.cells.init_pool()
            self._tables_np = np.full(
                (n_slots, self.cells.max_pages), self.kv.trash_page,
                np.int32)
            self._tables_dev = self._to_dev(self._tables_np)
        else:
            self._caches = self.cells.init_slot_caches()
        self._tok = np.zeros((n_slots,), np.int32)
        self._idx = np.zeros((n_slots,), np.int32)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (a copy on the CPU too: the host
        side keeps mutating its arrays between steps)."""
        return torch.tensor(a, device=self.device)

    # -- submission --------------------------------------------------------

    def _validate(self, req: ServeRequest) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {req.max_new_tokens}")
        lifetime = len(req.prompt) + req.max_new_tokens
        if lifetime > self.cache_len:
            raise ValueError(
                f"request needs {lifetime} cache positions "
                f"(prompt {len(req.prompt)} + {req.max_new_tokens} new), "
                f"engine cache_len is {self.cache_len}")
        if self.kv.blocks_for(lifetime) > self.kv.n_blocks:
            raise ValueError(
                f"request needs {self.kv.blocks_for(lifetime)} KV blocks, "
                f"pool holds {self.kv.n_blocks}")

    # -- tracing helpers ---------------------------------------------------
    # Timestamps handed to the tracer are absolute (run epoch + relative
    # engine time): one tracer can span calibration + sweep runs and every
    # track's timestamps stay monotone in the export.

    def _T(self, rel: float) -> float:
        return self._t0 + rel

    def _trace_work_start(self, rel: float) -> None:
        """Close the merged idle span (if open) at this working
        iteration's start — consecutive idle iterations render as one
        span, ended the moment work resumes."""
        if self._idle_open:
            self.tracer.end("engine", t=self._T(rel))
            self._idle_open = False

    # -- engine steps ------------------------------------------------------

    def _admit_one(self, now: float) -> Optional[int]:
        """Admit + prefill the scheduler's next pick, if admissible.

        An SLO admission may preempt active slots to make room: each
        victim's slot is reset here (token/index zeroed; paged tables
        re-pointed at the trash page) BEFORE the new prefill lands — the
        victim's pages went back to the pool, and its old slot may stay
        free while the candidate lands elsewhere, so without the reset
        its garbage decode could scribble a page the pool re-issued.
        """
        n_preempt = len(self.scheduler.preempt_log)
        adm = self.scheduler.admit(now)
        for _, vacated in self.scheduler.preempt_log[n_preempt:]:
            self._reset_slot(vacated, t_rel=now)
        if adm is None:
            return None
        slot, req = adm
        tr = self.tracer
        stall_s = 0.0
        if tr.enabled:
            self._trace_work_start(now)
            tr.begin("engine", "admit", "engine", t=self._T(now),
                     rid=req.rid, slot=slot, prompt_len=len(req.prompt))
            self._slot_open[slot] = True
            tr.begin(f"slot{slot}", f"r{req.rid}", "slot", t=self._T(now),
                     rid=req.rid, prompt_len=len(req.prompt),
                     max_new=req.max_new_tokens, priority=req.priority)
        if self.fabric is not None:
            # admission stall lands after the scheduler stamped t_admit:
            # the injected delay shows up as prefill time / TTFT, not as
            # queue wait — the decomposition keeps blaming the fabric,
            # not the admission policy
            s0 = self.fabric.stalled_s["admit"]
            self.fabric.stall_admit()
            stall_s = self.fabric.stalled_s["admit"] - s0
            if tr.enabled and stall_s > 0:
                # span duration is the injected stall itself (measured as
                # the fabric's accumulator delta — no clock calls)
                tr.begin("engine", "fabric_stall", "fabric", t=self._T(now),
                         kind="admit", condition=self.fabric.condition.name)
                tr.end("engine", t=self._T(now + stall_s), stalled_s=stall_s)
        if tr.enabled:
            tr.begin("engine", "prefill", "engine",
                     t=self._T(now + stall_s), rid=req.rid)
        logits, slot_caches = self._prefill(
            self.params,
            self._to_dev(np.asarray(req.prompt, np.int32))[None])
        first = int(torch.argmax(logits[0, -1]))     # device sync
        if self.paged:
            # the request's pages, trash-padded to the fixed table width;
            # insertion scatters the whole prefill cache into them
            row = np.asarray(
                self.kv.padded_table(req.rid, self.cells.max_pages),
                np.int32)
            self._pool = self._insert(self._pool, slot_caches,
                                      self._to_dev(row))
            self._tables_np[slot] = row
            self._tables_dev = self._to_dev(self._tables_np)
        else:
            self._caches = self._insert(self._caches, slot_caches, slot)
        self._tok[slot] = first
        self._idx[slot] = len(req.prompt)
        req.generated.append(first)
        req.t_first_token = self.clock() - self._t0
        if tr.enabled:
            # clamp against the synthetic stall extent so the engine track
            # stays monotone even when a virtual clock's tick is smaller
            # than the injected stall
            t_end = max(req.t_first_token, now + stall_s)
            tr.end("engine", t=self._T(t_end))          # prefill
            tr.instant("engine", "insert", "engine", t=self._T(t_end),
                       rid=req.rid, slot=slot, paged=self.paged)
            tr.end("engine", t=self._T(t_end), rid=req.rid)   # admit
            tr.metrics.observe("prefill_s", req.t_first_token - now)
        if len(req.generated) >= req.max_new_tokens:
            self.scheduler.complete(slot, req.t_first_token)
            self._reset_slot(slot, t_rel=max(req.t_first_token,
                                             now + stall_s))
        return req.rid

    def _decode_once(self) -> list[int]:
        """One synchronized decode step for every active slot."""
        active = self.scheduler.active()
        t_start = self.clock() - self._t0
        tr = self.tracer
        stall_s = 0.0
        if tr.enabled:
            self._trace_work_start(t_start)
            tr.begin("engine", "decode", "engine", t=self._T(t_start),
                     n_active=len(active))
        if self.fabric is not None:
            # inside the tick's timing window, so per-token stamps (TPOT)
            # absorb the injected delay; the straggler term applies here —
            # a batched step moves at the pace of its slowest device
            s0 = self.fabric.stalled_s["decode"]
            self.fabric.stall_decode()
            stall_s = self.fabric.stalled_s["decode"] - s0
            if tr.enabled and stall_s > 0:
                tr.begin("engine", "fabric_stall", "fabric",
                         t=self._T(t_start), kind="decode",
                         condition=self.fabric.condition.name)
                tr.end("engine", t=self._T(t_start + stall_s),
                       stalled_s=stall_s)
        if self.paged:
            logits, self._pool = self._decode(
                self.params, self._to_dev(self._tok)[:, None],
                self._to_dev(self._idx), self._pool, self._tables_dev)
        else:
            logits, self._caches = self._decode(
                self.params, self._to_dev(self._tok)[:, None],
                self._to_dev(self._idx), self._caches)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()  # host sync
        now = self.clock() - self._t0
        t_end = max(now, t_start + stall_s)
        decoded = []
        for slot, req in active:
            tok = int(nxt[slot])
            req.generated.append(tok)
            req.decode_token_s.append(now - t_start)
            self._tok[slot] = tok
            self._idx[slot] += 1
            decoded.append(req.rid)
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.complete(slot, now)
                self._reset_slot(slot, t_rel=t_end)
        if tr.enabled:
            tr.end("engine", t=self._T(t_end), n_decoded=len(decoded))
            tr.metrics.observe("decode_tick_s", now - t_start)
        return decoded

    def _reset_slot(self, slot: int, t_rel: Optional[float] = None) -> None:
        # keep the garbage decode of a free slot inside the cache bounds;
        # the next admission overwrites the whole slot cache anyway
        self._tok[slot] = 0
        self._idx[slot] = 0
        if self.paged:
            # the freed pages are back in the pool — point the slot's
            # table row at the trash page so its garbage decode can never
            # write into a page the next reservation hands out
            self._tables_np[slot] = self.kv.trash_page
            self._tables_dev = self._to_dev(self._tables_np)
        if self._slot_open[slot] and t_rel is not None:
            # close the slot-track request span at the vacating event's
            # own time (complete / preempt / deadline abort)
            self.tracer.end(f"slot{slot}", t=self._T(t_rel))
            self._slot_open[slot] = False
        if self.debug:
            self.kv.check()

    # -- run loop ----------------------------------------------------------

    def run(self, requests: list[ServeRequest],
            idle_hook: Optional[Callable[[], None]] = None,
            deadline_s: Optional[float] = None
            ) -> list[ServeRequest]:
        """Serve ``requests`` (with ``arrival_s`` offsets) to completion.

        The loop each iteration: ingest arrivals, admit + prefill up to
        ``prefill_per_step`` queued requests, run one decode step for the
        active slots — prefill interleaved with decode, not run ahead of
        it.  With nothing to decode or admit (a traffic gap) the
        ``idle_hook`` runs instead (default: a short sleep, so waiting
        for the next arrival neither pegs a core nor grows ``step_log``
        — idle iterations are counted in ``idle_iters``, not logged); the
        loop ends when every submitted request is done.  Returns
        ``requests`` in the order given.

        ``deadline_s`` bounds the run on the engine clock: at the
        deadline every unfinished request — queued, active, or not yet
        arrived — is shed with reason "deadline" (pages released, slots
        reset), which keeps overload levels of the sweeps from running
        arbitrarily past their measurement window.
        """
        if self.scheduler.n_active or self.scheduler.pending:
            raise RuntimeError(
                "engine already has requests in flight; run() is not "
                "reentrant — wait for the previous run to complete")
        for r in requests:
            self._validate(r)
        self.step_log = BoundedLog(self.log_cap)
        self.idle_iters = 0
        arrivals = sorted(requests, key=lambda r: r.arrival_s)
        n_seen = 0
        self._t0 = self.clock()
        tr = self.tracer
        if tr.enabled:
            # the scheduler shares this run's epoch so its decision
            # instants land on the same absolute timeline
            self.scheduler.trace_t0 = self._t0
            tr.instant("engine", "run_begin", "engine", t=self._t0,
                       n_requests=len(requests), n_slots=self.n_slots,
                       paged=self.paged, tp_size=self.tp_size,
                       condition=(self.fabric.condition.name
                                  if self.fabric is not None else "clean"))
            if self.paged:
                from repro_torch.serve.paged import pool_geometry
                tr.instant("kv", "pool_geometry", "kv", t=self._t0,
                           **pool_geometry(self.cfg, self.kv.n_pages,
                                           self.kv.block_size))
        self._idle_open = False
        now = 0.0
        while n_seen < len(arrivals) or self.scheduler.has_work:
            now = self.clock() - self._t0
            if deadline_s is not None and now >= deadline_s:
                if tr.enabled:
                    self._trace_work_start(now)
                    tr.instant("engine", "deadline_abort", "engine",
                               t=self._T(now), deadline_s=deadline_s)
                for slot in self.scheduler.abort(now, reason="deadline"):
                    self._reset_slot(slot, t_rel=now)
                for r in arrivals[n_seen:]:     # never even arrived
                    r.t_shed, r.shed_reason = now, "deadline"
                n_seen = len(arrivals)
                break
            while n_seen < len(arrivals) \
                    and arrivals[n_seen].arrival_s <= now:
                self.scheduler.submit(arrivals[n_seen], now)
                n_seen += 1
            admitted = []
            for _ in range(self.prefill_per_step):
                rid = self._admit_one(self.clock() - self._t0)
                if rid is None:
                    break
                admitted.append(rid)
            decoded = self._decode_once() if self.scheduler.n_active else []
            if not admitted and not decoded:
                self.idle_iters += 1
                if tr.enabled:
                    if not self._idle_open:
                        tr.begin("engine", "idle", "engine", t=self._T(now))
                        self._idle_open = True
                    tr.metrics.count("idle_iters")
                if idle_hook is not None:
                    idle_hook()
                else:
                    time.sleep(self.IDLE_SLEEP_S)
                continue
            if tr.enabled:
                # per-iteration pool/queue watermarks, each on its own
                # counter track (timestamps are this iteration's loop-top
                # time, monotone per track by construction)
                tr.counter("queue", "queue_depth", t=self._T(now),
                           depth=len(self.scheduler.pending))
                tr.counter("slots", "slot_occupancy", t=self._T(now),
                           active=self.scheduler.n_active)
                tr.counter("kv", "kv_pages", t=self._T(now),
                           free=self.kv.n_free, used=self.kv.n_used)
                tr.metrics.gauge("queue_depth",
                                 float(len(self.scheduler.pending)))
                tr.metrics.gauge("slot_occupancy",
                                 float(self.scheduler.n_active))
                tr.metrics.gauge("kv_pages_free", float(self.kv.n_free))
                tr.metrics.count("work_iters")
            self.step_log.append(StepEvent(
                now=now, admitted=tuple(admitted), decoded=tuple(decoded),
                queued=len(self.scheduler.pending)))
        if tr.enabled:
            # a still-open merged idle span (the loop drained while idle)
            # closes at the last loop-top time seen
            self._trace_work_start(now)
        return requests

    def generate(self, requests: list[ServeRequest]) -> list[ServeRequest]:
        """Static-API convenience: all requests arrive at t=0."""
        for r in requests:
            r.arrival_s = 0.0
        return self.run(requests)
