"""Slot scheduler: request lifecycle + admission for continuous batching.

A ``ServeRequest`` moves ``queued -> prefill -> decode -> done``; the
state is derived from its latency stamps rather than stored, so the
lifecycle record doubles as the latency decomposition the Records carry
(queue wait, TTFT, per-token decode — DESIGN.md section 11):

    t_enqueue ----- t_admit ----- t_first_token ----- t_done
       |  queue wait   |   prefill     |   decode (TPOT)  |
       `------------- TTFT ------------'

Two further terminal outcomes exist beyond ``done`` (DESIGN.md section
15): a request may be **shed** (``t_shed`` + ``shed_reason`` stamped,
never or no longer served) or **preempted** (its KV pages released, its
slot freed, and it re-queues with ``t_enqueue`` preserved so queue wait
stays honest across the restart; ``n_preempted`` counts the cycles).

The ``SlotScheduler`` owns the decode-batch slots and the admission
decision.  Without an ``SLOPolicy`` admission is FIFO: a queued request
is admitted as soon as (a) it has arrived, (b) a slot is free and (c)
the KV block pool covers its whole lifetime (``kv.KVBlockAllocator``,
conservative reservation — no preemption needed).  With a policy, the
scheduler closes the loop on its own measurements: the best-ranked
arrived request is admitted first, a queued request whose measured
queue wait exceeds its class shed budget is shed, and a candidate whose
measured queue wait plus the observed prefill time would miss its class
TTFT target may preempt a strictly lower-priority active request.

Both scheduler and allocator are host-side and account in *slots* and
*logical token positions* — they never see a device, so the same
workload drives identical decisions whether the engine's cache lives on
one device or is tensor-parallel over eight (``serve/step.py``).
``admit_log`` / ``preempt_log`` / ``shed_log`` record every decision in
order; the property tests replay one workload against allocators framed
at shard counts 1/2/4 and hold the logs equal.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.logbuf import BoundedLog
from repro_torch.serve.kv import KVBlockAllocator


@dataclass
class ServeRequest:
    """One request plus its lifecycle stamps (engine-clock seconds)."""
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int = 16
    arrival_s: float = 0.0              # offered arrival, relative to run start
    priority: str = "standard"          # SLO class name (SLOPolicy key)
    rid: int = -1                       # assigned at submit
    generated: list = field(default_factory=list)
    done: bool = False
    # latency decomposition stamps, filled as the lifecycle advances
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_shed: Optional[float] = None
    shed_reason: str = ""
    n_preempted: int = 0
    decode_token_s: list = field(default_factory=list)  # per token after first

    @property
    def state(self) -> str:
        if self.t_shed is not None:
            return "shed"
        if self.t_done is not None:
            return "done"
        if self.t_first_token is not None:
            return "decode"
        if self.t_admit is not None:
            return "prefill"
        return "queued"

    # -- derived latency metrics (None until the stage completed) ----------

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None or self.t_enqueue is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from arrival (includes queue wait)."""
        if self.t_first_token is None or self.t_enqueue is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def prefill_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_admit is None:
            return None
        return self.t_first_token - self.t_admit

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token over the decode stage."""
        if not self.decode_token_s:
            return None
        return float(sum(self.decode_token_s) / len(self.decode_token_s))

    @property
    def total_s(self) -> Optional[float]:
        if self.t_done is None or self.t_enqueue is None:
            return None
        return self.t_done - self.t_enqueue


@dataclass(frozen=True)
class ClassSLO:
    """Per-class service targets, in engine-clock seconds.

    ``rank`` orders admission (lower = higher priority).  ``ttft_s`` /
    ``tpot_s`` are the attainment targets; ``ttft_s`` also arms
    preemption (a candidate about to miss it may evict a lower class).
    ``shed_after_s`` is the queue-wait budget after which a still-queued
    request is shed instead of served stale; None = never shed.
    """
    rank: int
    ttft_s: float
    tpot_s: float
    shed_after_s: Optional[float] = None


@dataclass
class SLOPolicy:
    """Named SLO classes plus the admission knobs that act on them."""
    classes: dict                       # name -> ClassSLO
    preempt: bool = True
    default_class: str = "standard"

    def __post_init__(self):
        if not self.classes:
            raise ValueError("SLOPolicy needs at least one class")
        if self.default_class not in self.classes:
            # fall back to the worst-ranked class as the default bucket
            self.default_class = max(
                self.classes, key=lambda k: self.classes[k].rank)

    def slo_for(self, priority: str) -> ClassSLO:
        return self.classes.get(priority, self.classes[self.default_class])

    @classmethod
    def from_runtime(cls) -> "SLOPolicy":
        """Build from the ``serve_slo_targets`` runtime policy knob."""
        from repro_torch import runtime
        targets = runtime.policy()["serve_slo_targets"]
        return cls(classes={
            name: ClassSLO(rank=int(t["rank"]), ttft_s=float(t["ttft_s"]),
                           tpot_s=float(t["tpot_s"]),
                           shed_after_s=t.get("shed_after_s"))
            for name, t in targets.items()})


class SlotScheduler:
    """Admission into a fixed set of decode-batch slots.

    FIFO when ``slo`` is None; priority-aware with shed + preemption when
    an ``SLOPolicy`` is set (swappable between runs via the attribute).
    """

    # EWMA weight for the observed prefill/TPOT estimators
    _ALPHA = 0.3

    def __init__(self, n_slots: int, kv: KVBlockAllocator,
                 slo: Optional[SLOPolicy] = None,
                 tracer=None, log_cap: Optional[int] = None):
        assert n_slots > 0
        self.n_slots = n_slots
        self.kv = kv
        self.slo = slo
        # tracer: decision instants (admit/shed/preempt with args) land on
        # the "scheduler" track; timestamps are the `now` values callers
        # already computed plus trace_t0 (the engine sets it to its run
        # epoch so tracks stay monotone across runs) — the tracer's own
        # clock is never called here (obs/trace.py, the virtual-clock
        # contract).  log_cap ring-buffers admit_log/shed_log; preempt_log
        # stays a plain list (the engine slices it by index).
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.trace_t0 = 0.0
        self.pending: deque[ServeRequest] = deque()
        self.slots: list[Optional[ServeRequest]] = [None] * n_slots
        self.admit_log: BoundedLog = BoundedLog(log_cap)  # (rid, slot)
        self.preempt_log: list[tuple[int, int]] = []  # (rid, slot it vacated)
        self.shed_log: BoundedLog = BoundedLog(log_cap)   # (rid, reason)
        # observed-decomposition estimators the policy conditions on
        self.est_prefill_s: Optional[float] = None
        self.est_tpot_s: Optional[float] = None
        self._next_rid = 0

    # -- queue -------------------------------------------------------------

    def submit(self, req: ServeRequest, now: float) -> int:
        """Enqueue a request; stamps ``t_enqueue`` at its offered arrival
        time (queueing delay starts at arrival, not at the loop iteration
        that notices it — and a request submitted *ahead* of its arrival
        must not start accruing queue wait before it nominally exists)."""
        req.rid = self._next_rid
        self._next_rid += 1
        req.t_enqueue = req.arrival_s
        self.pending.append(req)
        return req.rid

    # -- admission ---------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _lifetime(self, req: ServeRequest) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _remove_pending(self, req: ServeRequest) -> None:
        # identity-based: dataclass == would compare numpy prompts
        idx = next(i for i, r in enumerate(self.pending) if r is req)
        del self.pending[idx]

    def _shed(self, req: ServeRequest, now: float, reason: str) -> None:
        req.t_shed = now
        req.shed_reason = reason
        self.shed_log.append((req.rid, reason))
        tr = self.tracer
        if tr.enabled:
            tr.instant("scheduler", "shed", "scheduler",
                       t=self.trace_t0 + now, rid=req.rid, reason=reason,
                       priority=req.priority,
                       waited_s=now - (req.t_enqueue or 0.0))
            tr.metrics.count("sheds")

    def _preempt(self, slot: int, now: float,
                 projected_ttft: Optional[float] = None) -> ServeRequest:
        """Evict the request in ``slot``: release its pages, wipe its
        served progress (greedy decode restarts bit-identically from the
        same prompt), keep ``t_enqueue`` so queue wait stays honest."""
        req = self.slots[slot]
        assert req is not None, f"preempting empty slot {slot}"
        self.kv.release(req.rid)
        self.slots[slot] = None
        req.generated.clear()
        req.decode_token_s.clear()
        req.t_admit = None
        req.t_first_token = None
        req.n_preempted += 1
        self.pending.append(req)
        self.preempt_log.append((req.rid, slot))
        tr = self.tracer
        if tr.enabled:
            tr.instant("scheduler", "preempt", "scheduler",
                       t=self.trace_t0 + now, victim_rid=req.rid, slot=slot,
                       victim_priority=req.priority,
                       projected_ttft_s=projected_ttft)
            tr.metrics.count("preemptions")
        return req

    def _admit_into(self, req: ServeRequest, slot: int,
                    now: float) -> tuple[int, ServeRequest]:
        self._remove_pending(req)
        self.kv.reserve(req.rid, self._lifetime(req))
        assert self.slots[slot] is None, "slot double-assigned"
        self.slots[slot] = req
        self.admit_log.append((req.rid, slot))
        req.t_admit = now
        tr = self.tracer
        if tr.enabled:
            tr.instant("scheduler", "admit", "scheduler",
                       t=self.trace_t0 + now, rid=req.rid, slot=slot,
                       priority=req.priority,
                       queue_wait_s=now - (req.t_enqueue or 0.0))
            tr.metrics.count("admits")
        return slot, req

    def admit(self, now: float) -> Optional[tuple[int, ServeRequest]]:
        """Admit one request if possible; apply the SLO policy if set.

        FIFO (no policy): head-of-queue only, once it has arrived and a
        slot AND KV blocks are free — FIFO blocks rather than skipping
        ahead, so admission order never starves a large request.

        SLO policy: first shed queued requests whose measured queue wait
        overran their class budget, then pick the best (rank, t_enqueue,
        rid) arrived candidate; if it cannot be placed and its measured
        wait plus the observed prefill estimate would miss its TTFT
        target, preempt strictly lower-priority active requests until it
        fits (or no victim outranks it).
        """
        if self.slo is None:
            if not self.pending:
                return None
            req = self.pending[0]
            if req.arrival_s > now:
                return None
            slot = self.free_slot()
            if slot is None:
                return None
            if not self.kv.can_reserve(self._lifetime(req)):
                return None
            return self._admit_into(req, slot, now)

        # -- shed pass: queue-wait budget overruns, in queue order --------
        for req in [r for r in self.pending if r.arrival_s <= now]:
            budget = self.slo.slo_for(req.priority).shed_after_s
            if budget is not None and now - req.t_enqueue > budget:
                self._remove_pending(req)
                self._shed(req, now, "slo_budget")

        # -- candidate: best-ranked arrived request ------------------------
        eligible = [r for r in self.pending if r.arrival_s <= now]
        if not eligible:
            return None
        req = min(eligible, key=lambda r: (
            self.slo.slo_for(r.priority).rank, r.t_enqueue, r.rid))
        cls = self.slo.slo_for(req.priority)
        lifetime = self._lifetime(req)

        def placeable():
            return (self.free_slot() is not None
                    and self.kv.can_reserve(lifetime))

        if not placeable() and self.slo.preempt:
            # Preempt only under measured TTFT pressure: the wait already
            # spent plus the prefill the engine has been observed to take
            # would overrun the candidate's target.
            projected_ttft = (now - req.t_enqueue) + (self.est_prefill_s or 0.0)
            for _ in range(self.n_slots):
                if placeable() or projected_ttft < cls.ttft_s:
                    break
                victims = [
                    (i, r) for i, r in enumerate(self.slots)
                    if r is not None
                    and self.slo.slo_for(r.priority).rank > cls.rank]
                if not victims:
                    break
                # evict the lowest class; among equals, the one with the
                # most estimated decode time left (observed TPOT × tokens
                # remaining) — least near-done work wasted
                tpot = self.est_tpot_s or 1.0

                def cost(item):
                    _, r = item
                    remaining = r.max_new_tokens - len(r.generated)
                    return (self.slo.slo_for(r.priority).rank,
                            remaining * tpot, r.rid)
                slot_v, _ = max(victims, key=cost)
                self._preempt(slot_v, now, projected_ttft=projected_ttft)

        if not placeable():
            return None
        return self._admit_into(req, self.free_slot(), now)

    # -- decode batch ------------------------------------------------------

    def active(self) -> list[tuple[int, ServeRequest]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or self.n_active > 0

    def complete(self, slot: int, now: float) -> ServeRequest:
        """Retire a finished request: stamp, free its KV blocks, free slot.
        Feeds the observed prefill/TPOT estimators the policy acts on."""
        req = self.slots[slot]
        assert req is not None, f"slot {slot} already free"
        req.t_done = now
        req.done = True
        self.kv.release(req.rid)
        self.slots[slot] = None
        tr = self.tracer
        if tr.enabled:
            tr.instant("scheduler", "complete", "scheduler",
                       t=self.trace_t0 + now, rid=req.rid, slot=slot,
                       n_tokens=len(req.generated))
            tr.metrics.count("completions")
        for attr, sample in (("est_prefill_s", req.prefill_s),
                             ("est_tpot_s", req.tpot_s)):
            if sample is not None:
                prev = getattr(self, attr)
                setattr(self, attr, sample if prev is None
                        else (1 - self._ALPHA) * prev + self._ALPHA * sample)
        return req

    def abort(self, now: float, reason: str = "deadline") -> list[int]:
        """Shed everything still in flight (queued AND active), releasing
        pages and slots.  Returns the slot indices freed so the engine can
        reset their device-side state."""
        while self.pending:
            self._shed(self.pending.popleft(), now, reason)
        freed = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.kv.release(req.rid)
            self.slots[i] = None
            self._shed(req, now, reason)
            freed.append(i)
        return freed

    def check(self) -> None:
        """Assert scheduler invariants (tests call this after every step)."""
        live = [r.rid for r in self.slots if r is not None]
        assert len(live) == len(set(live)), "request in two slots"
        shed_rids = [rid for rid, _ in self.shed_log]
        assert len(shed_rids) == len(set(shed_rids)), "request shed twice"
        for r in list(self.pending) + [r for r in self.slots if r is not None]:
            assert r.t_shed is None, f"shed request {r.rid} still scheduled"
        self.kv.check()
