"""Synthetic load generator for the serving characterization.

Two layers (DESIGN.md sections 11 and 15):

``LoadSpec`` produces deterministic request streams for an *offered
load* (requests per second): seeded prompt tokens, a fixed cycle of
prompt lengths (so the engine compiles one prefill per distinct length,
not per request), and either evenly spaced or Poisson arrivals.  The
``serve.load_sweep`` experiment drives the engine with streams at
multiples of its measured capacity — the serving transposition of the
paper's pktgen delay sweep, where offered load replaces injected delay
as the independent variable.

``TraceSpec`` produces production-shaped traffic: a non-homogeneous
Poisson process (bursts and ramps modulate the base rate; arrivals are
drawn by thinning), heavy-tailed prompt/generation lengths (seeded
lognormal, snapped to a small bucket grid so compile count stays
bounded), and weighted priority classes.  Traces are replayable: any
request stream round-trips through a JSONL file (``save_trace`` /
``load_trace``) so a measured run can be re-offered verbatim.

Both layers return a ``RequestStream`` carrying the *realized* offered
rate next to the requests.  The realized rate is the sweep's honest
denominator: a Poisson draw of n gaps spans what it spans, and the old
``cumsum(gaps) - gaps[0]`` convention additionally discarded the first
gap entirely, biasing short streams hot relative to ``rate_rps``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serve.scheduler import ServeRequest


@dataclass(frozen=True)
class LoadSpec:
    """One offered-load level of synthetic traffic."""
    n_requests: int
    rate_rps: float = 0.0               # 0 = burst: everything at t=0
    prompt_lens: tuple = (8, 16)        # cycled; bounds prefill recompiles
    max_new_tokens: int = 8
    vocab_size: int = 512
    seed: int = 0
    arrivals: str = "uniform"           # uniform | poisson

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.rate_rps < 0:
            raise ValueError(f"rate_rps must be >= 0, got {self.rate_rps}")
        if not self.prompt_lens:
            raise ValueError("prompt_lens must be non-empty")
        if any(p < 1 for p in self.prompt_lens):
            raise ValueError(f"prompt_lens must be >= 1: {self.prompt_lens}")
        if self.arrivals not in ("uniform", "poisson"):
            raise ValueError(f"unknown arrivals mode {self.arrivals!r}")


@dataclass
class RequestStream:
    """Requests plus the stream-level metadata the sweeps condition on."""
    requests: list                      # list[ServeRequest]
    realized_rps: float                 # measured over the arrival span
    requested_rps: float = 0.0
    params: dict = field(default_factory=dict)

    def __iter__(self):
        return iter(self.requests)

    def __len__(self):
        return len(self.requests)


def _realized_rps(offsets: np.ndarray) -> float:
    """Arrivals per second over the stream's own span (0 for bursts)."""
    if len(offsets) < 2:
        return 0.0
    span = float(offsets[-1] - offsets[0])
    return (len(offsets) - 1) / span if span > 0 else 0.0


def make_stream(spec: LoadSpec) -> RequestStream:
    """The request stream for ``spec`` — deterministic in ``spec``.

    Randomness is a pure function of ``spec.seed``: a per-spec
    ``SeedSequence`` spawns two independent ``numpy.random.Generator``
    streams, one for arrival gaps and one for prompt tokens.  No global
    RNG state is touched, so the same spec yields the same stream in any
    process, and the prompts are identical across arrival modes (the old
    single-stream draw order made poisson prompts diverge from uniform
    ones under the same seed).
    """
    arrival_rng, prompt_rng = (
        np.random.default_rng(s)
        for s in np.random.SeedSequence(spec.seed).spawn(2))
    if spec.rate_rps <= 0:
        offsets = np.zeros(spec.n_requests)
    elif spec.arrivals == "poisson":
        gaps = arrival_rng.exponential(1.0 / spec.rate_rps,
                                       size=spec.n_requests)
        offsets = np.cumsum(gaps) - gaps[0]     # first arrival at t=0
    else:
        offsets = np.arange(spec.n_requests) / spec.rate_rps
    out = []
    for i in range(spec.n_requests):
        plen = spec.prompt_lens[i % len(spec.prompt_lens)]
        prompt = prompt_rng.integers(
            0, spec.vocab_size, size=plen).astype(np.int32)
        out.append(ServeRequest(prompt=prompt,
                                max_new_tokens=spec.max_new_tokens,
                                arrival_s=float(offsets[i])))
    return RequestStream(requests=out,
                         realized_rps=_realized_rps(offsets),
                         requested_rps=spec.rate_rps,
                         params={"arrivals": spec.arrivals,
                                 "n_requests": spec.n_requests})


def make_requests(spec: LoadSpec) -> list[ServeRequest]:
    """Back-compat shim: just the requests of ``make_stream(spec)``."""
    return make_stream(spec).requests


# -- trace-driven load ------------------------------------------------------

def _snap(value: float, buckets: tuple) -> int:
    """Nearest bucket by log distance (buckets span octaves, so linear
    distance would over-favor the largest)."""
    logs = np.log(np.asarray(buckets, np.float64))
    return int(buckets[int(np.argmin(np.abs(logs - np.log(max(value, 1e-9)))))])


@dataclass(frozen=True)
class TraceSpec:
    """Production-shaped traffic: bursts/ramps over a base Poisson rate,
    heavy-tailed lengths, weighted priority classes."""
    n_requests: int
    base_rps: float
    classes: tuple = (("standard", 1.0),)   # (name, weight)
    bursts: tuple = ()                      # (start_s, duration_s, rate_mult)
    ramp: Optional[tuple] = None            # (start_s, end_s, end_mult)
    prompt_len_median: float = 12.0
    prompt_len_sigma: float = 0.6           # lognormal shape
    prompt_len_buckets: tuple = (8, 16)     # snap grid bounds compiles
    max_new_median: float = 6.0
    max_new_sigma: float = 0.6
    max_new_buckets: tuple = (4, 8)
    vocab_size: int = 512
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.base_rps <= 0:
            raise ValueError(f"base_rps must be > 0, got {self.base_rps}")
        if not self.classes or any(w <= 0 for _, w in self.classes):
            raise ValueError(f"classes need positive weights: {self.classes}")
        for start, dur, mult in self.bursts:
            if dur <= 0 or mult <= 0:
                raise ValueError(f"bad burst {(start, dur, mult)}")
        if not self.prompt_len_buckets or not self.max_new_buckets:
            raise ValueError("length bucket grids must be non-empty")

    def rate_mult(self, t: float) -> float:
        """Rate modulation at trace time ``t`` (bursts multiply; a ramp
        interpolates linearly from 1x at start to end_mult at end)."""
        mult = 1.0
        for start, dur, m in self.bursts:
            if start <= t < start + dur:
                mult *= m
        if self.ramp is not None:
            start, end, m = self.ramp
            if t >= end:
                mult *= m
            elif t > start:
                mult *= 1.0 + (m - 1.0) * (t - start) / (end - start)
        return mult

    @property
    def peak_rps(self) -> float:
        """Upper bound on the instantaneous rate (thinning envelope)."""
        mult = 1.0
        for _, _, m in self.bursts:
            mult *= max(m, 1.0)
        if self.ramp is not None:
            mult *= max(self.ramp[2], 1.0)
        return self.base_rps * mult


def make_trace(spec: TraceSpec) -> RequestStream:
    """Draw the trace for ``spec`` — deterministic in ``spec``.

    Arrivals come from thinning a homogeneous Poisson process at the
    spec's peak rate: a candidate at time t survives with probability
    ``rate(t) / peak``, which realizes the burst/ramp-modulated rate
    exactly.  Lengths are lognormal draws snapped to the bucket grids.
    """
    arrival_rng, prompt_rng, len_rng, cls_rng = (
        np.random.default_rng(s)
        for s in np.random.SeedSequence(spec.seed).spawn(4))
    peak = spec.peak_rps
    names = [n for n, _ in spec.classes]
    weights = np.asarray([w for _, w in spec.classes], np.float64)
    weights /= weights.sum()
    t, offsets = 0.0, []
    while len(offsets) < spec.n_requests:
        t += float(arrival_rng.exponential(1.0 / peak))
        if arrival_rng.random() < spec.base_rps * spec.rate_mult(t) / peak:
            offsets.append(t)
    offsets = np.asarray(offsets) - offsets[0]      # first arrival at t=0
    out = []
    for i in range(spec.n_requests):
        plen = _snap(len_rng.lognormal(np.log(spec.prompt_len_median),
                                       spec.prompt_len_sigma),
                     spec.prompt_len_buckets)
        max_new = _snap(len_rng.lognormal(np.log(spec.max_new_median),
                                          spec.max_new_sigma),
                        spec.max_new_buckets)
        prompt = prompt_rng.integers(
            0, spec.vocab_size, size=plen).astype(np.int32)
        out.append(ServeRequest(
            prompt=prompt, max_new_tokens=max_new,
            arrival_s=float(offsets[i]),
            priority=str(cls_rng.choice(names, p=weights))))
    return RequestStream(requests=out,
                         realized_rps=_realized_rps(offsets),
                         requested_rps=spec.base_rps,
                         params={"arrivals": "trace",
                                 "n_requests": spec.n_requests,
                                 "classes": names})


# -- trace replay -----------------------------------------------------------

def save_trace(requests, path) -> None:
    """Record a request stream as replayable JSONL (one request per line:
    arrival, prompt token ids, generation budget, priority class)."""
    rows = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps({
                "arrival_s": r.arrival_s,
                "prompt": [int(x) for x in r.prompt],
                "max_new_tokens": int(r.max_new_tokens),
                "priority": r.priority,
            }) + "\n")


def load_trace(path) -> RequestStream:
    """Replay a recorded trace: fresh ``ServeRequest`` objects (no stamps),
    arrivals re-based so the first lands at t=0."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            out.append(ServeRequest(
                prompt=np.asarray(row["prompt"], np.int32),
                max_new_tokens=int(row["max_new_tokens"]),
                arrival_s=float(row["arrival_s"]),
                priority=str(row.get("priority", "standard"))))
    if not out:
        raise ValueError(f"empty trace: {path}")
    out.sort(key=lambda r: r.arrival_s)
    base = out[0].arrival_s
    for r in out:
        r.arrival_s -= base
    offsets = np.asarray([r.arrival_s for r in out])
    return RequestStream(requests=out,
                         realized_rps=_realized_rps(offsets),
                         requested_rps=0.0,
                         params={"arrivals": "replay",
                                 "n_requests": len(out)})
