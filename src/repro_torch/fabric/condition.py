"""The degraded-fabric condition model.

Every number the repo produced before this subsystem assumed a clean
fabric; the paper's central finding is that the BlueField-2's value
collapses once the data path is stressed beyond what its cores can
absorb.  A :class:`FabricCondition` is the *scenario* half of that
question: a composable description of how the wire misbehaves —

  * ``latency_s``          fixed added latency per chain segment,
  * ``bandwidth_factor``   throttling: a segment's transfer time scales by
                           ``1/bandwidth_factor`` (1.0 = line rate),
  * ``loss_rate`` +        loss-with-retry: each segment independently
    ``retry_latency_s``    loses with probability ``loss_rate``; every
                           (geometric) retry re-issues the segment
                           wholesale — ``retry_latency_s`` plus a full
                           re-pay of the (throttled) transfer time,
  * ``straggler_device`` + one designated slow device: every segment costs
    ``straggler_delay_s``  it this much extra (the schedule decides
                           whether that serializes, ``fabric/inject.py``),
  * ``jitter_s`` +         seeded bursty jitter: with probability
    ``jitter_prob``        ``jitter_prob`` a segment stalls ``jitter_s``.

All randomness flows through an injectable ``numpy.random.Generator``
seeded from ``seed`` (``rng()``), so a condition is a *reproducible*
scenario: the same condition samples the same per-segment delays on every
trace and in every process.  ``FabricCondition.clean()`` is the identity
condition — enforcement points treat it exactly like "no fabric at all"
(bit-identical outputs, identical HLO; the tier-1 guard test holds them
equal).

Conditions compose with ``merge`` (jitter on top of a straggler, loss on
top of a throttled wire); the canonical scenario set used by the
``fabric.*`` experiment family and the planner's robustness rules lives
in ``canonical_conditions()``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class FabricCondition:
    """One composable degraded-fabric scenario (see module docstring)."""
    name: str = "clean"
    latency_s: float = 0.0            # fixed extra latency per segment
    bandwidth_factor: float = 1.0     # transfer time scales by 1/factor
    loss_rate: float = 0.0            # per-segment loss probability
    retry_latency_s: float = 0.0      # cost of each retry of a lost segment
    straggler_device: Optional[int] = None   # index on the target axis
    straggler_delay_s: float = 0.0    # per-segment extra cost on that device
    jitter_s: float = 0.0             # burst stall magnitude
    jitter_prob: float = 0.0          # per-segment burst probability
    seed: int = 0                     # seeds rng(); part of the scenario

    def __post_init__(self):
        if not 0.0 < self.bandwidth_factor <= 1.0:
            raise ValueError(
                f"bandwidth_factor must be in (0, 1], got "
                f"{self.bandwidth_factor} (1.0 = unthrottled line rate)")
        if not 0.0 <= self.loss_rate < 1.0:
            raise ValueError(
                f"loss_rate must be in [0, 1), got {self.loss_rate} "
                "(a segment that is always lost never completes)")
        if not 0.0 <= self.jitter_prob <= 1.0:
            raise ValueError(f"jitter_prob must be in [0, 1], "
                             f"got {self.jitter_prob}")
        for f in ("latency_s", "retry_latency_s", "straggler_delay_s",
                  "jitter_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")

    @classmethod
    def clean(cls) -> "FabricCondition":
        """The identity condition: enforcement points must be no-ops under
        it (same HLO, bit-identical outputs — guarded in tier-1)."""
        return cls()

    @property
    def is_clean(self) -> bool:
        """True when no field perturbs anything — the no-op fast path every
        enforcement point checks before injecting."""
        return (self.latency_s == 0.0 and self.bandwidth_factor == 1.0
                and self.loss_rate == 0.0
                and (self.straggler_device is None
                     or self.straggler_delay_s == 0.0)
                and (self.jitter_s == 0.0 or self.jitter_prob == 0.0))

    def rng(self) -> np.random.Generator:
        """A fresh Generator for this condition — per-segment samples are a
        pure function of (condition, draw order), never of global state."""
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(0xFAB,)))

    def merge(self, other: "FabricCondition",
              name: Optional[str] = None) -> "FabricCondition":
        """Compose two conditions: worst of each degradation axis (max
        latency/loss/jitter terms, min bandwidth, ``other``'s straggler
        wins when both designate one).  ``seed`` comes from ``self``."""
        return FabricCondition(
            name=name or f"{self.name}+{other.name}",
            latency_s=max(self.latency_s, other.latency_s),
            bandwidth_factor=min(self.bandwidth_factor,
                                 other.bandwidth_factor),
            loss_rate=max(self.loss_rate, other.loss_rate),
            retry_latency_s=max(self.retry_latency_s, other.retry_latency_s),
            straggler_device=(other.straggler_device
                              if other.straggler_device is not None
                              else self.straggler_device),
            straggler_delay_s=max(self.straggler_delay_s,
                                  other.straggler_delay_s),
            jitter_s=max(self.jitter_s, other.jitter_s),
            jitter_prob=max(self.jitter_prob, other.jitter_prob),
            seed=self.seed)

    def segment_delay_s(self, rng: np.random.Generator,
                        transfer_s: float = 0.0) -> float:
        """Sample one segment's *common* (every-device) added delay.

        ``transfer_s`` is the segment's nominal clean transfer time — the
        bandwidth throttle stretches it to ``transfer_s /
        bandwidth_factor``, so the added cost is the difference.  Loss
        retries are geometric (each attempt independently lost with
        ``loss_rate``) and each retry *re-issues the segment*: it pays
        ``retry_latency_s`` plus the full throttled transfer again — a
        lost chain segment is recomputed and resent, not merely
        acknowledged late.  Jitter is an all-or-nothing burst.  The
        straggler term is *not* included — it is per-device, applied by
        the enforcement point (``fabric/inject.py`` /
        ``fabric/serve.py``)."""
        d = self.latency_s
        if self.bandwidth_factor < 1.0 and transfer_s > 0.0:
            d += transfer_s * (1.0 / self.bandwidth_factor - 1.0)
        if self.loss_rate > 0.0 and (self.retry_latency_s > 0.0
                                     or transfer_s > 0.0):
            # geometric(p) counts attempts until first success: retries
            # are the failed attempts before it
            retries = int(rng.geometric(1.0 - self.loss_rate)) - 1
            d += retries * (self.retry_latency_s
                            + transfer_s / self.bandwidth_factor)
        if self.jitter_s > 0.0 and self.jitter_prob > 0.0:
            if rng.random() < self.jitter_prob:
                d += self.jitter_s
        return d

    def describe(self) -> str:
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name in ("name", "seed") or v == f.default:
                continue
            parts.append(f"{f.name}={v}")
        return f"{self.name}({', '.join(parts) or 'clean'})"

    def params(self) -> dict:
        """JSON-serializable condition fields, for ``Record.params``."""
        return {f"fabric_{f.name}": getattr(self, f.name)
                for f in fields(self)}


# ---------------------------------------------------------------------------
# the canonical scenario set
# ---------------------------------------------------------------------------

# Magnitudes are sized for the reference container (2 cores, fabricated
# host devices): a few ms per segment — large against a ~1 ms bucket
# chain or decode tick, small enough that the fabric.* experiments stay
# CI-sized.  The *relative* records (inflation vs clean, efficiency
# deltas) are what the planner consumes, so absolute magnitudes only need
# to dominate scheduler noise, not model a specific wire.
def canonical_conditions() -> dict[str, FabricCondition]:
    """Name -> condition for the canonical degraded-fabric scenarios the
    ``fabric.*`` experiments sweep and the planner rules key on."""
    return {
        "clean": FabricCondition.clean(),
        "jitter": FabricCondition(
            name="jitter", jitter_s=6e-3, jitter_prob=0.5, seed=7),
        "straggler": FabricCondition(
            name="straggler", straggler_device=1, straggler_delay_s=8e-3,
            seed=7),
        "lossy": FabricCondition(
            name="lossy", loss_rate=0.25, retry_latency_s=4e-3,
            latency_s=1e-3, seed=7),
        "throttle": FabricCondition(
            name="throttle", bandwidth_factor=0.25, latency_s=5e-4, seed=7),
    }
