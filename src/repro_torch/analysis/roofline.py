"""Three-term roofline of a dry-run cell, for the NVIDIA H100 SXM.

Counterpart of ``repro/analysis/roofline.py``:

  compute term    = FLOPs_per_device / PEAK_FLOPS
  memory term     = analytic HBM bytes per device / HBM_BW
  collective term = wire bytes per device (ici) / ICI_BW
                    + (dcn) / DCN_BW

The FLOPs and the collectives are counted on meta tensors by running one
rank's step (``analysis/cost.py``, ``analysis/collectives.py``); the
memory term is the reference's first-principles model
(:func:`analytic_memory_bytes`), and the counted operand bytes are
reported beside it (``collectives["hbm_bytes_upper_bound"]``).  The
peaks are the H100 SXM data sheet's: 989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s of HBM3, NVLink 450 GB/s a direction a card
within a node of 8, one 400 Gb/s InfiniBand NDR port a card between
nodes.  ``MODEL_FLOPS`` is the classic 6·N·D (train) / 2·N·D
(inference), N the active parameters: the ratio MODEL_FLOPS / counted
FLOPs shows remat and padding waste, and MODEL_FLOPS over the peak and a
step's time is the step's MFU.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

from repro_torch.analysis.collectives import CollectiveSummary
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.headroom import RooflineTerms

PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s / card
HBM_BW = 3.35e12           # bytes/s / card
ICI_BW = 450e9             # NVLink bytes/s / card, one direction
DCN_BW = 50e9              # InfiniBand NDR bytes/s / card (400 Gb/s)


# ---------------------------------------------------------------------------
# parameter counting (exact, from the abstract param tree)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _leaves(cfg: ArchConfig) -> tuple:
    """``(path, shape)`` of every leaf of the abstract parameter tree."""
    from repro_torch import bridge
    from repro_torch.models import registry
    return tuple((path, tuple(leaf.shape)) for path, leaf in
                 bridge.flatten(registry.abstract_params(cfg)))


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(shape) for _, shape in _leaves(cfg))


def active_param_count(cfg: ArchConfig) -> int:
    """Per-token active params: replace num_experts by experts_per_token."""
    n = param_count(cfg)
    if not cfg.num_experts:
        return n
    expert_total = 0
    for path, shape in _leaves(cfg):
        keys = path.split("/")
        if "moe" in keys and any(k in ("wi", "wg", "wo") for k in keys):
            expert_total += math.prod(shape)
    active_frac = (cfg.experts_per_token / cfg.num_experts)
    return n - expert_total + int(expert_total * active_frac)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D for train, 2·N·D for inference forward (D = processed tokens)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1      # decode: one token per sequence
    return 2.0 * n_active * tokens


# ---------------------------------------------------------------------------
# analytic HBM-traffic model
# ---------------------------------------------------------------------------

def analytic_memory_bytes(cfg: ArchConfig, shape: ShapeConfig,
                          n_chips: int, n_model: int = 16) -> float:
    """Per-device HBM bytes per step (read+write counted once each).  The
    batch shards are at least one (the reference divides by zero below
    ``n_model`` cards)."""
    P = param_count(cfg)
    P_active = active_param_count(cfg)
    dt = 2  # bf16
    n_batch_shards = max(n_chips // n_model, 1)
    train = shape.kind == "train"
    passes = {"train": 4, "prefill": 1, "decode": 1}[shape.kind]
    # weights: each device reads its TP shard of the *active* params every
    # pass (fwd + remat-refwd + 2 bwd matmuls per weight)
    weights = P_active / n_model * dt * passes
    total = weights
    if train:
        # optimizer: grads (fp32 w+r) + m/v (r+w) + param (r+w), ZeRO-sharded
        state_b = 2 if cfg.opt_state_dtype == "bfloat16" else 4
        shard = P / n_chips
        total += shard * (2 * 4 + 2 * 2 * state_b + 2 * dt)
    # activations
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    tok_loc = max(tokens // n_batch_shards, 1)
    D, H, Kv, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.hd, cfg.d_ff)
    act_passes = 3 if train else 1   # fwd + remat refwd + bwd
    F_eff = F * (cfg.experts_per_token if cfg.num_experts else 1)
    per_layer = (4 * D + 2 * (H * hd + Kv * hd) / n_model
                 + 3 * F_eff / n_model)
    total += cfg.num_layers * tok_loc * per_layer * dt * act_passes
    # attention score/prob traffic (chunked path, fp32)
    S = shape.seq_len
    n_attn = sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l))
    if shape.kind != "decode":
        eff_ctx = min(cfg.sliding_window or S, S)
        probs = n_attn * tok_loc * eff_ctx * (H / n_model) * 4 * act_passes
        total += 2 * probs      # scores + probs
    else:
        # decode reads the whole (sharded) KV cache once per step
        cache_tokens = min(cfg.sliding_window or S, S)
        kv = n_attn * shape.global_batch * cache_tokens * 2 * Kv * hd * dt
        total += kv / n_chips
    # recurrent-state traffic (mamba / rwkv)
    if cfg.family in ("hybrid", "ssm"):
        n_mix = cfg.num_layers - n_attn if cfg.family == "hybrid" \
            else cfg.num_layers
        d_inner = (cfg.ssm_expand * D if cfg.family == "hybrid"
                   else D)
        state = cfg.ssm_d_state if cfg.family == "hybrid" else cfg.rwkv_head_dim
        total += (n_mix * tok_loc * d_inner / n_model * state * 4
                  * act_passes * 0.25)   # chunked scan touches state/chunk
    return float(total)


# ---------------------------------------------------------------------------
# roofline assembly
# ---------------------------------------------------------------------------

@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_ici: float
    wire_dcn: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    peak_memory_bytes: float
    argument_bytes: float
    collectives: dict = field(default_factory=dict)

    def terms(self) -> RooflineTerms:
        return RooflineTerms(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of ideal compute-bound throughput (MFU-like, modeled)."""
        ideal = self.model_flops / (self.n_chips * PEAK_FLOPS)
        return ideal / self.step_s if self.step_s else 0.0

    def to_dict(self):
        d = dict(self.__dict__)
        d["step_s"] = self.step_s
        d["roofline_fraction"] = self.roofline_fraction
        return d

    def to_records(self):
        """Emit this cell in the unified experiment Record schema."""
        from repro_torch.experiments.record import Record
        name = f"{self.arch}.{self.shape}.{self.mesh}"
        base = {"bottleneck": self.bottleneck, "n_chips": self.n_chips}
        return [
            Record("roofline.table", name, "roofline_fraction",
                   self.roofline_fraction,
                   params=dict(base, compute_s=self.compute_s,
                               memory_s=self.memory_s,
                               collective_s=self.collective_s,
                               useful_ratio=self.useful_ratio)),
            Record("roofline.table", name, "step_s", self.step_s, unit="s",
                   params=base),
        ]


def analyze(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
            n_chips: int, costs) -> CellRoofline:
    """The cell's roofline from one rank's ``costs``
    (``analysis/cost.Costs``).  The memory term's model axis is the
    reference's fixed 16, whatever the mesh."""
    flops = costs.flops
    n_model = 16
    bytes_acc = analytic_memory_bytes(cfg, shape, n_chips, n_model)
    summ: CollectiveSummary = costs.summary()

    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = (summ.ici_wire_bytes / ICI_BW
                    + summ.dcn_wire_bytes / DCN_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mf = model_flops(cfg, shape)
    hlo_global = flops * n_chips
    return CellRoofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        flops_per_device=flops, bytes_per_device=bytes_acc,
        wire_ici=summ.ici_wire_bytes, wire_dcn=summ.dcn_wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        peak_memory_bytes=costs.peak_bytes,
        argument_bytes=costs.argument_bytes,
        collectives=dict(summ.to_dict(),
                         hbm_bytes_upper_bound=costs.hbm_bytes),
    )
