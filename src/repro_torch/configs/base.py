"""Config system: architecture configs, input shapes, smoke reductions.

Every assigned architecture is a frozen ``ArchConfig`` built from the published
dims.  ``smoke()`` derives a reduced same-family config for CPU tests.  The four
assigned input shapes are module-level constants; ``cells(cfg)`` enumerates the
live (arch x shape) cells, applying the sub-quadratic skip rule for
``long_500k`` (see DESIGN.md section 5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE FFN on layers with (l % moe_every == moe_every - 1)
    shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (Jamba): 1 attention layer per attn_period, rest Mamba ---
    attn_period: int = 0           # 0 = every layer is attention
    # --- SSM (Mamba) ---
    ssm_d_state: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- RWKV ---
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # --- attention details ---
    sliding_window: int = 0        # 0 = full attention
    rope_theta: float = 1_000_000.0
    # --- misc arch ---
    norm: str = "rmsnorm"          # rmsnorm | ln_nonparam
    act: str = "swiglu"            # swiglu | gelu | relu2
    tie_embeddings: bool = True
    use_bias: bool = False
    parallel_block: bool = False   # command-r style parallel attn+FFN
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    # --- VLM stub frontend ---
    num_patches: int = 0           # precomputed patch embeddings prepended to text
    # --- frame stub (audio): encoder input length is frames, not tokens ---
    frame_input: bool = False
    # --- compilation structure ---
    layer_group: int = 1           # scan over groups of this many layers
    # --- runtime policy ---
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "full"            # none | full | dots_saveable
    source: str = ""               # provenance note [source; tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see assignment skip rule)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def num_groups(self) -> int:
        assert self.num_layers % max(self.layer_group, 1) == 0, self.name
        return self.num_layers // max(self.layer_group, 1)

    def is_attn_layer(self, l: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period:
            # one attention layer per period, at the end of the period
            return (l % self.attn_period) == self.attn_period - 1
        return True

    def is_moe_layer(self, l: int) -> bool:
        if not self.num_experts:
            return False
        return (l % self.moe_every) == self.moe_every - 1


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def live_shapes(cfg: ArchConfig):
    """Shapes that apply to this arch (skip rule from the assignment)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


def smoke(cfg: ArchConfig, seq: int = 32) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (tiny dims, same topology)."""
    group = 2 if cfg.layer_group > 1 else 1
    n_layers = 2 * max(group, cfg.attn_period or 1, cfg.moe_every)
    kv = max(1, min(2, cfg.num_kv_heads))
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=kv if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        shared_experts=min(cfg.shared_experts, 1),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        rwkv_head_dim=16,
        rwkv_lora_rank=8,
        ssm_d_state=4,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_patches=4 if cfg.num_patches else 0,
        layer_group=group,
        attn_period=min(cfg.attn_period, 4) if cfg.attn_period else 0,
        remat="none",
    )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    # import side-effect registers all assigned archs
    from repro_torch import configs as _  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict[str, ArchConfig]:
    from repro_torch import configs as _  # noqa: F401
    return dict(_REGISTRY)
