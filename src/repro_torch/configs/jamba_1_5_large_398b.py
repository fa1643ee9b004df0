"""Jamba 1.5 Large 398B: hybrid Mamba+attention (1:7 interleave), MoE 16e top-2.

Groups of 8 layers (7 Mamba + 1 attention, MoE on every 2nd layer) are the
scan unit.  Optimizer state is bf16 so ZeRO-sharded state fits a 256-chip
v5e pod (see DESIGN.md section 8).

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_period=8,               # 1 attention layer per 8 (1:7 Mamba)
    ssm_d_state=16,
    ssm_conv_width=4,
    ssm_expand=2,
    act="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    layer_group=8,
    remat="full",
    opt_state_dtype="bfloat16",
    source="[arXiv:2403.19887; hf]",
))
