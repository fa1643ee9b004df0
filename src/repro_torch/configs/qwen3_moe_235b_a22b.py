"""Qwen3-MoE 235B-A22B: 128 experts top-8, GQA kv=4, per-expert d_ff 1536.

[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,                   # per-expert
    vocab_size=151936,
    head_dim=128,
    num_experts=128,
    experts_per_token=8,
    moe_every=1,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    layer_group=2,
    remat="full",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
))
