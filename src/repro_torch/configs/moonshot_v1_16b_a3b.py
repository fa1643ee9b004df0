"""Moonshot (Moonlight) 16B-A3B: 64 experts top-6 + shared experts, MHA kv=16.

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                   # per-expert
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_every=1,
    shared_experts=2,
    act="swiglu",
    tie_embeddings=True,
    rope_theta=50_000.0,
    layer_group=2,
    remat="full",
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
))
