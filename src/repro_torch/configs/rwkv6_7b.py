"""RWKV-6 (Finch) 7B: attention-free, data-dependent decay, ReLU^2 channel mix.

[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
    act="relu2",
    tie_embeddings=False,
    layer_group=1,
    remat="full",
    source="[arXiv:2404.05892; hf]",
))
