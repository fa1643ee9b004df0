"""Mistral NeMo 12B: dense GQA, 128k context, head_dim 128 (!= d_model/H).

[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    layer_group=1,
    remat="full",
    source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
))
