"""H2O Danube3 4B: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    act="swiglu",
    sliding_window=4096,         # SWA => sub-quadratic, runs long_500k
    tie_embeddings=False,
    rope_theta=10_000.0,
    layer_group=1,
    remat="full",
    source="[arXiv:2401.16818; unverified]",
))
