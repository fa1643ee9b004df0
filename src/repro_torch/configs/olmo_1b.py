"""OLMo 1B: dense MHA (kv=16=H), non-parametric LayerNorm.

[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="ln_nonparam",
    act="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    layer_group=1,
    remat="full",                # attention probs must not be saved (S^2 fp32)
    source="[arXiv:2402.00838; hf]",
))
