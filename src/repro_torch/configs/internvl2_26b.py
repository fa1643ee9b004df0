"""InternVL2 26B backbone: InternLM2-20B LM (48L, GQA kv=8) + stubbed InternViT.

Patch embeddings arrive precomputed (input_specs); vit_proj is the connector.
vocab 92553 is not divisible by the 16-way model axis -> the lm_head/vocab
sharding rule is pruned to replicated for this arch (see sharding.safe_spec).

[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    num_patches=256,
    act="swiglu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    layer_group=1,
    remat="full",
    source="[arXiv:2404.16821; hf]",
))
