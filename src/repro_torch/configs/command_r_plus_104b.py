"""Command R+ 104B: dense GQA, parallel attn+FFN block, tied embeddings.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    act="swiglu",
    parallel_block=True,
    tie_embeddings=True,
    use_bias=False,
    rope_theta=75_000_000.0,
    layer_group=1,
    remat="full",
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
))
