"""Whisper base: 6L encoder + 6L decoder, GELU, parametric LayerNorm.

Conv/mel frontend is a STUB (input_specs provides frame embeddings).

[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,                # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    use_bias=True,
    tie_embeddings=True,
    frame_input=True,
    layer_group=1,
    remat="full",
    source="[arXiv:2212.04356; unverified]",
))
