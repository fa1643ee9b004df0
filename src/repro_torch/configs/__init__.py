"""Architecture configs of the port.  Importing this package registers all
ten archs, as the reference's does."""
from repro_torch.configs import (  # noqa: F401
    command_r_plus_104b,
    h2o_danube_3_4b,
    mistral_nemo_12b,
    olmo_1b,
    jamba_1_5_large_398b,
    rwkv6_7b,
    qwen3_moe_235b_a22b,
    moonshot_v1_16b_a3b,
    whisper_base,
    internvl2_26b,
)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, all_archs, get, live_shapes, smoke,
)
