"""Architecture configs of the port.  Importing this package registers the
archs ported so far (other archs arrive with their model families)."""
from repro_torch.configs import (  # noqa: F401
    command_r_plus_104b,
    h2o_danube_3_4b,
    mistral_nemo_12b,
    olmo_1b,
    rwkv6_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, all_archs, get, live_shapes, smoke,
)
