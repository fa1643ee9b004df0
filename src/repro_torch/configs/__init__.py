"""Architecture configs of the port.  Importing this package registers the
archs ported so far (other archs arrive with their model families)."""
from repro_torch.configs import olmo_1b, rwkv6_7b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, all_archs, get, live_shapes, smoke,
)
