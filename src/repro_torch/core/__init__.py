"""The paper's characterizations on the port (counterpart of
``repro/core``): so far the serving family (``core/serving.py``) and the
serving half of the degraded-fabric family (``core/fabric.py``).  They
emit the unified ``repro_torch.experiments.Record`` schema and run through
the ``repro_torch.experiments`` Runner/CLI."""
from repro_torch.experiments.record import Record  # noqa: F401
