"""The paper's contribution on the port (counterpart of ``repro/core``):
characterization-driven offload — the headroom probe
(``core/headroom.py``), the stressor suite and its class aggregates
(``core/stressors.py``, ``core/classes.py``), the in-path transforms
(``core/inpath.py``), the planner (``core/planner.py``), the serving
family (``core/serving.py``) and the serving half of the degraded-fabric
family (``core/fabric.py``).

All characterizations emit the unified ``repro_torch.experiments.Record``
schema and run through the ``repro_torch.experiments`` Runner/CLI; the
modules here hold the measurements themselves."""
from repro_torch.core.headroom import RooflineTerms, derived_headroom  # noqa: F401
from repro_torch.core.planner import OffloadPlan, make_plan  # noqa: F401
from repro_torch.experiments.record import Record  # noqa: F401
