"""Degraded-fabric injection for serving: the scenario model and the
engine hook.

Counterpart of ``repro/fabric`` (DESIGN.md section 12).  ``condition`` is
the scenario model and ``serve`` the continuous engine's hook, both the
reference's text.  The collective-chain enforcement point
(``repro/fabric/inject.py``) needs collectives over more than one rank
and comes with that slice of the port (ROADMAP Queue 1 item 9).
"""
from repro_torch.fabric.condition import FabricCondition, canonical_conditions
from repro_torch.fabric.serve import ServeFabric

__all__ = [
    "FabricCondition",
    "canonical_conditions",
    "ServeFabric",
]
