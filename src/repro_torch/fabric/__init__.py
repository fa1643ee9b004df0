"""Degraded-fabric injection: the scenario model and its enforcement
points.

Counterpart of ``repro/fabric`` (DESIGN.md section 12).  ``condition`` is
the scenario model and ``serve`` the continuous engine's hook, both the
reference's text; ``inject`` is the collective-chain enforcement point, a
burn spliced into the gradient chains of ``parallel/collectives.py`` on
either pod axis (``parallel/pods.py``).
"""
from repro_torch.fabric.condition import FabricCondition, canonical_conditions
from repro_torch.fabric.inject import ChainInjector
from repro_torch.fabric.serve import ServeFabric

__all__ = [
    "ChainInjector",
    "FabricCondition",
    "canonical_conditions",
    "ServeFabric",
]
