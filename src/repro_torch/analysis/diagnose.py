"""Per-cell collective breakdown (perf-iteration profiling aid).

Counterpart of ``repro/analysis/diagnose.py``: the cell's step run once
on meta tensors (``launch/dryrun.lower_cell``), its recorded collectives
ranked by wire bytes.

  PYTHONPATH=src python -m repro_torch.analysis.diagnose <arch> <shape> [pod|multipod] [--sp] [--dp=METHOD]
"""
from __future__ import annotations

import collections
import sys

from repro_torch.configs import all_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_production_mesh


def breakdown(costs, top: int = 14) -> list:
    """``(wire bytes, kind, operand MB, axis, is_dcn)`` of the ``top``
    (kind, operand size, axis, link) classes, most bytes first."""
    agg = collections.Counter()
    for c in costs.collectives:
        key = (c.kind, f"{c.operand_bytes/1e6:.0f}MB", c.comp, c.is_dcn)
        agg[key] += c.wire_bytes * c.count
    return [(wb,) + key for key, wb in agg.most_common(top)]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arch, shape = argv[0], argv[1]
    mesh_name = argv[2] if len(argv) > 2 and not argv[2].startswith("--") \
        else "pod"
    sp = "--sp" in argv
    dp = "stock"
    for a in argv:
        if a.startswith("--dp="):
            dp = a.split("=")[1]
    cfg = all_archs()[arch]
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    _, costs = lower_cell(cfg, SHAPES[shape], mesh, sp=sp, dp=dp)[0].cost()
    summ = costs.summary()
    print(f"total wire: {summ.total_wire_bytes/1e9:.1f} GB/device "
          f"ici={summ.ici_wire_bytes/1e9:.1f} dcn={summ.dcn_wire_bytes/1e9:.1f}")
    for wb, kind, sz, axis, dcn in breakdown(costs):
        print(f"  {wb/1e9:8.1f}GB  {kind:20s} op={sz:>8s} {axis:6s} "
              f"{'DCN' if dcn else 'ICI'}")


if __name__ == "__main__":
    main()
