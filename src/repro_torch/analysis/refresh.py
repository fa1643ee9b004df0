"""Recompute the analytic fields of dry-run JSONs in place.

Counterpart of ``repro/analysis/refresh.py``: model_flops / useful_ratio /
roofline_fraction / the memory term are analytic (no meta run needed),
so a fix to ``analysis/roofline.py``'s model reaches cells already
costed.  Usage:
PYTHONPATH=src python -m repro_torch.analysis.refresh <dir>
"""
from __future__ import annotations

import glob
import json
import sys

from repro_torch.analysis import roofline as rf
from repro_torch.configs import all_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import DEFAULT_OUT


def refresh_record(d: dict) -> dict:
    cfg = all_archs()[d["arch"]]
    shape = SHAPES[d["shape"]]
    mf = rf.model_flops(cfg, shape)
    d["model_flops"] = mf
    d["hlo_flops_global"] = d["flops_per_device"] * d["n_chips"]
    d["useful_ratio"] = mf / d["hlo_flops_global"] if d["hlo_flops_global"] else 0
    d["bytes_per_device"] = rf.analytic_memory_bytes(cfg, shape, d["n_chips"])
    d["memory_s"] = d["bytes_per_device"] / rf.HBM_BW
    terms = {"compute": d["compute_s"], "memory": d["memory_s"],
             "collective": d["collective_s"]}
    d["bottleneck"] = max(terms, key=terms.get)
    d["step_s"] = max(terms.values())
    ideal = mf / (d["n_chips"] * rf.PEAK_FLOPS)
    d["roofline_fraction"] = ideal / d["step_s"] if d["step_s"] else 0.0
    return d


def main(dirname: str):
    for f in sorted(glob.glob(f"{dirname}/*.json")):
        with open(f) as fh:
            d = refresh_record(json.load(fh))
        with open(f, "w") as fh:
            json.dump(d, fh, indent=1)
        print(f"{d['arch']:24s} {d['shape']:12s} {d['mesh']:9s} "
              f"{d['bottleneck']:11s} roofline={d['roofline_fraction']:.1%} "
              f"useful={d['useful_ratio']:.1%}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)
