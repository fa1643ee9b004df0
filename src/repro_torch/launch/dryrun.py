"""Multi-pod dry run: cost every (arch x shape x mesh) cell on meta tensors.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's step against ``ShapeDtypeStruct`` inputs on 512
fabricated host devices and reads the costs from the compiled module.
The port has no compiler to ask: for each live cell (see
``configs.base.live_shapes`` for the long_500k skip rule) it builds one
rank's state on the meta device (no storage: ``common.MetaGenerator``)
and runs that rank's real step once on a production mesh of recording
axes (``launch/mesh.make_production_mesh``) under the counters of
``analysis/cost.py`` — the train step (``train/step.make_train_step``:
the mesh step, FSDP over ``data``, tensor parallelism over ``model``, an
int8 reduction over ``pod``) for train_4k, ``registry.prefill`` for
prefill_32k, ``registry.decode_step`` for the decode cells — and emits
the three-term H100 roofline (``analysis/roofline.py``).

* ``lower_s`` is the seconds of building the meta state and running the
  step; ``compile_s`` is 0.0: nothing is compiled, the port runs eagerly.
* ``peak_memory_bytes`` is the live storages' high-water mark of the
  rank, its arguments' included; ``output_bytes`` the result's new
  storages and ``temp_bytes`` the rest of the peak.
* Serving holds the parameters split over ``model`` and whole over
  ``data`` and ``pod``, which split the batch rows; a batch with fewer
  rows than ``data x pod`` (long_500k's one sequence) is run whole by
  every rank, since the port splits no cache sequence over ranks.
* A cell whose widths the port's model axis refuses
  (``transformer.check_tp``) fails: a ``FAILED`` line, exit 1.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from dataclasses import dataclass

import torch

from repro_torch import bridge
from repro_torch.analysis import cost
from repro_torch.analysis import roofline as rf
from repro_torch.configs import all_archs, live_shapes
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, registry
from repro_torch.train import step as tstep
from repro_torch.train.optimizer import OptConfig

DEFAULT_OUT = "experiments/dryrun_torch"


@dataclass
class Lowered:
    """A cell's step and its meta arguments: :meth:`cost` runs it once
    under the counters."""
    fn: object
    args: tuple

    def cost(self):
        return cost.measure(self.fn, *self.args)


def _rows(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch: split over ``data`` and
    ``pod``, or the whole batch where it has fewer rows than them."""
    n = mesh.dp_size * mesh.shape.get("pod", 1)
    out = {}
    for k, v in batch.items():
        if v.dim() == 0 or v.shape[0] < n:
            out[k] = v
            continue
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"over {n} data ranks")
        out[k] = v[:v.shape[0] // n]
    return out


def _serve_params(cfg, mesh):
    """This rank's serving parameters on the meta device, and the axis."""
    gen = common.MetaGenerator()
    if mesh.tp_size == 1:
        return registry.init_params(cfg, gen), None
    return bridge.init_shards(cfg, gen, mesh.tp_size,
                              mesh.axis.held), mesh.axis


def lower_cell(cfg, shape, mesh, options=None, sp=False, dp=None,
               remat=None):
    """Returns ``(lowered, mesh)``: the step for ``shape.kind`` and this
    rank's meta arguments (module docstring)."""
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    gen = common.MetaGenerator()
    if shape.kind == "train":
        options = options or tstep.TrainOptions(
            dp_method=dp or ("int8_a2a" if "pod" in mesh.axis_names
                             else "stock"),
            sequence_parallel=sp,
            opt=OptConfig(state_dtype=cfg.opt_state_dtype))
        state = tstep.make_train_state(cfg, options, gen, mesh)
        step = tstep.make_train_step(cfg, shape, mesh, options)
        return Lowered(step, (state, registry.input_specs(cfg, shape))), mesh
    params, axis = _serve_params(cfg, mesh)
    batch = _rows(registry.input_specs(cfg, shape), mesh)
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return registry.prefill(cfg, params, batch, axis=axis)
        return Lowered(prefill, (params, batch)), mesh
    caches = registry.abstract_decode_caches(
        cfg, batch["tokens"].shape[0], shape.seq_len, axis=axis)

    def decode(params, caches, batch):
        with torch.no_grad():
            return registry.decode_step(cfg, params, batch, caches,
                                        axis=axis)
    return Lowered(decode, (params, caches, batch)), mesh


def run_cell(cfg, shape, mesh_name: str, verbose: bool = True,
             sp: bool = False, dp=None, remat=None, mesh=None,
             options=None):
    """The cell's JSON record on ``mesh_name``'s production mesh (or on
    ``mesh``, named ``mesh_name``, where given)."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    n_chips = mesh.size
    t0 = time.time()
    lowered, _ = lower_cell(cfg, shape, mesh, options=options, sp=sp, dp=dp,
                            remat=remat)
    _, costs = lowered.cost()
    t1 = time.time()
    if verbose:
        print(f"  memory (meta run): args={costs.argument_bytes/1e9:.3f}GB "
              f"out={costs.output_bytes/1e9:.3f}GB "
              f"temp={costs.temp_bytes/1e9:.3f}GB "
              f"peak={costs.peak_bytes/1e9:.3f}GB per device")
        print(f"  counted: flops={costs.flops:.3e} "
              f"bytes={costs.hbm_bytes:.3e} per device")
    cell = rf.analyze(cfg, shape, mesh_name, n_chips, costs)
    out = cell.to_dict()
    out["lower_s"] = t1 - t0
    out["compile_s"] = 0.0
    out["output_bytes"] = costs.output_bytes
    out["temp_bytes"] = costs.temp_bytes
    if verbose:
        print(f"  roofline: compute={cell.compute_s*1e3:.2f}ms "
              f"memory={cell.memory_s*1e3:.2f}ms "
              f"collective={cell.collective_s*1e3:.2f}ms "
              f"-> {cell.bottleneck}-bound "
              f"(roofline fraction {cell.roofline_fraction:.1%}, "
              f"useful {cell.useful_ratio:.1%})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel TP (perf variant)")
    ap.add_argument("--dp", default=None,
                    help="override DP method (stock | int8_a2a | int8_ring)")
    ap.add_argument("--remat", default=None,
                    help="override remat policy (none|full|dots_saveable)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = all_archs()
    names = [args.arch] if args.arch else list(archs)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    failures = []
    for name in names:
        cfg = archs[name]
        shapes = ([SHAPES[args.shape]] if args.shape
                  else live_shapes(cfg))
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{name}__{shape.name}__{mesh_name}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[cell] {tag}")
                try:
                    out = run_cell(cfg, shape, mesh_name, sp=args.sp,
                                   dp=args.dp, remat=args.remat)
                    with open(path, "w") as f:
                        json.dump(out, f, indent=1)
                except Exception as e:
                    failures.append(tag)
                    print(f"  FAILED: {type(e).__name__}: {e}")
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all cells passed")


if __name__ == "__main__":
    main()
