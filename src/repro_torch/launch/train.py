"""End-to-end training CLI.

Counterpart of ``repro/launch/train.py`` with the same flags, running on
the CUDA device (it raises where there is none): the train step, the
deterministic data pipeline, the checkpoint manager and the fault-tolerant
loop.  The reference's ``make_host_mesh`` has a ``data`` and a ``model``
axis and never a ``pod`` axis, so its CLI trains on one device without a
pod reduction (a compressed ``--dp-method`` keeps its error-feedback state
and passes it through); so does this one.  ``--data-mesh D --model-mesh
M`` trains on a ``(data, model)`` mesh (``launch/mesh.make_host_mesh``):
emulated in this process, or, with ``--devices D·M``, one process a rank
over gloo (``parallel/dist.run_ranks``; rank 0 prints and writes the
checkpoints, which hold the full arrays, so a mesh run resumes a
one-device run's checkpoint and the reverse).  ``--devices`` is the
port's flag (the reference's CLI runs on the devices JAX sees, as
``launch/serve.py``'s ``--devices`` does); it must equal ``D·M``, and a
``--model-mesh`` above 1 takes every family whose widths it splits
(``models/transformer.check_tp_train``: heads, experts, ``d_ff``,
Mamba's ``d_inner``; the reference's flags do not ask for sequence
parallelism, which the train step takes on every family,
``TrainOptions.sequence_parallel``).

``--plan TERMS.json`` derives the offload plan as the reference does: the
roofline terms (``compute_s``, ``memory_s``, ``collective_s``) from the
file (a dry run's cell JSON, ``launch/dryrun.py``, as it is), the stressor suite measured on the device (``run_suite(duration=
0.1)``), ``make_plan(..., multi_pod=False, grad_bytes=4 * n_params)``; it
prints ``[plan]`` and the plan's notes and applies ``microbatches`` and
``dp_overlap`` (without a pod axis the reduction stays ``stock``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
        --data-mesh 2 --model-mesh 2 [--devices 4]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --scale 0.4 --steps 200 --batch 8 --seq 256 --plan terms.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile


def scaled_config(cfg, scale: float):
    """Geometric down-scale of a config (keeps family/topology)."""
    if scale >= 1.0:
        return cfg
    d = max(128, int(cfg.d_model * scale) // 128 * 128)
    heads = max(4, int(cfg.num_heads * scale))
    kv = max(1, min(cfg.num_kv_heads, heads))
    return dataclasses.replace(
        cfg, name=cfg.name + f"-x{scale}", d_model=d,
        num_layers=max(2, int(cfg.num_layers * scale)),
        num_heads=heads, num_kv_heads=kv, head_dim=d // heads,
        d_ff=max(256, int(cfg.d_ff * scale) // 128 * 128),
        vocab_size=min(cfg.vocab_size, 32000),
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        layer_group=1, attn_period=min(cfg.attn_period, 4) if cfg.attn_period else 0,
        rwkv_head_dim=64 if d % 64 == 0 else 32,
    )


def _config(args, ap):
    """The run's config, or the parser's error for an arch the port does
    not have or a model axis the arch's family does not take."""
    from repro_torch.configs import all_archs, smoke
    from repro_torch.models.transformer import check_tp_train

    if args.arch not in all_archs():
        ap.error(f"--arch {args.arch!r}: ported archs are "
                 f"{sorted(all_archs())}")
    base = all_archs()[args.arch]
    cfg = smoke(base) if args.smoke else scaled_config(base, args.scale)
    cfg = dataclasses.replace(cfg, remat="none")
    if args.model_mesh > 1:
        try:
            check_tp_train(cfg, args.model_mesh)
        except (NotImplementedError, ValueError) as exc:
            ap.error(f"--model-mesh {args.model_mesh}: {exc}")
    return cfg


def main(argv=None, device="cuda"):
    """Run the CLI.  ``device`` is a Python-level argument for tests
    (``"cpu"``); the command line always runs on the CUDA device."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--scale", type=float, default=0.4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp-method", default="stock")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--plan", default=None,
                    help="JSON of roofline terms (compute_s, memory_s, "
                         "collective_s) to derive the offload plan from, "
                         "with the stressor suite measured on the device")
    ap.add_argument("--smoke", action="store_true",
                    help="use the tiny smoke config instead of --scale")
    ap.add_argument("--trace-out", default="",
                    help="save a Chrome-trace-event JSON span timeline of "
                         "the run (per-step and checkpoint spans) at PATH")
    ap.add_argument("--devices", type=int, default=1,
                    help="run the mesh's D x M ranks as that many processes "
                         "over gloo (default: the mesh emulated in one)")
    args = ap.parse_args(argv)
    n = args.data_mesh * args.model_mesh
    if min(args.data_mesh, args.model_mesh, args.devices) < 1:
        ap.error("--data-mesh, --model-mesh and --devices take sizes >= 1")
    if args.devices > 1 and args.devices != n:
        ap.error(f"--devices {args.devices}: the mesh's ranks run one a "
                 f"process, so --devices must be --data-mesh x "
                 f"--model-mesh = {n}")
    _config(args, ap)              # refuse what the ranks would refuse
    if args.devices > 1:
        from repro_torch.parallel import rank_bodies
        from repro_torch.parallel.dist import run_ranks
        return run_ranks(rank_bodies.train_cli, n, backend="gloo",
                         device=device, args=(args, ap.prog))[0]
    return run(args, device, ap)


def run(args, device, ap, ranks=None):
    """The CLI's run on ``device`` (``ranks``: this process's rank of the
    group over which ``--devices`` runs the mesh)."""
    import torch

    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import for_arch
    from repro_torch.runtime import resolve_device
    from repro_torch.train import loop as tloop, step as tstep
    from repro_torch.train.optimizer import OptConfig

    cfg = _config(args, ap)
    device = resolve_device(device)
    mesh = None
    if args.data_mesh * args.model_mesh > 1:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(args.data_mesh, args.model_mesh, ranks=ranks)
    lead = mesh is None or mesh.is_lead
    say = print if lead else (lambda *a, **k: None)
    opts = tstep.TrainOptions(
        dp_method=args.dp_method, microbatches=args.microbatches,
        remat=False,
        opt=OptConfig(lr=args.lr, warmup_steps=20,
                      decay_steps=max(args.steps, 21)))
    n_params = sum(math.prod(s) for s in bridge.param_shapes(cfg).values())
    if args.plan:
        from repro_torch.core.headroom import RooflineTerms
        from repro_torch.core.planner import make_plan
        from repro_torch.core.stressors import run_suite
        with open(args.plan) as f:
            d = json.load(f)
        plan = make_plan(RooflineTerms(d["compute_s"], d["memory_s"],
                                       d["collective_s"]),
                         run_suite(duration=0.1, device=device),
                         multi_pod=False,
                         # gradients cross the pod axis as fp32 bucket
                         # buffers — the planner's bucket-count (and so
                         # overlap) estimate keys on this
                         grad_bytes=4 * n_params)
        say("[plan]", *plan.notes, sep="\n  ")
        # no pod axis: the reduction stays stock, as the reference's CLI
        opts = dataclasses.replace(opts, dp_method="stock",
                                   microbatches=plan.microbatches,
                                   dp_overlap=plan.dp_overlap)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen, mesh or 1)
    say(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
        f"device={device} pods=1 mesh="
        f"{dict(mesh.shape) if mesh else {'data': 1, 'model': 1}}"
        + (f" ranks={mesh.size}" if ranks is not None else ""))
    stepf = tstep.make_train_step(cfg, None, mesh or 1, opts)
    dcfg = for_arch(cfg, args.seq, args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, layout=None if mesh is None
                            else tstep.MeshCheckpoint(cfg, mesh))
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore(state, device=device)
        say(f"[train] resumed from step {start}")
    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer(metadata={"cli": "repro_torch.launch.train",
                                  "arch": cfg.name})
    with contextlib.ExitStack() as stack:
        if tracer is not None:
            from repro_torch.obs import trace as obs_trace
            stack.enter_context(obs_trace.use(tracer))
        state, hist = tloop.train_loop(
            stepf, state, dcfg, device, mgr,
            tloop.LoopConfig(total_steps=args.steps,
                             checkpoint_every=args.ckpt_every, log_every=10),
            start_step=start, log=say)
    if tracer is not None and lead:
        tracer.save(args.trace_out)
        say(f"[train] trace: {args.trace_out} "
            f"({len(tracer.events)} events)")
    if hist:
        say(f"[train] done: loss {hist[0]['loss']:.4f} -> "
            f"{hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
