"""Fault-tolerant training loop: checkpoint/restart, straggler detection.

Counterpart of ``repro/train/loop.py``.  Failure model (single-process
stand-in for a fleet):

  * a step may raise (injected via ``fault_hook`` in tests, real
    preemption in production) -> restore from the last committed checkpoint
    and replay; the data pipeline is position-keyed so replays are
    deterministic.
  * per-step wall times feed a running z-score straggler detector.

A step's timed region ends on ``.item()`` of its loss, which waits for the
device (the counterpart of the reference's ``block_until_ready``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.obs import trace as obs_trace


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    straggler_zscore: float = 3.0
    max_restarts: int = 3


@dataclass
class StragglerStats:
    times: list = field(default_factory=list)

    def observe(self, dt: float) -> Optional[str]:
        self.times.append(dt)
        if len(self.times) < 10:
            return None
        arr = np.array(self.times[-100:])
        mu, sd = arr.mean(), arr.std() + 1e-9
        z = (dt - mu) / sd
        if z > 3.0:
            return (f"straggler step: {dt*1e3:.1f}ms vs mean {mu*1e3:.1f}ms "
                    f"(z={z:.1f}) — would report host for exclusion")
        return None


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def train_loop(step_fn: Callable, state, data_cfg: DataConfig, device,
               manager: CheckpointManager, loop: LoopConfig,
               start_step: int = 0,
               fault_hook: Optional[Callable[[int], None]] = None,
               log: Callable[[str], None] = print):
    """Run the loop on ``device``; returns (state, history).  Restores on
    step failure."""
    stats = StragglerStats()
    history = []
    # the state's structure, shapes and dtypes, for a restore after a
    # failure (the step updates the state in place, so a step that fails
    # half way leaves nothing to go by)
    like = _meta_tree(state)
    step = start_step
    restarts = 0
    while step < loop.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            batch = {k: v.to(device)
                     for k, v in synth_batch(data_cfg, step).items()}
            tr = obs_trace.current()
            t0 = time.perf_counter()
            # the span brackets exactly the timed region (issue + wait)
            with tr.span("train", "step", "train", step=step):
                state, metrics = step_fn(state, batch)
                loss = metrics["loss"].item()
            dt = time.perf_counter() - t0
            if tr.enabled:
                tr.metrics.observe("train_step_s", dt)
            warn = stats.observe(dt)
            if warn:
                log(f"[step {step}] {warn}")
            history.append({"step": step, "loss": loss, "time_s": dt})
            if loop.log_every and step % loop.log_every == 0:
                log(f"[step {step}] loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            step += 1
            if loop.checkpoint_every and step % loop.checkpoint_every == 0:
                with tr.span("train", "checkpoint", "train", step=step):
                    manager.save(step, state)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # preemption / injected fault
            restarts += 1
            if restarts > loop.max_restarts:
                raise
            manager.wait()
            last = manager.latest_step()
            log(f"[step {step}] FAILURE ({type(e).__name__}: {e}); "
                f"restoring from step {last} (restart {restarts})")
            if last is None:
                raise
            state, step = manager.restore(like, device=device)
    manager.wait()
    return state, history
