"""Checkpointing: atomic commit, retention, restore onto a device.

Counterpart of ``repro/checkpoint/manager.py``, with its format: one
``.npy`` per tree leaf (named by position, keyed by its dotted path in
``meta.json``).  Writes go to ``<dir>/tmp.<step>`` and are committed by a
single atomic rename to ``<dir>/step_<step>`` — a crash mid-write never
corrupts the latest checkpoint.  numpy has no bfloat16, so a bf16 leaf is
stored as its ``uint16`` bit pattern with ``"bfloat16"`` as its dtype in
``meta.json``, and comes back bit for bit.  ``restore`` puts every leaf on
the given device (the reference's elastic reshard becomes a choice of
device on one card).

A mesh's state (``layout=`` a ``train/step.MeshCheckpoint``) is saved as
its full arrays, gathered from the shards (every rank process gathers,
the mesh's lead process writes), and restored as each rank's shards of
them: the files are those of a one-device run of the same state, so
either resumes the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

_NP_DTYPES = {"float32": torch.float32, "float64": torch.float64,
              "float16": torch.float16, "int32": torch.int32,
              "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8,
              "bool": torch.bool}


def _flatten(tree, prefix=()):
    """``(dotted path, leaf)`` in sorted-key order (the reference's
    ``_path_key`` of a dict path)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix), tree


def _rebuild(tree, leaves: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    return leaves[".".join(prefix)]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: the step updates its tensors in place
    while an asynchronous save may still be writing)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 layout=None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.layout = layout
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state) -> str:
        """Snapshot to host memory synchronously, write/commit (a)synchronously."""
        if self.layout is not None:
            state = self.layout.to_full(state)
            if not self.layout.writes:
                return os.path.join(self.dir, f"step_{step}")
        host = [(key, _to_host(v), "bfloat16" if v.dtype == torch.bfloat16
                 else None) for key, v in _flatten(state)]
        self.wait()
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._pending.start()
        else:
            self._write(step, host)
        return os.path.join(self.dir, f"step_{step}")

    def _write(self, step: int, host):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        names = {}
        for key, arr, dtype in host:
            fname = f"{len(names)}.npy"
            names[key] = {"file": fname, "dtype": dtype or str(arr.dtype),
                          "shape": list(arr.shape)}
            np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "leaves": names}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._retain()

    def _retain(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None, device=None):
        """Load into the structure, shapes and dtypes of ``state_like`` (a
        tree of tensors), every leaf on ``device`` (default: the matching
        leaf's own device).  Returns ``(state, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if self.layout is not None:
            full, step = self._load(self.layout.full_like(state_like), step,
                                    "cpu")
            return self.layout.from_full(full, state_like, device), step
        return self._load(state_like, step, device)

    def _load(self, state_like, step: int, device):
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves = meta["leaves"]
        out = {}
        for key, like in _flatten(state_like):
            if key not in leaves:
                raise KeyError(f"checkpoint {d} missing leaf {key}")
            entry = leaves[key]
            arr = np.load(os.path.join(d, entry["file"]))
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr).to(_NP_DTYPES[entry["dtype"]])
            if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                raise ValueError(f"checkpoint leaf {key}: {tuple(t.shape)} "
                                 f"{t.dtype}, expected {tuple(like.shape)} "
                                 f"{like.dtype}")
            out[key] = t.to(like.device if device is None else device)
        return _rebuild(state_like, out), step
