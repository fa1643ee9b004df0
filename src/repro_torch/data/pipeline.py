"""Deterministic synthetic data pipeline: prefetching, resumable.

Counterpart of ``repro/data/pipeline.py``.  Content is a position-keyed
hash (splitmix64, in numpy, the reference's arithmetic bit for bit) of
(stream_seed, step, index), so any step's batch can be regenerated exactly
after a restart — the loader resumes by step number alone.  Batches are
dicts of torch tensors on the CPU: ``tokens`` / ``labels`` int32, and the
stub ``frames`` / ``patches`` in bf16, rounded from f32 by torch (numpy has
no bf16; the rounding is the same round-to-nearest-even).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames_dim: int = 0       # encdec: frame-embedding dim (0 = none)
    patches: int = 0          # vlm: number of patch embeddings
    d_model: int = 0


def for_arch(arch, seq_len: int, global_batch: int) -> DataConfig:
    """The data config of ``arch`` (an ``ArchConfig``): an
    encoder-decoder's frames (``d_model`` wide, as many as the tokens) and
    a VLM's patches too, as the reference's ``registry.input_specs`` and
    its train CLI give them."""
    return DataConfig(vocab_size=arch.vocab_size, seq_len=seq_len,
                      global_batch=global_batch,
                      frames_dim=arch.d_model if arch.family == "encdec"
                      else 0, patches=arch.num_patches,
                      d_model=arch.d_model)


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """The (deterministic) global batch for ``step``."""
    B, S = cfg.global_batch, cfg.seq_len + 1
    base = np.uint64(cfg.seed) * np.uint64(1 << 40) + np.uint64(step) * np.uint64(1 << 20)
    idx = base + np.arange(B * S, dtype=np.uint64)
    toks = (_splitmix64(idx) % np.uint64(cfg.vocab_size)).astype(np.int32)
    toks = torch.from_numpy(toks.reshape(B, S))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frames_dim:
        f = _splitmix64(base + np.uint64(7) + np.arange(
            B * cfg.seq_len, dtype=np.uint64))
        f = (f.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
        f = np.repeat(f.reshape(B, cfg.seq_len, 1), 1, axis=-1) * np.ones(
            (1, 1, cfg.frames_dim), np.float32)
        out["frames"] = torch.from_numpy(f).to(torch.bfloat16)
    if cfg.patches:
        p = _splitmix64(base + np.uint64(13) + np.arange(
            B * cfg.patches * cfg.d_model, dtype=np.uint64))
        p = (p.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
        out["patches"] = torch.from_numpy(
            p.reshape(B, cfg.patches, cfg.d_model)).to(torch.bfloat16)
    return out


class Loader:
    """Prefetching loader: a thread makes the next batches and copies them
    to ``device`` — the card by default, as the reference's places them on
    its default device (it raises where there is no card; the CPU is
    ``device="cpu"``).  ``close()`` stops it."""

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            batch = {k: v.to(self.device)
                     for k, v in synth_batch(self.cfg, s).items()}
            try:
                self._q.put((s, batch), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
