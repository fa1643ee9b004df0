"""The fabric burn: a device-side spin that holds back its stream.

Wrapper of ``csrc/fabric_burn.cu`` and its plain version.  The burn is the
enforcement tool of degraded-fabric injection (``fabric/inject.py``), the
counterpart of the reference's ``_burn`` (an XLA ``while_loop``, not a TPU
kernel): ``iters`` trips of ``v = v * f32(1.000000119) + f32(1e-9)`` from
``v = 1``, each rounded in f32, written to a one-float scratch and nowhere
else.  Whatever the caller queues behind it on the stream waits for it.

* :func:`burn` — on a CUDA device, launches the kernel on the current
  stream (no synchronisation) and counts the launch in ``LAUNCHES`` (and
  its trips in ``TRIPS``, which the plain version adds to as well); a
  failed build or launch raises.  On the CPU it runs :func:`burn_torch`,
  which spins the host for the same trips.
* :func:`burn_torch` — the plain version: the same loop on the host, in
  numpy f32 scalars (the same roundings; the kernel's result is held to it
  bit for bit on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = 0        # kernel launches made by burn
TRIPS = 0           # trips burned by burn, on any device (kernel or plain)

_MUL = np.float32(1.000000119)
_ADD = np.float32(1e-9)


def burn_torch(iters: int) -> torch.Tensor:
    """Plain version: ``iters`` trips on the host; ``v`` as a (1,) f32."""
    v = np.float32(1.0)
    for _ in range(int(iters)):
        v = v * _MUL + _ADD
    return torch.tensor([v], dtype=torch.float32)


def burn(iters: int, device) -> torch.Tensor:
    """Spin ``iters`` trips on ``device`` (its current stream) and return
    the (1,) f32 scratch that receives ``v``.  ``iters < 0`` raises;
    ``0`` launches nothing."""
    global LAUNCHES, TRIPS
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"a burn takes iters >= 0, got {iters}")
    device = torch.device(device)
    TRIPS += iters
    if device.type != "cuda":
        return burn_torch(iters)
    sink = torch.ones((1,), dtype=torch.float32, device=device)
    if iters == 0:
        return sink
    with torch.cuda.device(device):
        code = _build.lib().fabric_burn(
            sink.data_ptr(), iters, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "fabric_burn")
    LAUNCHES += 1
    return sink
