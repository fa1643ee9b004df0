"""Runtime policy: which implementation backs each hot-spot op.

Counterpart of ``repro/runtime.py`` for the port.  The ``*_impl`` knobs
name *which function is called*, never a choice made silently by device:

* ``"kernel"`` (default) calls the kernel wrapper.  On a CUDA tensor the
  wrapper launches the hand-written CUDA kernel or raises; it takes the
  plain PyTorch version only for a tensor that lies on the CPU.
* ``"torch"`` calls the plain PyTorch version on whatever device the
  tensors are on (the comparison arm of ``chip_smoke.py`` and the tests).

Two knobs take a third value.  ``attention_impl="chunked"`` is the
reference's XLA attention branch (chunked masked softmax, differentiable:
the training path).  ``quant_impl="auto"`` (its default) is the reference's
size rule and nothing else: the int8 kernels for a payload of at least
``kernels/quant.PALLAS_QUANT_MIN_SIZE`` elements, the plain version below
it — never a choice by device or by failure.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_DEFAULT = {
    "attention_impl": "kernel",        # kernel | torch | chunked —
    #                             full-sequence attention: the flash kernel
    #                             (kernels/ops.flash_attention), its plain
    #                             version, or the reference's chunked softmax
    #                             (models/attention.py; train/step.py's loss)
    "paged_attention_impl": "kernel",  # kernel | torch — the paged-KV decode
    #                             attention, kernels/ops.paged_attention
    "rwkv_impl": "kernel",             # kernel | torch — the chunked WKV-6
    #                             scan of an RWKV prefill (T > 1),
    #                             kernels/ops.rwkv6_scan; one token always
    #                             takes models/rwkv6.wkv_step
    "quant_impl": "auto",       # auto | kernel | torch — the int8
    #                             quantize/dequantize of the compressed
    #                             gradient collectives (kernels/ops.py); auto
    #                             takes the kernels for payloads of at least
    #                             PALLAS_QUANT_MIN_SIZE elements
    "overlap_schedule": "auto",  # auto | serial | pipelined — bucket-chain
    #                             issue order for compressed gradient
    #                             collectives (parallel/overlap.py); auto
    #                             pipelines when a tree packs into more
    #                             than one bucket
    "paged_buffer_depth": 2,    # pages per step of the paged-attention walk
    #                             (gather width in the plain version; the
    #                             CUDA kernel validates and records it)
    "serve_prefill_per_step": 1,  # continuous-batching engine: max queued
    #                             requests admitted (prefilled) per engine
    #                             step, interleaved with the in-flight
    #                             decode batch (serve/continuous.py)
    "serve_headroom_min_gflops": 1.0,  # planner rule 5: serving offload is
    #                             profitable only while the probe kernel
    #                             beside the engine clears this FLOP/s
    #                             floor at every sustained load level
    #                             (core/planner.serve_offload_assessment)
    "fabric_p99_inflation_max": 3.0,  # planner rule 5, degraded-fabric arm:
    #                             tolerated p99 TTFT/TPOT inflation (x vs
    #                             the clean-fabric run) before the serve
    #                             offload verdict is withdrawn
    #                             (core/planner.fabric_sensitivity_assessment
    #                             consuming fabric.serve_tail records)
    "serve_slo_attainment_min": 0.9,  # planner rule 5, SLO arm: when
    #                             serve.slo_sweep records are present the
    #                             offload verdict additionally requires the
    #                             highest-priority class to attain its SLO
    #                             at this fraction at every sustained level
    #                             (core/planner.serve_offload_assessment)
    "serve_slo_targets": {      # per-class SLO targets (seconds) consumed by
        #                         scheduler.SLOPolicy.from_runtime — the
        #                         launch.serve --slo defaults; rank orders
        #                         admission (lower = higher priority),
        #                         shed_after_s is the queue-wait budget
        "interactive": {"rank": 0, "ttft_s": 0.5, "tpot_s": 0.25},
        "standard": {"rank": 1, "ttft_s": 2.0, "tpot_s": 0.5},
        "batch": {"rank": 2, "ttft_s": 10.0, "tpot_s": 2.0,
                  "shed_after_s": 10.0},
    },
    "obs_trace": False,         # unified span tracing (repro_torch.obs): True
    #                             makes every new ContinuousEngine build its
    #                             own Tracer instead of the null tracer
}

IMPLS = ("kernel", "torch")
CHOICES = {"attention_impl": IMPLS + ("chunked",),
           "paged_attention_impl": IMPLS, "rwkv_impl": IMPLS,
           "quant_impl": ("auto",) + IMPLS}

_local = threading.local()


def policy() -> dict:
    if not hasattr(_local, "policy"):
        _local.policy = dict(_DEFAULT)
    return _local.policy


@contextmanager
def use_policy(**kwargs):
    prev = dict(policy())
    policy().update(kwargs)
    try:
        yield policy()
    finally:
        _local.policy = prev


def impl(knob: str) -> str:
    """The validated value of an ``*_impl`` knob."""
    value = policy()[knob]
    if value not in CHOICES[knob]:
        raise ValueError(f"{knob}={value!r}; expected one of "
                         f"{CHOICES[knob]}")
    return value


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point runs on.  The default is the
    card; asking for it where there is none raises (there is no silent
    CPU fallback — callers that want the CPU pass ``device="cpu"``)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev
