"""Static batched serving engine: one batch, run to completion.

Counterpart of ``repro/serve/engine.py``, the *reference* serving path: a
whole batch is left-padded to a common prompt length, prefilled together
(one batched prefill: the flash-attention kernel at ``B = batch_size``),
and decoded in lockstep at one scalar position until every request
finishes.  Greedy sampling (argmax) keeps tests deterministic.  The
production path is ``serve.continuous.ContinuousEngine``; this engine
stays as the regression baseline it is token-identical to on
equal-length prompts, and as the static arm of the
``serve.continuous_vs_static`` experiment.  With a ``mesh``
(``launch/mesh.py``) its two steps run the dense family over the mesh's
``model`` axis (``serve/step.py``); the serve CLI still refuses
``--static`` with ``--tp-size > 1``, as the reference's does.

Pad tokens are attended, as in the reference: a left-padded prompt's
stream is the reference's, not the one it would get alone.  The caches
are written in place where the reference donates them.  ``device="cuda"``
by default (it raises where there is no card); tests pass
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime import resolve_device
from repro_torch.serve import step as sstep


@dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    generated: list = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ArchConfig, mesh, batch_size: int,
                 cache_len: int, params, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.batch = batch_size
        self.cache_len = cache_len
        self._decode = sstep.make_decode_step(cfg, mesh)
        self._prefill = sstep.make_prefill_step(cfg, mesh,
                                                cache_len=cache_len)
        self.device = resolve_device(device)
        self.params = sstep.put_params(cfg, mesh, params, self.device)

    def generate(self, requests: list[Request]) -> list[Request]:
        """Run a full batch of requests to completion (greedy)."""
        if not requests:        # nothing to do — and nothing to pad from
            return []
        if len(requests) > self.batch:
            raise ValueError(
                f"batch of {len(requests)} requests exceeds engine "
                f"batch_size={self.batch}; split the request list or "
                f"build the Engine with a larger batch_size")
        reqs = list(requests)
        while len(reqs) < self.batch:  # pad batch with dummies
            reqs.append(Request(prompt=reqs[0].prompt, max_new_tokens=0))
        plen = max(len(r.prompt) for r in reqs)
        prompts = np.stack([np.pad(r.prompt, (plen - len(r.prompt), 0))
                            for r in reqs]).astype(np.int32)  # left-pad
        logits, caches = self._prefill(
            self.params, {"tokens": torch.tensor(prompts,
                                                 device=self.device)})
        tok = torch.argmax(logits[:, -1], dim=-1)
        index = plen
        max_new = max(r.max_new_tokens for r in reqs)
        for i in range(max_new):
            host = tok.cpu().numpy()            # the step's one host sync
            for b, r in enumerate(reqs):
                if not r.done and len(r.generated) < r.max_new_tokens:
                    r.generated.append(int(host[b]))
                    if len(r.generated) >= r.max_new_tokens:
                        r.done = True
            if all(r.done or r.max_new_tokens == 0 for r in reqs):
                break
            logits, caches = self._decode(
                self.params, caches,
                {"tokens": tok[:, None].to(torch.int32), "index": index})
            tok = torch.argmax(logits[:, -1], dim=-1)
            index += 1
        return requests
