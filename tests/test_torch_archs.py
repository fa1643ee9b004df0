"""All ten archs of the port at smoke size against the JAX reference, on
the CPU.

Per arch (the config copies and the parameter trees' shapes are
``tests/test_torch_models.py``'s): the forward's logits and aux losses
(f32) agree within ``TOL_LOGITS`` (1e-4: f32 sums in another order over a
few layers); a prefill and 4 decode steps agree with the reference's
within ``TOL_LOGITS`` and with the port's own teacher-forced forward
within the reference's 0.15 (``tests/test_serving.py``; the MoE configs at
capacity factor 8, so that no assignment drops and decode equals the
forward); one train step of the smoke config gives a finite positive loss
(``tests/test_models_smoke.py``).  The reference's smoke Jamba has no
attention layer (groups of 2 under an attention period of 4), so a Jamba
config with groups of 4 — Mamba, MoE and attention inside one group — is
held as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.data import pipeline
from repro_torch.models import registry
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

TOL_LOGITS = 1e-4
TOL_DECODE_VS_FORWARD = 0.15
ARCHS = sorted(j_all_archs())
JAMBA_ATTN = dict(layer_group=4, attn_period=4, num_layers=8)
CASES = ARCHS + ["jamba-with-attention"]


def _configs(name, **change):
    """The reference's and the port's f32 smoke config of ``name``."""
    if name == "jamba-with-attention":
        name, change = "jamba-1.5-large-398b", dict(change, **JAMBA_ATTN)
    j = dataclasses.replace(j_smoke(j_all_archs()[name]), dtype="float32",
                            **change)
    t = dataclasses.replace(smoke(all_archs()[name]), dtype="float32",
                            **change)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _model(name, **change):
    jcfg, cfg = _configs(name, **change)
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B=2, S=32, seed=0):
    """numpy inputs: ``S`` positions in all (a VLM's patches included)."""
    rng = np.random.default_rng(seed)
    St = S - cfg.num_patches if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, St)).astype(
        np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _err(got, want) -> float:
    return float(np.max(np.abs(got.detach().float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("name", CASES)
def test_forward_logits_and_aux(name):
    jcfg, cfg, jparams, params = _model(name)
    batch = _batch(cfg)
    want, jaux = jregistry.forward(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = registry.forward(
        cfg, params, {k: torch.tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got, want) < TOL_LOGITS
    for k in ("lb_loss", "z_loss"):
        assert abs(float(aux[k]) - float(jaux[k])) < TOL_LOGITS, k
    assert (float(aux["lb_loss"]) > 0) == bool(cfg.num_experts)


@pytest.mark.parametrize("name", CASES)
def test_prefill_and_decode(name):
    """Prefill the first 28 positions with a cache of 32, then decode the
    last 4 tokens: each step's logits against the reference's step and
    against the port's own forward at that position."""
    jcfg, cfg, jparams, params = _model(name, capacity_factor=8.0)
    batch = _batch(cfg, seed=1)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    full, _ = registry.forward(cfg, params, tb)
    toks, K, S = batch["tokens"], 4, 32
    St = toks.shape[1]
    pb = dict(batch, tokens=toks[:, :St - K])
    jl, jc = jregistry.prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in pb.items()},
        cache_len=S)
    tl, tc = registry.prefill(
        cfg, params, {k: torch.tensor(v) for k, v in pb.items()},
        cache_len=S)
    off = cfg.num_patches if cfg.family == "vlm" else 0
    pos0 = off + St - K - 1
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert _err(tl, jl) < TOL_LOGITS
    errs = [float((tl[:, -1] - full[:, pos0]).abs().max())]
    for i in range(K):
        idx = pos0 + 1 + i
        step_toks = toks[:, St - K + i:St - K + i + 1]
        jl, jc = jregistry.decode_step(
            jcfg, jparams, {"tokens": jnp.asarray(step_toks),
                            "index": jnp.int32(idx)}, jc)
        tl, tc = registry.decode_step(
            cfg, params, {"tokens": torch.tensor(step_toks),
                          "index": idx}, tc)
        assert _err(tl, jl) < TOL_LOGITS, i
        errs.append(float((tl[:, 0] - full[:, idx]).abs().max()))
    assert max(errs) < TOL_DECODE_VS_FORWARD, errs


@pytest.mark.parametrize("name", CASES)
def test_one_train_step(name):
    """The smoke config as published (bf16): one stock step on the CPU
    from the port's own initialisation, a finite positive loss."""
    if name == "jamba-with-attention":
        cfg = dataclasses.replace(smoke(all_archs()["jamba-1.5-large-398b"]),
                                  **JAMBA_ATTN)
    else:
        cfg = smoke(all_archs()[name])
    opts = tstep.TrainOptions(remat=False, opt=topt.OptConfig(
        lr=1e-3, warmup_steps=1, decay_steps=10))
    gen = torch.Generator()
    gen.manual_seed(0)
    state = tstep.make_train_state(cfg, opts, gen)
    dcfg = pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
        frames_dim=cfg.d_model if cfg.family == "encdec" else 0,
        patches=cfg.num_patches, d_model=cfg.d_model)
    step = tstep.make_train_step(cfg, None, 1, opts)
    state, m = step(state, pipeline.synth_batch(dcfg, 0))
    loss = float(m["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(state["step"]) == 1
    assert np.isfinite(float(m["lb_loss"])) and np.isfinite(float(m["z_loss"]))
