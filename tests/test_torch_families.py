"""The port's MoE, Mamba, encoder-decoder and VLM modules against the JAX
reference, on the CPU, at f32.

Weights come from the reference's own initialisers (``jax.random.key``)
turned to numpy and carried over by ``repro_torch.bridge``; inputs are made
with numpy from a seed.  Single modules agree within ``TOL_MODULE`` (2e-5:
f32 sums taken in another order), the MoE's aux losses within 1e-6, whole
models within ``TOL_LOGITS`` (1e-4).  The Mamba scan steps through each
chunk sequentially where the reference runs an associative scan: the same
recurrence in f32, within ``TOL_MODULE`` over two chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.configs import all_archs as j_all_archs
from repro.configs import smoke as j_smoke
from repro.models import encdec as jencdec
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs import all_archs, smoke
from repro_torch.models import common as tcommon
from repro_torch.models import encdec, mamba, moe, registry

TOL_LOGITS = 1e-4
TOL_MODULE = 2e-5
TOL_AUX = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return tcommon.tree_map(torch.tensor, _np_tree(tree))


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _configs(name, **change):
    """The reference's and the port's f32 smoke config of ``name``."""
    j = dataclasses.replace(j_smoke(j_all_archs()[name]), dtype="float32",
                            **change)
    t = dataclasses.replace(smoke(all_archs()[name]), dtype="float32",
                            **change)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _reference_slots(jcfg, jp, x):
    """The reference's top-k expert ids and slots, by its own lines
    (``repro/models/moe.py`` computes them inside ``moe_apply``)."""
    B, S, D = x.shape
    E, K = jcfg.num_experts, jcfg.experts_per_token
    N = B * S
    Ng = jmoe._group_size(N)
    xg = jnp.asarray(x).reshape(N // Ng, Ng, D)
    probs = jax.nn.softmax(xg @ jp["router"]["kernel"].astype(jnp.float32),
                           axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    emask = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = emask.reshape(N // Ng, Ng * K, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(emask.shape)
    return np.asarray(idx), np.asarray(jnp.sum(pos * emask, -1))


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_matches_the_reference(cf):
    """moonshot's smoke MoE (4 experts top-2, one shared expert) over 96
    tokens (three groups of 32): the same slots, the same drops at
    capacity factor 1.25 and none at 8, outputs within TOL_MODULE, aux
    losses within 1e-6."""
    jcfg, cfg = _configs("moonshot-v1-16b-a3b", capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.key(1), jcfg)
    p = _t_tree(jp)
    x = np.random.default_rng(1).standard_normal((2, 48, 64)).astype(
        np.float32)
    want_y, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    got_y, got_aux = moe.moe_apply(cfg, p, torch.tensor(x))
    assert _err(got_y, want_y) < TOL_MODULE
    for k in ("lb_loss", "z_loss"):
        assert abs(float(got_aux[k]) - float(want_aux[k])) < TOL_AUX, k
    r = moe.routing(cfg, p, torch.tensor(x))
    idx, slot = _reference_slots(jcfg, jp, x)
    assert (r["G"], r["Ng"]) == (3, 32)
    assert (r["idx"].numpy() == idx).all()
    assert (r["slot"].numpy() == slot).all()
    dropped = int((slot >= r["C"]).sum())
    assert (dropped > 0) == (cf == 1.25), (cf, r["C"], dropped)


def test_moe_capacity_at_a_decode_step():
    """moonshot at full width over 8 decode slots: groups of 8 tokens and
    one slot an expert (C = max(1, int(8 * 6 / 64 * 1.25)) = 1), so
    assignments drop, as in the reference."""
    cfg = all_archs()["moonshot-v1-16b-a3b"]
    assert moe._group_size(8) == jmoe._group_size(8) == 8
    assert max(1, int(8 * cfg.experts_per_token / cfg.num_experts
                      * cfg.capacity_factor)) == 1
    assert [moe._group_size(n) for n in (1000, 1024, 4096, 96)] == \
        [jmoe._group_size(n) for n in (1000, 1024, 4096, 96)] == \
        [8, 1024, 1024, 32]


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    jcfg, cfg = _configs("jamba-1.5-large-398b")
    jp = jmamba.mamba_init(jax.random.key(2), jcfg)
    return jcfg, cfg, jp, _t_tree(jp)


def test_mamba_apply_crosses_the_chunk(mamba_setup):
    """T = 512: two chunks of 256, the state carried across the boundary;
    the output and the final conv and SSM states within TOL_MODULE."""
    jcfg, cfg, jp, p = mamba_setup
    x = np.random.default_rng(3).standard_normal((2, 512, 64)).astype(
        np.float32)
    want, want_st = jmamba.mamba_apply(jcfg, jp, jnp.asarray(x),
                                       return_state=True)
    got, st = mamba.mamba_apply(cfg, p, torch.tensor(x), return_state=True)
    assert got.shape == (2, 512, 64)
    assert _err(got, want) < TOL_MODULE
    assert _err(st["conv"], want_st["conv"]) < TOL_MODULE
    assert _err(st["ssm"], want_st["ssm"]) < TOL_MODULE


def test_mamba_refuses_a_ragged_chunk(mamba_setup):
    """A sequence past one chunk must be a whole number of chunks: the
    reference asserts it, the port raises (T = 300)."""
    jcfg, cfg, jp, p = mamba_setup
    x = np.zeros((1, 300, 64), np.float32)
    with pytest.raises(AssertionError):
        jmamba.mamba_apply(jcfg, jp, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of the scan's chunk"):
        mamba.mamba_apply(cfg, p, torch.tensor(x))


def test_mamba_decode_steps_through_the_sequence(mamba_setup):
    """mamba_decode from an empty state over 24 tokens: each step's output
    and state against the reference's step and against the full-sequence
    apply."""
    jcfg, cfg, jp, p = mamba_setup
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    full, full_st = mamba.mamba_apply(cfg, p, torch.tensor(x),
                                      return_state=True)
    jst = jmamba.init_state(jcfg, 2)
    st = mamba.init_state(cfg, 2, "cpu")
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: v.shape for k, v in jst.items()}
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jy, jst = jmamba.mamba_decode(jcfg, jp, jnp.asarray(xt), jst)
        y, st = mamba.mamba_decode(cfg, p, torch.tensor(xt), st)
        assert _err(y, jy) < TOL_MODULE, t
        assert _err(y, full[:, t:t + 1]) < TOL_MODULE, t
    assert _err(st["ssm"], jst["ssm"]) < TOL_MODULE
    assert _err(st["conv"], jst["conv"]) < TOL_MODULE
    assert _err(st["ssm"], full_st["ssm"]) < TOL_MODULE
    assert _err(st["conv"], full_st["conv"]) < TOL_MODULE


# ---------------------------------------------------------------------------
# encoder-decoder (Whisper) and VLM (InternVL2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = _configs("whisper-base")
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((2, 40, 64)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, cfg, jparams, params, frames, tokens


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_encode_is_non_causal_attention(ref_impl, whisper):
    """The encoder (the flash kernel's plain version, non-causal, on the
    CPU) against the reference's chunked branch and its Pallas kernel in
    interpret mode."""
    jcfg, cfg, jparams, params, frames, _ = whisper
    with jruntime.use_policy(attention_impl=ref_impl, pallas_interpret=True):
        want = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    got = encdec.encode(cfg, params, torch.tensor(frames))
    assert got.shape == (2, 40, 64)
    assert _err(got, want) < TOL_MODULE


def test_encdec_prefill_stores_the_cross_kv(whisper):
    jcfg, cfg, jparams, params, frames, tokens = whisper
    batch = {"tokens": tokens, "frames": frames}
    want, jc = jregistry.prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len=16)
    got, c = registry.prefill(
        cfg, params, {k: torch.tensor(v) for k, v in batch.items()},
        cache_len=16)
    assert got.shape == (2, 1, cfg.vocab_size)
    assert _err(got, want) < TOL_LOGITS
    assert c["xk"].shape == (cfg.num_layers, 2, 40, cfg.num_kv_heads, cfg.hd)
    for key in ("xk", "xv"):
        assert _err(c[key], jc[key]) < TOL_MODULE, key
    for key in ("k", "v"):
        assert c["self"][key].shape == (cfg.num_layers, 2, 16, 4, 16)
        assert _err(c["self"][key], jc["self"][key]) < TOL_MODULE, key
    assert (c["self"]["pos"][:, 0].numpy() == np.asarray(jc["self"]["pos"])
            ).all()
    # bf16 frames into the f32 model: the reference's type promotion
    bf = {"tokens": torch.tensor(tokens),
          "frames": torch.tensor(frames).to(torch.bfloat16)}
    again, _ = registry.prefill(cfg, params, bf, cache_len=16)
    jbf = {"tokens": jnp.asarray(tokens),
           "frames": jnp.asarray(frames).astype(jnp.bfloat16)}
    want_bf, _ = jregistry.prefill(jcfg, jparams, jbf, cache_len=16)
    assert _err(again, want_bf) < TOL_LOGITS


def test_vlm_forward_with_patches():
    """InternVL2's smoke config: 4 patches projected and prepended; logits
    over patches and text, against the reference's."""
    jcfg, cfg = _configs("internvl2-26b")
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = bridge.params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20)).astype(
                 np.int32),
             "patches": rng.standard_normal((2, 4, 64)).astype(np.float32)}
    want, _ = jregistry.forward(jcfg, jparams,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = registry.forward(cfg, params,
                                {k: torch.tensor(v) for k, v in batch.items()})
    assert got.shape == (2, 24, cfg.vocab_size)
    assert _err(got, want) < TOL_LOGITS
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
