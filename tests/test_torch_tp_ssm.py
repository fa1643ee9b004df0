"""Tensor-parallel serving of the ssm family (RWKV-6) and the hybrid one
(Jamba: Mamba layers, MoE layers, and, in ``jamba-with-attention``, one
attention layer in each group of 4) against the reference's
single-device functions and engine, on the CPU, at f32
(``tests/test_torch_tp_moe.py``'s helpers and tolerances):

* each layer's mixer over the ranks (RWKV-6's time mix at each rank's
  heads with its ``o`` summed, the channel mix's ``sigmoid(r) * kv``
  gathered, Mamba's two halves around the summed ``x_proj``) within 2e-5
  of the reference's module;
* ``forward``, ``prefill`` and 3 decode steps at emulated tp 2 and 4
  within 2e-5 of the port's at one device — the split's own error — and
  within the families' whole-model tolerance of the reference's, 1e-4
  (``TOL_LOGITS``: the one-device port's RWKV-6 smoke logits already
  differ from the reference's by 3.4e-5, its Jamba's by up to 2.4e-5,
  sums and scans taken in another order);
* each rank's decode state at its share: RWKV-6's ``wkv`` at ``H / n``
  heads, Mamba's conv ring and SSM state at ``d_inner / n`` channels;
* the Mamba ``in_proj`` split takes each rank's channels of both halves
  ``[x | z]``; the same model under a contiguous split of the fused leaf
  (rank 0 of 2 all of ``x``, none of ``z``) is off by far more than the
  tolerance;
* the decode tick's exchanges equal to ``registry.decode_exchanges``:
  RWKV-6 ``2 L + 1`` all-reduces and ``L + 1`` all-gathers, Jamba 3 all-reduces
  a Mamba layer and 2 an attention layer, plus the embedding's;
* the dense engine's burst streams and admission logs equal to the
  reference's single-device engine at tp 1/2/4, and RWKV-6's burst over 4
  gloo rank processes;
* training over a model axis admits every family, with sequence
  parallelism too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_tp_moe as tp
from repro_torch.configs import all_archs, smoke
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import mamba, registry, transformer
from repro_torch.parallel import sharding
from repro_torch.train import step as tstep

SSM = ("rwkv6-7b", "jamba-1.5-large-398b", "jamba-with-attention")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_and_hybrid_functions_at_tp_match_the_reference(arch, n):
    out = tp.hold_functions(arch, n, tol_ref=tp.TOL_LOGITS)
    _, cfg, _, _ = tp.model(arch)
    c = out["caches"]["l0"]
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        assert c["tm"]["wkv"].shape[:4] == (n, cfg.num_groups(), 2, H // n)
        L = cfg.num_layers
        assert out["ticks"][0] == {"all-reduce": 2 * L + 1,
                                   "all-gather": L + 1}
    else:
        d_inner = mamba._dims(cfg)[0]
        assert c["ssm"].shape[:4] == (n, cfg.num_groups(), 2, d_inner // n)
        assert c["conv"].shape[-1] == d_inner // n
        G = cfg.num_groups()
        attn = sum(cfg.is_attn_layer(i) for i in range(cfg.layer_group))
        mam = cfg.layer_group - attn
        assert out["ticks"][0] == {"all-reduce": G * (3 * mam + 2 * attn) + 1,
                                   "all-gather": 1}


@pytest.mark.parametrize("n", [2, 4])
def test_each_mixer_over_ranks_is_the_reference_module(n):
    """One layer's mixers over an emulated axis of ``n`` against the
    reference's modules on the whole layer, within 2e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import mamba as jmamba
    from repro.models import rwkv6 as jrwkv6
    from repro_torch.models import common, rwkv6
    from repro_torch.parallel.model_axis import ModelAxis
    axis = ModelAxis(n)
    heads = {"q": 4, "kv": 4, "rwkv": 4}
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(
        np.float32)
    xs = torch.tensor(x).expand((n, 2, 16, 64))

    def ranked(name, jp):
        tree = common.tree_map(torch.tensor,
                               jax.tree_util.tree_map(np.asarray, jp))
        sh = sharding.shard_params({"layers": {"l0": {name: tree}}}, n,
                                   range(n), heads)
        return [common.tree_index(sh["layers"]["l0"][name], j)
                for j in range(n)]

    jcfg, cfg, _, _ = tp.model("rwkv6-7b")
    jp = jrwkv6.time_mix_init(jax.random.key(1), jcfg)
    want, _ = jrwkv6.time_mix_apply(jcfg, jp, jnp.asarray(x))
    got = sum(rwkv6.time_mix_apply(cfg, rwkv6.local_time_mix(p, r, n),
                                   xs[r])[0]
              for r, p in enumerate(ranked("rwkv", jp)))
    assert tp.err(got, want) <= tp.TOL_F32
    jp = jrwkv6.channel_mix_init(jax.random.key(2), jcfg)
    want, _ = jrwkv6.channel_mix_apply(jcfg, jp, jnp.asarray(x))
    outs = [rwkv6.channel_mix_parts(cfg, p, xs[r])
            for r, p in enumerate(ranked("cmlp", jp))]
    kv = sum(o[0] for o in outs)
    Dl = 64 // n
    got = axis.gather(torch.stack([
        torch.sigmoid(o[1]) * kv[..., r * Dl:(r + 1) * Dl]
        for r, o in enumerate(outs)]))
    assert tp.err(got, want) <= tp.TOL_F32
    jcfg, cfg, _, _ = tp.model("jamba-1.5-large-398b")
    jp = jmamba.mamba_init(jax.random.key(3), jcfg)
    want = jmamba.mamba_apply(jcfg, jp, jnp.asarray(x))
    ranks_p = ranked("mamba", jp)
    fronts = [mamba.front(cfg, p, xs[r]) for r, p in enumerate(ranks_p)]
    proj = sum(f[3] for f in fronts)
    got = sum(mamba.back(cfg, p, f[0], f[1], proj)[0]
              for p, f in zip(ranks_p, fronts))
    assert tp.err(got, want) <= tp.TOL_F32


def test_the_mamba_split_takes_both_halves(monkeypatch):
    """Each rank holds its channels of ``x`` and of the gate ``z``; a
    contiguous split of the fused ``in_proj`` gives a wrong model."""
    jcfg, cfg, jparams, tree = tp.model("jamba-1.5-large-398b")
    sh = tp.shards(cfg, tree, 2)
    leaf = sh["layers"]["l0"]["mamba"]["in_proj"]["kernel"]   # (2, G, D, .)
    full = torch.tensor(tree["layers"]["l0"]["mamba"]["in_proj"]["kernel"])
    di = mamba._dims(cfg)[0]
    for r in range(2):
        want = torch.cat([full[..., r * di // 2:(r + 1) * di // 2],
                          full[..., di + r * di // 2:di + (r + 1) * di // 2]],
                         dim=-1)
        assert torch.equal(leaf[r], want)
    # the functions at tp 2 match under this split (the test above); under
    # a contiguous one they do not
    monkeypatch.setattr(sharding, "FUSED", {})
    with pytest.raises(AssertionError):
        tp.hold_functions("jamba-1.5-large-398b", 2, tol_ref=tp.TOL_LOGITS)


def test_rwkv_heads_split_whole():
    """RWKV-6's time-mix leaves split by whole heads: where the axis does
    not divide the heads the family is refused over it."""
    cfg = dataclasses.replace(smoke(all_archs()["rwkv6-7b"]), d_model=48,
                              rwkv_head_dim=16)
    with pytest.raises(ValueError, match="RWKV-6 heads 3"):
        transformer.check_tp(cfg, 2)
    heads = sharding.head_counts(cfg)
    assert sharding.spec_for_param("layers/l0/rwkv/r/kernel", (1, 48, 48),
                                   3, heads) == 2
    assert sharding.spec_for_param("layers/l0/rwkv/time_first", (1, 48), 2,
                                   heads) is None


@pytest.mark.parametrize("arch", SSM[:2])
def test_ssm_and_hybrid_engines_serve_the_reference_streams(arch):
    tp.hold_engines(arch, False)


def test_ssm_rank_processes_serve_the_reference_streams():
    tp.hold_ranked_burst("rwkv6-7b", False)


def test_training_over_a_model_axis_names_item_9e():
    """Serving admits every family over a model axis, and so does training
    (``transformer.check_tp_train``: the hybrid, encdec and vlm families
    since item 9f), with sequence parallelism too: one step of Jamba on
    a (1, 2) mesh with it gives the step's loss without it."""
    for arch in ("rwkv6-7b", "jamba-1.5-large-398b", "moonshot-v1-16b-a3b",
                 "whisper-base", "internvl2-26b"):
        cfg = smoke(all_archs()[arch])
        transformer.check_tp(cfg, 2)
        transformer.check_tp_train(cfg, 2)
        transformer.check_tp_train(cfg, 2, sequence_parallel=True)
    cfg = dataclasses.replace(smoke(all_archs()["jamba-1.5-large-398b"]),
                              dtype="float32")
    batch = pipeline.synth_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2), 0)
    losses = []
    for sp in (False, True):
        opts = tstep.TrainOptions(sequence_parallel=sp)
        gen = torch.Generator()
        gen.manual_seed(0)
        state = tstep.make_train_state(cfg, opts, gen, make_host_mesh(1, 2))
        _, m = tstep.make_train_step(cfg, None, make_host_mesh(1, 2),
                                     opts)(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and abs(losses[1] - losses[0]) < 1e-5
    assert registry.decode_exchanges(cfg, 1) == {}
