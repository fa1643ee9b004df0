"""The port stands on its own: it imports ``torch`` and never ``jax`` or
anything of the JAX package — nor does a rank process it spawns —, builds
nothing at import, and keeps its copies of the host-side modules equal to
the reference's."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke                      # imported, not run
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "torch" in sys.modules
from repro_torch.parallel import dist, rank_bodies
assert dist.run_ranks(rank_bodies.loaded_reference, 2, backend="gloo",
                      device="cpu", timeout_s=240) == [[], []]
from repro_torch.configs import all_archs, smoke
from repro_torch.serve import ranks
served = dist.run_ranks(ranks.serve_rank, 2, backend="gloo", device="cpu",
                        args=(smoke(all_archs()["olmo-1b"]), ("seed", 0),
                              rank_bodies.loaded_reference, ()),
                        timeout_s=240)
assert served[0]["result"] == [], served
from repro_torch.kernels import _build
assert _build._LIB is None and _build.build_seconds is None
assert not _build.build_dir().exists(), _build.build_dir()
expected = {"repro_torch.runtime", "repro_torch.bridge",
            "repro_torch.kernels.ops", "repro_torch.kernels._build",
            "repro_torch.kernels.paged_attention",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.rwkv6_scan", "repro_torch.models.rwkv6",
            "repro_torch.configs.rwkv6_7b",
            "repro_torch.models.transformer", "repro_torch.serve.paged",
            "repro_torch.serve.step", "repro_torch.serve.continuous",
            "repro_torch.launch.serve", "repro_torch.obs.trace",
            "repro_torch.kernels.quant", "repro_torch.parallel.pods",
            "repro_torch.parallel.buckets", "repro_torch.parallel.overlap",
            "repro_torch.parallel.collectives", "repro_torch.train.optimizer",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.serve.engine",
            "repro_torch.fabric", "repro_torch.fabric.condition",
            "repro_torch.fabric.serve", "repro_torch.experiments",
            "repro_torch.experiments.record",
            "repro_torch.experiments.registry",
            "repro_torch.experiments.diff",
            "repro_torch.experiments.measure",
            "repro_torch.experiments.runner",
            "repro_torch.experiments.defs",
            "repro_torch.experiments.__main__", "repro_torch.core",
            "repro_torch.core.serving", "repro_torch.core.fabric",
            "repro_torch.core.classes", "repro_torch.core.headroom",
            "repro_torch.core.stressors", "repro_torch.core.planner",
            "repro_torch.core.inpath", "repro_torch.parallel.dist",
            "repro_torch.parallel.rank_bodies", "repro_torch.fabric.inject",
            "repro_torch.kernels.burn", "repro_torch.launch.mesh",
            "repro_torch.parallel.sharding",
            "repro_torch.parallel.model_axis", "repro_torch.serve.ranks",
            "repro_torch.parallel.mesh_tree", "repro_torch.parallel.pipeline"}
assert expected <= set(names), expected - set(names)
print("IMPORTED", len(names))
"""


def test_port_imports_no_jax_and_no_reference_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}",
               REPRO_TORCH_BUILD_DIR=str(tmp_path / "build"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert "IMPORTED" in out.stdout, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    """No ``import jax`` / ``from repro`` line anywhere in the port or in
    ``chip_smoke.py`` (the subprocess test shows it at run time; this one
    covers lazy imports inside functions), and no library attention call."""
    import re
    files = sorted((SRC / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad_import = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for path in files:
        text = path.read_text()
        assert not bad_import.search(text), path
        if path.name != "chip_smoke.py":     # its yardstick, timed only
            assert "scaled_dot_product_attention" not in text, path
            assert "torch.compile" not in text, path


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: a non-zero exit and no result line; alone in a
    directory (without the package): a non-zero exit too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    alone = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                           capture_output=True, text=True, timeout=300,
                           cwd=tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


HOST_COPIES = ["obs/__init__.py", "obs/trace.py", "obs/metrics.py",
               "obs/logbuf.py", "obs/validate.py", "serve/kv.py",
               "serve/scheduler.py", "serve/loadgen.py", "configs/base.py",
               "configs/olmo_1b.py", "configs/rwkv6_7b.py",
               "configs/h2o_danube_3_4b.py", "configs/mistral_nemo_12b.py",
               "configs/command_r_plus_104b.py",
               "configs/moonshot_v1_16b_a3b.py",
               "configs/qwen3_moe_235b_a22b.py",
               "configs/jamba_1_5_large_398b.py", "configs/internvl2_26b.py",
               "configs/whisper_base.py", "fabric/condition.py",
               "fabric/serve.py", "experiments/record.py",
               "experiments/registry.py", "experiments/diff.py",
               "core/classes.py", "core/planner.py", "analysis/report.py"]

# The lines where a copy holds the card's number in place of the
# reference's TPU number, reference line -> the copy's line; no other
# line may differ.
OWN_LINES = {"core/planner.py": {
    "              hbm_bytes: float = 16e9,":
    "              hbm_bytes: float = 80e9,  # NVIDIA H100 80GB HBM3"}}


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_side_copies_have_not_drifted(rel):
    """The port keeps its own copy of each jax-free host module; apart
    from the package name (and the lines of ``OWN_LINES``) they are the
    reference's text, so admission, SLO, trace and offload decisions
    cannot drift between the two."""
    ours = (SRC / "repro_torch" / rel).read_text()
    theirs = (SRC / "repro" / rel).read_text()
    ours = ours.replace("repro_torch", "repro").splitlines()
    theirs = theirs.splitlines()
    assert len(ours) == len(theirs)
    differ = {t: o for o, t in zip(ours, theirs) if o != t}
    assert differ == OWN_LINES.get(rel, {})
