"""The port stands alone: every ``repro_torch`` module imports with ``jax``
and ``repro`` made unimportable, and neither lands in ``sys.modules``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names), " ".join(names))
'''


def test_every_port_module_imports_without_jax_or_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    count, names = proc.stdout.split(" ", 1)
    names = names.split()
    for mod in ("repro_torch.configs.qwen3_1_7b",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.models.transformer",
                "repro_torch.serving.serve", "repro_torch.launch.serve",
                "repro_torch.kernels.prox.ops", "repro_torch.quickstart",
                "repro_torch.core.compression", "repro_torch.analysis.comm",
                "repro_torch.launch.steps", "repro_torch.launch.train",
                "repro_torch.training.train_loop",
                "repro_torch.training.checkpoint",
                "repro_torch.training.backends", "repro_torch.obs.trace",
                "repro_torch.core.fedopt", "repro_torch.core.fedopt.baselines",
                "repro_torch.core.extensions", "repro_torch.training.sweep",
                "repro_torch.obs.metrics", "repro_torch.obs.record",
                "repro_torch.obs.sinks", "repro_torch.figures",
                "repro_torch.models.mamba2", "repro_torch.models.ssm",
                "repro_torch.models.hybrid", "repro_torch.configs.zamba2_2_7b",
                "repro_torch.configs.grok_1_314b",
                "repro_torch.serve_drift", "repro_torch.models.encdec",
                "repro_torch.launch.mesh", "repro_torch.analysis.roofline",
                "repro_torch.configs.seamless_m4t_medium",
                "repro_torch.launch.specs", "repro_torch.launch.sharding",
                "repro_torch.launch.dryrun", "repro_torch.launch.gossip_dist",
                "repro_torch.analysis.hlo", "repro_torch.core.gossip",
                "repro_torch.core.schedule", "repro_torch.core.mixing"):
        assert mod in names
    assert int(count) == len(names) >= 30
