"""The harness and its reference load neither JAX nor the JAX package, by
whole top-level module names (the program's ``repro_torch`` begins with
``repro``), and nothing in it reads the JAX package's benchmarks."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]

# a training cell's first steps, window, traced rounds and reference at a
# reduced size on the CPU, then every module of the harness
PROBE = r"""
import importlib, json, pkgutil, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.set_num_threads(2)
import perfbench
from perfbench.kinds import train
from perfbench.tests import reduced
cfg, tr = reduced.config("qwen3-1.7b"), reduced.traffic("train-l2048-t1", 16)
train.run(cfg, tr, {{}}, 5, 0.0, True, "cpu", time.perf_counter())
for m in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    if ".tests" not in m.name and not m.name.endswith(("calibrate",)):
        importlib.import_module(m.name)
from perfbench.run import forbidden_modules
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
print(json.dumps(forbidden_modules()))
"""


def test_harness_and_reference_hold_no_jax():
    p = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top, held = (__import__("json").loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert "repro_torch" in top and "perfbench" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "repro"}
    assert held == []


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


def test_nothing_reads_the_jax_benchmarks():
    for f in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in f.relative_to(ROOT).parts:
            continue
        text = f.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, f
        assert "import jax" not in text and "from repro " not in text, f
        assert "from repro." not in text and "import repro\n" not in text, f
