"""On the card: a reduced bf16 training cell through the whole run (first
steps, window, traced rounds, reference, comparison) comes out correct,
the trace attributes device time to the program's spans, and the readers
find the kernels they read by name.  Skips
without a card; on one:

    PYTHONPATH=src python -m pytest -q -m gpu perfbench/tests/test_bench_card.py
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import run
from perfbench.kinds import train
from perfbench.metrics.attention_roofline_pct import flash_seconds
from perfbench.metrics.sweep_pair_roofline_pct import sweep_seconds
from perfbench.tests import reduced

CELLS = json.loads((reduced.HERE.parent / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_reduced_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = run.load_cell(cell)
    cfg = reduced.config(c["cell"]["config"], "bfloat16", card=True)
    tr = reduced.traffic(c["cell"]["traffic"], seq_len=64)
    out = train.run(cfg, tr, c["limits"], 31, 1.0, True, "cuda", time.perf_counter())
    assert out["correct"], out["numbers"]
    t = out["trace"]
    assert 0 < t["busy_s"] <= t["wall_s"]
    assert sweep_seconds(t) > 0 and flash_seconds(t) > 0
    assert t["device_s"].get("gossip", 0) > 0 and t["device_s"]["model"] > 0
    got = run.read_metrics(c["per_layer"], run.context(cfg, tr, out))
    assert set(got) == {m["name"] for m in c["per_layer"]}
    assert got["sweep_pair_roofline_pct"]["value"] <= 105
    assert 0 < got["attention_roofline_pct"]["value"] <= 105
