"""A run of each cell with the program broken underneath comes out not
correct, and a sound run correct; and the control (the reference with
fp8 products in the program's place) fails the cell's limits.  CPU, at
reduced sizes, float32: the harness's look for a chip is skipped and the
rest of a run is driven (first steps, a short window, the reference, the
comparison against the cell's limits)."""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import check, run
from perfbench.faults import FAULTS
from perfbench.feed import TokenFeed
from perfbench.kinds import train
from perfbench.reference import depositum as reference
from perfbench.tests import reduced
from perfbench.weights import make_weights

CELLS = json.loads((reduced.HERE.parent / "BENCHMARK.json").read_text())["workloads"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(name):
    c = run.load_cell(name)
    return (reduced.config(c["cell"]["config"]),
            reduced.traffic(c["cell"]["traffic"], seq_len=32), c["limits"])


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_fault_comes_out_not_correct(cell, fault):
    cfg, tr, limits = _cell(cell)
    out = train.run(cfg, tr, limits, 21, 0.0, False, "cpu", time.perf_counter(),
                    program_hook=FAULTS.get(fault))
    assert out["correct"] is (fault is None), out["numbers"]


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_control_fails_the_limits(cell):
    cfg, tr, limits = _cell(cell)
    fam = reference.family(cfg["family"])
    feed = TokenFeed(tr, cfg["model"]["vocab_size"], 4)
    batches = lambda t: torch.from_numpy(feed.step_tokens(t))
    x0 = make_weights(fam.leaf_specs(cfg["model"]), 4, "cpu", "bfloat16")
    ref = reference.follow(cfg, tr, x0, batches)
    ctl = reference.follow(cfg, tr, x0, batches, precision="fp8")
    numbers = check.compare(ctl, ref)
    assert not check.verdict(numbers, limits), numbers
