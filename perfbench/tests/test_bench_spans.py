"""The readers of the program's own spans and counters: on a reduced
traced run on the CPU each gives a finite value from the program's store,
and nothing without a trace or from a program without a store (a traced
run lays these readers over the parent's checkout too)."""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

import pytest
import torch

from perfbench import run, spans
from perfbench.kinds import train
from perfbench.tests import reduced

ROOT = Path(__file__).resolve().parents[2]
READERS = ("model_host_ms_per_client_step", "cast_gb_per_client_step")


def _specs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["per_layer"]}
    return [by_name[n] for n in READERS]


@pytest.fixture(scope="module")
def traced():
    """A reduced bf16 T0 1 cell's first steps, an empty window and its
    traced rounds on the CPU, read as the result line reads them."""
    from repro_torch.obs import trace
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = reduced.config("qwen3-1.7b", "bfloat16")
        tr = reduced.traffic("train-l2048-t1", 16)
        out = train.run(cfg, tr, {}, 2147483999, 0.0, True, "cpu",
                        time.perf_counter())
        ctx = run.context(cfg, tr, out)
        yield ctx, run.read_metrics(_specs(), ctx), trace.STORE.summary()
    finally:
        torch.set_num_threads(n)


def test_every_span_reader_reads_the_store(traced):
    ctx, got, rows = traced
    assert set(got) == set(READERS)
    assert all(math.isfinite(v["value"]) and v["value"] >= 0
               for v in got.values())
    # the store holds the traced rounds alone: every span of the model
    # step, one model step a client-step
    assert {"round", "model_step", "block", "attention", "mlp", "loss_head",
            "ce"} <= set(rows)
    assert rows["model_step"]["count"] == ctx["trace"]["client_steps"]
    assert got["model_host_ms_per_client_step"]["value"] > 0
    assert got["cast_gb_per_client_step"]["value"] > 0


def test_span_readers_read_nothing_without_a_trace(traced):
    ctx, _, _ = traced
    assert run.read_metrics(_specs(), {**ctx, "trace": None}) == {}


def test_span_readers_read_nothing_from_a_program_without_a_store(
        traced, monkeypatch):
    ctx, _, _ = traced
    monkeypatch.setattr(spans, "_store", lambda: None)
    assert run.read_metrics(_specs(), ctx) == {}
