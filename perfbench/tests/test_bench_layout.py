"""The benchmark's files: every cell finds its configuration, traffic,
limits and metric readers by name; the result line's shape; a run without
a card, or without the program, prints no result."""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
               for m in BENCH["per_layer"])
    assert (ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    c = run.load_cell(cell)
    assert c["cfg"]["name"] == c["cell"]["config"]
    assert c["traffic"]["name"] == c["cell"]["traffic"]
    steps = c["traffic"]["check"]
    numbers = {"loss", "grad1", "grad1_med"} | {
        f"dx{t}{m}" for t in steps["dx_after"] for m in ("", "_med")}
    assert c["limits"] and set(c["limits"]) <= numbers
    assert all(0 < v < math.inf for v in c["limits"].values())
    for m in c["end_to_end"] + c["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    conf = {x["name"]: x for x in BENCH["configs"]}[c["cell"]["config"]]
    assert set(conf["reduced"]) == set(c["cfg"]["reduced"])
    for k in conf["reduced"]:
        assert c["cfg"]["published"][k] != c["cfg"]["as_run"][k]


def test_every_metric_reader_reads_nothing_from_nothing():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert run.read_metrics([m], {"window": None, "trace": None,
                                      "counts": {}, "setup_s": None,
                                      "peak_bytes": None, "model": None,
                                      "traffic": None}) == {}


def _out(traced):
    trace = {"wall_s": 2.0, "busy_s": 1.5, "rounds": 1, "steps": 4,
             "client_steps": 8, "comm_steps": 1, "counts": {"kernel": 4000},
             "device_s": {"model": 1.2, "gossip": 0.1, "unlinked": 0.144},
             "by_name": {"void fused_update_kernel<__nv_bfloat16, 0, false>(Tab)": 0.05,
                         "void tracking_kernel<__nv_bfloat16, false>(Tab)": 0.04,
                         "void flash_fwd_sm90_kernel<128>(CUtensorMap)": 0.018,
                         "void flash_bwd_dq_kernel<128>(CUtensorMap)": 0.036},
             "device_ops": [["k", 0.5]], "idle_gaps": [["aten::mm", 0.1]]}
    return {"correct": True, "attempted": 10, "failed": 0,
            "numbers": {"loss": (1e-5, "step 1[0]"), "grad1": (0.01, "a[0]")},
            "setup_s": 30.0, "peak_bytes": 6.4e10,
            "window": {"rounds": 10, "wall_s": 40.0, "tokens": 327680,
                       "steps": 40, "client_steps": 80},
            "trace": trace if traced else None,
            "counts": {"flops_per_token": 1.1e10, "sweep_bytes": 7.3e10,
                       "gossip_bytes": 3.25e10, "attention_flops_per_token": 7.0e8,
                       "tokens_per_client_step": 4096}}


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(traced):
    cell = run.load_cell(CELLS[0])
    cell["limits"] = {"loss": 1e-3, "grad1": 0.1}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 64000000000}
    line = json.loads(json.dumps(run.result_line(cell, _out(traced), traced, dev)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    want = cell["per_layer"] if traced else cell["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    if traced:
        assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"]["attention_roofline_pct"]["value"] == pytest.approx(
            100 * 7.0e8 * 4096 * 8 / 989e12 / 0.054)
    assert line["checks"]["loss"] == {"value": 1e-5, "limit": 1e-3, "at": "step 1[0]"}


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
         "2147483999", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
