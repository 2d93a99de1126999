"""A model family joins the benchmark through files named after it alone:
its work counts (``perfbench/work/<family>.py``), its reference
(``perfbench/reference/<family>.py``) and its reduced test sizes
(``perfbench/tests/families/<family>.py``).  A ``toy`` family, put in
``sys.modules`` under those names, runs through the harness's counts,
``reduced.config`` and the attention roofline's reader; a family without
its work module fails before set-up and names the file to add."""
from __future__ import annotations

import json
import math
import sys
import time
import types

import pytest

from perfbench import counts, run
from perfbench.kinds import train
from perfbench.metrics import attention_roofline_pct
from perfbench.tests import reduced

FLASH = {"void flash_fwd_sm90_kernel<128>(CUtensorMap, CUtensorMap)": 0.004,
         "void flash_bwd_delta_kernel(const __nv_bfloat16*)": 0.001,
         "void flash_bwd_dkdv_kernel<128>(CUtensorMap)": 0.007,
         "void flash_bwd_dq_kernel<128>(CUtensorMap)": 0.008}
OTHERS = {"void flash_fwd_fp32_kernel<128>(const float*)": 0.5,
          "void fused_update_kernel<__nv_bfloat16, 0, false>(Tab)": 0.05,
          "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": 0.2}


def _module(monkeypatch, name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    monkeypatch.setitem(sys.modules, name, mod)


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """A family whose attention has a query/key head of 12 and a value
    head of 8, with one configuration file, ``configs/toy.json``."""
    def attention(m, L):
        return m["n_layers"] * 3 * 2 * m["n_heads"] * (m["d_qk"] + m["d_v"]) * (L + 1) / 2

    _module(monkeypatch, "perfbench.work.toy",
            attention_flops_per_token=attention,
            flops_per_token=lambda m, L: 6 * m["d"] * m["d"] + attention(m, L))
    _module(monkeypatch, "perfbench.reference.toy",
            leaf_specs=lambda m: [("w", (m["d"], m["d"]), "normal", 0.1),
                                  ("b", (m["d"],), "zeros", 0.0)])
    _module(monkeypatch, "perfbench.tests.families.toy",
            MODEL={"d": 8, "n_layers": 1, "n_heads": 2, "d_qk": 12, "d_v": 8},
            port_fields=lambda m: {"d_model": m["d"]})
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps({
        "name": "toy", "family": "toy",
        "model": {"d": 1024, "n_layers": 4, "n_heads": 16, "d_qk": 192,
                  "d_v": 128, "dtype": "bfloat16"},
        "port": {"fields": {"d_model": 1024, "dtype": "bfloat16"}}}))
    tr = reduced.traffic("train-l2048-t4", seq_len=16, batch=3)
    monkeypatch.setattr(reduced, "HERE", tmp_path)
    return reduced.config("toy"), tr


def test_a_new_family_runs_through_the_harness(toy):
    cfg, tr = toy
    assert cfg["model"] == {"d": 8, "n_layers": 1, "n_heads": 2, "d_qk": 12,
                            "d_v": 8, "dtype": "float32"}
    assert cfg["port"]["fields"] == {"d_model": 8, "dtype": "float32"}
    specs = sys.modules["perfbench.reference.toy"].leaf_specs(cfg["model"])
    got = train.work_counts(cfg, tr, specs)
    attn = 3 * 2 * 2 * (12 + 8) * 17 / 2
    assert got == {"flops_per_token": 6 * 64 + attn,
                   "attention_flops_per_token": attn,
                   "tokens_per_client_step": 48,
                   "sweep_bytes": 9 * 2 * 4 * 72,
                   "gossip_bytes": 4 * 2 * 4 * 72}
    assert counts.flops_per_token("toy", cfg["model"], 16) == got["flops_per_token"]
    trace = {"client_steps": 8, "by_name": {**FLASH, **OTHERS}}
    ctx = run.context(cfg, tr, {"window": None, "trace": trace, "counts": got,
                                "setup_s": None, "peak_bytes": None})
    assert ctx["model"]["d_qk"] == 12 and ctx["traffic"]["batch"] == 3
    want = 100 * attn * 48 * 8 / 989e12 / 0.020
    assert attention_roofline_pct.read(ctx) == pytest.approx(want, rel=1e-12)


def test_attention_roofline_by_hand():
    """The flagship's shape: 704,987,136 FLOPs a token, B 2 x L 2048 a
    client-step, 8 client-steps traced (one T0 4 round of 2 clients); the
    four flash kernels' time alone, not the fp32 forward's."""
    ctx = {"trace": {"client_steps": 8, "by_name": {**FLASH, **OTHERS}},
           "counts": {"attention_flops_per_token": 704987136.0,
                      "tokens_per_client_step": 4096}}
    bound = 704987136.0 * 4096 * 8 / 989e12           # 23.4 ms: 2.92 a client-step
    assert attention_roofline_pct.read(ctx) == pytest.approx(100 * bound / 0.020)
    assert math.isclose(bound / 8, 2.92e-3, rel_tol=1e-3)


@pytest.mark.parametrize("by_name", [OTHERS, {}])
def test_attention_roofline_reads_nothing_without_a_flash_kernel(by_name):
    ctx = {"trace": {"client_steps": 8, "by_name": by_name},
           "counts": {"attention_flops_per_token": 1.0, "tokens_per_client_step": 1}}
    assert attention_roofline_pct.read(ctx) is None


def test_a_family_without_work_counts_fails_before_set_up(monkeypatch):
    _module(monkeypatch, "perfbench.reference.nowork", leaf_specs=lambda m: [])
    cfg = json.loads((reduced.HERE / "configs" / "qwen3-1.7b.json").read_text())
    cfg["family"] = "nowork"

    def no_set_up(*a, **k):
        raise AssertionError("set-up began")

    monkeypatch.setattr(train, "build_program", no_set_up)
    monkeypatch.setattr(train, "TokenFeed", no_set_up)
    with pytest.raises(ModuleNotFoundError, match=r"perfbench/work/nowork\.py"):
        train.run(cfg, reduced.traffic("train-l2048-t4"), {}, 1, 1.0, False,
                  "cpu", time.perf_counter())
