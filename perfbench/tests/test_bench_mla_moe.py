"""The ``mla_moe`` family (DeepSeek-V2-Lite's share of one chip) in the
benchmark, on the CPU: the benchmark's reference against the program at
the reduced size through the harness (the loss and every leaf's gradient
from the same weights and tokens, then DEPOSITUM's first steps through the
program's trainer, in float32); the leaves against the program's
parameters at the configuration's widths; the work counts by hand and the
cell's pinned attention count; the two readers this family brings, and
that they read nothing in the qwen cells."""
from __future__ import annotations

import dataclasses
import importlib
import json
import time

import pytest
import torch

from perfbench import counts, run
from perfbench.feed import TokenFeed
from perfbench.kinds import train
from perfbench.metrics import expert_roofline_pct, moe_host_ms_per_client_step
from perfbench.reference import depositum as reference
from perfbench.reference import mla_moe
from perfbench.tests import reduced
from perfbench.weights import make_weights
from perfbench.work import mla_moe as work

CELL = "deepseek-v2-lite.train-l4096-t4"
FULL = json.loads((reduced.HERE / "configs" / "deepseek-v2-lite.json").read_text())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _program(cfg):
    from repro_torch.configs import get_config
    port = cfg["port"]
    pcfg = dataclasses.replace(get_config(port["arch"]), **port["fields"])
    return pcfg, getattr(importlib.import_module(port["module"]), port["class"])


def test_loss_and_gradients_equal_the_program():
    from repro_torch.launch.steps import make_value_grad_fn
    from repro_torch.models import build_model

    cfg = reduced.config("deepseek-v2-lite")
    tr = reduced.traffic("train-l4096-t4", seq_len=32)
    pcfg, cls = _program(cfg)
    w = make_weights(mla_moe.leaf_specs(cfg["model"]), 3, "cpu", "float32")
    tok = torch.from_numpy(TokenFeed(tr, cfg["model"]["vocab_size"], 3).step_tokens(0))
    module = cls(pcfg, train.nested({k: v.clone() for k, v in w.items()}))
    grad_fn = make_value_grad_fn(build_model(pcfg, device="cpu"), template=module)
    g, aux = grad_fn({k: v[None].clone() for k, v in w.items()},
                     {"tokens": tok[:1, :, :-1], "labels": tok[:1, :, 1:]})
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss = mla_moe.loss(params, tok[0, :, :-1], tok[0, :, 1:], cfg["model"])
    ref = torch.autograd.grad(loss, list(params.values()))
    assert float(aux["ce"][0]) == pytest.approx(float(loss.detach()), rel=1e-6)
    for (k, r) in zip(params, ref):
        scale = max(float(r.norm()), 1e-6)
        assert float((g[k][0] - r).norm()) <= 1e-4 * scale, k


def test_first_steps_agree_in_float32():
    cfg = reduced.config("deepseek-v2-lite")
    tr = reduced.traffic("train-l4096-t4", seq_len=32)
    out = train.run(cfg, tr, {}, 11, None, False, "cpu", time.perf_counter())
    assert set(out["numbers"]) == {"loss", "grad1", "grad1_med", "dx3",
                                   "dx3_med", "dx4", "dx4_med"}
    for k, (v, where) in out["numbers"].items():
        assert v < 1e-4, (k, v, where)


def test_leaves_match_the_program_at_full_width():
    """Names, shapes and order of the reference's leaves are the program's
    parameters at the configuration's widths (on ``meta``): 1,739,930,112
    of them, the program's own count of the cut."""
    pcfg, cls = _program(FULL)
    from repro_torch.models import transformer
    params, _ = transformer.init_params(pcfg, device="meta")
    module = cls(pcfg, params)
    got = [(k, tuple(p.shape)) for k, p in module.named_parameters()]
    specs = mla_moe.leaf_specs(FULL["model"])
    assert got == [(s[0], s[1]) for s in specs]
    assert counts.param_count(specs) == pcfg.param_count() == 1_739_930_112
    assert FULL["deployment"]["parameters"] == 1_739_930_112


def test_work_counts_by_hand():
    m = reduced.config("deepseek-v2-lite")["model"]
    L = 8
    # MLA a layer: wq 64x96, wkv_a 64x40, wkv_b 32x128, wo 64x64
    mla = 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    dense = 3 * 64 * 96
    # a MoE layer: the router's 4 outputs, one shared expert of 32, and
    # 2 x 2 / 4 = 1 held expert a token of 3 x 64 x 32
    moe = 64 * 4 + 3 * 64 * 32
    experts = 2 * 6 * 1 * 3 * 64 * 32
    attn = 3 * (3 * 2 * 2 * 4 * (24 + 16) / 2 * (L + 1) / 2)
    weights = 3 * mla + dense + 2 * moe + 64 * 500
    assert work.expert_flops_per_token(m, L) == experts
    assert work.attention_flops_per_token(m, L) == attn
    assert counts.flops_per_token("mla_moe", m, L) == 6 * weights + experts + attn


def test_the_cells_counts_are_pinned():
    """At L 4096: the attention's 17 layers x 12 x 16 heads x (192 + 128) /
    2 x 4097 / 2 FLOPs a token, and the held experts' 16 layers x 6 x 0.75
    x 3 x 2048 x 1408."""
    m = FULL["model"]
    assert work.attention_flops_per_token(m, 4096) == 1_069_808_640
    assert work.expert_flops_per_token(m, 4096) == 622_854_144
    assert counts.attention_flops_per_token("mla_moe", m, 4096) == 1_069_808_640


TRACE = {"client_steps": 8, "by_name": {
    "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm"
    "6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEEE": 0.05,
    "void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>": 0.001,
    "void flash_fwd_sm90_kernel<192, 128>(CUtensorMap)": 0.02,
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": 0.3}}


def _ctx(trace):
    """The new cell's reading context at full size (B 2 x L 4096)."""
    tr = json.loads((reduced.HERE / "traffic" / "train-l4096-t4.json").read_text())
    return {"window": None, "trace": trace, "setup_s": None, "peak_bytes": None,
            "counts": {"tokens_per_client_step": tr["batch"] * tr["seq_len"]},
            "model": FULL["model"], "traffic": tr}


def test_expert_roofline_by_hand():
    want = 100 * 622_854_144 * 8192 * 8 / 989e12 / 0.051
    assert expert_roofline_pct.read(_ctx(TRACE)) == pytest.approx(want, rel=1e-12)
    others = {"client_steps": 8, "by_name": {
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": 0.3}}
    assert expert_roofline_pct.read(_ctx(others)) is None


def test_new_readers_read_nothing_in_the_qwen_cells():
    qwen = json.loads((reduced.HERE / "configs" / "qwen3-1.7b.json").read_text())
    for name in ("qwen3-1.7b.train-l2048-t4", "qwen3-1.7b.train-l2048-t1"):
        cell = run.load_cell(name)
        ctx = {"window": None, "trace": TRACE, "setup_s": None, "peak_bytes": None,
               "counts": {"tokens_per_client_step": 4096}, "model": qwen["model"],
               "traffic": cell["traffic"]}
        assert expert_roofline_pct.read(ctx) is None
        assert moe_host_ms_per_client_step.read(ctx) is None


def test_moe_host_reader_reads_the_moe_spans():
    """A reduced bf16 traced run of the cell on the CPU: the ``moe`` spans'
    host time."""
    from repro_torch.obs import trace
    cfg = reduced.config("deepseek-v2-lite", "bfloat16")
    tr = reduced.traffic("train-l4096-t4", 16)
    out = train.run(cfg, tr, {}, 2147483999, 0.0, True, "cpu", time.perf_counter())
    ctx = run.context(cfg, tr, out)
    v = moe_host_ms_per_client_step.read(ctx)
    assert v is not None and v > 0
    rows = trace.STORE.summary()
    assert {"moe", "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
            "shared_expert", "mla"} <= set(rows)
