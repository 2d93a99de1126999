"""The reference against the program at reduced sizes, both traffic mixes,
on the CPU (the only place that imports both): the loss and every leaf's
gradient from the same weights and tokens, then DEPOSITUM's first steps
through the program's trainer against the reference's, in float32."""
from __future__ import annotations

import dataclasses
import importlib
import time

import pytest
import torch

from perfbench.feed import TokenFeed
from perfbench.kinds import train
from perfbench.reference import depositum as reference
from perfbench.tests import reduced
from perfbench.weights import make_weights

CASES = [("qwen3-1.7b", "train-l2048-t4"), ("qwen3-1.7b", "train-l2048-t1")]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,traffic", CASES)
def test_loss_and_gradients_equal_the_program(name, traffic):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_value_grad_fn
    from repro_torch.models import build_model

    cfg, tr = reduced.config(name), reduced.traffic(traffic, seq_len=32)
    port = cfg["port"]
    pcfg = dataclasses.replace(get_config(port["arch"]), **port["fields"])
    fam = reference.family(cfg["family"])
    w = make_weights(fam.leaf_specs(cfg["model"]), 3, "cpu", "float32")
    tok = torch.from_numpy(TokenFeed(tr, cfg["model"]["vocab_size"], 3).step_tokens(0))
    module = getattr(importlib.import_module(port["module"]), port["class"])(
        pcfg, train.nested({k: v.clone() for k, v in w.items()}))
    grad_fn = make_value_grad_fn(build_model(pcfg, device="cpu"), template=module)
    g, aux = grad_fn({k: v[None].clone() for k, v in w.items()},
                     {"tokens": tok[:1, :, :-1], "labels": tok[:1, :, 1:]})
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    loss = fam.loss(params, tok[0, :, :-1], tok[0, :, 1:], cfg["model"])
    ref = torch.autograd.grad(loss, list(params.values()))
    assert float(aux["ce"][0]) == pytest.approx(float(loss.detach()), rel=1e-6)
    for (k, r) in zip(params, ref):
        scale = max(float(r.norm()), 1e-6)
        assert float((g[k][0] - r).norm()) <= 1e-4 * scale, k


@pytest.mark.parametrize("name,traffic", CASES)
def test_first_steps_agree_in_float32(name, traffic):
    cfg, tr = reduced.config(name), reduced.traffic(traffic, seq_len=32)
    out = train.run(cfg, tr, {}, 11, None, False, "cpu", time.perf_counter())
    assert set(out["numbers"]) == {"loss", "grad1", "grad1_med"} | {
        f"dx{t}{m}" for t in tr["check"]["dx_after"] for m in ("", "_med")}
    for k, (v, where) in out["numbers"].items():
        assert v < 1e-4, (k, v, where)
