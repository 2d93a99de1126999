"""``perfbench/counts.py`` and the dense family's work counts
(``perfbench/work/dense.py``) against hand counts at reduced sizes and
the flagship's pinned count, and the state it reckons against the
program's dry run and parameters."""
from __future__ import annotations

import pytest

from perfbench import counts
from perfbench.reference import dense
from perfbench.tests import reduced

DENSE = reduced.config("qwen3-1.7b")["model"]      # d 64, 2 layers, 4/2 heads of 16, ff 128, V 500


def test_dense_flops_by_hand():
    L = 8
    # a layer: wq 64x64, wk 64x32, wv 64x32, wo 64x64, 3 x 64x128
    layer = 4096 + 2048 + 2048 + 4096 + 3 * 8192
    weights = 2 * layer + 64 * 500                  # + the tied LM head, published vocab
    attn = 3 * 2 * 2 * 4 * 16 * (L + 1) / 2         # a layer, a token
    assert counts.flops_per_token("dense", DENSE, L) == 6 * weights + 2 * attn
    assert counts.attention_flops_per_token("dense", DENSE, L) == 2 * attn


def test_flagship_counts_are_pinned():
    """qwen3-1.7b at L 2048: the count every run of both cells reads, and
    its attention's (28 layers x 12 x 16 heads x 128 x 2049 / 2)."""
    import json

    m = json.loads((reduced.HERE / "configs" / "qwen3-1.7b.json").read_text())["model"]
    assert counts.flops_per_token("dense", m, 2048) == 11027693568.0
    assert counts.attention_flops_per_token("dense", m, 2048) == 704987136.0


def test_bytes_by_hand():
    specs = dense.leaf_specs(DENSE)
    n = sum(1 for _ in specs)
    params = 2 * (64 + 4096 + 2048 + 2048 + 4096 + 16 + 16 + 64 + 3 * 8192) \
        + 512 * 64 + 64                             # the table is also the head
    assert n == 2 * 11 + 2
    assert counts.param_count(specs) == params
    assert counts.tree_bytes(specs, "bfloat16") == 2 * params
    assert counts.sweep_pair_bytes(specs, "bfloat16", 2) == 9 * 2 * 2 * params
    assert counts.gossip_bytes(specs, "bfloat16", 2) == 4 * 2 * 2 * params
    assert counts.state_bytes(specs, "float32", 3) == 5 * 3 * 4 * params


@pytest.mark.parametrize("name,params", [("qwen3-1.7b", 1_720_837_120)])
def test_full_width_state_equals_the_dry_run(name, params, monkeypatch):
    """The dry run of the program's configuration with the fields the
    benchmark runs it with (the tied head) reckons the same state."""
    import dataclasses
    import json

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = json.loads((reduced.HERE / "configs" / f"{name}.json").read_text())
    as_run = dataclasses.replace(get_config(cfg["port"]["arch"]), **cfg["port"]["fields"])
    monkeypatch.setattr(dryrun, "get_config", lambda arch: as_run)
    specs = dense.leaf_specs(cfg["model"])
    rec = dryrun.run_one(name, "train_4k", n_clients=2)
    assert counts.state_bytes(specs, "bfloat16", 2) == rec["state_bytes"]
    assert counts.param_count(specs) == rec["params"] == params


@pytest.mark.parametrize("name", ["qwen3-1.7b"])
def test_leaves_match_the_program(name):
    """Names, shapes and order of the reference's leaves are the program's
    parameters at the configuration's widths (on ``meta``)."""
    import dataclasses
    import importlib
    import json

    from repro_torch.configs import get_config

    cfg = json.loads((reduced.HERE / "configs" / f"{name}.json").read_text())
    port = cfg["port"]
    pcfg = dataclasses.replace(get_config(port["arch"]), **port["fields"])
    mod = importlib.import_module(port["module"])
    params, _ = mod.init_params(pcfg, device="meta")
    module = getattr(mod, port["class"])(pcfg, params)
    got = [(k, tuple(p.shape)) for k, p in module.named_parameters()]
    assert got == [(s[0], s[1]) for s in dense.leaf_specs(cfg["model"])]
