"""The ``mla_moe`` family (DeepSeek-V2-Lite) against the benchmark's plain
float32 reference of it (``perfbench/reference/mla_moe.py``: plain
``torch``, no kernel, nothing of the port, no JAX), on seeded random
weights at the reduced size on the CPU: the loss and every leaf's gradient; one chip's
expert share against the uncut layer; dropless routing; YaRN's
frequencies and the softmax scale against the values written out; two
``FederatedTrainer`` rounds through ``launch/train.py``; a checkpoint
round trip.  The reference has no such family, so nothing here is held
against the JAX package."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from perfbench.reference import mla_moe as ref
from perfbench.reference.common import Precision, exact_fp32, swiglu
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import train
from repro_torch.models import build_model, mlp
from repro_torch.models.common import yarn_correction_range, yarn_inv_freq
from repro_torch.training import restore_checkpoint, save_checkpoint

ARCH = "deepseek-v2-lite"
#: fp32 on both sides, summed in different orders (the routing is the
#: same: no score lies within rounding of the top-k boundary at this size):
#: the gaps are ~1e-6 relative, so 1e-4 leaves room and still catches any
#: change of the mathematics (a missing term, a wrong scale)
GRAD_REL = 1e-4
LOSS_REL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with exact_fp32():
        yield
    torch.set_num_threads(n)


def _model(cfg, **over):
    """The reference's model block of a port configuration."""
    return {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "d_ff": cfg.d_ff,
            "moe_d_ff": cfg.moe_d_ff, "first_k_dense": cfg.first_k_dense,
            "n_routed_experts": cfg.n_experts, "experts_held": cfg.held,
            "expert_offset": cfg.expert_offset,
            "experts_per_token": cfg.experts_per_token,
            "n_shared_experts": cfg.n_shared_experts,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "aux_alpha": cfg.router_aux_weight, "rope_theta": cfg.rope_theta,
            "yarn": dataclasses.asdict(cfg.yarn), "rms_eps": 1e-6, **over}


def _weights(cfg, seed):
    """The port's module on the CPU with its norm scales drawn too (so
    that (1 + w) is exercised), and the same weights as a flat dict."""
    net, _ = build_model(cfg, device="cpu").init(seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("scale", "kv_norm")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net, {k: v.detach().clone() for k, v in net.named_parameters()}


def _tokens(cfg, B=2, L=24, seed=0):
    tok = torch.randint(0, cfg.vocab_size, (B, L + 1),
                        generator=torch.Generator().manual_seed(seed))
    return tok[:, :-1], tok[:, 1:]


def test_config_published_and_as_run():
    """The published widths, the count at the benchmark's cut (17 layers,
    8 of 64 experts, 12,800 vocabulary rows) and in full (15.7 B), and
    the port-only registry: the reference's ten archs stay the zoo."""
    c = get_config(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.kv_lora_rank,
            c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.d_ff,
            c.moe_d_ff, c.n_experts, c.experts_per_token, c.n_shared_experts,
            c.first_k_dense, c.vocab_size) == (27, 2048, 16, 512, 128, 64,
                                                128, 10944, 1408, 64, 6, 2,
                                                1, 102400)
    assert c.held == 64 and not c.norm_topk_prob and c.hd == 192
    assert c.param_count() == 15_706_484_224
    cut = dataclasses.replace(c, n_layers=17, experts_held=8, vocab_size=12800)
    assert cut.param_count() == 1_739_930_112
    net, _ = build_model(dataclasses.replace(cut, dtype="bfloat16"),
                         device="meta").init()
    assert sum(p.numel() for p in net.parameters()) == cut.param_count()
    assert tuple(net.blocks[1].moe.w_gate.shape) == (8, 2048, 1408)
    assert ARCH not in list_archs()
    r = get_config(ARCH, reduced=True)
    assert r.first_k_dense == 1 and r.n_layers - r.first_k_dense >= 2
    assert (r.n_experts, r.held, r.experts_per_token, r.n_shared_experts) \
        == (4, 2, 2, 1)


def test_yarn_frequencies_and_softmax_scale_written_out():
    """DeepSeek-V2's YaRN at factor 40 over 4,096 positions, beta 32 / 1,
    64 RoPE dims: the correction range [10.47 -> 10, 22.51 -> 23] and the
    inverse frequencies (float64 by hand: theta^(-2i/64) below the range,
    that over 40 above it, the linear ramp between), fp32 to 2e-7; mscale
    0.1 x 0.707 x ln 40 + 1 and the scale mscale^2 / sqrt(192)."""
    c = get_config(ARCH)
    assert yarn_correction_range(c.yarn, 64, 1e4) == (10, 23)
    got = yarn_inv_freq(64, 1e4, c.yarn).double().numpy()
    want = {0: 1.0, 1: 0.7498942093324559, 9: 0.07498942093324558,
            10: 0.05623413251903491, 11: 0.03900692656714386, 16: 0.0055,
            22: 0.0001778279410038922, 23: 3.33380358040831e-05,
            31: 3.3338035804083097e-06}
    for i, v in want.items():
        assert got[i] == pytest.approx(v, rel=2e-7), i
    assert c.softmax_scale == pytest.approx(0.11472138679292612, rel=1e-12)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.2608037774058554, rel=1e-15)
    # the benchmark reference's YaRN, written independently (the ramp's
    # complement formed in another order), agrees to fp32 rounding
    mine = ref.yarn_inv_freq(_model(c), "cpu")
    torch.testing.assert_close(mine, yarn_inv_freq(64, 1e4, c.yarn),
                               rtol=2e-7, atol=0)
    assert ref.softmax_scale(_model(c)) == pytest.approx(c.softmax_scale,
                                                         rel=1e-15)


def test_loss_and_every_gradient_match_the_plain_reference():
    cfg = get_config(ARCH, reduced=True)
    net, w = _weights(cfg, 7)
    tokens, labels = _tokens(cfg)
    model = build_model(cfg, device="cpu")
    loss, aux = model.loss(net, {"tokens": tokens, "labels": labels})
    loss.backward()
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    # the reference's value is the cross-entropy; its gradient is that of
    # the cross-entropy plus alpha times the summed balance losses
    rloss = ref.loss(params, tokens, labels, _model(cfg))
    rloss.backward()
    assert float(aux["ce"]) == pytest.approx(float(rloss.detach()),
                                            rel=LOSS_REL)
    assert float(aux["moe_aux"]) > 0
    assert float(loss) == pytest.approx(
        float(aux["ce"]) + cfg.router_aux_weight * float(aux["moe_aux"]),
        rel=1e-6)
    for name, p in net.named_parameters():
        r = params[name].grad
        gap = float((p.grad - r).norm() / r.norm())
        assert gap <= GRAD_REL, (name, gap)


def test_the_balance_term_reaches_the_router():
    """The router's gradient holds alpha x d(seq_aux): without the term it
    differs by more than the check's tolerance."""
    cfg = get_config(ARCH, reduced=True)
    tokens, labels = _tokens(cfg, seed=3)
    grads = []
    for alpha in (cfg.router_aux_weight, 0.0):
        c = dataclasses.replace(cfg, router_aux_weight=alpha)
        net, _ = _weights(c, 9)
        build_model(c, device="cpu").loss(
            net, {"tokens": tokens, "labels": labels})[0].backward()
        grads.append(net.blocks[1].moe.router.grad.clone())
    assert float((grads[0] - grads[1]).norm() / grads[0].norm()) > 10 * GRAD_REL


@pytest.mark.parametrize("shares", [2, 4])
def test_shares_add_up_to_the_uncut_layer(shares):
    """The reduced MoE layer (4 routed experts, top-2, one shared expert)
    cut into ``shares`` chips' shares: their routed parts, with the shared
    expert counted once, add up to the reference's uncut layer; every
    share computes the same balance loss (all four router outputs)."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), experts_held=0)
    net, w = _weights(cfg, 11)
    whole = {k[len("blocks.1.moe."):]: v for k, v in w.items()
             if k.startswith("blocks.1.moe.")}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(5))
    want, want_aux = ref._moe(
        x, *(whole[k] for k in ("router", "w_gate", "w_up", "w_down",
                                "shared.w_gate", "shared.w_up",
                                "shared.w_down")),
        _model(cfg, experts_held=4, expert_offset=0), Precision())
    n = cfg.n_experts // shares
    total, shared_once = 0.0, None
    for s in range(shares):
        c = dataclasses.replace(cfg, experts_held=n, expert_offset=s * n)
        p = {k: (v[s * n:(s + 1) * n] if k in ("w_gate", "w_up", "w_down") else v)
             for k, v in whole.items() if not k.startswith("shared.")}
        p["shared"] = {k[len("shared."):]: v for k, v in whole.items()
                       if k.startswith("shared.")}
        out, aux = mlp.expert_share(p, x, c)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
        shared_once = mlp.mlp(p["shared"], x, c)
        total = total + out
    total = total - (shares - 1) * shared_once
    assert float((total - want).norm() / want.norm()) < 1e-5


def test_dropless_every_row_kept():
    """A router that sends every token to expert 0 (held) and one other:
    no row is lost (the output is each token's weighted experts, computed
    row by row), and the dispatch's group offsets end at the count of
    rows routed to the held experts."""
    cfg = get_config(ARCH, reduced=True)           # holds experts 0 and 1
    net, w = _weights(cfg, 13)
    p = {k[len("blocks.1.moe."):]: v for k, v in w.items()
         if k.startswith("blocks.1.moe.")}
    p["shared"] = {k[len("shared."):]: p.pop(k) for k in list(p)
                   if k.startswith("shared.")}
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 0.3                       # expert 0 wins everywhere
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    x = x + 1.0                                    # so that x @ router's column 0 is large
    out, _ = mlp.expert_share(p, x, cfg)
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"], -1)
    wk, ids = torch.topk(probs, 2, -1)
    assert bool((ids[:, 0] == 0).all()) and float(wk[:, 1].min()) > 1e-12
    xt = x.reshape(-1, cfg.d_model)
    _, _, offs, _ = mlp.dispatch(xt, ids, cfg)
    assert int(offs[-1]) == int((ids < cfg.held).sum())
    rows = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(2):
            e = int(ids[t, j])
            if e < cfg.held:
                rows[t] += wk[t, j] * swiglu(xt[t], p["w_gate"][e],
                                             p["w_up"][e], p["w_down"][e],
                                             Precision())
    shared = mlp.mlp(p["shared"], x, cfg).reshape(-1, cfg.d_model)
    got = out.reshape(-1, cfg.d_model) - shared
    assert float((got - rows).norm() / rows.norm()) < 1e-5


def test_grouped_products_equal_a_loop_per_group():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(13, 8, generator=gen)
    w = torch.randn(3, 8, 5, generator=gen)
    offs = torch.tensor([4, 4, 10], dtype=torch.int32)   # an empty group
    got = mlp.grouped_mm(x, w, offs)
    want = torch.cat([x[:4] @ w[0], x[4:10] @ w[2], torch.zeros(3, 5)])
    assert torch.equal(got, want)


def test_mla_routes_on_the_cpu():
    """``use_flash`` None on the CPU computes ``_sdpa`` at the MLA scale;
    True the plain flash pair (forward with ``lse``, backward): the same
    loss and gradients to fp32 rounding."""
    cfg = get_config(ARCH, reduced=True)
    from repro_torch.models import attention
    net, w = _weights(cfg, 17)
    a = {k[len("blocks.0.attn."):]: v.clone().requires_grad_()
         for k, v in w.items() if k.startswith("blocks.0.attn.")}
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(1))
    outs = []
    for use_flash in (None, True):
        y = attention.mla_train(a, x, cfg, use_flash=use_flash)
        g = torch.autograd.grad(y.square().sum(), list(a.values()))
        outs.append((y, g))
    (y0, g0), (y1, g1) = outs
    assert float((y0 - y1).norm() / y0.norm()) < 1e-6
    for u, v in zip(g0, g1):
        assert float((u - v).norm() / u.norm()) < 1e-5


def test_serving_is_not_ported():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, device="cpu")
    net, _ = model.init(seed=0)
    with pytest.raises(NotImplementedError, match="latent KV cache"):
        model.forward_prefill(net, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, 8)


def test_two_rounds_through_the_launcher_and_a_checkpoint(tmp_path):
    """``launch.train --arch deepseek-v2-lite --reduced``: two rounds of two
    clients through ``FederatedTrainer`` (fused "auto"), finite losses that
    the second round lowers from the first step's, every leaf moved; the
    consensus saved with ``--ckpt`` (the dense first layer and the MoE
    layers kept apart in the file) restores bit for bit."""
    ck = str(tmp_path / "ck.npz")
    trainer, state, hist = train.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--clients", "2",
         "--batch", "2", "--seq", "16", "--t0", "2", "--topology",
         "complete", "--rounds", "2", "--log-every", "1", "--alpha", "0.05",
         "--ckpt", ck])
    assert state.t == 4 and [h["round"] for h in hist] == [1, 2]
    assert all(math.isfinite(h["loss"]) for h in hist)
    x0 = trainer.init_state(0).x
    moved = {k: float((state.x[k] - x0[k]).abs().max()) for k in x0}
    assert min(moved.values()) > 0, moved
    mean = trainer.mean_params(state)
    with np.load(ck) as data:
        assert "blocks/0/mlp/w_gate" in data and "blocks/1/moe/w_gate" in data
        assert data["blocks/1/moe/w_gate"].shape == (2, 64, 32)
    back, step = restore_checkpoint(ck, mean)
    assert step == 2
    for (k, a), (_, b) in zip(mean.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), k
    save_checkpoint(str(tmp_path / "again.npz"), back, step=2)
    again, _ = restore_checkpoint(str(tmp_path / "again.npz"), mean)
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                   again.parameters()))


def test_rows_the_grouped_product_leaves_unwritten_are_never_read(monkeypatch):
    """On the card ``torch._grouped_mm`` does not write the rows past the
    held experts' (they hold whatever memory held): filled with NaN here,
    the loss and every gradient stay those of the plain path."""
    cfg = get_config(ARCH, reduced=True)
    net, w = _weights(cfg, 19)
    tokens, labels = _tokens(cfg, seed=4)
    model = build_model(cfg, device="cpu")

    def grads():
        net.zero_grad()
        loss, _ = model.loss(net, {"tokens": tokens, "labels": labels})
        loss.backward()
        return float(loss), {k: p.grad.clone() for k, p in net.named_parameters()}

    want_loss, want = grads()
    plain = mlp.grouped_mm_plain

    def unwritten(x, w, offs):
        out = plain(x, w, offs)
        rows = torch.arange(out.shape[0])[:, None] >= offs[-1]
        return torch.where(rows, torch.full_like(out, math.nan), out)

    monkeypatch.setattr(mlp, "grouped_mm", unwritten)
    got_loss, got = grads()
    assert got_loss == want_loss
    for k, g in got.items():
        assert torch.equal(g, want[k]), k
