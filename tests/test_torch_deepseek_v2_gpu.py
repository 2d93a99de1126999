"""The ``mla_moe`` family's device paths on the card: the bf16 flash
kernels at (D 192, DV 128), the grouped expert products, the expert
share with no host synchronisation, and a reduced bf16 step through the
kernels.  Marked ``gpu``; each test skips without a CUDA card.  This file
imports neither JAX nor the reference::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_deepseek_v2_gpu.py

Tolerances: the kernels round P and dS to bf16 as wgmma operands and the
plain versions compute in fp32 from the same bf16 inputs, so outputs and
gradients are held at ``FLASH_BWD_REL`` relative L2 (the D = DV kernels'
bound; they read ~2.5e-3 here), ``lse`` at 1e-4 absolute; the grouped
bf16 products (fp32 accumulation, one bf16 rounding of the output)
against fp32 products of the same bf16 operands at 1e-2; the MLA layer
through the kernels against ``_sdpa`` (which rounds its probabilities to
bf16) at 3e-2.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

FLASH_BWD_REL = 1e-2
GROUPED_REL = 1e-2
MLA_ROUTE_REL = 3e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,KV,causal,window", [
    (2, 1024, 16, 16, True, 0), (1, 300, 4, 4, True, 0),
    (2, 257, 8, 4, True, 64), (1, 200, 4, 4, False, 0)])
def test_flash_192_128_against_plain(B, L, H, KV, causal, window):
    _card()
    from repro_torch.kernels.flash_attention import kernel as fk

    g = torch.Generator(device="cuda").manual_seed(L)
    q = torch.randn(B, L, H, 192, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, L, KV, 192, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, L, KV, 128, device="cuda", generator=g).bfloat16()
    do = torch.randn(B, L, H, 128, device="cuda", generator=g).bfloat16()
    scale = 1.2608037774058554 ** 2 / math.sqrt(192)
    o, lse = fk.flash_attention_fwd_train_cuda(q, k, v, causal=causal,
                                               window=window, scale=scale)
    grads = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window, scale=scale)
    po, plse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        scale=scale, return_lse=True)
    pgrads = fk.flash_attention_bwd_plain(q, k, v, po, plse, do,
                                          causal=causal, window=window,
                                          scale=scale)
    assert o.shape == (B, L, H, 128) and _rel(o, po) < FLASH_BWD_REL
    assert float((lse[..., :L] - plse).abs().max()) < 1e-4
    assert bool(torch.isinf(lse[..., L:]).all())
    for got, want in zip(grads, pgrads):
        assert got.shape == want.shape and _rel(got, want) < FLASH_BWD_REL


@pytest.mark.gpu
def test_grouped_products_against_a_loop_per_expert():
    """One ``torch._grouped_mm`` launch against each expert's product, on
    ragged groups (one empty), forward and both gradients; rows past the
    last group are masked by the caller, so only the groups are read."""
    _card()
    from repro_torch.models import mlp

    g = torch.Generator(device="cuda").manual_seed(0)
    sizes = [300, 0, 517, 64, 1, 811, 128, 99]
    R = sum(sizes) + 40
    x = torch.randn(R, 2048, device="cuda", generator=g).bfloat16().requires_grad_()
    w = (torch.randn(8, 2048, 1408, device="cuda", generator=g) / 45).bfloat16()
    w.requires_grad_()
    offs = torch.cumsum(torch.tensor(sizes, device="cuda"), 0).to(torch.int32)
    y = mlp.grouped_mm(x, w, offs)
    gy = torch.randn(y.shape, device="cuda", generator=g).bfloat16()
    n = int(offs[-1])
    gx, gw = torch.autograd.grad(y[:n], (x, w), gy[:n])
    xf, wf = x.detach().float(), w.detach().float()
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            assert _rel(y[start:end], xf[start:end] @ wf[e]) < GROUPED_REL
            assert _rel(gx[start:end], gy[start:end].float() @ wf[e].t()) < GROUPED_REL
            assert _rel(gw[e], xf[start:end].t() @ gy[start:end].float()) < GROUPED_REL
        else:
            assert float(gw[e].abs().max()) == 0
        start = end


@pytest.mark.gpu
def test_expert_share_makes_no_host_sync():
    """The DeepSeekMoE share's forward and backward (route, dispatch,
    grouped products, combine, shared experts, the balance loss) under
    ``torch.cuda.set_sync_debug_mode("error")``: any device-to-host
    synchronisation raises.  The output matches the CPU's plain path."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, mlp

    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite", reduced=True), d_model=256,
        moe_d_ff=128, n_experts=64, experts_held=8, expert_offset=8,
        experts_per_token=6, n_shared_experts=2, dtype="bfloat16")
    net, _ = build_model(cfg, device="cuda").init(seed=2)
    p = net.blocks[1].moe.tensors()
    x = torch.randn(2, 256, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).bfloat16().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = mlp.expert_share(p, x, cfg)
        loss = out.float().square().mean() + 1e-3 * aux
        grads = torch.autograd.grad(loss, [x, p["router"], p["w_gate"],
                                           p["w_up"], p["w_down"]])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    cpu = {k: (v.detach().cpu().float() if torch.is_tensor(v) else
               {a: b.detach().cpu().float() for a, b in v.items()})
           for k, v in p.items()}
    want, want_aux = mlp.expert_share(cpu, x.detach().cpu().float(),
                                      dataclasses.replace(cfg, dtype="float32"))
    assert _rel(out.cpu(), want) < 3e-2
    assert float(aux) == pytest.approx(float(want_aux), rel=2e-2)


@pytest.mark.gpu
def test_reduced_bf16_step_through_the_kernels(monkeypatch):
    """A reduced bf16 step (remat "full", 2 clients) at the true head dims
    (128 + 64 / 128) through the trainer's gradient function: the
    (192, 128) training forward twice and the backward once a layer and
    client, no ``_sdpa`` dispatch, finite gradients; the MLA layer alone
    through the kernels against ``_sdpa`` within ``MLA_ROUTE_REL``."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import train
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite", reduced=True), n_heads=2,
        n_kv_heads=2, head_dim=192, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, dtype="bfloat16", remat=True,
        remat_policy="full")
    monkeypatch.setattr(train, "get_config", lambda *a, **kw: cfg)
    args = train.parse_args(["--arch", "deepseek-v2-lite", "--reduced",
                             "--clients", "2", "--batch", "2", "--seq",
                             "128", "--t0", "1", "--seed", "3"])
    trainer, _, state, it = train.build(args)
    batch = {k: v[0] for k, v in next(it).items()}
    fk.reset_launch_counts()
    attn.DISPATCH_COUNTS.clear()
    g, _ = trainer._grad_fn(state.x, batch)
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS["flash_bwd"] == cfg.n_layers * 2
    assert fk.LAUNCH_COUNTS["flash_fwd_train"] == 2 * cfg.n_layers * 2
    assert not attn.DISPATCH_COUNTS
    assert all(bool(torch.isfinite(v).all()) for v in g.values())

    net, _ = trainer.model.init(seed=5)
    a = {k: v.detach().requires_grad_() for k, v in net.blocks[0].attn.tensors().items()}
    x = torch.randn(2, 256, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4)).bfloat16()
    outs = []
    for use_flash in (None, False):
        y = attn.mla_train(a, x, cfg, use_flash=use_flash)
        outs.append((y, torch.autograd.grad(y.float().square().sum(),
                                            list(a.values()))))
    (y0, g0), (y1, g1) = outs
    assert _rel(y0, y1) < MLA_ROUTE_REL
    for u, v in zip(g0, g1):
        assert _rel(u, v) < MLA_ROUTE_REL
