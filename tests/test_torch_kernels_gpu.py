"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a CUDA card (the CPU suite counts
them as skipped).  This file imports neither JAX nor the reference, so it
also runs on a machine that has only PyTorch and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerance: the prox kernels and their plain versions do the same fp32
operations in the same order (built with -fmad=false), held at atol = rtol
= 1e-6; frozen rows of the cohort gate are held bit for bit.  The flash
kernel sums its online softmax blockwise: fp32 at 2e-5, bf16 at 3e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.prox import kernel as tk

S, C = 3, 4
TOL = dict(atol=1e-6, rtol=1e-6)
TABLE = dict(lam=[1e-3, 5e-3, 1e-2], theta=4.0, alpha=[0.05, 0.1, 0.2],
             gamma=[0.0, 0.5, 0.9], beta=[1.0, 0.5, 1.5])
MASK = np.array([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 0, 1]], np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 1001, 1024])
def test_cuda_kernels_match_plain_versions(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(d)
    x, y, nu = (torch.randn((S, C, d), generator=g, device="cuda") * 0.1
                for _ in range(3))
    tt = tk.sweep_params_table(**TABLE, device="cuda")
    mask = torch.from_numpy(MASK).cuda()
    before = dict(tk.LAUNCH_COUNTS)
    for m in (None, mask):
        for kind in ("l1", "mcp", "scad"):
            out = tk.fused_update_sweep_cuda(x, y, nu, tt, m, kind=kind)
            ref = tk.fused_update_sweep_plain(x, y, nu, tt, m, kind=kind)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, **TOL)
        out = tk.fused_tracking_sweep_cuda(y, nu, x, tt, m)
        ref = tk.fused_tracking_sweep_plain(y, nu, x, tt, m)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **TOL)
    torch.cuda.synchronize()
    frozen = mask <= 0
    xo, nuo = tk.fused_update_sweep_cuda(x, y, nu, tt, mask, kind="scad")
    assert torch.equal(xo[frozen].view(torch.int32),
                       x[frozen].view(torch.int32))
    assert torch.equal(nuo[frozen].view(torch.int32),
                       nu[frozen].view(torch.int32))
    assert tk.LAUNCH_COUNTS["fused_sweep"] == before.get("fused_sweep", 0) + 7
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == before.get(
        "tracking_sweep", 0) + 2


@pytest.mark.gpu
def test_bf16_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(7)
    x, y, nu = ((torch.randn((S, C, 333), generator=g, device="cuda") * 0.1)
                .to(torch.bfloat16) for _ in range(3))
    tt = tk.sweep_params_table(**TABLE, device="cuda")
    mask = torch.from_numpy(MASK).cuda()
    for kind in ("l1", "mcp", "scad"):
        out = tk.fused_update_sweep_cuda(x, y, nu, tt, mask, kind=kind)
        ref = tk.fused_update_sweep_plain(x, y, nu, tt, mask, kind=kind)
        for a, b in zip(out, ref):  # fp32 math, one bf16 rounding: equal
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(tk.fused_tracking_sweep_cuda(y, nu, x, tt, mask),
                    tk.fused_tracking_sweep_plain(y, nu, x, tt, mask)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_round_on_the_card_matches_the_cpu():
    """One fused round of a small MLP: kernels on the card vs plain versions
    on the CPU (matmuls sum in another order: rtol 1e-4, atol 1e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import (DepositumConfig, MixPlan, init,
                                  local_then_comm_round, mixing_matrix)
    from repro_torch.models.classifier import MLP, client_grad_fn, init_params

    n, T0, d_in, k = 4, 3, 12, 5
    model = MLP(d_in, k, (16, 8))
    cfg = DepositumConfig(alpha=0.05, beta=0.5, gamma=0.8, comm_period=T0,
                          prox_name="mcp",
                          prox_kwargs={"lam": 1e-3, "theta": 4.0},
                          fused="require")
    rng = np.random.default_rng(0)
    batches = {"x": torch.from_numpy(
        rng.standard_normal((T0, n, 6, d_in)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, k, (T0, n, 6)))}
    W = mixing_matrix("ring", n)
    out = {}
    tk.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        state = init(init_params(model, 0, device=dev), n, device=dev)
        out[dev], _ = local_then_comm_round(
            state, {key: v.to(dev) for key, v in batches.items()},
            client_grad_fn(model.to(dev)), cfg, MixPlan.dense(W, device=dev))
    torch.cuda.synchronize()
    assert tk.LAUNCH_COUNTS["fused_sweep"] == T0 * 6
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == T0 * 6
    for f in ("x", "y", "nu", "g"):
        for key, v in getattr(out["cuda"], f).items():
            torch.testing.assert_close(v.cpu(), getattr(out["cpu"], f)[key],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["l1", "mcp", "scad"])
def test_one_config_kernels_match_plain_versions(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(11)
    hp = dict(lam=1e-3, theta=4.0, alpha=0.1)
    before = dict(tk.LAUNCH_COUNTS)
    for shape, dtype in (((1001,), torch.float32), ((64, 130), torch.float32),
                         ((3, 333), torch.bfloat16), ((), torch.float32)):
        x, y, nu = ((torch.randn(shape, generator=g, device="cuda") * 0.01)
                    .to(dtype) for _ in range(3))
        out = tk.prox_cuda(x, kind=kind, **hp)
        ref = tk.prox_plain(x, kind=kind, **hp)
        assert out.shape == x.shape and out.dtype == dtype
        torch.testing.assert_close(out, ref, **TOL)
        for a, b in zip(tk.fused_update_cuda(x, y, nu, kind=kind, gamma=0.8,
                                             **hp),
                        tk.fused_update_plain(x, y, nu, kind=kind, gamma=0.8,
                                              **hp)):
            torch.testing.assert_close(a, b, **TOL)
    torch.cuda.synchronize()
    assert tk.LAUNCH_COUNTS["prox"] == before.get("prox", 0) + 4
    assert tk.LAUNCH_COUNTS["fused_update"] == before.get("fused_update", 0) + 4


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_matches_plain_version(D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(D)
    fk.reset_launch_counts()
    cases = 0
    for B, Lq, Lk, H, KV in ((2, 17, 17, 4, 2), (1, 200, 200, 8, 1),
                             (1, 40, 17, 4, 4), (1, 1, 1, 2, 2)):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q = torch.randn((B, Lq, H, D), generator=g, device="cuda").to(dtype)
            k, v = (torch.randn((B, Lk, KV, D), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                out = fk.flash_attention(q, k, v, causal=causal, window=window)
                ref = fk.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
                torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
                cases += 1
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS["flash_fwd"] == cases


@pytest.mark.gpu
def test_reduced_server_on_the_card_matches_the_cpu():
    """Greedy tokens of reduced starcoder2 (window 64, prompt 80, ring cache)
    on the card equal the CPU's; prefill logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config("starcoder2-7b", reduced=True)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)))
    toks, logits = {}, {}
    fk.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device="cpu")
        params, _ = model.init(seed=0)
        model = build_model(cfg, device=dev)
        srv = BatchedServer(model, params.to(dev), ServeConfig(
            max_new_tokens=6, cache_capacity=64))
        toks[dev] = srv.generate(prompts).cpu()
        with torch.inference_mode():
            logits[dev] = srv.prefill(prompts.to(dev))[0].cpu()
    assert fk.LAUNCH_COUNTS["flash_fwd"] == 2 * cfg.n_layers
    assert torch.equal(toks["cpu"], toks["cuda"])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)
