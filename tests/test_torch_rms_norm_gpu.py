"""The RMSNorm kernel pair against its plain version, on the card.

Marked ``gpu``; each test skips without a CUDA card.  This file imports
neither JAX nor the reference::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_rms_norm_gpu.py

Tolerances: the kernels compute in fp32 as the plain path does, summing
each row in another order, so the bf16 forward is within one ulp of the
plain forward on the card (one rounding of nearly the same fp32 value),
fp32 within 1e-5 relative; the backward (dx and dw, both rounded once to
bf16) within ``BWD_REL`` relative L2 of the fp32 plain pair (bf16's
rounding is 2^-9 relative), fp32 within 1e-5 of the largest value; dw is
summed in a fixed order, so two runs give the same bits.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

BWD_REL = 3e-3
FP32_REL = 1e-5
#: the cells' rows x d (qwen's ln and head rows at B 2 x L 2048, 16 / 8
#: heads; the same at L 4096; DeepSeek's latent c, 512 of 576 columns)
CELL_SHAPES = [(4096, 2048, None), (65536, 128, None), (32768, 128, None),
               (8192, 2048, None), (8192, 512, 576)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _ulps(a, b):
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max())


def _inputs(rows, d, dtype, stride=None, offset=0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn(rows, (stride or d) + offset, generator=g,
                       device="cuda") * 2
    x = base.to(dtype)[:, offset:offset + d]
    w = (torch.randn(d, generator=g, device="cuda") * 0.1).to(dtype)
    dy = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    return x, w, dy


def _hold(x, w, dy, dtype):
    """The pair on (x, w, dy) against the plain pair: the forward against
    the plain forward in the same dtype, the backward against the fp32
    plain backward; dw the same bits twice."""
    from repro_torch.kernels.rms_norm import kernel as K
    from repro_torch.kernels.rms_norm import ref
    from repro_torch.models.common import rms_norm_plain

    y = K.rms_norm_fwd_cuda(x, w)
    dx, dw = K.rms_norm_bwd_cuda(x, w, dy)
    dx2, dw2 = K.rms_norm_bwd_cuda(x, w, dy)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    assert dx.dtype == dtype and dw.dtype == w.dtype
    plain = rms_norm_plain(x, w)
    rdx, rdw = ref.rms_norm_bwd_ref(x.float(), w.float(), dy.float())
    if dtype == torch.bfloat16:
        assert _ulps(y, plain) <= 1
        assert _rel(dx, rdx) < BWD_REL and _rel(dw, rdw) < BWD_REL
    else:
        torch.testing.assert_close(y, plain, rtol=FP32_REL, atol=FP32_REL)
        for got, want in ((dx, rdx), (dw, rdw)):
            err = float((got - want).abs().max() / want.abs().max())
            assert err < FP32_REL, err
    assert torch.equal(dw.view(torch.int16 if dw.dtype == torch.bfloat16
                               else torch.int32),
                       dw2.view(torch.int16 if dw.dtype == torch.bfloat16
                                else torch.int32))
    assert torch.equal(dx, dx2)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,stride", CELL_SHAPES)
def test_kernels_at_the_cells_shapes(rows, d, stride):
    _card()
    x, w, dy = _inputs(rows, d, torch.bfloat16, stride, seed=rows + d)
    _hold(x, w, dy, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [
    (37, 127, 0), (1001, 2047, 0), (3, 3, 0), (4097, 2048, 0),
    (9, 512, 0), (257, 64, 1), (33, 6144, 0), (5, 8192, 0)])
def test_kernels_at_odd_rows_widths_and_views(rows, d, offset, dtype):
    """Odd d and views one element into their row take the element route,
    the rest the vector route; odd row counts leave a ragged last group."""
    _card()
    x, w, dy = _inputs(rows, d, dtype, offset=offset, seed=rows)
    _hold(x, w, dy, dtype)


@pytest.mark.gpu
def test_strided_rows_are_read_in_place():
    """The latent c (512 of 576 columns) gives the bits of its contiguous
    copy, and the wrapper makes no copy of it."""
    _card()
    from repro_torch.kernels.rms_norm import kernel as K

    x, w, dy = _inputs(8192, 512, torch.bfloat16, stride=576, seed=1)
    assert K.row_layout(x) == (8192, 576)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = K.rms_norm_fwd_cuda(x, w)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before == y.numel() * 2
    assert torch.equal(y, K.rms_norm_fwd_cuda(x.contiguous(), w))
    for a, b in zip(K.rms_norm_bwd_cuda(x, w, dy),
                    K.rms_norm_bwd_cuda(x.contiguous(), w, dy)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_models_rms_norm_runs_the_pair_under_autograd():
    """``models/common.py::rms_norm`` on a CUDA tensor: one forward and one
    backward launch, the gradients the kernels' own; a bf16 x with an fp32
    w; under ``inference_mode`` the forward alone."""
    _card()
    from repro_torch.kernels.rms_norm import kernel as K
    from repro_torch.models import common

    x, w, dy = _inputs(300, 2048, torch.bfloat16, seed=7)
    w = w.float()
    K.reset_launch_counts()
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = common.rms_norm(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    assert dict(K.LAUNCH_COUNTS) == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}
    kdx, kdw = K.rms_norm_bwd_cuda(x, w, dy)
    assert torch.equal(dx, kdx) and torch.equal(dw, kdw)
    assert dw.dtype == torch.float32
    with torch.inference_mode():
        assert torch.equal(common.rms_norm(x, w), y.detach())
    assert K.LAUNCH_COUNTS["rms_norm_fwd"] == 2


CLIENTS = 2


def _client_step_counts(arch, cfg, monkeypatch):
    """``LAUNCH_COUNTS`` of one step of ``CLIENTS`` clients' gradients."""
    from repro_torch.kernels.rms_norm import kernel as K
    from repro_torch.launch import train

    monkeypatch.setattr(train, "get_config", lambda *a, **kw: cfg)
    args = train.parse_args(["--arch", arch, "--reduced", "--clients",
                             str(CLIENTS), "--batch", "2", "--seq", "128",
                             "--t0", "1", "--seed", "3"])
    trainer, _, state, it = train.build(args)
    batch = {k: v[0] for k, v in next(it).items()}
    K.reset_launch_counts()
    g, _ = trainer._grad_fn(state.x, batch)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    return dict(K.LAUNCH_COUNTS)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,norms", [("qwen3-1.7b", 4),
                                        ("deepseek-v2-lite", 3)])
def test_launches_in_a_client_step(arch, norms, monkeypatch):
    """A bf16 client-step at 2 layers under remat "full": each layer norm
    forward twice (forward and recompute) and backward once, the final
    norm once each: (2 N + 1) forwards and (N + 1) backwards a client,
    N = 2 x the layer's norms (qwen: ln1, ln2, q_norm, k_norm; DeepSeek:
    ln1, ln2, kv_norm)."""
    _card()
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=2,
                              dtype="bfloat16", remat=True,
                              remat_policy="full")
    if arch == "deepseek-v2-lite":
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=2,
                                  head_dim=192, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64, v_head_dim=128)
    n = 2 * norms
    assert _client_step_counts(arch, cfg, monkeypatch) == {
        "rms_norm_fwd": CLIENTS * (2 * n + 1),
        "rms_norm_bwd": CLIENTS * (n + 1)}
