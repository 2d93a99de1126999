"""The RMSNorm kernel pair's CPU side (``kernels/rms_norm``).

The kernels run only on the card (``tests/test_torch_rms_norm_gpu.py``).
Here: a CPU tensor's ``rms_norm`` is ``rms_norm_plain`` bit for bit; the
plain backward of ``ref.py`` against autograd through it (fp32 within
1e-6 relative L2: the same fp32 math in another order; bf16 within one
ulp: both round once from fp32), strided rows included; the launch
shapes (``plan``, forward and backward apart; ``row_layout``; the vector
rule) and a Python model of the kernels' row walk and fixed-order dw
reduction; that a CPU tensor never builds or loads the library; and that
no model the sweep engine vmaps reaches ``rms_norm``, so the
``autograd.Function`` needs no vmap rule.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rms_norm import kernel as K
from repro_torch.kernels.rms_norm import ref
from repro_torch.models import common

FP32_REL = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _ulps(a, b):
    """Largest distance of two bf16 tensors in units in the last place."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((line(a) - line(b)).abs().max())


def _inputs(rows, d, dtype, stride=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(rows, stride or d, generator=g) * 2
    x = base.to(dtype)[:, :d]
    w = (torch.randn(d, generator=g) * 0.1).to(dtype)
    dy = torch.randn(rows, d, generator=g).to(dtype)
    return x, w, dy


CASES = [(128, None), (512, None), (2048, None), (512, 576)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,stride", CASES)
def test_cpu_rms_norm_is_the_plain_path(d, stride, dtype):
    x, w, _ = _inputs(33, d, dtype, stride)
    assert torch.equal(common.rms_norm(x, w), common.rms_norm_plain(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,stride", CASES)
def test_ref_backward_matches_autograd_of_plain(d, stride, dtype):
    x, w, dy = _inputs(64, d, dtype, stride, seed=d)
    if stride:
        assert x.stride() == (stride, 1)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    dx, dw = torch.autograd.grad(common.rms_norm(xg, wg), (xg, wg), dy)
    rdx, rdw = ref.rms_norm_bwd_ref(x, w, dy)
    assert (rdx.dtype, rdw.dtype, rdx.shape) == (dtype, dtype, x.shape)
    if dtype == torch.float32:
        assert _rel(rdx, dx) < FP32_REL and _rel(rdw, dw) < FP32_REL
    else:
        assert _ulps(rdx, dx) <= 1 and _ulps(rdw, dw) <= 1


@pytest.mark.parametrize("d,dtype,vec,bwd,tpr", [
    (128, torch.bfloat16, True, True, 8),
    (512, torch.bfloat16, True, True, 32),
    (2048, torch.bfloat16, True, True, 128),
    (64, torch.bfloat16, True, True, 4),
    (6144, torch.bfloat16, True, True, 512),
    (2048, torch.float32, True, True, 256),
    (127, torch.bfloat16, False, True, 8),
    (2047, torch.float32, False, True, 128),
    (1, torch.float32, False, True, 4),
    (8192, torch.bfloat16, True, True, 512),
    (6144, torch.float32, False, True, 512),
    (128, torch.bfloat16, True, False, 4),
    (512, torch.bfloat16, True, False, 16),
    (2048, torch.bfloat16, True, False, 64),
    (64, torch.bfloat16, True, False, 4),
    (6144, torch.bfloat16, True, False, 256),
    (6144, torch.float32, True, False, 512),
    (8192, torch.float32, True, False, 512),
    (127, torch.bfloat16, False, False, 8)])
def test_plan_holds_a_row_in_the_fewest_threads(d, dtype, vec, bwd, tpr):
    p = K.plan(d, dtype, vec, bwd)
    assert p.vec == vec
    assert p.tpr == tpr and p.chunk == (K.VEC[dtype] if vec else 1)
    chunks, most = d // p.chunk, K.MAX_CHUNKS[vec, bwd]
    # every chunk has one (lane, k) with k < MAX_CHUNKS; half the threads
    # would not do (or the floor of 4 holds)
    owners = sorted(lane + k * p.tpr for lane in range(p.tpr)
                    for k in range(most) if lane + k * p.tpr < chunks)
    assert owners == list(range(chunks))
    assert p.tpr == 4 or (p.tpr // 2) * most < chunks
    # the source's shape rule (shape_ok): a block's threads a multiple of
    # tpr
    assert K.FWD_THREADS % p.tpr == 0 and K.BWD_THREADS % p.tpr == 0


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("d,dtype,vec", [
    (8200, torch.bfloat16, True), (8196, torch.float32, True),
    (8193, torch.bfloat16, False), (12, torch.bfloat16, True)])
def test_plan_refuses_rows_the_kernels_do_not_take(d, dtype, vec, bwd):
    """Past ``MAX_D`` in both directions, though the forward's vectors
    would hold a bf16 row of 16,384: a forward never runs where its
    backward would raise."""
    with pytest.raises(ValueError, match="rms_norm"):
        K.plan(d, dtype, vec, bwd)


def test_plan_sends_rows_too_wide_for_vectors_to_the_element_route():
    fp32 = torch.float32
    assert K.plan(6144, fp32, True, True) == K.plan(6144, fp32, False, True)
    assert K.plan(4096, fp32, True, True).vec
    assert K.plan(6144, fp32, True, False).vec


def test_row_layout_and_vector_rule():
    c = torch.empty(2, 7, 576)[..., :512]          # latent c of a split
    assert K.row_layout(c) == (14, 576)
    assert K.row_layout(torch.empty(5, 1, 3, 8)) == (15, 8)
    assert K.row_layout(torch.empty(8)) == (1, 8)
    assert K.row_layout(torch.empty(4, 8).t()) is None
    assert K.row_layout(torch.empty(4, 6, 8).transpose(0, 1)) is None
    assert K.row_layout(torch.empty(3, 8)[:, None].expand(3, 5, 8)) is None
    bf = torch.bfloat16
    assert K._whole_vectors(512, bf, (576,), (0, 16))
    assert not K._whole_vectors(512, bf, (577,), (0, 16))
    assert not K._whole_vectors(513, bf, (513,), (0, 16))
    assert not K._whole_vectors(512, bf, (576,), (0, 2))
    assert K._whole_vectors(12, torch.float32, (12,), (32, 48))


def _walk_model(x, w, dy, p, blocks, threads):
    """The backward kernel's walk in Python: block b takes row groups
    base = b G + i blocks G, its group g row base + g; each block's rows'
    dy xh summed per group, the groups in order, then the partial rows in
    order.  Returns (rows visited, dw)."""
    rows, d = x.shape
    G = threads // p.tpr
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    contrib = dy32 * (x32 * r)
    seen, partial = [], torch.zeros(blocks, d)
    for b in range(blocks):
        acc = torch.zeros(G, d)
        for base in range(b * G, rows, blocks * G):
            for g in range(G):
                if base + g < rows:
                    seen.append(base + g)
                    acc[g] += contrib[base + g]
        t = acc[0].clone()
        for g in range(1, G):
            t += acc[g]
        partial[b] = t
    dw = partial[0].clone()
    for b in range(1, blocks):
        dw += partial[b]
    return sorted(seen), dw.to(w.dtype)


@pytest.mark.parametrize("rows,d,blocks,vec", [
    (37, 128, 3, True), (300, 512, 5, True), (9, 2048, 4, True),
    (1, 64, 1, True), (301, 127, 2, False)])
def test_walk_visits_every_row_once_and_sums_dw(rows, d, blocks, vec):
    x, w, dy = _inputs(rows, d, torch.float32, seed=rows)
    p = K.plan(d, x.dtype, vec, True)
    seen, dw = _walk_model(x, w, dy, p, blocks, K.BWD_THREADS)
    assert seen == list(range(rows))
    _, rdw = ref.rms_norm_bwd_ref(x, w, dy)
    assert _rel(dw, rdw) < FP32_REL


def test_cpu_tensor_never_loads_the_library(monkeypatch):
    """A reduced qwen3 loss and its gradients on the CPU go through the
    plain path: nothing is built, loaded or counted."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    def refuse(*a, **kw):
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(_build, "build_library", refuse)
    monkeypatch.setattr(K, "build_library", refuse)
    monkeypatch.setattr(K, "_lib", refuse)
    monkeypatch.setattr(K, "rms_norm_cuda", refuse)
    monkeypatch.setattr(common, "rms_norm_cuda", refuse)
    K.reset_launch_counts()
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = build_model(cfg, device="cpu")
    net, _ = model.init(seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(0))
    loss, _ = model.loss(net, {"tokens": tokens[:, :-1],
                               "labels": tokens[:, 1:]})
    loss.backward()
    assert not K.LAUNCH_COUNTS
    with pytest.raises(ValueError, match="not CUDA"):
        K.rms_norm_fwd_cuda(torch.ones(2, 8), torch.zeros(8))


def test_sweep_engine_vmaps_no_model_that_normalises(monkeypatch):
    """Every grid the figures run through the sweep engine (the paper's
    linear, MLP and least-squares models): no call of ``rms_norm`` inside
    the engine's ``vmap``, so the kernels' ``autograd.Function`` never
    meets a vmap transform."""
    from repro_torch import figures
    from repro_torch.models import (attention, encdec, hybrid, mamba2, ssm,
                                    transformer)
    from repro_torch.training import sweep

    depth, vmapped, normed = [0], [0], []

    def counting_vmap(fn, *a, **kw):
        mapped = torch.func.vmap(fn, *a, **kw)

        def run(*args, **kwargs):
            depth[0] += 1
            vmapped[0] += 1
            try:
                return mapped(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    plain = common.rms_norm

    def watched(x, weight, eps=1e-6):
        if depth[0]:
            normed.append(tuple(x.shape))
        return plain(x, weight, eps)

    monkeypatch.setattr(sweep, "vmap", counting_vmap)
    for mod in (common, attention, encdec, hybrid, mamba2, ssm, transformer):
        monkeypatch.setattr(mod, "rms_norm", watched)
    for name in ("3", "4", "6", "8", "comm", "table3", "async"):
        run, _, _ = figures.FIGURES[name]
        run(2, False, "cpu", "auto")
    assert vmapped[0] > 0 and not normed
