"""Flash attention whose value head differs from its query/key head
(multi-head latent attention's 192 / 128), on the CPU: the plain forward,
its row logsumexp and the plain backward against float64 einsums and
autograd, with the default and an explicit softmax scale; the training
route through them; the kernels' (D, DV) instantiations read from the
sources; and ``_sdpa``'s scale, now a Python float, bit for bit the
reference's ``jnp.sqrt(hd)`` for every head dim the zoo uses."""
from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.models import attention

PAIRS = [(24, 16), (192, 128)]
#: fp32 against float64: the plain versions' rounding alone
REL = 2e-6


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(B, Lq, Lk, H, KV, D, DV, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Lq, H, D, generator=g),
            torch.randn(B, Lk, KV, D, generator=g),
            torch.randn(B, Lk, KV, DV, generator=g))


def _einsum_attention(q, k, v, causal, window, scale):
    """float64 attention, GQA by repeating the kv heads; rows with no
    visible key 0."""
    q, k, v = (t.double() for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    mask = fk._visible(q.shape[1], k.shape[1], causal, window, q.device)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.nan_to_num(torch.softmax(s, -1), nan=0.0)
    return torch.einsum("bhij,bjhd->bihd", p, v), torch.logsumexp(s, -1)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("D,DV", PAIRS)
@pytest.mark.parametrize("B,Lq,Lk,H,KV,causal,window", [
    (2, 40, 40, 4, 4, True, 0), (1, 33, 33, 4, 2, True, 9),
    (2, 17, 29, 2, 1, False, 0)])
@pytest.mark.parametrize("scale", [None, 0.11472138679292612])
def test_plain_forward_and_lse(B, Lq, Lk, H, KV, D, DV, causal, window, scale):
    q, k, v = _qkv(B, Lq, Lk, H, KV, D, DV)
    out, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        scale=scale, return_lse=True)
    want, wlse = _einsum_attention(q, k, v, causal, window,
                                   1 / math.sqrt(D) if scale is None else scale)
    assert out.shape == (B, Lq, H, DV)
    assert _rel(out, want) < REL
    assert torch.allclose(lse.double(), wlse, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("D,DV", PAIRS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_plain_backward_against_autograd(D, DV, causal, window):
    B, L, H, KV = 2, 23, 4, 2
    scale = 0.3
    q, k, v = _qkv(B, L, L, H, KV, D, DV, seed=1)
    do = torch.randn(B, L, H, DV, generator=torch.Generator().manual_seed(2))
    o, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale, return_lse=True)
    got = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want, _ = _einsum_attention(*leaves, causal, window, scale)
    ref = torch.autograd.grad(want, leaves, do.double())
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < 1e-5


@pytest.mark.parametrize("D,DV", PAIRS)
def test_training_route_on_the_cpu(D, DV):
    """``flash_attention_train`` with a scale: the plain pair, as autograd
    through the float64 einsum has it."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 19, 19, 4, 4, D, DV, seed=3))
    out = fk.flash_attention_train(q, k, v, causal=True, scale=0.2)
    g = torch.autograd.grad(out.square().sum(), (q, k, v))
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    want, _ = _einsum_attention(*leaves, True, 0, 0.2)
    r = torch.autograd.grad(want.square().sum(), leaves)
    assert _rel(out, want) < REL
    for a, b in zip(g, r):
        assert _rel(a, b) < 1e-5


def test_the_kernels_instantiate_the_dv_pairs():
    """Each bf16 source launches every ``TRAIN_DV_PAIRS`` pair by name,
    and neither takes a differing DV at any other pair."""
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        text = fk.SOURCES[name].read_text()
        got = {(int(a), int(b)) for a, b in re.findall(
            r"return launch_dv<(\d+), (\d+)>", text)}
        assert got == set(fk.TRAIN_DV_PAIRS), name
    assert all(d in (192,) and dv in fk.TRAIN_HEAD_DIMS
               for d, dv in fk.TRAIN_DV_PAIRS)
    assert not fk.trains_on_kernel(torch.zeros(1, 1, 1, 192),
                                   torch.zeros(1, 1, 1, 128))


def _zoo_head_dims():
    dims = set()
    for arch in list_archs():
        for reduced in (False, True):
            dims.add(get_config(arch, reduced).hd)
    return sorted(dims)


@pytest.mark.parametrize("hd", _zoo_head_dims())
def test_sdpa_scale_is_the_references_bit_for_bit(hd):
    """``_sdpa`` divides by ``math.sqrt(hd)``, a Python float: as fp32 it
    is the reference's ``jnp.sqrt(hd).astype(float32)``, and the scores it
    gives equal the former ``torch.sqrt(torch.tensor(hd))`` divisor's."""
    assert np.float32(math.sqrt(hd)) == np.asarray(
        jnp.sqrt(hd).astype(jnp.float32))
    q, k, v = _qkv(2, 9, 9, 4, 2, hd, hd, seed=hd)
    mask = attention.causal_mask(9)[None]
    cfg = get_config("qwen3-1.7b", reduced=True)
    got = attention._sdpa(q, k, v, mask, cfg)
    qg = q.reshape(2, 9, 2, 2, hd)
    s = torch.einsum("blkgh,bskh->bklgs", qg, k).float()
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    s = torch.where(mask[:, None, :, None, :], s, attention.NEG_INF)
    want = torch.einsum("bklgs,bskh->blkgh", torch.softmax(s, -1), v)
    assert torch.equal(got, want.reshape(2, 9, 4, hd))
