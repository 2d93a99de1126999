"""Port parity: the flash-attention kernel's plain version and dispatcher.

On the CPU ``flash_attention`` runs ``flash_attention_plain``; it is held
against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it, on the same shapes and masks) and against
``attention_ref``.  Tolerances: fp32 atol = rtol = 2e-5 (blockwise online
softmax vs one softmax: the sums run in another order), bf16 3e-2 (the ref
rounds the normalised probabilities to bf16 before P V, the bf16 CUDA
kernel its un-normalised ones, the plain version and the fp32 kernel
neither).  Ragged lengths and ``Lq != Lk``, which the Pallas wrapper's
divisibility assert refuses, are held against ``attention_ref`` only.  The
CUDA kernels themselves are held to the plain version by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` on the card;
``_sm90_model`` below repeats the bf16 kernel's arithmetic on the CPU, so
that its rounding is held to the reference here as well; ``fp32_schedule``
and ``_fp32_model`` repeat the fp32 kernel's tile schedule and masks, held
against a brute-force mask and the plain version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import attention_ref as t_ref

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, B, Lq, H, KV, D, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = Lq if Lk is None else Lk
    return (rng.standard_normal((B, Lq, H, D)).astype(np.float32),
            rng.standard_normal((B, Lk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Lk, KV, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,L,H,KV,D", [
    (2, 256, 4, 2, 128), (1, 384, 6, 1, 128), (2, 256, 8, 8, 256),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_plain_matches_pallas_and_ref(B, L, H, KV, D, causal, window):
    q, k, v = _qkv(L + H + D, B, L, H, KV, D)
    out = fk.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert out.shape == (B, L, H, D) and out.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = j_flash(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j_ref(jq, jk, jv, causal=causal,
                                      window=window)), **F32)


def test_plain_bf16_matches_pallas_and_ref():
    q, k, v = _qkv(3, 1, 256, 4, 2, 128)
    tq, tk_, tv = _t(q, k, v, dtype=torch.bfloat16)
    out = fk.flash_attention(tq, tk_, tv, causal=True)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (j_flash(jq, jk, jv, causal=True),
                 j_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,window", [
    (2, 17, 17, 4, 2, 64, True, 0),
    (1, 200, 200, 4, 1, 128, True, 0),
    (1, 200, 200, 8, 2, 64, True, 64),
    (2, 17, 17, 2, 2, 256, False, 0),
    (1, 17, 40, 4, 2, 64, False, 0),
    (1, 17, 40, 4, 2, 64, True, 0),
    (1, 40, 17, 4, 4, 64, True, 0),
    (1, 1, 1, 4, 2, 128, True, 0),
    # cross-attention: decode (Lq 1) and a prompt (Lq 16) against a
    # longer, ragged memory
    (2, 1, 1000, 4, 4, 64, False, 0),
    (2, 16, 1000, 4, 2, 64, False, 0),
])
def test_ragged_lengths_match_ref(B, Lq, Lk, H, KV, D, causal, window):
    q, k, v = _qkv(Lq * 7 + Lk, B, Lq, H, KV, D, Lk)
    out = fk.flash_attention(*_t(q, k, v), causal=causal, window=window)
    want = t_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32)
    jwant = j_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                  window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jwant), **F32)


def test_rows_with_no_visible_key_are_zero_as_in_the_pallas_kernel():
    """causal, window 64, Lq 256 > Lk 128 + 63: rows 191.. see no key.
    The kernels' guards give 0 there (the ref would average V)."""
    q, k, v = _qkv(9, 1, 256, 2, 1, 128, Lk=128)
    out = fk.flash_attention(*_t(q, k, v), causal=True, window=64)
    pallas = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                     window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **F32)
    assert torch.count_nonzero(out[:, 191:]) == 0
    assert torch.count_nonzero(out[:, :191]) > 0
    ref = t_ref(*_t(q, k, v), causal=True, window=64)
    np.testing.assert_allclose(out[:, :191].numpy(), ref[:, :191].numpy(),
                               **F32)


def _sm90_model(q, k, v, *, causal, window, block_k=128):
    """The arithmetic of ``csrc/flash_fwd_sm90.cu`` in fp32 on the CPU.

    Per tile of ``block_k`` keys: scores in fp32, masked scores -inf, the
    running max m, p = exp2(s scale log2(e) - m) un-normalised and rounded
    to bf16 before P V (l sums the unrounded p), the fp32 accumulator
    rescaled by alpha = exp2(m_old - m_new) (0 while m is -inf), and
    acc / max(l, 1e-30) at the end, rounded to bf16.
    """
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    sl = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qg = q.float().reshape(B, Lq, KV, H // KV, D)
    m = torch.full((B, KV, H // KV, Lq), -math.inf)
    l = torch.zeros((B, KV, H // KV, Lq))
    acc = torch.zeros((B, KV, H // KV, Lq, D))
    rows = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, block_k):
        kt, vt = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bikgd,bjkd->bkgij", qg, kt)
        cols = k0 + torch.arange(kt.shape[1])[None, :]
        ok = torch.ones((Lq, kt.shape[1]), dtype=torch.bool)
        if causal:
            ok = ok & (cols <= rows)
            if window > 0:
                ok = ok & (cols > rows - window)
        s = torch.where(ok, s, -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx * sl)
        alpha = torch.exp2(m * sl - mu)
        p = torch.exp2(s * sl - mu[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgij,bjkd->bkgid",
                          p.to(torch.bfloat16).float(), vt)
        acc = acc * alpha[..., None] + pv
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, D).to(torch.bfloat16)


@pytest.mark.parametrize("L", [128, 1000])
@pytest.mark.parametrize("window", [0, 96])
def test_sm90_rounding_model_matches_pallas_and_ref(L, window):
    """Rounding P to bf16 per key tile, as the bf16 CUDA kernel does, keeps
    the result within the bf16 tolerance the card holds the kernel to."""
    q, k, v = _qkv(L + window, 1, L, 4, 2, 128)
    tq, tk_, tv = _t(q, k, v, dtype=torch.bfloat16)
    out = _sm90_model(tq, tk_, tv, causal=True, window=window)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    block = 128 if L % 128 == 0 else 200
    for want in (j_flash(jq, jk, jv, causal=True, window=window,
                         block_q=block, block_k=block),
                 j_ref(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)
    np.testing.assert_allclose(
        out.float().numpy(),
        fk.flash_attention_plain(tq, tk_, tv, causal=True, window=window)
        .float().numpy(), **BF16)


# zamba2's D 80 and phi-3's D 96, which the bf16 kernel runs at their true
# width: causal, windowed, non-causal; GQA groups 1 and 4; Lq != Lk both
# ways (no row without a visible key: there the ref averages V)
NATIVE_80_96_CASES = [
    (2, 17, 17, 4, 4, True, 0), (1, 200, 200, 8, 2, True, 0),
    (1, 200, 200, 4, 1, True, 64), (2, 17, 40, 4, 1, True, 0),
    (1, 40, 17, 4, 4, False, 0), (2, 16, 300, 8, 2, False, 0),
]


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("B,Lq,Lk,H,KV,causal,window", NATIVE_80_96_CASES)
def test_plain_at_head_dims_80_96_matches_the_reference(B, Lq, Lk, H, KV,
                                                        causal, window, D):
    """``flash_attention_plain`` at D 80 / 96 (the card holds the bf16
    kernel to it there) against the reference's ``attention_ref`` on the
    same numpy inputs, fp32, within 1e-5: one softmax each, the sums in
    another order."""
    q, k, v = _qkv(D * 31 + Lq * 7 + Lk, B, Lq, H, KV, D, Lk)
    out = fk.flash_attention_plain(*_t(q, k, v), causal=causal,
                                   window=window)
    want = j_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                 window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("window", [0, 64])
def test_sm90_rounding_model_at_head_dims_80_96(D, window):
    """The bf16 kernel's arithmetic at D 80 / 96 (P rounded to bf16 per key
    tile) stays within the bf16 tolerance of the reference's
    ``attention_ref`` and of the plain version, as at D 128."""
    q, k, v = _qkv(D + window, 1, 300, 4, 2, D)
    tq, tk_, tv = _t(q, k, v, dtype=torch.bfloat16)
    out = _sm90_model(tq, tk_, tv, causal=True, window=window)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(j_ref(jq, jk, jv, causal=True, window=window),
                   np.float32), **BF16)
    np.testing.assert_allclose(
        out.float().numpy(),
        fk.flash_attention_plain(tq, tk_, tv, causal=True, window=window)
        .float().numpy(), **BF16)


@pytest.mark.parametrize("source,dtype", [
    ("flash_fwd_sm90", torch.bfloat16), ("flash_fwd", torch.float32)])
def test_kernel_switch_cases_equal_the_wrappers_head_dims(source, dtype):
    """The head dims each CUDA source's C switch instantiates, read from its
    text, are the wrapper's ``HEAD_DIMS`` of that source's dtype: a D the
    wrapper launches natively is one the kernel has a case for, and no
    instantiated D takes the head-dim route."""
    import re
    text = fk.SOURCES[source].read_text()
    cases = [int(d) for d, t in re.findall(
        r"case (\d+): return launch<(\d+)>", text) if d == t]
    assert len(cases) == len(re.findall(r"case \d+:", text))
    assert tuple(cases) == fk.HEAD_DIMS[dtype]
    assert {fk.padded_head_dim(d, dtype) for d in cases} == set(cases)


def test_ref_matches_the_reference_oracle():
    q, k, v = _qkv(4, 2, 48, 4, 2, 64)
    for causal, window in ((True, 0), (True, 16), (False, 0)):
        np.testing.assert_allclose(
            t_ref(*_t(q, k, v), causal=causal, window=window).numpy(),
            np.asarray(j_ref(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, window=window)), **F32)


def test_dispatch_and_checks():
    q, k, v = _t(*_qkv(5, 1, 8, 4, 2, 64))
    fk.reset_launch_counts()
    fk.flash_attention(q, k, v)
    fk.flash_attention(*(t.bfloat16() for t in (q, k, v)))
    # the plain path never counts
    assert fk.LAUNCH_COUNTS["flash_fwd"] == 0
    assert fk.LAUNCH_COUNTS["flash_fwd_sm90"] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        fk.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="not a CUDA device"):
        fk.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="group"):
        fk.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="B, Lk, KV, D"):
        fk.flash_attention(q, k, v[:, :4])
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_attention(q.double(), k.double(), v.double())


# the fp32 kernel's tiles (csrc/flash_fwd.cu) for each head dim: query
# rows a CTA, and keys a K/V tile
FP32_BQ = {64: 128, 128: 128, 256: 64}
FP32_BK = {64: 64, 128: 64, 256: 32}


def fp32_schedule(Lq: int, Lk: int, D: int, *, causal: bool = True,
                  window: int = 0) -> list[tuple[int, int, int, set]]:
    """The fp32 kernel's schedule of one (batch, head), as the card runs it.

    One ``(qt, kt_begin, kt_end, masked)`` a query tile of ``FP32_BQ[D]``
    rows,
    in launch order (the grid takes the last, heaviest tile first): the
    K/V tiles ``[kt_begin, kt_end)`` of ``FP32_BK[D]`` keys it walks (those
    that meet the causal / window band) and the set of them it masks
    element by element (they cross the diagonal, the window's edge or the
    end of the keys).  A model of ``flash_fwd.cu``, which computes the same bounds on the card.
    """
    BQ, BK = FP32_BQ[D], FP32_BK[D]
    nq, nk = -(-Lq // BQ), -(-Lk // BK)
    plan = []
    for qt in reversed(range(nq)):
        q0, begin, end = qt * BQ, 0, nk
        if causal:
            end = min(nk, (min(q0 + BQ, Lq) - 1) // BK + 1)
            if window > 0 and q0 - window + 1 > 0:
                begin = (q0 - window + 1) // BK
        masked = {kt for kt in range(begin, end)
                  if kt * BK + BK > Lk or (causal and (
                      kt * BK + BK - 1 > q0
                      or (window > 0 and kt * BK <= q0 + BQ - 1 - window)))}
        plan.append((qt, begin, end, masked))
    return plan


# (Lq, Lk, D, causal, window): tile edges, ragged ends, Lq != Lk both ways,
# windows narrower and wider than a tile, rows with no visible key
SCHEDULE_CASES = [(1, 1, 64, True, 0), (65, 65, 64, True, 0),
                  (200, 200, 128, True, 64), (40, 17, 128, True, 0),
                  (17, 200, 256, True, 0), (256, 64, 64, True, 64),
                  (130, 70, 256, False, 0), (300, 300, 256, True, 100),
                  (129, 129, 128, True, 4096), (191, 250, 64, True, 31),
                  (1, 1000, 64, False, 0), (16, 1000, 64, False, 0)]


def _visible(Lq, Lk, causal, window):
    i = np.arange(Lq)[:, None]
    j = np.arange(Lk)[None, :]
    vis = np.ones((Lq, Lk), bool)
    if causal:
        vis &= j <= i
        if window > 0:
            vis &= j > i - window
    return vis


@pytest.mark.parametrize("Lq,Lk,D,causal,window", SCHEDULE_CASES)
def test_fp32_schedule_against_a_brute_force_mask(Lq, Lk, D, causal, window):
    """Every query tile once, heaviest first when causal; its key tiles
    hold every visible key of its rows; an unmasked tile has only visible
    keys of real rows (a row past Lq is never written)."""
    BQ, BK = FP32_BQ[D], FP32_BK[D]
    vis = _visible(Lq, Lk, causal, window)
    plan = fp32_schedule(Lq, Lk, D, causal=causal, window=window)
    assert [p[0] for p in plan] == list(reversed(range(-(-Lq // BQ))))
    if causal and window == 0:
        work = [p[2] - p[1] for p in plan]
        assert work == sorted(work, reverse=True)
    for qt, begin, end, masked in plan:
        rows = vis[qt * BQ:(qt + 1) * BQ]
        cols = np.nonzero(rows.any(axis=0))[0]
        if len(cols):
            assert begin <= cols[0] // BK and cols[-1] // BK < end
        assert masked <= set(range(begin, end))
        for kt in set(range(begin, end)) - masked:
            assert kt * BK + BK <= Lk
            assert rows[:, kt * BK:(kt + 1) * BK].all()


def _fp32_model(q, k, v, causal, window):
    """The fp32 kernel's walk on the CPU: the tiles of ``fp32_schedule``,
    K/V zero-filled to whole tiles, a mask only on the tiles it names,
    the online softmax tile by tile."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    BQ, BK = FP32_BQ[D], FP32_BK[D]
    pad = -(-Lk // BK) * BK - Lk
    kp, vp = (torch.cat([t, t.new_zeros((B, pad, KV, D))], 1) for t in (k, v))
    qg = q.reshape(B, Lq, KV, H // KV, D)
    out = torch.zeros((B, Lq, KV, H // KV, D))
    vis = torch.from_numpy(_visible(Lq, kp.shape[1], causal, window))
    vis[:, Lk:] = False
    for qt, begin, end, masked in fp32_schedule(Lq, Lk, D, causal=causal,
                                                   window=window):
        rows = slice(qt * BQ, min(qt * BQ + BQ, Lq))
        m = torch.full(qg[:, rows].shape[:-1], fk.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(qg[:, rows].shape)
        for kt in range(begin, end):
            keys = slice(kt * BK, kt * BK + BK)
            s = torch.einsum("bikgd,bjkd->bikgj", qg[:, rows],
                             kp[:, keys]) / math.sqrt(D)
            ok = (vis[rows, keys][None, :, None, None, :] if kt in masked
                  else torch.ones(s.shape, dtype=torch.bool))
            s = torch.where(ok, s, fk.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.where(m == fk.NEG_INF, 0.0, torch.exp(m - m_new))
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum("bikgj,bjkd->bikgd",
                                                        p, vp[:, keys])
            m = m_new
        out[:, rows] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Lq, H, D)


@pytest.mark.parametrize("Lq,Lk,D,causal,window", SCHEDULE_CASES)
def test_fp32_kernel_walk_matches_plain(Lq, Lk, D, causal, window):
    """The kernel's schedule and masks, run on the CPU, give the plain
    version's attention at the fp32 tolerance (rows with no visible key
    come out 0 in both)."""
    q, k, v = _t(*_qkv(Lq + Lk + D, 1, Lq, 4, 2, D, Lk=Lk))
    torch.testing.assert_close(
        _fp32_model(q, k, v, causal, window),
        fk.flash_attention_plain(q, k, v, causal=causal, window=window),
        **F32)


# ---------------------------------------------------------------------------
# Training: the forward's row logsumexp and the backward
# ---------------------------------------------------------------------------

# (B, Lq, Lk, H, KV, D, causal, window): every backward head dim, GQA
# groups 1 / 2 / 4, windows narrower than L, lengths that are no tile
# multiple, Lq != Lk, non-causal, and rows with no visible key (causal,
# Lq > Lk + window - 1)
TRAIN_CASES = [
    (2, 37, 37, 4, 4, 64, True, 0), (1, 70, 70, 4, 2, 80, True, 16),
    (2, 45, 45, 8, 2, 96, True, 0), (1, 130, 130, 4, 1, 128, True, 32),
    (1, 50, 29, 4, 2, 64, True, 8), (2, 33, 47, 2, 1, 128, True, 0),
    (1, 20, 52, 6, 3, 96, False, 0), (1, 61, 61, 2, 2, 80, True, 0),
]


def _dead_rows(Lq, Lk, causal, window):
    """Rows that see no key."""
    return [i for i in range(Lq)
            if not any(j <= i and (window == 0 or j > i - window)
                       for j in range(Lk))] if causal else []


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,window", TRAIN_CASES)
def test_plain_backward_matches_autograd(B, Lq, Lk, H, KV, D, causal,
                                         window):
    """``flash_attention_bwd_plain`` (from the forward's ``lse``) against
    ``torch.autograd`` through ``flash_attention_plain``, fp32, at atol =
    rtol = 2e-5: the same gradient summed in another order (autograd's
    softmax backward takes rowsum(P dP), the plain backward rowsum(dO o),
    equal in exact arithmetic).  A row with no visible key gets zero
    gradient in both."""
    q, k, v = _t(*_qkv(Lq * 7 + Lk + D, B, Lq, H, KV, D, Lk=Lk))
    do = torch.from_numpy(np.random.default_rng(D + Lq).standard_normal(
        (B, Lq, H, D)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fk.flash_attention_plain(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert torch.equal(o, out.detach())
    got = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32)
    dead = _dead_rows(Lq, Lk, causal, window)
    assert (len(dead) > 0) == ((Lq, Lk, window) == (50, 29, 8))
    if dead:
        assert torch.count_nonzero(got[0][:, dead]) == 0
        assert torch.isinf(lse[..., dead]).all() and (lse[..., dead] > 0).all()


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,window", TRAIN_CASES[::2]
                         + [TRAIN_CASES[4]])
def test_plain_lse_is_the_logsumexp_of_the_scaled_masked_scores(
        B, Lq, Lk, H, KV, D, causal, window):
    """``return_lse``: the same output, and per row ``torch.logsumexp`` of
    the scores times 1 / sqrt(D) over the visible keys (query head h =
    kv * group + g), within 1e-5; +inf where no key is visible (where
    ``torch.logsumexp`` gives -inf)."""
    q, k, v = _t(*_qkv(Lq + 3 * Lk, B, Lq, H, KV, D, Lk=Lk))
    out, lse = fk.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    assert torch.equal(out, fk.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window))
    kk = k.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bihd,bjhd->bhij", q, kk) / math.sqrt(D)
    mask = torch.ones(Lq, Lk, dtype=torch.bool)
    if causal:
        i, j = torch.arange(Lq)[:, None], torch.arange(Lk)[None, :]
        mask = (j <= i) & ((j > i - window) if window else True)
    want = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32
    seen = torch.isfinite(want)
    torch.testing.assert_close(lse[seen], want[seen], atol=1e-5, rtol=1e-5)
    assert torch.equal(lse[~seen], torch.full_like(lse[~seen], math.inf))
    assert bool((~seen).any()) == bool(_dead_rows(Lq, Lk, causal, window))


def test_backward_switch_cases_equal_the_train_head_dims():
    """The head dims ``flash_bwd_sm90.cu``'s C switch instantiates, read
    from its text, are ``TRAIN_HEAD_DIMS``, each a bf16 forward dim."""
    import re
    text = fk.SOURCES["flash_bwd_sm90"].read_text()
    cases = [int(d) for d, t in re.findall(
        r"case (\d+): return launch<(\d+)>", text) if d == t]
    assert len(cases) == len(re.findall(r"case \d+:", text))
    assert tuple(cases) == fk.TRAIN_HEAD_DIMS
    assert set(cases) <= set(fk.HEAD_DIMS[torch.bfloat16])


def test_library_tag_hashes_the_headers_a_source_includes(tmp_path):
    """A library's tag covers its source and the headers beside it that
    the source includes, transitively: the sm90 kernels take
    ``sm90_common.cuh``, the fp32 kernel none; an unrelated header does
    not move a tag."""
    from repro_torch.kernels import _build
    src = fk.SOURCES
    common = src["flash_fwd_sm90"].parent / "sm90_common.cuh"
    for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
        assert list(_build._sources(src[name], {})) == [src[name], common]
    assert list(_build._sources(src["flash_fwd"], {})) == [src["flash_fwd"]]
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cuh").write_text('  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// c\n")
    (tmp_path / "d.cuh").write_text("// not included\n")
    got = _build._sources(tmp_path / "a.cu", {})
    assert [p.name for p in got] == ["a.cu", "b.cuh", "c.cuh"]


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 32)])
def test_attention_train_route_on_the_cpu(dtype, D):
    """On the CPU the chosen route (``use_flash=None``, the default) is
    ``_sdpa``: ``torch.equal`` to ``use_flash=False``, forward and
    gradients, with nothing counted (no dispatch, no launch)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as tattn
    from repro_torch.models.common import Initializer, split_params

    cfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                              head_dim=D, dtype=str(dtype).split(".")[-1])
    params, _ = split_params(tattn.init_attention(
        Initializer(torch.Generator().manual_seed(D), dtype), cfg))
    x = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)).to(dtype)
    tattn.DISPATCH_COUNTS.clear()
    fk.reset_launch_counts()
    got = {}
    for use_flash in (None, False):
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        out = tattn.attention_train(leaves, x, cfg, use_flash=use_flash)
        got[use_flash] = (out, torch.autograd.grad(out.float().sum(),
                                                   list(leaves.values())))
    assert torch.equal(got[None][0], got[False][0])
    for a, b in zip(got[None][1], got[False][1]):
        assert torch.equal(a, b)
    assert not tattn.DISPATCH_COUNTS and not +fk.LAUNCH_COUNTS


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_flash_attention_train_under_remat(policy):
    """``flash_attention_train`` inside ``maybe_checkpoint`` (the
    recompute runs its forward again, ``lse`` included) gives the
    gradients of the same block without remat, bit for bit, on the CPU;
    and those match ``_sdpa``'s at the fp32 tolerance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as tattn
    from repro_torch.models.common import maybe_checkpoint

    base = get_config("qwen3-1.7b", reduced=True)
    H, KV, D = 4, 2, 64
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 48, 32)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) / math.sqrt(s[0]))
                           .astype(np.float32))
          for s in ((32, H * D), (32, KV * D), (32, KV * D), (H * D, 32))]

    def block(x, wq, wk, wv, wo, *, route):
        q = (x @ wq).reshape(2, 48, H, D)
        k = (x @ wk).reshape(2, 48, KV, D)
        v = (x @ wv).reshape(2, 48, KV, D)
        if route == "flash":
            o = fk.flash_attention_train(q, k, v, causal=True, window=20)
        else:
            o = tattn._sdpa(q, k, v, tattn.causal_mask(48, 20)[None], base)
        return torch.tanh(o.reshape(2, 48, H * D) @ wo)

    def grads(remat, route):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        leaves = [t.clone().requires_grad_() for t in (x, *ws)]
        out = maybe_checkpoint(block, cfg)(*leaves, route=route)
        return torch.autograd.grad(out.square().sum(), leaves)

    fk.reset_launch_counts()
    plain = grads(False, "flash")
    for a, b in zip(grads(True, "flash"), plain):
        assert torch.equal(a, b)
    for a, b in zip(grads(False, "sdpa"), plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert not +fk.LAUNCH_COUNTS


@pytest.mark.parametrize("Lq", [1, 128, 200])
def test_backward_takes_lse_as_the_kernels_padded_rows(Lq):
    """``lse`` as the training forward's kernel writes it, (B, H,
    ``lse_rows(Lq)``) with ``+inf`` past Lq: whole q tiles of 128 rows,
    and the plain backward given those rows computes what it computes
    from the (B, H, Lq) ``lse``, bit for bit; on the CPU the backward
    kernel's wrapper raises before it reads any of it."""
    B, H, KV, D = 1, 4, 2, 64
    pad = fk.lse_rows(Lq)
    assert pad % 128 == 0 and Lq <= pad < Lq + 128
    q, k, v = _t(*_qkv(Lq + 11, B, Lq, H, KV, D))
    do = torch.from_numpy(np.random.default_rng(Lq).standard_normal(
        (B, Lq, H, D)).astype(np.float32))
    o, lse = fk.flash_attention_plain(q, k, v, return_lse=True)
    rows = torch.full((B, H, pad), math.inf)
    rows[..., :Lq] = lse
    want = fk.flash_attention_bwd_plain(q, k, v, o, lse, do)
    got = fk.flash_attention_bwd_plain(q, k, v, o, rows, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="training kernels take CUDA"):
        fk.flash_attention_bwd_cuda(q, k, v, o, rows, do)
