"""Port parity: the flash-attention kernel's plain version and dispatcher.

On the CPU ``flash_attention`` runs ``flash_attention_plain``; it is held
against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it, on the same shapes and masks) and against
``attention_ref``.  Tolerances: fp32 atol = rtol = 2e-5 (blockwise online
softmax vs one softmax: the sums run in another order), bf16 3e-2 (the ref
rounds the probabilities to bf16 before P V; the kernels do not).  Ragged
lengths and ``Lq != Lk``, which the Pallas wrapper's divisibility assert
refuses, are held against ``attention_ref`` only.  The CUDA kernel itself
is held to the plain version by ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` on the card.
"""
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
    assert fk.LAUNCH_COUNTS["flash_fwd"] == 0  # the plain path never counts
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
