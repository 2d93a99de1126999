"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips without a CUDA card (the CPU suite counts
them as skipped).  This file imports neither JAX nor the reference, so it
also runs on a machine that has only PyTorch and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerance: the prox kernels and their plain versions do the same fp32
operations in the same order (built with -fmad=false), held at atol = rtol
= 1e-6; frozen rows of the cohort gate are held bit for bit.  The flash
kernels sum their online softmax blockwise: fp32 (``flash_fwd.cu``) at
2e-5, bf16 (``flash_fwd_sm90.cu``, which also rounds P to bf16) at 3e-2,
bf16 D 80 and 96 at their true width too; the head-dim route (fp32 D 32,
80, 96 and bf16 D 32, on zero-padded operands) at the same two, and so
are the encoder-decoder's shapes (non-causal, and causal, ``Lq != Lk``:
cross-attention of 1 or 16 queries against 1024 or a ragged 1000 memory
rows).  The bf16 training kernels (the forward with its row logsumexp,
the backward) against their plain versions: the forward's output bit for
bit with and without ``lse``, ``lse`` within 1e-4, dq / dk / dv within
``FLASH_BWD_REL`` (relative L2 and largest error over largest value); a
reduced bf16 step of qwen3 (D 64) and zamba2 (D 80) through the kernels
against the ``_sdpa`` route per leaf within ``FLASH_STEP_REL``.  The
reduced enc-dec (fp32) on the card
against the CPU: prefill-step logits and memory at 1e-4, greedy tokens
identical.  The sweep rounds hold fused against unfused bit for
bit, and the card against the CPU at rtol 1e-4 / atol 1e-6 (products
summed in another order).  Compressed rounds (CHOCO,
``core/compression.py``) hold fused against unfused bit for bit with
their memory, a comm step on the card
against the CPU from one state at atol 1e-5, and a CUDA graph of
``choco_mix`` bit for bit against the eager call.  The training path: the
grouped bf16 sweep pair at the LM head's leaf against its plain version
at atol = rtol = 1e-2 (one bf16 rounding), the gated pair on bf16
leaves under the async learner's fractional weights within one ulp
(frozen rows bit for bit), both routes of the pair (16-byte vectors and
element by element: ragged rows, misaligned views) on a mixed tree under
five gates, bf16 within one ulp, fp32 and frozen rows bit for bit, and
two reduced fp32
``FederatedTrainer`` rounds on the card against the CPU at 1e-4.  A Table
III DEPOSITUM cell launches each sweep kernel once a step for its three
seeds, and recording its telemetry leaves it bit for bit unchanged.
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


# the Fig. 4 MLP's leaves a client, and a ragged tree: 2-D, 1-D and 0-D
# leaves, odd and float4-able sizes
MLP_SHAPES = ((123, 64), (64,), (64, 32), (32,), (32, 10), (10,))
RAGGED_SHAPES = ((), (3,), (10,), (8, 8), (123, 64), (1001,))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _tree(shapes, dtypes, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [[(torch.randn((S, C) + s, generator=g, device="cuda") * 0.1)
             .to(dt) for s, dt in zip(shapes, dtypes)] for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [MLP_SHAPES, RAGGED_SHAPES],
                         ids=["mlp", "ragged"])
def test_grouped_kernels_match_plain_versions_bit_for_bit(shapes, dtype):
    """One launch per call over every leaf; each output equals the plain
    version bit for bit (fp32 math, one rounding to the storage type), and
    frozen rows come back unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    x, y, nu = _tree(shapes, [dtype] * len(shapes), seed=len(shapes))
    tt = tk.sweep_params_table(**TABLE, device="cuda")
    mask = torch.from_numpy(MASK).cuda()
    frozen = mask <= 0
    for m in (None, mask):
        for kind in ("l1", "mcp", "scad"):
            before = tk.LAUNCH_COUNTS["fused_sweep"]
            out = tk.fused_update_sweep_grouped(x, y, nu, tt, m, kind=kind)
            assert tk.LAUNCH_COUNTS["fused_sweep"] == before + 1
            ref = tk.fused_update_sweep_grouped_plain(x, y, nu, tt, m,
                                                      kind=kind)
            for outs, refs, ins in zip(out, ref, (x, nu)):
                for a, b, i in zip(outs, refs, ins):
                    assert a.shape == i.shape and a.dtype == dtype
                    assert a.is_contiguous()
                    assert torch.equal(_bits(a), _bits(b)), kind
                    if m is not None:
                        assert torch.equal(_bits(a[frozen]), _bits(i[frozen]))
        before = tk.LAUNCH_COUNTS["tracking_sweep"]
        yo, gk = tk.fused_tracking_sweep_grouped(y, nu, x, tt, m)
        assert tk.LAUNCH_COUNTS["tracking_sweep"] == before + 1
        ry, rg = tk.fused_tracking_sweep_grouped_plain(y, nu, x, tt, m)
        for a, b in zip(yo + gk, ry + rg):
            assert torch.equal(_bits(a), _bits(b))
        if m is None:
            assert all(g is n for g, n in zip(gk, nu))
        else:
            for a, i in zip(yo + gk, y + x):
                assert torch.equal(_bits(a[frozen]), _bits(i[frozen]))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_grouped_launches_per_dtype_and_per_table():
    """A mixed fp32 / bf16 tree takes one launch per dtype; 99 leaves of
    one dtype take ceil(99 / 48) = 3; empty leaves none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    tt = tk.sweep_params_table(**TABLE, device="cuda")
    mask = torch.from_numpy(MASK).cuda()
    dts = [torch.float32, torch.bfloat16] * 3
    mixed = _tree(RAGGED_SHAPES, dts, seed=3)
    many = _tree([(7,), (64,), ()] * 33 + [(0,)] * 2, [torch.float32] * 101,
                 seed=4)
    for tree, want in ((mixed, 2), (many, 3)):
        for m in (None, mask):
            before = dict(tk.LAUNCH_COUNTS)
            out = tk.fused_update_sweep_grouped(*tree, tt, m, kind="scad")
            ref = tk.fused_update_sweep_grouped_plain(*tree, tt, m,
                                                      kind="scad")
            yo = tk.fused_tracking_sweep_grouped(*tree, tt, m)
            yr = tk.fused_tracking_sweep_grouped_plain(*tree, tt, m)
            for a, b in zip(out[0] + out[1] + yo[0] + yo[1],
                            ref[0] + ref[1] + yr[0] + yr[1]):
                assert torch.equal(_bits(a), _bits(b))
            assert tk.LAUNCH_COUNTS["fused_sweep"] == before.get(
                "fused_sweep", 0) + want
            assert tk.LAUNCH_COUNTS["tracking_sweep"] == before.get(
                "tracking_sweep", 0) + want
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_grouped_wrappers_check_their_inputs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    x, y, nu = _tree([(10,), (4, 4)], [torch.float32] * 2, seed=5)
    tt = tk.sweep_params_table(**TABLE, device="cuda")
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_update_sweep_grouped(
            [x[0], x[1].transpose(2, 3)], y, nu, tt)
    with pytest.raises(TypeError):
        tk.fused_tracking_sweep_grouped([t.double() for t in x],
                                        [t.double() for t in y],
                                        [t.double() for t in nu], tt)
    with pytest.raises(ValueError, match="params"):
        tk.fused_tracking_sweep_grouped(x, y, nu, tt[:2])
    with pytest.raises(ValueError, match="params"):
        tk.fused_tracking_sweep_grouped(x, y, nu, tt.cpu())
    with pytest.raises(ValueError, match="mask"):
        tk.fused_update_sweep_grouped(x, y, nu, tt,
                                      torch.ones(S, C + 1, device="cuda"))
    with pytest.raises(ValueError, match="kind"):
        tk.fused_update_sweep_grouped(x, y, nu, tt, kind="box")
    with pytest.raises(ValueError, match="differ"):
        tk.fused_update_sweep_grouped(x, y, [nu[0].cpu(), nu[1]], tt)
    assert not tk.LAUNCH_COUNTS


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
    # one grouped launch a step for all six leaves, each kernel
    assert tk.LAUNCH_COUNTS["fused_sweep"] == T0
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == T0
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prox_tree_is_one_grouped_launch_bit_equal_to_plain(dtype):
    """``prox_tree`` / ``fused_update_tree`` over the Fig. 4 model's six
    (10, ...) leaves and a ragged tree: one launch each a call, fp32 bit
    for bit (bf16: one rounding of the same fp32 result, also equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.prox import ops
    hp = dict(kind="mcp", lam=1e-4, alpha=0.05, theta=4.0)
    for shapes in ([(10,) + s for s in MLP_SHAPES], RAGGED_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(len(shapes))
        x, y, nu = ({f"l{i}": (torch.randn(s, generator=g, device="cuda")
                               * 0.01).to(dtype)
                     for i, s in enumerate(shapes)} for _ in range(3))
        for kind in ("l1", "mcp", "scad"):
            hp["kind"] = kind
            tk.reset_launch_counts()
            px = ops.prox_tree(x, **hp)
            ux, unu = ops.fused_update_tree(x, y, nu, gamma=0.8, **hp)
            torch.cuda.synchronize()
            assert dict(tk.LAUNCH_COUNTS) == {"prox": 1, "fused_update": 1}
            for key in x:
                rp = tk.prox_plain(x[key], **hp)
                rx, rn = tk.fused_update_plain(x[key], y[key], nu[key],
                                               gamma=0.8, **hp)
                for a, b in ((px[key], rp), (ux[key], rx), (unu[key], rn)):
                    assert a.shape == b.shape and a.dtype == dtype
                    assert torch.equal(_bits(a), _bits(b)), (kind, key)


@pytest.mark.gpu
def test_unfused_mcp_prox_divides_like_the_kernel():
    """The round's device Hyper makes the unfused MCP prox a true division
    on the card: bit-equal to ``prox_cuda`` (built with -fmad=false, which
    divides).  With the host's 0-d CPU scalars PyTorch multiplies by the
    reciprocal instead, and some elements differ by an ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import depositum as dep
    from repro_torch.core.hyper import Hyper
    from repro_torch.core.prox import _mcp_prox
    host = Hyper.create(alpha=0.05, lam=1e-4, theta=4.0)
    g = torch.Generator(device="cuda").manual_seed(41)
    # mostly inside the shrink band alpha lam < |x| <= theta lam
    x = torch.randn((10, 1 << 16), generator=g, device="cuda") * 2e-4
    state = dep.DepositumState(x={"w": x}, y={}, nu={}, mu={}, g={}, t=0)
    hp, vec = dep._round_scalars(host, state)
    assert all(t.device == x.device for t in hp) and vec.device == x.device
    kernel = tk.prox_cuda(x, kind="mcp", lam=host.lam, theta=host.theta,
                          alpha=host.alpha)
    on_card = _mcp_prox(x, hp.alpha, hp.lam, hp.theta)
    on_host = _mcp_prox(x, host.alpha, host.lam, host.theta)
    torch.cuda.synchronize()
    assert torch.equal(_bits(on_card), _bits(kernel))
    assert not torch.equal(_bits(on_host), _bits(kernel))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_matches_plain_version(D):
    """fp32 runs flash_fwd.cu and bf16 flash_fwd_sm90.cu; each case checks
    which of the two it launched.  The lengths sit on the tile edges of
    both kernels (bf16: 64 rows a warpgroup, 128 a CTA, 64 or 128 keys a
    tile; fp32: 128 rows a CTA and 64 keys a tile, 64 and 32 at D = 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(D)
    tols = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
    fk.reset_launch_counts()
    cases = {torch.float32: 0, torch.bfloat16: 0}

    def qkv(B, Lq, Lk, H, KV, dtype):
        q = torch.randn((B, Lq, H, D), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((B, Lk, KV, D), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        return q, k, v

    def check(q, k, v, causal, window):
        before = dict(fk.LAUNCH_COUNTS)
        out = fk.flash_attention(q, k, v, causal=causal, window=window)
        ref = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = tols[q.dtype]
        torch.testing.assert_close(
            out, ref, atol=tol, rtol=tol,
            msg=lambda m: (f"{q.dtype} q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"causal={causal} window={window}: {m}"))
        bf16 = q.dtype == torch.bfloat16
        assert fk.LAUNCH_COUNTS["flash_fwd_sm90"] == before.get(
            "flash_fwd_sm90", 0) + bf16
        assert fk.LAUNCH_COUNTS["flash_fwd_fp32"] == before.get(
            "flash_fwd_fp32", 0) + (not bf16)
        cases[q.dtype] += 1
        return out

    for B, Lq, Lk, H, KV in ((2, 17, 17, 4, 2), (1, 200, 200, 8, 1),
                             (1, 40, 17, 4, 4), (1, 1, 1, 2, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(B, Lq, Lk, H, KV, dtype)
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                check(q, k, v, causal, window)
    # the tile edges of both kernels (fp32: 64 query rows a CTA, 64 keys a
    # tile, 32 at D = 256), ragged Lq != Lk both ways, windows narrower and
    # wider than a tile
    lengths = [(L, L) for L in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                                1000)]
    for Lq, Lk in lengths + [(40, 17), (17, 200), (130, 70), (191, 250)]:
        for group in (1, 2, 8):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(2 if Lq < 1000 else 1, Lq, Lk, 8, 8 // group,
                              dtype)
                for causal, window in ((True, 0), (True, 31), (True, 64),
                                       (True, 4096), (False, 0)):
                    check(q, k, v, causal, window)
    # causal, window 64, Lq 256 > Lk 64 + 63: rows 127.. see no key
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(1, 256, 64, 4, 2, dtype)
        out = check(q, k, v, True, 64)
        assert torch.count_nonzero(out[:, 127:]) == 0
        assert torch.count_nonzero(out[:, :127]) > 0
    # no key at all: zeros, and no launch
    q, k, v = qkv(1, 5, 0, 4, 2, torch.bfloat16)
    assert torch.count_nonzero(fk.flash_attention(q, k, v)) == 0
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS["flash_fwd"] == sum(cases.values())
    assert fk.LAUNCH_COUNTS["flash_fwd_sm90"] == cases[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 80, 96])
def test_flash_head_dim_route_matches_plain_version(D):
    """Head dims a dtype's kernel is not built for go through the route: q,
    k, v zero-padded to 64 or 128 and the true D's scale (fp32 at D 32, 80
    and 96; bf16 at D 32).  bf16 D 80 and 96 launch the tensor-core kernel
    at the true D, never the route.  Both kernels, against the plain
    version at the true D at the flash tolerances; every launch counted
    under its kernel, and under "flash_fwd_padded" where it took the
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(D)
    tols = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
    fk.reset_launch_counts()
    cases = {torch.float32: 0, torch.bfloat16: 0}
    for B, Lq, Lk, H, KV in ((2, 17, 17, 4, 2), (1, 200, 200, 8, 1),
                             (1, 40, 17, 4, 4), (2, 129, 129, 8, 8),
                             (1, 1024, 1024, 4, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Lq, H, D), generator=g, device="cuda").to(
                dtype)
            k, v = (torch.randn((B, Lk, KV, D), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                out = fk.flash_attention(q, k, v, causal=causal,
                                         window=window)
                ref = fk.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
                assert out.shape == q.shape and out.is_contiguous()
                torch.testing.assert_close(
                    out, ref, atol=tols[dtype], rtol=tols[dtype],
                    msg=lambda m: (f"D={D} {dtype} q {tuple(q.shape)} k "
                                   f"{tuple(k.shape)} causal={causal} "
                                   f"window={window}: {m}"))
                cases[dtype] += 1
    torch.cuda.synchronize()
    routed = {dt: D not in fk.HEAD_DIMS[dt] for dt in cases}
    assert routed == {torch.float32: True, torch.bfloat16: D == 32}
    assert fk.LAUNCH_COUNTS["flash_fwd"] == sum(cases.values())
    assert fk.LAUNCH_COUNTS["flash_fwd_padded"] == sum(
        n for dt, n in cases.items() if routed[dt])
    assert fk.LAUNCH_COUNTS["flash_fwd_sm90"] == cases[torch.bfloat16]
    assert fk.LAUNCH_COUNTS["flash_fwd_fp32"] == cases[torch.float32]
    q = torch.zeros((1, 4, 2, 257), device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        fk.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [80, 96])
def test_bf16_flash_kernel_at_native_head_dims_80_96(D):
    """The tensor-core kernel at zamba2's D 80 and phi-3's D 96 (TMA boxes
    past D zero-filled, P V one m64n80k16 / m64n96k16): ragged lengths on
    and off the tile edges, Lq != Lk both ways, decode's one query and a
    prompt's 16 against 1024 keys; causal with windows 0 and 64 and
    non-causal; GQA groups 1, 2 and 8.  Every case one launch of the
    kernel and none through the head-dim route, within 3e-2 of the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(1000 + D)
    fk.reset_launch_counts()
    n = 0
    pairs = [(L, L) for L in (17, 129, 200, 1000)] + [
        (17, 200), (200, 17), (129, 1000), (1, 1024), (16, 1024)]
    for Lq, Lk in pairs:
        for group in (1, 2, 8):
            q = torch.randn((2, Lq, 8, D), generator=g, device="cuda").to(
                torch.bfloat16)
            k, v = (torch.randn((2, Lk, 8 // group, D), generator=g,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                out = fk.flash_attention(q, k, v, causal=causal,
                                         window=window)
                ref = fk.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
                assert out.shape == q.shape and out.is_contiguous()
                torch.testing.assert_close(
                    out, ref, atol=3e-2, rtol=3e-2,
                    msg=lambda m: (f"D={D} Lq={Lq} Lk={Lk} group={group} "
                                   f"causal={causal} window={window}: {m}"))
                n += 1
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS["flash_fwd_sm90"] == fk.LAUNCH_COUNTS[
        "flash_fwd"] == n
    assert fk.LAUNCH_COUNTS["flash_fwd_padded"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_cross_attention_shapes(dtype):
    """``Lq != Lk`` as the enc-dec runs it (B 4, 16 heads of 64, groups 1
    and 2): decode's one query and a 16-token prompt against 1024 memory
    rows and a ragged 1000, and short ragged pairs both ways; non-causal
    (the enc-dec's mode) and causal, each launch its dtype's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(64)
    tol = {torch.float32: 2e-5, torch.bfloat16: 3e-2}[dtype]
    route = ("flash_fwd_sm90" if dtype == torch.bfloat16
             else "flash_fwd_fp32")
    fk.reset_launch_counts()
    n = 0
    for Lq, Lk in ((1, 1024), (16, 1024), (16, 1000), (1, 17), (17, 200),
                   (200, 17)):
        for group in (1, 2):
            q = torch.randn((4, Lq, 16, 64), generator=g, device="cuda").to(
                dtype)
            k, v = (torch.randn((4, Lk, 16 // group, 64), generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            for causal in (False, True):
                out = fk.flash_attention(q, k, v, causal=causal)
                ref = fk.flash_attention_plain(q, k, v, causal=causal)
                torch.testing.assert_close(
                    out, ref, atol=tol, rtol=tol,
                    msg=lambda m: (f"{dtype} Lq {Lq} Lk {Lk} group {group} "
                                   f"causal={causal}: {m}"))
                n += 1
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS[route] == fk.LAUNCH_COUNTS["flash_fwd"] == n


@pytest.mark.gpu
def test_reduced_encdec_on_the_card_matches_the_cpu():
    """Reduced seamless-m4t-medium, fp32, the same weights on the card and
    on the CPU: the prefill step's logits and memory within 1e-4 (6 fp32
    flash launches on the card: 2 encoder, 2 decoder self, 2 cross), then
    identical greedy tokens from each device's memory (2 launches a decode
    step: the cross-attention)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config("seamless-m4t-medium", reduced=True)
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (2, 50, cfg.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))}
    params, _ = build_model(cfg, device="cpu").init(seed=0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        p = params.to(dev)
        fk.reset_launch_counts()
        logits, memory = build_prefill_step(model, 32)(
            p, {k: v.to(dev) for k, v in batch.items()})
        assert fk.LAUNCH_COUNTS["flash_fwd_fp32"] == (6 if dev == "cuda"
                                                      else 0)
        toks = BatchedServer(model, p, ServeConfig(
            max_new_tokens=5, cache_capacity=32)).generate(
            batch["tokens"], extra={"memory": memory})
        # 8 prompt tokens and 4 decode steps, 2 cross-attention launches each
        assert fk.LAUNCH_COUNTS["flash_fwd_fp32"] == (
            6 + 2 * (8 + 4) if dev == "cuda" else 0)
        out[dev] = (logits.cpu(), memory.cpu(), toks.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["grok-1-314b", "zamba2-2.7b"])
def test_reduced_zoo_server_on_the_card_matches_the_cpu(arch):
    """A reduced MoE and the reduced hybrid (head dim 32: the fp32 kernel
    through the head-dim route) in fp32, the same weights on the card and
    on the CPU: identical greedy tokens, prefill logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import group_shape
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(arch, reduced=True)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    toks, logits = {}, {}
    params, _ = build_model(cfg, device="cpu").init(seed=0)
    fk.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        srv = BatchedServer(build_model(cfg, device=dev), params.to(dev),
                            ServeConfig(max_new_tokens=6, cache_capacity=96))
        toks[dev] = srv.generate(prompts).cpu()
        with torch.inference_mode():
            logits[dev] = srv.prefill(prompts.to(dev))[0].cpu()
    attn_layers = (cfg.n_layers if cfg.family == "moe"
                   else group_shape(cfg)[0])
    assert fk.LAUNCH_COUNTS["flash_fwd_fp32"] == 2 * attn_layers
    assert fk.LAUNCH_COUNTS["flash_fwd_padded"] == 2 * attn_layers
    assert torch.equal(toks["cpu"], toks["cuda"])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)


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


def _bits_equal_states(a, b):
    for f in ("x", "y", "nu", "g"):
        for key, v in getattr(a, f).items():
            if not torch.equal(v.view(torch.int32),
                               getattr(b, f)[key].view(torch.int32)):
                return False
    return True


@pytest.mark.gpu
def test_sweep_round_is_one_launch_a_step_fused_equal_to_unfused():
    """Four configs (a stacked dense W over four topologies, a gamma x
    alpha grid) of a small MLP through ``sweep_run`` on the card: one
    grouped launch of each sweep kernel a step for all four, and fused
    bit-equal to unfused (both divide by the round's device scalars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import (DepositumConfig, MixPlan, hyper_grid,
                                  stack_mixplans)
    from repro_torch.models.classifier import MLP, client_grad_fn, init_params
    from repro_torch.training.sweep import sweep_run

    n, T0, R, d_in, k = 6, 4, 2, 12, 5
    model = MLP(d_in, k, (16, 8)).cuda()
    plans = stack_mixplans([MixPlan.from_topology(t, n, device="cuda")
                            for t in ("complete", "ring", "star", "torus")])
    rng = np.random.default_rng(1)
    batches = {"x": torch.from_numpy(rng.standard_normal(
        (R, T0, n, 6, d_in)).astype(np.float32)).cuda(),
        "y": torch.from_numpy(rng.integers(0, k, (R, T0, n, 6))).cuda()}
    finals = {}
    for mode in ("require", "off"):
        cfg = DepositumConfig(comm_period=T0, prox_name="mcp",
                              prox_kwargs={"lam": 1e-3, "theta": 4.0},
                              fused=mode)
        hypers = hyper_grid(base=cfg.hyper(), gamma=[0.5, 0.8],
                            alpha=[0.05, 0.1])
        tk.reset_launch_counts()
        finals[mode], _ = sweep_run(init_params(model, 0, device="cuda"),
                                    client_grad_fn(model), cfg, plans,
                                    hypers, batches, n_clients=n)
        torch.cuda.synchronize()
        want = R * T0 if mode == "require" else 0
        assert tk.LAUNCH_COUNTS["fused_sweep"] == want
        assert tk.LAUNCH_COUNTS["tracking_sweep"] == want
        assert not tk.GATED_LAUNCH_COUNTS
    assert finals["require"].x["l0.w"].shape == (4, n, d_in, 16)
    assert _bits_equal_states(finals["require"], finals["off"])


@pytest.mark.gpu
def test_gated_cohort_sweep_round_on_the_card():
    """A padded cohort grid on the card: every step one launch of each
    kernel's gated instantiation, the rows a round leaves out bit for bit
    unchanged, fused bit-equal to unfused, and the card within rtol 1e-4 /
    atol 1e-6 of the plain run on the CPU (least-squares sums in another
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.figures import (COHORT_D, cohort_grad_fn, cohort_setup)
    from repro_torch.training.sweep import make_sweep_round, sweep_init

    grid, rounds = dict(sizes=[4, 8], p_active=[0.5, 1.0], n_max=16), 3
    out = {}
    for dev, mode in (("cuda", "require"), ("cuda", "off"),
                      ("cpu", "require")):
        c = cohort_setup(dev, mode, **grid)
        T0 = c.config.comm_period
        round_fn = make_sweep_round(cohort_grad_fn(c.A, c.b), c.config,
                                    c.grid, batch_axis=None)
        state = sweep_init({"w": torch.zeros(COHORT_D, device=dev)}, 16, 4)
        tk.reset_launch_counts()
        for r in range(rounds):
            before = state
            state, _ = round_fn(state, c.config.hyper(),
                                torch.zeros((T0, 1), device=dev))
            idle = c.grid.sampler.mask_at(r) <= 0
            for f in ("x", "y", "nu", "g"):
                a, b = getattr(state, f)["w"], getattr(before, f)["w"]
                assert torch.equal(a[idle].view(torch.int32),
                                   b[idle].view(torch.int32)), f
        if dev == "cuda":
            torch.cuda.synchronize()
            want = rounds * T0 if mode == "require" else 0
            assert tk.LAUNCH_COUNTS["fused_sweep"] == want
            assert tk.GATED_LAUNCH_COUNTS["fused_sweep"] == want
            assert tk.GATED_LAUNCH_COUNTS["tracking_sweep"] == want
        out[(dev, mode)] = state
    assert _bits_equal_states(out[("cuda", "require")], out[("cuda", "off")])
    for f in ("x", "y", "nu", "g"):
        torch.testing.assert_close(
            getattr(out[("cuda", "require")], f)["w"].cpu(),
            getattr(out[("cpu", "require")], f)["w"], rtol=1e-4, atol=1e-6)


def _lsq_ops(dev, n=8, d=16, m=8, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((n, m, d)).astype(
        np.float32)).to(dev)
    b = A @ torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(
        dev)

    def grad_fn(x, batch):
        r = torch.einsum("nmd,nd->nm", A, x["w"]) - b
        return {"w": torch.einsum("nmd,nm->nd", A, r) / m}, {}

    return grad_fn


def _leaves_with_memory(st):
    out = [getattr(st, f)["w"] for f in ("x", "y", "nu", "g")]
    return out + [getattr(st.comm[v], f)["w"] for v in ("x", "y")
                  for f in ("xhat", "s")]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["topk", "qsgd"])
def test_compressed_round_on_the_card(kind):
    """A compressed one-config round and a compressed mixed-kind sweep
    (none / top-k / QSGD) of least squares on the card: one launch of each
    sweep kernel a step (for all S), fused bit-equal to unfused with the
    memory; the comm step from one state on the card and on the CPU (the
    same hashed draws) within atol 1e-5 (products summed in another
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import (CompressionSpec, DepositumConfig, MixPlan,
                                  as_schedule, init, local_then_comm_round,
                                  stack_hypers, stack_schedules, step)
    from repro_torch.training.sweep import sweep_run

    n, d, T0, R = 8, 16, 3, 2

    def spec(dev):
        return (CompressionSpec.topk(0.25, device=dev) if kind == "topk"
                else CompressionSpec.qsgd(4, seed=3, device=dev))

    def sched(dev):
        return as_schedule(MixPlan.from_topology(
            "ring", n, device=dev)).with_compression(spec(dev))

    out = {}
    for mode in ("require", "off"):
        cfg = DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                              comm_period=T0, fused=mode)
        grad_fn = _lsq_ops("cuda")
        st = init({"w": torch.ones(d, device="cuda")}, n,
                  compress=spec("cuda"), device="cuda")
        tk.reset_launch_counts()
        for _ in range(R):
            st, _ = local_then_comm_round(st, torch.zeros((T0, 1)), grad_fn,
                                          cfg, sched("cuda"))
        base = as_schedule(MixPlan.from_topology("ring", n, device="cuda"))
        grid = stack_schedules([base.with_compression(s) for s in (
            CompressionSpec.none(device="cuda"), spec("cuda"))])
        sw, _ = sweep_run({"w": torch.ones(d, device="cuda")}, grad_fn, cfg,
                          grid, stack_hypers([cfg.hyper()] * 2),
                          torch.zeros((R, T0, 1), device="cuda"),
                          n_clients=n)
        torch.cuda.synchronize()
        want = 2 * R * T0 if mode == "require" else 0
        assert tk.LAUNCH_COUNTS["fused_sweep"] == want
        assert tk.LAUNCH_COUNTS["tracking_sweep"] == want
        out[mode] = (st, sw)
    for a, b in zip(out["require"], out["off"]):
        for u, v in zip(_leaves_with_memory(a), _leaves_with_memory(b)):
            assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    st = out["require"][0]
    comm_step = {}
    for dev in ("cuda", "cpu"):
        mv = lambda t: {k: v.to(dev) for k, v in t.items()}
        s_dev = st._replace(
            **{f: mv(getattr(st, f)) for f in ("x", "y", "nu", "mu", "g")},
            comm={v: type(m)(*(mv(t) for t in m))
                  for v, m in st.comm.items()}, t=R * T0 + T0 - 1)
        cfg = DepositumConfig(alpha=0.05, beta=0.5, gamma=0.5,
                              comm_period=T0, fused="require")
        comm_step[dev], _ = step(s_dev, None, _lsq_ops(dev), cfg, sched(dev))
    for u, v in zip(_leaves_with_memory(comm_step["cuda"]),
                    _leaves_with_memory(comm_step["cpu"])):
        torch.testing.assert_close(u.cpu(), v, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["topk", "qsgd", "mixed"])
def test_choco_mix_replays_in_a_cuda_graph(kind):
    """One CHOCO exchange captured in a CUDA graph (capture fails on a host
    sync) replays bit-equal to the eager call, also on new inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import (CommMemory, CompressionSpec, MixPlan,
                                  apply_mix_sweep, choco_mix,
                                  comm_round_keys, stack_specs)

    S, n = 3, 6
    plan = MixPlan.from_topology("ring", n, device="cuda")
    if kind == "mixed":
        spec = stack_specs([CompressionSpec.none(device="cuda"),
                            CompressionSpec.topk(0.2, device="cuda"),
                            CompressionSpec.qsgd(3, device="cuda")])
    else:
        spec = (CompressionSpec.topk(0.2, device="cuda") if kind == "topk"
                else CompressionSpec.qsgd(4, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(7)
    x, xhat, s = ({"a": torch.randn((S, n, 5, 7), generator=g,
                                    device="cuda"),
                   "b": torch.randn((S, n, 3), generator=g, device="cuda")}
                  for _ in range(3))
    key = comm_round_keys(spec, 1)[1]

    def call():
        o, m = choco_mix(spec, lambda t: apply_mix_sweep(plan, t), x,
                         CommMemory(xhat, s), key, lead=2)
        return [o, m.xhat, m.s]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    for replay in range(2):
        if replay:
            for t in (x, xhat, s):
                for v in t.values():
                    v.copy_(torch.randn(v.shape, generator=g, device="cuda"))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            for k in a:
                assert torch.equal(a[k].view(torch.int32),
                                   b[k].view(torch.int32))


def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in ulps (int32)."""
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (line(a) - line(b)).abs()


@pytest.mark.gpu
def test_grouped_bf16_sweep_pair_at_the_lm_head_leaf():
    """The training path's largest leaf: one config's 2 client rows of the
    LM head, (2048, 152064) bf16 (311,427,072 elements a row), through
    the grouped pair (lead 1) under the launcher's row (alpha 0.02, gamma
    0.8, beta 1) against the plain versions.  The kernel and the plain
    version round the same fp32 result once: at most 1 bf16 ulp apart.
    x is at the weights' scale and y, nu at a gradient's, so x' - x spans
    ~200 ulps of x; the inputs returned unchanged, or the plain version
    under alpha / 2 (x') or beta / 2 (y'), miss by more than 1 ulp in
    over half the elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(11)
    shape = (2, 2048, 152064)
    x = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    y, nu = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    rows = [tk.sweep_params_table(lam=1e-5, theta=4.0, alpha=0.02 * s,
                                  gamma=0.8, beta=s, device="cuda")
            for s in (1.0, 0.5)]

    def held(out, ref, *controls):
        assert out.shape == shape and out.dtype == torch.bfloat16
        assert int(_bf16_ulps(out, ref).max()) <= 1
        for c in controls:
            assert float((_bf16_ulps(c, ref) > 1).float().mean()) > 0.5

    before = dict(tk.LAUNCH_COUNTS)
    (xo,), (nuo,) = tk.fused_update_sweep_grouped([x], [y], [nu], rows[0],
                                                  kind="l1", lead=1)
    (xr,), (nur,) = tk.fused_update_sweep_grouped_plain(
        [x], [y], [nu], rows[0], kind="l1", lead=1)
    (xa,), _ = tk.fused_update_sweep_grouped_plain([x], [y], [nu], rows[1],
                                                   kind="l1", lead=1)
    held(xo, xr, x, xa)
    held(nuo, nur, nu)
    del xo, nuo, xr, nur, xa
    (yo,), (kept,) = tk.fused_tracking_sweep_grouped([y], [nu], [x], rows[0],
                                                     lead=1)
    (yr,), _ = tk.fused_tracking_sweep_grouped_plain([y], [nu], [x], rows[0],
                                                     lead=1)
    (yb,), _ = tk.fused_tracking_sweep_grouped_plain([y], [nu], [x], rows[1],
                                                     lead=1)
    held(yo, yr, y, yb)
    assert kept is nu                           # ungated: g_kept is g_new
    assert tk.LAUNCH_COUNTS["fused_sweep"] == before.get("fused_sweep", 0) + 1
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == \
        before.get("tracking_sweep", 0) + 1


@pytest.mark.gpu
def test_gated_bf16_sweep_pair_with_fractional_weights():
    """The async learner's gate: one config's bf16 leaves (lead 1) under a
    (1, C) mask of downweight values (1, 0.5, 0.25) and zero rows, through
    the grouped pair's gated instantiation against its plain version.
    Live rows within 1 bf16 ulp (both round the same fp32 result once; the
    inputs returned unchanged miss by more than that in over half the
    elements); frozen rows of x', nu', y' and g_kept bit for bit the
    inputs, live rows of g_kept bit for bit g_new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(5, 333), (5, 64, 33), (5,), (5, 2048, 96)]
    mask = torch.tensor([[0.5, 0.0, 0.25, 1.0, 0.0]], device="cuda")
    live = mask[0] > 0
    mk = lambda sh, scale: (torch.randn(sh, generator=g, device="cuda")
                            * scale).to(torch.bfloat16)
    xs = [mk(sh, 0.02) for sh in shapes]
    ys, nus, gos = ([mk(sh, 1.0) for sh in shapes] for _ in range(3))
    row = tk.sweep_params_table(lam=1e-5, theta=4.0, alpha=0.02, gamma=0.8,
                                beta=1.0, device="cuda")
    before = dict(tk.LAUNCH_COUNTS)
    gated = dict(tk.GATED_LAUNCH_COUNTS)
    outs = tk.fused_update_sweep_grouped(xs, ys, nus, row, mask, kind="l1",
                                         lead=1)
    refs = tk.fused_update_sweep_grouped_plain(xs, ys, nus, row, mask,
                                               kind="l1", lead=1)
    tracked = tk.fused_tracking_sweep_grouped(ys, nus, gos, row, mask,
                                              lead=1)
    tracked_ref = tk.fused_tracking_sweep_grouped_plain(ys, nus, gos, row,
                                                        mask, lead=1)
    torch.cuda.synchronize()
    for out, ref, ins in ((outs[0], refs[0], xs), (outs[1], refs[1], nus),
                          (tracked[0], tracked_ref[0], ys)):
        for o, r, i in zip(out, ref, ins):
            assert o.dtype == torch.bfloat16 and o.shape == i.shape
            assert int(_bf16_ulps(o[live], r[live]).max()) <= 1
            assert torch.equal(o[~live].view(torch.int16),
                               i[~live].view(torch.int16))
        if ins is not nus:
            moved = torch.cat([(_bf16_ulps(i[live], r[live]) > 1).flatten()
                               for i, r in zip(ins, ref)])
            assert float(moved.float().mean()) > 0.5
    for k, gn, go in zip(tracked[1], nus, gos):
        assert torch.equal(k[live].view(torch.int16),
                           gn[live].view(torch.int16))
        assert torch.equal(k[~live].view(torch.int16),
                           go[~live].view(torch.int16))
    for key in ("fused_sweep", "tracking_sweep"):
        assert tk.LAUNCH_COUNTS[key] == before.get(key, 0) + 1
        assert tk.GATED_LAUNCH_COUNTS[key] == gated.get(key, 0) + 1


def _route_tree(seed):
    """x at the weights' scale, y, nu and g_old at a gradient's: (2, d)
    leaves of ``kernel.ROUTE_LEAVES`` (one config's 2 clients, lead 1),
    each a contiguous view at its storage offset."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    trees = []
    for scale in (0.02, 1.0, 1.0, 1.0):
        leaves = []
        for d, dt, k in tk.ROUTE_LEAVES:
            flat = torch.empty(2 * d + k, dtype=dt, device="cuda")
            view = flat[k:].view(2, d)
            view.copy_(torch.randn((2, d), generator=g, device="cuda")
                       * scale)
            leaves.append(view)
        trees.append(leaves)
    return trees


@pytest.mark.gpu
@pytest.mark.parametrize("gate", list(tk.ROUTE_GATES))
def test_sweep_pair_on_both_routes_of_a_ragged_mixed_tree(gate):
    """The grouped pair over ``kernel.ROUTE_LEAVES`` under each of
    ``kernel.ROUTE_GATES``, against the plain versions: bf16 live rows
    within 1 ulp (both round the same fp32 result once: expected equal),
    fp32 bit for bit, frozen rows bit for bit the inputs, g_kept's live
    rows bit for bit g_new; one launch of each kernel a dtype a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    x, y, nu, go = _route_tree(13)
    row = tk.sweep_params_table(lam=1e-5, theta=4.0, alpha=0.02, gamma=0.8,
                                beta=1.0, device="cuda")
    m = tk.ROUTE_GATES[gate]
    mask = None if m is None else torch.tensor([m], device="cuda")
    live = (torch.ones(2, dtype=torch.bool, device="cuda") if m is None
            else mask[0] > 0)

    def held(outs, refs, ins):
        for o, r, i in zip(outs, refs, ins):
            assert o.shape == i.shape and o.dtype == i.dtype
            if o.dtype == torch.bfloat16:
                if live.any():
                    assert int(_bf16_ulps(o[live], r[live]).max()) <= 1
            else:
                assert torch.equal(_bits(o[live]), _bits(r[live]))
            assert torch.equal(_bits(o[~live]), _bits(i[~live]))

    for kind in ("l1", "mcp", "scad"):
        before = tk.LAUNCH_COUNTS["fused_sweep"]
        outs = tk.fused_update_sweep_grouped(x, y, nu, row, mask, kind=kind,
                                             lead=1)
        assert tk.LAUNCH_COUNTS["fused_sweep"] == before + 2
        refs = tk.fused_update_sweep_grouped_plain(x, y, nu, row, mask,
                                                   kind=kind, lead=1)
        torch.cuda.synchronize()
        held(outs[0], refs[0], x)
        held(outs[1], refs[1], nu)
    before = tk.LAUNCH_COUNTS["tracking_sweep"]
    ys, kept = tk.fused_tracking_sweep_grouped(y, nu, go, row, mask, lead=1)
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == before + 2
    ref_ys, _ = tk.fused_tracking_sweep_grouped_plain(y, nu, go, row, mask,
                                                      lead=1)
    torch.cuda.synchronize()
    held(ys, ref_ys, y)
    for k, gn, g_old in zip(kept, nu, go):
        if mask is None:
            assert k is gn
        else:
            assert torch.equal(_bits(k[live]), _bits(gn[live]))
            assert torch.equal(_bits(k[~live]), _bits(g_old[~live]))


@pytest.mark.gpu
def test_reduced_trainer_round_on_the_card_matches_the_cpu():
    """Reduced fp32 qwen3 through FederatedTrainer (fused auto: the sweep
    kernels on the card, their plain versions on the CPU), 2 rounds from
    one state: x, y, nu, g within atol = rtol = 1e-4 (products summed in
    another order), one grouped launch of each kernel a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    import copy

    from repro_torch.launch import train

    args = train.parse_args(["--arch", "qwen3-1.7b", "--reduced",
                             "--clients", "4", "--batch", "2", "--seq", "16",
                             "--t0", "2", "--seed", "2"])
    states, start = {}, None
    for dev in ("cpu", "cuda"):
        args.device = dev
        trainer, _, _, it = train.build(args)
        if start is None:
            start = trainer.model.init(args.seed)[0]
        before = dict(tk.LAUNCH_COUNTS)
        state = trainer.state_from_params(copy.deepcopy(start).to(dev))
        states[dev], _ = trainer.run(state, it, 2)
    torch.cuda.synchronize()
    assert tk.LAUNCH_COUNTS["fused_sweep"] - before.get("fused_sweep", 0) \
        == states["cuda"].t == 4
    for f in ("x", "y", "nu", "g"):
        a, b = getattr(states["cuda"], f), getattr(states["cpu"], f)
        for k in a:
            torch.testing.assert_close(a[k].cpu(), b[k], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.gpu
def test_table3_cell_and_its_telemetry_on_the_card():
    """One Table III DEPOSITUM cell (OPTION I, Dir(0.1), 2 rounds, the
    three seeds as S = 3) with ``fused="require"``: one grouped launch of
    each sweep kernel a step for the three seeds; the same cell through
    ``sweep_run`` with a recorder attached is bit for bit the cell without
    one, and its buffer reaches the host once (2 rows, B = 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch import figures as F
    from repro_torch.core import MixPlan, stack_hypers
    from repro_torch.models.classifier import MLP, client_grad_fn
    from repro_torch.obs.record import Telemetry
    from repro_torch.training.sweep import sweep_run

    rounds = 2
    tk.reset_launch_counts()
    cell = F.table3_cell("depositum-I", 0.1, rounds=rounds, device="cuda",
                         fused="require")
    torch.cuda.synchronize()
    steps = rounds * F.T3_T0
    assert tk.LAUNCH_COUNTS["fused_sweep"] == steps
    assert tk.LAUNCH_COUNTS["tracking_sweep"] == steps
    probs = [F.table3_problem(0.1, s, rounds, "cuda") for s in F.T3_SEEDS]
    params0 = {k: torch.stack([p.params0[k] for p in probs])
               for k in probs[0].params0}
    batches = {"x": torch.stack([p.bx for p in probs]),
               "y": torch.stack([p.by for p in probs])}
    cfg = F.table3_dep_config("depositum-I", "require")
    grad_fn = client_grad_fn(MLP(F.T3_FEATURES, F.T3_CLASSES).cuda())
    plan = MixPlan.from_topology("complete", F.T3_CLIENTS, device="cuda")
    hypers = stack_hypers([cfg.hyper()] * len(F.T3_SEEDS))
    kw = dict(n_clients=F.T3_CLIENTS, params_axis=0, batch_axis=0)
    off, _ = sweep_run(params0, grad_fn, cfg, plan, hypers, batches, **kw)
    tel = Telemetry.memory()
    on, _ = sweep_run(params0, grad_fn, cfg, plan, hypers, batches,
                      telemetry=tel, **kw)
    for f in ("x", "y", "nu", "mu", "g"):
        for k, v in getattr(on, f).items():
            assert torch.equal(v, getattr(off, f)[k]), (f, k)
    for k, v in off.x.items():
        assert torch.equal(v, cell["x"][k]), k
    assert tel.host_copies == 1
    assert [tel.memory_sink.rounds(s) for s in range(3)] == [[1, 2]] * 3


# (B, Lq, Lk, H, KV, D, causal, window): tests/test_torch_flash.py's
# TRAIN_CASES (held there on the CPU, plain backward against autograd) and
# the benchmark cells' shape
FLASH_TRAIN_CASES = [
    (2, 37, 37, 4, 4, 64, True, 0), (1, 70, 70, 4, 2, 80, True, 16),
    (2, 45, 45, 8, 2, 96, True, 0), (1, 130, 130, 4, 1, 128, True, 32),
    (1, 50, 29, 4, 2, 64, True, 8), (2, 33, 47, 2, 1, 128, True, 0),
    (1, 20, 52, 6, 3, 96, False, 0), (1, 61, 61, 2, 2, 80, True, 0),
    (2, 2048, 2048, 16, 8, 128, True, 0),
]
#: the bf16 backward against its plain version on the same bf16 inputs,
#: per gradient: relative L2 error, and largest error over largest value.
#: The kernel rounds P and dS to bf16 as wgmma operands and writes bf16;
#: on an H100 its readings are 0.0022-0.0024 and 0.0011-0.0045 here
FLASH_BWD_REL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,causal,window", FLASH_TRAIN_CASES)
def test_flash_backward_kernel_matches_plain_version(B, Lq, Lk, H, KV, D,
                                                     causal, window):
    """The training forward (bf16, with ``lse``) gives the inference
    kernel's output bit for bit and the plain version's ``lse`` within
    1e-4 (+inf on the same rows; its rows past Lq, to whole q tiles, hold
    +inf); the backward kernel's dq, dk, dv match
    ``flash_attention_bwd_plain`` in fp32 on the same bf16 inputs within
    ``FLASH_BWD_REL``; rows with no visible key get zero dq; one count a
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device="cuda").manual_seed(Lq + Lk + D)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v, do = rnd(B, Lq, H, D), rnd(B, Lk, KV, D), rnd(B, Lk, KV, D), \
        rnd(B, Lq, H, D)
    fk.reset_launch_counts()
    o, lse = fk.flash_attention_fwd_train_cuda(q, k, v, causal=causal,
                                               window=window)
    assert torch.equal(o, fk.flash_attention_cuda(q, k, v, causal=causal,
                                                  window=window))
    f32 = [t.float() for t in (q, k, v)]
    _, plse = fk.flash_attention_plain(*f32, causal=causal, window=window,
                                       return_lse=True)
    assert lse.shape == (B, H, fk.lse_rows(Lq))
    assert bool(torch.isinf(lse[..., Lq:]).all() and (lse[..., Lq:] > 0).all())
    seen = torch.isfinite(plse)
    assert torch.equal(torch.isfinite(lse[..., :Lq]), seen)
    torch.testing.assert_close(lse[..., :Lq][seen], plse[seen], atol=1e-4,
                               rtol=0)
    got = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    want = fk.flash_attention_bwd_plain(*f32, o.float(), plse, do.float(),
                                        causal=causal, window=window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = a.float() - b
        rel = float(err.norm() / b.norm())
        top = float(err.abs().max() / b.abs().max())
        assert rel <= FLASH_BWD_REL and top <= FLASH_BWD_REL, (name, rel, top)
    dead = (~seen).all(dim=1)[0]  # (Lq,): rows no head sees a key from
    if dead.any():
        assert torch.count_nonzero(got[0][:, dead]) == 0
    assert (fk.LAUNCH_COUNTS["flash_fwd_train"], fk.LAUNCH_COUNTS["flash_bwd"],
            fk.LAUNCH_COUNTS["flash_bwd_sm90"]) == (1, 1, 1)


#: per-leaf first gradients of a reduced bf16 training step through the
#: kernels against the same step through ``_sdpa``: |g - g_sdpa| over the
#: larger of |g_sdpa| and the median leaf's norm (as the benchmark's
#: ``grad1``), worst leaf and client.  Both routes round to bf16, at other
#: places (``_sdpa`` its bf16 scores, dP and dS; the kernels P and dS as
#: wgmma operands)
FLASH_STEP_REL = 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("arch,D", [("qwen3-1.7b", 64), ("zamba2-2.7b", 80),
                                    ("seamless-m4t-medium", 64)])
def test_reduced_bf16_step_through_the_flash_kernels(arch, D, monkeypatch):
    """A reduced bf16 step with remat ("full") of 2 clients through the
    trainer's gradient function: on the card the chosen route launches the
    training forward twice (forward and recompute) and the backward once
    an attention layer and client, counts no ``_sdpa`` dispatch, and its
    per-leaf gradients match the ``_sdpa`` route's within
    ``FLASH_STEP_REL``.  qwen3 at D 64 through ``block_train``; zamba2's
    shared block (the hybrid) at D 80; the enc-dec's decoder
    self-attention at D 64 (16 stub frames a sample; its encoder and
    cross-attention compute ``_sdpa`` on both routes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import train
    from repro_torch.models import attention as attn
    from repro_torch.models.hybrid import group_shape

    cfg = dataclasses.replace(get_config(arch, reduced=True), head_dim=D,
                              dtype="bfloat16", remat=True,
                              remat_policy="full")
    monkeypatch.setattr(train, "get_config", lambda *a, **kw: cfg)
    clients = 2
    args = train.parse_args(["--arch", arch, "--reduced", "--clients",
                             str(clients), "--batch", "2", "--seq", "64",
                             "--t0", "1", "--seed", "3"])
    trainer, _, state, it = train.build(args)
    batch = {k: v[0] for k, v in next(it).items()}
    if cfg.family == "encdec":
        gen = torch.Generator(device="cuda").manual_seed(6)
        batch["frames"] = torch.randn(
            tuple(batch["tokens"].shape[:2]) + (16, cfg.d_model),
            generator=gen, device="cuda").to(torch.bfloat16)
    layers = (group_shape(cfg)[0] if cfg.family == "hybrid"
              else cfg.n_layers)
    fk.reset_launch_counts()
    attn.DISPATCH_COUNTS.clear()
    g_kernel, _ = trainer._grad_fn(state.x, batch)
    torch.cuda.synchronize()
    assert fk.LAUNCH_COUNTS["flash_bwd"] == layers * clients
    assert fk.LAUNCH_COUNTS["flash_fwd_train"] == 2 * layers * clients
    assert not attn.DISPATCH_COUNTS
    monkeypatch.setattr(attn, "trains_on_kernel", lambda q: False)
    g_sdpa, _ = trainer._grad_fn(state.x, batch)
    torch.cuda.synchronize()
    assert attn.DISPATCH_COUNTS["train_sdpa"] == 2 * layers * clients
    assert fk.LAUNCH_COUNTS["flash_bwd"] == layers * clients
    norms = {k: v.float().reshape(clients, -1).norm(dim=1)
             for k, v in g_sdpa.items()}
    median = torch.stack(list(norms.values())).median(dim=0).values
    worst = max(
        (float(((g_kernel[k].float() - v.float()).reshape(clients, -1)
                .norm(dim=1) / torch.maximum(norms[k], median)).max()), k)
        for k, v in g_sdpa.items())
    print(f"{arch} D {D}: worst leaf {worst[1]} at {worst[0]:.3g}")
    assert worst[0] <= FLASH_STEP_REL, worst
