"""Port parity: the encoder-decoder family (reduced ``seamless-m4t-medium``:
2 + 2 layers, d 256, 4 heads, fp32) against the reference.

The reference's parameters (its own ``init``) are carried across by
``repro_torch.convert.model_params_from_numpy``; inputs are numpy draws
from fixed seeds.  Covered: the encoder at window 0, at a window that
covers the frames and at a narrower one; ``attention_bidir`` and
``cross_attention`` with ``Lq != S``; the training forward with and
without the flash dispatch; step-by-step decode against the training
forward; the loss and its autograd gradients against ``jax.grad``;
``launch.steps.build_prefill_step`` / ``build_serve_step``; greedy
``BatchedServer`` tokens with a given memory; the serve launcher; remat.

Tolerances: logits, memories and losses by relative L2 norm within 1e-5
(the same fp32 operations, sums in another order); step-by-step decode
against the training forward at atol = rtol = 2e-5, as the reference's
``tests/test_decode_equivalence.py`` holds its own; gradients within 1e-4
relative L2 a leaf.  Greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.serving import BatchedServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDec, EncDecCache
from repro_torch.serving import BatchedServer, ServeConfig

ARCH = "seamless-m4t-medium"
REL = 1e-5
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_REL = 1e-4
B, S, L = 2, 24, 9      # batch, frames (memory rows), decoder tokens


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Small CPU ops run faster on few threads beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def port_pair(cfg_edit=None):
    """(reference model, its params, port model, port module), the same
    weights on both sides."""
    jcfg, tcfg = jget(ARCH, reduced=True), get_config(ARCH, reduced=True)
    if cfg_edit:
        jcfg, tcfg = (dataclasses.replace(c, **cfg_edit) for c in (jcfg, tcfg))
    jm = jbuild(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jp)
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, EncDec(tcfg, model_params_from_numpy(
        numpy_params, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def pair():
    jm, jp, tm, module = port_pair()
    return dict(cfg=tm.cfg, jcfg=jm.cfg, jm=jm, jp=jp, tm=tm, module=module)


def _batch(seed, n_frames=S, n_tokens=L, d=256):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, n_frames, d)).astype(
                np.float32),
            "tokens": rng.integers(0, 512, (B, n_tokens)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, n_tokens)).astype(np.int32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# Configs, building, converting
# ---------------------------------------------------------------------------

def test_every_arch_is_served_and_the_encdec_builds():
    """``list_archs`` / ``get_config`` / ``build_model`` serve all ten
    archs; the full enc-dec at its published widths and parameter count
    (the meta device: shapes without memory)."""
    assert len(list_archs()) == 10 and ARCH in list_archs()
    full = get_config(ARCH)
    assert (full.family, full.n_encoder_layers, full.n_layers, full.d_model,
            full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab_size, full.mlp_type) == (
        "encdec", 12, 12, 1024, 16, 16, 64, 4096, 256206, "gelu")
    assert full.param_count() == 877_031_424
    model = build_model(full, device="meta")
    assert model.forward_prefill is None
    module, axes = model.init(seed=0)
    assert isinstance(module, EncDec)
    assert len(module.encoder) == len(module.decoder) == 12
    assert module.lm_head["w"].shape == (1024, 256256)
    stored = sum(p.numel() for p in module.parameters())
    # + the vocabulary padding (50 rows) of the embedding and the head,
    # + the norms' scales
    assert stored == 877_031_424 + 2 * 50 * 1024 + (2 * 12 + 3 * 12 + 2) \
        * 1024
    assert axes["decoder"][0]["cross_attn"]["wq"] == ("embed", "qkv")
    cache = model.init_decode_cache(4, 32, memory_len=7)
    assert isinstance(cache, EncDecCache) and len(cache.kv) == 12
    assert cache.memory.shape == (4, 7, 1024)
    with pytest.raises(ValueError, match="encoder-decoder"):
        EncDec(get_config("qwen3-1.7b", reduced=True), {})


def test_convert_carries_the_reference_tree_both_ways(pair):
    """Every stacked ``encoder/...`` and ``decoder/...`` leaf one layer at
    a time, and back: the reference's tree bit for bit; a missing leaf
    raises."""
    numpy_params = jax.tree_util.tree_map(np.asarray, pair["jp"])
    back = model_params_to_numpy(pair["module"])
    flat = jax.tree_util.tree_leaves_with_path(numpy_params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)
    assert pair["module"].encoder[1].attn.wq.shape == (256, 256)
    np.testing.assert_array_equal(
        pair["module"].decoder[1].cross_attn.wk.detach().numpy(),
        numpy_params["decoder"]["cross_attn"]["wk"][1])
    del numpy_params["enc_norm"]
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(numpy_params, pair["cfg"], device="cpu")


# ---------------------------------------------------------------------------
# Attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, S, S + 7, 5])
def test_encode_matches_reference(pair, window):
    """Window 0 and windows that cover the frames take the flash dispatch;
    a narrower window computes the masked ``_sdpa``, counted."""
    b = _batch(1)
    want = jencdec.encode(pair["jp"], jnp.asarray(b["frames"]),
                          pair["jcfg"], window=window)
    frames = torch.from_numpy(b["frames"])
    before = tattn.DISPATCH_COUNTS["bidir_window_sdpa"]
    with torch.no_grad():
        plain = pair["module"].encode(frames, window=window)
        flash = pair["module"].encode(frames, window=window, use_flash=True)
    banded = 0 < window < S
    assert tattn.DISPATCH_COUNTS["bidir_window_sdpa"] - before == (
        pair["cfg"].n_encoder_layers if banded else 0)
    assert rel_l2(plain, want) <= REL and rel_l2(flash, want) <= REL


@pytest.mark.parametrize("use_flash", [False, True])
def test_bidir_and_cross_attention_match_reference(pair, use_flash):
    """``attention_bidir`` (no window, and a narrower one) and
    ``cross_attention`` of L queries (and of one) against S memory rows."""
    cfg = pair["cfg"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    q = rng.standard_normal((B, L, 256)).astype(np.float32)
    jenc = jax.tree_util.tree_map(lambda a: a[0], pair["jp"]["encoder"])
    jdec = jax.tree_util.tree_map(lambda a: a[1], pair["jp"]["decoder"])
    enc = pair["module"].encoder[0].tensors()
    dec = pair["module"].decoder[1].tensors()
    with torch.no_grad():
        for window in (0, 6):
            got = tattn.attention_bidir(enc["attn"], torch.from_numpy(x), cfg,
                                        window=window, use_flash=use_flash)
            want = jattn.attention_bidir(jenc["attn"], jnp.asarray(x),
                                         pair["jcfg"], window=window)
            assert rel_l2(got, want) <= REL
        for n in (L, 1):
            got = tattn.cross_attention(dec["cross_attn"],
                                        torch.from_numpy(q[:, :n]),
                                        torch.from_numpy(x), cfg,
                                        use_flash=use_flash)
            want = jattn.cross_attention(jdec["cross_attn"],
                                         jnp.asarray(q[:, :n]),
                                         jnp.asarray(x), pair["jcfg"])
            assert got.shape == (B, n, 256)
            assert rel_l2(got, want) <= REL


def test_flash_dispatch_is_non_causal_with_lq_not_lk(pair, monkeypatch):
    """With ``use_flash`` every encoder and cross-attention call reaches the
    module's ``flash_attention`` name non-causal (cross: ``Lq != Lk``), and
    the decoder's self-attention causal."""
    calls = []

    def spy(q, k, v, *, causal=True, window=0):
        calls.append((q.shape[1], k.shape[1], causal))
        return fk.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    b = _tb(_batch(3))
    with torch.no_grad():
        pair["module"].forward_train(b, use_flash=True)
    n_enc, n_dec = pair["cfg"].n_encoder_layers, pair["cfg"].n_layers
    assert calls[:n_enc] == [(S, S, False)] * n_enc
    assert calls[n_enc:] == [(L, L, True), (L, S, False)] * n_dec


# ---------------------------------------------------------------------------
# Forward, decode, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_train_logits(pair, use_flash):
    b = _batch(4)
    jl, _ = pair["jm"].forward_train(pair["jp"], _jb(b))
    with torch.no_grad():
        tl, aux = pair["module"].forward_train(_tb(b), use_flash=use_flash)
    assert tl.shape == (B, L, 512) == jl.shape
    assert rel_l2(tl, jl) <= REL
    assert aux["moe_aux"] == 0.0


def test_stepwise_decode_matches_reference_forward(pair):
    """The reference's ``test_encdec_decode_consistency``: the port's
    decode, token by token against the reference's memory, equals the
    reference's training forward."""
    b = _batch(5, n_tokens=12)
    full, _ = pair["jm"].forward_train(pair["jp"], _jb(b))
    memory = jencdec.encode(pair["jp"], jnp.asarray(b["frames"]),
                            pair["jcfg"])
    cache = pair["tm"].init_decode_cache(B, 32, memory_len=S)
    cache = cache._replace(memory=torch.from_numpy(np.array(memory)))
    step = build_serve_step(pair["tm"])
    outs = []
    for t in range(b["tokens"].shape[1]):
        lg, cache = step(pair["module"], cache, {"tokens": torch.from_numpy(
            b["tokens"][:, t:t + 1]).long()})
        outs.append(lg[:, 0].numpy())
    assert all(c.pos == 12 for c in cache.kv)
    np.testing.assert_allclose(np.stack(outs, 1), np.asarray(full),
                               **DECODE_TOL)


def test_loss_and_gradients_match_reference(pair):
    """``model.loss`` on {frames, tokens, labels} and its autograd
    gradients against ``jax.grad`` of the reference's, a leaf at a time."""
    b = _batch(6)
    jloss, jparts = pair["jm"].loss(pair["jp"], _jb(b))
    jgrad = jax.grad(lambda p: pair["jm"].loss(p, _jb(b))[0])(pair["jp"])
    _, _, tm, module = port_pair()
    loss, parts = tm.loss(module, _tb(b))
    assert rel_l2(loss, jloss) <= REL and rel_l2(parts["ce"], jparts["ce"]) \
        <= REL
    loss.backward()
    want = EncDec(tm.cfg, model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrad), tm.cfg, device="cpu"))
    ref = dict(want.named_parameters())
    names = [n for n, _ in module.named_parameters()]
    assert "encoder.0.attn.wq" in names and "decoder.1.ln_x.scale" in names
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert rel_l2(p.grad, ref[name].detach()) <= GRAD_REL, name


def test_remat_forward_and_gradients_equal_without(pair):
    """``cfg.remat`` checkpoints each encoder and decoder block: the same
    loss and gradients bit for bit."""
    b = _tb(_batch(7))
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(pair["cfg"], remat=remat)
        module = EncDec(cfg, model_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, pair["jp"]), cfg,
            device="cpu"))
        loss, _ = build_model(cfg, device="cpu").loss(module, b)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      module.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


# ---------------------------------------------------------------------------
# Step builders and serving
# ---------------------------------------------------------------------------

def test_prefill_step_matches_reference(pair):
    """``build_prefill_step``: the encoder under the config's long-context
    window (it covers the frames: the flash dispatch) and the decoder's
    prompt against the memory; last-position logits and the memory."""
    # the reference's steps module imports its training package first
    import repro.training  # noqa: F401
    from repro.launch.steps import build_prefill_step as j_prefill_step
    b = _batch(8)
    jl, jmem = j_prefill_step(pair["jm"], 64)(pair["jp"], _jb(
        {k: b[k] for k in ("frames", "tokens")}))
    before = tattn.DISPATCH_COUNTS["bidir_window_sdpa"]
    tl, tmem = build_prefill_step(pair["tm"], 64)(pair["module"], _tb(
        {k: b[k] for k in ("frames", "tokens")}))
    assert tattn.DISPATCH_COUNTS["bidir_window_sdpa"] == before
    assert tl.shape == (B, 1, 512) and tmem.shape == (B, S, 256)
    assert tl.is_inference() and not tl.requires_grad
    assert rel_l2(tl, jl) <= REL and rel_l2(tmem, jmem) <= REL


def test_other_families_prefill_step_is_forward_prefill():
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = build_model(cfg, device="cpu")
    params, _ = model.init(seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    lg, caches = build_prefill_step(model, 16)(params, {"tokens": toks})
    with torch.no_grad():
        want, _ = model.forward_prefill(params, {"tokens": toks}, 16)
    assert torch.equal(lg, want) and len(caches) == cfg.n_layers


def test_batched_server_greedy_tokens_match_reference(pair):
    """Token-by-token prompts against a given memory: the same greedy
    tokens as the reference's server; ``prefill`` gives the logits after
    the last prompt token, equal to the training forward's there."""
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, 512, (B, 8)).astype(np.int32)
    memory = rng.standard_normal((B, 32, 256)).astype(np.float32)
    want = JServer(pair["jm"], pair["jp"], JServeConfig(
        max_new_tokens=6, cache_capacity=32)).generate(
        jnp.asarray(prompts), extra={"memory": jnp.asarray(memory)})
    srv = BatchedServer(pair["tm"], pair["module"], ServeConfig(
        max_new_tokens=6, cache_capacity=32))
    extra = {"memory": torch.from_numpy(memory)}
    got = srv.generate(torch.from_numpy(prompts), extra=extra)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.inference_mode():
        last, cache = srv.prefill(torch.from_numpy(prompts).long(), extra)
    full, _ = pair["jm"].forward_train(pair["jp"], {
        "tokens": jnp.asarray(prompts)}, memory=jnp.asarray(memory))
    np.testing.assert_allclose(last[:, 0].numpy(), np.asarray(full)[:, -1],
                               **DECODE_TOL)
    assert all(c.pos == 8 for c in cache.kv)
    assert torch.equal(cache.memory, extra["memory"])


def test_serve_launcher_runs_the_encdec(capsys, tmp_path):
    from repro_torch.launch.serve import main
    from repro_torch.training import save_checkpoint
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--max-new", "3", "--cache", "16"]
    out = main(argv)
    assert tuple(out.shape) == (2, 3)
    assert ((out >= 0) & (out < 512)).all()
    assert capsys.readouterr().out.splitlines()[0].startswith(
        "generated (2, 3) in ")
    # --ckpt restores the enc-dec as it does every family: the seed's own
    # weights through a checkpoint serve the same tokens
    with pytest.raises(FileNotFoundError):
        main(argv + ["--ckpt", str(tmp_path / "missing.npz")])
    cfg = get_config(ARCH, reduced=True)
    params, _ = build_model(cfg, device="cpu").init(seed=0)
    ck = str(tmp_path / "seed0.npz")
    save_checkpoint(ck, params, step=3)
    again = main(argv + ["--ckpt", ck])
    assert "(step 3)" in capsys.readouterr().out
    assert torch.equal(again, out)


def test_flash_drift_of_the_prefill_step_on_the_cpu(pair):
    """``serve_drift.flash_drift`` holds each of the prefill step's flash
    calls (encoder, decoder self, cross) against the plain version; on the
    CPU both runs take the plain version, so nothing drifts."""
    from repro_torch.serve_drift import flash_drift, serve_drift
    b = _tb(_batch(10))
    step = build_prefill_step(pair["tm"], 0)
    drift = flash_drift(lambda: step(pair["module"], {
        "frames": b["frames"], "tokens": b["tokens"]})[0], call_tol=1e-6)
    cfg = pair["cfg"]
    assert drift["flash_calls"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert drift["flash_call_max_abs"] == drift["logit_max_abs"] == 0.0
    row = serve_drift(ARCH, reduced=True, device="cpu")
    assert row["flash_calls"] == 6 and row["logit_max_abs"] == 0.0
