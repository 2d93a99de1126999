"""Port parity: the dense decoder and batched serving against the reference.

Reduced ``qwen3-1.7b`` (qk-norm, SwiGLU, GQA 4/2) and reduced
``starcoder2-7b`` (GELU, sliding window 64), fp32, with the reference's
parameters carried across by ``repro_torch.convert``.  Tolerance: atol =
rtol = 1e-4 on logits and caches (the same fp32 operations; matmul sums run
in another order).  Greedy tokens must be identical.  On the CPU the
prefill attention runs the flash kernel's plain version.
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
from repro.models.registry import cross_entropy as j_ce
from repro.serving import BatchedServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models.registry import cross_entropy
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serving import BatchedServer, ServeConfig

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-1.7b", "starcoder2-7b"]
# sequence lengths: starcoder2's exceeds its window of 64 so the window bites
SEQ = {"qwen3-1.7b": 17, "starcoder2-7b": 80}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    jm = jbuild(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jp)
    tm = Transformer(tcfg, transformer_params_from_numpy(
        numpy_params, tcfg, device="cpu"))
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, SEQ[arch])).astype(np.int32)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jm=jm, jp=jp, tm=tm,
                np=numpy_params, toks=toks)


def _tt(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def test_config_matches_reference():
    assert set(ARCHS) <= set(list_archs())
    for arch in ARCHS:
        for reduced in (False, True):
            j, t = jget(arch, reduced), get_config(arch, reduced)
            for f in dataclasses.fields(t):
                if hasattr(j, f.name):
                    assert getattr(t, f.name) == getattr(j, f.name), f.name
            assert t.hd == j.hd and t.param_count() == j.param_count()
            assert t.torch_dtype == getattr(torch, j.dtype)
    full = get_config("qwen3-1.7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab_size) == (28, 2048, 16, 8, 128,
                                                     6144, 151936)
    assert full.tie_embeddings is False and full.torch_dtype == torch.bfloat16
    # the encoder-decoder arch and family build (no prefill: token by token)
    encdec = get_config("seamless-m4t-medium")
    assert encdec.family == "encdec"
    assert build_model(encdec, device="meta").forward_prefill is None
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_forward_train_logits(pair):
    jl, _ = pair["jm"].forward_train(pair["jp"], {"tokens": pair["toks"]})
    with torch.no_grad():
        tl, aux = pair["tm"].forward_train({"tokens": _tt(pair["toks"])})
        tf, _ = pair["tm"].forward_train({"tokens": _tt(pair["toks"])},
                                         use_flash=True)
    assert tl.shape == jl.shape
    _close(tl, jl)
    _close(tf, jl)


def test_attention_train_flash_matches_reference_sdpa(pair):
    cfg = pair["tcfg"]
    x = np.random.default_rng(2).standard_normal(
        (2, SEQ[pair["arch"]], cfg.d_model)).astype(np.float32)
    jp0 = jax.tree_util.tree_map(lambda a: a[0], pair["jp"]["blocks"]["attn"])
    want = jattn.attention_train(jp0, jnp.asarray(x), pair["jcfg"],
                                 use_flash=False)
    with torch.no_grad():
        got = tattn.attention_train(pair["tm"].blocks[0]["attn"],
                                    torch.from_numpy(x), cfg, use_flash=True)
    _close(got, want)


@pytest.mark.parametrize("cap_kind", ["full", "ring"])
def test_prefill_logits_and_cache(pair, cap_kind):
    L = SEQ[pair["arch"]]
    cap = L + 7 if cap_kind == "full" else L // 2 + 1
    jl, jc = pair["jm"].forward_prefill(pair["jp"], {"tokens": pair["toks"]},
                                        cap)
    with torch.no_grad():
        tl, tc = pair["tm"].forward_prefill({"tokens": _tt(pair["toks"])},
                                            cap)
    assert tl.shape == jl.shape == (2, 1, jl.shape[-1])
    _close(tl, jl)
    assert len(tc) == pair["tcfg"].n_layers
    for i, c in enumerate(tc):
        assert c.k.shape == jc.k[i].shape and c.pos == int(jc.pos[i]) == L
        _close(c.k, jc.k[i])
        _close(c.v, jc.v[i])


def _stepwise(model_decode, toks, cache, to_in):
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = model_decode({"tokens": to_in(toks[:, t:t + 1])}, cache)
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1)


def test_stepwise_decode_matches_reference_forward(pair):
    """The reference's decode-equals-forward property, port side: a window-
    sized ring cache for starcoder2, a full one for qwen3."""
    cfg = pair["tcfg"]
    cap = cfg.sliding_window or 64
    jl, _ = pair["jm"].forward_train(pair["jp"], {"tokens": pair["toks"]})
    with torch.inference_mode():
        got = _stepwise(pair["tm"].forward_decode, pair["toks"],
                        pair["tm"].init_decode_cache(2, cap), _tt)
    _close(got, jl)


def test_prefill_then_decode_matches_reference(pair):
    """Prefill into a ring cache smaller than the prompt, then decode."""
    L = SEQ[pair["arch"]]
    prompt, rest = pair["toks"][:, :L - 4], pair["toks"][:, L - 4:]
    cap = (L - 4) // 2 + 3
    jm, jp = pair["jm"], pair["jp"]
    _, jc = jm.forward_prefill(jp, {"tokens": prompt}, cap)
    want = _stepwise(lambda b, c: jm.forward_decode(jp, b, c), rest, jc,
                     jnp.asarray)
    with torch.inference_mode():
        _, tc = pair["tm"].forward_prefill({"tokens": _tt(prompt)}, cap)
        got = _stepwise(pair["tm"].forward_decode, rest, tc, _tt)
    _close(got, want)


def test_batched_server_greedy_tokens_match_reference(pair):
    cfg = pair["tcfg"]
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    cap = 32
    want = JServer(pair["jm"], pair["jp"],
                   JServeConfig(max_new_tokens=8, cache_capacity=cap)
                   ).generate(jnp.asarray(prompts))
    model = build_model(cfg, device="cpu")
    got = BatchedServer(model, pair["tm"],
                        ServeConfig(max_new_tokens=8, cache_capacity=cap)
                        ).generate(torch.from_numpy(prompts))
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded_and_in_range():
    cfg = get_config("qwen3-1.7b", reduced=True)
    model = build_model(cfg, device="cpu")
    params, axes = model.init(seed=0)
    assert axes["blocks"][0]["attn"]["wq"] == ("embed", "qkv")
    prompts = torch.zeros((2, 5), dtype=torch.long)
    runs = [BatchedServer(model, params, ServeConfig(
        max_new_tokens=4, temperature=1.0, cache_capacity=16, seed=7)
    ).generate(prompts) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 512)).all()


def test_init_scales_and_cross_entropy():
    cfg = get_config("qwen3-1.7b", reduced=True)
    params, _ = init_params(cfg, seed=0, device="cpu")
    assert float(params["embed"]["table"].std()) == pytest.approx(0.02, rel=0.05)
    wq = params["blocks"][0]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    assert torch.count_nonzero(params["blocks"][1]["ln1"]["scale"]) == 0
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                    None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits), _tt(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_convert_checks_every_leaf(pair):
    cfg, src = pair["tcfg"], pair["np"]
    extra = dict(src, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="left over"):
        transformer_params_from_numpy(extra, cfg, device="cpu")
    missing = dict(src)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        transformer_params_from_numpy(missing, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, src)
    bad["embed"] = {"table": src["embed"]["table"][:-1]}
    with pytest.raises(ValueError, match="shape"):
        transformer_params_from_numpy(bad, cfg, device="cpu")


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "starcoder2-7b", "--reduced", "--device", "cpu",
          "--batch", "2", "--prompt-len", "70", "--max-new", "3",
          "--cache", "64"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 3) in ")
    assert out[1].startswith("sample: [")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--arch", "qwen3-1.7b", "--reduced"])


def test_profile_serve_reports_each_window():
    from repro_torch.profile_serve import profile_serve
    lines = profile_serve("qwen3-1.7b", reduced=True, batch=2, prompt_len=9,
                          cache=16, steps=2, device="cpu")
    assert [d["phase"] for d in lines] == ["prefill", "decode", "syncs"]
    for d in lines[:2]:
        assert d["wall_ms"] > 0 and d["device_busy_ms"] == 0.0
        assert set(d["device_ms"]) == {"flash", "gemm", "other"}
    assert lines[1]["reps"] == 2 and lines[2]["syncs"] is None
