"""Port parity: the zoo's transformer families against the reference.

Reduced ``qwen2.5-14b`` (QKV bias), ``minitron-4b`` (GELU), ``grok-1-314b``
and ``qwen3-moe-235b-a22b`` (MoE, head dim 32, qk-norm for the latter) and
``phi-3-vision-4.2b`` (VLM, vision embeds prepended), fp32, with the
reference's parameters (its own ``init``) carried across by
``repro_torch.convert.model_params_from_numpy``.  Also every config of
the zoo, the MoE layer with capacity drops, served greedy tokens and the
launcher for all seven new architectures, and the flash kernel's head-dim
route at the head dims the new configs bring (32, 80, 96).

Tolerances: logits, caches, the MoE output and the losses by relative L2
norm within 1e-5 (the same fp32 operations, sums in another order); step
by step decode against the training forward at atol = rtol = 2e-5, as the
reference's ``tests/test_decode_equivalence.py`` holds its own; gradients
within 1e-4 relative L2 a leaf.  Greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import build_model as jbuild
from repro.models import mlp as jmlp
from repro.serving import BatchedServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.models import build_model
from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models import mlp as tmlp
from repro_torch.serving import BatchedServer, ServeConfig

REL = 1e-5
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_REL = 1e-4
ARCHS = ["qwen2.5-14b", "minitron-4b", "grok-1-314b", "qwen3-moe-235b-a22b",
         "phi-3-vision-4.2b"]
NEW_ARCHS = ARCHS + ["mamba2-130m", "zamba2-2.7b"]
# the reference's fields that the port leaves out: its layer-scan knobs
SCAN_ONLY = {"scan_unroll", "max_decode_cache"}
B, L = 2, 17


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


def _batch(cfg, seed, n_tokens=L):
    """numpy tokens / labels (and a VLM's vision embeds) from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(
        np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(
             np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def port_pair(arch, cfg_edit=None):
    """(reference model, its params, port model, port module) for the
    reduced ``arch``, the same weights on both sides."""
    jcfg, tcfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    if cfg_edit:
        jcfg, tcfg = (dataclasses.replace(c, **cfg_edit) for c in (jcfg, tcfg))
    jm = jbuild(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    numpy_params = jax.tree_util.tree_map(np.asarray, jp)
    tm = build_model(tcfg, device="cpu")
    mod = {"ssm": ssm.SSM, "hybrid": hybrid.Hybrid}.get(
        tcfg.family, transformer.Transformer)
    module = mod(tcfg, model_params_from_numpy(numpy_params, tcfg,
                                               device="cpu"))
    return jm, jp, tm, module


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jm, jp, tm, module = port_pair(request.param)
    return dict(arch=request.param, cfg=tm.cfg, jm=jm, jp=jp, tm=tm,
                module=module)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_every_config_matches_the_reference():
    """All ten architectures, full and reduced: every field of the port's
    config equals the reference's (the dtype as a name), the only
    reference fields left out are the scan knobs, and the parameter counts
    are equal.  Only the encoder-decoder arch waits for its slice."""
    tbase._ensure_loaded()
    assert sorted(tbase._REGISTRY) == sorted(jlist())
    assert list_archs() == sorted(set(jlist()) - {"seamless-m4t-medium"})
    for arch in jlist():
        for reduced in (False, True):
            j = jget(arch, reduced)
            entry = tbase._REGISTRY[arch]
            t = entry.reduced if reduced else entry.full
            names = {f.name for f in dataclasses.fields(t)}
            assert {f.name for f in dataclasses.fields(j)} - names \
                == SCAN_ONLY
            for name in names:
                assert getattr(t, name) == getattr(j, name), (arch, name)
            assert t.torch_dtype == getattr(torch, j.dtype)
            for prop in ("hd", "ssm_inner", "ssm_heads"):
                assert getattr(t, prop) == getattr(j, prop), (arch, prop)
            assert t.param_count() == j.param_count(), arch
            assert t.active_param_count() == j.active_param_count(), arch
            if arch == "seamless-m4t-medium":
                with pytest.raises(NotImplementedError, match="encoder"):
                    get_config(arch, reduced)
            else:
                assert get_config(arch, reduced) is t


def test_published_widths_and_counts():
    z = get_config("zamba2-2.7b")
    assert (z.hd, hybrid.group_shape(z)) == (80, (9, 5))
    assert get_config("phi-3-vision-4.2b").hd == 96
    assert get_config("grok-1-314b", reduced=True).hd == 32
    moe = get_config("qwen3-moe-235b-a22b")
    assert moe.active_param_count() < moe.param_count() // 10
    # the reference's count takes n_layers = 54 Mamba2 layers for the
    # hybrid; the model holds 9 groups x 5 = 45: it over-counts 9 layers
    # of 39.88 M (359 M), and the port copies the formula as it stands
    params, _ = hybrid.init_params(z, device="meta")
    held = sum(len(group) for group in params["mamba"])
    per_layer = z._ssm_layer_params()
    assert (held, per_layer) == (45, 39_875_232)
    d, V = z.d_model, z.vocab_size
    shared = 4 * d * d + 3 * d * z.d_ff          # attention + SwiGLU, once
    assert z.param_count() == 54 * per_layer + shared + 2 * V * d
    assert (z.n_layers - held) * per_layer == 358_877_088


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_build_model_init_every_family(arch):
    """``build_model(...).init`` on every new family (reduced, CPU): the
    axes tree mirrors the params, and each leaf has the reference's shape
    (through the converter, which checks every leaf)."""
    cfg = get_config(arch, reduced=True)
    module, axes = build_model(cfg, device="cpu").init(seed=1)
    jp, _ = jbuild(jget(arch, reduced=True)).init(jax.random.PRNGKey(1))
    ref = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    got = dict(module.named_parameters())
    ref_module = type(module)(cfg, ref)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in ref_module.named_parameters()}
    for leaf in jax.tree_util.tree_leaves(
            axes, is_leaf=lambda x: isinstance(x, tuple)):
        assert isinstance(leaf, tuple)


def test_init_params_default_to_the_card():
    """Every family's ``init_params`` defaults to ``"cuda"`` through
    ``resolve_device``: without a card it raises, and never falls back."""
    import inspect
    for init in (transformer.init_params, ssm.init_params,
                 hybrid.init_params):
        assert inspect.signature(init).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="is_available"):
                init(get_config("qwen3-1.7b", reduced=True)
                     if init is transformer.init_params else
                     get_config("mamba2-130m" if init is ssm.init_params
                                else "zamba2-2.7b", reduced=True))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _dropped_rows(jcfg, x, router):
    """Rows the reference's dispatch drops, from its own routing."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ router,
                           axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    counts = np.bincount(np.asarray(idx).ravel(),
                         minlength=jcfg.n_experts)
    C = max(1, int(jcfg.capacity_factor * x.shape[0] * x.shape[1]
                   * jcfg.experts_per_token / jcfg.n_experts))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen3-moe-235b-a22b"])
def test_moe_layer_matches_reference_with_drops(arch):
    """One MoE layer (capacity factor 1.25) on a router drawn wide and
    inputs off zero, so that routing is skewed and experts overflow:
    output and aux loss equal the reference's."""
    jcfg, tcfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    rng = np.random.default_rng(5)
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(2))
    p = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                               jp["blocks"]["moe"])
    p["router"] = rng.standard_normal(p["router"].shape).astype(np.float32)
    x = (rng.standard_normal((2, 24, tcfg.d_model)) + 1.0).astype(np.float32)
    assert _dropped_rows(jcfg, x, p["router"]) > 0
    want, want_aux = jmlp.moe(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg)
    got, aux = tmlp.moe({k: torch.tensor(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg)
    assert rel_l2(got, want) <= REL
    assert abs(float(aux) - float(want_aux)) <= REL * abs(float(want_aux))


def test_moe_ties_break_to_the_lower_index():
    """A zero router makes every expert's probability equal: the port's
    top-k picks experts 0..K-1 for every token, as ``jax.lax.top_k`` does,
    and the layer equals the reference's (the capacity then drops every
    row past C of experts 0 and 1)."""
    jcfg = jget("grok-1-314b", reduced=True)
    tcfg = get_config("grok-1-314b", reduced=True)
    probs = torch.full((5, 4), 0.25)
    vals, idx = tmlp.top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert torch.equal(idx, torch.tensor([[0, 1]] * 5))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(3))
    p = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                               jp["blocks"]["moe"])
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(6).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32)
    want, want_aux = jmlp.moe(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg)
    got, aux = tmlp.moe({k: torch.tensor(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg)
    assert rel_l2(got, want) <= REL
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


# ---------------------------------------------------------------------------
# The transformer families: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_train_and_loss(pair):
    cfg, b = pair["cfg"], _batch(pair["cfg"], 7)
    jl, jaux = pair["jm"].forward_train(pair["jp"], _jb(b))
    jloss, jparts = pair["jm"].loss(pair["jp"], _jb(b))
    with torch.no_grad():
        tl, aux = pair["module"].forward_train(_tb(b))
        tloss, parts = pair["tm"].loss(pair["module"], _tb(b))
    n_vis = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    assert tl.shape == (B, n_vis + L, jl.shape[-1])
    assert rel_l2(tl, jl) <= REL
    assert rel_l2(aux["moe_aux"], jaux["moe_aux"]) <= REL
    assert rel_l2(tloss, jloss) <= REL
    assert rel_l2(parts["ce"], jparts["ce"]) <= REL
    if cfg.family == "moe":
        assert float(aux["moe_aux"]) > 0
        assert float(tloss) > float(parts["ce"])


@pytest.mark.parametrize("cap_kind", ["full", "ring"])
def test_prefill_logits_and_caches(pair, cap_kind):
    cfg = pair["cfg"]
    b = _batch(cfg, 8)
    del b["labels"]
    total = L + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    cap = total + 5 if cap_kind == "full" else total // 2 + 1
    jl, jc = pair["jm"].forward_prefill(pair["jp"], _jb(b), cap)
    with torch.no_grad():
        tl, tc = pair["module"].forward_prefill(_tb(b), cap)
    assert tl.shape == jl.shape == (B, 1, jl.shape[-1])
    assert rel_l2(tl, jl) <= REL
    assert len(tc) == cfg.n_layers
    for i, c in enumerate(tc):
        assert c.pos == int(jc.pos[i]) == total
        assert rel_l2(c.k, jc.k[i]) <= REL and rel_l2(c.v, jc.v[i]) <= REL


def _stepwise(decode, toks, cache):
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = decode({"tokens": torch.from_numpy(
            toks[:, t:t + 1]).long()}, cache)
        outs.append(lg[:, 0].numpy())
    return np.stack(outs, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_stepwise_decode_matches_reference_forward(arch):
    """The port's decode, token by token, against the reference's training
    forward.  MoE at capacity factor 8, as the reference's own test: no
    drops, so decode (T = B tokens a step) routes as the forward does.
    The VLM prefills one token after its vision embeds, then decodes."""
    edit = ({"capacity_factor": 8.0} if get_config(arch, True).n_experts
            else None)
    jm, jp, tm, module = port_pair(arch, edit)
    cfg = tm.cfg
    b = _batch(cfg, 9)
    del b["labels"]
    full, _ = jm.forward_train(jp, _jb(b))
    full = np.asarray(full)
    toks = b["tokens"]
    with torch.inference_mode():
        if cfg.family == "vlm":
            full = full[:, cfg.n_vision_tokens:]
            first = dict(_tb(b), tokens=torch.from_numpy(toks[:, :1]).long())
            lg, cache = module.forward_prefill(first, 64)
            got = np.concatenate([lg[:, -1:].numpy(), _stepwise(
                module.forward_decode, toks[:, 1:], cache)], 1)[:, :-1]
            full = full[:, :-1]
        else:
            got = _stepwise(module.forward_decode, toks,
                            module.init_decode_cache(B, 64))
    np.testing.assert_allclose(got, full, **DECODE_TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "grok-1-314b",
                                  "phi-3-vision-4.2b"])
def test_gradients_match_reference(arch):
    """``autograd`` of the port's ``model.loss`` against ``jax.grad`` of the
    reference's: the second dense slice (GELU), MoE (router and experts,
    through the aux loss) and VLM (vision positions sliced off), a leaf at
    a time."""
    jm, jp, tm, module = port_pair(arch)
    b = _batch(tm.cfg, 10)
    jgrad = jax.grad(lambda p: jm.loss(p, _jb(b))[0])(jp)
    want = type(module)(tm.cfg, model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrad), tm.cfg, device="cpu"))
    loss, _ = tm.loss(module, _tb(b))
    loss.backward()
    ref = dict(want.named_parameters())
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert rel_l2(p.grad, ref[name].detach()) <= GRAD_REL, name


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_batched_server_greedy_tokens_match_reference(arch):
    """Greedy tokens of ``BatchedServer.generate`` equal the reference's
    for every new architecture (prompt 32, a multiple of the reduced SSD
    chunk; the VLM's vision embeds through ``extra``)."""
    jm, jp, tm, module = port_pair(arch)
    cfg = tm.cfg
    b = _batch(cfg, 11, n_tokens=32)
    extra = ({"vision_embeds": b["vision_embeds"]} if cfg.family == "vlm"
             else None)
    cap = 64
    want = JServer(jm, jp, JServeConfig(max_new_tokens=6, cache_capacity=cap)
                   ).generate(jnp.asarray(b["tokens"]),
                              extra=extra and _jb(extra))
    got = BatchedServer(tm, module, ServeConfig(
        max_new_tokens=6, cache_capacity=cap)).generate(
        torch.from_numpy(b["tokens"]), extra=extra and _tb(extra))
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_runs_every_new_arch(arch, capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "32", "--max-new", "3", "--cache",
                "64"])
    assert tuple(out.shape) == (2, 3)
    assert ((out >= 0) & (out < 512)).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated (2, 3) in ")


# ---------------------------------------------------------------------------
# The flash kernel's head-dim route
# ---------------------------------------------------------------------------

def test_padded_head_dims():
    assert [fk.padded_head_dim(d) for d in (1, 32, 64, 65, 80, 96, 128, 200,
                                            256)] == [64, 64, 64, 128, 128,
                                                      128, 128, 256, 256]
    for bad in (0, 257, 512):
        with pytest.raises(ValueError, match="head dim"):
            fk.padded_head_dim(bad)


@pytest.mark.parametrize("D", [32, 80, 96])
def test_pad_head_dim_equals_the_unpadded_call(D):
    """The route's pad-and-slice around ``flash_attention_plain`` equals the
    plain call at the true D, and the reference's ``attention_ref``:
    causal, windowed, GQA groups, ``Lq != Lk`` both ways.  (On the CPU
    the dispatch runs the plain version, so the route itself runs only
    on the card.)"""
    rng = np.random.default_rng(D)
    for Lq, Lk, H, KV in ((17, 17, 4, 2), (9, 23, 8, 1), (30, 12, 4, 4)):
        q = rng.standard_normal((2, Lq, H, D)).astype(np.float32)
        k, v = (rng.standard_normal((2, Lk, KV, D)).astype(np.float32)
                for _ in range(2))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        for causal, window in ((True, 0), (True, 5), (False, 0)):
            got = fk.pad_head_dim(fk.flash_attention_plain, tq, tk, tv,
                                  causal=causal, window=window)
            assert got.shape == tq.shape and got.is_contiguous()
            plain = fk.flash_attention_plain(tq, tk, tv, causal=causal,
                                             window=window)
            torch.testing.assert_close(got, plain, atol=1e-6, rtol=1e-6)
            if Lq == Lk:  # the reference's mask is built for Lq = Lk
                want = j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
                assert rel_l2(got, want) <= REL


def test_serve_drift_holds_each_call_and_measures_the_logits(monkeypatch):
    """``serve_drift`` on the CPU: both prefills take the plain version, so
    every call agrees and the logits do not drift; a wrong attention in
    place of the kernel fails the per-call hold."""
    from repro_torch import serve_drift as sd
    cfg = get_config("grok-1-314b", reduced=True)
    (row,) = sd.main(["--arch", "grok-1-314b", "--reduced", "--device",
                      "cpu"])
    assert row["flash_calls"] == cfg.n_layers and row["logits"] == 4 * 512
    assert row["flash_call_max_abs"] == row["logit_max_abs"] == 0.0
    assert row["logits_beyond"] == 0 and row["top1_agreement"] == 1.0
    model = build_model(cfg, device="cpu")
    params, _ = model.init(seed=0)
    srv = BatchedServer(model, params, ServeConfig(cache_capacity=32))
    prompts = torch.zeros((1, 8), dtype=torch.long)
    monkeypatch.setattr(
        "repro_torch.models.attention.flash_attention",
        lambda q, k, v, **kw: 1.01 * fk.flash_attention_plain(q, k, v, **kw))
    drift = sd.prefill_drift(srv, prompts)
    assert drift["flash_call_max_abs"] > 0 and drift["logit_max_abs"] > 0
    with pytest.raises(AssertionError, match="flash call 0"):
        sd.prefill_drift(srv, prompts, call_tol=1e-6)
