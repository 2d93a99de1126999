"""Port parity: Mamba2 / SSD, the SSM language model and the zamba2 hybrid
against the reference.

Inputs come from numpy seeds; model weights from the reference's own
``init`` at the reduced ``mamba2-130m`` and ``zamba2-2.7b`` configs (head
dim 32, chunk 32), carried across by
``repro_torch.convert.model_params_from_numpy``.  Tolerances as in
``test_torch_zoo.py``: relative L2 within 1e-5 for outputs, states and
caches; step by step decode against the chunked scan or the training
forward at atol = rtol = 2e-5, the reference's own decode tolerance;
gradients within 1e-4 relative L2 a leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import mamba2 as jm2
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import hybrid
from repro_torch.models import mamba2 as tm2
from test_torch_zoo import DECODE_TOL, GRAD_REL, REL, port_pair, rel_l2

B = 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(seed, L, H=4, P=8, N=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, H)).astype(np.float32)
    b, c = (rng.standard_normal((B, L, N)).astype(np.float32)
            for _ in range(2))
    return x, dt, A, b, c


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(chunk):
    args = _ssd_inputs(chunk, 48)
    y, h = tm2.ssd_chunked(*map(torch.from_numpy, args), chunk)
    jy, jh = jm2.ssd_chunked(*map(jnp.asarray, args), chunk)
    assert rel_l2(y, jy) <= REL and rel_l2(h, jh) <= REL
    with pytest.raises(ValueError, match="not divisible"):
        tm2.ssd_chunked(*map(torch.from_numpy, args), 20)


def test_ssd_decode_steps_match_the_chunked_scan():
    """The O(1) recurrence, token by token, against the chunked scan: every
    output, and the final state."""
    x, dt, A, b, c = map(torch.from_numpy, _ssd_inputs(3, 32))
    y, h = tm2.ssd_chunked(x, dt, A, b, c, 8)
    state = torch.zeros_like(h)
    ys = []
    for t in range(x.shape[1]):
        yt, state = tm2.ssd_decode_step(state, x[:, t], dt[:, t], A, b[:, t],
                                        c[:, t])
        ys.append(yt)
    torch.testing.assert_close(torch.stack(ys, 1), y, **DECODE_TOL)
    torch.testing.assert_close(state, h, **DECODE_TOL)
    jy, jstate = jm2.ssd_decode_step(*(jnp.asarray(a) for a in (
        np.zeros(h.shape, np.float32), x[:, 0], dt[:, 0], A, b[:, 0],
        c[:, 0])))
    assert rel_l2(ys[0], jy) <= REL


@pytest.fixture(scope="module")
def layer():
    """One reduced mamba2-130m layer's params, both sides."""
    jcfg, tcfg = jget("mamba2-130m", True), get_config("mamba2-130m", True)
    from repro.models import build_model as jbuild
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(4))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mamba"])
    tl = {k: torch.from_numpy(np.array(v)) for k, v in jl.items()}
    return jcfg, tcfg, jl, tl


def test_causal_conv_matches_reference(layer):
    jcfg, tcfg, jl, tl = layer
    x = np.random.default_rng(1).standard_normal(
        (B, 40, jl["conv_w"].shape[1])).astype(np.float32)
    b = np.random.default_rng(2).standard_normal(
        jl["conv_b"].shape).astype(np.float32)
    got = tm2._causal_conv_train(torch.from_numpy(x), tl["conv_w"],
                                 torch.from_numpy(b))
    want = jm2._causal_conv_train(jnp.asarray(x), jl["conv_w"],
                                  jnp.asarray(b))
    assert rel_l2(got, want) <= REL


def test_mamba_block_and_decode_match_reference(layer):
    """The full-sequence block (output, conv cache, SSD state) and then two
    decode steps from its cache, against the reference's."""
    jcfg, tcfg, jl, tl = layer
    rng = np.random.default_rng(7)
    u = rng.standard_normal((B, 64, tcfg.d_model)).astype(np.float32)
    out, cache = tm2.mamba_block(tl, torch.from_numpy(u), tcfg)
    jout, jcache = jm2.mamba_block(jl, jnp.asarray(u), jcfg)
    assert rel_l2(out, jout) <= REL
    assert rel_l2(cache.conv, jcache.conv) <= REL
    assert rel_l2(cache.ssd, jcache.ssd) <= REL
    for t in range(2):
        step = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        out, cache = tm2.mamba_decode(tl, torch.from_numpy(step), cache,
                                      tcfg)
        jout, jcache = jm2.mamba_decode(jl, jnp.asarray(step), jcache, jcfg)
        assert rel_l2(out, jout) <= REL
        assert rel_l2(cache.conv, jcache.conv) <= REL
        assert rel_l2(cache.ssd, jcache.ssd) <= REL


# ---------------------------------------------------------------------------
# The SSM and hybrid models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mamba2-130m", "zamba2-2.7b"])
def model(request):
    jm, jp, tm, module = port_pair(request.param)
    return dict(arch=request.param, cfg=tm.cfg, jm=jm, jp=jp, tm=tm,
                module=module)


def _toks(cfg, seed, L):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def _t(a):
    return torch.from_numpy(a).long()


def test_forward_train_matches_reference(model):
    toks = _toks(model["cfg"], 1, 64)
    jl, _ = model["jm"].forward_train(model["jp"], {"tokens": jnp.asarray(
        toks)})
    with torch.no_grad():
        tl, aux = model["module"].forward_train({"tokens": _t(toks)})
    assert rel_l2(tl, jl) <= REL
    assert float(aux["moe_aux"]) == 0.0


def _each_cache(cfg, tc, jc):
    """(port, reference) pairs of every cache tensor."""
    if cfg.family == "ssm":
        for i, c in enumerate(tc):
            yield c.conv, jc.conv[i]
            yield c.ssd, jc.ssd[i]
        return
    for g, group in enumerate(tc.mamba):
        for j, c in enumerate(group):
            yield c.conv, jc.mamba.conv[g, j]
            yield c.ssd, jc.mamba.ssd[g, j]
    for g, kv in enumerate(tc.kv):
        assert kv.pos == int(jc.kv.pos[g])
        yield kv.k, jc.kv.k[g]
        yield kv.v, jc.kv.v[g]


def test_prefill_caches_then_decode_match_reference(model):
    """Prefill of a chunk-multiple prompt: logits and every cache (conv
    inputs, SSD states; the hybrid's shared-block KV caches) against the
    reference's; then three decode steps from those caches."""
    cfg = model["cfg"]
    toks = _toks(cfg, 2, 2 * cfg.ssm_chunk + 3)
    prompt, rest = toks[:, :2 * cfg.ssm_chunk], toks[:, 2 * cfg.ssm_chunk:]
    cap = 96
    jm, jp = model["jm"], model["jp"]
    jl, jc = jm.forward_prefill(jp, {"tokens": jnp.asarray(prompt)}, cap)
    with torch.inference_mode():
        tl, tc = model["module"].forward_prefill({"tokens": _t(prompt)}, cap)
    assert tl.shape == jl.shape and rel_l2(tl, jl) <= REL
    n = 0
    for got, want in _each_cache(cfg, tc, jc):
        assert rel_l2(got, want) <= REL
        n += 1
    if cfg.family == "ssm":
        assert n == 2 * cfg.n_layers
    else:
        n_groups, per_group = hybrid.group_shape(cfg)
        assert n == 2 * n_groups * per_group + 2 * n_groups
    for t in range(rest.shape[1]):
        jl, jc = jm.forward_decode(jp, {"tokens": jnp.asarray(
            rest[:, t:t + 1])}, jc)
        with torch.inference_mode():
            tl, tc = model["module"].forward_decode(
                {"tokens": _t(rest[:, t:t + 1])}, tc)
        assert rel_l2(tl, jl) <= REL


def test_stepwise_decode_matches_reference_forward(model):
    """Token by token from an empty cache against the reference's training
    forward (the reference's own ``test_decode_equivalence`` property)."""
    cfg = model["cfg"]
    toks = _toks(cfg, 3, cfg.ssm_chunk)
    full, _ = model["jm"].forward_train(model["jp"],
                                        {"tokens": jnp.asarray(toks)})
    cache = model["module"].init_decode_cache(B, 64)
    outs = []
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            lg, cache = model["module"].forward_decode(
                {"tokens": _t(toks[:, t:t + 1])}, cache)
            outs.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(outs, 1), np.asarray(full),
                               **DECODE_TOL)


def test_gradients_match_reference(model):
    """``autograd`` of the port's ``model.loss`` against ``jax.grad`` of the
    reference's, a leaf at a time (through the SSD scan's masked ``exp``,
    the depthwise conv and, for the hybrid, the shared block reused by
    every group)."""
    jm, jp, tm, module = model["jm"], model["jp"], model["tm"], \
        model["module"]
    cfg = model["cfg"]
    rng = np.random.default_rng(4)
    b = {k: rng.integers(0, cfg.vocab_size, (B, cfg.ssm_chunk)).astype(
        np.int32) for k in ("tokens", "labels")}
    jgrad = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in
                                           b.items()})[0])(jp)
    want = type(module)(cfg, model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrad), cfg, device="cpu"))
    module.zero_grad()
    loss, _ = tm.loss(module, {k: _t(v) for k, v in b.items()})
    loss.backward()
    ref = dict(want.named_parameters())
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert rel_l2(p.grad, ref[name].detach()) <= GRAD_REL, name
    module.zero_grad()


def test_convert_checks_every_leaf(model):
    """``model_params_from_numpy`` on the SSM's and the hybrid's layouts: a
    leaf left over, one missing, a wrong shape and a stack of the wrong
    depth each raise."""
    cfg = model["cfg"]
    src = jax.tree_util.tree_map(np.asarray, model["jp"])
    key = "blocks" if cfg.family == "ssm" else "mamba"
    with pytest.raises(ValueError, match="left over"):
        model_params_from_numpy(dict(src, stray={"w": np.zeros(3)}), cfg,
                                device="cpu")
    missing = dict(src)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(missing, cfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, src)
    bad["embed"] = {"table": src["embed"]["table"][:, :-1]}
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(bad, cfg, device="cpu")
    shallow = jax.tree_util.tree_map(lambda a: a, src)
    shallow[key] = jax.tree_util.tree_map(lambda a: a[:1], src[key])
    with pytest.raises(ValueError, match="not stacked over"):
        model_params_from_numpy(shallow, cfg, device="cpu")
