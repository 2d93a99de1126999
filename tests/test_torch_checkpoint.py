"""Port parity: checkpoints in the reference's format.

The reference's three checkpoint tests, ported (a nested tree round trip
with bf16 and a list, a shape that differs raises ``ValueError``, a
missing leaf ``KeyError``), and checkpoints crossing between the
packages bit for bit: a reduced ``qwen3-1.7b`` written by
``repro.training.save_checkpoint`` restores into the port's Transformer
(fp32 and bf16), a Transformer written by the port restores into the
reference's stacked params, and a flat dotted params dict crosses with
the reference's nested one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.training import restore_checkpoint as j_restore
from repro.training import save_checkpoint as j_save
from repro_torch.configs import get_config
from repro_torch.convert import (model_params_to_numpy,
                                 transformer_params_from_numpy,
                                 transformer_params_to_numpy)
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.training import restore_checkpoint, save_checkpoint


def test_roundtrip_nested(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": [torch.zeros((2,)), torch.full((1,), 7.0)]}}
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree, step=42)
    out, step = restore_checkpoint(path, tree)
    assert step == 42
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert isinstance(out["b"]["d"], list)
    assert torch.equal(out["b"]["d"][1], tree["b"]["d"][1])
    with np.load(path) as data:
        assert sorted(data) == ["__step__", "a", "b/c", "b/d/0", "b/d/1"]
        assert data["b/c"].dtype == np.float32      # bf16 upcast on save


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"w": torch.ones((3, 3))})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"w": torch.ones((2, 2))})


def test_missing_leaf_rejected(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"w": torch.ones((2,))})
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"w": torch.ones((2,)),
                                  "v": torch.ones((2,))})


def _bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_checkpoints_cross_bit_for_bit(tmp_path, dtype):
    jcfg = dataclasses.replace(jget("qwen3-1.7b", reduced=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b", reduced=True),
                               dtype=dtype)
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    f32 = lambda t: jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), t)

    # reference -> port
    path = str(tmp_path / "ref.npz")
    j_save(path, jp, step=7)
    template = Transformer(tcfg, init_params(tcfg, device="meta")[0])
    module, step = restore_checkpoint(path, template, device="cpu")
    assert step == 7 and module.embed["table"].dtype == tcfg.torch_dtype
    got = transformer_params_to_numpy(module, tcfg)
    jax.tree_util.tree_map(lambda a, b: _bits(a, b) or pytest.fail("bits"),
                           got, f32(jp))

    # port -> reference
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, module, step=9)
    back, step = j_restore(path, jp)
    assert step == 9
    jax.tree_util.tree_map(
        lambda a, b: (a.dtype == b.dtype and _bits(f32(a), f32(b)))
        or pytest.fail("bits"), back, jp)
    with np.load(path) as data:
        assert data["blocks/attn/wq"].shape == (
            tcfg.n_layers, tcfg.d_model, tcfg.n_heads * tcfg.hd)

    # port -> port, a real template on the CPU
    again, _ = restore_checkpoint(path, Transformer(
        tcfg, transformer_params_from_numpy(f32(jp), tcfg, device="cpu")))
    for (k, a), (_, b) in zip(again.named_parameters(),
                              module.named_parameters()):
        assert torch.equal(a, b), k


def test_transformer_restore_checks_leaves(tmp_path):
    tcfg = get_config("qwen3-1.7b", reduced=True)
    template = Transformer(tcfg, init_params(tcfg, device="meta")[0])
    path = str(tmp_path / "part.npz")
    np.savez(path, **{"embed/table": np.zeros((512, 256), np.float32)})
    with pytest.raises(KeyError):
        restore_checkpoint(path, template, device="cpu")
    with pytest.raises(ValueError, match="device="):
        restore_checkpoint(path, template)
    wrong = dataclasses.replace(tcfg, n_layers=3)
    j_save(str(tmp_path / "ref.npz"), jbuild(jget("qwen3-1.7b", reduced=True))
           .init(jax.random.PRNGKey(1))[0])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path / "ref.npz"), Transformer(
            wrong, init_params(wrong, device="meta")[0]), device="cpu")


def test_flat_params_dict_crosses_with_nested(tmp_path):
    rng = np.random.default_rng(0)
    nested = {"l0": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                     "b": np.zeros(3, np.float32)},
              "l1": {"w": rng.normal(size=(3, 2)).astype(np.float32)}}
    flat = {"l0.w": torch.from_numpy(nested["l0"]["w"]),
            "l0.b": torch.from_numpy(nested["l0"]["b"]),
            "l1.w": torch.from_numpy(nested["l1"]["w"])}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, flat, step=3)
    back, step = j_restore(path, jax.tree_util.tree_map(jnp.asarray, nested))
    assert step == 3
    for k in ("l0", "l1"):
        for leaf in nested[k]:
            assert _bits(np.asarray(back[k][leaf]), nested[k][leaf])
    path = str(tmp_path / "ref.npz")
    j_save(path, jax.tree_util.tree_map(jnp.asarray, nested), step=4)
    out, step = restore_checkpoint(path, flat)
    assert step == 4 and sorted(out) == sorted(flat)
    for k, v in flat.items():
        assert torch.equal(out[k], v)


ZOO_ARCHS = ["mamba2-130m", "zamba2-2.7b", "seamless-m4t-medium",
             "qwen3-moe-235b-a22b", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_zoo_checkpoints_cross_bit_for_bit(tmp_path, arch, dtype):
    jcfg = dataclasses.replace(jget(arch, reduced=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    jp, _ = jbuild(jcfg).init(jax.random.PRNGKey(0))
    f32 = lambda t: jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32), t)

    # reference -> port, into the family's module built on meta
    ref = str(tmp_path / "ref.npz")
    j_save(ref, jp, step=7)
    template, _ = build_model(tcfg, device="meta").init()
    module, step = restore_checkpoint(ref, template, device="cpu")
    assert step == 7 and type(module) is type(template)
    assert all(p.dtype == tcfg.torch_dtype and p.device.type == "cpu"
               for p in module.parameters())
    jax.tree_util.tree_map(lambda a, b: _bits(a, b) or pytest.fail("bits"),
                           model_params_to_numpy(module), f32(jp))

    # port -> reference
    port = str(tmp_path / "port.npz")
    save_checkpoint(port, module, step=9)
    back, step = j_restore(port, jp)
    assert step == 9
    jax.tree_util.tree_map(
        lambda a, b: (a.dtype == b.dtype and _bits(f32(a), f32(b)))
        or pytest.fail("bits"), back, jp)

    # the same leaf names and shapes as the reference's own file
    with np.load(port) as a, np.load(ref) as b:
        assert {k: a[k].shape for k in a} == {k: b[k].shape for k in b}
        assert all(a[k].dtype == b[k].dtype for k in a)
    if tcfg.family == "hybrid":
        with np.load(port) as a:
            assert a["mamba/mamba/in_proj"].shape[:2] == (
                tcfg.n_layers // tcfg.shared_attn_every,
                tcfg.shared_attn_every - 1)


@pytest.mark.parametrize("tree", [
    {"w": torch.ones(2), "m": torch.nn.Linear(2, 2)},
    torch.nn.Linear(2, 2),
    {"w": torch.ones(2), "s": "text"},
    {"o": np.array([object()])},
], ids=["module-leaf", "module", "str-leaf", "object-array"])
def test_non_tensor_leaf_raises(tmp_path, tree):
    path = tmp_path / "bad.npz"
    with pytest.raises(TypeError, match="checkpoint leaf"):
        save_checkpoint(str(path), tree)
    assert not path.exists() and not list(tmp_path.iterdir())
