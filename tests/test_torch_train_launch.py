"""The training launcher end to end on the CPU: ``launch.train --reduced
--device cpu --rounds 2 --ckpt`` then ``launch.serve --ckpt`` gives the
same greedy tokens as serving the trainer's ``mean_params`` directly (bit
for bit: fp32 weights through an fp32 checkpoint), for reduced
``qwen3-1.7b`` and for the attention-free and hybrid families
(``mamba2-130m``, ``zamba2-2.7b``, prompts of the SSD chunk 32), whose
file the reference's ``restore_checkpoint`` reads bit for bit into its
own init params.  The enc-dec stays out of the training launcher, as in
the reference: its token batches carry no ``frames`` (``KeyError``).
Without ``--device cpu`` both launchers raise on a machine with no
card."""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.training import restore_checkpoint as j_restore
from repro_torch.convert import model_params_to_numpy
from repro_torch.launch import serve, train
from repro_torch.models import build_model

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--clients", "2", "--batch",
        "2", "--seq", "16", "--t0", "2", "--topology", "complete"]
SERVE = dict(batch=2, prompt_len=8, max_new=6)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_train_ckpt_then_serve(tmp_path, capsys):
    ck, log = str(tmp_path / "ck.npz"), str(tmp_path / "log.json")
    trainer, state, hist = train.main(
        ARGS + ["--device", "cpu", "--rounds", "2", "--ckpt", ck,
                "--log", log])
    assert state.t == 4 and [h["round"] for h in hist] == [2]
    assert json.load(open(log)) == hist
    out = capsys.readouterr().out
    assert "checkpoint -> " + ck in out and '"loss"' in out

    served = serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                         "cpu", "--ckpt", ck, "--batch", "2",
                         "--prompt-len", "8", "--max-new", "6"])
    assert "(step 2)" in capsys.readouterr().out
    model = build_model(trainer.model.cfg, device="cpu")
    direct = serve.generate(model, trainer.mean_params(state), **SERVE)
    assert served.shape == (2, 6)
    assert torch.equal(served, direct)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_zoo_train_ckpt_then_serve(tmp_path, capsys, arch):
    ck = str(tmp_path / "ck.npz")
    args = ["--arch", arch] + ARGS[2:] + ["--seq", "32", "--device", "cpu",
                                          "--rounds", "1", "--ckpt", ck]
    trainer, state, _ = train.main(args)
    mean = trainer.mean_params(state)
    saved = model_params_to_numpy(mean)

    # the reference reads the launcher's file into its own params
    jp, _ = jbuild(jget(arch, reduced=True)).init(jax.random.PRNGKey(0))
    back, step = j_restore(ck, jp)
    assert step == 1
    jax.tree_util.tree_map(
        lambda a, b: np.asarray(a).tobytes() == b.tobytes()
        or pytest.fail("bits"), back, saved)

    served = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--ckpt", ck, "--batch", "2", "--prompt-len", "32",
                         "--max-new", "6"])
    assert "(step 1)" in capsys.readouterr().out
    direct = serve.generate(build_model(trainer.model.cfg, device="cpu"),
                            mean, **dict(SERVE, prompt_len=32))
    assert served.shape == (2, 6)
    assert torch.equal(served, direct)


def test_encdec_stays_out_of_the_launcher(monkeypatch):
    """The reference's launcher and the port's raise alike for the
    enc-dec: the LM token stream has no frames."""
    args = ["--arch", "seamless-m4t-medium", "--reduced", "--clients", "2",
            "--rounds", "1", "--t0", "2", "--batch", "2", "--seq", "8"]
    with pytest.raises(KeyError, match="frames"):
        train.main(args + ["--device", "cpu"])
    from repro.launch import train as j_train
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    with pytest.raises(KeyError, match="frames"):
        j_train.main()


def test_launchers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(ARGS + ["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
