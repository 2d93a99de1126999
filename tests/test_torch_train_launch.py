"""The training launcher end to end on the CPU: ``launch.train --reduced
--device cpu --rounds 2 --ckpt`` then ``launch.serve --ckpt`` gives the
same greedy tokens as serving the trainer's ``mean_params`` directly (bit
for bit: fp32 weights through an fp32 checkpoint).  Without ``--device
cpu`` both launchers raise on a machine with no card."""
import json

import pytest
import torch

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


def test_launchers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(ARGS + ["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
