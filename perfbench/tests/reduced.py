"""Reduced configurations and traffic for the benchmark's CPU tests: the
shipped files with every size cut, so the program's plain kernel versions
and the reference run in seconds on a CPU."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

DENSE = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 500, "vocab_padded": 512}
PORT = {"dense": lambda m: {
            "n_layers": m["n_layers"], "d_model": m["d_model"],
            "n_heads": m["n_heads"], "n_kv_heads": m["n_kv_heads"],
            "head_dim": m["head_dim"], "d_ff": m["d_ff"],
            "vocab_size": m["vocab_size"]}}


def config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(DENSE)
    cfg["model"]["dtype"] = dtype
    cfg["port"]["fields"].update(PORT[cfg["family"]](cfg["model"]))
    cfg["port"]["fields"]["dtype"] = dtype
    return cfg


def traffic(name: str, seq_len: int = 32, batch: int = 2) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(seq_len=seq_len, batch=batch)
    return t
