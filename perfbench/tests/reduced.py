"""Reduced configurations and traffic for the benchmark's CPU tests: the
shipped files with every size cut, so the program's plain kernel versions
and the reference run in seconds on a CPU.  A family's reduced sizes
(``MODEL``, and ``CARD`` over them on the card) and the program's fields
they set (``port_fields(m)``) are in ``families/<family>.py``."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name: str, dtype: str = "float32", card: bool = False) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    fam = importlib.import_module(f"perfbench.tests.families.{cfg['family']}")
    cfg["model"].update(fam.MODEL)
    if card:
        cfg["model"].update(getattr(fam, "CARD", {}))
    cfg["model"]["dtype"] = dtype
    cfg["port"]["fields"].update(fam.port_fields(cfg["model"]))
    cfg["port"]["fields"]["dtype"] = dtype
    return cfg


def traffic(name: str, seq_len: int = 32, batch: int = 2) -> dict:
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(seq_len=seq_len, batch=batch)
    return t
