"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but absent.

    Entry points default to ``"cuda"``.  There is no silent CPU fallback:
    a caller that wants the CPU (the tests do) passes ``device="cpu"``, and
    every kernel then runs its plain PyTorch version.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
