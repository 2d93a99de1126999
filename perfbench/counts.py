"""Operations and bytes of the measured work, from a configuration's
logical shapes and dtypes alone (no implementation is read).

FLOPs (training, a token) are a family's own: ``perfbench/work/<family>.py``
gives ``flops_per_token(m, L)``, the whole model's, and
``attention_flops_per_token(m, L)``, its attention's, each of the
configuration's ``model`` block at sequence length L.  Causal attention,
the same in every family that has it: Q K^T and P V over the L (L + 1) / 2
pairs the mask keeps, 2 FLOPs a multiply-add: 2 x 2 x H x D x (L + 1) / 2 a
token forward, x 3 for training (the backward's four products).

Bytes: the state is DEPOSITUM's trees of one leaf a parameter and a row a
client, in the configuration's dtype.  The sweep pair reads x, y, nu and
writes x', nu' (momentum + prox), then reads y, g_new, g_old and writes y'
(tracking): 9 passes over a tree a step.  A gossip step reads and writes
the mixed x and y: 4 passes.
"""
from __future__ import annotations

import importlib
import math

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
SWEEP_TREE_PASSES = 9
GOSSIP_TREE_PASSES = 4
STATE_TREES = 5          # x, y, nu, mu, g


def attention_flops(H: int, D: int, L: int) -> float:
    """Training FLOPs a token of one causal attention over L positions."""
    return 3 * 2 * 2 * H * D * (L + 1) / 2


def work(family: str):
    """The family's work module, ``perfbench/work/<family>.py``."""
    name = f"perfbench.work.{family}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(
            f"family {family!r} has no work counts: add perfbench/work/"
            f"{family}.py with flops_per_token(m, L) and "
            "attention_flops_per_token(m, L)", name=name) from None


def flops_per_token(family: str, m: dict, L: int) -> float:
    """Training FLOPs a token of the whole model (no recomputation)."""
    return work(family).flops_per_token(m, L)


def attention_flops_per_token(family: str, m: dict, L: int) -> float:
    """Training FLOPs a token of the model's attention."""
    return work(family).attention_flops_per_token(m, L)


def param_count(specs) -> int:
    """Parameters of a leaf list ``(name, shape, init, scale)``."""
    return sum(math.prod(s[1]) for s in specs)


def tree_bytes(specs, dtype: str) -> int:
    """Bytes of one client's tree."""
    return param_count(specs) * DTYPE_BYTES[dtype]


def state_bytes(specs, dtype: str, clients: int, trees: int = STATE_TREES) -> int:
    return trees * clients * tree_bytes(specs, dtype)


def sweep_pair_bytes(specs, dtype: str, clients: int) -> int:
    """Least bytes the sweep pair moves in a step."""
    return SWEEP_TREE_PASSES * clients * tree_bytes(specs, dtype)


def gossip_bytes(specs, dtype: str, clients: int) -> int:
    """Least bytes a gossip step moves (the mixed x and y, each read and
    written once)."""
    return GOSSIP_TREE_PASSES * clients * tree_bytes(specs, dtype)
