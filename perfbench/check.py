"""The comparison that decides ``correct`` for a training cell.

Both sides give, for the first steps of the same run (same weights, same
tokens): each step's loss per client, the per-leaf, per-client norm of the
first gradient, and of the parameters' change after the steps the traffic
names.  The numbers compared:

* ``loss``: the largest |loss - ref| / |ref| over steps and clients;
* ``grad1``: the worst leaf's gap of norms, |‖g‖ - ‖g_ref‖| over the
  larger of the reference's norm of that leaf and of the median leaf
  (the median over the client's leaves), worst client;
* ``dx<t>``: the same for ‖x_t - x_0‖ after step t, leaving out the leaves
  whose reference first gradient is under a thousandth of the median
  leaf's (they move by round-off alone);
* ``grad1_med``, ``dx<t>_med``: the median leaf's gap instead of the
  worst's (worst client), steady where one leaf's rounding sets the worst.

The cell's limits name the numbers it compares; one that is missing or
not finite fails.
"""
from __future__ import annotations

import math

import numpy as np

#: a leaf whose first gradient is under this share of the median leaf's
#: is left out of the change
QUIET_LEAF = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves=None):
    """(names, (leaves, clients) gaps) of per-leaf (clients,) norms, or
    None where the program's are missing or not finite."""
    names = [k for k in ref if leaves is None or k in leaves]
    if not names or any(k not in prog for k in names):
        return None
    r = np.stack([np.asarray(ref[k], dtype=np.float64) for k in names])
    p = np.stack([np.asarray(prog[k], dtype=np.float64) for k in names])
    if not np.all(np.isfinite(p)):
        return None
    floor = np.maximum(r, np.median(r, axis=0)[None, :])
    return names, np.abs(p - r) / np.where(floor > 0, floor, np.inf)


def _worst_and_median(out: dict, name: str, found):
    if found is None:
        out[name] = out[name + "_med"] = (math.nan, "missing")
        return
    names, gap = found
    i, c = np.unravel_index(int(np.argmax(gap)), gap.shape)
    out[name] = (float(gap[i, c]), f"{names[i]}[{c}]")
    med = np.median(gap, axis=0)
    c = int(np.argmax(med))
    out[name + "_med"] = (float(med[c]), f"median leaf[{c}]")


def compare(prog: dict, ref: dict) -> dict:
    """name -> (value, where) of every compared number."""
    out = {}
    lp = np.asarray(prog.get("loss", []), dtype=np.float64)
    lr = np.asarray(ref["loss"], dtype=np.float64)
    if lp.shape != lr.shape or not np.all(np.isfinite(lp)):
        out["loss"] = (math.nan, "missing")
    else:
        rel = np.abs(lp - lr) / np.abs(lr)
        s, c = np.unravel_index(int(np.argmax(rel)), rel.shape)
        out["loss"] = (float(rel[s, c]), f"step {s + 1}[{c}]")
    _worst_and_median(out, "grad1", leaf_gaps(prog.get("grad1", {}), ref["grad1"]))
    g1 = {k: float(np.max(v)) for k, v in ref["grad1"].items()}
    med = float(np.median(list(g1.values())))
    moved = {k for k, v in g1.items() if v >= QUIET_LEAF * med}
    for t, ref_dx in ref["dx"].items():
        _worst_and_median(out, f"dx{t}",
                          leaf_gaps(prog.get("dx", {}).get(t, {}), ref_dx, moved))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name present, finite and within its limit."""
    return all(k in numbers and math.isfinite(numbers[k][0])
               and numbers[k][0] <= limits[k] for k in limits)
