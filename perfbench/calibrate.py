"""Readings that set a cell's limits, on the chip at the cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds S [S ...]
        [--control N] [--faults half_batch no_mix altered unchanged]
        [--fault-seeds S [S ...]]

For each seed the program runs its first steps as a benchmark run does
(no window) and the reference follows them; one JSON line gives the
compared numbers (mode "sound").  The first ``--control`` seeds also run
the control, the reference computed with fp8 products in the program's
place, against the same float32 reference (mode "control").  Each fault of
``perfbench/faults.py`` runs on each ``--fault-seeds`` seed (mode = its
name).  All in one process: the set-up is paid once.
"""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from perfbench import check  # noqa: E402
from perfbench.faults import FAULTS  # noqa: E402
from perfbench.kinds import train  # noqa: E402
from perfbench.reference import depositum as reference  # noqa: E402
from perfbench.run import load_cell, prepare_environment  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402
from perfbench.feed import TokenFeed  # noqa: E402


def emit(**rec):
    print(json.dumps(rec), flush=True)


def top_leaves(prog: dict, ref: dict, k: int = 6) -> dict:
    """The k leaves with the widest first-gradient gaps (worst client)."""
    names, gap = check.leaf_gaps(prog["grad1"], ref["grad1"])
    worst = gap.max(axis=1)
    order = worst.argsort()[::-1][:k]
    return {names[i]: round(float(worst[i]), 5) for i in order}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    prepare_environment()
    cell = load_cell(args.workload)
    cfg, traffic = cell["cfg"], cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    num = lambda ns: {k: [v[0], v[1]] for k, v in ns.items()}
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        out = train.run(cfg, traffic, {}, seed, None, False, dev, t)
        emit(cell=args.workload, mode="sound", seed=seed,
             numbers=num(out["numbers"]), peak_gb=out["peak_bytes"] / 1e9,
             setup_s=out["setup_s"], reference_s=out["reference_s"],
             top=top_leaves(out["prog"], out["ref"]) if i < args.control else None)
        if i < args.control:
            t = time.perf_counter()
            feed = TokenFeed(traffic, cfg["model"]["vocab_size"], seed)
            specs = reference.family(cfg["family"]).leaf_specs(cfg["model"])
            x0 = make_weights(specs, seed, dev, cfg["model"]["dtype"])
            ctl = reference.follow(
                cfg, traffic, x0,
                lambda s: torch.from_numpy(feed.step_tokens(s)).to(dev),
                precision="fp8")
            del x0
            emit(cell=args.workload, mode="control", seed=seed,
                 numbers=num(check.compare(ctl, out["ref"])),
                 seconds=time.perf_counter() - t, top=top_leaves(ctl, out["ref"]))
        del out
    for name in args.faults:
        for seed in args.fault_seeds:
            t = time.perf_counter()
            out = train.run(cfg, traffic, {}, seed, None, False, dev, t,
                            program_hook=FAULTS[name])
            emit(cell=args.workload, mode=name, seed=seed,
                 numbers=num(out["numbers"]), seconds=time.perf_counter() - t)
            del out


if __name__ == "__main__":
    main()
