"""Where a DEPOSITUM round's time goes on the card: a torch.profiler window.

Profiles ``--rounds`` rounds of the quickstart configuration (the Fig. 4
Polyak MLP point) after ``--warmup`` rounds, fused and unfused, and prints
one JSON line each: host wall time a round (the profiler's own overhead
included), device busy time a round (the sum of the kernels' and copies'
device time; one stream, so no overlap) and its share of the wall, the host time inside each annotated phase
(``fused_kernel``, ``local_step``, ``gossip``) with the rest of the step
(per-client gradients, bookkeeping) as ``other``, and the device kernels
that take the most time.  Then the card's name and power limit.

``--sweep S [S ...]`` profiles sweep rounds of the same MLP instead (fused):
S configurations at once (a ``hyper_grid`` over gamma x alpha around the
Fig. 4 point, S = 1, 4, 16, 64, ...: 2.07 MB of state a configuration),
one line a size, with ``wall_ms_per_config``.

    PYTHONPATH=src python -m repro_torch.profile_round [--rounds 3]
        [--sweep 1 4 16 64]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch._device import resolve_device
from repro_torch.core import MixPlan, hyper_grid, local_then_comm_round
from repro_torch.quickstart import mlp_config, prepare

PHASE_LABELS = ("fused_kernel", "local_step", "gossip")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profile_window(advance, rounds: int, device, top: int = 8) -> dict:
    """Profile ``advance(i)`` for i in range(rounds); returns wall and
    device busy ms a round, the busy share, host ms in each annotated
    phase and the top device kernels."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            advance(i)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()
    # device rows are kernels and copies, plus the GPU-side spans of the
    # annotated phases, which cover kernels already counted: leave them out
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in PHASE_LABELS]
    busy_us = sum(_device_us(e) for e in kernels)
    phases = {label: sum(e.cpu_time_total for e in rows if e.key == label)
              for label in PHASE_LABELS}
    kernels.sort(key=_device_us, reverse=True)
    return {
        "rounds": rounds,
        "wall_ms_per_round": wall_us / rounds / 1e3,
        "device_busy_ms_per_round": busy_us / rounds / 1e3,
        "device_busy_share": busy_us / wall_us,
        "host_phase_ms_per_round": {
            **{k: v / rounds / 1e3 for k, v in phases.items()},
            "other": (wall_us - sum(phases.values())) / rounds / 1e3},
        "top_device_kernels": [
            {"name": e.key[:80], "calls_per_round": e.count / rounds,
             "device_ms_per_round": _device_us(e) / rounds / 1e3}
            for e in kernels[:top]],
    }


def profile_rounds(fused: str, rounds: int = 3, warmup: int = 2,
                   device="cuda", top: int = 8) -> dict:
    """Profile ``rounds`` rounds after ``warmup``; returns the breakdown."""
    dev = resolve_device(device)
    cfg = mlp_config(warmup + rounds, fused=fused)
    p = prepare(cfg, device=dev)
    state = p.state

    def advance(r):
        nonlocal state
        state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn,
                                         cfg.depositum, p.mixer)

    for r in range(warmup):
        advance(r)
    out = profile_window(lambda i: advance(warmup + i), rounds, dev, top)
    return {"phase": "profile", "fused": fused, **out}


def sweep_hypers(S: int, base):
    """An S-point ``hyper_grid`` over gamma x alpha around ``base`` (the
    Fig. 4 point at S = 1): gamma in [0.2, 0.9], alpha in [0.01, 0.1]."""
    if S == 1:
        return hyper_grid(base=base, gamma=[float(base.gamma)])
    n_g = 2 ** math.ceil(math.log2(S) / 2)
    n_a = S // n_g
    if n_g * n_a != S:
        raise ValueError(f"--sweep takes powers of two, got {S}")
    return hyper_grid(base=base,
                      gamma=np.linspace(0.2, 0.9, n_g).tolist(),
                      alpha=np.linspace(0.01, 0.1, n_a).tolist())


def profile_sweep_rounds(S: int, rounds: int = 3, warmup: int = 2,
                         device="cuda", fused: str = "require",
                         top: int = 8) -> dict:
    """Profile sweep rounds of the Fig. 4 MLP at S configurations."""
    from repro_torch.training.sweep import make_sweep_round, sweep_init

    dev = resolve_device(device)
    cfg = mlp_config(warmup + rounds, fused=fused)
    p = prepare(cfg, device=dev)
    hypers = sweep_hypers(S, cfg.depositum.hyper())
    round_fn = make_sweep_round(p.grad_fn, cfg.depositum,
                                MixPlan.dense(p.W, device=dev),
                                batch_axis=None)
    state = sweep_init({k: v[0] for k, v in p.state.x.items()},
                       cfg.n_clients, S)

    def advance(r):
        nonlocal state
        state, _ = round_fn(state, hypers, p.batches(r))

    for r in range(warmup):
        advance(r)
    out = profile_window(lambda i: advance(warmup + i), rounds, dev, top)
    state_mb = sum(v.numel() * v.element_size() for f in ("x", "y", "nu",
                                                          "mu", "g")
                   for v in getattr(state, f).values()) / 1e6
    return {"phase": "profile_sweep", "fused": fused, "S": S,
            "state_mb": state_mb, **out,
            "wall_ms_per_config": out["wall_ms_per_round"] / S}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--sweep", type=int, nargs="+", default=None,
                    metavar="S")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sweep:
        for S in args.sweep:
            print(json.dumps(profile_sweep_rounds(S, args.rounds,
                                                  args.warmup)), flush=True)
    else:
        for fused in ("require", "off"):
            print(json.dumps(profile_rounds(fused, args.rounds,
                                            args.warmup)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
