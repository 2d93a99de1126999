"""Where a DEPOSITUM round's time goes on the card: a torch.profiler window.

Profiles ``--rounds`` rounds of the quickstart configuration (the Fig. 4
Polyak MLP point) after ``--warmup`` rounds, fused and unfused, and prints
one JSON line each: host wall time a round (the profiler's own overhead
included), device busy time a round (the sum of the kernels' and copies'
device time; one stream, so no overlap) and its share of the wall, the host time inside each annotated phase
(``fused_kernel``, ``local_step``, ``gossip``) with the rest of the step
(per-client gradients, bookkeeping) as ``other``, and the device kernels
that take the most time.  Then the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.profile_round [--rounds 3]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch._device import resolve_device
from repro_torch.core import local_then_comm_round
from repro_torch.quickstart import mlp_config, prepare

PHASE_LABELS = ("fused_kernel", "local_step", "gossip")


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profile_rounds(fused: str, rounds: int = 3, warmup: int = 2,
                   device="cuda", top: int = 8) -> dict:
    """Profile ``rounds`` rounds after ``warmup``; returns the breakdown."""
    dev = resolve_device(device)
    cfg = mlp_config(warmup + rounds, fused=fused)
    p = prepare(cfg, device=dev)
    state = p.state
    for r in range(warmup):
        state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn,
                                         cfg.depositum, p.mixer)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        for r in range(warmup, warmup + rounds):
            state, _ = local_then_comm_round(state, p.batches(r), p.grad_fn,
                                             cfg.depositum, p.mixer)
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
        "phase": "profile", "fused": fused, "rounds": rounds,
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fused in ("require", "off"):
        print(json.dumps(profile_rounds(fused, args.rounds, args.warmup)),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
