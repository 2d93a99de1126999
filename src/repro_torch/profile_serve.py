"""Where a served batch's time goes on the card: torch.profiler windows.

Builds ``--arch`` (full width unless ``--reduced``; random weights from
``--seed``), serves one warm-up batch, then profiles one prefill of
``--batch`` x ``--prompt-len`` tokens and ``--steps`` greedy decode steps
against a ``--cache``-slot cache.  Prints one JSON line for each window:
host wall time (the profiler's own overhead included), device busy time
(kernels and copies; one stream, so no overlap) and its share of the
wall, device time split into the flash kernel, matrix products (cuBLAS /
CUTLASS kernels) and the rest, the kernel count, and the kernels that take
the most time.  A third line counts the host-device synchronisations of
one prefill and one decode step (``torch.cuda.set_sync_debug_mode``).
Then the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.profile_serve [--steps 8]
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model

# cuBLAS / CUTLASS matrix-product kernels on Hopper (nvjet is cuBLAS's own)
GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|splitk", re.I)
FLASH = "flash_fwd_kernel"


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _window(fn, reps: int, on_card: bool, top: int) -> dict:
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels)
    flash = sum(_device_us(e) for e in kernels if FLASH in e.key)
    gemm = sum(_device_us(e) for e in kernels
               if FLASH not in e.key and GEMM.search(e.key))
    kernels.sort(key=_device_us, reverse=True)
    per = lambda us: us / reps / 1e3
    return {
        "reps": reps, "wall_ms": per(wall_us), "device_busy_ms": per(busy),
        "device_busy_share": busy / wall_us if wall_us else 0.0,
        "device_ms": {"flash": per(flash), "gemm": per(gemm),
                      "other": per(busy - flash - gemm)},
        "kernels_per_rep": sum(e.count for e in kernels) / reps,
        "top_device_kernels": [
            {"name": e.key[:90], "calls_per_rep": e.count / reps,
             "device_ms_per_rep": per(_device_us(e))}
            for e in kernels[:top]],
    }


def _count_syncs(fn) -> int:
    """Host-device synchronisations ``fn`` makes (warnings of the sync
    debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_serve(arch: str = "qwen3-1.7b", *, reduced: bool = False,
                  batch: int = 4, prompt_len: int = 1024, cache: int = 2048,
                  steps: int = 8, seed: int = 0, device="cuda",
                  top: int = 8) -> list[dict]:
    """Profile one prefill and ``steps`` decode steps; returns the lines."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg, device=dev)
    params, _ = model.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    with torch.inference_mode():
        logits, caches = model.forward_prefill(params, {"tokens": prompts},
                                               cache)
        model.forward_decode(params, {"tokens": tokens}, caches)  # warm-up
        pre = _window(lambda: model.forward_prefill(
            params, {"tokens": prompts}, cache), 1, on_card, top)

        # decode writes in place at slot prompt_len of the prefill's caches;
        # every step repeats that write with the same token
        def step():
            return model.forward_decode(params, {"tokens": tokens}, caches)
        dec = _window(step, steps, on_card, top)
        syncs = None
        if on_card:
            syncs = {
                "prefill": _count_syncs(lambda: model.forward_prefill(
                    params, {"tokens": prompts}, cache)),
                "decode_step": _count_syncs(step)}
    shape = {"arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
             "cache": cache, "dtype": cfg.dtype, "device": str(dev)}
    return [{"phase": "prefill", **shape, **pre},
            {"phase": "decode", **shape, "steps": steps, **dec},
            {"phase": "syncs", **shape, "syncs": syncs}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--cache", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for line in profile_serve(args.arch, reduced=args.reduced,
                              batch=args.batch, prompt_len=args.prompt_len,
                              cache=args.cache, steps=args.steps,
                              seed=args.seed, device=args.device):
        print(json.dumps(line), flush=True)
    if resolve_device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
