"""Serving launcher: batched generation with a ported zoo architecture
(port of ``repro/launch/serve.py``).

Example (CPU, reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --reduced --device cpu --batch 4 --prompt-len 16 --max-new 16

Without ``--device cpu`` it runs on the card (and raises without one); the
first call on the card builds the kernels with ``nvcc``.  Weights are drawn
from ``--seed``; prompts are uniform tokens from the same seed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import BatchedServer, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt:
        raise NotImplementedError("--ckpt: checkpoints arrive with the "
                                  "trainer slice (ROADMAP Queue 1 item 5)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=device)
    params, _ = model.init(args.seed)

    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=args.max_new, temperature=args.temperature,
        cache_capacity=args.cache, seed=args.seed,
    ))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    t0 = time.time()
    out = srv.generate(prompts)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. compile)")
    print("sample:", out[0].tolist())


if __name__ == "__main__":
    main()
