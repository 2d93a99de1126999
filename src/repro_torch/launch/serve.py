"""Serving launcher: batched generation with any architecture the port
serves (port of ``repro/launch/serve.py``): every family of the zoo
(``repro_torch.configs.list_archs()``), the encoder-decoder's included.

Example (CPU, reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --reduced --device cpu --batch 4 --prompt-len 32 --max-new 16

Without ``--device cpu`` it runs on the card (and raises without one); the
first call on the card builds the kernels with ``nvcc``.  Weights are drawn
from ``--seed``, or read from ``--ckpt`` (a checkpoint of any family in
the reference's format, as ``launch.train --ckpt`` or the reference's
``save_checkpoint`` writes it); prompts are
uniform tokens from the seed, a VLM's stub vision embeds (B,
n_vision_tokens, d) and an enc-dec's stub encoder memory (B, 32, d)
standard normal draws from it, as the reference's launcher stubs them.
The enc-dec runs its prompt token by token against that memory.  The SSM
and hybrid
families need a prompt length that is a multiple of ``ssm_chunk``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import BatchedServer, ServeConfig
from repro_torch.training.checkpoint import restore_checkpoint

#: rows of the enc-dec's stub memory, as the reference's launcher draws it
ENCDEC_MEMORY_LEN = 32


def generate(model, params, *, batch: int, prompt_len: int, max_new: int,
             temperature: float = 0.0, cache: int = 256, seed: int = 0):
    """Greedy (or sampled) tokens of ``params`` for ``batch`` prompts of
    uniform tokens drawn from ``seed`` on the params' device (after them,
    a VLM's vision embeds or an enc-dec's memory)."""
    cfg = model.cfg
    device = params.embed["table"].device
    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=max_new, temperature=temperature,
        cache_capacity=cache, seed=seed,
    ))
    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device)
    extra = None
    if cfg.family == "vlm":
        extra = {"vision_embeds": torch.randn(
            (batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
            device=device).to(cfg.torch_dtype)}
    if cfg.family == "encdec":
        extra = {"memory": torch.randn(
            (batch, ENCDEC_MEMORY_LEN, cfg.d_model), generator=gen,
            device=device).to(cfg.torch_dtype)}
    return srv.generate(prompts, extra=extra)


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

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=device)
    if args.ckpt:
        # the family's module built by its init_params on meta: shapes only
        template, _ = build_model(cfg, device="meta").init()
        params, step = restore_checkpoint(args.ckpt, template, device=device)
        print(f"restored {args.ckpt} (step {step})")
    else:
        params, _ = model.init(args.seed)

    t0 = time.time()
    out = generate(model, params, batch=args.batch,
                   prompt_len=args.prompt_len, max_new=args.max_new,
                   temperature=args.temperature, cache=args.cache,
                   seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. compile)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
