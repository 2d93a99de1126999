"""Flash against plain attention on a served prefill.

Each flash call of one prefill (or of any call that returns logits:
:func:`flash_drift`) is held against
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_plain`
on its own q, k, v; then the prefill runs again with the plain version
swapped in for every call, and the two prefills' logits are compared.  The
first reading is the kernel's error at the served shapes, the second how
far a model carries it to its logits::

    PYTHONPATH=src python -m repro_torch.serve_drift --arch qwen2.5-14b \\
        --layers 12 28 48

It serves on the card (raises without one unless ``--device cpu``, where
both runs take the plain version) what ``chip_smoke.py`` serves: B 4, a
1024-token prompt and weights from seed 0, in the config's dtype (bf16 at
the published width; ``--reduced`` for the CPU), one JSON line for each
depth (``--layers``; the config's depth without it).  The enc-dec
(``--arch seamless-m4t-medium``) has no prefill: its reading is of the
prefill step (``launch.steps.build_prefill_step``) on 1024 stub frames
and a 16-token prompt.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

import repro_torch.models.attention as attention_mod
from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as F
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import build_model
from repro_torch.serving import BatchedServer, ServeConfig


def flash_drift(run, *, call_tol: float | None = None,
                logit_tol: tuple[float, float] = (0.1, 0.05)) -> dict:
    """The two readings of ``run()``, a call that returns logits (a
    prefill, an enc-dec's prefill step, one decode step).  With
    ``call_tol`` every flash call must agree with the plain version within
    it (atol = rtol), or ``torch.testing.assert_close`` raises.
    ``logits_beyond`` counts the logits that differ by more than ``atol +
    rtol * |plain|`` (``logit_tol``).  ``run`` runs twice and must compute
    the same thing both times (a decode step that writes its cache in
    place writes the same values again)."""
    real = attention_mod.flash_attention
    calls = []

    def held(q, k, v, *, causal=True, window=0):
        out = real(q, k, v, causal=causal, window=window)
        ref = F.flash_attention_plain(q, k, v, causal=causal, window=window)
        if call_tol is not None:
            torch.testing.assert_close(
                out, ref, atol=call_tol, rtol=call_tol,
                msg=lambda m: f"flash call {len(calls)} of the run: {m}")
        d = (out.float() - ref.float()).abs()
        calls.append((float(d.max()), float((d > 0).float().mean())))
        return out

    with torch.inference_mode():
        for fn in (held, F.flash_attention_plain):
            attention_mod.flash_attention = fn
            try:
                logits = run().float()
            finally:
                attention_mod.flash_attention = real
            if fn is held:
                flash = logits
    atol, rtol = logit_tol
    diff = (flash - logits).abs()
    return {"flash_calls": len(calls),
            "flash_call_max_abs": max((c[0] for c in calls), default=None),
            "flash_call_share_differing": max((c[1] for c in calls),
                                              default=None),
            "logit_max_abs": float(diff.max()),
            "logits_beyond": int((diff > atol + rtol * logits.abs()).sum()),
            "logits": diff.numel(),
            "top1_agreement": float((flash.argmax(-1) == logits.argmax(-1))
                                    .float().mean())}


def prefill_drift(srv: BatchedServer, prompts, extra=None, **kw) -> dict:
    """:func:`flash_drift` of one prefill of ``srv`` (an enc-dec's runs its
    prompt token by token against ``extra["memory"]``)."""
    return flash_drift(lambda: srv.prefill(prompts, extra)[0], **kw)


def serve_drift(arch: str, layers: int | None = None, *,
                reduced: bool = False, device="cuda") -> dict:
    """:func:`prefill_drift` of ``arch`` at its published width (or
    ``reduced``; depth ``layers`` if given) on random weights; for the
    enc-dec, :func:`flash_drift` of its prefill step
    (``launch.steps.build_prefill_step``) on 1024 stub frames and a
    16-token prompt."""
    batch, prompt_len, seed = 4, 1024, 0
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, device=dev)
    params, _ = model.init(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    row = {"arch": arch, "layers": cfg.n_layers, "head_dim": cfg.hd,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    if cfg.family == "encdec":
        frames = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                             device=dev).to(cfg.torch_dtype)
        tokens = torch.randint(0, cfg.vocab_size, (batch, 16), generator=gen,
                               device=dev)
        step = build_prefill_step(model, 0)
        return {**row, **flash_drift(lambda: step(params, {
            "frames": frames, "tokens": tokens})[0])}
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    extra = None
    n_vis = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    if n_vis:
        extra = {"vision_embeds": torch.randn(
            (batch, n_vis, cfg.d_model), generator=gen,
            device=dev).to(cfg.torch_dtype)}
    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=1, cache_capacity=prompt_len + n_vis))
    return {**row, **prefill_drift(srv, prompts, extra)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="*", default=[None])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    for layers in args.layers:
        rows.append(serve_drift(args.arch, layers, reduced=args.reduced,
                                device=args.device))
        print(json.dumps(rows[-1]), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
