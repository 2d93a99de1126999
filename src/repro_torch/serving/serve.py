"""Batched serving: prefill + decode loop over a static request batch
(port of ``repro/serving/serve.py``).

Prefill runs once over the whole prompt (its attention through the flash
kernel), then one decode step per new token against the per-layer caches
(KV caches; Mamba2 conv and SSD states for the SSM and hybrid families),
all under ``torch.inference_mode()``.  ``extra`` tensors (a VLM's
``vision_embeds``) join the prefill batch, as in the reference.  A model
without a prefill (the encoder-decoder family) takes its prompt token by
token instead, as the reference does: a decode cache holding
``extra["memory"]`` (the encoder's output), then one ``forward_decode`` a
prompt token, each cross-attending the memory through the flash kernel.
Greedy decoding (the default) takes the argmax and matches the reference
token for token.
Temperature sampling draws from a ``torch.Generator`` seeded with
``ServeConfig.seed``; JAX's ``jax.random.categorical`` stream cannot be
reproduced, so sampled tokens differ from the reference's and parity
covers greedy decoding only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    cache_capacity: int = 4096
    eos_token: int = -1           # -1 => never stop early
    seed: int = 0


class BatchedServer:
    """Static-batch generation driver (prefill once, then decode steps).

    ``params`` is the model module from ``model.init`` (or a converted
    one); it stays on its device, and prompts are moved there.
    """

    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg

    def _sample(self, logits, gen):
        logits = logits[:, -1, :].to(torch.float32)
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def prefill(self, prompts: torch.Tensor, extra: Optional[dict] = None):
        """Prompt forward + caches.  Returns (last-position logits, caches).
        ``extra`` entries join the batch beside ``tokens``; for a model
        without a prefill, the prompt runs token by token from a fresh
        cache (an enc-dec's holding ``extra["memory"]``)."""
        if self.model.forward_prefill is not None:
            batch = {"tokens": prompts}
            if extra:
                batch.update(extra)
            return self.model.forward_prefill(self.params, batch,
                                              self.cfg.cache_capacity)
        memory = (extra or {}).get("memory")
        cache = self.model.init_decode_cache(
            prompts.shape[0], self.cfg.cache_capacity,
            memory_len=0 if memory is None else memory.shape[1])
        if memory is not None:
            cache = cache._replace(memory=memory.to(cache.memory.dtype))
        logits = None
        for t in range(prompts.shape[1]):
            logits, cache = self.model.forward_decode(
                self.params, {"tokens": prompts[:, t:t + 1]}, cache)
        return logits, cache

    def generate(self, prompts: torch.Tensor,
                 extra: Optional[dict] = None) -> torch.Tensor:
        """prompts: (B, L_prompt) int.  Returns (B, max_new_tokens) int64.
        ``extra`` (e.g. ``{"vision_embeds": (B, n_vision_tokens, d)}``, or
        an enc-dec's ``{"memory": (B, S, d)}``) joins the prefill; its
        tensors are moved to the params' device.

        The decode after the last token is skipped: its logits would pick
        a token past ``max_new_tokens``.
        """
        cfg = self.cfg
        device = next(self.params.parameters()).device
        prompts = torch.as_tensor(prompts).to(device=device, dtype=torch.long)
        if extra:
            extra = {k: torch.as_tensor(v).to(device) for k, v in
                     extra.items()}
        B = prompts.shape[0]
        gen = None
        if cfg.temperature > 0.0:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
        out = []
        with torch.inference_mode():
            logits, cache = self.prefill(prompts, extra)
            done = torch.zeros((B,), dtype=torch.bool, device=device)
            for step in range(cfg.max_new_tokens):
                nxt = self._sample(logits, gen)
                nxt = torch.where(done, torch.zeros_like(nxt), nxt)
                out.append(nxt)
                if cfg.eos_token >= 0:
                    done = done | (nxt == cfg.eos_token)
                if step + 1 < cfg.max_new_tokens:
                    logits, cache = self.model.forward_decode(
                        self.params, {"tokens": nxt[:, None]}, cache)
        return torch.stack(out, dim=1)
