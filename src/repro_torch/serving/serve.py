"""Batched serving: prefill + decode loop over a static request batch
(port of ``repro/serving/serve.py``).

Prefill runs once over the whole prompt (its attention through the flash
kernel), then one decode step per new token against the per-layer caches
(KV caches; Mamba2 conv and SSD states for the SSM and hybrid families),
all under ``torch.inference_mode()``.  ``extra`` tensors (a VLM's
``vision_embeds``) join the prefill batch, as in the reference.  Greedy decoding (the
default) takes the argmax and matches the reference token for token.
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
        if model.forward_prefill is None:
            raise NotImplementedError(
                "a model without a prefill (token-by-token prompts, the "
                "encoder-decoder family) arrives with its slice")
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
        ``extra`` entries join the batch beside ``tokens``."""
        batch = {"tokens": prompts}
        if extra:
            batch.update(extra)
        return self.model.forward_prefill(self.params, batch,
                                          self.cfg.cache_capacity)

    def generate(self, prompts: torch.Tensor,
                 extra: Optional[dict] = None) -> torch.Tensor:
        """prompts: (B, L_prompt) int.  Returns (B, max_new_tokens) int64.
        ``extra`` (e.g. ``{"vision_embeds": (B, n_vision_tokens, d)}``)
        joins the prefill batch; its tensors are moved to the params'
        device.

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
