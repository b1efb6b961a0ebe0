"""Batched serving engine: prefill, then the decode loop with sampling.

Fixed-batch engine (continuous batching reduces to refill-on-finish with the
deterministic cache layout; the decode step itself is batch-uniform).  It
runs eagerly on its device, "cuda" unless the caller passes another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.lm import resolve_device
from repro_torch.models.registry import ModelApi


@dataclasses.dataclass
class SamplerConfig:
    temperature: float = 0.0  # 0 ⇒ greedy
    seed: int = 0


class Engine:
    def __init__(self, api: ModelApi, params, batch: int, max_seq: int, device="cuda"):
        self.device = resolve_device(device)
        where = {p.device for p in params.parameters()}
        if where != {self.device}:
            raise ValueError(f"the parameters live on {sorted(map(str, where))}, the engine on {self.device}")
        self.api = api
        self.params = params
        self.batch = batch
        self.max_seq = max_seq

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 sampler: SamplerConfig = SamplerConfig(), **extra_inputs):
        """prompts: (batch, prompt_len) int → (batch, n_tokens) int32."""
        dev = self.device
        cache = self.api.init_cache(self.batch, self.max_seq, device=dev)
        extra = {k: torch.as_tensor(v, device=dev) for k, v in extra_inputs.items()}
        logits, cache = self.api.prefill(self.params, cache, tokens=torch.as_tensor(prompts, device=dev), **extra)
        gen = torch.Generator(device=dev).manual_seed(sampler.seed)
        out = []
        tok = self._sample(logits, sampler, gen)
        for i in range(n_tokens):
            out.append(tok)
            if i + 1 == n_tokens:
                break
            logits, cache = self.api.decode_step(self.params, tok, cache)
            tok = self._sample(logits, sampler, gen)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)

    @staticmethod
    def _sample(logits, sampler: SamplerConfig, gen: torch.Generator):
        if sampler.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / sampler.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
