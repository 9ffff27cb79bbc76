"""Token sampling: greedy, temperature, top-k, top-p (nucleus).

Counterpart of `audio_llama_tpu/ops/sampling.py`. The filters are the same
functions of the logits; the random draw takes an explicit
`torch.Generator`, so sampled tokens match the JAX package in distribution
only (`jax.random` and torch generators give different numbers).
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits; k <= 0 or k >= vocab disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering with the HF rule: a token stays if the cumulative
    probability BEFORE it is < top_p (the top token always stays)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    masked = torch.where(cum_before < top_p, sorted_logits, float("inf"))
    threshold = masked.amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def filtered_logits(
    logits: torch.Tensor, temperature: float = 1.0, top_p: float = 1.0, top_k: int = 0
) -> torch.Tensor:
    """Temperature -> top-k -> top-p, in f32: the log of the sampling
    distribution."""
    x = apply_temperature(logits.float(), temperature)
    if top_k > 0:
        x = apply_top_k(x, top_k)
    if top_p < 1.0:
        x = apply_top_p(x, top_p)
    return x


def sample_token(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_p: float = 1.0,
    top_k: int = 0,
    greedy: bool = False,
) -> torch.Tensor:
    """-> [B] int32 next tokens."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filtered_logits(logits, temperature, top_p, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
