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


def filtered_probs(
    logits: torch.Tensor, temperature: float = 1.0, top_p: float = 1.0, top_k: int = 0
) -> torch.Tensor:
    """The normalized post-filter sampling distribution (`filtered_logits`)."""
    return torch.softmax(filtered_logits(logits, temperature, top_p, top_k), dim=-1)


def filtered_logits_per_row(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B] f32
    top_p: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int32, <= 0 disables
) -> torch.Tensor:
    """`filtered_logits` with per-row parameters as tensors (the serving
    pool's per-request sampling): the same filter order and HF top-p rule,
    so a batch with uniform parameters (top_p < 1) gives the same logits. A
    row with top_p >= 1 keeps every token whose cumulative probability before
    it is below 1."""
    V = logits.shape[-1]
    x = logits.float() / temperature.float().clamp(min=1e-6)[:, None]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k = top_k.clamp(1, V).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    k_on = ((top_k > 0) & (top_k < V))[:, None]
    x = torch.where(k_on & (x < kth), NEG_INF, x)
    sorted_logits = torch.sort(x, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    masked = torch.where(cum_before < top_p.float()[:, None], sorted_logits, float("inf"))
    threshold = masked.amin(dim=-1, keepdim=True)
    return torch.where(x < threshold, NEG_INF, x)


def sample_token_per_row(
    logits: torch.Tensor,  # [B, V] f32
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,  # [B] f32
    top_p: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] int32
    greedy: torch.Tensor,  # [B] bool
) -> torch.Tensor:
    """-> [B] int32 with per-row parameters. Greedy rows are exact argmax, so
    they stay token-exact in a batch that mixes greedy and sampled rows. The
    draw divides the filtered probabilities by exponential noise from
    `generator` and takes the argmax (a categorical draw with no host sync)."""
    arg = torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filtered_logits_per_row(logits, temperature, top_p, top_k), dim=-1)
    noise = torch.empty_like(probs).exponential_(generator=generator)
    samp = torch.argmax(probs / noise, dim=-1).to(torch.int32)
    return torch.where(greedy.to(torch.bool), arg, samp)
