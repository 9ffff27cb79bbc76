"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling.

Counterpart of `audio_llama_tpu/ops/rope.py`: the HF rotate-half convention
with cos/sin tables built as concat(freqs, freqs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import LlamaConfig, RopeScalingConfig


def rope_inv_freq(
    head_dim: int, theta: float, scaling: Optional[RopeScalingConfig]
) -> np.ndarray:
    """Inverse frequencies [head_dim // 2] f32, with optional llama3 scaling
    (computed in float64 on the host, as the JAX package does)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None and scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wavelen = orig / scaling.low_freq_factor
        high_wavelen = orig / scaling.high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        scaled = inv_freq / scaling.factor
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(
            wavelen > low_wavelen,
            scaled,
            np.where(wavelen < high_wavelen, inv_freq, smoothed),
        )
    return inv_freq.astype(np.float32)


def rope_tables(
    positions: torch.Tensor, inv_freq
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> (cos, sin), each [..., head_dim] f32."""
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=positions.device)
    freqs = positions.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: [B, T, H, hd]; cos/sin: [B|1, T, hd] (or [T, hd])."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def rope_for_config(cfg: LlamaConfig) -> np.ndarray:
    return rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
