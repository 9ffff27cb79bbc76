"""Normalization layers (functional). f32 statistics regardless of input dtype.

Counterpart of `audio_llama_tpu/ops/norms.py`. The Whisper encoder's
per-layer LayerNorms go to the kernel in `ops/layer_norm.py`; this plain
two-pass `layer_norm` serves the projector and the encoder's `ln_post`.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Llama RMSNorm: x * rsqrt(mean(x^2) + eps) * scale, stats in f32.
    The normalized value is cast to x's dtype BEFORE the scale multiply (the
    HF order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return scale * normed.to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Standard LayerNorm (Whisper/projector), two-pass f32 stats."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
