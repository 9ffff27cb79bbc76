"""Row LayerNorm kernel (the Whisper encoder's per-layer LayerNorms).

Replaces `audio_llama_tpu/ops/ln_pallas.py::_kernel` (`layer_norm_pallas`).
The CUDA kernel is `csrc/layer_norm.cu` (one block per row, one-pass f32
moments, memory-bound; its source note gives the bound). `layer_norm_plain`
is the same arithmetic in PyTorch: the CPU path, and what the kernel is held
against on the card.
"""

from __future__ import annotations

import torch

from . import _cuda

launches = 0  # kernel launches through `layer_norm`


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """One-pass f32 moments, var = E[x^2] - E[x]^2, as ln_pallas._kernel."""
    xf = x.float()
    inv_d = 1.0 / x.shape[-1]
    mu = xf.sum(dim=-1, keepdim=True) * inv_d
    ex2 = (xf * xf).sum(dim=-1, keepdim=True) * inv_d
    y = (xf - mu) * torch.rsqrt(ex2 - mu * mu + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_cuda(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Launch the kernel on [..., D] (any row count)."""
    global launches
    _cuda.require_cuda("layer_norm", x, scale, bias)
    D = x.shape[-1]
    code = _cuda.dtype_code(x, "layer_norm")
    _cuda.require_shape("layer_norm scale", scale, (D,))
    _cuda.require_shape("layer_norm bias", bias, (D,))
    if scale.dtype != x.dtype or bias.dtype != x.dtype:
        scale, bias = scale.to(x.dtype), bias.to(x.dtype)
    x = x.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    if (D * x.element_size()) % 16 or not all(map(_cuda.aligned16, (x, scale, bias))):
        raise ValueError(f"layer_norm: D={D} rows must be whole 16-byte vectors")
    y = torch.empty_like(x)
    err = _cuda.library().al_layer_norm(
        code, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // D, D, float(eps), _cuda.stream_handle(x),
    )
    _cuda.check(err, "layer_norm")
    launches += 1
    return y


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    return layer_norm_cuda(x, scale, bias, eps)
