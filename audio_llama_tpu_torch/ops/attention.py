"""Attention core: plain PyTorch math.

Counterpart of `audio_llama_tpu/ops/attention.py` (the XLA path). Layout is
[B, T, H, hd]; GQA groups query heads over shared KV heads without
repeating K/V; the softmax runs in f32; masks are additive f32 biases. The
kernels' plain versions (`enc_attention_plain`, `causal_attention_plain`,
`decode_attention_plain`) build on the same conventions.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha(
    q: torch.Tensor,  # [B, Tq, Hq, hd]
    k: torch.Tensor,  # [B, Tk, Hkv, hd] (or [B, Hkv, Tk, hd] if kv_head_major)
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, Tq, Tk]
    scale: Optional[float] = None,
    kv_head_major: bool = False,
) -> torch.Tensor:
    """Grouped-query attention -> [B, Tq, Hq, hd] in q.dtype. Products
    accumulate in f32 (inputs upcast), probabilities meet V in q.dtype."""
    B, Tq, Hq, hd = q.shape
    if not kv_head_major:
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, Tq, Hkv, G, hd).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, Tq, hd]
    logits = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2)) * scale
    if bias is not None:
        bias = bias.float()
        if bias.dim() == 4:
            if bias.shape[1] == 1:
                bias = bias[:, :, None]
            else:
                bias = bias.reshape(bias.shape[0], Hkv, G, Tq, Tk)
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), v.float()[:, :, None]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, hd)


def causal_bias(Tq: int, Tk: int, offset: int = 0, device=None) -> torch.Tensor:
    """[1, 1, Tq, Tk] causal additive bias: query i attends keys j <= i + offset."""
    qpos = torch.arange(Tq, device=device)[:, None] + offset
    kpos = torch.arange(Tk, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kpos <= qpos, zero, NEG_INF)[None, None]


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """mask [B, Tk] (1 = attend) -> additive bias [B, 1, 1, Tk]."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] != 0, zero, NEG_INF)


def combine_bias(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    if out is None:
        return None
    # clamp so stacked NEG_INFs never overflow to -inf (an all -inf row would
    # give NaN; clamped values still underflow to probability 0)
    return torch.clamp(out, min=NEG_INF)
