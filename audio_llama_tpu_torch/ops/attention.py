"""Attention core: plain PyTorch math.

Counterpart of `audio_llama_tpu/ops/attention.py` (the XLA path). Layout is
[B, T, H, hd]; GQA groups query heads over shared KV heads without
repeating K/V; the softmax runs in f32; masks are additive f32 biases. The
kernels' plain versions (`enc_attention_plain`, `causal_attention_plain`,
`decode_attention_plain`) build on the same conventions.

`sp_partial_attention` and `merge_partial_stats` are the timeline-sharded
decode's halves: each rank's flash statistics over its slab of the cache,
and their exact merge across the ranks of the sp axis with one pmax and one
psum (`parallel/collectives.py`). The plain arm clamps the row max at
NEG_INF * 0.5, as the JAX package's XLA arm does; the stats kernels
(`ops/decode_attention_db.py`) keep their own -1e30 / -5e29 sentinels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives

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


def sp_partial_attention(
    q: torch.Tensor,  # [B, Tq, Hq, hd]
    k_local: torch.Tensor,  # [B, Hkv, S, hd]: this rank's slab of the timeline
    v_local: torch.Tensor,
    valid_local: torch.Tensor,  # [B, S], 1 = the local slot may be attended
    scale: float,
    axis,
) -> torch.Tensor:
    """Timeline-sharded decode attention in plain PyTorch -> [B, Tq, Hq, hd]
    in q.dtype, the same on every rank of `axis`: each rank's row max m,
    denominator l and numerator acc over its slab (f32; products of the
    f32-cast operands, p rounded to V's dtype before it meets V), merged by
    `merge_partial_stats`. A rank whose slots are all invalid contributes
    (clamped m, 0, 0), a no-op in the merge."""
    B, Tq, Hq, hd = q.shape
    _, Hkv, S, _ = k_local.shape
    G = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()  # [B, Hkv, G, Tq, hd]
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_local.float()) * scale
    vmask = (valid_local > 0)[:, None, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1).clamp(min=NEG_INF * 0.5)  # [B, Hkv, G, Tq]
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_local.dtype).float(), v_local.float())
    out = merge_partial_stats(m, l, acc, axis)  # [B, Hkv, G, Tq, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, hd).to(q.dtype)


def merge_stats(m, l, acc, pmax, psum, out_dtype=None):
    """The exact softmax attention from unnormalized flash statistics (row
    max m [...], denominator l [...], numerator acc [..., hd], f32) of
    several slabs, reduced by `pmax` and `psum`: m_g = pmax m, corr =
    exp(m - m_g), out = psum(acc corr) / max(psum(l corr), 1e-30). The two
    sums travel as one psum. A slab that was all invalid drops out through
    corr -> 0."""
    m_g = pmax(m)
    corr = torch.exp(m - m_g)
    both = psum(torch.cat([acc * corr[..., None], (l * corr)[..., None]], dim=-1))
    out = both[..., :-1] / both[..., -1:].clamp(min=1e-30)
    return out if out_dtype is None else out.to(out_dtype)


def merge_partial_stats(m, l, acc, axis, out_dtype=None):
    """`merge_stats` across the ranks of `axis` (one pmax and one psum), each
    rank holding the statistics of its slab of the timeline."""
    return merge_stats(m, l, acc, lambda t: collectives.pmax(t, axis),
                       lambda t: collectives.psum(t, axis), out_dtype)


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
