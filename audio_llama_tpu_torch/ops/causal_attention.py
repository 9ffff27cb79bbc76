"""Causal GQA attention forward (prefill and full-sequence forward).

Replaces `audio_llama_tpu/ops/causal_attention.py::_fwd_kernel` (`causal_mha`,
`softmax_mode='online'`, `tri='always'`), forward only. The CUDA kernel is
`csrc/causal_attention.cu` over the shared tensor-core tile loop of
`csrc/attention_fwd.cuh` (compute-bound; its source note gives the bound and
the design). `causal_attention_plain` is the same arithmetic in PyTorch.

Contract, as in the JAX package: q [B, T, Hq, hd], k/v [B, T, Hkv, hd]; the
mask [B, T] hides padded KEYS through a -1e9 bias added before the max (never
-inf, so a fully masked row stays finite); padded QUERY rows are garbage; T
is padded to a multiple of 128 here (causal_attention.py:838-850); q is
scaled in its own dtype. The kernel runs exp in f32 where the TPU kernel
runs it in bf16; both round P to bf16 before PV and sum the denominator from
that rounded P.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _cuda

NEG = -1e9
TILE = 128
launches = 0  # kernel launches through `causal_mha` / `causal_attention_fwd`


class CausalOut(NamedTuple):
    o: torch.Tensor  # [B, T, Hq, hd]
    l: torch.Tensor  # [B*Hq, T] f32 row denominators
    m: torch.Tensor  # [B*Hq, T] f32 row maxima


def causal_attention_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor
) -> CausalOut:
    """qs pre-scaled [B, T, Hq, hd]; k/v [B, T, Hkv, hd]; key_bias [B, T] f32."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s + key_bias[:, None, None, None, :]
    future = torch.ones(T, T, dtype=torch.bool, device=qs.device).triu(1)
    s = s.masked_fill(future, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lq = l[..., 0].permute(0, 3, 1, 2)[..., None]  # [B, T, Hkv, G, 1]
    o = torch.where(lq > 0, o / torch.where(lq > 0, lq, 1.0), 0.0)
    return CausalOut(
        o=o.reshape(B, T, Hq, hd).to(qs.dtype),
        l=l[..., 0].reshape(B * Hq, T),
        m=m[..., 0].reshape(B * Hq, T),
    )


def causal_attention_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor
) -> CausalOut:
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    name = "causal_attention"
    _cuda.require_cuda(name, qs, k, v, key_bias)
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={Hkv}")
    _cuda.require_shape(name, k, (B, T, Hkv, hd))
    _cuda.require_shape(name, v, (B, T, Hkv, hd))
    _cuda.require_shape(name, key_bias, (B, T))
    for t in (qs, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or not _cuda.aligned16(t):
            raise ValueError(f"{name}: rows must be contiguous 16-byte vectors")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")
    key_bias = key_bias.to(torch.float32).contiguous()
    o = torch.empty((B, T, Hq, hd), dtype=qs.dtype, device=qs.device)
    l = torch.empty((B * Hq, T), dtype=torch.float32, device=qs.device)
    m = torch.empty((B * Hq, T), dtype=torch.float32, device=qs.device)
    err = _cuda.library().al_causal_attention(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        l.data_ptr(), m.data_ptr(), key_bias.data_ptr(),
        B, T, Hq, Hkv, hd,
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches += 1
    return CausalOut(o, l, m)


def causal_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> CausalOut:
    """Pad T to the 128 tile, scale q, build the key bias, then run the
    kernel (CUDA tensors) or the plain version (CPU tensors). Returns o
    [B, T, Hq, hd] and l, m [B*Hq, T_padded]."""
    B, T, Hq, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    pad = (-T) % TILE
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        mask = F.pad(mask.to(torch.int32), (0, pad))  # pad keys are invisible
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    key_bias = torch.where(mask != 0, zero, NEG)
    if q.device.type == "cpu":
        out = causal_attention_plain(qs, k, v, key_bias)
    else:
        out = causal_attention_cuda(qs, k, v, key_bias)
    return out._replace(o=out.o[:, :T]) if pad else out


def causal_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA self-attention, [B, T, Hq, hd] in and out."""
    return causal_attention_fwd(q, k, v, mask, scale).o
