"""Whisper encoder attention kernel: non-causal MHA with a static valid-key
length.

Replaces `audio_llama_tpu/ops/enc_attention.py::_kernel_v3`
(`enc_attention(algo='v3', softmax='safe')`). The CUDA kernel is
`csrc/enc_attention.cu` over the shared tensor-core tile loop of
`csrc/attention_fwd.cuh` (compute-bound; its source note gives the bound and
the design). `enc_attention_plain` is the same arithmetic in PyTorch.

Contract, as in the JAX package: q/k/v [B, T, H, hd]; keys at index >=
valid_len are masked; padded QUERY rows are unspecified; q is scaled in its
own dtype before the kernel (enc_attention.py:315); P is rounded to the
value dtype before PV and the denominator is summed from that rounded P.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

NEG = -1e9
launches = 0  # kernel launches through `enc_attention`


def enc_attention_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """qs pre-scaled; all [B, T, H, hd] -> [B, T, H, hd]."""
    T = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if valid_len < T:
        s[..., valid_len:] = NEG
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(v.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.permute(0, 2, 1, 3).to(qs.dtype)


def enc_attention_cuda(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int
) -> torch.Tensor:
    """Launch the kernel. qs/k/v may be strided views ([B, T, H, hd] over a
    [B, T, H*hd] projection output); the last dim must be contiguous."""
    global launches
    name = "enc_attention"
    _cuda.require_cuda(name, qs, k, v)
    B, T, H, hd = qs.shape
    _cuda.require_shape(name, k, qs.shape)
    _cuda.require_shape(name, v, qs.shape)
    if not 0 <= valid_len <= T:
        raise ValueError(f"{name}: valid_len {valid_len} outside [0, {T}]")
    for t in (qs, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or not _cuda.aligned16(t):
            raise ValueError(f"{name}: rows must be contiguous 16-byte vectors")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")
    o = torch.empty((B, T, H, hd), dtype=qs.dtype, device=qs.device)
    err = _cuda.library().al_enc_attention(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, T, H, hd, int(valid_len),
        *qs.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    launches += 1
    return o


def enc_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    valid_len: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal self-attention, [B, T, H, hd] in and out. The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    T, hd = q.shape[1], q.shape[3]
    if scale is None:
        scale = hd ** -0.5
    nvalid = T if valid_len is None else int(valid_len)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return enc_attention_plain(qs, k, v, nvalid)
    return enc_attention_cuda(qs, k, v, nvalid)
