"""Causal GQA attention: forward (prefill and full-sequence) and backward.

Replaces `audio_llama_tpu/ops/causal_attention.py::_fwd_kernel` (`causal_mha`,
`softmax_mode='online'`, `tri='always'`) and the two kernels of its custom
VJP, `_dq_kernel` and `_dkv_kernel`. The forward kernel is
`csrc/causal_attention.cu` over the shared tensor-core tile loop of
`csrc/attention_fwd.cuh`; the backward kernels are
`csrc/causal_attention_bwd.cu` (their source notes give the bounds and the
designs). `causal_attention_plain` and `causal_attention_bwd_plain` are the
same arithmetic in PyTorch. `_CausalAttention` (a `torch.autograd.Function`)
joins them: its forward saves qs, k, v, the key bias, o and the row
statistics l and m, and its backward runs the D = rowsum(dO * O) prologue in
PyTorch (as the JAX package leaves it to XLA), then dq, then dk/dv; the bias
gets no gradient.

Contract, as in the JAX package: q [B, T, Hq, hd], k/v [B, T, Hkv, hd]; the
mask [B, T] hides padded KEYS through a -1e9 bias added before the max (never
-inf, so a fully masked row stays finite); padded QUERY rows are garbage; T
is padded to a multiple of 128 here (causal_attention.py:838-850); q is
scaled in its own dtype, outside the Function, so autograd carries the scale
and the pad slices. The forward kernel runs exp in f32 where the TPU kernel
runs it in bf16; both round P to bf16 before PV and sum the denominator from
that rounded P. The backward recomputes P in f32 from the saved m and l and
rounds P and dS to the input dtype before their products, as the TPU kernels
do.

`tri` selects the kernels' mode, as the JAX package's `tri` argument:
'always' (the causal mask; every call above) or 'never' (no mask, every key
tile contributes: one hop of the ring of sequence-parallel training,
`parallel/ring_kernel.py`, over a K/V block from an earlier shard, the
backward fed the ring's global m, l and D). Each mode of each kernel counts
its own launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _cuda

NEG = -1e9
TILE = 128
launches = 0  # forward kernel launches (tri='always')
launches_dq = 0  # dq kernel launches (tri='always')
launches_dkv = 0  # dk/dv kernel launches (tri='always')
launches_never = 0  # forward kernel launches, tri='never'
launches_dq_never = 0  # dq kernel launches, tri='never'
launches_dkv_never = 0  # dk/dv kernel launches, tri='never'
BWD_TILE = 64  # the backward kernels' tile: T must be a multiple of it
TRI = ("always", "never")


def _causal_flag(tri: str) -> int:
    if tri not in TRI:
        raise ValueError(f"tri must be one of {TRI}; got {tri!r}")
    return int(tri == "always")


def _scores(qg, k, key_bias, tri):
    """[B, Hkv, G, T, T] f32 scores of pre-scaled grouped queries against the
    keys, the key bias added and, for tri='always', the future masked."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s + key_bias[:, None, None, None, :]
    if _causal_flag(tri):
        T = s.shape[-1]
        future = torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(future, NEG)
    return s


class CausalOut(NamedTuple):
    o: torch.Tensor  # [B, T, Hq, hd]
    l: torch.Tensor  # [B*Hq, T] f32 row denominators
    m: torch.Tensor  # [B*Hq, T] f32 row maxima


def causal_attention_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    tri: str = "always",
) -> CausalOut:
    """qs pre-scaled [B, T, Hq, hd]; k/v [B, T, Hkv, hd]; key_bias [B, T] f32."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    s = _scores(qg, k, key_bias, tri)
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
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    tri: str = "always",
) -> CausalOut:
    """Launch the kernel (same arguments as the plain version)."""
    global launches, launches_never
    name = "causal_attention"
    causal = _causal_flag(tri)
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
        causal, _cuda.stream_handle(qs),
    )
    _cuda.check(err, name)
    if causal:
        launches += 1
    else:
        launches_never += 1
    return CausalOut(o, l, m)


def attention_bwd_prologue(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32: o, do [B, T, Hq, hd] -> [B*Hq, T]."""
    B, T, Hq, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # [B, T, Hq]
    return d.transpose(1, 2).reshape(B * Hq, T).contiguous()


def causal_attention_bwd_plain(
    qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
    o: torch.Tensor, l: torch.Tensor, m: torch.Tensor, do: torch.Tensor,
    tri: str = "always",
):
    """The backward of `causal_attention_plain` from its saved residuals ->
    (dq [B, T, Hq, hd], dk, dv [B, T, Hkv, hd]) in the inputs' dtypes: P
    recomputed as exp(s - m) / l (0 where l == 0), dS = P (dP - D), P and dS
    rounded to the input dtype before their products, f32 sums, dk and dv
    summed over the G query heads of each group. For a ring hop
    (tri='never') o, l and m are the whole row's, merged over the ring."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    d = attention_bwd_prologue(o, do).reshape(B, Hkv, G, T, 1)
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    dog = do.float().reshape(B, T, Hkv, G, hd)
    s = _scores(qg, k, key_bias, tri)
    lq = l.reshape(B, Hkv, G, T, 1)
    inv_l = torch.where(lq > 0, 1.0 / torch.where(lq > 0, lq, 1.0), 0.0)
    p = torch.exp(s - m.reshape(B, Hkv, G, T, 1)) * inv_l
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - d)).to(qs.dtype).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, T, Hq, hd)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_checks(name, qs, k, v, key_bias, l, m, do, d):
    _cuda.require_cuda(name, qs, k, v, key_bias, l, m, do, d)
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={Hkv}")
    if T % BWD_TILE:
        raise ValueError(f"{name}: T={T} not a multiple of {BWD_TILE}")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name}: head_dim {hd} not in (16, 32, 64, 128)")
    for t, shape in ((k, (B, T, Hkv, hd)), (v, (B, T, Hkv, hd)), (do, (B, T, Hq, hd)),
                     (key_bias, (B, T)), (l, (B * Hq, T)), (m, (B * Hq, T)), (d, (B * Hq, T))):
        _cuda.require_shape(name, t, shape)
    for t in (qs, k, v, do):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {t.dtype}")
    for t in (key_bias, l, m, d):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: statistics and bias must be f32, got {t.dtype}")
    for t in (qs, k, v, do, key_bias, l, m, d):
        if not t.is_contiguous() or not _cuda.aligned16(t):
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")
    return B, T, Hq, Hkv, hd


def causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, d, tri="always") -> torch.Tensor:
    """Launch the dq kernel: qs, do [B, T, Hq, hd], k, v [B, T, Hkv, hd] bf16
    contiguous; key_bias [B, T], l, m, d [B*Hq, T] f32 -> dq [B, T, Hq, hd]."""
    global launches_dq, launches_dq_never
    name = "causal_attention_dq"
    causal = _causal_flag(tri)
    B, T, Hq, Hkv, hd = _bwd_checks(name, qs, k, v, key_bias, l, m, do, d)
    dq = torch.empty_like(qs)
    err = _cuda.library().al_causal_attention_dq(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
        d.data_ptr(), key_bias.data_ptr(), dq.data_ptr(), B, T, Hq, Hkv, hd, causal,
        _cuda.stream_handle(qs))
    _cuda.check(err, name)
    if causal:
        launches_dq += 1
    else:
        launches_dq_never += 1
    return dq


def causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, d, tri="always"):
    """Launch the dk/dv kernel (the dq kernel's arguments) -> (dk, dv)
    [B, T, Hkv, hd], each summed over the G query heads of its group."""
    global launches_dkv, launches_dkv_never
    name = "causal_attention_dkv"
    causal = _causal_flag(tri)
    B, T, Hq, Hkv, hd = _bwd_checks(name, qs, k, v, key_bias, l, m, do, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _cuda.library().al_causal_attention_dkv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), l.data_ptr(), m.data_ptr(),
        d.data_ptr(), key_bias.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, Hq, Hkv, hd,
        causal, _cuda.stream_handle(qs))
    _cuda.check(err, name)
    if causal:
        launches_dkv += 1
    else:
        launches_dkv_never += 1
    return dk, dv


def causal_attention_bwd_cuda(qs, k, v, key_bias, o, l, m, do, tri="always"):
    """The prologue, then the two kernels (same arguments and results as
    `causal_attention_bwd_plain`)."""
    d = attention_bwd_prologue(o, do)
    dq = causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, d, tri)
    dk, dv = causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, d, tri)
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    """(qs, k, v, key_bias) -> (o, l, m): the kernels on CUDA tensors, the
    plain versions on CPU tensors; l and m carry no gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, key_bias):
        run = causal_attention_plain if qs.device.type == "cpu" else causal_attention_cuda
        o, l, m = run(qs, k, v, key_bias)
        ctx.save_for_backward(qs, k, v, key_bias, o, l, m)
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        qs, k, v, key_bias, o, l, m = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        if qs.device.type == "cpu":
            dq, dk, dv = causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do)
        else:
            dq, dk, dv = causal_attention_bwd_cuda(
                qs.contiguous(), k.contiguous(), v.contiguous(), key_bias, o, l, m, do)
        return dq, dk, dv, None


def causal_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> CausalOut:
    """Pad T to the 128 tile, scale q, build the key bias, then run the
    kernel (CUDA tensors) or the plain version (CPU tensors) through
    `_CausalAttention`, so the backward kernels (or the plain backward)
    serve autograd. Returns o [B, T, Hq, hd] and l, m [B*Hq, T_padded]."""
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
    out = CausalOut(*_CausalAttention.apply(qs, k, v, key_bias))
    return out._replace(o=out.o[:, :T]) if pad else out


def causal_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA self-attention, [B, T, Hq, hd] in and out, differentiable."""
    return causal_attention_fwd(q, k, v, mask, scale).o
