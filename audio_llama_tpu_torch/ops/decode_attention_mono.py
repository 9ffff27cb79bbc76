"""Single-token decode attention on a bf16/f32 KV cache, appending in place.

Replaces `audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono_full`
(`decode_attention_mono`). The CUDA kernel is `csrc/decode_attention.cu`
(memory-bound; its source note gives the bound and the design).
`decode_attention_plain` is the same arithmetic in PyTorch.

Contract, as in the JAX package: q [B, Hq, hd]; k_new/v_new [B, Hkv, hd];
cache_k/cache_v [L, B, Hkv, max_len, hd] with max_len % 32 == 0; `offset` a
scalar or [B] int32 (per-row append slots); `valid` [B, max_len], nonzero
where a slot may be attended (the caller folds `slot <= offset` into it).
The fresh rows are written into layer `layer` of the cache at the offset
IN PLACE (the returned cache tensors are the arguments, updated), then the
G = Hq / Hkv query heads of each KV head attend the valid slots. The scale
multiplies the f32 logits (it is not folded into q); probabilities meet V in
the cache dtype; the denominator sums the f32 probabilities.
"""

from __future__ import annotations

from typing import Union

import torch

from . import _cuda

launches = 0  # kernel launches through `decode_attention_mono`


def _offsets(offset: Union[int, torch.Tensor], B: int, device) -> torch.Tensor:
    off = torch.as_tensor(offset, dtype=torch.int32, device=device).reshape(-1)
    if off.numel() == 1:
        return off.expand(B).contiguous()
    if off.numel() != B:
        raise ValueError(f"offset must be scalar or [B]; got {tuple(off.shape)}")
    return off.contiguous()


def _append_rows(cache_k, cache_v, k_new, v_new, layer, off):
    """Write the fresh rows at off[b] (an offset outside the slab writes
    nothing, as in the TPU kernel)."""
    B, max_len = cache_k.shape[1], cache_k.shape[3]
    rows = torch.arange(B, device=off.device)
    inside = (off >= 0) & (off < max_len)
    slot = off.clamp(0, max_len - 1).long()
    keep_k = cache_k[layer, rows, :, slot]  # [B, Hkv, hd]
    keep_v = cache_v[layer, rows, :, slot]
    sel = inside[:, None, None]
    cache_k[layer, rows, :, slot] = torch.where(sel, k_new.to(cache_k.dtype), keep_k)
    cache_v[layer, rows, :, slot] = torch.where(sel, v_new.to(cache_v.dtype), keep_v)


def decode_attention_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """The kernel's arithmetic in PyTorch (updates the cache in place)."""
    L, B, Hkv, max_len, hd = cache_k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    off = _offsets(offset, B, cache_k.device)
    _append_rows(cache_k, cache_v, k_new, v_new, layer, off)
    k = cache_k[layer].float()  # [B, Hkv, S, hd]
    v = cache_v[layer]
    qg = q.float().reshape(B, Hkv, G, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    ok = (valid != 0)[:, None, None, :]
    logits = logits.masked_fill(~ok, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(denom > 0, acc / torch.where(denom > 0, denom, 1.0), 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype), cache_k, cache_v


def decode_attention_cuda(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    name = "decode_attention_mono"
    _cuda.require_cuda(name, q, k_new, v_new, cache_k, cache_v, valid)
    L, B, Hkv, max_len, hd = cache_k.shape
    Hq = q.shape[1]
    code = _cuda.dtype_code(cache_k, name)
    _cuda.require_shape(name, cache_v, cache_k.shape)
    _cuda.require_shape(name, q, (B, Hq, hd))
    _cuda.require_shape(name, k_new, (B, Hkv, hd))
    _cuda.require_shape(name, v_new, (B, Hkv, hd))
    _cuda.require_shape(name, valid, (B, max_len))
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if cache_v.dtype != cache_k.dtype or q.dtype != cache_k.dtype:
        raise TypeError(f"{name}: q and both caches must share one dtype")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError(f"{name}: the caches must be contiguous")
    if Hq % Hkv or Hq // Hkv not in (1, 2, 3, 4, 6, 8):
        raise ValueError(f"{name}: needs Hq/Hkv in (1, 2, 3, 4, 6, 8)")
    row_bytes = hd * cache_k.element_size()
    if row_bytes % 16 or 32 % (row_bytes // 16) or not _cuda.aligned16(cache_k) \
            or not _cuda.aligned16(cache_v):
        raise ValueError(f"{name}: cache rows must be 16-byte vectors, at most 32 per row")
    G = Hq // Hkv
    smem = 4 * (G * hd + G * max_len + 32 * G * hd)
    if smem > 227 * 1024:
        raise ValueError(f"{name}: max_len {max_len} exceeds the shared-memory budget")
    off = _offsets(offset, B, q.device)
    valid = valid.to(torch.int32).contiguous()
    q = q.contiguous()
    k_new = k_new.to(cache_k.dtype).contiguous()
    v_new = v_new.to(cache_v.dtype).contiguous()
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    err = _cuda.library().al_decode_attention(
        code, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), off.data_ptr(), valid.data_ptr(),
        int(layer), B, Hq, Hkv, max_len, hd, float(scale), out.data_ptr(),
        _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    launches += 1
    return out, cache_k, cache_v


def decode_attention_mono(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """-> (out [B, Hq, hd], cache_k, cache_v), the caches updated in place.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    max_len = cache_k.shape[3]
    if max_len % 32:
        raise ValueError(f"max_len % 32 != 0 ({max_len})")
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale
        )
    return decode_attention_cuda(
        q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale
    )
