"""Single-token decode attention, appending the fresh row in place: on a
bf16/f32 KV cache, on an int8 KV cache and on the K/V-combined int4 cache.

`decode_attention_mono` replaces
`audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono_full`; its CUDA
kernel is `csrc/decode_attention.cu` and `decode_attention_plain` is the
same arithmetic in PyTorch. `decode_attention_quantized4_mono` replaces
`_kernel_mono4`; its CUDA kernel is `csrc/decode_attention_q4.cu` and
`decode_attention_q4_plain` its arithmetic in PyTorch.
`decode_attention_quantized_mono` replaces `_kernel_mono_q8`; its CUDA kernel
is the int8 instance of the same template in `csrc/decode_attention_q4.cu`
and `decode_attention_q8_plain` its arithmetic in PyTorch. The kernels are
memory-bound; their source notes give the bounds and the designs. The TPU
kernel's DMA schedule knobs (MONO_DEPTH, MONO_HPD, MONO_ILP, MONO_KEPI,
MONO_BB) have no counterpart here: they order Mosaic copies, which the CUDA
kernels do not have.

Contract of `decode_attention_mono`, as in the JAX package: q [B, Hq, hd]; k_new/v_new [B, Hkv, hd];
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
launches_q4 = 0  # kernel launches through `decode_attention_quantized4_mono`
launches_q8 = 0  # kernel launches through `decode_attention_quantized_mono`
DEAD = -1e30  # the logit of a slot that is not attended, as in the TPU kernel


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


def _layer_scales(scales: torch.Tensor, layer) -> torch.Tensor:
    """[L, B, Hkv, S] stacked slabs (layer picked) or one layer's [B, Hkv, S]."""
    return scales[layer] if scales.dim() == 4 else scales


def decode_attention_q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                              v_new_scale, layer, offset, valid, scale):
    """The int4 kernel's arithmetic in PyTorch (appends in place)."""
    L, B, Hkv, S, hd = cache_kv.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    dev = cache_kv.device
    off = _offsets(offset, B, dev)
    slab = cache_kv[layer].to(torch.int32)  # [B, Hkv, S, hd], read before the append
    k_q = ((slab & 0xF) - 8).to(torch.float32)  # K: offset-binary low nibble
    v_q = (slab >> 4).to(torch.float32)  # V: signed high nibble
    ks = _layer_scales(k_scales, layer).to(torch.float32)
    vs = _layer_scales(v_scales, layer).to(torch.float32)
    qg = q.reshape(B, Hkv, G, hd).to(torch.float32)
    dead = (valid <= 0) | (torch.arange(S, device=dev)[None, :] == off[:, None])  # [B, S]
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_q) * (ks * scale)[:, :, None, :]
    logits = torch.where(dead[:, None, None, :], DEAD, logits)
    m1 = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m1)
    l1 = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, :]).to(q.dtype).to(torch.float32)
    acc1 = torch.einsum("bhgs,bhsd->bhgd", pv, v_q)
    # the fresh row, analytically
    n32 = kv_new.to(torch.int32)
    k_n, v_n = ((n32 & 0xF) - 8).to(torch.float32), (n32 >> 4).to(torch.float32)
    inside = (off >= 0) & (off < S)
    slot = off.clamp(0, S - 1).long()
    fresh_on = inside & (valid.gather(1, slot[:, None])[:, 0] > 0)  # [B]
    lf = torch.einsum("bhgd,bhd->bhg", qg, k_n)[..., None]
    lf = lf * (k_new_scale.to(torch.float32) * scale)[:, :, None, None]
    lf = torch.where(fresh_on[:, None, None, None], lf, DEAD)
    m = torch.maximum(m1, lf)
    a1, pf = torch.exp(m1 - m), torch.exp(lf - m)
    acc = a1 * acc1 + (pf * v_new_scale.to(torch.float32)[:, :, None, None]) * v_n[:, :, None, :]
    out = (acc / (a1 * l1 + pf)).to(q.dtype).reshape(B, Hq, hd)
    rows = torch.arange(B, device=dev)
    keep = cache_kv[layer, rows, :, slot]  # [B, Hkv, hd]
    cache_kv[layer, rows, :, slot] = torch.where(inside[:, None, None], kv_new, keep)
    return out, cache_kv


def _check_quantized(name, q, rows, caches, k_scales, v_scales, k_new_scale, v_new_scale,
                     valid, layer):
    """The int8/int4-KV kernels' argument checks -> (whether the scale slabs
    are stacked, (q, valid, k/v_new_scale, *rows) contiguous). rows: the
    fresh int8 rows; caches: the int8 slabs."""
    _cuda.require_cuda(name, q, *rows, *caches, k_scales, v_scales, k_new_scale, v_new_scale,
                       valid)
    L, B, Hkv, S, hd = caches[0].shape
    Hq = q.shape[1]
    if any(t.dtype != torch.int8 for t in (*rows, *caches)):
        raise TypeError(f"{name}: the cache and the fresh rows must be int8")
    for t in (k_scales, v_scales, k_new_scale, v_new_scale):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32")
    _cuda.require_shape(name, q, (B, Hq, hd))
    for t in rows:
        _cuda.require_shape(name, t, (B, Hkv, hd))
    for t in caches:
        _cuda.require_shape(name, t, caches[0].shape)
    _cuda.require_shape(name, k_new_scale, (B, Hkv))
    _cuda.require_shape(name, v_new_scale, (B, Hkv))
    _cuda.require_shape(name, valid, (B, S))
    stacked = k_scales.dim() == 4
    want = (L, B, Hkv, S) if stacked else (B, Hkv, S)
    _cuda.require_shape(name, k_scales, want)
    _cuda.require_shape(name, v_scales, want)
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if Hq % Hkv or Hq // Hkv not in (1, 2, 3, 4, 6, 8):
        raise ValueError(f"{name}: needs Hq/Hkv in (1, 2, 3, 4, 6, 8)")
    if hd % 16 or 32 % (hd // 16):
        raise ValueError(f"{name}: needs hd a multiple of 16 with hd/16 dividing 32")
    if not all(t.is_contiguous() for t in (*caches, k_scales, v_scales)) \
            or not all(_cuda.aligned16(t) for t in caches):
        raise ValueError(f"{name}: the cache and scale slabs must be contiguous, the cache "
                         "16-byte aligned")
    G = Hq // Hkv
    if 4 * (G * hd + G * S + 32 * G * hd) > 227 * 1024:
        raise ValueError(f"{name}: max_len {S} exceeds the shared-memory budget")
    return stacked, (q.contiguous(), valid.to(torch.int32).contiguous(),
                     k_new_scale.contiguous(), v_new_scale.contiguous(),
                     *(t.contiguous() for t in rows))


def decode_attention_q4_cuda(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                             v_new_scale, layer, offset, valid, scale):
    """Launch the int4 kernel (same arguments as the plain version)."""
    global launches_q4
    name = "decode_attention_quantized4_mono"
    stacked, (q, valid, ksn, vsn, kv_new) = _check_quantized(
        name, q, (kv_new,), (cache_kv,), k_scales, v_scales, k_new_scale, v_new_scale, valid,
        layer)
    L, B, Hkv, S, hd = cache_kv.shape
    Hq = q.shape[1]
    off = _offsets(offset, B, q.device)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    err = _cuda.library().al_decode_attention_q4(
        _cuda.dtype_code(q, name), q.data_ptr(), kv_new.data_ptr(), ksn.data_ptr(),
        vsn.data_ptr(), cache_kv.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
        off.data_ptr(), valid.data_ptr(), int(layer), int(layer) if stacked else 0, B, Hq, Hkv,
        S, hd, float(scale), out.data_ptr(), _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    launches_q4 += 1
    return out, cache_kv


def decode_attention_quantized4_mono(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                                     v_new_scale, layer, offset, valid, scale):
    """int4-KV decode attention -> (out [B, Hq, hd], cache_kv), the cache
    updated in place at slot `offset` (scalar or [B]) of layer `layer`.

    q [B, Hq, hd]; kv_new [B, Hkv, hd] int8 (models/llama.py
    quantize_kv_rows4); cache_kv [L, B, Hkv, max_len, hd] int8; k/v_scales
    the stacked [L, B, Hkv, max_len] f32 slabs or one layer's [B, Hkv,
    max_len]; k/v_new_scale [B, Hkv] f32; valid [B, max_len]. The caller
    writes the append slot's scales before the call: the kernel never reads
    them (the slot is dead in the slab; the fresh row enters from kv_new).
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    max_len = cache_kv.shape[3]
    if max_len % 32:
        raise ValueError(f"max_len % 32 != 0 ({max_len})")
    fn = decode_attention_q4_plain if q.device.type == "cpu" else decode_attention_q4_cuda
    return fn(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
              offset, valid, scale)


def decode_attention_q8_plain(q, k_new, v_new, cache_k, cache_v, k_scales, v_scales,
                              k_new_scale, v_new_scale, layer, offset, valid, scale):
    """The int8 kernel's arithmetic in PyTorch (appends in place): the fresh
    row's logit joins the slab's max, P meets V as (p * v_scale) rounded to
    q's dtype, the fresh row enters with weight exp(lf - m)."""
    L, B, Hkv, S, hd = cache_k.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    dev = cache_k.device
    off = _offsets(offset, B, dev)
    k_q = cache_k[layer].to(torch.float32)  # [B, Hkv, S, hd], read before the append
    v_q = cache_v[layer].to(torch.float32)
    ks = _layer_scales(k_scales, layer).to(torch.float32)
    vs = _layer_scales(v_scales, layer).to(torch.float32)
    qg = q.reshape(B, Hkv, G, hd).to(torch.float32)
    dead = (valid <= 0) | (torch.arange(S, device=dev)[None, :] == off[:, None])  # [B, S]
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_q) * (ks * scale)[:, :, None, :]
    logits = torch.where(dead[:, None, None, :], DEAD, logits)
    inside = (off >= 0) & (off < S)
    slot = off.clamp(0, S - 1).long()
    fresh_on = inside & (valid.gather(1, slot[:, None])[:, 0] > 0)  # [B]
    lf = torch.einsum("bhgd,bhd->bhg", qg, k_new.to(torch.float32))[..., None]
    lf = lf * (k_new_scale.to(torch.float32) * scale)[:, :, None, None]
    lf = torch.where(fresh_on[:, None, None, None], lf, DEAD)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), lf)
    p = torch.exp(logits - m)
    pf = torch.exp(lf - m)
    denom = p.sum(dim=-1, keepdim=True) + pf
    pv = (p * vs[:, :, None, :]).to(q.dtype).to(torch.float32)
    acc = torch.einsum("bhgs,bhsd->bhgd", pv, v_q)
    acc = acc + (pf * v_new_scale.to(torch.float32)[:, :, None, None]) \
        * v_new.to(torch.float32)[:, :, None, :]
    out = (acc / denom).to(q.dtype).reshape(B, Hq, hd)
    rows = torch.arange(B, device=dev)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        keep = cache[layer, rows, :, slot]  # [B, Hkv, hd]
        cache[layer, rows, :, slot] = torch.where(inside[:, None, None], new, keep)
    return out, cache_k, cache_v


def decode_attention_q8_cuda(q, k_new, v_new, cache_k, cache_v, k_scales, v_scales,
                             k_new_scale, v_new_scale, layer, offset, valid, scale):
    """Launch the int8 kernel (same arguments as the plain version)."""
    global launches_q8
    name = "decode_attention_quantized_mono"
    stacked, (q, valid, ksn, vsn, k_new, v_new) = _check_quantized(
        name, q, (k_new, v_new), (cache_k, cache_v), k_scales, v_scales, k_new_scale,
        v_new_scale, valid, layer)
    L, B, Hkv, S, hd = cache_k.shape
    Hq = q.shape[1]
    off = _offsets(offset, B, q.device)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    err = _cuda.library().al_decode_attention_q8(
        _cuda.dtype_code(q, name), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        ksn.data_ptr(), vsn.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), off.data_ptr(), valid.data_ptr(), int(layer),
        int(layer) if stacked else 0, B, Hq, Hkv, S, hd, float(scale), out.data_ptr(),
        _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    launches_q8 += 1
    return out, cache_k, cache_v


def decode_attention_quantized_mono(q, k_new, v_new, cache_k, cache_v, k_scales, v_scales,
                                    k_new_scale, v_new_scale, layer, offset, valid, scale):
    """int8-KV decode attention -> (out [B, Hq, hd], cache_k, cache_v), both
    caches updated in place at slot `offset` (scalar or [B]) of layer
    `layer`.

    q [B, Hq, hd]; k_new/v_new [B, Hkv, hd] int8 (models/llama.py
    quantize_kv_rows); cache_k/cache_v [L, B, Hkv, max_len, hd] int8;
    k/v_scales the stacked [L, B, Hkv, max_len] f32 slabs or one layer's;
    k/v_new_scale [B, Hkv] f32; valid [B, max_len]. As for the int4 kernel,
    the append slot's scales may be written before the call. The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    max_len = cache_k.shape[3]
    if max_len % 32:
        raise ValueError(f"max_len % 32 != 0 ({max_len})")
    fn = decode_attention_q8_plain if q.device.type == "cpu" else decode_attention_q8_cuda
    return fn(q, k_new, v_new, cache_k, cache_v, k_scales, v_scales, k_new_scale, v_new_scale,
              layer, offset, valid, scale)
