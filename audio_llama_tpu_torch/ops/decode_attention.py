"""Single-buffered decode attention: append one K/V row at a scalar offset,
then attend one token per batch row over the whole cache timeline.

`decode_attention` replaces `audio_llama_tpu/ops/decode_attention.py::_kernel`
and `decode_attention_quantized` replaces `::_kernel_quantized` (the int8
cache with per-slot f32 scales); their CUDA kernel is the timeline decode
core's normalized mode (`csrc/decode_timeline.cuh`, bf16, f32 and int8
instances, shared with `ops/decode_attention_db.py`'s `decode_attention_db`
and `decode_attention_quantized_db`) through the entry
`al_decode_attention_single` (`csrc/decode_attention_norm.cu`), and
`decode_attention_plain` / `decode_attention_quantized_plain` are the same
arithmetic in PyTorch. No entry point of either package runs them: they are
the readable references beside the mono kernels the decoder runs
(`ops/decode_attention_mono.py`). The core runs a thread-block cluster along
the timeline per (batch row, KV head), launched at
`ops/decode_timeline.py::timeline_plan`; a timeline no plan fits raises
ValueError.

Contract, as in the JAX package: q [B, Hq, hd]; k_new/v_new [B, Hkv, hd];
cache_k/cache_v [L, B, Hkv, max_len, hd] with max_len % 32 == 0 (else
ValueError); `offset` one slot for every row; `valid` [B, max_len], nonzero
where a slot may be attended (the new slot included). The fresh rows are
written into layer `layer` at the offset IN PLACE (the returned caches are
the arguments); an offset outside [0, max_len) writes nothing and the slab is
attended as it is. The softmax is the TPU kernel's: masked logits -1e30, the
max over the whole slab, p divided by its sum and rounded to V's dtype BEFORE
p @ V (f32 accumulation), unlike the db kernels, which normalize at the end.
The int8 variant multiplies the logits by k_s * scale and p by v_s (both
patched at the offset from the fresh rows' scales) and never writes the
scale arrays: the caller updates them.
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_timeline import cache_fmt, timeline_plan

launches = 0  # kernel launches through `decode_attention`
launches_q8 = 0  # kernel launches through `decode_attention_quantized`
DEAD = -1e30  # the logit of a slot that is not attended, as in the TPU kernel


def _check_len(max_len: int, name: str) -> None:
    if max_len % 32:
        raise ValueError(f"{name} needs max_len % 32 == 0 (got {max_len}); build caches via "
                         "KVCache.zeros, which tile-rounds the timeline")


def _patch(rows, new, off: int):
    """rows [..., max_len] with slot `off` replaced by new [...] where off
    lies inside the timeline (registers only, as the TPU kernel's select)."""
    if 0 <= off < rows.shape[-1]:
        rows = rows.clone()
        rows[..., off] = new
    return rows


def _append(cache_k, cache_v, k_new, v_new, layer: int, off: int) -> None:
    if 0 <= off < cache_k.shape[3]:
        cache_k[layer, :, :, off] = k_new.to(cache_k.dtype)
        cache_v[layer, :, :, off] = v_new.to(cache_v.dtype)


def _softmax_pv(logits, valid, v, cdt, v_s=None):
    """[B, Hkv, G, S] f32 logits -> out [B, Hkv, G, hd] f32: masked to DEAD,
    p = exp(l - max) / sum, rounded to cdt (after the v scales) before p @ V."""
    logits = torch.where((valid != 0)[:, None, None, :], logits, DEAD)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    if v_s is not None:
        p = p * v_s[:, :, None, :]
    return torch.einsum("bhgs,bhsd->bhgd", p.to(cdt).float(), v.to(cdt).float())


def decode_attention_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """The kernel's arithmetic in PyTorch (updates the caches in place)."""
    L, B, Hkv, max_len, hd = cache_k.shape
    _check_len(max_len, "decode_attention")
    Hq = q.shape[1]
    off, li = int(offset), int(layer)
    _append(cache_k, cache_v, k_new, v_new, li, off)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, cache_k[li].float()) * scale
    out = _softmax_pv(logits, valid, cache_v[li], cache_v.dtype)
    return out.reshape(B, Hq, hd).to(q.dtype), cache_k, cache_v


def decode_attention_quantized_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales,
                                     v_scales, k_new_scale, v_new_scale, layer, offset, valid,
                                     scale):
    """The int8 kernel's arithmetic in PyTorch (the caches updated in place,
    the scale arrays untouched)."""
    L, B, Hkv, max_len, hd = cache_k.shape
    _check_len(max_len, "quantized decode")
    Hq = q.shape[1]
    off, li = int(offset), int(layer)
    cdt = q.dtype
    _append(cache_k, cache_v, k_new_q, v_new_q, li, off)
    k_s = _patch(k_scales.float(), k_new_scale.float(), off)  # [B, Hkv, S]
    v_s = _patch(v_scales.float(), v_new_scale.float(), off)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, cache_k[li].to(cdt).float())
    logits = logits * (k_s * scale)[:, :, None, :]
    out = _softmax_pv(logits, valid, cache_v[li], cdt, v_s)
    return out.reshape(B, Hq, hd).to(cdt), cache_k, cache_v


def _launch(name, quant, q, k_new, v_new, cache_k, cache_v, scales, layer, offset, valid,
            scale):
    L, B, Hkv, max_len, hd = cache_k.shape
    Hq = q.shape[1]
    _cuda.require_cuda(name, q, k_new, v_new, cache_k, cache_v, valid, *scales)
    _check_len(max_len, name)
    code = _cuda.dtype_code(q, name)
    _cuda.require_shape(name, cache_v, cache_k.shape)
    _cuda.require_shape(name, q, (B, Hq, hd))
    _cuda.require_shape(name, k_new, (B, Hkv, hd))
    _cuda.require_shape(name, v_new, (B, Hkv, hd))
    _cuda.require_shape(name, valid, (B, max_len))
    if quant:
        if cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8:
            raise TypeError(f"{name}: the caches must be int8")
        for s, shape in zip(scales, ((B, Hkv, max_len),) * 2 + ((B, Hkv),) * 2):
            _cuda.require_shape(name, s, shape)
    elif cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"{name}: q and both caches must share one dtype")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError(f"{name}: the caches must be contiguous")
    if Hq % Hkv or Hq // Hkv not in (1, 2, 3, 4, 6, 8):
        raise ValueError(f"{name}: needs Hq/Hkv in (1, 2, 3, 4, 6, 8)")
    row_bytes = hd * cache_k.element_size()
    if row_bytes % 16 or 32 % (row_bytes // 16) or not _cuda.aligned16(cache_k) \
            or not _cuda.aligned16(cache_v):
        raise ValueError(f"{name}: cache rows must be 16-byte vectors, at most 32 per row")
    plan = timeline_plan(B, Hkv, max_len, Hq // Hkv, hd,
                         cache_fmt("int8" if quant else q.dtype))
    off = torch.as_tensor(offset, dtype=torch.int32, device=q.device).reshape(1)
    valid = _cuda.contiguous16(valid.to(torch.int32))
    q = q.contiguous()
    k_new = _cuda.contiguous16(k_new.to(cache_k.dtype))
    v_new = _cuda.contiguous16(v_new.to(cache_v.dtype))
    scales = [_cuda.contiguous16(s.to(torch.float32)) for s in scales]
    ptrs = [s.data_ptr() for s in scales] if quant else [None] * 4
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    err = _cuda.library().al_decode_attention_single(
        code, int(quant), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), *ptrs, off.data_ptr(), valid.data_ptr(),
        int(layer), B, Hq, Hkv, max_len, hd, float(scale), out.data_ptr(), plan.C,
        plan.stages, _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    return out


def decode_attention_cuda(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    out = _launch("decode_attention", False, q, k_new, v_new, cache_k, cache_v, (), layer,
                  offset, valid, scale)
    launches += 1
    return out, cache_k, cache_v


def decode_attention_quantized_cuda(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales,
                                    k_new_scale, v_new_scale, layer, offset, valid, scale):
    """Launch the int8 kernel (same arguments as the plain version)."""
    global launches_q8
    out = _launch("decode_attention_quantized", True, q, k_new_q, v_new_q, cache_k, cache_v,
                  (k_scales, v_scales, k_new_scale, v_new_scale), layer, offset, valid, scale)
    launches_q8 += 1
    return out, cache_k, cache_v


def decode_attention(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """-> (attn [B, Hq, hd], cache_k, cache_v), the caches updated in place.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = decode_attention_plain if q.device.type == "cpu" else decode_attention_cuda
    return fn(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale)


def decode_attention_quantized(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales,
                               k_new_scale, v_new_scale, layer, offset, valid, scale):
    """int8-cache variant -> (attn, cache_k, cache_v); the scale arrays are the
    caller's to update. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    fn = (decode_attention_quantized_plain if q.device.type == "cpu"
          else decode_attention_quantized_cuda)
    return fn(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
              v_new_scale, layer, offset, valid, scale)
