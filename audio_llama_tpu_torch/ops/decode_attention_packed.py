"""Timeline-chunked single-token decode attention with an online softmax
across the chunks, appending the fresh row in place.

Counterpart of `audio_llama_tpu/ops/decode_attention_packed.py`:
`decode_attention_packed` (bf16/f32 caches) and
`decode_attention_quantized_packed` (int8 caches with per-row f32 scales)
replace `_kernel`, `llama_forward`'s `attn_impl='decode_packed'` (it has no
int4-KV variant). Their CUDA kernel is `csrc/decode_attention_packed.cu`,
two launches a call; `packed_plain` is the TPU kernel's arithmetic in
PyTorch, chunk by chunk, which the wrappers run on CPU tensors. The TPU
kernel's slab DMA pipeline (PACKED_DEPTH) has no counterpart; its chunk
length is the JAX package's default (PACKED_CHUNK unset), and the same
`pick_chunk` cuts the timeline, since the chunk length changes the result.

Contract, as in the JAX package's: q [B, Hq, hd]; the fresh rows [B, Hkv,
hd]; the caches [L, B, Hkv, S, hd] (S % 32 == 0); `offset` a Python int
(the host's fill, so a decode step needs no device sync), the append slot;
valid [B, S], nonzero where a slot may be attended; the int8 caches' scales
stacked [L, B, Hkv, S] (the layer picked) or one layer's [B, Hkv, S], the
fresh rows' [B, Hkv]. The timeline is cut into NC = S / CH chunks, and for
each chunk in order, over its slots with the fresh row (and its scales)
standing at the offset:
  s = scale * q.k (times the row's K scale), -1e30 where not valid;
  m_new = max(m, max s) (m starts at -1e30); alpha = exp(m - m_new);
  p = valid ? exp((s - m_new) rounded to q's dtype), rounded to q's dtype : 0;
  l = alpha * l + sum p (f32);
  acc = alpha * acc + sum (p, or (p * v_scale) rounded to q's dtype) * V;
then out = acc / l in q's dtype. A chunk whose every slot is invalid adds
exactly 0. The fresh rows are written into the caches at the offset IN
PLACE (nothing outside [0, S)); the caller writes their scales.
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_attention_db import (DEAD, FMT_CACHE, FMT_INT8, append_row, check_args,
                                  check_len, check_offset, layer_scales, quant_pointers,
                                  with_fresh)

launches = 0  # kernel launches through `decode_attention_packed` (two a call)
launches_q8 = 0  # through `decode_attention_quantized_packed` (two a call)
DEFAULT_CHUNK = 512  # the JAX package's default timeline chunk


def pick_chunk(max_len: int, chunk: int) -> int:
    """The largest multiple of 32 that divides max_len and is <= chunk (the
    JAX package's `_pick_chunk`, which falls back to 32)."""
    c = (min(chunk, max_len) // 32) * 32
    while max_len % c != 0:
        c -= 32
        if c <= 32:
            return 32
    return c


def packed_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale,
                 chunk: int = DEFAULT_CHUNK, quant_args=None):
    """-> (out, cache_k, cache_v): the TPU kernel's arithmetic, chunk by
    chunk. quant_args: (k_scales, v_scales, k_new_scale, v_new_scale) for
    the int8 cache."""
    check_len(cache_k)
    off = check_offset(offset)
    append_row(cache_k, k_new, layer, off)
    append_row(cache_v, v_new, layer, off)
    k_rows, v_rows = cache_k[layer].float(), cache_v[layer].float()
    ks = vs = None
    if quant_args is not None:
        k_scales, v_scales, k_new_scale, v_new_scale = quant_args
        ks = with_fresh(layer_scales(k_scales, layer), k_new_scale, off)
        vs = with_fresh(layer_scales(v_scales, layer), v_new_scale, off)
    B, Hkv, S, hd = k_rows.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    cdt = q.dtype
    CH = pick_chunk(S, chunk)
    qg = q.reshape(B, Hkv, G, hd).float()
    m = torch.full((B, Hkv, G, 1), DEAD, device=q.device)
    l = torch.zeros((B, Hkv, G, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, hd), device=q.device)
    zero = torch.zeros((), dtype=cdt, device=q.device)
    for c0 in range(0, S, CH):
        sl = slice(c0, c0 + CH)
        s = torch.einsum("bhgd,bhsd->bhgs", qg, k_rows[:, :, sl])
        s = s * scale if ks is None else s * (ks[..., sl] * scale)[:, :, None, :]
        ok = (valid[:, sl] > 0)[:, None, None, :]
        s = torch.where(ok, s, DEAD)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp((s - m_new).to(cdt)), zero)
        l = alpha * l + p.float().sum(dim=-1, keepdim=True)
        pv_in = p if vs is None else (p.float() * vs[..., sl][:, :, None, :]).to(cdt)
        acc = alpha * acc + torch.einsum("bhgs,bhsd->bhgd", pv_in.float(), v_rows[:, :, sl])
        m = m_new
    return (acc / l).reshape(B, Hq, hd).to(cdt), cache_k, cache_v


def packed_cuda(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale,
                chunk: int = DEFAULT_CHUNK, quant_args=None):
    """Launch the kernel (the plain version's arguments); two launches."""
    global launches, launches_q8
    name = "decode_attention_packed" if quant_args is None else \
        "decode_attention_quantized_packed"
    check_len(cache_k)
    off = check_offset(offset)
    code = check_args(name, q, k_new, v_new, cache_k, cache_v, valid, layer, quant_args)
    _, B, Hkv, S, hd = cache_k.shape
    Hq = q.shape[1]
    CH = pick_chunk(S, chunk)
    NC = S // CH
    q, valid = q.contiguous(), valid.to(torch.int32).contiguous()
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    ptrs, scale_layer = quant_pointers(quant_args, layer)
    f32 = dict(dtype=torch.float32, device=q.device)
    s_ws = torch.empty((B, Hq, S), **f32)
    cmax = torch.empty((B, Hq, NC), **f32)
    wl = torch.empty((B, Hq, NC), **f32)
    wacc = torch.empty((B, Hq, NC, hd), **f32)
    counters = _cuda.counters(q.device, B * Hkv)
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    err = _cuda.library().al_decode_packed(
        FMT_CACHE if quant_args is None else FMT_INT8, code, q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ptrs[0], ptrs[1], cache_k.data_ptr(), cache_v.data_ptr(), ptrs[2],
        ptrs[3], valid.data_ptr(), int(layer), scale_layer, off, B, Hq, Hkv, S, hd, CH,
        float(scale), s_ws.data_ptr(), cmax.data_ptr(), wl.data_ptr(), wacc.data_ptr(),
        counters.data_ptr(), out.data_ptr(), _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    if quant_args is None:
        launches += 2
    else:
        launches_q8 += 2
    return out, cache_k, cache_v


def decode_attention_packed(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale,
                            chunk: int = DEFAULT_CHUNK):
    """-> (out [B, Hq, hd] in q's dtype, cache_k, cache_v) over the bf16/f32
    caches; the kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = packed_plain if q.device.type == "cpu" else packed_cuda
    return fn(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale, chunk)


def decode_attention_quantized_packed(q, k_new_q, v_new_q, cache_k, cache_v, k_scales,
                                      v_scales, k_new_scale, v_new_scale, layer, offset, valid,
                                      scale, chunk: int = DEFAULT_CHUNK):
    """-> (out, cache_k, cache_v) over the int8 caches."""
    fn = packed_plain if q.device.type == "cpu" else packed_cuda
    return fn(q, k_new_q, v_new_q, cache_k, cache_v, layer, offset, valid, scale, chunk,
              quant_args=(k_scales, v_scales, k_new_scale, v_new_scale))
