"""Timeline-sharded decode attention: the unnormalized flash statistics of
one rank's slab of the KV-cache timeline.

Counterpart of the stats entry points of
`audio_llama_tpu/ops/decode_attention_db.py`:
  - `decode_attention_db_stats` (bf16/f32 caches) replaces `_kernel` with
    stats=True;
  - `decode_attention_quantized_db_stats` (int8 caches) replaces
    `_kernel_quantized` with stats=True;
  - `decode_attention_quantized4_db_stats` (the K/V-combined int4 cache)
    replaces `_kernel_quantized4` with stats=True.
Their CUDA kernels are the three instances of `csrc/decode_attention_db.cu`;
`db_stats_plain`, `db_stats_q8_plain` and `db_stats_q4_plain` are the same
arithmetic in PyTorch, which the wrappers run on CPU tensors. The TPU
kernels' double-buffered slab DMAs (DEPTH) have no counterpart: a CUDA block
reads its slab rows directly.

Contract, as in the JAX package: q [B, Hq, hd]; the fresh rows [B, Hkv, hd];
the caches [L, B, Hkv, S, hd] hold this rank's S local slots (S % 32 == 0);
`local_offset` (a Python int) is the append slot in local coordinates,
outside [0, S) on a rank that does not own it; valid [B, S], nonzero where a
local slot may be attended (the caller folds global slot-causality and the
mask window into it). Over the slab with the fresh row standing at the
local offset: logits = scale * q.k (times the row's K scale when quantized),
-1e30 where not valid; m = max(rowmax, -5e29); p = valid ? exp(logits - m)
: 0; l = sum p; acc = sum p V, with p (times the row's V scale) rounded to
the cache dtype (bf16/f32 caches) or q's dtype (quantized) before it meets
V. Returns f32 m, l [B, Hq] and acc [B, Hq, hd], unnormalized, plus the
caches: the owner has written the fresh row at the local offset IN PLACE,
any other rank leaves them bit for bit unchanged. The scales of the fresh
row are written by the caller (owner-gated). Merge the ranks' statistics
with `ops.attention.merge_partial_stats`.
"""

from __future__ import annotations

import torch

from . import _cuda

launches = 0  # kernel launches through `decode_attention_db_stats`
launches_q8 = 0  # through `decode_attention_quantized_db_stats`
launches_q4 = 0  # through `decode_attention_quantized4_db_stats`
DEAD = -1e30  # an invalid lane's logit, as in the TPU kernel
FLOOR = -5e29  # the clamp of the row max: an all-invalid slab stays finite

FMT_CACHE, FMT_INT8, FMT_INT4 = 0, 1, 2


def _layer_scales(scales: torch.Tensor, layer: int) -> torch.Tensor:
    """[L, B, Hkv, S] stacked slabs (layer picked) or one layer's [B, Hkv, S]."""
    return scales[layer] if scales.dim() == 4 else scales


def _check_offset(local_offset) -> int:
    if isinstance(local_offset, torch.Tensor):
        raise TypeError("local_offset must be a Python int (the host's fill, so a decode "
                        "step needs no device sync)")
    return int(local_offset)


def _stats_plain(q, k_rows, v_rows, valid, scale, k_scale=None, v_scale=None, p_dtype=None):
    """(m, l, acc) over slabs k_rows/v_rows [B, Hkv, S, hd] (f32 values, the
    fresh row in place), optional per-row scales [B, Hkv, S]."""
    B, Hkv, S, hd = k_rows.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_rows)
    logits = logits * scale if k_scale is None else logits * (k_scale * scale)[:, :, None, :]
    ok = (valid > 0)[:, None, None, :]
    logits = torch.where(ok, logits, DEAD)
    m = logits.amax(dim=-1, keepdim=True).clamp(min=FLOOR)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1)
    pv = p if v_scale is None else p * v_scale[:, :, None, :]
    acc = torch.einsum("bhgs,bhsd->bhgd", pv.to(p_dtype).float(), v_rows)
    return m[..., 0].reshape(B, Hq), l.reshape(B, Hq), acc.reshape(B, Hq, hd)


def _append(cache, rows, layer, off):
    """The owner's in-place append of rows [B, Hkv, hd] at local slot off."""
    if 0 <= off < cache.shape[3]:
        cache[layer, :, :, off] = rows.to(cache.dtype)


def _with_fresh(slab_scales, new_scale, off):
    """One layer's scale slab [B, Hkv, S] (f32 copy) with the fresh row's
    scale standing at the local offset."""
    s = slab_scales.float().clone()
    if 0 <= off < s.shape[-1]:
        s[..., off] = new_scale.float()
    return s


def db_stats_plain(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid, scale):
    """The bf16/f32-cache kernel's arithmetic in PyTorch (appends in place)."""
    off = _check_offset(local_offset)
    _append(cache_k, k_new, layer, off)
    _append(cache_v, v_new, layer, off)
    m, l, acc = _stats_plain(q, cache_k[layer].float(), cache_v[layer].float(), valid, scale,
                             p_dtype=cache_v.dtype)
    return m, l, acc, cache_k, cache_v


def db_stats_q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                      v_new_scale, layer, local_offset, valid, scale):
    """The int8-cache kernel's arithmetic in PyTorch (appends the int8 rows
    in place; the scales are the caller's)."""
    off = _check_offset(local_offset)
    _append(cache_k, k_new_q, layer, off)
    _append(cache_v, v_new_q, layer, off)
    ks = _with_fresh(_layer_scales(k_scales, layer), k_new_scale, off)
    vs = _with_fresh(_layer_scales(v_scales, layer), v_new_scale, off)
    m, l, acc = _stats_plain(q, cache_k[layer].float(), cache_v[layer].float(), valid, scale,
                             ks, vs, p_dtype=q.dtype)
    return m, l, acc, cache_k, cache_v


def db_stats_q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale,
                      layer, local_offset, valid, scale):
    """The int4-cache kernel's arithmetic in PyTorch (appends the combined
    row in place; the scales are the caller's)."""
    off = _check_offset(local_offset)
    _append(cache_kv, kv_new, layer, off)
    b32 = cache_kv[layer].to(torch.int32)
    k_q = ((b32 & 0xF) - 8).float()  # K: offset-binary low nibble
    v_q = (b32 >> 4).float()  # V: signed high nibble
    ks = _with_fresh(_layer_scales(k_scales, layer), k_new_scale, off)
    vs = _with_fresh(_layer_scales(v_scales, layer), v_new_scale, off)
    m, l, acc = _stats_plain(q, k_q, v_q, valid, scale, ks, vs, p_dtype=q.dtype)
    return m, l, acc, cache_kv


def _launch(name, fmt, q, k_new, v_new, ck, cv, k_scales, v_scales, k_new_scale,
            v_new_scale, layer, local_offset, valid, scale):
    """Check the arguments and launch one instance -> (m, l, acc)."""
    off = _check_offset(local_offset)
    quant = fmt != FMT_CACHE
    tensors = [q, k_new, v_new, ck, cv, valid]
    if quant:
        tensors += [k_scales, v_scales, k_new_scale, v_new_scale]
    _cuda.require_cuda(name, *tensors)
    L, B, Hkv, S, hd = ck.shape
    Hq = q.shape[1]
    code = _cuda.dtype_code(q, name)
    _cuda.require_shape(name, cv, ck.shape)
    _cuda.require_shape(name, q, (B, Hq, hd))
    _cuda.require_shape(name, k_new, (B, Hkv, hd))
    _cuda.require_shape(name, v_new, (B, Hkv, hd))
    _cuda.require_shape(name, valid, (B, S))
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if quant:
        if any(t.dtype != torch.int8 for t in (k_new, v_new, ck, cv)):
            raise TypeError(f"{name}: the cache and the fresh rows must be int8")
        for t in (k_scales, v_scales, k_new_scale, v_new_scale):
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: scales must be float32")
        _cuda.require_shape(name, k_new_scale, (B, Hkv))
        _cuda.require_shape(name, v_new_scale, (B, Hkv))
        stacked = k_scales.dim() == 4
        want = (L, B, Hkv, S) if stacked else (B, Hkv, S)
        _cuda.require_shape(name, k_scales, want)
        _cuda.require_shape(name, v_scales, want)
        if not (k_scales.is_contiguous() and v_scales.is_contiguous()):
            raise ValueError(f"{name}: the scale slabs must be contiguous")
    elif not (ck.dtype == cv.dtype == q.dtype == k_new.dtype == v_new.dtype):
        raise TypeError(f"{name}: q, the fresh rows and both caches must share one dtype")
    if Hq % Hkv or Hq // Hkv not in (1, 2, 3, 4, 6, 8):
        raise ValueError(f"{name}: needs Hq/Hkv in (1, 2, 3, 4, 6, 8)")
    row_bytes = hd * ck.element_size()
    if row_bytes % 16 or 32 % (row_bytes // 16):
        raise ValueError(f"{name}: a row must be 16-byte vectors whose count divides 32")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError(f"{name}: the caches must be contiguous")
    q, valid = q.contiguous(), valid.to(torch.int32).contiguous()
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    if not all(_cuda.aligned16(t) for t in (ck, cv, k_new, v_new)):
        raise ValueError(f"{name}: the caches and fresh rows must be 16-byte aligned")
    G = Hq // Hkv
    if 4 * (G * hd + G * S + 32 * G * hd) > 227 * 1024:
        raise ValueError(f"{name}: {S} local slots exceed the shared-memory budget")
    m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    if quant:
        ksn, vsn = k_new_scale.contiguous(), v_new_scale.contiguous()
        scale_ptrs = (ksn.data_ptr(), vsn.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr())
        scale_layer = int(layer) if k_scales.dim() == 4 else 0
    else:
        scale_ptrs, scale_layer = (None,) * 4, 0
    err = _cuda.library().al_decode_db_stats(
        fmt, code, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), scale_ptrs[0],
        scale_ptrs[1], ck.data_ptr(), cv.data_ptr(), scale_ptrs[2], scale_ptrs[3],
        valid.data_ptr(), int(layer), scale_layer, off, B, Hq, Hkv, S, hd, float(scale),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), _cuda.stream_handle(q),
    )
    _cuda.check(err, name)
    return m, l, acc


def db_stats_cuda(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid, scale):
    """Launch the bf16/f32-cache kernel (same arguments as the plain version)."""
    global launches
    m, l, acc = _launch("decode_attention_db_stats", FMT_CACHE, q, k_new, v_new, cache_k,
                        cache_v, None, None, None, None, layer, local_offset, valid, scale)
    launches += 1
    return m, l, acc, cache_k, cache_v


def db_stats_q8_cuda(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                     v_new_scale, layer, local_offset, valid, scale):
    """Launch the int8-cache kernel (same arguments as the plain version)."""
    global launches_q8
    m, l, acc = _launch("decode_attention_quantized_db_stats", FMT_INT8, q, k_new_q, v_new_q,
                        cache_k, cache_v, k_scales, v_scales, k_new_scale, v_new_scale, layer,
                        local_offset, valid, scale)
    launches_q8 += 1
    return m, l, acc, cache_k, cache_v


def db_stats_q4_cuda(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale,
                     layer, local_offset, valid, scale):
    """Launch the int4-cache kernel (same arguments as the plain version)."""
    global launches_q4
    m, l, acc = _launch("decode_attention_quantized4_db_stats", FMT_INT4, q, kv_new, kv_new,
                        cache_kv, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
                        local_offset, valid, scale)
    launches_q4 += 1
    return m, l, acc, cache_kv


def _check_len(cache):
    if cache.shape[3] % 32:
        raise ValueError(f"max_len % 32 != 0 ({cache.shape[3]})")


def decode_attention_db_stats(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid,
                              scale):
    """-> (m, l, acc, cache_k, cache_v) over this rank's bf16/f32 slab; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_len(cache_k)
    fn = db_stats_plain if q.device.type == "cpu" else db_stats_cuda
    return fn(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid, scale)


def decode_attention_quantized_db_stats(q, k_new_q, v_new_q, cache_k, cache_v, k_scales,
                                        v_scales, k_new_scale, v_new_scale, layer,
                                        local_offset, valid, scale):
    """-> (m, l, acc, cache_k, cache_v) over this rank's int8 slabs (k/v
    scales: stacked [L, B, Hkv, S] or one layer's; the fresh rows' [B,
    Hkv]); the kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_len(cache_k)
    fn = db_stats_q8_plain if q.device.type == "cpu" else db_stats_q8_cuda
    return fn(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
              v_new_scale, layer, local_offset, valid, scale)


def decode_attention_quantized4_db_stats(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                                         v_new_scale, layer, local_offset, valid, scale):
    """-> (m, l, acc, cache_kv) over this rank's K/V-combined int4 slab; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_len(cache_kv)
    fn = db_stats_q4_plain if q.device.type == "cpu" else db_stats_q4_cuda
    return fn(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
              local_offset, valid, scale)
