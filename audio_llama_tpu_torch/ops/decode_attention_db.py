"""Decode attention over whole (batch row, KV head) slabs of the KV-cache
timeline, appending the fresh row in place: the normalized output of
single-device decode, and the unnormalized flash statistics of one rank's
slab in timeline-sharded decode.

Counterpart of `audio_llama_tpu/ops/decode_attention_db.py`:
  - `decode_attention_db` (bf16/f32 caches), `decode_attention_quantized_db`
    (int8 caches) and `decode_attention_quantized4_db` (the K/V-combined
    int4 cache) replace `_kernel`, `_kernel_quantized` and
    `_kernel_quantized4` with stats=False: `llama_forward`'s
    `attn_impl='decode_kernel'`;
  - `decode_attention_db_stats`, `decode_attention_quantized_db_stats` and
    `decode_attention_quantized4_db_stats` replace the same three with
    stats=True: every decode step under `sp_axis`.
Their CUDA kernels are the two modes and three cache formats of the
timeline decode core's kernel, `db_kernel` (the stats mode's instances and
entry in `csrc/decode_attention_db.cu`, the normalized mode's in
`csrc/decode_attention_norm.cu`); `db_plain`, `db_q8_plain`, `db_q4_plain` and
`db_stats_plain`, `db_stats_q8_plain`, `db_stats_q4_plain` are the same
arithmetic in PyTorch, which the wrappers run on CPU tensors. The kernels
run on the timeline decode core (`csrc/decode_timeline.cuh`): a
thread-block cluster along the timeline per (batch row, KV head), each
block streaming its range of the slab through a ring of bulk copies (the TPU
kernels' double-buffered slab DMAs), launched at
`ops/decode_timeline.py::timeline_plan`; a timeline no plan fits raises
ValueError.

Contract, as in the JAX package: q [B, Hq, hd]; the fresh rows [B, Hkv, hd];
the caches [L, B, Hkv, S, hd] (S % 32 == 0); the offset (a Python int: the
host's fill, `KVCache.host_length`, so a decode step needs no device sync)
is the append slot, in local coordinates in the stats mode, outside [0, S)
on a rank that does not own it; valid [B, S], nonzero where a slot may be
attended (the caller folds slot-causality and the mask into it). The scales
of the quantized caches are stacked [L, B, Hkv, S] (the layer picked) or one
layer's [B, Hkv, S]; the fresh rows' are [B, Hkv]. Over the slab with the
fresh row (and its scales) standing at the offset: logits = scale * q.k
(times the row's K scale when quantized), -1e30 where not valid; then
  - normalized: m = the row max (no clamp); p = exp(logits - m) (no mask:
    an all-invalid row averages its slab, as on the TPU); p = p / sum p in
    f32; out = sum p V with p (times the row's V scale) rounded to the cache
    dtype (bf16/f32 caches) or q's dtype (quantized) before it meets V;
    returned in q's dtype;
  - stats: m = max(rowmax, -5e29); p = valid ? exp(logits - m) : 0; l = sum
    p; acc = sum p V with the same rounding; f32 m, l [B, Hq] and acc [B,
    Hq, hd], unnormalized. Merge the ranks' statistics with
    `ops.attention.merge_partial_stats`.
Both return the caches: the owner of the slot has written the fresh row
there IN PLACE, any other rank leaves them bit for bit unchanged. The scales
of the fresh row are written by the caller, after the call (as the JAX
package's `write_scales` after the normalized kernels; owner-gated under sp).
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_timeline import cache_fmt, timeline_plan

launches = 0  # kernel launches through `decode_attention_db_stats`
launches_q8 = 0  # through `decode_attention_quantized_db_stats`
launches_q4 = 0  # through `decode_attention_quantized4_db_stats`
launches_norm = 0  # through `decode_attention_db`
launches_norm_q8 = 0  # through `decode_attention_quantized_db`
launches_norm_q4 = 0  # through `decode_attention_quantized4_db`
DEAD = -1e30  # an invalid lane's logit, as in the TPU kernel
FLOOR = -5e29  # the stats mode's clamp of the row max: an all-invalid slab stays finite

FMT_CACHE, FMT_INT8, FMT_INT4 = 0, 1, 2


def layer_scales(scales: torch.Tensor, layer: int) -> torch.Tensor:
    """[L, B, Hkv, S] stacked slabs (layer picked) or one layer's [B, Hkv, S]."""
    return scales[layer] if scales.dim() == 4 else scales


def check_offset(offset) -> int:
    if isinstance(offset, torch.Tensor):
        raise TypeError("the offset must be a Python int (the host's fill, so a decode step "
                        "needs no device sync)")
    return int(offset)


def _attend_plain(q, k_rows, v_rows, valid, scale, k_scale=None, v_scale=None, p_dtype=None,
                  normalized=False):
    """Over slabs k_rows/v_rows [B, Hkv, S, hd] (f32 values, the fresh row
    in place), optional per-row scales [B, Hkv, S]: out [B, Hq, hd] in q's
    dtype (normalized) or (m, l, acc)."""
    B, Hkv, S, hd = k_rows.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_rows)
    logits = logits * scale if k_scale is None else logits * (k_scale * scale)[:, :, None, :]
    ok = (valid > 0)[:, None, None, :]
    logits = torch.where(ok, logits, DEAD)
    m = logits.amax(dim=-1, keepdim=True)
    if normalized:
        p = torch.exp(logits - m)
        p = p / p.sum(dim=-1, keepdim=True)
    else:
        m = m.clamp(min=FLOOR)
        p = torch.where(ok, torch.exp(logits - m), 0.0)
    pv = p if v_scale is None else p * v_scale[:, :, None, :]
    acc = torch.einsum("bhgs,bhsd->bhgd", pv.to(p_dtype).float(), v_rows)
    if normalized:
        return acc.reshape(B, Hq, hd).to(q.dtype)
    return m[..., 0].reshape(B, Hq), p.sum(dim=-1).reshape(B, Hq), acc.reshape(B, Hq, hd)


def append_row(cache, rows, layer, off):
    """The owner's in-place append of rows [B, Hkv, hd] at local slot off."""
    if 0 <= off < cache.shape[3]:
        cache[layer, :, :, off] = rows.to(cache.dtype)


def with_fresh(slab_scales, new_scale, off):
    """One layer's scale slab [B, Hkv, S] (f32 copy) with the fresh row's
    scale standing at the local offset."""
    s = slab_scales.float().clone()
    if 0 <= off < s.shape[-1]:
        s[..., off] = new_scale.float()
    return s


def _cache_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale,
                 normalized):
    """The bf16/f32-cache kernel's arithmetic in PyTorch (appends in place)."""
    off = check_offset(offset)
    append_row(cache_k, k_new, layer, off)
    append_row(cache_v, v_new, layer, off)
    return _attend_plain(q, cache_k[layer].float(), cache_v[layer].float(), valid, scale,
                         p_dtype=cache_v.dtype, normalized=normalized)


def _q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
              v_new_scale, layer, offset, valid, scale, normalized):
    """The int8-cache kernel's arithmetic in PyTorch (appends the int8 rows
    in place; the scales are the caller's)."""
    off = check_offset(offset)
    append_row(cache_k, k_new_q, layer, off)
    append_row(cache_v, v_new_q, layer, off)
    ks = with_fresh(layer_scales(k_scales, layer), k_new_scale, off)
    vs = with_fresh(layer_scales(v_scales, layer), v_new_scale, off)
    return _attend_plain(q, cache_k[layer].float(), cache_v[layer].float(), valid, scale,
                         ks, vs, p_dtype=q.dtype, normalized=normalized)


def _q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
              offset, valid, scale, normalized):
    """The int4-cache kernel's arithmetic in PyTorch (appends the combined
    row in place; the scales are the caller's)."""
    off = check_offset(offset)
    append_row(cache_kv, kv_new, layer, off)
    b32 = cache_kv[layer].to(torch.int32)
    k_q = ((b32 & 0xF) - 8).float()  # K: offset-binary low nibble
    v_q = (b32 >> 4).float()  # V: signed high nibble
    ks = with_fresh(layer_scales(k_scales, layer), k_new_scale, off)
    vs = with_fresh(layer_scales(v_scales, layer), v_new_scale, off)
    return _attend_plain(q, k_q, v_q, valid, scale, ks, vs, p_dtype=q.dtype,
                         normalized=normalized)


def db_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """-> (out, cache_k, cache_v): the normalized bf16/f32-cache kernel."""
    out = _cache_plain(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale, True)
    return out, cache_k, cache_v


def db_q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                v_new_scale, layer, offset, valid, scale):
    """-> (out, cache_k, cache_v): the normalized int8-cache kernel."""
    out = _q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                    v_new_scale, layer, offset, valid, scale, True)
    return out, cache_k, cache_v


def db_q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
                offset, valid, scale):
    """-> (out, cache_kv): the normalized int4-cache kernel."""
    out = _q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
                    offset, valid, scale, True)
    return out, cache_kv


def db_stats_plain(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid, scale):
    """-> (m, l, acc, cache_k, cache_v): the bf16/f32-cache stats kernel."""
    m, l, acc = _cache_plain(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid,
                             scale, False)
    return m, l, acc, cache_k, cache_v


def db_stats_q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                      v_new_scale, layer, local_offset, valid, scale):
    """-> (m, l, acc, cache_k, cache_v): the int8-cache stats kernel."""
    m, l, acc = _q8_plain(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales,
                          k_new_scale, v_new_scale, layer, local_offset, valid, scale, False)
    return m, l, acc, cache_k, cache_v


def db_stats_q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale,
                      layer, local_offset, valid, scale):
    """-> (m, l, acc, cache_kv): the int4-cache stats kernel."""
    m, l, acc = _q4_plain(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale,
                          layer, local_offset, valid, scale, False)
    return m, l, acc, cache_kv


def check_args(name, q, k_new, v_new, ck, cv, valid, layer, quant_args=None) -> int:
    """Check what the slab kernels (db, packed) take -> q's dtype code.
    quant_args: (k_scales, v_scales, k_new_scale, v_new_scale) of an int8
    or int4 cache, the slabs' scales stacked [L, B, Hkv, S] or one layer's
    [B, Hkv, S]."""
    _cuda.require_cuda(name, q, k_new, v_new, ck, cv, valid, *(quant_args or ()))
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
    if quant_args is not None:
        k_scales, v_scales, k_new_scale, v_new_scale = quant_args
        if any(t.dtype != torch.int8 for t in (k_new, v_new, ck, cv)):
            raise TypeError(f"{name}: the cache and the fresh rows must be int8")
        if any(t.dtype != torch.float32 for t in quant_args):
            raise TypeError(f"{name}: scales must be float32")
        _cuda.require_shape(name, k_new_scale, (B, Hkv))
        _cuda.require_shape(name, v_new_scale, (B, Hkv))
        want = (L, B, Hkv, S) if k_scales.dim() == 4 else (B, Hkv, S)
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
    if not all(_cuda.aligned16(t) for t in (ck, cv, k_new.contiguous(), v_new.contiguous())):
        raise ValueError(f"{name}: the caches and fresh rows must be 16-byte aligned")
    return code


def quant_pointers(quant_args, layer):
    """-> ((fresh K scale, fresh V scale, K slab, V slab) pointers or Nones,
    the layer of the scale slabs)."""
    if quant_args is None:
        return (None,) * 4, 0
    k_scales, v_scales, k_new_scale, v_new_scale = quant_args
    ksn, vsn = k_new_scale.contiguous(), v_new_scale.contiguous()
    return ((ksn.data_ptr(), vsn.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr()),
            int(layer) if k_scales.dim() == 4 else 0)


def _launch(name, fmt, normalized, q, k_new, v_new, ck, cv, quant_args, layer, offset, valid,
            scale):
    """Check the arguments and launch one instance -> out, or (m, l, acc)."""
    off = check_offset(offset)
    code = check_args(name, q, k_new, v_new, ck, cv, valid, layer, quant_args)
    L, B, Hkv, S, hd = ck.shape
    Hq = q.shape[1]
    plan = timeline_plan(B, Hkv, S, Hq // Hkv, hd,
                         cache_fmt(q.dtype) if fmt == FMT_CACHE else ("int8", "int4")[fmt - 1])
    q, valid = q.contiguous(), _cuda.contiguous16(valid.to(torch.int32))
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    if quant_args is not None and not all(_cuda.aligned16(t) for t in quant_args[:2]):
        raise ValueError(f"{name}: the scale slabs must be 16-byte aligned")
    ptrs, scale_layer = quant_pointers(quant_args, layer)
    head = (fmt, code, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ptrs[0], ptrs[1],
            ck.data_ptr(), cv.data_ptr(), ptrs[2], ptrs[3], valid.data_ptr(), int(layer),
            scale_layer, off, B, Hq, Hkv, S, hd, float(scale))
    tail = (plan.C, plan.stages, _cuda.stream_handle(q))
    lib = _cuda.library()
    if normalized:
        out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
        _cuda.check(lib.al_decode_db(*head, out.data_ptr(), *tail), name)
        return out
    m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    _cuda.check(lib.al_decode_db_stats(*head, m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                                       *tail), name)
    return m, l, acc


def db_cuda(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """Launch the normalized bf16/f32-cache kernel (the plain version's arguments)."""
    global launches_norm
    out = _launch("decode_attention_db", FMT_CACHE, True, q, k_new, v_new, cache_k, cache_v,
                  None, layer, offset, valid, scale)
    launches_norm += 1
    return out, cache_k, cache_v


def db_q8_cuda(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
               v_new_scale, layer, offset, valid, scale):
    """Launch the normalized int8-cache kernel (the plain version's arguments)."""
    global launches_norm_q8
    out = _launch("decode_attention_quantized_db", FMT_INT8, True, q, k_new_q, v_new_q,
                  cache_k, cache_v, (k_scales, v_scales, k_new_scale, v_new_scale), layer,
                  offset, valid, scale)
    launches_norm_q8 += 1
    return out, cache_k, cache_v


def db_q4_cuda(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer,
               offset, valid, scale):
    """Launch the normalized int4-cache kernel (the plain version's arguments)."""
    global launches_norm_q4
    out = _launch("decode_attention_quantized4_db", FMT_INT4, True, q, kv_new, kv_new,
                  cache_kv, cache_kv, (k_scales, v_scales, k_new_scale, v_new_scale), layer,
                  offset, valid, scale)
    launches_norm_q4 += 1
    return out, cache_kv


def db_stats_cuda(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid, scale):
    """Launch the bf16/f32-cache stats kernel (the plain version's arguments)."""
    global launches
    m, l, acc = _launch("decode_attention_db_stats", FMT_CACHE, False, q, k_new, v_new,
                        cache_k, cache_v, None, layer, local_offset, valid, scale)
    launches += 1
    return m, l, acc, cache_k, cache_v


def db_stats_q8_cuda(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale,
                     v_new_scale, layer, local_offset, valid, scale):
    """Launch the int8-cache stats kernel (the plain version's arguments)."""
    global launches_q8
    m, l, acc = _launch("decode_attention_quantized_db_stats", FMT_INT8, False, q, k_new_q,
                        v_new_q, cache_k, cache_v, (k_scales, v_scales, k_new_scale,
                                                    v_new_scale), layer, local_offset, valid,
                        scale)
    launches_q8 += 1
    return m, l, acc, cache_k, cache_v


def db_stats_q4_cuda(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale,
                     layer, local_offset, valid, scale):
    """Launch the int4-cache stats kernel (the plain version's arguments)."""
    global launches_q4
    m, l, acc = _launch("decode_attention_quantized4_db_stats", FMT_INT4, False, q, kv_new,
                        kv_new, cache_kv, cache_kv, (k_scales, v_scales, k_new_scale,
                                                     v_new_scale), layer, local_offset, valid,
                        scale)
    launches_q4 += 1
    return m, l, acc, cache_kv


def check_len(cache):
    if cache.shape[3] % 32:
        raise ValueError(f"max_len % 32 != 0 ({cache.shape[3]})")


def _pick(q, plain, cuda):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    return plain if q.device.type == "cpu" else cuda


def decode_attention_db(q, k_new, v_new, cache_k, cache_v, layer, offset, valid, scale):
    """-> (out [B, Hq, hd] in q's dtype, cache_k, cache_v) over the bf16/f32
    slabs, the fresh rows appended at `offset` in place."""
    check_len(cache_k)
    return _pick(q, db_plain, db_cuda)(q, k_new, v_new, cache_k, cache_v, layer, offset,
                                       valid, scale)


def decode_attention_quantized_db(q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales,
                                  k_new_scale, v_new_scale, layer, offset, valid, scale):
    """-> (out, cache_k, cache_v) over the int8 slabs (k/v scales: stacked
    [L, B, Hkv, S] or one layer's; the fresh rows' [B, Hkv])."""
    check_len(cache_k)
    return _pick(q, db_q8_plain, db_q8_cuda)(q, k_new_q, v_new_q, cache_k, cache_v, k_scales,
                                             v_scales, k_new_scale, v_new_scale, layer,
                                             offset, valid, scale)


def decode_attention_quantized4_db(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                                   v_new_scale, layer, offset, valid, scale):
    """-> (out, cache_kv) over the K/V-combined int4 slab."""
    check_len(cache_kv)
    return _pick(q, db_q4_plain, db_q4_cuda)(q, kv_new, cache_kv, k_scales, v_scales,
                                             k_new_scale, v_new_scale, layer, offset, valid,
                                             scale)


def decode_attention_db_stats(q, k_new, v_new, cache_k, cache_v, layer, local_offset, valid,
                              scale):
    """-> (m, l, acc, cache_k, cache_v) over this rank's bf16/f32 slab."""
    check_len(cache_k)
    return _pick(q, db_stats_plain, db_stats_cuda)(q, k_new, v_new, cache_k, cache_v, layer,
                                                   local_offset, valid, scale)


def decode_attention_quantized_db_stats(q, k_new_q, v_new_q, cache_k, cache_v, k_scales,
                                        v_scales, k_new_scale, v_new_scale, layer,
                                        local_offset, valid, scale):
    """-> (m, l, acc, cache_k, cache_v) over this rank's int8 slabs."""
    check_len(cache_k)
    return _pick(q, db_stats_q8_plain, db_stats_q8_cuda)(
        q, k_new_q, v_new_q, cache_k, cache_v, k_scales, v_scales, k_new_scale, v_new_scale,
        layer, local_offset, valid, scale)


def decode_attention_quantized4_db_stats(q, kv_new, cache_kv, k_scales, v_scales, k_new_scale,
                                         v_new_scale, layer, local_offset, valid, scale):
    """-> (m, l, acc, cache_kv) over this rank's K/V-combined int4 slab."""
    check_len(cache_kv)
    return _pick(q, db_stats_q4_plain, db_stats_q4_cuda)(
        q, kv_new, cache_kv, k_scales, v_scales, k_new_scale, v_new_scale, layer, local_offset,
        valid, scale)
