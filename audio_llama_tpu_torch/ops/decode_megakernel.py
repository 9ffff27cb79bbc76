"""Whole-stack int4 decode step for one request: every layer of the decoder
(rms norm, q|k|v, rope, int4 KV-row quantization, attention with the fresh
row entered analytically, o and the residual, rms norm, gate|up, SiLU * up,
down and the residual) in ONE kernel launch.

Counterpart of `audio_llama_tpu/ops/decode_megakernel.py`; the kernel
`decode_megakernel` replaces `_kernel`. Its CUDA kernel is
`csrc/decode_megakernel.cu` (the source note gives the bound and the
design: one cooperative launch, a persistent grid with grid-wide barriers
between the phases of each layer). `decode_megakernel_plain` is the same
arithmetic in PyTorch, with the TPU kernel's rounding points: the q|k|v
planes summed in f32 and rounded to the compute dtype, rope in f32 rounded
to the compute dtype before the int4 row quantization, the int4-KV
attention of `decode_attention_q4_plain`, o rounded to the compute dtype
before its residual add, a = g * sigmoid(g) * u in f32 rounded to the
compute dtype, and each down column summed over its 128-row groups in
order (the TPU kernel's `dn_acc`) before its residual add.

Layouts (the fused int4 tree of `models/llama_int4.py`, one request):
  x [1, D] compute dtype (the embedded token, after the QuaRot rotation);
  qkv, o, gu, dn: {'w_p' int8 [L, K, N/2], 'w_s' f32 [L, K/128, N]};
  input_ln, post_attn_ln [L, D]; cos, sin [hd] f32 at the append position;
  cache_kv [L, 1, Hkv, Tk, hd] int8 (K/V-combined int4 rows);
  k_scales, v_scales [L, 1, Hkv, Tk] f32; offset a scalar int32 tensor;
  valid [1, Tk] int32.
Returns (hidden [1, D], cache_kv, fresh [L, Hkv, 2] f32): the fresh rows'
(k, v) scales. The packed rows and their scales are written in place at
slot `offset` of every layer (nothing for an offset outside the cache).
"""

from __future__ import annotations

import torch

from . import _cuda
from .decode_attention_mono import decode_attention_q4_plain
from .int4_matmul import FMT_CODE, GROUP, _fmt, _unpack_planes, int4_matmul_stacked_plain
from .norms import rms_norm
from .rope import apply_rope

launches = 0  # kernel launches through `decode_megakernel`

SLABS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
KV_GROUPS = (1, 2, 3, 4)  # query heads per KV head the kernel is built for
TILE = 32  # packed columns per work tile of the kernel
WARPS = 8  # warps per block of the kernel
SMEM_LIMIT = 227 * 1024 - 1024  # dynamic shared memory of a block; 1 KB left for its static


def smem_bytes(D: int, Hq: int, F: int, G: int, Tk: int, hd: int) -> int:
    """Dynamic shared memory of one block: the larger of a projection phase
    (the input row and one f32 partial per group and tile column) and the
    attention phase (q, k, v, the logits, the per-warp PV partials)."""
    kmax = max(D, Hq * hd, F)
    return 4 * max(kmax + kmax // 2, G * hd * (1 + WARPS) + 2 * hd + G * Tk)


def ok_for(cfg, slabs, Tk: int, offset: int, device=None) -> bool:
    """Whether the megakernel takes this step: the fused int4 slabs with 128-row
    groups, head_dim 128, tile-aligned packed widths, a supported number of
    query heads per KV head, a 32-slot cache timeline with the append slot
    inside it (a full cache keeps the per-layer path), the shared memory of
    one block, and on the card at least one co-resident block per SM."""
    if any(n not in slabs for n in SLABS) or any("w_r" in slabs[n] for n in SLABS):
        return False
    hd = cfg.head_dim
    if hd != 128 or cfg.num_heads % cfg.num_kv_heads:
        return False
    G = cfg.num_heads // cfg.num_kv_heads
    if G not in KV_GROUPS:
        return False
    for n in SLABS:
        w = slabs[n]
        if w["w_p"].shape[-2] != GROUP * w["w_s"].shape[-2] or w["w_p"].shape[-1] % TILE:
            return False
    if Tk % 32 or not 0 <= int(offset) < Tk:
        return False
    F = slabs["gateup_proj"]["w_p"].shape[-1]
    smem = smem_bytes(cfg.hidden_size, cfg.num_heads, F, G, Tk, hd)
    if smem > SMEM_LIMIT:
        return False
    if device is not None and torch.device(device).type == "cuda":
        return _cuda.library().al_megakernel_blocks_per_sm(G, smem) >= 1
    return True


def _mlp_plain(hn, gu, dn, li: int, fmt):
    """gate|up planes in f32, a = g * sigmoid(g) * u rounded to hn's dtype,
    down summed over its groups in order, rounded to hn's dtype."""
    g, u = int4_matmul_stacked_plain(hn.to(torch.float32), gu["w_p"], gu["w_s"], li,
                                     return_planes=True, fmt=fmt)
    a = (g * torch.sigmoid(g) * u).to(hn.dtype).to(torch.float32)
    lo, hi = _unpack_planes(dn["w_p"][li], fmt)
    s = dn["w_s"][li].to(torch.float32)
    dh = lo.shape[-1]
    acc = torch.zeros((a.shape[0], 2 * dh), dtype=torch.float32, device=a.device)
    for g2 in range(lo.shape[0] // GROUP):
        rows = slice(g2 * GROUP, (g2 + 1) * GROUP)
        part = torch.cat([a[:, rows] @ lo[rows].to(torch.float32),
                          a[:, rows] @ hi[rows].to(torch.float32)], dim=-1)
        acc = acc + part * s[g2]
    return acc.to(hn.dtype)


def decode_megakernel_plain(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv,
                            k_scales, v_scales, offset, valid, *, eps: float, scale: float,
                            fmt=None):
    """The kernel's arithmetic in PyTorch (writes the cache and the scale
    slabs in place)."""
    from ..models.llama import _write_scales, quantize_kv_rows4

    L, _, Hkv, Tk, hd = cache_kv.shape
    cd = x.dtype
    h = x.reshape(1, -1)
    Hq = o["w_p"].shape[1] // hd
    cs, sn = cos.reshape(1, 1, hd), sin.reshape(1, 1, hd)
    off = torch.as_tensor(offset, dtype=torch.int32, device=x.device).reshape(1)
    fresh = torch.empty((L, Hkv, 2), dtype=torch.float32, device=x.device)
    for li in range(L):
        hn = rms_norm(h, input_ln[li].to(cd), eps)
        lo, hi = int4_matmul_stacked_plain(hn, qkv["w_p"], qkv["w_s"], li, return_planes=True,
                                           fmt=fmt)
        qkv_out = torch.cat([lo, hi], dim=-1)
        q = apply_rope(qkv_out[:, :Hq * hd].reshape(1, 1, Hq, hd), cs, sn)
        k = apply_rope(qkv_out[:, Hq * hd:(Hq + Hkv) * hd].reshape(1, 1, Hkv, hd), cs, sn)
        v = qkv_out[:, (Hq + Hkv) * hd:].reshape(1, Hkv, hd)
        kvp, ks, vs = quantize_kv_rows4(k[:, 0], v)
        attn, _ = decode_attention_q4_plain(q[:, 0], kvp, cache_kv, k_scales, v_scales, ks, vs,
                                            li, off, valid, scale)
        _write_scales(k_scales, v_scales, ks, vs, li, off)
        fresh[li] = torch.stack([ks[0], vs[0]], dim=-1)
        h = h + int4_matmul_stacked_plain(attn.reshape(1, Hq * hd), o["w_p"], o["w_s"], li,
                                          fmt=fmt)
        hn = rms_norm(h, post_attn_ln[li].to(cd), eps)
        h = h + _mlp_plain(hn, gu, dn, li, fmt)
    return h, cache_kv, fresh


def _require(name, cond, msg):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def decode_megakernel_cuda(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv,
                           k_scales, v_scales, offset, valid, *, eps: float, scale: float,
                           fmt=None, barriers_only: bool = False):
    """Launch the kernel (same arguments as the plain version).
    `barriers_only` runs the launch's grid barriers and none of its work (a
    timing of the barriers alone; its outputs are not meaningful and it is
    not counted as a launch)."""
    global launches
    name = "decode_megakernel"
    slabs = (qkv, o, gu, dn)
    _cuda.require_cuda(name, x, cos, sin, cache_kv, k_scales, v_scales, valid,
                       *(t for w in slabs for t in (w["w_p"], w["w_s"])))
    L, B, Hkv, Tk, hd = cache_kv.shape
    D = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if cache_kv.dtype != torch.int8 or k_scales.dtype != torch.float32 \
            or v_scales.dtype != torch.float32:
        raise TypeError(f"{name}: expected an int8 cache and f32 scale slabs")
    for w in slabs:
        if w["w_p"].dtype != torch.int8 or w["w_s"].dtype != torch.float32:
            raise TypeError(f"{name}: expected int8 slabs and f32 scales")
        _require(name, w["w_p"].is_contiguous() and w["w_s"].is_contiguous()
                 and _cuda.aligned16(w["w_p"]), "the slabs must be contiguous and aligned")
    Nh = qkv["w_p"].shape[-1]
    Hq = o["w_p"].shape[1] // hd
    F = gu["w_p"].shape[-1]
    G = Hq // Hkv if Hkv else 0
    _require(name, B == 1 and x.numel() == D, "one request (B = 1, one token)")
    _require(name, hd == 128 and G in KV_GROUPS and Hq == G * Hkv,
             f"needs head_dim 128 and Hq/Hkv in {KV_GROUPS}")
    _require(name, 2 * Nh == (Hq + 2 * Hkv) * hd, "q|k|v slab width")
    for w, K, N in ((qkv, D, 2 * Nh), (o, Hq * hd, D), (gu, D, 2 * F), (dn, F, D)):
        _cuda.require_shape(name, w["w_p"], (L, K, N // 2))
        _cuda.require_shape(name, w["w_s"], (L, K // GROUP, N))
        _require(name, K % GROUP == 0 and (N // 2) % TILE == 0, "group and tile alignment")
    _cuda.require_shape(name, k_scales, (L, 1, Hkv, Tk))
    _cuda.require_shape(name, v_scales, (L, 1, Hkv, Tk))
    _cuda.require_shape(name, input_ln, (L, D))
    _cuda.require_shape(name, post_attn_ln, (L, D))
    _cuda.require_shape(name, valid, (1, Tk))
    _require(name, cos.numel() == hd and sin.numel() == hd, "cos/sin are [hd]")
    _require(name, Tk % 32 == 0, "Tk % 32 == 0")
    _require(name, all(t.is_contiguous() for t in (cache_kv, k_scales, v_scales))
             and _cuda.aligned16(cache_kv), "the cache and scale slabs must be contiguous")
    smem = smem_bytes(D, Hq, F, G, Tk, hd)
    _require(name, smem <= SMEM_LIMIT, f"Tk {Tk} exceeds the shared-memory budget")
    off = torch.as_tensor(offset, dtype=torch.int32, device=x.device).reshape(1).contiguous()
    dev = x.device
    x = x.reshape(D).contiguous()
    iln = input_ln.to(torch.bfloat16).contiguous()
    pln = post_attn_ln.to(torch.bfloat16).contiguous()
    cos = cos.to(torch.float32).reshape(hd).contiguous()
    sin = sin.to(torch.float32).reshape(hd).contiguous()
    valid = valid.to(torch.int32).reshape(Tk).contiguous()
    # scratch: the q|k|v planes (f32), the attention output and the MLP
    # activation (bf16), the residual (the output), the fresh scales
    qkv_out = torch.empty(2 * Nh, dtype=torch.float32, device=dev)
    attn = torch.empty(Hq * hd, dtype=torch.bfloat16, device=dev)
    act = torch.empty(F, dtype=torch.bfloat16, device=dev)
    hidden = torch.empty(D, dtype=torch.bfloat16, device=dev)
    fresh = torch.empty((L, Hkv, 2), dtype=torch.float32, device=dev)
    err = _cuda.library().al_decode_megakernel(
        x.data_ptr(), iln.data_ptr(), pln.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        qkv["w_p"].data_ptr(), qkv["w_s"].data_ptr(), o["w_p"].data_ptr(), o["w_s"].data_ptr(),
        gu["w_p"].data_ptr(), gu["w_s"].data_ptr(), dn["w_p"].data_ptr(), dn["w_s"].data_ptr(),
        cache_kv.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(), off.data_ptr(),
        valid.data_ptr(), qkv_out.data_ptr(), attn.data_ptr(), act.data_ptr(),
        hidden.data_ptr(), fresh.data_ptr(), _cuda.barrier_words(dev).data_ptr(),
        L, D, F, Hq, Hkv, Tk, hd, FMT_CODE[_fmt(fmt)], float(eps), float(scale), smem,
        int(barriers_only), _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    if not barriers_only:
        launches += 1
    return hidden.reshape(1, D), cache_kv, fresh


def decode_megakernel(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv, k_scales,
                      v_scales, offset, valid, *, eps: float, scale: float, fmt=None):
    """One decode step of one request through every layer -> (hidden [1, D],
    cache_kv, fresh scales [L, Hkv, 2]); see the module docstring. The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    fn = decode_megakernel_plain if x.device.type == "cpu" else decode_megakernel_cuda
    return fn(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv, k_scales, v_scales,
              offset, valid, eps=eps, scale=scale, fmt=fmt)
