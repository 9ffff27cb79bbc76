"""W4A16: group-wise int4 weight-only matmul on stacked layer slabs.

Counterpart of `audio_llama_tpu/ops/int4_matmul.py`. A weight w [K, N] (in,
out) is quantized per (128-row group, output column), q in [-7, 7], scale =
absmax / 7 (optionally clipped, `quantize_pack`), and byte-packed pairing
output column j with column j + N/2:

    packed[k, j] = lo | (hi << 4),  lo = q[k, j], hi = q[k, j + N/2]

`pair` stores lo signed; `obin` stores lo + 8 (offset-binary). The high
nibble is signed in both and reads as (sign-extended byte) >> 4. The format
is a property of the tree (models/llama_int4.py marks `obin` trees with an
`int4_obin` leaf); the default is `pair`.

The kernel `int4_matmul_stacked` replaces `_kernel_stacked`: x [..., K] @
dequant(packed_all[layer]) with the layer picked by a pointer offset into
the [L, K, N/2] slab. The CUDA kernel is `csrc/int4_matmul.cu` (its source
note gives the bounds and the two launch shapes, M <= 64 and M > 64).
`int4_matmul_stacked_plain` is the same arithmetic in PyTorch: per 128-row
group the f32 dot of x with the integer nibbles, times the group's f32
scale, summed over groups, cast to x's dtype. `int4_matmul_ref` and
`int4_matmul_stacked_ref` are the JAX package's oracles (dequantize, then
matmul in the compute dtype).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

GROUP = 128  # contraction rows per scale group
DEFAULT_FMT = "pair"
FMT_CODE = {"pair": 0, "obin": 1}

launches = 0  # kernel launches through `int4_matmul_stacked`

DECODE_MAX_M = 64  # rows up to which the kernel takes its weight-streaming shape
_TARGET_BLOCKS = 264  # two blocks per SM of the H100's 132


def _fmt(fmt: Optional[str]) -> str:
    fmt = fmt or DEFAULT_FMT
    if fmt not in FMT_CODE:
        raise ValueError(f"unknown int4 pack format {fmt!r}")
    return fmt


def absmax_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(absmax, 1e-8) / qmax, the symmetric quantizers' scale, by true
    division on every device. For a Python-scalar divisor PyTorch's CUDA
    kernel multiplies by the reciprocal instead, one f32 ulp away from the
    quotient that the CUDA kernels, the CPU and the JAX package compute; one
    ulp of a scale can flip the rounding of a quantized value."""
    return torch.clamp(absmax, min=1e-8) / absmax.new_full((), qmax)


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor, fmt: Optional[str] = None) -> torch.Tensor:
    """int4 planes (values in [-7, 7]) -> packed int8, one byte per column pair."""
    lo32 = lo.to(torch.int32)
    if _fmt(fmt) == "obin":
        lo32 = lo32 + 8  # [1, 15]: byte == 16 * hi + (lo + 8)
    return ((lo32 & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)).to(torch.int8)


def quantize_pack(w: torch.Tensor, group: int = GROUP,
                  clip_cands: Optional[Tuple[float, ...]] = None,
                  fmt: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] float -> (packed [K, N/2] int8, scales [K/group, N] f32).

    clip_cands: clipped-RTN scale search; for each (group, column) the scale
    absmax * c / 7 with the lowest summed squared reconstruction error over
    the candidates wins (the first on a tie)."""
    K, N = w.shape
    if N % 2 or K % group:
        raise ValueError(f"int4 pack needs even N and group|K; got {tuple(w.shape)}")
    g = w.to(torch.float32).reshape(K // group, group, N)
    absmax = g.abs().amax(dim=1)  # [K/g, N]
    scales = absmax_scale(absmax, 7.0)
    if clip_cands:
        cands = torch.tensor(clip_cands, dtype=torch.float32, device=w.device)
        errs = []
        for c in cands:  # one candidate at a time bounds the transients
            s = scales * c
            qc = torch.clamp(torch.round(g / s[:, None, :]), -7, 7)
            errs.append(((g - qc * s[:, None, :]) ** 2).sum(dim=1))
        best = torch.argmin(torch.stack(errs), dim=0)  # [K/g, N]
        scales = scales * cands[best]
    q = torch.clamp(torch.round(g / scales[:, None, :]), -7, 7).to(torch.int8).reshape(K, N)
    return pack_nibbles(q[:, : N // 2], q[:, N // 2:], fmt), scales


def _unpack_planes(packed: torch.Tensor, fmt: Optional[str]):
    """packed int8 [..., Nh] -> (lo, hi) int32 planes."""
    b = packed.to(torch.int32)
    if _fmt(fmt) == "obin":
        lo = (b & 0xF) - 8
    else:
        lo = (b << 28) >> 28  # sign-extends the low nibble
    return lo, b >> 4


def unpack_ref(packed: torch.Tensor, fmt: Optional[str] = None) -> torch.Tensor:
    """packed [K, N/2] int8 -> q [K, N] int32."""
    lo, hi = _unpack_planes(packed, fmt)
    return torch.cat([lo, hi], dim=-1)


def dequantize_ref(packed: torch.Tensor, scales: torch.Tensor, group: int = GROUP,
                   fmt: Optional[str] = None) -> torch.Tensor:
    """Inverse of quantize_pack, in f32."""
    q = unpack_ref(packed, fmt).to(torch.float32)
    return q * torch.repeat_interleave(scales, group, dim=-2)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    group: int = GROUP, compute_dtype=torch.bfloat16,
                    fmt: Optional[str] = None) -> torch.Tensor:
    """x [..., K] @ dequant(packed) -> [..., N] in compute dtype (the JAX
    package's oracle: the weights are rounded to the compute dtype first)."""
    w = dequantize_ref(packed, scales, group, fmt).to(compute_dtype)
    y = x.to(compute_dtype).to(torch.float32) @ w.to(torch.float32)
    return y.to(compute_dtype)


def int4_matmul_stacked_ref(x, packed_all, scales_all, layer, group: int = GROUP,
                            compute_dtype=torch.bfloat16, return_planes: bool = False,
                            fmt: Optional[str] = None):
    y = int4_matmul_ref(x, packed_all[layer], scales_all[layer], group, compute_dtype, fmt)
    if return_planes:
        nh = y.shape[-1] // 2
        return y[..., :nh], y[..., nh:]
    return y


def int4_matmul_stacked_plain(x, packed_all, scales_all, layer, group: int = GROUP,
                              return_planes: bool = False, fmt: Optional[str] = None):
    """The kernel's arithmetic in PyTorch (f32 per-group dots, scaled, summed
    over groups in order, cast to x's dtype)."""
    *lead, K = x.shape
    p, s = packed_all[layer], scales_all[layer].to(torch.float32)
    Nh = p.shape[-1]
    lo, hi = _unpack_planes(p, fmt)
    x2 = x.reshape(-1, K).to(torch.float32)
    acc_lo = torch.zeros((x2.shape[0], Nh), dtype=torch.float32, device=x.device)
    acc_hi = torch.zeros_like(acc_lo)
    for g in range(K // group):
        rows = slice(g * group, (g + 1) * group)
        xg = x2[:, rows]
        acc_lo = acc_lo + (xg @ lo[rows].to(torch.float32)) * s[g, :Nh]
        acc_hi = acc_hi + (xg @ hi[rows].to(torch.float32)) * s[g, Nh:]
    lo_out = acc_lo.to(x.dtype).reshape(*lead, Nh)
    hi_out = acc_hi.to(x.dtype).reshape(*lead, Nh)
    if return_planes:
        return lo_out, hi_out
    return torch.cat([lo_out, hi_out], dim=-1)


def decode_split(M: int, K: int, Nh: int, group: int = GROUP):
    """(rows per block, groups per block, blocks along K) of the kernel's
    M <= 64 shape: enough blocks to stream the slab on every SM."""
    mc = next(c for c in (1, 2, 4, 8) if c >= min(M, 8))
    n_groups = K // group
    blocks = (Nh // 128) * -(-M // mc)
    ksplit = min(n_groups, max(1, -(-_TARGET_BLOCKS // blocks)))
    gps = min(8, -(-n_groups // ksplit))
    return mc, gps, -(-n_groups // gps)


def int4_matmul_stacked_cuda(x, packed_all, scales_all, layer, group: int = GROUP,
                             return_planes: bool = False, fmt: Optional[str] = None):
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    name = "int4_matmul_stacked"
    _cuda.require_cuda(name, x, packed_all, scales_all)
    code = FMT_CODE[_fmt(fmt)]
    *lead, K = x.shape
    L, Kp, Nh = packed_all.shape
    N = 2 * Nh
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if packed_all.dtype != torch.int8 or scales_all.dtype != torch.float32:
        raise TypeError(f"{name}: expected int8 packed and f32 scales")
    if group != GROUP or Kp != K or K % GROUP or Nh % 128:
        raise ValueError(f"{name}: needs group 128, K % 128 == 0 and N/2 % 128 == 0; "
                         f"got K={K} N/2={Nh} group={group}")
    _cuda.require_shape(name, scales_all, (L, K // GROUP, N))
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if not (packed_all.is_contiguous() and scales_all.is_contiguous()):
        raise ValueError(f"{name}: the slabs must be contiguous")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if not (_cuda.aligned16(x2) and _cuda.aligned16(packed_all)):
        raise ValueError(f"{name}: x and the packed slab must be 16-byte aligned")
    li = int(layer)
    p, s = packed_all[li], scales_all[li]
    if return_planes:
        out = torch.empty((2, M, Nh), dtype=x.dtype, device=x.device)
        ldo, hi_off = Nh, M * Nh
    else:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        ldo, hi_off = N, Nh
    mc, gps, ksplit = decode_split(M, K, Nh) if M <= DECODE_MAX_M else (0, 0, 1)
    mz = -(-M // mc) if mc else 0
    if ksplit > 1:
        ws = torch.empty((mz, ksplit, mc, N), dtype=torch.float32, device=x.device)
        cnt = _cuda.counters(x.device, mz * (Nh // 128))
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    else:
        ws_ptr = cnt_ptr = None
    err = _cuda.library().al_int4_matmul(
        x2.data_ptr(), M, K, p.data_ptr(), Nh, s.data_ptr(), code, out.data_ptr(), ldo, hi_off,
        ws_ptr, cnt_ptr, mc, gps, ksplit, _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    launches += 1
    if return_planes:
        return out[0].reshape(*lead, Nh), out[1].reshape(*lead, Nh)
    return out.reshape(*lead, N)


def int4_matmul_stacked(x, packed_all, scales_all, layer, group: int = GROUP,
                        return_planes: bool = False, fmt: Optional[str] = None):
    """x [..., K] @ dequant(packed_all[layer]) -> [..., N] in x's dtype, or
    the (lo, hi) column-half planes [..., N/2] each with `return_planes`.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int4_matmul_stacked_plain(x, packed_all, scales_all, layer, group,
                                         return_planes, fmt)
    return int4_matmul_stacked_cuda(x, packed_all, scales_all, layer, group, return_planes, fmt)
