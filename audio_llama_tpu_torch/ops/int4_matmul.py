"""W4A16: group-wise int4 weight-only matmul on stacked layer slabs.

Counterpart of `audio_llama_tpu/ops/int4_matmul.py`. A weight w [K, N] (in,
out) is quantized per (group of `group` rows, output column; 128 by
default), q in [-7, 7], scale = absmax / 7 (optionally clipped,
`quantize_pack`), and byte-packed pairing output column j with column
j + N/2:

    packed[k, j] = lo | (hi << 4),  lo = q[k, j], hi = q[k, j + N/2]

`pair` stores lo signed; `obin` stores lo + 8 (offset-binary). The high
nibble is signed in both and reads as (sign-extended byte) >> 4. The format
is a property of the tree (models/llama_int4.py marks `obin` trees with an
`int4_obin` leaf); the default is `pair`.

The kernel `int4_matmul_stacked` replaces `_kernel_stacked`: x [..., K] @
dequant(packed_all[layer]) with the layer picked by a pointer offset into
the [L, K, N/2] slab. The CUDA kernel is `csrc/int4_matmul.cu` (its source
note gives the bounds and the two launch shapes: M <= 64 streams the
weight bytes through the tensor cores on the core of `csrc/int4_common.cuh`,
in clusters whose shape `decode_plan` picks; M > 64 runs on wgmma and TMA).
`int4_matmul_stacked_plain` is the same arithmetic in PyTorch: per scale
group the f32 dot of x with the integer nibbles, times the group's f32
scale, summed over groups, cast to x's dtype. The group is an argument of
the kernels, as of JAX's: on the card every group that `check_group` takes
(a multiple of 16 dividing 128 or a multiple of 128, so 32, 64, 128, 256;
the smoothed and GPTQ trees of the JAX package's users are quantized at
32). `int4_matmul_ref` and
`int4_matmul_stacked_ref` are the JAX package's oracles (dequantize, then
matmul in the compute dtype).

`int4_matmul` replaces the unstacked `_kernel` (int4_matmul.py:256): x
[..., K] @ dequant(packed [K, N/2], scales [K/group, N]) -> [..., N] in x's
dtype, f32 accumulation; the TPU kernel writes lo and hi planes and
concatenates them, the CUDA launch (`al_int4_matmul_2d` in the same source,
the stacked kernel's device code with the weight as the whole slab) writes
them side by side. `int4_matmul_plain` is its arithmetic in PyTorch. Its one
caller is `models/llama.py::_linear`'s per-layer `w_p` branch.

`block_k` (or the `INT4_BK` environment default, read at import as the JAX
package reads it) selects the contraction-split twin `_kernel_stacked_ksplit`
(int4_matmul.py:393): K in blocks of bk rows, each block's groups summed into
a fresh f32 partial, the partials added in block order, one cast at the end
(`int4_matmul_stacked_ksplit_plain`; the same kernel source, its K-split
launch). As in JAX, a bk that does not divide K or is not a multiple of the
group falls back to the whole-K grid (`ksplit_block`): at Llama-3.2-3B
widths 768 and 1536 split K 3072 (q|k|v, o, gate|up) and leave the down
projection's K 8192 whole. Each launch counts in `launches` (whole K) or
`launches_ksplit`.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda

GROUP = 128  # contraction rows per scale group
DEFAULT_FMT = "pair"
FMT_CODE = {"pair": 0, "obin": 1}
# the contraction block of the stacked matmuls when the caller gives none; 0
# keeps the whole K (audio_llama_tpu/ops/int4_matmul.py:66)
INT4_BK = int(os.environ.get("INT4_BK", "0"))

launches = 0  # whole-K kernel launches through `int4_matmul_stacked`
launches_ksplit = 0  # K-split kernel launches (block_k or INT4_BK in effect)
launches_2d = 0  # unstacked kernel launches through `int4_matmul`

DECODE_MAX_M = 64  # rows up to which the kernel takes its weight-streaming shape
_MAX_CLUSTER = 8  # blocks a cluster (the portable limit)
_SMEM_MAX = 232448  # shared memory a block can use on the H100


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


def ksplit_block(K: int, block_k: int, group: int = GROUP) -> int:
    """The contraction block a call runs with, by the JAX package's rule
    (int4_matmul.py:460-462): block_k, or INT4_BK when it is 0; 0 (the whole
    K) where that block does not divide K or is not a multiple of the group."""
    bk = block_k or INT4_BK
    if bk and (K % bk or bk % group):
        return 0
    return bk


def _group_sums(x2, lo, hi, s, g0, g1, group, Nh):
    """f32 sums over scale groups [g0, g1) in order, from zero: (lo, hi)."""
    acc_lo = torch.zeros((x2.shape[0], Nh), dtype=torch.float32, device=x2.device)
    acc_hi = torch.zeros_like(acc_lo)
    for g in range(g0, g1):
        rows = slice(g * group, (g + 1) * group)
        xg = x2[:, rows]
        acc_lo = acc_lo + (xg @ lo[rows].to(torch.float32)) * s[g, :Nh]
        acc_hi = acc_hi + (xg @ hi[rows].to(torch.float32)) * s[g, Nh:]
    return acc_lo, acc_hi


def int4_matmul_stacked_plain(x, packed_all, scales_all, layer, group: int = GROUP,
                              return_planes: bool = False, fmt: Optional[str] = None,
                              block_k: int = 0):
    """The kernel's arithmetic in PyTorch (f32 per-group dots, scaled, summed
    over groups in order, cast to x's dtype); with a block_k that splits K
    (`ksplit_block`), the K-split's (`int4_matmul_stacked_ksplit_plain`)."""
    *lead, K = x.shape
    bk = ksplit_block(K, block_k, group) if block_k else 0
    if bk:
        return int4_matmul_stacked_ksplit_plain(x, packed_all, scales_all, layer, bk, group,
                                                return_planes, fmt)
    p, s = packed_all[layer], scales_all[layer].to(torch.float32)
    Nh = p.shape[-1]
    lo, hi = _unpack_planes(p, fmt)
    x2 = x.reshape(-1, K).to(torch.float32)
    acc_lo, acc_hi = _group_sums(x2, lo, hi, s, 0, K // group, group, Nh)
    lo_out = acc_lo.to(x.dtype).reshape(*lead, Nh)
    hi_out = acc_hi.to(x.dtype).reshape(*lead, Nh)
    if return_planes:
        return lo_out, hi_out
    return torch.cat([lo_out, hi_out], dim=-1)


def int4_matmul_stacked_ksplit_plain(x, packed_all, scales_all, layer, block_k: int,
                                     group: int = GROUP, return_planes: bool = False,
                                     fmt: Optional[str] = None):
    """`_kernel_stacked_ksplit`'s arithmetic (int4_matmul.py:393-421): for
    each K block of block_k rows, in order, a fresh f32 sum over its scale
    groups in order, added into an f32 accumulator; one cast at the end.
    block_k must divide K and be a multiple of the group."""
    *lead, K = x.shape
    if block_k <= 0 or K % block_k or block_k % group:
        raise ValueError(f"block_k={block_k} must divide K={K} and be a multiple of {group}")
    p, s = packed_all[layer], scales_all[layer].to(torch.float32)
    Nh = p.shape[-1]
    lo, hi = _unpack_planes(p, fmt)
    x2 = x.reshape(-1, K).to(torch.float32)
    gpb = block_k // group
    acc_lo = torch.zeros((x2.shape[0], Nh), dtype=torch.float32, device=x.device)
    acc_hi = torch.zeros_like(acc_lo)
    for g0 in range(0, K // group, gpb):
        blk_lo, blk_hi = _group_sums(x2, lo, hi, s, g0, g0 + gpb, group, Nh)
        acc_lo = acc_lo + blk_lo
        acc_hi = acc_hi + blk_hi
    lo_out = acc_lo.to(x.dtype).reshape(*lead, Nh)
    hi_out = acc_hi.to(x.dtype).reshape(*lead, Nh)
    if return_planes:
        return lo_out, hi_out
    return torch.cat([lo_out, hi_out], dim=-1)


def group_ok(group: int) -> bool:
    """Whether the card's int4 kernels take scale groups of `group` rows: a
    multiple of 16 (one k-step of their tensor-core products) that divides
    their 128-row tile or is a multiple of it."""
    return group > 0 and group % 16 == 0 and (128 % group == 0 or group % 128 == 0)


def check_group(name: str, K: int, group: int) -> None:
    """Raise ValueError unless the card's int4 kernels take `group` at
    contraction K (`group_ok`, group | K, 128 | K)."""
    if not group_ok(group) or K % group or K % 128:
        raise ValueError(
            f"{name}: the scale group must be a multiple of 16 that divides 128 or is a "
            f"multiple of 128 (32, 64, 128, 256, ...) and divide K, and K a multiple of 128; "
            f"got group={group} K={K}")


def decode_instance(M: int) -> int:
    """NT, the n-tiles of 8 tokens of the decode kernels' instance for M <= 64
    rows (int4_common.cuh's `with_instance`)."""
    return 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8


KROWS, KSTAGES = 64, 4  # a ring stage's rows and the ring's stages (int4_common.cuh)
TILE = 64  # packed columns a decode block's tile (int4_common.cuh's kTW)


def unit_smem(nt: int, kn: int, group: int) -> int:
    """Dynamic shared memory of a decode block over kn rows: the ring, x and
    the scales while the rows stream, then the block's sums over the same
    bytes. The launch's own figure is int4_common.cuh's `unit_smem`; this
    copy is the planners' feasibility check (the card tests compare the two
    through `decode_kernel_info`)."""
    tok = 8 * nt
    stream = (KSTAGES * KROWS * TILE + tok * ((kn + 63) // 64 * 64 + 8) * 2
              + (kn // group) * 2 * TILE * 4)
    return max(stream, 2 * tok * TILE * 4)


@functools.lru_cache(maxsize=None)
def cluster_sizes(nt: int, K: int, span: int, group: int) -> Tuple[int, ...]:
    """Every cluster size C over K rows (int4_common.cuh's `unit_ok`): C <= 8
    blocks of whole 64-row stages and whole groups, each inside one block of
    `span` rows (span | K), the block in shared memory."""
    out = []
    for C in range(1, _MAX_CLUSTER + 1):
        kn = K // C
        if K % C or kn % KROWS or kn % group or span % kn:
            continue
        if unit_smem(nt, kn, group) <= _SMEM_MAX:
            out.append(C)
    return tuple(out)


class DecodePlan(NamedTuple):
    """The launch of the W4A16's decode shape: instance NT, clusters of C
    blocks over a tile of TILE packed columns each (`tiles` tiles), K / C
    rows a block, the block partials summed in order inside K blocks of
    `bk` rows (K: the whole-K call); `smem` bytes a block."""
    nt: int
    C: int
    bk: int
    tiles: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.C


@functools.lru_cache(maxsize=None)
def decode_plan(M: int, K: int, Nh: int, group: int = GROUP, bk: int = 0) -> DecodePlan:
    """The decode shape's launch for M <= 64 rows, K, Nh packed columns and
    the K-split block bk (0: whole K): the largest cluster that fits (the
    card's sweeps, PERF.md, int4 decode: a block's chain of ring stages and
    k-steps is what the time follows, so the fewest rows a block win).
    ValueError where none fits (a K block below 64 rows or a group, or more
    than 8 of them)."""
    nt = decode_instance(M)
    span = bk or K
    sizes = cluster_sizes(nt, K, span, group)
    if not sizes or Nh % TILE:
        raise ValueError(f"int4 decode: no launch for M={M} K={K} N/2={Nh} group={group} "
                         f"block_k={bk}")
    C = max(sizes)
    return DecodePlan(nt, C, span, Nh // TILE, unit_smem(nt, K // C, group))


def decode_plan_or_none(M: int, K: int, Nh: int, group: int, bk: int = 0):
    """`decode_plan` up to DECODE_MAX_M rows where one fits, else None (the
    wrappers then launch the prefill kernel, which takes every M and K
    block)."""
    if M > DECODE_MAX_M:
        return None
    try:
        return decode_plan(M, K, Nh, group, bk)
    except ValueError:
        return None


def decode_kernel_info(M: int, kn: int, group: int) -> dict:
    """Registers per thread, local (spilled) bytes, the dynamic shared memory
    its launch asks for and resident blocks per SM of the decode kernel's
    instance for M rows with blocks of kn rows at the scale group, from the
    CUDA runtime."""
    import ctypes

    out = (ctypes.c_int * 4)()
    _cuda.check(_cuda.library().al_int4_decode_info(M, kn, group,
                                                    ctypes.cast(out, ctypes.c_void_p)),
                "int4 decode info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], blocks_per_sm=out[3])


# the prefill kernel's instances, as al_sm90_kernel_info numbers them
SM90_KINDS = {"int4_matmul_prefill": 5, "int4_matmul_prefill_ksplit": 6}


def sm90_kernel_info(name: str, group: int = GROUP) -> dict:
    """Registers per thread, local (spilled) bytes, dynamic shared memory and
    resident blocks per SM of the prefill kernel's instance `name` (one of
    SM90_KINDS) at the scale group, from the CUDA runtime."""
    import ctypes

    out = (ctypes.c_int * 4)()
    fn = _cuda.library().al_sm90_kernel_info
    _cuda.check(fn(SM90_KINDS[name], group, ctypes.cast(out, ctypes.c_void_p)),
                f"{name} info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], blocks_per_sm=out[3])


def int4_matmul_stacked_cuda(x, packed_all, scales_all, layer, group: int = GROUP,
                             return_planes: bool = False, fmt: Optional[str] = None,
                             block_k: int = 0):
    """Launch the kernel (same arguments as the plain version): the K-split
    launch where block_k splits K (`ksplit_block`), else the whole-K one."""
    global launches, launches_ksplit
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
    check_group(name, K, group)
    if Kp != K or Nh % 128:
        raise ValueError(f"{name}: needs x's K equal to the slab's and N/2 % 128 == 0; "
                         f"got K={K} slab K={Kp} N/2={Nh}")
    _cuda.require_shape(name, scales_all, (L, K // group, N))
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if not (packed_all.is_contiguous() and scales_all.is_contiguous()):
        raise ValueError(f"{name}: the slabs must be contiguous")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if not all(_cuda.aligned16(t) for t in (x2, packed_all, scales_all)):
        raise ValueError(f"{name}: x and the packed and scale slabs must be 16-byte aligned")
    li = int(layer)
    p, s = packed_all[li], scales_all[li]
    if return_planes:
        out = torch.empty((2, M, Nh), dtype=x.dtype, device=x.device)
        ldo, hi_off = Nh, M * Nh
    else:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        ldo, hi_off = N, Nh
    bk = ksplit_block(K, block_k, group) if block_k else 0
    plan = decode_plan_or_none(M, K, Nh, group, bk)
    # no decode plan (past 64 rows, or K blocks the ring cannot take): the
    # prefill kernel, whole K or K-split
    gpb, C, span = (bk // group, 0, 0) if plan is None else (0, plan.C, plan.bk)
    err = _cuda.library().al_int4_matmul(
        x2.data_ptr(), M, K, p.data_ptr(), Nh, s.data_ptr(), code, out.data_ptr(), ldo, hi_off,
        C, span, gpb, group, _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    if bk:
        launches_ksplit += 1
    else:
        launches += 1
    if return_planes:
        return out[0].reshape(*lead, Nh), out[1].reshape(*lead, Nh)
    return out.reshape(*lead, N)


def int4_matmul_plain(x, packed, scales, group: int = GROUP, fmt: Optional[str] = None):
    """The unstacked kernel's arithmetic in PyTorch (f32 per-group dots,
    scaled, summed over groups in order, cast to x's dtype)."""
    return int4_matmul_stacked_plain(x, packed[None], scales[None], 0, group, fmt=fmt)


def int4_matmul_cuda(x, packed, scales, group: int = GROUP, fmt: Optional[str] = None):
    """Launch the unstacked kernel (same arguments as the plain version)."""
    global launches_2d
    name = "int4_matmul"
    _cuda.require_cuda(name, x, packed, scales)
    code = FMT_CODE[_fmt(fmt)]
    *lead, K = x.shape
    Kp, Nh = packed.shape
    N = 2 * Nh
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: expected int8 packed and f32 scales")
    check_group(name, K, group)
    if Kp != K or Nh % 128:
        raise ValueError(f"{name}: needs x's K equal to the weight's and N/2 % 128 == 0; "
                         f"got K={K} weight K={Kp} N/2={Nh}")
    _cuda.require_shape(name, scales, (K // group, N))
    packed, scales = packed.contiguous(), scales.contiguous()
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if not all(_cuda.aligned16(t) for t in (x2, packed, scales)):
        raise ValueError(f"{name}: x, the packed weight and the scales must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    plan = decode_plan_or_none(M, K, Nh, group)
    err = _cuda.library().al_int4_matmul_2d(
        x2.data_ptr(), M, K, packed.data_ptr(), Nh, scales.data_ptr(), code, out.data_ptr(),
        0 if plan is None else plan.C, group, _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    launches_2d += 1
    return out.reshape(*lead, N)


def int4_matmul(x, packed, scales, group: int = GROUP, fmt: Optional[str] = None):
    """x [..., K] @ dequant(packed [K, N/2], scales [K/group, N]) -> [..., N]
    in x's dtype. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group, fmt)
    return int4_matmul_cuda(x, packed, scales, group, fmt)


def int4_matmul_stacked(x, packed_all, scales_all, layer, group: int = GROUP,
                        return_planes: bool = False, fmt: Optional[str] = None,
                        block_k: int = 0):
    """x [..., K] @ dequant(packed_all[layer]) -> [..., N] in x's dtype, or
    the (lo, hi) column-half planes [..., N/2] each with `return_planes`.
    block_k (0: the INT4_BK default) splits the contraction where it divides
    K (`ksplit_block`). The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    bk = ksplit_block(x.shape[-1], block_k, group)
    if x.device.type == "cpu":
        return int4_matmul_stacked_plain(x, packed_all, scales_all, layer, group,
                                         return_planes, fmt, bk)
    return int4_matmul_stacked_cuda(x, packed_all, scales_all, layer, group, return_planes, fmt,
                                    bk)
