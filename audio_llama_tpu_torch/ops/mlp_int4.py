"""Fused int4 decode MLP: gate|up matmul, SiLU * up and the down matmul in
one launch per layer.

Counterpart of `audio_llama_tpu/ops/mlp_int4.py`; the kernel
`mlp_int4_stacked` replaces `_kernel`. Layouts as ops/int4_matmul.py:
  gate|up packed [L, K, F]    (low nibble gate column j, high nibble up j)
  gate|up scales [L, K/G, 2F]
  down    packed [L, F, D/2]  (low nibble column j, high nibble j + D/2)
  down    scales [L, F/G, D]
Decode only (M <= 64 rows). The CUDA kernel is `csrc/mlp_int4.cu` (its
source note gives the bound and the design). `mlp_int4_stacked_plain` is the
same arithmetic in PyTorch: per F-chunk the gate and up group dots scaled
into f32, a = g * sigmoid(g) * u in f32 cast to x's dtype, the chunk's down
rows into an f32 sum over chunks, cast at the end. `mlp_int4_stacked_ref` is
the JAX package's oracle (the two-call planes path).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .int4_matmul import FMT_CODE, GROUP, _fmt, _unpack_planes, int4_matmul_stacked_ref

launches = 0  # kernel launches through `mlp_int4_stacked`

MAX_M = 64
CHUNK = 512  # F columns per chunk (the TPU kernel's grid step)
# The CUDA kernel's chunk: one scale group. The TPU kernel walks its chunks
# in order on one core; here each chunk is a block, so one group per chunk
# puts 64 blocks on the card at F = 8192 (512 would leave 116 of 132 SMs
# idle). The activations are the same; only the f32 order of the sum over
# chunks changes.
KERNEL_CHUNK = GROUP


def pick_chunk(F: int, group: int = GROUP, target: Optional[int] = None):
    """Largest F-chunk <= target with chunk | F and group | chunk, or None."""
    c = min(CHUNK if target is None else target, F)
    c -= c % group
    while c >= group:
        if F % c == 0:
            return c
        c -= group
    return None


def geometry_ok(K: int, F: int, D: int, group: int = GROUP, chunk: Optional[int] = None) -> bool:
    """The JAX package's TPU-lowering gate (128 | chunk, 128 | D/2, group | K)."""
    c = pick_chunk(F, group) if chunk is None else chunk
    return c is not None and c % 128 == 0 and (D // 2) % 128 == 0 and K % group == 0


def kernel_chunk(F: int, dh: int, group: int = GROUP):
    """The F-chunk the fused kernel runs at for an MLP of F columns and a
    down slab of dh packed columns, or None where the kernel cannot tile it
    (the caller then takes the two-call planes path)."""
    c = pick_chunk(F, group, target=KERNEL_CHUNK)
    if c is None or 256 % (c // 8) or dh % 8:
        return None
    return c


def mlp_int4_stacked_ref(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                         group: int = GROUP, compute_dtype=torch.bfloat16,
                         fmt: Optional[str] = None):
    g, u = int4_matmul_stacked_ref(x, gup_packed, gup_scales, layer, group, compute_dtype,
                                   return_planes=True, fmt=fmt)
    a = torch.nn.functional.silu(g.to(torch.float32)) * u.to(torch.float32)
    return int4_matmul_stacked_ref(a.to(compute_dtype), dn_packed, dn_scales, layer, group,
                                   compute_dtype, fmt=fmt)


def _group_scaled(x2, packed, scales, rows, groups_from, fmt):
    """f32 sum over the groups of `rows` of (x2[:, group] @ q[group]) * s[g]
    for both planes -> (lo, hi) [M, Nh]."""
    lo, hi = _unpack_planes(packed[rows], fmt)
    Nh = lo.shape[1]
    acc_lo = torch.zeros((x2.shape[0], Nh), dtype=torch.float32, device=x2.device)
    acc_hi = torch.zeros_like(acc_lo)
    for i in range(lo.shape[0] // GROUP):
        r = slice(i * GROUP, (i + 1) * GROUP)
        xg = x2[:, r]
        s = scales[groups_from + i]
        acc_lo = acc_lo + (xg @ lo[r].to(torch.float32)) * s[:Nh]
        acc_hi = acc_hi + (xg @ hi[r].to(torch.float32)) * s[Nh:]
    return acc_lo, acc_hi


def mlp_int4_stacked_plain(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                           group: int = GROUP, chunk: Optional[int] = None,
                           fmt: Optional[str] = None):
    *lead, K = x.shape
    F = gup_packed.shape[2]
    chunk = chunk or pick_chunk(F, group)
    x2 = x.reshape(-1, K).to(torch.float32)
    gp, gs = gup_packed[layer], gup_scales[layer].to(torch.float32)
    dp, ds = dn_packed[layer], dn_scales[layer].to(torch.float32)
    out = None
    for c in range(F // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        # the chunk's gate and up columns: packed columns `cols`, scales of
        # gate column j at j and of up column j at F + j
        s_c = torch.cat([gs[:, cols], gs[:, F + c * chunk:F + (c + 1) * chunk]], dim=1)
        g, u = _group_scaled(x2, gp[:, cols], s_c, slice(0, K), 0, fmt)
        a = (g * torch.sigmoid(g) * u).to(x.dtype).to(torch.float32)
        d_lo, d_hi = _group_scaled(a, dp, ds, cols, c * chunk // GROUP, fmt)
        part = torch.cat([d_lo, d_hi], dim=1)
        out = part if out is None else out + part
    return out.to(x.dtype).reshape(*lead, -1)


def mlp_int4_stacked_cuda(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                          group: int = GROUP, chunk: Optional[int] = None,
                          fmt: Optional[str] = None):
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    name = "mlp_int4_stacked"
    _cuda.require_cuda(name, x, gup_packed, gup_scales, dn_packed, dn_scales)
    code = FMT_CODE[_fmt(fmt)]
    *lead, K = x.shape
    L, Kp, F = gup_packed.shape
    dh = dn_packed.shape[2]
    chunk = chunk or pick_chunk(F, group)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if gup_packed.dtype != torch.int8 or dn_packed.dtype != torch.int8 \
            or gup_scales.dtype != torch.float32 or dn_scales.dtype != torch.float32:
        raise TypeError(f"{name}: expected int8 slabs and f32 scales")
    _cuda.require_shape(name, gup_scales, (L, K // GROUP, 2 * F))
    _cuda.require_shape(name, dn_packed, (L, F, dh))
    _cuda.require_shape(name, dn_scales, (L, F // GROUP, 2 * dh))
    if group != GROUP or Kp != K or K % GROUP or chunk is None or chunk % GROUP or F % chunk \
            or 256 % (chunk // 8) or dh % 8:
        raise ValueError(f"{name}: unsupported geometry K={K} F={F} D/2={dh} chunk={chunk}")
    if not all(t.is_contiguous() for t in (gup_packed, gup_scales, dn_packed, dn_scales)):
        raise ValueError(f"{name}: the slabs must be contiguous")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M > MAX_M:
        raise ValueError(f"{name}: decode only (M <= {MAX_M}), got M={M}")
    smem = 4 * (4 * K + 4096 * 4 + 4 * chunk)
    if smem > 227 * 1024:
        raise ValueError(f"{name}: K={K} exceeds the shared-memory budget")
    li = int(layer)
    if not 0 <= li < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    out = torch.empty((M, 2 * dh), dtype=x.dtype, device=x.device)
    ws = torch.empty((F // chunk, M, 2 * dh), dtype=torch.float32, device=x.device)
    cnt = _cuda.counters(x.device, 1)
    err = _cuda.library().al_mlp_int4(
        x2.data_ptr(), M, K, gup_packed[li].data_ptr(), gup_scales[li].data_ptr(),
        dn_packed[li].data_ptr(), dn_scales[li].data_ptr(), F, dh, chunk, code,
        out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    launches += 1
    return out.reshape(*lead, 2 * dh)


def mlp_int4_stacked(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                     group: int = GROUP, chunk: Optional[int] = None,
                     fmt: Optional[str] = None):
    """silu(x @ Wgate) * (x @ Wup) @ Wdown -> [..., D] in x's dtype. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return mlp_int4_stacked_plain(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                                      group, chunk, fmt)
    return mlp_int4_stacked_cuda(x, gup_packed, gup_scales, dn_packed, dn_scales, layer,
                                 group, chunk, fmt)
