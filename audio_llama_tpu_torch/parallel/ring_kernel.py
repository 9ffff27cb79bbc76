"""Ring causal attention through the causal attention kernels, one per hop.

Counterpart of `audio_llama_tpu/parallel/ring_kernel.py` (`_ring_core`,
:54-199, and `ring_causal_mha_kernel`, :202-258). Each rank holds its slice
of the sequence; the K/V blocks and their key biases rotate around the
sequence-parallel axis (`collectives.ppermute_`), and each hop runs the
kernels of `ops/causal_attention.py`:

  hop 0 (the local block)        -> tri='always' (the causal mask);
  hops from an earlier shard     -> tri='never' (every key contributes);
  hops from a later shard        -> nothing at all: no launch (JAX's
                                    `lax.cond`), the blocks still rotate.

Forward: each live hop returns its (o, l, m); the hops merge online as
(o l, l, m), so o = sum / l at the end. The Function saves the merged (l, m)
and o. Backward (exact): given the whole row's m, l and D = rowsum(dO o), P
of one hop is exp(s - m) / l, so the backward re-rotates K/V, runs dq and
dk/dv per live hop with those global statistics (tri as in the forward),
and rotates each block's (dk, dv) accumulator together with the block; one
last rotation brings every accumulator home (:180-185).

On CUDA tensors the kernels run (their launch counters count every hop); on
CPU tensors their plain versions. Each rank's slice is padded to the 128
tile (the padded keys hidden by the bias, the padded rows sliced off;
:222-244). Sentinel: the kernels' key bias is -1e9 (`ops.causal_attention
.NEG`), JAX's ring uses -1e30; either way exp of a hidden key against a
live row's max is exactly 0, so a hop that sees only hidden keys adds
exactly 0 to l and to o l.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import causal_attention as ca
from .collectives import axis_index, axis_size, ppermute_
from .mesh import MeshAxis


def _fwd(qs, k, v, bias, tri):
    if qs.device.type == "cpu":
        return ca.causal_attention_plain(qs, k, v, bias, tri)
    return ca.causal_attention_cuda(qs, k, v, bias, tri)


def _bwd(qs, k, v, bias, o, l, m, do, d, tri):
    """(dq, dk, dv) of one hop, from the whole row's o, l, m and D."""
    if qs.device.type == "cpu":
        return ca.causal_attention_bwd_plain(qs, k, v, bias, o, l, m, do, tri)
    dq = ca.causal_attention_dq_cuda(qs, k, v, bias, l, m, do, d, tri)
    dk, dv = ca.causal_attention_dkv_cuda(qs, k, v, bias, l, m, do, d, tri)
    return dq, dk, dv


def _rows(stat: torch.Tensor, B: int) -> torch.Tensor:
    """[B*H, T] row statistics -> [B, T, H, 1], to scale o [B, T, H, hd]."""
    return stat.reshape(B, -1, stat.shape[-1]).transpose(1, 2)[..., None]


def ring_forward(qs, k, v, bias, axis):
    """The ring's forward -> (o, l, m), l and m merged over the ring,
    [B*Hq, Tl] f32 each."""
    n, idx = axis_size(axis), axis_index(axis)
    B = qs.shape[0]
    o0, l_acc, m_acc = _fwd(qs, k, v, bias, "always")
    acc = o0.float() * _rows(l_acc, B)  # unnormalized
    k_cur, v_cur, b_cur = k, v, bias
    for h in range(1, n):
        k_cur, v_cur, b_cur = (ppermute_(t, axis) for t in (k_cur, v_cur, b_cur))
        if h > idx:  # a later shard's block: nothing to add, nothing launched
            continue
        o_h, l_h, m_h = _fwd(qs, k_cur, v_cur, b_cur, "never")
        m_new = torch.maximum(m_acc, m_h)
        r_old, r_new = torch.exp(m_acc - m_new), torch.exp(m_h - m_new)
        l_acc = l_acc * r_old + l_h * r_new
        acc = acc * _rows(r_old, B) + (o_h.float() * _rows(l_h, B)) * _rows(r_new, B)
        m_acc = m_new
    lr = _rows(l_acc, B)
    o = torch.where(lr > 0, acc / torch.where(lr > 0, lr, 1.0), 0.0).to(qs.dtype)
    return o, l_acc, m_acc


def ring_backward(qs, k, v, bias, o, l, m, do, axis):
    """-> (dq, dk, dv) of this rank's slices."""
    n, idx = axis_size(axis), axis_index(axis)
    d = ca.attention_bwd_prologue(o, do)
    dq, dk, dv = _bwd(qs, k, v, bias, o, l, m, do, d, "always")
    dq, dk_acc, dv_acc = dq.float(), dk.float(), dv.float()
    k_cur, v_cur, b_cur = k, v, bias
    for h in range(1, n):
        # the block AND its gradient accumulator rotate together
        k_cur, v_cur, b_cur, dk_acc, dv_acc = (
            ppermute_(t, axis) for t in (k_cur, v_cur, b_cur, dk_acc, dv_acc))
        if h > idx:
            continue
        dq_h, dk_h, dv_h = _bwd(qs, k_cur, v_cur, b_cur, o, l, m, do, d, "never")
        dq = dq + dq_h.float()
        dk_acc = dk_acc + dk_h.float()
        dv_acc = dv_acc + dv_h.float()
    # n - 1 rotations so far: one more brings each accumulator to its owner
    dk_acc, dv_acc = ppermute_(dk_acc, axis), ppermute_(dv_acc, axis)
    return dq.to(qs.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qs, k, v, bias, axis):
        o, l, m = ring_forward(qs, k, v, bias, axis)
        ctx.save_for_backward(qs, k, v, bias, o, l, m)
        ctx.axis = axis
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, bias, o, l, m = ctx.saved_tensors
        dq, dk, dv = ring_backward(qs, k, v, bias, o, l, m, do.to(o.dtype).contiguous(),
                                   ctx.axis)
        return dq, dk, dv, None, None


def ring_causal_mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           axis: Optional[MeshAxis], mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The kernel twin of `ring_attention.ring_causal_mha` (same contract:
    q [B, Tl, Hq, hd], k/v [B, Tl, Hkv, hd] local slices, mask [B, Tl] the
    local key-padding mask) -> [B, Tl, Hq, hd], differentiable."""
    B, Tl, Hq, hd = q.shape
    if Hq % k.shape[2]:
        raise ValueError("Hq must be a multiple of Hkv")
    if scale is None:
        scale = hd ** -0.5
    if mask is None:
        mask = torch.ones((B, Tl), dtype=torch.int32, device=q.device)
    pad = (-Tl) % ca.TILE
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        mask = F.pad(mask.to(torch.int32), (0, pad))
    qs = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).contiguous()
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(mask != 0, zero, ca.NEG).contiguous()
    o = _RingCore.apply(qs, k.contiguous(), v.contiguous(), bias, axis)
    return o[:, :Tl] if pad else o
