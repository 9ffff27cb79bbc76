"""Ring causal attention over a sequence-parallel axis, in plain PyTorch.

Counterpart of `audio_llama_tpu/parallel/ring_attention.py::ring_causal_mha`
(the JAX package's XLA tier, :45-126). Each rank holds the queries, keys and
values of its slice of the sequence (shard order = sequence order); the K/V
blocks rotate around the ring with `collectives.ppermute`, and every hop's
partial attention (m, l, o) merges online, so no rank holds more than its
[B, T/sp, H, hd] slice. A block from an earlier shard contributes fully, the
local block causally, a later shard's block not at all (its hop still runs,
with the -1e30 bias, as JAX's does). Autograd differentiates it: the
transpose of a rotation is the reverse rotation, so the dK/dV partials ring
back home by themselves.

This is the reference the tests hold the kernel ring (`ring_kernel.py`)
against; no card path runs it. Its sentinel is JAX's NEG = -1e30.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import axis_index, axis_size, ppermute
from .mesh import MeshAxis

NEG = -1e30


def ring_causal_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    axis: Optional[MeshAxis], mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Tl, H, hd], k/v [B, Tl, Hkv, hd]: this rank's slices; mask [B, Tl]
    the local key-padding mask (1 = attend) -> the local [B, Tl, H, hd]
    output of causal attention over the whole sequence."""
    B, Tl, H, hd = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError("H must be a multiple of Hkv")
    if scale is None:
        scale = hd ** -0.5
    n, idx = axis_size(axis), axis_index(axis)
    g = H // Hkv
    qf = q.float() * scale
    rows = torch.arange(Tl, device=q.device)[:, None]
    cols = torch.arange(Tl, device=q.device)[None, :]
    tri = torch.where(cols <= rows, 0.0, NEG)

    def partial(k_blk, v_blk, m_blk, src):
        kf = k_blk.float().repeat_interleave(g, dim=2)
        vf = v_blk.float().repeat_interleave(g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        if src == idx:
            s = s + tri
        elif src > idx:
            s = s + NEG
        if m_blk is not None:
            s = s + torch.where(m_blk.bool(), 0.0, NEG)[:, None, None, :]
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        return m, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bhqd", p, vf)

    m_acc = torch.full((B, H, Tl), NEG, device=q.device)
    l_acc = torch.zeros((B, H, Tl), device=q.device)
    o_acc = torch.zeros((B, H, Tl, hd), device=q.device)
    k_cur, v_cur, m_cur = k, v, mask
    for h in range(n):
        if h:  # after h rotations this rank holds the block of shard idx - h
            k_cur, v_cur = ppermute(k_cur, axis), ppermute(v_cur, axis)
            m_cur = None if m_cur is None else ppermute(m_cur, axis)
        pm, pl, po = partial(k_cur, v_cur, m_cur, (idx - h) % n)
        m_new = torch.maximum(m_acc, pm)
        r_old, r_new = torch.exp(m_acc - m_new), torch.exp(pm - m_new)
        l_acc = l_acc * r_old + pl * r_new
        o_acc = o_acc * r_old[..., None] + po * r_new[..., None]
        m_acc = m_new
    safe = torch.where(l_acc > 0, l_acc, torch.ones_like(l_acc))
    out = torch.where(l_acc[..., None] > 0, o_acc / safe[..., None], 0.0)
    return out.transpose(1, 2).to(q.dtype)
