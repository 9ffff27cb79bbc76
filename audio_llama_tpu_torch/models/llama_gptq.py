"""GPTQ error-feedback int4 quantization of the frozen Llama decoder.

Counterpart of `audio_llama_tpu/models/llama_gptq.py`. Round-to-nearest
int4 (`models/llama_int4.py`) quantizes every weight on its own; GPTQ
quantizes the contraction rows of a slab one after another and feeds each
row's rounding error into the rows not yet quantized, weighted by the
calibration Gram H = sum_t x_t x_t^T of the slab's inputs (the GPTQ / OBQ
recipe: the upper Cholesky factor of the damped H^-1, a row loop inside each
scale group and one product for the rows past it). It writes the
fused int4 tree of `quantize_llama_int4(fuse=True)` unchanged (q|k|v and
gate|up as one slab each, o and down, int8 embed and lm_head, the
`int4_obin` marker), so every consumer takes it as it is.

The Grams come from `llama_forward(collect_quant_stats=...)`
(`collect_llama_stats`): [L, K, K] f32 per role; at 3B dims the down role's
is [28, 8192, 8192], 7.5 GB. The kernels index scales by contiguous row
groups, so GPTQ's act-order permutation is not used, as in the JAX package.

`gptq_pack` takes one slab [K, N] or a stack [..., K, N] with its Grams
[..., K, K]: the layers of a stack run together, each with its own
arithmetic, so a stack of L layers costs one row loop instead of L. The
inverse and the Cholesky factor are library calls (plain large linear
algebra, as the JAX package leaves them to XLA); no kernel of this repo's
runs here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..bridge import ParamTree
from ..ops import int4_matmul as i4
from .llama import QUANT_STAT_ROLES, llama_forward
from .llama_int8 import _quantize_rows, _quantize_stacked


def gptq_pack(w: torch.Tensor, H: torch.Tensor, group: int = i4.GROUP, damp: float = 0.01,
              clip_cands: Optional[Tuple[float, ...]] = None,
              fmt: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [..., K, N] float, H [..., K, K] (the inputs' Gram) -> (packed
    [..., K, N/2] int8, scales [..., K/group, N] f32) in the kernels' layout.

    Inputs never activated in calibration (H's diagonal <= 0) are made
    inert: their rows quantize to zero and H gets a unit diagonal there. H
    is damped by damp x its mean diagonal, inverted, symmetrized, and its
    upper Cholesky factor U carries the feedback. Each group's scales come
    from its error-fed values (with `clip_cands`, the clipped-RTN search per
    column); each row's error (w - q s) / U[j, j] goes into the group's
    later rows, and the group's errors into every row past it."""
    *lead, K, N = w.shape
    if N % 2 or K % group:
        raise ValueError(f"gptq_pack needs even N and group|K; got {tuple(w.shape)}")
    dev = w.device
    W = w.to(torch.float32).clone()
    Hf = H.to(torch.float32).clone()
    dead = torch.diagonal(Hf, dim1=-2, dim2=-1) <= 0.0
    torch.diagonal(Hf, dim1=-2, dim2=-1).add_(dead.to(torch.float32))
    W.mul_((~dead).to(torch.float32)[..., None])
    mean_d = torch.diagonal(Hf, dim1=-2, dim2=-1).mean(dim=-1)
    torch.diagonal(Hf, dim1=-2, dim2=-1).add_((damp * mean_d)[..., None])
    # one matrix a call: torch's batched CPU inverse (MKL, several threads)
    # can deadlock from K ~ 200 on
    U = torch.empty_like(Hf)
    for Hi, Ui in zip(Hf.view(-1, K, K), U.view(-1, K, K)):
        Hinv = torch.linalg.inv(Hi)
        Hinv = 0.5 * (Hinv + Hinv.T)  # inv() is not exactly symmetric
        Ui.copy_(torch.linalg.cholesky(Hinv).T)  # Hinv = U^T U, U upper
    del Hf, Hinv

    Q = torch.empty((*lead, K, N), dtype=torch.int8, device=dev)
    scales = torch.empty((*lead, K // group, N), dtype=torch.float32, device=dev)
    cands = None
    if clip_cands:
        cands = torch.tensor(clip_cands, dtype=torch.float32, device=dev)
    for g in range(K // group):
        r0, r1 = g * group, (g + 1) * group
        Wg = W[..., r0:r1, :]  # a view: the row loop feeds W in place
        Ug = U[..., r0:r1, r0:r1]
        s = i4.absmax_scale(Wg.abs().amax(dim=-2), 7.0)  # [..., N]
        if cands is not None:
            errs = []
            for c in cands:  # the same MSE criterion as quantize_pack's
                sc = s * c
                qc = torch.clamp(torch.round(Wg / sc[..., None, :]), -7, 7)
                errs.append(((Wg - qc * sc[..., None, :]) ** 2).sum(dim=-2))
            s = s * cands[torch.argmin(torch.stack(errs), dim=0)]
        err = torch.empty_like(Wg)
        for j in range(group):
            wj = Wg[..., j, :]
            qj = torch.clamp(torch.round(wj / s), -7, 7)
            err[..., j, :] = (wj - qj * s) / Ug[..., j, j, None]
            Q[..., r0 + j, :] = qj.to(torch.int8)
            if j + 1 < group:  # the group's later rows only
                Wg[..., j + 1:, :] -= Ug[..., j, j + 1:, None] * err[..., j, None, :]
        scales[..., g, :] = s
        if r1 < K:  # every row past the group gets its accumulated feedback
            W[..., r1:, :] -= U[..., r0:r1, r1:].transpose(-1, -2) @ err
    return i4.pack_nibbles(Q[..., : N // 2], Q[..., N // 2:], fmt), scales


def gptq_proxy_loss(w, packed, scales, H, group: int = i4.GROUP, fmt: Optional[str] = None):
    """tr((W - What)^T H (W - What)): the objective GPTQ minimizes."""
    err = w.to(torch.float32) - i4.dequantize_ref(packed, scales, group, fmt)
    return torch.einsum("kn,kl,ln->", err, H.to(torch.float32), err)


def collect_llama_stats(params: ParamTree, cfg, input_ids=None, attention_mask=None,
                        roles: tuple = QUANT_STAT_ROLES, compute_dtype=torch.float32,
                        inputs_embeds=None) -> dict:
    """One teacher-forced calibration forward -> the per-layer input Grams
    {role: [L, K_role, K_role] f32}. input_ids (or inputs_embeds, an audio
    splice) and attention_mask are [B, T(, D)]. The Grams add over
    examples, so a caller short of memory calls this on slices of the batch
    and sums them. Attention is pinned to the plain arm (attn_impl='xla', as
    the JAX package's), so f32 calibration runs on the card as on the host."""
    with torch.no_grad():
        *_, stats = llama_forward(params, cfg, input_ids=input_ids, inputs_embeds=inputs_embeds,
                                  attention_mask=attention_mask, compute_dtype=compute_dtype,
                                  attn_impl="xla", unembed_logits=False,
                                  collect_quant_stats=tuple(roles))
    return stats


def quantize_llama_int4_gptq(params: ParamTree, stats: dict, include_embed: bool = True,
                             group: int = i4.GROUP, damp: float = 0.01,
                             clip_cands: Optional[Tuple[float, ...]] = None,
                             fmt: Optional[str] = None) -> ParamTree:
    """Full-precision Llama tree + calibration Grams -> the fused int4 tree
    of `quantize_llama_int4(fuse=True)`. A role missing from `stats` falls
    back to plain RTN (`quantize_pack`, no clip search), as in the JAX
    package."""
    lp = params["layers"]
    first = lp["qkv_proj"] if "qkv_proj" in lp else lp["q_proj"]
    if isinstance(first, ParamTree):
        raise ValueError("quantize_llama_int4_gptq expects a full-precision tree")
    fmt = i4._fmt(fmt)
    slabs = {
        "qkv_proj": (torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1), "qkv"),
        "gateup_proj": (torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1), "gateup"),
        "o_proj": (lp["o_proj"], "o"),
        "down_proj": (lp["down_proj"], "down"),
    }
    canonical = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    layers = {k: v for k, v in lp.to_dict().items() if k not in canonical}
    for name, (w, role) in slabs.items():
        if role in stats:
            packed, sc = gptq_pack(w, stats[role], group, damp, clip_cands, fmt)
        else:
            packed, sc = (torch.stack(t) for t in zip(
                *(i4.quantize_pack(w[li], group, fmt=fmt) for li in range(w.shape[0]))))
        layers[name] = {"w_p": packed, "w_s": sc}
    out = {k: v for k, v in params.to_dict().items() if k != "layers"}
    if fmt == "obin":
        out["int4_obin"] = torch.zeros((), dtype=torch.int8, device=lp["q_proj"].device)
    out["layers"] = layers
    if include_embed:
        q, s = _quantize_rows(params["embed"]["weight"])
        out["embed"] = {"weight": q, "scale": s}
        if "lm_head" in params:
            out["lm_head"] = _quantize_stacked(params["lm_head"])
    return ParamTree(out)
