"""Symmetric int8 quantizers of the weight-only int8 recipe.

Counterpart of the quantizers of `audio_llama_tpu/models/llama_int8.py`. The
int4 tree (models/llama_int4.py) stores its embedding table per row in int8
with `_quantize_rows`, and an untied lm_head per vocab column with
`_quantize_stacked`. The int8 decoder tree itself (`quantize_llama`) is not
ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch


def _quantize_stacked(w: torch.Tensor) -> dict:
    """[..., in, out] -> {'w_q' int8, 'w_s' f32 [..., out]}, symmetric per
    output column."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"w_q": q, "w_s": scale}


def _quantize_rows(w: torch.Tensor):
    """[V, D] -> (int8 [V, D], f32 [V]), symmetric per row."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale
