"""Weight-only int8 (W8A16) Llama trees.

Counterpart of `audio_llama_tpu/models/llama_int8.py`. Each stacked linear
slab [L, in, out] becomes {"w_q": int8 [L, in, out], "w_s": f32 [L, out]}
(symmetric per output column), consumed by `models/llama.py::_linear` as
(x @ w_q) * w_s in the compute dtype; the embedding table becomes per-row
int8 {"weight": int8 [V, D], "scale": f32 [V]} and an untied lm_head per
vocab column {"w_q", "w_s"}. The int4 tree (models/llama_int4.py) stores its
embedding table and lm_head with the same quantizers. Other leaves (the
norms, a QuaRot `rot`) pass through.
"""

from __future__ import annotations

import torch

from ..bridge import ParamTree
from ..ops.int4_matmul import absmax_scale
from .llama import LINEAR_NAMES


def _quantize_stacked(w: torch.Tensor) -> dict:
    """[..., in, out] -> {'w_q' int8, 'w_s' f32 [..., out]}, symmetric per
    output column."""
    wf = w.to(torch.float32)
    scale = absmax_scale(wf.abs().amax(dim=-2), 127.0)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"w_q": q, "w_s": scale}


def _quantize_rows(w: torch.Tensor):
    """[V, D] -> (int8 [V, D], f32 [V]), symmetric per row."""
    wf = w.to(torch.float32)
    scale = absmax_scale(wf.abs().amax(dim=-1), 127.0)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_llama(params: ParamTree, include_embed: bool = True) -> ParamTree:
    """Llama tree -> weight-only int8 tree (see the module docstring);
    include_embed also quantizes the embedding table and an untied lm_head."""
    lp = params["layers"]
    if isinstance(lp["q_proj"], ParamTree):
        raise ValueError("quantize_llama expects a full-precision tree "
                         "(got an already-quantized one)")
    out = params.to_dict()
    layers = dict(out["layers"])
    for name in LINEAR_NAMES:
        layers[name] = _quantize_stacked(lp[name])
    out["layers"] = layers
    if include_embed:
        q, s = _quantize_rows(params["embed"]["weight"])
        out["embed"] = {"weight": q, "scale": s}
        if "lm_head" in params:
            out["lm_head"] = _quantize_stacked(params["lm_head"])
    return ParamTree(out)


def is_quantized(params) -> bool:
    return isinstance(params["layers"]["q_proj"], ParamTree)
