"""Weight-only int4 (W4A16) Llama trees.

Counterpart of `audio_llama_tpu/models/llama_int4.py`, for the fused tp=1
tree that the inference CLI builds: the shared-input projections are
quantized as one matrix each,

    layers["qkv_proj"]    = {"w_p": int8 [L, D, (Nq + 2 Nkv) / 2], "w_s": f32 [L, D/128, Nq + 2 Nkv]}
    layers["gateup_proj"] = {"w_p": int8 [L, D, F],  "w_s": f32 [L, D/128, 2F]}
    layers["o_proj"], layers["down_proj"]  (the same layout, one matrix each)

(ops/int4_matmul.py packing), consumed by the W4A16 kernel and the fused
decode MLP kernel through `models/llama.py::llama_forward`. The embedding
table becomes per-row int8 {"weight": int8 [V, D], "scale": f32 [V]} and an
untied lm_head per-column int8 {"w_q", "w_s"}. An `obin` tree carries the
scalar marker leaf `int4_obin`.

Not ported yet (ROADMAP queue 2): `smooth=True` (per-row equalizers), the
tensor-parallel pack-after-shard layout (tp > 1) and the unfused tree.
"""

from __future__ import annotations

import torch

from ..bridge import ParamTree
from ..ops import int4_matmul as i4
from .llama_int8 import _quantize_rows, _quantize_stacked

# Clipped-RTN scale-search candidates (the JAX package's CLIP_CANDS).
CLIP_CANDS = (1.0, 0.92, 0.84, 0.76, 0.68)

_LATER = "not ported yet (ROADMAP queue 2: the int4 trees' smooth, tp and unfused variants)"


def _quantize_stacked_int4(w: torch.Tensor, group: int = i4.GROUP, clip: bool = False,
                           fmt=None) -> dict:
    """[L, K, N] -> {'w_p' int8 [L, K, N/2], 'w_s' f32 [L, K/group, N]},
    one layer at a time (the f32 transients of the clip search stay small)."""
    cands = CLIP_CANDS if clip else None
    packed, scales = zip(*(i4.quantize_pack(w[li], group, cands, fmt) for li in range(w.shape[0])))
    return {"w_p": torch.stack(packed), "w_s": torch.stack(scales)}


def quantize_llama_int4(params: ParamTree, include_embed: bool = True, group: int = i4.GROUP,
                        tp: int = 1, fuse=None, smooth: bool = False, clip=None,
                        fmt=None) -> ParamTree:
    """Llama tree -> fused weight-only-int4 tree (see the module docstring).
    clip (None = auto: on, since QuaRot-rotated trees are not ported) runs
    the clipped-RTN scale search; fmt is 'pair' (default) or 'obin'."""
    lp = params["layers"]
    first = lp["qkv_proj"] if "qkv_proj" in lp else lp["q_proj"]
    if isinstance(first, ParamTree):
        raise ValueError("quantize_llama_int4 expects a full-precision tree "
                         "(got an already-quantized one)")
    if fuse is None:
        fuse = tp == 1
    if fuse and tp > 1:
        raise ValueError("fused int4 trees are tp=1 only (dp/single-chip)")
    if not fuse or tp > 1 or smooth:
        raise NotImplementedError(f"unfused / tp / smooth int4 trees: {_LATER}")
    if clip is None:
        clip = "rot" not in params
    fmt = i4._fmt(fmt)

    def q4(w):
        return _quantize_stacked_int4(w, group, clip=clip, fmt=fmt)

    out = {k: v for k, v in params.to_dict().items() if k != "layers"}
    if fmt == "obin":
        out["int4_obin"] = torch.zeros((), dtype=torch.int8, device=lp["q_proj"].device)
    layers = {k: v for k, v in lp.to_dict().items()
              if k not in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                           "o_proj", "down_proj")}
    layers["qkv_proj"] = q4(torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1))
    layers["gateup_proj"] = q4(torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1))
    layers["o_proj"] = q4(lp["o_proj"])
    layers["down_proj"] = q4(lp["down_proj"])
    out["layers"] = layers
    if include_embed:
        q, s = _quantize_rows(params["embed"]["weight"])
        out["embed"] = {"weight": q, "scale": s}
        if "lm_head" in params:
            out["lm_head"] = _quantize_stacked(params["lm_head"])
    return ParamTree(out)


def _fmt_of(params) -> str:
    return "obin" if "int4_obin" in params else "pair"


def dequantize_llama_int4(params: ParamTree) -> ParamTree:
    """int4 tree -> f32 tree with the canonical per-projection names (the
    numerics oracle of the parity tests)."""
    lp = params["layers"]
    if "qkv_proj" not in lp:
        raise NotImplementedError(f"unfused int4 tree: {_LATER}")
    fmt = _fmt_of(params)

    def deq(w):
        g = w["w_p"].shape[-2] // w["w_s"].shape[-2]
        return torch.stack([i4.dequantize_ref(p, s, g, fmt) for p, s in zip(w["w_p"], w["w_s"])])

    out = {k: v for k, v in params.to_dict().items() if k not in ("int4_obin", "layers")}
    layers = {k: v for k, v in lp.to_dict().items()
              if k not in ("qkv_proj", "gateup_proj", "o_proj", "down_proj")}
    qkv, gu = deq(lp["qkv_proj"]), deq(lp["gateup_proj"])
    nq = lp["o_proj"]["w_p"].shape[1]  # o_proj's K is Hq * hd
    nkv = (qkv.shape[-1] - nq) // 2
    layers["q_proj"] = qkv[..., :nq]
    layers["k_proj"] = qkv[..., nq:nq + nkv]
    layers["v_proj"] = qkv[..., nq + nkv:]
    nf = gu.shape[-1] // 2
    layers["gate_proj"], layers["up_proj"] = gu[..., :nf], gu[..., nf:]
    layers["o_proj"], layers["down_proj"] = deq(lp["o_proj"]), deq(lp["down_proj"])
    out["layers"] = layers
    emb = params["embed"]
    if "scale" in emb:
        out["embed"] = {"weight": emb["weight"].to(torch.float32) * emb["scale"][:, None]}
    head = params.get("lm_head")
    if isinstance(head, ParamTree):
        out["lm_head"] = head["w_q"].to(torch.float32) * head["w_s"][None, :]
    return ParamTree(out)


def is_int4(params) -> bool:
    lp = params["layers"]
    w = lp["qkv_proj"] if "qkv_proj" in lp else lp["q_proj"]
    return isinstance(w, ParamTree) and "w_p" in w
