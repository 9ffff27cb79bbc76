"""Weight-only int4 (W4A16) Llama trees.

Counterpart of `audio_llama_tpu/models/llama_int4.py`. The fused tp=1 tree
that the inference CLI builds quantizes the shared-input projections as one
matrix each,

    layers["qkv_proj"]    = {"w_p": int8 [L, D, (Nq + 2 Nkv) / 2], "w_s": f32 [L, D/128, Nq + 2 Nkv]}
    layers["gateup_proj"] = {"w_p": int8 [L, D, F],  "w_s": f32 [L, D/128, 2F]}
    layers["o_proj"], layers["down_proj"]  (the same layout, one matrix each)

(ops/int4_matmul.py packing), consumed by the W4A16 kernel and the fused
decode MLP kernel through `models/llama.py::llama_forward`. The embedding
table becomes per-row int8 {"weight": int8 [V, D], "scale": f32 [V]} and an
untied lm_head per-column int8 {"w_q", "w_s"}. An `obin` tree carries the
scalar marker leaf `int4_obin`.

The unfused tree (`fuse=False`) quantizes each of the seven projections on
its own, {"w_p": int8 [L, K, N/2], "w_s": f32 [L, K/g, N]}. For tensor
parallelism (`tp > 1`, unfused) the column-parallel slabs (q/k/v/gate/up)
are packed AFTER the shard: w_p [L, K, tp, N/(2 tp)], block s the canonical
packing of output columns [s N/tp, (s + 1) N/tp), so a tp rank's block is a
self-contained slab; w_s stays [L, K/g, N]. Row-parallel slabs (o/down)
shard the contraction dim, which the packing never pairs across; their
group scales must stay shard-aligned, (K/tp) % group == 0. The bytes equal
the JAX package's for the same weights.

Not ported yet (ROADMAP queue 1 item 3): `smooth=True` (per-row equalizers).
"""

from __future__ import annotations

import torch

from ..bridge import ParamTree
from ..ops import int4_matmul as i4
from .llama_int8 import _quantize_rows, _quantize_stacked

# Clipped-RTN scale-search candidates (the JAX package's CLIP_CANDS).
CLIP_CANDS = (1.0, 0.92, 0.84, 0.76, 0.68)

# Megatron roles (parallel/sharding.py): column-parallel slabs shard the OUT
# dim, the one the nibble packing pairs across
_COL_NAMES = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _quantize_stacked_int4(w: torch.Tensor, group: int = i4.GROUP, clip: bool = False,
                           fmt=None, tp: int = 1) -> dict:
    """[L, K, N] -> {'w_p' int8 [L, K, N/2], 'w_s' f32 [L, K/group, N]},
    one layer at a time (the f32 transients of the clip search stay small).
    tp > 1: the pack-after-shard layout, w_p [L, K, tp, N/(2 tp)]."""
    cands = CLIP_CANDS if clip else None
    L, K, N = w.shape
    if tp == 1:
        packed, scales = zip(*(i4.quantize_pack(w[li], group, cands, fmt) for li in range(L)))
        return {"w_p": torch.stack(packed), "w_s": torch.stack(scales)}
    if N % (2 * tp):
        raise ValueError(f"int4 pack-after-shard needs (2*tp) | N; got N={N} tp={tp}")
    n = N // tp
    packed, scales = [], []
    for li in range(L):
        blocks = [i4.quantize_pack(w[li][:, s * n:(s + 1) * n], group, cands, fmt)
                  for s in range(tp)]
        packed.append(torch.stack([p for p, _ in blocks], dim=1))  # [K, tp, n/2]
        scales.append(torch.cat([sc for _, sc in blocks], dim=1))  # [K/g, N]
    return {"w_p": torch.stack(packed), "w_s": torch.stack(scales)}


def quantize_llama_int4(params: ParamTree, include_embed: bool = True, group: int = i4.GROUP,
                        tp: int = 1, fuse=None, smooth: bool = False, clip=None,
                        fmt=None) -> ParamTree:
    """Llama tree -> weight-only-int4 tree (see the module docstring): fused
    by default at tp = 1 (`fuse=None`), unfused with `fuse=False`, packed
    after the shard for `tp > 1` (unfused). clip (None = auto: on for plain
    trees, off for QuaRot-rotated ones) runs the clipped-RTN scale search;
    fmt is 'pair' (default) or 'obin'."""
    lp = params["layers"]
    first = lp["qkv_proj"] if "qkv_proj" in lp else lp["q_proj"]
    if isinstance(first, ParamTree):
        raise ValueError("quantize_llama_int4 expects a full-precision tree "
                         "(got an already-quantized one)")
    if fuse is None:
        fuse = tp == 1
    if fuse and tp > 1:
        raise ValueError("fused int4 trees are tp=1 only (dp/single-chip)")
    if smooth:
        raise NotImplementedError("smooth int4 trees are not ported yet (ROADMAP queue 1 item 3)")
    if clip is None:
        clip = "rot" not in params
    fmt = i4._fmt(fmt)

    def q4(w, tp=1):
        return _quantize_stacked_int4(w, group, clip=clip, fmt=fmt, tp=tp)

    out = {k: v for k, v in params.to_dict().items() if k != "layers"}
    if fmt == "obin":
        out["int4_obin"] = torch.zeros((), dtype=torch.int8, device=lp["q_proj"].device)
    layers = {k: v for k, v in lp.to_dict().items() if k not in LINEAR_NAMES}
    if fuse:
        layers["qkv_proj"] = q4(torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1))
        layers["gateup_proj"] = q4(torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1))
        layers["o_proj"] = q4(lp["o_proj"])
        layers["down_proj"] = q4(lp["down_proj"])
    else:
        for name in LINEAR_NAMES:
            col = name in _COL_NAMES
            if tp > 1 and not col:
                K = lp[name].shape[1]
                if K % tp or (K // tp) % group:
                    raise ValueError(f"int4 row-parallel slab {name}: need group ({group}) "
                                     f"| K/tp ({K}/{tp})")
            layers[name] = q4(lp[name], tp if col else 1)
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
    """int4 tree (fused, unfused or tp-packed) -> f32 tree with the canonical
    per-projection names (the numerics oracle of the parity tests)."""
    lp = params["layers"]
    fmt = _fmt_of(params)

    def deq(w):
        p, sc = w["w_p"], w["w_s"]
        K = p.shape[1]
        g = K // sc.shape[-2]
        if p.dim() == 4:  # pack-after-shard blocks [L, K, tp, N/(2 tp)]
            tp, n = p.shape[2], 2 * p.shape[3]
            return torch.stack([torch.cat(
                [i4.dequantize_ref(p[li, :, s], sc[li, :, s * n:(s + 1) * n], g, fmt)
                 for s in range(tp)], dim=-1) for li in range(p.shape[0])])
        return torch.stack([i4.dequantize_ref(pl, s, g, fmt) for pl, s in zip(p, sc)])

    out = {k: v for k, v in params.to_dict().items() if k not in ("int4_obin", "layers")}
    fused = ("qkv_proj", "gateup_proj", "o_proj", "down_proj")
    layers = {k: v for k, v in lp.to_dict().items()
              if k not in (fused if "qkv_proj" in lp else LINEAR_NAMES)}
    if "qkv_proj" in lp:
        qkv, gu = deq(lp["qkv_proj"]), deq(lp["gateup_proj"])
        nq = lp["o_proj"]["w_p"].shape[1]  # o_proj's K is Hq * hd
        nkv = (qkv.shape[-1] - nq) // 2
        layers["q_proj"] = qkv[..., :nq]
        layers["k_proj"] = qkv[..., nq:nq + nkv]
        layers["v_proj"] = qkv[..., nq + nkv:]
        nf = gu.shape[-1] // 2
        layers["gate_proj"], layers["up_proj"] = gu[..., :nf], gu[..., nf:]
        layers["o_proj"], layers["down_proj"] = deq(lp["o_proj"]), deq(lp["down_proj"])
    else:
        for name in LINEAR_NAMES:
            layers[name] = deq(lp[name])
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
