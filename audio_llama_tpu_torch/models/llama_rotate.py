"""QuaRot residual-stream rotation of a Llama tree before low-bit quantization.

Counterpart of `audio_llama_tpu/models/llama_rotate.py`. An orthogonal
rotation R of the residual stream leaves the model's output unchanged once
each RMSNorm's gamma is folded into the projections that consume it:

    q_proj, k_proj, v_proj, gate_proj, up_proj:  W <- R^T diag(gamma) W
    o_proj, down_proj:                           W <- W R

with the norms' gammas set to one. The tree carries R as `params["rot"]`;
`models/llama.py::llama_forward` rotates the stream once after the
embedding and un-rotates it once before the final norm (the sandwich form:
the embedding, final norm and lm_head stay as they are). With `heads` (the
default) a per-head rotation R2 [hd, hd] also folds into the v/o pair: v's
per-head output columns get R2 and o's per-head input rows R2^T, which
cancel through attention. The quantizers (llama_int4, llama_int8) then
quantize the rotated weights and pass `rot` through.

The JAX package draws R from a `jax.random` key; here it comes from a
`torch.Generator` or is given explicitly, and an explicit R needs an
explicit R2 (the JAX package draws that one from PRNGKey(0x52), which no
torch generator reproduces). The transform is exact, so the output in full
precision does not depend on which rotation was drawn.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..bridge import ParamTree
from ..config import LlamaConfig

# LoRA targets whose input is the rotated stream, keyed to the norm whose
# gamma they absorb; targets whose output re-enters the stream
_IN_SIDE = {
    "q_proj": "input_ln",
    "k_proj": "input_ln",
    "v_proj": "input_ln",
    "gate_proj": "post_attn_ln",
    "up_proj": "post_attn_ln",
}
_OUT_SIDE = ("o_proj", "down_proj")


def random_rotation(generator: torch.Generator, d: int, dtype=torch.float32) -> torch.Tensor:
    """Haar-uniform random orthogonal [d, d] on the generator's device: QR of
    a Gaussian matrix with the sign fix."""
    a = torch.randn((d, d), generator=generator, device=generator.device, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(dtype)


def _per_layer(w: torch.Tensor, fn) -> torch.Tensor:
    """fn on each layer's f32 matrix, cast back to w's dtype (one layer's f32
    copy at a time)."""
    return torch.stack([fn(m.to(torch.float32)).to(w.dtype) for m in w])


def _in_rot(w: torch.Tensor, gamma: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """[L, D, N] input-side fold: W <- R^T diag(gamma_l) W, per layer."""
    g = gamma.to(torch.float32)
    return torch.stack([(rf.T @ (m.to(torch.float32) * gl[:, None])).to(w.dtype)
                        for m, gl in zip(w, g)])


def _out_rot(w: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """[L, A, D] output-side fold: W <- W R, per layer."""
    return _per_layer(w, lambda m: m @ rf)


def _head_cols_rot(w: torch.Tensor, r2: torch.Tensor, hd: int) -> torch.Tensor:
    """[L, D, H*hd]: rotate each head's output column block by R2."""
    D, N = w.shape[1:]
    return _per_layer(w, lambda m: torch.einsum(
        "dhk,kj->dhj", m.reshape(D, N // hd, hd), r2).reshape(D, N))


def _head_rows_rot(w: torch.Tensor, r2: torch.Tensor, hd: int) -> torch.Tensor:
    """[L, H*hd, D]: counter-rotate each head's input row block (R2^T @)."""
    N, D = w.shape[1:]
    return _per_layer(w, lambda m: torch.einsum(
        "kj,hkd->hjd", r2, m.reshape(N // hd, hd, D)).reshape(N, D))


def rotate_llama(params: ParamTree, cfg: LlamaConfig,
                 key_or_rot: Union[torch.Generator, torch.Tensor], lora=None,
                 heads: bool = True, r2: Optional[torch.Tensor] = None):
    """Full-precision Llama tree -> the exactly equivalent rotated tree (with
    params["rot"]); with a LoRA overlay, (tree, rotated overlay).

    key_or_rot: a torch.Generator (R, then R2, are drawn from it) or an
    explicit orthogonal [D, D] tensor, which with `heads` needs `r2` [hd, hd].
    The input must be full precision (rotate before quantizing) and not
    rotated already."""
    if "rot" in params:
        raise ValueError("tree is already rotated")
    lp = params["layers"]
    if isinstance(lp["qkv_proj"] if "qkv_proj" in lp else lp["q_proj"], ParamTree):
        raise ValueError("rotate_llama expects a full-precision tree (rotate before quantizing)")
    d, hd = cfg.hidden_size, cfg.head_dim
    if isinstance(key_or_rot, torch.Generator):
        rot = random_rotation(key_or_rot, d)
        if heads and r2 is None:
            r2 = random_rotation(key_or_rot, hd)
    else:
        rot = key_or_rot
        if tuple(rot.shape) != (d, d):
            raise ValueError(f"rotation must be [{d}, {d}], got {tuple(rot.shape)}")
        if heads and r2 is None:
            raise ValueError("an explicit rotation with heads=True needs an explicit r2")
    rf = rot.to(torch.float32)

    tree = params.to_dict()
    layers = dict(tree["layers"])
    g_in, g_post = lp["input_ln"], lp["post_attn_ln"]
    for name, ln in _IN_SIDE.items():
        layers[name] = _in_rot(lp[name], g_in if ln == "input_ln" else g_post, rf)
    for name in _OUT_SIDE:
        layers[name] = _out_rot(lp[name], rf)
    layers["input_ln"] = torch.ones_like(g_in)
    layers["post_attn_ln"] = torch.ones_like(g_post)
    if heads:
        r2 = r2.to(device=rf.device, dtype=torch.float32)
        layers["v_proj"] = _head_cols_rot(layers["v_proj"], r2, hd)
        layers["o_proj"] = _head_rows_rot(layers["o_proj"], r2, hd)
    else:
        r2 = None
    tree["layers"] = layers
    tree["rot"] = rot
    out = ParamTree(tree)
    if lora is None:
        return out
    return out, rotate_lora(lora, g_in, g_post, rot, r2=r2, hd=hd)


def rotate_lora(lora, g_in: torch.Tensor, g_post: torch.Tensor, rot: torch.Tensor,
                r2: Optional[torch.Tensor] = None, hd: Optional[int] = None):
    """A LoRA overlay {"layers": {name: {"a", "b"}}, ...} made to act on the
    rotated stream: input-side a factors absorb R^T diag(gamma), the o/down
    b factors get b R, and with R2 v's b columns rotate per head and o's a
    rows counter-rotate. The adapted model's output is unchanged. Returns
    the overlay's own type (a ParamTree or a dict), other keys kept."""
    rf = rot.to(torch.float32)
    layers = {}
    for name, br in lora["layers"].items():
        a, b = br["a"], br["b"]
        if name in _IN_SIDE:
            a = _in_rot(a, g_in if _IN_SIDE[name] == "input_ln" else g_post, rf)
        if name in _OUT_SIDE:
            b = _out_rot(b, rf)
        if r2 is not None and name == "v_proj":  # b [L, r, Hkv*hd]: per-head columns
            b = _head_cols_rot(b, r2, hd)
        if r2 is not None and name == "o_proj":  # a [L, Hq*hd, r]: per-head rows
            a = _head_rows_rot(a, r2, hd)
        layers[name] = {"a": a.detach(), "b": b.detach()}
    if isinstance(lora, ParamTree):
        out = lora.to_dict()
        out["layers"] = layers
        return ParamTree(out)
    out = dict(lora)
    out["layers"] = layers
    return out
