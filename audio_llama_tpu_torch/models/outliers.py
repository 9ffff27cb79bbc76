"""Outlier-channel weight injection: the hard accuracy regime for the
quantization gates.

Counterpart of `audio_llama_tpu/models/outliers.py`. Trained transformers
carry a handful of channels at 20-100x the median magnitude (LayerNorm
gammas, residual-stream channels, a few huge MLP output channels); random
init does not. This module puts that structure into random Whisper and Llama
trees so the W8A8 encoder's smoothing (`models/whisper_int8.py`) and the
quantized decoders run in the regime real checkpoints occupy:

  whisper: attn_ln / mlp_ln scale outliers (activation outliers at the
      q/k/v and fc1 inputs), v_proj / fc1 output-channel outliers (at the
      out_proj and fc2 inputs), mild input-row outliers on every quantized
      linear;
  llama: RMSNorm scale outliers, k_proj / v_proj output-channel outliers
      (outlier K/V cache channels), mild input-row outliers on all seven
      linears.

Each multiplier field is ones except n random channels per layer, set to
scale * exp(0.5 N(0, 1)). The draw (`draw_*_mults`, from an explicit
`torch.Generator`) is apart from the application (`apply_*_outliers`), so a
test can feed JAX's own fields to the port's application; `inject_*` does
both. The port's draws are the generator's numbers, not JAX's.
"""

from __future__ import annotations

import torch

from ..bridge import ParamTree

WHISPER_ROW_SITES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
LLAMA_ROW_SITES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def channel_mults(gen: torch.Generator, L: int, C: int, n: int, scale: float) -> torch.Tensor:
    """[L, C] f32 multiplier field on the generator's device: ones except n
    random channels per layer set to scale * exp(0.5 N(0, 1))."""
    dev = gen.device
    idx = torch.randint(0, C, (L, n), generator=gen, device=dev)
    f = scale * torch.exp(0.5 * torch.randn((L, n), generator=gen, device=dev))
    m = torch.ones((L, C), device=dev)
    m[torch.arange(L, device=dev)[:, None], idx] = f
    return m


def _mul(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Multiply keeping x's dtype; m broadcasts against x's trailing dims."""
    return (x.float() * m.to(x.device)).to(x.dtype)


def draw_whisper_mults(gen: torch.Generator, L: int, D: int, F: int, n: int = 4,
                       scale: float = 40.0, weight_row_scale: float = 8.0) -> dict:
    """The Whisper multiplier fields, in JAX's order: attn_ln, mlp_ln [L, D],
    v_proj output [L, D], fc1 output [L, F], then each quantized linear's
    input rows ('rows/<name>', [L, in])."""
    mults = {"attn_ln": channel_mults(gen, L, D, n, scale),
             "mlp_ln": channel_mults(gen, L, D, n, scale),
             "v_out": channel_mults(gen, L, D, n, scale),
             "fc1_out": channel_mults(gen, L, F, n, scale)}
    for name in WHISPER_ROW_SITES:
        cin = F if name == "fc2" else D
        mults[f"rows/{name}"] = channel_mults(gen, L, cin, n, weight_row_scale)
    return mults


def apply_whisper_outliers(params, mults: dict) -> ParamTree:
    """A Whisper tree (stacked [L, ...] layers) -> a new tree with the fields
    applied; untouched leaves are shared."""
    layers = {k: dict(params["layers"][k].items()) for k in params["layers"]}
    layers["attn_ln"]["scale"] = _mul(layers["attn_ln"]["scale"], mults["attn_ln"])
    layers["mlp_ln"]["scale"] = _mul(layers["mlp_ln"]["scale"], mults["mlp_ln"])
    # output-channel outliers: w [L, in, out] -> columns (and bias)
    for name, key in (("v_proj", "v_out"), ("fc1", "fc1_out")):
        layers[name]["w"] = _mul(layers[name]["w"], mults[key][:, None, :])
        layers[name]["b"] = _mul(layers[name]["b"], mults[key])
    for name in WHISPER_ROW_SITES:
        layers[name]["w"] = _mul(layers[name]["w"], mults[f"rows/{name}"][:, :, None])
    out = dict(params.items())
    out["layers"] = layers
    return ParamTree(out)


def inject_whisper_outliers(params, gen: torch.Generator, n: int = 4, scale: float = 40.0,
                            weight_row_scale: float = 8.0) -> ParamTree:
    """Draw the Whisper fields from `gen` and apply them."""
    L, D = params["layers"]["attn_ln"]["scale"].shape
    F = params["layers"]["fc1"]["b"].shape[-1]
    return apply_whisper_outliers(
        params, draw_whisper_mults(gen, L, D, F, n, scale, weight_row_scale))


def draw_llama_mults(gen: torch.Generator, L: int, D: int, kv_dim: int, in_dims: dict,
                     n: int = 4, scale: float = 20.0, weight_row_scale: float = 8.0) -> dict:
    """The Llama multiplier fields, in JAX's order: input_ln, post_attn_ln
    [L, D], k_proj and v_proj outputs [L, kv_dim], then each linear's input
    rows ('rows/<name>', [L, in_dims[name]])."""
    mults = {"input_ln": channel_mults(gen, L, D, n, scale),
             "post_attn_ln": channel_mults(gen, L, D, n, scale),
             "k_out": channel_mults(gen, L, kv_dim, n, scale),
             "v_out": channel_mults(gen, L, kv_dim, n, scale)}
    for name in LLAMA_ROW_SITES:
        mults[f"rows/{name}"] = channel_mults(gen, L, in_dims[name], n, weight_row_scale)
    return mults


def apply_llama_outliers(params, mults: dict) -> ParamTree:
    """A Llama tree (stacked [L, ...] layers, before any quantization) -> a
    new tree with the fields applied."""
    layers = dict(params["layers"].items())
    for name in ("input_ln", "post_attn_ln"):
        layers[name] = _mul(layers[name], mults[name])
    layers["k_proj"] = _mul(layers["k_proj"], mults["k_out"][:, None, :])
    layers["v_proj"] = _mul(layers["v_proj"], mults["v_out"][:, None, :])
    for name in LLAMA_ROW_SITES:
        layers[name] = _mul(layers[name], mults[f"rows/{name}"][:, :, None])
    out = dict(params.items())
    out["layers"] = layers
    return ParamTree(out)


def inject_llama_outliers(params, gen: torch.Generator, n: int = 4, scale: float = 20.0,
                          weight_row_scale: float = 8.0) -> ParamTree:
    """Draw the Llama fields from `gen` and apply them. Apply before any
    quantization."""
    layers = params["layers"]
    L, D = layers["input_ln"].shape
    in_dims = {name: layers[name].shape[1] for name in LLAMA_ROW_SITES}
    return apply_llama_outliers(
        params, draw_llama_mults(gen, L, D, layers["k_proj"].shape[-1], in_dims, n, scale,
                                 weight_row_scale))
