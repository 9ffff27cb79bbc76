"""LoRA adapters as a parameter overlay on the Llama linears.

Counterpart of `audio_llama_tpu/models/lora.py`: a tree
{"layers": {name: {"a": [L, in, r], "b": [L, r, out]}}} whose deltas
x @ a @ b * (alpha / rank) are added inside `llama_forward`'s linears.
Targets {q,k,v,gate,up,down}_proj, never o_proj.
"""

from __future__ import annotations

import torch

from ..bridge import ParamTree
from ..config import LlamaConfig, LoraConfig


def _module_dims(cfg: LlamaConfig) -> dict:
    D, F = cfg.hidden_size, cfg.intermediate_size
    return {
        "q_proj": (D, cfg.num_heads * cfg.head_dim),
        "k_proj": (D, cfg.num_kv_heads * cfg.head_dim),
        "v_proj": (D, cfg.num_kv_heads * cfg.head_dim),
        "o_proj": (cfg.num_heads * cfg.head_dim, D),
        "gate_proj": (D, F),
        "up_proj": (D, F),
        "down_proj": (F, D),
    }


def init_params(
    llama_cfg: LlamaConfig,
    lora_cfg: LoraConfig,
    generator: torch.Generator,
    dtype=torch.float32,
) -> ParamTree:
    """'ref' init: a zeros, b ~ N(0, 0.01); 'standard': a ~ N(0, 1/r), b zeros."""
    L, r = llama_cfg.num_layers, lora_cfg.rank
    dims = _module_dims(llama_cfg)
    dev = generator.device
    layers = {}
    for name in lora_cfg.target_modules:
        if name not in dims:
            raise ValueError(f"unknown LoRA target {name!r}")
        i, o = dims[name]
        if lora_cfg.init == "ref":
            a = torch.zeros((L, i, r), dtype=dtype, device=dev)
            b = (torch.randn((L, r, o), generator=generator, device=dev) * 0.01).to(dtype)
        elif lora_cfg.init == "standard":
            a = (torch.randn((L, i, r), generator=generator, device=dev) / r).to(dtype)
            b = torch.zeros((L, r, o), dtype=dtype, device=dev)
        else:
            raise ValueError(f"unknown lora init {lora_cfg.init!r}")
        layers[name] = {"a": a, "b": b}
    return ParamTree({"layers": layers})


def with_scaling(lora_params: ParamTree, lora_cfg: LoraConfig) -> dict:
    """Attach the static scaling for `llama_forward`."""
    return {"layers": lora_params["layers"], "scaling": lora_cfg.scaling}


def merge_into_llama(params: ParamTree, lora: dict, scaling=None) -> ParamTree:
    """Fold the LoRA deltas into the frozen weights, w + a @ b * scaling
    (summed in f32, cast back to w's dtype), one layer at a time. Returns a
    new tree; the input is untouched. The inference CLI merges before it
    quantizes, so serving pays no LoRA overhead."""
    if scaling is None:
        scaling = lora["scaling"]
    tree = params.to_dict()
    layers = dict(tree["layers"])
    for name, br in lora["layers"].items():
        w = layers[name]
        merged = torch.empty_like(w)
        for li in range(w.shape[0]):
            delta = br["a"][li].to(torch.float32) @ br["b"][li].to(torch.float32) * scaling
            merged[li] = (w[li].to(torch.float32) + delta).to(w.dtype)
        layers[name] = merged
    tree["layers"] = layers
    return ParamTree(tree)
