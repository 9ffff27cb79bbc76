"""Audio projector: Whisper hidden -> Llama embedding space.

Counterpart of `audio_llama_tpu/models/projector.py`: Linear(in, hid) ->
exact GELU -> Linear(hid, out) -> LayerNorm(out), hid = (in + out) // 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..bridge import ParamTree
from ..config import ProjectorConfig
from ..ops.norms import layer_norm


def init_params(
    cfg: ProjectorConfig, generator: torch.Generator, dtype=torch.float32
) -> ParamTree:
    """Uniform(+-fan_in^-0.5) weights, zero biases, unit LN (the JAX init's
    distribution, not its numbers)."""
    i, h, o = cfg.input_dim, cfg.hidden, cfg.output_dim
    dev = generator.device

    def dense(fan_in, fan_out):
        bound = fan_in ** -0.5
        u = torch.rand((fan_in, fan_out), generator=generator, device=dev)
        return ((u * 2 - 1) * bound).to(dtype)

    def vec(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    return ParamTree({
        "fc1": {"w": dense(i, h), "b": vec(h, 0.0)},
        "fc2": {"w": dense(h, o), "b": vec(o, 0.0)},
        "ln": {"scale": vec(o, 1.0), "bias": vec(o, 0.0)},
    })


def project(params: ParamTree, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[B, T, whisper_d] -> [B, T, llama_d]."""
    cd = compute_dtype
    x = x.to(cd)
    x = x @ params["fc1"]["w"].to(cd) + params["fc1"]["b"].to(cd)
    x = F.gelu(x, approximate="none")
    x = x @ params["fc2"]["w"].to(cd) + params["fc2"]["b"].to(cd)
    return layer_norm(x, params["ln"]["scale"], params["ln"]["bias"])
