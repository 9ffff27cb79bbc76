"""Whisper audio encoder.

Counterpart of `audio_llama_tpu/models/whisper.py`:

  log-mel [B, n_mels, 3000]
    -> Conv1d(k=3, s=1) + GELU -> Conv1d(k=3, s=2) + GELU   (conv stem)
    -> + sinusoidal position embedding
    -> N x [pre-LN MHA, pre-LN GELU-MLP] (bidirectional)
    -> final LayerNorm -> [B, 1500, d_model]

The stack is padded ONCE to the 128 tile (1500 -> 1536); pad rows live in
their own residual lanes and are masked out of attention as keys, then
sliced off before `ln_post`. The two per-layer LayerNorms run the kernel of
`ops/layer_norm.py` and attention the kernel of `ops/enc_attention.py`;
`ln_post` stays the plain LayerNorm, as in the JAX package. The conv stem
and the projections are plain `F.conv1d` / `torch.matmul`. The W8A8 twin
over a quantized tree is `models/whisper_int8.py::encode_int8`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..bridge import ParamTree
from ..config import WhisperConfig
from ..ops.enc_attention import enc_attention
from ..ops.layer_norm import layer_norm as layer_norm_kernel
from ..ops.norms import layer_norm

TILE = 128


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal table (HF's initializer formula)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def init_params(
    cfg: WhisperConfig, generator: torch.Generator, dtype=torch.float32
) -> ParamTree:
    """Random init (tests, benchmarks) on the generator's device; the same
    tree and scales as the JAX package's init, not the same numbers."""
    D, Fd, L, M = cfg.d_model, cfg.ffn_dim, cfg.num_layers, cfg.num_mel_bins
    dev = generator.device

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def dense(shape):
        return normal(shape, shape[-2] ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return ParamTree({
        "conv1": {"w": normal((D, M, 3), (M * 3) ** -0.5), "b": zeros(D)},
        "conv2": {"w": normal((D, D, 3), (D * 3) ** -0.5), "b": zeros(D)},
        "pos_embed": torch.as_tensor(
            sinusoid_position_embedding(cfg.max_source_positions, D), device=dev
        ).to(dtype),
        "layers": {
            "attn_ln": {"scale": ones(L, D), "bias": zeros(L, D)},
            "q_proj": {"w": dense((L, D, D)), "b": zeros(L, D)},
            "k_proj": {"w": dense((L, D, D))},
            "v_proj": {"w": dense((L, D, D)), "b": zeros(L, D)},
            "out_proj": {"w": dense((L, D, D)), "b": zeros(L, D)},
            "mlp_ln": {"scale": ones(L, D), "bias": zeros(L, D)},
            "fc1": {"w": dense((L, D, Fd)), "b": zeros(L, Fd)},
            "fc2": {"w": dense((L, Fd, D)), "b": zeros(L, D)},
        },
        "ln_post": {"scale": ones(D), "bias": zeros(D)},
    })


def _gelu(x: torch.Tensor, approx: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approx else "none")


def stem(params: ParamTree, cfg: WhisperConfig, mel: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The conv stem and position embedding: log-mel [B, n_mels, T_mel] ->
    [B, T_mel // 2, d_model] in compute_dtype."""
    cd = compute_dtype
    approx = cfg.gelu_approx
    x = mel.to(cd)
    x = _gelu(F.conv1d(x, params["conv1"]["w"].to(cd), params["conv1"]["b"].to(cd),
                       stride=1, padding=1), approx)
    x = _gelu(F.conv1d(x, params["conv2"]["w"].to(cd), params["conv2"]["b"].to(cd),
                       stride=2, padding=1), approx)
    x = x.transpose(1, 2)  # [B, T, D]
    return x + params["pos_embed"][:x.shape[1]].to(cd)


def pad_to_tile(x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> [B, T rounded up to TILE, D], contiguous, zero rows appended."""
    T = x.shape[1]
    pad = -T % TILE
    return (F.pad(x, (0, 0, 0, pad)) if pad else x).contiguous()


@torch.no_grad()
def encode(
    params: ParamTree,
    cfg: WhisperConfig,
    mel: torch.Tensor,  # [B, n_mels, T_mel]
    compute_dtype=torch.bfloat16,
    attn_algo: str = "v3",
) -> torch.Tensor:
    """Frozen encoder forward -> [B, T_mel // 2, d_model] in compute_dtype.
    `attn_algo`: the encoder attention kernel, as JAX's `encode(attn_algo=)`
    (`ops/enc_attention.py`: 'v3', 'v3q', 'bounded' or 'twopass')."""
    cd = compute_dtype
    approx = cfg.gelu_approx
    x = stem(params, cfg, mel, cd)
    B, T_real, D = x.shape
    x = pad_to_tile(x)
    T = x.shape[1]

    H, hd = cfg.num_heads, cfg.head_dim
    lp = params["layers"]
    eps = cfg.layer_norm_eps
    for li in range(cfg.num_layers):
        h = layer_norm_kernel(x, lp["attn_ln"]["scale"][li].to(cd),
                              lp["attn_ln"]["bias"][li].to(cd), eps)
        q = h @ lp["q_proj"]["w"][li].to(cd) + lp["q_proj"]["b"][li].to(cd)
        k = h @ lp["k_proj"]["w"][li].to(cd)
        v = h @ lp["v_proj"]["w"][li].to(cd) + lp["v_proj"]["b"][li].to(cd)
        attn = enc_attention(
            q.view(B, T, H, hd), k.view(B, T, H, hd), v.view(B, T, H, hd),
            valid_len=T_real, scale=hd ** -0.5, algo=attn_algo,
        ).reshape(B, T, D)
        x = x + (attn @ lp["out_proj"]["w"][li].to(cd) + lp["out_proj"]["b"][li].to(cd))
        h = layer_norm_kernel(x, lp["mlp_ln"]["scale"][li].to(cd),
                              lp["mlp_ln"]["bias"][li].to(cd), eps)
        h = _gelu(h @ lp["fc1"]["w"][li].to(cd) + lp["fc1"]["b"][li].to(cd), approx)
        x = x + (h @ lp["fc2"]["w"][li].to(cd) + lp["fc2"]["b"][li].to(cd))

    x = x[:, :T_real]
    return layer_norm(x, params["ln_post"]["scale"], params["ln_post"]["bias"], eps)
