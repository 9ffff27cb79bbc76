"""W8A8 int8 Whisper encoder with SmoothQuant activation smoothing.

Counterpart of `audio_llama_tpu/models/whisper_int8.py`:

  calibrate_encoder(params, cfg, mel): one full-precision forward (plain
      LayerNorm, stock attention `ops.attention.mha`, no padding) recording
      each quantized linear's per-INPUT-channel absmax: {'qkv', 'out', 'fc1',
      'fc2'}, each [L, in];
  quantize_encoder(params, act_stats, alpha, fold): per-OUTPUT-channel
      symmetric int8 weights {'w_q', 'w_s'} for q/k/v/out_proj/fc1/fc2; with
      act_stats each linear is SmoothQuant-smoothed, s_j = a_j^alpha /
      w_j^(1 - alpha) normalised to median 1. fold=True folds five of the six
      smoothers into the LayerNorms, v_proj's output columns and out_proj's
      rows, and only fc2 keeps a runtime divide ('a_s'); fold=False keeps
      every one at runtime;
  encode_int8(params, cfg, mel, attn_algo): whisper.encode's twin with every
      linear dynamic-activation W8A8 (per-row activation scales, int8 x int8
      -> int32, f32 rescale) and the encoder attention kernel chosen by
      `attn_algo` (`ops/enc_attention.py`).

The int8 products are `torch._int_mm` (a library product, as JAX leaves them
to XLA's int8 dot_general; not a Pallas kernel there): exact int32 sums on
the CPU and the card, never emulated in f32 (127^2 K passes 2^24 at K >
1040). LayerNorm and calibration stay plain, as in the JAX package.

Rounding as JAX's: `_mulcast` rounds back to the leaf's dtype; the median of
an even width is the mean of the two middle values (jnp.median; torch.median
takes the lower one); inside `encode_int8`'s layers the activation scale
multiplies by the f32 reciprocal of 127, as XLA compiles JAX's scan body,
while `_quantize_weight`, run eagerly in JAX, divides.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..bridge import ParamTree
from ..config import WhisperConfig
from ..ops.attention import mha
from ..ops.enc_attention import enc_attention
from ..ops.int4_matmul import absmax_scale
from ..ops.norms import layer_norm
from . import whisper as whisper_mod

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
# which calibration stat feeds each linear's smoother
STAT_KEY = {"q_proj": "qkv", "k_proj": "qkv", "v_proj": "qkv", "out_proj": "out",
            "fc1": "fc1", "fc2": "fc2"}
R127 = (1.0 / torch.tensor(127.0)).item()  # the f32 reciprocal, as a Python float


def is_quantized(wparams) -> bool:
    """Whether a Whisper tree went through `quantize_encoder` (JAX's
    dispatch test, allm.py:171-179)."""
    return "w_q" in wparams["layers"]["q_proj"]


def _quantize_weight(w: torch.Tensor):
    """[..., in, out] -> (int8 [..., in, out], f32 scales [..., out]):
    symmetric per output channel."""
    wf = w.float()
    scale = absmax_scale(wf.abs().amax(dim=-2), 127.0)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


def _row_absmax(w: torch.Tensor) -> torch.Tensor:
    """[..., in, out] -> per-input-channel |w| max [..., in]."""
    return torch.clamp(w.float().abs().amax(dim=-1), min=1e-5)


def _median(s: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis (keepdim): the middle value, or the mean
    of the two middle values of an even width."""
    n = s.shape[-1]
    srt = s.sort(dim=-1).values
    if n % 2:
        return srt[..., n // 2:n // 2 + 1]
    return (srt[..., n // 2 - 1:n // 2] + srt[..., n // 2:n // 2 + 1]) * 0.5


def _smooth_from_max(act_max: torch.Tensor, wmax: torch.Tensor, alpha: float) -> torch.Tensor:
    a = torch.clamp(act_max.float(), min=1e-5)
    s = a ** alpha / wmax ** (1.0 - alpha)
    s = s / _median(s)
    return torch.clamp(s, 1e-2, 1e4)


def smooth_scales(act_max: torch.Tensor, w: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant migration strength s_j = act_max_j^a / w_max_j^(1-a),
    normalised to median 1 and clipped; act_max [..., in], w [..., in, out]."""
    return _smooth_from_max(act_max, _row_absmax(w), alpha)


def _mulcast(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (x.float() * m).to(x.dtype)


def quantize_encoder(params: ParamTree, act_stats: Optional[dict] = None, alpha: float = 0.5,
                     fold: bool = True) -> ParamTree:
    """Whisper tree -> the same tree with int8 {'w_q', 'w_s'} (and, smoothed,
    'a_s') in place of 'w' in the six transformer linears. Untouched leaves
    are shared with `params`."""
    layers = {n: dict(params["layers"][n].items()) for n in params["layers"]}

    if act_stats is not None and fold:
        # one joint q/k/v smoother (they share the attn_ln output): wmax is the
        # maximum over the three weights' rows
        wmax = torch.maximum(_row_absmax(layers["q_proj"]["w"]),
                             torch.maximum(_row_absmax(layers["k_proj"]["w"]),
                                           _row_absmax(layers["v_proj"]["w"])))
        s_qkv = _smooth_from_max(act_stats["qkv"], wmax, alpha)
        s_out = smooth_scales(act_stats["out"], layers["out_proj"]["w"], alpha)
        s_fc1 = smooth_scales(act_stats["fc1"], layers["fc1"]["w"], alpha)
        for ln, s in (("attn_ln", s_qkv), ("mlp_ln", s_fc1)):
            layers[ln] = {k: _mulcast(layers[ln][k], 1.0 / s) for k in ("scale", "bias")}
        for n in ("q_proj", "k_proj", "v_proj"):
            layers[n]["w"] = _mulcast(layers[n]["w"], s_qkv[..., :, None])
        layers["fc1"]["w"] = _mulcast(layers["fc1"]["w"], s_fc1[..., :, None])
        # attention is linear in v: 1/s_out on v's output columns (+ bias)
        # scales the attention output per channel; s_out on out_proj's rows
        # undoes it inside the matmul
        inv_out = 1.0 / s_out
        layers["v_proj"]["w"] = _mulcast(layers["v_proj"]["w"], inv_out[..., None, :])
        layers["v_proj"]["b"] = _mulcast(layers["v_proj"]["b"], inv_out)
        layers["out_proj"]["w"] = _mulcast(layers["out_proj"]["w"], s_out[..., :, None])

    for name in QUANT_TARGETS:
        mod = layers[name]
        w = mod.pop("w")
        if act_stats is not None and (not fold or name == "fc2"):
            s = smooth_scales(act_stats[STAT_KEY[name]], w, alpha)
            w = w.float() * s[..., :, None]
            mod["a_s"] = s
        mod["w_q"], mod["w_s"] = _quantize_weight(w)
    out = dict(params.items())
    out["layers"] = layers
    return ParamTree(out)


@torch.no_grad()
def calibrate_encoder(params: ParamTree, cfg: WhisperConfig, mel: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> dict:
    """One encoder forward over a calibration mel batch (stock attention, no
    padding) -> the per-input-channel absmax each quantized linear sees:
    {'qkv': [L, D], 'out': [L, D], 'fc1': [L, D], 'fc2': [L, F]} f32."""
    cd = compute_dtype
    x = whisper_mod.stem(params, cfg, mel, cd)
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    lp, eps = params["layers"], cfg.layer_norm_eps

    def absmax(v):
        return v.float().abs().amax(dim=(0, 1))

    def lin(name, li, xx, bias=True):
        m = lp[name]
        y = xx.to(cd) @ m["w"][li].to(cd)
        if bias and "b" in m:
            y = y + m["b"][li].to(cd)
        return y

    stats = {k: [] for k in ("qkv", "out", "fc1", "fc2")}
    for li in range(cfg.num_layers):
        h = layer_norm(x, lp["attn_ln"]["scale"][li], lp["attn_ln"]["bias"][li], eps)
        stats["qkv"].append(absmax(h))
        q = lin("q_proj", li, h).view(B, T, H, hd)
        k = lin("k_proj", li, h, bias=False).view(B, T, H, hd)
        v = lin("v_proj", li, h).view(B, T, H, hd)
        attn = mha(q, k, v, bias=None, scale=hd ** -0.5).reshape(B, T, D)
        stats["out"].append(absmax(attn))
        x = x + lin("out_proj", li, attn)
        h = layer_norm(x, lp["mlp_ln"]["scale"][li], lp["mlp_ln"]["bias"][li], eps)
        stats["fc1"].append(absmax(h))
        h = whisper_mod._gelu(lin("fc1", li, h), cfg.gelu_approx)
        stats["fc2"].append(absmax(h))
        x = x + lin("fc2", li, h)
    return {k: torch.stack(v) for k, v in stats.items()}


def quantize_encoder_smoothed(params: ParamTree, cfg: WhisperConfig, calib_mel: torch.Tensor,
                              alpha: float = 0.5, compute_dtype=torch.bfloat16) -> ParamTree:
    """The production int8-encoder quantization: calibrate on a
    representative mel batch, then quantize with folded SmoothQuant
    smoothing."""
    stats = calibrate_encoder(params, cfg, calib_mel, compute_dtype)
    return quantize_encoder(params, act_stats=stats, alpha=alpha)


def _int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                 b: Optional[torch.Tensor] = None, a_s: Optional[torch.Tensor] = None):
    """(Optional smoother divide) + dynamic per-row activation quantization +
    int8 product + f32 rescale: x [..., in], wq [in, out] int8, ws [out] f32,
    a_s [in] -> f32 [..., out]."""
    xf = x.float()
    a_s = None if a_s is None else a_s.float()
    s_r = torch.clamp((xf if a_s is None else xf / a_s).abs().amax(dim=-1, keepdim=True),
                      min=1e-8) * R127
    # (x / a_s) / s_r as XLA simplifies it: x / (a_s * s_r)
    xq = torch.clamp(torch.round(xf / (s_r if a_s is None else a_s * s_r)), -127, 127)
    xq = xq.to(torch.int8)
    lead = xq.shape[:-1]
    acc = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*lead, wq.shape[-1])
    y = acc.float() * s_r * ws.float()
    if b is not None:
        y = y + b.float()
    return y


@torch.no_grad()
def encode_int8(params: ParamTree, cfg: WhisperConfig, mel: torch.Tensor,
                compute_dtype=torch.bfloat16, attn_algo: str = "v3") -> torch.Tensor:
    """W8A8 twin of `whisper.encode` over `quantize_encoder(params)` ->
    [B, T_mel // 2, d_model] in compute_dtype. The stack is padded to the
    128 tile, as JAX's kernel arms pad it (v3q's K mean and V scales span the
    padded rows); the LayerNorms are plain."""
    cd = compute_dtype
    x = whisper_mod.stem(params, cfg, mel, cd)
    B, T_real, D = x.shape
    x = whisper_mod.pad_to_tile(x)
    T = x.shape[1]
    H, hd = cfg.num_heads, cfg.head_dim
    lp, eps = params["layers"], cfg.layer_norm_eps

    def lin(name, li, xx, bias=True):
        m = lp[name]
        return _int8_linear(xx, m["w_q"][li], m["w_s"][li], m["b"][li] if bias else None,
                            m["a_s"][li] if "a_s" in m else None)

    for li in range(cfg.num_layers):
        h = layer_norm(x, lp["attn_ln"]["scale"][li], lp["attn_ln"]["bias"][li], eps)
        q = lin("q_proj", li, h).to(cd).view(B, T, H, hd)
        k = lin("k_proj", li, h, bias=False).to(cd).view(B, T, H, hd)
        v = lin("v_proj", li, h).to(cd).view(B, T, H, hd)
        attn = enc_attention(q, k, v, valid_len=T_real, scale=hd ** -0.5, algo=attn_algo)
        x = x + lin("out_proj", li, attn.reshape(B, T, D)).to(cd)
        h = layer_norm(x, lp["mlp_ln"]["scale"][li], lp["mlp_ln"]["bias"][li], eps)
        h = F.gelu(lin("fc1", li, h), approximate="tanh" if cfg.gelu_approx else "none").to(cd)
        x = x + lin("fc2", li, h).to(cd)
    x = x[:, :T_real]
    return layer_norm(x, params["ln_post"]["scale"], params["ln_post"]["bias"], eps)
