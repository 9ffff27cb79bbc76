"""KV-cached autoregressive generation.

Counterpart of `audio_llama_tpu/inference/generate.py::generate`: build the
<audio>+text embedding prefix, prefill a fresh static-shape KV cache, then
decode one token per step with temperature/top-p/top-k sampling and EOS
latching; exactly the new tokens come back. The decode loop is a Python
loop; positions, cache offsets and the done flags stay on the device, so a
step needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..bridge import ParamTree
from ..config import AudioLLMConfig
from ..device import DeviceLike, resolve_device
from ..models import allm
from ..models import llama as llama_mod
from ..models import lora as lora_mod
from ..models import projector as proj_mod
from ..ops import sampling


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens] int32, pad_id after EOS
    num_generated: torch.Tensor  # [B] int32, tokens up to and incl. EOS


def build_prefix(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    audio_features: Optional[torch.Tensor],
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
):
    """(embeds, mask) for the prompt (+ optional audio), laid out by
    cfg.splice_mode ('prepend' or 'inplace')."""
    if audio_features is None:
        return llama_mod.embed_tokens(frozen["llama"], input_ids, compute_dtype), attention_mask
    enc = allm.process_audio_features(frozen, cfg, audio_features, compute_dtype)
    audio_embeds = proj_mod.project(trainable["projector"], enc, compute_dtype)
    if cfg.splice_mode == "inplace":
        text = llama_mod.embed_tokens(frozen["llama"], input_ids, compute_dtype)
        embeds, mask, _ = allm.splice_inplace(
            text, audio_embeds, input_ids, attention_mask, None, audio_start_id
        )
        return embeds, mask
    return allm.combine_text_and_audio_embeddings(
        frozen, trainable, cfg, input_ids, attention_mask, audio_embeds,
        audio_start_id, audio_end_id, compute_dtype,
    )


@torch.no_grad()
def generate(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids,  # [B, T] (right-padded)
    attention_mask,  # [B, T]
    audio_features=None,  # [B, S] waveform, [B, n_mels, F] log-mel, or None
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int = 256,
    temperature: float = 0.7,
    top_p: float = 0.9,
    top_k: int = 0,
    greedy: bool = False,
    eos_id: int = 2,
    pad_id: int = 0,
    audio_start_id: int = 0,
    audio_end_id: int = 0,
    compute_dtype=torch.bfloat16,
    has_audio: bool = True,
    kv_quant=False,
    device: DeviceLike = None,
    megakernel: bool = True,
) -> GenerateResult:
    """Sampling defaults mirror the reference CLI (temperature 0.7, top_p
    0.9, 256 new tokens). Runs on `device` (the card unless the caller asks
    for the CPU), where the weights must already be. Sampling draws from
    `generator`, which must live on that device.

    kv_quant: False (a compute-dtype cache), True or 8 (int8 rows with
    per-row scales, decoded by the int8-KV kernel) or 4 (K/V-combined int4
    rows, decoded by the int4-KV kernel, or at B = 1 on the fused int4 tree
    by the decode megakernel; `megakernel=False` keeps those steps on the
    per-layer kernels)."""
    dev = resolve_device(device)
    weights_dev = frozen["llama"]["embed"]["weight"].device
    if weights_dev.type != dev.type:
        raise ValueError(f"weights are on {weights_dev}, generation asked for {dev}")
    if not greedy and generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
    attention_mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)
    if not has_audio:
        audio_features = None
    if audio_features is not None:
        audio_features = torch.as_tensor(audio_features, device=dev)

    lora = None
    if trainable is not None and "lora" in trainable and cfg.lora is not None:
        lora = lora_mod.with_scaling(trainable["lora"], cfg.lora)

    embeds, mask = build_prefix(
        frozen, trainable, cfg, input_ids, attention_mask, audio_features,
        audio_start_id, audio_end_id, compute_dtype,
    )
    B, P, _ = embeds.shape
    total = P + max_new_tokens
    full_mask = torch.cat(
        [mask.to(torch.int32), torch.ones((B, max_new_tokens), dtype=torch.int32, device=dev)],
        dim=1,
    )
    cache = llama_mod.KVCache.zeros(cfg.llama, B, total, dtype=compute_dtype, device=dev,
                                    quantized=kv_quant)
    _, cache, hidden = llama_mod.llama_forward(
        frozen["llama"], cfg.llama,
        inputs_embeds=embeds, attention_mask=full_mask, kv_cache=cache, lora=lora,
        compute_dtype=compute_dtype, assume_fresh_cache=True,
        return_hidden=True, unembed_logits=False,
    )
    # each row's last real position holds its next-token state
    real_len = mask.sum(dim=1).to(torch.int32)  # [B]
    idx = (real_len - 1).long()[:, None, None].expand(B, 1, hidden.shape[-1])
    last_hidden = torch.gather(hidden, 1, idx)
    next_logits = llama_mod.unembed(frozen["llama"], cfg.llama, last_hidden, compute_dtype)[:, 0]

    def sample(logits):
        return sampling.sample_token(
            logits, generator, temperature=temperature, top_p=top_p, top_k=top_k,
            greedy=greedy,
        )

    tok = sample(next_logits)
    done = tok == eos_id
    out = [tok]
    for i in range(max_new_tokens - 1):
        # RoPE position: real prompt length + tokens generated so far (pad
        # slots do not advance positions; the cache mask is slot-causal)
        positions = (real_len + i)[:, None]
        step_logits, cache = llama_mod.llama_forward(
            frozen["llama"], cfg.llama,
            input_ids=tok[:, None], attention_mask=full_mask, positions=positions,
            kv_cache=cache, lora=lora, compute_dtype=compute_dtype, megakernel=megakernel,
        )
        nxt = sample(step_logits[:, 0])
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
        tok = nxt
        out.append(nxt)
    tokens = torch.stack(out, dim=1)

    hit = tokens == eos_id
    first = hit.to(torch.int32).argmax(dim=1)
    num = torch.where(hit.any(dim=1), first + 1, torch.full_like(first, max_new_tokens))
    return GenerateResult(tokens=tokens, num_generated=num.to(torch.int32))
