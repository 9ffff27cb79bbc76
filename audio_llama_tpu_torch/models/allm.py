"""AudioLLM: frozen Whisper encoder + projector + frozen Llama with LoRA.

Counterpart of `audio_llama_tpu/models/allm.py`. Two parameter trees, as in
the JAX package:

    frozen    = {"llama": ..., "whisper": ...}
    trainable = {"projector": ..., "lora": ...}

mel [B, n_mels, 3000] -> whisper.encode -> projector.project ->
splice (<audio> ++ audio ++ </audio> ++ text) -> llama_forward.

`process_audio_features` takes a waveform [B, S] (log-mel through the mel
kernel, `ops/mel_power.py`; audio longer than one 30 s window as N windows
folded into the batch) or precomputed log-mel ([B, n_mels, F] or
[B, 1, n_mels, F]). It runs without autograd, the counterpart of the JAX
package's `stop_gradient`: gradients reach the projector and LoRA only.
`forward` is the training forward: audio path, splice ('prepend' or
'inplace'), the decoder with LoRA and the shifted cross-entropy (dense, or
in sequence chunks with `loss_chunk_size`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..bridge import ParamTree
from ..config import AudioLLMConfig
from . import llama as llama_mod
from . import lora as lora_mod
from . import projector as proj_mod
from . import whisper as whisper_mod
from ..ops import mel_power

IGNORE_INDEX = -100


class AudioLLMBatch(NamedTuple):
    """One training batch of static shapes (collate pads to them)."""

    input_ids: torch.Tensor  # [B, T] prompt (+ response) tokens
    attention_mask: torch.Tensor  # [B, T] 1 = real
    audio_features: Optional[torch.Tensor]  # [B, S] waveform, [B, n_mels, F] log-mel, or None
    labels: torch.Tensor  # [B, T], -100 = ignored


def init_trainable(cfg: AudioLLMConfig, generator: torch.Generator,
                   dtype=torch.float32) -> ParamTree:
    """Projector + (optional) LoRA on the generator's device."""
    tree = {"projector": proj_mod.init_params(cfg.projector, generator, dtype)}
    if cfg.lora is not None:
        tree["lora"] = lora_mod.init_params(cfg.llama, cfg.lora, generator, dtype)
    return ParamTree(tree)


def num_trainable_params(trainable: ParamTree) -> int:
    return int(sum(p.numel() for p in trainable.parameters()))


def init_frozen(cfg: AudioLLMConfig, generator: torch.Generator,
                dtype=torch.bfloat16) -> ParamTree:
    """Random frozen Llama + Whisper on the generator's device (tests,
    benchmarks; real checkpoints load through an HF loader, not yet
    ported)."""
    return ParamTree({
        "llama": llama_mod.init_params(cfg.llama, generator, dtype),
        "whisper": whisper_mod.init_params(cfg.whisper, generator, dtype),
    })


@torch.no_grad()
def process_audio_features(
    frozen: ParamTree, cfg: AudioLLMConfig, audio: torch.Tensor,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Waveform [B, S] at 16 kHz, or precomputed log-mel [B, n_mels, F] (or
    [B, 1, n_mels, F]) -> encoder states [B, A, d_whisper].

    A waveform longer than one window (cfg.mel.max_samples, 30 s) is N
    consecutive windows: [B, N * S] runs as [B * N, S] through the mel
    kernel and the encoder, then unfolds to [B, N * A, d]. The length must
    be a whole number of windows (the host pads)."""
    if audio.dim() == 2:
        S = cfg.mel.max_samples
        B, total = audio.shape
        if total % S:
            raise ValueError(f"waveform length {total} must be a multiple of the {S}-sample "
                             "window (pad on the host)")
        n_windows = total // S
        mel = mel_power.log_mel(audio.reshape(B * n_windows, S), cfg.mel)
        enc = whisper_mod.encode(frozen["whisper"], cfg.whisper, mel, compute_dtype)
        return enc.reshape(B, n_windows * enc.shape[1], enc.shape[2])
    mel = audio.squeeze(1) if audio.dim() == 4 else audio
    return whisper_mod.encode(frozen["whisper"], cfg.whisper, mel, compute_dtype)


def combine_text_and_audio_embeddings(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids: torch.Tensor,  # [B, T]
    attention_mask: torch.Tensor,  # [B, T]
    audio_embeds: torch.Tensor,  # [B, A, d_llama], already projected
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
):
    """'prepend' splice -> (embeds [B, A+2+T, D], mask [B, A+2+T])."""
    vocab = frozen["llama"]["embed"]["weight"].shape[0]
    if audio_start_id >= vocab or audio_end_id >= vocab:
        raise ValueError(
            f"audio delimiter ids ({audio_start_id}, {audio_end_id}) out of "
            f"range for embedding table of size {vocab} — did you forget "
            "resize_embeddings?"
        )
    B, A = audio_embeds.shape[:2]
    text = llama_mod.embed_tokens(frozen["llama"], input_ids, compute_dtype)
    delim = llama_mod.embed_tokens(
        frozen["llama"],
        torch.tensor([[audio_start_id, audio_end_id]], device=input_ids.device),
        compute_dtype,
    )  # [1, 2, D]
    D = text.shape[-1]
    combined = torch.cat([
        delim[:, 0:1].expand(B, 1, D),
        audio_embeds.to(compute_dtype),
        delim[:, 1:2].expand(B, 1, D),
        text,
    ], dim=1)
    ones = torch.ones((B, A + 2), dtype=attention_mask.dtype, device=attention_mask.device)
    return combined, torch.cat([ones, attention_mask], dim=1)


def splice_inplace(
    text_embeds: torch.Tensor,  # [B, T, D]
    audio_embeds: torch.Tensor,  # [B, A, D]
    input_ids: torch.Tensor,  # [B, T]
    attention_mask: torch.Tensor,  # [B, T]
    labels: Optional[torch.Tensor],  # [B, T] or None
    audio_start_id: int,
):
    """Insert the audio block right after the first `<audio>` token of each
    row (rows without one get it at the front). Output position j holds
    text[j] for j <= p, audio[j-p-1] for p < j <= p+A, text[j-A] after.
    Returns (embeds [B, T+A, D], mask [B, T+A], labels [B, T+A] | None)."""
    B, T, D = text_embeds.shape
    A = audio_embeds.shape[1]
    is_start = input_ids == audio_start_id
    has = is_start.any(dim=1)
    first = is_start.to(torch.int32).argmax(dim=1)
    p = torch.where(has, first, torch.full_like(first, -1))[:, None]  # [B, 1]

    j = torch.arange(T + A, device=input_ids.device)[None, :]
    before = j <= p
    in_audio = (~before) & (j <= p + A)
    text_idx = torch.where(before, j, j - A).clamp(0, T - 1)
    audio_idx = (j - p - 1).clamp(0, A - 1)

    gathered_text = torch.gather(text_embeds, 1, text_idx[..., None].expand(B, T + A, D))
    gathered_audio = torch.gather(
        audio_embeds.to(text_embeds.dtype), 1, audio_idx[..., None].expand(B, T + A, D)
    )
    embeds = torch.where(in_audio[..., None], gathered_audio, gathered_text)
    text_mask = torch.gather(attention_mask, 1, text_idx)
    mask = torch.where(in_audio, torch.ones_like(text_mask), text_mask)
    out_labels = None
    if labels is not None:
        text_labels = torch.gather(labels, 1, text_idx)
        out_labels = torch.where(in_audio, torch.full_like(text_labels, IGNORE_INDEX),
                                 text_labels)
    return embeds, mask, out_labels


def extend_labels(labels: torch.Tensor, audio_block_len: int) -> torch.Tensor:
    """Prepend -100 over the audio block ('prepend' splice)."""
    pad = torch.full((labels.shape[0], audio_block_len), IGNORE_INDEX, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([pad, labels], dim=1)


def forward(
    frozen: ParamTree,
    trainable: ParamTree,
    cfg: AudioLLMConfig,
    batch: AudioLLMBatch,
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
    loss_chunk_size: int = 0,
    remat: bool = False,
):
    """Full multimodal forward -> (loss, logits [B, T', V] f32 or None).
    Without audio it is the text-only LM step; `loss_chunk_size` > 0 takes
    the chunked cross-entropy and returns no logits."""
    lora = trainable.get("lora")
    if lora is not None:
        lora = lora_mod.with_scaling(lora, cfg.lora)
    lcfg, lparams = cfg.llama, frozen["llama"]
    if batch.audio_features is None:
        kw = dict(input_ids=batch.input_ids, attention_mask=batch.attention_mask)
        labels = batch.labels
    else:
        enc = process_audio_features(frozen, cfg, batch.audio_features, compute_dtype)
        audio_embeds = proj_mod.project(trainable["projector"], enc, compute_dtype)
        if cfg.splice_mode == "inplace":
            text = llama_mod.embed_tokens(lparams, batch.input_ids, compute_dtype)
            embeds, mask, labels = splice_inplace(text, audio_embeds, batch.input_ids,
                                                  batch.attention_mask, batch.labels,
                                                  audio_start_id)
        else:  # 'prepend'
            embeds, mask = combine_text_and_audio_embeddings(
                frozen, trainable, cfg, batch.input_ids, batch.attention_mask, audio_embeds,
                audio_start_id, audio_end_id, compute_dtype)
            labels = extend_labels(batch.labels, audio_embeds.shape[1] + 2)
        kw = dict(inputs_embeds=embeds, attention_mask=mask)
    if loss_chunk_size:
        _, _, hidden = llama_mod.llama_forward(lparams, lcfg, lora=lora,
                                               compute_dtype=compute_dtype, return_hidden=True,
                                               unembed_logits=False, remat=remat, **kw)
        loss = llama_mod.causal_lm_loss_from_hidden(lparams, lcfg, hidden, labels,
                                                    loss_chunk_size, compute_dtype)
        return loss, None
    logits, _ = llama_mod.llama_forward(lparams, lcfg, lora=lora, compute_dtype=compute_dtype,
                                        remat=remat, **kw)
    return llama_mod.causal_lm_loss(logits, labels), logits
