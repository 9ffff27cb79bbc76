"""Word-error-rate evaluation.

Counterpart of `audio_llama_tpu/eval/wer.py`: batched greedy transcription
through the port's `inference.generate.generate`, scored against the
reference transcripts by word-level Levenshtein distance after Whisper-style
text normalization. Runs on the card unless the caller passes the CPU:

    python -m audio_llama_tpu_torch.eval.wer --device cuda --toy_model \\
        --tokenizer byte --data_path corpus/examples.json --audio_dir corpus/audio
    python -m audio_llama_tpu_torch.eval.wer --device cpu --toy_model ...

(`data/synth_speech.build_corpus` writes such a corpus.) `--int8_encoder`
evaluates with the W8A8 encoder, calibrated on the first clips.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import string
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("audio_llama_tpu_torch")

DEFAULT_PROMPT = "Please transcribe this audio."


def normalize_text(text: str) -> str:
    """Lowercase, strip punctuation, collapse whitespace (the usual
    preprocessing before WER on LibriSpeech)."""
    text = text.lower()
    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text).strip()


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Word-level Levenshtein distance, O(len(ref) * len(hyp)), two rows."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1,  # deletion
                         cur[j - 1] + 1,  # insertion
                         prev[j - 1] + (r != h))  # substitution
        prev = cur
    return prev[-1]


def word_error_rate(refs: Sequence[str], hyps: Sequence[str],
                    normalize: bool = True) -> Dict[str, float]:
    """Corpus-level WER: total edits over total reference words."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references but {len(hyps)} hypotheses")
    edits = words = 0
    for r, h in zip(refs, hyps):
        if normalize:
            r, h = normalize_text(r), normalize_text(h)
        rw, hw = r.split(), h.split()
        edits += edit_distance(rw, hw)
        words += len(rw)
    return {
        "wer": edits / max(words, 1),
        "total_edits": float(edits),
        "total_words": float(words),
        "num_utterances": float(len(refs)),
    }


def transcribe_batch(cfg, frozen, trainable, tokenizer, prompts: List[str], audio: np.ndarray,
                     max_new_tokens: int = 128, seed: int = 0, pad_to: Optional[int] = None,
                     kv_quant=False, device=None) -> List[str]:
    """Greedy batched decode of waveforms audio [B, S]; the prompts are
    right-padded to a shared length (at least pad_to, so every batch of a
    corpus has one shape, as JAX's does for one compiled program). Runs on
    `device` (the card unless the caller passes the CPU), where the trees
    are. Greedy decoding draws nothing: `seed` is JAX's signature's."""
    from ..inference import generate as gen

    del seed
    encs = [tokenizer.encode(p) for p in prompts]
    T = max(len(ids) for ids, _ in encs)
    if pad_to is not None:
        T = max(T, pad_to)
    ids = np.full((len(encs), T), tokenizer.pad_id, np.int32)
    mask = np.zeros((len(encs), T), np.int32)
    for i, (e, m) in enumerate(encs):
        ids[i, :len(e)] = e
        mask[i, :len(m)] = m
    result = gen.generate(
        frozen, trainable, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(np.asarray(audio, np.float32)), max_new_tokens=max_new_tokens,
        kv_quant=kv_quant, greedy=True, eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id,
        audio_start_id=tokenizer.token_to_id(cfg.audio_start_token),
        audio_end_id=tokenizer.token_to_id(cfg.audio_end_token), has_audio=True,
        device=device)
    tokens = result.tokens.cpu().numpy()
    counts = result.num_generated.cpu().numpy()
    return [tokenizer.decode(tokens[i, :counts[i]], skip_special_tokens=True)
            for i in range(len(encs))]


def _prompt(entry: dict, prompt_override: Optional[str], text_key: str) -> str:
    return prompt_override or entry.get(text_key) or DEFAULT_PROMPT


def evaluate_wer(cfg, frozen, trainable, tokenizer, entries: List[dict], audio_dir: str,
                 batch_size: int = 8, max_new_tokens: int = 128,
                 prompt_override: Optional[str] = None, audio_key: str = "audio_paths",
                 text_key: str = "text", response_key: str = "response", kv_quant=False,
                 device=None) -> Dict[str, float]:
    """Transcribe every entry in batches of one shape and score corpus WER.
    The last, ragged batch is padded by repeating its last entry; the extra
    rows are dropped before scoring."""
    from ..inference.cli import process_audio

    refs: List[str] = []
    hyps: List[str] = []
    n = len(entries)
    pad_to = max((len(tokenizer.encode(_prompt(e, prompt_override, text_key))[0])
                  for e in entries), default=8)
    for lo in range(0, n, batch_size):
        chunk = entries[lo:lo + batch_size]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch_size - real)
        prompts = [_prompt(e, prompt_override, text_key) for e in chunk]
        audio = np.concatenate([process_audio(_resolve(audio_dir, e[audio_key]), cfg.mel)
                                for e in chunk], axis=0)
        texts = transcribe_batch(cfg, frozen, trainable, tokenizer, prompts, audio,
                                 max_new_tokens, pad_to=pad_to, kv_quant=kv_quant,
                                 device=device)
        refs.extend(e[response_key] for e in chunk[:real])
        hyps.extend(texts[:real])
        logger.info("transcribed %d/%d", min(lo + batch_size, n), n)
    return word_error_rate(refs, hyps)


def calib_mel_batch(cfg, entries: List[dict], audio_dir: str, n: int = 4,
                    audio_key: str = "audio_paths", device=None) -> torch.Tensor:
    """A representative log-mel batch [n, n_mels, frames] for the W8A8
    encoder's SmoothQuant calibration (`models/whisper_int8.py`
    `quantize_encoder_smoothed`): the first n clips through the inference
    CLI's `process_audio` and `ops/mel.py`, on `device` (the card unless the
    caller passes the CPU)."""
    from ..device import resolve_device
    from ..inference.cli import process_audio
    from ..ops import mel as mel_ops

    audio = np.concatenate([process_audio(_resolve(audio_dir, e[audio_key]), cfg.mel)
                            for e in entries[:max(n, 1)]], axis=0)
    return mel_ops.log_mel(torch.from_numpy(audio).to(resolve_device(device)), cfg.mel)


def _resolve(audio_dir: str, rel) -> str:
    """An entry's audio path: under audio_dir, or under audio_dir/audio."""
    if isinstance(rel, (list, tuple)):
        rel = rel[0]
    p = os.path.join(audio_dir, rel)
    if os.path.exists(p):
        return p
    alt = os.path.join(audio_dir, "audio", rel)
    return alt if os.path.exists(alt) else p


def main(argv=None):
    p = argparse.ArgumentParser(description="WER evaluation (PyTorch/CUDA port)")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--llama_path", type=str, default=None)
    p.add_argument("--whisper_path", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--audio_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--prompt", type=str, default=None,
                   help="override per-entry instruction text")
    p.add_argument("--toy_model", action="store_true")
    p.add_argument("--int8_encoder", action="store_true",
                   help="evaluate with the W8A8 encoder, calibrated on the first clips")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the host (as --device cpu)")
    p.add_argument("--device", type=str, default=None,
                   help="the device to run on: the CUDA card by default, or 'cpu'")
    p.add_argument("--output", type=str, default=None, help="write metrics JSON here")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..inference.cli import load_audio_llm

    device = args.device or ("cpu" if args.platform == "cpu" else None)
    cfg, frozen, trainable, tk = load_audio_llm(
        args.checkpoint_path, llama_path=args.llama_path, whisper_path=args.whisper_path,
        tokenizer=args.tokenizer, toy_model=args.toy_model, device=device)
    with open(args.data_path) as f:
        entries = json.load(f)
    if isinstance(entries, dict) and "examples" in entries:
        entries = entries["examples"]
    if args.limit:
        entries = entries[:args.limit]
    if args.int8_encoder:
        from ..bridge import ParamTree
        from ..models import whisper_int8 as w8

        frozen = ParamTree(dict(frozen.items()))
        frozen["whisper"] = w8.quantize_encoder_smoothed(
            frozen["whisper"], cfg.whisper,
            calib_mel_batch(cfg, entries, args.audio_dir, device=device))
    metrics = evaluate_wer(cfg, frozen, trainable, tk, entries, args.audio_dir,
                           batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
                           prompt_override=args.prompt, device=device)
    print(json.dumps(metrics))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
