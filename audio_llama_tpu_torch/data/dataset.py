"""Instruction-audio dataset: JSON entries -> fixed-shape training examples.

Counterpart of `audio_llama_tpu/data/dataset.py`, item for item: the
dataset_config key mapping is honored; audio is decoded, mixed to mono,
resampled, then cropped or zero-padded to `max_audio_seconds` (the port's
`data/audio_io.py`); waveforms go to the device, where the log-mel runs;
missing or undecodable audio becomes zeros with `use_dummy_audio_for_missing`.

Labels: `label_mode='concat'` (default) feeds prompt ++ response ++ eos and
labels the response only; `label_mode='reference'` reproduces the reference
trainer's independently tokenized prompt and response, the response ids
aligned to prompt positions. `audio_placeholder` puts '<audio></audio>' in
front of an audio prompt that has none (needed by the 'inplace' splice).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import audio_io
from .tokenizer import AUDIO_END_TOKEN, AUDIO_START_TOKEN

logger = logging.getLogger(__name__)


@dataclass
class DatasetConfig:
    """Key mapping + shape policy (reference src/dataloaders.py:51-57 defaults,
    produced by the corpus builder's dataset_config.json,
    reference src/get_librispeech.py:319-333)."""

    audio_key: str = "audio_paths"
    text_key: str = "text"
    response_key: str = "response"
    text_max_length: int = 512
    sample_rate: int = 16000
    max_audio_seconds: float = 30.0
    label_mode: str = "concat"  # 'concat' | 'reference'
    skip_missing_files: bool = False
    use_dummy_audio_for_missing: bool = False
    # Insert '<audio></audio>' at the front of prompts that have audio but no
    # placeholder yet. Required for splice_mode='inplace' to be usable
    # end-to-end: the in-place splice inserts the audio block after the first
    # <audio> token, so prompts must actually contain one (without it the
    # audio block lands at the front with no delimiters).
    audio_placeholder: bool = False

    @classmethod
    def from_json_file(cls, path: str) -> "DatasetConfig":
        with open(path) as f:
            d = json.load(f)
        kw = {}
        for k in ("audio_key", "text_key", "response_key"):
            if k in d:
                kw[k] = d[k]
        return cls(**kw)

    @property
    def max_samples(self) -> int:
        return int(self.max_audio_seconds * self.sample_rate)


class AudioLLMDataset:
    """Map-style dataset over instruction JSON entries.

    Each item: dict with
      input_ids [T] int32, attention_mask [T] int32, labels [T] int32,
      audio [S] f32 waveform or None (text-only entries), text, audio_path.
    """

    def __init__(
        self,
        entries: List[Dict[str, Any]],
        audio_dir: str,
        tokenizer,
        cfg: Optional[DatasetConfig] = None,
    ):
        self.cfg = cfg or DatasetConfig()
        self.audio_dir = audio_dir
        self.tokenizer = tokenizer
        if self.cfg.skip_missing_files:
            entries = self._filter_missing_files(entries)
        self.entries = entries

    # -- reference: _filter_missing_files, src/dataset.py:160-183 ------------
    def _resolve_audio_path(self, rel: str) -> Optional[str]:
        p = os.path.join(self.audio_dir, rel)
        if os.path.exists(p):
            return p
        # auto-fix 'audio/'-prefixed paths (reference src/dataset.py:171-176)
        if rel.startswith("audio/"):
            p2 = os.path.join(self.audio_dir, rel[len("audio/") :])
            if os.path.exists(p2):
                return p2
        else:
            p3 = os.path.join(self.audio_dir, "audio", rel)
            if os.path.exists(p3):
                return p3
        return None

    def _filter_missing_files(self, entries):
        kept = []
        for e in entries:
            rel = e.get(self.cfg.audio_key)
            if not rel:
                kept.append(e)  # text-only entries stay
                continue
            if self._resolve_audio_path(_first(rel)) is not None:
                kept.append(e)
        dropped = len(entries) - len(kept)
        if dropped:
            logger.warning("skip_missing_files: dropped %d entries", dropped)
        return kept

    def __len__(self) -> int:
        return len(self.entries)

    # -- audio: load -> mono -> resample -> crop/pad (fixed order) -----------
    def _process_audio(self, rel_path: str) -> Optional[np.ndarray]:
        path = self._resolve_audio_path(rel_path)
        if path is None:
            if self.cfg.use_dummy_audio_for_missing:
                return np.zeros(self.cfg.max_samples, np.float32)
            raise FileNotFoundError(f"audio file not found: {rel_path}")
        try:
            audio = audio_io.load_audio(path, target_sr=self.cfg.sample_rate)
        except Exception:
            if self.cfg.use_dummy_audio_for_missing:
                logger.warning("decode failed, using dummy audio: %s", path)
                return np.zeros(self.cfg.max_samples, np.float32)
            raise
        S = self.cfg.max_samples
        if len(audio) >= S:
            return audio[:S]
        out = np.zeros(S, np.float32)
        out[: len(audio)] = audio
        return out

    def _process_text(self, text: str, response: str):
        T = self.cfg.text_max_length
        if self.cfg.label_mode == "reference":
            ids, mask = self.tokenizer.encode(text, T, pad_to_max=True)
            resp_ids, resp_mask = self.tokenizer.encode(response, T, pad_to_max=True)
            labels = resp_ids.astype(np.int32).copy()
            labels[resp_mask == 0] = -100
            return ids, mask, labels
        # concat mode: prompt ++ response ++ eos, labels mask the prompt.
        p_ids, _ = self.tokenizer.encode(text, T, pad_to_max=False)
        r_ids, _ = self.tokenizer.encode(
            response, T, pad_to_max=False, add_bos=False, add_eos=True
        )
        ids = np.concatenate([p_ids, r_ids])[:T]
        n = len(ids)
        labels = np.full(T, -100, np.int32)
        resp_start = min(len(p_ids), T)
        labels[resp_start:n] = ids[resp_start:]
        full_ids = np.full(T, self.tokenizer.pad_id, np.int32)
        full_ids[:n] = ids
        mask = np.zeros(T, np.int32)
        mask[:n] = 1
        return full_ids, mask, labels

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        e = self.entries[idx]
        text = e.get(self.cfg.text_key, "") or ""
        response = e.get(self.cfg.response_key, "") or ""
        rel = e.get(self.cfg.audio_key)
        if self.cfg.audio_placeholder and rel and AUDIO_START_TOKEN not in text:
            text = f"{AUDIO_START_TOKEN}{AUDIO_END_TOKEN} {text}"
        ids, mask, labels = self._process_text(text, response)

        audio = None
        audio_path = None
        if rel:
            audio_path = _first(rel)
            try:
                audio = self._process_audio(audio_path)
            except FileNotFoundError:
                audio = None
        return {
            "input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "labels": labels.astype(np.int32),
            "audio": audio,
            "text": text,
            "audio_path": audio_path,
        }


def _first(v):
    """audio_paths may be a str or a list of paths (reference uses a str named
    'audio_paths'; accept both)."""
    if isinstance(v, (list, tuple)):
        return v[0] if v else None
    return v


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack items into a FIXED-SHAPE batch of len(items).

    Reference collate_fn (src/dataset.py:186-204) drops items whose audio
    failed — but ragged batch sizes break the static-shape contract (the
    micro-batches of one accumulation group are stacked). Here failed-audio
    items are replaced by a copy of a valid item with ALL labels set to
    -100, so shapes stay static and the filler contributes zero loss. A
    batch that is entirely text-only stays text-only (audio=None); an empty
    batch raises.
    """
    if not items:
        raise ValueError("empty batch")
    kept = [it for it in items if it["audio"] is not None]
    text_only = len(kept) == 0
    if text_only:
        rows = items
    else:
        rows = []
        for it in items:
            if it["audio"] is not None:
                rows.append(it)
            else:
                filler = dict(kept[0])
                filler["labels"] = np.full_like(kept[0]["labels"], -100)
                filler["metadata_dropped"] = it.get("audio_path")
                rows.append(filler)
    batch = {
        "input_ids": np.stack([it["input_ids"] for it in rows]),
        "attention_mask": np.stack([it["attention_mask"] for it in rows]),
        "labels": np.stack([it["labels"] for it in rows]),
        "audio": None if text_only else np.stack([it["audio"] for it in rows]),
        "metadata": [
            {"text": it["text"], "audio_path": it["audio_path"]} for it in rows
        ],
    }
    return batch
