"""Tokenizers: a deterministic byte-level one, and Hugging Face's.

Counterpart of `audio_llama_tpu/data/tokenizer.py`: the same interface and
ids, with `<audio>` / `</audio>` added as special tokens and pad := eos
where a Hugging Face tokenizer has no pad. `transformers` is imported only
when an HF tokenizer is loaded.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

AUDIO_START_TOKEN = "<audio>"
AUDIO_END_TOKEN = "</audio>"


class ByteTokenizer:
    """ids: 0 = pad, 1 = bos, 2 = eos, 3..258 = bytes, then special tokens."""

    def __init__(self):
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self._byte_offset = 3
        self._special: dict[str, int] = {}
        self.add_special_tokens([AUDIO_START_TOKEN, AUDIO_END_TOKEN])

    @property
    def vocab_size(self) -> int:
        return self._byte_offset + 256 + len(self._special)

    def add_special_tokens(self, tokens: List[str]) -> int:
        added = 0
        for t in tokens:
            if t not in self._special:
                self._special[t] = self._byte_offset + 256 + len(self._special)
                added += 1
        return added

    def token_to_id(self, token: str) -> int:
        return self._special[token]

    def encode(self, text: str, max_length: Optional[int] = None, pad_to_max: bool = False,
               add_bos: bool = True, add_eos: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            tok = next((t for t in self._special if text.startswith(t, i)), None)
            if tok is not None:
                ids.append(self._special[tok])
                i += len(tok)
            else:
                ids.extend(b + self._byte_offset for b in text[i].encode("utf-8"))
                i += 1
        if add_eos:
            ids.append(self.eos_id)
        if max_length is not None:
            ids = ids[:max_length]
        n = len(ids)
        if pad_to_max and max_length is not None:
            ids = ids + [self.pad_id] * (max_length - n)
        mask = np.zeros(len(ids), np.int32)
        mask[:n] = 1
        return np.asarray(ids, np.int32), mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        inv_special = {v: k for k, v in self._special.items()}
        out_bytes = bytearray()
        parts: List[str] = []
        for tid in np.asarray(ids).tolist():
            if tid in (self.pad_id, self.bos_id, self.eos_id):
                continue
            if tid in inv_special:
                if out_bytes:
                    parts.append(out_bytes.decode("utf-8", errors="replace"))
                    out_bytes = bytearray()
                if not skip_special_tokens:
                    parts.append(inv_special[tid])
                continue
            b = tid - self._byte_offset
            if 0 <= b < 256:
                out_bytes.append(b)
        if out_bytes:
            parts.append(out_bytes.decode("utf-8", errors="replace"))
        return "".join(parts)


class HFTokenizer:
    """A local Hugging Face tokenizer behind the ByteTokenizer interface."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path)
        if self.tk.pad_token is None:
            self.tk.pad_token = self.tk.eos_token
        self.added = self.add_special_tokens([AUDIO_START_TOKEN, AUDIO_END_TOKEN])
        self.pad_id = self.tk.pad_token_id
        self.bos_id = self.tk.bos_token_id
        self.eos_id = self.tk.eos_token_id

    @property
    def vocab_size(self) -> int:
        return len(self.tk)

    def add_special_tokens(self, tokens: List[str]) -> int:
        existing = set(self.tk.get_vocab().keys())
        new = [t for t in tokens if t not in existing]
        if new:
            self.tk.add_special_tokens({"additional_special_tokens": new})
        return len(new)

    def token_to_id(self, token: str) -> int:
        return self.tk.convert_tokens_to_ids(token)

    def encode(self, text, max_length=None, pad_to_max=False, add_bos=True, add_eos=False):
        enc = self.tk(text, max_length=max_length,
                      padding="max_length" if (pad_to_max and max_length) else False,
                      truncation=max_length is not None, add_special_tokens=add_bos,
                      return_tensors="np")
        ids = enc["input_ids"][0].astype(np.int32)
        mask = enc["attention_mask"][0].astype(np.int32)
        if add_eos:
            n = int(mask.sum())
            if n < len(ids):  # padded: eos in the first pad slot
                ids[n] = self.eos_id
                mask[n] = 1
            elif max_length is None or len(ids) < max_length:  # room left: append
                ids = np.concatenate([ids, [self.eos_id]]).astype(np.int32)
                mask = np.concatenate([mask, [1]]).astype(np.int32)
            else:  # truncated at max_length: the last token gives way
                ids[-1] = self.eos_id
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).tolist() if int(i) != self.pad_id]
        return self.tk.decode(ids, skip_special_tokens=skip_special_tokens)


def load_tokenizer(path_or_kind: str):
    """'byte' -> ByteTokenizer; anything else is a local HF tokenizer path."""
    if path_or_kind == "byte":
        return ByteTokenizer()
    return HFTokenizer(path_or_kind)
