"""Prefix KV caching: register a shared prompt prefix once, admit suffixes
against the stored slab (auto-match and eviction included).

Counterpart of `audio_llama_tpu/inference/serving/prefix.py` without the
draft model's slab (speculative pools are not ported: ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np

from ...models import llama as llama_mod
from .state import _Pending, _Prefix, row_slab


class PrefixMixin:
    def register_prefix(self, input_ids, audio_features=None) -> int:
        """Register a shared prompt prefix (an instruction template, or one
        audio clip with its instruction) and return its handle. Its KV is
        computed once here; every later submit(prefix=handle) prefills only
        its text suffix against the stored slab. Prefix slabs outlive
        reset()."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("prefix prompt is empty")
        has_audio = audio_features is not None
        if has_audio and self.trainable is None:
            raise ValueError("audio prefix on a text-only engine")
        feats = np.asarray(audio_features, np.float32) if has_audio else None
        blk = self._resolve_audio_len(feats.shape) if has_audio else None
        tb = self._pick_bucket(len(ids))
        if llama_mod.KVCache.rounded_len(self._combined_len(tb, blk)) > self.max_len:
            raise ValueError("prefix does not fit the pool timeline")
        # the engine's default sampling (the first token is discarded)
        req = _Pending(-1, ids, feats, 1, temperature=self.temperature, top_p=self.top_p,
                       top_k=self.top_k, greedy=self.greedy)
        fresh, real, _ = self._prefill([req], tb)
        length = int(real[0])
        # trim the slab to the real prefix (tile-rounded): a short prefix
        # registered through a large bucket must not carry the bucket's slots
        # into every admission splice
        cap = llama_mod.KVCache.rounded_len(length)
        pfx = _Prefix(cache=row_slab(fresh, 0, cap), length=length, cap=cap,
                      ids=tuple(int(t) for t in ids), has_audio=has_audio)
        del fresh
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = pfx
        return pid

    def unregister_prefix(self, handle: int):
        """Drop a registered prefix; requests queued against it are rejected
        at admission, new submit(prefix=handle) calls raise."""
        del self._prefixes[handle]

    def _match_prefix(self, ids: np.ndarray):
        """auto_prefix: split a text prompt on the LONGEST registered text-only
        prefix matching its head (at least one suffix token must remain) ->
        (pid or None, suffix ids)."""
        best, blen = None, 0
        for pid, p in self._prefixes.items():
            n = len(p.ids)
            if (not p.has_audio and n > blen and n < ids.size
                    and tuple(int(t) for t in ids[:n]) == p.ids):
                best, blen = pid, n
        return best, (ids[blen:] if best is not None else ids)
