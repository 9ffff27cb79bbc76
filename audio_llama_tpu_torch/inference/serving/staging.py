"""Chunked prefill (prefill_chunk_tokens): an admission fills a staging
cache piece by piece between decode chunks, bounding the decode stall any
admission causes. Prefix-cached suffixes stage too: their pieces append at
base = prefix length into a slab preloaded with the prefix KV.

Counterpart of `audio_llama_tpu/inference/serving/staging.py` without its
speculative (draft) halves.
"""

from __future__ import annotations

import torch

from ...models import llama as llama_mod
from ..generate import build_prefix
from .state import _Pending, _Row, _Staging, preloaded, samp_arrays


class StagingMixin:
    @torch.no_grad()
    def _staged_embeds(self, req: _Pending, bucket: int, feats):
        """The combined prompt embeds, computed once (the audio encode
        included), padded to a whole number of pieces: pad rows land past the
        final offset and are never attended."""
        ids, mask = self._padded([req], bucket)
        e, m = build_prefix(self.frozen, self.trainable, self.cfg, ids, mask, feats,
                            self.audio_start_id, self.audio_end_id, self.compute_dtype)
        c = self.prefill_chunk_tokens
        pad = -(-e.shape[1] // c) * c - e.shape[1]
        if pad:
            e = torch.nn.functional.pad(e, (0, 0, 0, pad))
            m = torch.nn.functional.pad(m, (0, pad))
        return e, m.to(torch.int32)

    def _stage_admission(self, r: int, req: _Pending, bucket: int):
        """Reserve row r and start a chunked prefill; `_advance_staging`
        appends the pieces across scheduling rounds."""
        cdt, dev = self.compute_dtype, self.device
        n = len(req.input_ids)
        if req.prefix is not None:
            pfx = self._prefixes[req.prefix]
            embeds, emask = self._staged_embeds(req, bucket, None)
            cache = llama_mod.KVCache.zeros(self.cfg.llama, 1, pfx.cap + embeds.shape[1],
                                            dtype=cdt, device=dev, quantized=self.kv_quant)
            st = _Staging(req=req, cache=preloaded(cache, pfx.cache), embeds=embeds,
                          emask=emask, total=n, base=pfx.length)
            self.prefix_admits += 1
        else:
            has_audio = req.audio_features is not None
            blk = self._resolve_audio_len(req.audio_features.shape) if has_audio else None
            embeds, emask = self._staged_embeds(req, bucket, self._feats([req]))
            cache = llama_mod.KVCache.zeros(self.cfg.llama, 1, embeds.shape[1], dtype=cdt,
                                            device=dev, quantized=self.kv_quant)
            st = _Staging(req=req, cache=cache, embeds=embeds, emask=emask,
                          total=self._combined_len(n, blk))
        self._staging_rows[r] = st
        self._rows[r] = _Row(rid=req.rid, budget=req.max_new_tokens, emitted=[], free=False,
                             staging=True)

    @torch.no_grad()
    def _piece(self, st: _Staging):
        """One prefill piece: embeds[:, i c:(i + 1) c) appended at
        cache_offsets = base + i c, and a candidate first token sampled at
        the piece's last real position (the final piece's is the
        admission's)."""
        c = self.prefill_chunk_tokens
        eoff = st.written
        off = st.base + eoff
        e = st.embeds[:, eoff:eoff + c]
        n_i = st.emask[:, eoff:eoff + c].sum(dim=1).to(torch.int32)  # [1]
        Tk = st.cache.k.shape[3]
        am = torch.arange(Tk, device=self.device)[None, :] < off + n_i[:, None]
        offs = torch.full((1,), off, dtype=torch.int32, device=self.device)
        _, st.cache, hidden = llama_mod.llama_forward(
            self.frozen["llama"], self.cfg.llama, inputs_embeds=e,
            attention_mask=am.to(torch.int32), kv_cache=st.cache, cache_offsets=offs,
            lora=self._lora, compute_dtype=self.compute_dtype, return_hidden=True,
            unembed_logits=False)
        st.tok0 = self._sample_first(hidden, (n_i - 1).clamp(min=0),
                                     samp_arrays([st.req], self.device))

    def _advance_staging(self):
        """Advance the chunked prefills by ONE piece this round (the stall
        bound), staged rows taking turns; a finished staging splices into its
        pool row and decodes from the next chunk."""
        if not self._staging_rows:
            return
        order = sorted(self._staging_rows)
        r = min((x for x in order if x >= self._staging_rr), default=order[0])
        self._staging_rr = r + 1
        st = self._staging_rows[r]
        self._piece(st)
        st.written += self.prefill_chunk_tokens
        if st.written >= st.total:
            real = torch.tensor(st.base + st.total, dtype=torch.int32, device=self.device)
            self._insert(st.cache, real, st.tok0[0], r, st.req)
            del self._staging_rows[r]
