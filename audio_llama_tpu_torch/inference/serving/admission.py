"""Admission: bucket selection, the one-shot and batched prefills, the
prefix-suffix prefill and the splice into a pool row.

Counterpart of `audio_llama_tpu/inference/serving/admission.py`. Where JAX
runs a prefill program and then a donated splice program, the port runs
the prefill into a fresh cache and writes that slab into the pool row's
slots in place (`state.splice_row`). Chunked (staged) prefill lives in
`staging.py`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...models import llama as llama_mod
from ...ops import sampling
from ..generate import build_prefix
from .state import _Pending, _Row, preloaded, row_slab, samp_arrays, splice_row


class AdmissionMixin:
    @staticmethod
    def _combined_len(n_text: int, block_len: Optional[int]) -> int:
        """Prompt timeline length: text tokens plus the audio embedding block
        (None for text-only requests)."""
        return n_text if block_len is None else n_text + block_len

    def _resolve_audio_len(self, feat_shape) -> int:
        """Audio embedding block length (encoder frames and delimiters), cached
        per feature shape (N 30 s windows give N-dependent lengths). JAX reads
        it off `eval_shape`; here one prefix of a zero clip and one text
        token is built once per shape."""
        key = tuple(feat_shape)
        if key not in self._audio_block_lens:
            ids = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
            feats = torch.zeros((1,) + key, dtype=torch.float32, device=self.device)
            with torch.no_grad():
                e, _ = build_prefix(self.frozen, self.trainable, self.cfg, ids,
                                    torch.ones_like(ids, dtype=torch.int32), feats,
                                    self.audio_start_id, self.audio_end_id, self.compute_dtype)
            self._audio_block_lens[key] = e.shape[1] - 1
        return self._audio_block_lens[key]

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest prefill bucket "
                         f"{self.buckets[-1]}")

    def _admit_pending(self):
        free = [r for r, row in enumerate(self._rows) if row.free]
        while free and self._queue:
            req = self._queue[0]
            if req.prefix is not None:
                pfx = self._prefixes.get(req.prefix)
                if pfx is None:  # unregistered while queued: reject
                    self._reject(self._queue.pop(0))
                    continue
                comb = pfx.length + len(req.input_ids)
            else:
                has_audio = req.audio_features is not None
                blk = self._resolve_audio_len(req.audio_features.shape) if has_audio else None
                comb = self._combined_len(len(req.input_ids), blk)
            try:
                # bucket over the TEXT length; audio (or a registered prefix
                # slab) is a fixed-size timeline prefix. The bucketed prefill
                # timeline must fit the pool (its rows splice in whole)
                # beside the generation budget.
                tb = self._pick_bucket(len(req.input_ids))
                c = self.prefill_chunk_tokens
                if req.prefix is not None:
                    sb = tb if c is None else -(-tb // c) * c  # staged suffixes: whole pieces
                    comb_b = llama_mod.KVCache.rounded_len(pfx.cap + sb)
                else:
                    cb = self._combined_len(tb, blk)
                    if c is not None:  # staging pads to whole pieces
                        cb = -(-cb // c) * c
                    comb_b = llama_mod.KVCache.rounded_len(cb)
                if comb + req.max_new_tokens > self.max_len or comb_b > self.max_len:
                    raise ValueError("request does not fit the pool")
            except ValueError:
                self._reject(self._queue.pop(0))  # cannot fit
                continue
            r = free.pop(0)
            self._queue.pop(0)
            if self.admit_batch > 1 and req.prefix is None and self.prefill_chunk_tokens is None:
                # batched admission: the consecutive run of queued requests
                # sharing this one's prefill geometry (bucket and audio shape,
                # no prefix, fits the pool) through one B > 1 prefill
                group = [(r, req)]
                while free and self._queue and len(group) < self.admit_batch:
                    nxt = self._queue[0]
                    if nxt.prefix is not None:
                        break
                    if (nxt.audio_features is None) != (req.audio_features is None):
                        break
                    if (nxt.audio_features is not None
                            and nxt.audio_features.shape != req.audio_features.shape):
                        break
                    nblk = (self._resolve_audio_len(nxt.audio_features.shape)
                            if nxt.audio_features is not None else None)
                    ncomb = self._combined_len(len(nxt.input_ids), nblk)
                    try:
                        if self._pick_bucket(len(nxt.input_ids)) != tb:
                            break
                    except ValueError:
                        break
                    if ncomb + nxt.max_new_tokens > self.max_len:
                        break
                    group.append((free.pop(0), self._queue.pop(0)))
                # round down to a power of two, as JAX does (its group sizes
                # are program shapes)
                keep = 1 << (len(group).bit_length() - 1)
                while len(group) > keep:
                    r2, q2 = group.pop()
                    free.insert(0, r2)
                    self._queue.insert(0, q2)
                if len(group) > 1:
                    self._admit_batch(group, tb)
                    continue
            self._admit(r, req, tb)

    def _reject(self, req: _Pending):
        self._results[req.rid] = []
        self._submitted_at.pop(req.rid, None)

    def _padded(self, reqs, bucket: int):
        """Right-padded ids [B, bucket] int64 and mask int32 on the device."""
        ids = np.full((len(reqs), bucket), self.pad_id, np.int64)
        mask = np.zeros((len(reqs), bucket), np.int32)
        for b, req in enumerate(reqs):
            n = len(req.input_ids)
            ids[b, :n] = req.input_ids
            mask[b, :n] = 1
        return (torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))

    def _feats(self, reqs):
        if reqs[0].audio_features is None:
            return None
        return torch.from_numpy(np.stack([np.asarray(r.audio_features, np.float32)
                                          for r in reqs])).to(self.device)

    def _sample_first(self, hidden, last, samp):
        """Unembed hidden[b, last[b]] and sample each row's first token."""
        D = hidden.shape[-1]
        h = torch.gather(hidden, 1, last.long()[:, None, None].expand(-1, 1, D))
        logits = llama_mod.unembed(self.frozen["llama"], self.cfg.llama, h,
                                   self.compute_dtype)[:, 0]
        return sampling.sample_token_per_row(
            logits, self._gen, samp["temperature"], samp["top_p"], samp["top_k"],
            samp["greedy"])

    @torch.no_grad()
    def _prefill(self, reqs, bucket: int):
        """Bucketed prefill of len(reqs) same-geometry prompts into one fresh
        cache, and each row's first token -> (fresh [L, Ba, ...], real [Ba],
        tok0 [Ba]), all on the device."""
        ids, mask = self._padded(reqs, bucket)
        cdt = self.compute_dtype
        embeds, emask = build_prefix(self.frozen, self.trainable, self.cfg, ids, mask,
                                     self._feats(reqs), self.audio_start_id,
                                     self.audio_end_id, cdt)
        Ba, P = embeds.shape[:2]
        fresh = llama_mod.KVCache.zeros(self.cfg.llama, Ba, P, dtype=cdt, device=self.device,
                                        quantized=self.kv_quant)
        _, fresh, hidden = llama_mod.llama_forward(
            self.frozen["llama"], self.cfg.llama, inputs_embeds=embeds,
            attention_mask=emask.to(torch.int32), kv_cache=fresh, lora=self._lora,
            compute_dtype=cdt, assume_fresh_cache=True, return_hidden=True,
            unembed_logits=False)
        real = emask.sum(dim=1).to(torch.int32)
        tok0 = self._sample_first(hidden, real - 1, samp_arrays(reqs, self.device))
        return fresh, real, tok0

    @torch.no_grad()
    def _suffix_prefill(self, pfx, req, bucket: int):
        """Prefix-cached admission: embed only the text suffix and append it at
        cache_offsets = prefix length into a fresh cache preloaded with the
        registered prefix slab (llama_forward's cached arm); the prefix's
        encode and prefill never run again -> (fresh, real, tok0)."""
        ids, mask = self._padded([req], bucket)
        cdt = self.compute_dtype
        embeds = llama_mod.embed_tokens(self.frozen["llama"], ids, cdt)
        fresh = llama_mod.KVCache.zeros(self.cfg.llama, 1, pfx.cap + bucket, dtype=cdt,
                                        device=self.device, quantized=self.kv_quant)
        fresh = preloaded(fresh, pfx.cache)
        n = mask.sum(dim=1).to(torch.int32)  # [1]
        Tk = fresh.k.shape[3]
        am = (torch.arange(Tk, device=self.device)[None, :] < pfx.length + n[:, None])
        off = torch.full((1,), pfx.length, dtype=torch.int32, device=self.device)
        _, fresh, hidden = llama_mod.llama_forward(
            self.frozen["llama"], self.cfg.llama, inputs_embeds=embeds,
            attention_mask=am.to(torch.int32), kv_cache=fresh, cache_offsets=off,
            lora=self._lora, compute_dtype=cdt, return_hidden=True, unembed_logits=False)
        tok0 = self._sample_first(hidden, n - 1, samp_arrays([req], self.device))
        return fresh, pfx.length + n, tok0

    def _admit(self, r: int, req: _Pending, bucket: int):
        if self.prefill_chunk_tokens is not None:
            # chunked prefill: reserve the row, fill it across rounds
            self._stage_admission(r, req, bucket)
            return
        if req.prefix is not None:
            fresh, real, tok0 = self._suffix_prefill(self._prefixes[req.prefix], req, bucket)
            self.prefix_admits += 1
        else:
            fresh, real, tok0 = self._prefill([req], bucket)
        self.admit_sizes.append(1)
        self._insert(fresh, real[0], tok0[0], r, req)

    def _admit_batch(self, group, bucket: int):
        """len(group) same-geometry requests through one batched prefill, then
        each row of the fresh cache spliced into its pool row."""
        reqs = [q for _, q in group]
        fresh, real, tok0 = self._prefill(reqs, bucket)
        self.admit_sizes.append(len(group))
        for b, (r, req) in enumerate(group):
            self._insert(row_slab(fresh, b), real[b], tok0[b], r, req)

    def _insert(self, fresh, real, tok0, r: int, req: _Pending):
        """The splice: the fresh slab into pool row r, and the row's offset,
        first token, budget and sampling parameters (device writes, in
        place)."""
        st = self._state
        splice_row(st["cache"], fresh, r)
        st["offsets"][r] = real
        st["last_tok"][r] = tok0
        st["active"][r] = True
        st["remaining"][r] = req.max_new_tokens - 1
        samp = st["samp"]
        samp["temperature"][r] = req.temperature
        samp["top_p"][r] = req.top_p
        samp["top_k"][r] = req.top_k
        samp["greedy"][r] = req.greedy
        self._rows[r] = _Row(rid=req.rid, budget=req.max_new_tokens, emitted=[], free=False)
