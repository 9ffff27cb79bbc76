"""The decode chunk: `chunk_steps` steps of every pool row between two host
synchronisations.

Counterpart of `audio_llama_tpu/inference/serving/decode.py::_decode_chunk`.
JAX runs the steps as one `lax.scan` program; here they are a Python loop
whose state stays on the device (offsets, last tokens, active flags,
remaining budgets): no step reads a value back, and the chunk's emitted
tokens and fire flags come to the host in ONE copy when they are harvested.
Each step is one `llama_forward` at T = 1 with the rows' offset vector as
`cache_offsets` and as the RoPE positions: on the card the mono decode
kernels (`ops/decode_attention_mono.py`, which take a [B] offset vector),
with the megakernel off (it takes one offset). The speculative chunk is not
ported (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from ...models import llama as llama_mod
from ...ops import sampling


class DecodeMixin:
    @torch.no_grad()
    def _decode_chunk(self):
        """-> (emit [K, R] int32, fire [K, R] bool) on the device. The first
        token emitted for a just-admitted row is its prefill-sampled one; a
        row retires after EOS or its budget (the emit and retire rule of the
        JAX chunk)."""
        st = self._state
        samp = st["samp"]
        cache = st["cache"]
        offsets, last_tok = st["offsets"], st["last_tok"]
        active, remaining = st["active"], st["remaining"]
        pad = torch.full_like(last_tok, self.pad_id)
        emits, fires = [], []
        for _ in range(self.chunk_steps):
            emit = torch.where(active, last_tok, pad)
            emits.append(emit)
            fires.append(active)
            logits, cache = llama_mod.llama_forward(
                self.frozen["llama"], self.cfg.llama, input_ids=last_tok[:, None],
                positions=offsets[:, None], kv_cache=cache, cache_offsets=offsets,
                lora=self._lora, compute_dtype=self.compute_dtype, attn_impl=self.attn_impl)
            tok = sampling.sample_token_per_row(
                logits[:, 0], self._gen, samp["temperature"], samp["top_p"], samp["top_k"],
                samp["greedy"])
            done = (emit == self.eos_id) | (remaining <= 0)
            nxt_active = active & ~done
            offsets = torch.where(active, offsets + 1, offsets)
            remaining = torch.where(nxt_active, remaining - 1, remaining)
            last_tok = torch.where(nxt_active, tok, last_tok)
            active = nxt_active
        st.update(cache=cache, offsets=offsets, last_tok=last_tok, active=active,
                  remaining=remaining)
        return torch.stack(emits), torch.stack(fires)

    def _decode_chunk_spec(self):
        raise NotImplementedError(
            "speculative serving (draft-and-verify chunks) is not ported yet "
            "(ROADMAP queue 1: speculative serving and the dp/tp pool)")
