"""Continuous-batching serving pool.

Counterpart of `audio_llama_tpu/inference/serving/`, split by concern as
there:
  engine.py    ServingEngine: lifecycle, submit / run / step_chunk, harvest
  admission.py bucketed and batched prefill, the prefix-suffix prefill, the
               splice into a pool row
  staging.py   chunked prefill (prefill_chunk_tokens)
  prefix.py    prefix KV caching (register / auto-match / evict)
  decode.py    the decode chunk
  state.py     host-side records and the slab moves
Speculative pools and the dp / tp pool (JAX's `sharding.py`) are not ported
(ROADMAP queue 1): the engine raises NotImplementedError for them.
"""

from .engine import ServingEngine

__all__ = ["ServingEngine"]
