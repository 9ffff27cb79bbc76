"""Continuous-batching serving engine.

Counterpart of `audio_llama_tpu/inference/serving/engine.py::ServingEngine`:
a fixed pool of decode rows over ONE KV cache, requests admitted into free
rows as they arrive and retired on EOS or their budget.

- The pool is a static [rows, max_len] KV cache (`max_len` rounded by
  `KVCache.rounded_len`); admission, decode and retirement never change a
  tensor's shape.
- A prompt prefills into a fresh cache at a BUCKETED length (the smallest
  of `prefill_buckets` that holds its text), and that slab is written into
  the assigned pool row in place (`admission.py`). Up to `admit_batch`
  queued requests of one geometry share a prefill; `prefill_chunk_tokens`
  stages a prompt in pieces between decode chunks (`staging.py`); a
  registered prefix (`prefix.py`) is prefilled once and its suffixes are
  appended at the prefix's length.
- Decode advances ALL rows one token a step with per-row cache offsets
  (rows are left-aligned single streams: a row's RoPE position is its
  append offset, and slot causality needs no timeline mask), `chunk_steps`
  steps between host synchronisations (`decode.py`).
- Sampling has engine defaults and per-request overrides, per-row tensors
  of the chunk (`ops/sampling.py::sample_token_per_row`): greedy rows are
  exact argmax in any mix. Draws come from one `torch.Generator` seeded by
  `seed` and by `reset(seed)`.

Retired rows need no scrubbing: a new request overwrites slots [0, P) at
its splice and every append lands at its own offset, so a stale slot is
overwritten or outside slot causality before it can be attended.

The engine runs on `device` (the card unless the caller asks for the CPU),
where the weights must be. Not ported (ROADMAP queue 1): speculative pools
(`draft_params`) and the dp / tp pool (a mesh with dp or tp > 1) raise
NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...config import AudioLLMConfig
from ...device import DeviceLike, resolve_device
from ...models import llama as llama_mod
from ...models import lora as lora_mod
from .admission import AdmissionMixin
from .decode import DecodeMixin
from .prefix import PrefixMixin
from .staging import StagingMixin
from .state import _Pending, _Prefix, _Row, _Staging

NOT_PORTED = "is not ported yet (ROADMAP queue 1: speculative serving and the dp/tp pool)"


class ServingEngine(AdmissionMixin, StagingMixin, PrefixMixin, DecodeMixin):
    """Fixed-row continuous-batching decode pool over one KV cache; the
    arguments are JAX's (`rows`, `max_len`, `prefill_buckets`,
    `chunk_steps`, `kv_quant` False / 8 / 4, sampling defaults, token ids,
    `attn_impl`, `seed`, `auto_prefix`, `prefill_chunk_tokens`,
    `admit_batch`), plus `device`."""

    def __init__(
        self,
        frozen,
        trainable,
        cfg: AudioLLMConfig,
        *,
        rows: int = 8,
        max_len: int = 2048,
        prefill_buckets=(128, 256, 512, 1024),
        chunk_steps: int = 16,
        kv_quant=False,
        compute_dtype=torch.bfloat16,
        greedy: bool = True,
        temperature: float = 0.7,
        top_p: float = 0.9,
        top_k: int = 0,
        eos_id: int = 2,
        pad_id: int = 0,
        audio_start_id: int = 0,
        audio_end_id: int = 0,
        attn_impl: str = "auto",
        seed: int = 0,
        mesh=None,
        dp_axis: str = "dp",
        draft_params=None,
        draft_cfg=None,
        gamma: int = 4,
        auto_prefix: bool = False,
        prefill_chunk_tokens: Optional[int] = None,
        admit_batch: int = 1,
        device: DeviceLike = None,
    ):
        if draft_params is not None:
            raise NotImplementedError(f"speculative serving (draft_params) {NOT_PORTED}")
        if mesh is not None and any(n > 1 for n in mesh.shape.values()):
            raise NotImplementedError(f"the dp/tp serving pool (mesh {dict(mesh.shape)}) "
                                      f"{NOT_PORTED}")
        if admit_batch < 1:
            raise ValueError("admit_batch must be >= 1")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        del dp_axis, draft_cfg, gamma
        self.device = resolve_device(device)
        wdev = frozen["llama"]["embed"]["weight"].device
        if wdev.type != self.device.type:
            raise ValueError(f"weights are on {wdev}, the engine asked for {self.device}")
        self.frozen = frozen
        self.trainable = trainable
        self.cfg = cfg
        self.rows = rows
        self.buckets = tuple(sorted(prefill_buckets))
        self.chunk_steps = chunk_steps
        self.kv_quant = kv_quant
        self.compute_dtype = compute_dtype
        self.greedy = greedy
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.audio_start_id = audio_start_id
        self.audio_end_id = audio_end_id
        self.attn_impl = attn_impl
        self.auto_prefix = auto_prefix
        self.admit_batch = admit_batch
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.draft_params = None  # speculative pools are not ported
        self._lora = None
        if trainable is not None and "lora" in trainable and cfg.lora is not None:
            self._lora = lora_mod.with_scaling(trainable["lora"], cfg.lora)
        self.max_len = llama_mod.KVCache.rounded_len(max_len)
        self._audio_block_lens: Dict[tuple, int] = {}
        self._prefixes: Dict[int, _Prefix] = {}
        self._next_pid = 0
        self._next_rid = 0
        self.prefix_admits = 0  # lifetime prefix-cached admissions
        self.admit_sizes: List[int] = []  # per-admission group sizes
        # telemetry: decode chunks run, each one's wall ms (chunk and its
        # harvest, which waits for the device), and per request the ms from
        # submit to the harvest that brought its first token
        self.decode_chunks = 0
        self.chunk_ms: List[float] = []
        self.ttft_ms: Dict[int, float] = {}
        self._submitted_at: Dict[int, float] = {}
        self.reset(seed)

    def _zero_state(self) -> dict:
        """Fresh pool state on the device: the cache and per-row offsets (also
        the RoPE positions), last tokens, active flags, remaining budgets and
        sampling parameters."""
        R, dev = self.rows, self.device
        cache = llama_mod.KVCache.zeros(self.cfg.llama, R, self.max_len,
                                        dtype=self.compute_dtype, device=dev,
                                        quantized=self.kv_quant)
        return {
            "cache": cache,
            "offsets": torch.zeros((R,), dtype=torch.int32, device=dev),
            "last_tok": torch.full((R,), self.pad_id, dtype=torch.int32, device=dev),
            "active": torch.zeros((R,), dtype=torch.bool, device=dev),
            "remaining": torch.zeros((R,), dtype=torch.int32, device=dev),
            "samp": {
                "temperature": torch.full((R,), self.temperature, dtype=torch.float32,
                                          device=dev),
                "top_p": torch.full((R,), self.top_p, dtype=torch.float32, device=dev),
                "top_k": torch.full((R,), self.top_k, dtype=torch.int32, device=dev),
                "greedy": torch.full((R,), self.greedy, dtype=torch.bool, device=dev),
            },
        }

    def reset(self, seed: int = 0):
        """Clear the pool state and host bookkeeping (registered prefixes
        stay) and reseed the sampling generator."""
        self._state = None  # free the old pool before the new one is made
        self._state = self._zero_state()
        self._rows: List[_Row] = [_Row() for _ in range(self.rows)]
        self._queue: List[_Pending] = []
        self._results: Dict[int, List[int]] = {}
        self._staging_rows: Dict[int, _Staging] = {}
        self._staging_rr = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def submit(self, input_ids, audio_features=None, max_new_tokens: int = 64,
               prefix: Optional[int] = None, temperature: Optional[float] = None,
               top_p: Optional[float] = None, top_k: Optional[int] = None,
               greedy: Optional[bool] = None) -> int:
        """Queue a request; returns its id. Tokens come back from run() as
        rid -> generated ids (EOS included if hit). `prefix`: a
        register_prefix handle, input_ids then being the text suffix.
        temperature / top_p / top_k / greedy: per-request overrides of the
        engine defaults (greedy=False alone switches to the engine's
        stochastic defaults)."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if audio_features is not None and self.trainable is None:
            raise ValueError("audio request on a text-only engine")
        if prefix is not None:
            if prefix not in self._prefixes:
                raise ValueError(f"unknown prefix handle {prefix}")
            if audio_features is not None:
                raise ValueError("audio_features with prefix=: register the audio as part of "
                                 "the prefix instead")
        elif self.auto_prefix and audio_features is None:
            prefix, ids = self._match_prefix(ids)
        rid = self._next_rid
        self._next_rid += 1
        self._submitted_at[rid] = time.perf_counter()
        self._queue.append(_Pending(
            rid, ids, None if audio_features is None else np.asarray(audio_features),
            max_new_tokens, prefix=prefix,
            temperature=float(self.temperature if temperature is None else temperature),
            top_p=float(self.top_p if top_p is None else top_p),
            top_k=int(self.top_k if top_k is None else top_k),
            greedy=self.greedy if greedy is None else bool(greedy)))
        return rid

    def run(self, max_chunks: Optional[int] = None, progress=None) -> Dict[int, List[int]]:
        """Serve until the queue and the pool drain; returns every result.
        `max_chunks` raises instead of spinning; progress(chunk, live,
        queued) is called after each chunk."""
        n = 0
        while self._queue or any(not r.free for r in self._rows):
            if max_chunks is not None and n >= max_chunks:
                raise RuntimeError(
                    f"run() exceeded {max_chunks} chunks with {len(self._queue)} queued and "
                    f"{sum(not r.free for r in self._rows)} live rows")
            self.step_chunk()
            n += 1
            if progress is not None:
                progress(n, sum(not r.free for r in self._rows), len(self._queue))
        return dict(self._results)

    def step_chunk(self):
        """One scheduling round: admit into free rows, advance a chunked
        prefill by one piece, then decode one chunk and harvest it."""
        self._admit_pending()
        self._advance_staging()
        if not any(not r.free and not r.staging for r in self._rows):
            return
        t0 = time.perf_counter()
        self._harvest(*self._decode_chunk())
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
        self.decode_chunks += 1
        self._retire_rows()

    def _harvest(self, emit, fire):
        both = torch.stack([emit.to(torch.int32), fire.to(torch.int32)]).cpu().numpy()
        emit, fire = both[0], both[1]  # [K, R] each: the chunk's one host read
        now = time.perf_counter()
        for r, row in enumerate(self._rows):
            if row.free:
                continue
            if not row.emitted and fire[:, r].any():
                t0 = self._submitted_at.pop(row.rid, None)
                if t0 is not None:
                    self.ttft_ms[row.rid] = (now - t0) * 1e3
            for s in range(emit.shape[0]):
                if not fire[s, r]:
                    continue
                tok = int(emit[s, r])
                row.emitted.append(tok)
                if tok == self.eos_id or len(row.emitted) >= row.budget:
                    break

    def _retire_rows(self):
        for r, row in enumerate(self._rows):
            if row.free:
                continue
            if (row.emitted and row.emitted[-1] == self.eos_id) or (
                    len(row.emitted) >= row.budget):
                self._results[row.rid] = row.emitted
                self._rows[r] = _Row()
