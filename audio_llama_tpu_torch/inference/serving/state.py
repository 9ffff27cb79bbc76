"""Host-side serving bookkeeping and the pool's KV-slab moves.

Counterpart of `audio_llama_tpu/inference/serving/state.py`. The pool
refuses tensor parallelism (`engine.py`), so JAX's `_check_tp_int4_layout`
has no counterpart here. The slab helpers stand in for JAX's jitted
dynamic-slice programs: each writes or reads one row's slots of the cache
tensors in place, never a copy of the whole pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ...models.llama import KVCache

CACHE_FIELDS = ("k", "v", "k_scale", "v_scale")


@dataclass
class _Row:
    """Host-side bookkeeping for one pool row."""
    rid: int = -1
    budget: int = 0
    emitted: List[int] = field(default_factory=list)
    free: bool = True
    staging: bool = False  # reserved for a chunked prefill in progress


@dataclass
class _Staging:
    """A chunked-prefill admission in progress (prefill_chunk_tokens): the
    staging cache fills piece by piece across scheduling rounds while the
    pool keeps decoding; after the last piece it splices like any
    admission."""
    req: "_Pending"
    cache: object  # staging KVCache [L, 1, Hkv, cap, hd]
    embeds: torch.Tensor  # combined prompt embeds [1, Pp, D], Pp a whole number of pieces
    emask: torch.Tensor  # [1, Pp] int32
    total: int  # real slots staged here (the suffix only for prefix admissions)
    written: int = 0  # slots appended so far
    tok0: Optional[torch.Tensor] = None  # first sampled token (set by the last piece)
    base: int = 0  # prefix real length (pieces append at base + i * c)


@dataclass
class _Pending:
    rid: int
    input_ids: np.ndarray  # [T] int32
    audio_features: Optional[np.ndarray]  # [S] waveform or [n_mels, F] log-mel, or None
    max_new_tokens: int
    prefix: Optional[int] = None  # registered-prefix handle
    # per-request sampling, resolved to the engine defaults at submit
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    greedy: bool = True


def samp_arrays(reqs, device) -> dict:
    """Per-request sampling parameters -> [len(reqs)] tensors on `device`."""
    return {
        "temperature": torch.tensor([r.temperature for r in reqs], dtype=torch.float32,
                                    device=device),
        "top_p": torch.tensor([r.top_p for r in reqs], dtype=torch.float32, device=device),
        "top_k": torch.tensor([r.top_k for r in reqs], dtype=torch.int32, device=device),
        "greedy": torch.tensor([r.greedy for r in reqs], dtype=torch.bool, device=device),
    }


@dataclass
class _Prefix:
    """A registered shared prompt prefix: its KV slab (computed once) plus the
    host bookkeeping admission needs."""
    cache: object  # KVCache [L, 1, Hkv, cap, hd] (+ scales)
    length: int  # real prompt slots (audio block + text)
    cap: int  # slab timeline (tile-rounded)
    ids: tuple = ()  # prefix text token ids (the auto-match key)
    has_audio: bool = False


def slab_fields(cache: KVCache):
    """(name, tensor) of the cache's slabs that exist (an int4 cache has no v)."""
    return [(n, getattr(cache, n)) for n in CACHE_FIELDS if getattr(cache, n) is not None]


def row_slab(cache: KVCache, b: int, cap: Optional[int] = None) -> KVCache:
    """Row b of a batched cache as a [L, 1, ...] cache, its first `cap` slots
    only when given (copies: the source slab can be freed)."""
    cut = {n: t[:, b:b + 1, :, :cap].clone() for n, t in slab_fields(cache)}
    return cache._replace(**cut)


def preloaded(fresh: KVCache, prefix: KVCache) -> KVCache:
    """`fresh` with the prefix slab's slots written at the origin, in place."""
    for n, t in slab_fields(fresh):
        src = getattr(prefix, n)
        t[:, :, :, :src.shape[3]] = src.to(t.dtype)
    return fresh


def splice_row(pool: KVCache, fresh: KVCache, row: int) -> None:
    """Write the fresh [L, 1, ...] slab into slots [0, cap) of pool row `row`,
    in place; the other rows and slots are untouched."""
    for n, t in slab_fields(pool):
        src = getattr(fresh, n)
        t[:, row, :, :src.shape[3]] = src[:, 0].to(t.dtype)
