"""Sequence parallelism for generation: audio windows and the KV-cache
timeline split over the mesh's 'sp' axis.

Counterpart of `audio_llama_tpu/parallel/seq_parallel.py`:
  - `make_sp_encode`: long audio is N independent 30 s Whisper windows;
    each sp rank encodes its N / sp whole windows (its dp rows with a 'dp'
    axis), then the frames are gathered over sp (and dp), so every rank
    holds the frames of the whole batch, equal to the single-device chunked
    encode;
  - `make_sp_generate`: each sp rank holds total / sp slots of every
    timeline of the KV cache, the memory ceiling of long contexts; weights
    and activations stay whole, the rank owning the current slot appends
    the new row, and each layer's decode attention merges the ranks' flash
    statistics with one pmax and one psum over 'sp' (models/llama.py).
Every rank of the mesh calls the returned function with the same full
inputs and gets the whole result.
"""

from __future__ import annotations

import torch

from ..config import AudioLLMConfig
from . import collectives


def make_sp_encode(cfg: AudioLLMConfig, mesh, compute_dtype=torch.bfloat16):
    """-> fn(frozen, audio [B, N * S]) -> encoder frames [B, N * A, d]. The
    mesh must have an 'sp' axis whose size divides the window count N; a
    'dp' axis splits the batch too. The Whisper weights stay whole."""
    from ..models import allm

    if "sp" not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no 'sp' axis")
    sp_axis = mesh.axis("sp")
    dp_axis = mesh.axis("dp") if "dp" in mesh.shape else None
    S = cfg.mel.max_samples

    def fn(frozen, audio):
        B, total = audio.shape
        if total % S:
            raise ValueError(f"audio length {total} must be whole {S}-sample windows")
        n_windows = total // S
        if n_windows % sp_axis.size:
            raise ValueError(f"sp={sp_axis.size} must divide the window count {n_windows}")
        dp = collectives.axis_size(dp_axis)
        if B % dp:
            raise ValueError(f"dp={dp} must divide the batch ({B} rows)")
        nb, nw = B // dp, n_windows // sp_axis.size
        i, j = collectives.axis_index(dp_axis), sp_axis.index
        local = audio[i * nb:(i + 1) * nb, j * nw * S:(j + 1) * nw * S]
        enc = allm.process_audio_features(frozen, cfg, local, compute_dtype)
        enc = collectives.all_gather(enc, sp_axis, dim=1)
        return collectives.all_gather(enc, dp_axis, dim=0)

    return fn


def make_sp_generate(cfg: AudioLLMConfig, mesh, **static_kw):
    """Timeline-sharded generation over the mesh's 'sp' axis (with the batch
    over 'dp' on top; no other axis may be larger than 1). Returns
    fn(frozen, trainable, input_ids, attention_mask, audio=None, seed=0)
    -> GenerateResult, the same on every rank. `static_kw`: `generate`'s
    keyword arguments, `device` included. Each decode layer attends through
    the stats kernels (`ops/decode_attention_db.py`)."""
    from ..inference.generate import sharded_generate_fn

    if "sp" not in mesh.shape:
        raise ValueError(f"mesh {mesh.axis_names} has no 'sp' axis")
    extra = {k: v for k, v in mesh.shape.items() if k not in ("sp", "dp") and v != 1}
    if extra:
        raise ValueError(f"make_sp_generate shards over 'sp' (+ optional 'dp'); mesh has "
                         f"extra non-trivial axes {extra}")
    return sharded_generate_fn(cfg, mesh, static_kw, sp_axis=mesh.axis("sp"))
