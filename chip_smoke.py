#!/usr/bin/env python3
"""Drive the PyTorch port (audio_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # the same, plus torch.profiler breakdowns

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA present, the card's name and power limit, kernel build
     (one nvcc process per source, all started together);
  2. kernels: each hand-written kernel at its main-path shapes against its
     plain PyTorch version on the same inputs (stated tolerance), then on
     inputs with planted faults, which the same check must reject (the
     decode megakernel's and the int8-KV kernel's by FAULT_MARGIN; the
     megakernel layer by layer, and its one-launch stack against its layers
     launched one by one, bit for bit); timed by device time (CUPTI; a trace
     that lost records falls back to CUDA events) beside the plain version
     (CUDA events: a plain version launches thousands of kernels, and a
     process's CUPTI loses records once it has traced some 10^5 of them),
     one library call as a yardstick where one exists
     (never used by the port; the int4 decode products' on dequantized
     weights rotated past the L2, `library_ms_hot` on one) and the least
     time the card could take (bound); the megakernel also with its grid
     barriers alone; the int4 decode kernels' planted faults include a
     block's rows left out of the cluster sum, a stale ring stage, and the
     MLP's activations read from the next tile and a down K chunk left out;
  3. bf16 main path: `inference.generate.generate` at the full published
     widths (Llama-3.2-3B decoder, Whisper-large-v3-turbo encoder, LoRA rank
     64) with seeded random weights: a 30 s log-mel clip and a 24-token
     prompt, 32 greedy tokens, then one sampled run; the kernels' launch
     counters are zeroed before the greedy run and read after it;
  4. int4 main path: the same model with LoRA merged and the decoder
     quantized on the card to the fused int4 tree (as the inference CLI's
     --int4_decoder does), B = 4 seeded 30 s waveforms with prompts of 24,
     20, 16 and 12 tokens, right-padded, an int4 KV cache, 32 greedy tokens
     and one sampled run; the counters are zeroed and read around the
     greedy run;
  5. CLI path: `inference.cli.generate_response` on a seeded 12 s, 44.1 kHz
     stereo WAV (mixdown, resample, padding to 30 s) at full width on the
     int4 tree, B = 1, whose tokens must equal `generate`'s on the processed
     audio; each decode step is one megakernel launch;
  6. int4w+kv4, B = 1: one 30 s waveform, the tree rotated (QuaRot, as
     --rotate) before it is quantized, 32 greedy tokens: 31 megakernel
     launches and no per-layer decode kernel; then the same request with
     the megakernel off, its decode time and its logits step by step;
  7. int8w+kv8, B = 4: the int4 path's request on the weight-only int8 tree
     with an int8 KV cache (--int8_decoder --kv_quant): 868 int8-KV kernel
     launches;
  8. card vs host: the bf16 path and the quantized paths (int4 + int4 KV,
     rotated or not, through the megakernel; int8 + int8 KV) cut to 2
     Whisper and 2 Llama layers at full width, the card (kernels, bf16)
     against the CPU plain path (f32) on the same weights: last-position
     prefill logits, and for the quantized paths one decode step's too;
  9. train kernels: the causal attention backward's dq and dk/dv kernels at
     the training shape (B 2, T 2048, Hq 24, Hkv 8, hd 128) against the
     plain backward on the forward kernel's residuals, on planted faults (D
     not computed, the causal mask dropped on one diagonal tile, a query
     head on the wrong KV head), two launches bit-equal; timed beside the
     plain backward and SDPA's backward;
 10. train path: the port's trainer in-process at full width
     (`--synthetic_flagship`, LoRA r64) on 24 seeded 30 s WAV clips: run A
     (B 2, 2 micro-batches a step, 3 steps, eval and save at step 2) and run
     B (B 8, `--remat --loss_chunk_size 256`, 2 steps); losses and grad norms
     finite, the update moves the trainable, every kernel launched exactly
     per micro-batch and eval batch, the final checkpoint reloaded bit for
     bit by the trainer's loader and the inference CLI's;
 11. train step card vs host at 2 + 2 layers: loss, every trainable leaf's
     gradient, the updated leaves.
 12. sharded decode kernels: the three timeline-sharded stats kernels
     (bf16, int8 and int4 KV) at the sp serving path's local slab (28
     layers, 8 KV heads, S local slots), B 1 and 4, against their plain
     versions (m and l within 1e-5 relative, acc within the decode kernels'
     bar, the caches bit-equal: an owner appends, a non-owner does not, an
     all-invalid slab gives (-5e29, 0, 0)); planted faults (a non-owner
     that appends, the fresh row's scales dropped, an unclamped row max);
     two half-slabs merged by `ops.attention.merge_stats` against the mono
     kernel on the whole slab; timed beside the plain version and SDPA;
 13. ring hop kernels: the tri='never' forward, dq and dk/dv kernels of
     the ring of sequence-parallel training at the sp = 2 hop of train A
     (B 2, Tl 1024, a padded source shard, the backward fed the row
     statistics merged over both blocks) against their plain versions, on
     planted faults (the causal mask on the hop, the source shard's bias
     dropped, the hop's own m and l for the merged ones, a later shard's
     hop launched: the launch count); timed beside the plain versions and
     SDPA (no mask) forward and backward;
 14. sharded training: 2 ranks on cuda:0 over gloo at full width on run
     A's corpus: dp = 2 and tp = 2 through the trainer CLI (`--distributed`,
     2 steps, a checkpoint), sp = 2 through `make_sharded_train_step` (the
     kernel ring, 2 steps), each against the single process: first loss,
     gradients, replicas bit-equal after every step, checkpoint reload bit
     for bit, the ring's launches exact per rank;
 15. multi-rank paths: a world of 2 ranks spawned on cuda:0 over gloo,
     each building its weights from the same seeds: (a) sp=2 on the
     serving configuration (LoRA merged, fused int4 tree, int4 KV, B = 1,
     four 30 s windows, also through `make_sp_encode`, 32 greedy tokens);
     (b) sp=2 on the bf16 tree with an int8 and a bf16 KV cache (one
     window, 8 tokens); (c) tp=2 on the int4 tree packed after the shard
     (int4 KV, B = 4, 16 tokens); (d) dp=2 on the bf16 tree (B = 4, 8
     tokens). Tokens identical on both ranks, the first decode step's
     logits within rel-L2 2e-2 of the single-process run, launches exact
     (the stats kernel 28 times per decode step per rank on the sp paths);
     per-rank times of 2 ranks time-sharing one card (not a scaling
     number) and which gloo collectives take CUDA tensors.
 16. --decode_impl arms: the four kernels of the inference CLI's
     `--decode_impl decode_kernel` / `decode_packed` (the normalized db
     kernels on bf16, int8 and int4 caches; the timeline-chunked packed
     kernel on bf16 and int8 caches) at the decoder's geometry, the bf16
     path's timeline and 3040 slots, B 1 and 4, against their plain
     versions (the caches bit-equal), on planted faults (p not normalized,
     a chunk dropped, the stale row read at the offset), timed beside the
     plain version and SDPA (run after phase 12's kernels); then, at the
     end of phases 3, 6 and 7 on their models (`decode_ab_path`):
     decode_kernel with bf16 KV at B = 1, with the int4 tree and int4 KV at
     B = 1 (the megakernel unlaunched), decode_packed and decode_kernel with
     int8 KV at B = 4: tokens well formed, launches exact, the first decode
     step's logits within rel-L2 2e-2 of the auto arm's, decode time per
     token beside auto's.
 17. int8 encoder (bench.py's encode program): (a) the `--enc_algo`
     kernels v3q, bounded (in v3's [B, T, H*hd] layout and head-major) and
     twopass (f32 and bf16 exp) at T 1536, 1500 valid keys, H 20, hd 64,
     B 1 and 8 against their plain versions, on planted faults (valid_len
     +-1; v3q the next head's V scales; bounded ||q|| taken before q is
     scaled, which underflows every row; twopass its last key tile
     skipped), timed beside the plain version and SDPA, and the bounded
     kernel zeroing the rows its plain version zeroes on outlier keys; (b)
     8 seeded 30 s waveforms -> log-mel -> `quantize_encoder_smoothed`
     calibrated on the card on the batch -> `encode_int8` for each of v3,
     v3q, twopass, bounded -> the projector, beside the bf16 encoder:
     encode_ms, audio-s/s, launches exact (32 of the chosen kernel, none of
     the others), v3/twopass/bounded within rel-L2 2e-2 of one another and
     v3q within 5e-2 of v3; (c) the bf16 path's model with its encoder
     quantized through `generate` (32 of the v3 kernel, no LayerNorm
     kernel; the first decode step's logits beside the bf16 encoder's);
     (d) card vs host at 2 Whisper layers for each algo.
 18. causal variants and the K-split W4A16 (see `causal_variant_checks`,
     `ksplit_kernel_checks`, `causal_variant_path`, `ksplit_path`); the
     variants' kernel checks run first of all, right after the build, so
     CUPTI times them before it has traced enough records to lose some.
 19. the last three Pallas kernels: (a) single-buffered decode attention
     (`decode_attention` on a bf16 cache, `decode_attention_quantized` on an
     int8 one) at [28, B, 8, S, 128] caches, S 1568 and 3040, B 1 and 4,
     against their plain versions (caches bit-equal, scales untouched), on
     planted faults (p not normalized, a stale fresh row), timed beside the
     plain version and SDPA, then their own path (4 decode steps through
     every layer, counted); (b) the unstacked W4A16 `int4_matmul` at q_proj
     and down_proj, M 4 and 6104, both pack formats, on planted faults,
     timed beside a bf16 matmul on the dequantized weight, and its path,
     `_linear` on a 2-D and a w_r-smoothed w_p tree.
 20. serving: `inference.serving.ServingEngine` (4 rows, chunks of 8) on
     the int4w+kv4 tree at full width behind `inference.server` on
     127.0.0.1: a /v1/prefix registration (a 30 s WAV and an instruction)
     and 8 concurrent /v1/generate requests of 32 tokens (four 30 s WAVs, one
     streamed; four suffixes of the prefix, two sampled): all answered,
     launches exact per decode chunk and prefill, /healthz and /v1/stats
     consistent, each audio request's prefill and first decode-step logits
     within rel-L2 2e-2 of `generate` at B = 1 (and under chunked prefill of
     512), stop() failing a request in flight; requests/s, tokens/s, time to
     first token, ms per chunk, peak memory; then the pool card vs host at
     2 + 2 layers, with the top-2 logit margin at the first step where a
     request's card and host tokens part.
 21. smoothed int4 trees and GPTQ: (a) the fused int4 MLP's dn_r mode (a
     smoothed tree's down equalizer) at the int4 path's decode shape
     against its plain version, on planted faults (dn_r ignored, the next
     layer's dn_r); (b) `smooth_path`: the full-width model with LoRA
     merged and outlier channels injected, quantized on the card four ways
     at scale group 32 (RTN, clipped RTN, smoothed, GPTQ calibrated on the
     four requests' audio splice), the first-step KL of each against the
     unquantized tree (reported), GPTQ's proxy loss over layer 0 at most
     RTN's, `generate` at B = 4 and B = 1 on the smoothed, clipped and GPTQ
     trees with exact launches (no megakernel: its gate refuses w_r and
     group 32; the smoothed tree: the dn_r mode every decode step), and the
     clipped tree at B = 4 under INT4_BK = 768; (c) card vs host at 2 + 2
     layers on a smoothed and a GPTQ tree of merged seeded weights (group
     128, through the megakernel) and on a clipped and a GPTQ tree at group
     32 (the per-layer kernels).
 22. the int4 kernels' scale group: (a) `group_kernel_checks`: rows 6, 7,
     7r, 28 and 31 of phase 2 again at groups 32 and 64 at the same shapes
     against their plain versions, on the planted fault group g's partial
     scaled by group g+1's scale, timed with the bound at that group's
     bytes (each row's `by_group`, with group 32's launches on the path that
     runs it; `int4_2d_checks` also runs `_linear` on group-32 weights); (b)
     `eval_path`, the quantization-accuracy path at full width on phase 21's
     model and group-32 trees: a FLAC formant-speech corpus
     (`data.synth_speech`), `eval.kl.batch_logit_kl` of each tree against the
     unquantized one on a loader batch of 4, `eval.wer.evaluate_wer` on the
     bf16 and the clipped tree (8 clips, 12 tokens): finite, shaped and
     counted, the clip-off RTN tree's KL above zero, WER reported.
With `--profile`, phases 3, 4, 6 (megakernel off), 7 and 10 add a
torch.profiler breakdown (encode + prefill + first token, and per decode
token; one train step) by device kernel group, with the device's busy share
and launches; phase 6 always reports its megakernel breakdown.

Output: progress lines, then `{"kernels": [...]}`, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


PROFILE_TRIES = 3  # CUPTI has come back with no device events now and then


def traced(fn, calls: int = 1):
    """Run fn under torch.profiler -> (wall ms, {device kernel name: ms},
    device launches). Device durations come from CUPTI. A trace that holds
    no device event is taken again (logged), up to PROFILE_TRIES times. With
    fn making `calls` calls of one function, each launching the same
    kernels, a trace in which a kernel's records are not a multiple of
    `calls` lost records: AssertionError."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, count, n = {}, {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                count[e.name] = count.get(e.name, 0) + 1
        short = {name: c for name, c in count.items() if c % calls}
        if short:
            name, c = next(iter(short.items()))
            raise AssertionError(f"profiler: the trace lost records ({c} of {name[:60]} "
                                 f"in {calls} calls)")
        if by_name:
            return wall_ms, by_name, n
        log(f"profiler: the trace holds no device events (attempt {attempt} of "
            f"{PROFILE_TRIES})")
    raise AssertionError("profiler: the trace holds no device events")


class Ms(float):
    """A time in ms that keeps how it was taken (`by`): "cupti" or "cuda
    events". `main` copies each kernel row's into the row's `timed_by`."""

    def __new__(cls, value: float, by: str):
        self = super().__new__(cls, value)
        self.by = by
        return self


def time_ms(fn, iters: int = 20, warmup: int = 3) -> Ms:
    """Device time of one call after warm-up: the summed durations of the
    kernels it launched, over `iters` calls. Host launch gaps are left out:
    a ~40 us kernel behind a Python wrapper would otherwise be timed at the
    host's pace."""
    for _ in range(warmup):
        fn()

    def many():
        for _ in range(iters):
            fn()

    try:
        _, by_name, _ = traced(many, calls=iters)
    except AssertionError as err:  # no events PROFILE_TRIES times, or records lost
        log(f"time_ms: {err}; this time is by CUDA events instead")
        return Ms(events_ms(fn, iters=iters, warmup=0), "cuda events (no complete CUPTI trace)")
    return Ms(sum(by_name.values()) / iters, "cupti")


def events_ms(fn, iters: int = 20, warmup: int = 3) -> Ms:
    """Time of one call by CUDA events around `iters` calls (a cross-check of
    `time_ms` for kernels long enough that host launch gaps do not count)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return Ms(start.elapsed_time(end) / iters, "cuda events")


def bound(flops: float, nbytes: float, flop_rate: float = H100_BF16_FLOPS):
    t_ops, t_bytes = flops / flop_rate, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def sdpa_backend(fn) -> str:
    """The backend PyTorch chose for an SDPA call, from the names of the
    device kernels one call launched (CUPTI): cudnn, flash, efficient
    (memory-efficient) or math, with the longest kernel's name."""
    try:
        _, by_name, _ = traced(fn)
    except AssertionError as err:
        return f"not traced ({err})"
    names = " ".join(by_name).lower()
    label = next((label for key, label in (("cudnn", "cudnn"), ("flash", "flash"),
                                           ("fmha", "efficient"), ("efficient", "efficient"))
                  if key in names), "math")
    return f"{label} ({max(by_name, key=by_name.get)[:90]})"


# Kernel-vs-plain tolerance: |got - want| <= atol + BF16_ULP * |want|, with
# atol a fraction of the RMS of the plain output's row (the last dim: one
# head's output vector, one normalized row). BF16_ULP admits one rounding
# flip of a bf16 output; atol bounds the gap before that rounding, which the
# kernels' other summation orders (and, in the attention forwards, P rounded
# to bf16 at the running rather than the final max) leave, and which scales
# with the row. On the card the worst element of each attention kernel
# reads about half its bar, and every planted one-key mask fault 30x or more
# (PERF.md, PR 1).
BF16_ULP = 2.0 ** -7
ATOL_ROW_RMS_FRAC = {
    "layer_norm": 1e-3,  # the same one-pass f32 moments on both sides
    "enc_attention": 3e-2,
    "causal_attention": 3e-2,
    "decode_attention_mono": 2.5e-3,  # the same arithmetic on both sides
    # f32 output: the same f32 products summed in another order (~1e-6)
    "mel_power": 1e-4,
    # bf16 outputs of the same f32 group sums in another order: a bf16
    # flip of the output, or (MLP) of an activation, at most
    "int4_matmul_stacked": 1e-3,
    "mlp_int4_stacked": 1e-3,
    "decode_attention_quantized4_mono": 2.5e-3,
    "decode_attention_quantized_mono": 2.5e-3,  # the same arithmetic on both sides
    # acc of the three stats kernels (m and l: STATS_REL): the same f32 sums
    # in another order, P (times the V scale) rounded to bf16 on both sides
    "decode_attention_db_stats": 2.5e-3,
    # one layer's output from the same input (`mega_layerwise`): bf16
    # roundings of the planes, the activation and the residual flip where
    # the f32 sums are ordered otherwise, and a flip can move a nibble of the
    # fresh int4 row
    "decode_megakernel": 2e-2,
    # bf16 gradients: the same f32 products summed in another order, then
    # P and dS rounded to bf16 (a rounding can flip) before f32 sums over up
    # to 2048 keys (dq) or 3 x 2048 queries (dk, dv)
    "causal_attention_dq": 2e-2,
    "causal_attention_dkv": 2e-2,
    # the --decode_impl kernels: the same arithmetic on both sides (packed:
    # p rounded against the same running max), f32 sums in another order
    "decode_attention_db": 2.5e-3,
    "decode_attention_quantized_db": 2.5e-3,
    "decode_attention_quantized4_db": 2.5e-3,
    "decode_attention_packed": 2.5e-3,
    # the encoder's A/B kernels: row 2's bar (P rounded to bf16 / pq to an
    # int8 level at the same max on both sides, f32 sums in another order;
    # v3q's pq may flip one level at a rounding tie of exp)
    "enc_attention_v3q": 3e-2,
    "enc_attention_bounded": 3e-2,
    "enc_attention_twopass": 3e-2,
    # the single-buffered decode kernels: the same arithmetic on both sides
    # (p normalized and rounded before PV), f32 sums in another order
    "decode_attention": 2.5e-3,
    "decode_attention_quantized": 2.5e-3,
    # the unstacked W4A16: row 6's bar (the same device code)
    "int4_matmul": 1e-3,
}


def tol_ratio(got, want, frac: float, rms_dims=(-1,)) -> float:
    """max |got - want| / (atol + BF16_ULP |want|), atol = frac * the RMS of
    want over `rms_dims` (its row by default); the check passes at <= 1."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = frac * want.pow(2).mean(dim=rms_dims, keepdim=True).sqrt() + BF16_ULP * want.abs()
    return torch.where(err == 0, 0.0, err / bar).max().item()


# A gradient row can cancel to ~0 (the first query's dq is 0 in exact
# arithmetic, and rounding leaves +-1e-8 there), so the backward kernels'
# atol scales with the RMS of the whole [T, hd] slab of each (batch, head).
GRAD_RMS_DIMS = (1, 3)


def check_close(name, got, want, frac, rms_dims=(-1,)):
    """-> (max_abs_err, tol_ratio); raises outside the tolerance."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    ratio = tol_ratio(got, want, frac, rms_dims)
    if ratio > 1:
        raise AssertionError(f"{name}: outside tolerance (ratio {ratio:.3f}); "
                             f"max_abs_err={err:.3e}")
    return err, ratio


def must_reject(name, fault, got, want, frac, margin: float = 1.0, rms_dims=(-1,)) -> float:
    """The kernel run on a planted fault must fail the check it passed, by
    more than `margin` times its bar."""
    ratio = tol_ratio(got, want, frac, rms_dims)
    if not ratio > margin:
        raise AssertionError(f"{name}: the planted fault '{fault}' lands at {ratio:.3f} of the "
                             f"bar, not above {margin}; the tolerance is too loose")
    return ratio


FAULT_MARGIN = 10.0  # the megakernel's and the int8-KV kernel's faults land this far out


def tol_entry(frac) -> dict:
    return {"atol_frac_of_row_rms": frac, "rtol": BF16_ULP}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def prefill_attention_case(dev, gen) -> dict:
    """Row 3's inputs, the causal prefill attention of the bf16 path: T =
    1526 real tokens padded to 1536, Hq 24 / Hkv 8, hd 128, q pre-scaled,
    the last 10 keys padded."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc, bf = full_config().llama, torch.bfloat16
    B, T, Hq, Hkv, hd = 1, 1536, lc.num_heads, lc.num_kv_heads, lc.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    qs = randn(B, T, Hq, hd) * torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    k, v = randn(B, T, Hkv, hd), randn(B, T, Hkv, hd)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[:, 1526:] = 0
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    return dict(qs=qs, k=k, v=v, mask=mask, key_bias=key_bias)


def prefill_sdpa(case):
    """Row 3's yardsticks on a prefill case -> (SDPA with is_causal and
    enable_gqa on the unrepeated K/V, whose padded keys lie after every real
    query; the earlier yardstick: SDPA with a boolean causal and key mask on
    K/V repeated to Hq, which keeps it off its flash backend), each a
    function of no arguments."""
    import torch.nn.functional as F

    qh, kh, vh = (case[n].transpose(1, 2) for n in ("qs", "k", "v"))
    G = qh.shape[1] // kh.shape[1]
    T = qh.shape[2]
    causal_ok = (torch.ones(T, T, dtype=torch.bool, device=qh.device).tril()
                 & (case["mask"][0] != 0)[None, :])
    kr, vr = (case[n].repeat_interleave(G, dim=2).transpose(1, 2) for n in ("k", "v"))
    return (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0,
                                                   enable_gqa=True),
            lambda: F.scaled_dot_product_attention(qh, kr, vr, attn_mask=causal_ok, scale=1.0))


def kernel_checks(dev, gen):
    from audio_llama_tpu_torch.ops import causal_attention as ca
    from audio_llama_tpu_torch.ops import decode_attention_mono as dm
    from audio_llama_tpu_torch.ops import enc_attention as ea
    from audio_llama_tpu_torch.ops import layer_norm as ln
    import torch.nn.functional as F

    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []

    # 1. LayerNorm: [B*1536, 1280] bf16 (the padded encoder stack, B=1)
    N, D = 1536, 1280
    x = randn(N, D) * 2 + 0.5
    s, b = randn(D) * 0.1 + 1, randn(D) * 0.1
    got, want = ln.layer_norm_cuda(x, s, b), ln.layer_norm_plain(x, s, b)
    frac = ATOL_ROW_RMS_FRAC["layer_norm"]
    err, ratio = check_close("layer_norm", got, want, frac)
    flops = 8.0 * N * D
    nbytes = 2.0 * (2 * N * D + 2 * D)
    bms, bby = bound(flops, nbytes, H100_F32_FLOPS)
    rows.append(dict(
        name="layer_norm", route="cuda", source="audio_llama_tpu_torch/csrc/layer_norm.cu",
        replaces="audio_llama_tpu/ops/ln_pallas.py:28", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio,
        ms=time_ms(lambda: ln.layer_norm_cuda(x, s, b), iters=100),
        plain_ms=events_ms(lambda: ln.layer_norm_plain(x, s, b)),
        library_ms=time_ms(lambda: F.layer_norm(x, (D,), s, b, 1e-5), iters=100),
        launches=None, bound_ms=bms, bound_by=bby, shapes=f"x[{N},{D}] bf16",
    ))
    log(f"kernel layer_norm ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f}")

    # 2. encoder attention: [1, 1536, 20, 64] bf16 views of [1, 1536, 1280],
    #    1500 valid keys, q pre-scaled; timed at B 1, 4 (the int4 B = 4
    #    request's encoder batch) and 8 (bench.py's encode batch)
    B, T, H, hd, valid = 1, 1536, 20, 64, 1500
    qkv = [randn(B, T, H * hd).view(B, T, H, hd) for _ in range(3)]
    qs = qkv[0] * torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    k, v = qkv[1], qkv[2]
    want = ea.enc_attention_plain(qs, k, v, valid)[:, :valid]
    frac = ATOL_ROW_RMS_FRAC["enc_attention"]
    err, ratio = check_close("enc_attention", ea.enc_attention_cuda(qs, k, v, valid)[:, :valid],
                             want, frac)
    faults = {  # one key too many, one too few
        f"valid_len {valid + d}": must_reject(
            "enc_attention", f"valid_len {valid + d}",
            ea.enc_attention_cuda(qs, k, v, valid + d)[:, :valid], want, frac)
        for d in (1, -1)
    }
    bms, bby = bound(*enc_work("enc_attention", B, T, H, hd, valid))
    sdpa, sdpa_masked = enc_sdpa(qs, k, v, valid)
    row = dict(
        name="enc_attention", route="cuda", source="audio_llama_tpu_torch/csrc/enc_attention.cu",
        replaces="audio_llama_tpu/ops/enc_attention.py:102", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: ea.enc_attention_cuda(qs, k, v, valid)),
        plain_ms=events_ms(lambda: ea.enc_attention_plain(qs, k, v, valid)),
        library_ms=time_ms(sdpa), library_backend=sdpa_backend(sdpa),
        library_ms_masked=time_ms(sdpa_masked), library_masked_backend=sdpa_backend(sdpa_masked),
        launches=None, bound_ms=bms, bound_by=bby, sm90=enc_sm90_report("enc_attention"),
        shapes=f"q/k/v[B,{T},{H},{hd}] bf16 views of [B,{T},{H * hd}], valid {valid}, B 1 "
               "(ms) and 4, 8 (ms_b4, ms_b8)",
        notes="library_ms: SDPA with no mask on K/V cut to the valid keys; library_ms_masked: "
              "SDPA on all keys with a boolean key mask",
    )
    gen_b = torch.Generator(device=dev).manual_seed(2)  # leaves gen's later draws as they were
    for Bb in (4, 8):
        case = enc_case(dev, gen_b, Bb)
        sdpa_b, _ = enc_sdpa(case["qs"], case["k"], case["v"], valid)
        bms_b, _ = bound(*enc_work("enc_attention", Bb, T, H, hd, valid))
        row.update({f"ms_b{Bb}": time_ms(lambda: enc_call("enc_attention", case)),
                    f"library_ms_b{Bb}": time_ms(sdpa_b), f"bound_ms_b{Bb}": bms_b})
        del case, sdpa_b
    rows.append(row)
    log(f"kernel enc_attention ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")

    # 3. causal prefill attention: T = 1526 real tokens padded to 1536,
    #    Hq 24 / Hkv 8, hd 128, q pre-scaled, last 10 keys padded
    case = prefill_attention_case(dev, gen)
    qs, k, v, mask, key_bias = (case[n] for n in ("qs", "k", "v", "mask", "key_bias"))
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    got = ca.causal_attention_cuda(qs, k, v, key_bias)
    want = ca.causal_attention_plain(qs, k, v, key_bias)
    frac, real = ATOL_ROW_RMS_FRAC["causal_attention"], 1526
    err, ratio = check_close("causal_attention", got.o[:, :real], want.o[:, :real], frac)
    # row stats of the real rows: m is the same f32 max on both sides; each
    # P term sits within 2^-8 of the plain one, so l does too
    for stat, atol, rtol in (("l", 0.0, 2.0 ** -8), ("m", 1e-4, 1e-5)):
        g_, w_ = getattr(got, stat)[:, :real], getattr(want, stat)[:, :real]
        if ((g_ - w_).abs() > atol + rtol * w_.abs()).any():
            raise AssertionError(f"causal_attention.{stat}: outside atol={atol} rtol={rtol}")
    # planted faults: each real query attends one future key (a query row
    # shifted down by one), or key 700 is masked as padding
    q_ahead = torch.cat([qs[:, :1], qs[:, :-1]], dim=1)
    drop = key_bias.clone()
    drop[:, 700] = ca.NEG
    faults = {
        "one future key": must_reject(
            "causal_attention", "one future key",
            ca.causal_attention_cuda(q_ahead, k, v, key_bias).o[:, 1:real],
            want.o[:, :real - 1], frac),
        "key 700 masked": must_reject(
            "causal_attention", "key 700 masked",
            ca.causal_attention_cuda(qs, k, v, drop).o[:, :real], want.o[:, :real], frac),
    }
    flops = 4.0 * B * Hq * hd * T * (T + 1) / 2
    nbytes = 2.0 * B * T * hd * (2 * Hq + 2 * Hkv) + 4.0 * B * T * (1 + 2 * Hq)
    bms, bby = bound(flops, nbytes)
    sdpa, sdpa_masked = prefill_sdpa(case)
    run = lambda: ca.causal_attention_cuda(qs, k, v, key_bias)  # noqa: E731
    rows.append(dict(
        name="causal_attention", route="cuda",
        source="audio_llama_tpu_torch/csrc/causal_attention.cu",
        replaces="audio_llama_tpu/ops/causal_attention.py:101", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(run), ms_events=events_ms(run),
        plain_ms=events_ms(lambda: ca.causal_attention_plain(qs, k, v, key_bias)),
        library_ms=time_ms(sdpa), library_backend=sdpa_backend(sdpa),
        library_ms_masked=time_ms(sdpa_masked), library_masked_backend=sdpa_backend(sdpa_masked),
        launches=None, bound_ms=bms, bound_by=bby, sm90=sm90_report("causal_attention", hd),
        shapes=f"q[{B},{T},{Hq},{hd}] k/v[{B},{T},{Hkv},{hd}] bf16, 1526 real",
        notes="library_ms: SDPA(is_causal, enable_gqa) on unrepeated K/V (the padded keys lie "
              "after every real query); library_ms_masked: SDPA with a boolean causal and "
              "key mask on K/V repeated to Hq",
    ))
    log(f"kernel causal_attention ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")

    # 4. decode attention: cache [28, 1, 8, 1568, 128] bf16, the last decode
    #    step of the main path (offset 1557, slots 0..1557 valid)
    L, B, Hkv, S, hd, Hq, off = 28, 1, 8, 1568, 128, 24, 1557
    ck, cv = randn(L, B, Hkv, S, hd), randn(L, B, Hkv, S, hd)
    q, kn, vn = randn(B, Hq, hd), randn(B, Hkv, hd), randn(B, Hkv, hd)
    offset = torch.full((B,), off, dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= offset[:, None]).to(torch.int32)
    li, scale = 5, hd ** -0.5
    ck2, cv2 = ck.clone(), cv.clone()
    layer_k, layer_v = ck[li:li + 1].clone(), cv[li:li + 1].clone()  # before the append
    got, gk, gv = dm.decode_attention_cuda(q, kn, vn, ck, cv, li, offset, valid, scale)
    want, wk, wv = dm.decode_attention_plain(q, kn, vn, ck2, cv2, li, offset, valid, scale)
    frac = ATOL_ROW_RMS_FRAC["decode_attention_mono"]
    err, ratio = check_close("decode_attention", got, want, frac)
    if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
        raise AssertionError("decode_attention: in-place cache append differs")
    # planted faults, on a copy of the layer as it was before the append:
    # one slot too many or too few in `valid`, or the fresh row not written
    # (the slot's stale row attended in its place)
    kpos = torch.arange(S, device=dev)[None, :]
    planted = {
        "slot offset+1 attended": (kn, vn, (kpos <= offset[:, None] + 1).to(torch.int32)),
        "slot offset not attended": (kn, vn, (kpos < offset[:, None]).to(torch.int32)),
        "stale fresh row": (layer_k[0, :, :, off].clone(), layer_v[0, :, :, off].clone(), valid),
    }
    faults = {
        fault: must_reject("decode_attention", fault, dm.decode_attention_cuda(
            q, k_row, v_row, layer_k.clone(), layer_v.clone(), 0, offset, fvalid, scale)[0],
            want, frac)
        for fault, (k_row, v_row, fvalid) in planted.items()
    }
    n_valid = off + 1
    nbytes = (2.0 * 2 * B * Hkv * n_valid * hd + 2.0 * 2 * B * Hq * hd
              + 2.0 * 2 * B * Hkv * hd + 4.0 * B * (S + 1))
    flops = 4.0 * B * Hq * n_valid * hd
    bms, bby = bound(flops, nbytes)
    # timed over the 28 layers in turn: 180 MB of K/V, so each call finds
    # its slab outside the 50 MB L2, as a decode step does
    kr = ck.repeat_interleave(Hq // Hkv, dim=2)  # [L, B, Hq, S, hd]
    vr = cv.repeat_interleave(Hq // Hkv, dim=2)
    qd = q[:, :, None, :]
    dmask = (valid != 0)[:, None, None, :]
    turn = itertools.count()

    def library(layer):
        return F.scaled_dot_product_attention(qd, kr[layer], vr[layer], attn_mask=dmask,
                                              scale=scale)

    rows.append(dict(
        name="decode_attention_mono", route="cuda",
        source="audio_llama_tpu_torch/csrc/decode_attention.cu",
        replaces="audio_llama_tpu/ops/decode_attention_mono.py:633", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: dm.decode_attention_cuda(
            q, kn, vn, ck, cv, next(turn) % L, offset, valid, scale), iters=112),
        plain_ms=events_ms(lambda: dm.decode_attention_plain(
            q, kn, vn, ck2, cv2, next(turn) % L, offset, valid, scale), iters=28),
        library_ms=time_ms(lambda: library(next(turn) % L), iters=112),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"cache[{L},{B},{Hkv},{S},{hd}] bf16, q[{B},{Hq},{hd}], {n_valid} valid",
    ))
    log(f"kernel decode_attention_mono ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")
    return rows


# kernel name -> (module of audio_llama_tpu_torch.ops, its launch counter)
COUNTERS = {
    "layer_norm": ("layer_norm", "launches"),
    "enc_attention": ("enc_attention", "launches"),
    "causal_attention": ("causal_attention", "launches"),
    "decode_attention_mono": ("decode_attention_mono", "launches"),
    "mel_power": ("mel_power", "launches"),
    "int4_matmul_stacked": ("int4_matmul", "launches"),
    "mlp_int4_stacked": ("mlp_int4", "launches"),
    "mlp_int4_stacked[dn_r]": ("mlp_int4", "launches_dnr"),
    "decode_attention_quantized4_mono": ("decode_attention_mono", "launches_q4"),
    "decode_attention_quantized_mono": ("decode_attention_mono", "launches_q8"),
    "decode_megakernel": ("decode_megakernel", "launches"),
    "causal_attention_dq": ("causal_attention", "launches_dq"),
    "causal_attention_dkv": ("causal_attention", "launches_dkv"),
    "decode_attention_db_stats": ("decode_attention_db", "launches"),
    "decode_attention_quantized_db_stats": ("decode_attention_db", "launches_q8"),
    "decode_attention_quantized4_db_stats": ("decode_attention_db", "launches_q4"),
    "causal_attention_never": ("causal_attention", "launches_never"),
    "causal_attention_dq_never": ("causal_attention", "launches_dq_never"),
    "causal_attention_dkv_never": ("causal_attention", "launches_dkv_never"),
    "decode_attention_db": ("decode_attention_db", "launches_norm"),
    "decode_attention_quantized_db": ("decode_attention_db", "launches_norm_q8"),
    "decode_attention_quantized4_db": ("decode_attention_db", "launches_norm_q4"),
    "decode_attention_packed": ("decode_attention_packed", "launches"),
    "decode_attention_quantized_packed": ("decode_attention_packed", "launches_q8"),
    "enc_attention_v3q": ("enc_attention", "launches_v3q"),
    "enc_attention_bounded": ("enc_attention", "launches_bounded"),
    "enc_attention_twopass": ("enc_attention", "launches_twopass"),
    "causal_attention_cond": ("causal_attention", "launches_cond"),
    "causal_attention_bounded": ("causal_attention", "launches_bounded"),
    "causal_attention_bounded_cond": ("causal_attention", "launches_bounded_cond"),
    "causal_attention_twopass": ("causal_attention", "launches_twopass"),
    "causal_attention_dma": ("causal_attention", "launches_dma"),
    "causal_attention_dma2": ("causal_attention", "launches_dma2"),
    "int4_matmul_stacked_ksplit": ("int4_matmul", "launches_ksplit"),
    "decode_attention": ("decode_attention", "launches"),
    "decode_attention_quantized": ("decode_attention", "launches_q8"),
    "int4_matmul": ("int4_matmul", "launches_2d"),
}


def _counter_module(name):
    import importlib

    return importlib.import_module(f"audio_llama_tpu_torch.ops.{COUNTERS[name][0]}")


def zero_counters() -> None:
    for name, (_, attr) in COUNTERS.items():
        setattr(_counter_module(name), attr, 0)


def read_counters() -> dict:
    return {name: getattr(_counter_module(name), attr) for name, (_, attr) in COUNTERS.items()}


def full_config():
    """The model every phase runs: Llama-3.2-3B + Whisper-large-v3-turbo,
    LoRA r64, at the published widths."""
    from audio_llama_tpu_torch.config import AudioLLMConfig

    return AudioLLMConfig()


# the int4 path's batch: four right-padded prompts
INT4_PROMPTS = (24, 20, 16, 12)


PREFILL_TOKENS = 64  # tokens a block of the W4A16 prefill kernel (int4_matmul.cu)


def prefill_faults(got, want, frac, run, packed, li) -> dict:
    """The W4A16 prefill kernel's planted faults, each of which must fail the
    bar that `got` (its output at a prefill shape, one [M, N] row) passed:
    the low and high nibble planes swapped in the epilogue; the second token
    tile's rows shifted by one; a stale ring stage, K tile 1 (rows 128-255)
    computed with tile 0's packed bytes."""
    nh = got.shape[-1] // 2
    swapped = torch.cat([got[:, nh:], got[:, :nh]], dim=-1)
    shifted = got.clone()
    t = slice(PREFILL_TOKENS, 2 * PREFILL_TOKENS)
    shifted[t] = torch.roll(got[t], 1, dims=0)
    stale = packed.clone()
    stale[li, 128:256] = packed[li, :128]
    return {
        "prefill: nibble planes swapped in the epilogue": must_reject(
            "int4_matmul_stacked", "planes swapped", swapped, want, frac),
        "prefill: a token tile's rows shifted by one": must_reject(
            "int4_matmul_stacked", "token tile shifted", shifted, want, frac),
        "prefill: K tile 1 with tile 0's packed bytes (a stale ring stage)": must_reject(
            "int4_matmul_stacked", "stale ring stage", run(p=stale), want, frac),
    }


L2_BYTES = 50e6  # the H100's L2


def cold_layers(layer_bytes: float) -> int:
    """Layers a rotated yardstick cycles through so that together they
    exceed the L2 (each call then streams its weight from device memory, as
    the kernels' own calls rotating over the 28 layers do)."""
    return 1 + int(math.ceil(L2_BYTES / layer_bytes))


def rotated_ms(fn, n: int, iters: int = 56) -> "Ms":
    """time_ms of fn(i), i cycling over range(n)."""
    turn = itertools.count()
    return time_ms(lambda: fn(next(turn) % n), iters=iters)


DECODE_STAGE = 64  # rows of a stage of the decode kernels' ring (int4_common.cuh)


def decode_faults(got, want, frac, run, packed, li, x, plan, plain) -> dict:
    """The W4A16 decode kernel's planted faults, each of which must fail the
    bar that `got` (its output at a decode shape, one [M, N] row) passed:
    block rank 1's rows (K / C of them, `plan`) left out of the cluster's
    sum (the plain version of x with those rows zero); a stale ring stage
    (block 0's stage 1, rows 64-127, computed with stage 0's packed bytes).
    plain(xx, p) is the plain version."""
    name = "int4_matmul_stacked"
    kn = x.shape[-1] // plan.C
    dropped = x.clone()
    dropped[:, kn:2 * kn] = 0
    stale = packed.clone()
    stale[li, DECODE_STAGE:2 * DECODE_STAGE] = packed[li, :DECODE_STAGE]
    return {
        "decode: block rank 1's rows left out of the cluster sum": must_reject(
            name, "a block's rows left out", got, plain(dropped, packed), frac),
        "decode: a stale ring stage (rows 64-127 with rows 0-63's bytes)": must_reject(
            name, "stale ring stage", run(p=stale), want, frac),
    }


def mlp_faults(got, want, frac, x, gup, gus, dn, dns, li, group, plain) -> dict:
    """The fused MLP's planted faults, each of which must fail the bar that
    `got` passed, planted on the plain version's inputs: gate|up tile 0's
    activations read from tile 1 (its packed columns and scales copied from
    tile 1's); a gate|up block's rows (rank 1's) left out (x's rows zero); a
    down K chunk (chunk 1) left out of the workspace sum (its scale rows
    zero); a stale ring stage of the gate|up slab (rows 64-127 with rows
    0-63's bytes). plain(x, gup, gus, dns) is the plain version."""
    from audio_llama_tpu_torch.ops import int4_matmul as i4
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    name = "mlp_int4_stacked"
    K, F, dh = gup.shape[1], gup.shape[2], dn.shape[2]
    plan = mlp4.mlp_plan(x.shape[0], K, F, dh, group)
    tw, kn = i4.TILE, K // plan.C
    moved_p, moved_s = gup.clone(), gus.clone()
    moved_p[li, :, :tw] = gup[li, :, tw:2 * tw]
    moved_s[li, :, :tw] = gus[li, :, tw:2 * tw]
    moved_s[li, :, F:F + tw] = gus[li, :, F + tw:F + 2 * tw]
    dropped = x.clone()
    dropped[:, kn:2 * kn] = 0
    kcr = F // plan.n_kc
    no_chunk = dns.clone()
    no_chunk[li, kcr // group:2 * kcr // group] = 0
    stale = gup.clone()
    stale[li, DECODE_STAGE:2 * DECODE_STAGE] = gup[li, :DECODE_STAGE]
    return {
        "tile 0's activations read from tile 1": must_reject(
            name, "activations of the next tile", got, plain(x, moved_p, moved_s, dns), frac),
        "gate|up block rank 1's rows left out": must_reject(
            name, "a gate|up block's rows left out", got, plain(dropped, gup, gus, dns), frac),
        "down K chunk 1 left out of the workspace sum": must_reject(
            name, "a down K chunk left out", got, plain(x, gup, gus, no_chunk), frac),
        "a stale gate|up ring stage (rows 64-127 with rows 0-63's bytes)": must_reject(
            name, "stale ring stage", got, plain(x, stale, gus, dns), frac),
    }


def int4_kernel_checks(dev, gen):
    """The four kernels of the int4 path at its shapes (B = 4): mel power,
    the W4A16 matmul (decode and prefill shapes, both pack formats), the
    fused int4 MLP and int4-KV decode attention."""
    import torch.nn.functional as F

    from audio_llama_tpu_torch.models.llama import KVCache
    from audio_llama_tpu_torch.ops import decode_attention_mono as dm
    from audio_llama_tpu_torch.ops import int4_matmul as i4
    from audio_llama_tpu_torch.ops import mel_power as mp
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    cfg = full_config()
    lc = cfg.llama
    B = len(INT4_PROMPTS)
    prefix = cfg.audio_seq_len + 2 + max(INT4_PROMPTS)
    bf = torch.bfloat16
    rows = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rand_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int32
                             ).to(torch.int8)

    def rand_scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.002

    # 5. mel power: B waveforms of one window, reflect-padded
    mc = cfg.mel
    n_fft, n_bins, n_mels, Fr = mc.n_fft, mc.n_fft // 2 + 1, mc.num_mel_bins, mc.num_frames
    wav = randn(B, mc.max_samples) * 0.1
    padded = mp.pad_waveform(wav, mc)
    got, want = mp.mel_power_cuda(padded, mc, Fr), mp.mel_power_plain(padded, mc, Fr)
    frac = ATOL_ROW_RMS_FRAC["mel_power"]
    err, ratio = check_close("mel_power", got, want, frac)
    faults = {"frame offset shifted by one sample": must_reject(
        "mel_power", "frame offset shifted by one sample",
        mp.mel_power_cuda(padded[:, 1:].contiguous(), mc, Fr), want, frac)}
    flops = B * Fr * (2.0 * 2 * n_fft * n_bins + 3 * n_bins + 2.0 * n_bins * n_mels)
    nbytes = 4.0 * (padded.numel() + B * Fr * n_mels + 2 * n_fft * n_bins + n_bins * n_mels)
    bms, bby = bound(flops, nbytes, H100_F32_FLOPS)
    window = torch.hann_window(n_fft, periodic=True, device=dev)
    fb = torch.from_numpy(np.ascontiguousarray(mp._basis(mc)[2][:n_bins].T)).to(dev)

    def library():
        spec = torch.stft(wav, n_fft, mc.hop_length, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :Fr]
        return fb @ spec.abs().square()

    rows.append(dict(
        name="mel_power", route="cuda", source="audio_llama_tpu_torch/csrc/mel_power.cu",
        replaces="audio_llama_tpu/ops/mel_pallas.py:84", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: mp.mel_power_cuda(padded, mc, Fr)),
        plain_ms=events_ms(lambda: mp.mel_power_plain(padded, mc, Fr)),
        library_ms=time_ms(library), launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"waveform[{B},{mc.max_samples}] f32 -> [{B},{Fr},{n_mels}]",
    ))
    log(f"kernel mel_power ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")
    del wav, padded, got, want

    # 6. W4A16 matmul: decode q|k|v (pair, planes) and o (obin) at M = B;
    #    the prefill's four products (q|k|v and gate|up pair, planes; o and
    #    down obin, one row) at M = B * prefix and at B = 1's 1526 rows
    L, D, Fd = lc.num_layers, lc.hidden_size, lc.intermediate_size
    Nqkv = (lc.num_heads + 2 * lc.num_kv_heads) * lc.head_dim
    Nq = lc.num_heads * lc.head_dim
    M1 = cfg.audio_seq_len + 2 + PROMPT  # b1_path's prefix
    cases = [  # (label, M, K, N, fmt, planes)
        ("decode q|k|v", B, D, Nqkv, "pair", True),
        ("decode o", B, Nq, D, "obin", False),
    ]
    for M in (B * prefix, M1):
        cases += [(f"prefill q|k|v M {M}", M, D, Nqkv, "pair", True),
                  (f"prefill o M {M}", M, Nq, D, "obin", False),
                  (f"prefill gate|up M {M}", M, D, 2 * Fd, "pair", True),
                  (f"prefill down M {M}", M, Fd, D, "obin", False)]
    frac = ATOL_ROW_RMS_FRAC["int4_matmul_stacked"]
    by_shape, faults, worst = [], {}, (0.0, 0.0)
    li = min(5, L - 1)  # a layer inside the slab, picked by pointer offset
    for label, M, K, N, fmt, planes in cases:
        packed, scales = rand_bytes(L, K, N // 2), rand_scales(L, K // 128, N)
        x = randn(M, K, dtype=bf)

        def run(p=packed, s=scales, f=fmt, layer=li, xx=x):
            out = i4.int4_matmul_stacked_cuda(xx, p, s, layer, return_planes=planes, fmt=f)
            return torch.cat(out, dim=-1) if planes else out

        def plain(p=packed, s=scales, f=fmt, layer=li, xx=x):
            return i4.int4_matmul_stacked_plain(xx, p, s, layer, fmt=f)

        want = plain()
        got = run()
        err, ratio = check_close(f"int4_matmul_stacked {label}", got, want, frac)
        worst = max(worst, (ratio, err))
        if label == "decode q|k|v":
            faults["group g read with group g+1's scale"] = must_reject(
                "int4_matmul_stacked", "group g+1's scale",
                run(s=torch.roll(scales, -1, dims=1).contiguous()), want, frac)
        if fmt == "obin":
            faults[f"{label}: obin bytes decoded as pair"] = must_reject(
                "int4_matmul_stacked", "obin decoded as pair", run(f="pair"), want, frac)
        if label == f"prefill q|k|v M {B * prefix}":
            faults.update(prefill_faults(got, want, frac, run, packed, li))
        if label == "decode q|k|v":
            faults.update(decode_faults(
                got, want, frac, run, packed, li, x, i4.decode_plan(M, K, N // 2),
                lambda xx, p: i4.int4_matmul_stacked_plain(xx, p, scales, li, fmt=fmt)))
        del got
        w_deq = i4.dequantize_ref(packed[li], scales[li], fmt=fmt).to(bf)
        flops = 2.0 * M * K * N
        nbytes = K * N / 2 + (K / 128) * N * 4 + 2.0 * M * (K + N)
        bms, bby = bound(flops, nbytes)
        turn = itertools.count()
        shape_row = dict(
            shape=label, M=M, K=K, N=N, fmt=fmt, tol_ratio=ratio, max_abs_err=err,
            # decode calls rotate over the layers so each finds its slab in
            # device memory, as a decode step does
            ms=time_ms(lambda: run(layer=next(turn) % L), iters=56 if M <= 64 else 10),
            plain_ms=events_ms(plain, iters=10 if M <= 64 else 3),
            library_ms=time_ms(lambda: x @ w_deq, iters=56 if M <= 64 else 10),
            bound_ms=bms, bound_by=bby)
        if M <= 64:  # the yardstick from device memory too; the hot one beside it
            n = cold_layers(2.0 * K * N)
            w_rot = [i4.dequantize_ref(packed[i], scales[i], fmt=fmt).to(bf) for i in range(n)]
            shape_row["library_ms_hot"] = shape_row["library_ms"]
            shape_row["library_ms"] = rotated_ms(lambda i: x @ w_rot[i], n)
            shape_row["library_layers"] = n
            del w_rot
        by_shape.append(shape_row)
        log(f"kernel int4_matmul_stacked {label} ok: {json.dumps(shape_row)}")
        del packed, scales, x, want, w_deq
        torch.cuda.empty_cache()
    first = by_shape[0]
    rows.append(dict(
        name="int4_matmul_stacked", route="cuda",
        source="audio_llama_tpu_torch/csrc/int4_matmul.cu",
        replaces="audio_llama_tpu/ops/int4_matmul.py:370", max_abs_err=worst[1],
        tol=tol_entry(frac), tol_ratio=worst[0], planted_fault_ratios=faults,
        ms=first["ms"], plain_ms=first["plain_ms"], library_ms=first["library_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], launches=None,
        library_ms_hot=first["library_ms_hot"],
        shapes="the row's times are the decode q|k|v call; by_shape has every shape",
        notes="library_ms at M <= 64: x @ the dequantized bf16 layer, rotated over layers "
              "that exceed the L2 (library_ms_hot: one layer)",
        by_shape=by_shape, sm90=w4_sm90_report(),
    ))
    log(f"kernel int4_matmul_stacked ok: planted faults rejected: {faults}")

    # 7. fused int4 MLP at M = B (decode), pair
    dh = D // 2
    gup, gus = rand_bytes(L, D, Fd), rand_scales(L, D // 128, 2 * Fd)
    dn, dns = rand_bytes(L, Fd, dh), rand_scales(L, Fd // 128, D)
    x = randn(B, D, dtype=bf)
    chunk = mlp4.kernel_chunk(Fd, dh)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li, chunk=chunk)
    frac = ATOL_ROW_RMS_FRAC["mlp_int4_stacked"]
    err, ratio = check_close("mlp_int4_stacked",
                             mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, li, chunk=chunk),
                             want, frac)
    dropped = gus.clone()
    dropped[li, :, Fd - chunk:Fd] = 0  # the last chunk's gate: a = 0, as if dropped
    got = mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, li, chunk=chunk)
    faults = {"last F-chunk dropped": must_reject(
        "mlp_int4_stacked", "last F-chunk dropped",
        mlp4.mlp_int4_stacked_cuda(x, gup, dropped, dn, dns, li, chunk=chunk), want, frac)}
    faults.update(mlp_faults(
        got, want, frac, x, gup, gus, dn, dns, li, 128,
        lambda xx, gp, gs, ds: mlp4.mlp_int4_stacked_plain(xx, gp, gs, dn, ds, li, chunk=chunk)))
    del got
    wg = i4.dequantize_ref(gup[li], gus[li]).to(bf)
    wd = i4.dequantize_ref(dn[li], dns[li]).to(bf)
    # the yardstick from device memory: dequantized layers, rotated
    n_rot = cold_layers(2.0 * D * 3 * Fd)
    w_rot = [(i4.dequantize_ref(gup[i], gus[i]).to(bf), i4.dequantize_ref(dn[i], dns[i]).to(bf))
             for i in range(n_rot)]

    def mlp_library(i, r=None):
        g, d = w_rot[i]
        a = F.silu(x @ g[:, :Fd]) * (x @ g[:, Fd:])
        return (a if r is None else a * r) @ d

    nbytes = D * Fd + (D / 128) * 2 * Fd * 4 + Fd * dh + (Fd / 128) * D * 4 + 2.0 * B * 2 * D
    flops = 2.0 * B * D * 2 * Fd + 2.0 * B * Fd * D
    bms, bby = bound(flops, nbytes)
    turn = itertools.count()
    rows.append(dict(
        name="mlp_int4_stacked", route="cuda", source="audio_llama_tpu_torch/csrc/mlp_int4.cu",
        replaces="audio_llama_tpu/ops/mlp_int4.py:43", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, next(turn) % L,
                                                      chunk=chunk), iters=56),
        plain_ms=events_ms(lambda: mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li,
                                                             chunk=chunk), iters=5),
        library_ms=rotated_ms(mlp_library, n_rot),
        library_ms_hot=time_ms(lambda: (F.silu(x @ wg[:, :Fd]) * (x @ wg[:, Fd:])) @ wd,
                               iters=56),
        library_layers=n_rot,
        # the same kernel at the TPU kernel's chunk (the activations do not
        # depend on it; only the plain version's order of the down sum does)
        ms_at_tpu_chunk=time_ms(lambda: mlp4.mlp_int4_stacked_cuda(
            x, gup, gus, dn, dns, next(turn) % L, chunk=mlp4.pick_chunk(Fd)), iters=56),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"x[{B},{D}] bf16, gate|up [{L},{D},{Fd}], down [{L},{Fd},{dh}] int8, "
               f"chunk {chunk}",
        notes="library_ms: three matmuls and SiLU on dequantized bf16 layers, rotated over "
              "layers that exceed the L2 (library_ms_hot: one layer)",
        sm90=mlp4_sm90_report(),
    ))
    log(f"kernel mlp_int4_stacked ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")

    # 7r. the same kernel in its dn_r mode (smoothed trees): each layer's down
    #     equalizer from `_equalize_rows` of a seeded down slab with hot rows
    from audio_llama_tpu_torch.models.llama_int4 import _equalize_rows

    dn_r = torch.empty((L, Fd), device=dev)
    for layer in range(L):
        w = randn(Fd, D) * 0.02
        w[torch.randint(0, Fd, (8,), generator=gen, device=dev)] *= 8.0
        dn_r[layer] = _equalize_rows(w)[1]
    del w
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li, chunk=chunk, dn_r=dn_r)
    err, ratio = check_close("mlp_int4_stacked[dn_r]", mlp4.mlp_int4_stacked_cuda(
        x, gup, gus, dn, dns, li, chunk=chunk, dn_r=dn_r), want, frac)
    faults = {
        "dn_r ignored": must_reject(
            "mlp_int4_stacked[dn_r]", "dn_r ignored",
            mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, li, chunk=chunk), want, frac),
        "dn_r of the next layer": must_reject(
            "mlp_int4_stacked[dn_r]", "dn_r of the next layer",
            mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, li, chunk=chunk,
                                       dn_r=torch.roll(dn_r, -1, dims=0).contiguous()),
            want, frac)}
    r_bf = dn_r[li].to(bf)
    bms, bby = bound(flops, nbytes + 4.0 * Fd)
    rows.append(dict(
        name="mlp_int4_stacked[dn_r]", route="cuda",
        source="audio_llama_tpu_torch/csrc/mlp_int4.cu",
        replaces="audio_llama_tpu/ops/mlp_int4.py:43", mode="has_dnr=True (call :190)",
        max_abs_err=err, tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: mlp4.mlp_int4_stacked_cuda(x, gup, gus, dn, dns, next(turn) % L,
                                                      chunk=chunk, dn_r=dn_r), iters=56),
        plain_ms=events_ms(lambda: mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li,
                                                             chunk=chunk, dn_r=dn_r), iters=5),
        library_ms=rotated_ms(lambda i: mlp_library(i, r_bf), n_rot),
        library_ms_hot=time_ms(lambda: (F.silu(x @ wg[:, :Fd]) * (x @ wg[:, Fd:]) * r_bf) @ wd,
                               iters=56),
        library_layers=n_rot,
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"x[{B},{D}] bf16, gate|up [{L},{D},{Fd}], down [{L},{Fd},{dh}] int8, "
               f"dn_r [{L},{Fd}] f32, chunk {chunk}",
    ))
    log(f"kernel mlp_int4_stacked[dn_r] ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")
    del gup, gus, dn, dns, wg, wd, dropped, dn_r, r_bf, w_rot

    # 8. int4-KV decode attention: the last decode step of the int4 path
    Hkv, Hq, hd = lc.num_kv_heads, lc.num_heads, lc.head_dim
    S = KVCache.rounded_len(prefix + N_NEW)
    off = prefix + N_NEW - 2
    ckv = rand_bytes(L, B, Hkv, S, hd)
    ks, vs = rand_scales(L, B, Hkv, S), rand_scales(L, B, Hkv, S)
    q = randn(B, Hq, hd, dtype=bf)
    kvn, ksn, vsn = rand_bytes(B, Hkv, hd), rand_scales(B, Hkv), rand_scales(B, Hkv)
    kpos = torch.arange(S, device=dev)[None, :]
    scale = hd ** -0.5
    frac = ATOL_ROW_RMS_FRAC["decode_attention_quantized4_mono"]

    def attend(offsets, valid, cache=None, k_new=kvn, k_s=ksn, v_s=vsn, layer=li, fn=None):
        fn = fn or dm.decode_attention_q4_cuda
        c = ckv.clone() if cache is None else cache
        return fn(q, k_new, c, ks, vs, k_s, v_s, layer, offsets, valid, scale)

    results = {}
    for kind, offsets in (("scalar", torch.tensor(off, dtype=torch.int32, device=dev)),
                          ("[B]", torch.tensor([off - 3 * b for b in range(B)],
                                               dtype=torch.int32, device=dev))):
        valid = (kpos <= offsets.reshape(-1, 1)).to(torch.int32).expand(B, S).contiguous()
        got, gc = attend(offsets, valid)
        want, wc = attend(offsets, valid, fn=dm.decode_attention_q4_plain)
        results[kind] = check_close(f"decode_attention_quantized4_mono {kind}", got, want, frac)
        if not torch.equal(gc, wc):
            raise AssertionError(f"decode_attention_quantized4_mono {kind}: in-place append "
                                 "differs")
    offsets = torch.full((B,), off, dtype=torch.int32, device=dev)
    valid = (kpos <= offsets[:, None]).to(torch.int32)
    want = attend(offsets, valid, fn=dm.decode_attention_q4_plain)[0]
    not_off = valid.clone()
    not_off[:, off] = 0
    planted = {
        "slot offset+1 attended": dict(valid=(kpos <= off + 1).to(torch.int32).expand(B, S)
                                       .contiguous()),
        "slot offset not attended": dict(valid=not_off),
        "stale fresh row": dict(k_new=ckv[li, :, :, off].clone(),
                                k_s=ks[li, :, :, off].clone(), v_s=vs[li, :, :, off].clone()),
        # flipping bit 3 of every K nibble makes the offset-binary decode read
        # the bytes as signed K
        "K decoded as signed": dict(cache=ckv ^ 0x08, k_new=kvn ^ 0x08),
    }
    faults = {}
    for fault, kw in planted.items():
        kw.setdefault("valid", valid)
        faults[fault] = must_reject("decode_attention_quantized4_mono", fault,
                                    attend(offsets, **kw)[0], want, frac)
    err = max(e for e, _ in results.values())
    ratio = max(r for _, r in results.values())
    n_valid = off + 1
    nbytes = (B * Hkv * n_valid * (hd + 8.0) + 2.0 * 2 * B * Hq * hd + B * Hkv * (hd + 8.0)
              + 4.0 * B * S)
    flops = 4.0 * B * Hq * n_valid * hd
    bms, bby = bound(flops, nbytes)
    # library: SDPA on K/V dequantized to bf16 ahead of time (all layers)
    kd = ((ckv.to(torch.int32) & 0xF) - 8).to(bf) * ks[..., None].to(bf)
    vd = (ckv.to(torch.int32) >> 4).to(bf) * vs[..., None].to(bf)
    kd = kd.repeat_interleave(Hq // Hkv, dim=2)
    vd = vd.repeat_interleave(Hq // Hkv, dim=2)
    dmask = (valid != 0)[:, None, None, :]
    turn = itertools.count()

    def sdpa(layer):
        return F.scaled_dot_product_attention(q[:, :, None, :], kd[layer], vd[layer],
                                              attn_mask=dmask, scale=scale)

    rows.append(dict(
        name="decode_attention_quantized4_mono", route="cuda",
        source="audio_llama_tpu_torch/csrc/decode_attention_q4.cu",
        replaces="audio_llama_tpu/ops/decode_attention_mono.py:76", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: dm.decode_attention_q4_cuda(
            q, kvn, ckv, ks, vs, ksn, vsn, next(turn) % L, offsets, valid, scale), iters=112),
        plain_ms=events_ms(lambda: dm.decode_attention_q4_plain(
            q, kvn, ckv, ks, vs, ksn, vsn, next(turn) % L, offsets, valid, scale), iters=28),
        library_ms=time_ms(lambda: sdpa(next(turn) % L), iters=112),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"cache[{L},{B},{Hkv},{S},{hd}] int4 K|V, q[{B},{Hq},{hd}] bf16, "
               f"{n_valid} valid, scalar and [B] offsets",
    ))
    log(f"kernel decode_attention_quantized4_mono ok: max_abs_err={err:.3e} "
        f"tol_ratio={ratio:.3f} planted faults rejected: {faults}")
    return rows


def megakernel_case(dev, gen, fmt, L, Tk, off, cfg=None):
    """Arguments of `decode_megakernel` at the widths of `cfg` (the full
    model by default): seeded random int4 slabs and scales, LayerNorm scales
    near 1, a random int4 cache and scale slabs, the embedded token, the rope
    row at `off` and slots [0, off] valid. Every nibble is drawn from
    [-7, 7], the range the quantizers write: a nibble drawn from [-8, 7] has
    mean -1/2, and 28 layers of such weights grow one shared offset in every
    column of h that buries what attention adds."""
    from audio_llama_tpu_torch.ops.int4_matmul import pack_nibbles
    from audio_llama_tpu_torch.ops.rope import rope_for_config, rope_tables

    lc = (cfg or full_config()).llama
    D, Fd, Hq, Hkv, hd = (lc.hidden_size, lc.intermediate_size, lc.num_heads, lc.num_kv_heads,
                          lc.head_dim)

    def nibbles(*shape):
        return torch.randint(-7, 8, shape, generator=gen, device=dev, dtype=torch.int32)

    def rand_scales(*shape, lo=0.002, span=0.02):
        return torch.rand(shape, generator=gen, device=dev) * span + lo

    def rand_kv(*shape):  # K offset-binary in the low nibble, V signed in the high
        return pack_nibbles(nibbles(*shape), nibbles(*shape), "obin")

    slabs = [{"w_p": pack_nibbles(nibbles(L, K, N // 2), nibbles(L, K, N // 2), fmt),
              "w_s": rand_scales(L, K // 128, N, span=0.01)}
             for K, N in ((D, (Hq + 2 * Hkv) * hd), (Hq * hd, D), (D, 2 * Fd), (Fd, D))]
    lns = [(1 + 0.1 * torch.randn((L, D), generator=gen, device=dev)).to(torch.bfloat16)
           for _ in range(2)]
    cos, sin = rope_tables(torch.tensor([[off]], device=dev), rope_for_config(lc))
    return dict(
        x=(torch.randn((1, D), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
        qkv=slabs[0], o=slabs[1], gu=slabs[2], dn=slabs[3], input_ln=lns[0],
        post_attn_ln=lns[1], cos=cos[0, 0], sin=sin[0, 0],
        cache_kv=rand_kv(L, 1, Hkv, Tk, hd), k_scales=rand_scales(L, 1, Hkv, Tk, lo=0.4, span=0.6),
        v_scales=rand_scales(L, 1, Hkv, Tk, lo=0.4, span=0.6),
        offset=torch.tensor(off, dtype=torch.int32, device=dev),
        valid=(torch.arange(Tk, device=dev)[None, :] <= off).to(torch.int32),
        eps=lc.rms_norm_eps, scale=hd ** -0.5, fmt=fmt)


def mega_run(fn, case, **over):
    """fn (the kernel or the plain version) on a copy of the case's cache
    and scale slabs -> (hidden, cache, k_scales, v_scales, fresh)."""
    kw = _cache_copy({**case, **over})
    hidden, cache, fresh = fn(**kw)
    return hidden, cache, kw["k_scales"], kw["v_scales"], fresh


def _cache_copy(case):
    return {**case, **{k: case[k].clone() for k in ("cache_kv", "k_scales", "v_scales")}}


def layer_case(case, li, x):
    """Layer li of a megakernel case as a one-layer case with input x (views:
    the layer's appends land in the case's cache and scale slabs)."""
    out = {k: {n: t[li:li + 1] for n, t in case[k].items()} for k in ("qkv", "o", "gu", "dn")}
    out.update({k: case[k][li:li + 1]
                for k in ("input_ln", "post_attn_ln", "cache_kv", "k_scales", "v_scales")})
    return {**case, **out, "x": x}


def mega_layerwise(case, **fault):
    """The kernel launched one layer at a time on a copy of the case's cache,
    each layer fed the kernel's previous output, beside the plain version of
    the same layer on the same input and cache. A deep stack of random
    weights carries one bf16 rounding flip on and grows it, so the kernel is
    held to its plain version layer by layer, and the whole-stack launch to
    these launches bit for bit (`megakernel_checks`). `fault` overrides
    arguments of the kernel's launches only. -> (worst per-layer tol_ratio,
    max abs err, the kernel's (hidden, cache, k_scales, v_scales, fresh) and
    the plain version's, whose hidden is its last layer's output)."""
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    frac = ATOL_ROW_RMS_FRAC["decode_megakernel"]
    want_case, got_case = _cache_copy(case), _cache_copy({**case, **fault})
    x, worst, err, fresh = case["x"], 0.0, 0.0, ([], [])
    for li in range(case["cache_kv"].shape[0]):
        want, _, wf = mk.decode_megakernel_plain(**layer_case(want_case, li, x))
        x, _, gf = mk.decode_megakernel_cuda(**layer_case(got_case, li, x))
        worst = max(worst, tol_ratio(x, want, frac))
        err = max(err, (x.float() - want.float()).abs().max().item())
        fresh[0].append(gf)
        fresh[1].append(wf)
    return worst, err, *((h, c["cache_kv"], c["k_scales"], c["v_scales"], torch.cat(f))
                         for h, c, f in ((x, got_case, fresh[0]), (want, want_case, fresh[1])))


def megakernel_faults(case):
    """The planted faults of the megakernel check (run through the kernel)
    -> {fault: worst per-layer tol_ratio}: the fresh row not attended, slot
    offset + 1 attended, and one layer's down residual skipped (its scales
    zeroed)."""
    off = int(case["offset"])
    Tk = case["valid"].shape[1]
    kpos = torch.arange(Tk, device=case["valid"].device)[None, :]
    not_off = case["valid"].clone()
    not_off[:, off] = 0
    dn = dict(case["dn"])
    dn["w_s"] = dn["w_s"].clone()
    dn["w_s"][dn["w_s"].shape[0] // 2] = 0
    planted = {
        "fresh row not attended": dict(valid=not_off),
        "slot offset+1 attended": dict(valid=(kpos <= off + 1).to(torch.int32)),
        "one layer's down residual skipped": dict(dn=dn),
    }
    out = {}
    for fault, kw in planted.items():
        ratio = mega_layerwise(case, **kw)[0]
        if not ratio > FAULT_MARGIN:
            raise AssertionError(f"decode_megakernel: the planted fault '{fault}' lands at "
                                 f"{ratio:.3f} of the bar, not above {FAULT_MARGIN}")
        out[fault] = ratio
    return out


def megakernel_checks(dev, gen):
    """The decode megakernel at the full model's widths against its plain
    version (both pack formats) at the B = 1 path's last decode step (offset
    1556 of 1568 slots): layer by layer, and the whole-stack launch against
    its layers launched one by one, bit for bit. Then 4 layers at offset 2,
    where one slot carries a third of the attention, on planted faults."""
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    cfg = full_config()
    lc = cfg.llama
    L, hd, Hkv = lc.num_layers, lc.head_dim, lc.num_kv_heads
    prefix = cfg.audio_seq_len + 2 + PROMPT
    Tk = _rounded_len(prefix + N_NEW)
    frac = ATOL_ROW_RMS_FRAC["decode_megakernel"]
    results, faults, cache_flips, scale_err = {}, {}, {}, 0.0
    for fmt in ("pair", "obin"):
        case = megakernel_case(dev, gen, fmt, L, Tk, prefix + N_NEW - 2)
        ratio, err, got, want = mega_layerwise(case)
        if ratio > 1:
            raise AssertionError(f"decode_megakernel {fmt}: a layer is outside tolerance "
                                 f"(ratio {ratio:.3f}); max_abs_err={err:.3e}")
        results[fmt] = (err, ratio)
        stack = mega_run(mk.decode_megakernel_cuda, case)
        if not all(torch.equal(a, b) for a, b in zip(stack, got)):
            raise AssertionError(f"decode_megakernel {fmt}: the one-launch stack differs from "
                                 "its layers launched one by one")
        # the appended rows: nibbles within +-1 of the plain version's on under
        # 1% of their bytes (an ulp can flip a rounding), the rest untouched;
        # the fresh scales within a bf16 rounding of the row's absmax
        gc, wc = got[1].to(torch.int32), want[1].to(torch.int32)
        d = ((gc & 0xF) - (wc & 0xF)).abs() + ((gc >> 4) - (wc >> 4)).abs()
        flips = (d > 0).float().mean().item() * Tk  # share of the appended rows' bytes
        if d.max() > 2 or flips >= 0.01:
            raise AssertionError(f"decode_megakernel {fmt}: cache rows differ ({flips:.4f})")
        cache_flips[fmt] = flips
        for g, w in zip(got[2:], want[2:]):
            scale_err = max(scale_err, ((g - w).abs() / w.abs()).max().item())
        if scale_err > 2.0 ** -7:
            raise AssertionError(f"decode_megakernel {fmt}: fresh scales differ ({scale_err})")
        short = megakernel_case(dev, gen, fmt, 4, Tk, 2)
        ratio = mega_layerwise(short)[0]
        if ratio > 1:
            raise AssertionError(f"decode_megakernel {fmt} offset 2: outside tolerance "
                                 f"(ratio {ratio:.3f})")
        faults.update({f"{fmt}: {k}": v for k, v in megakernel_faults(short).items()})
        if fmt == "pair":
            timed = case
        del short, got, want, stack
    case = timed
    slab_bytes = sum(w["w_p"].numel() + 4.0 * w["w_s"].numel()
                     for w in (case["qkv"], case["o"], case["gu"], case["dn"]))
    n_valid = prefix + N_NEW - 1
    nbytes = (slab_bytes + L * Hkv * n_valid * (hd + 8.0) + 2.0 * 2 * L * lc.hidden_size
              + L * Hkv * (hd + 16.0) + 4.0 * Tk + 2.0 * 2 * lc.hidden_size)
    flops = 2.0 * L * (lc.hidden_size * (lc.num_heads + 2 * Hkv) * hd + lc.num_heads * hd
                       * lc.hidden_size + 3.0 * lc.hidden_size * lc.intermediate_size
                       + 2.0 * lc.num_heads * n_valid * hd)
    bms, bby = bound(flops, nbytes)

    def run(**over):
        return mk.decode_megakernel_cuda(**{**case, **over})

    row = dict(
        name="decode_megakernel", route="cuda",
        source="audio_llama_tpu_torch/csrc/decode_megakernel.cu",
        replaces="audio_llama_tpu/ops/decode_megakernel.py:84",
        max_abs_err=max(e for e, _ in results.values()), tol=tol_entry(frac),
        tol_ratio=max(r for _, r in results.values()), planted_fault_ratios=faults,
        cache_byte_flip_share=cache_flips, fresh_scale_rel_err=scale_err,
        ms=time_ms(run, iters=10), plain_ms=events_ms(lambda: mk.decode_megakernel_plain(**case),
                                                    iters=1, warmup=1),
        library_ms=None,  # no one PyTorch call computes a decoder step
        barriers_only_ms=time_ms(lambda: run(barriers_only=True), iters=10),
        grid_barriers=5 * L - 1, launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"x[1,{lc.hidden_size}] bf16, {L} layers of fused int4 slabs, cache "
               f"[{L},1,{Hkv},{Tk},{hd}] int4 K|V, {n_valid} valid, pair and obin",
    )
    log(f"kernel decode_megakernel ok: {json.dumps(row)}")
    return row


def q8_kernel_checks(dev, gen):
    """int8-KV decode attention at the int8 path's last decode step (B = 4,
    cache [28, 4, 8, 1568, 128] int8 twice), scalar and [B] offsets."""
    import torch.nn.functional as F

    from audio_llama_tpu_torch.ops import decode_attention_mono as dm

    lc = full_config().llama
    L, B, Hkv, Hq, hd = lc.num_layers, len(INT4_PROMPTS), lc.num_kv_heads, lc.num_heads, \
        lc.head_dim
    prefix = full_config().audio_seq_len + 2 + max(INT4_PROMPTS)
    S = _rounded_len(prefix + N_NEW)
    off = prefix + N_NEW - 2
    bf = torch.bfloat16

    def rand_bytes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int32
                             ).to(torch.int8)

    def rand_scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.002 + 0.0002

    ck, cv = rand_bytes(L, B, Hkv, S, hd), rand_bytes(L, B, Hkv, S, hd)
    ks, vs = rand_scales(L, B, Hkv, S), rand_scales(L, B, Hkv, S)
    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(bf)
    kn, vn = rand_bytes(B, Hkv, hd), rand_bytes(B, Hkv, hd)
    ksn, vsn = rand_scales(B, Hkv), rand_scales(B, Hkv)
    kpos = torch.arange(S, device=dev)[None, :]
    scale, li = hd ** -0.5, min(5, L - 1)
    frac = ATOL_ROW_RMS_FRAC["decode_attention_quantized_mono"]

    def attend(offsets, valid, k_new=kn, v_new=vn, k_s=ksn, v_s=vsn, fn=None):
        fn = fn or dm.decode_attention_q8_cuda
        return fn(q, k_new, v_new, ck.clone(), cv.clone(), ks, vs, k_s, v_s, li, offsets, valid,
                  scale)

    results = {}
    for kind, offsets in (("scalar", torch.tensor(off, dtype=torch.int32, device=dev)),
                          ("[B]", torch.tensor([off - 3 * b for b in range(B)],
                                               dtype=torch.int32, device=dev))):
        valid = (kpos <= offsets.reshape(-1, 1)).to(torch.int32).expand(B, S).contiguous()
        got, gk, gv = attend(offsets, valid)
        want, wk, wv = attend(offsets, valid, fn=dm.decode_attention_q8_plain)
        results[kind] = check_close(f"decode_attention_quantized_mono {kind}", got, want, frac)
        if not (torch.equal(gk, wk) and torch.equal(gv, wv)):
            raise AssertionError(f"decode_attention_quantized_mono {kind}: append differs")
    # planted faults early in a request (offset 40), where one slot of 41
    # carries weight; the same check must reject each by FAULT_MARGIN
    short = 40
    offsets = torch.full((B,), short, dtype=torch.int32, device=dev)
    valid = (kpos <= offsets[:, None]).to(torch.int32)
    want = attend(offsets, valid, fn=dm.decode_attention_q8_plain)[0]
    check_close("decode_attention_quantized_mono offset 40", attend(offsets, valid)[0], want,
                frac)
    not_off = valid.clone()
    not_off[:, short] = 0
    planted = {
        "slot offset+1 attended": dict(valid=(kpos <= short + 1).to(torch.int32).expand(B, S)
                                       .contiguous()),
        "slot offset not attended": dict(valid=not_off),
        "stale fresh row": dict(k_new=ck[li, :, :, short].clone(),
                                v_new=cv[li, :, :, short].clone(),
                                k_s=ks[li, :, :, short].clone(), v_s=vs[li, :, :, short].clone()),
        "stale append scale": dict(k_s=ks[li, :, :, short].clone(),
                                   v_s=vs[li, :, :, short].clone()),
    }
    faults = {}
    for fault, kw in planted.items():
        kw.setdefault("valid", valid)
        faults[fault] = must_reject("decode_attention_quantized_mono", fault,
                                    attend(offsets, **kw)[0], want, frac, FAULT_MARGIN)
    offsets = torch.full((B,), off, dtype=torch.int32, device=dev)
    valid = (kpos <= offsets[:, None]).to(torch.int32)
    n_valid = off + 1
    nbytes = (B * Hkv * n_valid * (2 * hd + 8.0) + 2.0 * 2 * B * Hq * hd
              + B * Hkv * (2 * hd + 8.0) + 4.0 * B * S)
    flops = 4.0 * B * Hq * n_valid * hd
    bms, bby = bound(flops, nbytes)
    # library: SDPA on K/V dequantized to bf16 ahead of time (all layers)
    kd = (ck.to(bf) * ks[..., None].to(bf)).repeat_interleave(Hq // Hkv, dim=2)
    vd = (cv.to(bf) * vs[..., None].to(bf)).repeat_interleave(Hq // Hkv, dim=2)
    dmask = (valid != 0)[:, None, None, :]
    turn = itertools.count()

    def sdpa(layer):
        return F.scaled_dot_product_attention(q[:, :, None, :], kd[layer], vd[layer],
                                              attn_mask=dmask, scale=scale)

    row = dict(
        name="decode_attention_quantized_mono", route="cuda",
        source="audio_llama_tpu_torch/csrc/decode_attention_q4.cu",
        replaces="audio_llama_tpu/ops/decode_attention_mono.py:407",
        max_abs_err=max(e for e, _ in results.values()), tol=tol_entry(frac),
        tol_ratio=max(r for _, r in results.values()), planted_fault_ratios=faults,
        ms=time_ms(lambda: dm.decode_attention_q8_cuda(
            q, kn, vn, ck, cv, ks, vs, ksn, vsn, next(turn) % L, offsets, valid, scale),
            iters=112),
        plain_ms=events_ms(lambda: dm.decode_attention_q8_plain(
            q, kn, vn, ck, cv, ks, vs, ksn, vsn, next(turn) % L, offsets, valid, scale),
            iters=28),
        library_ms=time_ms(lambda: sdpa(next(turn) % L), iters=112),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"caches[{L},{B},{Hkv},{S},{hd}] int8 K and V, q[{B},{Hq},{hd}] bf16, "
               f"{n_valid} valid, scalar and [B] offsets",
    )
    log(f"kernel decode_attention_quantized_mono ok: {json.dumps(row)}")
    return row


def _rounded_len(n: int) -> int:
    from audio_llama_tpu_torch.models.llama import KVCache

    return KVCache.rounded_len(n)


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phase 3: the bf16 main path at full width
# ---------------------------------------------------------------------------

# the path whose launches each kernel's row reports (the int4 path otherwise)
KERNEL_PATH = {
    "layer_norm": "bf16", "enc_attention": "bf16", "causal_attention": "bf16",
    "decode_attention_mono": "bf16", "decode_megakernel": "b1",
    "decode_attention_quantized_mono": "int8",
    "causal_attention_dq": "train", "causal_attention_dkv": "train",
    "decode_attention_db_stats": "sp_bf16", "decode_attention_quantized_db_stats": "sp_int8",
    "decode_attention_quantized4_db_stats": "sp_int4",
    "causal_attention_never": "sp_train", "causal_attention_dq_never": "sp_train",
    "causal_attention_dkv_never": "sp_train",
    "decode_attention_db": "ab_db_bf16", "decode_attention_quantized_db": "ab_db_int8",
    "decode_attention_quantized4_db": "ab_db_int4", "decode_attention_packed": "ab_packed_int8",
    "enc_attention_v3q": "enc8_v3q", "enc_attention_bounded": "enc8_bounded",
    "enc_attention_twopass": "enc8_twopass",
    "causal_attention_cond": "causal_variants", "causal_attention_bounded": "causal_variants",
    "causal_attention_twopass": "causal_variants", "causal_attention_dma": "causal_variants",
    "causal_attention_dma2": "causal_variants", "int4_matmul_stacked_ksplit": "int4_ksplit",
    "decode_attention": "single_decode", "decode_attention_quantized": "single_decode",
    "int4_matmul": "int4_2d", "mlp_int4_stacked[dn_r]": "smooth",
}
# a row whose kernel serves several counters (its cache formats, its modes) sums them
ROW_COUNTERS = {"decode_attention_packed": ("decode_attention_packed",
                                            "decode_attention_quantized_packed"),
                "causal_attention_bounded": ("causal_attention_bounded",
                                             "causal_attention_bounded_cond")}

AUDIO_START, AUDIO_END, EOS = 128256, 128257, 128001  # resized vocab rows; Llama-3 <|end_of_text|>
N_NEW, PROMPT = 32, 24


def path_profile(run, label: str) -> None:
    """torch.profiler breakdown of run(1) (encode + prefill + first token)
    and, by difference with run(9), of one decode token."""
    n = 9
    prefill = device_profile(lambda: run(1))
    whole = device_profile(lambda: run(n))
    decode = {k: (whole["by_group_ms"].get(k, 0.0) - v) / (n - 1)
              for k, v in prefill["by_group_ms"].items()}
    for k, v in whole["by_group_ms"].items():
        decode.setdefault(k, v / (n - 1))
    log(json.dumps({"profile": {
        "path": label,
        "encode_prefill_first_token": prefill,
        "decode_per_token_by_group_ms": decode,
        "decode_per_token_wall_ms": (whole["wall_ms"] - prefill["wall_ms"]) / (n - 1),
        "decode_per_token_device_ms": (whole["device_ms"] - prefill["device_ms"]) / (n - 1),
        "decode_per_token_device_launches":
            (whole["device_launches"] - prefill["device_launches"]) / (n - 1),
    }}))


def check_tokens(label, toks, shape, V):
    if tuple(toks.shape) != shape or not bool(((toks >= 0) & (toks < V)).all()):
        raise AssertionError(f"{label}: bad tokens {toks.tolist()}")


def bf16_request(dev):
    """The bf16 path's model and request: seeded bf16 weights at full width
    with f32 LoRA masters, a 30 s log-mel clip and a 24-token prompt ->
    (cfg, frozen, trainable, ids, mask, mel, run), run(n, greedy=True,
    g=None) calling `generate` for n new tokens."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm, llama

    cfg = full_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    t0 = time.perf_counter()
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.float32)  # f32 masters
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in frozen.parameters())
    log(f"main: {n_params / 1e9:.3f} B frozen params on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    mel = torch.randn((1, cfg.whisper.num_mel_bins, cfg.mel.num_frames), generator=gen,
                      device=dev)
    ids = torch.randint(0, cfg.llama.vocab_size, (1, PROMPT), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev)

    def run(n, greedy=True, g=None):
        return generate(frozen, trainable, cfg, ids, mask, mel, g, max_new_tokens=n,
                        greedy=greedy, temperature=0.7, top_p=0.9, **kw)

    return cfg, frozen, trainable, ids, mask, mel, run


def main_path(dev, profile: bool = False):
    from audio_llama_tpu_torch.models import allm

    cfg, frozen, trainable, ids, mask, mel, run = bf16_request(dev)
    run(2)  # warm-up: library handles, allocator
    enc_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, mel)) for _ in range(3))
    first_ms = min(synced_ms(lambda: run(1)) for _ in range(3))

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("greedy", run(N_NEW)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    greedy = result["greedy"]
    V = cfg.llama.vocab_size + 2
    toks = greedy.tokens
    check_tokens("main greedy", toks, (1, N_NEW), V)
    again = run(N_NEW)
    if not torch.equal(again.tokens, toks):
        raise AssertionError("main: greedy decoding is not deterministic")
    want = {
        "layer_norm": 2 * cfg.whisper.num_layers,
        "enc_attention": cfg.whisper.num_layers,
        "causal_attention": cfg.llama.num_layers,
        "decode_attention_mono": cfg.llama.num_layers * (N_NEW - 1),
    }
    for name, n in want.items():
        if launches[name] < n:
            raise AssertionError(f"main: {name} launched {launches[name]} times, want >= {n}")

    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    sampled = run(N_NEW, greedy=False, g=g2).tokens
    check_tokens("main sampled", sampled, (1, N_NEW), V)

    stats = {
        "config": "Llama-3.2-3B (28 layers, vocab 128256+2) + Whisper-large-v3-turbo encoder "
                  "(32 layers) + LoRA r64, bf16, seeded random weights",
        "batch": 1, "prompt_tokens": PROMPT, "audio_frames": cfg.mel.num_frames,
        "prefix_tokens": cfg.audio_seq_len + 2 + PROMPT, "new_tokens": N_NEW,
        "encode_ms": enc_ms,
        "prefill_ms": first_ms - enc_ms,  # project + splice + prefill + first token
        "decode_ms_per_token": (total_ms - first_ms) / (N_NEW - 1),
        "generate_ms": total_ms, "peak_mem_gb": peak_gb,
        "greedy_tokens": toks[0].tolist(), "num_generated": int(greedy.num_generated[0]),
        "sampled_tokens": sampled[0].tolist(), "launches": launches,
    }
    log(json.dumps({"main_path": stats}))
    if profile:
        path_profile(run, "bf16, B=1")
    L = cfg.llama.num_layers
    ab = decode_ab_path(
        dict(model=(cfg, frozen, trainable), ids=ids, mask=mask, audio=mel, kv_quant=False,
             config=stats["config"]),
        [("ab_db_bf16", "decode_kernel, bf16 KV, B=1", "decode_kernel",
          {"decode_attention_db": L * (N_NEW - 1), "decode_attention_mono": 0,
           "decode_megakernel": 0})])
    enc8_dispatch(dict(model=(cfg, frozen, trainable), ids=ids, mask=mask, audio=mel))
    return launches, ab


# ---------------------------------------------------------------------------
# phases 4 and 5: the int4 path at full width, then the inference CLI on it
# ---------------------------------------------------------------------------

def int4_model(gen, cfg, bits=4, rotate=False):
    """Seeded bf16 weights with a non-zero LoRA r64 delta, merged, rotated
    with `rotate` (a generator seeded 7, as the CLI's --rotate) and quantized
    on the card to the fused int4 tree (`pair`, bits 4) or the int8 tree
    (bits 8), as the CLI's --int4_decoder / --int8_decoder do -> (frozen,
    trainable without LoRA)."""
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.models import allm, llama

    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.float32)
    for br in trainable["lora"]["layers"].values():  # 'ref' init has a = 0
        br["a"].data.copy_(torch.randn(br["a"].shape, generator=gen, device=br["a"].device)
                           * 0.02)
    return cli.quantize_decoder(cfg, frozen, trainable, bits=bits, rotate=rotate)


def int4_request(dev, b1: bool = False):
    """The int4 paths' model and request: int4_path's (B = 4, the fused int4
    tree, four 30 s waveforms, prompts of INT4_PROMPTS tokens right-padded;
    seed 11) or, with b1, b1_path's (B = 1, the tree rotated, one 30 s
    waveform, a PROMPT-token prompt; seed 13) -> (cfg, frozen, trainable,
    ids, mask, wav, run, gen), run(n, greedy=True, g=None, megakernel=True)
    calling `generate` for n new tokens with the int4 KV cache, gen the
    generator that made them."""
    from audio_llama_tpu_torch.inference.generate import generate

    cfg = full_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(13 if b1 else 11)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg, rotate=b1)
    torch.cuda.synchronize()
    log(f"{'b1' if b1 else 'int4'}: LoRA merged and the decoder "
        f"{'rotated and ' if b1 else ''}quantized on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    B = 1 if b1 else len(INT4_PROMPTS)
    wav = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    if b1:
        ids = torch.randint(0, cfg.llama.vocab_size, (1, PROMPT), generator=gen, device=dev)
        mask = torch.ones_like(ids)
    else:
        ids = torch.randint(0, cfg.llama.vocab_size, (B, max(INT4_PROMPTS)), generator=gen,
                            device=dev)
        mask = torch.zeros_like(ids)
        for b, n in enumerate(INT4_PROMPTS):
            mask[b, :n] = 1
        ids = ids * mask  # right-padded with pad id 0
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=4)

    def run(n, greedy=True, g=None, megakernel=True):
        return generate(frozen, trainable, cfg, ids, mask, wav, g, max_new_tokens=n,
                        greedy=greedy, temperature=0.7, top_p=0.9, megakernel=megakernel, **kw)

    return cfg, frozen, trainable, ids, mask, wav, run, gen


def int4_path(dev, profile: bool = False):
    from audio_llama_tpu_torch.models import allm

    cfg, frozen, trainable, ids, mask, wav, run, gen = int4_request(dev)
    B = len(INT4_PROMPTS)
    run(2)
    enc_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, wav))
                 for _ in range(3))
    first_ms = min(synced_ms(lambda: run(1)) for _ in range(3))
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("greedy", run(N_NEW)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    V = cfg.llama.vocab_size + 2
    toks = result["greedy"].tokens
    check_tokens("int4 greedy", toks, (B, N_NEW), V)
    if not torch.equal(run(N_NEW).tokens, toks):
        raise AssertionError("int4: greedy decoding is not deterministic")
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    want = {
        "mel_power": 1, "layer_norm": 2 * W, "enc_attention": W, "causal_attention": L,
        "int4_matmul_stacked": 4 * L + 2 * L * (N_NEW - 1),
        "mlp_int4_stacked": L * (N_NEW - 1),
        "decode_attention_quantized4_mono": L * (N_NEW - 1),
        "decode_attention_mono": 0,
    }
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"int4: {name} launched {launches[name]} times, want {n}")
    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    sampled = run(N_NEW, greedy=False, g=g2).tokens
    check_tokens("int4 sampled", sampled, (B, N_NEW), V)

    from audio_llama_tpu_torch.models import llama

    hidden = torch.randn((B, 1, cfg.llama.hidden_size), generator=gen, device=dev).to(
        torch.bfloat16)
    stats = {
        "label": "int4w+kv4, B=4",
        "config": "Llama-3.2-3B (28 layers, vocab 128256+2, fused int4 tree, pair, LoRA r64 "
                  "merged) + Whisper-large-v3-turbo encoder (32 layers), bf16 compute, int4 "
                  "KV cache, seeded random weights",
        "batch": B, "prompt_tokens": list(INT4_PROMPTS), "audio_samples": cfg.mel.max_samples,
        "prefix_tokens": cfg.audio_seq_len + 2 + max(INT4_PROMPTS), "new_tokens": N_NEW,
        "encode_ms": enc_ms, "prefill_ms": first_ms - enc_ms,
        "decode_ms_per_token": (total_ms - first_ms) / (N_NEW - 1),
        "generate_ms": total_ms, "peak_mem_gb": peak_gb,
        # the int8 table's unembed: cast to bf16, then one bf16 x bf16 -> f32 product
        "unembed_ms_per_step": time_ms(
            lambda: llama.unembed(frozen["llama"], cfg.llama, hidden, torch.bfloat16), iters=10),
        "greedy_tokens": toks.tolist(), "sampled_tokens": sampled.tolist(),
        "launches": launches,
    }
    log(json.dumps({"int4_path": stats}))
    if profile:
        path_profile(run, "int4w+kv4, B=4")
    return launches, (cfg, frozen, trainable), dict(ids=ids, mask=mask, wav=wav)


def cli_path(dev, model) -> None:
    """`inference.cli.generate_response` on a seeded 12 s, 44.1 kHz stereo
    16-bit WAV (mixdown, resample to 16 kHz, padding to 30 s), full width,
    int4 tree, int4 KV, greedy, 16 tokens, B = 1: its tokens must equal
    `generate`'s on `cli.process_audio` of the same file."""
    import tempfile

    from audio_llama_tpu_torch.data import audio_io
    from audio_llama_tpu_torch.data.tokenizer import ByteTokenizer
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.inference.generate import generate

    cfg, frozen, trainable = model
    tk = ByteTokenizer()
    sr, seconds, n_new = 44100, 12.0, 16
    rng = np.random.default_rng(5)
    t = np.arange(int(sr * seconds)) / sr
    stereo = np.stack([0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=t.shape),
                       0.2 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=t.shape)],
                      axis=1).astype(np.float32)
    prompt = "Transcribe the audio."
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/clip.wav"
        audio_io.write_wav(path, stereo, sr)
        zero_counters()
        t0 = time.perf_counter()
        text, tokens = cli.generate_response(cfg, frozen, trainable, tk, prompt, audio_path=path,
                                             max_new_tokens=n_new, greedy=True, kv_quant=4,
                                             device=dev, return_tokens=True)
        cli_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counters()
        wav = cli.process_audio(path, cfg.mel)
    ids, mask = tk.encode(prompt)
    want = generate(frozen, trainable, cfg, ids[None], mask[None], wav, max_new_tokens=n_new,
                    greedy=True, eos_id=tk.eos_id, pad_id=tk.pad_id,
                    audio_start_id=tk.token_to_id(cfg.audio_start_token),
                    audio_end_id=tk.token_to_id(cfg.audio_end_token),
                    compute_dtype=torch.bfloat16, kv_quant=4, device=dev)
    if not torch.equal(tokens, want.tokens):
        raise AssertionError(f"cli: tokens {tokens.tolist()} != generate's "
                             f"{want.tokens.tolist()}")
    # B = 1 on the fused int4 tree with an int4 cache: every decode step is
    # one megakernel launch, and no per-layer decode kernel runs
    per_layer = launches["mlp_int4_stacked"] + launches["decode_attention_quantized4_mono"]
    if launches["decode_megakernel"] != n_new - 1 or per_layer:
        raise AssertionError(f"cli: launches {launches}")
    nonzero = float(np.abs(wav).max())
    tail = float(np.abs(wav[0, int(seconds * cfg.mel.sample_rate) + 16:]).max(initial=0.0))
    if wav.shape != (1, cfg.mel.max_samples) or nonzero == 0 or tail != 0:
        raise AssertionError(f"cli: processed audio {wav.shape}, max {nonzero}, tail {tail}")
    log(json.dumps({"cli_path": {"wav": f"{seconds} s, {sr} Hz, stereo, 16-bit",
                                 "new_tokens": n_new, "tokens": tokens[0].tolist(),
                                 "text": text, "wall_ms": cli_ms,
                                 "megakernel_launches": launches["decode_megakernel"],
                                 "tokens_equal_generate": True}}))


def logit_trail(frozen, trainable, cfg, ids, mask, wav, tokens, megakernel, kv_quant=4):
    """Prefill one request, then feed it `tokens` (teacher-forced) one decode
    step at a time -> the f32 logits of every step: the prefill's last
    position (the logits token 0 is taken from), then each decode step's."""
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import llama

    dev = ids.device
    embeds, m = build_prefix(frozen, trainable, cfg, ids, mask, wav, AUDIO_START, AUDIO_END,
                             torch.bfloat16)
    P, n = embeds.shape[1], tokens.shape[1]
    full_mask = torch.cat([m, torch.ones((1, n), dtype=m.dtype, device=dev)], dim=1)
    cache = llama.KVCache.zeros(cfg.llama, 1, P + n, device=dev, quantized=kv_quant)
    _, cache, hidden = llama.llama_forward(frozen["llama"], cfg.llama, inputs_embeds=embeds,
                                           attention_mask=full_mask, kv_cache=cache,
                                           assume_fresh_cache=True, return_hidden=True,
                                           unembed_logits=False)
    last = int(m[0].sum()) - 1
    trail = [llama.unembed_with_tp(frozen["llama"], cfg.llama, hidden[:, last:last + 1],
                                   torch.bfloat16, None)[0, 0].float()]
    for i in range(n - 1):
        logits, cache = llama.llama_forward(
            frozen["llama"], cfg.llama, input_ids=tokens[:, i:i + 1], attention_mask=full_mask,
            positions=torch.full((1, 1), P + i, device=dev), kv_cache=cache,
            megakernel=megakernel)
        trail.append(logits[0, 0].float())
    return trail


def b1_path(dev, profile: bool = False):
    """int4w+kv4, B = 1: one 30 s waveform, a 24-token prompt, 32 greedy
    tokens; LoRA merged, the full-width tree rotated (QuaRot, a generator
    seeded 7) and quantized on the card, as the CLI's --int4_decoder --rotate
    does. Every decode step is one megakernel launch. Then the same request
    with the megakernel off: decode time, and logits step by step."""
    from audio_llama_tpu_torch.models import allm

    cfg, frozen, trainable, ids, mask, wav, run, _ = int4_request(dev, b1=True)
    run(2)
    run(2, megakernel=False)
    enc_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, wav))
                 for _ in range(3))
    first_ms = min(synced_ms(lambda: run(1)) for _ in range(3))
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("greedy", run(N_NEW)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    V = cfg.llama.vocab_size + 2
    toks = result["greedy"].tokens
    check_tokens("b1 greedy", toks, (1, N_NEW), V)
    if not torch.equal(run(N_NEW).tokens, toks):
        raise AssertionError("b1: greedy decoding is not deterministic")
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    want = {
        "mel_power": 1, "layer_norm": 2 * W, "enc_attention": W, "causal_attention": L,
        "int4_matmul_stacked": 4 * L,  # prefill only
        "decode_megakernel": N_NEW - 1,
        "mlp_int4_stacked": 0, "decode_attention_quantized4_mono": 0,
        "decode_attention_quantized_mono": 0, "decode_attention_mono": 0,
    }
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"b1: {name} launched {launches[name]} times, want {n}")

    # the same request with the megakernel off (the per-layer kernels)
    first_off = min(synced_ms(lambda: run(1, megakernel=False)) for _ in range(2))
    total_off = synced_ms(lambda: result.setdefault("off", run(N_NEW, megakernel=False)))
    trails = [logit_trail(frozen, trainable, cfg, ids, mask, wav, toks, mega)
              for mega in (True, False)]
    steps = [compare_logits(f"b1 megakernel vs per-layer, step {i}", a, b)
             for i, (a, b) in enumerate(zip(*trails))]
    g2 = torch.Generator(device=dev)
    g2.manual_seed(7)
    sampled = run(N_NEW, greedy=False, g=g2).tokens
    check_tokens("b1 sampled", sampled, (1, N_NEW), V)
    stats = {
        "label": "int4w+kv4, B=1",
        "config": "Llama-3.2-3B (28 layers, vocab 128256+2, LoRA r64 merged, QuaRot-rotated, "
                  "fused int4 tree, pair) + Whisper-large-v3-turbo encoder (32 layers), bf16 "
                  "compute, int4 KV cache, seeded random weights",
        "batch": 1, "prompt_tokens": PROMPT, "audio_samples": cfg.mel.max_samples,
        "prefix_tokens": cfg.audio_seq_len + 2 + PROMPT, "new_tokens": N_NEW,
        "encode_ms": enc_ms, "prefill_ms": first_ms - enc_ms,
        "decode_ms_per_token": (total_ms - first_ms) / (N_NEW - 1),
        "generate_ms": total_ms, "peak_mem_gb": peak_gb,
        "megakernel_off": {"decode_ms_per_token": (total_off - first_off) / (N_NEW - 1),
                           "generate_ms": total_off,
                           "tokens_equal": bool(torch.equal(result["off"].tokens, toks))},
        "logits_vs_per_layer": {"steps": len(steps),
                                "max_rel_l2": max(st["rel_l2"] for st in steps),
                                "argmax_agree": all(st["argmax_agree"] for st in steps)},
        # the gap between the two largest logits at each greedy step: a token
        # whose margin is within the kernels' rounding may part from another
        # build's (random weights leave the logits nearly flat)
        "top2_margin_per_step": [float(t[0] - t[1]) for t in
                                 (lg.topk(2).values for lg in trails[0])],
        "greedy_tokens": toks.tolist(), "sampled_tokens": sampled.tolist(),
        "launches": launches,
    }
    log(json.dumps({"b1_path": stats}))
    path_profile(run, "int4w+kv4, B=1 (megakernel)")
    if profile:
        path_profile(lambda n: run(n, megakernel=False), "int4w+kv4, B=1 (per-layer)")
    ab = decode_ab_path(
        dict(model=(cfg, frozen, trainable), ids=ids, mask=mask, audio=wav, kv_quant=4,
             config=stats["config"]),
        [("ab_db_int4", "decode_kernel, int4w+kv4, B=1", "decode_kernel",
          {"decode_attention_quantized4_db": L * (N_NEW - 1), "decode_megakernel": 0,
           "decode_attention_quantized4_mono": 0, "mlp_int4_stacked": L * (N_NEW - 1)})])
    return launches, ab


def int8_path(dev, profile: bool = False):
    """int8w+kv8, B = 4: four 30 s waveforms with the int4 path's prompts,
    LoRA merged and the decoder quantized on the card to the weight-only
    int8 tree (the CLI's --int8_decoder), an int8 KV cache (--kv_quant), 32
    greedy tokens."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm

    cfg = full_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg, bits=8)
    torch.cuda.synchronize()
    log(f"int8: LoRA merged and the decoder quantized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    B = len(INT4_PROMPTS)
    wav = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (B, max(INT4_PROMPTS)), generator=gen,
                        device=dev)
    mask = torch.zeros_like(ids)
    for b, n in enumerate(INT4_PROMPTS):
        mask[b, :n] = 1
    ids = ids * mask
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=True)

    def run(n, greedy=True, g=None):
        return generate(frozen, trainable, cfg, ids, mask, wav, g, max_new_tokens=n,
                        greedy=greedy, temperature=0.7, top_p=0.9, **kw)

    run(2)
    enc_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, wav))
                 for _ in range(3))
    first_ms = min(synced_ms(lambda: run(1)) for _ in range(3))
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("greedy", run(N_NEW)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = result["greedy"].tokens
    check_tokens("int8 greedy", toks, (B, N_NEW), cfg.llama.vocab_size + 2)
    if not torch.equal(run(N_NEW).tokens, toks):
        raise AssertionError("int8: greedy decoding is not deterministic")
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    want = {
        "mel_power": 1, "layer_norm": 2 * W, "enc_attention": W, "causal_attention": L,
        "decode_attention_quantized_mono": L * (N_NEW - 1),
        "int4_matmul_stacked": 0, "mlp_int4_stacked": 0, "decode_megakernel": 0,
        "decode_attention_quantized4_mono": 0, "decode_attention_mono": 0,
    }
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"int8: {name} launched {launches[name]} times, want {n}")
    stats = {
        "label": "int8w+kv8, B=4",
        "config": "Llama-3.2-3B (28 layers, vocab 128256+2, LoRA r64 merged, weight-only int8 "
                  "tree) + Whisper-large-v3-turbo encoder (32 layers), bf16 compute, int8 KV "
                  "cache, seeded random weights",
        "batch": B, "prompt_tokens": list(INT4_PROMPTS), "new_tokens": N_NEW,
        "encode_ms": enc_ms, "prefill_ms": first_ms - enc_ms,
        "decode_ms_per_token": (total_ms - first_ms) / (N_NEW - 1),
        "generate_ms": total_ms, "peak_mem_gb": peak_gb,
        "greedy_tokens": toks.tolist(), "launches": launches,
    }
    log(json.dumps({"int8_path": stats}))
    if profile:
        path_profile(run, "int8w+kv8, B=4")
    ab = decode_ab_path(
        dict(model=(cfg, frozen, trainable), ids=ids, mask=mask, audio=wav, kv_quant=True,
             config=stats["config"]),
        [("ab_packed_int8", "decode_packed, int8w+kv8, B=4", "decode_packed",
          {"decode_attention_quantized_packed": 2 * L * (N_NEW - 1),
           "decode_attention_packed": 0, "decode_attention_quantized_mono": 0}),
         ("ab_db_int8", "decode_kernel, int8w+kv8, B=4", "decode_kernel",
          {"decode_attention_quantized_db": L * (N_NEW - 1),
           "decode_attention_quantized_mono": 0})])
    return launches, ab


# ---------------------------------------------------------------------------
# phase 21: smoothed int4 trees and GPTQ on an outlier tree at full width
# ---------------------------------------------------------------------------

def merged_llama(cfg, frozen, trainable):
    """LoRA merged into the frozen Llama -> (llama tree, trainable without
    LoRA), as the CLI's quantizers start."""
    from audio_llama_tpu_torch.bridge import ParamTree
    from audio_llama_tpu_torch.models import lora as lora_mod

    merged = lora_mod.merge_into_llama(frozen["llama"],
                                       lora_mod.with_scaling(trainable["lora"], cfg.lora))
    return merged, ParamTree({k: v for k, v in trainable.items() if k != "lora"})


def gptq_llama(cfg, frozen, trainable, ids, mask, wav, group=128):
    """frozen["llama"] (full precision) quantized by GPTQ at the scale
    group, calibrated as the JAX package's outlier gate does: the requests'
    audio splice (built at bf16, which the encoder's kernels take), the
    decoder's masked input Grams at f32 with the plain attention
    (`collect_llama_stats`), then `quantize_llama_int4_gptq(clip_cands=
    CLIP_CANDS)` -> (int4 tree, Grams, seconds of each step)."""
    import copy

    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import llama_gptq
    from audio_llama_tpu_torch.models.llama_int4 import CLIP_CANDS

    t0 = time.perf_counter()
    with torch.no_grad():
        embeds, m = build_prefix(frozen, trainable, cfg, ids, mask, wav, AUDIO_START, AUDIO_END,
                                 torch.bfloat16)
        f32 = copy.deepcopy(frozen["llama"]).float()
        stats = llama_gptq.collect_llama_stats(f32, cfg.llama, attention_mask=m,
                                               inputs_embeds=embeds.float())
        del f32, embeds
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tree = llama_gptq.quantize_llama_int4_gptq(frozen["llama"], stats, group=group,
                                                   clip_cands=CLIP_CANDS)
        torch.cuda.synchronize()
    return tree, stats, {"gram_s": t1 - t0, "quantize_s": time.perf_counter() - t1}


def with_llama(frozen, tree):
    from audio_llama_tpu_torch.bridge import ParamTree

    out = ParamTree(dict(frozen.items()))
    out["llama"] = tree
    return out


def first_step_kl(ref, quant, trainable, cfg, request, dev) -> dict:
    """KL(ref || quant) of the first generated token's distribution (the
    prefill's next-token logits), mean and max over the batch rows."""
    from audio_llama_tpu_torch.inference.generate import prefill

    def logp(fz):
        with torch.no_grad():
            pre = prefill(fz, trainable, cfg, request["ids"], request["mask"], request["wav"],
                          dev, max_new_tokens=1, compute_dtype=torch.bfloat16, kv_quant=False,
                          audio_start_id=AUDIO_START, audio_end_id=AUDIO_END)
        return torch.log_softmax(pre.next_logits.float(), dim=-1)

    lp, lq = logp(ref), logp(quant)
    kl = (lp.exp() * (lp - lq)).sum(dim=-1)
    if not torch.isfinite(kl).all():
        raise AssertionError(f"first-step KL not finite: {kl.tolist()}")
    return {"kl_mean": kl.mean().item(), "kl_max": kl.max().item(),
            "argmax_agree": (lp.argmax(-1) == lq.argmax(-1)).float().mean().item()}


def timed_generate(label, frozen, trainable, cfg, request, want, dev, megakernel=True) -> dict:
    """`generate` of N_NEW greedy tokens with an int4 KV cache: encode_ms,
    prefill_ms, decode_ms_per_token, peak memory, the counted kernels'
    launches over the run (exactly `want`) and per decode step."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm

    ids, mask, wav = request["ids"], request["mask"], request["wav"]

    def run(n):
        return generate(frozen, trainable, cfg, ids, mask, wav, None, max_new_tokens=n,
                        greedy=True, eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START,
                        audio_end_id=AUDIO_END, compute_dtype=torch.bfloat16, device=dev,
                        kv_quant=4, megakernel=megakernel)

    run(2)
    enc_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, wav))
                 for _ in range(2))
    first_ms = min(synced_ms(lambda: run(1)) for _ in range(2))
    zero_counters()
    run(1)
    first = read_counters()
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("out", run(N_NEW)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = result["out"].tokens
    check_tokens(label, toks, (ids.shape[0], N_NEW), cfg.llama.vocab_size + 2)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, want {n}")
    per_step = {k: (v - first[k]) / (N_NEW - 1) for k, v in launches.items() if v - first[k]}
    return {"label": label, "batch": ids.shape[0], "new_tokens": N_NEW, "encode_ms": enc_ms,
            "prefill_ms": first_ms - enc_ms,
            "decode_ms_per_token": (total_ms - first_ms) / (N_NEW - 1),
            "generate_ms": total_ms, "peak_mem_gb": peak_gb,
            "kernel_launches_per_decode_step": per_step,
            "launches": {k: v for k, v in launches.items() if v},
            "greedy_tokens": toks.tolist()}, launches


SMOOTH_GROUP = 32  # the scale group every JAX user of smoothed and GPTQ trees quantizes at


def smooth_path(dev):
    """Smoothed int4 trees and GPTQ at full width (`AudioLLMConfig()`):
    seeded bf16 weights, LoRA merged, the port's outlier channels injected,
    then quantized four ways on the card at group SMOOTH_GROUP: RTN (clip
    off), clipped RTN (the default), smoothed (smooth=True, clip=True) and
    GPTQ (calibrated on the four requests' audio splice, Grams at f32,
    CLIP_CANDS). The first-step KL of each against the unquantized outlier
    tree (reported, not gated); GPTQ's proxy loss over layer 0's four slabs
    at most RTN's (gated). `generate` at B = 4 (four 30 s waveforms, the
    int4 path's prompts, int4 KV) and at B = 1 (the first request) on the
    smoothed, the clipped and the GPTQ tree, launches exact: no step runs
    the megakernel, whose gate refuses w_r and every group but 128, so the
    B = 1 steps run the per-layer kernels at group 32 (the smoothed tree's
    fused MLP in its dn_r mode); then the clipped tree at B = 4 under
    INT4_BK = 768 (the K-split launch at group 32). -> (the runs' counts by
    path name, the trees and model for `eval_path`)."""
    from audio_llama_tpu_torch.models import allm, llama, llama_gptq, llama_int4
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    cfg = full_config()
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    t0 = time.perf_counter()
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.float32)
    for br in trainable["lora"]["layers"].values():  # 'ref' init has a = 0
        br["a"].data.copy_(torch.randn(br["a"].shape, generator=gen, device=dev) * 0.02)
    from audio_llama_tpu_torch.models import outliers

    merged, trainable = merged_llama(cfg, frozen, trainable)
    lo = outliers.inject_llama_outliers(merged, gen)  # the regime smoothing and GPTQ are for
    del merged
    ref = with_llama(frozen, lo)
    del frozen
    B = len(INT4_PROMPTS)
    wav = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (B, max(INT4_PROMPTS)), generator=gen,
                        device=dev)
    mask = torch.zeros_like(ids)
    for b, n in enumerate(INT4_PROMPTS):
        mask[b, :n] = 1
    request = dict(ids=ids * mask, mask=mask, wav=wav)
    one = {k: v[:1] for k, v in request.items()}
    torch.cuda.synchronize()
    log(f"smooth: outlier tree built in {time.perf_counter() - t0:.1f} s")

    trees, quant_s, kl = {}, {}, {}
    for name, kw in (("rtn", dict(clip=False)), ("clip", dict()),
                     ("smooth", dict(smooth=True, clip=True))):
        t1 = time.perf_counter()
        trees[name] = with_llama(ref, llama_int4.quantize_llama_int4(lo, group=SMOOTH_GROUP,
                                                                     **kw))
        torch.cuda.synchronize()
        quant_s[name] = time.perf_counter() - t1
        kl[name] = first_step_kl(ref, trees[name], trainable, cfg, request, dev)
    gq, stats, gptq_s = gptq_llama(cfg, ref, trainable, request["ids"], mask, wav,
                                   group=SMOOTH_GROUP)
    trees["gptq"] = with_llama(ref, gq)
    kl["gptq"] = first_step_kl(ref, trees["gptq"], trainable, cfg, request, dev)
    log(json.dumps({"smooth_quantize": {"seconds": {**quant_s, **gptq_s}, "first_step_kl": kl}}))

    # GPTQ's objective on layer 0's four slabs, against (clipped) RTN's
    lp = lo["layers"]
    full = {"qkv_proj": torch.cat([lp["q_proj"][0], lp["k_proj"][0], lp["v_proj"][0]], dim=-1),
            "gateup_proj": torch.cat([lp["gate_proj"][0], lp["up_proj"][0]], dim=-1),
            "o_proj": lp["o_proj"][0], "down_proj": lp["down_proj"][0]}
    roles = {"qkv_proj": "qkv", "gateup_proj": "gateup", "o_proj": "o", "down_proj": "down"}
    proxy = {"gptq": 0.0, "rtn": 0.0, "clip": 0.0}
    for name, w in full.items():
        H = stats[roles[name]][0]
        g = gq["layers"][name]
        G = SMOOTH_GROUP
        proxy["gptq"] += llama_gptq.gptq_proxy_loss(w, g["w_p"][0], g["w_s"][0], H, G).item()
        proxy["rtn"] += llama_gptq.gptq_proxy_loss(w, *i4.quantize_pack(w, G), H, G).item()
        proxy["clip"] += llama_gptq.gptq_proxy_loss(
            w, *i4.quantize_pack(w, G, clip_cands=llama_int4.CLIP_CANDS), H, G).item()
    del stats, full
    torch.cuda.empty_cache()
    if not proxy["gptq"] <= proxy["rtn"]:
        raise AssertionError(f"smooth: GPTQ's proxy loss over layer 0 exceeds RTN's: {proxy}")

    n_dec = L * (N_NEW - 1)
    front = {"mel_power": 1, "layer_norm": 2 * W, "enc_attention": W, "causal_attention": L}
    per_layer = dict(front, **{"int4_matmul_stacked": 4 * L + 2 * n_dec,
                               "decode_attention_quantized4_mono": n_dec,
                               "decode_megakernel": 0})
    smooth_want = dict(per_layer, **{"mlp_int4_stacked[dn_r]": n_dec, "mlp_int4_stacked": 0})
    plain_want = dict(per_layer, **{"mlp_int4_stacked[dn_r]": 0, "mlp_int4_stacked": n_dec})
    runs, counted = {}, {}
    for name, want in (("smooth", smooth_want), ("clip", plain_want), ("gptq", plain_want)):
        runs[f"{name}_b4"], counted[name] = timed_generate(
            f"smooth_path {name}, B=4", trees[name], trainable, cfg, request, want, dev)
        runs[f"{name}_b1"], _ = timed_generate(f"smooth_path {name}, B=1", trees[name],
                                               trainable, cfg, one, want, dev)
    # the K-split launch at group 32: q|k|v, o and the prefill gate|up (K 3072)
    # split at 768, the prefill down projection (K 8192) whole
    bk_want = dict(plain_want, **{"int4_matmul_stacked_ksplit": 3 * L + 2 * n_dec,
                                  "int4_matmul_stacked": L})
    saved = i4.INT4_BK
    try:
        i4.INT4_BK = 768
        runs["clip_b4_bk768"], counted["bk768"] = timed_generate(
            "smooth_path clip, B=4, INT4_BK=768", trees["clip"], trainable, cfg, request,
            bk_want, dev)
    finally:
        i4.INT4_BK = saved
    stats = {
        "config": "Llama-3.2-3B (28 layers, vocab 128256+2, LoRA r64 merged, outlier channels "
                  "injected: models/outliers.py) + Whisper-large-v3-turbo encoder (32 layers), "
                  f"fused int4 trees (pair) at scale group {SMOOTH_GROUP}, bf16 compute, int4 KV "
                  "cache, seeded random weights",
        "quantize_s": {**quant_s, **gptq_s}, "first_step_kl": kl,
        "gptq_proxy_loss_layer0": proxy, "runs": runs,
    }
    log(json.dumps({"smooth_path": stats}))
    paths = {"smooth": counted["smooth"], "smooth_clip": counted["clip"],
             "smooth_bk768": counted["bk768"]}
    return paths, dict(cfg=cfg, ref=ref, trees=trees, trainable=trainable, first_step_kl=kl)


EVAL_UTTS, EVAL_B, EVAL_NEW = 8, 4, 12  # the accuracy path's corpus, KL batch, WER tokens


def eval_path(dev, ctx, tmp) -> dict:
    """Phase 22 (b): the quantization-accuracy path at full width on
    smooth_path's model (LoRA merged, outlier channels injected) and its
    group-32 trees: `data.synth_speech.build_corpus` (EVAL_UTTS formant-speech
    clips written as FLAC), one batch of EVAL_B through `create_dataloaders`
    (as the JAX package's outlier gate builds it), `eval.kl.batch_logit_kl`
    of each group-32 tree (RTN, clipped, smoothed, GPTQ) against the
    unquantized outlier tree (each test forward's 4 x 28 W4A16 launches
    counted, beside smooth_path's first-step KL; and the tree's dense bf16
    witness, diag(w_r) @ dequant run by cuBLAS: its KL from the reference and
    the kernels' KL from it, reported), and `eval.wer.evaluate_wer`
    on the bf16 tree and the clipped tree (one batch of EVAL_UTTS, EVAL_NEW
    greedy tokens, the fused MLP every decode step at group 32, counted).
    Gated: finite values, the shapes, the launches, the clip-off RTN tree's
    KL above zero; the WER of random weights is reported, not gated."""
    import os

    from audio_llama_tpu_torch.data import synth_speech
    from audio_llama_tpu_torch.data.dataset import DatasetConfig
    from audio_llama_tpu_torch.data.loader import create_dataloaders
    from audio_llama_tpu_torch.data.tokenizer import load_tokenizer
    from audio_llama_tpu_torch.eval.kl import batch_logit_kl
    from audio_llama_tpu_torch.eval.wer import evaluate_wer
    from audio_llama_tpu_torch.models import allm, llama_int4

    t0 = time.perf_counter()
    cfg, ref, trees, trainable = ctx["cfg"], ctx["ref"], ctx["trees"], ctx["trainable"]
    L = cfg.llama.num_layers
    data_path, audio_dir, entries = synth_speech.build_corpus(
        os.path.join(tmp, "synth"), n_utts=EVAL_UTTS, fmt="flac")
    corpus_s = time.perf_counter() - t0
    tk = load_tokenizer("byte")
    dl, _, _ = create_dataloaders(
        data_path, audio_dir, tk, batch_size=EVAL_B, val_split=0.125, num_workers=0,
        dataset_config=DatasetConfig(max_audio_seconds=cfg.mel.max_audio_seconds,
                                     text_max_length=32))
    hb = next(iter(dl))
    batch = allm.AudioLLMBatch(**{k: torch.as_tensor(hb[key], device=dev) for k, key in (
        ("input_ids", "input_ids"), ("attention_mask", "attention_mask"),
        ("audio_features", "audio"), ("labels", "labels"))})
    if tuple(batch.audio_features.shape) != (EVAL_B, cfg.mel.max_samples):
        raise AssertionError(f"eval_path: audio batch {tuple(batch.audio_features.shape)}")
    a_s, a_e = tk.token_to_id(cfg.audio_start_token), tk.token_to_id(cfg.audio_end_token)
    n_scored = int((batch.labels != allm.IGNORE_INDEX).sum())
    kl = {}
    for name in ("rtn", "clip", "smooth", "gptq"):
        t1 = time.perf_counter()
        zero_counters()
        r = batch_logit_kl(cfg, ref, trees[name], trainable, batch, a_s, a_e,
                           compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        launches = read_counters()
        if not (np.isfinite(r["kl_mean"]) and np.isfinite(r["kl_max"]) and r["kl_mean"] >= 0
                and r["n_positions"] == n_scored > 0):
            raise AssertionError(f"eval_path: {name} KL {r} ({n_scored} scored labels)")
        if launches["int4_matmul_stacked"] != 4 * L:
            raise AssertionError(f"eval_path: {name} KL ran int4_matmul_stacked "
                                 f"{launches['int4_matmul_stacked']} times, want {4 * L}")
        # the same effective weights as a dense bf16 tree (cuBLAS, no int4
        # kernel): its KL from the reference is the quantization's alone, and
        # the kernels' tree sits this close to it
        dense = with_llama(ref, llama_int4.dequantize_llama_int4(trees[name]["llama"]))
        dense["llama"] = dense["llama"].to(torch.bfloat16)
        witness = {
            "kl_vs_unquantized": batch_logit_kl(cfg, ref, dense, trainable, batch, a_s, a_e,
                                                compute_dtype=torch.bfloat16),
            "kl_kernels_vs_witness": batch_logit_kl(cfg, dense, trees[name], trainable, batch,
                                                    a_s, a_e, compute_dtype=torch.bfloat16)}
        del dense
        torch.cuda.empty_cache()
        if not all(np.isfinite(w["kl_mean"]) for w in witness.values()):
            raise AssertionError(f"eval_path: {name} witness KL {witness}")
        kl[name] = dict(r, seconds=time.perf_counter() - t1,
                        first_step_kl_mean=ctx["first_step_kl"][name]["kl_mean"],
                        dense_bf16_witness=witness)
    if not kl["rtn"]["kl_mean"] > 0:
        raise AssertionError(f"eval_path: the clip-off RTN tree's KL is {kl['rtn']}")
    n_dec = L * (EVAL_NEW - 1)
    wer = {}
    for name, fz, want in (
            ("bf16", ref, {"mlp_int4_stacked": 0, "int4_matmul_stacked": 0}),
            ("clip", trees["clip"], {"mlp_int4_stacked": n_dec,
                                     "int4_matmul_stacked": 4 * L + 2 * n_dec})):
        t1 = time.perf_counter()
        zero_counters()
        m = evaluate_wer(cfg, fz, trainable, tk, entries, audio_dir, batch_size=EVAL_UTTS,
                         max_new_tokens=EVAL_NEW, device=dev)
        launches = read_counters()
        if not (np.isfinite(m["wer"]) and m["num_utterances"] == EVAL_UTTS
                and m["total_words"] > 0):
            raise AssertionError(f"eval_path: {name} WER {m}")
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"eval_path: {name} WER run launched {k} {launches[k]} "
                                     f"times, want {n}")
        wer[name] = dict(m, seconds=time.perf_counter() - t1,
                         launches={k: v for k, v in launches.items() if v})
    stats = {"corpus": {"utterances": EVAL_UTTS, "format": "flac", "seconds": corpus_s,
                        "kl_batch": EVAL_B, "scored_positions": n_scored},
             "group": SMOOTH_GROUP, "logit_kl_vs_unquantized": kl, "wer": wer,
             "seconds": time.perf_counter() - t0}
    log(json.dumps({"eval_path": stats}))
    return read_counters()


KERNEL_GROUPS = (  # substring of the device kernel's name -> group, first match wins
    ("mel_power_kernel", "mel_power kernel"),
    ("w4_decode_kernel", "int4_matmul kernel"), ("w4_wgmma_kernel", "int4_matmul kernel"),
    ("mlp4_kernel", "mlp_int4 kernel"),
    ("megakernel", "decode_megakernel"),
    ("decode_quant_kernel<__nv_bfloat16, 3, true>", "decode_attention_q8 kernel"),
    ("decode_quant_kernel", "decode_attention_q4 kernel"),
    ("enc_kernel<", "enc_attention kernel"),
    ("online_kernel", "causal_attention kernel"), ("fixed_kernel", "causal_attention kernel"),
    ("dma2_kernel", "causal_attention kernel"),
    ("dq_kernel", "causal_attention_dq kernel"), ("dkv_kernel", "causal_attention_dkv kernel"),
    ("decode_kernel", "decode_attention kernel"),
    ("db_kernel", "decode_attention_db kernel"), ("packed_", "decode_attention_packed kernel"),
    ("layer_norm_kernel", "layer_norm kernel"),
    ("nvjet", "matmul (cuBLAS)"), ("gemm", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"), ("conv", "conv stem (cuDNN)"),
    ("Memcpy", "memcpy/memset"), ("Memset", "memcpy/memset"),
)


def device_profile(fn) -> dict:
    """One call's wall time, summed device time, device busy share, and
    device time by kernel group and by top kernel name."""
    wall_ms, by_name, n_kernels = traced(fn)
    by_group = {}
    for name, ms in by_name.items():
        group = next((g for key, g in KERNEL_GROUPS if key in name), "other elementwise/reduce")
        by_group[group] = by_group.get(group, 0.0) + ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_launches": n_kernels, "by_group_ms": by_group,
            "top_kernels_ms": [[name[:90], ms] for name, ms in top]}


# ---------------------------------------------------------------------------
# phase 6: card (bf16, kernels) vs host (f32, plain) at 2 + 2 layers
# ---------------------------------------------------------------------------

def cut_config():
    """full_config() with 2 Whisper and 2 Llama layers, widths unchanged."""
    import dataclasses

    full = full_config()
    return dataclasses.replace(
        full, llama=dataclasses.replace(full.llama, num_layers=2),
        whisper=dataclasses.replace(full.whisper, num_layers=2))


# bf16 activations through 2 + 2 layers against an f32 host path: each bf16
# rounding is <= 2^-9 relative, a few dozen of them compound to ~1e-2
HOST_TOL = 2e-2


def compare_logits(label, card, host, tol=HOST_TOL, argmax=True) -> dict:
    """rel-L2 of the card's logits from the host's; with a bar `tol`, raise
    unless they are finite, within it and (with `argmax`) agree on the
    argmax."""
    rel = ((card - host).norm() / host.norm()).item()
    stats = {"rel_l2": rel, "max_abs": (card - host).abs().max().item(),
             "host_logit_absmax": host.abs().max().item(),
             "argmax_agree": int(card.argmax()) == int(host.argmax())}
    if not torch.isfinite(card).all():
        raise AssertionError(f"{label}: card logits not finite")
    if tol is not None and not (rel <= tol and (stats["argmax_agree"] or not argmax)):
        raise AssertionError(f"{label}: card vs host logits {stats} (bar rel_l2 {tol}"
                             + (", argmax equal)" if argmax else ")"))
    return stats


def host_check(dev):
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import allm, llama, lora

    cfg = cut_config()
    t0 = time.perf_counter()
    gen = make_generator(2, "cpu")
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.bfloat16)
    rng = np.random.default_rng(3)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.02))
    mel = torch.from_numpy(
        rng.normal(size=(1, cfg.whisper.num_mel_bins, cfg.mel.num_frames)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.llama.vocab_size, (1, PROMPT)))
    mask = torch.ones_like(ids, dtype=torch.int32)

    def last_logits(fz, tr, cd, d):
        args = [t.to(d) for t in (ids, mask, mel)]
        embeds, m = build_prefix(fz, tr, cfg, args[0], args[1], args[2], AUDIO_START,
                                 AUDIO_END, cd)
        _, _, hidden = llama.llama_forward(
            fz["llama"], cfg.llama, inputs_embeds=embeds, attention_mask=m,
            lora=lora.with_scaling(tr["lora"], cfg.lora), compute_dtype=cd,
            return_hidden=True, unembed_logits=False)
        return llama.unembed(fz["llama"], cfg.llama, hidden[:, -1:], cd)[0, 0].float().cpu()

    card = last_logits(copy.deepcopy(frozen).to(dev), copy.deepcopy(trainable).to(dev),
                       torch.bfloat16, dev)
    host = last_logits(frozen.float(), trainable.float(), torch.float32, torch.device("cpu"))
    stats = {"path": "bf16, log-mel input", "layers": "2 whisper + 2 llama, full width",
             **compare_logits("host check", card, host), "tol_rel_l2": HOST_TOL,
             "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check": stats}))


def quant_request(cfg, seed):
    """The 2 + 2 layer host checks' model and request, drawn on the host:
    seeded bf16 weights with a non-zero LoRA delta, one 30 s waveform and a
    PROMPT-token prompt -> (frozen, trainable, ids, mask, wav)."""
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm, llama

    gen = make_generator(seed, "cpu")
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.bfloat16)
    rng = np.random.default_rng(seed)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.02))
    wav = torch.from_numpy((rng.normal(size=(1, cfg.mel.max_samples)) * 0.1).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.llama.vocab_size, (1, PROMPT)))
    mask = torch.ones_like(ids, dtype=torch.int32)
    return frozen, trainable, ids, mask, wav


def quant_logits(cfg, request, fz, tr, cd, d, kv_quant, token=None):
    """The last position's prefill logits, then one decode step's on the
    quantized KV cache (`token` fed, else the prefill's argmax), with the
    counters zeroed before the step -> (first, step, token), on the host."""
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import llama

    ids, mask, wav = request
    embeds, m = build_prefix(fz, tr, cfg, ids.to(d), mask.to(d), wav.to(d), AUDIO_START,
                             AUDIO_END, cd)
    P = embeds.shape[1]
    full_mask = torch.cat([m, torch.ones((1, 1), dtype=m.dtype, device=d)], dim=1)
    cache = llama.KVCache.zeros(cfg.llama, 1, P + 1, dtype=cd, device=d, quantized=kv_quant)
    _, cache, hidden = llama.llama_forward(
        fz["llama"], cfg.llama, inputs_embeds=embeds, attention_mask=full_mask,
        kv_cache=cache, compute_dtype=cd, assume_fresh_cache=True, return_hidden=True,
        unembed_logits=False)
    first = llama.unembed(fz["llama"], cfg.llama, hidden[:, -1:], cd)[0, 0].float().cpu()
    tok = first.argmax() if token is None else token
    zero_counters()
    step, _ = llama.llama_forward(
        fz["llama"], cfg.llama, input_ids=tok.reshape(1, 1).to(d), attention_mask=full_mask,
        positions=torch.full((1, 1), P, device=d), kv_cache=cache, compute_dtype=cd)
    return first, step[0, 0].float().cpu(), tok


def check_launches(label, want) -> dict:
    launches = read_counters()
    for name, n in (want or {}).items():
        if launches[name] != n:
            raise AssertionError(f"{label}: the card's decode step launched {name} "
                                 f"{launches[name]} times, want {n}")
    return {k: launches[k] for k in (want or {})}


def host_check_quant(dev, label, bits=4, rotate=False, kv_quant=4, seed=4, want=None,
                     quantize=None):
    """A quantized path at 2 + 2 layers: waveform in, LoRA merged, the
    decoder rotated (with `rotate`) and quantized once on the host, the same
    tree on both sides; the last position's prefill logits, then one decode
    step's on the quantized KV cache (the host's next token fed to both).
    `want`: {kernel: launches} of the card's decode step. `quantize(cfg,
    frozen, trainable, ids, mask, wav)` -> (frozen, trainable) builds the
    tree in place of the CLI's quantizer."""
    import copy

    from audio_llama_tpu_torch.inference import cli

    cfg = cut_config()
    t0 = time.perf_counter()
    frozen, trainable, ids, mask, wav = quant_request(cfg, seed)
    if quantize is None:
        frozen, trainable = cli.quantize_decoder(cfg, frozen, trainable, bits=bits,
                                                 rotate=rotate)
    else:
        frozen, trainable = quantize(cfg, frozen, trainable, ids, mask, wav)
    request = (ids, mask, wav)
    host_first, host_step, tok = quant_logits(cfg, request, frozen.float(), trainable.float(),
                                              torch.float32, torch.device("cpu"), kv_quant)
    card_first, card_step, _ = quant_logits(cfg, request, copy.deepcopy(frozen).to(dev),
                                            copy.deepcopy(trainable).to(dev), torch.bfloat16,
                                            dev, kv_quant, token=tok)
    stats = {"path": label, "layers": "2 whisper + 2 llama, full width",
             "prefill": compare_logits(f"{label}, prefill", card_first, host_first),
             "decode_step": compare_logits(f"{label}, decode step", card_step, host_step),
             "decode_step_launches": check_launches(label, want),
             "tol_rel_l2": HOST_TOL, "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check_quant": stats}))


# A smoothed outlier tree's bf16 forward loses more to activation rounding
# than the seeded trees': its kernels' gap from the host may be at most this
# many times that of its witness, the same effective weights run dense at
# bf16 with no int4 kernel (or HOST_TOL, whichever is larger). A kernel that
# dropped w_r or dn_r lands 0.35-0.40 away (the bridge fault the port's
# forward test pins).
OUTLIER_WITNESS_RATIO = 1.5


def host_check_smooth_outliers(dev, seed=10):
    """The smoothed int4 tree (smooth=True, clip=True) of an outlier tree at
    2 + 2 layers: the seeded merged tree with the port's outlier channels
    (`models/outliers.py`, drawn on the host), card (bf16, kernels, the dn_r
    mode) against host (f32, plain versions), as `host_check_quant`. Beside
    it the witness: diag(w_r) @ dequant, the same effective weights as a
    dense tree, run at bf16 on the card (cuBLAS, no int4 kernel) against the
    same host logits. The kernels' gap is held to OUTLIER_WITNESS_RATIO x
    the witness's (at least HOST_TOL), each of prefill and decode step, and
    to the host's argmax where the witness keeps it."""
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import llama_int4, outliers

    cfg = cut_config()
    L = cfg.llama.num_layers
    t0 = time.perf_counter()
    frozen, trainable, ids, mask, wav = quant_request(cfg, seed)
    merged, trainable = merged_llama(cfg, frozen, trainable)
    lo = outliers.inject_llama_outliers(merged, make_generator(seed, "cpu"))
    tree = llama_int4.quantize_llama_int4(lo, smooth=True, clip=True)
    del merged, lo
    frozen = with_llama(frozen, tree)
    request = (ids, mask, wav)
    host_first, host_step, tok = quant_logits(cfg, request, frozen.float(), trainable.float(),
                                              torch.float32, torch.device("cpu"), 4)
    card_first, card_step, _ = quant_logits(cfg, request, copy.deepcopy(frozen).to(dev),
                                            copy.deepcopy(trainable).to(dev), torch.bfloat16,
                                            dev, 4, token=tok)
    label = "int4w+kv4 smoothed, outlier tree, B=1"
    launches = check_launches(label, {"mlp_int4_stacked[dn_r]": L, "mlp_int4_stacked": 0,
                                      "decode_megakernel": 0})
    dense = with_llama(frozen, llama_int4.dequantize_llama_int4(tree))
    dense["llama"] = dense["llama"].to(torch.bfloat16)
    wit_first, wit_step, _ = quant_logits(cfg, request, dense.to(dev),
                                          copy.deepcopy(trainable).to(dev), torch.bfloat16,
                                          dev, 4, token=tok)
    witness = {"prefill": compare_logits("witness, prefill", wit_first, host_first, None),
               "decode_step": compare_logits("witness, decode step", wit_step, host_step, None)}
    bars = {k: max(HOST_TOL, OUTLIER_WITNESS_RATIO * v["rel_l2"]) for k, v in witness.items()}
    stats = {"path": label, "layers": "2 whisper + 2 llama, full width",
             "prefill": compare_logits(f"{label}, prefill", card_first, host_first,
                                       bars["prefill"], witness["prefill"]["argmax_agree"]),
             "decode_step": compare_logits(f"{label}, decode step", card_step, host_step,
                                           bars["decode_step"],
                                           witness["decode_step"]["argmax_agree"]),
             "decode_step_launches": launches,
             "witness_dense_bf16": witness, "tol_rel_l2": bars,
             "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check_smooth_outliers": stats}))


# The smoothed and GPTQ trees' card-vs-host checks quantize the merged seeded
# weights, as the other quantized host checks do; `host_check_smooth_outliers`
# holds the smoothed tree of an outlier tree against its witness.

def host_smooth_tree(cfg, frozen, trainable, ids, mask, wav):
    """The merged tree quantized smoothed (smooth=True, clip=True) on the
    host."""
    from audio_llama_tpu_torch.models import llama_int4

    merged, trainable = merged_llama(cfg, frozen, trainable)
    return with_llama(frozen, llama_int4.quantize_llama_int4(merged, smooth=True, clip=True)), \
        trainable


def host_clip_tree(cfg, frozen, trainable, ids, mask, wav, group=128):
    """The merged tree quantized clipped RTN at the scale group on the
    host."""
    from audio_llama_tpu_torch.models import llama_int4

    merged, trainable = merged_llama(cfg, frozen, trainable)
    return with_llama(frozen, llama_int4.quantize_llama_int4(merged, group=group, clip=True)), \
        trainable


def host_gptq_tree(cfg, frozen, trainable, ids, mask, wav, dev, group=128):
    """The merged tree quantized by GPTQ at the scale group, calibrated on
    this request's splice; the Grams and the quantization run on `dev` (the
    same tree then serves both sides)."""
    import copy

    merged, trainable = merged_llama(cfg, frozen, trainable)
    ref = copy.deepcopy(with_llama(frozen, merged)).to(dev)
    tree, _, _ = gptq_llama(cfg, ref, copy.deepcopy(trainable).to(dev), ids.to(dev),
                            mask.to(dev), wav.to(dev), group=group)
    return with_llama(frozen, tree.to("cpu")), trainable


# ---------------------------------------------------------------------------
# phases 9-11: training (projector + LoRA) at full width
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T, TRAIN_REAL = 2, 2048, 2014  # 1500 frames + 2 delimiters + 512 text


def bwd_reference(qs, k, v, key_bias, l, m, do, d, visible, kv_of):
    """The backward's arithmetic in f32 for a given key visibility [T, T]
    (bool) and query-head -> KV-head map `kv_of` [Hq]: the plain version's
    where `visible` is causal and kv_of[h] = h // G. A kernel that dropped
    the mask somewhere, or mapped heads otherwise, computes this."""
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    kq, vq = k.float()[:, :, kv_of], v.float()[:, :, kv_of]  # [B, T, Hq, hd]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kq) + key_bias[:, None, None, :]
    s = s.masked_fill(~visible, -1e9)
    lq = l.reshape(B, Hq, T, 1)
    p = torch.exp(s - m.reshape(B, Hq, T, 1)) * torch.where(
        lq > 0, 1.0 / torch.where(lq > 0, lq, 1.0), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vq)
    ds = (p * (dp - d.reshape(B, Hq, T, 1))).to(qs.dtype).float()
    del dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kq)
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    dv_h = torch.einsum("bhqk,bqhd->bkhd", p.to(qs.dtype).float(), do.float())
    idx = kv_of.to(qs.device)
    dk = torch.zeros((B, T, Hkv, hd), device=qs.device).index_add_(2, idx, dk_h)
    dv = torch.zeros((B, T, Hkv, hd), device=qs.device).index_add_(2, idx, dv_h)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_FAULTS = {  # a planted fault of the backward kernels -> the outputs it must move
    "stale K": ("dq",), "stale Q": ("dk", "dv"), "stale dO": ("dk", "dv"),
    "mask off on the last tile": ("dq", "dk", "dv"),
    "statistics one step off": ("dq", "dk", "dv")}


def bwd_fault_reference(qs, k, v, key_bias, l, m, do, d, fault=None):
    """The function a backward kernel with a planted fault computes, by
    `bwd_reference` with the kernels' 64-row ring steps (`ca.BWD_TILE`):
      'stale K': dq's key tile j >= 1 meets tile j-1's K (in S and in dS K),
          as a ring stage read before its refill;
      'stale Q' / 'stale dO': dk/dv's query tile i >= 1 meets tile i-1's Q
          (in S^T and dS^T Q) or dO (in dP^T and P^T dO);
      'mask off on the last tile': the diagonal tile of the last query tile
          (its last 64 queries and keys) is not masked;
      'statistics one step off': query tile i >= 1 reads tile i-1's m, l and
          D.
    None: no fault. -> (dq, dk, dv) in the inputs' dtypes."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    T, Hq, Hkv = qs.shape[1], qs.shape[2], k.shape[2]
    n = ca.BWD_TILE
    t = torch.arange(T, device=qs.device)

    def stale(x, dim):  # row i >= n of x along `dim` is row i - n's
        late = (t >= n).reshape([-1 if i == dim else 1 for i in range(x.dim())])
        return torch.where(late, torch.roll(x, n, dims=dim), x)

    visible = t[None, :] <= t[:, None]
    if fault == "stale K":
        k = stale(k, 1)
    elif fault == "stale Q":
        qs = stale(qs, 1)
    elif fault == "stale dO":
        do = stale(do, 1)
    elif fault == "mask off on the last tile":
        visible = visible | ((t[:, None] >= T - n) & (t[None, :] >= T - n))
    elif fault == "statistics one step off":
        l, m, d = stale(l, 1), stale(m, 1), stale(d, 1)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return bwd_reference(qs, k, v, key_bias, l, m, do, d, visible,
                         torch.arange(Hq, device=qs.device) // (Hq // Hkv))


def train_bwd_case(dev, gen, B=TRAIN_B) -> dict:
    """The backward's inputs at the training geometry (T 2048 = 2014 real +
    34 pad keys, Hq 24, Hkv 8, hd 128, bf16; row 1's tail padded from 1800):
    qs pre-scaled, k, v, a cotangent dO, the key bias, the forward kernel's
    residuals (o, l, m) and the prologue's D."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc = full_config().llama
    T, Hq, Hkv, hd = TRAIN_T, lc.num_heads, lc.num_kv_heads, lc.head_dim
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    qs = randn(B, T, Hq, hd) * torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    k, v, do = randn(B, T, Hkv, hd), randn(B, T, Hkv, hd), randn(B, T, Hq, hd)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[:, TRAIN_REAL:] = 0
    mask[1, 1800:] = 0
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    o, l, m = ca.causal_attention_cuda(qs, k, v, key_bias)
    return dict(qs=qs, k=k, v=v, key_bias=key_bias, o=o, l=l, m=m, do=do,
                d=ca.attention_bwd_prologue(o, do))


def sdpa_backward(qs, k, v, do, causal: bool):
    """One call of the backward of `F.scaled_dot_product_attention` (GQA;
    is_causal or no mask) on the case's tensors: dq, dk and dv together,
    the yardstick of the dq and dk/dv kernels (the port never calls it)."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qs, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=1.0,
                                         enable_gqa=True)
    doh = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)


def bwd_bounds(B, T, Hq, Hkv, hd, causal: bool) -> dict:
    """The least time of the dq and of the dk/dv kernel (`bound`): each
    hd-deep product over the causal half (or every pair), per head; inputs
    read once, outputs written once."""
    pairs = T * (T + 1) / 2 if causal else T * T
    per_product = 2.0 * hd * pairs * B * Hq
    in_bytes = 2.0 * B * T * hd * (2 * Hq + 2 * Hkv) + 4.0 * B * T * (3 * Hq + 1)
    return {"dq": bound(3 * per_product, in_bytes + 2.0 * B * T * Hq * hd),
            "dkv": bound(4 * per_product, in_bytes + 2.0 * 2 * B * T * Hkv * hd)}


def train_kernel_checks(dev, gen):
    """The dq and dk/dv kernels at the training geometry (`train_bwd_case`,
    B 2) against the plain backward on the forward kernel's residuals;
    planted faults: D not computed (0), the causal mask dropped on one
    diagonal tile, queries mapped to the wrong KV head (h % Hkv for h // G).
    Two launches give the same bits, and at B 8 (train B's batch) the first
    two batch rows give the bits of a B 2 launch on them. Timed at B 2 and B
    8 beside the plain backward (B 2) and the backward of
    `F.scaled_dot_product_attention` (causal, GQA); each row carries its
    wgmma / TMA kernel's `sm90` report."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc = full_config().llama
    B, T, Hq, Hkv, hd = TRAIN_B, TRAIN_T, lc.num_heads, lc.num_kv_heads, lc.head_dim
    G = Hq // Hkv
    c = train_bwd_case(dev, gen)
    qs, k, v, key_bias, o, l, m, do, d = (c[n] for n in "qs k v key_bias o l m do d".split())
    want = ca.causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do)

    def dq_run(dd=d):
        return ca.causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, dd)

    def dkv_run(dd=d):
        return ca.causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, dd)

    got_dq, (got_dk, got_dv) = dq_run(), dkv_run()
    if not (torch.equal(got_dq, dq_run()) and all(
            torch.equal(a, b) for a, b in zip((got_dk, got_dv), dkv_run()))):
        raise AssertionError("causal attention backward: two launches differ")
    results = {}
    for name, got, w in (("causal_attention_dq", got_dq, want[0]),
                         ("causal_attention_dk", got_dk, want[1]),
                         ("causal_attention_dv", got_dv, want[2])):
        frac = ATOL_ROW_RMS_FRAC["causal_attention_dq" if name.endswith("dq")
                                 else "causal_attention_dkv"]
        results[name] = check_close(name, got, w, frac, GRAD_RMS_DIMS)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    tile = T // 2 // ca.BWD_TILE * ca.BWD_TILE  # a diagonal tile halfway down
    unmasked = causal.clone()
    unmasked[tile:tile + ca.BWD_TILE, tile:tile + ca.BWD_TILE] = True
    by_index = torch.arange(Hq, device=dev) // G
    planted = {
        "D not computed (0)": (dq_run(torch.zeros_like(d)),
                               dkv_run(torch.zeros_like(d))[0], want[0], want[1]),
        "causal mask dropped on one diagonal tile": (got_dq, got_dk, *bwd_reference(
            qs, k, v, key_bias, l, m, do, d, unmasked, by_index)[:2]),
        "q head h read KV head h % Hkv": (got_dq, got_dk, *bwd_reference(
            qs, k, v, key_bias, l, m, do, d, causal, torch.arange(Hq, device=dev) % Hkv)[:2]),
    }
    faults = {}
    for fault, (gq, gk, wq, wk) in planted.items():
        faults[fault] = {
            "dq": must_reject("causal_attention_dq", fault, gq, wq,
                              ATOL_ROW_RMS_FRAC["causal_attention_dq"], rms_dims=GRAD_RMS_DIMS),
            "dk": must_reject("causal_attention_dkv", fault, gk, wk,
                              ATOL_ROW_RMS_FRAC["causal_attention_dkv"], rms_dims=GRAD_RMS_DIMS)}
    del planted, want
    bounds = bwd_bounds(B, T, Hq, Hkv, hd, causal=True)
    # timed by CUDA events, with CUPTI's reading beside (`ms_cupti`): CUPTI's
    # sums have read these kernels low after earlier phases (PERF.md, rows 11-12)
    plain_ms = events_ms(lambda: ca.causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do),
                         iters=3, warmup=1)
    sdpa = sdpa_backward(qs, k, v, do, causal=True)
    library_ms, library_backend = events_ms(sdpa), sdpa_backend(sdpa)
    del sdpa
    timed = {"causal_attention_dq": dict(ms=events_ms(dq_run), ms_cupti=time_ms(dq_run)),
             "causal_attention_dkv": dict(ms=events_ms(dkv_run), ms_cupti=time_ms(dkv_run))}
    del c, qs, k, v, key_bias, o, l, m, do, d, got_dq, got_dk, got_dv
    torch.cuda.empty_cache()
    # B 8 (train B's batch): its first two batch rows (row 1 padded from 1800,
    # as at B 2) must give the bits of a B 2 launch on those rows, then timed
    B8 = 8
    c8 = train_bwd_case(dev, gen, B8)
    args8 = tuple(c8[n] for n in "qs k v key_bias l m do d".split())
    # the first B batch rows: of [B8, ...] and of the [B8 * Hq, T] statistics
    args2 = tuple(a[:B * Hq] if a.shape[0] == B8 * Hq else a[:B] for a in args8)
    got8 = (ca.causal_attention_dq_cuda(*args8), *ca.causal_attention_dkv_cuda(*args8))
    got2 = (ca.causal_attention_dq_cuda(*args2), *ca.causal_attention_dkv_cuda(*args2))
    if not all(torch.equal(a[:B], b) for a, b in zip(got8, got2)):
        raise AssertionError("causal attention backward: B 8's first rows differ from B 2's")
    del got8, got2, args2
    bounds8 = bwd_bounds(B8, T, Hq, Hkv, hd, causal=True)
    library_ms_b8 = events_ms(sdpa_backward(c8["qs"], c8["k"], c8["v"], c8["do"], causal=True))
    for name, fn in (("causal_attention_dq", ca.causal_attention_dq_cuda),
                     ("causal_attention_dkv", ca.causal_attention_dkv_cuda)):
        timed[name].update(ms_b8=events_ms(lambda fn=fn: fn(*args8)),
                           ms_cupti_b8=time_ms(lambda fn=fn: fn(*args8)))
    del c8, args8
    torch.cuda.empty_cache()
    shapes = (f"qs/dO[B,{T},{Hq},{hd}] k/v[B,{T},{Hkv},{hd}] bf16, l/m/D [B*{Hq},{T}] "
              f"f32, keys >= {TRAIN_REAL} (row 1: >= 1800) padded; B {B} (ms) and {B8} (ms_b8)")
    rows = []
    for name, err_names in (("causal_attention_dq", ("causal_attention_dq",)),
                            ("causal_attention_dkv", ("causal_attention_dk",
                                                      "causal_attention_dv"))):
        frac = ATOL_ROW_RMS_FRAC[name]
        key = "dq" if name.endswith("dq") else "dkv"
        checked = [results[n] for n in err_names]
        rows.append(dict(
            name=name, route="cuda", source="audio_llama_tpu_torch/csrc/causal_attention_bwd.cu",
            replaces="audio_llama_tpu/ops/causal_attention.py:" + ("471" if key == "dq"
                                                                   else "514"),
            max_abs_err=max(r[0] for r in checked),
            tol={**tol_entry(frac), "rms_over": "each (batch, head)'s [T, hd] slab"},
            tol_ratio=max(r[1] for r in checked),
            planted_fault_ratios={f: r["dq" if key == "dq" else "dk"]
                                  for f, r in faults.items()},
            **timed[name], plain_ms=plain_ms, library_ms=library_ms,
            library_backend=library_backend, library_ms_b8=library_ms_b8, launches=None,
            bound_ms=bounds[key][0], bound_by=bounds[key][1], bound_ms_b8=bounds8[key][0],
            shapes=shapes,
            sm90=sm90_report(name, hd),
            notes="times by CUDA events (ms_cupti: CUPTI); plain_ms: the whole plain backward "
                  "(dq, dk and dv) at B 2; library_ms: the backward of SDPA(is_causal, "
                  "enable_gqa), dq, dk and dv in one call",
        ))
        log(f"kernel {name} ok: {json.dumps(rows[-1])}")
    return rows


# ---------------------------------------------------------------------------
# phase 12: the ring hop's tri='never' kernels (sequence-parallel training)
# ---------------------------------------------------------------------------

def merge_hops(*hops):
    """(o, l, m) of several key blocks of the same queries -> the whole
    row's (o, l, m), as the ring merges them (f32)."""
    B = hops[0][0].shape[0]

    def rows(x):  # [B*H, T] -> [B, T, H, 1]
        return x.reshape(B, -1, x.shape[-1]).transpose(1, 2)[..., None]

    m = torch.stack([h[2] for h in hops]).amax(dim=0)
    l = sum(h[1] * torch.exp(h[2] - m) for h in hops)
    acc = sum(h[0].float() * rows(h[1] * torch.exp(h[2] - m)) for h in hops)
    o = torch.where(rows(l) > 0, acc / torch.where(rows(l) > 0, rows(l), 1.0), 0.0)
    return o.to(hops[0][0].dtype), l, m


def ring_hop_case(dev, gen, B, T, Hq, Hkv, hd, pad_from=None):
    """Rank 1 of sp = 2 at a hop: its queries (pre-scaled) against the K/V
    block of shard 0 (the hop, `k`, `v`, `bias`: the source shard's
    padding, row 1's keys from `pad_from` on) and its own block (`own`); the
    whole row's (o, l, m) and D merged over both blocks by the plain
    versions, and a cotangent dO. bf16."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    qs = randn(B, T, Hq, hd) * torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    k, v, k1, v1, do = (randn(B, T, Hkv, hd), randn(B, T, Hkv, hd), randn(B, T, Hkv, hd),
                        randn(B, T, Hkv, hd), randn(B, T, Hq, hd))
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    if pad_from is not None:
        mask[-1, pad_from:] = 0
    zero = torch.zeros((), device=dev)
    bias = torch.where(mask != 0, zero, ca.NEG)
    own_bias = torch.zeros(B, T, device=dev)
    hop = ca.causal_attention_plain(qs, k, v, bias, tri="never")
    own = ca.causal_attention_plain(qs, k1, v1, own_bias, tri="always")
    o, l, m = merge_hops(hop, own)
    return dict(qs=qs, k=k, v=v, bias=bias, do=do, o=o, l=l, m=m,
                d=ca.attention_bwd_prologue(o, do), hop=hop, own=(k1, v1, own_bias))


RING_NAMES = ("causal_attention_never", "causal_attention_dq_never", "causal_attention_dkv_never")
ATOL_ROW_RMS_FRAC.update({"causal_attention_never": ATOL_ROW_RMS_FRAC["causal_attention"],
                          "causal_attention_dq_never": ATOL_ROW_RMS_FRAC["causal_attention_dq"],
                          "causal_attention_dkv_never": ATOL_ROW_RMS_FRAC["causal_attention_dkv"]})


def ring_launch_fault(case) -> dict:
    """The ring's forward on one process (a 2-rank axis whose rotation hands
    each block back unchanged: the counts, not the numbers, are checked):
    rank 0 must launch no tri='never' kernel (its only other block is a
    later shard's), rank 1 one. The planted fault, a ring that launches a
    later shard's hop, is caught by that count alone."""
    from audio_llama_tpu_torch.ops import causal_attention as ca
    from audio_llama_tpu_torch.parallel import ring_kernel as rk
    from audio_llama_tpu_torch.parallel.mesh import MeshAxis

    saved = rk.ppermute_, rk.axis_index
    rk.ppermute_ = lambda t, axis, shift=1: t
    got = {}
    try:
        for label, idx, lie in (("rank 0", 0, None), ("rank 1", 1, None),
                                ("rank 0, later hop launched (planted)", 0, 1)):
            axis = MeshAxis("sp", 2, idx, None, (0, 1))
            rk.axis_index = saved[1] if lie is None else (lambda a, lie=lie: lie)
            n = ca.launches_never
            rk.ring_forward(case["qs"], case["k"], case["v"], case["bias"], axis)
            got[label] = ca.launches_never - n
    finally:
        rk.ppermute_, rk.axis_index = saved
    if got["rank 0"] != 0 or got["rank 1"] != 1:
        raise AssertionError(f"ring: tri='never' launches {got}, want rank 0: 0, rank 1: 1")
    if got["rank 0, later hop launched (planted)"] == 0:
        raise AssertionError("ring: the planted later-shard launch was not counted")
    return got


def ring_kernel_checks(dev, gen):
    """The three tri='never' kernels at the sp = 2 hop of train A (rank 1:
    qs [2, 1024, 24, 128] against shard 0's K/V [2, 1024, 8, 128], row 1's
    keys from 896 padded) against their plain versions, the backward fed
    the row statistics merged over both blocks; planted faults: the causal
    mask applied on the hop, the source shard's padding bias dropped, dq and
    dk/dv fed the hop's own (m, l) for the merged ones, and (by the launch
    count) a later shard's hop launched. Timed by CUPTI with CUDA events
    beside, the plain versions, and SDPA (non-causal, GQA) forward and
    backward as yardsticks."""
    import torch.nn.functional as F

    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc = full_config().llama
    B, T, Hq, Hkv, hd = TRAIN_B, TRAIN_T // 2, lc.num_heads, lc.num_kv_heads, lc.head_dim
    c = ring_hop_case(dev, gen, B, T, Hq, Hkv, hd, pad_from=T * 7 // 8)
    qs, k, v, bias, do, o, l, m, d = (c[n] for n in "qs k v bias do o l m d".split())

    def fwd(tri="never", b=bias):
        return ca.causal_attention_cuda(qs, k, v, b, tri)

    def dq(tri="never", b=bias, ll=l, mm=m):
        return ca.causal_attention_dq_cuda(qs, k, v, b, ll, mm, do, d, tri)

    def dkv(tri="never", b=bias, ll=l, mm=m):
        return ca.causal_attention_dkv_cuda(qs, k, v, b, ll, mm, do, d, tri)

    want_fwd = c["hop"].o
    want_bwd = ca.causal_attention_bwd_plain(qs, k, v, bias, o, l, m, do, tri="never")
    got_fwd = fwd()
    got_dq, (got_dk, got_dv) = dq(), dkv()
    fr = {n: ATOL_ROW_RMS_FRAC[n] for n in RING_NAMES}
    res = {"causal_attention_never": check_close(RING_NAMES[0], got_fwd.o, want_fwd,
                                                 fr[RING_NAMES[0]])}
    for name, got, want, key in (("dq", got_dq, want_bwd[0], RING_NAMES[1]),
                                 ("dk", got_dk, want_bwd[1], RING_NAMES[2]),
                                 ("dv", got_dv, want_bwd[2], RING_NAMES[2])):
        res[name] = check_close(key + " " + name, got, want, fr[key], GRAD_RMS_DIMS)
    for name, got, want in (("l", got_fwd.l, c["hop"].l), ("m", got_fwd.m, c["hop"].m)):
        rel = ((got - want).abs() / want.abs().clamp(min=1e-6)).max().item()
        if not rel <= 1e-2:
            raise AssertionError(f"causal_attention_never: {name} off by {rel:.3e} relative")
    zero_bias = torch.zeros_like(bias)
    hop_l, hop_m = c["hop"].l, c["hop"].m
    faults = {RING_NAMES[0]: {
        "causal mask applied on the hop": must_reject(
            RING_NAMES[0], "causal mask", fwd("always").o, want_fwd, fr[RING_NAMES[0]]),
        "source shard's padding bias dropped": must_reject(
            RING_NAMES[0], "bias dropped", fwd(b=zero_bias).o, want_fwd, fr[RING_NAMES[0]]),
    }}
    for key, run, want, pick in ((RING_NAMES[1], dq, want_bwd[0], lambda r: r),
                                 (RING_NAMES[2], dkv, want_bwd[1], lambda r: r[0])):
        faults[key] = {
            fault: must_reject(key, fault, pick(got), want, fr[key], rms_dims=GRAD_RMS_DIMS)
            for fault, got in (
                ("causal mask applied on the hop", run("always")),
                ("source shard's padding bias dropped", run(b=zero_bias)),
                ("hop-local (m, l) for the merged ones", run(ll=hop_l, mm=hop_m)))}
    launch_check = ring_launch_fault(c)
    # bounds: every product over the whole Tl x Tl hop (no causal half)
    per_product = 2.0 * hd * T * T * B * Hq
    in_bytes = 2.0 * B * T * hd * (Hq + 2 * Hkv) + 4.0 * B * T
    stats = 4.0 * B * Hq * T
    bwd = bwd_bounds(B, T, Hq, Hkv, hd, causal=False)
    bounds = {RING_NAMES[0]: bound(2 * per_product, in_bytes + 2.0 * B * T * Hq * hd + 2 * stats),
              RING_NAMES[1]: bwd["dq"], RING_NAMES[2]: bwd["dkv"]}
    plain_fwd = events_ms(lambda: ca.causal_attention_plain(qs, k, v, bias, tri="never"),
                          iters=3, warmup=1)
    plain_bwd = events_ms(lambda: ca.causal_attention_bwd_plain(qs, k, v, bias, o, l, m, do,
                                                                tri="never"),
                          iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qs, k, v))
    sdpa_fwd = events_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0,
                                                                enable_gqa=True))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0, enable_gqa=True)
    doh = do.transpose(1, 2)
    sdpa_bwd = events_ms(lambda: torch.autograd.grad(sdpa, (qh, kh, vh), doh,
                                                     retain_graph=True))
    shapes = (f"qs/dO[{B},{T},{Hq},{hd}] k/v[{B},{T},{Hkv},{hd}] bf16 (the sp=2 hop of "
              f"train A), bias [{B},{T}] f32 (row 1 keys >= {T * 7 // 8} padded), l/m/D "
              f"[{B * Hq},{T}] "
              f"f32 merged over both of rank 1's blocks")
    rows = []
    for name, run, err, line, plain_ms, library_ms in (
            (RING_NAMES[0], fwd, res["causal_attention_never"], "101", plain_fwd, sdpa_fwd),
            (RING_NAMES[1], dq, res["dq"], "471", plain_bwd, sdpa_bwd),
            (RING_NAMES[2], dkv, max(res["dk"], res["dv"]), "514", plain_bwd, sdpa_bwd)):
        bms, bby = bounds[name]
        rows.append(dict(
            name=name, route="cuda",
            source="audio_llama_tpu_torch/csrc/" + ("causal_attention.cu" if name == RING_NAMES[0]
                                                    else "causal_attention_bwd.cu"),
            replaces=f"audio_llama_tpu/ops/causal_attention.py:{line} (tri='never')",
            max_abs_err=err[0], tol={**tol_entry(ATOL_ROW_RMS_FRAC[name]), **(
                {"rms_over": "each (batch, head)'s [T, hd] slab"} if name != RING_NAMES[0]
                else {})},
            tol_ratio=err[1], planted_fault_ratios=faults[name],
            launch_fault=launch_check,
            ms=time_ms(run), ms_events=events_ms(run), plain_ms=plain_ms,
            library_ms=library_ms, launches=None, bound_ms=bms, bound_by=bby, shapes=shapes,
            sm90=sm90_report(name, hd),
            notes="plain_ms of dq and dk/dv: the whole plain backward of the hop; library_ms: "
                  "SDPA (no causal mask, enable_gqa), its forward for the forward kernel, its "
                  "backward (dq, dk, dv in one call) for the backward kernels",
        ))
        log(f"kernel {name} ok: {json.dumps(rows[-1])}")
    return rows


def write_corpus(root: str, n: int = 24, seconds: float = 30.0, seed: int = 0):
    """n seeded WAV clips (16 kHz, 16-bit, a tone plus noise) and an
    examples.json of prompts and responses -> (data_path, audio_dir)."""
    import os

    from audio_llama_tpu_torch.data import audio_io

    audio_dir = os.path.join(root, "audio")
    os.makedirs(audio_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    entries = []
    for i in range(n):
        wav = 0.2 * np.sin(2 * np.pi * (180 + 20 * i) * t) + 0.05 * rng.normal(size=t.shape)
        audio_io.write_wav(os.path.join(audio_dir, f"clip_{i}.wav"), wav.astype(np.float32),
                           16000)
        entries.append({"text": f"Transcribe clip {i}: <audio>", "audio_paths": f"clip_{i}.wav",
                        "response": f"this is clip number {i}, a tone of {180 + 20 * i} hertz"})
    data_path = os.path.join(root, "examples.json")
    with open(data_path, "w") as f:
        json.dump(entries, f)
    return data_path, audio_dir


def _read_checkpoint(path):
    from audio_llama_tpu_torch.training import checkpoint as ckpt
    from audio_llama_tpu_torch.training import msgpack_io

    with open(f"{path}/{ckpt.CKPT_FILE}", "rb") as f:
        return msgpack_io.restore(f.read())


def _leaves(tree, prefix=""):
    """{dotted name: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def train_run(dev, data_path, audio_dir, out, flags, label):
    """One in-process run of the port's trainer at full width -> (stats,
    launches, result)."""
    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.training.train import _flops_per_step, parse_args, train

    args = parse_args(["--data_path", data_path, "--audio_dir", audio_dir, "--output_dir", out,
                       "--synthetic_flagship", "--tokenizer", "byte", "--val_split", "0.1",
                       "--log_steps", "1", "--no_tensorboard", "--num_workers", "4",
                       "--text_max_length", "512", *flags])
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train(args)
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = AudioLLMConfig()
    micro = args.grad_accum_steps * result["steps"]
    tokens = args.batch_size * args.grad_accum_steps * (args.text_max_length + cfg.audio_seq_len + 2)
    steady = result["step_seconds"][1:] or result["step_seconds"]
    step_s = float(np.median(steady))
    flops = _flops_per_step(cfg, args.batch_size * (args.text_max_length + cfg.audio_seq_len + 2),
                            args.batch_size * cfg.audio_seq_len, args.grad_accum_steps)
    loss, gnorm = result.get("train/loss"), result.get("train/grad_norm")
    if not (loss is not None and np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{label}: loss {loss}, grad norm {gnorm}")
    stats = {
        "label": label, "flags": flags, "steps": result["steps"], "micro_batches": micro,
        "train_loss": loss, "grad_norm": gnorm, "eval_loss": result.get("eval/loss"),
        "step_ms_each": [x * 1e3 for x in result["step_seconds"]],
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": flops / step_s / H100_BF16_FLOPS,
        "mfu_note": "the JAX trainer's FLOP count (2 x encoder params x frames + 6 x decoder "
                    "params x tokens), which leaves out attention and the unembedding",
        "peak_mem_gb": peak_gb, "wall_s": wall, "launches": launches,
    }
    return stats, launches, result


RUN_A_FLAGS = ["--batch_size", "2", "--grad_accum_steps", "2", "--max_steps", "3",
               "--warmup_steps", "1", "--eval_batch_size", "2", "--eval_steps", "2",
               "--save_steps", "2"]


def train_path(dev, tmp: str, profile: bool = False):
    """The port's trainer in-process at full width (`--synthetic_flagship
    --tokenizer byte`, LoRA r64) on 24 seeded 30 s WAV clips written under
    `tmp`: run A (B 2, 2 micro-batches a step, 3 steps, eval and save at
    step 2; its outputs stay in `tmp/run_A` for `sharded_train_path`) and
    run B (B 8, `--remat --loss_chunk_size 256`, 2 steps). Checks the
    losses, the updates, every kernel's launches and the checkpoints'
    reload."""
    import shutil

    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.models import allm
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.training import checkpoint as ckpt

    L, W = full_config().llama.num_layers, full_config().whisper.num_layers
    data_path, audio_dir = write_corpus(tmp)
    runs = {}
    for label, flags, micro, evals, remat in (
            ("A", RUN_A_FLAGS, 6, 2, False),
            ("B", ["--batch_size", "8", "--grad_accum_steps", "1", "--remat",
                   "--loss_chunk_size", "256", "--max_steps", "2", "--eval_steps", "0",
                   "--save_steps", "0"], 2, 1, True)):
        out = f"{tmp}/run_{label}"
        stats, launches, result = train_run(dev, data_path, audio_dir, out, flags,
                                            f"train run {label}")
        want = {
            "causal_attention": L * ((2 if remat else 1) * micro + evals),
            "causal_attention_dq": L * micro, "causal_attention_dkv": L * micro,
            "mel_power": micro + evals, "enc_attention": W * (micro + evals),
            "layer_norm": 2 * W * (micro + evals),
        }
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"train run {label}: {name} launched {launches[name]} "
                                     f"times, want {n}")
        # the final checkpoint reloads bit for bit, through the trainer's
        # loader and through the inference CLI's
        final = result["final_checkpoint"]
        saved = _leaves(_read_checkpoint(final)["model"]["trainable"])
        cfg, frozen, by_cli, _ = cli.load_audio_llm(final, device=dev)
        del frozen
        template = allm.init_trainable(cfg, make_generator(0, dev))
        by_ckpt, opt, step, _ = ckpt.load_checkpoint(final, trainable_template=template)
        for tree in (by_cli, by_ckpt):
            for name, p in tree.named_parameters():
                if not np.array_equal(p.detach().cpu().numpy(), saved[name]):
                    raise AssertionError(f"train run {label}: {name} does not reload "
                                         "bit for bit")
        if step != result["steps"] or int(opt["1"]["0"]["count"]) != step:
            raise AssertionError(f"train run {label}: checkpoint step {step}")
        if label == "A":
            # step 1 runs at lr 0 (warm-up from 0); step 2 at the peak
            # must move the trainable
            init = allm.init_trainable(cfg, make_generator(42 + 1, dev))
            at2 = _leaves(_read_checkpoint(f"{out}/checkpoint-2")["model"]["trainable"])
            moved = sum(not np.array_equal(p.detach().cpu().numpy(), at2[n])
                        for n, p in init.named_parameters())
            if moved == 0 or not any(not np.array_equal(at2[n], saved[n]) for n in saved):
                raise AssertionError("train run A: the update did not move the trainable")
            stats["leaves_moved_by_step_2"] = moved
            del init
        stats["checkpoint_reload"] = "bit-equal (trainer loader, inference CLI)"
        log(json.dumps({"train_path": stats}))
        runs[label] = launches
        del by_cli, by_ckpt, template
        torch.cuda.empty_cache()
        if label == "B":
            shutil.rmtree(out)
    if profile:
        train_profile(dev, data_path, audio_dir)
    return runs["A"]


def train_profile(dev, data_path, audio_dir):
    """torch.profiler breakdown of one run-A train step (B 2, 2 micro-batches)."""
    from audio_llama_tpu_torch.data.loader import create_dataloaders
    from audio_llama_tpu_torch.data.dataset import DatasetConfig
    from audio_llama_tpu_torch.data.tokenizer import ByteTokenizer
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm
    from audio_llama_tpu_torch.parallel import sharded_train
    from audio_llama_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from audio_llama_tpu_torch.training import optim
    from audio_llama_tpu_torch.training.train import build_frozen, group_by_modality, to_device

    cfg = full_config()
    tk = ByteTokenizer()
    loader, _, _ = create_dataloaders(data_path, audio_dir, tk, batch_size=2,
                                      dataset_config=DatasetConfig(text_max_length=512))
    batch = to_device(next(group_by_modality(loader, 2)), dev)
    frozen = build_frozen(cfg, 42, dev)
    mesh = make_mesh(MeshConfig(dp=1))  # one process: the trainer's mesh of one position
    state = sharded_train.init_sharded_state(
        mesh, allm.init_trainable(cfg, make_generator(43, dev)),
        lambda p: optim.OptaxAdamW(p, lambda c: 2e-5, weight_decay=0.01, max_grad_norm=2.0))
    step = sharded_train.make_sharded_train_step(
        cfg, None, mesh, None, tk.token_to_id("<audio>"), tk.token_to_id("</audio>"),
        accum_steps=2)
    box = {"state": state}

    def run():
        box["state"], metrics = step(box["state"], frozen, batch)
        float(metrics["loss"])

    run()
    log(json.dumps({"profile": {"path": "train step, B=2 x 2 micro-batches, T=2014",
                                **device_profile(run)}}))


def host_check_train(dev):
    """One train step at 2 + 2 layers, full width, from the same weights on
    the card (kernels, bf16) and on the host (plain, f32): the loss, every
    trainable leaf's gradient (within HOST_GRAD_TOL) and the updated leaves
    (AdamW at the trainer's default lr 2e-5). Adam's first update is lr * sign(g) per element, so a
    leaf that starts at zero (the projector's biases) is its update alone and
    an element whose gradient is near 0 may take either sign: such leaves
    are held by the share of elements whose update has the host's sign. The
    card's optimizer fed the host's gradients must give the host's leaves."""
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm, llama
    from audio_llama_tpu_torch.training import optim, train_step

    cfg = cut_config()
    t0 = time.perf_counter()
    gen = make_generator(8, "cpu")
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.float32)
    rng = np.random.default_rng(8)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.02))
    T = 40
    ids = rng.integers(0, cfg.llama.vocab_size, (1, T)).astype(np.int32)
    labels = np.where(np.arange(T) >= 16, ids, -100).astype(np.int32)
    wav = (rng.normal(size=(1, cfg.mel.max_samples)) * 0.1).astype(np.float32)
    batch = allm.AudioLLMBatch(*(torch.from_numpy(x) for x in (ids, np.ones_like(ids), wav,
                                                                labels)))
    names = [n for n, _ in trainable.named_parameters()]
    before = {n: p.detach().clone() for n, p in trainable.named_parameters()}

    def update(tr, grads):
        """AdamW's first step on `tr` from `grads` -> {name: updated leaf}."""
        params = list(tr.parameters())
        opt = optim.OptaxAdamW(params, lambda c: 2e-5, weight_decay=0.01, max_grad_norm=2.0)
        for p, g in zip(params, grads):
            p.grad = g.to(p.device)
        gnorm = opt.step()
        return float(gnorm), {n: p.detach().float().cpu() for n, p in zip(names, params)}

    def one_step(fz, tr, cd, d):
        tr.requires_grad_(True)
        b = allm.AudioLLMBatch(*(x.to(d) for x in batch))
        loss, _ = allm.forward(fz, tr, cfg, b, AUDIO_START, AUDIO_END, cd)
        grads = train_step.gradients(loss, list(tr.parameters()))
        gnorm, leaves = update(tr, grads)
        return loss.item(), gnorm, dict(zip(names, (g.float().cpu() for g in grads))), leaves

    card = one_step(copy.deepcopy(frozen).to(dev), copy.deepcopy(trainable).to(dev),
                    torch.bfloat16, dev)
    host = one_step(frozen.float(), copy.deepcopy(trainable), torch.float32, torch.device("cpu"))
    _, card_opt = update(copy.deepcopy(trainable).to(dev), [host[2][n] for n in names])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    zero_init = [n for n in names if not before[n].any()]
    grad_rel = {n: rel(card[2][n], host[2][n]) for n in names}
    leaf_rel = {n: rel(card[3][n], host[3][n]) for n in names if n not in zero_init}
    sign_share = {n: (torch.sign(card[3][n]) == torch.sign(host[3][n])).float().mean().item()
                  for n in zero_init}
    opt_rel = {n: rel(card_opt[n], host[3][n]) for n in names}
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    stats = {"layers": "2 whisper + 2 llama, full width", "tokens": cfg.audio_seq_len + 2 + T,
             "loss": {"card": card[0], "host": host[0], "rel": loss_rel},
             "grad_norm": {"card": card[1], "host": host[1]},
             "grad_rel_l2": grad_rel, "grad_rel_l2_max": max(grad_rel.values()),
             "updated_leaf_rel_l2_max": max(leaf_rel.values()),
             "zero_init_leaves_update_sign_share_min": min(sign_share.values()),
             "card_optimizer_on_host_grads_rel_l2_max": max(opt_rel.values()),
             "bars": {"loss_rel": 1e-2, "grad_rel_l2": HOST_GRAD_TOL,
                      "updated_leaf_rel_l2": HOST_TOL,
                      "zero_init_sign_share": 0.95, "card_optimizer_rel_l2": 1e-6},
             "seconds": time.perf_counter() - t0}
    if not (np.isfinite(card[0]) and loss_rel <= 1e-2
            and stats["grad_rel_l2_max"] <= HOST_GRAD_TOL
            and stats["updated_leaf_rel_l2_max"] <= HOST_TOL
            and stats["zero_init_leaves_update_sign_share_min"] >= 0.95
            and stats["card_optimizer_on_host_grads_rel_l2_max"] <= 1e-6):
        raise AssertionError(f"host check, train step: {stats}")
    log(json.dumps({"host_check_train": stats}))


# ---------------------------------------------------------------------------
# phases 12 and 13: timeline-sharded decode kernels, then the multi-rank paths
# ---------------------------------------------------------------------------

SP_WINDOWS = 4  # 30 s windows of the sp serving path (a), two per rank
DB_ROWS = {  # name -> (format, TPU kernel it replaces)
    "decode_attention_db_stats": (16, "audio_llama_tpu/ops/decode_attention_db.py:29"),
    "decode_attention_quantized_db_stats": (8, "audio_llama_tpu/ops/decode_attention_db.py:151"),
    "decode_attention_quantized4_db_stats": (4, "audio_llama_tpu/ops/decode_attention_db.py:535"),
}
STATS_REL = 1e-5  # m and l against the plain version: the same f32 sums in another order
# two half-slabs merged vs the mono kernel on the whole slab: P is rounded to
# bf16 at each half's own max there and at the whole slab's max here, the
# attention forwards' reason for their bar (ATOL_ROW_RMS_FRAC)
MERGE_FRAC = 3e-2
MULTI_LABEL = "2 ranks time-sharing one H100 over gloo"


def sp_slots(cfg, windows=SP_WINDOWS, prompt=PROMPT, new=N_NEW, sp=2):
    """(local slots of each sp rank, prefix length) of the sp serving path."""
    prefix = windows * cfg.audio_seq_len + 2 + prompt
    return _rounded_len(-(-(prefix + new) // sp)), prefix


def stats_ratio(got, want) -> float:
    """max |got - want| / (STATS_REL |want|) of m or l (0 where both are 0)."""
    err = (got.float() - want.float()).abs()
    bar = STATS_REL * want.float().abs()
    return torch.where(err == 0, 0.0, err / bar.clamp(min=1e-30)).max().item()


def db_reject(name, fault, got, want, frac) -> dict:
    """A stats kernel run on a planted fault must fail the check it passed:
    m or l outside STATS_REL, or acc outside its bar -> each one's ratio."""
    ratios = {"m": stats_ratio(got[0], want[0]), "l": stats_ratio(got[1], want[1]),
              "acc": tol_ratio(got[2], want[2], frac)}
    if not max(ratios.values()) > 1:
        raise AssertionError(f"{name}: the planted fault '{fault}' passes the check {ratios}")
    return ratios


def db_case(dev, gen, bits, B, S, L, Hkv, Hq, hd):
    """Random inputs of one stats-kernel call: (q, fresh rows, caches,
    scales, fresh scales); int8/int4 caches as random bytes and scales."""
    bf = torch.bfloat16

    def rand_bytes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def rand_scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.002 + 0.0002

    q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(bf)
    if bits == 16:
        rows = [torch.randn((B, Hkv, hd), generator=gen, device=dev).to(bf) for _ in range(2)]
        caches = [torch.randn((L, B, Hkv, S, hd), generator=gen, device=dev).to(bf)
                  for _ in range(2)]
        return dict(q=q, rows=rows, caches=caches, scales=None, fresh=None)
    n = 2 if bits == 8 else 1
    return dict(q=q, rows=[rand_bytes(B, Hkv, hd) for _ in range(n)],
                caches=[rand_bytes(L, B, Hkv, S, hd) for _ in range(n)],
                scales=[rand_scales(L, B, Hkv, S) for _ in range(2)],
                fresh=[rand_scales(B, Hkv) for _ in range(2)])


def db_call(case, bits, li, off, valid, scale, cuda=True, fresh=None):
    """One stats-kernel call on copies of the case's caches -> (m, l, acc,
    caches after). fresh: the fresh rows' scales to pass (a fault plants
    others)."""
    from audio_llama_tpu_torch.ops import decode_attention_db as db

    caches = [c.clone() for c in case["caches"]]
    q, rows = case["q"], case["rows"]
    if bits == 16:
        fn = db.db_stats_cuda if cuda else db.db_stats_plain
        m, l, acc, *_ = fn(q, rows[0], rows[1], caches[0], caches[1], li, off, valid, scale)
    elif bits == 8:
        fn = db.db_stats_q8_cuda if cuda else db.db_stats_q8_plain
        m, l, acc, *_ = fn(q, rows[0], rows[1], caches[0], caches[1], *case["scales"],
                           *(fresh or case["fresh"]), li, off, valid, scale)
    else:
        fn = db.db_stats_q4_cuda if cuda else db.db_stats_q4_plain
        m, l, acc, *_ = fn(q, rows[0], caches[0], *case["scales"], *(fresh or case["fresh"]),
                           li, off, valid, scale)
    return m, l, acc, caches


def mono_call(case, bits, li, off, valid, scale):
    """The already-ported mono kernel on the whole slab (offset a [B] tensor)."""
    from audio_llama_tpu_torch.ops import decode_attention_mono as dm

    caches = [c.clone() for c in case["caches"]]
    q, rows = case["q"], case["rows"]
    if bits == 16:
        return dm.decode_attention_cuda(q, rows[0], rows[1], caches[0], caches[1], li, off,
                                        valid, scale)[0]
    ks, vs = (s.clone() for s in case["scales"])
    ksn, vsn = case["fresh"]
    B = q.shape[0]
    ks[li, torch.arange(B), :, off.long()] = ksn  # the caller writes the append scales
    vs[li, torch.arange(B), :, off.long()] = vsn
    if bits == 8:
        return dm.decode_attention_q8_cuda(q, rows[0], rows[1], caches[0], caches[1], ks, vs,
                                           ksn, vsn, li, off, valid, scale)[0]
    return dm.decode_attention_q4_cuda(q, rows[0], caches[0], ks, vs, ksn, vsn, li, off, valid,
                                       scale)[0]


def sdpa_slab(case, bits, valid, scale, turn):
    """-> fn() running SDPA (the yardstick of the slab kernels, never used by
    the port) over the case's slab of the next layer in `turn`: K/V
    dequantized to bf16 and repeated per query head ahead of time, the
    valid mask as its boolean mask."""
    import torch.nn.functional as F

    q = case["q"]
    Hq, Hkv = q.shape[1], case["caches"][0].shape[2]
    L = case["caches"][0].shape[0]
    if bits == 16:
        kd, vd = case["caches"]
    else:
        from audio_llama_tpu_torch.models.llama import unpack_kv4

        ks, vs = case["scales"]
        kq, vq = case["caches"] if bits == 8 else unpack_kv4(case["caches"][0])
        kd = kq.to(torch.bfloat16) * ks[..., None].to(torch.bfloat16)
        vd = vq.to(torch.bfloat16) * vs[..., None].to(torch.bfloat16)
    kd, vd = (t.repeat_interleave(Hq // Hkv, dim=2) for t in (kd, vd))
    dmask = (valid != 0)[:, None, None, :]

    def sdpa():
        li = next(turn) % L
        return F.scaled_dot_product_attention(q[:, :, None, :], kd[li], vd[li],
                                              attn_mask=dmask, scale=scale)

    return sdpa


def db_kernel_checks(dev, gen):
    """The three stats kernels at the sp serving path's local slab (28
    layers, 8 KV heads, S local slots), B 1 and 4, against their plain
    versions: an owner and a non-owner rank, an all-invalid slab; planted
    faults; two half-slabs merged against the mono kernel on the whole
    slab; timed beside the plain version and SDPA over the same slab."""
    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.ops.attention import merge_stats

    lc = full_config().llama
    L, Hkv, Hq, hd = lc.num_layers, lc.num_kv_heads, lc.num_heads, lc.head_dim
    S, prefix = sp_slots(full_config())
    glob = prefix + N_NEW - 2  # the last decode step's slot
    own = glob - S  # its local slot on rank 1 of 2
    scale, li = hd ** -0.5, min(5, L - 1)
    frac = ATOL_ROW_RMS_FRAC["decode_attention_db_stats"]
    kpos = torch.arange(S, device=dev)[None, :]
    rows = []
    for name, (bits, replaces) in DB_ROWS.items():
        results, faults = {}, {}
        for B in (1, 4):
            case = db_case(dev, gen, bits, B, S, L, Hkv, Hq, hd)
            valid = (kpos <= own).to(torch.int32).repeat(B, 1)
            for b in range(B):  # a few masked slots per row
                valid[b, 100 * b + 3:100 * b + 10] = 0
            past = torch.ones_like(valid)
            past[:, 7:19] = 0
            for kind, off, vmask in (("owner", own, valid), ("non-owner", S + 16, past),
                                     ("all-invalid", own, torch.zeros_like(valid))):
                m, l, acc, caches = db_call(case, bits, li, off, vmask, scale)
                wm, wl, wacc, wcaches = db_call(case, bits, li, off, vmask, scale, cuda=False)
                torch.cuda.synchronize()
                label = f"{name} B={B} {kind}"
                err, ratio = check_close(label, acc, wacc, frac)
                rm, rl = stats_ratio(m, wm), stats_ratio(l, wl)
                if max(rm, rl) > 1:
                    raise AssertionError(f"{label}: m/l outside rel {STATS_REL} ({rm}, {rl})")
                for got_c, want_c, before in zip(caches, wcaches, case["caches"]):
                    if not torch.equal(got_c, want_c):
                        raise AssertionError(f"{label}: the cache differs from the plain one")
                    if kind == "non-owner" and not torch.equal(got_c, before):
                        raise AssertionError(f"{label}: a non-owner changed its cache")
                if kind == "all-invalid" and not (bool((m == -5e29).all()) and not l.any()
                                                  and not acc.any()):
                    raise AssertionError(f"{label}: want (-5e29, 0, 0)")
                results[f"B={B} {kind}"] = dict(acc_max_abs_err=err, acc_tol_ratio=ratio,
                                                m_ratio=rm, l_ratio=rl)
            # planted faults, at B = 4 against the plain version's right answer
            if B == 4:
                want = db_call(case, bits, li, S + 16, past, scale, cuda=False)
                wrong = db_call(case, bits, li, S // 2, past, scale)  # a non-owner appends
                faults["non-owner appends"] = db_reject(name, "non-owner appends", wrong,
                                                        want, frac)
                if torch.equal(wrong[3][0], want[3][0]):
                    raise AssertionError(f"{name}: the wrongly appended row left no trace")
                if bits != 16:
                    want = db_call(case, bits, li, own, valid, scale, cuda=False)
                    ones = [torch.ones_like(s) for s in case["fresh"]]
                    dropped = db_call(case, bits, li, own, valid, scale, fresh=ones)
                    faults["fresh row's scales dropped"] = db_reject(
                        name, "fresh row's scales dropped", dropped, want, frac)
                # an unclamped row max on an all-invalid slab: m = -1e30
                m0 = db_call(case, bits, li, own, torch.zeros_like(valid), scale)[0]
                ratio = stats_ratio(torch.full_like(m0, -1e30), m0)
                if not ratio > 1:
                    raise AssertionError(f"{name}: the m check passes an unclamped row max")
                faults["unclamped m, all-invalid slab"] = ratio
                # two half-slabs merged vs the mono kernel over the whole slab
                whole = db_case(dev, gen, bits, B, 2 * S, L, Hkv, Hq, hd)
                wvalid = (torch.arange(2 * S, device=dev)[None, :] <= glob).to(
                    torch.int32).repeat(B, 1)
                wvalid[:, 700:710] = 0
                parts = []
                for r in range(2):
                    half = dict(whole, caches=[c[:, :, :, r * S:(r + 1) * S].contiguous()
                                               for c in whole["caches"]])
                    if bits != 16:
                        half["scales"] = [s[..., r * S:(r + 1) * S].contiguous()
                                          for s in whole["scales"]]
                    parts.append(db_call(half, bits, li, glob - r * S,
                                         wvalid[:, r * S:(r + 1) * S].contiguous(), scale))
                merged = merge_stats(*(torch.stack([p[i] for p in parts]) for i in range(3)),
                                     pmax=lambda t: t.amax(dim=0, keepdim=True),
                                     psum=lambda t: t.sum(dim=0))
                mono = mono_call(whole, bits, li, torch.full((B,), glob, dtype=torch.int32,
                                                             device=dev), wvalid, scale)
                merge = dict(zip(("max_abs_err", "tol_ratio"),
                                 check_close(f"{name} merged", merged, mono, MERGE_FRAC)),
                             tol=tol_entry(MERGE_FRAC))
                del whole, parts
        # times at B = 1, rank 1's slab at the last decode step
        case = db_case(dev, gen, bits, 1, S, L, Hkv, Hq, hd)
        valid = (kpos <= own).to(torch.int32)
        n_valid = int(valid.sum())
        row_bytes = {16: 4 * hd, 8: 2 * hd + 8, 4: hd + 8}[bits]
        nbytes = (Hkv * n_valid * row_bytes + 2.0 * Hq * hd + Hkv * row_bytes
                  + 4.0 * Hq * (hd + 2) + 4.0 * S)
        bms, bby = bound(4.0 * Hq * n_valid * hd, nbytes)
        turn = itertools.count()
        sdpa = sdpa_slab(case, bits, valid, scale, turn)
        fns = {16: (db.db_stats_cuda, db.db_stats_plain), 8: (db.db_stats_q8_cuda,
                                                            db.db_stats_q8_plain),
               4: (db.db_stats_q4_cuda, db.db_stats_q4_plain)}[bits]
        args = [case["q"], *case["rows"], *case["caches"], *(case["scales"] or []),
                *(case["fresh"] or [])]

        def kernel(fn):  # a rank that does not own the fresh row: the slab is only read
            return fn(*args, next(turn) % L, S + 16, valid, scale)

        # CUPTI sums: a call lasts about as long as its wrapper's host work,
        # so CUDA events around back-to-back calls read the host's pace
        # (`ms_events` keeps that reading beside them)
        ms = time_ms(lambda: kernel(fns[0]), iters=112)
        ms_events = events_ms(lambda: kernel(fns[0]), iters=112)
        plain_ms = events_ms(lambda: kernel(fns[1]), iters=10)
        library_ms = time_ms(sdpa, iters=112)
        del sdpa
        row = dict(
            name=name, route="cuda", source="audio_llama_tpu_torch/csrc/decode_attention_db.cu",
            replaces=replaces,
            max_abs_err=max(r["acc_max_abs_err"] for r in results.values()),
            tol={**tol_entry(frac), "m_l_rel": STATS_REL},
            tol_ratio=max(r["acc_tol_ratio"] for r in results.values()),
            checks=results, merge_of_2_half_slabs_vs_mono=merge,
            planted_fault_ratios=faults, ms=ms, ms_events=ms_events, plain_ms=plain_ms,
            library_ms=library_ms,
            library_note="SDPA over the same slab (K/V bf16, dequantized and repeated per query "
                         "head ahead of time); SDPA normalizes its output, the kernel returns "
                         "unnormalized m, l, acc",
            launches=None, bound_ms=bms, bound_by=bby,
            shapes=f"local slab [{L},B,{Hkv},{S},{hd}] ({'bf16 K and V' if bits == 16 else 'int8 K and V' if bits == 8 else 'int4 K/V combined'}), q[B,{Hq},{hd}] bf16, B 1 and 4; timed at B=1 with {n_valid} valid slots, the fresh row on another rank",
        )
        log(f"kernel {name} ok: {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 16: the inference CLI's --decode_impl arms (decode_kernel, decode_packed)
# ---------------------------------------------------------------------------

AB_ROWS = {  # kernel row -> (cache bits of its instances, TPU kernel it replaces, source)
    "decode_attention_db": ((16,), "audio_llama_tpu/ops/decode_attention_db.py:29",
                            "audio_llama_tpu_torch/csrc/decode_attention_db.cu"),
    "decode_attention_quantized_db": ((8,), "audio_llama_tpu/ops/decode_attention_db.py:151",
                                      "audio_llama_tpu_torch/csrc/decode_attention_db.cu"),
    "decode_attention_quantized4_db": ((4,), "audio_llama_tpu/ops/decode_attention_db.py:535",
                                       "audio_llama_tpu_torch/csrc/decode_attention_db.cu"),
    "decode_attention_packed": ((16, 8), "audio_llama_tpu/ops/decode_attention_packed.py:69",
                                "audio_llama_tpu_torch/csrc/decode_attention_packed.cu"),
}
AB_FAULT_OFFSET = 40  # a request's early step: one slot of 41 carries the fresh row's weight


def ab_call(name, case, bits, li, off, valid, scale, cuda=True, rows=None, fresh=None,
            copy=True):
    """One call of a --decode_impl kernel (or its plain version) on copies of
    the case's caches (on the caches themselves with copy=False) -> (out,
    caches after). rows / fresh: the fresh rows and their scales to pass (a
    fault plants others)."""
    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk

    caches = [c.clone() for c in case["caches"]] if copy else case["caches"]
    q, rows, fresh = case["q"], rows or case["rows"], fresh or case["fresh"]
    if name == "decode_attention_packed":
        fn = pk.packed_cuda if cuda else pk.packed_plain
        quant = None if bits == 16 else (*case["scales"], *fresh)
        return fn(q, rows[0], rows[1], caches[0], caches[1], li, off, valid, scale,
                  quant_args=quant)[0], caches
    if bits == 16:
        fn = db.db_cuda if cuda else db.db_plain
        return fn(q, rows[0], rows[1], caches[0], caches[1], li, off, valid, scale)[0], caches
    if bits == 8:
        fn = db.db_q8_cuda if cuda else db.db_q8_plain
        return fn(q, rows[0], rows[1], caches[0], caches[1], *case["scales"], *fresh, li, off,
                  valid, scale)[0], caches
    fn = db.db_q4_cuda if cuda else db.db_q4_plain
    return fn(q, rows[0], caches[0], *case["scales"], *fresh, li, off, valid, scale)[0], caches


def check_append(label, got, want, before, rows, li, off):
    """The kernel's caches equal the plain version's; only slot `off` of layer
    li changed, and it holds the fresh rows."""
    for g, w, b, r in zip(got, want, before, rows):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: the cache differs from the plain version's")
        changed = (g != b).any(dim=-1)
        changed[li, :, :, off] = False
        if changed.any() or not torch.equal(g[li, :, :, off], r):
            raise AssertionError(f"{label}: the append is not the fresh row at the offset")


def ab_kernel_checks(dev, gen):
    """The four kernels of the --decode_impl arms (the normalized db kernels
    on bf16, int8 and int4 caches, the packed kernel on bf16 and int8 caches)
    at the decoder's geometry (28 layers, 8 KV heads, 24 query heads), the
    bf16 path's timeline and 3040 slots, B 1 and 4, against their plain
    versions: the output within the bar, the caches bit-equal; planted
    faults; timed at B = 1, 3040 slots, beside the plain version and SDPA."""
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk

    cfg = full_config()
    lc = cfg.llama
    L, Hkv, Hq, hd = lc.num_layers, lc.num_kv_heads, lc.num_heads, lc.head_dim
    scale, li = hd ** -0.5, min(5, L - 1)
    timelines = (_rounded_len(cfg.audio_seq_len + 2 + PROMPT + N_NEW), 3040)
    rows = []
    for name, (instances, replaces, source) in AB_ROWS.items():
        frac = ATOL_ROW_RMS_FRAC[name]
        results, faults, times = {}, {}, {}
        for bits, S, B in itertools.product(instances, timelines, (1, 4)):
            case = db_case(dev, gen, bits, B, S, L, Hkv, Hq, hd)
            kpos = torch.arange(S, device=dev)[None, :]
            off = S - 24  # a decode step's slot, slots still ahead of it
            valid = (kpos <= off).to(torch.int32).repeat(B, 1)
            for b in range(B):  # a few masked slots per row
                valid[b, 100 * b + 3:100 * b + 10] = 0
            got, gc = ab_call(name, case, bits, li, off, valid, scale)
            want, wc = ab_call(name, case, bits, li, off, valid, scale, cuda=False)
            torch.cuda.synchronize()
            label = f"{name} {bits}-bit cache, S={S}, B={B}"
            err, ratio = check_close(label, got, want, frac)
            check_append(label, gc, wc, case["caches"], case["rows"], li, off)
            results[label] = dict(max_abs_err=err, tol_ratio=ratio)
            if B == 4 and S == timelines[1]:
                # planted faults, each against the plain version's right answer
                if name == "decode_attention_packed":
                    drop = valid.clone()  # the kernel forgets the second chunk
                    CH = pk.pick_chunk(S, pk.DEFAULT_CHUNK)
                    drop[:, CH:2 * CH] = 0
                    faults[f"{bits}-bit: a chunk dropped"] = must_reject(
                        name, "a chunk dropped", ab_call(name, case, bits, li, off, drop,
                                                         scale)[0], want, frac)
                else:  # the stats kernel's acc is this kernel without the division by l
                    acc = db_call(case, bits, li, off, valid, scale)[2]
                    faults[f"{bits}-bit: p not normalized"] = must_reject(
                        name, "p not normalized", acc.to(want.dtype), want, frac)
                short = AB_FAULT_OFFSET
                svalid = (kpos <= short).to(torch.int32).repeat(B, 1)
                swant = ab_call(name, case, bits, li, short, svalid, scale, cuda=False)[0]
                check_close(f"{label}, offset {short}",
                            ab_call(name, case, bits, li, short, svalid, scale)[0], swant, frac)
                stale = [c[li, :, :, short].clone() for c in case["caches"]]
                stale_fresh = None if bits == 16 else [s[li, :, :, short].clone()
                                                       for s in case["scales"]]
                faults[f"{bits}-bit: stale row read at offset {short}"] = must_reject(
                    name, "stale row read at the offset",
                    ab_call(name, case, bits, li, short, svalid, scale, rows=stale,
                            fresh=stale_fresh)[0], swant, frac)
            del case, gc, wc
        # times at B = 1, 3040 slots, the last decode step's slot
        S = timelines[1]
        off = S - 24
        valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32)
        n_valid = int(valid.sum())
        for bits in instances:
            case = db_case(dev, gen, bits, 1, S, L, Hkv, Hq, hd)
            turn = itertools.count()

            def kernel(cuda):  # appends at one slot again
                return ab_call(name, case, bits, next(turn) % L, off, valid, scale, cuda=cuda,
                               copy=False)

            row_bytes = {16: 4 * hd, 8: 2 * hd + 8, 4: hd + 8}[bits]
            nbytes = (Hkv * n_valid * row_bytes + 2.0 * Hq * hd * 2 + 4.0 * S
                      + Hkv * row_bytes)
            times[bits] = dict(
                ms=time_ms(lambda: kernel(True), iters=56),
                plain_ms=events_ms(lambda: kernel(False), iters=8),
                library_ms=time_ms(sdpa_slab(case, bits, valid, scale, turn), iters=112),
                bound=bound(4.0 * Hq * n_valid * hd, nbytes))
            del case
        main_bits = instances[-1]  # the instance the path runs (packed: int8)
        t = times[main_bits]
        row = dict(
            name=name, route="cuda",
            source=source, replaces=replaces, max_abs_err=max(r["max_abs_err"] for r in results.values()),
            tol=tol_entry(frac), tol_ratio=max(r["tol_ratio"] for r in results.values()),
            checks=results, planted_fault_ratios=faults, ms=t["ms"], plain_ms=t["plain_ms"],
            library_ms=t["library_ms"],
            library_note="SDPA over the same slab (K/V bf16, dequantized and repeated per query "
                         "head ahead of time)",
            launches=None, bound_ms=t["bound"][0], bound_by=t["bound"][1],
            times_by_cache_bits={b: {k: v for k, v in tt.items() if k != "bound"}
                                 for b, tt in times.items()},
            shapes=f"caches [{L},B,{Hkv},S,{hd}], q [B,{Hq},{hd}] bf16, S {timelines}, B 1 "
                   f"and 4, {'/'.join(f'{b}-bit' for b in instances)} caches; timed at B=1, "
                   f"S={S}, {n_valid} valid slots, the {main_bits}-bit cache",
        )
        log(f"kernel {name} ok: {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def decode_ab_path(ctx, arms) -> dict:
    """The inference CLI's --decode_impl arms on one model at full width:
    for each (key, label, decode_impl, launches wanted), 32 greedy tokens
    through `generate(attn_impl=...)` with the counters zeroed around them:
    tokens well formed, launches exact, the first decode step's logits
    within rel-L2 HOST_TOL of the auto arm's on the same weights, and the
    decode time per token beside auto's, both in this call."""
    from audio_llama_tpu_torch.inference.generate import generate

    cfg, frozen, trainable = ctx["model"]
    ids, mask, audio, kv = ctx["ids"], ctx["mask"], ctx["audio"], ctx["kv_quant"]
    B = ids.shape[0]
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=ids.device, kv_quant=kv, greedy=True)

    def run(n, impl):
        return generate(frozen, trainable, cfg, ids, mask, audio, None, max_new_tokens=n,
                        attn_impl=impl, **kw)

    out = {}
    for key, label, impl, want in arms:
        run(2, impl)
        first_ms = min(synced_ms(lambda: run(1, impl)) for _ in range(2))
        auto_ms = synced_ms(lambda: run(N_NEW, "auto"))
        zero_counters()
        result = {}
        total_ms = synced_ms(lambda: result.setdefault("out", run(N_NEW, impl)))
        launches = read_counters()
        toks = result["out"].tokens
        check_tokens(label, toks, (B, N_NEW), cfg.llama.vocab_size + 2)
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                     f"want {n}")
        arm = first_step_logits(frozen, trainable, cfg, ids, mask, audio, kv, attn_impl=impl)
        auto = first_step_logits(frozen, trainable, cfg, ids, mask, audio, kv, megakernel=True)
        rel = rel_l2(arm, auto)
        if not (torch.isfinite(arm).all() and rel <= HOST_TOL):
            raise AssertionError(f"{label}: first decode step's logits rel-L2 {rel} vs the auto "
                                 f"arm (bar {HOST_TOL})")
        stats = dict(
            label=label, decode_impl=impl, batch=B, new_tokens=N_NEW, config=ctx["config"],
            decode_ms_per_token=(total_ms - first_ms) / (N_NEW - 1),
            auto_decode_ms_per_token=(auto_ms - first_ms) / (N_NEW - 1),
            first_step_logits_rel_l2_vs_auto=rel, tol_rel_l2=HOST_TOL,
            first_step_argmax_agree=(arm.argmax(-1) == auto.argmax(-1)).float().mean().item(),
            tokens=toks.tolist(), launches=launches)
        log(json.dumps({"decode_ab_path": stats}))
        out[key] = launches
    return out


def gloo_probe(dev) -> dict:
    """Which gloo collectives take CUDA tensors here: each op once, straight
    on the card's tensors (not through parallel/collectives.py), on the
    world's group."""
    import torch.distributed as dist

    out = {}
    # the cost of one all-reduce of the sizes the paths send: the sp merge's
    # [B, Hq, hd + 1] f32 and tp's [B, 1, 3072] bf16 at B = 1, handed to
    # gloo on the card or copied through the host first (ms per call, both
    # ranks on one card)
    for tag, shape, dt in (("sp merge [1,24,129] f32", (1, 24, 129), torch.float32),
                           ("tp psum [1,1,3072] bf16", (1, 1, 3072), torch.bfloat16)):
        x = torch.ones(shape, dtype=dt, device=dev)
        for how, fn in (("cuda tensor", lambda: dist.all_reduce(x)),
                        ("through the host", lambda: x.copy_(_host_all_reduce(x)))):
            fn()
            out[f"all_reduce ms, {tag}, {how}"] = min(
                synced_ms(lambda: [fn() for _ in range(20)]) / 20 for _ in range(3))
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        tag = str(dt).replace("torch.", "")
        for op, fn in (
            ("all_reduce_sum", lambda x: dist.all_reduce(x)),
            ("all_reduce_max", lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX)),
            ("all_gather", lambda x: dist.all_gather([torch.empty_like(x)
                                                      for _ in range(dist.get_world_size())], x)),
        ):
            x = torch.ones(8, dtype=dt, device=dev)
            try:
                fn(x)
                torch.cuda.synchronize()
                out[f"{op} {tag}"] = "accepted"
            except (RuntimeError, ValueError) as e:
                out[f"{op} {tag}"] = "refused: " + str(e).splitlines()[0][:160]
    # point to point (the ring of sp training): the route
    # `collectives.ppermute` takes here, and one rotation by it. A CUDA
    # tensor is never handed to gloo's send/recv: gloo reads its address as
    # host memory (the transport then fails with "writev ... Bad address"
    # on an H100 under torch 2.11)
    from audio_llama_tpu_torch.parallel import build_mesh, collectives

    x = torch.full((8,), float(dist.get_rank() + 1), device=dev)
    peer = 1 - dist.get_rank()
    axis = build_mesh([("sp", 2)]).axis("sp")
    got = collectives.ppermute_(x, axis)
    if not torch.equal(got, torch.full_like(x, float(peer + 1))):
        raise AssertionError("ppermute: the peer's block did not arrive")
    out["ppermute route"] = collectives.ppermute_route(axis, x)
    return out


def _host_all_reduce(x):
    import torch.distributed as dist

    y = x.cpu()
    dist.all_reduce(y)
    return y.to(x.device)


@torch.no_grad()
def first_step_logits(frozen, trainable, cfg, ids, mask, audio, kv_quant, tp_axis=None,
                      sp_axis=None, megakernel=False, attn_impl="auto"):
    """generate's prefill, then one greedy decode step (through the
    `attn_impl` kernel) -> the f32 logits [B, V] of that step; sharded when
    given the axes."""
    from audio_llama_tpu_torch.inference.generate import prefill
    from audio_llama_tpu_torch.models import llama

    bf = torch.bfloat16
    pre = prefill(frozen, trainable, cfg, ids, mask, audio, ids.device, max_new_tokens=N_NEW,
                  compute_dtype=bf, kv_quant=kv_quant, audio_start_id=AUDIO_START,
                  audio_end_id=AUDIO_END, tp_axis=tp_axis, sp_axis=sp_axis)
    logits, _ = llama.llama_forward(
        frozen["llama"], cfg.llama, input_ids=pre.next_logits.argmax(-1)[:, None],
        attention_mask=pre.full_mask, positions=pre.real_len[:, None], kv_cache=pre.cache,
        lora=pre.lora, compute_dtype=bf, megakernel=megakernel, attn_impl=attn_impl,
        tp_axis=tp_axis, sp_axis=sp_axis)
    return logits[:, 0].float()


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def bf16_model(gen, cfg, lora_a=True):
    """Seeded bf16 weights (vocab + 2 rows) and an f32 trainable tree whose
    LoRA has a non-zero delta."""
    from audio_llama_tpu_torch.models import allm, llama

    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.float32)
    if lora_a:
        for br in trainable["lora"]["layers"].values():
            br["a"].data.copy_(torch.randn(br["a"].shape, generator=gen,
                                           device=br["a"].device) * 0.02)
    return frozen, trainable


def sharded_run(label, dev, fn, ref_fn, n_new, step_logits, want, batch, exact_fn=None):
    """Time one sharded generate (warm-up, 1 token, n_new tokens with the
    counters zeroed around it), check its launches, hold the first decode
    step's logits against the single-process run and report the tokens'
    agreement with it. `exact_fn(n_new)`, where given, -> tokens that the
    sharded run's must equal bit for bit."""
    fn(2)
    first_ms = min(synced_ms(lambda: fn(1)) for _ in range(2))
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("out", fn(n_new)))
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = result["out"].tokens
    check_tokens(label, toks, (batch, n_new), full_config().llama.vocab_size + 2)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, want {n}")
    ref = ref_fn(n_new).tokens
    if exact_fn is not None and not torch.equal(toks, exact_fn(n_new)):
        raise AssertionError(f"{label}: the tokens differ from the single-process runs of "
                             f"the same rows")
    sharded, single = step_logits()
    rel = rel_l2(sharded, single)
    if not (torch.isfinite(sharded).all() and rel <= HOST_TOL):
        raise AssertionError(f"{label}: first decode step's logits rel-L2 {rel} vs the "
                             f"single-process run (bar {HOST_TOL})")
    return dict(
        label=label, timing=MULTI_LABEL, new_tokens=n_new, batch=batch,
        prefill_ms=first_ms, decode_ms_per_token=(total_ms - first_ms) / (n_new - 1),
        generate_ms=total_ms, peak_mem_gb=peak_gb, tokens=toks.tolist(),
        greedy_agreement_with_single_process=(toks == ref).float().mean().item(),
        first_step_logits_rel_l2=rel, tol_rel_l2=HOST_TOL,
        first_step_argmax_agree=(sharded.argmax(-1) == single.argmax(-1)).float().mean().item(),
        launches=launches,
    ), toks


def multi_rank(rank, world, device):
    """One rank of the 2-rank world on `device` (cuda:0; gloo): paths (a)-(d)."""
    from audio_llama_tpu_torch.inference.generate import generate, make_dp_generate, \
        make_tp_generate
    from audio_llama_tpu_torch.models import allm, llama_int4, lora
    from audio_llama_tpu_torch.parallel import build_mesh, make_sp_encode, make_sp_generate, \
        shard_frozen_for_generation
    from audio_llama_tpu_torch.parallel.mesh import AXES

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"gloo_cuda": gloo_probe(dev)}
    sp_mesh = build_mesh([("sp", 2)])
    tp_mesh = build_mesh(list(zip(AXES, (1, 1, 2, 1))))
    dp_mesh = build_mesh([("dp", 2)])
    cfg = full_config()
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    bf = torch.bfloat16
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=bf, device=dev, greedy=True)
    zero = {"decode_attention_mono": 0, "decode_attention_quantized4_mono": 0,
            "decode_attention_quantized_mono": 0, "decode_megakernel": 0}

    # (a) sp = 2, the shipped serving configuration: LoRA merged, fused int4
    # tree, int4 KV, B = 1, four 30 s windows, 32 greedy tokens
    gen = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg)
    wav = torch.randn((1, SP_WINDOWS * cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (1, PROMPT), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    enc = make_sp_encode(cfg, sp_mesh)
    frames = enc(frozen, wav)
    ref_frames = allm.process_audio_features(frozen, cfg, wav)
    enc_rel = rel_l2(frames.float(), ref_frames.float())
    if not (tuple(frames.shape) == tuple(ref_frames.shape) and enc_rel <= HOST_TOL):
        raise AssertionError(f"sp encode: {tuple(frames.shape)} rel-L2 {enc_rel}")
    enc_ms = min(synced_ms(lambda: enc(frozen, wav)) for _ in range(2))
    enc_single_ms = min(synced_ms(lambda: allm.process_audio_features(frozen, cfg, wav))
                        for _ in range(2))
    a_kw = dict(kw, kv_quant=4)
    sp = sp_mesh.axis("sp")

    def run_a(n):
        return make_sp_generate(cfg, sp_mesh, max_new_tokens=n, **a_kw)(
            frozen, trainable, ids, mask, wav)

    stats, toks = sharded_run(
        "sp=2 int4w+kv4, B=1, 4 windows", dev, run_a,
        lambda n: generate(frozen, trainable, cfg, ids, mask, wav, None, max_new_tokens=n,
                           megakernel=False, **a_kw), N_NEW,
        lambda: (first_step_logits(frozen, trainable, cfg, ids, mask, wav, 4, sp_axis=sp),
                 first_step_logits(frozen, trainable, cfg, ids, mask, wav, 4)),
        {**zero, "decode_attention_quantized4_db_stats": L * (N_NEW - 1),
         "decode_attention_quantized_db_stats": 0, "decode_attention_db_stats": 0,
         "layer_norm": 2 * W, "enc_attention": W, "mel_power": 1}, 1)
    stats.update(setup_s=time.perf_counter() - t0, local_slots=sp_slots(cfg)[0],
                 prefix_tokens=sp_slots(cfg)[1], sp_encode_ms=enc_ms,
                 single_encode_ms=enc_single_ms, sp_encode_rel_l2=enc_rel)
    out["a"] = stats
    del frozen, trainable
    torch.cuda.empty_cache()

    # (b) sp = 2 on the bf16 tree (LoRA as an adapter), one window, 8 tokens,
    # an int8 KV cache and a bf16 one
    gen = torch.Generator(device=dev).manual_seed(22)
    frozen, trainable = bf16_model(gen, cfg)
    wav = torch.randn((1, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (1, PROMPT), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    n_b = 8
    for kv, name in ((True, "decode_attention_quantized_db_stats"),
                     (False, "decode_attention_db_stats")):
        b_kw = dict(kw, kv_quant=kv)
        others = {"decode_attention_quantized4_db_stats": 0, "decode_attention_quantized_db_stats": 0,
                  "decode_attention_db_stats": 0}
        stats, _ = sharded_run(
            f"sp=2 bf16w+kv{8 if kv else 16}, B=1", dev,
            lambda n: make_sp_generate(cfg, sp_mesh, max_new_tokens=n, **b_kw)(
                frozen, trainable, ids, mask, wav),
            lambda n: generate(frozen, trainable, cfg, ids, mask, wav, None, max_new_tokens=n,
                               **b_kw), n_b,
            lambda: (first_step_logits(frozen, trainable, cfg, ids, mask, wav, kv, sp_axis=sp),
                     first_step_logits(frozen, trainable, cfg, ids, mask, wav, kv)),
            {**zero, **others, name: L * (n_b - 1)}, 1)
        out["b kv8" if kv else "b kv16"] = stats

    # (d) dp = 2 on the same bf16 tree, B = 4 (two rows per rank), 8 tokens
    B = len(INT4_PROMPTS)
    wav4 = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids4 = torch.randint(0, cfg.llama.vocab_size, (B, max(INT4_PROMPTS)), generator=gen,
                         device=dev)
    mask4 = torch.zeros_like(ids4)
    for b, n in enumerate(INT4_PROMPTS):
        mask4[b, :n] = 1
    ids4 = ids4 * mask4
    rows = slice(2 * dp_mesh.axis("dp").index, 2 * dp_mesh.axis("dp").index + 2)
    d_kw = dict(kw, kv_quant=False)

    def per_group(n):  # each dp group's rows through one process, in group order
        return torch.cat([generate(frozen, trainable, cfg, ids4[g:g + 2], mask4[g:g + 2],
                                   wav4[g:g + 2], None, max_new_tokens=n, **d_kw).tokens
                          for g in (0, 2)])

    # the entry point's tokens must equal the groups' single-process runs
    # bit for bit (the rows' order across the gather included); the logits
    # check holds this rank's rows, run alone in one process, against the
    # whole batch's run: dp's per-rank program at B/dp, not the gather
    stats, _ = sharded_run(
        "dp=2 bf16w+kv16, B=4", dev,
        lambda n: make_dp_generate(cfg, dp_mesh, max_new_tokens=n, **d_kw)(
            frozen, trainable, ids4, mask4, wav4),
        lambda n: generate(frozen, trainable, cfg, ids4, mask4, wav4, None, max_new_tokens=n,
                           **d_kw), n_b,
        lambda: (first_step_logits(frozen, trainable, cfg, ids4[rows], mask4[rows], wav4[rows],
                                   False),
                 first_step_logits(frozen, trainable, cfg, ids4, mask4, wav4, False)[rows]),
        {"decode_attention_mono": L * (n_b - 1), "decode_attention_db_stats": 0}, B,
        exact_fn=per_group)
    out["d"] = stats
    del frozen, trainable
    torch.cuda.empty_cache()

    # (c) tp = 2 on the int4 tree packed after the shard (LoRA merged),
    # int4 KV, B = 4, 16 tokens; the single-process run takes the unfused
    # tp=1 tree of the same weights (the same int4 values, packed whole)
    gen = torch.Generator(device=dev).manual_seed(23)
    frozen, trainable = bf16_model(gen, cfg)
    merged = lora.merge_into_llama(frozen["llama"], lora.with_scaling(trainable["lora"],
                                                                      cfg.lora))
    trainable = type(trainable)({k: v for k, v in trainable.items() if k != "lora"})
    whole = type(frozen)({"llama": llama_int4.quantize_llama_int4(merged, fuse=False),
                          "whisper": frozen["whisper"]})
    packed = type(frozen)({"llama": llama_int4.quantize_llama_int4(merged, tp=2, fuse=False),
                           "whisper": frozen["whisper"]})
    del merged, frozen
    block = shard_frozen_for_generation(tp_mesh, packed)  # for the first-step logits
    torch.cuda.empty_cache()
    wav4 = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    c_kw = dict(kw, kv_quant=4)
    n_c = 16
    tp = tp_mesh.axis("tp")
    stats, _ = sharded_run(
        "tp=2 int4w (tp-packed)+kv4, B=4", dev,
        lambda n: make_tp_generate(cfg, tp_mesh, max_new_tokens=n, **c_kw)(
            packed, trainable, ids4, mask4, wav4),
        lambda n: generate(whole, trainable, cfg, ids4, mask4, wav4, None, max_new_tokens=n,
                           **c_kw), n_c,
        lambda: (first_step_logits(block, trainable, cfg, ids4, mask4, wav4, 4, tp_axis=tp),
                 first_step_logits(whole, trainable, cfg, ids4, mask4, wav4, 4)),
        {**zero, "decode_attention_quantized4_mono": L * (n_c - 1),
         "int4_matmul_stacked": 7 * L * n_c, "mlp_int4_stacked": 0,
         "decode_attention_quantized4_db_stats": 0}, B)
    out["c"] = stats
    return out


def multi_path(dev) -> dict:
    """A world of 2 ranks spawned on cuda:0 over gloo (NCCL refuses two ranks
    on one device), each building its weights from the same seeds: (a) sp=2
    on the serving configuration, (b) sp=2 with int8 and bf16 KV caches on
    the bf16 tree, (c) tp=2 on the tp-packed int4 tree, (d) dp=2. Tokens
    must be identical on both ranks."""
    from audio_llama_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    res = distributed.spawn(multi_rank, 2, backend="gloo", device=str(dev), args=(str(dev),),
                            timeout=900)
    for key in ("a", "b kv8", "b kv16", "c", "d"):
        if res[0][key]["tokens"] != res[1][key]["tokens"]:
            raise AssertionError(f"multi {key}: the ranks' tokens differ")
    log(json.dumps({"multi_path": {
        "timing": MULTI_LABEL, "seconds": time.perf_counter() - t0,
        "gloo_cuda_tensors": res[0]["gloo_cuda"],
        "ranks": [{k: v for k, v in r.items() if k != "gloo_cuda"} for r in res],
    }}))
    return {"sp_int4": res[0]["a"]["launches"], "sp_int8": res[0]["b kv8"]["launches"],
            "sp_bf16": res[0]["b kv16"]["launches"]}


# ---------------------------------------------------------------------------
# phase 15: sharded training, 2 ranks on the card
# ---------------------------------------------------------------------------

TRAIN_ARM_FLAGS = ["--batch_size", "2", "--grad_accum_steps", "2", "--max_steps", "2",
                   "--warmup_steps", "1", "--eval_steps", "0", "--save_steps", "2"]
SHARDED_LOSS_REL = 1e-2  # the first step's loss against the single process (bf16 sums)
SHARDED_GRAD_REL = 3e-2  # gradients (Adam's mu after 2 steps): HOST_GRAD_TOL's reasoning


class CollectiveCounter:
    """Counts the port's collectives (calls and bytes by name) while
    installed: `collectives.psum` (f, g, the sums of the loss and the
    gradients, the clip norm), `all_gather` (the lm_head shards, the
    checkpoint's gather) and `ppermute_` (the ring's rotations)."""

    def __init__(self):
        from audio_llama_tpu_torch.parallel import collectives, ring_kernel, sharded_train, \
            sharding

        self.calls = {}
        self.sites = [(collectives, "psum"), (collectives, "all_gather"),
                      (sharded_train, "psum"), (sharding, "all_gather"),
                      (ring_kernel, "ppermute_")]
        self.saved = [getattr(m, n) for m, n in self.sites]

    def __enter__(self):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)

    def _wrap(self, name, fn):
        def counted(x, axis, *args, **kw):
            if axis is not None and axis.size > 1:
                c = self.calls.setdefault(name, {"calls": 0, "bytes": 0})
                c["calls"] += 1
                c["bytes"] += x.numel() * x.element_size()
            return fn(x, axis, *args, **kw)
        return counted

    def take(self) -> dict:
        out, self.calls = self.calls, {}
        return out


def _digest(trainable, flags) -> str:
    """A hash of the replicated leaves' bytes (bit-equality across ranks)."""
    import hashlib

    h = hashlib.sha256()
    for p, f in zip(trainable.parameters(), flags):
        if not f:
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _timed_steps(record, counter):
    """Wrap `sharded_train.make_sharded_train_step` so that every step it
    makes records its wall ms (synchronized), its collectives, the ring's
    launches and the digest of the replicated leaves after it."""
    from audio_llama_tpu_torch.parallel import sharded_train, sharding

    make = sharded_train.make_sharded_train_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def timed(state, frozen, batch):
            zero_counters()
            counter.take()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, frozen, batch)
            torch.cuda.synchronize()
            c = read_counters()
            record.append({
                "ms": (time.perf_counter() - t0) * 1e3, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]), "collectives": counter.take(),
                "ring_launches": {n: c[n] for n in RING_NAMES},
                "digest": _digest(state.trainable, sharding.sharded_flags(state.trainable))})
            return state, metrics
        return timed

    return make, wrapped


def _gloo_sizes(dev, ranks_axis) -> dict:
    """ms per call of the collectives the arms send, 2 ranks on the card over
    gloo: tp's f/g all-reduce of a [2, 2014, 3072] bf16 activation, the dp /
    sp gradient all-reduce (the trainable's f32 numel), and one ring
    rotation of a [2, 1024, 8, 128] bf16 block through the host."""
    from audio_llama_tpu_torch.parallel import collectives

    out = {}
    for tag, x, fn in (
            ("all_reduce [2,2014,3072] bf16 (tp f/g)",
             torch.ones(2, 2014, 3072, dtype=torch.bfloat16, device=dev),
             lambda t: collectives.psum(t, ranks_axis)),
            ("ppermute [2,1024,8,128] bf16 (ring hop, through the host)",
             torch.ones(2, 1024, 8, 128, dtype=torch.bfloat16, device=dev),
             lambda t: collectives.ppermute_(t, ranks_axis))):
        fn(x)
        out[tag] = min(synced_ms(lambda: fn(x)) for _ in range(3))
    out["ppermute route"] = collectives.ppermute_route(ranks_axis, x)
    return out


def train_rank(rank, world, device, root):
    """One rank of the 2-rank training world on `device` (cuda:0; gloo): the
    dp = 2 and tp = 2 arms through the trainer CLI, then sp = 2 through
    `make_sharded_train_step` on run A's first two accumulation groups."""
    import torch.distributed as dist

    from audio_llama_tpu_torch.data.dataset import DatasetConfig
    from audio_llama_tpu_torch.data.loader import create_dataloaders
    from audio_llama_tpu_torch.data.tokenizer import load_tokenizer
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm
    from audio_llama_tpu_torch.parallel import sharded_train, sharding
    from audio_llama_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from audio_llama_tpu_torch.training import optim, train_step
    from audio_llama_tpu_torch.training.train import build_frozen, group_by_modality, \
        parse_args, to_device, train

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data_path, audio_dir = f"{root}/examples.json", f"{root}/audio"
    counter = CollectiveCounter()
    out = {"gloo": _gloo_sizes(dev, make_mesh(MeshConfig(dp=2)).axis("dp"))}
    cfg = full_config()

    # dp = 2, then tp = 2: the trainer CLI, run A's flags cut to 2 steps
    for arm, mesh_flags in (("dp=2", ["--mesh_dp", "2"]),
                            ("tp=2", ["--mesh_dp", "1", "--mesh_tp", "2"])):
        record = []
        make, wrapped = _timed_steps(record, counter)
        sharded_train.make_sharded_train_step = wrapped
        torch.cuda.reset_peak_memory_stats()
        run_dir = f"{root}/run_{arm[:2]}"
        try:
            with counter:
                res = train(parse_args([
                    "--data_path", data_path, "--audio_dir", audio_dir, "--output_dir", run_dir,
                    "--synthetic_flagship", "--tokenizer", "byte", "--val_split", "0.1",
                    "--log_steps", "1", "--no_tensorboard", "--num_workers", "4",
                    "--text_max_length", "512", *TRAIN_ARM_FLAGS, *mesh_flags, "--distributed",
                    "--num_processes", str(world), "--process_id", str(rank)]))
        finally:
            sharded_train.make_sharded_train_step = make
        out[arm] = {"steps": record, "final_checkpoint": res["final_checkpoint"],
                    "run_dir": run_dir, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        dist.barrier()
        torch.cuda.empty_cache()

    # sp = 2: run A's first two accumulation groups through the sharded step
    tok = load_tokenizer("byte")
    sid, eid = tok.token_to_id(cfg.audio_start_token), tok.token_to_id(cfg.audio_end_token)
    loader, _, _ = create_dataloaders(data_path, audio_dir, tok, batch_size=2, val_split=0.1,
                                      seed=42, num_workers=4,
                                      dataset_config=DatasetConfig(text_max_length=512,
                                                                   max_audio_seconds=30.0))
    groups = group_by_modality(loader, 2)
    batches = [to_device(next(groups), dev) for _ in range(2)]
    frozen = build_frozen(cfg, 42, dev)
    schedule = optim.cosine_schedule_with_warmup(2e-5, 1, 2)

    def make_opt(params):
        return optim.OptaxAdamW(params, schedule, weight_decay=0.01, max_grad_norm=2.0)

    whole = allm.init_trainable(cfg, make_generator(43, dev))
    ref = None
    if rank == 0:  # the single-process gradients of the first group, the peer waiting
        state = train_step.init_train_state(whole, make_opt)
        params = list(state.trainable.parameters())
        total, grads = 0.0, [torch.zeros_like(p) for p in params]
        for i in range(2):
            micro = train_step.micro_batch(batches[0], i)
            lossi, _ = allm.forward(frozen, state.trainable, cfg, micro, sid, eid)
            grads = [a + g.float() for a, g in zip(grads, train_step.gradients(lossi, params))]
            total += float(lossi.detach())
        ref = {"loss": total / 2, "grads": [(g / 2).cpu() for g in grads]}
        whole.requires_grad_(False)
        del state, grads, params
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=2))
    state = sharded_train.init_sharded_state(mesh, whole, make_opt)
    del whole
    grads_fn = sharded_train.make_sharded_grad_fn(cfg, mesh, None, sid, eid, accum_steps=2)
    loss, grads = grads_fn(state.trainable, frozen, batches[0])
    sp = {"first_loss": float(loss)}
    if rank == 0:
        rels = [rel_l2(g.cpu(), w) for g, w in zip(grads, ref["grads"])]
        sp.update(ref_loss=ref["loss"], grad_rel_l2_max=max(rels),
                  grad_rel_l2_by_leaf=dict(zip((n for n, _ in state.trainable.named_parameters()),
                                               rels)))
    del grads
    record = []
    make, wrapped = _timed_steps(record, counter)
    step = wrapped(cfg, None, mesh, None, sid, eid, accum_steps=2)
    torch.cuda.reset_peak_memory_stats()
    with counter:
        for b in batches:
            state, _ = step(state, frozen, b)
    sp.update(steps=record, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    out["sp=2"] = sp
    del frozen, state
    torch.cuda.empty_cache()
    return out


def sharded_train_path(dev, root) -> dict:
    """A world of 2 ranks on cuda:0 over gloo at full width (run A's corpus
    and flags, B 2, 2014 tokens a row): dp = 2 and tp = 2 through the
    trainer CLI (`--distributed`, 2 steps, a checkpoint), sp = 2 through
    `make_sharded_train_step` (2 steps). Each against the single process on
    the same seeded weights and global batches: the first step's loss within
    SHARDED_LOSS_REL, the gradients (sp: the gathered gradients of the first
    step; dp and tp: Adam's mu at step 2 in the checkpoint, the same
    gradients' moments) within SHARDED_GRAD_REL, the replicated trainables
    bit-equal on both ranks after every step, the dp/tp checkpoint reloaded
    by the single-process CLI's loaders bit for bit; the ring's launches
    exact per rank (rank r: r x 28 per micro-batch, none on rank 0)."""
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.models import allm
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.parallel import distributed
    from audio_llama_tpu_torch.training import checkpoint as ckpt

    import os
    import shutil

    t0 = time.perf_counter()
    # run A (the single process, train_path) wrote these with the same seeds
    with open(os.path.join(root, "run_A", "metrics.jsonl")) as f:
        single = [json.loads(line) for line in f if line.strip()]
    single_loss = {m["step"]: m["train/loss"] for m in single if "train/loss" in m}
    single_mu = _leaves(_read_checkpoint(os.path.join(root, "run_A", "checkpoint-2"))
                        ["optimizer"]["1"]["0"]["mu"])
    res = distributed.spawn(train_rank, 2, backend="gloo", device=str(dev),
                            args=(str(dev), root), timeout=900)
    L = full_config().llama.num_layers
    report = {"timing": MULTI_LABEL, "gloo_ms": res[0]["gloo"]}
    for arm in ("dp=2", "tp=2", "sp=2"):
        steps = [r[arm]["steps"] for r in res]
        for i, (a, b) in enumerate(zip(*steps)):
            if a["digest"] != b["digest"]:
                raise AssertionError(f"{arm}: the replicated trainables differ after step {i + 1}")
            if a["loss"] != b["loss"]:
                raise AssertionError(f"{arm}: the ranks' losses differ at step {i + 1}")
        first = steps[0][0]["loss"]
        want = res[0]["sp=2"]["ref_loss"] if arm == "sp=2" else single_loss[1]
        loss_rel = abs(first - want) / abs(want)
        if not loss_rel <= SHARDED_LOSS_REL:
            raise AssertionError(f"{arm}: first loss {first} against {want}")
        for r, rank_steps in enumerate(steps):
            for s in rank_steps:
                want_n = {n: (r * L * 2 if arm == "sp=2" else 0) for n in RING_NAMES}
                if s["ring_launches"] != want_n:
                    raise AssertionError(f"{arm} rank {r}: ring launches {s['ring_launches']}, "
                                         f"want {want_n}")
        entry = {"first_loss": first, "single_process_loss": want, "loss_rel": loss_rel,
                 "ranks": [{"ms_per_step": [s["ms"] for s in r[arm]["steps"]],
                            "tokens_per_s": [2 * 2 * 2014 / (s["ms"] / 1e3)
                                             for s in r[arm]["steps"]],
                            "peak_mem_gb": r[arm]["peak_mem_gb"],
                            "collectives_per_step": r[arm]["steps"][-1]["collectives"],
                            "ring_launches_per_step": r[arm]["steps"][-1]["ring_launches"]}
                           for r in res]}
        if arm == "sp=2":
            rel = res[0]["sp=2"]["grad_rel_l2_max"]
            entry["grad_rel_l2_max"] = rel
            if not rel <= SHARDED_GRAD_REL:
                raise AssertionError(f"sp=2: gradients rel-L2 {rel} against one process")
        else:
            final = res[0][arm]["final_checkpoint"]
            saved = _read_checkpoint(final)
            mu = _leaves(_read_checkpoint(os.path.join(res[0][arm]["run_dir"], "checkpoint-2"))
                         ["optimizer"]["1"]["0"]["mu"])
            rels = {n: rel_l2(torch.from_numpy(mu[n]), torch.from_numpy(single_mu[n]))
                    for n in single_mu}
            entry["mu_rel_l2_max"] = max(rels.values())
            if not entry["mu_rel_l2_max"] <= SHARDED_GRAD_REL:
                raise AssertionError(f"{arm}: Adam's mu rel-L2 {entry['mu_rel_l2_max']}")
            leaves = _leaves(saved["model"]["trainable"])
            cfg, frozen, by_cli, _ = cli.load_audio_llm(final, device=dev)
            del frozen
            template = allm.init_trainable(cfg, make_generator(0, dev))
            by_ckpt, _, step, _ = ckpt.load_checkpoint(final, trainable_template=template)
            for tree in (by_cli, by_ckpt):
                for n, p in tree.named_parameters():
                    if not np.array_equal(p.detach().cpu().numpy(), leaves[n]):
                        raise AssertionError(f"{arm}: {n} does not reload bit for bit")
            if tuple(leaves["lora.layers.q_proj.b"].shape) != tuple(
                    template["lora"]["layers"]["q_proj"]["b"].shape):
                raise AssertionError(f"{arm}: the checkpoint holds a tp block, not the leaf")
            entry["checkpoint_reload"] = "bit-equal (trainer loader, inference CLI)"
            del by_cli, by_ckpt, template
            torch.cuda.empty_cache()
            shutil.rmtree(res[0][arm]["run_dir"])
        report[arm] = entry
    report["seconds"] = time.perf_counter() - t0
    log(json.dumps({"sharded_train_path": report}))
    return {"sp_train": res[1]["sp=2"]["steps"][-1]["ring_launches"]}


# ---------------------------------------------------------------------------
# phase 17: the W8A8 int8 encoder and its --enc_algo attention kernels
# ---------------------------------------------------------------------------

ENC_ROWS = {  # kernel row -> (TPU kernel it replaces, source)
    "enc_attention_v3q": ("audio_llama_tpu/ops/enc_attention.py:170",
                          "audio_llama_tpu_torch/csrc/enc_attention_v3q.cu"),
    "enc_attention_bounded": ("audio_llama_tpu/ops/enc_attention.py:54",
                              "audio_llama_tpu_torch/csrc/enc_attention.cu"),
    "enc_attention_twopass": ("audio_llama_tpu/ops/enc_attention.py:232",
                              "audio_llama_tpu_torch/csrc/enc_attention.cu"),
}
# the wgmma / TMA encoder kernel's modes (ea.SM90_KINDS) -> their ptxas entry at hd 64
ENC_SM90 = {"enc_attention": "enc_kernelILi64ELi0ELb0E",
            "enc_attention_bounded": "enc_kernelILi64ELi1ELb0E",
            "enc_attention_twopass": "enc_kernelILi64ELi2ELb0E",
            "enc_attention_twopass_bf16": "enc_kernelILi64ELi2ELb1E"}
ENC_ALGOS = ("v3", "v3q", "twopass", "bounded")
ENC_KERNEL = {"v3": "enc_attention", "v3q": "enc_attention_v3q",
              "twopass": "enc_attention_twopass", "bounded": "enc_attention_bounded"}
ENC_B = 8  # bench.py's default --batch


def enc_case(dev, gen, B, T=1536, valid=1500, H=20, hd=64, mag=1.0):
    """Encoder attention inputs at the main path's geometry: q/k/v [B, T, H,
    hd] bf16 views of [B, T, H*hd] projections (v3's layout), copies stored
    head-major ([B, H, T, hd], the layout of JAX's bounded and twopass
    wrappers) seen through the same [B, T, H, hd] index, the pre-scaled q,
    the key norms and v3q's quantized tensors."""
    from audio_llama_tpu_torch.ops import enc_attention as ea

    q, k, v = ((torch.randn((B, T, H * hd), generator=gen, device=dev) * mag)
               .to(torch.bfloat16).view(B, T, H, hd) for _ in range(3))
    scale = hd ** -0.5
    qs = q * torch.tensor(scale, dtype=torch.bfloat16, device=dev)
    return dict(q=q, k=k, v=v, qs=qs, valid=valid, scale=scale, kn=ea.key_norm_max(k),
                heads=[t.transpose(1, 2).contiguous().transpose(1, 2) for t in (qs, k, v)],
                v3q=ea.v3q_quantize(q, k, v, scale))


def enc_call(name, case, cuda=True, valid=None, layout="v3", exp_dtype=torch.float32,
             kn=None, sv=None):
    """One call of an encoder kernel (v3: enc_attention; or a variant's) or
    its plain version on the case -> [B, T, H, hd]; `valid`, `kn`, `sv`: what
    to pass in place of the case's (a fault plants others)."""
    from audio_llama_tpu_torch.ops import enc_attention as ea

    valid = case["valid"] if valid is None else valid
    if name == "enc_attention_v3q":
        qi, ki, vti, c, sv0 = case["v3q"]
        fn = ea.enc_attention_v3q_cuda if cuda else ea.enc_attention_v3q_plain
        return fn(qi, ki, vti, c, sv0 if sv is None else sv, valid, torch.bfloat16)
    qs, k, v = case["heads"] if layout == "head-major" else (case["qs"], case["k"], case["v"])
    if name == "enc_attention":
        return (ea.enc_attention_cuda if cuda else ea.enc_attention_plain)(qs, k, v, valid)
    if name == "enc_attention_bounded":
        fn = ea.enc_attention_bounded_cuda if cuda else ea.enc_attention_bounded_plain
        return fn(qs, k, v, case["kn"] if kn is None else kn, valid)
    fn = ea.enc_attention_twopass_cuda if cuda else ea.enc_attention_twopass_plain
    return fn(qs, k, v, valid, exp_dtype)


def enc_work(name, B, T, H, hd, valid):
    """(FLOP, bytes) an encoder attention call must do: QK^T and PV over the
    valid keys; q, k, v read once and o written once (v3q: its int8 tensors
    and f32 scales)."""
    flops = 4.0 * B * T * valid * hd * H
    if name == "enc_attention_v3q":
        return flops, (3.0 * B * T * H * hd + 4.0 * B * T * H + 4.0 * B * H * hd
                       + 2.0 * B * T * H * hd)
    return flops, 2.0 * 4 * B * T * H * hd


def enc_sdpa(qs, k, v, valid):
    """The encoder rows' library calls on [B, T, H, hd] inputs -> (SDPA with
    no mask on K/V cut to the valid keys; the earlier yardstick, SDPA on all
    keys with a boolean key mask, which keeps it off its flash backend), each
    a function of no arguments."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2) for t in (qs, k, v))
    kv_valid = [t[:, :, :valid].contiguous() for t in (kh, vh)]
    key_ok = (torch.arange(kh.shape[2], device=kh.device) < valid)[None, :]
    return (lambda: F.scaled_dot_product_attention(qh, *kv_valid, scale=1.0),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok, scale=1.0))


def enc_reference(case, name, fault):
    """The function an encoder kernel with a planted fault computes on the
    case, in f32 by the plain version's rules (`name`: enc_attention, _bounded
    or _twopass), with the kernel's key tiles (`ea.key_tile`):
      'stale K' / 'stale V': key tile j >= 1 meets tile j-1's K (its V), as a
          ring stage read before its refill;
      'mask off': the last valid tile's keys past valid_len are not masked;
      'max one tile short': twopass's pass 1 leaves the last valid tile out
          of the row max.
    -> [B, T, H, hd] bf16."""
    from audio_llama_tpu_torch.ops import enc_attention as ea

    qs, k, v, valid = case["qs"], case["k"], case["v"], case["valid"]
    T, hd = k.shape[1], k.shape[3]
    bk = ea.key_tile(hd)
    n = -(-valid // bk)
    key = torch.arange(T, device=k.device)
    late = (key >= bk)[None, :, None, None]
    if fault == "stale K":
        k = torch.where(late, torch.roll(k, bk, dims=1), k)
    elif fault == "stale V":
        v = torch.where(late, torch.roll(v, bk, dims=1), v)
    seen = key < (min(n * bk, T) if fault == "mask off" else valid)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float()).masked_fill(~seen, ea.NEG)
    if name == "enc_attention_bounded":
        c = qs.float().square().sum(dim=-1).sqrt().permute(0, 2, 1)[..., None] * \
            case["kn"][:, :, None, None]
        p = torch.exp(s - c).masked_fill(~seen, 0.0)
    else:
        in_max = key < (n - 1) * bk if fault == "max one tile short" else seen
        m = s.masked_fill(~in_max, ea.NEG).amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    p = p.to(v.dtype).float()
    return ea._guarded(torch.einsum("bhqk,bkhd->bhqd", p, v.float()),
                       p.sum(dim=-1, keepdim=True), qs.dtype)


def enc_faults(name, case):
    """name -> {fault: kwargs of enc_call} for the planted faults."""
    valid, kw = case["valid"], {}
    faults = {f"valid_len {valid + d}": dict(valid=valid + d) for d in (1, -1)}
    if name == "enc_attention_v3q":  # the V scales of the neighbouring head
        faults["sv of the next head"] = dict(sv=torch.roll(case["v3q"][4], 1, dims=1))
    elif name == "enc_attention_bounded":  # ||q|| taken before q is scaled
        faults["qn of the unscaled q"] = dict(kn=case["kn"] / case["scale"])
    else:  # the last key tile (64 keys) skipped
        faults["last key tile skipped"] = dict(valid=(valid - 1) // 64 * 64)
    return faults


def enc_outlier_case(dev, gen, T=1536, H=20, hd=64):
    """tests/test_enc_attention.py::test_outlier_magnitudes_safe_softmax at the
    main path's geometry: q, k ~ 2 N(0, 1), key 0 of every head a unit
    direction times 1200."""
    from audio_llama_tpu_torch.ops import enc_attention as ea

    case = enc_case(dev, gen, 1, T=T, valid=T, H=H, hd=hd, mag=2.0)
    d = torch.randn((H, hd), generator=gen, device=dev)
    case["k"][:, 0] = (d / d.norm(dim=-1, keepdim=True) * 1200.0).to(torch.bfloat16)
    case["kn"] = ea.key_norm_max(case["k"])
    return case


def enc_kernel_checks(dev, gen):
    """Phase 17 (a): v3q, bounded (both layouts) and twopass (f32 and bf16
    exp) at T 1536, 1500 valid keys, H 20, hd 64, B 1 and 8, against their
    plain versions and planted faults; timed at both batches beside the
    plain version and SDPA (v3q's on its dequantized bf16 tensors)."""
    import torch.nn.functional as F

    rows = []
    H, hd, T, valid = 20, 64, 1536, 1500
    arms = {"enc_attention_v3q": [dict()],
            "enc_attention_bounded": [dict(), dict(layout="head-major")],
            "enc_attention_twopass": [dict(), dict(layout="head-major"),
                                      dict(exp_dtype=torch.bfloat16)]}
    for name, (replaces, source) in ENC_ROWS.items():
        frac = ATOL_ROW_RMS_FRAC[name]
        mag = 2.0 if name == "enc_attention_bounded" else 1.0  # the qn fault underflows
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   tol=tol_entry(frac), launches=None, checks={})
        worst = (0.0, 0.0)
        for B in (1, ENC_B):
            case = enc_case(dev, gen, B, mag=mag)
            key_ok = (torch.arange(case["k"].shape[1], device=dev) < case["valid"])[None, :]
            for arm in arms[name]:
                label = f"B={B} " + ",".join(f"{k}={v}" for k, v in arm.items())
                want = enc_call(name, case, cuda=False, **arm)[:, :valid]
                err, ratio = check_close(f"{name} {label}", enc_call(name, case, **arm)[:, :valid],
                                         want, frac)
                faults = {f: must_reject(name, f, enc_call(name, case, **arm, **fk)[:, :valid],
                                         want, frac)
                          for f, fk in enc_faults(name, case).items()}
                row["checks"][label] = dict(max_abs_err=err, tol_ratio=ratio,
                                            planted_fault_ratios=faults)
                worst = max(worst, (ratio, err))
                log(f"kernel {name} {label} ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
                    f"planted faults rejected: {faults}")
            suffix = "" if B == 1 else f"_b{B}"
            if name == "enc_attention_v3q":
                bms, bby = bound(*enc_work(name, B, T, H, hd, valid), H100_INT8_OPS)
                qi, ki, vti, c, sv = case["v3q"]
                lib = [t.to(torch.bfloat16).contiguous() for t in (  # dequantized [B, H, T, hd]
                    qi.transpose(1, 2) * (c / case["scale"]).transpose(1, 2)[..., None],
                    ki.transpose(1, 2).float(), vti.transpose(2, 3) * sv[:, :, None, :])]
                library = {"library_ms" + suffix: time_ms(lambda: F.scaled_dot_product_attention(
                    *lib, attn_mask=key_ok, scale=case["scale"]))}
            else:
                bms, bby = bound(*enc_work(name, B, T, H, hd, valid))
                lib, lib_masked = enc_sdpa(case["qs"], case["k"], case["v"], valid)
                library = {"library_ms" + suffix: time_ms(lib),
                           "library_backend" + suffix: sdpa_backend(lib),
                           "library_ms_masked" + suffix: time_ms(lib_masked)}
                row["notes"] = ("library_ms: SDPA with no mask on K/V cut to the valid keys; "
                                "library_ms_masked: SDPA on all keys with a boolean key mask")
            row.update({
                "ms" + suffix: time_ms(lambda: enc_call(name, case)),
                "plain_ms" + suffix: events_ms(lambda: enc_call(name, case, cuda=False), iters=5),
                **library, "bound_ms" + suffix: bms, "bound_by" + suffix: bby,
            })
            del case, lib
            torch.cuda.empty_cache()
        if name in ENC_SM90:
            row["sm90"] = enc_sm90_report(name)
            if name == "enc_attention_twopass":
                row["sm90_exp_bf16"] = enc_sm90_report("enc_attention_twopass_bf16")
        row["tol_ratio"], row["max_abs_err"] = worst
        row["shapes"] = f"q/k/v[B,{T},{H},{hd}], {valid} valid, B 1 (ms) and {ENC_B} (ms_b{ENC_B})"
        rows.append(row)
    # the bounded shift's kept failure: the kernel zeroes the rows its plain
    # version zeroes on outlier keys
    case = enc_outlier_case(dev, gen)
    got = enc_call("enc_attention_bounded", case)
    want = enc_call("enc_attention_bounded", case, cuda=False)
    zero_got, zero_want = (got == 0).all(dim=-1), (want == 0).all(dim=-1)
    if not torch.equal(zero_got, zero_want) or not zero_got.any():
        raise AssertionError("enc_attention_bounded: the kernel and its plain version zero "
                             f"different rows on the outlier input, or none "
                             f"({int(zero_got.sum())} vs {int(zero_want.sum())})")
    rows[1]["outlier_rows_zeroed"] = f"{int(zero_got.sum())} of {zero_got.numel()}"
    log(f"kernel enc_attention_bounded on outlier keys: {rows[1]['outlier_rows_zeroed']} "
        "(batch, row, head) rows zeroed, the same as its plain version")
    return rows


def enc8_path(dev) -> dict:
    """Phase 17 (b): bench.py's encode program, ported: ENC_B seeded 30 s
    waveforms -> log-mel (the mel kernel) -> `quantize_encoder_smoothed`
    calibrated on the card on the same batch -> `encode_int8` for each
    attn_algo at the full Whisper-large-v3-turbo width -> the projector; the
    bf16 `whisper.encode` in the same call. Launches exact per encode: the
    chosen kernel once a layer, none of the other three, no LayerNorm
    kernel. -> {path label: launch counters} for the kernel rows."""
    from audio_llama_tpu_torch.models import allm, projector, whisper, whisper_int8 as w8
    from audio_llama_tpu_torch.ops import mel_power

    cfg = full_config()
    L, bf = cfg.whisper.num_layers, torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    wparams = whisper.init_params(cfg.whisper, gen, bf)
    proj = allm.init_trainable(cfg, gen, torch.float32)["projector"]
    wav = torch.randn((ENC_B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    mel = mel_power.log_mel(wav, cfg.mel)
    t0 = time.perf_counter()
    qp = w8.quantize_encoder_smoothed(wparams, cfg.whisper, mel, compute_dtype=bf)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    A, D = cfg.mel.num_frames // 2, cfg.whisper.d_model
    audio_s = ENC_B * cfg.mel.max_samples / cfg.mel.sample_rate
    stats, outs, paths = {}, {}, {}

    def measure(label, run):
        run()  # warm-up
        zero_counters()
        out = run()
        torch.cuda.synchronize()
        launches = read_counters()
        if tuple(out.shape) != (ENC_B, A, D) or not torch.isfinite(out).all():
            raise AssertionError(f"enc8 {label}: encoder output {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        emb = projector.project(proj, out, bf)
        if not torch.isfinite(emb).all():
            raise AssertionError(f"enc8 {label}: non-finite projector output")
        ms = float(np.median([synced_ms(run) for _ in range(5)]))
        outs[label] = out.float()
        stats[label] = {"encode_ms": ms, "audio_s_per_s": audio_s / (ms / 1e3),
                        "projected": list(emb.shape)}
        return launches

    for algo in ENC_ALGOS:
        launches = measure(algo, lambda: w8.encode_int8(qp, cfg.whisper, mel, bf,
                                                         attn_algo=algo))
        want = {k: L * (k == ENC_KERNEL[algo]) for k in ENC_KERNEL.values()}
        want["layer_norm"] = 0
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"enc8 {algo}: launches {got}, want {want}")
        stats[algo]["launches"] = got
        paths[f"enc8_{algo}"] = launches
    measure("bf16 whisper.encode", lambda: whisper.encode(wparams, cfg.whisper, mel, bf))
    for algo in ("twopass", "bounded"):
        stats[algo]["rel_l2_to_v3"] = rel_l2(outs[algo], outs["v3"])
        if stats[algo]["rel_l2_to_v3"] > ENC8_REL:
            raise AssertionError(f"enc8 {algo}: rel-L2 to v3 {stats[algo]['rel_l2_to_v3']}")
    stats["v3q"]["rel_l2_to_v3"] = rel_l2(outs["v3q"], outs["v3"])
    if stats["v3q"]["rel_l2_to_v3"] > ENC8_V3Q_REL:
        raise AssertionError(f"enc8 v3q: rel-L2 to v3 {stats['v3q']['rel_l2_to_v3']}")
    stats["bf16 whisper.encode"]["rel_l2_to_v3"] = rel_l2(outs["bf16 whisper.encode"],
                                                          outs["v3"])
    log(json.dumps({"enc8_path": {
        "config": f"Whisper-large-v3-turbo encoder ({L} layers, d_model {D}, "
                  f"{cfg.whisper.num_heads} heads, F {cfg.whisper.ffn_dim}), {A} frames padded "
                  f"to the 128 tile, B = {ENC_B} seeded 30 s waveforms, bf16, W8A8 smoothed "
                  "(calibrated on the batch), seeded random weights",
        "calibrate_and_quantize_s": calib_s, "by_algo": stats}}))
    return paths


ENC8_REL = 2e-2  # v3, twopass and bounded: one function, P rounded at other maxima
ENC8_V3Q_REL = 5e-2  # v3q: int8 q/k/v and an int8 P on top


def enc8_dispatch(ctx) -> dict:
    """Phase 17 (c): the bf16 path's model with its encoder quantized
    (smoothed, calibrated on the clip) through `generate` at B = 1, 32 greedy
    tokens: `allm.process_audio_features` dispatches on `w_q`; the v3 kernel
    once a layer and no LayerNorm kernel; the first decode step's logits
    beside the bf16 encoder's."""
    from audio_llama_tpu_torch.bridge import ParamTree
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import whisper_int8 as w8

    cfg, frozen, trainable = ctx["model"]
    ids, mask, audio = ctx["ids"], ctx["mask"], ctx["audio"]
    bf = torch.bfloat16
    q = ParamTree(dict(frozen.items()))
    q["whisper"] = w8.quantize_encoder_smoothed(frozen["whisper"], cfg.whisper, audio,
                                                compute_dtype=bf)
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=bf, device=ids.device)
    zero_counters()
    toks = generate(q, trainable, cfg, ids, mask, audio, None, max_new_tokens=N_NEW,
                    greedy=True, **kw).tokens
    torch.cuda.synchronize()
    launches = read_counters()
    check_tokens("enc8 dispatch", toks, (1, N_NEW), cfg.llama.vocab_size + 2)
    L = cfg.whisper.num_layers
    got = {k: launches[k] for k in ("enc_attention", "layer_norm", "enc_attention_v3q",
                                    "enc_attention_bounded", "enc_attention_twopass")}
    if got != {"enc_attention": L, "layer_norm": 0, "enc_attention_v3q": 0,
               "enc_attention_bounded": 0, "enc_attention_twopass": 0}:
        raise AssertionError(f"enc8 dispatch: launches {got}")
    card = first_step_logits(q, trainable, cfg, ids, mask, audio, kv_quant=False)
    bf16_enc = first_step_logits(frozen, trainable, cfg, ids, mask, audio, kv_quant=False)
    stats = {"path": "bf16 path's model, W8A8 encoder (smoothed on the clip), B=1",
             "greedy_tokens": toks[0].tolist(), "launches": got,
             "first_step_logits_rel_l2_to_bf16_encoder": rel_l2(card, bf16_enc),
             "argmax_agree": bool((card.argmax(-1) == bf16_enc.argmax(-1)).all())}
    log(json.dumps({"enc8_dispatch": stats}))
    return stats


def host_check_enc8(dev) -> None:
    """Phase 17 (d): 2 Whisper layers at full width, quantized once on the
    host (f32, smoothed on the clip); `encode_int8` on the card (kernels,
    bf16) against the host's plain path (f32) on that tree, each algo within
    rel-L2 HOST_TOL."""
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import whisper, whisper_int8 as w8

    cfg = cut_config().whisper
    t0 = time.perf_counter()
    gen = make_generator(8, "cpu")
    wparams = whisper.init_params(cfg, gen, torch.float32)
    mel = torch.randn((1, cfg.num_mel_bins, 2 * cfg.max_source_positions), generator=gen)
    qp = w8.quantize_encoder_smoothed(wparams, cfg, mel, compute_dtype=torch.float32)
    qp_card = copy.deepcopy(qp).to(dev)
    res = {}
    for algo in ENC_ALGOS:
        card = w8.encode_int8(qp_card, cfg, mel.to(dev), torch.bfloat16,
                              attn_algo=algo).float().cpu()
        host = w8.encode_int8(qp, cfg, mel, torch.float32, attn_algo=algo)
        res[algo] = rel_l2(card, host)
        if not (torch.isfinite(card).all() and res[algo] <= HOST_TOL):
            raise AssertionError(f"host check enc8 {algo}: rel-L2 {res[algo]} (bar {HOST_TOL})")
    log(json.dumps({"host_check_enc8": {
        "layers": "2 whisper, full width, W8A8 smoothed on the host", "rel_l2_by_algo": res,
        "tol_rel_l2": HOST_TOL, "seconds": time.perf_counter() - t0}}))


# ---------------------------------------------------------------------------
# phase 18: causal_mha's forward variants and the K-split W4A16 (INT4_BK)
# ---------------------------------------------------------------------------

VARIANT_ROWS = {  # kernel row -> (fwd_impl, softmax_mode, TPU kernel it replaces, source)
    "causal_attention_cond": ("blocks_cond", "online",
                              "audio_llama_tpu/ops/causal_attention.py:101 (tri='cond')",
                              "audio_llama_tpu_torch/csrc/causal_attention.cu"),
    "causal_attention_bounded": ("blocks", "bounded",
                                 "audio_llama_tpu/ops/causal_attention.py:101 "
                                 "(softmax='bounded')",
                                 "audio_llama_tpu_torch/csrc/causal_attention_fixed.cu"),
    "causal_attention_twopass": ("blocks", "twopass", "audio_llama_tpu/ops/causal_attention.py:188",
                                 "audio_llama_tpu_torch/csrc/causal_attention_fixed.cu"),
    "causal_attention_dma": ("dma", "bounded", "audio_llama_tpu/ops/causal_attention.py:250",
                             "audio_llama_tpu_torch/csrc/causal_attention_fixed.cu"),
    "causal_attention_dma2": ("dma2", "bounded", "audio_llama_tpu/ops/causal_attention.py:321",
                              "audio_llama_tpu_torch/csrc/causal_attention_dma2.cu"),
}
# each row's wgmma / TMA kernel -> (its name in ca.SM90_KERNELS, its ptxas entry at hd 128)
SM90_KERNELS = {
    "causal_attention_dq": ("causal_attention_dq", "dq_kernelILi128ELb1E"),
    "causal_attention_dq_never": ("causal_attention_dq_never", "dq_kernelILi128ELb0E"),
    "causal_attention_dkv": ("causal_attention_dkv", "dkv_kernelILi128ELb1E"),
    "causal_attention_dkv_never": ("causal_attention_dkv_never", "dkv_kernelILi128ELb0E"),
    "causal_attention": ("causal_attention", "online_kernelILi128ELb1E"),
    "causal_attention_never": ("causal_attention_never", "online_kernelILi128ELb0E"),
    "causal_attention_cond": ("causal_attention", "online_kernelILi128ELb1E"),
    "causal_attention_bounded": ("causal_attention_bounded", "fixed_kernelILi128ELb1E"),
    "causal_attention_twopass": ("causal_attention_twopass", "fixed_kernelILi128ELb0E"),
    "causal_attention_dma": ("causal_attention_bounded", "fixed_kernelILi128ELb1E"),
    "causal_attention_dma2": ("causal_attention_dma2", "dma2_kernelILi128E"),
}
# the bounded row also runs under blocks_cond (its own counter, summed in the row)
VARIANT_ARMS = [(v[0], v[1]) for v in VARIANT_ROWS.values()] + [("blocks_cond", "bounded")]
VARIANT_T, VARIANT_REAL = 2560, 2014  # experiments/causal_dma_bench.py's T; train A's tokens
ATOL_ROW_RMS_FRAC.update({n: ATOL_ROW_RMS_FRAC["causal_attention"] for n in VARIANT_ROWS})
ATOL_ROW_RMS_FRAC["int4_matmul_stacked_ksplit"] = ATOL_ROW_RMS_FRAC["int4_matmul_stacked"]
STAT_BARS = (("l", 0.0, 2.0 ** -8), ("m", 1e-4, 1e-5))  # row 3's bars on l and the shift


def variant_case(dev, gen, B):
    """The JAX package's A/B geometry (Llama-3.2-3B attention, T 2560, bf16):
    qs pre-scaled [B, T, 24, 128], k/v [B, T, 8, 128], the last batch row's
    keys padded from VARIANT_REAL, the key bias, kn."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    T, real = VARIANT_T, VARIANT_REAL
    lc = full_config().llama
    Hq, Hkv, hd, bf = lc.num_heads, lc.num_kv_heads, lc.head_dim, torch.bfloat16
    qs = (torch.randn((B, T, Hq, hd), generator=gen, device=dev).to(bf)
          * torch.tensor(hd ** -0.5, dtype=bf, device=dev))
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen, device=dev).to(bf) for _ in range(2))
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[-1, real:] = 0
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    return dict(qs=qs, k=k, v=v, mask=mask, key_bias=key_bias, kn=ca.key_norm_max(k))


def variant_call(name, case, cuda=True, **over):
    """One call of a variant's kernel (or its plain version) -> CausalOut;
    `over` replaces inputs of the case (a fault plants others)."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    c = {**case, **over}
    fwd_impl, softmax = VARIANT_ROWS[name][:2] if name in VARIANT_ROWS else name
    plain, kernel = ca.variant_forward(fwd_impl, softmax)
    return (kernel if cuda else plain)(c["qs"], c["k"], c["v"], c["key_bias"], c["kn"])


def variant_sdpa(case):
    """Phase 18's library call on a case: SDPA (causal, GQA, no padding mask)
    on its q, k, v laid out [B, H, T, hd] -> a function of no arguments."""
    import torch.nn.functional as F

    qh, kh, vh = (case[n].transpose(1, 2).contiguous() for n in ("qs", "k", "v"))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0,
                                                  enable_gqa=True)


def variant_reference(case, visible, softmax, kn=None, max_keys=None, v_next=False):
    """A variant's arithmetic in f32 for a key visibility [T, T]: the faulty
    functions the planted faults stand for. 'online' / 'twopass' shift by the
    row max (over `max_keys` only, if given), 'bounded' by ||q|| kn; v_next:
    the keys below a row's diagonal tile meet the V rows one tile (64 keys)
    later, as a PV that reads tile j+1's stage."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    qs, k, v, key_bias = case["qs"], case["k"], case["v"], case["key_bias"]
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    qg = qs.float().reshape(B, T, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) + key_bias[:, None, None, None, :]
    s = s.masked_fill(~visible, ca.NEG)
    if softmax == "bounded":
        c = ca.row_bound(qs, case["kn"] if kn is None else kn)
        p = torch.exp(s - c)
        l = p.sum(-1, keepdim=True)
        p = p.to(v.dtype).float()
    else:
        c = (s if max_keys is None else s.masked_fill(~max_keys, ca.NEG)).amax(-1, keepdim=True)
        p = torch.exp(s - c).to(v.dtype).float()
        l = p.sum(-1, keepdim=True)
    del s
    if v_next:
        t = torch.arange(T, device=qs.device)
        below = (t[None, :] // 64) < (t[:, None] // 64)
        o = (torch.einsum("bhgqk,bkhd->bqhgd", p * below, torch.roll(v, -64, dims=1).float())
             + torch.einsum("bhgqk,bkhd->bqhgd", p * ~below, v.float()))
    else:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return ca._out(o, l, c.expand_as(l), qs.dtype)


def lc_ratios(got, want, mask) -> dict:
    """l and the shift m (c) of the valid rows against the plain version's:
    max |got - want| / (atol + rtol |want|) with row 3's bars; pass <= 1."""
    B, T = mask.shape
    valid = mask != 0
    out = {}
    for stat, atol, rtol in STAT_BARS:
        g = getattr(got, stat).reshape(B, -1, T).transpose(1, 2)[valid]
        w = getattr(want, stat).reshape(B, -1, T).transpose(1, 2)[valid]
        err, bar = (g - w).abs(), atol + rtol * w.abs()
        ratio = torch.where(err == 0, 0.0, err / bar).max().item()
        out["c" if stat == "m" else "l"] = ratio
    return out


def variant_outlier_case(dev, gen):
    """tests/test_causal_attention.py::_outlier_setup at this geometry (B 1):
    q, k ~ 2 N(0, 1), key 0 of every KV head a unit direction times 1500,
    v ~ N(0, 1), no padding."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc, T = full_config().llama, VARIANT_T
    Hq, Hkv, hd, bf = lc.num_heads, lc.num_kv_heads, lc.head_dim, torch.bfloat16
    q = torch.randn((1, T, Hq, hd), generator=gen, device=dev) * 2.0
    k = torch.randn((1, T, Hkv, hd), generator=gen, device=dev) * 2.0
    d = torch.randn((hd,), generator=gen, device=dev)
    k[:, 0] = d / d.norm() * 1500.0
    v = torch.randn((1, T, Hkv, hd), generator=gen, device=dev)
    k = k.to(bf)
    return dict(qs=(q * hd ** -0.5).to(bf), k=k, v=v.to(bf),
                mask=torch.ones(1, T, dtype=torch.int32, device=dev),
                key_bias=torch.zeros(1, T, device=dev), kn=ca.key_norm_max(k))


def ptxas_report(entry: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    `entry`, from the `-Xptxas=-v` lines of this build's log."""
    from audio_llama_tpu_torch.ops import _cuda

    lines = (_cuda.BUILD_DIR / f"{_cuda._digest()}.log").read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Function properties for" in line and entry in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
            out["spill_store_bytes"], out["spill_load_bytes"] = int(m[1]), int(m[2])
            out["registers"] = int(re.search(r"Used (\d+) registers", lines[i + 2])[1])
        elif "serialized" in line and entry in line:
            out["wgmma_serialized"] = line.split("ptxas info    : ")[-1]
    if "registers" not in out:
        raise AssertionError(f"ptxas: no report for {entry} in the build log")
    return out


def sm90_checked(label: str, entry: str, runtime: dict) -> dict:
    """ptxas's registers and spills of the kernel whose mangled name holds
    `entry` (the build log) beside the runtime's registers, local bytes,
    shared memory and resident blocks per SM. A spill, local memory or a
    wgmma that ptxas serialized fails the run."""
    px = ptxas_report(entry)
    if (px["spill_store_bytes"] or px["spill_load_bytes"] or "wgmma_serialized" in px
            or runtime["local_bytes"]):
        raise AssertionError(f"{label}: spills, local memory or serialized wgmma: "
                             f"{dict(ptxas=px, runtime=runtime)}")
    return dict(ptxas=px, runtime=runtime)


def sm90_report(row: str, hd: int) -> dict:
    """Row's wgmma / TMA kernel at head_dim hd, by `sm90_checked`."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    kernel, entry = SM90_KERNELS[row]
    return dict(kernel=kernel, **sm90_checked(row, entry, ca.sm90_kernel_info(kernel, hd)))


def enc_sm90_report(kind: str) -> dict:
    """The encoder kernel's mode `kind` (a key of ENC_SM90) at hd 64, by
    `sm90_checked`."""
    from audio_llama_tpu_torch.ops import enc_attention as ea

    return dict(kernel=kind, **sm90_checked(kind, ENC_SM90[kind], ea.sm90_kernel_info(kind, 64)))


DECODE_REPORT_M = (4, 16, 32, 64)  # one M of each decode instance (NT)


def w4_sm90_report() -> dict:
    """Every instance of the W4A16 prefill kernel (int4_matmul.cu: groups
    16-256, whole K and K-split) and of its decode kernel (one M an instance,
    at q|k|v's plan), by `sm90_checked`."""
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    out = {}
    for M in DECODE_REPORT_M:
        plan = i4.decode_plan(M, 3072, 2560)
        label = f"int4_matmul_decode M {M}"
        out[label] = sm90_checked(label, f"w4_decode_kernelILi{plan.nt}EE",
                                  i4.decode_kernel_info(M, 3072 // plan.C, 128))
    for kind, code in i4.SM90_KINDS.items():
        for group in (16, 32, 64, 128, 256):
            entry = (f"w4_wgmma_kernelINS_7PrefillILb{code - 5}ELi{max(1, 128 // group)}"
                     f"ELb{int(group > 128)}E")
            out[f"{kind} group {group}"] = sm90_checked(
                f"{kind} group {group}", entry, i4.sm90_kernel_info(kind, group))
    return out


def mlp4_sm90_report() -> dict:
    """Every instance of the fused MLP kernel (one M an instance, at the 3B
    widths' plan), by `sm90_checked`."""
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    out = {}
    for M in DECODE_REPORT_M:
        plan = mlp4.mlp_plan(M, 3072, 8192, 1536)
        label = f"mlp_int4_stacked M {M}"
        out[label] = sm90_checked(label, f"mlp4_kernelILi{plan.nt}EE",
                                  mlp4.kernel_info(M, 3072, 8192, plan))
    return out


def causal_variant_checks(dev, gen):
    """Phase 18 (a): the forward variants' kernels (cond online, bounded
    under blocks and blocks_cond, twopass, dma, dma2) at T 2560 (2014 real
    in the last row), Hq 24, Hkv 8, hd 128, B 2 and 8 against their plain
    versions: o on the valid rows within row 3's bar, l and c within row 3's
    l / m bars; cond == always and bounded-cond, dma == bounded bit for bit,
    dma2 (its own kernel) against bounded within row 3's bars;
    two launches bit-equal; planted faults (cond: the diagonal tile
    left unmasked; twopass: its last valid tile left out of pass 1; bounded:
    kn over the valid keys only, and kn of KV head h % Hkv for h // G; dma:
    the diagonal tile not fetched; dma2: tile j's PV read from tile j+1's V
    stage); the outlier input; timed by CUPTI at B 2 and 8 beside the plain
    version and SDPA (causal, GQA, no padding mask). Each row's wgmma / TMA
    kernel (online for cond; bounded for bounded and dma; twopass; dma2)
    also reports its registers and spills (the build log; either fails the
    run), resident blocks per SM (the occupancy calculator) and a CUDA-events
    time beside CUPTI's. `main` runs this phase first, on a generator of its own:
    a process's CUPTI loses kernel records once it has traced some 10^5 of
    them, and the later phases trace that many."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    rows, T = [], VARIANT_T
    lc = full_config().llama
    Hq, Hkv, hd = lc.num_heads, lc.num_kv_heads, lc.head_dim
    t = torch.arange(T, device=dev)
    causal = t[None, :] <= t[:, None]
    diag = (t[None, :] // 64) == (t[:, None] // 64)
    results = {n: dict(checks={}) for n in VARIANT_ROWS}
    events_by_b = {}
    for B in (2, 8):
        case = variant_case(dev, gen, B)
        valid = case["mask"] != 0
        always = ca.causal_attention_cuda(case["qs"], case["k"], case["v"], case["key_bias"])
        got = {}
        for name in list(VARIANT_ROWS) + [("blocks_cond", "bounded")]:
            out = variant_call(name, case)
            label = name if isinstance(name, str) else "causal_attention_bounded (blocks_cond)"
            row = label.split(" ")[0]
            if not all(torch.equal(a, b) for a, b in zip(out, variant_call(name, case))):
                raise AssertionError(f"{label}: two launches differ")
            want = variant_call(name, case, cuda=False)
            err, ratio = check_close(f"{label} B={B}", out.o[valid], want.o[valid],
                                     ATOL_ROW_RMS_FRAC[row])
            stats = lc_ratios(out, want, case["mask"])
            if max(stats.values()) > 1:
                raise AssertionError(f"{label} B={B}: l or c outside row 3's bars {stats}")
            results[row]["checks"][f"B={B}" + (" blocks_cond" if label != row else "")] = dict(
                max_abs_err=err, tol_ratio=ratio, l_ratio=stats["l"], c_ratio=stats["c"])
            got[label] = out
            del want
        same = {"causal_attention_cond": always,
                "causal_attention_bounded (blocks_cond)": got["causal_attention_bounded"],
                "causal_attention_dma": got["causal_attention_bounded"]}
        for label, ref in same.items():
            if not all(torch.equal(a, b) for a, b in zip(got[label], ref)):
                raise AssertionError(f"{label} B={B}: not bit-equal to its blocks kernel")
        # dma2's kernel and the bounded kernel: within row 3's bars (their
        # per-thread sum orders match, and on the card they have given the
        # same bits)
        dma2, bounded = got["causal_attention_dma2"], got["causal_attention_bounded"]
        err, ratio = check_close(f"causal_attention_dma2 B={B} vs bounded blocks",
                                 dma2.o[valid], bounded.o[valid],
                                 ATOL_ROW_RMS_FRAC["causal_attention_dma2"])
        stats = lc_ratios(dma2, bounded, case["mask"])
        if max(stats.values()) > 1:
            raise AssertionError(f"causal_attention_dma2 B={B}: l or c outside row 3's bars "
                                 f"of the bounded blocks kernel {stats}")
        results["causal_attention_dma2"][f"vs_bounded_blocks_b{B}"] = dict(
            max_abs_err=err, tol_ratio=ratio, l_ratio=stats["l"], c_ratio=stats["c"])
        if B == 2:
            faults = {n: {} for n in VARIANT_ROWS}

            def o_fault(name, fault, want, rows_from=0):
                v = valid.clone()
                v[:, :rows_from] = False
                faults[name][fault] = must_reject(name, fault, got[name].o[v], want.o[v],
                                                  ATOL_ROW_RMS_FRAC[name])

            def c_fault(name, fault, out, want, rows_from=0):  # the shift must leave its bar
                m = case["mask"].clone()
                m[:, :rows_from] = 0
                r = lc_ratios(out, want, m)
                if not r["c"] > 1:
                    raise AssertionError(f"{name}: planted fault '{fault}' passes the c bar {r}")
                faults[name][fault] = r

            o_fault("causal_attention_cond", "diagonal tile left unmasked",
                    variant_reference(case, causal | diag, "online"))
            c_fault("causal_attention_twopass", "last valid tile skipped in pass 1",
                    got["causal_attention_twopass"],
                    variant_reference(case, causal, "twopass", max_keys=causal & ~diag),
                    rows_from=64)  # tile 0's rows have no other tile: their max is -1e9
            big = case["k"].clone()
            big[-1, VARIANT_REAL + 7] *= 3  # a padded key with the largest norm
            planted = {**case, "k": big, "kn": ca.key_norm_max(big)}
            c_fault("causal_attention_bounded", "kn over the valid keys only",
                    variant_call("causal_attention_bounded", planted),
                    variant_call("causal_attention_bounded", planted, cuda=False,
                                 kn=ca.key_norm_max(big * valid[:, :, None, None])))
            qn = case["qs"].float().pow(2).sum(-1).sqrt()  # [B, T, Hq]
            kv_of = torch.arange(Hq, device=dev) % Hkv  # for h // G
            bounded = got["causal_attention_bounded"]
            c_fault("causal_attention_bounded", "kn of KV head h % Hkv (not h // G)", bounded,
                    bounded._replace(m=(qn * case["kn"][:, None, kv_of]).transpose(1, 2)
                                     .reshape(B * Hq, T)))
            o_fault("causal_attention_dma", "diagonal tile not fetched",
                    variant_reference(case, causal & ~diag, "bounded"),
                    rows_from=64)  # tile 0's rows would see no key at all
            o_fault("causal_attention_dma2", "tile j's PV read from tile j+1's V stage",
                    variant_reference(case, causal, "bounded", v_next=True))
            for name in VARIANT_ROWS:
                results[name]["planted_fault_ratios"] = faults[name]
            log(f"causal variants: planted faults rejected: {json.dumps(faults)}")
        flops = 4.0 * hd * Hq * B * T * (T + 1) / 2
        nbytes = 2.0 * B * T * hd * (2 * Hq + 2 * Hkv) + 4.0 * B * T * (1 + 2 * Hq) + 4.0 * B * Hkv
        bms, bby = bound(flops, nbytes)
        sdpa = time_ms(variant_sdpa(case))
        suffix = "" if B == 2 else f"_b{B}"
        events_by_b[B] = {name: events_ms(lambda: variant_call(name, case))
                          for name in VARIANT_ROWS}  # a cross-check of CUPTI's times
        for name in VARIANT_ROWS:
            results[name].update({
                "ms" + suffix: time_ms(lambda: variant_call(name, case)),
                "plain_ms" + suffix: events_ms(lambda: variant_call(name, case, cuda=False),
                                             iters=3, warmup=1),
                "library_ms" + suffix: sdpa, "bound_ms" + suffix: bms, "bound_by" + suffix: bby})
        results["causal_attention_bounded"]["ms_blocks_cond" + suffix] = time_ms(
            lambda: variant_call(("blocks_cond", "bounded"), case))
        results["causal_attention_cond"]["ms_always" + suffix] = time_ms(
            lambda: ca.causal_attention_cuda(case["qs"], case["k"], case["v"], case["key_bias"]))
        del case, got, always
        torch.cuda.empty_cache()
    # the outlier input: the bounded family zeroes the rows its plain version
    # zeroes; twopass and cond stay within the bar of online
    case = variant_outlier_case(dev, gen)
    online = ca.causal_attention_cuda(case["qs"], case["k"], case["v"], case["key_bias"])
    zero_want = (variant_call("causal_attention_bounded", case, cuda=False).o == 0).all(dim=-1)
    for name in VARIANT_ROWS:
        out = variant_call(name, case)
        if name in ("causal_attention_twopass", "causal_attention_cond"):
            ratio = check_close(f"{name} on outlier keys vs online", out.o, online.o,
                                ATOL_ROW_RMS_FRAC[name])[1]
            results[name]["outlier_tol_ratio_vs_online"] = ratio
        else:
            zero = (out.o == 0).all(dim=-1)
            if not torch.equal(zero, zero_want) or not zero.any():
                raise AssertionError(f"{name}: zeroes {int(zero.sum())} rows on outlier keys, "
                                     f"its plain version {int(zero_want.sum())}")
            results[name]["outlier_rows_zeroed"] = f"{int(zero.sum())} of {zero.numel()}"
    del case, online
    for name in VARIANT_ROWS:
        r = results[name]
        r["sm90"] = dict(sm90_report(name, hd), ms_events=events_by_b[2][name],
                         ms_events_b8=events_by_b[8][name])
        log(f"{name} (wgmma / TMA, hd {hd}): {json.dumps(r['sm90'])}; ms {r['ms']:.4f} "
            f"({r['ms'].by}), B 8 {r['ms_b8']:.4f} ({r['ms_b8'].by})")
    for name, (fwd_impl, softmax, replaces, source) in VARIANT_ROWS.items():
        r = results[name]
        worst = max((c["tol_ratio"], c["max_abs_err"]) for c in r.pop("checks").values())
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            fwd_impl=fwd_impl, softmax_mode=softmax, max_abs_err=worst[1], tol_ratio=worst[0],
            tol={**tol_entry(ATOL_ROW_RMS_FRAC[name]), "l": "rtol 2^-8", "c": "atol 1e-4 + "
                 "rtol 1e-5"}, launches=None,
            shapes=f"qs[B,{T},{Hq},{hd}] k/v[B,{T},{Hkv},{hd}] bf16, last row's keys from "
                   f"{VARIANT_REAL} padded; B 2 (ms) and 8 (ms_b8)",
            notes="library_ms: SDPA(is_causal, enable_gqa), no padding mask", **r))
        log(f"kernel {name} ok: {json.dumps(rows[-1])}")
    return rows


def flip_budget(qs, k, v, key_bias, o, l, m, do):
    """One bf16 rounding flip of the largest term of each gradient sum: dq_i =
    sum_j bf16(dS_ij) k_j, dk_j = sum_i bf16(dS_ij) qs_i, dv_j = sum_i
    bf16(P_ij) dO_i. A flip moves a term by one bf16 ulp, at most 2^-7 of it.
    In a query row of the first tile P sits on a few keys, |dS| reaches 4-8,
    and one flip (the kernel and the plain version on either side of a
    rounding boundary, their P 1e-7..1e-6 apart) exceeds 2e-2 of the slab's
    RMS (PERF.md, PR 9). -> (dq, dk, dv) budgets broadcastable to the
    gradients."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = qs.float().reshape(B, T, Hkv, G, hd)
    s = ca._scores(qg, k, key_bias, "always")
    lq = l.reshape(B, Hkv, G, T, 1)
    p = torch.exp(s - m.reshape(B, Hkv, G, T, 1)) * torch.where(
        lq > 0, 1.0 / torch.where(lq > 0, lq, 1.0), 0.0)
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.float().reshape(B, T, Hkv, G, hd), v.float())
    d = ca.attention_bwd_prologue(o, do).reshape(B, Hkv, G, T, 1)
    ds = (p * (dp - d)).abs()
    del dp
    kmax = k.float().abs().amax(dim=(1, 3))  # [B, Hkv]
    qmax = qg.abs().amax(dim=(1, 3, 4))
    domax = do.float().abs().reshape(B, T, Hkv, G, hd).amax(dim=(1, 3, 4))
    fq = (ds.amax(-1) * kmax[:, :, None, None]).reshape(B, Hq, T).transpose(1, 2)[..., None]
    fk = (ds.amax(dim=(2, 3)) * qmax[:, :, None]).transpose(1, 2)[..., None]
    fv = (p.amax(dim=(2, 3)) * domax[:, :, None]).transpose(1, 2)[..., None]
    return tuple(BF16_ULP * f for f in (fq, fk, fv))


def grad_ratios(got, want, frac, budget) -> dict:
    """rows 11-12's ratio (atol frac x the (batch, head) slab's RMS + 2^-7
    |want|) and the checked one, whose bar also admits `budget`."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = frac * want.pow(2).mean(dim=GRAD_RMS_DIMS, keepdim=True).sqrt() + BF16_ULP * want.abs()
    plain = torch.where(err == 0, 0.0, err / bar).max().item()
    flip = torch.where(err == 0, 0.0, err / (bar + budget)).max().item()
    return dict(max_abs_err=err.max().item(), ratio_rows_11_12_bar=plain,
                ratio_with_one_flip=flip, worst_row=int(err.argmax()) // got[0, 0].numel()
                % got.shape[1])


def causal_variant_path(dev, gen) -> dict:
    """Phase 18 (b): `causal_mha(fwd_impl=..., softmax_mode=...)` forward and
    backward through autograd for every variant arm at B 2, T 2560, the
    counters zeroed just before and read just after: one forward launch of
    each variant's kernel, one dq and one dk/dv a call, no online 'always'
    forward. Then dq, dk, dv of twopass, bounded and dma2 against the plain
    backward on the kernel's residuals: rows 11-12's bar plus one bf16
    rounding flip of each sum's largest term (`flip_budget`), with the ratio
    to rows 11-12's bar alone reported beside it; fwd+bwd time of each arm by
    CUDA events."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    B, T, bf = 2, VARIANT_T, torch.bfloat16
    lc = full_config().llama
    Hq, Hkv, hd = lc.num_heads, lc.num_kv_heads, lc.head_dim
    q = torch.randn((B, T, Hq, hd), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((B, T, Hkv, hd), generator=gen, device=dev).to(bf) for _ in range(2))
    do = torch.randn((B, T, Hq, hd), generator=gen, device=dev).to(bf)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[-1, VARIANT_REAL:] = 0

    def fwd_bwd(fwd_impl, softmax):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = ca.causal_mha(*leaves, mask, fwd_impl=fwd_impl, softmax_mode=softmax)
        return torch.autograd.grad(o, leaves, do)

    torch.cuda.synchronize()
    zero_counters()
    grads = {arm: fwd_bwd(*arm) for arm in VARIANT_ARMS}
    torch.cuda.synchronize()
    launches = read_counters()
    n = len(VARIANT_ARMS)
    want = {"causal_attention_cond": 1, "causal_attention_bounded": 1,
            "causal_attention_bounded_cond": 1, "causal_attention_twopass": 1,
            "causal_attention_dma": 1, "causal_attention_dma2": 1, "causal_attention": 0,
            "causal_attention_dq": n, "causal_attention_dkv": n}
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"causal variants: {name} launched {launches[name]} times, "
                                 f"want {count}")
    scale = torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    qs = q * scale
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    kn = ca.key_norm_max(k)
    checked = {}
    for arm in (("blocks", "twopass"), ("blocks", "bounded"), ("dma2", "bounded")):
        res = ca.variant_forward(*arm)[1](qs, k, v, key_bias, kn)
        wq, wk, wv = ca.causal_attention_bwd_plain(qs, k, v, key_bias, res.o, res.l, res.m, do)
        budgets = flip_budget(qs, k, v, key_bias, res.o, res.l, res.m, do)
        budgets = (budgets[0] * scale.float(),) + budgets[1:]  # dq = dqs x the scale
        checked["/".join(arm)] = r = {}
        for g, got, w, budget in zip("qkv", grads[arm], (wq * scale, wk, wv), budgets):
            if not torch.isfinite(got).all():
                raise AssertionError(f"causal_mha {arm} d{g}: non-finite gradient")
            r[g] = grad_ratios(got, w, ATOL_ROW_RMS_FRAC[
                "causal_attention_dq" if g == "q" else "causal_attention_dkv"], budget)
            if r[g]["ratio_with_one_flip"] > 1:
                raise AssertionError(f"causal_mha {arm} d{g}: outside rows 11-12's bar plus one "
                                     f"bf16 flip: {r[g]}")
        del res, wq, wk, wv, budgets
    fwd_bwd_ms = {"/".join(arm): events_ms(lambda: fwd_bwd(*arm), iters=5, warmup=1)
                  for arm in VARIANT_ARMS + [("blocks", "online")]}
    log(json.dumps({"causal_variant_path": dict(
        label="causal_mha fwd+bwd per variant arm", batch=B, T=T, real=VARIANT_REAL,
        launches=launches, grads_vs_plain_backward=checked, fwd_bwd_ms_events=fwd_bwd_ms)}))
    return launches


def ksplit_kernel_checks(dev, gen):
    """Phase 18 (c): the K-split W4A16 launch at block_k 768 and 1536, both
    pack formats, at decode q|k|v (M 4, K 3072, N 5120) and the prefill's
    q|k|v, o (N 3072) and gate|up (N 16384) at M 6104 against the K-split
    plain version; planted faults (the last K block dropped; every K block
    read with block 0's scales); K 8192 (the down projection) falls back to
    the whole-K launch bit for bit; timed beside the whole-K launch and a
    bf16 matmul on the dequantized weight."""
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    cfg = full_config()
    lc = cfg.llama
    B = len(INT4_PROMPTS)
    M_pre = B * (cfg.audio_seq_len + 2 + max(INT4_PROMPTS))
    L, D, Fd, bf = lc.num_layers, lc.hidden_size, lc.intermediate_size, torch.bfloat16
    Nqkv = (lc.num_heads + 2 * lc.num_kv_heads) * lc.head_dim
    li = min(5, L - 1)
    name = "int4_matmul_stacked_ksplit"
    frac = ATOL_ROW_RMS_FRAC[name]

    def rand_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int32
                             ).to(torch.int8)

    def rand_scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.002

    by_shape, faults, worst = [], {}, (0.0, 0.0)
    Nq = lc.num_heads * lc.head_dim
    for label, M, K, N in (("decode q|k|v", B, D, Nqkv), ("prefill q|k|v", M_pre, D, Nqkv),
                           ("prefill o", M_pre, Nq, D), ("prefill gate|up", M_pre, D, 2 * Fd)):
        packed, scales = rand_bytes(L, K, N // 2), rand_scales(L, K // 128, N)
        x = torch.randn((M, K), generator=gen, device=dev).to(bf)
        for fmt in ("pair", "obin"):
            for bk in (768, 1536):
                want = i4.int4_matmul_stacked_ksplit_plain(x, packed, scales, li, bk, fmt=fmt)
                got = i4.int4_matmul_stacked_cuda(x, packed, scales, li, fmt=fmt, block_k=bk)
                lo, hi = i4.int4_matmul_stacked_cuda(x, packed, scales, li, fmt=fmt, block_k=bk,
                                                     return_planes=True)
                if not torch.equal(torch.cat([lo, hi], dim=-1), got):
                    raise AssertionError(f"{name} {label}: planes differ from the row output")
                err, ratio = check_close(f"{name} {label} {fmt} bk {bk}", got, want, frac)
                worst = max(worst, (ratio, err))
                if fmt == "pair" and M <= 64:
                    faults.update({f"{label} bk {bk}: {k}": v for k, v in decode_faults(
                        got, want, frac,
                        lambda p: i4.int4_matmul_stacked_cuda(x, p, scales, li, block_k=bk),
                        packed, li, x, i4.decode_plan(M, K, N // 2, 128, bk),
                        lambda xx, p: i4.int4_matmul_stacked_ksplit_plain(
                            xx, p, scales, li, bk)).items()})
                if fmt == "pair":
                    nb, gpb = K // bk, bk // 128
                    dropped = x.clone()
                    dropped[:, (nb - 1) * bk:] = 0
                    faults[f"{label} bk {bk}: the last K block dropped"] = must_reject(
                        name, "a K block dropped", got, i4.int4_matmul_stacked_ksplit_plain(
                            dropped, packed, scales, li, bk), frac)
                    if nb > 1:
                        s0 = scales.clone()
                        s0[li] = scales[li, :gpb].repeat(nb, 1)
                        faults[f"{label} bk {bk}: every block read with block 0's scales"] = \
                            must_reject(name, "block 0's scales", i4.int4_matmul_stacked_cuda(
                                x, packed, s0, li, block_k=bk), want, frac)
                        del s0
                    del dropped
                del want, got, lo, hi
        w_deq = i4.dequantize_ref(packed[li], scales[li]).to(bf)
        flops, nbytes = 2.0 * M * K * N, K * N / 2 + (K / 128) * N * 4 + 2.0 * M * (K + N)
        bms, bby = bound(flops, nbytes)
        iters = 56 if M <= 64 else 10
        turn = itertools.count()
        shape_row = dict(shape=label, M=M, K=K, N=N, fmt="pair", bound_ms=bms, bound_by=bby)
        for bk in (768, 1536):
            shape_row[f"ms_bk{bk}"] = time_ms(lambda: i4.int4_matmul_stacked_cuda(
                x, packed, scales, next(turn) % L, block_k=bk), iters=iters)
        shape_row["ms_whole_k"] = time_ms(lambda: i4.int4_matmul_stacked_cuda(
            x, packed, scales, next(turn) % L), iters=iters)
        shape_row["plain_ms"] = events_ms(lambda: i4.int4_matmul_stacked_ksplit_plain(
            x, packed, scales, li, 768), iters=10 if M <= 64 else 3)
        shape_row["library_ms"] = time_ms(lambda: x @ w_deq, iters=iters)
        if M <= 64:  # the yardstick from device memory too; the hot one beside it
            n = cold_layers(2.0 * K * N)
            w_rot = [i4.dequantize_ref(packed[i], scales[i]).to(bf) for i in range(n)]
            shape_row["library_ms_hot"] = shape_row["library_ms"]
            shape_row["library_ms"] = rotated_ms(lambda i: x @ w_rot[i], n)
            del w_rot
        by_shape.append(shape_row)
        log(f"kernel {name} {label} ok: {json.dumps(shape_row)}")
        del packed, scales, x, w_deq
        torch.cuda.empty_cache()
    # the down projection's K 8192 divides by neither block: the whole-K launch
    fallback = {}
    for M in (B, M_pre):
        packed, scales = rand_bytes(2, Fd, D // 2), rand_scales(2, Fd // 128, D)
        x = torch.randn((M, Fd), generator=gen, device=dev).to(bf)
        whole = i4.int4_matmul_stacked_cuda(x, packed, scales, 1)
        for bk in (768, 1536):
            before = (i4.launches, i4.launches_ksplit)
            got = i4.int4_matmul_stacked(x, packed, scales, 1, block_k=bk)
            if (i4.launches - before[0], i4.launches_ksplit - before[1]) != (1, 0) or \
                    not torch.equal(got, whole):
                raise AssertionError(f"{name}: K 8192 at bk {bk}, M {M} is not the whole-K launch")
        fallback[f"M {M}"] = "whole-K launch, bit-equal"
        del packed, scales, x, whole, got
    first = by_shape[0]
    row = dict(
        name=name, route="cuda", source="audio_llama_tpu_torch/csrc/int4_matmul.cu",
        replaces="audio_llama_tpu/ops/int4_matmul.py:393", max_abs_err=worst[1],
        tol=tol_entry(frac), tol_ratio=worst[0], planted_fault_ratios=faults,
        geometry_fallback=fallback, ms=first["ms_bk768"], ms_whole_k=first["ms_whole_k"],
        plain_ms=first["plain_ms"], library_ms=first["library_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], launches=None, library_ms_hot=first["library_ms_hot"],
        shapes="the row's times are decode q|k|v (M 4) at block_k 768; by_shape has bk 1536, "
               "the prefill's q|k|v, o and gate|up and the whole-K launch beside each",
        notes="library_ms: x @ the dequantized bf16 weight (cuBLAS); at M <= 64 rotated over "
              "layers that exceed the L2 (library_ms_hot: one layer)", by_shape=by_shape)
    log(f"kernel {name} ok: planted faults rejected: {faults}")
    return [row]


def ksplit_path(dev, model, request) -> dict:
    """Phase 18 (d): the int4 path's model and request (int4w+kv4, B = 4) with
    INT4_BK = 768 for the run (restored after), the JAX package's round-5
    decode arm: 32 greedy tokens with the counters zeroed around them
    (K-split launches for every q|k|v, o and prefill gate|up call, whole-K for
    the prefill down projection's K 8192); the first decode step's logits
    within rel-L2 HOST_TOL of the whole-K run's; decode time per token beside
    the whole-K run's, both in this call."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    cfg, frozen, trainable = model
    ids, mask, wav = request["ids"], request["mask"], request["wav"]
    B, L = ids.shape[0], cfg.llama.num_layers
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=4, greedy=True)

    def run(n):
        return generate(frozen, trainable, cfg, ids, mask, wav, None, max_new_tokens=n, **kw)

    def timed():
        run(2)
        first_ms = min(synced_ms(lambda: run(1)) for _ in range(2))
        return first_ms, synced_ms(lambda: run(N_NEW))

    saved = i4.INT4_BK
    i4.INT4_BK = 0
    whole_first, whole_total = timed()
    whole = first_step_logits(frozen, trainable, cfg, ids, mask, wav, 4)
    try:
        i4.INT4_BK = 768
        split_first, _ = timed()
        zero_counters()
        result = {}
        total_ms = synced_ms(lambda: result.setdefault("out", run(N_NEW)))
        launches = read_counters()
        split = first_step_logits(frozen, trainable, cfg, ids, mask, wav, 4)
    finally:
        i4.INT4_BK = saved
    toks = result["out"].tokens
    check_tokens("int4 K-split", toks, (B, N_NEW), cfg.llama.vocab_size + 2)
    want = {"int4_matmul_stacked_ksplit": 3 * L + 2 * L * (N_NEW - 1),
            "int4_matmul_stacked": L, "mlp_int4_stacked": L * (N_NEW - 1),
            "decode_attention_quantized4_mono": L * (N_NEW - 1)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"int4 K-split: {name} launched {launches[name]} times, "
                                 f"want {n}")
    rel = rel_l2(split, whole)
    if not (torch.isfinite(split).all() and rel <= HOST_TOL):
        raise AssertionError(f"int4 K-split: first decode step's logits rel-L2 {rel} vs the "
                             f"whole-K run (bar {HOST_TOL})")
    stats = dict(
        label="int4w+kv4, B=4, INT4_BK=768", batch=B, new_tokens=N_NEW,
        decode_ms_per_token=(total_ms - split_first) / (N_NEW - 1),
        whole_k_decode_ms_per_token=(whole_total - whole_first) / (N_NEW - 1),
        prefill_ms_with_encode=split_first, whole_k_prefill_ms_with_encode=whole_first,
        first_step_logits_rel_l2_vs_whole_k=rel, tol_rel_l2=HOST_TOL,
        first_step_argmax_agree=(split.argmax(-1) == whole.argmax(-1)).float().mean().item(),
        tokens=toks.tolist(), launches=launches)
    log(json.dumps({"ksplit_path": stats}))
    return launches


# ---------------------------------------------------------------------------
# phase 19: the last three Pallas kernels (single-buffered decode attention on
# bf16 and int8 caches, the unstacked W4A16)
# ---------------------------------------------------------------------------

SINGLE_ROWS = {  # kernel row -> (cache bits, TPU kernel it replaces)
    "decode_attention": (16, "audio_llama_tpu/ops/decode_attention.py:34"),
    "decode_attention_quantized": (8, "audio_llama_tpu/ops/decode_attention.py:189"),
}
SINGLE_STEPS = 4  # decode steps of the single kernels' own path, every layer each


def single_call(case, bits, li, off, valid, scale, cuda=True, rows=None, fresh=None,
                copy=True):
    """One call of a single-buffered decode kernel (or its plain version) on
    copies of the case's caches (the caches themselves with copy=False) ->
    (out, caches after). The int8 kernel reads layer li's scales and the fresh
    rows' scales; `rows` / `fresh` plant others."""
    from audio_llama_tpu_torch.ops import decode_attention as da

    caches = [c.clone() for c in case["caches"]] if copy else case["caches"]
    q, rows, fresh = case["q"], rows or case["rows"], fresh or case["fresh"]
    if bits == 16:
        fn = da.decode_attention_cuda if cuda else da.decode_attention_plain
        return fn(q, rows[0], rows[1], caches[0], caches[1], li, off, valid, scale)[0], caches
    fn = da.decode_attention_quantized_cuda if cuda else da.decode_attention_quantized_plain
    ks, vs = (s_[li] for s_ in case["scales"])
    return fn(q, rows[0], rows[1], caches[0], caches[1], ks, vs, *fresh, li, off, valid,
              scale)[0], caches


def single_decode_checks(dev, gen):
    """Phase 19 (a): `decode_attention` (bf16 cache) and
    `decode_attention_quantized` (int8 cache) at the decoder's geometry (28
    layers, 8 KV heads, 24 query heads), 1568 and 3040 slots, B 1 and 4,
    against their plain versions: the output within the bar, the caches
    bit-equal with only the offset's slot changed, the int8 kernel's scale
    arrays untouched; planted faults (p not normalized: the db stats kernel's
    acc; a stale fresh row); timed at B = 1, 3040 slots beside the plain
    version and SDPA on the same slab. Then the kernels' own path:
    SINGLE_STEPS decode steps through every layer at B = 4, counted."""
    cfg = full_config()
    lc = cfg.llama
    L, Hkv, Hq, hd = lc.num_layers, lc.num_kv_heads, lc.num_heads, lc.head_dim
    scale, li = hd ** -0.5, min(5, L - 1)
    timelines = (_rounded_len(cfg.audio_seq_len + 2 + PROMPT + N_NEW), 3040)
    rows, cases = [], {}
    for name, (bits, replaces) in SINGLE_ROWS.items():
        frac = ATOL_ROW_RMS_FRAC[name]
        results, faults = {}, {}
        for S, B in itertools.product(timelines, (1, 4)):
            case = db_case(dev, gen, bits, B, S, L, Hkv, Hq, hd)
            kpos = torch.arange(S, device=dev)[None, :]
            off = S - 24
            valid = (kpos <= off).to(torch.int32).repeat(B, 1)
            for b in range(B):
                valid[b, 100 * b + 3:100 * b + 10] = 0
            scales0 = [s_.clone() for s_ in case["scales"] or ()]
            got, gc = single_call(case, bits, li, off, valid, scale)
            want, wc = single_call(case, bits, li, off, valid, scale, cuda=False)
            torch.cuda.synchronize()
            label = f"{name} S={S}, B={B}"
            err, ratio = check_close(label, got, want, frac)
            check_append(label, gc, wc, case["caches"], case["rows"], li, off)
            if any(not torch.equal(a, b) for a, b in zip(case["scales"] or (), scales0)):
                raise AssertionError(f"{label}: the kernel wrote the scale arrays")
            results[label] = dict(max_abs_err=err, tol_ratio=ratio)
            if B == 4 and S == timelines[1]:
                acc = db_call(case, bits, li, off, valid, scale)[2]
                faults["p not normalized"] = must_reject(name, "p not normalized",
                                                         acc.to(want.dtype), want, frac)
                short = AB_FAULT_OFFSET
                svalid = (kpos <= short).to(torch.int32).repeat(B, 1)
                swant = single_call(case, bits, li, short, svalid, scale, cuda=False)[0]
                check_close(f"{label}, offset {short}",
                            single_call(case, bits, li, short, svalid, scale)[0], swant, frac)
                stale = [c[li, :, :, short].clone() for c in case["caches"]]
                stale_fresh = None if bits == 16 else [s_[li, :, :, short].clone()
                                                       for s_ in case["scales"]]
                faults[f"stale row read at offset {short}"] = must_reject(
                    name, "stale row read at the offset",
                    single_call(case, bits, li, short, svalid, scale, rows=stale,
                                fresh=stale_fresh)[0], swant, frac)
                cases[name] = (case, valid, off)
            else:
                del case
            del gc, wc
        S = timelines[1]
        off = S - 24
        valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32)
        n_valid = int(valid.sum())
        case = db_case(dev, gen, bits, 1, S, L, Hkv, Hq, hd)
        turn = itertools.count()

        def kernel(cuda):  # appends at one slot again, layer by layer
            return single_call(case, bits, next(turn) % L, off, valid, scale, cuda=cuda,
                               copy=False)

        row_bytes = {16: 4 * hd, 8: 2 * hd + 8}[bits]
        nbytes = Hkv * n_valid * row_bytes + 2.0 * Hq * hd * 2 + 4.0 * S + Hkv * row_bytes
        bms, bby = bound(4.0 * Hq * n_valid * hd, nbytes)
        row = dict(
            name=name, route="cuda", source="audio_llama_tpu_torch/csrc/decode_attention_single.cu",
            replaces=replaces, max_abs_err=max(r["max_abs_err"] for r in results.values()),
            tol=tol_entry(frac), tol_ratio=max(r["tol_ratio"] for r in results.values()),
            checks=results, planted_fault_ratios=faults,
            ms=time_ms(lambda: kernel(True), iters=56),
            plain_ms=events_ms(lambda: kernel(False), iters=8),
            library_ms=time_ms(sdpa_slab(case, bits, valid, scale, turn), iters=112),
            library_note="SDPA over the same slab (K/V bf16, dequantized and repeated per query "
                         "head ahead of time)",
            launches=None, bound_ms=bms, bound_by=bby,
            shapes=f"caches [{L},B,{Hkv},S,{hd}] ({bits}-bit), q [B,{Hq},{hd}] bf16, S "
                   f"{timelines}, B 1 and 4; timed at B=1, S={S}, {n_valid} valid slots")
        log(f"kernel {name} ok: {json.dumps(row)}")
        rows.append(row)
        del case
        torch.cuda.empty_cache()
    # the kernels' own path: every layer of SINGLE_STEPS decode steps, B = 4
    zero_counters()
    for name, (bits, _) in SINGLE_ROWS.items():
        case, valid, off = cases[name]
        for step in range(SINGLE_STEPS):
            valid[:, off + step] = 1
            for layer in range(L):
                single_call(case, bits, layer, off + step, valid, scale, copy=False)
    torch.cuda.synchronize()
    launches = read_counters()
    for name in SINGLE_ROWS:
        if launches[name] != SINGLE_STEPS * L:
            raise AssertionError(f"single decode path: {name} launched {launches[name]} "
                                 f"times, want {SINGLE_STEPS * L}")
    log(json.dumps({"single_decode_path": {
        "steps": SINGLE_STEPS, "layers": L, "batch": 4, "slots": timelines[1],
        "launches": {n: launches[n] for n in SINGLE_ROWS}}}))
    return rows, launches


def int4_2d_checks(dev, gen):
    """Phase 19 (b): the unstacked W4A16 `int4_matmul` at q_proj (K 3072, N
    3072) and down_proj (K 8192, N 3072), M 4 and 6104, both pack formats,
    against `int4_matmul_plain`; planted faults (the last scale group's rows
    dropped; every group read with group 0's scales); timed at M 4, 1526 and
    6104 beside the plain version and a bf16 matmul on the dequantized weight.
    Then its path: `models/llama.py::_linear` on a 2-D w_p tree and on a
    pack-after-shard [K, 1, N/2] one smoothed by w_r, at M 4 and 6104,
    against the plain version, counted."""
    from audio_llama_tpu_torch.models import llama
    from audio_llama_tpu_torch.ops import int4_matmul as i4

    cfg = full_config()
    lc = cfg.llama
    D, Fd, bf = lc.hidden_size, lc.intermediate_size, torch.bfloat16
    Nq = lc.num_heads * lc.head_dim
    M_pre = len(INT4_PROMPTS) * (cfg.audio_seq_len + 2 + max(INT4_PROMPTS))
    M1 = cfg.audio_seq_len + 2 + PROMPT  # B = 1's prefix
    name = "int4_matmul"
    frac = ATOL_ROW_RMS_FRAC[name]

    def weight(K, N):
        packed = torch.randint(-128, 128, (K, N // 2), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
        return packed, torch.rand((K // 128, N), generator=gen, device=dev) * 0.02 + 0.002

    results, faults, by_shape = {}, {}, []
    weights = {}
    for label, K, N in (("q_proj", D, Nq), ("down_proj", Fd, D)):
        packed, scales = weights[label] = weight(K, N)
        for M in (len(INT4_PROMPTS), M_pre):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            for fmt in ("pair", "obin"):
                got = i4.int4_matmul_cuda(x, packed, scales, fmt=fmt)
                want = i4.int4_matmul_plain(x, packed, scales, fmt=fmt)
                key = f"{label} M={M} {fmt}"
                err, ratio = check_close(f"{name} {key}", got, want, frac)
                results[key] = dict(max_abs_err=err, tol_ratio=ratio)
                if fmt == "pair":
                    dropped = x.clone()
                    dropped[:, K - 128:] = 0
                    faults[f"{label} M={M}: the last group dropped"] = must_reject(
                        name, "a group dropped", got, i4.int4_matmul_plain(dropped, packed,
                                                                           scales), frac)
                    s0 = scales[:1].repeat(K // 128, 1)
                    faults[f"{label} M={M}: group 0's scales everywhere"] = must_reject(
                        name, "group 0's scales", i4.int4_matmul_cuda(x, packed, s0), want, frac)
                    del dropped, s0
                del got, want
            del x
        w_deq = i4.dequantize_ref(packed, scales).to(bf)
        # a decode step streams each weight from device memory: the M 4 rows
        # rotate the kernel over copies of the weight, and the yardstick over
        # copies of its dequantized bf16, each set past the L2 (ms_hot,
        # library_ms_hot: one weight)
        n_p, n_w = cold_layers(K * N / 2 + (K / 128) * N * 4), cold_layers(2.0 * K * N)
        copies = [(packed.clone(), scales.clone()) for _ in range(n_p)]
        w_rot = [w_deq.clone() for _ in range(n_w)]
        for M in (len(INT4_PROMPTS), M1, M_pre):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            bms, bby = bound(2.0 * M * K * N, K * N / 2 + (K / 128) * N * 4 + 2.0 * M * (K + N))
            iters = 56 if M <= 64 else 10
            entry = dict(
                shape=label, M=M, K=K, N=N, bound_ms=bms, bound_by=bby,
                ms=time_ms(lambda: i4.int4_matmul_cuda(x, packed, scales), iters=iters),
                plain_ms=events_ms(lambda: i4.int4_matmul_plain(x, packed, scales),
                                   iters=10 if M <= 64 else 3),
                library_ms=time_ms(lambda: x @ w_deq, iters=iters))
            if M <= 64:
                entry["ms_hot"], entry["library_ms_hot"] = entry["ms"], entry["library_ms"]
                entry["ms"] = rotated_ms(lambda i: i4.int4_matmul_cuda(x, *copies[i]), n_p)
                entry["library_ms"] = rotated_ms(lambda i: x @ w_rot[i], n_w)
            by_shape.append(entry)
            log(f"kernel {name} {label} ok: {json.dumps(by_shape[-1])}")
            del x
        del w_deq, copies, w_rot
    # its path: _linear's w_p branch, plain and smoothed, decode and prefill rows
    zero_counters()
    linear_checks, n_calls = {}, 0
    for label, K, N in (("q_proj", D, Nq), ("down_proj", Fd, D)):
        packed, scales = weights[label]
        w_r = torch.rand((K,), generator=gen, device=dev) + 0.5
        trees = {"2-D w_p": {"w_p": packed, "w_s": scales},
                 "[K, 1, N/2] w_p, w_r": {"w_p": packed[:, None], "w_s": scales, "w_r": w_r}}
        for M in (len(INT4_PROMPTS), M_pre):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            for tname, tree in trees.items():
                got = llama._linear(x, tree, None, bf)
                n_calls += 1
                xq = x * w_r.to(bf) if "w_r" in tree else x
                err, ratio = check_close(f"_linear {label} {tname} M={M}", got,
                                         i4.int4_matmul_plain(xq, packed, scales), frac)
                linear_checks[f"{label} {tname} M={M}"] = dict(max_abs_err=err, tol_ratio=ratio)
            del x
    torch.cuda.synchronize()
    launches = read_counters()
    if launches[name] != n_calls:
        raise AssertionError(f"int4_2d path: {name} launched {launches[name]} times, "
                             f"want {n_calls}")
    # the same path on group-32 weights (the scale group of smoothed and GPTQ
    # trees), counted on their own
    zero_counters()
    n_g32 = 0
    for label, K, N in (("q_proj", D, Nq), ("down_proj", Fd, D)):
        packed, scales = i4.quantize_pack(
            torch.randn((K, N), generator=gen, device=dev) * 0.02, SMOOTH_GROUP)
        for M in (len(INT4_PROMPTS), M_pre):
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            got = llama._linear(x, {"w_p": packed, "w_s": scales}, None, bf)
            n_g32 += 1
            err, ratio = check_close(
                f"_linear {label} group {SMOOTH_GROUP} M={M}", got,
                i4.int4_matmul_plain(x, packed, scales, SMOOTH_GROUP), frac)
            linear_checks[f"{label} 2-D w_p group {SMOOTH_GROUP} M={M}"] = dict(
                max_abs_err=err, tol_ratio=ratio)
            del x, got
        del packed, scales
    torch.cuda.synchronize()
    launches_g32 = read_counters()
    if launches_g32[name] != n_g32:
        raise AssertionError(f"int4_2d path, group {SMOOTH_GROUP}: {name} launched "
                             f"{launches_g32[name]} times, want {n_g32}")
    first = by_shape[0]
    row = dict(
        name=name, route="cuda", source="audio_llama_tpu_torch/csrc/int4_matmul.cu",
        replaces="audio_llama_tpu/ops/int4_matmul.py:256",
        max_abs_err=max(r["max_abs_err"] for r in results.values()), tol=tol_entry(frac),
        tol_ratio=max(r["tol_ratio"] for r in results.values()), checks=results,
        planted_fault_ratios=faults, linear_checks=linear_checks, ms=first["ms"],
        plain_ms=first["plain_ms"], library_ms=first["library_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], launches=None,
        ms_hot=first["ms_hot"], library_ms_hot=first["library_ms_hot"],
        shapes="the row's times are q_proj at M 4; by_shape has M 1526 and 6104 and "
               "down_proj",
        notes="library_ms: x @ the dequantized bf16 weight (cuBLAS); at M 4 the kernel and "
              "the yardstick rotate over copies of their weights that exceed the L2 (ms_hot, "
              "library_ms_hot: one weight)", by_shape=by_shape)
    log(f"kernel {name} ok: planted faults rejected: {faults}")
    del weights
    torch.cuda.empty_cache()
    return [row], launches, launches_g32


# ---------------------------------------------------------------------------
# phase 22: the int4 kernels' scale group; the quantization-accuracy path
# ---------------------------------------------------------------------------

GROUP_CHECKS = (32, 64)  # scale groups the kernels run at beside 128
# the path whose count each row's group-32 entry reports: smooth_path
# quantizes at group 32 (B = 4 clipped run; its INT4_BK=768 run), int4_2d_path
# its group-32 tree
GROUP_PATH = {"int4_matmul_stacked": "smooth_clip", "mlp_int4_stacked": "smooth_clip",
              "mlp_int4_stacked[dn_r]": "smooth", "int4_matmul_stacked_ksplit": "smooth_bk768",
              "int4_matmul": "int4_2d_g32"}


def group_kernel_checks(dev, gen, rows) -> None:
    """Phase 22 (a): rows 6, 7, 7r, 28 and 31 again at groups 32 and 64, at
    their shapes (B = 4 decode and the int4 path's 6104-row prefill), each
    against its plain version at the same group and bar; the planted fault
    group g's partial scaled by group g+1's scale (the scales rolled by one
    group) must land outside it. Timed beside the plain version and the
    library call, the bound at that group's bytes (its scales are K/g x N
    f32). The plain versions, tens of thousands of small launches a call at
    group 32, are timed by CUDA events over one call: a CUPTI trace of them
    takes minutes. Each row gets `by_group` {group: entry}; main() adds the
    group-32 launches of the path that runs it."""
    import torch.nn.functional as F

    from audio_llama_tpu_torch.models.llama_int4 import _equalize_rows
    from audio_llama_tpu_torch.ops import int4_matmul as i4
    from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

    t0 = time.perf_counter()
    cfg = full_config()
    lc = cfg.llama
    B = len(INT4_PROMPTS)
    M_pre = B * (cfg.audio_seq_len + 2 + max(INT4_PROMPTS))
    L, D, Fd, bf = lc.num_layers, lc.hidden_size, lc.intermediate_size, torch.bfloat16
    Nqkv = (lc.num_heads + 2 * lc.num_kv_heads) * lc.head_dim
    Nq = lc.num_heads * lc.head_dim
    li = min(5, L - 1)
    by_row = {name: {} for name in GROUP_PATH}

    def rand_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int32
                             ).to(torch.int8)

    def rand_scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.002

    def entry(name, label, group, run, plain, fault, library, flops, nbytes, iters, turn=None,
              cold=None):
        """Check run() against plain(), fault() outside; time all three.
        cold: (fn(i), n), the yardstick rotated over n weights past the L2
        (then library_ms; library() is kept as library_ms_hot)."""
        frac = ATOL_ROW_RMS_FRAC[name.replace("[dn_r]", "")]
        want = plain()
        err, ratio = check_close(f"{name} group {group} {label}", run(), want, frac)
        fault_ratio = must_reject(name, f"group {group}: group g+1's scale", fault(), want,
                                  frac)
        bms, bby = bound(flops, nbytes)
        e = dict(shape=label, group=group, max_abs_err=err, tol_ratio=ratio,
                 planted_fault_ratios={"group g's partial scaled by group g+1's scale":
                                       fault_ratio},
                 ms=time_ms(turn or run, iters=iters),
                 plain_ms=events_ms(plain, iters=1, warmup=0),
                 library_ms=time_ms(library, iters=iters), bound_ms=bms, bound_by=bby)
        if cold is not None:
            e["library_ms_hot"], e["library_ms"] = e["library_ms"], rotated_ms(*cold, iters=iters)
        log(f"kernel {name} group {group} {label} ok: {json.dumps(e)}")
        return e

    for group in GROUP_CHECKS:
        # rows 6 and 28: decode q|k|v (pair, planes), prefill gate|up; K-split at 768
        for label, M, K, N in (("decode q|k|v", B, D, Nqkv), ("prefill gate|up", M_pre, D, 2 * Fd)):
            packed, scales = rand_bytes(L, K, N // 2), rand_scales(L, K // group, N)
            rolled = torch.roll(scales, -1, dims=1).contiguous()
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            w_deq = i4.dequantize_ref(packed[li], scales[li], group).to(bf)
            nbytes = K * N / 2 + (K / group) * N * 4 + 2.0 * M * (K + N)
            iters = 56 if M <= 64 else 10
            n = cold_layers(2.0 * K * N)
            w_rot = [i4.dequantize_ref(packed[i], scales[i], group).to(bf)
                     for i in range(n)] if M <= 64 else None
            for name, bk in (("int4_matmul_stacked", 0), ("int4_matmul_stacked_ksplit", 768)):
                turn = itertools.count()

                def run(s=scales, layer=li, bk=bk):
                    return torch.cat(i4.int4_matmul_stacked_cuda(
                        x, packed, s, layer, group, return_planes=True, block_k=bk), dim=-1)

                by_row[name][f"{group} {label}"] = entry(
                    name, label, group, run,
                    lambda bk=bk: i4.int4_matmul_stacked_plain(x, packed, scales, li, group,
                                                               block_k=bk),
                    lambda run=run: run(s=rolled), lambda: x @ w_deq, 2.0 * M * K * N, nbytes,
                    iters, turn=lambda run=run, turn=turn: run(layer=next(turn) % L),
                    cold=None if w_rot is None else (lambda i: x @ w_rot[i], n))
            del packed, scales, rolled, x, w_deq, w_rot
            torch.cuda.empty_cache()
        # row 31: the unstacked W4A16 at q_proj, decode and prefill rows
        packed, scales = rand_bytes(D, Nq // 2), rand_scales(D // group, Nq)
        rolled = torch.roll(scales, -1, dims=0).contiguous()
        w_deq = i4.dequantize_ref(packed, scales, group).to(bf)
        # the M 4 row rotates the kernel and the yardstick over copies past the L2
        n_p, n_w = cold_layers(D * Nq / 2 + (D / group) * Nq * 4), cold_layers(2.0 * D * Nq)
        copies = [(packed.clone(), scales.clone()) for _ in range(n_p)]
        w_rot = [w_deq.clone() for _ in range(n_w)]
        for M in (B, M_pre):
            x = torch.randn((M, D), generator=gen, device=dev).to(bf)
            turn = itertools.count()
            by_row["int4_matmul"][f"{group} q_proj M={M}"] = entry(
                "int4_matmul", f"q_proj M={M}", group,
                lambda: i4.int4_matmul_cuda(x, packed, scales, group),
                lambda: i4.int4_matmul_plain(x, packed, scales, group),
                lambda: i4.int4_matmul_cuda(x, packed, rolled, group), lambda: x @ w_deq,
                2.0 * M * D * Nq, D * Nq / 2 + (D / group) * Nq * 4 + 2.0 * M * (D + Nq),
                56 if M <= 64 else 10,
                turn=(lambda: i4.int4_matmul_cuda(x, *copies[next(turn) % n_p], group))
                if M <= 64 else None,
                cold=(lambda i: x @ w_rot[i], n_w) if M <= 64 else None)
        del packed, scales, rolled, w_deq, x, copies, w_rot
        # rows 7 and 7r: the fused MLP at M = B, without and with dn_r
        dh = D // 2
        gup, gus = rand_bytes(L, D, Fd), rand_scales(L, D // group, 2 * Fd)
        dn, dns = rand_bytes(L, Fd, dh), rand_scales(L, Fd // group, D)
        gus_rolled = torch.roll(gus, -1, dims=1).contiguous()
        x = torch.randn((B, D), generator=gen, device=dev).to(bf)
        chunk = mlp4.kernel_chunk(Fd, dh, group)
        w = torch.randn((Fd, D), generator=gen, device=dev) * 0.02
        w[torch.randint(0, Fd, (8,), generator=gen, device=dev)] *= 8.0
        dn_r = _equalize_rows(w)[1].expand(L, Fd).contiguous()
        wg = i4.dequantize_ref(gup[li], gus[li], group).to(bf)
        wd = i4.dequantize_ref(dn[li], dns[li], group).to(bf)
        n_rot = cold_layers(2.0 * D * 3 * Fd)
        w_rot = [(i4.dequantize_ref(gup[i], gus[i], group).to(bf),
                  i4.dequantize_ref(dn[i], dns[i], group).to(bf)) for i in range(n_rot)]
        nbytes = D * Fd + (D / group) * 2 * Fd * 4 + Fd * dh + (Fd / group) * D * 4 + 4.0 * B * D
        flops = 2.0 * B * D * 2 * Fd + 2.0 * B * Fd * D
        for name, r in (("mlp_int4_stacked", None), ("mlp_int4_stacked[dn_r]", dn_r)):
            turn = itertools.count()
            r_bf = None if r is None else r[li].to(bf)

            def run(gs=gus, layer=li, r=r):
                return mlp4.mlp_int4_stacked_cuda(x, gup, gs, dn, dns, layer, group, chunk,
                                                  dn_r=r)

            def library(r_bf=r_bf, w=(wg, wd)):
                a = F.silu(x @ w[0][:, :Fd]) * (x @ w[0][:, Fd:])
                return (a if r_bf is None else a * r_bf) @ w[1]

            by_row[name][f"{group} decode"] = entry(
                name, f"x[{B},{D}], chunk {chunk}", group, run,
                lambda r=r: mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li, group, chunk,
                                                        dn_r=r),
                lambda run=run: run(gs=gus_rolled), library,
                flops, nbytes + (0.0 if r is None else 4.0 * Fd), 56,
                turn=lambda run=run, turn=turn: run(layer=next(turn) % L),
                cold=(lambda i, library=library: library(w=w_rot[i]), n_rot))
        del gup, gus, dn, dns, gus_rolled, x, w, dn_r, wg, wd, w_rot
        torch.cuda.empty_cache()
    for row in rows:
        if row["name"] in by_row:
            row["by_group"] = by_row[row["name"]]
    log(f"group_kernel_checks: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 20: the continuous-batching pool and its HTTP server at full width
# ---------------------------------------------------------------------------

SERVE_ROWS, SERVE_CHUNK = 4, 8
SERVE_BUCKETS = (32, 64)
SERVE_AUDIO_PROMPTS = (24, 20, 16, 12)  # the text of the four audio requests
SERVE_SUFFIXES = (12, 9, 6, 3)  # the four text suffixes of the registered prefix
SERVE_INSTRUCTION = 20  # the prefix's instruction tokens (after its audio block)
SERVE_PIECE = 512  # prefill_chunk_tokens of the chunked-prefill check
# int4 KV under chunked prefill: its later pieces attend int4 K/V (rows
# quantized per slot to 15 levels) where generate's one-shot prefill attends
# the exact rows; on an H100 the two land 4.1-4.8e-2 apart (PERF.md)
STAGED_INT4_TOL = 1e-1


class SamplerTrace:
    """Records the logits every `sample_token_per_row` call receives (the
    pool's prefill calls get [1, V], its decode steps [rows, V]); restores
    the sampler on exit."""

    def __enter__(self):
        from audio_llama_tpu_torch.ops import sampling

        self._mod, self._orig, self.logits = sampling, sampling.sample_token_per_row, []

        def traced_sampler(logits, *a, **k):
            self.logits.append(logits.float().clone())
            return self._orig(logits, *a, **k)

        sampling.sample_token_per_row = traced_sampler
        return self

    def __exit__(self, *exc):
        self._mod.sample_token_per_row = self._orig


def pool_logits(eng, ids, audio):
    """The pool's prefill logits (the last prefill piece's under chunked
    prefill) and its first decode step's (row 0) for one request, replayed
    alone on a reset engine."""
    eng.reset()
    with SamplerTrace() as tr:
        eng.submit(ids, audio_features=audio, max_new_tokens=2)
        eng.run(max_chunks=8)
    pre = [lg for lg in tr.logits if lg.shape[0] == 1]
    step = [lg for lg in tr.logits if lg.shape[0] == eng.rows]
    if not (pre and step):
        raise AssertionError("serve: the replayed request was not admitted and decoded")
    return pre[-1][0], step[0][0]


def http(port, path, body=None, timeout=300.0):
    """-> (status, parsed JSON, or the NDJSON events of a stream)."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = (urllib.request.Request(url, data=json.dumps(body).encode(),
                                  headers={"Content-Type": "application/json"}, method="POST")
           if body is not None else url)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, data = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, data = e.code, e.read().decode()
    if body is not None and body.get("stream") and status == 200:
        return status, [json.loads(line) for line in data.splitlines() if line]
    return status, json.loads(data)


def serve_path(dev, tmp) -> dict:
    """Phase 20: the serving configuration (int4 weights with LoRA merged,
    int4 KV cache) at full width behind the HTTP server: a ServingEngine of
    SERVE_ROWS rows, chunks of SERVE_CHUNK steps, on 127.0.0.1 port 0; one
    /v1/prefix registration (a 30 s WAV and an instruction), then 8
    concurrent /v1/generate requests of N_NEW tokens: four with their own
    seeded 30 s WAVs (one streams), four text suffixes of the prefix (two
    with temperature 0.7, top_p 0.9). Every request answered with its token
    count; launches exact by the counters for the decode chunks and the
    prefills; /healthz and /v1/stats consistent; each audio request's
    prefill logits and first decode step's (replayed on the pool) within
    rel-L2 HOST_TOL of `generate` at B = 1 (megakernel off), greedy tokens
    agreeing with it reported; stop() fails a request in flight (503); the
    same engine with prefill_chunk_tokens = 512 on two audio requests within
    the same bar."""
    import threading

    from audio_llama_tpu_torch.data import audio_io
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.inference.generate import generate, prefill
    from audio_llama_tpu_torch.inference.server import AudioLLMServer, EngineRunner
    from audio_llama_tpu_torch.inference.serving import ServingEngine

    cfg = full_config()
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg)
    rng = np.random.default_rng(20)
    S, sr = cfg.mel.max_samples, cfg.mel.sample_rate
    paths = []
    for i in range(len(SERVE_AUDIO_PROMPTS) + 1):
        p = f"{tmp}/serve_{i}.wav"
        audio_io.write_wav(p, (rng.normal(size=S) * 0.1).astype(np.float32), sr)
        paths.append(p)
    V = cfg.llama.vocab_size
    ids = lambda n: rng.integers(0, V, (n,)).tolist()  # noqa: E731
    audio_ids = [ids(n) for n in SERVE_AUDIO_PROMPTS]
    instr, suffixes = ids(SERVE_INSTRUCTION), [ids(n) for n in SERVE_SUFFIXES]
    blk = cfg.audio_seq_len + 2
    max_len = _rounded_len(blk + SERVE_BUCKETS[0] + SERVE_BUCKETS[0] + N_NEW)
    eng = ServingEngine(
        frozen, trainable, cfg, rows=SERVE_ROWS, max_len=max_len, prefill_buckets=SERVE_BUCKETS,
        chunk_steps=SERVE_CHUNK, kv_quant=4, compute_dtype=torch.bfloat16, greedy=True,
        temperature=0.7, top_p=0.9, eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START,
        audio_end_id=AUDIO_END, seed=0, device=dev)
    waves = [cli.process_audio(p, cfg.mel) for p in paths]  # [1, S] host, as the server reads
    eng.submit(audio_ids[0], audio_features=waves[0][0], max_new_tokens=2)  # warm-up
    eng.run(max_chunks=8)
    eng.reset()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    runner = EngineRunner(eng, poll_interval=0.005)
    srv = AudioLLMServer(runner, cfg, tokenizer=None, port=0, request_timeout=300.0).start()
    results = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        chunks0, rid0 = eng.decode_chunks, eng._next_rid
        t_run = time.perf_counter()
        code, out = http(srv.port, "/v1/prefix", {"prompt_ids": instr,
                                                  "audio_path": paths[-1]})
        if code != 200:
            raise AssertionError(f"serve: /v1/prefix answered {code}: {out}")
        pid = out["prefix_id"]
        bodies = [dict(prompt_ids=a, audio_path=p, max_new_tokens=N_NEW, stream=i == 0)
                  for i, (a, p) in enumerate(zip(audio_ids, paths))]
        bodies += [dict(prompt_ids=sfx, prefix_id=pid, max_new_tokens=N_NEW,
                        **({"greedy": False, "temperature": 0.7, "top_p": 0.9} if i >= 2
                           else {})) for i, sfx in enumerate(suffixes)]

        def send(i):
            t = time.perf_counter()
            results[i] = (*http(srv.port, "/v1/generate", bodies[i]), time.perf_counter() - t)

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall_s = time.perf_counter() - t_run
        launches = read_counters()
        chunks = eng.decode_chunks - chunks0
        chunk_ms = eng.chunk_ms[-chunks:]
        ttft = [v for r, v in sorted(eng.ttft_ms.items()) if r >= rid0]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _, health = http(srv.port, "/healthz")
        _, stats = http(srv.port, "/v1/stats")
        # stop() with a request in flight: it must fail with 503. The engine
        # thread holds after each chunk until stop() is under way, so the
        # request is still decoding when it comes
        inflight = {}

        def held_step(_step=eng.step_chunk):
            _step()
            for _ in range(6000):
                if runner._stop:
                    break
                time.sleep(0.005)

        eng.step_chunk = held_step
        th = threading.Thread(target=lambda: inflight.setdefault(
            "r", http(srv.port, "/v1/generate", dict(prompt_ids=suffixes[0], prefix_id=pid,
                                                      max_new_tokens=2 * N_NEW))))
        th.start()
        for _ in range(6000):
            if runner.health()["live"]:
                break
            time.sleep(0.005)
    finally:
        srv.stop()
        eng.__dict__.pop("step_chunk", None)
    th.join(300)
    code, out = inflight.get("r", (None, None))
    if code != 503 or "shutting down" not in out.get("error", ""):
        raise AssertionError(f"serve: stop() with a request in flight answered {code}: {out}")

    tokens = {}
    for i, body in enumerate(bodies):
        code, out, secs = results.get(i, (None, None, None))
        if code != 200:
            raise AssertionError(f"serve: request {i} answered {code}: {out}")
        if body.get("stream"):
            toks = [t for e in out[:-1] for t in e["tokens"]]
            if not out[-1].get("done") or out[-1]["n_tokens"] != len(toks):
                raise AssertionError(f"serve: stream {i} ended with {out[-1]}")
        else:
            toks = out["tokens"]
        n = len(toks)
        if not (n == N_NEW or (0 < n < N_NEW and toks[-1] == EOS)) or \
                not all(0 <= t < V + 2 for t in toks):
            raise AssertionError(f"serve: request {i} gave {n} tokens {toks}")
        tokens[i] = toks
    n_long, n_short = len(audio_ids) + 1, len(suffixes)
    steps = SERVE_CHUNK * chunks
    want = {"decode_attention_quantized4_mono": L * steps,
            "mlp_int4_stacked": L * steps + L * n_short,
            "int4_matmul_stacked": 2 * L * steps + 4 * L * n_long + 2 * L * n_short,
            "causal_attention": L * n_long, "enc_attention": W * n_long,
            "mel_power": n_long, "layer_norm": 2 * W * n_long, "decode_megakernel": 0,
            "decode_attention_mono": 0}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"serve: {name} launched {launches[name]} times over {chunks} "
                                 f"chunks, want {n}")
    n_tok = sum(len(t) for t in tokens.values())
    if not (health["ok"] and health["live"] == 0 and health["queued"] == 0
            and stats["completed"] == stats["requests"] == len(bodies)
            and stats["tokens"] == n_tok and stats["prefixes"] == 1
            and stats["prefix_admits"] == n_short
            and stats["decode_chunks"] == chunks0 + chunks):
        raise AssertionError(f"serve: /healthz {health} and /v1/stats {stats} disagree with "
                             f"the run ({len(bodies)} requests, {n_tok} tokens, {chunks} chunks)")

    # each audio request's logits on the pool against generate at B = 1
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=4, greedy=True)
    per_request = []
    for i, (a, wave) in enumerate(zip(audio_ids, waves)):
        tid = torch.tensor([a], device=dev)
        tmask = torch.ones_like(tid, dtype=torch.int32)
        twav = torch.from_numpy(wave).to(dev)
        ref_pre = prefill(frozen, trainable, cfg, tid, tmask, twav, dev, max_new_tokens=N_NEW,
                          compute_dtype=torch.bfloat16, kv_quant=4, audio_start_id=AUDIO_START,
                          audio_end_id=AUDIO_END).next_logits[0].float()
        ref_step = first_step_logits(frozen, trainable, cfg, tid, tmask, twav, 4)[0]
        pool_pre, pool_step = pool_logits(eng, np.asarray(a, np.int32), wave[0])
        rel_pre, rel_step = rel_l2(pool_pre, ref_pre), rel_l2(pool_step, ref_step)
        if not (rel_pre <= HOST_TOL and rel_step <= HOST_TOL):
            raise AssertionError(f"serve: audio request {i} logits rel-L2 prefill {rel_pre}, "
                                 f"first step {rel_step} vs generate (bar {HOST_TOL})")
        ref_toks = generate(frozen, trainable, cfg, tid, tmask, twav, None,
                            max_new_tokens=N_NEW, megakernel=False, **kw).tokens[0].tolist()
        agree = sum(x == y for x, y in zip(tokens[i], ref_toks))
        per_request.append(dict(
            request=i, prefill_rel_l2=rel_pre, first_step_rel_l2=rel_step,
            greedy_tokens_equal_generate=f"{agree}/{len(tokens[i])}", greedy_tokens=tokens[i],
            http_seconds=results[i][2]))
    stats_out = dict(
        label="serving pool, int4w+kv4 (LoRA merged), HTTP", rows=SERVE_ROWS,
        chunk_steps=SERVE_CHUNK, max_len=max_len, buckets=list(SERVE_BUCKETS),
        requests=len(bodies), new_tokens=N_NEW, wall_s=wall_s,
        requests_per_s=len(bodies) / wall_s, tokens_per_s=n_tok / wall_s,
        decode_chunks=chunks, ms_per_chunk=float(np.median(chunk_ms)),
        ms_per_chunk_each=chunk_ms, ttft_ms_each=ttft, peak_mem_gb=peak_gb, setup_s=setup_s,
        launches=launches, per_request=per_request, tol_rel_l2=HOST_TOL, health=health,
        stats=stats, card=gpu_line())
    log(json.dumps({"serve_path": stats_out}))
    # chunked prefill (pieces of SERVE_PIECE), two audio requests against
    # generate: on this engine (int4 KV) the later pieces attend the int4
    # K/V of the earlier ones where generate's one-shot prefill attends the
    # exact rows (the JAX pool's semantics too), so it is reported and held
    # to STAGED_INT4_TOL; the piece machinery is held to HOST_TOL on a bf16-KV
    # engine of the same weights, where the pieces read back what one shot
    # attends
    eng.prefill_chunk_tokens = SERVE_PIECE
    eng16 = ServingEngine(
        frozen, trainable, cfg, rows=SERVE_ROWS, max_len=max_len, prefill_buckets=SERVE_BUCKETS,
        chunk_steps=SERVE_CHUNK, kv_quant=False, compute_dtype=torch.bfloat16, greedy=True,
        eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
        prefill_chunk_tokens=SERVE_PIECE, device=dev)
    staged = []
    for kv, engine, bar in ((4, eng, STAGED_INT4_TOL), (False, eng16, HOST_TOL)):
        for i in range(2):
            tid = torch.tensor([audio_ids[i]], device=dev)
            tmask = torch.ones_like(tid, dtype=torch.int32)
            twav = torch.from_numpy(waves[i]).to(dev)
            pool_pre, pool_step = pool_logits(engine, np.asarray(audio_ids[i], np.int32),
                                              waves[i][0])
            ref_pre = prefill(frozen, trainable, cfg, tid, tmask, twav, dev,
                              max_new_tokens=N_NEW, compute_dtype=torch.bfloat16, kv_quant=kv,
                              audio_start_id=AUDIO_START,
                              audio_end_id=AUDIO_END).next_logits[0].float()
            ref_step = first_step_logits(frozen, trainable, cfg, tid, tmask, twav, kv)[0]
            staged.append(dict(kv_cache="int4" if kv else "bf16", request=i,
                               prefill_rel_l2=rel_l2(pool_pre, ref_pre),
                               first_step_rel_l2=rel_l2(pool_step, ref_step), bar=bar))
    eng.prefill_chunk_tokens = None
    del eng16
    log(json.dumps({"serve_staged_prefill": dict(prefill_chunk_tokens=SERVE_PIECE,
                                                 requests=staged)}))
    for st in staged:
        if not (st["prefill_rel_l2"] <= st["bar"] and st["first_step_rel_l2"] <= st["bar"]):
            raise AssertionError(f"serve, prefill_chunk_tokens={SERVE_PIECE}: {st}")
    del eng, frozen, trainable
    torch.cuda.empty_cache()
    return launches


def host_check_pool(dev) -> None:
    """The pool at 2 + 2 layers, card (bf16, kernels) against host (f32, plain
    versions) on the same int4 tree built on the host: two audio requests and
    one text request, 8 greedy tokens each, rows 2, chunks of 4; every
    request's prefill logits within rel-L2 HOST_TOL, tokens compared."""
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.inference.serving import ServingEngine
    from audio_llama_tpu_torch.models import allm, llama

    cfg = cut_config()
    t0 = time.perf_counter()
    gen = make_generator(21, "cpu")
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.bfloat16)
    rng = np.random.default_rng(21)
    for br in trainable["lora"]["layers"].values():
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.02))
    frozen, trainable = cli.quantize_decoder(cfg, frozen, trainable, bits=4)
    reqs = [(rng.integers(0, cfg.llama.vocab_size, (n,)).astype(np.int32),
             None if n == 8 else (rng.normal(size=cfg.mel.max_samples) * 0.1).astype(np.float32))
            for n in (16, 12, 8)]

    def run(fz, tr, cd, d):
        eng = ServingEngine(fz, tr, cfg, rows=2, max_len=_rounded_len(cfg.audio_seq_len + 80),
                            prefill_buckets=(16, 32), chunk_steps=4, kv_quant=4,
                            compute_dtype=cd, greedy=True, eos_id=-1, audio_start_id=AUDIO_START,
                            audio_end_id=AUDIO_END, device=d)
        with SamplerTrace() as tr_:
            rids = [eng.submit(i, audio_features=a, max_new_tokens=8) for i, a in reqs]
            out = eng.run(max_chunks=20)
        firsts = [lg[0].cpu() for lg in tr_.logits if lg.shape[0] == 1]  # the prefills'
        return [out[r] for r in rids], firsts, eng

    def step_logits(eng, ids, audio, step):
        """The logits that chose token `step` of a request replayed alone
        (row 0 of a reset engine): its prefill's for step 0, else decode
        step `step`'s."""
        eng.reset()
        with SamplerTrace() as tr_:
            eng.submit(ids, audio_features=audio, max_new_tokens=step + 1)
            eng.run(max_chunks=20)
        pre = [lg[0] for lg in tr_.logits if lg.shape[0] == 1]
        steps = [lg[0] for lg in tr_.logits if lg.shape[0] == eng.rows]
        return (pre[-1:] + steps)[step].cpu()

    def margin(lg):
        top = lg.topk(2).values
        return (top[0] - top[1]).item()

    host_toks, host_first, host_eng = run(frozen.float(), trainable.float(), torch.float32,
                                          torch.device("cpu"))
    card_toks, card_first, card_eng = run(copy.deepcopy(frozen).to(dev),
                                          copy.deepcopy(trainable).to(dev), torch.bfloat16, dev)
    prefills = [compare_logits(f"pool card vs host, request {i}", c, h)
                for i, (c, h) in enumerate(zip(card_first, host_first))]
    # where the greedy tokens part: the top-2 logit margin of each side at the
    # first step that differs, beside the card-host logit gap there; a margin
    # inside that gap is a near-tie that bf16 rounding decides
    splits = []
    for i, (c, h) in enumerate(zip(card_toks, host_toks)):
        k = next((j for j, (a, b) in enumerate(zip(c, h)) if a != b), None)
        if k is not None:
            lc = step_logits(card_eng, reqs[i][0], reqs[i][1], k)
            lh = step_logits(host_eng, reqs[i][0], reqs[i][1], k)
            gap = (lc - lh).abs().max().item()
            splits.append({"request": i, "step": k, "card_token": c[k],
                           "host_token": h[k], "host_top2_margin": margin(lh),
                           "card_top2_margin": margin(lc), "card_host_max_abs": gap,
                           "replay_tokens": [int(lc.argmax()), int(lh.argmax())],
                           "near_tie": margin(lh) <= gap})
    stats = {"path": "serving pool int4w+kv4", "layers": "2 whisper + 2 llama, full width",
             "prefill": prefills, "tokens_equal": [c == h for c, h in zip(card_toks, host_toks)],
             "first_split": splits, "tol_rel_l2": HOST_TOL, "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check_pool": stats}))


# gradients: the q and k LoRA leaves reach the loss through attention's
# dS = P (dP - D), a difference of two sums of bf16 products that nearly
# cancel, which doubles their relative error (2.2e-2 on an H100 80GB HBM3 at
# 700 W, PERF.md PR 4; the other leaves 0.7-1.0e-2)
HOST_GRAD_TOL = 3e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of the bf16, int4, B = 1 per-layer "
                         "and int8 paths and of one train step")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import audio_llama_tpu_torch  # noqa: F401  (fails outside the repo)
    from audio_llama_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions and host checks
    torch.backends.cudnn.allow_tf32 = False
    # phase 18 (a) first: its times are the wgmma / TMA kernels' CUPTI rows
    rows = causal_variant_checks(dev, torch.Generator(device=dev).manual_seed(18))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows += kernel_checks(dev, gen)
    rows += int4_kernel_checks(dev, gen)
    rows.append(megakernel_checks(dev, gen))
    rows.append(q8_kernel_checks(dev, gen))
    torch.cuda.empty_cache()
    rows += db_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    rows += ab_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    rows += train_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    rows += ring_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    rows += enc_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    rows += ksplit_kernel_checks(dev, gen)
    torch.cuda.empty_cache()
    single_rows, single_launches = single_decode_checks(dev, gen)
    rows += single_rows
    torch.cuda.empty_cache()
    int4_2d_rows, int4_2d_launches, int4_2d_g32 = int4_2d_checks(dev, gen)
    rows += int4_2d_rows
    torch.cuda.empty_cache()
    group_kernel_checks(dev, gen, rows)
    torch.cuda.empty_cache()
    paths = enc8_path(dev)
    paths["single_decode"], paths["int4_2d"] = single_launches, int4_2d_launches
    paths["int4_2d_g32"] = int4_2d_g32
    paths["causal_variants"] = causal_variant_path(dev, gen)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    paths["bf16"], ab = main_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    paths["int4"], model, request = int4_path(dev, profile=args.profile)
    cli_path(dev, model)
    paths["int4_ksplit"] = ksplit_path(dev, model, request)
    del model, request
    torch.cuda.empty_cache()
    paths["b1"], ab = b1_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    paths["int8"], ab = int8_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    smooth_paths, ctx = smooth_path(dev)
    paths.update(smooth_paths)
    with tempfile.TemporaryDirectory() as tmp:
        paths["eval"] = eval_path(dev, ctx, tmp)
    del ctx
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        paths["serve"] = serve_path(dev, tmp)
    torch.cuda.empty_cache()
    host_check(dev)
    L = cut_config().llama.num_layers
    host_check_quant(dev, "int4w+kv4, B=1 (megakernel)", seed=4,
                     want={"decode_megakernel": 1, "mlp_int4_stacked": 0})
    host_check_quant(dev, "int4w+kv4 rotated, B=1 (megakernel)", rotate=True, seed=5,
                     want={"decode_megakernel": 1, "mlp_int4_stacked": 0})
    host_check_quant(dev, "int8w+kv8, B=1", bits=8, kv_quant=True, seed=6,
                     want={"decode_attention_quantized_mono": L})
    host_check_quant(dev, "int4w+kv4 smoothed, B=1", seed=8,
                     want={"mlp_int4_stacked[dn_r]": L, "mlp_int4_stacked": 0,
                           "decode_megakernel": 0},
                     quantize=host_smooth_tree)
    host_check_quant(dev, "int4w+kv4 GPTQ, B=1 (megakernel)", seed=9,
                     want={"decode_megakernel": 1, "mlp_int4_stacked": 0,
                           "mlp_int4_stacked[dn_r]": 0},
                     quantize=lambda *a: host_gptq_tree(*a, dev=dev))
    # group 32: the megakernel's gate refuses it, so the step runs the per-layer kernels
    group_want = {"decode_megakernel": 0, "mlp_int4_stacked": L, "int4_matmul_stacked": 2 * L}
    host_check_quant(dev, f"int4w+kv4 clipped, group {SMOOTH_GROUP}, B=1", seed=11,
                     want=group_want,
                     quantize=lambda *a: host_clip_tree(*a, group=SMOOTH_GROUP))
    host_check_quant(dev, f"int4w+kv4 GPTQ, group {SMOOTH_GROUP}, B=1", seed=12,
                     want=group_want,
                     quantize=lambda *a: host_gptq_tree(*a, dev=dev, group=SMOOTH_GROUP))
    host_check_smooth_outliers(dev)
    host_check_enc8(dev)
    host_check_pool(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        paths["train"] = train_path(dev, tmp, profile=args.profile)
        torch.cuda.empty_cache()
        paths.update(sharded_train_path(dev, tmp))
    torch.cuda.empty_cache()
    paths.update(multi_path(dev))
    for row in rows:  # each kernel's count on the path that exercises it
        counted = paths[KERNEL_PATH.get(row["name"], "int4")]
        row["launches"] = sum(counted[n] for n in ROW_COUNTERS.get(row["name"], (row["name"],)))
        row["timed_by"] = {k: row[k].by for k in ("ms", "plain_ms", "library_ms")
                           if isinstance(row.get(k), Ms)}
        for entry in row.get("by_group", {}).values():  # group 32's count on its path
            if entry["group"] == SMOOTH_GROUP:
                entry["launches"] = paths[GROUP_PATH[row["name"]]][row["name"]]
                if not entry["launches"]:
                    raise AssertionError(f"{row['name']}: no launch at group {SMOOTH_GROUP} "
                                         f"on {GROUP_PATH[row['name']]}")
            else:
                entry["launches"] = None  # no path quantizes at this group
    torch.cuda.empty_cache()
    host_check_train(dev)

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
