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
     launched one by one, bit for bit); timed by device time (CUPTI) beside
     the plain version, one library call as a yardstick where one exists
     (never used by the port) and the least time the card could take
     (bound); the megakernel also with its grid barriers alone;
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
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


PROFILE_TRIES = 3  # CUPTI has come back with no device events now and then


def traced(fn):
    """Run fn under torch.profiler -> (wall ms, {device kernel name: ms},
    device launches). Device durations come from CUPTI. A trace that holds
    no device event is taken again (logged), up to PROFILE_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, n = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
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
        _, by_name, _ = traced(many)
    except AssertionError:  # CUPTI gave no device events, PROFILE_TRIES times
        log("time_ms: no device events; this time is by CUDA events instead")
        return Ms(events_ms(fn, iters=iters, warmup=0), "cuda events (CUPTI gave no events)")
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
        plain_ms=time_ms(lambda: ln.layer_norm_plain(x, s, b)),
        library_ms=time_ms(lambda: F.layer_norm(x, (D,), s, b, 1e-5), iters=100),
        launches=None, bound_ms=bms, bound_by=bby, shapes=f"x[{N},{D}] bf16",
    ))
    log(f"kernel layer_norm ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f}")

    # 2. encoder attention: [1, 1536, 20, 64] bf16 views of [1, 1536, 1280],
    #    1500 valid keys, q pre-scaled
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
    flops = 4.0 * B * H * T * valid * hd
    nbytes = 2.0 * 4 * B * T * H * hd
    bms, bby = bound(flops, nbytes)
    key_ok = torch.zeros(T, T, dtype=torch.bool, device=dev)
    key_ok[:, :valid] = True
    qh, kh, vh = (t.transpose(1, 2) for t in (qs, k, v))
    rows.append(dict(
        name="enc_attention", route="cuda", source="audio_llama_tpu_torch/csrc/enc_attention.cu",
        replaces="audio_llama_tpu/ops/enc_attention.py:102", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: ea.enc_attention_cuda(qs, k, v, valid)),
        plain_ms=time_ms(lambda: ea.enc_attention_plain(qs, k, v, valid)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=key_ok, scale=1.0)),
        launches=None, bound_ms=bms, bound_by=bby, shapes=f"q/k/v[{B},{T},{H},{hd}] bf16, valid {valid}",
    ))
    log(f"kernel enc_attention ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")

    # 3. causal prefill attention: T = 1526 real tokens padded to 1536,
    #    Hq 24 / Hkv 8, hd 128, q pre-scaled, last 10 keys padded
    B, T, Hq, Hkv, hd = 1, 1536, 24, 8, 128
    qs = randn(B, T, Hq, hd) * torch.tensor(hd ** -0.5, dtype=bf, device=dev)
    k, v = randn(B, T, Hkv, hd), randn(B, T, Hkv, hd)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[:, 1526:] = 0
    zero = torch.zeros((), device=dev)
    key_bias = torch.where(mask != 0, zero, ca.NEG)
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
    causal_ok = torch.ones(T, T, dtype=torch.bool, device=dev).tril() & (mask[0] != 0)[None, :]
    kr, vr = (t.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for t in (k, v))
    qh = qs.transpose(1, 2)
    rows.append(dict(
        name="causal_attention", route="cuda",
        source="audio_llama_tpu_torch/csrc/causal_attention.cu",
        replaces="audio_llama_tpu/ops/causal_attention.py:101", max_abs_err=err,
        tol=tol_entry(frac), tol_ratio=ratio, planted_fault_ratios=faults,
        ms=time_ms(lambda: ca.causal_attention_cuda(qs, k, v, key_bias)),
        plain_ms=time_ms(lambda: ca.causal_attention_plain(qs, k, v, key_bias)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kr, vr, attn_mask=causal_ok, scale=1.0)),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"q[{B},{T},{Hq},{hd}] k/v[{B},{T},{Hkv},{hd}] bf16, 1526 real",
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
        plain_ms=time_ms(lambda: dm.decode_attention_plain(
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
        plain_ms=time_ms(lambda: mp.mel_power_plain(padded, mc, Fr)),
        library_ms=time_ms(library), launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"waveform[{B},{mc.max_samples}] f32 -> [{B},{Fr},{n_mels}]",
    ))
    log(f"kernel mel_power ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")
    del wav, padded, got, want

    # 6. W4A16 matmul: decode q|k|v (pair, planes) and o (obin) at M = B,
    #    prefill gate|up (pair, planes) and down (obin) at M = B * prefix
    L, D, Fd = lc.num_layers, lc.hidden_size, lc.intermediate_size
    Nqkv = (lc.num_heads + 2 * lc.num_kv_heads) * lc.head_dim
    cases = [  # (label, M, K, N, fmt, planes)
        ("decode q|k|v", B, D, Nqkv, "pair", True),
        ("decode o", B, lc.num_heads * lc.head_dim, D, "obin", False),
        ("prefill gate|up", B * prefix, D, 2 * Fd, "pair", True),
        ("prefill down", B * prefix, Fd, D, "obin", False),
    ]
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
        err, ratio = check_close(f"int4_matmul_stacked {label}", run(), want, frac)
        worst = max(worst, (ratio, err))
        if label == "decode q|k|v":
            faults["group g read with group g+1's scale"] = must_reject(
                "int4_matmul_stacked", "group g+1's scale",
                run(s=torch.roll(scales, -1, dims=1).contiguous()), want, frac)
        if fmt == "obin":
            faults[f"{label}: obin bytes decoded as pair"] = must_reject(
                "int4_matmul_stacked", "obin decoded as pair", run(f="pair"), want, frac)
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
            plain_ms=time_ms(plain, iters=10 if M <= 64 else 3),
            library_ms=time_ms(lambda: x @ w_deq, iters=56 if M <= 64 else 10),
            bound_ms=bms, bound_by=bby)
        by_shape.append(shape_row)
        log(f"kernel int4_matmul_stacked {label} ok: {json.dumps(shape_row)}")
        del packed, scales, x, want, w_deq
    first = by_shape[0]
    rows.append(dict(
        name="int4_matmul_stacked", route="cuda",
        source="audio_llama_tpu_torch/csrc/int4_matmul.cu",
        replaces="audio_llama_tpu/ops/int4_matmul.py:370", max_abs_err=worst[1],
        tol=tol_entry(frac), tol_ratio=worst[0], planted_fault_ratios=faults,
        ms=first["ms"], plain_ms=first["plain_ms"], library_ms=first["library_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"], launches=None,
        shapes="the row's times are the decode q|k|v call; by_shape has every shape",
        by_shape=by_shape,
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
    faults = {"last F-chunk dropped": must_reject(
        "mlp_int4_stacked", "last F-chunk dropped",
        mlp4.mlp_int4_stacked_cuda(x, gup, dropped, dn, dns, li, chunk=chunk), want, frac)}
    wg = i4.dequantize_ref(gup[li], gus[li]).to(bf)
    wd = i4.dequantize_ref(dn[li], dns[li]).to(bf)
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
        plain_ms=time_ms(lambda: mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, li,
                                                             chunk=chunk), iters=5),
        library_ms=time_ms(lambda: (F.silu(x @ wg[:, :Fd]) * (x @ wg[:, Fd:])) @ wd, iters=56),
        # the same kernel at the TPU kernel's chunk (16 blocks at F = 8192)
        ms_at_tpu_chunk=time_ms(lambda: mlp4.mlp_int4_stacked_cuda(
            x, gup, gus, dn, dns, next(turn) % L, chunk=mlp4.pick_chunk(Fd)), iters=56),
        launches=None, bound_ms=bms, bound_by=bby,
        shapes=f"x[{B},{D}] bf16, gate|up [{L},{D},{Fd}], down [{L},{Fd},{dh}] int8, "
               f"chunk {chunk}",
    ))
    log(f"kernel mlp_int4_stacked ok: max_abs_err={err:.3e} tol_ratio={ratio:.3f} "
        f"planted faults rejected: {faults}")
    del gup, gus, dn, dns, wg, wd, dropped

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
        plain_ms=time_ms(lambda: dm.decode_attention_q4_plain(
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
        ms=time_ms(run, iters=10), plain_ms=time_ms(lambda: mk.decode_megakernel_plain(**case),
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
        plain_ms=time_ms(lambda: dm.decode_attention_q8_plain(
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
}
# a row whose kernel serves several counters (its cache formats) sums them
ROW_COUNTERS = {"decode_attention_packed": ("decode_attention_packed",
                                            "decode_attention_quantized_packed")}

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


def main_path(dev, profile: bool = False):
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


def int4_path(dev, profile: bool = False):
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm

    cfg = full_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg)
    torch.cuda.synchronize()
    log(f"int4: LoRA merged and the decoder quantized on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    B = len(INT4_PROMPTS)
    wav = torch.randn((B, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (B, max(INT4_PROMPTS)), generator=gen,
                        device=dev)
    mask = torch.zeros_like(ids)
    for b, n in enumerate(INT4_PROMPTS):
        mask[b, :n] = 1
    ids = ids * mask  # right-padded with pad id 0
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=4)

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
    return launches, (cfg, frozen, trainable)


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
    step at a time -> the f32 logits of every step."""
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import llama

    dev = ids.device
    embeds, m = build_prefix(frozen, trainable, cfg, ids, mask, wav, AUDIO_START, AUDIO_END,
                             torch.bfloat16)
    P, n = embeds.shape[1], tokens.shape[1]
    full_mask = torch.cat([m, torch.ones((1, n), dtype=m.dtype, device=dev)], dim=1)
    cache = llama.KVCache.zeros(cfg.llama, 1, P + n, device=dev, quantized=kv_quant)
    _, cache = llama.llama_forward(frozen["llama"], cfg.llama, inputs_embeds=embeds,
                                   attention_mask=full_mask, kv_cache=cache,
                                   assume_fresh_cache=True, unembed_logits=False)
    trail = []
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
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm

    cfg = full_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    t0 = time.perf_counter()
    frozen, trainable = int4_model(gen, cfg, rotate=True)
    torch.cuda.synchronize()
    log(f"b1: LoRA merged, the decoder rotated and quantized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    wav = torch.randn((1, cfg.mel.max_samples), generator=gen, device=dev) * 0.1
    ids = torch.randint(0, cfg.llama.vocab_size, (1, PROMPT), generator=gen, device=dev)
    mask = torch.ones_like(ids)
    kw = dict(eos_id=EOS, pad_id=0, audio_start_id=AUDIO_START, audio_end_id=AUDIO_END,
              compute_dtype=torch.bfloat16, device=dev, kv_quant=4)

    def run(n, greedy=True, g=None, megakernel=True):
        return generate(frozen, trainable, cfg, ids, mask, wav, g, max_new_tokens=n,
                        greedy=greedy, temperature=0.7, top_p=0.9, megakernel=megakernel, **kw)

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


KERNEL_GROUPS = (  # substring of the device kernel's name -> group, first match wins
    ("mel_power_kernel", "mel_power kernel"),
    ("w4_decode_kernel", "int4_matmul kernel"), ("w4_prefill_kernel", "int4_matmul kernel"),
    ("mlp4_kernel", "mlp_int4 kernel"),
    ("megakernel", "decode_megakernel"),
    ("decode_quant_kernel<__nv_bfloat16, 3, true>", "decode_attention_q8 kernel"),
    ("decode_quant_kernel", "decode_attention_q4 kernel"),
    ("attn_fwd_kernel<64, false>", "enc_attention kernel"),
    ("attn_fwd_kernel<128, true>", "causal_attention kernel"),
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


def compare_logits(label, card, host) -> dict:
    rel = ((card - host).norm() / host.norm()).item()
    stats = {"rel_l2": rel, "max_abs": (card - host).abs().max().item(),
             "host_logit_absmax": host.abs().max().item(),
             "argmax_agree": int(card.argmax()) == int(host.argmax())}
    if not (torch.isfinite(card).all() and rel <= HOST_TOL and stats["argmax_agree"]):
        raise AssertionError(f"{label}: card vs host logits {stats} (bar rel_l2 {HOST_TOL}, "
                             "argmax equal)")
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


def host_check_quant(dev, label, bits=4, rotate=False, kv_quant=4, seed=4, want=None):
    """A quantized path at 2 + 2 layers: waveform in, LoRA merged, the
    decoder rotated (with `rotate`) and quantized once on the host, the same
    tree on both sides; the last position's prefill logits, then one decode
    step's on the quantized KV cache (the host's next token fed to both).
    `want`: {kernel: launches} of the card's decode step."""
    import copy

    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import allm, llama

    cfg = cut_config()
    t0 = time.perf_counter()
    gen = make_generator(seed, "cpu")
    frozen = allm.init_frozen(cfg, gen, torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, gen, torch.bfloat16)
    rng = np.random.default_rng(seed)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.02))
    frozen, trainable = cli.quantize_decoder(cfg, frozen, trainable, bits=bits, rotate=rotate)
    wav = torch.from_numpy((rng.normal(size=(1, cfg.mel.max_samples)) * 0.1).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.llama.vocab_size, (1, PROMPT)))
    mask = torch.ones_like(ids, dtype=torch.int32)

    def logits(fz, tr, cd, d, token=None):
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

    host_first, host_step, tok = logits(frozen.float(), trainable.float(), torch.float32,
                                        torch.device("cpu"))
    card_first, card_step, _ = logits(copy.deepcopy(frozen).to(dev),
                                      copy.deepcopy(trainable).to(dev), torch.bfloat16, dev,
                                      token=tok)
    launches = read_counters()
    for name, n in (want or {}).items():
        if launches[name] != n:
            raise AssertionError(f"{label}: the card's decode step launched {name} "
                                 f"{launches[name]} times, want {n}")
    stats = {"path": label, "layers": "2 whisper + 2 llama, full width",
             "prefill": compare_logits(f"{label}, prefill", card_first, host_first),
             "decode_step": compare_logits(f"{label}, decode step", card_step, host_step),
             "decode_step_launches": {k: launches[k] for k in (want or {})},
             "tol_rel_l2": HOST_TOL, "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check_quant": stats}))


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


def train_kernel_checks(dev, gen):
    """The dq and dk/dv kernels at the training geometry (B 2, T 2048 = 2014
    real + 34 pad keys, Hq 24, Hkv 8, hd 128, bf16; row 1's tail padded from
    1800) against the plain backward on the forward kernel's residuals;
    planted faults: D not computed (0), the causal mask dropped on one
    diagonal tile, queries mapped to the wrong KV head (h % Hkv for h // G).
    Two launches give the same bits. Timed beside the plain backward and
    the backward of `F.scaled_dot_product_attention` (causal, GQA)."""
    import torch.nn.functional as F

    from audio_llama_tpu_torch.ops import causal_attention as ca

    lc = full_config().llama
    B, T, Hq, Hkv, hd = TRAIN_B, TRAIN_T, lc.num_heads, lc.num_kv_heads, lc.head_dim
    G = Hq // Hkv
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
    d = ca.attention_bwd_prologue(o, do)
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
    # bounds: each hd-deep product over the causal half, per head
    per_product = 2.0 * hd * T * (T + 1) / 2 * B * Hq
    in_bytes = 2.0 * B * T * hd * (2 * Hq + 2 * Hkv) + 4.0 * B * T * (3 * Hq + 1)
    bq = bound(3 * per_product, in_bytes + 2.0 * B * T * Hq * hd)
    bkv = bound(4 * per_product, in_bytes + 2.0 * 2 * B * T * Hkv * hd)
    # timed by CUDA events: every call here lasts 0.3 ms or more, so the host's
    # launch gaps do not count, and the CUPTI sums of `time_ms` have read
    # these kernels low after earlier phases (PERF.md, PR 4); `ms_cupti`
    # keeps that reading beside them
    plain_ms = events_ms(lambda: ca.causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do),
                         iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qs, k, v))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0,
                                          enable_gqa=True)
    doh = do.transpose(1, 2)
    library_ms = events_ms(lambda: torch.autograd.grad(sdpa, (qh, kh, vh), doh,
                                                       retain_graph=True))
    shapes = (f"qs/dO[{B},{T},{Hq},{hd}] k/v[{B},{T},{Hkv},{hd}] bf16, l/m/D [{B * Hq},{T}] "
              f"f32, keys >= {TRAIN_REAL} (row 1: >= 1800) padded")
    rows = []
    for name, run, (bms, bby), err_names in (
            ("causal_attention_dq", dq_run, bq, ("causal_attention_dq",)),
            ("causal_attention_dkv", dkv_run, bkv, ("causal_attention_dk", "causal_attention_dv"))):
        frac = ATOL_ROW_RMS_FRAC[name]
        rows.append(dict(
            name=name, route="cuda", source="audio_llama_tpu_torch/csrc/causal_attention_bwd.cu",
            replaces="audio_llama_tpu/ops/causal_attention.py:" + ("471" if name.endswith("dq")
                                                                   else "514"),
            max_abs_err=max(results[n][0] for n in err_names),
            tol={**tol_entry(frac), "rms_over": "each (batch, head)'s [T, hd] slab"},
            tol_ratio=max(results[n][1] for n in err_names),
            planted_fault_ratios={f: r["dq" if name.endswith("dq") else "dk"]
                                  for f, r in faults.items()},
            ms=events_ms(run), ms_cupti=time_ms(run), plain_ms=plain_ms, library_ms=library_ms,
            launches=None, bound_ms=bms, bound_by=bby, shapes=shapes,
            notes="times by CUDA events; plain_ms: the whole plain backward (dq, dk and dv); "
                  "library_ms: the backward of SDPA(is_causal, enable_gqa), dq, dk and dv in "
                  "one call",
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
    bounds = {RING_NAMES[0]: bound(2 * per_product, in_bytes + 2.0 * B * T * Hq * hd + 2 * stats),
              RING_NAMES[1]: bound(3 * per_product, in_bytes + 2.0 * B * T * Hq * hd + 3 * stats
                                   + 2.0 * B * T * Hq * hd),
              RING_NAMES[2]: bound(4 * per_product, in_bytes + 2.0 * B * T * Hq * hd + 3 * stats
                                   + 2.0 * 2 * B * T * Hkv * hd)}
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
        plain_ms = time_ms(lambda: kernel(fns[1]), iters=10)
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
                plain_ms=time_ms(lambda: kernel(False), iters=8),
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


# bf16 activations through 2 + 2 layers against an f32 host path: each bf16
# rounding is <= 2^-9 relative, a few dozen of them compound to ~1e-2
HOST_TOL = 2e-2
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = kernel_checks(dev, gen)
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
    paths = {}
    paths["bf16"], ab = main_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    paths["int4"], model = int4_path(dev, profile=args.profile)
    cli_path(dev, model)
    del model
    torch.cuda.empty_cache()
    paths["b1"], ab = b1_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    paths["int8"], ab = int8_path(dev, profile=args.profile)
    paths.update(ab)
    torch.cuda.empty_cache()
    host_check(dev)
    L = cut_config().llama.num_layers
    host_check_quant(dev, "int4w+kv4, B=1 (megakernel)", seed=4,
                     want={"decode_megakernel": 1, "mlp_int4_stacked": 0})
    host_check_quant(dev, "int4w+kv4 rotated, B=1 (megakernel)", rotate=True, seed=5,
                     want={"decode_megakernel": 1, "mlp_int4_stacked": 0})
    host_check_quant(dev, "int8w+kv8, B=1", bits=8, kv_quant=True, seed=6,
                     want={"decode_attention_quantized_mono": L})
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
