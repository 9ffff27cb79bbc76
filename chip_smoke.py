#!/usr/bin/env python3
"""Drive the PyTorch port (audio_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # the same, plus a torch.profiler breakdown

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA present, the card's name and power limit, kernel build;
  2. kernels: each hand-written kernel at its main-path shapes against its
     plain PyTorch version on the same inputs (bf16, stated tolerance),
     then each attention kernel on inputs with a planted one-key mask fault,
     which the same check must reject; timed by device time (CUPTI) beside
     the plain version, one library call as a yardstick (never used by the
     port) and the least time the card could take (bound);
  3. main path: `inference.generate.generate` at the full published widths
     (Llama-3.2-3B decoder, Whisper-large-v3-turbo encoder, LoRA rank 64)
     with seeded random weights: a 30 s log-mel clip and a 24-token prompt,
     32 greedy tokens, then one sampled run; the kernels' launch counters
     are zeroed before the greedy run and read after it;
  4. card vs host: the same path cut to 2 Whisper and 2 Llama layers at full
     width, last-position prefill logits on the card (bf16, kernels) against
     the CPU plain path (f32) on the same weights.
With `--profile`, phase 3 adds a torch.profiler breakdown of the main path
(encode + prefill + first token, and per decode token) by device kernel
group, with the device's busy share and launches.

Output: progress lines, then `{"kernels": [...]}`, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
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


def traced(fn):
    """Run fn under torch.profiler -> (wall ms, {device kernel name: ms},
    device launches). Device durations come from CUPTI."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    if not by_name:
        raise AssertionError("profiler: the trace holds no device events")
    return wall_ms, by_name, n


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call after warm-up: the summed durations of the
    kernels it launched, over `iters` calls. Host launch gaps are left out:
    a ~40 us kernel behind a Python wrapper would otherwise be timed at the
    host's pace."""
    for _ in range(warmup):
        fn()

    def many():
        for _ in range(iters):
            fn()

    _, by_name, _ = traced(many)
    return sum(by_name.values()) / iters


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
}


def tol_ratio(got, want, frac: float) -> float:
    """max |got - want| / (atol + BF16_ULP |want|), atol = frac * the RMS of
    want's row; the check passes at <= 1."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bar = frac * want.pow(2).mean(dim=-1, keepdim=True).sqrt() + BF16_ULP * want.abs()
    return torch.where(err == 0, 0.0, err / bar).max().item()


def check_close(name, got, want, frac):
    """-> (max_abs_err, tol_ratio); raises outside the tolerance."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    ratio = tol_ratio(got, want, frac)
    if ratio > 1:
        raise AssertionError(f"{name}: outside tolerance (ratio {ratio:.3f}); "
                             f"max_abs_err={err:.3e}")
    return err, ratio


def must_reject(name, fault, got, want, frac) -> float:
    """The kernel run on a planted fault must fail the check it passed."""
    ratio = tol_ratio(got, want, frac)
    if not ratio > 1:
        raise AssertionError(f"{name}: the check passes the planted fault '{fault}' "
                             f"(ratio {ratio:.3f}); the tolerance is too loose")
    return ratio


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


def kernel_modules():
    from audio_llama_tpu_torch.ops import causal_attention, decode_attention_mono
    from audio_llama_tpu_torch.ops import enc_attention, layer_norm

    return {
        "layer_norm": layer_norm,
        "enc_attention": enc_attention,
        "causal_attention": causal_attention,
        "decode_attention_mono": decode_attention_mono,
    }


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

AUDIO_START, AUDIO_END, EOS = 128256, 128257, 128001  # resized vocab rows; Llama-3 <|end_of_text|>
N_NEW, PROMPT = 32, 24


def main_path(dev, profile: bool = False):
    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm, llama

    cfg = AudioLLMConfig()  # Llama-3.2-3B + Whisper-large-v3-turbo, LoRA r64
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

    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    result = {}
    total_ms = synced_ms(lambda: result.setdefault("greedy", run(N_NEW)))
    launches = {name: m.launches for name, m in mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    greedy = result["greedy"]
    V = cfg.llama.vocab_size + 2
    toks = greedy.tokens
    if toks.shape != (1, N_NEW) or not bool(((toks >= 0) & (toks < V)).all()):
        raise AssertionError(f"main: bad greedy tokens {toks.tolist()}")
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
    if sampled.shape != (1, N_NEW) or not bool(((sampled >= 0) & (sampled < V)).all()):
        raise AssertionError(f"main: bad sampled tokens {sampled.tolist()}")

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
        "sampled_tokens": sampled[0].tolist(),
    }
    log(json.dumps({"main_path": stats}))
    if profile:
        n = 9
        prefill = device_profile(lambda: run(1))
        whole = device_profile(lambda: run(n))
        decode = {k: (whole["by_group_ms"].get(k, 0.0) - v) / (n - 1)
                  for k, v in prefill["by_group_ms"].items()}
        for k, v in whole["by_group_ms"].items():
            decode.setdefault(k, v / (n - 1))
        log(json.dumps({"profile": {
            "encode_prefill_first_token": prefill,
            "decode_per_token_by_group_ms": decode,
            "decode_per_token_wall_ms": (whole["wall_ms"] - prefill["wall_ms"]) / (n - 1),
            "decode_per_token_device_ms":
                (whole["device_ms"] - prefill["device_ms"]) / (n - 1),
            "decode_per_token_device_launches":
                (whole["device_launches"] - prefill["device_launches"]) / (n - 1),
        }}))
    return launches


KERNEL_GROUPS = (  # substring of the device kernel's name -> group
    ("attn_fwd_kernel<64, false>", "enc_attention kernel"),
    ("attn_fwd_kernel<128, true>", "causal_attention kernel"),
    ("decode_kernel", "decode_attention kernel"),
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
# phase 4: card (bf16, kernels) vs host (f32, plain) at 2 + 2 layers
# ---------------------------------------------------------------------------

def host_check(dev):
    import copy
    import dataclasses

    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference.generate import build_prefix
    from audio_llama_tpu_torch.models import allm, llama, lora

    full = AudioLLMConfig()
    cfg = dataclasses.replace(
        full, llama=dataclasses.replace(full.llama, num_layers=2),
        whisper=dataclasses.replace(full.whisper, num_layers=2))
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
    rel = ((card - host).norm() / host.norm()).item()
    max_abs = (card - host).abs().max().item()
    top_agree = int(card.argmax()) == int(host.argmax())
    stats = {"layers": "2 whisper + 2 llama, full width", "rel_l2": rel, "max_abs": max_abs,
             "host_logit_absmax": host.abs().max().item(), "argmax_agree": top_agree,
             "tol_rel_l2": HOST_TOL, "seconds": time.perf_counter() - t0}
    log(json.dumps({"host_check": stats}))
    if not (torch.isfinite(card).all() and rel <= HOST_TOL):
        raise AssertionError(f"host check: card vs host logits rel_l2={rel:.3e} > {HOST_TOL}")


# bf16 activations through 2 + 2 layers against an f32 host path: each bf16
# rounding is <= 2^-9 relative, a few dozen of them compound to ~1e-2
HOST_TOL = 2e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the main path")
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = kernel_checks(dev, gen)
    launches = main_path(dev, profile=args.profile)
    for row in rows:
        row["launches"] = launches[row["name"]]
    host_check(dev)

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
