"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here carries the `cuda` marker and skips on a host
without a CUDA device; the skip is decided inside a fixture, so every pytest
worker collects the same tests.

This file imports torch only: the card's machine has no JAX. Run it there
with `python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q`
(the repo's conftest imports JAX).

Tolerances: bf16 outputs (and the f32 mel power) within chip_smoke's
per-kernel bar, one bf16 ulp relative plus a fraction of the output row's
RMS (`chip_smoke.ATOL_ROW_RMS_FRAC`), which a one-element fault exceeds (the
planted-fault tests below); f32 attention within 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from chip_smoke import (ATOL_ROW_RMS_FRAC, BWD_FAULTS, GRAD_RMS_DIMS,  # noqa: E402
                        bwd_fault_reference, decode_faults, mlp_faults, prefill_faults,
                        tol_ratio, variant_reference)
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402
from audio_llama_tpu_torch.ops import enc_attention as ea  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from audio_llama_tpu_torch.ops import layer_norm as ln  # noqa: E402
from audio_llama_tpu_torch.ops import mel_power as mp  # noqa: E402
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _close(got, want, dtype, kernel):
    if dtype == torch.bfloat16:
        assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC[kernel]) <= 1
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(1536, 1280), (7, 64), (300, 384)])
def test_layer_norm_kernel(dev, dtype, rows, d):
    x = _randn(dev, rows, d, dtype=dtype) * 2 + 0.5
    s = _randn(dev, d, dtype=dtype, seed=1) * 0.1 + 1
    b = _randn(dev, d, dtype=dtype, seed=2) * 0.1
    before = ln.launches
    got = ln.layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert ln.launches == before + 1
    _close(got, ln.layer_norm_plain(x, s, b), dtype, "layer_norm")


# the wgmma encoder kernel's edges (`ea.key_tile`: 128 keys a tile, 64 at hd
# 128): one valid key, the last key of a tile, a whole tile, one key past it
# and every key; T 200 and 1000 (off the 128-query and key grids); B 1-3
ENC_EDGES = [(1 + i % 3, (200, 1000)[(i + j) % 2], 3, hd, valid)
             for j, hd in enumerate((16, 32, 64, 128))
             for i, valid in enumerate((1, 127, 128, 129, None))]


@pytest.mark.parametrize("B,T,H,hd,valid", [(2, 1536, 20, 64, 1500), (2, 128, 4, 16, 64),
                                            (2, 256, 2, 128, None)] + ENC_EDGES)
def test_enc_attention_kernel(dev, B, T, H, hd, valid):
    q, k, v = (_randn(dev, B, T, H * hd, seed=i).view(B, T, H, hd) for i in range(3))
    before = ea.launches
    got = ea.enc_attention(q, k, v, valid_len=valid, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert ea.launches == before + 1
    qs = q * torch.tensor(hd ** -0.5, dtype=q.dtype, device=dev)
    n = T if valid is None else valid
    want = ea.enc_attention_plain(qs, k, v, n)
    _close(got[:, :n], want[:, :n], torch.bfloat16, "enc_attention")


@pytest.mark.parametrize("T,Hq,Hkv,hd", [(1526, 24, 8, 128), (100, 4, 2, 16), (300, 8, 8, 64)])
def test_causal_attention_kernel(dev, T, Hq, Hkv, hd):
    q = _randn(dev, 2, T, Hq, hd)
    k, v = _randn(dev, 2, T, Hkv, hd, seed=1), _randn(dev, 2, T, Hkv, hd, seed=2)
    mask = torch.ones(2, T, dtype=torch.int32, device=dev)
    mask[1, T - 11:] = 0
    got = ca.causal_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    want = ca.causal_attention_fwd(q.cpu(), k.cpu(), v.cpu(), mask.cpu())
    for b, real in enumerate([T, T - 11]):
        _close(got.o[b, :real].cpu(), want.o[b, :real], torch.bfloat16,
               "causal_attention")
    torch.testing.assert_close(got.m.cpu(), want.m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got.l.cpu(), want.l, atol=0.0, rtol=2.0 ** -8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_kernel(dev, dtype, per_row):
    L, B, Hkv, S, hd, Hq = 3, 2, 8, 1568, 128, 24
    ck, cv = _randn(dev, L, B, Hkv, S, hd, dtype=dtype), _randn(dev, L, B, Hkv, S, hd, dtype=dtype, seed=1)
    q = _randn(dev, B, Hq, hd, dtype=dtype, seed=2)
    kn, vn = _randn(dev, B, Hkv, hd, dtype=dtype, seed=3), _randn(dev, B, Hkv, hd, dtype=dtype, seed=4)
    off = torch.tensor([1200, 37] if per_row else [900], dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= off.reshape(-1, 1)).to(torch.int32)
    valid = valid.expand(B, S).contiguous()
    valid[0, 10:20] = 0
    ck2, cv2 = ck.clone(), cv.clone()
    got, gk, gv = dm.decode_attention_mono(q, kn, vn, ck, cv, 2, off, valid, hd ** -0.5)
    want, wk, wv = dm.decode_attention_plain(q, kn, vn, ck2, cv2, 2, off, valid, hd ** -0.5)
    torch.cuda.synchronize()
    _close(got, want, dtype, "decode_attention_mono")
    assert gk.data_ptr() == ck.data_ptr()  # appended in place
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("fault", ["valid_len + 1", "valid_len - 1"])
def test_enc_attention_check_rejects_a_one_key_fault(dev, fault):
    T, H, hd, valid = 256, 4, 64, 200
    q, k, v = (_randn(dev, 1, T, H, hd, seed=i) for i in range(3))
    want = ea.enc_attention_plain(q, k, v, valid)[:, :valid]
    wrong = ea.enc_attention_cuda(q, k, v, valid + (1 if "+" in fault else -1))[:, :valid]
    assert tol_ratio(wrong, want, ATOL_ROW_RMS_FRAC["enc_attention"]) > 1


@pytest.mark.parametrize("fault", ["one future key", "one key masked"])
def test_causal_attention_check_rejects_a_one_key_fault(dev, fault):
    T, Hq, Hkv, hd = 256, 4, 2, 64
    q = _randn(dev, 1, T, Hq, hd)
    k, v = _randn(dev, 1, T, Hkv, hd, seed=1), _randn(dev, 1, T, Hkv, hd, seed=2)
    bias = torch.zeros(1, T, device=dev)
    want = ca.causal_attention_plain(q, k, v, bias).o
    if fault == "one future key":  # query t attends keys 0..t+1
        ahead = torch.cat([q[:, :1], q[:, :-1]], dim=1)
        wrong, want = ca.causal_attention_cuda(ahead, k, v, bias).o[:, 1:], want[:, :-1]
    else:
        bias[:, 100] = ca.NEG
        wrong = ca.causal_attention_cuda(q, k, v, bias).o
    assert tol_ratio(wrong, want, ATOL_ROW_RMS_FRAC["causal_attention"]) > 1


@pytest.mark.parametrize("fault", ["slot offset+1 attended", "stale fresh row"])
def test_decode_attention_check_rejects_a_one_slot_fault(dev, fault):
    L, B, Hkv, S, hd, Hq, off = 1, 1, 8, 512, 128, 24, 400
    ck, cv = _randn(dev, L, B, Hkv, S, hd), _randn(dev, L, B, Hkv, S, hd, seed=1)
    q = _randn(dev, B, Hq, hd, seed=2)
    kn, vn = _randn(dev, B, Hkv, hd, seed=3), _randn(dev, B, Hkv, hd, seed=4)
    offset = torch.tensor([off], dtype=torch.int32, device=dev)
    kpos = torch.arange(S, device=dev)[None, :]
    valid = (kpos <= off).to(torch.int32)
    want = dm.decode_attention_plain(q, kn, vn, ck.clone(), cv.clone(), 0, offset, valid,
                                     hd ** -0.5)[0]
    if fault == "stale fresh row":
        kn, vn = ck[0, :, :, off].clone(), cv[0, :, :, off].clone()
    else:
        valid = (kpos <= off + 1).to(torch.int32)
    wrong = dm.decode_attention_cuda(q, kn, vn, ck, cv, 0, offset, valid, hd ** -0.5)[0]
    assert tol_ratio(wrong, want, ATOL_ROW_RMS_FRAC["decode_attention_mono"]) > 1


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _randn(dev, 4, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        ln.layer_norm(x, x[0], x[0])
    q = _randn(dev, 1, 128, 2, 32, dtype=torch.float32)
    with pytest.raises(TypeError):
        ea.enc_attention(q, q, q)
    ck = _randn(dev, 1, 1, 1, 40, 16)
    with pytest.raises(ValueError):
        dm.decode_attention_mono(ck[0, :, :, 0], ck[0, :, :, 0], ck[0, :, :, 0], ck, ck, 0,
                                 0, torch.ones(1, 40, dtype=torch.int32, device=dev), 1.0)


def test_tiny_generate_on_the_card_matches_the_host(dev):
    """The whole slice on the card at bf16 (kernels) against the host's plain
    path at f32 on the same bf16-valued weights: the first greedy token of
    each row agrees and the tokens are valid ids."""
    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm, llama

    cfg = AudioLLMConfig.tiny()
    host = allm.init_frozen(cfg, make_generator(0, "cpu"), torch.bfloat16)
    host["llama"] = llama.resize_embeddings(host["llama"], cfg.llama.vocab_size + 2, cfg.llama)
    train = allm.init_trainable(cfg, make_generator(1, "cpu"), torch.bfloat16)
    on_card = [copy.deepcopy(t).to(dev) for t in (host, train)]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 5))
    mask = np.ones_like(ids)
    mel = rng.normal(size=(2, 80, 128)).astype(np.float32)
    kw = dict(max_new_tokens=4, greedy=True, eos_id=-1, audio_start_id=512, audio_end_id=513)
    launches = ea.launches, ca.launches, dm.launches, ln.launches
    got = generate(*on_card, cfg, ids, mask, mel, compute_dtype=torch.bfloat16, device=dev, **kw)
    want = generate(host.float(), train.float(), cfg, ids, mask, mel,
                    compute_dtype=torch.float32, device="cpu", **kw)
    after = ea.launches, ca.launches, dm.launches, ln.launches
    L, W = cfg.llama.num_layers, cfg.whisper.num_layers
    assert np.subtract(after, launches).tolist() == [W, L, L * 3, 2 * W]
    assert torch.equal(got.tokens[:, 0].cpu(), want.tokens[:, 0])
    assert ((got.tokens >= 0) & (got.tokens < 514)).all()


def _bytes(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int32).to(
        torch.int8)


def _scales(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) * 0.02 + 0.002


def _ratio(got, want, kernel):
    return tol_ratio(got, want, ATOL_ROW_RMS_FRAC[kernel])


@pytest.mark.parametrize("seconds,n_mels", [(30.0, 128), (1.28, 80)])
def test_mel_power_kernel(dev, seconds, n_mels):
    from audio_llama_tpu_torch.config import MelConfig

    cfg = MelConfig(num_mel_bins=n_mels, max_audio_seconds=seconds)
    wav = _randn(dev, 2, cfg.max_samples, dtype=torch.float32) * 0.1
    padded = mp.pad_waveform(wav, cfg)
    before = mp.launches
    got = mp.mel_power(wav, cfg)
    torch.cuda.synchronize()
    assert mp.launches == before + 1
    want = mp.mel_power_plain(padded, cfg, cfg.num_frames)
    assert got.shape == (2, cfg.num_frames, n_mels)
    assert _ratio(got, want, "mel_power") <= 1
    shifted = mp.mel_power_cuda(padded[:, 1:].contiguous(), cfg, cfg.num_frames)
    assert _ratio(shifted, want, "mel_power") > 1  # frame offset one sample off


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M,K,Nh", [(1, 3072, 2560), (2, 512, 256), (4, 3072, 1536),
                                    (37, 512, 256), (64, 256, 128), (65, 256, 128),
                                    (200, 512, 384), (6104, 3072, 128),
                                    # the prefill kernel's 64-token tile edges
                                    (65, 1024, 2560), (127, 512, 384), (128, 256, 128),
                                    (129, 512, 2560), (255, 1024, 384), (1526, 3072, 2560),
                                    (6104, 3072, 384)])
def test_int4_matmul_kernel(dev, fmt, M, K, Nh):
    L = 3
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // 128, 2 * Nh, seed=1)
    x = _randn(dev, M, K, seed=2)
    want = i4.int4_matmul_stacked_plain(x, packed, scales, 1, fmt=fmt)
    for planes in (False, True):
        before = i4.launches
        got = i4.int4_matmul_stacked(x, packed, scales, 1, return_planes=planes, fmt=fmt)
        torch.cuda.synchronize()
        assert i4.launches == before + 1
        got = torch.cat(got, dim=-1) if planes else got
        assert _ratio(got, want, "int4_matmul_stacked") <= 1
    rolled = torch.roll(scales, -1, dims=1).contiguous()  # group g with g+1's scale
    assert _ratio(i4.int4_matmul_stacked(x, packed, rolled, 1, fmt=fmt), want,
                  "int4_matmul_stacked") > 1
    if fmt == "obin":
        assert _ratio(i4.int4_matmul_stacked(x, packed, scales, 1, fmt="pair"), want,
                      "int4_matmul_stacked") > 1


@pytest.mark.parametrize("M,K,F,D", [(4, 3072, 8192, 3072), (1, 256, 1024, 256),
                                     (9, 512, 1536, 512)])
def test_mlp_int4_kernel(dev, M, K, F, D):
    L = 2
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // 128, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // 128, D, seed=3)
    x = _randn(dev, M, K, seed=4)
    chunk = mlp4.kernel_chunk(F, D // 2)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, 1, chunk=chunk)
    before = mlp4.launches
    got = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk)
    again = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk)
    torch.cuda.synchronize()
    assert mlp4.launches == before + 2
    assert torch.equal(got, again)  # the cross-block sum runs in a fixed order
    assert _ratio(got, want, "mlp_int4_stacked") <= 1
    gus[1, :, F - chunk:F] = 0  # the last chunk dropped
    assert _ratio(mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk), want,
                  "mlp_int4_stacked") > 1


def _dnr(dev, L, F, D, seed=5):
    """[L, F] f32 down equalizers as a smoothed tree carries them: each
    layer's `_equalize_rows` of a seeded [F, D] slab with a few hot rows."""
    from audio_llama_tpu_torch.models.llama_int4 import _equalize_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for _ in range(L):
        w = torch.randn((F, D), generator=g, device=dev) * 0.02
        w[torch.randint(0, F, (8,), generator=g, device=dev)] *= 8.0
        rows.append(_equalize_rows(w)[1])
    return torch.stack(rows).contiguous()


@pytest.mark.parametrize("M,K,F,D", [(4, 3072, 8192, 3072), (1, 256, 1024, 256),
                                     (9, 512, 1536, 512)])
def test_mlp_int4_dnr_kernel(dev, M, K, F, D):
    """The has_dnr mode (smoothed trees) against its plain version; the
    equalizer ignored or taken from the wrong layer lands outside the bar."""
    L = 2
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // 128, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // 128, D, seed=3)
    x = _randn(dev, M, K, seed=4)
    dn_r = _dnr(dev, L, F, D)
    chunk = mlp4.kernel_chunk(F, D // 2)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, 1, chunk=chunk, dn_r=dn_r)
    before, before_plain = mlp4.launches_dnr, mlp4.launches
    got = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk, dn_r=dn_r)
    again = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk, dn_r=dn_r)
    torch.cuda.synchronize()
    assert (mlp4.launches_dnr, mlp4.launches) == (before + 2, before_plain)
    assert torch.equal(got, again)
    assert _ratio(got, want, "mlp_int4_stacked") <= 1
    assert _ratio(mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk), want,
                  "mlp_int4_stacked") > 1  # dn_r ignored
    assert _ratio(mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk,
                                        dn_r=dn_r.flip(0).contiguous()), want,
                  "mlp_int4_stacked") > 1  # the other layer's dn_r


def test_mlp_int4_dnr_refusals(dev):
    L, K, F, D = 2, 256, 1024, 256
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // 128, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // 128, D, seed=3)
    x = _randn(dev, 4, K, seed=4)
    dn_r = _dnr(dev, L, F, D)

    def run(r):
        return mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, dn_r=r)

    with pytest.raises(TypeError, match="float32"):
        run(dn_r.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        run(dn_r[:, :F // 2].contiguous())
    with pytest.raises(ValueError, match="shape"):
        run(dn_r[1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        run(torch.empty((F, L), device=dev).t())
    with pytest.raises(ValueError, match="tensors on"):
        run(dn_r.cpu())


def _q4_case(dev, dtype, per_row, S=1568):
    L, B, Hkv, hd, Hq = 3, 2, 8, 128, 24
    ckv = _bytes(dev, L, B, Hkv, S, hd)
    ks, vs = _scales(dev, L, B, Hkv, S, seed=1), _scales(dev, L, B, Hkv, S, seed=2)
    q = _randn(dev, B, Hq, hd, dtype=dtype, seed=3)
    kvn = _bytes(dev, B, Hkv, hd, seed=4)
    ksn, vsn = _scales(dev, B, Hkv, seed=5), _scales(dev, B, Hkv, seed=6)
    off = torch.tensor([1200, 37] if per_row else [900], dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= off.reshape(-1, 1)).to(torch.int32)
    valid = valid.expand(B, S).contiguous()
    valid[0, 10:20] = 0
    return q, kvn, ckv, ks, vs, ksn, vsn, off, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_q4_kernel(dev, dtype, per_row):
    q, kvn, ckv, ks, vs, ksn, vsn, off, valid = _q4_case(dev, dtype, per_row)
    ck2 = ckv.clone()
    before = dm.launches_q4
    got, gc = dm.decode_attention_quantized4_mono(q, kvn, ckv, ks, vs, ksn, vsn, 2, off, valid,
                                                  128 ** -0.5)
    want, wc = dm.decode_attention_q4_plain(q, kvn, ck2, ks, vs, ksn, vsn, 2, off, valid,
                                            128 ** -0.5)
    torch.cuda.synchronize()
    assert dm.launches_q4 == before + 1
    assert gc.data_ptr() == ckv.data_ptr() and torch.equal(gc, wc)  # appended in place
    _close(got, want, dtype, "decode_attention_quantized4_mono")


@pytest.mark.parametrize("fault", ["slot offset+1 attended", "slot offset not attended",
                                   "stale fresh row", "K decoded as signed"])
def test_decode_attention_q4_check_rejects_a_one_slot_fault(dev, fault):
    q, kvn, ckv, ks, vs, ksn, vsn, off, valid = _q4_case(dev, torch.bfloat16, False, S=512)
    off = torch.tensor([400], dtype=torch.int32, device=dev)
    kpos = torch.arange(512, device=dev)[None, :]
    valid = (kpos <= off).to(torch.int32).expand(2, 512).contiguous()
    want = dm.decode_attention_q4_plain(q, kvn, ckv.clone(), ks, vs, ksn, vsn, 0, off, valid,
                                        128 ** -0.5)[0]
    if fault == "slot offset+1 attended":
        valid = (kpos <= 401).to(torch.int32).expand(2, 512).contiguous()
    elif fault == "slot offset not attended":
        valid = valid.clone()
        valid[:, 400] = 0
    elif fault == "stale fresh row":
        kvn, ksn, vsn = ckv[0, :, :, 400].clone(), ks[0, :, :, 400].clone(), vs[0, :, :, 400].clone()
    else:
        ckv, kvn = ckv ^ 0x08, kvn ^ 0x08
    wrong = dm.decode_attention_q4_cuda(q, kvn, ckv.clone(), ks, vs, ksn, vsn, 0, off, valid,
                                        128 ** -0.5)[0]
    assert _ratio(wrong, want, "decode_attention_quantized4_mono") > 1


def test_tiny_int4_generate_on_the_card_matches_the_host(dev):
    """Waveform audio through the int4 slice (LoRA merged, fused int4 tree,
    int4 KV) on the card at bf16 against the host's plain path at f32 on the
    same tree: the first greedy token of each row agrees, every kernel of
    the path launched."""
    import dataclasses

    from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.inference import cli
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.models import allm, llama

    lc = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                     num_heads=4, num_kv_heads=2, head_dim=64, rope_scaling=None)
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=lc)
    host = allm.init_frozen(cfg, make_generator(0, "cpu"), torch.bfloat16)
    host["llama"] = llama.resize_embeddings(host["llama"], 514, lc)
    train = allm.init_trainable(cfg, make_generator(1, "cpu"), torch.bfloat16)
    host, train = cli.quantize_decoder(cfg, host, train)
    on_card = [copy.deepcopy(t).to(dev) for t in (host, train)]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 5))
    mask = np.ones_like(ids)
    wav = (rng.normal(size=(2, cfg.mel.max_samples)) * 0.1).astype(np.float32)
    kw = dict(max_new_tokens=4, greedy=True, eos_id=-1, audio_start_id=512, audio_end_id=513,
              kv_quant=4)
    counts = mp.launches, i4.launches, mlp4.launches, dm.launches_q4
    got = generate(*on_card, cfg, ids, mask, wav, compute_dtype=torch.bfloat16, device=dev, **kw)
    want = generate(host.float(), train.float(), cfg, ids, mask, wav,
                    compute_dtype=torch.float32, device="cpu", **kw)
    after = mp.launches, i4.launches, mlp4.launches, dm.launches_q4
    L = lc.num_layers
    assert np.subtract(after, counts).tolist() == [1, 4 * L + 2 * L * 3, L * 3, L * 3]
    assert torch.equal(got.tokens[:, 0].cpu(), want.tokens[:, 0])


def _q8_case(dev, dtype, per_row, S=1568):
    L, B, Hkv, hd, Hq = 3, 2, 8, 128, 24
    ck, cv = _bytes(dev, L, B, Hkv, S, hd), _bytes(dev, L, B, Hkv, S, hd, seed=7)
    ks, vs = _scales(dev, L, B, Hkv, S, seed=1) * 0.1, _scales(dev, L, B, Hkv, S, seed=2) * 0.1
    q = _randn(dev, B, Hq, hd, dtype=dtype, seed=3)
    kn, vn = _bytes(dev, B, Hkv, hd, seed=4), _bytes(dev, B, Hkv, hd, seed=8)
    ksn, vsn = _scales(dev, B, Hkv, seed=5) * 0.1, _scales(dev, B, Hkv, seed=6) * 0.1
    off = torch.tensor([1200, 37] if per_row else [900], dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= off.reshape(-1, 1)).to(torch.int32)
    valid = valid.expand(B, S).contiguous()
    valid[0, 10:20] = 0
    return q, kn, vn, ck, cv, ks, vs, ksn, vsn, off, valid


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_q8_kernel(dev, dtype, per_row):
    q, kn, vn, ck, cv, ks, vs, ksn, vsn, off, valid = _q8_case(dev, dtype, per_row)
    ck2, cv2 = ck.clone(), cv.clone()
    before = dm.launches_q8
    got, gk, gv = dm.decode_attention_quantized_mono(q, kn, vn, ck, cv, ks, vs, ksn, vsn, 2, off,
                                                     valid, 128 ** -0.5)
    want, wk, wv = dm.decode_attention_q8_plain(q, kn, vn, ck2, cv2, ks, vs, ksn, vsn, 2, off,
                                                valid, 128 ** -0.5)
    torch.cuda.synchronize()
    assert dm.launches_q8 == before + 1
    assert gk.data_ptr() == ck.data_ptr() and gv.data_ptr() == cv.data_ptr()  # in place
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    _close(got, want, dtype, "decode_attention_quantized_mono")


@pytest.mark.parametrize("fault", ["slot offset+1 attended", "slot offset not attended",
                                   "stale fresh row", "stale append scale"])
def test_decode_attention_q8_check_rejects_a_one_slot_fault(dev, fault):
    q, kn, vn, ck, cv, ks, vs, ksn, vsn, off, valid = _q8_case(dev, torch.bfloat16, False)
    off = torch.tensor([40], dtype=torch.int32, device=dev)
    kpos = torch.arange(ck.shape[3], device=dev)[None, :]
    valid = (kpos <= off).to(torch.int32).expand(2, -1).contiguous()
    want = dm.decode_attention_q8_plain(q, kn, vn, ck.clone(), cv.clone(), ks, vs, ksn, vsn, 0,
                                        off, valid, 128 ** -0.5)[0]
    if fault == "slot offset+1 attended":
        valid = (kpos <= 41).to(torch.int32).expand(2, -1).contiguous()
    elif fault == "slot offset not attended":
        valid = valid.clone()
        valid[:, 40] = 0
    elif fault == "stale fresh row":
        kn, vn = ck[0, :, :, 40].clone(), cv[0, :, :, 40].clone()
        ksn, vsn = ks[0, :, :, 40].clone(), vs[0, :, :, 40].clone()
    else:
        ksn, vsn = ks[0, :, :, 40].clone(), vs[0, :, :, 40].clone()
    wrong = dm.decode_attention_q8_cuda(q, kn, vn, ck.clone(), cv.clone(), ks, vs, ksn, vsn, 0,
                                        off, valid, 128 ** -0.5)[0]
    assert _ratio(wrong, want, "decode_attention_quantized_mono") > 1


class _Widths:
    """A stand-in for AudioLLMConfig carrying only `llama` (megakernel_case)."""

    def __init__(self, **dims):
        from audio_llama_tpu_torch.config import LlamaConfig

        self.llama = LlamaConfig(**dims)


# the full model's widths at 2 layers (G 3), the JAX megakernel test's
# geometry (G 2), and geometries of G 1 and G 4
MK_WIDTHS = {
    "3b": dict(hidden_size=3072, intermediate_size=8192, num_heads=24, num_kv_heads=8),
    "tiny": dict(hidden_size=256, intermediate_size=256, num_heads=2, num_kv_heads=1,
                 rope_scaling=None),
    "g1": dict(hidden_size=1024, intermediate_size=2816, num_heads=8, num_kv_heads=8),
    "g4": dict(hidden_size=2048, intermediate_size=5632, num_heads=16, num_kv_heads=4),
}
# (Tk, offset): the JAX test's, one timeline group at both ends, the B = 1
# path's last step at 1568 slots, 3040 slots at both ends
MK_TIMELINES = [(256, 200), (32, 0), (32, 31), (1568, 1556), (3040, 0), (3040, 3039)]


def _mk_case(dev, widths, fmt, Tk, off, L=2, seed=3):
    from chip_smoke import megakernel_case

    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = _Widths(num_layers=L, head_dim=128, **MK_WIDTHS[widths])
    return megakernel_case(dev, gen, fmt, L, Tk, off, cfg=cfg)


@pytest.mark.parametrize("tk,off", MK_TIMELINES)
@pytest.mark.parametrize("widths", list(MK_WIDTHS))
@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_megakernel_kernel(dev, widths, fmt, tk, off):
    """Each layer within the bar of the plain version on the same input, and
    the one-launch stack equal to its layers launched one by one."""
    from chip_smoke import mega_layerwise, mega_run
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    case = _mk_case(dev, widths, fmt, tk, off)
    before = mk.launches
    stack = mega_run(mk.decode_megakernel, case)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    ratio, _, got, want = mega_layerwise(case)
    assert ratio <= 1
    for a, b in zip(stack, got):
        assert torch.equal(a, b)
    gc, wc = got[1].to(torch.int32), want[1].to(torch.int32)
    d = ((gc & 0xF) - (wc & 0xF)).abs() + ((gc >> 4) - (wc >> 4)).abs()
    assert d.max() <= 2 and (d > 0).float().mean().item() * tk < 0.01
    for g, w in zip(got[2:], want[2:]):  # the scale slabs, then the fresh scales
        torch.testing.assert_close(g, w, rtol=2.0 ** -7, atol=0)
    # the barriers alone, and each phase alone: the same launch shape runs
    # and is not counted
    before = mk.launches
    for phases in [0] + [1 << i for i in range(len(mk.PHASES))]:
        mk.decode_megakernel_cuda(**case, phases=phases)
    torch.cuda.synchronize()
    assert mk.launches == before


def test_megakernel_longest_cache(dev):
    """The longest cache the gate admits (MAX_TK slots), the fresh row at
    its last slot."""
    from chip_smoke import mega_layerwise
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    tk = mk.MAX_TK
    case = _mk_case(dev, "tiny", "obin", tk, tk - 1)
    assert mk.ok_for(_Widths(num_layers=2, head_dim=128, **MK_WIDTHS["tiny"]).llama,
                     {n: w for n, w in zip(mk.SLABS, (case["qkv"], case["o"], case["gu"],
                                                      case["dn"]))}, tk, tk - 1, dev)
    assert mega_layerwise(case)[0] <= 1


@pytest.mark.parametrize("widths", ["3b", "g4"])
def test_megakernel_two_launches_same_bits(dev, widths):
    """The split plan and the ordered sums make the launch deterministic:
    two launches on the same inputs give the same bits."""
    from chip_smoke import mega_run
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    case = _mk_case(dev, widths, "pair", 1568, 1556, L=4)
    first = mega_run(mk.decode_megakernel_cuda, case)
    second = mega_run(mk.decode_megakernel_cuda, case)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_megakernel_check_rejects_planted_faults(dev, fmt):
    from chip_smoke import FAULT_MARGIN, mega_layerwise, megakernel_case, megakernel_faults

    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = _Widths(num_layers=4, head_dim=128, **MK_WIDTHS["3b"])
    case = megakernel_case(dev, gen, fmt, 4, 256, 2, cfg=cfg)
    assert mega_layerwise(case)[0] <= 1
    faults = megakernel_faults(case)
    assert {"one timeline split left out of the merge", "one K slice's partial dropped",
            "a stale ring stage consumed"} <= set(faults)
    assert min(faults.values()) > FAULT_MARGIN


def test_megakernel_gate_on_the_card(dev):
    """ok_for asks for a resident launch plan on the card: it admits every
    32-slot timeline up to MAX_TK with the append slot inside, and refuses a
    full cache, a longer timeline, w_r trees and groups other than 128."""
    from audio_llama_tpu_torch.config import LlamaConfig
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    lc = LlamaConfig(num_layers=2)
    slabs = {n: {"w_p": torch.empty((2, K, N // 2), dtype=torch.int8, device=dev),
                 "w_s": torch.empty((2, K // 128, N), device=dev)}
             for n, K, N in (("qkv_proj", 3072, 5120), ("o_proj", 3072, 3072),
                             ("gateup_proj", 3072, 16384), ("down_proj", 8192, 3072))}
    for tk, off in ((32, 0), (32, 31), (1568, 1556), (3040, 3039), (mk.MAX_TK, 0),
                    (mk.MAX_TK, mk.MAX_TK - 1)):
        assert mk.ok_for(lc, slabs, tk, off, dev), (tk, off)
    assert not mk.ok_for(lc, slabs, 1568, 1568, dev)  # a full cache
    assert not mk.ok_for(lc, slabs, mk.MAX_TK + 32, 0, dev)
    assert not mk.ok_for(lc, slabs, 1568, -1, dev)
    assert not mk.ok_for(lc, {**slabs, "o_proj": {**slabs["o_proj"], "w_r": slabs["o_proj"][
        "w_s"]}}, 1568, 1556, dev)
    g64 = {"w_p": slabs["down_proj"]["w_p"], "w_s": torch.empty((2, 8192 // 64, 3072),
                                                                device=dev)}
    assert not mk.ok_for(lc, {**slabs, "down_proj": g64}, 1568, 1556, dev)
    # the 3B widths run two blocks an SM, the plan's shared memory is the
    # kernel's, and nothing spills
    pl = mk.launch_plan(dev, 3072, 8192, 24, 8, 1568)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert pl.per_sm == 2 and pl.grid == 2 * sms
    info = mk.kernel_info(3, pl, 3072)
    assert info["smem_bytes"] == pl.smem and info["blocks_per_sm"] >= 2
    assert info["local_bytes"] == 0


def test_quantizers_divide_as_the_host_does(dev):
    """The symmetric quantizers on the card give the host's bytes and scales:
    their scale is a true quotient (a Python-scalar divisor would make the
    card multiply by its reciprocal, an ulp off, and flip roundings)."""
    from audio_llama_tpu_torch.models import llama, llama_int8

    gen = torch.Generator().manual_seed(9)
    x = torch.randn((4, 8, 64, 128), generator=gen)
    y = torch.randn((4, 8, 64, 128), generator=gen)
    for fn, args in ((llama.quantize_kv_rows4, (x, y)), (llama.quantize_kv_rows, (x,)),
                     (llama_int8._quantize_rows, (x[0, 0],)),
                     (lambda w: tuple(i4.quantize_pack(w)), (x[0, 0].T.contiguous(),))):
        host = fn(*args)
        card = fn(*(a.to(dev) for a in args))
        for h, c in zip(host, card):
            assert torch.equal(h, c.cpu()), fn


def _bwd_case(dev, B, T, Hq, Hkv, hd, pad_tail=0, seed=3):
    """Seeded backward inputs: qs pre-scaled, the last row's tail keys
    padded, o / l / m from the plain forward, a random cotangent."""
    qs = _randn(dev, B, T, Hq, hd, seed=seed) * torch.tensor(hd ** -0.5, dtype=torch.bfloat16,
                                                              device=dev)
    k, v = _randn(dev, B, T, Hkv, hd, seed=seed + 1), _randn(dev, B, T, Hkv, hd, seed=seed + 2)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    if pad_tail:
        mask[-1, T - pad_tail:] = 0
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    o, l, m = ca.causal_attention_plain(qs, k, v, key_bias)
    do = _randn(dev, B, T, Hq, hd, seed=seed + 3)
    return qs, k, v, key_bias, o, l, m, do


BWD_NAMES = ("causal_attention_dq", "causal_attention_dkv", "causal_attention_dkv")


def _grad_ratio(got, want, name):
    return tol_ratio(got, want, ATOL_ROW_RMS_FRAC[name], GRAD_RMS_DIMS)


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,pad", [
    (2, 512, 24, 8, 128, 34), (1, 256, 4, 2, 64, 0), (2, 128, 6, 6, 32, 5), (2, 128, 4, 2, 16, 3),
    # the wgmma kernels' edges: T 128, 384, 2048; G 1, 3, 6; a tail padded
    # inside a 64-row step; a batch row padded from 1800
    (1, 384, 6, 1, 128, 40), (2, 384, 9, 3, 64, 20), (1, 128, 6, 1, 16, 0),
    (3, 384, 3, 3, 32, 100), (2, 128, 12, 4, 128, 7), (2, 2048, 24, 8, 128, 248)])
def test_causal_attention_bwd_kernels(dev, B, T, Hq, Hkv, hd, pad):
    case = _bwd_case(dev, B, T, Hq, Hkv, hd, pad)
    want = ca.causal_attention_bwd_plain(*case)
    got = ca.causal_attention_bwd_cuda(*case)
    ratios = [_grad_ratio(g, w, name) for g, w, name in zip(got, want, BWD_NAMES)]
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in got)
    assert max(ratios) <= 1, ratios


def test_causal_attention_bwd_is_deterministic(dev):
    """No float atomics: two launches give the same bits."""
    case = _bwd_case(dev, 2, 512, 24, 8, 128, 34)
    first = ca.causal_attention_bwd_cuda(*case)
    second = ca.causal_attention_bwd_cuda(*case)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", list(BWD_FAULTS))
@pytest.mark.parametrize("hd", [64, 128])
def test_causal_attention_bwd_check_rejects_ring_and_mask_faults(dev, fault, hd):
    """The faults of the ring-fed backward kernels, computed by `chip_smoke.
    bwd_fault_reference` with their 64-row steps: dq's key tile j read with
    tile j-1's K, dk/dv's query tile i with tile i-1's Q or dO (a stale
    stage), the diagonal mask left off on the last tile, and the query
    statistics m, l and D read one step off: each fails the bar on every
    output it moves, which the kernels and the reference without a fault
    pass."""
    case = _bwd_case(dev, 2, 384, 6, 2, hd, 20)
    qs, k, v, key_bias, o, l, m, do = case
    d = ca.attention_bwd_prologue(o, do)
    want = ca.causal_attention_bwd_plain(*case)
    outs = ("dq", "dk", "dv")

    def passes(got, i):
        return bool(torch.isfinite(got[i]).all()) and _grad_ratio(got[i], want[i],
                                                                  BWD_NAMES[i]) <= 1

    got = ca.causal_attention_bwd_cuda(*case)
    clean = bwd_fault_reference(qs, k, v, key_bias, l, m, do, d)
    faulty = bwd_fault_reference(qs, k, v, key_bias, l, m, do, d, fault)
    for i, out in enumerate(outs):
        assert passes(got, i) and passes(clean, i), out
    for out in BWD_FAULTS[fault]:
        assert not passes(faulty, outs.index(out)), (fault, out)


def test_causal_attention_bwd_check_rejects_a_wrong_d(dev):
    qs, k, v, key_bias, o, l, m, do = _bwd_case(dev, 1, 256, 4, 2, 64)
    want = ca.causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do)
    d = torch.zeros((4, 256), device=dev)  # the prologue skipped
    got = ca.causal_attention_dq_cuda(qs, k, v, key_bias, l, m, do, d)
    assert _grad_ratio(got, want[0], BWD_NAMES[0]) > 1
    dk, _ = ca.causal_attention_dkv_cuda(qs, k, v, key_bias, l, m, do, d)
    assert _grad_ratio(dk, want[1], BWD_NAMES[1]) > 1


def test_causal_mha_gradients_go_through_the_kernels(dev):
    """autograd through `causal_mha` on the card launches the dq and dk/dv
    kernels once each and matches the plain backward of the kernel's own
    forward residuals."""
    B, T, Hq, Hkv, hd = 2, 200, 4, 2, 64
    q = _randn(dev, B, T, Hq, hd, seed=11).requires_grad_(True)
    k = _randn(dev, B, T, Hkv, hd, seed=12).requires_grad_(True)
    v = _randn(dev, B, T, Hkv, hd, seed=13).requires_grad_(True)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, 150:] = 0
    do = _randn(dev, B, T, Hq, hd, seed=14)
    n_dq, n_dkv = ca.launches_dq, ca.launches_dkv
    o = ca.causal_mha(q, k, v, mask)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    assert (ca.launches_dq - n_dq, ca.launches_dkv - n_dkv) == (1, 1)
    # the same chain by hand: pad to 256, scale, forward kernel, plain backward
    pad = (0, 0, 0, 0, 0, 56)
    qs = torch.nn.functional.pad(q.detach(), pad) * torch.tensor(hd ** -0.5, dtype=q.dtype,
                                                                   device=dev)
    kp, vp = (torch.nn.functional.pad(t.detach(), pad) for t in (k, v))
    key_bias = torch.where(torch.nn.functional.pad(mask, (0, 56)) != 0,
                           torch.zeros((), device=dev), ca.NEG)
    res = ca.causal_attention_cuda(qs, kp, vp, key_bias)
    wq, wk, wv = ca.causal_attention_bwd_plain(qs, kp, vp, key_bias, res.o, res.l, res.m,
                                               torch.nn.functional.pad(do, pad))
    wq = wq * torch.tensor(hd ** -0.5, dtype=q.dtype, device=dev)
    ratios = [_grad_ratio(g, w[:, :T], name)
              for g, w, name in zip((dq, dk, dv), (wq, wk, wv), BWD_NAMES)]
    assert max(ratios) <= 1, ratios


def test_unembed_gradient_on_the_card(dev):
    """The card's bf16 x bf16 -> f32 unembedding (`_MatmulF32Out`) passes the
    hidden state's gradient the host's f32 product gives, to bf16 rounding."""
    from audio_llama_tpu_torch.config import LlamaConfig
    from audio_llama_tpu_torch.models import llama

    cfg = LlamaConfig.tiny(vocab_size=1000)
    g = torch.Generator().manual_seed(4)
    params = {"embed": {"weight": (torch.randn(1000, 64, generator=g) * 0.1).to(torch.bfloat16)}}
    x = torch.randn(2, 7, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(2, 7, 1000, generator=g)
    tied = cfg.replace(tie_word_embeddings=True)

    def grad(d, cd):
        xd = x.to(d).to(cd).requires_grad_(True)
        pd = {"embed": {"weight": params["embed"]["weight"].to(d)}}
        logits = llama.unembed(pd, tied, xd, cd)
        assert logits.dtype == torch.float32
        return torch.autograd.grad((logits * w.to(d)).sum(), xd)[0].float().cpu()

    card, host = grad(dev, torch.bfloat16), grad("cpu", torch.float32)
    assert ((card - host).norm() / host.norm()).item() < 1e-2


def test_tiny_train_step_on_the_card_matches_the_host(dev):
    """One train step of the toy model (hd 16) on the card at bf16 (kernels,
    the dq and dk/dv kernels once per layer) against the host's plain path
    at f32 from the same weights: loss and gradients."""
    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm, llama
    from audio_llama_tpu_torch.training import train_step

    cfg = AudioLLMConfig.tiny()
    frozen = allm.init_frozen(cfg, make_generator(0, "cpu"), torch.bfloat16)
    frozen["llama"] = llama.resize_embeddings(frozen["llama"], cfg.llama.vocab_size + 2,
                                              cfg.llama)
    trainable = allm.init_trainable(cfg, make_generator(1, "cpu"))
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():
        br["a"].data.copy_(torch.from_numpy(rng.normal(size=br["a"].shape) * 0.1))
    ids = torch.from_numpy(rng.integers(3, 500, (2, 12)))
    labels = torch.where(torch.arange(12) >= 6, ids, -100)
    mel = torch.from_numpy(rng.normal(size=(2, 80, 128)).astype(np.float32))
    batch = allm.AudioLLMBatch(ids, torch.ones_like(ids), mel, labels)

    def step(fz, tr, cd, d):
        tr.requires_grad_(True)
        b = allm.AudioLLMBatch(*(t.to(d) for t in batch))
        loss, _ = allm.forward(fz, tr, cfg, b, 512, 513, cd)
        return loss.item(), [g.float().cpu() for g in train_step.gradients(
            loss, list(tr.parameters()))]

    n = ca.launches_dq, ca.launches_dkv
    card = step(copy.deepcopy(frozen).to(dev), copy.deepcopy(trainable).to(dev), torch.bfloat16,
                dev)
    assert (ca.launches_dq - n[0], ca.launches_dkv - n[1]) == (cfg.llama.num_layers,) * 2
    host = step(frozen.float(), copy.deepcopy(trainable), torch.float32, torch.device("cpu"))
    assert abs(card[0] - host[0]) <= 1e-2 * abs(host[0])
    for c, h in zip(card[1], host[1]):
        assert ((c - h).norm() / h.norm()).item() < 5e-2


# --- timeline-sharded decode: the stats kernels and a two-rank world -------

@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("B,S,off", [(1, 3040, 3016), (4, 3040, 3056), (2, 64, 19),
                                     (2, 64, -5)])
def test_db_stats_kernels(dev, bits, B, S, off):
    """Each stats kernel against its plain version: m and l within 1e-5
    relative, acc within the decode kernels' bar, the caches bit-equal (an
    owner appended, a non-owner left its cache as it was)."""
    from chip_smoke import STATS_REL, db_call, db_case, stats_ratio

    gen = torch.Generator(device=dev).manual_seed(bits + B)
    case = db_case(dev, gen, bits, B, S, 2, 8, 24, 128)
    valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
    if off < 0 or off >= S:
        valid[:] = 1
    valid[0, 3:9] = 0
    m, l, acc, caches = db_call(case, bits, 1, off, valid, 128 ** -0.5)
    wm, wl, wacc, wcaches = db_call(case, bits, 1, off, valid, 128 ** -0.5, cuda=False)
    torch.cuda.synchronize()
    assert stats_ratio(m, wm) <= 1 and stats_ratio(l, wl) <= 1, STATS_REL
    assert tol_ratio(acc, wacc, ATOL_ROW_RMS_FRAC["decode_attention_db_stats"]) <= 1
    for got, want, before in zip(caches, wcaches, case["caches"]):
        assert torch.equal(got, want)
        assert torch.equal(got, before) == (not 0 <= off < S)


def _tiny_sp_case(dev):
    from audio_llama_tpu_torch.config import AudioLLMConfig
    from audio_llama_tpu_torch.device import make_generator
    from audio_llama_tpu_torch.models import allm

    cfg = AudioLLMConfig.tiny()
    frozen = allm.init_frozen(cfg, make_generator(0, "cpu"), torch.bfloat16).to(dev)
    train = allm.init_trainable(cfg, make_generator(1, "cpu"), torch.bfloat16).to(dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(3, 250, (2, 40)))
    kw = dict(max_new_tokens=6, greedy=True, eos_id=-1, has_audio=False,
              compute_dtype=torch.bfloat16, device=dev)
    return cfg, frozen, train, ids, kw


def _sp_world(rank, world):
    """sp = 2 on the card (gloo, both ranks on cuda:0), the tiny model at
    bf16: the tokens and the stats kernel's launches."""
    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.parallel import build_mesh, make_sp_generate

    cfg, frozen, train, ids, kw = _tiny_sp_case("cuda:0")
    fn = make_sp_generate(cfg, build_mesh([("sp", 2)]), **kw)
    n = db.launches
    tokens = fn(frozen, train, ids, torch.ones_like(ids)).tokens
    return tokens, db.launches - n


def test_sp_generate_two_ranks_on_the_card(dev):
    """Two gloo ranks on one card: the same tokens on both, the first one
    the single-process run's (the prefill is the same computation), and the
    stats kernel launched once per layer per decode step on each rank."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.parallel import distributed

    cfg, frozen, train, ids, kw = _tiny_sp_case(dev)
    want = generate(frozen, train, cfg, ids, torch.ones_like(ids), **kw).tokens.cpu()
    out = distributed.spawn(_sp_world, 2, backend="gloo", device="cuda:0", timeout=240)
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][0][:, 0], want[:, 0])
    assert all(launches == cfg.llama.num_layers * 5 for _, launches in out)


# --- the ring hop: the tri='never' modes, and the sp ring on the card ---------

def _hop(dev, B, T, Hq, Hkv, hd, pad_from, seed=11):
    from chip_smoke import ring_hop_case

    return ring_hop_case(dev, torch.Generator(device=dev).manual_seed(seed), B, T, Hq, Hkv, hd,
                         pad_from)


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,pad_from", [(2, 512, 24, 8, 128, 400),
                                                    (1, 256, 4, 2, 64, None),
                                                    (2, 128, 4, 2, 16, 100),
                                                    (1, 384, 6, 1, 128, 340),
                                                    (2, 384, 9, 3, 32, 300),
                                                    (2, 128, 3, 3, 64, 70),
                                                    (2, 2048, 24, 8, 128, 1800)])
def test_never_kernels_match_their_plain_versions(dev, B, T, Hq, Hkv, hd, pad_from):
    """The forward, dq and dk/dv kernels with tri='never' on a ring hop, the
    backward fed the row statistics merged over the hop and the local block."""
    c = _hop(dev, B, T, Hq, Hkv, hd, pad_from)
    args = (c["qs"], c["k"], c["v"], c["bias"])
    got = ca.causal_attention_cuda(*args, tri="never")
    assert tol_ratio(got.o, c["hop"].o, ATOL_ROW_RMS_FRAC["causal_attention_never"]) <= 1
    torch.testing.assert_close(got.l, c["hop"].l, rtol=1e-2, atol=0)
    want = ca.causal_attention_bwd_plain(*args, c["o"], c["l"], c["m"], c["do"], tri="never")
    stats = (c["l"], c["m"], c["do"], c["d"])
    dq = ca.causal_attention_dq_cuda(*args, *stats, tri="never")
    dk, dv = ca.causal_attention_dkv_cuda(*args, *stats, tri="never")
    names = ("causal_attention_dq_never", "causal_attention_dkv_never",
             "causal_attention_dkv_never")
    for g, w, name in zip((dq, dk, dv), want, names):
        assert tol_ratio(g, w, ATOL_ROW_RMS_FRAC[name], GRAD_RMS_DIMS) <= 1, name


def test_never_kernels_check_rejects_the_causal_mask_and_the_local_stats(dev):
    c = _hop(dev, 1, 256, 4, 2, 64, 200)
    args = (c["qs"], c["k"], c["v"], c["bias"])
    masked = ca.causal_attention_cuda(*args, tri="always").o
    assert tol_ratio(masked, c["hop"].o, ATOL_ROW_RMS_FRAC["causal_attention_never"]) > 1
    want = ca.causal_attention_bwd_plain(*args, c["o"], c["l"], c["m"], c["do"], tri="never")
    local = ca.causal_attention_dq_cuda(*args, c["hop"].l, c["hop"].m, c["do"], c["d"],
                                        tri="never")
    assert tol_ratio(local, want[0], ATOL_ROW_RMS_FRAC["causal_attention_dq_never"],
                     GRAD_RMS_DIMS) > 1


def _ring_world(rank, world):
    """sp = 2 on the card (gloo, both ranks on cuda:0): this rank's slice of
    a bf16 causal attention through the kernel ring, its gradients, and its
    tri='never' launches."""
    from audio_llama_tpu_torch.parallel import build_mesh
    from audio_llama_tpu_torch.parallel.ring_kernel import ring_causal_mha_kernel

    q, k, v, mask, w = _ring_case("cuda:0")
    Tl = q.shape[1] // world
    sl = slice(rank * Tl, (rank + 1) * Tl)
    ts = [t[:, sl].contiguous().requires_grad_(True) for t in (q, k, v)]
    axis = build_mesh([("sp", world)]).axis("sp")
    n = (ca.launches_never, ca.launches_dq_never, ca.launches_dkv_never)
    o = ring_causal_mha_kernel(*ts, axis=axis, mask=mask[:, sl].contiguous())
    grads = torch.autograd.grad(o, ts, w[:, sl])
    launches = (ca.launches_never - n[0], ca.launches_dq_never - n[1],
                ca.launches_dkv_never - n[2])
    return o.detach(), grads, launches


def _ring_case(dev, B=2, T=512, Hq=8, Hkv=2, hd=64):
    q, k, v = (_randn(dev, B, T, h, hd, seed=s) for s, h in ((20, Hq), (21, Hkv), (22, Hkv)))
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, 400:] = 0
    return q, k, v, mask, _randn(dev, B, T, Hq, hd, seed=23)


def test_sp_ring_two_ranks_on_the_card(dev):
    """Two gloo ranks on one card: the kernel ring's output and gradients
    against the one-device kernels (bf16, rel-L2 2e-2 on the valid rows),
    rank 0 launching no tri='never' kernel and rank 1 one of each."""
    from audio_llama_tpu_torch.parallel import distributed

    q, k, v, mask, w = _ring_case(dev)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ca.causal_mha(*ts, mask=mask)
    want = [o.detach(), *torch.autograd.grad(o, ts, w)]
    out = distributed.spawn(_ring_world, 2, backend="gloo", device="cuda:0", timeout=240)
    got = [torch.cat([r[0] for r in out], dim=1)] + [
        torch.cat([r[1][i] for r in out], dim=1) for i in range(3)]
    valid = mask.bool().cpu()
    for i, (g, wnt) in enumerate(zip(got, want)):
        g, wnt = g.float().cpu(), wnt.float().cpu()
        if i < 2:  # o and dq: valid query rows
            g, wnt = g[valid], wnt[valid]
        assert (g - wnt).norm() <= 2e-2 * wnt.norm(), i
    assert [r[2] for r in out] == [(0, 0, 0), (1, 1, 1)]


# --- the --decode_impl kernels: the normalized db modes and the packed kernel -

AB_KERNELS = [("decode_attention_db", 16), ("decode_attention_quantized_db", 8),
              ("decode_attention_quantized4_db", 4), ("decode_attention_packed", 16),
              ("decode_attention_packed", 8)]


def _ab_case(dev, bits, B, S, Hq, Hkv, hd, dtype=torch.bfloat16, seed=0):
    from chip_smoke import db_case

    case = db_case(dev, torch.Generator(device=dev).manual_seed(seed + bits), bits, B, S, 2,
                   Hkv, Hq, hd)
    if dtype == torch.float32:  # the f32 instance: q (and a 16-bit cache) in f32
        case["q"] = case["q"].float()
        if bits == 16:
            case["rows"] = [r.float() for r in case["rows"]]
            case["caches"] = [c.float() for c in case["caches"]]
    return case


@pytest.mark.parametrize("name,bits", AB_KERNELS)
@pytest.mark.parametrize("B,S,off,Hq,Hkv,hd,dtype", [
    (2, 64, 19, 4, 2, 64, torch.bfloat16), (2, 96, 95, 4, 2, 64, torch.bfloat16),
    (2, 64, 40, 6, 2, 32, torch.float32), (4, 3040, 3016, 24, 8, 128, torch.bfloat16)])
def test_decode_ab_kernels(dev, name, bits, B, S, off, Hq, Hkv, hd, dtype):
    """Each kernel against its plain version: the output within the decode
    kernels' bar (f32: 1e-4), the caches bit-equal, the fresh rows at the
    offset and nothing else changed."""
    from chip_smoke import ab_call, check_append

    case = _ab_case(dev, bits, B, S, Hq, Hkv, hd, dtype)
    valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
    valid[-1, 3:9] = 0
    got, gc = ab_call(name, case, bits, 1, off, valid, hd ** -0.5)
    want, wc = ab_call(name, case, bits, 1, off, valid, hd ** -0.5, cuda=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, want, dtype, name)
    check_append(name, gc, wc, case["caches"], case["rows"], 1, off)


@pytest.mark.parametrize("quant", [False, True])
def test_packed_kernel_masked_leading_chunk_and_repeat_launches(dev, quant):
    """chunk 32 (NC 3 of 96 slots, one chunk a block) with the first chunk
    fully masked: within the bar of the plain version; two calls, one launch
    each, give the same bits."""
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk

    case = _ab_case(dev, 8 if quant else 16, 2, 96, 24, 8, 128)
    valid = (torch.arange(96, device=dev)[None, :] <= 70).to(torch.int32).repeat(2, 1)
    valid[:, :32] = 0
    qa = (*case["scales"], *case["fresh"]) if quant else None

    def call(fn):
        ck, cv = (c.clone() for c in case["caches"])
        return fn(case["q"], *case["rows"], ck, cv, 1, 70, valid, 128 ** -0.5, chunk=32,
                  quant_args=qa)[0]

    before = pk.launches_q8 if quant else pk.launches
    got, again = call(pk.packed_cuda), call(pk.packed_cuda)
    torch.cuda.synchronize()
    assert (pk.launches_q8 if quant else pk.launches) == before + 2  # one launch a call
    assert torch.equal(got, again)
    _close(got, call(pk.packed_plain), torch.bfloat16, "decode_attention_packed")


@pytest.mark.parametrize("name,bits", AB_KERNELS)
def test_decode_ab_check_rejects_a_stale_fresh_row(dev, name, bits):
    """The fresh row read stale from the cache at the offset, early in a
    request (one slot of 41 carries its weight): outside the bar."""
    from chip_smoke import AB_FAULT_OFFSET as off, ab_call

    case = _ab_case(dev, bits, 4, 1568, 24, 8, 128)
    valid = (torch.arange(1568, device=dev)[None, :] <= off).to(torch.int32).repeat(4, 1)
    want = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5, cuda=False)[0]
    stale = [c[1, :, :, off].clone() for c in case["caches"]]
    fresh = None if bits == 16 else [s[1, :, :, off].clone() for s in case["scales"]]
    got = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5, rows=stale, fresh=fresh)[0]
    assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC[name]) > 1


@pytest.mark.parametrize("impl,kv", [("decode_kernel", False), ("decode_kernel", True),
                                     ("decode_kernel", 4), ("decode_packed", False),
                                     ("decode_packed", True)])
def test_tiny_generate_decode_impl_on_the_card(dev, impl, kv):
    """The tiny model at bf16 through generate(attn_impl=...): the kernel
    launched once a layer a decode step, the first token the auto arm's (the
    prefill is the same)."""
    from audio_llama_tpu_torch.inference.generate import generate
    from audio_llama_tpu_torch.ops import decode_attention_db as db
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk

    cfg, frozen, train, ids, kw = _tiny_sp_case(dev)
    kw["kv_quant"] = kv
    counter = {("decode_kernel", False): (db, "launches_norm"),
               ("decode_kernel", True): (db, "launches_norm_q8"),
               ("decode_kernel", 4): (db, "launches_norm_q4"),
               ("decode_packed", False): (pk, "launches"),
               ("decode_packed", True): (pk, "launches_q8")}[(impl, kv)]
    n = getattr(*counter)
    got = generate(frozen, train, cfg, ids, torch.ones_like(ids), attn_impl=impl, **kw).tokens
    assert getattr(*counter) - n == cfg.llama.num_layers * 5
    want = generate(frozen, train, cfg, ids, torch.ones_like(ids), **kw).tokens
    assert torch.equal(got[:, 0], want[:, 0])


ENC_ARMS = [("enc_attention_v3q", {}), ("enc_attention_bounded", {}),
            ("enc_attention_bounded", {"layout": "head-major"}), ("enc_attention_twopass", {}),
            ("enc_attention_twopass", {"layout": "head-major"}),
            ("enc_attention_twopass", {"exp_dtype": torch.bfloat16})]


ENC_VARIANT_CASES = (
    [(name, arm, B, T, H, 64, valid) for name, arm in ENC_ARMS
     for B, T, H, valid in [(1, 1536, 20, 1500), (2, 256, 4, 200), (1, 128, 2, 128)]]
    # the wgmma kernel's modes at its edges (v3q is another kernel: hd 64, T % 64 == 0)
    + [(name, arm, *edge) for name, arm in ENC_ARMS if name != "enc_attention_v3q"
       for edge in ENC_EDGES])


@pytest.mark.parametrize("name,arm,B,T,H,hd,valid", ENC_VARIANT_CASES)
def test_enc_variant_kernels(dev, name, arm, B, T, H, hd, valid):
    """v3q, bounded and twopass at the main path's geometry and at small ones,
    within the encoder attention's bar of their plain versions."""
    from chip_smoke import enc_call, enc_case

    gen = torch.Generator(device=dev).manual_seed(5)
    valid = T if valid is None else valid
    case = enc_case(dev, gen, B, T=T, valid=valid, H=H, hd=hd)
    got = enc_call(name, case, **arm)
    torch.cuda.synchronize()
    want = enc_call(name, case, cuda=False, **arm)
    _close(got[:, :valid], want[:, :valid], torch.bfloat16, name)


ENC_MODES = [("enc_attention", {}), ("enc_attention_bounded", {}), ("enc_attention_twopass", {}),
             ("enc_attention_twopass", {"exp_dtype": torch.bfloat16})]


@pytest.mark.parametrize("name,arm", ENC_MODES)
@pytest.mark.parametrize("layout", ["v3", "head-major"])
def test_enc_kernel_gives_the_same_bits_twice(dev, name, arm, layout):
    """Every mode of the wgmma encoder kernel sums in a fixed order: a second
    launch on the same inputs gives the same bits."""
    from chip_smoke import enc_call, enc_case

    case = enc_case(dev, torch.Generator(device=dev).manual_seed(8), 2, T=1000, valid=900, H=4)
    got = enc_call(name, case, layout=layout, **arm)
    assert torch.equal(got, enc_call(name, case, layout=layout, **arm))


ENC_TILE_FAULTS = [(name, fault) for name in ("enc_attention", "enc_attention_bounded",
                                              "enc_attention_twopass")
                   for fault in ("stale K", "stale V", "mask off")] + [
    ("enc_attention_twopass", "max one tile short")]


@pytest.mark.parametrize("name,fault", ENC_TILE_FAULTS)
@pytest.mark.parametrize("hd", [64, 128])
def test_enc_kernel_check_rejects_ring_and_mask_faults(dev, name, fault, hd):
    """The faults of a ring-fed tile loop, computed by `chip_smoke.
    enc_reference` with the kernel's key tiles: tile j read with tile j-1's
    K or V (a stale stage), the last valid tile's keys past valid_len left
    unmasked, and twopass's pass-1 max one tile short (on a key of the last
    valid tile 1200 times a unit direction, which the short max leaves to
    overflow) each fail the bar that the kernel passes; the reference
    without a fault passes it."""
    from chip_smoke import enc_call, enc_case, enc_reference

    T, valid = 256, 200
    case = enc_case(dev, torch.Generator(device=dev).manual_seed(9), 2, T=T, valid=valid, H=4,
                    hd=hd)
    if fault == "max one tile short":
        d = torch.randn((4, hd), generator=torch.Generator(device=dev).manual_seed(10),
                        device=dev)
        case["k"][:, valid - 1] = (d / d.norm(dim=-1, keepdim=True) * 1200.0).to(torch.bfloat16)

    def passes(got, want):
        return bool(torch.isfinite(got).all()) and tol_ratio(got, want,
                                                             ATOL_ROW_RMS_FRAC[name]) <= 1

    want = enc_call(name, case, cuda=False)[:, :valid]
    assert passes(enc_call(name, case)[:, :valid], want)
    assert passes(enc_reference(case, name, None)[:, :valid], want)
    assert not passes(enc_reference(case, name, fault)[:, :valid], want), fault


@pytest.mark.parametrize("name", ["enc_attention_v3q", "enc_attention_bounded",
                                  "enc_attention_twopass"])
def test_enc_variant_checks_reject_planted_faults(dev, name):
    """valid_len +- 1 for each; v3q with the next head's V scales; bounded
    with ||q|| taken before q is scaled (every row underflows); twopass with
    its last key tile skipped: each outside the bar."""
    from chip_smoke import enc_call, enc_case, enc_faults

    gen = torch.Generator(device=dev).manual_seed(6)
    case = enc_case(dev, gen, 1, T=256, valid=200, H=4,
                    mag=2.0 if name == "enc_attention_bounded" else 1.0)
    want = enc_call(name, case, cuda=False)[:, :200]
    for fault, kw in enc_faults(name, case).items():
        got = enc_call(name, case, **kw)[:, :200]
        assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC[name]) > 1, fault


def test_bounded_kernel_zeroes_the_plain_versions_rows_on_outlier_keys(dev):
    from chip_smoke import enc_call, enc_outlier_case

    case = enc_outlier_case(dev, torch.Generator(device=dev).manual_seed(7), T=256, H=4)
    got = enc_call("enc_attention_bounded", case)
    want = enc_call("enc_attention_bounded", case, cuda=False)
    zero = (want == 0).all(dim=-1)
    assert zero.any() and torch.equal((got == 0).all(dim=-1), zero)


@pytest.mark.parametrize("algo,softmax,counter", [
    ("v3", "safe", "launches"), ("v3", "bounded", "launches_bounded"),
    ("bounded", "safe", "launches_bounded"), ("twopass", "safe", "launches_twopass"),
    ("v3q", "safe", "launches_v3q")])
def test_enc_attention_algos_launch_their_kernels(dev, algo, softmax, counter):
    q, k, v = (_randn(dev, 1, 128, 2 * 64, seed=i).view(1, 128, 2, 64) for i in range(3))
    before = {c: getattr(ea, c) for c in ("launches", "launches_v3q", "launches_bounded",
                                          "launches_twopass")}
    ea.enc_attention(q, k, v, valid_len=100, algo=algo, softmax=softmax)
    torch.cuda.synchronize()
    after = {c: getattr(ea, c) for c in before}
    assert {c: after[c] - before[c] for c in before} == {c: int(c == counter) for c in before}


def test_int_mm_on_the_card_is_exact(dev):
    """The W8A8 linears' int8 product (torch._int_mm) at the encoder's shapes:
    exact int32 sums, as on the host."""
    g = torch.Generator(device=dev).manual_seed(8)
    a = torch.randint(-127, 128, (1536, 1280), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (1280, 5120), generator=g, device=dev, dtype=torch.int8)
    got = torch._int_mm(a, b)
    assert torch.equal(got.cpu(), torch._int_mm(a.cpu(), b.cpu()))


@pytest.mark.parametrize("algo", ["v3", "v3q", "bounded", "twopass"])
def test_tiny_int8_encoder_on_the_card_matches_the_host(dev, algo):
    """A 2-layer W8A8 encoder (hd 64, the v3q kernel's width) quantized once
    on the host: the card (kernels, bf16) within rel-L2 2e-2 of the host's
    plain path (f32), the chosen kernel once a layer."""
    import copy
    import dataclasses

    from audio_llama_tpu_torch.config import WhisperConfig
    from audio_llama_tpu_torch.models import whisper, whisper_int8 as w8

    cfg = dataclasses.replace(WhisperConfig.tiny(), d_model=256, num_heads=4, ffn_dim=512,
                              max_source_positions=128)
    gen = torch.Generator().manual_seed(9)
    params = whisper.init_params(cfg, gen, torch.float32)
    mel = torch.randn((2, cfg.num_mel_bins, 256), generator=gen)
    qp = w8.quantize_encoder_smoothed(params, cfg, mel, compute_dtype=torch.float32)
    counter = {"v3": "launches", "v3q": "launches_v3q", "bounded": "launches_bounded",
               "twopass": "launches_twopass"}[algo]
    before = getattr(ea, counter)
    card = w8.encode_int8(copy.deepcopy(qp).to(dev), cfg, mel.to(dev), torch.bfloat16,
                          attn_algo=algo)
    torch.cuda.synchronize()
    assert getattr(ea, counter) - before == cfg.num_layers
    host = w8.encode_int8(qp, cfg, mel, torch.float32, attn_algo=algo)
    rel = ((card.float().cpu() - host).norm() / host.norm()).item()
    assert rel < 2e-2, rel


# --- the causal forward variants (fwd_impl / softmax_mode) ---------------------

CAUSAL_VARIANTS = {  # kernel -> (plain, kernel) of (qs, k, v, key_bias, kn)
    "causal_attention": ca.variant_forward("blocks", "online"),
    "causal_attention_never": (
        lambda qs, k, v, b, kn: ca.causal_attention_plain(qs, k, v, b, "never"),
        lambda qs, k, v, b, kn: ca.causal_attention_cuda(qs, k, v, b, "never")),
    "causal_attention_cond": ca.variant_forward("blocks_cond", "online"),
    "causal_attention_bounded": ca.variant_forward("blocks", "bounded"),
    "causal_attention_bounded_cond": ca.variant_forward("blocks_cond", "bounded"),
    "causal_attention_twopass": ca.variant_forward("blocks", "twopass"),
    "causal_attention_dma": ca.variant_forward("dma", "bounded"),
    "causal_attention_dma2": ca.variant_forward("dma2", "bounded"),
}


def _variant_case(dev, B, T, Hq, Hkv, hd, pad_from, seed=21):
    qs = _randn(dev, B, T, Hq, hd, seed=seed) * torch.tensor(hd ** -0.5, dtype=torch.bfloat16,
                                                             device=dev)
    k, v = _randn(dev, B, T, Hkv, hd, seed=seed + 1), _randn(dev, B, T, Hkv, hd, seed=seed + 2)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[B - 1, pad_from:] = 0
    key_bias = torch.where(mask != 0, torch.zeros((), device=dev), ca.NEG)
    return qs, k, v, key_bias, ca.key_norm_max(k), mask


def _variant_close(got, want, mask):
    for b in range(mask.shape[0]):
        real = int(mask[b].sum())
        assert tol_ratio(got.o[b, :real], want.o[b, :real],
                         ATOL_ROW_RMS_FRAC["causal_attention"]) <= 1
    torch.testing.assert_close(got.m, want.m, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got.l, want.l, atol=0.0, rtol=2.0 ** -8)


@pytest.mark.parametrize("name", list(CAUSAL_VARIANTS))
@pytest.mark.parametrize("B,T,Hq,Hkv,hd,pad_from", [(2, 256, 8, 2, 128, 200),
                                                    (1, 320, 4, 4, 64, 300),
                                                    (2, 128, 6, 2, 32, 100)])
def test_causal_variant_kernels(dev, name, B, T, Hq, Hkv, hd, pad_from):
    """Each forward variant's kernel against its plain version: o on the
    valid rows within row 3's bar, l and the shift m (c) as row 3's; the
    same bits on a second launch."""
    qs, k, v, key_bias, kn, mask = _variant_case(dev, B, T, Hq, Hkv, hd, pad_from)
    plain, kernel = CAUSAL_VARIANTS[name]
    got = kernel(qs, k, v, key_bias, kn)
    torch.cuda.synchronize()
    _variant_close(got, plain(qs, k, v, key_bias, kn), mask)
    again = kernel(qs, k, v, key_bias, kn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name,same_as", [("causal_attention_cond", None),
                                          ("causal_attention_bounded_cond",
                                           "causal_attention_bounded"),
                                          ("causal_attention_dma", "causal_attention_bounded")])
def test_causal_variants_equal_their_blocks_kernel_bit_for_bit(dev, name, same_as):
    """cond runs the kernel of 'always', bounded_cond and dma the bounded
    kernel (their TPU differences, masked tiles and hand-copied K/V, have
    no counterpart under TMA): the same bits (dma2, a kernel of its own: the
    next test)."""
    qs, k, v, key_bias, kn, _ = _variant_case(dev, 2, 384, 8, 2, 128, 333)
    got = CAUSAL_VARIANTS[name][1](qs, k, v, key_bias, kn)
    if same_as is None:
        want = ca.causal_attention_cuda(qs, k, v, key_bias, "always")
    else:
        want = CAUSAL_VARIANTS[same_as][1](qs, k, v, key_bias, kn)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dma2_matches_the_bounded_blocks_kernel_within_the_bar(dev):
    """dma2's kernel (64-key tiles, S_{j+1} ahead) and the bounded kernel
    (128-key tiles) compute one function: o within row 3's bar, l and c
    within its l / m bars."""
    qs, k, v, key_bias, kn, mask = _variant_case(dev, 2, 384, 8, 2, 128, 333)
    got = CAUSAL_VARIANTS["causal_attention_dma2"][1](qs, k, v, key_bias, kn)
    want = CAUSAL_VARIANTS["causal_attention_bounded"][1](qs, k, v, key_bias, kn)
    _variant_close(got, want, mask)


# the wgmma / TMA kernels in every mode: hd 16-128 (dma2: 64, 128), G 1-4, B 1
# and 2, T off the 64 grid for online and twopass, off the 128 grid for the
# bounded blocks modes (dma and dma2 take multiples of 64), one row's keys padded
SM90_CASES = [("causal_attention", 2, 1000, 12, 4, 128, 900),
              ("causal_attention", 1, 640, 8, 2, 64, 600),
              ("causal_attention", 2, 200, 4, 2, 32, 150),
              ("causal_attention", 1, 330, 4, 4, 16, 300),
              ("causal_attention_cond", 2, 768, 12, 4, 128, 700),
              ("causal_attention_cond", 1, 1000, 6, 2, 16, 950),
              ("causal_attention_never", 2, 1000, 12, 4, 128, 900),
              ("causal_attention_never", 1, 520, 8, 2, 32, 500),
              ("causal_attention_never", 2, 96, 4, 1, 16, 90),
              ("causal_attention_never", 1, 384, 3, 1, 64, 300),
              ("causal_attention_bounded", 2, 1000, 12, 4, 128, 900),
              ("causal_attention_bounded", 1, 640, 8, 8, 64, 600),
              ("causal_attention_bounded", 2, 320, 6, 2, 32, 250),
              ("causal_attention_bounded", 1, 576, 4, 1, 16, 500),
              ("causal_attention_bounded_cond", 2, 768, 12, 4, 128, 700),
              ("causal_attention_bounded_cond", 1, 320, 4, 4, 64, 300),
              ("causal_attention_dma", 2, 768, 12, 4, 128, 700),
              ("causal_attention_dma", 1, 640, 8, 2, 32, 600),
              ("causal_attention_dma", 2, 576, 4, 1, 16, 500),
              ("causal_attention_twopass", 2, 1000, 12, 4, 128, 900),
              ("causal_attention_twopass", 1, 640, 8, 2, 128, 600),
              ("causal_attention_twopass", 2, 576, 4, 4, 64, 500),
              ("causal_attention_twopass", 2, 320, 6, 2, 32, 250),
              ("causal_attention_twopass", 1, 1000, 4, 1, 16, 800),
              ("causal_attention_dma2", 2, 768, 12, 4, 128, 700),
              ("causal_attention_dma2", 1, 640, 8, 2, 128, 600),
              ("causal_attention_dma2", 2, 576, 4, 4, 64, 500),
              ("causal_attention_dma2", 1, 320, 6, 2, 64, 300)]


@pytest.mark.parametrize("name,B,T,Hq,Hkv,hd,pad_from", SM90_CASES)
def test_sm90_attention_kernels(dev, name, B, T, Hq, Hkv, hd, pad_from):
    """Each wgmma / TMA kernel in each mode against its plain version: o on
    the valid rows within row 3's bar, l and the shift m (c) within its bars;
    a second launch gives the same bits."""
    qs, k, v, key_bias, kn, mask = _variant_case(dev, B, T, Hq, Hkv, hd, pad_from)
    plain, kernel = CAUSAL_VARIANTS[name]
    got = kernel(qs, k, v, key_bias, kn)
    torch.cuda.synchronize()
    _variant_close(got, plain(qs, k, v, key_bias, kn), mask)
    again = kernel(qs, k, v, key_bias, kn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_twopass_residuals_drive_the_backward_kernels(dev):
    """twopass's l and c are the backward's residuals: the dq and dk/dv
    kernels fed them give the plain backward's gradients within rows 11-12's
    bars."""
    B, T, Hq, Hkv, hd = 2, 512, 12, 4, 128
    qs, k, v, key_bias, kn, _ = _variant_case(dev, B, T, Hq, Hkv, hd, 450, seed=41)
    res = CAUSAL_VARIANTS["causal_attention_twopass"][1](qs, k, v, key_bias, kn)
    do = _randn(dev, B, T, Hq, hd, seed=45)
    got = ca.causal_attention_bwd_cuda(qs, k, v, key_bias, res.o, res.l, res.m, do)
    want = ca.causal_attention_bwd_plain(qs, k, v, key_bias, res.o, res.l, res.m, do)
    ratios = [_grad_ratio(g, w, name) for g, w, name in zip(got, want, BWD_NAMES)]
    assert max(ratios) <= 1, ratios


def test_sm90_kernel_info(dev):
    """Every wgmma / TMA kernel reports its registers, no spills and one
    resident block an SM at hd 128 (the runtime's view of what the build log
    says); the causal backward's dq and dk/dv kernels (both modes) and the
    encoder kernel's modes at every head_dim they take."""
    for name in ca.SM90_KERNELS:
        info = ca.sm90_kernel_info(name, 128)
        assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0, (name, info)
    for name in ("causal_attention_dq", "causal_attention_dq_never", "causal_attention_dkv",
                 "causal_attention_dkv_never"):
        for hd in (16, 32, 64):
            info = ca.sm90_kernel_info(name, hd)
            assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0, (name, hd, info)
    for name in ea.SM90_KINDS:
        for hd in (16, 32, 64, 128):
            info = ea.sm90_kernel_info(name, hd)
            assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0, (name, hd, info)


def test_causal_variant_checks_reject_planted_faults(dev):
    """The check above fails on each planted fault (`chip_smoke.
    variant_reference` computes the faulty functions): cond's diagonal tile
    unmasked, twopass's last valid tile left out of the max (seen in c),
    bounded's kn over the valid keys only (a padded key holds the largest
    norm; seen in c), dma's diagonal tile not fetched (its keys dropped),
    dma2's PV of tile j read from tile j+1's V."""
    B, T, Hq, Hkv, hd = 2, 256, 8, 2, 128
    qs, k, v, key_bias, kn, mask = _variant_case(dev, B, T, Hq, Hkv, hd, 200)
    k[1, 230] *= 3  # a padded key with the largest norm
    case = dict(qs=qs, k=k, v=v, key_bias=key_bias, kn=ca.key_norm_max(k))
    frac, real = ATOL_ROW_RMS_FRAC["causal_attention"], 200
    t = torch.arange(T, device=dev)
    diag = (t[None, :] // 64) == (t[:, None] // 64)
    causal = t[None, :] <= t[:, None]

    def run(name):
        return CAUSAL_VARIANTS[name][1](qs, k, v, key_bias, case["kn"])

    def o_ratio(got, want, q0=0):
        return tol_ratio(got.o[:, q0:real], want.o[:, q0:real], frac)

    def shift_differs(got, want, q0=0):  # the check of m (c): atol 1e-4, rtol 1e-5
        g, w = got.m.reshape(B, Hq, T)[:, :, q0:real], want.m.reshape(B, Hq, T)[:, :, q0:real]
        return ((g - w).abs() > 1e-4 + 1e-5 * w.abs()).any()

    assert o_ratio(run("causal_attention_cond"), variant_reference(case, causal | diag,
                                                                   "online")) > 1
    kn_valid = ca.key_norm_max(k * (mask != 0)[:, :, None, None])
    assert shift_differs(run("causal_attention_bounded"),
                         ca.causal_attention_bounded_plain(qs, k, v, key_bias, kn_valid))
    # the max over fewer keys moves c, and l with it (o is invariant to the shift)
    assert shift_differs(run("causal_attention_twopass"), variant_reference(
        case, causal, "twopass", max_keys=causal & ~diag), q0=64)
    assert o_ratio(run("causal_attention_dma"),
                   variant_reference(case, causal & ~diag, "bounded"), q0=64) > 1
    assert o_ratio(run("causal_attention_dma2"),
                   variant_reference(case, causal, "bounded", v_next=True), q0=128) > 1


@pytest.mark.parametrize("fwd_impl,softmax_mode,counter", [
    ("blocks_cond", "online", "launches_cond"), ("blocks", "bounded", "launches_bounded"),
    ("blocks_cond", "bounded", "launches_bounded_cond"),
    ("blocks", "twopass", "launches_twopass"), ("blocks_cond", "twopass", "launches_twopass"),
    ("dma", "online", "launches_dma"), ("dma2", "twopass", "launches_dma2")])
def test_causal_mha_variants_launch_their_kernels(dev, fwd_impl, softmax_mode, counter):
    """autograd through `causal_mha(fwd_impl=, softmax_mode=)`: one launch of
    the variant's forward kernel, one dq, one dk/dv (dma and dma2 take the
    bounded mode whatever is asked), the gradients within rows 11-12's bars
    of the plain backward on the kernel's residuals."""
    B, T, Hq, Hkv, hd = 2, 200, 8, 2, 128
    q = _randn(dev, B, T, Hq, hd, seed=31).requires_grad_(True)
    k = _randn(dev, B, T, Hkv, hd, seed=32).requires_grad_(True)
    v = _randn(dev, B, T, Hkv, hd, seed=33).requires_grad_(True)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, 150:] = 0
    do = _randn(dev, B, T, Hq, hd, seed=34)
    before = (getattr(ca, counter), ca.launches, ca.launches_dq, ca.launches_dkv)
    o = ca.causal_mha(q, k, v, mask, fwd_impl=fwd_impl, softmax_mode=softmax_mode)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    after = (getattr(ca, counter), ca.launches, ca.launches_dq, ca.launches_dkv)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 1, 1)
    pad = (0, 0, 0, 0, 0, 56)
    qs = torch.nn.functional.pad(q.detach(), pad) * torch.tensor(hd ** -0.5, dtype=q.dtype,
                                                                   device=dev)
    kp, vp = (torch.nn.functional.pad(t.detach(), pad) for t in (k, v))
    key_bias = torch.where(torch.nn.functional.pad(mask, (0, 56)) != 0,
                           torch.zeros((), device=dev), ca.NEG)
    res = ca.variant_forward(fwd_impl, softmax_mode)[1](qs, kp, vp, key_bias, ca.key_norm_max(kp))
    wq, wk, wv = ca.causal_attention_bwd_plain(qs, kp, vp, key_bias, res.o, res.l, res.m,
                                               torch.nn.functional.pad(do, pad))
    wq = wq * torch.tensor(hd ** -0.5, dtype=q.dtype, device=dev)
    ratios = [_grad_ratio(g, w[:, :T], name)
              for g, w, name in zip((dq, dk, dv), (wq, wk, wv), BWD_NAMES)]
    assert max(ratios) <= 1, ratios


def test_bounded_variants_zero_the_plain_versions_rows_on_outlier_keys(dev):
    """tests/test_causal_attention.py::_outlier_setup on the card: the bounded
    kernels (blocks, dma, dma2) zero the rows their plain version zeroes;
    twopass and cond stay within the bar of online."""
    B, T, Hq, Hkv, hd = 1, 256, 2, 1, 128
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, T, Hq, hd), generator=g, device=dev) * 2.0
    k = torch.randn((B, T, Hkv, hd), generator=g, device=dev) * 2.0
    d = torch.randn((hd,), generator=g, device=dev)
    k[:, 0] = d / d.norm() * 1500.0
    v = torch.randn((B, T, Hkv, hd), generator=g, device=dev)
    qs = (q * hd ** -0.5).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    key_bias = torch.zeros((B, T), device=dev)
    kn = ca.key_norm_max(k)
    want = ca.causal_attention_bounded_plain(qs, k, v, key_bias, kn)
    zero_want = (want.o == 0).all(dim=-1)
    assert zero_want.any()
    for name in ("causal_attention_bounded", "causal_attention_dma", "causal_attention_dma2"):
        got = CAUSAL_VARIANTS[name][1](qs, k, v, key_bias, kn)
        assert torch.equal((got.o == 0).all(dim=-1), zero_want), name
    online = ca.causal_attention_cuda(qs, k, v, key_bias)
    for name in ("causal_attention_twopass", "causal_attention_cond"):
        got = CAUSAL_VARIANTS[name][1](qs, k, v, key_bias, kn)
        assert tol_ratio(got.o, online.o, ATOL_ROW_RMS_FRAC["causal_attention"]) <= 1, name


# --- the K-split W4A16 (block_k / INT4_BK) -----------------------------------------

@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M,K,Nh,bk", [(4, 3072, 2560, 768), (4, 3072, 2560, 1536),
                                       (1, 1024, 256, 256), (8, 1536, 128, 1536),
                                       (72, 512, 256, 256), (200, 3072, 384, 768),
                                       (300, 3072, 128, 1536), (65, 1536, 384, 768),
                                       (127, 3072, 128, 1536), (128, 1536, 2560, 768),
                                       (129, 3072, 2560, 1536), (255, 1536, 384, 768),
                                       (1526, 3072, 384, 768), (6104, 3072, 2560, 1536)])
def test_int4_ksplit_kernel(dev, fmt, M, K, Nh, bk):
    """The K-split launch (both shapes) against the K-split plain version;
    a K block dropped, and block ki read with block 0's scales, fail the
    same check."""
    L = 2
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // 128, 2 * Nh, seed=1)
    x = _randn(dev, M, K, seed=2)
    want = i4.int4_matmul_stacked_ksplit_plain(x, packed, scales, 1, bk, fmt=fmt)
    for planes in (False, True):
        before = (i4.launches, i4.launches_ksplit)
        got = i4.int4_matmul_stacked(x, packed, scales, 1, return_planes=planes, fmt=fmt,
                                     block_k=bk)
        torch.cuda.synchronize()
        assert (i4.launches, i4.launches_ksplit) == (before[0], before[1] + 1)
        got = torch.cat(got, dim=-1) if planes else got
        assert _ratio(got, want, "int4_matmul_stacked") <= 1
    nb, gpb = K // bk, bk // 128
    dropped = x.clone()
    dropped[:, (nb - 1) * bk:] = 0  # the last K block left out
    assert _ratio(want, i4.int4_matmul_stacked_ksplit_plain(dropped, packed, scales, 1, bk,
                                                            fmt=fmt), "int4_matmul_stacked") > 1
    if nb > 1:
        s0 = scales.clone()
        s0[1] = scales[1, :gpb].repeat(nb, 1)  # every block with block 0's scales
        got = i4.int4_matmul_stacked(x, packed, s0.contiguous(), 1, fmt=fmt, block_k=bk)
        assert _ratio(got, want, "int4_matmul_stacked") > 1


@pytest.mark.parametrize("M", [4, 6104])
def test_int4_ksplit_geometry_fallback_is_the_whole_k_kernel(dev, M):
    """K 8192 (the down projection) divides by neither 768 nor 1536: the call
    is the whole-K launch, bit for bit, counted as whole K."""
    K, Nh = 8192, 128
    packed, scales = _bytes(dev, 2, K, Nh), _scales(dev, 2, K // 128, 2 * Nh, seed=3)
    x = _randn(dev, M, K, seed=4)
    whole = i4.int4_matmul_stacked_cuda(x, packed, scales, 0)
    for bk in (768, 1536):
        before = (i4.launches, i4.launches_ksplit)
        got = i4.int4_matmul_stacked(x, packed, scales, 0, block_k=bk)
        assert (i4.launches, i4.launches_ksplit) == (before[0] + 1, before[1])
        assert torch.equal(got, whole)


# ---- the last three Pallas kernels: single-buffered decode attention on a
# bf16/f32 and an int8 cache, and the unstacked W4A16


def _single_case(dev, quant, B, S, dtype=torch.bfloat16, L=3, Hkv=8, Hq=24, hd=128, seed=0):
    from audio_llama_tpu_torch.models.llama import quantize_kv_rows

    q = _randn(dev, B, Hq, hd, dtype=dtype, seed=seed)
    if not quant:
        return dict(q=q, rows=[_randn(dev, B, Hkv, hd, dtype=dtype, seed=seed + i + 1)
                               for i in range(2)],
                    caches=[_randn(dev, L, B, Hkv, S, hd, dtype=dtype, seed=seed + i + 3)
                            for i in range(2)], scales=[])
    (ck, ks), (cv, vs) = (quantize_kv_rows(_randn(dev, L, B, Hkv, S, hd, dtype=torch.float32,
                                                  seed=seed + i + 3)) for i in range(2))
    (kn, ksn), (vn, vsn) = (quantize_kv_rows(_randn(dev, B, Hkv, hd, dtype=torch.float32,
                                                    seed=seed + i + 1)) for i in range(2))
    return dict(q=q, rows=[kn, vn], caches=[ck, cv], scales=[ks[1], vs[1], ksn, vsn])


def _single_call(case, off, valid, cuda, layer=1, rows=None):
    from audio_llama_tpu_torch.ops import decode_attention as da

    caches = [c.clone() for c in case["caches"]]
    scales = [s.clone() for s in case["scales"]]
    rows = rows or case["rows"]
    hd = case["q"].shape[-1]
    if scales:
        fn = da.decode_attention_quantized_cuda if cuda else da.decode_attention_quantized_plain
        out = fn(case["q"], *rows, *caches, *scales, layer, off, valid, hd ** -0.5)[0]
    else:
        fn = da.decode_attention_cuda if cuda else da.decode_attention_plain
        out = fn(case["q"], *rows, *caches, layer, off, valid, hd ** -0.5)[0]
    return out, caches, scales


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,off", [(1, 3040, 3016), (4, 1568, 1567), (4, 96, 96),
                                     (2, 64, 0)])
def test_single_decode_kernel(dev, quant, dtype, B, S, off):
    from audio_llama_tpu_torch.ops import decode_attention as da

    case = _single_case(dev, quant, B, S, dtype)
    valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
    valid[-1, 3:9] = 0
    before = (da.launches, da.launches_q8)
    got, gc, gs = _single_call(case, off, valid, cuda=True)
    want, wc, ws = _single_call(case, off, valid, cuda=False)
    torch.cuda.synchronize()
    assert (da.launches - before[0], da.launches_q8 - before[1]) == ((0, 1) if quant else (1, 0))
    kernel = "decode_attention_quantized" if quant else "decode_attention"
    _close(got, want, dtype, kernel)
    for g, w, c in zip(gc, wc, case["caches"]):
        assert torch.equal(g, w)
        changed = (g != c).any(dim=-1)
        if off < S:
            changed[1, :, :, off] = False
        assert not changed.any()
    for g, s in zip(gs, case["scales"]):
        assert torch.equal(g, s)  # the scale arrays are the caller's


@pytest.mark.parametrize("quant", [False, True])
def test_single_decode_check_rejects_planted_faults(dev, quant):
    """p not normalized (the division dropped) and a stale fresh row both
    fall outside the bar the kernel meets."""
    from chip_smoke import must_reject

    B, S, off = 4, 1568, 40
    case = _single_case(dev, quant, B, S)
    valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
    kernel = "decode_attention_quantized" if quant else "decode_attention"
    frac = ATOL_ROW_RMS_FRAC[kernel]
    want = _single_call(case, off, valid, cuda=False)[0]
    assert tol_ratio(_single_call(case, off, valid, cuda=True)[0], want, frac) <= 1
    stale = [c[1, :, :, off].clone() for c in case["caches"]]
    st_case = case
    if quant:  # the stale row with its own stale scales
        st_case = dict(case, scales=case["scales"][:2] + [case["scales"][0][:, :, off].clone(),
                                                          case["scales"][1][:, :, off].clone()])
    must_reject(kernel, "stale row", _single_call(st_case, off, valid, True, rows=stale)[0],
                want, frac)
    # unnormalized p: the plain version's output times the softmax denominator
    from audio_llama_tpu_torch.ops import decode_attention as da

    hd = case["q"].shape[-1]
    qf = case["q"].float().reshape(B, 8, 3, hd)
    k = case["caches"][0][1].clone()
    k[:, :, off] = case["rows"][0].to(k.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * hd ** -0.5
    if quant:
        ks = case["scales"][0].clone()
        ks[:, :, off] = case["scales"][2]
        logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * (ks * hd ** -0.5)[:, :, None]
    logits = torch.where((valid != 0)[:, None, None, :], logits, da.DEAD)
    den = torch.exp(logits - logits.amax(-1, keepdim=True)).sum(-1)  # [B, 8, 3]
    unnorm = want.float().reshape(B, 8, 3, hd) * den[..., None]
    must_reject(kernel, "p not normalized", unnorm.reshape(want.shape).to(want.dtype), want,
                frac)


def test_single_decode_refuses_a_timeline_past_shared_memory(dev):
    """One slot group past the timeline planner's cap (ops/decode_timeline.py:
    the largest range of 8 blocks no longer fits a block's shared memory)."""
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    S = dtl.max_slots(3, 128, "bf16") + 32
    case = _single_case(dev, False, 1, S, L=2)
    valid = torch.ones((1, S), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        _single_call(case, 5, valid, cuda=True)


# ---- the timeline decode core (csrc/decode_timeline.cuh): the single kernel
# (rows 29, 30) and the db kernels (rows 13-18) on clusters along the timeline

TIMELINE_KERNELS = [("single", 16), ("single", 8), ("db", 16), ("db", 8), ("db", 4),
                    ("stats", 16), ("stats", 8), ("stats", 4)]
TIMELINE_NAMES = {("single", 16): "decode_attention", ("single", 8): "decode_attention_quantized",
                  ("db", 16): "decode_attention_db", ("db", 8): "decode_attention_quantized_db",
                  ("db", 4): "decode_attention_quantized4_db"}


def _timeline_call(kind, case, bits, off, valid, cuda, li=1):
    """-> (out, or (m, l, acc), caches after) of one kernel or plain call."""
    from chip_smoke import ab_call, db_call, single_call

    scale = case["q"].shape[-1] ** -0.5
    if kind == "single":
        return single_call(case, bits, li, off, valid, scale, cuda=cuda)
    if kind == "db":
        return ab_call(TIMELINE_NAMES[kind, bits], case, bits, li, off, valid, scale, cuda=cuda)
    m, l, acc, caches = db_call(case, bits, li, off, valid, scale, cuda=cuda)
    return (m, l, acc), caches


def _timeline_check(kind, bits, case, off, valid, li=1):
    from chip_smoke import check_append, stats_ratio

    got, gc = _timeline_call(kind, case, bits, off, valid, True, li)
    want, wc = _timeline_call(kind, case, bits, off, valid, False, li)
    torch.cuda.synchronize()
    if kind == "stats":
        assert stats_ratio(got[0], want[0]) <= 1 and stats_ratio(got[1], want[1]) <= 1
        assert tol_ratio(got[2], want[2], ATOL_ROW_RMS_FRAC["decode_attention_db_stats"]) <= 1
        for g, w in zip(gc, wc):
            assert torch.equal(g, w)
    else:
        name = TIMELINE_NAMES[kind, bits]
        assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC[name]) <= 1
        check_append(name, gc, wc, case["caches"], case["rows"], li, off)
    return got


@pytest.mark.parametrize("kind,bits", TIMELINE_KERNELS)
@pytest.mark.parametrize("B,S", [(1, 3040), (4, 3040), (1, 1568), (4, 1568)])
def test_timeline_kernels_at_the_plans_clusters(dev, kind, bits, B, S):
    """Each kernel against its plain version at the plan's C for B 1 (8
    blocks a cluster) and B 4 (4), the offset on the first slot of rank 2's
    range and on the last of rank 1's."""
    from chip_smoke import db_case
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    case = db_case(dev, torch.Generator(device=dev).manual_seed(B + bits), bits, B, S, 2, 8,
                   24, 128)
    plan = dtl.timeline_plan(B, 8, S, 3, 128, "bf16" if bits == 16 else f"int{bits}")
    assert plan.C == (8 if B == 1 else 4)
    edge = plan.ranges(S)[2][0]
    for off in (edge, edge - 1):
        valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
        valid[-1, 3:9] = 0
        _timeline_check(kind, bits, case, off, valid)


@pytest.mark.parametrize("kind,bits", TIMELINE_KERNELS)
@pytest.mark.parametrize("G,hd", [(1, 128), (2, 64), (4, 128), (6, 64), (8, 128), (3, 32)])
def test_timeline_kernels_at_every_g(dev, kind, bits, G, hd):
    """Every query-head group the kernels take (the logits' tensor-core tile
    has G <= 8 columns), at hd 128, 64 and 32 (hd 32: int8 / int4 keys on
    the CUDA-core path), B 2, 3 blocks a cluster's worth of 96 slots."""
    from chip_smoke import db_case

    S, B = 96, 2
    case = db_case(dev, torch.Generator(device=dev).manual_seed(G + hd + bits), bits, B, S, 2,
                   2, 2 * G, hd)
    valid = (torch.arange(S, device=dev)[None, :] <= 70).to(torch.int32).repeat(B, 1)
    valid[1, 33:40] = 0
    _timeline_check(kind, bits, case, 70, valid)


@pytest.mark.parametrize("kind,bits", TIMELINE_KERNELS)
def test_timeline_kernels_past_the_one_block_cap(dev, kind, bits):
    """24000 slots: past the one-block kernels' [G, S] logits in 227 KB."""
    from chip_smoke import db_case

    S = 24000
    case = db_case(dev, torch.Generator(device=dev).manual_seed(bits), bits, 1, S, 2, 8, 24,
                   128)
    valid = (torch.arange(S, device=dev)[None, :] <= S - 7).to(torch.int32)
    valid[0, 1000:1400] = 0
    _timeline_check(kind, bits, case, S - 7, valid)


@pytest.mark.parametrize("kind,bits", TIMELINE_KERNELS)
def test_timeline_kernels_give_the_same_bits_twice(dev, kind, bits):
    from chip_smoke import db_case

    S, B = 3040, 2
    case = db_case(dev, torch.Generator(device=dev).manual_seed(3 + bits), bits, B, S, 2, 8, 24,
                   128)
    valid = (torch.arange(S, device=dev)[None, :] <= 2000).to(torch.int32).repeat(B, 1)
    first = _timeline_call(kind, case, bits, 2000, valid, True)
    again = _timeline_call(kind, case, bits, 2000, valid, True)
    for a, b in zip(first[0] if kind == "stats" else [first[0]],
                    again[0] if kind == "stats" else [again[0]]):
        assert torch.equal(a, b)
    for a, b in zip(first[1], again[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,fmt", [("db", "bf16"), ("db", "int8"), ("db", "int4"),
                                      ("db_stats", "bf16"), ("db_stats", "int8"),
                                      ("db_stats", "int4"), ("mono", "bf16"), ("mono", "f32"),
                                      ("packed", "bf16"), ("packed", "int8")])
@pytest.mark.parametrize("B,S", [(1, 3040), (4, 1568), (1, 24000)])
def test_timeline_kernel_info(dev, kind, fmt, B, S):
    """The launch's shared memory equals the planner's; no spill; the plan's
    clusters can be resident."""
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    chunk = pk.pick_chunk(S, pk.DEFAULT_CHUNK) if kind == "packed" else 0
    plan = dtl.timeline_plan(B, 8, S, 3, 128, fmt, chunk=chunk)
    info = dtl.kernel_info(kind, fmt, 0 if fmt == "f32" else 1, 3, S, 128, plan)
    assert info["smem_bytes"] == plan.smem
    assert info["local_bytes"] == 0 and info["clusters_resident"] >= 1


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M,K,N", [(4, 3072, 3072), (4, 8192, 3072), (300, 3072, 3072),
                                   (1, 256, 512)])
def test_int4_matmul_2d_kernel(dev, fmt, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K)
    packed = torch.randint(-128, 128, (K, N // 2), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
    scales = torch.rand((K // 128, N), generator=g, device=dev) * 0.02 + 0.002
    x = _randn(dev, M, K)
    before = (i4.launches_2d, i4.launches)
    got = i4.int4_matmul(x, packed, scales, fmt=fmt)
    torch.cuda.synchronize()
    assert (i4.launches_2d - before[0], i4.launches - before[1]) == (1, 0)
    assert tuple(got.shape) == (M, N) and got.dtype == torch.bfloat16
    _close(got, i4.int4_matmul_plain(x, packed, scales, fmt=fmt), torch.bfloat16, "int4_matmul")


def test_linear_w_p_branch_runs_the_2d_kernel(dev):
    from audio_llama_tpu_torch.models import llama

    K, N = 3072, 1024
    w = _randn(dev, K, N, dtype=torch.float32) * 0.05
    packed, scales = i4.quantize_pack(w)
    w_r = torch.rand(K, device=dev) + 0.5
    x = _randn(dev, 2, 3, K)
    for tree in ({"w_p": packed, "w_s": scales}, {"w_p": packed[:, None], "w_s": scales,
                                                  "w_r": w_r}):
        before = i4.launches_2d
        got = llama._linear(x, tree, None, torch.bfloat16)
        assert i4.launches_2d == before + 1
        xq = x * tree["w_r"].to(x.dtype) if "w_r" in tree else x
        _close(got, i4.int4_matmul_plain(xq, packed, scales), torch.bfloat16, "int4_matmul")


# ---- the int4 kernels' scale group (32, 64, 128, 256 on the card)


@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M,K,Nh,bk", [(4, 3072, 2560, 768), (1, 8192, 1536, 0),
                                       (200, 3072, 384, 768), (70, 1024, 256, 512),
                                       (127, 1536, 384, 768), (129, 1024, 128, 512),
                                       (1526, 3072, 2560, 768), (6104, 1536, 128, 768),
                                       # K blocks that end inside a 128-row tile
                                       (200, 1024, 128, 64), (1526, 1536, 384, 192)])
def test_int4_matmul_group_kernels(dev, group, fmt, M, K, Nh, bk):
    """The stacked W4A16 (whole K and K-split, one row and two planes) and
    the unstacked one at the group against their plain versions; group g
    read with group g+1's scale fails the same check."""
    L, N = 2, 2 * Nh
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // group, N, seed=1)
    x = _randn(dev, M, K, seed=2)
    for block_k in {0, bk}:
        want = i4.int4_matmul_stacked_plain(x, packed, scales, 1, group=group, fmt=fmt,
                                            block_k=block_k)
        before = (i4.launches, i4.launches_ksplit)
        got = i4.int4_matmul_stacked(x, packed, scales, 1, group=group, fmt=fmt,
                                     block_k=block_k)
        planes = i4.int4_matmul_stacked(x, packed, scales, 1, group=group, fmt=fmt,
                                        block_k=block_k, return_planes=True)
        torch.cuda.synchronize()
        assert (i4.launches + i4.launches_ksplit) == sum(before) + 2
        assert torch.equal(torch.cat(planes, dim=-1), got)
        assert _ratio(got, want, "int4_matmul_stacked") <= 1
        rolled = torch.roll(scales, -1, dims=1).contiguous()
        assert _ratio(i4.int4_matmul_stacked(x, packed, rolled, 1, group=group, fmt=fmt,
                                             block_k=block_k), want, "int4_matmul_stacked") > 1
    want = i4.int4_matmul_plain(x, packed[0], scales[0], group=group, fmt=fmt)
    before = i4.launches_2d
    got = i4.int4_matmul(x, packed[0], scales[0], group=group, fmt=fmt)
    torch.cuda.synchronize()
    assert i4.launches_2d == before + 1
    assert _ratio(got, want, "int4_matmul") <= 1
    rolled = torch.roll(scales[0], -1, dims=0).contiguous()
    assert _ratio(i4.int4_matmul(x, packed[0], rolled, group=group, fmt=fmt), want,
                  "int4_matmul") > 1


@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("dnr", [False, True])
@pytest.mark.parametrize("M,K,F,D", [(4, 3072, 8192, 3072), (9, 512, 1536, 512)])
def test_mlp_int4_group_kernel(dev, group, dnr, M, K, F, D):
    L = 2
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // group, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // group, D, seed=3)
    x = _randn(dev, M, K, seed=4)
    dn_r = _dnr(dev, L, F, D) if dnr else None
    chunk = mlp4.kernel_chunk(F, D // 2, group)
    assert chunk == max(128, group)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, 1, group=group, chunk=chunk,
                                       dn_r=dn_r)
    before = mlp4.launches + mlp4.launches_dnr
    got = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, group=group, chunk=chunk, dn_r=dn_r)
    torch.cuda.synchronize()
    assert mlp4.launches + mlp4.launches_dnr == before + 1
    assert _ratio(got, want, "mlp_int4_stacked") <= 1
    for rolled in ((torch.roll(gus, -1, dims=1), dns), (gus, torch.roll(dns, -1, dims=1))):
        gs, ds = (t.contiguous() for t in rolled)
        assert _ratio(mlp4.mlp_int4_stacked(x, gup, gs, dn, ds, 1, group=group, chunk=chunk,
                                            dn_r=dn_r), want, "mlp_int4_stacked") > 1


@pytest.mark.parametrize("M,group,bk", [(129, 256, 0), (1526, 128, 0), (6104, 32, 768),
                                        (255, 64, 512)])
def test_int4_prefill_rejects_planted_faults(dev, M, group, bk):
    """The prefill kernel's output passes its bar, and each of its planted
    faults (`chip_smoke.prefill_faults`: the nibble planes swapped in the
    epilogue, the second token tile's rows shifted by one, K tile 1 computed
    with tile 0's packed bytes as a stale ring stage would) fails it."""
    K, Nh, L = 1536, 384, 2
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // group, 2 * Nh, seed=1)
    x = _randn(dev, M, K, seed=2)

    def run(p=packed):
        return i4.int4_matmul_stacked(x, p, scales, 1, group=group, block_k=bk)

    want = i4.int4_matmul_stacked_plain(x, packed, scales, 1, group=group, block_k=bk)
    got = run()
    assert _ratio(got, want, "int4_matmul_stacked") <= 1
    faults = prefill_faults(got, want, ATOL_ROW_RMS_FRAC["int4_matmul_stacked"], run, packed, 1)
    assert len(faults) == 3 and min(faults.values()) > 1, faults


@pytest.mark.parametrize("name", list(i4.SM90_KINDS))
@pytest.mark.parametrize("group", [16, 32, 64, 128, 256])
def test_int4_prefill_kernel_info(dev, name, group):
    """Every instance of the prefill kernel fits one block of 384 threads an
    SM at its launch register count (the consumers' 232 after setmaxnreg and
    the producer's 40 fill the same 65,536), with no local memory."""
    info = i4.sm90_kernel_info(name, group)
    assert info["registers"] * 384 <= 65536 and info["registers"] <= 232, info
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 1, info
    assert info["smem_bytes"] <= 232448, info


def test_int4_kernels_refuse_group_48(dev):
    K, Nh, F, D = 3072, 256, 1536, 512
    x = _randn(dev, 4, K)
    packed, scales = _bytes(dev, 2, K, Nh), _scales(dev, 2, K // 48, 2 * Nh)
    gup, gus = _bytes(dev, 2, K, F), _scales(dev, 2, K // 48, 2 * F)
    dn, dns = _bytes(dev, 2, F, D // 2), _scales(dev, 2, F // 48, D)
    calls = (
        lambda: i4.int4_matmul_stacked(x, packed, scales, 0, group=48),
        lambda: i4.int4_matmul_stacked(x, packed, scales, 0, group=48, block_k=768),
        lambda: i4.int4_matmul(x, packed[0], scales[0], group=48),
        lambda: mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 0, group=48, chunk=192),
    )
    before = (i4.launches, i4.launches_ksplit, i4.launches_2d, mlp4.launches)
    for call in calls:
        with pytest.raises(ValueError, match="multiple of 16 that divides 128"):
            call()
    assert (i4.launches, i4.launches_ksplit, i4.launches_2d, mlp4.launches) == before


# -- the int4 decode kernels on the weight-streaming core (int4_common.cuh) ----

DECODE_M = (1, 2, 4, 8, 9, 16, 33, 64)  # every instance and its edges


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("M", DECODE_M)
def test_int4_decode_kernel_at_every_row_count(dev, M, group, fmt):
    """The W4A16's decode shape at q|k|v's widths (K 3072, N 5120): whole K,
    the K-split at block_k 768 and 1536, and the 2-D launch at q_proj's
    (N 3072), each within the bar of its plain version, two launches giving
    the same bits, one launch counted a call."""
    K, Nh, L = 3072, 2560, 2
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // group, 2 * Nh, seed=1)
    x = _randn(dev, M, K, seed=2)
    for bk in (0, 768, 1536):
        want = i4.int4_matmul_stacked_plain(x, packed, scales, 1, group, fmt=fmt, block_k=bk)
        before = (i4.launches, i4.launches_ksplit)
        got = i4.int4_matmul_stacked(x, packed, scales, 1, group, fmt=fmt, block_k=bk)
        again = i4.int4_matmul_stacked(x, packed, scales, 1, group, fmt=fmt, block_k=bk)
        torch.cuda.synchronize()
        assert (i4.launches, i4.launches_ksplit) == \
            (before[0] + 2 * (not bk), before[1] + 2 * bool(bk))
        assert torch.equal(got, again)
        assert _ratio(got, want, "int4_matmul_stacked") <= 1
    p2, s2 = packed[0, :, :1536].contiguous(), scales[0, :, :3072].contiguous()
    before = i4.launches_2d
    got = i4.int4_matmul(x, p2, s2, group, fmt=fmt)
    assert torch.equal(got, i4.int4_matmul(x, p2, s2, group, fmt=fmt))
    assert i4.launches_2d == before + 2
    assert _ratio(got, i4.int4_matmul_plain(x, p2, s2, group, fmt=fmt), "int4_matmul") <= 1


@pytest.mark.parametrize("dnr", [False, True])
@pytest.mark.parametrize("group", [32, 128, 256])
@pytest.mark.parametrize("M", DECODE_M)
@pytest.mark.parametrize("K,F,D", [(3072, 8192, 3072), (256, 1024, 256)])
def test_mlp_int4_kernel_at_every_row_count(dev, K, F, D, M, group, dnr):
    """The fused MLP in both modes at the 3B widths and toy widths: within
    the bar of its plain version, two launches giving the same bits, one
    launch counted a call in its mode's counter."""
    L = 2
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // group, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // group, D, seed=3)
    x = _randn(dev, M, K, seed=4) * 0.5
    dn_r = _dnr(dev, L, F, D) if dnr else None
    chunk = mlp4.kernel_chunk(F, D // 2, group)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, 1, group, chunk, dn_r=dn_r)
    before = (mlp4.launches, mlp4.launches_dnr)
    got = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, group, chunk, dn_r=dn_r)
    again = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, group, chunk, dn_r=dn_r)
    torch.cuda.synchronize()
    assert (mlp4.launches, mlp4.launches_dnr) == \
        (before[0] + 2 * (not dnr), before[1] + 2 * dnr)
    assert torch.equal(got, again)
    assert _ratio(got, want, "mlp_int4_stacked") <= 1


@pytest.mark.parametrize("M", [1, 4, 64])
def test_int4_decode_checks_reject_the_new_mechanisms_faults(dev, M):
    """chip_smoke's planted faults of the decode core: a K slice left out of
    the cluster sum, a stale batch; the MLP's activations read from the next
    tile, a gate|up slice and a down K chunk left out, a stale batch."""
    K, Nh, L = 3072, 2560, 2
    packed, scales = _bytes(dev, L, K, Nh), _scales(dev, L, K // 128, 2 * Nh, seed=1)
    x = _randn(dev, M, K, seed=2)

    def run(p=packed):
        return i4.int4_matmul_stacked(x, p, scales, 1)

    want = i4.int4_matmul_stacked_plain(x, packed, scales, 1)
    got = run()
    frac = ATOL_ROW_RMS_FRAC["int4_matmul_stacked"]
    faults = decode_faults(got, want, frac, run, packed, 1, x, i4.decode_plan(M, K, Nh),
                           lambda xx, p: i4.int4_matmul_stacked_plain(xx, p, scales, 1))
    assert len(faults) == 2 and min(faults.values()) > 1, faults
    F, D = 8192, 3072
    gup, gus = _bytes(dev, L, K, F), _scales(dev, L, K // 128, 2 * F, seed=1)
    dn, dns = _bytes(dev, L, F, D // 2, seed=2), _scales(dev, L, F // 128, D, seed=3)
    chunk = mlp4.kernel_chunk(F, D // 2)
    want = mlp4.mlp_int4_stacked_plain(x, gup, gus, dn, dns, 1, chunk=chunk)
    got = mlp4.mlp_int4_stacked(x, gup, gus, dn, dns, 1, chunk=chunk)
    faults = mlp_faults(got, want, ATOL_ROW_RMS_FRAC["mlp_int4_stacked"], x, gup, gus, dn, dns,
                        1, 128, lambda xx, gp, gs, ds: mlp4.mlp_int4_stacked_plain(
                            xx, gp, gs, dn, ds, 1, chunk=chunk))
    assert len(faults) == 4 and min(faults.values()) > 1, faults


@pytest.mark.parametrize("M", [4, 16, 32, 64])
def test_int4_decode_kernel_info(dev, M):
    """Each decode instance of both kernels at the 3B plans (groups 32 and
    128; whole K, the K-split at 768 and K 8192): no local memory, at least
    one block an SM, and the shared memory its launch asks for (the C side's
    `unit_smem`) equal to the plan's (the planners' copy)."""
    for group in (32, 128):
        for K, Nh, bk in ((3072, 2560, 0), (3072, 2560, 768), (8192, 1536, 0)):
            plan = i4.decode_plan(M, K, Nh, group, bk)
            info = i4.decode_kernel_info(M, K // plan.C, group)
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (K, bk, info)
            assert info["smem_bytes"] == plan.smem, (K, bk, plan, info)
        mlp = mlp4.mlp_plan(M, 3072, 8192, 1536, group)
        info = mlp4.kernel_info(M, 3072, 8192, mlp, group)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info
        assert info["smem_bytes"] == mlp.smem, (mlp, info)


# ---- row 4 (the mono mode) and row 19 (the chunk mode) on the timeline core ----

def _mono_case(dev, B, S, L=3, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return dict(q=randn(B, 24, 128), kn=randn(B, 8, 128), vn=randn(B, 8, 128),
                ck=randn(L, B, 8, S, 128), cv=randn(L, B, 8, S, 128))


def _mono_call(case, off, valid, kernel=True, li=1):
    ck, cv = case["ck"].clone(), case["cv"].clone()
    fn = dm.decode_attention_cuda if kernel else dm.decode_attention_plain
    out = fn(case["q"], case["kn"], case["vn"], ck, cv, li, off, valid, 128 ** -0.5)[0]
    return out, ck, cv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1568, 3040])
def test_mono_kernel_at_b4_with_four_offsets(dev, dtype, S):
    """Row 4 at B 4, each row at its own offset on the device (a range
    boundary of the plan, an early slot, one past the timeline, S - 1),
    against the plain version: the output within the bar, the caches
    bit-equal; a second launch gives the same bits."""
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    B = 4
    plan = dtl.timeline_plan(B, 8, S, 3, 128, dtl.cache_fmt(dtype))
    offs = torch.tensor([plan.ranges(S)[2][0], 41, S + 3, S - 1], dtype=torch.int32,
                        device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= offs[:, None]).to(torch.int32)
    valid[0, 7:30] = 0
    case = _mono_case(dev, B, S, dtype=dtype, seed=S)
    before = dm.launches
    got, gk, gv = _mono_call(case, offs, valid)
    want, wk, wv = _mono_call(case, offs, valid, kernel=False)
    again = _mono_call(case, offs, valid)[0]
    torch.cuda.synchronize()
    assert dm.launches == before + 2
    _close(got, want, dtype, "decode_attention_mono")
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(got, again)


def test_mono_kernel_rows_fully_masked_and_past_shared_memory(dev):
    """A fully masked row gives 0, as the plain version; 24000 slots (past the
    one-block design's 227 KB cap) within the bar."""
    S = 24000
    case = _mono_case(dev, 2, S, L=2, seed=5)
    offs = torch.tensor([S - 9, 100], dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= offs[:, None]).to(torch.int32)
    valid[1] = 0
    got = _mono_call(case, offs, valid)[0]
    want = _mono_call(case, offs, valid, kernel=False)[0]
    torch.cuda.synchronize()
    assert not got[1].any()
    _close(got, want, torch.bfloat16, "decode_attention_mono")


def test_mono_check_rejects_another_rows_offset(dev):
    """Row 1's offset read for row 0: the fresh row lands on a slot row 0 does
    not attend, and row 0's own slot is read stale."""
    S = 1568
    case = _mono_case(dev, 4, S, seed=9)
    offs = torch.tensor([40, 800, 1100, 1557], dtype=torch.int32, device=dev)
    valid = (torch.arange(S, device=dev)[None, :] <= offs[:, None]).to(torch.int32)
    want = _mono_call(case, offs, valid, kernel=False)[0]
    wrong = offs.clone()
    wrong[0] = offs[1]
    got = _mono_call(case, wrong, valid)[0]
    assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC["decode_attention_mono"]) > 1


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("S", [1568, 3040])
def test_packed_kernel_at_b4_with_four_offsets(dev, bits, S):
    """Row 19 at B 4 (4 blocks a cluster, uneven chunks a block at 3040), four
    offsets (a chunk boundary, a block's range boundary, the first slot,
    S - 1), against the plain version with the caches bit-equal; each call
    launched twice gives the same bits."""
    from chip_smoke import ab_call, check_append
    from audio_llama_tpu_torch.ops import decode_attention_packed as pk
    from audio_llama_tpu_torch.ops import decode_timeline as dtl

    B, name = 4, "decode_attention_packed"
    CH = pk.pick_chunk(S, pk.DEFAULT_CHUNK)
    plan = dtl.timeline_plan(B, 8, S, 3, 128, "bf16" if bits == 16 else "int8", chunk=CH)
    case = _ab_case(dev, bits, B, S, 24, 8, 128, seed=S)
    for off in (3 * CH, plan.ranges(S)[1][0], 0, S - 1):
        valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
        valid[2, :CH] = 0  # a masked leading chunk in one row
        valid[2, off] = 1
        got, gc = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5)
        again = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5)[0]
        want, wc = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5, cuda=False)
        torch.cuda.synchronize()
        _close(got, want, torch.bfloat16, name)
        check_append(name, gc, wc, case["caches"], case["rows"], 1, off)
        assert torch.equal(got, again)


@pytest.mark.parametrize("bits", [16, 8])
def test_packed_check_rejects_a_rank_left_out_of_the_running_max(dev, bits):
    """The planted fault: the blocks after rank 1 start their walk without its
    chunks' maxima."""
    from chip_smoke import ab_call

    S, B, name = 3040, 4, "decode_attention_packed"
    case = _ab_case(dev, bits, B, S, 24, 8, 128, seed=11)
    off = S - 24
    valid = (torch.arange(S, device=dev)[None, :] <= off).to(torch.int32).repeat(B, 1)
    want = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5, cuda=False)[0]
    got = ab_call(name, case, bits, 1, off, valid, 128 ** -0.5, skip_rank=1)[0]
    assert tol_ratio(got, want, ATOL_ROW_RMS_FRAC[name]) > 1
