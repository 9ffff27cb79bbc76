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

from chip_smoke import ATOL_ROW_RMS_FRAC, GRAD_RMS_DIMS, tol_ratio  # noqa: E402
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


@pytest.mark.parametrize("T,H,hd,valid", [(1536, 20, 64, 1500), (128, 4, 16, 64),
                                          (256, 2, 128, None)])
def test_enc_attention_kernel(dev, T, H, hd, valid):
    q, k, v = (_randn(dev, 2, T, H * hd, seed=i).view(2, T, H, hd) for i in range(3))
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
                                    (200, 512, 384), (6104, 3072, 128)])
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


# the full model's widths at 2 layers, and the JAX megakernel test's geometry
MK_WIDTHS = {
    "3b": dict(hidden_size=3072, intermediate_size=8192, num_heads=24, num_kv_heads=8),
    "tiny": dict(hidden_size=256, intermediate_size=256, num_heads=2, num_kv_heads=1,
                 rope_scaling=None),
}


@pytest.mark.parametrize("widths", ["3b", "tiny"])
@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_megakernel_kernel(dev, widths, fmt):
    """Each layer within the bar of the plain version on the same input, and
    the one-launch stack equal to its layers launched one by one."""
    from chip_smoke import mega_layerwise, mega_run, megakernel_case
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = _Widths(num_layers=2, head_dim=128, **MK_WIDTHS[widths])
    case = megakernel_case(dev, gen, fmt, 2, 256, 200, cfg=cfg)
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
    assert d.max() <= 2 and (d > 0).float().mean().item() * 256 < 0.01
    for g, w in zip(got[2:], want[2:]):  # the scale slabs, then the fresh scales
        torch.testing.assert_close(g, w, rtol=2.0 ** -7, atol=0)
    # barriers only: the same launch shape runs and is not counted
    before = mk.launches
    mk.decode_megakernel_cuda(**case, barriers_only=True)
    torch.cuda.synchronize()
    assert mk.launches == before


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_megakernel_check_rejects_planted_faults(dev, fmt):
    from chip_smoke import FAULT_MARGIN, mega_layerwise, megakernel_case, megakernel_faults

    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = _Widths(num_layers=4, head_dim=128, **MK_WIDTHS["3b"])
    case = megakernel_case(dev, gen, fmt, 4, 256, 2, cfg=cfg)
    assert mega_layerwise(case)[0] <= 1
    assert min(megakernel_faults(case).values()) > FAULT_MARGIN


def test_megakernel_gate_on_the_card(dev):
    """ok_for asks the occupancy API on the card; a refused geometry (a full
    cache) keeps the per-layer path."""
    from audio_llama_tpu_torch.config import LlamaConfig
    from audio_llama_tpu_torch.ops import decode_megakernel as mk

    lc = LlamaConfig(num_layers=2)
    slabs = {n: {"w_p": torch.empty((2, K, N // 2), dtype=torch.int8, device=dev),
                 "w_s": torch.empty((2, K // 128, N), device=dev)}
             for n, K, N in (("qkv_proj", 3072, 5120), ("o_proj", 3072, 3072),
                             ("gateup_proj", 3072, 16384), ("down_proj", 8192, 3072))}
    assert mk.ok_for(lc, slabs, 1568, 1556, dev)
    assert not mk.ok_for(lc, slabs, 1568, 1568, dev)


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


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,pad", [(2, 512, 24, 8, 128, 34), (1, 256, 4, 2, 64, 0),
                                               (2, 128, 6, 6, 32, 5), (2, 128, 4, 2, 16, 3)])
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
                                                    (2, 128, 4, 2, 16, 100)])
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
