"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here carries the `cuda` marker and skips on a host
without a CUDA device; the skip is decided inside a fixture, so every pytest
worker collects the same tests.

This file imports torch only: the card's machine has no JAX. Run it there
with `python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q`
(the repo's conftest imports JAX).

Tolerances: bf16 outputs within chip_smoke's per-kernel bar, one bf16 ulp
relative plus a fraction of the output row's RMS
(`chip_smoke.ATOL_ROW_RMS_FRAC`),
which a one-key mask fault exceeds (the planted-fault tests below); f32
within 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from chip_smoke import ATOL_ROW_RMS_FRAC, tol_ratio  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402
from audio_llama_tpu_torch.ops import enc_attention as ea  # noqa: E402
from audio_llama_tpu_torch.ops import layer_norm as ln  # noqa: E402

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
