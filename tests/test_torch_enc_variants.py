"""The port's encoder-attention variants (algo v3q, bounded, twopass; v3's
bounded softmax) against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed (B 2, T 256, H 4, hd 64, as
tests/test_enc_attention.py:146-175) and handed to both packages; on the CPU
the port's `enc_attention` runs each kernel's plain version. Bars:
  bounded, twopass (f32 exp), v3 bounded: atol = rtol = 2e-5 at f32 (the same
      f32 products summed in another order);
  twopass with a bf16 exp: 1e-2 against JAX's kernel (a bf16 exp may round
      an argument or a result one bf16 ulp apart), and JAX's own 6e-2 against
      the XLA `mha`;
  v3q: q's and v's int8 tensors and `sv` equal to JAX's wrapper's; `c`
      within two f32 ulps and k's int8 copy up to a stated count of one-level
      flips, because K's timeline mean is an f32 sum in another order (XLA
      on the CPU sums windows of 32 rows; the port takes torch's sum), which
      moves sk by an ulp in some heads; the output within rel-L2 1e-3 of JAX's
      kernel on the valid rows (a pq at a rounding tie of exp may land one
      level apart) and within 0.02 of the XLA `mha`, JAX's bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(2)

from audio_llama_tpu.ops import enc_attention as j_ea  # noqa: E402
from audio_llama_tpu.ops.attention import mha, padding_bias  # noqa: E402
from audio_llama_tpu_torch.bridge import to_tensor  # noqa: E402
from audio_llama_tpu_torch.ops import enc_attention as t_ea  # noqa: E402

B, T, H, HD = 2, 256, 4, 64
TOL = 2e-5


def _inputs(seed, k_offset=0.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, HD)).astype(np.float32) * 0.5 for _ in range(3))
    return q, (k + k_offset).astype(dtype), v


def _t(x):
    return to_tensor(x, torch.device("cpu"))


def _jax(q, k, v, valid, **kw):
    return np.asarray(j_ea.enc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         valid_len=valid, interpret=True, **kw), np.float32)


def _port(q, k, v, valid, **kw):
    return t_ea.enc_attention(_t(q), _t(k), _t(v), valid_len=valid, **kw).float().numpy()


def _xla_ref(q, k, v, valid):
    if valid is None:
        return np.asarray(mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    mask = jnp.asarray(np.arange(T)[None, :].repeat(B, 0) < valid, jnp.int32)
    return np.asarray(mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          bias=padding_bias(mask)))


@pytest.mark.parametrize("valid", [200, None])
@pytest.mark.parametrize("algo,softmax", [("bounded", "safe"), ("twopass", "safe"),
                                          ("v3", "bounded")])
def test_bf16_kernel_variants_match_pallas(algo, softmax, valid):
    q, k, v = _inputs(1)
    n = T if valid is None else valid
    got = _port(q, k, v, valid, algo=algo, softmax=softmax)
    want = _jax(q, k, v, valid, algo=algo, softmax=softmax)
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("valid", [200, None])
def test_twopass_bf16_exp(valid):
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(2))
    n = T if valid is None else valid
    got = _port(q, k, v, valid, algo="twopass", exp_dtype=torch.bfloat16)
    want = _jax(q, k, v, valid, algo="twopass", exp_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=1e-2, rtol=1e-2)
    ref = np.asarray(_xla_ref(q, k, v, valid), np.float32)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=6e-2, rtol=6e-2)


@jax.jit
def _jax_v3q_jit(qf, kf, vf, scale):
    sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1) / 127.0, 1e-8)
    q_i8 = jnp.round(qf / sq[..., None]).astype(jnp.int8)
    kc = kf - jnp.mean(kf, axis=1, keepdims=True)
    sk = jnp.maximum(jnp.max(jnp.abs(kc), axis=(1, 3)) / 127.0, 1e-8)
    k_i8 = jnp.round(kc / sk[:, None, :, None]).astype(jnp.int8)
    sv = jnp.maximum(jnp.max(jnp.abs(vf), axis=1) / 127.0, 1e-8)
    v_i8 = jnp.round(vf / sv[:, None]).astype(jnp.int8)
    c = (sq * sk[:, None, :] * scale).astype(jnp.float32)
    return q_i8, k_i8, v_i8, c, sv


def _jax_v3q_tensors(q, k, v, scale):
    """The JAX v3q wrapper's quantization (enc_attention.py:363-378): its
    expressions, jitted as the wrapper is."""
    args = (jnp.asarray(x, jnp.float32) for x in (q, k, v))
    return [np.asarray(x) for x in _jax_v3q_jit(*args, jnp.float32(scale))]


K_I8_FLIPS_MAX = 4  # one-level flips of k's int8 copy allowed, of 131072 entries


def test_v3q_quantize_matches_the_jax_wrapper():
    q, k, v = _inputs(7, k_offset=0.7)
    scale = HD ** -0.5
    jq, jk, jv, jc, jsv = _jax_v3q_tensors(q, k, v, scale)
    tq, tk, tvt, tc, tsv = (x.numpy() for x in t_ea.v3q_quantize(_t(q), _t(k), _t(v), scale))
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tvt.transpose(0, 3, 1, 2), jv)
    np.testing.assert_array_equal(tsv, jsv)
    np.testing.assert_array_max_ulp(tc, jc, maxulp=2)
    diff = np.abs(tk.astype(np.int32) - jk.astype(np.int32))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= K_I8_FLIPS_MAX, int((diff > 0).sum())


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("valid", [200, None])
def test_v3q_matches_pallas_and_xla(valid):
    q, k, v = _inputs(7, k_offset=0.7)
    n = T if valid is None else valid
    got = _port(q, k, v, valid, algo="v3q")[:, :n]
    want = _jax(q, k, v, valid, algo="v3q")[:, :n]
    assert _rel(got, want) < 1e-3, _rel(got, want)
    ref = _xla_ref(q, k, v, valid)[:, :n]
    assert _rel(got, ref) < 0.02, _rel(got, ref)


def test_v3q_plain_on_jax_quantized_tensors_matches_pallas():
    """The kernel's plain version alone, fed JAX's own int8 tensors and
    scales: the gap to JAX's kernel is exp's rounding only."""
    q, k, v = _inputs(8, k_offset=0.7)
    jq, jk, jv, jc, jsv = _jax_v3q_tensors(q, k, v, HD ** -0.5)
    got = t_ea.enc_attention_v3q_plain(
        _t(jq), _t(jk), _t(jv.transpose(0, 2, 3, 1)), _t(jc), _t(jsv), 200,
        torch.float32).numpy()[:, :200]
    want = _jax(q, k, v, 200, algo="v3q")[:, :200]
    assert _rel(got, want) < 1e-4, _rel(got, want)


def test_v3q_statistics_span_the_padded_rows():
    """mu, sk and sv are taken over all T rows, padded ones included (they are
    not zero in the encoder: biases reach them). Statistics over the valid
    rows only are another function, which the bar above must reject."""
    q, k, v = _inputs(9, k_offset=0.7)
    rng = np.random.default_rng(10)
    valid = 200
    k[:, valid:] += rng.normal(size=k[:, valid:].shape).astype(np.float32) * 3.0
    v[:, valid:] *= 6.0
    want = _jax(q, k, v, valid, algo="v3q")[:, :valid]
    got = _port(q, k, v, valid, algo="v3q")[:, :valid]
    assert _rel(got, want) < 1e-3
    # the same scheme with its statistics over the valid rows (the padded
    # rows' int8 values do not matter: they are masked keys and unread rows)
    wq, wk, wvt, wc, wsv = t_ea.v3q_quantize(_t(q)[:, :valid], _t(k)[:, :valid],
                                             _t(v)[:, :valid], HD ** -0.5)
    pad = T - valid
    bad = t_ea.enc_attention_v3q_plain(
        F.pad(wq, (0, 0, 0, 0, 0, pad)), F.pad(wk, (0, 0, 0, 0, 0, pad)), F.pad(wvt, (0, pad)),
        F.pad(wc, (0, 0, 0, pad)), wsv, valid, torch.float32).numpy()[:, :valid]
    assert _rel(bad, want) > 1e-2, _rel(bad, want)


def test_outlier_magnitudes():
    """tests/test_enc_attention.py::test_outlier_magnitudes_safe_softmax on the
    port: v3 'safe' stays exact at outlier key magnitudes; the bounded shift
    underflows and zeroes rows, exactly as JAX's does (kept, not repaired),
    in both of its layouts."""
    rng = np.random.default_rng(0)
    Bo, To, Ho = 1, 256, 2
    q = rng.normal(size=(Bo, To, Ho, HD)).astype(np.float32) * 2.0
    k = rng.normal(size=(Bo, To, Ho, HD)).astype(np.float32) * 2.0
    d = rng.normal(size=(HD,)).astype(np.float32)
    k[:, 0] = d / np.linalg.norm(d) * 1200.0
    v = rng.normal(size=(Bo, To, Ho, HD)).astype(np.float32)
    ref = np.asarray(mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=None,
                         scale=HD ** -0.5))
    safe = t_ea.enc_attention(_t(q), _t(k), _t(v), scale=HD ** -0.5).numpy()
    np.testing.assert_allclose(safe, ref, atol=2e-4, rtol=2e-4)
    j_bad = np.asarray(j_ea.enc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          scale=HD ** -0.5, interpret=True,
                                          softmax="bounded"))
    for kw in (dict(softmax="bounded"), dict(algo="bounded")):
        bad = t_ea.enc_attention(_t(q), _t(k), _t(v), scale=HD ** -0.5, **kw).numpy()
        assert float(np.abs(bad - ref).max()) > 0.1
        zero_rows = (bad == 0).all(axis=-1)
        np.testing.assert_array_equal(zero_rows, (j_bad == 0).all(axis=-1))
        assert zero_rows.any()
        np.testing.assert_allclose(bad, j_bad, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kw", [dict(algo="v4"), dict(algo="v3q", softmax="bounded"),
                                dict(algo="twopass", softmax="bounded"),
                                dict(algo="v3", softmax="online"),
                                dict(algo="v3", exp_dtype=torch.bfloat16),
                                dict(algo="bounded", exp_dtype=torch.float16)])
def test_enc_attention_refuses_what_it_does_not_run(kw):
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError):
        t_ea.enc_attention(q, q, q, **kw)


def test_new_wrappers_take_the_plain_version_only_on_cpu():
    """On CPU tensors the kernels are never launched; the CUDA entry points
    refuse CPU tensors."""
    q, k, v = (_t(x) for x in _inputs(3))
    counts = (t_ea.launches_v3q, t_ea.launches_bounded, t_ea.launches_twopass)
    for algo in ("v3q", "bounded", "twopass"):
        t_ea.enc_attention(q, k, v, valid_len=200, algo=algo)
    assert (t_ea.launches_v3q, t_ea.launches_bounded, t_ea.launches_twopass) == counts
    kn = t_ea.key_norm_max(k)
    for call in (lambda: t_ea.enc_attention_bounded_cuda(q, k, v, kn, 200),
                 lambda: t_ea.enc_attention_twopass_cuda(q, k, v, 200),
                 lambda: t_ea.enc_attention_v3q_cuda(*t_ea.v3q_quantize(q, k, v, 0.125), 200)):
        with pytest.raises(ValueError):
            call()
