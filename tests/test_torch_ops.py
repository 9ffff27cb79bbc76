"""Port ops (audio_llama_tpu_torch.ops) against the JAX package at f32.

Inputs are made with numpy from a seed and handed to both packages. Each
kernel's plain PyTorch version (the CPU path of its wrapper) is held against
the JAX Pallas kernel in interpret mode and against the JAX XLA path.
Tolerances: 2e-5 for f32 elementwise ops and single attention calls (f32
sums in another order), exact for sampling masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaConfig  # noqa: E402
from audio_llama_tpu.ops import attention as j_att  # noqa: E402
from audio_llama_tpu.ops import norms as j_norms  # noqa: E402
from audio_llama_tpu.ops import rope as j_rope  # noqa: E402
from audio_llama_tpu.ops import sampling as j_samp  # noqa: E402
from audio_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.ops import attention as t_att  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as t_ca  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as t_dm  # noqa: E402
from audio_llama_tpu_torch.ops import enc_attention as t_ea  # noqa: E402
from audio_llama_tpu_torch.ops import layer_norm as t_ln  # noqa: E402
from audio_llama_tpu_torch.ops import norms as t_norms  # noqa: E402
from audio_llama_tpu_torch.ops import rope as t_rope  # noqa: E402
from audio_llama_tpu_torch.ops import sampling as t_samp  # noqa: E402

TOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 2 + 0.3
    s = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(
        t_norms.rms_norm(_t(x), _t(s), 1e-5).numpy(),
        _np(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        t_norms.layer_norm(_t(x), _t(s), _t(b), 1e-5).numpy(),
        _np(j_norms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scaled", [True, False])
def test_rope_matches(scaled):
    cfg = LlamaConfig() if scaled else LlamaConfig.tiny()
    jcfg = JLlamaConfig() if scaled else JLlamaConfig.tiny()
    inv_t = t_rope.rope_for_config(cfg)
    inv_j = j_rope.rope_for_config(jcfg)
    np.testing.assert_array_equal(inv_t, inv_j)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 9000, (2, 6)).astype(np.int32)
    x = rng.normal(size=(2, 6, 3, cfg.head_dim)).astype(np.float32)
    cos_t, sin_t = t_rope.rope_tables(_t(pos), inv_t)
    cos_j, sin_j = j_rope.rope_tables(jnp.asarray(pos), inv_j)
    np.testing.assert_allclose(cos_t.numpy(), _np(cos_j), atol=TOL)
    np.testing.assert_allclose(sin_t.numpy(), _np(sin_j), atol=TOL)
    np.testing.assert_allclose(
        t_rope.apply_rope(_t(x), cos_t, sin_t).numpy(),
        _np(j_rope.apply_rope(jnp.asarray(x), cos_j, sin_j)), atol=1e-4, rtol=TOL)


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.7, 0.9, 0), (1.0, 1.0, 5), (0.5, 0.6, 7), (1.3, 0.95, 0),
])
def test_sampling_filters_match(temperature, top_p, top_k):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 64)) * 3).astype(np.float32)
    got = t_samp.filtered_logits(_t(logits), temperature, top_p, top_k).numpy()
    want = _np(j_samp.filtered_logits(jnp.asarray(logits), temperature, top_p, top_k))
    # the same tokens survive, with the same tempered logits
    np.testing.assert_array_equal(got > -1e30, want > -1e30)
    keep = want > -1e30
    np.testing.assert_allclose(got[keep], want[keep], atol=TOL, rtol=TOL)


def test_greedy_sample_is_argmax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    got = t_samp.sample_token(_t(logits), None, greedy=True).numpy()
    want = np.asarray(j_samp.sample_token(jnp.asarray(logits), None, greedy=True))
    np.testing.assert_array_equal(got, want)


def test_mha_matches_xla_path():
    rng = np.random.default_rng(4)
    B, Tq, Tk, Hq, Hkv, hd = 2, 5, 9, 4, 2, 8
    q = rng.normal(size=(B, Tq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Tk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Tk, Hkv, hd)).astype(np.float32)
    mask = np.ones((B, Tk), np.int32)
    mask[1, 7:] = 0
    bias_t = t_att.combine_bias(t_att.causal_bias(Tq, Tk, offset=4), t_att.padding_bias(_t(mask)))
    bias_j = j_att.combine_bias(j_att.causal_bias(Tq, Tk, offset=4),
                                j_att.padding_bias(jnp.asarray(mask)))
    np.testing.assert_array_equal(bias_t.numpy(), _np(bias_j))
    got = t_att.mha(_t(q), _t(k), _t(v), bias=bias_t)
    want = j_att.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias_j)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the kernels' plain versions vs the Pallas kernels (interpret) and XLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 256, 64), (3, 7, 64)])
def test_layer_norm_plain_matches_pallas(shape):
    from audio_llama_tpu.ops.ln_pallas import layer_norm_pallas

    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    s = (rng.normal(size=shape[-1:]) * 0.1 + 1).astype(np.float32)
    b = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    got = t_ln.layer_norm(_t(x), _t(s), _t(b), 1e-5).numpy()
    pallas = layer_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5,
                               interpret=True)
    xla = j_norms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(got, _np(pallas), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _np(xla), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("valid", [None, 100])
def test_enc_attention_plain_matches_pallas(valid):
    from audio_llama_tpu.ops.enc_attention import enc_attention

    rng = np.random.default_rng(6)
    B, T, H, hd = 1, 128, 2, 64
    q, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32) for _ in range(3))
    got = t_ea.enc_attention(_t(q), _t(k), _t(v), valid_len=valid, scale=hd ** -0.5).numpy()
    pallas = enc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid_len=valid,
                           scale=hd ** -0.5, interpret=True, algo="v3")
    n = T if valid is None else valid
    bias = None
    if valid is not None:
        mask = np.zeros((B, T), np.int32)
        mask[:, :valid] = 1
        bias = j_att.padding_bias(jnp.asarray(mask))
    xla = j_att.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias)
    # padded query rows are unspecified in both packages: compare valid rows
    np.testing.assert_allclose(got[:, :n], _np(pallas)[:, :n], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[:, :n], _np(xla)[:, :n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T", [128, 100])
def test_causal_attention_plain_matches_pallas(T):
    from audio_llama_tpu.ops.causal_attention import causal_mha

    rng = np.random.default_rng(7)
    B, Hq, Hkv, hd = 2, 4, 2, 32
    q = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, T - 9:] = 0
    got = t_ca.causal_attention_fwd(_t(q), _t(k), _t(v), _t(mask))
    pallas = causal_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask), interpret=True)
    bias = j_att.combine_bias(j_att.causal_bias(T, T), j_att.padding_bias(jnp.asarray(mask)))
    xla = j_att.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias)
    o = got.o.numpy()
    real = [T, T - 9]  # padded query rows are garbage in the reference
    for b in range(B):
        np.testing.assert_allclose(o[b, :real[b]], _np(pallas)[b, :real[b]], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(o[b, :real[b]], _np(xla)[b, :real[b]], atol=TOL, rtol=TOL)
    assert got.l.shape == got.m.shape == (B * Hq, T + (-T) % 128)
    assert np.isfinite(got.l.numpy()).all() and np.isfinite(got.m.numpy()).all()


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_plain_matches_pallas(per_row):
    from audio_llama_tpu.ops.decode_attention_mono import decode_attention_mono

    rng = np.random.default_rng(8)
    L, B, Hkv, S, hd, Hq = 2, 3, 2, 64, 32, 4
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    kn = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    vn = rng.normal(size=(B, Hkv, hd)).astype(np.float32)
    ck = rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32)
    cv = rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32)
    off = np.array([21, 30, 5], np.int32) if per_row else np.int32(21)
    valid = (np.arange(S)[None, :] <= np.reshape(off, (-1, 1))).astype(np.int32)
    valid = np.broadcast_to(valid, (B, S)).copy()
    valid[1, 3:5] = 0
    scale = hd ** -0.5
    tk, tv = _t(ck), _t(cv)
    out, tk, tv = t_dm.decode_attention_mono(_t(q), _t(kn), _t(vn), tk, tv, 1,
                                            _t(off), _t(valid), scale)
    p_out, p_k, p_v = decode_attention_mono(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(1), jnp.asarray(off), jnp.asarray(valid), scale, interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(p_out), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tk.numpy(), _np(p_k))  # in-place append, bit-exact
    np.testing.assert_array_equal(tv.numpy(), _np(p_v))
    # XLA path: attend the appended cache under the same validity
    bias = j_att.padding_bias(jnp.asarray(valid))
    xla = j_att.mha(jnp.asarray(q)[:, None], p_k[1], p_v[1], bias=bias, scale=scale,
                    kv_head_major=True)[:, 0]
    np.testing.assert_allclose(out.numpy(), _np(xla), atol=TOL, rtol=TOL)


def test_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on another device never reaches the plain version."""
    x = torch.zeros(4, 64, device="meta")
    s = torch.ones(64, device="meta")
    before = t_ln.launches
    with pytest.raises(ValueError):
        t_ln.layer_norm(x, s, s)
    assert t_ln.launches == before
