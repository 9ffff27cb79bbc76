"""The port's int4 KV cache and the whole int4 slice against the JAX package.

- `quantize_kv_rows4` / `unpack_kv4`: bit-identical.
- The int4-KV decode kernel's plain version against JAX
  `decode_attention_quantized4_mono(..., interpret=True)`: the cache bytes
  bit-identical after the append, the output at f32 within 1e-5 (the same
  f32 softmax summed in another order), with scalar and [B] offsets, a fresh
  row marked invalid, and a poisoned append-slot scale (which both must
  ignore: the slot is dead in the slab pass).
- The slice: the port's greedy `generate` equals JAX `generate` token for
  token at f32, on waveform audio, a fused int4 tree bridged from JAX (both
  pack formats) with an int4 KV cache (kv_quant=4) and with an int8 one
  (kv_quant=True), B = 2 with a right-padded row, with and without audio.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.ops import decode_attention_mono as j_dm  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)


def _np(x):
    return np.asarray(x)


def test_quantize_kv_rows4_bit_identical():
    rng = np.random.default_rng(0)
    k, v = (rng.normal(size=(2, 3, 5, 32)).astype(np.float32) for _ in range(2))
    k[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    want = j_llama.quantize_kv_rows4(jnp.asarray(k), jnp.asarray(v))
    got = llama.quantize_kv_rows4(torch.from_numpy(k), torch.from_numpy(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for g, w in zip(llama.unpack_kv4(got[0]), j_llama.unpack_kv4(want[0])):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    cache = llama.KVCache.zeros(LlamaConfig.tiny(), 2, 40, quantized=4)
    assert cache.v is None and cache.kv_bits == 4 and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == (2, 2, 2, 64)
    for q8 in (True, 8):  # int8 rows: separate K and V slabs, as JAX's zeros
        cache = llama.KVCache.zeros(LlamaConfig.tiny(), 2, 40, quantized=q8)
        want = j_llama.KVCache.zeros(JLlamaCfg.tiny(), 2, 40, quantized=q8)
        assert cache.kv_bits == want.kv_bits == 8
        for g, w in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                        (want.k, want.v, want.k_scale, want.v_scale)):
            assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype))


def _decode_case(seed, per_row, fresh_valid=True, poison=False):
    L, B, Hkv, S, hd, Hq = 2, 2, 2, 64, 32, 4
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    kv_new, ks_new, vs_new = (_np(a).copy() for a in j_llama.quantize_kv_rows4(
        jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32))))
    ckv, ks, vs = (_np(a).copy() for a in j_llama.quantize_kv_rows4(
        jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32))))
    off = np.array([19, 40], np.int32) if per_row else np.int32(19)
    off_b = np.broadcast_to(off, (B,))
    valid = (np.arange(S)[None, :] <= off_b[:, None]).astype(np.int32)
    valid[0, 3:6] = 0
    if not fresh_valid:
        valid[1, off_b[1]] = 0
    if poison:
        for b in range(B):
            ks[1, b, :, off_b[b]] = 1e30
            vs[1, b, :, off_b[b]] = 1e30
    return q, kv_new, ckv, ks, vs, ks_new, vs_new, off, valid


@pytest.mark.parametrize("case", ["scalar", "per_row", "fresh_invalid", "poisoned"])
def test_decode_quantized4_matches_the_pallas_kernel(case):
    args = _decode_case(1, per_row=case != "scalar", fresh_valid=case != "fresh_invalid",
                        poison=case == "poisoned")
    q, kv_new, ckv, ks, vs, ks_new, vs_new, off, valid = args
    scale = 32 ** -0.5
    want, want_cache = j_dm.decode_attention_quantized4_mono(
        jnp.asarray(q), jnp.asarray(kv_new), jnp.asarray(ckv), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(ks_new), jnp.asarray(vs_new), jnp.int32(1),
        jnp.asarray(off), jnp.asarray(valid), scale, interpret=True)
    cache = torch.from_numpy(ckv.copy())
    got, got_cache = dm.decode_attention_quantized4_mono(
        torch.from_numpy(q), torch.from_numpy(kv_new), cache, torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(ks_new), torch.from_numpy(vs_new), 1,
        torch.from_numpy(np.asarray(off)), torch.from_numpy(valid), scale)
    assert got_cache.data_ptr() == cache.data_ptr()  # appended in place
    np.testing.assert_array_equal(got_cache.numpy(), _np(want_cache))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    assert np.isfinite(got.numpy()).all()
    # the per-layer scale-slab form gives the same result
    again, _ = dm.decode_attention_quantized4_mono(
        torch.from_numpy(q), torch.from_numpy(kv_new), torch.from_numpy(ckv.copy()),
        torch.from_numpy(ks[1]), torch.from_numpy(vs[1]), torch.from_numpy(ks_new),
        torch.from_numpy(vs_new), 1, torch.from_numpy(np.asarray(off)),
        torch.from_numpy(valid), scale)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None,
            tie_word_embeddings=True)
START, END = 512, 513


@pytest.fixture(scope="module", params=["pair", "obin"])
def slice_model(request):
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JLlamaCfg(**DIMS))
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=LlamaConfig(**DIMS))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_l4.quantize_llama_int4(
        j_llama.resize_embeddings(frozen["llama"], 514, jcfg.llama), fmt=request.param)
    trainable = {"projector": j_allm.init_trainable(jcfg, jax.random.PRNGKey(1))["projector"]}
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0  # row 1 right-padded
    wav = (rng.normal(size=(2, cfg.mel.max_samples)) * 0.1).astype(np.float32)
    return jcfg, cfg, frozen, trainable, tf, tt, ids, mask, wav


@pytest.mark.parametrize("with_audio", [False, True])
def test_int4_slice_greedy_tokens_match_jax(slice_model, with_audio):
    jcfg, cfg, jf, jt, tf, tt, ids, mask, wav = slice_model
    audio = wav if with_audio else None
    kw = dict(max_new_tokens=6, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
              audio_end_id=END, has_audio=with_audio, kv_quant=4)
    want = j_gen.generate(jf, jt, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                          None if audio is None else jnp.asarray(audio), jax.random.PRNGKey(0),
                          compute_dtype=jnp.float32, **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, audio, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), _np(want.num_generated))
    # int8 KV rows on the same tree (the int8-KV kernel's plain version)
    kw["kv_quant"] = True
    want = j_gen.generate(jf, jt, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                          None if audio is None else jnp.asarray(audio), jax.random.PRNGKey(0),
                          compute_dtype=jnp.float32, **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, audio, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
