"""The port's int8 weights and int8 KV cache against the JAX package's.

- `quantize_llama` (tied table, and an untied lm_head): bit-identical to
  JAX's for the same weights (the same symmetric per-column / per-row
  rounding, in f32).
- `llama_forward` on the int8 tree: f32 logits within 1e-5 relative to
  their scale of JAX's (the same f32 products summed in another order).
- `quantize_kv_rows`: bit-identical.
- The int8-KV decode kernel's plain version against JAX
  `decode_attention_quantized_mono(..., interpret=True)`: the cache bytes
  bit-identical after the append, the output at f32 within 1e-5, with scalar
  and [B] offsets, a fresh row marked invalid, and a poisoned append-slot
  scale (which both must ignore: the slot is dead in the slab pass).
- The slice: the port's greedy `generate` equals JAX `generate` token for
  token at f32 on the int8 tree with an int8 KV cache, waveform audio, B = 2
  with a right-padded row, with and without audio.
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
from audio_llama_tpu.models import llama_int8 as j_l8  # noqa: E402
from audio_llama_tpu.ops import decode_attention_mono as j_dm  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama, llama_int8  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402

DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None)
START, END = 512, 513


def _np(x):
    return np.asarray(x)


def _cfgs(tied):
    return JLlamaCfg(**DIMS, tie_word_embeddings=tied), LlamaConfig(**DIMS,
                                                                  tie_word_embeddings=tied)


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_llama_bit_identical_and_forward_matches_jax(tied):
    jcfg, cfg = _cfgs(tied)
    params = j_llama.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    want_tree = j_l8.quantize_llama(params)
    got_tree = llama_int8.quantize_llama(bridge.from_jax(jax.tree.map(np.asarray, params), "cpu"))
    assert llama_int8.is_quantized(got_tree) and not llama_int8.is_quantized(
        bridge.from_jax(jax.tree.map(np.asarray, params), "cpu"))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got_tree.to_dict()))[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], _np(w), err_msg=str(path))
    assert ("lm_head" in got_tree) == (not tied)

    ids = np.random.default_rng(2).integers(3, 500, (2, 9)).astype(np.int32)
    want = _np(j_llama.llama_forward(want_tree, jcfg, input_ids=jnp.asarray(ids),
                                     compute_dtype=jnp.float32)[0])
    got, _ = llama.llama_forward(got_tree, cfg, input_ids=torch.from_numpy(ids),
                                 compute_dtype=torch.float32)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_quantize_kv_rows_bit_identical():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 floor
    want = j_llama.quantize_kv_rows(jnp.asarray(x))
    got = llama.quantize_kv_rows(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def _decode_case(seed, per_row, fresh_valid=True, poison=False):
    L, B, Hkv, S, hd, Hq = 2, 2, 2, 64, 32, 4
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    (kn, ksn), (vn, vsn) = (tuple(_np(a).copy() for a in j_llama.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32)))) for _ in range(2))
    (ck, ks), (cv, vs) = (tuple(_np(a).copy() for a in j_llama.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32)))) for _ in range(2))
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
    return q, kn, vn, ck, cv, ks, vs, ksn, vsn, off, valid


@pytest.mark.parametrize("case", ["scalar", "per_row", "fresh_invalid", "poisoned"])
def test_decode_quantized8_matches_the_pallas_kernel(case):
    args = _decode_case(1, per_row=case != "scalar", fresh_valid=case != "fresh_invalid",
                        poison=case == "poisoned")
    q, kn, vn, ck, cv, ks, vs, ksn, vsn, off, valid = args
    scale = 32 ** -0.5
    want, want_k, want_v = j_dm.decode_attention_quantized_mono(
        *(jnp.asarray(a) for a in (q, kn, vn, ck, cv, ks, vs, ksn, vsn)), jnp.int32(1),
        jnp.asarray(off), jnp.asarray(valid), scale, interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (q, kn, vn, ck, cv, ks, vs, ksn, vsn)]
    tk, tv = t[3], t[4]
    got, got_k, got_v = dm.decode_attention_quantized_mono(
        *t, 1, torch.from_numpy(np.asarray(off)), torch.from_numpy(valid), scale)
    assert got_k.data_ptr() == tk.data_ptr() and got_v.data_ptr() == tv.data_ptr()  # in place
    np.testing.assert_array_equal(got_k.numpy(), _np(want_k))
    np.testing.assert_array_equal(got_v.numpy(), _np(want_v))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    assert np.isfinite(got.numpy()).all()
    # the per-layer scale-slab form gives the same result
    t = [torch.from_numpy(np.array(a)) for a in (q, kn, vn, ck, cv, ks[1], vs[1], ksn, vsn)]
    again = dm.decode_attention_quantized_mono(*t, 1, torch.from_numpy(np.asarray(off)),
                                               torch.from_numpy(valid), scale)[0]
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.fixture(scope="module")
def int8_model():
    dims = {**DIMS, "tie_word_embeddings": True}
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JLlamaCfg(**dims))
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=LlamaConfig(**dims))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_l8.quantize_llama(
        j_llama.resize_embeddings(frozen["llama"], 514, jcfg.llama))
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
def test_int8_slice_greedy_tokens_match_jax(int8_model, with_audio):
    jcfg, cfg, jf, jt, tf, tt, ids, mask, wav = int8_model
    audio = wav if with_audio else None
    kw = dict(max_new_tokens=6, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
              audio_end_id=END, has_audio=with_audio, kv_quant=True)
    want = j_gen.generate(jf, jt, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                          None if audio is None else jnp.asarray(audio), jax.random.PRNGKey(0),
                          compute_dtype=jnp.float32, **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, audio, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), _np(want.num_generated))
