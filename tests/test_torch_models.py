"""Port models (audio_llama_tpu_torch.models) against the JAX package at f32
on bridged tiny params.

The JAX side runs its CPU (XLA) path; the port runs its wrappers' plain
versions. Tolerances are stated per test: 1e-4 absolute on activations of
order one after a few layers (f32 sums in another order, and the port's
one-pass LayerNorm moments and 128-tile padding of the encoder stack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import lora as j_lora  # noqa: E402
from audio_llama_tpu.models import projector as j_proj  # noqa: E402
from audio_llama_tpu.models import whisper as j_whisper  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.models import allm, llama, lora, projector, whisper  # noqa: E402
from audio_llama_tpu_torch.ops import mel_power  # noqa: E402

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()
ATOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def params():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(
        frozen["llama"], JCFG.llama.vocab_size + 2, JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"] = jnp.asarray(rng.normal(size=br["a"].shape).astype(np.float32) * 0.1)
    jf = jax.tree.map(np.asarray, frozen)
    jt = jax.tree.map(np.asarray, trainable)
    return frozen, trainable, bridge.from_jax(jf, "cpu"), bridge.from_jax(jt, "cpu")


def test_whisper_encode(params):
    jf, _, tf, _ = params
    mel = np.random.default_rng(1).normal(
        size=(2, CFG.whisper.num_mel_bins, 2 * CFG.whisper.max_source_positions)
    ).astype(np.float32)
    want = j_whisper.encode(jf["whisper"], JCFG.whisper, jnp.asarray(mel), jnp.float32,
                            attn_impl="xla")
    got = whisper.encode(tf["whisper"], CFG.whisper, torch.from_numpy(mel), torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=ATOL)


def test_sinusoid_table():
    np.testing.assert_array_equal(whisper.sinusoid_position_embedding(50, 16),
                                  j_whisper.sinusoid_position_embedding(50, 16))


def test_project(params):
    _, jt, _, tt = params
    x = np.random.default_rng(2).normal(size=(2, 9, CFG.whisper.d_model)).astype(np.float32)
    want = j_proj.project(jt["projector"], jnp.asarray(x), jnp.float32)
    got = projector.project(tt["projector"], torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=ATOL)


def _lora(jt, tt):
    return (j_lora.with_scaling(jt["lora"], JCFG.lora),
            lora.with_scaling(tt["lora"], CFG.lora))


def test_llama_full_sequence(params):
    jf, jt, tf, tt = params
    jl, tl = _lora(jt, tt)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 512, (2, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    want, _ = j_llama.llama_forward(jf["llama"], JCFG.llama, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask), lora=jl,
                                    compute_dtype=jnp.float32, attn_impl="xla")
    got, _ = llama.llama_forward(tf["llama"], CFG.llama, input_ids=torch.from_numpy(ids),
                                 attention_mask=torch.from_numpy(mask), lora=tl,
                                 compute_dtype=torch.float32)
    want = _np(want)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got[1, :8].numpy(), want[1, :8], atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_llama_prefill_then_decode(params, per_row):
    """Fresh-cache prefill (hidden states and KV slabs), then one T == 1
    decode step (logits and KV slabs) with a scalar or a [B] offset."""
    jf, jt, tf, tt = params
    jl, tl = _lora(jt, tt)
    rng = np.random.default_rng(4)
    B, T, max_len = 2, 9, 20
    emb = rng.normal(size=(B, T, CFG.llama.hidden_size)).astype(np.float32)
    mask = np.ones((B, max_len), np.int32)
    mask[1, 6:T] = 0  # right padding in row 1's prompt

    jc = j_llama.KVCache.zeros(JCFG.llama, B, max_len, dtype=jnp.float32)
    _, jc, jh = j_llama.llama_forward(
        jf["llama"], JCFG.llama, inputs_embeds=jnp.asarray(emb), attention_mask=jnp.asarray(mask),
        kv_cache=jc, lora=jl, compute_dtype=jnp.float32, assume_fresh_cache=True,
        return_hidden=True, unembed_logits=False, attn_impl="xla")
    tc = llama.KVCache.zeros(CFG.llama, B, max_len, dtype=torch.float32, device="cpu")
    _, tc, th = llama.llama_forward(
        tf["llama"], CFG.llama, inputs_embeds=torch.from_numpy(emb),
        attention_mask=torch.from_numpy(mask), kv_cache=tc, lora=tl,
        compute_dtype=torch.float32, assume_fresh_cache=True, return_hidden=True,
        unembed_logits=False)
    assert tc.k.shape == jc.k.shape == (2, B, 2, 32, 16)  # 32-slot rounding
    np.testing.assert_allclose(th[0].numpy(), _np(jh)[0], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(th[1, :6].numpy(), _np(jh)[1, :6], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), _np(jc.k), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), _np(jc.v), atol=ATOL, rtol=ATOL)
    assert int(tc.length) == int(jc.length) == T

    tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
    pos = np.array([[T], [6]], np.int32)
    j_kw, t_kw = {}, {}
    if per_row:
        offs = np.array([T, T], np.int32)
        j_kw["cache_offsets"] = jnp.asarray(offs)
        t_kw["cache_offsets"] = torch.from_numpy(offs)
    jlog, jc = j_llama.llama_forward(
        jf["llama"], JCFG.llama, input_ids=jnp.asarray(tok), attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(pos), kv_cache=jc, lora=jl, compute_dtype=jnp.float32,
        attn_impl="xla", **j_kw)
    tlog, tc = llama.llama_forward(
        tf["llama"], CFG.llama, input_ids=torch.from_numpy(tok),
        attention_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos), kv_cache=tc,
        lora=tl, compute_dtype=torch.float32, **t_kw)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), _np(jc.k), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), _np(jc.v), atol=ATOL, rtol=ATOL)
    assert int(tc.length) == int(jc.length) == T + 1


def test_resize_embeddings(params):
    jf, _, tf, _ = params
    np.testing.assert_array_equal(tf["llama"]["embed"]["weight"].numpy(),
                                  _np(jf["llama"]["embed"]["weight"]))
    grown = llama.resize_embeddings(tf["llama"], 520, CFG.llama)
    want = j_llama.resize_embeddings(jf["llama"], 520, JCFG.llama)
    np.testing.assert_allclose(grown["embed"]["weight"].numpy(), _np(want["embed"]["weight"]),
                               atol=1e-6)
    np.testing.assert_allclose(grown["lm_head"].numpy(), _np(want["lm_head"]), atol=1e-6)


def test_splices(params):
    jf, jt, tf, tt = params
    rng = np.random.default_rng(5)
    B, T, A, D = 3, 6, 4, CFG.llama.hidden_size
    ids = rng.integers(0, 500, (B, T)).astype(np.int32)
    ids[0, 2] = 512  # <audio> mid-prompt; row 1 at the front; row 2 has none
    ids[1, 0] = 512
    mask = np.ones((B, T), np.int32)
    mask[2, 4:] = 0
    labels = rng.integers(0, 500, (B, T)).astype(np.int32)
    audio = rng.normal(size=(B, A, D)).astype(np.float32)
    text = rng.normal(size=(B, T, D)).astype(np.float32)

    got = allm.splice_inplace(torch.from_numpy(text), torch.from_numpy(audio),
                              torch.from_numpy(ids), torch.from_numpy(mask),
                              torch.from_numpy(labels), 512)
    want = j_allm.splice_inplace(jnp.asarray(text), jnp.asarray(audio), jnp.asarray(ids),
                                 jnp.asarray(mask), jnp.asarray(labels), 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    got_e, got_m = allm.combine_text_and_audio_embeddings(
        tf, tt, CFG, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(audio),
        512, 513, torch.float32)
    want_e, want_m = j_allm.combine_text_and_audio_embeddings(
        jf, jt, JCFG, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(audio), 512, 513,
        jnp.float32)
    np.testing.assert_array_equal(got_e.numpy(), _np(want_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_waveform_input_waits_for_the_mel_kernel(params):
    """Waveform input runs the mel kernel's path: the encoder states equal
    those of its log-mel fed directly."""
    _, _, tf, _ = params
    wav = torch.from_numpy(
        np.random.default_rng(6).normal(size=(2, CFG.mel.max_samples)).astype(np.float32))
    got = allm.process_audio_features(tf, CFG, wav, torch.float32)
    want = allm.process_audio_features(tf, CFG, mel_power.log_mel(wav, CFG.mel), torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("tied", [True, False])
def test_unembed_logits_stay_f32_at_bf16(params, tied):
    """bf16 hidden states and weights: the port's logits equal JAX
    `unembed`'s (bf16 x bf16 products accumulated and kept in f32) within
    1e-5 relative; rounding them to bf16 would miss by ~4e-3."""
    jf, _, tf, _ = params
    jcfg = JCFG.llama.replace(tie_word_embeddings=tied)
    cfg = CFG.llama.replace(tie_word_embeddings=tied)
    x = np.random.default_rng(7).normal(size=(2, 3, CFG.llama.hidden_size)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(j_llama.unembed(jf["llama"], jcfg, xj, jnp.bfloat16), np.float32)
    got = llama.unembed(tf["llama"], cfg, bridge.to_tensor(np.asarray(xj), torch.device("cpu")),
                        torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
