"""The slice end to end: the port's `generate` against JAX `generate` on
bridged `AudioLLMConfig.tiny()` params.

Bars: at f32 the greedy token chains are equal token for token, with and
without audio, at B = 2 with a right-padded row. At bf16 the two packages
round at different places, so the bar is the prefill's next-token logits
within 0.05 absolute (logits of magnitude ~1-3 at these widths) and the
first greedy token equal. Sampling is compared by distribution only:
`jax.random` and torch generators give different numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.ops import sampling as j_samp  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama as t_llama  # noqa: E402
from audio_llama_tpu_torch.ops import sampling as t_samp  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()
START, END = 512, 513


@pytest.fixture(scope="module")
def model():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(
        frozen["llama"], JCFG.llama.vocab_size + 2, JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"] = jnp.asarray(rng.normal(size=br["a"].shape).astype(np.float32) * 0.1)
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    B, T = 2, 7
    ids = rng.integers(0, 512, (B, T)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0  # row 1 right-padded
    mel = rng.normal(size=(B, 80, 2 * CFG.whisper.max_source_positions)).astype(np.float32)
    return frozen, trainable, tf, tt, ids, mask, mel


def _kw(audio):
    return dict(max_new_tokens=6, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
                audio_end_id=END, has_audio=audio is not None)


@pytest.mark.parametrize("with_audio", [False, True])
def test_greedy_tokens_match_jax_f32(model, with_audio):
    jf, jt, tf, tt, ids, mask, mel = model
    audio = mel if with_audio else None
    want = j_gen.generate(jf, jt, JCFG, jnp.asarray(ids), jnp.asarray(mask),
                          None if audio is None else jnp.asarray(audio),
                          jax.random.PRNGKey(0), compute_dtype=jnp.float32, **_kw(audio))
    got = t_gen.generate(tf, tt, CFG, ids, mask, audio, compute_dtype=torch.float32,
                         device="cpu", **_kw(audio))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(want.num_generated))


def test_bf16_prefill_logits_and_first_token(model):
    jf, jt, tf, tt, ids, mask, mel = model

    def j_logits():
        embeds, m = j_gen.build_prefix(jf, jt, JCFG, jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(mel), START, END, jnp.bfloat16)
        logits, _ = j_llama.llama_forward(
            jf["llama"], JCFG.llama, inputs_embeds=embeds, attention_mask=m,
            lora=j_gen.lora_mod.with_scaling(jt["lora"], JCFG.lora),
            compute_dtype=jnp.bfloat16, attn_impl="xla")
        last = np.asarray(m).sum(1) - 1
        return np.asarray(logits, np.float32)[np.arange(2), last]

    embeds, m = t_gen.build_prefix(tf, tt, CFG, torch.from_numpy(ids).long(),
                                   torch.from_numpy(mask), torch.from_numpy(mel), START, END,
                                   torch.bfloat16)
    logits, _ = t_llama.llama_forward(
        tf["llama"], CFG.llama, inputs_embeds=embeds, attention_mask=m,
        lora=t_gen.lora_mod.with_scaling(tt["lora"], CFG.lora), compute_dtype=torch.bfloat16)
    last = m.sum(1) - 1
    got = logits[torch.arange(2), last].numpy()
    want = j_logits()
    np.testing.assert_allclose(got, want, atol=5e-2)
    first = t_gen.generate(tf, tt, CFG, ids, mask, mel, compute_dtype=torch.bfloat16,
                           device="cpu", **_kw(mel)).tokens[:, 0].numpy()
    np.testing.assert_array_equal(first, want.argmax(-1))


def test_eos_latching(model):
    _, _, tf, tt, ids, mask, _ = model
    probe = t_gen.generate(tf, tt, CFG, ids[:1], mask[:1], None, compute_dtype=torch.float32,
                           device="cpu", **{**_kw(None), "max_new_tokens": 1})
    eos = int(probe.tokens[0, 0])
    res = t_gen.generate(tf, tt, CFG, ids[:1], mask[:1], None, compute_dtype=torch.float32,
                         device="cpu", **{**_kw(None), "eos_id": eos})
    assert int(res.num_generated[0]) == 1
    assert (res.tokens[0, 1:] == 0).all()


def test_sampling_distribution_matches_jax_filters():
    """Empirical frequencies of the port's sampler vs the JAX package's
    post-filter distribution (temperature 0.7, top-p 0.9): within 0.02 on
    every token over 20000 draws (the binomial std is <= 0.0036)."""
    rng = np.random.default_rng(9)
    logits = (rng.normal(size=(1, 32)) * 1.5).astype(np.float32)
    probs = np.asarray(j_samp.filtered_probs(jnp.asarray(logits), 0.7, 0.9))[0]
    gen = torch.Generator().manual_seed(0)
    draws = t_samp.sample_token(torch.from_numpy(np.repeat(logits, 20000, 0)), gen,
                                temperature=0.7, top_p=0.9).numpy()
    freq = np.bincount(draws, minlength=32) / draws.size
    np.testing.assert_allclose(freq, probs, atol=0.02)
    assert (freq[probs == 0] == 0).all()


def test_sampled_generate_runs(model):
    _, _, tf, tt, ids, mask, mel = model
    gen = torch.Generator().manual_seed(0)
    kw = {**_kw(mel), "greedy": False, "temperature": 0.7, "top_p": 0.9}
    res = t_gen.generate(tf, tt, CFG, ids, mask, mel, gen, compute_dtype=torch.float32,
                         device="cpu", **kw)
    assert res.tokens.shape == (2, 6) and res.tokens.dtype == torch.int32
    assert ((res.tokens >= 0) & (res.tokens < 514)).all()
    with pytest.raises(ValueError, match="Generator"):
        t_gen.generate(tf, tt, CFG, ids, mask, mel, None, compute_dtype=torch.float32,
                       device="cpu", **kw)
