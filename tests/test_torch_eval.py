"""The port's accuracy measures (`eval/wer.py`, `eval/kl.py`) against the
JAX package's.

Toy model: `AudioLLMConfig.tiny()` (Llama hidden 64, F 128) with the byte
tokenizer's vocabulary, JAX weights passed through the bridge, on a FLAC
corpus of the JAX package's `build_corpus`. Bars:
  - the WER metric: exact, the cases of tests/test_wer.py;
  - `evaluate_wer` (batch 2 over 5 clips: a ragged last batch): the greedy
    transcripts equal JAX's and so do the metrics, both packages' generate
    pinned to f32 compute (at bf16 the two frameworks round in other places);
  - `batch_logit_kl` of a group-32 int4 tree against the f32 tree, f32:
    kl_mean and kl_max within 1e-5 absolute plus 1e-3 relative (the same
    f32 logits up to summation order through ~6 products and the softmax),
    n_positions equal;
  - `calib_mel_batch`: the mel bar of tests/test_torch_mel.py (2e-3).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.data import synth_speech as j_ss  # noqa: E402
from audio_llama_tpu.data.dataset import DatasetConfig as JDatasetConfig  # noqa: E402
from audio_llama_tpu.data.loader import create_dataloaders as j_loaders  # noqa: E402
from audio_llama_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from audio_llama_tpu.eval import kl as j_kl  # noqa: E402
from audio_llama_tpu.eval import wer as j_wer  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from audio_llama_tpu_torch.eval import kl as t_kl  # noqa: E402
from audio_llama_tpu_torch.eval import wer as t_wer  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import allm  # noqa: E402

KL_ATOL, KL_RTOL = 1e-5, 1e-3
MEL_BAR = dict(atol=2e-3, rtol=2e-3)


def test_edit_distance():
    assert t_wer.edit_distance([], []) == 0
    assert t_wer.edit_distance(["a"], []) == 1
    assert t_wer.edit_distance([], ["a", "b"]) == 2
    assert t_wer.edit_distance("the cat sat".split(), "the cat sat".split()) == 0
    assert t_wer.edit_distance("the cat sat".split(), "the bat sat".split()) == 1
    assert t_wer.edit_distance("a b c".split(), "b c d".split()) == 2


def test_normalize_text():
    assert t_wer.normalize_text("Hello, World!") == "hello world"
    assert t_wer.normalize_text("  A   B\tC ") == "a b c"


def test_word_error_rate():
    assert t_wer.word_error_rate(["the cat sat"], ["the cat sat"])["wer"] == 0.0
    m = t_wer.word_error_rate(["the cat sat on the mat"], ["the bat sat on mat"])
    assert m["wer"] == pytest.approx(2 / 6)  # one substitution, one deletion
    assert t_wer.word_error_rate(["Hello, world."], ["hello world"])["wer"] == 0.0
    m = t_wer.word_error_rate(["a b", "c d"], ["a b", "c x"])
    assert m["wer"] == pytest.approx(1 / 4) and m["num_utterances"] == 2
    refs, hyps = ["a b c", "Hello there", ""], ["a c", "hello, there!", "x"]
    assert t_wer.word_error_rate(refs, hyps) == j_wer.word_error_rate(refs, hyps)
    with pytest.raises(ValueError, match="hypotheses"):
        t_wer.word_error_rate(["a"], [])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    return j_ss.build_corpus(root, n_utts=5, vocab_size=4, seed=1, fmt="flac", max_seconds=1.0)


@pytest.fixture(scope="module")
def model():
    tk = JByteTokenizer()
    jcfg = JCfg.tiny()
    jcfg = jcfg.replace(llama=jcfg.llama.replace(vocab_size=max(tk.vocab_size, 384)))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    trainable = j_allm.init_trainable(jcfg, jax.random.PRNGKey(1))
    trainable = jax.tree.map(lambda x: x + 0.01 if x.ndim == 3 else x, trainable)  # LoRA on
    cfg = AudioLLMConfig.from_dict(jcfg.to_dict())
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    return jcfg, frozen, trainable, cfg, tf, tt


def test_evaluate_wer_matches_jax(model, corpus, monkeypatch):
    jcfg, frozen, trainable, cfg, tf, tt = model
    _, audio_dir, entries = corpus
    monkeypatch.setattr(j_gen, "generate",
                        functools.partial(j_gen.generate, compute_dtype=jnp.float32))
    monkeypatch.setattr(t_gen, "generate",
                        functools.partial(t_gen.generate, compute_dtype=torch.float32))
    seen = {}
    for name, mod in (("jax", j_wer), ("port", t_wer)):
        real = mod.word_error_rate
        monkeypatch.setattr(mod, "word_error_rate",
                            lambda r, h, real=real, name=name: seen.setdefault(name, (r, h))
                            and real(r, h))
    want = j_wer.evaluate_wer(jcfg, frozen, trainable, JByteTokenizer(), entries, audio_dir,
                              batch_size=2, max_new_tokens=6)
    got = t_wer.evaluate_wer(cfg, tf, tt, ByteTokenizer(), entries, audio_dir, batch_size=2,
                             max_new_tokens=6, device="cpu")
    refs, hyps = seen["port"]
    assert len(hyps) == 5 and refs == [e["response"] for e in entries]
    assert seen["port"] == seen["jax"]
    assert got == want and got["num_utterances"] == 5


def test_batch_logit_kl_on_a_group32_tree_matches_jax(model, corpus):
    jcfg, frozen, trainable, cfg, tf, tt = model
    data_path, audio_dir, _ = corpus
    tk = JByteTokenizer()
    dl, _, _ = j_loaders(data_path, audio_dir, tk, batch_size=4, val_split=0.2, num_workers=0,
                         dataset_config=JDatasetConfig(
                             max_audio_seconds=jcfg.mel.max_audio_seconds, text_max_length=32))
    hb = next(iter(dl))
    jb = j_allm.AudioLLMBatch(input_ids=jnp.asarray(hb["input_ids"]),
                              attention_mask=jnp.asarray(hb["attention_mask"]),
                              audio_features=jnp.asarray(hb["audio"]),
                              labels=jnp.asarray(hb["labels"]))
    tb = allm.AudioLLMBatch(*(torch.from_numpy(np.asarray(hb[k])) for k in
                              ("input_ids", "attention_mask", "audio", "labels")))
    jq = dict(frozen)
    jq["llama"] = j_l4.quantize_llama_int4(frozen["llama"], group=32, clip=False)
    assert jq["llama"]["layers"]["qkv_proj"]["w_s"].shape[-2] == jcfg.llama.hidden_size // 32
    tq = bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu")
    a_s, a_e = tk.token_to_id(jcfg.audio_start_token), tk.token_to_id(jcfg.audio_end_token)
    want = j_kl.batch_logit_kl(jcfg, frozen, jq, trainable, jb, a_s, a_e)
    got = t_kl.batch_logit_kl(cfg, tf, tq, tt, tb, a_s, a_e)
    assert got["n_positions"] == want["n_positions"] > 0
    for k in ("kl_mean", "kl_max"):
        assert got[k] == pytest.approx(want[k], abs=KL_ATOL, rel=KL_RTOL), k
    assert got["kl_mean"] > 0
    same = t_kl.batch_logit_kl(cfg, tf, tf, tt, tb, a_s, a_e)
    assert same["kl_mean"] == 0.0 and same["kl_max"] == 0.0


def test_calib_mel_batch_matches_jax(model, corpus):
    jcfg, _, _, cfg, _, _ = model
    _, audio_dir, entries = corpus
    want = np.asarray(j_wer.calib_mel_batch(jcfg, entries, audio_dir, n=3))
    got = t_wer.calib_mel_batch(cfg, entries, audio_dir, n=3, device="cpu")
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MEL_BAR)


@pytest.mark.parametrize("flags", [[], ["--int8_encoder"]], ids=["bf16", "int8_encoder"])
def test_wer_cli_on_the_host(corpus, tmp_path, capsys, flags):
    data_path, audio_dir, _ = corpus
    out = tmp_path / "m.json"
    metrics = t_wer.main(["--device", "cpu", "--toy_model", "--tokenizer", "byte",
                          "--data_path", data_path, "--audio_dir", audio_dir, "--limit", "3",
                          "--batch_size", "2", "--max_new_tokens", "3", "--output", str(out),
                          *flags])
    assert metrics["num_utterances"] == 3 and np.isfinite(metrics["wer"])
    assert json.loads(out.read_text()) == metrics
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics
