"""The port's host side and inference CLI against the JAX package's.

Audio decode (WAV, FLAC) and the mono mixdown + resample: bit-identical to
JAX's `audio_io` (the same numpy and scipy calls). Tokenizers: identical ids
and text. The CLI runs end to end on the host (`--platform cpu`) with the
toy model and the int4 KV cache, and `--int4_decoder` on the toy model
refuses the same way as JAX's (hidden 64 is not a multiple of group 128).
`--kv_quant` (int8 rows), `--int8_decoder`, `--rotate` and both A/B values of
`--decode_impl` run; the flags of parts not ported yet name their ROADMAP
queue.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.data import audio_io as j_io  # noqa: E402
from audio_llama_tpu.data import tokenizer as j_tok  # noqa: E402
from audio_llama_tpu.data.flac_write import write_flac  # noqa: E402
from audio_llama_tpu.inference import cli as j_cli  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.data import audio_io, tokenizer  # noqa: E402
from audio_llama_tpu_torch.inference import cli  # noqa: E402

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_llama_tokenizer"


def _stereo(seconds, sr, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    left = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.shape)
    right = 0.3 * np.sin(2 * np.pi * 660 * t)
    return np.stack([left, right], axis=1).astype(np.float32)


def test_wav_and_flac_decode_match_jax(tmp_path):
    wav = tmp_path / "a.wav"
    j_io.write_wav(str(wav), _stereo(0.5, 44100), 44100)
    got, sr = audio_io.read_wav(str(wav))
    want, jsr = j_io.read_wav(str(wav))
    assert sr == jsr == 44100
    np.testing.assert_array_equal(got, want)
    mine = tmp_path / "b.wav"
    audio_io.write_wav(str(mine), _stereo(0.5, 44100), 44100)
    assert mine.read_bytes() == wav.read_bytes()

    flac = tmp_path / "c.flac"
    write_flac(str(flac), _stereo(0.3, 16000, seed=1), 16000)
    got, sr = audio_io.read_flac(str(flac))
    want, jsr = j_io.read_flac(str(flac))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
    for path in (wav, flac):
        np.testing.assert_array_equal(audio_io.load_audio(str(path)), j_io.load_audio(str(path)))


def test_process_audio_pads_mixes_and_resamples(tmp_path):
    """A 2 s, 44.1 kHz stereo WAV -> one 16 kHz window, zero-padded."""
    cfg = AudioLLMConfig.tiny()
    wav = tmp_path / "a.wav"
    audio_io.write_wav(str(wav), _stereo(2.0, 44100), 44100)
    got = cli.process_audio(str(wav), cfg.mel)
    want = j_cli.process_audio(str(wav), cfg.mel)
    assert got.shape == (1, cfg.mel.max_samples)
    np.testing.assert_array_equal(got, want)


def test_byte_tokenizer_matches_jax():
    text = "hé<audio></audio> ok"
    got, want = tokenizer.ByteTokenizer(), j_tok.ByteTokenizer()
    assert got.vocab_size == want.vocab_size
    for kw in ({}, {"add_eos": True}, {"max_length": 12, "pad_to_max": True}):
        for g, w in zip(got.encode(text, **kw), want.encode(text, **kw)):
            np.testing.assert_array_equal(g, w)
    ids, _ = got.encode(text)
    assert got.decode(ids) == want.decode(ids)
    assert got.decode(ids, skip_special_tokens=False) == want.decode(ids,
                                                                    skip_special_tokens=False)


def test_hf_tokenizer_matches_jax():
    got, want = tokenizer.load_tokenizer(str(FIXTURE)), j_tok.load_tokenizer(str(FIXTURE))
    assert (got.vocab_size, got.pad_id, got.eos_id) == (want.vocab_size, want.pad_id,
                                                        want.eos_id)
    assert got.token_to_id("<audio>") == want.token_to_id("<audio>")
    for kw in ({}, {"add_eos": True, "max_length": 16, "pad_to_max": True}):
        for g, w in zip(got.encode("hello there <audio>", **kw),
                        want.encode("hello there <audio>", **kw)):
            np.testing.assert_array_equal(g, w)
    ids, _ = got.encode("hello there")
    assert got.decode(ids) == want.decode(ids)


def test_cli_main_runs_on_the_host(tmp_path, capsys):
    wav = tmp_path / "a.wav"
    audio_io.write_wav(str(wav), _stereo(1.0, 22050), 22050)
    text = cli.main(["--platform", "cpu", "--toy_model", "--tokenizer", "byte", "--audio",
                     str(wav), "--prompt", "Transcribe:", "--kv_quant", "--kv_bits", "4",
                     "--greedy", "--max_new_tokens", "4"])
    assert isinstance(text, str)
    assert capsys.readouterr().out.rstrip("\n") == text
    cfg, frozen, trainable, tk = cli.load_audio_llm(None, toy_model=True, device="cpu")
    text2, tokens = cli.generate_response(cfg, frozen, trainable, tk, "Transcribe:",
                                          audio_path=str(wav), max_new_tokens=4, greedy=True,
                                          kv_quant=4, device="cpu", return_tokens=True)
    assert text2 == text and tokens.shape == (1, 4)


@pytest.mark.parametrize("flags", [
    ["--kv_quant"],
    ["--int8_decoder", "--kv_quant"],
    ["--int8_decoder", "--rotate", "--kv_quant", "--kv_bits", "4"],
])
def test_cli_quantized_configs_match_generate(tmp_path, monkeypatch, flags):
    """The CLI's int8-KV, int8-weight and rotated configurations: its greedy
    tokens equal `generate_response`'s on the tree built the same way."""
    wav = tmp_path / "a.wav"
    audio_io.write_wav(str(wav), _stereo(1.0, 22050), 22050)
    seen = []
    real = cli.generate_response

    def recorded(*a, **k):
        text, tokens = real(*a, **{**k, "return_tokens": True})
        seen.append(tokens)
        return text

    monkeypatch.setattr(cli, "generate_response", recorded)
    text = cli.main(["--platform", "cpu", "--toy_model", "--tokenizer", "byte", "--audio",
                     str(wav), "--prompt", "Transcribe:", "--greedy", "--max_new_tokens", "4"]
                    + flags)
    cfg, frozen, trainable, tk = cli.load_audio_llm(None, toy_model=True, device="cpu")
    if "--int8_decoder" in flags:
        frozen, trainable = cli.quantize_decoder(cfg, frozen, trainable, bits=8,
                                                 rotate="--rotate" in flags)
        assert "rot" in frozen["llama"] or "--rotate" not in flags
    text2, tokens = real(cfg, frozen, trainable, tk, "Transcribe:", audio_path=str(wav),
                         max_new_tokens=4, greedy=True,
                         kv_quant=4 if "4" in flags else True, device="cpu",
                         return_tokens=True)
    assert text2 == text
    np.testing.assert_array_equal(seen[0].numpy(), tokens.numpy())


def test_cli_refusals_match_jax_or_name_the_queue():
    with pytest.raises(ValueError, match="int4 pack needs even N and group"):
        cli.main(["--platform", "cpu", "--toy_model", "--prompt", "x", "--int4_decoder",
                  "--max_new_tokens", "1"])
    with pytest.raises(ValueError, match="int4 pack needs even N and group"):
        j_cli.main(["--platform", "cpu", "--toy_model", "--prompt", "x", "--int4_decoder",
                    "--max_new_tokens", "1"])
    for flags in (["--int8_decoder"], ["--rotate"], ["--kv_quant"],  # ported: they run
                  ["--decode_impl", "decode_kernel"], ["--decode_impl", "decode_packed"]):
        text = cli.main(["--platform", "cpu", "--toy_model", "--prompt", "x", "--greedy",
                         "--max_new_tokens", "2"] + flags)
        assert isinstance(text, str)
    for flags in (["--draft_llama_path", "toy"], ["--llama_path", "x"]):
        with pytest.raises(NotImplementedError, match="ROADMAP queue"):
            cli.main(["--platform", "cpu", "--prompt", "x"]
                     + (["--toy_model"] if "--llama_path" not in flags else []) + flags)
    # --checkpoint_path is ported (tests/test_torch_train.py): a missing one is an error
    with pytest.raises(FileNotFoundError):
        cli.main(["--platform", "cpu", "--prompt", "x", "--toy_model", "--checkpoint_path",
                  "missing_ckpt"])
