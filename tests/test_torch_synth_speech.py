"""The port's FLAC encoder and synthetic speech corpus against the JAX
package's.

Both are numpy, so the bar is exact: the same samples and mode give the
same FLAC bytes (every subframe mode, stereo decorrelation, bit depth and
the float contract of tests/test_audio_io.py), and the same seed gives the
same waveforms, entries and `examples.json` (wav and flac corpora). The
port's FLAC files also round-trip through its own decoder.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.data import flac_write as j_flac  # noqa: E402
from audio_llama_tpu.data import synth_speech as j_ss  # noqa: E402
from audio_llama_tpu_torch.data import audio_io  # noqa: E402
from audio_llama_tpu_torch.data import flac_write  # noqa: E402
from audio_llama_tpu_torch.data import synth_speech  # noqa: E402


def _sine(n=16000, sr=16000, freq=440.0, amp=0.5):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int64)


def _bytes_of(write, path, *args, **kw):
    write(path, *args, **kw)
    with open(path, "rb") as f:
        return f.read()


CASES = {
    **{f"mono {m}": ((_sine(12345), 16000), dict(bps=16, mode=m))
       for m in ("verbatim", "fixed0", "fixed1", "fixed2", "fixed3", "fixed4", "lpc")},
    "constant": ((np.full(5000, 1234, np.int64), 16000), dict(mode="constant")),
    **{f"stereo {m}": ((np.stack([_sine(9000), _sine(9000, freq=220.0, amp=0.3)], 1), 16000),
                       dict(mode="fixed2", stereo_mode=m))
       for m in ("independent", "left_side", "right_side", "mid_side")},
    "noise 22.05 kHz": ((np.random.default_rng(0).integers(-32768, 32767, 44100)
                         .astype(np.int64), 22050), dict(mode="verbatim")),
    "float waveform": (((np.random.default_rng(0).standard_normal(8000) * 0.1)
                        .astype(np.float32), 16000), {}),
    "24-bit": (((_sine(7000) * 256), 48000), dict(bps=24, mode="fixed3")),
    "8-bit, small blocks": (((_sine(7000) // 256), 8000), dict(bps=8, block_size=1000)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_flac_bytes_equal_jax(tmp_path, case):
    args, kw = CASES[case]
    want = _bytes_of(j_flac.write_flac, str(tmp_path / "j.flac"), *args, **kw)
    got = _bytes_of(flac_write.write_flac, str(tmp_path / "t.flac"), *args, **kw)
    assert got == want


def test_write_flac_round_trips_through_the_decoder(tmp_path):
    x = _sine(12345)
    p = str(tmp_path / "x.flac")
    flac_write.write_flac(p, x, 16000, mode="fixed2")
    audio, sr = audio_io.read_flac(p)
    assert sr == 16000
    np.testing.assert_array_equal((audio[:, 0] * 32768.0).round().astype(np.int64), x)
    with pytest.raises(ValueError, match="channels"):
        flac_write.write_flac(p, np.zeros((10, 3), np.int64))


def test_synth_pieces_equal_jax():
    assert synth_speech.make_vocab(12, seed=3) == j_ss.make_vocab(12, seed=3)
    assert synth_speech.make_speakers(5, seed=2) == j_ss.make_speakers(5, seed=2)
    spk = j_ss.make_speakers(1, seed=4)[0]
    words = j_ss.make_vocab(3, seed=4)
    got = synth_speech.synth_utterance(words, spk, 16000, np.random.default_rng(9), 20.0)
    want = j_ss.synth_utterance(words, spk, 16000, np.random.default_rng(9), 20.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_build_corpus_equals_jax(tmp_path, fmt):
    kw = dict(n_utts=6, vocab_size=5, words_per_utt=(1, 3), n_speakers=3, seed=7, fmt=fmt,
              max_seconds=1.5)
    jd, ja, je = j_ss.build_corpus(str(tmp_path / "j"), **kw)
    td, ta, te = synth_speech.build_corpus(str(tmp_path / "t"), **kw)
    assert te == je and len(te) == 6
    with open(jd, "rb") as f, open(td, "rb") as g:
        assert g.read() == f.read()
    assert json.load(open(td)) == te
    for e in te:
        with open(os.path.join(ja, e["audio_paths"]), "rb") as f, \
                open(os.path.join(ta, e["audio_paths"]), "rb") as g:
            assert g.read() == f.read(), e["audio_paths"]
        wave = audio_io.load_audio(os.path.join(ta, e["audio_paths"]), target_sr=16000)
        assert wave.ndim == 1 and 0 < len(wave) <= int(1.5 * 16000)
        assert np.isfinite(wave).all() and np.abs(wave).max() <= 1.0
