"""The port's log-mel front end against the JAX package's.

Tables: bit-equal. Featurizers: the port's plain `ops/mel.py::log_mel`
(rfft) and the mel kernel's plain version (`ops/mel_power.py::log_mel`, the
DFT against the windowed bases) against JAX `mel.log_mel` (XLA) and
`mel_pallas.log_mel(..., interpret=True)`, at atol = rtol = 2e-3, the bar of
tests/test_mel_pallas.py (f32 DFT-by-matmul against rFFT, then log10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.config import MelConfig as JMel  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.ops import mel as j_mel  # noqa: E402
from audio_llama_tpu.ops import mel_pallas as j_mel_pallas  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, MelConfig  # noqa: E402
from audio_llama_tpu_torch.models import allm  # noqa: E402
from audio_llama_tpu_torch.ops import mel, mel_power  # noqa: E402

BAR = dict(atol=2e-3, rtol=2e-3)


def _cfgs(**kw):
    return MelConfig(**kw), JMel(**kw)


@pytest.mark.parametrize("style", ["whisper", "ref"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_tables_bit_equal(style, n_mels):
    cfg, jcfg = _cfgs(num_mel_bins=n_mels, style=style)
    for got, want in zip(mel._tables(cfg), j_mel._tables(jcfg)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(mel_power._basis(cfg), j_mel_pallas._basis(jcfg)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mel.hann_window(400, periodic=False),
                                  j_mel.hann_window(400, periodic=False))


@pytest.mark.parametrize("style", ["whisper", "ref"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(style, n_mels):
    cfg, jcfg = _cfgs(num_mel_bins=n_mels, style=style, max_audio_seconds=5.0)  # 500 frames
    assert j_mel_pallas.uses_pallas(jcfg)
    audio = np.random.default_rng(0).normal(size=(2, cfg.max_samples)).astype(np.float32) * 0.3
    want_xla = np.asarray(j_mel.log_mel(jnp.asarray(audio), jcfg))
    want_pallas = np.asarray(j_mel_pallas.log_mel(jnp.asarray(audio), jcfg, interpret=True))
    for fn in (mel.log_mel, mel_power.log_mel):
        got = fn(torch.from_numpy(audio), cfg).numpy()
        assert got.shape == (2, n_mels, cfg.num_frames)
        np.testing.assert_allclose(got, want_xla, **BAR)
        np.testing.assert_allclose(got, want_pallas, **BAR)


def test_silent_audio():
    cfg, jcfg = _cfgs(max_audio_seconds=2.5)
    audio = np.zeros((1, cfg.max_samples), np.float32)
    want = np.asarray(j_mel_pallas.log_mel(jnp.asarray(audio), jcfg, interpret=True))
    got = mel_power.log_mel(torch.from_numpy(audio), cfg).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BAR)


def test_frame_count_off_the_jax_tile():
    """128 frames: the JAX kernel falls back to XLA; the port's kernel path
    masks the ragged tile and runs."""
    cfg, jcfg = _cfgs(num_mel_bins=80, max_audio_seconds=1.28)
    assert not j_mel_pallas.uses_pallas(jcfg)
    audio = np.random.default_rng(1).normal(size=(3, cfg.max_samples)).astype(np.float32)
    want = np.asarray(j_mel_pallas.log_mel(jnp.asarray(audio), jcfg))
    got = mel_power.log_mel(torch.from_numpy(audio), cfg).numpy()
    np.testing.assert_allclose(got, want, **BAR)
    single = mel_power.log_mel(torch.from_numpy(audio[0]), cfg)
    assert single.shape == (80, cfg.num_frames)


def test_long_audio_folds_windows_into_the_batch():
    """Two 1.28 s windows through process_audio_features (tiny model, f32)
    against JAX's chunked encoding: [B, 2 S] -> [B, 2 A, d]."""
    jcfg, cfg = JCfg.tiny(), AudioLLMConfig.tiny()
    import jax

    jf = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tf = bridge.from_jax({"whisper": jax.tree.map(np.asarray, jf["whisper"])}, "cpu")
    S = cfg.mel.max_samples
    audio = np.random.default_rng(2).normal(size=(2, 2 * S)).astype(np.float32) * 0.1
    want = np.asarray(j_allm.process_audio_features(jf, jcfg, jnp.asarray(audio), jnp.float32,
                                                    enc_attn_impl="xla", mel_impl="xla"))
    got = allm.process_audio_features(tf, cfg, torch.from_numpy(audio), torch.float32)
    assert got.shape == (2, 2 * cfg.audio_seq_len, cfg.whisper.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    with pytest.raises(ValueError, match="multiple"):
        allm.process_audio_features(tf, cfg, torch.from_numpy(audio[:, :S + 7]), torch.float32)
