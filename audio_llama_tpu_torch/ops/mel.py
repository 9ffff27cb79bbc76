"""Log-mel spectrogram front end: the host-side tables and the plain
featurizer.

Counterpart of `audio_llama_tpu/ops/mel.py`. The tables (hann window, mel
filterbank) are the port's own numpy copies of the JAX package's and come
out bit-equal. `log_mel` frames the reflect-padded waveform and takes
`torch.fft.rfft`, as the JAX package's XLA featurizer takes `jnp.fft.rfft`.
The main path runs the mel kernel instead (`ops/mel_power.py`).

style='whisper' is Whisper's featurizer (slaney mels, log10, dynamic-range
clamp to the clip's max - 8, then (x + 4) / 4); style='ref' is the
reference's training featurizer (htk mels, log(x + 1e-9)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MelConfig


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """Hann window; periodic matches torch.hann_window / whisper."""
    m = n if periodic else n - 1
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / m))).astype(np.float32)


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3  # slaney
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft // 2 + 1] (librosa-compatible)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        fb = fb * enorm[:, None]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(cfg: MelConfig):
    """(hann window [n_fft], filterbank [n_mels, n_bins]) for the config's style."""
    window = hann_window(cfg.n_fft, periodic=True)
    if cfg.style == "whisper":
        fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mel_bins, fmax=8000.0,
                            htk=False, norm="slaney")
    elif cfg.style == "ref":
        fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mel_bins, fmax=None,
                            htk=True, norm=None)
    else:
        raise ValueError(f"unknown mel style {cfg.style!r}")
    return window, fb


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """[..., S] f32 -> [..., S + 2 pad], center reflect padding."""
    lead = audio.shape[:-1]
    flat = audio.reshape(-1, 1, audio.shape[-1]).to(torch.float32)
    return F.pad(flat, (pad, pad), mode="reflect").reshape(*lead, -1)


def frames_of(padded: torch.Tensor, n_fft: int, hop: int, num_frames: int) -> torch.Tensor:
    """[..., P] -> [..., num_frames, n_fft]: frame f is samples
    [f * hop, f * hop + n_fft), zero past the end."""
    need = (num_frames - 1) * hop + n_fft
    if padded.shape[-1] < need:
        padded = F.pad(padded, (0, need - padded.shape[-1]))
    return padded.unfold(-1, n_fft, hop)[..., :num_frames, :]


def log_from_power(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Mel power [..., n_mels, F] -> log-mel, per the config's style."""
    if cfg.style == "whisper":
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        max_val = log_spec.amax(dim=(-2, -1), keepdim=True)  # per clip
        log_spec = torch.maximum(log_spec, max_val - 8.0)
        return (log_spec + 4.0) / 4.0
    return torch.log(mel + 1e-9)


def log_mel(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """waveform [..., max_samples] f32 at 16 kHz -> log-mel [..., n_mels,
    num_frames] (3000 frames for a 30 s clip)."""
    window, fb = _tables(cfg)
    padded = reflect_pad(audio, cfg.n_fft // 2)
    frames = frames_of(padded, cfg.n_fft, cfg.hop_length, cfg.num_frames)
    frames = frames * torch.from_numpy(window).to(frames.device)
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [..., F, n_bins]
    mel = power @ torch.from_numpy(fb).to(power.device).t()  # [..., F, n_mels]
    return log_from_power(mel.transpose(-1, -2), cfg)


def log_mel_batch(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, S] -> [B, n_mels, F] (log_mel already handles batch dims)."""
    return log_mel(audio, cfg)
