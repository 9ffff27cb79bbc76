"""Log-mel through the mel-power kernel.

Replaces `audio_llama_tpu/ops/mel_pallas.py::_kernel` (`mel_power`,
`log_mel`). The kernel computes the mel power spectrogram [B, F, n_mels]
from the reflect-padded waveform: per frame the windowed DFT against the
hann*cos and hann*sin bases of `_basis`, power = re^2 + im^2, times the
mel filterbank. The reflect pad, log10 and the dynamic-range clamp stay
outside the kernel, as in the JAX package (the clamp needs the clip's
global max). The CUDA kernel is `csrc/mel_power.cu` (its source note gives
the bound and the design); `mel_power_plain` is the same arithmetic in
PyTorch (f32 products against the same bases).

The JAX kernel covers frame counts that are a multiple of its 250-frame
tile and falls back to the XLA featurizer otherwise; this kernel masks the
ragged edge and takes any frame count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import MelConfig
from . import _cuda
from .mel import _tables, frames_of, log_from_power, reflect_pad

NB_PAD = 256  # n_fft // 2 + 1 = 201 bins padded to 256 columns, as the TPU kernel's

launches = 0  # kernel launches through `mel_power`


@functools.lru_cache(maxsize=4)
def _basis(cfg: MelConfig):
    """(C [n_slices, hop, NB], S [n_slices, hop, NB], fbT [NB, n_mels]) f32:
    the windowed DFT basis in hop-row slices and the transposed filterbank,
    zero-padded to NB columns (the JAX package's `_basis`, host arrays)."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n_bins = n_fft // 2 + 1
    if n_bins > NB_PAD:
        raise ValueError(f"mel kernel: n_fft {n_fft} gives {n_bins} bins > {NB_PAD}")
    window, fb = _tables(cfg)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    cos = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin = (np.sin(ang) * window[:, None]).astype(np.float32)
    n_slices = -(-n_fft // hop)
    C = np.zeros((n_slices, hop, NB_PAD), np.float32)
    S = np.zeros((n_slices, hop, NB_PAD), np.float32)
    for s in range(n_slices):
        lo, hi = s * hop, min((s + 1) * hop, n_fft)
        C[s, : hi - lo, :n_bins] = cos[lo:hi]
        S[s, : hi - lo, :n_bins] = sin[lo:hi]
    fbT = np.zeros((NB_PAD, fb.shape[0]), np.float32)
    fbT[:n_bins] = fb.T
    return C, S, fbT


_device_tables = {}


def _tables_on(cfg: MelConfig, device: torch.device):
    """The basis as [n_slices * hop, NB] row tables and fbT, on `device` (cached)."""
    key = (cfg, str(device))
    if key not in _device_tables:
        C, S, fbT = _basis(cfg)
        _device_tables[key] = tuple(
            torch.from_numpy(t.reshape(-1, t.shape[-1]).copy()).to(device) for t in (C, S, fbT))
    return _device_tables[key]


def pad_waveform(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, S] -> [B, S + n_fft] f32, center reflect padding."""
    return reflect_pad(audio, cfg.n_fft // 2).contiguous()


def mel_power_plain(padded: torch.Tensor, cfg: MelConfig, num_frames: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: padded [B, P] -> [B, F, n_mels]."""
    C, S, fbT = _tables_on(cfg, padded.device)
    n_fft, n_bins = cfg.n_fft, cfg.n_fft // 2 + 1
    frames = frames_of(padded.to(torch.float32), n_fft, cfg.hop_length, num_frames)
    re = frames @ C[:n_fft, :n_bins]
    im = frames @ S[:n_fft, :n_bins]
    return (re * re + im * im) @ fbT[:n_bins]


def mel_power_cuda(padded: torch.Tensor, cfg: MelConfig, num_frames: int) -> torch.Tensor:
    """Launch the kernel (same arguments as the plain version)."""
    global launches
    name = "mel_power"
    _cuda.require_cuda(name, padded)
    if padded.dtype != torch.float32 or padded.dim() != 2:
        raise TypeError(f"{name}: expected a [B, P] float32 waveform")
    padded = padded.contiguous()
    B, P = padded.shape
    C, S, fbT = _tables_on(cfg, padded.device)
    n_fft, hop, n_mels = cfg.n_fft, cfg.hop_length, cfg.num_mel_bins
    n_bins = n_fft // 2 + 1
    if 4 * (31 * hop + n_fft + 3 + 32 * n_bins) > 227 * 1024:
        raise ValueError(f"{name}: hop {hop} / n_fft {n_fft} exceed the shared-memory budget")
    out = torch.empty((B, num_frames, n_mels), dtype=torch.float32, device=padded.device)
    err = _cuda.library().al_mel_power(
        padded.data_ptr(), B, P, num_frames, hop, n_fft, C.data_ptr(), S.data_ptr(), NB_PAD,
        n_bins, fbT.data_ptr(), n_mels, out.data_ptr(), _cuda.stream_handle(padded),
    )
    _cuda.check(err, name)
    launches += 1
    return out


def mel_power(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """waveform [B, max_samples] -> mel power [B, num_frames, n_mels]. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    padded = pad_waveform(audio, cfg)
    fn = mel_power_plain if padded.device.type == "cpu" else mel_power_cuda
    return fn(padded, cfg, cfg.num_frames)


def log_mel(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """waveform [..., max_samples] -> log-mel [..., n_mels, num_frames]
    (same contract and numerics as ops/mel.py::log_mel)."""
    if cfg.style not in ("whisper", "ref"):
        raise ValueError(f"unknown mel style {cfg.style!r}")
    lead = audio.shape[:-1]
    mel = mel_power(audio.reshape(-1, audio.shape[-1]), cfg).transpose(-1, -2)
    return log_from_power(mel, cfg).reshape(*lead, *mel.shape[-2:])
