"""Synthetic speech-like corpus: the offline proxy for real-speech WER.

Counterpart of `audio_llama_tpu/data/synth_speech.py`: numpy throughout, so
the same seed gives the same waveforms, entries and `examples.json` as the
JAX package's. A pseudo-word vocabulary of consonant-vowel syllables is
rendered by additive formant synthesis: a harmonic source at the speaker's
pitch f0, harmonic amplitudes shaped by vowel formant resonances (F1/F2/F3),
fricative noise bands and stop bursts for consonants, per-speaker pitch,
vocal-tract scale and rate, amplitude envelopes, and additive noise at a
sampled SNR. Transcribing it takes what real speech takes of the mel front
end and the encoder (time-varying broadband spectral envelopes), at a size
the tiny model learns on the host.

Consumers: the quantization-accuracy path (`eval/kl.py`, `eval/wer.py`;
`chip_smoke.py`'s `eval_path`). The layout is the instruction JSON the
trainer reads ({"text", "audio_paths", "response"}, as
`data/dataset.py`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Peterson-Barney-ish vowel formants (Hz) at formant_scale=1.0
_VOWELS: Dict[str, Tuple[float, float, float]] = {
    "a": (730.0, 1090.0, 2440.0),
    "e": (530.0, 1840.0, 2480.0),
    "i": (270.0, 2290.0, 3010.0),
    "o": (570.0, 840.0, 2410.0),
    "u": (300.0, 870.0, 2240.0),
}

# fricatives: noise band (lo, hi) Hz; stops: burst band + closure silence
_FRICS: Dict[str, Tuple[float, float]] = {
    "s": (4500.0, 7600.0),
    "f": (1500.0, 7000.0),
}
_STOPS: Dict[str, Tuple[float, float]] = {
    "t": (3000.0, 6500.0),
    "k": (1200.0, 3500.0),
    "m": (200.0, 700.0),   # rendered as a short nasal murmur, not a burst
}

_CONSONANTS: List[str] = list(_FRICS) + list(_STOPS)


def make_vocab(n_words: int, seed: int = 0,
               syllables_per_word: int = 2) -> List[str]:
    """Deterministic pseudo-word vocabulary: CV-syllable strings ("sati",
    "komu", ...), pairwise distinct."""
    rng = np.random.default_rng(seed)
    seen, words = set(), []
    while len(words) < n_words:
        w = "".join(
            rng.choice(_CONSONANTS) + rng.choice(list(_VOWELS))
            for _ in range(syllables_per_word)
        )
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _formant_env(freqs: np.ndarray, formants: Sequence[float],
                 scale: float) -> np.ndarray:
    """Spectral envelope: sum of Gaussian resonances with bandwidth growing
    with center frequency (rough vocal-tract realism)."""
    env = np.zeros_like(freqs)
    for i, f in enumerate(formants):
        fc = f * scale
        bw = 60.0 + 0.05 * fc
        env += (0.9 ** i) * np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    return env


def _vowel(vowel: str, dur: float, f0: float, fscale: float, sr: int,
           rng: np.random.Generator) -> np.ndarray:
    n = int(dur * sr)
    t = np.arange(n) / sr
    # pitch declination + mild vibrato
    f0_t = f0 * (1.0 - 0.08 * t / max(dur, 1e-6)) \
        * (1.0 + 0.01 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0_t) / sr
    k_max = max(2, int(6800.0 / f0))
    k = np.arange(1, k_max + 1)
    amps = _formant_env(k * f0, _VOWELS[vowel], fscale) / np.sqrt(k)
    phi = rng.uniform(0, 2 * np.pi, k_max)
    sig = (np.sin(np.outer(phase, k) + phi) @ amps).astype(np.float32)
    return sig


def _noise_band(lo: float, hi: float, n: int, sr: int,
                rng: np.random.Generator) -> np.ndarray:
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(freqs < lo) | (freqs > hi)] = 0.0
    return np.fft.irfft(spec, n).astype(np.float32)


def _consonant(c: str, f0: float, fscale: float, sr: int,
               rng: np.random.Generator) -> np.ndarray:
    if c in _FRICS:
        lo, hi = _FRICS[c]
        n = int(0.09 * sr)
        return 0.5 * _noise_band(lo * fscale, min(hi * fscale, sr / 2 - 100),
                                 n, sr, rng)
    lo, hi = _STOPS[c]
    if c == "m":  # nasal murmur: low harmonic hum
        return 0.6 * _vowel("u", 0.07, f0, fscale * 0.5, sr, rng)
    closure = np.zeros(int(0.035 * sr), np.float32)
    burst = _noise_band(lo * fscale, min(hi * fscale, sr / 2 - 100),
                        int(0.025 * sr), sr, rng)
    return np.concatenate([closure, 1.2 * burst])


def _fade(x: np.ndarray, ms: float, sr: int) -> np.ndarray:
    n = min(int(ms * sr / 1000), len(x) // 2)
    if n > 0:
        ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
        x = x.copy()
        x[:n] *= ramp
        x[-n:] *= ramp[::-1]
    return x


def synth_word(word: str, f0: float, fscale: float, rate: float, sr: int,
               rng: np.random.Generator) -> np.ndarray:
    """Render one pseudo-word (CV syllable string) at a speaker setting."""
    segs = []
    i = 0
    while i < len(word):
        c, v = word[i], word[i + 1]
        i += 2
        segs.append(_fade(_consonant(c, f0, fscale, sr, rng), 4, sr))
        vdur = rng.uniform(0.10, 0.14) / rate
        segs.append(_fade(_vowel(v, vdur, f0, fscale, sr, rng), 8, sr))
    out = np.concatenate(segs)
    peak = np.max(np.abs(out)) or 1.0
    return (0.5 / peak) * out * rng.uniform(0.6, 1.0)


def synth_utterance(
    words: Sequence[str], speaker: Dict[str, float], sr: int,
    rng: np.random.Generator, snr_db: float,
) -> np.ndarray:
    parts = []
    for w in words:
        parts.append(synth_word(w, speaker["f0"] * rng.uniform(0.95, 1.05),
                                speaker["fscale"], speaker["rate"], sr, rng))
        parts.append(np.zeros(int(rng.uniform(0.02, 0.05) * sr), np.float32))
    sig = np.concatenate(parts[:-1])
    p_sig = float(np.mean(sig ** 2)) or 1e-9
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    sig = sig + rng.standard_normal(len(sig)).astype(np.float32) \
        * np.sqrt(p_noise)
    return np.clip(sig, -1.0, 1.0)


def make_speakers(n: int, seed: int = 0) -> List[Dict[str, float]]:
    rng = np.random.default_rng(seed + 1000)
    return [
        {
            "f0": float(rng.uniform(95.0, 230.0)),
            "fscale": float(rng.uniform(0.88, 1.14)),
            "rate": float(rng.uniform(0.9, 1.15)),
        }
        for _ in range(n)
    ]


def build_corpus(
    root: str,
    n_utts: int = 96,
    vocab_size: int = 12,
    words_per_utt: Tuple[int, int] = (2, 2),
    n_speakers: int = 4,
    snr_db: Tuple[float, float] = (15.0, 30.0),
    seed: int = 0,
    sr: int = 16000,
    fmt: str = "flac",
    prompt: str = "Transcribe the audio.",
    max_seconds: Optional[float] = None,
) -> Tuple[str, str, List[dict]]:
    """Write a corpus under `root` (audio/ + examples.json). Returns
    (data_path, audio_dir, entries). Word sequences cycle through the vocab
    deterministically so classes stay balanced; speaker/noise draws vary per
    clip. fmt 'flac' exercises the native decoder path end-to-end."""
    rng = np.random.default_rng(seed)
    vocab = make_vocab(vocab_size, seed)
    speakers = make_speakers(n_speakers, seed)
    audio_dir = os.path.join(root, "audio")
    os.makedirs(audio_dir, exist_ok=True)

    entries = []
    for i in range(n_utts):
        k = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        words = [vocab[(i + j) % vocab_size] for j in range(k)]
        spk = speakers[i % n_speakers]
        snr = float(rng.uniform(*snr_db))
        sig = synth_utterance(words, spk, sr, rng, snr)
        if max_seconds is not None and len(sig) > int(max_seconds * sr):
            sig = sig[: int(max_seconds * sr)]
        rel = f"utt_{i:04d}.{fmt}"
        path = os.path.join(audio_dir, rel)
        if fmt == "flac":
            from .flac_write import write_flac

            write_flac(path, sig, sr)
        else:
            from .audio_io import write_wav

            write_wav(path, sig, sr)
        entries.append({
            "text": prompt,
            "audio_paths": rel,
            "response": " ".join(words),
        })

    data_path = os.path.join(root, "examples.json")
    with open(data_path, "w") as f:
        json.dump(entries, f)
    return data_path, audio_dir, entries
