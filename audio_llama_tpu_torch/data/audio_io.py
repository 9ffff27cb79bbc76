"""Host-side audio IO: WAV and FLAC decode, mono mixdown, resampling.

Counterpart of `audio_llama_tpu/data/audio_io.py`. WAV decoding is numpy.
FLAC decoding runs the repository's C++ decoder (`native/flac_decoder.cpp`),
built with g++ on first use into the port's git-ignored build directory
(`audio_llama_tpu_torch/csrc/build/`) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC_PATH = _ROOT / "native" / "flac_decoder.cpp"
_LIB_PATH = Path(__file__).resolve().parent.parent / "csrc" / "build" / "libflacdec.so"

_lib = None
_lib_lock = threading.Lock()


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("total_samples", ctypes.c_uint64),
    ]


def build_native(force: bool = False) -> Path:
    """Compile the FLAC decoder if it is missing or older than its source."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    if not force and _LIB_PATH.exists() \
            and _LIB_PATH.stat().st_mtime >= _SRC_PATH.stat().st_mtime:
        return _LIB_PATH
    tmp = _LIB_PATH.with_suffix(f".{threading.get_ident()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC_PATH)],
                   check=True, capture_output=True)
    tmp.replace(_LIB_PATH)
    return _LIB_PATH


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            lib.flac_probe.restype = ctypes.c_int
            lib.flac_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(_FlacInfo)]
            lib.flac_decode.restype = ctypes.c_int64
            lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64]
            _lib = lib
    return _lib


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 [n, ch] in [-1, 1], sample_rate)."""
    data = Path(path).read_bytes()
    lib = _get_lib()
    info = _FlacInfo()
    rc = lib.flac_probe(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"malformed FLAC file: {path} (rc={rc})")
    total = int(info.total_samples) or info.sample_rate * 3600  # count may be absent
    out = np.empty(total * info.channels, np.int32)
    n = lib.flac_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        total)
    if n < 0:
        raise ValueError(f"FLAC decode failed: {path} (rc={n})")
    pcm = out[: n * info.channels].reshape(int(n), info.channels)
    return pcm.astype(np.float32) / float(1 << (info.bits_per_sample - 1)), \
        int(info.sample_rate)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE (PCM 8/16/24/32-bit, float32) -> ([n, ch] f32, sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos, fmt, raw, fmt_body = 12, None, None, None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        size = struct.unpack("<I", data[pos + 4: pos + 8])[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"WAV missing fmt/data chunk: {path}")
    audio_fmt, ch, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: the SubFormat GUID's first two bytes
        audio_fmt = struct.unpack("<H", fmt_body[24:26])[0] if len(fmt_body) >= 26 else 1
    if audio_fmt == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_fmt == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 1 and bits == 8:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    elif audio_fmt == 1 and bits == 24:
        b = np.frombuffer(raw, "u1").reshape(-1, 3)
        v = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) \
            | (b[:, 2].astype(np.int32) << 16)
        x = ((v ^ 0x800000) - 0x800000).astype(np.float32) / float(1 << 23)
    elif audio_fmt == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    elif audio_fmt == 1:
        raise ValueError(f"unsupported WAV bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format {audio_fmt}")
    n = (len(x) // ch) * ch
    return x[:n].reshape(-1, ch), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """float32 in [-1, 1], [n] or [n, ch] -> 16-bit PCM WAV."""
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    n, ch = pcm.shape
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + pcm.nbytes))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, ch, sample_rate, sample_rate * ch * 2, ch * 2,
                            16))
        f.write(b"data")
        f.write(struct.pack("<I", pcm.nbytes))
        f.write(pcm.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy `resample_poly`) along axis 0; identity
    when the rates match."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=0).astype(np.float32)


def load_audio(path: str, target_sr: int = 16000, mono: bool = True) -> np.ndarray:
    """Decode a .wav or .flac file -> float32 [n] (mono: the channel mean) or
    [n, ch], resampled to target_sr."""
    ext = Path(path).suffix.lower()
    if ext == ".flac":
        audio, sr = read_flac(path)
    elif ext == ".wav":
        audio, sr = read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
    if mono and audio.shape[1] > 1:
        audio = audio.mean(axis=1, keepdims=True)
    audio = resample(audio, sr, target_sr)
    return audio[:, 0] if mono else audio
