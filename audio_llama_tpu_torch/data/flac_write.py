"""Minimal FLAC encoder (numpy).

Counterpart of `audio_llama_tpu/data/flac_write.py`, byte for byte: the same
samples and mode give the same file. It writes FLAC fixtures for the
repository's C++ decoder (`native/flac_decoder.cpp`, read by
`data/audio_io.read_flac`) and the synthetic corpora of
`data/synth_speech.py`. Constant / verbatim / fixed-order (0-4) / simple-LPC
subframes with Rice residual coding, mono or stereo (independent,
left-side, right-side, mid-side), 8-24 bit depths, CRC-8 / CRC-16 as the
specification gives them.
"""

from __future__ import annotations

import struct

import numpy as np


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        value &= (1 << bits) - 1
        self.cur = (self.cur << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.cur >> self.nbits) & 0xFF)
        self.cur &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    if n < 0x800:
        lead, nbytes = 0xC0, 2
    elif n < 0x10000:
        lead, nbytes = 0xE0, 3
    elif n < 0x200000:
        lead, nbytes = 0xF0, 4
    elif n < 0x4000000:
        lead, nbytes = 0xF8, 5
    else:
        lead, nbytes = 0xFC, 6
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.mean(np.abs(res))) + 1e-9
    k = max(0, int(np.ceil(np.log2(mean + 1))))
    return min(k, 14)


def _write_residual(bw: _BitWriter, res: np.ndarray):
    """Single-partition rice coding (partition order 0, method 0)."""
    bw.write(0, 2)  # method: rice 4-bit params
    bw.write(0, 4)  # partition order 0
    param = _rice_param(res)
    bw.write(param, 4)
    for v in res.tolist():
        u = (abs(v) * 2 - 1) if v < 0 else v * 2  # zigzag
        q, r = u >> param, u & ((1 << param) - 1)
        bw.write_unary(q)
        bw.write(r, param)


def _write_subframe(bw: _BitWriter, samples: np.ndarray, bps: int, mode: str):
    s = samples.astype(np.int64)
    bw.write(0, 1)  # pad
    if mode == "constant" and np.all(s == s[0]):
        bw.write(0, 6)
        bw.write(0, 1)  # no wasted bits
        bw.write_signed(int(s[0]), bps)
    elif mode == "verbatim":
        bw.write(1, 6)
        bw.write(0, 1)
        for v in s.tolist():
            bw.write_signed(int(v), bps)
    elif mode.startswith("fixed"):
        order = int(mode[-1])
        coefs = _FIXED_COEFS[order]
        bw.write(8 + order, 6)
        bw.write(0, 1)
        for v in s[:order].tolist():
            bw.write_signed(int(v), bps)
        res = s[order:].copy()
        for j, c in enumerate(coefs):
            res -= c * s[order - 1 - j : len(s) - 1 - j]
        _write_residual(bw, res)
    elif mode == "lpc":
        # order-2 quantized LPC with coefs [2, -1], shift 0, precision 4:
        # numerically identical to fixed-2 but exercises the LPC decode path.
        order, prec, shift = 2, 4, 0
        bw.write(32 + order - 1, 6)
        bw.write(0, 1)
        for v in s[:order].tolist():
            bw.write_signed(int(v), bps)
        bw.write(prec - 1, 4)
        bw.write_signed(shift, 5)
        for c in (2, -1):
            bw.write_signed(c, prec)
        res = s[2:] - (2 * s[1:-1] - s[:-2])
        _write_residual(bw, res)
    else:
        raise ValueError(f"unknown subframe mode {mode!r}")


_SS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def write_flac(
    path: str,
    samples: np.ndarray,  # [n] or [n, ch]; float in [-1, 1] or int PCM
    sample_rate: int = 16000,
    bps: int = 16,
    block_size: int = 4096,
    mode: str = "fixed2",
    stereo_mode: str = "independent",  # | left_side | right_side | mid_side
) -> None:
    if samples.ndim == 1:
        samples = samples[:, None]
    n, nch = samples.shape
    if nch not in (1, 2):
        raise ValueError(f"write_flac takes 1 or 2 channels, got {nch}")
    if np.issubdtype(samples.dtype, np.floating):
        # float waveform contract matches write_wav: [-1, 1] -> full-scale PCM
        # (a bare astype would truncate |x|<1 to silence).
        full = float(2 ** (bps - 1) - 1)
        samples = np.round(np.clip(samples, -1.0, 1.0) * full)
    samples = samples.astype(np.int64)

    header = bytearray(b"fLaC")
    si = bytearray()
    si += struct.pack(">HH", block_size, block_size)
    si += b"\x00\x00\x00" * 2  # min/max framesize unknown
    si += bytes(
        [
            (sample_rate >> 12) & 0xFF,
            (sample_rate >> 4) & 0xFF,
            ((sample_rate & 0xF) << 4) | ((nch - 1) << 1) | (((bps - 1) >> 4) & 1),
            (((bps - 1) & 0xF) << 4) | ((n >> 32) & 0xF),
            (n >> 24) & 0xFF,
            (n >> 16) & 0xFF,
            (n >> 8) & 0xFF,
            n & 0xFF,
        ]
    )
    si += b"\x00" * 16  # md5 unknown
    header += bytes([0x80]) + len(si).to_bytes(3, "big") + si

    frames = bytearray()
    frame_idx = 0
    for start in range(0, n, block_size):
        blk = samples[start : start + block_size]
        bs = blk.shape[0]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)  # sync
        bw.write(0, 1)  # reserved
        bw.write(0, 1)  # fixed-blocksize strategy
        bw.write(7, 4)  # blocksize: explicit 16-bit
        bw.write(0, 4)  # sample rate: from STREAMINFO
        if nch == 1 or stereo_mode == "independent":
            bw.write(nch - 1, 4)
        else:
            bw.write({"left_side": 8, "right_side": 9, "mid_side": 10}[stereo_mode], 4)
        bw.write(_SS_CODE[bps], 3)
        bw.write(0, 1)  # reserved
        # UTF-8 frame number
        for byte in _utf8_number(frame_idx):
            bw.write(byte, 8)
        bw.write(bs - 1, 16)
        assert bw.nbits == 0
        bw.buf.append(_crc8(bytes(bw.buf)))

        chans = []
        bps_per_ch = []
        if nch == 1 or stereo_mode == "independent":
            for c in range(nch):
                chans.append(blk[:, c])
                bps_per_ch.append(bps)
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if stereo_mode == "left_side":
                chans, bps_per_ch = [left, side], [bps, bps + 1]
            elif stereo_mode == "right_side":
                chans, bps_per_ch = [side, right], [bps + 1, bps]
            else:  # mid_side
                mid = (left + right) >> 1
                chans, bps_per_ch = [mid, side], [bps, bps + 1]
        for ch, chbps in zip(chans, bps_per_ch):
            _write_subframe(bw, ch, chbps, mode)
        bw.align()
        body = bytes(bw.buf)
        frames += body + struct.pack(">H", _crc16(body))
        frame_idx += 1

    with open(path, "wb") as f:
        f.write(bytes(header) + bytes(frames))
