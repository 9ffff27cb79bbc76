"""flax's single-file msgpack checkpoint format, without flax or msgpack.

The JAX package writes checkpoints with `flax.serialization.to_bytes` and
reads them with `msgpack_restore`. The card's machine has neither package,
so the port encodes and decodes the same bytes itself: msgpack maps, arrays,
strings, binary, ints, floats, booleans and nil, and flax's two extension
types, 1 (an ndarray as the msgpack triple (shape, dtype name, C-order
bytes)) and 3 (a numpy scalar in the same triple). Arrays over 2^30 bytes
are split into flax's chunked-array dicts on write and joined on read.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit per array leaf


def _dtype_from_name(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q")):
            if n >= limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack int out of range: {n}")


def _sized(n: int, fix_base: int, fix_max: int, codes: tuple) -> bytes:
    """Header of a str / bin / array / map of n items (codes for 8-, 16- and
    32-bit lengths; a code of None has no such width)."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack length out of range: {n}")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _encode(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, int) and not isinstance(x, np.generic):
        out.append(_int(x))
    elif isinstance(x, float) and not isinstance(x, np.generic):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        out.append(_sized(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_sized(len(x), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(x))
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _encode(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    else:
        raise TypeError(f"cannot msgpack-encode {type(x).__name__}")


def packb(x: Any) -> bytes:
    """msgpack bytes of x, as `msgpack.packb(x, use_bin_type=True)` with
    flax's extension hook writes them."""
    out: list = []
    _encode(x, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unknown msgpack extension type {code}")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array_(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return {"ext": self.ext, "str": self.str_, "array": self.array_,
                    "map": self.map_}[kind](n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def array_(self, n: int):
        return [self.value() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode msgpack bytes (flax's extension types as numpy arrays and
    scalars; str as bytes when `raw`)."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack data")
    return out


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data, raw=True)
    arr = np.frombuffer(buf, dtype=_dtype_from_name(name.decode()))
    return arr.reshape(shape, order="C").copy()


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(x):
    """Chunk the large array leaves, and order every dict's keys as flax
    does (it walks the tree with JAX, which sorts them)."""
    if isinstance(x, dict):
        return {k: _chunk_leaves(x[k]) for k in sorted(x)}
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _unchunk_leaves(x):
    if isinstance(x, dict):
        if "__msgpack_chunked_array__" in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in x.items()}
    return x


def serialize(state: Any) -> bytes:
    """`flax.serialization.msgpack_serialize` of a tree of dicts, lists,
    Python scalars and numpy arrays: the same bytes."""
    return packb(_chunk_leaves(state))


def restore(data: bytes) -> Any:
    """`flax.serialization.msgpack_restore`."""
    return _unchunk_leaves(unpackb(data))
